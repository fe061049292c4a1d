"""Launchers and meters of the port (``repro.launch`` counterpart)."""
