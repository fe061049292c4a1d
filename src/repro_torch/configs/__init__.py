"""Configurations of the port: the paper's §5.3 FFNN configs (more come
with the model-zoo slice)."""
