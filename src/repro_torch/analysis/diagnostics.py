"""Diagnostics for the static plan verifier (port of
``repro.analysis.diagnostics``, unchanged).

Every verifier pass reports through the same small vocabulary: a
:class:`Diagnostic` names the pass that produced it, a severity, the
offending plan node by **provenance** — the ``nid:Label`` addressing of
:func:`repro_torch.core.guards.label_nodes`, i.e. the node's postorder index in
:func:`repro_torch.core.engine.plan_sig` (the same ids the fault injector's
node selectors and ``NumericsError`` attribution use) — a one-line
message, and a fix-it hint.

:class:`Diagnostics` is the ordered collection a
:class:`~repro_torch.analysis.manager.PassManager` run returns;
:class:`PlanVerificationError` (a ``ValueError``, so callers matching the
pre-verifier error class keep working) is what ``Engine(validate="strict")``
raises when any error-severity diagnostic survives.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Tuple

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of one verifier pass, anchored to a plan node."""

    pass_name: str                  # "placement" | "collectives" | ...
    severity: str                   # "error" | "warning" | "info"
    message: str
    node_id: int = -1               # plan_sig postorder id (-1: whole plan)
    node_label: str = ""            # e.g. "7:FusedJoinAgg[matMul→matAdd]"
    hint: str = ""                  # fix-it suggestion

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, "
                f"got {self.severity!r}")

    def render(self) -> str:
        where = f" at node {self.node_label}" if self.node_label else ""
        out = f"[{self.pass_name}] {self.severity}{where}: {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def __str__(self) -> str:
        return self.render()


class Diagnostics:
    """Ordered collection of :class:`Diagnostic` with severity views."""

    def __init__(self, items: Iterable[Diagnostic] = ()) -> None:
        self._items: List[Diagnostic] = list(items)

    # -- construction ------------------------------------------------------
    def add(self, pass_name: str, severity: str, message: str, *,
            node=None, labels=None, hint: str = "") -> Diagnostic:
        """Append a diagnostic, resolving ``node`` provenance via
        ``labels`` (the :func:`repro_torch.core.guards.label_nodes` table)."""
        nid, label = -1, ""
        if node is not None:
            if labels is not None and id(node) in labels:
                nid, label = labels[id(node)]
            else:
                label = type(node).__name__
        d = Diagnostic(pass_name, severity, message, nid, label, hint)
        self._items.append(d)
        return d

    def extend(self, other: "Diagnostics") -> None:
        self._items.extend(other)

    # -- views -------------------------------------------------------------
    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __getitem__(self, i):
        return self._items[i]

    @property
    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self._items if d.severity == "error")

    @property
    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self._items if d.severity == "warning")

    def by_pass(self, pass_name: str) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self._items if d.pass_name == pass_name)

    def render(self, min_severity: str = "info") -> str:
        keep = SEVERITIES[:SEVERITIES.index(min_severity) + 1]
        lines = [d.render() for d in self._items if d.severity in keep]
        if not lines:
            return "no diagnostics"
        counts = ", ".join(
            f"{len([d for d in self._items if d.severity == s])} {s}(s)"
            for s in SEVERITIES
            if any(d.severity == s for d in self._items))
        return "\n".join(lines + [f"-- {counts}"])

    def raise_if_errors(self) -> "Diagnostics":
        if self.errors:
            raise PlanVerificationError(self)
        return self


class PlanVerificationError(ValueError):
    """Static verification rejected the plan (``validate="strict"``).

    Subclasses ``ValueError`` so pre-verifier callers catching the engine's
    historical invalid-plan error class continue to work; carries the full
    :class:`Diagnostics` as ``.diagnostics``.
    """

    def __init__(self, diagnostics: Diagnostics,
                 prefix: Optional[str] = None) -> None:
        self.diagnostics = diagnostics
        head = prefix or (
            f"plan verification failed with "
            f"{len(diagnostics.errors)} error(s)")
        super().__init__(f"{head}\n{diagnostics.render()}")
