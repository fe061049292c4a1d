"""Engine input/configuration validation in the verifier's vocabulary.

Port of ``repro.analysis.inputs``.  The engine's checks — ``chunk`` /
``memory_budget`` range validation at construction, unexpected/missing
inputs and the ``jit`` executor's masked-input rejection at dispatch —
raise through here: each failure is a
:class:`~repro_torch.analysis.diagnostics.Diagnostic` (pass ``"inputs"``,
severity ``error``, a fix-it hint) rendered into the raised exception.

Every constructor raises the *same exception type* with the *same leading
message text* as the JAX package's (``ValueError("chunk must be >= 1,
...")``, ``ValueError("unexpected inputs: ...")``,
``NotImplementedError("... mask-free ...")``), so callers matching on type
or substring work on both; the rendered diagnostic follows the first
line.  One difference: :func:`check_chunk` also refuses a ``bool`` or a
non-integer ``chunk`` (JAX's compares it with 1 and lets ``True`` pass).
"""
from __future__ import annotations

from typing import Sequence, Type

from repro_torch.analysis.diagnostics import Diagnostic

PASS = "inputs"


def _raiseable(exc_type: Type[Exception], message: str, *, hint: str = "",
               where: str = "Engine") -> Exception:
    d = Diagnostic(PASS, "error", message, node_label=where, hint=hint)
    return exc_type(f"{message}\n{d.render()}")


def check_chunk(chunk) -> None:
    """``chunk`` is ``None``, ``"auto"`` or a positive int."""
    if chunk is None or chunk == "auto":
        return
    if isinstance(chunk, (str, bool)) or not isinstance(chunk, int):
        raise _raiseable(
            ValueError,
            f"chunk must be a positive int, None or \"auto\"; "
            f"got {chunk!r}",
            hint="\"auto\" autotunes from the device memory budget",
            where="Engine(chunk=...)")
    if chunk < 1:
        raise _raiseable(
            ValueError, f"chunk must be >= 1, got {chunk}",
            hint="the chunk counts grid slices per streamed reduction "
                 "step; use \"auto\" to autotune it",
            where="Engine(chunk=...)")


def check_memory_budget(budget) -> None:
    """``memory_budget`` is ``None`` or a positive byte count."""
    if budget is not None and budget < 1:
        raise _raiseable(
            ValueError,
            f"memory_budget must be >= 1 byte, got {budget}",
            hint="pass the device live-bytes budget in bytes, or None "
                 "to disable the out-of-core tier",
            where="Engine(memory_budget=...)")


def unexpected_inputs_error(unknown: Sequence[str],
                            expected: Sequence[str]) -> ValueError:
    return _raiseable(
        ValueError,
        f"unexpected inputs: {list(unknown)}; "
        f"expected {sorted(expected)}",
        hint="run() takes exactly the plan's declared TraInput/IAInput "
             "names",
        where="CompiledExpr.run")


def missing_inputs_error(missing: Sequence[str],
                         expected: Sequence[str]) -> ValueError:
    return _raiseable(
        ValueError,
        f"missing inputs: {list(missing)}; "
        f"expected {sorted(expected)}",
        hint="every declared input must be bound by name",
        where="CompiledExpr.run")


def masked_inputs_error(executor: str,
                        holey: Sequence[str]) -> NotImplementedError:
    return _raiseable(
        NotImplementedError,
        f"executor {executor!r} requires continuous (mask-free) input "
        f"relations; inputs {list(holey)} carry masks — run on "
        f"executor=\"reference\", or express the filter inside the plan",
        hint="staged executors rebuild relations from raw arrays, so an "
             "input-side static mask would be silently dropped",
        where="CompiledExpr.run")
