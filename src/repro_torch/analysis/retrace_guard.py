"""Runtime guard: pin what a hot path may repeat per call (counterpart of
``repro.analysis.retrace_guard``).

The reference's guard counts each wrapped jitted function's compilation
cache misses inside a region: every miss is a (re)trace.  The eager port
compiles nothing per shape.  What it can repeat per call instead is

* a kernel library load: :func:`repro_torch.kernels._build.load` opening a
  library with ``ctypes`` (:func:`library_loads`), which a warm process
  never needs again;
* a host sync (:data:`repro_torch.sync.SYNCS`, :func:`host_syncs`), of
  which a hot loop should pay a fixed number per master tick.

A :class:`RetraceGuard` reads each watched counter when the region is
entered and again when it is left; each counter may grow by at most its
limit in between.  It reads the counters only at the region's
boundaries, so it costs the guarded calls nothing, and it imports no JAX.

Usage (no library load after warm-up, at most ``k`` host syncs a tick)::

    with retrace_guard(loads=(library_loads, 0),
                       syncs=(host_syncs, k * ticks)) as g:
        svc.serve(prompts)         # raises RetraceError past a limit
    g.counts()                     # {"loads": 0, "syncs": ...}
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

Counter = Callable[[], int]


class RetraceError(AssertionError):
    """A watched counter grew past its limit inside the guarded region."""


def library_loads() -> int:
    """Kernel libraries opened with ``ctypes`` so far in this process."""
    from ..kernels._build import LOADS

    return LOADS["cdll"]


def host_syncs() -> int:
    """Host syncs counted so far (:data:`repro_torch.sync.SYNCS`)."""
    from ..sync import SYNCS

    return SYNCS["host_any"]


def counter_value(counter: Any) -> int:
    """The current value of ``counter``, a callable returning an ``int``."""
    value = counter() if callable(counter) else None
    if not isinstance(value, int) or isinstance(value, bool):
        raise TypeError(f"{counter!r} is not a counter (a callable returning an int): "
                        "retrace_guard can only watch counters")
    return value


class RetraceGuard:
    """Context manager bounding each watched counter's growth."""

    def __init__(self, counters: Dict[str, Any], max_traces: int = 1):
        if not counters:
            raise ValueError("retrace_guard needs at least one counter")
        self._counters: Dict[str, Counter] = {}
        self.limits: Dict[str, int] = {}
        for name, watched in counters.items():
            counter, limit = watched if isinstance(watched, tuple) else (watched, max_traces)
            counter_value(counter)  # fail fast on a non-counter
            self._counters[name] = counter
            self.limits[name] = int(limit)
        self.max_traces = max_traces
        self._base: Optional[Dict[str, int]] = None

    def __enter__(self) -> "RetraceGuard":
        self._base = {n: counter_value(c) for n, c in self._counters.items()}
        return self

    def counts(self) -> Dict[str, int]:
        """Growth of each counter since the guard was entered."""
        if self._base is None:
            raise RuntimeError("retrace_guard not entered yet")
        return {n: counter_value(c) - self._base[n] for n, c in self._counters.items()}

    def check(self) -> None:
        """Raise :class:`RetraceError` if any counter grew past its limit."""
        offenders = {n: c for n, c in self.counts().items() if c > self.limits[n]}
        if offenders:
            detail = ", ".join(f"{n}: {c} (limit {self.limits[n]})"
                               for n, c in sorted(offenders.items()))
            raise RetraceError(
                f"past the limit inside the guarded region ({detail}): a library "
                "load after warm-up, or host syncs that grow with the call"
            )

    def __exit__(self, exc_type, exc, tb) -> None:
        # Don't mask an exception already unwinding through the region.
        if exc_type is None:
            self.check()


def retrace_guard(max_traces: int = 1, **counters: Any) -> RetraceGuard:
    """A :class:`RetraceGuard` over ``name=counter`` or ``name=(counter,
    limit)`` pairs; a bare counter's limit is ``max_traces``."""
    return RetraceGuard(counters, max_traces=max_traces)
