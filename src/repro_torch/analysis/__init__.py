"""Runtime tooling of the port (counterpart of ``repro.analysis``).

:mod:`repro_torch.analysis.retrace_guard` pins what a hot path may repeat
per call.  The static pass, ``repro-lint`` (``repro.analysis.lint``),
already lints the port's sources as they are, so it has no counterpart
here.
"""

from .retrace_guard import (  # noqa: F401
    RetraceError,
    RetraceGuard,
    counter_value,
    host_syncs,
    library_loads,
    retrace_guard,
)

__all__ = [
    "RetraceError",
    "RetraceGuard",
    "counter_value",
    "host_syncs",
    "library_loads",
    "retrace_guard",
]
