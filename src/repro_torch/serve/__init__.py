"""Serving on the port: the continuous pub-sub serve loop (admission
control, adaptive batching, K-deep dispatch on CUDA streams, latency
SLOs, poison quarantine, shadow-plan hot swap — see
:mod:`repro_torch.serve.loop`) and its chaos harness
(:mod:`repro_torch.serve.faults`)."""
from .loop import (ReconfigTicket, ServeLoop, ServeRequest,  # noqa: F401
                   burst_arrivals, make_arrivals, poisson_arrivals,
                   replay_arrivals, run_trace)

#: the chaos harness's names, loaded on first use so that
#: ``python -m repro_torch.serve.faults`` runs the module only once
_FAULTS = ("DEFAULT_PLAN", "FaultInjector", "FaultPlan", "chaos_workload",
           "run_chaos_trace")


def __getattr__(name):
    if name in _FAULTS:
        from . import faults

        return getattr(faults, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
