"""Serving on the port: the continuous pub-sub serve loop (admission
control, adaptive batching, K-deep dispatch on CUDA streams, latency
SLOs, poison quarantine, shadow-plan hot swap — see
:mod:`repro_torch.serve.loop`)."""
from .loop import (ReconfigTicket, ServeLoop, ServeRequest,  # noqa: F401
                   burst_arrivals, make_arrivals, poisson_arrivals,
                   replay_arrivals, run_trace)
