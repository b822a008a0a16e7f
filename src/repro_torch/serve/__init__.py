"""Continuous-batching serving for the port: the slot-stacked cache pool
(:mod:`repro_torch.serve.pool`), the engine with device-side decode
blocks, output guards and serve snapshots (:mod:`repro_torch.serve.engine`;
on the card a block is one CUDA-graph replay), the host-side FIFO
scheduler with deadline shedding and a retry lane
(:mod:`repro_torch.serve.scheduler`) and the seeded chaos-injection plans
(:mod:`repro_torch.serve.faults`).  :func:`naive_generate` is the
per-token oracle.
"""
from repro_torch.serve.engine import ServeConfig, ServeEngine, naive_generate
from repro_torch.serve.faults import FaultPlan, SimulatedCrash, seeded_plan
from repro_torch.serve.pool import gather_slot, init_pool_cache, scatter_slot
from repro_torch.serve.scheduler import (TERMINAL_STATES, FifoScheduler,
                                         Request, RequestRecord,
                                         poisson_requests, state_counts)

__all__ = [
    "ServeConfig", "ServeEngine", "naive_generate",
    "FaultPlan", "SimulatedCrash", "seeded_plan",
    "init_pool_cache", "scatter_slot", "gather_slot",
    "FifoScheduler", "Request", "RequestRecord", "poisson_requests",
    "TERMINAL_STATES", "state_counts",
]
