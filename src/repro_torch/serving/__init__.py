"""Request-level serving of the port (counterpart of ``repro.serving``):
the Engine (DESIGN.md §6, §7, §9), the serving harness of DESIGN.md §10 —
CUDA-graph warmup, the async host loop, open-loop load and SLA metrics —
and the degradation ladder and fault model of DESIGN.md §11."""
from .engine import (Engine, FinishReason, Request, ServeSession,
                     StreamHandle, decode_one, default_chunk_buckets,
                     multi_decode, sample_per_slot)
from .warmup import GraphCache, shape_signature
from .host_loop import HostLoop, HostLoopCrash, TokenDelivery
from .loadgen import Arrival, WorkloadSpec, poisson_trace, run_open_loop
from .metrics import (MetricsRecorder, RequestRecord, find_saturation,
                      goodput, percentiles)
from .faults import (FAULT_KINDS, ChaosEvent, ChaosSpec, chaos_trace,
                     TickClock, FaultInjector)

__all__ = ["Engine", "FinishReason", "Request", "ServeSession",
           "StreamHandle", "decode_one", "default_chunk_buckets",
           "multi_decode", "sample_per_slot",
           "GraphCache", "shape_signature",
           "HostLoop", "HostLoopCrash", "TokenDelivery",
           "Arrival", "WorkloadSpec", "poisson_trace", "run_open_loop",
           "MetricsRecorder", "RequestRecord", "find_saturation", "goodput",
           "percentiles",
           "FAULT_KINDS", "ChaosEvent", "ChaosSpec", "chaos_trace",
           "TickClock", "FaultInjector"]
