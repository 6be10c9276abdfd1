"""Request-level serving of the port (counterpart of ``repro.serving``)."""
from .engine import (Engine, FinishReason, Request, ServeSession,
                     StreamHandle, multi_decode, sample_per_slot)

__all__ = ["Engine", "FinishReason", "Request", "ServeSession",
           "StreamHandle", "multi_decode", "sample_per_slot"]
