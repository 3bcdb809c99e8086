"""Continuous-batching inference server: a request queue with arrival-time
admission (``queue``), slot-based KV-cache bookkeeping (``slots``) and the
prefill/decode interleave engine (``engine``) that packs ready prompts into
free cache lanes, runs chunked fused prefill (``Model.prefill``) and steps
every active lane through one decode step per tick."""
from repro_torch.serve.engine import (ServeEngine, ServeReport,
                                      generate_batch_loop)
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.slots import Slot, SlotManager

__all__ = ["Request", "RequestQueue", "Slot", "SlotManager", "ServeEngine",
           "ServeReport", "generate_batch_loop"]
