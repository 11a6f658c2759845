"""Serving surfaces, both session types over one slot-based core
(``SlotServer`` in serve/slots.py: slot admit/retire, mid-flight
admission, device-side emission windows with one host sync per
``sync_every`` steps, failure recovery, honest utilization stats).

  TokenServer — token-LM sessions: per-row cache positions, ragged
      prefill, EOS retirement; ``submit(..., sampling=SamplingParams(...))``
      enables per-request temperature / top-k / top-p sampling, and
      ``decode_kernel=True`` the fused decode_attention / topk_sample
      kernels.
  StreamServer — streaming-AM sessions: per-row recurrent state,
      ragged chunk consumption, one host sync per window, mid-flight
      detach/reattach (bitwise state round-trip).
  SLOTier / TieredPolicy / INTERACTIVE / FIREHOSE — SLO tiers with
      per-tier sync_every / max_batch and admission control that sheds
      or parks firehose streams under interactive pressure.
  StreamingEngine — bucketed batch inference (the bidirectional
      teacher's path) + per-stream chunked streaming with carried state.
  BatchPolicy / THROUGHPUT / LATENCY — batch-formation policies.
"""
from repro_torch.serve.batcher import (FIREHOSE, INTERACTIVE, LATENCY,
                                       SLO_DEFAULT, THROUGHPUT, BatchPolicy,
                                       FormedBatch, SLOTier, TieredPolicy,
                                       bucket_length, form_batches,
                                       padding_efficiency)
from repro_torch.serve.decode import TokenRequest, TokenServer
from repro_torch.serve.engine import (StreamFeed, StreamingEngine,
                                      make_topk_emitter)
from repro_torch.serve.request import (CompletedRequest, InferenceRequest,
                                       RequestQueue)
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.serve.slots import SlotServer
from repro_torch.serve.stream import StreamServer, StreamSession

__all__ = [
    "BatchPolicy", "THROUGHPUT", "LATENCY", "FormedBatch", "bucket_length",
    "form_batches", "padding_efficiency", "SLOTier", "TieredPolicy",
    "SLO_DEFAULT", "INTERACTIVE", "FIREHOSE", "SlotServer",
    "StreamingEngine", "StreamFeed", "StreamServer", "StreamSession",
    "make_topk_emitter", "InferenceRequest", "CompletedRequest",
    "RequestQueue", "TokenServer", "TokenRequest", "SamplingParams",
    "GREEDY",
]
