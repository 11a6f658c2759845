"""Batched streaming-inference engine for the acoustic model (paper
§3.2.2 framing: teacher target generation and online serving are the
same workload under different batching policies).

  StreamServer — streaming-AM sessions over the slot core
      (``SlotServer`` in serve/slots.py): per-row recurrent state,
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
from repro_torch.serve.engine import (StreamFeed, StreamingEngine,
                                      make_topk_emitter)
from repro_torch.serve.request import (CompletedRequest, InferenceRequest,
                                       RequestQueue)
from repro_torch.serve.slots import SlotServer
from repro_torch.serve.stream import StreamServer, StreamSession

__all__ = [
    "BatchPolicy", "THROUGHPUT", "LATENCY", "FormedBatch", "bucket_length",
    "form_batches", "padding_efficiency", "SLOTier", "TieredPolicy",
    "SLO_DEFAULT", "INTERACTIVE", "FIREHOSE", "SlotServer",
    "StreamingEngine", "StreamFeed", "StreamServer", "StreamSession",
    "make_topk_emitter", "InferenceRequest", "CompletedRequest",
    "RequestQueue",
]
