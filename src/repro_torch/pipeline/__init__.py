"""The pipeline half of the million-hour data plane.

Producers: ``generate`` partitions target generation across N workers
(an engine per worker, disjoint manifest shard ranges, a resumable work
ledger) — the paper's "parallelize target generation" over ``store``.

Consumers: ``prefetch.PrefetchingSource``, the asynchronous
double-buffered host -> device feed for ``Trainer.fit`` (a producer
thread, pinned host memory and a side CUDA stream).
"""
from repro_torch.pipeline.generate import (WorkLedger, WorkRange,
                                           generate_corpus, generate_sharded,
                                           prepare_ledger, shard_ranges)
from repro_torch.pipeline.prefetch import PrefetchingSource

__all__ = [
    "WorkLedger", "WorkRange", "shard_ranges", "prepare_ledger",
    "generate_sharded", "generate_corpus",
    "PrefetchingSource",
]

