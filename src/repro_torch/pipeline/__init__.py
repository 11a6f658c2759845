"""The pipeline half of the million-hour data plane.

Producers: ``generate`` partitions target generation across N workers
(an engine per worker, disjoint manifest shard ranges, a resumable work
ledger) — the paper's "parallelize target generation" over ``store``.

Consumers: the reference's ``PrefetchingSource`` (an asynchronous
double-buffered host -> device feed for ``Trainer.fit``) is not ported
yet: looking it up raises, naming ROADMAP Queue 1, step 4.
"""
from repro_torch.pipeline.generate import (WorkLedger, WorkRange,
                                           generate_corpus, generate_sharded,
                                           prepare_ledger, shard_ranges)

__all__ = [
    "WorkLedger", "WorkRange", "shard_ranges", "prepare_ledger",
    "generate_sharded", "generate_corpus",
    "PrefetchingSource",
]


def __getattr__(name):
    if name == "PrefetchingSource":
        raise NotImplementedError(
            "PrefetchingSource is not ported yet (ROADMAP Queue 1, step 4: "
            "checkpoint, resume and prefetch)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
