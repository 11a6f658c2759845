"""The store half of the million-hour data plane (paper §3.2.2).

"To reduce bandwidth and storage requirements as we parallelize across
multiple GPUs, we store only the k highest valued logits."  One frame
costs ``k * (2 + 4)`` bytes (a 16-bit value and an int32 index) instead
of ``vocab * 4``: k=20 against the paper's 3,183 senones is 120 bytes
against 12,732.

This package is LogitStore **v2**, the twin of the reference's
``store/``: a manifest-backed sharded archive (a JSON manifest carrying
per-shard frame counts, k, vocab, wave tag and checksum; memory-mapped
shard reads; append/retire semantics so a regenerated teacher wave
supersedes stale shards atomically), plus a migration reader that
serves v1 archives through the same API.  The codecs and the v1 store
stay in ``core.logit_store``; producers write through
``pipeline.generate`` and consumers read through
``train.data.distill_shard_source``.
"""
from repro_torch.store.logit_store import LogitStoreV2, migrate_v1
from repro_torch.store.manifest import (Manifest, ShardCorruptionError,
                                        ShardEntry, StaleWaveError,
                                        StoreError, file_checksum)


def __getattr__(name):
    # lazy, as the reference's: the byte math lives in the v1 module
    if name in ("storage_bytes_per_frame", "full_bytes_per_frame"):
        from repro_torch.core import logit_store as _v1
        return getattr(_v1, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "LogitStoreV2", "migrate_v1",
    "Manifest", "ShardEntry", "file_checksum",
    "StoreError", "ShardCorruptionError", "StaleWaveError",
    "storage_bytes_per_frame", "full_bytes_per_frame",
]
