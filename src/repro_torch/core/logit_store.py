"""Top-k logit store (paper §3.2.2).

"we store only the k highest valued logits ... We found storing the
top-20 values for k to be sufficient."

The store is an on-disk archive of (values bf16, indices int32) pairs
per frame, written by the teacher's target-generation pass and read by
the student trainer.  ``topk_compress`` / ``reconstruct`` are the
in-memory codecs; selection runs the ``topk_logits`` kernel on the card.

This module keeps the codecs, the storage math and the **v1** store
(one compressed npz per shard), in the reference's exact on-disk
format: each package reads the other's shards.  The production archive
is ``store.LogitStoreV2`` (manifest-backed, memory-mapped,
wave-versioned), which reads v1 archives in place through its migration
path; producers write through ``pipeline.generate``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.distill import NEG_FILL
from repro_torch.kernels.topk_logits import topk_logits


def topk_compress(logits: torch.Tensor, k: int):
    """logits (..., V) -> (vals (..., k) bf16, idx (..., k) int32).

    Selection runs through ``kernels/topk_logits`` (the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor).  Softmax is
    shift-invariant and bf16 precision concentrates near 0, so values
    are stored max-shifted.
    """
    vals, idx = topk_logits(logits, k)
    return shift_to_bf16(vals), idx


def shift_to_bf16(vals: torch.Tensor) -> torch.Tensor:
    """Sorted top-k values -> the wire's max-shifted bf16 values."""
    return (vals - vals[..., :1]).to(torch.bfloat16)


def reconstruct(vals, idx, vocab: int):
    """Lossy reconstruction: missing logits filled with NEG_FILL.

    vals (..., k), idx (..., k) -> (..., vocab) float32.  The scatter
    writes the output in place, so nothing beyond the output is
    allocated (the reference's ``row_chunk`` bounds its functional
    scatter's copies; there are none here).  Loss paths should not call
    this: ``distill.chunked_topk_distill_ce`` consumes top-k directly.
    """
    vals = torch.as_tensor(vals)
    idx = torch.as_tensor(idx)
    k = vals.shape[-1]
    canvas = torch.full((vals.numel() // k, vocab), NEG_FILL,
                        dtype=torch.float32, device=vals.device)
    canvas.scatter_(-1, idx.reshape(-1, k).long(),
                    vals.reshape(-1, k).float())
    return canvas.reshape(tuple(vals.shape[:-1]) + (vocab,))


def iter_reconstruct(vals, idx, vocab: int, row_chunk: int = 1024):
    """Host-side streaming reconstruction: yields (lo, hi, block) over
    row blocks without ever allocating the full canvas."""
    k = vals.shape[-1]
    flat_v = np.asarray(host_array(vals, np.float32)).reshape(-1, k)
    flat_i = np.asarray(host_array(idx, np.int64)).reshape(-1, k)
    n = flat_v.shape[0]
    for lo in range(0, n, row_chunk):
        hi = min(lo + row_chunk, n)
        block = np.full((hi - lo, vocab), NEG_FILL, np.float32)
        np.put_along_axis(block, flat_i[lo:hi], flat_v[lo:hi], axis=-1)
        yield lo, hi, block


def host_array(a, dtype) -> np.ndarray:
    """A tensor (any device, bf16 included) or array -> numpy ``dtype``.
    A CUDA tensor is copied to the host in its own dtype first (the
    copy waits for the device), then widened there."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        a = a.float() if a.is_floating_point() else a
        a = a.numpy()
    return np.asarray(a, dtype=dtype)


def storage_bytes_per_frame(k: int) -> int:
    return k * (2 + 4)          # bf16 value + int32 index


def full_bytes_per_frame(vocab: int) -> int:
    return vocab * 4


@dataclass
class ShardMeta:
    n_frames: int
    k: int
    vocab: int


class LogitStore:
    """Directory of npz shards: one shard per (worker, sub-epoch chunk).

    Layout: <root>/shard_<i>.npz {vals, idx, utt_lens} + meta.json, the
    reference's v1 format.  Values are written as float16 in
    ``np.savez_compressed`` and read back as bf16: the reference's double
    rounding (bf16 -> f16 on disk -> bf16), kept exactly so that both
    packages read the same targets from either's shards.
    """

    def __init__(self, root: str, *, k: int = 20, vocab: int = 0):
        self.root = root
        self.k = k
        self.vocab = vocab
        os.makedirs(root, exist_ok=True)

    def append_shard(self, shard_id: int, vals, idx, utt_lens=None, *,
                     wave: int = 0):
        """The v2 spelling, so producers are store-agnostic; v1 has no
        wave generations -- the tag is accepted and dropped."""
        del wave
        return self.write_shard(shard_id, vals, idx, utt_lens)

    def write_shard(self, shard_id: int, vals, idx, utt_lens=None):
        vals = host_array(vals, np.float32)
        idx = host_array(idx, np.int32)
        path = os.path.join(self.root, f"shard_{shard_id:05d}.npz")
        np.savez_compressed(
            path, vals=vals.astype(np.float16), idx=idx,
            utt_lens=np.asarray(utt_lens if utt_lens is not None else
                                [vals.shape[0]], np.int32))
        with open(os.path.join(self.root, "meta.json"), "w") as f:
            json.dump({"k": self.k, "vocab": self.vocab}, f)
        return path

    def read_shard(self, shard_id: int):
        """-> (vals bf16, idx int32) CPU tensors."""
        path = os.path.join(self.root, f"shard_{shard_id:05d}.npz")
        with np.load(path) as z:
            vals = torch.from_numpy(z["vals"]).to(torch.bfloat16)
            idx = torch.from_numpy(z["idx"].astype(np.int32))
        return vals, idx

    def shards(self):
        return sorted(f for f in os.listdir(self.root)
                      if f.startswith("shard_"))

    def stats(self):
        n = 0
        for s in self.shards():
            with np.load(os.path.join(self.root, s)) as z:
                n += int(np.prod(z["idx"].shape[:-1]))
        return ShardMeta(n_frames=n, k=self.k, vocab=self.vocab)
