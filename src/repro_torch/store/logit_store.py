"""LogitStore v2: manifest-backed sharded top-k archive (paper §3.2.2).

The port's twin of the reference's ``store/logit_store.py``: the same
on-disk layout, the same bytes for the same inputs, and the same reads
(numpy float16 / int32, memory-mapped for v2 shards, decompressed for
v1-npz), so each package reads, verifies, migrates and supersedes the
other's stores.  ``append_shard`` also takes tensors on any device
(bf16 included): they are copied to the host first, the shard's one
host sync, and then written exactly as the reference writes numpy
arrays.

Layout under <root>:

    manifest.json                        — the index (store.manifest)
    shards/shard_<id>_w<wave>.vals.npy   — (N..., k) float16, max-shifted
    shards/shard_<id>_w<wave>.idx.npy    — (N..., k) int32 vocab ids
    shards/shard_<id>_w<wave>.lens.npy   — (U,) int32 per-utterance lengths

Raw ``.npy`` (not the v1 compressed ``.npz``) so reads memory-map:
``read_shard`` costs an mmap + page faults for the touched frames, not a
full decompress — the student trainer streams a sub-epoch's shards
without ever holding more than its working set.

Write protocol (``append_shard``): data files land first under
wave-tagged names, the checksummed manifest entry commits via atomic
rename, and the superseded entry moves to the manifest's **retired**
list with its files left on disk.  The supersede is atomic **per
shard**: a reader sees each shard's old complete wave or its new
complete wave, never torn bytes, and a writer killed before the
manifest commit leaves that shard's previous wave live.  Retired files
are finally deleted by ``gc()`` — invoked on store open (also sweeping
any staged-but-never-committed files a killed writer leaked) — which is
what lets a consumer *pin* a wave for a whole sub-epoch
(``train.data.distill_shard_source(pin_wave=True)`` snapshots the live
entries and reads them via ``read_entry`` even while a regeneration
supersedes them concurrently).  The gc-on-open contract assumes the
single-writer-at-a-time discipline ``pipeline.generate``'s ledger
provides: never open a store for writing while another writer is
mid-stage.

Cross-shard consistency is the producer's job — a regeneration killed
mid-wave durably leaves earlier shards at the new wave and later ones
at the old, and ``pipeline.generate``'s resumable work ledger is what
closes that window: the next invocation re-claims the unfinished
ranges and completes the wave.

v1 stores (``shard_*.npz`` + ``meta.json``) migrate via ``migrate_v1``:
existing archives are indexed in place (format tag "v1-npz", checksum
computed at migration), readable through the same API, and superseded
shard-by-shard as a new wave rewrites them in v2 format.
"""
from __future__ import annotations

import json
import os
import re
from typing import List, Tuple

import numpy as np

from repro_torch.core.logit_store import ShardMeta, host_array
from repro_torch.runtime.procs import file_lock
from repro_torch.store.manifest import (Manifest, ShardCorruptionError,
                                        ShardEntry, StoreError,
                                        file_checksum)

_SHARD_DIR = "shards"
_V1_SHARD_RE = re.compile(r"shard_(\d+)\.npz$")


class LogitStoreV2:
    """Manifest-backed sharded archive of (vals f16, idx i32) per frame."""

    def __init__(self, root: str, *, k: int = 0, vocab: int = 0,
                 gc_on_open: bool = True, shared: bool = False):
        """``shared=True`` is the multi-process-writer mode: every
        manifest commit becomes a locked reload-merge-save (N worker
        processes with disjoint shard ids then interleave commits
        without losing each other's entries), and gc-on-open is forced
        off — a worker must never sweep a sibling's staged files.  The
        supervisor (single process, before the workers exist) opens the
        store unshared and does the gc."""
        self.root = root
        self.shared = shared
        if shared:
            gc_on_open = False
        os.makedirs(os.path.join(root, _SHARD_DIR), exist_ok=True)
        if Manifest.exists(root):
            self.manifest = Manifest.load(root)
            # a caller's k/vocab must agree with what is on disk; 0 means
            # "whatever the store says" (read-only consumers)
            if k and self.manifest.k and k != self.manifest.k:
                raise StoreError(f"store has k={self.manifest.k}, "
                                 f"caller wants k={k}")
            if vocab and self.manifest.vocab and vocab != self.manifest.vocab:
                raise StoreError(f"store has vocab={self.manifest.vocab}, "
                                 f"caller wants vocab={vocab}")
        elif _find_v1_shards(root):
            self.manifest = _index_v1(root, k=k, vocab=vocab)
            self.manifest.save(root)
        else:
            self.manifest = Manifest(k=k, vocab=vocab)
        self.k = self.manifest.k or k
        self.vocab = self.manifest.vocab or vocab
        if gc_on_open:
            # sweep retired waves + orphans a killed writer left behind.
            # gc_on_open=False is for readers deliberately racing a
            # live writer (they must not delete its staged files).
            self.gc()

    # -------------------------------------------------------------- write

    def _shard_files(self, shard_id: int, wave: int) -> dict:
        stem = os.path.join(_SHARD_DIR, f"shard_{shard_id:05d}_w{wave:04d}")
        return {"vals": stem + ".vals.npy", "idx": stem + ".idx.npy",
                "lens": stem + ".lens.npy"}

    def _write_shard_files(self, shard_id: int, vals, idx, utt_lens=None,
                           *, wave: int = 0) -> ShardEntry:
        """Stage a shard's data files on disk WITHOUT committing them to
        the manifest — split out so the commit is a separate, atomic
        step (and so tests can simulate a writer killed in between).
        Tensors (any device, bf16 included) are copied to the host
        first; the written bytes are the reference's for the same
        values."""
        vals = host_array(vals, np.float32).astype(np.float16)
        idx = host_array(idx, np.int32)
        if vals.shape != idx.shape:
            raise ValueError(f"vals {vals.shape} != idx {idx.shape}")
        lens = np.asarray(utt_lens if utt_lens is not None
                          else [int(np.prod(vals.shape[:-1]))], np.int32)
        files = self._shard_files(shard_id, wave)
        np.save(os.path.join(self.root, files["vals"]), vals)
        np.save(os.path.join(self.root, files["idx"]), idx)
        np.save(os.path.join(self.root, files["lens"]), lens)
        return ShardEntry(
            shard_id=shard_id, wave=wave,
            n_frames=int(np.prod(idx.shape[:-1])),
            k=int(idx.shape[-1]), vocab=self.vocab, files=files,
            checksum=file_checksum(files, self.root), format="v2")

    @property
    def _manifest_lock(self) -> str:
        return os.path.join(self.root, "manifest.lock")

    def _commit(self, entry: ShardEntry):
        """Manifest swap; the superseded entry is *retired* (files kept
        on disk for wave-pinned readers) and reclaimed by ``gc()``.

        Shared mode serializes the read-modify-write: under the
        manifest lock, the on-disk manifest (which siblings may have
        advanced) is reloaded, this entry superseded into *that*, and
        the result saved — so concurrent writers with disjoint shard
        ids compose instead of clobbering."""
        if not self.shared:
            self.manifest.supersede(entry)
            self.manifest.save(self.root)
            return
        with file_lock(self._manifest_lock):
            self.reload()
            self.manifest.supersede(entry)
            self.manifest.save(self.root)

    def reload(self):
        """Re-read the manifest from disk, where other writers' commits
        land (a no-op before the first commit)."""
        if Manifest.exists(self.root):
            self.manifest = Manifest.load(self.root)
            self.manifest.k = self.manifest.k or self.k
            self.manifest.vocab = self.manifest.vocab or self.vocab

    def append_shard(self, shard_id: int, vals, idx, utt_lens=None, *,
                     wave: int = 0) -> str:
        """Write one shard and commit it; returns the vals file path.

        With ``wave`` above the live entry's, the new shard atomically
        supersedes it (stale files retired after the manifest commit);
        an older wave raises StaleWaveError.
        """
        entry = self._write_shard_files(shard_id, vals, idx, utt_lens,
                                        wave=wave)
        self._commit(entry)
        return os.path.join(self.root, entry.files["vals"])

    # --------------------------------------------------------------- read

    def read_shard(self, shard_id: int, *, verify: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (vals (..., k) float16, idx (..., k) int32).

        v2 shards come back memory-mapped (zero-copy until touched);
        v1-npz entries decompress (the migration reader).  ``verify``
        recomputes the checksum first — it reads every byte, so it is
        the consumer's opt-in integrity gate, not the default.
        """
        return self.read_entry(self.manifest.entry(shard_id),
                               verify=verify)

    def read_entry(self, entry: ShardEntry, *, verify: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Read a shard through an explicit (possibly pinned) entry.

        This is the wave-pinning read path: a consumer snapshots the
        live entries at sub-epoch start and keeps reading *those* even
        if a concurrent regeneration supersedes them — retired files
        stay on disk until ``gc()``, so the pinned pass stays
        wave-consistent instead of silently mixing teachers mid-epoch.
        """
        if verify:
            self.verify_entry(entry)
        if entry.format == "v1-npz":
            with np.load(os.path.join(self.root, entry.files["npz"])) as z:
                return (z["vals"].astype(np.float16),
                        z["idx"].astype(np.int32))
        vals = np.load(os.path.join(self.root, entry.files["vals"]),
                       mmap_mode="r")
        idx = np.load(os.path.join(self.root, entry.files["idx"]),
                      mmap_mode="r")
        return vals, idx

    def read_lens(self, shard_id: int) -> np.ndarray:
        entry = self.manifest.entry(shard_id)
        if entry.format == "v1-npz":
            with np.load(os.path.join(self.root, entry.files["npz"])) as z:
                return z["utt_lens"].astype(np.int32)
        return np.load(os.path.join(self.root, entry.files["lens"]))

    # ---------------------------------------------------------- integrity

    def verify_shard(self, shard_id: int):
        self.verify_entry(self.manifest.entry(shard_id))

    def verify_entry(self, entry: ShardEntry):
        try:
            got = file_checksum(entry.files, self.root)
        except FileNotFoundError as e:
            raise ShardCorruptionError(
                f"shard {entry.shard_id} (wave {entry.wave}): data file "
                f"missing ({e}) — a pinned entry read after gc()?") from e
        if got != entry.checksum:
            raise ShardCorruptionError(
                f"shard {entry.shard_id} (wave {entry.wave}): checksum "
                f"{got[:12]}... != manifest {entry.checksum[:12]}...")

    def verify(self) -> int:
        """Checksum every live shard; returns the count verified."""
        for sid in self.manifest.shard_ids():
            self.verify_shard(sid)
        return len(self.manifest.shards)

    # ----------------------------------------------- garbage collection

    def gc(self) -> List[str]:
        """Reclaim dead shard files; returns the relpaths removed.

        Two populations die here (and only here — commits never delete):

        * files of **retired** entries — waves superseded while a
          pinned reader may still have been on them; by open time that
          reader is gone, so the previous wave's files go, and the
          manifest's retired list is cleared;
        * **orphans** in ``shards/`` referenced by no live or retired
          entry — staged by a writer that died between ``np.save`` and
          the manifest commit, which would otherwise leak forever (a
          resumed pass rewrites the same wave-tagged names, but an
          abandoned one never would).

        Runs on store open (``gc_on_open``).  Contract: no *other*
        writer is mid-stage on this root — the generation ledger's
        single-pass-at-a-time discipline.
        """
        live = {rel for e in self.manifest.shards.values()
                for rel in e.files.values()}
        removed = []

        def _rm(rel: str):
            path = os.path.join(self.root, rel)
            if os.path.exists(path):
                os.remove(path)
                removed.append(rel)

        # retired entries first: their files may live outside shards/
        # (v1-npz archives sit at the store root)
        for entry in self.manifest.retired:
            for rel in entry.files.values():
                if rel not in live:
                    _rm(rel)
        sdir = os.path.join(self.root, _SHARD_DIR)
        for fname in sorted(os.listdir(sdir)):
            rel = os.path.join(_SHARD_DIR, fname)
            if rel not in live:
                _rm(rel)
        if self.manifest.retired:
            self.manifest.retired = []
            self.manifest.save(self.root)
        return removed

    # ------------------------------------------------------------ queries

    def shards(self) -> List[int]:
        return self.manifest.shard_ids()

    def next_wave(self) -> int:
        return self.manifest.max_wave() + 1

    def stats(self) -> ShardMeta:
        """O(manifest) — v1 walked and decompressed every shard."""
        return ShardMeta(n_frames=self.manifest.n_frames(),
                         k=self.k, vocab=self.vocab)


# ------------------------------------------------------------ v1 migration

def _find_v1_shards(root: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(root):
        return []
    out = []
    for f in os.listdir(root):
        m = _V1_SHARD_RE.match(f)
        if m:
            out.append((int(m.group(1)), f))
    return sorted(out)


def _index_v1(root: str, *, k: int = 0, vocab: int = 0) -> Manifest:
    """Build a v2 manifest over an existing v1 archive, in place.

    The npz files are not rewritten — each becomes a "v1-npz" entry with
    a checksum computed now; subsequent waves supersede them with v2
    files shard-by-shard.
    """
    meta_path = os.path.join(root, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        k = k or int(meta.get("k", 0))
        vocab = vocab or int(meta.get("vocab", 0))
    manifest = Manifest(k=k, vocab=vocab)
    for sid, fname in _find_v1_shards(root):
        with np.load(os.path.join(root, fname)) as z:
            idx_shape = z["idx"].shape
        files = {"npz": fname}
        manifest.shards[sid] = ShardEntry(
            shard_id=sid, wave=0,
            n_frames=int(np.prod(idx_shape[:-1])),
            k=int(idx_shape[-1]), vocab=vocab, files=files,
            checksum=file_checksum(files, root), format="v1-npz")
    return manifest


def migrate_v1(root: str, *, k: int = 0, vocab: int = 0) -> LogitStoreV2:
    """Open a v1 archive as a v2 store (indexes shards, writes the
    manifest).  Idempotent: an already-migrated root just loads."""
    return LogitStoreV2(root, k=k, vocab=vocab)
