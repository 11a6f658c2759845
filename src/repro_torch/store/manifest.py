"""Manifest: the LogitStore v2 index — one JSON file naming every live shard.

The port's copy of the reference's ``store/manifest.py``: the same
classes and the same file, byte for byte (keys, key order, ``indent=1``),
so each package reads and commits the other's manifests.

The manifest is the store's single source of truth: a shard exists iff
the manifest names it.  Shard data files are written first (to
wave-tagged names that never collide with the live entries), then the
manifest is swapped atomically (`os.replace`) — so a reader holding the
old manifest always sees intact files, and a writer killed at any point
leaves each shard's old or new entry fully live, never torn bytes
(cross-shard wave consistency is the producer's ledger's job — see
``pipeline.generate``).

Superseded entries are *retired*, not deleted: they move to the
manifest's ``retired`` list with their files left on disk, so a reader
that pinned a wave at sub-epoch start (``train.data
.distill_shard_source(pin_wave=True)``) keeps reading consistent
targets while a new teacher wave lands.  ``LogitStoreV2.gc()`` —
invoked on store open — is what finally deletes retired files, along
with any staged-but-never-committed files a killed writer left behind.

Each entry records the shard's frame count, k, vocab, wave (teacher
generation tag — higher wave supersedes), on-disk file names, storage
format ("v2" raw .npy triple, memory-mappable; "v1-npz" the legacy
compressed archive, readable in place by the migration path), and a
sha256 checksum over the data files.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

MANIFEST_VERSION = 2


class StoreError(RuntimeError):
    """Base class for store integrity failures."""


class ShardCorruptionError(StoreError):
    """A shard's bytes no longer match its manifest checksum."""


class StaleWaveError(StoreError):
    """A writer tried to commit a shard older than the live one."""


@dataclass
class ShardEntry:
    shard_id: int
    wave: int
    n_frames: int
    k: int
    vocab: int
    files: Dict[str, str]            # role ("vals"/"idx"/"lens") -> relpath
    checksum: str                    # sha256 hex over the data files
    format: str = "v2"               # "v2" | "v1-npz"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ShardEntry":
        return cls(**d)


def file_checksum(paths, root: str) -> str:
    """sha256 over the named files' bytes, in sorted role order.

    Role names are mixed into the digest so swapping two same-sized
    files (vals <-> idx) cannot produce a colliding checksum.
    """
    h = hashlib.sha256()
    for role in sorted(paths):
        h.update(role.encode())
        with open(os.path.join(root, paths[role]), "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
    return h.hexdigest()


@dataclass
class Manifest:
    """In-memory manifest + atomic on-disk round-trip."""

    k: int = 0
    vocab: int = 0
    shards: Dict[int, ShardEntry] = field(default_factory=dict)
    retired: list = field(default_factory=list)   # superseded ShardEntry,
    version: int = MANIFEST_VERSION               # files pending gc()

    FILENAME = "manifest.json"

    # ------------------------------------------------------------------ io

    @classmethod
    def path_for(cls, root: str) -> str:
        return os.path.join(root, cls.FILENAME)

    @classmethod
    def exists(cls, root: str) -> bool:
        return os.path.exists(cls.path_for(root))

    @classmethod
    def load(cls, root: str) -> "Manifest":
        with open(cls.path_for(root)) as f:
            d = json.load(f)
        if d.get("version") != MANIFEST_VERSION:
            raise StoreError(f"manifest version {d.get('version')!r} "
                             f"!= {MANIFEST_VERSION}")
        shards = {int(sid): ShardEntry.from_json(e)
                  for sid, e in d.get("shards", {}).items()}
        retired = [ShardEntry.from_json(e) for e in d.get("retired", [])]
        return cls(k=d["k"], vocab=d["vocab"], shards=shards,
                   retired=retired)

    def save(self, root: str):
        """Atomic commit: full write to a temp file, then os.replace.

        A reader never observes a half-written manifest, and a writer
        killed before the replace leaves the previous manifest live.
        """
        payload = {"version": self.version, "k": self.k,
                   "vocab": self.vocab,
                   "shards": {str(sid): e.to_json()
                              for sid, e in sorted(self.shards.items())},
                   "retired": [e.to_json() for e in self.retired]}
        tmp = self.path_for(root) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path_for(root))

    # ------------------------------------------------------------- queries

    def entry(self, shard_id: int) -> ShardEntry:
        if shard_id not in self.shards:
            raise KeyError(f"shard {shard_id} not in manifest")
        return self.shards[shard_id]

    def shard_ids(self):
        return sorted(self.shards)

    def n_frames(self) -> int:
        return sum(e.n_frames for e in self.shards.values())

    def max_wave(self) -> int:
        return max((e.wave for e in self.shards.values()), default=-1)

    # -------------------------------------------------------------- update

    def supersede(self, entry: ShardEntry) -> Optional[ShardEntry]:
        """Install `entry`, moving the predecessor (if any) onto the
        ``retired`` list — its files stay on disk for readers that
        pinned the old wave, until ``LogitStoreV2.gc()``.

        Same-wave rewrites are allowed (shard contents are deterministic,
        so an idempotent retry rewrites in place); an *older* wave is a
        stale writer and is rejected.
        """
        old = self.shards.get(entry.shard_id)
        if old is not None and entry.wave < old.wave:
            raise StaleWaveError(
                f"shard {entry.shard_id}: wave {entry.wave} < live "
                f"wave {old.wave}")
        self.shards[entry.shard_id] = entry
        if old is not None and old.files == entry.files:
            return None                     # in-place rewrite: nothing retired
        if old is not None:
            self.retired.append(old)
        return old
