"""Pluggable metrics sinks for the Trainer.

A sink receives one ``emit(step, tag, metrics)`` per optimizer update
with plain-float scalars (the Trainer reads them off the device).
``tag`` is the loss kind of the update ("ce", "distill_topk", ...), so
one sink can separate the interleaved phases of a scheduled run.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Protocol, Tuple, runtime_checkable


@runtime_checkable
class MetricsSink(Protocol):
    def emit(self, step: int, tag: str, metrics: Dict[str, float]) -> None:
        ...


class ListSink:
    """In-memory record: [(step, tag, metrics)] + convenience accessors."""

    def __init__(self):
        self.records: List[Tuple[int, str, Dict[str, float]]] = []

    def emit(self, step, tag, metrics):
        self.records.append((step, tag, dict(metrics)))

    def values(self, key: str, tag: str = None) -> List[float]:
        return [m[key] for _, t, m in self.records
                if key in m and (tag is None or t == tag)]

    def last(self, key: str, tag: str = None):
        vs = self.values(key, tag)
        return vs[-1] if vs else None

    def first(self, key: str, tag: str = None):
        vs = self.values(key, tag)
        return vs[0] if vs else None

    def __len__(self):
        return len(self.records)


class JsonlSink:
    """Append-only JSONL file — the artifact form for experiment dirs."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def emit(self, step, tag, metrics):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "tag": tag, **metrics}) + "\n")


class TeeSink:
    """Fan one emit out to several sinks."""

    def __init__(self, *sinks: MetricsSink):
        self.sinks = sinks

    def emit(self, step, tag, metrics):
        for s in self.sinks:
            s.emit(step, tag, metrics)
