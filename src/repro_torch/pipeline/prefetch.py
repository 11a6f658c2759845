"""Async prefetching feed: decode ahead on a host thread, stage on the card.

``PrefetchingSource`` wraps any DataSource (iterable of TrainBatch) so
that while the update consumes batch *n*, a background thread is already
producing batch *n+1..n+depth* (whatever the wrapped source does: the
copy of a v2 shard out of its memory map and ``verify=True``'s checksum
in ``distill_shard_source``, the synthetic corpus's featurization in
``CorpusLoader``) and staging it on the device.

Staging on the card: the producer copies each array of ``data`` into a
pinned host tensor and issues its ``.to(device, non_blocking=True)`` on
its own ``torch.cuda.Stream``, then records an event.  The consumer's
``__next__`` makes its current stream wait on that event and calls
``record_stream`` on each staged tensor, so the caching allocator does
not hand the memory to another tensor before the update is done with
it.  The pinned buffers need no holding here: a ``non_blocking`` copy out
of pinned memory records an event with PyTorch's caching host
allocator, which does not reuse the block until that copy has ended, so
a buffer dropped early (an item discarded by ``close()`` included) is
never overwritten under its copy.  The update's own ``.to(device)`` then
finds the tensor in place (``launch/steps.py:_tensor``) and copies
nothing.  On the host, staging is a plain ``torch.as_tensor``; no CUDA
stream is created.

Determinism: one producer thread and one bounded FIFO queue, so the
wrapped source's order is preserved exactly and training through a
prefetching source is bitwise-identical to the synchronous feed.
``lr`` and ``loss`` ride through untouched (Schedule objects included);
only ``data`` is staged.

Lifecycle, as the reference's: each ``iter()`` spawns a fresh daemon
producer; a consumer that stops early (``Trainer.fit``'s
``max_updates``) calls ``close()`` (the Trainer does), which is
idempotent; an exhausted iterator stays exhausted; a producer exception
is re-raised at the consumer's next ``__next__``, not swallowed.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.kernels._dispatch import resolve_device

# NOTE: no repro_torch.train import here: repro_torch.train re-exports
# this module, and TrainBatch is handled structurally
# (dataclasses.replace)

_DONE = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class _Staged:
    """A TrainBatch whose arrays were issued on the side stream."""
    item: object
    event: torch.cuda.Event


def _map(fn, data):
    """``fn`` over every array or tensor of a nested dict/list batch."""
    if isinstance(data, dict):
        return {k: _map(fn, v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(_map(fn, v) for v in data)
    if isinstance(data, (np.ndarray, torch.Tensor)):
        return fn(data)
    return data


class _PrefetchIterator(Iterator):
    def __init__(self, source: Iterable, depth: int,
                 device: Optional[torch.device], skip_put: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._device = device
        self._skip_put = skip_put
        self._stream = (torch.cuda.Stream(device) if device is not None
                        and device.type == "cuda" else None)
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),),
            name="prefetch-producer", daemon=True)
        self._thread.start()

    def _stage(self, tb):
        if self._stream is None:
            return dataclasses.replace(tb, data=_map(torch.as_tensor,
                                                     tb.data))

        def put(a):
            t = torch.as_tensor(a)
            if t.is_cuda:
                return t
            # a contiguous pinned copy: staged through pin_memory(), a
            # strided view (a CE batch's feature window) reached the card
            # by a pageable copy
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host.to(self._device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            data = _map(put, tb.data)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(dataclasses.replace(tb, data=data), event)

    def _produce(self, it):
        try:
            for n, tb in enumerate(it):
                # a resuming consumer replays-and-drops the first
                # skip_put items: don't pay their device transfer
                stage = self._device is not None and n >= self._skip_put
                item = self._stage(tb) if stage else tb
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                else:
                    return                   # consumer closed early
            self._put_final(_DONE)
        except BaseException as e:           # surface in the consumer
            self._put_final(_Failure(e))

    def _put_final(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._stop.set()        # exhausted stays exhausted: the next
            raise StopIteration     # call must not park on an empty queue
        if isinstance(item, _Failure):
            self._stop.set()
            raise item.exc
        if isinstance(item, _Staged):
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(item.event)
            _map(lambda t: t.record_stream(cur) if t.is_cuda else None,
                 item.item.data)
            return item.item
        return item

    def close(self):
        """Stop the producer and release the queue (idempotent)."""
        self._stop.set()
        while True:                          # unblock a parked producer
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=2.0)


class PrefetchingSource:
    """DataSource combinator: ``PrefetchingSource(source, depth=2)``.

    Composes with every source in ``repro_torch.train.data`` (epoch,
    distill-shard, scheduled, chain): anything iterable of TrainBatch.
    Pass a zero-arg factory instead of an iterable when the source must
    be rebuilt per iteration (generators are single-shot).
    ``device_put=False`` only moves production to the thread;
    ``device`` is where batches are staged (the card unless the caller
    asks for another device, as every entry point of the port).
    """

    def __init__(self, source, *, depth: int = 2, device_put: bool = True,
                 skip_put: int = 0, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = source
        self.depth = depth
        self.device_put = device_put
        self.device = device
        # items known to be replay-skipped by the consumer (resume):
        # produced and queued, but not staged on the device
        self.skip_put = skip_put
        self._live: Optional[_PrefetchIterator] = None

    def __iter__(self) -> _PrefetchIterator:
        self.close()                 # never orphan a previous producer
        device = resolve_device(self.device) if self.device_put else None
        src = self._source() if callable(self._source) else self._source
        self._live = _PrefetchIterator(src, self.depth, device,
                                       self.skip_put)
        return self._live

    def close(self):
        if self._live is not None:
            self._live.close()
            self._live = None
