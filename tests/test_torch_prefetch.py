"""The port's prefetching feed (``pipeline/prefetch.py``) on the host.

Twins of the reference's prefetch tests: order, bitwise equality with
the synchronous feed through ``Trainer.fit`` (a quadratic problem and
the AM's distill loss over a verified v2 store), an exhausted iterator
that stays exhausted, a producer error surfacing at the consumer, and an
early close that stops the producer.  On the host the feed stages with
a plain ``torch.as_tensor`` and creates no CUDA stream; the card's
pinned-memory, side-stream staging is held by ``chip_smoke.py``.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import LayerSpec, Segment  # noqa: E402
from repro_torch.configs.lstm_am_7khr import CONFIG  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.steps import make_loss_fn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.pipeline import PrefetchingSource  # noqa: E402
from repro_torch.store import LogitStoreV2  # noqa: E402
from repro_torch.train import (ListSink, Local, TrainBatch,  # noqa: E402
                               Trainer, distill_shard_source)
from repro_torch.train import data as train_data  # noqa: E402

K, V = 4, 30


def _quad(params, batch):
    e = torch.as_tensor(batch["x"]) @ params["w"] - torch.as_tensor(
        batch["y"])
    return torch.mean(e ** 2), {"loss": torch.mean(e ** 2).detach()}


def _quad_problem(seed=0, n=32, d=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ rng.normal(size=(d,))).astype(np.float32)
    return {"x": x, "y": y}


def test_prefetch_preserves_order():
    src = [TrainBatch({"i": np.asarray([i])}, 0.1, "t") for i in range(20)]
    out = [int(tb.data["i"][0])
           for tb in PrefetchingSource(src, depth=3, device="cpu")]
    assert out == list(range(20))


def test_prefetch_training_bitwise_equals_sync():
    batch = _quad_problem()
    src = lambda: [TrainBatch(batch, 0.05 * (0.9 ** i), "q")  # noqa: E731
                   for i in range(12)]
    sink_s, sink_p = ListSink(), ListSink()
    tr_s = Trainer(Local(clip=0.0), {"q": _quad}, metrics=sink_s)
    st_s = tr_s.fit(tr_s.init_state({"w": torch.zeros(8)}), src())
    tr_p = Trainer(Local(clip=0.0), {"q": _quad}, metrics=sink_p,
                   prefetch=3)
    st_p = tr_p.fit(tr_p.init_state({"w": torch.zeros(8)}), src())
    assert sink_s.values("loss") == sink_p.values("loss")
    assert torch.equal(st_s.params["w"], st_p.params["w"])


def test_prefetch_distill_shard_source_bitwise(tmp_path):
    """Distill shards fed synchronously and prefetched (the memory-map
    copy and verify=True's checksum on the producer thread, still
    counted in SHARD_COPIES) train to the same loss and params bitwise."""
    cfg = CONFIG.replace(
        lstm_hidden=16, feat_dim=8, n_senones=V, vocab_size=V,
        segments=(Segment((LayerSpec(mixer="lstm", ffn="none"),),
                          repeat=1),))
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    params = dict(model.state_dict())
    rng = np.random.default_rng(1)
    batches = [{"feats": rng.normal(size=(2, 6, 8)).astype(np.float32),
                "mask": np.ones((2, 6), np.float32)} for _ in range(4)]
    store = LogitStoreV2(str(tmp_path), k=K, vocab=V)
    for j in range(4):
        vals = rng.normal(size=(2, 6, K)).astype(np.float32)
        vals = vals - vals.max(-1, keepdims=True)
        idx = np.stack([rng.choice(V, K, replace=False)
                        for _ in range(12)]).reshape(2, 6, K)
        store.append_shard(j, vals, idx)

    loss_fns = {"distill_topk": make_loss_fn(model, cfg, "distill_topk")}
    outs = []
    for depth in (0, 2):
        sink = ListSink()
        train_data.SHARD_COPIES = 0
        tr = Trainer(Local(clip=0.0), loss_fns, metrics=sink,
                     prefetch=depth)
        st = tr.fit(tr.init_state(params),
                    distill_shard_source(batches, store, 0, 4, 0.05,
                                         verify=depth > 0))
        assert train_data.SHARD_COPIES == 4
        outs.append((sink.values("loss"), st.params))
    assert outs[0][0] == outs[1][0]
    for n in outs[0][1]:
        assert torch.equal(outs[0][1][n], outs[1][1][n])


def test_prefetch_exhausted_iterator_stays_exhausted():
    it = iter(PrefetchingSource([TrainBatch({"i": np.zeros(1)}, 0.1, "t")],
                                depth=2, device="cpu"))
    assert len(list(it)) == 1
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_propagates_producer_error():
    def bad():
        yield TrainBatch({"i": np.zeros(1)}, 0.1, "t")
        raise ValueError("decode failed")
    it = iter(PrefetchingSource(bad, depth=2, device="cpu"))
    next(it)
    with pytest.raises(ValueError, match="decode failed"):
        next(it)


def test_prefetch_error_surfaces_through_fit_after_the_good_updates():
    """A source that raises after its 3rd item: fit takes exactly 3
    updates' worth of items, then re-raises the producer's error."""
    batch = _quad_problem()

    def src():
        for i in range(3):
            yield TrainBatch(batch, 0.05, "q")
        raise RuntimeError("killed")

    sink = ListSink()
    tr = Trainer(Local(clip=0.0), {"q": _quad}, metrics=sink, prefetch=2)
    with pytest.raises(RuntimeError, match="killed"):
        tr.fit(tr.init_state({"w": torch.zeros(8)}), src())
    assert len(sink) == 3


def test_prefetch_early_close_stops_producer():
    produced = []

    def src():
        for i in range(1000):
            produced.append(i)
            yield TrainBatch({"i": np.asarray([i])}, 0.1, "t")

    ps = PrefetchingSource(src, depth=2, device="cpu")
    it = iter(ps)
    for _ in range(3):
        next(it)
    ps.close()
    ps.close()                                # idempotent
    n = len(produced)
    assert n < 1000
    time.sleep(0.1)
    assert len(produced) == n
    # a fresh iter() gets a fresh producer
    assert [int(tb.data["i"][0]) for tb, _ in zip(iter(ps), range(2))] == \
        [0, 1]
    ps.close()


def test_prefetch_skip_put_and_host_staging():
    """The first skip_put items pass through unstaged; the rest are
    staged with a plain torch.as_tensor on the host (shared memory, no
    copy) and lr/loss ride through untouched."""
    arrs = [np.full(3, i, np.float32) for i in range(4)]
    items = list(PrefetchingSource(
        [TrainBatch({"a": a, "n": i}, 0.1 * i, "t")
         for i, a in enumerate(arrs)], skip_put=2, device="cpu"))
    assert [type(tb.data["a"]) for tb in items] == \
        [np.ndarray, np.ndarray, torch.Tensor, torch.Tensor]
    assert items[3].data["a"].numpy().ctypes.data == arrs[3].ctypes.data
    assert [tb.data["n"] for tb in items] == [0, 1, 2, 3]
    assert [tb.lr for tb in items] == [0.0, 0.1, 0.2, 0.30000000000000004]


def test_staged_tensor_is_not_copied_again():
    """launch/steps._tensor passes a tensor already on the device (and of
    the asked dtype) through as the same object."""
    t = torch.arange(6, dtype=torch.float32)
    assert steps._tensor(t, t.device) is t
    assert steps._tensor(t, t.device, torch.float32) is t


def test_prefetch_defaults_to_the_card():
    ps = PrefetchingSource([TrainBatch({"i": np.zeros(1)}, 0.1, "t")])
    if torch.cuda.is_available():
        assert next(iter(ps)).data["i"].is_cuda
        ps.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            iter(ps)
    assert len(list(PrefetchingSource(
        [TrainBatch({"i": np.zeros(1)}, 0.1, "t")], device_put=False))) == 1
