"""Port parity: the token-LM serving path (``serve/decode.py:TokenServer``,
``launch/steps.py:make_serve_step``, ``launch/serve.py``) against the
JAX reference's ``TokenServer`` on the host.

The same weights (reduced qwen2.5-3b, initialised in JAX, the embedding
table scaled by 1/sqrt(d_model) so sampling has a spread to draw from)
and the same requests go through both servers, with ``decode_kernel``
off (plain attention, argmax / full-vocab sampler) and on (the fused
ops, here their plain versions).  Bars: greedy tokens equal; sampled
tokens — fused (top_k <= 32), full-vocab, and mixed windows — equal
(each package draws its own noise with the same bits); the host-side
counts ``syncs``, ``steps`` and ``active_slot_steps`` equal.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as pserve  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.decode import TokenRequest, _validate_submit  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COUNTS = ("syncs", "steps", "active_slot_steps", "slot_steps", "admitted",
          "tokens_out")


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_reduced(jax_get_arch("qwen2.5-3b"))
    pcfg = reduced(get_arch("qwen2.5-3b"))
    jp = jax.device_get(jax_build_model(jcfg).init(jax.random.key(1)))
    jp["embed"] = jp["embed"] / np.sqrt(jcfg.d_model)
    return jcfg, pcfg, jp, params_from_numpy(jp, pcfg, device="cpu")


def _serve(lm, subs, *, decode_kernel, tiered=False, **kw):
    """Drain the same submissions through both servers (each with its
    own package's SLO tiers and THROUGHPUT policy when ``tiered``);
    returns ({rid: tokens} ref, {rid: tokens} port, ref server, port
    server)."""
    jcfg, pcfg, jp, pp = lm

    def make(pkg, cfg, params, **extra):
        if tiered:
            extra.update(tiers=pkg.TieredPolicy(), policy=pkg.THROUGHPUT)
        return pkg.TokenServer(cfg, params, decode_kernel=decode_kernel,
                               **kw, **extra)
    js = make(jserve, jcfg, jp)
    ps = make(pserve, pcfg, pp, device="cpu")
    for prompt, max_new, samp, tier in subs:
        js.submit(prompt, max_new=max_new, tier=tier,
                  sampling=None if samp is None else jserve.SamplingParams(**samp))
        ps.submit(prompt, max_new=max_new, tier=tier,
                  sampling=None if samp is None else pserve.SamplingParams(**samp))
    jd = {r: list(v.out) for r, v in js.drain().items()}
    pd = {r: list(v.out) for r, v in ps.drain().items()}
    return jd, pd, js, ps


def _requests(seed, n, vocab, sampled=()):
    rng = np.random.default_rng(seed)
    subs = []
    for i in range(n):
        prompt = rng.integers(1, vocab, int(rng.integers(3, 12))).astype(
            np.int32)
        samp = sampled[i] if i < len(sampled) else None
        subs.append((prompt, int(rng.integers(3, 9)), samp, None))
    return subs


def _same(jd, pd, js, ps):
    assert pd == jd
    for k in COUNTS:
        assert ps.stats[k] == js.stats[k], k


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_greedy_tokens_and_counts_match(lm, decode_kernel):
    subs = _requests(3, 7, lm[1].vocab_size)
    _same(*_serve(lm, subs, decode_kernel=decode_kernel, max_seq=64,
                  sync_every=4))


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_sampled_tokens_match(lm, decode_kernel):
    """top_k within the fused candidate set: a ``sample`` window."""
    samp = [dict(temperature=t, top_k=k, top_p=p, seed=100 + i)
            for i, (t, k, p) in enumerate([(1.0, 20, 0.95), (0.7, 8, 0.9),
                                           (1.3, 32, 1.0), (0.0, 5, 0.5),
                                           (1.0, 1, 0.8)])]
    jd, pd, js, ps = _serve(lm, _requests(4, 6, lm[1].vocab_size, samp),
                            decode_kernel=decode_kernel, max_seq=64,
                            sync_every=4)
    _same(jd, pd, js, ps)
    assert len(set(sum(pd.values(), []))) > 10      # it really samples


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_mixed_windows_match(lm, decode_kernel):
    """Wide rows (top_k 0 or > 32) beside fused ones: with the kernel
    server that is the ``mixed`` window."""
    samp = [dict(temperature=1.0, top_k=k, top_p=0.95, seed=200 + i)
            for i, k in enumerate([0, 33, 64, 20, 8])]
    _same(*_serve(lm, _requests(5, 6, lm[1].vocab_size, samp),
                  decode_kernel=decode_kernel, max_seq=64, sync_every=4))


def test_window_modes(lm):
    _, pcfg, _, pp = lm
    srv = pserve.TokenServer(pcfg, pp, decode_kernel=True, device="cpu")
    assert srv._window_mode() == "greedy"
    srv.submit(np.arange(1, 4), sampling=pserve.SamplingParams(1.0, 10))
    srv.submit(np.arange(1, 4), sampling=pserve.SamplingParams(1.0, 0))
    srv.pump()
    assert srv._window_mode() == "mixed"
    plain = pserve.TokenServer(pcfg, pp, decode_kernel=False, device="cpu")
    plain.submit(np.arange(1, 4), sampling=pserve.SamplingParams(1.0, 0))
    plain.pump()
    assert plain._window_mode() == "sample"


def test_eos_and_tiers_match(lm):
    _, pcfg, _, _ = lm
    subs = _requests(6, 6, pcfg.vocab_size)
    jd, _, _, _ = _serve(lm, subs, decode_kernel=False, max_seq=64,
                         sync_every=4)
    eos = jd[0][1]                      # a token request 0 emits
    _same(*_serve(lm, subs, decode_kernel=True, max_seq=64, sync_every=4,
                  eos_id=eos))
    tiered = [(p, m, None, "interactive" if i % 3 == 0 else "firehose")
              for i, (p, m, _, _) in enumerate(subs)]
    jd, pd, js, ps = _serve(lm, tiered, decode_kernel=True, max_seq=64,
                            tiered=True)
    assert pd == jd
    for k in COUNTS:
        assert ps.stats[k] == js.stats[k], k


def test_one_host_sync_per_window_and_slot_invariants(lm):
    _, pcfg, _, pp = lm
    srv = pserve.TokenServer(pcfg, pp, max_seq=64, sync_every=4,
                             device="cpu")
    for p, m, _, _ in _requests(7, 9, pcfg.vocab_size):
        srv.submit(p, max_new=m)
    while srv.queue.n_pending or srv.n_active:
        srv.pump()
        host, dev = srv.slot_positions()
        live = [i for i, s in enumerate(srv._slots) if s is not None]
        np.testing.assert_array_equal(host[live], dev[live])
    assert srv.stats["syncs"] * 4 == srv.stats["steps"]


def test_submit_validation_matches_reference(lm):
    _, pcfg, _, pp = lm
    srv = pserve.TokenServer(pcfg, pp, max_seq=16, device="cpu")
    for prompt, max_new in ((np.zeros((0,), np.int32), 4),
                            (np.zeros((2, 2), np.int32), 4),
                            (np.arange(1, 5), 0),
                            (np.arange(1, 15), 4)):
        with pytest.raises(ValueError):
            srv.submit(prompt, max_new=max_new)
        with pytest.raises(ValueError):
            jserve.decode._validate_submit(prompt, max_new, 16)
    assert _validate_submit(np.arange(1, 14), 4, 16).dtype == np.int32
    assert TokenRequest(0, np.arange(3)).out == []
    with pytest.raises(KeyError):
        pserve.TokenServer(pcfg, pp, tiers=pserve.TieredPolicy(),
                           device="cpu").submit(np.arange(1, 4), tier="x")
    with pytest.raises(ValueError, match="page budget"):
        pserve.TokenServer(pcfg, pp, paging=pserve.PagedCacheConfig(4, 3),
                           device="cpu").submit(np.arange(1, 12), max_new=3)
    with pytest.raises(ValueError, match="token-LM"):
        pserve.TokenServer(reduced(get_arch("lstm-am-7khr")), {},
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pserve.TokenServer(pcfg, pp)


def test_abort_recovers_and_reruns_identically(lm):
    """A failed window strands nothing: outputs reset, requests requeued,
    device state dropped; the re-run equals a clean run."""
    _, pcfg, _, pp = lm
    subs = _requests(8, 5, pcfg.vocab_size)

    def run(fail_once):
        srv = pserve.TokenServer(pcfg, pp, max_seq=64, sync_every=4,
                                 device="cpu")
        for p, m, _, _ in subs:
            srv.submit(p, max_new=m)
        if fail_once:
            good = srv.serve

            def bad(*a):
                srv.serve = good
                raise RuntimeError("injected")
            srv.serve = bad
            with pytest.raises(RuntimeError, match="injected"):
                srv.pump()
            assert srv._cache is None and srv.n_active == 0
        return {r: list(v.out) for r, v in srv.drain().items()}
    assert run(True) == run(False)


def test_serve_step_matches_argmax_and_refuses_the_am(lm):
    _, pcfg, _, pp = lm
    model = build_model(pcfg, device="cpu", params=pp)
    cache = model.init_cache(2, 8, per_row=True)
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    nxt, logits, _ = make_serve_step(model, pcfg)(cache, tok)
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], logits[:, -1].argmax(-1).to(torch.int32))
    cache = model.init_cache(2, 8, per_row=True)
    fused, _, _ = make_serve_step(model, pcfg, use_kernel=True)(cache, tok)
    assert torch.equal(fused, nxt)
    with pytest.raises(ValueError, match="token LM"):
        make_serve_step(model, reduced(get_arch("lstm-am-7khr")))


def test_launcher_serves_tokens_on_the_host(capsys):
    done = port_launch.main(["--arch", "qwen2.5-3b", "--device", "cpu",
                             "--requests", "3", "--max-new", "4"])
    assert done is None
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "host syncs" in out
    port_launch.main(["--arch", "qwen2.5-3b", "--device", "cpu",
                      "--requests", "2", "--no-decode-kernel"])
    assert "2 requests, 16 tokens" in capsys.readouterr().out


def test_launcher_module_runs_as_a_program():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "qwen2.5-3b", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "6 requests, 48 tokens" in out.stdout
