"""Port parity: training the token LM (step 10d) and explicit positions
(step 10b) against the JAX package on the host.

The same weights (the reference's init, carried by
``checkpoint/convert.py``) and the same seeded numpy batches go through
both packages; the reference's gradients come back through the same
unstacking (``params_from_numpy`` of its gradient tree).  Bars, each
relative to max(1, |reference|): forwards and losses within 1e-5;
gradients within 1e-5 of the largest reference gradient of the model
and within 1e-4 of the largest of their own leaf;
one Adam update's parameters and moments within 1e-5; the smoke's four
losses (four Adam steps apart) within 1e-4.  On the card
``chip_smoke.py:phase_lm_train`` holds the kernel path to the plain one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, mla  # noqa: E402
from repro_torch.train.strategies import loss_and_grads  # noqa: E402

REL = 1e-5
GRAD_LEAF_REL = 1e-4
SMOKE_REL = 1e-4
S = 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced widths: torch's intra-op threads only contend under the
    suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, ref, scale=None):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    den = np.maximum(1.0, np.abs(ref)) if scale is None else max(1.0, scale)
    return float((np.abs(a - ref) / den).max())


def _pair(arch, seed=0):
    """(reference cfg, port cfg, reference model, its params, the port's
    state dict, the port model) on the reference's init at ``seed``."""
    jcfg = jax_configs.reduced(jax_configs.get_arch(arch))
    pcfg = configs.reduced(configs.get_arch(arch))
    jm = jax_build_model(jcfg)
    jp = jax.device_get(jax.jit(jm.init)(jax.random.key(seed)))
    pp = params_from_numpy(jax.device_get(jp), pcfg, device="cpu")
    return jcfg, pcfg, jm, jp, pp, build_model(pcfg, device="cpu", params=pp)


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen2.5-3b")


@pytest.fixture(scope="module")
def deepseek():
    return _pair("deepseek-v3-671b", seed=7)


def _batch(cfg, kind="ce", b=2, s=S, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1]}
    if kind == "ce":
        batch["labels"] = tok[:, 1:]
    else:
        batch["topk_vals"] = rng.normal(size=(b, s, 5)).astype(np.float32)
        batch["topk_idx"] = rng.integers(0, cfg.vocab_size,
                                         (b, s, 5)).astype(np.int32)
    return batch


def _jax_loss_grads(jm, jcfg, jp, kind, batch):
    fn = jax_steps.make_loss_fn(jm, jcfg, kind)
    (_, met), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: float(v) for k, v in met.items()}, jax.device_get(g)


def _port_loss_grads(pm, pcfg, pp, kind, batch):
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in pp.items()}
    loss, met = steps.make_loss_fn(pm, pcfg, kind)(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert float(met["total_loss"]) == float(loss.detach())
    return ({k: float(v) for k, v in met.items()},
            dict(zip(leaves, grads)))


def _check_grads(pg, jg, pcfg):
    """Every port gradient leaf within REL of the model's largest
    reference gradient and within GRAD_LEAF_REL of its own leaf's largest
    (floored at 1e-6 of the model's), so a small leaf is held too."""
    want = params_from_numpy(jg, pcfg, device="cpu")
    assert set(pg) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    for n, g in pg.items():
        w = want[n].numpy()
        assert _rel(g.numpy(), w, scale=top) <= REL, n
        own = max(float(np.abs(w).max()), 1e-6 * top)
        assert float(np.abs(g.numpy() - w).max()) / own <= GRAD_LEAF_REL, n


def _positions(s, shift=7, negative=(2, 11)):
    p = np.arange(s, dtype=np.int32) + shift
    p[list(negative)] = -1
    return p


# ------------------------------------------------------- explicit positions

@pytest.mark.parametrize("arch,window", [("qwen2.5-3b", None),
                                         ("h2o-danube-3-4b", 8)])
def test_attention_apply_at_explicit_positions(arch, window):
    """Causal (qwen2.5-3b: the positions mask, two rows that see no key)
    and banded (h2o-danube-3-4b, window 8 < S: RoPE at the positions, the
    mask by index, as the reference's windowed branch)."""
    jcfg = jax_configs.reduced(jax_configs.get_arch(arch))
    pcfg = configs.reduced(configs.get_arch(arch))
    jspec = jcfg.segments[0].pattern[0]
    pspec = pcfg.segments[0].pattern[0]
    if window:
        jspec = jspec.__class__(**{**vars(jspec), "window": window})
        pspec = pspec.__class__(**{**vars(pspec), "window": window})
    assert (pspec.mixer == "swa") == bool(window)
    p = jax.device_get(jax_attn.init_attention(jax.random.key(2), jcfg,
                                               jspec))
    x = np.random.default_rng(3).normal(size=(2, S, pcfg.d_model)).astype(
        np.float32)
    pos = _positions(S)
    want = jax.jit(jax_attn.attention_apply, static_argnums=(1, 2))(
        p, jcfg, jspec, jnp.asarray(x), jnp.asarray(pos))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got = attn.attention_apply(tp, pcfg, pspec, torch.from_numpy(x),
                               torch.from_numpy(pos))
    assert _rel(got.detach().numpy(), want) <= REL


def test_mla_apply_and_model_at_explicit_positions(deepseek):
    """``mla_apply`` and deepseek-v3's ``Transformer.apply`` (MLA, an MoE
    layer) at shifted positions with rows that see no key."""
    jcfg = jax_configs.reduced(jax_configs.get_arch("deepseek-v3-671b"))
    pcfg = configs.reduced(configs.get_arch("deepseek-v3-671b"))
    p = jax.tree_util.tree_map(np.array, jax.device_get(
        jax_mla.init_mla(jax.random.key(4), jcfg)))
    x = np.random.default_rng(5).normal(size=(2, S, pcfg.d_model)).astype(
        np.float32)
    pos = _positions(S, shift=3)
    want = jax.jit(jax_mla.mla_apply, static_argnums=1)(
        p, jcfg, jnp.asarray(x), jnp.asarray(pos))

    def tt(tree):
        return {k: tt(v) if isinstance(v, dict) else torch.from_numpy(v)
                for k, v in tree.items()}
    got = mla.mla_apply(tt(p), pcfg, torch.from_numpy(x),
                        torch.from_numpy(pos))
    assert _rel(got.numpy(), want) <= REL
    jcfg, pcfg, jm, jp, _, pm = deepseek
    tok = _batch(pcfg)["tokens"]
    jh, jaux = jax.jit(jm.apply)(jp, jnp.asarray(tok),
                                 positions=jnp.asarray(pos))
    with torch.no_grad():
        ph, paux = pm.apply(torch.from_numpy(tok),
                            positions=torch.from_numpy(pos))
    assert _rel(ph.numpy(), jh) <= REL
    assert set(paux) == set(jaux)
    for k in paux:
        assert _rel(float(paux[k]), float(jaux[k])) <= REL, k


# ------------------------------------------------------------------ losses

@pytest.fixture(scope="module")
def recurrentgemma():
    return _pair("recurrentgemma-2b", seed=2)


@pytest.fixture(scope="module")
def xlstm():
    return _pair("xlstm-350m", seed=3)


@pytest.mark.parametrize("kind", ["ce", "distill_topk"])
@pytest.mark.parametrize("arch", ["qwen", "recurrentgemma", "xlstm"])
def test_loss_and_grads_match_reference(request, arch, kind):
    """Dense attention (qwen2.5-3b) and the recurrent mixers
    (recurrentgemma-2b: RG-LRU's scan and the local attention; xlstm-350m:
    the mLSTM and sLSTM state writes): every leaf reaches the loss
    (autograd is strict) and its gradient equals the reference's."""
    jcfg, pcfg, jm, jp, pp, pm = request.getfixturevalue(arch)
    batch = _batch(pcfg, kind)
    jmet, jg = _jax_loss_grads(jm, jcfg, jp, kind, batch)
    pmet, pg = _port_loss_grads(pm, pcfg, pp, kind, batch)
    assert set(pmet) == set(jmet) == {"loss", "total_loss"}
    for k in pmet:
        assert _rel(pmet[k], jmet[k]) <= REL, k
    _check_grads(pg, jg, pcfg)


def test_mtp_and_moe_aux_terms_match_reference(deepseek):
    """deepseek-v3 (MLA, a dense and an MoE layer, one MTP block): the
    CE, the MoE load-balancing sum and the total with 0.01 x lb + 1e-4 x
    z and 0.3 x the MTP CE, loss and every gradient; qwen3-moe: the aux
    terms alone."""
    jcfg, pcfg, jm, jp, pp, pm = deepseek
    batch = _batch(pcfg, s=16)
    jmet, jg = _jax_loss_grads(jm, jcfg, jp, "ce", batch)
    pmet, pg = _port_loss_grads(pm, pcfg, pp, "ce", batch)
    assert set(pmet) == set(jmet) == {"loss", "moe_lb", "total_loss"}
    for k in pmet:
        assert _rel(pmet[k], jmet[k]) <= REL, k
    assert pmet["total_loss"] > pmet["loss"] + pcfg.router_aux_weight * \
        pmet["moe_lb"]                              # the MTP term is in
    _check_grads(pg, jg, pcfg)
    assert float(pg["mtp.proj"].abs().max()) > 0
    jcfg, pcfg, jm, jp, pp, pm = _pair("qwen3-moe-30b-a3b", seed=8)
    batch = _batch(pcfg, s=16)
    _, want = jax.jit(jax_steps.make_loss_fn(jm, jcfg, "ce"))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        _, got = steps.make_loss_fn(pm, pcfg, "ce")(pp, batch)
    assert set(got) == {"loss", "moe_lb", "total_loss"}
    for k in got:
        assert _rel(float(got[k]), float(want[k])) <= REL, k


# ------------------------------------------------------- optimizer, smoke

def test_loss_and_grads_strict_but_for_unreached(deepseek):
    """``loss_and_grads`` under deepseek-v3's distill loss: the MTP block
    (the loss's named ``unreached``) gets zeros, as under JAX's grad, and
    every other leaf the reference's gradient; a loss that leaves any
    other leaf out raises."""
    jcfg, pcfg, jm, jp, pp, pm = deepseek
    batch = _batch(pcfg, "distill_topk", s=16)
    loss_fn = steps.make_loss_fn(pm, pcfg, "distill_topk")
    assert loss_fn.unreached == ("mtp.",)
    assert not hasattr(steps.make_loss_fn(pm, pcfg, "ce"), "unreached")
    jmet, jg = _jax_loss_grads(jm, jcfg, jp, "distill_topk", batch)
    loss, met, pg = loss_and_grads(loss_fn, pp, batch)
    assert _rel(float(loss), jmet["total_loss"]) <= REL
    assert set(pg) == set(pp)
    assert all(not pg[n].any() for n in pg if n.startswith("mtp."))
    _check_grads(pg, jg, pcfg)

    def embed_only(params, batch):
        return params["embed"].square().sum(), {}
    with pytest.raises(RuntimeError, match="not have been used"):
        loss_and_grads(embed_only, pp, batch)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b",
                                  "recurrentgemma-2b", "xlstm-350m",
                                  "whisper-medium"])
def test_init_statistics_match_reference(arch):
    """The port's own seeded init draws every leaf from the reference's
    distribution: constants equal, means and standard deviations within
    6 standard errors (6 sigma / sqrt(n)).  With the reference's tied
    N(0, 1) embedding, this is why the first CE at full widths sits far
    above ln V (``chip_smoke.py:phase_lm_train`` (d) logs the input
    token's own logit beside it)."""
    jcfg = jax_configs.reduced(jax_configs.get_arch(arch))
    pcfg = configs.reduced(configs.get_arch(arch))
    ref = params_from_numpy(jax.device_get(jax.jit(
        jax_build_model(jcfg).init)(jax.random.key(0))), pcfg, device="cpu")
    own = build_model(pcfg, device="cpu", generator=torch.Generator()
                      .manual_seed(0)).state_dict()
    assert set(own) == set(ref)
    for n, r in ref.items():
        p = own[n]
        assert p.shape == r.shape and p.dtype == r.dtype, n
        r, p = r.double(), p.double()
        sd = float(r.std()) if r.numel() > 1 else 0.0
        if sd == 0.0:
            assert torch.equal(p, r), n
            continue
        se = 6 / np.sqrt(r.numel())
        assert abs(float(p.mean() - r.mean())) <= se * sd, n
        assert abs(float(p.std()) / sd - 1) <= se, n


def test_adam_update_matches_reference(qwen):
    """One ``make_train_step(optimizer="adam")`` update at lr 3e-4 (clip
    1.0): the parameters, the moments and the step count."""
    jcfg, pcfg, jm, jp, pp, pm = qwen
    batch = _batch(pcfg, seed=9)
    jstep = jax.jit(jax_steps.make_train_step(jm, jcfg, optimizer="adam"))
    jp2, jo2, jmet = jstep(jp, jax_steps.init_opt_state(jp, "adam"),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           3e-4)
    pstep = steps.make_train_step(pm, pcfg, optimizer="adam")
    pp2, po2, pmet = pstep(pp, train.init_opt(pp, "adam"), batch, 3e-4)
    assert _rel(float(pmet["loss"]), float(jmet["loss"])) <= REL
    assert _rel(float(pmet["grad_norm"]), float(jmet["grad_norm"])) <= REL
    assert int(po2["t"]) == int(jo2["t"]) == 1
    for name, port, ref in (("params", pp2, jp2), ("m", po2["m"], jo2["m"]),
                            ("v", po2["v"], jo2["v"])):
        want = params_from_numpy(jax.device_get(ref), pcfg, device="cpu")
        top = max(float(w.abs().max()) for w in want.values())
        for n, t in port.items():
            assert _rel(t.numpy(), want[n].numpy(), scale=top) <= REL, \
                (name, n)
    assert any(not torch.equal(pp2[n], pp[n]) for n in pp)


def test_train_llm_smoke_losses_match_reference(qwen, capsys):
    """``train_llm_smoke("qwen2.5-3b")``: the reference's four losses
    (its init at key 0, four Adam steps of 2 x 64 tokens) against the
    port's on the same init carried over, within 1e-4."""
    want = jax_train.train_llm_smoke("qwen2.5-3b")
    got = launch_train.train_llm_smoke("qwen2.5-3b", device="cpu",
                                       params=qwen[4])
    assert len(got) == len(want) == 4
    assert _rel(got, np.asarray(want)) <= SMOKE_REL
    assert "step loss=" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["ce", "distill_topk"])
@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_every_arch_trains(arch, kind):
    """Torch only, as ``tests/test_arch_smoke.py`` holds the reference:
    one momentum step at lr 1e-2 on every assigned arch, reduced, from
    the port's own init; the loss is finite and the parameters move."""
    cfg = configs.reduced(configs.get_arch(arch))
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    batch = next(launch_train.lm_batches(cfg, 2, 16, 1))
    if kind == "distill_topk":
        rng = np.random.default_rng(0)
        batch.pop("labels")
        batch["topk_vals"] = rng.normal(size=(2, 16, 5)).astype(np.float32)
        batch["topk_idx"] = rng.integers(0, cfg.vocab_size, (2, 16, 5))
    params = dict(model.state_dict())
    step = steps.make_train_step(model, cfg, loss_kind=kind)
    new, _, met = step(params, train.init_opt(params), batch, 1e-2)
    assert bool(torch.isfinite(met["loss"])), arch
    assert max(float((new[n] - params[n]).abs().max()) for n in params) > 0


def test_launch_train_arch_smoke(capsys):
    """``launch.train --arch <id> --smoke --device cpu``: the reduced
    model's losses, printed and returned (an unknown id raises)."""
    out = launch_train.main(["--arch", "xlstm-350m", "--smoke", "--steps",
                             "2", "--device", "cpu"])
    assert out["arch"] == "xlstm-350m" and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert "[train] LLM smoke: xlstm-350m on cpu" in capsys.readouterr().out
