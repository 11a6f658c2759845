#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one line (or a few) before the last:
  1. device  — the card's name and power limit (nvidia-smi) and compute
               capability; fails below sm_90.
  2. build   — every CUDA source under src/repro_torch/kernels/csrc/,
               built from the checkout into build/kernels/, in parallel.
  3. kernel  — ``topk_logits`` on the card against its plain PyTorch
               version on the same card tensors, R in {128, 1024, 4096,
               8192} (128 rows are a student chunk step, 1024 a batch of
               training targets, 8192 the teacher's padded batch),
               V in {97, 3183, 32768}, k in {1, 20}, on
               continuous and tie-heavy (quantised) inputs: stage-1
               candidates and the merged output bitwise, ids exact.
               Times at each R with V=3183, k=20 (median of 20
               CUDA-event runs, and device time from the profiler),
               checked the same way, beside the bound and one
               ``torch.topk`` call.
     sparse_ce — the fused lse + gather kernel against its plain
               (full-logit) version at T in {128, 1024, 4096}, D=768,
               V in {97, 3183}, K in {1, 20}, duplicate ids in every row,
               softcap 0 (and 30 at the main path's shape): lse and z
               within 1e-5 of max(1, |plain|).  The autograd function's loss, dh
               and dw (kernel forward, chunked backward) against autograd
               through the plain version at T=1024.  Timed at the main
               path's T=1024, D=768, V=3183, K=20 beside the bound and
               the materialising composite logsumexp(h @ w) + gather.
     gtc_compress — bitwise against its plain version at every leaf
               shape of the student, with |acc| == tau, zeros, -0 and NaN
               forced in, and on an unaligned view; timed over all 16
               leaves (one update) beside the bytes bound.
  4. student — ``StreamServer`` at full width (lstm-am-7khr, 5x768,
               F=192, V=3183, k=20) with the kernel emitter: 8 slots,
               16-frame chunks, SLO tiers, 8 firehose streams + 2
               interactive ones.  One emission per frame; the two
               interactive streams re-run through the port's
               StreamServer on the host (plain versions, same weights)
               and held to the CPU tests' tolerances.  Then the same
               run again under the profiler: the device's busy share.
  5. teacher — ``StreamingEngine.run`` at full width (lstm-am-teacher,
               5x768 biLSTM), THROUGHPUT policy, 16 utterances of
               100-500 frames; one utterance re-run through the port's
               StreamingEngine on the host and held to the same; then
               traced as in 4.
  6. train   — the port's student stage (``launch/train.stage_student``)
               at full width: the teacher writes top-20 targets of 8
               batches of 16x64 frames, then 12 GTC updates of scheduled
               learning (8 distill, 4 CE); untraced, then traced.  One
               distill update is re-run on the host from the final state:
               loss and clipped gradients within 1e-4 relative, and the
               card's compression of the card's gradients bitwise against
               the plain version.

Every kernel's launch count is set to 0 just before phases 4, 5 and 6
and read just after each untraced run; a phase whose run did not launch
each kernel of its path fails.  Each kernel row's ``launches`` is the
sum over the paths, ``launches_by_path`` each path's own; ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` are at the shape named in
the row (``at``).  The line before the last is ``{"kernels": [...]}``;
the last is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before either is printed; without CUDA, or without the
repository beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_OPS_PER_S = 67e12              # H100 SXM f32 peak outside tensor cores
SEED = 0
K = 20
GAP = 1e-4                         # near-tie threshold of the id check
KERNELS = ("topk_logits", "sparse_ce", "gtc_compress")
D_MODEL = 768                      # the student's width (h of the loss)
TAU = 2e-4                         # the student stage's GTC threshold
REL = 1e-5                         # sparse_ce vs its plain version
HOST_REL = 1e-4                    # card vs host distill update


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


# --------------------------------------------------------------- helpers

def time_ms(fn, *, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``runs`` CUDA-event runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, name: str, *, runs: int = 20) -> float:
    """Device time per ``fn()`` call of the kernels whose name contains
    ``name``, read from a ``torch.profiler`` trace (host time excluded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name)
    if us == 0:
        fail(f"the profiler saw no device time for {name!r}")
    return us / runs / 1e3


def launch_counts(reset: bool = False) -> dict:
    """{kernel: launches} of every kernel wrapper; ``reset`` sets each
    count to 0 first."""
    counts = {}
    for name in KERNELS:
        mod = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
        if reset:
            mod.LAUNCHES = 0
        counts[name] = mod.LAUNCHES
    return counts


def bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    import numpy as np
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def check_emissions(vals, idx, ref_vals, ref_idx, logits, k: int,
                    what: str) -> float:
    """Hold the card's served (vals, idx) (T, k) against the host run's
    (ref_vals, ref_idx), with the host logits (T, V) for the near-ties.

    Ids: where the k-th and (k+1)-th host logits are more than GAP apart
    the id sets agree, and every rank whose value is more than GAP from
    both neighbours has the same id.  Values: within one bf16 ulp, plus
    GAP of float32 drift.  Returns the largest value error in ulps.
    """
    import numpy as np
    if vals.shape != ref_vals.shape or idx.shape != ref_idx.shape \
            or vals.shape != (logits.shape[0], k):
        fail(f"{what}: shapes {vals.shape}/{idx.shape}, want "
             f"{ref_vals.shape}")
    top = -np.sort(-logits.numpy(), axis=1)[:, :k + 1]
    clear = top[:, k - 1] - top[:, k] > GAP
    same_set = np.sort(idx, axis=1) == np.sort(ref_idx, axis=1)
    if not same_set[clear].all():
        fail(f"{what}: top-{k} id sets differ on separated frames")
    gaps = -np.diff(top, axis=1)                   # (T, k) >= 0
    sep = gaps[:, :k] > GAP
    sep[:, 1:] &= gaps[:, :k - 1] > GAP
    if not (idx == ref_idx)[sep].all():
        fail(f"{what}: ids differ at separated ranks")
    err = np.abs(vals - ref_vals)
    ulp = bf16_ulp(np.maximum(np.abs(vals), np.abs(ref_vals)))
    if not (err <= ulp + GAP).all():
        fail(f"{what}: values beyond one bf16 ulp (max err "
             f"{float(err.max())})")
    return float((err / ulp).max())


# ---------------------------------------------------------------- phases

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    print(smi, flush=True)
    log(f"device: {smi} | capability {cap[0]}.{cap[1]} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    if cap < (9, 0):
        fail(f"compute capability {cap} < 9.0: the kernels are sm_90a")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    log(f"build: {sorted(_build.sources())} in {dt:.2f} s "
        f"(compiled now: {sorted(logs) or 'none, cached'})")
    for name, text in logs.items():
        used = [ln.split(":", 1)[1].strip() for ln in text.splitlines()
                if "registers" in ln]
        log(f"  {name}: ptxas per instantiation: {' | '.join(used)}")


def check_kernel(x, k: int, what: str):
    """Stage-1 candidates and the merged output of ``topk_logits`` on the
    card tensor ``x`` against the plain versions: values bitwise, ids
    exact."""
    import torch
    from repro_torch.kernels.topk_logits import kernel, ops, ref
    vt = ref.tile_width(x.shape[-1])
    kk = min(k, vt)
    cv, ci = kernel.topk_logits_tiles(x, kk, vt)
    rv, ri = ref.topk_logits_tiles_ref(x, kk, vt)
    if not (torch.equal(cv, rv) and torch.equal(ci, ri)):
        fail(f"stage-1 candidates differ at {what}")
    mv, mi = ops.topk_logits(x, k)
    sv, si = ref.topk_logits_ref(x, k)
    if not (torch.equal(mv, sv) and torch.equal(mi, si)):
        fail(f"topk_logits differs at {what}")
    return float((mv - sv).abs().max())


def bound(rows: int, v: int):
    """(bound ms, what bounds it) of top-k over (rows, v) f32 logits."""
    bytes_ms = (rows * v * 4 + rows * K * 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * v * K / F32_OPS_PER_S * 1e3     # k compare rounds over V
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def phase_kernel() -> dict:
    import torch
    from repro_torch.kernels.topk_logits import kernel, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # R=128 is a student chunk step (8 slots x 16 frames), R=1024 a
    # training batch of targets (16 x 64 frames), R=8192 the teacher's
    # padded batch (16 x 512 frames)
    n = 0
    for r in (128, 1024, 4096, 8192):
        for v in (97, 3183, 32768):
            for kind in ("continuous", "ties"):
                x = torch.randn((r, v), generator=gen, device="cuda")
                if kind == "ties":          # 5 levels: ties everywhere
                    x = torch.round(x * 1.5).clamp(-2, 2) * 0.75
                for k in (1, K):
                    check_kernel(x, k, f"R={r} V={v} k={k} ({kind})")
                    n += 1
    torch.cuda.synchronize()
    log(f"kernel: topk_logits == plain version (stage 1 and merged, "
        f"values bitwise, ids exact) on {n} cases")

    v = 3183
    at_rows = {}
    for rows in (128, 4096, 8192):
        x = torch.randn((rows, v), generator=gen, device="cuda")
        err = check_kernel(x, K, f"R={rows} V={v} k={K} (timed input)")
        b, by = bound(rows, v)
        at_rows[rows] = {
            "ms": time_ms(lambda: ops.topk_logits(x, K)),
            "plain_ms": time_ms(lambda: ref.topk_logits_ref(x, K)),
            "library_ms": time_ms(lambda: torch.topk(x, K, dim=-1)),
            "bound_ms": b, "bound_by": by, "max_abs_err": err,
            "device_ms": device_ms(lambda: ops.topk_logits(x, K),
                                   "topk_select")}
        t = at_rows[rows]
        log(f"kernel: R={rows} V={v} k={K}: {t['ms']:.4f} ms (device only, "
            f"both launches: {t['device_ms']:.4f} ms), plain sort "
            f"{t['plain_ms']:.4f} ms, torch.topk {t['library_ms']:.4f} ms, "
            f"bound {b:.4f} ms ({by})")
    x = torch.randn((4096, v), generator=gen, device="cuda")
    stage1_ms = time_ms(lambda: kernel.topk_logits_tiles(x, K,
                                                         ref.tile_width(v)))
    log(f"kernel: R=4096 stage 1 alone {stage1_ms:.4f} ms")
    t = at_rows[4096]
    return {"name": "topk_logits", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_logits.cu",
            "replaces": "src/repro/kernels/topk_logits/kernel.py:57",
            "launches": 0,
            "max_abs_err": max(a["max_abs_err"] for a in at_rows.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "at": "R=4096 V=3183 k=20",
            "at_rows": {str(r): {key: a[key] for key in
                                 ("ms", "device_ms", "plain_ms",
                                  "library_ms", "bound_ms")}
                        for r, a in at_rows.items()}}


def rel_err(a, b) -> float:
    """max |a - b| / max(1, |b|), elementwise, as a float."""
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def check_sparse_ce(h, w, idx, softcap: float, what: str) -> float:
    """``sparse_ce`` on card tensors against its plain version: lse and
    the gathered logits within REL of max(1, |plain|).  Returns the
    worst error."""
    import torch
    from repro_torch.kernels.sparse_ce import kernel, ref
    lse, z = kernel.sparse_ce_tiles(h, w, idx, softcap)
    rl, rz = ref.sparse_ce_lse_gather_ref(h, w, idx, softcap=softcap)
    torch.cuda.synchronize()
    if lse.shape != rl.shape or z.shape != rz.shape:
        fail(f"sparse_ce shapes {tuple(lse.shape)}/{tuple(z.shape)} at "
             f"{what}")
    err = max(rel_err(lse, rl), rel_err(z, rz))
    if not err <= REL:
        fail(f"sparse_ce differs from its plain version at {what}: "
             f"error {err:.3e} > {REL} of max(1, |plain|)")
    return err


def sparse_ce_bound(t: int, d: int, v: int, k: int):
    """(bound ms, what bounds it): 2*T*D*V flops at the f32 rate, against
    h, w, ids read once and lse, z written once."""
    ops_ms = 2 * t * d * v / F32_OPS_PER_S * 1e3
    bytes_ms = 4 * (t * d + d * v + 2 * t * k + t) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def phase_sparse_ce() -> dict:
    import torch
    from repro_torch.kernels.sparse_ce import kernel, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def inputs(t, v, k):
        h = torch.randn((t, D_MODEL), generator=gen, device="cuda")
        w = torch.randn((D_MODEL, v), generator=gen, device="cuda") \
            / math.sqrt(D_MODEL)
        idx = torch.randint(0, v, (t, k), generator=gen, device="cuda",
                            dtype=torch.int32)
        if k > 1:
            idx[:, 1] = idx[:, 0]              # a duplicate id in every row
        return h, w, idx

    worst, n = 0.0, 0
    for t in (128, 1024, 4096):
        for v in (97, 3183):
            for k in (1, K):
                h, w, idx = inputs(t, v, k)
                caps = (0.0, 30.0) if (t, v, k) == (1024, 3183, K) else (0.0,)
                for cap in caps:
                    worst = max(worst, check_sparse_ce(
                        h, w, idx, cap, f"T={t} V={v} K={k} softcap={cap}"))
                    n += 1
    log(f"kernel: sparse_ce == plain version within {REL} of max(1, "
        f"|plain|) on {n} cases (worst {worst:.3e})")

    # the autograd function (kernel forward, chunked backward) against
    # autograd through the plain version, at the main path's T
    t, v = 1024, 3183
    h, w, idx = inputs(t, v, K)
    vals = torch.randn((t, K), generator=gen, device="cuda")
    grads = []
    for fn in (lambda a, b: ops.topk_distill_ce(a, b, vals, idx,
                                                use_kernel=True),
               lambda a, b: ref.topk_distill_ce_ref(a, b, vals, idx)):
        a = h.clone().requires_grad_(True)
        b = w.clone().requires_grad_(True)
        loss = fn(a, b)
        grads.append((loss.detach(), *torch.autograd.grad(loss, (a, b))))
    (lk, dhk, dwk), (lr, dhr, dwr) = grads
    gerr = {"loss": float((lk - lr).abs() / lr.abs()),
            "dh": float((dhk - dhr).abs().max() / dhr.abs().max()),
            "dw": float((dwk - dwr).abs().max() / dwr.abs().max())}
    if not max(gerr.values()) <= REL:
        fail(f"sparse_ce autograd differs from autograd through the plain "
             f"version at T={t}: {gerr}")
    log(f"kernel: sparse_ce loss/dh/dw == autograd through the plain "
        f"version at T={t} V={v} K={K} (relative to the largest: "
        + ", ".join(f"{k_} {e:.2e}" for k_, e in gerr.items()) + ")")

    lse_ref, z_ref = ref.sparse_ce_lse_gather_ref(h, w, idx)
    ids64 = idx.long()

    def composite():
        x = h @ w
        return torch.logsumexp(x, dim=-1), torch.gather(x, -1, ids64)

    b, by = sparse_ce_bound(t, D_MODEL, v, K)
    row = {"name": "sparse_ce", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/sparse_ce.cu",
           "replaces": "src/repro/kernels/sparse_ce/kernel.py:79",
           "launches": 0, "max_abs_err": 0.0,
           "ms": time_ms(lambda: kernel.sparse_ce_tiles(h, w, idx)),
           "device_ms": device_ms(lambda: kernel.sparse_ce_tiles(h, w, idx),
                                  "sparse_ce"),
           "plain_ms": time_ms(lambda: ref.sparse_ce_lse_gather_ref(
               h, w, idx)),
           "composite_ms": time_ms(composite),
           "bound_ms": b, "bound_by": by, "library_ms": None,
           "at": f"T={t} D={D_MODEL} V={v} K={K}"}
    lse, z = kernel.sparse_ce_tiles(h, w, idx)
    row["max_abs_err"] = max(float((lse - lse_ref).abs().max()),
                             float((z - z_ref).abs().max()))
    log(f"kernel: sparse_ce at {row['at']}: {row['ms']:.4f} ms (device "
        f"only, both launches: {row['device_ms']:.4f} ms), plain "
        f"{row['plain_ms']:.4f} ms, materialising composite "
        f"logsumexp(h @ w) + gather {row['composite_ms']:.4f} ms, bound "
        f"{b:.4f} ms ({by})")
    return row


def student_leaf_shapes() -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models.lstm_am import LstmAM
    from repro_torch.utils.trees import leaf_order
    sd = LstmAM(get_arch("lstm-am-7khr"), device="meta",
                generator=None).state_dict()
    return {n: tuple(sd[n].shape) for n in leaf_order(sd)}


def same_bits(a, b) -> bool:
    """Bitwise equality of two float32 tensors (NaNs and -0 included)."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_gtc(g, r, what: str):
    import torch
    from repro_torch.kernels.gtc_compress import kernel, ref
    s, nr = kernel.gtc_compress_flat(g, r, TAU)
    rs, rnr = ref.gtc_compress_ref(g, r, TAU)
    torch.cuda.synchronize()
    if not (same_bits(s, rs) and same_bits(nr, rnr)):
        fail(f"gtc_compress differs from its plain version at {what}")
    return s


def phase_gtc_compress() -> dict:
    import torch
    from repro_torch.kernels.gtc_compress import kernel, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    shapes = student_leaf_shapes()
    gs, rs = {}, {}
    sent = total = 0
    for name, shape in shapes.items():
        g = torch.randn(shape, generator=gen, device="cuda") * TAU
        r = torch.randn(shape, generator=gen, device="cuda") * TAU
        flat_g, flat_r = g.view(-1), r.view(-1)
        flat_g[:6] = torch.tensor([TAU, -TAU, 0.0, -0.0, float("nan"),
                                   1.0], device="cuda")
        flat_r[:6] = torch.tensor([0.0, 0.0, 0.0, -0.0, 0.0,
                                   float("nan")], device="cuda")
        flat_g[6], flat_r[6] = TAU / 2, TAU / 2   # acc == tau exactly
        s = check_gtc(g, r, f"{name} {shape}")
        if not (s.view(-1)[:7] == 0).all():
            fail(f"gtc_compress sent at |acc| == tau, 0 or NaN ({name})")
        sent += int((s != 0).sum())
        total += s.numel()
        gs[name], rs[name] = g, r
    off = torch.randn(1 + 8193, generator=gen, device="cuda") * TAU
    check_gtc(off[1:], off[:-1].clone(), "an unaligned view of 8193 values")
    log(f"kernel: gtc_compress == plain version bitwise on the student's "
        f"{len(shapes)} leaves ({total} values, density {sent / total:.4f}, "
        f"|acc| == tau, 0, -0 and NaN forced) and an unaligned view")

    def all_leaves(fn):
        return lambda: [fn(gs[n], rs[n], TAU) for n in shapes]

    b = 16 * total / HBM_BYTES_PER_S * 1e3
    row = {"name": "gtc_compress", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/gtc_compress.cu",
           "replaces": "src/repro/kernels/gtc_compress/kernel.py:39",
           "launches": 0, "max_abs_err": 0.0,
           "ms": time_ms(all_leaves(kernel.gtc_compress_flat)),
           "device_ms": device_ms(all_leaves(kernel.gtc_compress_flat),
                                  "gtc_compress"),
           "plain_ms": time_ms(all_leaves(ref.gtc_compress_ref)),
           "bound_ms": b, "bound_by": "bytes", "library_ms": None,
           "at": f"the student's {len(shapes)} leaves, {total} values "
                 f"(one update)"}
    log(f"kernel: gtc_compress over {row['at']}: {row['ms']:.4f} ms "
        f"(device only: {row['device_ms']:.4f} ms), plain "
        f"{row['plain_ms']:.4f} ms, bound {b:.4f} ms (bytes)")
    return row


def phase_train() -> dict:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.gtc import compress_tree
    from repro_torch.kernels.gtc_compress import ref as gtc_ref
    from repro_torch.launch import steps
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.train.strategies import clipped_grads
    out = ROOT / "build" / "chip_smoke_train"

    def run(log_fn=log):
        return launch_train.stage_student(full=True, device="cuda",
                                          seed=SEED, out=str(out),
                                          log=log_fn)

    launch_train.stage_student(full=False, device="cuda", seed=SEED,  # warm-up
                               steps=2, out=str(out / "warm"),
                               log=lambda _m: None)
    launch_counts(reset=True)
    res = run()
    counts = launch_counts()
    r = res.results
    missing = [k for k in KERNELS if counts[k] == 0]
    if missing:
        fail(f"train: the student stage launched no {missing} kernel")
    if r["updates"] != 12 or not all(math.isfinite(x) for x in
                                     (r["loss_first"], r["loss_last"])):
        fail(f"train: {r['updates']} updates, losses {r['loss_first']} / "
             f"{r['loss_last']}")
    if not all(0.0 < d <= 1.0 for d in r["gtc_density"]):
        fail(f"train: gtc_density out of (0, 1]: {r['gtc_density']}")
    if not all(torch.isfinite(p).all() for p in res.state.params.values()):
        fail("train: non-finite parameters after the stage")
    log(f"train: {r['updates']} updates ({r['updates_by_loss']}) of 16x64 "
        f"frames in {r['train_s']:.3f} s = {r['frames_per_s']:.1f} frames/s "
        f"of training; targets {r['targets_s']:.3f} s; loss "
        f"{r['loss_first']:.4f} -> {r['loss_last']:.4f}; launches {counts}")

    # one distill update from the final state, on the card and the host
    vals, idx = res.store.read_shard(0)
    batch = {**res.unlabeled[0], "topk_vals": vals, "topk_idx": idx}
    params = res.state.params
    card, card_g = clipped_grads(res.loss_fns["distill_topk"], params,
                                 batch)
    cfg = get_arch("lstm-am-7khr")
    host_params = _host(params)
    host_model = build_model(cfg, device="cpu", params=host_params)
    host, host_g = clipped_grads(
        steps.make_loss_fn(host_model, cfg, "distill_topk"), host_params,
        batch)
    errs = {"loss": float((card["loss"].cpu() - host["loss"]).abs()
                          / host["loss"].abs())}
    for n in host_g:
        errs[n] = float((card_g[n].cpu() - host_g[n]).abs().max()
                        / host_g[n].abs().max())
    if not max(errs.values()) <= HOST_REL:
        fail(f"train: card vs host distill update beyond {HOST_REL}: "
             + str({k: v for k, v in errs.items() if v > HOST_REL}))
    residual = res.state.strategy_state["residual"]
    send, new_r = compress_tree(card_g, residual, launch_train.GTC_TAU)
    for n in card_g:
        rs, rr = gtc_ref.gtc_compress_ref(card_g[n], residual[n],
                                          launch_train.GTC_TAU)
        if not (same_bits(send[n], rs) and same_bits(new_r[n], rr)):
            fail(f"train: the card's compression of {n} differs from the "
                 "plain version")
    log(f"train: one distill update re-run on the host: loss and clipped "
        f"gradients within {HOST_REL} (worst {max(errs.values()):.2e}, "
        f"loss {errs['loss']:.2e}); the card's compression of the card's "
        f"gradients == plain version bitwise on all {len(card_g)} leaves")
    log("train: the same stage again, traced:")
    traced("train", lambda: run(lambda _m: None))
    return counts


def _host(params):
    return {n: p.cpu() for n, p in params.items()}


def _host_logits(cfg, params, feats):
    """Full-utterance logits of the plain path on the host."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu", params=_host(params))
    with torch.no_grad():
        h, _ = model.apply(torch.from_numpy(feats)[None])
        return model.unembed(h)[0]


def phase_student() -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve import SLO_DEFAULT, StreamServer
    cfg = get_arch("lstm-am-7khr")
    params = build_model(cfg, device="cuda", generator=torch.Generator()
                         .manual_seed(SEED)).state_dict()
    rng = np.random.default_rng(SEED)
    fire = [rng.normal(size=(int(rng.integers(300, 601)), cfg.feat_dim))
            .astype(np.float32) for _ in range(8)]
    inter = [rng.normal(size=(int(rng.integers(40, 80)), cfg.feat_dim))
             .astype(np.float32) for _ in range(2)]

    def server():
        return StreamServer(cfg, params, n_slots=8, chunk_frames=16, k=K,
                            tiers=SLO_DEFAULT, topk_impl="kernel",
                            device="cuda")

    def drive(srv):
        rids = [srv.submit(u, tier="firehose") for u in fire]
        done = srv.pump()
        rids += [srv.submit(u, tier="interactive") for u in inter]
        done.update(srv.drain())
        torch.cuda.synchronize()
        return rids, done

    warm = server()                           # cuBLAS/allocator warm-up
    warm.submit(inter[0], tier="interactive")
    warm.drain()
    torch.cuda.synchronize()

    srv = server()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    rids, done = drive(srv)
    dt = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["topk_logits"]
    if launches == 0:
        fail("student: the stream path launched no topk_logits kernel")
    frames = sum(u.shape[0] for u in fire + inter)
    for rid, u in zip(rids, fire + inter):
        v, i = done[rid].emissions()
        if v.shape != (u.shape[0], K) or not np.isfinite(v).all():
            fail(f"student: stream {rid} emitted {v.shape}, want "
                 f"({u.shape[0]}, {K}) finite")
    st = srv.stats
    log(f"student: {len(rids)} streams, {frames} frames in {dt:.3f} s = "
        f"{frames / dt:.1f} frames/s; {st['syncs']} syncs over "
        f"{st['steps']} steps, {st['parked']} parks, utilization "
        f"{srv.utilization():.3f}; topk_logits launches {launches} "
        f"({launches / st['steps']:.2f} per chunk step)")
    host = StreamServer(cfg, _host(params), n_slots=2, chunk_frames=16,
                        k=K, topk_impl="kernel", device="cpu")
    host_rids = [host.submit(u) for u in inter]
    host_done = host.drain()
    worst = 0.0
    for rid, hrid, u in zip(rids[-2:], host_rids, inter):
        worst = max(worst, check_emissions(
            *done[rid].emissions(), *host_done[hrid].emissions(),
            _host_logits(cfg, params, u), K, f"student stream {rid}"))
    log(f"student: 2 interactive streams == the port's StreamServer on the "
        f"host (ids exact away from near-ties; worst value error "
        f"{worst:.3f} bf16 ulp)")
    log("student: the same run again, traced:")
    traced("student", lambda: drive(server()))
    return counts


def traced(path: str, fn):
    """Run ``fn`` under the profiler and log the device's busy share."""
    from repro_torch.launch.serve import profile_device
    p = profile_device(fn)
    log(f"{path}: traced wall {p['wall_ms']:.1f} ms, device busy "
        f"{p['busy_ms']:.1f} ms = {p['busy_ms'] / p['wall_ms']:.1%} "
        f"(idle {1 - p['busy_ms'] / p['wall_ms']:.1%}), {p['ops']} device "
        f"ops")


def phase_teacher() -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve import THROUGHPUT, StreamingEngine
    cfg = get_arch("lstm-am-teacher")
    params = build_model(cfg, device="cuda", generator=torch.Generator()
                         .manual_seed(SEED + 1)).state_dict()
    rng = np.random.default_rng(SEED + 1)
    utts = [rng.normal(size=(int(rng.integers(100, 501)), cfg.feat_dim))
            .astype(np.float32) for _ in range(16)]
    eng = StreamingEngine(cfg, params, k=K, policy=THROUGHPUT,
                          topk_impl="kernel", device="cuda")
    eng.submit(utts[0][:64])                  # warm-up
    eng.run()
    torch.cuda.synchronize()

    def drive():
        rids = [eng.submit(u) for u in utts]
        res = eng.run()
        torch.cuda.synchronize()
        return rids, res

    launch_counts(reset=True)
    t0 = time.perf_counter()
    rids, res = drive()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["topk_logits"]
    if launches == 0:
        fail("teacher: the batch path launched no topk_logits kernel")
    frames = sum(u.shape[0] for u in utts)
    for rid, u in zip(rids, utts):
        if res[rid].vals.shape != (u.shape[0], K) \
                or not np.isfinite(res[rid].vals).all():
            fail(f"teacher: utterance {rid} emitted {res[rid].vals.shape}")
    log(f"teacher: 16 utterances, {frames} frames in {dt:.3f} s = "
        f"{frames / dt:.1f} frames/s; topk_logits launches {launches}")
    j = int(np.argmin([u.shape[0] for u in utts]))
    host = StreamingEngine(cfg, _host(params), k=K, policy=THROUGHPUT,
                           topk_impl="kernel", device="cpu")
    hrid = host.submit(utts[j])
    href = host.run()[hrid]
    worst = check_emissions(res[rids[j]].vals, res[rids[j]].idx, href.vals,
                            href.idx, _host_logits(cfg, params, utts[j]), K,
                            "teacher utterance")
    log(f"teacher: utterance of {utts[j].shape[0]} frames == the port's "
        f"StreamingEngine on the host (worst value error {worst:.3f} bf16 "
        f"ulp)")
    log("teacher: the same run again, traced:")
    traced("teacher", drive)
    return counts


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        fail(f"the port (src/repro_torch) is not beside {__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    rows = [phase_kernel(), phase_sparse_ce(), phase_gtc_compress()]
    by_path = {"student": phase_student(), "teacher": phase_teacher(),
               "train": phase_train()}
    for row in rows:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
