"""Gradient Threshold Compression (paper §2/§3.5; Strom, Interspeech 2015).

The paper's 16-GPU trainer for labeled CE + sMBR, and the default
student trainer.  Strom's algorithm, kept bit-faithful:

  r      <- r + g                      (error-feedback residual)
  send   <- tau * sign(r) * [|r| > tau]   (1-bit-quantized sparse message)
  r      <- r - send
  update <- sum_over_workers(send)

``compress_tree`` is the error-feedback selection, run per leaf through
``kernels/gtc_compress`` (the Hopper kernel on a CUDA tensor, its plain
version on a CPU tensor); ``pack_int8`` / ``unpack_int8`` are the only
pack/unpack pair; ``wire_reduce`` is the wire.  At one worker the int8
wire is a pack/unpack round-trip that is a bitwise identity on ternary
sends, so the single-process ``train.GTC`` strategy runs the exact
arithmetic of the multi-worker wire.

A tree is a dict of tensors (a state dict).  Every function here walks
it in the reference's leaf order (``utils.trees.leaf_order``).

The multi-worker forms (``make_gtc_allreduce``, ``make_gtc_train_step``,
``make_sharded_gtc_train_step``) run the W = ``cfg.n_workers`` workers
as the reference's sharded step does: per worker its grads, the optional
transform (clipping), ``compress_tree`` against its own residual and
``wire_pack``; the packed messages summed at integer width in worker
order; one ``wire_unpack``.  Where the reference takes an ``axis_name``
or a ``mesh``, these take ``group=None`` / ``mesh=None`` -- every worker
a loop on this device, the reference's one-device mesh -- or a
``runtime.cluster.WorkerMesh``: this rank's lanes (global indices
``mesh.lanes``, their rows of the residuals and batches) run as that
loop, their messages add locally, and one ``all_reduce(SUM)`` a leaf at
the wire's width sums the ranks' partial sums -- the reference's local
sum plus one ``psum`` a leaf.  On the integer wires that is exact, so a
mesh of ranks is bitwise the one-device loop; on the float wire the sum
is regrouped (within an ulp).  A rank past the mesh's axis adds zeros.
Any other group raises ``TypeError``.  ``simulate_gtc_round`` is the
reference round, compressing through the plain ``gtc_compress_ref`` on
any device, so on the card it is the plain version the kernel's
multi-worker path is held against.

``wire_unpack`` divides the summed update by W as the reference does,
on every device by a 0-dim tensor made on the operand's device: on a
CUDA tensor a division by a host scalar runs as a multiply by its
reciprocal, which is not the quotient's bits when W is not a power of
two.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.kernels.gtc_compress import gtc_compress, gtc_compress_ref
from repro_torch.runtime.cluster import check_mesh
from repro_torch.utils.trees import leaf_order

Tree = Dict[str, torch.Tensor]

MAX_INT8_WORKERS = 127       # |sum of W ternary messages| <= W must fit int8


@dataclass(frozen=True)
class GTCConfig:
    tau: float = 1e-3
    quantize_int8: bool = True       # pack the send tensor to int8 on the wire
    n_workers: int = 16
    int32_accum: bool = False        # widen the sum to int32 (required
                                     # beyond 127 workers; the narrow int8
                                     # wire is exact below that)
    use_kernel: Optional[bool] = None    # None: the Hopper kernel on a
                                         # CUDA tensor, the plain version
                                         # on a CPU tensor


# ----------------------------------------------------------- compression

def compress_leaf(g: torch.Tensor, r: torch.Tensor, tau: float, *,
                  use_kernel: Optional[bool] = None):
    """One tensor: error-feedback threshold compression.

    Returns (send, new_residual), float32; send has values in
    {-tau, 0, +tau}.  Kernel and plain version are bitwise-identical.
    """
    return gtc_compress(g, r, tau, use_kernel=use_kernel)


def compress_tree(grads: Tree, residuals: Tree, tau: float, *,
                  use_kernel: Optional[bool] = None):
    """(sends, new_residuals) over every leaf, in the reference's leaf
    order."""
    sends, ress = {}, {}
    for n in leaf_order(grads):
        sends[n], ress[n] = compress_leaf(grads[n], residuals[n], tau,
                                          use_kernel=use_kernel)
    return sends, ress


# ------------------------------------------------------------------ wire

def pack_int8(send: torch.Tensor, tau: float, *, n_workers: int = 1,
              int32_accum: bool = False) -> torch.Tensor:
    """{-tau,0,tau} -> int8 {-1,0,1}: the wire format (4x smaller than
    f32).

    ``n_workers`` is the number of ternary messages the reduction will
    sum.  At int8 width the sum is exact only while ``n_workers <= 127``;
    past that the packed wire would silently wrap, so this raises unless
    the caller opted into int32 accumulation.
    """
    if n_workers > MAX_INT8_WORKERS and not int32_accum:
        raise ValueError(
            f"pack_int8: summing {n_workers} ternary int8 messages "
            f"overflows int8 (|sum| <= {n_workers} > {MAX_INT8_WORKERS}); "
            f"set int32_accum=True to widen the accumulation")
    return torch.clamp(torch.round(send / tau), -1, 1).to(torch.int8)


def unpack_int8(packed: torch.Tensor, tau: float,
                n_workers_summed: int = 1) -> torch.Tensor:
    """Packed (possibly summed) wire integers -> the averaged float
    update: ``packed * tau / n_workers_summed``.  With
    ``n_workers_summed=1`` this is the exact inverse of ``pack_int8`` on
    a single message."""
    out = packed.float() * tau
    if n_workers_summed != 1:
        out = _divide(out, n_workers_summed)
    return out


def _divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n with the quotient's bits on every device: the divisor is a
    tensor made on x's device (a CUDA tensor divided by a host scalar is
    multiplied by its reciprocal, which differs at n = 3)."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def wire_pack(send: torch.Tensor, cfg: GTCConfig) -> torch.Tensor:
    """One worker's send tensor -> its wire message: ternary int8 (or
    int32-widened when ``cfg.int32_accum``), or the raw f32 send when the
    wire is unquantized."""
    if not cfg.quantize_int8:
        return send
    p = pack_int8(send, cfg.tau, n_workers=cfg.n_workers,
                  int32_accum=cfg.int32_accum)
    return p.to(torch.int32) if cfg.int32_accum else p


def wire_unpack(acc: torch.Tensor, cfg: GTCConfig) -> torch.Tensor:
    """Accumulated wire messages -> the averaged float update."""
    if cfg.quantize_int8:
        return unpack_int8(acc, cfg.tau, n_workers_summed=cfg.n_workers)
    return _divide(acc, cfg.n_workers) if cfg.n_workers != 1 else acc


def wire_reduce(sends: Tree, cfg: GTCConfig) -> Tree:
    """The wire for one worker: pack -> unpack-average, per leaf.  At
    ``cfg.n_workers == 1`` with the int8 format this is a bitwise
    identity on ternary sends.  Returns the update averaged over
    ``cfg.n_workers`` (the paper applies the raw sum; normalizing keeps
    the learning rate worker-count independent)."""
    return {n: wire_unpack(wire_pack(sends[n], cfg), cfg)
            for n in leaf_order(sends)}


def gtc_init(params: Tree, cfg: Optional[GTCConfig] = None) -> dict:
    """Error-feedback residuals, zeros in float32.  With a ``cfg`` they
    are per-worker: stacked on a leading W dim, even at W=1.  Without
    one, the single-process unstacked form."""
    lead = () if cfg is None else (cfg.n_workers,)
    return {"residual": {n: torch.zeros(lead + tuple(params[n].shape),
                                        dtype=torch.float32,
                                        device=params[n].device)
                         for n in leaf_order(params)}}


def density(update: Tree, tau: float) -> torch.Tensor:
    """Fraction of nonzero elements actually shipped (diagnostic), a
    float32 scalar on the update's device."""
    del tau                                  # the reference's signature
    names = leaf_order(update)
    nz = sum((update[n].abs() > 0).sum().float() for n in names)
    n = sum(update[n].numel() for n in names)
    return nz / max(n, 1)


def wire_bytes_per_update(params: Tree, cfg: GTCConfig) -> int:
    """Bytes one worker ships per update under ``cfg``'s wire format
    (the collective roofline term the int8 pack is buying down).

    Measured from what ``wire_pack`` -- the function the trainer ships
    through -- emits for each leaf, on the meta device (no compute), so
    a change to the packing moves this number."""
    total = 0
    for n in leaf_order(params):
        msg = wire_pack(torch.empty(tuple(params[n].shape),
                                    dtype=torch.float32, device="meta"), cfg)
        total += msg.numel() * msg.element_size()
    return total


# ------------------------------------------------- the W workers' exchange

def _mesh(what: str, mesh, cfg: GTCConfig):
    """``mesh`` if it is None or a ``WorkerMesh`` of ``cfg``'s workers;
    raises otherwise."""
    return None if mesh is None else check_mesh(what, mesh, cfg.n_workers)


def _add(acc: Optional[Tree], packed: Tree) -> Tree:
    """The running sum of wire messages, in worker order (integers on the
    quantized wire, so exact)."""
    return packed if acc is None else {n: acc[n] + packed[n] for n in acc}


def _row(tree: Tree, i: int) -> Tree:
    return {n: x[i] for n, x in tree.items()}


def local_sum(grads_of: Callable[[int], Tree], residuals: Tree,
              cfg: GTCConfig):
    """The workers whose rows ``residuals`` holds, in order: row j's
    grads (``grads_of(j)``, taken when its turn comes), compressed
    against its own residual and packed, the messages added (zeros of the
    wire's width when there is no row: a rank without lanes).  -> (the
    summed messages, the stacked new residuals)."""
    acc, new_res = None, []
    for j in range(next(iter(residuals.values())).shape[0]):
        send, r = compress_tree(grads_of(j), _row(residuals, j), cfg.tau,
                                use_kernel=cfg.use_kernel)
        acc = _add(acc, {n: wire_pack(send[n], cfg)
                         for n in leaf_order(send)})
        new_res.append(r)
    if acc is None:
        return ({n: wire_pack(x.new_zeros(x.shape[1:]), cfg)
                 for n, x in residuals.items()}, residuals)
    return acc, {n: torch.stack([r[n] for r in new_res])
                 for n in leaf_order(new_res[0])}


def all_reduce_tree(acc: Tree, mesh=None) -> Tree:
    """The ranks' summed messages: one ``all_reduce`` a leaf, in leaf
    order, in place (nothing without a mesh of ranks)."""
    if mesh is not None:
        for n in leaf_order(acc):
            mesh.all_reduce(acc[n])
    return acc


def _exchange(grads_of: Callable[[int], Tree], residuals: Tree,
              cfg: GTCConfig, mesh=None):
    """``local_sum``, ``all_reduce_tree`` over the mesh's ranks, one
    unpack.  -> (update, stacked residuals)."""
    acc, res = local_sum(grads_of, residuals, cfg)
    acc = all_reduce_tree(acc, mesh)
    return {n: wire_unpack(acc[n], cfg) for n in leaf_order(acc)}, res


def make_gtc_allreduce(cfg: GTCConfig, group=None):
    """The exchange of the W workers: grads and residuals carry a leading
    dim of the workers' rows (all W on this device for ``group=None``,
    this rank's lanes on a ``WorkerMesh``); each worker compresses
    against its own residual and packs, the messages add in worker
    order (then over the ranks), one unpack averages.  ->
    allreduce(grads, gtc_state) -> (update, {"residual": stacked})."""
    mesh = _mesh("make_gtc_allreduce", group, cfg)

    def allreduce(grads: Tree, gtc_state: dict):
        update, res = _exchange(lambda i: _row(grads, i),
                                gtc_state["residual"], cfg, mesh)
        return update, {"residual": res}
    return allreduce


def make_gtc_train_step(loss_fn: Callable, optimizer_update: Callable,
                        cfg: GTCConfig, group=None):
    """Data-parallel train step with the GTC exchange:
    ``make_sharded_gtc_train_step`` without a transform, on ``group``
    (None: the W workers of this device as a loop).  step(params,
    opt_state, gtc_state, batches, lr) -> (params, opt_state, gtc_state,
    metrics), batches stacked as the residuals."""
    return make_sharded_gtc_train_step(
        loss_fn, optimizer_update, cfg,
        mesh=_mesh("make_gtc_train_step", group, cfg))


def make_sharded_gtc_train_step(loss_fn: Callable,
                                optimizer_update: Callable,
                                cfg: GTCConfig, mesh=None,
                                worker_axes=("data",),
                                grad_transform: Optional[Callable] = None):
    """Multi-worker GTC: batches and error-feedback residuals carry a
    leading dim of worker rows, params and optimizer state are shared
    (synchronous SGD: every worker applies the same averaged update).
    ``mesh=None``: all W rows on this device; a ``WorkerMesh``: this
    rank's lanes' rows, and the ranks' messages summed by one
    ``all_reduce`` a leaf.

    Per worker, in the reference's order: its grads, then
    ``grad_transform(grads) -> (grads, extra_metrics)`` (clipping), then
    ``compress_tree`` against its residual (the ``gtc_compress`` kernel
    on the card, one launch a leaf), then ``wire_pack``; the messages
    add in worker order; one ``wire_unpack``; the optimizer;
    ``gtc_density`` of the applied update (the same on every rank),
    broadcast to (W,).  A loss declaring ``rng`` gets ``fold_rng(rng,
    i)`` for worker i, its global index (``rng`` an int from
    ``train.state.fold_seed``).  Returns step(params, opt_state,
    gtc_state, batches, lr, rng=None) -> (params, opt_state, gtc_state,
    metrics), each metric (W,)-shaped: on a mesh of ranks the lanes'
    metrics gathered in lane order, so every rank sees the one-device
    loop's.  ``worker_axes`` is the reference's; the mesh has one axis.
    """
    from repro_torch.train.state import fold_rng, gather_lanes
    from repro_torch.train.strategies import loss_and_grads, loss_takes_rng
    del worker_axes
    mesh = _mesh("make_sharded_gtc_train_step", mesh, cfg)
    takes_rng = loss_takes_rng(loss_fn)

    def step(params, opt_state, gtc_state, batches, lr, rng=None):
        ms = []
        lanes = (mesh.lanes if mesh is not None
                 else range(next(iter(batches.values())).shape[0]))

        def grads_of(j):
            key = fold_rng(rng, lanes[j]) if takes_rng and rng is not None \
                else None
            _, m, g = loss_and_grads(loss_fn, params, _row(batches, j), key)
            if grad_transform is not None:
                g, extra = grad_transform(g)
                m.update(extra)
            ms.append(m)
            return g

        update, res = _exchange(grads_of, gtc_state["residual"], cfg, mesh)
        params, opt_state = optimizer_update(params, update, opt_state,
                                             lr=lr)
        metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in ms])
                   for k in ms[0]} if ms else {}
        if mesh is not None:
            metrics = gather_lanes(metrics, mesh)
        metrics["gtc_density"] = density(update, cfg.tau).expand(
            cfg.n_workers)
        return params, opt_state, {"residual": res}, metrics

    return step


def adaptive_tau(g: torch.Tensor, target_density: float) -> torch.Tensor:
    """Per-tensor tau that keeps ~target_density of elements: the
    reference's ``jnp.quantile(|g|, 1 - target_density)`` (linear
    interpolation, float32 position arithmetic, NaN if any element is),
    floored at 1e-12.  By a sort, so any size works (``torch.quantile``
    refuses inputs over 2**24 elements).  The interpolation is one
    fused multiply-add, ``fma(high, high_w, low * low_w)``, as the
    reference's compiled CPU code contracts it: the exact product is
    added in float64 and rounded once to float32."""
    a = g.float().abs().reshape(-1)
    f32 = dict(dtype=torch.float32, device=a.device)
    a = torch.where(torch.isnan(a).any(), torch.tensor(float("nan"), **f32),
                    a)
    a = torch.sort(a).values
    n = torch.tensor(float(a.numel()), **f32)
    q = torch.tensor(1.0 - target_density, **f32) * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    lo = torch.clamp(low, min=0).minimum(n - 1).long()
    hi = torch.clamp(high, min=0).minimum(n - 1).long()
    out = ((a[lo] * low_w).double() + a[hi].double() * high_w.double()
           ).float()
    return torch.maximum(out, torch.tensor(1e-12, **f32))


# ------------------------------------------------- reference (single host)

def simulate_gtc_round(grads_per_worker: List[Tree],
                       residuals_per_worker: List[Tree], tau: float, *,
                       quantize_int8: bool = False,
                       int32_accum: bool = False):
    """The reference round for tests: returns (applied_update,
    new_residuals).  grads/residuals: lists per worker.  Compression is
    the plain ``gtc_compress_ref`` on any device (as the reference's
    round runs its plain version), so on the card this is the plain path
    the kernel's exchange is held against.

    ``quantize_int8`` reproduces the packed wire exactly as
    ``wire_reduce`` ships it: each worker's send packed to ternary int8,
    summed at integer width (int8 unless ``int32_accum``), unpacked and
    averaged -- integer sums are exact, so the multi-worker step must
    match this bitwise.
    """
    n = len(grads_per_worker)
    sends, new_res = [], []
    for g, r in zip(grads_per_worker, residuals_per_worker):
        s, nr = {}, {}
        for k in leaf_order(g):
            s[k], nr[k] = gtc_compress_ref(g[k], r[k], tau)
        sends.append(s)
        new_res.append(nr)
    if quantize_int8:
        packed = [{k: pack_int8(sd[k], tau, n_workers=n,
                                int32_accum=int32_accum) for k in sd}
                  for sd in sends]
        if int32_accum:
            packed = [{k: p.to(torch.int32) for k, p in pk.items()}
                      for pk in packed]
        summed = packed[0]
        for pk in packed[1:]:
            summed = _add(summed, pk)
        return ({k: unpack_int8(summed[k], tau, n_workers_summed=n)
                 for k in leaf_order(summed)}, new_res)
    summed = sends[0]
    for s in sends[1:]:
        summed = _add(summed, s)
    return {k: _divide(summed[k], n) for k in leaf_order(summed)}, new_res
