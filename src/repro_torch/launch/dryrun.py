"""Dry run on the ``meta`` device: what each (architecture x input shape)
pair asks of the card, with nothing allocated.

The twin of what a meta device can say about the reference's
``launch/dryrun.py``.  For every pair the reference's ``supports()``
admits, the model is built on ``meta`` tensors (shapes only) and one
JSON per pair is written to ``experiments/dryrun_torch/`` with:

  n_params            the parameter count, the reference's
                      ``param_count(abstract_params(cfg))``
  param_bytes         at bf16 (the reference's ``PARAM_DTYPE``) and f32
  grad_bytes          one f32 gradient a parameter
  adam_bytes          Adam's f32 moments m and v and its int32 step
  train_state_bytes   what a ``Local(optimizer="adam")`` update holds
                      before the optimizer: f32 params, Adam, the
                      gradients and their clipped copy
  update_peak_bytes   the same while the functional Adam update runs
                      (``optim/sgd.py``: new params and moments beside
                      the old ones; the raw gradients are gone by then)
  flops, flops_by_op  ``torch.utils.flop_counter.FlopCounterMode`` over
                      the shape's step on meta tensors: a train step's
                      loss and its gradients (``train``), the prompt's
                      forward (``prefill``), one ``decode_step`` over a
                      cache of ``seq_len`` slots (``decode``), with the
                      full-sequence attention in one whole-sequence
                      chunk (``attn_whole_seq``, the reference's cost
                      probe): the chunked loops' FLOPs for causal
                      attention, masked blocks included, in one product
                      a layer rather than thousands of meta ops

Activations are not reckoned, and nothing here has a twin for the
reference's mesh, its sharding of parameters and batch, the collectives'
bytes parsed from its HLO or XLA's ``memory_analysis``: those describe
a compiled multi-chip program, which eager PyTorch on one card does not
have.  A pair whose step does not run on the meta device records the
error (``flops_error``) beside its counts.  xlstm's mLSTM and sLSTM run
a Python loop of S steps a layer (as the reference scans them), which
costs ~0.1 ms of host a meta op under the counter: their train and
prefill steps are counted only up to ``LOOP_LIMIT`` tokens, and past it
the record says so (``flops_skipped``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--variant swa]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCHS, SHAPES, ShapeConfig, get_arch,
                                 get_shape, supports)
from repro_torch.launch import steps as step_lib
from repro_torch.models.lstm_am import LstmAM
from repro_torch.models.transformer import Transformer
from repro_torch.models.whisper import Whisper

TOPK = 20                         # the paper's k
OUT = "experiments/dryrun_torch"
META = torch.device("meta")
LOOP_LIMIT = 2048                 # S past which looped mixers go uncounted


def meta_model(cfg):
    """The model as a shape template on the meta device."""
    make = (LstmAM if cfg.family == "lstm_am" else
            Whisper if cfg.encoder is not None else Transformer)
    return make(cfg, device=META, generator=None)


def input_batch(cfg, shape: ShapeConfig, *, topk: int = 0) -> Dict:
    """The reference's ``input_specs`` for train and prefill, as meta
    tensors: tokens and labels (or top-k targets), whisper's
    ``enc_embeds`` (B, S, D) beside at most ``max_target_len`` tokens,
    the AM's features."""
    b, s = shape.global_batch, shape.seq_len

    def ints(*sh):
        return torch.empty(sh, dtype=torch.int32, device=META)

    def floats(*sh):
        return torch.empty(sh, dtype=torch.float32, device=META)
    if cfg.family == "lstm_am":
        batch = {"feats": floats(b, s, cfg.feat_dim)}
        st = s
    elif cfg.encoder is not None:
        st = min(cfg.max_target_len, s)
        batch = {"enc_embeds": floats(b, s, cfg.d_model),
                 "tokens": ints(b, st)}
    else:
        st = s
        batch = {"tokens": ints(b, s)}
    if shape.kind == "train":
        if topk:
            batch["topk_vals"] = floats(b, st, topk)
            batch["topk_idx"] = ints(b, st, topk)
        else:
            batch["labels"] = ints(b, st)
    return batch


def _count(fn) -> Dict:
    with FlopCounterMode(display=False) as fc:
        fn()
    by_op = {str(op): int(n)
             for op, n in fc.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(fc.get_total_flops()), "flops_by_op": by_op}


def step_flops(cfg, shape: ShapeConfig, *, loss_kind: str = "distill_topk",
               model=None) -> Dict:
    """FLOPs of the shape's step on meta tensors (see the module doc)."""
    cfg = cfg.replace(attn_whole_seq=True)
    model = model if model is not None else meta_model(cfg)
    model.cfg = cfg
    if shape.kind == "train":
        kind = loss_kind
        params = {n: torch.empty_like(p, device=META).requires_grad_(True)
                  for n, p in model.state_dict().items()}
        loss_fn = step_lib.make_loss_fn(model, cfg, kind)
        batch = input_batch(cfg, shape, topk=TOPK if kind == "distill_topk"
                            else 0)

        def run():
            loss, _ = loss_fn(params, batch)
            torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
        return _count(run)
    if shape.kind == "prefill":
        step = step_lib.make_prefill_step(model, cfg)
        return _count(lambda: step(input_batch(cfg, shape)))
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             torch.bfloat16)
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                         device=META)
    return _count(lambda: model.decode_step(cache, tokens))


def reckon(cfg, model=None) -> Dict:
    """Parameter count and the f32 training state's bytes."""
    model = model if model is not None else meta_model(cfg)
    n = sum(p.numel() for p in model.state_dict().values())
    return {"n_params": n,
            "param_bytes": {"bfloat16": 2 * n, "float32": 4 * n},
            "grad_bytes": 4 * n,
            "adam_bytes": 8 * n + 4,
            "train_state_bytes": 4 * n + (8 * n + 4) + 2 * 4 * n,
            "update_peak_bytes": 2 * (4 * n + 8 * n + 4) + 4 * n}


def dryrun_one(arch: str, shape_name: str, *, loss_kind: str = "distill_topk",
               out_dir: Optional[str] = OUT, flops: bool = True,
               verbose: bool = True) -> Dict:
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    ok, why = supports(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "device": "meta"}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    model = meta_model(cfg)
    rec.update(status="ok", kind=shape.kind, seq_len=shape.seq_len,
               global_batch=shape.global_batch,
               loss_kind=loss_kind if shape.kind == "train" else shape.kind,
               **reckon(cfg, model))
    looped = {"mlstm", "slstm"} & set(cfg.mixers())
    if flops and looped and shape.kind != "decode" and \
            shape.seq_len > LOOP_LIMIT:
        rec["flops_skipped"] = (f"{'/'.join(sorted(looped))} loop over "
                                f"S={shape.seq_len} > {LOOP_LIMIT} steps")
    elif flops:
        t0 = time.perf_counter()
        try:
            rec.update(step_flops(cfg, shape, loss_kind=loss_kind,
                                  model=model))
        except (RuntimeError, NotImplementedError, ValueError) as e:
            rec["flops_error"] = repr(e)
        rec["count_s"] = round(time.perf_counter() - t0, 2)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch.replace('/', '_')}__"
                                     f"{shape_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        gb = rec["train_state_bytes"] / 1e9
        print(f"OK  {arch:20s} {shape_name:12s} params="
              f"{rec['n_params'] / 1e9:.3f}B train-state(f32)={gb:.1f}GB "
              f"flops={rec.get('flops', float('nan')):.3e}"
              + (f" ({rec['flops_error']})" if "flops_error" in rec else ""),
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default=None, choices=[None, "swa"])
    ap.add_argument("--loss", default="distill_topk",
                    choices=["ce", "distill_topk"])
    ap.add_argument("--no-flops", action="store_true",
                    help="counts and bytes only (no step on meta tensors)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if args.all:
        archs = [a for a in ARCHS if not a.startswith("lstm-am")]
        shapes = list(SHAPES)
    elif args.arch:
        archs = [args.arch]
        shapes = [args.shape] if args.shape else list(SHAPES)
    else:
        ap.error("pass --arch (and optionally --shape) or --all")
    if args.variant == "swa":
        archs = [a + "+swa" for a in archs]
    recs = []
    for arch in archs:
        for shape in shapes:
            rec = dryrun_one(arch, shape, loss_kind=args.loss,
                             out_dir=args.out, flops=not args.no_flops)
            if rec["status"] == "skipped":
                print(f"SKIP {arch:20s} {shape:12s} ({rec['reason']})",
                      flush=True)
            recs.append(rec)
    failed = [r for r in recs if "flops_error" in r]
    if failed:
        print(f"\n{len(failed)} pairs did not run on the meta device")
        sys.exit(1)
    print(f"\n{len(recs)} pairs written to {args.out}")
    return recs


if __name__ == "__main__":
    main()
