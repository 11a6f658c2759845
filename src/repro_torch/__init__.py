"""PyTorch / CUDA port of the million-hour acoustic-model reproduction.

A package of its own beside ``repro`` (the JAX reference): the same
relative module paths and public names, plain PyTorch inside, and
hand-written Hopper (sm_90a) CUDA kernels where the reference has Pallas
kernels.  It imports torch, numpy and the standard library only — never
jax, never ``repro``.

Entry points take an explicit ``device`` and default to ``"cuda"``; on a
host without CUDA they raise unless the caller asks for ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version.

Ported so far: the acoustic-model serving path (``launch/serve.py``):
the LSTM AM, the slot-based ``StreamServer``, the batched
``StreamingEngine`` and the ``topk_logits`` emission kernel; target
generation at scale (``launch/train.py --stage targets``): the teacher
loaded from the checkpoint store (``checkpoint/store.py``), in-process
workers over the resumable work ledger (``pipeline/generate.py``)
writing the manifest-backed v2 logit store (``store/``); the student
stage (``launch/train.py --stage student``): scheduled distillation
from that store under the single-process GTC trainer, with the
``sparse_ce`` and ``gtc_compress`` kernels; and the token LM's decode
and prefill (``qwen2.5-3b``, ``h2o-danube-3-4b``) with the
``decode_attention``, ``topk_sample`` and ``swa_attention`` kernels.
"""
