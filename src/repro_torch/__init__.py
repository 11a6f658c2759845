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
``StreamingEngine`` and the ``topk_logits`` emission kernel; and the
student stage (``launch/train.py``): teacher targets into the v1 logit
store, then scheduled distillation under the single-process GTC
trainer, with the ``sparse_ce`` and ``gtc_compress`` kernels.
"""
