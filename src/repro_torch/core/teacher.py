"""Teacher-side target generation (paper §3.1-3.2).

The teacher (the bidirectional LSTM AM) runs inference over unlabeled
data and emits top-k logits into the LogitStore.  Generation is
embarrassingly parallel over workers — the property the paper
engineered for ("parallelize target generation").

All decode loops live in ``serve.StreamingEngine``, whose emission runs
the ``topk_logits`` kernel on the card, and all multi-worker
partitioning and ledger bookkeeping in ``pipeline.generate``;
``TeacherRunner`` is the thin *single-worker special case*: pre-formed
dict batches go through ``engine.forward_topk`` (the trainer's
batches), the raw utterance firehose through
``pipeline.generate_corpus`` over the engine's bucketed queue.
Cross-worker sharded generation is ``pipeline.generate_sharded`` with
one TeacherRunner per worker — see ``launch/train.py:stage_targets``.
"""
from __future__ import annotations

from repro_torch.configs.lstm_am_7khr import TEACHER
from repro_torch.pipeline.generate import generate_corpus


class TeacherRunner:
    def __init__(self, cfg, params, *, k: int = 20, temperature: float = 1.0,
                 policy=None, topk_impl: str = "kernel", device=None):
        from repro_torch.serve import THROUGHPUT, StreamingEngine
        self.cfg = cfg
        self.k = k
        self.temperature = temperature
        self.engine = StreamingEngine(cfg, params, k=k,
                                      temperature=temperature,
                                      policy=policy or THROUGHPUT,
                                      topk_impl=topk_impl, device=device)
        self.model = self.engine.model
        self.device = self.engine.device
        self.params = params

    def generate(self, batch):
        """One pre-formed batch -> device (vals (B,S,k) bf16, idx (B,S,k)
        int32)."""
        return self.engine.forward_topk(batch)

    # the spelling pipeline.generate duck-types on (engine-or-runner)
    forward_topk = generate

    def generate_to_store(self, store, batches, shard_offset: int = 0,
                          store_wave: int = 0):
        """Pre-formed dict batches -> one store shard each (trainer-aligned
        shard layout: shard i holds batch i's frames)."""
        paths = []
        for i, batch in enumerate(batches):
            vals, idx = self.generate(batch)
            paths.append(store.append_shard(shard_offset + i, vals, idx,
                                            wave=store_wave))
        return paths

    def generate_corpus_to_store(self, store, utterances,
                                 shard_offset: int = 0, wave: int = 0,
                                 store_wave: int = 0):
        """The firehose path — ``pipeline.generate_corpus`` with this
        runner's engine: raw (T, F) utterances -> bucketed batched
        inference -> one shard per utterance, numbered in submission
        order.  ``wave`` is the flush granularity (utterances per
        memory-bounded drain, default one policy batch); ``store_wave``
        the LogitStore generation tag.  Failure contract and streaming
        semantics are documented on ``generate_corpus``.
        """
        return generate_corpus(self.engine, store, utterances,
                               shard_offset=shard_offset, wave_size=wave,
                               store_wave=store_wave)


def make_teacher_config(student_cfg):
    """The paper's teacher: same depth/width but bidirectional."""
    if student_cfg.family != "lstm_am":
        raise NotImplementedError(
            f"{student_cfg.name}: only the AM teacher is ported yet")
    return TEACHER.replace(
        lstm_hidden=student_cfg.lstm_hidden,
        n_senones=student_cfg.n_senones,
        feat_dim=student_cfg.feat_dim,
        vocab_size=student_cfg.vocab_size)
