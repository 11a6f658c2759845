#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one line (or a few) before the last:
  1. device  — the card's name and power limit (nvidia-smi) and compute
               capability; fails below sm_90.
  2. build   — every CUDA source under src/repro_torch/kernels/csrc/,
               built from the checkout into build/kernels/, in parallel.
  3. kernel  — ``topk_logits`` on the card against its plain PyTorch
               version on the same card tensors, R in {1, 128, 1024,
               4096, 8192} (1 row is one emission, 128 a student chunk
               step, 1024 a batch of training targets, 8192 the
               teacher's padded batch), V in {97, 2053, 3183, 32768}
               (2053: a second tile of 5 real columns, so stage 1
               repeats a NEG column; 32768: stage 1 and a merge launch,
               the rest one launch), k in {1, 20}, and the pipeline's
               chunked batch R=256 at V in {49, 97} (its tiny and small
               widths; 49: one ragged tile), k=10, whisper's emission
               R=8 at V=51865 (26 tiles: stage 1 and a merge launch), k
               in {1, 20}, on continuous and
               tie-heavy (quantised) inputs: stage-1 candidates and the
               merged output bitwise, ids exact; and [-0, +0, -0, +0, -1]
               at k=4: ids [0, 1, 2, 3], each value its element's own
               zero (sign bits checked).  Times at each R with
               V=3183, k=20, and at R=8 with V=51865 (median of 20
               CUDA-event runs, and device
               time from the profiler), checked the same way, beside the
               bound and one ``torch.topk`` call (event and device).
     sparse_ce — the fused lse + gather kernel (3xTF32 wgmma, two
               launches a call) against its plain (full-logit) version at
               T in {128, 1024, 4096} with D=768 and T=33 with D in
               {100, 32}, V in {97, 3183}, K in {1, 20}, the pipeline's
               T=256 at (D, V, K) = (64, 49, 10) and (128, 97, 10) (V=49
               below one 128-column tile; D=64 two 32-deep chunks) (and
               T=33, D=37,
               K=40, w aligned and at a 4-byte offset), duplicate ids in
               every row, softcap 0 (and 30 at the main path's shape): lse
               and z within 1e-5 of max(1, |plain|).  With h x 30 at the
               main shape (large logits): lse within 1e-5 of max(1,
               |plain|), and lse and z no further from float64 than the
               plain float32 version (whose own rounding of partial sums
               ~30 exceeds 1e-5 of max(1, |x|) there), both printed.  The autograd
               function's loss, dh and dw (kernel forward, chunked
               backward) against autograd through the plain version at
               T=1024.  Timed at the main path's T=1024, D=768, V=3183,
               K=20 (both launches and the tile kernel alone, device
               time; host us a call) beside the bound (at the 3xTF32
               tensor-core rate, the CUDA-core figure beside it) and the
               materialising composite logsumexp(h @ w) + gather.
     gtc_compress — bitwise against its plain version at every leaf
               shape of the student and of the tiny pipeline's 2x64
               student, with |acc| == tau, zeros, -0 and NaN
               forced in, and on an unaligned view; timed over all 16
               leaves (one update) beside the bytes bound.
     decode_attention — against its plain version on clones of the same
               card tensors: window {0, 8} x softcap {0, 30} x rope on/off
               x write on/off x hd {64, 120, 128} x G {1, 8} x S {64
               (one block per (b, h)), 300 (five)} at ragged positions (a
               ring wrap under the window), f32 caches once; the split's
               edges at the main path's widths (S=1000, pos 0, 1, on
               chunk and tile edges, S-1 and past S; linear and a window
               of 200), a ring wrapped many times with windows of 200 and
               256 over S=256 (longer than a tile and a chunk), G=16 with
               hd=256 in bf16 and f32, hd=6 (element-wise tile loads),
               B*Hkv=320 (no split), and the main path's shape (B=16,
               Hkv=2, G=8, hd=128, S in {512, 1024}, bf16): written caches
               bitwise, o within 1e-5 of max(1, |plain|); a row at pos -1
               (S=16, one block; S=1000, eight) writes nothing and returns
               the mean of its S value rows, as the plain version does.
               Timed at S=512 and 1024 beside the bytes bound and SDPA over
               the written cache (event and device).
     topk_sample — V in {20 (k_cap = V), 97 (one short tile), 512,
               32000, 151936, 262144 (gemma3's vocab: 128 runs, every
               run in registers), 262145 (129 runs: one in shared
               memory)} x B in {1, 16, 128}, and at B in {1, 16} V=524288
               (C = 8192, the kernel's limit) and V=4194304 at k_cap=4
               (2048 runs, 60 a lane in shared memory), greedy and sampled,
               continuous, tie-heavy and all-±0-but-a-few logits, greedy
               sentinel rows mixed in, fed the same noise as its plain
               version: vals bitwise (sign bits included) and idx exact,
               tokens equal except where an excl lies within EXCL_WINDOW
               of its top_p (counted).  Timed at B=16, V=151936 (stage 1,
               stage 2, both; stage 2's host us a call) beside the bytes
               bounds (both stages; stage 2's candidates alone), the
               launch floor (a one-element fill's device time),
               torch.topk over the logits and, as stage 2's merge-only
               yardstick, over its (16, 2400) candidates.  V=524289
               (C = 8224) must raise ValueError.
     swa_attention — against its plain version (ref.py, per batch row
               and kv head, every output row) on the same card tensors:
               window {64, 100, 4096, >= S} x softcap {0, 30} x hd {64,
               80, 120, 128} x G {1, 4, 8} x S {64, 300, 1024, 8192}
               (B=2, Hkv=2), then hd {100, 256} x G {1, 4} x S {64, 300}
               x window {64, S+1} x softcap {0, 30}, bf16 inputs once,
               and the prefill path's shapes (B=2, Hq=32, Hkv=8, hd=120;
               S=8192 with window 4096, S=2048 causal): o within ATTN_REL
               of max(1, |plain|).  The locality property, bitwise: keys
               before the band of the last query tile set to NaN change
               no output of that tile.  Timed (both launches, and the
               prepass alone) at the path's two shapes beside the
               operations bound at the 3xTF32 tensor-core rate (the
               CUDA-core figure beside it) and single SDPA calls: the band
               mask with GQA (enable_gqa, which in f32 only the math
               backend takes), the efficient backend over kv repeated
               G-fold with the band mask, and at S=2048 the same with
               is_causal=True (the upper triangle skipped); library_ms is
               the fastest.
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
  6. targets — ``launch/train.stage_targets`` at full width
               (lstm-am-teacher, 5x768 biLSTM, from its checkpoint):
               12 batches of 16x512 frames (row lengths 128-512, zero
               mask past each) over 3 in-process ledgered workers into
               the v2 store.  First through engines that raise at their
               6th forward: range (0, 4) done in the ledger, at most 5
               shards, all verifying.  Then the resume: exactly the 8
               unfinished batches forwarded (topk_logits launches), 12
               verified wave-0 shards, each shard's lens its mask's row
               sums, storage_compression_x 106.1.  One batch's shortest
               row re-run through the port's StreamingEngine on the host
               (``check_emissions``).  The firehose: 48 utterances of
               100-500 frames through ``generate_corpus_to_store`` in
               waves of 16, one shard each in submission order (3
               launches).  Frames/s of both, seconds in forwards against
               shard writes and checksums (and the 12 shards rewritten
               from host arrays, the store's own time); 2 batches
               again, traced.
  7. train   — the port's student stage (``launch/train.stage_student``)
               at full width: the teacher writes top-20 targets of 8
               batches of 16x64 frames into the v2 store (one worker),
               then 12 GTC updates of scheduled learning (8 distill, 4
               CE) reading it with the wave pinned; untraced, then
               traced.  One
               distill update is re-run on the host from the final state:
               loss and clipped gradients within 1e-4 relative, and the
               card's compression of the card's gradients bitwise against
               the plain version.
     prefetch — the same GTC student stage at prefetch=2: the final
               state (params, momentum, residual) held to the train
               phase's two uninterrupted prefetch=0 runs (untraced and
               traced) by the determinism rule below; frames/s of
               training beside the train phase's untraced run; traced
               once more at prefetch=2: the batches' host-to-device
               copies (4 arrays a distill batch, 3 a CE batch) all from
               pinned memory on a stream other than the kernels', the
               stage's pageable copies left counted
               beside the prefetch=0 trace's.
     bmuf    — ``stage_student(trainer="bmuf")`` at full width: BMUFVmap
               with W = 4 lanes and tau = 2, 16x64 microbatches, 16
               unlabeled batches a sub-epoch and 8 labeled a pass: 6
               updates (4 distill, 2 CE) of 8 microbatches; topk_logits
               exactly 32 launches (the 32 batches' targets), sparse_ce
               64 (2 a call, 32 distill lane-steps), gtc_compress none;
               finite losses and parameters; frames/s of training and
               block sync's share of an update (CUDA events).  The stage
               again, the second uninterrupted run.  One distill block
               from the final state on the stage's first 8 microbatches,
               on the card (traced: the update's own idle share) and on
               the host (plain versions): theta_g, delta and every lane
               within HOST_REL.
     resume  — the GTC and the BMUF students with ckpt_every=1, killed by
               their source after update 3 and re-invoked: resumed at
               update 3 on the completed targets pass it trained on (no
               topk_logits launch), the rest of the schedule run, the
               kernels launched, the checkpoints cleared at the stage's
               end, and the final state held to two uninterrupted runs
               (the train and bmuf phases') by the determinism rule: if
               those two are bitwise equal the resumed run must be too,
               else it must lie within their run-to-run difference.
     baseline — ``stage_baseline`` at full width: CE under Local on the
               reference's synthetic corpus (64 mels x 3 = 192 features,
               3,183 senones, 32 utterances, batch 16, chunk_len 64: two
               chunked epochs and the full-sequence fine-tune); every
               batch one update, finite losses; one CE update re-run on
               the host from the final state: loss and clipped gradients
               within HOST_REL; the training time split into the updates
               alone (a chunked and a full-sequence update timed on the
               card) and the rest, beside the feed thread's seconds in
               the corpus source.  No kernel is on this path.
     teacher_train — ``stage_teacher`` at full width (5x768 biLSTM,
               3,183 senones): the CE fit (10 updates on the baseline's
               32 utterances), then one epoch of sMBR fine-tune (4
               full-sequence batches of 8 rows); real frames/s of each
               part, the sMBR eacc and log Z, val FER; the peak device
               memory of one sMBR update; one sMBR update's loss and
               gradients on the card against the host's plain path from
               the same weights on a cut of the batch (2 rows x 48
               frames) within HOST_REL; the scaled forward-backward
               against its literal (B, S, S) twin on the card at B=2,
               T=32, S=3,183 from the teacher's scores: gamma within
               FB_TOL, log Z within FB_TOL of max(1, |log Z|).  No kernel
               is on this path.
     smbr    — ``stage_smbr`` at full width from the train phase's
               student and the baseline phase's baseline: GTCShardMap at
               W = 2 on the int8 wire, 2 epochs of 4 padded batches of 8
               rows = 4 updates, gtc_compress exactly 128 launches (16
               leaves x 2 workers an update); frames/s, eacc first and
               last, gtc_density, val FER against the baseline's; one
               update's applied update and both workers' residuals, from
               the stage's final state on the card's gradients of its
               first two batches, bitwise against ``simulate_gtc_round``
               (the plain gtc_compress) on the same gradients, at the
               stage's tau and at an adaptive_tau where the wire sends;
               two sMBR updates of GTCShardMap at that adaptive tau from
               the stage's params (nonzero gtc_density, the params and
               the momentum moved), three runs held to the determinism
               rule, with the values sent; the wall
               time of one update split into the workers' gradients and
               the wire; the peak device memory of one worker's sMBR
               gradients; the stage again, and the stage killed after
               update 2 and re-invoked, held to the two by the
               determinism rule.
     pipeline — ``SSLPipeline(PipelineConfig.tiny(),
               student_trainer="gtc").run("all")`` on the card (2x64
               LSTM, 49 senones, k=10, 48 / 192 / 16 utterances), then
               the BMUF student and its sMBR on the same baseline,
               teacher and targets; each stage's seconds and real
               frames/s, the val FERs and rel_fer_reduction_pct beside
               the reference's tiny figures, the launches of each kernel
               by stage.  Holds: every stage completes with finite
               results; the store verifies with 40 shards and 10,240
               frames (the reference's; the corpus is bitwise); each
               stage launches exactly what its data asks for (one
               topk_logits a batch of targets, two sparse_ce a distill
               microbatch, gtc_compress on every leaf of every update
               and worker) and nothing else; the card's targets against
               the host's TeacherRunner from the same checkpoint (ids
               away from near-ties, values within one bf16 ulp); the GTC
               student stage on the host from the same baseline and
               store: per-update losses within PIPE_HOST_REL.
     gen_procs — ``generate_sharded(processes=3)`` at full width: the
               5x768 biLSTM teacher (lstm-am-teacher, F=192, V=3,183,
               k=20) drawn from the seed and saved with the port's
               CheckpointStore, each worker process building
               ``runtime.workers:teacher_engine`` from it; the targets
               phase's 12 ragged batches of 16x512, worker 1 SIGKILLed
               after its 2nd shard; against the same batches from the
               same teacher in-process (the targets phase's store, kept
               for this).  Holds: every shard verified, the ledger
               done, a restart, worker 1 killed once; the stores
               bitwise equal (else ids away from near-ties and values
               within one bf16 ulp against the teacher's logits on the
               card); every worker report without an error or a jax /
               reference import, every worker that wrote shards on this
               card, the reports' topk_logits launches at least the 12
               batches, and the parent launching nothing.  Real frames/s
               of both passes.
     elastic — the BMUF student at full width (5x768, sparse_ce at
               T=1,024, D=768, V=3,183, K=20 on targets the teacher
               writes for 16 batches of 16x64): W = 4, tau = 2, 6
               updates under ``LaneCrashPlan(kills={1: "lane3"},
               revives={3: "lane3"})`` -- 2 resizes, final W 4, 88
               sparse_ce launches; a W = 4 checkpoint at update 2, then
               the run killed to W = 3 against a fresh W = 3 trainer
               resuming it, params and lanes bitwise at update 4;
               GTCShardMap (mesh=None) resized W = 2 -> 1 -> 2 over 4
               distill updates at an adaptive tau (1% of the first
               gradient): the sends plus the final residuals equal the
               sum of the gradients within half a float32 ulp of the
               run's magnitudes per rounding on a value's path, and 16
               gtc_compress launches a worker-update.
     waves   — ``SSLPipeline.run_waves(2, kill_at=1, revive_after=2)``
               at ``PipelineConfig.tiny()`` (BMUF W = 4, tau = 2,
               gen_procs = 2) from the pipeline phase's baseline and
               teacher, copied into a fresh out dir: 2 waves [0, 1], 4
               resizes, 2 lane deaths absorbed, final W 4 in each wave,
               manifest and ledger clean; topk_logits launched in the
               workers only (their reports), sparse_ce in the parent.  A
               wiring check, as the pipeline phase.
     cluster — the paper's two trainers across OS processes: ranks of
               ``python -m repro_torch.launch.train --cluster
               127.0.0.1:<free port>,N,i`` started together, each with a
               hard limit (one rank's failure kills the others and fails
               the phase), each writing its report (its card, kernel
               launches, start-up, an update's split) and rank 0 the
               gathered final state.  (a) ``--full --stage smbr
               --gtc-workers 2`` in 2 gloo ranks, one lane each, from
               the smbr phase's student and baseline: final params,
               momentum and residuals held to that phase's two
               in-process runs by the determinism rule (bitwise when
               they are), gtc_compress 128 over the ranks; an update's
               wall split into the lane's gradients, local pack, the
               all-reduce through the host and the unpack (CUDA events
               and host clock); real frames/s; each rank's start-up.
               (c) the same as one NCCL rank at world 1 holding both
               lanes: bitwise equal to (a).  (b) ``--full --stage
               student --trainer bmuf`` in 2 gloo ranks (W = 4, 2 lanes a
               rank, tau = 2) on the bmuf phase's targets: theta_g,
               delta, lanes and momentum within BMUF_BLOCK_REL a block of
               its BMUFVmap run (delta against theta_g's size),
               sparse_ce 64 over the ranks; the block sync's ms.
  8. whisper — ``StreamServer`` at full width and depth (whisper-medium:
               24 + 24 layers, d_model 1024, 16 heads of 64, vocab
               51865; 0.93 B f32 parameters drawn on the card from the
               seed): 8 slots, 16-frame chunks, sync_every 4, k=20,
               max_frames 256, SLO tiers with firehose windows of 4 (a
               stream's 16 chunks would fit one default firehose
               window); 6 firehose streams of 240 frames, a live
               interactive stream of 160 frames appended in 32-frame
               pieces between pumps and then closed, 2 interactive
               streams of 48 frames submitted after the first pump, and
               one firehose stream detached mid-flight and reattached.
               Useful frames/s and chunk steps/s over the drain; syncs,
               parks, utilization, occupancy; the peak device memory;
               topk_logits 2 launches a chunk step (stage 1 and the
               merge), one emission of R=8 rows at V=51865.  Holds: each
               stream one finite emission a chunk; the detached stream
               and the live stream bitwise equal to uninterrupted runs
               of their frames in a server of the same shape; topk_logits
               on the model's own logits at R=8 (one chunk step's unembed)
               against its plain version, values bitwise, ids exact; two
               firehose streams through the port's plain path on the host
               at full width, chunk by chunk over their first 8 chunks,
               up to the first chunk whose fed-back token is a near-tie
               (host top-2 margin <= GAP):
               ids exact away from near-ties, values within one bf16
               ulp, at least 4 chunks a stream.  Then the firehose and
               interactive streams again, traced: device ops and device
               ms a chunk step, the idle share.  Runs before lm and
               prefill, and frees its model.
  9. lm      — qwen2.5-3b at full widths, 36 layers cut to LM_LAYERS (4:
               0.619 B f32 parameters drawn on the card from the seed,
               copied to the host) through
               ``TokenServer(THROUGHPUT, max_seq=512, decode_kernel=True)``:
               32 requests of 16-256 prompt and 16-64 new tokens, half
               greedy, half sampled (two of them full-vocab, so mixed
               windows run); generated and fed tokens/s, steps, syncs,
               launches (decode_attention a layer a step).  The first 16
               requests again on the drain's server (prompts cut to 64,
               max_new to 32), one window after their first traced:
               device ops and device ms per step.  One decode_step
               computes the RoPE tables once for all its layers.
               Then two short requests on the card and on the host (plain
               versions), float32 caches: tokens equal away from
               near-ties, teacher-forced logits within LM_LOGIT_REL; and
               the 4 shortest greedy requests re-run on the card with
               decode_kernel=False: tokens equal away from near-ties.
               Its weights stay on the card for the paged phase.
  10. paged  — the paged KV cache (``TokenServer(paging=)``): (a)
               qwen2.5-3b at the lm phase's widths, depth and weights,
               ``PagedCacheConfig(16, 384, 512)``, 16 slots, float32
               caches, decode_kernel=True: 16 requests of 256-448
               prompt tokens (the first 16 ask for more pages than the
               pool has, so admission waits) and 8 sharing a 64-token
               prefix; tokens/s beside the contiguous server's on the
               same requests, greedy tokens equal to its away from
               near-ties, admission waits, prefix hits and fewer allocs
               than without the cache (the prefix requests drained with
               it off too, tokens equal), the pool's peak against the
               contiguous cache's bytes, alloc.check() and no live page
               after the drain, decode_attention a layer a step,
               topk_logits and topk_sample on the sampled windows; one
               traced window's device ops and ms a step by kind (pool
               writes, gathers, copies).  decode_attention(write=False)
               over a gathered bf16 view at B=16, S=512: against its
               plain version, timed beside its bound, SDPA and the
               gathers.  (b) gemma3-27b at full widths, depth cut to its
               (5 local, global) group's first local layer and its
               global one (2.23 B f32 parameters drawn on the card): 4
               requests of 1,040-1,100 prompt tokens paged against the
               contiguous server: tokens equal away from near-ties, a
               ring for the local layer and a pool for the global one,
               1 write=True and 1 write=False call a step,
               the prefix cache refused.  (c) deepseek-67b and
               chameleon-34b at full widths, 2 layers: 4 short greedy
               requests paged, finite logits, tokens equal the
               contiguous server's.  Each paged drain's launches count.
  11. moe    — qwen3-moe-30b-a3b at full widths (128 experts top-8,
               moe_d_ff 768, 32/4 heads, hd 128, qk_norm), 48 layers cut
               to 2: 1.869 B f32 parameters drawn on the card, the
               embedding scaled by 1/sqrt(d).  (a) a contiguous
               ``TokenServer`` (8 slots, float32 caches, fused kernels):
               8 requests of 32-96 prompt tokens, max_new 16, half
               sampled (top_k 20); logits finite, decode_attention 2 a
               step, topk_logits and topk_sample 1 a step; tokens/s.
               (b) the greedy half paged (``PagedCacheConfig(16, 32,
               128)``): tokens equal (a)'s away from near-ties, write=False
               2 a step.  (c) one ``make_prefill_step`` call at B=2,
               S=2048: swa_attention 2 launches a layer and nothing else,
               finite logits, moe_drop_frac by layer.  Each path's kernel
               inputs (decode step 40 of both drains, the prefill's layer
               0) held to the plain versions.  (d) layer 0's MoE on the
               host on its card inputs of decode step 40 and of the
               prefill: routing ids equal away from near-ties (MOE_TIE),
               per-group counts and drops equal, y within MOE_HOST_REL.
               (e) one traced window of 16 decode steps: device ms and
               ops a step, the MoE layers' share, the largest lines.
      mla    — deepseek-v3-671b at full widths (MLA ranks 1536/512,
               qk 128+64, v 128, 128 heads; 256 experts top-8 + 1
               shared, moe_d_ff 2048; dense d_ff 18,432; V 129,280;
               MTP 1), 61 layers cut to 2, one dense and one MoE: 13.944
               B f32 parameters drawn on the card, the embedding scaled
               by 1/sqrt(d), the MTP block on the MoE layer's own
               tensors (its norm and proj, 0.103 B, drawn).  (a) a
               contiguous ``TokenServer`` as moe's (a): MLA decodes in
               its absorbed plain form, so no decode_attention; 2
               ``mla_decode`` calls, topk_logits and topk_sample 1 a
               step.  (b) the greedy half paged (``PagedCacheConfig(16,
               26, 128)``) with two greedy requests on the longest
               greedy prompt's head: admission waits, prefix hits equal
               a host replay's (a reduced model, the prompts relabelled
               one to one), tokens equal (a)'s away from near-ties.  (c)
               one ``make_prefill_step`` call at B=1, S=2,048 (capacity
               80 a group) after ``apply`` on the same tokens:
               swa_attention 2 launches a layer a call and nothing else.
               (g) ``mtp_hidden`` on that hidden: shape, finite, one
               swa_attention call.  (d) a 64-token prompt's last prefill
               logits against ``decode_step`` after the same tokens
               within LM_LOGIT_REL, at a capacity where no assignment
               drops.  (e) layer 0's ``mla_decode`` of decode step 40 on
               the host on its card inputs: y and the written cache
               within MLA_HOST_REL.  (f) ``swa_attention`` on layer 0's
               prefill q/k/v (hd 192, v zero-padded from 128, G = 1,
               causal) within ATTN_REL of its plain version, timed beside
               SDPA ``is_causal`` with v at 128; ``topk_logits`` bitwise
               on one step's (8, 129,280) logits, k 1 and 32, timed.
               (h) one traced window of 16 decode steps, the MoE
               layer's and the MLA layers' device ms a step.  The peak
               ``max_memory_allocated``; everything freed after.
      recurrent — recurrentgemma-2b (26 layers: 18 RG-LRU and 8 local
               attention, hd 256, Hkv 1, G 10, window 2,048; V 256,000;
               2.894 B f32 parameters), then xlstm-350m (24 layers: 18
               mLSTM, hd 512, and 6 sLSTM; V 50,304; 0.500 B), each at
               full widths and depth, drawn on the card from the seed
               (the embedding scaled by 1/sqrt(d)), the first freed
               before the second.  (a) a ``TokenServer`` (8 slots,
               float32 caches of 2,048 slots: the local layers' rings at
               their window, fused kernels) drains the moe phase's 8
               requests and a 9th, the shortest greedy one again,
               admitted mid-drain into a reset row: its tokens equal its
               twin's away from near-ties; logits finite; decode_attention
               a local layer a step, topk_logits and topk_sample 1 a step.
               (b) each mixer's first layer (RG-LRU 0; mLSTM 0, sLSTM 3)
               of decode step 40 re-run on the host on its card inputs:
               y and the new state within RECURRENT_HOST_REL.  (c) the
               first local layer's decode_attention inputs of that step
               held to the plain version, timed beside SDPA over the
               written ring.  (d) the last prefill logits of the first
               64 prompt tokens of a drained request within LM_LOGIT_REL
               of the drain's ``decode_step`` after the same tokens (its
               row's logits at that step); the mixers' prefill calls
               re-run on the host.  (e) ``make_prefill_step`` at B=1, S=2,048
               (recurrentgemma: a warm-up and 2 timed calls, 16
               swa_attention launches a call) and S=512 (xlstm, one
               call: its loops are sequential).  (f) ``topk_logits``
               bitwise on one step's (8, V) logits, k 1 and 32, timed;
               ``topk_sample`` on a sampled step's own logits and knobs
               from the drain: vals and ids bitwise, tokens equal to the
               plain version's away from top_p boundaries and to the
               drain's, timed; ``swa_attention`` on the prefill's first
               local layer within ATTN_REL of its plain version, timed
               beside SDPA over kv repeated 10-fold with ``is_causal``.
               (g) one traced window of 16 decode steps on the drain's
               server and the mixers' device ms a step.  (b)-(e) run on
               the drain's model.
  12. prefill — h2o-danube-3-4b at full width (3.96 B f32 parameters drawn
               on the card from the seed, after the lm phase's model is
               freed) through ``launch.steps.make_prefill_step``: B=2 at
               S=8192 (the banded branch, window 4096) and S=2048 (the
               causal branch); a warm-up and 3 timed calls each, prompt
               tokens/s, 48 ``swa_attention`` launches per call (the
               prepass and the main kernel for each of 24 layers), finite
               (B, 1, 32000) logits; each traced once.  Layer 0's kernel
               output against the plain twins (``windowed_attention``,
               ``flash_full_attention``) on the same card tensors within
               ATTN_REL, and ``attention_apply`` at positions arange(S)
               within ATTN_REL of it at None; a 64-token prompt's last
               logits against ``decode_step`` after the same 64 tokens
               (float32 cache, decode_kernel=True) within LM_LOGIT_REL.
  13. lm_train — training the token LM: (a) ``swa_attention``'s
               autograd function (the kernel forward, the chunked PyTorch
               backward) against autograd through its plain version on
               the same card tensors, o, dq, dk and dv within
               SWA_GRAD_REL: qwen2.5-3b's layer (B=2, Hq=16, Hkv=2,
               hd=128, S=512) causal, at window 128 and at explicit
               positions (shifted by 7, three negative: rows that see no
               key), and MLA's (H=128, hd 192, v zero-padded from 128,
               S=256); the forward and the backward timed.  (b)
               ``sparse_ce`` at the LM's distill shape (T=1,024,
               D=2,048, V=151,936, K=20): loss, dh and dw against
               autograd through the plain version within REL, timed
               beside its bound.  (c) qwen2.5-3b at full widths, 2
               layers: one CE step's loss and every gradient leaf
               against the same step through the plain attention within
               LM_GRAD_REL, 2 swa_attention launches a layer; one
               distill_topk step through ``sparse_ce`` (2 launches).
               (d) qwen2.5-3b at full widths cut to LM_TRAIN_LAYERS (18)
               through ``Trainer(Local(optimizer="adam"))``, B=2, S=512,
               8 steps on one batch: losses finite and falling, the
               parameters moved, step ms, trained tokens/s, the peak
               against the dry run's reckoning, exactly 2 swa_attention
               launches a layer a forward.  (e) ``launch.train --arch A
               --smoke`` on the card for deepseek-v3-671b,
               recurrentgemma-2b and whisper-medium: finite losses; the
               first loss on host-made weights within LM_SMOKE_REL of
               the host's.

Every kernel's launch count is set to 0 just before phases 4 to 13 (in
the paged, moe, mla and recurrent phases before each drain or call of
the path, and summed over them), the
bmuf, prefetch, resume, baseline, teacher_train and smbr runs, each
stage of the pipeline phase and the gen_procs, elastic and waves runs,
and read just after each untraced run; a run that did not launch each
kernel of its path fails.  A worker process or rank starts its counts
at 0 and reports them as it exits; the gen_procs and waves paths'
topk_logits launches are those reports' sum, and the cluster path's
launches the ranks'.  Each kernel row's ``launches`` is the
sum over the paths, ``launches_by_path`` each path's own; ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` are at the shape named in
the row (``at``).  Every traced run records device activity only.  The
line before the last is ``{"kernels": [...]}``;
the last is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before either is printed; without CUDA, or without the
repository beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_OPS_PER_S = 67e12              # H100 SXM f32 peak outside tensor cores
TF32X3_OPS_PER_S = 495e12 / 3      # float32-accurate products on the tensor
                                   # cores: the dense TF32 rate over the
                                   # three TF32 products (3xTF32) that one
                                   # float32 product takes
SEED = 0
K = 20
GAP = 1e-4                         # near-tie threshold of the id check
KERNELS = ("topk_logits", "sparse_ce", "gtc_compress", "decode_attention",
           "topk_sample", "swa_attention")
D_MODEL = 768                      # the student's width (h of the loss)
TAU = 2e-4                         # the student stage's GTC threshold
REL = 1e-5                         # sparse_ce vs its plain version
HOST_REL = 1e-4                    # card vs host distill update
FB_TOL = 1e-5                      # scaled vs literal forward-backward
ATTN_REL = 1e-5                    # attention kernels' o vs plain versions
LM_LOGIT_REL = 1e-3                # card vs host decode_step logits
BF16_DRIFT = 0.1                   # share of the top logit within which two
                                   # bf16-cache decodes of 36 layers may
                                   # disagree (4-7% measured, PERF.md)
EXCL_WINDOW = 4e-6                 # |excl - top_p| where a token may move:
                                   # the kernel sums the softmax denominator
                                   # in another order, so each of <= 32
                                   # probabilities may differ in its last bit


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


def device_ms(fn, name: str = "", *, runs: int = 20) -> float:
    """Device time per ``fn()`` call of the kernels whose name contains
    ``name`` (every device op of the call for ``""``), read from a
    ``torch.profiler`` trace (host time excluded).  Fails if the trace
    has device ops but none named so; if three sessions record no
    device op at all, times ``fn()`` with CUDA events instead and says
    so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a session can come back with no device records at all (seen on an
    # H100, after several sessions that saw them): up to three sessions
    recorded = False
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        recorded = recorded or bool(ops)
        # the raw records' nanoseconds: a launch can take under the whole
        # microsecond that the per-event objects' time ranges round down to
        ns = sum(e.duration_ns() for e in ops if name in e.name())
        if ns:
            return ns / runs / 1e6
    if recorded:
        fail(f"the profiler saw no device time for {name or 'the call'!r} in "
             f"three sessions")
    ms = time_ms(fn, runs=runs)
    log(f"the profiler recorded no device op in three sessions: "
        f"{name or 'the call'!r} timed with CUDA events instead, {ms:.4f} "
        f"ms a call (host gaps included)")
    return ms


def host_us(fn, *, calls: int = 200) -> float:
    """Host time per ``fn()`` in microseconds over ``calls`` back-to-back
    calls: the time to enqueue the call (the wrapper's Python and the
    launch).  ``calls`` stays below the launch queue's depth (~1,024),
    so the host never waits for the card inside the timed loop."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


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
        spills = sorted({ln.strip() for ln in text.splitlines()
                         if "stack frame" in ln and not
                         ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                               "spill stores, 0 bytes spill "
                                               "loads")})
        log(f"  {name}: ptxas per instantiation: {' | '.join(used)}"
            + (f"; stack/spills: {' | '.join(spills)}" if spills else ""))


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
    # R=1 is one emission; V=2053's second tile holds 5 real columns, so
    # stage 1 repeats the first NEG column (duplicate ids); V<=8 tiles take
    # the one-launch route, V=32768 stage 1 and a merge launch
    n = 0
    # R=256, V in {49, 97}, k=10: the pipeline's chunked batch (8 x 32) at
    # its tiny and small widths; V=49 is one ragged tile of 49 columns
    grid = [(r, v, (1, K)) for r in (1, 128, 1024, 4096, 8192)
            for v in (97, 2053, 3183, 32768)]
    grid += [(256, v, (10,)) for v in (49, 97)]
    # R=8, V=51865: whisper's emission (8 slots, one position a chunk);
    # 26 tiles, so stage 1 and a merge launch
    grid += [(8, 51865, (1, K))]
    for r, v, ks in grid:
        for kind in ("continuous", "ties"):
            x = torch.randn((r, v), generator=gen, device="cuda")
            if kind == "ties":              # 5 levels: ties everywhere
                x = torch.round(x * 1.5).clamp(-2, 2) * 0.75
            for k in ks:
                check_kernel(x, k, f"R={r} V={v} k={k} ({kind})")
                n += 1
    # signed zeros tie and go in id order, each value its own element's
    # (ref.py's docstring): the reference op's ids, the plain version's bits
    x = torch.tensor([[-0.0, 0.0, -0.0, 0.0, -1.0]], device="cuda")
    zv, zi = ops.topk_logits(x, 4)
    rv, ri = ref.topk_logits_ref(x, 4)
    if zi.tolist() != [[0, 1, 2, 3]] or not torch.equal(zi, ri) or \
            not same_bits(zv, rv) or \
            torch.signbit(zv).tolist() != [[True, False, True, False]]:
        fail(f"topk_logits on [-0, +0, -0, +0, -1], k=4: ids {zi.tolist()}, "
             f"sign bits {torch.signbit(zv).tolist()}; want ids [0, 1, 2, 3] "
             f"and sign bits [T, F, T, F]")
    n += 1
    torch.cuda.synchronize()
    log(f"kernel: topk_logits == plain version (stage 1 and merged, "
        f"values bitwise, ids exact) on {n} cases")

    v = 3183
    at_rows = {}
    for rows, vv in ((128, v), (4096, v), (8192, v), (8, 51865)):
        x = torch.randn((rows, vv), generator=gen, device="cuda")
        err = check_kernel(x, K, f"R={rows} V={vv} k={K} (timed input)")
        b, by = bound(rows, vv)
        key = rows if vv == v else f"{rows}x{vv}"
        at_rows[key] = {
            "ms": time_ms(lambda: ops.topk_logits(x, K)),
            "plain_ms": time_ms(lambda: ref.topk_logits_ref(x, K)),
            "library_ms": time_ms(lambda: torch.topk(x, K, dim=-1)),
            "bound_ms": b, "bound_by": by, "max_abs_err": err,
            "device_ms": device_ms(lambda: ops.topk_logits(x, K), "topk_"),
            "library_device_ms": device_ms(lambda: torch.topk(x, K, dim=-1)),
            "host_us": host_us(lambda: ops.topk_logits(x, K)),
            "library_host_us": host_us(lambda: torch.topk(x, K, dim=-1))}
        t = at_rows[key]
        log(f"kernel: R={rows} V={vv} k={K}: {t['ms']:.4f} ms (device only: "
            f"{t['device_ms']:.4f} ms; host {t['host_us']:.1f} us a call), "
            f"plain sort {t['plain_ms']:.4f} ms, torch.topk "
            f"{t['library_ms']:.4f} ms (device only: "
            f"{t['library_device_ms']:.4f} ms; host "
            f"{t['library_host_us']:.1f} us), bound {b:.4f} ms ({by})")
    x = torch.randn((4096, v), generator=gen, device="cuda")
    stage1_ms = time_ms(lambda: kernel.topk_logits_tiles(x, K,
                                                         ref.tile_width(v)))
    stage1_dev = device_ms(lambda: kernel.topk_logits_tiles(
        x, K, ref.tile_width(v)), "topk_tiles")
    log(f"kernel: R=4096 stage 1 alone {stage1_ms:.4f} ms (device "
        f"{stage1_dev:.4f} ms)")
    t = at_rows[4096]
    return {"name": "topk_logits", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_logits.cu",
            "replaces": "src/repro/kernels/topk_logits/kernel.py:57",
            "launches": 0,
            "max_abs_err": max(a["max_abs_err"] for a in at_rows.values()),
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "at": "R=4096 V=3183 k=20",
            "at_rows": {str(r): {key: a[key] for key in
                                 ("ms", "device_ms", "plain_ms",
                                  "library_ms", "library_device_ms",
                                  "host_us", "library_host_us", "bound_ms")}
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
    """(bound ms, what bounds it, the CUDA-core figure ms): 2*T*D*V flops
    at the float32-accurate tensor-core rate (3xTF32), against h, w, ids
    read once and lse, z written once.  The third value is the same
    flops at the f32 CUDA-core rate, which a tensor-core design beats."""
    ops_ms = 2 * t * d * v / TF32X3_OPS_PER_S * 1e3
    bytes_ms = 4 * (t * d + d * v + 2 * t * k + t) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), \
        2 * t * d * v / F32_OPS_PER_S * 1e3


def phase_sparse_ce() -> dict:
    import torch
    from repro_torch.kernels.sparse_ce import kernel, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def inputs(t, v, k, d=D_MODEL, scale=1.0):
        h = torch.randn((t, d), generator=gen, device="cuda") * scale
        w = torch.randn((d, v), generator=gen, device="cuda") / math.sqrt(d)
        idx = torch.randint(0, v, (t, k), generator=gen, device="cuda",
                            dtype=torch.int32)
        if k > 1:
            idx[:, 1] = idx[:, 0]              # a duplicate id in every row
        return h, w, idx

    worst, n = 0.0, 0
    grid = [(t, D_MODEL, v, k) for t in (128, 1024, 4096) for v in (97, 3183)
            for k in (1, K)]
    # T = 33: a ragged row tile; D = 100 and 32: one ragged and one whole
    # 32-deep chunk
    grid += [(33, d, v, k) for d in (100, 32) for v in (97, 3183)
             for k in (1, K)]
    # the pipeline's chunked batch (T = 8 x 32) at the tiny widths (D=64:
    # two 32-deep chunks; V=49 below one 128-column tile) and the small
    grid += [(256, 64, 49, 10), (256, 128, 97, 10)]
    for t, d, v, k in grid:
        h, w, idx = inputs(t, v, k, d)
        caps = (0.0, 30.0) if (t, d, v, k) == (1024, D_MODEL, 3183, K) \
            else (0.0,)
        for cap in caps:
            worst = max(worst, check_sparse_ce(
                h, w, idx, cap, f"T={t} D={d} V={v} K={k} softcap={cap}"))
            n += 1
    # D % 4 != 0 (4-byte copies of h), K > 32 (the gather's second
    # pass) and w a view 4 bytes into its storage (rows read at a shift)
    t, d, v, k = 33, 37, 3183, 40
    h, w, idx = inputs(t, v, k, d)
    storage = torch.empty(d * v + 1, device="cuda")
    w_view = storage[1:].view(d, v)
    w_view.copy_(w)
    for ww, what in ((w, "w aligned"), (w_view, "w at a 4-byte offset")):
        worst = max(worst, check_sparse_ce(
            h, ww, idx, 0.0, f"T={t} D={d} V={v} K={k}, {what}"))
        n += 1
    log(f"kernel: sparse_ce == plain version within {REL} of max(1, "
        f"|plain|) on {n} cases (worst {worst:.3e})")

    # large logits: h x 30 at the main shape (logits ~30, up to ~140).  A
    # gathered logit near 0 then carries the rounding of partial sums of
    # size ~30, in the plain float32 product as in the kernel, beyond REL
    # of max(1, |x|) for both.  So: lse within REL of the plain version,
    # and lse and z no further from float64 than the plain version is.
    t, v = 1024, 3183
    h, w, idx = inputs(t, v, K, scale=30.0)
    large = {}
    for cap in (0.0, 30.0):
        lse, z = kernel.sparse_ce_tiles(h, w, idx, cap)
        rl, rz = ref.sparse_ce_lse_gather_ref(h, w, idx, softcap=cap)
        x64 = h.double() @ w.double()
        if cap:
            x64 = torch.tanh(x64 / cap) * cap
        l64 = torch.logsumexp(x64, dim=-1)
        z64 = torch.gather(x64, -1, idx.long())
        errs = {"kernel_vs_plain": max(rel_err(lse, rl), rel_err(z, rz)),
                "kernel_vs_f64": max(rel_err(lse.double(), l64),
                                     rel_err(z.double(), z64)),
                "plain_vs_f64": max(rel_err(rl.double(), l64),
                                    rel_err(rz.double(), z64)),
                "lse_kernel_vs_plain": rel_err(lse, rl)}
        log(f"kernel: sparse_ce with h x 30, softcap={cap}, T={t} V={v} "
            f"K={K}: error of max(1, |reference|): " + ", ".join(
                f"{k_} {e:.3e}" for k_, e in errs.items()))
        if not (errs["lse_kernel_vs_plain"] <= REL
                and errs["kernel_vs_f64"] <= errs["plain_vs_f64"]):
            fail(f"sparse_ce with h x 30, softcap={cap}: lse not within "
                 f"{REL} of the plain version, or further from float64 "
                 f"than the plain version: {errs}")
        large[f"softcap={cap}"] = errs

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

    def call():
        return kernel.sparse_ce_tiles(h, w, idx)

    b, by, b_cuda_core = sparse_ce_bound(t, D_MODEL, v, K)
    row = {"name": "sparse_ce", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/sparse_ce.cu",
           "replaces": "src/repro/kernels/sparse_ce/kernel.py:79",
           "launches": 0, "max_abs_err": 0.0,
           "launches_per_call": 2,
           "ms": time_ms(call),
           "device_ms": device_ms(call, "sparse_ce"),
           "tiles_device_ms": device_ms(call, "sparse_ce_tc"),
           "host_us": host_us(call),
           "plain_ms": time_ms(lambda: ref.sparse_ce_lse_gather_ref(
               h, w, idx)),
           "composite_ms": time_ms(composite),
           "composite_device_ms": device_ms(composite),
           "bound_ms": b, "bound_by": by,
           "bound_cuda_core_ms": b_cuda_core, "library_ms": None,
           "large_logits_err": large,
           "at": f"T={t} D={D_MODEL} V={v} K={K}"}
    lse, z = call()
    row["max_abs_err"] = max(float((lse - lse_ref).abs().max()),
                             float((z - z_ref).abs().max()))
    log(f"kernel: sparse_ce at {row['at']}: {row['ms']:.4f} ms (device "
        f"only, both launches: {row['device_ms']:.4f} ms, the tile kernel "
        f"{row['tiles_device_ms']:.4f}; host {row['host_us']:.1f} us a "
        f"call), plain {row['plain_ms']:.4f} ms, materialising composite "
        f"logsumexp(h @ w) + gather {row['composite_ms']:.4f} ms (device "
        f"{row['composite_device_ms']:.4f}), bound {b:.4f} ms ({by}, "
        f"3xTF32 on the tensor cores: {row['bound_ms'] / row['device_ms']:.0%}"
        f" of it; on the CUDA cores {b_cuda_core:.4f} ms)")
    return row


def student_leaf_shapes(cfg=None) -> dict:
    """{leaf: shape} of the student (``cfg``; default the full-width
    lstm-am-7khr) in the reference's leaf order."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lstm_am import LstmAM
    from repro_torch.utils.trees import leaf_order
    sd = LstmAM(cfg or get_arch("lstm-am-7khr"), device="meta",
                generator=None).state_dict()
    return {n: tuple(sd[n].shape) for n in leaf_order(sd)}


def tiny_student_cfg():
    """The student of ``PipelineConfig.tiny()``: 2x64 LSTM, 49 senones."""
    from repro_torch.core.ssl_pipeline import PipelineConfig, am_configs
    pc = PipelineConfig.tiny()
    return am_configs(n_layers=pc.n_layers, lstm_hidden=pc.lstm_hidden,
                      n_senones=pc.n_senones, feat_dim=pc.feat_dim)[0]


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
    tiny = {f"tiny {n}": s for n, s in
            student_leaf_shapes(tiny_student_cfg()).items()}
    gs, rs = {}, {}
    sent = total = 0
    for name, shape in {**shapes, **tiny}.items():
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
    tiny_total = sum(math.prod(s) for s in tiny.values())
    total -= tiny_total
    off = torch.randn(1 + 8193, generator=gen, device="cuda") * TAU
    check_gtc(off[1:], off[:-1].clone(), "an unaligned view of 8193 values")
    log(f"kernel: gtc_compress == plain version bitwise on the student's "
        f"{len(shapes)} leaves ({total} values) and the tiny pipeline "
        f"student's {len(tiny)} ({tiny_total} values; density "
        f"{sent / (total + tiny_total):.4f}, |acc| == tau, 0, -0 and NaN "
        f"forced) and an unaligned view")

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
    from repro_torch.train import distill_shard_source
    from repro_torch.train.strategies import clipped_grads
    out = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(out, ignore_errors=True)

    def run(log_fn=log):
        return launch_train.stage_student(full=True, device="cuda",
                                          seed=SEED, prefetch=0,
                                          ckpt_every=0, out=str(out),
                                          log=log_fn)

    launch_train.stage_student(full=False, device="cuda", seed=SEED,  # warm-up
                               steps=2, prefetch=0, ckpt_every=0,
                               out=str(out / "warm"), log=lambda _m: None)
    launch_counts(reset=True)
    res = run()
    counts = launch_counts()
    r = res.results
    missing = [k for k in ("topk_logits", "sparse_ce", "gtc_compress")
               if counts[k] == 0]
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

    # one distill update from the final state, on the card and the host,
    # on the first batch as the stage reads it (v2 store, pinned wave)
    batch = next(distill_shard_source(res.unlabeled, res.store, 0, 1, 0.0,
                                      pin_wave=True)).data
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
    again = []
    prof = traced("train", lambda: again.append(run(lambda _m: None)))
    # two uninterrupted runs: what resume and prefetch are held to
    RUNS["gtc"] = [host_state(res.state), host_state(again[0].state)]
    RUNS["gtc_frames_per_s"] = r["frames_per_s"]
    RUNS["gtc_trace"] = prof
    return counts


# ------------------------------------- training: prefetch, BMUF, resume

RUNS = {}             # finished training states a later phase is held to


def host_state(state) -> dict:
    """A TrainState's tensors copied to the host: params, optimizer and
    strategy state, and the step."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x.detach().to("cpu", copy=True)
    return {"params": walk(state.params), "opt": walk(state.opt_state),
            "strategy": walk(state.strategy_state), "step": state.step}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif hasattr(v, "shape"):
            yield prefix + k, v


def state_diff(a: dict, b: dict) -> float:
    """0.0 when two host states are bitwise equal (every float32 leaf,
    and the step); else the largest leaf difference relative to that
    leaf's largest magnitude (1e-300 at the least)."""
    if a["step"] != b["step"]:
        fail(f"states at different steps: {a['step']} vs {b['step']}")
    la, lb = list(_leaves(a)), list(_leaves(b))
    if [n for n, _ in la] != [n for n, _ in lb]:
        fail("states with different leaves")
    worst = 0.0
    for (n, x), (_, y) in zip(la, lb):
        if same_bits(x, y):
            continue
        d = float((x.double() - y.double()).abs().max()
                  / max(float(x.double().abs().max()), 1e-30))
        worst = max(worst, d, 1e-300)
    return worst


def hold_to_rule(what: str, refs, got: dict) -> str:
    """The determinism rule: two uninterrupted runs ``refs``; if they are
    bitwise equal, ``got`` must be too; if not, ``got`` must lie within
    their run-to-run difference of one of them."""
    base = state_diff(refs[0], refs[1])
    d = [state_diff(r, got) for r in refs]
    if base == 0.0:
        if max(d) != 0.0:
            fail(f"{what}: two uninterrupted runs are bitwise equal, but "
                 f"this run differs from them by {d}")
        return "bitwise equal to two uninterrupted runs (bitwise equal " \
               "to each other)"
    if min(d) > base:
        fail(f"{what}: {d} from two uninterrupted runs, beyond their "
             f"run-to-run difference {base:.3e}")
    return (f"within the run-to-run difference {base:.3e} of two "
            f"uninterrupted runs (distances {d[0]:.3e}, {d[1]:.3e})")


def count_copies(prof: dict) -> dict:
    """Host-to-device copies in a ``profile_device`` trace: pinned or
    pageable, on the stream that runs most kernels (the compute stream)
    or another one (the prefetch feed's side stream)."""
    by_stream = {}
    for name, per in prof["streams"].items():
        if not name.startswith("Memcpy"):
            for sid, n in per.items():
                by_stream[sid] = by_stream.get(sid, 0) + n
    compute = max(by_stream, key=by_stream.get)
    out = {"pinned_side": 0, "pinned_compute": 0, "pageable_side": 0,
           "pageable_compute": 0, "names": {}}
    for name, per in prof["streams"].items():
        if "HtoD" not in name:
            continue
        out["names"][name] = dict(per)
        kind = "pinned" if "Pinned" in name else "pageable"
        for sid, n in per.items():
            out[f"{kind}_{'compute' if sid == compute else 'side'}"] += n
    return out


def phase_prefetch():
    """The GTC student at prefetch=2 against the train phase's two
    prefetch=0 runs: the same final state (the determinism rule),
    frames/s both ways, and a traced run whose batch copies come from
    pinned memory on the side stream."""
    from repro_torch.launch import train as launch_train
    out = ROOT / "build" / "chip_smoke_prefetch"
    shutil.rmtree(out, ignore_errors=True)

    def run(log_fn=log):
        return launch_train.stage_student(full=True, device="cuda",
                                          seed=SEED, prefetch=2,
                                          ckpt_every=0, out=str(out),
                                          log=log_fn)

    launch_counts(reset=True)
    p2 = run()
    counts = launch_counts()
    missing = [k for k in ("topk_logits", "sparse_ce", "gtc_compress")
               if counts[k] == 0]
    if missing:
        fail(f"prefetch: the student stage launched no {missing} kernel")
    # prefetch=0: the train phase's two uninterrupted runs (its untraced
    # run's rate)
    rule = hold_to_rule("prefetch=2", RUNS["gtc"], host_state(p2.state))
    log(f"prefetch: GTC student frames/s of training: prefetch=0 "
        f"{RUNS['gtc_frames_per_s']:.1f} (the train phase), prefetch=2 "
        f"{p2.results['frames_per_s']:.1f}; launches {counts}")
    log(f"prefetch: prefetch=2 {rule}")
    log("prefetch: prefetch=2 again, traced:")
    runs = []
    prof = traced("prefetch", lambda: runs.append(run(lambda _m: None)))
    by_loss = runs[0].results["updates_by_loss"]
    want = 4 * by_loss["distill_topk"] + 3 * by_loss["ce"]
    got, before = count_copies(prof), count_copies(RUNS["gtc_trace"])
    if got["pinned_side"] != want:
        fail(f"prefetch: {got['pinned_side']} pinned host-to-device copies "
             f"on the side stream, want {want} (the batches' arrays); "
             f"copies seen: {got['names']}")
    log(f"prefetch: the batches' {want} host-to-device copies from pinned "
        f"memory on the side stream; the stage's pageable copies left "
        f"{got['pageable_side'] + got['pageable_compute']} (prefetch=0 "
        f"traced in the train phase: {before['pageable_compute']} pageable, "
        f"{before['pinned_side'] + before['pinned_compute']} pinned); "
        f"copies by name and stream: {got['names']}")
    shutil.rmtree(out, ignore_errors=True)


def phase_bmuf() -> dict:
    """The BMUF student at full width (W = 4 lanes, tau = 2): 6 updates
    of 8 microbatches; the kernels' launches; the stage again (the second
    uninterrupted run); one block re-run on the card (traced) and on the
    host; block sync's share of an update."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.bmuf import block_sync, make_bmuf_block_step
    from repro_torch.launch import steps
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.train import BMUFVmap, distill_shard_source, make_sgd_step
    from repro_torch.train.state import fold_seed
    out = ROOT / "build" / "chip_smoke_bmuf"
    shutil.rmtree(out, ignore_errors=True)

    def run(where, log_fn=log):
        return launch_train.stage_student(full=True, device="cuda",
                                          seed=SEED, trainer="bmuf",
                                          ckpt_every=0, out=str(out / where),
                                          log=log_fn)

    launch_counts(reset=True)
    res = run("first")
    counts = launch_counts()
    r = res.results
    want = {"topk_logits": 32, "sparse_ce": 64, "gtc_compress": 0}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"bmuf: launches {counts}, want {want}")
    if r["updates"] != 6 or r["updates_by_loss"] != {"distill_topk": 4,
                                                     "ce": 2} \
            or not all(math.isfinite(x) for x in (r["loss_first"],
                                                  r["loss_last"])):
        fail(f"bmuf: {r['updates']} updates ({r['updates_by_loss']}), "
             f"losses {r['loss_first']} / {r['loss_last']}")
    st = res.state
    if not all(torch.isfinite(p).all() for p in st.params.values()):
        fail("bmuf: non-finite parameters after the stage")
    bstate = {"theta_g": st.params, **st.strategy_state}
    sync_ms = time_ms(lambda: block_sync(bstate, launch_train.BMUF),
                      runs=10)
    update_ms = r["train_s"] * 1e3 / r["updates_run"]
    log(f"bmuf: {r['updates']} updates ({r['updates_by_loss']}) of "
        f"{r['microbatches']} x 16x64 frames in {r['train_s']:.3f} s = "
        f"{r['frames_per_s']:.1f} frames/s of training; targets "
        f"{r['targets_s']:.3f} s; loss {r['loss_first']:.4f} -> "
        f"{r['loss_last']:.4f}; block sync {sync_ms:.3f} ms = "
        f"{sync_ms / update_ms:.2%} of an update ({update_ms:.1f} ms); "
        f"launches {counts}")

    # the second uninterrupted run, which resume is held to with the first
    hs = host_state(st)
    t0 = time.perf_counter()
    RUNS["bmuf"] = [hs, host_state(run("again", lambda _m: None).state)]
    RUNS["bmuf_sync_ms"] = sync_ms
    RUNS["bmuf_frames_per_s"] = r["frames_per_s"]
    RUNS["bmuf_counts"] = counts
    # the targets the cluster phase's BMUF ranks train on
    keep = CLUSTER_IN / "bmuf"
    shutil.rmtree(keep, ignore_errors=True)
    for name in ("logit_store", "ckpt_teacher"):
        shutil.copytree(out / "first" / name, keep / name)
    shutil.copy(out / "first" / "gen_ledger.json", keep / "gen_ledger.json")
    log(f"bmuf: the same stage again in {time.perf_counter() - t0:.1f} s")

    # one distill block from the final state, on the card (traced) and
    # the host, on the stage's first 8 microbatches as it reads them
    group = [tb.data for tb in distill_shard_source(
        res.unlabeled, res.store, 0, 8, 0.0, pin_wave=True)]
    batches = BMUFVmap(launch_train.BMUF).stack(group)
    seed = fold_seed(st.rng, st.step)
    block = make_bmuf_block_step(
        make_sgd_step(res.loss_fns["distill_topk"]), launch_train.BMUF)
    log("bmuf: one distill block on the card, traced:")
    blocks = []
    traced("bmuf", lambda: blocks.append(
        block(bstate, st.opt_state, batches, 0.05, seed)))
    card = blocks[0][0]
    cfg = get_arch("lstm-am-7khr")
    t0 = time.perf_counter()
    host_model = build_model(cfg, device="cpu", params=hs["params"])
    host, _, _ = make_bmuf_block_step(
        make_sgd_step(steps.make_loss_fn(host_model, cfg, "distill_topk")),
        launch_train.BMUF)({"theta_g": hs["params"], **hs["strategy"]},
                           hs["opt"], batches, 0.05, seed)
    host_s = time.perf_counter() - t0
    errs = {}
    for key in ("theta_g", "delta", "workers"):
        for n, h in host[key].items():
            errs[f"{key}/{n}"] = float(
                (card[key][n].cpu() - h).abs().max() / h.abs().max())
    if not max(errs.values()) <= HOST_REL:
        fail(f"bmuf: card vs host block beyond {HOST_REL}: "
             + str({k: v for k, v in errs.items() if v > HOST_REL}))
    log(f"bmuf: one distill block (4 lanes x 2 local steps) re-run on the "
        f"host ({host_s:.1f} s there): theta_g, delta and every lane within "
        f"{HOST_REL} (worst {max(errs.values()):.2e})")
    del card, blocks, host, host_model, bstate
    shutil.rmtree(out, ignore_errors=True)
    return counts


def _killed_after(n_items: int, real):
    """``real`` (a function returning a training source) whose source
    raises after its first ``n_items``."""
    def source(*args, **kwargs):
        for i, tb in enumerate(real(*args, **kwargs)):
            if i == n_items:
                raise RuntimeError("killed")
            yield tb
    return source


def phase_resume():
    """The GTC and the BMUF students, checkpointing every update, killed
    by their source after update 3 and re-invoked: held to the two
    uninterrupted runs of the train and bmuf phases by the determinism
    rule."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch import train as launch_train
    out = ROOT / "build" / "chip_smoke_resume"
    shutil.rmtree(out, ignore_errors=True)
    for trainer, per, prefetch, kernels in (
            ("gtc", 1, 0, ("sparse_ce", "gtc_compress")),
            ("bmuf", 8, 2, ("sparse_ce",))):
        kw = dict(full=True, device="cuda", seed=SEED, trainer=trainer,
                  ckpt_every=1, prefetch=prefetch, out=str(out / trainer),
                  log=lambda _m: None)
        real = launch_train.scheduled_source
        launch_train.scheduled_source = _killed_after(3 * per, real)
        t0 = time.perf_counter()
        try:
            launch_train.stage_student(**kw)
        except RuntimeError as e:
            if "killed" not in str(e):
                raise
        else:
            fail(f"resume: the {trainer} student was not killed")
        finally:
            launch_train.scheduled_source = real
        kill_s = time.perf_counter() - t0
        store = CheckpointStore(str(out / trainer / f"ckpt_student_{trainer}"
                                    / "state"))
        if store.latest() != 3:
            fail(f"resume: {trainer} latest checkpoint {store.latest()}, "
                 "want 3")
        ckpt_mb = sum(f.stat().st_size for f in Path(store.root).iterdir()
                      ) / len(store.steps()) / 1e6
        launch_counts(reset=True)
        t0 = time.perf_counter()
        res = launch_train.stage_student(**kw)
        resume_s = time.perf_counter() - t0
        counts = launch_counts()
        r = res.results
        total = RUNS[trainer][0]["step"]
        if (r["resumed_at"], r["updates"], r["updates_run"],
                r["targets_written"]) != (3, total, total - 3, 0):
            fail(f"resume: {trainer} resumed at {r['resumed_at']}, "
                 f"{r['updates']} updates, {r['updates_run']} run, "
                 f"{r['targets_written']} target batches written again")
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            fail(f"resume: the resumed {trainer} run launched no {missing}")
        if counts["topk_logits"]:
            fail(f"resume: the resumed {trainer} run forwarded targets "
                 f"again ({counts['topk_logits']} topk_logits launches)")
        if store.latest() is not None:
            fail(f"resume: the {trainer} stage's end left its checkpoints")
        rule = hold_to_rule(f"resumed {trainer}", RUNS[trainer],
                            host_state(res.state))
        log(f"resume: {trainer} killed after update 3 ({kill_s:.2f} s, 3 "
            f"checkpoints of {ckpt_mb:.1f} MB), re-invoked on its targets "
            f"(none forwarded again): {r['updates_run']} more updates in "
            f"{resume_s:.2f} s (training "
            f"{r['train_s']:.3f} s = {r['frames_per_s']:.1f} frames/s); "
            f"{rule}; launches {counts}")
    shutil.rmtree(out, ignore_errors=True)


def phase_baseline():
    """``stage_baseline`` at full width: CE on the synthetic corpus under
    Local; one CE update re-run on the host."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.train import Local
    from repro_torch.train.strategies import clipped_grads
    out = ROOT / "build" / "chip_smoke_baseline"
    shutil.rmtree(out, ignore_errors=True)
    launch_counts(reset=True)
    res = launch_train.stage_baseline(full=True, device="cuda", seed=SEED,
                                      ckpt_every=0, out=str(out), log=log)
    counts = launch_counts()
    r = res.results
    if r["updates"] != r["batches"] or r["updates"] == 0 or not all(
            math.isfinite(x) for x in (r["loss_first"], r["loss_last"])):
        fail(f"baseline: {r['updates']} updates of {r['batches']} batches, "
             f"losses {r['loss_first']} / {r['loss_last']}")
    params = res.state.params
    card, card_g = clipped_grads(res.loss_fn, params, res.first_batch)
    cfg = get_arch("lstm-am-7khr")
    host_params = _host(params)
    host, host_g = clipped_grads(
        steps.make_loss_fn(build_model(cfg, device="cpu",
                                       params=host_params), cfg, "ce"),
        host_params, res.first_batch)
    errs = {"loss": float((card["loss"].cpu() - host["loss"]).abs()
                          / host["loss"].abs())}
    for n in host_g:
        errs[n] = float((card_g[n].cpu() - host_g[n]).abs().max()
                        / host_g[n].abs().max())
    if not max(errs.values()) <= HOST_REL:
        fail(f"baseline: card vs host CE update beyond {HOST_REL}: "
             + str({k: v for k, v in errs.items() if v > HOST_REL}))
    log(f"baseline: {r['updates']} CE updates, loss {r['loss_first']:.4f} -> "
        f"{r['loss_last']:.4f}, {r['frames_per_s']:.1f} real frames/s of "
        f"training (corpus MVN {r['mvn_s']:.2f} s); launches {counts}; one "
        f"CE update re-run on the host: loss and clipped gradients within "
        f"{HOST_REL} (worst {max(errs.values()):.2e})")

    # where the training time goes: the updates alone, timed on the card
    # from the final state (a chunked batch and a full-sequence one), and
    # the seconds the feed's thread spent in the corpus source
    update = Local().make_update(res.loss_fn)
    n_full = len(res.pipe._batches(res.pipe.rng_labeled, chunked=False))
    ms = {k: time_ms(lambda: update(res.state, batch, 0.0), runs=3,
                     warmup=1)
          for k, batch in (("chunked", res.first_batch),
                           ("full", res.last_batch))}
    updates_s = ((r["batches"] - n_full) * ms["chunked"]
                 + n_full * ms["full"]) / 1e3
    log(f"baseline: training {r['train_s']:.2f} s = the updates alone "
        f"{updates_s:.2f} s ({r['batches'] - n_full} chunked "
        f"{tuple(res.first_batch['feats'].shape[:2])} at "
        f"{ms['chunked']:.1f} ms, {n_full} full-sequence "
        f"{tuple(res.last_batch['feats'].shape[:2])} at {ms['full']:.1f} ms) "
        f"+ {r['train_s'] - updates_s:.2f} s outside them; the feed's "
        f"thread spent {r['source_s']:.2f} s in the corpus source")
    # ckpt_baseline stays for the smbr phase, which removes it


def phase_teacher_train() -> dict:
    """``stage_teacher`` at full width: the CE fit, then the sMBR
    fine-tune; one sMBR update's peak memory; an sMBR update on the card
    against the host's; the scaled forward-backward against its literal
    twin."""
    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import model_forward
    from repro_torch.models import build_model
    from repro_torch.seqtrain import fb, make_smbr_loss_fn
    from repro_torch.train import Local
    from repro_torch.train.strategies import loss_and_grads
    out = ROOT / "build" / "chip_smoke_teacher"
    shutil.rmtree(out, ignore_errors=True)
    launch_counts(reset=True)
    res = launch_train.stage_teacher(full=True, device="cuda", seed=SEED,
                                     ckpt_every=0, out=str(out), log=log)
    counts = launch_counts()
    r = res.results
    if (r["ce_updates"], r["smbr_updates"]) != (10, 4) or not all(
            math.isfinite(x) for x in (r["loss_last"], r["smbr_eacc"],
                                       r["smbr_log_z"])) \
            or not 0.0 < r["smbr_eacc"] <= 1.0 or not 0 <= r["val_fer"] <= 1:
        fail(f"teacher_train: {r}")
    if not all(torch.isfinite(p).all() for p in res.state.params.values()):
        fail("teacher_train: non-finite parameters after the stage")
    log(f"teacher_train: CE {r['ce_frames_per_s']:.1f} real frames/s "
        f"({r['ce_updates']} updates, {r['ce_frames']:.0f} frames in "
        f"{r['ce_train_s']:.2f} s; {r['ce_source_s']:.2f} s in the corpus "
        f"source), sMBR {r['smbr_frames_per_s']:.1f} real frames/s "
        f"({r['smbr_updates']} updates of {r['smbr_batch']}, "
        f"{r['smbr_frames']:.0f} frames in {r['smbr_train_s']:.2f} s); "
        f"sMBR eacc {r['smbr_eacc']:.4e}, log Z {r['smbr_log_z']:.3f}; val "
        f"FER {r['val_fer']:.4f}; launches {counts}")

    # the peak device memory of one sMBR update from the final state
    batch = res.batches[0]
    update = Local(clip=0.0).make_update(res.loss_fn)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pc = launch_train.stage_config(True)
    update(res.state, batch, pc.smbr_lr)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"teacher_train: one sMBR update of {tuple(batch['mask'].shape)}: "
        f"peak device memory {peak / 2**30:.3f} GiB "
        f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
        f"held before it)")

    # one sMBR update's loss and gradients, card against host, on a cut
    cut = {k: v[:2, :48] for k, v in batch.items()}
    cfg = launch_train._teacher_cfg(True)
    card_loss, _, card_g = loss_and_grads(res.loss_fn, res.state.params,
                                          cut)
    host_params = _host(res.state.params)
    host_fn = make_smbr_loss_fn(build_model(cfg, device="cpu",
                                            params=host_params), cfg,
                                res.graph, kappa=pc.smbr_kappa)
    host_loss, _, host_g = loss_and_grads(host_fn, host_params, cut)
    errs = {"loss": float((card_loss.cpu() - host_loss).abs()
                          / host_loss.abs())}
    for n in host_g:
        errs[n] = float((card_g[n].cpu() - host_g[n]).abs().max()
                        / host_g[n].abs().max())
    if not max(errs.values()) <= HOST_REL:
        fail(f"teacher_train: card vs host sMBR update beyond {HOST_REL}: "
             + str({k: v for k, v in errs.items() if v > HOST_REL}))
    log(f"teacher_train: one sMBR update (2 rows x 48 frames) re-run on the "
        f"host: loss {float(host_loss):.6f}, loss and gradients within "
        f"{HOST_REL} (worst {max(errs.values()):.2e}, loss "
        f"{errs['loss']:.2e})")

    # the scaled forward-backward against its literal twin on the card
    model = build_model(cfg, device="cuda", params=res.state.params)
    g = res.graph.to("cuda")
    sub = {k: torch.as_tensor(v[:2, :32]).cuda() for k, v in batch.items()}
    with torch.no_grad():
        h, _ = model_forward(model, cfg, None, {"feats": sub["feats"]})
        lo = pc.smbr_kappa * (torch.log_softmax(
            model.unembed(h), -1) - g.log_prior)
        args = (lo, g.log_trans, g.log_init, sub["mask"])
        gam, z = fb.forward_backward(*args)
        lgam, lz = fb.forward_backward_literal(*args)
        scaled_ms = time_ms(lambda: fb.forward_backward(*args), runs=5)
        literal_ms = time_ms(lambda: fb.forward_backward_literal(*args),
                             runs=5)
    err_g = float((gam - lgam).abs().max())
    err_z = float(((z - lz).abs() / lz.abs().clamp(min=1.0)).max())
    if not (err_g <= FB_TOL and err_z <= FB_TOL):
        fail(f"teacher_train: scaled forward-backward vs the literal twin: "
             f"gamma {err_g:.3e}, log Z {err_z:.3e} (limit {FB_TOL})")
    log(f"teacher_train: scaled forward-backward == literal (B, S, S) twin "
        f"at B=2, T=32, S={cfg.n_senones} within {FB_TOL} (gamma "
        f"{err_g:.2e}, log Z {err_z:.2e} relative, log Z "
        f"{[round(float(x), 3) for x in lz]}); {scaled_ms:.2f} ms against "
        f"the twin's {literal_ms:.2f} ms, no autograd")
    del model, res, update
    shutil.rmtree(out, ignore_errors=True)
    return counts


def phase_smbr() -> dict:
    """``stage_smbr`` at full width, W = 2 on the int8 wire: 128
    gtc_compress launches; one update's wire bitwise against
    ``simulate_gtc_round`` on the plain gtc_compress; two updates that
    send, at an adaptive tau, held to the determinism rule; the update's
    time split; resume held to two uninterrupted runs."""
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core.ssl_pipeline import SSLPipeline
    from repro_torch.distributed import gtc
    from repro_torch.launch import train as launch_train
    from repro_torch.train import GTCShardMap, ListSink, Trainer, epoch_source
    from repro_torch.train.strategies import loss_and_grads
    out = ROOT / "build" / "chip_smoke_smbr"
    shutil.rmtree(out, ignore_errors=True)
    pc = launch_train.stage_config(True)
    w = pc.gtc_workers

    def run(where, log_fn=log, **kw):
        for src, name in (("chip_smoke_train", "ckpt_student_gtc"),
                          ("chip_smoke_baseline", "ckpt_baseline")):
            if not (out / where / name).exists():
                shutil.copytree(ROOT / "build" / src / name,
                                out / where / name)
        kw = {"ckpt_every": 0, **kw}
        return launch_train.stage_smbr(full=True, device="cuda", seed=SEED,
                                       gtc_workers=w, out=str(out / where),
                                       log=log_fn, **kw)

    launch_counts(reset=True)
    res = run("first")
    counts = launch_counts()
    r = res.results
    want = {"topk_logits": 0, "sparse_ce": 0, "gtc_compress": 4 * w * 16}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"smbr: launches {counts}, want {want}")
    if r["updates"] != 4 or r["start"] != "student_gtc" or not all(
            math.isfinite(x) for x in (r["eacc_first"], r["eacc_last"],
                                       r["val_fer"], r["baseline_fer"])) \
            or not all(0.0 <= d <= 1.0 for d in r["gtc_density"]):
        fail(f"smbr: {r}")
    st = res.state
    if not all(torch.isfinite(p).all() for p in st.params.values()):
        fail("smbr: non-finite parameters after the stage")
    log(f"smbr: {r['updates']} updates of {w} x {r['batch']} from "
        f"{r['start']} ({r['train_frames']:.0f} real frames) in "
        f"{r['train_s']:.3f} s = {r['frames_per_s']:.1f} real frames/s; eacc "
        f"{r['eacc_first']:.4e} -> {r['eacc_last']:.4e}; gtc_density "
        f"{r['gtc_density']}; val FER "
        f"{r['val_fer']:.4f} (baseline {r['baseline_fer']:.4f}, "
        f"{r['rel_fer_reduction_pct']}%); launches {counts}")

    # one update's wire on the card's gradients of the first W batches,
    # through the multi-worker step (a linear probe whose gradients are
    # those, bitwise), against the plain round on the same gradients:
    # at the stage's tau, and at the tau adaptive_tau gives for ~1% of
    # the largest leaf's values (sMBR gradients of a barely trained
    # model can stay under the stage's tau, and then nothing is sent)
    batches = res.batches[:w]
    t_grads = torch.cuda.Event(enable_timing=True)
    t_wire = torch.cuda.Event(enable_timing=True)
    t_grads.record()
    grads = [loss_and_grads(res.loss_fn, st.params, b)[2] for b in batches]
    t_wire.record()
    t_wire.synchronize()
    # one warm run (the stage ran these kernels): the update's gradients
    # are not computed again to time them
    grads_ms = t_grads.elapsed_time(t_wire)
    stacked = GTCShardMap(gtc.GTCConfig(n_workers=w)).stack(grads)
    res_w = st.strategy_state["residual"]
    big = max(grads[0], key=lambda n: grads[0][n].numel())
    taus = {"the stage's": launch_train.GTC_TAU,
            "adaptive_tau(1%)": float(gtc.adaptive_tau(
                res_w[big][0] + grads[0][big], 0.01))}

    def probe(params, c):
        return sum(torch.sum(params[n] * c[n]) for n in params), {}

    for what, tau in taus.items():
        cfg = gtc.GTCConfig(tau=tau, n_workers=w)
        step = gtc.make_sharded_gtc_train_step(
            probe, lambda p, u, o, *, lr: (u, o), cfg)
        before = launch_counts()["gtc_compress"]
        upd, _, new_state, _ = step(st.params, None, st.strategy_state,
                                    stacked, 0.0)
        torch.cuda.synchronize()
        if launch_counts()["gtc_compress"] - before != w * len(st.params):
            fail("smbr: the wire check did not run the gtc_compress kernel")
        ref_upd, ref_res = gtc.simulate_gtc_round(
            grads, [{n: x[i] for n, x in res_w.items()} for i in range(w)],
            tau, quantize_int8=True)
        for n in ref_upd:
            if not same_bits(upd[n], ref_upd[n]) or not all(
                    same_bits(new_state["residual"][n][i], ref_res[i][n])
                    for i in range(w)):
                fail(f"smbr: the card's wire differs from "
                     f"simulate_gtc_round (plain gtc_compress) at {n}, "
                     f"tau {tau}")
        sent = sum(int((u != 0).sum()) for u in upd.values())
        log(f"smbr: one update's applied update and both workers' "
            f"residuals at {what} tau {tau:.4e} == simulate_gtc_round on "
            f"the plain gtc_compress bitwise, all {len(ref_upd)} leaves "
            f"({sent} values sent, density "
            f"{float(gtc.density(upd, tau)):.4e})")

    # the stage's strategy where its wire sends: two sMBR updates of the
    # student under GTCShardMap at the adaptive tau, from the stage's
    # params, with the momentum optimizer applying the averaged update;
    # three runs held to the determinism rule
    atau = taus["adaptive_tau(1%)"]
    n_values = sum(p.numel() for p in st.params.values())

    def sending():
        sink = ListSink()
        tr = Trainer(GTCShardMap(gtc.GTCConfig(tau=atau, n_workers=w),
                                 clip=0.0), {"smbr": res.loss_fn},
                     metrics=sink)
        s = tr.fit(tr.init_state(st.params, seed=SEED),
                   epoch_source(lambda ep: res.batches[:2 * w], 1,
                                pc.smbr_lr, "smbr"))
        dens = sink.values("gtc_density")
        if s.step != 2 or len(dens) != 2 or not all(d > 0 for d in dens):
            fail(f"smbr: the adaptive-tau updates: step {s.step}, "
                 f"gtc_density {dens}")
        return host_state(s), dens

    t0 = time.perf_counter()
    (a, dens), (b, _), (c, _) = sending(), sending(), sending()
    sending_s = (time.perf_counter() - t0) / 3
    moved = max(float((a["params"][n] - st.params[n].cpu()).abs().max())
                for n in a["params"])
    mom = max(float(x.abs().max()) for _, x in _leaves(a["opt"]))
    if not (moved > 0 and mom > 0):
        fail(f"smbr: the adaptive-tau updates moved the params by {moved}, "
             f"momentum {mom}")
    rule = hold_to_rule("smbr at the adaptive tau", [a, b], c)
    log(f"smbr: 2 updates of GTCShardMap(tau {atau:.4e}, W = {w}, clip 0) "
        f"from the stage's params in {sending_s:.2f} s a run: gtc_density "
        f"{[f'{d:.4e}' for d in dens]} = "
        f"{[round(d * n_values) for d in dens]} of {n_values} values sent "
        f"(nonzero in the averaged update); params moved by up to "
        f"{moved:.3e}, momentum up to {mom:.3e}; {rule}")
    cfg = gtc.GTCConfig(tau=launch_train.GTC_TAU, n_workers=w)

    # one update's wall time: the workers' gradients, then the wire
    allreduce = gtc.make_gtc_allreduce(cfg)
    wire_ms = time_ms(lambda: allreduce(stacked, st.strategy_state), runs=3,
                      warmup=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss_and_grads(res.loss_fn, st.params, batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    RUNS["smbr_wire_ms"] = wire_ms
    log(f"smbr: an update's {w} workers' gradients {grads_ms:.1f} ms (one "
        f"warm run, the wire check's), the wire (compression, int8 pack, "
        f"sum, unpack) {wire_ms:.2f} ms = "
        f"{wire_ms / (grads_ms + wire_ms):.2%}; one worker's sMBR gradients "
        f"of {r['batch']}: peak device memory {peak / 2**30:.3f} GiB "
        f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
        f"held before)")
    log("smbr: one update of the stage's strategy on its first batches, "
        "traced:")
    update = GTCShardMap(cfg, clip=0.0).make_update(res.loss_fn)
    traced("smbr", lambda: update(st, GTCShardMap(cfg).stack(batches),
                                  pc.smbr_lr))
    del grads, stacked, upd, new_state, ref_upd, ref_res, update

    # the determinism rule: the stage again, then killed after update 2
    # (checkpointing every 2) and re-invoked
    refs = [host_state(st), host_state(run("again", lambda _m: None).state)]
    RUNS["smbr"] = refs
    RUNS["smbr_frames_per_s"] = r["frames_per_s"]
    RUNS["smbr_counts"] = counts
    keep = CLUSTER_IN / "smbr"
    shutil.rmtree(keep, ignore_errors=True)
    for name in ("ckpt_student_gtc", "ckpt_baseline"):
        shutil.copytree(out / "first" / name, keep / name)
    real = SSLPipeline._smbr_source
    SSLPipeline._smbr_source = _killed_after(2 * w, real)
    try:
        run("killed", lambda _m: None, ckpt_every=2)
    except RuntimeError as e:
        if "killed" not in str(e):
            raise
    else:
        fail("smbr: the stage was not killed")
    finally:
        SSLPipeline._smbr_source = real
    store = CheckpointStore(str(out / "killed" / "ckpt_smbr" / "state"))
    if store.latest() != 2 or store.load_meta(2).get("n_workers") != w:
        fail(f"smbr: latest checkpoint {store.latest()}, want 2 at W = {w}")
    t0 = time.perf_counter()
    again = run("killed", lambda _m: None, ckpt_every=2)
    ra = again.results
    if (ra["resumed_at"], ra["updates_run"]) != (2, 2) \
            or store.latest() is not None:
        fail(f"smbr: resumed at {ra['resumed_at']}, {ra['updates_run']} "
             f"updates run, checkpoints left {store.steps()}")
    rule = hold_to_rule("resumed smbr", refs, host_state(again.state))
    log(f"smbr: killed after update 2 and re-invoked: {ra['updates_run']} "
        f"more updates in {time.perf_counter() - t0:.2f} s; {rule}")
    del res, again
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(ROOT / "build" / "chip_smoke_baseline", ignore_errors=True)
    return counts


PIPELINE_STAGES = ("baseline", "teacher", "targets", "student", "smbr")
PIPELINE_KEPT = ("ckpt_baseline", "ckpt_teacher", "logit_store",
                 "gen_ledger.json", "ckpt_student_bmuf", "ckpt_smbr")
# the reference at PipelineConfig.tiny on the CPU (ROADMAP, Queue 1 step
# 7): the students' rel_fer_reduction_pct and the teacher's val FER
REF_TINY = {"gtc": 1.36, "bmuf": 8.16, "teacher_fer": 1.0}
PIPE_HOST_REL = 1e-5               # card vs host per-update losses of the
                                   # tiny GTC student stage: 50x the 2.0e-7
                                   # measured over its 62 updates on an
                                   # H100 (PERF.md), where gtc_density
                                   # differed by up to 3.1e-5 (two of
                                   # 65,088 sends flipped at tau)


def phase_pipeline() -> dict:
    """``SSLPipeline(PipelineConfig.tiny(), student_trainer="gtc")
    .run("all")`` on the card, then the BMUF student and its sMBR on the
    same baseline, teacher and targets: every stage completes, the store
    verifies with the reference's 40 shards and 10,240 frames, each
    kernel launched on its stages only and as often as the stage's data
    says; the card's targets and GTC student stage against the host's
    from the same checkpoints and store."""
    import numpy as np
    from repro_torch.core.ssl_pipeline import (PipelineConfig, SSLPipeline,
                                               load_params)
    from repro_torch.store import LogitStoreV2
    out = ROOT / "build" / "chip_smoke_pipeline"
    shutil.rmtree(out, ignore_errors=True)
    pc = PipelineConfig.tiny()
    total = dict.fromkeys(KERNELS, 0)
    by_stage = {}

    def counted(pipe, arm):
        """``pipe`` with each stage's launch counts set to 0 just before
        it and read just after, into ``by_stage`` and ``total``."""
        for name in PIPELINE_STAGES:
            def stage(real=getattr(pipe, f"stage_{name}"), name=name):
                launch_counts(reset=True)
                res = real()
                counts = launch_counts()
                by_stage[f"{arm} {name}"] = {k: v for k, v in counts.items()
                                             if v}
                for k, v in counts.items():
                    total[k] += v
                return res
            setattr(pipe, f"stage_{name}", stage)
        return pipe

    card = out / "card"
    gtc = counted(SSLPipeline(pc, out_dir=str(card), student_trainer="gtc"),
                  "gtc")
    res = {"gtc": gtc.run("all")}
    bmuf = counted(SSLPipeline(pc, out_dir=str(card),
                               student_trainer="bmuf"), "bmuf")
    res["bmuf"] = {s: bmuf.run(s) for s in ("student", "smbr")}

    # every stage completed with finite numbers; the store is the
    # reference's (the corpus is bitwise)
    targets = res["gtc"]["targets"]
    store = LogitStoreV2(str(card / "logit_store"))
    if (targets["n_shards"], targets["n_frames"]) != (40, 10240) \
            or store.verify() != 40:
        fail(f"pipeline: targets {targets}, {len(store.shards())} shards")
    for arm, stages in res.items():
        for name, r in stages.items():
            for key, x in r.items():
                if isinstance(x, float) and not math.isfinite(x):
                    fail(f"pipeline: {arm} {name} {key} = {x}")
            if "val_fer" in r and not 0 <= r["val_fer"] <= 1:
                fail(f"pipeline: {arm} {name} val FER {r['val_fer']}")
    if not res["gtc"]["student"]["n_steps"] or \
            not res["bmuf"]["student"]["n_steps"]:
        fail(f"pipeline: a student took no update: "
             f"{res['gtc']['student']}, {res['bmuf']['student']}")

    # the launches each stage's data asks for: one topk_logits a batch of
    # targets; two sparse_ce a distill microbatch (per_sub shards a
    # sub-epoch; BMUF drops the partial group of each); gtc_compress on
    # every leaf of every update (and worker, for sMBR); none elsewhere
    n_leaves = len(student_leaf_shapes(gtc.student_cfg))
    per_sub = targets["n_shards"] // pc.n_sub_epochs
    group = pc.bmuf_workers * pc.bmuf_block_steps
    n_full = len(gtc._batches(gtc.rng_labeled, chunked=False))
    smbr_updates = pc.smbr_epochs * (n_full // pc.gtc_workers)
    smbr = {"gtc_compress": n_leaves * pc.gtc_workers * smbr_updates}
    want = {"gtc baseline": {}, "gtc teacher": {},
            "gtc targets": {"topk_logits": targets["n_shards"]},
            "gtc student": {"sparse_ce": 2 * per_sub * pc.n_sub_epochs,
                            "gtc_compress": n_leaves
                            * res["gtc"]["student"]["n_steps"]},
            "gtc smbr": smbr,
            "bmuf student": {"sparse_ce": 2 * (per_sub // group) * group
                             * pc.n_sub_epochs},
            "bmuf smbr": smbr}
    if by_stage != want:
        fail(f"pipeline: launches by stage {by_stage}, want {want}")
    # the BMUF arm's inputs and outputs, which phase_cluster (d)'s ranks
    # are held to (the BMUF arm's sMBR wrote ckpt_smbr last)
    keep = CLUSTER_IN / "pipeline"
    shutil.rmtree(keep, ignore_errors=True)
    keep.mkdir(parents=True)
    for name in PIPELINE_KEPT:
        (shutil.copytree if (card / name).is_dir() else shutil.copy)(
            card / name, keep / name)
    RUNS["pipeline"] = {"by_stage": by_stage, "res": res,
                        "stats": {"gtc": dict(gtc.stats),
                                  "bmuf": dict(bmuf.stats)}}

    def stats(pipe, stage):
        st = pipe.stats[stage]
        return (f"{st['seconds']:.2f} s ({st['frames']:.0f} real frames in "
                f"{st['fit_s']:.2f} s = {st['frames'] / st['fit_s']:.1f} "
                f"frames/s)")
    for arm, pipe, names in (("gtc", gtc, PIPELINE_STAGES),
                             ("bmuf", bmuf, ("student", "smbr"))):
        for name in names:
            key = f"student_{arm}" if name == "student" else name
            log(f"pipeline: {arm} {name}: {stats(pipe, key)}; launches "
                f"{by_stage[f'{arm} {name}']}; {res[arm][name]}")
    g, b = res["gtc"], res["bmuf"]

    def fer(r):
        return f"{r['val_fer']:.4f} ({r['rel_fer_reduction_pct']:+}%)"
    log(f"pipeline: val FER baseline {g['baseline']['val_fer']:.4f}, teacher "
        f"{g['teacher']['val_fer']:.4f} (reference at tiny: "
        f"{REF_TINY['teacher_fer']}); GTC student {fer(g['student'])} "
        f"(reference {REF_TINY['gtc']:+}%), sMBR {fer(g['smbr'])}; BMUF "
        f"student {fer(b['student'])} (reference {REF_TINY['bmuf']:+}%), "
        f"sMBR {fer(b['smbr'])}; the store 40 shards, 10,240 frames, "
        f"verified")

    # the card's targets against the host's from the same teacher
    host = out / "host_targets"
    shutil.copytree(card / "ckpt_teacher", host / "ckpt_teacher")
    hpipe = SSLPipeline(pc, out_dir=str(host), device="cpu")
    hpipe.stage_targets()
    hstore = LogitStoreV2(str(host / "logit_store"))
    tparams = load_params(hpipe.teacher_cfg, str(card / "ckpt_teacher"),
                          "cpu")
    batches = hpipe._batches(hpipe.rng_unlabeled, chunked=True, seed=7)
    worst, rows = 0.0, 0
    for j in store.shards():
        (cv, ci), (hv, hi) = store.read_shard(j), hstore.read_shard(j)
        for r, t in enumerate(batches[j]["mask"].sum(-1).astype(int)):
            if t:
                worst = max(worst, check_emissions(
                    np.asarray(cv[r, :t], np.float32), np.asarray(ci[r, :t]),
                    np.asarray(hv[r, :t], np.float32), np.asarray(hi[r, :t]),
                    _host_logits(hpipe.teacher_cfg, tparams,
                                 batches[j]["feats"][r, :t]),
                    pc.topk, f"pipeline targets shard {j} row {r}"))
                rows += 1
    log(f"pipeline: the card's targets == the host's on {rows} rows of 40 "
        f"shards (ids away from near-ties, values within one bf16 ulp; "
        f"worst {worst:.3f} ulp)")

    # the card's GTC student stage against the host's, from the same
    # baseline and store: the per-update losses (sparse_ce and
    # gtc_compress inside a real stage)
    host = out / "host_student"
    for name in ("ckpt_baseline", "logit_store"):
        shutil.copytree(card / name, host / name)
    hpipe = SSLPipeline(pc, out_dir=str(host), student_trainer="gtc",
                        device="cpu")
    hres = hpipe.stage_student()
    cl = np.array(gtc.fits["student_gtc"].sink.values("loss"))
    hl = np.array(hpipe.fits["student_gtc"].sink.values("loss"))
    cd = np.array(gtc.fits["student_gtc"].sink.values("gtc_density"))
    hd = np.array(hpipe.fits["student_gtc"].sink.values("gtc_density"))
    if cl.shape != hl.shape:
        fail(f"pipeline: {len(cl)} card updates against {len(hl)} host ones")
    rel = np.abs(cl - hl) / np.abs(hl)
    log(f"pipeline: GTC student card vs host ({len(cl)} updates): loss "
        f"relative difference max {rel.max():.3e} (first {rel[0]:.3e}, last "
        f"{rel[-1]:.3e}; limit {PIPE_HOST_REL}); gtc_density max difference "
        f"{np.abs(cd - hd).max():.3e}; host val FER {hres['val_fer']:.4f} "
        f"against the card's {g['student']['val_fer']:.4f}; host stage "
        f"{stats(hpipe, 'student_gtc')}")
    if not rel.max() <= PIPE_HOST_REL:
        fail(f"pipeline: card vs host losses beyond {PIPE_HOST_REL}: "
             f"{rel.tolist()}")
    # the card's baseline and teacher stay for phase_waves
    for name in ("host_targets", "host_student"):
        shutil.rmtree(out / name, ignore_errors=True)
    return total


# ------------------------------------------------ the elastic runtime

GEN_PROCS = 3                      # phase_gen_procs: worker processes
ELASTIC_TAU_DENSITY = 0.01         # phase_elastic: GTC's tau keeps ~1% of
                                   # the first gradient's values


def worker_launches(reports) -> dict:
    """{kernel: launches} summed over worker exit reports."""
    return {k: sum(r["launches"][k] for r in reports) for k in KERNELS}


def check_worker_reports(reports, what: str, n_written: int):
    """Every worker report of a pass on the card: no error, no jax or
    reference import; a worker that wrote shards ran on this card; the
    shards and the ``topk_logits`` launches cover the pass."""
    import torch
    name = torch.cuda.get_device_name(0)
    for r in reports:
        if r.get("error") or r["foreign_modules"]:
            fail(f"{what}: worker {r['worker']} (pid {r['pid']}): "
                 f"{r.get('error') or r['foreign_modules']}")
        if r["n_written"] and (not str(r["device"]).startswith("cuda")
                               or r["device_name"] != name):
            fail(f"{what}: worker {r['worker']} wrote {r['n_written']} "
                 f"shards on {r['device']} ({r['device_name']}), not {name}")
        if not r["n_written"] and r["device"] is not None:
            fail(f"{what}: worker {r['worker']} built an engine on "
                 f"{r['device']} and wrote nothing")
    wrote = sum(r["n_written"] for r in reports)
    launched = worker_launches(reports)["topk_logits"]
    if wrote < n_written or launched < n_written:
        fail(f"{what}: the workers' reports write {wrote} shards with "
             f"{launched} topk_logits launches, want >= {n_written}")
    return wrote, launched


def phase_gen_procs() -> dict:
    """``generate_sharded(processes=3)`` at full width: the 5x768 biLSTM
    teacher's checkpoint, the targets phase's 12 ragged batches of
    16x512, worker 1 SIGKILLed after its 2nd shard, against the same
    batches from the same teacher in-process (the targets phase's
    store).  Every shard verified, the ledger done, a restart; the two
    stores equal; every worker on the card with its ``topk_logits``
    launches; real frames/s of both passes."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.pipeline import WorkLedger, generate_sharded
    from repro_torch.store import LogitStoreV2
    out = ROOT / "build" / "chip_smoke_gen_procs"
    shutil.rmtree(out, ignore_errors=True)
    cfg = get_arch("lstm-am-teacher")
    n, rows, frames = launch_train.TARGET_SIZES["full"]
    batches = launch_train.make_target_batches(cfg, n=n, rows=rows,
                                               frames=frames, seed=SEED)
    real = sum(int(b["mask"].sum()) for b in batches)
    teacher = build_model(cfg, device="cpu", generator=torch.Generator()
                          .manual_seed(SEED + 1))
    CheckpointStore(str(out / "ckpt_teacher")).save(0, teacher.state_dict())
    spec = "repro_torch.runtime.workers:teacher_engine"
    kw = {"ckpt_dir": str(out / "ckpt_teacher"), "k": K, "device": "cuda"}

    launch_counts(reset=True)
    fleet = LogitStoreV2(str(out / "fleet"), k=K, vocab=cfg.n_senones)
    t0 = time.perf_counter()
    rep = generate_sharded(spec, batches, fleet, n_workers=GEN_PROCS,
                           processes=GEN_PROCS, engine_kwargs=kw,
                           crash={"worker": 1, "after_shards": 2},
                           supervisor_opts={"timeout_s": 600.0})
    fleet_s = time.perf_counter() - t0
    parent = launch_counts()
    if any(parent.values()):
        fail(f"gen_procs: the parent launched {parent}; the workers "
             "forward")
    if fleet.verify() != n or not WorkLedger.peek_all_done(
            str(out / "fleet" / "gen_ledger.json")) or rep["restarts"] < 1:
        fail(f"gen_procs: {len(fleet.shards())} shards, ledger done "
             f"{WorkLedger.peek_all_done(str(out / 'fleet' / 'gen_ledger.json'))}"
             f", {rep['restarts']} restarts")
    killed = [e for e in rep["events"] if e["event"] == "exit"
              and e["returncode"] == -9]
    if [e["worker"] for e in killed] != [1]:
        fail(f"gen_procs: SIGKILLed workers {killed}, want worker 1 once")
    wrote, launched = check_worker_reports(rep["workers"], "gen_procs", n)
    counts = worker_launches(rep["workers"])

    # the in-process pass of the same batches from the same teacher
    # (``lstm-am-teacher`` at seed + 1): phase_targets' store, written in
    # this process by stage_targets' 3 ledgered workers (killed at its 6th
    # forward and resumed: 12 verified wave-0 shards)
    inproc = LogitStoreV2(str(ROOT / "build" / "chip_smoke_targets"
                              / "logit_store"))
    rep0 = RUNS.pop("targets_pass")
    if inproc.verify() != n:
        fail(f"gen_procs: the targets phase's store holds "
             f"{inproc.verify()} shards, want {n}")

    # the two stores: the same kernel on the same card from the same
    # checkpoint -- bitwise, else ids away from near-ties and values
    # within one bf16 ulp against the teacher's logits on the card
    differ = [j for j in range(n) if not all(
        np.array_equal(a, b) for a, b in zip(fleet.read_shard(j),
                                             inproc.read_shard(j)))]
    if differ:
        model = build_model(cfg, device="cuda", params={
            k: v.cuda() for k, v in teacher.state_dict().items()})
        worst = 0.0
        for j in differ:
            (fv, fi), (iv, ii) = fleet.read_shard(j), inproc.read_shard(j)
            b = batches[j]
            lens = b["mask"].sum(-1).astype(int)
            with torch.no_grad():
                h, _ = model.apply(torch.from_numpy(b["feats"]).cuda(),
                                   lens=torch.from_numpy(lens).cuda())
                logits = model.unembed(h).float().cpu()
            for r, t in enumerate(lens):
                worst = max(worst, check_emissions(
                    np.asarray(fv[r, :t], np.float32), np.asarray(fi[r, :t]),
                    np.asarray(iv[r, :t], np.float32), np.asarray(ii[r, :t]),
                    logits[r, :t], K, f"gen_procs shard {j} row {r}"))
        equal = (f"{n - len(differ)} of {n} shards bitwise, the rest ids "
                 f"equal away from near-ties, values within one bf16 ulp "
                 f"(worst {worst:.3f} ulp)")
    else:
        equal = f"all {n} shards bitwise equal"
    fwd = sum(r["forward_s"] for r in rep["workers"])
    spawned = {e["owner"]: e["t"] for e in rep["events"]
               if e["event"] == "spawn"}
    life = [(r["t_loaded"] - spawned[r["owner"]], r["engine_s"],
             r["forward_s"], r["write_s"],
             r["t_exit"] - spawned[r["owner"]]) for r in rep["workers"]
            if r["n_written"]]
    log("gen_procs: the workers that wrote, each (seconds from spawn to its "
        "imports done, building the engine, forwards, store writes; spawn "
        "to exit): " + "; ".join(
            f"{a:.2f}, {b:.2f}, {c:.2f}, {d:.3f}; {e:.2f}"
            for a, b, c, d, e in life))
    log(f"gen_procs: {GEN_PROCS} worker processes, worker 1 SIGKILLed "
        f"after its 2nd shard: {rep['restarts']} restart(s), "
        f"{rep['reclaimed']} range(s) reclaimed, {rep['n_written']} of {n} "
        f"batches of {rows}x{frames} ({real} real frames) in "
        f"{fleet_s:.2f} s = {real / fleet_s:.1f} real frames/s (spawn, "
        f"torch import, CUDA context and weights in each process included; "
        f"{fwd:.2f} s in the workers' forwards); in-process (the targets "
        f"phase's resumed pass, {rep0['n_written']} of the batches) "
        f"{rep0['frames_per_s']:.1f} real frames/s (forwards "
        f"{rep0['forward_s']:.2f} s); {len(rep['workers'])} "
        f"worker reports, {wrote} shards written on the card with "
        f"{launched} topk_logits launches; the stores: {equal}")
    shutil.rmtree(out, ignore_errors=True)
    return counts


def phase_elastic() -> dict:
    """The elastic student at full width: BMUF (W = 4, tau = 2) for 6
    updates with lane3 killed after update 1 and revived after update
    3; the kill against a cross-W resume of a W = 4 checkpoint, bitwise;
    GTCShardMap resized W = 2 -> 1 -> 2 over 4 distill updates, the
    error mass kept."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_arch
    from repro_torch.distributed import gtc
    from repro_torch.distributed.bmuf import BMUFConfig
    from repro_torch.launch import steps
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.runtime.workers import LaneCrashPlan, TrainerMembership
    from repro_torch.store import LogitStoreV2
    from repro_torch.train import (BMUFVmap, GTCShardMap, Trainer, TrainState,
                                   distill_shard_source)
    from repro_torch.train.strategies import loss_and_grads
    out = ROOT / "build" / "chip_smoke_elastic"
    shutil.rmtree(out, ignore_errors=True)
    cfg = get_arch("lstm-am-7khr")
    rows, frames, per_sub, _ = launch_train.SIZES["bmuf"]["full"]
    unl, _ = launch_train.make_batches(cfg, rows=rows, frames=frames,
                                       n_unlabeled=per_sub, n_labeled=0,
                                       seed=SEED)
    launch_train.generate_targets(launch_train._teacher_cfg(True), unl,
                                  device="cuda", seed=SEED, workers=1,
                                  out=str(out))
    store = LogitStoreV2(str(out / "logit_store"))
    student = build_model(cfg, device="cuda",
                          generator=torch.Generator().manual_seed(SEED))
    params = dict(student.state_dict())
    loss = {"distill_topk": steps.make_loss_fn(student, cfg, "distill_topk")}

    def passes(n_passes):
        for _ in range(n_passes):
            yield from distill_shard_source(unl, store, 0, len(unl), 0.05,
                                            pin_wave=True)

    def bmuf(w, **kw):
        return Trainer(BMUFVmap(BMUFConfig(n_workers=w, block_steps=2)),
                       loss, **kw)

    def roster(name):
        m = TrainerMembership(str(out / name / "members.json"),
                              timeout_s=30.0)
        for i in range(4):
            m.join(f"lane{i}")
        return m

    # 1. kill lane3 after update 1, revive it after update 3
    launch_counts(reset=True)
    tr = bmuf(4)
    plan = LaneCrashPlan(roster("run"), kills={1: "lane3"},
                         revives={3: "lane3"})
    t0 = time.perf_counter()
    st = tr.fit(tr.init_state(params, seed=SEED), passes(4), resume=False,
                max_updates=6, membership=plan)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    lane_steps = 2 * (4 + 3 + 3 + 4 + 4 + 4)
    if (st.step, tr.resize_stats["count"], tr.strategy.n_workers) != \
            (6, 2, 4) or [e["event"] for e in plan.log] != ["kill",
                                                             "revive"]:
        fail(f"elastic: {st.step} updates, {tr.resize_stats['count']} "
             f"resizes, final W {tr.strategy.n_workers}, events {plan.log}")
    if counts["sparse_ce"] != 2 * lane_steps:
        fail(f"elastic: {counts['sparse_ce']} sparse_ce launches, want "
             f"{2 * lane_steps} (2 a distill lane-step)")
    if not all(torch.isfinite(p).all() for p in st.params.values()):
        fail("elastic: non-finite parameters")
    resize_ms = tr.resize_stats["seconds"] / 2 * 1e3
    log(f"elastic: BMUF W = 4 -> 3 -> 4 (lane3 killed after update 1, "
        f"revived after update 3): 6 updates, {lane_steps} lane-steps of "
        f"{rows}x{frames} in {run_s:.2f} s; 2 resizes, {resize_ms:.2f} ms "
        f"each on average (lanes and their momentum re-stacked, updates "
        f"rebuilt); launches {counts}")

    # 2. the kill against a cross-W resume: bitwise
    ck = str(out / "ck")
    tr_a = bmuf(4, checkpoint=CheckpointStore(ck), ckpt_every=2)
    s_a = tr_a.fit(tr_a.init_state(params, seed=SEED), passes(1),
                   resume=False)
    tr_a.ckpt_every = 0
    s_a = tr_a.fit(s_a, passes(1), resume=False, max_updates=2,
                   membership=LaneCrashPlan(roster("pin"),
                                            kills={0: "lane3"}))
    tr_b = bmuf(3, checkpoint=CheckpointStore(ck))
    t0 = time.perf_counter()
    s_b = tr_b.fit(tr_b.init_state(params, seed=SEED), passes(2),
                   max_updates=2)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    same = all(torch.equal(s_a.params[k], s_b.params[k])
               for k in s_a.params) and all(
        torch.equal(s_a.strategy_state["workers"][k],
                    s_b.strategy_state["workers"][k])
        for k in s_a.strategy_state["workers"])
    if (s_a.step, s_b.step, tr_b.resize_stats["count"]) != (4, 4, 1) \
            or not same:
        fail(f"elastic: kill vs cross-W resume: steps {s_a.step} / "
             f"{s_b.step}, resume resizes {tr_b.resize_stats['count']}, "
             f"bitwise {same}")
    ckpt_mb = sum(f.stat().st_size for f in Path(ck).glob("*.npz")) / 1e6
    log(f"elastic: killed at W = 4 -> 3 after update 2 == a fresh W = 3 "
        f"trainer resuming the W = 4 checkpoint ({ckpt_mb:.1f} MB; loaded, "
        f"resized and 2 updates in {resume_s:.2f} s): params and lanes "
        f"bitwise at update 4")

    # 3. GTCShardMap W = 2 -> 1 -> 2: sends + residuals == gradients
    phases = (2, 1, 2, 2)
    _, _, g0 = loss_and_grads(loss["distill_topk"], params,
                              next(passes(1)).data)
    tau = float(gtc.adaptive_tau(torch.cat([g.reshape(-1)
                                            for g in g0.values()]),
                                 ELASTIC_TAU_DENSITY))
    del g0
    strat = GTCShardMap(gtc.GTCConfig(tau=tau, n_workers=phases[0]),
                        clip=0.0)
    gstate = strat.init_state(params)
    grads, sent, mag = ({n: torch.zeros(p.shape, dtype=torch.float64,
                                        device="cuda")
                           for n, p in params.items()} for _ in range(3))

    def record(g):
        for n, x in g.items():
            grads[n] += x.double()
            mag[n] += x.double().abs()
        return g, {}

    feed = passes(1)
    roundings, n_sent = 0, 0
    before = launch_counts()["gtc_compress"]
    for w in phases:
        if w != strat.n_workers:
            old = strat.n_workers
            gstate = strat.resize(TrainState(params, None, gstate, 0, SEED),
                                  w).strategy_state
            roundings += max(0, old - w)
        step = gtc.make_sharded_gtc_train_step(
            loss["distill_topk"], lambda p, u, o, lr: (u, o), strat.cfg,
            grad_transform=record)
        upd, _, gstate, _ = step(params, None, gstate,
                                 strat.stack([next(feed).data
                                              for _ in range(w)]), 0.05)
        for n, u in upd.items():
            sent[n] += w * u.double()
            mag[n] += (w * u.double()).abs()
            n_sent += int((u != 0).sum())
        roundings += 2 * w + 1
    gtc_launches = launch_counts()["gtc_compress"] - before
    counts = launch_counts()
    worst = 0.0
    for n, r in gstate["residual"].items():
        res = r.double().sum(0)
        m = mag[n] + res.abs()
        ulp = torch.from_numpy(np.spacing(m.float().cpu().numpy())).to(
            m.device).double()
        err = (sent[n] + res - grads[n]).abs()
        worst = max(worst, float((err / ulp).max()))
    if not worst <= roundings * 0.5 or n_sent == 0:
        fail(f"elastic: GTC error mass off by {worst:.2f} ulp of the run's "
             f"magnitudes (limit {roundings * 0.5}), {n_sent} values sent")
    n_leaves = len(params)
    if gtc_launches != n_leaves * sum(phases):
        fail(f"elastic: {gtc_launches} gtc_compress launches, want "
             f"{n_leaves * sum(phases)}")
    log(f"elastic: GTCShardMap W = 2 -> 1 -> 2 over 4 distill updates at "
        f"tau {tau:.3e} (adaptive, {ELASTIC_TAU_DENSITY:.0%} of the first "
        f"gradient): {n_sent} values sent; sends + final residuals == the "
        f"sum of the gradients within {worst:.2f} ulp of the run's "
        f"magnitudes (limit {roundings * 0.5}: half an ulp a rounding); "
        f"{gtc_launches} gtc_compress launches")
    shutil.rmtree(out, ignore_errors=True)
    return counts


def phase_waves() -> dict:
    """``SSLPipeline.run_waves(2, kill_at=1, revive_after=2)`` at
    ``PipelineConfig.tiny()`` (BMUF W = 4, tau = 2) with the targets in 2
    worker processes a wave, from phase_pipeline's baseline and teacher
    (copied into a fresh out dir, so the waves are 0 and 1): the
    reference's report counts, a clean manifest and ledger, the workers
    on the card.  A wiring check, as phase_pipeline.  Keeps its inputs
    (``CLUSTER_IN / "waves"``), its out dir and its report
    (``RUNS["waves"]``) for phase_cluster (e), which removes them."""
    from repro_torch.core.ssl_pipeline import PipelineConfig, SSLPipeline
    src = ROOT / "build" / "chip_smoke_pipeline" / "card"
    out = WAVES_OUT
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(CLUSTER_IN / "waves", ignore_errors=True)
    for name in ("ckpt_baseline", "ckpt_teacher"):
        if not (src / name).is_dir():
            fail(f"waves: phase_pipeline left no {src / name}")
        shutil.copytree(src / name, out / name)
        shutil.copytree(src / name, CLUSTER_IN / "waves" / name)
    shutil.rmtree(src.parent, ignore_errors=True)
    pc = dataclasses.replace(PipelineConfig.tiny(), bmuf_workers=4,
                             bmuf_block_steps=2, gen_procs=2)
    pipe = SSLPipeline(pc, out_dir=str(out), student_trainer="bmuf",
                       supervisor_opts={"timeout_s": 600.0})
    launch_counts(reset=True)
    t0 = time.perf_counter()
    rep = pipe.run_waves(2, kill_at=1, revive_after=2)
    waves_s = time.perf_counter() - t0
    counts = launch_counts()
    got = (rep["n_waves"], rep["resize_count"], rep["restarts_absorbed"],
           [wv["wave"] for wv in rep["waves"]],
           [wv["student"]["final_workers"] for wv in rep["waves"]],
           rep["manifest_clean"], rep["ledger_clean"])
    if got != (2, 4, 2, [0, 1], [4, 4], True, True):
        fail(f"waves: (n_waves, resize_count, restarts_absorbed, waves, "
             f"final_workers, manifest_clean, ledger_clean) = {got}")
    reports = [r for wv in rep["waves"] for r in wv["gen"]["workers"]]
    n_shards = sum(wv["gen"]["n_shards"] for wv in rep["waves"])
    check_worker_reports(reports, "waves", n_shards)
    if counts["topk_logits"] or counts["gtc_compress"] \
            or not counts["sparse_ce"]:
        fail(f"waves: the parent launched {counts}; want sparse_ce only "
             "(the workers forward the targets)")
    counts["topk_logits"] = worker_launches(reports)["topk_logits"]
    for i, wv in enumerate(rep["waves"]):
        s, g = wv["student"], wv["gen"]
        log(f"waves: wave {i}: targets wave {wv['wave']} by "
            f"{g['processes']} processes ({g['restarts']} restarts, "
            f"{g['n_steals']} steals); student {s['n_steps']} updates, {s['resizes']['count']} "
            f"resizes ({s['resizes']['seconds'] * 1e3:.2f} ms), final W "
            f"{s['final_workers']}, val FER {s['val_fer']:.4f}; "
            f"chaos {s['chaos']}")
    log(f"waves: 2 waves in {waves_s:.2f} s: {rep['restarts_absorbed']} "
        f"lane deaths absorbed by {rep['resize_count']} resizes "
        f"({rep['resize_seconds']} s), {rep['n_verified']} shards verified, "
        f"{rep['gc_removed']} superseded files collected; launches "
        f"{counts} (topk_logits from the {len(reports)} worker reports)")
    RUNS["waves"] = {"report": rep, "counts": dict(counts),
                     "seconds": waves_s,
                     "stats": {k: dict(v) for k, v in pipe.stats.items()}}
    return counts


CLUSTER_IN = ROOT / "build" / "chip_smoke_cluster_in"   # phase_smbr's,
                                   # phase_bmuf's and phase_waves's inputs,
                                   # kept for the ranks
WAVES_OUT = ROOT / "build" / "chip_smoke_waves"    # phase_waves's out dir,
                                   # kept for phase_cluster (e)
RANK_TIMEOUT_S = 300.0             # phase_cluster: a rank's hard limit
BMUF_BLOCK_REL = 2e-6              # BMUF across ranks vs BMUFVmap: each
                                   # leaf within this share of its size per
                                   # block (~16 float32 ulps: the sync's
                                   # sum regrouped, then trained on; delta
                                   # against theta_g's size, as a step of
                                   # the parameters)
WAVES_VALS_TOL = 1e-2              # (e): wave 1's stored targets (float16,
                                   # max-shifted) against phase_waves's,
                                   # within this share of max(1, |value|).
                                   # Sound readings: 7.463e-03 on an H100,
                                   # 3.906e-03 on the host (tests/
                                   # test_torch_cluster_waves.py).  The
                                   # fault it catches: wave 1 generated by
                                   # the wrong student (wave 0's before its
                                   # training) reads 0.939 on the host
WAVES_NEAR_TIES = 0.01             # (e): at most this share of wave 1's
                                   # ids may differ, each at a near-tie
PIPE_SMBR_SHARE = 0.25             # (d): the sMBR stage's own update
                                   # (its checkpoint less the BMUF student
                                   # it starts from) within this share of
                                   # the in-process update's largest
                                   # element: an sMBR that did not run, or
                                   # lost a rank's lanes or the all-reduce,
                                   # is off by about the whole update


def run_ranks(args, world: int, backend: str, out: Path) -> tuple:
    """``python -m repro_torch.launch.train --cluster 127.0.0.1:<port>,
    world,i`` plus ``args`` for each rank i, started together with
    ``REPRO_DIST_BACKEND=backend``; each rank's output in
    ``out/rank<i>.log``.  A rank that fails, or outlives
    RANK_TIMEOUT_S, kills the others and fails the phase.  -> (the
    ranks' reports, each rank's spawn time, the wall seconds)."""
    import socket

    from repro_torch.runtime.procs import child_env
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = child_env({"REPRO_DIST_BACKEND": backend})
    out.mkdir(parents=True, exist_ok=True)
    procs, spawned, files = [], [], []
    t0 = time.perf_counter()
    try:
        for i in range(world):
            f = open(out / f"rank{i}.log", "w")
            files.append(f)
            spawned.append(time.time())
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train",
                 "--cluster", f"127.0.0.1:{port},{world},{i}", *args],
                cwd=str(ROOT), env=env, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    wall = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    if any(codes):
        for i in range(world):
            tail = (out / f"rank{i}.log").read_text()[-3000:]
            print(f"[chip_smoke] rank {i} (exit {codes[i]}):\n{tail}",
                  file=sys.stderr)
        fail(f"cluster: ranks of {args} exited {codes}")
    reports = [json.loads((out / "_ranks" / f"rank{i}.json").read_text())
               for i in range(world)]
    return reports, spawned, wall


def rank_launches(reports) -> dict:
    """{kernel: launches} summed over the ranks' reports."""
    return {k: sum(r["launches"][k] for r in reports) for k in KERNELS}


def check_ranks(reports, what: str, world: int, backend: str):
    """Every rank on this card, in the fleet it was started in, without
    a jax or reference import."""
    import torch
    name = torch.cuda.get_device_name(0)
    for i, r in enumerate(reports):
        if (r["rank"], r["world"], r["backend"]) != (i, world, backend) \
                or not str(r["device"]).startswith("cuda") \
                or r["device_name"] != name or r["foreign_modules"]:
            fail(f"cluster {what}: rank {i} reports rank {r['rank']} of "
                 f"{r['world']} ({r['backend']}) on {r['device']} "
                 f"({r['device_name']}), foreign {r['foreign_modules']}")


def ranks_state(out: Path) -> dict:
    """Rank 0's gathered final TrainState as ``host_state`` lays it out."""
    import torch
    d = torch.load(out / "_ranks" / "state.pt")
    return {"params": d["params"], "opt": d["opt"], "strategy":
            d["strategy"], "step": int(d["step"])}


def bmuf_gap(a: dict, b: dict) -> float:
    """The largest leaf difference of two BMUF host states, relative to
    the leaf's size; delta's against theta_g's leaf (a step of the
    parameters: its own magnitude is a difference of two of them)."""
    if a["step"] != b["step"]:
        fail(f"states at different steps: {a['step']} vs {b['step']}")
    worst = 0.0
    for n, x in _leaves(a):
        y = dict(_leaves(b))[n]
        ref = y
        if n.startswith("strategy/delta/"):
            ref = b["params"][n[len("strategy/delta/"):]]
        d = float((x.double() - y.double()).abs().max())
        worst = max(worst, d / max(float(ref.double().abs().max()), 1e-30))
    return worst


def phase_cluster() -> dict:
    """The paper's two trainers across OS processes on this card: (a) the
    sMBR stage in 2 gloo ranks (one lane each) from phase_smbr's inputs,
    bitwise to its in-process run; (c) one NCCL rank at world 1 holding
    both lanes, bitwise to (a); (b) the BMUF student in 2 gloo ranks
    (W = 4, 2 lanes a rank, tau = 2) on phase_bmuf's targets, within
    BMUF_BLOCK_REL a block of its BMUFVmap run; (d) the tiny pipeline's
    ``--stage all`` in 2 gloo ranks against phase_pipeline's BMUF arm
    (``cluster_pipeline``).  The ranks' launches add up to the
    in-process runs'; (e) ``run_waves(2)`` in 2 gloo ranks, one
    generation process a rank, against phase_waves's run
    (``cluster_waves``)."""
    import torch
    out = ROOT / "build" / "chip_smoke_cluster"
    shutil.rmtree(out, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    counts = {k: 0 for k in KERNELS}
    states = {}
    smbr_args = ["--full", "--stage", "smbr", "--gtc-workers", "2"]
    for what, world, backend in (("a", 2, "gloo"), ("c", 1, "nccl")):
        where = out / f"smbr_{what}"
        for name in ("ckpt_student_gtc", "ckpt_baseline"):
            shutil.copytree(CLUSTER_IN / "smbr" / name, where / name)
        reps, spawned, wall = run_ranks(smbr_args + ["--out", str(where)],
                                        world, backend, where)
        check_ranks(reps, f"smbr ({what})", world, backend)
        states[what] = ranks_state(where)
        launched = rank_launches(reps)
        for k in KERNELS:
            counts[k] += launched[k]
        if launched != RUNS["smbr_counts"]:
            fail(f"cluster smbr ({what}): the ranks launched {launched}, "
                 f"the in-process run {RUNS['smbr_counts']}")
        res = json.loads((where / "train_smbr.json").read_text())
        if what == "a":
            rule = hold_to_rule("cluster smbr (a)", RUNS["smbr"],
                                states["a"])
        elif state_diff(states["a"], states["c"]) != 0.0:
            fail(f"cluster smbr (c): NCCL at world 1 differs from (a) by "
                 f"{state_diff(states['a'], states['c']):.3e}")
        else:
            rule = "bitwise equal to (a)"
        for r in reps:
            sp = r["split"]
            log(f"cluster smbr ({what}): rank {r['rank']}/{world} "
                f"({backend}, lanes {r['lanes']}) on {r['device']}: start-up "
                f"{r['t_main'] - spawned[r['rank']]:.2f} s to the launcher's "
                f"main, {r['t_initialized'] - spawned[r['rank']]:.2f} s to "
                f"the process group, {r['t_done'] - spawned[r['rank']]:.2f} s "
                f"to the stage's end; an update's wall (events / host ms): "
                + ", ".join(f"{k} {sp[k]['event_ms']:.2f} / "
                            f"{sp[k]['host_ms']:.2f}"
                            for k in ("grads", "pack", "all_reduce",
                                      "unpack"))
                + f"; {sp['wire_bytes']} wire bytes a rank; describe: "
                f"torch {r['describe']['torch_version']}, "
                f"{r['describe']['nvidia_smi']}")
        log(f"cluster smbr ({what}): {world} {backend} rank(s), "
            f"{res['updates']} updates, {res['train_frames']:.0f} real "
            f"frames in {res['train_s']:.3f} s = {res['frames_per_s']:.1f} "
            f"real frames/s (in-process {RUNS['smbr_frames_per_s']:.1f}; "
            f"the in-process wire {RUNS['smbr_wire_ms']:.2f} ms an update); "
            f"{wall:.1f} s from spawn to the last exit; launches "
            f"{launched}; final params, momentum and residuals: {rule}; "
            f"{smi}")

    where = out / "bmuf"
    for name in ("logit_store", "ckpt_teacher"):
        shutil.copytree(CLUSTER_IN / "bmuf" / name, where / name)
    shutil.copy(CLUSTER_IN / "bmuf" / "gen_ledger.json",
                where / "gen_ledger.json")
    reps, spawned, wall = run_ranks(
        ["--full", "--stage", "student", "--trainer", "bmuf", "--out",
         str(where)], 2, "gloo", where)
    check_ranks(reps, "bmuf (b)", 2, "gloo")
    launched = rank_launches(reps)
    for k in KERNELS:
        counts[k] += launched[k]
    want = dict(RUNS["bmuf_counts"], topk_logits=0)   # the targets reused
    if launched != want:
        fail(f"cluster bmuf (b): the ranks launched {launched}, want {want}")
    res = json.loads((where / "train_student.json").read_text())
    got = ranks_state(where)
    blocks = got["step"]
    gap = max(bmuf_gap(got, ref) for ref in RUNS["bmuf"][:1])
    if not gap <= BMUF_BLOCK_REL * blocks:
        fail(f"cluster bmuf (b): {gap:.3e} from BMUFVmap's run, beyond "
             f"{BMUF_BLOCK_REL} x {blocks} blocks")
    for r in reps:
        sync = r["split"]["block_sync"]
        log(f"cluster bmuf (b): rank {r['rank']}/2 (gloo, lanes "
            f"{r['lanes']}): start-up {r['t_main'] - spawned[r['rank']]:.2f}"
            f" s to main, {r['t_initialized'] - spawned[r['rank']]:.2f} s "
            f"to the process group; block sync {sync['event_ms']:.3f} ms "
            f"(events) / {sync['host_ms']:.3f} ms (host), in-process "
            f"{RUNS['bmuf_sync_ms']:.3f} ms; describe: "
            f"{r['describe']['nvidia_smi']}")
    log(f"cluster bmuf (b): 2 gloo ranks, {res['updates']} updates "
        f"({res['updates_by_loss']}) of {res['microbatches']} x 16x64 in "
        f"{res['train_s']:.3f} s = {res['frames_per_s']:.1f} frames/s "
        f"(in-process {RUNS['bmuf_frames_per_s']:.1f}); {wall:.1f} s from "
        f"spawn to the last exit; theta_g, delta, lanes and momentum within "
        f"{gap:.3e} of BMUFVmap's run (limit {BMUF_BLOCK_REL * blocks:.1e}); "
        f"sparse_ce launches {launched['sparse_ce']} over the ranks; {smi}")

    launched = cluster_pipeline(out / "pipeline", smi)
    for k in KERNELS:
        counts[k] += launched[k]
    launched = cluster_waves(out / "waves", smi)
    for k in KERNELS:
        counts[k] += launched[k]
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(CLUSTER_IN, ignore_errors=True)
    shutil.rmtree(WAVES_OUT, ignore_errors=True)
    return counts


def _npz_leaves(ckpt: Path) -> dict:
    """A ``CheckpointStore`` root's step-0 leaves as host tensors."""
    import numpy as np
    import torch
    with np.load(ckpt / "step_00000000.npz") as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def leaf_gap(a: dict, b: dict) -> float:
    """0.0 when every leaf is bitwise equal; else the largest leaf
    difference relative to that leaf's largest magnitude in ``b``."""
    if sorted(a) != sorted(b):
        fail(f"leaves differ: {sorted(set(a) ^ set(b))}")
    worst = 0.0
    for n in b:
        if not same_bits(a[n], b[n]):
            worst = max(worst, float((a[n].double() - b[n].double()).abs()
                                     .max() / max(float(b[n].double().abs()
                                                        .max()), 1e-30)),
                        1e-300)
    return worst


def update_gap(got: Path, ref: Path, start: str, end: str) -> tuple:
    """A stage's update (checkpoint ``end`` less the ``start`` it began
    from) under ``got`` against the same under ``ref``: (the largest
    element of the difference, the largest element of ``ref``'s update),
    over every leaf at once (GTC's sends are multiples of lr x tau
    whatever a leaf's size)."""
    g0, g1 = _npz_leaves(got / start), _npz_leaves(got / end)
    r0, r1 = _npz_leaves(ref / start), _npz_leaves(ref / end)
    diff = move = 0.0
    for n in r1:
        upd = r1[n].double() - r0[n].double()
        move = max(move, float(upd.abs().max()))
        diff = max(diff, float((g1[n].double() - g0[n].double() - upd)
                               .abs().max()))
    return diff, move


def cluster_pipeline(where: Path, smi: str) -> dict:
    """phase_cluster (d): ``launch.train --stage all --scale tiny
    --trainer bmuf`` in 2 gloo ranks on this card, against
    phase_pipeline's BMUF arm (``CLUSTER_IN / "pipeline"``): every stage
    completes; generation split over both ranks, their ranges disjoint
    and covering the store; the replicated baseline and teacher and the
    store bitwise the arm's; the BMUF student (its lanes on the ranks)
    within BMUF_BLOCK_REL a block of the arm's BMUFVmap student, the sMBR
    stage's update within PIPE_SMBR_SHARE of the arm's; the ranks'
    launches, summed, the arm's stage by stage.  -> the ranks' launches."""
    from repro_torch.pipeline import WorkLedger
    arm, ref = CLUSTER_IN / "pipeline", RUNS["pipeline"]
    t0 = time.perf_counter()
    reps, spawned, wall = run_ranks(
        ["--stage", "all", "--scale", "tiny", "--trainer", "bmuf",
         "--out", str(where)], 2, "gloo", where)
    check_ranks(reps, "pipeline (d)", 2, "gloo")
    res = json.loads((where / "train_all.json").read_text())
    keys = {"baseline": "baseline", "teacher": "teacher",
            "targets": "targets", "student": "student_bmuf",
            "smbr": "smbr"}
    if list(res) != list(PIPELINE_STAGES) or any(
            set(r["stages"]) != set(keys.values()) for r in reps):
        fail(f"cluster pipeline (d): results {list(res)}, stages "
             f"{[sorted(r['stages']) for r in reps]}")

    # generation split over the ranks
    ranges = [r["stages"]["targets"]["ranges"] for r in reps]
    shards = sorted(i for rr in ranges for lo, hi in rr
                    for i in range(lo, hi))
    n = res["targets"]["n_shards"]
    if not all(ranges) or shards != list(range(n)) or \
            not WorkLedger.peek_all_done(str(where / "gen_ledger.json")):
        fail(f"cluster pipeline (d): the ranks generated {ranges} of {n} "
             f"shards, ledger all done "
             f"{WorkLedger.peek_all_done(str(where / 'gen_ledger.json'))}")

    # the replicated stages and the store against the in-process arm
    gaps = {name: leaf_gap(_npz_leaves(where / name), _npz_leaves(arm / name))
            for name in ("ckpt_baseline", "ckpt_teacher")}
    if any(gaps.values()):
        fail(f"cluster pipeline (d): the replicated stages differ from the "
             f"in-process run: {gaps}")
    files = sorted(p.name for p in (arm / "logit_store" / "shards").iterdir())
    if (where / "logit_store" / "manifest.json").read_bytes() != \
            (arm / "logit_store" / "manifest.json").read_bytes() or \
            sorted(p.name for p in (where / "logit_store" / "shards")
                   .iterdir()) != files or any(
                (where / "logit_store" / "shards" / f).read_bytes()
                != (arm / "logit_store" / "shards" / f).read_bytes()
                for f in files):
        fail("cluster pipeline (d): the store differs from the in-process "
             "run's")

    # the BMUF student and its sMBR
    blocks = res["student"]["n_steps"]
    bmuf = leaf_gap(_npz_leaves(where / "ckpt_student_bmuf"),
                    _npz_leaves(arm / "ckpt_student_bmuf"))
    smbr = leaf_gap(_npz_leaves(where / "ckpt_smbr"),
                    _npz_leaves(arm / "ckpt_smbr"))
    upd, move = update_gap(where, arm, "ckpt_student_bmuf", "ckpt_smbr")
    own = leaf_gap(_npz_leaves(arm / "ckpt_smbr"),
                   _npz_leaves(arm / "ckpt_student_bmuf"))
    log(f"cluster pipeline (d): the sMBR stage's update, in-process: its "
        f"largest element {move:.3e}, {own:.3e} of its leaf's size; the "
        f"ranks' update off by {upd:.3e} = {upd / max(move, 1e-300):.3e} of "
        f"it (limit {PIPE_SMBR_SHARE}); the ranks' sMBR checkpoint "
        f"{smbr:.3e} of each leaf's size from the in-process one, the BMUF "
        f"student's {bmuf:.3e}")
    if not (bmuf <= BMUF_BLOCK_REL * blocks and move > 0
            and upd <= PIPE_SMBR_SHARE * move):
        fail(f"cluster pipeline (d): BMUF student {bmuf:.3e} from the "
             f"in-process run (limit {BMUF_BLOCK_REL} x {blocks} blocks), "
             f"sMBR update off by {upd:.3e} of the in-process {move:.3e} "
             f"(limit {PIPE_SMBR_SHARE} of it)")

    # the ranks' launches, stage by stage, against the in-process arm's
    launched = dict.fromkeys(KERNELS, 0)
    for stage, key in keys.items():
        got = {}
        for r in reps:
            for k, v in r["stages"][key]["launches"].items():
                got[k] = got.get(k, 0) + v
                launched[k] += v
        arm_name = f"{'bmuf' if stage in ('student', 'smbr') else 'gtc'} " \
                   f"{stage}"
        if got != ref["by_stage"][arm_name]:
            fail(f"cluster pipeline (d): {stage}: the ranks launched {got}, "
                 f"the in-process {arm_name} {ref['by_stage'][arm_name]}")
    d_s = time.perf_counter() - t0

    def rate(st):
        return st["frames"] / st["fit_s"]
    for stage, key in keys.items():
        mine = reps[0]["stages"][key]
        over = ("over both ranks" if mine["frames_summed_over_ranks"]
                else "a rank")
        one = ref["stats"]["bmuf" if stage in ("student", "smbr")
                           else "gtc"][key]
        inproc = ref["res"]["bmuf" if stage in ("student", "smbr")
                            else "gtc"][stage]
        log(f"cluster pipeline (d): {stage}: {mine['seconds']:.2f} s "
            f"(rank 1 {reps[1]['stages'][key]['seconds']:.2f}), "
            f"{mine['frames']:.0f} real frames {over} = "
            f"{rate(mine):.1f} frames/s (in-process {rate(one):.1f}, "
            f"{one['seconds']:.2f} s); launches {mine['launches']} / "
            f"{reps[1]['stages'][key]['launches']}"
            + (f"; lanes {mine['lanes']} / {reps[1]['stages'][key]['lanes']}"
               if "lanes" in mine else "")
            + (f"; ranges {ranges[0]} / {ranges[1]}" if key == "targets"
               else "")
            + (f"; val FER {res[stage]['val_fer']:.4f} (in-process "
               f"{inproc['val_fer']:.4f})" if "val_fer" in res[stage]
               else "")
            + f"; rank 1 from rank 0's checkpoint "
            f"{reps[1]['stages'][key]['diff_from_rank0']:.3e}")
    for r in reps:
        log(f"cluster pipeline (d): rank {r['rank']}/2 (gloo) on "
            f"{r['device']}: start-up {r['t_main'] - spawned[r['rank']]:.2f} s"
            f" to the launcher's main, "
            f"{r['t_initialized'] - spawned[r['rank']]:.2f} s to the process "
            f"group, {r['t_done'] - spawned[r['rank']]:.2f} s to the end")
    log(f"cluster pipeline (d): --stage all --scale tiny --trainer bmuf in 2 "
        f"gloo ranks: {wall:.1f} s from spawn to the last exit, {d_s:.1f} s "
        f"with the checks; baseline and teacher checkpoints and the store "
        f"({n} shards) bitwise the in-process run's; BMUF student within "
        f"{bmuf:.3e} (limit {BMUF_BLOCK_REL * blocks:.1e}, {blocks} blocks), "
        f"sMBR update off by {upd / max(move, 1e-300):.3e} of the "
        f"in-process one (limit {PIPE_SMBR_SHARE}); launches "
        f"{launched} over the ranks, the in-process arm's stage by stage; "
        f"{smi}")
    return launched


def waves_targets_gap(got: Path, ref: Path) -> tuple:
    """Two stores' live shards, ``got`` against ``ref``: -> (the ids
    that differ, each at a near-tie: ``ref``'s stored value there within
    WAVES_VALS_TOL x max(1, |value|) of a neighbour's; all the ids; the
    largest value difference in units of max(1, |value|)).  Fails at an
    id that differs away from a near-tie."""
    import numpy as np
    from repro_torch.store import LogitStoreV2
    a = LogitStoreV2(str(got), gc_on_open=False)
    b = LogitStoreV2(str(ref), gc_on_open=False)
    if a.shards() != b.shards() or not b.shards():
        fail(f"cluster waves (e): shards {a.shards()} vs {b.shards()}")
    swaps = total = 0
    worst = 0.0
    for sid in b.shards():
        va, ia = a.read_shard(sid)
        vb, ib = b.read_shard(sid)
        va, vb = np.asarray(va, np.float64), np.asarray(vb, np.float64)
        scale = np.maximum(1.0, np.abs(vb))
        worst = max(worst, float((np.abs(va - vb) / scale).max()))
        total += ib.size
        for pos in zip(*np.nonzero(np.asarray(ia) != np.asarray(ib))):
            row, j = vb[pos[:-1]], pos[-1]
            near = min(abs(row[j] - row[j + d]) for d in (-1, 1)
                       if 0 <= j + d < row.size) / scale[pos]
            if near > WAVES_VALS_TOL:
                fail(f"cluster waves (e): shard {sid} {pos}: id "
                     f"{ia[pos]} vs {ib[pos]}, {near:.3e} from a tie")
            swaps += 1
    return swaps, total, worst


def cluster_waves(where: Path, smi: str) -> dict:
    """phase_cluster (e): ``launch.train --stage waves --scale tiny
    --trainer bmuf --gen-procs 1`` (``run_waves(2, kill_at=1,
    revive_after=2)``) in 2 gloo ranks on this card, each rank's targets
    in one worker process, from phase_waves's baseline and teacher,
    against phase_waves's run (``RUNS["waves"]``, its out dir
    WAVES_OUT): the report's counts equal; every rank at its W at every
    block (rank 1 without a lane at W = 3); each wave's student within
    BMUF_BLOCK_REL a block (counted from wave 0); wave 1's targets, which
    that student generates, ids equal but at near-ties (at most
    WAVES_NEAR_TIES of them) and values within WAVES_VALS_TOL; every
    worker on the card; the launches over the ranks and their workers'
    reports phase_waves's.  -> the launches."""
    ref = RUNS["waves"]
    want = ref["report"]
    for name in ("ckpt_baseline", "ckpt_teacher"):
        shutil.copytree(CLUSTER_IN / "waves" / name, where / name)
    t0 = time.perf_counter()
    reps, spawned, wall = run_ranks(
        ["--stage", "waves", "--scale", "tiny", "--trainer", "bmuf",
         "--gen-procs", "1", "--out", str(where)], 2, "gloo", where)
    check_ranks(reps, "waves (e)", 2, "gloo")
    res = json.loads((where / "train_waves.json").read_text())

    # the report's counts against the in-process run's
    keys = ("n_waves", "manifest_clean", "n_verified", "gc_removed",
            "ledger_clean", "restarts_absorbed", "resize_count")
    got = {k: res[k] for k in keys}
    if got != {k: want[k] for k in keys}:
        fail(f"cluster waves (e): {got}, in-process "
             f"{ {k: want[k] for k in keys} }")
    for w, (wv, ww) in enumerate(zip(res["waves"], want["waves"])):
        mine = [wv["wave"]] + [wv["student"][k] for k in (
            "final_workers", "chaos", "n_steps")]
        theirs = [ww["wave"]] + [ww["student"][k] for k in (
            "final_workers", "chaos", "n_steps")]
        if mine != theirs:
            fail(f"cluster waves (e): wave {w}: (wave, final_workers, "
                 f"chaos, n_steps) {mine}, in-process {theirs}")
        one_w = [p["n_workers"]
                 for p in ref["stats"][f"student_wave{w}"]["polls"]]
        for r in wv["ranks"]:
            seen = [p["n_workers"] for p in r["polls"]]
            empty = [p["n_workers"] for p in r["polls"] if not p["lanes"]]
            if seen != one_w or (
                    r["rank"] == 1 and set(empty) != {3}) or (
                    r["rank"] == 0 and empty):
                fail(f"cluster waves (e): wave {w}: rank {r['rank']} polled "
                     f"W {seen} with lanes {[p['lanes'] for p in r['polls']]}"
                     f"; in-process W {one_w}")

    # each wave's student, and wave 1's targets from wave 0's student
    gaps, blocks = [], 0
    for w, ww in enumerate(want["waves"]):
        blocks += ww["student"]["n_steps"]
        name = f"ckpt_student_wave{w}"
        gap = leaf_gap(_npz_leaves(where / name), _npz_leaves(WAVES_OUT / name))
        gaps.append(gap)
        if not 0 < blocks or not gap <= BMUF_BLOCK_REL * blocks:
            fail(f"cluster waves (e): wave {w}'s student {gap:.3e} from the "
                 f"in-process one, beyond {BMUF_BLOCK_REL} x {blocks} blocks")
    swaps, n_ids, worst = waves_targets_gap(where / "logit_store",
                                            WAVES_OUT / "logit_store")
    if swaps > WAVES_NEAR_TIES * n_ids or worst > WAVES_VALS_TOL:
        fail(f"cluster waves (e): wave 1's targets: {swaps} of {n_ids} ids "
             f"at near-ties (limit {WAVES_NEAR_TIES}), values within "
             f"{worst:.3e} of max(1, |value|) (limit {WAVES_VALS_TOL})")

    # the launches: the ranks' and their workers' reports
    workers = [r for wv in res["waves"] for r in wv["gen"]["workers"]]
    check_worker_reports(workers, "cluster waves (e)",
                         sum(wv["gen"]["n_shards"] for wv in res["waves"]))
    launched = dict.fromkeys(KERNELS, 0)
    for r in reps:
        for k in KERNELS:
            launched[k] += r["launches"][k]
    if launched["topk_logits"] or launched["gtc_compress"]:
        fail(f"cluster waves (e): the ranks launched {launched}; want "
             "sparse_ce only (the workers forward the targets)")
    launched["topk_logits"] = worker_launches(workers)["topk_logits"]
    if launched != ref["counts"]:
        fail(f"cluster waves (e): the ranks and workers launched "
             f"{launched}, phase_waves {ref['counts']}")
    e_s = time.perf_counter() - t0

    spawn_t = {e["owner"]: e["t"] for wv in res["waves"]
               for e in wv["gen"]["events"] if e["event"] == "spawn"}
    nan = float("nan")
    for w, wv in enumerate(res["waves"]):
        g = wv["gen"]
        starts = ", ".join(
            f"rank {r.get('rank')} worker {r['worker']}: "
            f"{r['t_loaded'] - spawn_t.get(r['owner'], nan):.2f} s to its "
            f"imports, "
            f"{r['engine_s']:.2f} s building the engine, {r['n_written']} "
            f"shards, forwards {r['forward_s']:.2f} s, spawn to exit "
            f"{r['t_exit'] - spawn_t.get(r['owner'], nan):.2f} s"
            for r in g["workers"])
        one = want["waves"][w]
        log(f"cluster waves (e): wave {w}: targets wave {wv['wave']} by "
            f"{g['processes']} processes over 2 ranks ({g['restarts']} "
            f"restarts), ranges {[r['ranges'] for r in wv['ranks']]}; "
            f"{starts}; student {wv['student']['n_steps']} blocks at W "
            f"{[p['n_workers'] for p in wv['ranks'][0]['polls']]}, lanes "
            f"rank 0 "
            f"{[p['lanes'] for p in wv['ranks'][0]['polls']]}, rank 1 "
            f"{[p['lanes'] for p in wv['ranks'][1]['polls']]}; "
            f"{gaps[w]:.3e} from the in-process student; val FER "
            f"{wv['student']['val_fer']:.4f} (in-process "
            f"{one['student']['val_fer']:.4f})")
    for r in reps:
        st = r["stages"]
        log(f"cluster waves (e): rank {r['rank']}/2 (gloo) on {r['device']}: "
            f"start-up {r['t_main'] - spawned[r['rank']]:.2f} s to the "
            f"launcher's main, {r['t_initialized'] - spawned[r['rank']]:.2f} "
            f"s to the process group, {r['t_done'] - spawned[r['rank']]:.2f} "
            f"s to the end; student waves "
            + ", ".join(f"{st[f'student_wave{w}']['seconds']:.2f} s "
                        f"(in-process {ref['stats'][f'student_wave{w}']['seconds']:.2f})"
                        for w in range(2))
            + f"; its launches {r['launches']}")
    log(f"cluster waves (e): run_waves(2) in 2 gloo ranks, a generation "
        f"process a rank: {wall:.1f} s from spawn to the last exit, {e_s:.1f}"
        f" s with the checks (in-process phase_waves {ref['seconds']:.2f} s); "
        f"counts {got} the in-process run's; students within "
        + " / ".join(f"{g:.3e}" for g in gaps)
        + f" (limit {BMUF_BLOCK_REL} a block); wave 1's targets: {swaps} of "
        f"{n_ids} ids at near-ties, values within {worst:.3e} of max(1, "
        f"|value|); launches "
        f"{launched} over the ranks and {len(workers)} worker reports, "
        f"phase_waves's; {smi}")
    return launched


def phase_targets() -> dict:
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_arch
    from repro_torch.core.teacher import TeacherRunner, make_teacher_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LstmAM
    from repro_torch.pipeline import generate_sharded
    from repro_torch.serve import THROUGHPUT, StreamingEngine
    from repro_torch.store import (LogitStoreV2, full_bytes_per_frame,
                                   storage_bytes_per_frame)
    out = ROOT / "build" / "chip_smoke_targets"
    shutil.rmtree(out, ignore_errors=True)
    cfg = make_teacher_config(get_arch("lstm-am-7khr"))
    n, rows, frames = launch_train.TARGET_SIZES["full"]
    batches = launch_train.make_target_batches(cfg, n=n, rows=rows,
                                               frames=frames, seed=SEED)
    workers, per_range = 3, n // 3

    def run():
        return launch_train.stage_targets(full=True, device="cuda",
                                          seed=SEED, workers=workers,
                                          out=str(out), log=log)

    # 1. a pass whose engines raise at their 6th forward (the reference
    # test's dying engine; not CrashPoint, which would kill this process)
    real = launch_train.engine_from_checkpoint
    forwards = []

    class Dying:
        def __init__(self, eng):
            self.eng = eng

        def forward_topk(self, batch):
            if len(forwards) == 5:
                raise RuntimeError("worker killed at its 6th forward")
            forwards.append(batch)
            return self.eng.forward_topk(batch)

    launch_train.engine_from_checkpoint = (
        lambda *a, **kw: Dying(real(*a, **kw)))
    launch_counts(reset=True)
    try:
        run()
    except RuntimeError as e:
        if "6th forward" not in str(e):
            raise
    else:
        fail("targets: the killed pass ran to its end")
    finally:
        launch_train.engine_from_checkpoint = real
    killed = launch_counts()["topk_logits"]
    with open(out / "gen_ledger.json") as f:
        ledger = json.load(f)
    done = [(r["lo"], r["hi"]) for r in ledger["ranges"]
            if r["status"] == "done"]
    store = LogitStoreV2(str(out / "logit_store"))
    if done != [(0, per_range)] or killed != 5:
        fail(f"targets: killed pass left ranges {done} done after {killed} "
             f"topk_logits launches, want [(0, {per_range})] after 5")
    if not (set(range(per_range)) <= set(store.shards())
            and len(store.shards()) <= 5
            and store.verify() == len(store.shards())):
        fail(f"targets: killed pass left shards {store.shards()}")
    log(f"targets: killed pass: {killed} forwards, ledger ranges done "
        f"{done}, {len(store.shards())} shards committed and verified")

    # 2. the resume forwards exactly the unfinished batches
    rep = run()
    counts = launch_counts()
    RUNS["targets_pass"] = rep          # phase_gen_procs' in-process pass
    resumed = counts["topk_logits"] - killed
    store = LogitStoreV2(str(out / "logit_store"))
    if not rep["resumed"] or resumed != n - per_range \
            or rep["n_written"] != n - per_range:
        fail(f"targets: resume forwarded {resumed} batches "
             f"(n_written {rep['n_written']}), want {n - per_range}")
    if store.verify() != n or any(store.manifest.entry(j).wave != 0
                                  for j in range(n)):
        fail("targets: the resumed store is not 12 verified wave-0 shards")
    want_x = round(full_bytes_per_frame(cfg.n_senones)
                   / storage_bytes_per_frame(K), 1)
    if rep["storage_compression_x"] != want_x or want_x != 106.1:
        fail(f"targets: storage_compression_x {rep['storage_compression_x']}")
    for j, b in enumerate(batches):
        if not np.array_equal(store.read_lens(j), b["mask"].sum(-1)):
            fail(f"targets: shard {j}'s lens differ from its mask")
    # the same 12 shards written again from host arrays: the store's own
    # share of write_s (which also waits for each forward's last kernels)
    host_shards = [(store.read_shard(j), store.read_lens(j))
                   for j in range(n)]
    rewrite = LogitStoreV2(str(out / "rewrite_store"), k=K,
                           vocab=cfg.n_senones)
    t0 = time.perf_counter()
    for j, ((v, i), lens) in enumerate(host_shards):
        rewrite.append_shard(j, v, i, lens)
    rewrite_ms = (time.perf_counter() - t0) / n * 1e3
    gen_s = rep["gen_s"]
    log(f"targets: resumed pass: {rep['n_written']} batches of "
        f"{rows}x{frames}, {rep['frames_written']} frames in {gen_s:.3f} s "
        f"= {rep['frames_per_s']:.1f} frames/s; forwards "
        f"{rep['forward_s']:.3f} s, shard writes and checksums "
        f"{rep['write_s']:.4f} s ({rep['write_s'] / gen_s:.2%} of the "
        f"pass, {rep['write_s'] / rep['n_written'] * 1e3:.2f} ms a shard, "
        f"{rewrite_ms:.2f} ms a shard rewritten from host arrays); "
        f"{storage_bytes_per_frame(K)} bytes a stored frame "
        f"against {full_bytes_per_frame(cfg.n_senones)}, "
        f"storage_compression_x {rep['storage_compression_x']}")

    # 3. one batch's shortest row against the port's engine on the host
    like = LstmAM(cfg, device="meta", generator=None).state_dict()
    params, _ = CheckpointStore(str(out / "ckpt_teacher")).load(like)
    j = n - 1
    r = int(np.argmin(batches[j]["mask"].sum(-1)))
    t = int(batches[j]["mask"][r].sum())
    utt = batches[j]["feats"][r, :t]
    host = StreamingEngine(cfg, params, k=K, policy=THROUGHPUT,
                           topk_impl="kernel", device="cpu")
    hrid = host.submit(utt)
    href = host.run()[hrid]
    vals, idx = store.read_shard(j)
    worst = check_emissions(vals[r, :t].astype(np.float32), idx[r, :t],
                            href.vals, href.idx,
                            _host_logits(cfg, params, utt), K,
                            f"targets shard {j} row {r}")
    log(f"targets: shard {j} row {r} ({t} frames) == the port's "
        f"StreamingEngine on the host (worst value error {worst:.3f} bf16 "
        f"ulp); every shard's lens == its mask's row sums")

    # 4. the firehose: one shard per utterance, in submission order
    card_params = {k: v.cuda() for k, v in params.items()}
    runner = TeacherRunner(cfg, card_params, k=K, device="cuda")
    rng = np.random.default_rng(SEED + 2)
    utts = [rng.normal(size=(int(rng.integers(100, 501)), cfg.feat_dim))
            .astype(np.float32) for _ in range(48)]
    fire = LogitStoreV2(str(out / "firehose_store"), k=K,
                        vocab=cfg.n_senones)
    before = launch_counts()["topk_logits"]
    t0 = time.perf_counter()
    paths = runner.generate_corpus_to_store(fire, utts, wave=16)
    torch.cuda.synchronize()
    fire_s = time.perf_counter() - t0
    counts = launch_counts()
    fire_launches = counts["topk_logits"] - before
    want = [str(out / "firehose_store" / "shards"
                / f"shard_{i:05d}_w0000.vals.npy") for i in range(48)]
    if paths != want or fire.verify() != 48 or fire_launches != 3:
        fail(f"targets: firehose wrote {len(paths)} shards in order "
             f"{paths == want} with {fire_launches} launches, want 48 in "
             "order with 3")
    for i, u in enumerate(utts):
        if fire.manifest.entry(i).n_frames != len(u) \
                or fire.read_lens(i).tolist() != [len(u)]:
            fail(f"targets: firehose shard {i} is not its utterance's "
                 f"{len(u)} frames")
    frames = sum(len(u) for u in utts)
    log(f"targets: firehose: 48 utterances, {frames} frames in "
        f"{fire_s:.3f} s = {frames / fire_s:.1f} frames/s; 48 shards in "
        f"submission order, 3 topk_logits launches (waves of 16)")

    # 5. four batches again, traced: the device's idle share
    eng = TeacherRunner(cfg, card_params, k=K, device="cuda")
    log("targets: 2 batches through generate_sharded again, traced:")
    traced("targets", lambda: generate_sharded(
        lambda w: eng, batches[:2],
        LogitStoreV2(str(out / "traced_store"), k=K, vocab=cfg.n_senones),
        ledger_path=str(out / "traced_ledger.json")))
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


def traced(path: str, fn) -> dict:
    """Run ``fn`` under the profiler, device activity only, and log the
    device's busy share; returns ``profile_device``'s numbers.  No
    number here reads the host's ops, and recording them adds host time
    to every op (which inflates the idle share) and minutes of reading
    to a script that must finish in 1,200 s."""
    from repro_torch.launch.serve import profile_device
    p = profile_device(fn, host_ops=False)
    log(f"{path}: traced wall {p['wall_ms']:.1f} ms, device busy "
        f"{p['busy_ms']:.1f} ms = {p['busy_ms'] / p['wall_ms']:.1%} "
        f"(idle {1 - p['busy_ms'] / p['wall_ms']:.1%}), {p['ops']} device "
        f"ops")
    return p


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


# ------------------------------------------------- whisper streaming

WHISPER_ARCH = "whisper-medium"
WHISPER_SLOTS, WHISPER_CHUNK, WHISPER_MAX_FRAMES = 8, 16, 256
WHISPER_MIN_COMPARED = 4           # chunks a stream the host must confirm
WHISPER_HOST_CHUNKS = 8            # chunks of a stream the host runs (of
                                   # 15; the host's f32 products at full
                                   # width take 0.3-1.0 s a chunk step)


def whisper_streams(d: int):
    """6 firehose streams of 240 frames, 2 interactive of 48 and a live
    one of 160 (fed in 32-frame pieces: whole chunks, so its chunk
    boundaries are those of one submit), encoder embeddings ~ N(0, 1)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 7)

    def audio(n):
        return rng.normal(size=(n, d)).astype(np.float32)
    return ([audio(240) for _ in range(6)], [audio(48) for _ in range(2)],
            audio(160))


def phase_whisper() -> dict:
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.logit_store import topk_compress
    from repro_torch.models import build_model
    from repro_torch.serve import (FIREHOSE, INTERACTIVE, StreamServer,
                                   TieredPolicy)
    cfg = get_arch(WHISPER_ARCH)
    t0 = time.perf_counter()
    params = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 7)).state_dict()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    log(f"whisper: {WHISPER_ARCH} ({n_params / 1e9:.3f} B params, f32) "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    # a stream holds at most 256 / 16 = 16 chunks, one default firehose
    # window: firehose windows of 4 keep streams in flight across pumps,
    # so interactive arrivals park one and a stream can be detached
    tiers = TieredPolicy(tiers=(INTERACTIVE,
                                dataclasses.replace(FIREHOSE, sync_every=4)))
    fire, inter, live = whisper_streams(cfg.d_model)

    def server():
        return StreamServer(cfg, params, n_slots=WHISPER_SLOTS,
                            chunk_frames=WHISPER_CHUNK, sync_every=4, k=K,
                            tiers=tiers, max_frames=WHISPER_MAX_FRAMES,
                            device="cuda")

    def attached(srv):
        return [req.rid for req in srv._slots if req is not None]

    def drive(srv, *, detach_and_live=True):
        """The firehose alone for one pump, then the interactive
        arrivals; with ``detach_and_live`` also the live stream (opened
        with them, appended between pumps, then closed) and one firehose
        stream detached mid-flight and reattached.  Returns (rids, done,
        detached rid, live rid)."""
        rids = [srv.submit(u, tier="firehose") for u in fire]
        rl = rd = None
        done = srv.pump()
        rids += [srv.submit(u, tier="interactive") for u in inter]
        if detach_and_live:
            rl = srv.submit(live[:32], final=False, tier="interactive")
            done.update(srv.pump())
            srv.append(rl, live[32:64])
            rd = next(r for r in attached(srv) if r in rids[:len(fire)])
            srv.detach(rd)
            srv.append(rl, live[64:96])
            done.update(srv.pump())
            srv.reattach(rd)
            srv.append(rl, live[96:])
            srv.close(rl)
        done.update(srv.drain())
        torch.cuda.synchronize()
        return rids, done, rd, rl

    warm = server()                           # cuBLAS/allocator warm-up
    warm.submit(inter[0], tier="interactive")
    warm.drain()
    torch.cuda.synchronize()

    srv = server()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    rids, done, rd, rl = drive(srv)
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    launches = counts["topk_logits"]
    st = srv.stats
    if launches == 0:
        fail("whisper: the stream path launched no topk_logits kernel")
    if launches != 2 * st["steps"]:
        fail(f"whisper: {launches} topk_logits launches over {st['steps']} "
             f"chunk steps, want 2 a step (stage 1 and the merge: "
             f"V = {cfg.vocab_size} is {-(-cfg.vocab_size // 2048)} tiles)")
    utts = dict(zip(rids, fire + inter))
    utts[rl] = live
    for rid, u in utts.items():
        v, i = done[rid].emissions()
        want = (-(-u.shape[0] // WHISPER_CHUNK), K)
        if v.shape != want or i.shape != want or not np.isfinite(v).all():
            fail(f"whisper: stream {rid} emitted {v.shape}, want {want} "
                 f"finite")
    frames = st["useful_units"]
    if frames != sum(u.shape[0] for u in utts.values()):
        fail(f"whisper: {frames} useful frames, want "
             f"{sum(u.shape[0] for u in utts.values())}")
    log(f"whisper: {len(utts)} streams, {frames} frames in {dt:.3f} s = "
        f"{frames / dt:.1f} useful frames/s, {st['steps'] / dt:.2f} chunk "
        f"steps/s; {st['syncs']} syncs over {st['steps']} steps, "
        f"{st['parked']} parks, slot occupancy "
        f"{st['active_slot_steps'] / st['slot_steps']:.3f}, frame "
        f"utilization {srv.utilization():.3f}; topk_logits launches "
        f"{launches} ({launches / st['steps']:.2f} per chunk step); peak "
        f"device memory {peak / 2**30:.3f} GiB")

    # the detached stream and the live stream against uninterrupted runs
    # of the same frames in a server of the same shape, bitwise
    ref = server()
    r_d = ref.submit(utts[rd], tier="firehose")
    r_l = ref.submit(live, tier="interactive")
    ref_done = ref.drain()
    for what, got, want in (("detached and reattached", done[rd],
                             ref_done[r_d]),
                            ("live", done[rl], ref_done[r_l])):
        (gv, gi), (wv, wi) = got.emissions(), want.emissions()
        if not (np.array_equal(gi, wi) and same_bits(torch.from_numpy(gv),
                                                      torch.from_numpy(wv))):
            fail(f"whisper: the {what} stream differs from an "
                 f"uninterrupted run of its frames")
    log(f"whisper: the detached and reattached stream {rd} and the live "
        f"stream {rl} == uninterrupted runs of their frames (bitwise)")

    # the kernel against its plain version on the model's own logits at
    # the path's shape: one chunk step of 8 rows
    model = srv.model
    with torch.no_grad():
        state = model.init_stream_state(WHISPER_SLOTS,
                                        max_frames=WHISPER_MAX_FRAMES,
                                        max_tokens=WHISPER_MAX_FRAMES)
        feats = torch.from_numpy(np.stack(
            [u[:WHISPER_CHUNK] for u in fire + inter])).cuda()
        h, _ = model.stream_step(state, feats)
        logits = model.unembed(h)[:, 0]
    del state
    err = check_kernel(logits, K, f"R={WHISPER_SLOTS} V={cfg.vocab_size} "
                       f"k={K} (the model's unembed)")
    log(f"whisper: topk_logits == plain version on the model's logits at "
        f"R={WHISPER_SLOTS}, V={cfg.vocab_size}, k={K} (values bitwise, "
        f"ids exact; max abs err {err})")

    log("whisper: the firehose and interactive streams again, traced:")
    tsrv = server()
    p = traced("whisper", lambda: drive(tsrv, detach_and_live=False))
    steps0 = tsrv.stats["steps"]
    log(f"whisper: traced {steps0} chunk steps: "
        f"{p['ops'] / steps0:.1f} device ops and {p['busy_ms'] / steps0:.3f} "
        f"device ms a chunk step, {p['wall_ms'] / steps0:.3f} ms of wall "
        f"(traced)")

    # card against host: two firehose streams through the port's plain
    # path on the host at full width, chunk by chunk over their first
    # WHISPER_HOST_CHUNKS chunks, up to the first chunk whose fed-back
    # token is a near-tie (top-2 margin <= GAP)
    t0 = time.perf_counter()
    host = build_model(cfg, device="cpu", params=_host(params))
    pick = [r for r in rids[:len(fire)] if r != rd][:2]
    n_chunks = WHISPER_HOST_CHUNKS
    hs = host.init_stream_state(len(pick), max_frames=WHISPER_MAX_FRAMES,
                                max_tokens=WHISPER_MAX_FRAMES)
    hv, hi, hl = [], [], []
    with torch.no_grad():
        for c in range(n_chunks):
            f = torch.from_numpy(np.stack(
                [utts[r][c * WHISPER_CHUNK:(c + 1) * WHISPER_CHUNK]
                 for r in pick]))
            h, hs = host.stream_step(hs, f)
            lg = host.unembed(h)[:, 0]
            v, i = topk_compress(lg, K)
            hv.append(v.float().numpy())
            hi.append(i.numpy())
            hl.append(lg)
    host_s = time.perf_counter() - t0
    compared, worst = [], 0.0
    for j, rid in enumerate(pick):
        logits = torch.stack([lg[j] for lg in hl])          # (chunks, V)
        top2 = torch.topk(logits, 2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1] <= GAP).nonzero()
        n = n_chunks if near.numel() == 0 else int(near[0]) + 1
        if n < WHISPER_MIN_COMPARED:
            fail(f"whisper: stream {rid}'s host run reaches a near-tie at "
                 f"chunk {n - 1}; fewer than {WHISPER_MIN_COMPARED} chunks "
                 f"to compare")
        cv, ci = done[rid].emissions()
        worst = max(worst, check_emissions(
            cv[:n], ci[:n], np.stack([v[j] for v in hv])[:n],
            np.stack([i[j] for i in hi])[:n], logits[:n], K,
            f"whisper stream {rid}"))
        compared.append(n)
    del host, hs
    log(f"whisper: streams {pick} == the port's plain path on the host at "
        f"full width over {compared} chunks (ids exact away from "
        f"near-ties; worst value error {worst:.3f} bf16 ulp; the host took "
        f"{host_s:.1f} s)")
    del params, srv, ref, tsrv, warm, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------- token-LM decode kernels

def same_cache(a, b) -> bool:
    """Bitwise equality of two caches (bf16 or f32)."""
    import torch
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(a.view(view), b.view(view))


def attn_inputs(gen, b, hkv, g, s, hd, dtype):
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return (rnd(b, hkv * g, 1, hd), rnd(b, hkv, 1, hd), rnd(b, hkv, 1, hd),
            rnd(b, hkv, s, hd).to(dtype), rnd(b, hkv, s, hd).to(dtype))


def check_decode_attention(inputs, pos, what: str, **kw) -> float:
    """``decode_attention`` on card tensors against its plain version on
    clones of the same caches: the written caches bitwise, o within
    ATTN_REL of max(1, |plain|).  Returns the error."""
    import torch
    from repro_torch.kernels.decode_attention import ops, ref
    q, kn, vn, ck, cv = inputs
    ko, kk, kv = ops.decode_attention(q, kn, vn, ck.clone(), cv.clone(), pos,
                                      **kw)
    ro, rk, rv = ref.decode_attention_ref(q, kn, vn, ck.clone(), cv.clone(),
                                          pos, **kw)
    torch.cuda.synchronize()
    if not (same_cache(kk, rk) and same_cache(kv, rv)):
        fail(f"decode_attention wrote other caches than its plain version "
             f"at {what}")
    if ko.shape != ro.shape:
        fail(f"decode_attention o {tuple(ko.shape)} at {what}")
    err = rel_err(ko, ro)
    if not err <= ATTN_REL:
        fail(f"decode_attention differs from its plain version at {what}: "
             f"{err:.3e} > {ATTN_REL} of max(1, |plain|)")
    return err


def phase_decode_attention() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    from repro_torch.models import layers
    from repro_torch.models.attention import decode_slot_validity
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    n, worst = 0, 0.0
    # every variant at two small shapes: S=64 runs one block per (b, h),
    # S=300 five (kernel.split_plan); ragged rows, the ring wrapping
    # (positions past S) under a window
    for s in (64, 300):
        for hd in (64, 120, 128):
            for g in (1, 8):
                for window in (0, 8):
                    pos = torch.tensor(
                        ([0, 5, s - 1, 37] if not window
                         else [3, s - 1, s + 5, 3 * s + 17]),
                        dtype=torch.int32, device="cuda")
                    inputs = attn_inputs(gen, 4, 2, g, s, hd, torch.bfloat16)
                    for cap in (0.0, 30.0):
                        for theta in (0.0, 1e6):
                            for write in (True, False):
                                worst = max(worst, check_decode_attention(
                                    inputs, pos, f"S={s} hd={hd} G={g} "
                                    f"window={window} softcap={cap} "
                                    f"rope_theta={theta} write={write}",
                                    window=window, softcap=cap,
                                    rope_theta=theta, write=write))
                                n += 1
    # the split's edges at the main path's widths (B=16, Hkv=2, G=8,
    # hd=128: 8 blocks per (b, h) at S=1000); each row's valid slots are
    # cut into 8 chunks, the written slot always in the row's last one
    nsplit = kernel.split_plan(32, 1000, torch.cuda.get_device_properties(
        0).multi_processor_count)
    edges = [0, 1, nsplit - 1, nsplit, 64 * nsplit - 1, 64 * nsplit,
             999, 1000 + 3]             # pos = S - 1; pos >= S (all valid)
    pos = torch.tensor(edges + [int(v) for v in torch.randint(
        0, 1000, (16 - len(edges),), generator=gen, device="cuda")],
        dtype=torch.int32, device="cuda")
    inputs = attn_inputs(gen, 16, 2, 8, 1000, 128, torch.bfloat16)
    for window, theta in ((0, 1e6), (0, 0.0), (200, 1e6)):
        worst = max(worst, check_decode_attention(
            inputs, pos, f"S=1000 ({nsplit} blocks per (b, h)) "
            f"window={window} rope_theta={theta}", window=window,
            rope_theta=theta))
        n += 1
    # a ring wrapped many times, the window longer than a 64-slot tile
    # and than a block's chunk (S=256: 4 blocks per (b, h))
    pos = torch.randint(256, 4096, (16,), generator=gen, device="cuda",
                        dtype=torch.int32)
    inputs = attn_inputs(gen, 16, 2, 8, 256, 128, torch.bfloat16)
    for window in (200, 256):
        worst = max(worst, check_decode_attention(
            inputs, pos, f"SWA ring S=256 window={window}", window=window,
            rope_theta=1e6, softcap=30.0))
        n += 1
    # G=16 and hd=256 (f32 caches: 152 KB of dynamic shared memory), hd=6
    # (rows of 12 bytes: the element-wise tile loads), and B*Hkv=320 (one
    # block per (b, h), no combine) at S=512
    for (b_, g_, s_, hd_, dt) in ((4, 16, 512, 256, torch.bfloat16),
                                  (4, 16, 512, 256, torch.float32),
                                  (4, 8, 300, 6, torch.bfloat16),
                                  (160, 8, 512, 128, torch.bfloat16)):
        pos = torch.randint(0, 2 * s_, (b_,), generator=gen, device="cuda",
                            dtype=torch.int32)
        pos[0] = s_ - 1
        inputs = attn_inputs(gen, b_, 2, g_, s_, hd_, dt)
        for window in (0, 100):
            worst = max(worst, check_decode_attention(
                inputs, pos, f"B={b_} G={g_} S={s_} hd={hd_} {dt} "
                f"window={window}", window=window, rope_theta=1e6))
            n += 1
    inputs = attn_inputs(gen, 4, 2, 4, 64, 128, torch.float32)
    pos = torch.tensor([1, 9, 63, 30], dtype=torch.int32, device="cuda")
    worst = max(worst, check_decode_attention(inputs, pos, "f32 caches",
                                              rope_theta=1e6))
    n += 1
    # a negative position writes nothing and, every slot masked, returns
    # the mean of the row's S value rows (one block at S=16, eight at 1000)
    for s_ in (16, 1000):
        inputs = attn_inputs(gen, 16, 2, 8, s_, 128, torch.bfloat16)
        pos = torch.tensor([-1, 3] * 8, dtype=torch.int32, device="cuda")
        for window in (0, 8):
            worst = max(worst, check_decode_attention(
                inputs, pos, f"pos -1 at S={s_} window={window}",
                window=window, rope_theta=1e6))
            n += 1
        o = ops.decode_attention(*inputs, pos, rope_theta=1e6)[0]
        mean_v = inputs[4][0].float().mean(dim=1)            # (Hkv, hd)
        err = rel_err(o[0].reshape(2, 8, 128), mean_v[:, None].expand(
            2, 8, 128))
        if not err <= ATTN_REL:
            fail(f"decode_attention at pos -1, S={s_}: o is not the mean of "
                 f"V ({err:.3e})")
    # the main path's shape: 16 slots, qwen2.5-3b's 2 kv heads x 8 queries
    b, hkv, g, hd = 16, 2, 8, 128
    at = {}
    for s in (512, 1024):
        inputs = attn_inputs(gen, b, hkv, g, s, hd, torch.bfloat16)
        pos = torch.randint(0, s, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
        pos[0], pos[1] = 0, s - 1
        worst = max(worst, check_decode_attention(
            inputs, pos, f"the main path's shape at S={s}",
            rope_theta=1e6))
        n += 1
        q, kn, vn, ck, cv = inputs

        def fused():
            return ops.decode_attention(q, kn, vn, ck, cv, pos,
                                        rope_theta=1e6)

        def plain():
            return ref.decode_attention_ref(q, kn, vn, ck, cv, pos,
                                            rope_theta=1e6)
        qb = q.to(torch.bfloat16)
        mask = decode_slot_validity(pos, s)[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qb, ck, cv, attn_mask=mask,
                                                  enable_gqa=True)
        # what this run's data needs: the valid slots of each row (j <=
        # pos) read once, q, the new token and cos/sin read, o and the
        # written slot stored
        slots = int(mask.sum())
        small = 4 * (2 * b * hkv * g * hd + 2 * b * hkv * hd + b * hd) \
            + 4 * b + 2 * b * hkv * hd * ck.element_size()
        bytes_ms = (2 * slots * hkv * hd * ck.element_size() + small) \
            / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * slots * hkv * g * hd / F32_OPS_PER_S * 1e3
        tables = layers.rope_tables(pos, hd, 1e6)
        at[s] = {"ms": time_ms(fused), "plain_ms": time_ms(plain),
                 "library_ms": time_ms(sdpa),
                 "library_device_ms": device_ms(sdpa),
                 "device_ms": device_ms(fused, "decode_attention"),
                 "host_us": host_us(fused),
                 "host_us_tables_given": host_us(
                     lambda: ops.decode_attention(q, kn, vn, ck, cv, pos,
                                                  rope_theta=1e6,
                                                  rope_tables=tables)),
                 "rope_tables_host_us": host_us(
                     lambda: layers.rope_tables(pos, hd, 1e6)),
                 "library_host_us": host_us(sdpa),
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        t = at[s]
        log(f"kernel: decode_attention at B={b} Hkv={hkv} G={g} hd={hd} "
            f"S={s} bf16: {t['ms']:.4f} ms (device only: "
            f"{t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
            f"SDPA over the written cache {t['library_ms']:.4f} ms (device "
            f"only: {t['library_device_ms']:.4f} ms), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}); host per call: "
            f"{t['host_us']:.1f} us ({t['host_us_tables_given']:.1f} us with "
            f"the step's RoPE tables given, which cost "
            f"{t['rope_tables_host_us']:.1f} us), SDPA "
            f"{t['library_host_us']:.1f} us")
    log(f"kernel: decode_attention == plain version on {n} cases (caches "
        f"bitwise, o within {ATTN_REL} of max(1, |plain|); worst "
        f"{worst:.3e})")
    t = at[512]
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:110",
            "launches": 0, "max_abs_err": worst,
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "at": f"B={b} Hkv={hkv} G={g} hd={hd} S=512 bf16",
            "at_s": {str(k): v for k, v in at.items()}}


def sampler_margins(logits, temp, top_k, top_p, k_cap: int):
    """(B,) distance of the nearest exclusive mass to its top_p, from
    the plain sampler's arithmetic (inf for rows that do not sample)."""
    import torch
    from repro_torch.kernels.topk_logits.ref import topk_logits_ref
    vals, _ = topk_logits_ref(logits, k_cap)
    safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
    sv = vals / safe_t[:, None]
    e = torch.exp(sv - sv[:, :1])
    p = e / e.sum(dim=1, keepdim=True)
    excl = torch.cumsum(p, dim=1) - p
    rank = torch.arange(k_cap, device=logits.device)
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, max=k_cap),
                        torch.full_like(top_k, k_cap))
    d = (excl - top_p[:, None]).abs()
    d = torch.where(rank[None, :] < k_eff[:, None], d, float("inf"))
    d = d.min(dim=1).values
    return torch.where(temp > 0, d, float("inf"))


def sampler_logits(gen, b: int, v: int, kind: str):
    """(B, V) card logits: continuous, tie-heavy (quantised), or all ±0
    (random signs) but for one value in 50."""
    import torch
    x = torch.randn((b, v), generator=gen, device="cuda") * 3
    if kind == "ties":
        return torch.round(x) * 0.5
    if kind == "zeros":
        sign = torch.rand((b, v), generator=gen, device="cuda") < 0.5
        z = torch.where(sign, -0.0, 0.0)
        few = torch.rand((b, v), generator=gen, device="cuda") < 0.02
        return torch.where(few, x, z)
    return x


def check_topk_sample(x, samp, kc: int, what: str):
    """``topk_sample`` against its plain version on (B, V) logits ``x``:
    greedy where ``samp`` is None, else ``samp`` is (temperature, top_k,
    top_p, seeds, pos) and the plain version draws ``gumbel_rows`` of the
    seeds and positions.  vals bitwise with their sign bits, idx exact,
    greedy tokens argmax, sampled tokens equal away from top_p
    boundaries.  Returns (the kernel's output, the rows whose excl lies
    within EXCL_WINDOW of top_p, the tokens that moved there)."""
    import torch
    from repro_torch.kernels.topk_sample import ops, ref
    greedy = samp is None
    if greedy:
        out = ops.topk_sample(x, k_cap=kc, greedy=True)
        rv, ri, rt = ref.topk_sample_ref(x, k_cap=kc, greedy=True)
    else:
        temp, top_k, top_p, seeds, pos = samp
        out = ops.topk_sample(x, temp, top_k, top_p, seeds, pos, k_cap=kc)
        rv, ri, rt = ref.topk_sample_ref(x, temp, top_k, top_p,
                                         ops.gumbel_rows(seeds, pos, kc),
                                         k_cap=kc)
    kv, ki, kt = out
    if not (torch.equal(kv.view(torch.int32), rv.view(torch.int32))
            and torch.equal(ki, ri)):
        fail(f"topk_sample vals/idx differ from the plain version at {what} "
             f"(sign bits included)")
    if greedy and not torch.equal(kt, torch.argmax(x, dim=1).to(torch.int32)):
        fail(f"greedy topk_sample != argmax at {what}")
    differ = kt != rt
    near = torch.zeros_like(differ)
    if not greedy:
        near = sampler_margins(x, temp, top_k, top_p, kc) <= EXCL_WINDOW
    if bool((differ & ~near).any()):
        fail(f"topk_sample tokens differ from the plain version away from "
             f"top_p boundaries at {what}")
    return out, int(near.sum()), int(differ.sum())


def phase_topk_sample() -> dict:
    import torch
    from repro_torch.kernels.topk_logits import kernel as stage1
    from repro_torch.kernels.topk_logits.ref import tile_width
    from repro_torch.kernels.topk_sample import kernel, ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    n = boundary = moved = 0
    # V = 20: k_cap = V < 32, one run; 97: one short tile; 262,144: 128
    # runs, the most a warp keeps in registers; past it runs wait in shared
    # memory: 129 runs, and 2,048 at k_cap = 4 (C = 8,192, the kernel's
    # limit, as at V = 524,288 and k_cap = 32)
    grid = [(v, min(ops.K_CAP_DEFAULT, v), (1, 16, 128))
            for v in (20, 97, 512, 32_000, 151_936, 262_144, 262_145)]
    grid += [(524_288, 32, (1, 16)), (4_194_304, 4, (1, 16))]
    for v, kc, batches in grid:
        for b in batches:
            for kind in ("continuous", "ties", "zeros"):
                x = sampler_logits(gen, b, v, kind)
                temp = torch.rand((b,), generator=gen, device="cuda") + 0.5
                temp[::4] = 0.0                      # greedy sentinel rows
                temp[1::8] = -1.0
                top_k = torch.randint(0, 40, (b,), generator=gen,
                                      device="cuda", dtype=torch.int32)
                top_p = torch.rand((b,), generator=gen, device="cuda") * 0.5 \
                    + 0.5
                seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen,
                                      device="cuda", dtype=torch.int32)
                pos = torch.randint(0, 4096, (b,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                for greedy in (True, False):
                    _, near, differ = check_topk_sample(
                        x, None if greedy else (temp, top_k, top_p, seeds,
                                                pos), kc,
                        f"V={v} k_cap={kc} B={b} {kind} greedy={greedy}")
                    boundary += near
                    moved += differ
                    n += 1
    log(f"kernel: topk_sample == plain version on {n} cases (vals bitwise "
        f"with sign bits, idx exact, tokens equal; {boundary} rows with an "
        f"excl within {EXCL_WINDOW} of top_p, {moved} tokens moved there)")
    try:                                 # 257 runs of 32: C = 8,224
        ops.topk_sample(sampler_logits(gen, 1, 524_289, "continuous"),
                        greedy=True)
        fail("topk_sample took C = 8224 candidates, past its limit")
    except ValueError:
        pass

    b, v, k = 16, 151_936, ops.K_CAP_DEFAULT
    x = torch.randn((b, v), generator=gen, device="cuda") * 3
    temp = torch.full((b,), 0.8, device="cuda")
    top_k = torch.full((b,), 20, dtype=torch.int32, device="cuda")
    top_p = torch.full((b,), 0.9, device="cuda")
    seeds = torch.arange(b, dtype=torch.int32, device="cuda")
    pos = torch.full((b,), 100, dtype=torch.int32, device="cuda")
    noise = ops.gumbel_rows(seeds, pos, k)
    vt = tile_width(v)
    cand_v, cand_i = stage1.topk_logits_tiles(x, k, vt)

    def stage2():
        return kernel.topk_sample_tiles(cand_v, cand_i, temp, top_k, top_p,
                                        noise, k_cap=k)
    one = torch.empty((1,), device="cuda")
    row = {"name": "topk_sample", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/topk_sample.cu",
           "replaces": "src/repro/kernels/topk_sample/kernel.py:91",
           "launches": 0, "max_abs_err": 0.0,
           **topk_sample_times(x, (temp, top_k, top_p, seeds, pos), k),
           "stage1_ms": time_ms(lambda: stage1.topk_logits_tiles(x, k, vt)),
           "stage1_device_ms": device_ms(
               lambda: stage1.topk_logits_tiles(x, k, vt),
               "topk_tiles_kernel"),
           "stage2_host_us": host_us(stage2),
           # the card's practical floor for one launch's device time
           "launch_floor_device_ms": device_ms(lambda: one.fill_(0.0)),
           # stage 2's merge alone as one PyTorch call (no sampling)
           "merge_topk_ms": time_ms(lambda: torch.topk(cand_v, k, dim=-1)),
           "merge_topk_device_ms": device_ms(
               lambda: torch.topk(cand_v, k, dim=-1)),
           "at": f"B={b} V={v} k_cap={k}, sampled"}
    log(f"kernel: topk_sample at {row['at']}: stage 1 + 2 {row['ms']:.4f} ms "
        f"(device only {row['device_ms']:.4f} ms); stage 1 "
        f"{row['stage1_ms']:.4f} ms (device {row['stage1_device_ms']:.4f}); "
        f"stage 2 {row['stage2_ms']:.4f} ms (device "
        f"{row['stage2_device_ms']:.4f}, host {row['stage2_host_us']:.1f} us "
        f"a call; bound {row['stage2_bound_ms']:.5f} ms (bytes); launch "
        f"floor, a one-element fill: device "
        f"{row['launch_floor_device_ms']:.4f} ms; merge-only yardstick "
        f"torch.topk over the ({b}, {cand_v.shape[1]}) candidates "
        f"{row['merge_topk_ms']:.4f} ms, device "
        f"{row['merge_topk_device_ms']:.4f}); with the threefry noise "
        f"{row['with_noise_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms, "
        f"torch.topk {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms (bytes)")
    return row


def topk_sample_times(x, samp, k: int) -> dict:
    """Sampled ``topk_sample`` on (B, V) logits ``x`` with ``samp`` =
    (temperature, top_k, top_p, seeds, pos), timed: both stages on the
    call's Gumbel noise (``ms``), stage 2 alone on stage 1's candidates
    beside its bound, the whole op with the threefry noise, the plain
    version and ``torch.topk``.  Bounds are bytes: stage 1 + 2 read the
    logits and write vals, ids and tokens once; stage 2 reads its
    candidates (value and id), the knobs and the noise."""
    import torch
    from repro_torch.kernels.topk_logits import kernel as stage1
    from repro_torch.kernels.topk_logits.ref import tile_width
    from repro_torch.kernels.topk_sample import kernel, ops, ref
    temp, top_k, top_p, seeds, pos = samp
    b, v = x.shape
    noise = ops.gumbel_rows(seeds, pos, k)
    vt = tile_width(v)
    cand_v, cand_i = stage1.topk_logits_tiles(x, k, vt)

    def both():
        cv, ci = stage1.topk_logits_tiles(x, k, vt)
        return kernel.topk_sample_tiles(cv, ci, temp, top_k, top_p, noise,
                                        k_cap=k)

    def stage2():
        return kernel.topk_sample_tiles(cand_v, cand_i, temp, top_k, top_p,
                                        noise, k_cap=k)
    return {"ms": time_ms(both), "device_ms": device_ms(both, "_kernel"),
            "stage2_ms": time_ms(stage2),
            "stage2_device_ms": device_ms(stage2, "topk_sample_kernel"),
            "stage2_bound_ms": (cand_v.numel() * 8 + b * (3 + k) * 4
                                + b * (2 * k + 1) * 4) / HBM_BYTES_PER_S
            * 1e3,
            "with_noise_ms": time_ms(lambda: ops.topk_sample(x, *samp,
                                                             k_cap=k)),
            "plain_ms": time_ms(lambda: ref.topk_sample_ref(
                x, temp, top_k, top_p, noise, k_cap=k)),
            "library_ms": time_ms(lambda: torch.topk(x, k, dim=-1)),
            "bound_ms": (b * v * 4 + b * (2 * k + 1) * 4) / HBM_BYTES_PER_S
            * 1e3,
            "bound_by": "bytes"}


# ------------------------------------------------- full-sequence attention

SWA_MAIN = (2, 32, 8, 120)         # prefill: B, Hq, Hkv, hd (h2o-danube-3-4b)
SWA_WINDOW = 4096


def swa_plain(q, k, v, window: int, softcap: float = 0.0, positions=None):
    """The plain version (ref.py, full (S, S) mask, by index or by
    ``positions``) on every output row, one (batch row, kv head) slice at
    a time: at S=8192 the whole batch's scores would take 17 GB per
    copy."""
    import torch
    from repro_torch.kernels.swa_attention import ref
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for bi in range(b):
        for h in range(hkv):
            kk = k[bi:bi + 1, h:h + 1].expand(1, g, s, hd)
            vv = v[bi:bi + 1, h:h + 1].expand(1, g, s, hd)
            out[bi:bi + 1, h * g:(h + 1) * g] = ref.swa_attention_ref(
                q[bi:bi + 1, h * g:(h + 1) * g], kk, vv, window,
                softcap=softcap, positions=positions)
    return out


def swa_inputs(gen, b, hq, hkv, s, hd, dtype=None):
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            dtype or torch.float32)
    return rnd(b, hq, s, hd), rnd(b, hkv, s, hd), rnd(b, hkv, s, hd)


def check_swa(inputs, window: int, what: str, softcap: float = 0.0,
              positions=None):
    """``swa_attention`` on card tensors against its plain version: o
    within ATTN_REL of max(1, |plain|) on every row.  Returns (error,
    kernel output)."""
    import torch
    from repro_torch.kernels.swa_attention import ops
    q, k, v = inputs
    ko = ops.swa_attention(q, k, v, window, softcap=softcap,
                           positions=positions)
    ro = swa_plain(q, k, v, window, softcap, positions)
    torch.cuda.synchronize()
    if ko.shape != ro.shape or ko.dtype != torch.float32:
        fail(f"swa_attention o {tuple(ko.shape)} {ko.dtype} at {what}")
    err = rel_err(ko, ro)
    if not err <= ATTN_REL:
        fail(f"swa_attention differs from its plain version at {what}: "
             f"{err:.3e} > {ATTN_REL} of max(1, |plain|)")
    return err, ko


def swa_bound(b, hq, hkv, s, hd, window: int):
    """(bound ms, what bounds it, the CUDA-core figure ms): 4 * hd flops
    per visible (query, key) pair at the float32-accurate tensor-core
    rate (3xTF32), against q, k, v read once and o written once.  The
    third value is the same flops at the f32 CUDA-core rate."""
    w = min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w
    flops = 4 * hd * pairs * b * hq
    ops_ms = flops / TF32X3_OPS_PER_S * 1e3
    bytes_ms = 4 * (2 * b * hq + 2 * b * hkv) * s * hd / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), \
        flops / F32_OPS_PER_S * 1e3


def sdpa_band(q, k, v, window: int):
    """(backend, fn): one ``scaled_dot_product_attention`` call with the
    band mask and ``enable_gqa``, on the first backend that takes it (the
    fused ones refuse f32 with fewer kv heads, then the math backend
    computes all (S, S) scores)."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    s = q.shape[2]
    i = torch.arange(s, device="cuda")[:, None]
    j = torch.arange(s, device="cuda")[None, :]
    mask = (j <= i) & (i - j < window)
    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # each refusal's reasons
                call()
        except RuntimeError as e:            # this backend refuses the call
            log(f"kernel: SDPA {backend.name} refused: {str(e)[:80]}")
            continue
        return backend.name, call
    fail("no SDPA backend takes the band-masked GQA call")


def sdpa_repeated(q, k, v, window: int, *, causal: bool = False):
    """The efficient SDPA backend over k and v repeated G-fold beforehand
    (the repeat is not timed): one fused call for the same function,
    which ``enable_gqa`` rules out in f32.  With the band mask, or with
    ``causal`` (a window of at least S) as ``is_causal=True`` and no
    mask, which skips the upper triangle.  None if the backend refuses
    it."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    s, g = q.shape[2], q.shape[1] // k.shape[1]
    i = torch.arange(s, device="cuda")[:, None]
    j = torch.arange(s, device="cuda")[None, :]
    mask = None if causal else (j <= i) & (i - j < window)
    kr = k.repeat_interleave(g, dim=1)
    vr = v.repeat_interleave(g, dim=1)

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask,
                                                  is_causal=causal)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            call()
    except RuntimeError as e:
        log(f"kernel: SDPA EFFICIENT_ATTENTION over repeated kv "
            f"{'is_causal ' if causal else ''}refused: {str(e)[:80]}")
        return None
    return call


def swa_times(inputs, window: int, err: float, sdpa, backend: str,
              bound) -> dict:
    """``swa_attention`` at a model's shape, already held to its plain
    version within ``err``: timed beside the plain version and the
    library call ``sdpa`` (``backend`` names it), with ``bound`` =
    (bound ms, what bounds it)."""
    from repro_torch.kernels.swa_attention import ops as swa_ops
    q, k, v = inputs

    def call():
        return swa_ops.swa_attention(q, k, v, window)
    return {"ms": time_ms(call, runs=10),
            "device_ms": device_ms(call, "swa_", runs=5),
            "plain_ms": time_ms(lambda: swa_plain(q, k, v, window), runs=2,
                                warmup=1),
            "library_ms": time_ms(sdpa, runs=10), "library_backend": backend,
            "bound_ms": bound[0], "bound_by": bound[1], "max_abs_err": err}


def phase_swa_attention() -> dict:
    import torch
    from repro_torch.kernels.swa_attention import kernel, ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    n, worst = 0, 0.0
    for s in (64, 300, 1024, 8192):
        for hd in (64, 80, 120, 128):
            for g in (1, 4, 8):
                inputs = swa_inputs(gen, 2, 2 * g, 2, s, hd)
                for window in (64, 100, 4096, s + 1):
                    for cap in (0.0, 30.0):
                        worst = max(worst, check_swa(
                            inputs, window, f"S={s} hd={hd} G={g} "
                            f"window={window} softcap={cap}", cap)[0])
                        n += 1
    # head dims off the tiles: hd=100 (not a multiple of 8, zero-padded to
    # the 120 tiles) and hd=256 (the smaller tile of the same design)
    for s in (64, 300):
        for hd in (100, 256):
            for g in (1, 4):
                inputs = swa_inputs(gen, 2, 2 * g, 2, s, hd)
                for window in (64, s + 1):
                    for cap in (0.0, 30.0):
                        worst = max(worst, check_swa(
                            inputs, window, f"S={s} hd={hd} G={g} "
                            f"window={window} softcap={cap}", cap)[0])
                        n += 1
    inputs = swa_inputs(gen, 2, 8, 2, 300, 120, torch.bfloat16)
    worst = max(worst, check_swa(inputs, 100, "bf16 inputs S=300 hd=120 G=4 "
                                 "window=100")[0])
    n += 1
    # locality: NaN keys and values before the band of the last query
    # tile reach none of its rows (nothing outside the band is read)
    s, w = 1000, 100
    q, k, v = swa_inputs(gen, 1, 4, 2, s, 64)
    q0 = (s - 1) // kernel.Q_TILE * kernel.Q_TILE
    o1 = ops.swa_attention(q, k, v, w)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, :q0 - w + 1] = float("nan")
    v2[:, :, :q0 - w + 1] = float("nan")
    o2 = ops.swa_attention(q, k2, v2, w)
    if not same_bits(o1[:, :, q0:], o2[:, :, q0:]):
        fail("swa_attention: keys before the last tile's band changed its "
             "output")
    log(f"kernel: swa_attention == plain version on {n} cases (o within "
        f"{ATTN_REL} of max(1, |plain|); worst {worst:.3e}); keys before the "
        f"band of the last query tile (NaN) change none of its {s - q0} rows "
        f"(bitwise)")

    b, hq, hkv, hd = SWA_MAIN
    at = {}
    for s in (8192, 2048):
        window = SWA_WINDOW if s > SWA_WINDOW else s   # as attention_apply
        inputs = swa_inputs(gen, b, hq, hkv, s, hd)
        err, ko = check_swa(inputs, window, f"the prefill path's shape S={s}")
        worst = max(worst, err)
        q, k, v = inputs
        backend, sdpa = sdpa_band(q, k, v, window)
        lib = sdpa()
        gqa_ms = time_ms(sdpa, runs=5, warmup=1)
        gqa_err = rel_err(lib.float(), ko)
        del lib
        rep = sdpa_repeated(q, k, v, window)
        rep_ms = rep_err = None
        if rep is not None:
            rep_err = rel_err(rep().float(), ko)
            rep_ms = time_ms(rep, runs=5, warmup=1)
        causal = causal_ms = causal_err = None
        if window >= s:
            causal = sdpa_repeated(q, k, v, window, causal=True)
        if causal is not None:
            causal_err = rel_err(causal().float(), ko)
            causal_ms = time_ms(causal, runs=5, warmup=1)
        bound_ms, by, bound_cc = swa_bound(b, hq, hkv, s, hd, window)
        # library_ms is the fastest of the single SDPA calls
        best = (gqa_ms, f"{backend} (enable_gqa)", gqa_err)
        if rep_ms is not None and rep_ms < best[0]:
            best = (rep_ms, "EFFICIENT_ATTENTION (kv repeated)", rep_err)
        if causal_ms is not None and causal_ms < best[0]:
            best = (causal_ms, "EFFICIENT_ATTENTION is_causal (kv repeated)",
                    causal_err)

        def call():
            return ops.swa_attention(q, k, v, window)
        at[s] = {"ms": time_ms(call),
                 "device_ms": device_ms(call, "swa_", runs=5),
                 "prepass_device_ms": device_ms(call, "swa_split_kv",
                                                runs=5),
                 "plain_ms": time_ms(lambda: swa_plain(q, k, v, window),
                                     runs=3, warmup=1),
                 "library_ms": best[0], "library_backend": best[1],
                 "library_err": best[2],
                 "library_gqa_ms": gqa_ms, "library_gqa_backend": backend,
                 "library_repeated_ms": rep_ms,
                 "library_repeated_err": rep_err,
                 "library_causal_ms": causal_ms,
                 "library_causal_err": causal_err,
                 "bound_ms": bound_ms, "bound_by": by,
                 "bound_cuda_core_ms": bound_cc, "window": window,
                 "max_abs_err": err}
        t = at[s]
        rep_txt = ("refused" if rep_ms is None else
                   f"{rep_ms:.4f} ms (o within {rep_err:.2e} of the kernel's)")
        causal_txt = ("" if causal_ms is None else
                      f", the same with is_causal=True and no mask "
                      f"{causal_ms:.4f} ms (o within {causal_err:.2e})")
        log(f"kernel: swa_attention at B={b} Hq={hq} Hkv={hkv} hd={hd} S={s} "
            f"window={window}: {t['ms']:.4f} ms (device only, both launches: "
            f"{t['device_ms']:.4f} ms, the prepass "
            f"{t['prepass_device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
            f"SDPA ({backend}, band mask, enable_gqa) {gqa_ms:.4f} ms (o "
            f"within {gqa_err:.2e} of the kernel's), SDPA "
            f"EFFICIENT_ATTENTION over kv repeated {hq // hkv}-fold (repeat "
            f"untimed) {rep_txt}{causal_txt}; bound {bound_ms:.4f} ms ({by}, "
            f"3xTF32 on the tensor cores; on the CUDA cores "
            f"{bound_cc:.4f} ms)")
        del inputs, q, k, v, ko, rep, causal
    t = at[8192]
    return {"name": "swa_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/swa_attention.cu",
            "replaces": "src/repro/kernels/swa_attention/kernel.py:80",
            "launches": 0, "max_abs_err": worst,
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "bound_cuda_core_ms": t["bound_cuda_core_ms"],
            "library_ms": t["library_ms"],
            "library_backend": t["library_backend"],
            "at": f"B={b} Hq={hq} Hkv={hkv} hd={hd} S=8192 window="
                  f"{SWA_WINDOW} f32",
            "at_s": {str(k): v for k, v in at.items()}}


# ---------------------------------------------------------- token-LM serving

LM_ARCH = "qwen2.5-3b"
LM_LAYERS = 4                      # phase_lm's and the paged phase's depth,
                                   # of 36, every width kept: the drains are
                                   # host-bound at ~55 device ops a layer a
                                   # step; 36 layers took ~49 s and ~80 s
                                   # of the script's 1,200, 12 ~23 and ~26
LM_MAX_SEQ = 512


def lm_requests(cfg, n: int, rng):
    """``n`` requests of 16-256 prompt tokens and max_new 16-64: the even
    ones greedy, the odd ones sampled (temperature 0.8, top_k 20, top_p
    0.9, distinct seeds), two of them wide (top_k 0: full vocabulary,
    so mixed windows run)."""
    import numpy as np
    from repro_torch.serve import SamplingParams
    reqs = []
    for i in range(n):
        prompt = rng.integers(1, cfg.vocab_size,
                              int(rng.integers(16, 257))).astype(np.int32)
        samp = None
        if i % 2:
            samp = SamplingParams(temperature=0.8,
                                  top_k=0 if i in (1, 3) else 20, top_p=0.9,
                                  seed=1000 + i)
        reqs.append((prompt, int(rng.integers(16, 65)), samp))
    return reqs


def teacher_forced(model, seqs, steps: int, fn, cache_dtype=None,
                   seq_len: int = LM_MAX_SEQ):
    """Feed every row its own token sequence through ``model.decode_step``
    from a fresh per-row cache of ``seq_len`` slots (bf16 unless
    ``cache_dtype``) for ``steps`` steps (rows past their end feed 0)
    and collect ``fn(logits (B, V), step)`` on the device."""
    import numpy as np
    import torch
    b = len(seqs)
    tok = np.zeros((steps, b), np.int32)
    for i, s in enumerate(seqs):
        tok[:len(s), i] = s[:steps]
    tok = torch.from_numpy(tok).to(model.device)
    cache = model.init_cache(b, seq_len, cache_dtype or torch.bfloat16,
                             per_row=True)
    out = []
    for t in range(steps):
        logits, cache = model.decode_step(cache, tok[t][:, None])
        out.append(fn(logits[:, -1], t))
    return torch.stack(out)


def top2_gap(logits, _t):
    import torch
    top = torch.topk(logits, 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def first_divergence(a, b):
    """Index of the first differing token of two sequences, or None."""
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def phase_lm() -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve import (LATENCY, THROUGHPUT, SamplingParams,
                                   TokenServer)
    cfg = cut_depth(get_arch(LM_ARCH), LM_LAYERS)
    t0 = time.perf_counter()
    params = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 5)).state_dict()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host_params = {n: p.cpu() for n, p in params.items()}
    n_params = sum(p.numel() for p in params.values())
    log(f"lm: {LM_ARCH} at full widths, {cfg.n_layers} of 36 layers "
        f"({n_params / 1e9:.3f} B params, f32) drawn on the "
        f"card in {t1 - t0:.1f} s, copied to the host in "
        f"{time.perf_counter() - t1:.1f} s")
    rng = np.random.default_rng(SEED + 5)
    reqs = lm_requests(cfg, 32, rng)

    def server(decode_kernel=True, policy=THROUGHPUT, device="cuda",
               weights=None, cache_dtype=torch.bfloat16):
        return TokenServer(cfg, params if weights is None else weights,
                           policy=policy, max_seq=LM_MAX_SEQ,
                           decode_kernel=decode_kernel, device=device,
                           cache_dtype=cache_dtype)

    def drive(srv, todo):
        rids = [srv.submit(p, max_new=m, sampling=s) for p, m, s in todo]
        done = srv.drain()
        torch.cuda.synchronize()
        return rids, done

    warm = server()                  # cuBLAS, allocator, kernel libraries
    drive(warm, [(reqs[0][0][:16], 4, None), (reqs[1][0][:16], 4, reqs[1][2]),
                 (reqs[5][0][:16], 4, reqs[5][2])])
    srv = server()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    rids, done = drive(srv, reqs)
    dt = time.perf_counter() - t0
    counts = launch_counts()
    st = srv.stats
    gen = sum(len(done[r].out) for r in rids)
    fed = sum(p.shape[0] for p, _, _ in reqs) + gen
    for r, (p, m, _) in zip(rids, reqs):
        out = np.asarray(done[r].out)
        if len(out) != m or not ((out >= 0) & (out < cfg.vocab_size)).all():
            fail(f"lm: request {r} returned {len(out)} tokens (want {m}) "
                 f"or ids outside the vocabulary")
    for name in ("decode_attention", "topk_sample", "topk_logits"):
        if counts[name] == 0:
            fail(f"lm: the decode path launched no {name} kernel")
    if counts["decode_attention"] != cfg.n_layers * st["steps"]:
        fail(f"lm: {counts['decode_attention']} decode_attention launches "
             f"over {st['steps']} steps, want {cfg.n_layers} per step")
    log(f"lm: {len(reqs)} requests ({sum(s is None for *_, s in reqs)} "
        f"greedy), {gen} tokens generated in {dt:.3f} s = {gen / dt:.1f} "
        f"generated tokens/s, {fed / dt:.1f} fed tokens/s (prompt + "
        f"generated); {st['steps']} steps ({st['steps'] / dt:.1f} steps/s), "
        f"{st['syncs']} syncs, slot occupancy "
        f"{st['active_slot_steps'] / st['slot_steps']:.3f}; launches "
        f"decode_attention {counts['decode_attention']} "
        f"({counts['decode_attention'] / st['steps']:.0f} per step), "
        f"topk_sample {counts['topk_sample']}, topk_logits "
        f"{counts['topk_logits']}")
    # traced: one window of 16 steps on the drain's warm server, 16 rows
    # in flight (the first 16 requests, prompts cut to 64 tokens, max_new
    # to 32): reading a trace costs ~40 us an op, and re-serving the 16
    # requests whole under the profiler (96 steps, 0.19 M ops) took 10-13 s
    log("lm: the first 16 requests (prompts cut to 64, max_new to 32) on "
        "the drain's server, one window after their first, traced:")
    t0 = time.perf_counter()
    k, p = traced_window(srv, [(q[:64], min(m, 32), s)
                               for q, m, s in reqs[:16]])
    log(f"lm: traced wall {p['wall_ms']:.1f} ms, device busy "
        f"{p['busy_ms']:.1f} ms = {p['busy_ms'] / p['wall_ms']:.1%} (idle "
        f"{1 - p['busy_ms'] / p['wall_ms']:.1%}), {p['ops']} device ops")
    log(f"lm: {p['ops'] / k:.1f} device ops and {p['busy_ms'] / k:.3f} ms "
        f"of device time per step over {k} steps; tracing and reading the "
        f"trace took {time.perf_counter() - t0:.1f} s")

    # the RoPE tables: once per decode step, shared by the layers
    from repro_torch.models import layers
    tables = layers.rope_tables
    calls = []
    layers.rope_tables = lambda *a, **kw: calls.append(1) or tables(*a, **kw)
    try:
        cache = srv.model.init_cache(16, LM_MAX_SEQ, torch.bfloat16,
                                     per_row=True)
        before = launch_counts()["decode_attention"]
        srv.model.decode_step(cache, torch.zeros((16, 1), dtype=torch.int32,
                                                 device="cuda"))
        torch.cuda.synchronize()
        step_launches = launch_counts()["decode_attention"] - before
    finally:
        layers.rope_tables = tables
    if len(calls) != 1 or step_launches != cfg.n_layers:
        fail(f"lm: one decode_step computed the RoPE tables {len(calls)} "
             f"times and launched decode_attention {step_launches} times "
             f"(want 1 and {cfg.n_layers})")
    log(f"lm: one decode_step computes the RoPE tables once for its "
        f"{step_launches} decode_attention launches")

    # host re-check: two short requests through the port's TokenServer on
    # the host (same weights, plain versions) and on the card, with
    # float32 caches on both sides.  The served bf16 cache is no fit for
    # this comparison: when the two sides' float32 k/v differ in the last
    # bit (cuBLAS and the host BLAS sum in other orders), a bf16 entry
    # now and then rounds the other way, a 2**-8 relative step, and 36
    # layers amplify it; between the port and the JAX package on the
    # host that moves 36-layer logits by 4-7% of their size, against
    # 5e-5-7e-5 with float32 caches (the CPU measurement in PERF.md).
    t0 = time.perf_counter()
    short = [(reqs[0][0][:16], 8, None),
             (reqs[2][0][:16], 8, SamplingParams(temperature=0.8, top_k=20,
                                                 top_p=0.9, seed=7))]
    pair = dataclasses.replace(LATENCY, max_batch=2)
    card_srv = server(policy=pair, cache_dtype=torch.float32)
    card_rids, card_done = drive(card_srv, short)
    card_out = [card_done[r].out for r in card_rids]
    host_srv = server(policy=pair, device="cpu", weights=host_params,
                      cache_dtype=torch.float32)
    host_logits = []                 # the host server's own logits per step
    step_fn = host_srv.model.decode_step

    def recording(cache, tokens):
        logits, cache = step_fn(cache, tokens)
        host_logits.append(logits[:, -1].clone())
        return logits, cache
    host_srv.model.decode_step = recording
    hr = [host_srv.submit(p, max_new=m, sampling=s) for p, m, s in short]
    host_done = host_srv.drain()
    host_out = [host_done[r].out for r in hr]
    steps = 16 + 8 - 1               # every fed position of both rows
    host_logits = torch.stack(host_logits[:steps])           # (steps, 2, V)
    seqs = [np.concatenate([p, np.asarray(o[:-1], np.int32)])
            for (p, _, _), o in zip(short, host_out)]
    card_logits = teacher_forced(card_srv.model, seqs, steps,
                                 lambda lg, t: lg.clone(),
                                 cache_dtype=torch.float32).cpu()
    lerr = rel_err(card_logits, host_logits)
    if not lerr <= LM_LOGIT_REL:
        fail(f"lm: card vs host teacher-forced logits {lerr:.3e} > "
             f"{LM_LOGIT_REL} of max(1, |host|)")
    gaps = top2_gap(host_logits.reshape(-1, cfg.vocab_size), 0) \
        .reshape(steps, len(seqs))
    for i, ((p, _, s), a, h) in enumerate(zip(short, card_out, host_out)):
        j = first_divergence(a, h)
        if j is not None:
            gap = float(gaps[p.shape[0] - 1 + j, i])
            if s is not None or gap > GAP:
                fail(f"lm: card and host tokens of request {i} differ at "
                     f"token {j}, top-2 gap {gap:.3e}")
    log(f"lm: 2 short requests (prompt 16, max_new 8; greedy and sampled) "
        f"through TokenServer on the card and the port's TokenServer on "
        f"the host (plain versions), float32 caches: tokens equal away "
        f"from near-ties; the card's teacher-forced logits within "
        f"{LM_LOGIT_REL} of max(1, |host|) of the host server's (worst "
        f"{lerr:.3e}) [{time.perf_counter() - t0:.1f} s]")

    # card re-check: the greedy requests through the non-fused path, both
    # with the served bf16 cache.  The fused and plain tails sum in other
    # orders, so the bf16 rounding argument above applies here too: a
    # token may move only where the top-2 gap is within BF16_DRIFT of the
    # top logit.  The 4 shortest greedy requests (the re-run's steps are
    # the longest request's prompt and new tokens)
    t0 = time.perf_counter()
    greedy = sorted(((i, r) for i, r in enumerate(reqs) if r[2] is None),
                    key=lambda ir: ir[1][0].shape[0] + ir[1][1])[:4]
    plain_rids, plain_done = drive(server(decode_kernel=False),
                                   [r for _, r in greedy])
    plain_out = [plain_done[r].out for r in plain_rids]
    apart = [(col, i, p, j) for col, ((i, (p, _, _)), o) in enumerate(
        zip(greedy, plain_out))
        if (j := first_divergence(done[rids[i]].out, o)) is not None]
    if apart:
        # the non-fused run's own top-2 margins, teacher-forced over its
        # tokens: read only where a token moved
        seqs = [np.concatenate([reqs[i][0], np.asarray(o[:-1], np.int32)])
                for (i, _), o in zip(greedy, plain_out)]
        plain_model = build_model(cfg, device="cuda", params=params)

        def margin(logits, _t):
            top = torch.topk(logits, 2, dim=-1).values
            return torch.stack([top[:, 0] - top[:, 1], top[:, 0].abs()], -1)
        margins = teacher_forced(plain_model, seqs,
                                 max(len(x) for x in seqs), margin).cpu()
        for col, i, p, j in apart:
            gap, top = margins[p.shape[0] - 1 + j, col].tolist()
            if gap > max(GAP, BF16_DRIFT * top):
                fail(f"lm: fused and non-fused greedy tokens differ at "
                     f"token {j} of request {i}, top-2 gap {gap:.3e}")
    near = len(apart)
    log(f"lm: {len(greedy)} greedy requests re-run on the card with "
        f"decode_kernel=False: tokens equal ({near} diverged at a near-tie)"
        f" [{time.perf_counter() - t0:.1f} s]")
    LM_WEIGHTS["params"] = params        # phase_paged serves them next
    return counts


# ------------------------------------------------------------ paged serving

PAGED_LM = dict(page_size=16, n_pages=384, max_ctx=512)    # qwen2.5-3b
PAGED_PREFIX = 64                  # tokens the 8 prefix requests share
PAGED_GEMMA = dict(page_size=16, n_pages=280, max_ctx=1120)  # 4 x 70 pages
PAGED_GEMMA_KEEP = (0, 5)          # gemma3-27b: its (5 local, global)
                                   # group's first local layer and the
                                   # global one
PAGED_WIDE = dict(page_size=16, n_pages=16, max_ctx=64)    # 4 x 4 pages
PAGED_NEAR_TIE = LM_LOGIT_REL      # share of max(1, |top|) within which the
                                   # top-2 gap lets two float32 decodes pick
                                   # other tokens: the paged path ropes k
                                   # before the pool, the contiguous fused
                                   # path inside the kernel
LM_WEIGHTS = {}                    # phase_lm's qwen2.5-3b weights, kept on
                                   # the card for phase_paged
PAGED_TIMES = {}                   # decode_attention(write=False) at the
                                   # paged shape, for the kernel's row
PAGED_TAP_STEP = 330               # qwen2.5-3b: the decode step whose
                                   # decode_attention inputs are held to
                                   # the plain version (16 rows in flight
                                   # at other positions, four of them
                                   # started at a prefix hit)
PAGED_GEMMA_TAP_STEP = 1060        # gemma3-27b: every ring has wrapped
PAGED_WIDE_TAP_STEP = 20           # deepseek-67b, chameleon-34b


def paged_requests(cfg, rng, page_size: int, sync_every: int):
    """Traffic for the paged qwen2.5-3b server: 16 requests of 256-448
    prompt and 16-64 new tokens (lm_requests' kind, longer, so that 16
    slots ask for more than the pool's 384 pages and the 16th waits for
    the first retirement; the odd ones sampled at top_k 20), then 8
    greedy requests of 8-32 tokens of their own after a 64-token prefix
    (4 sharable pages) and max_new 16.  The prefix is the prompt head of
    the long request that retires second.  The first retirement admits
    the 16th request (whose pages evict the first retiree's parked ones)
    and the first prefix request, which misses; the source publishes its
    prompt pages in the next window, and from then on a prefix request
    holds them live, so the other 7 find them: 28 hits.  Returns
    (requests, the prefix requests' indices)."""
    import numpy as np
    from repro_torch.serve import SamplingParams
    reqs = []
    for i in range(16):
        prompt = rng.integers(1, cfg.vocab_size,
                              int(rng.integers(256, 449))).astype(np.int32)
        samp = None
        if i % 2:
            samp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                                  seed=2000 + i)
        reqs.append((prompt, int(rng.integers(16, 65)), samp))
    # a request retires in the window after its last step
    done = [-(-(p.shape[0] + m - 1) // sync_every) for p, m, _ in reqs[:15]]
    first, second = sorted(range(15), key=lambda i: done[i])[:2]
    if done[first] == done[second]:
        fail(f"paged: requests {first} and {second} retire in one window; "
             f"the prefix pages would be evicted")
    pre = reqs[second][0][:PAGED_PREFIX]
    for _ in range(8):
        tail = rng.integers(1, cfg.vocab_size,
                            int(rng.integers(8, 33))).astype(np.int32)
        reqs.append((np.concatenate([pre, tail]), 16, None))
    return reqs, list(range(16, 24))


def near_ties(model, reqs, ref_outs, outs, what: str, seq_len: int) -> int:
    """Hold greedy ``outs`` to ``ref_outs`` (both float32-cache runs of
    the same requests): equal, or first apart where the top-2 gap of
    ``model``'s teacher-forced logits over the reference's sequence is
    within PAGED_NEAR_TIE of max(1, |top|).  Returns how many requests
    parted at a near-tie."""
    import numpy as np
    import torch
    apart = [(i, j) for i, (a, b) in enumerate(zip(ref_outs, outs))
             if reqs[i][2] is None
             and (j := first_divergence(a, b)) is not None]
    if not apart:
        return 0
    seqs = [np.concatenate([reqs[i][0], np.asarray(ref_outs[i][:-1],
                                                    np.int32)])
            for i, _ in apart]

    def margin(logits, _t):
        top = torch.topk(logits, 2, dim=-1).values
        return torch.stack([top[:, 0] - top[:, 1], top[:, 0].abs()], -1)
    margins = teacher_forced(model, seqs, max(len(s) for s in seqs), margin,
                             cache_dtype=torch.float32,
                             seq_len=seq_len).cpu()
    for col, (i, j) in enumerate(apart):
        gap, top = margins[reqs[i][0].shape[0] - 1 + j, col].tolist()
        if gap > max(GAP, PAGED_NEAR_TIE * max(1.0, top)):
            fail(f"paged: {what}: greedy tokens of request {i} differ at "
                 f"token {j}, top-2 gap {gap:.3e}")
    return len(apart)


def kernel_shares(by_name: dict, steps: int) -> dict:
    """Device ms and ops a step of a traced window's ops, sorted by name
    into kinds: the decode_attention kernel, index copies (the paged
    pool writes), other index and gather ops, other copies, the matrix
    products, and the rest.  A kind holds every op of its names, the
    contiguous path's too (the embedding lookup, the wrappers' copies):
    ``phase_paged`` reads the paged path's cost as the difference from
    a contiguous server's trace of the same window."""
    kinds = {}
    for name, (n, ms) in by_name.items():
        low = name.lower()
        if "decode_attention" in low:
            kind = "decode_attention"
        elif "index_copy" in low or "indexcopy" in low:
            kind = "index_copy"
        elif "index" in low or "gather" in low:
            kind = "index"
        elif "copy" in low:
            kind = "copy"
        elif "gemm" in low or "cutlass" in low or "sm90" in low:
            kind = "matmul"
        else:
            kind = "other"
        c, t = kinds.get(kind, (0, 0.0))
        kinds[kind] = (c + n, t + ms)
    return {k: {"ops_per_step": c / steps, "ms_per_step": t / steps}
            for k, (c, t) in kinds.items()}


def traced_window(srv, todo):
    """Submit ``todo``, run one window untraced, trace the next: returns
    (its steps, ``profile_device``'s record)."""
    import torch
    from repro_torch.launch.serve import profile_device
    for p, m, s in todo:
        srv.submit(p, max_new=m, sampling=s)
    srv.pump()
    torch.cuda.synchronize()
    k0 = srv.stats["steps"]
    prof = profile_device(srv.pump, host_ops=False)
    return srv.stats["steps"] - k0, prof


@contextlib.contextmanager
def decode_attention_tap(model, at: int):
    """While ``model`` decodes, count ``decode_attention`` calls by
    ``write`` and keep clones of the inputs of the first call of each
    mode in decode step ``at`` (from 0), before the kernel writes: the
    shapes, dtypes and data the path really gives the kernel, for
    ``check_tapped``."""
    import repro_torch.kernels.decode_attention as da_pkg
    real, step = da_pkg.decode_attention, model.decode_step
    tap = {"step": -1, "at": at, "modes": {True: 0, False: 0}, "kept": {}}

    def stepped(cache, tokens):
        tap["step"] += 1
        return step(cache, tokens)

    def spy(q, k_new, v_new, ck, cv, pos, *, write=True, **kw):
        tap["modes"][write] += 1
        if tap["step"] == at and write not in tap["kept"]:
            kept = {key: (tuple(t.clone() for t in val)
                          if key == "rope_tables" and val is not None
                          else val) for key, val in kw.items()}
            tap["kept"][write] = (tuple(t.clone() for t in (
                q, k_new, v_new, ck, cv)), pos.clone(), kept)
        return real(q, k_new, v_new, ck, cv, pos, write=write, **kw)
    model.decode_step = stepped
    da_pkg.decode_attention = spy
    try:
        yield tap
    finally:
        da_pkg.decode_attention = real
        model.decode_step = step


def check_tapped(tap, what: str) -> dict:
    """Hold every mode ``tap`` saw launched against the plain version on
    the inputs it kept (``check_decode_attention``).  Returns, for each
    mode, the inputs' shapes and dtype, the error and the call's
    options."""
    out = {}
    for write, n in tap["modes"].items():
        if not n:
            continue
        if write not in tap["kept"]:
            fail(f"paged: {what}: no decode_attention(write={write}) call "
                 f"kept at decode step {tap['at']}")
        inputs, pos, kw = tap["kept"][write]
        ck = inputs[3]
        at = (f"{what}, decode step {tap['at']}, write={write}: q "
              f"{tuple(inputs[0].shape)}, cache {tuple(ck.shape)} "
              f"{str(ck.dtype).replace('torch.', '')}, pos "
              f"{int(pos.min())}-{int(pos.max())}")
        err = check_decode_attention(inputs, pos, at, write=write, **kw)
        out[write] = {"at": at, "max_abs_err": err,
                      "window": kw.get("window", 0),
                      "rope": bool(kw.get("rope_theta", 0.0))}
    return out


def log_tapped(checked: dict, path: str = "paged"):
    for write, r in sorted(checked.items()):
        log(f"{path}: decode_attention == its plain version at {r['at']} "
            f"(window {r['window']}, rope in the kernel {r['rope']}): o "
            f"within {r['max_abs_err']:.3e} of max(1, |plain|), caches "
            f"bitwise")


def decode_attention_times(inputs, pos, kw) -> dict:
    """``decode_attention`` on ``inputs`` (q, k_new, v_new, the caches)
    at ``pos`` with the call's options ``kw``, timed beside its plain
    version and SDPA over the same caches with the slots' validity mask
    (q in the caches' dtype), and the bound of what this call's data
    needs: each row's valid slots of k and v read once, q read and o
    written in float32, pos read; with ``write``, the new k and v read
    and written to their slot, and the step's RoPE tables read."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.models.attention import decode_slot_validity
    q, kn, vn, ck, cv = inputs
    ck, cv = ck.clone(), cv.clone()
    b, hq, _, hd = q.shape
    hkv, s = ck.shape[1], ck.shape[2]

    def fused():
        return ops.decode_attention(q, kn, vn, ck, cv, pos, **kw)

    def plain():
        return ref.decode_attention_ref(q, kn, vn, ck, cv, pos, **kw)
    mask = decode_slot_validity(pos, s, window=kw.get("window", 0))[
        :, None, None, :]
    qq = q.to(ck.dtype)

    def sdpa():
        return F.scaled_dot_product_attention(qq, ck, cv, attn_mask=mask,
                                              enable_gqa=True)
    slots = int(mask.sum())
    item = ck.element_size()
    moved = 2 * slots * hkv * hd * item + 4 * 2 * b * hq * hd + 4 * b
    if kw.get("write", True):
        moved += 4 * 2 * b * hkv * hd + 2 * b * hkv * hd * item
        if kw.get("rope_theta") or kw.get("rope_tables") is not None:
            moved += 4 * b * hd
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * slots * hq * hd / F32_OPS_PER_S * 1e3
    return {"ms": time_ms(fused),
            "device_ms": device_ms(fused, "decode_attention"),
            "plain_ms": time_ms(plain), "library_ms": time_ms(sdpa),
            "library_device_ms": device_ms(sdpa),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def paged_drain(srv, todo):
    """Submit ``todo`` ((prompt, max_new, sampling) each), drain, and
    return (the outputs in order, the drain's seconds)."""
    import torch
    rids = [srv.submit(p, max_new=m, sampling=s) for p, m, s in todo]
    t0 = time.perf_counter()
    done = srv.drain()
    torch.cuda.synchronize()
    return [done[r].out for r in rids], time.perf_counter() - t0


def paged_counted(total: dict, fn):
    """Run ``fn`` with every launch count at 0 first, and add the counts
    it left to ``total``: the paged path's launches."""
    import torch
    launch_counts(reset=True)
    out = fn()
    torch.cuda.synchronize()
    for name, n in launch_counts().items():
        total[name] += n
    return out


def paged_check(srv, outs, todo, vocab: int, what: str):
    """Every request's tokens in the vocabulary and as many as asked;
    the allocator's invariant holds and no page is live."""
    import numpy as np
    for i, (out, (_, m, _)) in enumerate(zip(outs, todo)):
        o = np.asarray(out)
        if len(o) != m or not ((o >= 0) & (o < vocab)).all():
            fail(f"paged: {what}: request {i} returned {len(o)} tokens "
                 f"(want {m}) or ids outside the vocabulary")
    srv.alloc.check()
    if srv.alloc.live_pages():
        fail(f"paged: {what}: {srv.alloc.live_pages()} live pages after "
             f"the drain")


def paged_lm(total: dict) -> dict:
    """(a): qwen2.5-3b at full widths and phase_lm's depth on its
    weights.  Returns the main drain's launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, paging
    from repro_torch.serve import PagedCacheConfig, THROUGHPUT, TokenServer
    t0 = time.perf_counter()
    cfg = cut_depth(get_arch(LM_ARCH), LM_LAYERS)
    params = LM_WEIGHTS.pop("params")
    pag = PagedCacheConfig(**PAGED_LM)
    reqs, pre = paged_requests(cfg, np.random.default_rng(SEED + 7),
                               pag.page_size, THROUGHPUT.sync_every)
    greedy = [i for i, r in enumerate(reqs) if r[2] is None]
    ask = sum(-(-(p.shape[0] + m - 1) // pag.page_size)
              for p, m, _ in reqs[:THROUGHPUT.max_batch])
    if ask <= pag.n_pages:
        fail(f"paged: the first {THROUGHPUT.max_batch} requests ask for "
             f"{ask} pages, not more than the pool's {pag.n_pages}")

    def server(paged=True, prefix_cache=True):
        return TokenServer(cfg, params, policy=THROUGHPUT,
                           max_seq=LM_MAX_SEQ, decode_kernel=True,
                           paging=pag if paged else None,
                           prefix_cache=prefix_cache,
                           cache_dtype=torch.float32)

    srv_on = server()
    turned = []                      # admissions the pool turned away
    admit = srv_on._admit_pages
    srv_on._admit_pages = lambda slot, r: turned.append(
        admit(slot, r)) or turned[-1]
    with decode_attention_tap(srv_on.model, PAGED_TAP_STEP) as tap:
        out_on, dt_on = paged_counted(total, lambda: paged_drain(srv_on,
                                                                 reqs))
    counts = dict(total)
    paged_check(srv_on, out_on, reqs, cfg.vocab_size, "prefix cache on")
    st_on, steps = srv_on.paging_stats(), srv_on.stats["steps"]
    for name in ("decode_attention", "topk_sample", "topk_logits"):
        if counts[name] == 0:
            fail(f"paged: the paged drain launched no {name} kernel")
    if counts["decode_attention"] != cfg.n_layers * steps or \
            tap["modes"] != {True: 0, False: cfg.n_layers * steps}:
        fail(f"paged: {counts['decode_attention']} decode_attention "
             f"launches ({tap['modes']} by write) over {steps} steps, want "
             f"{cfg.n_layers} write=False a step")
    checked = check_tapped(tap, LM_ARCH)
    waited = sum(t < 0 for t in turned)
    # all prefix requests but the first find the 4 published pages
    want_hits = (len(pre) - 1) * (PAGED_PREFIX // pag.page_size)
    if not waited or st_on["hits"] < want_hits:
        fail(f"paged: admission never waited for pages ({waited}) or "
             f"{st_on['hits']} prefix hits, want {want_hits}")
    srv_c = server(paged=False)
    out_c, dt_c = paged_drain(srv_c, reqs)
    steps_c = srv_c.stats["steps"]
    del srv_c
    # the prefix cache off: without it every admission allocates all its
    # pages, so the whole traffic's allocs are the sum of its requests'
    # pages; the 8 prefix requests are drained to hold that and their
    # tokens (a row's tokens do not depend on the other rows)
    pages_of = [-(-(p.shape[0] + m - 1) // pag.page_size)
                for p, m, _ in reqs]
    shared = [reqs[i] for i in pre]
    srv_off = server(prefix_cache=False)
    out_off, dt_off = paged_counted(total, lambda: paged_drain(srv_off,
                                                               shared))
    paged_check(srv_off, out_off, shared, cfg.vocab_size,
                "prefix cache off")
    st_off = srv_off.paging_stats()
    del srv_off
    if st_off["hits"] or st_off["allocs"] != sum(pages_of[i] for i in pre) \
            or st_on["allocs"] > sum(pages_of) - want_hits:
        fail(f"paged: the prefix cache saved fewer pages than its hits "
             f"({st_on['allocs']} allocs on, {sum(pages_of)} without it; "
             f"the prefix requests alone {st_off})")
    plain = build_model(cfg, device="cuda", params=params)
    near_c = near_ties(plain, reqs, out_c, out_on, "paged vs contiguous",
                       LM_MAX_SEQ)
    near_off = near_ties(plain, shared, out_off, [out_on[i] for i in pre],
                         "prefix cache on vs off", LM_MAX_SEQ)
    del plain
    same_sampled = sum(out_on[i] == out_c[i] for i, r in enumerate(reqs)
                       if r[2] is not None)
    gen = sum(m for _, m, _ in reqs)
    tok_bytes = paging.paged_token_bytes(cfg, torch.bfloat16)
    peak = st_on["peak_pages"] * pag.page_size * tok_bytes
    flat = THROUGHPUT.max_batch * LM_MAX_SEQ * tok_bytes
    log(f"paged: {LM_ARCH} at full widths, {cfg.n_layers} of 36 layers, "
        f"TokenServer(paging="
        f"PagedCacheConfig(16, 384, 512), decode_kernel=True), f32 caches: "
        f"{len(reqs)} requests ({len(greedy)} greedy, 8 sharing a "
        f"{PAGED_PREFIX}-token prefix), {gen} tokens in {dt_on:.3f} s = {gen / dt_on:.1f} "
        f"generated tokens/s over {steps} steps ({steps / dt_on:.1f} "
        f"steps/s); the contiguous TokenServer on the same requests "
        f"{dt_c:.3f} s = {gen / dt_c:.1f} tokens/s over {steps_c} steps "
        f"({steps_c / dt_c:.1f} steps/s)")
    log(f"paged: admission turned away {waited} of {len(turned)} tries; "
        f"prefix cache on: {st_on} ({sum(pages_of)} allocs without it); "
        f"the 8 prefix requests with it off: {st_off} in {dt_off:.3f} s; "
        f"peak {st_on['peak_pages']} pages x {pag.page_size} x {tok_bytes} "
        f"B a token (bf16) = {peak / 2**20:.1f} MiB against 16 slots x "
        f"{LM_MAX_SEQ} x {tok_bytes} B = {flat / 2**20:.1f} MiB contiguous "
        f"(twice both in these float32 caches); alloc.check() passed, 0 "
        f"live pages; launches decode_attention "
        f"{counts['decode_attention']} "
        f"({counts['decode_attention'] / steps:.0f} a step, all "
        f"write=False), topk_sample {counts['topk_sample']}, topk_logits "
        f"{counts['topk_logits']}")
    log(f"paged: greedy tokens equal the contiguous server's ({near_c} "
        f"parted at a near-tie) and prefix-on equal prefix-off ({near_off} "
        f"at a near-tie); sampled requests equal to the contiguous "
        f"server's (logged, not held): {same_sampled} of "
        f"{len(reqs) - len(greedy)}")
    log_tapped(checked)
    # one traced window, 16 rows in flight, on the paged server and on a
    # contiguous one: the paged path's cost is the difference
    window = [(p[:64], 32, smp) for p, _, smp in reqs[:16]]
    t1 = time.perf_counter()
    traces = {}
    for name, paged in (("paged", True), ("contiguous", False)):
        srv = server(paged=paged)
        k, prof = traced_window(srv, window)
        del srv
        traces[name] = (k, prof, kernel_shares(prof["by_name"], k))
        log(f"paged: one traced window of {k} steps, 16 rows, {name}: "
            f"{prof['ops'] / k:.1f} device ops and {prof['busy_ms'] / k:.3f} "
            f"ms of device time a step (wall {prof['wall_ms'] / k:.3f} ms); "
            f"by kind, ms a step: " + ", ".join(
                f"{kind} {v['ms_per_step']:.4f} ({v['ops_per_step']:.1f} "
                f"ops)" for kind, v in sorted(traces[name][2].items())))
    (kp, pp, sp), (kc, pc, sc) = traces["paged"], traces["contiguous"]
    zero = {"ms_per_step": 0.0, "ops_per_step": 0.0}
    log(f"paged: the paged step minus the contiguous one, same window: "
        f"{pp['busy_ms'] / kp - pc['busy_ms'] / kc:+.4f} device ms and "
        f"{pp['ops'] / kp - pc['ops'] / kc:+.1f} device ops a step, wall "
        f"{pp['wall_ms'] / kp - pc['wall_ms'] / kc:+.3f} ms (traced); by "
        f"kind, ms (ops) a step: " + ", ".join(
            f"{kind} {sp.get(kind, zero)['ms_per_step'] - sc.get(kind, zero)['ms_per_step']:+.4f} "
            f"({sp.get(kind, zero)['ops_per_step'] - sc.get(kind, zero)['ops_per_step']:+.1f})"
            for kind in sorted(set(sp) | set(sc))))
    t2 = time.perf_counter()
    log(f"paged: {LM_ARCH} seconds: drains paged {dt_on:.1f}, contiguous "
        f"{dt_c:.1f}, prefix cache off {dt_off:.1f}; the two traced windows "
        f"{t2 - t1:.1f}; the rest (servers built, checks) "
        f"{t1 - t0 - dt_on - dt_c - dt_off:.1f}")
    return counts


def paged_kernel_times():
    """``decode_attention(write=False)`` at the paged shape (B=16,
    Hkv=2, G=8, hd=128, S=512, bf16) over a view gathered from a pool
    through random block tables: checked against its plain version,
    then timed beside its bytes bound, SDPA over the same view and the
    two gathers that make the view."""
    import torch
    from repro_torch.models import paging
    pag = paging.PagedCacheConfig(**PAGED_LM)
    b, hkv, g, hd, s = 16, 2, 8, 128, pag.resolved_max_ctx
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    pool_k = rnd(pag.pool_slots, hkv, hd).to(torch.bfloat16)
    pool_v = rnd(pag.pool_slots, hkv, hd).to(torch.bfloat16)
    pos = torch.randint(0, s, (b,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[0], pos[1] = 0, s - 1
    tables = torch.randint(1, pag.n_pages + 1, (b, pag.max_blocks),
                           generator=gen, device="cuda", dtype=torch.int32)
    gidx = paging.gather_indices(paging.PageRef(tables, pos + 1,
                                                pag.page_size))
    ck, cv = paging.gather_pool(pool_k, gidx), paging.gather_pool(pool_v,
                                                                  gidx)
    q, kn, vn = rnd(b, hkv * g, 1, hd), rnd(b, hkv, 1, hd), rnd(b, hkv, 1, hd)
    err = check_decode_attention((q, kn, vn, ck, cv), pos,
                                 "a gathered pool view (write=False)",
                                 write=False)
    # the paged drains' caches are float32: the same view in float32
    err32 = check_decode_attention(
        (q, kn, vn, ck.float(), cv.float()), pos,
        "a gathered float32 pool view (write=False)", write=False)

    def gather():
        return (paging.gather_pool(pool_k, gidx),
                paging.gather_pool(pool_v, gidx))
    t = PAGED_TIMES
    t.update(decode_attention_times((q, kn, vn, ck, cv), pos,
                                    {"write": False}))
    t.update({"gather_ms": time_ms(gather),
              "gather_device_ms": device_ms(gather),
              "max_abs_err": err, "max_abs_err_f32": err32,
              "at": f"B={b} Hkv={hkv} G={g} hd={hd} S={s} bf16, write=False "
                    f"over a gathered pool view"})
    log(f"kernel: decode_attention(write=False) at B={b} Hkv={hkv} G={g} "
        f"hd={hd} S={s} bf16 over a gathered pool view: {t['ms']:.4f} ms "
        f"(device only {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} "
        f"ms, SDPA over the same view {t['library_ms']:.4f} ms (device only "
        f"{t['library_device_ms']:.4f} ms), bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}); the two gathers that make the view "
        f"{t['gather_ms']:.4f} ms (device only {t['gather_device_ms']:.4f} "
        f"ms); o within {err:.3e} of the plain version ({err32:.3e} over "
        f"the same view in float32)")


def paged_wide(total: dict, arch: str, layers: int, paging_kw: dict,
               reqs_of, seed: int, tap_step: int, keep=None) -> dict:
    """One wide config at full widths, its depth cut to the first
    segment's pattern (only its positions ``keep``, when given) repeated
    ``layers // len(pattern)`` times, drawn
    on the card from ``seed`` (the embedding scaled by 1/sqrt(d)):
    a paged greedy drain of ``reqs_of(cfg)`` against the contiguous
    server's, both with float32 caches and the fused route, and the
    kernel's inputs at decode step ``tap_step`` of the paged drain held
    to its plain version.  Returns facts for the log: the paged drain's
    seconds, steps, decode_attention calls by ``write``, the kernel
    checks, cache layout and stats."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import Segment
    from repro_torch.models import build_model
    from repro_torch.serve import PagedCacheConfig, THROUGHPUT, TokenServer
    t0 = time.perf_counter()
    cfg = get_arch(arch)
    pat = cfg.segments[0].pattern
    if keep is not None:
        pat = tuple(pat[i] for i in keep)
    cfg = cfg.replace(segments=(Segment(pat, layers // len(pat)),))
    params = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed)).state_dict()
    params["embed"].mul_(cfg.d_model ** -0.5)
    n_params = sum(v.numel() for v in params.values())
    pag = PagedCacheConfig(**paging_kw)
    pol = dataclasses.replace(THROUGHPUT, max_batch=4)
    reqs = reqs_of(cfg)
    srv = TokenServer(cfg, params, policy=pol, paging=pag,
                      decode_kernel=True, cache_dtype=torch.float32)
    finite = []
    step = srv.model.decode_step

    def checked(cache, tokens):
        logits, cache = step(cache, tokens)
        finite.append(torch.isfinite(logits).all())
        return logits, cache
    srv.model.decode_step = checked
    with decode_attention_tap(srv.model, tap_step) as tap:
        out, dt = paged_counted(total, lambda: paged_drain(srv, reqs))
    paged_check(srv, out, reqs, cfg.vocab_size, arch)
    if not bool(torch.stack(finite).all()):
        fail(f"paged: {arch}: non-finite logits")
    kernel = check_tapped(tap, arch)
    facts = {"cfg": cfg, "n_params": n_params, "reqs": reqs, "dt": dt,
             "steps": srv.stats["steps"], "modes": tap["modes"],
             "kernel": kernel, "stats": srv.paging_stats(),
             "prefix_cache": srv.alloc.prefix_cache,
             "layout": [srv._cache["seg0"][f"p{i}"]["k"].dim()
                        for i in range(len(pat))]}
    del srv
    ref = TokenServer(cfg, params, policy=pol,
                      max_seq=pag.resolved_max_ctx, decode_kernel=True,
                      cache_dtype=torch.float32)
    ref_out, facts["ref_dt"] = paged_drain(ref, reqs)
    facts["near"] = near_ties(ref.model, reqs, ref_out, out,
                              f"{arch} paged vs contiguous",
                              pag.resolved_max_ctx)
    facts["seconds"] = time.perf_counter() - t0
    return facts


def paged_gemma(total: dict, rng) -> None:
    """phase_paged (b): gemma3-27b at full widths, its depth cut to the
    group's first local layer and its global one (``PAGED_GEMMA_KEEP``):
    4 requests whose prompts wrap every 1,024-slot ring, paged against
    the contiguous server."""
    import numpy as np
    import torch

    def gemma_reqs(cfg):             # every ring of 1024 slots wraps
        return [(rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32),
                 16, None) for n in rng.integers(1040, 1101, 4)]
    n_local = len(PAGED_GEMMA_KEEP) - 1
    r = paged_wide(total, "gemma3-27b", len(PAGED_GEMMA_KEEP), PAGED_GEMMA,
                   gemma_reqs, SEED + 9, PAGED_GEMMA_TAP_STEP,
                   keep=PAGED_GEMMA_KEEP)
    torch.cuda.empty_cache()
    if r["layout"] != [5] * n_local + [4]:
        fail(f"paged: gemma3-27b cache layout {r['layout']}: want rings for "
             f"the {n_local} local layers and a pool for the global one")
    if r["modes"] != {True: n_local * r["steps"], False: r["steps"]}:
        fail(f"paged: gemma3-27b ran decode_attention {r['modes']} times by "
             f"write over {r['steps']} steps (want {n_local} and 1 a step)")
    if r["kernel"][True]["window"] != 1024 or r["kernel"][False]["window"]:
        fail(f"paged: gemma3-27b's kernel calls {r['kernel']}: want the "
             f"rings at window 1024 and the pool at none")
    if r["stats"]["hits"] or r["prefix_cache"]:
        fail("paged: gemma3-27b's prefix cache is not refused")
    log(f"paged: gemma3-27b at full widths (d 5376, 32/16 heads, hd 128, "
        f"d_ff 21504, V 262144, tied), depth cut from 62 layers to "
        f"{n_local} local (window 1024) and 1 global, "
        f"{r['n_params'] / 1e9:.3f} B f32 "
        f"params drawn on the card: 4 requests of "
        f"{[p.shape[0] for p, _, _ in r['reqs']]} prompt tokens, max_new 16 "
        f"(every ring wraps): paged {r['dt']:.3f} s ({64 / r['dt']:.1f} "
        f"tokens/s, {r['steps']} steps), contiguous {r['ref_dt']:.3f} s; "
        f"decode_attention write=True {r['modes'][True]} ({n_local} a step: "
        f"the rings), write=False {r['modes'][False]} (1 a step: the pool); a "
        f"pool only for the global layer; prefix cache refused, 0 hits; "
        f"greedy tokens equal the contiguous server's ({r['near']} parted "
        f"at a near-tie); pages {r['stats']} [{r['seconds']:.1f} s]")
    log_tapped(r["kernel"])


def phase_paged() -> dict:
    """The paged KV cache on the card (``models/paging.py``,
    ``serve/paging.py``, ``TokenServer(paging=)``): (a) qwen2.5-3b at
    full width on phase_lm's weights; the kernel's ``write=False`` mode
    timed at its paged shape; (b) gemma3-27b at full widths cut to its
    group's first local layer and its global one; (c) deepseek-67b and chameleon-34b at full
    widths cut to 2 layers.  Every paged drain's launches count toward
    the path (the contiguous runs they are held to do not), and in each
    the kernel's inputs of one step are held to its plain version."""
    import numpy as np
    import torch
    total = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    paged_lm(total)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    paged_kernel_times()
    t2 = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    paged_gemma(total, rng)
    t3 = time.perf_counter()
    for n, arch in enumerate(("deepseek-67b", "chameleon-34b")):
        def short(cfg):
            return [(rng.integers(1, cfg.vocab_size, int(m)).astype(
                np.int32), 8, None) for m in rng.integers(16, 49, 4)]
        r = paged_wide(total, arch, 2, PAGED_WIDE, short, SEED + 10 + n,
                       PAGED_WIDE_TAP_STEP)
        torch.cuda.empty_cache()
        c = r["cfg"]
        log(f"paged: {arch} at full widths (d {c.d_model}, {c.n_heads}/"
            f"{c.n_kv_heads} heads, d_ff {c.d_ff}, V {c.vocab_size}), depth "
            f"cut to 2 layers ({r['n_params'] / 1e9:.3f} B f32 params): 4 "
            f"greedy requests paged in {r['dt']:.3f} s, {r['steps']} steps, "
            f"logits finite, tokens equal the contiguous server's "
            f"({r['near']} parted at a near-tie); pages {r['stats']} "
            f"[{r['seconds']:.1f} s]")
        log_tapped(r["kernel"])
    t4 = time.perf_counter()
    log(f"paged: seconds by part: qwen2.5-3b {t1 - t0:.1f}, write=False "
        f"timing {t2 - t1:.1f}, gemma3-27b {t3 - t2:.1f}, deepseek-67b and "
        f"chameleon-34b {t4 - t3:.1f}")
    return total


# ------------------------------------------------------------ MoE serving

MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 2                     # of 48: 1.869 B f32 parameters
MOE_MAX_SEQ = 128                  # a request's prompt and new tokens fit
MOE_PAGED = dict(page_size=16, n_pages=32, max_ctx=MOE_MAX_SEQ)
MOE_TAP_STEP = 40                  # the decode step whose decode_attention
                                   # and MoE layer-0 inputs are held to the
                                   # plain version and to the host (every
                                   # row still in flight)
MOE_PREFILL = (2, 2048)            # make_prefill_step's (B, S)
MOE_TIE = 1e-6                     # a token is a near-tie when two of its
                                   # top k+1 router probabilities lie within
                                   # MOE_TIE of its top one: card and host
                                   # may order them otherwise
MOE_HOST_REL = 1e-4                # card vs host MoE output, of max(1,
                                   # |host|)


def moe_requests(cfg, rng):
    """8 requests of 32-96 prompt tokens and max_new 16, the odd ones
    sampled (temperature 0.8, top_k 20, top_p 0.9)."""
    import numpy as np
    from repro_torch.serve import SamplingParams
    reqs = []
    for i in range(8):
        prompt = rng.integers(1, cfg.vocab_size,
                              int(rng.integers(32, 97))).astype(np.int32)
        samp = None if i % 2 == 0 else SamplingParams(
            temperature=0.8, top_k=20, top_p=0.9, seed=3000 + i)
        reqs.append((prompt, 16, samp))
    return reqs


@contextlib.contextmanager
def moe_tap(keep: set, aux: bool = False):
    """While the model runs, keep a clone of ``moe_apply``'s input at
    each call index in ``keep`` (from 0; a model of L MoE layers makes L
    calls a forward) and, with ``aux``, every call's aux."""
    import repro_torch.models.moe as moe_mod
    real = moe_mod.moe_apply
    tap = {"calls": 0, "kept": {}, "aux": []}

    def spy(params, cfg, x):
        if tap["calls"] in keep:
            tap["kept"][tap["calls"]] = x.clone()
        tap["calls"] += 1
        y, a = real(params, cfg, x)
        if aux:
            tap["aux"].append(a)
        return y, a
    moe_mod.moe_apply = spy
    try:
        yield tap
    finally:
        moe_mod.moe_apply = real


@contextlib.contextmanager
def swa_tap(module=None):
    """Keep the inputs of the first ``swa_attention`` call the model's
    full-sequence attention makes (layer 0), through ``module``'s name
    for the op (``models/attention.py`` unless given: ``models/mla.py``
    for an MLA model)."""
    if module is None:
        import repro_torch.models.attention as module
    real = module.swa_attention
    tap = {}

    def spy(q, k, v, window, **kw):
        if not tap:
            tap.update(inputs=(q.clone(), k.clone(), v.clone()),
                       window=window, kw=kw)
        return real(q, k, v, window, **kw)
    module.swa_attention = spy
    try:
        yield tap
    finally:
        module.swa_attention = real


def moe_host_check(card, host, cfg, x, what: str) -> dict:
    """One MoE layer on the card's own input ``x`` (B, S, D), on the
    card (``card``: the layer's parameters there) and on the host
    (``host``: their copies): routing ids equal for every token that is
    no near-tie (MOE_TIE), and with the near-tie tokens held to the
    card's choice the host's per-group expert counts and drops equal the
    card's and its output is within MOE_HOST_REL of the card's.  The
    config has no shared expert, so ``moe_apply``'s y is the dispatch's.
    Returns the facts for the log."""
    import torch
    from repro_torch.models import moe
    b, s, _ = x.shape
    k = cfg.moe_top_k
    cap = moe.capacity(s, cfg)
    with torch.inference_mode():
        y_c, aux_c = moe.moe_apply(card, cfg, x)
        _, _, p_c, i_c = moe.route(card, cfg, x)
        _, counts_c, drop_c = moe._group_dispatch_combine(
            x, p_c.reshape(b, s, k), i_c.reshape(b, s, k),
            card["w_gate"], card["w_up"], card["w_down"], cap=cap)
        xh = x.cpu()
        _, probs_h, _, i_h = moe.route(host, cfg, xh)
        top = torch.sort(probs_h, dim=-1, descending=True).values[:, :k + 1]
        near = ((top[:, :-1] - top[:, 1:]).min(-1).values
                <= MOE_TIE * top[:, 0])
        i_c = i_c.cpu()
        apart = int(((i_c != i_h).any(-1) & ~near).sum())
        if apart:
            fail(f"moe: {what}: {apart} tokens routed to other experts on "
                 f"the card than on the host, no near-tie among them")
        ids = torch.where(near[:, None], i_c, i_h)
        p = probs_h.gather(1, ids)
        if cfg.moe_renorm_topk:
            p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9)
        y_h, counts_h, drop_h = moe._group_dispatch_combine(
            xh, p.reshape(b, s, k), ids.reshape(b, s, k), host["w_gate"],
            host["w_up"], host["w_down"], cap=cap)
        if not (torch.equal(counts_c.cpu(), counts_h)
                and torch.equal(drop_c.cpu(), drop_h)):
            fail(f"moe: {what}: the card's per-group expert counts or drops "
                 f"differ from the host's")
        err = rel_err(y_c.cpu(), y_h.reshape(y_c.shape))
        if not err <= MOE_HOST_REL:
            fail(f"moe: {what}: the card's MoE output differs from the "
                 f"host's by {err:.3e} > {MOE_HOST_REL} of max(1, |host|)")
    return {"tokens": b * s, "near": int(near.sum()), "err": err,
            "cap": cap, "dropped": float(drop_h.sum()),
            "kept": int(counts_h.clamp(max=cap).sum()),
            "drop_frac": float(aux_c["moe_drop_frac"])}


def phase_moe() -> dict:
    """qwen3-moe-30b-a3b at full widths, 48 layers cut to 2 (1.869 B f32
    parameters drawn on the card from the seed, the embedding scaled by
    1/sqrt(d)), through the port's entry points: (a) a contiguous
    ``TokenServer`` drain of 8 requests, half sampled, with the fused
    kernels and float32 caches; (b) a paged drain of the greedy half,
    tokens equal to (a)'s away from near-ties; (c) one
    ``make_prefill_step`` call at B=2, S=2,048; (d) the MoE layer on
    the host, on layer 0's card inputs of one decode step and of the
    prefill; (e) one traced window of 16 decode steps and the MoE
    layers' share of its device time.  The kernels' inputs of one
    decode step of each drain and of the prefill's layer 0 are held to
    their plain versions.  Returns the launches of (a), (b) and (c)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import Segment
    from repro_torch.launch.serve import profile_device
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, moe
    from repro_torch.serve import PagedCacheConfig, THROUGHPUT, TokenServer
    total = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    full = get_arch(MOE_ARCH)
    cfg = full.replace(segments=(Segment(full.segments[0].pattern,
                                         MOE_LAYERS),))
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 12))
    params = model.state_dict()
    params["embed"].mul_(cfg.d_model ** -0.5)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    log(f"moe: {MOE_ARCH} at full widths (d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.head_dim}, qk_norm, "
        f"{cfg.n_experts} experts top-{cfg.moe_top_k}, moe_d_ff "
        f"{cfg.moe_d_ff}, V {cfg.vocab_size}, untied), depth cut from "
        f"{full.n_layers} layers to {MOE_LAYERS}: {n_params / 1e9:.3f} B f32 "
        f"params drawn on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 12)
    reqs = moe_requests(cfg, rng)
    greedy = [i for i, r in enumerate(reqs) if r[2] is None]
    pol = dataclasses.replace(THROUGHPUT, max_batch=len(reqs))

    def server(**kw):
        if "paging" not in kw:
            kw["max_seq"] = MOE_MAX_SEQ
        return TokenServer(cfg, params, policy=pol, decode_kernel=True,
                           cache_dtype=torch.float32, **kw)

    # (a) the contiguous drain, after a short warm-up drain
    paged_drain(server(), [(reqs[0][0][:8], 2, None),
                           (reqs[1][0][:8], 2, reqs[1][2])])
    t1 = time.perf_counter()
    srv = server()
    finite = []
    step = srv.model.decode_step

    def checked(cache, tokens):
        logits, cache = step(cache, tokens)
        finite.append(torch.isfinite(logits).all())
        return logits, cache
    srv.model.decode_step = checked
    with decode_attention_tap(srv.model, MOE_TAP_STEP) as dtap, \
            moe_tap({MOE_LAYERS * MOE_TAP_STEP}) as mtap:
        out, dt = paged_counted(total, lambda: paged_drain(srv, reqs))
    counts = dict(total)
    steps = srv.stats["steps"]
    for i, (o, (_, m, _)) in enumerate(zip(out, reqs)):
        o = np.asarray(o)
        if len(o) != m or not ((o >= 0) & (o < cfg.vocab_size)).all():
            fail(f"moe: request {i} returned {len(o)} tokens (want {m}) or "
                 f"ids outside the vocabulary")
    if not bool(torch.stack(finite).all()):
        fail("moe: non-finite logits in the contiguous drain")
    want = {"decode_attention": MOE_LAYERS * steps, "topk_logits": steps,
            "topk_sample": steps}
    got = {name: counts[name] for name in want}
    if got != want:
        fail(f"moe: the contiguous drain launched {got} over {steps} steps, "
             f"want {want} (decode_attention {MOE_LAYERS} a step, the "
             f"sampler's two stages 1 a step)")
    gen = sum(len(o) for o in out)
    log(f"moe: (a) contiguous TokenServer, {len(reqs)} slots, float32 "
        f"caches, fused kernels: {len(reqs)} requests of "
        f"{[p.shape[0] for p, _, _ in reqs]} prompt tokens, max_new 16, "
        f"{len(reqs) - len(greedy)} sampled (top_k 20): {gen} tokens in "
        f"{dt:.3f} s = {gen / dt:.1f} generated tokens/s, {steps} steps "
        f"({steps / dt:.1f} steps/s), {srv.stats['syncs']} syncs; logits "
        f"finite; launches {got}")
    log_tapped(check_tapped(dtap, f"{MOE_ARCH} contiguous"), "moe")
    x_dec = mtap["kept"][MOE_LAYERS * MOE_TAP_STEP]
    t2 = time.perf_counter()

    # (b) the paged drain of the greedy half
    todo = [reqs[i] for i in greedy]
    psrv = server(paging=PagedCacheConfig(**MOE_PAGED))
    with decode_attention_tap(psrv.model, MOE_TAP_STEP) as ptap:
        pout, pdt = paged_counted(total, lambda: paged_drain(psrv, todo))
    paged_check(psrv, pout, todo, cfg.vocab_size, MOE_ARCH)
    psteps = psrv.stats["steps"]
    if ptap["modes"] != {True: 0, False: MOE_LAYERS * psteps}:
        fail(f"moe: the paged drain ran decode_attention {ptap['modes']} "
             f"times by write over {psteps} steps (want write=False "
             f"{MOE_LAYERS} a step)")
    near = near_ties(srv.model, todo, [out[i] for i in greedy], pout,
                     f"{MOE_ARCH} paged vs contiguous", MOE_MAX_SEQ)
    log(f"moe: (b) paged (PagedCacheConfig({MOE_PAGED})): the {len(todo)} "
        f"greedy requests in {pdt:.3f} s, {psteps} steps; tokens equal the "
        f"contiguous server's ({near} parted at a near-tie); pages "
        f"{psrv.paging_stats()}")
    log_tapped(check_tapped(ptap, f"{MOE_ARCH} paged"), "moe")
    del psrv
    t3 = time.perf_counter()

    # (c) one prefill call
    pmodel = build_model(cfg, device="cuda", params=params)
    prefill = make_prefill_step(pmodel, cfg)
    b, s = MOE_PREFILL
    tokens = torch.randint(1, cfg.vocab_size, (b, s), generator=torch.Generator(
        device="cuda").manual_seed(SEED + 12), device="cuda",
        dtype=torch.int32)
    prefill({"tokens": tokens})                          # warm-up
    torch.cuda.synchronize()
    with moe_tap({0}, aux=True) as ftap, swa_tap() as stap:
        def call():
            t = time.perf_counter()
            logits = prefill({"tokens": tokens})
            torch.cuda.synchronize()
            return logits, time.perf_counter() - t
        before = dict(total)
        logits, fdt = paged_counted(total, call)
    pcounts = {k: total[k] - before[k] for k in KERNELS}
    if pcounts != {**dict.fromkeys(KERNELS, 0),
                   "swa_attention": 2 * MOE_LAYERS}:
        fail(f"moe: the prefill call launched {pcounts}, want swa_attention "
             f"{2 * MOE_LAYERS} (prepass and main kernel a layer) alone")
    if logits.shape != (b, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"moe: prefill logits {tuple(logits.shape)} not finite or of "
             f"another shape")
    drops = [float(a["moe_drop_frac"]) for a in ftap["aux"]]
    swa_err, _ = check_swa(stap["inputs"], stap["window"],
                           f"{MOE_ARCH} prefill layer 0", **stap["kw"])
    q, k, _ = stap["inputs"]
    log(f"moe: (c) make_prefill_step at B={b} S={s}: {fdt * 1e3:.1f} ms = "
        f"{b * s / fdt:.1f} prompt tokens/s, swa_attention "
        f"{pcounts['swa_attention']} launches (2 a layer), logits "
        f"{tuple(logits.shape)} finite; moe_drop_frac by layer "
        f"{[round(d, 6) for d in drops]} (capacity {moe.capacity(s, cfg)} a "
        f"group of {s} tokens); layer 0's swa_attention inputs (q "
        f"{tuple(q.shape)}, k {tuple(k.shape)}, window {stap['window']}) "
        f"held to its plain version: o within {swa_err:.3e} of max(1, "
        f"|plain|)")
    x_pre = ftap["kept"][0]
    t4 = time.perf_counter()

    # (d) the MoE layer on the host, on the card's own inputs
    card = pmodel.seg0[0]["p0"]["ffn"]
    host = {n: p.detach().cpu() for n, p in card.items()}
    t5 = time.perf_counter()
    for x, what in ((x_dec, f"decode step {MOE_TAP_STEP}, B={x_dec.shape[0]} "
                             f"one token a row"),
                    (x_pre, f"prefill B={b} S={s}")):
        r = moe_host_check(card, host, cfg, x, what)
        log(f"moe: (d) layer 0 on the host, {what}: routing ids equal on "
            f"{r['tokens'] - r['near']} of {r['tokens']} tokens, {r['near']} "
            f"within the near-tie margin {MOE_TIE} (held to the card's "
            f"choice); per-group counts and drops equal (capacity "
            f"{r['cap']}, {r['kept']} kept, {r['dropped']:.0f} dropped, "
            f"moe_drop_frac {r['drop_frac']:.6f}); y within {r['err']:.3e} "
            f"of max(1, |host|) (limit {MOE_HOST_REL})")
    log(f"moe: (d) layer 0's {sum(v.numel() for v in host.values()) / 1e6:.1f}"
        f" M MoE params copied to the host in {t5 - t4:.1f} s")
    del host
    t6 = time.perf_counter()

    # (e) one traced window of 16 decode steps, and the MoE layers alone
    tsrv = server()
    wsteps, prof = traced_window(tsrv, reqs)
    busy, ops = prof["busy_ms"] / wsteps, prof["ops"] / wsteps
    ffns = [pmodel.seg0[g]["p0"]["ffn"] for g in range(MOE_LAYERS)]

    def moe_only():
        with torch.inference_mode():
            for _ in range(wsteps):
                for f in ffns:
                    moe.moe_apply(f, cfg, x_dec)
    mprof = profile_device(moe_only, host_ops=False)
    m_busy, m_ops = mprof["busy_ms"] / wsteps, mprof["ops"] / wsteps
    expert_bytes = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 4
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][1])[:3]
    log(f"moe: (e) one traced window of {wsteps} decode steps ({len(reqs)} "
        f"rows): {ops:.1f} device ops and {busy:.3f} device ms a step "
        f"(wall {prof['wall_ms'] / wsteps:.1f} ms, idle "
        f"{1 - prof['busy_ms'] / prof['wall_ms']:.1%}); the {MOE_LAYERS} "
        f"MoE layers alone on the same (B={x_dec.shape[0]}, 1, D) input: "
        f"{m_ops:.1f} ops and {m_busy:.3f} device ms a step = "
        f"{m_busy / busy:.1%} of the step's device time ({m_busy / MOE_LAYERS:.3f}"
        f" ms a layer against {expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms to "
        f"read its {expert_bytes / 1e9:.2f} GB of expert weights once); "
        f"largest device lines a step: " + "; ".join(
            f"{name[:60]} {n / wsteps:.1f}x {ms / wsteps:.3f} ms"
            for name, (n, ms) in top))
    t7 = time.perf_counter()
    log(f"moe: seconds by part: weights {t1 - t0:.1f}, contiguous {t2 - t1:.1f}"
        f", paged {t3 - t2:.1f}, prefill {t4 - t3:.1f}, host {t6 - t4:.1f}, "
        f"traced {t7 - t6:.1f}")
    return total


# ------------------------------------------------- MLA and MTP (deepseek-v3)

MLA_ARCH = "deepseek-v3-671b"
MLA_MAX_SEQ = 128                  # a request's prompt and new tokens fit
MLA_PAGED = dict(page_size=16, n_pages=26, max_ctx=MLA_MAX_SEQ)
MLA_PREFIX = 48                    # tokens the two prefix requests share
MLA_TAP_STEP = 40                  # the decode step whose layer-0 MLA
                                   # inputs are re-run on the host
MLA_PREFILL = (1, 2048)            # make_prefill_step's (B, S)
MLA_PROMPT = 64                    # (d): prefill against decode
MLA_HOST_REL = 1e-4                # card vs host mla_decode, of max(1,
                                   # |host|)
MLA_K = 32                         # the sampler's stage-1 k (K_CAP_DEFAULT)
MLA_TIMES = {}                     # phase_mla's kernel times at its shapes,
                                   # for the kernel rows


def mla_params(cfg, gen):
    """deepseek-v3 at ``cfg``'s widths and depth, drawn on the card from
    ``gen`` without the MTP block, then the MTP module: its norm and
    ``proj`` drawn, its block the last layer's own tensors (the same
    shapes; ``build_model(params=)`` assigns, so one tensor named twice
    is one copy).  Returns the state dict."""
    from repro_torch.models import build_model, layers
    model = build_model(cfg.replace(mtp_depth=0), device="cuda",
                        generator=gen)
    params = model.state_dict()
    del model
    params["embed"].mul_(cfg.d_model ** -0.5)
    last = f"seg{len(cfg.segments) - 1}.{cfg.segments[-1].repeat - 1}.p0."
    for name in [n for n in params if n.startswith(last)]:
        params["mtp.block.0." + name[len(last):]] = params[name]
    params["mtp.norm.scale"] = layers.norm_init(cfg.d_model, cfg.norm,
                                                device="cuda")["scale"]
    params["mtp.proj"] = layers.dense_init(2 * cfg.d_model, cfg.d_model,
                                           generator=gen, device="cuda")
    return params


@contextlib.contextmanager
def mla_tap(keep: int):
    """While the model decodes, keep clones of the inputs of
    ``mla_decode`` call ``keep`` (from 0; a model of L MLA layers makes L
    calls a step), its cache before the write, and its output."""
    import repro_torch.models.mla as mla_mod
    real = mla_mod.mla_decode
    tap = {"calls": 0}

    def spy(params, cfg, x, cache, pos, pages=None, rope_tables=None):
        if tap["calls"] == keep:
            tap["inputs"] = dict(
                x=x.clone(), cache={k: a.clone() for k, a in cache.items()},
                pos=pos.clone(), pages=pages, rope_tables=None if
                rope_tables is None else tuple(t.clone()
                                               for t in rope_tables))
        tap["calls"] += 1
        y, cache = real(params, cfg, x, cache, pos, pages=pages,
                        rope_tables=rope_tables)
        if tap["calls"] == keep + 1:
            tap["y"] = y.clone()
            tap["after"] = {k: a.clone() for k, a in cache.items()}
        return y, cache
    mla_mod.mla_decode = spy
    try:
        yield tap
    finally:
        mla_mod.mla_decode = real


def mla_replay_hits(cfg, todo, pol) -> int:
    """The prefix hits of ``todo`` through a paged ``TokenServer`` on the
    host, over ``cfg`` reduced to d 64.  Admission, retirement and the
    allocator follow from the prompts' lengths, their equal blocks and
    ``max_new`` alone, not from the tokens, so the prompts' ids are
    relabelled one to one onto 1..n (equal blocks stay equal, distinct
    ones distinct) and the replay's vocabulary is n + 1."""
    import numpy as np
    import torch
    from repro_torch.configs import reduced
    from repro_torch.models import build_model
    from repro_torch.serve import PagedCacheConfig, TokenServer
    ids = np.unique(np.concatenate([p for p, _, _ in todo]))
    relabel = [(1 + np.searchsorted(ids, p).astype(np.int32), m, samp)
               for p, m, samp in todo]
    rcfg = reduced(cfg).replace(d_model=64, vocab_size=len(ids) + 1)
    params = build_model(rcfg, device="cpu", generator=torch.Generator(
        ).manual_seed(SEED)).state_dict()
    srv = TokenServer(rcfg, params, policy=pol, decode_kernel=True,
                      cache_dtype=torch.float32, device="cpu",
                      paging=PagedCacheConfig(**MLA_PAGED))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny products: threads only wait
    try:
        paged_drain(srv, relabel)
    finally:
        torch.set_num_threads(threads)
    return srv.paging_stats()["hits"]


def mla_attn_bound(b, h, s, qk: int, v: int):
    """(bound ms, what bounds it) of MLA's causal attention: 2 * qk + 2 *
    v flops a visible (query, key) pair at the 3xTF32 rate, against q, k
    (qk wide) and v read once and o (v wide) written once."""
    pairs = s * (s + 1) // 2
    ops_ms = (2 * qk + 2 * v) * pairs * b * h / TF32X3_OPS_PER_S * 1e3
    bytes_ms = 4 * b * h * s * (2 * qk + 2 * v) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def mla_kernel_times(inputs, logits) -> dict:
    """(f): ``swa_attention`` on layer 0's prefill q/k/v (v padded to
    q's head dim) against its plain version and timed beside SDPA
    ``is_causal`` on the same function; ``topk_logits`` bitwise on one
    decode step's (8, V) logits and timed."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q, k, v = inputs
    b, h, s, hd = q.shape
    hdv = 128
    err, ko = check_swa(inputs, s, f"{MLA_ARCH} prefill layer 0 (hd {hd}, "
                                   f"v padded from {hdv})")
    if not bool((ko[..., hdv:] == 0).all()):
        fail("mla: swa_attention wrote non-zero columns past v's head dim")
    vv = v[..., :hdv].contiguous()
    lib_note = "v at 128"

    def sdpa(vv=vv):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, vv, is_causal=True)
    try:
        lib = sdpa()
    except RuntimeError as e:
        log(f"mla: SDPA EFFICIENT_ATTENTION is_causal with v at {hdv} "
            f"refused: {str(e)[:80]}; v padded instead")
        lib_note = f"v padded to {hd}"

        def sdpa():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)
        lib = sdpa()
    lib_err = rel_err(lib[..., :hdv].float(), ko[..., :hdv])
    del lib
    bnd, by = mla_attn_bound(b, h, s, hd, hdv)
    swa = swa_times(inputs, s, err, sdpa,
                    f"EFFICIENT_ATTENTION is_causal ({lib_note})", (bnd, by))
    swa.update(library_err=lib_err,
               at=f"B={b} H={h} (G=1) hd={hd} (v {hdv}, zero-padded) S={s} "
                  f"causal f32")
    log(f"mla: (f) swa_attention at {swa['at']}: o within {err:.3e} of "
        f"max(1, |plain|) (limit {ATTN_REL}), columns past {hdv} zero; "
        f"{swa['ms']:.4f} ms (device only, both launches "
        f"{swa['device_ms']:.4f} ms), plain {swa['plain_ms']:.4f} ms, SDPA "
        f"{swa['library_backend']} {swa['library_ms']:.4f} ms (o within "
        f"{lib_err:.2e} of the kernel's), bound {bnd:.4f} ms ({by}: "
        f"{2 * hd + 2 * hdv} flops a visible pair, 3xTF32)")
    rows, vocab = logits.shape
    topk = topk_times(logits, MLA_K)
    log(f"mla: (f) topk_logits on one decode step's logits, R={rows} "
        f"V={vocab}, k 1 and {MLA_K}: stage 1 and merged bitwise the plain "
        f"versions; {topk['ms']:.4f} ms (device only {topk['device_ms']:.4f} "
        f"ms), plain sort {topk['plain_ms']:.4f} ms, torch.topk "
        f"{topk['library_ms']:.4f} ms, bound {topk['bound_ms']:.4f} ms "
        f"({topk['bound_by']})")
    return {"swa_attention": swa, "topk_logits": topk}


def mla_run() -> tuple:
    """deepseek-v3-671b at full widths, 61 layers cut to 2 (one dense,
    one MoE: 13.944 B f32 parameters drawn on the card from the seed, the
    embedding scaled by 1/sqrt(d); the MTP block the MoE layer's own
    tensors), through the port's entry points: (a) a contiguous
    ``TokenServer`` drain of 8 requests, half sampled; (b) the greedy
    half paged with two requests sharing a prompt head, admission
    waiting for pages, tokens equal to (a)'s and prefix hits equal to a
    host replay's; (c) one ``make_prefill_step`` call at B=1, S=2,048;
    (d) a 64-token prompt's last prefill logits against ``decode_step``;
    (e) layer 0's ``mla_decode`` of one decode step re-run on the host;
    (f) the kernels at this path's shapes against their plain versions;
    (g) ``mtp_hidden`` on (c)'s hidden; (h) a traced window of 16 decode
    steps with the MoE and MLA layers' shares.  Returns the launches of
    (a)-(d) and (g), and the peak of ``max_memory_allocated`` in GB."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import Segment
    from repro_torch.launch.serve import profile_device
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, mla, moe
    from repro_torch.serve import PagedCacheConfig, THROUGHPUT, TokenServer
    total = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_arch(MLA_ARCH)
    cfg = full.replace(segments=tuple(Segment(sg.pattern, 1)
                                      for sg in full.segments))
    n_layers = cfg.n_layers
    params = mla_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 13))
    torch.cuda.synchronize()
    n_params = sum(v.numel() for n, v in params.items()
                   if not n.startswith("mtp.block."))
    m = cfg.mla
    log(f"mla: {MLA_ARCH} at full widths (d {cfg.d_model}, {cfg.n_heads} "
        f"heads, MLA ranks q {m.q_lora_rank} kv {m.kv_lora_rank}, qk "
        f"{m.qk_nope_head_dim}+{m.qk_rope_head_dim}, v {m.v_head_dim}; dense "
        f"d_ff {cfg.d_ff}; {cfg.n_experts} experts top-{cfg.moe_top_k} + "
        f"{cfg.n_shared_experts} shared, moe_d_ff {cfg.moe_d_ff}; V "
        f"{cfg.vocab_size}, untied; MTP {cfg.mtp_depth}), depth cut from "
        f"{full.n_layers} layers to {n_layers} (one of each segment): "
        f"{n_params / 1e9:.3f} B f32 params ({n_params * 4 / 1e9:.2f} GB) "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s, the MTP "
        f"block on the MoE layer's tensors; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    rng = np.random.default_rng(SEED + 13)
    reqs = moe_requests(cfg, rng)
    greedy = [i for i, r in enumerate(reqs) if r[2] is None]
    pol = dataclasses.replace(THROUGHPUT, max_batch=len(reqs))

    def server(**kw):
        if "paging" not in kw:
            kw["max_seq"] = MLA_MAX_SEQ
        return TokenServer(cfg, params, policy=pol, decode_kernel=True,
                           cache_dtype=torch.float32, **kw)

    # (a) the contiguous drain, after a short warm-up drain
    paged_drain(server(), [(reqs[0][0][:8], 2, None),
                           (reqs[1][0][:8], 2, reqs[1][2])])
    t1 = time.perf_counter()
    srv = server()
    finite, kept = [], {}
    step = srv.model.decode_step

    def checked(cache, tokens):
        logits, cache = step(cache, tokens)
        finite.append(torch.isfinite(logits).all())
        if len(finite) == MLA_TAP_STEP + 1:
            kept["logits"] = logits[:, -1].clone()
        return logits, cache
    srv.model.decode_step = checked
    with mla_tap(n_layers * MLA_TAP_STEP) as ltap, \
            moe_tap({MLA_TAP_STEP}) as mtap:
        out, dt = paged_counted(total, lambda: paged_drain(srv, reqs))
    counts = dict(total)
    steps = srv.stats["steps"]
    for i, (o, (_, mx, _)) in enumerate(zip(out, reqs)):
        o = np.asarray(o)
        if len(o) != mx or not ((o >= 0) & (o < cfg.vocab_size)).all():
            fail(f"mla: request {i} returned {len(o)} tokens (want {mx}) or "
                 f"ids outside the vocabulary")
    if not bool(torch.stack(finite).all()):
        fail("mla: non-finite logits in the contiguous drain")
    want = {"decode_attention": 0, "topk_logits": steps,
            "topk_sample": steps}
    got = {name: counts[name] for name in want}
    if got != want:
        fail(f"mla: the contiguous drain launched {got} over {steps} steps, "
             f"want {want} (MLA decodes in its absorbed plain form; the "
             f"sampler's two stages 1 a step)")
    if ltap["calls"] != n_layers * steps:
        fail(f"mla: {ltap['calls']} mla_decode calls over {steps} steps, "
             f"want {n_layers} a step")
    gen = sum(len(o) for o in out)
    log(f"mla: (a) contiguous TokenServer, {len(reqs)} slots, float32 "
        f"caches: {len(reqs)} requests of {[p.shape[0] for p, _, _ in reqs]} "
        f"prompt tokens, max_new 16, {len(reqs) - len(greedy)} sampled (top_k"
        f" 20): {gen} tokens in {dt:.3f} s = {gen / dt:.1f} generated "
        f"tokens/s, {steps} steps ({steps / dt:.2f} steps/s, "
        f"{dt / steps * 1e3:.1f} ms a step), {srv.stats['syncs']} syncs; "
        f"logits finite; launches {got}, mla_decode {ltap['calls']}")
    x_dec = mtap["kept"][MLA_TAP_STEP]
    t2 = time.perf_counter()

    # (b) the greedy half paged, and two greedy requests on the longest
    # greedy prompt's head: its whole prompt, and its first MLA_PREFIX
    # tokens before a tail of their own
    head = max(greedy, key=lambda i: reqs[i][0].shape[0])
    hp = reqs[head][0]
    if hp.shape[0] <= MLA_PREFIX:
        fail(f"mla: the longest greedy prompt has {hp.shape[0]} tokens, not "
             f"more than the {MLA_PREFIX} to share")
    tail = rng.integers(1, cfg.vocab_size, 24).astype(np.int32)
    todo = [reqs[i] for i in greedy] + [(hp, 16, None), (np.concatenate(
        [hp[:MLA_PREFIX], tail]), 16, None)]
    psrv = server(paging=PagedCacheConfig(**MLA_PAGED))
    turned = []
    admit = psrv._admit_pages
    psrv._admit_pages = lambda slot, r: turned.append(
        admit(slot, r)) or turned[-1]
    pout, pdt = paged_counted(total, lambda: paged_drain(psrv, todo))
    paged_check(psrv, pout, todo, cfg.vocab_size, MLA_ARCH)
    hits = psrv.paging_stats()["hits"]
    replay = mla_replay_hits(cfg, todo, pol)
    waited = sum(t < 0 for t in turned)
    if not waited or not hits or hits != replay:
        fail(f"mla: paged: admission waited {waited} times, {hits} prefix "
             f"hits, the host replay {replay} (want waits, and hits equal "
             f"and > 0)")
    ref_outs = [out[i] for i in greedy] + [out[head]]
    near = near_ties(srv.model, todo[:-1], ref_outs, pout[:-1],
                     f"{MLA_ARCH} paged vs contiguous", MLA_MAX_SEQ)
    log(f"mla: (b) paged (PagedCacheConfig({MLA_PAGED})): the "
        f"{len(greedy)} greedy requests and two on request {head}'s "
        f"{hp.shape[0]}-token prompt (all of it; its first {MLA_PREFIX} "
        f"tokens and 24 of its own) in {pdt:.3f} s, "
        f"{psrv.stats['steps']} steps; admission waited {waited} times; "
        f"{hits} prefix hits = the host replay's; tokens equal the "
        f"contiguous server's ({near} parted at a near-tie); pages "
        f"{psrv.paging_stats()}")
    del psrv
    t3 = time.perf_counter()

    # (c) one prefill call; (g) mtp_hidden on the same prompt's hidden
    pmodel = build_model(cfg, device="cuda", params=params)
    prefill = make_prefill_step(pmodel, cfg)
    b, s = MLA_PREFILL
    tokens = torch.randint(1, cfg.vocab_size, (b, s), generator=torch.Generator(
        device="cuda").manual_seed(SEED + 13), device="cuda",
        dtype=torch.int32)

    def hidden():
        with torch.inference_mode():
            return pmodel.apply(tokens)[0]
    before = dict(total)
    h = paged_counted(total, hidden)               # and the warm-up
    with moe_tap(set(), aux=True) as ftap, swa_tap(mla) as stap:
        def call():
            t = time.perf_counter()
            logits = prefill({"tokens": tokens})
            torch.cuda.synchronize()
            return logits, time.perf_counter() - t
        logits, fdt = paged_counted(total, call)
    pcounts = {k: total[k] - before[k] for k in KERNELS}
    want = {**dict.fromkeys(KERNELS, 0), "swa_attention": 4 * n_layers}
    if pcounts != want:
        fail(f"mla: the forward and the prefill call launched {pcounts}, "
             f"want swa_attention {4 * n_layers} (prepass and main kernel a "
             f"layer, each) alone")
    if logits.shape != (b, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"mla: prefill logits {tuple(logits.shape)} not finite or of "
             f"another shape")
    drops = [float(a["moe_drop_frac"]) for a in ftap["aux"]]
    log(f"mla: (c) make_prefill_step at B={b} S={s}: {fdt * 1e3:.1f} ms = "
        f"{b * s / fdt:.1f} prompt tokens/s, swa_attention "
        f"{pcounts['swa_attention'] // 2} launches (2 a layer), logits "
        f"{tuple(logits.shape)} finite; moe_drop_frac "
        f"{[round(d, 6) for d in drops]} (capacity {moe.capacity(s, cfg)} a "
        f"group of {s} tokens)")
    t4 = time.perf_counter()
    shifted = torch.roll(tokens, -1, dims=1)
    with torch.inference_mode():
        before = dict(total)
        torch.cuda.synchronize()
        tm = time.perf_counter()
        hm = paged_counted(total, lambda: pmodel.mtp_hidden(h, shifted))
        mdt = time.perf_counter() - tm
    mcounts = {k: total[k] - before[k] for k in KERNELS}
    if hm.shape != h.shape or not bool(torch.isfinite(hm).all()) or \
            mcounts["swa_attention"] != 2:
        fail(f"mla: mtp_hidden gave {tuple(hm.shape)} (want "
             f"{tuple(h.shape)}), finite {bool(torch.isfinite(hm).all())}, "
             f"launches {mcounts}")
    log(f"mla: (g) mtp_hidden on (c)'s hidden {tuple(h.shape)} and the "
        f"shifted tokens: {tuple(hm.shape)} finite in {mdt * 1e3:.1f} ms "
        f"(the MTP block's MLA and MoE at S={s}; swa_attention 1 call)")
    del h, hm
    t5 = time.perf_counter()

    # (d) the last logits of a 64-token prompt: prefill against decode,
    # at a capacity that keeps every assignment (capacity(64) = 8 a
    # group drops at prefill, and a decode step's one-token groups never
    # drop): the decompressed MLA against the absorbed one
    nodrop = cfg.replace(capacity_factor=cfg.n_experts / cfg.moe_top_k)
    if moe.capacity(MLA_PROMPT, nodrop) < MLA_PROMPT:
        fail(f"mla: capacity {moe.capacity(MLA_PROMPT, nodrop)} a group of "
             f"{MLA_PROMPT} tokens can drop")
    prompt = tokens[:, :MLA_PROMPT]
    pre = paged_counted(total, lambda: make_prefill_step(build_model(
        nodrop, device="cuda", params=params), nodrop)({"tokens": prompt}))
    dec_model = build_model(nodrop, device="cuda", params=params,
                            decode_kernel=True)
    cache = dec_model.init_cache(1, MLA_PROMPT, torch.float32, per_row=True)
    before = dict(total)

    def decode():
        nonlocal cache
        for t in range(MLA_PROMPT):
            dec, cache = dec_model.decode_step(cache, prompt[:, t:t + 1])
        return dec
    dec = paged_counted(total, decode)
    err = rel_err(pre, dec)
    if not err <= LM_LOGIT_REL:
        fail(f"mla: the {MLA_PROMPT}-token prompt's last prefill logits "
             f"differ from decode_step's by {err:.3e} > {LM_LOGIT_REL} of "
             f"max(1, |decode|)")
    top = int(torch.argmax(pre[0, 0]))
    log(f"mla: (d) a {MLA_PROMPT}-token prompt at capacity factor "
        f"{nodrop.capacity_factor} (capacity "
        f"{moe.capacity(MLA_PROMPT, nodrop)} a group: no drops): the "
        f"decompressed prefill's last logits within {err:.3e} of max(1, "
        f"|decode|) of the absorbed decode_step's after the same tokens "
        f"(limit {LM_LOGIT_REL}, float32 cache; argmax {top} both: "
        f"{int(torch.argmax(dec[0, 0])) == top})")
    del dec_model, cache
    t6 = time.perf_counter()

    # (e) layer 0's mla_decode on the host, on the card's inputs
    host = host_params(pmodel.seg0[0]["p0"]["mixer"])
    inp = ltap["inputs"]
    hcache = {k: a.cpu() for k, a in inp["cache"].items()}
    with torch.inference_mode():
        y_h, hcache = mla.mla_decode(
            host, cfg, inp["x"].cpu(), hcache, inp["pos"].cpu(),
            rope_tables=None if inp["rope_tables"] is None else
            tuple(t.cpu() for t in inp["rope_tables"]))
    err_y = rel_err(ltap["y"].cpu(), y_h)
    err_c = max(rel_err(ltap["after"][k].cpu(), hcache[k]) for k in hcache)
    if not (err_y <= MLA_HOST_REL and err_c <= MLA_HOST_REL):
        fail(f"mla: layer 0's mla_decode at decode step {MLA_TAP_STEP}: the "
             f"card's y differs from the host's by {err_y:.3e}, its cache by "
             f"{err_c:.3e} (limit {MLA_HOST_REL} of max(1, |host|))")
    log(f"mla: (e) layer 0's mla_decode at decode step {MLA_TAP_STEP} (x "
        f"{tuple(inp['x'].shape)}, cache {tuple(hcache['c_kv'].shape)} + "
        f"{tuple(hcache['k_rope'].shape)}, pos "
        f"{int(inp['pos'].min())}-{int(inp['pos'].max())}) re-run on the "
        f"host: y within {err_y:.3e}, the written cache within {err_c:.3e} "
        f"of max(1, |host|) (limit {MLA_HOST_REL})")
    del host, hcache
    t7 = time.perf_counter()

    # (f) the kernels at this path's shapes
    MLA_TIMES.update(mla_kernel_times(stap["inputs"], kept["logits"]))
    del stap
    t8 = time.perf_counter()

    # (h) one traced window of 16 decode steps, then the MoE layer and the
    # MLA layers alone on their inputs of one step
    tsrv = server()
    wsteps, prof = traced_window(tsrv, reqs)
    del tsrv
    busy, ops = prof["busy_ms"] / wsteps, prof["ops"] / wsteps
    ffn = pmodel.seg1[0]["p0"]["ffn"]
    mixers = [pmodel.seg0[0]["p0"]["mixer"], pmodel.seg1[0]["p0"]["mixer"]]
    mcache = dict(inp["cache"])

    def moe_only():
        with torch.inference_mode():
            for _ in range(wsteps):
                moe.moe_apply(ffn, cfg, x_dec)

    def mla_only():
        with torch.inference_mode():
            for _ in range(wsteps):
                for mx in mixers:
                    mla.mla_decode(mx, cfg, inp["x"], mcache, inp["pos"],
                                   rope_tables=inp["rope_tables"])
    mprof = profile_device(moe_only, host_ops=False)
    aprof = profile_device(mla_only, host_ops=False)
    m_busy, a_busy = mprof["busy_ms"] / wsteps, aprof["busy_ms"] / wsteps
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    expert_bytes = 3 * e * d * f * 4
    mla_bytes = sum(p.numel() for p in pmodel.seg0[0]["p0"][
        "mixer"].parameters()) * 4
    top3 = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][1])[:3]
    log(f"mla: (h) one traced window of {wsteps} decode steps "
        f"({len(reqs)} rows): {ops:.1f} device ops and {busy:.3f} device ms "
        f"a step (wall {prof['wall_ms'] / wsteps:.1f} ms, idle "
        f"{1 - prof['busy_ms'] / prof['wall_ms']:.1%}); the MoE layer alone "
        f"on its (B={x_dec.shape[0]}, 1, D) input {m_busy:.3f} device ms a "
        f"step = {m_busy / busy:.1%} (reading its {expert_bytes / 1e9:.2f} GB "
        f"of expert weights once takes "
        f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); the {n_layers} MLA "
        f"layers alone {a_busy:.3f} device ms a step = {a_busy / busy:.1%} "
        f"({mla_bytes / 1e9:.2f} GB of weights a layer, "
        f"{mla_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms to read once); largest "
        f"device lines a step: " + "; ".join(
            f"{name[:60]} {n / wsteps:.1f}x {ms / wsteps:.3f} ms"
            for name, (n, ms) in top3))
    t9 = time.perf_counter()
    log(f"mla: seconds by part: weights {t1 - t0:.1f}, contiguous {t2 - t1:.1f}"
        f", paged {t3 - t2:.1f}, prefill {t4 - t3:.1f}, mtp {t5 - t4:.1f}, "
        f"prefill vs decode {t6 - t5:.1f}, host {t7 - t6:.1f}, kernels "
        f"{t8 - t7:.1f}, traced {t9 - t8:.1f}")
    return total, torch.cuda.max_memory_allocated() / 1e9


def phase_mla() -> dict:
    """``mla_run``, then every tensor it made freed before the next
    phase."""
    import gc
    import torch
    total, peak = mla_run()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"mla: peak max_memory_allocated {peak:.2f} GB; freed: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved after the "
        f"phase")
    return total


# ------------------------------------------------------- recurrent mixers

RECURRENT_ARCHS = ("recurrentgemma-2b", "xlstm-350m")
RECURRENT_MAX_SEQ = 2048           # the local layers' rings at their window
RECURRENT_TAP_STEP = 40            # the decode step whose mixer (and, for
                                   # recurrentgemma, decode_attention)
                                   # inputs are re-run on the host
RECURRENT_PREFILL = {"recurrentgemma-2b": (1, 2048),   # make_prefill_step's
                     "xlstm-350m": (1, 512)}           # (B, S)
RECURRENT_PROMPT = 64              # (d): prefill against decode
RECURRENT_HOST_REL = 1e-4          # card vs host mixer output and state, of
                                   # max(1, |host|)
RECURRENT_TIMES = {}               # phase_recurrent's kernel times at its
                                   # shapes, for the kernel rows


@contextlib.contextmanager
def recurrent_tap(mixer: str, keep: dict):
    """While the model runs, keep clones of the inputs and outputs of
    one call of the ``mixer`` layers: ``keep`` maps "apply" / "decode"
    to the call index to keep (from 0; a model of L such layers makes L
    calls a forward or a step).  The transformer dispatches through its
    ``_RECURRENT`` table, so the spy goes there."""
    from repro_torch.models import transformer
    real = transformer._RECURRENT[mixer]
    tap = {"apply": {"calls": 0}, "decode": {"calls": 0}}

    def clone(st):
        return None if st is None else {k: a.clone() for k, a in st.items()}

    def spy(kind, fn):
        rec = tap[kind]

        def call(params, cfg, x, *state):
            hit = rec["calls"] == keep.get(kind, -1)
            if hit:
                rec.update(x=x.clone(), state=clone(state[0] if state
                                                    else None),
                           params=params)
            rec["calls"] += 1
            y, st = fn(params, cfg, x, *state)
            if hit:
                rec.update(y=y.clone(), after=clone(st))
            return y, st
        return call
    transformer._RECURRENT[mixer] = real._replace(
        apply=spy("apply", real.apply), decode=spy("decode", real.decode))
    try:
        yield tap
    finally:
        transformer._RECURRENT[mixer] = real


def host_params(params):
    """A layer's (nested) ParameterDict, copied to the host."""
    import torch
    return {n: host_params(p) if isinstance(p, torch.nn.ParameterDict)
            else p.detach().cpu() for n, p in params.items()}


def recurrent_host_check(mixer: str, kind: str, rec, cfg, what: str) -> float:
    """One mixer call the card made, re-run on the host on the card's
    inputs: y and every state leaf (dtype and shape equal) within
    RECURRENT_HOST_REL of max(1, |host|).  Returns the larger error."""
    import torch
    from repro_torch.models import transformer
    if "y" not in rec:
        fail(f"recurrent: {what}: no {mixer} {kind} call kept")
    fn = getattr(transformer._RECURRENT[mixer], kind)
    state = () if rec["state"] is None else (
        {k: a.cpu() for k, a in rec["state"].items()},)
    with torch.inference_mode():
        y, st = fn(host_params(rec["params"]), cfg, rec["x"].cpu(), *state)
    err = rel_err(rec["y"].cpu(), y)
    for k, a in st.items():
        card = rec["after"][k]
        if card.dtype != a.dtype or card.shape != a.shape:
            fail(f"recurrent: {what}: {mixer} {kind} state {k} "
                 f"{tuple(card.shape)} {card.dtype} on the card, "
                 f"{tuple(a.shape)} {a.dtype} on the host")
        err = max(err, rel_err(card.cpu(), a))
    if not err <= RECURRENT_HOST_REL:
        fail(f"recurrent: {what}: the card's {mixer} {kind} differs from "
             f"the host's by {err:.3e} > {RECURRENT_HOST_REL} of max(1, "
             f"|host|)")
    return err


def topk_times(logits, k: int) -> dict:
    """``topk_logits`` on one decode step's (R, V) logits: stage 1 and
    the merged output bitwise the plain versions at k 1 and ``k``, then
    timed beside the plain sort, ``torch.topk`` and the bound."""
    import torch
    from repro_torch.kernels.topk_logits import ops as tk_ops
    from repro_torch.kernels.topk_logits import ref as tk_ref
    rows, vocab = logits.shape
    worst = max(check_kernel(logits, kk, f"one decode step's logits R={rows} "
                                         f"V={vocab} k={kk}")
                for kk in (1, k))
    bytes_ms = (rows * vocab * 4 + rows * k * 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * vocab * k / F32_OPS_PER_S * 1e3
    return {"ms": time_ms(lambda: tk_ops.topk_logits(logits, k)),
            "device_ms": device_ms(lambda: tk_ops.topk_logits(logits, k),
                                   "topk_"),
            "plain_ms": time_ms(lambda: tk_ref.topk_logits_ref(logits, k)),
            "library_ms": time_ms(lambda: torch.topk(logits, k, dim=-1)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": worst, "at": f"R={rows} V={vocab} k={k}"}


@contextlib.contextmanager
def topk_sample_tap(at: int):
    """While a server builds and runs its decode windows, keep clones of
    the arguments and output of one sampled ``topk_sample`` call: the
    first made in decode step ``at`` (from 0; one call a step) or after
    it, else the last before it.  A window binds the op when it is built,
    so the spy stays in the windows built under it and keeps nothing
    once the tap is closed."""
    import repro_torch.kernels.topk_sample as ts_pkg
    real = ts_pkg.topk_sample
    tap = {"calls": 0, "open": True}

    def spy(logits, *args, **kw):
        step = tap["calls"]
        tap["calls"] += 1
        out = real(logits, *args, **kw)
        if tap["open"] and args and not kw.get("greedy") and (
                "args" not in tap or tap["step"] < at):
            tap.update(step=step, kw=kw,
                       args=tuple(t.clone() for t in (logits, *args)),
                       out=tuple(t.clone() for t in out))
        return out
    ts_pkg.topk_sample = spy
    try:
        yield tap
    finally:
        tap["open"] = False
        ts_pkg.topk_sample = real


def recurrent_topk_sample(tap, arch: str) -> dict:
    """The sampled ``topk_sample`` call a drain made (``topk_sample_tap``)
    on its own inputs: held to its plain version (``check_topk_sample``),
    its tokens equal to the drain's, then timed (``topk_sample_times``)."""
    import torch
    from repro_torch.kernels.topk_sample import K_CAP_DEFAULT
    if "args" not in tap:
        fail(f"recurrent: {arch}: the drain made no sampled topk_sample call")
    x, *samp = tap["args"]
    kc = tap["kw"].get("k_cap", K_CAP_DEFAULT)
    rows, vocab = x.shape
    temp = samp[0]
    what = (f"{arch}'s sampled decode step {tap['step']}, R={rows} V={vocab} "
            f"k_cap={kc}, {int((temp > 0).sum())} rows sampled")
    out, near, moved = check_topk_sample(x, tuple(samp), kc, what)
    if not all(torch.equal(a, b) for a, b in zip(out, tap["out"])):
        fail(f"recurrent: topk_sample at {what} on the drain's inputs gave "
             f"other vals, ids or tokens than in the drain")
    return {**topk_sample_times(x, tuple(samp), kc), "max_abs_err": 0.0,
            "near_top_p": near, "moved_near_top_p": moved, "at": what}


def recurrent_requests(cfg, rng):
    """The moe phase's 8 requests, then a 9th: the shortest greedy one
    again, admitted mid-drain into a slot a finished request leaves.
    Returns (requests, the index of the request it repeats)."""
    reqs = moe_requests(cfg, rng)
    twin = min((i for i, r in enumerate(reqs) if r[2] is None),
               key=lambda i: reqs[i][0].shape[0])
    return reqs + [(reqs[twin][0], reqs[twin][1], None)], twin


def recurrent_run(arch: str, total: dict) -> dict:
    """One recurrent model at full widths and depth, weights drawn on the
    card from the seed (the embedding scaled by 1/sqrt(d)), through the
    port's entry points: (a) a ``TokenServer`` drain (8 slots, float32
    caches of RECURRENT_MAX_SEQ slots, fused kernels) of the moe phase's
    8 requests and a 9th admitted mid-drain into a reset row; (g) a
    traced window of 16 steps on the same warm server and the mixers'
    share of it; (b) each mixer's first layer's decode step re-run on the
    host; (c) the first local layer's ``decode_attention`` inputs held to
    the plain version (recurrentgemma); (d) the prefill of a drained
    request's first 64 prompt tokens against the drain's ``decode_step``
    after them, the mixers' prefill calls re-run on the host; (e) ``make_prefill_step`` timed at B=1 and S 2,048
    (recurrentgemma) or 512 (xlstm); (f) the kernels at this path's
    shapes, ``topk_sample`` on the drain's own sampled inputs.  Every
    part runs on the server's model.  Adds the launches of (a), (d) and
    (e) to ``total``; returns the kernel times."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import profile_device
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, transformer
    from repro_torch.serve import THROUGHPUT, TokenServer
    t0 = time.perf_counter()
    cfg = get_arch(arch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    params = build_model(cfg, device="cuda", generator=gen).state_dict()
    params["embed"].mul_(cfg.d_model ** -0.5)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    layers_by = collections.Counter(cfg.mixers())
    n_local = layers_by["swa"]
    # each recurrent mixer, with its first layer: the one re-run on the host
    mixers = [(m, cfg.mixers().index(m)) for m in layers_by
              if m in transformer._RECURRENT]
    log(f"recurrent: {arch} at full widths and depth (d {cfg.d_model}, "
        f"{cfg.n_layers} layers {dict(layers_by)}, V {cfg.vocab_size}): "
        f"{n_params / 1e9:.3f} B f32 params ({n_params * 4 / 1e9:.2f} GB) "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 28)
    reqs, twin = recurrent_requests(cfg, rng)
    pol = dataclasses.replace(THROUGHPUT, max_batch=8)

    def server():
        return TokenServer(cfg, params, policy=pol, decode_kernel=True,
                           cache_dtype=torch.float32,
                           max_seq=RECURRENT_MAX_SEQ)

    # (a) the drain, after a short warm-up drain on a server of its own
    paged_drain(server(), [(reqs[0][0][:8], 2, None),
                           (reqs[1][0][:8], 2, reqs[1][2])])
    t1 = time.perf_counter()
    srv = server()
    model = srv.model
    finite, kept = [], {}
    step, admit = model.decode_step, srv._admit_slot
    # (d)'s decode side: the logits of the row that consumes the first
    # RECURRENT_PROMPT tokens of request `pick`'s prompt, at the step that
    # feeds the last of them
    pick = next(i for i, r in enumerate(reqs)
                if r[0].shape[0] >= RECURRENT_PROMPT and i != twin)

    def admitted(slot, req):
        ok = admit(slot, req)
        if ok and "prompt_at" not in kept and np.array_equal(
                req.payload.prompt, reqs[pick][0]):
            kept["prompt_at"] = (slot, len(finite) + RECURRENT_PROMPT)
        return ok

    def checked(cache, tokens):
        logits, cache = step(cache, tokens)
        finite.append(torch.isfinite(logits).all())
        if len(finite) == RECURRENT_TAP_STEP + 1:
            kept["logits"] = logits[:, -1].clone()
        if (len(finite),) == kept.get("prompt_at", (None, None))[1:]:
            row = kept["prompt_at"][0]
            kept["prompt_logits"] = logits[row:row + 1, -1:].clone()
        return logits, cache
    model.decode_step, srv._admit_slot = checked, admitted
    with contextlib.ExitStack() as stack:
        taps = {m: stack.enter_context(recurrent_tap(
            m, {"decode": RECURRENT_TAP_STEP * layers_by[m]}))
            for m, _ in mixers}
        dtap = stack.enter_context(decode_attention_tap(
            model, RECURRENT_TAP_STEP))
        stap = stack.enter_context(topk_sample_tap(RECURRENT_TAP_STEP))
        before = dict(total)
        out, dt = paged_counted(total, lambda: paged_drain(srv, reqs))
    model.decode_step, srv._admit_slot = step, admit
    counts = {k: total[k] - before[k] for k in KERNELS}
    steps = srv.stats["steps"]
    for i, (o, (_, mx, _)) in enumerate(zip(out, reqs)):
        o = np.asarray(o)
        if len(o) != mx or not ((o >= 0) & (o < cfg.vocab_size)).all():
            fail(f"recurrent: {arch}: request {i} returned {len(o)} tokens "
                 f"(want {mx}) or ids outside the vocabulary")
    if not bool(torch.stack(finite).all()):
        fail(f"recurrent: {arch}: non-finite logits in the drain")
    want = {"decode_attention": n_local * steps, "topk_logits": steps,
            "topk_sample": steps}
    got = {name: counts[name] for name in want}
    if got != want:
        fail(f"recurrent: {arch}: the drain launched {got} over {steps} "
             f"steps, want {want} (decode_attention a local layer a step, "
             f"the sampler's two stages 1 a step)")
    for m, _ in mixers:
        if taps[m]["decode"]["calls"] != layers_by[m] * steps:
            fail(f"recurrent: {arch}: {taps[m]['decode']['calls']} {m} "
                 f"decode calls over {steps} steps, want {layers_by[m]} a "
                 f"step")
    near = near_ties(model, [reqs[-1]], [out[twin]], [out[-1]],
                     f"{arch}: the request admitted mid-drain vs request "
                     f"{twin}", RECURRENT_MAX_SEQ)
    n_tok = sum(len(o) for o in out)
    log(f"recurrent: (a) {arch} TokenServer, 8 slots, float32 caches of "
        f"{RECURRENT_MAX_SEQ} slots: {len(reqs)} requests of "
        f"{[p.shape[0] for p, _, _ in reqs]} prompt tokens, max_new 16, "
        f"{sum(r[2] is not None for r in reqs)} sampled (top_k 20): {n_tok} "
        f"tokens in {dt:.3f} s = {n_tok / dt:.1f} generated tokens/s, "
        f"{steps} steps ({steps / dt:.2f} steps/s, {dt / steps * 1e3:.1f} ms "
        f"a step), {srv.stats['syncs']} syncs; logits finite; launches "
        f"{got}; the 9th request (request {twin}'s prompt, admitted "
        f"mid-drain into a reset row) gave request {twin}'s greedy tokens "
        f"({near} parted at a near-tie)")
    t2 = time.perf_counter()

    # (g) one traced window of 16 decode steps on the warm server, then
    # the mixers alone on their decode inputs of (b), 4 times
    wsteps, prof = traced_window(srv, reqs[:8])
    del srv
    busy, ops = prof["busy_ms"] / wsteps, prof["ops"] / wsteps
    layers_of = {m: [blk[f"p{i}"]["mixer"]
                     for si, seg in enumerate(cfg.segments)
                     for blk in getattr(model, f"seg{si}")
                     for i, sp in enumerate(seg.pattern) if sp.mixer == m]
                 for m, _ in mixers}
    reps = 4

    def mixers_only():
        with torch.inference_mode():
            for _ in range(reps):
                for m, _ in mixers:
                    rec = taps[m]["decode"]
                    for p in layers_of[m]:
                        transformer._RECURRENT[m].decode(p, cfg, rec["x"],
                                                         rec["state"])
    mprof = profile_device(mixers_only, host_ops=False)
    m_busy, m_ops = mprof["busy_ms"] / reps, mprof["ops"] / reps
    top3 = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][1])[:3]
    w_bytes = n_params * 4
    log(f"recurrent: (g) {arch}: one traced window of {wsteps} decode steps "
        f"(8 rows) on the drain's server: {ops:.1f} device ops and "
        f"{busy:.3f} device ms a step (wall {prof['wall_ms'] / wsteps:.1f} "
        f"ms, idle {1 - prof['busy_ms'] / prof['wall_ms']:.1%}; reading the "
        f"{w_bytes / 1e9:.2f} GB of weights once takes "
        f"{w_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); the "
        + " and ".join(f"{layers_by[m]} {m}" for m, _ in mixers)
        + f" mixers alone on their step-{RECURRENT_TAP_STEP} inputs "
        f"{m_busy:.3f} device ms and {m_ops:.1f} ops a step = "
        f"{m_busy / busy:.1%} of the step's device ms; largest device lines "
        f"a step: " + "; ".join(f"{name[:60]} {n / wsteps:.1f}x "
                                f"{ms / wsteps:.3f} ms"
                                for name, (n, ms) in top3))
    t3 = time.perf_counter()

    # (b) each mixer's first layer's decode step on the host
    for m, layer in mixers:
        rec = taps[m]["decode"]
        err = recurrent_host_check(m, "decode", rec, cfg,
                                   f"{arch} layer {layer}, decode step "
                                   f"{RECURRENT_TAP_STEP}")
        log(f"recurrent: (b) layer {layer}'s {m} decode step "
            f"{RECURRENT_TAP_STEP} (x {tuple(rec['x'].shape)}, state "
            + ", ".join(f"{k} {tuple(a.shape)} {str(a.dtype)[6:]}"
                        for k, a in rec["state"].items())
            + f") re-run on the host: y and the new state within {err:.3e} "
            f"of max(1, |host|) (limit {RECURRENT_HOST_REL})")

    # (d) the last logits of request `pick`'s first 64 prompt tokens,
    # prefill against the drain's decode_step after the same tokens; the
    # mixers' prefill calls on the host
    prefill = make_prefill_step(model, cfg)
    ptok = torch.as_tensor(reqs[pick][0][:RECURRENT_PROMPT],
                           dtype=torch.int32, device="cuda")[None]
    with contextlib.ExitStack() as stack:
        ptaps = {m: stack.enter_context(recurrent_tap(m, {"apply": 0}))
                 for m, _ in mixers}
        pre = paged_counted(total, lambda: prefill({"tokens": ptok}))
    if "prompt_logits" not in kept:
        fail(f"recurrent: {arch}: the drain kept no logits after request "
             f"{pick}'s first {RECURRENT_PROMPT} prompt tokens")
    dec = kept["prompt_logits"]
    err = rel_err(pre, dec)
    if not err <= LM_LOGIT_REL:
        fail(f"recurrent: {arch}: the {RECURRENT_PROMPT}-token prompt's last "
             f"prefill logits differ from decode_step's by {err:.3e} > "
             f"{LM_LOGIT_REL} of max(1, |decode|)")
    top = int(torch.argmax(pre[0, 0]))
    log(f"recurrent: (d) request {pick}'s first {RECURRENT_PROMPT} prompt "
        f"tokens: the prefill's last logits within {err:.3e} of max(1, "
        f"|decode|) of the drain's decode_step after the same tokens (row "
        f"{kept['prompt_at'][0]} of 8, decode step "
        f"{kept['prompt_at'][1] - 1}; limit {LM_LOGIT_REL}, float32 cache; "
        f"argmax {top} both: {int(torch.argmax(dec[0, 0])) == top})")
    for m, layer in mixers:
        rec = ptaps[m]["apply"]
        err = recurrent_host_check(m, "apply", rec, cfg,
                                   f"{arch} layer {layer}, the "
                                   f"{RECURRENT_PROMPT}-token prefill")
        log(f"recurrent: (d) layer {layer}'s {m} apply on the prefill's x "
            f"{tuple(rec['x'].shape)} re-run on the host: y and the final "
            f"state within {err:.3e} of max(1, |host|)")
    del ptaps
    t4 = time.perf_counter()

    # (e) make_prefill_step at (B, S): a warm-up call at S, then timed
    b, s = RECURRENT_PREFILL[arch]
    tokens = torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda", dtype=torch.int32)
    calls = 2 if n_local else 1
    times = []

    def call():
        t = time.perf_counter()
        logits = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return logits
    with swa_tap() as swtap:
        if n_local:
            paged_counted(total, call)
        before = dict(total)
        for _ in range(calls):
            logits = paged_counted(total, call)
    pcounts = {k: (total[k] - before[k]) // calls for k in KERNELS}
    want = {**dict.fromkeys(KERNELS, 0), "swa_attention": 2 * n_local}
    if pcounts != want:
        fail(f"recurrent: {arch}: a prefill call launched {pcounts}, want "
             f"swa_attention {2 * n_local} (the prepass and the main kernel "
             f"a local layer) alone")
    if logits.shape != (b, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"recurrent: {arch}: prefill logits {tuple(logits.shape)} not "
             f"finite or of another shape")
    timed = times[-calls:]
    log(f"recurrent: (e) make_prefill_step at B={b} S={s}: "
        + " / ".join(f"{t * 1e3:.1f}" for t in timed) + " ms = "
        + " / ".join(f"{b * s / t:.1f}" for t in timed)
        + " prompt tokens/s" + (
            f" ({n_local} local layers through swa_attention, the RG-LRU as "
            f"a log-depth scan)" if n_local else
            f" (sequential by nature: the mLSTM and sLSTM loops take {s} "
            f"steps in each of {cfg.n_layers} layers, one call, no warm-up "
            f"at S but (d)'s)")
        + f"; logits {tuple(logits.shape)} finite")
    del model, prefill
    t5 = time.perf_counter()

    # (f) the kernels at this path's shapes
    found = {"topk_logits": topk_times(kept["logits"], MLA_K),
             "topk_sample": recurrent_topk_sample(stap, arch)}
    tk, ts = found["topk_logits"], found["topk_sample"]
    log(f"recurrent: (f) topk_logits on one decode step's logits, "
        f"{tk['at']}: stage 1 and merged bitwise the plain versions at k 1 "
        f"and {MLA_K}; {tk['ms']:.4f} ms (device only {tk['device_ms']:.4f} "
        f"ms), plain sort {tk['plain_ms']:.4f} ms, torch.topk "
        f"{tk['library_ms']:.4f} ms, bound {tk['bound_ms']:.4f} ms "
        f"({tk['bound_by']})")
    log(f"recurrent: (f) topk_sample on {ts['at']}: vals bitwise with sign "
        f"bits, idx exact, tokens equal to the plain version's away from "
        f"top_p boundaries ({ts['near_top_p']} rows within {EXCL_WINDOW}, "
        f"{ts['moved_near_top_p']} moved there) and to the drain's; stage "
        f"1 + 2 {ts['ms']:.4f} ms (device only {ts['device_ms']:.4f}), "
        f"stage 2 {ts['stage2_ms']:.4f} ms (device only "
        f"{ts['stage2_device_ms']:.4f}, bound {ts['stage2_bound_ms']:.5f}, "
        f"bytes), with the threefry noise {ts['with_noise_ms']:.4f} ms, "
        f"plain {ts['plain_ms']:.4f} ms, torch.topk {ts['library_ms']:.4f} "
        f"ms, bound {ts['bound_ms']:.4f} ms (bytes)")
    if n_local:
        checked = check_tapped(dtap, arch)
        if set(checked) != {True}:
            fail(f"recurrent: decode_attention modes {sorted(checked)}, want "
                 f"write=True alone (the local layers' rings)")
        inputs, pos, kw = dtap["kept"][True]
        q, ck = inputs[0], inputs[3]
        da = found["decode_attention"] = {
            **decode_attention_times(inputs, pos, kw),
            "max_abs_err": checked[True]["max_abs_err"],
            "at": f"B={q.shape[0]} Hkv={ck.shape[1]} G="
                  f"{q.shape[1] // ck.shape[1]} hd={q.shape[3]} ring "
                  f"S={ck.shape[2]} (window {kw.get('window', 0)}) "
                  f"{str(ck.dtype)[6:]}, pos {int(pos.min())}-"
                  f"{int(pos.max())}"}
        log(f"recurrent: (c) decode_attention on the first local layer's "
            f"inputs of decode step {RECURRENT_TAP_STEP}, {da['at']}: caches "
            f"bitwise, o within {da['max_abs_err']:.3e} of max(1, |plain|); "
            f"{da['ms']:.4f} ms (device only {da['device_ms']:.4f}), plain "
            f"{da['plain_ms']:.4f} ms, SDPA over the written ring "
            f"{da['library_ms']:.4f} ms (device only "
            f"{da['library_device_ms']:.4f}), bound {da['bound_ms']:.4f} ms "
            f"({da['bound_by']})")
        q, k, v = swtap["inputs"]
        window = swtap["window"]
        hq, hkv = q.shape[1], k.shape[1]
        at = (f"B={q.shape[0]} Hq={hq} Hkv={hkv} hd={q.shape[3]} "
              f"S={q.shape[2]}")
        err, _ = check_swa((q, k, v), window, f"{arch} prefill ({at})")
        sdpa = sdpa_repeated(q, k, v, window, causal=window >= q.shape[2])
        backend = f"EFFICIENT_ATTENTION over kv repeated {hq // hkv}-fold, " \
            f"is_causal"
        if sdpa is None:          # the efficient backend refuses this hd

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            backend = "the default backend with enable_gqa, is_causal"
        bnd, by, cuda_cores = swa_bound(q.shape[0], hq, hkv, q.shape[2],
                                        q.shape[3], window)
        sw = found["swa_attention"] = {
            **swa_times((q, k, v), window, err, sdpa, backend, (bnd, by)),
            "cuda_core_ms": cuda_cores, "at": f"{at} window {window} f32"}
        log(f"recurrent: (f) swa_attention on the prefill's first local "
            f"layer, {sw['at']}: o within {sw['max_abs_err']:.3e} of max(1, "
            f"|plain|) (limit {ATTN_REL}); {sw['ms']:.4f} ms (device only, "
            f"both launches {sw['device_ms']:.4f}), plain "
            f"{sw['plain_ms']:.4f} ms, SDPA {sw['library_backend']} "
            f"{sw['library_ms']:.4f} ms, bound {sw['bound_ms']:.4f} ms "
            f"({sw['bound_by']}, 3xTF32; {sw['cuda_core_ms']:.4f} on the "
            f"CUDA cores)")
    elif any(dtap["modes"].values()) or swtap:
        fail(f"recurrent: {arch} has no attention layer but an attention "
             f"kernel was called")
    t6 = time.perf_counter()
    log(f"recurrent: {arch} seconds by part: weights and warm-up "
        f"{t1 - t0:.1f}, drain {t2 - t1:.1f}, traced {t3 - t2:.1f}, host "
        f"decode and prefill vs decode {t4 - t3:.1f}, prefill "
        f"{t5 - t4:.1f}, kernels {t6 - t5:.1f}; peak max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return found


def phase_recurrent() -> dict:
    """``recurrent_run`` for recurrentgemma-2b, then for xlstm-350m, every
    tensor of the first freed before the second is drawn.  Returns the
    path's launches; the kernel times go to RECURRENT_TIMES."""
    import gc
    import torch
    total = dict.fromkeys(KERNELS, 0)
    for arch in RECURRENT_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for name, t in recurrent_run(arch, total).items():
            RECURRENT_TIMES.setdefault(name, {})[arch] = t
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("topk_logits", "topk_sample", "decode_attention",
                 "swa_attention"):
        if not total[name]:
            fail(f"recurrent: the path launched no {name}")
    log(f"recurrent: launches {total}; freed: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after the "
        f"phase")
    return total


# ------------------------------------------------------------ token-LM prefill

PREFILL_ARCH = "h2o-danube-3-4b"
PREFILL_SHAPES = ((2, 8192), (2, 2048))      # (B, S): banded, causal
PREFILL_CALLS = 3


def phase_prefill() -> dict:
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.swa_attention import swa_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention, build_model, layers
    gc.collect()                     # the lm phase's model is gone
    torch.cuda.empty_cache()
    cfg = get_arch(PREFILL_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 8))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"prefill: {PREFILL_ARCH} ({n_params / 1e9:.3f} B params, f32) drawn "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    step = make_prefill_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def tokens(b, s):
        return torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                             device="cuda", dtype=torch.int32)
    batches = {shape: {"tokens": tokens(*shape)} for shape in PREFILL_SHAPES}
    for batch in batches.values():                      # warm-up
        step(batch)
    torch.cuda.synchronize()
    launch_counts(reset=True)
    before = 0
    for (b, s), batch in batches.items():
        times = []
        for _ in range(PREFILL_CALLS):
            t0 = time.perf_counter()
            logits = step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = launch_counts()
        per_call = (counts["swa_attention"] - before) / PREFILL_CALLS
        before = counts["swa_attention"]
        # two launches a layer: the prepass that writes k and v as the
        # main loop's TF32 images, then the tensor-core kernel
        if per_call != 2 * cfg.n_layers:
            fail(f"prefill: {per_call} swa_attention launches per call at "
                 f"B={b} S={s}, want {2 * cfg.n_layers}")
        if logits.shape != (b, 1, cfg.vocab_size) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            fail(f"prefill: logits {tuple(logits.shape)} {logits.dtype} "
                 f"(finite: {bool(torch.isfinite(logits).all())}) at B={b} "
                 f"S={s}")
        branch = "banded, window 4096" if s > SWA_WINDOW else "causal"
        log(f"prefill: B={b} S={s} ({branch}): "
            + " / ".join(f"{t * 1e3:.1f}" for t in times) + " ms per call = "
            + " / ".join(f"{b * s / t:.1f}" for t in times)
            + f" prompt tokens/s; {per_call:.0f} swa_attention launches per "
            f"call; logits {tuple(logits.shape)} finite")
    others = {k: v for k, v in counts.items() if k != "swa_attention" and v}
    if others:
        fail(f"prefill: the path launched other kernels too: {others}")
    for (b, s), batch in batches.items():
        log(f"prefill: B={b} S={s}, traced:")
        traced(f"prefill S={s}", lambda: step(batch))

    # layer 0's attention: the kernel against the plain twins on the same
    # card tensors (the banded twin at S=8192, the causal one at 2048)
    p0 = model.seg0[0]["p0"]
    spec = cfg.segments[0].pattern[0]
    with torch.inference_mode():
        for (b, s), batch in batches.items():
            x = layers.norm_apply(p0["norm1"], model.embed_tokens(
                batch["tokens"]), cfg.norm)
            pos = torch.arange(s, device="cuda")
            q, k, v = attention._project_qkv(p0["mixer"], cfg, x, pos)
            window = spec.window if spec.window < s else s
            ko = swa_attention(q, k, v, window)
            qg = attention._group(q, cfg.n_kv_heads)
            if spec.window < s:
                twin = attention.windowed_attention(qg, k, v, 0, spec.window)
                name = "windowed_attention"
            else:
                twin = attention.flash_full_attention(qg, k, v, pos, pos)
                name = "flash_full_attention"
            err = rel_err(ko, twin.reshape(ko.shape))
            if not err <= ATTN_REL:
                fail(f"prefill: layer 0's swa_attention vs {name} at S={s}: "
                     f"{err:.3e} > {ATTN_REL}")
            # explicit positions arange(S): the banded branch masks by
            # index whatever they say, the causal one by them (every key
            # tile): both the values of positions=None
            by_index = attention.attention_apply(p0["mixer"], cfg, spec, x)
            perr = rel_err(attention.attention_apply(p0["mixer"], cfg, spec,
                                                     x, pos), by_index)
            if not perr <= ATTN_REL:
                fail(f"prefill: layer 0's attention_apply at positions "
                     f"arange(S) vs None at S={s}: {perr:.3e} > {ATTN_REL}")
            log(f"prefill: layer 0 at B={b} S={s}: swa_attention == {name} "
                f"on the same card tensors within {ATTN_REL} of max(1, "
                f"|plain|) (error {err:.3e}); attention_apply at positions "
                f"arange(S) == at None ({perr:.3e})")
            del x, q, k, v, ko, qg, twin, by_index

    # the last logits of a 64-token prompt: prefill against decode
    prompt = tokens(1, 64)
    pre = step({"tokens": prompt})
    dec_model = build_model(cfg, device="cuda", params=model.state_dict(),
                            decode_kernel=True)
    cache = dec_model.init_cache(1, 64, torch.float32, per_row=True)
    for t in range(64):
        dec, cache = dec_model.decode_step(cache, prompt[:, t:t + 1])
    err = rel_err(pre, dec)
    if not err <= LM_LOGIT_REL:
        fail(f"prefill: the 64-token prompt's last logits differ from "
             f"decode_step's by {err:.3e} > {LM_LOGIT_REL} of max(1, |decode|)")
    top = int(torch.argmax(pre[0, 0]))
    log(f"prefill: a 64-token prompt at B=1: last logits within "
        f"{LM_LOGIT_REL} of max(1, |decode|) of decode_step after the same "
        f"64 tokens (float32 cache, decode_kernel=True; error {err:.3e}, "
        f"argmax {top} both: {int(torch.argmax(dec[0, 0])) == top})")
    return counts


# --------------------------------------------------------- LM training

LM_TRAIN_LAYERS = 18               # (d): qwen2.5-3b's 36 layers cut to 18:
                                   # 1.699 B f32 parameters, ~32 bytes each
                                   # at the Adam update's peak (the dry
                                   # run's 28 and the module's own 4), ~54
                                   # GB before activations; all 36 would
                                   # take ~99 GB
LM_TRAIN_SHAPE = (2, 512)          # (B, S) of (c) and (d)
LM_TRAIN_STEPS = 8                 # (d): Adam steps on one repeated batch
LM_TRAIN_LR = 3e-4                 # the reference's train_llm_smoke lr
SWA_GRAD_REL = 1e-4                # (a): o, dq, dk, dv of the autograd
                                   # function vs autograd through the plain
                                   # version, of max(1, |plain|): the two
                                   # forwards' and backwards' float32 sums
                                   # run in other orders over up to 512 keys
SPARSE_CE_LM_REL = 1e-4            # (b): loss, dh and dw of the largest,
                                   # at V = 151,936: dh sums 151,936 vocab
                                   # terms a row in another order than the
                                   # plain version (REL's 1e-5 is for the
                                   # AM's V = 3,183; 1.2e-5 measured here)
LM_GRAD_REL = 1e-4                 # (c): the loss, every gradient leaf of
                                   # its own largest plain gradient (floored
                                   # at 1e-6 of the model's largest), and
                                   # the loss after one Adam update
LM_STEP_DROP = 0.5                 # (d): the loss after the first Adam
                                   # update at most this share of the first
                                   # loss, and the last loss too; a sound
                                   # step gave 0.29 and 0.27 at 18 layers
                                   # (618.8 -> 181.9 ... 165.6), an update
                                   # that is missing, zero or of the wrong
                                   # sign gives >= 1
LM_SMOKE_ARCHS = ("deepseek-v3-671b", "recurrentgemma-2b", "whisper-medium")
LM_SMOKE_REL = 1e-3                # (e): the card's first loss vs the
                                   # host's on the same weights, of max(1,
                                   # |host|): a mean over 128 tokens in
                                   # which a near-tie may route an MoE token
                                   # to another expert
LM_TRAIN_TIMES = {}                # the kernels' times at this phase's
                                   # shapes, for their rows


def cut_depth(cfg, layers: int):
    """``cfg`` (one segment of one block) cut to ``layers`` layers at its
    published widths."""
    from repro_torch.configs import Segment
    (seg,) = cfg.segments
    return cfg.replace(segments=(Segment(seg.pattern, layers),))


@contextlib.contextmanager
def plain_attention():
    """``models/attention.py``'s ``swa_attention`` replaced by the plain
    version (``ref.py``, kv repeated G-fold), under autograd as it
    stands: the plain twin of the training path on the card."""
    import repro_torch.models.attention as attn
    from repro_torch.kernels.swa_attention import ref
    real = attn.swa_attention

    def plain(q, k, v, window, *, softcap=0.0, positions=None):
        g = q.shape[1] // k.shape[1]
        return ref.swa_attention_ref(q, k.repeat_interleave(g, 1),
                                     v.repeat_interleave(g, 1), window,
                                     softcap=softcap, positions=positions)
    attn.swa_attention = plain
    try:
        yield
    finally:
        attn.swa_attention = real


def swa_pairs(s: int, window: int, positions=None) -> int:
    """Visible (query, key) pairs a head: the band's by index, else those
    of ``positions``' mask (what this run's data needs)."""
    if positions is None:
        w = min(window, s)
        return w * (w + 1) // 2 + (s - w) * w
    p = positions.long()
    return int(((p[:, None] >= 0) & (p[None, :] <= p[:, None])).sum())


def swa_train_check(gen, inputs, window: int, what: str, positions=None,
                    time_it: bool = False) -> dict:
    """(a): ``swa_attention``'s autograd function (kernel forward,
    chunked backward) against autograd through the plain version on the
    same card tensors: o, dq, dk and dv within SWA_GRAD_REL of max(1,
    |plain|).  With ``time_it``, the forward and the backward timed
    beside the plain version's forward and backward and the bound."""
    import torch
    from repro_torch.kernels.swa_attention import ops, ref
    q, k, v = inputs
    b, hq, s, hd = q.shape
    g = hq // k.shape[1]
    do = torch.randn(q.shape, generator=gen, device="cuda")
    outs = []
    for plain in (False, True):
        a, bb, c = (t.clone().requires_grad_(True) for t in (q, k, v))
        if plain:
            o = ref.swa_attention_ref(a, bb.repeat_interleave(g, 1),
                                      c.repeat_interleave(g, 1), window,
                                      positions=positions)
        else:
            o = ops.swa_attention(a, bb, c, window, positions=positions)
            if type(o.grad_fn).__name__ != "_SwaAttentionBackward":
                fail(f"lm_train: swa_attention under autograd at {what} "
                     f"is not its autograd function: {o.grad_fn}")
        outs.append((o.detach(),) + torch.autograd.grad(o, (a, bb, c), do))
    torch.cuda.synchronize()
    errs = {n: rel_err(x, y) for n, x, y in zip(("o", "dq", "dk", "dv"),
                                                *outs)}
    if not max(errs.values()) <= SWA_GRAD_REL:
        fail(f"lm_train: swa_attention under autograd vs autograd through "
             f"the plain version at {what}: {errs} > {SWA_GRAD_REL}")
    rec = {"at": what, "err": errs,
           "max_abs_err": max(float((x - y).abs().max())
                              for x, y in zip(*outs))}
    if time_it:
        pairs = swa_pairs(s, window, positions) * b * hq
        o = outs[0][0]

        def fwd():
            return ops.swa_attention(q, k, v, window, positions=positions)

        def bwd():
            return ops.swa_attention_bwd(q, k, v, o, do, window,
                                         positions=positions)

        def plain_both():
            a = q.clone().requires_grad_(True)
            ro = ref.swa_attention_ref(a, k.repeat_interleave(g, 1),
                                       v.repeat_interleave(g, 1), window,
                                       positions=positions)
            return torch.autograd.grad(ro, a, do)
        rec.update(ms=time_ms(fwd, runs=10),
                   device_ms=device_ms(fwd, "swa_", runs=5),
                   bwd_ms=time_ms(bwd, runs=5, warmup=1),
                   plain_fwd_bwd_ms=time_ms(plain_both, runs=3, warmup=1),
                   bound_ms=4 * hd * pairs / TF32X3_OPS_PER_S * 1e3,
                   bwd_bound_ms=10 * hd * pairs / TF32X3_OPS_PER_S * 1e3,
                   bound_by="operations")
        if positions is None and window >= s:
            sdpa = sdpa_repeated(q, k, v, window, causal=True)
            rec["library_ms"] = None if sdpa is None else \
                time_ms(sdpa, runs=10)
    log(f"lm_train: (a) swa_attention under autograd at {what}: o/dq/dk/dv "
        f"within {SWA_GRAD_REL} of autograd through the plain version ("
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + ")"
        + (f"; forward {rec['ms']:.4f} ms (device {rec['device_ms']:.4f}, "
           f"bound {rec['bound_ms']:.4f}), backward (chunked PyTorch) "
           f"{rec['bwd_ms']:.4f} ms (bound {rec['bwd_bound_ms']:.4f}), plain "
           f"forward + backward {rec['plain_fwd_bwd_ms']:.4f} ms"
           + (f", SDPA is_causal forward {rec['library_ms']:.4f} ms"
              if rec.get("library_ms") else "") if time_it else ""))
    return rec


def lm_train_sparse_ce(gen) -> dict:
    """(b): ``sparse_ce`` at the LM's distill shape (T = 1,024 tokens,
    D = 2,048, V = 151,936, K = 20): the autograd function's loss, dh and
    dw against autograd through the plain version, and timed."""
    import torch
    from repro_torch.kernels.sparse_ce import kernel, ops, ref
    t, d, v = 1024, 2048, 151_936
    h = torch.randn((t, d), generator=gen, device="cuda")
    w = torch.randn((d, v), generator=gen, device="cuda") / math.sqrt(d)
    idx = torch.randint(0, v, (t, K), generator=gen, device="cuda",
                        dtype=torch.int32)
    vals = torch.randn((t, K), generator=gen, device="cuda")
    grads = []
    for fn in (lambda a, b: ops.topk_distill_ce(a, b, vals, idx,
                                                use_kernel=True),
               lambda a, b: ref.topk_distill_ce_ref(a, b, vals, idx)):
        a = h.clone().requires_grad_(True)
        b = w.clone().requires_grad_(True)
        loss = fn(a, b)
        grads.append((loss.detach(), *torch.autograd.grad(loss, (a, b))))
        del a, b, loss
    (lk, dhk, dwk), (lr, dhr, dwr) = grads
    gerr = {"loss": float((lk - lr).abs() / lr.abs()),
            "dh": float((dhk - dhr).abs().max() / dhr.abs().max()),
            "dw": float((dwk - dwr).abs().max() / dwr.abs().max())}
    if not max(gerr.values()) <= SPARSE_CE_LM_REL:
        fail(f"lm_train: sparse_ce autograd vs autograd through the plain "
             f"version at T={t} D={d} V={v}: {gerr} > {SPARSE_CE_LM_REL}")
    del grads, dhk, dwk, dhr, dwr
    lse, z = kernel.sparse_ce_tiles(h, w, idx)
    g_lse, g_z = torch.ones_like(lse), torch.ones_like(z)
    b_ms, by, _ = sparse_ce_bound(t, d, v, K)

    def call():
        return kernel.sparse_ce_tiles(h, w, idx)
    rec = {"at": f"T={t} D={d} V={v} K={K}", "err": gerr,
           "ms": time_ms(call, runs=10),
           "device_ms": device_ms(call, "sparse_ce", runs=5),
           "bwd_ms": time_ms(lambda: ops.lse_gather_bwd(
               h, w, idx, lse, g_lse, g_z, softcap=0.0), runs=3, warmup=1),
           "plain_ms": time_ms(lambda: ref.sparse_ce_lse_gather_ref(
               h, w, idx), runs=3, warmup=1),
           "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    log(f"lm_train: (b) sparse_ce at {rec['at']} (149 vocab tiles of "
        f"partials a row): loss/dh/dw within {SPARSE_CE_LM_REL} of the "
        f"largest, against autograd through the "
        f"plain version (" + ", ".join(f"{n} {e:.2e}" for n, e in
                                       gerr.items())
        + f"); forward {rec['ms']:.4f} ms (device {rec['device_ms']:.4f}, "
        f"bound {b_ms:.4f}, {by}), chunked backward {rec['bwd_ms']:.4f} ms, "
        f"plain forward {rec['plain_ms']:.4f} ms")
    return rec


class StepClock:
    """A metrics sink that keeps each update's metrics and the host clock
    when they arrive (the Trainer reads them as floats: after a sync)."""

    def __init__(self):
        self.records, self.times = [], []

    def emit(self, step, tag, metrics):
        self.times.append(time.perf_counter())
        self.records.append(dict(metrics))


def init_logit_stats(model, cfg, batch) -> str:
    """What makes up a tied-embedding LM's first CE at init, over the
    batch's B*S positions: the mean log-sum-exp, the mean logit of the
    label and of the input token itself, and the share of positions whose
    largest logit is the input token's.  With the reference's N(0, 1)
    embedding tied to the unembedding, the input token's own logit is
    about |e_t|^2 / rms(residual), hundreds at D=2,048, so the first loss
    is that logit less the label's (~N(0, D / rms^2)), not ln V."""
    import torch
    from repro_torch.launch import steps
    with torch.no_grad():
        h, _ = steps.model_forward(model, cfg, None, batch)
        h = h.reshape(-1, cfg.d_model)
        w = model.unembed_matrix()
        tok = batch["tokens"].reshape(-1).long()
        lab = batch["labels"].reshape(-1).long()
        lse, top = [], []
        for i in range(0, h.shape[0], 256):
            z = h[i:i + 256] @ w
            lse.append(torch.logsumexp(z, -1))
            top.append(z.argmax(-1))
        lse, top = torch.cat(lse), torch.cat(top)
        own = (h * w.T[tok]).sum(-1)
        label = (h * w.T[lab]).sum(-1)
        return (f"CE {float((lse - label).mean()):.4f} = mean log-sum-exp "
                f"{float(lse.mean()):.4f} - mean label logit "
                f"{float(label.mean()):.4f}; the input token's own logit "
                f"{float(own.mean()):.4f} (the largest at "
                f"{float((top == tok).float().mean()):.4f} of the "
                f"positions); ln V {math.log(cfg.vocab_size):.4f}")


def phase_lm_train() -> dict:
    """Training the token LM on the card (``launch/steps.py``'s loss for
    every family, ``swa_attention`` under autograd): (a) the attention's
    autograd function against autograd through its plain version at
    qwen2.5-3b's layer shape (causal, window 128, explicit positions)
    and MLA's; (b) ``sparse_ce`` at the LM's distill shape; (c) one CE
    step of qwen2.5-3b at full widths, 2 layers, against the same step
    through the plain attention, and one distill step; (d) qwen2.5-3b
    at full widths and LM_TRAIN_LAYERS layers through
    ``Trainer(Local(optimizer="adam"))``; (e) ``launch.train --arch A
    --smoke`` for deepseek-v3-671b, recurrentgemma-2b and whisper-medium,
    the first loss against the host's on the same weights.  The counts
    are (c)-(e)'s kernel runs."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.optim import adam_init, adam_update, clip_by_global_norm
    from repro_torch.train import Local, TrainBatch, Trainer
    from repro_torch.train.strategies import loss_and_grads
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    t0 = time.perf_counter()

    # (a) the attention under autograd
    b, s = LM_TRAIN_SHAPE
    qwen = swa_inputs(gen, b, 16, 2, s, 128)
    pos = torch.arange(s, device="cuda", dtype=torch.int32) + 7
    pos[[3, 200, 201]] = -1
    times = {"causal": swa_train_check(gen, qwen, s, f"B={b} Hq=16 Hkv=2 "
                                       f"hd=128 S={s} causal", time_it=True),
             "window": swa_train_check(gen, qwen, 128, f"B={b} Hq=16 Hkv=2 "
                                       f"hd=128 S={s} window 128"),
             "positions": swa_train_check(
                 gen, qwen, s, f"B={b} Hq=16 Hkv=2 hd=128 S={s} positions "
                 f"+7, 3 negative", positions=pos, time_it=True)}
    q, k, v = swa_inputs(gen, 1, 128, 128, 256, 192)
    v = torch.nn.functional.pad(v[..., :128], (0, 64))
    times["mla"] = swa_train_check(gen, (q, k, v), 256, "B=1 H=128 hd=192 "
                                   "(v 128 zero-padded) S=256 causal")
    del qwen, q, k, v
    LM_TRAIN_TIMES["swa_attention"] = times
    LM_TRAIN_TIMES["sparse_ce"] = lm_train_sparse_ce(gen)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()

    # (c) one step at full widths, 2 layers: the kernels against plain
    launch_counts(reset=True)
    cfg = cut_depth(get_arch(LM_ARCH), 2)
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 12))
    params = dict(model.state_dict())
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    loss_fn = steps.make_loss_fn(model, cfg, "ce")
    before = launch_counts()["swa_attention"]
    lk, _, gk = loss_and_grads(loss_fn, params, batch)
    torch.cuda.synchronize()
    launched = launch_counts()["swa_attention"] - before
    if launched != 2 * cfg.n_layers:
        fail(f"lm_train: (c) {launched} swa_attention launches in a CE step "
             f"of {cfg.n_layers} layers, want {2 * cfg.n_layers}")
    with plain_attention():
        lp, _, gp = loss_and_grads(loss_fn, params, batch)
    torch.cuda.synchronize()
    if launch_counts()["swa_attention"] - before != launched:
        fail("lm_train: (c) the plain step launched the kernel")
    top = max(float(g.abs().max()) for g in gp.values())
    lerr = rel_err(lk, lp)
    gerr = max(float((gk[n] - gp[n]).abs().max()) for n in gp) / max(1.0,
                                                                      top)
    leaf = {n: float((gk[n] - gp[n]).abs().max())
            / max(float(gp[n].abs().max()), 1e-6 * top) for n in gp}
    worst = max(leaf, key=leaf.get)
    attn = [n for n in leaf if ".mixer." in n]
    worst_attn = max(attn, key=leaf.get)
    # one Adam update from each route's gradients, then the loss again
    after = []
    for g in (gk, gp):
        g, _ = clip_by_global_norm(g, 1.0)
        p1, _ = adam_update(params, g, adam_init(params), lr=LM_TRAIN_LR)
        with torch.no_grad():
            after.append(loss_fn(p1, batch)[0])
        del p1, g
    serr = rel_err(after[0], after[1])
    if not (lerr <= LM_GRAD_REL and max(leaf.values()) <= LM_GRAD_REL
            and serr <= LM_GRAD_REL and float(after[0]) < float(lk)):
        fail(f"lm_train: (c) the kernel step vs the plain one: loss "
             f"{lerr:.3e}, gradient leaf {worst} {leaf[worst]:.3e} of its "
             f"own largest, loss after one Adam update {float(after[0])} "
             f"vs {float(after[1])} ({serr:.3e}) from {float(lk)}")
    dk = steps.make_loss_fn(model, cfg, "distill_topk")
    dbatch = {"tokens": batch["tokens"],
              "topk_vals": torch.randn((b, s, K), generator=gen,
                                       device="cuda"),
              "topk_idx": torch.randint(0, cfg.vocab_size, (b, s, K),
                                        generator=gen, device="cuda",
                                        dtype=torch.int32)}
    before_ce = launch_counts()["sparse_ce"]
    ld, _, gd = loss_and_grads(dk, params, dbatch)
    torch.cuda.synchronize()
    if launch_counts()["sparse_ce"] - before_ce != 2 or \
            not bool(torch.isfinite(ld)) or \
            not all(bool(torch.isfinite(g).all()) for g in gd.values()):
        fail(f"lm_train: (c) the distill step: loss {float(ld)}, sparse_ce "
             f"launches {launch_counts()['sparse_ce'] - before_ce} (want 2)")
    n2 = sum(p.numel() for p in params.values())
    log(f"lm_train: (c) {LM_ARCH} at full widths, 2 of 36 layers ({n2 / 1e9:.3f}"
        f" B f32), B={b} S={s}: one CE step through the kernels (loss "
        f"{float(lk):.4f}, {launched} swa_attention launches) against the "
        f"same step through the plain attention: loss within {lerr:.3e}; "
        f"every gradient leaf within {leaf[worst]:.3e} of its own largest "
        f"plain gradient (worst {worst}; the attention's worst {worst_attn} "
        f"{leaf[worst_attn]:.3e}, its largest "
        f"{float(gp[worst_attn].abs().max()):.3e}), {gerr:.3e} of the "
        f"model's largest ({top:.3e}), bar "
        f"{LM_GRAD_REL}; after one Adam update (lr {LM_TRAIN_LR}) the loss "
        f"{float(after[0]):.4f} against the plain gradients' "
        f"{float(after[1]):.4f} ({serr:.3e}), "
        f"{float(after[0]) / float(lk):.3f} of the first; one "
        f"distill_topk step (K={K}) through sparse_ce: loss {float(ld):.4f},"
        f" gradients finite")
    del model, params, gk, gp, gd, loss_fn, dk, after
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()

    # (d) Adam through the Trainer at full widths
    cfg = cut_depth(get_arch(LM_ARCH), LM_TRAIN_LAYERS)
    reck = dryrun.reckon(cfg)
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 13))
    init = init_logit_stats(model, cfg, batch)
    params = dict(model.state_dict())
    probe = "seg0.0.p0.mixer.wq"
    first = params[probe][:4, :4].clone()
    clock = StepClock()
    trainer = Trainer(Local(optimizer="adam"),
                      {"ce": steps.make_loss_fn(model, cfg, "ce")},
                      metrics=clock)
    state = trainer.init_state(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()["swa_attention"]
    t_fit = time.perf_counter()
    state = trainer.fit(state, (TrainBatch(batch, LM_TRAIN_LR, "ce")
                                for _ in range(LM_TRAIN_STEPS)),
                        resume=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_fit
    peak = torch.cuda.max_memory_allocated()
    launched = launch_counts()["swa_attention"] - before
    losses = [r["loss"] for r in clock.records]
    step_s = np.diff([t_fit] + clock.times)
    moved = float((state.params[probe][:4, :4] - first).abs().max())
    n = reck["n_params"]
    if launched != 2 * cfg.n_layers * LM_TRAIN_STEPS:
        fail(f"lm_train: (d) {launched} swa_attention launches over "
             f"{LM_TRAIN_STEPS} steps of {cfg.n_layers} layers, want "
             f"{2 * cfg.n_layers * LM_TRAIN_STEPS}: a forward ran attention "
             f"outside the kernel")
    if len(losses) != LM_TRAIN_STEPS or not np.isfinite(losses).all() or \
            not max(losses[1], losses[-1]) <= LM_STEP_DROP * losses[0] or \
            not moved > 0:
        fail(f"lm_train: (d) losses {losses} (the second and the last at "
             f"most {LM_STEP_DROP} of the first), parameters moved {moved}")
    log(f"lm_train: (d) {LM_ARCH} at full widths, {cfg.n_layers} of 36 layers "
        f"({n / 1e9:.3f} B f32), Trainer(Local(adam)), lr {LM_TRAIN_LR}, "
        f"B={b} S={s}, {LM_TRAIN_STEPS} steps on one batch: losses "
        + " ".join(f"{x:.4f}" for x in losses) + f" (the second "
        f"{losses[1] / losses[0]:.3f}, the last {losses[-1] / losses[0]:.3f}"
        f" of the first, bar {LM_STEP_DROP}); the first loss at init: {init}"
        f"; {probe} "
        f"moved {moved:.3e}; {dt:.3f} s = {LM_TRAIN_STEPS * b * s / dt:.1f} "
        f"trained tokens/s; step ms " + " ".join(f"{x * 1e3:.1f}"
                                                 for x in step_s)
        + f" (median after the first {np.median(step_s[1:]) * 1e3:.1f}); "
        f"peak {peak / 1e9:.2f} GB against the dry run's Adam update "
        f"{reck['update_peak_bytes'] / 1e9:.2f} GB + the module's own "
        f"weights {4 * n / 1e9:.2f} GB; {launched} swa_attention launches "
        f"(2 a layer a forward)")
    LM_TRAIN_TIMES["train"] = {
        "layers": cfg.n_layers, "n_params": n, "losses": losses,
        "init": init,
        "step_ms": [x * 1e3 for x in step_s],
        "tokens_per_s": LM_TRAIN_STEPS * b * s / dt, "peak_bytes": peak,
        "dryrun_update_peak_bytes": reck["update_peak_bytes"]}
    del model, state, trainer, batch, first
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()

    # (e) launch.train --arch A --smoke on the card; the first loss from
    # weights made on the host (CUDA generators draw other numbers)
    for arch in LM_SMOKE_ARCHS:
        out = launch_train.main(["--arch", arch, "--smoke"])
        if not np.isfinite(out["losses"]).all() or len(out["losses"]) != 4:
            fail(f"lm_train: (e) --arch {arch} --smoke losses {out}")
        cfg = reduced(get_arch(arch))
        host = build_model(cfg, device="cpu", generator=torch.Generator()
                           .manual_seed(SEED)).state_dict()
        want = launch_train.train_llm_smoke(arch, steps=1, device="cpu",
                                            params=host)[0]
        got = launch_train.train_llm_smoke(arch, steps=1, device="cuda",
                                           params=host)[0]
        err = abs(got - want) / max(1.0, abs(want))
        if not err <= LM_SMOKE_REL:
            fail(f"lm_train: (e) {arch}: the card's first loss {got} vs the "
                 f"host's {want} ({err:.3e} > {LM_SMOKE_REL})")
        log(f"lm_train: (e) launch.train --arch {arch} --smoke on the card: "
            f"losses " + " ".join(f"{x:.4f}" for x in out["losses"])
            + f"; on host-made weights the first loss {got:.6f} against the "
            f"host's {want:.6f} ({err:.3e}, bar {LM_SMOKE_REL})")
    counts = launch_counts()
    t4 = time.perf_counter()
    log(f"lm_train: seconds by part: (a)+(b) {t1 - t0:.1f}, (c) "
        f"{t2 - t1:.1f}, (d) {t3 - t2:.1f}, (e) {t4 - t3:.1f}")
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
    seconds = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        seconds[name] = round(time.perf_counter() - t, 1)
        log(f"{name}: phase took {seconds[name]} s")
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    rows = [timed(f.__name__[6:], f) for f in (
        phase_kernel, phase_sparse_ce, phase_gtc_compress,
        phase_decode_attention, phase_topk_sample, phase_swa_attention)]
    by_path = {name: timed(name, f) for name, f in (
        ("student", phase_student), ("teacher", phase_teacher),
        ("targets", phase_targets), ("train", phase_train))}
    timed("prefetch", phase_prefetch)
    by_path["bmuf"] = timed("bmuf", phase_bmuf)
    timed("resume", phase_resume)
    timed("baseline", phase_baseline)
    by_path["teacher_train"] = timed("teacher_train", phase_teacher_train)
    by_path["smbr"] = timed("smbr", phase_smbr)
    by_path["pipeline"] = timed("pipeline", phase_pipeline)
    by_path["gen_procs"] = timed("gen_procs", phase_gen_procs)
    by_path["elastic"] = timed("elastic", phase_elastic)
    by_path["waves"] = timed("waves", phase_waves)
    by_path["cluster"] = timed("cluster", phase_cluster)
    RUNS.clear()
    by_path["whisper"] = timed("whisper", phase_whisper)
    by_path.update(lm=timed("lm", phase_lm),
                   paged=timed("paged", phase_paged),
                   moe=timed("moe", phase_moe),
                   mla=timed("mla", phase_mla),
                   recurrent=timed("recurrent", phase_recurrent),
                   prefill=timed("prefill", phase_prefill),
                   lm_train=timed("lm_train", phase_lm_train))
    for row in rows:
        if row["name"] == "decode_attention":
            row["paged_write_false"] = PAGED_TIMES
        if row["name"] in MLA_TIMES:
            row["at_mla"] = MLA_TIMES[row["name"]]
        if row["name"] in RECURRENT_TIMES:
            row["at_recurrent"] = RECURRENT_TIMES[row["name"]]
        if row["name"] in LM_TRAIN_TIMES:
            row["at_lm_train"] = LM_TRAIN_TIMES[row["name"]]
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    # the card again near the end: a caller that keeps only the tail of
    # the output still reads which card and power limit the numbers had
    log(f"seconds by phase: {seconds}")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s on {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
