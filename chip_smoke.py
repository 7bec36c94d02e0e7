#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own lines; any failure exits non-zero:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build  — every kernel under ``paddle_tpu_torch/ops/csrc`` compiled with
   nvcc for sm_90a (one nvcc per source, all at once);
3. kernel — the flash-attention forward kernel against its plain PyTorch
   version on the card, on both routes (bf16 at head dims 64 and 128 on
   the tensor cores, f32 and bf16 head dim 32 on the CUDA cores), at the
   prefill shapes of the served path (the strided head views of the fused
   qkv projection, buckets 1 and 8), at the training path's shape (two
   runs must give the same bits) and at ragged, masked, fully masked,
   sq > sk, long and head-dim 32/128 shapes, with each case's tolerance,
   timings (kernel, plain version, ``scaled_dot_product_attention`` where
   its mask convention matches) and the card's least time for the same
   work;
4. parity — full-width GPT-base (random weights from ``--seed``) in f32:
   ``make_generator`` on the card (kernel) against the CPU (plain
   versions) from the same weights; 12 kernel launches per generate call;
3b. backward — the two flash-attention backward kernels (dQ; dK/dV)
   against their plain PyTorch version on the card, on both routes (bf16
   on the tensor cores, f32 and bf16 head dim 32 on the CUDA cores), at
   the training path's shape (strided head views of the fused [8, 1024,
   3, 768] qkv projection, with a strided dO; two runs must give the same
   bits) and at long, ragged, biased, segmented, fully masked, sq > sk and
   head-dim 32/128 shapes, with each grad's error against its tolerance,
   timings per pass (kernel, plain version, ``scaled_dot_product_attention``
   backward where its mask convention matches) and the card's least time;
5. served — the bf16 decode-serving path a user calls: ``export_decoder``
   → ``decode_server`` (``load_inference_model`` + continuous batching)
   answers single-prompt requests; each reply is checked against its row
   of ``Predictor.run`` on the same merged bucket batch. Kernel launch
   counts are zeroed just before this path and read just after it; a
   profiled bf16 generate call must show the forward's tensor-core
   kernel and none of its CUDA-core one;
6. training parity — full-width GPT-base in f32: ``build(make_model)`` +
   ``Trainer`` with AdamW on the card (kernels) against the CPU (plain
   versions) from the same weights, 3 steps: the losses of every step and
   the step-1 grads of every param must agree;
7. training — the bf16 GPT-base training path a user calls, at bench.py
   ``bench_gpt``'s config and feeds: ``build(make_model)`` → ``Trainer(AdamW)``
   → ``startup`` → ``step``, 3 warm-up and 10 timed steps, with the launch
   counts zeroed just before the path and read just after it (12 launches
   of each kernel per step); tokens/s, ms per step, peak memory, the
   losses; the first two losses against the same steps run through the
   plain versions on the card; a profiler breakdown of one step, which
   must show the three tensor-core kernels and none of the CUDA-core
   ones;
8. MNIST MLP — the ``build`` programming model a user drives:
   ``build(mnist.mlp)`` → ``Trainer`` → ``step`` and ``fit``. (i) f32
   parity, card against CPU, from one seed's params on both: 20 SGD(0.01)
   steps on bench.py ``bench_mnist_mlp``'s feeds; (ii) ``fit`` with the
   prefetch (``DeviceFeeder``: pinned batches copied on a side stream)
   against ``fit`` without it over one epoch of synthetic MNIST: the same
   losses bit for bit, then test accuracy above 0.9; (iii) the timed path
   at ``bench_mnist_mlp``'s config (batch 128, SGD(0.01), 5 warm-up and 50
   timed steps fed through the prefetch): samples/s, ms per step, kernels
   launched per step and the device's busy share of profiled steps, peak
   memory; beside it the same steps fed by a lookahead on the step's own
   thread, by a plain put and from the card, with each thread's CPU time
   and context switches, and a profile of the prefetched steps by thread.
   The path runs no hand kernel: the launch counts, zeroed just before
   it, must read 0 after it;
9. persistence and inference — (a) the bf16 GPT-base trainer of phase 7
   (``build(make_model)`` → ``Trainer(AdamW)``): two uninterrupted runs of 5
   steps, the second ``io.save_trainer``'d after step 3 (seconds, bytes,
   ``validate_checkpoint``'s verdict), and a fresh trainer ``load_trainer``'d
   from it takes steps 4-5, whose losses and params must equal the
   uninterrupted run's (bit for bit when the two uninterrupted runs are)
   and which launch all three kernels; (b) MNIST ``fit`` with
   ``CheckpointConfig(step_interval=10)`` stopped by a SIGTERM the process
   sends itself mid-epoch, then ``fit(resume=True)``: the uninterrupted
   run's losses and params bit for bit, no fill thread left; (c) the MNIST
   trainer ``save_inference_model``'d at buckets [1, 8, 128] and
   ``load_inference_model``'d on the card: ``trainer.eval``'s outputs; a
   ``PredictorServer`` answers 64 requests (p50/p99 latency); a copy with
   one byte flipped raises ``CheckpointCorrupt``. Launch counts are
   zeroed just before the phase and read just after it;
10. ResNet-50 and mixed precision — (a) f32 ResNet-50 (depth 50, 1000
   classes) at 64x64, batch 16, NHWC: 3 Momentum(1e-4, 0.9) steps card
   against CPU from the same params (losses, step-1 grads of every param,
   moving stats, the params' moves), with a second card run's spread, and
   each card step's Momentum update held against its formula on the
   card's own grads to f32 rounding; then the path a user drives,
   with the launch counts zeroed before it and read after it (the conv
   nets run no hand kernel): (b) bf16 NHWC ResNet-50 at bench.py
   ``bench_resnet50``'s config (224x224, batch 64, Momentum(0.1, 0.9),
   ``layout_mode`` + ``amp_guard``), 3 warm-up and 10 timed steps:
   images/s, ms per step, peak memory, the losses; a profiled step's
   device time, busy share, device operations and top ops, with no
   NCHW<->NHWC transpose kernel; the step with and without a dynamic
   loss scaler in turns, with each one's device time and operations; (c)
   NCHW against NHWC
   from the same params, the first losses and ms per step; (d)
   ``mnist.conv_net`` at batch 64: a NaN batch skipped under loss scaling
   (scale halved, params and moving stats bit-equal) and discarded by the
   guard (one incident), ``fit`` to test accuracy above 0.9; (e) the (b)
   trainer exported at buckets [1, 16] and served on the card against
   ``trainer.eval``;
11. Transformer-base and BERT-base — (a) f32 parity card against CPU at
   dropout 0, full width from one seed's params: Transformer-base at b=4,
   s=64 (3 Adam steps) and BERT-base at b=4, s=128 (2 AdamW steps), the
   losses, the step-1 grads of every param, and an eval that launches 12
   flash forwards; then the paths a user drives, each with the launch
   counts zeroed just before it and read just after it: (b) bf16
   Transformer-base at bench.py ``bench_transformer``'s config (b=32,
   s=256, dropout 0.1: no flash launch in training), 3 warm-up and 10
   timed steps (tokens/s, ms per step, TFLOP/s by ``core/flops.py``, peak
   memory, a profiled step's device time, busy share, operations and top
   ops), then ``trainer.eval`` (12 flash forwards) against the same eval
   through the plain versions on the card; (c) its params served by
   ``make_decoder`` (greedy, and beam 4 at length penalty 0.6) through
   ``save_inference_model`` and ``load_inference_model``: 8 source rows
   of 256, each call the encoder (6 flash forwards) then 64 replays of
   one captured CUDA graph of a decoder step; the ids (and scores) bit
   for bit against the eager loop on the card, ms a call eager against
   captured, a profiled captured call's device time and busy share, the
   eager loop's log-probabilities against the CPU's in f32, a second
   params set through the same program, and a captured call under
   ``set_sync_debug_mode("error")``; (d) bf16 BERT-base at ``bench_bert``'s config,
   read as (b); (e) ``bench_transformer_long`` (b=4, s=4096, dropout 0): 12
   launches of each kernel a step on the tensor-core route, the first
   loss against the plain versions; (f) dropout on the card: the keep
   rate, the rng, and remat replaying the masks;
12. captured steps — ``Trainer.run_steps`` (the step captured once as a
   CUDA graph and replayed K times a dispatch) and
   ``fit(steps_per_dispatch=K)`` on each training path, every result held
   bit for bit against the same steps run eagerly: (a) MNIST MLP at
   bench.py ``bench_dispatch_overhead``'s config (K=16): ``run_steps``
   from a saved state (also on a trainer that captured before the load),
   ``fit`` with and without the prefetch against ``fit`` K=1; (b) bf16
   GPT-base at ``bench_gpt``'s config, K=4: a profiled dispatch runs the
   three tensor-core kernels 12 times a step and no CUDA-core one (the
   Python launch counts, zeroed around the path, count the eager steps
   and the capture's warm-up and capture: a replay runs no Python); (c)
   bf16 ResNet-50 with a dynamic loss scaler, K=4, one step fed infinite
   pixels: skipped on the device, the scale halved, batch-norm state
   carried; (d) bf16 Transformer-base at dropout 0.1, K=4, and under
   ``DistStrategy(remat=True)`` on 2+2 layers; (e) the guard's NaN batch inside a
   dispatch charged to its own step; (f) bf16 BERT-base (K=4) and the
   long-context Transformer (K=2, the three kernels under a key bias and
   causal in the graph), each trainer alone on the card. Each path's ms per step eager
   against captured (in turns), throughput, peak memory, and the
   device's busy share, device time and operations a step of profiled
   eager steps and of a profiled dispatch;
13. captured decode — the GPT generator's decode steps as one captured
   CUDA graph of a step, replayed (``GPTGenerator.__call__``), against
   the same decode as a plain loop (``_generate_eager``), bf16 GPT-base at
   phase 5's config, bucket 8, with the launch counts zeroed just before
   the phase and read just after it: (a) greedy: ids bit-equal, ms per
   decode step and generated tokens/s a call of each (in turns), a
   profiled call's busy share, device ms and operations a decode step
   (the captured call's; the eager call's in (a) only), peak memory,
   the cache's bytes, 12 flash forward launches a call (the prefill's,
   on the tensor-core route) and none in the replays;
   (b) beam 4, read as (a) with the scores bit-equal too, and f32 beam
   4 card against the CPU at phase 4's width (the best beam's score
   within BEAM_SCORE_TOL, the share of equal ids reported); (c) the int8
   KV cache, read as (a), its cache's bytes and ms per decode step
   against the compute cache's, the share of ids equal to (a)'s
   reported, and f32 beam 4 with the int8 cache card against the CPU
   (the best beam's score within INT8_SCORE_TOL, at least INT8_IDS_SHARE
   of the beams' ids equal); (d) an int8 ``export_decoder`` → ``decode_server``: each
   reply equals its row of ``Predictor.run`` on the merged batch, as
   phase 5 checks;
14. the rest of slice 7 — (a) the build GPT (``build(gpt.make_model(cfg))``,
   which phases 6, 7, 9, 11 (f) and 12 (b) train) against the module GPT
   it replaced: phase 7's device time and operations a step and phase
   12 (b)'s captured ones against the module's last readings on the
   card (quoted), within 3% on a 700 W card; (b) ``DistStrategy(remat=True,
   remat_policy=p)`` at phase 7's config for None, "nothing",
   "dots_no_batch", "dots" and "everything", and remat off, captured
   (K=2): peak memory in the order nothing < dots_no_batch <= dots <
   everything ~ off and what each setting leaves allocated, ms a step,
   the flash forward's launches a step (12, or 24 recomputed), the steps'
   losses, one batch's grads and the params after the steps against
   remat off; the remat-off trainer's scope served by
   ``GPTGenerator.load_params``; (c)
   ``TransformerConfig(stacked=True)`` at bench.py's ``BENCH_STACKED=1``
   config, eager against captured (K=4) bit for bit beside phase 11 (b)'s
   unrolled model, and stacked transformer_long (K=2) with every flash
   call of its eager steps (the stacked decoder's cross attention under
   the source's key bias among them) held against the plain versions;
   (d) ``DistStrategy(accum_steps=a)`` at phase 7's config for a = 1, 2,
   4, captured (K=2): peak memory, ms a step, the steps' losses, one
   batch's grads and the params after the steps against a = 1, a planted
   fault (a microbatch's grads dropped) outside those limits, the flash
   calls at the microbatches' shapes held against the plain versions;
   and a ResNet-50 step at accum_steps 2, its batch-norm state
   threaded through the microbatches. The launch counts are zeroed just
   before (b)-(d) and read just after;
15. DeepFM, the recommender and the rest of the optimizers — (a) f32
   ``build(deepfm.make_model())`` at bench.py ``bench_deepfm``'s config
   (b=2048, 26 fields x 1000 rows, embedding 16, 13 dense, 400-400-400,
   Adagrad(0.01)), card against CPU from the same params, 3 steps: the
   losses, the step-1 grads and the params' moves; then the paths a user
   drives, with the launch counts zeroed just before them and read just
   after (none runs a hand kernel): (b) ``bench_deepfm`` 3 warm-up and 20
   timed steps eager, then the same steps through ``run_steps`` (K=4),
   bit-equal (losses, params, Adagrad moments): samples/s, ms a step,
   TFLOP/s by ``core/flops.py``, a profiled step's device time, busy share,
   operations and kernel families, peak memory; (c) ``bench_deepfm_10m``
   (26 x 400,000 = 10.4 M rows), read as (b), with the step's bytes bound
   and the share of it reached; (d) ``fit(steps_per_dispatch=4)`` over
   synthetic ``datasets.ctr`` (batch 256), the loss falling, and (b)'s
   trainer saved and loaded, the resumed steps bit-equal; (e) the book
   recommender at its default widths on synthetic MovieLens, eager against
   captured bit for bit, the loss falling; (f) LarsMomentum, Adagrad,
   Adamax, DecayedAdagrad, Adadelta, RMSProp, Ftrl (both ``lr_power``
   branches), Lamb and Adam under ``DistStrategy(opt_state_dtype=
   "bfloat16")`` on phase 8's MNIST MLP, card against CPU; Lamb and
   LarsMomentum captured against eager; ``sparse.apply_adagrad`` and
   ``apply_adam_lazy`` on (c)'s factor table with one batch's 53,248 ids,
   card against CPU, two card runs bit-equal;
16. the image zoo — (a) VGG-16, AlexNet, GoogLeNet and SE-ResNeXt-50 in
   f32 NHWC at small sizes with dropout off, card against CPU (eval
   logits, train-mode loss, logits and grads); then the path a user
   drives, with the launch counts zeroed just before it and read just
   after (none runs a hand kernel): (b) each net at bench.py's config
   (``_bench_convnet``: 224x224, NHWC, bf16, Momentum(0.01, 0.9), 1000
   classes; batch 64, 256, 64 and 32), eager steps and the same steps
   through ``run_steps`` (K=4) bit for bit, ms a step eager against
   captured, images/s, TFLOP/s by ``core/flops.py``, peak memory, the busy
   share and top op families of profiled steps, and for SE-ResNeXt-50 the
   share of its grouped 3x3 convs.
17. the recurrent family (f32, TF32 off), with the launch counts zeroed
   just before the phase and read just after it (none runs a hand kernel):
   (a) card against CPU at small widths with ragged lengths:
   ``dynamic_lstm``, ``dynamic_gru`` and ``dynamic_lstmp`` (forward and
   reverse; outputs, last states, grads), one Adam step of lstm, seq2seq,
   srl and word2vec (loss, grads), seq2seq's beam-4 decode and the CRF's
   Viterbi ids equal, and the sequence reductions over 200,000 rows, two
   card runs bit-equal; (b) ``bench_lstm``, (c) ``bench_lstm_big`` and (d)
   ``bench_seq2seq`` at bench.py's configs: eager steps and ``run_steps``
   (K=4) bit for bit, ms a step eager against captured, samples/s or
   tokens/s, TFLOP/s by ``core/flops.py``, peak memory, a profiled eager
   step's device time, operations and op families; (e) bench_lstm's widths
   with lengths drawn from 16-128, captured bit-equal to eager, each row's
   last state its state at its end; (f) ``seq2seq.make_decoder(beam_size=4,
   max_len=30)`` served from (d)'s params on 8 source rows, ms a call, then
   ``beam_search_decode_lod``'s 2-level LoD.
18. the multi-GPU slice's first half on one card: (a) a world of one
   over NCCL (``parallel.initialize`` through a TCP store on 127.0.0.1),
   bf16 GPT-base at ``bench_gpt``'s config: 3 steps each of
   ``replicated()`` on ``make_mesh({"dp": 1})``, ``fsdp()`` on
   ``{"fsdp": 1}`` and ``DistStrategy(zero_sharding=True)`` against the
   unmeshed Trainer from the same params (losses, the params' largest
   difference or bit-equal), ``run_steps(K=4)`` under the mesh captured
   against 4 ``step()`` calls of the mesh bit for bit, and ms a step of
   the unmeshed eager step, the mesh's eager step and its captured step
   in turns; (b) ring attention's steps for 4 shards of bench_gpt's
   attention ([8, 12, 1024, 64] bf16, causal) driven in one process, a
   rotation of the shard list standing for the exchange, plain ring and
   zigzag, and Ulysses' head shards: out, lse and dq/dk/dv against flash
   attention on the whole sequence and against the plain versions, and
   each step's kernel ms against the whole-sequence kernels'; (c) the
   quantized codec (int8, int4, blocks of 256) card against CPU bit for
   bit at GPT-base's gradient count, with encode and decode ms. Launch
   counts are zeroed before (a)'s and (b)'s paths and read after them.
19. the multi-GPU slice's second half (a) on one card, its ranks driven
   in this process (``parallel.pipeline.LocalRanks``: every rank's tick in
   turn, a rotation of the rank list standing for the exchange, so the
   ms a step is not a pipeline's speed): (a) bench_gpt's GPT-base program
   under ``framework.pipeline_mode(LocalRanks(4), 8)``, GPipe (3 layers a
   stage) and interleaved V=3 (1 layer a chunk, its rows in
   ``interleave_perm`` order), one forward and backward each against the
   sequential stacked step from the same params, the flash launches per
   tick counted; ``bubble_fraction``; a world-of-one Trainer on
   ``{dp: 1, tp: 1, pp: 1}`` with ``pp_microbatches=8`` bit-equal to the
   unmeshed Trainer, eager and captured, and with ``transformer_tp_rules``
   within bf16 rounding of it; (b) the stacked Transformer-base
   at bench_transformer_long's widths and shape through a pp=2, 4-microbatch
   schedule with the decoder's extras delivered per microbatch, against
   the sequential stacked step; (c) the MoE LM at its ``base_config``
   widths (bf16, flash) at batch 8 × seq 1024: eager steps, ``run_steps``
   captured bit-equal to eager, f32 card against CPU at a small width, one
   MoE layer's 4 ep ranks emulated in this process against each shard's
   dense route, ms a step, tokens/s, peak memory and the dispatch and
   combine products' share of device time. Launch counts are zeroed
   around (a)+(b) (``pipeline``) and around (c) (``moe``).
20. sharded checkpoints and elastic training, on bench_gpt's bf16
   GPT-base (``TRAIN``, AdamW, batch 8 × seq 1024): (a) 3 steps, then
   ``io.save_trainer_sharded(async_save=True)`` and 2 steps at once while
   the write runs, ``io.wait_for_checkpoints()``, and a fresh trainer
   ``load_trainer_sharded`` from it replays the same 2 feeds: its params
   and optimizer state bit-equal to the first trainer's at step 5; once
   unmeshed and once on a world of one over NCCL (DCP coordinating over a
   gloo group of its own), with the bytes written, the ms until the save
   returns (the copy off the card), the s until the write ends, the load
   s and the ms a step while the write runs against the same steps
   without one; (b) a 2-rank gloo world on the CPU, spawned by this script
   from its own code, trains GPT-base at full width one step with
   ``zero_sharding`` over dp=2 and ``save_trainer``s it; on the card a
   plain ``load_trainer`` raises ``ReshardError`` naming ``{'dp': 2}``,
   ``resilience.restore_latest(elastic=True)`` restores it onto the
   one-device trainer and onto the world-of-one trainer (params and
   optimizer state bit-equal to ``load_persistables`` of the directory,
   the report's bytes and seconds), then ``fit(resume=True,
   elastic=True)`` trains 3 steps; (c) ``fit(resize=path)`` whose event
   handler requests ``{'dp': 2}`` at step 2 returns there with a
   ``resized`` event and a boundary checkpoint, and ``fit(resume=True,
   elastic=True)`` goes on with losses bit-equal to bare steps from that
   checkpoint. Launch counts are zeroed around (a) (``sharded_checkpoint``)
   and around (b) and (c) (``elastic``), and the flash kernels' calls of
   (a)'s and (b)'s steps are held against their plain versions.

The last lines are a JSON ``kernels`` record, the nvidia-smi line and
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

# GPT-base as bench.py's decode config defines it
GPT_BASE = dict(vocab_size=32000, d_model=768, d_inner=3072, num_heads=12,
                num_layers=12, use_flash=True)
PROMPT, NEW_TOKENS, BUCKETS = 128, 128, (1, 8)
PARITY_NEW_TOKENS = 16
N_REQUESTS = 16

# GPT-base training as bench.py's bench_gpt defines it (dtype and compute
# bf16), and the cut-down f32 parity run of the same widths
TRAIN = dict(GPT_BASE, vocab_size=32000, max_len=1024, fused_ce=True,
             dtype="bfloat16")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_FEEDS = 8, 1024, 4
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
TRAIN_LR, TRAIN_WD = 1e-4, 0.01
PARITY_TRAIN_BATCH, PARITY_TRAIN_SEQ, PARITY_TRAIN_STEPS = 2, 256, 3

# H100 SXM published peaks (dense): HBM bytes/s and FLOP/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel against its plain version: outputs o compared at TOL[dtype]
# (f32: the same products summed in another order; bf16: two bf16 ulps
# of |o| <= 2, since both round o to bf16 and p to bf16 before P·V), and
# lse (f32 in both) at LSE_TOL
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
LSE_TOL = 1e-4
# backward kernels against their plain version: each of dQ, dK, dV at
# BWD_TOL[dtype]·max|plain| (each grad sums up to s products in another
# order; in bf16 dS and P are rounded to bf16 from f32 values that may
# differ in the last bits, and each grad is rounded once more)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the backward passes' device ms at train_qkv on the CUDA-core kernels that
# the bf16 tensor-core route replaced (NVIDIA H100 80GB HBM3, 700 W): quoted
# for comparison in the printout, not measured by this script
PREV_BWD_MS = {"dq": 0.8617, "dkv": 1.1106}
# the same for the forward, on its CUDA-core kernel at train_qkv_b8 and
# prefill_qkv_b8 (NVIDIA H100 80GB HBM3, 700 W): quoted, not measured here
PREV_FWD_MS = {"train_qkv_b8": 0.5868, "prefill_qkv_b8": 0.0244}
# f32 training, card against CPU: losses at rel 1e-4 (the same f32
# arithmetic summed in another order through 12 layers), step-1 grads per
# param at 1e-2 relative L2, ‖g_card − g_cpu‖ / ‖g_cpu‖. Not element by
# element, and not tighter: a ReLU input within f32 rounding of 0 takes
# the other branch on one side (phase 6 counts them: 4 of the 18.9 M
# ReLU inputs of a step on an H100, |input| ≤ 6.1e-7); each moves one
# column of its layer's ffn_in grad by one token's share (3.3% of max|g|
# at worst) and that token's grads in every layer below, up to 9.8e-4
# relative L2 (the embedding). The element-wise error is reported. bf16
# kernels against the plain versions on the card: the first two losses
# at rel 2e-2
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_BF16_LOSS_TOL = 1e-4, 1e-2, 2e-2

# MNIST MLP as bench.py's bench_mnist_mlp runs it (batch 128, SGD(0.01), 5
# warm-up and 50 timed steps over 4 random feeds), and the fit check's
# epoch (synthetic MNIST, shuffle buffer 512 with seed 0, batch 64, Adam)
MNIST_BATCH, MNIST_FEEDS, MNIST_WARMUP, MNIST_STEPS = 128, 4, 5, 50
MNIST_PARITY_STEPS, MNIST_LR, MNIST_FIT_BATCH, MNIST_FIT_LR = 20, 0.01, 64, 1e-3
# f32 MNIST, card against CPU: losses at rel 1e-5 per step and final params
# at max abs 1e-5 (the same f32 products summed in another order, cuBLAS
# with TF32 off against the CPU's BLAS; three layers of 784, 200 and 200
# inputs). Profiled steps of phase 8's timing
MNIST_LOSS_TOL, MNIST_PARAM_TOL, MNIST_PROFILED_STEPS = 1e-5, 1e-5, 10

# phase 9: the GPT-base trainer of phase 7 takes CKPT_STEPS steps, is saved,
# and a fresh trainer loaded from the checkpoint takes RESUMED_STEPS more;
# MNIST fit (the phase-8 epoch, 2 epochs of 32 steps) checkpoints every
# MNIST_CKPT_INTERVAL steps and is sent SIGTERM after step MNIST_SIGTERM_STEP
# (mid epoch 2), then resumed; the MNIST artifact serves buckets
# SERVE_BUCKETS and a PredictorServer answers SERVE_REQUESTS requests of
# 1-128 rows. Served rows against trainer.eval on the same rows at the
# MNIST tolerance (another batch size may take another GEMM kernel)
CKPT_STEPS, RESUMED_STEPS = 3, 2
MNIST_CKPT_EPOCHS, MNIST_CKPT_INTERVAL, MNIST_SIGTERM_STEP = 2, 10, 45
SERVE_BUCKETS, SERVE_REQUESTS = (1, 8, 128), 64


# phase 10: ResNet-50 as bench.py bench_resnet50 trains it (depth 50, 1000
# classes, 224x224, batch 64, NHWC, bf16 compute, Momentum(0.1, 0.9), 4 random
# feeds from seed 0; 3 warm-up and 10 timed steps), 3 forward passes' FLOPs a
# training image (the port's core/flops.py ``resnet_fwd_flops``).
# (a) f32 parity card against CPU at 64x64 images, batch 16, 3 steps of
# Momentum(1e-4, 0.9). ResNet-50 at init on random data is ill-conditioned
# (backprop through 53 batch norms amplifies rounding; measured on the CPU by
# python3 -m paddle_tpu_torch.tools.resnet_conditioning): f32 against float64
# step-1 grads differ
# by up to 2.1e-2 relative L2 (a batch norm's bias), and
# with lr 0.1 the step-3 moving stats by 37% of their max; with lr 1e-4 the
# losses of steps 1-3 differ by 1.4e-6, 4.5e-4 and 5.7e-4 and the moving stats
# after them by 1.7e-5, 1.3e-3 and 1.1e-2 of max. At batch 4 even the f32 step-1
# grads of two CPU runs with 1 and 8 threads differ by 4% (1e-5 at batch 16):
# hence batch 16 and lr 1e-4. Held: the step-1 loss at rel 1e-4 and the moving
# stats after it at 1e-4 of max (the forward alone), the step-1 grads at 5e-2
# relative L2 per param, the losses of steps 2-3 at 5e-3 and the moving stats
# after step 3 at 5e-2 of max. The params' moves over the 3 steps, card against
# CPU, at 0.4 relative L2 per param (the grads of steps 2-3 inherit the
# conditioning: the worst param, a batch norm's bias, read 0.279-0.292 on five
# runs on an H100); so each card step's update is also held against Momentum's
# formula on that step's own grads and velocity in float64, element by element
# within 2^-22 of the magnitudes it sums (two f32 roundings, 0.9 and lr as f32).
# (c) NCHW against NHWC in bf16: the first losses at rel 2e-2 (each
# conv rounds its bf16 output once, from sums in another order). (e) the served
# logits against trainer.eval's at 1e-2 of their max (bf16; the same program
# on the same shapes, so equal unless cuDNN picks another algorithm). (d)
# mnist.conv_net at batch 64, Momentum(0.01, 0.9)
RESNET = dict(depth=50, class_num=1000, image_size=224)
RESNET_BATCH, RESNET_FEEDS, RESNET_WARMUP, RESNET_STEPS = 64, 4, 3, 10
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_PARITY_IMAGE, RESNET_PARITY_BATCH, RESNET_PARITY_STEPS = 64, 16, 3
RESNET_PARITY_LR = 1e-4
RESNET_LOSS1_TOL, RESNET_GRAD_TOL, RESNET_STATE1_TOL = 1e-4, 5e-2, 1e-4
RESNET_LOSS_TOL, RESNET_STATE_TOL, RESNET_MOVE_TOL = 5e-3, 5e-2, 0.4
RESNET_UPDATE_ULP = 2.0 ** -22
RESNET_LAYOUT_TOL, RESNET_LAYOUT_STEPS, RESNET_SCALING_STEPS = 2e-2, 3, 6
RESNET_INFER_BUCKETS, RESNET_INFER_TOL = (1, 16), 1e-2
RESNET_TOP_OPS = 12
CONVNET_BATCH, CONVNET_LR = 64, 0.01
# cuDNN's layout transposes, and any other kernel named for a transpose
TRANSPOSE_KERNELS = ("nchwToNhwc", "nhwcToNchw", "ranspose")

# phase 11: Transformer-base (base_config: d 512, d_inner 2048, 8 heads, 6+6
# layers, vocab 32000) and BERT-base (base_config, max_len 512) as bench.py
# trains them. (a) f32 parity card against CPU at dropout 0 from the card's
# initial params: the Transformer at b=4, s=64, 3 Adam(1e-3) steps; BERT at
# b=4, s=128, 2 AdamW steps; losses at TRAIN_LOSS_TOL, step-1 grads at
# TRAIN_GRAD_TOL relative L2 per param. (b) bench_transformer (bench.py:418-465):
# b=32, s=256, dropout 0.1, fuse_qkv, use_flash, fused_ce, bf16, Adam(1e-3),
# bench.py's 4 feeds from seed 0, 3 warm-up and 10 timed steps. (c) its
# params served: make_decoder(max_len=64) exported, loaded on the card, 8
# source rows of 256 (ragged, padded with 0) decoded greedily SEQ_SERVE_CALLS
# times. (d) bench_bert (bench.py:473-500): b=32, s=128, 20 masked, AdamW(1e-4,
# wd 0.01), fuse_qkv, use_flash, fused_ce, max_len 512, bf16. (e)
# bench_transformer_long (bench.py:466): b=4, s=4096, max_len 4096, dropout 0,
# 2 warm-up and 5 timed steps. Evals and the first long step are held
# against the same run through the kernels' plain versions on the card at
# TRAIN_BF16_LOSS_TOL, and what each path hands the kernels (the first call
# of each kind) against the plain versions element by element, as phases 3
# and 3b hold them; phase 3 and 3b also run these shapes under a padded key
# bias. (f) dropout on the card: a 10^7-element mask's keep
# rate within 4 sigma, the same rng the same bits, and two GPT-base layers at
# dropout 0.1 with and without remat (grads within SEQ_REMAT_TOL rel L2)
TRANSFORMER = dict(src_vocab=32000, trg_vocab=32000, d_model=512, d_inner=2048,
                   num_heads=8, num_encoder_layers=6, num_decoder_layers=6)
SEQ_FEEDS, SEQ_WARMUP, SEQ_STEPS = 4, 3, 10
TR_BATCH, TR_SEQ, TR_LR = 32, 256, 1e-3
TR_PARITY_BATCH, TR_PARITY_SEQ, TR_PARITY_STEPS = 4, 64, 3
BERT_BASE = dict(max_len=512)
BERT_BATCH, BERT_SEQ, BERT_MASKED, BERT_LR, BERT_WD = 32, 128, 20, 1e-4, 0.01
BERT_PARITY_BATCH, BERT_PARITY_SEQ, BERT_PARITY_STEPS = 4, 128, 2
SEQ_SERVE_ROWS, SEQ_SERVE_SRC, SEQ_SERVE_MAX_LEN, SEQ_SERVE_CALLS = 8, 256, 64, 3
SEQ_SERVE_BEAM, SEQ_SERVE_ALPHA = 4, 0.6
LONG_BATCH, LONG_SEQ, LONG_WARMUP, LONG_STEPS = 4, 4096, 2, 5
DROPOUT_N, DROPOUT_P, SEQ_REMAT_TOL = 10 ** 7, 0.1, 1e-6
SEQ_TOP_OPS = 8
# the first long step's grads: each param's relative L2 distance from the
# same step in f32, the kernels' run at most LONG_GRAD_RATIO times the
# plain versions' (both bf16, which part from f32 by 3% at the median
# param, 8% at the worst; the ratio read 0.98 at the median and 1.29 at
# the worst on an H100); the served decoder's log-probabilities (bf16,
# the kernels) against the plain CPU run's (f32) at SERVE_LOGP_TOL max
# abs, over every step whose inputs agree (read: 0.012 a row)
LONG_GRAD_RATIO, SERVE_LOGP_TOL = 2.0, 0.05


# phase 12: captured steps (Trainer.run_steps: one CUDA graph of the step,
# replayed K times a dispatch). (a) MNIST MLP as bench.py
# bench_dispatch_overhead (bench.py:584: f32, batch 128, SGD(0.01), K=16),
# FUSED_MNIST_DISPATCHES dispatches a timed turn; (b)-(d) GPT-base (phase 7's
# config), ResNet-50 (phase 10's, with a dynamic loss scaler) and
# Transformer-base (phase 11's, dropout 0.1) at K=FUSED_K, FUSED_DISPATCHES
# dispatches a timed turn, in turns eager, captured, captured, eager; the
# Transformer under DistStrategy(remat=True) cut to FUSED_REMAT_LAYERS+FUSED_REMAT_LAYERS
# layers; (e) the guard's NaN batch at step FUSED_GUARD_AT of a K=16
# dispatch; (f) BERT-base (phase 11 (d)'s config, K=FUSED_K) and transformer_long
# (K=FUSED_LONG_K). Every comparison of captured against eager steps is bit for bit.
FUSED_MNIST_K, FUSED_MNIST_DISPATCHES, FUSED_GUARD_AT = 16, 48, 5
FUSED_K, FUSED_DISPATCHES, FUSED_REMAT_LAYERS = 4, 2, 2
# (f) transformer_long (phase 11 (e)'s config) at K=2, eager and captured
# trainers one after the other (two would not fit the card together); where
# two eager runs from one state are not bit-equal (atomics in a library
# kernel), captured steps are held to an eager run within FUSED_NONDET_RATIO
# times the distance between the two eager runs
FUSED_LONG_K, FUSED_NONDET_RATIO, FUSED_LOSS_FLOOR = 2, 2.0, 1e-5

# phase 13: the captured decode at phase 5's config (GPT_BASE bf16, prompt
# PROMPT, NEW_TOKENS new tokens) at bucket DECODE_BUCKET, beam DECODE_BEAM;
# the f32 beam checks at phase 4's width (PARITY_NEW_TOKENS new tokens),
# card against CPU from the same params. With the compute cache, the best
# beam's score within BEAM_SCORE_TOL absolute (read 1.53e-05 on an H100:
# about 65x room). With the int8 cache, the best beam's score within
# INT8_SCORE_TOL (read 3.05e-05 on an H100: about 33x room) and at least
# INT8_IDS_SHARE of the beams' ids equal (read all 32: f32 rounding may
# move a value across an int8 rounding boundary, so 4 may part)
DECODE_BUCKET, DECODE_BEAM, BEAM_SCORE_TOL = 8, 4, 1e-3
INT8_SCORE_TOL, INT8_IDS_SHARE = 1e-3, 0.875


# phase 14: (a) the build GPT's readings of phases 7 and 12(b) against the
# module GPT's, which this script read at its last run before GPT became a
# build program (NVIDIA H100 80GB HBM3, 700.00 W: quoted, not measured here),
# device time a step within BUILD_DEVICE_TOL of it on a 700 W card; (b)
# DistStrategy(remat=True, remat_policy=p) at phase 7's config, captured,
# K=REMAT_K, REMAT_DISPATCHES timed dispatches each, peak memory over the
# first dispatch (its capture: a warm-up that copies the training state,
# the same for every setting); against the remat-off run: the K steps'
# losses at BF16_ROUNDING (relative), the grads of one forward and backward
# from the initial params (L2 distance over their norm) and the params
# after the K steps (L2 distance over the remat-off params' move from their
# initial values) each at REMAT_TOL, far below the 1 that zeroed grads give
# and the 0.5 of halved ones (bit-equality reported); what each setting
# leaves allocated after its trainer is gone within ALLOC_GROWTH_GB of what
# the first left (less than one cuBLAS workspace);
# the trained scope then served by GPTGenerator (HANDOFF_PROMPT prompt
# tokens, HANDOFF_NEW new ones, bucket 2), captured against eager; (c) the
# stacked Transformer at bench.py's BENCH_STACKED=1 config (phase 11 (b)'s,
# stacked), eager against captured K=FUSED_K; stacked transformer_long (b=4,
# s=4096, dropout 0) K=FUSED_LONG_K with its flash calls recorded; (d)
# DistStrategy(accum_steps=a) at phase 7's config for a in ACCUM_STEPS,
# captured K=REMAT_K, against accum_steps 1: the K steps' losses at
# BF16_ROUNDING, the grads of the first batch from the initial params at
# ACCUM_GRAD_TOL and the params after the K steps at ACCUM_PARAM_TOL (the
# distances of (b)); a planted fault (accum_steps 2, every second
# microbatch's grads dropped) must exceed both limits; ResNet-50 (phase
# 10 (b)'s config) one step at
# accum_steps 2, its batch-norm state against the same two microbatches'
# forwards threaded by hand (RESNET_ACCUM_STATE_TOL of the state's largest
# move, against the unthreaded state's distance)
MODULE_GPT = {"eager_device_ms": 56.75, "captured_device_ms": 56.36,
                   "captured_ops": 2949, "captured_ms": 56.0761}
BUILD_DEVICE_TOL = 0.03
REMAT_SETTINGS = ("off", None, "nothing", "dots_no_batch", "dots", "everything")
REMAT_K, REMAT_DISPATCHES = 2, 3
HANDOFF_PROMPT, HANDOFF_NEW = 16, 8
ACCUM_STEPS, RESNET_ACCUM_STATE_TOL = (1, 2, 4), 1e-2
BF16_ROUNDING, REMAT_TOL, ALLOC_GROWTH_GB = 2.0 ** -8, 1e-3, 0.016
# near the geometric means of the sound readings (accum 2 and 4: grads
# 0.0024, params 0.033 of the move) and the planted fault's (0.71, 0.85) on
# an H100 80GB HBM3 at 700 W
ACCUM_GRAD_TOL, ACCUM_PARAM_TOL = 0.04, 0.15

# phase 15: DeepFM as bench.py trains it (_bench_deepfm_config, bench.py:541-582:
# 26 fields, embedding 16, 13 dense, 400-400-400, batch 2048, Adagrad(0.01),
# 4 random feeds from RandomState(0)) at 1000 rows a field (bench_deepfm) and
# 400,000 (bench_deepfm_10m: 10.4 M rows), f32, nothing cut. (a) card against
# CPU from the same params, DEEPFM_PARITY_STEPS steps: losses at rel
# DEEPFM_LOSS_TOL (f32 sums of the same products in another order, TF32 off);
# step-1 grads at DEEPFM_GRAD_TOL relative L2 per param (a bias's grad sums
# 2048 terms of either sign, ~45x cancellation, and a ReLU input within
# rounding of 0 may take the other branch on one side, as in phase 6); the
# params' moves over the steps at DEEPFM_MOVE_TOL relative L2 (Adagrad's first
# step is lr·g/(|g| + eps), which moves by at most lr·δ/4 for a relative
# error δ of g). (b), (c) DEEPFM_WARMUP warm-up and DEEPFM_STEPS timed steps
# eager, then the same steps captured at K=DEEPFM_K, bit-equal. (d) fit over
# synthetic ctr at (b)'s widths, DEEPFM_FIT_EPOCHS epochs of DEEPFM_FIT_BATCH,
# K=DEEPFM_K; save_trainer/load_trainer of (b)'s trainer, DEEPFM_RESUME_STEPS
# resumed steps bit-equal. (e) the recommender at its default widths
# (recommender.py:14-16) on synthetic MovieLens, batch REC_BATCH, Adam(REC_LR),
# REC_EPOCHS epochs eager and captured, as tests/test_srl_recommender.py:42-60
# trains it. (f) the optimizers new in the slice, OPT_STEPS steps of phase 8's
# MNIST MLP at rates around OPT_LR, card against CPU, held three ways:
# - the losses at MNIST_LOSS_TOL;
# - the params' moves at DEEPFM_MOVE_TOL relative L2, not at MNIST_PARAM_TOL
#   element by element: an adaptive first step moves a weight by
#   lr·g/(|g| + eps), so a weight whose grad lies within a few eps of 0
#   moves by an amount the grad's rounding sets (Adamax's params read
#   8.2e-5 apart at lr 1e-3 on an H100). Ftrl runs at l1 = l2 = 0: its L1
#   threshold |lin| > l1 is a step (3.7e-2 apart at l1 1e-4 on an H100),
#   and with l2 > 0 the first step scales a weight by r/(l2 + r), r =
#   |g|^(−2·lr_power)/lr, which the grads near 1e-10 set at lr_power −0.3
#   (3.1e-3 apart at l2 1e-4);
# - one more update from the card's params, grads and state, on both,
#   within OPT_UPDATE_TOL of the largest update after one f32 rounding of
#   the new value (the optimizer alone: the same f32 operations, the norms
#   of Lamb and LarsMomentum summed in another order; LarsMomentum's updates
#   are ~1e-4 of the params, so a last-bit difference moves the rounded
#   param by an ulp).
# Then sparse.apply_adagrad/apply_adam_lazy on (c)'s factor table with one
# batch's 53,248 ids, card against CPU within SPARSE_TOL of the largest
# value (the same sorted, in-order sums and IEEE operations; pow may round
# differently).
DEEPFM = dict(num_sparse_fields=26, sparse_feature_dim=1000, embedding_size=16,
              num_dense=13, hidden_dims=(400, 400, 400))
DEEPFM_BATCH, DEEPFM_FEEDS, DEEPFM_LR, DEEPFM_10M_DIM = 2048, 4, 0.01, 400_000
DEEPFM_WARMUP, DEEPFM_STEPS, DEEPFM_K, DEEPFM_PARITY_STEPS = 3, 20, 4, 3
DEEPFM_LOSS_TOL, DEEPFM_GRAD_TOL, DEEPFM_MOVE_TOL = 1e-5, 1e-3, 1e-3
DEEPFM_FIT_BATCH, DEEPFM_FIT_EPOCHS, DEEPFM_RESUME_STEPS = 256, 3, 2
REC_BATCH, REC_LR, REC_EPOCHS = 64, 1e-2, 3
REC_NAMES = ["user_id", "gender_id", "age_id", "job_id", "movie_id", "category_ids",
             "title_ids", "score"]
OPT_STEPS, OPT_LR, OPT_UPDATE_TOL, SPARSE_TOL = 3, 1e-3, 1e-5, 1e-6
DEEPFM_TOP_OPS = 6
DEEPFM_FAMILIES = (
    ("matmuls", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("gathers and index_put", ("index", "gather", "scatter", "sort", "radix", "cub::")),
    ("reductions", ("reduce_kernel",)),
    # the step's write of the new values into the state (foreach copies)
    ("copies and fills", ("copy", "Memcpy", "Memset", "fill", "Fill", "multi_tensor_apply")),
    ("elementwise", ("elementwise",)))

# phase 16: the image zoo as bench.py trains it (_bench_convnet, bench.py:344-384:
# NHWC, bf16 compute, Momentum(0.01, 0.9), 1000 classes, 224x224, 4 feeds of f32
# randn images and int64 labels from RandomState(0)): bench_vgg16 (:335, batch
# 64), bench_alexnet (:387, 256), bench_googlenet (:397, 64) and
# bench_se_resnext (:407, 32); nothing cut. Each eager, then captured
# (run_steps, K=ZOO_K) from the same params, bit for bit; ZOO_DISPATCHES
# dispatches a timed turn. (a) f32 parity, card against CPU, dropout off, at
# the CPU tests' sizes but VGG-16's batch: (image size, batch, grads' relative
# L2 tolerance). The batch-normed nets' f32 grads at init are ill-conditioned,
# as tests/test_torch_convnets.py measures against float64; VGG-16's fc batch
# norm over a batch of 2 normalises two values a feature (a sign), and card and
# CPU part there by 7.3e-4 in the logits and 1.6e-2 in the grads (an H100),
# so the card holds it at batch 8
ZOO = {"vgg16": 64, "alexnet": 256, "googlenet": 64, "se_resnext50": 32}
ZOO_IMAGE, ZOO_K, ZOO_DISPATCHES, ZOO_LR, ZOO_MOMENTUM = 224, 4, 2, 0.01, 0.9
ZOO_TOP_OPS = 6
ZOO_PARITY = {"vgg16": (32, 8, 1e-2), "alexnet": (64, 2, 1e-4),
              "googlenet": (64, 2, 1e-4), "se_resnext50": (64, 4, 5e-2)}
ZOO_PARITY_CLASSES, ZOO_OUT_TOL = 5, 1e-4

# readings a later phase compares with: {path: {metric: value}}
READINGS = {}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*parts):
    print(*parts, flush=True)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, iters, repeats=5):
    """Device time of one call of ``fn``: CUDA events around ``iters``
    back-to-back calls, divided by ``iters``; the median of ``repeats``
    such averages, after one warm call.

    At these sizes the host takes longer to launch a call than the card
    takes to run it, so events around calls launched one by one would
    time the host. Each batch is therefore queued behind a sleep kernel
    that outlasts the host's launches: when the sleep ends, every call
    is already queued and the card runs them without waiting. The start
    event must still be pending once all calls are queued, or the sleep
    is lengthened and the batch timed again."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    launch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # at most 2e9 SM cycles a second, so this sleeps at least 2 launch_s
    cycles = int(4e9 * launch_s) + 10_000_000
    times = []
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            times.append(start.elapsed_time(end) / iters)
        else:
            check(cycles < 1e10, "device_ms: the host cannot queue the calls "
                  "ahead of the card")
            cycles *= 4
    times.sort()
    return times[len(times) // 2]


def _host_ms(fn, n=3):
    """Median host-clock ms of ``n`` calls of ``fn``, each ending in a
    synchronize."""
    import torch
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


# -- phase 3: the kernel against its plain version ---------------------------


Case = collections.namedtuple(
    "Case", "name b h sq sk d dtype causal bias segments fully_masked qkv pad",
    defaults=(False, False, False, False, False, False))

# the padding mask's value (layers.attention.NEG_INF), which ``pad`` cases
# add to the key bias on a ragged tail of keys
PAD_BIAS = -1e9


def kernel_cases():
    """q, k, v are [b, h, s, d]. In the ``qkv`` cases they are what the
    served prefill and the training step hand the kernel: strided head
    views of one fused [b, s, 3, h·d] projection
    (``layers.stacked._split_heads``), at both served buckets and at the
    training shape. The kernels record has rows ``train_qkv_b8`` and
    ``prefill_qkv_b8``. The bf16 cases at head dims 64 and 128 run on the
    tensor cores, the f32 and bf16 head-dim-32 ones on the CUDA cores.
    The ``transformer``, ``served``, ``bert`` and ``long`` qkv cases are
    phase 11's shapes: the encoders' non-causal attention under a key
    bias (random, plus the padding mask on a ragged tail of each row's
    keys) and the decoders' causal self-attention."""
    return [
        Case("prefill_qkv_b8", 8, 12, 128, 128, 64, "bfloat16", causal=True,
             qkv=True),
        Case("prefill_qkv_b1", 1, 12, 128, 128, 64, "bfloat16", causal=True,
             qkv=True),
        Case("train_qkv_b8", 8, 12, 1024, 1024, 64, "bfloat16", causal=True,
             qkv=True),
        Case("prefill", 8, 12, 128, 128, 64, "bfloat16", causal=True),
        Case("long", 1, 12, 2048, 2048, 64, "bfloat16", causal=True),
        Case("long4096", 1, 12, 4096, 4096, 64, "bfloat16", causal=True),
        Case("ragged_f32", 2, 12, 100, 300, 64, "float32", bias=True,
             segments=True),
        Case("ragged_bf16", 2, 12, 100, 300, 64, "bfloat16", bias=True,
             segments=True),
        Case("ragged_causal_bf16", 2, 12, 100, 300, 64, "bfloat16", causal=True,
             bias=True, segments=True),
        Case("fully_masked_f32", 2, 4, 96, 96, 64, "float32", causal=True,
             segments=True, fully_masked=True),
        Case("head32_f32", 2, 4, 70, 70, 32, "float32", causal=True),
        Case("head128_bf16", 2, 4, 70, 130, 128, "bfloat16", causal=True,
             bias=True),
        # every branch of the bf16 tensor-core route: fully masked rows,
        # causal sq > sk (the first sq - sk rows see no key), bias and
        # segment ids at head dim 128 on strided qkv views with a length
        # that is not a multiple of the 64-row tile; and bf16 head dim
        # 32, which the route sends to the CUDA cores
        Case("fully_masked_bf16", 2, 4, 96, 96, 64, "bfloat16", causal=True,
             segments=True, fully_masked=True),
        Case("causal_sq_gt_sk_bf16", 2, 12, 300, 100, 64, "bfloat16",
             causal=True),
        Case("qkv_h128_bias_segments_bf16", 2, 8, 331, 331, 128, "bfloat16",
             causal=True, bias=True, segments=True, qkv=True),
        Case("head32_bf16", 2, 4, 70, 70, 32, "bfloat16", causal=True),
        # phase 11: Transformer-base eval (b=32, s=256), its served encoder
        # (8 rows), BERT-base eval (b=32, s=128) and the long-context step
        Case("transformer_enc_qkv", 32, 8, 256, 256, 64, "bfloat16", bias=True,
             qkv=True, pad=True),
        Case("transformer_dec_qkv", 32, 8, 256, 256, 64, "bfloat16", causal=True,
             qkv=True),
        Case("served_enc_qkv_b8", 8, 8, 256, 256, 64, "bfloat16", bias=True,
             qkv=True, pad=True),
        Case("bert_qkv", 32, 12, 128, 128, 64, "bfloat16", bias=True, qkv=True,
             pad=True),
        Case("long_enc_qkv", 4, 8, 4096, 4096, 64, "bfloat16", bias=True, qkv=True,
             pad=True),
        Case("long_dec_qkv", 4, 8, 4096, 4096, 64, "bfloat16", causal=True,
             qkv=True),
    ]


def _case_inputs(case, dev, seed):
    import torch
    b, h, sq, sk, d = case.b, case.h, case.sq, case.sk, case.d
    g = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, case.dtype)
    if case.qkv:
        from paddle_tpu_torch.layers.stacked import _split_heads
        qkv = torch.randn(b, sq, 3, h * d, generator=g).to(dev, dtype)
        q, k, v = (_split_heads(qkv[:, :, i], d) for i in range(3))
        check(not q.is_contiguous(), f"{case.name}: q is not a strided view")
    else:
        q, k, v = (torch.randn(b, h, s, d, generator=g).to(dev, dtype)
                   for s in (sq, sk, sk))
    kw = {"causal": case.causal}
    if case.bias:
        kw["key_bias"] = torch.randn(b, sk, generator=g)
        if case.pad:  # row i pads its last i·sk/(2b) keys
            for i in range(b):
                kw["key_bias"][i, sk - i * sk // (2 * b):] = PAD_BIAS
        kw["key_bias"] = kw["key_bias"].to(dev)
    if case.segments:
        seg_q = (torch.arange(sq) * 3 // sq).repeat(b, 1)
        seg_k = (torch.arange(sk) * 3 // sk).repeat(b, 1)
        if case.fully_masked:  # the last query segment has no key
            seg_q[:, sq // 2:] = 7
        kw["segment_ids"] = seg_q.to(dev, torch.int32)
        kw["kv_segment_ids"] = seg_k.to(dev, torch.int32)
    return q, k, v, kw


def _visible_pairs(q, k, kw):
    """Query-key pairs this run's masks leave visible, over all b·h."""
    import torch
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    vis = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=q.device)
    if kw.get("causal"):
        vis &= torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
    if "segment_ids" in kw:
        vis &= (kw["segment_ids"][:, None, :, None]
                == kw["kv_segment_ids"][:, None, None, :])
    return int(vis.sum().item()) * h


def bound_of(q, k, v, kw, like=None, rows=1, products=2):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    over HBM bandwidth and its multiply-adds over the peak rate of the
    operand type. Bytes, each read or written once: q, k and v, one more
    tensor of the size of each of ``like`` (the forward writes o: (q,);
    the dQ pass reads dO and writes dQ: (q, q); the dK/dV pass reads dO
    and writes dK, dV: (q, k, k)), ``rows`` f32 values per query row
    (lse; lse and δ in the backward), the bias and the ids. Operations:
    ``products`` d-long products per visible pair (Q·Kᵀ and P·V in the
    forward)."""
    like = (q,) if like is None else like
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, *like))
    nbytes += rows * q.shape[0] * q.shape[1] * q.shape[2] * 4
    for key in ("key_bias", "segment_ids", "kv_segment_ids"):
        if key in kw:
            nbytes += kw[key].numel() * 4
    flops = 2 * products * q.shape[-1] * _visible_pairs(q, k, kw)
    dt = str(q.dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dt]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev, seed):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa

    rows = {}
    for case in kernel_cases():
        name, b, h, sq, sk, d, dt = case[:7]
        q, k, v, kw = _case_inputs(case, dev, seed)
        layout = "strided qkv views" if case.qkv else "contiguous"
        route = fa.ROUTES[(q.dtype, d)]
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        if name == "train_qkv_b8":  # one writer per output tile: the same bits
            o2, lse2 = fa.flash_attention(q, k, v, return_lse=True, **kw)
            check(torch.equal(o, o2) and torch.equal(lse, lse2),
                  f"{name}: two runs of the forward differ")
        ro, rlse = fa.flash_attention_reference(
            q, k, v, kw["causal"], kw.get("key_bias"), kw.get("segment_ids"),
            kw.get("kv_segment_ids"))
        err = (o.float() - ro.float()).abs().max().item()
        lerr = (lse - rlse).abs().max().item()
        check(torch.isfinite(o.float()).all().item(), f"{name}: non-finite output")
        ok_o = torch.allclose(o.float(), ro.float(), atol=TOL[dt], rtol=TOL[dt])
        ok_l = torch.allclose(lse, rlse, atol=LSE_TOL, rtol=LSE_TOL)
        if case.fully_masked:
            rows_masked = o[:, :, sq // 2:].float()
            check(rows_masked.abs().max().item() == 0.0,
                  f"{name}: fully masked rows are not 0")
            check((lse[:, :, sq // 2:] < -1e29).all().item(),
                  f"{name}: fully masked rows' lse is not about -1e30")
        if case.causal and sq > sk:  # the first sq - sk rows see no key
            check(o[:, :, :sq - sk].float().abs().max().item() == 0.0
                  and (lse[:, :, :sq - sk] < -1e29).all().item(),
                  f"{name}: rows that see no key are not o = 0, lse about -1e30")
        iters = 10 if sq * sk > 1e6 else 50
        ms = device_ms(lambda: fa.flash_attention(q, k, v, **kw), iters)
        plain_ms = device_ms(lambda: fa.flash_attention_reference(
            q, k, v, kw["causal"], kw.get("key_bias"), kw.get("segment_ids"),
            kw.get("kv_segment_ids")), max(5, iters // 10))
        lib_ms = None
        if sq == sk and len(kw) == 1:  # causal or not, no bias/ids: same mask
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=kw["causal"]), iters)
        bound_ms, bound_by = bound_of(q, k, v, kw)
        rows[name] = dict(max_abs_err=err, lse_err=lerr, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
        say(f"kernel {name}: [{b},{h},{sq},{sk},{d}] {dt} {route} {layout} "
            f"causal={kw['causal']} bias={'key_bias' in kw} "
            f"segments={'segment_ids' in kw} pad={case.pad} | "
            f"max|o-plain|={err:.3g} (tol {TOL[dt]}) max|lse-plain|={lerr:.3g} "
            f"(tol {LSE_TOL}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}) | "
            f"{'ok' if ok_o and ok_l else 'MISMATCH'}")
        check(ok_o and ok_l, f"{name}: kernel disagrees with its plain version")
        if name in PREV_FWD_MS:
            pairs = _visible_pairs(q, k, kw)
            say(f"kernel {name}: {ms:.4f} ms (before the tensor-core route, quoted: "
                f"{PREV_FWD_MS[name]} ms, {PREV_FWD_MS[name] / ms:.2f}x), bound "
                f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it "
                f"reached, {4 * d * pairs / (ms * 1e-3) / 1e12:.1f} TFLOP/s on 2 "
                f"products a visible pair"
                + ("" if lib_ms is None else f", {ms / lib_ms:.2f}x sdpa")
                + ("; two runs gave the same bits" if name == "train_qkv_b8" else ""))
    # no query row: the wrapper launches nothing and counts nothing
    before = fa.flash_fwd_launches
    e = torch.empty(0, 12, 128, 64, dtype=torch.bfloat16, device=dev)
    check(fa.flash_attention(e, e, e, causal=True).shape == e.shape
          and fa.flash_fwd_launches == before,
          "kernel: an empty batch was counted as a launch")
    return rows


# -- phase 3b: the backward kernels against their plain version --------------


def bwd_cases():
    """The training step hands the backward kernels the strided qkv head
    views and a strided dO (``_merge_heads``' backward gives a transposed
    view of a [b, s, h, d] tensor); its row of the kernels record is
    ``train_qkv``."""
    return [
        Case("train_qkv", 8, 12, 1024, 1024, 64, "bfloat16", causal=True, qkv=True),
        Case("long", 1, 12, 2048, 2048, 64, "bfloat16", causal=True),
        Case("ragged_f32", 2, 12, 100, 300, 64, "float32", bias=True,
             segments=True),
        Case("causal_sq_gt_sk_bf16", 2, 12, 300, 100, 64, "bfloat16", causal=True),
        Case("fully_masked_f32", 2, 4, 96, 96, 64, "float32", causal=True,
             segments=True, fully_masked=True),
        Case("head32_f32", 2, 4, 70, 70, 32, "float32", causal=True),
        Case("head128_bf16", 2, 4, 70, 130, 128, "bfloat16", causal=True,
             bias=True),
        # every branch of the bf16 tensor-core route: bias and segment ids
        # with sq != sk and sk - sq not a multiple of the 64-row tile, with
        # and without causal; fully masked rows; a causal length that is
        # not a multiple of the tile; head dim 128 at a length with whole
        # unmasked tiles; and bf16 head dim 32, which the route sends to
        # the CUDA cores
        Case("bias_segments_bf16", 2, 12, 200, 331, 64, "bfloat16", bias=True,
             segments=True),
        Case("causal_bias_segments_bf16", 2, 12, 200, 331, 64, "bfloat16",
             causal=True, bias=True, segments=True),
        Case("fully_masked_bf16", 2, 4, 96, 96, 64, "bfloat16", causal=True,
             segments=True, fully_masked=True),
        Case("causal_1000_bf16", 2, 12, 1000, 1000, 64, "bfloat16", causal=True),
        Case("head128_long_bf16", 1, 12, 1024, 1024, 128, "bfloat16", causal=True),
        Case("head32_bf16", 2, 4, 70, 70, 32, "bfloat16", causal=True),
        # phase 11's long-context step: the encoder's non-causal
        # attention under a key bias and the decoder's causal one
        Case("long_enc_qkv", 4, 8, 4096, 4096, 64, "bfloat16", bias=True, qkv=True,
             pad=True),
        Case("long_dec_qkv", 4, 8, 4096, 4096, 64, "bfloat16", causal=True,
             qkv=True),
    ]


def _sdpa_backward_ms(q, k, v, g, causal, iters):
    """Device ms of ``scaled_dot_product_attention``'s backward (dq, dk
    and dv together): forward plus backward, less the forward."""
    import torch
    import torch.nn.functional as F
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qr, kr, vr), g)

    return device_ms(fwd_bwd, iters) - device_ms(fwd, iters)


def phase_bwd_kernels(dev, seed):
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa

    rows = {}
    for case in bwd_cases():
        name, b, h, sq, sk, d, dt = case[:7]
        q, k, v, kw = _case_inputs(case, dev, seed)
        g_ = torch.Generator().manual_seed(seed + 7)
        dtype = getattr(torch, dt)
        if case.qkv:  # dO as the head split's backward hands it over
            g = torch.randn(b, sq, h, d, generator=g_).to(dev, dtype).transpose(1, 2)
        else:
            g = torch.randn(b, h, sq, d, generator=g_).to(dev, dtype)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        delta = (out.float() * g.float()).sum(-1)
        args = (q, k, v, kw["causal"], kw.get("key_bias"), kw.get("segment_ids"),
                kw.get("kv_segment_ids"), g, lse, delta)
        got = (fa.flash_bwd_dq_cuda(*args), *fa.flash_bwd_dkv_cuda(*args))
        torch.cuda.synchronize()
        route = fa.ROUTES[(q.dtype, d)]
        if name == "train_qkv":  # one writer per output tile, no atomics: the same bits
            again = (fa.flash_bwd_dq_cuda(*args), *fa.flash_bwd_dkv_cuda(*args))
            check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                  f"{name}: two runs of a backward pass differ")
        want = (fa.flash_bwd_dq_reference(*args), *fa.flash_bwd_dkv_reference(*args))
        errs, ok = {}, True
        for gname, a, w in zip(("dq", "dk", "dv"), got, want):
            tol = BWD_TOL[dt] * w.float().abs().max().item()
            errs[gname] = ((a.float() - w.float()).abs().max().item(), tol)
            ok &= torch.isfinite(a.float()).all().item() and errs[gname][0] <= tol
        if case.fully_masked:  # rows with no visible key get no gradient
            check(got[0][:, :, sq // 2:].abs().max().item() == 0.0,
                  f"{name}: fully masked rows' dq is not 0")
        if case.causal and sq > sk:  # the first sq - sk rows see no key
            check(got[0][:, :, :sq - sk].abs().max().item() == 0.0,
                  f"{name}: dq of rows that see no key is not 0")
        iters = 5 if sq * sk > 1e6 else 20
        ms = {"dq": device_ms(lambda: fa.flash_bwd_dq_cuda(*args), iters),
              "dkv": device_ms(lambda: fa.flash_bwd_dkv_cuda(*args), iters)}
        plain = {"dq": device_ms(lambda: fa.flash_bwd_dq_reference(*args), iters),
                 "dkv": device_ms(lambda: fa.flash_bwd_dkv_reference(*args), iters)}
        lib_ms = None
        if sq == sk and len(kw) == 1:  # causal or not, no bias/ids: same mask
            lib_ms = _sdpa_backward_ms(q, k, v, g, kw["causal"], iters)
        bounds = {"dq": bound_of(q, k, v, kw, like=(q, q), rows=2, products=3),
                  "dkv": bound_of(q, k, v, kw, like=(q, k, k), rows=2, products=4)}
        max_err = {"dq": errs["dq"][0], "dkv": max(errs["dk"][0], errs["dv"][0])}
        rows[name] = {p: dict(ms=ms[p], plain_ms=plain[p], library_ms=lib_ms,
                              bound_ms=bounds[p][0], bound_by=bounds[p][1],
                              max_abs_err=max_err[p], route=route)
                      for p in ("dq", "dkv")}
        layout = "strided qkv views, strided dO" if case.qkv else "contiguous"
        say(f"backward {name}: [{b},{h},{sq},{sk},{d}] {dt} {route} {layout} "
            f"causal={kw['causal']} bias={'key_bias' in kw} "
            f"segments={'segment_ids' in kw} pad={case.pad} | "
            + " ".join(f"max|{n}-plain|={e:.3g} (tol {t:.3g})"
                       for n, (e, t) in errs.items())
            + f" | dq kernel {ms['dq']:.4f} ms, plain {plain['dq']:.4f} ms, bound "
            f"{bounds['dq'][0] * 1e3:.2f} us ({bounds['dq'][1]}) | dkv kernel "
            f"{ms['dkv']:.4f} ms, plain {plain['dkv']:.4f} ms, bound "
            f"{bounds['dkv'][0] * 1e3:.2f} us ({bounds['dkv'][1]}) | sdpa backward "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} | "
            f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name}: a backward kernel disagrees with its plain version")
        if name == "train_qkv":
            pairs = _visible_pairs(q, k, kw)
            for p_, n_products in (("dq", 3), ("dkv", 4)):
                tflops = 2 * n_products * d * pairs / (ms[p_] * 1e-3) / 1e12
                say(f"backward {name} {p_}: {ms[p_]:.4f} ms (before the tensor-core "
                    f"route, quoted: {PREV_BWD_MS[p_]} ms, "
                    f"{PREV_BWD_MS[p_] / ms[p_]:.2f}x), "
                    f"bound {bounds[p_][0]:.4f} ms ({bounds[p_][1]}), "
                    f"{100 * bounds[p_][0] / ms[p_]:.1f}% of it reached, "
                    f"{tflops:.1f} TFLOP/s on {n_products} products a visible pair; "
                    f"two runs gave the same bits")
            if lib_ms is not None:
                say(f"backward {name}: dq + dkv {ms['dq'] + ms['dkv']:.4f} ms against "
                    f"sdpa backward {lib_ms:.4f} ms in this run: "
                    f"{(ms['dq'] + ms['dkv']) / lib_ms:.2f}x")
    return rows


# -- phase 4: f32 path parity, card against CPU ------------------------------


def phase_parity(dev, seed):
    import numpy as np
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(max_len=PROMPT + NEW_TOKENS, dtype="float32",
                          **GPT_BASE)
    t0 = time.perf_counter()
    card = gpt.make_generator(cfg, PARITY_NEW_TOKENS, device=dev).init_params(seed)
    host = gpt.make_generator(cfg, PARITY_NEW_TOKENS, device="cpu").load_params(
        {k: v.cpu() for k, v in card.flat_params().items()})
    prompts = np.random.RandomState(seed).randint(
        3, cfg.vocab_size, (8, PROMPT)).astype(np.int32)
    with torch.inference_mode():
        lp_card = card.prefill(torch.from_numpy(prompts).to(dev))[0].cpu()
        lp_host = host.prefill(torch.from_numpy(prompts))[0]
    diff = (lp_card - lp_host).abs().max().item()
    before = fa.flash_fwd_launches
    ids_card = card(prompts)["ids"].cpu().numpy()
    per_call = fa.flash_fwd_launches - before
    ids_host = host(prompts)["ids"].numpy()
    same = int((ids_card == ids_host).all(axis=1).sum())
    say(f"parity f32 GPT-base b=8 p={PROMPT} new={PARITY_NEW_TOKENS}: "
        f"max|logp0 card - cpu|={diff:.3g} (tol 1e-3), ids equal in "
        f"{same}/8 rows, flash_fwd_launches per generate call={per_call} "
        f"(want {cfg.num_layers}), {time.perf_counter() - t0:.1f} s")
    check(diff <= 1e-3, "parity: logp0 differs from the CPU run")
    check(same == 8, "parity: token ids differ from the CPU run")
    check(per_call == cfg.num_layers,
          f"parity: {per_call} kernel launches per generate call")
    del card, host


# -- phase 5: the served path -------------------------------------------------


def phase_served(dev, seed, card):
    """Export, serve and check the bf16 decoder; returns the launches of
    each kernel during the served path."""
    import numpy as np
    import torch
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.fleet import decode
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(max_len=PROMPT + NEW_TOKENS, dtype="bfloat16",
                          **GPT_BASE)
    rng = np.random.RandomState(seed + 1)
    example = rng.randint(3, cfg.vocab_size, (max(BUCKETS), PROMPT)).astype(np.int32)
    prompts = rng.randint(3, cfg.vocab_size, (N_REQUESTS, PROMPT)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "decoder")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts(fa)
        # ---- the main path, as a user drives it
        decode.export_decoder(d, cfg, NEW_TOKENS, example,
                              batch_buckets=list(BUCKETS), seed=seed,
                              compute_dtype="bfloat16", device=dev)
        outs, lat, wall, rep = _serve_single_prompts(d, prompts, dev)
        launches = _launch_counts(fa)
        # ---- end of the main path
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        big = max(BUCKETS)
        pred = pio.load_inference_model(d, device=dev)
        rows_ok = _rows_of_merged_batches(pred, prompts, outs)
        alone = sum(int(np.array_equal(
            outs[i], pred.run({"prompt_ids": prompts[i:i + 1]})["ids"].cpu().numpy()))
            for i in range(N_REQUESTS))
        served_breakdown(pred.program, prompts[:big], card)
    valid = all(o.shape == (1, NEW_TOKENS) and o.dtype == np.int32
                and o.min() >= 0 and o.max() < cfg.vocab_size for o in outs)
    tok_s = N_REQUESTS * NEW_TOKENS / wall
    say(f"served bf16 GPT-base ({card}): {N_REQUESTS} single-prompt requests, "
        f"p={PROMPT}, new={NEW_TOKENS}, buckets={list(BUCKETS)}: "
        f"{tok_s:.1f} generated tokens/s, latency p50 "
        f"{1e3 * float(np.percentile(lat, 50)):.1f} ms p99 "
        f"{1e3 * float(np.percentile(lat, 99)):.1f} ms, wall {wall:.2f} s, "
        f"peak memory {peak_gb:.3f} GB, coalesced "
        f"{rep['coalesced_requests']} requests in {rep['coalesced_batches']} "
        f"batches, flash_fwd launches {launches['flash_fwd']}")
    say(f"served check: {rows_ok}/{N_REQUESTS} replies equal their row of "
        f"Predictor.run on the merged bucket batch (required); {alone}/"
        f"{N_REQUESTS} equal a pad-alone bucket-1 run (reported only)")
    check(valid, "served: replies are not int32 ids of the expected shape")
    check(rows_ok == N_REQUESTS,
          "served: replies differ from Predictor.run on the merged batch")
    check(rep["errors"] == 0 and rep["completed"] == N_REQUESTS,
          f"served: {rep['errors']} errors, {rep['completed']} completed")
    return launches


def _serve_single_prompts(d, prompts, dev):
    """``decode_server`` over the artifact in ``d`` answers each row of
    ``prompts`` as a single-prompt request. Returns (replies as numpy,
    sorted latencies, wall seconds, the server's report)."""
    from paddle_tpu_torch.fleet import decode

    # a wait budget far above the time the submits take, so the requests
    # coalesce as full bucket-sized dispatches in submit order (the check
    # rebuilds exactly those batches); full batches dispatch at once, so
    # the budget adds no latency
    srv = decode.decode_server(d, max_wait_ms=1000.0, workers=1, device=dev)
    try:
        t0 = time.perf_counter()
        pends = [srv.submit({"prompt_ids": prompts[i:i + 1]}) for i in range(len(prompts))]
        outs = [p.result(timeout=600)["ids"].cpu().numpy() for p in pends]
        wall = time.perf_counter() - t0
        rep = srv.report()
    finally:
        srv.close(drain=True, timeout=120)
    return outs, sorted(p.latency for p in pends), wall, rep


def _rows_of_merged_batches(pred, prompts, outs):
    """How many replies equal their row of ``Predictor.run`` on the batch
    the server merged them into (submit order, the largest bucket, the
    last group padded with zero rows up to its bucket)."""
    import numpy as np
    big = max(BUCKETS)
    rows_ok = 0
    for g0 in range(0, len(prompts), big):
        group = prompts[g0:g0 + big]
        fill = min(b for b in BUCKETS if b >= len(group)) - len(group)
        group = np.concatenate([group, np.zeros((fill, group.shape[1]), np.int32)])
        merged = pred.run({"prompt_ids": group})["ids"].cpu().numpy()
        rows_ok += sum(int(np.array_equal(outs[i][0], merged[i - g0]))
                       for i in range(g0, min(g0 + big, len(prompts))))
    return rows_ok


def served_breakdown(prog, ids, card):
    """Where one bucket-sized generate call spends its time: host-clock
    prefill and whole-call times (median of 3, each ending in a
    synchronize), then one call under torch.profiler for the device's
    busy share and the flash kernel's share of device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ids = torch.from_numpy(ids).to(prog.device)
    with torch.inference_mode():
        prefill_ms = _host_ms(lambda: prog.prefill(ids))
        call_ms = _host_ms(lambda: prog(ids))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prog(ids)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = 0.0
    n_kernels = 0
    # the forward's two kernels: the bf16 call must run the tensor-core one
    kernels = dict.fromkeys(("flash_fwd_wgmma", "flash_fwd_kernel"), 0.0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += evt.self_device_time_total
        n_kernels += evt.count
        for name in kernels:
            if name in evt.key:
                kernels[name] += evt.self_device_time_total
    steps = prog.max_new_tokens - 1
    busy = ("not measured (the profiler saw no device time)" if device_us == 0
            else f"{100 * device_us / 1e3 / wall_ms:.1f}% of a profiled "
                 f"{wall_ms:.1f} ms call, {n_kernels} device kernels; "
                 + ", ".join(f"{k} {v / 1e3:.4f} ms ({100 * v / device_us:.3f}%)"
                             for k, v in kernels.items())
                 + " of device time")
    say(f"served breakdown ({card}), one generate call at b={ids.shape[0]}: "
        f"prefill {prefill_ms:.2f} ms, whole call {call_ms:.1f} ms, decode "
        f"{(call_ms - prefill_ms) / steps:.2f} ms per step over {steps} steps; "
        f"device busy {busy}")
    check(kernels["flash_fwd_wgmma"] > 0,
          "served: the profiled generate call shows no device time of the "
          "forward's tensor-core kernel")
    check(kernels["flash_fwd_kernel"] == 0,
          "served: the bf16 generate call ran the forward's CUDA-core kernel")


# -- phases 6 and 7: training ------------------------------------------------


def _train_feeds(rng, n, batch, seq, vocab):
    """bench_gpt's feeds: ids in [3, vocab), labels the ids shifted left
    with 2 appended."""
    import numpy as np
    feeds = []
    for _ in range(n):
        ids = rng.randint(3, vocab, (batch, seq)).astype(np.int32)
        labels = np.concatenate([ids[:, 1:], np.full((batch, 1), 2)],
                                axis=1).astype(np.int32)
        feeds.append({"ids": ids, "labels": labels})
    return feeds


def _zero_launch_counts(fa):
    fa.flash_fwd_launches = 0
    fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0


def _launch_counts(fa):
    return {"flash_fwd": fa.flash_fwd_launches,
            "flash_bwd_dq": fa.flash_bwd_dq_launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_launches}


@contextlib.contextmanager
def plain_versions_on_card(fa):
    """Route CUDA tensors through the kernels' plain versions, so one run
    can be held against the same run through the kernels. Used only by
    this check; the port itself never takes them for a CUDA tensor."""
    saved = fa.flash_fwd_cuda, fa.flash_bwd_cuda
    fa.flash_fwd_cuda = (lambda q, k, v, causal, key_bias=None, seg_q=None,
                         seg_k=None: fa.flash_attention_reference(
                             q, k, v, causal, key_bias, seg_q, seg_k))
    fa.flash_bwd_cuda = fa.flash_attention_bwd_reference
    try:
        yield
    finally:
        fa.flash_fwd_cuda, fa.flash_bwd_cuda = saved


def _trainer(cfg, dev, strategy=None):
    """bench_gpt's program and optimizer: ``build(gpt.make_model(cfg))``
    and AdamW; it computes in the ambient ``amp_guard``'s dtype."""
    from paddle_tpu_torch import Trainer, build, optimizer
    from paddle_tpu_torch.models import gpt
    return Trainer(build(gpt.make_model(cfg)),
                   optimizer.AdamW(TRAIN_LR, weight_decay=TRAIN_WD),
                   loss_name="loss", fetch_list=["loss"], device=dev, strategy=strategy)


def phase_train_parity(dev, seed):
    """f32 GPT-base training, card (kernels) against CPU (plain versions),
    from the same weights."""
    import numpy as np
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(max_len=PARITY_TRAIN_SEQ, dtype="float32", **GPT_BASE)
    t0 = time.perf_counter()
    feeds = _train_feeds(np.random.RandomState(seed + 2), PARITY_TRAIN_STEPS,
                         PARITY_TRAIN_BATCH, PARITY_TRAIN_SEQ, cfg.vocab_size)
    for f in feeds:
        f["labels"][0, -16:] = 0  # padding, masked out of the loss
    card = _trainer(cfg, dev).startup(seed, sample_feed=feeds[0])
    host = _trainer(cfg, "cpu").startup(
        sample_feed=feeds[0], params={k: v.detach().cpu() for k, v in card.scope.params.items()})
    rel_loss, grad_err, grad_max_err, launches = [], {}, {}, []
    relu_in = {}
    for i, f in enumerate(feeds):
        before = _launch_counts(fa)
        with record_relu_inputs(i == 0) as relu_in["card"]:
            lc = float(card.step(f)["loss"])
        launches.append({k: v - before[k] for k, v in _launch_counts(fa).items()})
        with record_relu_inputs(i == 0) as relu_in["cpu"]:
            lh = float(host.step(f)["loss"])
        rel_loss.append(abs(lc - lh) / abs(lh))
        if i == 0:
            step1_relu = dict(relu_in)
            for name, p in card.scope.params.items():
                gh = host.scope.params[name].grad
                diff = p.grad.cpu() - gh
                grad_err[name] = (diff.norm() / gh.norm().clamp_min(1e-30)).item()
                grad_max_err[name] = (diff.abs().max()
                                      / gh.abs().max().clamp_min(1e-30)).item()
            flips, flip_cols, worst_col_flipped = _relu_flips(
                step1_relu, card.scope.params["gpt/encoder_stack/ffn_in/w"].grad.cpu(),
                host.scope.params["gpt/encoder_stack/ffn_in/w"].grad)
    worst = max(grad_err, key=grad_err.get)
    worst_max = max(grad_max_err, key=grad_max_err.get)
    n_relu = sum(t.numel() for t in step1_relu["cpu"])
    say(f"training parity f32 GPT-base b={PARITY_TRAIN_BATCH} s={PARITY_TRAIN_SEQ} "
        f"{cfg.num_layers} layers, {PARITY_TRAIN_STEPS} AdamW steps: loss rel "
        f"card - cpu per step {[f'{r:.3g}' for r in rel_loss]} (tol "
        f"{TRAIN_LOSS_TOL}), step-1 grads ‖card - cpu‖/‖cpu‖ worst "
        f"{grad_err[worst]:.3g} ({worst}; tol {TRAIN_GRAD_TOL}), max|card - "
        f"cpu|/max|cpu| worst {grad_max_err[worst_max]:.3g} ({worst_max}; "
        f"reported only); step-1 ReLU inputs of opposite sign on card and CPU: "
        f"{len(flips)} of {n_relu} (|input| <= {max(flips, default=0.0):.3g}), "
        f"the worst ffn_in/w grad column {'is' if worst_col_flipped else 'is not'}"
        f" one of their {flip_cols} units; launches per step {launches[0]}, "
        f"{time.perf_counter() - t0:.1f} s")
    check(max(rel_loss) <= TRAIN_LOSS_TOL, "training parity: losses differ")
    check(grad_err[worst] <= TRAIN_GRAD_TOL, "training parity: grads differ")
    check(all(n == cfg.num_layers for step in launches for n in step.values()),
          f"training parity: launches per step {launches}")


@contextlib.contextmanager
def record_relu_inputs(enabled=True):
    """Collect (on the CPU) the input of every ``torch.relu`` call made
    inside: the FFN of each block, in layer order. Collects nothing when
    not ``enabled``."""
    import torch
    seen, relu = [], torch.relu
    if not enabled:
        yield seen
        return

    def recording(x):
        seen.append(x.detach().cpu())
        return relu(x)

    torch.relu = recording
    try:
        yield seen
    finally:
        torch.relu = relu


def _relu_flips(relu_in, g_card, g_cpu):
    """(the CPU-side |input| of each ReLU input whose sign differs between
    the card and the CPU, the number of (layer, unit) columns they fall
    in, whether the ffn_in/w grad's worst column [L, d, d_inner] is one)."""
    import torch
    flips, flipped = [], []
    for a, b in zip(relu_in["card"], relu_in["cpu"]):
        differ = (a > 0) != (b > 0)
        flips += b[differ].abs().tolist()
        flipped.append(differ.flatten(0, -2).any(dim=0))
    flipped = torch.stack(flipped)  # [L, d_inner]
    col_err = (g_card - g_cpu).abs().amax(dim=1)  # [L, d_inner]
    return flips, int(flipped.sum()), bool(flipped.flatten()[col_err.argmax()])


def phase_train(dev, seed, card_name):
    """The bf16 GPT-base training path (bench_gpt's config and feeds, the
    program under ``amp_guard("bfloat16")``); returns the launches of each
    kernel during the path."""
    import paddle_tpu_torch as pt
    with pt.amp_guard("bfloat16"):
        return _train_path(dev, seed, card_name)


def _train_path(dev, seed, card_name):
    import numpy as np
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(**TRAIN)
    feeds = _train_feeds(np.random.RandomState(0), TRAIN_FEEDS, TRAIN_BATCH,
                         TRAIN_SEQ, cfg.vocab_size)
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    trainer = _trainer(cfg, dev).startup(seed, sample_feed=feeds[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(fa)
    # ---- the main path, as a user drives it
    losses = []
    for i in range(n_steps):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(trainer.step(feeds[i % TRAIN_FEEDS])["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts(fa)
    # ---- end of the main path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    ms_step = wall / TRAIN_STEPS * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / wall
    say(f"training bf16 GPT-base ({card_name}): b={TRAIN_BATCH} s={TRAIN_SEQ}, "
        f"AdamW({TRAIN_LR}, wd {TRAIN_WD}), {TRAIN_WARMUP} warm-up + "
        f"{TRAIN_STEPS} timed steps: {tok_s:.1f} tokens/s, {ms_step:.2f} ms per "
        f"step, peak memory {peak_gb:.3f} GB, launches {launches} (want "
        f"{cfg.num_layers * n_steps} each)")
    say("training losses per step: " + " ".join(f"{x:.5f}" for x in losses))
    check(all(np.isfinite(losses)), "training: a loss is not finite")
    check(losses[-1] < losses[0], "training: the loss did not fall")
    check(all(n == cfg.num_layers * n_steps for n in launches.values()),
          f"training: launches {launches}, want {cfg.num_layers} per step")
    train_breakdown(trainer, feeds[0], card_name)
    del trainer

    # the same first steps through the plain versions on the card
    plain = _trainer(cfg, dev).startup(seed, sample_feed=feeds[0])
    before = _launch_counts(fa)
    with plain_versions_on_card(fa):
        plain_losses = [float(plain.step(feeds[i])["loss"]) for i in range(2)]
    check(_launch_counts(fa) == before, "plain run launched a kernel")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    say(f"training bf16 kernels against the plain versions on the card, steps "
        f"1-2: losses {losses[:2]} vs {plain_losses}, rel "
        f"{[f'{r:.3g}' for r in rel]} (tol {TRAIN_BF16_LOSS_TOL})")
    check(max(rel) <= TRAIN_BF16_LOSS_TOL,
          "training: kernel losses differ from the plain versions'")
    del plain
    return launches


def train_breakdown(trainer, feed, card_name):
    """Where one training step's time goes: the host-clock step time
    (median of 3, each ending in a synchronize), then one step under
    torch.profiler: device time of the kernels launched in the forward
    and update ranges of ``Trainer.step`` (the backward's kernels are
    launched from autograd's own thread, outside any range, so the
    backward is the rest), the three kernels' share of device time and
    the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(feed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(feed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us, spans, n_ops = 0.0, {}, 0
    # the three kernels' two families: the bf16 step must run on the
    # tensor-core ones alone
    tensor_core = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")
    cuda_core = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    kernels = dict.fromkeys((*tensor_core, *cuda_core), 0.0)
    for evt in prof.key_averages():
        if evt.key.startswith("trainer."):
            # the range itself, and its copy on the device's timeline
            spans[evt.key] = max(spans.get(evt.key, 0.0), evt.device_time_total)
            continue
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += evt.self_device_time_total
        n_ops += evt.count
        for name in kernels:
            if name in evt.key:
                kernels[name] += evt.self_device_time_total
    if device_us == 0:
        seen = "not measured (the profiler saw no device time)"
    else:
        fwd = spans.get("trainer.forward", 0.0)
        upd = spans.get("trainer.update", 0.0)
        READINGS["gpt_eager"] = {"device_ms": device_us / 1e3, "ops": n_ops}
        seen = (f"device busy {100 * device_us / 1e3 / wall_ms:.1f}% of a profiled "
                f"{wall_ms:.1f} ms step ({device_us / 1e3:.2f} ms of device time in "
                f"{n_ops} operations: "
                f"forward {fwd / 1e3:.2f} ms, update {upd / 1e3:.2f} ms, backward "
                f"(the rest) {(device_us - fwd - upd) / 1e3:.2f} ms); "
                + ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / device_us:.1f}%)"
                            for k, v in kernels.items())
                + f", together {100 * sum(kernels.values()) / device_us:.1f}% of "
                  "device time")
    say(f"training breakdown ({card_name}), one step at b={TRAIN_BATCH} "
        f"s={TRAIN_SEQ}: {sorted(times)[1]:.2f} ms on the host clock; {seen}")
    check(all(kernels[k] > 0 for k in tensor_core),
          "training: the profiled step shows no device time of a tensor-core "
          "kernel")
    check(all(kernels[k] == 0 for k in cuda_core),
          "training: the bf16 step ran a kernel of the CUDA-core route")


# -- phase 8: MNIST MLP through build programs --------------------------------


def _mnist_feeds():
    """bench_mnist_mlp's feeds (bench.py:1763-1766)."""
    import numpy as np
    rng = np.random.RandomState(0)
    return [{"image": rng.randn(MNIST_BATCH, 784).astype(np.float32),
             "label": rng.randint(0, 10, (MNIST_BATCH, 1)).astype(np.int64)}
            for _ in range(MNIST_FEEDS)]


def phase_mnist(dev, seed, card_name):
    """Parity, prefetch bit-equality and the timed MNIST path; returns the
    hand kernels' launches during the path (none expected)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    _zero_launch_counts(fa)
    # ---- the main path, as a user drives it
    mnist_parity(dev, seed)
    mnist_fit(dev, seed)
    mnist_timed(dev, seed, card_name)
    launches = _launch_counts(fa)
    # ---- end of the main path
    say(f"mnist: hand-kernel launches during the path {launches} (the MLP runs none)")
    check(all(n == 0 for n in launches.values()), "mnist: a flash kernel launched")
    return launches


def _mnist_trainer(dev, opt):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import mnist
    return pt.Trainer(pt.build(mnist.mlp), opt, loss_name="loss", place=dev)


def mnist_parity(dev, seed):
    """(i) f32, card against CPU, from the same params."""
    import numpy as np
    import paddle_tpu_torch as pt

    feeds = _mnist_feeds()
    card = _mnist_trainer(dev, pt.optimizer.SGD(MNIST_LR)).startup(seed, feeds[0])
    host = _mnist_trainer("cpu", pt.optimizer.SGD(MNIST_LR)).startup(
        seed, feeds[0], params={k: v.detach().cpu() for k, v in card.scope.params.items()})
    lc, lh = [], []
    for i in range(MNIST_PARITY_STEPS):
        lc.append(card.step(feeds[i % MNIST_FEEDS])["loss"])
        lh.append(float(host.step(feeds[i % MNIST_FEEDS])["loss"]))
    lc = [float(x) for x in lc]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    perr = max((card.scope.params[k].detach().cpu() - p.detach()).abs().max().item()
               for k, p in host.scope.params.items())
    say(f"mnist parity f32 card - cpu, {MNIST_PARITY_STEPS} SGD({MNIST_LR}) steps at "
        f"b={MNIST_BATCH}: losses {lc[0]:.6f} -> {lc[-1]:.6f}, max rel {rel:.3g} (tol "
        f"{MNIST_LOSS_TOL}), final params max abs {perr:.3g} (tol {MNIST_PARAM_TOL})")
    check(all(np.isfinite(lc)) and lc[-1] < lc[0], "mnist parity: the loss did not fall")
    check(rel <= MNIST_LOSS_TOL, "mnist parity: losses differ between card and CPU")
    check(perr <= MNIST_PARAM_TOL, "mnist parity: params differ between card and CPU")


def mnist_fit(dev, seed):
    """(ii) fit with the prefetch against fit without it, then accuracy."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import data

    reader = data.batch(data.shuffle(data.datasets.mnist("train"), 512, seed=0),
                        MNIST_FIT_BATCH)
    sample = data.DataFeeder(["image", "label"]).feed(next(iter(reader())))
    runs = {}
    for prefetch in (True, False):
        tr = _mnist_trainer(dev, pt.optimizer.Adam(MNIST_FIT_LR)).startup(seed, sample)
        losses = []
        pt.fit(tr, reader, 1, ["image", "label"], prefetch=prefetch,
               event_handler=lambda e: losses.append(e.metrics["loss"])
               if e.kind == "end_step" else None)
        runs[prefetch] = (torch.stack(losses).cpu(), tr)
    same = torch.equal(runs[True][0], runs[False][0])
    params_same = all(torch.equal(p, runs[False][1].scope.params[k])
                      for k, p in runs[True][1].scope.params.items())
    trainer = runs[True][1]
    feeder = data.DataFeeder(["image", "label"])
    accs = [trainer.eval(feeder.feed(s))["acc"]
            for s in data.batch(data.datasets.mnist("test"), 256)()]
    acc = float(torch.stack(accs).mean())
    losses = runs[True][0]
    say(f"mnist fit: 1 epoch of synthetic MNIST ({len(losses)} steps, b={MNIST_FIT_BATCH}, "
        f"Adam({MNIST_FIT_LR})): prefetch on vs off losses bit-identical: {same}, final "
        f"params bit-identical: {params_same}; loss {float(losses[0]):.5f} -> "
        f"{float(losses[-1]):.5f}; test accuracy {acc:.4f} (want > 0.9)")
    check(same and params_same, "mnist fit: the prefetch changed the losses or params")
    check(bool(np.isfinite(losses.numpy()).all()), "mnist fit: a loss is not finite")
    check(acc > 0.9, f"mnist fit: test accuracy {acc:.4f}")


def _lookahead(feed_iter, dev):
    """A depth-1 lookahead from the consumer's own thread, measured beside
    the ``DeviceFeeder`` and used nowhere in the port: batch i+1 is pinned
    and its copy started on a side stream before step i runs; the compute
    stream waits on the copy's event, as the feeder's consumer does."""
    import numpy as np
    import torch

    stream = torch.cuda.Stream(dev)

    def stage(feed):
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in feed.items()}
        with torch.cuda.stream(stream):
            tensors = {k: t.to(dev, non_blocking=True) for k, t in pinned.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return tensors, ready, pinned

    def deliver(staged):
        tensors, ready, _ = staged
        current = torch.cuda.current_stream(dev)
        current.wait_event(ready)
        for t in tensors.values():
            t.record_stream(current)
        return tensors

    nxt = None
    for feed in feed_iter:
        cur, nxt = nxt, stage(feed)
        if cur is not None:
            yield deliver(cur)
    if nxt is not None:
        yield deliver(nxt)


def _thread_cpu_split(prof):
    """Top-level CPU op time (ms) on each thread a profile saw, keyed by
    the role its ops show: the step's thread (its ``trainer.`` ranges),
    the fill thread (the feeder's ``DeviceFeeder.stage`` ranges),
    autograd's device thread (the rest);
    and the fill thread's ops by self CPU time: {name: (ms, calls)}."""
    import torch

    by_thread = collections.defaultdict(float)
    names = collections.defaultdict(set)
    self_ms = collections.defaultdict(lambda: collections.defaultdict(lambda: [0.0, 0]))
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        names[evt.thread].add(evt.name)
        if evt.cpu_parent is None:
            by_thread[evt.thread] += evt.cpu_time_total / 1e3
        entry = self_ms[evt.thread][evt.name]
        entry[0] += evt.self_cpu_time_total / 1e3
        entry[1] += 1
    roles, fill_ops = {}, {}
    for tid, ms in by_thread.items():
        seen = names[tid]
        role = ("step" if any(n.startswith("trainer.") for n in seen) else
                "fill" if "DeviceFeeder.stage" in seen else "autograd")
        roles[role] = roles.get(role, 0.0) + ms
        if role == "fill":
            fill_ops.update(self_ms[tid])
    return roles, fill_ops


def _profile_steps(trainer, feed_iter, n):
    """Profile ``n`` steps fed by ``feed_iter``: (wall ms, device ops,
    copies, device us, host us by step range, thread split)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:  # see the fill thread's ops too (a thread the step did not start)
        from torch._C._profiler import _ExperimentalConfig
        extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        extra = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **extra) as prof:
        t0 = time.perf_counter()
        for feed in feed_iter:
            trainer.step(feed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us, n_ops, memcpy, host_us = 0.0, 0, 0, {}
    for evt in prof.key_averages():
        if evt.key.startswith("trainer."):
            if evt.device_type == torch.autograd.DeviceType.CPU:
                host_us[evt.key] = evt.cpu_time_total
            continue
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += evt.self_device_time_total
        n_ops += evt.count
        memcpy += evt.count if "Memcpy" in evt.key or "Memset" in evt.key else 0
    return (wall_ms, n_ops, memcpy, device_us, host_us) + _thread_cpu_split(prof)


def _profile_line(name, n, prof):
    wall_ms, n_ops, memcpy, device_us, host_us, threads, fill_ops = prof
    top = sorted(fill_ops.items(), key=lambda kv: -kv[1][0])[:6]
    fill = ("" if not top else "; the fill thread's ops by self CPU ms a batch (calls a batch) "
            + ", ".join(f"{k} {ms / n:.3f} ({calls / n:.1f})" for k, (ms, calls) in top))
    if device_us == 0:
        return f"{name}: not measured (the profiler saw no device time)"
    return (f"{name}: {n_ops / n:.1f} device operations a step ({memcpy / n:.1f} of them "
            f"copies or memsets), {device_us / 1e3 / n:.4f} ms of device time a step, "
            f"device busy {100 * device_us / 1e3 / wall_ms:.1f}% of {n} profiled steps "
            f"({wall_ms / n:.3f} ms a step under the profiler; host ms a step in "
            + ", ".join(f"{k} {v / 1e3 / n:.3f}" for k, v in sorted(host_us.items()))
            + "; top-level CPU op ms a step by thread "
            + ", ".join(f"{k} {v / n:.3f}" for k, v in sorted(threads.items())) + fill + ")")


def mnist_timed(dev, seed, card_name):
    """(iii) bench_mnist_mlp's config fed through the prefetch. Beside it,
    the same steps fed by a depth-1 lookahead on the step's own thread, by
    a plain put and with the feeds already on the card, in the order
    A B C D E E D C B A (B is the prefetch with the interpreter lock's
    switch interval cut from 5 ms to 0.1 ms), each with the time the
    step's thread spends getting its feed, its CPU time (and the fill
    thread's: the thread clock may tick coarsely, 10 ms on some hosts, so
    0.2 ms a step over 50 steps); then profiles of the prefetched and the
    staged steps: device operations and time a step, the device's busy
    share, the host's time in the step's three ranges, the CPU op time of
    each thread and the fill thread's ops."""
    import torch
    import paddle_tpu_torch as pt

    feeds = _mnist_feeds()
    trainer = _mnist_trainer(dev, pt.optimizer.SGD(MNIST_LR)).startup(seed, feeds[0])
    staged = [trainer._put_feed(f) for f in feeds]
    fill_usage = []

    def batches(n):
        return lambda: (feeds[i % MNIST_FEEDS] for i in range(n))

    def fill_measured(n):
        def run():  # runs on the feeder's fill thread
            c0 = time.thread_time()
            try:
                yield from batches(n)()
            finally:
                fill_usage.append(time.thread_time() - c0)
        return run

    def switching_fast(feed_iter_fn):
        def run(n):  # the interpreter lock offered to a waiting thread every 0.1 ms
            old = sys.getswitchinterval()
            sys.setswitchinterval(1e-4)
            try:
                yield from feed_iter_fn(n)
            finally:
                sys.setswitchinterval(old)
        return run

    modes = {
        "prefetch": lambda n: pt.data.DeviceFeeder(fill_measured(n), device=dev),
        "prefetch_switch_0.1ms": switching_fast(
            lambda n: pt.data.DeviceFeeder(fill_measured(n), device=dev)),
        "lookahead": lambda n: _lookahead(batches(n)(), dev),
        "put": lambda n: map(trainer._put_feed, batches(n)()),
        "staged": lambda n: (staged[i % MNIST_FEEDS] for i in range(n)),
    }

    def timed(feed_iter, n):
        torch.cuda.synchronize()
        c0, t0 = time.thread_time(), time.perf_counter()
        feed_iter, wait = iter(feed_iter), 0.0
        while True:  # the time the step's thread spends getting each feed
            t1 = time.perf_counter()
            feed = next(feed_iter, None)
            wait += time.perf_counter() - t1
            if feed is None:
                break
            out = trainer.step(feed)
        torch.cuda.synchronize()
        wall, cpu = time.perf_counter() - t0, time.thread_time() - c0
        return {"ms": wall / n * 1e3, "cpu_ms": cpu / n * 1e3, "wait_ms": wait / n * 1e3}, out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mode in modes.values():
        for feed in mode(MNIST_WARMUP):
            trainer.step(feed)
    runs = collections.defaultdict(list)
    order = list(modes) + list(reversed(modes))
    for name in order:
        fill_usage.clear()
        r, out = timed(modes[name](MNIST_STEPS), MNIST_STEPS)
        if name.startswith("prefetch"):
            r["fill_cpu_ms"] = fill_usage[0] / MNIST_STEPS * 1e3
        runs[name].append(r)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    loss = float(out["loss"])
    ms_step = sum(r["ms"] for r in runs["prefetch"]) / len(runs["prefetch"])
    mean = {name: sum(r["ms"] for r in rs) / len(rs) for name, rs in runs.items()}

    def mode_line(name):
        rs = runs[name]
        line = (f"{name} " + " / ".join(f"{r['ms']:.4f}" for r in rs) + " ms a step, step "
                "thread CPU " + " / ".join(f"{r['cpu_ms']:.4f}" for r in rs) + " ms; "
                "getting the feed " + " / ".join(f"{r['wait_ms']:.4f}" for r in rs)
                + f" ms a step (wall); mean {mean[name]:.4f} ms, {mean[name] - mean['put']:+.4f} "
                "against the plain put")
        if "fill_cpu_ms" in rs[0]:
            line += ("; fill thread CPU " + " / ".join(f"{r['fill_cpu_ms']:.4f}" for r in rs)
                     + " ms a batch")
        return line

    n = MNIST_PROFILED_STEPS
    prof_lines = []
    for name in ("prefetch", "staged"):
        try:  # a breakdown for the reader, not a check
            prof_lines.append(_profile_line(f"profiled {name}", n,
                                            _profile_steps(trainer, modes[name](n), n)))
        except Exception as e:  # noqa: BLE001 - reported, and the checks go on
            prof_lines.append(f"profiled {name}: not measured ({type(e).__name__}: {e})")
    say(f"mnist timed ({card_name}): MLP 784-200-200-10, b={MNIST_BATCH}, SGD({MNIST_LR}), "
        f"{MNIST_WARMUP} warm-up steps a feed mode, then {MNIST_STEPS} timed steps a mode in "
        f"the order {' '.join(order)}: {MNIST_BATCH / ms_step * 1e3:.1f} samples/s, "
        f"{ms_step:.4f} ms per step through the prefetch (mean of both rounds); peak memory "
        f"{peak_mb:.2f} MB, last loss {loss:.5f}")
    for name in modes:
        say(f"mnist feed modes: {mode_line(name)}")
    for line in prof_lines:
        say(f"mnist {line}")
    check(ms_step > 0 and torch.isfinite(torch.tensor(loss)), "mnist timed: bad step")


# -- phase 9: persistence and inference ---------------------------------------


def phase_persistence(dev, seed, card_name):
    """(a) the GPT-base checkpoint round trip, (b) MNIST fit preempted by
    SIGTERM and resumed, (c) the MNIST inference artifact served; returns
    the hand kernels' launches during the path."""
    from paddle_tpu_torch.ops import flash_attention as fa

    with tempfile.TemporaryDirectory() as tmp:
        _zero_launch_counts(fa)
        # ---- the main path, as a user drives it
        gpt_checkpoint(dev, seed, card_name, tmp)
        mnist_resume(dev, seed, tmp)
        mnist_serving(dev, seed, card_name, tmp)
        launches = _launch_counts(fa)
        # ---- end of the main path
    say(f"persistence: hand-kernel launches during the path {launches}")
    check(all(n > 0 for n in launches.values()),
          f"persistence: a flash kernel never launched ({launches})")
    return launches


def _host_params(trainer):
    return {k: v.detach().cpu() for k, v in trainer.scope.params.items()}


def _max_param_diff(a, b):
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def gpt_checkpoint(dev, seed, card_name, tmp):
    """(a) The bf16 GPT-base trainer of phase 7: two uninterrupted runs of
    CKPT_STEPS + RESUMED_STEPS steps, the second saved after CKPT_STEPS;
    a fresh trainer (other initial values) loads it and takes the last
    RESUMED_STEPS steps. Its losses and params must equal the
    uninterrupted run's to the degree two uninterrupted runs agree."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(**TRAIN)
    n = CKPT_STEPS + RESUMED_STEPS
    feeds = _train_feeds(np.random.RandomState(1), n, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)

    def steps(trainer, fs):
        with pt.amp_guard("bfloat16"):
            return [float(x) for x in [trainer.step(f)["loss"] for f in fs]]

    def trainer(seed_):
        with pt.amp_guard("bfloat16"):
            return _trainer(cfg, dev).startup(seed_, sample_feed=feeds[0])

    first = trainer(seed)
    ref = steps(first, feeds)
    ref_params = _host_params(first)
    del first
    torch.cuda.empty_cache()
    second = trainer(seed)
    again = steps(second, feeds[:CKPT_STEPS])
    d = os.path.join(tmp, "gpt_base", "step_%d" % CKPT_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.io.save_trainer(d, second)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    t0 = time.perf_counter()
    man = pt.resilience.validate_checkpoint(d)
    validate_s = time.perf_counter() - t0
    again += steps(second, feeds[CKPT_STEPS:])
    again_params = _host_params(second)
    del second
    torch.cuda.empty_cache()
    resumed = trainer(seed + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.io.load_trainer(d, resumed)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    before = _launch_counts(fa)
    tail = steps(resumed, feeds[CKPT_STEPS:])
    resumed_launches = {k: v - before[k] for k, v in _launch_counts(fa).items()}
    resumed_params = _host_params(resumed)
    del resumed
    torch.cuda.empty_cache()

    def loss_rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    runs_equal = again == ref and all(torch.equal(again_params[k], ref_params[k])
                                      for k in ref_params)
    res_equal = tail == ref[CKPT_STEPS:] and all(
        torch.equal(resumed_params[k], ref_params[k]) for k in ref_params)
    run_loss, run_param = loss_rel(again, ref), _max_param_diff(again_params, ref_params)
    res_loss = loss_rel(tail, ref[CKPT_STEPS:])
    res_param = _max_param_diff(resumed_params, ref_params)
    say(f"persistence (a) bf16 GPT-base checkpoint ({card_name}): b={TRAIN_BATCH} "
        f"s={TRAIN_SEQ}, {sum(p.numel() for p in ref_params.values())} params, AdamW; "
        f"save_trainer after step {CKPT_STEPS}: {save_s:.3f} s, {nbytes} bytes "
        f"({nbytes / 1e9:.3f} GB, {len(man['files'])} files); validate_checkpoint: "
        f"valid (global_step {man['global_step']}, {validate_s:.3f} s); load_trainer "
        f"into a fresh trainer: {load_s:.3f} s")
    say(f"persistence (a) two uninterrupted runs of {n} steps bit-identical: "
        f"{runs_equal} (losses rel {run_loss:.3g}, params max abs {run_param:.3g}); "
        f"resumed steps {CKPT_STEPS + 1}-{n} against the uninterrupted run: "
        f"bit-identical {res_equal} (losses {tail} vs {ref[CKPT_STEPS:]}, rel "
        f"{res_loss:.3g}; params max abs {res_param:.3g}); launches in the resumed "
        f"steps {resumed_launches}")
    check(all(np.isfinite(ref)), "persistence: a loss is not finite")
    if runs_equal:
        check(res_equal, "persistence: the resumed run differs from the uninterrupted one")
    else:
        # a nondeterministic op on the path: the resumed run may differ from
        # the uninterrupted one as much as two uninterrupted runs differ
        # (twice that, for the spread of one more sample)
        check(res_loss <= 2 * run_loss and res_param <= 2 * run_param,
              "persistence: the resumed run differs from the uninterrupted one "
              "more than two uninterrupted runs do")
    check(all(v == cfg.num_layers * RESUMED_STEPS for v in resumed_launches.values()),
          f"persistence: launches in the resumed steps {resumed_launches}")


def mnist_resume(dev, seed, tmp):
    """(b) fit over phase 8's synthetic MNIST (prefetch on) with
    CheckpointConfig(step_interval=MNIST_CKPT_INTERVAL), stopped by a
    SIGTERM the process sends itself after step MNIST_SIGTERM_STEP, then
    fit(resume=True) to the end: the losses and final params equal the
    uninterrupted run's."""
    import signal
    import threading
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import data

    reader = data.batch(data.shuffle(data.datasets.mnist("train"), 512, seed=0),
                        MNIST_FIT_BATCH)
    sample = data.DataFeeder(["image", "label"]).feed(next(iter(reader())))
    cfg = pt.CheckpointConfig(os.path.join(tmp, "mnist"), epoch_interval=1,
                              step_interval=MNIST_CKPT_INTERVAL, max_num_checkpoints=3)

    def run(rng, handler=None, **kw):
        tr = _mnist_trainer(dev, pt.optimizer.Adam(MNIST_FIT_LR)).startup(rng, sample)
        pt.fit(tr, reader, MNIST_CKPT_EPOCHS, ["image", "label"], event_handler=handler,
               **kw)
        return tr

    ref_losses, losses, events = [], [], []

    def record(log):
        return lambda e: log.append(e.metrics["loss"]) if e.kind == "end_step" else None

    def preempting(e):
        events.append(e.kind)
        record(losses)(e)
        if e.kind == "end_step" and e.step == MNIST_SIGTERM_STEP:
            os.kill(os.getpid(), signal.SIGTERM)

    ref = run(seed, record(ref_losses))
    sigterm_before = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()
    stopped = run(seed, preempting, checkpoint_config=cfg)
    stop_s = time.perf_counter() - t0
    fill_alive = [t for t in threading.enumerate() if t.name == "DeviceFeeder.fill"]
    tags = [(c.tag, c.global_step) for c in pt.resilience.list_checkpoints(cfg.checkpoint_dir)]
    t0 = time.perf_counter()
    resumed = run(seed + 1, record(losses), checkpoint_config=cfg, resume=True)
    resume_s = time.perf_counter() - t0
    same = len(losses) == len(ref_losses) and torch.equal(torch.stack(losses).cpu(),
                                                          torch.stack(ref_losses).cpu())
    params_same = all(torch.equal(p, ref.scope.params[k])
                      for k, p in resumed.scope.params.items())
    say(f"persistence (b) mnist fit {MNIST_CKPT_EPOCHS} epochs x "
        f"{len(ref_losses) // MNIST_CKPT_EPOCHS} steps, Adam({MNIST_FIT_LR}), prefetch on, "
        f"step_interval {MNIST_CKPT_INTERVAL}: SIGTERM after step {MNIST_SIGTERM_STEP} -> "
        f"returned at step {stopped.global_step} with event {events[-1]!r} in {stop_s:.2f} s, "
        f"fill threads alive {len(fill_alive)}, checkpoints {tags}; fit(resume=True) to "
        f"step {resumed.global_step} in {resume_s:.2f} s: losses equal to the "
        f"uninterrupted run's bit for bit: {same}, final params: {params_same}")
    check(stopped.global_step == MNIST_SIGTERM_STEP and events[-1] == "preempted",
          "persistence: the SIGTERM did not stop fit at the step boundary")
    check(not fill_alive, "persistence: a DeviceFeeder fill thread outlived fit")
    check(signal.getsignal(signal.SIGTERM) == sigterm_before,
          "persistence: fit did not restore the SIGTERM handler")
    check(tags[-1] == (f"step_{MNIST_SIGTERM_STEP}", MNIST_SIGTERM_STEP),
          f"persistence: no boundary checkpoint ({tags})")
    check(resumed.global_step == ref.global_step and same and params_same,
          "persistence: the resumed run differs from the uninterrupted one")


def mnist_serving(dev, seed, card_name, tmp):
    """(c) bench_mnist_mlp's trainer after 20 steps exported at buckets
    SERVE_BUCKETS, loaded on the card: its outputs equal trainer.eval's; a
    PredictorServer answers SERVE_REQUESTS requests one at a time; a copy
    of the artifact with one byte flipped is refused."""
    import shutil
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import PredictorServer

    feeds = _mnist_feeds()
    trainer = _mnist_trainer(dev, pt.optimizer.SGD(MNIST_LR)).startup(seed, feeds[0])
    for i in range(MNIST_PARITY_STEPS):
        trainer.step(feeds[i % MNIST_FEEDS])
    d = os.path.join(tmp, "mnist_mlp")
    t0 = time.perf_counter()
    pt.io.save_inference_model(d, trainer.program, trainer.scope.params,
                               trainer.scope.state, feeds[0], batch_buckets=SERVE_BUCKETS)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = pt.io.load_inference_model(d, device=dev)
    load_s = time.perf_counter() - t0
    got, want = pred.run(feeds[1]), trainer.eval(feeds[1])
    exact = all(torch.equal(got[k], want[k]) for k in ("logits", "loss", "acc"))
    rng = np.random.RandomState(seed)
    lat, worst = [], 0.0
    with PredictorServer(pred, workers=2) as server:
        for _ in range(SERVE_REQUESTS):
            n = int(rng.randint(1, SERVE_BUCKETS[-1] + 1))
            rows = rng.choice(MNIST_BATCH, n, replace=False)
            f = {k: v[rows] for k, v in feeds[2].items()}
            t0 = time.perf_counter()
            out = server.run(f, timeout=60)
            lat.append((time.perf_counter() - t0) * 1e3)
            ref = trainer.eval(f)["logits"]
            check(out["logits"].device == torch.device(dev) and out["logits"].shape == (n, 10),
                  "persistence: a served reply is off the card or misshapen")
            worst = max(worst, (out["logits"] - ref).abs().max().item())
        report = server.report()
    p50, p99 = np.percentile(lat, [50, 99])
    flipped = d + "_flipped"
    shutil.copytree(d, flipped)
    p = os.path.join(flipped, "params.npz")
    with open(p, "r+b") as fh:
        fh.seek(os.path.getsize(p) // 2)
        b = fh.read(1)
        fh.seek(os.path.getsize(p) // 2)
        fh.write(bytes([b[0] ^ 0xFF]))
    try:
        pt.io.load_inference_model(flipped, device=dev)
        refused = None
    except pt.resilience.CheckpointCorrupt as e:
        refused = e.reason
    say(f"persistence (c) mnist artifact ({card_name}): save_inference_model at buckets "
        f"{list(SERVE_BUCKETS)} {save_s:.3f} s, load_inference_model on {dev} "
        f"{load_s:.3f} s; Predictor.run equals trainer.eval bit for bit at b={MNIST_BATCH}: "
        f"{exact}; PredictorServer (2 workers) answered {SERVE_REQUESTS} requests of 1-"
        f"{SERVE_BUCKETS[-1]} rows one at a time: latency p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms (host clock around server.run; the server's histogram: "
        f"p50 {report['latency_ms']['p50']} ms, p99 {report['latency_ms']['p99']} ms), "
        f"served logits against trainer.eval max abs {worst:.3g} (tol {MNIST_PARAM_TOL}), "
        f"completed {report['completed']}; a copy with one byte of params.npz flipped: "
        f"{refused!r}")
    check(exact, "persistence: the loaded artifact's outputs differ from trainer.eval's")
    check(worst <= MNIST_PARAM_TOL and report["completed"] == SERVE_REQUESTS,
          "persistence: served rows differ from trainer.eval's, or a request failed")
    check(refused is not None and "checksum" in refused,
          "persistence: a flipped byte was not refused")


# -- phase 10: ResNet-50 and mixed precision ----------------------------------


def _resnet_feeds(rng, n, batch, size, fmt):
    """bench_resnet50's feeds (bench.py:368-374): f32 randn images and
    int64 labels in [0, 1000), image then label from one rng per feed."""
    import numpy as np
    shape = (batch, size, size, 3) if fmt == "NHWC" else (batch, 3, size, size)
    return [{"image": rng.randn(*shape).astype(np.float32),
             "label": rng.randint(0, RESNET["class_num"], (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _nchw(feed):
    import numpy as np
    return dict(feed, image=np.ascontiguousarray(feed["image"].transpose(0, 3, 1, 2)))


def _resnet_trainer(dev, fmt, image_size=None, strategy=None, lr=RESNET_LR):
    """bench_resnet50's program and optimizer: the model built under
    ``layout_mode(fmt)`` with ``data_format=fmt``, Momentum(lr, 0.9)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import layout_mode
    from paddle_tpu_torch.models import resnet
    with layout_mode(fmt):
        prog = pt.build(resnet.make_model(
            depth=RESNET["depth"], class_num=RESNET["class_num"],
            image_size=image_size or RESNET["image_size"], data_format=fmt))
    return pt.Trainer(prog, pt.optimizer.Momentum(lr, RESNET_MOMENTUM),
                      loss_name="loss", fetch_list=["loss"], place=dev, strategy=strategy)


def _on_card(feeds, dev):
    import torch
    return [{k: torch.from_numpy(v).to(dev) for k, v in f.items()} for f in feeds]


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _rel_max(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def phase_resnet(dev, seed, card_name):
    """(a) f32 parity card against CPU, then the path a user drives: (b)
    the timed bf16 NHWC step at bench_resnet50's config, (c) NCHW against
    NHWC, (d) loss scaling and the guard on mnist.conv_net, (e) the (b)
    trainer exported and served; returns the hand kernels' launches
    during (b)-(e)."""
    import gc
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa

    resnet_parity(dev, seed, card_name)
    with tempfile.TemporaryDirectory() as tmp, pt.amp_guard("bfloat16"):
        _zero_launch_counts(fa)
        # ---- the main path, as a user drives it
        trainer, feeds = resnet_timed(dev, seed, card_name)
        resnet_loss_scaling(dev, seed, card_name)
        resnet_layouts(dev, seed, card_name)
        convnet_scaling_and_guard(dev, seed, card_name)
        resnet_inference(dev, trainer, feeds, card_name, tmp)
        launches = _launch_counts(fa)
        # ---- end of the main path
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    say(f"resnet: hand-kernel launches during the path {launches} (ResNet-50 and the "
        "conv net run none)")
    check(all(n == 0 for n in launches.values()), "resnet: a flash kernel launched")
    return launches


def resnet_parity(dev, seed, card_name):
    """(a) f32 ResNet-50 (depth 50, 1000 classes) at 64x64 images, batch
    16, NHWC: 3 Momentum(1e-4, 0.9) steps on the card and on the CPU from
    the card's initial params; a second card run from the same params
    gives the card's own spread. Each step of the first card run is held
    against Momentum's formula on its own grads (:func:`_momentum_err`)."""
    import numpy as np
    import torch

    feeds = _resnet_feeds(np.random.RandomState(seed), RESNET_PARITY_STEPS,
                          RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE, "NHWC")
    runs, update_err = {}, []
    t0 = time.perf_counter()
    first = _resnet_trainer(dev, "NHWC", RESNET_PARITY_IMAGE, lr=RESNET_PARITY_LR).startup(
        seed, feeds[0])
    p0 = {k: v.detach().to("cpu", copy=True) for k, v in first.scope.params.items()}
    for name, place, trainer in (("card", dev, first), ("card2", dev, None),
                                 ("cpu", "cpu", None)):
        trainer = trainer or _resnet_trainer(place, "NHWC", RESNET_PARITY_IMAGE,
                                             lr=RESNET_PARITY_LR).startup(seed, feeds[0],
                                                                          params=p0)
        losses, grads, states = [], None, []
        for i, f in enumerate(feeds):
            before = _momentum_snapshot(trainer) if name == "card" else None
            losses.append(float(trainer.step(f)["loss"]))
            if before is not None:
                update_err.append(_momentum_err(trainer, before, RESNET_PARITY_LR))
            if i == 0:
                grads = {k: p.grad.detach().cpu() for k, p in trainer.scope.params.items()}
            # copies: the step writes the state in place, and .cpu() of a CPU
            # tensor is the tensor itself
            states.append({k: v.detach().to("cpu", copy=True)
                           for k, v in trainer.scope.state.items()})
        moved = {k: v.detach().cpu() - p0[k] for k, v in trainer.scope.params.items()}
        runs[name] = (losses, grads, states, moved)
        del trainer
    del first
    secs = time.perf_counter() - t0
    (lc, gc_, sc, mc), (l2, g2, s2, m2), (lh, gh, sh, mh) = (runs["card"], runs["card2"],
                                                           runs["cpu"])
    moved_rel = {k: _rel_l2(mc[k], mh[k]) for k in mh}
    moved_worst = max(moved_rel, key=moved_rel.get)
    moved_all = _rel_l2(torch.cat([mc[k].flatten() for k in mh]),
                        torch.cat([mh[k].flatten() for k in mh]))
    moved_card = max(_rel_l2(mc[k], m2[k]) for k in m2)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]
    grad_rel = {k: _rel_l2(gc_[k], gh[k]) for k in gh}
    worst = max(grad_rel, key=grad_rel.get)
    state_rel = [max(_rel_max(a[k], b[k]) for k in b) for a, b in zip(sc, sh)]
    spread = (lc == l2 and all(torch.equal(gc_[k], g2[k]) for k in g2)
              and all(torch.equal(a[k], b[k]) for a, b in zip(sc, s2) for k in b))
    card_spread = ("bit-identical" if spread else
                   f"losses rel {[f'{abs(a - b) / abs(b):.3g}' for a, b in zip(lc, l2)]}, "
                   f"step-1 grads rel L2 up to {max(_rel_l2(gc_[k], g2[k]) for k in g2):.3g} "
                   f"({max(g2, key=lambda k: _rel_l2(gc_[k], g2[k]))})")
    say(f"resnet parity f32 ({card_name}): depth {RESNET['depth']}, {RESNET['class_num']} "
        f"classes, {RESNET_PARITY_IMAGE}x{RESNET_PARITY_IMAGE} NHWC, b={RESNET_PARITY_BATCH}, "
        f"{RESNET_PARITY_STEPS} Momentum({RESNET_PARITY_LR}, {RESNET_MOMENTUM}) steps in "
        f"{secs:.1f} "
        f"s: losses card {lc} cpu {lh}, rel {[f'{r:.3g}' for r in loss_rel]} (tol "
        f"{RESNET_LOSS1_TOL} at step 1, then {RESNET_LOSS_TOL}); step-1 grads of {len(gh)} "
        f"params rel L2 up to {grad_rel[worst]:.3g} ({worst}; tol {RESNET_GRAD_TOL}); moving "
        f"stats after each step up to {[f'{r:.3g}' for r in state_rel]} of max (tol "
        f"{RESNET_STATE1_TOL} after step 1, {RESNET_STATE_TOL} after step "
        f"{RESNET_PARITY_STEPS}); the params' moves over the {RESNET_PARITY_STEPS} steps rel "
        f"L2 up to {moved_rel[moved_worst]:.3g} ({moved_worst}; tol {RESNET_MOVE_TOL}), "
        f"{moved_all:.3g} over all params; each card step's Momentum update against its "
        f"formula: velocity and params within {[f'{v:.3g}/{q:.3g}' for v, q in update_err]} of "
        f"the f32 rounding bound; two card runs: {card_spread}, moves rel L2 up to "
        f"{moved_card:.3g}")
    check(all(np.isfinite(lc)), "resnet parity: a loss is not finite")
    check(loss_rel[0] <= RESNET_LOSS1_TOL and max(loss_rel) <= RESNET_LOSS_TOL,
          "resnet parity: losses differ card against CPU")
    check(grad_rel[worst] <= RESNET_GRAD_TOL, "resnet parity: grads differ card against CPU")
    check(state_rel[0] <= RESNET_STATE1_TOL and state_rel[-1] <= RESNET_STATE_TOL,
          "resnet parity: moving stats differ card against CPU")
    check(moved_rel[moved_worst] <= RESNET_MOVE_TOL,
          "resnet parity: the params' moves differ card against CPU")
    check(len(update_err) == RESNET_PARITY_STEPS and all(max(e) <= 1.0 for e in update_err),
          "resnet parity: a card step's Momentum update is not its formula")


def _momentum_snapshot(trainer):
    """{name: (param, velocity)} copies before a step."""
    acc = trainer.scope.opt_state["accums"]
    return {k: (p.detach().clone(), acc[k]["velocity"].clone())
            for k, p in trainer.scope.params.items()}


def _momentum_err(trainer, before, lr):
    """The step just taken against Momentum's formula in float64 on its own
    grads: v = 0.9·v_prev + g, p = p_prev − lr·v. Returns the worst
    |error| / (RESNET_UPDATE_ULP · the magnitudes summed) of the velocity
    and of the params; at most 1 where each is its formula rounded to f32."""
    acc = trainer.scope.opt_state["accums"]
    worst_v = worst_p = 0.0
    for k, p in trainer.scope.params.items():
        p_prev, v_prev = (t.double() for t in before[k])
        g, v, p_new = p.grad.double(), acc[k]["velocity"].double(), p.detach().double()
        bound_v = RESNET_UPDATE_ULP * (RESNET_MOMENTUM * v_prev.abs() + g.abs()) + 1e-30
        worst_v = max(worst_v, float(((v - (RESNET_MOMENTUM * v_prev + g)).abs()
                                      / bound_v).max()))
        bound_p = RESNET_UPDATE_ULP * (p_prev.abs() + lr * v.abs()) + 1e-30
        worst_p = max(worst_p, float(((p_new - (p_prev - lr * v)).abs() / bound_p).max()))
    return worst_v, worst_p


# kernel families of a profiled ResNet step, by name (the first match wins)
RESNET_FAMILIES = (
    ("layout transposes", TRANSPOSE_KERNELS),
    ("convs and matmuls", ("xmma", "cutlass", "cudnn", "nvjet", "gemm", "conv")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise",)))


def _profile_step(trainer, feed):
    """One profiled step: (wall ms, device us, device ops, rows of (us,
    calls, kernel), the layout-transpose kernels by name, device us by
    kernel family)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(feed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us, n_ops, rows, transposes = 0.0, 0, [], {}
    families = dict.fromkeys([f for f, _ in RESNET_FAMILIES] + ["other"], 0.0)
    for evt in prof.key_averages():
        # a record_function range shows a second time as a device event; on
        # this host-bound step its span includes the device's idle gaps
        if evt.key.startswith("trainer.") or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += evt.self_device_time_total
        n_ops += evt.count
        rows.append((evt.self_device_time_total, evt.count, evt.key))
        if any(t in evt.key for t in TRANSPOSE_KERNELS):
            transposes[evt.key[:90]] = evt.count
        family = next((f for f, keys in RESNET_FAMILIES if any(k in evt.key for k in keys)),
                      "other")
        families[family] += evt.self_device_time_total
    return wall_ms, device_us, n_ops, sorted(rows, reverse=True), transposes, families


def resnet_timed(dev, seed, card_name):
    """(b) bf16 NHWC ResNet-50 at bench_resnet50's config: 3 warm-up and
    10 timed steps fed as numpy (the trainer copies each batch to the
    card), then 10 on feeds already on the card, and one profiled step."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core import flops

    feeds = _resnet_feeds(np.random.RandomState(0), RESNET_FEEDS, RESNET_BATCH,
                          RESNET["image_size"], "NHWC")
    t0 = time.perf_counter()
    trainer = _resnet_trainer(dev, "NHWC").startup(seed, feeds[0])
    startup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.scope.params.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(RESNET_WARMUP + RESNET_STEPS):
        if i == RESNET_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(trainer.step(feeds[i % RESNET_FEEDS])["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    staged = _on_card(feeds, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RESNET_STEPS):
        losses.append(trainer.step(staged[i % RESNET_FEEDS])["loss"])
    torch.cuda.synchronize()
    wall_staged = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    ms, ms_staged = wall / RESNET_STEPS * 1e3, wall_staged / RESNET_STEPS * 1e3
    tflop = flops.convnet_train_flops(flops.resnet_fwd_flops(
        RESNET["depth"], RESNET["image_size"], RESNET["class_num"]), RESNET_BATCH) / 1e12
    say(f"resnet bf16 NHWC ({card_name}): depth {RESNET['depth']}, {RESNET['image_size']}x"
        f"{RESNET['image_size']}, b={RESNET_BATCH}, Momentum({RESNET_LR}, {RESNET_MOMENTUM}), "
        f"{n_params} params, startup {startup_s:.2f} s; {RESNET_WARMUP} warm-up + "
        f"{RESNET_STEPS} timed steps fed as numpy: {RESNET_BATCH / wall * RESNET_STEPS:.1f} "
        f"images/s, {ms:.2f} ms per step; {RESNET_STEPS} steps on feeds already on the card: "
        f"{RESNET_BATCH / wall_staged * RESNET_STEPS:.1f} images/s, {ms_staged:.2f} ms per "
        f"step ({tflop:.3f} TFLOP a step, {tflop / ms_staged * 1e3:.1f} TFLOP/s); peak memory "
        f"{peak_gb:.3f} GB")
    say("resnet losses per step: " + " ".join(f"{x:.5f}" for x in losses))
    check(all(np.isfinite(losses)), "resnet: a loss is not finite")
    wall_ms, device_us, n_ops, rows, transposes, families = _profile_step(trainer,
                                                                            staged[0])
    if device_us == 0:
        say("resnet breakdown: not measured (the profiler saw no device time)")
    else:
        say(f"resnet breakdown ({card_name}), one profiled step on the card's feed: "
            f"{device_us / 1e3:.2f} ms of device time in a {wall_ms:.2f} ms step, device busy "
            f"{100 * device_us / 1e3 / wall_ms:.1f}%, {n_ops} device operations; by kernel "
            f"family "
            + ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / device_us:.1f}%)"
                        for k, v in families.items())
            + f"; NCHW<->NHWC transpose kernels: {sum(transposes.values())} {transposes}")
        for us, calls, key in rows[:RESNET_TOP_OPS]:
            say(f"  resnet top op {us / 1e3:8.3f} ms {100 * us / device_us:5.1f}% "
                f"{calls:5d} calls  {key[:120]}")
    check(device_us > 0, "resnet: the profiler saw no device time, so the transposes "
          "cannot be counted")
    check(not transposes, f"resnet: layout transposes ran in the NHWC step: {transposes}")
    return trainer, feeds


def resnet_loss_scaling(dev, seed, card_name):
    """The mixed-precision layer's cost on the ResNet-50 step: the (b)
    config without a loss scaler and under DistStrategy(dynamic_loss_scale=
    True, loss_scale=1024), from the same params on feeds already on the
    card, in turns (a, b, b, a, twice; the median turn of each, as the
    host's step time jumps by tens of ms between turns), and each one's
    profiled step. bf16 does not overflow at that scale: the scale stays
    and the first losses agree at the bf16 tolerance of (c)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt

    feeds = _on_card(_resnet_feeds(np.random.RandomState(0), RESNET_FEEDS, RESNET_BATCH,
                                   RESNET["image_size"], "NHWC"), dev)
    strat = pt.DistStrategy(dynamic_loss_scale=True, loss_scale=1024.0)
    trainers = {"no scaler": _resnet_trainer(dev, "NHWC"),
                "dynamic scaler": _resnet_trainer(dev, "NHWC", strategy=strat)}
    first = {}
    for name, tr in trainers.items():
        tr.startup(seed, feeds[0])
        first[name] = float(tr.step(feeds[0])["loss"])
        for i in range(1, RESNET_WARMUP):
            tr.step(feeds[i % RESNET_FEEDS])
    times = {k: [] for k in trainers}
    order = (list(trainers) + list(trainers)[::-1]) * 2
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(RESNET_SCALING_STEPS):
            trainers[name].step(feeds[i % RESNET_FEEDS])
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / RESNET_SCALING_STEPS * 1e3)
    profiles = {k: _profile_step(tr, feeds[0])[1:3] for k, tr in trainers.items()}
    ls = trainers["dynamic scaler"].scope.loss_scale_state
    scale, overflows = float(ls["scale"]), int(ls["overflows"])
    rel = abs(first["dynamic scaler"] - first["no scaler"]) / abs(first["no scaler"])
    say(f"resnet loss scaling ({card_name}), bf16 NHWC b={RESNET_BATCH}, ms per step in turns "
        f"{order}, {RESNET_SCALING_STEPS} steps each: "
        + "; ".join(f"{k} {[round(t, 2) for t in v]} (median {np.median(v):.2f}; profiled step "
                    f"{profiles[k][0] / 1e3:.2f} ms of device time, {profiles[k][1]} device "
                    f"operations)" for k, v in times.items())
        + f"; first losses {first}, rel {rel:.3g} (tol {RESNET_LAYOUT_TOL}); scale {scale}, "
        f"overflows {overflows}")
    check(rel <= RESNET_LAYOUT_TOL, "resnet loss scaling: the first losses differ")
    check(scale == 1024.0 and overflows == 0, "resnet loss scaling: a bf16 step overflowed")
    del trainers


def resnet_layouts(dev, seed, card_name):
    """(c) NCHW against NHWC at the full config from the same params: the
    first step's losses agree, and ms per step of each (in turns)."""
    import numpy as np
    import torch

    feeds_h = _resnet_feeds(np.random.RandomState(0), RESNET_FEEDS, RESNET_BATCH,
                            RESNET["image_size"], "NHWC")
    staged = {"NHWC": _on_card(feeds_h, dev), "NCHW": _on_card([_nchw(f) for f in feeds_h], dev)}
    trainers = {fmt: _resnet_trainer(dev, fmt).startup(seed, staged[fmt][0])
                for fmt in ("NHWC", "NCHW")}
    check(all(torch.equal(trainers["NHWC"].scope.params[k], p)
              for k, p in trainers["NCHW"].scope.params.items()),
          "resnet layouts: the two trainers start from different params")
    first = {fmt: float(tr.step(staged[fmt][0])["loss"]) for fmt, tr in trainers.items()}
    rel = abs(first["NCHW"] - first["NHWC"]) / abs(first["NHWC"])
    times = {fmt: [] for fmt in trainers}
    for fmt in ("NHWC", "NCHW", "NCHW", "NHWC"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(RESNET_LAYOUT_STEPS):
            trainers[fmt].step(staged[fmt][(i + 1) % RESNET_FEEDS])
        torch.cuda.synchronize()
        times[fmt].append((time.perf_counter() - t0) / RESNET_LAYOUT_STEPS * 1e3)
    nchw_t = _profile_step(trainers["NCHW"], staged["NCHW"][0])
    say(f"resnet NCHW vs NHWC ({card_name}), bf16 b={RESNET_BATCH}: first-step losses "
        f"NHWC {first['NHWC']:.5f} NCHW {first['NCHW']:.5f}, rel {rel:.3g} (tol "
        f"{RESNET_LAYOUT_TOL}); ms per step in turns (NHWC, NCHW, NCHW, NHWC), "
        f"{RESNET_LAYOUT_STEPS} steps each: NHWC {[round(t, 2) for t in times['NHWC']]}, NCHW "
        f"{[round(t, 2) for t in times['NCHW']]}; the NCHW step profiled: "
        f"{nchw_t[1] / 1e3:.2f} ms of device time, {nchw_t[2]} device operations, transpose "
        f"kernels {sum(nchw_t[4].values())}")
    check(rel <= RESNET_LAYOUT_TOL, "resnet layouts: NCHW and NHWC losses differ")
    del trainers


def convnet_scaling_and_guard(dev, seed, card_name):
    """(d) mnist.conv_net at batch 64 in bf16: under dynamic loss scaling a
    NaN batch is skipped (the scale halves, params and moving stats stay
    bit-equal, the next clean step moves them); under GuardPolicy() a NaN
    batch is discarded with one Incident; fit over one epoch of synthetic
    MNIST reaches test accuracy above 0.9; LossScaler.all_finite on the
    card flags a single NaN or Inf."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import data
    from paddle_tpu_torch.amp import LossScaler
    from paddle_tpu_torch.models import mnist

    reader = data.batch(data.shuffle(data.datasets.mnist("train"), 512, seed=0),
                        CONVNET_BATCH)
    feed = data.DataFeeder(["image", "label"]).feed(next(iter(reader())))
    bad = dict(feed, image=np.full_like(feed["image"], np.nan))

    def trainer(**kw):
        return pt.Trainer(pt.build(mnist.conv_net), pt.optimizer.Momentum(CONVNET_LR, 0.9),
                          loss_name="loss", place=dev, **kw).startup(seed, feed)

    def snap(tr):
        return ({k: v.detach().clone() for k, v in tr.scope.params.items()},
                {k: v.clone() for k, v in tr.scope.state.items()})

    def same(a, b):
        return all(torch.equal(a[i][k], b[i][k]) for i in range(2) for k in a[i])

    scaled = trainer(strategy=pt.DistStrategy(dynamic_loss_scale=True, loss_scale=1024.0))
    scaled.step(feed)
    before = snap(scaled)
    skipped = scaled.step(bad)
    kept = same(before, snap(scaled))
    moved_after = scaled.step(feed)
    moved = not same(before, snap(scaled))
    guarded = trainer(guard=pt.GuardPolicy())
    guarded.step(feed)
    before_g = snap(guarded)
    guarded.step(bad)
    guarded.drain_guard()
    kept_g = same(before_g, snap(guarded))
    incidents = list(guarded.guard_incidents)
    t0 = time.perf_counter()
    fitted = trainer()
    pt.fit(fitted, reader, 1, ["image", "label"])
    fit_s = time.perf_counter() - t0
    accs = [fitted.eval(data.DataFeeder(["image", "label"]).feed(s))["acc"]
            for s in data.batch(data.datasets.mnist("test"), 256)()]
    acc = float(torch.stack(accs).mean())
    probes = {}
    for name, value in (("clean", None), ("nan", float("nan")), ("inf", float("inf"))):
        grads = [torch.randn(257, device=dev), torch.randn(33, 5, device=dev).bfloat16()]
        if value is not None:
            grads[0][100] = value
            grads[1][7, 3] = value
        probes[name] = bool(LossScaler.all_finite(grads))
    say(f"conv_net bf16 b={CONVNET_BATCH} ({card_name}): dynamic loss scale 1024, a NaN batch: "
        f"loss_scale {float(skipped['loss_scale'])} (want 512), params and moving stats "
        f"bit-equal {kept}, the next clean step moves them {moved} (loss "
        f"{float(moved_after['loss']):.5f}); GuardPolicy(): a NaN batch leaves them bit-equal "
        f"{kept_g}, incidents {[str(i) for i in incidents]}; fit over one epoch of synthetic "
        f"MNIST ({fitted.global_step} steps, Momentum({CONVNET_LR}, 0.9), prefetch) in "
        f"{fit_s:.2f} s: test accuracy {acc:.4f} (want > 0.9); all_finite on the card "
        f"{probes}")
    check(float(skipped["loss_scale"]) == 512.0 and kept and moved,
          "conv_net: the loss scaler did not skip the NaN batch cleanly")
    check(kept_g and len(incidents) == 1, "conv_net: the guard did not discard the NaN batch")
    check(acc > 0.9, "conv_net: test accuracy not above 0.9")
    check(probes == {"clean": True, "nan": False, "inf": False},
          f"conv_net: all_finite on the card gave {probes}")


def resnet_inference(dev, trainer, feeds, card_name, tmp):
    """(e) The (b) trainer exported at buckets RESNET_INFER_BUCKETS and
    loaded on the card: its outputs against trainer.eval's at b=16."""
    import torch
    import paddle_tpu_torch as pt

    rows = {k: v[:RESNET_INFER_BUCKETS[-1]] for k, v in feeds[1].items()}
    d = os.path.join(tmp, "resnet50")
    t0 = time.perf_counter()
    pt.io.save_inference_model(d, trainer.program, trainer.scope.params, trainer.scope.state,
                               rows, batch_buckets=RESNET_INFER_BUCKETS)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = pt.io.load_inference_model(d, device=dev)
    load_s = time.perf_counter() - t0
    got, want = pred.run(rows), trainer.eval(rows)
    err = _rel_max(got["logits"], want["logits"])
    exact = torch.equal(got["logits"], want["logits"])
    meta = pt.io.read_artifact_meta(d)["meta"]
    say(f"resnet inference ({card_name}): save_inference_model at buckets "
        f"{list(RESNET_INFER_BUCKETS)} {save_s:.3f} s, load_inference_model on {dev} "
        f"{load_s:.3f} s (layout {meta['layout']}, compute {meta['compute_dtype']}); "
        f"Predictor.run against trainer.eval at b={RESNET_INFER_BUCKETS[-1]}: logits max abs "
        f"{err:.3g} of max|logits| (tol {RESNET_INFER_TOL}), bit-equal {exact}")
    check(meta["layout"] == "NHWC" and meta["compute_dtype"] == "bfloat16",
          "resnet inference: the artifact lost its layout or compute dtype")
    check(err <= RESNET_INFER_TOL, "resnet inference: served logits differ from trainer.eval's")


# -- phase 11: Transformer-base and BERT-base ---------------------------------


def _seq2seq_feeds(rng, n, batch, seq):
    """bench_transformer's feeds (bench.py:445-449): src_ids, trg_ids and
    labels in [3, vocab), drawn in that order from one rng."""
    import numpy as np
    vocab = TRANSFORMER["src_vocab"]
    return [{"src_ids": rng.randint(3, vocab, (batch, seq)).astype(np.int32),
             "trg_ids": rng.randint(3, vocab, (batch, seq)).astype(np.int32),
             "labels": rng.randint(3, vocab, (batch, seq)).astype(np.int32)}
            for _ in range(n)]


def _bert_feeds(rng, n, batch, seq, masked, vocab):
    """bench_bert's feeds (bench.py:487-493)."""
    import numpy as np
    return [{"input_ids": rng.randint(0, vocab, (batch, seq)).astype(np.int32),
             "token_type_ids": rng.randint(0, 2, (batch, seq)).astype(np.int32),
             "mlm_positions": rng.randint(0, seq, (batch, masked)).astype(np.int32),
             "mlm_labels": rng.randint(0, vocab, (batch, masked, 1)).astype(np.int64),
             "nsp_label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _transformer_cfg(**kw):
    from paddle_tpu_torch.models import transformer
    return transformer.base_config(**TRANSFORMER, use_flash=True, fuse_qkv=True,
                                   fused_ce=True, **kw)


def _bert_cfg(**kw):
    from paddle_tpu_torch.models import bert
    return bert.base_config(**BERT_BASE, use_flash=True, fuse_qkv=True, fused_ce=True,
                            **kw)


def _seq2seq_trainer(cfg, dev, strategy=None):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer
    return pt.Trainer(pt.build(transformer.make_model(cfg)), pt.optimizer.Adam(TR_LR),
                      loss_name="loss", fetch_list=["loss"], place=dev, strategy=strategy)


def _bert_trainer(cfg, dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    return pt.Trainer(pt.build(bert.make_pretrain_model(cfg)),
                      pt.optimizer.AdamW(BERT_LR, weight_decay=BERT_WD),
                      loss_name="loss", fetch_list=["loss"], place=dev)


@contextlib.contextmanager
def record_kernel_calls(fa):
    """Record what the path hands the kernels: for the first call of each
    kind (forward or backward, at each shape, causal or not, with or
    without a key bias or segment ids), copies of its inputs and of the
    kernel's outputs, for :func:`check_recorded` to hold against the plain
    versions once the path's launch counts are read. The launches are the
    path's own: the wrappers count them as always."""
    import torch
    calls, seen = [], set()
    fwd, bwd = fa.flash_fwd_cuda, fa.flash_bwd_cuda

    def keep(kind, args, out):
        q, k, _, causal, bias, seg_q = args[:6]
        # a cross attention's queries and keys come from two projections,
        # a self-attention's from one
        cross = q.untyped_storage().data_ptr() != k.untyped_storage().data_ptr()
        key = (kind, tuple(q.shape), tuple(k.shape), bool(causal), bias is None,
               seg_q is None, cross)
        if key not in seen:
            seen.add(key)
            strided = not all(t.is_contiguous() for t in args[:3])
            calls.append((kind, strided, cross,
                          [a.clone() if torch.is_tensor(a) else a for a in args],
                          [o.clone() for o in out]))

    def fwd_recorded(q, k, v, causal, key_bias=None, seg_q=None, seg_k=None):
        out = fwd(q, k, v, causal, key_bias, seg_q, seg_k)
        keep("forward", (q, k, v, causal, key_bias, seg_q, seg_k), out)
        return out

    def bwd_recorded(*args):
        out = bwd(*args)
        keep("backward", args, out)
        return out

    fa.flash_fwd_cuda, fa.flash_bwd_cuda = fwd_recorded, bwd_recorded
    try:
        yield calls
    finally:
        fa.flash_fwd_cuda, fa.flash_bwd_cuda = fwd, bwd


def check_recorded(fa, calls, path):
    """Each recorded call's kernel outputs against the plain versions on
    the same inputs, element by element, as phases 3 and 3b hold them: the
    forward's o at TOL and lse at LSE_TOL, the backward's dq, dk and dv at
    BWD_TOL·max|plain|."""
    import torch
    check(calls, f"{path}: the path handed the kernels nothing")
    for kind, strided, cross, args, got in calls:
        q, k, _, causal, bias, seg_q = args[:6]
        dt = str(q.dtype).replace("torch.", "")
        if kind == "forward":  # allclose with atol = rtol = tol, as phase 3
            want = fa.flash_attention_reference(*args)
            errs = {n: ((a.float() - w.float()).abs().max().item(), tol,
                        ((a.float() - w.float()).abs() / (tol * (1 + w.float().abs())))
                        .max().item())
                    for n, a, w, tol in (("o", got[0], want[0], TOL[dt]),
                                         ("lse", got[1], want[1], LSE_TOL))}
            ok = all(r <= 1 for _, _, r in errs.values())
            detail = " ".join(f"max|{n}-plain|={e:.3g}, {r:.2f} of allclose's bound "
                              f"(atol=rtol={t})" for n, (e, t, r) in errs.items())
        else:
            want = (fa.flash_bwd_dq_reference(*args), *fa.flash_bwd_dkv_reference(*args))
            errs = {n: ((a.float() - w.float()).abs().max().item(),
                        BWD_TOL[dt] * w.float().abs().max().item())
                    for n, a, w in zip(("dq", "dk", "dv"), got, want)}
            ok = all(e <= t for e, t in errs.values())
            detail = " ".join(f"max|{n}-plain|={e:.3g} (tol {t:.3g})"
                              for n, (e, t) in errs.items())
        ok &= all(torch.isfinite(t.float()).all().item() for t in got)
        masked = "no key bias" if bias is None else (
            f"key bias masking {int((bias <= PAD_BIAS / 2).sum())} of {bias.numel()} keys")
        say(f"{path} {kind} as the path called it: [{q.shape[0]},{q.shape[1]},{q.shape[2]},"
            f"{k.shape[2]},{q.shape[3]}] {dt} {fa.ROUTES[(q.dtype, q.shape[3])]} "
            f"{'strided views' if strided else 'contiguous'}"
            f"{', cross attention' if cross else ''} causal={bool(causal)}, "
            f"{masked}, segments={seg_q is not None} | {detail} | "
            f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{path}: the {kind} kernel disagrees with its plain version on the "
              "path's own inputs")
        del want


@contextlib.contextmanager
def record_greedy_logp(module):
    """Record, on the host, the log-probabilities [rows, vocab] f32 from
    which each step of ``module``'s ``greedy_search`` chooses."""
    steps = []
    inner = module.greedy_search

    def search(step_fn, init_state, *args, **kw):
        def step(tokens, state):
            logp, state = step_fn(tokens, state)
            steps.append(logp.float().cpu())
            return logp, state
        return inner(step, init_state, *args, **kw)

    module.greedy_search = search
    try:
        yield steps
    finally:
        module.greedy_search = inner


def _eval_launches(fa, trainer, feed):
    """(outputs, launches) of one ``trainer.eval``."""
    _zero_launch_counts(fa)
    out = trainer.eval(feed)
    return out, _launch_counts(fa)


def phase_seq2seq(dev, seed, card_name):
    """Phase 11: (a) f32 parity, then the paths a user drives, each with
    the launch counts zeroed just before it and read just after it: (b)
    the bf16 Transformer-base step and its eval, (c) its params served by
    make_decoder, (d) the bf16 BERT-base step and its eval, (e) the
    long-context Transformer step; then (f) dropout on the card. Returns
    the launches of each kernel by path."""
    import gc
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa

    seq2seq_parity(dev, seed, card_name, "transformer")
    seq2seq_parity(dev, seed, card_name, "bert")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp, pt.amp_guard("bfloat16"):
        trainer, cfg, launches["transformer"] = seq2seq_timed(dev, seed, card_name,
                                                              "transformer")
        launches["transformer_served"] = transformer_served(dev, trainer, cfg, card_name,
                                                            tmp)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        trainer, _, launches["bert"] = seq2seq_timed(dev, seed, card_name, "bert")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        launches["transformer_long"] = transformer_long(dev, seed, card_name)
    gc.collect()
    torch.cuda.empty_cache()
    dropout_on_card(dev, seed, card_name)
    return launches


def seq2seq_parity(dev, seed, card_name, model):
    """(a) f32 at dropout 0, card (kernels) against CPU (plain versions)
    from the card's initial params: the losses of every step, the step-1
    grads of every param and one eval, which launches 12 forwards."""
    import numpy as np
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 11)
    if model == "transformer":
        cfg = _transformer_cfg(max_len=TR_PARITY_SEQ, dropout=0.0)
        make, steps, b, s = _seq2seq_trainer, TR_PARITY_STEPS, TR_PARITY_BATCH, TR_PARITY_SEQ
        feeds = _seq2seq_feeds(rng, steps, b, s)
        for f in feeds:  # padding: the key bias and the loss mask see it
            f["src_ids"][0, -s // 4:] = 0
            f["labels"][1, -s // 8:] = 0
        want_fwd = cfg.num_encoder_layers + cfg.num_decoder_layers
    else:
        cfg = _bert_cfg(dropout=0.0)
        make, steps, b, s = _bert_trainer, BERT_PARITY_STEPS, BERT_PARITY_BATCH, BERT_PARITY_SEQ
        feeds = _bert_feeds(rng, steps, b, s, BERT_MASKED, cfg.vocab_size)
        for f in feeds:
            f["input_ids"][0, -s // 4:] = 0
        want_fwd = cfg.num_layers
    t0 = time.perf_counter()
    card = make(cfg, dev).startup(seed, feeds[0])
    host = make(cfg, "cpu").startup(
        seed, feeds[0], params={k: v.detach().cpu() for k, v in card.scope.params.items()})
    rel_loss, grad_err, launches = [], {}, []
    for i, f in enumerate(feeds):
        _zero_launch_counts(fa)
        lc = float(card.step(f)["loss"])
        launches.append(_launch_counts(fa))
        lh = float(host.step(f)["loss"])
        rel_loss.append(abs(lc - lh) / abs(lh))
        if i == 0:
            for name, p in card.scope.params.items():
                grad_err[name] = _rel_l2(p.grad.cpu(), host.scope.params[name].grad)
    out, eval_launches = _eval_launches(fa, card, feeds[0])
    eval_rel = abs(float(out["loss"]) - float(host.eval(feeds[0])["loss"])) / abs(
        float(out["loss"]))
    worst = max(grad_err, key=grad_err.get)
    say(f"{model} parity f32 ({card_name}): b={b} s={s}, {steps} "
        f"{type(card.optimizer).__name__} steps, {len(grad_err)} params: loss rel card - cpu "
        f"per step {[f'{r:.3g}' for r in rel_loss]} (tol {TRAIN_LOSS_TOL}), step-1 grads "
        f"rel L2 worst {grad_err[worst]:.3g} ({worst}; tol {TRAIN_GRAD_TOL}), eval loss rel "
        f"{eval_rel:.3g}; launches per step {launches[0]}, eval {eval_launches} (want "
        f"{want_fwd} forwards); {time.perf_counter() - t0:.1f} s")
    check(max(rel_loss) <= TRAIN_LOSS_TOL and eval_rel <= TRAIN_LOSS_TOL,
          f"{model} parity: losses differ card against CPU")
    check(grad_err[worst] <= TRAIN_GRAD_TOL, f"{model} parity: grads differ card against CPU")
    check(all(n == want_fwd for step in launches for n in step.values()),
          f"{model} parity: launches per step {launches}")
    check(eval_launches == {"flash_fwd": want_fwd, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
          f"{model} parity: eval launches {eval_launches}")


def seq2seq_timed(dev, seed, card_name, model):
    """(b)/(d) The bf16 training path at bench.py's config: 3 warm-up and 10
    timed steps (dropout 0.1: the dense attention, no flash launch), then
    ``trainer.eval`` (12 flash forwards) held against the same eval
    through the plain versions on the card, then a profiled step. Returns
    (trainer, cfg, launches during the path)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core import flops
    from paddle_tpu_torch.ops import flash_attention as fa

    if model == "transformer":
        cfg = _transformer_cfg(max_len=TR_SEQ, dropout=0.1, dtype="bfloat16")
        b, s = TR_BATCH, TR_SEQ
        feeds = _seq2seq_feeds(np.random.RandomState(0), SEQ_FEEDS, b, s)
        trainer = _seq2seq_trainer(cfg, dev)
        tflop = flops.transformer_train_flops(b, s, cfg) / 1e12
        want_fwd = cfg.num_encoder_layers + cfg.num_decoder_layers
    else:
        cfg = _bert_cfg(dtype="bfloat16")
        b, s = BERT_BATCH, BERT_SEQ
        feeds = _bert_feeds(np.random.RandomState(0), SEQ_FEEDS, b, s, BERT_MASKED,
                            cfg.vocab_size)
        trainer = _bert_trainer(cfg, dev)
        tflop = flops.bert_train_flops(b, s, BERT_MASKED, cfg) / 1e12
        want_fwd = cfg.num_layers
    t0 = time.perf_counter()
    trainer.startup(seed, feeds[0])
    startup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.scope.params.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(fa)
    # ---- the main path, as a user drives it
    losses = []
    for i in range(SEQ_WARMUP + SEQ_STEPS):
        if i == SEQ_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(trainer.step(feeds[i % SEQ_FEEDS])["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = _launch_counts(fa)
    with record_kernel_calls(fa) as calls:
        out, eval_launches = _eval_launches(fa, trainer, feeds[0])
    # ---- end of the main path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    ms = wall / SEQ_STEPS * 1e3
    READINGS[model] = {"ms": ms, "peak_gb": peak_gb}
    say(f"{model} bf16 ({card_name}): b={b} s={s}, dropout {cfg.dropout}, "
        f"{type(trainer.optimizer).__name__}, {n_params} params, startup {startup_s:.2f} s; "
        f"{SEQ_WARMUP} warm-up + {SEQ_STEPS} timed steps: {b * s / ms * 1e3:.1f} tokens/s, "
        f"{ms:.2f} ms per step ({tflop:.3f} TFLOP a step by core/flops.py, "
        f"{tflop / ms * 1e3:.1f} TFLOP/s), peak memory {peak_gb:.3f} GB; launches in "
        f"training {train_launches} (want 0: dropout takes the dense path), at eval "
        f"{eval_launches} (want {want_fwd} forwards)")
    say(f"{model} losses per step: " + " ".join(f"{x:.5f}" for x in losses))
    check(all(np.isfinite(losses)), f"{model}: a loss is not finite")
    check(all(n == 0 for n in train_launches.values()),
          f"{model}: a flash kernel launched in training at dropout 0.1")
    check(eval_launches == {"flash_fwd": want_fwd, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
          f"{model}: eval launches {eval_launches}")
    before = _launch_counts(fa)
    with plain_versions_on_card(fa):
        plain = trainer.eval(feeds[0])
    check(_launch_counts(fa) == before, f"{model}: the plain eval launched a kernel")
    rel = abs(float(out["loss"]) - float(plain["loss"])) / abs(float(plain["loss"]))
    say(f"{model} eval, kernels against the plain versions on the card: loss "
        f"{float(out['loss']):.5f} vs {float(plain['loss']):.5f}, rel {rel:.3g} (tol "
        f"{TRAIN_BF16_LOSS_TOL})")
    check(rel <= TRAIN_BF16_LOSS_TOL, f"{model}: eval through the kernels differs from the "
          "plain versions'")
    check_recorded(fa, calls, f"{model} eval")
    del calls
    _seq2seq_breakdown(model, trainer, feeds[0], card_name)
    return trainer, cfg, {k: train_launches[k] + eval_launches[k] for k in train_launches}


def _seq2seq_breakdown(model, trainer, feed, card_name):
    """One profiled step: device time, busy share, device operations and
    the top ops."""
    wall_ms, device_us, n_ops, rows, _, _ = _profile_step(trainer, feed)
    if device_us == 0:
        say(f"{model} breakdown: not measured (the profiler saw no device time)")
        return rows
    READINGS.setdefault(model, {}).update(device_ms=device_us / 1e3, ops=n_ops)
    say(f"{model} breakdown ({card_name}), one profiled step: {device_us / 1e3:.2f} ms of "
        f"device time in a {wall_ms:.2f} ms step, device busy "
        f"{100 * device_us / 1e3 / wall_ms:.1f}%, {n_ops} device operations")
    for us, calls, key in rows[:SEQ_TOP_OPS]:
        say(f"  {model} top op {us / 1e3:8.3f} ms {100 * us / device_us:5.1f}% "
            f"{calls:5d} calls  {key[:120]}")
    return rows


def transformer_served(dev, trainer, cfg, card_name, tmp):
    """(c) The (b) trainer's params served: ``save_inference_model`` of
    ``make_decoder(cfg, max_len=64)`` greedy and at beam SEQ_SERVE_BEAM
    with length penalty SEQ_SERVE_ALPHA, ``load_inference_model`` on the
    card (its warm-up captures each bucket's decoder step), 8 padded
    source rows of 256 decoded SEQ_SERVE_CALLS times each way: 6 flash
    forwards a call (the encoder's, under the key bias), what the path
    hands the kernel held against the plain version, and each call's
    ``max_len`` steps replays of one captured CUDA graph. Then, outside the
    main path: the captured ids (and beam scores) bit-equal to the eager
    loop's on the card; ms per served call eager against captured, in
    turns; a profiled captured call's device time, busy share and device
    operations; the cross attention's K/V projections' device time a
    step; the eager loop's log-probabilities against the plain CPU run's
    in f32 at SERVE_LOGP_TOL at every step whose inputs agree (so a row's
    ids may part from the CPU's only at a near-tie); a second params set
    (the trainer after two more steps) through the same program giving
    its own eager ids; and one captured call under
    ``torch.cuda.set_sync_debug_mode("error")``. Returns the launches
    during the served calls."""
    import dataclasses
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import flash_attention as fa

    t_part = time.perf_counter()
    rng = np.random.RandomState(7)
    src = rng.randint(3, cfg.src_vocab, (SEQ_SERVE_ROWS, SEQ_SERVE_SRC)).astype(np.int32)
    for i in range(SEQ_SERVE_ROWS):  # ragged rows, padded with 0
        src[i, SEQ_SERVE_SRC - 16 * i:] = 0
    feed = {"src_ids": src}
    progs = {"greedy": pt.build(transformer.make_decoder(cfg, max_len=SEQ_SERVE_MAX_LEN)),
             f"beam {SEQ_SERVE_BEAM}": pt.build(transformer.make_decoder(
                 cfg, max_len=SEQ_SERVE_MAX_LEN, beam_size=SEQ_SERVE_BEAM,
                 length_penalty_alpha=SEQ_SERVE_ALPHA))}
    preds, io_s = {}, {}
    for name, prog in progs.items():
        d = os.path.join(tmp, f"transformer_decoder_{name.replace(' ', '')}")
        t0 = time.perf_counter()
        pt.io.save_inference_model(d, prog, trainer.scope.params, {}, feed)
        t1 = time.perf_counter()
        preds[name] = pt.io.load_inference_model(d, device=dev)
        io_s[name] = (t1 - t0, time.perf_counter() - t1)
    torch.cuda.synchronize()
    _zero_launch_counts(fa)
    # ---- the main path, as a user drives it
    served, wall = {}, {}
    with record_kernel_calls(fa) as calls:
        for name, pred in preds.items():
            t0 = time.perf_counter()
            for _ in range(SEQ_SERVE_CALLS):
                served[name] = pred.run(feed)
            torch.cuda.synchronize()
            wall[name] = (time.perf_counter() - t0) / SEQ_SERVE_CALLS * 1e3
    launches = _launch_counts(fa)
    # ---- end of the main path
    check_recorded(fa, calls, "transformer served")
    del calls
    check(launches == {"flash_fwd": cfg.num_encoder_layers * SEQ_SERVE_CALLS * len(preds),
                       "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
          f"transformer served: launches {launches}")
    states = {n: p.program.program.fn._states for n, p in preds.items()}
    for name, st in states.items():
        dec = next(iter(st.values()))
        check(len(st) == 1 and dec.captures == 1 and dec.replays == SEQ_SERVE_MAX_LEN * (
            SEQ_SERVE_CALLS + 1), f"transformer served {name}: {len(st)} states, "
            f"{dec.captures} captures, {dec.replays} replays (want 1 capture and "
            f"{SEQ_SERVE_MAX_LEN} replays a call, the loader's warm-up among them)")
    out_g = served["greedy"]["ids"]
    check(tuple(out_g.shape) == (SEQ_SERVE_ROWS, SEQ_SERVE_MAX_LEN)
          and int(out_g.min()) >= 0 and int(out_g.max()) < cfg.trg_vocab,
          "transformer served: ids out of shape or range")
    # the captured decode against the eager loop, bit for bit, and timed in turns
    eager, lines = {}, []
    for name, pred in preds.items():
        with transformer._eager_decode():
            eager[name] = pred.run(feed)
        same = _outputs_equal(served[name], eager[name])
        runs = {"eager": lambda: _eager_call(pred, feed), "captured": lambda: pred.run(feed)}
        times = {n: [] for n in runs}
        for turn in ("eager", "captured", "captured", "eager"):
            times[turn].append(_host_ms(runs[turn], n=1))
        wall_p, dev_us, n_ops, _ = _profile_dispatch(lambda: pred.run(feed))
        ms = {n: sum(v) / len(v) for n, v in times.items()}
        dec = next(iter(states[name].values()))
        lines.append(
            f"{name}: ids{' and scores' if 'scores' in eager[name] else ''} bit-equal to the "
            f"eager loop {same}; ms a call eager {[round(t, 2) for t in times['eager']]}, "
            f"captured {[round(t, 2) for t in times['captured']]} ({ms['eager'] / ms['captured']:.1f}"
            f"x; {SEQ_SERVE_ROWS * SEQ_SERVE_MAX_LEN / ms['captured'] * 1e3:.1f} decoded "
            f"tokens/s); a profiled captured call "
            + (f"{dev_us / 1e3:.2f} device ms, busy {100 * dev_us / 1e3 / wall_p:.1f}% of "
               f"{wall_p:.2f} ms, {n_ops} device operations ({n_ops / SEQ_SERVE_MAX_LEN:.0f} a "
               f"step with the encoder's spread over them)" if dev_us else
               "busy: not measured (the profiler saw no device time)")
            + f"; cache {dec.cache_bytes()} bytes")
        READINGS[f"transformer_served_{name}"] = {"eager_ms": ms["eager"],
                                                  "captured_ms": ms["captured"],
                                                  "device_ms": dev_us / 1e3, "ops": n_ops}
        check(same, f"transformer served {name}: the captured decode differs from the eager "
              "loop's on the card")
    kv_ms = _cross_kv_ms(trainer, cfg, src, dev)
    say(f"transformer served ({card_name}): make_decoder(max_len={SEQ_SERVE_MAX_LEN}) "
        f"greedy and beam {SEQ_SERVE_BEAM} (alpha {SEQ_SERVE_ALPHA}) exported and loaded on "
        f"{dev} in {[(round(a, 3), round(b, 3)) for a, b in io_s.values()]} s; "
        f"{SEQ_SERVE_ROWS} rows of {SEQ_SERVE_SRC} source tokens (lengths "
        f"{[int((r != 0).sum()) for r in src]}), {SEQ_SERVE_CALLS} calls each: "
        f"{[round(w, 2) for w in wall.values()]} ms per call; launches {launches} (want "
        f"{cfg.num_encoder_layers} forwards a call); " + "; ".join(lines)
        + f"; the cross attention's K/V projections of the source, recomputed every step as "
        f"the JAX scan does: {kv_ms:.4f} device ms a step (all {cfg.num_decoder_layers} "
        "layers, greedy rows)")
    # the eager loop's log-probabilities against the plain CPU run in f32
    params = {k: v.detach() for k, v in trainer.scope.params.items()}
    prog = progs["greedy"]
    with torch.no_grad(), transformer._eager_decode(), \
            record_greedy_logp(transformer) as logp_card:
        direct = prog.apply(params, {}, src_ids=src, place=dev)[0]["ids"]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    with pt.amp_guard("float32"), torch.no_grad(), transformer._eager_decode(), \
            record_greedy_logp(transformer) as logp_host:
        host = pt.build(transformer.make_decoder(cfg32, max_len=SEQ_SERVE_MAX_LEN)).apply(
            {k: v.float().cpu() for k, v in params.items()}, {}, src_ids=src,
            place="cpu")[0]["ids"]
    host_s = time.perf_counter() - t0
    got, want = out_g.cpu().numpy(), host.numpy()
    differ = got != want
    first = [int(np.argmax(row)) if row.any() else None for row in differ]
    # per row: the largest |logp card - logp cpu| over the steps whose
    # inputs agree, and at a first differing step the CPU's margin between
    # its id and the card's
    logp_err, margin = [], []
    for r, t in enumerate(first):
        last = SEQ_SERVE_MAX_LEN - 1 if t is None else t
        logp_err.append(max((logp_card[i][r] - logp_host[i][r]).abs().max().item()
                            for i in range(last + 1)))
        margin.append(None if t is None else
                      (logp_host[t][r, want[r, t]] - logp_host[t][r, got[r, t]]).item())
    # a second params set through the same program: its own ids, not the first's
    src_dev = torch.from_numpy(src).to(dev)
    prog.apply(params, {}, src_ids=src_dev, place=dev)
    for f in _seq2seq_feeds(np.random.RandomState(11), 2, TR_BATCH, TR_SEQ):
        trainer.step(f)
    params2 = {k: v.detach().clone() for k, v in trainer.scope.params.items()}
    second = prog.apply(params2, {}, src_ids=src_dev, place=dev)[0]["ids"]
    with transformer._eager_decode():
        second_eager = prog.apply(params2, {}, src_ids=src_dev, place=dev)[0]["ids"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        synced = None
        prog.apply(params2, {}, src_ids=src_dev, place=dev)
    except RuntimeError as e:
        synced = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    say(f"transformer served ({card_name}): served greedy ids equal the eager loop run "
        f"directly on the card: {bool(torch.equal(out_g, direct))}; against the plain CPU "
        f"run in f32 ({host_s:.1f} s): {int((~differ).all(axis=1).sum())} of "
        f"{SEQ_SERVE_ROWS} rows equal, first differing step per row {first}, CPU margin "
        f"there {[None if m is None else f'{m:.3g}' for m in margin]}; max|logp card - "
        f"cpu| per row over the steps whose inputs agree "
        f"{[f'{e:.3g}' for e in logp_err]} (tol {SERVE_LOGP_TOL}); a second params set (two "
        f"more steps) through the same program: its eager ids {bool(torch.equal(second, second_eager))}"
        f", {int((second != direct).sum())} of {second.numel()} ids differ from the first "
        f"set's; a captured call under set_sync_debug_mode('error'): "
        f"{'no host sync' if synced is None else synced}; {time.perf_counter() - t_part:.1f} s")
    check(torch.equal(out_g, direct), "transformer served: the artifact's ids differ from "
          "the eager loop's on the card")
    check(len(logp_card) == len(logp_host) == SEQ_SERVE_MAX_LEN,
          "transformer served: a greedy step's log-probabilities were not recorded")
    check(max(logp_err) <= SERVE_LOGP_TOL, "transformer served: the log-probabilities "
          "differ from the plain CPU run's")
    check(all(m is None or m <= 2 * SERVE_LOGP_TOL for m in margin),
          "transformer served: the ids part from the plain CPU run's other than at a near-tie")
    check(torch.equal(second, second_eager), "transformer served: a second params set gave "
          "other ids than its eager loop (a stale weight read?)")
    check(synced is None, f"transformer served: a captured call synchronised: {synced}")
    return launches


def _eager_call(pred, feed):
    from paddle_tpu_torch.models import transformer
    with transformer._eager_decode():
        return pred.run(feed)


def _cross_kv_ms(trainer, cfg, src, dev):
    """Device ms of the decoder's cross-attention K/V projections of the
    encoder's output for one step (every layer, the greedy call's rows),
    which the JAX scan body recomputes every step."""
    import torch
    from paddle_tpu_torch.framework import compute_dtype
    params = trainer.scope.params
    names = sorted(n for n in params if n.startswith("decoder/") and n.endswith("/kv_proj/w"))
    check(len(names) == cfg.num_decoder_layers,
          f"transformer served: cross-attention kv_proj weights {names}")
    cd = compute_dtype()
    enc = torch.randn(src.shape[0], src.shape[1], cfg.d_model, device=dev).to(cd)
    ws = [params[n].detach().to(cd).reshape(cfg.d_model, -1) for n in names]
    bs = [params[n[:-1] + "b"].detach().to(cd).reshape(-1) for n in names]
    return device_ms(lambda: [torch.matmul(enc, w) + b for w, b in zip(ws, bs)], 20)


def transformer_long(dev, seed, card_name):
    """(e) bench_transformer_long: bf16 at b=4, s=4096, dropout 0; 2 warm-up
    and 5 timed steps, 12 launches of each kernel a step, all on the
    tensor-core route (a profiled step), what the step hands the kernels
    held against the plain versions, and the first step's loss and grads
    against the same step through the plain versions on the card. Two bf16
    runs' grads differ by their roundings, so each param's grad is held
    against the same step in f32 (plain versions): the kernels' run may lie
    no farther from it than LONG_GRAD_RATIO times the plain run does."""
    import dataclasses
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import flops
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = _transformer_cfg(max_len=LONG_SEQ, dropout=0.0, dtype="bfloat16")
    feeds = _seq2seq_feeds(np.random.RandomState(0), SEQ_FEEDS, LONG_BATCH, LONG_SEQ)
    trainer = _seq2seq_trainer(cfg, dev).startup(seed, feeds[0])
    p0 = {k: v.detach().clone() for k, v in trainer.scope.params.items()}
    n_steps = LONG_WARMUP + LONG_STEPS
    per_step = cfg.num_encoder_layers + cfg.num_decoder_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(fa)
    # ---- the main path, as a user drives it
    losses = []
    with record_kernel_calls(fa) as calls:
        for i in range(n_steps):
            if i == LONG_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(trainer.step(feeds[i % SEQ_FEEDS])["loss"])
            if i == 0:  # the first step's grads, on the host
                g1 = {k: p.grad.detach().cpu() for k, p in trainer.scope.params.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launch_counts(fa)
    # ---- end of the main path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    ms = wall / LONG_STEPS * 1e3
    tflop = flops.transformer_train_flops(LONG_BATCH, LONG_SEQ, cfg) / 1e12
    say(f"transformer_long bf16 ({card_name}): b={LONG_BATCH} s={LONG_SEQ}, dropout 0, "
        f"{LONG_WARMUP} warm-up + {LONG_STEPS} timed steps: "
        f"{LONG_BATCH * LONG_SEQ / ms * 1e3:.1f} tokens/s, {ms:.2f} ms per step "
        f"({tflop:.3f} TFLOP a step, {tflop / ms * 1e3:.1f} TFLOP/s), peak memory "
        f"{peak_gb:.3f} GB (the dense cross-attention keeps f32 probabilities), launches "
        f"{launches} (want {per_step * n_steps} each)")
    say("transformer_long losses per step: " + " ".join(f"{x:.5f}" for x in losses))
    check(all(np.isfinite(losses)), "transformer_long: a loss is not finite")
    check(all(n == per_step * n_steps for n in launches.values()),
          f"transformer_long: launches {launches}, want {per_step} per step")
    rows = _seq2seq_breakdown("transformer_long", trainer, feeds[0], card_name)
    tensor_core = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")
    cuda_core = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    us = {k: sum(t for t, _, key in rows if k in key) for k in tensor_core + cuda_core}
    say("transformer_long flash kernels in the profiled step: "
        + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in us.items()))
    check(all(us[k] > 0 for k in tensor_core),
          "transformer_long: the profiled step shows no device time of a tensor-core kernel")
    check(all(us[k] == 0 for k in cuda_core),
          "transformer_long: the bf16 step ran a kernel of the CUDA-core route")
    del trainer
    torch.cuda.empty_cache()
    check_recorded(fa, calls, "transformer_long step 1")
    del calls
    torch.cuda.empty_cache()
    plain = _seq2seq_trainer(cfg, dev).startup(seed, feeds[0], params=p0)
    before = _launch_counts(fa)
    with plain_versions_on_card(fa):
        plain_loss = float(plain.step(feeds[0])["loss"])
    g_plain = {k: p.grad.detach().cpu() for k, p in plain.scope.params.items()}
    del plain
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with pt.amp_guard("float32"), plain_versions_on_card(fa):
        ref = _seq2seq_trainer(cfg32, dev).startup(
            seed, feeds[0], params={k: v.float() for k, v in p0.items()})
        del p0
        ref_loss = float(ref.step(feeds[0])["loss"])
    g32 = {k: p.grad.detach().cpu() for k, p in ref.scope.params.items()}
    del ref
    torch.cuda.empty_cache()
    check(_launch_counts(fa) == before, "transformer_long: a plain run launched a kernel")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    to_plain = {k: _rel_l2(g1[k], g_plain[k]) for k in g32}
    err_kernel = {k: _rel_l2(g1[k], g32[k]) for k in g32}
    err_plain = {k: _rel_l2(g_plain[k], g32[k]) for k in g32}
    ratio = {k: err_kernel[k] / max(err_plain[k], 1e-30) for k in g32}
    worst = max(ratio, key=ratio.get)

    def median(d):
        return sorted(d.values())[len(d) // 2]

    say(f"transformer_long step 1, kernels against the plain versions on the card: loss "
        f"{losses[0]:.5f} vs {plain_loss:.5f}, rel {rel:.3g} (tol {TRAIN_BF16_LOSS_TOL}), "
        f"f32 {ref_loss:.5f}; grads of {len(g32)} params, rel L2 kernels to plain worst "
        f"{max(to_plain.values()):.3g} median {median(to_plain):.3g}; to the f32 step: "
        f"kernels worst {max(err_kernel.values()):.3g} median {median(err_kernel):.3g}, "
        f"plain worst {max(err_plain.values()):.3g} median {median(err_plain):.3g}; kernels' "
        f"over plain's, worst {ratio[worst]:.3g} ({worst}: {err_kernel[worst]:.3g} against "
        f"{err_plain[worst]:.3g}), median {median(ratio):.3g} (tol {LONG_GRAD_RATIO})")
    check(rel <= TRAIN_BF16_LOSS_TOL, "transformer_long: the kernels' loss differs from the "
          "plain versions'")
    check(ratio[worst] <= LONG_GRAD_RATIO, "transformer_long: the kernels' step-1 grads lie "
          "farther from the f32 step's than the plain versions' do")
    return launches


def dropout_on_card(dev, seed, card_name):
    """(f) The keep rate of a 10^7-element mask, the same program rng giving
    the same bits, and two GPT-base layers at dropout 0.1 trained one step
    with and without remat from the same params: the recompute draws the
    forward's masks, so the grads agree."""
    import dataclasses
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.models import gpt

    x = torch.ones(DROPOUT_N, device=dev)
    kept = int((L.dropout(x, DROPOUT_P, is_test=False, seed=seed) != 0).sum())
    sigma = (DROPOUT_N * DROPOUT_P * (1 - DROPOUT_P)) ** 0.5
    z = (kept - DROPOUT_N * (1 - DROPOUT_P)) / sigma
    prog = pt.build(lambda x: {"y": L.dropout(x, DROPOUT_P)})
    a = prog.apply({}, {}, x=x, training=True, rng=seed + 5, place=dev)[0]["y"]
    b = prog.apply({}, {}, x=x, training=True, rng=seed + 5, place=dev)[0]["y"]
    c = prog.apply({}, {}, x=x, training=True, rng=seed + 6, place=dev)[0]["y"]
    cfg = gpt.base_config(**dict(GPT_BASE, num_layers=2), max_len=256, dropout=DROPOUT_P)
    feed = _train_feeds(np.random.RandomState(seed), 1, 2, 256, cfg.vocab_size)[0]
    grads, losses, p0 = {}, {}, None
    for remat in (False, True):
        trainer = _trainer(dataclasses.replace(cfg, remat=remat), dev)
        trainer.startup(seed, sample_feed=feed, params=p0)
        p0 = p0 or {k: v.detach().clone() for k, v in trainer.scope.params.items()}
        losses[remat] = float(trainer.step(feed)["loss"])
        grads[remat] = {k: p.grad.detach().clone() for k, p in trainer.scope.params.items()}
        del trainer
    err = max(_rel_l2(grads[True][k], grads[False][k]) for k in grads[False])
    same = all(torch.equal(grads[True][k], grads[False][k]) for k in grads[False])
    say(f"dropout on the card ({card_name}): p={DROPOUT_P} over {DROPOUT_N} elements kept "
        f"{kept} ({z:+.2f} sigma); the same program rng gives the same bits "
        f"{bool(torch.equal(a, b))}, another rng other bits {not torch.equal(a, c)}; two "
        f"GPT-base layers at dropout {DROPOUT_P}, one step with and without remat: losses "
        f"{losses[False]:.6f} / {losses[True]:.6f}, grads rel L2 up to {err:.3g} (tol "
        f"{SEQ_REMAT_TOL}), bit-equal {same}")
    check(abs(z) <= 4, "dropout: the keep rate is off by more than 4 sigma")
    check(torch.equal(a, b) and not torch.equal(a, c),
          "dropout: the masks do not follow the program rng")
    check(err <= SEQ_REMAT_TOL, "dropout: a remat recompute drew other masks")


# -- the run ------------------------------------------------------------------


# -- phase 12: captured steps (Trainer.run_steps, fit(steps_per_dispatch=K)) ---


def _params_of(trainer):
    return {k: p.detach().clone() for k, p in trainer.scope.params.items()}


def _state_of(trainer):
    """Every leaf of the training state (params, optimizer, program and
    loss-scale state), cloned, by path."""
    out = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}", v)
        else:
            out[prefix] = tree.detach().clone()

    walk("", trainer._state_trees())
    return out


def _bits_equal(a, b):
    """Two tensors bit for bit, a NaN (a skipped step's loss) equal to a NaN."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))
        and torch.equal(torch.isnan(a), torch.isnan(b)))


def _states_differ(a, b):
    """The leaves of two state snapshots that are not bit-equal."""
    return [k for k in a if not _bits_equal(a[k], b[k])]


def _profile_dispatch(fn):
    """``fn`` (a dispatch) under torch.profiler: (wall ms, device us,
    device operations, {kernel name: (calls, device us)}). Record_function
    ranges, which the profiler shows again on the device's timeline, are
    left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us, n_ops, kernels = 0.0, 0, {}
    for evt in prof.key_averages():
        if evt.key.startswith(("trainer.", "DeviceFeeder.")) or \
                evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += evt.self_device_time_total
        n_ops += evt.count
        kernels[evt.key] = (evt.count, evt.self_device_time_total)
    return wall_ms, device_us, n_ops, kernels


def _eager_against_captured(eager, fused, staged, stacked, n_dispatches, k):
    """ms per step of ``eager`` (``step()`` on feeds already on the card)
    and of ``fused`` (``run_steps`` on a stacked feed on the card), each
    over ``n_dispatches`` dispatches of ``k`` steps, in turns (eager,
    captured, captured, eager) after one warm dispatch each; with each
    one's peak device memory over its turns. Returns ({name: [ms per
    step of each turn]}, {name: peak GB})."""
    import torch

    def run_eager():
        for i in range(n_dispatches * k):
            eager.step(staged[i % len(staged)])

    def run_fused():
        for _ in range(n_dispatches):
            fused.run_steps(stacked)

    runs = {"eager": run_eager, "captured": run_fused}
    for name in runs:
        eager.step(staged[0]) if name == "eager" else fused.run_steps(stacked)
    times, peaks = {n: [] for n in runs}, {n: 0.0 for n in runs}
    for name in ("eager", "captured", "captured", "eager"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / (n_dispatches * k) * 1e3)
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() / 1e9)
    return times, peaks


def _busy_against(eager, fused, staged, stacked, into=None):
    """The device's busy share, device ms and operations a step of K
    profiled eager steps and of one profiled dispatch of K, as a clause of
    the timing line; ``into`` (a dict) takes {"eager"/"captured": (device
    ms, operations) a step}."""
    k = len(staged)
    parts = []
    for name, fn in (("eager", lambda: [eager.step(f) for f in staged]),
                     ("captured", lambda: fused.run_steps(stacked))):
        wall, dev_us, n_ops, _ = _profile_dispatch(fn)
        if into is not None:
            into[name] = (dev_us / 1e3 / k, n_ops / k)
        parts.append(f"{name} busy {100 * dev_us / 1e3 / wall:.1f}% ({dev_us / 1e3 / k:.2f} "
                     f"ms, {n_ops / k:.0f} operations a step)" if dev_us else
                     f"{name} busy: not measured")
    return f"; profiled {k} steps: " + ", ".join(parts)


def _timing_line(path, times, peaks, unit, per_step, card_name, k, extra=""):
    """One line of eager against captured times, and the means."""
    import numpy as np
    ms = {n: float(np.mean(v)) for n, v in times.items()}
    say(f"captured steps timing ({card_name}): {path}: eager "
        f"{[round(t, 4) for t in times['eager']]} ms per step (mean {ms['eager']:.4f}, "
        f"{per_step / ms['eager'] * 1e3:.1f} {unit}), captured K={k} "
        f"{[round(t, 4) for t in times['captured']]} ms per step (mean {ms['captured']:.4f}, "
        f"{per_step / ms['captured'] * 1e3:.1f} {unit}), {ms['eager'] / ms['captured']:.2f}x; "
        f"peak memory eager {peaks['eager']:.3f} GB, captured {peaks['captured']:.3f} GB"
        + extra)
    return ms


def fused_mnist(dev, seed, card_name, tmp):
    """(a) MNIST MLP as bench.py bench_dispatch_overhead (f32, batch 128,
    SGD(0.01), K=16): run_steps from a saved state against 16 step()
    calls from it, bit for bit (losses and params), also on a trainer
    that captured its step before the load; fit(steps_per_dispatch=16)
    with and without the prefetch against fit K=1; then eager against
    captured over FUSED_MNIST_DISPATCHES dispatches."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import data
    from paddle_tpu_torch import io as pio

    k = FUSED_MNIST_K
    feeds = _mnist_feeds()
    chunk = [feeds[i % len(feeds)] for i in range(k)]
    opt = lambda: pt.optimizer.SGD(MNIST_LR)  # noqa: E731
    saved = _mnist_trainer(dev, opt()).startup(seed, feeds[0])
    for f in feeds[:3]:
        saved.step(f)
    ckpt = os.path.join(tmp, "mnist_fused")
    pio.save_trainer(ckpt, saved)
    eager = _mnist_trainer(dev, opt()).startup(seed + 1, feeds[0])
    pio.load_trainer(ckpt, eager)
    losses_eager = torch.stack([eager.step(f)["loss"] for f in chunk])
    fused = _mnist_trainer(dev, opt()).startup(seed + 1, feeds[0])
    fused.run_steps(pt.data.stack_batches(chunk))  # a graph of the state the load replaces
    stale = fused._fused
    pio.load_trainer(ckpt, fused)
    outs = fused.run_steps(pt.data.stack_batches(chunk))
    differ = _states_differ(_state_of(eager), _state_of(fused))
    same_losses = _bits_equal(losses_eager, outs["loss"])
    say(f"captured mnist (a): run_steps(K={k}) from a saved state (global step "
        f"{saved.global_step}) against {k} step() calls from it: losses bit-equal "
        f"{same_losses}, state leaves differing {differ}; the trainer had captured "
        f"its step before the load: captured anew {fused._fused is not stale} "
        f"({fused._fused.captures} capture)")
    check(same_losses and not differ, "captured mnist: run_steps differs from step()")
    check(fused._fused is not stale, "captured mnist: load_trainer kept the old graph")

    reader = data.batch(data.shuffle(data.datasets.mnist("train"), 512, seed=0),
                        MNIST_FIT_BATCH)
    sample = data.DataFeeder(["image", "label"]).feed(next(iter(reader())))
    runs = {}
    for kk, prefetch in ((1, False), (k, True), (k, False)):
        tr = _mnist_trainer(dev, pt.optimizer.Adam(MNIST_FIT_LR)).startup(seed, sample)
        losses, dispatches = [], []
        pt.fit(tr, reader, 1, ["image", "label"], prefetch=prefetch, steps_per_dispatch=kk,
               event_handler=lambda e: (losses.append(e.metrics["loss"].reshape(-1)),
                                        dispatches.append(e.num_steps))
               if e.kind == "end_step" else None)
        runs[(kk, prefetch)] = (torch.cat(losses), _state_of(tr), dispatches,
                                tr.pipeline_report())
    base = runs[(1, False)]
    for key, (losses, state, dispatches, report) in runs.items():
        same = _bits_equal(losses, base[0]) and not _states_differ(state, base[1])
        say(f"captured mnist (a): fit(steps_per_dispatch={key[0]}, prefetch={key[1]}) "
            f"over an epoch ({len(losses)} steps in {len(dispatches)} dispatches "
            f"{sorted(set(dispatches))}): losses and state bit-equal to K=1: {same}; "
            f"pipeline {({n: report[n] for n in ('batches', 'chunks', 'h2d_mbps', 'bottleneck')})}")
        check(same, f"captured mnist: fit K={key[0]} prefetch={key[1]} differs from K=1")
    check(max(runs[(k, True)][2]) == k, "captured mnist: fit never ran a fused dispatch")

    # the timed path: bench_dispatch_overhead's config on staged feeds
    trainers = [_mnist_trainer(dev, opt()).startup(seed, feeds[0]) for _ in range(2)]
    for tr in trainers:
        tr.fetch_list = ["loss"]
    staged = [trainers[0]._put_feed(f) for f in feeds]
    stacked = trainers[1]._put_feed(pt.data.stack_batches(chunk))
    times, peaks = _eager_against_captured(trainers[0], trainers[1], staged, stacked,
                                           FUSED_MNIST_DISPATCHES, k)
    ms = _timing_line(f"MNIST MLP f32 b={MNIST_BATCH} SGD({MNIST_LR}), "
                      f"{FUSED_MNIST_DISPATCHES} dispatches a turn", times, peaks,
                      "samples/s", MNIST_BATCH, card_name, k)
    wall, dev_us, n_ops, _ = _profile_dispatch(lambda: trainers[1].run_steps(stacked))
    busy = (f"device busy {100 * dev_us / 1e3 / wall:.1f}% of a profiled dispatch of "
            f"{wall:.3f} ms ({dev_us / 1e3 / k:.4f} ms of device time and {n_ops / k:.1f} "
            f"device operations a step)" if dev_us else "device busy: not measured")
    say(f"captured mnist (a): {busy}")
    return {"MNIST MLP": ms}


def fused_gpt(dev, seed, card_name):
    """(b) GPT-base at bench_gpt's config (bf16, b=8, s=1024, AdamW), K=4,
    from one state: 4 eager steps against one dispatch, bit for bit; a
    profiled dispatch must show device time of all three tensor-core
    kernels, 12 launches of each a step, and none of the CUDA-core ones;
    eager against captured (ms per step, tokens/s, busy share, memory).
    Returns the Python launch counts of the path (eager steps, and the
    warm-up and capture of the captured step: a replay runs no Python)
    and the profiled replays' launches."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    k = FUSED_K
    cfg = gpt.base_config(**TRAIN)
    feeds = _train_feeds(np.random.RandomState(0), k, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    # ---- the main path, as a user drives it
    eager = _trainer(cfg, dev).startup(seed, sample_feed=feeds[0])
    fused = _trainer(cfg, dev).startup(seed, sample_feed=feeds[0], params=_params_of(eager))
    _zero_launch_counts(fa)  # the startups' init forwards took the flash forward
    losses_eager = torch.stack([eager.step(f)["loss"] for f in feeds])
    stacked = fused._put_feed(pt.data.stack_batches(feeds))
    outs = fused.run_steps(stacked)
    launches = _launch_counts(fa)
    # ---- end of the main path (the timing below launches more)
    differ = _states_differ(_state_of(eager), _state_of(fused))
    same_losses = _bits_equal(losses_eager, outs["loss"])
    say(f"captured gpt (b): bf16 GPT-base b={TRAIN_BATCH} s={TRAIN_SEQ} AdamW, run_steps(K={k}) "
        f"against {k} step() calls from one state: losses {outs['loss'].tolist()}, bit-equal "
        f"{same_losses}; state leaves differing {differ}; Python launch counts {launches} "
        f"({k} eager steps and the warm-up and capture of one step: "
        f"{cfg.num_layers} x ({k} + {_captured_step_runs()}) each)")
    check(same_losses and not differ, "captured gpt: run_steps differs from step()")
    want = cfg.num_layers * (k + _captured_step_runs())
    check(all(n == want for n in launches.values()),
          f"captured gpt: Python launch counts {launches}, want {want} each")
    wall, dev_us, n_ops, kernels = _profile_dispatch(lambda: fused.run_steps(stacked))
    READINGS["gpt_captured"] = {"device_ms": dev_us / 1e3 / k, "ops": n_ops / k}
    tensor_core = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")
    cuda_core = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    seen = {n: [sum(c for key, (c, _) in kernels.items() if n in key),
                sum(us for key, (_, us) in kernels.items() if n in key) / 1e3]
            for n in tensor_core + cuda_core}
    say(f"captured gpt (b): one profiled dispatch of {k} replays ({card_name}): {wall:.2f} ms, "
        f"{dev_us / 1e3:.2f} ms of device time ({dev_us / 1e3 / k:.2f} ms and "
        f"{n_ops / k:.0f} device operations a step), device busy "
        f"{100 * dev_us / 1e3 / wall:.1f}%; flash kernels [launches, device ms] {seen}")
    check(all(seen[n][0] == cfg.num_layers * k and seen[n][1] > 0 for n in tensor_core),
          f"captured gpt: the replays did not run each tensor-core kernel "
          f"{cfg.num_layers} times a step: {seen}")
    check(all(seen[n][0] == 0 for n in cuda_core),
          "captured gpt: the replays ran a kernel of the CUDA-core route")
    replayed = {n.replace("_wgmma", ""): seen[n][0] for n in tensor_core}
    staged = [eager._put_feed(f) for f in feeds]
    times, peaks = _eager_against_captured(eager, fused, staged, stacked, FUSED_DISPATCHES, k)
    ms = _timing_line(f"GPT-base bf16 b={TRAIN_BATCH} s={TRAIN_SEQ}, {FUSED_DISPATCHES} "
                      f"dispatches a turn", times, peaks, "tokens/s",
                      TRAIN_BATCH * TRAIN_SEQ, card_name, k,
                      _busy_against(eager, fused, staged, stacked))
    READINGS["gpt_captured"]["ms"] = ms["captured"]
    del eager, fused
    gc.collect()
    torch.cuda.empty_cache()
    return {"GPT-base": ms}, launches, replayed


def _captured_step_runs():
    """Eager runs of the step body a capture makes: its warm-up, then the
    capture itself (which launches every kernel's host code once)."""
    from paddle_tpu_torch import _captured_step
    return _captured_step.WARMUP_RUNS + 1


def fused_resnet(dev, seed, card_name):
    """(c) ResNet-50 at bench_resnet50's config (b=64, NHWC, bf16,
    Momentum) with a dynamic loss scaler, K=4, step 3 of the dispatch fed
    infinite pixels: its update is skipped on the device (params and
    batch-norm state kept), the scale backs off, the batch-norm state of
    the other steps carries through; the dispatch equals the eager steps
    bit for bit. Then eager against captured."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt

    k = FUSED_K
    feeds = _resnet_feeds(np.random.RandomState(0), k, RESNET_BATCH, RESNET["image_size"],
                          "NHWC")
    feeds[2] = dict(feeds[2], image=np.full_like(feeds[2]["image"], np.inf))
    strat = lambda: pt.DistStrategy(dynamic_loss_scale=True, loss_scale=1024.0)  # noqa: E731
    eager = _resnet_trainer(dev, "NHWC", strategy=strat()).startup(seed, feeds[0])
    fused = _resnet_trainer(dev, "NHWC", strategy=strat()).startup(
        seed, feeds[0], params=_params_of(eager))
    snaps, outs_eager = [_state_of(eager)], []
    for f in feeds:
        outs_eager.append(eager.step(f))
        snaps.append(_state_of(eager))
    outs = fused.run_steps(fused._put_feed(pt.data.stack_batches(feeds)))
    scales = outs["loss_scale"].tolist()
    kept = _states_differ(snaps[2], snaps[3])
    kept = [n for n in kept if not n.startswith("/ls/")]
    moved = [n for n in _states_differ(snaps[1], snaps[2]) if n.startswith("/state/")]
    differ = _states_differ(snaps[-1], _state_of(fused))
    same_losses = _bits_equal(torch.stack([o["loss"] for o in outs_eager]), outs["loss"])
    say(f"captured resnet (c): bf16 NHWC ResNet-50 b={RESNET_BATCH}, dynamic loss scale from "
        f"1024, run_steps(K={k}) with step 3 fed infinite pixels: losses "
        f"{[round(x, 5) for x in outs['loss'].tolist()]}, scales after each step {scales}; "
        f"the skipped step changed {kept or 'nothing'} but the loss-scale state; step 2 "
        f"moved {len(moved)} batch-norm statistics; captured against eager: losses bit-equal "
        f"{same_losses}, state leaves differing {differ}")
    check(scales[2] == scales[1] / 2 and scales[1] == scales[0],
          f"captured resnet: the scale did not back off at the skipped step: {scales}")
    check(not kept, f"captured resnet: the skipped step changed {kept[:5]}")
    check(moved, "captured resnet: the batch-norm statistics did not move")
    check(same_losses and not differ, "captured resnet: run_steps differs from step()")
    staged = _on_card(feeds[:2], dev)
    stacked = fused._put_feed(pt.data.stack_batches([feeds[i % 2] for i in range(k)]))
    times, peaks = _eager_against_captured(eager, fused, staged, stacked, FUSED_DISPATCHES, k)
    ms = _timing_line(f"ResNet-50 bf16 NHWC b={RESNET_BATCH} with a dynamic loss scaler, "
                      f"{FUSED_DISPATCHES} dispatches a turn", times, peaks, "images/s",
                      RESNET_BATCH, card_name, k,
                      _busy_against(eager, fused, [staged[i % 2] for i in range(k)], stacked))
    del eager, fused
    gc.collect()
    torch.cuda.empty_cache()
    return {"ResNet-50": ms}


def fused_transformer(dev, seed, card_name):
    """(d) Transformer-base at bench_transformer's config with dropout 0.1
    (b=32, s=256, Adam), K=4: captured against eager bit for bit; the same
    under DistStrategy(remat=True) on the model cut to FUSED_REMAT_LAYERS +
    FUSED_REMAT_LAYERS layers (the only cut); eager against captured."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa

    k = FUSED_K
    feeds = _seq2seq_feeds(np.random.RandomState(0), k, TR_BATCH, TR_SEQ)
    cut = FUSED_REMAT_LAYERS
    ms = None
    for remat in (False, True):
        # phase 11 (b)'s config: bench_transformer's, bf16 tables and norms
        cfg = _transformer_cfg(max_len=TR_SEQ, dropout=DROPOUT_P, dtype="bfloat16")
        if remat:
            cfg = dataclasses.replace(cfg, num_encoder_layers=cut, num_decoder_layers=cut)
        strategy = pt.DistStrategy(remat=True) if remat else None
        eager = _seq2seq_trainer(cfg, dev, strategy).startup(seed, feeds[0])
        fused = _seq2seq_trainer(cfg, dev, strategy).startup(seed, feeds[0],
                                                             params=_params_of(eager))
        # the startups' init runs (not training) took the flash forward
        _zero_launch_counts(fa)
        losses_eager = torch.stack([eager.step(f)["loss"] for f in feeds])
        stacked = fused._put_feed(pt.data.stack_batches(feeds))
        outs = fused.run_steps(stacked)
        differ = _states_differ(_state_of(eager), _state_of(fused))
        same_losses = _bits_equal(losses_eager, outs["loss"])
        gens = len(fused._fused.stream.generators())
        say(f"captured transformer (d): bf16 Transformer-base b={TR_BATCH} s={TR_SEQ} "
            f"dropout {DROPOUT_P}" + (f", remat on {cut}+{cut} layers (cut from "
                                      f"{TRANSFORMER['num_encoder_layers']}+"
                                      f"{TRANSFORMER['num_decoder_layers']})"
                                      if remat else "")
            + f": run_steps(K={k}) against {k} step() calls: losses "
            f"{[round(x, 5) for x in outs['loss'].tolist()]}, bit-equal {same_losses}; "
            f"state leaves differing {differ}; {gens} generators registered with the "
            f"graph")
        check(same_losses and not differ,
              f"captured transformer: run_steps differs from step() (remat {remat})")
        check(len(set(outs["loss"].tolist())) == k, "captured transformer: repeated loss")
        launches = _launch_counts(fa)
        check(all(n == 0 for n in launches.values()),
              f"captured transformer: a flash kernel launched in training: {launches}")
        if not remat:
            staged = [eager._put_feed(f) for f in feeds]
            times, peaks = _eager_against_captured(eager, fused, staged, stacked,
                                                   FUSED_DISPATCHES, k)
            ms = _timing_line(f"Transformer-base bf16 b={TR_BATCH} s={TR_SEQ} dropout "
                              f"{DROPOUT_P}, {FUSED_DISPATCHES} dispatches a turn",
                              times, peaks, "tokens/s", TR_BATCH * TR_SEQ, card_name, k,
                              _busy_against(eager, fused, staged, stacked))
        del eager, fused
        gc.collect()
        torch.cuda.empty_cache()
    return {"Transformer-base": ms}


def _fused_alone(make, feeds, k, path, card_name, unit, per_step, on_fused=None,
                 record_into=None):
    """Eager and captured trainers from one state, one at a time (for
    paths whose trainers would not fit the card together): ``k`` eager
    steps, twice; then ``run_steps(k)``; then one more timed dispatch of
    each kind. Where the two eager runs agree bit for bit the captured run
    must too. Where they do not (a library kernel that accumulates with
    atomics, such as ``torch.gather``'s backward), the captured run is
    held to the first eager run within FUSED_NONDET_RATIO times the eager
    runs' own distance: the worst relative L2 distance of a state leaf,
    and the worst relative difference of a loss (at least
    FUSED_LOSS_FLOOR, should the eager runs' losses agree). ``on_fused`` runs just
    before the captured trainer is made; ``record_into`` (a list) takes
    :func:`record_kernel_calls`' record of the first eager run. Returns
    {"eager": ms, "captured": ms}."""
    import gc
    import torch
    import paddle_tpu_torch as pt

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    eager = make(None)
    params = _params_of(eager)
    if record_into is None:
        losses_eager = torch.stack([eager.step(f)["loss"] for f in feeds])
    else:
        from paddle_tpu_torch.ops import flash_attention as fa
        with record_kernel_calls(fa) as calls:
            losses_eager = torch.stack([eager.step(f)["loss"] for f in feeds])
        record_into.extend(calls)
    state_eager = _state_of(eager)
    staged = [eager._put_feed(f) for f in feeds]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in staged:
        eager.step(f)
    torch.cuda.synchronize()
    ms = {"eager": (time.perf_counter() - t0) / k * 1e3}
    del eager, staged
    free()
    again = make(params)
    losses_again = torch.stack([again.step(f)["loss"] for f in feeds])
    state_again = _state_of(again)
    del again
    free()
    if on_fused is not None:
        on_fused()
    fused = make(params)
    stacked = fused._put_feed(pt.data.stack_batches(feeds))
    outs = fused.run_steps(stacked)
    state_fused = _state_of(fused)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused.run_steps(stacked)
    torch.cuda.synchronize()
    ms["captured"] = (time.perf_counter() - t0) / k * 1e3
    del fused
    free()

    def distance(losses, state):
        loss = float(((losses - losses_eager).abs() / losses_eager.abs()).max())
        leaves = max((_rel_l2(state[n], state_eager[n]) for n in state_eager
                      if state_eager[n].is_floating_point()), default=0.0)
        return loss, leaves, _states_differ(state_eager, state)

    spread, held = distance(losses_again, state_again), distance(outs["loss"], state_fused)
    deterministic = not spread[2] and _bits_equal(losses_again, losses_eager)
    timing = (f"one more dispatch of each ({card_name}): eager {ms['eager']:.4f} ms per step "
              f"({per_step / ms['eager'] * 1e3:.1f} {unit}), captured {ms['captured']:.4f} "
              f"({per_step / ms['captured'] * 1e3:.1f} {unit}), "
              f"{ms['eager'] / ms['captured']:.2f}x")
    if deterministic:
        same = not held[2] and _bits_equal(losses_eager, outs["loss"])
        say(f"captured {path}: run_steps(K={k}) against {k} step() calls from one state (two "
            f"eager runs bit-equal): losses {[round(x, 5) for x in outs['loss'].tolist()]}, "
            f"bit-equal {same}; state leaves differing {held[2]}; {timing}")
        check(same, f"captured {path}: run_steps differs from step()")
    else:
        ok = held[0] <= FUSED_NONDET_RATIO * max(spread[0], FUSED_LOSS_FLOOR) and \
            held[1] <= FUSED_NONDET_RATIO * spread[1]
        say(f"captured {path}: two eager runs from one state differ ({len(spread[2])} state "
            f"leaves, e.g. {spread[2][:3]}; losses rel up to {spread[0]:.3g}, leaves rel L2 up "
            f"to {spread[1]:.3g}): a library kernel accumulates in an order of its own, so "
            f"run_steps(K={k}) is held to the eager run within {FUSED_NONDET_RATIO}x that: "
            f"losses rel {held[0]:.3g}, leaves rel L2 {held[1]:.3g}; {timing}")
        check(ok, f"captured {path}: run_steps lies farther from step() than two eager runs")
    return ms


def fused_bert_and_long(dev, seed, card_name):
    """(f) The other training paths of phase 11: BERT-base at bench_bert's
    config (dropout 0.1, K=4) and transformer_long (b=4, s=4096, dropout
    0, K=2: the three flash kernels in the graph, the encoder's under a
    key bias), each captured against eager bit for bit. Returns the
    Python launch counts of the long path (its eager steps, and the
    warm-up and capture of one step)."""
    import numpy as np
    from paddle_tpu_torch.ops import flash_attention as fa

    k = FUSED_K
    cfg = _bert_cfg(dtype="bfloat16")
    feeds = _bert_feeds(np.random.RandomState(0), k, BERT_BATCH, BERT_SEQ, BERT_MASKED,
                        cfg.vocab_size)
    times = {"BERT-base": _fused_alone(
        lambda params: _bert_trainer(cfg, dev).startup(seed, feeds[0], params=params),
        feeds, k, f"bert (f): bf16 BERT-base b={BERT_BATCH} s={BERT_SEQ}", card_name,
        "tokens/s", BERT_BATCH * BERT_SEQ)}
    k = FUSED_LONG_K
    cfg = _transformer_cfg(max_len=LONG_SEQ, dropout=0.0, dtype="bfloat16")
    feeds = _seq2seq_feeds(np.random.RandomState(0), k, LONG_BATCH, LONG_SEQ)

    def make(params):
        tr = _seq2seq_trainer(cfg, dev).startup(seed, feeds[0], params=params)
        _zero_launch_counts(fa)  # after the startup's init forwards
        return tr

    launches = {}
    times["transformer_long"] = _fused_alone(
        make, feeds, k, f"transformer_long (f): bf16 b={LONG_BATCH} s={LONG_SEQ}",
        card_name, "tokens/s", LONG_BATCH * LONG_SEQ,
        on_fused=lambda: launches.update(_launch_counts(fa)))
    captured = _launch_counts(fa)
    layers = cfg.num_encoder_layers + cfg.num_decoder_layers
    # the eager trainers' counts: the second one's k steps (each startup zeroes)
    want = {n: k * layers for n in launches}
    say(f"captured transformer_long (f): Python launch counts of the second eager run's steps "
        f"{launches} (want {want}), of the captured trainer {captured} (two dispatches: the "
        f"warm-up and capture of one step, {_captured_step_runs()} x {layers} each)")
    check(launches == want, "captured transformer_long: eager launch counts")
    check(all(n == _captured_step_runs() * layers for n in captured.values()),
          "captured transformer_long: a replay ran Python, or the capture launched no kernel")
    return times, {n: launches[n] + captured[n] for n in captured}


def fused_coverage(dev, seed, card_name, tmp):
    """(e) The guard in a fused dispatch: a NaN batch at step FUSED_GUARD_AT
    of a K=16 MNIST dispatch from global step 3 is discarded on the
    device and recorded at step 3 + FUSED_GUARD_AT with that batch's
    digest, as the eager steps record it; the state equals theirs."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import mnist
    from paddle_tpu_torch.resilience import GuardPolicy, feed_digest

    k, at = FUSED_MNIST_K, FUSED_GUARD_AT
    feeds = _mnist_feeds()
    chunk = [feeds[i % len(feeds)] for i in range(k)]
    chunk[at] = dict(chunk[at], image=np.full_like(chunk[at]["image"], np.nan))
    trainers = []
    for _ in range(2):
        tr = pt.Trainer(pt.build(mnist.mlp), pt.optimizer.SGD(MNIST_LR),
                        loss_name="loss", place=dev,
                        guard=GuardPolicy(max_incidents=4, window=100))
        trainers.append(tr.startup(seed, feeds[0]))
    eager, fused = trainers
    for tr in trainers:
        for f in feeds[:3]:
            tr.step(f)
    for f in chunk:
        eager.step(f)
    outs = fused.run_steps(pt.data.stack_batches(chunk))
    for tr in trainers:
        tr.drain_guard()
    steps = {n: [i.step for i in tr.guard_incidents] for n, tr in (("eager", eager),
                                                                   ("captured", fused))}
    digest_ok = [i.feed_digest for i in fused.guard_incidents] == [feed_digest(chunk[at])]
    differ = _states_differ(_state_of(eager), _state_of(fused))
    say(f"captured coverage (e): the guard in a K={k} dispatch from global step 3 with a NaN "
        f"batch at step {at}: masks {outs['guard_nonfinite'].tolist()}, incidents at steps "
        f"{steps} (want [{3 + at}]), digest of that batch alone {digest_ok}; state against "
        f"the eager steps: leaves differing {differ}")
    check(steps["captured"] == steps["eager"] == [3 + at],
          f"captured coverage: the incident was charged to {steps}")
    check(digest_ok and not differ, "captured coverage: digest or state differ")


def phase_fused(dev, seed, card_name):
    """Phase 12: captured steps on each training path, (a)-(f). Returns
    the Python launch counts of the paths that run the kernels (GPT-base
    and transformer_long) and the profiled GPT-base replays' launches."""
    import gc
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa

    timings = {}
    with tempfile.TemporaryDirectory() as tmp:
        _zero_launch_counts(fa)
        timings.update(fused_mnist(dev, seed, card_name, tmp))
        fused_coverage(dev, seed, card_name, tmp)
        mnist_launches = _launch_counts(fa)
        check(all(n == 0 for n in mnist_launches.values()),
              "captured mnist: a flash kernel launched")
        with pt.amp_guard("bfloat16"):
            gpt_times, launches, replayed = fused_gpt(dev, seed, card_name)
            timings.update(gpt_times)
            _zero_launch_counts(fa)
            timings.update(fused_resnet(dev, seed, card_name))
            resnet = _launch_counts(fa)
            # zeroed after each trainer's startup and checked inside
            timings.update(fused_transformer(dev, seed, card_name))
            more, long_launches = fused_bert_and_long(dev, seed, card_name)
            timings.update(more)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"captured steps: hand-kernel launches on the ResNet-50 path {resnet} (it runs none)")
    check(all(n == 0 for n in resnet.values()), "captured resnet: a flash kernel launched")
    for path, ms in timings.items():
        say(f"captured steps summary ({card_name}): {path}: eager {ms['eager']:.4f} ms per "
            f"step, captured {ms['captured']:.4f} ms per step, "
            f"{ms['eager'] / ms['captured']:.2f}x")
    return {n: launches[n] + long_launches[n] for n in launches}, replayed


# -- phase 13: the captured decode (GPTGenerator: one CUDA graph of a step) ----


def _outputs_equal(a, b):
    return sorted(a) == sorted(b) and all(_bits_equal(a[k], b[k]) for k in a)


def _decode_path(path, gen, ids, card_name, profile_eager=False):
    """One generator at one bucket, eager loop against captured replays:
    outputs bit-equal, ms per decode step in turns, a profiled captured
    call (and a profiled eager call where ``profile_eager``: the
    profiler takes about a minute to sum an eager call's events), the
    prefill's launches and the cache's bytes. Returns the captured
    outputs and the numbers."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa

    b, steps = ids.shape[0], gen.max_new_tokens - 1
    t_path = time.perf_counter()
    eager_out = gen._generate_eager(ids)
    before = fa.flash_fwd_launches
    captured_out = gen(ids)  # the first call at this signature captures
    per_call = fa.flash_fwd_launches - before
    check(per_call == GPT_BASE["num_layers"],
          f"captured decode {path}: {per_call} flash_fwd launches a call (the capture's "
          "warm-up runs no prefill)")
    dec = gen._decoders[tuple(ids.shape)]
    check(dec.captures == 1 and dec.replays == steps,
          f"captured decode {path}: {dec.captures} captures, {dec.replays} replays")
    check(_outputs_equal(captured_out, eager_out),
          f"captured decode {path}: the replayed steps differ from the eager loop")
    with torch.inference_mode():
        prefill_ms = _host_ms(lambda: gen.prefill(ids))
    runs = {"eager": lambda: gen._generate_eager(ids), "captured": lambda: gen(ids)}
    times, peaks = {n: [] for n in runs}, {n: 0.0 for n in runs}
    for name in ("eager", "captured", "captured", "eager"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = runs[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() / 1e9)
        check(_outputs_equal(out, eager_out),
              f"captured decode {path}: a timed {name} call's outputs differ")
    with torch.inference_mode():
        pre = _profile_dispatch(lambda: gen.prefill(ids))
    profiled = {n: _profile_dispatch(fn) for n, fn in runs.items()
                if n == "captured" or profile_eager}
    ms = {n: float(sum(v) / len(v)) for n, v in times.items()}
    step_ms = {n: (ms[n] - prefill_ms) / steps for n in ms}
    parts = []
    for n, (wall, dev_us, n_ops, _) in profiled.items():
        if dev_us == 0:
            parts.append(f"{n} busy: not measured (the profiler saw no device time)")
            continue
        parts.append(f"{n} busy {100 * dev_us / 1e3 / wall:.1f}% of a profiled {wall:.1f} ms "
                     f"call, {(dev_us - pre[1]) / 1e3 / steps:.4f} device ms and "
                     f"{(n_ops - pre[2]) / steps:.1f} operations a decode step")
    kernels = profiled["captured"][3]
    wgmma = sum(c for k, (c, _) in kernels.items() if "flash_fwd_wgmma" in k)
    cuda_core = sum(c for k, (c, _) in kernels.items() if "flash_fwd_kernel" in k)
    say(f"captured decode ({card_name}): {path}, b={b}, p={ids.shape[1]}, new="
        f"{gen.max_new_tokens}: eager {[round(t, 2) for t in times['eager']]} ms a call "
        f"({step_ms['eager']:.4f} ms a decode step, "
        f"{b * gen.max_new_tokens / ms['eager'] * 1e3:.1f} generated tokens/s), captured "
        f"{[round(t, 2) for t in times['captured']]} ms a call ({step_ms['captured']:.4f} ms "
        f"a decode step, {b * gen.max_new_tokens / ms['captured'] * 1e3:.1f} generated "
        f"tokens/s), {step_ms['eager'] / step_ms['captured']:.2f}x a step; prefill "
        f"{prefill_ms:.3f} ms ({pre[1] / 1e3:.4f} device ms, {pre[2]} operations); "
        + "; ".join(parts)
        + f"; peak memory eager {peaks['eager']:.3f} GB, captured {peaks['captured']:.3f} GB; "
        f"cache {dec.cache_bytes()} bytes; flash_fwd {per_call} launches a call, "
        f"profiled captured call: {wgmma} flash_fwd_wgmma and {cuda_core} flash_fwd_kernel "
        f"kernels over {steps} replays; {time.perf_counter() - t_path:.1f} s")
    if profiled["captured"][1]:
        # the wrappers' counts say the call launched 12; the profile shows
        # where they ran. It may drop events of a call of ~100k kernels
        # (one run on an H100 showed 11 of the 12), never adds them, so a
        # replay that launched the forward would show more than 12
        check(0 < wgmma <= GPT_BASE["num_layers"] and cuda_core == 0,
              f"captured decode {path}: the profiled call ran {wgmma} tensor-core and "
              f"{cuda_core} CUDA-core forward kernels (want the prefill's "
              f"{GPT_BASE['num_layers']} at most and none in the replays)")
    return captured_out, {"step_ms": step_ms, "cache_bytes": dec.cache_bytes()}


def _beam_card_against_cpu(dev, seed, card_name, kv_cache_dtype="compute"):
    """(b), (c) f32 beam 4 at phase 4's width, card against CPU from the
    same params: the best beam's score within BEAM_SCORE_TOL (the compute
    cache), or within INT8_SCORE_TOL with at least INT8_IDS_SHARE of the
    beams' ids equal (the int8 cache)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import gpt

    t0 = time.perf_counter()
    int8 = kv_cache_dtype == "int8"
    cfg = gpt.base_config(max_len=PROMPT + NEW_TOKENS, dtype="float32",
                          kv_cache_dtype=kv_cache_dtype, **GPT_BASE)
    card = gpt.make_generator(cfg, PARITY_NEW_TOKENS, beam_size=DECODE_BEAM,
                              device=dev).init_params(seed)
    host = gpt.make_generator(cfg, PARITY_NEW_TOKENS, beam_size=DECODE_BEAM,
                              device="cpu").load_params(
        {k: v.cpu() for k, v in card.flat_params().items()})
    prompts = np.random.RandomState(seed).randint(3, cfg.vocab_size,
                                                  (8, PROMPT)).astype(np.int32)
    t_init = time.perf_counter() - t0
    got = card(torch.from_numpy(prompts).to(dev))
    t_card = time.perf_counter() - t0 - t_init
    want = host(torch.from_numpy(prompts))
    best = (got["scores"][:, 0].cpu() - want["scores"][:, 0]).abs().max().item()
    same = float((got["ids"].cpu() == want["ids"]).all(dim=-1).float().mean())
    tol = INT8_SCORE_TOL if int8 else BEAM_SCORE_TOL
    ids_rule = (f"(at least {100 * INT8_IDS_SHARE:g}% required)" if int8
                else "(reported only)")
    say(f"captured decode ({card_name}): f32 beam {DECODE_BEAM} GPT-base, {kv_cache_dtype} "
        f"KV cache, b=8 p={PROMPT} new={PARITY_NEW_TOKENS}, card against CPU: best beam's "
        f"score max|card - cpu|={best:.3g} (tol {tol}), {100 * same:.1f}% of beams with "
        f"equal ids {ids_rule}; init {t_init:.1f} s, card {t_card:.1f} s, CPU "
        f"{time.perf_counter() - t0 - t_init - t_card:.1f} s")
    check(best <= tol, f"captured decode: f32 beam scores ({kv_cache_dtype} KV cache) differ "
          "from the CPU's")
    if int8:
        check(same >= INT8_IDS_SHARE, "captured decode: f32 beam ids (int8 KV cache) differ "
              "from the CPU's")
    del card, host


def _served_int8(dev, seed, card_name, params, tmp):
    """(d) The int8 cache served: ``export_decoder`` → ``decode_server``,
    each reply against its row of ``Predictor.run`` on the merged batch."""
    import numpy as np
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.fleet import decode
    from paddle_tpu_torch.models import gpt

    cfg = gpt.base_config(max_len=PROMPT + NEW_TOKENS, dtype="bfloat16",
                          kv_cache_dtype="int8", **GPT_BASE)
    rng = np.random.RandomState(seed + 3)
    prompts = rng.randint(3, cfg.vocab_size, (N_REQUESTS, PROMPT)).astype(np.int32)
    d = os.path.join(tmp, "int8_decoder")
    t0 = time.perf_counter()
    decode.export_decoder(d, cfg, NEW_TOKENS, prompts[:max(BUCKETS)], params=params,
                          batch_buckets=list(BUCKETS), compute_dtype="bfloat16", device=dev)
    t_export = time.perf_counter() - t0
    outs, lat, wall, rep = _serve_single_prompts(d, prompts, dev)
    t_serve = time.perf_counter() - t0 - t_export
    rows_ok = _rows_of_merged_batches(pio.load_inference_model(d, device=dev), prompts, outs)
    say(f"captured decode ({card_name}): int8 served, {N_REQUESTS} single-prompt requests, "
        f"buckets={list(BUCKETS)}: {N_REQUESTS * NEW_TOKENS / wall:.1f} generated tokens/s, "
        f"latency p50 {1e3 * float(np.percentile(lat, 50)):.1f} ms p99 "
        f"{1e3 * float(np.percentile(lat, 99)):.1f} ms, coalesced {rep['coalesced_requests']} "
        f"requests in {rep['coalesced_batches']} batches; {rows_ok}/{N_REQUESTS} replies "
        f"equal their row of Predictor.run on the merged batch (required); export "
        f"{t_export:.1f} s, load, warm-up and serving {t_serve:.1f} s, all "
        f"{time.perf_counter() - t0:.1f} s")
    check(rows_ok == N_REQUESTS, "captured decode: int8 replies differ from Predictor.run")
    check(rep["errors"] == 0 and rep["completed"] == N_REQUESTS,
          f"captured decode: int8 served {rep['errors']} errors")


def phase_captured_decode(dev, seed, card_name):
    """Phase 13: (a) greedy, (b) beam, (c) int8, each eager loop against
    captured replays, (d) the int8 cache served; then f32 beam card
    against CPU with each cache dtype. Returns the launches of each kernel during (a)-(d)."""
    import gc
    import dataclasses
    import numpy as np
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(max_len=PROMPT + NEW_TOKENS, dtype="bfloat16", **GPT_BASE)
    ids = torch.from_numpy(np.random.RandomState(seed + 2).randint(
        3, cfg.vocab_size, (DECODE_BUCKET, PROMPT)).astype(np.int32)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        _zero_launch_counts(fa)
        # ---- the main path: (a)-(d)
        t0 = time.perf_counter()
        gen = gpt.make_generator(cfg, NEW_TOKENS, compute_dtype="bfloat16",
                                 device=dev).init_params(seed)
        params = gen.flat_params()
        say(f"captured decode: GPT-base bf16 generator initialised in "
            f"{time.perf_counter() - t0:.1f} s")
        greedy, a = _decode_path("(a) greedy bf16", gen, ids, card_name, profile_eager=True)
        del gen
        beam = gpt.make_generator(cfg, NEW_TOKENS, beam_size=DECODE_BEAM,
                                  compute_dtype="bfloat16", device=dev).load_params(params)
        _decode_path(f"(b) beam {DECODE_BEAM} bf16", beam, ids, card_name)
        del beam
        int8 = gpt.make_generator(dataclasses.replace(cfg, kv_cache_dtype="int8"), NEW_TOKENS,
                                  compute_dtype="bfloat16", device=dev).load_params(params)
        q8_out, c = _decode_path("(c) greedy bf16, int8 KV cache", int8, ids, card_name)
        del int8
        same = float((q8_out["ids"] == greedy["ids"]).float().mean())
        say(f"captured decode ({card_name}): (c) int8 against the compute cache: "
            f"{c['step_ms']['captured']:.4f} against {a['step_ms']['captured']:.4f} ms a "
            f"captured decode step ({c['step_ms']['eager']:.4f} against "
            f"{a['step_ms']['eager']:.4f} eager), cache {c['cache_bytes']} against "
            f"{a['cache_bytes']} bytes ({c['cache_bytes'] / a['cache_bytes']:.3f}x), "
            f"{100 * same:.1f}% of ids equal (reported only)")
        _served_int8(dev, seed, card_name, params, tmp)
        launches = _launch_counts(fa)
        # ---- end of the main path
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _beam_card_against_cpu(dev, seed, card_name)
    _beam_card_against_cpu(dev, seed, card_name, "int8")
    say(f"captured decode: hand-kernel launches on the path {launches}")
    check(launches["flash_fwd"] > 0 and launches["flash_fwd"] % GPT_BASE["num_layers"] == 0,
          f"captured decode: {launches['flash_fwd']} flash_fwd launches is not a whole "
          "number of generate calls")
    check(launches["flash_bwd_dq"] == 0 and launches["flash_bwd_dkv"] == 0,
          "captured decode: a backward kernel launched on the serving path")
    return launches


# -- phase 14: the build GPT, remat policies, the stacked Transformer, accumulation --


def build_against_module(card_name):
    """(a) The build GPT's readings of phases 7 and 12(b) against the module
    GPT's last readings (MODULE_GPT, quoted): device time and
    operations a step, eager and captured, and the captured ms a step. On
    a card at its 700 W limit the device time a step must lie within
    BUILD_DEVICE_TOL of the module's: the build program adds no work."""
    eager, captured = READINGS.get("gpt_eager"), READINGS.get("gpt_captured")
    check(eager is not None and captured is not None,
          "phase 14 (a): phases 7 and 12(b) recorded no device time")
    mod = MODULE_GPT
    rel = {"eager": eager["device_ms"] / mod["eager_device_ms"] - 1,
           "captured": captured["device_ms"] / mod["captured_device_ms"] - 1}
    full_power = "700.00 W" in card_name
    say(f"phase 14 (a) build GPT against the module GPT ({card_name}): phase 7 eager "
        f"{eager['device_ms']:.2f} ms of device time in {eager['ops']} operations a step "
        f"(module: {mod['eager_device_ms']:.2f} ms; {100 * rel['eager']:+.2f}%); "
        f"phase 12(b) captured {captured['device_ms']:.2f} ms in {captured['ops']:.0f} "
        f"operations a step (module {mod['captured_device_ms']:.2f} ms in "
        f"{mod['captured_ops']}; {100 * rel['captured']:+.2f}%), {captured['ms']:.4f} ms a "
        f"captured step (module {mod['captured_ms']:.4f}); tol {100 * BUILD_DEVICE_TOL:.0f}% "
        f"on a 700 W card" + ("" if full_power else ": this card is not at 700 W, reported only"))
    if full_power:
        check(all(abs(r) <= BUILD_DEVICE_TOL for r in rel.values()),
              f"phase 14 (a): the build GPT's device time a step is off the module's: {rel}")


def _host_tree(tree):
    """An f32 copy of a tree's leaves on the host (a copy also of a leaf
    already there)."""
    import torch
    return {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in tree.items()}


def _tree_dist(a, b=None):
    """sqrt(sum ||a - b||^2) over the leaves of ``a``, in f32 (``b`` None:
    the norm of ``a``); a leaf of ``b`` may lie on the host."""
    import torch
    total = 0.0
    for k, v in a.items():
        d = v.detach().float()
        if b is not None:
            d = d - b[k].to(d.device).float()
        total += float(d.pow(2).sum(dtype=torch.float64))
    return total ** 0.5


def _take_grads(tr):
    """The grads a forward and backward left on the params (zeros where
    none), taken off them."""
    import torch
    grads = {}
    for k, p in tr.scope.params.items():
        grads[k] = torch.zeros_like(p) if p.grad is None else p.grad.detach()
        p.grad = None
    return grads


def _first_grads(tr, feed, seed, a):
    """The grads of one batch from the trainer's current params: one
    forward and backward, or under accum_steps ``a`` > 1 the microbatches'
    summed f32 grads divided by ``a`` (``Trainer._accumulate``)."""
    stream = tr._rng.reset(seed)
    if a > 1:
        grads = tr._accumulate(feed, stream, a)[2]
        _take_grads(tr)
        return grads
    tr._forward_backward(feed, stream, tr.scope.state)
    return _take_grads(tr)


def _drop_every_second_microbatch(tr):
    """A planted fault for phase 14 (d): every second microbatch's grads
    are dropped before the trainer sums them."""
    run, calls = tr._forward_backward, [0]

    def dropped(*args):
        out = run(*args)
        calls[0] += 1
        if calls[0] % 2 == 0:
            for p in tr.scope.params.values():
                p.grad = None
        return out

    tr._forward_backward = dropped


def _gpt_handoff(trainer, cfg, dev, seed, card_name):
    """A trained scope served unchanged: ``GPTGenerator.load_params(
    trainer.scope.params)`` decodes bucket 2 captured and eagerly, the ids
    bit-equal and in range."""
    import dataclasses
    import numpy as np
    import torch
    from paddle_tpu_torch.models import gpt

    gcfg = dataclasses.replace(cfg, max_len=HANDOFF_PROMPT + HANDOFF_NEW)
    ids = torch.from_numpy(np.random.RandomState(seed + 3).randint(
        3, cfg.vocab_size, (2, HANDOFF_PROMPT)).astype(np.int32)).to(dev)
    gen = gpt.make_generator(gcfg, HANDOFF_NEW, compute_dtype="bfloat16",
                             device=dev).load_params(trainer.scope.params)
    got, want = gen(ids)["ids"], gen._generate_eager(ids)["ids"]
    ok = _bits_equal(got, want) and int(got.min()) >= 0 and int(got.max()) < cfg.vocab_size
    say(f"phase 14 (b) the remat-off trainer's scope served by GPTGenerator.load_params "
        f"({card_name}): bucket 2, {HANDOFF_PROMPT}+{HANDOFF_NEW} tokens, captured ids "
        f"equal the eager loop's {ok}: {got[0].tolist()}")
    check(ok, "phase 14 (b): the trained scope does not serve")


def _peak_gb(fn):
    """(what ``fn`` returns, the peak device memory while it runs and that
    peak's rise over what was allocated before, in GB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, peak / 1e9, (peak - before) / 1e9


def remat_policies(dev, seed, card_name):
    """(b) Phase 7's bf16 GPT-base under DistStrategy(remat=True,
    remat_policy=p) for each policy, and with remat off, each from one
    seed: the peak memory of one training forward and backward (before
    any update: what the policy keeps) and its grads, then K=REMAT_K steps
    captured, the peak over that first dispatch (its warm-up copies the
    training state, and the update's new state outlasts the activations),
    the flash forward's launches a step body (12, or 24 where the blocks
    are recomputed), the K steps' losses and the params after them, and ms
    a step over REMAT_DISPATCHES more dispatches. Against remat off: the
    losses at BF16_ROUNDING, the grads and the params' move at REMAT_TOL.
    The forward and backward's rise in memory and the dispatch's peak in
    the order nothing < dots_no_batch <= dots < everything, which equals
    off; what a setting leaves allocated does not grow from setting to
    setting."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(**TRAIN)
    feeds = _train_feeds(np.random.RandomState(0), REMAT_K, TRAIN_BATCH, TRAIN_SEQ,
                         cfg.vocab_size)
    rows, ref = {}, None
    for policy in REMAT_SETTINGS:
        gc.collect()
        torch.cuda.empty_cache()
        allocated = torch.cuda.memory_allocated() / 1e9
        strategy = None if policy == "off" else pt.DistStrategy(remat=True,
                                                                 remat_policy=policy)
        tr = _trainer(cfg, dev, strategy).startup(seed, sample_feed=feeds[0])
        stacked = tr._put_feed(pt.data.stack_batches(feeds))
        first = {k: v[0] for k, v in stacked.items()}
        _, _, run_gb = _peak_gb(lambda: tr._forward_backward(first, tr._rng.reset(seed),
                                                             tr.scope.state))
        grads = _take_grads(tr)
        if policy == "off":
            ref = {"init": _host_tree(tr.scope.params), "grads": _host_tree(grads)}
            ref["grad_norm"] = _tree_dist(ref["grads"])
        grad_rel = _tree_dist(grads, ref["grads"]) / ref["grad_norm"]
        del grads
        before = _launch_counts(fa)
        outs, dispatch_gb, _ = _peak_gb(lambda: tr.run_steps(stacked))
        body = {n: (v - before[n]) / _captured_step_runs()
                for n, v in _launch_counts(fa).items()}
        # the K steps of the first dispatch, and the params after them
        losses = outs["loss"].float().cpu()
        if policy == "off":
            ref.update(losses=losses, params=_host_tree(tr.scope.params))
            ref["move"] = _tree_dist(ref["params"], ref["init"])
        param_rel = _tree_dist(tr.scope.params, ref["params"]) / ref["move"]
        t0 = time.perf_counter()
        for _ in range(REMAT_DISPATCHES):
            tr.run_steps(stacked)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (REMAT_DISPATCHES * REMAT_K) * 1e3
        if policy == "off":
            _gpt_handoff(tr, cfg, dev, seed, card_name)
        del tr, stacked, first, outs
        gc.collect()
        torch.cuda.empty_cache()
        rows[policy] = {"allocated_gb": allocated,
                        "left_gb": torch.cuda.memory_allocated() / 1e9, "run_gb": run_gb,
                        "dispatch_gb": dispatch_gb, "ms": ms, "body": body,
                        "losses": losses, "grad_rel": grad_rel, "param_rel": param_rel}
    for policy, r in rows.items():
        r["loss_rel"] = float(((r["losses"] - ref["losses"]).abs()
                               / ref["losses"].abs()).max())
        r["bits"] = (torch.equal(r["losses"], ref["losses"]) and r["grad_rel"] == 0
                     and r["param_rel"] == 0)
        say(f"phase 14 (b) remat {policy!r} ({card_name}): allocated before the setting "
            f"{r['allocated_gb']:.4f} GB, after it {r['left_gb']:.4f} GB; a training forward and backward raises memory by "
            f"{r['run_gb']:.3f} GB; peak over the first captured dispatch "
            f"{r['dispatch_gb']:.3f} GB; {r['ms']:.4f} ms a captured step (K={REMAT_K}); "
            f"launches a step {r['body']}; losses {r['losses'].tolist()}, rel to off "
            f"{r['loss_rel']:.3g} (tol {BF16_ROUNDING:.3g}); first grads' L2 distance to "
            f"off's {r['grad_rel']:.3g} of their norm, params' after {REMAT_K} steps "
            f"{r['param_rel']:.3g} of off's move from the initial params (off's move "
            f"{ref['move']:.4g}; tol {REMAT_TOL}); bit-equal to off {r['bits']}")
    layers = cfg.num_layers
    for policy, r in rows.items():
        recompute = policy not in ("off", "everything")
        want = {"flash_fwd": 2 * layers if recompute else layers,
                "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
        check(r["body"] == want, f"phase 14 (b): remat {policy!r} launches a step "
              f"{r['body']}, want {want}")
        check(r["loss_rel"] <= BF16_ROUNDING and r["grad_rel"] <= REMAT_TOL
              and r["param_rel"] <= REMAT_TOL,
              f"phase 14 (b): remat {policy!r} trains away from remat off")
        check(r["left_gb"] <= rows["off"]["left_gb"] + ALLOC_GROWTH_GB,
              f"phase 14 (b): remat {policy!r} left {r['left_gb']:.4f} GB allocated, "
              f"against {rows['off']['left_gb']:.4f} after off")
    # equal programs (dots and dots_no_batch with flash on; everything and
    # off) may part by the allocator's block rounding: 1%
    for what, key in (("the forward and backward's rise in memory", "run_gb"),
                      ("the first captured dispatch's peak memory", "dispatch_gb")):
        gb = {p: r[key] for p, r in rows.items()}
        check(gb["nothing"] < gb["dots_no_batch"] <= 1.01 * gb["dots"]
              and gb["dots"] < gb["everything"]
              and abs(gb["everything"] - gb["off"]) <= 0.01 * gb["off"],
              f"phase 14 (b): {what} out of the order nothing < dots_no_batch <= dots < "
              f"everything ~ off: {gb}")
    return rows


def stacked_transformer(dev, seed, card_name):
    """(c) The stacked Transformer: Transformer-base at bench.py's
    BENCH_STACKED=1 config (phase 11 (b)'s: b=32, s=256, dropout 0.1, bf16,
    Adam, fuse_qkv, fused_ce), eager against captured K=FUSED_K bit for
    bit, with ms a step, device time and operations a step and peak memory
    against phase 11 (b)'s unrolled model; then stacked transformer_long
    (b=4, s=4096, dropout 0), eager against captured K=FUSED_LONG_K, every
    flash call of its first eager steps held against the plain versions
    (the stacked decoder's cross attention among them)."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa

    k = FUSED_K
    cfg = _transformer_cfg(max_len=TR_SEQ, dropout=DROPOUT_P, dtype="bfloat16", stacked=True)
    feeds = _seq2seq_feeds(np.random.RandomState(0), k, TR_BATCH, TR_SEQ)
    eager = _seq2seq_trainer(cfg, dev).startup(seed, feeds[0])
    fused = _seq2seq_trainer(cfg, dev).startup(seed, feeds[0], params=_params_of(eager))
    _zero_launch_counts(fa)  # the startups' init forwards took the flash forward
    losses_eager = torch.stack([eager.step(f)["loss"] for f in feeds])
    stacked = fused._put_feed(pt.data.stack_batches(feeds))
    outs = fused.run_steps(stacked)
    differ = _states_differ(_state_of(eager), _state_of(fused))
    same = _bits_equal(losses_eager, outs["loss"])
    finite = bool(torch.isfinite(outs["loss"]).all() and torch.isfinite(losses_eager).all())
    launches = _launch_counts(fa)
    say(f"phase 14 (c) stacked Transformer-base bf16 b={TR_BATCH} s={TR_SEQ} dropout "
        f"{DROPOUT_P} ({card_name}): run_steps(K={k}) against {k} step() calls: losses "
        f"{[round(x, 5) for x in outs['loss'].tolist()]}, bit-equal {same}, finite {finite}; "
        f"state leaves differing {differ}; launches in training {launches} (want 0: dropout "
        f"takes the dense path)")
    check(same and not differ and finite, "phase 14 (c): stacked run_steps differs from step()")
    check(all(n == 0 for n in launches.values()),
          "phase 14 (c): a flash kernel launched in training at dropout 0.1")
    staged = [eager._put_feed(f) for f in feeds]
    times, peaks = _eager_against_captured(eager, fused, staged, stacked, FUSED_DISPATCHES, k)
    busy = {}
    ms = _timing_line(f"stacked Transformer-base bf16 b={TR_BATCH} s={TR_SEQ} dropout "
                      f"{DROPOUT_P}, {FUSED_DISPATCHES} dispatches a turn", times, peaks,
                      "tokens/s", TR_BATCH * TR_SEQ, card_name, k,
                      _busy_against(eager, fused, staged, stacked, into=busy))
    unrolled = READINGS.get("transformer", {})
    dev_ms, n_ops = busy.get("eager", (0.0, 0))
    say(f"phase 14 (c) stacked against unrolled Transformer-base ({card_name}): eager "
        f"{ms['eager']:.4f} ms a step (phase 11 (b) unrolled {unrolled.get('ms', 0):.4f}), "
        f"captured {ms['captured']:.4f}; device {dev_ms:.2f} ms in {n_ops:.0f} operations a "
        f"profiled eager step (unrolled {unrolled.get('device_ms', 0):.2f} ms in "
        f"{unrolled.get('ops', 0)}); peak memory eager {peaks['eager']:.3f} GB (unrolled "
        f"{unrolled.get('peak_gb', 0):.3f})")
    del eager, fused, staged, stacked
    gc.collect()
    torch.cuda.empty_cache()

    k = FUSED_LONG_K
    cfg = _transformer_cfg(max_len=LONG_SEQ, dropout=0.0, dtype="bfloat16", stacked=True)
    feeds = _seq2seq_feeds(np.random.RandomState(0), k, LONG_BATCH, LONG_SEQ)

    def make(params):
        tr = _seq2seq_trainer(cfg, dev).startup(seed, feeds[0], params=params)
        _zero_launch_counts(fa)  # after the startup's init forwards
        return tr

    calls, launches = [], {}
    ms_long = _fused_alone(make, feeds, k, f"stacked transformer_long (c): bf16 "
                           f"b={LONG_BATCH} s={LONG_SEQ}", card_name, "tokens/s",
                           LONG_BATCH * LONG_SEQ,
                           on_fused=lambda: launches.update(_launch_counts(fa)),
                           record_into=calls)
    captured = _launch_counts(fa)
    layers = cfg.num_encoder_layers + 2 * cfg.num_decoder_layers  # + the cross attention
    want = {n: k * layers for n in launches}
    say(f"phase 14 (c) stacked transformer_long: launches of the second eager run's steps "
        f"{launches} (want {want}: 6 encoder, 6 causal decoder and 6 cross attentions a "
        f"step), of the captured trainer {captured}")
    check(launches == want, "phase 14 (c): stacked transformer_long eager launch counts")
    check(all(n == _captured_step_runs() * layers for n in captured.values()),
          "phase 14 (c): stacked transformer_long capture launch counts")
    check(any(c[2] for c in calls), "phase 14 (c): no cross attention reached the kernels")
    check_recorded(fa, calls, "stacked transformer_long")
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    return {"stacked Transformer-base": ms, "stacked transformer_long": ms_long}, \
        {n: launches[n] + captured[n] for n in captured}


def accumulation(dev, seed, card_name):
    """(d) DistStrategy(accum_steps=a) at phase 7's config, captured
    K=REMAT_K, for a in ACCUM_STEPS: peak memory over the first dispatch
    and of an eager step, ms a step, and against a=1 (bench.py's feeds
    have no pad: each microbatch counts the same tokens) the K steps'
    losses at BF16_ROUNDING, the first batch's grads from the initial
    params at ACCUM_GRAD_TOL and the params after the K steps at
    ACCUM_PARAM_TOL (of a=1's move from the initial params); a planted
    fault, accum_steps 2 with every second microbatch's grads dropped (K
    eager steps), must exceed both limits; the flash calls at the
    microbatches' shapes held against the plain versions; then ResNet-50
    at phase 10 (b)'s config, one step at accum_steps 2: finite, its
    batch-norm state the two microbatches' threaded one after the other."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gpt

    cfg = gpt.base_config(**TRAIN)
    feeds = _train_feeds(np.random.RandomState(0), REMAT_K, TRAIN_BATCH, TRAIN_SEQ,
                         cfg.vocab_size)
    from paddle_tpu_torch.ops import flash_attention as fa

    rows, ref = {}, None
    # the planted fault last, keyed "2, dropped"
    for a in ACCUM_STEPS + ("2, dropped",):
        planted = a == "2, dropped"
        n = 2 if planted else a
        gc.collect()
        torch.cuda.empty_cache()
        tr = _trainer(cfg, dev, pt.DistStrategy(accum_steps=n) if n > 1 else None)
        tr.startup(seed, sample_feed=feeds[0])
        if planted:
            _drop_every_second_microbatch(tr)
        stacked = tr._put_feed(pt.data.stack_batches(feeds))
        grads = _first_grads(tr, {k: v[0] for k, v in stacked.items()}, seed, n)
        if a == 1:
            ref = {"init": _host_tree(tr.scope.params), "grads": _host_tree(grads)}
            ref["grad_norm"] = _tree_dist(ref["grads"])
        grad_rel = _tree_dist(grads, ref["grads"]) / ref["grad_norm"]
        del grads
        row = {"grad_rel": grad_rel}
        if planted:
            losses = torch.stack([tr.step({k: v[i] for k, v in stacked.items()})["loss"]
                                  for i in range(REMAT_K)])
        else:
            # the capture's warm-up hands the kernels the microbatches' shapes
            with record_kernel_calls(fa) as calls:
                outs, row["dispatch_gb"], _ = _peak_gb(lambda: tr.run_steps(stacked))
            if a > 1:
                check_recorded(fa, calls, f"accum_steps {a} GPT-base")
            del calls
            losses = outs["loss"]
        row["losses"] = losses.float().cpu()
        if a == 1:
            ref["params"] = _host_tree(tr.scope.params)
            ref["move"] = _tree_dist(ref["params"], ref["init"])
        row["param_rel"] = _tree_dist(tr.scope.params, ref["params"]) / ref["move"]
        if not planted:
            t0 = time.perf_counter()
            for _ in range(REMAT_DISPATCHES):
                tr.run_steps(stacked)
            torch.cuda.synchronize()
            row["ms"] = (time.perf_counter() - t0) / (REMAT_DISPATCHES * REMAT_K) * 1e3
            # an eager step on the main stream: the step's own peak
            _, row["step_gb"], _ = _peak_gb(
                lambda: tr.step({k: v[0] for k, v in stacked.items()}))
        rows[a] = row
        del tr, stacked, losses
    base = rows[1]["losses"]
    for a, r in rows.items():
        r["rel"] = float(((r["losses"] - base).abs() / base.abs()).max())
        sound = a != "2, dropped"
        n = 2 if not sound else a
        say(f"phase 14 (d) accum_steps {a} GPT-base bf16 b={TRAIN_BATCH} ({TRAIN_BATCH // n} "
            f"a microbatch) s={TRAIN_SEQ} ({card_name}): "
            + (f"peak memory of an eager step {r['step_gb']:.3f} GB, over the first "
               f"captured dispatch {r['dispatch_gb']:.3f} GB; {r['ms']:.4f} ms a captured "
               f"step (K={REMAT_K}); " if sound else f"planted fault, {REMAT_K} eager steps; ")
            + f"losses {r['losses'].tolist()}, rel to accum_steps 1 {r['rel']:.3g} (tol "
            f"{BF16_ROUNDING:.3g}); first grads' L2 distance to accum_steps 1's "
            f"{r['grad_rel']:.3g} of their norm (tol {ACCUM_GRAD_TOL}), params' after "
            f"{REMAT_K} steps {r['param_rel']:.3g} of accum_steps 1's move from the "
            f"initial params ({ref['move']:.4g}; tol {ACCUM_PARAM_TOL})")
        check(bool(torch.isfinite(r["losses"]).all()), f"phase 14 (d): accum {a} not finite")
        if not sound:
            check(r["grad_rel"] > ACCUM_GRAD_TOL and r["param_rel"] > ACCUM_PARAM_TOL,
                  "phase 14 (d): the planted fault (a microbatch's grads dropped) passes "
                  "the limits")
            continue
        check(r["rel"] <= BF16_ROUNDING, f"phase 14 (d): accum {a}'s losses differ from "
              "one batch's")
        check(r["grad_rel"] <= ACCUM_GRAD_TOL and r["param_rel"] <= ACCUM_PARAM_TOL,
              f"phase 14 (d): accum {a} trains away from one batch")
        check(r["step_gb"] <= rows[1]["step_gb"],
              f"phase 14 (d): accum {a} raised an eager step's peak memory")
    gc.collect()
    torch.cuda.empty_cache()

    # ResNet-50, one step at accum_steps 2: the batch-norm state threaded
    with pt.amp_guard("bfloat16"):
        feed = _resnet_feeds(np.random.RandomState(0), 1, RESNET_BATCH, RESNET["image_size"],
                             "NHWC")[0]
        tr = _resnet_trainer(dev, "NHWC", strategy=pt.DistStrategy(accum_steps=2))
        tr.startup(seed, feed)
        p0, s0 = _params_of(tr), {k: v.clone() for k, v in tr.scope.state.items()}
        half = RESNET_BATCH // 2
        micro = [{k: torch.from_numpy(v[i * half:(i + 1) * half]).to(dev)
                  for k, v in feed.items()} for i in range(2)]
        with torch.no_grad():
            _, s1 = tr.program.apply(p0, s0, training=True, place=dev, **micro[0])
            _, s2 = tr.program.apply(p0, s1, training=True, place=dev, **micro[1])
            _, s2_alone = tr.program.apply(p0, s0, training=True, place=dev, **micro[1])
        loss = float(tr.step(feed)["loss"])
    state = tr.scope.state
    moved = max(float((s2[k].float() - s0[k].float()).abs().max()) for k in s0)
    err = max(float((state[k].float() - s2[k].float()).abs().max()) for k in s0) / moved
    apart = max(float((s2_alone[k].float() - s2[k].float()).abs().max()) for k in s0) / moved
    say(f"phase 14 (d) ResNet-50 bf16 NHWC b={RESNET_BATCH} accum_steps 2 ({card_name}): loss "
        f"{loss:.5f}; batch-norm state after the step against the two microbatches' forwards "
        f"threaded by hand: max |diff| {err:.3g} of the state's largest move (tol "
        f"{RESNET_ACCUM_STATE_TOL}), the unthreaded state {apart:.3g} away")
    check(np.isfinite(loss), "phase 14 (d): the ResNet-50 step is not finite")
    check(err <= RESNET_ACCUM_STATE_TOL < apart,
          "phase 14 (d): the batch-norm state was not threaded through the microbatches")
    del tr, p0, s0, s1, s2, s2_alone, micro
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_remat_accum_stacked(dev, seed, card_name):
    """Phase 14: (a) the build GPT against the module GPT, (b) remat
    policies, (c) the stacked Transformer, (d) gradient accumulation. The
    launch counts are zeroed just before (b)-(d) and read just after;
    returns them."""
    import gc
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa

    build_against_module(card_name)
    counts = []
    with pt.amp_guard("bfloat16"):
        # ---- the main path, as a user drives it ((c) zeroes the counts after
        # each trainer's startup and returns its own)
        for part, run in (("(b)", remat_policies), ("(c)", stacked_transformer),
                          ("(d)", accumulation)):
            t0 = time.perf_counter()
            _zero_launch_counts(fa)
            out = run(dev, seed, card_name)
            counts.append(out[1] if part == "(c)" else _launch_counts(fa))
            say(f"phase 14 {part} took {time.perf_counter() - t0:.1f} s")
        # ---- end of the main path
    launches = {n: sum(c[n] for c in counts) for n in counts[0]}
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 14: hand-kernel launches on the paths {launches}")
    check(all(n > 0 for n in launches.values()), "phase 14: a flash kernel never launched")
    return launches


# -- phase 15: DeepFM, the recommender, the rest of the optimizers --------------


def _deepfm_feeds(dim):
    """bench.py _bench_deepfm_config's feeds (bench.py:551-556)."""
    import numpy as np
    rng = np.random.RandomState(0)
    f, d = DEEPFM["num_sparse_fields"], DEEPFM["num_dense"]
    return [{"dense": rng.randn(DEEPFM_BATCH, d).astype(np.float32),
             "sparse_ids": rng.randint(0, dim, (DEEPFM_BATCH, f)).astype(np.int32),
             "label": rng.randint(0, 2, (DEEPFM_BATCH, 1)).astype(np.int64)}
            for _ in range(DEEPFM_FEEDS)]


def _deepfm_trainer(dev, dim, sample, seed=0, params=None, lr=DEEPFM_LR):
    """bench.py's DeepFM trainer: ``build(deepfm.make_model(...))`` and
    Adagrad, the loss fetched."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import deepfm
    prog = pt.build(deepfm.make_model(**dict(DEEPFM, sparse_feature_dim=dim)))
    return pt.Trainer(prog, pt.optimizer.Adagrad(lr), loss_name="loss", fetch_list=["loss"],
                      place=dev).startup(seed, sample, params=params)


def _families(kernels):
    """Device us by kernel family of a ``_profile_dispatch`` kernel table."""
    out = dict.fromkeys([f for f, _ in DEEPFM_FAMILIES] + ["other"], 0.0)
    for key, (_, us) in kernels.items():
        fam = next((f for f, keys in DEEPFM_FAMILIES if any(k in key for k in keys)), "other")
        out[fam] += us
    return out


def deepfm_parity(dev, seed):
    """(a) f32 bench_deepfm, card against CPU from the card's initial params,
    DEEPFM_PARITY_STEPS Adagrad steps."""
    import numpy as np

    feeds = _deepfm_feeds(DEEPFM["sparse_feature_dim"])
    card = _deepfm_trainer(dev, DEEPFM["sparse_feature_dim"], feeds[0], seed)
    p0 = {k: v.detach().cpu().clone() for k, v in card.scope.params.items()}
    host = _deepfm_trainer("cpu", DEEPFM["sparse_feature_dim"], feeds[0], params=p0)
    lc, lh, grads = [], [], {}
    for i in range(DEEPFM_PARITY_STEPS):
        lc.append(float(card.step(feeds[i % DEEPFM_FEEDS])["loss"]))
        lh.append(float(host.step(feeds[i % DEEPFM_FEEDS])["loss"]))
        if i == 0:
            grads = {k: _rel_l2(p.grad.cpu(), host.scope.params[k].grad)
                     for k, p in card.scope.params.items()}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    moves = {k: _rel_l2(p.detach().cpu() - p0[k], host.scope.params[k].detach() - p0[k])
             for k, p in card.scope.params.items()}
    say(f"deepfm parity f32 card - cpu, bench_deepfm's config, {DEEPFM_PARITY_STEPS} "
        f"Adagrad({DEEPFM_LR}) steps from the same params: losses {lc} (cpu {lh}), max rel "
        f"{loss_rel:.3g} (tol {DEEPFM_LOSS_TOL}); step-1 grads relative L2 by param "
        f"{ {k: f'{v:.3g}' for k, v in grads.items()} } (tol {DEEPFM_GRAD_TOL}); the params' "
        f"moves over the steps, relative L2 by param "
        f"{ {k: f'{v:.3g}' for k, v in moves.items()} } (tol {DEEPFM_MOVE_TOL})")
    check(all(np.isfinite(lc)), "deepfm parity: a loss is not finite")
    check(loss_rel <= DEEPFM_LOSS_TOL, "deepfm parity: losses differ between card and CPU")
    check(max(grads.values()) <= DEEPFM_GRAD_TOL,
          "deepfm parity: step-1 grads differ between card and CPU")
    check(max(moves.values()) <= DEEPFM_MOVE_TOL,
          "deepfm parity: the params moved differently on card and CPU")


def deepfm_timed(dev, seed, card_name, dim, path):
    """(b)/(c) bench_deepfm at ``dim`` rows a field: DEEPFM_WARMUP warm-up and
    DEEPFM_STEPS timed steps eager, then the same steps captured through
    run_steps at K=DEEPFM_K from the same state, bit-equal; the readings.
    Returns (the eager trainer, its feeds on the card, readings)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import flops

    feeds = _deepfm_feeds(dim)
    t0 = time.perf_counter()
    eager = _deepfm_trainer(dev, dim, feeds[0], seed)
    fused = _deepfm_trainer(dev, dim, feeds[0], params=eager.scope.params)
    startup_s = time.perf_counter() - t0
    staged = [eager._put_feed(f) for f in feeds]
    for i in range(DEEPFM_WARMUP):
        eager.step(staged[i % DEEPFM_FEEDS])
        fused.step(staged[i % DEEPFM_FEEDS])
    order = [(DEEPFM_WARMUP + i) % DEEPFM_FEEDS for i in range(DEEPFM_K)]
    stacked = fused._put_feed(pt.data.stack_batches([feeds[i] for i in order]))
    dispatches = DEEPFM_STEPS // DEEPFM_K

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eager_losses = [eager.step(staged[(DEEPFM_WARMUP + i) % DEEPFM_FEEDS])["loss"]
                    for i in range(DEEPFM_STEPS)]
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / DEEPFM_STEPS * 1e3
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [fused.run_steps(stacked)["loss"]]  # captures, then replays K steps
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs += [fused.run_steps(stacked)["loss"] for _ in range(dispatches - 1)]
    torch.cuda.synchronize()
    captured_ms = (time.perf_counter() - t0) / ((dispatches - 1) * DEEPFM_K) * 1e3
    captured_peak = torch.cuda.max_memory_allocated() / 1e9
    same_losses = _bits_equal(torch.stack(eager_losses), torch.cat(outs))
    differ = _states_differ(_state_of(eager), _state_of(fused))
    losses = torch.stack(eager_losses).cpu().numpy()

    readings = {}
    for name, fn in (("eager", lambda: [eager.step(staged[i]) for i in order]),
                     ("captured", lambda: fused.run_steps(stacked))):
        wall, dev_us, n_ops, kernels = _profile_dispatch(fn)
        readings[name] = (wall / DEEPFM_K, dev_us / 1e3 / DEEPFM_K, n_ops / DEEPFM_K,
                          _families(kernels), sorted(kernels.items(), key=lambda kv: -kv[1][1]))
    tflop = flops.deepfm_train_flops(DEEPFM_BATCH, DEEPFM["num_sparse_fields"],
                                     DEEPFM["embedding_size"], DEEPFM["num_dense"],
                                     DEEPFM["hidden_dims"]) / 1e12
    tables = ("deepfm_0/fm_w1/w", "deepfm_0/fm_v/w")
    table_elems = sum(eager.scope.params[k].numel() for k in tables)
    other_elems = sum(p.numel() for k, p in eager.scope.params.items() if k not in tables)
    feed_bytes = sum(v.numel() * v.element_size() for v in staged[0].values())
    # the least a dense step moves: each param's grad written once, Adagrad
    # reading p, g and m and writing p and m, all f32; the feed read once
    bound_bytes = 6 * 4 * (table_elems + other_elems) + feed_bytes
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    say(f"deepfm {path} ({card_name}): {DEEPFM['num_sparse_fields']} fields x {dim} rows "
        f"({table_elems // (DEEPFM['embedding_size'] + 1)} table rows, "
        f"{table_elems * 4 / 1e9:.3f} GB of tables, as much again of Adagrad moments), "
        f"b={DEEPFM_BATCH}, Adagrad({DEEPFM_LR}), startup {startup_s:.2f} s; "
        f"{DEEPFM_WARMUP} warm-up + {DEEPFM_STEPS} steps eager: {eager_ms:.4f} ms per step, "
        f"{DEEPFM_BATCH / eager_ms * 1e3:.1f} samples/s, {tflop / eager_ms * 1e3:.3f} "
        f"TFLOP/s, peak memory {eager_peak:.3f} GB; the same steps captured K={DEEPFM_K} "
        f"(capture and first dispatch {capture_s:.2f} s): {captured_ms:.4f} ms per step, "
        f"{DEEPFM_BATCH / captured_ms * 1e3:.1f} samples/s, {tflop / captured_ms * 1e3:.3f} "
        f"TFLOP/s ({tflop * 1e3:.3f} GFLOP a step by core/flops.py: the MLP tower and "
        f"the dense head; the gathers, their scatter-add backward and the FM term are "
        f"left out), peak memory {captured_peak:.3f} GB; losses bit-equal {same_losses}, "
        f"state leaves differing {differ}; losses {losses[0]:.5f} -> {losses[-1]:.5f}")
    for name, (wall, dms, ops, fam, top) in readings.items():
        if dms == 0:
            say(f"deepfm {path} {name} profile: not measured (no device time seen)")
            continue
        say(f"deepfm {path} {name} profile ({card_name}): {wall:.4f} ms a step, "
            f"{dms:.4f} ms of device time ({100 * dms / wall:.1f}% busy), {ops:.0f} device "
            f"operations a step; by family "
            + ", ".join(f"{k} {v / 1e3 / DEEPFM_K:.4f} ms" for k, v in fam.items()))
        for key, (calls, us) in top[:DEEPFM_TOP_OPS]:
            say(f"  deepfm {path} {name} top op {us / 1e3 / DEEPFM_K:8.4f} ms a step "
                f"{calls // DEEPFM_K:4d} calls  {key[:110]}")
    dev_captured = readings["captured"][1]
    say(f"deepfm {path} bytes bound ({card_name}): {bound_bytes / 1e9:.4f} GB a step "
        f"(6 f32 passes over {table_elems + other_elems} params: the grad written, "
        f"Adagrad's p, g, m read and p, m written) -> {bound_ms:.4f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; captured step {captured_ms:.4f} ms ("
        + (f"{dev_captured:.4f} ms of device time, {100 * bound_ms / dev_captured:.1f}% "
           f"of the bound reached)" if dev_captured else "device time not measured)"))
    check(bool(np.isfinite(losses).all()), f"deepfm {path}: a loss is not finite")
    check(same_losses and not differ, f"deepfm {path}: captured steps differ from eager ones")
    check(fused._fused is not None and fused._fused.captures == 1,
          f"deepfm {path}: run_steps did not capture its step once")
    del fused
    return eager, staged, {"eager_ms": eager_ms, "captured_ms": captured_ms,
                           "device_ms": dev_captured, "bound_ms": bound_ms}


def deepfm_fit_and_resume(dev, seed, card_name, trainer, staged, tmp):
    """(d) fit(steps_per_dispatch=DEEPFM_K) over datasets.ctr at (b)'s widths;
    save_trainer/load_trainer of (b)'s trainer, the resumed steps bit-equal
    to the uninterrupted ones."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import data
    from paddle_tpu_torch import io as pio

    names = ["dense", "sparse_ids", "label"]
    reader = data.batch(data.map_readers(lambda s: (s[0], s[1], np.array([s[2]])),
                                         data.datasets.ctr("train")), DEEPFM_FIT_BATCH)
    sample = data.DataFeeder(names).feed(next(iter(reader())))
    tr = _deepfm_trainer(dev, DEEPFM["sparse_feature_dim"], sample, seed)
    losses, sizes = [], []
    t0 = time.perf_counter()
    pt.fit(tr, reader, DEEPFM_FIT_EPOCHS, names, steps_per_dispatch=DEEPFM_K,
           event_handler=lambda e: (losses.append(e.metrics["loss"].reshape(-1)),
                                    sizes.append(e.num_steps))
           if e.kind == "end_step" else None)
    fit_s = time.perf_counter() - t0
    losses = torch.cat(losses).cpu().numpy()
    epoch = len(losses) // DEEPFM_FIT_EPOCHS
    first, last = float(losses[:epoch].mean()), float(losses[-epoch:].mean())
    say(f"deepfm (d) fit({DEEPFM_FIT_EPOCHS} epochs of synthetic ctr, b={DEEPFM_FIT_BATCH}, "
        f"steps_per_dispatch={DEEPFM_K}, prefetch on): {len(losses)} steps in "
        f"{len(sizes)} dispatches {sorted(set(sizes))}, {fit_s:.2f} s; mean loss first "
        f"epoch {first:.5f}, last {last:.5f} (want below half)")
    check(bool(np.isfinite(losses).all()), "deepfm fit: a loss is not finite")
    check(max(sizes) == DEEPFM_K, "deepfm fit: no fused dispatch ran")
    check(last < 0.5 * first, "deepfm fit: the loss did not fall")

    ckpt = os.path.join(tmp, "deepfm")
    t0 = time.perf_counter()
    pio.save_trainer(ckpt, trainer)
    save_s = time.perf_counter() - t0
    whole = [trainer.step(staged[i % DEEPFM_FEEDS])["loss"] for i in range(DEEPFM_RESUME_STEPS)]
    resumed = _deepfm_trainer(dev, DEEPFM["sparse_feature_dim"], sample, seed + 1)
    t0 = time.perf_counter()
    pio.load_trainer(ckpt, resumed)
    load_s = time.perf_counter() - t0
    again = [resumed.step(staged[i % DEEPFM_FEEDS])["loss"] for i in range(DEEPFM_RESUME_STEPS)]
    same = _bits_equal(torch.stack(whole), torch.stack(again))
    differ = _states_differ(_state_of(trainer), _state_of(resumed))
    say(f"deepfm (d) save_trainer {save_s:.2f} s, load_trainer {load_s:.2f} s; "
        f"{DEEPFM_RESUME_STEPS} resumed steps against the uninterrupted ones: losses "
        f"bit-equal {same}, state leaves differing {differ}")
    check(same and not differ, "deepfm resume: the resumed steps differ")


def recommender_on_card(dev, seed, card_name):
    """(e) the book recommender at its default widths on synthetic
    MovieLens (batch REC_BATCH, Adam(REC_LR)), REC_EPOCHS epochs eager and
    captured (K=DEEPFM_K) from the same params, bit for bit; the loss falls."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import data
    from paddle_tpu_torch.models import recommender

    feeder = data.DataFeeder(REC_NAMES)
    batches = [feeder.feed(b) for b in data.batch(data.datasets.movielens("train"),
                                                  REC_BATCH, drop_last=True)()]

    def trainer(params=None):
        return pt.Trainer(pt.build(recommender.make_model()), pt.optimizer.Adam(REC_LR),
                          loss_name="loss", fetch_list=["loss", "pred"],
                          place=dev).startup(seed, batches[0], params=params)

    eager = trainer()
    fused = trainer(eager.scope.params)
    staged = [eager._put_feed(b) for b in batches]
    chunks = [fused._put_feed(pt.data.stack_batches(batches[i:i + DEEPFM_K]))
              for i in range(0, len(batches) - DEEPFM_K + 1, DEEPFM_K)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch = staged[:len(chunks) * DEEPFM_K]
    le = [eager.step(b)["loss"] for _ in range(REC_EPOCHS) for b in epoch]
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / len(le) * 1e3
    t0 = time.perf_counter()
    lf = [fused.run_steps(c)["loss"] for _ in range(REC_EPOCHS) for c in chunks]
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) / len(le) * 1e3
    same = _bits_equal(torch.stack(le), torch.cat(lf))
    differ = _states_differ(_state_of(eager), _state_of(fused))
    losses = torch.stack(le).cpu().numpy()
    n = len(chunks) * DEEPFM_K
    first, last = float(losses[:n].mean()), float(losses[-n:].mean())
    n_params = sum(p.numel() for p in eager.scope.params.values())
    say(f"recommender (e) ({card_name}): default widths ({n_params} params), "
        f"b={REC_BATCH}, Adam({REC_LR}), {REC_EPOCHS} epochs of {n} steps: eager "
        f"{eager_ms:.4f} ms per step, captured K={DEEPFM_K} {fused_ms:.4f} ms per step "
        f"(the capture included); losses bit-equal {same}, state leaves differing {differ}; "
        f"mean loss first epoch {first:.5f}, last {last:.5f} (want below 0.7 of it)")
    check(bool(np.isfinite(losses).all()), "recommender: a loss is not finite")
    check(same and not differ, "recommender: captured steps differ from eager ones")
    check(last < 0.7 * first, "recommender: the loss did not fall")


def _update_err(got, want, old):
    """How far a new param ``got`` lies from ``want``, over the largest
    update ``want − old``, after one f32 rounding of the new value (2^-23 of
    its magnitude: an update far below the param's size, as LarsMomentum's,
    rounds to a neighbouring float when it differs in its last bits)."""
    slack = (got - want).abs() - 2.0 ** -23 * want.abs()
    return float(slack.clamp_min(0).max() / (want - old).abs().max().clamp_min(1e-30))


def optimizers_on_card(dev, seed, card_name, table_trainer, table_feed):
    """(f) the optimizers new in this slice on phase 8's MNIST MLP, card
    against CPU; Lamb and LarsMomentum captured against eager; the row-wise
    Adagrad and lazy Adam on the 10.4 M-row table, card against CPU and
    card against card."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import sparse
    from paddle_tpu_torch.models import mnist

    o = pt.optimizer
    makers = {
        "LarsMomentum": lambda: o.LarsMomentum(OPT_LR * 10, lars_coeff=0.01),
        "Adagrad": lambda: o.Adagrad(OPT_LR), "Adamax": lambda: o.Adamax(OPT_LR),
        "DecayedAdagrad": lambda: o.DecayedAdagrad(OPT_LR),
        "Adadelta": lambda: o.Adadelta(1.0),
        "RMSProp centered": lambda: o.RMSProp(OPT_LR, momentum=0.5, centered=True),
        # l1 and l2 0 (the CPU tests hold their branches against the JAX package)
        "Ftrl": lambda: o.Ftrl(OPT_LR * 10),
        "Ftrl lr_power -0.3": lambda: o.Ftrl(OPT_LR * 10, lr_power=-0.3),
        "Lamb": lambda: o.Lamb(OPT_LR), "Adam bf16 state": lambda: o.Adam(OPT_LR)}
    feeds = _mnist_feeds()

    def trainer(name, place, params=None):
        strategy = pt.DistStrategy(opt_state_dtype="bfloat16") if "bf16" in name else None
        return pt.Trainer(pt.build(mnist.mlp), makers[name](), loss_name="loss",
                          fetch_list=["loss"], place=place,
                          strategy=strategy).startup(seed, feeds[0], params=params)

    def on_cpu(tree):
        if isinstance(tree, dict):
            return {k: on_cpu(v) for k, v in tree.items()}
        return tree.detach().cpu()

    worst = {}
    for name in makers:
        card = trainer(name, dev)
        p0 = on_cpu(card.scope.params)
        host = trainer(name, "cpu", p0)
        lc = [float(card.step(feeds[i])["loss"]) for i in range(OPT_STEPS)]
        lh = [float(host.step(feeds[i])["loss"]) for i in range(OPT_STEPS)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        perr = max(float((card.scope.params[k].detach().cpu() - p.detach()).abs().max())
                   for k, p in host.scope.params.items())
        moves = max(_rel_l2(card.scope.params[k].detach().cpu() - p0[k], p.detach() - p0[k])
                    for k, p in host.scope.params.items())
        # the optimizer alone: one more update from the card's params, last
        # grads and state, on the card and on the CPU
        params = {k: p.detach() for k, p in card.scope.params.items()}
        grads = {k: p.grad for k, p in card.scope.params.items()}
        with torch.no_grad():
            new_c, _ = card.optimizer.update(grads, card.scope.opt_state, params,
                                             card.program.param_info)
            new_h, _ = makers[name]().set_state_dtype(card.optimizer.state_dtype).update(
                on_cpu(grads), on_cpu(card.scope.opt_state), on_cpu(params),
                card.program.param_info)
        upd = max(_update_err(new_c[k].cpu(), new_h[k], params[k].cpu()) for k in params)
        worst[name] = (rel, perr, moves, upd)
        check(all(np.isfinite(lc)), f"optimizers: {name} gave a non-finite loss")
        check(rel <= MNIST_LOSS_TOL and moves <= DEEPFM_MOVE_TOL and upd <= OPT_UPDATE_TOL,
              f"optimizers: {name} differs between card and CPU ({rel:.3g}, {moves:.3g}, "
              f"{upd:.3g})")
        if "bf16" in name:
            dtypes = {v.dtype for a in card.scope.opt_state["accums"].values()
                      for v in a.values()}
            check(dtypes == {torch.bfloat16}, f"optimizers: {name} stored {dtypes}")
    say(f"optimizers (f): {OPT_STEPS} steps of MNIST MLP b={MNIST_BATCH}, card against CPU "
        f"from the same params; by optimizer (max rel loss (tol {MNIST_LOSS_TOL}), max abs "
        f"param (reported), the params' moves relative L2 (tol {DEEPFM_MOVE_TOL}), one "
        f"update from the same params, grads and state, max abs beyond one rounding over "
        f"the largest update (tol {OPT_UPDATE_TOL})): "
        + ", ".join(f"{k} ({a:.3g}, {b:.3g}, {c:.3g}, {d:.3g})"
                    for k, (a, b, c, d) in worst.items()))

    for name in ("Lamb", "LarsMomentum"):
        eager = trainer(name, dev)
        fused = trainer(name, dev, eager.scope.params)
        stacked = fused._put_feed(pt.data.stack_batches(feeds[:DEEPFM_K]))
        le = torch.stack([eager.step(f)["loss"] for f in feeds[:DEEPFM_K]])
        lf = fused.run_steps(stacked)["loss"]
        same = _bits_equal(le, lf)
        differ = _states_differ(_state_of(eager), _state_of(fused))
        say(f"optimizers (f): {name} captured K={DEEPFM_K} against eager: losses bit-equal "
            f"{same}, state leaves differing {differ}")
        check(same and not differ, f"optimizers: captured {name} differs from eager")

    # the row-wise updates on the 10.4 M-row factor table, one batch's ids
    table = table_trainer.scope.params["deepfm_0/fm_v/w"].detach()
    moment = table_trainer.scope.opt_state["accums"]["deepfm_0/fm_v/w"]["moment"]
    f, dim = DEEPFM["num_sparse_fields"], DEEPFM_10M_DIM
    rows = (table_feed["sparse_ids"].long()
            + torch.arange(f, device=table.device) * dim).reshape(-1).to(torch.int32)
    vals = torch.from_numpy(np.random.RandomState(seed).randn(
        rows.numel(), table.shape[1]).astype(np.float32) * 1e-3).to(table.device)
    sr = sparse.SelectedRows(rows, vals, table.shape[0])
    sr_cpu = sparse.SelectedRows(rows.cpu(), vals.cpu(), table.shape[0])
    runs = {
        "apply_adagrad": (lambda: sparse.apply_adagrad(table, moment, sr, DEEPFM_LR),
                          lambda: sparse.apply_adagrad(table.cpu(), moment.cpu(), sr_cpu,
                                                       DEEPFM_LR)),
        "apply_adam_lazy": (lambda: sparse.apply_adam_lazy(table, moment * 1e-3, moment, sr,
                                                           1e-3, 3),
                            lambda: sparse.apply_adam_lazy(table.cpu(), moment.cpu() * 1e-3,
                                                           moment.cpu(), sr_cpu, 1e-3, 3))}
    distinct = int(torch.unique(rows).numel())
    for name, (on_card, on_cpu) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a read back to the host raises
        try:
            a = on_card()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        b = on_card()
        twice = all(_bits_equal(x, y) for x, y in zip(a, b))
        host = on_cpu()
        err = max(float((x.cpu() - y).abs().max() / y.abs().max().clamp_min(1e-30))
                  for x, y in zip(a, host))
        moved = int((a[0] != table).any(dim=1).sum())
        ms = device_ms(on_card, 5)
        say(f"optimizers (f) sparse.{name} ({card_name}): {rows.numel()} ids "
            f"({distinct} distinct) into {table.shape[0]} rows x {table.shape[1]}: "
            f"{moved} rows moved, no read back to the host, two card runs bit-equal "
            f"{twice}, card against CPU max "
            f"abs {err:.3g} of the largest value (tol {SPARSE_TOL}); {ms:.4f} ms on the "
            f"card (out of place: each result a new full-size tensor)")
        check(twice, f"sparse.{name}: two card runs differ")
        check(moved == distinct, f"sparse.{name}: {moved} rows moved, want {distinct}")
        check(err <= SPARSE_TOL, f"sparse.{name}: card and CPU differ")
        del a, b, host


def phase_deepfm(dev, seed, card_name):
    """Phase 15: DeepFM at bench_deepfm's and bench_deepfm_10m's configs,
    the recommender and the rest of the optimizers, (a)-(f). The path runs
    no hand kernel: the launch counts, zeroed just before it, must read 0
    after it; returns them."""
    import gc
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    _zero_launch_counts(fa)
    # ---- the main path, as a user drives it
    with tempfile.TemporaryDirectory() as tmp:
        deepfm_parity(dev, seed)
        trainer, staged, small = deepfm_timed(dev, seed, card_name,
                                              DEEPFM["sparse_feature_dim"], "(b)")
        deepfm_fit_and_resume(dev, seed, card_name, trainer, staged, tmp)
        del trainer, staged
        gc.collect()
        torch.cuda.empty_cache()
        big_trainer, big_staged, big = deepfm_timed(dev, seed, card_name, DEEPFM_10M_DIM,
                                                    "(c) 10m")
        recommender_on_card(dev, seed, card_name)
        optimizers_on_card(dev, seed, card_name, big_trainer, big_staged[0])
    launches = _launch_counts(fa)
    # ---- end of the main path
    del big_trainer, big_staged
    gc.collect()
    torch.cuda.empty_cache()
    READINGS["deepfm"], READINGS["deepfm_10m"] = small, big
    say(f"phase 15 took {time.perf_counter() - t_phase:.1f} s; hand-kernel launches on the "
        f"DeepFM paths {launches} (they run none)")
    check(all(n == 0 for n in launches.values()), "deepfm: a flash kernel launched")
    return launches


# -- phase 16: the image zoo (VGG-16, AlexNet, GoogLeNet, SE-ResNeXt-50) ------


def _zoo_model(name, class_num):
    """The program function of a zoo net, from the port's models."""
    from paddle_tpu_torch.models import convnets, vgg
    return {"vgg16": lambda: vgg.make_model(depth=16, class_num=class_num),
            "alexnet": lambda: convnets.make_alexnet(class_num=class_num),
            "googlenet": lambda: convnets.make_googlenet(class_num=class_num),
            "se_resnext50": lambda: convnets.make_se_resnext(depth=50, class_num=class_num),
            }[name]()


def _zoo_fwd_flops(name, size, class_num):
    """Forward FLOPs of one image, by the port's core/flops.py."""
    from paddle_tpu_torch.core import flops
    return {"vgg16": lambda: flops.vgg_fwd_flops(16, size, class_num),
            "alexnet": lambda: flops.alexnet_fwd_flops(size, class_num),
            "googlenet": lambda: flops.googlenet_fwd_flops(size, class_num),
            "se_resnext50": lambda: flops.se_resnext_fwd_flops(50, size, class_num),
            }[name]()


@contextlib.contextmanager
def _dropout_off():
    """The port's dropout replaced by the identity (the zoo's f32 parity
    runs, as the CPU tests hold them)."""
    from paddle_tpu_torch import layers
    inner = layers.dropout
    layers.dropout = lambda x, *a, **k: x
    try:
        yield
    finally:
        layers.dropout = inner


def zoo_parity(dev, seed, card_name):
    """(a) Each net in f32 NHWC at ZOO_PARITY's small size, dropout off,
    card against CPU from the CPU's initial params: eval logits, then the
    train-mode loss, logits and every grad."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import layout_mode

    parts = []
    for name, (size, batch, grad_tol) in ZOO_PARITY.items():
        with layout_mode("NHWC"):
            prog = pt.build(_zoo_model(name, ZOO_PARITY_CLASSES))
        rng = np.random.RandomState(seed)
        feed = {"image": rng.randn(batch, size, size, 3).astype(np.float32),
                "label": (np.arange(batch) % ZOO_PARITY_CLASSES).reshape(batch, 1)
                .astype(np.int64)}
        params, state = prog.init(seed, place="cpu", **feed)
        out = {}
        for where in ("cpu", dev):
            p = {k: v.detach().to(where).requires_grad_(True) for k, v in params.items()}
            st = {k: v.to(where) for k, v in state.items()}
            with torch.no_grad(), pt.amp_guard("float32"):
                ev = prog.apply(p, st, place=where, **feed)[0]["logits"]
            with _dropout_off(), pt.amp_guard("float32"):
                tr, _ = prog.apply(p, st, training=True, place=where, **feed)
            tr["loss"].backward()
            out[where] = (ev.cpu(), tr["loss"].detach().cpu(), tr["logits"].detach().cpu(),
                          {k: v.grad.cpu() for k, v in p.items()})
        (ev_h, loss_h, lg_h, g_h), (ev_c, loss_c, lg_c, g_c) = out["cpu"], out[dev]
        errs = (_rel_max(ev_c, ev_h), float((loss_c - loss_h).abs() / loss_h.abs()),
                _rel_max(lg_c, lg_h),
                float(torch.sqrt(sum(((g_c[k] - g_h[k]) ** 2).sum() for k in g_h)
                                 / sum((g_h[k] ** 2).sum() for k in g_h))))
        parts.append(f"{name} {size}x{size} b={batch}: eval logits {errs[0]:.3g}, loss "
                     f"{errs[1]:.3g}, logits {errs[2]:.3g}, grads rel L2 {errs[3]:.3g} "
                     f"(tol {grad_tol})")
        check(errs[0] <= ZOO_OUT_TOL and errs[1] <= ZOO_OUT_TOL and errs[2] <= ZOO_OUT_TOL
              and errs[3] <= grad_tol, f"zoo parity {name}: card against CPU {errs}")
    say(f"zoo parity ({card_name}): f32 NHWC, dropout off, card against CPU from the same "
        f"params (outputs tol {ZOO_OUT_TOL}): " + "; ".join(parts))


def _grouped_conv_ms(batch, image_size):
    """Device ms of SE-ResNeXt-50's grouped 3x3 convs, forward and both
    grads, as one training step runs them (bf16, channels-last), each
    block's at its own shape."""
    import torch
    import torch.nn.functional as F
    s = image_size // 4  # the stem's stride 2 and the max pool's
    total = 0.0
    for stage, blocks in enumerate((3, 4, 6, 3)):
        filters = 128 * 2 ** stage
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            x = torch.randn(batch, filters, s, s, device="cuda", dtype=torch.bfloat16) \
                .to(memory_format=torch.channels_last).requires_grad_(True)
            w = torch.randn(filters, filters // 32, 3, 3, device="cuda", dtype=torch.bfloat16) \
                .to(memory_format=torch.channels_last).requires_grad_(True)
            out = F.conv2d(x, w, stride=stride, padding=1, groups=32)
            g = torch.randn_like(out)
            total += device_ms(lambda: torch.autograd.grad(
                F.conv2d(x, w, stride=stride, padding=1, groups=32), (x, w), g), 5)
            s //= stride
    return total


def zoo_path(dev, seed, card_name, name):
    """(b) One net as bench.py trains it: eager steps, then the same steps
    captured (``run_steps``, K=ZOO_K) from the same params, bit for bit
    (losses, params, Momentum's velocities, batch-norm state); ms a step
    eager against captured in turns, images/s, TFLOP/s by core/flops.py,
    peak memory, the busy share of profiled eager steps and of a profiled
    dispatch, and a profiled eager step's top op families."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import flops
    from paddle_tpu_torch.framework import layout_mode

    t_path = time.perf_counter()
    batch, size, k = ZOO[name], ZOO_IMAGE, ZOO_K
    feeds = _resnet_feeds(np.random.RandomState(0), k, batch, size, "NHWC")
    with layout_mode("NHWC"):
        prog = pt.build(_zoo_model(name, RESNET["class_num"]))

    def make(params):
        return pt.Trainer(prog, pt.optimizer.Momentum(ZOO_LR, ZOO_MOMENTUM), loss_name="loss",
                          fetch_list=["loss"], place=dev).startup(seed, feeds[0], params=params)

    t0 = time.perf_counter()
    eager = make(None)
    startup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in eager.scope.params.values())
    params0 = _params_of(eager)
    staged = _on_card(feeds, dev)
    losses_eager = torch.stack([eager.step(f)["loss"] for f in staged])
    state_eager = _state_of(eager)
    fused = make(params0)
    stacked = fused._put_feed(pt.data.stack_batches(feeds))
    outs = fused.run_steps(stacked)
    differ = _states_differ(state_eager, _state_of(fused))
    same = _bits_equal(losses_eager, outs["loss"]) and not differ
    del state_eager
    times, peaks = _eager_against_captured(eager, fused, staged, stacked, ZOO_DISPATCHES, k)
    # k profiled eager steps and one profiled dispatch of k; the families and
    # top ops are the dispatch's (the eager steps run the same kernels)
    prof = {n: _profile_dispatch(fn) for n, fn in (
        ("eager", lambda: [eager.step(f) for f in staged]),
        ("captured", lambda: fused.run_steps(stacked)))}
    busy_clause = "; profiled {} steps: ".format(k) + ", ".join(
        f"{n} busy {100 * dev / 1e3 / wall:.1f}% ({dev / 1e3 / k:.2f} ms, {ops / k:.0f} "
        f"operations a step)" if dev else f"{n} busy: not measured"
        for n, (wall, dev, ops, _) in prof.items())
    dev_ms = prof["captured"][1] / 1e3 / k
    families = dict.fromkeys([f for f, _ in RESNET_FAMILIES] + ["other"], 0.0)
    for key, (_, us) in prof["captured"][3].items():
        families[next((f for f, keys in RESNET_FAMILIES if any(t in key for t in keys)),
                      "other")] += us / 1e3 / k
    rows = sorted(((us / k, calls // k, key) for key, (calls, us) in prof["captured"][3].items()),
                  reverse=True)
    grouped = ""
    if name == "se_resnext50" and dev_ms:
        g_ms = _grouped_conv_ms(batch, size)
        grouped = (f"; its 16 grouped 3x3 convs (32 groups, forward and grads, timed alone at "
                   f"the step's shapes) {g_ms:.3f} device ms, {100 * g_ms / dev_ms:.1f}% of a "
                   "captured step's device time")
    ms = {n: float(np.mean(v)) for n, v in times.items()}
    tflop = flops.convnet_train_flops(_zoo_fwd_flops(name, size, RESNET["class_num"]),
                                      batch) / 1e12
    fam = (", ".join(f"{f} {100 * v / dev_ms:.1f}%" for f, v in
                     sorted(families.items(), key=lambda kv: -kv[1]) if v)
           if dev_ms else "not measured")
    top = ", ".join(f"{key[:60]} x{calls} {us / 1e3:.3f} ms" for us, calls, key in rows[:ZOO_TOP_OPS])
    say(f"zoo {name} ({card_name}): bf16 NHWC {size}x{size}, b={batch}, "
        f"Momentum({ZOO_LR}, {ZOO_MOMENTUM}), {n_params} params, startup {startup_s:.2f} s; "
        f"losses {[round(x, 5) for x in losses_eager.tolist()]}; run_steps(K={k}) against "
        f"{k} step() calls from one state: losses and state bit-equal {same}"
        f"{'' if same else f' (differing leaves {differ[:5]})'}; eager "
        f"{[round(t, 3) for t in times['eager']]} ms a step (mean {ms['eager']:.3f}, "
        f"{batch / ms['eager'] * 1e3:.1f} images/s, {tflop / ms['eager'] * 1e3:.1f} TFLOP/s), "
        f"captured {[round(t, 3) for t in times['captured']]} (mean {ms['captured']:.3f}, "
        f"{batch / ms['captured'] * 1e3:.1f} images/s, {tflop / ms['captured'] * 1e3:.1f} "
        f"TFLOP/s, {ms['eager'] / ms['captured']:.2f}x) at {tflop:.3f} TFLOP a step; peak "
        f"memory eager {peaks['eager']:.3f} GB, captured {peaks['captured']:.3f} GB"
        f"{busy_clause}; a captured step's device time by family: {fam}; top ops a step: "
        f"{top}{grouped}; {time.perf_counter() - t_path:.1f} s")
    READINGS[f"zoo_{name}"] = {"eager_ms": ms["eager"], "captured_ms": ms["captured"],
                               "tflop": tflop, "captured_device_ms": dev_ms}
    check(bool(torch.isfinite(losses_eager).all()), f"zoo {name}: a loss is not finite")
    check(same, f"zoo {name}: run_steps differs from step()")
    del eager, fused, staged, stacked
    gc.collect()
    torch.cuda.empty_cache()


def phase_zoo(dev, seed, card_name):
    """Phase 16: (a) the zoo's f32 parity, card against CPU; then the path
    a user drives, each net at bench.py's config eager and captured (b).
    The path runs no hand kernel: the launch counts, zeroed just before
    it, must read 0 after it; returns them."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    zoo_parity(dev, seed, card_name)
    _zero_launch_counts(fa)
    # ---- the main path, as a user drives it
    with pt.amp_guard("bfloat16"):
        for name in ZOO:
            zoo_path(dev, seed, card_name, name)
    launches = _launch_counts(fa)
    # ---- end of the main path
    torch.cuda.empty_cache()
    say(f"phase 16 took {time.perf_counter() - t_phase:.1f} s; hand-kernel launches on the "
        f"zoo paths {launches} (they run none)")
    check(all(n == 0 for n in launches.values()), "zoo: a flash kernel launched")
    return launches


# -- phase 17: the recurrent family (dynamic LSTM/GRU, sequence ops, the CRF) --


# bench.py's three recurrent rows, nothing cut: bench_lstm (:1775: vocab 10000,
# emb = hidden = 512, 2 layers, b=64, s=128, full lengths, Adam(1e-3)),
# bench_lstm_big (:1797: b=256, emb = hidden = 1280) and bench_seq2seq (:1804:
# b=128, s=30, emb 512, hidden 512, vocab 30000, Adam(1e-3), fetch_list=["loss"]),
# in f32 (the JAX default bench.py trains them in) with TF32 off; 4 feeds each
# from RandomState(0) as bench.py makes them. Each trains eagerly, then through
# run_steps (K=RNN_K) from the same params, bit for bit, then in turns.
RNN_PATHS = {
    "lstm": dict(model=dict(vocab_size=10000, emb_dim=512, hidden_dim=512, num_layers=2),
                 batch=64, seq=128),
    "lstm_big": dict(model=dict(vocab_size=10000, emb_dim=1280, hidden_dim=1280,
                                num_layers=2), batch=256, seq=128),
    "seq2seq": dict(model=dict(src_vocab=30000, trg_vocab=30000, emb_dim=512, hidden=512),
                    batch=128, seq=30),
}
RNN_LR, RNN_K, RNN_DISPATCHES, RNN_TOP_OPS = 1e-3, 4, 1, 6
# (a) f32 parity card against CPU at small widths, ragged lengths: each
# layer's outputs, last states and grads within RNN_TOL of the largest element
# (f32 GEMMs summed in another order through 12 steps of recurrence; 4.2e-7 on
# an H100); a train step's loss within RNN_TOL relative and its grads within
# RNN_GRAD_TOL relative L2 by param (a grad whose terms cancel, as the
# attention's projections' in seq2seq, amplifies the rounding: 1.39e-5 on an
# H100, PR 14 call 2); decoded ids equal exactly, beam scores within RNN_TOL;
# the sequence reductions at SEQ_ROWS rows bit-equal over two card runs and
# within RNN_TOL of the CPU's largest element, their grads within RNN_GRAD_TOL
# relative L2 (the softmax's grad y·(g − Σy·g) cancels: its worst element lay
# 4.11e-5 and 9.23e-5 of the largest from the CPU's in two calls, PR 14 calls
# 2-3, the CPU's own multi-threaded sums moving it).
RNN_SMALL = dict(b=4, t=12, d=16, h=32)
RNN_TOL, RNN_GRAD_TOL, SEQ_ROWS, SEQ_SEGMENTS, SEQ_DIM = 1e-5, 1e-4, 200_000, 1000, 64
# (e) bench_lstm's widths with lengths drawn from RNN_RAGGED
RNN_RAGGED = (16, 128)
# (f) the served decoder: make_decoder(beam 4, max_len 30) from (d)'s params
S2S_SERVE_ROWS, S2S_BEAM, S2S_MAX_LEN, S2S_CALLS = 8, 4, 30, 3


def _rnn_feeds(path, lengths=None):
    """bench_lstm's or bench_seq2seq's feeds (bench.py:1786-1790, :1818-1826):
    RNN_K batches from RandomState(0); ``lengths`` replaces bench_lstm's full
    sequence_length."""
    import numpy as np
    spec = RNN_PATHS[path]
    b, s = spec["batch"], spec["seq"]
    rng = np.random.RandomState(0)
    feeds = []
    for i in range(RNN_K):
        if path == "seq2seq":
            v = spec["model"]["src_vocab"]
            src = rng.randint(3, v, (b, s)).astype(np.int64)
            trg = np.zeros_like(src)
            trg[:, 0] = 1
            trg[:, 1:] = src[:, :-1]
            labels = np.concatenate([trg[:, 1:], np.full((b, 1), 2)], axis=1).astype(np.int64)
            feeds.append({"src_ids": src, "trg_ids": trg, "labels": labels,
                          "src_lengths": np.full((b,), s, np.int64)})
        else:
            v = spec["model"]["vocab_size"]
            feeds.append({"word_ids": rng.randint(0, v, (b, s)).astype(np.int64),
                          "label": rng.randint(0, 2, (b, 1)).astype(np.int64),
                          "sequence_length": np.full((b,), s, np.int64) if lengths is None
                          else lengths[i]})
    return feeds


def _rnn_trainer(path, dev, sample, seed=0, params=None):
    """bench.py's recurrent trainer: ``build(lstm/seq2seq.make_model(...))``
    and Adam(1e-3); seq2seq fetches the loss only, as bench_seq2seq."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import lstm, seq2seq
    module = seq2seq if path == "seq2seq" else lstm
    return pt.Trainer(pt.build(module.make_model(**RNN_PATHS[path]["model"])),
                      pt.optimizer.Adam(RNN_LR), loss_name="loss",
                      fetch_list=["loss"] if path == "seq2seq" else None,
                      place=dev).startup(seed, sample, params=params)


def _rnn_layer_parity(dev, seed):
    """(a) dynamic_lstm, dynamic_gru and dynamic_lstmp, forward and reverse,
    ragged lengths: outputs, last states and the grads of one weighted sum
    of them, card against CPU from the same params. Returns the worst
    errors by check."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.layers import rnn

    b, t, d, h = (RNN_SMALL[k] for k in "btdh")
    rng = np.random.RandomState(seed + 170)
    x = rng.randn(b, t, d).astype(np.float32)
    lens = np.array([t, 3, 7, 1][:b], np.int64)
    layers = {
        "dynamic_lstm": lambda x, l, rev: rnn.dynamic_lstm(x, h, l, is_reverse=rev,
                                                           forget_bias=1.0),
        "dynamic_gru": lambda x, l, rev: (rnn.dynamic_gru(x, h, l, is_reverse=rev),),
        "dynamic_lstmp": lambda x, l, rev: rnn.dynamic_lstmp(x, h, 8, l, is_reverse=rev,
                                                             proj_clip=0.5, cell_clip=2.0),
    }
    worst = {}
    for name, layer in layers.items():
        for rev in (False, True):
            prog = pt.build(lambda x, l, layer=layer, rev=rev: layer(x, l, rev))
            params, _ = prog.init(seed, torch.from_numpy(x), torch.from_numpy(lens),
                                  place="cpu")
            runs = []
            for where in ("cpu", dev):
                p = {k: v.detach().to(where).requires_grad_(True) for k, v in params.items()}
                xt = torch.from_numpy(x).to(where).requires_grad_(True)
                out, _ = prog.apply(p, {}, xt, torch.from_numpy(lens).to(where), place=where)
                leaves = [out[0], *out[1]] if len(out) == 2 else list(out)
                cots = [torch.from_numpy(np.random.RandomState(i).randn(*o.shape)
                                         .astype(np.float32)).to(where)
                        for i, o in enumerate(leaves)]
                sum((o * c).sum() for o, c in zip(leaves, cots)).backward()
                runs.append(([o.detach().cpu() for o in leaves],
                             [xt.grad.cpu()] + [p[k].grad.cpu() for k in sorted(p)]))
            (oc, gc), (od, gd) = runs
            worst[f"{name}{' reverse' if rev else ''}"] = (
                max(_rel_max(a, b) for a, b in zip(od, oc)),
                max(_rel_max(a, b) for a, b in zip(gd, gc)))
    return worst


RNN_PARITY_MODELS = {
    "lstm": dict(model=dict(vocab_size=100, emb_dim=16, hidden_dim=32, num_layers=2)),
    "seq2seq": dict(model=dict(src_vocab=60, trg_vocab=60, emb_dim=16, hidden=32)),
    "srl": dict(model=dict(vocab_size=80, num_labels=7, word_dim=8, hidden_dim=16, depth=3)),
    "word2vec": dict(model=dict(dict_size=100, emb_dim=8, hidden=32)),
}


def _rnn_parity_feed(name, rng):
    import numpy as np
    b, t = RNN_SMALL["b"], RNN_SMALL["t"]
    lens = np.array([t, 3, 7, 1][:b], np.int64)
    if name == "lstm":
        return {"word_ids": rng.randint(0, 100, (b, t)).astype(np.int64),
                "label": rng.randint(0, 2, (b, 1)).astype(np.int64), "sequence_length": lens}
    if name == "seq2seq":
        src = rng.randint(3, 60, (b, t)).astype(np.int64)
        trg = np.concatenate([np.ones((b, 1), np.int64), src[:, :-1]], axis=1)
        labels = np.concatenate([trg[:, 1:], np.full((b, 1), 2)], axis=1).astype(np.int64)
        return {"src_ids": src, "trg_ids": trg, "labels": labels, "src_lengths": lens}
    if name == "srl":
        return {"word_ids": rng.randint(0, 80, (b, t)).astype(np.int64),
                "mark_ids": rng.randint(0, 2, (b, t)).astype(np.int64),
                "label": rng.randint(0, 7, (b, t)).astype(np.int64), "lengths": lens}
    return {"context_ids": rng.randint(0, 100, (b, 4)).astype(np.int64),
            "label": rng.randint(0, 100, (b, 1)).astype(np.int64)}


def _rnn_model_parity(dev, seed):
    """(a) one Adam(1e-3) step of lstm, seq2seq, srl and word2vec, card
    against CPU from the same params: the loss and every param's grad; and
    seq2seq's beam-4 decode from the stepped params, ids equal. Returns
    ({model: (loss rel, worst grad rel L2, card loss)}, seq2seq's decode (ids
    equal, score error), srl's CRF decode equal)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import seq2seq, srl, word2vec, lstm

    modules = {"lstm": lstm, "seq2seq": seq2seq, "srl": srl, "word2vec": word2vec}
    errs, decode, decode_srl = {}, None, None
    for name, spec in RNN_PARITY_MODELS.items():
        feed = _rnn_parity_feed(name, np.random.RandomState(seed + 171))
        prog_of = lambda: pt.build(modules[name].make_model(**spec["model"]))  # noqa: E731
        card = pt.Trainer(prog_of(), pt.optimizer.Adam(RNN_LR), place=dev).startup(seed, feed)
        host = pt.Trainer(prog_of(), pt.optimizer.Adam(RNN_LR), place="cpu").startup(
            seed, feed, params=_host_tree(card.scope.params))
        lc, lh = float(card.step(feed)["loss"]), float(host.step(feed)["loss"])
        grads = {k: _rel_l2(p.grad.cpu(), host.scope.params[k].grad)
                 for k, p in card.scope.params.items()}
        errs[name] = (abs(lc - lh) / abs(lh), max(grads.values()), lc)
        if name == "seq2seq":
            dims = dict(spec["model"], max_len=10, beam_size=4)
            src = {k: feed[k] for k in ("src_ids", "src_lengths")}
            outs = []
            for where, tr in ((dev, card), ("cpu", host)):
                dec = pt.build(seq2seq.make_decoder(**dims))
                with torch.no_grad():
                    outs.append(dec.apply(tr.scope.params, {}, place=where, **src)[0])
            decode = (torch.equal(outs[0]["ids"].cpu(), outs[1]["ids"]),
                      _rel_max(outs[0]["scores"].cpu(), outs[1]["scores"]))
        if name == "srl":  # the CRF's Viterbi path from the stepped params' emissions
            decode_srl = torch.equal(card.eval(feed)["decoded"].cpu(),
                                     host.eval(feed)["decoded"])
    return errs, decode, decode_srl


def _crf_and_sequence_on_card(dev, seed):
    """(a) crf_decoding and crf_nll card against CPU; the sequence reductions
    (sum, average, max pools, softmax and their grads) over SEQ_ROWS rows in
    the padded layout's interleaved ids: two card runs bit-equal, within
    RNN_TOL of the CPU. Returns readings."""
    import numpy as np
    import torch
    from paddle_tpu_torch.layers import crf, sequence

    rng = np.random.RandomState(seed + 172)
    em = torch.from_numpy(rng.randn(16, 20, 9).astype(np.float32))
    tr = torch.from_numpy(rng.randn(11, 9).astype(np.float32))
    label = torch.from_numpy(rng.randint(0, 9, (16, 20)))
    lens = torch.from_numpy(rng.randint(1, 21, 16))
    ids_cpu = crf.crf_decoding(em, lens, tr)
    ids_card = crf.crf_decoding(em.to(dev), lens.to(dev), tr.to(dev))
    nll_err = _rel_max(crf.crf_nll(em.to(dev), label.to(dev), lens.to(dev), tr.to(dev)).cpu(),
                       crf.crf_nll(em, label, lens, tr))
    out = {"crf_ids_equal": torch.equal(ids_card.cpu(), ids_cpu), "crf_nll": nll_err}

    # the padded layout: SEQ_SEGMENTS rows of ragged lengths, tails given id b
    t = SEQ_ROWS // SEQ_SEGMENTS
    seq_lens = torch.from_numpy(rng.randint(0, t + 1, SEQ_SEGMENTS))
    padded = torch.from_numpy(rng.randn(SEQ_SEGMENTS, t, SEQ_DIM).astype(np.float32))
    flat, seg = sequence.sequence_unpad(padded, seq_lens)
    cot = torch.from_numpy(rng.randn(SEQ_SEGMENTS, SEQ_DIM).astype(np.float32))

    def run(where):
        x = flat.to(where).requires_grad_(True)
        res = {}
        for pool in ("sum", "average", "max"):
            y = sequence.sequence_pool(x, seg.to(where), SEQ_SEGMENTS, pool)
            g, = torch.autograd.grad((y * cot.to(where)).sum(), x)
            res[pool], res[pool + " grad"] = y.detach(), g
        y = sequence.sequence_softmax(x[:, 0], seg.to(where), SEQ_SEGMENTS)
        g, = torch.autograd.grad((y * x[:, 1].detach()).sum(), x)
        res["softmax"], res["softmax grad"] = y.detach(), g
        return res

    def err(name, got, want):  # an empty segment's max is -inf in both, or it is an error
        inf = torch.isinf(want)
        if not torch.equal(torch.isinf(got), inf):
            return float("inf")
        got, want = torch.where(inf, 0.0, got), torch.where(inf, 0.0, want)
        return _rel_l2(got, want) if name.endswith("grad") else _rel_max(got, want)

    a, b, host = run(dev), run(dev), run("cpu")
    out["seq_bits_equal"] = all(_bits_equal(a[k], b[k]) for k in a)
    out["seq_err"] = {k: err(k, a[k].cpu(), host[k]) for k in a}
    out["seq_rows"] = int(flat.shape[0])
    return out


def rnn_parity(dev, seed, card_name):
    """(a) f32 parity, card against CPU, at small widths."""
    t0 = time.perf_counter()
    layer = _rnn_layer_parity(dev, seed)
    models, decode, srl_decode = _rnn_model_parity(dev, seed)
    other = _crf_and_sequence_on_card(dev, seed)
    say(f"recurrent (a) f32 parity card - cpu ({card_name}), b={RNN_SMALL['b']}, "
        f"t={RNN_SMALL['t']}, lengths [12, 3, 7, 1]: layers (outputs and last states, grads) "
        "max error over the largest element "
        + ", ".join(f"{k} {o:.3g}, {g:.3g}" for k, (o, g) in layer.items())
        + f" (tol {RNN_TOL}); one Adam step (loss rel, worst grad rel L2): "
        + ", ".join(f"{k} {lr:.3g}, {gr:.3g} (loss {loss:.5f})"
                    for k, (lr, gr, loss) in models.items())
        + f" (tol {RNN_TOL}, grads {RNN_GRAD_TOL}); seq2seq beam-4 decode ids equal "
        f"{decode[0]}, scores {decode[1]:.3g}; srl's CRF decode equal {srl_decode}; "
        f"crf_decoding ids equal {other['crf_ids_equal']}, crf_nll {other['crf_nll']:.3g}; "
        "sequence ops over "
        f"{other['seq_rows']} rows ({SEQ_SEGMENTS} segments x {SEQ_DIM}, the padded "
        f"layout's interleaved ids): two card runs bit-equal {other['seq_bits_equal']}, card "
        "- cpu " + ", ".join(f"{k} {v:.3g}" for k, v in other["seq_err"].items())
        + f" (tol {RNN_TOL} of the largest element, grads {RNN_GRAD_TOL} relative L2); "
        f"{time.perf_counter() - t0:.1f} s")
    check(all(o <= RNN_TOL and g <= RNN_TOL for o, g in layer.values()),
          "recurrent (a): a layer differs between card and CPU")
    check(all(lr <= RNN_TOL and gr <= RNN_GRAD_TOL for lr, gr, _ in models.values()),
          "recurrent (a): a model's step differs between card and CPU")
    check(decode[0] and decode[1] <= RNN_TOL, "recurrent (a): seq2seq beam decode differs")
    check(srl_decode and other["crf_ids_equal"] and other["crf_nll"] <= RNN_TOL,
          "recurrent (a): the CRF differs between card and CPU")
    check(other["seq_bits_equal"], "recurrent (a): a sequence reduction changed its bits "
          "between two card runs")
    check(all(v <= (RNN_GRAD_TOL if k.endswith("grad") else RNN_TOL)
              for k, v in other["seq_err"].items()),
          "recurrent (a): a sequence reduction differs between card and CPU")


def rnn_timed(dev, seed, card_name, path):
    """(b)-(d) one bench row: RNN_K eager steps, then run_steps(K) from the
    same params, bit for bit (losses, params, Adam moments); ms a step eager
    against captured in turns, samples/s (tokens/s for seq2seq), TFLOP/s by
    core/flops.py, peak memory, and a profiled eager step's device time,
    operations and op families (a captured step runs the same kernels:
    its ms over that device time says how near the device it runs; a
    dispatch is not profiled, its ~46,000 kernels take the profiler tens
    of seconds to sum). Returns the eager trainer."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import flops

    t_path = time.perf_counter()
    spec = RNN_PATHS[path]
    b, s, m = spec["batch"], spec["seq"], spec["model"]
    feeds = _rnn_feeds(path)
    t0 = time.perf_counter()
    eager = _rnn_trainer(path, dev, feeds[0], seed)
    startup_s = time.perf_counter() - t0
    params0 = _params_of(eager)
    staged = _on_card(feeds, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = torch.stack([eager.step(f)["loss"] for f in staged])
    torch.cuda.synchronize()
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    state_eager = _state_of(eager)
    fused = _rnn_trainer(path, dev, feeds[0], params=params0)
    stacked = fused._put_feed(pt.data.stack_batches(feeds))
    t0 = time.perf_counter()
    outs = fused.run_steps(stacked)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    differ = _states_differ(state_eager, _state_of(fused))
    same = _bits_equal(losses, outs["loss"]) and not differ
    del state_eager, params0
    times, peaks = _eager_against_captured(eager, fused, staged, stacked, RNN_DISPATCHES,
                                           RNN_K)
    wall, dev_us, n_ops, kernels = _profile_dispatch(lambda: eager.step(staged[0]))
    ms = {n: float(np.mean(v)) for n, v in times.items()}
    if path == "seq2seq":
        tflop = flops.seq2seq_train_flops(b, s, s, m["emb_dim"], m["hidden"],
                                          m["trg_vocab"]) / 1e12
        unit, per_step = "tokens/s", b * s
    else:
        tflop = flops.lstm_train_flops(b, s, m["hidden_dim"], m["num_layers"],
                                       m["emb_dim"]) / 1e12
        unit, per_step = "samples/s", b
    dev_ms = dev_us / 1e3
    fam = _families(kernels)
    rows = sorted(((us, calls, key) for key, (calls, us) in kernels.items()), reverse=True)
    n_params = sum(p.numel() for p in eager.scope.params.values())
    profile = (f"a profiled eager step: {wall:.3f} ms, {dev_ms:.3f} ms of device time "
               f"({100 * dev_ms / wall:.1f}% busy), {n_ops} device operations; the captured "
               f"step's ms {ms['captured'] / dev_ms:.3f}x that device time; by "
               "family " + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in fam.items() if v)
               + "; top ops " + ", ".join(f"{key[:60]} x{calls} {us / 1e3:.3f} ms"
                                          for us, calls, key in rows[:RNN_TOP_OPS])
               if dev_us else "profile: not measured (no device time seen)")
    say(f"recurrent {path} ({card_name}): f32, b={b}, s={s}, {m}, Adam({RNN_LR}), "
        f"{n_params} params, startup {startup_s:.2f} s; losses "
        f"{[round(x, 5) for x in losses.tolist()]}; run_steps(K={RNN_K}) against {RNN_K} "
        f"step() calls from one state (capture and dispatch {capture_s:.2f} s): losses and "
        f"state bit-equal {same}{'' if same else f' (differing leaves {differ[:5]})'}; eager "
        f"{[round(t, 3) for t in times['eager']]} ms a step (mean {ms['eager']:.3f}, "
        f"{per_step / ms['eager'] * 1e3:.1f} {unit}, {tflop / ms['eager'] * 1e3:.2f} "
        f"TFLOP/s), captured {[round(t, 3) for t in times['captured']]} (mean "
        f"{ms['captured']:.3f}, {per_step / ms['captured'] * 1e3:.1f} {unit}, "
        f"{tflop / ms['captured'] * 1e3:.2f} TFLOP/s, {ms['eager'] / ms['captured']:.2f}x) "
        f"at {tflop:.4f} TFLOP a step by core/flops.py; peak memory first eager steps "
        f"{first_peak:.3f} GB, eager {peaks['eager']:.3f} GB, captured "
        f"{peaks['captured']:.3f} GB; {profile}; {time.perf_counter() - t_path:.1f} s")
    READINGS[f"recurrent_{path}"] = {"eager_ms": ms["eager"], "captured_ms": ms["captured"],
                                     "tflop": tflop, "device_ms": dev_ms,
                                     "peak_gb": max(peaks.values())}
    check(bool(torch.isfinite(losses).all()), f"recurrent {path}: a loss is not finite")
    check(same, f"recurrent {path}: run_steps differs from step()")
    del fused, stacked, staged
    return eager


def rnn_ragged(dev, seed, card_name):
    """(e) bench_lstm's widths with lengths drawn from RNN_RAGGED: run_steps
    bit-equal to step(); and one dynamic_lstm at those widths: each row's
    h_last is its state at its own end (the last valid step; the first in
    reverse), and its outputs past the end are that state (in reverse the
    zero state the row starts from)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.layers import rnn

    t0 = time.perf_counter()
    spec = RNN_PATHS["lstm"]
    b, s, h = spec["batch"], spec["seq"], spec["model"]["hidden_dim"]
    rng = np.random.RandomState(seed + 173)
    lengths = [rng.randint(RNN_RAGGED[0], RNN_RAGGED[1] + 1, b).astype(np.int64)
               for _ in range(RNN_K)]
    feeds = _rnn_feeds("lstm", lengths=lengths)
    eager = _rnn_trainer("lstm", dev, feeds[0], seed)
    fused = _rnn_trainer("lstm", dev, feeds[0], params=_params_of(eager))
    losses = torch.stack([eager.step(f)["loss"] for f in feeds])
    outs = fused.run_steps(fused._put_feed(pt.data.stack_batches(feeds)))
    differ = _states_differ(_state_of(eager), _state_of(fused))
    same = _bits_equal(losses, outs["loss"]) and not differ
    del eager, fused

    lens = torch.from_numpy(lengths[0]).to(dev)
    x = torch.randn(b, s, h, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    ends = {}
    for rev in (False, True):
        prog = pt.build(lambda x, l, rev=rev: rnn.dynamic_lstm(x, h, l, is_reverse=rev))
        params, _ = prog.init(seed, x, lens, place=dev)
        with torch.no_grad():
            out, (h_last, _) = prog.apply(params, {}, x, lens, place=dev)[0]
        rows = torch.arange(b, device=dev)
        at_end = torch.equal(h_last, out[rows, torch.zeros_like(lens) if rev else lens - 1])
        past = torch.arange(s, device=dev)[None, :] >= lens[:, None]
        expect = torch.zeros_like(out) if rev else h_last[:, None].expand_as(out)
        ends["reverse" if rev else "forward"] = (at_end, torch.equal(out[past], expect[past]))
    say(f"recurrent (e) ragged ({card_name}): bench_lstm's widths, lengths "
        f"{int(min(x.min() for x in lengths))}-{int(max(x.max() for x in lengths))} "
        f"(drawn from {RNN_RAGGED}); losses {[round(x, 5) for x in losses.tolist()]}; "
        f"run_steps(K={RNN_K}) bit-equal to step() {same}"
        f"{'' if same else f' (differing leaves {differ[:5]})'}; dynamic_lstm at h={h}: "
        + ", ".join(f"{k} h_last at each row's end {a}, past the end held {p}"
                    for k, (a, p) in ends.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    check(same, "recurrent (e): run_steps differs from step() on ragged lengths")
    check(all(a and p for a, p in ends.values()),
          "recurrent (e): a row's last state is not its state at its end")


def seq2seq_served(dev, seed, card_name, trainer):
    """(f) make_decoder(beam_size=S2S_BEAM, max_len=S2S_MAX_LEN) applied with
    (d)'s trained params to S2S_SERVE_ROWS source rows of ragged length,
    eagerly; ms a call; then beam_search_decode_lod on its ids: the 2-level
    LoD of the hypotheses, its tokens those up to each first EOS."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.layers import beam_search_decode_lod
    from paddle_tpu_torch.models import seq2seq

    spec = RNN_PATHS["seq2seq"]
    m, s = spec["model"], spec["seq"]
    rng = np.random.RandomState(seed + 174)
    src = torch.from_numpy(rng.randint(3, m["src_vocab"], (S2S_SERVE_ROWS, s))).to(dev)
    lens = torch.from_numpy(rng.randint(s // 3, s + 1, S2S_SERVE_ROWS)).to(dev)
    dec = pt.build(seq2seq.make_decoder(**m, max_len=S2S_MAX_LEN, beam_size=S2S_BEAM))

    def call():
        with torch.no_grad():
            return dec.apply(trainer.scope.params, {}, src_ids=src, src_lengths=lens,
                             place=dev)[0]

    first = call()
    torch.cuda.synchronize()
    times = []
    for _ in range(S2S_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    same = torch.equal(first["ids"], out["ids"]) and _bits_equal(first["scores"],
                                                                  out["scores"])
    ids, scores = out["ids"], out["scores"]
    is_eos = (ids == 2).int()
    valid = (torch.cumsum(is_eos, -1) - is_eos) == 0
    t0 = time.perf_counter()
    lod, lod_scores = beam_search_decode_lod(ids, valid, scores)
    lod_ms = (time.perf_counter() - t0) * 1e3
    hyp = [int(n) for n in valid.sum(-1).reshape(-1).tolist()]
    lod_ok = (lod.recursive_sequence_lengths() == [[S2S_BEAM] * S2S_SERVE_ROWS, hyp]
              and torch.equal(lod.values, ids[valid].to(torch.int32))
              and lod.values.device == ids.device
              and lod_scores.recursive_sequence_lengths()[1] == [1] * len(hyp))
    ordered = bool((scores[:, :-1] >= scores[:, 1:]).all())
    in_range = bool(((ids >= 0) & (ids < m["trg_vocab"])).all())
    med = sorted(times)[len(times) // 2]
    say(f"recurrent (f) served seq2seq decoder ({card_name}): make_decoder(beam_size="
        f"{S2S_BEAM}, max_len={S2S_MAX_LEN}) from (d)'s trained params, {S2S_SERVE_ROWS} "
        f"source rows of lengths {lens.tolist()}, eager: {[round(t, 2) for t in times]} ms a "
        f"call (median {med:.2f}, {S2S_SERVE_ROWS * S2S_BEAM * S2S_MAX_LEN / med * 1e3:.1f} "
        f"beam tokens/s); two calls bit-equal {same}; scores best first {ordered}, finite "
        f"{bool(torch.isfinite(scores).all())}; beam_search_decode_lod in {lod_ms:.2f} ms: "
        f"LoD levels [{S2S_SERVE_ROWS} x {S2S_BEAM}], hypothesis lengths "
        f"{hyp[:8]}..., tokens {int(lod.values.numel())}, matching the valid ids {lod_ok}")
    READINGS["recurrent_served"] = {"ms_a_call": med}
    check(same and ordered and in_range and bool(torch.isfinite(scores).all()),
          "recurrent (f): the served decoder's output is wrong")
    check(lod_ok, "recurrent (f): beam_search_decode_lod's LoD does not match the ids")


def phase_recurrent(dev, seed, card_name):
    """Phase 17: the recurrent family. The path runs no hand kernel: the
    launch counts, zeroed just before the phase, must read 0 after it;
    returns them."""
    import gc
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    _zero_launch_counts(fa)
    # ---- the phase, as a user drives it
    rnn_parity(dev, seed, card_name)
    s2s = None
    for path in ("lstm", "lstm_big", "seq2seq"):
        trainer = rnn_timed(dev, seed, card_name, path)
        if path == "seq2seq":
            s2s = trainer
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    rnn_ragged(dev, seed, card_name)
    seq2seq_served(dev, seed, card_name, s2s)
    launches = _launch_counts(fa)
    # ---- end of the phase
    del s2s
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 17 took {time.perf_counter() - t_phase:.1f} s; hand-kernel launches on the "
        f"recurrent paths {launches} (they run none)")
    check(all(n == 0 for n in launches.values()), "recurrent: a flash kernel launched")
    return launches


# -- phase 18: the multi-GPU slice's first half on one card --------------------

MESH_STEPS, MESH_K = 3, 4
# ring attention at bench_gpt's attention shape, its sequence split over
# RING_SP shards driven in this one process
RING_SHAPE, RING_SP = (8, 12, 1024, 64), 4
QUANT_BLOCK = 256


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_state(trainer):
    """The training state's local tensors (a DTensor's shard), cloned, by
    path."""
    from paddle_tpu_torch.executor import _local
    return {k: _local(v) for k, v in _state_of(trainer).items()}


def _max_diff(a, b):
    """The largest element difference of two {name: tensor} dicts, as f32
    (0.0 when every leaf is bit-equal)."""
    return max(float((x.float() - b[k].float()).abs().max()) if x.numel() else 0.0
               for k, x in a.items())


def _logical(trainer):
    from paddle_tpu_torch.executor import _full
    return {k: _full(v.detach()).clone() for k, v in trainer._logical_params().items()}


def _mesh_trainer(cfg, dev, mesh, rules=None, strategy=None):
    from paddle_tpu_torch import Trainer, build, optimizer
    from paddle_tpu_torch.models import gpt
    return Trainer(build(gpt.make_model(cfg)),
                   optimizer.AdamW(TRAIN_LR, weight_decay=TRAIN_WD), loss_name="loss",
                   fetch_list=["loss"], device=dev, mesh=mesh, sharding_rules=rules,
                   strategy=strategy)


def mesh_world_of_one(dev, seed, card_name):
    """(a) bf16 GPT-base at bench_gpt's config on meshes of a world of one:
    3 steps each of replicated() on {dp: 1}, fsdp() on {fsdp: 1} and
    zero_sharding on {dp: 1} against the unmeshed Trainer from the same
    params; run_steps(K=4) under the {dp: 1} mesh, captured, against 4
    step() calls of the mesh; ms a step eager (unmeshed, mesh) and
    captured (mesh) in turns. Returns (launch counts of the path, the
    param count)."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel as par
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(**TRAIN)
    feeds = _train_feeds(np.random.RandomState(0), MESH_K, TRAIN_BATCH, TRAIN_SEQ,
                         cfg.vocab_size)
    dp, fs = par.make_mesh({"dp": 1}), par.make_mesh({"fsdp": 1})
    base = _trainer(cfg, dev).startup(seed, sample_feed=feeds[0])
    params0 = _params_of(base)
    n_params = sum(p.numel() for p in params0.values())
    variants = {"replicated": (dp, par.replicated(), None), "fsdp": (fs, par.fsdp(), None),
                "zero": (dp, None, pt.DistStrategy(zero_sharding=True))}
    trainers = {name: _mesh_trainer(cfg, dev, m, r, s).startup(seed, sample_feed=feeds[0],
                                                             params=params0)
                for name, (m, r, s) in variants.items()}
    seq = _mesh_trainer(cfg, dev, dp).startup(seed, sample_feed=feeds[0], params=params0)
    fused = _mesh_trainer(cfg, dev, dp).startup(seed, sample_feed=feeds[0], params=params0)
    _zero_launch_counts(fa)  # the startups' init forwards took the flash forward
    # ---- the main path, as a user drives it
    losses = {"unmeshed": [base.step(f)["loss"] for f in feeds[:MESH_STEPS]]}
    for name, tr in trainers.items():
        losses[name] = [tr.step(f)["loss"] for f in feeds[:MESH_STEPS]]
    seq_losses = torch.stack([seq.step(f)["loss"] for f in feeds])
    stacked = fused._put_feed(pt.data.stack_batches(feeds), stacked=True)
    outs = fused.run_steps(stacked)
    torch.cuda.synchronize()
    launches = _launch_counts(fa)
    # ---- end of the main path
    want_l = {k: float(v) for k, v in zip(range(MESH_STEPS), losses["unmeshed"])}
    ref = _logical(base)
    for name, tr in trainers.items():
        got = [float(x) for x in losses[name]]
        diff = _max_diff(_logical(tr), ref)
        bit_equal = got == list(want_l.values()) and diff == 0.0
        say(f"mesh (a) {name} ({card_name}): bf16 GPT-base b={TRAIN_BATCH} s={TRAIN_SEQ} "
            f"AdamW, {MESH_STEPS} steps on {tr.mesh.shape} against the unmeshed Trainer: "
            f"losses {got} vs {list(want_l.values())}, params' largest difference {diff} "
            f"({'bit-equal' if bit_equal else 'not bit-equal'})"
            + (f"; ZeRO rows {tuple(next(iter(tr.scope.params.values())).to_local().shape)}, "
               f"collective bytes {tr.collective_bytes}" if name == "zero" else ""))
        check(all(np.isfinite(got)), f"mesh {name}: a loss is not finite")
        check(max(abs(a - b) / abs(b) for a, b in zip(got, want_l.values())) <= 1e-2,
              f"mesh {name}: losses part from the unmeshed Trainer's")
    same = _bits_equal(seq_losses, outs["loss"])
    differ = _states_differ(_local_state(seq), _local_state(fused))
    say(f"mesh (a) captured: run_steps(K={MESH_K}) on {fused.mesh.shape} against {MESH_K} "
        f"step() calls of the mesh from one state: losses {outs['loss'].tolist()}, "
        f"bit-equal {same}; state leaves differing {differ}; launches of the path "
        f"{launches}")
    check(same and not differ, "mesh captured: run_steps differs from step()")
    want = cfg.num_layers * (MESH_STEPS * 4 + MESH_K + _captured_step_runs())
    check(all(n == want for n in launches.values()),
          f"mesh (a): launch counts {launches}, want {want} each")
    del trainers
    gc.collect()
    # ms a step in turns: the unmeshed eager step, the mesh's eager step
    # (DTensor's host dispatch) and the mesh's captured step
    staged = [base._put_feed(f) for f in feeds]
    mstaged = [seq._put_feed(f) for f in feeds]
    runs = {"unmeshed eager": lambda: [base.step(f) for f in staged],
            "mesh eager": lambda: [seq.step(f) for f in mstaged],
            "mesh captured": lambda: fused.run_steps(stacked)}
    times = {n: [] for n in runs}
    for name in list(runs) + list(runs)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / MESH_K * 1e3)
    ms = {n: float(np.mean(v)) for n, v in times.items()}
    quoted = {k: READINGS.get(k) for k in ("gpt_eager", "gpt_captured")}
    say(f"mesh (a) timing ({card_name}): ms a step over {MESH_K} steps, two turns each: "
        + ", ".join(f"{n} {[round(t, 2) for t in v]} (mean {ms[n]:.2f})"
                    for n, v in times.items())
        + f"; phase 7/12's unmeshed readings {quoted}")
    del base, seq, fused
    gc.collect()
    torch.cuda.empty_cache()
    return launches, n_params, ms


def _ring_shards(t, order, n):
    return [c.contiguous() for c in t[:, :, order].chunk(n, 2)]


def ring_on_one_card(dev, seed, card_name):
    """(b) ring attention's steps for RING_SP shards driven in this process
    (a rotation of the shard list standing for the exchange) at bench_gpt's
    attention shape, bf16 causal, plain ring and zigzag; Ulysses' head
    shards. Returns (launch counts of the ring's steps, the comparisons'
    rows)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import ring_attention as ra

    b, h, s, d = RING_SHAPE
    n = RING_SP
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(RING_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    _zero_launch_counts(fa)
    # ---- the path: every ring step of both schedules, forward and backward
    results = {}
    for name in ("ring", "zigzag"):
        order = (ra.zigzag_order(s, n, device=dev) if name == "zigzag"
                 else torch.arange(s, device=dev))
        sched = ra._ZigzagSchedule() if name == "zigzag" else ra._RingSchedule(True)
        qs, ks, vs, gs = (_ring_shards(t, order, n) for t in (q, k, v, g))
        outs, lses = [], []
        for idx in range(n):
            acc = torch.zeros(qs[idx].shape, dtype=torch.float32, device=dev)
            lse = torch.full(qs[idx].shape[:3], ra.NEG_INF, dtype=torch.float32, device=dev)
            for i in range(n):
                src = (idx - i) % n
                acc, lse = ra.fwd_step(sched, qs[idx], ks[src], vs[src], acc, lse, idx, src)
            outs.append(acc.to(q.dtype))
            lses.append(lse)
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=dev) for x in qs]
        dk = [torch.zeros(x.shape, dtype=torch.float32, device=dev) for x in ks]
        dv = [torch.zeros(x.shape, dtype=torch.float32, device=dev) for x in vs]
        for idx in range(n):
            delta = (outs[idx].float() * gs[idx].float()).sum(-1)
            for i in range(n):
                src = (idx - i) % n
                dq[idx], dk[src], dv[src] = ra.bwd_step(
                    sched, qs[idx], ks[src], vs[src], outs[idx], lses[idx], gs[idx], delta,
                    dq[idx], dk[src], dv[src], idx, src)
        inv = torch.argsort(order)
        results[name] = {"out": torch.cat(outs, 2)[:, :, inv],
                         "lse": torch.cat(lses, 2)[:, :, inv],
                         **{n_: torch.cat([x.to(q.dtype) for x in t], 2)[:, :, inv]
                            for n_, t in (("dq", dq), ("dk", dk), ("dv", dv))}}
    # Ulysses: each rank's heads over the whole sequence (the all-to-alls
    # only move data)
    hs = h // n
    parts = [fa.flash_attention(q[:, j * hs:(j + 1) * hs], k[:, j * hs:(j + 1) * hs],
                                v[:, j * hs:(j + 1) * hs], causal=True, return_lse=True)
             for j in range(n)]
    ugrads = [fa._flash_bwd(q[:, j * hs:(j + 1) * hs], k[:, j * hs:(j + 1) * hs],
                            v[:, j * hs:(j + 1) * hs], None, None, None, True, parts[j][0],
                            parts[j][1], g[:, j * hs:(j + 1) * hs]) for j in range(n)]
    results["ulysses"] = {"out": torch.cat([p[0] for p in parts], 1),
                          "lse": torch.cat([p[1] for p in parts], 1),
                          **{n_: torch.cat([u[i] for u in ugrads], 1)
                             for i, n_ in enumerate(("dq", "dk", "dv"))}}
    torch.cuda.synchronize()
    launches = _launch_counts(fa)
    # ---- end of the path; the comparisons below launch more
    o_w, lse_w = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    whole = dict(zip(("dq", "dk", "dv"), fa._flash_bwd(q, k, v, None, None, None, True,
                                                       o_w, lse_w, g)), out=o_w, lse=lse_w)
    po, plse = fa.flash_attention_reference(q, k, v, True)
    plain = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_reference(
        q, k, v, True, None, None, None, g, plse, (po.float() * g.float()).sum(-1))),
        out=po, lse=plse)
    rows = {}
    for name, res in results.items():
        errs = {}
        for key, ref_ in (("whole", whole), ("plain", plain)):
            for t in ("out", "lse", "dq", "dk", "dv"):
                e = float((res[t].float() - ref_[t].float()).abs().max())
                scale = 1.0 if t in ("out", "lse") else float(ref_[t].float().abs().max())
                tol = (LSE_TOL if t == "lse" else TOL["bfloat16"] if t == "out"
                       else BWD_TOL["bfloat16"]) * scale
                errs[f"{t}/{key}"] = e
                check(e <= tol, f"ring (b) {name}: {t} against the {key} attention "
                      f"{e} > {tol}")
        rows[name] = errs
        say(f"ring (b) {name} bf16 {list(RING_SHAPE)} causal, sp={n} in one process: "
            f"max |diff| against flash on the whole sequence and against the plain "
            f"versions {errs} (tol out {TOL['bfloat16']}, lse {LSE_TOL}, grads "
            f"{BWD_TOL['bfloat16']}·max|grad|)")
    check(all(n_ > 0 for n_ in launches.values()), f"ring (b): launches {launches}")
    # each ring step's kernels against the whole-sequence kernels
    sl = s // n
    shapes = {"whole causal": (s, s, True), "shard full": (sl, sl, False),
              "shard causal": (sl, sl, True), "zigzag earlier": (sl, sl // 2, False),
              "zigzag later": (sl // 2, sl, False)}
    step_ms = {}
    for label, (sq, sk, causal) in shapes.items():
        qq, kk, vv, gg = q[:, :, :sq], k[:, :, :sk], v[:, :, :sk], g[:, :, :sq]
        oo, ll = fa.flash_attention(qq, kk, vv, causal=causal, return_lse=True)
        step_ms[label] = (device_ms(lambda: fa.flash_attention(qq, kk, vv, causal=causal,
                                                               return_lse=True), 10),
                          device_ms(lambda: fa._flash_bwd(qq, kk, vv, None, None, None,
                                                          causal, oo, ll, gg), 10))
    say(f"ring (b) step kernels ({card_name}): [forward ms, backward ms] at "
        f"[b, h, sq, sk] = [{b}, {h}, sq, sk]: "
        + ", ".join(f"{k_} {sq_}x{sk_} {[round(x, 4) for x in step_ms[k_]]}"
                    for k_, (sq_, sk_, _) in shapes.items())
        + f"; one rank's causal ring does rank+1 shard steps (ring) or {n} half-steps "
          f"(zigzag: earlier/later {n - 1}, own 1)")
    return launches, rows, step_ms


def quantized_codec_on_card(dev, seed, card_name, n):
    """(c) the quantized exchange's block codec, card against CPU, bit for
    bit, int8 and int4 at ``n`` gradient elements (GPT-base's), with its
    encode and decode ms on the card."""
    import torch
    from paddle_tpu_torch.parallel import quantized_collectives as qc

    gen = torch.Generator().manual_seed(seed)
    n_pad = -(-n // QUANT_BLOCK) * QUANT_BLOCK
    x = torch.randn(n_pad, generator=gen) * 1e-3
    x[:QUANT_BLOCK] = 0.0                  # an all-zero block
    x[QUANT_BLOCK + 7] = float("nan")      # a poisoned block
    x[5 * QUANT_BLOCK + 3] = 3.0           # an outlier's block
    xc = x.to(dev)
    for bits in (8, 4):
        pc, sc = qc._encode(xc, bits, QUANT_BLOCK)
        pcpu, scpu = qc._encode(x, bits, QUANT_BLOCK)
        dc = qc._decode(pc, sc, bits, QUANT_BLOCK)
        dcpu = qc._decode(pcpu, scpu, bits, QUANT_BLOCK)
        eq = (torch.equal(pc.cpu(), pcpu), torch.equal(sc.cpu().nan_to_num(-1.0),
                                                       scpu.nan_to_num(-1.0)),
              torch.equal(dc.cpu().nan_to_num(-1.0), dcpu.nan_to_num(-1.0)))
        enc_ms = device_ms(lambda: qc._encode(xc, bits, QUANT_BLOCK), 3, repeats=3)
        dec_ms = device_ms(lambda: qc._decode(pc, sc, bits, QUANT_BLOCK), 3, repeats=3)
        gb = n_pad * 4 / 1e9
        say(f"quant (c) int{bits} blocks of {QUANT_BLOCK} over {n} elements ({card_name}): "
            f"card against CPU bit-equal (payload, scales, decode) {eq}; encode "
            f"{enc_ms:.3f} ms ({gb / max(enc_ms, 1e-9) * 1e3:.1f} GB/s of f32 in), decode "
            f"{dec_ms:.3f} ms; payload {pc.numel() * pc.element_size() / 1e6:.1f} MB + "
            f"scales {sc.numel() * 4 / 1e6:.2f} MB for {gb * 1e3:.1f} MB of f32")
        check(all(eq), f"quant (c) int{bits}: card and CPU codecs differ")
        del pc, sc, dc, pcpu, scpu, dcpu


def phase_multi_gpu(dev, seed, card_name):
    """Phase 18: (a) meshes in a world of one over NCCL, (b) ring and
    Ulysses attention's steps on one card, (c) the quantized codec.
    Returns the launch counts of (a)'s and (b)'s paths, summed."""
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel as par

    # the world of one meets itself through a store on the loopback: the
    # sealed machine has no other network
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    par.initialize(place=dev, init_method=f"tcp://127.0.0.1:{_free_port()}",
                   world_size=1, rank=0)
    say(f"mesh: world of one, backend {dist.get_backend()}, initialised in "
        f"{time.perf_counter() - t0:.2f} s")
    try:
        with pt.amp_guard("bfloat16"):
            mesh_launches, n_params, _ = mesh_world_of_one(dev, seed, card_name)
        ring_launches, _, _ = ring_on_one_card(dev, seed, card_name)
        quantized_codec_on_card(dev, seed, card_name, n_params)
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return {k: mesh_launches[k] + ring_launches[k] for k in mesh_launches}


# phase 19: pipeline parallelism and the MoE transformer, their ranks driven
# in this process. (a) bench_gpt's GPT-base (TRAIN, TRAIN_BATCH x TRAIN_SEQ,
# bf16) under pipeline_mode(LocalRanks(PP_RANKS), PP_MICRO): GPipe and
# interleaved PP_V, one forward and backward each against the sequential
# stacked step from the same params, the loss at BF16_ROUNDING relative and
# the grads at ACCUM_GRAD_TOL relative L2 (phase 14 (d)'s limits: the same
# math, the microbatches' products in other shapes); a world-of-one Trainer
# on {dp: 1, tp: 1, pp: 1} with pp_microbatches=PP_MICRO (no pp axis larger
# than 1: the degenerate, layer-by-layer route) bit-equal to the unmeshed
# Trainer for MESH_STEPS steps and its run_steps(K=MESH_K) captured
# bit-equal to MESH_K step() calls; with transformer_tp_rules (the fused
# projections run one product a q/k/v on tp-sharded DTensor weights) its
# losses within BF16_ROUNDING relative. (b) the stacked Transformer-base at
# bench_transformer_long's widths and shape (TRANSFORMER, LONG_BATCH x
# LONG_SEQ, dropout 0, flash, bf16) through PP_TR_RANKS ranks and
# PP_TR_MICRO microbatches, extras per microbatch, against the sequential
# stacked step at the same limits. (c) the MoE LM at base_config widths,
# bf16, flash, at MOE_BATCH x MOE_SEQ: MOE_EAGER eager steps on one batch
# (the loss falls), run_steps(K=MOE_K) captured against MOE_K step() calls
# bit for bit; f32 card against CPU at MOE_PARITY's widths (the loss at
# MOE_LOSS_TOL, the grads at MOE_GRAD_TOL relative L2 and each grad's distance
# at MOE_GRAD_TOL of the largest grad's norm); one MoE layer's
# MOE_EP ranks emulated here (each rank's tokens routed at the capacity of
# its shard, the all-to-all by slicing and concatenating) against each
# shard's dense route at BF16_ROUNDING (outputs) and ACCUM_GRAD_TOL (grads)
# relative L2.
PP_RANKS, PP_MICRO, PP_V = 4, 8, 3
PP_TR_RANKS, PP_TR_MICRO = 2, 4
MOE_BATCH, MOE_SEQ, MOE_LR, MOE_EAGER, MOE_K, MOE_EP = 8, 1024, 1e-3, 4, 4, 4
MOE_PARITY = dict(vocab_size=512, max_len=64, d_model=64, d_inner=128, d_expert=64,
                  num_heads=2, num_layers=2, num_experts=4)
MOE_PARITY_BATCH, MOE_PARITY_SEQ = 2, 64
MOE_LOSS_TOL, MOE_GRAD_TOL = 1e-5, 1e-3


def _rel_dist(a, b):
    """‖a − b‖ / ‖b‖ over two {name: tensor} trees, in f32."""
    return _tree_dist(a, b) / max(_tree_dist(b), 1e-30)


def _loss_and_grads(prog, params, feed, dev, seed, pp=None):
    """One training forward and backward of ``prog`` from a copy of
    ``params``, under ``pp`` (a pipeline_mode, or nothing): (loss, grads)."""
    import torch
    ps = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    with pp or contextlib.nullcontext():
        out, _ = prog.apply(ps, {}, training=True, rng=seed, place=dev, **feed)
    out["loss"].backward()
    torch.cuda.synchronize()
    return out["loss"].detach().float(), {k: p.grad.detach() for k, p in ps.items()}


def _held(name, loss, grads, want_loss, want_grads, card_name, extra=""):
    """Say and check a schedule's loss and grads against the sequential
    step's."""
    import torch
    rl = float((loss - want_loss).abs() / want_loss.abs())
    rg = _rel_dist(grads, want_grads)
    say(f"phase 19 {name} ({card_name}): loss {float(loss):.6f} against the sequential "
        f"step's {float(want_loss):.6f} (relative {rl:.2e}, limit {BF16_ROUNDING:.2e}); "
        f"grads' relative L2 distance {rg:.2e} (limit {ACCUM_GRAD_TOL}){extra}")
    check(bool(torch.isfinite(loss)), f"phase 19 {name}: the loss is not finite")
    check(rl <= BF16_ROUNDING, f"phase 19 {name}: the loss parts from the sequential step's")
    check(rg <= ACCUM_GRAD_TOL, f"phase 19 {name}: the grads part from the sequential step's")


def pipeline_gpt(dev, seed, card_name):
    """(a) The one-process pipeline on bench_gpt's GPT-base, and the
    world-of-one pp Trainer. Returns the launch counts of the two
    schedules, and those of the world-of-one Trainers (which take the
    layer-by-layer route, not the schedule)."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework, parallel as par
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import pipeline as pp

    cfg = gpt.base_config(**TRAIN)
    feeds = _train_feeds(np.random.RandomState(0), MESH_K, TRAIN_BATCH, TRAIN_SEQ,
                         cfg.vocab_size)
    prog = pt.build(gpt.make_model(cfg))
    base = _trainer(cfg, dev).startup(seed, sample_feed=feeds[0])
    params0 = _params_of(base)
    feed = base._put_feed(feeds[0])
    want_loss, want = _loss_and_grads(prog, params0, feed, dev, seed)
    launches = {n: 0 for n in _launch_counts(fa)}
    perm = pp.interleave_perm(cfg.num_layers, PP_RANKS, PP_V)
    say(f"phase 19 (a) bubble_fraction({PP_RANKS}, {PP_MICRO}, 1) = "
        f"{pp.bubble_fraction(PP_RANKS, PP_MICRO, 1):.6f} (3/11 = {3 / 11:.6f}), "
        f"bubble_fraction({PP_RANKS}, {PP_MICRO}, {PP_V}) = "
        f"{pp.bubble_fraction(PP_RANKS, PP_MICRO, PP_V):.6f} (3/27 = {3 / 27:.6f})")
    check(abs(pp.bubble_fraction(PP_RANKS, PP_MICRO, 1) - 3 / 11) < 1e-12
          and abs(pp.bubble_fraction(PP_RANKS, PP_MICRO, PP_V) - 3 / 27) < 1e-12,
          "phase 19 (a): bubble_fraction")
    for name, v, layout in (("GPipe", 1, "stacked"), (f"interleaved V={PP_V}", PP_V,
                                                       "interleaved")):
        params = dict(params0)
        rows = torch.as_tensor(perm, device=dev)
        if layout == "interleaved":
            params = {k: (t[rows] if "_stack/" in k else t) for k, t in params.items()}
        ticks = pp._schedule_ticks(PP_MICRO, PP_RANKS, v)
        lc = cfg.num_layers // (PP_RANKS * v)
        mode = framework.pipeline_mode(pp.LocalRanks(PP_RANKS), PP_MICRO, interleave=v,
                                       param_layout=layout)
        _zero_launch_counts(fa)
        t0 = time.perf_counter()
        with record_kernel_calls(fa) as calls:
            # ---- the path: one forward and backward through the schedule
            loss, grads = _loss_and_grads(prog, params, feed, dev, seed, pp=mode)
            # ---- end
        secs = time.perf_counter() - t0
        got = _launch_counts(fa)
        for n in launches:
            launches[n] += got[n]
        check_recorded(fa, calls, f"phase 19 (a) {name}")
        del calls
        if layout == "interleaved":
            back = torch.as_tensor(np.argsort(perm), device=dev)
            grads = {k: (g[back] if "_stack/" in k else g) for k, g in grads.items()}
        per_tick = PP_RANKS * lc
        _held(f"(a) {name} pp={PP_RANKS} M={PP_MICRO} bf16 GPT-base b={TRAIN_BATCH} "
              f"s={TRAIN_SEQ}", loss, grads, want_loss, want, card_name,
              f"; {ticks} ticks, flash launches {got} ({per_tick} a tick: {PP_RANKS} ranks "
              f"x {lc} layers, each rank every tick); {secs:.2f} s on the host clock "
              "(one process drives all ranks in turn: not a pipeline's speed)")
        check(all(n == ticks * per_tick for n in got.values()),
              f"phase 19 (a) {name}: launch counts {got}, want {ticks * per_tick} each")
    del base
    gc.collect()
    # the world-of-one Trainer with pp_microbatches: its mesh has no pp axis
    # larger than 1, so it warns and trains layer by layer
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    par.initialize(place=dev, init_method=f"tcp://127.0.0.1:{_free_port()}",
                   world_size=1, rank=0)
    try:
        mesh = par.make_mesh({"dp": 1, "tp": 1, "pp": 1})
        strategy = pt.DistStrategy(pp_microbatches=PP_MICRO)
        unmeshed = _trainer(cfg, dev).startup(seed, sample_feed=feeds[0], params=params0)
        meshed, seq, fused = (_mesh_trainer(cfg, dev, mesh, None, strategy).startup(
            seed, sample_feed=feeds[0], params=params0) for _ in range(3))
        tp = _mesh_trainer(cfg, dev, mesh, par.transformer_tp_rules(), strategy).startup(
            seed, sample_feed=feeds[0], params=params0)
        _zero_launch_counts(fa)
        import warnings
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            # ---- the path: the Trainer a user builds with the knob
            got = [float(meshed.step(f)["loss"]) for f in feeds[:MESH_STEPS]]
            tp_got = [float(tp.step(f)["loss"]) for f in feeds[:MESH_STEPS]]
            seq_losses = torch.stack([seq.step(f)["loss"] for f in feeds])
            outs = fused.run_steps(fused._put_feed(pt.data.stack_batches(feeds),
                                                   stacked=True))
            torch.cuda.synchronize()
            # ---- end
        trained = _launch_counts(fa)
        want_l = [float(unmeshed.step(f)["loss"]) for f in feeds[:MESH_STEPS]]
        diff = _max_diff(_logical(meshed), _logical(unmeshed))
        same = _bits_equal(seq_losses, outs["loss"])
        differ = _states_differ(_local_state(seq), _local_state(fused))
        note = [str(w.message) for w in warned if "pp_microbatches" in str(w.message)]
        tp_rel = max(abs(a - b) / abs(b) for a, b in zip(tp_got, want_l))
        say(f"phase 19 (a) world-of-one Trainer ({card_name}): {mesh.shape}, "
            f"DistStrategy(pp_microbatches={PP_MICRO}): losses {got} against the unmeshed "
            f"Trainer's {want_l}, params' largest difference {diff}; run_steps(K={MESH_K}) "
            f"captured against {MESH_K} step() calls: bit-equal {same}, state leaves "
            f"differing {differ}; warned: {note[:1]}; with transformer_tp_rules (the fused "
            f"projections one product a q/k/v on tp-sharded weights): losses {tp_got}, "
            f"{tp_rel:.2e} relative (limit {BF16_ROUNDING:.2e})")
        check(got == want_l and diff == 0.0,
              "phase 19 (a): the world-of-one pp Trainer is not bit-equal to the unmeshed one")
        check(tp_rel <= BF16_ROUNDING, "phase 19 (a): the tp-rules Trainer parts from the "
              "unmeshed one")
        check(same and not differ, "phase 19 (a): the pp Trainer's run_steps differs")
        check(bool(note), "phase 19 (a): no warning that the mesh has no pp axis")
        want_n = cfg.num_layers * (2 * MESH_STEPS + MESH_K + _captured_step_runs())
        check(all(n == want_n for n in trained.values()),
              f"phase 19 (a): the Trainers' launch counts {trained}, want {want_n} each")
    finally:
        dist.destroy_process_group()
    del unmeshed, meshed, seq, fused, tp
    gc.collect()
    torch.cuda.empty_cache()
    return launches, trained


def pipeline_transformer(dev, seed, card_name):
    """(b) The stacked Transformer-base through a pp=2 schedule with the
    decoder's extras per microbatch. Returns the launch counts."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import pipeline as pp

    cfg = _transformer_cfg(max_len=LONG_SEQ, dropout=0.0, dtype="bfloat16", stacked=True)
    feeds = _seq2seq_feeds(np.random.RandomState(0), 1, LONG_BATCH, LONG_SEQ)
    tr = _seq2seq_trainer(cfg, dev).startup(seed, feeds[0])
    params = _params_of(tr)
    feed = tr._put_feed(feeds[0])
    del tr
    prog = pt.build(transformer.make_model(cfg))
    want_loss, want = _loss_and_grads(prog, params, feed, dev, seed)
    mode = framework.pipeline_mode(pp.LocalRanks(PP_TR_RANKS), PP_TR_MICRO)
    _zero_launch_counts(fa)
    t0 = time.perf_counter()
    with record_kernel_calls(fa) as calls:
        # ---- the path: one forward and backward through both stacks' schedules
        loss, grads = _loss_and_grads(prog, params, feed, dev, seed, pp=mode)
        # ---- end
    secs = time.perf_counter() - t0
    got = _launch_counts(fa)
    check_recorded(fa, calls, "phase 19 (b) stacked Transformer-base pp schedule")
    del calls
    ticks = pp._schedule_ticks(PP_TR_MICRO, PP_TR_RANKS, 1)
    lc = cfg.num_encoder_layers // PP_TR_RANKS
    # a tick: each rank's encoder layers (self attention), then in the
    # decoder's schedule its layers' self and cross attention
    want_n = ticks * PP_TR_RANKS * lc * 3
    _held(f"(b) stacked Transformer-base pp={PP_TR_RANKS} M={PP_TR_MICRO} bf16 "
          f"b={LONG_BATCH} s={LONG_SEQ}", loss, grads, want_loss, want, card_name,
          f"; flash launches {got} (want {want_n}: {ticks} ticks of {PP_TR_RANKS} ranks x "
          f"{lc} layers, encoder self, decoder self and cross attention); {secs:.2f} s "
          "on the host clock (one process drives both ranks: not a pipeline's speed)")
    check(all(n == want_n for n in got.values()),
          f"phase 19 (b): launch counts {got}, want {want_n} each")
    del params, grads, want
    gc.collect()
    torch.cuda.empty_cache()
    return got


def _moe_cfg(**kw):
    from paddle_tpu_torch.models import moe_transformer
    return moe_transformer.base_config(**{"use_flash": True, "dtype": "bfloat16", **kw})


def _moe_trainer(cfg, dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import moe_transformer
    return pt.Trainer(pt.build(moe_transformer.make_model(cfg)),
                      pt.optimizer.Adam(MOE_LR), loss_name="loss",
                      fetch_list=["loss", "ce_loss", "aux_loss"], place=dev)


def moe_parity(dev, seed, card_name):
    """(c) f32 MoE LM, card against CPU, one forward and backward from the
    same params at MOE_PARITY's widths."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import moe_transformer

    cfg = _moe_cfg(**MOE_PARITY, dtype="float32")
    feed = _train_feeds(np.random.RandomState(1), 1, MOE_PARITY_BATCH, MOE_PARITY_SEQ,
                        cfg.vocab_size)[0]
    prog = pt.build(moe_transformer.make_model(cfg))
    params, _ = prog.init(seed, place="cpu", **{k: _put_cpu(v) for k, v in feed.items()})
    results = {}
    for where in (dev, "cpu"):
        f = {k: _put_cpu(v).to(where) for k, v in feed.items()}
        ps = {k: v.to(where) for k, v in params.items()}
        loss, grads = _loss_and_grads_any(prog, ps, f, where, seed)
        results[where] = (loss.cpu(), {k: g.cpu() for k, g in grads.items()})
    (lc, gc_), (lp, gp) = results[dev], results["cpu"]
    rl = float((lc - lp).abs() / lp.abs())
    # each grad's distance against the largest grad's norm: a key
    # projection's bias has a grad of 0 in exact arithmetic, so its own
    # relative distance is rounding over rounding
    top = max(_tree_dist({k: g}) for k, g in gp.items())
    worst = max((_tree_dist({k: gc_[k]}, {k: gp[k]}) / top, k) for k in gp)
    whole = _rel_dist(gc_, gp)
    say(f"phase 19 (c) MoE LM f32 card against CPU ({card_name}): {MOE_PARITY}, "
        f"b={MOE_PARITY_BATCH} s={MOE_PARITY_SEQ}: loss {float(lc):.7f} vs {float(lp):.7f} "
        f"(relative {rl:.2e}, limit {MOE_LOSS_TOL}); grads' relative L2 {whole:.2e}, the "
        f"worst grad's distance over the largest grad's norm {worst[0]:.2e} ({worst[1]}; "
        f"limit {MOE_GRAD_TOL} for both)")
    check(rl <= MOE_LOSS_TOL, "phase 19 (c): the f32 loss parts card from CPU")
    check(whole <= MOE_GRAD_TOL and worst[0] <= MOE_GRAD_TOL,
          "phase 19 (c): an f32 grad parts card from CPU")


def _put_cpu(v):
    import numpy as np
    import torch
    return torch.from_numpy(np.ascontiguousarray(v))


def _loss_and_grads_any(prog, params, feed, where, seed):
    ps = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    out, _ = prog.apply(ps, {}, training=True, rng=seed, place=where, **feed)
    out["loss"].backward()
    return out["loss"].detach().float(), {k: p.grad.detach() for k, p in ps.items()}


def moe_ep_emulated(dev, seed, card_name):
    """(c) One MoE layer at base_config widths, MOE_BATCH x MOE_SEQ tokens,
    through ``moe(mesh=LocalRanks(MOE_EP, "ep"))``: the port's ep path with
    its ranks run in this process (each rank routes its row block at its
    shard's capacity, the port's send and receive layouts around an
    all-to-all that slices and concatenates, each rank's experts over the
    slots it received); forward and backward against each shard's dense
    route at the same capacity."""
    import math
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.layers.ops import apply_activation
    from paddle_tpu_torch.parallel import moe as M
    from paddle_tpu_torch.parallel.pipeline import LocalRanks

    cfg = _moe_cfg()
    d, e, ff, k = cfg.d_model, cfg.num_experts, cfg.d_expert, cfg.top_k
    t = MOE_BATCH * MOE_SEQ
    tl = t // MOE_EP
    cap = max(1, int(math.ceil(tl * k / e * cfg.capacity_factor)))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    base = {"router_w": rand(d, e, scale=d ** -0.5),
            "expert_w1": rand(e, d, ff, scale=d ** -0.5), "expert_b1": rand(e, ff, scale=0.02),
            "expert_w2": rand(e, ff, d, scale=ff ** -0.5), "expert_b2": rand(e, d, scale=0.02)}
    x0 = rand(MOE_BATCH, MOE_SEQ, d, dtype=torch.bfloat16)
    g0 = rand(MOE_BATCH, MOE_SEQ, d, dtype=torch.bfloat16)
    act = lambda h: apply_activation(h, "gelu")  # noqa: E731

    def layer(x):
        out, aux = M.moe(x, e, ff, top_k=k, capacity_factor=cfg.capacity_factor,
                         mesh=LocalRanks(MOE_EP, "ep"))
        return {"out": out, "aux": aux}

    prog = pt.build(layer)
    names = {n.rsplit("/", 1)[-1]: n for n in prog.init(seed, x=x0, place=dev)[0]}

    def run(ep):
        p = {n: v.clone().requires_grad_(True) for n, v in base.items()}
        x = x0.clone().requires_grad_(True)
        if ep:
            with M.capture_moe_configs() as log:
                out = prog.apply({names[n]: v for n, v in p.items()}, {}, x=x,
                                 place=dev)[0]["out"]
            check(log[0]["capacity"] == cap and log[0]["ep"] == MOE_EP,
                  f"phase 19 (c): the ep layer's config {log[0]}")
        else:
            out = torch.cat([M._route_compute(
                [shard.reshape(tl, d)], p["router_w"],
                [tuple(p[f"expert_{n}"] for n in ("w1", "b1", "w2", "b2"))], top_k=k,
                capacity=cap, act=act, normalize_gates=True)[0][0].reshape(shard.shape)
                for shard in x.chunk(MOE_EP)]).to(x.dtype)
        (out.float() * g0.float()).sum().backward()
        torch.cuda.synchronize()
        return out.detach(), {"x": x.grad, **{n: v.grad for n, v in p.items()}}

    out_e, g_e = run(True)
    out_d, g_d = run(False)
    ro = _rel_dist({"o": out_e}, {"o": out_d})
    rg = _rel_dist(g_e, g_d)
    say(f"phase 19 (c) one MoE layer, moe(mesh=LocalRanks({MOE_EP}, 'ep')) ({card_name}): "
        f"d={d} E={e} top-{k} d_expert={ff}, {t} tokens, {tl} a rank, capacity {cap}, "
        f"{e // MOE_EP} experts a rank, bf16: output relative L2 {ro:.2e} (limit "
        f"{BF16_ROUNDING:.2e}), grads {rg:.2e} (limit {ACCUM_GRAD_TOL}) against each "
        "shard's dense route")
    check(cap == 640, f"phase 19 (c): capacity {cap}, want 640")
    check(ro <= BF16_ROUNDING, "phase 19 (c): the ep layer parts from the dense route")
    check(rg <= ACCUM_GRAD_TOL, "phase 19 (c): the ep grads part from the dense route")


def _moe_trace(eager, feed, e, cap):
    """One profiled eager step of the MoE LM, read from its trace: (the
    step's device ms, {family: [device ms, operations]}) for the products
    over a [t, E·C] dispatch or combine matrix (``aten::mm`` with an E·C
    operand dim), the other operations on such a matrix (its zeros,
    scatters, casts and their grads) and the expert bank's batched
    products (``aten::bmm`` with a capacity dim)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        eager.step(feed)
        torch.cuda.synchronize()
    device_us = sum(evt.self_device_time_total for evt in prof.key_averages()
                    if evt.device_type == torch.autograd.DeviceType.CUDA
                    and not evt.key.startswith(("trainer.", "DeviceFeeder.")))
    fams = {"dispatch and combine products": [0.0, 0], "other [t, E*C] operations": [0.0, 0],
            "expert bank products": [0.0, 0]}
    for evt in prof.events():
        us = evt.self_device_time_total if evt.device_type == torch.autograd.DeviceType.CPU \
            else 0
        if not us:
            continue
        shapes = [shape for shape in evt.input_shapes if isinstance(shape, list)]
        wide = any(e * cap in shape for shape in shapes)
        if evt.name in ("aten::mm", "aten::addmm") and wide:
            fam = "dispatch and combine products"
        elif evt.name in ("aten::bmm", "aten::baddbmm") and any(
                len(shape) == 3 and cap in shape for shape in shapes):
            fam = "expert bank products"
        elif wide:
            fam = "other [t, E*C] operations"
        else:
            continue
        fams[fam][0] += us / 1e3
        fams[fam][1] += 1
    return device_us / 1e3, fams


def moe_lm(dev, seed, card_name):
    """(c) The MoE LM at base_config widths: eager steps, run_steps captured
    bit-equal, timings, memory and the products' share. Returns the launch
    counts of the path."""
    import gc
    import math
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = _moe_cfg()
    feeds = _train_feeds(np.random.RandomState(0), MOE_K, MOE_BATCH, MOE_SEQ, cfg.vocab_size)
    eager = _moe_trainer(cfg, dev).startup(seed, sample_feed=feeds[0])
    params0 = _params_of(eager)
    fused = _moe_trainer(cfg, dev).startup(seed, sample_feed=feeds[0], params=params0)
    again = _moe_trainer(cfg, dev).startup(seed, sample_feed=feeds[0], params=params0)
    staged = [eager._put_feed(f) for f in feeds]
    stacked = fused._put_feed(pt.data.stack_batches(feeds), stacked=True)
    _zero_launch_counts(fa)
    # ---- the path: eager steps on one batch, then K steps eager and captured
    with record_kernel_calls(fa) as calls:
        falling = [float(again.step(staged[0])["loss"]) for _ in range(MOE_EAGER)]
    losses = torch.stack([eager.step(f)["loss"] for f in staged])
    outs = fused.run_steps(stacked)
    torch.cuda.synchronize()
    # ---- end
    launches = _launch_counts(fa)
    check_recorded(fa, calls, "phase 19 (c) MoE LM eager step")
    del calls
    same = _bits_equal(losses, outs["loss"])
    differ = _states_differ(_state_of(eager), _state_of(fused))
    say(f"phase 19 (c) MoE LM ({card_name}): d={cfg.d_model} {cfg.num_layers} layers, "
        f"{cfg.num_experts} experts top-{cfg.top_k} d_expert={cfg.d_expert} "
        f"d_inner={cfg.d_inner} vocab {cfg.vocab_size}, bf16, flash, b={MOE_BATCH} "
        f"s={MOE_SEQ}, Adam({MOE_LR}): {MOE_EAGER} eager steps on one batch, losses "
        f"{[round(x, 5) for x in falling]}; run_steps(K={MOE_K}) against {MOE_K} step() "
        f"calls: losses {[round(x, 5) for x in outs['loss'].tolist()]}, bit-equal {same}, "
        f"state leaves differing {differ}; launches {launches}")
    check(all(np.isfinite(falling)) and falling[-1] < falling[0],
          "phase 19 (c): the MoE LM's loss does not fall")
    check(same and not differ, "phase 19 (c): the MoE LM's run_steps differs from step()")
    want_n = cfg.num_layers * (MOE_EAGER + MOE_K + _captured_step_runs())
    check(all(n == want_n for n in launches.values()),
          f"phase 19 (c): launch counts {launches}, want {want_n} each")
    times, peaks = _eager_against_captured(eager, fused, staged, stacked, 1, MOE_K)
    ms = _timing_line(f"MoE LM bf16 b={MOE_BATCH} s={MOE_SEQ} (phase 19 (c))", times, peaks,
                      "tokens/s", MOE_BATCH * MOE_SEQ, card_name, MOE_K,
                      _busy_against(eager, fused, staged, stacked))
    t = MOE_BATCH * MOE_SEQ
    cap = max(1, int(math.ceil(t * cfg.top_k / cfg.num_experts * cfg.capacity_factor)))
    e_c = cfg.num_experts * cap
    dev_ms, fams = _moe_trace(eager, staged[0], cfg.num_experts, cap)
    del eager, fused, again, staged, stacked
    gc.collect()
    torch.cuda.empty_cache()
    n_moe = cfg.num_layers // cfg.moe_every
    flop = 2 * t * e_c * cfg.d_model
    f32_gb, bf_gb = t * e_c * 4 / 1e9, t * e_c * 2 / 1e9
    shares = (", ".join(f"{f} {v[0]:.3f} ms in {v[1]} operations, {100 * v[0] / dev_ms:.1f}%"
                        for f, v in fams.items()) if dev_ms and any(v[1] for v in fams.values())
              else "not measured (the trace holds no device time for the operations)")
    say(f"phase 19 (c) MoE dispatch and combine from one profiled eager step's trace "
        f"({card_name}): capacity {cap}, E*C = {e_c}, {n_moe} MoE layers, "
        f"{flop / 1e9:.1f} GFLOP a product (2*t*E*C*d) "
        f"against {2 * 2 * e_c * cfg.d_model * cfg.d_expert / 1e9:.1f} GFLOP for the expert "
        f"bank's forward; of the step's {dev_ms:.2f} device ms: {shares}. The JAX einsum's "
        "[t, k, E, C] intermediate is not formed: _topk_dispatch writes f32 zeros "
        f"[t, E*C] and scatters the k choices into two f32 copies of them (3 x {f32_gb:.3f} "
        "GB a layer, freed after the cast), and the products take bf16 casts of the "
        f"dispatch and combine matrices ({bf_gb:.3f} GB each, kept for the backward)")
    return launches, ms


def phase_pipeline_moe(dev, seed, card_name):
    """Phase 19: (a) the pipelined GPT-base and the world-of-one pp Trainer,
    (b) the pipelined stacked Transformer-base, (c) the MoE LM. Returns the
    launch counts of the pipeline's schedules ((a)+(b)), of (a)'s
    world-of-one Trainers (the layer-by-layer route) and of the MoE path."""
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    with pt.amp_guard("bfloat16"):
        a, world_of_one = pipeline_gpt(dev, seed, card_name)
        say(f"phase 19 (a) done in {time.perf_counter() - t0:.1f} s")
        b = pipeline_transformer(dev, seed, card_name)
        say(f"phase 19 (b) done in {time.perf_counter() - t0:.1f} s")
        moe_launches, _ = moe_lm(dev, seed, card_name)
        moe_ep_emulated(dev, seed, card_name)
    moe_parity(dev, seed, card_name)
    say(f"phase 19 (c) done in {time.perf_counter() - t0:.1f} s")
    return {"pipeline": {n: a[n] + b[n] for n in a}, "pp_world_of_one": world_of_one,
            "moe": moe_launches}


# phase 20: sharded checkpoints and elastic training on bench_gpt's GPT-base.
# (a) SHARD_STEPS steps, an async save_trainer_sharded, SHARD_OVERLAP steps
# while it writes, a fresh trainer's load_trainer_sharded and the same
# SHARD_OVERLAP feeds replayed (bit-equal state); (b) ELASTIC_WORLD CPU ranks
# (this script's --elastic-world-rank) train GPT-base one step at
# ELASTIC_WORLD_BATCH x ELASTIC_WORLD_SEQ with ZeRO and save it, restored
# elastically on the card, then ELASTIC_FIT_STEPS steps of fit; (c) a fit
# resized at step RESIZE_AT of RESIZE_BATCHES, resumed elastically.
SHARD_STEPS, SHARD_OVERLAP = 3, 2
ELASTIC_WORLD, ELASTIC_WORLD_BATCH, ELASTIC_WORLD_SEQ, ELASTIC_WORLD_THREADS = 2, 2, 64, 3
ELASTIC_WORLD_TIMEOUT = 300
ELASTIC_FIT_STEPS = 3
RESIZE_AT, RESIZE_BATCHES = 2, 5


def elastic_world_rank(rank, world, port, outdir):
    """One rank of (b)'s CPU world: GPT-base at TRAIN's widths, bf16 amp,
    AdamW with ZeRO over dp=world, one step, save_trainer to
    <outdir>/step_1."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(ELASTIC_WORLD_THREADS)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel as par
    from paddle_tpu_torch.models import gpt

    par.initialize(place=pt.CPUPlace())
    try:
        cfg = gpt.base_config(**TRAIN)
        feed = _train_feeds(np.random.RandomState(2), 1, ELASTIC_WORLD_BATCH,
                            ELASTIC_WORLD_SEQ, cfg.vocab_size)[0]
        with pt.amp_guard("bfloat16"):
            tr = _mesh_trainer(cfg, "cpu", par.make_mesh({"dp": world}),
                               strategy=pt.DistStrategy(zero_sharding=True))
            tr.startup(0, sample_feed=feed)
            loss = float(tr.step(feed)["loss"])
        pt.io.save_trainer(os.path.join(outdir, "step_1"), tr)
        if rank == 0:
            print(f"elastic world: loss {loss}", flush=True)
    finally:
        dist.destroy_process_group()


def _spawn_elastic_world(outdir):
    """(b)'s CPU world, started in the background: its processes."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=str(ELASTIC_WORLD_THREADS),
               GLOO_SOCKET_IFNAME="lo")
    port = _free_port()
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--elastic-world-rank", str(r), str(ELASTIC_WORLD), str(port),
                              outdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             env=env)
            for r in range(ELASTIC_WORLD)]


def _wait_elastic_world(procs, t0):
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, ELASTIC_WORLD_TIMEOUT
                                               - (time.perf_counter() - t0)))
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    check(not bad, "elastic (b): CPU world ranks %s failed:\n%s"
          % (bad, "\n".join(logs[i][-3000:] for i in bad)))
    say(f"elastic (b) CPU world of {ELASTIC_WORLD} ranks done in "
        f"{time.perf_counter() - t0:.1f} s: {logs[0].strip().splitlines()[-1]}")


def _flat_state(params, opt_state):
    """Params and optimizer state as the npz members save_trainer writes
    (whole tensors, bit patterns)."""
    import numpy as np
    from paddle_tpu_torch import io
    flat = io._flatten(io._full_tree({"params": params, "opt_state": opt_state}))
    return {k: np.array(v) for k, v in flat.items()}  # copies, not views of the state


def _flat_equal(a, b):
    import numpy as np
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _bytes_under(d):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)


def sharded_checkpoint(dev, seed, card_name, tmp, mesh=None, record=False):
    """(a) on one trainer kind (unmeshed, or ``mesh``'s world of one).
    Returns the recorded flash calls when ``record``."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(**TRAIN)
    label = "world of one" if mesh is not None else "unmeshed"
    feeds = _train_feeds(np.random.RandomState(3), SHARD_STEPS + SHARD_OVERLAP, TRAIN_BATCH,
                         TRAIN_SEQ, cfg.vocab_size)

    def make(s):
        tr = _mesh_trainer(cfg, dev, mesh) if mesh is not None else _trainer(cfg, dev)
        return tr.startup(s, sample_feed=feeds[0])

    first = make(seed)
    staged = [first._put_feed(f) for f in feeds]
    calls = []
    with (record_kernel_calls(fa) if record else contextlib.nullcontext(calls)) as calls:
        for f in staged[:SHARD_STEPS]:
            first.step(f)
    d = os.path.join(tmp, "sharded_" + label.replace(" ", "_"))
    done = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fut = pt.io.save_trainer_sharded(d, first, async_save=True)
    return_ms = (time.perf_counter() - t0) * 1e3
    fut.add_done_callback(lambda _: done.append(time.perf_counter()))
    t1 = time.perf_counter()
    losses = [first.step(f)["loss"] for f in staged[SHARD_STEPS:]]
    torch.cuda.synchronize()
    during_ms = (time.perf_counter() - t1) * 1e3 / SHARD_OVERLAP
    writing_after_steps = not fut.done()
    pt.io.wait_for_checkpoints()
    write_s = done[0] - t0
    want = _flat_state(first.scope.params, first.scope.opt_state)
    want_losses = [float(x) for x in losses]
    # the same steps' work without a write in flight, on the same trainer
    t2 = time.perf_counter()
    for f in staged[SHARD_STEPS:]:
        first.step(f)
    torch.cuda.synchronize()
    quiet_ms = (time.perf_counter() - t2) * 1e3 / SHARD_OVERLAP
    del first, staged
    gc.collect()
    torch.cuda.empty_cache()
    second = make(seed + 1)
    staged = [second._put_feed(f) for f in feeds[SHARD_STEPS:]]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    pt.io.load_trainer_sharded(d, second)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t3
    step_after_load = second.global_step
    replay = [float(second.step(f)["loss"]) for f in staged]
    equal = _flat_equal(_flat_state(second.scope.params, second.scope.opt_state), want)
    nbytes = _bytes_under(d)
    say(f"elastic (a) {label} ({card_name}): bf16 GPT-base b={TRAIN_BATCH} s={TRAIN_SEQ} "
        f"AdamW; save_trainer_sharded(async_save=True) after step {SHARD_STEPS}: "
        f"{nbytes} bytes ({nbytes / 1e9:.3f} GB) in {len(os.listdir(d))} files, returned in "
        f"{return_ms:.1f} ms, the write ended {write_s:.3f} s after the call (still "
        f"writing when the {SHARD_OVERLAP} steps ended: {writing_after_steps}); ms a step "
        f"while it wrote {during_ms:.2f}, the same steps without a write {quiet_ms:.2f}; "
        f"load_trainer_sharded into a fresh trainer {load_s:.3f} s (global_step "
        f"{step_after_load}); replayed losses {replay} vs {want_losses}; params and "
        f"optimizer state at step {SHARD_STEPS + SHARD_OVERLAP} bit-equal: {equal}")
    check(all(np.isfinite(want_losses)), f"elastic (a) {label}: a loss is not finite")
    check(step_after_load == SHARD_STEPS, f"elastic (a) {label}: global_step "
          f"{step_after_load} after the load")
    check(equal and replay == want_losses, f"elastic (a) {label}: the restored trainer's "
          "state after the replay differs from the saved trainer's")
    del second, staged
    gc.collect()
    torch.cuda.empty_cache()
    return calls


@contextlib.contextmanager
def _reshard_reports():
    """The reports of the ``reshard_restore`` calls made inside the block
    (``restore_latest`` returns only the meta)."""
    from paddle_tpu_torch import resilience
    reports, orig = [], resilience.reshard_restore

    def keep(*args, **kw):
        reports.append(orig(*args, **kw))
        return reports[-1]
    resilience.reshard_restore = keep
    try:
        yield reports
    finally:
        resilience.reshard_restore = orig


def _fit_feeds(feeds, names=("ids", "labels")):
    """A reader of ``feeds`` (each a batch), as fit reads it: lists of
    per-sample tuples."""
    return lambda: ([tuple(f[n][j] for n in names) for j in range(len(f[names[0]]))]
                    for f in feeds)


def elastic_restore(dev, seed, card_name, root, mesh):
    """(b) on the card: the CPU world's ZeRO dp=2 checkpoint under
    ``root``. Returns the recorded flash calls of the fit."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(**TRAIN)
    feeds = _train_feeds(np.random.RandomState(4), ELASTIC_FIT_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                         cfg.vocab_size)
    ck = os.path.join(root, "step_1")
    params, _, opt_state, meta = pt.io.load_persistables(ck)
    want = _flat_state(params, opt_state)
    del params, opt_state
    for label, make in (("one device", lambda: _trainer(cfg, dev)),
                        ("world of one", lambda: _mesh_trainer(cfg, dev, mesh))):
        tr = make().startup(seed, sample_feed=feeds[0])
        try:
            pt.io.load_trainer(ck, tr)
            err = ""
        except pt.resilience.ReshardError as e:
            err = str(e)
        with _reshard_reports() as reports:
            t0 = time.perf_counter()
            got_meta = pt.resilience.restore_latest(root, tr, elastic=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rep = reports[0] if reports else {}
        equal = _flat_equal(_flat_state(tr.scope.params, tr.scope.opt_state), want)
        say(f"elastic (b) {label} ({card_name}): plain load_trainer of the dp=2 ZeRO "
            f"checkpoint raised ReshardError: {err[:160]!r}...; restore_latest(elastic=True) "
            f"in {wall:.3f} s: global_step {got_meta['global_step']}, report saved "
            f"{rep.get('saved_axes')} -> target {rep.get('target_axes')}, bytes_moved "
            f"{rep.get('bytes_moved')}, seconds {rep.get('seconds')}; params and optimizer "
            f"state bit-equal to load_persistables: {equal}")
        check("{'dp': 2}" in err, f"elastic (b) {label}: load_trainer did not raise a "
              "ReshardError naming {'dp': 2}")
        check(bool(reports) and rep["bytes_moved"] > 0 and tr.global_step == 1,
              f"elastic (b) {label}: no reshard report")
        check(equal, f"elastic (b) {label}: the restored state differs from the checkpoint")
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    tr = _trainer(cfg, dev).startup(seed + 2, sample_feed=feeds[0])
    losses = []
    with record_kernel_calls(fa) as calls:
        pt.fit(tr, _fit_feeds(feeds), 1, ["ids", "labels"],
               checkpoint_config=pt.CheckpointConfig(root, epoch_interval=0, step_interval=0),
               resume=True, elastic=True,
               event_handler=lambda e: losses.append(float(e.metrics["loss"]))
               if e.kind == "end_step" else None)
    say(f"elastic (b) fit(resume=True, elastic=True) ({card_name}): {len(losses)} steps at "
        f"b={TRAIN_BATCH} s={TRAIN_SEQ}, losses {losses}, global_step {tr.global_step}")
    check(len(losses) == ELASTIC_FIT_STEPS and all(np.isfinite(losses))
          and tr.global_step == 1 + ELASTIC_FIT_STEPS, "elastic (b): the resumed fit")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def scheduled_resize(dev, seed, card_name, tmp):
    """(c): fit(resize=path) resized at step RESIZE_AT, then resumed."""
    import gc
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gpt

    cfg = gpt.base_config(**TRAIN)
    feeds = _train_feeds(np.random.RandomState(5), RESIZE_BATCHES, TRAIN_BATCH, TRAIN_SEQ,
                         cfg.vocab_size)
    root, path = os.path.join(tmp, "resize_ck"), os.path.join(tmp, "resize.json")
    ck_cfg = pt.CheckpointConfig(root, epoch_interval=0, step_interval=0)
    events = []

    def handler(e):
        events.append(e.kind)
        if e.kind == "end_step" and e.step == RESIZE_AT:
            pt.resilience.ResizeRequest(path).request({"dp": 2})

    tr = _trainer(cfg, dev).startup(seed, sample_feed=feeds[0])
    pt.fit(tr, _fit_feeds(feeds), 1, ["ids", "labels"], event_handler=handler,
           checkpoint_config=ck_cfg, resize=path)
    saved = [c.global_step for c in pt.resilience.list_checkpoints(root)]
    target = pt.resilience.ResizeRequest(path).consume()
    stopped = tr.global_step
    del tr
    gc.collect()
    losses = []
    resumed = _trainer(cfg, dev).startup(seed + 1, sample_feed=feeds[0])
    pt.fit(resumed, _fit_feeds(feeds), 1, ["ids", "labels"], checkpoint_config=ck_cfg,
           resume=True, elastic=True,
           event_handler=lambda e: losses.append(float(e.metrics["loss"]))
           if e.kind == "end_step" else None)
    end = resumed.global_step
    del resumed
    gc.collect()
    bare = _trainer(cfg, dev).startup(seed + 2, sample_feed=feeds[0])
    pt.io.load_trainer(os.path.join(root, f"step_{RESIZE_AT}"), bare)
    bare_losses = [float(bare.step(f)["loss"]) for f in feeds[RESIZE_AT:]]
    del bare
    gc.collect()
    torch.cuda.empty_cache()
    say(f"elastic (c) ({card_name}): fit(resize=path) requested {target} at step "
        f"{RESIZE_AT}: returned at step {stopped} with {events[-1]!r}, checkpoints "
        f"{saved}; fit(resume=True, elastic=True) losses {losses} against bare steps from "
        f"the checkpoint {bare_losses} (bit-equal {losses == bare_losses}), global_step {end}")
    check(stopped == RESIZE_AT and events[-1] == "resized" and saved == [RESIZE_AT]
          and target == {"dp": 2}, "elastic (c): fit did not stop at the resize")
    check(losses == bare_losses and end == RESIZE_BATCHES and all(np.isfinite(losses)),
          "elastic (c): the resumed fit differs from bare steps")


def phase_elastic(dev, seed, card_name):
    """Phase 20: (c) while (b)'s CPU world trains, then (a) unmeshed, a world
    of one over NCCL, (a) on it, (b). Returns the launch counts of
    ``sharded_checkpoint`` ((a)) and ``elastic`` ((b) + (c))."""
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel as par
    from paddle_tpu_torch.ops import flash_attention as fa

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    import torch.distributed.checkpoint  # noqa: F401  (its import is not (a)'s copy time)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "zero_dp2")
        procs = _spawn_elastic_world(root)
        try:
            with pt.amp_guard("bfloat16"):
                _zero_launch_counts(fa)
                # ---- the main path (c)
                scheduled_resize(dev, seed, card_name, tmp)
                torch.cuda.synchronize()
                elastic = _launch_counts(fa)
                # ---- end of (c)
                say(f"phase 20 (c) done in {time.perf_counter() - t0:.1f} s")
                _wait_elastic_world(procs, t0)
                _zero_launch_counts(fa)
                # ---- the main path (a)
                calls = sharded_checkpoint(dev, seed, card_name, tmp, record=True)
                par.initialize(place=dev, init_method=f"tcp://127.0.0.1:{_free_port()}",
                               world_size=1, rank=0)
                try:
                    mesh = par.make_mesh({"dp": 1})
                    sharded_checkpoint(dev, seed, card_name, tmp, mesh=mesh)
                    torch.cuda.synchronize()
                    sharded = _launch_counts(fa)
                    # ---- end of (a)
                    say(f"phase 20 (a) done in {time.perf_counter() - t0:.1f} s")
                    _zero_launch_counts(fa)
                    # ---- the main path (b)
                    fit_calls = elastic_restore(dev, seed, card_name, root, mesh)
                    torch.cuda.synchronize()
                    elastic = {k: v + _launch_counts(fa)[k] for k, v in elastic.items()}
                    # ---- end of (b)
                finally:
                    dist.destroy_process_group()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    check_recorded(fa, calls, "phase 20 (a)")
    check_recorded(fa, fit_calls, "phase 20 (b)")
    say(f"phase 20: launches sharded_checkpoint {sharded}, elastic {elastic}; "
        f"{time.perf_counter() - t0:.1f} s")
    check(all(n > 0 for n in sharded.values()) and all(n > 0 for n in elastic.values()),
          f"phase 20: a flash kernel never launched ({sharded}, {elastic})")
    torch.cuda.empty_cache()
    return sharded, elastic


def _routes(fa, torch):
    """The route table's choices, as the kernels record reports them."""
    return {"bfloat16": fa.ROUTES[(torch.bfloat16, 64)],
            "float32": fa.ROUTES[(torch.float32, 64)],
            "bfloat16_head_dim_32": fa.ROUTES[(torch.bfloat16, 32)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 20 (b)'s CPU world, which this script spawns itself
    ap.add_argument("--elastic-world-rank", nargs=4, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.elastic_world_rank:
        rank, world, port, outdir = args.elastic_world_rank
        elastic_world_rank(int(rank), int(world), int(port), outdir)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False); "
              "this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    # f32 references in full f32 (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda:0"
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_all()
    say(f"build: {_build.sources()} in {time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in sorted(_build.build_log.items()):
        # ptxas's lines for each kernel: the function, its spills, its registers
        # and any note that it serialised a kernel's wgmma products
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "entry function" in ln
                or "wgmma" in ln]
        say(f"build {name}: {secs:.2f} s nvcc; " + " | ".join(regs))

    def done(phase):
        say(f"{phase} done at {time.perf_counter() - t_start:.1f} s")

    done("build")

    # 3. kernel against its plain version
    rows = phase_kernels(dev, args.seed)
    done("phase 3")

    # 3b. the backward kernels against their plain version
    bwd_rows = phase_bwd_kernels(dev, args.seed)
    done("phase 3b")

    # 4. f32 path parity
    phase_parity(dev, args.seed)
    done("phase 4")

    # 5. the served path (launch counts zeroed inside, around the path)
    served = phase_served(dev, args.seed, smi)
    check(served["flash_fwd"] > 0, "served: the flash kernel never launched")
    check(served["flash_fwd"] % GPT_BASE["num_layers"] == 0,
          f"served: {served['flash_fwd']} launches is not a whole number "
          "of generate calls")
    done("phase 5")

    # 6. f32 training parity
    phase_train_parity(dev, args.seed)
    done("phase 6")

    # 7. the training path (launch counts zeroed inside, around the path)
    trained = phase_train(dev, args.seed, smi)
    done("phase 7")

    # 8. MNIST MLP through build programs (launch counts zeroed inside)
    phase_mnist(dev, args.seed, smi)
    done("phase 8")

    # 9. persistence and inference (launch counts zeroed inside)
    persisted = phase_persistence(dev, args.seed, smi)
    done("phase 9")

    # 10. ResNet-50 and mixed precision (launch counts zeroed inside)
    resnet_launches = phase_resnet(dev, args.seed, smi)
    done("phase 10")

    # 11. Transformer-base and BERT-base (launch counts zeroed inside, per path)
    seq2seq = phase_seq2seq(dev, args.seed, smi)
    done("phase 11")

    # 12. captured steps (launch counts zeroed inside, around the GPT path)
    captured, replayed = phase_fused(dev, args.seed, smi)
    done("phase 12")

    # 13. the captured decode (launch counts zeroed inside, around the path)
    decoded = phase_captured_decode(dev, args.seed, smi)
    done("phase 13")

    # 14. the build GPT, remat policies, the stacked Transformer and gradient
    # accumulation (launch counts zeroed inside, around each part)
    slice7 = phase_remat_accum_stacked(dev, args.seed, smi)
    done("phase 14")

    # 15. DeepFM, the recommender and the rest of the optimizers (launch
    # counts zeroed inside, around the path)
    deepfm = phase_deepfm(dev, args.seed, smi)
    done("phase 15")

    # 16. the image zoo at bench.py's configs (launch counts zeroed inside,
    # around the path)
    zoo = phase_zoo(dev, args.seed, smi)
    done("phase 16")

    # 17. the recurrent family at bench.py's lstm, lstm_big and seq2seq rows
    # (launch counts zeroed inside, around the phase)
    recurrent = phase_recurrent(dev, args.seed, smi)
    done("phase 17")

    # 18. meshes in a world of one, ring and Ulysses attention's steps, the
    # quantized codec (launch counts zeroed inside, around each path)
    multi_gpu = phase_multi_gpu(dev, args.seed, smi)
    done("phase 18")

    # 19. pipeline parallelism and the MoE transformer, their ranks driven in
    # this process (launch counts zeroed inside, around each path)
    second = phase_pipeline_moe(dev, args.seed, smi)
    done("phase 19")

    # 20. sharded checkpoints and elastic training (launch counts zeroed
    # inside, around each path)
    sharded, elastic = phase_elastic(dev, args.seed, smi)
    done("phase 20")
    by_path = {name: {"served": served[name], "training": trained[name],
                      "persistence": persisted[name], "resnet": resnet_launches[name],
                      **{path: n[name] for path, n in seq2seq.items()},
                      "captured": captured[name], "captured_decode": decoded[name],
                      "remat_stacked_accum": slice7[name], "deepfm": deepfm[name],
                      "zoo": zoo[name], "recurrent": recurrent[name],
                      "multi_gpu": multi_gpu[name], "pipeline": second["pipeline"][name],
                      "pp_world_of_one": second["pp_world_of_one"][name],
                      "moe": second["moe"][name], "sharded_checkpoint": sharded[name],
                      "elastic": elastic[name]}
               for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}

    # the kernels record: each kernel's row at the training path's shape,
    # launches summed over the main paths it runs on
    fwd_row = rows["train_qkv_b8"]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:191",
        "launches": sum(by_path["flash_fwd"].values()),
        "launches_by_path": by_path["flash_fwd"],
        "max_abs_err": fwd_row["max_abs_err"], "ms": fwd_row["ms"],
        "plain_ms": fwd_row["plain_ms"], "bound_ms": fwd_row["bound_ms"],
        "bound_by": fwd_row["bound_by"], "library_ms": fwd_row["library_ms"],
        "replay_launches_profiled": replayed["flash_fwd"],
        "served_shape": {k: rows["prefill_qkv_b8"][k] for k in
                         ("ms", "plain_ms", "bound_ms", "library_ms")},
        "routes": _routes(fa, torch),
    }]
    for name, line, pass_ in (("flash_bwd_dq", 342, "dq"),
                              ("flash_bwd_dkv", 379, "dkv")):
        row = bwd_rows["train_qkv"][pass_]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"paddle_tpu/ops/flash_attention.py:{line}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_covers": "dq, dk and dv together (SDPA forward+backward "
                              "minus forward)",
            "replay_launches_profiled": replayed[name],
            "routes": _routes(fa, torch),
        })
    say(f"kernels: flash_fwd, flash_bwd_dq, flash_bwd_dkv ported (cuda, sm_90a), "
        f"checked in {len(rows)} forward and {len(bwd_rows)} backward cases; "
        f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
