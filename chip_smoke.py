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
6. training parity — full-width GPT-base in f32: ``make_model`` +
   ``Trainer`` with AdamW on the card (kernels) against the CPU (plain
   versions) from the same weights, 3 steps: the losses of every step and
   the step-1 grads of every param must agree;
7. training — the bf16 GPT-base training path a user calls, at bench.py
   ``bench_gpt``'s config and feeds: ``make_model`` → ``Trainer(AdamW)``
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
   it, must read 0 after it.

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


# -- phase 3: the kernel against its plain version ---------------------------


Case = collections.namedtuple(
    "Case", "name b h sq sk d dtype causal bias segments fully_masked qkv",
    defaults=(False, False, False, False, False))


def kernel_cases():
    """q, k, v are [b, h, s, d]. In the ``qkv`` cases they are what the
    served prefill and the training step hand the kernel: strided head
    views of one fused [b, s, 3, h·d] projection
    (``layers.stacked._split_heads``), at both served buckets and at the
    training shape. The kernels record has rows ``train_qkv_b8`` and
    ``prefill_qkv_b8``. The bf16 cases at head dims 64 and 128 run on the
    tensor cores, the f32 and bf16 head-dim-32 ones on the CUDA cores."""
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
        kw["key_bias"] = torch.randn(b, sk, generator=g).to(dev)
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
            f"segments={'segment_ids' in kw} | "
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
        if case.qkv:  # one writer per output tile, no atomics: the same bits
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
            f"segments={'segment_ids' in kw} | "
            + " ".join(f"max|{n}-plain|={e:.3g} (tol {t:.3g})"
                       for n, (e, t) in errs.items())
            + f" | dq kernel {ms['dq']:.4f} ms, plain {plain['dq']:.4f} ms, bound "
            f"{bounds['dq'][0] * 1e3:.2f} us ({bounds['dq'][1]}) | dkv kernel "
            f"{ms['dkv']:.4f} ms, plain {plain['dkv']:.4f} ms, bound "
            f"{bounds['dkv'][0] * 1e3:.2f} us ({bounds['dkv'][1]}) | sdpa backward "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} | "
            f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name}: a backward kernel disagrees with its plain version")
        if case.qkv:
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
        # a wait budget far above the time the 16 submits take, so the
        # requests coalesce as two full bucket-8 dispatches in submit order
        # (the check below rebuilds exactly those batches); full batches
        # dispatch at once, so the budget adds no latency
        srv = decode.decode_server(d, max_wait_ms=1000.0, workers=1, device=dev)
        try:
            t0 = time.perf_counter()
            pends = [srv.submit({"prompt_ids": prompts[i:i + 1]})
                     for i in range(N_REQUESTS)]
            outs = [p.result(timeout=600)["ids"].cpu().numpy() for p in pends]
            wall = time.perf_counter() - t0
            rep = srv.report()
        finally:
            srv.close(drain=True, timeout=120)
        launches = _launch_counts(fa)
        # ---- end of the main path
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lat = sorted(p.latency for p in pends)
        big = max(BUCKETS)
        pred = pio.load_inference_model(d, device=dev)
        rows_ok = 0
        for g0 in range(0, N_REQUESTS, big):
            group = prompts[g0:g0 + big]
            fill = min(b for b in BUCKETS if b >= len(group)) - len(group)
            group = np.concatenate([group, np.zeros((fill, PROMPT), np.int32)])
            merged = pred.run({"prompt_ids": group})["ids"].cpu().numpy()
            for i in range(g0, min(g0 + big, N_REQUESTS)):
                rows_ok += int(np.array_equal(outs[i][0], merged[i - g0]))
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


def served_breakdown(prog, ids, card):
    """Where one bucket-sized generate call spends its time: host-clock
    prefill and whole-call times (median of 3, each ending in a
    synchronize), then one call under torch.profiler for the device's
    busy share and the flash kernel's share of device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ids = torch.from_numpy(ids).to(prog.device)

    def host_ms(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[1]

    with torch.inference_mode():
        prefill_ms = host_ms(lambda: prog.prefill(ids))
        call_ms = host_ms(lambda: prog(ids))
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


def _trainer(cfg, dev, compute="float32"):
    from paddle_tpu_torch import Trainer, optimizer
    from paddle_tpu_torch.models import gpt
    return Trainer(gpt.make_model(cfg, compute_dtype=compute, device=dev),
                   optimizer.AdamW(TRAIN_LR, weight_decay=TRAIN_WD),
                   loss_name="loss", fetch_list=["loss"], device=dev)


def phase_train_parity(dev, seed):
    """f32 GPT-base training, card (kernels) against CPU (plain versions),
    from the same weights."""
    import numpy as np
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(max_len=PARITY_TRAIN_SEQ, dtype="float32", **GPT_BASE)
    t0 = time.perf_counter()
    card = _trainer(cfg, dev).startup(seed)
    host = _trainer(cfg, "cpu").startup(
        params={k: v.detach().cpu() for k, v in card.scope.params.items()})
    feeds = _train_feeds(np.random.RandomState(seed + 2), PARITY_TRAIN_STEPS,
                         PARITY_TRAIN_BATCH, PARITY_TRAIN_SEQ, cfg.vocab_size)
    for f in feeds:
        f["labels"][0, -16:] = 0  # padding, masked out of the loss
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
    """The bf16 GPT-base training path (bench_gpt's config and feeds);
    returns the launches of each kernel during the path."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = gpt.base_config(**TRAIN)
    feeds = _train_feeds(np.random.RandomState(0), TRAIN_FEEDS, TRAIN_BATCH,
                         TRAIN_SEQ, cfg.vocab_size)
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    trainer = _trainer(cfg, dev, "bfloat16").startup(seed, sample_feed=feeds[0])
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
    plain = _trainer(cfg, dev, "bfloat16").startup(seed, sample_feed=feeds[0])
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
    device_us, spans = 0.0, {}
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
        for name in kernels:
            if name in evt.key:
                kernels[name] += evt.self_device_time_total
    if device_us == 0:
        seen = "not measured (the profiler saw no device time)"
    else:
        fwd = spans.get("trainer.forward", 0.0)
        upd = spans.get("trainer.update", 0.0)
        seen = (f"device busy {100 * device_us / 1e3 / wall_ms:.1f}% of a profiled "
                f"{wall_ms:.1f} ms step ({device_us / 1e3:.2f} ms of device time: "
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


# -- the run ------------------------------------------------------------------


def _routes(fa, torch):
    """The route table's choices, as the kernels record reports them."""
    return {"bfloat16": fa.ROUTES[(torch.bfloat16, 64)],
            "float32": fa.ROUTES[(torch.float32, 64)],
            "bfloat16_head_dim_32": fa.ROUTES[(torch.bfloat16, 32)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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

    # the kernels record: each kernel's row at the training path's shape,
    # launches summed over the main paths it runs on
    fwd_row = rows["train_qkv_b8"]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:191",
        "launches": served["flash_fwd"] + trained["flash_fwd"],
        "launches_by_path": {"served": served["flash_fwd"],
                             "training": trained["flash_fwd"]},
        "max_abs_err": fwd_row["max_abs_err"], "ms": fwd_row["ms"],
        "plain_ms": fwd_row["plain_ms"], "bound_ms": fwd_row["bound_ms"],
        "bound_by": fwd_row["bound_by"], "library_ms": fwd_row["library_ms"],
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
            "launches": served[name] + trained[name],
            "launches_by_path": {"served": served[name], "training": trained[name]},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_covers": "dq, dk and dv together (SDPA forward+backward "
                              "minus forward)",
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
