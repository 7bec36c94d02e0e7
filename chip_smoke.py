#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own lines; any failure exits non-zero:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build  — every kernel under ``paddle_tpu_torch/ops/csrc`` compiled with
   nvcc for sm_90a (one nvcc per source, all at once);
3. kernel — the flash-attention forward kernel against its plain PyTorch
   version on the card, at the prefill shapes of the served path (the
   strided head views of the fused qkv projection, buckets 1 and 8) and
   at ragged, masked and long shapes, with each case's tolerance, timings
   (kernel, plain version, ``scaled_dot_product_attention`` where its mask
   convention matches) and the card's least time for the same work;
4. parity — full-width GPT-base (random weights from ``--seed``) in f32:
   ``make_generator`` on the card (kernel) against the CPU (plain
   versions) from the same weights; 12 kernel launches per generate call;
5. served — the bf16 decode-serving path a user calls: ``export_decoder``
   → ``decode_server`` (``load_inference_model`` + continuous batching)
   answers single-prompt requests; each reply is checked against its row
   of ``Predictor.run`` on the same merged bucket batch. Kernel launch
   counts are zeroed just before this path and read just after it.

The last lines are a JSON ``kernels`` record, the nvidia-smi line and
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import collections
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

# H100 SXM published peaks (dense): HBM bytes/s and FLOP/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel against its plain version: outputs o compared at TOL[dtype]
# (f32: the same products summed in another order; bf16: two bf16 ulps
# of |o| <= 2, since both round o to bf16 and p to bf16 before P·V), and
# lse (f32 in both) at LSE_TOL
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
LSE_TOL = 1e-4


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
    served prefill hands the kernel: strided head views of one fused
    [b, s, 3, h·d] projection (``layers.stacked._split_heads``), at both
    served buckets. The main path's row of the kernels record is
    ``prefill_qkv_b8``."""
    return [
        Case("prefill_qkv_b8", 8, 12, 128, 128, 64, "bfloat16", causal=True,
             qkv=True),
        Case("prefill_qkv_b1", 1, 12, 128, 128, 64, "bfloat16", causal=True,
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


def bound_of(q, k, v, kw):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (q, k, v, bias and ids read once; o and lse written once) over HBM
    bandwidth, and the Q·Kᵀ and P·V multiply-adds of the visible pairs
    over the peak rate of the operand type."""
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    nbytes += q.shape[0] * q.shape[1] * q.shape[2] * 4  # lse
    for key in ("key_bias", "segment_ids", "kv_segment_ids"):
        if key in kw:
            nbytes += kw[key].numel() * 4
    flops = 4 * q.shape[-1] * _visible_pairs(q, k, kw)
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
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
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
        say(f"kernel {name}: [{b},{h},{sq},{sk},{d}] {dt} {layout} "
            f"causal={kw['causal']} bias={'key_bias' in kw} "
            f"segments={'segment_ids' in kw} | "
            f"max|o-plain|={err:.3g} (tol {TOL[dt]}) max|lse-plain|={lerr:.3g} "
            f"(tol {LSE_TOL}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}) | "
            f"{'ok' if ok_o and ok_l else 'MISMATCH'}")
        check(ok_o and ok_l, f"{name}: kernel disagrees with its plain version")
    # no query row: the wrapper launches nothing and counts nothing
    before = fa.flash_fwd_launches
    e = torch.empty(0, 12, 128, 64, dtype=torch.bfloat16, device=dev)
    check(fa.flash_attention(e, e, e, causal=True).shape == e.shape
          and fa.flash_fwd_launches == before,
          "kernel: an empty batch was counted as a launch")
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
        fa.flash_fwd_launches = 0
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
        launches = {"flash_fwd": fa.flash_fwd_launches}
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
    device_us = flash_us = 0.0
    n_kernels = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += evt.self_device_time_total
        n_kernels += evt.count
        if "flash_fwd_kernel" in evt.key:
            flash_us += evt.self_device_time_total
    steps = prog.max_new_tokens - 1
    busy = ("not measured (the profiler saw no device time)" if device_us == 0
            else f"{100 * device_us / 1e3 / wall_ms:.1f}% of a profiled "
                 f"{wall_ms:.1f} ms call, {n_kernels} device kernels, flash_fwd "
                 f"{100 * flash_us / device_us:.3f}% of device time")
    say(f"served breakdown ({card}), one generate call at b={ids.shape[0]}: "
        f"prefill {prefill_ms:.2f} ms, whole call {call_ms:.1f} ms, decode "
        f"{(call_ms - prefill_ms) / steps:.2f} ms per step over {steps} steps; "
        f"device busy {busy}")


# -- the run ------------------------------------------------------------------


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
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        say(f"build {name}: {secs:.2f} s nvcc; " + " | ".join(regs))

    # 3. kernel against its plain version
    rows = phase_kernels(dev, args.seed)

    # 4. f32 path parity
    phase_parity(dev, args.seed)

    # 5. the served path (launch counts zeroed inside, around the path)
    launches = phase_served(dev, args.seed, smi)
    check(launches["flash_fwd"] > 0, "served: the flash kernel never launched")
    check(launches["flash_fwd"] % GPT_BASE["num_layers"] == 0,
          f"served: {launches['flash_fwd']} launches is not a whole number "
          "of generate calls")

    # 6. the kernels record
    main_row = rows["prefill_qkv_b8"]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:191",
        "launches": launches["flash_fwd"],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
    }]
    say(f"kernels: flash_fwd ported (cuda, sm_90a), checked in "
        f"{len(rows)} cases; total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
