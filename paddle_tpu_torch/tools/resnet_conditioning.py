"""How well f32 determines ResNet-50's training steps at init, on the CPU,
through the PyTorch port (the conditioning behind chip_smoke.py phase
10(a)'s tolerances).

    python3 -m paddle_tpu_torch.tools.resnet_conditioning

ResNet-50 (depth 50, 1000 classes) at 64x64 NHWC images on bench.py's
random feeds (seed 0), from one init:

1. step-1 grads of two f32 runs with 1 and with 8 CPU threads (the same
   arithmetic summed in another order), at batch 4 and 16: the worst
   relative L2 over the params;
2. at batch 16, three Momentum(lr, 0.9) steps in f32 against the same
   steps in float64 (every ``Tensor.float()`` of the port promoted to
   float64 for the run, and float64 params, images and compute dtype), at
   lr 0.1 and 1e-4: the step-1 grads' worst relative L2, and each step's
   loss and moving stats (relative to their max).

Takes a few minutes and a few GB of memory on the CPU. The float64 runs
rebind ``torch.Tensor.float`` for their duration, so run this module as
its own process and import nothing else beside it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import config
from paddle_tpu_torch.framework import layout_mode
from paddle_tpu_torch.models import resnet

IMAGE, STEPS, CPU = 64, 3, pt.CPUPlace()


def _feeds(batch):
    rng = np.random.RandomState(0)
    return [{"image": rng.randn(batch, IMAGE, IMAGE, 3).astype(np.float32),
             "label": rng.randint(0, 1000, (batch, 1)).astype(np.int64)} for _ in range(STEPS)]


@contextlib.contextmanager
def _float64():
    """The port's f32 casts and compute dtype as float64, for the block
    (``Tensor.float`` is rebound process-wide until it ends)."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    config.set_flag("default_compute_dtype", "float64")
    try:
        yield
    finally:
        torch.Tensor.float = orig
        config.set_flag("default_compute_dtype", "float32")


def _run(prog, params, state, feeds, dtype, lr, steps):
    """(losses, step-1 grads, moving stats after each step) of ``steps``
    Momentum steps through ``Program.apply`` in ``dtype``."""
    opt = pt.optimizer.Momentum(lr, 0.9)
    p = {k: v.to(dtype) for k, v in params.items()}
    opt_state, losses, grads, states = opt.init(p), [], None, []
    for f in feeds[:steps]:
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        feed = {"image": torch.from_numpy(f["image"]).to(dtype),
                "label": torch.from_numpy(f["label"])}
        out, state = prog.apply(leaves, state, training=True, place=CPU, **feed)
        out["loss"].backward()
        losses.append(out["loss"].item())
        g = {k: v.grad for k, v in leaves.items()}
        grads = grads or g
        with torch.no_grad():
            p, opt_state = opt.update(g, opt_state, {k: v.detach() for k, v in leaves.items()})
        state = {k: v.detach() for k, v in state.items()}
        states.append(state)
    return losses, grads, states


def _worst_l2(a, b):
    rel = {k: float((a[k].double() - b[k].double()).norm() / b[k].double().norm())
           for k in b}
    k = max(rel, key=rel.get)
    return rel[k], k


def _rel_max(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()
                     / b[k].double().abs().max()) for k in b)


def main():
    with layout_mode("NHWC"):
        prog = pt.build(resnet.make_model(depth=50, class_num=1000, image_size=IMAGE,
                                          data_format="NHWC"))
    threads = torch.get_num_threads()
    for batch in (4, 16):
        feeds = _feeds(batch)
        params, state = prog.init(0, place=CPU, **feeds[0])
        grads = []
        for n in (1, 8):
            torch.set_num_threads(n)
            grads.append(_run(prog, params, state, feeds, torch.float32, 0.1, 1)[1])
        torch.set_num_threads(threads)
        rel, k = _worst_l2(grads[0], grads[1])
        print(f"batch {batch}: f32 step-1 grads with 1 against 8 threads, worst rel L2 "
              f"{rel:.3g} ({k})", flush=True)
    feeds = _feeds(16)
    params, state = prog.init(0, place=CPU, **feeds[0])
    for lr in (0.1, 1e-4):
        l32, g32, s32 = _run(prog, params, state, feeds, torch.float32, lr, STEPS)
        with _float64():
            l64, g64, s64 = _run(prog, params, state, feeds, torch.float64, lr, STEPS)
        rel, k = _worst_l2(g32, g64)
        print(f"batch 16, Momentum({lr}, 0.9), f32 against float64: step-1 grads worst rel "
              f"L2 {rel:.3g} ({k}); losses rel "
              f"{[f'{abs(a - b) / abs(b):.3g}' for a, b in zip(l32, l64)]}; moving stats "
              f"after each step {[f'{_rel_max(a, b):.3g}' for a, b in zip(s32, s64)]} of max",
              flush=True)


if __name__ == "__main__":
    main()
