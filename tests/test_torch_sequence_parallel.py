"""Sequence parallelism of the port (ring and Ulysses attention over the
mesh's ``sp`` axis, and GPT training through them) against
``paddle_tpu.parallel.ring_attention`` / ``ulysses`` and the JAX GPT.

On one spawned gloo world of 4 ranks (``torch_dist_worker.py``, suite
"sequence"): attention over q, k, v [2, 4, 32, 16] f32 from a numpy seed,
non-causal and causal, through the plain ring, the zigzag ring (on an
sp=4 mesh and on a dp2×sp2 mesh) and Ulysses (the flash kernel inside);
its output and its grads under a fixed cotangent. Then five Momentum
steps of the 2-layer GPT (seq 64, batch 8, dropout 0) at sp=4, ring
(activations in zigzag order end to end) and Ulysses, against the JAX
Trainer with the same ``DistStrategy`` on 4 virtual CPU devices and
against the port's single-rank Trainer. On the CPU every ring step runs
the plain versions of the flash kernels (the JAX side its Pallas kernels
in interpret mode).

Tolerances: attention outputs and grads 1e-5 (relative, plus 1e-5 of the
largest magnitude for elements near 0): per-shard softmaxes merged in
log space round differently from one softmax over the whole row. GPT
losses 1e-5 relative, params 1e-5 of each param's largest magnitude."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.ops.flash_attention import flash_attention as jflash
from paddle_tpu.parallel.ring_attention import (causal_work_per_rank as j_work,
                                                zigzag_order as j_zigzag)
from paddle_tpu.parallel.ring_attention import ring_attention as jring
from paddle_tpu.parallel.ulysses import ulysses_attention as julysses

from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.parallel import ring_attention as tra

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402
from torch_dist_jax import jax_run, write_initial_params  # noqa: E402


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sp_world"))
    write_initial_params(d)
    return dict(np.load(W.spawn_world("sequence", d, d)))


def _jax_attention(name):
    impl, causal, schedule, axes = W.ATTN_CASES[name]
    mesh = pt.make_mesh(axes, devices=jax.devices()[:4])
    q, k, v, g = (jnp.asarray(a) for a in W.qkv())

    def f(q_, k_, v_):
        if impl == "ring":
            return jring(q_, k_, v_, mesh, causal=causal, schedule=schedule)
        return julysses(q_, k_, v_, mesh, causal=causal,
                        attn_fn=lambda a, b, c, cz: jflash(a, b, c, causal=cz))

    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    return [np.asarray(out)] + [np.asarray(x) for x in vjp(g)]


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(W.ATTN_CASES))
def test_attention_matches_paddle_tpu(world, name):
    out, dq, dk, dv = _jax_attention(name)
    _close(world[f"{name}/out"], out)
    for n_, want in zip(("dq", "dk", "dv"), (dq, dk, dv)):
        _close(world[f"{name}/{n_}"], want)


@pytest.mark.parametrize("name", sorted(W.SP_CASES))
def test_sp_training_matches_paddle_tpu(world, name):
    losses, params = jax_run(*W.SP_CASES[name])
    np.testing.assert_allclose(world[f"{name}/losses"], losses, rtol=1e-5)
    pre = f"{name}/param/"
    got = {k[len(pre):]: v for k, v in world.items() if k.startswith(pre)}
    assert set(got) == set(params)
    for k in params:
        _close_param(got[k], params[k], k)


@pytest.mark.parametrize("name", sorted(W.SP_CASES))
def test_sp_training_matches_the_single_rank_trainer(world, name):
    np.testing.assert_allclose(world[f"{name}/losses"], world[f"{name}/single_losses"],
                               rtol=1e-5)
    for key in world:
        if key.startswith(f"{name}/param/"):
            k = key[len(f"{name}/param/"):]
            _close_param(world[key], world[f"{name}/single_param/{k}"], k)


def _close_param(got, want, k):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_schedule_accounting_matches_paddle_tpu():
    for n in (1, 2, 4, 8):
        for s in ("ring", "zigzag"):
            assert tra.causal_work_per_rank(n, s) == j_work(n, s)
        assert tra.zigzag_order(64, n).tolist() == np.asarray(j_zigzag(64, n)).tolist()


def test_ring_steps_emulated_in_one_process_equal_whole_attention():
    """The ring's steps for n shards driven in one process, a rotation of
    the shard list standing for the exchange (as the chip smoke drives
    them), against flash attention on the whole sequence."""
    import torch
    from paddle_tpu_torch.ops.flash_attention import flash_attention as tflash

    q, k, v, g = (torch.from_numpy(a) for a in W.qkv())
    n = 4
    for causal, schedule in ((False, "ring"), (True, "ring"), (True, "zigzag")):
        order = tra.zigzag_order(32, n) if schedule == "zigzag" else torch.arange(32)
        sched = tra._ZigzagSchedule() if schedule == "zigzag" else tra._RingSchedule(causal)
        qs, ks, vs, gs = ([t[:, :, order].chunk(n, 2)[i] for i in range(n)]
                          for t in (q, k, v, g))
        outs, lses = [], []
        for idx in range(n):
            acc = torch.zeros_like(qs[idx])
            lse = torch.full(qs[idx].shape[:3], tra.NEG_INF)
            for i in range(n):
                src = (idx - i) % n
                acc, lse = tra.fwd_step(sched, qs[idx], ks[src], vs[src], acc, lse, idx, src)
            outs.append(acc)
            lses.append(lse)
        out = torch.cat(outs, 2)[:, :, torch.argsort(order)]
        want = tflash(q, k, v, causal=causal)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        dq = [torch.zeros_like(x) for x in qs]
        dk = [torch.zeros_like(x) for x in ks]
        dv = [torch.zeros_like(x) for x in vs]
        for idx in range(n):
            delta = (outs[idx] * gs[idx]).sum(-1)
            for i in range(n):
                src = (idx - i) % n
                dq[idx], dk[src], dv[src] = tra.bwd_step(
                    sched, qs[idx], ks[src], vs[src], outs[idx], lses[idx], gs[idx], delta,
                    dq[idx], dk[src], dv[src], idx, src)
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        tflash(qq, kk, vv, causal=causal).backward(g)
        inv = torch.argsort(order)
        for got, ref in ((dq, qq), (dk, kk), (dv, vv)):
            torch.testing.assert_close(torch.cat(got, 2)[:, :, inv], ref.grad,
                                       rtol=1e-5, atol=1e-5)


def test_sp_enforcements():
    import torch
    from paddle_tpu_torch.layers import stacked
    q = torch.zeros(1, 2, 8, 16)
    cfg = {"mesh": None, "axis": "sp", "impl": "ring"}
    with pytest.raises(EnforceError, match="padding bias"):
        stacked._sdpa(q, q, q, torch.zeros(1, 8), True, True, cfg)
    with pytest.raises(EnforceError, match="dropout"):
        stacked._sdpa(q, q, q, None, True, True, cfg, dropout_rate=0.1, training=True)
