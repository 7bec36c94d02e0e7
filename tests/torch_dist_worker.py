"""One rank of the port's multi-rank CPU tests: a gloo world of spawned
processes, each running every case of one suite on the port alone
(torch, numpy and ``paddle_tpu_torch``: no JAX here) and rank 0 writing
the results to ``<outdir>/<suite>.npz`` for the test file to hold against
the JAX package.

    python tests/torch_dist_worker.py SUITE RANK WORLD PORT OUTDIR [INDIR]

``INDIR`` holds what the test process wrote first (the JAX package's
initial params, a JAX-written checkpoint). :func:`spawn_world` starts a
world and waits for it. The data (:func:`mnist_feeds`, :func:`gpt_feeds`,
:func:`qkv`) is made here from numpy seeds, and the test files import it
from here, so both packages see the same inputs.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np

MNIST_BATCH, STEPS = 16, 5
GPT = dict(vocab_size=50, max_len=64, d_model=64, d_inner=128, num_heads=4, num_layers=2,
           use_flash=True, fused_ce=True, ce_chunk=16)
GPT_BATCH, GPT_SEQ = 8, 64
LR, MOMENTUM = 0.05, 0.9


# -- data, shared with the test files ---------------------------------------------


def mnist_feeds(n=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(MNIST_BATCH, 784).astype(np.float32),
             "label": rng.randint(0, 10, (MNIST_BATCH, 1)).astype(np.int64)}
            for _ in range(n)]


def gpt_feeds(n=STEPS, seed=0, batch=GPT_BATCH, seq=GPT_SEQ):
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(n):
        ids = rng.randint(3, GPT["vocab_size"], (batch, seq)).astype(np.int32)
        labels = np.concatenate([ids[:, 1:], np.full((batch, 1), 2)], 1).astype(np.int32)
        labels[0, -4:] = 0  # padding: out of the loss and the count
        feeds.append({"ids": ids, "labels": labels})
    return feeds


def qkv(b=2, h=4, s=32, d=16, seed=0):
    """q, k, v [b, h, s, d] f32 and a cotangent of the output's shape."""
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, s, d).astype(np.float32) for _ in range(4))


# the training cases: name -> (model, mesh axes, rules, strategy kwargs);
# the default exchange under each rule table
TRAIN_CASES = {
    "mnist_dp": ("mnist", {"dp": 4}, None, {}),
    "mnist_fsdp": ("mnist", {"fsdp": 4}, "fsdp", {}),
    "mnist_dp_tp": ("mnist", {"dp": 2, "tp": 2}, "tp", {}),
    "gpt_dp": ("gpt", {"dp": 4}, None, {}),
    "gpt_fsdp": ("gpt", {"fsdp": 4}, "fsdp", {}),
    "gpt_dp_tp": ("gpt", {"dp": 2, "tp": 2}, "tp", {}),
}
# the other exchanges, the loss scaler's skip and batch norm, at dp=4
EXCHANGE_CASES = {
    "mnist_dp_accum": ("mnist", {"dp": 4}, None, {"accum_steps": 2}),
    "mnist_hoisted": ("mnist", {"dp": 4}, None, {"accum_steps": 2,
                                                 "accum_exchange": "hoisted"}),
    "mnist_int8": ("mnist", {"dp": 4}, None, {"quantized_allreduce": "int8",
                                              "quant_block_size": 64}),
    "mnist_int8_sr": ("mnist", {"dp": 4}, None, {"quantized_allreduce": "int8",
                                                 "quant_block_size": 64,
                                                 "quant_stochastic_rounding": True}),
    "mnist_int4": ("mnist", {"dp": 4}, None, {"quantized_allreduce": "int4",
                                              "quant_block_size": 64}),
    "mnist_inf_scaler": ("mnist_inf", {"dp": 4}, None, {"loss_scale": 2.0 ** 10,
                                                        "dynamic_loss_scale": True}),
    "conv_dp": ("conv", {"dp": 4}, None, {}),
}
ZERO_CASES = {
    "mnist_zero": ("mnist", {"dp": 4}, None, {"zero_sharding": True}),
    "mnist_zero_int8": ("mnist", {"dp": 4}, None, {"zero_sharding": True,
                                                   "quantized_allreduce": "int8",
                                                   "quant_block_size": 64}),
    "gpt_zero": ("gpt", {"dp": 4}, None, {"zero_sharding": True}),
}
SP_CASES = {
    "gpt_sp_ring": ("gpt", {"sp": 4}, None, {"sequence_parallel": True, "sp_impl": "ring"}),
    "gpt_sp_ulysses": ("gpt", {"sp": 4}, None, {"sequence_parallel": True,
                                               "sp_impl": "ulysses"}),
    # heads sharded by the tp rules, gathered before Ulysses' all-to-all
    "gpt_tp_sp_ulysses": ("gpt", {"sp": 2, "tp": 2}, "tp", {"sequence_parallel": True,
                                                            "sp_impl": "ulysses"}),
}
# attention cases: name -> (impl, causal, schedule, mesh axes)
ATTN_CASES = {
    "ring": ("ring", False, "ring", {"sp": 4}),
    "ring_causal": ("ring", True, "ring", {"sp": 4}),
    "zigzag": ("ring", True, "zigzag", {"sp": 4}),
    "zigzag_dp": ("ring", True, "zigzag", {"dp": 2, "sp": 2}),
    "ulysses": ("ulysses", False, None, {"sp": 4}),
    "ulysses_causal": ("ulysses", True, None, {"sp": 4}),
}
FSDP_MIN = 64


def spawn_world(suite: str, outdir: str, indir: str = "", world: int = 4,
                timeout: float = 240.0) -> str:
    """Run ``suite`` on a gloo world of ``world`` processes; return the
    path of its results. A rank that fails fails the world, with its
    output in the error."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r),
                               str(world), str(port), outdir, indir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    deadline = time.time() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"{suite}: ranks {bad} failed:\n" + "\n".join(
            logs[i][-4000:] for i in bad))
    return os.path.join(outdir, f"{suite}.npz")


# -- the port's side ------------------------------------------------------------------


def _rank():
    import torch.distributed as dist
    return dist.get_rank()


def _np(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy()


def _rules(name):
    from paddle_tpu_torch import parallel as par
    return {None: None, "fsdp": par.fsdp(FSDP_MIN), "tp": par.transformer_tp_rules()}[name]


def _program(model):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gpt, mnist
    return pt.build({"mnist": mnist.mlp, "conv": mnist.conv_net}.get(model) or
                    gpt.make_model(gpt.base_config(**GPT)))


def _feeds(model):
    if model == "gpt":
        return gpt_feeds()
    feeds = mnist_feeds()
    if model == "mnist_inf":
        # an infinite pixel in one row of the third batch: a loss-scaled
        # step that every rank must skip, whichever holds the row
        feeds[2]["image"][13, 7] = np.inf
    return feeds


def _trainer(model, axes, rules, skw, indir, mesh=None):
    """A Momentum Trainer of ``model`` on ``axes`` (None: one device) from
    the JAX package's initial params where the test wrote them, else from
    the port's init at seed 0 (the same on every rank)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework, optimizer, parallel as par

    path = os.path.join(indir, f"params_{model.split('_')[0]}.npz")
    init = (framework.params_from_jax(dict(np.load(path)), device="cpu")
            if os.path.exists(path) else None)
    if axes is not None and mesh is None:
        mesh = par.make_mesh(axes)
    tr = pt.Trainer(_program(model.split("_")[0]), optimizer.Momentum(LR, MOMENTUM),
                    place=pt.CPUPlace(), mesh=mesh, sharding_rules=_rules(rules),
                    strategy=pt.DistStrategy(**skw) if skw else None, fetch_list=["loss"])
    tr.startup(0, _feeds(model)[0], params=init)
    return tr


# the strategy fields a single-rank reference run keeps
SINGLE_FIELDS = ("accum_steps", "loss_scale", "dynamic_loss_scale")


def _train(res, name, case, indir, single=True):
    model, axes, rules, skw = case
    feeds = _feeds(model)
    tr = _trainer(model, axes, rules, skw, indir)
    outs = [tr.step(f) for f in feeds]
    res[f"{name}/losses"] = np.array([float(o["loss"]) for o in outs])
    if "loss_scale" in outs[0]:
        res[f"{name}/scales"] = np.array([float(o["loss_scale"]) for o in outs])
    for k, v in tr._logical_params().items():
        res[f"{name}/param/{k}"] = _np(v)
    for k, v in tr.scope.state.items():
        res[f"{name}/state/{k}"] = _np(v)
    if single and _rank() == 0:
        # the port's own single-rank Trainer on the whole batches (rank 0,
        # which writes the results, runs it alone)
        ref = _trainer(model, None, None, {k: v for k, v in skw.items()
                                           if k in SINGLE_FIELDS}, indir)
        routs = [ref.step(f) for f in feeds]
        res[f"{name}/single_losses"] = np.array([float(o["loss"]) for o in routs])
        if "loss_scale" in routs[0]:
            res[f"{name}/single_scales"] = np.array([float(o["loss_scale"]) for o in routs])
        for k, v in ref.scope.params.items():
            res[f"{name}/single_param/{k}"] = _np(v)
        for k, v in ref.scope.state.items():
            res[f"{name}/single_state/{k}"] = _np(v)
    return tr


def suite_training(res, indir):
    from paddle_tpu_torch.parallel import sharding
    for name, case in TRAIN_CASES.items():
        tr = _train(res, name, case, indir)
        if name in ("gpt_fsdp", "gpt_dp_tp"):
            # the placements the rule tables gave: each param's spec and its
            # local shard's shape on this rank
            for k, p in tr.scope.params.items():
                res[f"{name}/spec/{k}"] = np.array(repr(sharding.spec_of(
                    p.placements, tr.mesh, p.dim())))
                res[f"{name}/local_shape/{k}"] = np.array(p.to_local().shape)


def suite_exchanges(res, indir):
    import paddle_tpu_torch as pt
    for name, case in EXCHANGE_CASES.items():
        tr = _train(res, name, case, indir)
        cb = tr.collective_bytes
        res[f"{name}/wire_bytes"] = np.array([cb["fp32_bytes_per_step"],
                                              cb["wire_bytes_per_step"]])
    # fit and eval on a mesh: fit takes the step loop's steps, eval gives
    # the single-rank Trainer's loss from the same params
    model, axes, rules, skw = TRAIN_CASES["mnist_dp"]
    loop = _train(res, "loop", TRAIN_CASES["mnist_dp"], indir, single=False)
    del loop
    tr = _trainer(model, axes, rules, skw, indir)
    feeds = _feeds(model)
    reader = lambda: iter([list(zip(f["image"], f["label"])) for f in feeds])  # noqa: E731
    pt.fit(tr, reader, 1, ["image", "label"], prefetch=False)
    for k, v in tr._logical_params().items():
        res[f"fit/param/{k}"] = _np(v)
    res["fit/global_step"] = np.array(tr.global_step)
    ref = _trainer(model, None, None, {}, indir)
    for f in feeds:
        ref.step(f)
    res["eval/loss"] = np.array([float(tr.eval(feeds[0])["loss"]),
                                 float(ref.eval(feeds[0])["loss"])])


def suite_zero(res, indir):
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io, parallel as par

    for name, case in ZERO_CASES.items():
        tr = _train(res, name, case, indir)
        cb = tr.collective_bytes
        res[f"{name}/allgather_bytes"] = np.array(cb["zero"]["allgather_bytes_per_step"])
        res[f"{name}/row_shape"] = np.array(next(iter(tr.scope.params.values()))
                                            .to_local().shape)
    # same-N save and restore: bit for bit, and the next step equal
    model, axes, rules, skw = ZERO_CASES["mnist_zero"]
    feeds = _feeds(model)
    tr = _trainer(model, axes, rules, skw, indir)
    tr.step(feeds[0])
    ck = os.path.join(indir, "port_zero_ck")
    io.save_trainer(ck, tr)
    back = _trainer(model, axes, rules, skw, indir)
    io.load_trainer(ck, back)
    saved = {k: _np(v) for k, v in back._logical_params().items()}
    same = all(torch.equal(a.to_local(), b.to_local())
               for a, b in zip(tr.scope.params.values(), back.scope.params.values()))
    same &= all(torch.equal(tr.scope.opt_state["accums"][k]["velocity"].to_local(),
                            back.scope.opt_state["accums"][k]["velocity"].to_local())
                for k in tr.scope.params)
    flags = torch.tensor([float(same)])
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    res["restore/bit_equal"] = flags.numpy()
    res["restore/next_loss"] = np.array([float(tr.step(feeds[1])["loss"]),
                                         float(back.step(feeds[1])["loss"])])
    res["restore/files"] = np.array(sorted(os.listdir(ck)))
    # a layout change is gated: a replicated trainer refuses the ZeRO dir
    plain = _trainer(model, axes, rules, {}, indir)
    try:
        io.load_trainer(ck, plain)
        res["restore/gated"] = np.array(0)
    except Exception as e:  # ReshardError
        res["restore/gated"] = np.array(int(type(e).__name__ == "ReshardError"))
    # and with allow_reshard the gathered tensors are placed replicated
    io.load_trainer(ck, plain, allow_reshard=True)
    res["restore/gathered_equal"] = np.array(int(all(
        np.array_equal(_np(plain.scope.params[k]), v) for k, v in saved.items())))
    # the JAX-written ZeRO checkpoint, restored shard-locally
    jck = os.path.join(indir, "jax_zero_ck")
    if os.path.isdir(jck):
        jt = _trainer(model, axes, rules, skw, indir)
        io.load_trainer(jck, jt)
        for k, v in jt._logical_params().items():
            res[f"jax_ck/param/{k}"] = _np(v)
        res["jax_ck/global_step"] = np.array(jt.global_step)
        res["jax_ck/next_loss"] = np.array(float(jt.step(feeds[2])["loss"]))
    # a mesh trainer's checkpoint is saved unsharded: one params.npz
    dp = _trainer("gpt", {"fsdp": 4}, "fsdp", {}, indir)
    dck = os.path.join(indir, "port_fsdp_ck")
    io.save_trainer(dck, dp)
    if dist.get_rank() == 0:
        p, _, _, meta = io.load_persistables(dck)
        res["fsdp_ck/mesh_axes"] = np.array(repr(meta["mesh_axes"]))
        for k, v in p.items():
            res[f"fsdp_ck/param/{k}"] = v.float().numpy()
    dist.barrier()


def suite_sequence(res, indir):
    import torch
    from paddle_tpu_torch import parallel as par
    from paddle_tpu_torch.ops.flash_attention import flash_attention
    from paddle_tpu_torch.parallel import api, ring_attention as ra, ulysses

    q0, k0, v0, g0 = qkv()
    meshes = {}
    for name, (impl, causal, schedule, axes) in ATTN_CASES.items():
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = par.make_mesh(axes)
        mesh = meshes[key]
        ts = [api.replicate(mesh, torch.from_numpy(a.copy())).requires_grad_(True)
              for a in (q0, k0, v0)]
        if impl == "ring":
            out = ra.ring_attention(*ts, mesh, causal=causal, schedule=schedule)
        else:
            out = ulysses.ulysses_attention(*ts, mesh, causal=causal,
                                            attn_fn=lambda a, b, c, cz:
                                            flash_attention(a, b, c, causal=cz))
        res[f"{name}/out"] = _np(out)
        (out * api.replicate(mesh, torch.from_numpy(g0))).sum().backward()
        for n_, t in zip("qkv", ts):
            res[f"{name}/d{n_}"] = _np(t.grad)
    for name, case in SP_CASES.items():
        _train(res, name, case, indir)


QUANT_CASES = {"int8_b16": (8, 16), "int8_chunk": (8, None), "int4_b16": (4, 16)}


def quant_input(rank: int, shape=(3, 37)):
    """Rank ``rank``'s input to the quantized all-reduce (an outlier in
    one block)."""
    x = np.random.RandomState(100 + rank).randn(*shape).astype(np.float32)
    x[1, 5] = 40.0 * (rank + 1)
    return x


def suite_mesh(res, indir):
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel as par, sparse
    from paddle_tpu_torch.core.errors import EnforceError
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import api, quantized_collectives as qc

    rank = dist.get_rank()
    m = par.make_mesh({"dp": 2, "tp": -1})
    res["mesh/shape"] = np.array(list(m.shape.items()), dtype=object).astype(str)
    res["mesh/dp_size"] = np.array(par.data_parallel_size(m))
    res["mesh/devices"] = m.devices
    for name, axes in (("mismatch", {"dp": 3}), ("infer", {"dp": 3, "tp": -1})):
        try:
            par.make_mesh(axes)
            res[f"mesh/err_{name}"] = np.array("")
        except ValueError as e:
            res[f"mesh/err_{name}"] = np.array(str(e))
    # put_batch: the local contract, the whole batch sliced, stacked feeds
    feed = mnist_feeds(1)[0]
    loc = {k: v[rank * 4:(rank + 1) * 4] for k, v in feed.items()}
    mesh4 = par.make_mesh({"dp": 4})
    for name, kw, f in (("local", {}, loc), ("global", {"global_batch": True}, feed)):
        out = api.put_batch(mesh4, None, f, **kw)
        res[f"put/{name}/shape"] = np.array(out["image"].shape)
        res[f"put/{name}/image"] = _np(out["image"])
    st = api.put_batch(mesh4, None, {"x": np.arange(2 * 8 * 3, dtype=np.float32)
                                     .reshape(2, 8, 3)}, stacked=True, global_batch=True)
    res["put/stacked/local"] = st["x"].to_local().numpy()
    # the quantized ring: the same bits on every rank
    for name, (bits, block) in QUANT_CASES.items():
        y = qc.quantized_psum(torch.from_numpy(quant_input(rank)), None, bits=bits,
                              block_size=block)
        allv = [torch.empty_like(y) for _ in range(dist.get_world_size())]
        dist.all_gather(allv, y)
        res[f"quant/{name}"] = y.numpy()
        res[f"quant/{name}/same_on_ranks"] = np.array(int(all(torch.equal(a, y)
                                                              for a in allv)))
        res[f"quant/{name}/pmean"] = qc.quantized_pmean(
            torch.from_numpy(quant_input(rank)), None, bits=bits, block_size=block).numpy()
    # a sharded lookup over ep, against the plain lookup, with grads
    rng = np.random.RandomState(7)
    table = rng.randn(16, 6).astype(np.float32)
    ids = rng.randint(0, 16, (4, 5)).astype(np.int64)
    cot = rng.randn(4, 5, 6).astype(np.float32)
    for name, axes in (("ep", {"ep": 4}), ("dp_ep", {"dp": 2, "ep": 2})):
        mesh = par.make_mesh(axes)
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        ep = mesh.dim("ep")
        tpl = [Shard(0) if d == ep else Replicate() for d in range(len(mesh.axis_names))]
        tbl = distribute_tensor(torch.from_numpy(table), mesh.device_mesh, tpl)
        tbl.requires_grad_(True)
        ipl = [Shard(0) if a == "dp" else Replicate() for a in mesh.axis_names]
        dids = distribute_tensor(torch.from_numpy(ids), mesh.device_mesh, ipl)
        out = sparse.sharded_embedding_lookup(tbl, dids, mesh)
        res[f"lookup/{name}/out"] = _np(out)
        res[f"lookup/{name}/placements"] = np.array(repr(out.placements))
        (out * api.replicate(mesh, torch.from_numpy(cot))).sum().backward()
        res[f"lookup/{name}/dtable"] = _np(tbl.grad)
    # a DTensor handed to a kernel launch raises, before any device work
    d = api.replicate(mesh4, torch.zeros(1, 1, 4, 32))
    try:
        fa.flash_fwd_cuda(d, d, d, False)
        res["kernel/refused"] = np.array("")
    except EnforceError as e:
        res["kernel/refused"] = np.array(str(e))
    # a dim split over two axes listed out of the mesh's order: fsdp major
    from torch.distributed.tensor import distribute_tensor as _dist
    from paddle_tpu_torch.parallel import sharding as tsh
    m22 = par.make_mesh({"dp": 2, "fsdp": 2})
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    for name, spec in (("fsdp_dp", tsh.P(("fsdp", "dp"))), ("dp_fsdp", tsh.P(("dp", "fsdp")))):
        dt = _dist(full, m22.device_mesh, tsh.placements(spec, m22))
        blocks = [torch.empty_like(dt.to_local()) for _ in range(dist.get_world_size())]
        dist.all_gather(blocks, dt.to_local().contiguous())
        res[f"g1/{name}/blocks"] = np.stack([b.numpy() for b in blocks])
        res[f"g1/{name}/full"] = _np(dt * 2.0)
        res[f"g1/{name}/spec"] = np.array(repr(tsh.spec_of(dt.placements, m22, 2)))
    # a Trainer's place must agree with its mesh
    try:
        pt.Trainer(_program("mnist"), None, place="cuda", mesh=mesh4)
        res["trainer/place_mismatch"] = np.array("")
    except EnforceError as e:
        res["trainer/place_mismatch"] = np.array(str(e))


# -- pipeline parallelism (suite "pipeline") ------------------------------------------

# the stacked Transformer of tests/test_pipeline_transformer_e2e.py:20-26; the
# port's side takes the flash route (its plain version on the CPU)
PP_CFG = dict(src_vocab=64, trg_vocab=64, d_model=32, d_inner=64, num_heads=4,
              num_encoder_layers=4, num_decoder_layers=4, dropout=0.0, stacked=True)
PP_BATCH, PP_SEQ, PP_STEPS, PP_LR = 8, 12, 3, 1e-3
# name -> (mesh axes, strategy kwargs)
PP_CASES = {
    "pp4": ({"pp": 4}, {"pp_microbatches": 4}),
    "dp2_pp2_v2": ({"dp": 2, "pp": 2}, {"pp_microbatches": 4, "pp_interleave": 2}),
    "tp2_pp2": ({"pp": 2, "tp": 2}, {"pp_microbatches": 4}),
}
PP_ACCUM = ({"dp": 2, "pp": 2}, {"accum_steps": 2, "pp_microbatches": 2}, 16)


def _tp_specs():
    from paddle_tpu_torch.parallel.sharding import P
    return {"w1": P(None, "tp"), "w2": P("tp")}


# name -> (mesh axes, interleave, param_layout, param specs or None): the
# schedule on a world, as tests/test_pipeline.py runs the JAX one
PP_APPLY_CASES = {
    "dp2_pp2_v2_stacked": ({"dp": 2, "pp": 2}, 2, "stacked", None),
    "dp2_pp2_v2_interleaved": ({"dp": 2, "pp": 2}, 2, "interleaved", None),
    "pp2_tp2_mlp": ({"pp": 2, "tp": 2}, 1, "stacked", "tp"),
    "dp2_tp2_mlp": ({"dp": 2, "tp": 2}, 1, "stacked", "tp"),
}


def pp_apply_inputs(name):
    """(stacked params, x, cotangent) of a case: 4 layers of d 8."""
    rng = np.random.RandomState(5)
    if PP_APPLY_CASES[name][3]:
        st = {"w1": (rng.randn(4, 8, 16) * 0.3).astype(np.float32),
              "w2": (rng.randn(4, 16, 8) * 0.3).astype(np.float32)}
    else:
        st = {"w": (rng.randn(4, 8, 8) * 0.3).astype(np.float32),
              "b": (rng.randn(4, 8) * 0.1).astype(np.float32)}
    if PP_APPLY_CASES[name][2] == "interleaved":
        from paddle_tpu_torch.parallel.pipeline import interleave_perm
        perm = interleave_perm(4, 2, PP_APPLY_CASES[name][1])
        st = {k: a[perm] for k, a in st.items()}
    return st, rng.randn(8, 8).astype(np.float32), rng.randn(8, 8).astype(np.float32)


def pp_tanh_layer(x, p):
    import torch
    return torch.tanh(x @ p["w"] + p["b"])


def pp_mlp_layer(x, p):
    """tests/test_pipeline.py's Megatron MLP stage: w1 column-sharded, w2
    row-sharded, the partial sums summed over tp."""
    import torch
    from paddle_tpu_torch.parallel.pipeline import psum
    return psum(torch.relu(x @ p["w1"]) @ p["w2"], "tp") + x


def pp_feed(bs, seq=PP_SEQ, vocab=64, seed=0):
    """tests/test_pipeline_transformer_e2e.py's ``_feed``."""
    rng = np.random.RandomState(seed)
    src = rng.randint(3, vocab, (bs, seq)).astype(np.int32)
    trg = np.roll(src, 1, axis=1)
    trg[:, 0] = 1
    labels = np.concatenate([trg[:, 1:], np.full((bs, 1), 2)], axis=1).astype(np.int32)
    return {"src_ids": src, "trg_ids": trg, "labels": labels}


def _pp_trainer(axes, skw, indir, use_flash=True):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework, optimizer, parallel as par
    from paddle_tpu_torch.models import transformer

    init = framework.params_from_jax(dict(np.load(os.path.join(indir, "params_pp.npz"))),
                                     device="cpu")
    cfg = transformer.base_config(**PP_CFG, use_flash=use_flash)
    mesh = par.make_mesh(axes) if axes else None
    tr = pt.Trainer(pt.build(transformer.make_model(cfg)), optimizer.Adam(PP_LR),
                    place=pt.CPUPlace(), mesh=mesh,
                    sharding_rules=par.transformer_tp_rules() if axes else None,
                    strategy=pt.DistStrategy(**skw) if skw else None, fetch_list=["loss"])
    return tr.startup(0, pp_feed(PP_BATCH), params=init)


def _catch(fn):
    try:
        fn()
        return ""
    except Exception as e:  # the message is what the test holds
        return f"{type(e).__name__}: {e}"


def suite_pipeline(res, indir):
    import warnings
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework, io, optimizer, parallel as par
    from paddle_tpu_torch.layers import stacked as S
    from paddle_tpu_torch.layers.nn import dropout
    from paddle_tpu_torch.models import mnist
    from paddle_tpu_torch.parallel import pipeline as pp
    from paddle_tpu_torch.parallel import sharding

    rank = dist.get_rank()
    feeds = [pp_feed(PP_BATCH, seed=i) for i in range(PP_STEPS)]
    for name, (axes, skw) in PP_CASES.items():
        tr = _pp_trainer(axes, skw, indir)
        res[f"{name}/losses"] = np.array([float(tr.step(f)["loss"]) for f in feeds])
        for k, p in tr.scope.params.items():
            if "_stack/" in k:
                res[f"{name}/spec/{k}"] = np.array(repr(sharding.spec_of(
                    p.placements, tr.mesh, p.dim())))
                res[f"{name}/local_shape/{k}"] = np.array(p.to_local().shape)
        if name == "dp2_pp2_v2":
            inter = tr
    if rank == 0:
        ref = _pp_trainer(None, None, indir)
        res["single/losses"] = np.array([float(ref.step(f)["loss"]) for f in feeds])
        res["single/eval"] = np.array(float(ref.eval(feeds[0])["loss"]))
    # the interleaved trainer: its rest layout, eval through the schedule, its
    # checkpoint in logical order, and its own round trip
    res["inter/perm_names"] = np.array(sorted(inter._pp_perm))
    res["inter/eval"] = np.array(float(inter.eval(feeds[0])["loss"]))
    res["inter/eval_batch_error"] = np.array(_catch(lambda: inter.eval(pp_feed(6))))
    ck = os.path.join(indir, "pp_inter_ck")
    io.save_trainer(ck, inter)
    first = sorted(inter._pp_perm)[0]
    full = {k: v.full_tensor().detach() for k, v in inter.scope.params.items()}
    m1 = inter.scope.opt_state["accums"][first]["moment1"].full_tensor()
    logical, lopt = inter.stacked_to_logical(full, {"accums": {first: {"moment1": m1}}})
    if rank == 0:
        saved, _, opt, _ = io.load_persistables(ck)
        res["ck/logical_equal"] = np.array(int(all(
            torch.equal(saved[k], logical[k]) for k in logical)))
        res["ck/rest_differs"] = np.array(int(all(
            not torch.equal(saved[k], full[k]) for k in inter._pp_perm)))
        res["ck/moment_logical"] = np.array(int(torch.equal(
            opt["accums"][first]["moment1"], lopt["accums"][first]["moment1"])))
        one = _pp_trainer(None, None, indir)
        io.load_trainer(ck, one, allow_reshard=True)
        res["ck/single_eval"] = np.array(float(one.eval(feeds[0])["loss"]))
        # the {dp, pp} -> one-device restore through the elastic door
        # (tests/test_pipeline_transformer_e2e.py:247-288)
        from paddle_tpu_torch import resilience
        el = _pp_trainer(None, None, indir)
        res["ck/plain_load_error"] = np.array(_catch(lambda: io.load_trainer(ck, el)))
        rep = resilience.reshard_restore(ck, el, sample_feed=feeds[0])
        res["ck/reshard_axes"] = np.array(repr((rep["saved_axes"], rep["target_axes"])))
        res["ck/reshard_eval"] = np.array(float(el.eval(feeds[0])["loss"]))
    before = {k: v.full_tensor().detach().clone() for k, v in inter.scope.params.items()}
    io.load_trainer(ck, inter)
    res["ck/roundtrip_equal"] = np.array(int(all(
        torch.equal(inter.scope.params[k].full_tensor(), v) for k, v in before.items())))
    res["ck/next_loss"] = np.array(float(inter.step(feeds[1])["loss"]))
    # accum_steps x pp_microbatches
    axes, skw, bs = PP_ACCUM
    big = pp_feed(bs, seed=9)
    acc = _pp_trainer(axes, skw, indir)
    res["accum/loss"] = np.array(float(acc.step(big)["loss"]))
    if rank == 0:
        aref = _pp_trainer(None, {"accum_steps": 2}, indir)
        res["accum/single_loss"] = np.array(float(aref.step(big)["loss"]))
    # dropout on the pipeline path: an identity stack of dropout blocks
    mesh = par.make_mesh({"dp": 2, "pp": 2})
    L_, B_, D_ = 2, 4, 64

    def make_block(num_heads, use_flash, causal, tp_axis, sp_cfg, dropout_rate=0.0,
                   compute_dtype=None, training=False):
        def block(x, lp):
            return dropout(x * lp["w"][0], dropout_rate,
                           dropout_implementation="upscale_in_train")
        return block

    def net(x):
        stack = {"w": torch.ones((L_, 1))}
        h = S.apply_stacked(x, stack, make_block, num_heads=1, dropout_rate=0.5)
        return {"out": h}

    prog = pt.build(net)
    xin = torch.ones((B_, D_))
    with framework.pipeline_mode(mesh, 2):
        outs = [prog.apply({}, {}, x=xin, training=True, rng=r, place=pt.CPUPlace())[0]["out"]
                for r in (7, 7, 8)]
    kept = [(o != 0).float().numpy() for o in outs]
    res["dropout/kept"] = np.stack(kept)
    # pipeline_apply itself on plain tensors (taken as replicated): both
    # layouts of the interleaved schedule, and tp stages with and without pp
    for name, (axes, v, layout, specs) in PP_APPLY_CASES.items():
        m_ = par.make_mesh(axes)
        st, x, g = pp_apply_inputs(name)
        ts = {k: torch.from_numpy(a).requires_grad_(True) for k, a in st.items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        layer = pp_mlp_layer if specs else pp_tanh_layer
        out = pp.pipeline_apply(tx, ts, layer, m_, microbatches=2, interleave=v,
                                param_layout=layout,
                                param_specs=_tp_specs() if specs else None)
        res[f"apply/{name}/out"] = out.detach().numpy()
        (out * torch.from_numpy(g)).sum().backward()
        res[f"apply/{name}/dx"] = tx.grad.numpy()
        for k, t in ts.items():
            res[f"apply/{name}/d{k}"] = t.grad.numpy()
    # the enforcements
    x8 = torch.zeros(8, 4)
    st8 = {"w": torch.zeros(4, 4, 4)}
    lay = lambda a, p_: a @ p_["w"]  # noqa: E731
    res["err/layers"] = np.array(_catch(lambda: pp.pipeline_apply(
        x8, st8, lay, mesh, microbatches=2, interleave=3)))
    res["err/batch"] = np.array(_catch(lambda: pp.pipeline_apply(
        torch.zeros(6, 4), st8, lay, mesh, microbatches=4)))
    res["err/dshard"] = np.array(_catch(lambda: pp.pipeline_apply(
        torch.zeros(4, 4), st8, lay, mesh, microbatches=4)))
    # a model with no stacked blocks never consumes the pipeline: warned
    m4 = par.make_mesh({"pp": 4})
    mtr = pt.Trainer(pt.build(mnist.mlp), optimizer.SGD(0.1), place=pt.CPUPlace(), mesh=m4,
                     strategy=pt.DistStrategy(pp_microbatches=4), fetch_list=["loss"])
    mtr.startup(0, mnist_feeds(1)[0])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mtr.step(mnist_feeds(1)[0])
    res["warn/unconsumed"] = np.array([str(x.message) for x in w
                                       if "never consumed" in str(x.message)] or [""])


# -- mixture of experts (suite "moe") --------------------------------------------------

MOE_LAYER = dict(b=8, s=4, d=16, E=8, ff=32, top_k=2, cf=8.0)
MOE_CFG = dict(vocab_size=64, max_len=32, d_model=32, d_inner=64, d_expert=64,
               num_heads=4, num_layers=2, num_experts=8, top_k=2, moe_every=2,
               fused_ce=False, aux_weight=0.0, capacity_factor=4.0)
MOE_BATCH, MOE_SEQ, MOE_STEPS, MOE_LR = 8, 16, 2, 1e-3
# ep=4 and dp2×ep2 take the ep path; dp=4 the dense path on a mesh
MOE_MESHES = {"ep4": {"ep": 4}, "dp2_ep2": {"dp": 2, "ep": 2}, "dp4": {"dp": 4}}


def moe_input(c=MOE_LAYER, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(c["b"], c["s"], c["d"]).astype(np.float32),
            rng.randn(c["b"], c["s"], c["d"]).astype(np.float32))


def moe_feed(bs=MOE_BATCH, seq=MOE_SEQ, vocab=64, seed=0):
    """tests/test_moe_transformer.py's ``_feed``."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, (bs, seq)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((bs, 1), 2)], axis=1).astype(np.int32)
    return {"ids": ids, "labels": labels}


def moe_layer_program(mesh=None, c=MOE_LAYER):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.moe import moe

    def fn(x):
        out, aux = moe(x, num_experts=c["E"], d_ff=c["ff"], top_k=c["top_k"],
                       capacity_factor=c["cf"], mesh=mesh)
        return {"out": out, "aux": aux}
    return pt.build(fn)


def _moe_trainer(mesh, indir):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework, optimizer, parallel as par
    from paddle_tpu_torch.models import moe_transformer

    init = framework.params_from_jax(dict(np.load(os.path.join(indir, "params_moe.npz"))),
                                     device="cpu")
    prog = pt.build(moe_transformer.make_model(moe_transformer.base_config(**MOE_CFG),
                                               mesh=mesh))
    rules = (par.ShardingRules(list(par.moe_ep_rules()), default=None)
             if mesh is not None else None)
    tr = pt.Trainer(prog, optimizer.Adam(MOE_LR), place=pt.CPUPlace(), mesh=mesh,
                    sharding_rules=rules, fetch_list=["loss"])
    return tr.startup(0, moe_feed(), params=init)


def suite_moe(res, indir):
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework, parallel as par
    from paddle_tpu_torch.parallel import api, sharding

    rank = dist.get_rank()
    x0, g0 = moe_input()
    lp = framework.params_from_jax(dict(np.load(os.path.join(indir, "params_moe_layer.npz"))),
                                   device="cpu")
    feeds = [moe_feed(seed=i) for i in range(MOE_STEPS)]
    for name, axes in MOE_MESHES.items():
        mesh = par.make_mesh(axes)
        # the layer: each rank's params DTensors by moe_ep_rules, the input
        # sharded over the data axes as the Trainer puts a batch
        rules = par.ShardingRules(list(par.moe_ep_rules()), default=None).adapted_to(mesh)
        params = rules.shard_params(mesh, lp)
        for p in params.values():
            p.requires_grad_(True)
        x = api.put_batch(mesh, None, {"x": x0}, global_batch=True)["x"].requires_grad_(True)
        from paddle_tpu_torch.parallel.moe import capture_moe_configs
        with capture_moe_configs() as log:
            out, _ = moe_layer_program(mesh).apply(params, {}, x=x, place=pt.CPUPlace())
        res[f"{name}/layer/config"] = np.array(repr(sorted(log[0].items())))
        res[f"{name}/layer/out"] = _np(out["out"])
        res[f"{name}/layer/aux"] = _np(out["aux"])
        g = api.put_batch(mesh, None, {"g": g0}, global_batch=True)["g"]
        (out["out"] * g).sum().backward()
        res[f"{name}/layer/dx"] = _np(x.grad)
        for k, p in params.items():
            res[f"{name}/layer/grad/{k}"] = _np(p.grad)
            res[f"{name}/layer/spec/{k}"] = np.array(repr(sharding.spec_of(
                p.placements, mesh, p.dim())))
        if "ep" in axes:  # the LM, trained through the ep path
            tr = _moe_trainer(mesh, indir)
            res[f"{name}/losses"] = np.array([float(tr.step(f)["loss"]) for f in feeds])
    if rank == 0:
        ref = _moe_trainer(None, indir)
        res["dense/losses"] = np.array([float(ref.step(f)["loss"]) for f in feeds])
        dense = moe_layer_program(None)
        ps = {k: v.clone().requires_grad_(True) for k, v in lp.items()}
        xx = torch.from_numpy(x0).requires_grad_(True)
        out, _ = dense.apply(ps, {}, x=xx, place=pt.CPUPlace())
        (out["out"] * torch.from_numpy(g0)).sum().backward()
        res["dense/layer/out"] = _np(out["out"])
        res["dense/layer/dx"] = _np(xx.grad)
        for k, p in ps.items():
            res[f"dense/layer/grad/{k}"] = _np(p.grad)


# -- elastic training (suites "elastic4" and "elastic2") ------------------------------

# tests/test_elastic_reshard.py's model and data: fc 6 -> 16 -> 4, batch 8
E_DIM, E_CLASSES, E_BS, E_BATCHES = 6, 4, 8, 8
E_FEED = {"x": np.zeros((E_BS, E_DIM), np.float32), "label": np.zeros((E_BS, 1), np.int64)}
E_AMP = dict(loss_scale=2.0 ** 10, dynamic_loss_scale=True)


def e_reader(n_batches=E_BATCHES, seed=7, bs=E_BS):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_batches):
            x = rng.randn(bs, E_DIM).astype(np.float32)
            y = rng.randint(0, E_CLASSES, (bs,)).astype(np.int64)
            yield [(x[j], y[j:j + 1]) for j in range(bs)]
    return reader


def _e_net(x, label):
    from paddle_tpu_torch import layers as L
    h = L.fc(x, 16, name="fc1")
    logits = L.fc(h, E_CLASSES, name="fc2")
    return {"loss": L.mean(L.softmax_with_cross_entropy(logits, label))}


def e_trainer(n, momentum=False, strategy=None, rules=None, place=None):
    """The elastic tests' Trainer on {dp: n} (one device at n = 1)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer, parallel as par
    tr = pt.Trainer(pt.build(_e_net),
                    optimizer.Momentum(0.1, 0.9) if momentum else optimizer.SGD(0.1),
                    loss_name="loss", place=place or pt.CPUPlace(),
                    mesh=par.make_mesh({"dp": n}) if n > 1 else None,
                    sharding_rules=rules, strategy=strategy)
    return tr.startup(0, sample_feed=E_FEED)


def e_rules(P):
    """tests/test_elastic_reshard.py:153's rules: every weight over dp."""
    from paddle_tpu_torch.parallel import ShardingRules
    return ShardingRules([(r".*/w$", P(None, "dp"))])


def e_fit(tr, root, reader=None, epochs=2, handler=None, step_interval=0, **kw):
    import paddle_tpu_torch as pt
    cfg = pt.CheckpointConfig(root, epoch_interval=0, step_interval=step_interval,
                              max_num_checkpoints=3)
    return pt.fit(tr, reader or e_reader(), num_epochs=epochs, feed_names=["x", "label"],
                  dtypes=["float32", "int64"], checkpoint_config=cfg, event_handler=handler,
                  prefetch=False, **kw)


def e_manual(tr, meta, epochs=2, n_batches=E_BATCHES):
    """fit's resumed tail as bare steps (tests/test_elastic_reshard.py:81)."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    feeder = DataFeeder(["x", "label"], ["float32", "int64"])
    losses = []
    for epoch in range(int(meta.get("epoch", 0)), epochs):
        skip = int(meta.get("epoch_step", 0)) if epoch == int(meta.get("epoch", 0)) else 0
        for i, samples in enumerate(e_reader(n_batches)()):
            if i >= skip:
                losses.append(float(tr.step(feeder.feed(samples))["loss"]))
    return losses


def _exact(t):
    """A tensor (a DTensor's whole value) as numpy, bit for bit (bfloat16
    as its 16-bit pattern)."""
    import torch
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().copy()


def _record_state(res, name, tr):
    """A restored trainer's state, whole and bit-exact, under ``name``."""
    from paddle_tpu_torch import io
    for k, v in tr.scope.params.items():
        res[f"{name}/param/{k}"] = _exact(v)
    for k, v in io._flatten(io._full_tree(tr.scope.opt_state or {})).items():
        res[f"{name}/opt/{k}"] = v.copy()
    for k, v in (tr.scope.loss_scale_state or {}).items():
        res[f"{name}/ls/{k}"] = _exact(v)
    res[f"{name}/global_step"] = np.array(tr.global_step)


def _reshard_case(res, name, ck, tr, feed=None):
    from paddle_tpu_torch import resilience
    rep = resilience.reshard_restore(ck, tr, sample_feed=E_FEED if feed is None else feed)
    _record_state(res, name, tr)
    res[f"{name}/report"] = np.array(repr((rep["saved_axes"], rep["target_axes"],
                                           rep["global_step"], rep["bytes_moved"] > 0)))
    res[f"{name}/next_loss"] = np.array(float(tr.step(E_FEED)["loss"]))


def _reshard_error(res, name, fn):
    from paddle_tpu_torch import resilience
    try:
        fn()
        res[f"{name}/error"] = np.array("")
    except resilience.ReshardError as e:
        res[f"{name}/error"] = np.array(str(e))
        res[f"{name}/axes"] = np.array(repr((e.saved_axes, e.target_axes)))


def _fit_losses(res, name, tr, root, ref_ck, n, **kw):
    """An elastic rejoin's losses and params, and the bare-step continuation
    of the same checkpoint on a fresh trainer of the same mesh."""
    from paddle_tpu_torch import resilience
    losses = []

    def collect(e):
        if e.kind == "end_step":
            m = e.metrics["loss"]
            m = m.full_tensor() if hasattr(m, "full_tensor") else m
            losses.extend(np.asarray(m.detach().float()).reshape(-1).tolist())
    epochs = kw.pop("epochs", 2)
    e_fit(tr, root, epochs=epochs, handler=collect, resume=True, elastic=True, **kw)
    res[f"{name}/losses"] = np.float32(losses)
    res[f"{name}/global_step"] = np.array(tr.global_step)
    ref = e_trainer(n)
    rep = resilience.reshard_restore(ref_ck, ref, sample_feed=E_FEED)
    res[f"{name}/ref_losses"] = np.float32(e_manual(ref, rep["meta"], epochs=epochs))
    res[f"{name}/params_equal"] = np.array(int(all(
        np.array_equal(_exact(tr.scope.params[k]), _exact(ref.scope.params[k]))
        for k in tr.scope.params)))


def suite_elastic4(res, indir):
    """dp=4: the sources the world of 2 restores, the restores of the JAX
    package's dp=2 checkpoints, the infeasible batch, the kill at step 5,
    the K=3 rejoin and the sharded restore across a mesh reshape."""
    import signal
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import io, parallel as par, resilience
    from paddle_tpu_torch.analysis import check_artifacts
    from paddle_tpu_torch.parallel import sharding

    j = lambda name: os.path.join(indir, name)  # noqa: E731
    # the dp=4 sources: Momentum after 2 steps; step_3 of the mismatch drill
    src = e_trainer(4, momentum=True)
    src.step(E_FEED)
    src.step(E_FEED)
    io.save_trainer(j("p4_mom_ck"), src)
    newer = e_trainer(4)
    newer.global_step = 3
    io.save_trainer(os.path.join(j("mm_root"), "step_3"), newer,
                    extra_meta={"epoch": 0, "epoch_step": 3})
    # dp 2 -> 4 restores of the JAX package's checkpoints
    _reshard_case(res, "r2to4", j("j2_mom_ck"), e_trainer(4, momentum=True))
    _reshard_case(res, "amp", j("j2_amp_ck"), e_trainer(4, strategy=_strategy(E_AMP)))
    rules_tr = e_trainer(4, rules=e_rules(sharding.P))
    _reshard_case(res, "rules", j("j2_rules_ck"), rules_tr)
    w = rules_tr.scope.params["fc1/w"]
    res["rules/spec"] = np.array(repr(sharding.spec_of(w.placements, rules_tr.mesh, w.dim())))
    res["rules/local_shape"] = np.array(w.to_local().shape)
    # an infeasible batch raises before any state changes, with the
    # static finding's own text
    tgt = e_trainer(4)
    before = {k: _exact(v) for k, v in tgt.scope.params.items()}
    small = {"x": np.zeros((2, E_DIM), np.float32), "label": np.zeros((2, 1), np.int64)}
    finding = check_artifacts(trainer=tgt, checkpoint_dir=j("j2_sgd_ck"), sample_feed=small)
    _reshard_error(res, "infeasible", lambda: resilience.reshard_restore(
        j("j2_sgd_ck"), tgt, sample_feed=small))
    res["infeasible/finding"] = np.array(
        finding.by_code("ckpt:reshard-infeasible")[0].message)
    res["infeasible/untouched"] = np.array(int(tgt.global_step == 0 and all(
        np.array_equal(_exact(v), before[k]) for k, v in tgt.scope.params.items())))
    # an elastic fit whose batch of 6 does not split 4 ways
    _reshard_error(res, "fit6", lambda: e_fit(e_trainer(4), j("j_fit6"),
                                              reader=e_reader(4, seed=5, bs=6), epochs=1,
                                              resume=True, elastic=True))
    # the fit the world of 2 resumes without elastic
    e_fit(e_trainer(4), j("fit4"), epochs=1, step_interval=4)
    # kill at step 5 by SIGTERM: the boundary checkpoint
    def kill5(e):
        if e.kind == "end_step" and e.step == 5:
            os.kill(os.getpid(), signal.SIGTERM)
    killed = e_fit(e_trainer(4), j("kill"), handler=kill5)
    res["kill/global_step"] = np.array(killed.global_step)
    # the K=2 run's checkpoint (the JAX package's, at dp=2) rejoined at K=3
    _fit_losses(res, "k3", e_trainer(4), j("j_k2"), j("j_k2_ref"), 4, epochs=1,
                steps_per_dispatch=3)
    # the sharded restore across a mesh reshape: dp4 -> dp2 x fsdp2 (an
    # async save, the step after it at once)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    feeds = mnist_like_head_feeds()
    dp4 = pt.Trainer(pt.build(_e_head), optimizer.Adam(1e-2), place=pt.CPUPlace(),
                     mesh=par.make_mesh({"dp": 4}), sharding_rules=par.replicated())
    dp4.startup(0, sample_feed=feeds[0])
    dp4.step(feeds[0])
    saved = {k: _exact(v) for k, v in dp4.scope.params.items()}
    io.save_trainer_sharded(j("mesh_sharded"), dp4, async_save=True)
    dp4.step(feeds[1])
    io.wait_for_checkpoints()
    m22 = par.make_mesh({"dp": 2, "fsdp": 2})
    tgt = pt.Trainer(pt.build(_e_head), optimizer.Adam(1e-2), place=pt.CPUPlace(), mesh=m22,
                     sharding_rules=par.fsdp(min_size_to_shard=4))
    tgt.startup(1, sample_feed=feeds[0])
    io.load_trainer_sharded(j("mesh_sharded"), tgt)
    res["reshape/equal"] = np.array(int(all(np.array_equal(_exact(tgt.scope.params[k]), v)
                                            for k, v in saved.items())))
    w = tgt.scope.params["head/w"]
    res["reshape/spec"] = np.array(repr(sharding.spec_of(w.placements, m22, w.dim())))
    res["reshape/local_shape"] = np.array(w.to_local().shape)
    res["reshape/global_step"] = np.array(tgt.global_step)
    res["reshape/next_loss"] = np.array(float(tgt.step(feeds[1])["loss"]))
    dist.barrier()


def _e_head(x, label):
    """tests/test_orbax_checkpoint.py's model: one fc head 6 -> 4."""
    from paddle_tpu_torch import layers as L
    return {"loss": L.mean(L.softmax_with_cross_entropy(L.fc(x, 4, name="head"), label))}


def mnist_like_head_feeds(n=2, seed=1):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(8, E_DIM).astype(np.float32),
             "label": rng.randint(0, 3, (8, 1)).astype(np.int64)} for _ in range(n)]


def _strategy(kw):
    import paddle_tpu_torch as pt
    return pt.DistStrategy(**kw)


def suite_elastic2(res, indir):
    """dp=2: the restores of the one-device and dp=4 checkpoints, the
    structured errors of the implicit paths, and the rejoin after the kill."""
    from paddle_tpu_torch import io, resilience

    j = lambda name: os.path.join(indir, name)  # noqa: E731
    src = e_trainer(2, momentum=True)
    src.step(E_FEED)
    src.step(E_FEED)
    io.save_trainer(j("p2_mom_ck"), src)
    _reshard_case(res, "r1to2", j("p1_mom_ck"), e_trainer(2, momentum=True))
    _reshard_case(res, "r4to2", j("p4_mom_ck"), e_trainer(2, momentum=True))
    # the mismatch drill: step_1 at dp=2 beside the dp=4 step_3
    old = e_trainer(2)
    old.step(E_FEED)
    io.save_trainer(os.path.join(j("mm_root"), "step_1"), old,
                    extra_meta={"epoch": 0, "epoch_step": 1})
    _reshard_error(res, "mm_load", lambda: io.load_trainer(
        os.path.join(j("mm_root"), "step_3"), e_trainer(2)))
    _reshard_error(res, "mm_latest", lambda: resilience.restore_latest(j("mm_root"),
                                                                       e_trainer(2)))
    tgt = e_trainer(2)
    meta = resilience.restore_latest(j("mm_root"), tgt, elastic=True)
    res["mm_elastic/global_step"] = np.array(tgt.global_step)
    res["mm_elastic/meta_step"] = np.array(meta["global_step"])
    # fit(resume=True) across the change, and elastic without resume
    _reshard_error(res, "fit_resume", lambda: e_fit(e_trainer(2), j("fit4"), resume=True))
    try:
        e_fit(e_trainer(2), j("fit4"), elastic=True)
        res["fit_elastic_alone"] = np.array("")
    except Exception as e:  # EnforceError
        res["fit_elastic_alone"] = np.array(f"{type(e).__name__}: {e}")
    # the one-device checkpoint is gated at dp=2, and restores elastically
    _reshard_error(res, "single_gate", lambda: io.load_trainer(j("p1_sgd_ck"), e_trainer(2)))
    _reshard_case(res, "single_to2", j("p1_sgd_ck"), e_trainer(2))
    # the rejoin at dp=2 after the dp=4 run's kill at step 5
    _fit_losses(res, "rejoin", e_trainer(2), j("kill"), os.path.join(j("kill"), "step_5"), 2)


SUITES = {"mesh": suite_mesh, "training": suite_training, "exchanges": suite_exchanges,
          "zero": suite_zero, "sequence": suite_sequence, "pipeline": suite_pipeline,
          "moe": suite_moe, "elastic4": suite_elastic4, "elastic2": suite_elastic2}


def main():
    suite, rank, world, port, outdir = sys.argv[1:6]
    indir = sys.argv[6] if len(sys.argv) > 6 else ""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                      WORLD_SIZE=world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel as par

    par.initialize(place=pt.CPUPlace())
    res = {}
    SUITES[suite](res, indir)
    if int(rank) == 0:
        np.savez(os.path.join(outdir, f"{suite}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
