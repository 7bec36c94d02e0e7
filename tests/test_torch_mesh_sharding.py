"""Meshes, sharding rules, placement of feeds, the quantized ring and the
sharded lookup of the port (``paddle_tpu_torch.parallel``) against
``paddle_tpu.parallel``.

Rule resolution runs in this process: ``spec_for`` and ``adapted_to`` of
the port's tables on every param name of the GPT and Transformer programs
against the JAX tables on JAX meshes of the same shapes, warnings
included. The rest runs on one spawned gloo world of 4 ranks
(``torch_dist_worker.py``, suite "mesh"): ``make_mesh`` and its errors,
``put_batch`` (each rank's local slice, and the whole batch sliced by
rank), the quantized all-reduce (int8 and int4, block and per-chunk
scales), ``sharded_embedding_lookup`` with its table grad, and the
refusals (a DTensor at a kernel launch, a Trainer whose place is not its
mesh's). The JAX side runs on 4 of ``conftest``'s 8 virtual CPU devices.

Tolerances: the codec (encode, decode, roundtrip, the host wire codec)
is bit-equal to the JAX package's run eagerly (the same f32 arithmetic in
the same order); the ring's result is bit-identical on every rank and
within one f32 ulp of its largest element a hop (6 for 4 ranks) of the
JAX ring under ``jit``, whose decode XLA contracts into fused
multiply-adds (2 ulp apart at most, measured; an eager JAX ring,
which takes ~25 s to run op by op here, gave 0 differences when this was
written); the lookup and its grad to 1e-6 (a gather and a sum of one
non-zero term)."""

import dataclasses
import os
import sys
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as pt
from paddle_tpu import sparse as jsparse
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel import quantized_collectives as jqc
from paddle_tpu.parallel import sharding as jsh
from paddle_tpu.parallel.strategy import DistStrategy as JStrategy

import paddle_tpu_torch as tpt
from paddle_tpu_torch import framework as tF
from paddle_tpu_torch import parallel as tpar
from paddle_tpu_torch.core.errors import EnforceError, NotYetPorted
from paddle_tpu_torch.core.place import NoCudaDevice
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.parallel import quantized_collectives as tqc
from paddle_tpu_torch.parallel import sharding as tsh

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_world"))
    return dict(np.load(W.spawn_world("mesh", d, d)))


class _FakeMesh:
    """What ``spec_for`` reads of a mesh: axis names and sizes."""

    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)

    def dim(self, a):
        return self.axis_names.index(a)


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return pt.make_mesh(axes, devices=jax.devices()[:n])


def _program_params(which):
    """{name: shape} of a small program of the port, initialised on the CPU."""
    if which == "gpt":
        prog = tF.build(tgpt.make_model(tgpt.base_config(**W.GPT)))
        feed = {k: torch.from_numpy(v) for k, v in W.gpt_feeds(1, batch=2, seq=16)[0].items()}
    else:
        cfg = ttr.base_config(src_vocab=64, trg_vocab=64, d_model=32, d_inner=64, num_heads=4,
                              num_encoder_layers=2, num_decoder_layers=2, fuse_qkv=True)
        prog = tF.build(ttr.make_model(cfg))
        ids = torch.from_numpy(np.random.RandomState(0).randint(3, 64, (2, 8)).astype(np.int32))
        feed = {"src_ids": ids, "trg_ids": ids, "labels": ids}
    params, _ = prog.init(0, place=CPU, **feed)
    return {k: tuple(v.shape) for k, v in params.items()}


def _jspec(spec):
    return tuple(spec)


RULES = {"replicated": (tsh.replicated, jsh.replicated),
         "fsdp": (lambda: tsh.fsdp(64), lambda: jsh.fsdp(64)),
         "tp": (tsh.transformer_tp_rules, jsh.transformer_tp_rules),
         "typo": (lambda: tsh.ShardingRules([(r".*/w$", ("tpp", None))]),
                  lambda: jsh.ShardingRules([(r".*/w$", ("tpp", None))]))}
MESHES = [{"dp": 2, "tp": 2}, {"fsdp": 4}, {"dp": 2, "fsdp": 2, "tp": 2}, {"pp": 2, "tp": 2},
          {"dp": 4}]


def test_gpt_param_names_match_paddle_tpu():
    feed = W.gpt_feeds(1, batch=2, seq=16)[0]
    prog = pt.build(jgpt.make_model(jgpt.base_config(**W.GPT)))
    shapes = jax.eval_shape(lambda: prog.init(jax.random.PRNGKey(0), **feed)[0])
    assert {k: tuple(v.shape) for k, v in shapes.items()} == _program_params("gpt")


@pytest.mark.parametrize("which", ["gpt", "transformer"])
@pytest.mark.parametrize("rules", sorted(RULES))
def test_spec_for_matches_paddle_tpu_on_every_param(which, rules):
    """``spec_for`` (raw and ``adapted_to`` the mesh) on every param name
    of the program, on meshes of several shapes; and the same warnings."""
    params = _program_params(which)
    tmake, jmake = RULES[rules]
    for axes in MESHES:
        tr, jr = tmake(), jmake()
        fm, jm = _FakeMesh(axes), _jmesh(axes)
        tsh.reset_drop_warnings()
        jsh.reset_drop_warnings()
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = {k: tuple(tr.spec_for(k, s, fm)) for k, s in params.items()}
            got_ad = {k: tuple(tr.adapted_to(fm).spec_for(k, s, fm)) for k, s in params.items()}
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = {k: _jspec(jr.spec_for(k, s, jm)) for k, s in params.items()}
            want_ad = {k: _jspec(jr.adapted_to(jm).spec_for(k, s, jm)) for k, s in params.items()}
        assert got == want, axes
        assert got_ad == want_ad, axes
        assert sorted(str(w.message) for w in tw) == sorted(str(w.message) for w in jw)
        assert all(issubclass(w.category, tsh.ShardingRuleWarning) for w in tw)


def test_batch_spec_matches_paddle_tpu():
    for axes in MESHES + [{"dp": 2, "sp": 2}]:
        for seq_axis in (None, "sp"):
            tr = tsh.ShardingRules(seq_axis=seq_axis)
            jr = jsh.ShardingRules(seq_axis=seq_axis)
            for shape in [(8, 16), (8, 1), (8, 3, 4, 4), (8,)]:
                assert tuple(tr.batch_spec(_FakeMesh(axes), len(shape), shape)) == \
                    _jspec(jr.batch_spec(_jmesh(axes), len(shape), shape))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = _FakeMesh({"dp": 2, "fsdp": 2, "tp": 2})
    assert tsh.placements(tsh.P(("dp", "fsdp"), None, "tp"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tsh.placements(tsh.P(), m) == [Replicate()] * 3
    assert tsh.spec_of([Shard(0), Shard(0), Shard(2)], m, 3) == \
        tsh.P(("dp", "fsdp"), None, "tp")
    # axes out of the mesh's order: fsdp major, as NamedSharding splits it
    from torch.distributed.tensor.placement_types import _StridedShard
    pl = tsh.placements(tsh.P(("fsdp", "dp")), m)
    assert pl == [_StridedShard(0, split_factor=2), Shard(0), Replicate()]
    assert tsh.spec_of(pl, m, 1) == tsh.P(("fsdp", "dp"))


@pytest.mark.parametrize("name, entry", [("fsdp_dp", ("fsdp", "dp")),
                                         ("dp_fsdp", ("dp", "fsdp"))])
def test_a_dim_over_two_axes_shards_as_paddle_tpu(world, name, entry):
    """Each rank's block of an [8, 3] tensor split over dp and fsdp, in and
    out of the mesh's order, against NamedSharding's block on the device
    of the same mesh position."""
    full = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    mesh = _jmesh({"dp": 2, "fsdp": 2})
    arr = jax.device_put(full, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(entry)))
    rank_of = {d.id: r for r, d in enumerate(mesh.devices.reshape(-1))}
    blocks = world[f"g1/{name}/blocks"]
    for sh in arr.addressable_shards:
        np.testing.assert_array_equal(blocks[rank_of[sh.device.id]], np.asarray(sh.data))
    np.testing.assert_array_equal(world[f"g1/{name}/full"], full * 2.0)
    assert str(world[f"g1/{name}/spec"]) == repr(tsh.P(entry, None))


def test_make_mesh_and_its_errors(world):
    assert [tuple(r) for r in world["mesh/shape"]] == [("dp", "2"), ("tp", "2")]
    assert int(world["mesh/dp_size"]) == 2
    assert world["mesh/devices"].tolist() == [[0, 1], [2, 3]]
    for name, axes in (("mismatch", {"dp": 3}), ("infer", {"dp": 3, "tp": -1})):
        with pytest.raises(ValueError) as e:
            pt.make_mesh(axes, devices=jax.devices()[:4])
        assert str(world[f"mesh/err_{name}"]) == str(e.value)


def test_put_batch_slices_and_local_contract(world):
    feed = W.mnist_feeds(1)[0]
    for name in ("local", "global"):
        assert world[f"put/{name}/shape"].tolist() == [16, 784]
        np.testing.assert_array_equal(world[f"put/{name}/image"], feed["image"])
    # a stacked (K, batch, ...) feed keeps K whole and splits the batch
    x = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
    np.testing.assert_array_equal(world["put/stacked/local"], x[:, 0:2])


def _jax_quantized_psum(bits, block):
    mesh = _jmesh({"dp": 4})
    xs = jnp.asarray(np.stack([W.quant_input(r) for r in range(4)]))
    P = jax.sharding.PartitionSpec

    def body(x):
        return jqc.quantized_psum(x[0], "dp", bits=bits, block_size=block)[None]

    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                                check_vma=False))(xs)
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(W.QUANT_CASES))
def test_quantized_psum_bit_equal_to_paddle_tpu(world, name):
    bits, block = W.QUANT_CASES[name]
    want = _jax_quantized_psum(bits, block)
    assert int(world[f"quant/{name}/same_on_ranks"]) == 1
    # XLA contracts the jitted decode's multiply-add into FMAs: at most
    # one f32 ulp of the result's largest element a hop apart, 2(p-1)
    # hops (eager JAX, which does not contract, is bit-equal; the codec's
    # test below holds that)
    ulp = 2 * 3 * float(np.spacing(np.float32(np.abs(want[0]).max())))
    np.testing.assert_allclose(world[f"quant/{name}"], want[0], rtol=0, atol=ulp)
    np.testing.assert_allclose(world[f"quant/{name}/pmean"], want[0] / 4, rtol=0, atol=ulp)
    exact = np.sum([W.quant_input(r) for r in range(4)], axis=0)
    assert np.abs(want[0] - exact).max() <= 0.1 * np.abs(exact).max()


@pytest.mark.parametrize("bits, block", [(8, 16), (8, None), (4, 16), (4, None), (8, 1)])
def test_codec_bit_equal_to_paddle_tpu(bits, block):
    rng = np.random.RandomState(3)
    x = rng.randn(96).astype(np.float32)
    x[16:32] = 0.0                     # an all-zero block: exact zeros
    x[40] = np.nan                      # a poisoned block: NaN on the wire
    x[70] = 1e30                        # an outlier's block
    tq, ts = tqc._encode(torch.from_numpy(x), bits, block)
    jq, js = jqc._encode(jnp.asarray(x), bits, block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tqc._decode(tq, ts, bits, block).numpy(),
                                  np.asarray(jqc._decode(jq, js, bits, block)))
    y = x[:93]
    np.testing.assert_array_equal(
        tqc.block_roundtrip(torch.from_numpy(y), bits=bits, block_size=block).numpy(),
        np.asarray(jqc.block_roundtrip(jnp.asarray(y), bits=bits, block_size=block)))


def test_wire_codec_and_byte_counts_match_paddle_tpu():
    g = np.random.RandomState(4).randn(1000).astype(np.float32)
    for bits in (8, 4):
        tp, tsc = tqc.encode_wire_blocks(g, bits=bits, block_size=64)
        jp, jsc = jqc.encode_wire_blocks(g, bits=bits, block_size=64)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tsc, jsc)
        np.testing.assert_array_equal(
            tqc.decode_wire_blocks(tp, tsc, 1000, bits=bits, block_size=64),
            jqc.decode_wire_blocks(jp, jsc, 1000, bits=bits, block_size=64))
        assert tqc.wire_block_bytes(1000, bits=bits, block_size=64) == \
            jqc.wire_block_bytes(1000, bits=bits, block_size=64)
        for n, p, blk in ((1000, 4, 64), (7, 3, None), (4096, 8, 256)):
            assert tqc.ring_wire_bytes(n, p, bits=bits, block_size=blk) == \
                jqc.ring_wire_bytes(n, p, bits=bits, block_size=blk)
    assert tqc.ring_wire_bytes(1000, 4) == jqc.ring_wire_bytes(1000, 4)
    with pytest.raises(EnforceError, match="int4 packs"):
        tqc.block_roundtrip(torch.zeros(4), bits=4, block_size=3)


@pytest.mark.parametrize("name, axes", [("ep", {"ep": 4}), ("dp_ep", {"dp": 2, "ep": 2})])
def test_sharded_embedding_lookup_matches_paddle_tpu(world, name, axes):
    rng = np.random.RandomState(7)
    table = rng.randn(16, 6).astype(np.float32)
    ids = rng.randint(0, 16, (4, 5)).astype(np.int64)
    cot = rng.randn(4, 5, 6).astype(np.float32)
    mesh = _jmesh(axes)

    def f(t):
        return jnp.sum(jsparse.sharded_embedding_lookup(t, jnp.asarray(ids), mesh) * cot)

    out = np.asarray(jsparse.sharded_embedding_lookup(jnp.asarray(table), jnp.asarray(ids),
                                                      mesh))
    np.testing.assert_allclose(world[f"lookup/{name}/out"], out, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(world[f"lookup/{name}/out"], table[ids], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(world[f"lookup/{name}/dtable"],
                               np.asarray(jax.grad(f)(jnp.asarray(table))),
                               rtol=1e-6, atol=1e-6)
    want_pl = "(Replicate(),)" if name == "ep" else "(Shard(dim=0), Replicate())"
    assert str(world[f"lookup/{name}/placements"]) == want_pl


def test_no_dtensor_reaches_a_kernel_and_places_agree(world):
    assert "a DTensor reached the kernel launch" in str(world["kernel/refused"])
    assert "run on their own devices" in str(world["trainer/place_mismatch"])


def test_a_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is for hosts without one")
    with pytest.raises(NoCudaDevice):
        tpar.initialize(place=tpt.CUDAPlace(0))
    fake = tpar.Mesh.__new__(tpar.Mesh)
    fake.device, fake.axis_names, fake.shape = torch.device("cuda", 0), ("dp",), {"dp": 1}
    with pytest.raises(NoCudaDevice):
        tpt.Trainer(tF.build(lambda x: {"loss": x.sum()}), None, mesh=fake)
    with pytest.raises(tpar.DistributedInitError, match="initialize"):
        tpar.make_mesh({"dp": 1})


@pytest.mark.parametrize("field, value, item", [
    ("async_mode", True, "item 21"), ("dump_hlo_path", "/x", "item 25")])
def test_fields_of_the_second_half_raise(field, value, item):
    # async_mode (item 21 (e)) is ported with the parameter server: the
    # SPMD Trainer refuses it and points to AsyncPSTrainer, as JAX does
    err, match = ((EnforceError, "async_mode.*AsyncPSTrainer") if field == "async_mode"
                  else (NotYetPorted, f"{field}.*{item}"))
    with pytest.raises(err, match=match):
        tpt.Trainer(tF.build(lambda x: {"loss": x.sum()}), None, place=CPU,
                    strategy=tpar.DistStrategy(**{field: value}))


def test_strategy_knobs_match_paddle_tpu():
    want = {f.name: f.default for f in dataclasses.fields(JStrategy)}
    got = {f.name: f.default for f in dataclasses.fields(tpar.DistStrategy)}
    assert got == want
    assert tpar.unported_fields(tpar.DistStrategy(
        zero_sharding=True, quantized_allreduce="int4", sequence_parallel=True,
        sp_impl="ulysses", accum_exchange="hoisted", error_feedback=False)) == {}


def test_sp_mode_is_the_ambient_switch():
    m = _FakeMesh({"sp": 4})
    assert tF.sp_config() is None
    with tF.sp_mode(m, impl="ulysses") as cfg:
        assert tF.sp_config() is cfg and cfg["impl"] == "ulysses" and cfg["consumed"]
    assert tF.sp_config() is None
    with pytest.raises(EnforceError, match="impl"):
        with tF.sp_mode(m, impl="zigzag"):
            pass
    with pytest.raises(EnforceError, match="sp"):
        with tF.sp_mode(None):
            pass
