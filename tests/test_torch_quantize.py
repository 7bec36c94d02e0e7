"""``paddle_tpu_torch.quantize`` against ``paddle_tpu.quantize`` on the
same numpy inputs, made from seeds.

- ``int8_dynamic_matmul`` and ``int8_dynamic_conv`` on f32 inputs: bit
  for bit (the same int8 values, the same int32 accumulators, the same f32
  rescale in the same order), NCHW and NHWC, with stride, asymmetric
  padding, dilation and groups. On bf16 inputs within one bf16 ulp of the
  JAX result (both round the same f32 value to bf16; the abs-max of a
  bf16 tensor is exact in either).
- ``fake_quant``: the forward bit for bit, the straight-through grad bit
  for bit, and no grad to the scale (the JAX VJP returns None for it);
  ``fake_quant_abs_max`` and ``quant_dequant_moving_avg`` bit for bit.
- ``quantize_params``/``dequantize_params``: the int8 values and scales
  equal, the dequantized params bit for bit; the two quirks of the
  reference are pinned in both packages (the store alone is returned; a
  ``num_bits=4`` store is divided by 127 on the way back).
- ``cast_params_for_inference``: floating params only, bit for bit.
- ``fold_batch_norms``: within 1e-6 of max|w| (``rsqrt`` may differ by an
  ulp between XLA and PyTorch).
- The card route's padding (``_padded_int_mm``): rows 1 and 16 and an
  inner width of 147 (ResNet-50's fc at buckets 1 and 16, its 7x7x3 stem)
  padded to what cuBLASLt's int8 GEMM takes, the accumulators equal to
  the unpadded product's.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import quantize as jq

from paddle_tpu_torch import quantize as tq


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


def _bf16_ulp(x):
    """One bf16 ulp at each value of ``x`` (8 significant bits)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _hold(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want)), np.max(np.abs(got - want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("xshape", [(5, 16), (2, 3, 16)])
def test_int8_dynamic_matmul_equals_jax(xshape, dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(*xshape).astype(np.float32)
    w = (rng.randn(16, 8) * 0.3).astype(np.float32)
    td, jd = DTYPES[dtype]
    got = tq.int8_dynamic_matmul(_t(x, td), _t(w, td))
    want = jq.int8_dynamic_matmul(_j(x, jd), _j(w, jd))
    assert got.dtype == td
    _hold(got, want, dtype)


# (x shape, layout, filter [O, I/g, kh, kw], strides, padding, dilation, groups)
CONVS = {
    "nchw_pad1": ((2, 3, 8, 8), "NCHW", (4, 3, 3, 3), (1, 1), [(1, 1), (1, 1)], (1, 1), 1),
    "nhwc_stride2": ((2, 9, 9, 4), "NHWC", (6, 4, 3, 3), (2, 2), [(1, 1), (1, 1)], (1, 1), 1),
    "nchw_asym_pad_dilated": ((1, 2, 10, 9), "NCHW", (4, 2, 3, 2), (1, 2), [(1, 0), (0, 2)],
                              (2, 3), 1),
    "nhwc_groups": ((2, 7, 7, 6), "NHWC", (9, 2, 3, 3), (1, 1), [(1, 1), (1, 1)], (1, 1), 3),
    "nchw_groups_stride_1x1": ((3, 4, 6, 6), "NCHW", (8, 2, 1, 1), (2, 2), [(0, 0), (0, 0)],
                               (1, 1), 2),
    "nhwc_stem_7x7": ((1, 16, 16, 3), "NHWC", (8, 3, 7, 7), (2, 2), [(3, 3), (3, 3)],
                      (1, 1), 1),
}


def _dn(layout):
    return ("NCHW", "OIHW", "NCHW") if layout == "NCHW" else ("NHWC", "HWIO", "NHWC")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONVS))
def test_int8_dynamic_conv_equals_jax(case, dtype):
    xs, layout, ws, st, pad, dil, g = CONVS[case]
    rng = np.random.RandomState(1)
    x = rng.randn(*xs).astype(np.float32)
    w = (rng.randn(*ws) * 0.2).astype(np.float32)
    if layout == "NHWC":
        w = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # HWIO, as the JAX layer passes it
    td, jd = DTYPES[dtype]
    dn = _dn(layout)
    jdn = jax.lax.conv_dimension_numbers(xs, w.shape, dn)
    want = jq.int8_dynamic_conv(_j(x, jd), _j(w, jd), st, pad, rhs_dilation=dil,
                                dimension_numbers=jdn, feature_group_count=g)
    got = tq.int8_dynamic_conv(_t(x, td), _t(w, td), st, pad, rhs_dilation=dil,
                               dimension_numbers=dn, feature_group_count=g)
    assert got.dtype == td
    _hold(got, want, dtype)


def test_int8_routes_are_counted():
    tq.reset_int8_route_counts()
    x = torch.randn(2, 3, 6, 6)
    tq.int8_dynamic_conv(x, torch.randn(4, 3, 3, 3), (1, 1), [(0, 0), (0, 0)], (1, 1),
                         _dn("NCHW"))
    tq.int8_dynamic_matmul(torch.randn(2, 5), torch.randn(5, 3))
    tq.int8_dynamic_matmul(torch.randn(2, 5), torch.randn(5, 3))
    assert tq.int8_route_counts() == {"matmul": 2, "conv": 1}
    tq.reset_int8_route_counts()
    assert tq.int8_route_counts() == {"matmul": 0, "conv": 0}


# -- fake quantization ------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scale_kind", ["float", "tensor"])
def test_fake_quant_forward_and_straight_through_grad_equal_jax(scale_kind, bits):
    rng = np.random.RandomState(2)
    x = (rng.randn(64) * 1.2).astype(np.float32)  # some beyond the scale: clipped
    ct = rng.randn(64).astype(np.float32)
    scale = 0.9 if scale_kind == "float" else np.float32(0.9)
    jscale = scale if scale_kind == "float" else jnp.asarray(scale)
    want = jq.fake_quant(jnp.asarray(x), jscale, bits)
    jgrad = jax.grad(lambda v: jnp.sum(jq.fake_quant(v, jscale, bits) * ct))(jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    tscale = scale if scale_kind == "float" else torch.tensor(scale, requires_grad=True)
    got = tq.fake_quant(tx, tscale, bits)
    (got * _t(ct)).sum().backward()
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrad))
    assert (np.asarray(jgrad) == 0).any() and (np.asarray(jgrad) != 0).any()
    if scale_kind == "tensor":
        assert tscale.grad is None  # the JAX VJP gives the scale none


def test_fake_quant_abs_max_and_moving_avg_equal_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 9).astype(np.float32)
    np.testing.assert_array_equal(_np(tq.fake_quant_abs_max(_t(x), 8)),
                                  np.asarray(jq.fake_quant_abs_max(jnp.asarray(x), 8)))
    state = np.float32(1.7)
    out, new = tq.quant_dequant_moving_avg(_t(x), torch.tensor(state), decay=0.9)
    jout, jnew = jq.quant_dequant_moving_avg(jnp.asarray(x), jnp.asarray(state), decay=0.9)
    np.testing.assert_array_equal(_np(out), np.asarray(jout))
    np.testing.assert_array_equal(_np(new), np.asarray(jnew))
    # no grad reaches x through the scale: only the straight-through mask
    tx = _t(x).requires_grad_(True)
    tq.quant_dequant_moving_avg(tx, torch.tensor(state))[0].sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), (np.abs(x / np.asarray(jnew)) <= 1.0)
                                  .astype(np.float32))


# -- params rewrites -----------------------------------------------------------------


def _params(seed=4):
    rng = np.random.RandomState(seed)
    return {"fc_0/w": rng.randn(16, 8).astype(np.float32),
            "fc_0/b": rng.randn(8).astype(np.float32),
            "conv2d_0/w": (rng.randn(4, 3, 3, 3) * 0.5).astype(np.float32),
            "emb/ids": rng.randint(0, 9, (5,)).astype(np.int32)}


@pytest.mark.parametrize("bits", [8, 6])
def test_quantize_and_dequantize_params_equal_jax(bits):
    p = _params()
    jstore = jq.quantize_params({k: jnp.asarray(v) for k, v in p.items()}, num_bits=bits)
    tstore = tq.quantize_params({k: _t(v) for k, v in p.items()}, num_bits=bits)
    assert sorted(tstore) == sorted(jstore)
    for k, v in jstore.items():
        if isinstance(v, dict):
            assert tstore[k]["q"].dtype == torch.int8
            np.testing.assert_array_equal(tstore[k]["q"].numpy(), np.asarray(v["q"]))
            np.testing.assert_array_equal(tstore[k]["scale"].numpy(), np.asarray(v["scale"]))
        else:
            np.testing.assert_array_equal(_np(tstore[k]), np.asarray(v))
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jdense = jq.dequantize_params(jstore, dtype=jd)
        tdense = tq.dequantize_params(tstore, dtype=td)
        for k in ("fc_0/w", "conv2d_0/w"):
            assert tdense[k].dtype == td
            np.testing.assert_array_equal(_np(tdense[k]), _np(jdense[k]))


def test_the_reference_quantize_params_quirks():
    """Pinned, not fixed (queue 3, standing notes): ``quantize_params``
    returns the store alone, though its docstring promises a pair, and
    ``dequantize_params`` divides by 127 whatever ``num_bits`` made the
    store, so a 4-bit store comes back at 7/127 of its size."""
    w = np.array([[1.0, -0.5], [0.25, 2.0]], np.float32)
    for q, arr in ((jq, jnp.asarray), (tq, _t)):
        store = q.quantize_params({"fc/w": arr(w)}, num_bits=4)
        assert isinstance(store, dict) and set(store) == {"fc/w"}
        assert set(store["fc/w"]) == {"q", "scale"}
        back = _np(q.dequantize_params(store)["fc/w"])
        scale = np.abs(w).max(axis=1, keepdims=True)
        levels = np.clip(np.round(w / scale * 7), -7, 7)
        np.testing.assert_allclose(back, levels * scale / 127.0, rtol=1e-6)
        np.testing.assert_allclose(back, (levels * scale / 7) * (7 / 127), rtol=1e-6)


def test_cast_params_for_inference_equals_jax():
    p = _params()
    jout = jq.cast_params_for_inference({k: jnp.asarray(v) for k, v in p.items()})
    tout = tq.cast_params_for_inference({k: _t(v) for k, v in p.items()})
    for k in p:
        assert str(tout[k].dtype).replace("torch.", "") == str(jout[k].dtype)
        np.testing.assert_array_equal(_np(tout[k]), _np(jout[k]))
    assert tout["emb/ids"].dtype == torch.int32


def test_fold_batch_norms_equals_jax():
    rng = np.random.RandomState(5)
    params = {"conv2d_0/w": rng.randn(6, 3, 3, 3).astype(np.float32),
              "batch_norm_0/scale": rng.rand(6).astype(np.float32) + 0.5,
              "batch_norm_0/bias": rng.randn(6).astype(np.float32)}
    state = {"batch_norm_0/moving_mean": rng.randn(6).astype(np.float32),
             "batch_norm_0/moving_variance": rng.rand(6).astype(np.float32) + 0.1}
    pairs = [("conv2d_0", "batch_norm_0")]
    jout = jq.fold_batch_norms({k: jnp.asarray(v) for k, v in params.items()},
                               {k: jnp.asarray(v) for k, v in state.items()}, pairs)
    tout = tq.fold_batch_norms({k: _t(v) for k, v in params.items()},
                               {k: _t(v) for k, v in state.items()}, pairs)
    assert sorted(tout) == sorted(jout)
    for k in ("conv2d_0/w", "conv2d_0/folded_bias"):
        want = np.asarray(jout[k])
        assert np.max(np.abs(_np(tout[k]) - want)) <= 1e-6 * np.max(np.abs(want))


# -- the card route's padding ----------------------------------------------------------


@pytest.mark.parametrize("mkn", [(1, 2048, 1000), (16, 2048, 1000), (40, 147, 64),
                                 (17, 152, 10)])
def test_padded_int_mm_equals_the_unpadded_product(mkn):
    m, k, n = mkn
    g = torch.Generator().manual_seed(6)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    seen = []

    def card_like_mm(x, y):
        # what torch._int_mm takes on the card (H100): more than 16 rows,
        # widths a multiple of 8, the right operand column-major
        seen.append((tuple(x.shape), tuple(y.shape)))
        assert x.shape[0] > 16 and x.shape[1] % 8 == 0 and y.shape[1] % 8 == 0
        assert x.is_contiguous() and y.t().is_contiguous()
        return torch._int_mm(x, y)

    got = tq._padded_int_mm(a, b, mm=card_like_mm)
    want = torch.matmul(a.to(torch.int32), b.to(torch.int32))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, want)
    assert len(seen) == 1
