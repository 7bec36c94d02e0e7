"""The feed wire formats of the port (``paddle_tpu_torch.data.wire``)
against ``paddle_tpu.data.wire`` on the same numpy inputs.

- ``WireSpec.quantize``/``cast``/``passthrough`` encode to the same bytes
  (the bf16 cast to ``ml_dtypes``' bits: the port rounds without
  ``ml_dtypes``, to nearest with ties to even, a NaN to the quiet NaN of
  its sign), and the specs are equal as values.
- Decoding gives the same values exactly (the same f32 operations), and a
  decode dtype that is not floating is refused.
- The byte counts of ``feed_wire_nbytes``/``feed_logical_nbytes`` agree."""

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.core.errors import EnforceError as JEnforceError
from paddle_tpu.data import wire as jwire

from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.data import wire as twire

SPECS = {
    "quantize_uint8": lambda w: w.WireSpec.quantize("uint8", scale=0.05, zero_point=128.0),
    "quantize_int8": lambda w: w.WireSpec.quantize("int8", scale=0.1, zero_point=-3.0),
    "image_uint8": lambda w: w.WireSpec.image_uint8(),
    "cast_bfloat16": lambda w: w.WireSpec.cast("bfloat16"),
    "cast_float16": lambda w: w.WireSpec.cast("float16"),
    "passthrough": lambda w: w.WireSpec.passthrough(),
}


def _values(n=4096, seed=0, extremes=True):
    """f32 test values; ``extremes`` adds bf16 rounding ties and values
    near f32's range (which an affine quantization refuses: they overflow
    to inf)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 4.0).astype(np.float32)
    x[:6] = [0.0, -0.0, 1.00390625, 1.01171875, 1e-40, 255.49]
    if extremes:
        x[6:8] = [3.3895e38, -3.3895e38]
    return x.reshape(64, -1)


def _values_for(spec, seed):
    return _values(seed=seed, extremes=spec.kind != "quantize")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_encode_bytes_equal_jax(name):
    js, ts = SPECS[name](jwire), SPECS[name](twire)
    assert ts == twire.WireSpec(**vars(js))
    x = _values_for(ts, 0)
    assert ts.encode(x).tobytes() == np.asarray(js.encode(x)).tobytes()


def test_bf16_cast_equals_ml_dtypes_bits_on_every_pattern_class():
    rng = np.random.RandomState(1)
    bits = rng.randint(0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32)
    specials = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                         0xFFBFFFFF, 0x7F7FFFFF, 0x00000001, 0x80000000, 0x3F808000,
                         0x3F818000, 0x3F80FFFF], np.uint32)
    x = np.concatenate([bits, specials]).view(np.float32)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(twire.bf16_bits(x), want)
    assert twire.WireSpec.cast("bfloat16").wire_np == np.uint16


@pytest.mark.parametrize("name", sorted(SPECS))
def test_decode_values_equal_jax(name):
    js, ts = SPECS[name](jwire), SPECS[name](twire)
    x = _values_for(ts, 2)
    wire = ts.encode(x)
    jwire_arr = np.asarray(js.encode(x))
    got = ts.decode(wire)
    want = np.asarray(js.decode(jwire_arr))
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    # already-logical data passes through; a tensor on the wire decodes too
    assert ts.decode(torch.from_numpy(x)).dtype == torch.float32
    if ts.kind == "quantize":
        np.testing.assert_array_equal(ts.decode(torch.from_numpy(wire)).numpy(), got)


@pytest.mark.parametrize("make", [
    lambda w: w.WireSpec.quantize("uint8", decode_dtype="int32"),
    lambda w: w.WireSpec.quantize("float16"),
    lambda w: w.WireSpec.cast("int8", decode_dtype="int32"),
    lambda w: w.WireSpec.cast("float32", "float32"),
    lambda w: w.WireSpec.cast("float32", "float16"),
    lambda w: w.WireSpec.quantize("uint8", scale=0.0),
], ids=["quantize_int_decode", "quantize_float_wire", "cast_int_decode", "cast_noop",
        "cast_wider", "zero_scale"])
def test_refusals_equal_jax(make):
    with pytest.raises(JEnforceError):
        make(jwire)
    with pytest.raises(EnforceError):
        make(twire)


def test_quantize_refuses_nonfinite_and_decode_refuses_foreign_dtypes():
    spec = twire.WireSpec.quantize("uint8", scale=0.5)
    with pytest.raises(FloatingPointError):
        spec.encode(np.array([1.0, np.nan], np.float32))
    with pytest.raises(EnforceError, match="expected uint8 wire data"):
        spec.decode(torch.zeros(3, dtype=torch.int32))


def test_feed_wire_encode_decode_and_byte_counts_equal_jax():
    feed = {"image": _values(seed=3, extremes=False),
            "label": np.arange(64, dtype=np.int64).reshape(64, 1),
            "dense": _values(seed=4)[:, :13]}
    specs = {"image": "image_uint8", "dense": "cast_bfloat16"}
    jfw = jwire.FeedWire({k: SPECS[v](jwire) for k, v in specs.items()})
    tfw = twire.FeedWire.make({k: SPECS[v](twire) for k, v in specs.items()})
    jenc, tenc = jfw.encode(feed), tfw.encode(feed)
    for k in feed:
        assert tenc[k].tobytes() == np.asarray(jenc[k]).tobytes(), k
    assert tfw.wire_nbytes(tenc) == jfw.wire_nbytes(jenc)
    assert tfw.logical_nbytes(tenc) == jfw.logical_nbytes(jenc)
    assert twire.feed_wire_nbytes(feed) == jwire.feed_wire_nbytes(feed)
    assert twire.feed_logical_nbytes(tenc, tfw) == jwire.feed_logical_nbytes(jenc, jfw)
    dec = tfw.decode(tenc)
    assert dec["image"].dtype == torch.float32 and dec["label"] is tenc["label"]
    np.testing.assert_array_equal(dec["dense"].numpy(), np.asarray(jfw.decode(jenc)["dense"]))
    logical = tfw.logical_feed(tenc)
    assert logical["image"].dtype == torch.float32 and logical["image"].device.type == "meta"


BF16_DECODES = {
    "cast_f16_to_bf16": lambda w: w.WireSpec.cast("float16", decode_dtype="bfloat16"),
    "cast_bf16_to_bf16": lambda w: w.WireSpec.cast("bfloat16", decode_dtype="bfloat16"),
    "cast_f32_to_bf16": lambda w: w.WireSpec.cast("float32", decode_dtype="bfloat16"),
    "quantize_uint8_to_bf16": lambda w: w.WireSpec.quantize("uint8", 0.5,
                                                            decode_dtype="bfloat16"),
    "image_uint8_bf16": lambda w: w.WireSpec.image_uint8(decode_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", sorted(BF16_DECODES))
def test_bf16_decode_dtype_refused_as_jax(name):
    """F10: the JAX package's ``np.issubdtype(..., np.floating)`` refuses
    ml_dtypes' bfloat16 as a decode dtype, so the port refuses it with the
    same message (a bf16-to-bf16 cast passes the first check by equality
    and is refused as a no-op)."""
    with pytest.raises(JEnforceError) as want:
        BF16_DECODES[name](jwire)
    with pytest.raises(EnforceError) as got:
        BF16_DECODES[name](twire)
    assert str(got.value) == str(want.value)


def test_bf16_wire_with_f32_decode_stays_valid():
    js, ts = jwire.WireSpec.cast("bfloat16"), twire.WireSpec.cast("bfloat16")
    assert ts == twire.WireSpec(**vars(js))
    assert (ts.wire_dtype, ts.decode_dtype) == ("bfloat16", "float32")
    x = _values(seed=3, extremes=False)
    # the wire's bit patterns, put on a device as they are, decode too
    bits = torch.from_numpy(ts.encode(x))
    np.testing.assert_array_equal(ts.decode(bits).numpy(),
                                  np.asarray(js.decode(np.asarray(js.encode(x)))))
