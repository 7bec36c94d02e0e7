"""Quantized ring collectives: block-scaled int8/int4 all-reduce
(counterpart of ``paddle_tpu.parallel.quantized_collectives``).

A ring all-reduce whose every hop carries int8 (or packed int4) codes
with f32 abs-max scales instead of f32: about 4× (int8) to 8× (int4)
fewer bytes on the wire at about 1% of the block max of error per hop.
The JAX module is ``jnp`` over ``lax.ppermute``, not Pallas; here it is
plain PyTorch over ``torch.distributed.batch_isend_irecv``, with the same
arithmetic, so the codec is bit-equal to the JAX package's on the same
inputs and the ring's result is bit-identical on every rank.

Scale granularity: ``block_size=None`` keeps one scale per ring chunk;
an integer ``B`` gives one f32 abs-max scale per ``B`` contiguous
elements, so an outlier flattens only its own block. An all-zero block
encodes to exact zeros (scale 1), and a block holding a NaN or an Inf
gets a NaN wire scale, so the whole block decodes to NaN and the
overflow checks downstream still fire. ``bits=4`` packs two bias-8 codes
a byte. ``generator`` (a ``torch.Generator`` on the data's device) turns
on stochastic rounding, floor(x + u), for the reduce-scatter hops only:
the all-gather hops round to nearest, so every rank ends bit-identical.

Also here: the host codec of the parameter server's PUSHQB verb
(:func:`encode_wire_blocks` / :func:`decode_wire_blocks`, numpy) and the
bytes-on-wire accounting (:func:`ring_wire_bytes`, :func:`wire_block_bytes`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.errors import enforce


def _qmax(bits: int) -> float:
    enforce(bits in (8, 4), f"quantized collectives carry int8 or int4 "
            f"payloads, not int{bits}")
    return float(2 ** (bits - 1) - 1)  # 127 / 7


def _align(bits: int, block_size: Optional[int]) -> int:
    """The element alignment an encoded vector needs: the block grid, and
    an even count for int4 (two codes share a byte)."""
    a = int(block_size) if block_size else 1
    if bits == 4 and a % 2:
        a *= 2
    return a


def _check_block(bits: int, block_size: Optional[int]) -> None:
    _qmax(bits)
    if block_size is not None:
        enforce(int(block_size) >= 1,
                f"quant block_size must be >= 1, got {block_size}")
        enforce(bits != 4 or int(block_size) % 2 == 0,
                f"int4 packs two codes per byte: block_size must be even, "
                f"got {block_size}")


def _pack4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-7, 7] (even count) → uint8, two bias-8 nibbles a
    byte: lo | hi << 4."""
    u = (q.to(torch.int32) + 8).to(torch.uint8)
    return u[0::2] | (u[1::2] << 4)


def _unpack4(payload: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack4` (twice the payload's length)."""
    lo = (payload & 0xF).to(torch.int32) - 8
    hi = ((payload >> 4) & 0xF).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=1).reshape(-1).to(torch.int8)


def _safe_scales(v2: torch.Tensor):
    """Per-row (code scale, wire scale) of an (nblk, B) f32 grid: the
    abs-max over the finite elements (1 for an all-zero row), and NaN on
    the wire for a row holding a non-finite element."""
    finite = torch.isfinite(v2)
    amax = torch.where(finite, v2.abs(), torch.zeros_like(v2)).amax(dim=1)
    safe = torch.where(amax > 0, amax, torch.ones_like(amax)).float()
    wire = torch.where(finite.all(dim=1), safe, torch.full_like(safe, float("nan")))
    return safe, wire


def _encode(flat: torch.Tensor, bits: int, block_size: Optional[int],
            generator: Optional[torch.Generator] = None):
    """Aligned flat f32 vector → (wire payload, scales): int8 codes
    (bits=8) or packed uint8 nibble pairs (bits=4); one 0-d f32 scale
    (``block_size=None``) or f32[nblk]."""
    qmax = _qmax(bits)
    v2 = flat[None, :] if block_size is None else flat.reshape(-1, int(block_size))
    safe, wire = _safe_scales(v2)
    x = torch.where(torch.isfinite(v2), v2, torch.zeros_like(v2)) / safe[:, None] * qmax
    if generator is None:
        q = torch.round(x)
    else:
        q = torch.floor(x + torch.rand(x.shape, generator=generator, device=x.device,
                                       dtype=x.dtype))
    q = torch.clamp(q, -qmax, qmax).to(torch.int8).reshape(-1)
    scales = wire.reshape(()) if block_size is None else wire
    return (_pack4(q) if bits == 4 else q), scales


def _decode(payload: torch.Tensor, scales: torch.Tensor, bits: int,
            block_size: Optional[int]) -> torch.Tensor:
    # qmax as a tensor on the scales' device: PyTorch's CUDA division by a
    # Python scalar multiplies by its reciprocal, one ulp from the CPU's
    # (and XLA's) true division; tensor by tensor divides on both
    qmax = scales.new_full((), _qmax(bits))
    q = (_unpack4(payload) if bits == 4 else payload).float()
    if block_size is None:
        return q * (scales / qmax)
    return (q.reshape(-1, int(block_size)) * (scales[:, None] / qmax)).reshape(-1)


def _ring_chunk(n: int, p: int, bits: int, block_size: Optional[int]) -> int:
    """A rank's chunk of the ring: ceil(n/p) rounded up to the encode
    alignment, so no block straddles two chunks (the block grids of a
    whole-tensor roundtrip and of the ring coincide, which is what lets
    error feedback compose with the ring)."""
    chunk = -(-n // p)
    a = _align(bits, block_size)
    return -(-chunk // a) * a


def block_roundtrip(x: torch.Tensor, *, bits: int = 8, block_size: Optional[int] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Quantize then dequantize ``x`` on the wire grid with no exchange:
    what a rank's contribution becomes on the wire. ``x -
    block_roundtrip(x)`` is the error-feedback residual. The grid is
    :func:`quantized_psum`'s, so the ring re-encodes the roundtripped
    value to the same codes."""
    _check_block(bits, block_size)
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    a = _align(bits, block_size)
    flat = torch.nn.functional.pad(flat, (0, -(-n // a) * a - n))
    out = _decode(*_encode(flat, bits, block_size, generator), bits, block_size)
    return out[:n].reshape(x.shape).to(x.dtype)


def _hop(payload: torch.Tensor, scales: torch.Tensor, group, rank: int, p: int):
    """Send (payload, scales) to the next rank of the ring and receive the
    previous rank's: one ``batch_isend_irecv`` of four point-to-point ops."""
    import torch.distributed as dist

    nxt = dist.get_global_rank(group, (rank + 1) % p)
    prv = dist.get_global_rank(group, (rank - 1) % p)
    rq = torch.empty(payload.shape, dtype=payload.dtype, device=payload.device)
    rs = torch.empty(scales.shape, dtype=scales.dtype, device=scales.device)
    ops = [dist.P2POp(dist.isend, payload.contiguous(), nxt, group),
           dist.P2POp(dist.isend, scales.contiguous(), nxt, group),
           dist.P2POp(dist.irecv, rq, prv, group),
           dist.P2POp(dist.irecv, rs, prv, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return rq, rs


def quantized_psum(x: torch.Tensor, group=None, *, bits: int = 8,
                   block_size: Optional[int] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Ring all-reduce (sum) of ``x`` over the process ``group`` (None:
    the world) with int8/int4 hops (quantized_collectives.py:176).
    Accumulation is f32; each of the 2(p-1) hops quantizes what it
    carries.

    Reduce-scatter, then all-gather, one neighbour exchange a step: rank
    r first forwards chunk (r+1)%p, adds its own share to the partial
    arriving at step k (chunk (r-k+1)%p), and after p-1 steps owns the
    reduced chunk (r+2)%p; the all-gather passes the reduced chunks on.
    The owner keeps the quantized roundtrip of its chunk, not its exact
    f32 (abs-max quantization is idempotent per block), so the result is
    bit-identical on every rank."""
    import torch.distributed as dist

    _check_block(bits, block_size)
    group = dist.group.WORLD if group is None else group
    p = dist.get_world_size(group)
    if p == 1:
        return x
    r = dist.get_rank(group)
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    chunk = _ring_chunk(n, p, bits, block_size)
    chunks = torch.nn.functional.pad(flat, (0, chunk * p - n)).reshape(p, chunk)

    def hop(v, gen=None):
        q, s = _encode(v, bits, block_size, gen)
        q, s = _hop(q, s, group, r, p)
        return _decode(q, s, bits, block_size)

    carry = chunks[(r + 1) % p]
    for k in range(1, p):
        carry = hop(carry, generator) + chunks[(r - k + 1) % p]
    carry = _decode(*_encode(carry, bits, block_size), bits, block_size)
    out = torch.zeros_like(chunks)
    out[(r + 2) % p] = carry
    recv = carry
    for k in range(1, p):
        recv = hop(recv)
        out[(r - k + 2) % p] = recv
    return out.reshape(-1)[:n].reshape(orig_shape).to(orig_dtype)


def quantized_pmean(x: torch.Tensor, group=None, *, bits: int = 8,
                    block_size: Optional[int] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The mean form of :func:`quantized_psum` (data-parallel gradient
    averaging)."""
    import torch.distributed as dist

    return quantized_psum(x, group, bits=bits, block_size=block_size,
                          generator=generator) / dist.get_world_size(group)


# --------------------------------------------------------------------------
# the host wire codec (the parameter server's PUSHQB verb) and byte counts
# --------------------------------------------------------------------------


def encode_wire_blocks(arr, *, bits: int = 8, block_size: int = 256
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of the encoder for host wire crossings: flat gradient →
    (payload, scales), the input zero-padded to the block grid; payload
    int8 codes (bits=8) or packed bias-8 nibble pairs as uint8 (bits=4),
    scales f32[nblk] with :func:`_safe_scales`' semantics."""
    enforce(block_size and int(block_size) >= 1,
            f"encode_wire_blocks needs a positive block_size, got {block_size}")
    _check_block(bits, block_size)
    b = int(block_size)
    qmax = _qmax(bits)
    g = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    n = g.size
    padded = -(-max(n, 1) // b) * b
    g = np.pad(g, (0, padded - n))
    v2 = g.reshape(-1, b)
    finite = np.isfinite(v2)
    amax = np.max(np.abs(np.where(finite, v2, 0.0)), axis=1)
    safe = np.where(amax > 0, amax, 1.0).astype(np.float32)
    wire = np.where(finite.all(axis=1), safe, np.float32(np.nan)).astype(np.float32)
    q = np.clip(np.rint(np.where(finite, v2, 0.0) / safe[:, None] * qmax),
                -qmax, qmax).astype(np.int8).reshape(-1)
    if bits == 4:
        u = (q.astype(np.int32) + 8).astype(np.uint8)
        q = (u[0::2] | (u[1::2] << 4)).astype(np.uint8)
    return q, wire


def decode_wire_blocks(payload, scales, n: int, *, bits: int = 8,
                       block_size: int = 256) -> np.ndarray:
    """Inverse of :func:`encode_wire_blocks`."""
    _check_block(bits, block_size)
    b = int(block_size)
    qmax = _qmax(bits)
    q = np.asarray(payload)
    if bits == 4:
        u = q.view(np.uint8) if q.dtype != np.uint8 else q
        lo = (u & 0xF).astype(np.int32) - 8
        hi = ((u >> 4) & 0xF).astype(np.int32) - 8
        q = np.stack([lo, hi], axis=1).reshape(-1)
    s = np.asarray(scales, dtype=np.float32)
    out = (q.astype(np.float32).reshape(-1, b) * (s[:, None] / qmax)).reshape(-1)
    return out[:n]


def wire_block_bytes(n: int, *, bits: int = 8, block_size: int = 256) -> Tuple[int, int]:
    """(payload bytes, scale bytes) :func:`encode_wire_blocks` puts on the
    wire for ``n`` elements."""
    _check_block(bits, block_size)
    b = int(block_size)
    padded = -(-max(int(n), 1) // b) * b
    nblk = padded // b
    return (padded if bits == 8 else padded // 2), 4 * nblk


def ring_wire_bytes(n: int, p: int, *, bits: Optional[int] = None,
                    block_size: Optional[int] = None) -> int:
    """Bytes one rank sends in ONE ring all-reduce of ``n`` elements over
    ``p`` ranks: 2(p-1) hops of one chunk (plus its scales when
    quantized); ``bits=None`` is the f32 ring."""
    n, p = int(n), int(p)
    if p <= 1 or n <= 0:
        return 0
    if bits is None:
        return 2 * (p - 1) * (-(-n // p)) * 4
    _check_block(bits, block_size)
    chunk = _ring_chunk(n, p, bits, block_size)
    codes = chunk if bits == 8 else chunk // 2
    scales = 4 * (chunk // int(block_size) if block_size else 1)
    return 2 * (p - 1) * (codes + scales)


__all__ = ["block_roundtrip", "decode_wire_blocks", "encode_wire_blocks", "quantized_pmean",
           "quantized_psum", "ring_wire_bytes", "wire_block_bytes"]
