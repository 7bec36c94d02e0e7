"""Flash attention, forward and backward (counterpart of
``paddle_tpu.ops.flash_attention``).

:func:`flash_attention` is one ``torch.autograd.Function``
(:class:`_FlashCore`, the counterpart of the JAX package's ``_flash_core``
custom VJP). Its forward saves q, k, v, the key bias, the segment ids,
the output and the logsumexp; its backward is :func:`_flash_bwd`, the
recompute formula of the JAX package's ``_flash_bwd``. On CUDA tensors
both directions launch the hand-written Hopper kernels
(``csrc/flash_fwd.cu``; ``csrc/flash_bwd.cu``, a dQ pass and a dK/dV
pass), built at first launch and bound with ctypes. On CPU tensors both
run the plain PyTorch versions, :func:`flash_attention_reference` and
:func:`flash_attention_bwd_reference`, which the tests hold against the
JAX package. There is no fallback between the two: a CUDA tensor the
kernels cannot take raises.

The TPU package's block sizes, block flags and interpret mode are TPU
facts and have no counterpart here: the kernels choose their own tiles.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from ..core import profiler as _profiler
from ..core.errors import EnforceError, enforce
from . import _dtensor as _dt

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The route of all three kernels (the forward, the dQ and the dK/dV
# passes) by (dtype, head dim): bf16 at head dims 64 and 128 on the tensor
# cores ("wgmma": TMA loads, wgmma products), everything else on the CUDA
# cores ("cuda_core": f32 FMAs). f32 stays off the tensor cores, whose f32
# products are TF32; head dim 32 would need its own swizzle. This table is
# the rule: the wrappers pass its choice to csrc/flash_fwd.cu and
# csrc/flash_bwd.cu (:func:`_route_code`), which launch what they are told.
ROUTES = {(dtype, d): ("wgmma" if dtype == torch.bfloat16 and d in (64, 128)
                       else "cuda_core")
          for dtype in _DTYPE_CODES for d in HEAD_DIMS}

# launches of each CUDA kernel in this process (plain ints, bumped at each
# launch and nowhere else; the smoke run zeroes them around a main path)
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
_count_lock = threading.Lock()  # server workers launch from several threads


class UnsupportedFlashInput(EnforceError, ValueError):
    """A CUDA input the flash kernels were not built for (dtype, head dim,
    layout)."""


def flash_attention(q, k, v, causal: bool = False,
                    attn_mask: Optional[torch.Tensor] = None,
                    key_bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """Flash attention over [b, h, s, d].

    - ``key_bias``: additive [b, s_k] (padding mask).
    - ``segment_ids`` / ``kv_segment_ids``: int [b, s] ragged-batch ids;
      attention is masked across segment boundaries. ``segment_ids``
      alone is used for both sides.
    - ``attn_mask``: a [b,1,1,s_k] additive mask becomes a key bias; any
      other dense mask goes to the plain dense path (:func:`_mask_fallback`),
      which returns the output alone, as the JAX package does.
    - ``causal``: bottom-right aligned (query i sees key j when
      i + s_k − s_q ≥ j).
    - ``return_lse``: also return the per-query logsumexp [b, h, s_q] f32.
      Forward only, as in the JAX package (ring attention merges shards
      with it and calls :func:`_flash_bwd` itself): the outputs carry no
      gradient.

    q, k and v are differentiable; the bias and the ids are not.

    DTensors (a mesh's tensors) run on their local shards, with a batch or
    head shard kept and the sequence and head dims gathered
    (:func:`_flash_dtensor`).
    """
    if _dt.is_dtensor(q):
        return _flash_dtensor(q, k, v, causal, attn_mask, key_bias, segment_ids,
                              kv_segment_ids, return_lse)
    enforce(kv_segment_ids is None or segment_ids is not None,
            "flash_attention: kv_segment_ids requires segment_ids (the "
            "query-side ids) as well")
    if attn_mask is not None:
        if attn_mask.dim() == 4 and attn_mask.shape[1] == 1 and attn_mask.shape[2] == 1:
            key_bias = attn_mask[:, 0, 0, :] if key_bias is None \
                else key_bias + attn_mask[:, 0, 0, :]
        else:
            mask = attn_mask
            if key_bias is not None:
                mask = mask + key_bias[:, None, None, :]
            if segment_ids is not None:
                seg_k_ = kv_segment_ids if kv_segment_ids is not None else segment_ids
                same = segment_ids[:, None, :, None] == seg_k_[:, None, None, :]
                mask = torch.where(same, mask, torch.full_like(mask, NEG_INF))
            return _mask_fallback(q, k, v, mask, causal)
    seg_q = segment_ids
    seg_k = kv_segment_ids if kv_segment_ids is not None else segment_ids
    bias = None if key_bias is None else key_bias.float()
    if return_lse:
        with torch.no_grad():
            return _flash_fwd(q, k, v, bias, seg_q, seg_k, causal)
    return _FlashCore.apply(q, k, v, bias, seg_q, seg_k, bool(causal))


def _flash_dtensor(q, k, v, causal, attn_mask, key_bias, segment_ids, kv_segment_ids,
                   return_lse):
    """:func:`flash_attention` of DTensors: attention is independent per
    (batch, head), so q, k and v go to their local shards with a shard of
    dim 0 or 1 kept (the same for all three) and everything else
    replicated; the bias and the ids follow the batch shard. The output
    (and lse) come back as DTensors of those placements."""
    enforce(attn_mask is None, "flash_attention on DTensors takes key_bias and "
            "segment ids, not a dense attn_mask")
    pl = _dt.kept_placements(q, (0, 1))
    bpl = _dt.batch_placements(q)
    ql, kl, vl = (_dt.local_at(t, q, pl) for t in (q, k, v))
    out = flash_attention(ql, kl, vl, causal=causal,
                          key_bias=_dt.local_at(key_bias, q, bpl),
                          segment_ids=_dt.local_at(segment_ids, q, bpl),
                          kv_segment_ids=_dt.local_at(kv_segment_ids, q, bpl),
                          return_lse=return_lse)
    if return_lse:
        return _dt.wrap(out[0], q, pl), _dt.wrap(out[1], q, pl)
    return _dt.wrap(out, q, pl)


def _flash_fwd(q, k, v, bias, seg_q, seg_k, causal):
    """(o, lse): the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, bias, seg_q, seg_k)
    return flash_fwd_cuda(q, k, v, causal, bias, seg_q, seg_k)


class _FlashCore(torch.autograd.Function):
    """``_flash_core``'s custom VJP (paddle_tpu/ops/flash_attention.py
    :578-600): the forward keeps what the backward recomputes from, and
    the backward is :func:`_flash_bwd`. The bias and the segment ids get
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seg_q, seg_k, causal):
        out, lse = _flash_fwd(q, k, v, bias, seg_q, seg_k, causal)
        ctx.save_for_backward(q, k, v, bias, seg_q, seg_k, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seg_q, seg_k, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, bias, seg_q, seg_k, ctx.causal,
                                out, lse, g)
        return dq, dk, dv, None, None, None, None


def _flash_bwd(q, k, v, bias, seg_q, seg_k, causal, out, lse, g, delta=None):
    """(dq, dk, dv) of attention at cotangent ``g`` [b, h, sq, d], by the
    JAX package's recompute formula (``_flash_bwd`` :424): probabilities
    recomputed from ``lse`` [b, h, sq] f32, and δ = rowsum(out·g) in f32
    from the saved, rounded ``out`` unless ``delta`` [b, h, sq] is given.
    Callable on its own with lse and δ from outside, as ring attention
    calls it. The dQ and dK/dV kernels on CUDA tensors, the plain
    version on CPU tensors."""
    if delta is None:
        delta = (out.float() * g.float()).sum(-1)
    if seg_q is not None and seg_k is None:
        seg_k = seg_q
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, causal, bias, seg_q,
                                             seg_k, g, lse, delta)
    return flash_bwd_cuda(q, k, v, causal, bias, seg_q, seg_k, g, lse, delta)


def flash_attention_reference(q, k, v, causal: bool = False,
                              key_bias: Optional[torch.Tensor] = None,
                              seg_q: Optional[torch.Tensor] = None,
                              seg_k: Optional[torch.Tensor] = None):
    """The plain PyTorch version of the forward kernel: (o, lse) with the
    kernel's masking conventions, f32 scores and softmax, probabilities
    rounded to v's dtype before P·V. Runs on any device."""
    s = _masked_scores(q, k, causal, key_bias, seg_q, seg_k)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m).masked_fill(s <= NEG_INF / 2, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, causal, key_bias, seg_q, seg_k,
                                  g, lse, delta):
    """The plain PyTorch version of the two backward kernels: (dq, dk, dv)
    with their masks, f32 products and rounding points. Runs on any
    device."""
    args = (q, k, v, causal, key_bias, seg_q, seg_k, g, lse, delta)
    return (flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args))


def _bwd_probs(q, k, v, causal, key_bias, seg_q, seg_k, g, lse, delta):
    """P = exp(s − lse) with masked pairs 0, and dS = P∘(dP − δ)·scale,
    both f32, recomputed as each backward kernel recomputes them."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _masked_scores(q, k, causal, key_bias, seg_q, seg_k)
    p = torch.exp(s - lse.float()[..., None]).masked_fill(s <= NEG_INF / 2, 0.0)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.float()[..., None]) * scale


def flash_bwd_dq_reference(q, k, v, causal, key_bias, seg_q, seg_k, g, lse,
                           delta):
    """Plain version of the dQ kernel: dQ = dS·K, with dS rounded to k's
    dtype first (:371)."""
    _, ds = _bwd_probs(q, k, v, causal, key_bias, seg_q, seg_k, g, lse, delta)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, causal, key_bias, seg_q, seg_k, g, lse,
                            delta):
    """Plain version of the dK/dV kernel: dV = Pᵀ·dO with P rounded to
    dO's dtype (:407), dK = dSᵀ·Q with dS rounded to q's dtype (:415)."""
    p, ds = _bwd_probs(q, k, v, causal, key_bias, seg_q, seg_k, g, lse, delta)
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), g.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _masked_scores(q, k, causal, key_bias, seg_q, seg_k):
    """``_block_scores`` (:84) over whole [b, h, sq, sk] score matrices:
    f32 q·kᵀ·scale plus the key bias, NEG_INF where masked."""
    sq, sk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    masked = torch.zeros((), dtype=torch.bool, device=s.device)
    if seg_q is not None:
        seg_k = seg_q if seg_k is None else seg_k
        masked = masked | (seg_q[:, None, :, None] != seg_k[:, None, None, :])
    if causal:
        cm = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril(sk - sq)
        masked = masked | ~cm
    return s.masked_fill(masked, NEG_INF)


def _cuda_operands(q, k, v, key_bias, seg_q, seg_k, **more):
    """Check what the kernels take and bring it to their layout
    (:func:`_kernel_layout`), on q's CUDA device."""
    dev = q.device
    enforce(dev.type == "cuda", f"flash_attention: q is on {dev}, not a CUDA card")
    return _kernel_layout(q, k, v, key_bias, seg_q, seg_k, **more)


def _kernel_layout(q, k, v, key_bias, seg_q, seg_k, **more):
    """q, k, v (and the ``more`` tensors) on q's device, q/k/v of one dtype
    (float32 or bfloat16), [b, h, s, d] with d in :data:`HEAD_DIMS` and a
    contiguous last dim (read through their other strides; on the
    tensor-core route also as TMA reads them, :func:`_tma_ready`); the
    bias as contiguous f32 [b, sk], the ids as contiguous int32 [b, s]."""
    dev = q.device
    for name, t in (("k", k), ("v", v), ("key_bias", key_bias),
                    ("segment_ids", seg_q), ("kv_segment_ids", seg_k),
                    *more.items()):
        if t is not None and t.device != dev:
            raise UnsupportedFlashInput(
                f"flash_attention: {name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise UnsupportedFlashInput(
            f"flash_attention: the CUDA kernels take float32 or bfloat16 "
            f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise UnsupportedFlashInput("flash_attention: q, k, v must be [b, h, s, d]")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d not in HEAD_DIMS:
        raise UnsupportedFlashInput(
            f"flash_attention: the CUDA kernels are built for head dims "
            f"{HEAD_DIMS}, got {d}")
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise UnsupportedFlashInput(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do "
            f"not match q {tuple(q.shape)}")
    layout = _tma_ready if ROUTES[(q.dtype, d)] == "wgmma" else _last_dim_contiguous
    q, k, v = (layout(t) for t in (q, k, v))
    if key_bias is not None:
        key_bias = key_bias.float().expand(b, sk).contiguous()
    if seg_q is not None:
        seg_k = seg_q if seg_k is None else seg_k
        seg_q = seg_q.to(torch.int32).expand(b, sq).contiguous()
        seg_k = seg_k.to(torch.int32).expand(b, sk).contiguous()
    return q, k, v, key_bias, seg_q, seg_k


def _last_dim_contiguous(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def _tma_ready(t):
    """``t`` as TMA reads it: the same tensor when its base address and
    every stride but the last (which is 1) are positive multiples of 16
    bytes, as the fused qkv projection's head views and the transposed dO
    are; otherwise a fresh contiguous copy, which is."""
    es = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st > 0 and st * es % 16 == 0 for st in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _route_code(dtype, d):
    """The C entry points' first argument: 0 (f32) or 1 (bf16) on the CUDA
    cores, as :data:`_DTYPE_CODES`; 2, bf16 on the tensor cores."""
    return 2 if ROUTES[(dtype, d)] == "wgmma" else _DTYPE_CODES[dtype]


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd_cuda(q, k, v, causal: bool, key_bias=None, seg_q=None, seg_k=None):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors; returns (o, lse).
    Raises :class:`UnsupportedFlashInput` for what the kernel does not
    take and :class:`EnforceError` when the launch fails."""
    _dt.refuse("flash_fwd_cuda", q, k, v, key_bias, seg_q, seg_k)
    global flash_fwd_launches
    q, k, v, key_bias, seg_q, seg_k = _cuda_operands(q, k, v, key_bias, seg_q, seg_k)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:  # no query row: nothing to launch, nothing to count
        return o, lse
    fn = _kernel("flash_fwd", "flash_fwd", ARGTYPES)
    with _profiler.kernel_range("flash_fwd"), torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_route_code(q.dtype, d), d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 _ptr(key_bias), _ptr(seg_q), _ptr(seg_k), o.data_ptr(),
                 lse.data_ptr(), b, h, sq, sk, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], 1.0 / math.sqrt(d), int(bool(causal)), stream)
    if err != 0:
        raise EnforceError(f"flash_fwd kernel launch failed: CUDA error {err}")
    with _count_lock:
        flash_fwd_launches += 1
    return o, lse


def flash_bwd_cuda(q, k, v, causal: bool, key_bias, seg_q, seg_k, g, lse, delta):
    """Both backward kernels on CUDA tensors, the dQ pass then the dK/dV
    pass: (dq, dk, dv) in q's, k's and v's dtype."""
    args = (q, k, v, causal, key_bias, seg_q, seg_k, g, lse, delta)
    return (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))


def flash_bwd_dq_cuda(q, k, v, causal: bool, key_bias, seg_q, seg_k, g, lse,
                      delta):
    """Launch ``flash_bwd_dq`` of ``csrc/flash_bwd.cu``; returns dq. ``g``
    (dO) is read through its strides like q; ``lse`` and ``delta`` are
    [b, h, sq] f32. Raises :class:`UnsupportedFlashInput` for what the
    kernel does not take and :class:`EnforceError` when the launch
    fails."""
    _dt.refuse("flash_bwd_dq_cuda", q, k, v, key_bias, seg_q, seg_k, g, lse, delta)
    global flash_bwd_dq_launches
    ops, common, sizes = _bwd_operands(q, k, v, causal, key_bias, seg_q, seg_k,
                                       g, lse, delta)
    dev = q.device
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    if dq.numel() == 0:  # no row to write: nothing to launch or count
        return dq
    fn = _kernel("flash_bwd", "flash_bwd_dq", BWD_ARGTYPES["flash_bwd_dq"])
    _launch(fn, "flash_bwd_dq", dev, *common, dq.data_ptr(), *sizes)
    with _count_lock:
        flash_bwd_dq_launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, causal: bool, key_bias, seg_q, seg_k, g, lse,
                       delta):
    """Launch ``flash_bwd_dkv`` of ``csrc/flash_bwd.cu``; returns (dk,
    dv). Takes what :func:`flash_bwd_dq_cuda` takes."""
    _dt.refuse("flash_bwd_dkv_cuda", q, k, v, key_bias, seg_q, seg_k, g, lse, delta)
    global flash_bwd_dkv_launches
    ops, common, sizes = _bwd_operands(q, k, v, causal, key_bias, seg_q, seg_k,
                                       g, lse, delta)
    dev = q.device
    dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
    if dk.numel() == 0:
        return dk, dv
    fn = _kernel("flash_bwd", "flash_bwd_dkv", BWD_ARGTYPES["flash_bwd_dkv"])
    _launch(fn, "flash_bwd_dkv", dev, *common, dk.data_ptr(), dv.data_ptr(),
            *sizes)
    with _count_lock:
        flash_bwd_dkv_launches += 1
    return dk, dv


def _bwd_operands(q, k, v, causal, key_bias, seg_q, seg_k, g, lse, delta):
    """(ops, common, sizes): the checked operands in the kernels' layout,
    and the kernels' arguments before and after their output pointers.
    The caller holds ``ops`` until its launch is queued, so no pointer
    outlives its tensor."""
    q, k, v, key_bias, seg_q, seg_k = _cuda_operands(
        q, k, v, key_bias, seg_q, seg_k, dout=g, lse=lse, delta=delta)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(g.shape) != (b, h, sq, d) or g.dtype != q.dtype:
        raise UnsupportedFlashInput(
            f"flash_attention backward: dO {tuple(g.shape)} {g.dtype} does "
            f"not match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, sq):
            raise UnsupportedFlashInput(
                f"flash_attention backward: {name} is {tuple(t.shape)}, "
                f"expected {(b, h, sq)}")
    g = (_tma_ready if ROUTES[(q.dtype, d)] == "wgmma" else _last_dim_contiguous)(g)
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    common = [_route_code(q.dtype, d), d, q.data_ptr(), k.data_ptr(),
              v.data_ptr(), _ptr(key_bias), _ptr(seg_q), _ptr(seg_k), g.data_ptr(),
              lse.data_ptr(), delta.data_ptr()]
    sizes = [b, h, sq, sk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *g.stride()[:3], 1.0 / math.sqrt(d), int(bool(causal))]
    ops = (q, k, v, key_bias, seg_q, seg_k, g, lse, delta)
    return ops, common, sizes


def _launch(fn, name, dev, *args):
    # a profiling report names the kernel's launching op after its wrapper
    with _profiler.kernel_range(name), torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise EnforceError(f"{name} kernel launch failed: CUDA error {err}")


# the C signatures of csrc/flash_fwd.cu and csrc/flash_bwd.cu, one entry per
# parameter. flash_fwd: route, head_dim, 8 pointers (q, k, v, bias, seg_q,
# seg_k, o, lse), B, H, sq, sk, 9 strides, scale, causal, stream. The
# backward passes: route, head_dim, 9 input pointers (q, k, v, bias, seg_q,
# seg_k, dO, lse, delta), their 1 (dq) or 2 (dk, dv) output pointers, B, H,
# sq, sk, 12 strides (q, k, v, dO), scale, causal, stream.
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = [_I, _I] + [_P] * 8 + [_I] * 4 + [_LL] * 9 + [ctypes.c_float, _I, _P]
BWD_ARGTYPES = {
    name: [_I, _I] + [_P] * (9 + n_out) + [_I] * 4 + [_LL] * 12
    + [ctypes.c_float, _I, _P]
    for name, n_out in (("flash_bwd_dq", 1), ("flash_bwd_dkv", 2))
}


def _kernel(source: str, entry: str, argtypes):
    """The C entry point ``entry`` of the library built from
    ``csrc/<source>.cu``, with its argtypes set."""
    from . import _build
    fn = getattr(_build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _mask_fallback(q, k, v, attn_mask, causal):
    from .attention_scores import scores_mxu
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = scores_mxu(q, k, scale) + attn_mask
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        cm = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~cm, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)
