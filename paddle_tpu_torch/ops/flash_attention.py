"""Flash attention forward (counterpart of ``paddle_tpu.ops.flash_attention``).

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernel ``csrc/flash_fwd.cu`` (built at first launch, bound with ctypes);
on a CPU tensor it computes :func:`flash_attention_reference`, the plain
PyTorch version of the same function, which the tests hold against the
JAX package. There is no fallback between the two: a CUDA tensor the
kernel cannot take raises.

The TPU package's block sizes, block flags and interpret mode are TPU
facts and have no counterpart here: the kernel chooses its own tiles.
The backward kernels (``_dq_kernel``/``_dkv_kernel``) are not ported yet
(ROADMAP queue 2), so this is inference-only.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from ..core.errors import EnforceError, enforce

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel in this process (plain int, bumped at each
# launch and nowhere else; the smoke run zeroes it around the main path)
flash_fwd_launches = 0
_count_lock = threading.Lock()  # server workers launch from several threads


class UnsupportedFlashInput(EnforceError, ValueError):
    """A CUDA input the flash kernel was not built for (dtype, head dim,
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
    """
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
    if q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, causal, bias, seg_q, seg_k)
    else:
        out, lse = flash_fwd_cuda(q, k, v, causal, bias, seg_q, seg_k)
    return (out, lse) if return_lse else out


def flash_attention_reference(q, k, v, causal: bool = False,
                              key_bias: Optional[torch.Tensor] = None,
                              seg_q: Optional[torch.Tensor] = None,
                              seg_k: Optional[torch.Tensor] = None):
    """The plain PyTorch version of the kernel: (o, lse) with the kernel's
    masking conventions, f32 scores and softmax, probabilities rounded to
    v's dtype before P·V. Runs on any device."""
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
    s = s.masked_fill(masked, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m).masked_fill(s <= NEG_INF / 2, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def flash_fwd_cuda(q, k, v, causal: bool, key_bias=None, seg_q=None, seg_k=None):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors; returns (o, lse).
    Raises :class:`UnsupportedFlashInput` for what the kernel does not
    take and :class:`EnforceError` when the launch fails."""
    global flash_fwd_launches
    from . import _build

    dev = q.device
    enforce(dev.type == "cuda", f"flash_fwd_cuda: q is on {dev}, not a CUDA card")
    for name, t in (("k", k), ("v", v), ("key_bias", key_bias),
                    ("segment_ids", seg_q), ("kv_segment_ids", seg_k)):
        if t is not None and t.device != dev:
            raise UnsupportedFlashInput(
                f"flash_attention: {name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise UnsupportedFlashInput(
            f"flash_attention: the CUDA kernel takes float32 or bfloat16 "
            f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise UnsupportedFlashInput("flash_attention: q, k, v must be [b, h, s, d]")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d not in HEAD_DIMS:
        raise UnsupportedFlashInput(
            f"flash_attention: the CUDA kernel is built for head dims "
            f"{HEAD_DIMS}, got {d}")
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise UnsupportedFlashInput(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do "
            f"not match q {tuple(q.shape)}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if key_bias is not None:
        key_bias = key_bias.float().expand(b, sk).contiguous()
    if seg_q is not None:
        seg_k = seg_q if seg_k is None else seg_k
        seg_q = seg_q.to(torch.int32).expand(b, sq).contiguous()
        seg_k = seg_k.to(torch.int32).expand(b, sk).contiguous()
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if o.numel() == 0:  # no query row: nothing to launch, nothing to count
        return o, lse
    lib = _kernel(_build)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_fwd(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ptr(key_bias), ptr(seg_q), ptr(seg_k), o.data_ptr(), lse.data_ptr(),
            b, h, sq, sk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            1.0 / math.sqrt(d), int(bool(causal)), stream)
    if err != 0:
        raise EnforceError(f"flash_fwd kernel launch failed: CUDA error {err}")
    with _count_lock:
        flash_fwd_launches += 1
    return o, lse


# the C signature of flash_fwd in csrc/flash_fwd.cu, one entry per
# parameter: dtype, head_dim, 8 pointers, B, H, sq, sk, 9 strides, scale,
# causal, stream
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = [_I, _I] + [_P] * 8 + [_I] * 4 + [_LL] * 9 + [ctypes.c_float, _I, _P]


def _kernel(_build):
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib


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
