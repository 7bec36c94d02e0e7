"""Variable-length sequence ops, the LoD equivalent (counterpart of
``paddle_tpu.layers.sequence``).

As in the JAX package, a ragged batch has two static-shape forms:

- **packed**: values [total, ...] and ``segment_ids`` [total] (the row of
  each element; ids at or past ``num_seqs`` drop out of the reductions);
- **padded**: values [batch, max_len, ...] and ``lengths`` [batch];

with the converters between them and LoD offsets, the ``sequence_*`` ops
and :class:`LoDTensor`, which carries nested LoD levels as host lists
beside packed values on a device.

The segment reductions give the same bits run to run on the card: a sum
is ``index_put_(accumulate=True)``, which sorts the ids and adds in order
on CUDA (never ``index_add_``/``scatter_add_``, whose float atomics add
in a varying order); a max or min is ``scatter_reduce``, exact in any
order. A gather ``x[ids]`` follows the JAX gather's index rule
(:func:`nn.take_rows`: negative ids count from the end, then clamp), and
its backward sums repeated ids in the same sorted order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import initializer as init
from ..core.dtypes import convert_dtype
from ..core.errors import enforce
from ..core.place import default_device
from ..framework import LayerHelper, cast_compute, compute_dtype
from .nn import take_rows
from .ops import apply_activation

_INT32_MAX = torch.iinfo(torch.int32).max
_INT32_MIN = torch.iinfo(torch.int32).min

# ---------------------------------------------------------------------------
# segment reductions (jax.ops.segment_* with num_segments)
# ---------------------------------------------------------------------------


def _safe_ids(segment_ids, num: int) -> torch.Tensor:
    """int64 ids with every id outside [0, num) sent to ``num``, a slot the
    caller drops."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num), ids, num)


def _segment_sum(data, segment_ids, num: int):
    """[num, ...] sums of ``data``'s rows by segment; ids outside [0, num)
    are dropped. Sorted and summed in order on the card."""
    out = torch.zeros((num + 1,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_put((_safe_ids(segment_ids, num),), data, accumulate=True)[:num]


def _identity(dtype, reduce: str):
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    return _INT32_MIN if reduce == "amax" else _INT32_MAX


def _segment_extreme(data, segment_ids, num: int, reduce: str):
    """[num, ...] max (``reduce="amax"``) or min (``"amin"``) by segment;
    an empty segment gives the reduction's identity (−inf/+inf for floats,
    the int32 extremes for ints), as jax.ops.segment_max/min."""
    ids = _safe_ids(segment_ids, num).reshape((-1,) + (1,) * (data.dim() - 1))
    out = torch.full((num + 1,) + tuple(data.shape[1:]), _identity(data.dtype, reduce),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, ids.expand_as(data), data, reduce, include_self=True)[:num]


def _arange(n: int, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=like.device)


def _as_tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    device = like.device if like is not None else None
    return torch.as_tensor(np.asarray(x), device=device)


# ---------------------------------------------------------------------------
# representation converters (LoD <-> segment ids <-> padded)
# ---------------------------------------------------------------------------


def lengths_to_offsets(lengths):
    """lengths [b] -> LoD offsets (row_splits) [b+1]."""
    lengths = _as_tensor(lengths)
    return torch.cat([torch.zeros(1, dtype=lengths.dtype, device=lengths.device),
                      torch.cumsum(lengths, 0, dtype=lengths.dtype)])


def offsets_to_lengths(offsets):
    return offsets[1:] - offsets[:-1]


def lengths_to_segment_ids(lengths, total: int):
    """lengths [b] -> int32 segment ids [total]; positions past
    sum(lengths) get id b, so they drop out of reductions over b
    segments."""
    lengths = _as_tensor(lengths)
    offsets = torch.cumsum(lengths, 0, dtype=lengths.dtype)
    pos = _arange(total, lengths, lengths.dtype)
    return torch.searchsorted(offsets, pos, right=True).to(torch.int32)


def segment_ids_to_lengths(segment_ids, num_seqs: int):
    return _segment_sum(torch.ones_like(segment_ids), segment_ids, num_seqs)


def sequence_pad(packed, lengths, max_len: int, pad_value=0.0):
    """packed [total, ...] + lengths [b] -> (padded [b, max_len, ...],
    lengths) (sequence_pad_op.cc analog)."""
    lengths = _as_tensor(lengths, packed)
    total = packed.shape[0]
    offsets = torch.cat([torch.zeros(1, dtype=lengths.dtype, device=lengths.device),
                         torch.cumsum(lengths, 0, dtype=lengths.dtype)[:-1]])
    col = _arange(max_len, lengths, lengths.dtype)[None, :]
    src = torch.clamp(offsets[:, None] + col, 0, total - 1)
    valid = col < lengths[:, None]
    out = packed[src.long()]
    mask = valid.reshape(valid.shape + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.as_tensor(pad_value, dtype=out.dtype,
                                                  device=out.device)), lengths


def sequence_unpad(padded, lengths):
    """padded [b, max_len, ...] + lengths -> (packed [b·max_len, ...],
    segment ids): the padded capacity kept, tail positions given id b
    (sequence_unpad_op.cc analog)."""
    lengths = _as_tensor(lengths, padded)
    b, t = padded.shape[0], padded.shape[1]
    flat = padded.reshape((b * t,) + tuple(padded.shape[2:]))
    valid = _arange(t, padded)[None, :] < lengths[:, None]
    seg = torch.where(valid, _arange(b, padded)[:, None], b).reshape(-1).to(torch.int32)
    return flat, seg


# ---------------------------------------------------------------------------
# the sequence_pool family (sequence_pool_op.cc) and the other sequence ops
# ---------------------------------------------------------------------------


def sequence_pool(packed, segment_ids, num_seqs: int, pool_type: str = "average"):
    """Pool each sequence (sequence_pool_op.cc analog): ``pool_type`` is
    one of sum, average, sqrt, max, min, first, last. Elements with
    segment_id >= num_seqs are ignored."""
    pool_type = pool_type.lower()
    if pool_type in ("sum", "average", "sqrt"):
        s = _segment_sum(packed, segment_ids, num_seqs)
        if pool_type == "sum":
            return s
        cnt = _segment_sum(torch.ones(packed.shape[0], dtype=packed.dtype,
                                      device=packed.device), segment_ids, num_seqs)
        cnt = torch.clamp_min(cnt, 1.0).reshape((num_seqs,) + (1,) * (packed.dim() - 1))
        return s / cnt if pool_type == "average" else s / torch.sqrt(cnt)
    if pool_type in ("max", "min"):
        return _segment_extreme(packed, segment_ids, num_seqs, "a" + pool_type)
    if pool_type in ("first", "last"):
        total = packed.shape[0]
        pos = _arange(total, packed)
        idx = _segment_extreme(pos, segment_ids, num_seqs,
                               "amin" if pool_type == "first" else "amax")
        return packed[torch.clamp(idx, 0, total - 1).long()]
    raise ValueError(f"unknown pool_type {pool_type}")


def sequence_first_step(packed, segment_ids, num_seqs: int):
    return sequence_pool(packed, segment_ids, num_seqs, "first")


def sequence_last_step(packed, segment_ids, num_seqs: int):
    return sequence_pool(packed, segment_ids, num_seqs, "last")


def sequence_softmax(packed, segment_ids, num_seqs: int):
    """Softmax within each sequence (sequence_softmax_op.cc analog), shifted
    by each segment's max."""
    m = _segment_extreme(packed, segment_ids, num_seqs, "amax")
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(packed - take_rows(m, segment_ids))
    denom = _segment_sum(e, segment_ids, num_seqs)
    return e / torch.clamp_min(take_rows(denom, segment_ids), 1e-30)


def sequence_expand(x, ref_lengths, axis_total: int = None, ref_level: int = -1):
    """Repeat row x[i] ref_lengths[i] times (sequence_expand_op.cc analog).
    ``axis_total`` is the static output length. ``ref_lengths`` may be a
    :class:`LoDTensor`, whose level ``ref_level`` supplies the counts
    (the op's ref_level attribute)."""
    if isinstance(ref_lengths, LoDTensor):
        lens = ref_lengths.seq_lens[ref_lengths._level(ref_level)]
        if axis_total is None:
            axis_total = int(sum(lens))
        ref_lengths = torch.as_tensor(lens, dtype=torch.int32, device=x.device)
    enforce(axis_total is not None, "sequence_expand: axis_total required for array lengths")
    seg = lengths_to_segment_ids(_as_tensor(ref_lengths, x), axis_total)
    return x[torch.clamp(seg, 0, x.shape[0] - 1).long()]


def sequence_reverse(packed, segment_ids, num_seqs: int):
    """Reverse each sequence in place (sequence_reverse_op.cc analog)."""
    total = packed.shape[0]
    pos = _arange(total, packed)
    first = _segment_extreme(pos, segment_ids, num_seqs + 1, "amin")
    last = _segment_extreme(pos, segment_ids, num_seqs + 1, "amax")
    sid = torch.clamp(segment_ids.long(), 0, num_seqs)
    mirrored = first[sid] + last[sid] - pos
    src = torch.where(segment_ids < num_seqs, mirrored, pos)
    return packed[src.long()]


def sequence_concat(packed_list, segment_ids_list, num_seqs: int):
    """Concatenate sequences by segment (sequence_concat_op analog): the
    output packs sequence 0 of every input, then sequence 1, ... Returns
    (packed, segment_ids)."""
    packed = torch.cat(list(packed_list), dim=0)
    seg = torch.cat(list(segment_ids_list), dim=0)
    order = torch.argsort(seg, stable=True)
    return packed[order], seg[order]


def sequence_enumerate(ids, win_size: int, pad_value: int = 0):
    """sequence_enumerate_op analog over padded [b, t] ids: the sliding
    windows [b, t, win_size]."""
    b, _ = ids.shape
    cols = [torch.cat([ids[:, w:], torch.full((b, w), pad_value, dtype=ids.dtype,
                                              device=ids.device)], dim=1)
            for w in range(win_size)]
    return torch.stack(cols, dim=-1)


def sequence_mask(lengths, maxlen: int, dtype=torch.float32):
    """sequence_mask op analog: a [b, maxlen] 1/0 mask."""
    lengths = _as_tensor(lengths)
    return (_arange(maxlen, lengths, lengths.dtype)[None, :] < lengths[:, None]) \
        .to(convert_dtype(dtype))


def sequence_erase(packed, segment_ids, tokens_to_erase, num_seqs: int):
    """sequence_erase_op analog, static-shape: erased positions get segment
    id ``num_seqs`` (so reductions skip them) instead of being compacted.
    Returns (packed, new_segment_ids)."""
    erase = torch.zeros(packed.shape[0], dtype=torch.bool, device=packed.device)
    for t in tokens_to_erase:
        erase = erase | (packed == t)
    return packed, torch.where(erase, num_seqs, segment_ids).to(torch.int32)


def sequence_slice(packed, segment_ids, num_seqs: int, offset, length, total_out: int):
    """sequence_slice_op analog: each sequence's [offset, offset+length)
    window, repacked into capacity ``total_out`` with fresh segment ids.
    Returns (packed, segment_ids)."""
    offset, length = _as_tensor(offset, packed), _as_tensor(length, packed)
    pos = _arange(packed.shape[0], packed)
    first = _segment_extreme(pos, segment_ids, num_seqs + 1, "amin")[:num_seqs]
    out_seg = lengths_to_segment_ids(length, total_out)
    out_seg_c = torch.clamp(out_seg, 0, num_seqs - 1).long()
    out_off = torch.cat([torch.zeros(1, dtype=torch.int32, device=packed.device),
                         torch.cumsum(length, 0).to(torch.int32)[:-1]])
    within = _arange(total_out, packed) - out_off[out_seg_c]
    src = first[out_seg_c] + offset[out_seg_c].to(torch.int32) + within
    src = torch.clamp(src, 0, packed.shape[0] - 1)
    return packed[src.long()], torch.where(out_seg < num_seqs, out_seg,
                                           num_seqs).to(torch.int32)


def sequence_conv(packed, segment_ids, num_filters: int, filter_size: int = 3,
                  filter_stride: int = 1, padding=None, param_attr=None,
                  bias_attr=None, act=None, name=None):
    """Sequence (time) convolution on packed values and segment ids
    (sequence_conv_op.cc; context_start = -filter_size//2, as
    layers/nn.py:1349): output row t sees rows [t+context_start,
    t+context_start+filter_size) of its own sequence, zero across a
    boundary; one shifted GEMM a tap against the ``[filter_size·d,
    num_filters]`` weight ``w``."""
    enforce(filter_stride == 1, "sequence_conv: only stride 1 (reference semantics)")
    helper = LayerHelper("sequence_conv", name=name)
    total, d = packed.shape
    context_start = -(filter_size // 2)
    w = helper.create_parameter("w", (filter_size * d, num_filters), torch.float32,
                                attr=param_attr, initializer=init.Xavier())
    x, w = cast_compute(compute_dtype(), packed, w)
    out = torch.zeros((total, num_filters), dtype=x.dtype, device=x.device)
    pos = torch.arange(total, device=x.device)
    for tap in range(filter_size):
        shifted_pos = pos + context_start + tap
        src = torch.clamp(shifted_pos, 0, total - 1)
        valid = ((shifted_pos >= 0) & (shifted_pos < total)
                 & (segment_ids[src] == segment_ids))[:, None]
        shifted = torch.where(valid, x[src], 0.0)
        out = out + torch.matmul(shifted, w[tap * d:(tap + 1) * d])
    if bias_attr is not False:
        b = helper.create_parameter("b", (num_filters,), torch.float32, attr=bias_attr,
                                    initializer=init.Constant(0.0))
        out = out + b.to(out.dtype)
    return apply_activation(out, act)


def sequence_expand_as(x, ref_lengths, axis_total: int):
    """sequence_expand_as_op analog: row i of x repeated ref_lengths[i]
    times (each input sequence one row, the common fluid usage)."""
    return sequence_expand(x, ref_lengths, axis_total)


def sequence_reshape(packed, lengths, new_dim: int):
    """sequence_reshape_op analog: refold each sequence's payload to width
    ``new_dim``; lengths scale by old_dim/new_dim. Returns (packed2,
    lengths2)."""
    total, d = packed.shape
    enforce(total * d % new_dim == 0, "sequence_reshape: size not divisible")
    return packed.reshape(total * d // new_dim, new_dim), \
        (_as_tensor(lengths, packed) * d) // new_dim


def sequence_scatter(x, ids, ids_segment_ids, updates):
    """sequence_scatter_op analog: out[seg[j], ids[j]] += updates[j] for
    packed (ids, updates) whose segment ids map each entry to a row of x;
    repeated targets add in sorted order."""
    seg = _as_tensor(ids_segment_ids, x).long()
    idx = _as_tensor(ids, x).reshape(-1).long()
    return x.index_put((seg, idx), updates.to(x.dtype), accumulate=True)


def lod_reset(x, target_lengths, capacity: Optional[int] = None):
    """lod_reset_op analog: keep the values, re-segment. Returns (x,
    segment_ids) from ``target_lengths`` over x's row capacity."""
    cap = capacity if capacity is not None else x.shape[0]
    return x, lengths_to_segment_ids(_as_tensor(target_lengths, x), cap)


def reorder_lod_tensor_by_rank(padded, lengths):
    """reorder_lod_tensor_by_rank_op + lod_rank_table analog: the batch in
    descending-length order (ties keep their order). Returns (padded',
    lengths', perm); ``torch.argsort(perm)`` inverts it."""
    lengths = _as_tensor(lengths, padded)
    perm = torch.argsort(-lengths, stable=True)
    return padded[perm], lengths[perm], perm


# ---------------------------------------------------------------------------
# LoDTensor: packed values + nested LoD levels (lod_tensor.h:58-110)
# ---------------------------------------------------------------------------


class LoDTensor:
    """Packed values on a device and nested LoD metadata on the host.

    ``recursive_seq_lens`` is a list of levels, outermost first; each
    level's entries count units of the next level (the innermost counts
    value rows), the reference's recursive_sequence_lengths() view. The
    values stay where a tensor lies (``place`` moves them); numpy or list
    values go to ``place``, the CUDA card unless the caller asks for the
    CPU. Iterates as the single-level ``(values, lengths, segment_ids)``
    triple of the innermost level."""

    def __init__(self, values, recursive_seq_lens, place=None):
        enforce(len(recursive_seq_lens) > 0,
                "LoDTensor: recursive_seq_lens must have at least one level")
        if not isinstance(recursive_seq_lens[0], (list, tuple, np.ndarray)):
            recursive_seq_lens = [list(recursive_seq_lens)]
        if isinstance(values, torch.Tensor):
            self.values = values if place is None else values.to(default_device(place))
        else:
            self.values = torch.as_tensor(np.asarray(values),
                                          device=default_device(place, "LoDTensor"))
        self.seq_lens = [[int(v) for v in level] for level in recursive_seq_lens]
        for li in range(len(self.seq_lens) - 1):
            enforce(sum(self.seq_lens[li]) == len(self.seq_lens[li + 1]),
                    f"LoDTensor: level {li} lengths must sum to the number of "
                    f"level-{li + 1} sequences "
                    f"({sum(self.seq_lens[li])} != {len(self.seq_lens[li + 1])})")
        enforce(sum(self.seq_lens[-1]) == int(self.values.shape[0]),
                "LoDTensor: innermost lengths must sum to data rows")

    @property
    def lod_level(self) -> int:
        return len(self.seq_lens)

    def recursive_sequence_lengths(self):
        return [list(level) for level in self.seq_lens]

    def lod(self):
        """Offset form: each level's offsets index units of the next level
        (rows for the innermost), LoD as lod_tensor.h:58 stores it."""
        return [[0] + np.cumsum(level, dtype=np.int64).tolist() for level in self.seq_lens]

    def _level(self, level: int) -> int:
        """A python-style level index, range-checked (the reference op
        bound-checks its ref_level attribute)."""
        enforce(-self.lod_level <= level < self.lod_level,
                f"LoD level {level} out of range for lod_level={self.lod_level}")
        return level % self.lod_level

    def num_seqs(self, level: int = 0) -> int:
        return len(self.seq_lens[self._level(level)])

    def row_lengths(self, level: int = -1):
        """Lengths at ``level`` in value rows, every level below composed:
        for lod [[2, 1], [3, 2, 4]], row_lengths(0) = [5, 4]."""
        level = self._level(level)
        lens = list(self.seq_lens[-1])
        for li in range(self.lod_level - 2, level - 1, -1):
            grouped, pos = [], 0
            for n in self.seq_lens[li]:
                grouped.append(sum(lens[pos:pos + n]))
                pos += n
            lens = grouped
        return lens

    def segment_ids(self, level: int = -1):
        """Row-granular segment ids of each value row's ``level`` sequence,
        so every packed op of this module works at any level."""
        lens = torch.as_tensor(self.row_lengths(level), dtype=torch.int32,
                               device=self.values.device)
        return lengths_to_segment_ids(lens, int(self.values.shape[0]))

    def pool(self, pool_type: str = "average", level: int = -1):
        """sequence_pool at ``level``: pooling the innermost level keeps the
        outer levels (each inner sequence becomes a row), pooling an outer
        level collapses everything below it. Returns a LoDTensor while
        levels remain, else the pooled tensor."""
        level = self._level(level)
        pooled = sequence_pool(self.values, self.segment_ids(level), self.num_seqs(level),
                               pool_type)
        if level == 0:
            return pooled
        return LoDTensor(pooled, self.seq_lens[:level])

    def sequences(self, level: int = -1):
        """The host's ragged view: nested lists of numpy rows split at
        ``level`` and below."""
        vals = self.values.detach().cpu().numpy()
        flat = np.split(vals, np.cumsum(self.row_lengths(-1))[:-1])
        level = self._level(level)
        for li in range(self.lod_level - 2, level - 1, -1):
            grouped, pos = [], 0
            for n in self.seq_lens[li]:
                grouped.append(flat[pos:pos + n])
                pos += n
            flat = grouped
        return flat

    def __iter__(self):
        lens = torch.as_tensor(self.row_lengths(-1), dtype=torch.int32,
                               device=self.values.device)
        return iter((self.values, lens, self.segment_ids(-1)))

    def __repr__(self):
        return (f"LoDTensor(shape={tuple(self.values.shape)}, "
                f"lod={self.recursive_sequence_lengths()})")


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """lod_tensor.py create_lod_tensor analog: a :class:`LoDTensor` with the
    full nested structure on ``place`` (the card unless the caller asks
    for the CPU); unpacked as ``values, lens, seg`` it gives the innermost
    level."""
    return LoDTensor(data, recursive_seq_lens, place)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low: int = 0, high: int = 1):
    """lod_tensor.py create_random_int_lodtensor analog: ints in [low, high]
    drawn from numpy's global generator, as the reference draws them."""
    lens = recursive_seq_lens
    while isinstance(lens[0], (list, tuple)):
        lens = lens[-1]
    total = int(np.sum(lens))
    data = np.random.randint(low, high + 1, (total,) + tuple(base_shape)).astype(np.int32)
    return create_lod_tensor(data, recursive_seq_lens, place)


__all__ = ["LoDTensor", "create_lod_tensor", "create_random_int_lodtensor",
           "lengths_to_offsets", "lengths_to_segment_ids", "lod_reset",
           "offsets_to_lengths", "reorder_lod_tensor_by_rank", "segment_ids_to_lengths",
           "sequence_concat", "sequence_conv", "sequence_enumerate", "sequence_erase",
           "sequence_expand", "sequence_expand_as", "sequence_first_step",
           "sequence_last_step", "sequence_mask", "sequence_pad", "sequence_pool",
           "sequence_reshape", "sequence_reverse", "sequence_scatter", "sequence_slice",
           "sequence_softmax", "sequence_unpad"]
