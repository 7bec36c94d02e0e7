"""Sparse gradients and row-wise updates (counterpart of
``paddle_tpu.sparse``).

- :class:`SelectedRows`: (rows, values) pairs with a fixed row capacity,
  rows possibly repeated (the reference's SelectedRows before MergeAdd),
  and ``height``, the dense dim 0.
- :func:`merge_selected_rows`: duplicates summed (MergeAdd), in the JAX
  output's layout: rows ascending, then padding slots of row ``height``
  with zero values.
- :func:`lookup_rowwise_grad`: the table gradient of a lookup as
  SelectedRows, with no dense ``[vocab, d]`` gradient.
- :func:`apply_sgd`, :func:`apply_adagrad`, :func:`apply_adam_lazy`: the
  row-wise updates (sparse sgd_op, adagrad_op, lazy-mode adam_op), which
  return new tensors and leave their inputs as they were.

Every sum of repeated rows is an ``index_put_(accumulate=True)``: on the
card it sorts the indices and adds each row's values in their order, so
two runs give the same bits (``index_add_`` adds with atomics, in a
different order each run). A slot whose row lies outside ``[0, height)``
changes nothing. The JAX package drops such a slot too where its row is
``height`` or more; a negative row it clips into row 0.

One difference from the JAX package, by design: its ``apply_adagrad``
and ``apply_adam_lazy`` write the moments back with ``.at[clipped].set``
for every slot, so a padding slot clipped to row ``height - 1`` writes
that row's old moment beside the new one, and which write wins is not
defined (on the CPU the old one wins). Here only the valid slots write
their rows' moments.

``sharded_embedding_lookup`` looks ids up in a table row-sharded over a
mesh axis (``ep``): each rank gathers its rows' hits and one sum over the
axis merges them.
"""

from __future__ import annotations

import dataclasses

import torch

from .core.errors import enforce


@dataclasses.dataclass
class SelectedRows:
    """Sparse rows (selected_rows.h:32 analog): ``rows`` [n] int may
    repeat; ``values`` [n, ...] are the rows' payloads; ``height`` is the
    dense dim-0 size."""

    rows: torch.Tensor
    values: torch.Tensor
    height: int

    def to_dense(self) -> torch.Tensor:
        """The dense ``[height, ...]`` tensor: the values summed into their
        rows, as ``zeros.at[rows].add(values)`` (a negative row counts from
        the end; a row outside ``[-height, height)`` is dropped)."""
        h = self.height
        rows = self.rows.long()
        keep = (rows >= -h) & (rows < h)
        idx = torch.where(rows < 0, rows + h, rows).clamp(0, h - 1)
        vals = torch.where(_col(keep, self.values), self.values,
                           torch.zeros((), dtype=self.values.dtype, device=self.values.device))
        dense = torch.zeros((h,) + tuple(self.values.shape[1:]), dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_put_((idx,), vals, accumulate=True)


def _col(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-slot mask [n] shaped to broadcast over ``like`` [n, ...]."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def merge_selected_rows(sr: SelectedRows) -> SelectedRows:
    """Sum duplicate rows (MergeAdd; sparse.py:60). The capacity stays n:
    slot g holds the g-th distinct row in ascending order and its summed
    values; the slots left over hold row ``height`` and zeros. The sort is
    stable, as ``jnp.argsort``, so each row's values are added in their
    input order."""
    n = sr.rows.shape[0]
    dev = sr.rows.device
    order = torch.sort(sr.rows, stable=True).indices
    rows_s = sr.rows[order]
    vals_s = sr.values[order]
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          rows_s[1:] != rows_s[:-1]])
    group = torch.cumsum(is_first, 0) - 1  # each element's group
    summed = torch.zeros_like(vals_s).index_put_((group,), vals_s, accumulate=True)
    pos = torch.arange(n, device=dev)
    # slot g <- the first element of the g-th group (n for the left-over slots)
    slot_src = torch.sort(torch.where(is_first, pos, n)).values
    valid = slot_src < n
    src = slot_src.clamp(0, n - 1)
    new_rows = torch.where(valid, rows_s[src], sr.height).to(torch.int32)
    new_vals = torch.where(_col(valid, summed), summed[group[src].clamp(0, n - 1)],
                           torch.zeros((), dtype=summed.dtype, device=dev))
    return SelectedRows(new_rows, new_vals, sr.height)


def lookup_rowwise_grad(ids: torch.Tensor, grad_out: torch.Tensor, vocab: int) -> SelectedRows:
    """The gradient of ``table[ids]`` with respect to the table, as
    SelectedRows (sparse.py:86; the is_sparse lookup_table_grad): rows are
    the flattened ids, values ``grad_out`` reshaped to one row each."""
    rows = ids.reshape(-1).to(torch.int32)
    values = grad_out.reshape((rows.shape[0],) + tuple(grad_out.shape[ids.dim():]))
    return SelectedRows(rows, values, vocab)


# -- row-wise optimizer updates (sparse sgd_op / adagrad_op / lazy adam) -----


def _slots(table: torch.Tensor, rows: torch.Tensor):
    """(each slot's row clamped into the table, whether the slot's row lies
    in ``[0, height)``)."""
    rows = rows.long()
    valid = (rows >= 0) & (rows < table.shape[0])
    return rows.clamp(0, table.shape[0] - 1), valid


def _set_rows(dst: torch.Tensor, safe: torch.Tensor, valid: torch.Tensor,
              new_rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``dst`` with ``dst[safe[i]] = new_rows[i]`` for each valid
    slot i (the valid slots name distinct rows) and every other row as it
    was. An invalid slot repeats the last valid slot's write, so every
    index written twice gets the same value and the result does not depend
    on the order of the writes; with no valid slot, each slot writes its
    row's old value."""
    n = safe.shape[0]
    keep = _col(valid, new_rows)
    new_rows = torch.where(keep, new_rows, dst[safe])
    # a one-element index: a 0-d one would be read back to the host
    last = torch.argmax(torch.where(valid, torch.arange(n, device=safe.device), -1)).reshape(1)
    idx = torch.where(valid, safe, safe[last])
    vals = torch.where(keep, new_rows, new_rows[last])
    return dst.index_put((idx,), vals)


def apply_sgd(table: torch.Tensor, sr: SelectedRows, lr) -> torch.Tensor:
    """Row-wise SGD (sparse.py:96; sgd_op's SelectedRows branch): each
    slot's ``−lr·values`` added into its row, repeated rows summed."""
    safe, valid = _slots(table, sr.rows)
    mask = _col(valid, sr.values).to(table.dtype)
    return table.index_put((safe,), -lr * sr.values * mask, accumulate=True)


def apply_adagrad(table: torch.Tensor, moment: torch.Tensor, sr: SelectedRows, lr,
                  epsilon: float = 1e-6):
    """Row-wise Adagrad (sparse.py:99): the rows merged, then for each
    touched row ``m += g²`` and ``p −= lr·g / (√m + eps)``. Returns (new
    table, new moment); untouched rows keep their values and moments."""
    sr = merge_selected_rows(sr)
    safe, valid = _slots(table, sr.rows)
    g = sr.values * _col(valid, sr.values).to(table.dtype)
    m_rows = moment[safe] + g * g
    upd = lr * g / (torch.sqrt(m_rows) + epsilon)
    return (table.index_put((safe,), -upd, accumulate=True),
            _set_rows(moment, safe, valid, m_rows))


def apply_adam_lazy(table: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                    sr: SelectedRows, lr, t, beta1: float = 0.9, beta2: float = 0.999,
                    epsilon: float = 1e-8):
    """Lazy-mode Adam (sparse.py:110; adam_op lazy_mode): the moments move
    only on touched rows, bias-corrected at step ``t + 1`` (``t`` an int
    or a 0-d tensor). Returns (new table, new m1, new m2)."""
    sr = merge_selected_rows(sr)
    safe, valid = _slots(table, sr.rows)
    mask = _col(valid, sr.values).to(table.dtype)
    g = sr.values * mask
    m1_rows = beta1 * m1[safe] + (1 - beta1) * g
    m2_rows = beta2 * m2[safe] + (1 - beta2) * g * g
    tf = (torch.full((), float(t), dtype=torch.float32, device=table.device)
          if isinstance(t, (int, float)) else t.to(device=table.device, dtype=torch.float32))
    tf = tf + 1.0
    lr_t = lr * torch.sqrt(1 - torch.pow(beta2, tf)) / (1 - torch.pow(beta1, tf))
    upd = lr_t * m1_rows / (torch.sqrt(m2_rows) + epsilon) * mask
    return (table.index_put((safe,), -upd, accumulate=True),
            _set_rows(m1, safe, valid, m1_rows), _set_rows(m2, safe, valid, m2_rows))


def sharded_embedding_lookup(table, ids, mesh, axis: str = "ep",
                             batch_axes=("dp", "fsdp")):
    """A lookup into a table row-sharded over a mesh axis (sparse.py:131,
    the distributed lookup table): ``table`` [vocab, d] is a DTensor
    sharded on dim 0 over ``axis`` (or a full tensor, which each rank
    slices to its rows), ``ids`` [...] are replicated over ``axis`` (a
    DTensor with its batch shard, or a plain tensor). Each rank gathers
    the ids that fall in its rows, zeros elsewhere, and one sum over the
    axis merges them (the reduction of a ``Partial`` DTensor). Returns a
    DTensor [..., d] with the ids' batch shard, differentiable in the
    table's local rows. Without the axis (or at size 1) it is a plain
    lookup."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from .ops import _dtensor as _dt

    if axis not in mesh.axis_names or mesh.shape[axis] == 1:
        t = table.full_tensor() if _dt.is_dtensor(table) else table
        i = ids.full_tensor() if _dt.is_dtensor(ids) else ids
        return t[i.long()]
    n = mesh.shape[axis]
    vocab = table.shape[0]
    enforce(vocab % n == 0, f"sharded_embedding_lookup: vocab {vocab} does not split "
                            f"over {axis}={n}")
    shard = vocab // n
    ax = mesh.dim(axis)
    if _dt.is_dtensor(ids):
        ipl = [Replicate() if d == ax else (pl if isinstance(pl, Shard) and pl.dim == 0
                                            else Replicate())
               for d, pl in enumerate(ids.placements)]
        loc_ids = ids.redistribute(placements=ipl).to_local()
    else:
        ipl = [Replicate()] * len(mesh.axis_names)
        loc_ids = ids
    if _dt.is_dtensor(table):
        enforce(isinstance(table.placements[ax], Shard) and table.placements[ax].dim == 0,
                f"sharded_embedding_lookup: the table must be sharded on dim 0 over "
                f"{axis!r}, it is {table.placements}")
        tpl = [Shard(0) if d == ax else Replicate() for d in range(len(mesh.axis_names))]
        # the local rows' grad sums over the batch shards this rank saw
        gpl = [Shard(0) if d == ax else (Partial() if isinstance(ipl[d], Shard)
                                         else Replicate())
               for d in range(len(mesh.axis_names))]
        tbl = table.redistribute(placements=tpl).to_local(grad_placements=gpl)
    else:
        k = mesh.coord(axis)
        tbl = table[k * shard:(k + 1) * shard]
    lo = mesh.coord(axis) * shard
    local = loc_ids.long() - lo
    hit = (local >= 0) & (local < shard)
    vals = tbl[local.clamp(0, shard - 1)]
    vals = torch.where(hit[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                         device=vals.device))
    opl = [Partial() if d == ax else pl for d, pl in enumerate(ipl)]
    out = DTensor.from_local(vals, mesh.device_mesh, opl, run_check=False)
    return out.redistribute(placements=[Replicate() if d == ax else pl
                                        for d, pl in enumerate(opl)])


__all__ = ["SelectedRows", "apply_adagrad", "apply_adam_lazy", "apply_sgd",
           "lookup_rowwise_grad", "merge_selected_rows", "sharded_embedding_lookup"]
