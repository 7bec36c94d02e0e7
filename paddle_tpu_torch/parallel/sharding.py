"""Sharding rules: name pattern → partition spec (counterpart of
``paddle_tpu.parallel.sharding``).

A :class:`ShardingRules` maps parameter-name regexes to partition specs,
with the JAX package's resolution (``spec_for``, ``adapted_to``, the
drop warnings) and presets (:func:`replicated`, :func:`fsdp`,
:func:`transformer_tp_rules`). Where the JAX package hands a spec to
``NamedSharding``, the port turns it into DTensor placements
(:func:`placements`): tensor dim ``i`` naming mesh axis ``a`` is
``Shard(i)`` on mesh dim ``a``; every other mesh dim is ``Replicate()``. A
dim split over axes listed out of the mesh's order takes DTensor's strided
shard, so the first axis of the entry stays major.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, Optional, Sequence, Tuple, Union

from . import mesh as mesh_lib


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec`` analog: one entry per tensor dim,
    each None, an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec
SpecLike = Union[PartitionSpec, Tuple, None]

CANONICAL_AXES = frozenset((mesh_lib.DP, mesh_lib.FSDP, mesh_lib.TP,
                            mesh_lib.SP, mesh_lib.PP, mesh_lib.EP))


class ShardingRules:
    """Ordered (regex → spec) table for parameters, plus the batch-axis
    spec for inputs (sharding.py:27). ``seq_axis`` opts feeds' dim 1 into
    sharding over that axis (the input side of sequence parallelism)."""

    def __init__(self, rules: Optional[Sequence[Tuple[str, SpecLike]]] = None,
                 default: SpecLike = None,
                 batch_axes: Optional[Sequence[str]] = None,
                 seq_axis: Optional[str] = None):
        self.rules = [(re.compile(pat), _as_spec(spec)) for pat, spec in (rules or [])]
        self.default = _as_spec(default)
        self.batch_axes = tuple(batch_axes) if batch_axes is not None else None
        self.seq_axis = seq_axis

    def adapted_to(self, mesh) -> "ShardingRules":
        """A copy with the axes ``mesh`` lacks removed from every spec: the
        way to run a preset table on a smaller mesh. Dropping a canonical
        axis is silent; a non-canonical one warns (a typo). Memoised per
        mesh axis set."""
        names = tuple(mesh.axis_names)
        if getattr(self, "_adapted_for", None) == names:
            return self
        cache = self.__dict__.setdefault("_adapted_cache", {})
        if names in cache:
            return cache[names]
        nameset = set(names)

        def adapt(spec: PartitionSpec) -> PartitionSpec:
            out = []
            for entry in spec:
                keep, dropped = _filter_axes(entry, nameset)
                for a in dropped:
                    if a not in CANONICAL_AXES:
                        _warn_drop(("adapt-typo", a),
                                   f"adapted_to: rule axis {a!r} is neither in the "
                                   f"mesh {names} nor a canonical axis name "
                                   f"{sorted(CANONICAL_AXES)} — likely a typo; "
                                   f"that dim will be replicated")
                out.append(keep)
            return PartitionSpec(*out)

        adapted = ShardingRules.__new__(type(self))
        adapted.__dict__.update(self.__dict__)
        adapted.rules = [(pat, adapt(spec)) for pat, spec in self.rules]
        adapted.default = adapt(self.default)
        if self.batch_axes is not None:
            adapted.batch_axes = tuple(a for a in self.batch_axes if a in nameset)
        if self.seq_axis is not None and self.seq_axis not in nameset:
            adapted.seq_axis = None
        adapted.__dict__["_adapted_for"] = names
        adapted.__dict__["_adapted_cache"] = {}
        cache[names] = adapted
        return adapted

    def spec_for(self, name: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
        for pat, spec in self.rules:
            if pat.search(name):
                return _validate(spec, shape, mesh, name)
        return _validate(self.default, shape, mesh, name)

    def batch_spec(self, mesh, ndim: int,
                   shape: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
        axes = self.batch_axes if self.batch_axes is not None else mesh_lib.data_axis_names(mesh)
        axes = tuple(a for a in axes if a in mesh.axis_names and mesh.shape[a] > 1)
        # dim 1 shards only on feeds that look like sequences: a [b, 1]
        # label or a [b, c, h, w] image must not be sharded on 'sp'
        seq = None
        if (self.seq_axis in mesh.axis_names
                and mesh.shape.get(self.seq_axis, 1) > 1
                and shape is not None and len(shape) >= 2
                and shape[1] > 1 and shape[1] % mesh.shape[self.seq_axis] == 0):
            seq = self.seq_axis
        if not axes and seq is None:
            return PartitionSpec()
        lead = axes if len(axes) > 1 else (axes[0] if axes else None)
        rest = [seq] + [None] * (ndim - 2) if ndim >= 2 else []
        return PartitionSpec(lead, *rest)

    def shard_params(self, mesh, params: Dict[str, "torch.Tensor"]) -> Dict[str, "torch.Tensor"]:
        """Each param as a DTensor placed by its spec (from the full tensor
        every rank holds)."""
        from torch.distributed.tensor import distribute_tensor

        return {k: distribute_tensor(v.detach(), mesh.device_mesh,
                                     placements(self.spec_for(k, tuple(v.shape), mesh), mesh))
                for k, v in params.items()}


def _as_spec(spec: SpecLike) -> PartitionSpec:
    if spec is None:
        return PartitionSpec()
    if isinstance(spec, PartitionSpec):
        return spec
    return PartitionSpec(*spec)


def _filter_axes(entry, nameset):
    """One spec entry split into (kept entry, dropped axes) by mesh
    membership (sharding.py:155)."""
    if entry is None:
        return None, ()
    axes = entry if isinstance(entry, tuple) else (entry,)
    keep = tuple(a for a in axes if a in nameset)
    dropped = tuple(a for a in axes if a not in nameset)
    return (keep if len(keep) > 1 else (keep[0] if keep else None)), dropped


class ShardingRuleWarning(UserWarning):
    """A sharding rule degraded (an axis dropped, a dim not divisible):
    silently replicated params are the classic mis-sharding failure."""


# warn_explicit's registry: once per distinct message, honouring the
# ambient filters, re-armed by reset_drop_warnings()
_DROP_REGISTRY: dict = {}

# the rule key's kind -> the finding's code when a report collects the drop
_DROP_CODES = {
    "missing": "sharding:unknown-axis",
    "adapt-typo": "sharding:unknown-axis",
    "divide": "sharding:indivisible",
    "rank": "sharding:rank-mismatch",
}


def reset_drop_warnings():
    """Re-arm the once-per-key drop warnings (test helper)."""
    _DROP_REGISTRY.clear()


def _warn_drop(key: tuple, msg: str) -> None:
    """One rule degradation (sharding.py:187): a finding of the active
    ``analysis.report.LintReport`` when a check installed one
    (``analysis.report.collect_into``), else warned once per message."""
    from ..analysis import report as _lint

    rep = _lint.active_report()
    if rep is not None:
        rep.add(_DROP_CODES.get(key[0], "sharding:dropped-axis"), "warning", msg,
                where=str(key[1]) if len(key) > 1 else "")
        return
    warnings.warn_explicit(msg, ShardingRuleWarning, __file__, 0,
                           module=__name__, registry=_DROP_REGISTRY)


def _validate(spec: PartitionSpec, shape: Tuple[int, ...], mesh, name: str) -> PartitionSpec:
    """Drop the axes that do not divide the dim or are not in the mesh,
    each drop warned once (sharding.py:203; dropping a size-1 axis is a
    no-op and does not warn)."""
    nameset = set(mesh.axis_names)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        kept, dropped = _filter_axes(entry, nameset)
        for a in dropped:
            _warn_drop(("missing", a, tuple(mesh.shape.items())),
                       f"sharding rule names axis {a!r} which is not in the "
                       f"mesh {dict(mesh.shape)}; replicating that dim "
                       f"(warned once per axis and mesh shape)")
        keep = [] if kept is None else list(kept if isinstance(kept, tuple) else (kept,))
        size = 1
        for a in keep:
            size *= mesh.shape[a]
        if i >= len(shape):
            if keep and size > 1:
                _warn_drop(("rank", name, i),
                           f"sharding rule for {name!r} has more entries than the "
                           f"param rank {len(shape)}; extra axes {keep} dropped")
            out.append(None)
        elif not keep:
            out.append(None)
        elif shape[i] % size != 0:
            if size > 1:
                _warn_drop(("divide", name, i),
                           f"sharding rule for {name!r}: dim {i} of shape {shape} "
                           f"is not divisible by mesh axes {keep} (size {size}); "
                           f"replicating that dim")
            out.append(None)
        else:
            out.append(kept)
    return PartitionSpec(*out[:len(shape)])


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of a (validated) spec on ``mesh``: ``Shard(i)``
    on mesh dim ``a`` where tensor dim ``i`` names axis ``a``, else
    ``Replicate()``. A dim split over several axes is split with the first
    axis of the entry major, as ``NamedSharding`` splits it: a plain
    ``Shard`` on each mesh dim when the entry lists its axes in mesh order,
    else a ``_StridedShard`` on each mesh dim that a later mesh dim of the
    entry must precede (its ``split_factor`` the product of those axes'
    sizes), so ``P(("fsdp", "dp"))`` on a ``(dp, fsdp)`` mesh shards with
    fsdp major."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    out = [Replicate() for _ in mesh.axis_names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for k, a in enumerate(axes):
            d = mesh.dim(a)
            sf = 1
            for b in axes[:k]:
                if mesh.dim(b) > d:
                    sf *= mesh.shape[b]
            out[d] = Shard(i) if sf == 1 else _StridedShard(i, split_factor=sf)
    return out


def spec_of(placements_, mesh, ndim: int) -> PartitionSpec:
    """The spec a DTensor's placements stand for (the inverse of
    :func:`placements` for Shard, strided Shard and Replicate
    placements)."""
    import itertools

    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    entries = [[] for _ in range(ndim)]
    for a, pl in zip(mesh.axis_names, placements_):
        if isinstance(pl, (Shard, _StridedShard)):
            entries[pl.dim].append(a)
    out = []
    for i, axes in enumerate(entries):
        if len(axes) > 1:
            # the order of the axes whose placements these are
            want = [placements_[mesh.dim(a)] for a in axes]
            for order in itertools.permutations(axes):
                pl = placements(PartitionSpec(*([None] * i), tuple(order)), mesh)
                if [pl[mesh.dim(a)] for a in axes] == want:
                    axes = list(order)
                    break
        out.append(None if not axes else (axes[0] if len(axes) == 1 else tuple(axes)))
    return PartitionSpec(*out)


# Preset rule tables ---------------------------------------------------------

def replicated() -> ShardingRules:
    """Pure DP: params replicated, grads all-reduced (kAllReduce)."""
    return ShardingRules([], default=PartitionSpec())


def fsdp(min_size_to_shard: int = 1024) -> ShardingRules:
    """Shard every parameter's largest divisible dim over 'fsdp' (the
    kReduce / param-slicing analog, ZeRO-3-like)."""
    return _FsdpRules(min_size_to_shard)


class _FsdpRules(ShardingRules):
    def __init__(self, min_size_to_shard: int):
        super().__init__([], default=PartitionSpec())
        self.min_size = min_size_to_shard

    def spec_for(self, name, shape, mesh):
        if mesh_lib.FSDP not in mesh.axis_names or not shape:
            return PartitionSpec()
        n = mesh.shape[mesh_lib.FSDP]
        size = 1
        for s in shape:
            size *= s
        if size < self.min_size:
            return PartitionSpec()
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % n == 0:
                spec = [None] * len(shape)
                spec[i] = mesh_lib.FSDP
                return PartitionSpec(*spec)
        return PartitionSpec()


def transformer_tp_rules(extra: Sequence[Tuple[str, SpecLike]] = ()) -> ShardingRules:
    """Megatron-style TP rules for the built-in transformer/BERT/GPT
    models (sharding.py:287), the same name table: stacked-block params
    (``_stack/``) with the layer dim over ``pp`` and the Megatron dims
    over ``tp``; fused projections with ``tp`` on the last axis."""
    P_ = PartitionSpec
    rules = [
        (r".*_stack/(qkv|xkv)/w$", P_("pp", None, None, "tp")),
        (r".*_stack/(qkv|xkv)/b$", P_("pp", None, "tp")),
        (r".*_stack/(out|xout)/w$", P_("pp", "tp", None)),
        (r".*_stack/(ffn_in|xq)/w$", P_("pp", None, "tp")),
        (r".*_stack/(ffn_in|xq)/b$", P_("pp", "tp")),
        (r".*_stack/ffn_out/w$", P_("pp", "tp", None)),
        (r".*_stack/", P_("pp")),
    ] + [
        (r".*(qkv_proj|kv_proj)/w$", P_("fsdp", None, "tp")),
        (r".*(qkv_proj|kv_proj)/b$", P_(None, "tp")),
        (r".*(q_proj|k_proj|v_proj)/w$", P_("fsdp", "tp")),
        (r".*(q_proj|k_proj|v_proj)/b$", P_("tp")),
        (r".*out_proj/w$", P_("tp", "fsdp")),
        (r".*ffn_in/w$", P_("fsdp", "tp")),
        (r".*ffn_in/b$", P_("tp")),
        (r".*ffn_out/w$", P_("tp", "fsdp")),
        (r".*embedding.*/w$", P_("tp", None)),
        (r".*/w$", P_(None, "fsdp")),
    ] + list(extra)
    return ShardingRules(rules, default=PartitionSpec())


__all__ = ["CANONICAL_AXES", "P", "PartitionSpec", "ShardingRuleWarning", "ShardingRules",
           "fsdp", "placements", "replicated", "reset_drop_warnings", "spec_of",
           "transformer_tp_rules"]
