"""Checkpoints, inference export and the Predictor (counterpart of
``paddle_tpu.io``).

Persistable state is name-keyed dicts of tensors, one ``.npz`` per
collection (``params.npz``, ``state.npz``, ``opt_state.npz``) plus
``meta.json``, under the JAX package's key mangling: nested keys joined by
``||``, bfloat16 stored as its uint16 bit pattern under an ``@bfloat16``
suffix. Every leaf goes through that encoding, so each package loads the
other's files. ``save_trainer`` and ``save_inference_model`` commit
atomically: everything is written to a ``<dirname>.tmp.<pid>`` sibling,
fsynced, covered by a ``resilience.write_manifest`` manifest (per-file
CRC32 and size, the flat shape/dtype spec of each collection) and renamed
into place; the loaders validate the manifest and raise
:class:`~paddle_tpu_torch.resilience.CheckpointCorrupt` on a torn or
bit-flipped directory. Loaded leaves are CPU tensors, copied out of the
npz reader.

A trainer's loss-scale state rides in the meta (``loss_scale_state``) and
is restored across config drift with the JAX package's warnings.

An inference artifact records its program instead of an exported graph: a
``build`` Program by the import path of its function
(``paddle_tpu_torch.models.mnist:mlp``), or of the factory that made it
with the factory's arguments (a function with ``factory_spec``, as
``models.resnet.make_model`` and ``models.gpt.make_generator`` return),
with its layout and compute dtype. The loader rebuilds the program from
there; an artifact of the GPT generator from before it was a ``build``
program records a ``builder`` instead and raises
:class:`ArtifactOutdated`, which says to export it again. Not carried yet, each raising
:class:`NotYetPorted`: an exported graph per bucket (``torch.export``
cannot trace a kernel called through ctypes; ROADMAP queue 1, item 9) and
``save_train_artifact`` (item 27).

Sharded checkpoints (:func:`save_sharded`, :func:`load_sharded`,
:func:`wait_for_checkpoints`, :func:`save_trainer_sharded`,
:func:`load_trainer_sharded`) are ``torch.distributed.checkpoint``'s
where the JAX package's are orbax's: each rank writes its own shards,
optionally from a background thread, and a restore re-places them at the
target's placements. The two formats do not cross: neither package reads
the other's sharded checkpoints, and the npz ``save_trainer`` directories
stay the format they exchange.

A trainer on a mesh saves unsharded, as the JAX package does: every rank
takes part in gathering the full tensors and rank 0 writes them, so the
checkpoint moves between meshes and between the packages. The exception
is ``DistStrategy(zero_sharding=True)`` (io.py:21-25): params and the
partitioned optimizer leaves go to per-shard ``*.zero{i}.npz`` files (one
``(k,)`` row each), with the shard count and the logical flat spec in
``meta.zero``. A restore at the same shard layout reads each rank's own
shard files only; any other layout change is gated (``ReshardError``
unless ``allow_reshard``), and :func:`load_persistables` gathers the rows
back to logical tensors.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import shutil
import threading
import warnings
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import resilience
from .core.dtypes import dtype_name
from .core.errors import EnforceError, NotYetPorted, enforce
from .core.place import default_device
from .resilience import CheckpointCorrupt

SEP = "||"  # path separator for nested keys (param names use '/')
TMP_MARKER = resilience.TMP_MARKER
_COLLECTIONS = {"params": "params.npz", "state": "state.npz", "opt_state": "opt_state.npz"}


def _log():
    return logging.getLogger("paddle_tpu_torch.io")


class ArtifactOutdated(EnforceError):
    """An inference artifact in a format this package no longer loads;
    the message says how to export it again."""


class InvalidRequest(EnforceError, ValueError):
    """A serving/inference feed failed structural validation: missing or
    extra feed key, shape or dtype mismatch, off-bucket batch size, or a
    non-finite payload. Carries ``field`` (the offending feed name) and
    ``reason``."""

    def __init__(self, field: str, reason: str):
        super().__init__(f"invalid request: feed {field!r} {reason}")
        self.field = field
        self.reason = reason


# npz cannot store bfloat16: it is saved as its uint16 bit pattern under
# a "@bfloat16" key suffix, the JAX package's encoding
_EXOTIC_DTYPES = {"bfloat16": np.uint16}

# the JAX package runs with 64-bit types off: an int64/float64 feed is
# taken as its 32-bit canonical type
_CANONICAL = {np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32),
              np.dtype(np.float64): np.dtype(np.float32),
              np.dtype(np.complex128): np.dtype(np.complex64)}


def _canonical_dtype(dtype: np.dtype) -> np.dtype:
    dtype = np.dtype(dtype)
    return _CANONICAL.get(dtype, dtype)


# -- flat dict <-> npz -------------------------------------------------------


def _mangle_key(prefix: str, dtype_name_: str) -> Tuple[str, np.dtype]:
    """(npz member name, stored dtype) of a leaf of logical dtype
    ``dtype_name_`` (``paddle_tpu.io._mangle_key``'s rule)."""
    if dtype_name_ in _EXOTIC_DTYPES:
        return f"{prefix}@{dtype_name_}", np.dtype(_EXOTIC_DTYPES[dtype_name_])
    stored = np.dtype(dtype_name_)
    if (prefix.endswith("@raw")
            or any(prefix.endswith(f"@{dt}") and stored == enc
                   for dt, enc in _EXOTIC_DTYPES.items())):
        # an integer param literally named 'x@bfloat16' (or 'x@raw') is
        # escaped so load strips exactly one suffix
        return f"{prefix}@raw", stored
    return prefix, stored


def _logical_dtype(t) -> str:
    if isinstance(t, torch.Tensor):
        return dtype_name(t.dtype)
    return np.asarray(t).dtype.name


def _to_numpy(t) -> np.ndarray:
    """The storable numpy array of a tensor/array (bfloat16 as uint16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    elif tree is not None:
        out[_mangle_key(prefix, _logical_dtype(tree))[0]] = _to_numpy(tree)
    return out


def flat_spec(tree: Any, prefix: str = "") -> Dict[str, Dict[str, Any]]:
    """The flat ``{npz key: {"shape": [...], "dtype": "..."}}`` spec
    :func:`save_persistables` would record for ``tree``, from shapes and
    dtypes only (no device-to-host copy), through the same key mangling."""
    out: Dict[str, Dict[str, Any]] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_spec(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    elif tree is not None:
        shape = tree.shape if hasattr(tree, "shape") else np.asarray(tree).shape
        key, stored = _mangle_key(prefix, _logical_dtype(tree))
        out[key] = {"shape": list(shape), "dtype": str(stored)}
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """npz members -> nested dict of CPU tensors (bfloat16 restored), each
    a copy owning its memory."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        t = None
        if "@" in key:
            maybe_key, _, dtname = key.rpartition("@")
            if dtname == "raw":
                key = maybe_key
            elif dtname in _EXOTIC_DTYPES and v.dtype == _EXOTIC_DTYPES[dtname]:
                key = maybe_key
                t = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        if t is None:
            t = torch.from_numpy(np.array(v))
        parts = key.split(SEP)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = t
    return out


def _spec_of(flat: Dict[str, np.ndarray]) -> Dict[str, Dict[str, Any]]:
    return {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in flat.items()}


# -- persistables ------------------------------------------------------------


def save_persistables(dirname: str, params: Dict[str, Any],
                      state: Optional[Dict[str, Any]] = None,
                      opt_state: Optional[Dict[str, Any]] = None,
                      meta: Optional[Dict[str, Any]] = None) -> Dict[str, Dict[str, Any]]:
    """Save the persistable collections (save_persistables analog): tensors
    (on any device) or numpy arrays. Returns the flat shape/dtype spec per
    npz file, which ``save_trainer`` records in the manifest."""
    os.makedirs(dirname, exist_ok=True)
    spec: Dict[str, Dict[str, Any]] = {}
    for name, tree in (("params.npz", params), ("state.npz", state),
                       ("opt_state.npz", opt_state)):
        if tree is None and name != "params.npz":
            continue
        flat = _flatten(tree)
        np.savez(os.path.join(dirname, name), **flat)
        spec[name] = _spec_of(flat)
    with open(os.path.join(dirname, "meta.json"), "w") as f:
        json.dump(meta or {}, f)
    return spec


def _load_collection(dirname: str, name: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(dirname, name)
    if not os.path.exists(p):
        return None
    with np.load(p, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def _merge_nested(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge_nested(dst[k], v)
        else:
            dst[k] = v
    return dst


def _load_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: np.array(z[k]) for k in z.files}


def _gather_zero_collection(dirname: str, stem: str,
                            zero_meta: Dict[str, Any]) -> Dict[str, Any]:
    """A ZeRO checkpoint's per-shard ``(k,)`` rows concatenated back into
    logical leaves (io.py:290, the host-side gather); {} when the
    collection has no partitioned leaves."""
    n = int(zero_meta["shards"])
    spec = (zero_meta.get("arrays") or {}).get(f"{stem}.npz") or {}
    paths = [os.path.join(dirname, f"{stem}.zero{i}.npz") for i in range(n)]
    if not any(os.path.exists(p) for p in paths):
        return {}
    missing = [os.path.basename(p) for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"ZeRO checkpoint is missing shard files {missing[:3]} "
                                f"({len(missing)} of {n})")
    flats = [_load_flat(p) for p in paths]
    flat: Dict[str, np.ndarray] = {}
    for key in flats[0]:
        ent = spec.get(key)
        if ent is None:
            raise KeyError(f"{stem} shard member {key!r} is absent from the "
                           "checkpoint's meta.zero.arrays spec")
        shape = tuple(ent["shape"])
        size = int(np.prod(shape)) if shape else 1
        flat[key] = np.concatenate([f[key] for f in flats])[:size].reshape(shape)
    return _unflatten(flat)


def load_persistables(dirname: str) -> Tuple[Dict[str, Any], Dict[str, Any],
                                             Optional[Dict[str, Any]], Dict[str, Any]]:
    """Load (params, state, opt_state, meta) as CPU tensors
    (load_persistables analog). A ZeRO checkpoint (``meta.zero``) is
    gathered back to logical tensors."""
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(dirname, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    zero = meta.get("zero")
    if zero:
        params = _gather_zero_collection(dirname, "params", zero)
        state = _load_collection(dirname, "state.npz") or {}
        opt_state = _load_collection(dirname, "opt_state.npz")
        opart = _gather_zero_collection(dirname, "opt_state", zero)
        if opart:
            opt_state = _merge_nested(opt_state if opt_state is not None else {}, opart)
    else:
        params = _load_collection(dirname, "params.npz") or {}
        state = _load_collection(dirname, "state.npz") or {}
        opt_state = _load_collection(dirname, "opt_state.npz")
    if opt_state is not None:
        # a stateless optimizer's empty "global"/"accums" flatten to nothing
        opt_state.setdefault("global", {})
        opt_state.setdefault("accums", {})
    return params, state, opt_state, meta


def _fsync_tree(dirname: str) -> None:
    """fsync every regular file in ``dirname`` and the directory: the
    rename commits only what has reached the disk."""
    for name in os.listdir(dirname):
        p = os.path.join(dirname, name)
        if not os.path.isfile(p):
            continue
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
        except OSError:
            pass  # fs without fsync support: best effort
        finally:
            os.close(fd)
    _fsync_dir(dirname)


def _fsync_dir(dirname: str) -> None:
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_trainer(dirname: str, trainer, extra_meta: Optional[Dict[str, Any]] = None) -> None:
    """Checkpoint a Trainer: params, state, optimizer state and step
    (CheckpointConfig/save_checkpoint analog).

    Atomic and validated: the collections go to a ``<dirname>.tmp.<pid>``
    sibling, are fsynced, covered by ``manifest.json`` and renamed into
    place. A crash at any point (the ``save_trainer:*`` crash points)
    leaves the previous committed checkpoint or the new one, never a torn
    directory that :func:`load_trainer` trusts. ``extra_meta`` rides in
    the meta (``fit`` stores epoch/epoch_step there)."""
    meta = {"global_step": trainer.global_step,
            # the mesh the checkpoint was written at: {} on one device, so
            # a restore onto a mesh trips the reshard gate
            "mesh_axes": resilience.trainer_mesh_axes(trainer) or {}}
    ls = trainer.scope.loss_scale_state
    if ls:
        meta["loss_scale_state"] = {k: float(_full(v)) for k, v in ls.items()}
    zero = getattr(trainer, "_zero", None)
    if zero is not None:
        meta["zero_axes"] = dict(zero.axes_dict)
        meta["zero"] = {"shards": zero.n, "axes": dict(zero.axes_dict), "arrays": zero.arrays}
    if extra_meta:
        meta.update(extra_meta)
    mesh = getattr(trainer, "mesh", None)
    params, state, opt_state = trainer.scope.params, trainer.scope.state, \
        trainer.scope.opt_state
    if mesh is not None:
        # every rank gathers (the DTensors' full tensors, ZeRO's (N, k)
        # rows); rank 0 writes, and the others wait for it at the end
        import torch.distributed as dist
        params, state, opt_state = (_full_tree(t) for t in (params, state, opt_state))
        # checkpoints store logical layer order: the interleaved pipeline's
        # rest layout is undone (io.py:452-455; no-op otherwise)
        params, opt_state = trainer.stacked_to_logical(params, opt_state)
        if dist.get_rank() != 0:
            dist.barrier()
            return
    path = os.path.abspath(dirname)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    # a prior process's torn save of this tag leaves <tag>.tmp.<pid>
    resilience.sweep_tmp_dirs(parent, tag=os.path.basename(path))
    tmp = f"{path}{TMP_MARKER}{os.getpid()}"
    if zero is not None:
        spec = _save_zero_persistables(tmp, zero, params, state, opt_state, meta)
    else:
        spec = save_persistables(tmp, params, state, opt_state, meta=meta)
    resilience.crash_point("save_trainer:files-written")
    _fsync_tree(tmp)
    resilience.write_manifest(tmp, meta=meta, arrays=spec)
    resilience.crash_point("save_trainer:manifest-written")
    if os.path.isdir(path):
        # an overwritten tag vanishes before the rename (a rename onto a
        # non-empty directory fails); older tags stay for the scanner
        shutil.rmtree(path)
    os.rename(tmp, path)
    _fsync_dir(parent)
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _full_tree(tree):
    """A tree's DTensors as full tensors (collective: every rank calls it)."""
    if isinstance(tree, dict):
        return {k: _full_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _full(tree.detach())
    return tree


def _zero_split_flat(tree: Any, n: int, partitioned) -> Tuple[List[Dict[str, np.ndarray]],
                                                              Dict[str, np.ndarray]]:
    """A ZeRO tree (its partitioned leaves as full (N, k) rows) split into
    n per-shard flat dicts, one ``(k,)`` row a leaf, and one flat dict of
    the replicated leaves (io.py:213)."""
    shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(n)]
    base: Dict[str, np.ndarray] = {}
    for mkey, leaf in _flatten_leaves(tree):
        if mkey not in partitioned:
            base[mkey] = _to_numpy(leaf)
            continue
        rows = _to_numpy(leaf)
        for i in range(n):
            shards[i][mkey] = rows[i]
    return shards, base


def _flatten_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(npz member name, leaf) of every leaf of a tree."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flatten_leaves(v, f"{prefix}{SEP}{k}" if prefix else str(k))]
    if tree is None:
        return []
    return [(_mangle_key(prefix, _logical_dtype(tree))[0], tree)]


def _save_zero_persistables(dirname: str, zero, params, state, opt_state,
                            meta) -> Dict[str, Dict[str, Any]]:
    """The ZeRO form of :func:`save_persistables` (io.py:249): params and
    the partitioned optimizer leaves in ``params.zero{i}.npz`` /
    ``opt_state.zero{i}.npz``, the replicated optimizer leaves in
    ``opt_state.npz``. Returns the spec of the files written."""
    os.makedirs(dirname, exist_ok=True)
    spec: Dict[str, Dict[str, Any]] = {}

    def write(name, flat):
        np.savez(os.path.join(dirname, name), **flat)
        spec[name] = _spec_of(flat)

    pshards, pbase = _zero_split_flat(params, zero.n, zero.partitioned["params.npz"])
    enforce(not pbase, "zero_sharding partitions every param leaf")
    for i, flat in enumerate(pshards):
        write(f"params.zero{i}.npz", flat)
    if state is not None:
        write("state.npz", _flatten(state))
    if opt_state is not None:
        oshards, obase = _zero_split_flat(opt_state, zero.n,
                                          zero.partitioned["opt_state.npz"])
        write("opt_state.npz", obase)
        if oshards[0]:
            for i, flat in enumerate(oshards):
                write(f"opt_state.zero{i}.npz", flat)
    with open(os.path.join(dirname, "meta.json"), "w") as f:
        json.dump(meta or {}, f)
    return spec


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def load_trainer(dirname: str, trainer, allow_reshard: bool = False) -> None:
    """Restore a Trainer in place onto its device or mesh.

    The directory is validated against its manifest first (CRC32 per
    file, format version); a mismatch, or an npz that fails to parse,
    raises :class:`CheckpointCorrupt`. Pre-manifest (legacy) directories
    load without validation. A checkpoint recorded at other mesh axes than
    the trainer's (a single device: none), or at another ZeRO shard
    layout, raises :class:`~paddle_tpu_torch.resilience.ReshardError`
    unless ``allow_reshard`` (io.py:486-554); its text names the remedy,
    ``resilience.reshard_restore`` or ``fit(resume=True, elastic=True)``,
    which prove the new layout feasible first. A started trainer's params
    must match the checkpoint's names, shapes and dtypes.

    The trainer's params become fresh tensors on its device (DTensors on
    its mesh, placed as ``startup`` places them), with ``requires_grad``
    as ``startup`` sets it. A ZeRO checkpoint restored at the same shard
    layout reads only this rank's shard files (bit for bit the rows that
    were saved); any other restore reads the logical tensors
    (:func:`load_persistables`) and places them."""
    tz = getattr(trainer, "_zero", None)
    if not allow_reshard:
        man = resilience.read_manifest(dirname)  # None for legacy
        saved = ((man or {}).get("meta") or {})
        saved_axes = saved.get("mesh_axes")
        target_axes = resilience.trainer_mesh_axes(trainer)
        if saved_axes is not None and resilience.normalize_mesh_axes(saved_axes) \
                != resilience.normalize_mesh_axes(target_axes):
            raise resilience.ReshardError(
                dirname, saved_axes, target_axes,
                f"checkpoint was saved at mesh axes {saved_axes} but the target "
                f"trainer runs {target_axes or 'a single device'} — restoring "
                "across a mesh change is an elastic reshard; use "
                "resilience.reshard_restore(checkpoint_dir, trainer) or "
                "fit(resume=True, elastic=True) (or load_trainer("
                "allow_reshard=True) to skip the feasibility check)")
        target_zero = dict(tz.axes_dict) if tz is not None else {}
        if man is not None and resilience.normalize_mesh_axes(saved.get("zero_axes")) \
                != resilience.normalize_mesh_axes(target_zero):
            raise resilience.ReshardError(
                dirname, saved_axes, target_axes,
                f"checkpoint zero_sharding axes {saved.get('zero_axes') or None} differ "
                f"from the target trainer's {target_zero or None} — restoring across a "
                "ZeRO shard-layout change is an elastic reshard (gather-then-repartition); "
                "use resilience.reshard_restore(checkpoint_dir, trainer) or "
                "fit(resume=True, elastic=True) (or load_trainer(allow_reshard=True) to "
                "skip the feasibility check)")
    manifest = resilience.validate_checkpoint(dirname)  # None for legacy
    zero_meta = ((manifest or {}).get("meta") or {}).get("zero")
    if zero_meta is None:
        meta_path = os.path.join(dirname, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                zero_meta = json.load(f).get("zero")
    if (tz is not None and zero_meta and int(zero_meta.get("shards", 0)) == tz.n
            and resilience.normalize_mesh_axes(zero_meta.get("axes") or {})
            == resilience.normalize_mesh_axes(tz.axes_dict)):
        _load_zero_shard_local(dirname, trainer, zero_meta)
        return
    try:
        params, state, opt_state, meta = load_persistables(dirname)
    except Exception as e:
        raise CheckpointCorrupt(
            dirname, f"unreadable collection: {type(e).__name__}: {e}") from e
    if not params:
        raise CheckpointCorrupt(dirname, "no parameters found (params.npz missing or empty)")
    if manifest and not zero_meta:
        _check_arrays_spec(manifest, dirname, params=params, state=state,
                           opt_state=opt_state)
    _check_trainer_param_drift(dirname, trainer, params)
    dev = trainer.device
    if opt_state is not None:
        # a stateless optimizer's per-param accums are empty dicts, which
        # flatten to nothing on save
        for k in params:
            opt_state["accums"].setdefault(k, {})
        opt_state = _to_device(opt_state, dev)
        opt_state["step"] = opt_state["step"].to(torch.int32)
    params = {k: v.to(dev) for k, v in params.items()}
    state = _to_device(state, dev)
    # a trainer running the interleaved pipeline layout re-permutes the
    # logical rows on the way in (io.py:591-594; no-op otherwise)
    if getattr(trainer, "_pp_perm", None):
        params, opt_state = trainer.stacked_from_logical(params, opt_state)
    if getattr(trainer, "mesh", None) is not None:
        params, state, opt_state = trainer._mesh_placement(params, state, opt_state)
    trainer.scope.params = {k: v.requires_grad_(v.is_floating_point())
                            for k, v in params.items()}
    trainer.scope.state = state
    trainer.scope.opt_state = opt_state
    _finish_restore(dirname, trainer, meta)


def _finish_restore(dirname: str, trainer, meta: Dict[str, Any]) -> None:
    trainer._fused = None  # a captured step reads the state it replaced
    trainer.global_step = int(meta.get("global_step", 0))
    # fit(resume=True) reads epoch/epoch_step from here
    trainer._last_loaded_meta = dict(meta)
    _restore_loss_scale(trainer, meta, dirname)


def _load_zero_shard_local(dirname: str, trainer, zero_meta: Dict[str, Any]) -> None:
    """Same-layout ZeRO restore (io.py:541): this rank reads its own
    ``*.zero{i}.npz`` rows and the replicated leaves; no gather."""
    from .parallel import api as par_api
    from .parallel.zero import _rows

    tz, mesh, dev = trainer._zero, trainer.mesh, trainer.device
    i = mesh.axes_coord(tz.axes)
    with open(os.path.join(dirname, "meta.json")) as f:
        meta = json.load(f)
    try:
        prow = _unflatten(_load_flat(os.path.join(dirname, f"params.zero{i}.npz")))
        state = _load_collection(dirname, "state.npz") or {}
        base = _load_collection(dirname, "opt_state.npz")
        opath = os.path.join(dirname, f"opt_state.zero{i}.npz")
        orow = _unflatten(_load_flat(opath)) if os.path.exists(opath) else {}
    except Exception as e:
        raise CheckpointCorrupt(
            dirname, f"unreadable ZeRO shard {i}: {type(e).__name__}: {e}") from e
    params = {k: _rows(mesh, tz, v.to(dev)[None]).requires_grad_(v.is_floating_point())
              for k, v in prow.items()}
    enforce(set(params) == set(tz.shapes),
            f"ZeRO checkpoint {dirname!r}: shard {i} holds params {sorted(params)[:3]}..., "
            f"the trainer {sorted(tz.shapes)[:3]}...")

    def place(tree, rows):
        if isinstance(tree, dict):
            return {k: place(v, rows) for k, v in tree.items()}
        t = tree.to(dev)
        return _rows(mesh, tz, t[None]) if rows else par_api.replicate(mesh, t)

    opt_state = None
    if base is not None or orow:
        opt_state = _merge_nested(place(base or {}, False), place(orow, True))
        opt_state.setdefault("global", {})
        opt_state.setdefault("accums", {})
        for k in params:
            opt_state["accums"].setdefault(k, {})
        opt_state["step"] = par_api.replicate(mesh, opt_state["step"].to_local().to(torch.int32))
    trainer.scope.params = params
    trainer.scope.state = {k: par_api.replicate(mesh, v.to(dev)) for k, v in state.items()}
    trainer.scope.opt_state = opt_state
    _finish_restore(dirname, trainer, meta)


def _restore_loss_scale(trainer, meta: Dict[str, Any], dirname: str) -> None:
    """The loss-scale state across drift between the checkpoint and the
    trainer (io.py:800): a checkpoint without it restored into a
    scaler-running trainer (or the other way round), or with fields
    missing, warns and falls back to the scaler's initial values."""
    ls_meta = meta.get("loss_scale_state")
    if trainer.loss_scaler is None:
        if ls_meta:
            warnings.warn(
                f"checkpoint {dirname!r} carries loss_scale_state but the trainer "
                "has no loss scaler — ignoring it (configure DistStrategy.loss_scale "
                "to adopt it)")
        return
    init = trainer.loss_scaler.init_state()
    if not ls_meta:
        warnings.warn(
            f"checkpoint {dirname!r} has no loss_scale_state but the trainer runs a "
            "loss scaler — falling back to the scaler's initial state (scale will "
            "re-calibrate)")
        ls_meta = {}
    missing = {"scale", "good_steps", "overflows"} - set(ls_meta)
    if ls_meta and missing:
        warnings.warn(
            f"checkpoint {dirname!r} loss_scale_state is missing {sorted(missing)} — "
            "those fields fall back to the scaler's initial values")
    dev = trainer.device
    ls = {"scale": torch.tensor(float(ls_meta.get("scale", float(init["scale"]))),
                                dtype=torch.float32, device=dev),
          "good_steps": torch.tensor(int(ls_meta.get("good_steps", int(init["good_steps"]))),
                                     dtype=torch.int32, device=dev),
          "overflows": torch.tensor(int(ls_meta.get("overflows", int(init["overflows"]))),
                                    dtype=torch.int32, device=dev)}
    if getattr(trainer, "mesh", None) is not None:
        from .parallel.api import replicate
        ls = {k: replicate(trainer.mesh, v) for k, v in ls.items()}
    trainer.scope.loss_scale_state = ls


def _check_trainer_param_drift(dirname: str, trainer, params) -> None:
    """Raise :class:`CheckpointCorrupt` when a started trainer's params
    and the checkpoint's differ in names, shapes or dtypes (the model
    config drifted since the save), instead of failing inside the next
    step or training the wrong thing."""
    have = trainer.scope.params
    if not have:
        return
    tz = getattr(trainer, "_zero", None)
    want = dict(tz.arrays["params.npz"]) if tz is not None else flat_spec(have)
    got = flat_spec(params)
    if set(want) != set(got):
        missing = sorted(set(want) - set(got))[:3]
        extra = sorted(set(got) - set(want))[:3]
        raise CheckpointCorrupt(
            dirname, f"checkpoint params diverge from the trainer's (missing: "
            f"{missing}, unexpected: {extra}) — the model config drifted since "
            "this checkpoint was written")
    drift = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if drift:
        k, (g, w) = sorted(drift.items())[0]
        raise CheckpointCorrupt(
            dirname, f"checkpoint param {k!r} is {g} but the trainer expects {w} "
            f"({len(drift)} drifted entr{'y' if len(drift) == 1 else 'ies'} total) "
            "— the model config drifted since this checkpoint was written")


def _check_arrays_spec(manifest: Dict[str, Any], dirname: str, **collections) -> None:
    """Hold the loaded collections to the manifest's flat shape/dtype spec
    (CRC32 vouches for the bytes, this for the decoded structure)."""
    spec = manifest.get("arrays") or {}
    for coll, tree in collections.items():
        fname = _COLLECTIONS[coll]
        want = spec.get(fname)
        if want is None or tree is None:
            continue
        got = flat_spec(tree)
        if set(got) != set(want):
            missing = sorted(set(want) - set(got))[:3]
            extra = sorted(set(got) - set(want))[:3]
            raise CheckpointCorrupt(
                dirname, f"{fname} members diverge from manifest (missing: "
                f"{missing}, unexpected: {extra})")
        for k, w in want.items():
            if got[k] != w:
                raise CheckpointCorrupt(
                    dirname, f"{fname}:{k} is {got[k]} on disk but the manifest "
                    f"records {w}")


def save_params(dirname: str, params, state=None, opt_state=None):
    """save_params analog: the params (with state/opt_state when given)."""
    save_persistables(dirname, params, state or {}, opt_state)


def save_vars(dirname: str, vars: Dict[str, Any], filename=None):
    """save_vars analog: an arbitrary name→tensor dict."""
    save_persistables(dirname, dict(vars), {}, None)


def load_params(dirname: str):
    """load_params analog: the parameter dict (CPU tensors)."""
    return load_persistables(dirname)[0]


def load_vars(dirname: str):
    """load_vars analog."""
    return load_persistables(dirname)[0]


# -- sharded checkpoints (io.py:1479-1596) -----------------------------------
# The JAX package writes these with orbax; here torch.distributed.checkpoint
# (DCP) writes them: each rank writes the shards it holds, and a restore
# reads, for each target tensor, the pieces of its own placement. The
# future of the async save in flight is kept here until
# wait_for_checkpoints() (or the next sharded save or load) waits on it.

_pending_save = None
# (default process group, the CPU-backed group DCP coordinates over)
_ckpt_group: Optional[Tuple[Any, Any]] = None


def _ckpt_process_group():
    """The process group DCP coordinates a sharded save or load over: None
    without a world (DCP then runs in one process), else a gloo group over
    the world of its own, made once per world. DCP moves its plans and
    metadata (pickled, on the host) through it, from the writing thread of
    an async save too, so it must not be the group the training steps'
    collectives use (their order would interleave and deadlock), and DCP's
    async save refuses a group without a CPU backend. No tensor of the
    training state passes through it."""
    import torch.distributed as dist

    global _ckpt_group
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.group.WORLD
    if _ckpt_group is None or _ckpt_group[0] is not world:
        _ckpt_group = (world, dist.new_group(backend="gloo"))
    return _ckpt_group[1]


def _snapshot(tree):
    """A copy of every tensor leaf (a DTensor stays a DTensor, its shard
    copied), so the steps that follow an async save, which write the
    training state in place, cannot reach what the save writes."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def save_sharded(dirname: str, tree: Dict[str, Any], async_save: bool = False):
    """Save a tree of tensors (DTensors on a mesh: each rank writes its own
    shards) with ``torch.distributed.checkpoint``. The directory is
    replaced. With ``async_save`` the tensors are copied first (on their
    device; DCP then stages the copies to host memory) and the call returns
    while a thread writes the files: :func:`wait_for_checkpoints` (or the
    next sharded save or load) waits for it, and raises its error. Returns
    the write's future (async) or DCP's metadata. On a mesh every rank
    calls it.

    The files are DCP's ``.distcp`` and ``.metadata``, not orbax's: neither
    package reads the other's sharded checkpoints. ``save_trainer``'s npz
    directories are the format the two packages exchange."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    global _pending_save
    wait_for_checkpoints()  # an async save in flight may still own the dir
    path = os.path.abspath(dirname)
    pg = _ckpt_process_group()
    if pg is None or dist.get_rank() == 0:
        shutil.rmtree(path, ignore_errors=True)
    if pg is not None:
        dist.barrier(group=pg)
    if not async_save:
        return dcp.save(tree, checkpoint_id=path, process_group=pg)
    fut = dcp.async_save(_snapshot(tree), checkpoint_id=path, process_group=pg)
    # a newer DCP answers with its staging and upload futures
    _pending_save = getattr(fut, "upload_completion", fut)
    return _pending_save


def wait_for_checkpoints() -> None:
    """Wait for the async sharded save in flight, if any, and raise its
    error if it failed."""
    global _pending_save
    fut, _pending_save = _pending_save, None
    if fut is not None:
        fut.result()


def _tree_from_metadata(path: str, device: torch.device) -> Dict[str, Any]:
    """An empty tree of the checkpoint's structure: each tensor at its
    saved shape and dtype on ``device``, each other value None. The key
    paths come from the planner's record, so a key holding '.' keeps its
    place."""
    import torch.distributed.checkpoint as dcp

    md = dcp.FileSystemReader(path).read_metadata()
    paths = md.planner_data or {}
    out: Dict[str, Any] = {}
    for fqn, ent in md.state_dict_metadata.items():
        keys = paths.get(fqn)
        enforce(keys is not None, f"sharded checkpoint {path!r}: entry {fqn!r} has no "
                "key path in its metadata")
        d = out
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = (torch.empty(tuple(ent.size), dtype=ent.properties.dtype,
                                   device=device)
                       if isinstance(ent, dcp.TensorStorageMetadata) else None)
    return out


def load_sharded(dirname: str, target: Optional[Dict[str, Any]] = None, device=None):
    """Restore a :func:`save_sharded` checkpoint into ``target`` in place
    and return it. ``target`` is a tree of tensors at the saved shapes:
    DTensors are filled at their own placements, whatever placements the
    checkpoint was written at (the restore across a mesh reshape). Without
    a target the tree is built from the checkpoint's metadata, its tensors
    on ``device`` (default: the card; no card: ``NoCudaDevice``). On a mesh
    every rank calls it."""
    import torch.distributed.checkpoint as dcp

    wait_for_checkpoints()  # an async save in flight may still own the dir
    path = os.path.abspath(dirname)
    if target is None:
        target = _tree_from_metadata(path, default_device(device, "io.load_sharded"))
    dcp.load(target, checkpoint_id=path, process_group=_ckpt_process_group())
    return target


def save_trainer_sharded(dirname: str, trainer, async_save: bool = True):
    """A Trainer's params, state, optimizer state and ``meta.global_step``
    (and its loss-scale state, with a scaler) through :func:`save_sharded`,
    async by default; stacked rows in logical layer order, as
    ``save_trainer`` stores them."""
    with torch.no_grad(), trainer._mesh_scope():
        params, opt_state = trainer.stacked_to_logical(trainer.scope.params,
                                                       trainer.scope.opt_state or {})
    tree = {"params": params, "state": trainer.scope.state, "opt_state": opt_state,
            "meta": {"global_step": trainer.global_step}}
    if trainer.scope.loss_scale_state:
        tree["loss_scale_state"] = trainer.scope.loss_scale_state
    return save_sharded(dirname, tree, async_save=async_save)


def _empty_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _empty_like_tree(v) for k, v in tree.items()}
    return torch.empty_like(tree)


def load_trainer_sharded(dirname: str, trainer) -> None:
    """Restore a :func:`save_trainer_sharded` checkpoint into the trainer at
    its own mesh and placements (across a mesh reshape too). The tensors
    are read into new buffers first and copied into the trainer's own once
    all of them are read. A checkpoint's loss-scale state is read when it
    has one, and adopted only by a trainer that runs a loss scaler."""
    import torch.distributed.checkpoint as dcp

    wait_for_checkpoints()
    md = dcp.FileSystemReader(os.path.abspath(dirname)).read_metadata()
    saved = {keys[0] for keys in (md.planner_data or {}).values()}
    scope = trainer.scope
    target = {"params": _empty_like_tree(scope.params), "state": _empty_like_tree(scope.state),
              "opt_state": _empty_like_tree(scope.opt_state or {}),
              "meta": {"global_step": 0}}
    if "loss_scale_state" in saved:
        ls = scope.loss_scale_state
        target["loss_scale_state"] = _empty_like_tree(ls) if ls else {
            "scale": torch.zeros((), dtype=torch.float32, device=trainer.device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=trainer.device),
            "overflows": torch.zeros((), dtype=torch.int32, device=trainer.device)}
    restored = load_sharded(dirname, target)
    from .executor import write_in_place
    with torch.no_grad(), trainer._mesh_scope():
        params, opt_state = trainer.stacked_from_logical(restored["params"],
                                                         restored["opt_state"])
        write_in_place(scope.params, params)
        write_in_place(scope.state, restored["state"])
        if scope.opt_state is not None:
            write_in_place(scope.opt_state, opt_state)
        # a trainer without a scaler has no state for it to adopt into
        if "loss_scale_state" in restored and trainer.loss_scaler is not None:
            write_in_place(scope.loss_scale_state, restored["loss_scale_state"])
    trainer.global_step = int(restored["meta"]["global_step"])
    trainer._fused = None  # a captured step reads the state it replaced


# -- inference model ---------------------------------------------------------


def _recover_renamed_aside(path: str) -> None:
    """A save that died between moving the old artifact aside and
    committing the new one leaves the only good copy at
    ``<path>.tmp.<pid>.old``: put it back before the tmp sweep, whose
    ``<tag>.tmp.*`` pattern would delete it."""
    if os.path.isdir(path):
        return
    parent = os.path.dirname(path) or "."
    olds = [p for p in (os.path.join(parent, n) for n in os.listdir(parent))
            if p.startswith(f"{path}{TMP_MARKER}") and p.endswith(".old")
            and os.path.isdir(p)]
    if olds:
        newest = max(olds, key=os.path.getmtime)
        os.rename(newest, path)
        _log().warning("recovered artifact %s from interrupted overwrite (%s)",
                       path, os.path.basename(newest))


def _infer_batch_info(example_feed: Dict[str, Any]) -> Tuple[int, List[str]]:
    """(batch_size, batched feed names): the batch is the leading dim of
    the first (sorted) non-scalar feed; every feed sharing it is batched."""
    batch = 0
    for k in sorted(example_feed):
        v = np.asarray(example_feed[k])
        if v.ndim >= 1:
            batch = int(v.shape[0])
            break
    batched = [k for k in sorted(example_feed)
               if np.asarray(example_feed[k]).ndim >= 1
               and np.asarray(example_feed[k]).shape[0] == batch]
    return batch, batched


def _resize_batch(v: np.ndarray, n: int) -> np.ndarray:
    """A feed at another bucket size: sliced down or tiled up along dim 0
    (the server's warm-up and canary feeds)."""
    if v.shape[0] >= n:
        return np.ascontiguousarray(v[:n])
    reps = -(-n // v.shape[0])  # ceil
    return np.ascontiguousarray(np.concatenate([v] * reps, axis=0)[:n])


def _resolve(path: str):
    """The object at import path ``module:qualname``."""
    module, _, qualname = path.partition(":")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _program_spec(program) -> Dict[str, Any]:
    """How to rebuild a ``build`` Program: its function's import path (or
    its ``factory_spec``: a factory's import path and arguments), its
    name, its layout, and the compute dtype and ``quantize.int8_serving``
    switch in force at export (the JAX package bakes both into the
    exported graph; here the loaded program runs under them again)."""
    from .framework import compute_dtype
    from .quantize import in_int8_serving

    fn = program.fn
    factory = getattr(fn, "factory_spec", None)
    if factory is not None:
        _resolve(factory["factory"])  # importable, or the export fails now
        return {"program_factory": factory["factory"],
                "program_kwargs": dict(factory["kwargs"]), "name": program.name,
                "layout": program.layout, "compute_dtype": dtype_name(compute_dtype()),
                "int8_serving": in_int8_serving()}
    path = f"{getattr(fn, '__module__', None)}:{getattr(fn, '__qualname__', '')}"
    try:
        found = _resolve(path)
    except (ImportError, AttributeError):
        found = None
    enforce(found is fn,
            f"save_inference_model: the program's function {path!r} cannot be "
            "imported back by that path (a lambda or a nested function?): define "
            "it at module level")
    return {"program": path, "name": program.name, "layout": program.layout,
            "compute_dtype": dtype_name(compute_dtype()), "int8_serving": in_int8_serving()}


class _ProgramRunner:
    """A ``build`` Program bound to its loaded weights:
    ``runner(**feed) -> outputs``, through
    ``Program.apply(training=False)`` under the export's compute dtype and
    its int8 switch (an artifact saved before the switch was recorded
    serves in float)."""

    def __init__(self, program, params, state, device: torch.device, compute_dtype: str,
                 int8: bool = False):
        self.program = program
        self.params = _to_device(params, device)
        self.state = _to_device(state, device)
        self.device = device
        self.compute_dtype = compute_dtype
        self.int8 = bool(int8)

    @property
    def max_signatures(self) -> int:
        """The program function's bound on the call signatures it keeps
        state for (``transformer.make_decoder``'s captured decodes); an
        AttributeError when it keeps none, so a :class:`Predictor` leaves
        it alone."""
        return self.program.fn.max_signatures

    @max_signatures.setter
    def max_signatures(self, n: int) -> None:
        self.program.fn.max_signatures = n

    def __call__(self, **feed):
        from .framework import amp_guard
        from .quantize import int8_serving

        with amp_guard(self.compute_dtype), int8_serving(self.int8):
            out, _ = self.program.apply(self.params, self.state, training=False,
                                        place=self.device, **feed)
        return out


def save_inference_model(dirname: str, program, params: Dict[str, Any],
                         state: Dict[str, Any], example_feed: Dict[str, Any],
                         batch_buckets: Optional[Sequence[int]] = None) -> None:
    """Export the ``build`` Program ``program`` with its weights as an
    inference artifact (its function must be importable by path, or carry
    a ``factory_spec``, as ``models.gpt.make_generator``'s does).
    ``batch_buckets`` adds batch sizes the :class:`Predictor` serves
    besides the example feed's own.

    The commit is atomic and validated as ``save_trainer``'s, with
    ``{"kind": "inference_model"}`` as the manifest's meta; overwriting
    moves the committed artifact aside first, so a crash inside the
    two-rename window leaves it recoverable."""
    from .framework import Program

    enforce(isinstance(program, Program),
            f"save_inference_model: expected a build Program, got "
            f"{type(program).__name__} (build(models.gpt.make_generator(...)) for GPT)")
    spec = _program_spec(program)
    feed_names = sorted(example_feed)
    batch, batched_feeds = _infer_batch_info(example_feed)
    buckets = sorted(set(int(b) for b in (batch_buckets or [])) | {batch})
    enforce(all(b > 0 for b in buckets), f"batch_buckets must be positive, got {buckets}")
    inputs = []
    for k in feed_names:
        v = np.asarray(example_feed[k])
        inputs.append({"source": "feed", "name": k, "shape": list(v.shape),
                       "dtype": _canonical_dtype(v.dtype).name})
    meta = {"feed_names": feed_names, "inputs": inputs, "batch_size": batch,
            "batched_feeds": batched_feeds, "batch_buckets": buckets, **spec}

    path = os.path.abspath(dirname)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    _recover_renamed_aside(path)
    resilience.sweep_tmp_dirs(parent, tag=os.path.basename(path))
    tmp = f"{path}{TMP_MARKER}{os.getpid()}"
    os.makedirs(tmp)
    arrays = {}
    for name, tree in (("params.npz", params), ("state.npz", state or {})):
        flat = _flatten(tree)
        np.savez(os.path.join(tmp, name), **flat)
        arrays[name] = _spec_of(flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    resilience.crash_point("save_inference_model:files-written")
    _fsync_tree(tmp)
    resilience.write_manifest(tmp, meta={"kind": "inference_model"}, arrays=arrays)
    resilience.crash_point("save_inference_model:manifest-written")
    old = None
    if os.path.isdir(path):
        old = f"{path}{TMP_MARKER}{os.getpid()}.old"
        os.rename(path, old)
        resilience.crash_point("save_inference_model:committing")
    os.rename(tmp, path)
    _fsync_dir(parent)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def load_inference_model(dirname: str, device=None) -> "Predictor":
    """Validate the artifact in ``dirname`` against its manifest (a torn
    or bit-flipped one raises :class:`CheckpointCorrupt`; a legacy one
    without a manifest loads unvalidated), rebuild its program, load its
    weights onto ``device`` (the CUDA card by default) and run every
    bucket once."""
    dev = default_device(device, "load_inference_model")
    manifest = resilience.validate_checkpoint(dirname)
    meta = read_artifact_meta(dirname)["meta"]
    try:
        params, state, _, _ = load_persistables(dirname)
        feeds = artifact_feed_spec(meta)
    except NotYetPorted:
        raise
    except Exception as e:
        raise CheckpointCorrupt(
            dirname, f"unreadable artifact: {type(e).__name__}: {e}") from e
    if manifest:
        _check_arrays_spec(manifest, dirname, params=params, state=state)
    if "builder" in meta:
        raise ArtifactOutdated(
            f"load_inference_model: {dirname!r} records the builder "
            f"{meta['builder']!r}, an artifact of the GPT generator from before it "
            "became a build program; re-export it (fleet.decode.export_decoder, or "
            "save_inference_model(build(models.gpt.make_generator(...)), ...))")
    enforce("program" in meta or "program_factory" in meta,
            f"load_inference_model: {dirname!r} records no program this port can rebuild")
    from .framework import build

    fn = (_resolve(meta["program"]) if "program" in meta
          else _resolve(meta["program_factory"])(**meta["program_kwargs"]))
    program = build(fn, name=meta["name"])
    program.layout = meta["layout"]
    program = _ProgramRunner(program, params, state, dev, meta["compute_dtype"],
                             int8=meta.get("int8_serving", False))
    return Predictor(program, meta["feed_names"],
                     {k: {"shape": list(s), "dtype": d.name} for k, (s, d) in feeds.items()},
                     batch_size=meta["batch_size"], batched_feeds=meta["batched_feeds"],
                     batch_buckets=meta["batch_buckets"])


def read_artifact_meta(dirname: str) -> Dict[str, Any]:
    """The static metadata of a ``save_inference_model`` artifact: its
    parsed ``meta.json`` and its manifest (read without the CRC pass). No
    weights are read and nothing runs. Raises :class:`CheckpointCorrupt`
    for a directory that is not a readable artifact. (The JAX package
    also reports its per-bucket StableHLO files; the port exports none.)"""
    if not os.path.isdir(dirname):
        raise CheckpointCorrupt(dirname, "not a directory")
    mpath = os.path.join(dirname, "meta.json")
    if not os.path.exists(mpath):
        raise CheckpointCorrupt(dirname, "no meta.json (not a save_inference_model "
                                "artifact)")
    try:
        with open(mpath) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(dirname, f"unreadable meta.json: {e}") from e
    return {"path": dirname, "meta": meta, "manifest": resilience.read_manifest(dirname)}


def artifact_feed_spec(meta: Dict[str, Any],
                       batch: Optional[int] = None) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """``{feed name: (shape, numpy dtype)}`` at bucket ``batch`` (default:
    the export's own batch size), from an artifact's ``meta.json`` alone:
    the spec :meth:`Predictor.feed_spec` gives."""
    feeds = {e["name"]: e for e in meta.get("inputs", []) if e.get("source") == "feed"}
    enforce(set(feeds) == set(meta.get("feed_names", [])),
            f"artifact meta is inconsistent: inputs name feeds {sorted(feeds)} but "
            f"feed_names is {meta.get('feed_names')}")
    batch = int(meta["batch_size"]) if batch is None else int(batch)
    batched = set(meta.get("batched_feeds", []))
    out = {}
    for k, e in feeds.items():
        shape = tuple(int(d) for d in e["shape"])
        if k in batched:
            shape = (batch,) + shape[1:]
        out[k] = (shape, np.dtype(str(e["dtype"])))
    return out


def artifact_fingerprint(dirname: str) -> Tuple[Dict[str, Any], str]:
    """(manifest, token) of a committed artifact: the token is
    ``<basename>-<crc32:08x>`` over the sorted ``name:crc:size`` lines of
    the manifest's file table, so two hosts can agree an artifact is the
    same without moving its bytes."""
    path = os.path.abspath(dirname)
    man = resilience.read_manifest(path)
    enforce(man is not None, f"artifact_fingerprint: {dirname!r} has no manifest — "
            "only committed save_inference_model dirs can be distributed")
    lines = "\n".join(f"{name}:{spec['crc32']}:{spec['size']}"
                      for name, spec in sorted(man["files"].items()))
    crc = zlib.crc32(lines.encode()) & 0xFFFFFFFF
    return man, f"{os.path.basename(path)}-{crc:08x}"


def save_train_artifact(dirname: str, trainer, example_feed: Dict[str, Any]) -> None:
    raise NotYetPorted("save_train_artifact: the native trainer's step artifact "
                       "comes with ROADMAP queue 1, item 27")


# process-wide count of what a Predictor prepares for a call signature:
# each bucket's warm-up run and each CUDA graph a captured decode captures
_aot_compiles = 0
_aot_lock = threading.Lock()


def aot_compile_count() -> int:
    """How many program preparations this process has made: one for each
    bucket a :class:`Predictor` warms at construction (the JAX package
    AOT-compiles each bucket there) and one for each CUDA graph a captured
    decode captures (``_captured_decode.StaticDecode``: the GPT generator's
    and the Transformer decoder's decode step, once per call signature).
    XLA's AOT compiles have no exact analog here: an eager call that meets
    a new shape prepares nothing countable, so the count moves only where
    the port does prepare. A warmed server's requests must leave it flat
    (``PredictorServer.report()["compiles_since_warmup"]`` stays 0); a
    capture on a request's path (a signature evicted and met again) moves
    it."""
    return _aot_compiles


def _count_compile() -> None:
    global _aot_compiles
    with _aot_lock:
        _aot_compiles += 1


class Predictor:
    """Loaded inference model: ``run(feed) -> outputs`` (tensors on the
    program's device); ``clone()`` is free (the program and its weights
    are shared and stateless across calls).

    ``run`` validates the feed first — a missing/extra key or a
    shape/dtype mismatch raises a typed :class:`InvalidRequest` naming
    the offending field — and dispatches only exact bucket sizes
    (padding ragged batches up to a bucket is the server's job).
    Construction runs every bucket once, the port's stand-in for the
    JAX package's AOT compile."""

    def __init__(self, program, feed_names: Sequence[str],
                 feeds: Dict[str, Dict[str, Any]], batch_size: int,
                 batched_feeds: Sequence[str], batch_buckets: Sequence[int],
                 warmup: bool = True):
        self._program = program
        self.feed_names = list(feed_names)
        self._feeds = {k: (tuple(v["shape"]), np.dtype(v["dtype"]))
                       for k, v in feeds.items()}
        self.batch_size = int(batch_size)
        self.batched_feeds = frozenset(batched_feeds)
        self._buckets = sorted(int(b) for b in batch_buckets)
        if hasattr(program, "max_signatures"):
            # a program that keeps state per input shape (the GPT generator's
            # captured decode steps) keeps it for every bucket
            program.max_signatures = max(program.max_signatures, len(self._buckets))
        if warmup:
            for b in self._buckets:
                _block_on(self.run({k: np.zeros(shape, dtype) for k, (shape, dtype)
                                    in self.feed_spec(b).items()}))
                _count_compile()

    @property
    def program(self):
        return self._program

    @property
    def device(self) -> torch.device:
        return self._program.device

    @property
    def batch_buckets(self) -> List[int]:
        """Served batch sizes, ascending."""
        return list(self._buckets)

    def feed_spec(self, batch: Optional[int] = None) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        """{feed name: (shape, numpy dtype)} at bucket ``batch`` (default:
        the export's own batch size)."""
        batch = self.batch_size if batch is None else int(batch)
        out = {}
        for k, (shape, dtype) in self._feeds.items():
            if k in self.batched_feeds:
                shape = (batch,) + shape[1:]
            out[k] = (shape, dtype)
        return out

    def validate_feed(self, feed: Dict[str, Any],
                      allow_padding: bool = False) -> Tuple[int, int]:
        """Structural request validation. Returns ``(n, bucket)`` — the
        request's batch size and the bucket that serves it (``n ==
        bucket`` unless ``allow_padding``, where the smallest bucket >= n
        is chosen). Raises :class:`InvalidRequest` naming the offending
        field for missing/extra keys, shape or dtype mismatches, and
        off-bucket batch sizes."""
        for k in self.feed_names:
            if k not in feed:
                raise InvalidRequest(k, "is missing from the feed "
                                     f"(expected keys: {self.feed_names})")
        for k in sorted(feed):
            if k not in self._feeds:
                raise InvalidRequest(
                    k, "is not a feed of this model "
                    f"(expected keys: {self.feed_names})")
        buckets = self.batch_buckets
        first_batched = (sorted(self.batched_feeds)[0] if self.batched_feeds
                         else self.feed_names[0])
        n = None
        arrs = {k: np.asarray(feed[k]) for k in self.feed_names}
        for k in self.feed_names:
            if k not in self.batched_feeds:
                continue
            v = arrs[k]
            if v.ndim < 1:
                raise InvalidRequest(k, "must be batched (got a scalar)")
            if n is None:
                n = int(v.shape[0])
            elif int(v.shape[0]) != n:
                raise InvalidRequest(
                    k, f"batch dim {v.shape[0]} disagrees with the "
                    f"request's batch size {n}")
        if n is None:
            n = self.batch_size
        if n == 0:
            raise InvalidRequest(first_batched, "has an empty batch")
        if allow_padding:
            fits = [b for b in buckets if b >= n]
            if not fits:
                raise InvalidRequest(
                    first_batched, f"batch size {n} exceeds the largest "
                    f"precompiled bucket (buckets: {buckets})")
            bucket = fits[0]
        else:
            if n not in buckets:
                raise InvalidRequest(
                    first_batched, f"batch size {n} is not a precompiled "
                    f"bucket (buckets: {buckets})")
            bucket = n
        spec = self.feed_spec(n)
        for k in self.feed_names:
            v = arrs[k]
            want_shape, want_dtype = spec[k]
            if tuple(v.shape) != want_shape:
                raise InvalidRequest(
                    k, f"has shape {tuple(v.shape)}, expected {want_shape}")
            if v.dtype != want_dtype and _canonical_dtype(v.dtype) != want_dtype:
                raise InvalidRequest(
                    k, f"has dtype {v.dtype}, expected {want_dtype}")
        return n, bucket

    def run(self, feed: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        self.validate_feed(feed, allow_padding=False)
        spec = self.feed_spec()
        dev = self.device
        vals = {k: torch.from_numpy(np.ascontiguousarray(
                    np.asarray(feed[k]).astype(spec[k][1], copy=False))).to(dev)
                for k in self.feed_names}
        with torch.inference_mode():
            return self._program(**vals)

    def clone(self) -> "Predictor":
        """A predictor over the same program and weights (no warmup)."""
        return Predictor(self._program, self.feed_names,
                         {k: {"shape": list(s), "dtype": d.name}
                          for k, (s, d) in self._feeds.items()},
                         self.batch_size, self.batched_feeds, self._buckets,
                         warmup=False)


def _block_on(out) -> None:
    """Wait until the device has produced ``out`` (the JAX
    ``block_until_ready`` analog): an event recorded on this thread's
    current stream, where the call that made ``out`` ran, and waited on.
    Not a device-wide sync: a serving thread must not wait on, or
    disturb, a CUDA graph another thread is capturing meanwhile (a
    sibling replica's warm-up, a reload's candidate)."""
    values = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else [out])
    for v in values:
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(v.device))
            done.synchronize()
            return


__all__ = ["ArtifactOutdated", "InvalidRequest", "Predictor", "aot_compile_count",
           "artifact_feed_spec", "artifact_fingerprint",
           "flat_spec", "load_inference_model", "load_params", "load_persistables",
           "load_trainer", "load_vars", "read_artifact_meta", "save_inference_model",
           "save_params", "save_persistables", "save_train_artifact", "save_trainer",
           "save_vars"]
