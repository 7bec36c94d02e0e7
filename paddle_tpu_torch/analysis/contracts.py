"""Cross-artifact contracts (counterpart of the ``ckpt:*`` half of
``paddle_tpu.analysis.contracts``): whether a checkpoint restores onto a
trainer and a target mesh, proved from metadata alone (the manifest's
flat shape/dtype spec and meta, ``io.flat_spec`` of the trainer's scope,
the rule table, a sample feed's shapes), with no CRC pass, no
deserialization and no device work.

- ``ckpt:*`` findings: missing or extra collections and entries, shape
  and dtype drift (``io.load_trainer`` raises ``CheckpointCorrupt``),
  loss-scale drift (the restore warns and falls back), a ZeRO layout
  change, and restoring at a different mesh: ``ckpt:mesh-reshard``
  (``resilience.reshard_restore`` restores it) or
  ``ckpt:reshard-infeasible`` (``reshard_restore`` raises
  ``ReshardError`` with the finding's own text), with a rule the target
  mesh cannot honour as ``ckpt:reshard-dropped-rule``;
- ``sharding:replicated-optstate`` (:mod:`.rules`).

Every finding's code, severity and message are the JAX package's, word
for word. The ``artifact:*`` half (serving artifacts against a trainer
or a live server, ``serving_spec``, ``check_reload_compat``) comes with
ROADMAP queue 1, item 25: ``check_artifacts(artifact_dir=...)`` and
``serving=`` raise ``NotYetPorted``.

A target ``mesh`` is read through its axis names and sizes only, so a
``parallel.mesh.AbstractMesh`` checks a layout no world is running.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.errors import NotYetPorted, enforce
from . import rules as _rules
from .report import LintReport, collect_into

_COLLECTIONS = ("params.npz", "state.npz", "opt_state.npz")
# params drift makes load_trainer raise CheckpointCorrupt (error); the
# other collections degrade at runtime (state rebuilt / scaler fallback
# warnings) so their drift reports at warning severity
_COLLECTION_SEVERITY = {"params.npz": "error", "state.npz": "warning",
                        "opt_state.npz": "warning"}


def _unmangle_key(key: str, recorded_dtype: Optional[str] = None) -> str:
    """Logical leaf name of a mangled npz member key — the inverse of
    ``io._mangle_key`` (strip one ``@raw`` escape or one exotic-dtype
    suffix whose recorded storage dtype matches the encoding)."""
    from ..io import _EXOTIC_DTYPES

    if "@" not in key:
        return key
    stem, _, suffix = key.rpartition("@")
    if suffix == "raw":
        return stem
    enc = _EXOTIC_DTYPES.get(suffix)
    if enc is not None and (recorded_dtype is None
                            or np.dtype(recorded_dtype) == np.dtype(enc)):
        return stem
    return key


def trainer_specs(trainer) -> Dict[str, Any]:
    """The trainer-side contract surface: the flat shape/dtype spec
    ``io.save_trainer`` would record for each collection (computed from
    shapes only — no device reads; an interleaved-pipeline row layout
    is a permutation, so the spec is layout-agnostic), plus loss-scaler
    presence and the mesh axes."""
    scope = trainer.scope
    enforce(getattr(scope, "params", None) is not None,
            "contracts.trainer_specs: call trainer.startup() first (the "
            "contract is the started scope's spec)")
    from .. import io as _io

    from .. import resilience

    tz = getattr(trainer, "_zero", None)
    if tz is not None:
        # a ZeRO trainer's live trees hold per-replica (1, k) shard rows;
        # its contract surface is the LOGICAL spec recorded at startup
        # (the same spec meta["zero"]["arrays"] pins in its checkpoints)
        arrays = {k: dict(v) for k, v in tz.arrays.items()}
    else:
        arrays = {"params.npz": _io.flat_spec(scope.params),
                  "state.npz": _io.flat_spec(scope.state or {})}
        if scope.opt_state is not None:
            arrays["opt_state.npz"] = _io.flat_spec(scope.opt_state)
    return {
        "arrays": arrays,
        "has_loss_scaler": getattr(trainer, "loss_scaler", None) is not None,
        "mesh_axes": resilience.trainer_mesh_axes(trainer),
        "zero_axes": dict(tz.axes_dict) if tz is not None else None,
    }


def _feed_shapes(sample_feed: Optional[Dict[str, Any]]) -> Dict[str, Tuple[int, ...]]:
    out = {}
    for k in sorted(sample_feed or {}):
        shape = getattr(sample_feed[k], "shape", None)
        if shape is None:
            try:
                shape = np.asarray(sample_feed[k]).shape
            except Exception:
                continue
        if shape:
            out[k] = tuple(int(d) for d in shape)
    return out


# --------------------------------------------------------------------------
# ckpt:* — checkpoint vs trainer/mesh
# --------------------------------------------------------------------------


def _manifest_logical_arrays(manifest: Dict[str, Any]) -> Dict[str, Any]:
    """The checkpoint's LOGICAL flat spec per collection. A plain
    checkpoint records it directly in ``manifest["arrays"]``; a ZeRO
    (shard-aware) checkpoint's manifest arrays are the real per-shard
    row files (``params.zero{i}.npz``), so the logical spec lives in
    ``meta["zero"]["arrays"]`` instead — that is what a trainer's
    contract surface compares against."""
    zero = (manifest.get("meta") or {}).get("zero")
    if zero:
        logical = dict(zero.get("arrays") or {})
        # the replicated remainder (step counters, non-param-shaped
        # accums) still lives in the base opt_state.npz spec; the
        # logical opt spec recorded under meta["zero"] already covers
        # the whole tree, so prefer it — but fall back to the base file
        # for collections the zero meta does not record
        for fname, spec in (manifest.get("arrays") or {}).items():
            logical.setdefault(fname, spec)
        return logical
    return manifest.get("arrays") or {}


def _check_zero(specs: Dict[str, Any], manifest: Dict[str, Any],
                report: LintReport) -> None:
    """ZeRO shard-layout agreement between a checkpoint and the trainer
    that would restore it. The runtime counterpart is the
    ``load_trainer`` gate that raises ``ReshardError`` on a layout
    change; statically the same comparison is the ``ckpt:zero-mismatch``
    finding (warning, not error — ``reshard_restore`` /
    ``fit(resume=True, elastic=True)`` recover via an explicit
    gather-then-repartition, so the restore is feasible, just not
    shard-local)."""
    from .. import resilience

    saved = (manifest.get("meta") or {}).get("zero_axes") or {}
    target = specs.get("zero_axes") or {}
    if resilience.normalize_mesh_axes(saved) == \
            resilience.normalize_mesh_axes(target):
        return
    if saved and not target:
        msg = (f"checkpoint is ZeRO-sharded over {dict(saved)} but the "
               "trainer runs with zero_sharding off — plain "
               "load_trainer raises ReshardError; restore via "
               "resilience.reshard_restore / fit(resume=True, "
               "elastic=True) (gathers the shard rows, full logical "
               "copy per device)")
    elif target and not saved:
        msg = (f"trainer shards its weight update over {dict(target)} "
               "(zero_sharding=True) but the checkpoint stores plain "
               "unsharded arrays — plain load_trainer raises "
               "ReshardError; reshard_restore / elastic fit repartition "
               "on load")
    else:
        msg = (f"checkpoint ZeRO layout {dict(saved)} != the trainer's "
               f"{dict(target)} — shard-local restore is impossible; "
               "reshard_restore / elastic fit fall back to "
               "gather-then-repartition (bytes reported)")
    report.add("ckpt:zero-mismatch", "warning", msg, where="meta.zero",
               got=dict(saved), expected=dict(target))


def _check_ckpt_arrays(specs: Dict[str, Any], manifest: Dict[str, Any],
                       report: LintReport) -> None:
    arrays = _manifest_logical_arrays(manifest)
    for fname in _COLLECTIONS:
        want = specs["arrays"].get(fname)
        got = arrays.get(fname)
        sev = _COLLECTION_SEVERITY[fname]
        if want is None and got is None:
            continue
        if got is None:
            if fname == "params.npz":
                report.add(
                    "ckpt:missing-collection", "error",
                    "checkpoint manifest records no params.npz spec — "
                    "load_trainer raises CheckpointCorrupt (no parameters "
                    "found) or the legacy path loads unvalidated",
                    where=fname)
            else:
                report.add(
                    "ckpt:missing-collection", "warning",
                    f"the trainer persists {fname} but the checkpoint "
                    f"manifest has no spec for it — that collection will "
                    "not restore (optimizer state/statistics restart "
                    "from scratch)",
                    where=fname)
            continue
        if want is None:
            report.add(
                "ckpt:extra-collection", "info",
                f"checkpoint carries {fname} but the trainer does not "
                "persist that collection (e.g. an optimizer-less "
                "evaluator restoring a training checkpoint) — it is "
                "ignored on load",
                where=fname)
            continue
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        for k in missing:
            report.add(
                "ckpt:missing-entry", sev,
                f"{fname} has no entry for {_unmangle_key(k)!r} "
                f"{tuple(want[k]['shape'])} — the trainer's model config "
                "gained this leaf since the checkpoint was written; "
                "load_trainer "
                + ("raises CheckpointCorrupt (params diverge)"
                   if sev == "error" else "restores it uninitialized"),
                where=f"{fname}:{k}", shape=list(want[k]["shape"]))
        for k in extra:
            report.add(
                "ckpt:extra-entry", sev,
                f"{fname} carries {_unmangle_key(k)!r} "
                f"{tuple(got[k]['shape'])} which the trainer's model no "
                "longer has — renamed or removed layer; load_trainer "
                + ("raises CheckpointCorrupt (params diverge)"
                   if sev == "error" else "drops it"),
                where=f"{fname}:{k}", shape=list(got[k]["shape"]))
        for k in sorted(set(want) & set(got)):
            w, g = want[k], got[k]
            if list(w["shape"]) != list(g["shape"]):
                report.add(
                    "ckpt:shape-drift", sev,
                    f"{fname}:{_unmangle_key(k)} is {tuple(g['shape'])} in "
                    f"the checkpoint but the trainer expects "
                    f"{tuple(w['shape'])} — "
                    + ("load_trainer raises CheckpointCorrupt naming the "
                       "drifted param" if sev == "error"
                       else "the restored value cannot feed the step"),
                    where=f"{fname}:{k}",
                    got=list(g["shape"]), expected=list(w["shape"]))
            elif str(w["dtype"]) != str(g["dtype"]):
                report.add(
                    "ckpt:dtype-drift", sev,
                    f"{fname}:{_unmangle_key(k)} is {g['dtype']} in the "
                    f"checkpoint but the trainer expects {w['dtype']}",
                    where=f"{fname}:{k}",
                    got=str(g["dtype"]), expected=str(w["dtype"]))


def _check_loss_scale(specs: Dict[str, Any], manifest: Dict[str, Any],
                      report: LintReport) -> None:
    ls_meta = (manifest.get("meta") or {}).get("loss_scale_state")
    if specs["has_loss_scaler"] and not ls_meta:
        report.add(
            "ckpt:loss-scale-drift", "warning",
            "the trainer runs a loss scaler but the checkpoint has no "
            "loss_scale_state — restore falls back to the scaler's "
            "initial state (scale re-calibrates; the first post-resume "
            "steps may overflow-skip)",
            where="loss_scale_state")
    elif ls_meta and not specs["has_loss_scaler"]:
        report.add(
            "ckpt:loss-scale-drift", "warning",
            "the checkpoint carries loss_scale_state but the trainer has "
            "no loss scaler — it is ignored on load (configure "
            "DistStrategy.loss_scale to adopt it)",
            where="loss_scale_state")
    elif ls_meta:
        missing = sorted({"scale", "good_steps", "overflows"} - set(ls_meta))
        if missing:
            report.add(
                "ckpt:loss-scale-drift", "warning",
                f"checkpoint loss_scale_state is missing {missing} — "
                "those fields fall back to the scaler's initial values",
                where="loss_scale_state")


def _check_reshard(manifest: Dict[str, Any], mesh, rules,
                   sample_feed: Optional[Dict[str, Any]],
                   report: LintReport) -> None:
    """Restore-at-a-different-mesh feasibility. Checkpoint arrays are
    stored unsharded (fully gathered) — except ZeRO checkpoints, whose
    per-shard row files gather back to the same logical arrays on any
    non-shard-local load — so a mesh change is a question
    about the *target* placement only: (a) every rule-sharded param dim
    must divide the target axes (a dropped rule silently replicates —
    HBM regression, not a crash), and (b) the per-step batch must
    divide the target data-shard product (``put_batch``'s NamedSharding
    raises otherwise). A dp N→M resize that passes both is expressible
    by construction — that verdict is the ``ckpt:mesh-reshard`` info
    finding."""
    if mesh is None:
        return
    from .. import resilience
    from ..parallel.api import _rules as _adapt

    saved_axes = (manifest.get("meta") or {}).get("mesh_axes")
    target_axes = resilience.mesh_axes(mesh)
    if saved_axes is not None and \
            resilience.normalize_mesh_axes(saved_axes) == \
            resilience.normalize_mesh_axes(target_axes):
        # same PLACEMENT (size-1 axes normalized away, exactly like the
        # load_trainer gate — the pinned pairwise agreement must hold
        # for {'dp': 2, 'pp': 1} vs {'dp': 2} too): nothing to reshard
        return
    arrays = _manifest_logical_arrays(manifest).get("params.npz") or {}
    table = _adapt(rules, mesh)
    dropped = LintReport("reshard")
    with collect_into(dropped):
        for key, entry in arrays.items():
            table.spec_for(_unmangle_key(key, entry.get("dtype")),
                           tuple(entry["shape"]), mesh)
    for f in dropped.findings:
        report.add(
            "ckpt:reshard-dropped-rule", "warning",
            f"restoring this checkpoint at mesh {target_axes} drops a "
            f"sharding rule ({f.message}) — the param loads fully "
            "replicated instead of sharded: feasible, but each device "
            "pays the full copy",
            where=f.where or "sharding_rules", **{
                k: v for k, v in f.data.items()
                if k in ("axis", "shape", "dtype")})
    # mirror put_batch EXACTLY: each feed's dim-0 sharding comes from
    # rules.batch_spec (which honors ShardingRules.batch_axes — a
    # {dp,fsdp} mesh whose rules batch-shard only dp splits 2-way, not
    # 8-way), and EVERY feed must divide its own shard product, not
    # just the alphabetically-first one
    offending: Dict[str, Tuple[int, int, Tuple[str, ...]]] = {}
    batch = data_n = None
    for name, shape in _feed_shapes(sample_feed).items():
        spec = table.batch_spec(mesh, len(shape), shape=shape)
        # an empty P() means the batch stays unsharded (no batch axes
        # in the target mesh, e.g. pure-tp) — always feasible
        entry = spec[0] if len(spec) else None
        axes = (entry if isinstance(entry, tuple)
                else (entry,) if entry else ())
        n = int(np.prod([mesh.shape[a] for a in axes] or [1]))
        batch = int(shape[0]) if batch is None else batch
        data_n = n if data_n is None else max(data_n, n)
        if n > 1 and shape[0] % n:
            offending[name] = (int(shape[0]), n, tuple(axes))
    infeasible = bool(offending)
    if infeasible:
        _, (b, n, axes) = sorted(offending.items())[0]
        report.add(
            "ckpt:reshard-infeasible", "error",
            f"restoring at mesh {target_axes} is not expressible with "
            f"the current feed: batch {b} (feed"
            f"{'s' if len(offending) > 1 else ''} {sorted(offending)}) "
            f"does not divide the {n}-way batch-shard product "
            f"({'x'.join(f'{a}={mesh.shape[a]}' for a in axes)}) — "
            "put_batch's NamedSharding rejects the split at the first "
            "step; re-batch the feed or pick a divisible mesh",
            where="batch", got=[b], expected=[n])
    if not infeasible:
        # a pre-mesh-meta checkpoint has no saved axes, so this may not
        # be a reshard at all — the verdict is about restoring AT this
        # mesh, never a claim that the mesh changed. {} is different:
        # the checkpoint KNOWS it was saved single-device (the 1->N
        # elastic case)
        claim = (f"restore at a different mesh "
                 f"({saved_axes or 'single-device'} -> {target_axes}) is"
                 if saved_axes is not None else
                 f"restore at mesh {target_axes} is (checkpoint predates "
                 "mesh metadata — the saved mesh is unknown)")
        stored = ("as ZeRO shard rows (gathered on a non-shard-local "
                  "load)" if (manifest.get("meta") or {}).get("zero")
                  else "unsharded")
        report.add(
            "ckpt:mesh-reshard", "info",
            f"{claim} expressible: checkpoint arrays are stored "
            f"{stored} and re-placed per the rule table at load — "
            "resilience.reshard_restore(checkpoint_dir, trainer) (or "
            "fit(resume=True, elastic=True)) performs it with bit-exact "
            "state"
            + (f"; batch {batch} divides the {data_n}-way batch shards"
               if batch is not None and (data_n or 1) > 1 else
               "; batch feasibility UNCHECKED (pass sample_feed to "
               "verify the feed divides the target batch shards)"
               if batch is None else "")
            + (" (some rules drop — see ckpt:reshard-dropped-rule)"
               if dropped.findings else ""),
            where="mesh")


# --------------------------------------------------------------------------
# front door
# --------------------------------------------------------------------------


def _degrade(report: LintReport, code: str, where: str, fn, *args) -> None:
    """Run one sub-check, degrading a crash on malformed input metadata
    (a meta.json whose sections disagree, a manifest entry missing its
    shape) to an error finding naming the exception — the verifier's
    own contract: corrupt ARTIFACTS are findings, exit 3 is reserved
    for the checker being broken."""
    try:
        fn(*args)
    except Exception as e:
        report.add(code, "error",
                   f"metadata is malformed — the "
                   f"{fn.__name__.lstrip('_')} check cannot run on it "
                   f"({type(e).__name__}: {e}); the runtime load dies on "
                   "the same inconsistency", where=where)


def check_artifacts(
    trainer=None,
    checkpoint_dir: Optional[str] = None,
    artifact_dir: Optional[str] = None,
    mesh=None,
    sharding_rules=None,
    sample_feed: Optional[Dict[str, Any]] = None,
    serving: Optional[Dict[str, Any]] = None,
    replicated_optstate_bytes: int = 64 << 20,
    subject: Optional[str] = None,
) -> LintReport:
    """Statically verify a checkpoint against a trainer and a target mesh
    (contracts.py:607).

    - ``trainer``: a started :class:`~paddle_tpu_torch.executor.Trainer`
      (its scope spec, loss scaler, mesh and rules are the live side of
      every contract);
    - ``checkpoint_dir``: an ``io.save_trainer`` checkpoint: ``ckpt:*``
      findings against the trainer's spec, and whether it restores at the
      target mesh;
    - ``mesh`` / ``sharding_rules``: the target placement (default: the
      trainer's);
    - ``sample_feed``: an example feed (arrays or tensors), whose batch
      the target's data shards must divide.

    Metadata only: no device work, no CRC pass, no deserialization.
    Unreadable metadata degrades to a ``ckpt:unreadable`` error finding,
    and metadata that parses but is inconsistent to ``ckpt:malformed``:
    never a crash of the check. ``artifact_dir`` and ``serving`` (the
    ``artifact:*`` half) raise ``NotYetPorted`` (ROADMAP queue 1, item
    25)."""
    from .. import resilience

    if artifact_dir is not None or serving is not None:
        raise NotYetPorted("check_artifacts(artifact_dir=, serving=): the artifact:* "
                           "contracts come with the analysis package, ROADMAP queue 1, "
                           "item 25")
    enforce(trainer is not None or checkpoint_dir,
            "check_artifacts: pass at least one of trainer / "
            "checkpoint_dir / artifact_dir")
    names = [n for n in (
        f"trainer({trainer.program.name})" if trainer is not None else None,
        checkpoint_dir, artifact_dir) if n]
    report = LintReport(subject=subject or " ~ ".join(names))
    specs = trainer_specs(trainer) if trainer is not None else None
    mesh = mesh if mesh is not None else getattr(trainer, "mesh", None)
    if sharding_rules is None and trainer is not None:
        sharding_rules = (getattr(trainer, "sharding_rules_raw", None)
                          or trainer.sharding_rules)

    if checkpoint_dir:
        manifest = None
        try:
            manifest = resilience.read_manifest(checkpoint_dir)
        except resilience.CheckpointCorrupt as e:
            report.add(
                "ckpt:unreadable", "error",
                f"checkpoint metadata is unreadable ({e.reason}) — "
                "load_trainer raises CheckpointCorrupt",
                where=checkpoint_dir)
        if manifest is None and not report.by_code("ckpt:unreadable"):
            report.add(
                "ckpt:legacy", "info",
                "pre-manifest checkpoint: no flat spec recorded, so "
                "nothing is statically verifiable (and the runtime load "
                "validates nothing either)",
                where=checkpoint_dir)
        elif manifest is not None:
            if specs is not None:
                _degrade(report, "ckpt:malformed", checkpoint_dir,
                         _check_zero, specs, manifest, report)
                _degrade(report, "ckpt:malformed", checkpoint_dir,
                         _check_ckpt_arrays, specs, manifest, report)
                _degrade(report, "ckpt:malformed", checkpoint_dir,
                         _check_loss_scale, specs, manifest, report)
            _degrade(report, "ckpt:malformed", checkpoint_dir,
                     _check_reshard, manifest, mesh,
                     sharding_rules, sample_feed, report)

    if trainer is not None and mesh is not None \
            and trainer.scope.opt_state is not None:
        _rules.check_replicated_optstate(
            trainer.scope.params, trainer.scope.opt_state, mesh,
            sharding_rules, report,
            replicated_optstate_bytes=replicated_optstate_bytes,
            zero_sharding=getattr(trainer, "_zero", None) is not None)
    return report


__all__ = ["check_artifacts", "trainer_specs"]
