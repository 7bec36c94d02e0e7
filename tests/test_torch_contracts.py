"""The port's ``analysis`` package (``report``, the ``ckpt:*`` half of
``contracts``, ``rules.check_replicated_optstate``) and R1, the sharding
rule drops that a collecting report gathers, against ``paddle_tpu.analysis``
on the CPU.

Each ``ckpt:*`` case of tests/test_contracts.py:86-437 runs here on one
checkpoint directory: the port's ``check_artifacts`` on the port's
trainer and the JAX package's on its own, and the two reports' findings
(code, severity, message, anchor, data) must be equal, word for word,
with the runtime counterpart that runs on one device (``load_trainer``'s
``CheckpointCorrupt``, its warnings). A target mesh that no world runs
here is the port's ``parallel.AbstractMesh`` against the JAX package's
mesh of ``conftest``'s virtual devices: the checks read a mesh's axis names
and sizes only. The restores at those meshes run in the spawned worlds of
tests/test_torch_elastic.py. The replicated-optstate trigger (:561-608)
and the report machinery (:676-808: fingerprints, dedupe, severity
overrides, baselines, SARIF) are held the same way."""

import json
import os

import numpy as np
import pytest

import jax

import paddle_tpu as jpt
from paddle_tpu import analysis as janalysis
from paddle_tpu import io as jio
from paddle_tpu import layers as jL
from paddle_tpu import optimizer as jopt
from paddle_tpu import resilience as jres
from paddle_tpu.analysis import report as jreport
from paddle_tpu.parallel import DistStrategy as JStrategy
from paddle_tpu.parallel import fsdp as jfsdp
from paddle_tpu.parallel.sharding import ShardingRules as JRules
from paddle_tpu.testing import faults
from jax.sharding import PartitionSpec as JP

import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.analysis import report as treport
from paddle_tpu_torch.core.errors import EnforceError, NotYetPorted
from paddle_tpu_torch.parallel import AbstractMesh
from paddle_tpu_torch.parallel import sharding as tsh

CPU = tpt.CPUPlace()
DIM, CLASSES, BS = 6, 4, 4


def _jnet(dim_h=16):
    def net(x, label):
        h = jL.fc(x, dim_h, name="fc1")
        logits = jL.fc(h, CLASSES, name="fc2")
        return {"loss": jL.mean(jL.softmax_with_cross_entropy(logits, label))}
    return net


def _tnet(dim_h=16):
    def net(x, label):
        h = tL.fc(x, dim_h, name="fc1")
        logits = tL.fc(h, CLASSES, name="fc2")
        return {"loss": tL.mean(tL.softmax_with_cross_entropy(logits, label))}
    return net


def _feed(batch=BS, dim=DIM):
    return {"x": np.zeros((batch, dim), np.float32),
            "label": np.zeros((batch, 1), np.int64)}


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jpt.make_mesh(axes, devices=jax.devices()[:n])


def _jtrainer(dim_h=16, mesh=None, rules=None, strategy=None, optim=None, feed=None):
    tr = jpt.Trainer(jpt.build(_jnet(dim_h)), optim or jopt.SGD(0.1), loss_name="loss",
                     mesh=mesh, sharding_rules=rules, strategy=strategy)
    tr.startup(sample_feed=feed or _feed())
    return tr


def _ttrainer(dim_h=16, rules=None, strategy=None, optim=None, feed=None):
    tr = tpt.Trainer(tpt.build(_tnet(dim_h)), optim or topt.SGD(0.1), loss_name="loss",
                     place=CPU, sharding_rules=rules, strategy=strategy)
    tr.startup(0, sample_feed=feed or _feed())
    return tr


def _findings(rep):
    return [(f.code, f.severity, f.message, f.where, dict(f.data), f.count)
            for f in rep.findings]


def _both(jtr, ttr, **kw):
    """The JAX package's report and the port's on the same arguments (a
    target mesh given as {axes}: the JAX mesh and the port's AbstractMesh;
    rules as {"jax": ..., "port": ...}), held equal; returns the port's."""
    axes = kw.pop("mesh", None)
    jkw, tkw = dict(kw), dict(kw)
    if axes is not None:
        jkw["mesh"], tkw["mesh"] = _jmesh(axes), AbstractMesh(axes)
    if "sharding_rules" in kw:
        jkw["sharding_rules"] = kw["sharding_rules"]["jax"]
        tkw["sharding_rules"] = kw["sharding_rules"]["port"]
    jrep = janalysis.check_artifacts(trainer=jtr, **jkw)
    trep = tanalysis.check_artifacts(trainer=ttr, **tkw)
    assert _findings(trep) == _findings(jrep), (trep.render("info"), jrep.render("info"))
    return trep


def _edit_manifest(ck, mutate):
    p = os.path.join(ck, tres.MANIFEST_NAME)
    with open(p) as f:
        man = json.load(f)
    mutate(man)
    with open(p, "w") as f:
        json.dump(man, f)


def _save(tmp_path, tr, name="ck"):
    d = str(tmp_path / name)
    tio.save_trainer(d, tr)
    return d


# -- ckpt:* against one device (tests/test_contracts.py:86-237) --------------------------


def test_clean_pair_has_no_findings(tmp_path):
    ttr = _ttrainer()
    ttr.step(_feed())
    ck = _save(tmp_path, ttr)
    rep = _both(_jtrainer(), ttr, checkpoint_dir=ck)
    assert rep.ok("info"), rep.render("info")
    tio.load_trainer(ck, ttr)


def test_shape_drifted_checkpoint_static_and_runtime(tmp_path):
    ck = _save(tmp_path, _ttrainer(dim_h=16))
    t24 = _ttrainer(dim_h=24)
    rep = _both(_jtrainer(dim_h=24), t24, checkpoint_dir=ck)
    drift = rep.by_code("ckpt:shape-drift")
    assert drift and all(f.severity == "error" for f in drift)
    assert {f.where for f in drift} == {"params.npz:fc1/w", "params.npz:fc1/b",
                                        "params.npz:fc2/w"}
    f = next(f for f in drift if f.where == "params.npz:fc1/w")
    assert f.data["got"] == [6, 16] and f.data["expected"] == [6, 24]
    with pytest.raises(tres.CheckpointCorrupt, match="fc1/b.*drifted"):
        tio.load_trainer(ck, t24)


def test_missing_and_extra_entries_static_and_runtime(tmp_path):
    def renamed(L):
        def net(x, label):
            h = L.fc(x, 16, name="fc1")
            logits = L.fc(h, CLASSES, name="head")
            return {"loss": L.mean(L.softmax_with_cross_entropy(logits, label))}
        return net

    ck = _save(tmp_path, _ttrainer())
    jtr = jpt.Trainer(jpt.build(renamed(jL)), jopt.SGD(0.1), loss_name="loss")
    jtr.startup(sample_feed=_feed())
    ttr = tpt.Trainer(tpt.build(renamed(tL)), topt.SGD(0.1), loss_name="loss", place=CPU)
    ttr.startup(0, sample_feed=_feed())
    rep = _both(jtr, ttr, checkpoint_dir=ck)
    missing, extra = rep.by_code("ckpt:missing-entry"), rep.by_code("ckpt:extra-entry")
    assert {f.where for f in missing} >= {"params.npz:head/w"}
    assert {f.where for f in extra} >= {"params.npz:fc2/w"}
    assert all(f.severity == "error" for f in missing + extra)
    with pytest.raises(tres.CheckpointCorrupt, match="diverge"):
        tio.load_trainer(ck, ttr)


def test_manifest_bitrot_static_and_runtime(tmp_path):
    ttr = _ttrainer()
    ck = _save(tmp_path, ttr)
    faults.flip_byte(ck, name=tres.MANIFEST_NAME, offset=0)
    rep = _both(_jtrainer(), ttr, checkpoint_dir=ck)
    (f,) = rep.by_code("ckpt:unreadable")
    assert f.severity == "error" and "unreadable" in f.message
    assert not rep.by_code("ckpt:legacy")
    with pytest.raises(tres.CheckpointCorrupt, match="manifest"):
        tio.load_trainer(ck, ttr)


@pytest.mark.parametrize("edit", ["shape", "dtype"])
def test_manifest_spec_hand_edit_static_and_runtime(tmp_path, edit):
    ttr = _ttrainer()
    ck = _save(tmp_path, ttr)

    def mutate(man):
        if edit == "shape":
            man["arrays"]["params.npz"]["fc1/w"]["shape"] = [DIM, 99]
        else:
            man["arrays"]["params.npz"]["fc1/b"]["dtype"] = "float64"
    _edit_manifest(ck, mutate)
    rep = _both(_jtrainer(), ttr, checkpoint_dir=ck)
    if edit == "shape":
        (f,) = rep.by_code("ckpt:shape-drift")
        assert f.where == "params.npz:fc1/w" and f.data["got"] == [DIM, 99]
        match = "fc1/w.*manifest records"
    else:
        (f,) = rep.by_code("ckpt:dtype-drift")
        assert f.where == "params.npz:fc1/b"
        assert f.data == {"got": "float64", "expected": "float32"}
        match = "fc1/b.*manifest records"
    with pytest.raises(tres.CheckpointCorrupt, match=match):
        tio.load_trainer(ck, ttr)


def test_loss_scale_drift_static_and_runtime(tmp_path):
    plain = _ttrainer()
    ck_plain = _save(tmp_path, plain, "ck_plain")
    skw = dict(loss_scale=2.0 ** 10, dynamic_loss_scale=True)
    scaled = _ttrainer(strategy=tpt.DistStrategy(**skw))
    rep = _both(_jtrainer(strategy=JStrategy(**skw)), scaled, checkpoint_dir=ck_plain)
    (f,) = rep.by_code("ckpt:loss-scale-drift")
    assert f.severity == "warning" and "no loss_scale_state" in f.message
    assert rep.ok("error")
    with pytest.warns(UserWarning, match="no loss_scale_state"):
        tio.load_trainer(ck_plain, scaled)
    ck_scaled = _save(tmp_path, scaled, "ck_scaled")
    rep = _both(_jtrainer(), plain, checkpoint_dir=ck_scaled)
    (f,) = rep.by_code("ckpt:loss-scale-drift")
    assert f.severity == "warning" and "no loss scaler" in f.message
    with pytest.warns(UserWarning, match="no loss scaler"):
        tio.load_trainer(ck_scaled, plain)


def test_malformed_metadata_degrades_to_finding_not_crash(tmp_path):
    ttr = _ttrainer()
    ck = _save(tmp_path, ttr)

    def drop_shape(man):
        del man["arrays"]["params.npz"]["fc1/w"]["shape"]
    _edit_manifest(ck, drop_shape)
    rep = _both(_jtrainer(), ttr, checkpoint_dir=ck, mesh={"dp": 8},
                sample_feed=_feed(batch=8))
    assert rep.by_code("ckpt:malformed"), rep.render("info")
    # the artifact:* half is item 25's
    with pytest.raises(NotYetPorted, match="item 25"):
        tanalysis.check_artifacts(trainer=ttr, artifact_dir=ck)


def test_legacy_checkpoint_is_info_only(tmp_path):
    ttr = _ttrainer()
    ck = _save(tmp_path, ttr)
    os.remove(os.path.join(ck, tres.MANIFEST_NAME))
    rep = _both(_jtrainer(), ttr, checkpoint_dir=ck)
    (f,) = rep.by_code("ckpt:legacy")
    assert f.severity == "info" and rep.ok("warning")


# -- restoring at another mesh (tests/test_contracts.py:245-437) ---------------------


def _jax_checkpoint(tmp_path, axes, name, batch=8, step=True):
    """A checkpoint the JAX package writes from a trainer on ``axes``."""
    tr = _jtrainer(mesh=_jmesh(axes), feed=_feed(batch=batch))
    if step:
        tr.step(_feed(batch=batch))
    d = str(tmp_path / name)
    jio.save_trainer(d, tr)
    return d


def test_reshard_infeasible_static(tmp_path):
    ck = _save(tmp_path, _ttrainer())
    rep = _both(_jtrainer(), _ttrainer(), checkpoint_dir=ck, mesh={"dp": 8},
                sample_feed=_feed(batch=4))
    (f,) = rep.by_code("ckpt:reshard-infeasible")
    assert f.severity == "error" and f.data == {"got": [4], "expected": [8]}
    assert not rep.by_code("ckpt:mesh-reshard")


def test_reshard_feasible_n_to_m_static(tmp_path):
    ck = _jax_checkpoint(tmp_path, {"dp": 2}, "ck_dp2", step=False)
    assert tres.read_manifest(ck)["meta"]["mesh_axes"] == {"dp": 2}
    jtr = _jtrainer(mesh=_jmesh({"dp": 8}), feed=_feed(batch=8))
    ttr = _ttrainer(feed=_feed(batch=8))
    jrep = janalysis.check_artifacts(trainer=jtr, checkpoint_dir=ck,
                                     sample_feed=_feed(batch=8))
    rep = tanalysis.check_artifacts(trainer=ttr, checkpoint_dir=ck,
                                    mesh=AbstractMesh({"dp": 8}),
                                    sample_feed=_feed(batch=8))
    assert _findings(rep) == _findings(jrep)
    (f,) = rep.by_code("ckpt:mesh-reshard")
    assert f.severity == "info" and "{'dp': 2} -> {'dp': 8}" in f.message
    assert "reshard_restore" in f.message
    assert rep.ok("warning"), rep.render("info")


def test_reshard_verdicts_pairwise_and_the_one_device_restore(tmp_path):
    """Every dp N→M pair's verdict equal to the JAX package's; at M = 1
    (this process) the restore itself: bit-exact params, as the verdict
    says. tests/test_torch_elastic.py runs the M = 2 and M = 4 restores
    and their ReshardError texts."""
    feed6 = _feed(batch=6)
    for n in (2, 4):
        ck = _jax_checkpoint(tmp_path, {"dp": n}, f"ck_dp{n}")
        want = jio.load_persistables(ck)[0]
        for m in (1, 2, 4, 8):
            if m == n:
                continue
            jtr = _jtrainer(mesh=_jmesh({"dp": m}) if m > 1 else None, feed=_feed(batch=8))
            ttr = _ttrainer(feed=_feed(batch=8))
            jrep = janalysis.check_artifacts(trainer=jtr, checkpoint_dir=ck,
                                             sample_feed=feed6)
            rep = tanalysis.check_artifacts(
                trainer=ttr, checkpoint_dir=ck, sample_feed=feed6,
                mesh=AbstractMesh({"dp": m}) if m > 1 else None)
            assert _findings(rep) == _findings(jrep), (n, m)
            assert bool(rep.by_code("ckpt:reshard-infeasible")) == (m in (4, 8))
            if m == 1:
                tres.reshard_restore(ck, ttr, sample_feed=feed6)
                for k, v in want.items():
                    assert np.array_equal(ttr.scope.params[k].detach().numpy(), np.asarray(v)), k


@pytest.mark.parametrize("case", ["size_one_axes", "same_mesh"])
def test_reshard_same_placement_is_silent(tmp_path, case):
    saved, target = (({"dp": 2, "pp": 1}, {"dp": 2}) if case == "size_one_axes"
                     else ({"dp": 8}, {"dp": 8}))
    ck = _jax_checkpoint(tmp_path, saved, "ck", step=False)
    rep = _both(_jtrainer(mesh=_jmesh(target), feed=_feed(batch=8)),
                _ttrainer(feed=_feed(batch=8)), checkpoint_dir=ck, mesh=target,
                sample_feed=_feed(batch=8))
    assert not [f for f in rep.findings if f.code.startswith("ckpt:")], rep.render("info")


def test_reshard_honors_rules_batch_axes(tmp_path):
    ttr = _ttrainer()
    ck = _save(tmp_path, ttr)
    rules = {"jax": JRules(batch_axes=("dp",)), "port": tsh.ShardingRules(batch_axes=("dp",))}
    rep = _both(_jtrainer(), ttr, checkpoint_dir=ck, mesh={"dp": 2, "fsdp": 4},
                sharding_rules=rules, sample_feed=_feed(batch=4))
    assert not rep.by_code("ckpt:reshard-infeasible"), rep.render("info")
    (f,) = rep.by_code("ckpt:mesh-reshard")
    assert "2-way" in f.message
    rep = _both(_jtrainer(), ttr, checkpoint_dir=ck, mesh={"dp": 2, "fsdp": 4},
                sample_feed=_feed(batch=4))
    (f,) = rep.by_code("ckpt:reshard-infeasible")
    assert f.data == {"got": [4], "expected": [8]}


def test_reshard_dropped_rule_is_warning_not_error(tmp_path):
    """R1: the rule that tp=8 cannot honour is dropped inside the check's
    collecting report, so it becomes a ckpt:reshard-dropped-rule finding,
    the verdict still emitted."""
    ttr = _ttrainer()
    ck = _save(tmp_path, ttr)
    rules = {"jax": JRules([(r".*fc1/w", JP("tp", None))]),
             "port": tsh.ShardingRules([(r".*fc1/w", tsh.P("tp", None))])}
    rep = _both(_jtrainer(), ttr, checkpoint_dir=ck, mesh={"tp": 8}, sharding_rules=rules,
                sample_feed=_feed())
    dropped = rep.by_code("ckpt:reshard-dropped-rule")
    assert dropped and all(f.severity == "warning" for f in dropped)
    (f,) = rep.by_code("ckpt:mesh-reshard")
    assert "some rules drop" in f.message


# -- R1: a rule drop is a finding inside collect_into, a warning outside -------------


def test_rule_drops_route_into_the_active_report():
    from paddle_tpu.parallel import sharding as jsh

    cases = [("fc1/w", (6, 16), {"tp": 4}, ("tp", None)),     # indivisible
             ("fc1/w", (6, 16), {"dp": 2}, ("sp", None)),     # axis not in the mesh
             ("fc1/b", (16,), {"tp": 2}, (None, "tp"))]       # more entries than the rank
    got = {}
    for pkg, sh, mk, P_ in (("jax", jsh, _jmesh, JP), ("port", tsh, AbstractMesh, tsh.P)):
        rep = (jreport if pkg == "jax" else treport).LintReport("rules")
        collect = (jreport if pkg == "jax" else treport).collect_into
        with collect(rep):
            for name, shape, axes, spec in cases:
                rules = sh.ShardingRules([(".*", P_(*spec))])
                assert tuple(rules.spec_for(name, shape, mk(axes))) == (None,) * len(shape)
        got[pkg] = _findings(rep)
    assert got["port"] == got["jax"]
    assert [c for c, *_ in got["port"]] == ["sharding:indivisible", "sharding:unknown-axis",
                                            "sharding:rank-mismatch"]
    # outside a collecting report the drop warns, once per message
    tsh.reset_drop_warnings()
    with pytest.warns(tsh.ShardingRuleWarning, match="not divisible"):
        tsh.ShardingRules([(".*", tsh.P("tp", None))]).spec_for(
            "fc1/w", (6, 16), AbstractMesh({"tp": 4}))


# -- sharding:replicated-optstate (tests/test_contracts.py:561-608) ------------------


def test_replicated_optstate_flags_adam_on_dp_mesh():
    rep = _both(_jtrainer(mesh=_jmesh({"dp": 8}), optim=jopt.Adam(1e-3), feed=_feed(batch=8)),
                _ttrainer(optim=topt.Adam(1e-3), feed=_feed(batch=8)), mesh={"dp": 8},
                replicated_optstate_bytes=1)
    (f,) = rep.by_code("sharding:replicated-optstate")
    assert f.severity == "warning" and f.data["data_shards"] == 8
    assert f.data["zero_saving_bytes"] == pytest.approx(
        f.data["replicated_bytes_per_device"] * 7 / 8, rel=1e-6)


def test_replicated_optstate_not_fooled_by_fsdp_sharding():
    rules = {"jax": jfsdp(min_size_to_shard=1), "port": tsh.fsdp(min_size_to_shard=1)}
    feed = _feed(batch=8, dim=8)
    rep = _both(_jtrainer(mesh=_jmesh({"fsdp": 8}), rules=rules["jax"],
                          optim=jopt.Adam(1e-3), feed=feed),
                _ttrainer(optim=topt.Adam(1e-3), feed=feed), mesh={"fsdp": 8},
                sharding_rules=rules, replicated_optstate_bytes=1)
    hits = rep.by_code("sharding:replicated-optstate")
    if hits:  # only the un-shardable fc2/b moments may contribute
        assert hits[0].data["replicated_bytes_per_device"] <= 2 * 4 * 4, hits[0].message


def test_replicated_optstate_quiet_below_threshold_and_for_sgd():
    rep = _both(_jtrainer(mesh=_jmesh({"dp": 8}), optim=jopt.Adam(1e-3), feed=_feed(batch=8)),
                _ttrainer(optim=topt.Adam(1e-3), feed=_feed(batch=8)), mesh={"dp": 8})
    assert not rep.by_code("sharding:replicated-optstate")
    rep = _both(_jtrainer(mesh=_jmesh({"dp": 8}), feed=_feed(batch=8)),
                _ttrainer(feed=_feed(batch=8)), mesh={"dp": 8}, replicated_optstate_bytes=1)
    assert not rep.by_code("sharding:replicated-optstate")


# -- the report machinery (tests/test_contracts.py:676-808), on both packages --------


@pytest.fixture(params=["port", "jax"])
def R(request):
    return treport if request.param == "port" else jreport


def test_fingerprint_dedupe_bumps_count(R):
    rep = R.LintReport("t")
    f1 = rep.add("moe:capacity", "warning", "msg v1", where="moe_0", expected_drop_rate=0.5)
    f2 = rep.add("moe:capacity", "warning", "msg v2 (improved wording)", where="moe_0",
                 expected_drop_rate=0.493)
    assert f1 is f2 and f1.count == 2 and len(rep.findings) == 1
    rep.add("moe:capacity", "warning", "other layer", where="moe_1")
    assert len(rep.findings) == 2


def test_extend_dedupes_repeated_checks(R):
    def one():
        r = R.LintReport("t")
        r.add("ckpt:shape-drift", "error", "m", where="params.npz:w", got=[2], expected=[3])
        return r

    merged = R.LintReport("t").extend(one()).extend(one())
    assert len(merged.findings) == 1 and merged.findings[0].count == 2
    src = one()
    R.LintReport("t").extend(src).findings[0].count = 99
    assert src.findings[0].count == 1


def test_fingerprint_discriminates_distinct_sites(R):
    rep = R.LintReport("t")
    a = rep.add("collective:in-scan", "warning", "m", where="psum", payload_bytes=100,
                path=["scan", "fwd"])
    b = rep.add("collective:in-scan", "warning", "m", where="psum", payload_bytes=100,
                path=["scan", "bwd"])
    assert a.fingerprint != b.fingerprint and len(rep.findings) == 2
    c = rep.add("dtype:cast-roundtrip", "info", "m", where="convert_element_type",
                dtype="float32->bfloat16->float32")
    d = rep.add("dtype:cast-roundtrip", "info", "m", where="convert_element_type",
                dtype="float32->float16->float32")
    assert c.fingerprint != d.fingerprint
    e = rep.add("collective:in-scan", "warning", "m", where="psum", payload_bytes=999,
                path=["scan", "fwd"])
    assert e is a and a.count == 2
    # the port's fingerprints are the JAX package's
    other = jreport if R is treport else treport
    assert other.Finding("a:b", "info", "m", "w", {"shape": [2], "x": 1}).fingerprint == \
        R.Finding("a:b", "info", "m", "w", {"shape": [2], "x": 1}).fingerprint


def test_same_fingerprint_different_severity_kept_separate(R):
    rep = R.LintReport("t")
    rep.add("a:b", "warning", "m", where="w")
    rep.add("a:b", "error", "m", where="w")
    assert len(rep.findings) == 2


def test_apply_severity_exact_beats_family(R):
    rep = R.LintReport("t")
    rep.add("moe:capacity", "warning", "m", where="moe_0")
    rep.add("moe:other", "warning", "m", where="moe_0")
    R.apply_severity(rep, {"moe": "info", "moe:capacity": "error"})
    assert {f.code: f.severity for f in rep.findings} == {"moe:capacity": "error",
                                                          "moe:other": "info"}
    with pytest.raises(Exception, match="severity override"):
        R.apply_severity(rep, {"moe": "fatal"})


def test_baseline_roundtrip_and_new_findings(tmp_path, R):
    rep = R.LintReport("t")
    rep.add("a:b", "warning", "m", where="w", shape=[2, 3])
    rep.add("c:d", "error", "m2", where="v")
    path = str(tmp_path / "base.json")
    doc = R.write_baseline(path, [("subj", rep)])
    assert len(doc["baseline"]) == 2
    base = R.load_baseline(path)
    assert R.new_findings("subj", rep, base) == []
    rep.add("a:b", "warning", "m again", where="w", shape=[2, 3])
    assert R.new_findings("subj", rep, base) == []
    assert len(R.new_findings("other", rep, base)) == 2
    f = rep.add("e:f", "warning", "fresh", where="w")
    assert R.new_findings("subj", rep, base) == [f]
    rep.add("g:h", "info", "note", where="w")
    assert R.new_findings("subj", rep, base) == [f]
    assert R.load_baseline(str(tmp_path / "nope.json")) == {}
    # a baseline the other package wrote suppresses the same findings
    other = jreport if R is treport else treport
    assert sorted(other.load_baseline(path)) == sorted(base)


def test_bad_baseline_file_is_enforced(tmp_path, R):
    p = str(tmp_path / "bad.json")
    with open(p, "w") as fh:
        json.dump(["not", "a", "baseline"], fh)
    with pytest.raises(Exception, match="baseline file"):
        R.load_baseline(p)
    with open(p, "w") as fh:
        json.dump({"version": 99, "baseline": {}}, fh)
    with pytest.raises(Exception, match="version"):
        R.load_baseline(p)
    if R is treport:
        with pytest.raises(EnforceError):
            R.load_baseline(p)


def test_sarif_emitter_shape(R):
    rep = R.LintReport("t")
    rep.add("a:b", "warning", "m", where="w")
    rep.add("a:b", "warning", "m", where="w")
    rep.add("c:d", "error", "m2", where="")
    doc = R.to_sarif([("subj", rep)])
    assert doc["version"] == "2.1.0" and len(doc["runs"]) == 1
    run = doc["runs"][0]
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == ["a:b", "c:d"]
    by_rule = {r["ruleId"]: r for r in run["results"]}
    assert by_rule["a:b"]["occurrenceCount"] == 2
    assert by_rule["a:b"]["level"] == "warning" and by_rule["c:d"]["level"] == "error"
    fp = by_rule["a:b"]["partialFingerprints"]["paddleTpuLint/v1"]
    assert fp == R.baseline_key("subj", rep.findings[0])
    assert by_rule["c:d"]["locations"][0]["logicalLocations"][0]["name"] == "subj"
    # the results are the JAX package's; only the tool's name differs
    other = jreport if R is treport else treport
    orep = other.LintReport("t")
    for f in rep.findings:
        orep.merge(other.Finding(f.code, f.severity, f.message, f.where, dict(f.data),
                                 f.count))
    assert other.to_sarif([("subj", orep)])["runs"][0]["results"] == run["results"]
