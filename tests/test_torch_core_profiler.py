"""The rest of the port's ``core/`` against ``paddle_tpu``'s on the CPU:
``core.profiler`` (the RecordEvent spans, the aggregate table, the
timeline dump, the start/stop/reset/cuda_profiler controls of
tests/test_compat_surfaces.py:187-266, a ``torch.profiler`` trace written
under ``trace_dir``, the report scopes), ``core.errors``' ``ShapeError``,
``enforce_eq``, ``enforce_gt`` and ``not_found``, and ``core.place``'s
``Place``, ``default_place``, ``available_places`` and ``device_count``;
and the modules this slice ported import neither ``jax`` nor
``paddle_tpu``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu.core import errors as jerrors
from paddle_tpu.core import place as jplace
from paddle_tpu.core import profiler as JP

import paddle_tpu_torch as tpt
from paddle_tpu_torch import core as tcore
from paddle_tpu_torch.core import errors as terrors
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.core import profiler as TP


def _nested(P):
    """The same record_event nesting in either package; returns the rows."""
    P.start_profiler()
    for _ in range(3):
        with P.record_event("step"):
            with P.record_event("fwd"):
                pass
            with P.record_event("bwd"):
                pass
    with P.record_event("fwd"):
        pass
    return P.stop_profiler()


def test_aggregate_rows_equal_jax(capsys):
    jrows, trows = _nested(JP), _nested(TP)
    assert [(r["name"], r["calls"]) for r in sorted(trows, key=lambda r: r["name"])] == \
        [(r["name"], r["calls"]) for r in sorted(jrows, key=lambda r: r["name"])] == \
        [("bwd", 3), ("fwd", 4), ("step", 3)]
    for r in trows:
        assert set(r) == {"name", "calls", "total", "min", "max", "ave"}
        assert r["min"] <= r["ave"] <= r["max"] and r["total"] >= 0
    printed = capsys.readouterr().out.splitlines()
    jhead = [ln for ln in printed if ln.startswith("Event")]
    assert len(jhead) == 2 and jhead[0] == jhead[1]
    # the rows stay until the next enable, sorted by the key asked for
    # (an unknown key sorts by total), as in the JAX package
    for key in ("calls", "max", "bogus"):
        for P in (JP, TP):
            rows = P.disable_profiler(sorted_key=key, print_table=False)
            k = "total" if key == "bogus" else key
            assert [r[k] for r in rows] == sorted((r[k] for r in rows), reverse=True)
            assert len(rows) == 3


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_timeline_schema(pkg, tmp_path):
    P = JP if pkg == "jax" else TP
    _nested(P)
    path = str(tmp_path / "tl.json")
    n = P.timeline(path, extra_spans=[("extra", 1.0, 2.0, 7)])
    doc = json.load(open(path))
    ev = doc["traceEvents"]
    assert n == len(ev) == 3 * 3 + 1 + 1 and doc["displayTimeUnit"] == "ms"
    assert all(set(e) == {"name", "ph", "ts", "dur", "pid", "tid", "cat"} for e in ev)
    assert all(e["ph"] == "X" and e["cat"] == "host" and e["dur"] >= 0 for e in ev)
    assert [e["ts"] for e in ev] == sorted(e["ts"] for e in ev)
    P.reset_profiler()
    assert P.timeline(path) == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_profiler_controls(pkg):
    P = JP if pkg == "jax" else TP
    P.start_profiler()
    with P.record_event("op_x"):
        pass
    rows = P.stop_profiler()
    assert any(r["name"] == "op_x" for r in rows)
    P.reset_profiler()
    with pytest.raises(NotImplementedError):
        P.cuda_profiler()
    # a disabled profiler records nothing, and the span still runs its body
    ran = []
    with P.record_event("quiet"):
        ran.append(1)
    assert ran == [1] and P.timeline(os.devnull) == 0


def test_profiler_writes_a_torch_trace(tmp_path):
    d = str(tmp_path / "trace")
    with TP.profiler(d):
        with TP.record_event("matmul_block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.load(open(os.path.join(d, "trace.json")))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "matmul_block" in names and any(str(n).startswith("aten::") for n in names)
    TP.reset_profiler()


def test_report_scopes_open_layer_and_kernel_ranges_only_inside_a_report():
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import layers
    prog = tpt.build(lambda x: layers.fc(layers.fc(x, 4, name="a"), 2, name="b"))
    x = torch.ones(3, 5)
    params, _ = prog.init(0, x, place=tpt.CPUPlace())

    def names(report):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with TP.report_scopes() if report else TP._NULL:
                prog.apply(params, {}, x, place=tpt.CPUPlace())
                with TP.kernel_range("flash_fwd"):
                    pass
        return [e.name for e in prof.events()]

    assert not any(n.startswith("layer:") or n == "flash_fwd" for n in names(False))
    got = names(True)
    assert [n for n in got if n.startswith("layer:")] == ["layer:a", "layer:b"]
    assert "flash_fwd" in got
    assert TP.kernel_range("flash_fwd") is TP._NULL and TP._reporting == 0


# -- core.errors and core.place -----------------------------------------------------


def test_errors_equal_jax():
    for mod in (jerrors, terrors):
        assert issubclass(mod.ShapeError, mod.EnforceError)
        assert issubclass(mod.ShapeError, ValueError)
    for fn, args in (("enforce_eq", (1, 2, "m")), ("enforce_gt", (1, 2, "m")),
                     ("enforce_gt", (2, 2))):
        with pytest.raises(jerrors.EnforceError) as j:
            getattr(jerrors, fn)(*args)
        with pytest.raises(terrors.EnforceError) as t:
            getattr(terrors, fn)(*args)
        assert str(t.value) == str(j.value)
    terrors.enforce_eq(3, 3)
    terrors.enforce_gt(3, 2)
    with pytest.raises(terrors.NotFoundError, match="no w") as t:
        terrors.not_found("no w")
    assert isinstance(t.value, KeyError)
    assert tcore.ShapeError is terrors.ShapeError


def test_place_equal_jax():
    # conftest runs JAX on 8 virtual CPU devices; torch sees one CPU here
    assert repr(tplace.default_place()) == repr(jplace.default_place()) == "CPUPlace(0)"
    assert tplace.Place("cpu", 0) == tcore.Place("cpu")
    for p in ("cpu", "gpu", "tpu"):
        assert repr(tplace.Place(p, 1)) == repr(jplace.Place(p, 1))
    assert tplace.available_places("gpu") == [] == jplace.available_places("gpu")
    assert [repr(p) for p in tplace.available_places("cpu")] == \
        [repr(p) for p in jplace.available_places("cpu")][:1]
    assert tplace.device_count() == len(tplace.available_places()) == 1
    assert jplace.device_count() == len(jplace.available_places())
    assert tplace.Place("cpu").device() == torch.device("cpu")
    with pytest.raises(tplace.UnsupportedPlace):
        tplace.Place("tpu").device()
    with pytest.raises(tplace.NoCudaDevice):
        tplace.Place("gpu").device()
    # a Place is a place= argument
    assert tplace.default_device(tplace.Place("cpu")) == torch.device("cpu")


def test_new_modules_import_no_jax():
    mods = ["paddle_tpu_torch.core", "paddle_tpu_torch.core.profiler",
            "paddle_tpu_torch.core.errors", "paddle_tpu_torch.core.place",
            "paddle_tpu_torch.profiling", "paddle_tpu_torch.profiling.fusion",
            "paddle_tpu_torch.profiling.steptime", "paddle_tpu_torch.profiling.advisor",
            "paddle_tpu_torch.debugger", "paddle_tpu_torch.executor"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
              "'paddle_tpu'))\nassert not bad, bad\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
