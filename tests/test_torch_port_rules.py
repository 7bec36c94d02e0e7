"""Rules the PyTorch/CUDA port keeps, checked on a machine without a
CUDA card: it never imports JAX or the JAX package, its entry points
refuse to fall back to the CPU, ``chip_smoke.py`` fails without a card,
and the CUDA source and its builder load without nvcc."""

import ast
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.core.place import NoCudaDevice, TPUPlace, UnsupportedPlace
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module):
    # whole dotted names only: "paddle_tpu_torch" is not "paddle_tpu"
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_jax_package_imports(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert bad == [], f"{os.path.relpath(path, REPO)} imports {bad}"


def test_forbidden_name_check_does_not_match_the_port():
    assert _forbidden("paddle_tpu.ops") and _forbidden("jax.numpy")
    assert not _forbidden("paddle_tpu_torch.ops") and not _forbidden("jaxtyping_x")


def test_importing_the_port_loads_no_jax():
    mods = ["paddle_tpu_torch", "paddle_tpu_torch.io", "paddle_tpu_torch.serving",
            "paddle_tpu_torch.fleet.decode", "paddle_tpu_torch.models.gpt",
            "paddle_tpu_torch.ops.flash_attention", "paddle_tpu_torch.ops._build",
            "paddle_tpu_torch.layers.attention", "paddle_tpu_torch.initializer"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _tiny_cfg():
    from paddle_tpu_torch.models import gpt
    return gpt.base_config(vocab_size=17, max_len=16, d_model=16, d_inner=32,
                           num_heads=2, num_layers=1)


def _entry_points(tmp_path):
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.fleet import decode
    from paddle_tpu_torch.models import gpt

    art = str(tmp_path / "art")
    prompts = np.full((2, 4), 3, np.int32)
    decode.export_decoder(art, _tiny_cfg(), 2, prompts, device="cpu")
    return {
        "make_generator": lambda: gpt.make_generator(_tiny_cfg(), 2),
        "params_from_jax": lambda: gpt.params_from_jax(
            {"w": np.zeros(2, np.float32)}),
        "export_decoder": lambda: decode.export_decoder(
            str(tmp_path / "other"), _tiny_cfg(), 2, prompts),
        "load_inference_model": lambda: tio.load_inference_model(art),
        "decode_server": lambda: decode.decode_server(art),
    }


@pytest.mark.parametrize("entry", ["make_generator", "params_from_jax",
                                   "export_decoder", "load_inference_model",
                                   "decode_server"])
def test_entry_points_refuse_to_run_without_a_card(tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    call = _entry_points(tmp_path)[entry]
    with pytest.raises(NoCudaDevice, match="no CUDA card is available"):
        call()


def test_places_are_torch_devices_and_tpu_place_raises():
    from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace, default_device
    assert CPUPlace() == torch.device("cpu")
    assert CUDAPlace(1) == torch.device("cuda", 1)
    assert default_device("cpu") == torch.device("cpu")
    with pytest.raises(UnsupportedPlace):
        TPUPlace(0)


def _run_chip_smoke(cwd, script):
    return subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run_chip_smoke(REPO, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = _run_chip_smoke(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_kernel_source_and_builder_load_without_nvcc(tmp_path, monkeypatch):
    assert _build.sources() == ["flash_fwd"]
    with open(os.path.join(_build.CSRC, "flash_fwd.cu")) as f:
        src = f.read()
    # the C entry point's parameters match the ctypes argtypes one to one
    sig = re.search(r'extern "C" int flash_fwd\(([^)]*)\)', src)
    assert sig is not None
    params = [p.strip() for p in sig.group(1).split(",") if p.strip()]
    assert len(params) == len(tfa.ARGTYPES)
    # every pointer and the stream go as c_void_p (a c_int would cut them)
    for param, argtype in zip(params, tfa.ARGTYPES):
        assert ("*" in param) == (argtype is ctypes.c_void_p), param
    assert "paddle_tpu/ops/flash_attention.py" in src  # names what it replaces
    cmd = _build.nvcc_command("nvcc", "x.cu", "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    path = _build.library_path("flash_fwd")
    assert os.path.basename(path).startswith("libflash_fwd-")
    # no nvcc here: building raises the typed error, it never half-loads
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "library_path",
                        lambda name: str(tmp_path / f"lib{name}.so"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build("flash_fwd")


def test_package_import_builds_nothing():
    assert paddle_tpu_torch.__version__
    assert _build._libs == {} or torch.cuda.is_available()
    assert tfa.HEAD_DIMS == (32, 64, 128)
