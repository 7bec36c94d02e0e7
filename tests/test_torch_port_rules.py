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
FORBIDDEN = ("jax", "jaxlib", "orbax", "paddle_tpu")


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
    assert _forbidden("orbax.checkpoint")
    assert not _forbidden("paddle_tpu_torch.ops") and not _forbidden("jaxtyping_x")


def test_importing_the_port_loads_no_jax():
    mods = ["paddle_tpu_torch", "paddle_tpu_torch.io", "paddle_tpu_torch.serving",
            "paddle_tpu_torch.fleet.decode", "paddle_tpu_torch.models.gpt",
            "paddle_tpu_torch.ops.flash_attention", "paddle_tpu_torch.ops._build",
            "paddle_tpu_torch.layers.attention", "paddle_tpu_torch.initializer",
            "paddle_tpu_torch.optimizer", "paddle_tpu_torch.executor",
            "paddle_tpu_torch.ops.fused_ce", "paddle_tpu_torch.layers.nn",
            "paddle_tpu_torch.layers.stacked", "paddle_tpu_torch.models.lm_head",
            "paddle_tpu_torch.framework", "paddle_tpu_torch.core.config",
            "paddle_tpu_torch.core.unique_name", "paddle_tpu_torch.layers.ops",
            "paddle_tpu_torch.layers.tensor", "paddle_tpu_torch.metrics",
            "paddle_tpu_torch.regularizer", "paddle_tpu_torch.clip",
            "paddle_tpu_torch.lr_scheduler", "paddle_tpu_torch.data",
            "paddle_tpu_torch.data.reader", "paddle_tpu_torch.data.datasets",
            "paddle_tpu_torch.data.feeder", "paddle_tpu_torch.models.mnist",
            "paddle_tpu_torch.resilience", "paddle_tpu_torch.models.transformer",
            "paddle_tpu_torch.models.bert", "paddle_tpu_torch.core.flops",
            "paddle_tpu_torch.ops.attention_scores", "paddle_tpu_torch.nets",
            "paddle_tpu_torch._captured_step", "paddle_tpu_torch.amp",
            "paddle_tpu_torch._captured_decode", "paddle_tpu_torch.layers.beam_search",
            "paddle_tpu_torch.quantize", "paddle_tpu_torch.sparse",
            "paddle_tpu_torch.models.deepfm", "paddle_tpu_torch.models.recommender",
            "paddle_tpu_torch.models.vgg", "paddle_tpu_torch.models.convnets",
            "paddle_tpu_torch.models", "paddle_tpu_torch.layers.rnn",
            "paddle_tpu_torch.layers.sequence", "paddle_tpu_torch.layers.crf",
            "paddle_tpu_torch.layers.control_flow", "paddle_tpu_torch.models.lstm",
            "paddle_tpu_torch.models.seq2seq", "paddle_tpu_torch.models.srl",
            "paddle_tpu_torch.models.word2vec", "paddle_tpu_torch.models.fit_a_line",
            "paddle_tpu_torch.parallel", "paddle_tpu_torch.parallel.mesh",
            "paddle_tpu_torch.parallel.sharding", "paddle_tpu_torch.parallel.api",
            "paddle_tpu_torch.parallel.zero", "paddle_tpu_torch.parallel.ring_attention",
            "paddle_tpu_torch.parallel.ulysses",
            "paddle_tpu_torch.parallel.quantized_collectives",
            "paddle_tpu_torch.ops._dtensor", "paddle_tpu_torch.parallel.pipeline",
            "paddle_tpu_torch.parallel.moe", "paddle_tpu_torch.models.moe_transformer",
            "paddle_tpu_torch.analysis", "paddle_tpu_torch.analysis.report",
            "paddle_tpu_torch.analysis.contracts", "paddle_tpu_torch.analysis.rules",
            "paddle_tpu_torch.parallel.async_ps", "paddle_tpu_torch.native",
            "paddle_tpu_torch.telemetry", "paddle_tpu_torch.telemetry.journal",
            "paddle_tpu_torch.telemetry.registry", "paddle_tpu_torch.telemetry.recorder",
            "paddle_tpu_torch.telemetry.http", "paddle_tpu_torch.telemetry.shipper",
            "paddle_tpu_torch.profiling", "paddle_tpu_torch.profiling.steptime",
            "paddle_tpu_torch.layers.ctc", "paddle_tpu_torch.layers.detection",
            "paddle_tpu_torch.evaluator", "paddle_tpu_torch.backward",
            "paddle_tpu_torch.transpiler"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


FLEET_MODULES = ["paddle_tpu_torch.fleet.router", "paddle_tpu_torch.fleet.remote",
                 "paddle_tpu_torch.fleet.replica_main", "paddle_tpu_torch.fleet.agent",
                 "paddle_tpu_torch.data.wire", "paddle_tpu_torch.testing",
                 "paddle_tpu_torch.testing.faults"]


def test_fleet_modules_load_no_jax():
    """The serving fleet's modules import, in a fresh interpreter, without
    loading JAX or the JAX package (a replica process and a host agent
    start from them)."""
    code = ("import importlib, sys\n"
            f"for m in {FLEET_MODULES!r}: importlib.import_module(m)\n"
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
    from paddle_tpu_torch import (Executor, Inferencer, Trainer, build, data, fit, framework,
                                  layers, optimizer, parallel)
    from paddle_tpu_torch.layers import detection
    from paddle_tpu_torch.models import mnist
    sample = {"image": np.zeros((2, 784), np.float32), "label": np.zeros((2, 1), np.int64)}
    mlp_params = {k: np.zeros(v.shape, np.float32) for k, v in
                  build(mnist.mlp).init(0, place="cpu", **sample)[0].items()}
    mlp_art = str(tmp_path / "mlp")
    tio.save_inference_model(mlp_art, build(mnist.mlp), mlp_params, {}, sample)
    reader = data.batch(data.datasets.mnist("train", synthetic_size=8), 4)

    from paddle_tpu_torch.models import (bert, convnets, deepfm, fit_a_line, lstm,
                                         moe_transformer, recommender,
                                         seq2seq, srl, transformer, vgg, word2vec)
    from paddle_tpu_torch.layers import beam_search, sequence
    tcfg = transformer.base_config(src_vocab=17, trg_vocab=17, max_len=8, d_model=16,
                                   d_inner=32, num_heads=2, num_encoder_layers=1,
                                   num_decoder_layers=1)
    src = np.full((2, 4), 3, np.int32)
    dec_art = str(tmp_path / "dec")
    dec = build(transformer.make_decoder(tcfg, 3))
    dec_params = {k: v.numpy() for k, v in dec.init(0, place="cpu", src_ids=src)[0].items()}
    tio.save_inference_model(dec_art, dec, dec_params, {}, {"src_ids": src})
    bcfg = bert.base_config(vocab_size=17, max_len=8, d_model=16, d_inner=32,
                            num_heads=2, num_layers=1)

    def constant():  # no params, no inputs: nothing says where it runs
        return {"out": layers.fill_constant([2], "float32", 1.0)}

    sharded = str(tmp_path / "sharded")
    tio.save_sharded(sharded, {"w": torch.zeros(2)})

    return {
        "io.load_sharded": lambda: tio.load_sharded(sharded),
        "Executor": lambda: Executor(),
        "Trainer_program": lambda: Trainer(build(mnist.mlp), optimizer.SGD(0.01)),
        "fit": lambda: fit(Trainer(build(mnist.mlp), optimizer.SGD(0.01)), reader, 1,
                           ["image", "label"]),
        "Program.init": lambda: build(mnist.mlp).init(0, **sample),
        "Program.apply": lambda: build(constant).apply({}, {}),
        "Program.apply_numpy": lambda: build(mnist.mlp).apply({}, {}, **sample),
        "DeviceFeeder": lambda: data.DeviceFeeder(lambda: iter([sample])),
        "framework.params_from_jax": lambda: framework.params_from_jax(
            {"w": np.zeros(2, np.float32)}),
        "make_generator": lambda: build(gpt.make_generator(_tiny_cfg(), 2)).init(
            0, prompt_ids=prompts),
        "make_model": lambda: build(gpt.make_model(_tiny_cfg())).init(
            0, ids=prompts, labels=prompts),
        "Trainer": lambda: Trainer(build(gpt.make_model(_tiny_cfg())),
                                   optimizer.AdamW(1e-4)),
        "params_from_jax": lambda: gpt.params_from_jax(
            {"w": np.zeros(2, np.float32)}),
        "export_decoder": lambda: decode.export_decoder(
            str(tmp_path / "other"), _tiny_cfg(), 2, prompts),
        "load_inference_model": lambda: tio.load_inference_model(art),
        "load_inference_model_program": lambda: tio.load_inference_model(mlp_art),
        "Inferencer": lambda: Inferencer(mnist.mlp, params=mlp_params),
        "decode_server": lambda: decode.decode_server(art),
        "Trainer_transformer": lambda: Trainer(build(transformer.make_model(tcfg)),
                                               optimizer.Adam(1e-3)),
        "Trainer_bert": lambda: Trainer(build(bert.make_pretrain_model(bcfg)),
                                        optimizer.AdamW(1e-4)),
        "transformer.make_decoder": lambda: build(transformer.make_decoder(tcfg, 3)).init(
            0, src_ids=src),
        "load_inference_model_decoder": lambda: tio.load_inference_model(dec_art),
        "Trainer_deepfm": lambda: Trainer(build(deepfm.make_model(num_sparse_fields=2,
                                                                  sparse_feature_dim=5)),
                                          optimizer.Adagrad(0.01)),
        "Trainer_recommender": lambda: Trainer(build(recommender.make_model()),
                                               optimizer.Adam(1e-2)),
        "transformer.make_decoder_apply": lambda: build(transformer.make_decoder(tcfg, 3)).apply(
            dec_params, {}, src_ids=src),
        "Trainer_vgg": lambda: Trainer(build(vgg.make_model(depth=16, class_num=3)),
                                       optimizer.Momentum(0.01, 0.9)),
        "Trainer_alexnet": lambda: Trainer(build(convnets.make_alexnet(class_num=3)),
                                           optimizer.Momentum(0.01, 0.9)),
        "Trainer_googlenet": lambda: Trainer(build(convnets.make_googlenet(class_num=3)),
                                             optimizer.Momentum(0.01, 0.9)),
        "Trainer_se_resnext": lambda: Trainer(build(convnets.make_se_resnext(class_num=3)),
                                              optimizer.Momentum(0.01, 0.9)),
        "convnets.Program.init": lambda: build(convnets.make_alexnet(class_num=3)).init(
            0, image=np.zeros((1, 3, 64, 64), np.float32), label=np.zeros((1, 1), np.int64)),
        "Trainer_lstm": lambda: Trainer(build(lstm.make_model(vocab_size=9, emb_dim=4,
                                                              hidden_dim=4)),
                                        optimizer.Adam(1e-3)),
        "Trainer_seq2seq": lambda: Trainer(build(seq2seq.make_model(9, 9, 4, 4)),
                                           optimizer.Adam(1e-3)),
        "Trainer_srl": lambda: Trainer(build(srl.make_model(9, 3, 4, 4, 2)),
                                       optimizer.Adam(1e-3)),
        "Trainer_word2vec": lambda: Trainer(build(word2vec.make_model(9, 4, 4)),
                                            optimizer.Adam(1e-3)),
        "Trainer_fit_a_line": lambda: Trainer(build(fit_a_line.make_model()),
                                              optimizer.SGD(1e-3)),
        "seq2seq.make_decoder": lambda: build(seq2seq.make_decoder(9, 9, 4, 4, 3)).init(
            0, src_ids=src, src_lengths=np.full((2,), 4, np.int64)),
        "create_lod_tensor": lambda: sequence.create_lod_tensor(
            np.zeros((3, 1), np.float32), [[1, 2]]),
        "beam_search_decode_lod": lambda: beam_search.beam_search_decode_lod(
            np.ones((1, 2, 3), np.int32), np.ones((1, 2, 3), bool)),
        "parallel.initialize": lambda: parallel.initialize(),
        "Trainer_mesh": lambda: Trainer(build(mnist.mlp), optimizer.SGD(0.01),
                                        mesh=_cuda_mesh(parallel)),
        "Trainer_moe": lambda: Trainer(build(moe_transformer.make_model(
            moe_transformer.base_config(vocab_size=9, d_model=8, d_inner=8, d_expert=8,
                                        num_heads=2, num_layers=2, num_experts=2))),
            optimizer.Adam(1e-3)),
        "Trainer_pipeline": lambda: Trainer(build(transformer.make_model(
            transformer.base_config(src_vocab=9, trg_vocab=9, d_model=8, d_inner=8,
                                    num_heads=2, num_encoder_layers=2,
                                    num_decoder_layers=2, stacked=True))),
            optimizer.Adam(1e-3), strategy=parallel.DistStrategy(pp_microbatches=2)),
        # refuses before it connects: no server listens at this address
        "AsyncPSTrainer": lambda: parallel.AsyncPSTrainer(build(mnist.mlp), ("127.0.0.1", 9)),
        "detection.prior_box": lambda: detection.prior_box((2, 2), (8, 8), [4.0]),
        "detection.density_prior_box": lambda: detection.density_prior_box(
            (2, 2), (8, 8), [4.0], [1.0], [1]),
    }


def _cuda_mesh(parallel):
    """A mesh that says its ranks are on the card (what ``make_mesh`` gives
    under NCCL), without a process group."""
    mesh = parallel.Mesh.__new__(parallel.Mesh)
    mesh.device, mesh.axis_names, mesh.shape = torch.device("cuda", 0), ("dp",), {"dp": 1}
    return mesh


@pytest.mark.parametrize("entry", ["make_generator", "params_from_jax",
                                   "export_decoder", "load_inference_model",
                                   "decode_server", "make_model", "Trainer",
                                   "Executor", "Trainer_program", "fit", "Program.init",
                                   "Program.apply", "Program.apply_numpy",
                                   "DeviceFeeder", "framework.params_from_jax",
                                   "load_inference_model_program", "Inferencer",
                                   "Trainer_transformer", "Trainer_bert",
                                   "transformer.make_decoder",
                                   "load_inference_model_decoder", "Trainer_deepfm",
                                   "Trainer_recommender", "transformer.make_decoder_apply",
                                   "Trainer_vgg", "Trainer_alexnet", "Trainer_googlenet",
                                   "Trainer_se_resnext", "convnets.Program.init",
                                   "Trainer_lstm", "Trainer_seq2seq", "Trainer_srl",
                                   "Trainer_word2vec", "Trainer_fit_a_line",
                                   "seq2seq.make_decoder", "create_lod_tensor",
                                   "beam_search_decode_lod", "parallel.initialize",
                                   "Trainer_mesh", "Trainer_moe", "Trainer_pipeline",
                                   "io.load_sharded", "AsyncPSTrainer",
                                   "detection.prior_box", "detection.density_prior_box"])
def test_entry_points_refuse_to_run_without_a_card(tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    call = _entry_points(tmp_path)[entry]
    with pytest.raises(NoCudaDevice, match="no CUDA card is available"):
        call()


def test_executor_and_trainer_run_programs_on_their_own_place():
    """A program with no params and no inputs runs where the Executor or
    Trainer that runs it is placed, not on a device of its own choosing:
    on the CPU when they are given the CPU, and on the card (so, with no
    card, NoCudaDevice) when they hold a CUDA place."""
    from paddle_tpu_torch import CPUPlace, Executor, Trainer, build, layers, optimizer

    def constant():
        return {"loss": layers.fill_constant([2], "float32", 1.0)}

    exe = Executor(place=CPUPlace())
    prog = build(constant)
    exe.startup(prog)
    out = exe.run(prog, return_numpy=False)
    assert out["loss"].device == torch.device("cpu")
    trainer = Trainer(prog, optimizer.SGD(0.1), place=CPUPlace()).startup(0)
    assert trainer.eval({})["loss"].device == torch.device("cpu")
    if torch.cuda.is_available():
        return
    # the same objects holding the card's place (as Executor() and Trainer()
    # would, with a card) hand it to the program, which then needs the card
    exe.device = trainer.device = torch.device("cuda", 0)
    with pytest.raises(NoCudaDevice, match="Program.apply"):
        exe.run(prog)
    with pytest.raises(NoCudaDevice, match="Program.apply"):
        trainer.eval({})
    with pytest.raises(NoCudaDevice, match="Program.init"):
        trainer.startup(0)


def test_run_steps_needs_a_card_on_a_cuda_place():
    """A trainer holding the card's place runs its fused steps there: with
    no card, run_steps raises NoCudaDevice before it puts or runs
    anything."""
    from paddle_tpu_torch import CPUPlace, Trainer, build, optimizer
    from paddle_tpu_torch.data import stack_batches
    from paddle_tpu_torch.models import mnist

    sample = {"image": np.zeros((2, 784), np.float32), "label": np.zeros((2, 1), np.int64)}
    trainer = Trainer(build(mnist.mlp), optimizer.SGD(0.1), place=CPUPlace()).startup(0, sample)
    if torch.cuda.is_available():
        return
    trainer.device = torch.device("cuda", 0)
    with pytest.raises(NoCudaDevice, match="Trainer.run_steps"):
        trainer.run_steps(stack_batches([sample, sample]))
    assert trainer.global_step == 0 and trainer._fused is None


def test_device_feeder_refuses_a_cpu_target():
    """The prefetch copies on a side CUDA stream: asked to target the CPU,
    it raises instead of copying synchronously, and fit(prefetch=True)
    with a CPU trainer raises the same way."""
    from paddle_tpu_torch.core.errors import EnforceError
    from paddle_tpu_torch.data import DeviceFeeder
    for device in ("cpu", torch.device("cpu")):
        with pytest.raises(EnforceError, match="side CUDA stream"):
            DeviceFeeder(lambda: iter([]), device=device)


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
    assert _build.sources() == ["flash_bwd", "flash_fwd"]
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


@pytest.mark.parametrize("entry", sorted(tfa.BWD_ARGTYPES))
def test_backward_entry_points_match_their_argtypes(entry):
    """flash_bwd_dq / flash_bwd_dkv: each C parameter has its ctypes
    argtype, pointers and the stream as c_void_p (a c_int would cut
    them)."""
    with open(os.path.join(_build.CSRC, "flash_bwd.cu")) as f:
        src = f.read()
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
    assert sig is not None
    params = [p.strip() for p in sig.group(1).split(",") if p.strip()]
    argtypes = tfa.BWD_ARGTYPES[entry]
    assert len(params) == len(argtypes)
    for param, argtype in zip(params, argtypes):
        assert ("*" in param) == (argtype is ctypes.c_void_p), param
        if "long long" in param:
            assert argtype is ctypes.c_longlong, param
        elif param.startswith("float"):
            assert argtype is ctypes.c_float, param
    for name in ("_dq_kernel", "_dkv_kernel", "paddle_tpu/ops/flash_attention.py"):
        assert name in src  # names what it replaces


def test_package_import_builds_nothing():
    assert paddle_tpu_torch.__version__
    assert _build._libs == {} or torch.cuda.is_available()
    assert tfa.HEAD_DIMS == (32, 64, 128)


def _source(name):
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        return f.read()


@pytest.mark.parametrize("source,replaces", [
    ("flash_bwd", ("_dq_kernel", "_dkv_kernel")), ("flash_fwd", ("_fwd_kernel",))])
def test_kernel_source_runs_bf16_on_the_tensor_cores_without_atomics(source, replaces):
    """The bf16 route's products are wgmma, its tiles arrive by TMA into
    mbarrier-guarded stages, and nothing in the source adds into an output
    with atomics: each output tile has one writer."""
    src = _source(source)
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                   "cuTensorMapEncodeTiled", "__grid_constant__"):
        assert needle in src, needle
    code = re.sub(r"//[^\n]*", "", src)  # comments may name what is absent
    assert "atomic" not in code.lower()
    assert re.search(r"\bred\.|\batom\.|cp\.reduce", code) is None
    for name in (*replaces, "paddle_tpu/ops/flash_attention.py"):
        assert name in src  # names what it replaces


@pytest.mark.parametrize("source", _build.sources())
def test_kernel_source_includes_no_header_of_the_repo(source):
    """Each source stands alone: it includes only the CUDA toolkit's and the
    C library's headers. A header shared by the forward and the backward
    once slowed the forward (the library name hashes the source, so a
    shared header would also go unseen by the rebuild check)."""
    includes = re.findall(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]', _source(source), re.M)
    assert includes, source
    assert all(kind == "<" for kind, _ in includes), includes
    repo_headers = {f for _, _, files in os.walk(REPO) for f in files
                    if f.endswith((".h", ".cuh", ".hpp"))}
    assert not {os.path.basename(h) for _, h in includes} & repo_headers


def test_route_table_is_the_stated_rule():
    """One table routes the forward and both backward passes: bf16 at head
    dims 64 and 128 on the tensor cores; f32 at every head dim and bf16 at
    32 on the CUDA cores. The wrappers pass the choice to the C entry
    points as a code: 0 f32 and 1 bf16 on the CUDA cores, 2 bf16 on the
    tensor cores."""
    want = {(torch.bfloat16, 32): "cuda_core", (torch.bfloat16, 64): "wgmma",
            (torch.bfloat16, 128): "wgmma", (torch.float32, 32): "cuda_core",
            (torch.float32, 64): "cuda_core", (torch.float32, 128): "cuda_core"}
    assert tfa.ROUTES == want
    codes = {key: tfa._route_code(*key) for key in want}
    assert codes == {(torch.bfloat16, 32): 1, (torch.bfloat16, 64): 2,
                     (torch.bfloat16, 128): 2, (torch.float32, 32): 0,
                     (torch.float32, 64): 0, (torch.float32, 128): 0}


@pytest.mark.parametrize("d", [64, 128])
def test_tma_ready_keeps_the_training_views_without_a_copy(d):
    from paddle_tpu_torch.layers.stacked import _split_heads
    b, s, h = 2, 16, 3
    qkv = torch.randn(b, s, 3, h * d).to(torch.bfloat16)
    for i in range(3):
        view = _split_heads(qkv[:, :, i], d)
        assert not view.is_contiguous()
        assert tfa._tma_ready(view) is view
    g = torch.randn(b, s, h, d).to(torch.bfloat16).transpose(1, 2)  # _merge_heads' grad
    assert not g.is_contiguous() and tfa._tma_ready(g) is g
    flat = torch.randn(b, h, s, d).to(torch.bfloat16)
    assert tfa._tma_ready(flat) is flat


def _attn_params(d, n_heads, dtype):
    """Random weights of one attention block's qkv projection, as
    ``layers.stacked._attn_qkv`` reads them."""
    g = torch.Generator().manual_seed(0)
    width = d * n_heads
    return {"ln1/scale": torch.ones(width), "ln1/bias": torch.zeros(width),
            "qkv/w": torch.randn(width, 3, width, generator=g).to(dtype),
            "qkv/b": torch.randn(3, width, generator=g).to(dtype)}


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (128, torch.bfloat16),
                                     (64, torch.float32), (32, torch.bfloat16)])
def test_forward_operands_keep_the_qkv_head_views_without_a_copy(d, dtype):
    """The served prefill and the training step hand the forward q, k and v
    as strided head views of one fused [b, s, 3, h·d] projection
    (``_attn_qkv``); the operands the kernel gets are those views, on
    either route, so their pointers and strides reach it unchanged."""
    from paddle_tpu_torch.layers.stacked import _attn_qkv
    b, s, h = 2, 24, 3
    x = torch.randn(b, s, h * d, generator=torch.Generator().manual_seed(1))
    q, k, v = _attn_qkv(x.to(dtype), _attn_params(d, h, dtype), h, dtype)
    assert q.dtype == dtype and not q.is_contiguous()
    assert q.stride() == (s * 3 * h * d, d, 3 * h * d, 1)
    got = tfa._kernel_layout(q, k, v, None, None, None)
    assert all(a is w for a, w in zip(got[:3], (q, k, v)))
    assert got[3:] == (None, None, None)


@pytest.mark.parametrize("make", ["row_stride_136_bytes", "base_off_by_2_bytes",
                                  "zero_stride"])
def test_tma_ready_copies_what_tma_cannot_read(make):
    base = torch.randn(2, 3, 10, 68).to(torch.bfloat16)
    t = {"row_stride_136_bytes": lambda: base[..., :64],
         "base_off_by_2_bytes": lambda: base.flatten()[1:1 + 2 * 3 * 10 * 64]
         .view(2, 3, 10, 64),
         "zero_stride": lambda: base[:1, :, :, :64].contiguous().expand(2, 3, 10, 64),
         }[make]()
    got = tfa._tma_ready(t)
    assert got is not t and got.is_contiguous()
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
