"""``core/flops.py``'s GPT counts and the card's peak, the port against
``paddle_tpu`` on the CPU: ``gpt_train_flops`` and ``gpt_decode_flops``
are pure arithmetic and must equal the JAX values exactly;
``device_peak_flops`` reads the H100's bf16 peak from its table by the
card's name (faked here), whatever dtype is asked for, and falls back to
``measured_matmul_peak`` on the CPU."""

import pytest
import torch

from paddle_tpu.core import flops as jflops
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.core import flops as tflops
from paddle_tpu_torch.models import gpt as tgpt

# (name, config kwargs, batch, seq) — bench_gpt (bench.py:503), gpt_32k
# (bench.py:537) and a small config
CONFIGS = [
    ("bench_gpt", dict(vocab_size=32000, max_len=1024, d_model=768, d_inner=3072,
                       num_heads=12, num_layers=12, use_flash=True, fused_ce=True,
                       dtype="bfloat16"), 8, 1024),
    ("gpt_32k", dict(vocab_size=32000, max_len=32768, d_model=768, d_inner=3072,
                     num_heads=12, num_layers=12, use_flash=True, fused_ce=True,
                     dtype="bfloat16"), 1, 32768),
    ("small", dict(vocab_size=97, max_len=32, d_model=64, d_inner=128, num_heads=2,
                   num_layers=2), 3, 17),
]


@pytest.mark.parametrize("name,kw,batch,seq", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_gpt_counts_equal_paddle_tpu(name, kw, batch, seq):
    jcfg, tcfg = jgpt.base_config(**kw), tgpt.base_config(**kw)
    assert tflops.gpt_train_flops(batch, seq, tcfg) == jflops.gpt_train_flops(batch, seq, jcfg)
    for prompt, new in ((seq // 2, seq // 4), (seq, 1), (7, 0)):
        assert (tflops.gpt_decode_flops(batch, prompt, new, tcfg)
                == jflops.gpt_decode_flops(batch, prompt, new, jcfg))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_device_peak_is_the_table_value_for_an_h100(monkeypatch, dtype):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    peak, source = tflops.device_peak_flops(torch.device("cuda", 0), dtype=dtype)
    # the bf16 peak whatever dtype is asked for (flops.py:52-57)
    assert peak == 989e12 and source == "table:nvidia h100 80gb hbm3"


def test_device_peak_falls_back_to_a_measured_matmul_on_the_cpu():
    peak, source = tflops.device_peak_flops("cpu", dtype="float32")
    assert source == "measured_matmul" and peak > 0
    assert tflops.measured_matmul_peak("cpu", dtype="float32", n=64, iters=1) > 0
