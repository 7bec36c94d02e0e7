"""paddle_tpu_torch.profiling — the step's kernel table + HBM/remat advisor
(counterpart of ``paddle_tpu.profiling``).

- :mod:`fusion` — the JAX package's optimized-HLO text parse, copied
  (``parse_hlo_module``, ``module_units``, ``unit_row``,
  ``fusion_report_from_text``), and ``fusion_report(trainer, feed)``: one
  training step under ``torch.profiler``, its device kernels (on the
  card; leaf ops on the CPU) as units with bytes, FLOPs and their layers,
  the top-k by cost;
- :mod:`steptime` — per-dispatch wall-time accounting (always on in the
  Trainer) merged with the input-pipeline stage metrics into
  ``trainer.profile_report()`` (compute / h2d / host-encode /
  starvation), with chrome-trace export via ``core.profiler``;
- :mod:`advisor` — the step's memory estimate (params + optimizer state
  + what the backward holds) against the card's memory, emitting
  ``memory:remat-candidate`` findings whose suggested
  ``DistStrategy.remat`` is measured (:func:`advisor.verify_remat`).
"""

from .advisor import advise, device_hbm_bytes, memory_estimate, verify_remat
from .fusion import (fusion_report, fusion_report_from_text, module_units,
                     parse_hlo_module, unit_row)
from .steptime import StepTimer, export_chrome_trace, profile_report

__all__ = [
    "advise", "device_hbm_bytes", "memory_estimate", "verify_remat",
    "fusion_report", "fusion_report_from_text", "module_units",
    "parse_hlo_module", "unit_row",
    "StepTimer", "export_chrome_trace", "profile_report",
]
