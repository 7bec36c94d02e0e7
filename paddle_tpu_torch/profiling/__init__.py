"""Profiling (counterpart of ``paddle_tpu.profiling``): the per-dispatch
:class:`~paddle_tpu_torch.profiling.steptime.StepTimer`, and the memory
advisor's ``device_hbm_bytes`` and ``memory_estimate``
(:mod:`.advisor`). The fusion report, the rest of the advisor,
``profile_report`` and ``export_chrome_trace`` come with ROADMAP item 24
(b)."""

from .advisor import device_hbm_bytes, memory_estimate
from .steptime import StepTimer

__all__ = ["StepTimer", "device_hbm_bytes", "memory_estimate"]
