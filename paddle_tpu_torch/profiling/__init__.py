"""Profiling (counterpart of ``paddle_tpu.profiling``): the per-dispatch
:class:`~paddle_tpu_torch.profiling.steptime.StepTimer`. The fusion and
memory advisors, ``profile_report`` and ``export_chrome_trace`` come with
ROADMAP item 24 (b)."""

from .steptime import StepTimer

__all__ = ["StepTimer"]
