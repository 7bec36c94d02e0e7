"""Static checks (counterpart of ``paddle_tpu.analysis``), the part that
checkpoints and elastic restores need.

- :mod:`.report`: :class:`Finding`, :class:`LintReport`, the collector
  (:func:`collect_into`) that ``parallel.sharding``'s rule drops report
  into, the baseline functions and the SARIF emitter;
- :mod:`.contracts`: :func:`check_artifacts` for the ``ckpt:*`` findings,
  a trainer against a checkpoint and a target mesh, which
  ``resilience.reshard_restore`` runs before it touches any state, and
  :func:`~.contracts.check_reload_compat` for a hot reload's candidate
  against a live server (``PredictorServer.reload_preflight``);
- :mod:`.rules`: :func:`~.rules.check_replicated_optstate`, the
  ``sharding:replicated-optstate`` trigger.

The program lints over the traced step (``check``, ``check_trainer``,
the walker, the zoo), the rest of the ``artifact:*`` half, the
source-level checks and the CLI come with ROADMAP queue 1, item 25.
"""

from . import contracts, report, rules
from .contracts import check_artifacts, trainer_specs
from .report import (Finding, LintError, LintReport, LintWarning, active_report,
                     apply_severity, baseline_key, collect_into, load_baseline,
                     new_findings, to_sarif, write_baseline)
from .rules import check_replicated_optstate

__all__ = [
    "contracts", "report", "rules",
    "check_artifacts", "trainer_specs", "check_replicated_optstate",
    "Finding", "LintError", "LintReport", "LintWarning", "active_report",
    "apply_severity", "baseline_key", "collect_into", "load_baseline",
    "new_findings", "to_sarif", "write_baseline",
]
