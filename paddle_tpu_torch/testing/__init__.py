"""Test-support utilities shipped with the port (deterministic fault
injection for the serving fleet; counterpart of ``paddle_tpu.testing``).
Production code never imports this package."""

from . import faults  # noqa: F401
