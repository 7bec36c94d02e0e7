"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package keeps ``paddle_tpu``'s module layout and public names so each
module's counterpart is easy to find, and it keeps the JAX package's
parameter names and layouts, so a parameter dict moves between the two as
numpy arrays. It imports ``torch`` and numpy only; every CUDA kernel is
built at its first launch (``ops/_build.py``), never at import.

The programming model is the JAX package's: ``build(fn)`` → ``Program``
whose layers create their params through ``LayerHelper`` → ``Trainer``
(or ``Executor``) → ``fit``. Entry points run on the CUDA card unless the
caller passes the CPU (``place=CPUPlace()`` or ``device="cpu"``); with no
card they raise :class:`paddle_tpu_torch.core.place.NoCudaDevice`.
"""

__version__ = "0.1.0"

from . import clip, core, data, framework, initializer, layers, lr_scheduler  # noqa: E402
from . import metrics, models, optimizer, regularizer  # noqa: E402
from .core.config import enable_determinism, get_flag  # noqa: E402
from .core.place import CPUPlace, CUDAPlace  # noqa: E402
from .executor import (Event, Executor, Scope, Trainer, fit, global_scope,  # noqa: E402
                       scope_guard)
from .framework import (  # noqa: E402
    LayerHelper,
    ParamAttr,
    Program,
    WeightNormParamAttr,
    amp_guard,
    build,
    create_parameter,
    create_variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
)

# honour PDTPU_DETERMINISTIC=1, as the JAX package does at import
if get_flag("deterministic"):
    enable_determinism()

__all__ = [
    "CPUPlace", "CUDAPlace", "Event", "Executor", "LayerHelper",
    "ParamAttr", "Program", "Scope", "Trainer", "WeightNormParamAttr", "amp_guard",
    "build", "clip", "create_parameter", "create_variable", "data",
    "default_main_program", "default_startup_program", "enable_determinism", "fit",
    "framework", "global_scope", "initializer", "layers", "lr_scheduler", "metrics",
    "models", "name_scope", "optimizer", "program_guard", "regularizer",
    "scope_guard",
]
