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

from . import amp, analysis, backward, clip, core, data, debugger, evaluator  # noqa: E402
from . import framework  # noqa: E402
from . import initializer, io, layers, lr_scheduler, metrics, models, nets  # noqa: E402
from . import optimizer, parallel, profiling, quantize, regularizer, resilience  # noqa: E402
from . import sparse  # noqa: E402
from . import transpiler  # noqa: E402
from .backward import append_backward, calc_gradient  # noqa: E402
from .core.config import enable_determinism, get_flag  # noqa: E402
from .core.place import CPUPlace, CUDAPlace  # noqa: E402
from .executor import (CheckpointConfig, Event, Executor, Inferencer, Scope,  # noqa: E402
                       Trainer, fit, global_scope, scope_guard)
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
from .parallel import DistStrategy  # noqa: E402
from .transpiler import (DistributeTranspiler, DistributeTranspilerConfig,  # noqa: E402
                         HashName, RoundRobin, memory_optimize, release_memory)
from .resilience import GuardPolicy  # noqa: E402

# honour PDTPU_DETERMINISTIC=1, as the JAX package does at import
if get_flag("deterministic"):
    enable_determinism()

__all__ = [
    "CPUPlace", "CUDAPlace", "CheckpointConfig", "DistStrategy", "DistributeTranspiler",
    "DistributeTranspilerConfig", "Event", "Executor", "GuardPolicy", "HashName",
    "Inferencer", "LayerHelper", "ParamAttr", "Program", "RoundRobin", "Scope", "Trainer",
    "WeightNormParamAttr", "amp", "amp_guard", "analysis", "append_backward", "backward",
    "build", "calc_gradient", "clip", "create_parameter", "create_variable", "data",
    "debugger", "default_main_program", "default_startup_program", "enable_determinism", "evaluator",
    "fit", "framework", "global_scope", "initializer", "io", "layers",
    "lr_scheduler", "memory_optimize", "metrics", "models", "name_scope", "nets",
    "optimizer", "parallel", "profiling", "program_guard", "quantize", "regularizer", "release_memory",
    "resilience", "scope_guard", "transpiler",
]
