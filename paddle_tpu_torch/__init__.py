"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package keeps ``paddle_tpu``'s module layout and public names so each
module's counterpart is easy to find, and it keeps the JAX package's
parameter names and layouts, so a parameter dict moves between the two as
numpy arrays. It imports ``torch`` and numpy only; every CUDA kernel is
built at its first launch (``ops/_build.py``), never at import.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card they raise
:class:`paddle_tpu_torch.core.place.NoCudaDevice`.
"""

__version__ = "0.1.0"
