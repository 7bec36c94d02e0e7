"""Attention ops: the dense score product and the flash-attention kernel
(CUDA sources under ``csrc/``, built at first launch by ``_build``)."""
