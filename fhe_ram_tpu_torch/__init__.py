"""fhe_ram_tpu_torch -- the encrypted-RAM (FHE-RAM) framework on PyTorch
and CUDA.

Same layout as the JAX package it was ported from (ops/ core/ ram/ vm/ utils/), so
a module here is the counterpart of the module of the same name there.
Plain tensor code is PyTorch; the hot kernels are hand-written CUDA
(csrc/, built at first use by ops/ntt_cuda.py).  Entry points take an
explicit `device`; the default is the GPU.
"""

from .params import (  # noqa: F401
    Params,
    PARAMS_README_2_18,
    PARAMS_CODE_2_14,
    PARAMS_2_18_TURBO_READOPT,
    PARAMS_TEST_SMALL,
    PARAMS_TEST_FLAT,
)

__version__ = "0.1.0"
