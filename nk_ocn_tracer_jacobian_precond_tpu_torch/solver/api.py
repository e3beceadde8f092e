"""Solver facade: factor once, solve many right-hand sides.

Backends, as in the JAX package's ``solver/api.py``:

  * "scipy"        - host SuperLU (the reference package's
                     ScipyFactorization, imported as it is);
  * "multifrontal" - the port's multifrontal solver on a torch device, at
                     float64 or float32 factors ("auto" picks it).
"""

from __future__ import annotations

import torch

from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import SparseMatrix
from nk_ocn_tracer_jacobian_precond_tpu.solver.api import (  # noqa: F401
    ScipyFactorization, residual_norm)


def factor(matrix: SparseMatrix, backend: str = "auto",
           device: str | torch.device = "cuda", precision="f64", **kwargs):
    """Factor ``matrix`` with ``backend``; the multifrontal backend runs on
    ``device`` with ``precision`` factors ("f64", "f32" or "auto") and
    takes MultifrontalFactorization's other keyword arguments."""
    if backend == "auto":
        backend = "multifrontal"
    if backend == "scipy":
        return ScipyFactorization(matrix)
    if backend == "multifrontal":
        from .mf import MultifrontalFactorization
        return MultifrontalFactorization(matrix, device=device,
                                         precision=precision, **kwargs)
    raise ValueError(f"unknown solver backend: {backend}")
