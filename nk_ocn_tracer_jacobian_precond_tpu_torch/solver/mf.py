"""Multifrontal factorization facade: symbolic once, numeric per matrix,
solve per RHS batch, iterative refinement to direct-solver accuracy.

The port of the JAX package's ``solver/mf.py::MultifrontalFactorization``
on the torch engine (``mf_torch.TorchMultifrontal``). The symbolic
analysis and the Ruiz equilibration are the reference's own host code.
Every refined solve goes through the device refiner (``refine.py``,
FGMRES-IR3), as the JAX facade's solves do under x64; when float32 factors
leave the refiner hopeless, the facade refactors in float64 and solves
again.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import SparseMatrix
from nk_ocn_tracer_jacobian_precond_tpu.solver.memplan import plan_memory
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    _rel_residuals, equilibrate)
from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
    SymbolicFactorization, symbolic_from_matrix)
from nk_ocn_tracer_jacobian_precond_tpu.utils import dbg, timed

from ..device import resolve_device, resolve_precision
from .mf_torch import TorchMultifrontal
from .refine import DeviceRefiner


def _device_memory_limit(device: torch.device) -> int | None:
    """The card's total memory in bytes; None on the CPU, where the plan
    against host RAM is the memory plan's job, not the escalation's."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


class MultifrontalFactorization:
    """Factor ``matrix`` on ``device`` ("cuda" by default; "cpu" only when
    named) at ``precision`` ("f64" by default, "f32", or "auto": f32 on
    the card, f64 on the CPU) and solve it to a relative residual of
    100 * refine_tol. With float32 factors, a solve whose refinement gives
    up (raw preconditioner error above ``giveup``) refactors in float64
    and solves again, unless ``escalate`` is False; ``escalation`` then
    records the float32 attempt (its max relative residual and refiner
    stats). ``timings`` holds the seconds of each phase of the last
    factorization (symbolic, equilibrate, plan, factor; escalate once
    escalated)."""

    def __init__(self, matrix: SparseMatrix, leaf_size: int = 32,
                 refine_tol: float = 1e-13, maps=None,
                 sym: SymbolicFactorization | None = None,
                 device: str | torch.device = "cuda", precision="f64",
                 escalate: bool = True, giveup: float = 0.25):
        self.device = resolve_device(device)
        prec = resolve_precision(precision, self.device)
        self.matrix = matrix
        self.A = matrix.to_scipy()
        self.refine_tol = refine_tol
        self.escalate = escalate
        self.giveup = giveup
        self.timings: dict[str, float] = {}
        self._refiner = None
        self.escalation: dict | None = None
        if sym is None:
            if maps is None:
                raise ValueError(
                    "MultifrontalFactorization needs index maps (pass "
                    "maps=...) when constructed from a bare SparseMatrix")
            t0 = time.perf_counter()
            with timed("symbolic analysis"):
                sym = symbolic_from_matrix(maps, matrix, leaf_size=leaf_size)
            self.timings["symbolic"] = time.perf_counter() - t0
        self.sym = sym
        t0 = time.perf_counter()
        with timed("equilibration"):
            self._fac_matrix, self.dr, self.dc = equilibrate(matrix)
        self.timings["equilibrate"] = time.perf_counter() - t0
        with timed("numeric factorization (torch)"):
            self.engine = TorchMultifrontal(sym, self._fac_matrix,
                                            self.device, prec=prec)
        self.timings.update(self.engine.timings)

    def refactor(self, matrix: SparseMatrix | None = None) -> None:
        """Numeric refactorization with the same sparsity pattern (new
        Jacobian values each Newton iteration), at the engine's current
        precision. The old factors are freed before the new ones are
        built; the refiner keeps its memo and takes the new values."""
        if matrix is not None:
            self.matrix = matrix
            self.A = matrix.to_scipy()
            self._fac_matrix, self.dr, self.dc = equilibrate(matrix)
            if self._refiner is not None:
                self._refiner.rebind(self.matrix, dr=self.dr, dc=self.dc)
        with timed("numeric refactorization"):
            self.engine.refactor(self._fac_matrix)
        self.timings["factor"] = self.engine.timings["factor"]

    def validate(self) -> dict:
        """Raise FloatingPointError if any factor entry is not finite (a
        singular pivot block or overflow); else report the entry counts."""
        bad = 0
        total = 0
        for item in self.engine.factors or ():
            for t in item:
                if t.is_floating_point():
                    bad += int((~torch.isfinite(t)).sum())
                    total += t.numel()
        report = {"nonfinite_factor_entries": bad, "factor_entries": total}
        if bad:
            raise FloatingPointError(
                f"factorization produced {bad} non-finite entries "
                f"(singular pivot block or overflow): {report}")
        return report

    def _precond_solve(self, b: np.ndarray) -> np.ndarray:
        """Apply the (scaled) factorization: x ~= A^{-1} b."""
        scaled_b = self.dr[:, None] * b if b.ndim == 2 else self.dr * b
        y = np.asarray(self.engine.solve(scaled_b), dtype=np.float64)
        return self.dc[:, None] * y if y.ndim == 2 else self.dc * y

    def _device_refiner(self) -> DeviceRefiner:
        if self._refiner is None:
            self._refiner = DeviceRefiner(
                self.engine, self.matrix, dr=self.dr, dc=self.dc,
                tol=max(self.refine_tol, 1e-13), giveup=self.giveup)
        return self._refiner

    def _maybe_escalate_precision(self, rel: float) -> bool:
        """Refactor in float64 when float32 factors left a residual that no
        refinement tier repaired (eps32 x element growth is O(1) on deep
        trees). Returns True if the engine was rebuilt; False when
        escalation is off, the factors are float64 already, or float64
        factors would not fit the card (with a warning)."""
        if not self.escalate or self.engine.prec != torch.float32:
            return False
        peak = plan_memory(self.engine.plans, 1, 8).peak_per_device
        lim = _device_memory_limit(self.device)
        if lim and peak > 0.92 * lim:
            warnings.warn(
                f"float32 factors failed (max rel residual {rel:.3e}) but "
                f"float64 factors need ~{peak / 1e9:.1f} GB vs "
                f"~{lim / 1e9:.1f} GB on {self.device}: rerun with "
                f"precision='f64' on a larger card", RuntimeWarning,
                stacklevel=3)
            return False
        dbg(1, f"solve escalation: float32 factors left max relative "
               f"residual {rel:.3e} (> {100 * self.refine_tol:.1e}); "
               f"refactoring in float64")
        self.escalation = dict(max_rel=float(rel),
                               refiner=dict(self._refiner.stats))
        # free the float32 engine (factors, device constants) and the
        # refiner before the float64 build: both resident at once is an
        # avoidable OOM
        self.engine = self._refiner = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with timed("float64 escalation refactorization"):
            self.engine = TorchMultifrontal(self.sym, self._fac_matrix,
                                            self.device, prec=torch.float64)
        self.timings["escalate"] = time.perf_counter() - t0
        self.timings.update(self.engine.timings)
        return True

    def solve(self, b: np.ndarray, refine: bool = True) -> np.ndarray:
        b = np.asarray(b, dtype=np.float64)
        single = b.ndim == 1
        B = b[:, None] if single else b
        if not refine:
            with timed("mf solve"):
                X = self._precond_solve(B)
            return X[:, 0] if single else X
        X = self._device_refiner().solve(B)
        rel = _rel_residuals(self.A, X, B)
        if (rel.max() > 100 * self.refine_tol
                and self._maybe_escalate_precision(rel.max())):
            X = self._device_refiner().solve(B)
            rel = _rel_residuals(self.A, X, B)
        if rel.max() > 100 * self.refine_tol:
            warnings.warn(f"device GMRES-IR stalled at max relative "
                          f"residual {rel.max():.3e}", RuntimeWarning,
                          stacklevel=2)
        return X[:, 0] if single else X
