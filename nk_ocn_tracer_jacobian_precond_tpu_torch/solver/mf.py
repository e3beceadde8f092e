"""Multifrontal factorization facade: symbolic once, numeric per matrix,
solve per RHS batch, iterative refinement to direct-solver accuracy.

The port of the JAX package's ``solver/mf.py::MultifrontalFactorization``
on the torch engine (``mf_torch.TorchMultifrontal``, ``impl="torch"``) or
the host engine (``mf_numpy.NumpyMultifrontal``, ``impl="numpy"``). The
Ruiz equilibration (``equilibrate``) and ``_rel_residuals`` are copies of
the reference's host code, as is the symbolic analysis (``symbolic.py``).
Every refined solve on the torch engine goes through the device refiner
(``refine.py``, FGMRES-IR3), as the JAX facade's solves do under x64; when
float32 factors leave the refiner hopeless, the facade refactors in
float64 and solves again. The host engine refines as the JAX facade's host
branch does: plain refinement, then scipy GMRES-IR.

With ``n_devices`` above 1 or a ``mesh`` (the distributed mode, the
reference's solve_ABdist), the torch engine shards the factorization over
the ranks of a torch.distributed mesh (mf_torch's module docstring). Every
rank builds the facade with the same arguments and calls it in step: its
refinement and escalation decisions are taken on values that every rank
holds equal (the gathered solves, and the residuals of them, which every
rank's refiner sums in one fixed order), so the ranks take the same
branches and meet at the same collectives.
"""

from __future__ import annotations

import os
import time
import warnings
import zipfile

import numpy as np
import torch

from ..device import resolve_device, resolve_precision
from ..io.matrixfile import SparseMatrix
from ..parallel.mesh import make_mesh
from ..utils import dbg, timed
from ..utils.profiling import span
from .api import iterative_refinement
from .checkpoint import load_factors, save_factors
from .memplan import plan_memory
from .mf_numpy import NumpyMultifrontal
from .mf_torch import TorchMultifrontal
from .refine import DeviceRefiner
from .symbolic import SymbolicFactorization, symbolic_from_matrix


def equilibrate(matrix: SparseMatrix, ruiz_iters: int = 8):
    """Iterated (Ruiz) row/column equilibration, powers of two.

    The rebuild of SuperLU's dgsequ/dlaqgs scaling step (which the
    reference's pdgssvx drivers run by default), strengthened: instead of
    one row-max pass then one column-max pass, scale both sides by
    1/sqrt(max|.|) repeatedly until every row and column max is within
    [1/2, 2]. Simultaneous convergence on both sides measurably reduces
    no-pivot element growth in the float32 factorization at depth
    (60-level problems), which is what bounds the refinement cycle count.
    Scaling by exact powers of two keeps the scaled entries
    bit-representable. Returns (scaled_matrix, dr, dc) with
    (Dr A Dc) y = Dr b, x = Dc y."""
    from scipy.sparse import csr_matrix

    A = matrix.to_scipy().tocsr()
    n = A.shape[0]
    rowcnt = np.diff(A.indptr)
    rows = np.repeat(np.arange(n), rowcnt)
    cols = A.indices
    a = np.abs(A.data)
    la0 = np.log2(np.where(a > 0, a, 1.0))
    ldr = np.zeros(n)
    ldc = np.zeros(n)
    # segment maxima via sort + reduceat: rows are CSR-sorted already;
    # columns get one reusable argsort. np.maximum.at was ~10x slower
    # (ufunc.at is scalar-dispatched) and equilibration sat at 18s of the
    # gx3 cold factor — this form is a few hundred ms
    row_ptr = A.indptr[:-1].astype(np.int64)
    row_has = rowcnt > 0
    col_order = np.argsort(cols, kind="stable")
    cols_sorted = cols[col_order]
    col_cnt = np.bincount(cols_sorted, minlength=n)
    col_ptr = (np.cumsum(col_cnt) - col_cnt).astype(np.int64)
    col_has = col_cnt > 0

    def _seg_max(vals, order, ptr, has):
        v = vals[order] if order is not None else vals
        out = np.zeros(n)
        # reduceat needs strictly valid segment starts: clamp empty
        # segments' starts and zero them after
        safe = np.minimum(ptr, max(len(v) - 1, 0))
        if len(v):
            out = np.maximum.reduceat(v, safe)
        out[~has] = 0.0
        return out

    for _ in range(ruiz_iters):
        la = la0 - ldr[rows] - ldc[cols]
        rmax = _seg_max(la, None, row_ptr, row_has)
        cmax = _seg_max(la, col_order, col_ptr, col_has)
        if max(np.abs(rmax).max(initial=0.0),
               np.abs(cmax).max(initial=0.0)) <= 1.0:
            break
        # simultaneous sqrt steps (Ruiz): both sides move by half their
        # log-deviation each sweep, which contracts geometrically where
        # full alternating steps oscillate on rows/columns that share
        # extreme entries
        ldr += rmax / 2
        ldc += cmax / 2
    dr = np.exp2(-np.round(ldr))
    dc = np.exp2(-np.round(ldc))
    data = A.data * dr[rows] * dc[cols]
    As = csr_matrix((data, A.indices, A.indptr), shape=A.shape)
    scaled = SparseMatrix(nzval=As.data, colind=As.indices.astype(np.int64),
                          rowptr=As.indptr.astype(np.int64),
                          coupled_tracer_cnt=matrix.coupled_tracer_cnt)
    return scaled, dr, dc


def _rel_residuals(A, X, B) -> np.ndarray:
    r = B - A @ X
    bn = np.linalg.norm(B, axis=0)
    bn[bn == 0] = 1.0
    return np.linalg.norm(r, axis=0) / bn


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
    100 * refine_tol. ``impl="numpy"`` factors on the host instead
    (float64, ``mf_numpy.NumpyMultifrontal``; ``device``, ``precision``,
    escalation and checkpoints do not apply, and a ``numeric_checkpoint``
    is neither read nor written, with a warning). ``equilibrate_matrix``
    False factors the matrix as it is: no Ruiz scaling, ``dr`` and ``dc``
    None, and ``refactor`` scales no new values either. With float32
    factors, a solve whose refinement gives up (raw preconditioner error
    above ``giveup``) refactors in float64 and solves again, unless
    ``escalate`` is False; ``escalation`` then
    records the float32 attempt (its max relative residual and refiner
    stats). ``factor_checkpoint_dir`` gives the engine per-round factor
    checkpoints there (mf_torch.TorchMultifrontal: resume, offload).
    ``numeric_checkpoint`` names a whole-set factor file
    (checkpoint.save_factors): loaded in place of the numeric phase when it
    exists and matches the matrix (its factors cast to the engine's dtype),
    else written after factoring. ``timings`` holds the seconds of each
    phase of the last factorization (symbolic, equilibrate, plan, factor or
    load_factors; escalate once escalated; to_scipy and rebind after a
    refactor with new values).

    ``n_devices`` above 1 makes the mesh ``make_mesh(n_devices,
    ("front",), rhs_devices=rhs_devices)`` over the ranks of the default
    process group (a ValueError "requested N devices, have M" when the
    world is smaller); ``mesh`` passes one made already. Either way the
    torch engine shards its rounds over the mesh, and ``device`` is this
    rank's. ``mem_budget_bytes`` and ``row_shard_min`` go to the engine
    (mf_torch.TorchMultifrontal)."""

    def __init__(self, matrix: SparseMatrix, leaf_size: int = 32,
                 refine_tol: float = 1e-13, maps=None,
                 sym: SymbolicFactorization | None = None,
                 device: str | torch.device = "cuda", precision="f64",
                 escalate: bool = True, giveup: float = 0.25,
                 factor_checkpoint_dir: str | None = None,
                 numeric_checkpoint: str | None = None,
                 impl: str = "torch", equilibrate_matrix: bool = True,
                 n_devices: int | None = None, mesh=None,
                 rhs_devices: int = 1, mem_budget_bytes: float = 1.5e9,
                 row_shard_min: int = 1024):
        if impl not in ("torch", "numpy"):
            raise ValueError(f"unknown multifrontal impl: {impl}")
        if mesh is None and n_devices is not None and n_devices > 1:
            # the distributed mode (the reference's -n nprow,npcol): a
            # parallelism flag that cannot be honoured raises
            mesh = make_mesh(n_devices, ("front",), rhs_devices=rhs_devices)
        if mesh is not None and impl != "torch":
            raise ValueError("a mesh needs the torch engine (impl='torch')")
        self.mesh = mesh
        self._engine_kw = dict(mesh=mesh, mem_budget_bytes=mem_budget_bytes,
                               row_shard_min=row_shard_min)
        self.impl = impl
        self.device = resolve_device(device) if impl == "torch" else None
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
        self.equilibrate_matrix = equilibrate_matrix
        t0 = time.perf_counter()
        with timed("equilibration"):
            self._fac_matrix, self.dr, self.dc = self._scaled(matrix)
        self.timings["equilibrate"] = time.perf_counter() - t0
        if impl == "numpy":
            if numeric_checkpoint is not None:
                warnings.warn(
                    "numeric_checkpoint (--factors) is only supported by the "
                    "torch engine; the numpy engine will factor from scratch "
                    "and NOT save/load the file", RuntimeWarning,
                    stacklevel=2)
            t0 = time.perf_counter()
            with timed("numeric factorization (numpy)"):
                self.engine = NumpyMultifrontal(sym, self._fac_matrix)
            self.timings["factor"] = time.perf_counter() - t0
            return
        prec = resolve_precision(precision, self.device)
        loadable = (numeric_checkpoint is not None
                    and os.path.exists(numeric_checkpoint))
        with timed("numeric factorization (torch)"):
            self.engine = TorchMultifrontal(
                sym, self._fac_matrix, self.device, prec=prec,
                checkpoint_dir=factor_checkpoint_dir,
                factorize=not loadable, **self._engine_kw)
        loaded = loadable and self._load_factors(numeric_checkpoint)
        if numeric_checkpoint is not None and not loaded:
            save_factors(numeric_checkpoint, self)
            dbg(1, f"numeric factors saved to {numeric_checkpoint}")
        self.timings.update(self.engine.timings)

    def _scaled(self, matrix: SparseMatrix):
        """(the matrix the engine factors, dr, dc): the Ruiz-equilibrated
        matrix with its scalings, or ``matrix`` itself and None, None when
        ``equilibrate_matrix`` is False."""
        if not self.equilibrate_matrix:
            return matrix, None, None
        return equilibrate(matrix)

    def _load_factors(self, path: str) -> bool:
        """Load the factor file at ``path``; when it is rejected (stale
        values, another pattern or pack block size, an unreadable file),
        log why and factor instead. Returns whether it loaded."""
        t0 = time.perf_counter()
        try:
            load_factors(path, self)
        except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:
            dbg(1, f"factor checkpoint rejected ({type(e).__name__}: {e}); "
                   f"refactoring")
            self.engine.refactor(self._fac_matrix)
            return False
        self.timings["load_factors"] = time.perf_counter() - t0
        dbg(1, f"numeric factors loaded from {path}")
        return True

    def refactor(self, matrix: SparseMatrix | None = None) -> None:
        """Numeric refactorization with the same sparsity pattern (new
        Jacobian values each Newton iteration), at the engine's current
        precision. The old factors are freed before the new ones are
        built; the refiner keeps its memo and takes the new values. With a
        new matrix, ``timings`` splits the host passes (to_scipy,
        equilibrate, the refiner's rebind) from the engine's factor."""
        if matrix is not None:
            t0 = time.perf_counter()
            self.matrix = matrix
            with span("mf.to_scipy"):
                self.A = matrix.to_scipy()
            t1 = time.perf_counter()
            with span("mf.equilibrate"):
                self._fac_matrix, self.dr, self.dc = self._scaled(matrix)
            t2 = time.perf_counter()
            if self._refiner is not None:
                with span("mf.rebind"):
                    self._refiner.rebind(self.matrix, dr=self.dr, dc=self.dc)
            self.timings.update(to_scipy=t1 - t0, equilibrate=t2 - t1,
                                rebind=time.perf_counter() - t2)
        t0 = time.perf_counter()
        with span("mf.factor"), timed("numeric refactorization"):
            if self.impl == "numpy":
                self.engine._factorize(self._fac_matrix)
            else:
                self.engine.refactor(self._fac_matrix)
        self.timings["factor"] = (time.perf_counter() - t0
                                  if self.impl == "numpy"
                                  else self.engine.timings["factor"])

    def validate(self) -> dict:
        """Raise FloatingPointError if any factor entry is not finite (a
        singular pivot block or overflow); else report the entry counts."""
        bad = 0
        total = 0
        factors = self.engine.factors or ()
        if isinstance(factors, dict):       # NumpyMultifrontal: FrontFactors
            factors = [tuple(torch.from_numpy(a) for a in (f.lu11, f.L21,
                                                           f.U12))
                       for f in factors.values()]
        for item in factors:
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
        if self.dr is None:
            return np.asarray(self.engine.solve(b), dtype=np.float64)
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
        peak = plan_memory(self.engine.plans, self.engine.ndev, 8,
                           row_shard_min=self.engine.row_shard_min
                           ).peak_per_device
        lim = _device_memory_limit(self.device)
        if lim and peak > 0.92 * lim:
            warnings.warn(
                f"float32 factors failed (max rel residual {rel:.3e}) but "
                f"float64 factors need ~{peak / 1e9:.1f} GB vs "
                f"~{lim / 1e9:.1f} GB on {self.device}: rerun with "
                f"precision='f64' on a larger card", RuntimeWarning,
                stacklevel=4)
            return False
        with span("mf.escalate"):
            dbg(1, f"solve escalation: float32 factors left max relative "
                   f"residual {rel:.3e} (> {100 * self.refine_tol:.1e}); "
                   f"refactoring in float64")
            self.escalation = dict(max_rel=float(rel),
                                   refiner=dict(self._refiner.stats))
            # free the float32 engine (factors, device constants) and the
            # refiner before the float64 build: both resident at once is an
            # avoidable OOM
            ckpt_dir = self.engine._ckpt_dir
            self.engine = self._refiner = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with timed("float64 escalation refactorization"):
                self.engine = TorchMultifrontal(
                    self.sym, self._fac_matrix, self.device,
                    prec=torch.float64, checkpoint_dir=ckpt_dir,
                    **self._engine_kw)
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
        with span("mf.solve"):
            X = (self._host_refined_solve(B) if self.impl == "numpy"
                 else self._device_refined_solve(B))
        return X[:, 0] if single else X

    def _device_refined_solve(self, B: np.ndarray) -> np.ndarray:
        """The device refiner's solve, judged by the relative residuals the
        refiner took of the iterate it returns (float64, or long double
        where it took that pass); escalated to float64 factors when float32
        ones leave it short of the target."""
        refiner = self._device_refiner()
        X = refiner.solve(B)
        rel = float(np.max(refiner.stats["best_rels"]))
        if (rel > 100 * self.refine_tol
                and self._maybe_escalate_precision(rel)):
            refiner = self._device_refiner()
            X = refiner.solve(B)
            rel = float(np.max(refiner.stats["best_rels"]))
        if rel > 100 * self.refine_tol:
            warnings.warn(f"device GMRES-IR stalled at max relative "
                          f"residual {rel:.3e}", RuntimeWarning,
                          stacklevel=3)
        return X

    def _host_refined_solve(self, B: np.ndarray) -> np.ndarray:
        """The JAX facade's host branch (its solve without x64): plain
        refinement, then scipy GMRES-IR with the factorization as the
        preconditioner and a plain-refinement polish, warning if the
        target is still missed."""
        with timed("mf solve"):
            X = self._precond_solve(B)
        with timed("mf refine"):
            X = iterative_refinement(self.A, self._precond_solve, B, X,
                                     tol=self.refine_tol)
        rel = _rel_residuals(self.A, X, B)
        if rel.max() > 100 * self.refine_tol:
            with timed("mf gmres-ir"):
                X = self._gmres_ir(B, X)
                X = iterative_refinement(self.A, self._precond_solve, B, X,
                                         tol=self.refine_tol)
            rel = _rel_residuals(self.A, X, B)
            if rel.max() > 100 * self.refine_tol:
                warnings.warn(
                    f"solve did not reach target accuracy: max relative "
                    f"residual {rel.max():.3e} > "
                    f"{100 * self.refine_tol:.1e} after GMRES-IR "
                    f"(ill-conditioned matrix or factorization breakdown)",
                    RuntimeWarning, stacklevel=3)
        return X

    def _gmres_ir(self, B: np.ndarray, X0: np.ndarray) -> np.ndarray:
        from scipy.sparse.linalg import LinearOperator, gmres
        n = self.A.shape[0]
        M = LinearOperator((n, n), matvec=lambda v: self._precond_solve(v))
        X = np.empty_like(X0)
        for j in range(B.shape[1]):
            x, info = gmres(self.A, B[:, j], x0=X0[:, j], M=M,
                            rtol=self.refine_tol, restart=30, maxiter=20)
            X[:, j] = x
            if info != 0:
                warnings.warn(f"gmres-ir did not converge for rhs {j} "
                              f"(info={info})", RuntimeWarning, stacklevel=2)
            dbg(1, f"gmres-ir rhs {j}: info={info}")
        return X
