"""Three-precision flexible GMRES iterative refinement (FGMRES-IR3) on a
torch device.

The port of the JAX package's ``solver/refine.py::DeviceRefiner``. The
outer loop runs on the host with exact float64 residuals (scipy SpMV); the
corrections run on the engine's device, batched over all right-hand sides:

* **ir**: plain refinement, x += M^-1 r of the host residual (the
  reference's pdgsrfs), tried first;
* **gmres**: up to ``MAX_CYCLES`` restarted FGMRES cycles with float32
  Krylov vectors and the multifrontal solve as the preconditioner, its
  outputs stored (flexible GMRES: the correction is Z y, never a
  re-application of M^-1), Givens-QR least squares, and a float64
  device-side outer residual between cycles; the loop reads one number,
  the relative residual, back to the host per cycle;
* **polish**: single cycles fed the host-exact residual, when the iterate
  is within sight of the target;
* **gmres64**: the same cycles with float64 Krylov vectors, when float32
  cycles stall far from the target at full depth (m: ``M_START`` doubling
  to ``M_MAX`` first).

A raw preconditioner error above ``giveup`` after the first correction
ends the refinement at once: no Krylov tier repairs an O(1)-wrong float32
factorization, and the facade's escalation to float64 factors is the
repair. Depth, and the Krylov phase once plain refinement has stalled
far from the target, are memoized across solves of one factorization.
The refiner never returns an iterate worse than the best host-checked one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import dbg, timed

# FGMRES inner depth: the first cycles use M_START vectors, doubled up to
# M_MAX when a cycle gains under ~1.5 digits; a fused dispatch runs up to
# MAX_CYCLES restart cycles, a solve up to 3 * MAX_CYCLES outer steps
M_START = 4
M_MAX = 16
MAX_CYCLES = 10


def _givens_lstsq(H: torch.Tensor, beta: torch.Tensor, m: int):
    """Batched min ||beta e1 - H y|| for the small Hessenberg H (m + 1, m,
    nrhs) by Givens QR (backward stable; the normal equations would square
    kappa(H), which is large exactly when float32 factors with element
    growth precondition the Krylov basis). Returns y (m, nrhs)."""
    # cols[j][i] = H[i, j], rotated in place of the JAX version's .at[].set
    cols = [list(H[:, j].unbind(0)) for j in range(m)]
    g = [beta.to(H.dtype)] + [torch.zeros_like(beta, dtype=H.dtype)] * m
    cs, sn = [], []
    for j in range(m):
        col = cols[j]
        for i in range(j):
            a, b = col[i], col[i + 1]
            col[i] = cs[i] * a + sn[i] * b
            col[i + 1] = -sn[i] * a + cs[i] * b
        a, b = col[j], col[j + 1]
        r = torch.sqrt(a * a + b * b)
        ok = r > 0
        rs = torch.where(ok, r, 1.0)
        c = torch.where(ok, a / rs, 1.0)
        s = torch.where(ok, b / rs, 0.0)
        cs.append(c)
        sn.append(s)
        col[j], col[j + 1] = r, torch.zeros_like(r)
        ga, gb = g[j], g[j + 1]
        g[j], g[j + 1] = c * ga + s * gb, -s * ga + c * gb
    # back substitution on the upper-triangular R = H[:m, :m]
    y = [None] * m
    for j in range(m - 1, -1, -1):
        acc = g[j]
        for k in range(j + 1, m):
            acc = acc - cols[k][j] * y[k]
        d = cols[j][j]
        ok = d.abs() > 0
        y[j] = torch.where(ok, acc / torch.where(ok, d, 1.0), 0.0)
    return torch.stack(y)


class DeviceRefiner:
    """GMRES-IR3 driven from the host, with the Krylov corrections batched
    on ``engine.device`` (a mf_torch.TorchMultifrontal of either factor
    dtype). ``matrix`` is the unscaled system, ``dr``/``dc`` the
    equilibration the engine's factors were built with. ``stats`` reports
    the last solve: phases taken, plain-IR applies to the host residual
    ("host_applies"), device cycles, outer iterations, final depth, the max relative residual of
    every host-checked iterate ("rels") and of the one returned
    ("best_rel")."""

    def __init__(self, engine, matrix, dr=None, dc=None,
                 tol: float = 1e-12, giveup: float = 0.25):
        self.engine = engine
        self.device = engine.device
        self.tol = tol
        self.giveup = giveup
        self._m = M_START       # inner depth, memoized across solves
        self.n = matrix.flat_len
        self._rowptr = np.asarray(matrix.rowptr)
        self._phase = "ir"
        self.stats: dict = {}
        self._bind_matrix(matrix, dr, dc)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _bind_matrix(self, matrix, dr=None, dc=None) -> None:
        """Stage the matrix-value-dependent device tensors: the ELL
        (padded row-major) SpMV operands at both precisions, and the
        equilibration scalings."""
        n = self.n
        self.A = matrix.to_scipy()
        rowptr = self._rowptr
        rowlen = np.diff(rowptr)
        E = int(rowlen.max()) if n else 0
        nnz = len(matrix.colind)
        rows = np.repeat(np.arange(n, dtype=np.int64), rowlen)
        pos = np.arange(nnz, dtype=np.int64) - rowptr[rows]
        ell_col = np.full((n, E), n, dtype=np.int64)    # n -> zero pad row
        ell_val = np.zeros((n, E), dtype=np.float64)
        ell_col[rows, pos] = np.asarray(matrix.colind, dtype=np.int64)
        ell_val[rows, pos] = np.asarray(matrix.nzval, dtype=np.float64)
        self._ell_col = self._put(ell_col)
        self._ell_val64 = self._put(ell_val)
        self._ell_val32 = self._put(ell_val.astype(np.float32))
        one = np.ones(n)
        self._dr = self._put(np.asarray(dr if dr is not None else one,
                                        dtype=np.float64))
        self._dc = self._put(np.asarray(dc if dc is not None else one,
                                        dtype=np.float64))

    def rebind(self, matrix, dr=None, dc=None) -> None:
        """New matrix values on the identical sparsity pattern (the
        Newton-iteration reuse path): refresh the device operands."""
        if (matrix.flat_len != self.n
                or not np.array_equal(np.asarray(matrix.rowptr),
                                      self._rowptr)):
            raise ValueError("rebind requires the identical sparsity "
                             "pattern (new pattern => new DeviceRefiner)")
        self._bind_matrix(matrix, dr, dc)

    # -- device building blocks ---------------------------------------------

    def _spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x in x's precision (float64 or float32); x (n, nrhs)."""
        vals = (self._ell_val64 if x.dtype == torch.float64
                else self._ell_val32)
        xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        return (vals[:, :, None] * xp[self._ell_col]).sum(dim=1)

    def _precond(self, v: torch.Tensor) -> torch.Tensor:
        """M^-1 v: scale, solve in the factor dtype, unscale; the result
        comes back in v's dtype."""
        eng = self.engine
        r = (self._dr.to(v.dtype)[:, None] * v).to(eng.prec)
        W = eng.solve_workspace(torch.cat([r, r.new_zeros((1, r.shape[1]))]))
        return self._dc.to(v.dtype)[:, None] * W[:self.n].to(v.dtype)

    def _correct(self, R: np.ndarray) -> np.ndarray:
        """One plain-refinement correction M^-1 R of the host residual R
        (n, nrhs), float64 on the host."""
        return self._precond(self._put(R)).cpu().numpy()

    def _cycle(self, b: torch.Tensor, m: int, dtype: torch.dtype):
        """One restarted-FGMRES correction in ``dtype``: solve A d ~= b
        from zero and return d (n, nrhs). The caller owns the outer
        residual."""
        n, nrhs = b.shape
        beta = torch.linalg.vector_norm(b, dim=0)
        safe = torch.where(beta > 0, beta, 1.0)
        V = b.new_zeros((m + 1, n, nrhs), dtype=dtype)
        V[0] = (b / safe).to(dtype)
        Z = b.new_zeros((m, n, nrhs), dtype=dtype)
        H = b.new_zeros((m + 1, m, nrhs), dtype=dtype)
        for j in range(m):
            z = self._precond(V[j])
            Z[j] = z
            w = self._spmv(z)
            Vj = V[:j + 1]
            # classical Gram-Schmidt, two passes: one pass loses
            # orthogonality exactly when the preconditioned operator is
            # ill-conditioned, which is the use case
            for _ in range(2):
                coef = torch.einsum("inr,nr->ir", Vj, w)
                w = w - torch.einsum("inr,ir->nr", Vj, coef)
                H[:j + 1, j] += coef
            hnorm = torch.linalg.vector_norm(w, dim=0)
            H[j + 1, j] = hnorm
            V[j + 1] = w / torch.where(hnorm > 0, hnorm, 1.0)
        y = _givens_lstsq(H, beta, m)
        return torch.einsum("inr,ir->nr", Z, y)

    def _fused(self, b: torch.Tensor, X: torch.Tensor, m: int,
               dtype: torch.dtype):
        """Up to MAX_CYCLES cycles with a float64 device residual between
        them; exits early on reaching tol, or once a cycle contracts the
        residual by less than 4x (after the first two). Returns (X, the
        relative residual before the last correction, cycles run)."""
        bnorm = torch.linalg.vector_norm(b, dim=0)
        bnorm = torch.where(bnorm > 0, bnorm, 1.0)
        rel = prev = np.inf
        k = 0
        while (k < MAX_CYCLES and rel > self.tol
               and (rel < 0.25 * prev or k < 2)):
            R = b - self._spmv(X)
            rel_now = float((torch.linalg.vector_norm(R, dim=0)
                             / bnorm).max())
            X = X + self._cycle(R.to(dtype), m, dtype).to(b.dtype)
            prev, rel, k = rel, rel_now, k + 1
        return X, rel, k

    # -- host driver ---------------------------------------------------------

    def solve(self, B: np.ndarray) -> np.ndarray:
        """Solve A X = B to self.tol relative residual; B (n,) or (n, nrhs)
        float64 on the host."""
        B = np.asarray(B, dtype=np.float64)
        single = B.ndim == 1
        if single:
            B = B[:, None]
        X = np.zeros_like(B)
        bnorm = np.linalg.norm(B, axis=0)
        bnorm[bnorm == 0] = 1.0
        phase = self._phase
        applied_ir = False
        prev = np.inf
        stall = 0
        fused_stalled = False
        Bd = None    # device copy of the RHS, staged once
        Xd = None    # device iterate equal to X (fused outers)
        X_best, rel_best = X, np.inf
        stats = dict(phases=[], host_applies=0, cycles=0, outers=0,
                     rels=[])
        with timed("refine (gmres-ir3)"):
            for outer in range(3 * MAX_CYCLES):
                R = B - self.A @ X if X.any() else B
                rel = float((np.linalg.norm(R, axis=0) / bnorm).max())
                stats["outers"] = outer + 1
                stats["rels"].append(rel)
                dbg(1, f"refine outer {outer} ({phase}): max rel residual "
                       f"{rel:.3e}")
                if rel < rel_best:
                    rel_best, X_best = rel, X.copy()
                if rel <= self.tol:
                    break
                if (applied_ir or outer >= 1) and rel > self.giveup:
                    # the preconditioner itself is O(1) wrong: bail out so
                    # the facade refactors in float64
                    dbg(1, f"refine: preconditioner apply error {rel:.3e} "
                           f"> {self.giveup}: abandoning refinement")
                    break
                if phase == "ir" and applied_ir and rel > 0.1 * prev:
                    # plain refinement stalled: host-exact polish when the
                    # target is within sight, else fused Krylov corrections,
                    # memoized for later solves. (The JAX refiner memoizes
                    # "gmres" in both cases, so that every later solve of
                    # an f64 factorization pays a fused dispatch where 3
                    # plain steps and 1 polish cycle suffice.)
                    if rel <= 1e3 * self.tol:
                        phase = "polish"
                    else:
                        phase = self._phase = "gmres"
                elif phase == "gmres" and (fused_stalled
                                           or rel > 0.5 * prev):
                    if rel <= 1e3 * self.tol:
                        phase = "polish"
                    elif self._m < M_MAX:
                        self._m = min(2 * self._m, M_MAX)
                        dbg(1, f"refine: deepening inner cycle to "
                               f"m={self._m}")
                    else:
                        phase = "gmres64"
                        self._phase = "gmres64"
                        dbg(1, "refine: escalating inner cycle to float64")
                elif (phase == "gmres" and rel > 3e-2 * prev
                      and self._m < M_MAX):
                    # progressing by under ~1.5 digits a cycle: deepen
                    self._m = min(2 * self._m, M_MAX)
                    dbg(1, f"refine: deepening inner cycle to m={self._m}")
                elif phase == "polish" and (rel > 0.5 * prev
                                            or rel <= 3 * self.tol):
                    dbg(1, "refine: converged to the attainable floor")
                    break
                elif phase == "gmres64":
                    stall = stall + 1 if rel > 0.7 * prev else 0
                    if stall >= 2:
                        dbg(1, "refine: converged to the attainable floor")
                        break
                prev = rel
                stats["phases"].append(phase)
                if phase == "ir":
                    X = X + self._correct(R)
                    applied_ir = True
                    stats["host_applies"] += 1
                    Xd = None
                elif phase == "polish":
                    d = self._cycle(self._put(R.astype(np.float32)),
                                    self._m, torch.float32)
                    X = X + d.cpu().numpy().astype(np.float64)
                    stats["cycles"] += 1
                    Xd = None
                else:
                    dtype = (torch.float32 if phase == "gmres"
                             else torch.float64)
                    m_cur = self._m if phase == "gmres" else M_MAX
                    if Bd is None:
                        Bd = self._put(B)
                    if Xd is None:
                        Xd = (torch.zeros_like(Bd) if not X.any()
                              else self._put(X))
                    Xd, rel_est, k = self._fused(Bd, Xd, m_cur, dtype)
                    X = Xd.cpu().numpy()
                    fused_stalled = k < MAX_CYCLES and rel_est > self.tol
                    stats["cycles"] += k
                    dbg(1, f"refine: fused {k} x m={m_cur} cycles, device "
                           f"residual estimate {rel_est:.3e}")
        # an exhausted outer budget leaves the last correction unchecked:
        # give it its chance, then return the best iterate seen
        if outer == 3 * MAX_CYCLES - 1:
            R = B - self.A @ X
            rel = float((np.linalg.norm(R, axis=0) / bnorm).max())
            if rel < rel_best:
                rel_best, X_best = rel, X
        stats.update(m=self._m, best_rel=rel_best)
        self.stats = stats
        return X_best[:, 0] if single else X_best
