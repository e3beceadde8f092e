"""Out-of-core triangular solve over per-round factor checkpoints.

The port's copy of the JAX package's ``solver/stream_solve.py``. The
production 1-degree problem's float64 factor set (~88 GB trimmed, ~144 GB
padded) exceeds one card's memory. Here the numeric factorization streams
to per-round checkpoints (``mf_torch.TorchMultifrontal`` with
``factor_only=True``: offload, v3 trimmed format of ``checkpoint.py``), and
the solve walks those files on the host, forward substitution in round
order and backward in reverse, touching one round's factors at a time.
Peak memory is one round's trimmed blocks plus the (n, nrhs) workspace;
each preconditioner application costs two sequential passes over the
factor files (disk-bandwidth bound).

Each front's substitutions are the engine's own
(mf_torch.block_lower_apply / block_upper_apply, on float64 CPU tensors):
this module reads nothing of the packed pivot-block layout itself, which
only mf_torch's solve-side building blocks (and checkpoint's identity
padding) know. U12 = L11^-1 P A12; L21 = A21 U11^-1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import dbg, timed
from .checkpoint import stored_dtype
from .mf import equilibrate
from .mf_torch import (TorchMultifrontal, block_lower_apply,
                       block_upper_apply)


def _front_apply(substitute, K: np.ndarray, rhs: np.ndarray, bs: int):
    """``substitute`` (block_lower_apply or block_upper_apply) on one
    front's packed pivot factor K (p, p) and rhs (p, nrhs), float64 on the
    CPU; a float32 round file's K is upcast exactly."""
    Kt = torch.from_numpy(np.asarray(K, dtype=np.float64))[None]
    return substitute(Kt, torch.from_numpy(rhs)[None], bs)[0].numpy()


class StreamSolver:
    """Solve A x = b from on-disk per-round factor checkpoints.

    Parameters mirror the engine that WROTE the checkpoints: the same
    symbolic factorization, plans, pack block size, and (equilibrated)
    matrix values — validated against the files' nzhash by the caller
    (FactorRoundCheckpointer.scan)."""

    def __init__(self, ckpt, sym, plans, pack_bs: int, flat_len: int):
        self.ckpt = ckpt
        self.sym = sym
        self.plans = plans
        self.bs = int(pack_bs)
        self.n = int(flat_len)

    def _round_fronts(self, rnd: int, plan):
        """Yield (front, K, U12, L21, perm) per real batch entry of a
        round, reading the trimmed v3 blocks directly (no padded
        reconstruction — the whole point is not materializing padding)."""
        path = self.ckpt._path(rnd)
        with np.load(path, allow_pickle=False) as z:
            perm_all = z["perm"]
            if "blocks" in z.files:
                pm = z["pm"]
                blocks = z["blocks"]
                off = 0
                for b, nid in enumerate(plan.node_ids):
                    p, m = int(pm[b, 0]), int(pm[b, 1])
                    K = blocks[off:off + p * p].reshape(p, p)
                    off += p * p
                    if m:
                        U12 = blocks[off:off + p * m].reshape(p, m)
                        off += p * m
                        L21 = blocks[off:off + m * p].reshape(m, p)
                        off += m * p
                    else:
                        U12 = np.zeros((p, 0)); L21 = np.zeros((0, p))
                    yield (self.sym.fronts[nid], K, U12, L21,
                           perm_all[b, :p])
            else:                       # v2 padded fallback
                FP = z["FP"]
                L21_all = z["L21"]
                for b, nid in enumerate(plan.node_ids):
                    f = self.sym.fronts[nid]
                    p, m = f.p, f.n - f.p
                    yield (f, FP[b, :p, :p], FP[b, :p, plan.P:plan.P + m],
                           L21_all[b, :m, :p], perm_all[b, :p])

    def apply(self, b: np.ndarray) -> np.ndarray:
        """x = A^-1 b (the equilibrated system's A) — one forward pass in
        round order, one backward pass in reverse, each streaming every
        round's factor file exactly once."""
        single = b.ndim == 1
        W = np.asarray(b, dtype=np.float64)
        if single:
            W = W[:, None]
        W = W.copy()
        for rnd, plan in enumerate(self.plans):
            for f, K, U12, L21, perm in self._round_fronts(rnd, plan):
                cells = np.asarray(f.cells)
                own = cells[:f.p]
                y = _front_apply(block_lower_apply, K, W[own][perm],
                                 self.bs)
                W[own] = y
                if f.n > f.p:
                    W[cells[f.p:]] -= L21 @ y
        for rnd in range(len(self.plans) - 1, -1, -1):
            plan = self.plans[rnd]
            for f, K, U12, L21, perm in self._round_fronts(rnd, plan):
                cells = np.asarray(f.cells)
                own = cells[:f.p]
                rhs = W[own]
                if f.n > f.p:
                    rhs = rhs - U12 @ W[cells[f.p:]]
                W[own] = _front_apply(block_upper_apply, K, rhs, self.bs)
        return W[:, 0] if single else W


def stream_solve(matrix, maps, sym, ckpt_dir: str, B: np.ndarray,
                 pack_bs: int = 128, refine_tol: float = 1e-10,
                 max_iters: int = 8, mem_budget_bytes: float = 1.5e9):
    """End-to-end out-of-core solve: equilibrate, validate the on-disk
    checkpoints against the matrix values, stream-apply, refine with
    exact float64 residuals (scipy SpMV). Returns (X, rel_residuals).

    ``pack_bs`` and ``mem_budget_bytes`` are the writer engine's
    ``_pack_bs`` and plan budget; its factor dtype is read from the round
    files. All three enter the checkpoint key. The solve runs on the host;
    no device is touched."""
    fac_matrix, dr, dc = equilibrate(matrix)
    stored = stored_dtype(ckpt_dir)
    prec = torch.float32 if stored == np.float32 else torch.float64
    # a factorize=False engine reproduces the plans + checkpoint key the
    # factor pass used (same nzhash: equilibrate is deterministic); it
    # uploads no plan constants. _pack_bs is forced to the WRITER's block
    # size after construction: the writer may have had its own reason
    # for another width, and the width keys the checkpoints
    eng = TorchMultifrontal(sym, fac_matrix, torch.device("cpu"),
                            factorize=False, prec=prec,
                            checkpoint_dir=ckpt_dir,
                            mem_budget_bytes=mem_budget_bytes)
    eng._pack_bs = int(pack_bs)
    ck = eng._ckpt_for(fac_matrix)
    done = ck.scan(eng.plans)
    if len(done) != len(eng.plans):
        raise RuntimeError(
            f"checkpoint dir {ckpt_dir} holds {len(done)}/{len(eng.plans)} "
            f"valid rounds — cannot stream-solve an incomplete factor set")
    solver = StreamSolver(ck, sym, eng.plans, eng._pack_bs, eng.flat_len)

    A = matrix.to_scipy().tocsr()
    single = B.ndim == 1
    Bm = B[:, None] if single else B
    bnorm = np.linalg.norm(Bm, axis=0)
    bnorm[bnorm == 0] = 1.0

    def precond(r):
        scaled = dr[:, None] * r if dr is not None else r
        y = solver.apply(scaled)
        return dc[:, None] * y if dc is not None else y

    X = np.zeros_like(Bm, dtype=np.float64)
    rel = np.ones(Bm.shape[1])
    for it in range(max_iters):
        R = Bm - A @ X if X.any() else Bm
        rel = np.linalg.norm(R, axis=0) / bnorm
        dbg(1, f"stream-solve outer {it}: max rel residual {rel.max():.3e}")
        if rel.max() <= refine_tol:
            break
        with timed(f"stream apply {it}"):
            X = X + precond(R)
    R = Bm - A @ X
    rel = np.linalg.norm(R, axis=0) / bnorm
    return (X[:, 0] if single else X), rel
