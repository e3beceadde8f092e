"""Multifrontal numeric phase in PyTorch: factor and multi-RHS solve.

The port of the JAX package's ``solver/mf_jax.py`` single-device engine.
The factorization runs the round plans of ``plan.build_plan`` in
dependency order; each round is a batch of padded dense fronts (B, N, N):

1. assembly from the CSR values (``cuda_kernels.ell_assemble``, kernel K3);
2. extend-add of the children's Schur complements (``extend_add``);
3. blocked LU of the pivot block with partial pivoting restricted to the
   fully-summed rows (``partial_factor``: the panel kernel
   ``cuda_kernels.pivoted_panel``, K1 at f64 and K2 at f32, which also
   returns the panel's row permutation; TRSM, trailing GEMM), or the
   library LU for rounds of at most two fronts;
4. packing of the pivot block's diagonal-block inverses for the solve.

The stored factors per round are K (B, P, P) (the ``pack_diag_inv``
layout), U12 (B, P, M), L21 (B, M, P) and perm (B, P). The solve walks
the rounds forward then backward over a (flat_len + 1, nrhs) workspace
whose last row takes every pad index. Factors, Schur stacks and the
workspace are in the engine's factor dtype ``prec`` (float64, or float32);
rounds with P >= HI_ROUND_MIN_P run their substitutions in float64 on
float32 factors.

Index tensors go to the device once, as int64 (p_arr, a count, as int32).
Functions that take F update it in place where that saves memory, and say
so.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..io.matrixfile import SparseMatrix
from ..utils import dbg, timed
from . import cuda_kernels as ck
from .memplan import plan_memory
from .plan import build_plan
from .symbolic import SymbolicFactorization

PANEL = 128
# float32 engines run the substitutions of rounds with P >= this in float64
# (mf_jax.JaxMultifrontal._hi_round): element growth concentrates in the
# tree-top rounds, and their sequential block chains would otherwise
# accumulate eps32 error on top of the factors' own rounding
HI_ROUND_MIN_P = 4096
NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


# --------------------------------------------------------------------------
# factor-side building blocks
# --------------------------------------------------------------------------

def _ea_chunk_len(N: int, Mp1: int, itemsize: int) -> int:
    """Link-chunk length bounding extend-add's temporaries to ~0.5 GB."""
    return max(1, int(5e8 / (itemsize * N * Mp1)))


def link_waves(dst_slots: np.ndarray):
    """Order the links of one child group into waves of distinct dst slots:
    wave w holds the w-th link (in link order) of every dst front. Returns
    (order, bounds): the links' new order and the waves' [start, stop)
    ranges in it. Adding the waves one after another sums each front's
    children in link order, as a sequential scatter-add does, and every
    index_add_ then has distinct indices: the sum is the same on every
    run, on the CPU and on CUDA."""
    ds = np.asarray(dst_slots, dtype=np.int64)
    rank = np.zeros(len(ds), dtype=np.int64)
    seen: dict[int, int] = {}
    for i, d in enumerate(ds.tolist()):
        rank[i] = seen.get(d, 0)
        seen[d] = rank[i] + 1
    order = np.argsort(rank, kind="stable")
    counts = np.bincount(rank) if len(ds) else np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    bounds = [(int(e - c), int(e)) for c, e in zip(counts, ends)]
    return order, bounds


def extend_add(F, S_src, src_slots, dst_slots, inv, waves):
    """F[dst_slots[l]] += S_src[src_slots[l]][inv[l]][:, inv[l]], in place.

    S is padded by a zero row and column, so positions outside the child's
    border (inv == M_src) add nothing. ``waves`` lists the [start, stop)
    link ranges of ``link_waves``, added in turn: a front with several
    children in one source round sums them in link order, and no
    index_add_ sees a duplicate index (on CUDA its atomics would sum
    duplicates in an order that varies between runs)."""
    Bs, M, _ = S_src.shape
    Mp1 = M + 1
    N = inv.shape[1]
    Sp = S_src.new_zeros((Bs, Mp1, Mp1))
    Sp[:, :M, :M] = S_src
    Lc = _ea_chunk_len(N, Mp1, F.element_size())
    for start, stop in waves:
        for lo in range(start, stop, Lc):
            hi = min(lo + Lc, stop)
            iv = inv[lo:hi]
            rows = Sp[src_slots[lo:hi, None], iv]            # (Lc, N, M+1)
            adds = torch.gather(rows, 2,
                                iv[:, None, :].expand(hi - lo, N, N))
            F.index_add_(0, dst_slots[lo:hi], adds)
    return F


def pack_diag_inv(LU, bs: int = PANEL):
    """Copy of a packed LU (B, P, P) whose bs-sized diagonal blocks are
    replaced by stril(L_ii^-1, -1) + triu(U_ii^-1); the off-diagonal blocks
    keep the raw L and U values. The layout the block substitutions read."""
    B, Pdim, _ = LU.shape
    out = LU.clone()
    for o in range(0, Pdim, bs):
        T = min(bs, Pdim - o)
        Ti = LU[:, o:o + T, o:o + T]
        eye = torch.eye(T, dtype=LU.dtype, device=LU.device).expand(B, T, T)
        Li = torch.linalg.solve_triangular(Ti, eye, upper=False,
                                           unitriangular=True)
        Ui = torch.linalg.solve_triangular(Ti, eye, upper=True)
        out[:, o:o + T, o:o + T] = torch.tril(Li, -1) + torch.triu(Ui)
    return out


def block_lower_apply(K, rhs, bs: int = PANEL):
    """y = L11^-1 rhs by block forward substitution; K in the
    pack_diag_inv layout (only its leading (P, P) block is read), rhs
    (B, P, nrhs)."""
    Pdim = rhs.shape[1]
    ys = []
    for o in range(0, Pdim, bs):
        T = min(bs, Pdim - o)
        t = rhs[:, o:o + T]
        if o:
            t = t - K[:, o:o + T, :o] @ torch.cat(ys, dim=1)
        KD = K[:, o:o + T, o:o + T]
        ys.append(t + torch.tril(KD, -1) @ t)
    return torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]


def block_upper_apply(K, rhs, bs: int = PANEL):
    """x = U11^-1 rhs by block backward substitution (layout as above)."""
    Pdim = rhs.shape[1]
    xs = []
    for o in reversed(range(0, Pdim, bs)):
        T = min(bs, Pdim - o)
        t = rhs[:, o:o + T]
        if xs:
            t = t - K[:, o:o + T, o + T:Pdim] @ torch.cat(xs, dim=1)
        KD = K[:, o:o + T, o:o + T]
        xs.insert(0, torch.triu(KD) @ t)
    return torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]


def block_upper_apply_right(K, rhs, bs: int = PANEL):
    """X = rhs @ U11^-1 by block forward substitution over column blocks;
    rhs (B, M, P)."""
    Pdim = rhs.shape[2]
    xs = []
    for o in range(0, Pdim, bs):
        T = min(bs, Pdim - o)
        t = rhs[:, :, o:o + T]
        if o:
            t = t - torch.cat(xs, dim=2) @ K[:, :o, o:o + T]
        KD = K[:, o:o + T, o:o + T]
        xs.append(t @ torch.triu(KD))
    return torch.cat(xs, dim=2) if len(xs) > 1 else xs[0]


def finish_factor(F, lu, perm, P: int, pack_bs: int = PANEL):
    """Tail of the partial factorization once the pivot block's packed LU
    and row permutation are known: pack the diagonal-block inverses, form
    U12 and L21 by block substitution, Schur-update the border. Returns
    (K, U12, L21, S, perm), each in its own storage."""
    Bb, N = F.shape[0], F.shape[-1]
    K = pack_diag_inv(lu, pack_bs)
    if N > P:
        F12p = torch.gather(F[:, :P, P:], 1,
                            perm[:, :, None].expand(Bb, P, N - P))
        U12 = block_lower_apply(K, F12p, pack_bs)
        L21 = block_upper_apply_right(K, F[:, P:, :P], pack_bs)
        S = F[:, P:, P:] - L21 @ U12
    else:
        U12 = F.new_zeros((Bb, P, 0))
        L21 = F.new_zeros((Bb, 0, P))
        S = F.new_zeros((Bb, 0, 0))
    return K, U12, L21, S, perm


def _lapack_pivots_to_perm(piv: torch.Tensor) -> torch.Tensor:
    """1-based LAPACK swap pivots (B, P) -> the row permutation (B, P)
    int64 that jax.lax.linalg.lu returns: A[perm] = L @ U."""
    pv = piv.cpu().numpy().astype(np.int64) - 1
    B, P = pv.shape
    perm = np.tile(np.arange(P, dtype=np.int64), (B, 1))
    rows = np.arange(B)
    for i in range(P):
        j = pv[:, i]
        a = perm[:, i].copy()
        perm[:, i] = perm[rows, j]
        perm[rows, j] = a
    return torch.from_numpy(perm).to(piv.device)


def partial_factor_small_batch(F, P: int, tau: float, pack_bs: int = PANEL):
    """Tree-top rounds (B <= 2): the library's batched LU with unrestricted
    partial pivoting inside F11 (the identity padding is a decoupled block
    that pivoting never mixes with real rows), then the GESP clamp applied
    to U's diagonal after the fact."""
    lu, piv = torch.linalg.lu_factor(F[:, :P, :P])
    perm = _lapack_pivots_to_perm(piv)
    d = torch.diagonal(lu, dim1=1, dim2=2)
    tau_t = torch.full_like(d, tau)
    d.copy_(torch.where(d.abs() < tau_t,
                        torch.where(d < 0, -tau_t, tau_t), d))
    return finish_factor(F, lu, perm, P, pack_bs)


def partial_factor(F, P: int, p_arr, tau: float = 0.0,
                   pack_bs: int = PANEL):
    """Blocked LU with restricted partial pivoting of F[:, :P, :P], TRSM of
    the off-diagonal blocks, Schur update of the border. F (B, N, N) is
    overwritten. Returns (K, U12, L21, S, perm) with S = F22 - L21 @ U12
    and perm (B, P) mapping solve positions to the original eliminated-row
    order (border rows are never permuted)."""
    B, N = F.shape[0], F.shape[-1]
    if B <= 2:
        return partial_factor_small_batch(F, P, tau, pack_bs)
    perm_total = torch.arange(P, device=F.device).repeat(B, 1)
    for off in range(0, P, PANEL):
        T = min(PANEL, P - off)
        R = P - off
        # the kernel composes the pivot swaps into pperm (B, R) itself
        Pan, _, pperm = ck.pivoted_panel(
            F[:, off:P, off:off + T].contiguous(), off, p_arr, tau)
        # permute the panel rows' other columns, then put the factored
        # panel in place
        Rows = torch.gather(F[:, off:P, :], 1,
                            pperm[:, :, None].expand(B, R, N))
        Rows[:, :, off:off + T] = Pan
        F[:, off:P, :] = Rows
        perm_total[:, off:] = torch.gather(perm_total[:, off:], 1, pperm)
        rest = N - off - T
        if rest > 0:
            D = Pan[:, :T, :T]
            # U part of the panel rows
            A12 = torch.linalg.solve_triangular(
                D, F[:, off:off + T, off + T:], upper=False,
                unitriangular=True)
            F[:, off:off + T, off + T:] = A12
            # L part of the (never permuted) border rows
            if N > P:
                F[:, P:, off:off + T] = torch.linalg.solve_triangular(
                    D, F[:, P:, off:off + T], upper=True, left=False)
            F[:, off + T:, off + T:] -= F[:, off + T:, off:off + T] @ A12
    K = pack_diag_inv(F[:, :P, :P], pack_bs)
    return (K, F[:, :P, P:].clone(), F[:, P:, :P].clone(),
            F[:, P:, P:].clone(), perm_total)


# --------------------------------------------------------------------------
# solve-side building blocks
# --------------------------------------------------------------------------

def set_own(W, vals, cells_own):
    """W[cells_own] = vals (B, P, nrhs), in place (the scatter form); pad
    entries all land on the dump row W[flat_len]."""
    W[cells_own.reshape(-1)] = vals.reshape(-1, vals.shape[-1])
    return W


def fwd_round(W, K, U12, L21, perm, cells_own, cells_bor, bs: int = PANEL,
              hi: bool = False):
    """Forward substitution for one round, batched over fronts, in place
    on the workspace W (flat_len + 1, nrhs). ``hi``: the arithmetic runs in
    float64 on transient upcasts of the factors, and the results are stored
    back at W's dtype."""
    nrhs = W.shape[1]
    rhs = W[cells_own]                                   # (B, P, nrhs)
    rhs = torch.gather(rhs, 1, perm[:, :, None].expand(-1, -1, nrhs))
    if hi:
        rhs, K, L21 = rhs.double(), K.double(), L21.double()
    y = block_lower_apply(K, rhs, bs)
    upd = (L21 @ y).to(W.dtype)
    set_own(W, y.to(W.dtype), cells_own)
    W.index_add_(0, cells_bor.reshape(-1), upd.reshape(-1, nrhs), alpha=-1)
    return W


def bwd_round(W, K, U12, L21, cells_own, cells_bor, bs: int = PANEL,
              hi: bool = False):
    """Backward substitution x = U11^-1 (rhs - U12 xb), in place on W
    (``hi``: see fwd_round)."""
    rhs, xb = W[cells_own], W[cells_bor]
    if hi:
        rhs, xb, K, U12 = rhs.double(), xb.double(), K.double(), U12.double()
    x = block_upper_apply(K, rhs - U12 @ xb, bs)
    return set_own(W, x.to(W.dtype), cells_own)


def solve_rounds(W, factors, consts, bs: int, hi=None):
    """The whole triangular sweep over all rounds (forward, then backward);
    hi[r] runs round r's substitutions in float64 (see fwd_round)."""
    hi = hi or [False] * len(factors)
    for (K, U12, L21, perm), cc, h in zip(factors, consts, hi):
        W = fwd_round(W, K, U12, L21, perm, cc["own"], cc["bor"], bs, h)
    for (K, U12, L21, _), cc, h in zip(reversed(factors), reversed(consts),
                                       reversed(hi)):
        W = bwd_round(W, K, U12, L21, cc["own"], cc["bor"], bs, h)
    return W


def factors_from_jax(jax_engine, device) -> tuple:
    """The per-round (K, U12, L21, perm) tensors of a JaxMultifrontal
    engine's factors on ``device``, at the JAX engine's own dtype, read
    through np.asarray (no jax import here): the port's solve can then run
    on the JAX engine's factors."""
    device = torch.device(device)
    out = []
    for K, U12, L21, perm, _ in jax_engine.factors:
        out.append(tuple(torch.from_numpy(np.array(a)).to(device)
                         for a in (K, U12, L21))
                   + (torch.from_numpy(np.array(perm, dtype=np.int64))
                      .to(device),))
    return tuple(out)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

class TorchMultifrontal:
    """Single-device numeric engine over the round plans: factor
    (``refactor`` for new values on the same pattern) and multi-RHS
    solve. ``device`` is a torch.device (see device.resolve_device),
    ``prec`` the factor dtype (torch.float64 or torch.float32)."""

    def __init__(self, sym: SymbolicFactorization, matrix: SparseMatrix,
                 device: torch.device, factorize: bool = True,
                 prec: torch.dtype = torch.float64):
        if prec not in NUMPY_DTYPE:
            raise ValueError(f"unsupported factor dtype {prec}")
        self.sym = sym
        self.device = torch.device(device)
        self.prec = prec
        self.flat_len = sym.flat_len
        self.timings: dict[str, float] = {}
        t0 = time.perf_counter()
        with timed("build round plans"):
            # bytes_per_elem stays at its default of 4 at either dtype, as the
            # JAX engine calls it: the chunking (and so every round and
            # pivot) must be the same
            self.plans = build_plan(sym, matrix, batch_multiple=1)
        # adaptive solve block size: full explicit diagonal-block inverses
        # on shallow trees, narrower blocks as element growth deepens
        maxP = max((p.P for p in self.plans), default=PANEL)
        if maxP <= 2048:
            self._pack_bs = maxP
        elif maxP <= 4096:
            self._pack_bs = 1024
        else:
            self._pack_bs = 512
        dbg(1, "memory plan: "
            + plan_memory(self.plans, 1, prec.itemsize).summary())
        with timed("device constants"):
            self._consts = self._device_constants()
        self.timings["plan"] = time.perf_counter() - t0
        self.factors = None
        if factorize:
            self._factorize(matrix)

    def _device_constants(self) -> list[dict]:
        def put(a, dtype=torch.int64):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=self.device, dtype=dtype)

        consts = []
        for p in self.plans:
            groups = []
            for g in p.child_groups:
                order, waves = link_waves(g.dst_slots)
                groups.append((g.src_round, put(g.src_slots[order]),
                               put(g.dst_slots[order]), put(g.inv[order]),
                               waves))
            consts.append(dict(
                a_col=put(p.a_col), a_csrc=put(p.a_csrc),
                a_pos=put(p.a_pos), a_src=put(p.a_src),
                # any real spill entries? (pads sit at >= N*N)
                spill=bool((p.a_pos < p.N * p.N).any()),
                p_arr=put(p.p_arr, torch.int32),
                own=put(p.cells_own), bor=put(p.cells_bor),
                groups=groups))
        return consts

    def refactor(self, matrix: SparseMatrix) -> None:
        """New numeric values, same pattern (Newton-iteration reuse)."""
        self._factorize(matrix)

    def _factorize(self, matrix: SparseMatrix) -> None:
        # drop the previous factors first: both sets resident at once
        # would double the peak
        self.factors = None
        nz = np.zeros(len(matrix.nzval) + 1, dtype=NUMPY_DTYPE[self.prec])
        nz[:-1] = matrix.nzval
        # GESP static-pivot threshold: sqrt(eps) of the factor precision
        # times the largest (factor-precision) value, rounded through f32
        # as the JAX engine does at either dtype
        eps = float(np.finfo(nz.dtype).eps)
        amax = float(np.max(np.abs(nz))) if len(matrix.nzval) else 1.0
        self._tau = float(np.float32(np.sqrt(eps) * amax))
        t0 = time.perf_counter()
        with timed("factor dispatch"):
            nzval_ext = torch.from_numpy(nz).to(self.device)
            self.factors = self._factor_rounds(nzval_ext)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.timings["factor"] = time.perf_counter() - t0

    def _factor_rounds(self, nzval_ext) -> tuple:
        """Walk the rounds in dependency order, freeing each Schur stack
        as soon as its last consumer has extend-added it."""
        factors = []
        schur: list = [None] * len(self.plans)
        uses = [0] * len(self.plans)
        for plan in self.plans:
            for g in plan.child_groups:
                uses[g.src_round] += 1
        for rnd, (plan, cc) in enumerate(zip(self.plans, self._consts)):
            F = ck.ell_assemble(nzval_ext, cc["a_col"], cc["a_csrc"],
                                cc["a_pos"], cc["a_src"], cc["p_arr"],
                                plan.N, plan.P, cc["spill"])
            for src_rnd, ss, ds, inv, waves in cc["groups"]:
                extend_add(F, schur[src_rnd], ss, ds, inv, waves)
                uses[src_rnd] -= 1
                if uses[src_rnd] == 0:
                    schur[src_rnd] = None
            K, U12, L21, S, perm = partial_factor(
                F, plan.P, cc["p_arr"], self._tau, self._pack_bs)
            del F
            schur[rnd] = S if uses[rnd] > 0 else None
            factors.append((K, U12, L21, perm))
        return tuple(factors)

    def _hi_round(self, plan) -> bool:
        return plan.P >= HI_ROUND_MIN_P and self.prec == torch.float32

    def solve_workspace(self, W: torch.Tensor) -> torch.Tensor:
        """Solve in place on W (flat_len + 1, nrhs), a tensor of the factor
        dtype on the engine's device holding the right-hand sides above its
        zero dump row; returns W. The device-side solve the refiner applies
        as its preconditioner (mf_jax.JaxMultifrontal._solve_program)."""
        if self.factors is None:
            raise RuntimeError("no numeric factors: call refactor() first")
        return solve_rounds(W, self.factors, self._consts, self._pack_bs,
                            [self._hi_round(p) for p in self.plans])

    def solve(self, b: np.ndarray) -> np.ndarray:
        """x = A^-1 b on the host arrays b (n,) or (n, nrhs); the RHS is
        staged in the factor dtype, the result returned as float64."""
        B = np.asarray(b, dtype=np.float64)
        single = B.ndim == 1
        if single:
            B = B[:, None]
        W = torch.zeros((self.flat_len + 1, B.shape[1]), dtype=self.prec,
                        device=self.device)
        W[:self.flat_len] = torch.from_numpy(np.ascontiguousarray(B)).to(
            self.device)
        W = self.solve_workspace(W)
        X = W[:self.flat_len].cpu().numpy().astype(np.float64)
        return X[:, 0] if single else X
