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
layout), U12 (B, P, M), L21 (B, M, P) and perm (B, P). That packed
layout is known only to this module's solve-side building blocks, which
the stream solve calls too, and to checkpoint._unpack_trimmed's identity
padding. The solve walks the rounds forward then backward over a
(flat_len + 1, nrhs) workspace whose last row takes every pad index, one
round body a direction for every layout (``_fwd``, ``_bwd``); the
forward sweep subtracts each round's border updates in waves of distinct
destinations, so its sums are the same on every run (``border_waves``).
With a checkpoint directory the engine writes each round to disk and
resumes from it (``checkpoint.FactorRoundCheckpointer``), and can keep
its factors off the device (offload, factor-only). Factors, Schur stacks and the
workspace are in the engine's factor dtype ``prec`` (float64, or float32);
rounds with P >= HI_ROUND_MIN_P run their substitutions in float64 on
float32 factors.

With a mesh (``parallel.mesh.Mesh``; mf_jax.JaxMultifrontal's ``mesh=``)
the engine is one rank of a torch.distributed world and shards each round
over the ranks along the mesh's primary axis (``round_layout``):

* a round whose batch the rank count divides is batch-sharded: each rank
  assembles, extend-adds and factors its own slice of the fronts, taking
  the Schur fronts its links read from other ranks by a static exchange
  plan, and the solve all-gathers each round's results;
* a tree-top round of fewer fronts (N >= ``row_shard_min``, N divisible)
  is row-sharded: every rank factors it whole, then keeps K by columns
  (with the replicated diagonal-block stack ``kd`` for the masked
  substitution), U12 by its border axis, L21 by its rows and the Schur
  stack by its trailing axis;
* any other round is replicated.

Under a mesh the engine plans with ``batch_multiple`` = the rank count,
packs at ``PANEL`` and factors the tree-top rounds with the panel kernel,
never the library LU, as the JAX mesh engine does, so rounds and pivots
are the same as its. An "rhs" axis splits the right-hand-side columns of
a solve between the mesh's columns (``solve_workspace``). Every
collective goes through ``parallel.collectives``; a mesh of one rank, or
no mesh, communicates nothing.

Index tensors go to the device once, as int64 (p_arr, a count, as int32).
Functions that take F update it in place where that saves memory, and say
so.

A single-device CUDA engine replays its solve sweep as one CUDA graph
(``solve_workspace``): the second sweep at a right-hand-side width on the
same factors captures the eager sweep's launches, in the same order, and
every later sweep at that width replays them on a static workspace. New
factors drop every graph.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..io.matrixfile import SparseMatrix
from ..parallel import collectives as coll
from ..utils import dbg, timed
from ..utils.profiling import STAGES, span
from . import cuda_kernels as ck
from .checkpoint import FactorRoundCheckpointer
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
                   pack_bs: int = PANEL, allow_native_lu: bool = True):
    """Blocked LU with restricted partial pivoting of F[:, :P, :P], TRSM of
    the off-diagonal blocks, Schur update of the border. F (B, N, N) is
    overwritten. Returns (K, U12, L21, S, perm) with S = F22 - L21 @ U12
    and perm (B, P) mapping solve positions to the original eliminated-row
    order (border rows are never permuted). Rounds of at most two fronts
    take the library LU unless ``allow_native_lu`` is False (mesh engines,
    as mf_jax._partial_factor_body under a mesh): then every round runs the
    panel kernel. The stages of the profile (utils.profiling.STAGES) are
    the library LU, and per panel the kernel, the row gather, the two
    TRSMs and the trailing GEMM; then the pack."""
    B, N = F.shape[0], F.shape[-1]
    if B <= 2 and allow_native_lu:
        with STAGES.stage("treetop_lu"):
            return partial_factor_small_batch(F, P, tau, pack_bs)
    perm_total = torch.arange(P, device=F.device).repeat(B, 1)
    for off in range(0, P, PANEL):
        T = min(PANEL, P - off)
        R = P - off
        panel = F[:, off:P, off:off + T].contiguous()
        # the kernel composes the pivot swaps into pperm (B, R) itself
        with STAGES.stage("panel"):
            Pan, _, pperm = ck.pivoted_panel(panel, off, p_arr, tau)
        del panel
        # permute the panel rows' other columns, then put the factored
        # panel in place
        with STAGES.stage("row_gather"):
            Rows = torch.gather(F[:, off:P, :], 1,
                                pperm[:, :, None].expand(B, R, N))
            Rows[:, :, off:off + T] = Pan
            F[:, off:P, :] = Rows
            perm_total[:, off:] = torch.gather(perm_total[:, off:], 1,
                                               pperm)
        rest = N - off - T
        if rest > 0:
            D = Pan[:, :T, :T]
            with STAGES.stage("trsm"):
                # U part of the panel rows
                A12 = torch.linalg.solve_triangular(
                    D, F[:, off:off + T, off + T:], upper=False,
                    unitriangular=True)
                F[:, off:off + T, off + T:] = A12
                # L part of the (never permuted) border rows
                if N > P:
                    F[:, P:, off:off + T] = torch.linalg.solve_triangular(
                        D, F[:, P:, off:off + T], upper=True, left=False)
            with STAGES.stage("gemm"):
                F[:, off + T:, off + T:] -= F[:, off + T:, off:off + T] @ A12
    K = pack_diag_inv(F[:, :P, :P], pack_bs)
    return (K, F[:, :P, P:].clone(), F[:, P:, :P].clone(),
            F[:, P:, P:].clone(), perm_total)


# --------------------------------------------------------------------------
# solve-side building blocks
# --------------------------------------------------------------------------
# pack_diag_inv writes the packed pivot-block layout; the block
# substitutions below are its only readers.

def set_own(W, vals, cells_own):
    """W[cells_own] = vals (B, P, nrhs), in place (the scatter form); pad
    entries all land on the dump row W[flat_len]."""
    W[cells_own.reshape(-1)] = vals.reshape(-1, vals.shape[-1])
    return W


def border_waves(cells_bor: np.ndarray, flat_len: int):
    """The border subtraction of one round in waves of distinct
    destinations: (src, dst, waves) with src the flattened (B * M) update
    rows in wave order, dst their workspace rows and waves the [start,
    stop) ranges of link_waves. Subtracting the waves in turn sums each
    border cell's updates in flattened update order, as a sequential
    scatter-add (and the JAX reference on the CPU) does, with no duplicate
    index in any index_add_: the same sums on every run, on the CPU and on
    CUDA. Pad entries (the dump row, which only ever receives zero rows)
    are dropped."""
    flat = np.asarray(cells_bor, dtype=np.int64).reshape(-1)
    keep = np.flatnonzero(flat < flat_len)
    order, waves = link_waves(flat[keep])
    src = keep[order]
    return src, flat[src], waves


def fwd_store(W, y, upd, cells_own, border):
    """Store one round's forward results in W, in place: y on the fronts'
    own rows, then the border updates subtracted in the waves of
    ``border`` = (src, dst, waves) (border_waves, as tensors on W's device,
    waves a list)."""
    nrhs = W.shape[1]
    set_own(W, y, cells_own)
    src, dst, waves = border
    upd = upd.reshape(-1, nrhs)[src]
    for a, b in waves:
        W.index_add_(0, dst[a:b], upd[a:b], alpha=-1)
    return W


def pack_diag_inv(LU, bs: int = PANEL):
    """Copy of a packed LU (B, P, P) whose bs-sized diagonal blocks are
    replaced by stril(L_ii^-1, -1) + triu(U_ii^-1); the off-diagonal blocks
    keep the raw L and U values. The layout the block substitutions read."""
    B, Pdim, _ = LU.shape
    with STAGES.stage("pack"):
        out = LU.clone()
        for o in range(0, Pdim, bs):
            T = min(bs, Pdim - o)
            Ti = LU[:, o:o + T, o:o + T]
            eye = torch.eye(T, dtype=LU.dtype,
                            device=LU.device).expand(B, T, T)
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


def extract_diag_blocks(K, bs: int):
    """The bs-sized diagonal blocks of K (B, P, P) as a stack (B, P // bs,
    bs, bs) (mf_jax._extract_diag_blocks): the masked substitution reads
    its diagonal blocks there, never from K's sharded columns."""
    return torch.stack([K[:, o:o + bs, o:o + bs]
                        for o in range(0, K.shape[1], bs)], dim=1)


def block_lower_apply_masked(K, KD, rhs, c0: int, reduce):
    """y = L11^-1 rhs when this rank holds only the columns [c0, c0 +
    K.shape[2]) of the packed pivot block (a row-sharded round;
    mf_jax._block_lower_apply_masked). Each block step contracts the
    local columns of its row block against y, which is zero past the
    block, and ``reduce`` sums the ranks' partial products; the diagonal
    blocks come from KD (B, P // bs, bs, bs)."""
    bs = KD.shape[-1]
    Kc = K.shape[2]
    y = torch.zeros_like(rhs)
    for i, o in enumerate(range(0, rhs.shape[1], bs)):
        t = rhs[:, o:o + bs] - reduce(K[:, o:o + bs, :]
                                      @ y[:, c0:c0 + Kc])
        t = t + torch.tril(KD[:, i], -1) @ t
        y[:, o:o + bs] = t
    return y


def block_upper_apply_masked(K, KD, rhs, c0: int, reduce):
    """x = U11^-1 rhs, masked form (layout and reduce as above)."""
    bs = KD.shape[-1]
    Kc = K.shape[2]
    x = torch.zeros_like(rhs)
    for i in reversed(range(rhs.shape[1] // bs)):
        o = i * bs
        t = rhs[:, o:o + bs] - reduce(K[:, o:o + bs, :]
                                      @ x[:, c0:c0 + Kc])
        x[:, o:o + bs] = torch.triu(KD[:, i]) @ t
    return x


def upcast(hi: bool, *ts):
    """``ts`` in float64 when ``hi`` (a hi round's transient upcasts: see
    HI_ROUND_MIN_P), else as they are; a None stays None."""
    if not hi:
        return ts
    return tuple(None if t is None else t.double() for t in ts)


# --------------------------------------------------------------------------
# the mesh layout of a round
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class RoundLayout:
    """Where one round lives on a mesh of ``ndev`` ranks along its primary
    axis, as rank ``me`` sees it (mf_jax.JaxMultifrontal's ``_put``,
    ``_row_sharded`` and ``_shard_factors``). ``kind`` is

    * "batch": the rank count divides B, and this rank holds the fronts
      [lo, hi) (all of them without a mesh, or on a mesh of one rank);
    * "row": a tree-top round of N >= row_shard_min, N divisible by the
      rank count: every rank factors all its fronts, then keeps the
      columns ``chunk(P)`` of K with the diagonal-block stack when
      ``masked`` (P divisible by the rank count and by the diagonal
      block), and the columns ``chunk(M)`` of U12 and of the Schur stack
      and those rows of L21 when ``border`` (M > 0 divisible);
    * "rep": every rank holds the whole round."""
    kind: str
    lo: int
    hi: int
    ndev: int
    me: int
    masked: bool = False
    border: bool = False

    @property
    def split(self) -> bool:
        """True where the ranks share the round's batch between them."""
        return self.kind == "batch" and self.ndev > 1

    def chunk(self, n: int) -> tuple[int, int]:
        """This rank's [start, stop) of an axis of n entries."""
        w = n // self.ndev
        return self.me * w, (self.me + 1) * w


def round_layout(plan, ndev: int, me: int, row_shard_min: int):
    """The RoundLayout of ``plan``'s round on rank ``me`` of ``ndev``."""
    B = plan.B
    if ndev <= 1 or B % ndev == 0:
        bl = B // max(ndev, 1)
        return RoundLayout("batch", me * bl, (me + 1) * bl, ndev, me)
    if plan.N >= row_shard_min and plan.N % ndev == 0:
        bs = min(PANEL, plan.P)
        return RoundLayout("row", 0, B, ndev, me,
                           masked=plan.P % ndev == 0 and plan.P % bs == 0,
                           border=plan.M > 0 and plan.M % ndev == 0)
    return RoundLayout("rep", 0, B, ndev, me)


def shard_round(lay: RoundLayout, plan, K, U12, L21, perm, own):
    """This rank's (K, U12, L21, perm, KD) of one round's whole factors
    (tensors) in layout ``lay``; ``own(t)`` makes a slice a tensor of its
    own on the engine's device. KD is None off the masked path."""
    if lay.split:
        b = slice(lay.lo, lay.hi)
        return own(K[b]), own(U12[b]), own(L21[b]), own(perm[b]), None
    KD = None
    if lay.kind == "row":
        if lay.masked:
            KD = own(extract_diag_blocks(K, min(PANEL, plan.P)))
            c0, c1 = lay.chunk(plan.P)
            K = K[:, :, c0:c1]
        if lay.border:
            m0, m1 = lay.chunk(plan.M)
            U12, L21 = U12[:, :, m0:m1], L21[:, m0:m1, :]
    return own(K), own(U12), own(L21), own(perm), KD


def shard_schur(lay: RoundLayout, plan, S, own):
    """This rank's part of one round's whole Schur stack S (a tensor) in
    layout ``lay`` (mf_jax._shard_schur for the row-sharded rounds)."""
    if lay.split:
        return own(S[lay.lo:lay.hi])
    if lay.kind == "row" and lay.border:
        m0, m1 = lay.chunk(plan.M)
        return own(S[:, :, m0:m1])
    return own(S)


def factors_from_jax(jax_engine, device, mesh=None) -> tuple:
    """The per-round (K, U12, L21, perm) tensors of a JaxMultifrontal
    engine's factors on ``device``, at the JAX engine's own dtype, read
    through np.asarray (no jax import here): the port's solve can then run
    on the JAX engine's factors.

    With ``mesh`` (this rank's parallel.mesh.Mesh), the JAX engine is a
    mesh engine with as many devices along its primary axis as ``mesh``
    has ranks there, and each tuple is this rank's slice of its global
    factors, (K, U12, L21, perm, KD) in the port's layout (round_layout,
    with the JAX engine's own ``_row_sharded`` choosing the row-sharded
    rounds), for TorchMultifrontal.set_factors."""
    device = torch.device(device)
    out = []
    for rnd, (K, U12, L21, perm, _) in enumerate(jax_engine.factors):
        arrs = [torch.from_numpy(np.array(a)) for a in (K, U12, L21)]
        arrs.append(torch.from_numpy(np.array(perm, dtype=np.int64)))
        if mesh is None:
            out.append(tuple(a.to(device) for a in arrs))
            continue
        plan = jax_engine.plans[rnd]
        # the JAX engine's own choice of row-sharded rounds, as a threshold
        row_min = 0 if jax_engine._row_sharded(plan) else plan.N + 1
        lay = round_layout(plan, mesh.shape[0], mesh.coords[0], row_min)
        out.append(shard_round(lay, plan, *arrs,
                               lambda t: t.to(device).contiguous().clone()))
    return tuple(out)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _can_capture(device: torch.device) -> bool:
    """Whether work on ``device`` can be captured into a CUDA graph."""
    return device.type == "cuda"


def _capture(body):
    """A CUDA graph of ``body()`` on the current device: capturing records
    its launches without running them; ``replay()`` runs them."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph


def pack_block_size(plans) -> int:
    """The adaptive solve block size of ``pack_diag_inv``: full explicit
    diagonal-block inverses on shallow trees, narrower blocks as element
    growth deepens."""
    maxP = max((p.P for p in plans), default=PANEL)
    if maxP <= 2048:
        return maxP
    if maxP <= 4096:
        return 1024
    return 512


class TorchMultifrontal:
    """Numeric engine over the round plans: factor (``refactor`` for new
    values on the same pattern) and multi-RHS solve. ``device`` is a
    torch.device (see device.resolve_device), ``prec`` the factor dtype
    (torch.float64 or torch.float32).

    With ``checkpoint_dir`` every completed round is written there
    (checkpoint.FactorRoundCheckpointer) and rounds with a valid
    checkpoint are loaded instead of recomputed, so a factor pass resumes
    after a process death. ``offload`` (on by default with a checkpoint
    directory) drops each round's factors from the device once they are on
    disk and streams them back after the last round: the factor pass then
    holds only the live Schur stacks and one round's fronts.
    ``factor_only`` writes the checkpoints and keeps no factors (the
    engine cannot solve; another engine, or ``stream_solve``, resumes from
    the directory); ``stop_after`` (factor-only only) ends the pass after
    that round, leaving a directory the next engine continues from.

    ``mesh`` (a parallel.mesh.Mesh holding this rank) makes the engine one
    rank of a sharded factorization (see the module docstring); every rank
    of the mesh constructs it with the same arguments, and its factor,
    solve and checkpoint calls are collective. Only the mesh's first rank
    writes checkpoint files, and each rank reads its own slice back. The
    fronts shard over the mesh's primary axis. ``mem_budget_bytes`` bounds each round's padded fronts in the
    plan (build_plan), ``row_shard_min`` is the smallest front that a
    round with fewer fronts than ranks shards by rows (the JAX engine's
    ``NK_MEM_BUDGET`` and ``ROW_SHARD_MIN``)."""

    def __init__(self, sym: SymbolicFactorization, matrix: SparseMatrix,
                 device: torch.device, factorize: bool = True,
                 prec: torch.dtype = torch.float64,
                 checkpoint_dir: str | None = None,
                 factor_only: bool = False, offload: bool | None = None,
                 stop_after: int | None = None, mesh=None,
                 mem_budget_bytes: float = 1.5e9,
                 row_shard_min: int = 1024):
        if prec not in NUMPY_DTYPE:
            raise ValueError(f"unsupported factor dtype {prec}")
        if offload is None:
            offload = checkpoint_dir is not None
        if (offload or factor_only) and checkpoint_dir is None:
            raise ValueError("offload and factor_only need a checkpoint_dir "
                             "(the factors live there)")
        if stop_after is not None and not factor_only:
            raise ValueError("stop_after requires factor_only (a partial "
                             "factor set cannot solve)")
        if mesh is not None and mesh.coords is None:
            raise ValueError("this rank is outside the mesh")
        self.sym = sym
        self.device = torch.device(device)
        self.prec = prec
        self.flat_len = sym.flat_len
        self.mesh = mesh
        self.ndev = mesh.shape[0] if mesh is not None else 1
        self.me = mesh.coords[0] if mesh is not None else 0
        self._fgroup = mesh.front_group if mesh is not None else None
        # only the mesh's first rank writes files
        self._writer = mesh is None or not any(mesh.coords)
        self.mem_budget_bytes = mem_budget_bytes
        self.row_shard_min = row_shard_min
        self._ckpt_dir = checkpoint_dir
        self._offload = offload
        self._factor_only = factor_only
        self._stop_after = stop_after
        self._ckpt = None
        self.timings: dict[str, float] = {}
        t0 = time.perf_counter()
        with timed("build round plans"):
            # bytes_per_elem stays at its default of 4 at either dtype, as the
            # JAX engine calls it: the chunking (and so every round and
            # pivot) must be the same; a mesh pads batches to its rank count
            self.plans = build_plan(sym, matrix,
                                    mem_budget_bytes=mem_budget_bytes,
                                    batch_multiple=self.ndev)
        # mesh engines pin PANEL (the masked substitution's diagonal blocks
        # and the sharded checkpoint layout), as the JAX mesh engine does
        self._pack_bs = (PANEL if mesh is not None
                         else pack_block_size(self.plans))
        self.layouts = [round_layout(p, self.ndev, self.me, row_shard_min)
                        for p in self.plans]
        # the solve spans' arguments: each round's front shape
        self._round_args = [dict(round=r, B=p.B, P=p.P, N=p.N)
                            for r, p in enumerate(self.plans)]
        if mesh is not None:
            self._check_plans()
        dbg(1, "memory plan: " + plan_memory(
            self.plans, self.ndev, prec.itemsize,
            row_shard_min=row_shard_min).summary())
        # each round's device constants are built on its first use: a
        # factor-only pass builds none for the rounds it loads, the stream
        # solve's engine none at all. An engine that will solve needs them
        # all, and builds them here, outside timings["factor"]
        self._consts: list[dict | None] = [None] * len(self.plans)
        if factorize and not factor_only:
            with timed("device constants"):
                for rnd in range(len(self.plans)):
                    self._round_consts(rnd)
        self.timings["plan"] = time.perf_counter() - t0
        # the captured sweeps, by (width, dtype): (static workspace, graph);
        # the keys swept once eagerly on the current factors; the sweeps
        # by route; the factor generation (see ``factors``)
        self._graphs: dict = {}
        self._swept: set = set()
        self.sweep_counts = {"eager": 0, "captured": 0, "replayed": 0}
        self.generation = 0
        self.factors = None
        self.loaded_rounds: list[int] = []
        # the replicated diagonal-block stacks of the masked rounds
        self.kd: list = [None] * len(self.plans)
        if factorize:
            self._factorize(matrix)

    @property
    def factors(self):
        """Per-round (K, U12, L21, perm), or None."""
        return self._factors

    @factors.setter
    def factors(self, factors) -> None:
        # a captured sweep reads the factors at the addresses it was
        # captured on and holds no reference to them: every graph and its
        # pool goes before the old factors can be freed, and the next
        # factors start a generation of their own
        self._graphs.clear()
        self._swept.clear()
        self.generation += 1
        self._factors = factors

    # -- placement ----------------------------------------------------------

    def _put(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """A host array on the engine's device at ``dtype``."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def _own(self, t) -> torch.Tensor:
        """``t`` (a tensor or an array) as a tensor of its own on the
        engine's device, floating values at the factor dtype and integers
        as int64; a whole contiguous tensor already there is kept."""
        t = torch.as_tensor(t)
        dtype = self.prec if t.is_floating_point() else torch.int64
        here = (t.device.type == self.device.type
                and self.device.index in (None, t.device.index))
        if here and t.dtype == dtype and t._base is None \
                and t.is_contiguous():
            return t
        return torch.empty(t.shape, dtype=dtype,
                           device=self.device).copy_(t)

    def _place_round(self, rnd: int, plan, K, U12, L21, perm) -> tuple:
        """Round ``rnd``'s whole factors (host arrays or tensors) in this
        rank's layout on the device: returns (K, U12, L21, perm) and keeps
        the round's diagonal-block stack in ``kd``."""
        K, U12, L21, perm, self.kd[rnd] = shard_round(
            self.layouts[rnd], plan,
            *(torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a) for a in (K, U12, L21, perm)),
            self._own)
        return K, U12, L21, perm

    def _place_schur(self, rnd: int, plan, S) -> torch.Tensor:
        """Round ``rnd``'s whole Schur stack in this rank's layout."""
        return shard_schur(self.layouts[rnd], plan, torch.as_tensor(S),
                           self._own)

    def _gather_round(self, rnd: int, K, U12, L21, perm) -> tuple:
        """Round ``rnd``'s whole factors from every rank's slice
        (collective over the mesh column)."""
        lay, g = self.layouts[rnd], self._fgroup
        if lay.split:
            return tuple(coll.all_gather(t, g) for t in (K, U12, L21, perm))
        if lay.kind == "row":
            if lay.masked:
                K = coll.all_gather(K, g, dim=2)
            if lay.border:
                U12 = coll.all_gather(U12, g, dim=2)
                L21 = coll.all_gather(L21, g, dim=1)
        return K, U12, L21, perm

    def _gather_schur(self, rnd: int, S) -> torch.Tensor:
        lay = self.layouts[rnd]
        if lay.split:
            return coll.all_gather(S, self._fgroup)
        if lay.kind == "row" and lay.border:
            return coll.all_gather(S, self._fgroup, dim=2)
        return S

    def global_factors(self) -> tuple:
        """Every round's whole (K, U12, L21, perm), gathered from the
        ranks' slices (collective under a mesh; the factors themselves
        without one)."""
        if self.mesh is None:
            return self.factors
        return tuple(self._gather_round(rnd, *f)
                     for rnd, f in enumerate(self.factors))

    def resident_factor_bytes(self) -> int:
        """The factor bytes this rank holds (K, U12, L21, the diagonal-block
        stacks), counted as memplan.plan_memory counts them: perm at the 4
        bytes of the JAX engine's int32 perm (the port's is int64)."""
        n = 0
        for (K, U12, L21, perm), kd in zip(self.factors, self.kd):
            for t in (K, U12, L21, kd):
                if t is not None:
                    n += t.numel() * t.element_size()
            n += perm.numel() * 4
        return n

    def set_factors(self, factors) -> None:
        """Install per-round factors already in this rank's layout:
        (K, U12, L21, perm) tuples, or (K, U12, L21, perm, KD) ones as
        factors_from_jax(..., mesh) gives them."""
        self.factors = tuple(tuple(f[:4]) for f in factors)
        self.kd = [f[4] if len(f) > 4 else None for f in factors]

    def _check_plans(self) -> None:
        """Every rank of the mesh must walk the same rounds with the same
        options, or the first collective where two differ hangs: compare a
        digest of them across each group the engine talks over (which is
        also each group's first collective)."""
        h = hashlib.sha1(np.array([[p.B, p.P, p.N] for p in self.plans],
                                  dtype=np.int64).tobytes())
        h.update(f"{self.row_shard_min} {self._pack_bs} {self.prec} "
                 f"{self.mem_budget_bytes}".encode())
        digest = torch.from_numpy(np.frombuffer(h.digest()[:8],
                                                dtype=np.int64).copy())
        digest = digest.to(self.device)
        groups = [self._fgroup]
        if self.mesh.rhs_groups:
            groups.append(self.mesh.rhs_group)
        for group in groups:
            if not bool((coll.all_gather(digest, group) == digest).all()):
                raise RuntimeError("the ranks of the mesh built different "
                                   "round plans (matrix, options or "
                                   "arguments differ between ranks)")

    def _psum(self, t: torch.Tensor) -> torch.Tensor:
        return coll.all_reduce_sum(t, self._fgroup)

    def _mesh_barrier(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            coll.barrier(self.mesh.group)

    # -- plan constants -----------------------------------------------------

    def _round_consts(self, rnd: int) -> dict:
        """Round ``rnd``'s plan constants on the device, built on first
        use and kept."""
        if self._consts[rnd] is None:
            self._consts[rnd] = self._device_constants(rnd)
        return self._consts[rnd]

    def _device_constants(self, rnd: int) -> dict:
        """The round's index tensors: the assembly maps and p_arr of this
        rank's fronts, its extend-add links (``_link_group``), and the
        solve's cell maps, whole (``own``, ``bor``, ``border``) and of this
        rank's fronts (``own_l``, ``bor_l``)."""
        p, lay = self.plans[rnd], self.layouts[rnd]

        def put(a, dtype=torch.int64):
            return self._put(a, dtype)

        b = slice(lay.lo, lay.hi)
        links = [self._link_group(rnd, g, put) for g in p.child_groups]
        src, dst, waves = border_waves(p.cells_bor, self.flat_len)
        own, bor = put(p.cells_own), put(p.cells_bor)
        if lay.split:
            own_l, bor_l = put(p.cells_own[b]), put(p.cells_bor[b])
        else:
            own_l, bor_l = own, bor
        return dict(
            a_col=put(p.a_col[b]), a_csrc=put(p.a_csrc[b]),
            a_pos=put(p.a_pos[b]), a_src=put(p.a_src[b]),
            # any real spill entries? (pads sit at >= N*N)
            spill=bool((p.a_pos[b] < p.N * p.N).any()),
            p_arr=put(p.p_arr[b], torch.int32),
            own=own, bor=bor, own_l=own_l, bor_l=bor_l,
            border=(put(src), put(dst), waves),
            groups=[lk[0] for lk in links], exchange=[lk[1] for lk in links])

    def _link_group(self, rnd: int, g, put) -> tuple:
        """One child group's links into this rank's fronts, in link order:
        ((src_round, src_slots, dst_slots, inv, waves), exchange plan). The
        source slots index the stack that ``_source_schur`` hands the
        extend-add: the source round's Schur stack, or, when the source
        is batch-sharded over several ranks, the fronts this rank's links
        read, taken in owner order from the local stack and from the other
        ranks (the exchange plan: which local fronts go to which rank, how
        many come from which; None without one)."""
        lay, ls = self.layouts[rnd], self.layouts[g.src_round]
        dst_all = g.dst_slots.astype(np.int64)
        src_all = g.src_slots.astype(np.int64)

        def reads(q: int) -> np.ndarray:
            """The source slots that rank q's links read."""
            if not lay.split:
                return np.unique(src_all)
            w = lay.hi - lay.lo
            return np.unique(src_all[(dst_all >= q * w)
                                     & (dst_all < (q + 1) * w)])

        mine = (dst_all >= lay.lo) & (dst_all < lay.hi)
        ss, ds, inv = src_all[mine], dst_all[mine] - lay.lo, g.inv[mine]
        xplan = None
        if ls.split:
            bl = ls.hi - ls.lo
            need = reads(self.me)
            owner = need // bl
            send = {}
            for q in range(self.ndev):
                theirs = reads(q)
                theirs = theirs[theirs // bl == self.me]
                if q != self.me and len(theirs):
                    send[q] = put(theirs - ls.lo)
            xplan = dict(
                send=send,
                recv={int(q): int((owner == q).sum())
                      for q in np.unique(owner) if q != self.me},
                keep=put(need[owner == self.me] - ls.lo),
                owners=sorted(set(owner.tolist())))
            ss = np.searchsorted(need, ss)
        order, waves = link_waves(ds)
        return ((g.src_round, put(ss[order]), put(ds[order]),
                 put(inv[order]), waves), xplan)

    def _source_schur(self, src_rnd: int, S, xplan):
        """The Schur stack a link group reads: ``S`` itself, the whole
        stack of a row-sharded source gathered from its column shards, or
        (``xplan``) the fronts this rank's links read, exchanged with the
        other ranks of the mesh column."""
        lay = self.layouts[src_rnd]
        if xplan is not None:
            got = coll.exchange(
                {q: S.index_select(0, idx) for q, idx in xplan["send"].items()},
                {q: (c,) + tuple(S.shape[1:])
                 for q, c in xplan["recv"].items()}, S, self._fgroup)
            parts = [S.index_select(0, xplan["keep"]) if o == self.me
                     else got[o] for o in xplan["owners"]]
            return torch.cat(parts) if parts else S[:0]
        if lay.kind == "row" and lay.border:
            return coll.all_gather(S, self._fgroup, dim=2)
        return S

    def _plan_pm(self, plan) -> np.ndarray:
        """True (pivot, border) sizes per batch entry of a round: the trim
        map of the v3 round checkpoints ((0, 0) for padding entries)."""
        pm = np.zeros((plan.B, 2), dtype=np.int64)
        for b, nid in enumerate(plan.node_ids):
            f = self.sym.fronts[nid]
            pm[b] = (f.p, f.n - f.p)
        return pm

    # -- checkpoints --------------------------------------------------------

    def _ckpt_for(self, matrix: SparseMatrix, nz: np.ndarray | None = None):
        """The round checkpointer keyed to this matrix's values (in the
        factor dtype), the plan shape, the factor layout version and the
        pack block size: the key under which two engines (a factor-only
        pass and a later solve, of either package) agree that they resume
        the same factorization. None without a checkpoint directory."""
        if self._ckpt_dir is None:
            return None
        if nz is None:
            nz = np.zeros(len(matrix.nzval) + 1, dtype=NUMPY_DTYPE[self.prec])
            nz[:-1] = matrix.nzval
        h = hashlib.sha1(nz.tobytes())
        h.update(np.int64([self.flat_len, len(self.plans)]).tobytes())
        # the layout version (v2: the pack_diag_inv block-substitution
        # layout); a pack_bs other than PANEL changes the packed K and keys
        # in, as the JAX engine keys it
        h.update(b"factor-layout-v2")
        if self._pack_bs != PANEL:
            h.update(f"pack_bs={self._pack_bs}".encode())
        return FactorRoundCheckpointer(self._ckpt_dir, h.hexdigest())

    def _scan_done(self, ckpt) -> set[int]:
        """Resumable rounds: shape- and value-valid checkpoints, minus (to
        a fixpoint) any round whose Schur stack a not-yet-checkpointed
        consumer needs but whose S file is gone; dropping a round can
        orphan its own sources' Schur needs in turn."""
        done = ckpt.scan(self.plans)
        if not done:
            return done
        consumers: list[list[int]] = [[] for _ in self.plans]
        for rnd, plan in enumerate(self.plans):
            for g in plan.child_groups:
                consumers[g.src_round].append(rnd)
        changed = True
        while changed:
            changed = False
            for rnd in list(done):
                need = any(c not in done for c in consumers[rnd])
                if need and self.plans[rnd].M > 0 \
                        and not ckpt.has_schur(rnd):
                    done.discard(rnd)
                    changed = True
        return done

    def _save_round(self, ckpt, rnd: int, plan, K, U12, L21, perm, S):
        """Round ``rnd``'s factors (and Schur stack, if given) to the
        checkpoint directory: gathered whole under a mesh, written by the
        first rank alone, on disk for every rank when this returns."""
        with STAGES.stage("ckpt_save"):
            K, U12, L21, perm = self._gather_round(rnd, K, U12, L21, perm)
            if S is not None:
                S = self._gather_schur(rnd, S)
            if self._writer:
                ckpt.save_round(rnd, plan, K, U12, L21, perm, S,
                                pm=self._plan_pm(plan))
            self._mesh_barrier()

    def _save_schur(self, ckpt, rnd: int, S) -> None:
        with STAGES.stage("ckpt_save"):
            S = self._gather_schur(rnd, S)
            if self._writer:
                ckpt.save_schur(rnd, S)
            self._mesh_barrier()

    def _drop_schur(self, ckpt, rnd: int) -> None:
        if self._writer:
            with STAGES.stage("ckpt_save"):
                ckpt.drop_schur(rnd)

    # -- factor -------------------------------------------------------------

    def refactor(self, matrix: SparseMatrix) -> None:
        """New numeric values, same pattern (Newton-iteration reuse)."""
        self._factorize(matrix)

    def _factorize(self, matrix: SparseMatrix) -> None:
        # drop the previous factors first: both sets resident at once
        # would double the peak
        self.factors = None
        self.kd = [None] * len(self.plans)
        nz = np.zeros(len(matrix.nzval) + 1, dtype=NUMPY_DTYPE[self.prec])
        nz[:-1] = matrix.nzval
        # GESP static-pivot threshold: sqrt(eps) of the factor precision
        # times the largest (factor-precision) value, rounded through f32
        # as the JAX engine does at either dtype
        eps = float(np.finfo(nz.dtype).eps)
        amax = float(np.max(np.abs(nz))) if len(matrix.nzval) else 1.0
        self._tau = float(np.float32(np.sqrt(eps) * amax))
        self._ckpt = self._ckpt_for(matrix, nz)
        t0 = time.perf_counter()
        with timed("factor dispatch"):
            nzval_ext = self._put(nz, self.prec)
            factors = self._factor_rounds(nzval_ext)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.timings["factor"] = time.perf_counter() - t0
        if self._factor_only:
            dbg(1, f"factor-only: factors persisted to {self._ckpt_dir}; "
                   f"engine holds none")
            factors = None
        self.factors = factors

    def _factor_rounds(self, nzval_ext) -> tuple:
        """Walk the rounds in dependency order, freeing each Schur stack
        as soon as its last consumer has extend-added it. With a round
        checkpointer, rounds with a valid checkpoint are loaded, the others
        computed and saved (see the class docstring); ``loaded_rounds``
        lists the rounds that came from the checkpoints. Each round is a
        scope of the stage timer (utils.profiling.STAGES), as are its
        assembly, extend-add, partial factorization and checkpoint I/O."""
        ckpt = self._ckpt
        self.loaded_rounds = []
        factors = []
        schur: list = [None] * len(self.plans)
        uses = [0] * len(self.plans)
        consumers: list[list[int]] = [[] for _ in self.plans]
        for rnd, plan in enumerate(self.plans):
            for g in plan.child_groups:
                uses[g.src_round] += 1
                consumers[g.src_round].append(rnd)
        done: set[int] = set()
        repair: set[int] = set()
        if ckpt is not None:
            done = self._scan_done(ckpt)
            # Schur repair: rounds whose factors are on disk but whose
            # Schur stack a pending consumer needs is gone are recomputed
            # for their Schur only; their factor files are kept
            repair = ckpt.scan(self.plans) - done
            if repair:
                dbg(1, f"factor checkpoint: {len(repair)} rounds have "
                       f"valid factors but missing Schur stacks; "
                       f"recomputing them for their Schur only")
            # no rank writes before every rank has scanned
            self._mesh_barrier()
        t_round = time.perf_counter()
        for rnd, plan in enumerate(self.plans):
            with STAGES.round(rnd, plan):
                if rnd in done:
                    need_s = (plan.M > 0
                              and any(c not in done for c in consumers[rnd]))
                    with STAGES.stage("ckpt_load"):
                        loaded = ckpt.load_round(rnd, plan, self,
                                                 need_schur=need_s,
                                                 factors=not self._offload)
                    if loaded is not None:
                        self.loaded_rounds.append(rnd)
                        for g in plan.child_groups:
                            uses[g.src_round] -= 1
                            if uses[g.src_round] == 0:
                                schur[g.src_round] = None
                                self._drop_schur(ckpt, g.src_round)
                        factors.append(loaded[:4])
                        schur[rnd] = loaded[4]
                        # schur[rnd] must hold the stack's only reference, or
                        # it outlives its last consumer
                        del loaded
                        continue
                    # the checkpoint vanished mid-run: recompute
                    done.discard(rnd)
                cc = self._round_consts(rnd)
                with STAGES.stage("assemble"):
                    F = ck.ell_assemble(nzval_ext, cc["a_col"], cc["a_csrc"],
                                        cc["a_pos"], cc["a_src"],
                                        cc["p_arr"], plan.N, plan.P,
                                        cc["spill"])
                drops: list[int] = []
                with STAGES.stage("extend_add"):
                    for (src_rnd, ss, ds, inv, waves), xplan in zip(
                            cc["groups"], cc["exchange"]):
                        S_src = self._source_schur(src_rnd, schur[src_rnd],
                                                   xplan)
                        if waves:
                            extend_add(F, S_src, ss, ds, inv, waves)
                        del S_src
                        uses[src_rnd] -= 1
                        if uses[src_rnd] == 0:
                            # free the device memory now, but delete the
                            # source's file only once this round's own
                            # checkpoint is on disk: a death between the
                            # two must leave a resumable prefix
                            schur[src_rnd] = None
                            drops.append(src_rnd)
                # a mesh engine never takes the library LU (mf_jax: no native
                # LU under a mesh), so its tree-top pivots are the panel's
                with STAGES.stage("partial_factor"):
                    K, U12, L21, S, perm = partial_factor(
                        F, plan.P, cc["p_arr"], self._tau, self._pack_bs,
                        allow_native_lu=self.mesh is None)
                del F
                lay = self.layouts[rnd]
                if lay.kind == "row":
                    K, U12, L21, perm, self.kd[rnd] = shard_round(
                        lay, plan, K, U12, L21, perm, self._own)
                    S = shard_schur(lay, plan, S, self._own)
                schur[rnd] = S if uses[rnd] > 0 else None
                if ckpt is not None:
                    # the host copy in either save synchronizes the round
                    if rnd not in repair:
                        self._save_round(ckpt, rnd, plan, K, U12, L21, perm,
                                         schur[rnd])
                    elif schur[rnd] is not None and plan.M > 0:
                        self._save_schur(ckpt, rnd, S)
                    for src in drops:
                        self._drop_schur(ckpt, src)
                    now = time.perf_counter()
                    dbg(1, f"factor round {rnd + 1}/{len(self.plans)} "
                           f"B={plan.B} P={plan.P} N={plan.N} "
                           f"({now - t_round:.1f}s)"
                           + (" [repair]" if rnd in repair else ""))
                    t_round = now
                if self._offload:
                    factors.append((None,) * 4)
                    self.kd[rnd] = None
                else:
                    factors.append((K, U12, L21, perm))
                del K, U12, L21, S, perm
                if self._stop_after is not None and rnd >= self._stop_after:
                    dbg(1, f"factor stop-after: handing off at round {rnd} "
                           f"({len(self.plans) - 1 - rnd} rounds remain)")
                    return tuple(factors)
        if ckpt is not None:
            # every round is on disk now: no resume needs a Schur stack
            for rnd, plan in enumerate(self.plans):
                if plan.M > 0:
                    self._drop_schur(ckpt, rnd)
            if self._offload and not self._factor_only:
                dbg(1, f"factor offload: streaming factors back from "
                       f"{ckpt.dir}")
                for rnd, plan in enumerate(self.plans):
                    if factors[rnd][0] is None:
                        with STAGES.stage("ckpt_load"):
                            factors[rnd] = ckpt.load_round(
                                rnd, plan, self, need_schur=False)[:4]
        return tuple(factors)

    # -- solve --------------------------------------------------------------

    def _hi_round(self, plan) -> bool:
        return plan.P >= HI_ROUND_MIN_P and self.prec == torch.float32

    def solve_workspace(self, W: torch.Tensor) -> torch.Tensor:
        """Solve in place on W (flat_len + 1, nrhs), a tensor of the factor
        dtype on the engine's device holding the right-hand sides above its
        zero dump row; returns W. The device-side solve the refiner applies
        as its preconditioner (mf_jax.JaxMultifrontal._solve_program).

        Under a mesh every rank passes the same W and gets the same
        result. With an "rhs" axis whose size divides nrhs, each mesh
        column solves its own block of columns and the blocks are
        gathered along the rows of the mesh (mf_jax._put_rhs).

        The sweep takes one of three routes (``sweep_counts`` counts
        them; the span's ``route`` argument names it): "eager", launch by
        launch; on a graphable engine (``_graphable``) the second sweep
        at a width on the same factors is "capture", which records the
        eager sweep's launches into a CUDA graph over a static workspace
        and replays it once, and every later one "replay": W is copied
        in, the graph launched and the result copied back to W."""
        if self.factors is None:
            raise RuntimeError("no numeric factors: call refactor() first")
        mesh = self.mesh
        key = (W.shape[1], W.dtype)
        if key in self._graphs:
            route = "replay"
        elif key in self._swept and self._graphable():
            route = "capture"
        else:
            route = "eager"
        with span("engine.sweep", pack_bs=self._pack_bs, route=route):
            if route == "eager":
                self.sweep_counts["eager"] += 1
                self._swept.add(key)
                if mesh is not None and mesh.rhs_groups \
                        and W.shape[1] % mesh.shape[1] == 0:
                    w = W.shape[1] // mesh.shape[1]
                    c = mesh.coords[1]
                    Wc = self._sweep(W[:, c * w:(c + 1) * w].contiguous())
                    return coll.all_gather(Wc, mesh.rhs_group, dim=1)
                return self._sweep(W)
            if route == "capture":
                self.sweep_counts["captured"] += 1
                static = torch.zeros(W.shape, dtype=W.dtype, device=W.device)
                self._graphs[key] = (static,
                                     _capture(lambda: self._sweep(static)))
            else:
                self.sweep_counts["replayed"] += 1
            static, graph = self._graphs[key]
            static.copy_(W)
            graph.replay()
            return W.copy_(static)

    def _graphable(self) -> bool:
        """Whether the sweep may be captured: a CUDA engine without a mesh
        (whose rounds call collectives) and without offloaded factors,
        none of whose rounds is a ``_hi_round`` (a graph's pool would pin
        their float64 upcasts of the factors)."""
        return (_can_capture(self.device) and self.mesh is None
                and not self._offload
                and not any(self._hi_round(p) for p in self.plans))

    def _sweep(self, W: torch.Tensor) -> torch.Tensor:
        """The forward then backward sweep over all rounds, in place; hi
        rounds (``_hi_round``) substitute in float64 on transient upcasts
        of the factors and store back at W's dtype. Each round's
        substitution is a span, its round number and front shape (B, P, N)
        in the range's arguments."""
        consts = [self._round_consts(r) for r in range(len(self.plans))]
        hi = [self._hi_round(p) for p in self.plans]
        args = self._round_args
        for rnd in range(len(self.plans)):
            with span("engine.fwd", **args[rnd]):
                W = self._fwd(rnd, W, consts[rnd], hi[rnd])
        for rnd in reversed(range(len(self.plans))):
            with span("engine.bwd", **args[rnd]):
                W = self._bwd(rnd, W, consts[rnd], hi[rnd])
        return W

    def _fwd(self, rnd: int, W, cc: dict, hi: bool):
        """One round's forward substitution on this rank's fronts, in every
        layout: y = L11^-1 P rhs (masked over the column shards of K on a
        row-sharded round with a diagonal-block stack) and the border
        update L21 y, at W's dtype. A batch-sharded round then gathers y
        and the update from every rank, a row-sharded border its update
        rows; every rank stores the whole round's results in the
        single-device order."""
        K, _, L21, perm = self.factors[rnd]
        lay, KD, g = self.layouts[rnd], self.kd[rnd], self._fgroup
        nrhs = W.shape[1]
        rhs = torch.gather(W[cc["own_l"]], 1,
                           perm[:, :, None].expand(-1, -1, nrhs))
        rhs, K, L21, KD = upcast(hi, rhs, K, L21, KD)
        if KD is not None:
            y = block_lower_apply_masked(K, KD, rhs,
                                         lay.chunk(self.plans[rnd].P)[0],
                                         self._psum)
        else:
            y = block_lower_apply(K, rhs, self._pack_bs)
        upd = (L21 @ y).to(W.dtype)
        y = y.to(W.dtype)
        if lay.split:
            y, upd = coll.all_gather(y, g), coll.all_gather(upd, g)
        elif lay.border:
            upd = coll.all_gather(upd, g, dim=1)
        return fwd_store(W, y, upd, cc["own"], cc["border"])

    def _bwd(self, rnd: int, W, cc: dict, hi: bool):
        """One round's backward substitution x = U11^-1 (rhs - U12 xb)
        (layouts as in ``_fwd``; a row-sharded border sums U12 xb over its
        shards)."""
        K, U12, _, _ = self.factors[rnd]
        lay, plan, KD = self.layouts[rnd], self.plans[rnd], self.kd[rnd]
        rhs, xb = W[cc["own_l"]], W[cc["bor_l"]]
        rhs, xb, K, U12, KD = upcast(hi, rhs, xb, K, U12, KD)
        if lay.border:
            m0, m1 = lay.chunk(plan.M)
            t = rhs - self._psum(U12 @ xb[:, m0:m1])
        else:
            t = rhs - U12 @ xb
        if KD is not None:
            x = block_upper_apply_masked(K, KD, t, lay.chunk(plan.P)[0],
                                         self._psum)
        else:
            x = block_upper_apply(K, t, self._pack_bs)
        x = x.to(W.dtype)
        if lay.split:
            x = coll.all_gather(x, self._fgroup)
        return set_own(W, x, cc["own"])

    def sweep_bytes(self, nrhs: int = 1) -> int:
        """The bytes one forward-plus-backward sweep of ``nrhs`` right-hand
        sides reads and writes at the least, counted from the resident
        tensors: each round's K once (its lower triangle in the forward
        sweep, its upper in the backward), L21, U12 and perm once each, and
        the workspace (flat_len + 1, nrhs) read and written once. Under a
        mesh, this rank's slices."""
        if self.factors is None:
            raise RuntimeError("no numeric factors: call refactor() first")
        n = sum(t.numel() * t.element_size() for f in self.factors
                for t in f)
        return n + 2 * (self.flat_len + 1) * nrhs * self.prec.itemsize

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
