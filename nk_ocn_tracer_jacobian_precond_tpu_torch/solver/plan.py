"""Round plans of the multifrontal numeric phase (host side, numpy only).

A copy of the JAX package's ``solver/mf_jax.py`` plan builder
(``build_plan``, ``RoundPlan``, ``ChildGroup`` and their helpers), which
cannot be imported from there because that module imports jax. The port
must reproduce the JAX engine's rounds, padding and assembly routing array
for array, or pivots and factors differ; ``tests/test_torch_plan.py``
holds the copy equal to the original. The only change: the memory budget
is an argument and no environment variable overrides it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.matrixfile import SparseMatrix
from ..native import plan_entries
from .symbolic import SymbolicFactorization

LANE = 128


def _round_up(x: int, m: int) -> int:
    return max(m, (x + m - 1) // m * m)


_ARANGE = np.empty(0, dtype=np.int64)


def _ar(n: int) -> np.ndarray:
    """Cached arange — build_plan asks for one per front per round, and
    at 1-degree scale the per-call allocations dominated the plan time."""
    global _ARANGE
    if len(_ARANGE) < n:
        _ARANGE = np.arange(max(n, 2 * len(_ARANGE)), dtype=np.int64)
    return _ARANGE[:n]


def _pad_batch(b: int, mult: int = 1) -> int:
    """Pad a round's batch count: powers of two up to 128, multiples of
    128 above (the dummy identity fronts are cheap individually, but a
    power-of-2 jump at large B nearly doubled round-1's transient front
    memory). With ``mult`` = mesh size, rounds with at least ``mult``
    real fronts additionally round up to a multiple of it so their batch
    axis always shards (dummy fronts are cheap at that size). Smaller
    rounds are NOT padded up — measured at 1-degree scale, padding a
    1-2-front tree-top round to the mesh size just multiplies its
    storage by the mesh size for zero per-device gain; those rounds get
    their factor ARRAYS sharded along the front axes instead (see
    JaxMultifrontal._shard_factors)."""
    if b >= 128:
        p = _round_up(b, 128)
    else:
        p = 1
        while p < b:
            p *= 2
    return _round_up(p, mult) if mult > 1 and b >= mult else p


def _pad_dim(x: int) -> int:
    """Pad a front dimension to a bucketed size: powers of two up to 512
    (maximizes compiled-kernel reuse across rounds and matrices — compile
    time is a first-order cost on a remote-compile TPU), multiples of the
    128 lane width above that (large fronts dominate memory; power-of-2
    padding there wastes up to 2x HBM for little compile-cache benefit —
    the gx3 OOM of round 1)."""
    if x <= 8:
        return 8
    if x >= 512:
        return _round_up(x, LANE)
    p = 8
    while p < x:
        p *= 2
    return p


@dataclass
class ChildGroup:
    """All extend-add links from one earlier round into this round,
    batched: dst front [dst_slots[l]] += S_src[src_slots[l]][inv[l]][:, inv[l]]."""
    src_round: int
    src_slots: np.ndarray  # (L,) batch slots in the source round's Schur stack
    dst_slots: np.ndarray  # (L,) batch slots in this round
    inv: np.ndarray        # (L, N) position in child's border (or M_src = pad)


@dataclass
class RoundPlan:
    node_ids: list[int]
    B: int
    P: int                 # padded eliminated size
    N: int                 # padded front size
    M: int                 # N - P (padded border size)
    a_col: np.ndarray      # (B, N, W) ELL front-column per row entry (pad -> 0)
    a_csrc: np.ndarray     # (B, N, W) nzval index per row entry (pad -> nnz: zero)
    a_pos: np.ndarray      # (B, E) SPILL scatter positions into N*N (pad -> N*N)
    a_src: np.ndarray      # (B, E) SPILL indices into CSR nzval (pad -> nnz)
    p_arr: np.ndarray      # (B,) true eliminated count per front (0 for dummies)
    cells_own: np.ndarray  # (B, P) matrix indices of eliminated cells (pad -> flat_len)
    cells_bor: np.ndarray  # (B, M) matrix indices of border cells (pad -> flat_len)
    child_groups: list[ChildGroup]


def build_plan(sym: SymbolicFactorization, matrix: SparseMatrix,
               mem_budget_bytes: float = 1.5e9,
               bytes_per_elem: int = 4,
               batch_multiple: int = 1) -> list[RoundPlan]:
    """Compile the symbolic factorization into static per-round arrays.

    Depends only on the sparsity pattern; reusable across matrices with
    the same pattern (every Newton iteration of a spin-up run).

    Entry routing is fully vectorized: each CSR entry (r, c) is assembled
    exactly once, in the front owning the earlier-eliminated of the two
    cells (if that is c, the entry lands in the owned-column block; if r,
    in the owned-row x border block) — the standard multifrontal assembly
    rule expressed as array ops over all nnz at once.
    """
    # The budget changes the plan (chunk boundaries). The port takes it as
    # an argument only: the JAX package's NK_MEM_BUDGET override is not
    # read here.
    flat_len = sym.flat_len
    csr_rowptr = np.asarray(matrix.rowptr)
    csr_colind = np.asarray(matrix.colind, dtype=np.int64)
    nnz = len(csr_colind)
    # int32 routing/scatter-index safety: plan_entries and a_src narrow to
    # int32, and the assembly scatter runs with promise_in_bounds — an
    # overflowed index would be silent corruption, so refuse loudly
    if flat_len >= 2 ** 31 or nnz >= 2 ** 31:
        raise ValueError(f"matrix too large for the int32 plan path "
                         f"(flat_len={flat_len}, nnz={nnz} must be < 2^31)")
    # the promise_in_bounds + unique_indices assembly scatter is only safe
    # for canonical CSR (column-sorted, duplicate-free rows — what
    # assemble.py::to_csr emits); a hand-made matrix file with duplicate
    # (r, c) entries would silently corrupt the factors. O(nnz) check.
    if nnz > 1:
        starts = np.zeros(nnz, dtype=bool)
        starts[csr_rowptr[1:-1]] = True
        if not np.all((np.diff(csr_colind) > 0) | starts[1:]):
            raise ValueError(
                "matrix CSR is not canonical (columns not strictly "
                "increasing within rows; duplicates?) — re-canonicalize "
                "with ops.assemble.to_csr before factorization")

    # --- global per-cell tables -------------------------------------------
    cell_node = np.empty(flat_len, dtype=np.int64)   # owning node per cell
    cell_elim = np.empty(flat_len, dtype=np.int64)   # elimination position
    for nid, f in sym.fronts.items():
        cell_node[f.cells[:f.p]] = nid
        # per-cell elimination position: order within the permutation
    cell_elim[sym.perm] = np.arange(flat_len)

    # --- route every CSR entry to its assembly front, grouped per front.
    # Native path: one fused C routing + counting sort (plan_entries);
    # fallback: the same grouping via numpy argsort.
    pe = plan_entries(csr_rowptr, csr_colind, cell_node, cell_elim,
                      len(sym.fronts))
    if pe is not None:
        ent_row, ent_col, ent_src, bounds = pe
    else:
        rows = np.repeat(np.arange(flat_len, dtype=np.int64),
                         np.diff(csr_rowptr))
        col_first = cell_elim[csr_colind] <= cell_elim[rows]
        entry_node = np.where(col_first, cell_node[csr_colind],
                              cell_node[rows])
        order = np.argsort(entry_node, kind="stable")
        bounds = np.searchsorted(entry_node[order],
                                 np.arange(len(sym.fronts) + 1))
        ent_row = rows[order].astype(np.int32)
        ent_col = csr_colind[order].astype(np.int32)
        ent_src = order.astype(np.int32)

    # split each dependency round into memory-bounded, size-homogeneous
    # chunks: fronts sorted by size so each chunk's padding is tight, and
    # the REAL transient allocation — padded batch x (padded max P + padded
    # max M)^2 — stays under the budget (large rounds at 1-degree scale
    # would otherwise materialize tens of GB at once)
    chunked_rounds: list[list[int]] = []
    for node_ids in sym.rounds:
        by_size = sorted(node_ids, key=lambda nid: -sym.fronts[nid].n)
        chunk: list[int] = []
        maxp = maxm = 0
        for nid in by_size:
            f = sym.fronts[nid]
            p2 = max(maxp, f.p)
            m2 = max(maxm, f.n - f.p)
            n_pad = _pad_dim(p2) + (_pad_dim(m2) if m2 > 0 else 0)
            cost = (_pad_batch(len(chunk) + 1, batch_multiple)
                    * n_pad * n_pad * bytes_per_elem)
            if chunk and cost > mem_budget_bytes:
                chunked_rounds.append(chunk)
                chunk, maxp, maxm = [], 0, 0
            chunk.append(nid)
            maxp = max(maxp, f.p)
            maxm = max(maxm, f.n - f.p)
        if chunk:
            chunked_rounds.append(chunk)

    plans: list[RoundPlan] = []
    slot_of_node: dict[int, tuple[int, int]] = {}
    # flat scratch of padded front positions per cell: one write + gathers
    # per front instead of argsort+searchsorted (gx1-scale hot spot).
    # int32: positions < padded max front (~2^15), and the narrower
    # gathers halve traffic on this bandwidth-starved host
    cell_fpos = np.empty(flat_len, dtype=np.int32)
    for rnd, node_ids in enumerate(chunked_rounds):
        B_real = len(node_ids)
        # pad the batch as well: dummy identity fronts cost almost nothing
        # individually and make (B, P, N) shapes reusable across chunks
        # and problem sizes
        B = _pad_batch(B_real, batch_multiple)
        maxp = max(sym.fronts[nid].p for nid in node_ids)
        maxm = max(sym.fronts[nid].n - sym.fronts[nid].p for nid in node_ids)
        P = _pad_dim(maxp)
        M = _pad_dim(maxm) if maxm > 0 else 0
        N = P + M
        pos_l: list[np.ndarray] = [np.empty(0, np.int32)] * B
        src_l: list[np.ndarray] = [np.empty(0, np.int32)] * B
        cells_own = np.full((B, P), flat_len, dtype=np.int64)
        cells_bor = np.full((B, M), flat_len, dtype=np.int64)
        p_arr = np.zeros(B, dtype=np.int32)
        links: list[tuple[int, int, int, np.ndarray]] = []
        for b, nid in enumerate(node_ids):
            f = sym.fronts[nid]
            slot_of_node[nid] = (rnd, b)
            p, n = f.p, f.n
            p_arr[b] = p
            cells_own[b, :p] = f.cells[:p]
            if n > p:
                cells_bor[b, :n - p] = f.cells[p:]
            # padded front position per cell, via flat scratch gather
            cell_fpos[f.cells[:p]] = _ar(p)
            cell_fpos[f.cells[p:]] = P + _ar(n - p)

            s0, s1 = bounds[nid], bounds[nid + 1]
            if s1 > s0:
                rp = cell_fpos[ent_row[s0:s1]]
                cp = cell_fpos[ent_col[s0:s1]]
                # int32 arithmetic: rp*N+cp < padded_N^2 <= ~5e8 < 2^31
                pos_l[b] = rp * np.int32(N) + cp
                src_l[b] = ent_src[s0:s1]
            for ch in f.children:
                cf = sym.fronts[ch]
                src_rnd, src_slot = slot_of_node[ch]
                # capture the parent-front positions NOW (cell_fpos is
                # overwritten by later fronts sharing border cells); the
                # (L, N) inv matrices are built batched per group below
                q = cell_fpos[cf.cells[cf.p:]]
                links.append((src_rnd, src_slot, b, q))
        # Assembly routing, hybrid ELL + spill (ELLPACK form): most
        # entries pack into a per-row rectangle (B, N, W) consumed by the
        # gather/compare assembly kernel — a fused, bandwidth-bound
        # reduce with NO device scatter (the scatter was 31% of the
        # factor at gx3 even with unique+in-bounds promises). W is the
        # 98th-percentile row population of the chunk rounded up to a
        # power of two (shape-bucket reuse); the tail rows' overflow
        # entries spill to the old unique-index scatter, whose cost is
        # negligible at spill sizes. ELL pads: col 0 + the nzval
        # sentinel zero (adds 0.0 to column 0).
        cnts = []
        for b in range(B):
            if len(pos_l[b]):
                cnts.append(np.bincount(pos_l[b] // N, minlength=N))
            else:
                cnts.append(np.zeros(N, dtype=np.int64))
        allc = np.concatenate(cnts)
        occupied = allc[allc > 0]
        if occupied.size:
            w98 = int(np.quantile(occupied, 0.98))
            W = 1 << max(2, int(np.ceil(np.log2(max(w98, 1)))))
        else:
            W = 4
        a_col = np.zeros((B, N, W), dtype=np.int32)
        a_csrc = np.full((B, N, W), nnz, dtype=np.int32)
        spill_pos: list[np.ndarray] = [np.empty(0, np.int32)] * B
        spill_src: list[np.ndarray] = [np.empty(0, np.int32)] * B
        for b in range(B):
            pos, src = pos_l[b], src_l[b]
            if not len(pos):
                continue
            order = np.argsort(pos, kind="stable")
            pos, src = pos[order], src[order]
            rp = pos // N
            cnt = cnts[b]
            starts = np.cumsum(cnt) - cnt
            slot = _ar(len(pos)) - starts[rp].astype(np.int32)
            ell = slot < W
            a_col[b, rp[ell], slot[ell]] = (pos[ell] % N).astype(np.int32)
            a_csrc[b, rp[ell], slot[ell]] = src[ell]
            if not ell.all():
                spill_pos[b] = pos[~ell]
                spill_src[b] = src[~ell]
        E = max(max((len(x) for x in spill_pos), default=0), 1)
        # spill padding entries point at DISTINCT overflow slots past N*N
        # (the scatter buffer is N*N + E and gets truncated): every
        # scatter index is unique and in-bounds, so the device scatter
        # runs with unique_indices + promise_in_bounds (XLA:TPU
        # serializes a scatter it cannot prove duplicate-free)
        if N * N + E >= 2 ** 31:
            raise ValueError(f"padded front {N}x{N} + {E} entries overflows "
                             f"the int32 scatter index space")
        a_pos = np.tile(N * N + np.arange(E, dtype=np.int32), (B, 1))
        a_src = np.full((B, E), nnz, dtype=np.int32)
        for b in range(B):
            a_pos[b, :len(spill_pos[b])] = spill_pos[b]
            a_src[b, :len(spill_src[b])] = spill_src[b]
        groups: list[ChildGroup] = []
        for src_rnd in sorted({l[0] for l in links}):
            sel = [l for l in links if l[0] == src_rnd]
            M_src = plans[src_rnd].M
            L = len(sel)
            qs = [l[3] for l in sel]
            lens = np.array([len(q) for q in qs], dtype=np.int64)
            inv = np.full((L, N), M_src, dtype=np.int32)
            if lens.sum():
                rowidx = np.repeat(_ar(L), lens)
                qcat = np.concatenate(qs)
                total = int(lens.sum())
                offs = _ar(total) - np.repeat(np.cumsum(lens) - lens, lens)
                inv[rowidx, qcat] = offs.astype(np.int32)
            groups.append(ChildGroup(
                src_round=src_rnd,
                src_slots=np.array([l[1] for l in sel], dtype=np.int32),
                dst_slots=np.array([l[2] for l in sel], dtype=np.int32),
                inv=inv))
        plans.append(RoundPlan(
            node_ids=list(node_ids), B=B, P=P, N=N, M=M,
            a_col=a_col, a_csrc=a_csrc, a_pos=a_pos, a_src=a_src,
            p_arr=p_arr,
            cells_own=cells_own, cells_bor=cells_bor, child_groups=groups))
    return plans
