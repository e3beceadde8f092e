"""Column-graph construction and nested-dissection ordering (host side).

This replaces the external ParMETIS fill-reducing ordering + SuperLU_DIST
symbolic machinery the reference depends on (src/solve_ABdist.c:494-495:
options.ColPerm = PARMETIS, ParSymbFact = YES). Unlike a general-purpose
solver we know the geometry: the flat state vector is a j/i/k enumeration
of wet cells where each water column's cells are contiguous
(src/matrix.c:239-251), and the only horizontal couplings are short
stencil offsets. So the ordering operates on the 2-D graph of *water
columns* — whole columns become dense blocks (every within-column coupling,
including matrix_file vertical mixing and generic-tracer source levels, is
inside a block) and nested dissection on the 2-D column graph yields the
supernode tree whose fronts the TPU factors as dense MXU tiles.

Coupled-tracer systems fold in naturally: a super-column holds the cells
of ALL tracers at one (j,i) (cross-tracer coupling is cell-diagonal,
src/matrix.c:954-961), preserving the 2-D block-stencil structure.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..grid import IndexMaps
from ..io.matrixfile import SparseMatrix


@dataclass
class ColumnGraph:
    ncols: int
    col_j: np.ndarray        # (ncols,)
    col_i: np.ndarray
    depth: np.ndarray        # (ncols,) wet levels per column
    cell_start: np.ndarray   # (ncols,) first tracer-state index of the column
    nt: int                  # coupled tracer count
    tsl: int                 # tracer_state_len
    adj_indptr: np.ndarray   # CSR column-column adjacency (excl. self)
    adj_indices: np.ndarray
    col_of_cell: np.ndarray  # (tsl,) column id per tracer-state cell

    def neighbors(self, c: int) -> np.ndarray:
        return self.adj_indices[self.adj_indptr[c]:self.adj_indptr[c + 1]]

    def neighbors_of(self, cols: np.ndarray) -> np.ndarray:
        """Unique neighbors of a set of columns — one vectorized gather
        (the per-column Python loop was a gx1-scale hot spot)."""
        if len(cols) == 0:
            return np.empty(0, dtype=np.int64)
        starts = self.adj_indptr[cols]
        counts = self.adj_indptr[cols + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, dtype=np.int64)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        return np.unique(self.adj_indices[np.repeat(starts, counts) + offs])

    def block_cells(self, c: int) -> np.ndarray:
        """All matrix indices belonging to super-column c (t-major)."""
        s, d = self.cell_start[c], self.depth[c]
        base = np.arange(s, s + d)
        return np.concatenate([t * self.tsl + base for t in range(self.nt)])

    def cells_of_cols(self, cols: np.ndarray) -> np.ndarray:
        """Concatenated block_cells over many columns, vectorized,
        preserving block_cells' order (per column: tracer-major)."""
        if len(cols) == 0:
            return np.empty(0, dtype=np.int64)
        d = self.depth[cols].astype(np.int64)
        s = self.cell_start[cols].astype(np.int64)
        total = int(d.sum())
        offs = np.arange(total) - np.repeat(np.cumsum(d) - d, d)
        base = np.repeat(s, d) + offs            # per-column contiguous cells
        if self.nt == 1:
            return base
        seg = np.repeat(np.arange(len(cols)), d)
        allc = np.concatenate([base + t * self.tsl for t in range(self.nt)])
        allseg = np.tile(seg, self.nt)
        allt = np.repeat(np.arange(self.nt), total)
        alloff = np.tile(offs, self.nt)
        order = np.lexsort((alloff, allt, allseg))
        return allc[order]

    @property
    def block_size(self) -> np.ndarray:
        return self.depth * self.nt


def build_column_graph(maps: IndexMaps, matrix: SparseMatrix) -> ColumnGraph:
    """Derive columns and their adjacency directly from the CSR pattern —
    exact for any option combination (stencil reach varies with adv/hmix
    choices, src/matrix.c:478-591)."""
    tsl = maps.tracer_state_len
    nt = matrix.coupled_tracer_cnt
    # column boundaries: cells are contiguous per (j,i) in enumeration order
    jj, ii = maps.ind_to_j, maps.ind_to_i
    is_new = np.ones(tsl, dtype=bool)
    is_new[1:] = (jj[1:] != jj[:-1]) | (ii[1:] != ii[:-1])
    cell_start = np.flatnonzero(is_new)
    ncols = len(cell_start)
    depth = np.diff(np.append(cell_start, tsl))
    col_of_cell = np.cumsum(is_new) - 1
    col_j = jj[cell_start]
    col_i = ii[cell_start]

    # column-column adjacency from the CSR pattern. The native path is one
    # C pass over colind (this host has ~0.25 GB/s memory bandwidth —
    # numpy formulations need several full passes over nnz-sized
    # temporaries and dominated the 1-degree symbolic phase); the fallback
    # dedupes via scipy's COO->CSR bucketing.
    from scipy.sparse import coo_matrix
    row_cols = (col_of_cell if nt == 1
                else np.tile(col_of_cell, nt))   # column id per matrix row
    from ..native import column_adjacency
    pairs = column_adjacency(matrix.rowptr, matrix.colind, row_cols, ncols)
    if pairs is not None:
        rc, cc = pairs
    else:
        rowlen = np.diff(matrix.rowptr)
        rc = np.repeat(row_cols, rowlen)
        cc = row_cols[matrix.colind]
        mask = rc != cc
        rc, cc = rc[mask], cc[mask]
    adj = coo_matrix((np.ones(len(rc), dtype=np.int8), (rc, cc)),
                     shape=(ncols, ncols)).tocsr()
    adj.data.fill(1)   # int8 duplicate sums may wrap; only the pattern matters
    # symmetrize (factorization treats the pattern symmetrically)
    adj = adj + adj.T
    adj.sort_indices()
    return ColumnGraph(ncols=ncols, col_j=col_j, col_i=col_i, depth=depth,
                       cell_start=cell_start, nt=nt, tsl=tsl,
                       adj_indptr=adj.indptr.astype(np.int64),
                       adj_indices=adj.indices.astype(np.int64),
                       col_of_cell=col_of_cell)


@dataclass
class DissectionNode:
    owned: np.ndarray               # column ids eliminated at this node
    children: list[int] = field(default_factory=list)
    parent: int = -1
    round: int = 0                  # 0 = leaves; parents after children


@dataclass
class DissectionTree:
    nodes: list[DissectionNode]
    postorder: np.ndarray           # node ids, children before parents
    col_elim_pos: np.ndarray        # (ncols,) global elimination position
    owner_node: np.ndarray          # (ncols,) node id owning each column


def nested_dissection(graph: ColumnGraph, leaf_size: int = 32) -> DissectionTree:
    """Recursive coordinate bisection with vertex separators.

    Split a column set at the median of its wider coordinate extent; the
    separator is the set of A-side endpoints of cut edges, which handles
    the zonal wraparound and distance-2 (upwind3) couplings with no special
    cases — wrap edges simply appear as extra cut edges.
    """
    nodes: list[DissectionNode] = []
    side = np.zeros(graph.ncols, dtype=np.int8)  # scratch: 0=A, 1=B

    def recurse(cols: np.ndarray, er: np.ndarray, ec: np.ndarray) -> int:
        """cols plus the edge list internal to cols (both directions)."""
        if len(cols) <= leaf_size:
            nodes.append(DissectionNode(owned=np.sort(cols)))
            return len(nodes) - 1
        js = graph.col_j[cols]
        is_ = graph.col_i[cols]
        if js.max() - js.min() >= is_.max() - is_.min():
            coord = js
        else:
            coord = is_
        med = np.median(coord)
        sideA = coord <= med
        if sideA.all() or not sideA.any():
            sideA = coord < med
            if not sideA.any():  # degenerate: all same coordinate
                half = len(cols) // 2
                sideA = np.zeros(len(cols), dtype=bool)
                sideA[:half] = True
        side[cols] = np.where(sideA, 0, 1).astype(np.int8)
        # separator: A-side endpoints of A-B cut edges
        cut = (side[er] == 0) & (side[ec] == 1)
        sep = np.unique(er[cut])
        in_sep = np.zeros(graph.ncols, dtype=bool)
        in_sep[sep] = True
        A_rest = cols[sideA & ~in_sep[cols]]
        B = cols[~sideA]
        if len(sep) == 0 or (len(A_rest) == 0 and len(B) == 0):
            nodes.append(DissectionNode(owned=np.sort(cols)))
            return len(nodes) - 1
        children = []
        for part in (A_rest, B):
            if len(part) == 0:
                continue
            in_part = np.zeros(graph.ncols, dtype=bool)
            in_part[part] = True
            keep = in_part[er] & in_part[ec]
            children.append(recurse(part, er[keep], ec[keep]))
        me = len(nodes)
        nodes.append(DissectionNode(owned=np.sort(sep), children=children))
        for ch in children:
            nodes[ch].parent = me
        return me

    import sys
    er_all = np.repeat(np.arange(graph.ncols, dtype=np.int64),
                       np.diff(graph.adj_indptr))
    ec_all = graph.adj_indices.astype(np.int64)
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        recurse(np.arange(graph.ncols, dtype=np.int64), er_all, ec_all)
    finally:
        sys.setrecursionlimit(old_limit)

    # rounds + postorder
    post = []

    def walk(nid):
        for ch in nodes[nid].children:
            walk(ch)
        nodes[nid].round = (
            1 + max((nodes[ch].round for ch in nodes[nid].children), default=-1))
        post.append(nid)

    root = len(nodes) - 1
    walk(root)
    postorder = np.array(post, dtype=np.int64)

    col_elim_pos = np.empty(graph.ncols, dtype=np.int64)
    owner_node = np.empty(graph.ncols, dtype=np.int64)
    pos = 0
    for nid in postorder:
        owned = nodes[nid].owned
        col_elim_pos[owned] = np.arange(pos, pos + len(owned))
        owner_node[owned] = nid
        pos += len(owned)
    assert pos == graph.ncols
    return DissectionTree(nodes=nodes, postorder=postorder,
                          col_elim_pos=col_elim_pos, owner_node=owner_node)
