"""Symbolic multifrontal analysis (host side).

From the dissection tree, compute for every supernode its *front*: the
dense matrix over (owned cells | border cells), where border columns are
ancestor-owned columns coupled to the subtree:

    border(n) = (U_child border(child)  |  neighbors(owned(n))) \\ subtree(n)

This is the block-granular equivalent of SuperLU_DIST's symbolic
factorization + supernode detection (reference SuperLU_brief_tree.txt:5-8);
because borders live entirely inside ancestor separators, the recurrence is
exact — no extra fill beyond the dense blocks.

The output is a static execution plan: per processing round, the list of
fronts with their cell index sets, extend-add index maps into the parent
front, and A-assembly scatter maps. The numeric phase (numpy or JAX) just
replays the plan — the TPU side never sees a pointer or a dynamic shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.matrixfile import SparseMatrix
from ..utils import dbg
from .ordering import ColumnGraph, DissectionTree


@dataclass
class Front:
    node: int
    owned_cols: np.ndarray     # column ids, sorted by elimination position
    border_cols: np.ndarray    # column ids, sorted by elimination position
    cells: np.ndarray          # matrix indices: owned cells then border cells
    p: int                     # number of eliminated (owned) cells
    n: int                     # total front size
    parent: int                # parent node id (-1 at root)
    parent_map: np.ndarray | None  # position of this front's border cells
    #                                in the parent's front (len n - p)
    children: list[int]
    round: int


@dataclass
class SymbolicFactorization:
    fronts: dict[int, Front]           # node id -> Front
    rounds: list[list[int]]            # node ids per round (leaves first)
    perm: np.ndarray                   # permuted order: cells by elimination
    iperm: np.ndarray
    flat_len: int

    @property
    def max_front(self) -> int:
        return max(f.n for f in self.fronts.values())

    def factor_nnz(self) -> int:
        return sum(f.p * (2 * f.n - f.p) for f in self.fronts.values())

    def factor_flops(self) -> float:
        tot = 0.0
        for f in self.fronts.values():
            p, n, b = f.p, f.n, f.n - f.p
            tot += 2.0 / 3.0 * p ** 3 + 2.0 * p * p * b + 2.0 * p * b * b
        return tot


def _compute_borders(graph: ColumnGraph,
                     tree: DissectionTree) -> dict[int, np.ndarray]:
    """Bottom-up border recurrence over the postorder:
    border(n) = (U_child border(child) | neighbors(owned(n))) \\ subtree(n).
    Subtree membership tests use min/max elimination position (postorder
    gives each subtree a contiguous elim range)."""
    nodes = tree.nodes
    elim = tree.col_elim_pos
    border: dict[int, np.ndarray] = {}
    sub_lo: dict[int, float] = {}
    sub_hi: dict[int, float] = {}
    for nid in tree.postorder:
        nd = nodes[nid]
        lo = elim[nd.owned].min() if len(nd.owned) else np.inf
        hi = elim[nd.owned].max() if len(nd.owned) else -np.inf
        for ch in nd.children:
            lo = min(lo, sub_lo[ch])
            hi = max(hi, sub_hi[ch])
        sub_lo[nid], sub_hi[nid] = lo, hi
        cand = [border[ch] for ch in nd.children]
        cand.append(graph.neighbors_of(np.asarray(nd.owned, dtype=np.int64)))
        allc = np.unique(np.concatenate(cand)) if cand else np.empty(0, np.int64)
        # outside the subtree == eliminated after every column in it
        outside = allc[(elim[allc] < lo) | (elim[allc] > hi)]
        # only later-eliminated columns remain (earlier ones are impossible
        # with vertex separators, but filter defensively)
        border[nid] = outside[elim[outside] > hi]
    return border


def analyze(graph: ColumnGraph, tree: DissectionTree) -> SymbolicFactorization:
    nodes = tree.nodes
    elim = tree.col_elim_pos

    def by_elim(cols: np.ndarray) -> np.ndarray:
        return cols[np.argsort(elim[cols], kind="stable")]

    border = _compute_borders(graph, tree)

    fronts: dict[int, Front] = {}
    for nid in tree.postorder:
        nd = nodes[nid]
        oc = by_elim(nd.owned)
        bc = by_elim(border[nid])
        cells = np.concatenate(
            [graph.cells_of_cols(oc), graph.cells_of_cols(bc)])
        p = int(graph.block_size[oc].sum())
        fronts[nid] = Front(node=nid, owned_cols=oc, border_cols=bc,
                            cells=cells, p=p, n=len(cells),
                            parent=nd.parent, parent_map=None,
                            children=list(nd.children), round=nd.round)

    # extend-add maps: child border cells -> positions in parent front.
    # One flat scratch array instead of a per-parent dict (a gx1-scale
    # hot spot); each parent's positions are written once, then every
    # child maps its border by a single gather.
    pos_of_cell = np.empty(graph.nt * graph.tsl, dtype=np.int64)
    for nid in tree.postorder:
        pf = fronts[nid]
        if not pf.children:
            continue
        pos_of_cell[pf.cells] = np.arange(pf.n)
        for ch in pf.children:
            cf = fronts[ch]
            cf.parent_map = pos_of_cell[cf.cells[cf.p:]]

    nrounds = max(f.round for f in fronts.values()) + 1
    rounds = [[] for _ in range(nrounds)]
    for nid in tree.postorder:
        rounds[fronts[nid].round].append(nid)

    perm = np.concatenate([fronts[nid].cells[:fronts[nid].p]
                           for nid in tree.postorder])
    flat_len = graph.nt * graph.tsl
    assert len(perm) == flat_len, (len(perm), flat_len)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(flat_len)
    sym = SymbolicFactorization(fronts=fronts, rounds=rounds, perm=perm,
                                iperm=iperm, flat_len=flat_len)
    dbg(1, f"symbolic: {len(fronts)} fronts, {nrounds} rounds, "
           f"max front {sym.max_front}, factor nnz {sym.factor_nnz():,}, "
           f"flops {sym.factor_flops():.3e}")
    return sym


def _front_flops(p: float, n: float) -> float:
    b = n - p
    return 2.0 / 3.0 * p ** 3 + 2.0 * p * p * b + 2.0 * p * b * b


def amalgamate(graph: ColumnGraph, tree: DissectionTree,
               relax: float = 0.25, min_cells: int = 32,
               max_front: int | None = None) -> DissectionTree:
    """Relaxed supernode amalgamation: merge child fronts into their
    parents when the flop increase from the induced fill stays within
    ``relax``, or when the child eliminates at most ``min_cells`` cells
    (tiny fronts cost dispatch/padding, not math).

    This is the standard multifrontal trick SuperLU/MUMPS apply during
    supernode detection (reference SuperLU_brief_tree.txt:12-14's panels
    come from merged supernodes); on the TPU it is the difference between
    rounds of MXU-starved sub-tile GEMMs and rounds of near-tile-size
    batched GEMMs. Merging child c into parent p is exact — no symbolic
    recomputation needed — because border(c) \\ owned(p) is a subset of
    border(p) (child borders live entirely in ancestor separators), so
    the merged node's border is border(p) and the merged front size is
    p_cells(c) + n_cells(p). A ``max_front`` cap (cells) keeps tree-top
    merges from blowing the per-front memory envelope."""
    nodes = tree.nodes
    border = _compute_borders(graph, tree)
    psz = [int(graph.block_size[nodes[i].owned].sum())
           for i in range(len(nodes))]
    bsz = [int(graph.block_size[border[i]].sum()) for i in range(len(nodes))]
    owned = [[np.asarray(nodes[i].owned)] for i in range(len(nodes))]
    children = [list(nodes[i].children) for i in range(len(nodes))]
    alive = [True] * len(nodes)
    if max_front is None:
        cur_max = max((psz[i] + bsz[i] for i in range(len(nodes))),
                      default=0)
        max_front = max(int(1.25 * cur_max), 4096)
    # merged pivot blocks never exceed the tree's ORIGINAL max eliminated
    # block: growing maxP reclassifies the whole factorization's adaptive
    # solve block size (mf_jax: shallow trees take full explicit
    # inverses) and reshapes the latency-critical tree-top rounds — the
    # wins amalgamation is after live in the tiny-leaf fronts, not there
    max_p = max(psz, default=0)
    merged = 0
    for nid in tree.postorder:
        changed = True
        while changed:
            changed = False
            for ch in list(children[nid]):
                pc, nc = psz[ch], psz[ch] + bsz[ch]
                pp, np_ = psz[nid], psz[nid] + bsz[nid]
                pm, nm = pc + pp, pc + np_
                if nm > max_front or pm > max_p:
                    continue
                fl_before = _front_flops(pc, nc) + _front_flops(pp, np_)
                fl_after = _front_flops(pm, nm)
                if not (pc <= min_cells
                        or fl_after <= (1.0 + relax) * fl_before):
                    continue
                owned[nid].extend(owned[ch])
                children[nid].remove(ch)
                children[nid].extend(children[ch])
                psz[nid] = pm
                alive[ch] = False
                merged += 1
                changed = True
    if not merged:
        return tree

    # rebuild the tree over surviving nodes (same shape invariants as
    # nested_dissection's tail: postorder children-before-parents, rounds,
    # contiguous per-subtree elimination positions)
    from .ordering import DissectionNode, DissectionTree as _DT
    new_id = {}
    new_nodes: list[DissectionNode] = []
    for i in range(len(nodes)):
        if alive[i]:
            new_id[i] = len(new_nodes)
            new_nodes.append(DissectionNode(
                owned=np.concatenate(owned[i])))
    for i in range(len(nodes)):
        if not alive[i]:
            continue
        me = new_id[i]
        new_nodes[me].children = [new_id[c] for c in children[i]]
        for c in children[i]:
            new_nodes[new_id[c]].parent = me

    post: list[int] = []
    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))

    def walk(nid):
        for ch in new_nodes[nid].children:
            walk(ch)
        new_nodes[nid].round = 1 + max(
            (new_nodes[ch].round for ch in new_nodes[nid].children),
            default=-1)
        post.append(nid)

    try:
        roots = [i for i, n in enumerate(new_nodes) if n.parent == -1]
        for r in roots:
            walk(r)
    finally:
        sys.setrecursionlimit(old_limit)
    postorder = np.array(post, dtype=np.int64)
    col_elim_pos = np.empty(graph.ncols, dtype=np.int64)
    pos = 0
    owner_node = np.empty(graph.ncols, dtype=np.int64)
    for nid in postorder:
        ow = new_nodes[nid].owned
        col_elim_pos[ow] = np.arange(pos, pos + len(ow))
        owner_node[ow] = nid
        pos += len(ow)
    assert pos == graph.ncols
    dbg(1, f"amalgamation: {len(nodes)} -> {len(new_nodes)} fronts "
           f"({merged} merged, relax={relax}, min_cells={min_cells})")
    return _DT(nodes=new_nodes, postorder=postorder,
               col_elim_pos=col_elim_pos, owner_node=owner_node)


def symbolic_from_matrix(maps, matrix: SparseMatrix, leaf_size: int = 32,
                         amalg_relax: float = 0.25,
                         amalg_min_cells: int = 32) -> SymbolicFactorization:
    import os
    from .ordering import build_column_graph, nested_dissection
    graph = build_column_graph(maps, matrix)
    tree = nested_dissection(graph, leaf_size=leaf_size)
    relax = float(os.environ.get("NK_AMALG_RELAX", amalg_relax))
    min_cells = int(os.environ.get("NK_AMALG_MIN", amalg_min_cells))
    if relax > 0 or min_cells > 0:
        tree = amalgamate(graph, tree, relax=relax, min_cells=min_cells)
    return analyze(graph, tree)
