"""Multi-rank dry run: the whole distributed preconditioner workflow on a
torch.distributed mesh, at tiny shapes.

The port of the JAX package's ``parallel/dryrun.py``. Every rank of a
world runs ``run``, which exercises what the distributed mode (the
reference's solve_ABdist, src/solve_ABdist.c:422-612) does:

1. assemble a transport Jacobian and factor it with its rounds sharded
   over the mesh (the sharded multifrontal engine, the pdgstrf
   replacement), solve a multi-RHS batch and refine it to the 1e-10
   workflow contract;
2. a deliberately ill-conditioned secondary case (upwind3 advection),
   held to SuperLU's own residual on the same system;
3. the latitude-band-sharded stencil apply against the single-device
   apply;
4. a scaled case that forces what the production run uses at a size a
   dry run affords: a 2 MB plan budget that splits rounds into chunks,
   row-sharded tree-top rounds with the masked substitution
   (``row_shard_min=256``), and the factor-only pass over round
   checkpoints followed by the out-of-core stream solve.

The mesh's first rank prints one summary line. ``main`` starts the ranks
itself:

    python -m nk_ocn_tracer_jacobian_precond_tpu_torch.parallel.dryrun N \\
        [--device cpu|cuda] [--backend gloo|nccl]

(gloo ranks on cpu; on cuda NCCL with one card per rank, or gloo ranks
that share the cards there are when ``--backend gloo`` is named).
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import warnings

import numpy as np
import torch

CONTRACT = 1e-10    # the workflow's relative residual, every RHS


def _rel(A, X, B) -> np.ndarray:
    return np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)


def run(mesh, device) -> dict:
    """The dry run on this rank of ``mesh``, a 1-D ("front",) mesh of at
    least two ranks spanning the default process group (every rank calls
    this with the same arguments). Raises AssertionError when a check
    fails; returns the summary (printed by the mesh's first rank)."""
    from ..io.matrixfile import SparseMatrix
    from ..ops.assemble import to_csr
    from ..solver.mf import MultifrontalFactorization, equilibrate
    from ..solver.mf_torch import TorchMultifrontal
    from ..solver.plan import build_plan
    from ..solver.stream_solve import stream_solve
    from ..solver.symbolic import symbolic_from_matrix
    from .demo import make_demo_assembly
    from .mesh import make_mesh
    from .stencil import StencilOperator

    n = mesh.shape[0]
    if n < 2 or mesh.axis_names != ("front",):
        raise ValueError(f"the dry run takes a 1-D ('front',) mesh of at "
                         f"least 2 ranks, not {mesh.axis_names} {mesh.shape}")
    first = mesh.coords[0] == 0
    device = torch.device(device)

    def build(imt=16, jmt=16, km=4, **opt_kw):
        asm, maps = make_demo_assembly(imt=imt, jmt=jmt, km=km, **opt_kw)
        nzval, colind, rowptr = to_csr(asm)
        return asm, maps, SparseMatrix(nzval=nzval, colind=colind,
                                       rowptr=rowptr,
                                       coupled_tracer_cnt=asm.nt)

    # --- 1: the transport matrix, sharded factor and solve, to the contract
    asm, maps, matrix = build(hmix_type="isop_file")
    fac = MultifrontalFactorization(matrix, maps=maps, mesh=mesh,
                                    device=device)
    sharded = sum(1 for lay in fac.engine.layouts
                  if lay.split or lay.kind == "row")
    assert sharded >= 1, "no factor round ended up sharded over the mesh"
    rng = np.random.default_rng(0)
    B = rng.standard_normal((matrix.flat_len, 3))
    X = fac.solve(B)
    rel = _rel(matrix.to_scipy(), X, B)
    assert rel.max() <= CONTRACT, \
        f"distributed residual {rel.max():.3e} misses the {CONTRACT:.0e} " \
        f"workflow contract"

    # --- 2: ill-conditioned secondary, against SuperLU's own residual ----
    # refine_tol sits below the bar's floor: a tolerance at the bar could
    # stop the refiner above a residual SuperLU reaches under 1e-10
    asm2, maps2, matrix2 = build(adv_type="upwind3", hmix_type="isop_file")
    fac2 = MultifrontalFactorization(matrix2, maps=maps2, mesh=mesh,
                                     device=device, refine_tol=1e-11)
    B2 = rng.standard_normal((matrix2.flat_len, 3))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        X2 = fac2.solve(B2)
    if first:
        for w in caught:
            print(f"dryrun secondary (conditioning-limited by design, "
                  f"SuperLU-relative bar applies): {w.message}")
    from scipy.sparse.linalg import splu
    A2 = matrix2.to_scipy()
    rel2 = _rel(A2, X2, B2)
    rel2_ref = _rel(A2, splu(A2.tocsc()).solve(B2), B2)
    assert rel2.max() <= max(CONTRACT, 10.0 * rel2_ref.max()), \
        f"ill-conditioned residual {rel2.max():.3e} vs SuperLU " \
        f"{rel2_ref.max():.3e}"

    # --- 3: the band-sharded stencil apply against the single-device one -
    op = StencilOperator.from_assembly(asm, device)
    bands = make_mesh(n, ("band",))
    apply_fn, layout, pad_field, unpad_field = op.sharded_apply_factory(bands)
    km, jmt, imt = op.shape
    wet = np.arange(km)[:, None, None] < np.asarray(asm.grid.KMT)[None]
    x3 = np.where(wet, rng.standard_normal((km, jmt, imt)), 0.0)[None]
    x3 = torch.from_numpy(np.repeat(x3, op.nt, axis=0)).to(device)
    x_l = layout.scatter(pad_field(x3) if first else None)
    y_sh = unpad_field(layout.gather(apply_fn(x_l)))
    y_loc = op.apply(x3)
    scale = max(float(y_loc.abs().max()), 1.0)
    assert torch.allclose(y_sh, y_loc, rtol=1e-5, atol=1e-6 * scale), \
        "sharded stencil apply mismatch"

    # --- 4: the scaled case: chunked, row-sharded, masked, streamed ------
    asm3, maps3 = make_demo_assembly(imt=32, jmt=24, km=12,
                                     hmix_type="isop_file")
    nz3, ci3, rp3 = to_csr(asm3)
    matrix3 = SparseMatrix(nzval=nz3, colind=ci3, rowptr=rp3,
                           coupled_tracer_cnt=asm3.nt)
    sym3 = symbolic_from_matrix(maps3, matrix3, leaf_size=16)
    plans_default = build_plan(sym3, matrix3, batch_multiple=n)
    budget = 2e6    # ~2 MB: forces the chunker to split rounds
    fac3 = MultifrontalFactorization(matrix3, maps=maps3, sym=sym3,
                                     mesh=mesh, device=device,
                                     mem_budget_bytes=budget,
                                     row_shard_min=256)
    eng3 = fac3.engine
    assert len(eng3.plans) > len(plans_default), \
        f"the {budget:.0e} budget did not force multi-chunk rounds " \
        f"({len(eng3.plans)} vs {len(plans_default)} plans)"
    rowsh = [i for i, lay in enumerate(eng3.layouts) if lay.kind == "row"]
    masked = [i for i in rowsh if eng3.kd[i] is not None]
    assert rowsh, "no front-axis (row-)sharded round at scaled size"
    assert masked, "no round took the masked-substitution (KD) path"
    B3 = rng.standard_normal((matrix3.flat_len, 3))
    X3 = fac3.solve(B3)
    rel3 = _rel(matrix3.to_scipy(), X3, B3)
    assert rel3.max() <= CONTRACT, \
        f"scaled front-sharded residual {rel3.max():.3e}"
    # the factor-only pass over round checkpoints and the out-of-core
    # stream solve: one engine, no mesh, on the first rank
    rel3s = None
    if first:
        ckdir = tempfile.mkdtemp(prefix="nk_dryrun_fckpt_")
        try:
            fm3, _, _ = equilibrate(matrix3)
            eng_f = TorchMultifrontal(sym3, fm3, device, checkpoint_dir=ckdir,
                                      factor_only=True,
                                      mem_budget_bytes=budget)
            _, rel3s = stream_solve(matrix3, maps3, sym3, ckdir, B3,
                                    pack_bs=eng_f._pack_bs,
                                    mem_budget_bytes=budget)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        assert rel3s.max() <= CONTRACT, \
            f"streamed-rounds residual {rel3s.max():.3e}"

    summary = dict(n_devices=n, sharded=sharded, rel=float(rel.max()),
                   rel2=float(rel2.max()), rel2_ref=float(rel2_ref.max()),
                   chunked=len(eng3.plans), default=len(plans_default),
                   rowsh=len(rowsh), masked=len(masked),
                   rel3=float(rel3.max()),
                   rel3s=None if rel3s is None else float(rel3s.max()))
    if first:
        print(f"dryrun ok: {n} devices, {sharded} sharded factor rounds, "
              f"transport-matrix residual {rel.max():.3e} <= "
              f"{CONTRACT:.0e} contract; ill-conditioned secondary "
              f"{rel2.max():.3e} (SuperLU on same system: "
              f"{rel2_ref.max():.3e}); scaled case: {len(eng3.plans)} "
              f"chunked rounds ({len(plans_default)} default), "
              f"{len(rowsh)} row-sharded, {len(masked)} masked-substitution, "
              f"front-sharded residual {rel3.max():.3e}, streamed-rounds "
              f"residual {rel3s.max():.3e}", flush=True)
    return summary


def _dryrun_rank(device: torch.device) -> None:
    from .mesh import make_mesh
    run(make_mesh(None, ("front",)), device)


def spawn(n_devices: int, device: str = "cuda",
          backend: str | None = None) -> None:
    """``run`` on ``n_devices`` ranks started here (parallel.mesh.run_world):
    gloo ranks on cpu; on cuda one card per rank over NCCL (raising
    ValueError "requested N devices, have M" when there are fewer cards),
    or, with ``backend="gloo"``, ranks that share the cards there are.
    Raises when a rank fails."""
    from .mesh import run_world
    run_world(_dryrun_rank, n_devices, device, backend=backend)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dryrun", description=__doc__.split(
        "\n\n")[0])
    p.add_argument("n_devices", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"])
    args = p.parse_args(argv)
    spawn(args.n_devices, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
