"""gen_a driver: assemble the sparse Jacobian and write the matrix file.

Rebuild of the gen_A executable (src/gen_A.c:459-501):
  parse options -> load grid -> index maps -> assemble -> canonical CSR ->
  write matrix file. Same CLI surface: [-h] [-D dbg_lvl] [-o opt_fname]
  matrix_fname.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..grid import gen_ind_maps, load_grid
from ..io.matrixfile import SparseMatrix, write_matrix_file
from ..ops import AssemblyOptions, assemble_jacobian
from ..ops.assemble import to_csr
from ..ops.fieldsource import FileFieldSource
from ..utils import dbg, set_dbg_lvl, timed
from .config import parse_opt_file


def write_opts(opts: AssemblyOptions, matrix_fname: str) -> None:
    """Echo the resolved options at dbg level >= 1, the rebuild of
    write_opts (src/gen_A.c:355-455)."""
    dbg(1, f"day_cnt                    = {opts.day_cnt:e}")
    dbg(1, f"reg_fname                  = {opts.reg_fname or 'none'}")
    dbg(1, f"circ_fname                 = {opts.circ_fname}")
    dbg(1, f"adv_opt                    = {opts.adv_type}")
    dbg(1, f"l_adv_enforce_divfree      = {int(opts.l_adv_enforce_divfree)}")
    dbg(1, f"hmix_opt                   = {opts.hmix_type}")
    dbg(1, f"vmix_opt                   = {opts.vmix_type}")
    dbg(1, f"tracer_fname               = {opts.tracer_fname or 'none'}")
    dbg(1, f"coupled_tracer_cnt         = {opts.coupled_tracer_cnt}")
    for t, pt in enumerate(opts.per_tracer):
        dbg(1, f"options for tracer {t}")
        dbg(1, f"   sink_opt                = {pt.sink_type}")
        if pt.sink_type in ("const", "const_shallow"):
            dbg(1, f"   sink_rate               = {pt.sink_rate:e}")
        if pt.sink_type == "const_shallow":
            dbg(1, f"   sink_depth              = {pt.sink_depth:e}")
        if pt.sink_type == "file":
            dbg(1, f"   sink_field_name         = {pt.sink_field_name}")
        if pt.sink_type == "generic_tracer":
            dbg(1, f"   sink_generic_tracer_name= {pt.sink_generic_tracer_name}")
            dbg(1, f"   depends_layer_cnt       = "
                   f"{pt.sink_generic_tracer_depends_layer_cnt}")
        dbg(1, f"   pv_field_name           = {pt.pv_field_name or 'none'}")
        dbg(1, f"   d_SF_d_TRACER_field_name= "
               f"{pt.d_SF_d_TRACER_field_name or 'none'}")
    dbg(1, f"coupled_tracer_opt         = {opts.coupled_tracer_type}")
    dbg(1, f"matrix_fname               = {matrix_fname}")


def check_matrix_diag(matrix: SparseMatrix) -> tuple[int, int]:
    """Warn-only scan for missing/zero diagonal entries after assembly
    (rebuild of check_matrix_diag, reference src/matrix.c:3692-3727): a
    malformed option/input file that produces a structurally singular
    Jacobian should be flagged here, not discovered as a breakdown inside
    the factorization. Returns (missing_cnt, zero_cnt)."""
    rowptr = np.asarray(matrix.rowptr)
    colind = np.asarray(matrix.colind)
    nzval = np.asarray(matrix.nzval)
    n = matrix.flat_len
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rowptr))
    is_diag = colind == rows
    has_diag = np.zeros(n, dtype=bool)
    has_diag[rows[is_diag]] = True
    zero_diag = np.zeros(n, dtype=bool)
    zero_diag[rows[is_diag & (nzval == 0.0)]] = True
    missing = int((~has_diag).sum())
    zeros = int(zero_diag.sum())
    if missing:
        first = int(np.flatnonzero(~has_diag)[0])
        print(f"gen_a: WARNING: {missing} row(s) have no diagonal entry "
              f"(first: row {first})", file=sys.stderr)
    if zeros:
        first = int(np.flatnonzero(zero_diag)[0])
        print(f"gen_a: WARNING: {zeros} row(s) have a zero diagonal entry "
              f"(first: row {first})", file=sys.stderr)
    return missing, zeros


def run_gen_a(matrix_fname: str, opt_fname: str | None = None,
              opts: AssemblyOptions | None = None, dbg_lvl: int = 0) -> SparseMatrix:
    set_dbg_lvl(dbg_lvl)
    if opts is None:
        opts = AssemblyOptions()
        if opt_fname is not None:
            opts = parse_opt_file(opt_fname, opts)
    if opts.circ_fname is None:
        raise ValueError("circ_fname not specified")
    opts.validate()
    write_opts(opts, matrix_fname)

    with timed("get_grid_info"):
        grid = load_grid(opts.circ_fname, opts.reg_fname)
    with timed("gen_ind_maps"):
        maps = gen_ind_maps(np.asarray(grid.KMT), grid.km)
    circ_src = FileFieldSource(opts.circ_fname)
    tracer_src = (FileFieldSource(opts.tracer_fname)
                  if opts.tracer_fname is not None else None)
    with timed("gen_sparse_matrix"):
        asm = assemble_jacobian(grid, opts, circ_src, tracer_src, maps)
        nzval, colind, rowptr = to_csr(asm)
    matrix = SparseMatrix(nzval=nzval, colind=colind, rowptr=rowptr,
                          coupled_tracer_cnt=opts.coupled_tracer_cnt)
    check_matrix_diag(matrix)
    with timed("put_matrix_file"):
        write_matrix_file(matrix_fname, grid, maps, matrix)
    dbg(1, f"matrix written to {matrix_fname}: flat_len = {matrix.flat_len}, "
           f"nnz = {matrix.nnz}")
    return matrix


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gen_a",
        description="generate the sparse Jacobian approximation matrix file")
    p.add_argument("-D", dest="dbg_lvl", type=int, default=0)
    p.add_argument("-o", dest="opt_fname", default=None)
    p.add_argument("matrix_fname")
    args = p.parse_args(argv)
    try:
        run_gen_a(args.matrix_fname, args.opt_fname, dbg_lvl=args.dbg_lvl)
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"gen_a: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
