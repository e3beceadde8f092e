"""ncdiff-style comparison utility for matrix and tracer files.

The reference's solver smoke tests "verify" results by running ncdiff on
the in/out tracer file and eyeballing the dump (reference:
test/test_solve_ABglobal.csh:42). This tool makes that check automated
and quantitative: compare two NetCDF files variable by variable, report
max abs/rel differences, and exit nonzero above a tolerance.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import netcdf3


def diff_files(a_path: str, b_path: str, varnames=None, rtol: float = 0.0,
               atol: float = 0.0, quiet: bool = False) -> int:
    ha = netcdf3.read_header(a_path)
    hb = netcdf3.read_header(b_path)
    names = varnames or [n for n in ha.var_order if n in hb.vars]
    worst = 0
    for name in names:
        if name not in ha.vars or name not in hb.vars:
            print(f"{name}: missing in one file")
            worst = max(worst, 2)
            continue
        va = netcdf3.read_var(a_path, name, ha)
        vb = netcdf3.read_var(b_path, name, hb)
        if va.shape != vb.shape:
            print(f"{name}: shape {va.shape} != {vb.shape}")
            worst = max(worst, 2)
            continue
        if va.dtype.kind in "fc":
            ad = np.abs(va - vb)
            scale = np.maximum(np.abs(va), np.abs(vb))
            bad = ad > atol + rtol * scale
            if bad.any():
                rel = np.where(scale > 0, ad / np.where(scale == 0, 1, scale), 0)
                print(f"{name}: {bad.sum()} diffs, max abs {ad.max():.3e}, "
                      f"max rel {rel.max():.3e}")
                worst = max(worst, 1)
            elif not quiet:
                print(f"{name}: OK (max abs diff {ad.max():.3e})")
        else:
            if (va != vb).any():
                print(f"{name}: {(va != vb).sum()} integer diffs")
                worst = max(worst, 1)
            elif not quiet:
                print(f"{name}: OK")
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ncdiff", description=__doc__)
    p.add_argument("-v", dest="vars", default=None,
                   help="comma-separated variable names (default: common vars)")
    p.add_argument("--rtol", type=float, default=0.0)
    p.add_argument("--atol", type=float, default=0.0)
    p.add_argument("-q", dest="quiet", action="store_true")
    p.add_argument("file_a")
    p.add_argument("file_b")
    args = p.parse_args(argv)
    names = args.vars.split(",") if args.vars else None
    return diff_files(args.file_a, args.file_b, names, args.rtol, args.atol,
                      args.quiet)


if __name__ == "__main__":
    raise SystemExit(main())
