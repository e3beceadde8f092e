"""Upwind3 face transports that belong to a circulation file's velocities.

``make_circ_file`` draws the upwind3 fields (UTE_POS/NEG, VTN_POS/NEG,
WTK_POS/NEG) as independent random numbers of 3e10 (horizontal) and 2e4
(vertical), some 1e4 times the transports of the file's own UVEL, VVEL and
WVEL and unrelated to them. The upwind3 matrix assembled from them is
dominated by that noise: on the 20x16x6 grid of seed 33 its condition
number is 4.7e10, and even a dense partially pivoted LU of it reaches a
relative residual of only 1.6e-7, short of the workflow's 1e-10. POP
writes the positive and negative parts of the same face transports that
the centered scheme reads; ``derive_upwind3_transports`` rewrites the
six fields so, and the upwind3 matrix is then as well conditioned as the
centered one (2.8e4 on that grid).
"""

from __future__ import annotations

import numpy as np

from ..grid import load_grid
from ..io import fields
from ..ops.adv import load_UTE, load_VTN, load_WVEL
from ..ops.fieldsource import FileFieldSource
from .synthetic import FV


def derive_upwind3_transports(circ_fname: str) -> None:
    """Overwrite, in place, the upwind3 face transports of the circulation
    file ``circ_fname`` with the positive and negative parts of its own
    centered-scheme transports: UTE = UVEL * DYU averaged to east faces
    (``ops.adv.load_UTE``), VTN likewise (``load_VTN``), and WTK = WVEL at
    top faces (``load_WVEL``); land cells keep the fill value."""
    grid = load_grid(circ_fname)
    src = FileFieldSource(circ_fname)
    wet = np.arange(grid.km)[:, None, None] < np.asarray(grid.KMT)[None]
    for name, t in (("UTE", load_UTE(grid, src, False)),
                    ("VTN", load_VTN(grid, src, False)),
                    ("WTK", load_WVEL(grid, src, False))):
        fields.put_var_inplace(circ_fname, f"{name}_POS",
                               np.where(wet, np.maximum(t, 0.0), FV))
        fields.put_var_inplace(circ_fname, f"{name}_NEG",
                               np.where(wet, np.minimum(t, 0.0), FV))
