"""The port's matrix-free stencil operator (parallel/stencil.py) against the
JAX package's and against the canonical CSR product, on the CPU.

Same assembly through both packages (the four option sets of
tests/test_stencil.py): the port's ``apply`` on tracer fields and its
``matvec_factory`` on a flat vector must agree with the JAX operator's and
with the CSR product at tests/test_stencil.py's tolerance, rtol 1e-12 and
atol 1e-13 of the largest entry (the sums run in another order: XLA fuses
the shifted multiply-adds, and the dense blocks' contractions differ).
"""

import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu.grid import gen_ind_maps as ref_maps
from nk_ocn_tracer_jacobian_precond_tpu.grid import load_grid as ref_grid
from nk_ocn_tracer_jacobian_precond_tpu.ops import (
    AssemblyOptions as RefOptions, PerTracerOptions as RefPerTracer,
    assemble_jacobian as ref_assemble)
from nk_ocn_tracer_jacobian_precond_tpu.ops.fieldsource import (
    FileFieldSource as RefSource)
from nk_ocn_tracer_jacobian_precond_tpu.parallel import (
    StencilOperator as RefOperator)
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid import (gen_ind_maps,
                                                           load_grid)
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
    SparseMatrix)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (
    AssemblyOptions, PerTracerOptions, assemble_jacobian)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.assemble import to_csr
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.fieldsource import (
    FileFieldSource)
from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import StencilOperator
from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import stencil
from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import (
    make_circ_file, make_tracer_file)

IMT, JMT, KM = 16, 12, 5
CPU = torch.device("cpu")

# tests/test_stencil.py's option sets: (assembly keyword arguments,
# per-tracer keyword arguments)
CASES = [
    (dict(adv_type="centered", hmix_type="const", vmix_type="file"), [{}]),
    (dict(adv_type="upwind3", hmix_type="isop_file", vmix_type="const"),
     [{}]),
    (dict(adv_type="donor", hmix_type="isop_file", vmix_type="matrix_file"),
     [{}]),
    (dict(adv_type="centered", hmix_type="const", vmix_type="file",
          coupled_tracer_cnt=2, coupled_tracer_type="OCMIP_BGC_PO4_DOP"),
     [dict(sink_type="generic_tracer", sink_generic_tracer_name="PO4"), {}]),
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_stencil")
    circ, tracer = str(d / "circ.nc"), str(d / "tracer.nc")
    make_circ_file(circ, imt=IMT, jmt=JMT, km=KM, seed=42)
    make_tracer_file(tracer, IMT, JMT, KM, generic_tracer_names=("PO4",),
                     coupled_names=(("OCMIP_BGC_PO4", "OCMIP_BGC_DOP"),
                                    ("OCMIP_BGC_DOP", "OCMIP_BGC_PO4")),
                     seed=42)
    return circ, tracer


def _assemble(circ, tracer, case, port: bool):
    kw, pts = CASES[case]
    opts_cls, pt_cls, grid_fn, maps_fn, src, asm_fn = (
        (AssemblyOptions, PerTracerOptions, load_grid, gen_ind_maps,
         FileFieldSource, assemble_jacobian) if port else
        (RefOptions, RefPerTracer, ref_grid, ref_maps, RefSource,
         ref_assemble))
    opts = opts_cls(circ_fname=circ, tracer_fname=tracer,
                    per_tracer=[pt_cls(**pt) for pt in pts], **kw)
    grid = grid_fn(circ)
    maps = maps_fn(np.asarray(grid.KMT), grid.km)
    return asm_fn(grid, opts, src(circ), src(tracer), maps), maps


@pytest.fixture(scope="module", params=range(len(CASES)))
def ops(request, files):
    circ, tracer = files
    asm_r, _ = _assemble(circ, tracer, request.param, False)
    asm_p, maps = _assemble(circ, tracer, request.param, True)
    nzval, colind, rowptr = to_csr(asm_p)
    matrix = SparseMatrix(nzval=nzval, colind=colind, rowptr=rowptr,
                          coupled_tracer_cnt=asm_p.nt)
    return (RefOperator.from_assembly(asm_r),
            StencilOperator.from_assembly(asm_p, device="cpu"), matrix, maps)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-13 * np.abs(want).max())


def test_fields_equal_jax(ops):
    """The sanitized fields are the reference's host arrays, bit for bit."""
    ref, op, _, _ = ops
    assert op.offsets == ref.offsets and op.nt == ref.nt
    assert op.shape == ref.shape and op.device == CPU
    np.testing.assert_array_equal(op.coefs.numpy(), ref.coefs)
    np.testing.assert_array_equal(op.selfs.numpy(), ref.selfs)
    assert (op.vmix is None) == (ref.vmix is None)
    if op.vmix is not None:
        np.testing.assert_array_equal(op.vmix.numpy(), ref.vmix)
    for a, b in zip(op.sink, ref.sink):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b)
    assert list(op.cross) == list(ref.cross)
    for k in op.cross:
        np.testing.assert_array_equal(op.cross[k].numpy(), ref.cross[k])


def test_apply_matches_jax(ops):
    ref, op, _, _ = ops
    nt, (km, jmt, imt) = op.nt, op.shape
    x = np.random.default_rng(8).standard_normal((nt, km, jmt, imt))
    x_in = torch.from_numpy(x.copy())
    y = op.apply(x_in)
    torch.testing.assert_close(x_in, torch.from_numpy(x), rtol=0, atol=0)
    _close(y.numpy(), np.asarray(ref._device_copy().apply(x)))


def test_matvec_matches_jax_and_csr(ops):
    ref, op, matrix, maps = ops
    x = np.random.default_rng(7).standard_normal(matrix.flat_len)
    y = op.matvec_factory(maps)(torch.from_numpy(x))
    assert y.dtype == torch.float64 and y.shape == (matrix.flat_len,)
    _close(y.numpy(), matrix.to_scipy() @ x)
    _close(y.numpy(), np.asarray(ref.matvec_factory(maps)(x)))


def test_shift_leaves_input_alone():
    """_shift_x zeroes the wrapped k rows in a copy, never in x."""
    x = torch.arange(2 * 4 * 3 * 5, dtype=torch.float64).reshape(2, 4, 3, 5)
    x0 = x.clone()
    for off in ((1, 0, 0), (-1, 1, 0), (2, -1, 1), (0, 0, -2)):
        y = stencil._shift_x(x, *off)
        assert torch.equal(x, x0)
        dk, dj, di = off
        want = torch.roll(x0, (-dk, -dj, -di), dims=(-3, -2, -1))
        if dk > 0:
            want[..., -dk:, :, :] = 0
        elif dk < 0:
            want[..., :-dk, :, :] = 0
        assert torch.equal(y, want)


def test_to_moves_every_field(ops):
    _, op, _, _ = ops
    moved = op.to("cpu")
    assert moved is not op and moved.device == CPU
    assert torch.equal(moved.selfs, op.selfs)
