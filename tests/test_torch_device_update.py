"""The port's Newton value-update plan (ops/device_update.py) against the
JAX package's.

Same assembly inputs through both packages: the plans must be equal
(layout, total, ell_src, nnz), and the port's update on a numpy array (the
host branch) and on a CPU tensor must equal the JAX plan's host update bit
for bit, for every field kind: stencil offsets, the vmix dense block,
the generic-tracer sink dense block, cross-tracer coupling (the option sets
of tests/test_device_update.py).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu.grid import gen_ind_maps as ref_maps
from nk_ocn_tracer_jacobian_precond_tpu.grid import load_grid as ref_grid
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import (
    SparseMatrix as RefSparseMatrix)
from nk_ocn_tracer_jacobian_precond_tpu.ops import (
    AssemblyOptions as RefOptions, PerTracerOptions as RefPerTracer,
    assemble_jacobian as ref_assemble)
from nk_ocn_tracer_jacobian_precond_tpu.ops.assemble import to_csr as ref_csr
from nk_ocn_tracer_jacobian_precond_tpu.ops.device_update import (
    build_update_plan as ref_build_plan)
from nk_ocn_tracer_jacobian_precond_tpu.ops.fieldsource import (
    FileFieldSource as RefSource)
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid import (gen_ind_maps,
                                                           load_grid)
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
    SparseMatrix)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (
    AssemblyOptions, PerTracerOptions, assemble_jacobian)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.assemble import to_csr
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.device_update import (
    build_update_plan)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.fieldsource import (
    FileFieldSource)
from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import (
    make_circ_file, make_tracer_file)

IMT, JMT, KM = 14, 10, 5

# the option sets of tests/test_device_update.py, plus its coupled-tracer
# case: (assembly keyword arguments, per-tracer keyword arguments)
CASES = {
    "upwind3_isop_matrix_file": (dict(adv_type="upwind3",
                                      hmix_type="isop_file",
                                      vmix_type="matrix_file"), [{}]),
    "generic_tracer_sink": (dict(adv_type="centered", hmix_type="const",
                                 vmix_type="file"),
                            [dict(sink_type="generic_tracer",
                                  sink_generic_tracer_name="DIC",
                                  sink_generic_tracer_depends_layer_cnt=3)]),
    "coupled_po4_dop": (dict(hmix_type="isop_file", vmix_type="file",
                             coupled_tracer_cnt=2,
                             coupled_tracer_type="OCMIP_BGC_PO4_DOP"),
                        [{}, {}]),
    "bench_options": (dict(adv_type="centered", hmix_type="isop_file",
                           vmix_type="file"),
                      [dict(sink_type="const", sink_rate=1.21e-4)]),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """tests/test_device_update.py's circulation and tracer files."""
    d = tmp_path_factory.mktemp("torch_devupd")
    circ, tracer = str(d / "circ.nc"), str(d / "tracer.nc")
    make_circ_file(circ, imt=IMT, jmt=JMT, km=KM, seed=9)
    make_tracer_file(tracer, IMT, JMT, KM, tracer_names=("IAGE_CUR",),
                     generic_tracer_names=("PO4", "DIC"),
                     coupled_names=(("OCMIP_BGC_PO4", "OCMIP_BGC_DOP"),
                                    ("OCMIP_BGC_DOP", "OCMIP_BGC_PO4")),
                     seed=9)
    return circ, tracer


def _build(circ, tracer, case, port: bool):
    """(assembly, canonical matrix, plan) of ``case`` by one package."""
    kw, pts = CASES[case]
    if port:
        opts_cls, pt_cls, grid_fn, maps_fn, src_cls = (
            AssemblyOptions, PerTracerOptions, load_grid, gen_ind_maps,
            FileFieldSource)
        asm_fn, csr_fn, mat_cls, plan_fn = (assemble_jacobian, to_csr,
                                            SparseMatrix, build_update_plan)
    else:
        opts_cls, pt_cls, grid_fn, maps_fn, src_cls = (
            RefOptions, RefPerTracer, ref_grid, ref_maps, RefSource)
        asm_fn, csr_fn, mat_cls, plan_fn = (ref_assemble, ref_csr,
                                            RefSparseMatrix, ref_build_plan)
    opts = opts_cls(circ_fname=circ, tracer_fname=tracer,
                    per_tracer=[pt_cls(**pt) for pt in pts], **kw)
    grid = grid_fn(circ)
    asm = asm_fn(grid, opts, src_cls(circ), src_cls(tracer),
                 maps_fn(np.asarray(grid.KMT), grid.km))
    nzval, colind, rowptr = csr_fn(asm)
    matrix = mat_cls(nzval=nzval, colind=colind, rowptr=rowptr,
                     coupled_tracer_cnt=opts.coupled_tracer_cnt)
    return asm, matrix, plan_fn(asm, matrix)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, files):
    circ, tracer = files
    return (request.param, _build(circ, tracer, request.param, False),
            _build(circ, tracer, request.param, True))


def test_plan_equals_jax(pair):
    case, (_, m_r, ref), (_, m_p, got) = pair
    assert got.layout == ref.layout
    assert got.total == ref.total and got.nnz == ref.nnz
    assert got.ell_src.dtype == ref.ell_src.dtype
    np.testing.assert_array_equal(got.ell_src, ref.ell_src)
    np.testing.assert_array_equal(np.asarray(m_p.nzval),
                                  np.asarray(m_r.nzval))
    if case == "upwind3_isop_matrix_file":
        # the vmix dense block sums duplicates: the fold has W > 1 columns
        assert got.ell_src.shape[1] > 1
    if case == "coupled_po4_dop":
        assert any(k[0] == "cross" for k in got.layout)


def test_update_bitwise_equals_jax_host(pair):
    """The port's update of a numpy array (host branch) and of a CPU tensor
    against the JAX plan's host update, on the stacked fields and on a
    perturbation of them as the NK loop makes."""
    _, (asm_r, m_r, ref), (asm_p, _, got) = pair
    s0 = got.stack_fields(asm_p)
    np.testing.assert_array_equal(s0, ref.stack_fields(asm_r))
    c = 1.0 + 1e-3 * np.random.default_rng(42).standard_normal(got.total)
    for s in (s0, s0 * c):
        want = ref.update(s)
        host = got.update(s)
        dev = got.update(torch.from_numpy(s))
        assert isinstance(host, np.ndarray) and isinstance(dev, torch.Tensor)
        np.testing.assert_array_equal(host, want)
        np.testing.assert_array_equal(dev.numpy(), want)
    np.testing.assert_array_equal(got.update(torch.from_numpy(s0)).numpy(),
                                  np.asarray(m_r.nzval))
    # the index table went to the CPU once, as int64
    assert list(got._ell_dev) == [torch.device("cpu")]
    assert got._ell_dev[torch.device("cpu")].dtype == torch.int64


def test_update_row_scaled_bitwise(pair):
    """tests/test_device_update.py's frozen-pattern check: every field
    scaled by a power of two per row cell; the update must equal the
    row-scaled canonical values bit for bit, through the JAX plan and
    the port's (tensor) update alike."""
    _, (asm_r, m_r, ref), (asm_p, _, got) = pair
    asm_r, asm_p = copy.deepcopy(asm_r), copy.deepcopy(asm_p)
    rng = np.random.default_rng(3)
    grid = asm_p.grid
    c3 = 2.0 ** rng.integers(-2, 3, size=(grid.km, grid.jmt, grid.imt))
    for asm in (asm_r, asm_p):
        for k in list(asm.shared):
            asm.shared[k] = asm.shared[k] * c3
        asm.self_full = [f * c3 for f in asm.self_full]
        if asm.vmix_dense is not None:
            asm.vmix_dense = asm.vmix_dense * c3[None]
        asm.sink_dense = [None if s is None else s * c3[None]
                          for s in asm.sink_dense]
        asm.cross = {k: v * c3 for k, v in asm.cross.items()}
    s = got.stack_fields(asm_p)
    np.testing.assert_array_equal(s, ref.stack_fields(asm_r))
    rowptr = np.asarray(m_r.rowptr)
    row_of_entry = np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr))
    int3 = np.asarray(asm_p.maps.int3_to_ind)
    wetmask = int3 >= 0
    scale_of_state = np.empty(asm_p.maps.tracer_state_len)
    scale_of_state[int3[wetmask]] = c3[wetmask]
    scale = scale_of_state[row_of_entry % asm_p.maps.tracer_state_len]
    want = np.asarray(m_r.nzval) * scale
    np.testing.assert_array_equal(ref.update(s), want)
    np.testing.assert_array_equal(got.update(torch.from_numpy(s)).numpy(),
                                  want)


def test_update_against_jitted_jax(pair):
    """Against the NK loop's jitted JAX update, jit(plan.update(s * c))
    (bench.py:163): bit for bit on every option set, the W = 2 folds of
    the vmix and generic-tracer sink blocks included. XLA:CPU could have
    fused the multiply into the fold's adds (one rounding per fused
    multiply-add, against the port's separate product and sum); it does
    not, so the tolerance is zero."""
    _, (_, _, ref), (asm_p, _, got) = pair
    s0 = got.stack_fields(asm_p)
    c = 1.0 + 1e-3 * np.random.default_rng(42).standard_normal(got.total)
    jitted = np.asarray(jax.jit(lambda s, cc: ref.update(s * cc))(
        jnp.asarray(s0), jnp.asarray(c)))
    port = got.update(torch.from_numpy(s0) * torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(port, jitted)
