"""The port's copies of the JAX package's host layers against the originals.

The port (``nk_ocn_tracer_jacobian_precond_tpu_torch``) keeps its own
copies of the reference's numpy and C++ host code (``io``, ``grid``,
``ops``, ``testdata``, ``native``, ``utils``, the symbolic analysis, the
memory plan, the equilibration, ``drivers.gen_a``) so that it imports
nothing of the JAX package. The copies must behave exactly as the
originals: byte-identical files, equal orderings, trees and plans, and
bit-equal scalings.
"""

import dataclasses
import filecmp
import os
import shutil

import numpy as np
import pytest

import nk_ocn_tracer_jacobian_precond_tpu as ref_pkg
import nk_ocn_tracer_jacobian_precond_tpu_torch as port_pkg
from nk_ocn_tracer_jacobian_precond_tpu import native as ref_native
from nk_ocn_tracer_jacobian_precond_tpu.drivers import gen_a as ref_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid import indmap as ref_indmap
from nk_ocn_tracer_jacobian_precond_tpu.io import matrixfile as ref_mfile
from nk_ocn_tracer_jacobian_precond_tpu.ops import options as ref_options
from nk_ocn_tracer_jacobian_precond_tpu.solver import memplan as ref_memplan
from nk_ocn_tracer_jacobian_precond_tpu.solver import mf as ref_mf
from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
from nk_ocn_tracer_jacobian_precond_tpu.solver import ordering as ref_ordering
from nk_ocn_tracer_jacobian_precond_tpu.solver import symbolic as ref_symbolic
from nk_ocn_tracer_jacobian_precond_tpu.testdata import synthetic as ref_synth
from nk_ocn_tracer_jacobian_precond_tpu_torch import native
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import gen_a
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid import indmap
from nk_ocn_tracer_jacobian_precond_tpu_torch.io import matrixfile
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import options
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import memplan, mf
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import ordering, plan
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import symbolic
from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import synthetic

IMT, JMT, KM = 14, 10, 5

# gen_A option sets from tests/test_assembly.py (single-tracer combinations,
# sink options, coupled tracers) and tests/test_end_to_end.py: (assembly
# keyword arguments, per-tracer keyword arguments)
GEN_A_CASES = {
    "centered_isop_file": (dict(adv_type="centered", hmix_type="isop_file",
                                vmix_type="file"), [{}]),
    "upwind3_isop_file": (dict(adv_type="upwind3", hmix_type="isop_file",
                               vmix_type="file"), [{}]),
    "donor_const_file": (dict(adv_type="donor", hmix_type="const",
                              vmix_type="file"), [{}]),
    "upwind3_matrix_file": (dict(adv_type="upwind3", hmix_type="isop_file",
                                 vmix_type="matrix_file"), [{}]),
    "end_to_end_const_sink": (dict(adv_type="centered", hmix_type="const",
                                   vmix_type="file"),
                              [dict(sink_type="const", sink_rate=1.21e-4)]),
    "generic_tracer_sink": (dict(hmix_type="const", vmix_type="file"),
                            [dict(sink_type="generic_tracer",
                                  sink_generic_tracer_name="DIC",
                                  sink_generic_tracer_depends_layer_cnt=3)]),
    "coupled_po4_dop": (dict(hmix_type="isop_file", vmix_type="file",
                             coupled_tracer_cnt=2,
                             coupled_tracer_type="OCMIP_BGC_PO4_DOP"),
                        [{}, {}]),
}


def _make_inputs(mod, d):
    """Circulation and tracer files of tests/test_assembly.py, made by the
    synthetic-data module ``mod`` (the reference's or the port's)."""
    circ, tracer = str(d / "circ.nc"), str(d / "tracer.nc")
    mod.make_circ_file(circ, imt=IMT, jmt=JMT, km=KM, seed=4)
    mod.make_tracer_file(
        tracer, IMT, JMT, KM, tracer_names=("IAGE_CUR",),
        sink_field_names=("my_sink_rate",),
        generic_tracer_names=("PO4", "DIC"),
        coupled_names=(("OCMIP_BGC_PO4", "OCMIP_BGC_DOP"),
                       ("OCMIP_BGC_DOP", "OCMIP_BGC_PO4")),
        pv_names=("pv_a", "pv_b"), seed=4)
    return circ, tracer


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d_ref = tmp_path_factory.mktemp("hostcopy_ref")
    d_port = tmp_path_factory.mktemp("hostcopy_port")
    return _make_inputs(ref_synth, d_ref), _make_inputs(synthetic, d_port)


def test_synthetic_files_byte_identical(inputs):
    (circ_r, tracer_r), (circ_p, tracer_p) = inputs
    assert filecmp.cmp(circ_r, circ_p, shallow=False)
    assert filecmp.cmp(tracer_r, tracer_p, shallow=False)


def _opts(opt_mod, circ, tracer, case):
    kw, pts = GEN_A_CASES[case]
    return opt_mod.AssemblyOptions(
        circ_fname=circ, tracer_fname=tracer,
        per_tracer=[opt_mod.PerTracerOptions(**pt) for pt in pts], **kw)


@pytest.mark.parametrize("case", sorted(GEN_A_CASES))
def test_gen_a_matrix_file_byte_identical(inputs, tmp_path, case):
    (circ, tracer), _ = inputs
    want, got = str(tmp_path / "ref.nc"), str(tmp_path / "port.nc")
    ref_gen_a.run_gen_a(want, opts=_opts(ref_options, circ, tracer, case))
    gen_a.run_gen_a(got, opts=_opts(options, circ, tracer, case))
    assert os.path.getsize(got) > 0
    assert filecmp.cmp(want, got, shallow=False)


def test_gen_a_cli_option_file(inputs, tmp_path):
    """The port's stage-1 CLI reads the reference's option-file syntax
    (tests/test_end_to_end.py's 4-character prefix) to the same file."""
    (circ, _), _ = inputs
    optf = tmp_path / "opts.txt"
    optf.write_text(f"circ_fname {circ}\nadv_type cent\nhmix_type const\n"
                    f"vmix_type file\nsink_type const 1.21e-4\n")
    want, got = str(tmp_path / "ref.nc"), str(tmp_path / "port.nc")
    assert ref_gen_a.main(["-o", str(optf), want]) == 0
    assert gen_a.main(["-o", str(optf), got]) == 0
    assert filecmp.cmp(want, got, shallow=False)


def _assert_same(a, b, where=".", equal_nan=False):
    """Field-by-field equality of two trees of dataclasses, dicts, lists
    and arrays (the classes themselves differ: one per package); with
    ``equal_nan``, NaNs in the same places of float arrays are equal."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}", equal_nan)
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]", equal_nan)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]", equal_nan)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=equal_nan and a.dtype.kind == "f"), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.fixture(scope="module")
def matrices(inputs, tmp_path_factory):
    """One gen_A matrix (the coupled case: two tracers), read back by
    each package's own reader."""
    (circ, tracer), _ = inputs
    d = tmp_path_factory.mktemp("hostcopy_mat")
    ref_gen_a.run_gen_a(str(d / "m.nc"), opts=_opts(
        ref_options, circ, tracer, "coupled_po4_dop"))
    return ((ref_mfile.read_matrix_file(str(d / "m.nc")),
             ref_indmap.load_ind_maps(str(d / "m.nc"))),
            (matrixfile.read_matrix_file(str(d / "m.nc")),
             indmap.load_ind_maps(str(d / "m.nc"))))


def test_matrix_file_reader_and_maps_equal(matrices):
    (m_r, maps_r), (m_p, maps_p) = matrices
    _assert_same(m_r, m_p)
    _assert_same(maps_r, maps_p)


@pytest.mark.parametrize("leaf_size", [6, 32])
def test_symbolic_equal(matrices, leaf_size):
    (m_r, maps_r), (m_p, maps_p) = matrices
    g_r = ref_ordering.build_column_graph(maps_r, m_r)
    g_p = ordering.build_column_graph(maps_p, m_p)
    _assert_same(g_r, g_p)
    _assert_same(ref_ordering.nested_dissection(g_r, leaf_size=leaf_size),
                 ordering.nested_dissection(g_p, leaf_size=leaf_size))
    _assert_same(ref_symbolic.symbolic_from_matrix(maps_r, m_r, leaf_size),
                 symbolic.symbolic_from_matrix(maps_p, m_p, leaf_size))


@pytest.mark.parametrize("n_devices,bytes_per_elem", [(1, 4), (1, 8), (4, 8)])
def test_plan_memory_equal(matrices, n_devices, bytes_per_elem):
    (m_r, maps_r), (m_p, maps_p) = matrices
    plans_r = mf_jax.build_plan(
        ref_symbolic.symbolic_from_matrix(maps_r, m_r, 6), m_r)
    plans_p = plan.build_plan(symbolic.symbolic_from_matrix(maps_p, m_p, 6),
                              m_p)
    want = ref_memplan.plan_memory(plans_r, n_devices, bytes_per_elem)
    got = memplan.plan_memory(plans_p, n_devices, bytes_per_elem)
    _assert_same(want, got)
    assert got.summary() == want.summary()


def test_equilibrate_bit_equal(matrices):
    (m_r, _), (m_p, _) = matrices
    s_r, dr_r, dc_r = ref_mf.equilibrate(m_r)
    s_p, dr_p, dc_p = mf.equilibrate(m_p)
    _assert_same(s_r, s_p)
    _assert_same(dr_r, dr_p)
    _assert_same(dc_r, dc_p)
    X = np.random.default_rng(3).standard_normal((m_r.flat_len, 2))
    B = m_r.to_scipy() @ X + 1e-9
    _assert_same(ref_mf._rel_residuals(m_r.to_scipy(), X, B),
                 mf._rel_residuals(m_p.to_scipy(), X, B))


def test_native_builds_outside_the_source_tree():
    if native._load() is None:
        pytest.skip("no C++ toolchain")
    so = native._so_path()
    assert os.path.exists(so)
    assert os.path.dirname(os.path.dirname(so)) == native._BUILD_ROOT
    pkg_dir = os.path.dirname(port_pkg.__file__)
    assert not so.startswith(pkg_dir + os.sep)
    assert "-march=native" not in native._FLAGS
    assert not os.path.exists(os.path.join(os.path.dirname(native.__file__),
                                            "nk_core.so"))


def _native_outputs(matrices):
    """What the port's native layer feeds: the column graph, the symbolic
    analysis and the round plans."""
    _, (m_p, maps_p) = matrices
    sym = symbolic.symbolic_from_matrix(maps_p, m_p, 6)
    return dict(graph=ordering.build_column_graph(maps_p, m_p), sym=sym,
                plans=plan.build_plan(sym, m_p))


def test_native_equals_numpy_fallback(matrices, monkeypatch):
    if native._load() is None:
        pytest.skip("no C++ toolchain")
    with_native = _native_outputs(matrices)
    monkeypatch.setattr(native, "_load", lambda: None)
    _assert_same(with_native, _native_outputs(matrices))


def test_native_canonicalize_equals_numpy_fallback(inputs, monkeypatch):
    """gen_A's canonical CSR (the native duplicate summation in emission
    order, or its numpy fallback) through the port's stage 1."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid import (gen_ind_maps,
                                                               load_grid)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (
        assemble_jacobian)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.assemble import to_csr
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.fieldsource import (
        FileFieldSource)
    if native._load() is None:
        pytest.skip("no C++ toolchain")
    (circ, tracer), _ = inputs
    opts = _opts(options, circ, tracer, "upwind3_isop_file")
    grid = load_grid(circ)
    maps = gen_ind_maps(np.asarray(grid.KMT), grid.km)
    asm = assemble_jacobian(grid, opts, FileFieldSource(circ),
                            FileFieldSource(tracer), maps)
    want = to_csr(asm)
    monkeypatch.setattr(native, "_load", lambda: None)
    got = to_csr(asm)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(want[1], got[1])
    np.testing.assert_array_equal(want[2], got[2])
    # values: the C++ path folds duplicates left to right (the reference's
    # order); numpy's reduceat may sum pairwise, so 1-2 ulp may differ
    np.testing.assert_allclose(want[0], got[0], rtol=1e-15, atol=0)


def test_native_entry_points_equal_reference_native():
    """Both packages' native libraries give the same answers."""
    if native._load() is None or ref_native._load() is None:
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(0)
    flat_len = 300
    rows = rng.integers(0, flat_len, 5000)
    cols = rng.integers(0, flat_len, 5000)
    vals = rng.standard_normal(5000)
    _assert_same(list(ref_native.canonicalize_coo(rows, cols, vals,
                                                  flat_len)),
                 list(native.canonicalize_coo(rows, cols, vals, flat_len)))
    rowptr = np.arange(0, flat_len * 8 + 1, 8)
    colind = np.sort(rng.integers(0, flat_len, (flat_len, 8)), axis=1)
    cell_node = rng.integers(0, 20, flat_len)
    cell_elim = rng.permutation(flat_len)
    _assert_same(ref_native.route_entries(rowptr, colind.ravel(), cell_node,
                                          cell_elim),
                 native.route_entries(rowptr, colind.ravel(), cell_node,
                                      cell_elim))
    _assert_same(list(ref_native.plan_entries(rowptr, colind.ravel(),
                                              cell_node, cell_elim, 20)),
                 list(native.plan_entries(rowptr, colind.ravel(), cell_node,
                                          cell_elim, 20)))
    col_of_row = rng.integers(0, 40, flat_len)
    _assert_same(list(ref_native.column_adjacency(rowptr, colind.ravel(),
                                                  col_of_row, 40)),
                 list(native.column_adjacency(rowptr, colind.ravel(),
                                              col_of_row, 40)))


def test_packages_are_distinct():
    """The port's copies are its own modules, not re-exports."""
    assert symbolic.SymbolicFactorization is not (
        ref_symbolic.SymbolicFactorization)
    assert matrixfile.SparseMatrix is not ref_mfile.SparseMatrix
    assert not ref_pkg.__file__.startswith(
        os.path.dirname(port_pkg.__file__))


def test_ncdiff_exit_codes_equal(inputs, tmp_path, capsys):
    """The port's ncdiff (over its own netcdf3 reader) against the JAX
    package's: the same exit code and report on equal files (0), files
    whose values differ (1), and mismatched files (2: a variable missing
    or of another shape), with and without a tolerance."""
    from nk_ocn_tracer_jacobian_precond_tpu.drivers import ncdiff as ref_ncd
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import ncdiff
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io import fields
    (_, tracer), _ = inputs
    same = str(tmp_path / "same.nc")
    synthetic.make_tracer_file(
        same, IMT, JMT, KM, tracer_names=("IAGE_CUR",),
        sink_field_names=("my_sink_rate",),
        generic_tracer_names=("PO4", "DIC"),
        coupled_names=(("OCMIP_BGC_PO4", "OCMIP_BGC_DOP"),
                       ("OCMIP_BGC_DOP", "OCMIP_BGC_PO4")),
        pv_names=("pv_a", "pv_b"), seed=4)
    changed = str(tmp_path / "changed.nc")
    synthetic.make_tracer_file(changed, IMT, JMT, KM,
                               tracer_names=("IAGE_CUR",), seed=4)
    f3 = fields.get_var_double(changed, "IAGE_CUR", 3)
    fields.put_var_inplace(changed, "IAGE_CUR", f3 * (1 + 1e-9))
    other = str(tmp_path / "other.nc")
    synthetic.make_tracer_file(other, IMT + 1, JMT, KM,
                               tracer_names=("IAGE_CUR",), seed=4)
    cases = [(tracer, same, None, {}), (tracer, changed, None, {}),
             (tracer, changed, ["IAGE_CUR"], dict(rtol=1e-6)),
             (tracer, other, ["IAGE_CUR"], {}),
             (tracer, changed, ["IAGE_CUR", "NOPE"], {})]
    codes = []
    for a, b, names, kw in cases:
        want = ref_ncd.diff_files(a, b, names, **kw)
        want_out = capsys.readouterr().out
        got = ncdiff.diff_files(a, b, names, **kw)
        assert (got, capsys.readouterr().out) == (want, want_out)
        codes.append(got)
    assert codes == [0, 1, 0, 2, 2]
    assert ncdiff.main(["-q", "-v", "IAGE_CUR", tracer, changed]) == 1


def test_torch_trace_writes_a_trace(tmp_path):
    """torch_trace on the CPU (named) writes one Chrome trace holding the
    block's operators, also when the block raises."""
    import json

    import torch

    from nk_ocn_tracer_jacobian_precond_tpu_torch.utils import profiling
    with profiling.torch_trace(str(tmp_path / "t"), "cpu") as prof:
        torch.ones(64, dtype=torch.float64).cumsum(0)
    assert any("cumsum" in e.key for e in prof.key_averages())
    files = list((tmp_path / "t").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    with pytest.raises(RuntimeError, match="inside"):
        with profiling.torch_trace(str(tmp_path / "u"), "cpu"):
            raise RuntimeError("inside")
    assert len(list((tmp_path / "u").iterdir())) == 1


@pytest.mark.parametrize("kw", [
    dict(),
    dict(imt=16, jmt=12, km=5, seed=42, adv_type="upwind3",
         hmix_type="isop_file", vmix_type="file")])
def test_demo_assembly_equal(kw):
    """parallel/demo.py's make_demo_assembly, called with the same
    arguments in both packages: equal assemblies and equal index maps."""
    from nk_ocn_tracer_jacobian_precond_tpu.parallel import demo as ref_demo
    from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import demo
    asm_r, maps_r = ref_demo.make_demo_assembly(**kw)
    asm_p, maps_p = demo.make_demo_assembly(**kw)
    # each call writes its circulation file into a temporary directory of
    # its own: the paths differ, the files do not
    circ_r, circ_p = asm_r.opts.circ_fname, asm_p.opts.circ_fname
    assert filecmp.cmp(circ_r, circ_p, shallow=False)
    for c in (circ_r, circ_p):
        shutil.rmtree(os.path.dirname(c))
    asm_p.opts = dataclasses.replace(asm_p.opts, circ_fname=circ_r)
    # the dense coefficient fields hold NaN on land in both
    _assert_same(asm_r, asm_p, equal_nan=True)
    _assert_same(maps_r, maps_p)
