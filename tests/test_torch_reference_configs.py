"""The reference's own assembly configurations through both packages, on
the CPU.

Two options files in the reference's format (drivers/config.py), at the
sizes of tests/test_mf_jax.py's fixtures:

* upwind3: ``adv_type upwind3``, ``hmix_type isop_file``, ``vmix_type
  file``, a constant sink (the reference's stage-1 test options), on the
  20x16x6 grid of seed 33, four tracers, the circulation's upwind3
  transports derived from its own velocities
  (testdata.transports.derive_upwind3_transports: make_circ_file's own
  give a matrix that no LU solves to the contract, pinned below);
* coupled: ``coupled_tracer_cnt 2``, ``coupled_tracer_type
  OCMIP_BGC_PO4_DOP``, one constant sink per tracer and a tracer file
  that holds the cross-tracer derivatives ``d_J_A_d_B``
  (testdata.make_tracer_file's ``coupled_names``), on the 12x10x4 grid of
  seed 35, solved as the pair ``-v OCMIP_BGC_PO4,OCMIP_BGC_DOP``.

Each file goes through the JAX package's gen_A CLI and the port's (the
same matrix, array for array), then through each package's ``run_solve``
on copies of one tracer file: the written values agree to 1e-10 of the
largest entry (tests/test_torch_solve_cli.py's bar), land cells stay bit
for bit, every residual meets the 1e-10 contract, at float64 factors and
at float32 factors with the float64 substitution forced on every round in
both packages (``HI_ROUND_MIN_P`` / ``NK_SOLVE_F64_MINP`` at 1), where
both take the same escalation decision. A gloo world of 2 ranks factors
the upwind3 matrix with the mesh engine against the JAX mesh engine on
the simulated mesh (perms and factors per round), and the Newton-Krylov
loop runs at f64 and at f32 against the JAX loop, at f32 also with the
give-up bar lowered so that both loops escalate to float64.
"""

import functools
import shutil

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from nk_ocn_tracer_jacobian_precond_tpu.drivers import gen_a as jax_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.drivers import solve as jax_solve
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    MultifrontalFactorization as JaxMF)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import (make_circ_file,
                                                         make_tracer_file)
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import gen_a
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import solve
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata.transports import (
    derive_upwind3_transports)
from test_torch_mesh import factors_world, spawn_world

COUPLED = ("OCMIP_BGC_PO4", "OCMIP_BGC_DOP")
# name: (dims, seed, options file body, tracer variables, -v groups)
CONFIGS = {
    "upwind3": (
        dict(imt=20, jmt=16, km=6), 33,
        "adv_type upwind3\nhmix_type isop_file\nvmix_type file\n"
        "sink_type const 1.21e-4\n",
        ("IAGE_CUR", "PO4_CUR", "DOP_CUR", "O2_CUR"),
        "IAGE_CUR,PO4_CUR,DOP_CUR,O2_CUR"),
    "coupled": (
        dict(imt=12, jmt=10, km=4), 35,
        "adv_type centered\nhmix_type isop_file\nvmix_type file\n"
        "tracer_fname {tracer}\ncoupled_tracer_cnt 2\n"
        "coupled_tracer_type OCMIP_BGC_PO4_DOP\n"
        "tracer_ind 0\nsink_type const 1.21e-4\n"
        "tracer_ind 1\nsink_type const 2.0e-4\n",
        COUPLED, ",".join(COUPLED)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """Per configuration: the directory, the tracer file and the matrix
    file each package's gen_A CLI wrote from the same options file."""
    out = {}
    for name, (dims, seed, body, tracers, _) in CONFIGS.items():
        d = tmp_path_factory.mktemp(f"refcfg_{name}")
        circ, tracer = str(d / "circ.nc"), str(d / "tracer.nc")
        make_circ_file(circ, seed=seed, **dims)
        if name == "upwind3":
            derive_upwind3_transports(circ)
        make_tracer_file(tracer, dims["imt"], dims["jmt"], dims["km"],
                         tracer_names=tracers, seed=seed,
                         coupled_names=(COUPLED, COUPLED[::-1]))
        opts = d / "opts.txt"
        opts.write_text(f"circ_fname {circ}\n"
                        + body.format(tracer=tracer))
        mats = {}
        for pkg, main in (("jax", jax_gen_a.main), ("torch", gen_a.main)):
            mats[pkg] = str(d / f"matrix_{pkg}.nc")
            assert main(["-o", str(opts), mats[pkg]]) == 0
        out[name] = d, tracer, mats
    return out


def _read(path, var):
    with netcdf_file(path, "r", mmap=False) as f:
        return np.array(f.variables[var].data, dtype=np.float64)


@pytest.mark.parametrize("name", CONFIGS)
def test_gen_a_matches_jax(configs, name):
    """The port's gen_A CLI writes the JAX gen_A's matrix: rowptr, colind
    and nzval equal (and the files byte for byte); the coupled matrix has
    its cross-tracer blocks, the upwind3 one rows wider than centered's."""
    d, _, mats = configs[name]
    got, want = (read_matrix_file(mats[p]) for p in ("torch", "jax"))
    for key in ("rowptr", "colind", "nzval"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
    with open(mats["torch"], "rb") as a, open(mats["jax"], "rb") as b:
        assert a.read() == b.read()
    A = want.to_scipy().tocoo()
    if name == "coupled":
        tsl = want.flat_len // 2
        assert want.coupled_tracer_cnt == 2
        cross = (A.row < tsl) != (A.col < tsl)
        assert cross.any() and np.all(np.isfinite(A.data[cross]))
    else:
        opts = (d / "opts.txt").read_text().replace("adv_type upwind3",
                                                   "adv_type centered")
        (d / "centered.txt").write_text(opts)
        assert gen_a.main(["-o", str(d / "centered.txt"),
                           str(d / "centered.nc")]) == 0
        centered = read_matrix_file(str(d / "centered.nc"))
        assert centered.flat_len == want.flat_len
        assert want.nnz > centered.nnz


def _solve_both(configs, name, prec, tmp_path, monkeypatch):
    """Both packages' run_solve on copies of the tracer file at ``prec``
    (float32 factors: the float64 substitution on every round in both):
    (paths written, the port's facade, the JAX facade, the hi flag of
    every round of the port's float32 sweeps)."""
    _, _, _, _, vars_arg = CONFIGS[name]
    _, tracer, mats = configs[name]
    paths = {p: str(tmp_path / f"tracer_{p}.nc") for p in ("jax", "torch")}
    for p in paths.values():
        shutil.copy(tracer, p)
    if prec == "f32":
        monkeypatch.setenv("NK_PREC", "f32")
        monkeypatch.setenv("NK_SOLVE_F64_MINP", "1")
        monkeypatch.setattr(mf_torch, "HI_ROUND_MIN_P", 1)
    swept = []
    real_fwd = mf_torch.TorchMultifrontal._fwd

    def fwd(self, rnd, W, cc, hi):
        if self.prec == torch.float32:
            swept.append(hi)
        return real_fwd(self, rnd, W, cc, hi)
    monkeypatch.setattr(mf_torch.TorchMultifrontal, "_fwd", fwd)
    made = []
    real_factor = jax_solve.factor
    monkeypatch.setattr(jax_solve, "factor", lambda *a, **k: made.append(
        real_factor(*a, **k)) or made[-1])
    jax_solve.run_solve(mats["jax"], paths["jax"], vars_arg)
    out = solve.run_solve(mats["torch"], paths["torch"], vars_arg,
                          device="cpu", precision=prec)
    assert max(out["residuals"].values()) <= 1e-10
    return paths, out["factorization"], made[0], swept


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", CONFIGS)
def test_run_solve_matches_jax(configs, name, prec, tmp_path, monkeypatch):
    """The written tracer values of the two packages' run_solve agree to
    1e-10 of the largest entry, land cells are the file's, and every
    variable meets the contract (residual of its own rows of A x - b, in
    long double, at most 1e-10). At f32 every round of the port's float32
    sweeps substitutes in float64, as the JAX engine's rounds do, and
    both packages take the same escalation decision (none, at these
    sizes)."""
    _, _, _, tracers, _ = CONFIGS[name]
    _, tracer, mats = configs[name]
    paths, fac, jfac, swept = _solve_both(configs, name, prec, tmp_path,
                                          monkeypatch)
    maps = load_ind_maps(mats["torch"])
    A = read_matrix_file(mats["torch"]).to_scipy()
    land = maps.int3_to_ind < 0
    b = {v: _read(tracer, v) for v in tracers}
    x = {v: _read(paths["torch"], v) for v in tracers}
    for v in tracers:
        want = maps.flatten_field(_read(paths["jax"], v))
        got = maps.flatten_field(x[v])
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max(), v
        assert np.array_equal(x[v][land], b[v][land]), v
        assert not np.array_equal(x[v][~land], b[v][~land]), v
    ld = np.longdouble
    groups = [tracers] if name == "coupled" else [(v,) for v in tracers]
    for group in groups:
        xs = np.concatenate([maps.flatten_field(x[v]) for v in group])
        bs = np.concatenate([maps.flatten_field(b[v]) for v in group])
        r = (A.astype(ld) @ xs.astype(ld) - bs.astype(ld)).astype(np.float64)
        tsl = maps.tracer_state_len
        for t, v in enumerate(group):
            rows = slice(t * tsl, (t + 1) * tsl)
            rel = np.linalg.norm(r[rows]) / np.linalg.norm(bs[rows])
            assert rel <= 1e-10, (v, rel)
    if prec == "f32":
        import jax.numpy as jnp
        assert fac.escalation is None and fac.engine.prec == torch.float32
        assert jfac.engine.prec == jnp.float32
        assert all(jfac.engine._hi_round(p) for p in jfac.engine.plans)
        assert swept and all(swept)
        assert len(swept) % len(fac.engine.plans) == 0
    else:
        assert not swept


def test_upwind3_transports_belong_to_the_velocities(tmp_path):
    """derive_upwind3_transports writes the positive and negative parts of
    the file's own face transports; make_circ_file's random upwind3 fields
    give a matrix that no LU solves to the contract (a dense partially
    pivoted LU leaves more than 1e-8), the derived ones one that the
    dense LU solves to 1e-12."""
    from nk_ocn_tracer_jacobian_precond_tpu.grid import load_grid
    from nk_ocn_tracer_jacobian_precond_tpu.ops.adv import load_UTE
    from nk_ocn_tracer_jacobian_precond_tpu.ops.fieldsource import (
        FileFieldSource)
    dims, seed, body, _, _ = CONFIGS["upwind3"]
    b = None
    res = {}
    for derived in (False, True):
        circ, mat = str(tmp_path / "circ.nc"), str(tmp_path / "m.nc")
        make_circ_file(circ, seed=seed, **dims)
        if derived:
            derive_upwind3_transports(circ)
            ute = load_UTE(load_grid(circ), FileFieldSource(circ), False)
            src = FileFieldSource(circ)
            pos, neg = src.get3_fv0("UTE_POS"), src.get3_fv0("UTE_NEG")
            np.testing.assert_array_equal(pos + neg, ute)
            assert (pos >= 0).all() and (neg <= 0).all()
        opts = tmp_path / "opts.txt"
        opts.write_text(f"circ_fname {circ}\n{body}")
        assert gen_a.main(["-o", str(opts), mat]) == 0
        A = read_matrix_file(mat).to_scipy().toarray()
        if b is None:
            b = np.random.default_rng(0).standard_normal(A.shape[0])
        x = np.linalg.solve(A, b)
        res[derived] = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    assert res[False] > 1e-8 and res[True] < 1e-12, res


def test_mesh_engine_matches_jax(configs, tmp_path):
    """A gloo world of 2 ranks runs the mesh engine (the facade's
    n_devices=2) on the upwind3 matrix, against the JAX mesh engine on 2
    simulated devices: the same rounds, perms equal round by round and
    factors within 1e-12 of their largest entry (tests/test_torch_mf.py's
    per-round bar), the tree-top rounds of at most two fronts through the
    panel on both ranks, never the library LU; refined solutions within
    1e-10 (rtol) of the JAX one and bit for bit alike on both ranks."""
    from test_torch_mesh import join_world, start_world
    _, _, mats = configs["upwind3"]
    matrix, maps = read_matrix_file(mats["jax"]), load_ind_maps(mats["jax"])
    B = np.random.default_rng(5).standard_normal((matrix.flat_len, 3))
    world = start_world(2, tmp_path, mats["torch"], B, target=factors_world)
    jf = JaxMF(matrix, impl="jax", maps=maps, n_devices=2)
    X_jax = jf.solve(B)
    want = [tuple(np.asarray(a) for a in f[:4]) for f in jf.engine.factors]
    plans = [(p.B, p.P, p.N, p.M) for p in jf.engine.plans]
    ranks = join_world(world)
    assert any(p[0] <= 2 for p in plans)
    for r in ranks:
        assert r["plans"] == plans and r["small_lu_calls"] == 0
        assert np.array_equal(r["X"], ranks[0]["X"])
    for rnd, (got, (jK, jU, jL, jperm)) in enumerate(
            zip(ranks[0]["factors"], want)):
        K, U12, L21, perm = got
        assert np.array_equal(perm.numpy(), jperm.astype(np.int64)), rnd
        for a, b in ((K, jK), (U12, jU), (L21, jL)):
            assert a.shape == b.shape, rnd
            if b.size:
                err = np.abs(a.numpy() - b).max() / np.abs(b).max()
                assert err <= 1e-12, (rnd, err)
    np.testing.assert_allclose(ranks[0]["X"], X_jax, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("prec,giveup", [("f64", None), ("f32", None),
                                         ("f32", 1e-9)],
                         ids=["f64", "f32", "f32-escalates"])
def test_nk_loop_matches_jax(tmp_path, monkeypatch, prec, giveup):
    """The Newton-Krylov loop (bench.py's options, 20x16x6, 2 iterations)
    at ``prec`` against the JAX loop (tests/test_torch_nk_loop.py's
    oracle at the same precision): new values bit for bit, every residual
    at most 1e-10, the same factor dtype after every iteration's solve,
    solutions within 1e-12 (f64) or 1e-10 (f32) of the largest entry. At
    f32 this grid's factors meet the contract by plain refinement; with
    the give-up bar at 1e-9 in both packages (the port's ``giveup``, the
    JAX NK_REFINE_GIVEUP; tests/test_torch_precision.py's escalation bar)
    both escalate to float64 in the first iteration's solve and refactor
    in float64 in the second; each row's refactor split is its refactor's,
    not the escalation's factor that follows in its solve."""
    from test_torch_nk_loop import DIMS, N_ITER, TOL, _jax_loop
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import nk_loop
    if giveup is not None:
        monkeypatch.setenv("NK_REFINE_GIVEUP", str(giveup))
        monkeypatch.setattr(nk_loop, "MultifrontalFactorization",
                            functools.partial(nk_loop.MultifrontalFactorization,
                                              giveup=giveup))
    matrix, maps, circ = nk_loop.build_problem(DIMS, str(tmp_path))
    B = np.random.default_rng(0).standard_normal((matrix.flat_len, 4))
    port = nk_loop.run_nk_loop(matrix, maps, circ, B, N_ITER, tol=TOL,
                               device="cpu", precision=prec)
    _, ref = _jax_loop(circ.replace("circ_", "matrix_"), circ, B, prec)
    want_dtypes = {"f64": ["float64"] * N_ITER,
                   "f32": ["float32"] * N_ITER if giveup is None
                   else ["float64"] * N_ITER}[prec]
    assert [r["factor_dtype"] for r in port.rows] == want_dtypes
    assert [r["escalated"] for r in port.rows] == [
        giveup is not None] + [False] * (N_ITER - 1)
    bar = {"f64": 1e-12, "f32": 1e-10}[prec]
    for row, nz, X, (want, X_ref, res_ref, dtype) in zip(
            port.rows, port.nzvals, port.solutions, ref):
        np.testing.assert_array_equal(nz, want)
        assert row["residual"] <= 1e-10 and res_ref <= 1e-10
        assert row["factor_dtype"] == dtype, row["it"]
        # the refactor's own split, not the escalation's factor after it
        assert sum(row["refactor_split"].values()) <= row["refactor"]
        rel = float(np.abs(X - X_ref).max() / np.abs(X_ref).max())
        assert rel <= bar, (row["it"], rel)
