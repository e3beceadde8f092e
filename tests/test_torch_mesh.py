"""The port's device mesh (parallel/mesh.py) and the sharded stencil apply
in one process, and the worker that the multi-process tests spawn.

In a process with no process group, ``make_mesh`` is a world of one: it
raises as the JAX package's make_mesh does (more devices than exist, two
primary axis names, an "rhs" count that does not divide), and one band of
the sharded apply is ``apply`` bit for bit. Without a process group, more
than one band raises: the sharded apply never computes on one device.

``band_world`` is what tests/test_torch_dist_stencil.py runs in each rank
of a gloo world on the CPU (``spawn_world``), ``solver_world`` what
tests/test_torch_dist_solver.py runs, ``factors_world`` what
tests/test_torch_reference_configs.py runs and ``profile_world`` what
tests/test_torch_profile.py runs. This file imports no jax, so the
spawned ranks do not load it.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import (
    StencilOperator, init_process_group, make_mesh)
from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel.demo import (
    make_demo_assembly)
from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel.mesh import Mesh

# the three ways the JAX make_mesh refuses a mesh: (keyword arguments of a
# world of n, the ValueError's message)
BAD_MESHES = [
    (lambda n: dict(n_devices=n + 1), "requested {m} devices, have {n}"),
    (lambda n: dict(n_devices=n, axis_names=("band", "x")),
     "single primary axis name"),
    (lambda n: dict(n_devices=n, rhs_devices=3), "must divide"),
]


def wet_field(asm, nt: int, seed: int = 8) -> torch.Tensor:
    """tests/test_stencil.py's x: one standard normal field on the wet
    cells (zeros on land), repeated over the tracers."""
    km, jmt, imt = asm.grid.km, asm.grid.jmt, asm.grid.imt
    wet = np.arange(km)[:, None, None] < np.asarray(asm.grid.KMT)[None]
    rng = np.random.default_rng(seed)
    x = np.where(wet, rng.standard_normal((km, jmt, imt)), 0.0)[None]
    return torch.from_numpy(np.repeat(x, nt, axis=0))


def sharded(op: StencilOperator, mesh: Mesh, x: torch.Tensor):
    """The sharded apply of ``x`` over ``mesh``: rank 0 scatters the
    padded field, every rank applies its band, the bands are gathered."""
    apply_fn, layout, pad_field, unpad_field = op.sharded_apply_factory(mesh)
    x_l = layout.scatter(pad_field(x) if mesh.coords[0] == 0 else None)
    return unpad_field(layout.gather(apply_fn(x_l)))


def band_world(rank: int, world: int, store: str, op: StencilOperator,
               x: torch.Tensor, out_dir: str) -> None:
    """One rank of a gloo world of ``world`` ranks: the sharded apply over
    all ranks and over the first half of them, the make_mesh refusals, and
    with 4 ranks or more an (n / 2, 2) mesh whose "rhs" groups sum their
    ranks. Writes what it saw to ``out_dir``/rank<r>.pt."""
    torch.set_num_threads(1)
    init_process_group("cpu", rank, world, store)
    try:
        out = dict(y=sharded(op, make_mesh(world), x),
                   default_shape=make_mesh().shape)
        errors = []
        for kw, _ in BAD_MESHES:
            try:
                make_mesh(**kw(world))
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        out["errors"] = errors
        half = make_mesh(world // 2)
        out["half_coords"] = half.coords
        if half.coords is not None:
            out["y_half"] = sharded(op, half, x)
        if world >= 4:
            m2 = make_mesh(world, ("front",), rhs_devices=2)
            t = torch.tensor([float(rank)])
            dist.all_reduce(t, group=m2.rhs_group)
            out.update(rhs_shape=m2.shape, rhs_axes=m2.axis_names,
                       rhs_coords=m2.coords, rhs_sum=float(t))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class JaxFactors:
    """Stands in for a JAX mesh engine in ``mf_torch.factors_from_jax`` on
    a rank, which imports no jax: that engine's global factors as numpy
    5-tuples, and the rounds it row-shards. ``plans`` are set on the rank
    (the port's own, equal to the JAX engine's)."""

    def __init__(self, factors, row_sharded):
        self.factors = factors
        self.rows = list(row_sharded)
        self.plans = None

    def _row_sharded(self, plan) -> bool:
        return self.rows[next(i for i, p in enumerate(self.plans)
                              if p is plan)]


def _mesh_case(fac, B, gather: bool) -> dict:
    """What tests/test_torch_dist_solver.py reads of one facade on a rank:
    its solution of B, the layouts, shard shapes and resident bytes (with
    the plan's), the refiner's decisions and, with ``gather``, the whole
    factors."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.memplan import (
        plan_memory)
    eng = fac.engine
    gf = eng.global_factors()
    if gather:
        gf = [tuple(t.clone() for t in f) for f in gf]
    X = fac.solve(B)
    out = dict(
        X=X, stats=fac._refiner.stats,
        layouts=[(lay.kind, lay.masked, lay.border) for lay in eng.layouts],
        plans=[(p.B, p.P, p.N, p.M) for p in eng.plans],
        shapes=[tuple(tuple(t.shape) for t in f) + (
            None if kd is None else tuple(kd.shape),)
            for f, kd in zip(eng.factors, eng.kd)],
        resident=eng.resident_factor_bytes(),
        planned=plan_memory(eng.plans, eng.ndev, eng.prec.itemsize,
                            row_shard_min=eng.row_shard_min
                            ).factor_bytes_per_device)
    if gather:
        out["factors"] = gf
    return out


def solver_world(rank: int, world: int, store: str, cases: dict,
                 out_dir: str) -> None:
    """One rank of a gloo world of ``world`` ranks running the mesh engine
    through the facade on tests/test_dist_solver.py's fixtures (``cases``:
    matrix file paths, the JAX stand-in and which optional cases run).
    Writes what it saw to ``out_dir``/rank<r>.pt."""
    torch.set_num_threads(1)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        load_ind_maps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (
        cuda_kernels as ck, mf_torch)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
        MultifrontalFactorization)
    init_process_group("cpu", rank, world, store)
    try:
        def load(path):
            return read_matrix_file(path), load_ind_maps(path)

        # the library LU must never run under a mesh
        small = []
        real_small = mf_torch.partial_factor_small_batch
        mf_torch.partial_factor_small_batch = (
            lambda *a, **k: small.append(1) or real_small(*a, **k))
        matrix, maps = load(cases["transport"])
        n = matrix.flat_len
        out = {}
        fac = MultifrontalFactorization(matrix, maps=maps, device="cpu",
                                        n_devices=world)
        out["default"] = _mesh_case(
            fac, np.random.default_rng(5).standard_normal((n, 3)), False)
        row = MultifrontalFactorization(matrix, maps=maps, device="cpu",
                                        sym=fac.sym, n_devices=world,
                                        row_shard_min=64)
        B7 = np.random.default_rng(7).standard_normal((n, 3))
        out["row"] = _mesh_case(row, B7, rank == 0)
        out["small_lu_calls"] = len(small)
        # round checkpoints under the mesh: the first rank writes every
        # round (offload streams them back into each rank's layout), then
        # a second engine on the directory loads them all and assembles
        # nothing
        ckdir = os.path.join(out_dir, "rounds")
        kw = dict(maps=maps, device="cpu", sym=fac.sym, n_devices=world,
                  row_shard_min=64, factor_checkpoint_dir=ckdir)
        first = MultifrontalFactorization(matrix, **kw)
        assembled = []
        real_asm = ck.ell_assemble
        ck.ell_assemble = lambda *a, **k: assembled.append(1) or real_asm(
            *a, **k)
        try:
            again = MultifrontalFactorization(matrix, **kw)
        finally:
            ck.ell_assemble = real_asm
        out["ckpt"] = dict(X=first.solve(B7), X_again=again.solve(B7),
                           assembled=len(assembled),
                           offload=first.engine._offload,
                           files=sorted(os.listdir(ckdir)))
        # the JAX mesh engine's factors, sliced to this rank, solved by
        # the port's mesh engine
        jf = cases["jax"]
        eng = mf_torch.TorchMultifrontal(
            row.sym, row._fac_matrix, torch.device("cpu"), factorize=False,
            mesh=row.mesh, row_shard_min=64)
        jf.plans = eng.plans
        eng.set_factors(mf_torch.factors_from_jax(jf, "cpu", row.mesh))
        out["from_jax"] = dict(Y=eng.solve(cases["engine_rhs"]),
                               masked=[kd is not None for kd in eng.kd])
        cm, cmaps = load(cases["coupled"])
        cfac = MultifrontalFactorization(cm, maps=cmaps, device="cpu",
                                         n_devices=world)
        out["coupled"] = cfac.solve(
            np.random.default_rng(9).standard_normal((cm.flat_len, 2)))
        try:
            MultifrontalFactorization(matrix, maps=maps, device="cpu",
                                      sym=fac.sym, n_devices=8 * world)
            out["too_many"] = None
        except ValueError as e:
            out["too_many"] = str(e)
        if cases.get("f32"):
            f32 = MultifrontalFactorization(matrix, maps=maps, device="cpu",
                                            sym=fac.sym, n_devices=world,
                                            precision="f32")
            out["f32"] = _mesh_case(
                f32, np.random.default_rng(9).standard_normal((n, 2)),
                rank == 0)
            out["f32"]["escalation"] = f32.escalation
        if cases.get("rhs"):
            rfac = MultifrontalFactorization(matrix, maps=maps, device="cpu",
                                             sym=fac.sym, n_devices=world,
                                             rhs_devices=2)
            out["rhs"] = dict(
                mesh=(rfac.mesh.axis_names, rfac.mesh.shape,
                      rfac.mesh.coords),
                X=rfac.solve(np.random.default_rng(21).standard_normal(
                    (n, 4))))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def factors_world(rank: int, world: int, store: str, mat: str, B,
                  out_dir: str) -> None:
    """One rank of a gloo world of ``world`` ranks factoring ``mat``
    through the facade with ``n_devices=world`` (the mesh engine) and
    solving ``B``: writes the plans, the whole factors gathered to every
    rank, the library LU calls (none under a mesh) and the solution to
    ``out_dir``/rank<r>.pt."""
    torch.set_num_threads(1)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        load_ind_maps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
        MultifrontalFactorization)
    init_process_group("cpu", rank, world, store)
    try:
        small = []
        real_small = mf_torch.partial_factor_small_batch
        mf_torch.partial_factor_small_batch = (
            lambda *a, **k: small.append(1) or real_small(*a, **k))
        fac = MultifrontalFactorization(read_matrix_file(mat),
                                        maps=load_ind_maps(mat),
                                        device="cpu", n_devices=world)
        eng = fac.engine
        out = dict(plans=[(p.B, p.P, p.N, p.M) for p in eng.plans],
                   factors=[tuple(t.clone() for t in f)
                            for f in eng.global_factors()],
                   small_lu_calls=len(small), X=fac.solve(B))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def profile_world(rank: int, world: int, store: str, mat: str,
                  out_dir: str) -> None:
    """One rank of a gloo world of ``world`` ranks profiling the mesh
    engine's refactor of ``mat`` (drivers.profile.profile_refactor, the
    facade with ``n_devices=world``): writes the profile, the plans and
    whether the profiled factors equal an unprofiled refactor's to
    ``out_dir``/rank<r>.pt."""
    torch.set_num_threads(1)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.profile import (
        profile_refactor)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        load_ind_maps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
        MultifrontalFactorization)
    init_process_group("cpu", rank, world, store)
    try:
        fac = MultifrontalFactorization(read_matrix_file(mat),
                                        maps=load_ind_maps(mat),
                                        device="cpu", n_devices=world)
        prof = profile_refactor(fac, "cpu")
        timed = [tuple(t.clone() for t in f) for f in fac.engine.factors]
        fac.refactor()
        same = all(torch.equal(a, b) for fa, fb in zip(
            timed, fac.engine.factors) for a, b in zip(fa, fb))
        torch.save(dict(prof=prof, same=same, plans=[
            (p.B, p.P, p.N, len(p.child_groups)) for p in fac.engine.plans],
            layouts=[lay.kind for lay in fac.engine.layouts]),
            os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_world(world: int, tmp_path, *args, target=band_world):
    """Start ``target(rank, world, store, *args, out_dir)`` (``band_world``
    by default, with args (op, x)) in ``world`` spawned processes; returns
    the handle ``join_world`` takes."""
    out_dir = tmp_path / f"{target.__name__}{world}"
    out_dir.mkdir()
    ctx = torch.multiprocessing.start_processes(
        target, args=(world, str(out_dir / "store"), *args, str(out_dir)),
        nprocs=world, join=False, start_method="spawn")
    return ctx, world, out_dir


def join_world(handle, timeout_s: float = 240.0) -> list:
    """Wait for a started world; the per-rank dicts each rank saved as
    out_dir/rank<r>.pt. Kills the ranks and fails after ``timeout_s``."""
    ctx, world, out_dir = handle
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"world of {world} ranks did not finish in "
                        f"{timeout_s:.0f} s")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def spawn_world(world: int, tmp_path, *args, target=band_world,
                timeout_s: float = 240.0) -> list:
    """start_world, then join_world."""
    return join_world(start_world(world, tmp_path, *args, target=target),
                      timeout_s)


@pytest.fixture(scope="module")
def demo():
    asm, _ = make_demo_assembly(16, 12, 5, seed=42, adv_type="upwind3",
                                hmix_type="isop_file", vmix_type="file")
    op = StencilOperator.from_assembly(asm, "cpu")
    return asm, op, wet_field(asm, op.nt)


def test_world_of_one_mesh():
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert (mesh.axis_names, mesh.shape, mesh.ranks, mesh.coords) == (
        ("band",), (1,), (0,), (0,))
    assert mesh.group is None and mesh.rhs_group is None
    assert make_mesh(1, ("front",)).axis_names == ("front",)


@pytest.mark.parametrize("case", range(len(BAD_MESHES)))
def test_make_mesh_refuses_as_jax(case):
    kw, msg = BAD_MESHES[case]
    with pytest.raises(ValueError, match=msg.format(m=2, n=1)):
        make_mesh(**kw(1))


def test_one_band_is_apply_bitwise(demo):
    asm, op, x = demo
    y = sharded(op, make_mesh(1), x)
    assert torch.equal(y, op.apply(x))
    assert op.sharded_apply_factory(make_mesh(1))[1].shape == (
        op.nt,) + op.shape


def test_bands_without_a_group_raise(demo):
    """A mesh of two bands in a process with no group: no quiet fallback
    to one device."""
    _, op, _ = demo
    two = Mesh(axis_names=("band",), shape=(2,), ranks=(0, 1), coords=(0,))
    with pytest.raises(RuntimeError, match="initialized process group"):
        op.sharded_apply_factory(two)
    with pytest.raises(ValueError, match="1-D mesh"):
        op.sharded_apply_factory(make_mesh(1, ("front",)))


def test_band_fields_are_the_rows_of_the_padded_fields(demo):
    """A band too thin for the halo raises; the padding rows of a
    5-band layout are zeros past jmt."""
    asm, op, x = demo
    thin = Mesh(axis_names=("band",), shape=(12,), ranks=tuple(range(12)),
                coords=(0,))
    mp = pytest.MonkeyPatch()
    mp.setattr(dist, "is_initialized", lambda: True)
    try:
        with pytest.raises(ValueError, match="at least 2 rows"):
            op.sharded_apply_factory(thin)
        five = Mesh(axis_names=("band",), shape=(5,), ranks=tuple(range(5)),
                    coords=(4,))
        _, layout, pad_field, unpad_field = op.sharded_apply_factory(five)
    finally:
        mp.undo()
    assert layout.shape == (op.nt, 5, 15, 16) and layout.rows == 3
    xp = pad_field(x)
    assert xp.shape == layout.shape and not xp[:, :, 12:].any()
    assert torch.equal(unpad_field(xp), x)
