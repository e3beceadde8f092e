"""The port's device mesh (parallel/mesh.py) and the sharded stencil apply
in one process, and the worker that the multi-process tests spawn.

In a process with no process group, ``make_mesh`` is a world of one: it
raises as the JAX package's make_mesh does (more devices than exist, two
primary axis names, an "rhs" count that does not divide), and one band of
the sharded apply is ``apply`` bit for bit. Without a process group, more
than one band raises: the sharded apply never computes on one device.

``band_world`` is what tests/test_torch_dist_stencil.py runs in each rank
of a gloo world on the CPU (``spawn_world``). This file imports no jax, so
the spawned ranks do not load it.
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


def spawn_world(world: int, tmp_path, op: StencilOperator,
                x: torch.Tensor, timeout_s: float = 240.0) -> list:
    """``band_world`` in ``world`` spawned processes; the per-rank dicts.
    Kills the ranks and fails after ``timeout_s``."""
    out_dir = tmp_path / f"world{world}"
    out_dir.mkdir()
    ctx = torch.multiprocessing.start_processes(
        band_world, args=(world, str(out_dir / "store"), op, x,
                          str(out_dir)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"world of {world} ranks did not finish in "
                        f"{timeout_s:.0f} s")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


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
