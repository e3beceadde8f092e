"""The port's band-sharded stencil apply over a gloo world on the CPU,
against the port's single-device ``apply`` and the JAX package's
``sharded_apply_factory`` on its simulated 8-device mesh.

tests/test_stencil.py's fixture (16x12x5, seed 42, upwind3 advection,
isop_file hmix, file vmix) and its x go through both packages. For 2, 4
and 8 bands one spawn of that many ranks runs every case
(tests/test_torch_mesh.py::band_world): the sharded apply over all ranks
(a halo exchanged between ranks, 12 rows padded to 16 at 8 bands) and over
the first half of them (a mesh smaller than the world; one band at 2
ranks), the make_mesh refusals, and at 4 and 8 ranks a mesh with an "rhs"
axis. The gathered result must be the same on every rank and match
``apply`` and the JAX sharded apply on the wet cells at
tests/test_stencil.py's tolerance, rtol 1e-12 and atol 1e-13 of the
largest entry (the bands' dense vmix contractions run over other shapes
than the whole field's, and XLA fuses the shifted multiply-adds).
"""

import jax
import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu.grid import gen_ind_maps as ref_maps
from nk_ocn_tracer_jacobian_precond_tpu.grid import load_grid as ref_grid
from nk_ocn_tracer_jacobian_precond_tpu.ops import (
    AssemblyOptions as RefOptions, assemble_jacobian as ref_assemble)
from nk_ocn_tracer_jacobian_precond_tpu.ops.fieldsource import (
    FileFieldSource as RefSource)
from nk_ocn_tracer_jacobian_precond_tpu.parallel import (
    StencilOperator as RefOperator, make_mesh as ref_make_mesh)
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid import (gen_ind_maps,
                                                           load_grid)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (AssemblyOptions,
                                                          assemble_jacobian)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.fieldsource import (
    FileFieldSource)
from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import StencilOperator
from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import (
    make_circ_file, make_tracer_file)
from test_torch_mesh import BAD_MESHES, spawn_world, wet_field

IMT, JMT, KM = 16, 12, 5
OPTS = dict(adv_type="upwind3", hmix_type="isop_file", vmix_type="file")
WORLDS = (2, 4, 8)


def _assemble(circ, tracer, port: bool):
    opts_cls, grid_fn, maps_fn, src, asm_fn = (
        (AssemblyOptions, load_grid, gen_ind_maps, FileFieldSource,
         assemble_jacobian) if port else
        (RefOptions, ref_grid, ref_maps, RefSource, ref_assemble))
    grid = grid_fn(circ)
    return asm_fn(grid, opts_cls(circ_fname=circ, tracer_fname=tracer,
                                 **OPTS),
                  src(circ), src(tracer),
                  maps_fn(np.asarray(grid.KMT), grid.km))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The fixture through both packages, then one gloo world per band
    count: (port operator, x, wet mask, JAX operator, {world: per-rank
    results})."""
    d = tmp_path_factory.mktemp("torch_dist_stencil")
    circ, tracer = str(d / "circ.nc"), str(d / "tracer.nc")
    make_circ_file(circ, imt=IMT, jmt=JMT, km=KM, seed=42)
    make_tracer_file(tracer, IMT, JMT, KM, generic_tracer_names=("PO4",),
                     coupled_names=(("OCMIP_BGC_PO4", "OCMIP_BGC_DOP"),
                                    ("OCMIP_BGC_DOP", "OCMIP_BGC_PO4")),
                     seed=42)
    asm = _assemble(circ, tracer, port=True)
    op = StencilOperator.from_assembly(asm, "cpu")
    x = wet_field(asm, op.nt)
    wet = np.arange(KM)[:, None, None] < np.asarray(asm.grid.KMT)[None]
    ref = RefOperator.from_assembly(_assemble(circ, tracer, port=False))
    worlds = {n: spawn_world(n, d, op, x) for n in WORLDS}
    return op, x, wet, ref, worlds


def _close(got, want, wet):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got)[:, wet], want[:, wet],
                               rtol=1e-12, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("nband", WORLDS)
def test_gathered_apply_matches_apply(run, nband):
    op, x, wet, _, worlds = run
    ranks = worlds[nband]
    y = ranks[0]["y"]
    assert y.shape == x.shape and y.dtype == torch.float64
    for r in ranks[1:]:
        assert torch.equal(r["y"], y)
    _close(y, op.apply(x), wet)


@pytest.mark.parametrize("nband", WORLDS)
def test_matches_jax_sharded_apply(run, nband):
    """The JAX sharded apply on the simulated mesh, for the same x."""
    _, x, wet, ref, worlds = run
    apply_fn, sharding, pad_field, unpad_field = ref.sharded_apply_factory(
        ref_make_mesh(nband, ("band",)))
    want = unpad_field(apply_fn(jax.device_put(pad_field(x.numpy()),
                                               sharding)))
    _close(worlds[nband][0]["y"], want, wet)


@pytest.mark.parametrize("nband", WORLDS)
def test_mesh_smaller_than_the_world(run, nband):
    """make_mesh(n / 2) in a world of n: the first half of the ranks hold
    coordinates and apply over their own group, the others are outside.
    At n = 2 that mesh is one band: ``apply`` bit for bit."""
    op, x, wet, _, worlds = run
    ranks = worlds[nband]
    half = nband // 2
    assert [r["half_coords"] for r in ranks] == (
        [(s,) for s in range(half)] + [None] * half)
    want = op.apply(x)
    for r in ranks[:half]:
        if half == 1:
            assert torch.equal(r["y_half"], want)
        _close(r["y_half"], want, wet)
    assert all("y_half" not in r for r in ranks[half:])


@pytest.mark.parametrize("nband", WORLDS)
def test_make_mesh_in_a_world(run, nband):
    """The default mesh spans the world; the three JAX refusals raise on
    every rank; an (n / 2, 2) mesh's "rhs" rows are pairs of ranks."""
    ranks = run[4][nband]
    for rank, r in enumerate(ranks):
        assert r["default_shape"] == (nband,)
        for (_, msg), err in zip(BAD_MESHES, r["errors"]):
            assert err is not None and msg.format(m=nband + 1,
                                                  n=nband) in err
        if nband >= 4:
            assert r["rhs_shape"] == (nband // 2, 2)
            assert r["rhs_axes"] == ("front", "rhs")
            assert r["rhs_coords"] == (rank // 2, rank % 2)
            assert r["rhs_sum"] == 4 * (rank // 2) + 1
