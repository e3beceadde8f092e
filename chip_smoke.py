#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the torch package's main paths, the ``solve`` workflow at float64
factors and at float32 factors (FGMRES-IR3 refinement, escalating to
float64 when it fails), through the entry points a user calls, and checks
its hand-written CUDA kernels on the way:

1. device: a CUDA card must be present (no CPU fallback);
2. build: compile the kernels from csrc/ with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the gx3 main path gives it and at tall panels (R = 4096,
   8192 and 13,824) that the panel kernel walks in column slabs (pivots, the
   composed permutation and values bit for bit, P A = L U for the panel),
   with kernel, plain and library times and the bound of each shape: the
   panel at f64 (K1) and f32 (K2), the assembly (K3) at both;
4. engine parity: the bench "tiny" problem factored through the kernels
   and through their plain versions (swapped in here), same perms and
   solutions, at f64 and at f32; at f32 also the fused f32 FGMRES path on
   the card (tiny's f32 factors refine by plain IR alone, so the refiner
   starts in its memoized Krylov phase);
5. main path at f64: POP's 3-degree grid (gx3, 100x116x25, seed 7, 154,386
   rows), the port's own gen_A, then drivers.solve.run_solve on cuda over
   four tracers; every residual <= 1e-10, land cells unchanged, every kernel launched on
   the rounds that use it; then the steady refactor and the 4-RHS solve
   timed, a synchronized stage breakdown of one steady refactor
   (drivers.profile.profile_refactor: the stage timer on the engine's
   round loop; it must call no seq_to_perm, and its stages plus the walk
   must add up to the wall within 1%) and torch.profiler's kernel count
   and device busy share of another (drivers.profile.device_busy);
6. main path at f32: the same through run_solve(..., precision="f32"): K2
   and K3-f32 on every f32 round, whether the refiner reached the contract
   on f32 factors or the facade escalated to f64 (then K1 and K3-f64 run
   on the refactor), the refiner's phases and cycles, times, peak memory;
   every residual <= 1e-10 either way. When it escalated, the f32 factors
   are then built alone to time their steady refactor, read their own
   peak memory and print the per-round profile of their refactor (K2);
7. gx3 out of core at f64, on the phase-5 problem: (f) three unrefined
   4-RHS solves on gx3 f32 factors, bit for bit alike (the border
   subtraction adds in waves of distinct destinations); (a) the CLI's
   --memplan; (b) the CLI twice with --factors FILE on fresh tracer copies,
   the first factoring and writing FILE, the second loading it with no K1
   or K3 launch; (c) a factor-only pass with stop_after at a mid-tree
   round into a fresh checkpoint directory, then a factor-only resume that
   launches K3 once per remaining round, with each pass's peak memory and
   each round's peak held against memplan.engine_round_peaks;
   (d) stream_solve from that directory on the four tracers; (e) an
   offloading engine on the directory against a resident one, factors
   equal. Every residual <= 1e-10;
8. the Newton-Krylov outer loop (drivers.nk_loop.run_nk_loop) on the card
   at gx3deep (100x116x60, POP's 3-degree grid at its 60 levels), f64, 4
   RHS, 3 iterations of new values on the device, refactor and solve:
   every residual <= 1e-10, K1 and K3 launched on every refactor as the
   plans say, each refactor split into host passes and engine time, the
   one-time costs, peak memory and each round's peak of a steady refactor
   against memplan.engine_round_peaks; the value update on the card bit
   for bit with the host's (also at tiny size with a W > 1 fold), the
   stencil operator's matvec against the CSR product, the refiner's
   product kernel (csr_matvec) at 1 and 4 RHS bit for bit against its
   plain version and scipy's CSR product, timed beside its bound, the
   plain version, torch.sparse.mm and scipy, its launches on the loop's
   4-RHS solves and on one 1-RHS solve against the refiner's count of
   device residuals, K1's and K3's
   ms per gx3deep refactor beside their bounds (every panel shape and
   every round's fronts bit for bit against the plain versions), and the
   per-round profile of a synchronized steady refactor;
9. the factor-and-solve bench (drivers.bench.main, bench.py's main path)
   at gx3, f64, on the card, with its cache in this run's temporary
   directory, so scipy's SuperLU baseline is measured on this host: every
   residual <= 1e-10 (the port's and the baseline's), K1 and K3-f64
   launched as the plans say on the cold factor and the refactor, the
   bench's JSON line and the phase's seconds; then K1 and K3-f64 at this
   path's own (leaf 16) shapes bit for bit against their plain versions,
   with their ms per bench factor beside the plain, library and bound ms;
10. an NCCL process group of one rank (parallel.mesh.init_process_group)
   and make_mesh(1): the one-band sharded stencil apply on phase 8's
   gx3deep assembly bit for bit with the single-device apply. The machine
   has one card, so no halo crosses ranks here (the multi-rank exchange
   is tested on gloo on the CPU);
11. the mesh engine: (a) the facade with mesh=make_mesh(1, ("front",)) in
   an NCCL group of one at gx3deep (leaf 16, f64, 4 RHS), every round
   through K1 (the tree-top rounds of at most two fronts too, which the
   single-device engine gives the library LU; no library LU call) and
   K3, residuals and solutions against the single-device facade's,
   steady factor and solve beside the single-device ones, a synchronized
   breakdown of each, the peak against plan_memory(plans, 1, 8), K1 bit
   for bit and timed at the tree-top shapes and K3 on every round of the
   mesh engine's plan; (b) a gloo world
   of 2 ranks that share the card, gx3 at leaf 32 (batch-sharded rounds
   and the root row-sharded with the masked substitution): each rank's
   launches as the plan gives, its resident factor bytes equal to the
   plan's, the same bits on both ranks, solutions against the mesh of
   one; (c) a gloo world of 4 ranks as a 2 x rhs 2 mesh at tiny, the rhs
   split against the mesh of one; (d) the dry run's main on a gloo world
   of 2 on the card (its sharded stencil on the card too, the halos going
   through the host). (b)-(d) go through the host: their times are not a
   distribution speed;
12. the reference's own assembly configurations, through the port's gen_a
   CLI on options files in the reference's format: (a) upwind3 advection
   (its stage-1 test's options; the circulation's upwind3 transports
   derived from its own velocities, testdata.transports) at gx3deep,
   drivers.solve.run_solve over four tracers at f64, leaf 32: every
   residual <= 1e-10 in long double, land cells unchanged, launches as
   the plans say, cold and steady factor with a synchronized stage
   breakdown of one steady refactor, the 4-RHS solve, the refiner's
   phases, peak memory against plan_memory, K1 and K3 bit for bit and
   timed at its shapes, the per-round profile; (b) the same at f32: the
   float64 substitution (_hi_round) on exactly the rounds with P >=
   HI_ROUND_MIN_P in every f32 sweep, the refiner's tier (plain IR, fused
   f32 FGMRES, or the escalation to f64), K2 and K3-f32 bit for bit and
   timed; (c) the same matrix on the mesh engine in an NCCL world of one:
   K1 on every round, the tree-top panels (taller than 4096 rows, in
   column slabs) bit for bit with the plain version, the tallest panel's
   launch config, solutions within 1e-9 of (a)'s largest entry; (d) the
   coupled PO4-DOP pair at gx3 (d_J_A_d_B from the tracer file),
   run_solve -v OCMIP_BGC_PO4,OCMIP_BGC_DOP at f64: each tracer's own
   rows of the residual <= 1e-10, land cells bit for bit, both tracers
   written, the steady refactor and its stage breakdown;
   (e) the NK loop at gx3deep at f32, 3 iterations: each refactor's
   launches at its factor dtype, which iteration escalated, every
   residual <= 1e-10, K2 and K3-f32 at the loop's shapes;
13. scripts/torch_gx1_dist_run.py (the distributed gx1 runner) on phase
   5's gx3 matrix as an NCCL world of one with --ckpt, run twice: the
   first computes and saves every round, the second loads every round,
   computes none and gives the same solutions bit for bit; every residual
   <= 1e-10; before the first run, what chip_smoke has written so far
   (/proc/self/io's wchar) and this phase's planned writes stay under
   WRITE_CAP_GB; the checkpoint directory is deleted.

Prints one line per phase, the card's name and power limit, one JSON line
of kernel results (K1 and K3-f64 twice: the gx3 main path, and the mesh
path of phase 11a; then a row per kernel and path of phase 12, with a
"path" key), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises: the script then exits non-zero without that line.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PKG = "nk_ocn_tracer_jacobian_precond_tpu_torch"
PANEL_SOURCE = f"{PKG}/csrc/pivoted_panel.cu"
ASM_SOURCE = f"{PKG}/csrc/ell_assemble.cu"
MATVEC_SOURCE = f"{PKG}/csrc/csr_matvec.cu"
# def lines of pallas_pivoted_panel_df64 (K1), pallas_pivoted_panel (K2)
# and pallas_ell_assemble (K3)
PALLAS = "nk_ocn_tracer_jacobian_precond_tpu/solver/pallas_kernels.py"
PANEL_REPLACES = {"f64": f"{PALLAS}:307", "f32": f"{PALLAS}:103"}
ASM_REPLACES = f"{PALLAS}:384"
DTYPES = {"f64": "float64", "f32": "float32"}
KID = {"f64": "K1", "f32": "K2"}
# P A = L U bound on O(1) random panels: f64 rounding, and the f32
# envelope of tests/test_pallas_kernels.py (float32 elimination error
# grows with element growth; far below any pivoting mistake)
LU_BOUND = {"f64": 1e-12, "f32": 2e-3}
GX3 = dict(imt=100, jmt=116, km=25)
TINY = dict(imt=24, jmt=20, km=8)
# POP's 3-degree grid at its real 60 levels, the NK loop's grid (phase 8)
GX3DEEP = dict(imt=100, jmt=116, km=60)
NK_ITERATIONS = 3
# the bench size of phase 9 (the scipy baseline is measured there)
BENCH_SIZE = "gx3"
# an option set whose value-update fold has W > 1 columns (the vmix dense
# block sums duplicates)
UPDATE_W2 = dict(adv_type="upwind3", hmix_type="isop_file",
                 vmix_type="matrix_file")
TRACERS = ("IAGE_CUR", "PO4_CUR", "DOP_CUR", "O2_CUR")
# the reference's own assembly configurations (phase 12): options files in
# the reference's format (drivers/config.py) for its stage-1 test's upwind3
# advection, and for the coupled PO4-DOP pair with its cross-tracer
# derivatives read from the tracer file
UPWIND3_OPTS = ("adv_type upwind3\nhmix_type isop_file\nvmix_type file\n"
                "sink_type const 1.21e-4\n")
COUPLED = ("OCMIP_BGC_PO4", "OCMIP_BGC_DOP")
COUPLED_OPTS = ("adv_type centered\nhmix_type isop_file\nvmix_type file\n"
                "tracer_fname {tracer}\ncoupled_tracer_cnt 2\n"
                "coupled_tracer_type OCMIP_BGC_PO4_DOP\n"
                "tracer_ind 0\nsink_type const 1.21e-4\n"
                "tracer_ind 1\nsink_type const 2.0e-4\n")
# panel shapes (B, R, T, off): tests/test_pallas_kernels.py's cases, gx3
# plan panels with B > 2, and tall panels that the kernel walks in column
# slabs (R = 4096, 8192, and 13,824: phase 12's widest front as one panel,
# 8-column slabs at f64)
PANEL_SHAPES = [(4, 256, 128, 128), (3, 128, 128, 0), (2, 512, 64, 0),
                (2, 128, 128, 0), (256, 512, 128, 0), (16, 640, 128, 0),
                (16, 128, 128, 512), (4, 128, 128, 640), (3, 4096, 128, 0),
                (4, 8192, 128, 0), (1, 13824, 128, 0)]


# panels taller than this were run on the card only as forced shapes
# (phase 3) before phase 12c's tree-top rounds
TALL_R = 4096


# the card's host ends a run that has written 45 GiB to its disk (deleted
# files count): the writes this script plans stay under 0.8 of it
WRITE_CAP_GB = 0.8 * 45 * 2**30 / 1e9
# published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): HBM
# bytes per second, and FLOP/s of FP64 and FP32 outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}


def say(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn, device, reps: int) -> float:
    """Median wall time of fn() in ms, synchronized, after one warm-up."""
    fn()
    sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms from CUDA events around ``reps``
    back-to-back calls, after one warm-up (wrapper work included)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, sfx: str):
    """(ms, "bytes" or "operations"): the least time the card could take
    for nbytes of traffic and flops of arithmetic at the dtype's peak."""
    t_b = nbytes / HBM_BPS * 1e3
    t_o = flops / PEAK_FLOPS[sfx] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def panel_bound(B: int, R: int, T: int, sfx: str):
    """The panel's bound: the panel read once and written once, piv, perm
    and p_arr; B fronts of sum_k (R-k-1) divisions and (R-k-1)(T-k-1)
    FMAs (two operations each)."""
    item = 8 if sfx == "f64" else 4
    nbytes = 2 * B * R * T * item + B * T * 4 + B * R * 8 + B * 4
    flops = B * sum((R - k - 1) * (1 + 2 * (T - k - 1)) for k in range(T))
    return bound(nbytes, flops, sfx)


def make_problem(d: Path, dims: dict, tracers=()):
    """The bench.py problem (seed 7, centered advection, isop_file hmix,
    file vmix, const sink 1.21e-4): circulation file, optional tracer file,
    gen_A matrix file."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.gen_a import run_gen_a
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (AssemblyOptions,
                                                         PerTracerOptions)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import (
        make_circ_file, make_tracer_file)
    circ, mat = str(d / "circ.nc"), str(d / "matrix.nc")
    make_circ_file(circ, seed=7, **dims)
    tracer = None
    if tracers:
        tracer = str(d / "tracer.nc")
        make_tracer_file(tracer, dims["imt"], dims["jmt"], dims["km"],
                         tracer_names=tracers, seed=7)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ, adv_type="centered",
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt]))
    return mat, tracer


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def panel_backward_error(A, Pp, piv) -> float:
    """max |P A - L U| of a factored (B, R, T) panel, in float64."""
    import torch
    B, R, T = A.shape
    A = A.double()
    Pp = Pp.double()
    bidx = torch.arange(B, device=A.device)
    piv = piv.long()
    for k in range(T):
        s = piv[:, k]
        rk = A[:, k].clone()
        A[:, k] = A[bidx, s]
        A[bidx, s] = rk
    eye = torch.eye(T, dtype=A.dtype, device=A.device)
    L = torch.cat([torch.tril(Pp[:, :T], -1) + eye, Pp[:, T:]], dim=1)
    U = torch.triu(Pp[:, :T])
    return float((L @ U - A).abs().max())


def once_ms(fn) -> float:
    """The device time of one call of fn() in ms, from CUDA events around
    it."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def check_panel(ck, device, sfx, B, R, T, off, p_arr, tau, seed):
    """Kernel vs plain on one random panel, required bit for bit (values,
    piv and perm): returns (max abs difference, the input panel, the
    plain version's ms on it: a launch-bound loop of T steps, timed once
    here rather than run again)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    Pan = torch.randn((B, R, T), generator=g,
                      dtype=getattr(torch, DTYPES[sfx]), device=device)
    Pk, pk, permk = ck.pivoted_panel(Pan, off, p_arr, tau)
    plain = []
    t_plain = once_ms(lambda: plain.extend(ck.pivoted_panel_plain(
        Pan, off, p_arr, tau)))
    Pp, pp, permp = plain
    name = KID[sfx]
    if not torch.equal(pk, pp):
        raise AssertionError(f"{name} {B, R, T, off} tau={tau}: pivots "
                             f"differ from the plain version")
    if permk.dtype != torch.int64 or not torch.equal(permk, permp):
        raise AssertionError(f"{name} {B, R, T, off} tau={tau}: perm "
                             f"differs from the plain version")
    if not torch.equal(Pk, Pp):
        raise AssertionError(f"{name} {B, R, T, off} tau={tau}: values "
                             f"differ from the plain version by "
                             f"{float((Pk - Pp).abs().max()):.3e}")
    return float((Pk - Pp).abs().max()), Pan, t_plain


def panel_shapes(plans) -> dict:
    """{(B, R, T, off): [count, p_arr]} of every 128-column panel that one
    factor over ``plans`` gives the panel kernel (rounds with B > 2)."""
    shapes: dict = {}
    for p in plans:
        if p.B <= 2:
            continue
        for off in range(0, p.P, 128):
            key = (p.B, p.P - off, min(128, p.P - off), off)
            shapes.setdefault(key, [0, p.p_arr])[0] += 1
    return shapes


def library_panel(Pan):
    """torch.linalg.lu_factor_ex on the same (B, R, T) batch: with every
    row eligible and tau = 0 the same elimination (yardstick only)."""
    import torch
    return torch.linalg.lu_factor_ex(Pan)


def phase_panel(ck, device, plans, sfx: str) -> dict:
    """K1 (f64) or K2 (f32) against the plain version: the PANEL_SHAPES,
    then every panel of one gx3 factor, with kernel, plain and library
    times and the bound, summed over the factor."""
    import torch
    name = KID[sfx]
    err = 0.0
    for i, (B, R, T, off) in enumerate(PANEL_SHAPES):
        mixed = torch.tensor(np.linspace(0, off + R, B).astype(np.int32),
                             device=device)
        for tau in (0.0, 0.05):
            e, _, _ = check_panel(ck, device, sfx, B, R, T, off, mixed,
                                  tau, i)
            err = max(err, e)
        full = torch.full((B,), off + R, dtype=torch.int32, device=device)
        _, Pan, _ = check_panel(ck, device, sfx, B, R, T, off, full, 0.0,
                                100 + i)
        Pk, pk, _ = ck.pivoted_panel(Pan, off, full, 0.0)
        bwd = panel_backward_error(Pan, Pk, pk)
        if not bwd <= LU_BOUND[sfx]:
            raise AssertionError(f"{name} {B, R, T, off}: P A - L U = "
                                 f"{bwd:.3e} > {LU_BOUND[sfx]:.0e}")
        C, nb = ck.panel_launch_config(B, R, T, Pan.element_size(),
                                       ck.active_clusters)
        say(f"phase 3 {name} {(B, R, T, off)} cluster {C} slab {nb}: piv, "
            f"perm and values bitwise equal, P A = L U to {bwd:.2e}")
    # one gx3 factor's worth of panels: every panel of every round with
    # B > 2, on random data with the round's own p_arr
    shapes = panel_shapes(plans)
    tot = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0)
    bound_by = set()
    for i, ((B, R, T, off), (count, pa)) in enumerate(sorted(shapes.items())):
        p_arr = torch.from_numpy(pa).to(device)
        e, Pan, _ = check_panel(ck, device, sfx, B, R, T, off, p_arr,
                                0.05, 200 + i)
        err = max(err, e)
        t_k = event_ms(lambda: ck.pivoted_panel(Pan, off, p_arr, 0.05), 20)
        t_w = median_ms(lambda: ck.pivoted_panel(Pan, off, p_arr, 0.05),
                        device, 10)
        t_p = event_ms(lambda: ck.pivoted_panel_plain(Pan, off, p_arr,
                                                      0.05), 2)
        t_l = event_ms(lambda: library_panel(Pan), 10)
        b_ms, b_by = panel_bound(B, R, T, sfx)
        bound_by.add(b_by)
        for k, v in (("ms", t_k), ("wall_ms", t_w), ("plain_ms", t_p),
                     ("library_ms", t_l), ("bound_ms", b_ms)):
            tot[k] += count * v
        C, nb = ck.panel_launch_config(B, R, T, Pan.element_size(),
                                       ck.active_clusters)
        say(f"phase 3 {name} gx3 panel {(B, R, T, off)} x{count} cluster "
            f"{C}: kernel {t_k:.4f} ms (wall {t_w:.4f}), plain {t_p:.3f} "
            f"ms, lu_factor_ex {t_l:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), bitwise equal")
    say(f"phase 3 {name} per gx3 factor "
        f"({sum(c for c, _ in shapes.values())} panels): kernel "
        f"{tot['ms']:.3f} ms (wall {tot['wall_ms']:.3f}), plain "
        f"{tot['plain_ms']:.3f} ms, lu_factor_ex {tot['library_ms']:.3f} "
        f"ms, bound {tot['bound_ms']:.4f} ms")
    del tot["wall_ms"]
    return dict(max_abs_err=err, bound_by="/".join(sorted(bound_by)), **tot)


def library_assemble(nzd, a_col, a_csrc, B: int, N: int):
    """One index_put_ of the same ELL entries into zeroed fronts (the ELL
    part of K3's function; yardstick only)."""
    import torch
    R, W = a_col.shape[1:]
    F = torch.zeros((B, N, N), dtype=nzd.dtype, device=nzd.device)
    bi = torch.arange(B, device=nzd.device)[:, None, None].expand(B, R, W)
    ri = torch.arange(R, device=nzd.device)[None, :, None].expand(B, R, W)
    return F.index_put_((bi, ri, a_col), nzd[a_csrc], accumulate=True)


def assemble_bound(p, nnz: int, sfx: str):
    """K3's bound: the fronts written once, the ELL and spill maps and
    the CSR values read once; no arithmetic to speak of."""
    item = 8 if sfx == "f64" else 4
    E = p.a_pos.shape[1]
    nbytes = (p.B * p.N * p.N * item + 2 * p.B * p.N * p.a_col.shape[2] * 8
              + 2 * p.B * E * 8 + p.B * 4 + (nnz + 1) * item)
    return bound(nbytes, 0.0, sfx)


def phase_assemble(ck, device, plans, nzval, sfx: str) -> dict:
    import torch
    nz = np.zeros(len(nzval) + 1)
    nz[:-1] = nzval
    dtype = getattr(torch, DTYPES[sfx])
    nzd = torch.from_numpy(nz).to(device=device, dtype=dtype)
    err = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for rnd, p in enumerate(plans):
        args = [torch.from_numpy(a).to(device=device, dtype=torch.int64)
                for a in (p.a_col, p.a_csrc, p.a_pos, p.a_src)]
        p_arr = torch.from_numpy(p.p_arr).to(device)
        spill = bool((p.a_pos < p.N * p.N).any())
        Fk = ck.ell_assemble(nzd, *args, p_arr, p.N, p.P, spill)
        Fp = ck.ell_assemble_plain(nzd, *args, p_arr, p.N, p.P, spill)
        sync(device)
        if Fk.dtype != dtype or not torch.equal(Fk, Fp):
            raise AssertionError(f"K3 {sfx} round {rnd}: fronts differ "
                                 f"from the plain version")
        err = max(err, float((Fk - Fp).abs().max()))
        del Fk, Fp
        t_k = event_ms(lambda: ck.ell_assemble(nzd, *args, p_arr, p.N,
                                               p.P, spill), 10)
        t_p = event_ms(lambda: ck.ell_assemble_plain(nzd, *args, p_arr,
                                                     p.N, p.P, spill), 5)
        t_l = event_ms(lambda: library_assemble(nzd, args[0], args[1], p.B,
                                                p.N), 10)
        b_ms, _ = assemble_bound(p, len(nzval), sfx)
        for k, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                     ("bound_ms", b_ms)):
            tot[k] += v
        say(f"phase 3 K3 {sfx} gx3 round {rnd} (B, P, N, W, E) = "
            f"{(p.B, p.P, p.N, p.a_col.shape[2], p.a_pos.shape[1])}: "
            f"bitwise equal, kernel {t_k:.4f} ms, plain {t_p:.3f} ms, "
            f"index_put_ {t_l:.4f} ms, bound {b_ms:.4f} ms (bytes)")
    say(f"phase 3 K3 {sfx} per gx3 factor ({len(plans)} rounds): kernel "
        f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, index_put_ "
        f"{tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms")
    return dict(max_abs_err=err, bound_by="bytes", **tot)


# --------------------------------------------------------------------------
# phase 4: engine parity, kernels vs plain versions
# --------------------------------------------------------------------------

def phase_parity(ck, device, work: Path, precision: str) -> None:
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import load_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
        MultifrontalFactorization)
    d = work / f"tiny_{precision}"
    d.mkdir()
    mat, _ = make_problem(d, TINY)
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    B = np.random.default_rng(7).standard_normal((matrix.flat_len, 4))
    before = dict(ck.LAUNCHES)
    fk = MultifrontalFactorization(matrix, maps=maps, device=device,
                                   precision=precision)
    sfx = ck.SUFFIX[fk.engine.prec]
    for k in (f"pivoted_panel_{sfx}", f"ell_assemble_{sfx}"):
        if ck.LAUNCHES[k] == before[k]:
            raise AssertionError(f"engine parity {precision}: the kernel "
                                 f"run launched no {k}")
    real = (ck.pivoted_panel, ck.ell_assemble)
    ck.pivoted_panel, ck.ell_assemble = (ck.pivoted_panel_plain,
                                         ck.ell_assemble_plain)
    try:
        launched = dict(ck.LAUNCHES)
        fp = MultifrontalFactorization(matrix, maps=maps, sym=fk.sym,
                                       device=device, precision=precision)
        if ck.LAUNCHES != launched:
            raise AssertionError("engine parity: the plain run launched "
                                 "a kernel")
    finally:
        ck.pivoted_panel, ck.ell_assemble = real
    if fk.engine.prec != fp.engine.prec:
        raise AssertionError("engine parity: factor dtypes differ")
    bitwise = True
    for rnd, (a, b) in enumerate(zip(fk.engine.factors, fp.engine.factors)):
        if not np.array_equal(a[3].cpu().numpy(), b[3].cpu().numpy()):
            raise AssertionError(f"engine parity {precision}: round {rnd} "
                                 f"perms differ")
        bitwise &= all(bool(torch.equal(x, y)) for x, y in zip(a[:3], b[:3]))
    rel = lambda x, y: float(np.abs(x - y).max() / np.abs(y).max())
    raw = rel(fk.solve(B, refine=False), fp.solve(B, refine=False))
    Xk, Xp = fk.solve(B), fp.solve(B)
    ref = rel(Xk, Xp)
    res = float((np.linalg.norm(matrix.to_scipy() @ Xk - B, axis=0)
                 / np.linalg.norm(B, axis=0)).max())
    if not (ref <= 1e-12 and res <= 1e-10):
        raise AssertionError(f"engine parity {precision}: refined solutions "
                             f"differ by {ref:.3e} relative, residual "
                             f"{res:.3e}")
    say(f"phase 4 engine parity tiny {tuple(TINY.values())} {precision}: "
        f"{len(fk.engine.plans)} rounds, perms equal, factors bitwise "
        f"equal {bitwise}, unrefined solutions {raw:.2e}, refined "
        f"{ref:.2e} relative, residual {res:.2e}, refiner "
        f"{fk._refiner.stats}")
    if precision == "f32":
        phase_fused(fk, matrix, B, Xp)


def phase_fused(fac, matrix, B, X_ref) -> None:
    """The fused f32 FGMRES path on f32 factors on the card: the refiner
    starts in the memoized Krylov phase (where a factorization whose plain
    refinement stalled far from the target solves from), so the solve
    runs fused cycles with no host apply; it must keep the f32 factors,
    reach 1e-10 and agree with the plain-IR solution to 1e-10 relative."""
    import torch
    refiner = fac._refiner
    refiner._phase = "gmres"
    t0 = time.perf_counter()
    X = fac.solve(B)
    t = time.perf_counter() - t0
    s = refiner.stats
    res = float((np.linalg.norm(matrix.to_scipy() @ X - B, axis=0)
                 / np.linalg.norm(B, axis=0)).max())
    rel = float(np.abs(X - X_ref).max() / np.abs(X_ref).max())
    if (fac.engine.prec != torch.float32 or s["phases"][0] != "gmres"
            or s["host_applies"] or s["cycles"] < 2):
        raise AssertionError(f"fused f32 FGMRES: did not run as set: {s}")
    if not (res <= 1e-10 and rel <= 1e-10):
        raise AssertionError(f"fused f32 FGMRES: residual {res:.3e}, "
                             f"{rel:.3e} from the plain-IR solution")
    say(f"phase 4 fused f32 FGMRES tiny: {t:.3f} s, residual {res:.2e}, "
        f"{rel:.2e} from the plain-IR solution, refiner {s}")


# --------------------------------------------------------------------------
# phases 5 and 6: the main path at gx3, f64 and f32
# --------------------------------------------------------------------------

def check_tracers(mat: str, before: str, after: str, groups=None):
    """Residual of every tracer of ``after`` (solved from ``before``), in
    long double, land cells unchanged; returns ({tracer: residual}, A, B).
    ``groups`` lists the variable groups solved together (the coupled
    tracers of one system; by default each of TRACERS alone): B has a
    column per group, and each tracer's residual is that of its own rows,
    ||(A x - b)_t|| / ||b_t||."""
    from scipy.io import netcdf_file
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import load_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    if groups is None:
        groups = [(v,) for v in TRACERS]
    matrix = read_matrix_file(mat)
    maps = load_ind_maps(mat)
    A = matrix.to_scipy()
    A_ld = A.astype(np.longdouble)
    tsl = maps.tracer_state_len
    land = maps.int3_to_ind < 0
    res = {}
    Bm = np.empty((matrix.flat_len, len(groups)))
    with netcdf_file(before, "r", mmap=False) as f0, \
            netcdf_file(after, "r", mmap=False) as f1:
        for j, group in enumerate(groups):
            xs = []
            for t, v in enumerate(group):
                old = np.array(f0.variables[v].data, dtype=np.float64)
                new = np.array(f1.variables[v].data, dtype=np.float64)
                if not np.array_equal(old[land], new[land]):
                    raise AssertionError(f"{v}: land cells changed")
                b, x = maps.flatten_field(old), maps.flatten_field(new)
                if not np.all(np.isfinite(x)) or x.shape != b.shape:
                    raise AssertionError(f"{v}: bad solution")
                Bm[t * tsl:(t + 1) * tsl, j] = b
                xs.append(x)
            r = (A_ld @ np.concatenate(xs).astype(np.longdouble)
                 - Bm[:, j].astype(np.longdouble)).astype(np.float64)
            for t, v in enumerate(group):
                rows = slice(t * tsl, (t + 1) * tsl)
                res[v] = float(np.linalg.norm(r[rows])
                               / np.linalg.norm(Bm[rows, j]))
                if not res[v] <= 1e-10:
                    raise AssertionError(f"{v}: relative residual "
                                         f"{res[v]:.3e} > 1e-10")
    return res, A, Bm


def expect_launches(launches: dict, plans, sfxs) -> None:
    """Every kernel of the factor path at each of ``sfxs`` launched as
    the plans say (K3 once per round, K1/K2 once per panel of every round
    with B > 2), the others not at all."""
    want_asm = len(plans)
    want_panel = sum(math.ceil(p.P / 128) for p in plans if p.B > 2)
    for sfx in DTYPES:
        on = sfx in sfxs
        for k, want in ((f"ell_assemble_{sfx}", want_asm),
                        (f"pivoted_panel_{sfx}", want_panel)):
            if launches[k] != (want if on else 0):
                raise AssertionError(f"{k} launched {launches[k]} times, "
                                     f"want {want if on else 0}")


def factor_launches(launches: dict) -> dict:
    """The launches of the factor path's kernels: the refiner's product
    kernel runs in the solves (counting_solves checks it)."""
    return {k: v for k, v in launches.items() if k != "csr_matvec_f64"}


class counting_solves:
    """For the block, every DeviceRefiner.solve's stats, and the product
    kernel's launches against the refiner's device residuals: ``check()``
    raises unless each residual launched the kernel once and nothing else
    did (a float64 Krylov cycle launches it for its products, so a solve
    that took one fails the check). Returns the launches."""

    def __init__(self, ck):
        self.ck, self.stats = ck, []

    def __enter__(self):
        from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.refine import (
            DeviceRefiner)
        self._cls, self._real = DeviceRefiner, DeviceRefiner.solve
        self._before = self.ck.LAUNCHES["csr_matvec_f64"]
        real, stats = self._real, self.stats

        def solve(ref, B):
            X = real(ref, B)
            stats.append(dict(ref.stats, nrhs=1 if np.ndim(B) == 1
                              else np.shape(B)[1]))
            return X
        DeviceRefiner.solve = solve
        return self

    def __exit__(self, *exc):
        self._cls.solve = self._real
        self.launches = self.ck.LAUNCHES["csr_matvec_f64"] - self._before

    def check(self, what: str) -> int:
        res = sum(st["device_residuals"] for st in self.stats)
        phases = {p for st in self.stats for p in st["phases"]}
        if not self.stats or res < 1 or self.launches != res \
                or "gmres64" in phases:
            raise AssertionError(
                f"{what}: csr_matvec launched {self.launches} times over "
                f"{len(self.stats)} refined solves with {res} device "
                f"residuals (phases {sorted(phases)})")
        return self.launches


def max_rel(A, X, B) -> float:
    """The largest relative residual over the columns, with A X - B in
    long double (float64's own rounding of the product reaches 4.8e-10
    for one gx3deep right-hand side, drivers.nk_loop.residual)."""
    ld = np.longdouble
    r = (A.astype(ld) @ X.astype(ld) - B.astype(ld)).astype(np.float64)
    return float((np.linalg.norm(r, axis=0)
                  / np.linalg.norm(B, axis=0)).max())


def steady(fac, A, Bm) -> dict:
    """The steady refactor and one 4-RHS refined solve, timed."""
    t0 = time.perf_counter()
    fac.refactor()              # synchronizes at its end
    t_steady = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = fac.solve(Bm)           # ends in a copy to the host
    t_solve = time.perf_counter() - t0
    rel = max_rel(A, X, Bm)
    if not rel <= 1e-10:
        raise AssertionError(f"steady solve residual {rel:.3e}")
    # one solve's wall time varies by tens of ms between calls: the
    # median of this and four more
    times = [t_solve]
    for _ in range(4):
        t0 = time.perf_counter()
        fac.solve(Bm)
        times.append(time.perf_counter() - t0)
    return dict(steady_factor_s=t_steady, solve_4rhs_s=t_solve,
                solve_4rhs_median_s=float(np.median(times)),
                steady_max_residual=rel,
                steady_refiner=dict(fac._refiner.stats))


def stage_breakdown(fac, device) -> dict:
    """drivers.profile.profile_refactor over the facade (a warm refactor,
    then a steady one under the stage timer, a synchronize around each
    stage of the engine's round loop) in the keys the phases print:
    exclusive ms per stage (a stage's time less that of the stages it
    calls), the walk outside the stages, the synchronized wall and the
    calls; beside them the split of the rest of partial_factor, the
    per-round profile, and the calls of seq_to_perm made in it (none on
    the card: the panel kernel composes the permutation). The stages plus
    the walk must add up to the wall within 1%."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import profile
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (
        cuda_kernels as ck)
    seq = []
    real = ck.seq_to_perm
    ck.seq_to_perm = lambda *a, **kw: seq.append(1) or real(*a, **kw)
    try:
        prof = profile.profile_refactor(fac, device)
    finally:
        ck.seq_to_perm = real
    # (on the CPU the plain panel composes it through seq_to_perm)
    if device.type == "cuda" and seq:
        raise AssertionError(f"the steady refactor called seq_to_perm "
                             f"{len(seq)} times")
    tot, calls, wall = prof["totals"], prof["calls"], prof["wall_ms"]
    if abs(sum(tot.values()) + prof["walk_ms"] - wall) > 0.01 * wall:
        raise AssertionError(f"stages {sum(tot.values()):.3f} ms and walk "
                             f"{prof['walk_ms']:.3f} ms against the wall "
                             f"{wall:.3f} ms")
    sfx = ck.SUFFIX[fac.engine.prec]
    keys = {f"K3 ell_assemble_{sfx}": ("assemble",),
            f"{KID[sfx]} pivoted_panel_{sfx}": ("panel",),
            "extend_add": ("extend_add",), "pack_diag_inv": ("pack",),
            "tree-top library LU (B <= 2)": ("treetop_lu",),
            "partial_factor rest (row gather, TRSM, GEMM)": (
                "partial_factor", "row_gather", "trsm", "gemm"),
            "checkpoint save": ("ckpt_save",),
            "checkpoint load": ("ckpt_load",)}
    stages = {name: round(sum(tot[k] for k in ks), 3)
              for name, ks in keys.items() if calls[ks[0]]}
    stages = dict(sorted(stages.items(), key=lambda kv: -kv[1]))
    stages["engine walk outside the stages"] = round(prof["walk_ms"], 3)
    stage_calls = {name: calls[ks[0]] for name, ks in keys.items()
                   if calls[ks[0]]}
    if seq:
        stage_calls["seq_to_perm"] = len(seq)
    return dict(
        synced_refactor_ms=round(wall, 3), stages_ms=stages,
        stage_calls=stage_calls,
        partial_factor_rest_split_ms={
            "row gather": round(tot["row_gather"], 3),
            "TRSM": round(tot["trsm"], 3),
            "trailing GEMM": round(tot["gemm"], 3),
            "other (panel input copy, permutation, copies out)":
                round(tot["partial_factor"], 3)},
        rows_share_of_wall=prof["rows_ms"] / wall, profile=prof)


def print_rounds(phase: str, what: str, breakdown: dict, card: str) -> None:
    """The per-round table of a stage breakdown's profile, and
    profile_factor.py's ranked costs."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import profile
    prof = breakdown["profile"]
    say(f"phase {phase} {what}, per-round profile of one synchronized "
        f"steady refactor (exclusive ms; rows {prof['rows_ms']:.1f} of the "
        f"wall {prof['wall_ms']:.1f} ms) [{card}]:\n"
        + profile.round_table(prof) + "\n"
        + profile.cost_table(profile.ranked_costs(prof["rows"])))


def reference_solve(ck, device, mat: str, tracer: str, vars_arg: str,
                    precision: str, groups=None) -> dict:
    """drivers.solve.run_solve of ``vars_arg`` at ``precision`` on a copy
    of ``tracer``, the counts set to 0 just before it and read just
    after; the written file checked (check_tracers) and the launches held
    against the plans. Returns what it saw, the facade included."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.solve import (
        run_solve)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.memplan import (
        plan_memory)
    out_file = f"{tracer}.{precision}.nc"
    shutil.copy(tracer, out_file)
    reset_counts(ck, device)
    t0 = time.perf_counter()
    out = run_solve(mat, out_file, vars_arg, device=device,
                    precision=precision)
    t_run = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    fac = out["factorization"]
    plans = fac.engine.plans
    escalated = fac.escalation is not None
    expect_launches(launches, plans, ("f32", "f64") if escalated
                    else (precision,))
    fac.validate()
    res, A, Bm = check_tracers(mat, tracer, out_file, groups)
    t = fac.timings
    return dict(
        fac=fac, A=A, Bm=Bm, out_file=out_file, launches=launches,
        flat_len=A.shape[0], nnz=A.nnz, rounds=[(p.B, p.P, p.N)
                                                for p in plans],
        max_W=max(p.a_col.shape[2] for p in plans),
        run_solve_s=t_run, symbolic_s=t["symbolic"],
        cold_factor_s=t["equilibrate"] + t["plan"] + t["factor"],
        escalated=escalated, escalation=fac.escalation,
        escalate_s=t.get("escalate"), refiner=dict(fac._refiner.stats),
        residuals=res, peak_mem_gb=peak / 1e9,
        plan_peak_gb=plan_memory(plans, 1, 8 if precision == "f64"
                                 or escalated else 4).peak_per_device / 1e9)


def brief(stats: dict) -> dict:
    """``stats`` without the objects reference_solve hands back."""
    return {k: v for k, v in stats.items()
            if k not in ("fac", "A", "Bm", "out_file")}


def phase_main(ck, device, mat: str, tracer: str, precision: str,
               phase: int, card: str) -> dict:
    """drivers.solve.run_solve over the four tracers at ``precision``,
    from a copy of the original tracer file (``reference_solve``), then
    the steady refactor and solve; returns the launch counts of the run
    and the phase's numbers."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import profile
    st = reference_solve(ck, device, mat, tracer, ",".join(TRACERS),
                         precision)
    fac = st["fac"]
    stats = dict(precision=precision, factor_dtype=str(fac.engine.prec),
                 **brief(st))
    stats.update(steady(fac, st["A"], st["Bm"]))
    if precision == "f64":
        stats["breakdown"] = stage_breakdown(fac, device)
        try:
            stats["profile"] = profile.device_busy(fac, device)
        except Exception as e:  # noqa: BLE001 - a measurement, not a check
            stats["profile"] = f"not measured ({type(e).__name__}: {e})"
    stats["peak_mem_after_refactor_gb"] = torch.cuda.max_memory_allocated(
        device) / 1e9
    if precision == "f32" and st["escalated"]:
        stats.update(f32_alone(fac, device))
        print_rounds(str(phase), "gx3 f32 factors alone (K2)",
                     stats["f32_alone_breakdown"], card)
    say(f"phase {phase} main path gx3 {precision}: " + json.dumps(stats))
    return st["launches"], stats


def f32_alone(fac, device) -> dict:
    """The gx3 f32 factors never reach a refactor on the main path (it
    escalates): drop the facade's f64 engine, build the f32 factors
    alone, time their steady refactor and read their own peak; then the
    stage breakdown of their refactor (the K2 path), through the facade
    with the f32 engine in place."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf_torch import (
        TorchMultifrontal)
    fac.engine = fac._refiner = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    eng = TorchMultifrontal(fac.sym, fac._fac_matrix, device,
                            prec=torch.float32)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.refactor(fac._fac_matrix)           # synchronizes at its end
    t_steady = time.perf_counter() - t0
    if not all(bool(torch.isfinite(t).all()) for f in eng.factors
               for t in f[:3]):
        raise AssertionError("f32 factors alone: non-finite entries")
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    fac.engine = eng
    return dict(f32_alone_cold_factor_s=cold,
                f32_alone_steady_factor_s=t_steady,
                f32_alone_peak_mem_gb=peak,
                f32_alone_breakdown=stage_breakdown(fac, device))


# --------------------------------------------------------------------------
# phase 7: gx3 out of core at f64
# --------------------------------------------------------------------------

def run_cli(argv) -> tuple:
    """drivers.solve.main(argv) with its output captured: (rc, stdout,
    stderr, seconds). Raises on a non-zero exit."""
    import contextlib
    import io
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import solve
    from nk_ocn_tracer_jacobian_precond_tpu_torch.utils import set_dbg_lvl
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = solve.main(argv)
    finally:
        set_dbg_lvl(0)      # -D sets the process's level; keep it quiet
    t = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"solve {' '.join(argv)}: rc {rc}\n"
                             f"{err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), t


def timed_line(log: str, name: str) -> float:
    """The seconds of utils.timed's "(0) name: X s" line in ``log``."""
    for line in log.splitlines():
        if line.startswith(f"(0) {name}: ") and line.endswith("s"):
            return float(line.rsplit(" ", 1)[1][:-1])
    raise AssertionError(f"no '{name}' timing in the log")


def solutions(mat: str, tracer_file: str, names=TRACERS) -> np.ndarray:
    """The tracers ``names`` of a tracer file, flattened, as columns."""
    from scipy.io import netcdf_file
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import load_ind_maps
    maps = load_ind_maps(mat)
    with netcdf_file(tracer_file, "r", mmap=False) as f:
        return np.stack([maps.flatten_field(np.array(
            f.variables[v].data, dtype=np.float64)) for v in names], 1)


def reset_counts(ck, device) -> None:
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    for k in ck.LAUNCHES:
        ck.LAUNCHES[k] = 0


def phase_oocore(ck, device, work: Path, mat: str, tracer: str, sym,
                 plans, resident_peak_gb: float) -> dict:
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import load_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import stream_solve
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.checkpoint import (
        FactorRoundCheckpointer)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.memplan import (
        checkpoint_disk_plan, engine_round_peaks)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import equilibrate
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf_torch import (
        TorchMultifrontal, pack_block_size)
    d = work / "oocore"
    d.mkdir()
    gb = 1e9
    disk = shutil.disk_usage(d)
    stats = dict(disk_free_gb=disk.free / gb,
                 resident_at_start_gb=torch.cuda.memory_allocated(device) / gb)
    matrix = read_matrix_file(mat)
    fac_matrix, _, _ = equilibrate(matrix)
    Bm = solutions(mat, tracer)
    n = len(plans)
    asm, pan = "ell_assemble_f64", "pivoted_panel_f64"

    # (f) the border repair on the card: f32 factors, unrefined solves
    eng = TorchMultifrontal(sym, fac_matrix, device, prec=torch.float32)
    stats["border_waves_per_round"] = [len(c["border"][2])
                                       for c in eng._consts]
    xs = [eng.solve(Bm) for _ in range(3)]
    if not all(np.array_equal(xs[0], x) for x in xs[1:]):
        spread = max(float(np.abs(x - xs[0]).max()) for x in xs[1:])
        raise AssertionError(f"f32 unrefined solves differ by {spread:.3e}")
    t0 = time.perf_counter()
    eng.solve(Bm)
    stats["f32_unrefined_4rhs_solve_s"] = time.perf_counter() - t0
    del eng, xs
    say(f"phase 7f border repair: 3 unrefined f32 4-RHS solves bitwise "
        f"equal; waves per round {stats['border_waves_per_round']}")

    # (a) --memplan
    out, _, t = run_cli(["--memplan", "-n", "1", "--prec", "f64", mat])
    if "float64 factors" not in out:
        raise AssertionError(f"--memplan printed {out!r}")
    stats["memplan_s"] = t
    say("phase 7a --memplan -n 1 --prec f64:\n  "
        + "\n  ".join(out.strip().splitlines()))

    # (b) --factors, twice on fresh tracer copies
    f = d / "factors.npz"
    X = []
    for run in ("save", "load"):
        out_file = str(d / f"tracer_{run}.nc")
        shutil.copy(tracer, out_file)
        reset_counts(ck, device)
        out, err, t = run_cli(["-D", "1", "--device", "cuda", "--prec", "f64",
                               "--factors", str(f), "-v", ",".join(TRACERS),
                               mat, out_file])
        launches = dict(ck.LAUNCHES)
        if run == "save":
            expect_launches(launches, plans, ("f64",))
            if f"numeric factors saved to {f}" not in out:
                raise AssertionError("--factors: the first run saved nothing")
        elif (launches[asm] or launches[pan]
              or f"numeric factors loaded from {f}" not in out):
            raise AssertionError(f"--factors: the second run factored "
                                 f"({launches}) or did not load")
        res, _, _ = check_tracers(mat, tracer, out_file)
        X.append(solutions(mat, out_file))
        stats[f"factors_{run}"] = dict(
            run_s=t, factor_phase_s=timed_line(err, "factor"),
            solve_phase_s=timed_line(err, "solve"),
            max_residual=max(res.values()),
            peak_mem_gb=torch.cuda.max_memory_allocated(device) / gb)
    stats["factors_file_gb"] = f.stat().st_size / gb
    factors_file = f.stat().st_size
    rel = float(np.abs(X[1] - X[0]).max() / np.abs(X[0]).max())
    if not rel <= 1e-12:
        raise AssertionError(f"--factors: the loaded run's solutions differ "
                             f"by {rel:.3e} relative")
    stats["factors_runs_rel_diff"] = rel
    f.unlink()
    say(f"phase 7b --factors: cold factor phase "
        f"{stats['factors_save']['factor_phase_s']:.2f} s, loaded "
        f"{stats['factors_load']['factor_phase_s']:.2f} s, file "
        f"{stats['factors_file_gb']:.2f} GB, solutions {rel:.2e} apart")

    # (c) factor-only with a handoff at a mid-tree round, then a resume;
    # each round's peak (since the previous round's save) is held against
    # the engine's memory plan
    ck_dir = str(d / "rounds")
    k = n // 2 - 1
    passes = {}
    plan_peaks = engine_round_peaks(plans, 8, fac_matrix.nnz,
                                    pack_block_size(plans))
    round_peaks = {}
    real_save = FactorRoundCheckpointer.save_round

    def peak_save(self, rnd, *a, **kw):
        round_peaks[rnd] = torch.cuda.max_memory_allocated(device) - base
        torch.cuda.reset_peak_memory_stats(device)
        real_save(self, rnd, *a, **kw)
    for name, kw in (("stop_after", dict(stop_after=k)), ("resume", {})):
        reset_counts(ck, device)
        base = torch.cuda.memory_allocated(device)
        FactorRoundCheckpointer.save_round = peak_save
        t0 = time.perf_counter()
        try:
            eng = TorchMultifrontal(sym, fac_matrix, device,
                                    checkpoint_dir=ck_dir, factor_only=True,
                                    **kw)
        finally:
            FactorRoundCheckpointer.save_round = real_save
        t = time.perf_counter() - t0
        if eng.factors is not None:
            raise AssertionError("factor-only: the engine kept factors")
        rounds = range(k + 1) if name == "stop_after" else range(k + 1, n)
        want = {asm: len(rounds),
                pan: sum(math.ceil(plans[r].P / 128) for r in rounds
                         if plans[r].B > 2)}
        got = {key: ck.LAUNCHES[key] for key in want}
        if got != want:
            raise AssertionError(f"factor-only {name}: launches {got}, "
                                 f"want {want}")
        pack_bs = eng._pack_bs
        # the pass's peak: its rounds' windows and the one after its last
        # save
        peak = max([torch.cuda.max_memory_allocated(device) - base]
                   + [round_peaks[r] for r in rounds])
        passes[name] = dict(s=t, factor_s=eng.timings["factor"],
                            rounds=len(rounds), launches=got,
                            peak_mem_gb=(base + peak) / gb)
        del eng
    files = sorted(Path(ck_dir).iterdir())
    if [p.name for p in files] != [f"round_{r:04d}.npz" for r in range(n)]:
        raise AssertionError(f"factor-only: directory holds "
                             f"{[p.name for p in files]}")
    over = {r: p / plan_peaks[r] for r, p in sorted(round_peaks.items())}
    if sorted(over) != list(range(n)) or max(over.values()) > 1.0:
        raise AssertionError(f"factor-only: round peaks over the memory "
                             f"plan's {over}")
    stats["factor_only"] = passes
    stats["round_peak_gb"] = [round_peaks[r] / gb for r in range(n)]
    stats["round_peak_planned_gb"] = [p / gb for p in plan_peaks]
    stats["round_files_gb"] = sum(p.stat().st_size for p in files) / gb
    # what this phase writes to the disk: the --factors file and the
    # checkpointed pass (round files and Schur files, deleted ones too)
    stats["disk_written_planned_gb"] = (
        factors_file + checkpoint_disk_plan(sym, plans, 8)[1][-1]) / gb
    say(f"phase 7c factor-only: stop after round {k} then resume "
        f"{passes['resume']['rounds']} rounds (K3 once each); peaks "
        f"{passes['stop_after']['peak_mem_gb']:.2f} / "
        f"{passes['resume']['peak_mem_gb']:.2f} GB against phase 5's "
        f"resident {resident_peak_gb:.2f} GB; per round measured / "
        f"planned {[round(x, 3) for x in over.values()]}; "
        f"{stats['round_files_gb']:.2f} GB of round files")

    # (d) the out-of-core stream solve over the round files
    times = []
    real = stream_solve.StreamSolver.apply

    def counted(self, b):
        t0 = time.perf_counter()
        out = real(self, b)
        times.append(time.perf_counter() - t0)
        return out
    stream_solve.StreamSolver.apply = counted
    try:
        t0 = time.perf_counter()
        Xs, rel = stream_solve.stream_solve(matrix, load_ind_maps(mat), sym,
                                            ck_dir, Bm, pack_bs=pack_bs)
        t = time.perf_counter() - t0
    finally:
        stream_solve.StreamSolver.apply = real
    A = matrix.to_scipy()
    res = np.linalg.norm(A @ Xs - Bm, axis=0) / np.linalg.norm(Bm, axis=0)
    if not (rel.max() <= 1e-10 and res.max() <= 1e-10
            and np.all(np.isfinite(Xs))):
        raise AssertionError(f"stream solve residuals {res}")
    stats["stream_solve"] = dict(s=t, applies=len(times),
                                 s_per_apply=float(np.mean(times)),
                                 max_residual=float(res.max()))
    say(f"phase 7d stream solve: {len(times)} applies, "
        f"{np.mean(times):.2f} s each, {t:.2f} s, residuals "
        f"{[f'{r:.2e}' for r in res]}")

    # (e) an offloading engine on the directory against a resident one
    reset_counts(ck, device)
    off = TorchMultifrontal(sym, fac_matrix, device, checkpoint_dir=ck_dir)
    if not off._offload or ck.LAUNCHES[asm] or ck.LAUNCHES[pan]:
        raise AssertionError(f"offload: factored instead of loading "
                             f"({dict(ck.LAUNCHES)})")
    peak_off = torch.cuda.max_memory_allocated(device) / gb
    res_eng = TorchMultifrontal(sym, fac_matrix, device)
    for rnd, (a, b) in enumerate(zip(off.factors, res_eng.factors)):
        if not all(bool(torch.equal(x, y)) for x, y in zip(a, b)):
            raise AssertionError(f"offload: round {rnd} differs from the "
                                 f"resident factors")
    stats["offload"] = dict(load_s=off.timings["factor"],
                            resident_factor_s=res_eng.timings["factor"],
                            peak_mem_gb=peak_off)
    del off, res_eng
    say(f"phase 7e offload: factors equal the resident engine's; load "
        f"{stats['offload']['load_s']:.2f} s against a factor of "
        f"{stats['offload']['resident_factor_s']:.2f} s")
    say("phase 7 gx3 out of core f64: " + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# phase 8: the Newton-Krylov outer loop at gx3deep, f64
# --------------------------------------------------------------------------

def tensor_bytes(obj) -> int:
    """Bytes of the tensors in ``obj`` (nested dicts, lists and tuples)."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v) for v in obj)
    return 0


def refactor_round_peaks(ck, fac, device) -> list:
    """One steady refactor (same values) with each round's device peak
    recorded: a window opens at each round's K3 launch and closes at the
    next one (the last at the end of the refactor). The peaks count what
    the engine's round walk holds: what was allocated before the refactor,
    less the previous factors and the plan constants, is taken off."""
    import torch
    eng = fac.engine
    outside = (torch.cuda.memory_allocated(device) - tensor_bytes(eng.factors)
               - tensor_bytes(eng._consts))
    peaks = []
    real = ck.ell_assemble

    def windowed(*a, **kw):
        peaks.append(torch.cuda.max_memory_allocated(device) - outside)
        torch.cuda.reset_peak_memory_stats(device)
        return real(*a, **kw)
    torch.cuda.reset_peak_memory_stats(device)
    ck.ell_assemble = windowed
    try:
        fac.refactor()
    finally:
        ck.ell_assemble = real
    peaks.append(torch.cuda.max_memory_allocated(device) - outside)
    return peaks[1:]    # [0]: before round 0 (the old factors' release)


def refactor_kernel_ms(ck, device, plans, nzval, sfx: str = "f64") -> dict:
    """The panel kernel (K1 at f64, K2 at f32) and K3 at ``sfx`` on every
    shape one refactor over ``plans`` gives them, timed as phase 3 times
    them (CUDA events over back-to-back launches; random panels with each
    round's p_arr, the real values for K3), with the plain version's and
    the library call's times, summed over the refactor with each shape's
    bound. Every panel shape and every round's fronts are held bit for
    bit against the plain version first."""
    import torch
    k1 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, panels=0,
              shapes_bitwise=0)
    bound_by = set()
    for i, ((B, R, T, off), (count, pa)) in enumerate(
            sorted(panel_shapes(plans).items())):
        p_arr = torch.from_numpy(pa).to(device)
        _, Pan, t_plain = check_panel(ck, device, sfx, B, R, T, off, p_arr,
                                      0.05, 300 + i)
        k1["shapes_bitwise"] += 1
        t = event_ms(lambda: ck.pivoted_panel(Pan, off, p_arr, 0.05), 5)
        k1["ms"] += count * t
        k1["plain_ms"] += count * t_plain
        k1["library_ms"] += count * event_ms(lambda: library_panel(Pan), 3)
        b_ms, b_by = panel_bound(B, R, T, sfx)
        k1["bound_ms"] += count * b_ms
        bound_by.add(b_by)
        k1["panels"] += count
        del Pan
    k1["bound_by"] = "/".join(sorted(bound_by))
    return dict(K1=k1, K3=assemble_kernel_ms(ck, device, plans, nzval, sfx))


def assemble_kernel_ms(ck, device, plans, nzval, sfx: str = "f64") -> dict:
    """K3 at ``sfx`` on every round of ``plans`` with the real values
    (in the factor dtype), held bit for bit against its plain version,
    then timed as phase 3 times it with the plain, library and bound
    times, summed over one factor; with the rounds' largest ELL width."""
    import torch
    nz = np.zeros(len(nzval) + 1)
    nz[:-1] = nzval
    nzd = torch.from_numpy(nz).to(device=device,
                                  dtype=getattr(torch, DTYPES[sfx]))
    k3 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
              rounds=len(plans), bound_by="bytes",
              max_W=max(p.a_col.shape[2] for p in plans))
    for rnd, p in enumerate(plans):
        args = [torch.from_numpy(a).to(device=device, dtype=torch.int64)
                for a in (p.a_col, p.a_csrc, p.a_pos, p.a_src)]
        p_arr = torch.from_numpy(p.p_arr).to(device)
        spill = bool((p.a_pos < p.N * p.N).any())
        if not torch.equal(
                ck.ell_assemble(nzd, *args, p_arr, p.N, p.P, spill),
                ck.ell_assemble_plain(nzd, *args, p_arr, p.N, p.P, spill)):
            raise AssertionError(f"K3 {sfx} round {rnd} {(p.B, p.P, p.N)}: "
                                 f"fronts differ from the plain version")
        k3["ms"] += event_ms(lambda: ck.ell_assemble(nzd, *args, p_arr, p.N,
                                                     p.P, spill), 3)
        k3["plain_ms"] += event_ms(lambda: ck.ell_assemble_plain(
            nzd, *args, p_arr, p.N, p.P, spill), 2)
        k3["library_ms"] += event_ms(lambda: library_assemble(
            nzd, args[0], args[1], p.B, p.N), 3)
        k3["bound_ms"] += assemble_bound(p, len(nzval), sfx)[0]
    return k3


def update_on_card(plan, stacked_host, c_host, device) -> None:
    """plan.update(stacked * c) on the card against the host numpy update
    of the same product: bit for bit."""
    import torch
    s = torch.from_numpy(stacked_host).to(device)
    got = plan.update(s * torch.from_numpy(c_host).to(device)).cpu().numpy()
    want = plan.update(stacked_host * c_host)
    if not np.array_equal(got, want):
        raise AssertionError(f"update on the card differs from the host's "
                             f"by {float(np.abs(got - want).max()):.3e}")


def phase_nk_loop(ck, device, work: Path, card: str) -> dict:
    """drivers.nk_loop.run_nk_loop on the card at gx3deep, f64, 4 RHS."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import nk_loop
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid import (gen_ind_maps,
                                                               load_grid)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        SparseMatrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (
        AssemblyOptions, assemble_jacobian)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.assemble import to_csr
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.device_update import (
        build_update_plan)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.fieldsource import (
        FileFieldSource)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import (
        StencilOperator)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.memplan import (
        engine_round_peaks)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import (
        make_circ_file)
    gb = 1e9
    d = work / "gx3deep"
    d.mkdir()
    t0 = time.perf_counter()
    matrix, maps, circ = nk_loop.build_problem(GX3DEEP, str(d))
    t_gen = time.perf_counter() - t0
    B = np.random.default_rng(0).standard_normal((matrix.flat_len, 4))
    say(f"phase 8 gx3deep problem {tuple(GX3DEEP.values())}: flat_len "
        f"{matrix.flat_len}, nnz {matrix.nnz}, gen_A {t_gen:.2f} s")

    # the loop, with each refactor's launches read around it
    per_refactor = []
    real_refactor = mf.MultifrontalFactorization.refactor

    def counted(self, *a, **kw):
        before = dict(ck.LAUNCHES)
        real_refactor(self, *a, **kw)
        per_refactor.append({k: ck.LAUNCHES[k] - before[k]
                             for k in ck.LAUNCHES})
    reset_counts(ck, device)
    mf.MultifrontalFactorization.refactor = counted
    try:
        with counting_solves(ck) as solves4:
            res = nk_loop.run_nk_loop(matrix, maps, circ, B, NK_ITERATIONS,
                                      device=device)
    finally:
        mf.MultifrontalFactorization.refactor = real_refactor
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    fac = res.factorization
    plans = fac.engine.plans
    if len(per_refactor) != NK_ITERATIONS:
        raise AssertionError(f"{len(per_refactor)} refactors, want "
                             f"{NK_ITERATIONS}")
    for it, got in enumerate(per_refactor, 1):
        try:
            expect_launches(got, plans, ("f64",))
        except AssertionError as e:
            raise AssertionError(f"NK iteration {it}: {e}") from None
    factor = factor_launches(launches)
    per_factor = {k: v // (NK_ITERATIONS + 1) for k, v in factor.items()}
    expect_launches(per_factor, plans, ("f64",))
    if any(v % (NK_ITERATIONS + 1) for v in factor.values()):
        raise AssertionError(f"launches {launches} are not one cold factor "
                             f"and {NK_ITERATIONS} refactors")
    fac.validate()
    # the product kernel on the main path: the loop's 4-RHS solves, then
    # one 1-RHS solve of the last factor, as the apply cell's requests
    with counting_solves(ck) as solves1:
        fac.solve(B[:, 0])
    matvec_launches = {4: solves4.check("phase 8 NK loop"),
                       1: solves1.check("phase 8 1-RHS solve")}
    if {st["nrhs"] for st in solves4.stats} != {4} \
            or solves1.stats[-1]["best_rel"] > 1e-10:
        raise AssertionError(f"phase 8 solves: {solves4.stats} "
                             f"{solves1.stats}")
    say(f"phase 8 csr_matvec launches: {matvec_launches[4]} over the "
        f"loop's {len(solves4.stats)} 4-RHS refined solves, "
        f"{matvec_launches[1]} over one 1-RHS solve, each the refiner's "
        f"device residuals")
    for r in res.rows:
        split = r["refactor_split"]
        lk = per_refactor[r["it"] - 1]
        say(f"phase 8 NK iteration {r['it']}: assemble {r['assemble']:.4f} "
            f"s, refactor {r['refactor']:.3f} s (engine {split['factor']:.3f}"
            f" s; host: equilibrate {split['equilibrate']:.3f}, to_scipy "
            f"{split['to_scipy']:.3f}, rebind {split['rebind']:.3f} s), "
            f"solve {r['solve']:.3f} s, residual {r['residual']:.3e}, "
            f"refiner {r['refiner']}; launches K1 "
            f"{lk['pivoted_panel_f64']}, K3 {lk['ell_assemble_f64']} "
            f"[{card}]")
    for r in res.rows:
        if not r["residual"] <= 1e-10:
            raise AssertionError(f"NK iteration {r['it']}: residual "
                                 f"{r['residual']:.3e} > 1e-10")

    # the value update on the card, bit for bit with the host's, for each
    # iteration's perturbation (the loop's own draws)
    plan = res.plan
    stacked = res.stacked0.cpu().numpy()
    rng = np.random.default_rng(42)
    for nz in res.nzvals:
        c = 1.0 + 1e-3 * rng.standard_normal(plan.total)
        if not np.array_equal(nz, plan.update(stacked * c)):
            raise AssertionError("the loop's new values differ from the "
                                 "host update's")
        update_on_card(plan, stacked, c, device)
    # and on a tiny option set whose fold has W > 1 columns
    td = work / "update_w2"
    td.mkdir()
    tcirc = str(td / "circ.nc")
    make_circ_file(tcirc, seed=7, **TINY)
    tgrid = load_grid(tcirc)
    tasm = assemble_jacobian(tgrid, AssemblyOptions(circ_fname=tcirc,
                                                    **UPDATE_W2),
                             FileFieldSource(tcirc), None,
                             gen_ind_maps(np.asarray(tgrid.KMT), tgrid.km))
    nzv, colind, rowptr = to_csr(tasm)
    tplan = build_update_plan(tasm, SparseMatrix(
        nzval=nzv, colind=colind, rowptr=rowptr, coupled_tracer_cnt=1))
    if tplan.ell_src.shape[1] < 2:
        raise AssertionError("the W > 1 option set folds one column")
    update_on_card(tplan, tplan.stack_fields(tasm),
                   1.0 + 1e-3 * np.random.default_rng(1).standard_normal(
                       tplan.total), device)
    say(f"phase 8 value update: card bit for bit with the host at gx3deep "
        f"(W = {plan.ell_src.shape[1]}, {plan.total} stacked, {plan.nnz} "
        f"nonzeros, {len(plan.layout)} fields) on all {NK_ITERATIONS} "
        f"iterations, and at tiny {UPDATE_W2} (W = "
        f"{tplan.ell_src.shape[1]})")

    # the stencil operator's matvec against the CSR product
    op = StencilOperator.from_assembly(res.asm, device)
    x = np.random.default_rng(7).standard_normal(matrix.flat_len)
    y = op.matvec_factory(maps)(torch.from_numpy(x).to(device)).cpu().numpy()
    want = matrix.to_scipy() @ x
    scale = float(np.abs(want).max())
    err = float(np.abs(y - want).max())
    np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-13 * scale)
    del op
    say(f"phase 8 stencil matvec gx3deep: max |y - A x| {err:.3e} (max |y| "
        f"{scale:.3e}), within rtol 1e-12, atol 1e-13 max|y|")
    csr_mv = phase_csr_matvec(ck, device, matrix, card)
    csr_mv["launches"] = matvec_launches

    # each round's peak of a steady refactor against the engine's plan
    planned = engine_round_peaks(plans, 8, fac._fac_matrix.nnz,
                                 fac.engine._pack_bs, factor_only=False)
    peaks = refactor_round_peaks(ck, fac, device)
    over = [m / p for m, p in zip(peaks, planned)]
    if len(peaks) != len(plans) or max(over) > 1.0:
        raise AssertionError(f"refactor round peaks over the memory plan's: "
                             f"{[round(x, 3) for x in over]}")
    kern = refactor_kernel_ms(ck, device, plans, fac._fac_matrix.nzval)
    breakdown = stage_breakdown(fac, device)
    print_rounds("8", "gx3deep f64 leaf 16 (the NK loop's facade)",
                 breakdown, card)
    rounds = [(p.B, p.P, p.N) for p in plans]
    stats = dict(
        card=card, flat_len=matrix.flat_len, nnz=matrix.nnz,
        rounds=len(plans), max_P=max(p.P for p in plans),
        max_N=max(p.N for p in plans), gen_a_s=t_gen,
        symbolic_s=res.symbolic_s, update_plan_s=res.update_plan_s,
        cold_factor_s=res.cold_factor_s, cold_timings=res.cold_timings,
        iterations=res.rows, launches_per_refactor=per_refactor,
        launches=launches, peak_mem_gb=peak / gb,
        round_peak_over_plan_max=max(over),
        round_peak_gb_max=max(peaks) / gb, kernels_per_refactor=kern,
        breakdown=breakdown, summary=nk_loop.summary(res, 4, "gx3deep"),
        csr_matvec=csr_mv)
    say(f"phase 8 gx3deep rounds (B, P, N): {rounds}")
    say(f"phase 8 one-time: gen_A {t_gen:.2f} s, symbolic "
        f"{res.symbolic_s:.2f} s, update plan {res.update_plan_s:.2f} s, "
        f"cold factor {res.cold_factor_s:.2f} s; peak {peak / gb:.2f} GB; "
        f"refactor round peaks over plan {min(over):.3f}-{max(over):.3f} "
        f"(max {max(peaks) / gb:.2f} GB); K1 f64 {kern['K1']['ms']:.3f} ms "
        f"per gx3deep refactor ({kern['K1']['panels']} panels, "
        f"{kern['K1']['shapes_bitwise']} shapes bitwise equal, plain "
        f"{kern['K1']['plain_ms']:.1f} ms, lu_factor_ex "
        f"{kern['K1']['library_ms']:.3f} ms, bound "
        f"{kern['K1']['bound_ms']:.4f} ms), K3 f64 {kern['K3']['ms']:.3f} "
        f"ms ({kern['K3']['rounds']} rounds bitwise equal, plain "
        f"{kern['K3']['plain_ms']:.3f} ms, index_put_ "
        f"{kern['K3']['library_ms']:.3f} ms, bound "
        f"{kern['K3']['bound_ms']:.4f} ms) [{card}]")
    say("phase 8 NK loop gx3deep f64: " + json.dumps(stats, default=float))
    return stats, res.asm


def phase_csr_matvec(ck, device, matrix, card: str) -> dict:
    """The refiner's product kernel (csr_matvec) on its own ELL copy of
    ``matrix`` at 1 and 4 right-hand sides: bit for bit against its plain
    version on the card and against scipy's A @ X on the host, and b minus
    it against scipy's B - A @ X; timed (CUDA events) beside its bound,
    the plain version, the same product through torch.sparse.mm on a CSR
    tensor (a yardstick: the port never calls it) and scipy on the host,
    and the refiner's residual (b minus it) beside it."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.refine import (
        DeviceRefiner)
    ref = DeviceRefiner.__new__(DeviceRefiner)
    ref.n, ref._rowptr, ref.device = (matrix.flat_len,
                                      np.asarray(matrix.rowptr), device)
    ref._bind_matrix(matrix)
    col, val = ref._ell_col, ref._ell_val64
    n, E = col.shape
    A = ref.A.tocsr()
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data), size=A.shape).to(device)
    rows = {}
    for nrhs in (1, 4):
        rng = np.random.default_rng(nrhs)
        X = rng.standard_normal((n, nrhs)) * np.exp(
            rng.uniform(-8, 8, (n, 1)))
        B = rng.standard_normal((n, nrhs))
        Xd, Bd = (torch.from_numpy(a).to(device) for a in (X, B))
        before = ck.LAUNCHES["csr_matvec_f64"]
        got = ck.csr_matvec(col, val, Xd)
        plain = ck.csr_matvec_plain(col, val, Xd)
        r = ref._residual64(Bd, Xd, dict(device_residuals=0))
        sync(device)
        if ck.LAUNCHES["csr_matvec_f64"] != before + 2:
            raise AssertionError("csr_matvec launched no kernel")
        if not torch.equal(got, plain):
            raise AssertionError(f"csr_matvec (nrhs {nrhs}) differs from "
                                 f"its plain version")
        AX = A @ X
        host = got.cpu().numpy()
        scipy_bitwise = bool(np.array_equal(host, AX)
                             and np.array_equal(r.cpu().numpy(), B - AX))
        scale = np.abs(A) @ np.abs(X)
        # the least traffic: values and int32 column indices of the
        # nonzeros, the row pointers, x gathered once and y written
        nbytes = matrix.nnz * 12 + (n + 1) * 4 + 2 * n * nrhs * 8
        rows[nrhs] = dict(
            ms=event_ms(lambda: ck.csr_matvec(col, val, Xd), 200),
            bound_ms=nbytes / HBM_BPS * 1e3,
            ell_stored_ms=n * E * 16 / HBM_BPS * 1e3,
            residual_ms=event_ms(lambda: ref._residual64(
                Bd, Xd, dict(device_residuals=0)), 200),
            plain_ms=event_ms(lambda: ck.csr_matvec_plain(col, val, Xd), 5),
            library_ms=event_ms(lambda: torch.sparse.mm(csr, Xd), 200),
            scipy_host_ms=median_ms(lambda: A @ X, torch.device("cpu"), 5),
            scipy_bitwise=scipy_bitwise,
            max_err_over_scale=float((np.abs(host - AX) / scale).max()))
        m = rows[nrhs]
        say(f"phase 8 csr_matvec gx3deep (n {n}, E {E}, nnz {matrix.nnz}, "
            f"nrhs {nrhs}): kernel {m['ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms (stored ELL {m['ell_stored_ms']:.4f}),"
            f" residual {m['residual_ms']:.4f} ms, plain "
            f"{m['plain_ms']:.3f} ms, torch.sparse.mm "
            f"{m['library_ms']:.4f} ms, scipy on the host "
            f"{m['scipy_host_ms']:.3f} ms; bit for bit with the plain "
            f"version, with scipy {scipy_bitwise} (max |y - y_scipy| / "
            f"|A||x| {m['max_err_over_scale']:.3e}) [{card}]")
    return dict(n=n, E=E, nnz=matrix.nnz, rows=rows)


# --------------------------------------------------------------------------
# phase 9: the factor-and-solve bench against scipy SuperLU on this host
# --------------------------------------------------------------------------

def phase_bench(ck, device, work: Path, card: str) -> dict:
    """drivers.bench.main at BENCH_SIZE, f64, on the card, with a fresh
    scipy baseline; its JSON line, checked."""
    import contextlib
    import io
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import (bench,
                                                                  nk_loop)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.plan import (
        build_plan)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (
        symbolic_from_matrix)
    cache = work / "bench"
    out = io.StringIO()
    reset_counts(ck, device)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), counting_solves(ck) as solves:
        rc = bench.main(["--size", BENCH_SIZE, "--prec", "f64", "--cache",
                         str(cache)])
    t_phase = time.perf_counter() - t0
    matvec_launches = solves.check("phase 9 bench")
    launches = dict(ck.LAUNCHES)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0:
        raise AssertionError(f"bench exited {rc}")
    for key in ("residual", "baseline_residual"):
        if not line[key] <= 1e-10:
            raise AssertionError(f"bench {key} {line[key]:.3e} > 1e-10")
    if "NOT MET" in line["metric"] or line["escalated"] is not None:
        raise AssertionError(f"bench line: {line['metric']}, escalated "
                             f"{line['escalated']}")
    if line["device"] != torch.cuda.get_device_name(device):
        raise AssertionError(f"bench ran on {line['device']}")
    # the cold factor and the steady refactor, each as the plans say (the
    # problem files are in the cache; the plans do not depend on values)
    matrix, maps, _ = nk_loop.build_problem(nk_loop.SIZES[BENCH_SIZE],
                                            str(cache))
    plans = build_plan(symbolic_from_matrix(maps, matrix, leaf_size=16),
                       matrix, batch_multiple=1)
    factor = factor_launches(launches)
    if any(v % 2 for v in factor.values()):
        raise AssertionError(f"launches {factor} are not two factors")
    expect_launches({k: v // 2 for k, v in factor.items()}, plans,
                    ("f64",))
    # K1 and K3 (f64) at this path's own shapes (leaf 16), bit for bit
    # with their plain versions, timed per bench factor
    kern = refactor_kernel_ms(ck, device, plans, matrix.nzval)
    k1, k3 = kern["K1"], kern["K3"]
    say(f"phase 9 per bench factor ({BENCH_SIZE}, leaf 16): K1 f64 "
        f"{k1['ms']:.3f} ms ({k1['panels']} panels, {k1['shapes_bitwise']} "
        f"shapes bitwise equal, plain {k1['plain_ms']:.1f} ms, lu_factor_ex "
        f"{k1['library_ms']:.3f} ms, bound {k1['bound_ms']:.4f} ms), K3 f64 "
        f"{k3['ms']:.3f} ms ({k3['rounds']} rounds bitwise equal, plain "
        f"{k3['plain_ms']:.3f} ms, index_put_ {k3['library_ms']:.3f} ms, "
        f"bound {k3['bound_ms']:.4f} ms) [{card}]")
    say(f"phase 9 bench {BENCH_SIZE} f64: {t_phase:.1f} s in all; factor "
        f"{line['factor_s']:.4f} s, solve {line['solve_s']:.4f} s, cold "
        f"factor {line['cold_factor_s']:.3f} s, cold solve "
        f"{line['cold_solve_s']:.3f} s, symbolic {line['symbolic_s']:.3f} "
        f"s, residual {line['residual']:.3e}, peak "
        f"{line['peak_mem_gb']:.2f} GB; scipy SuperLU factor "
        f"{line['baseline_factor_s']:.2f} s, solve "
        f"{line['baseline_solve_s']:.3f} s, residual "
        f"{line['baseline_residual']:.3e} on {line['baseline_host']}; "
        f"vs_baseline {line['vs_baseline']:.2f}; launches K1 "
        f"{launches['pivoted_panel_f64']}, K3 "
        f"{launches['ell_assemble_f64']} over 2 factors, csr_matvec "
        f"{matvec_launches} over {len(solves.stats)} refined solves "
        f"[{card}]")
    say("phase 9 bench line: " + json.dumps(line))
    return dict(line=line, launches=launches, phase_s=t_phase,
                kernels_per_factor=kern)


# --------------------------------------------------------------------------
# phase 10: an NCCL world of one, the sharded stencil apply
# --------------------------------------------------------------------------

def phase_mesh(device, work: Path, asm, card: str) -> dict:
    """init_process_group("cuda", 0, 1) and make_mesh(1): an all-reduce
    on the card, and the one-band sharded apply of ``asm``'s operator bit
    for bit with its apply, both timed."""
    import torch
    import torch.distributed as dist
    from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import (
        StencilOperator, init_process_group, make_mesh)
    dev = init_process_group(device, 0, 1, str(work / "nccl_store"))
    try:
        backend = dist.get_backend()
        t = torch.full((4,), 2.0, device=dev)
        dist.all_reduce(t)
        if backend != "nccl" or not bool((t == 2.0).all()):
            raise AssertionError(f"{backend} all-reduce of one rank: "
                                 f"{t.tolist()}")
        op = StencilOperator.from_assembly(asm, dev)
        mesh = make_mesh(1)
        apply_fn, layout, pad_field, unpad_field = op.sharded_apply_factory(
            mesh)
        km, jmt, imt = op.shape
        wet = np.arange(km)[:, None, None] < np.asarray(asm.grid.KMT)[None]
        x = np.where(wet, np.random.default_rng(8).standard_normal(
            (km, jmt, imt)), 0.0)[None].repeat(op.nt, 0)
        x = torch.from_numpy(x).to(dev)
        x_l = layout.scatter(pad_field(x))
        y = unpad_field(layout.gather(apply_fn(x_l)))
        want = op.apply(x)
        if not torch.equal(y, want):
            raise AssertionError(
                f"one-band sharded apply differs from apply by "
                f"{float((y - want).abs().max()):.3e}")
        stats = dict(backend=backend, mesh_shape=mesh.shape,
                     shape=op.shape, nt=op.nt, offsets=len(op.offsets),
                     sharded_ms=median_ms(lambda: apply_fn(x_l), dev, 5),
                     apply_ms=median_ms(lambda: op.apply(x), dev, 5))
    finally:
        dist.destroy_process_group()
    say(f"phase 10 NCCL world of one, make_mesh(1): sharded apply on the "
        f"gx3deep assembly {op.shape} bit for bit with apply; "
        f"{stats['sharded_ms']:.3f} ms against {stats['apply_ms']:.3f} ms "
        f"(median of 5) [{card}]")
    return stats


# --------------------------------------------------------------------------
# phase 11: the mesh engine (an NCCL world of one, gloo worlds on the card)
# --------------------------------------------------------------------------

def treetop_panel_ms(ck, device, plans, seed: int = 400) -> dict:
    """K1 on every panel of the rounds with B <= 2 (which a mesh engine
    factors with the panel kernel where the single-device engine takes the
    library LU), each held bit for bit against its plain version, then
    timed as phase 3 times them, with the plain, library and bound times,
    summed over one factor; with the tallest panel's launch config (C,
    nb) and the count of panels taller than TALL_R rows."""
    import torch
    k1 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, panels=0,
              tallest_R=0, tallest_config=None, slab=False, tall=0)
    for p in plans:
        if p.B > 2:
            continue
        p_arr = torch.from_numpy(p.p_arr).to(device)
        for off in range(0, p.P, 128):
            B, R, T = p.B, p.P - off, min(128, p.P - off)
            _, Pan, t_plain = check_panel(ck, device, "f64", B, R, T, off,
                                          p_arr, 0.05, seed + k1["panels"])
            k1["ms"] += event_ms(lambda: ck.pivoted_panel(Pan, off, p_arr,
                                                          0.05), 5)
            k1["plain_ms"] += t_plain
            k1["library_ms"] += event_ms(lambda: library_panel(Pan), 3)
            k1["bound_ms"] += panel_bound(B, R, T, "f64")[0]
            k1["panels"] += 1
            k1["tall"] += R > TALL_R
            if R > k1["tallest_R"]:
                C, nb = ck.panel_launch_config(B, R, T, 8,
                                               ck.active_clusters)
                k1.update(tallest_R=R, tallest_config=(C, nb), slab=nb < T)
            del Pan
    return k1


def mesh_kernel_ms(ck, device, plans, nzval) -> dict:
    """K1 on the tree-top panels (``treetop_panel_ms``) and K3 on every
    round of the mesh engine's ``plans``."""
    return dict(K1=treetop_panel_ms(ck, device, plans),
                K3=assemble_kernel_ms(ck, device, plans, nzval))


def solutions_agree(X, X1, what: str) -> float:
    """max |X - X1| over max |X1|, required <= 1e-9 (tests/test_dist_cli's
    rtol, taken over the largest entry)."""
    d = float(np.abs(X - X1).max() / np.abs(X1).max())
    if not d <= 1e-9:
        raise AssertionError(f"{what}: solutions differ by {d:.3e} of the "
                             f"largest entry")
    return d


def phase_mesh_of_one(ck, device, work: Path, card: str,
                      deep_k1: dict) -> dict:
    """(a) The facade with mesh=make_mesh(1, ("front",)) in an NCCL group
    of one rank, at gx3deep (phase 8's problem, leaf 16), f64, 4 RHS,
    against the single-device facade on the same right-hand sides.
    ``deep_k1`` is phase 8's K1 per gx3deep refactor (its B > 2 panels,
    the same shapes as here)."""
    import torch
    import torch.distributed as dist
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import nk_loop
    from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import (
        init_process_group, make_mesh)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.memplan import (
        plan_memory)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
        MultifrontalFactorization)
    matrix, maps, _ = nk_loop.build_problem(GX3DEEP, str(work / "gx3deep"))
    A = matrix.to_scipy()
    B = np.random.default_rng(0).standard_normal((matrix.flat_len, 4))
    # the single-device facade: its solutions and steady factor
    reset_counts(ck, device)
    one = MultifrontalFactorization(matrix, maps=maps, leaf_size=16,
                                    device=device)
    X1 = one.solve(B)
    t0 = time.perf_counter()
    one.refactor()
    single_steady = time.perf_counter() - t0
    t0 = time.perf_counter()
    one.solve(B)
    single_solve = time.perf_counter() - t0
    single_stages = stage_breakdown(one, device)
    sym = one.sym
    del one
    torch.cuda.empty_cache()

    dev = init_process_group(device, 0, 1, str(work / "nccl_store_11"))
    small = []
    real_small = mf_torch.partial_factor_small_batch
    mf_torch.partial_factor_small_batch = (
        lambda *a, **k: small.append(1) or real_small(*a, **k))
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        # the mesh path: counts from 0 just before it, read just after
        reset_counts(ck, dev)
        t0 = time.perf_counter()
        fac = MultifrontalFactorization(matrix, maps=maps, sym=sym,
                                        leaf_size=16, device=dev,
                                        mesh=make_mesh(1, ("front",)))
        t_cold = time.perf_counter() - t0
        X = fac.solve(B)
        launches = dict(ck.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        eng = fac.engine
        plans = eng.plans
        want_k1 = sum(math.ceil(p.P / 128) for p in plans)
        treetop = [(p.B, p.P, p.N) for p in plans if p.B <= 2]
        if (launches["pivoted_panel_f64"] != want_k1
                or launches["ell_assemble_f64"] != len(plans)
                or launches["pivoted_panel_f32"]
                or launches["ell_assemble_f32"]):
            raise AssertionError(f"mesh of one: launches {launches}, want "
                                 f"K1 {want_k1} and K3 {len(plans)}")
        if small or not treetop:
            raise AssertionError(f"mesh of one: {len(small)} library LU "
                                 f"calls, tree-top rounds {treetop}")
        rel = max_rel(A, X, B)
        if not rel <= 1e-10:
            raise AssertionError(f"mesh of one residual {rel:.3e}")
        agree = solutions_agree(X, X1, "mesh of one against one device")
        t0 = time.perf_counter()
        fac.refactor()
        t_steady = time.perf_counter() - t0
        t0 = time.perf_counter()
        X = fac.solve(B)
        t_solve = time.perf_counter() - t0
        rel_steady = max_rel(A, X, B)
        if not rel_steady <= 1e-10:
            raise AssertionError(f"mesh of one steady residual "
                                 f"{rel_steady:.3e}")
        planned = plan_memory(plans, 1, 8).peak_per_device
        stages = stage_breakdown(fac, dev)
        kern = mesh_kernel_ms(ck, dev, plans, fac._fac_matrix.nzval)
    finally:
        mf_torch.partial_factor_small_batch = real_small
        dist.destroy_process_group()
    k1, k3 = kern["K1"], kern["K3"]
    per_factor = {key: deep_k1[key] + k1[key]
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    stats = dict(card=card, treetop_rounds=treetop, launches=launches,
                 tallest_panel_R=k1["tallest_R"], slab_path=k1["slab"],
                 cold_facade_s=t_cold, steady_factor_s=t_steady,
                 single_device_steady_factor_s=single_steady,
                 solve_4rhs_s=t_solve,
                 single_device_solve_4rhs_s=single_solve,
                 breakdown=stages, single_device_breakdown=single_stages,
                 residual=rel,
                 steady_residual=rel_steady, solutions_diff=agree,
                 peak_mem_gb=peak / 1e9,
                 plan_peak_gb=planned / 1e9, mesh_kernels=kern,
                 k1_per_factor=per_factor,
                 single_device_k1_ms=deep_k1["ms"])
    say(f"phase 11a NCCL world of one, make_mesh(1, ('front',)), gx3deep "
        f"f64 leaf 16, 4 RHS: tree-top rounds (B, P, N) {treetop} through "
        f"K1 ({k1['panels']} panels, tallest R {k1['tallest_R']}, column "
        f"slabs {k1['slab']}), no library LU; launches K1 "
        f"{launches['pivoted_panel_f64']}, K3 {launches['ell_assemble_f64']}"
        f" per factor; residual {rel:.3e} (steady {rel_steady:.3e}), "
        f"solutions {agree:.2e} of the largest entry from the single-device "
        f"facade's [{card}]")
    say(f"phase 11a times: cold facade {t_cold:.2f} s, steady factor "
        f"{t_steady:.4f} s (single-device {single_steady:.4f} s), 4-RHS "
        f"solve {t_solve:.4f} s (single-device {single_solve:.4f} s); peak "
        f"{peak / 1e9:.2f} GB against "
        f"plan_memory(plans, 1, 8) {planned / 1e9:.2f} GB; K1 per factor "
        f"{per_factor['ms']:.3f} ms (tree-top {k1['ms']:.3f} ms over "
        f"{k1['panels']} panels; single-device engine {deep_k1['ms']:.3f} "
        f"ms), bound {per_factor['bound_ms']:.4f} ms, lu_factor_ex "
        f"{per_factor['library_ms']:.3f} ms, plain "
        f"{per_factor['plain_ms']:.1f} ms; K3 f64 per factor "
        f"{k3['ms']:.3f} ms ({k3['rounds']} rounds bitwise equal, plain "
        f"{k3['plain_ms']:.3f} ms, index_put_ {k3['library_ms']:.3f} ms, "
        f"bound {k3['bound_ms']:.4f} ms) [{card}]")
    say(f"phase 11a synchronized refactor, exclusive ms: mesh of one "
        f"{stages['synced_refactor_ms']:.1f} {stages['stages_ms']} (rest of "
        f"partial_factor {stages['partial_factor_rest_split_ms']}); single "
        f"device {single_stages['synced_refactor_ms']:.1f} "
        f"{single_stages['stages_ms']} (rest of partial_factor "
        f"{single_stages['partial_factor_rest_split_ms']}) [{card}]")
    return stats


def mesh_world_rank(dev, mat: str, rhs_devices: int, leaf: int,
                    out_dir: str) -> None:
    """One rank of a gloo world whose ranks share the card
    (parallel.mesh.run_world): the facade with n_devices = the world's
    size (and ``rhs_devices``) on ``mat``, 4 RHS; writes what it saw to
    out_dir/rank<r>.pt."""
    import torch
    import torch.distributed as dist
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        load_ind_maps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (
        cuda_kernels as ck)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.memplan import (
        plan_memory)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
        MultifrontalFactorization)
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    B = np.random.default_rng(0).standard_normal((matrix.flat_len, 4))
    t0 = time.perf_counter()
    fac = MultifrontalFactorization(matrix, maps=maps, leaf_size=leaf,
                                    device=dev,
                                    n_devices=dist.get_world_size(),
                                    rhs_devices=rhs_devices)
    t_cold = time.perf_counter() - t0
    X = fac.solve(B)
    launches = dict(ck.LAUNCHES)
    eng = fac.engine
    t0 = time.perf_counter()
    fac.refactor()
    t_steady = time.perf_counter() - t0
    t0 = time.perf_counter()
    fac.solve(B)
    t_solve = time.perf_counter() - t0
    out = dict(
        X=X, launches=launches, cold_s=t_cold, steady_s=t_steady,
        solve_s=t_solve, stats=fac._refiner.stats,
        plans=[(p.B, p.P, p.N, p.M) for p in eng.plans],
        layouts=[(lay.kind, lay.masked, lay.border) for lay in eng.layouts],
        resident=eng.resident_factor_bytes(),
        planned=plan_memory(eng.plans, eng.ndev, 8,
                            row_shard_min=eng.row_shard_min
                            ).factor_bytes_per_device,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        mesh=(fac.mesh.axis_names, fac.mesh.shape, fac.mesh.coords))
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


def gloo_world(world: int, work: Path, name: str, *args) -> list:
    """mesh_world_rank on ``world`` gloo ranks that share the card; their
    results."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import run_world
    out_dir = work / name
    out_dir.mkdir()
    run_world(mesh_world_rank, world, "cuda", *args, str(out_dir),
              backend="gloo")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def phase_gloo_worlds(ck, device, work: Path, mat: str, card: str) -> dict:
    """(b) 2 gloo ranks on the card at gx3 (leaf 32), (c) 4 gloo ranks as a
    2 x rhs 2 mesh at tiny, each against the mesh of one in this process
    (no process group), and (d) the dry run's main on 2 gloo ranks."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        load_ind_maps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import (
        dryrun, make_mesh)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
        MultifrontalFactorization)
    say("phase 11 (b)-(d): the ranks of each world share this one card and "
        "their collectives go through the host (gloo), so their times are "
        "not a distribution speed")
    stats = {}
    tiny_dir = work / "tiny_11"
    tiny_dir.mkdir()
    tiny, _ = make_problem(tiny_dir, TINY)
    for tag, world, path, rhs, leaf in (("b", 2, mat, 1, 32),
                                        ("c", 4, tiny, 2, 32)):
        matrix, maps = read_matrix_file(path), load_ind_maps(path)
        A = matrix.to_scipy()
        B = np.random.default_rng(0).standard_normal((matrix.flat_len, 4))
        one = MultifrontalFactorization(matrix, maps=maps, leaf_size=leaf,
                                        device=device,
                                        mesh=make_mesh(1, ("front",)))
        X1 = one.solve(B)
        del one
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = gloo_world(world, work, f"world_{tag}", path, rhs, leaf)
        t_world = time.perf_counter() - t0
        r0 = ranks[0]
        plans = r0["plans"]
        want_k1 = sum(math.ceil(P / 128) for _, P, _, _ in plans)
        for rank, r in enumerate(ranks):
            if not np.array_equal(r["X"], r0["X"]) or r["stats"] != r0["stats"]:
                raise AssertionError(f"world {tag}: rank {rank} solved or "
                                     f"refined otherwise than rank 0")
            if (r["launches"]["pivoted_panel_f64"] != want_k1
                    or r["launches"]["ell_assemble_f64"] != len(plans)):
                raise AssertionError(f"world {tag} rank {rank}: launches "
                                     f"{r['launches']}, want K1 {want_k1}, "
                                     f"K3 {len(plans)}")
            if r["resident"] != r["planned"]:
                raise AssertionError(f"world {tag} rank {rank}: resident "
                                     f"factor bytes {r['resident']}, plan "
                                     f"{r['planned']}")
        rel = max_rel(A, r0["X"], B)
        if not rel <= 1e-10:
            raise AssertionError(f"world {tag}: residual {rel:.3e}")
        agree = solutions_agree(r0["X"], X1, f"world {tag} against the "
                                "mesh of one")
        kinds = [k for k, _, _ in r0["layouts"]]
        front = r0["mesh"][1][0]
        split = sum(1 for (k, _, _), p in zip(r0["layouts"], plans)
                    if k == "batch" and p[0] % front == 0)
        masked = sum(1 for k, m, _ in r0["layouts"] if k == "row" and m)
        if tag == "b" and not (split and masked):
            raise AssertionError(f"world b: {split} batch-sharded and "
                                 f"{masked} masked row-sharded rounds")
        if tag == "c" and r0["mesh"][:2] != (("front", "rhs"), (2, 2)):
            raise AssertionError(f"world c mesh {r0['mesh']}")
        stats[tag] = dict(
            world=world, mesh=r0["mesh"][:2], kinds=kinds, residual=rel,
            solutions_diff=agree,
            launches=r0["launches"], resident_gb=[r["resident"] / 1e9
                                                  for r in ranks],
            cold_s=[r["cold_s"] for r in ranks],
            steady_s=[r["steady_s"] for r in ranks],
            solve_s=[r["solve_s"] for r in ranks],
            peak_gb=[r["peak_gb"] for r in ranks], world_s=t_world)
        say(f"phase 11{tag} gloo world of {world} on the card, mesh "
            f"{r0['mesh'][1]}: rounds {kinds} ({split} batch-sharded, "
            f"{masked} row-sharded masked); per rank K1 "
            f"{r0['launches']['pivoted_panel_f64']} and K3 "
            f"{r0['launches']['ell_assemble_f64']} launches, as the plan "
            f"gives; resident factor bytes equal the plan's on every rank "
            f"({[round(r['resident'] / 1e9, 4) for r in ranks]} GB); "
            f"residual {rel:.3e}, solutions {agree:.2e} of the largest "
            f"entry from the mesh of one's and bit for bit alike on every "
            f"rank; cold "
            f"{[round(r['cold_s'], 2) for r in ranks]} s, steady factor "
            f"{[round(r['steady_s'], 3) for r in ranks]} s, solve "
            f"{[round(r['solve_s'], 3) for r in ranks]} s, {t_world:.1f} s "
            f"with the ranks' start (shared card, through the host) [{card}]")
    t0 = time.perf_counter()
    dryrun.main(["2", "--device", "cuda", "--backend", "gloo"])
    stats["d"] = dict(seconds=time.perf_counter() - t0)
    say(f"phase 11d dry run on a gloo world of 2 on the card: ok, "
        f"{stats['d']['seconds']:.1f} s (shared card) [{card}]")
    return stats


# --------------------------------------------------------------------------
# phase 12: the reference's own assembly configurations
# --------------------------------------------------------------------------

def make_config(d: Path, dims: dict, body: str, tracers, upwind3: bool):
    """A circulation file of seed 7 at ``dims`` (its upwind3 transports
    derived from its own velocities when ``upwind3``), a tracer file of
    ``tracers`` (with the coupled derivatives d_J_A_d_B of the PO4-DOP
    pair when those are the tracers), an options file of ``body`` in the
    reference's format, and the port's gen_a CLI on it: (matrix path,
    tracer path, gen_A seconds)."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import gen_a
    from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import (
        make_circ_file, make_tracer_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata.transports import (
        derive_upwind3_transports)
    d.mkdir()
    circ, tracer = str(d / "circ.nc"), str(d / "tracer.nc")
    mat, opts = str(d / "matrix.nc"), d / "opts.txt"
    make_circ_file(circ, seed=7, **dims)
    if upwind3:
        derive_upwind3_transports(circ)
    coupled = tuple(tracers) == COUPLED
    make_tracer_file(tracer, dims["imt"], dims["jmt"], dims["km"],
                     tracer_names=tracers, seed=7,
                     coupled_names=(COUPLED, COUPLED[::-1]) if coupled
                     else ())
    opts.write_text(f"circ_fname {circ}\n" + body.format(tracer=tracer))
    t0 = time.perf_counter()
    if gen_a.main(["-o", str(opts), mat]) != 0:
        raise AssertionError(f"gen_a -o {opts} failed")
    return mat, tracer, time.perf_counter() - t0


def phase_upwind3(ck, device, work: Path, card: str) -> dict:
    """12a-c: the upwind3 options file at gx3deep through the port's gen_a
    CLI, then (a) run_solve over the four tracers at f64, (b) at f32, (c)
    the facade on the mesh engine in an NCCL world of one rank."""
    import torch
    import torch.distributed as dist
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        load_ind_maps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import (
        init_process_group, make_mesh)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.memplan import (
        plan_memory)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
        MultifrontalFactorization)
    mat, tracer, t_gen = make_config(work / "upwind3", GX3DEEP, UPWIND3_OPTS,
                                     TRACERS, upwind3=True)
    vars_arg = ",".join(TRACERS)

    # (a) f64, single device
    a = reference_solve(ck, device, mat, tracer, vars_arg, "f64")
    fac = a["fac"]
    plans = fac.engine.plans
    a.update(gen_a_s=t_gen, **steady(fac, a["A"], a["Bm"]))
    a["breakdown"] = stage_breakdown(fac, device)
    kern64 = refactor_kernel_ms(ck, device, plans, fac._fac_matrix.nzval)
    sym, A, Bm = fac.sym, a["A"], a["Bm"]
    X64 = solutions(mat, a["out_file"])
    say(f"phase 12a upwind3 gx3deep f64 {tuple(GX3DEEP.values())}: gen_A "
        f"{t_gen:.2f} s, flat_len {a['flat_len']}, nnz {a['nnz']} "
        f"({a['nnz'] / a['flat_len']:.2f} a row), ELL width {a['max_W']}, "
        f"rounds (B, P, N) {a['rounds']}")
    say(f"phase 12a: cold factor {a['cold_factor_s']:.3f} s, steady factor "
        f"{a['steady_factor_s']:.4f} s, 4-RHS solve {a['solve_4rhs_s']:.4f} "
        f"s (median of 5 {a['solve_4rhs_median_s']:.4f} s), residuals "
        f"{a['residuals']} (long double), refiner {a['refiner']}; peak "
        f"{a['peak_mem_gb']:.2f} GB against plan_memory "
        f"{a['plan_peak_gb']:.2f} GB; K1 {a['launches']['pivoted_panel_f64']}"
        f" and K3 {a['launches']['ell_assemble_f64']} launches; K1 "
        f"{kern64['K1']['ms']:.3f} ms per factor ({kern64['K1']['panels']} "
        f"panels, bound {kern64['K1']['bound_ms']:.4f}, plain "
        f"{kern64['K1']['plain_ms']:.1f}, lu_factor_ex "
        f"{kern64['K1']['library_ms']:.3f}), K3 {kern64['K3']['ms']:.3f} ms "
        f"(bound {kern64['K3']['bound_ms']:.4f}, plain "
        f"{kern64['K3']['plain_ms']:.3f}, index_put_ "
        f"{kern64['K3']['library_ms']:.3f}), all bitwise equal; "
        f"synchronized refactor {a['breakdown']['synced_refactor_ms']:.1f} "
        f"ms, exclusive ms {a['breakdown']['stages_ms']}, rest of "
        f"partial_factor {a['breakdown']['partial_factor_rest_split_ms']} "
        f"[{card}]")
    print_rounds("12a", "upwind3 gx3deep f64 leaf 32", a["breakdown"], card)
    del fac, a["fac"]
    torch.cuda.empty_cache()

    # (b) f32: the rounds with P >= HI_ROUND_MIN_P substitute in float64
    hi_want = {r for r, p in enumerate(plans)
               if p.P >= mf_torch.HI_ROUND_MIN_P}
    if not hi_want:
        raise AssertionError("upwind3 gx3deep has no round with P >= "
                             f"{mf_torch.HI_ROUND_MIN_P}")
    swept = []
    real_fwd = mf_torch.TorchMultifrontal._fwd

    def fwd(self, rnd, W, cc, hi):
        if self.prec == torch.float32:
            swept.append((rnd, hi))
        return real_fwd(self, rnd, W, cc, hi)
    mf_torch.TorchMultifrontal._fwd = fwd
    try:
        b = reference_solve(ck, device, mat, tracer, vars_arg, "f32")
    finally:
        mf_torch.TorchMultifrontal._fwd = real_fwd
    n = len(plans)
    sweeps = [swept[i:i + n] for i in range(0, len(swept), n)]
    if not sweeps or any({r for r, hi in s if hi} != hi_want
                         or [r for r, _ in s] != list(range(n))
                         for s in sweeps):
        raise AssertionError(f"f32 sweeps ran _hi_round on "
                             f"{[sorted(r for r, hi in s if hi) for s in sweeps]}"
                             f", want {sorted(hi_want)}")
    refiner32 = (b["escalation"]["refiner"] if b["escalated"]
                 else b["refiner"])
    b["tier"] = ("escalated to f64" if b["escalated"] else
                 "fused f32 FGMRES" if "gmres" in refiner32["phases"]
                 else "plain IR")
    kern32 = refactor_kernel_ms(ck, device, plans,
                                b["fac"]._fac_matrix.nzval, "f32")
    say(f"phase 12b upwind3 gx3deep f32: {len(sweeps)} f32 sweep(s), each "
        f"with _hi_round on exactly the rounds with P >= "
        f"{mf_torch.HI_ROUND_MIN_P} {sorted(hi_want)} "
        f"{[plans[r].P for r in sorted(hi_want)]}; tier: {b['tier']} "
        f"(f32 refiner {refiner32}); K2 "
        f"{b['launches']['pivoted_panel_f32']} and K3-f32 "
        f"{b['launches']['ell_assemble_f32']} launches per f32 factor (K1 "
        f"{b['launches']['pivoted_panel_f64']}, K3-f64 "
        f"{b['launches']['ell_assemble_f64']} after escalation); cold "
        f"{b['cold_factor_s']:.3f} s, escalate {b['escalate_s']} s, "
        f"run_solve {b['run_solve_s']:.2f} s; residuals {b['residuals']}; "
        f"peak {b['peak_mem_gb']:.2f} GB; K2 {kern32['K1']['ms']:.3f} ms "
        f"per factor (bound {kern32['K1']['bound_ms']:.4f}, plain "
        f"{kern32['K1']['plain_ms']:.1f}, lu_factor_ex "
        f"{kern32['K1']['library_ms']:.3f}), K3-f32 "
        f"{kern32['K3']['ms']:.3f} ms (bound "
        f"{kern32['K3']['bound_ms']:.4f}, plain "
        f"{kern32['K3']['plain_ms']:.3f}, index_put_ "
        f"{kern32['K3']['library_ms']:.3f}), all bitwise equal [{card}]")
    del b["fac"]
    torch.cuda.empty_cache()

    # (c) the mesh engine, an NCCL world of one, on 12a's symbolic plan
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    dev = init_process_group(device, 0, 1, str(work / "nccl_store_12"))
    small = []
    real_small = mf_torch.partial_factor_small_batch
    mf_torch.partial_factor_small_batch = (
        lambda *a_, **k: small.append(1) or real_small(*a_, **k))
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        reset_counts(ck, dev)
        t0 = time.perf_counter()
        mfac = MultifrontalFactorization(matrix, maps=maps, sym=sym,
                                         device=dev,
                                         mesh=make_mesh(1, ("front",)))
        t_cold = time.perf_counter() - t0
        X = mfac.solve(Bm)
        launches = dict(ck.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        mplans = mfac.engine.plans
        want_k1 = sum(math.ceil(p.P / 128) for p in mplans)
        if (launches["pivoted_panel_f64"] != want_k1
                or launches["ell_assemble_f64"] != len(mplans)
                or launches["pivoted_panel_f32"]
                or launches["ell_assemble_f32"] or small):
            raise AssertionError(f"12c mesh of one: launches {launches}, "
                                 f"{len(small)} library LU calls, want K1 "
                                 f"{want_k1} and K3 {len(mplans)}")
        rel = max_rel(A, X, Bm)
        if not rel <= 1e-10:
            raise AssertionError(f"12c mesh of one residual {rel:.3e}")
        agree = solutions_agree(X, X64, "12c mesh of one against 12a")
        t0 = time.perf_counter()
        mfac.refactor()
        t_steady = time.perf_counter() - t0
        t0 = time.perf_counter()
        mfac.solve(Bm)
        t_solve = time.perf_counter() - t0
        planned = plan_memory(mplans, 1, 8).peak_per_device
        del mfac
        torch.cuda.empty_cache()
        top = treetop_panel_ms(ck, dev, mplans, seed=600)
    finally:
        mf_torch.partial_factor_small_batch = real_small
        dist.destroy_process_group()
    if not (top["tall"] and top["slab"]):
        raise AssertionError(f"12c: no tree-top panel over {TALL_R} rows "
                             f"in column slabs: {top}")
    c = dict(launches=launches, treetop_panels=top["panels"],
             tallest_R=top["tallest_R"], tallest_config=top["tallest_config"],
             tall_panels=top["tall"], residual=rel, solutions_diff=agree,
             cold_facade_s=t_cold, steady_factor_s=t_steady,
             solve_4rhs_s=t_solve, peak_mem_gb=peak / 1e9,
             plan_peak_gb=planned / 1e9,
             k1_per_factor={k: kern64["K1"][k] + top[k] for k in
                            ("ms", "plain_ms", "library_ms", "bound_ms")})
    say(f"phase 12c upwind3 gx3deep, mesh of one (NCCL): K1 "
        f"{launches['pivoted_panel_f64']} launches per factor (every round; "
        f"{top['panels']} tree-top panels, {top['tall']} of them over "
        f"{TALL_R} rows, all bitwise equal to the plain version; tallest R "
        f"{top['tallest_R']} at (C, nb) = {top['tallest_config']}), K3 "
        f"{launches['ell_assemble_f64']}, no library LU; residual "
        f"{rel:.3e}, solutions {agree:.2e} of the largest entry from 12a's; "
        f"cold {t_cold:.2f} s, steady factor {t_steady:.4f} s, 4-RHS solve "
        f"{t_solve:.4f} s, peak {peak / 1e9:.2f} GB against plan "
        f"{planned / 1e9:.2f} GB; K1 per factor "
        f"{c['k1_per_factor']['ms']:.3f} ms (tree-top {top['ms']:.3f}), "
        f"bound {c['k1_per_factor']['bound_ms']:.4f}, lu_factor_ex "
        f"{c['k1_per_factor']['library_ms']:.3f}, plain "
        f"{c['k1_per_factor']['plain_ms']:.1f} [{card}]")
    stats = dict(card=card, a=brief(a), b=brief(b), c=c, kern64=kern64,
                 kern32=kern32)
    say("phase 12a-c upwind3 gx3deep: " + json.dumps(stats, default=str))
    return stats


def phase_coupled(ck, device, work: Path, card: str) -> dict:
    """12d: the coupled PO4-DOP options file at gx3 through the port's
    gen_a CLI, then run_solve -v OCMIP_BGC_PO4,OCMIP_BGC_DOP at f64: each
    tracer's own rows of the residual, land cells bit for bit, both
    tracers written."""
    import torch
    mat, tracer, t_gen = make_config(work / "coupled", GX3, COUPLED_OPTS,
                                     COUPLED, upwind3=False)
    d = reference_solve(ck, device, mat, tracer, ",".join(COUPLED), "f64",
                        groups=[COUPLED])
    fac = d["fac"]
    A = d["A"]
    tsl = A.shape[0] // 2
    coo = A.tocoo()
    cross = int(((coo.row < tsl) != (coo.col < tsl)).sum())
    if fac.matrix.coupled_tracer_cnt != 2 or not cross:
        raise AssertionError(f"12d: {cross} cross-tracer entries")
    before, after = (solutions(mat, f, COUPLED)
                     for f in (tracer, d["out_file"]))
    if (before == after).all(axis=0).any():
        raise AssertionError("12d: a coupled tracer was not written")
    d.update(gen_a_s=t_gen, cross_entries=cross,
             **steady(fac, A, d["Bm"]))
    d["breakdown"] = stage_breakdown(fac, device)
    kern = refactor_kernel_ms(ck, device, fac.engine.plans,
                              fac._fac_matrix.nzval)
    say(f"phase 12d coupled PO4-DOP gx3 f64: gen_A {t_gen:.2f} s, flat_len "
        f"{d['flat_len']} (2 x {tsl}), nnz {d['nnz']} ({cross} in the "
        f"cross-tracer blocks), rounds (B, P, N) {d['rounds']}; residuals "
        f"{d['residuals']} (each tracer's own rows, long double), land "
        f"cells bit for bit, both tracers written; cold factor "
        f"{d['cold_factor_s']:.3f} s, steady {d['steady_factor_s']:.4f} s, "
        f"solve {d['solve_4rhs_s']:.4f} s, refiner {d['refiner']}, peak "
        f"{d['peak_mem_gb']:.2f} GB against plan {d['plan_peak_gb']:.2f} GB; "
        f"K1 {d['launches']['pivoted_panel_f64']} and K3 "
        f"{d['launches']['ell_assemble_f64']} launches; K1 "
        f"{kern['K1']['ms']:.3f} ms per factor (bound "
        f"{kern['K1']['bound_ms']:.4f}, plain {kern['K1']['plain_ms']:.1f}, "
        f"lu_factor_ex {kern['K1']['library_ms']:.3f}), K3 "
        f"{kern['K3']['ms']:.3f} ms (bound {kern['K3']['bound_ms']:.4f}, "
        f"plain {kern['K3']['plain_ms']:.3f}, index_put_ "
        f"{kern['K3']['library_ms']:.3f}), bitwise equal; synchronized "
        f"refactor {d['breakdown']['synced_refactor_ms']:.1f} ms, exclusive "
        f"ms {d['breakdown']['stages_ms']} [{card}]")
    del fac, d["fac"]
    torch.cuda.empty_cache()
    return dict(d=brief(d), kern=kern)


def phase_nk_loop_f32(ck, device, work: Path, card: str) -> dict:
    """12e: drivers.nk_loop.run_nk_loop at gx3deep (bench's options,
    phase 8's problem), f32, 4 RHS, 3 iterations: each refactor's
    launches at the factor dtype it ran at, which iteration escalated,
    every residual <= 1e-10; then K2 and K3-f32 at the loop's shapes."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import nk_loop
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf
    matrix, maps, circ = nk_loop.build_problem(GX3DEEP, str(work / "gx3deep"))
    B = np.random.default_rng(0).standard_normal((matrix.flat_len, 4))
    per_refactor = []
    real_refactor = mf.MultifrontalFactorization.refactor

    def counted(self, *a, **kw):
        before = dict(ck.LAUNCHES)
        sfx = ck.SUFFIX[self.engine.prec]
        real_refactor(self, *a, **kw)
        per_refactor.append((sfx, {k: ck.LAUNCHES[k] - before[k]
                                   for k in ck.LAUNCHES}))
    reset_counts(ck, device)
    mf.MultifrontalFactorization.refactor = counted
    try:
        res = nk_loop.run_nk_loop(matrix, maps, circ, B, NK_ITERATIONS,
                                  device=device, precision="f32")
    finally:
        mf.MultifrontalFactorization.refactor = real_refactor
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    fac = res.factorization
    plans = fac.engine.plans
    for it, (sfx, got) in enumerate(per_refactor, 1):
        try:
            expect_launches(got, plans, (sfx,))
        except AssertionError as e:
            raise AssertionError(f"12e iteration {it} ({sfx}): {e}") from None
    escalated = [r["it"] for r in res.rows if r["escalated"]]
    panels = sum(math.ceil(p.P / 128) for p in plans if p.B > 2)
    n32 = 1 + sum(s == "f32" for s, _ in per_refactor)
    n64 = sum(s == "f64" for s, _ in per_refactor) + len(escalated)
    if (len(escalated) > 1
            or launches["pivoted_panel_f32"] != n32 * panels
            or launches["pivoted_panel_f64"] != n64 * panels
            or launches["ell_assemble_f32"] != n32 * len(plans)
            or launches["ell_assemble_f64"] != n64 * len(plans)):
        raise AssertionError(f"12e launches {launches}: want {n32} f32 and "
                             f"{n64} f64 factors of {panels} panels and "
                             f"{len(plans)} rounds (escalated {escalated})")
    for r in res.rows:
        say(f"phase 12e NK iteration {r['it']} (f32 requested): "
            f"{r['factor_dtype']} factors after its solve"
            f"{' (escalated in this solve)' if r['escalated'] else ''}; "
            f"assemble {r['assemble']:.4f} s, refactor {r['refactor']:.3f} "
            f"s (engine {r['refactor_split']['factor']:.3f} s), solve "
            f"{r['solve']:.3f} s, residual {r['residual']:.3e}, refiner "
            f"{r['refiner']} [{card}]")
        if not r["residual"] <= 1e-10:
            raise AssertionError(f"12e iteration {r['it']}: residual "
                                 f"{r['residual']:.3e} > 1e-10")
    kern32 = refactor_kernel_ms(ck, device, plans, fac._fac_matrix.nzval,
                                "f32")
    stats = dict(card=card, escalated_in=escalated,
                 launches=launches, f32_factors=n32, f64_factors=n64,
                 cold_factor_s=res.cold_factor_s, peak_mem_gb=peak / 1e9,
                 iterations=res.rows, kern32=kern32)
    say(f"phase 12e NK loop gx3deep f32: "
        f"{'escalated in iteration ' + str(escalated[0]) if escalated else 'no escalation'}"
        f"; {n32} f32 and {n64} f64 factors ({launches}); cold factor "
        f"{res.cold_factor_s:.2f} s, peak {peak / 1e9:.2f} GB; K2 "
        f"{kern32['K1']['ms']:.3f} ms per f32 factor ({kern32['K1']['panels']}"
        f" panels, bound {kern32['K1']['bound_ms']:.4f}, plain "
        f"{kern32['K1']['plain_ms']:.1f}, lu_factor_ex "
        f"{kern32['K1']['library_ms']:.3f}), K3-f32 "
        f"{kern32['K3']['ms']:.3f} ms (bound {kern32['K3']['bound_ms']:.4f},"
        f" plain {kern32['K3']['plain_ms']:.3f}, index_put_ "
        f"{kern32['K3']['library_ms']:.3f}), bitwise equal [{card}]")
    del fac, res
    torch.cuda.empty_cache()
    return stats


def phase12_kernel_rows(up: dict, coupled: dict, nk32: dict) -> list:
    """The kernels line's rows of phase 12's paths: the launches of each
    path's run, the times of its own shapes per factor (12c: 12a's B > 2
    panels, the same shapes, with the tree-top panels timed in 12c)."""
    rows = []
    for path, sfx, launched, kern in (
            ("upwind3 gx3deep leaf 32 (12a)", "f64", up["a"]["launches"],
             up["kern64"]),
            ("upwind3 gx3deep leaf 32 (12b)", "f32", up["b"]["launches"],
             up["kern32"]),
            ("upwind3 gx3deep mesh of one (12c)", "f64", up["c"]["launches"],
             dict(K1=dict(up["c"]["k1_per_factor"],
                          bound_by=up["kern64"]["K1"]["bound_by"]))),
            ("coupled PO4-DOP gx3 leaf 32 (12d)", "f64",
             coupled["d"]["launches"], coupled["kern"]),
            ("NK loop gx3deep f32, whole loop (12e)", "f32",
             nk32["launches"], nk32["kern32"])):
        for key, name, source, replaces in (
                ("K1", f"pivoted_panel_{sfx}", PANEL_SOURCE,
                 PANEL_REPLACES[sfx]),
                ("K3", f"ell_assemble_{sfx}", ASM_SOURCE, ASM_REPLACES)):
            if key in kern:
                rows.append(dict(
                    name=name, route="cuda", source=source,
                    replaces=replaces, path=path, launches=launched[name],
                    max_abs_err=0.0, **{k: kern[key][k] for k in (
                        "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by")}))
    return rows


# --------------------------------------------------------------------------
# phase 13: the distributed runner (scripts/torch_gx1_dist_run.py), resumed
# --------------------------------------------------------------------------

def written_gb() -> float | None:
    """What this process has written so far, in GB: /proc/self/io's wchar
    (every write call, to files and pipes, of files deleted since
    included), an upper bound of its own disk writes. The writes of a
    child it has reaped (a spawned rank, a subprocess) count only where
    the kernel adds them to the parent's, which not every kernel does.
    None where the system does not count writes."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1]) / 1e9
    except OSError:
        pass
    return None


def phase_dist_runner(work: Path, mat: str, card: str,
                      planned_gb: float) -> dict:
    """scripts/torch_gx1_dist_run.py on phase 5's gx3 matrix as an NCCL
    world of one (``-n 1``) with ``--ckpt``, twice: the first run computes
    and saves every round, the second loads every round and computes
    none, with solutions bit for bit the first's; every residual <= 1e-10
    both times. The runner's ``main`` runs in this process, which has
    imported torch already (its rank is a process of its own, spawned by
    run_world as always), its output sent to a log in the phase's
    directory. Before the first run, what this process has written so far
    (written_gb; where it is not counted, ``planned_gb``, phase 7's
    planned writes) and this phase's planned writes (its checkpointed
    pass, from the runner's own cached symbolic analysis) must stay under
    WRITE_CAP_GB. The checkpoint directory is deleted at the end."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.checkpoint import (
        load_symbolic)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.memplan import (
        checkpoint_disk_plan)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.plan import (
        build_plan)
    # importable by name, so that the spawned rank unpickles rank_main
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_gx1_dist_run as runner
    d = work / "dist_runner"
    ckpt = d / "rounds"
    sym = load_symbolic(runner.symbolic_cached(mat, str(d))[0])
    planned = checkpoint_disk_plan(
        sym, build_plan(sym, read_matrix_file(mat), batch_multiple=1),
        8)[1][-1] / 1e9
    del sym
    before = written_gb()
    total = (planned_gb if before is None else before) + planned
    if total > WRITE_CAP_GB:
        raise AssertionError(f"chip_smoke would write {total:.1f} GB to "
                             f"the disk, over {WRITE_CAP_GB} GB")
    runs = []
    for name in ("first", "resume"):
        out, log = d / f"{name}.npz", d / f"{name}.log"
        t0 = time.perf_counter()
        # the runner's lines and its rank's go to the log (standard
        # output's descriptor, which the spawned rank inherits)
        sys.stdout.flush()
        saved = os.dup(1)
        with open(log, "w") as f:
            os.dup2(f.fileno(), 1)
            try:
                rc = runner.main(["--matrix", mat, "-n", "1", "--device",
                                  "cuda", "--ckpt", str(ckpt), "--cache",
                                  str(d), "--out", str(out)])
            finally:
                sys.stdout.flush()
                os.dup2(saved, 1)
                os.close(saved)
        t = time.perf_counter() - t0
        text = log.read_text()
        last = text.strip().splitlines()[-1] if text.strip() else ""
        if rc != 0 or " distributed: ok=True " not in last:
            raise AssertionError(f"13 {name}: rc {rc}\n{text[-3000:]}")
        with np.load(out) as z:
            runs.append(dict(X=z["X"], st=json.loads(str(z["stats"])),
                             s=t, last=last))
        if name == "first":
            ckpt_gb = sum(f.stat().st_size for f in ckpt.iterdir()) / 1e9
        say(f"phase 13 {name} run: {last} ({t:.1f} s in all; "
            f"{runs[-1]['st']['rounds_computed']} rounds computed, "
            f"{runs[-1]['st']['rounds_loaded']} loaded) [{card}]")
    first, again = runs
    n = first["st"]["rounds"]
    if (first["st"]["rounds_computed"] != n
            or again["st"]["rounds_loaded"] != n
            or again["st"]["rounds_computed"]):
        raise AssertionError(f"13: rounds {first['st']} / {again['st']}")
    if not np.array_equal(first["X"], again["X"]):
        raise AssertionError("13: the resumed run's solutions differ")
    shutil.rmtree(ckpt)
    after = written_gb()
    stats = dict(card=card, rounds=n, round_files_gb=ckpt_gb,
                 written_planned_gb=planned,
                 chip_smoke_written_before_gb=before,
                 chip_smoke_written_planned_gb=total,
                 chip_smoke_written_after_gb=after,
                 first=first["st"], resume=again["st"],
                 first_s=first["s"], resume_s=again["s"])
    say(f"phase 13 scripts/torch_gx1_dist_run.py at gx3, NCCL world of "
        f"one, --ckpt: {n} rounds computed then all {n} loaded, solutions "
        f"bit for bit; round files {ckpt_gb:.2f} GB; before it chip_smoke "
        f"had written {before} GB, with this phase's planned "
        f"{planned:.2f} GB {total:.2f} GB (cap {WRITE_CAP_GB} GB), after "
        f"it {after} GB [{card}]")
    say("phase 13 distributed runner: " + json.dumps(stats))
    return stats


def main() -> int:
    if not (REPO / PKG).is_dir():
        raise SystemExit(f"chip_smoke: {PKG}/ not found next to this script "
                         f"(run it from a checkout of the repository)")
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (the port's smoke run "
                         "needs a card; it has no CPU fallback)")
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import load_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (
        symbolic_from_matrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.device import (
        card_name, resolve_device)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (
        cuda_kernels as ck)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.plan import (
        build_plan)

    # phase 1: device
    device = resolve_device("cuda")
    card = card_name(device)
    say(f"phase 1 device: torch {torch.__version__} cuda "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    # phase 2: build
    t0 = time.perf_counter()
    ck.build()
    say(f"phase 2 build: {time.perf_counter() - t0:.2f} s")
    for line in ck.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip(), file=sys.stderr)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        gx3 = work / "gx3"
        gx3.mkdir()
        t0 = time.perf_counter()
        mat, tracer = make_problem(gx3, GX3, TRACERS)
        matrix = read_matrix_file(mat)
        sym = symbolic_from_matrix(load_ind_maps(mat), matrix)
        plans = build_plan(sym, matrix, batch_multiple=1)
        say(f"phase 3 gx3 problem: flat_len {matrix.flat_len}, nnz "
            f"{matrix.nnz}, rounds (B, P, N) "
            f"{[(p.B, p.P, p.N) for p in plans]} "
            f"({time.perf_counter() - t0:.1f} s)")

        # phase 3: kernels against their plain versions
        panel = {sfx: phase_panel(ck, device, plans, sfx) for sfx in DTYPES}
        asm = {sfx: phase_assemble(ck, device, plans, matrix.nzval, sfx)
               for sfx in DTYPES}
        del matrix

        # phase 4: engine parity
        for precision in DTYPES:
            phase_parity(ck, device, work, precision)

        # phases 5 and 6: main path at f64 factors, then at f32 factors;
        # each kernel reports the launches of the path of its dtype
        launches, main_stats = {}, {}
        for sfx, phase in (("f64", 5), ("f32", 6)):
            launches[sfx], main_stats[sfx] = phase_main(
                ck, device, mat, tracer, sfx, phase, card)

        # phase 7: out of core at f64 on the phase-5 problem
        oocore = phase_oocore(ck, device, work, mat, tracer, sym, plans,
                              main_stats["f64"]["peak_mem_gb"])

        # phase 8: the NK outer loop at gx3deep, f64, 4 RHS
        deep_stats, deep_asm = phase_nk_loop(ck, device, work, card)

        # phase 9: the factor-and-solve bench against scipy on this host
        phase_bench(ck, device, work, card)

        # phase 10: an NCCL world of one, the sharded stencil apply
        phase_mesh(device, work, deep_asm, card)
        del deep_asm

        # phase 11: the mesh engine: (a) an NCCL world of one at gx3deep,
        # (b)-(d) gloo worlds whose ranks share the card
        mesh_one = phase_mesh_of_one(
            ck, device, work, card, deep_stats["kernels_per_refactor"]["K1"])
        phase_gloo_worlds(ck, device, work, mat, card)

        # phase 12: the reference's own assembly configurations, (a)-(c)
        # upwind3 at gx3deep (f64, f32, the mesh of one), (d) the coupled
        # PO4-DOP pair at gx3, (e) the NK loop at gx3deep at f32
        t0 = time.perf_counter()
        up = phase_upwind3(ck, device, work, card)
        coupled = phase_coupled(ck, device, work, card)
        nk32 = phase_nk_loop_f32(ck, device, work, card)
        say(f"phase 12 in all: {time.perf_counter() - t0:.1f} s")

        # phase 13: the distributed runner at gx3, then its resume, in a
        # process of its own: release what this one caches on the card
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_dist_runner(work, mat, card, oocore["disk_written_planned_gb"])
        say(f"phase 13 in all: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for sfx in DTYPES:
        kernels.append(dict(
            name=f"pivoted_panel_{sfx}", route="cuda", source=PANEL_SOURCE,
            replaces=PANEL_REPLACES[sfx],
            launches=launches[sfx][f"pivoted_panel_{sfx}"], **panel[sfx]))
        kernels.append(dict(
            name=f"ell_assemble_{sfx}", route="cuda", source=ASM_SOURCE,
            replaces=ASM_REPLACES,
            launches=launches[sfx][f"ell_assemble_{sfx}"], **asm[sfx]))
    # the mesh path of phase 11a: the same kernels, launched on every
    # round (the tree-top ones included) of one gx3deep factor. K1's times
    # add phase 8's B > 2 panels (the same shapes) to the tree-top panels
    # timed in 11a; K3's are 11a's own, on the mesh engine's rounds
    k3m = mesh_one["mesh_kernels"]["K3"]
    kernels.append(dict(
        name="pivoted_panel_f64", route="cuda", source=PANEL_SOURCE,
        replaces=PANEL_REPLACES["f64"], path="gx3deep mesh of one",
        launches=mesh_one["launches"]["pivoted_panel_f64"], max_abs_err=0.0,
        bound_by="bytes", **mesh_one["k1_per_factor"]))
    kernels.append(dict(
        name="ell_assemble_f64", route="cuda", source=ASM_SOURCE,
        replaces=ASM_REPLACES, path="gx3deep mesh of one",
        launches=mesh_one["launches"]["ell_assemble_f64"], max_abs_err=0.0,
        bound_by="bytes", **{k: k3m[k] for k in ("ms", "plain_ms",
                                                 "library_ms", "bound_ms")}))
    kernels += phase12_kernel_rows(up, coupled, nk32)
    # the refiner's product, which replaces no Pallas kernel; its launches
    # are phase 8's on the main path at that width
    cmv = deep_stats["csr_matvec"]
    for nrhs, r in cmv["rows"].items():
        kernels.append(dict(
            name="csr_matvec_f64", route="cuda", source=MATVEC_SOURCE,
            replaces=None, path=f"gx3deep refiner product, {nrhs} RHS",
            launches=cmv["launches"][nrhs], max_abs_err=0.0,
            bound_by="bytes",
            **{k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                 "bound_ms", "residual_ms",
                                 "scipy_bitwise")}))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
