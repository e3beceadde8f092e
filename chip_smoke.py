#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the torch package's main paths, the ``solve`` workflow at float64
factors and at float32 factors (FGMRES-IR3 refinement, escalating to
float64 when it fails), through the entry points a user calls, and checks
its hand-written CUDA kernels on the way:

1. device: a CUDA card must be present (no CPU fallback);
2. build: compile the kernels from csrc/ with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the gx3 main path gives it and at tall panels (R = 4096 and
   8192) that the panel kernel walks in column slabs (pivots, the
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
   timed, a synchronized stage breakdown of one steady refactor (which
   must call no seq_to_perm) and torch.profiler's kernel count and device
   busy share of another;
6. main path at f32: the same through run_solve(..., precision="f32"): K2
   and K3-f32 on every f32 round, whether the refiner reached the contract
   on f32 factors or the facade escalated to f64 (then K1 and K3-f64 run
   on the refactor), the refiner's phases and cycles, times, peak memory;
   every residual <= 1e-10 either way. When it escalated, the f32 factors
   are then built alone to time their steady refactor and read their own
   peak memory.

Prints one line per phase, the card's name and power limit, one JSON line
of kernel results, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises: the script then exits non-zero without that line.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PKG = "nk_ocn_tracer_jacobian_precond_tpu_torch"
PANEL_SOURCE = f"{PKG}/csrc/pivoted_panel.cu"
ASM_SOURCE = f"{PKG}/csrc/ell_assemble.cu"
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
TRACERS = ("IAGE_CUR", "PO4_CUR", "DOP_CUR", "O2_CUR")
# panel shapes (B, R, T, off): tests/test_pallas_kernels.py's cases, gx3
# plan panels with B > 2, and tall panels that the kernel walks in column
# slabs (R = 4096 and 8192)
PANEL_SHAPES = [(4, 256, 128, 128), (3, 128, 128, 0), (2, 512, 64, 0),
                (2, 128, 128, 0), (256, 512, 128, 0), (16, 640, 128, 0),
                (16, 128, 128, 512), (4, 128, 128, 640), (3, 4096, 128, 0),
                (4, 8192, 128, 0)]


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


def check_panel(ck, device, sfx, B, R, T, off, p_arr, tau, seed):
    """Kernel vs plain on one random panel, required bit for bit (values,
    piv and perm): returns (max abs difference, the input panel)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    Pan = torch.randn((B, R, T), generator=g,
                      dtype=getattr(torch, DTYPES[sfx]), device=device)
    Pk, pk, permk = ck.pivoted_panel(Pan, off, p_arr, tau)
    Pp, pp, permp = ck.pivoted_panel_plain(Pan, off, p_arr, tau)
    sync(device)
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
    return float((Pk - Pp).abs().max()), Pan


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
            e, _ = check_panel(ck, device, sfx, B, R, T, off, mixed, tau,
                               i)
            err = max(err, e)
        full = torch.full((B,), off + R, dtype=torch.int32, device=device)
        _, Pan = check_panel(ck, device, sfx, B, R, T, off, full, 0.0,
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
    shapes: dict = {}
    for p in plans:
        if p.B <= 2:
            continue
        for off in range(0, p.P, 128):
            key = (p.B, p.P - off, min(128, p.P - off), off)
            shapes.setdefault(key, [0, p.p_arr])[0] += 1
    tot = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0)
    bound_by = set()
    for i, ((B, R, T, off), (count, pa)) in enumerate(sorted(shapes.items())):
        p_arr = torch.from_numpy(pa).to(device)
        e, Pan = check_panel(ck, device, sfx, B, R, T, off, p_arr, 0.05,
                             200 + i)
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

def check_tracers(mat: str, before: str, after: str):
    """Residual of every tracer of ``after`` (solved from ``before``),
    land cells unchanged; returns ({tracer: residual}, A, B)."""
    from scipy.io import netcdf_file
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import load_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    matrix = read_matrix_file(mat)
    maps = load_ind_maps(mat)
    A = matrix.to_scipy()
    land = maps.int3_to_ind < 0
    res = {}
    Bm = np.empty((matrix.flat_len, len(TRACERS)))
    with netcdf_file(before, "r", mmap=False) as f0, \
            netcdf_file(after, "r", mmap=False) as f1:
        for j, v in enumerate(TRACERS):
            old = np.array(f0.variables[v].data, dtype=np.float64)
            new = np.array(f1.variables[v].data, dtype=np.float64)
            if not np.array_equal(old[land], new[land]):
                raise AssertionError(f"{v}: land cells changed")
            b, x = maps.flatten_field(old), maps.flatten_field(new)
            if not np.all(np.isfinite(x)) or x.shape != b.shape:
                raise AssertionError(f"{v}: bad solution")
            res[v] = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
            if not res[v] <= 1e-10:
                raise AssertionError(f"{v}: relative residual "
                                     f"{res[v]:.3e} > 1e-10")
            Bm[:, j] = b
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


def steady(fac, A, Bm) -> dict:
    """The steady refactor and one 4-RHS refined solve, timed."""
    t0 = time.perf_counter()
    fac.refactor()              # synchronizes at its end
    t_steady = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = fac.solve(Bm)           # ends in a copy to the host
    t_solve = time.perf_counter() - t0
    rel = np.linalg.norm(A @ X - Bm, axis=0) / np.linalg.norm(Bm, axis=0)
    if not rel.max() <= 1e-10:
        raise AssertionError(f"steady solve residual {rel.max():.3e}")
    return dict(steady_factor_s=t_steady, solve_4rhs_s=t_solve,
                steady_max_residual=float(rel.max()),
                steady_refiner=dict(fac._refiner.stats))


def stage_breakdown(fac, device) -> dict:
    """One steady refactor with a synchronize around each stage of the
    round loop: exclusive ms per stage (a stage's time less that of the
    stages it calls), and the calls of seq_to_perm made in it (none: the
    panel kernel composes the permutation)."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (
        cuda_kernels as ck, mf_torch)
    incl: dict = {}
    child: dict = {}
    calls: dict = {}
    stack: list = []
    top = [0.0]
    patched = []

    def timed_stage(owner, attr, name):
        real = getattr(owner, attr)

        def run(*args, **kw):
            sync(device)
            stack.append(name)
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                sync(device)
                dt = (time.perf_counter() - t0) * 1e3
                stack.pop()
                incl[name] = incl.get(name, 0.0) + dt
                calls[name] = calls.get(name, 0) + 1
                if stack:
                    child[stack[-1]] = child.get(stack[-1], 0.0) + dt
                else:
                    top[0] += dt
        patched.append((owner, attr, real))
        setattr(owner, attr, run)

    sfx = ck.SUFFIX[fac.engine.prec]
    for owner, attr, name in (
            (ck, "ell_assemble", f"K3 ell_assemble_{sfx}"),
            (ck, "pivoted_panel", f"{KID[sfx]} pivoted_panel_{sfx}"),
            (ck, "seq_to_perm", "seq_to_perm"),
            (mf_torch, "extend_add", "extend_add"),
            (mf_torch, "pack_diag_inv", "pack_diag_inv"),
            (mf_torch, "partial_factor_small_batch",
             "tree-top library LU (B <= 2)"),
            (mf_torch, "partial_factor",
             "partial_factor rest (row gather, TRSM, GEMM)")):
        timed_stage(owner, attr, name)
    try:
        t0 = time.perf_counter()
        fac.refactor()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, real in reversed(patched):
            setattr(owner, attr, real)
    # (on the CPU the plain panel composes it through seq_to_perm)
    if device.type == "cuda" and calls.get("seq_to_perm", 0):
        raise AssertionError(f"the steady refactor called seq_to_perm "
                             f"{calls['seq_to_perm']} times")
    excl = {k: v - child.get(k, 0.0) for k, v in incl.items()}
    stages = {k: round(v, 3)
              for k, v in sorted(excl.items(), key=lambda kv: -kv[1])}
    stages["engine walk outside the stages"] = round(wall - top[0], 3)
    return dict(synced_refactor_ms=round(wall, 3), stages_ms=stages,
                stage_calls=calls)


def device_busy(fac, device) -> dict:
    """torch.profiler over one steady refactor: CUDA kernels launched and
    the union of their intervals as a share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fac.refactor()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    names: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    return dict(profiled_refactor_ms=round(wall_us / 1e3, 3),
                device_kernels=len(spans),
                device_busy_share=(round(busy / wall_us, 4) if spans
                                   else "not measured"),
                top_kernels_by_count=top)


def phase_main(ck, device, mat: str, tracer: str, precision: str,
               phase: int) -> dict:
    """drivers.solve.run_solve over the four tracers at ``precision``,
    from a copy of the original tracer file; the launch counts of the run
    are returned."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.solve import (
        run_solve)

    out_file = f"{tracer}.{precision}.nc"
    shutil.copy(tracer, out_file)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    for k in ck.LAUNCHES:
        ck.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    out = run_solve(mat, out_file, ",".join(TRACERS), device=device,
                    precision=precision)
    t_run = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    fac = out["factorization"]
    plans = fac.engine.plans
    escalated = fac.escalation is not None
    if precision == "f64":
        expect_launches(launches, plans, ("f64",))
    else:
        expect_launches(launches, plans,
                        ("f32", "f64") if escalated else ("f32",))
    fac.validate()
    res, A, Bm = check_tracers(mat, tracer, out_file)
    peak_cold = torch.cuda.max_memory_allocated(device)
    run_refiner = dict(fac._refiner.stats)
    t = fac.timings
    stats = dict(
        precision=precision, factor_dtype=str(fac.engine.prec),
        escalated=escalated, escalation=fac.escalation,
        flat_len=A.shape[0], nnz=A.nnz,
        rounds=len(plans), max_P=max(p.P for p in plans),
        max_N=max(p.N for p in plans), run_solve_s=t_run,
        symbolic_s=t["symbolic"], escalate_s=t.get("escalate"),
        cold_factor_s=t["equilibrate"] + t["plan"] + t["factor"],
        run_refiner=run_refiner, max_residual=float(max(res.values())),
        peak_mem_gb=peak_cold / 1e9)
    stats.update(steady(fac, A, Bm))
    if precision == "f64":
        stats["breakdown"] = stage_breakdown(fac, device)
        try:
            stats["profile"] = device_busy(fac, device)
        except Exception as e:  # noqa: BLE001 - a measurement, not a check
            stats["profile"] = f"not measured ({type(e).__name__}: {e})"
    stats.update(peak_mem_after_refactor_gb=torch.cuda.max_memory_allocated(
        device) / 1e9, launches=launches)
    if precision == "f32" and escalated:
        stats.update(f32_alone(fac, device))
    say(f"phase {phase} main path gx3 {precision}: " + json.dumps(stats))
    return launches


def f32_alone(fac, device) -> dict:
    """The gx3 f32 factors never reach a refactor on the main path (it
    escalates): drop the facade's f64 engine, build the f32 factors
    alone, time their steady refactor and read their own peak."""
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
    return dict(f32_alone_cold_factor_s=cold,
                f32_alone_steady_factor_s=t_steady,
                f32_alone_peak_mem_gb=torch.cuda.max_memory_allocated(
                    device) / 1e9)


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
        resolve_device)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (
        cuda_kernels as ck)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.plan import (
        build_plan)

    # phase 1: device
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed (rc {smi.returncode}): "
                           f"{smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
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
        del plans, sym, matrix

        # phase 4: engine parity
        for precision in DTYPES:
            phase_parity(ck, device, work, precision)

        # phases 5 and 6: main path at f64 factors, then at f32 factors;
        # each kernel reports the launches of the path of its dtype
        launches = {"f64": phase_main(ck, device, mat, tracer, "f64", 5),
                    "f32": phase_main(ck, device, mat, tracer, "f32", 6)}

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
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
