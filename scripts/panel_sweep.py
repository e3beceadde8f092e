#!/usr/bin/env python3
"""Time the port's panel kernel (K1 at f64, K2 at f32) at every cluster
size that fits, on the panel shapes of one gx3 factor, on one CUDA card.

The wrapper (``cuda_kernels.pivoted_panel``) takes its cluster size from
``panel_launch_config``; this script calls the kernel's C entry point
directly with each size C in 1..8 whose slice fits the shared memory, and
checks each result bit for bit against the plain version, so the rule can
be set from measurements. Prints one line per (dtype, shape) with the time
of each C in ms (CUDA events over back-to-back launches) and the rule's
pick, and the card's name and power limit.

Run from the repository root: ``python3 scripts/panel_sweep.py``.
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from nk_ocn_tracer_jacobian_precond_tpu_torch.device import (  # noqa: E402
    card_name)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (  # noqa: E402
    cuda_kernels as ck)

# (B, R) of every panel of the gx3 plan's kernel rounds, T = 128
GX3_ROUNDS = [(256, 512), (128, 256), (256, 128), (64, 512), (32, 512),
              (16, 640), (8, 512), (4, 768)]
SHAPES = sorted({(B, P - off) for B, P in GX3_ROUNDS
                 for off in range(0, P, 128)})


def launch(lib, sfx, Pan, out, piv, perm, p_arr, C, nb):
    B, R, T = Pan.shape
    err = getattr(lib, f"nk_pivoted_panel_{sfx}")(
        Pan.data_ptr(), out.data_ptr(), piv.data_ptr(), perm.data_ptr(),
        p_arr.data_ptr(), B, R, T, 0, 0.05, C, nb,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch {sfx} {B, R, T} C={C}: CUDA error {err}")


def time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("panel_sweep: needs a CUDA device")
    lib = ck.build()
    T = 128
    for sfx, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        for B, R in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(B * 7919 + R)
            Pan = torch.randn((B, R, T), generator=g, dtype=dtype,
                              device="cuda")
            p_arr = torch.full((B,), R // 2, dtype=torch.int32,
                               device="cuda")
            want, wpiv, wperm = ck.pivoted_panel_plain(Pan, 0, p_arr, 0.05)
            pick = ck.panel_launch_config(B, R, T, Pan.element_size(),
                                          ck.active_clusters)
            times = {}
            for C in range(1, ck.PANEL_MAX_CLUSTER + 1):
                rows = -(-R // C)
                if ck.panel_smem_bytes(rows, T, Pan.element_size()) > \
                        ck.SMEM_BLOCK:
                    continue
                out = torch.empty_like(Pan)
                piv = torch.empty((B, T), dtype=torch.int32, device="cuda")
                perm = torch.empty((B, R), dtype=torch.int64, device="cuda")
                launch(lib, sfx, Pan, out, piv, perm, p_arr, C, T)
                torch.cuda.synchronize()
                if not (torch.equal(out, want) and torch.equal(piv, wpiv)
                        and torch.equal(perm, wperm)):
                    raise AssertionError(f"{sfx} {B, R} C={C}: differs "
                                         f"from the plain version")
                times[C] = time_ms(lambda: launch(lib, sfx, Pan, out, piv,
                                                  perm, p_arr, C, T))
            best = min(times, key=times.get)
            print(f"{sfx} (B, R) = {(B, R)}: " + ", ".join(
                f"C={c} {t:.4f}" for c, t in times.items())
                + f"; fastest C={best}, rule C={pick[0]} "
                f"({times[pick[0]]:.4f} ms)", flush=True)
    print(card_name(torch.device("cuda")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
