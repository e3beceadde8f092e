"""Entry points: the forward step on one device, and the multi-rank dry run.

The port of the repository root's ``__graft_entry__.py``:

* ``entry(device)``: the flagship forward step, the matrix-free Jacobian
  stencil operator applied to tracer fields (the compute core of every
  refinement residual), as ``(forward, (x,))`` with x on ``device``;
* ``dryrun_multichip(n_devices, device, backend)``: the whole distributed
  preconditioner workflow (``parallel.dryrun.run``: sharded multifrontal
  factor and solve, sharded stencil apply, checked against SuperLU) on
  ``n_devices`` ranks that it starts itself.

Neither re-executes anything behind the caller's back or reads an
environment variable: the caller names the device, and the backend when
ranks are to share cards.
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device: str | torch.device = "cuda"):
    """(forward, (x,)): forward(x) = A x for the demo assembly's stencil
    operator (``make_demo_assembly(16, 12, 5)``, float64 fields on
    ``device``) and x a float32 field (a standard normal draw of seed 0 on
    the wet cells, repeated over the tracers) on ``device``."""
    from .parallel.demo import make_demo_assembly
    from .parallel.stencil import StencilOperator

    asm, _ = make_demo_assembly(imt=16, jmt=12, km=5)
    op = StencilOperator.from_assembly(asm, device)
    km, jmt, imt = op.shape
    rng = np.random.default_rng(0)
    wet = np.arange(km)[:, None, None] < np.asarray(asm.grid.KMT)[None]
    x = np.where(wet, rng.standard_normal((km, jmt, imt)), 0.0)[None]
    x = torch.from_numpy(np.repeat(x, op.nt, axis=0)).to(
        device=op.device, dtype=torch.float32)

    def forward(xf: torch.Tensor) -> torch.Tensor:
        return op.apply(xf)

    return forward, (x,)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str | None = None) -> None:
    """The distributed dry run (parallel.dryrun.run) on ``n_devices``
    ranks started here: on cuda one card per rank over NCCL (ValueError
    "requested N devices, have M" when there are fewer), or, with
    ``backend="gloo"``, ranks that share the cards there are; on cpu gloo
    ranks. Raises when a rank fails; the first rank prints the summary
    line."""
    from .parallel.dryrun import spawn
    spawn(n_devices, device, backend)
