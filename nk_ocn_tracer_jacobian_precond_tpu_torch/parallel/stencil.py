"""Matrix-free stencil SpMV operator — the device-native form of the Jacobian.

The assembled Jacobian's structured form (per-offset dense coefficient
fields, ops/assemble.py) applies to tracer fields directly as shifted
multiply-adds: no CSR gather/scatter, fully vectorized. Used for residual
computation in iterative refinement and as the operator for Krylov solves.

The port of the JAX package's ``parallel/stencil.py`` on one torch device:
``_sanitize`` is the reference's host numpy; ``apply`` and
``matvec_factory`` run on the device that holds the operator's fields
(``from_assembly(asm, device)``, ``to(device)``). The latitude-band
sharded apply (``sharded_apply_factory``, halo exchange between devices)
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.assemble import Assembly
from ..ops.offsets import target_wet, wet3d


def _sanitize(asm: Assembly):
    """Zero coefficients at invalid (row, target) pairs so the dense fields
    are safe to multiply everywhere (the CSR emission masks these; the
    stencil operator needs clean zeros instead)."""
    grid = asm.grid
    km = grid.km
    KMT = np.asarray(grid.KMT)
    wet = wet3d(KMT, km)
    offsets = []
    coefs = []
    for off, arr in asm.shared.items():
        if off == (0, 0, 0):
            continue
        valid = wet & target_wet(KMT, km, *off)
        offsets.append(off)
        coefs.append(np.where(valid, arr, 0.0))
    selfs = np.stack([np.where(wet, s, 0.0) for s in asm.self_full])
    kk = np.arange(km)[:, None, None]
    vmix = None
    if asm.vmix_dense is not None:
        valid = wet[None, :] & (np.arange(km)[:, None, None, None] < KMT[None, None])
        vmix = np.where(valid, asm.vmix_dense, 0.0)
    sink = []
    for t, sd in enumerate(asm.sink_dense):
        if sd is None:
            sink.append(None)
        else:
            valid = wet[None, :] & (np.arange(km)[:, None, None, None] <= kk[None])
            sink.append(np.where(valid, sd, 0.0))
    cross = {}
    for (t, t2), arr in asm.cross.items():
        cross[(t, t2)] = np.where(wet, arr, 0.0)
    return offsets, coefs, selfs, vmix, sink, cross


def _shift_x(x, dk, dj, di):
    """x (..., km, j, i) -> x at (k+dk, j+dj, i+di); i and j wrap, k
    zero-pads. Returns a new tensor (torch.roll copies); the wrapped k rows
    are zeroed in that copy, never in x."""
    if dk:
        x = torch.roll(x, -dk, dims=-3)
        if dk > 0:
            x[..., -dk:, :, :] = 0.0
        else:
            x[..., :-dk, :, :] = 0.0
    if dj:
        x = torch.roll(x, -dj, dims=-2)
    if di:
        x = torch.roll(x, -di, dims=-1)
    return x


@dataclass
class StencilOperator:
    offsets: list[tuple[int, int, int]]
    coefs: torch.Tensor        # (n_off, km, jmt, imt), shared across tracers
    selfs: torch.Tensor        # (nt, km, jmt, imt)
    vmix: torch.Tensor | None  # (km2, km, jmt, imt)
    sink: list                 # per tracer: (km2, km, jmt, imt) or None
    cross: dict                # (t, t2) -> (km, jmt, imt)
    nt: int
    shape: tuple               # (km, jmt, imt)

    @classmethod
    def from_assembly(cls, asm: Assembly,
                      device: str | torch.device = "cuda"
                      ) -> "StencilOperator":
        """The operator of ``asm``'s fields, float64, on ``device`` (cuda
        by default; cpu only when named)."""
        offsets, coefs, selfs, vmix, sink, cross = _sanitize(asm)
        return cls(offsets=offsets,
                   coefs=torch.from_numpy(
                       np.stack(coefs) if coefs else
                       np.zeros((0,) + selfs.shape[1:])),
                   selfs=torch.from_numpy(selfs),
                   vmix=None if vmix is None else torch.from_numpy(vmix),
                   sink=[None if s is None else torch.from_numpy(s)
                         for s in sink],
                   cross={k: torch.from_numpy(v) for k, v in cross.items()},
                   nt=asm.nt,
                   shape=(asm.grid.km, asm.grid.jmt, asm.grid.imt)
                   ).to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.selfs.device

    def to(self, device: str | torch.device) -> "StencilOperator":
        """A copy of the operator with its fields on ``device``."""
        conv = lambda a: None if a is None else a.to(device)
        return StencilOperator(
            offsets=self.offsets, coefs=conv(self.coefs),
            selfs=conv(self.selfs), vmix=conv(self.vmix),
            sink=[conv(s) for s in self.sink],
            cross={k: conv(v) for k, v in self.cross.items()},
            nt=self.nt, shape=self.shape)

    # -- single-device apply ----------------------------------------------

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x on tracer fields; x, y are (nt, km, jmt, imt) with zeros
        on land, on the operator's device. The dense vmix and sink blocks
        contract at x's dtype."""
        y = self.selfs * x
        for o, off in enumerate(self.offsets):
            y = y + self.coefs[o][None] * _shift_x(x, *off)
        if self.vmix is not None:
            y = y + torch.einsum("bkji,tbji->tkji", self.vmix.to(x.dtype), x)
        for t, sd in enumerate(self.sink):
            if sd is not None:
                y[t] += torch.einsum("bkji,bji->kji", sd.to(x.dtype), x[t])
        for (t, t2), arr in self.cross.items():
            y[t] += arr * x[t2]
        return y

    # -- flat-vector interface (for refinement / Krylov) -------------------

    def matvec_factory(self, maps):
        """Return a flat-vector matvec using the index maps: y = A x for a
        (flat_len,) tensor x on the operator's device."""
        def put(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(
                self.device)

        scat_k, scat_j, scat_i = (put(maps.ind_to_k), put(maps.ind_to_j),
                                  put(maps.ind_to_i))
        tsl = maps.tracer_state_len
        nt = self.nt
        km, jmt, imt = self.shape

        def matvec(xflat: torch.Tensor) -> torch.Tensor:
            x = xflat.new_zeros((nt, km, jmt, imt))
            x[:, scat_k, scat_j, scat_i] = xflat.reshape(nt, tsl)
            y = self.apply(x)
            return y[:, scat_k, scat_j, scat_i].reshape(nt * tsl)

        return matvec
