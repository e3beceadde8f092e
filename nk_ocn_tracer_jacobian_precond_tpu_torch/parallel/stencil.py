"""Matrix-free stencil SpMV operator — the device-native form of the Jacobian.

The assembled Jacobian's structured form (per-offset dense coefficient
fields, ops/assemble.py) applies to tracer fields directly as shifted
multiply-adds: no CSR gather/scatter, fully vectorized. Used for residual
computation in iterative refinement and as the operator for Krylov solves.

The port of the JAX package's ``parallel/stencil.py`` on torch devices:
``_sanitize`` is the reference's host numpy; ``apply`` and
``matvec_factory`` run on the device that holds the operator's fields
(``from_assembly(asm, device)``, ``to(device)``). ``sharded_apply_factory``
shards the latitude axis over the ranks of a ``parallel.mesh.Mesh`` (one
band of rows per rank, fields padded so the band count divides jmt) with a
halo of 2 rows from each side exchanged over the ring of bands by
point-to-point sends (the JAX package's ``ppermute`` pair): the
replacement for the reference's MPI block-row partition
(src/solve_ABdist.c:139-144). Its scatter, gather and halo exchange go
through ``parallel.collectives``, so ranks that share a card over gloo
exchange their CUDA bands through the host. It never computes a band
count above 1 on one device: without a process group it raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.assemble import Assembly
from ..ops.offsets import target_wet, wet3d
from . import collectives as coll
from .mesh import Mesh


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
class BandLayout:
    """Where the bands of a padded field of ``shape`` (nt, km, jmt_pad,
    imt) live: band s, rows [s * rows, (s + 1) * rows), on the mesh's
    rank s, at ``dtype`` on ``device``. It takes the place of the JAX
    package's NamedSharding and device_put."""
    mesh: Mesh
    rows: int
    shape: tuple
    dtype: torch.dtype
    device: torch.device

    def scatter(self, x: torch.Tensor | None) -> torch.Tensor:
        """This rank's band of the padded field ``x`` that the mesh's first
        rank holds (the other ranks pass None). Collective."""
        out = torch.empty(self.shape[:2] + (self.rows,) + self.shape[3:],
                          dtype=self.dtype, device=self.device)
        parts = None
        if self.mesh.coords[0] == 0:
            if x is None or tuple(x.shape) != self.shape:
                raise ValueError(f"scatter takes a padded field of shape "
                                 f"{self.shape}, got "
                                 f"{None if x is None else tuple(x.shape)}")
            x = x.to(device=self.device, dtype=self.dtype)
            if self.mesh.size == 1:
                return x
            parts = list(x.split(self.rows, dim=2))
        return coll.scatter(parts, out, 0, self.mesh.group)

    def gather(self, y_l: torch.Tensor) -> torch.Tensor:
        """The padded field of every rank's band ``y_l``, on every rank.
        Collective."""
        return coll.all_gather(y_l, self.mesh.group, dim=2)


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
        return self._sum(x, lambda off: _shift_x(x, *off))

    def _sum(self, x: torch.Tensor, shifted) -> torch.Tensor:
        """y = A x over the rows of x that the fields cover, with the x of
        each offset from ``shifted(off)``: the one sum of ``apply`` and of
        the sharded apply's bands, in one order."""
        y = self.selfs * x
        for o, off in enumerate(self.offsets):
            y = y + self.coefs[o][None] * shifted(off)
        if self.vmix is not None:
            y = y + torch.einsum("bkji,tbji->tkji", self.vmix.to(x.dtype), x)
        for t, sd in enumerate(self.sink):
            if sd is not None:
                y[t] += torch.einsum("bkji,bji->kji", sd.to(x.dtype), x[t])
        for (t, t2), arr in self.cross.items():
            y[t] += arr * x[t2]
        return y

    # -- mesh-sharded apply ------------------------------------------------

    def sharded_apply_factory(self, mesh: Mesh, axis: str = "band"):
        """y = A x over latitude bands of ``mesh``, a 1-D mesh over
        ``axis`` (parallel.mesh.make_mesh), on the operator's device.

        The fields are padded with zero rows so the band count divides
        jmt, and each rank keeps only its band of them. A call exchanges
        a halo of 2 rows (the widest stencil reach, upwind3's j +- 2) with
        the neighbouring bands on the ring (s - 1, s + 1 mod nband); one
        band wraps its own halo. Each band then sums as ``apply`` does, so
        one band gives ``apply``'s bits. Returns (apply_fn, layout,
        pad_field, unpad_field): ``apply_fn`` maps this rank's band of x
        to its band of y, ``layout`` (a BandLayout) scatters a padded
        field to the bands and gathers them back, ``pad_field`` /
        ``unpad_field`` pad a (nt, km, jmt, imt) field to the padded rows
        and cut them off again."""
        if tuple(mesh.axis_names) != (axis,):
            raise ValueError(f"the sharded apply takes a 1-D mesh over "
                             f"{axis!r}, not axes {mesh.axis_names}")
        if mesh.coords is None:
            raise ValueError("this rank is outside the mesh")
        nband = mesh.shape[0]
        if nband > 1 and not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"a mesh of {nband} bands needs an initialized process group "
                f"(parallel.mesh.init_process_group); the sharded apply "
                f"does not compute on one device")
        km, jmt, imt = self.shape
        jmt_pad = -(-jmt // nband) * nband
        pad = jmt_pad - jmt
        rows = jmt_pad // nband
        if rows < 2:
            raise ValueError(f"{nband} bands of {jmt} rows: a band needs at "
                             f"least 2 rows for the width-2 halo")
        s = mesh.coords[0]
        lo_row, hi_row = s * rows, min((s + 1) * rows, jmt)

        def band(a):
            """This band's rows of a field, j its second-to-last axis
            (axis 2 of coefs, selfs, vmix and sink, axis 1 of cross), with
            the padding rows as zeros; a copy, so the whole field can go."""
            a = a[..., lo_row:max(hi_row, lo_row), :]
            extra = rows - a.shape[-2]
            return F.pad(a, (0, 0, 0, extra)) if extra else a.clone()

        local = StencilOperator(
            offsets=list(self.offsets), coefs=band(self.coefs),
            selfs=band(self.selfs),
            vmix=None if self.vmix is None else band(self.vmix),
            sink=[None if sd is None else band(sd) for sd in self.sink],
            cross={k: band(v) for k, v in self.cross.items()},
            nt=self.nt, shape=(km, rows, imt))
        layout = BandLayout(mesh=mesh, rows=rows,
                            shape=(self.nt, km, jmt_pad, imt),
                            dtype=self.selfs.dtype, device=self.device)
        nxt, prv = (s + 1) % nband, (s - 1) % nband
        halo = (self.nt, km, 2, imt)

        def apply_fn(x_l: torch.Tensor) -> torch.Tensor:
            if x_l.shape != (self.nt, km, rows, imt):
                raise ValueError(f"band of shape {tuple(x_l.shape)}, want "
                                 f"{(self.nt, km, rows, imt)}")
            if nband == 1:
                lo, hi = x_l[:, :, -2:, :], x_l[:, :, :2, :]
            else:
                # the last rows to the next band (its south halo), the
                # first rows to the previous one (its north), stacked in
                # that order when both are one band (a ring of two)
                sends = {nxt: [x_l[:, :, -2:]]}
                sends.setdefault(prv, []).append(x_l[:, :, :2])
                got = coll.exchange(
                    {q: torch.stack(ts) for q, ts in sends.items()},
                    {q: (len(ts),) + halo for q, ts in sends.items()},
                    x_l, mesh.group)
                lo, hi = got[prv][0], got[nxt][-1]
            xh = torch.cat([lo, x_l, hi], dim=2)
            return local._sum(x_l,
                              lambda off: _shift_x(xh, *off)[:, :, 2:-2, :])

        def pad_field(x: torch.Tensor) -> torch.Tensor:
            return F.pad(x, (0, 0, 0, pad)) if pad else x

        def unpad_field(y: torch.Tensor) -> torch.Tensor:
            return y[:, :, :jmt, :]

        return apply_fn, layout, pad_field, unpad_field

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
