"""The few collectives of the mesh engine, over one process group.

The JAX package's mesh engine lets GSPMD move the data between devices;
the port says each move itself (``solver/mf_torch.py``):

* ``all_gather``: every rank's slice, concatenated in group-rank order (the
  batch slices of a round's solve results, the trailing-axis slices of a
  row-sharded Schur stack, the "rhs" column blocks of a solve);
* ``all_reduce_sum``: the sum of every rank's partial product, added in
  group-rank order, so that it is the same on every rank and on every run
  (the masked substitution's partial sums);
* ``exchange``: point-to-point sends and receives in one
  ``batch_isend_irecv`` (the Schur fronts a round's extend-add takes from
  other ranks);
* ``broadcast``: one rank's tensor to all (a right-hand-side chunk that one
  rank read);
* ``scatter``: one rank's parts, one to each rank (the latitude bands of
  a field for the sharded stencil, ``parallel/stencil.py``, which also
  gathers its bands and exchanges its halos here).

On NCCL each call runs on the card. On gloo, which takes no CUDA tensors
for most collectives, a CUDA tensor is copied to the host and the result
back: that is how ranks that share one card meet. A group of one rank
(including a process with no process group) communicates nothing. A failed
collective raises; nothing here retries it or carries on without it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Ranks in ``group`` (None: the default group); 1 in a process with no
    process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) concatenated along
    ``dim`` in group-rank order, on every rank, on ``t``'s device."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.contiguous()
    host = _via_host(src, group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``, added in group-rank order on every
    rank: the same bits everywhere and on every run, unlike a reduction
    whose order the library picks."""
    n = group_size(group)
    if n == 1:
        return t
    parts = all_gather(t[None], group)
    acc = parts[0]
    for i in range(1, n):
        acc = acc + parts[i]
    return acc


def exchange(sends: dict, recv_shapes: dict, like: torch.Tensor,
             group) -> dict:
    """Send ``sends[q]`` to group rank q and receive a tensor of
    ``recv_shapes[q]`` (``like``'s dtype and device) from each q, all in
    one batch_isend_irecv; returns {q: received tensor}. Every pair that
    one side sends must be received by the other: the callers build both
    sides from one static plan."""
    if not sends and not recv_shapes:
        return {}
    host = _via_host(like, group)
    dev = torch.device("cpu") if host else like.device
    recvd = {q: torch.empty(shape, dtype=like.dtype, device=dev)
             for q, shape in recv_shapes.items()}
    ops = []
    for q, t in sends.items():
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if host else t,
                              _global(group, q), group))
    for q, buf in recvd.items():
        ops.append(dist.P2POp(dist.irecv, buf, _global(group, q), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host:
        recvd = {q: buf.to(like.device) for q, buf in recvd.items()}
    return recvd


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank (the others pass a tensor
    of the same shape and dtype to receive into); returns it."""
    if group_size(group) == 1:
        return t
    host = _via_host(t, group)
    buf = t.cpu() if host else t.contiguous()
    dist.broadcast(buf, _global(group, src), group=group)
    return buf.to(t.device) if host else buf


def scatter(parts: list | None, out: torch.Tensor, src: int,
            group) -> torch.Tensor:
    """``parts[q]`` of group rank ``src`` written into ``out`` on group
    rank q (one shape on every rank; the ranks other than ``src`` pass
    ``parts`` None); returns ``out``."""
    if group_size(group) == 1:
        return out.copy_(parts[0])
    host = _via_host(out, group)
    buf = out.cpu() if host else out
    if parts is not None:
        parts = [(p.cpu() if host else p).contiguous() for p in parts]
    dist.scatter(buf, parts, src=_global(group, src), group=group)
    return out.copy_(buf) if host else out


def barrier(group) -> None:
    """Wait until every rank of ``group`` is here (a small all-gather on
    the card under NCCL, on the host under gloo)."""
    if group_size(group) > 1:
        nccl = dist.get_backend(group) == "nccl"
        all_gather(torch.zeros(1, device="cuda" if nccl else "cpu"), group)


def _global(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank``."""
    if group is None:
        return rank
    return dist.get_global_rank(group, rank)
