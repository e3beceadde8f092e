"""Plan-level memory accounting (host side, exact to the padded shapes).

The reference's distributed mode exists because the factors outgrow one
node's memory (src/solve_ABdist.c:106-244 block-row-distributes the
matrix; SuperLU_DIST distributes L/U over the process grid). The TPU
rebuild's equivalent question — "how many chips does this problem need?"
— is answerable *before* factorization, because the round plans fix every
padded shape. This module walks a plan and reports:

  * resident factor bytes per round (K (B,P,P) + U12 (B,P,M) +
    L21 (B,M,P) + perm, plus the replicated KD diagonal stack on
    masked row-sharded rounds),
  * the Schur-complement live set over the round schedule (a round's
    (B,M,M) stack stays allocated until its last consuming round), and
  * the per-round transient peak (the full (B,N,N) front stack plus the
    bounded extend-add temporaries),

each split replicated-vs-sharded for an n_devices mesh (rounds whose
batch divides the mesh shard over it; tree-top rounds stay replicated —
mirroring JaxMultifrontal._put).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MemoryPlan:
    n_devices: int
    bytes_per_elem: int
    factor_bytes_total: int       # all rounds' FP+L21+perm
    factor_bytes_per_device: int  # with sharded rounds divided by n_devices
    schur_peak_bytes: int         # max live Schur set (total, un-sharded)
    schur_peak_per_device: int
    transient_peak_bytes: int     # largest single-round working set (total)
    transient_peak_per_device: int
    rounds: list[dict]            # per-round breakdown

    @property
    def peak_per_device(self) -> int:
        """True high-water mark over the round schedule: each round's
        factors-resident-so-far + full front stack + index/extend-add
        transients + ALL live Schur stacks (pre-free, including the
        round's own output) — computed once per round in plan_memory
        (no double count of surviving stacks)."""
        return max((r["highwater_dev"] for r in self.rounds), default=0)

    def summary(self) -> str:
        gb = 1 / 2 ** 30
        return (f"factors {self.factor_bytes_total * gb:.2f} GB total / "
                f"{self.factor_bytes_per_device * gb:.2f} GB/device; "
                f"peak {self.peak_per_device * gb:.2f} GB/device "
                f"on {self.n_devices} device(s)")


def plan_memory(plans, n_devices: int = 1, bytes_per_elem: int = 4,
                row_shard_min: int = 1024) -> MemoryPlan:
    """Exact padded-shape memory walk of a build_plan() output.

    Mirrors JaxMultifrontal's placement rules: batch-sharded rounds
    (B divides the mesh) divide everything by n_devices; small-batch
    big-front rounds (N >= row_shard_min, N divisible) divide their
    RESIDENT factor arrays by n_devices (front-axis sharding,
    _shard_factors) while their transients stay replicated."""
    e = bytes_per_elem

    def shard(nbytes: int, B: int) -> int:
        if n_devices > 1 and B % n_devices == 0:
            return nbytes // n_devices
        return nbytes

    def shard_dim(nbytes: int, B: int, dim: int, qualifies: bool) -> int:
        """Resident-factor sharding: batch if it divides, else the given
        front axis when the round qualifies for row sharding."""
        if n_devices <= 1:
            return nbytes
        if B % n_devices == 0:
            return nbytes // n_devices
        if qualifies and dim % n_devices == 0 and dim > 0:
            return nbytes // n_devices
        return nbytes

    # last consumer of each round's Schur stack
    last_use = {}
    for rnd, plan in enumerate(plans):
        for g in plan.child_groups:
            last_use[g.src_round] = rnd

    rounds = []
    fac_tot = 0
    fac_dev = 0
    live: dict[int, tuple[int, int]] = {}   # rnd -> (bytes, dev_bytes)
    schur_peak = schur_peak_dev = 0
    trans_peak = trans_peak_dev = 0
    PANEL = 128   # mirrors mf_jax.PANEL (diagonal-block size)
    for rnd, plan in enumerate(plans):
        B, P, N, M = plan.B, plan.P, plan.N, plan.M
        k_b = B * P * P * e
        u12 = B * P * M * e
        l21 = B * M * P * e
        perm = B * P * 4
        q = N >= row_shard_min and N % max(n_devices, 1) == 0
        # masked row-sharded rounds additionally hold the replicated
        # PANEL-diagonal stack KD (B, P/bs, bs, bs) — see _shard_factors
        bs = min(PANEL, P)
        kd = 0
        if (q and n_devices > 1 and B % n_devices != 0
                and P % n_devices == 0 and bs and P % bs == 0):
            kd = B * P * bs * e
        f_bytes = k_b + u12 + l21 + perm + kd
        fac_tot += f_bytes
        qk = q and bs and P % bs == 0   # engine shards K only with a KD
        f_dev = (shard_dim(k_b, B, P, qk) + shard_dim(u12, B, M, q)
                 + shard_dim(l21, B, M, q) + shard(perm, B) + kd)
        fac_dev += f_dev
        # transient working set of this round: the full (B,N,N) front
        # stack, the assembly index arrays, and the bounded extend-add
        # temporaries (~1 GB, see _extend_add's chunking)
        a_idx = (plan.a_pos.size * plan.a_pos.itemsize
                 + plan.a_src.size * plan.a_src.itemsize
                 + plan.a_col.size * plan.a_col.itemsize
                 + plan.a_csrc.size * plan.a_csrc.itemsize)
        # extend-add temporaries: 3 arrays of (Lc, N, M_src+1), Lc chosen
        # so each stays under ~0.5 GB (_extend_add's chunking) — but never
        # more than the actual link total
        ea = 0
        for g in plan.child_groups:
            msrc = plans[g.src_round].M + 1
            ea = max(ea, min(int(5e8), len(g.src_slots) * N * msrc * e) * 3)
        trans = B * N * N * e + a_idx + ea
        trans_dev = shard(B * N * N * e, B) + a_idx + ea
        # Schur stack this round produces (row-sharded rounds shard it
        # on the trailing axis, _shard_schur)
        s_bytes = B * M * M * e
        live[rnd] = (s_bytes, shard_dim(s_bytes, B, M, q))
        # the round's true high-water mark: factors resident through this
        # round (this round's FP/L21 coexist with its front stack at the
        # tail of the kernel) + the front stack and bounded temporaries +
        # every Schur stack live DURING the round (pre-free: sources being
        # consumed by the extend-add plus the round's own output). Counted
        # exactly once — the old split into transient + post-free live set
        # double-counted surviving stacks.
        s_during = sum(v[0] for v in live.values())
        s_during_dev = sum(v[1] for v in live.values())
        hw = fac_tot + trans + s_during
        hw_dev = fac_dev + trans_dev + s_during_dev
        # free the stacks whose last consumer is this round
        for src, lr in list(last_use.items()):
            if lr == rnd:
                live.pop(src, None)
                del last_use[src]
        s_live = sum(v[0] for v in live.values())
        s_live_dev = sum(v[1] for v in live.values())
        schur_peak = max(schur_peak, s_live)
        schur_peak_dev = max(schur_peak_dev, s_live_dev)
        trans_peak = max(trans_peak, trans)
        trans_peak_dev = max(trans_peak_dev, trans_dev)
        rounds.append(dict(round=rnd, B=B, P=P, N=N, factor=f_bytes,
                           factor_dev=f_dev,
                           schur_live=s_live, schur_live_dev=s_live_dev,
                           transient=trans, transient_dev=trans_dev,
                           highwater=hw, highwater_dev=hw_dev))
    return MemoryPlan(n_devices=n_devices, bytes_per_elem=e,
                      factor_bytes_total=fac_tot,
                      factor_bytes_per_device=fac_dev,
                      schur_peak_bytes=schur_peak,
                      schur_peak_per_device=schur_peak_dev,
                      transient_peak_bytes=trans_peak,
                      transient_peak_per_device=trans_peak_dev,
                      rounds=rounds)


# allocations the walk below does not itemise (library workspaces, index
# buffers): a share of each round's peak plus a fixed amount, fitted to
# the per-round peaks of the gx3 factor-only pass on an H100 (chip_smoke.py
# phase 7c prints them beside the plan)
SLACK_FRAC, SLACK_BYTES = 0.02, 64 << 20


def _consts_bytes(plan) -> int:
    """The engine's device constants of one round (mf_torch
    _device_constants): int64 index arrays, p_arr int32."""
    n = 8 * (plan.a_col.size + plan.a_csrc.size + plan.a_pos.size
             + plan.a_src.size + plan.cells_own.size
             + 3 * plan.cells_bor.size) + 4 * plan.B
    for g in plan.child_groups:
        n += 8 * (2 * len(g.src_slots) + g.inv.size)
    return n


def _extend_add_bytes(g, src, N: int, e: int) -> int:
    """mf_torch.extend_add's temporaries for one child group: the padded
    source copy, then per chunk of links (its waves, cut at its chunk
    length) the gathered rows (c, N, M+1) and their adds (c, N, N). A
    chunk's rows are allocated while the previous chunk's rows and adds
    are alive, its adds while the previous adds are."""
    from .mf_torch import _ea_chunk_len, link_waves
    mp1 = src.M + 1
    lc = _ea_chunk_len(N, mp1, e)
    _, waves = link_waves(g.dst_slots)
    best = prev_r = prev_a = 0
    for c in (min(lo + lc, stop) - lo for start, stop in waves
              for lo in range(start, stop, lc)):
        r, a = c * N * mp1 * e, c * N * N * e
        best = max(best, prev_r + prev_a + r, prev_a + r + a)
        prev_r, prev_a = r, a
    return src.B * mp1 * mp1 * e + best


def _factor_bytes(plan, e: int, pack_bs: int) -> int:
    """Bytes above the front stack while mf_torch.partial_factor runs, its
    outputs (K, U12, L21, the Schur block, perm) included."""
    B, P, N, M = plan.B, plan.P, plan.N, plan.M
    tb = min(pack_bs, P)
    # pack_diag_inv: the copy, per diagonal block the inverses and their
    # triangles (B, tb, tb) and the identity (tb, tb)
    pack = (B * P * P + 5 * B * tb * tb + tb * tb) * e
    outs = (B * P * P + 2 * B * P * M + B * M * M) * e + 8 * B * P
    if B <= 2:
        # the library LU's copy of F11, then finish_factor: the pack, F12
        # gathered, U12 and L21 by block substitution (pieces and their
        # concatenation), S = F22 - L21 @ U12
        k, pm, blk = B * P * P * e, B * P * M * e, B * tb * tb * e
        return k + max(pack, k + 4 * pm + blk, k + 5 * pm + blk,
                       k + 3 * pm + 2 * B * M * M * e) + 8 * B * P
    # per 128-column panel step: the gathered rows (B, R, N), the panel
    # kernel's buffers and perms, the U block, then the trailing update's
    # product (or the border TRSM's result); the previous step's rows,
    # panel and U block are alive until this step's replace them
    steps, prev = [], 0
    for off in range(0, P, 128):
        T, R = min(128, P - off), P - off
        rows = B * R * N * e
        kern = 3 * B * R * T * e + 16 * B * R
        a12 = B * T * (N - off - T) * e
        upd = max(B * (N - off - T) ** 2, B * (N - P) * T) * e
        steps.append(max(prev + rows + kern, rows + kern + a12 + upd))
        prev = rows + 2 * B * R * T * e + a12
    return max(max(steps), prev + pack, prev + outs) + 8 * B * P


def engine_round_peaks(plans, bytes_per_elem: int, nnz: int, pack_bs: int,
                       factor_only: bool = True) -> list[int]:
    """Device bytes the PyTorch engine (``mf_torch.TorchMultifrontal``)
    holds at most while it factors each round, one round after another on
    one device from round 0, as ``torch.cuda.max_memory_allocated`` counts
    them. A round's figure covers the previous round's save too.

    ``plan_memory`` models the JAX engine, whose compiled programs fuse
    most temporaries away. The PyTorch engine runs eager ops, each of which
    allocates its result, so this walk counts them op by op: the CSR
    values and the plan constants; the live Schur stacks, each freed after
    its last consumer's extend-add; the (B, N, N) front stack; extend-add's
    temporaries; partial_factor's (``_factor_bytes``). ``factor_only``
    (the checkpointed pass with offload): a round's constants are built
    when it runs, and its factors leave the device once saved. Otherwise
    (the resident engine) every round's constants are built first and the
    factors stay. A factor-only resume, which loads the rounds on disk,
    holds no more in each round it computes than the whole pass."""
    e = bytes_per_elem
    last_use = {}
    for rnd, plan in enumerate(plans):
        for g in plan.child_groups:
            last_use[g.src_round] = rnd
    schur = [p.B * p.M * p.M * e if last_use.get(r, -1) > r else 0
             for r, p in enumerate(plans)]
    held = (nnz + 1) * e                       # the CSR values, extended
    if not factor_only:
        held += sum(_consts_bytes(p) for p in plans)
    live = tail = 0                            # Schur stacks; last save
    peaks = []
    for rnd, plan in enumerate(plans):
        B, P, N, M = plan.B, plan.P, plan.N, plan.M
        if factor_only:
            held += _consts_bytes(plan)
        front = B * N * N * e
        peak = tail
        for g in plan.child_groups:
            peak = max(peak, held + live + front + _extend_add_bytes(
                g, plans[g.src_round], N, e))
            if last_use[g.src_round] == rnd:
                live -= schur[g.src_round]
        peak = max(peak, held + live + front + _factor_bytes(plan, e,
                                                             pack_bs))
        # through the save: the outputs, the Schur block among them
        factors = (B * P * P + 2 * B * P * M) * e + 8 * B * P
        if not factor_only:
            held += factors
        tail = held + live + B * M * M * e + (factors if factor_only else 0)
        live += schur[rnd]
        peak = max(peak, tail)
        peaks.append(int(peak * (1 + SLACK_FRAC)) + SLACK_BYTES)
    return peaks


def checkpoint_disk_plan(sym, plans, itemsize: int):
    """(live, written) per round of a checkpointed factor pass (one whose
    engine has a ``checkpoint_dir``): the bytes it holds on disk while it
    saves the round (every round file so far, v3 trimmed:
    each front's p*p + 2*p*m entries, and the padded Schur file of every
    round whose last consumer has not yet been saved; see
    mf_torch.TorchMultifrontal._factor_rounds) and the bytes it has
    written up to then, deleted Schur files included."""
    last = [-1] * len(plans)
    for rnd, plan in enumerate(plans):
        for g in plan.child_groups:
            last[g.src_round] = max(last[g.src_round], rnd)
    files = written = 0
    live, wrote = [], []
    for rnd, plan in enumerate(plans):
        size = itemsize * sum(f.p * f.p + 2 * f.p * (f.n - f.p)
                              for f in (sym.fronts[n]
                                        for n in plan.node_ids))
        files += size
        written += size + (itemsize * plan.B * plan.M * plan.M
                           if last[rnd] > rnd else 0)
        schur = sum(itemsize * p.B * p.M * p.M
                    for s, p in enumerate(plans[:rnd + 1]) if last[s] >= rnd)
        live.append(files + schur)
        wrote.append(written)
    return live, wrote
