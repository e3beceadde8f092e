"""The Jacobian values of a Newton iteration, drawn on the coefficient
fields: the reference's side of the ``"values": "fields"`` mixes.

Stage 1's coefficient fields before compaction (``stage1.assemble``'s
``coef`` of each offset slot, the self slot with the sink added), each
entry multiplied by c = 1 + scale z, then compacted as stage 1 compacts:
the contributions of one (row, column) summed in slot order, on the
pattern of the unperturbed fields (a group whose unperturbed sum is zero
stays out, as the frozen pattern of a Newton loop leaves it out).

z is float32 standard normal, one per (slot, k, j, i), slot-major in stage
1's slot order: a window of L = slots * km * jmt * imt entries of one pool
of 2 L drawn for the seed, at an offset drawn for the step (``pool``,
``offset``). The harness hands the same pool and offsets to the program;
the reference works out the fields, their compaction and each step's
values itself, from the configuration alone.
"""

from __future__ import annotations

import numpy as np

from . import stage1
from .check import _rng

FIELDS, FIELD_OFFSET = 4, 5      # the seed's streams, after check.py's


def slot_offsets(adv_type: str) -> list:
    """Stage 1's offset slots, in its within-row order."""
    return (stage1.FACE_OFFSETS
            + (stage1.ADV2_OFFSETS if adv_type == "upwind3" else [])
            + stage1.ISOP_OFFSETS)


def pool(seed: int, length: int) -> np.ndarray:
    """The seed's 2 ``length`` float32 standard normals."""
    return _rng(seed, FIELDS).standard_normal(2 * length, dtype=np.float32)


def offset(seed: int, index: int, length: int) -> int:
    """Where step ``index``'s window of ``length`` starts in the pool."""
    return int(_rng(seed, FIELD_OFFSET, index).integers(0, length))


def coefficient_fields(config: dict) -> tuple:
    """(slots, fields, KMT): stage 1's offset slots, their coefficient
    fields as one (slots, km, jmt, imt) float64 array, the self slot's
    with the sink (what ``stage1.assemble`` compacts), and the grid's
    KMT."""
    g, a = config["grid"], config["assembly"]
    km = g["km"]
    if (a["adv_type"] not in stage1.ADV_TYPES
            or a["hmix_type"] != "isop_file" or a["vmix_type"] != "file"
            or a["sink_type"] != "const"
            or not a.get("l_adv_enforce_divfree", True)):
        raise ValueError(f"options outside the frozen stage 1: {a}")
    dt = stage1.SECONDS_PER_DAY * a["day_cnt"]
    f = stage1.circulation(g["imt"], g["jmt"], km, config["circulation_seed"],
                           a["adv_type"])
    slots = slot_offsets(a["adv_type"])
    coef = {off: np.zeros((km, g["jmt"], g["imt"])) for off in slots}
    if a["adv_type"] == "centered":
        stage1.add_centered(coef, f, dt)
    else:
        stage1.add_upwind3(coef, f, dt)
    stage1.enforce_divfree(coef, a["adv_type"])
    stage1.add_isop_file(coef, f, dt)
    stage1.add_vmix_file(coef, f, dt)
    self_coef = coef[stage1.SELF].copy()
    self_coef += -(a["day_cnt"] / 365.0) * a["sink_rate"]
    fields = np.stack([self_coef if off == stage1.SELF else coef[off]
                       for off in slots])
    return slots, fields, f["KMT"]


class FieldValues:
    """The configuration's fields and their compaction, held by the
    reference: ``colind``, ``rowptr`` and ``nzval0`` of the unperturbed
    fields, and ``__call__(index)``, the values of step ``index``."""

    def __init__(self, config: dict, seed: int, scale: float):
        self.seed, self.scale = seed, scale
        slots, fields, KMT = coefficient_fields(config)
        km, jmt, imt = fields.shape[1:]
        self.flat = fields.reshape(-1)
        self.length = self.flat.size
        cells = km * jmt * imt
        maps = stage1.ind_maps(KMT, km)
        int3 = maps["int3_to_ind"]
        wet = stage1.wet3d(KMT, km)
        kk, jj, ii = np.meshgrid(np.arange(km), np.arange(jmt),
                                 np.arange(imt), indexing="ij")
        cell = kk * (jmt * imt) + jj * imt + ii
        rows, cols, src, seq = [], [], [], []
        for slot, (dk, dj, di) in enumerate(slots):
            valid = wet & stage1.target_wet(KMT, km, dk, dj, di)
            tgt = int3[np.clip(kk + dk, 0, km - 1),
                       np.clip(jj + dj, 0, jmt - 1), (ii + di) % imt]
            rows.append(int3[valid])
            cols.append(tgt[valid])
            src.append(slot * cells + cell[valid])
            seq.append(np.full(int(valid.sum()), slot, dtype=np.int64))
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        src, seq = np.concatenate(src), np.concatenate(seq)
        n = maps["tracer_state_len"]
        order = np.lexsort((seq, cols, rows))
        rows, cols, self.src = rows[order], cols[order], src[order]
        key = rows * n + cols
        new = np.empty(len(rows), dtype=bool)
        new[0] = True
        np.not_equal(key[1:], key[:-1], out=new[1:])
        self.starts = np.flatnonzero(new)
        summed = np.add.reduceat(self.flat[self.src], self.starts)
        self.keep = summed != 0.0
        self.nzval0 = summed[self.keep]
        self.colind = cols[self.starts][self.keep].astype(np.int64)
        rowptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(rowptr, rows[self.starts][self.keep] + 1, 1)
        self.rowptr = np.cumsum(rowptr)
        self.pool = pool(seed, self.length)

    def __call__(self, index: int) -> np.ndarray:
        o = offset(self.seed, index, self.length)
        c = 1.0 + self.scale * self.pool[o:o + self.length].astype(np.float64)
        scaled = self.flat * c
        return np.add.reduceat(scaled[self.src], self.starts)[self.keep]
