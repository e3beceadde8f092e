"""Symbolic, per-round and whole-set factor checkpoints.

The port's copy of the JAX package's ``solver/checkpoint.py``, with the
same file names and formats, so that a file written by one package loads
into the other:

* ``save_symbolic`` / ``load_symbolic``: the symbolic factorization, which
  depends only on the sparsity pattern and is the same for every Newton
  iteration of a spin-up;
* ``FactorRoundCheckpointer``: one file per completed round of the numeric
  factorization (v3 trimmed format, v2 padded read on load) plus the Schur
  stacks a pending round still needs, so that a factor pass resumes after
  a process death and a factor set larger than the card lives on disk
  (``mf_torch.TorchMultifrontal(checkpoint_dir=...)``, ``stream_solve``);
* ``save_factors`` / ``load_factors``: the whole numeric factor set and the
  equilibration scalings in one file (the solve CLI's ``--factors``).

Tensors reach numpy through ``.cpu().numpy()``; on the card that copy is
also the only synchronization of a checkpointed factor round.
"""

from __future__ import annotations

import hashlib
import os
import zipfile

import numpy as np
import torch

from ..utils import dbg
from .symbolic import Front, SymbolicFactorization


def save_symbolic(path: str, sym: SymbolicFactorization) -> None:
    nodes = sorted(sym.fronts.keys())
    arrays = {
        "perm": sym.perm,
        "iperm": sym.iperm,
        "flat_len": np.array([sym.flat_len]),
        "nodes": np.array(nodes, dtype=np.int64),
        "rounds_sizes": np.array([len(r) for r in sym.rounds], dtype=np.int64),
        "rounds_flat": np.concatenate(
            [np.asarray(r, dtype=np.int64) for r in sym.rounds]
            or [np.empty(0, np.int64)]),
    }
    for nid in nodes:
        f = sym.fronts[nid]
        arrays[f"f{nid}_owned"] = f.owned_cols
        arrays[f"f{nid}_border"] = f.border_cols
        arrays[f"f{nid}_cells"] = f.cells
        arrays[f"f{nid}_meta"] = np.array(
            [f.p, f.n, f.parent, f.round], dtype=np.int64)
        arrays[f"f{nid}_children"] = np.array(f.children, dtype=np.int64)
        if f.parent_map is not None:
            arrays[f"f{nid}_pmap"] = f.parent_map
    np.savez_compressed(path, **arrays)


def load_symbolic(path: str) -> SymbolicFactorization:
    z = np.load(path)
    nodes = z["nodes"]
    fronts = {}
    for nid in nodes:
        nid = int(nid)
        p, n, parent, rnd = (int(v) for v in z[f"f{nid}_meta"])
        pmap_key = f"f{nid}_pmap"
        fronts[nid] = Front(
            node=nid,
            owned_cols=z[f"f{nid}_owned"],
            border_cols=z[f"f{nid}_border"],
            cells=z[f"f{nid}_cells"],
            p=p, n=n, parent=parent,
            parent_map=z[pmap_key] if pmap_key in z.files else None,
            children=[int(c) for c in z[f"f{nid}_children"]],
            round=rnd)
    rounds = []
    off = 0
    flat = z["rounds_flat"]
    for sz in z["rounds_sizes"]:
        rounds.append([int(x) for x in flat[off:off + int(sz)]])
        off += int(sz)
    return SymbolicFactorization(
        fronts=fronts, rounds=rounds, perm=z["perm"], iperm=z["iperm"],
        flat_len=int(z["flat_len"][0]))


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class FactorRoundCheckpointer:
    """Per-round checkpoints of the numeric factorization.

    Each completed round's factors land in ``round_NNNN.npz`` (atomic
    rename): v3 trimmed, only each front's true (p, m) blocks of K, U12 and
    L21 raveled into ``blocks``, with the trim map ``pm``, the full (B, P)
    ``perm``, the round's (B, P, N, M) ``meta`` and the value key
    ``nzhash``; the v2 padded format (``FP`` = [K | U12], ``L21``) of older
    writers is read too. Its Schur stack, needed only until the consuming round has
    extend-added it, lands in ``round_NNNN_S.npy`` and is deleted once every
    consumer's own checkpoint is on disk, so the Schur files on disk track
    the live set. The key hashes the factorized values and the plan shape
    (``mf_torch.TorchMultifrontal._ckpt_for``), so new Newton-iteration
    values never resume from stale factors."""

    def __init__(self, dirpath: str, nzhash: str):
        self.dir = dirpath
        self.nzhash = nzhash
        os.makedirs(dirpath, exist_ok=True)

    def _path(self, rnd: int) -> str:
        return os.path.join(self.dir, f"round_{rnd:04d}.npz")

    def _spath(self, rnd: int) -> str:
        return os.path.join(self.dir, f"round_{rnd:04d}_S.npy")

    def _meta(self, plan) -> np.ndarray:
        return np.array([plan.B, plan.P, plan.N, plan.M], dtype=np.int64)

    def scan(self, plans) -> set[int]:
        """Rounds with a valid (shape- and value-matching) checkpoint."""
        done: set[int] = set()
        for rnd, plan in enumerate(plans):
            p = self._path(rnd)
            if not os.path.exists(p):
                continue
            try:
                with np.load(p, allow_pickle=False) as z:
                    if (str(z["nzhash"]) == self.nzhash
                            and np.array_equal(z["meta"], self._meta(plan))):
                        done.add(rnd)
            except Exception:  # noqa: BLE001 - an unreadable file is no checkpoint
                continue
        if done:
            dbg(1, f"factor checkpoint: resuming {len(done)}/{len(plans)} "
                   f"rounds from {self.dir}")
        return done

    def save_round(self, rnd: int, plan, K, U12, L21, perm,
                   S=None, *, pm) -> None:
        """Write round ``rnd``'s factors in the v3 trimmed format (``pm``:
        the (B, 2) true (p, m) per batch entry, mf_torch._plan_pm) and, when
        given, its Schur stack."""
        tmp = self._path(rnd) + ".tmp.npz"
        Kh, Uh, Lh = _host(K), _host(U12), _host(L21)
        # only each front's true (p, m) blocks: batch padding is 30-50% of
        # the padded bytes at production scale (gx1 float64 factors: 88 GB
        # trimmed against ~144 GB padded)
        parts = []
        for b in range(plan.B):
            p, m = int(pm[b, 0]), int(pm[b, 1])
            if p:
                parts.append(Kh[b, :p, :p].ravel())
            if p and m:
                parts.append(Uh[b, :p, :m].ravel())
                parts.append(Lh[b, :m, :p].ravel())
        blocks = np.concatenate(parts) if parts else np.empty(0, Kh.dtype)
        np.savez(tmp, blocks=blocks, pm=np.asarray(pm, np.int64),
                 perm=_host(perm), meta=self._meta(plan), nzhash=self.nzhash)
        os.replace(tmp, self._path(rnd))
        if S is not None and S.numel():
            self.save_schur(rnd, S)

    def load_round(self, rnd: int, plan, eng, need_schur: bool,
                   factors: bool = True):
        """(K, U12, L21, perm, S-or-None) on the engine's device, at its
        factor dtype (perm int64), in the engine's layout (under a mesh,
        this rank's slice, as ``_shard_factors`` places a load), or None
        when the Schur stack a consumer needs is gone. With
        ``factors=False`` (the engine's offload mode) only the Schur stack
        is read; the factor slots come back None."""
        K = U12 = L21 = perm = None
        if factors:
            with np.load(self._path(rnd), allow_pickle=False) as z:
                if "blocks" in z.files:      # v3 trimmed
                    Kh, Uh, Lh = _unpack_trimmed(z, plan)
                else:                        # v2 padded
                    FP = z["FP"]
                    Kh, Uh = FP[:, :, :plan.P], FP[:, :, plan.P:]
                    Lh = z["L21"]
                # the JAX engine may have written a narrower integer perm
                K, U12, L21, perm = eng._place_round(rnd, plan, Kh, Uh, Lh,
                                                     z["perm"])
        S = None
        if need_schur:
            spath = self._spath(rnd)
            if not os.path.exists(spath):
                return None     # a consumer needs the Schur we don't have
            S = eng._place_schur(rnd, plan, np.load(spath))
        return K, U12, L21, perm, S

    def save_schur(self, rnd: int, S) -> None:
        """Persist a round's Schur stack alone (also the repair mode: the
        factor file is on disk already, the regenerated Schur keeps the
        directory resumable at every completed round)."""
        stmp = self._spath(rnd) + ".tmp.npy"
        np.save(stmp, _host(S))
        os.replace(stmp, self._spath(rnd))

    def has_schur(self, rnd: int) -> bool:
        return os.path.exists(self._spath(rnd))

    def drop_schur(self, rnd: int) -> None:
        try:
            os.remove(self._spath(rnd))
        except OSError:
            pass


def stored_dtype(dirpath: str) -> np.dtype | None:
    """The factor dtype of the round checkpoints in ``dirpath``, read from
    the header of round 0's ``blocks`` (v3) or ``FP`` (v2) array without
    loading it; None when round 0 has no file."""
    path = os.path.join(dirpath, "round_0000.npz")
    if not os.path.exists(path):
        return None
    with zipfile.ZipFile(path) as zf:
        name = "blocks.npy" if "blocks.npy" in zf.namelist() else "FP.npy"
        with zf.open(name) as f:
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            return read(f)[2]


def _unpack_trimmed(z, plan):
    """Rebuild padded (B,P,P)/(B,P,M)/(B,M,P) factor stacks from a v3
    trimmed round file. Padding is IDENTITY on K's diagonal and zero
    elsewhere: the packed-inverse layout's diagonal blocks then act as
    identity in the block substitution (tril(I,-1)=0, triu(I)=I), so
    padded solve lanes pass through untouched — the same behavior the
    factor kernels produce natively by padding assembled fronts with a
    unit diagonal (mf_jax._assemble p_arr masking)."""
    pm = z["pm"]
    blocks = z["blocks"]
    B, P, M = plan.B, plan.P, plan.M
    K = np.zeros((B, P, P), blocks.dtype)
    K[:, np.arange(P), np.arange(P)] = 1.0
    U = np.zeros((B, P, M), blocks.dtype)
    L = np.zeros((B, M, P), blocks.dtype)
    off = 0
    for b in range(B):
        p, m = int(pm[b, 0]), int(pm[b, 1])
        if p:
            K[b, :p, :p] = blocks[off:off + p * p].reshape(p, p)
            off += p * p
        if p and m:
            U[b, :p, :m] = blocks[off:off + p * m].reshape(p, m)
            off += p * m
            L[b, :m, :p] = blocks[off:off + m * p].reshape(m, p)
            off += m * p
    return K, U, L


def _nzhash(matrix) -> str:
    h = hashlib.sha1(np.ascontiguousarray(matrix.nzval).tobytes())
    h.update(np.ascontiguousarray(matrix.rowptr, dtype=np.int64).tobytes())
    # colind too: identical values + row counts with permuted columns is
    # a different matrix and must not resume silently
    h.update(np.ascontiguousarray(matrix.colind, dtype=np.int64).tobytes())
    return h.hexdigest()


def save_factors(path: str, fac) -> None:
    """Persist the numeric factors of ``fac`` (a MultifrontalFactorization)
    so that a Newton outer loop can restart and go straight to the solves:
    every round's concatenated [K | U12] stack, L21 and perm, the
    equilibration scalings and the hash of the matrix values they were
    computed from. The symbolic plan is not stored: it is rebuilt from the
    matrix pattern or loaded with ``load_symbolic``. Under a mesh the
    ranks gather every round whole (collective), the mesh's first rank
    alone writes the file (the JAX mesh engine's keys and layout, which
    are the single-device ones), and it is on disk for every rank when
    this returns."""
    eng = fac.engine
    factors = eng.global_factors()
    if not eng._writer:
        eng._mesh_barrier()
        return
    arrays = {"n_rounds": np.array([len(factors)]),
              "flat_len": np.array([eng.flat_len]),
              "pack_bs": np.array([eng._pack_bs]),
              # factors are valid only for the exact values they were
              # computed from: a Newton iteration's new values must never
              # silently resume from stale factors
              "nzhash": np.array([_nzhash(fac.matrix)])}
    if fac.dr is not None:
        arrays["dr"] = fac.dr
        arrays["dc"] = fac.dc
    for i, (K, U12, L21, perm) in enumerate(factors):
        arrays[f"r{i}_FP"] = np.concatenate([_host(K), _host(U12)], axis=2)
        arrays[f"r{i}_L21"] = _host(L21)
        arrays[f"r{i}_perm"] = _host(perm)
    np.savez(path, **arrays)
    eng._mesh_barrier()


def load_factors(path: str, fac) -> None:
    """Load numeric factors written by save_factors (by either package)
    into ``fac``, whose engine must have the same plans (shapes are
    checked) and pack block size, replacing its factors; under a mesh each
    rank keeps its slice. Raises ValueError when the file does not match
    the matrix pattern or values."""
    eng = fac.engine
    with np.load(path) as z:
        n_rounds = int(z["n_rounds"][0])
        if n_rounds != len(eng.plans):
            raise ValueError(f"checkpoint has {n_rounds} rounds, plan has "
                             f"{len(eng.plans)} — pattern mismatch")
        if int(z["flat_len"][0]) != eng.flat_len:
            raise ValueError("checkpoint flat_len mismatch")
        if "nzhash" not in z.files:
            raise ValueError("factor checkpoint has no matrix-value hash "
                             "(pre-hash format) — cannot prove it matches "
                             "these matrix values; refactor")
        if str(z["nzhash"][0]) != _nzhash(fac.matrix):
            raise ValueError("checkpoint was computed from different matrix "
                             "VALUES (stale Newton iteration?) — refactor")
        ck_bs = int(z["pack_bs"][0]) if "pack_bs" in z.files else 128
        if ck_bs != eng._pack_bs:
            raise ValueError(f"checkpoint pack_bs {ck_bs} != engine "
                             f"{eng._pack_bs}: its diagonal blocks are packed "
                             f"at another width; refactor")
        factors = []
        for i, plan in enumerate(eng.plans):
            FP = z[f"r{i}_FP"]
            if FP.shape != (plan.B, plan.P, plan.N):
                raise ValueError(f"round {i}: factor shape {FP.shape} != "
                                 f"{(plan.B, plan.P, plan.N)}")
            factors.append(eng._place_round(
                i, plan, FP[:, :, :plan.P], FP[:, :, plan.P:],
                z[f"r{i}_L21"], z[f"r{i}_perm"]))
        eng.factors = tuple(factors)
        if "dr" in z.files:
            fac.dr, fac.dc = z["dr"], z["dc"]
        elif fac.dr is not None:
            # the file's factors were computed from the unequilibrated matrix:
            # adopt that convention rather than wrap unscaled factors in this
            # facade's fresh scalings (a silently degraded preconditioner)
            dbg(1, "factor checkpoint was computed without equilibration; "
                   "dropping this facade's row/column scalings to match")
            fac.dr = fac.dc = None
    fac._refiner = None     # rebind the refiner to the loaded factors
