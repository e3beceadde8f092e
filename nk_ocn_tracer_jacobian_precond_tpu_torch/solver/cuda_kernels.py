"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Three kernels carry the factor path, each a port of a Pallas kernel of the
JAX package (``solver/pallas_kernels.py``), each at the factor dtype:

* ``pivoted_panel`` (``csrc/pivoted_panel.cu``): the batched
  restricted-pivot panel LU, which also composes the pivot swaps into the
  row permutation. At float64 it is K1, replacing
  ``pallas_pivoted_panel_df64``; at float32 it is K2, replacing
  ``pallas_pivoted_panel``. One template, two instances, each front on a
  thread-block cluster whose shared memory holds the panel
  (``panel_launch_config`` picks the cluster size and the column slab).
* ``ell_assemble`` (``csrc/ell_assemble.cu``) replaces
  ``pallas_ell_assemble`` and the rest of ``mf_jax._assemble``: front
  assembly with its spill entries and identity padding (K3, both dtypes).

A fourth carries the solve's refinement and replaces no Pallas kernel (the
JAX refiner takes its residuals on the host):

* ``csr_matvec`` (``csrc/csr_matvec.cu``): the refiner's float64 product
  A x from its ELL copy of the matrix, summed in CSR order as scipy's CSR
  product sums it, so b minus it is scipy's ``B - A @ X``.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Both dispatch on the dtype
(float32 or float64; any other raises), but ``csr_matvec``, which takes
float64 only. The kernels are compiled with
``nvcc`` into ``build/torch_kernels/<hash of the sources>/`` at the first
launch (or by ``build()``) and bound with ctypes. Nothing here imports or
compiles CUDA code when the module is imported. ``LAUNCHES`` counts the
kernel launches per kernel and dtype, so a run can show that its main path
went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("pivoted_panel.cu", "ell_assemble.cu", "csr_matvec.cu")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# --fmad=false: the kernels fuse a multiply-add only where the source calls
# fma(), as their plain versions do, so the two agree bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")

LAUNCHES = {"pivoted_panel_f64": 0, "pivoted_panel_f32": 0,
            "ell_assemble_f64": 0, "ell_assemble_f32": 0,
            "csr_matvec_f64": 0}
SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
BUILD_LOG = ""          # ptxas' register / shared-memory report of the build

_lib = None
_lock = threading.Lock()
_VP, _I64 = ctypes.c_void_p, ctypes.c_int64


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    path = shutil.which("nvcc")
    if path is None and CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit")
    return path


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' library."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in SOURCES:
            h.update((_CSRC / name).read_bytes())
        out_dir = BUILD_ROOT / h.hexdigest()[:16]
        so = out_dir / "libnk_torch_kernels.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"libnk_torch_kernels.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(_CSRC / s) for s in SOURCES)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed (rc {res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            BUILD_LOG = res.stdout + res.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.nk_pivoted_panel_smem.restype = _I64
        lib.nk_pivoted_panel_smem.argtypes = [_I64, _I64, _I64]
        lib.nk_pivoted_panel_active_clusters.restype = ctypes.c_int
        lib.nk_pivoted_panel_active_clusters.argtypes = [_I64] * 4
        for sfx, tau_t in (("f64", ctypes.c_double), ("f32", ctypes.c_float)):
            fn = getattr(lib, f"nk_pivoted_panel_{sfx}")
            fn.restype = ctypes.c_int
            fn.argtypes = [_VP, _VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64,
                           tau_t, _I64, _I64, _VP]
            fn = getattr(lib, f"nk_ell_assemble_{sfx}")
            fn.restype = ctypes.c_int
            fn.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP,
                           _I64, _I64, _I64, _I64, _I64, _I64, ctypes.c_int,
                           _VP]
        lib.nk_csr_matvec_f64.restype = ctypes.c_int
        lib.nk_csr_matvec_f64.argtypes = [_VP] * 4 + [_I64] * 3 + [_VP]
        _lib = lib
        return lib


def _route(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel) for tensors on one device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: the kernels run on "
                         f"cuda, their plain versions on cpu")
    return dev.type


def _float_dtype(t: torch.Tensor, name: str) -> str:
    """The kernel suffix ("f64" or "f32") of a floating tensor's dtype."""
    if t.dtype not in SUFFIX:
        raise TypeError(f"{name}: expected float32 or float64, got "
                        f"{t.dtype}")
    return SUFFIX[t.dtype]


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# --------------------------------------------------------------------------
# K1 (f64) and K2 (f32): pivoted panel
# --------------------------------------------------------------------------

_SPLIT = 134217729.0        # 2**27 + 1, Veltkamp's splitter for binary64


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    p = a * b
    ca = _SPLIT * a
    ah = ca - (ca - a)
    al = a - ah
    cb = _SPLIT * b
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_to_odd(s, err):
    """s + err rounded to odd, for float64 s = RN(s + err): an inexact s
    with an even last bit moves to its odd neighbour on the side of the
    exact sum."""
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(fix, torch.nextafter(s, toward), s)


def fma_plain(a, b, c):
    """a * b + c rounded once to the operands' dtype (float64 or float32),
    from separately rounded tensor ops (Boldo and Melquiond's emulation
    through rounding to odd; exact barring overflow and underflow). The
    panel's rank-1 update is a fused multiply-add at both dtypes, as XLA on
    the CPU compiles the JAX reference and as the kernel computes it, and
    each PyTorch op here rounds on its own, so no backend contracts it
    differently.

    float32 takes the float64 route: a * b is exact there (24 + 24 bits),
    the sum is rounded to odd in float64 (53 >= 2 * 24 + 2 bits), and the
    one rounding to float32 is then correct. Rounding the float64 sum to
    nearest first would round twice."""
    if a.dtype == torch.float32:
        s, err = _two_sum(a.double() * b.double(), c.double())
        return _round_to_odd(s, err).float()
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    s, err = _two_sum(tl, ul)
    return th + _round_to_odd(s, err)


def seq_to_perm(piv, R: int):
    """Compose a pivot-swap sequence (B, T) into a row permutation (B, R)
    int64: perm[b, i] = panel-relative source row that ends up at i
    (mf_jax._seq_to_perm)."""
    B, T = piv.shape
    perm = torch.arange(R, device=piv.device).repeat(B, 1)
    bidx = torch.arange(B, device=piv.device)
    piv = piv.to(torch.int64)
    for k in range(T):
        sel = piv[:, k]
        a = perm[:, k].clone()
        perm[:, k] = perm[bidx, sel]
        perm[bidx, sel] = a
    return perm


# what the panel kernel's launch may use on an H100 (csrc/pivoted_panel.cu)
# threads per CTA: 512 for one CTA per front, 256 in a cluster
PANEL_THREADS = {"solo": 512, "cluster": 256}
PANEL_MAX_CLUSTER = 8       # the portable cluster size
PANEL_MAX_T = 128
SMEM_BLOCK = 232448         # 227 KB: a block's dynamic shared memory
SMEM_SM = 233472            # 228 KB per SM, 1 KB of it reserved per block
SMEM_RESERVED = 1024
SMS = 132
THREADS_SM = 2048


def panel_smem_bytes(rows: int, nb: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA of the panel kernel holding `rows`
    rows of a slab `nb` columns wide (the kernel's smem_bytes)."""
    warps = PANEL_THREADS["solo"] // 32
    s = rows * nb + 5 * nb + rows + 2 + warps
    i = rows + 6 + warps
    return (s * itemsize + i * 4 + 15) // 16 * 16


# the launch rule's cost model, fitted to scripts/panel_sweep.py on an H100
# 80GB HBM3 at 700 W: a step costs its CTA's rows, times PANEL_SOLO_ROWS
# for one CTA of 512 threads; a cluster of C > 1 CTAs adds
# PANEL_CLUSTER_COST rows' worth for its barrier and distributed shared
# memory; CTAs sharing an SM slow each other by (CTAs per SM) **
# PANEL_SHARE
PANEL_SOLO_ROWS = 0.6
PANEL_CLUSTER_COST = 100
PANEL_SHARE = 0.5


def estimate_active_clusters(C: int, rows: int, nb: int,
                             itemsize: int) -> int:
    """Clusters of C CTAs the card can keep active at once, from shared
    memory and threads per SM alone (the card's own count, which the
    wrapper asks cudaOccupancyMaxActiveClusters for, can be lower: a
    cluster must fit in one GPC)."""
    smem = panel_smem_bytes(rows, nb, itemsize)
    if smem > SMEM_BLOCK:
        return 0
    threads = PANEL_THREADS["solo" if C == 1 else "cluster"]
    per_sm = min(SMEM_SM // (smem + SMEM_RESERVED), THREADS_SM // threads)
    return SMS * per_sm // C


def panel_launch_config(B: int, R: int, T: int, itemsize: int,
                        active=estimate_active_clusters):
    """(C, nb): the cluster size (CTAs per front) and the column-slab width
    of the panel kernel for B fronts of (R, T) at ``itemsize`` bytes;
    ``active(C, rows, nb, itemsize)`` is the number of clusters the card
    keeps active at once (0 where the slice does not fit).

    The whole panel (nb = T) stays in the cluster's shared memory when some
    C <= 8 gives a slice of ceil(R / C) rows that fits 227 KB. Among those
    C the rule takes the least modelled time: waves of active clusters,
    each of T steps whose cost is the slice's rows plus, for C > 1, the
    cluster's cost, stretched by the CTAs that share an SM. One CTA (no
    cluster barrier) wins on short panels and many fronts, 8 CTAs on tall
    panels and few fronts. Taller panels take C = 8 and the widest slab (a
    multiple of 8 columns) that fits; a panel whose 8-column slab does not
    fit raises ValueError."""
    if T < 1 or T > PANEL_MAX_T or R < T:
        raise ValueError(f"panel (R={R}, T={T}) needs 1 <= T <= "
                         f"{PANEL_MAX_T} and R >= T")
    best = None
    for C in range(1, PANEL_MAX_CLUSTER + 1):
        rows = -(-R // C)
        if panel_smem_bytes(rows, T, itemsize) > SMEM_BLOCK:
            continue
        act = active(C, rows, T, itemsize)
        if act < 1:
            continue
        share = max(1.0, min(B, act) * C / SMS) ** PANEL_SHARE
        step = (rows + PANEL_CLUSTER_COST if C > 1
                else rows * PANEL_SOLO_ROWS)
        cost = -(-B // act) * share * step
        if best is None or cost < best[0]:
            best = (cost, C)
    if best is not None:
        return best[1], T
    C = PANEL_MAX_CLUSTER
    rows = -(-R // C)
    nb = 8 * (T // 8)
    while nb >= 8 and panel_smem_bytes(rows, nb, itemsize) > SMEM_BLOCK:
        nb -= 8
    if nb < 8:
        raise ValueError(f"panel (B={B}, R={R}, T={T}) at {itemsize} bytes "
                         f"per value: {rows} rows per CTA do not fit "
                         f"{SMEM_BLOCK} bytes of shared memory even in "
                         f"8-column slabs")
    return C, nb


_ACTIVE: dict = {}


def active_clusters(C: int, rows: int, nb: int, itemsize: int) -> int:
    """The card's own count of active clusters (cached)."""
    key = (C, rows, nb, itemsize)
    if key not in _ACTIVE:
        _ACTIVE[key] = max(0, build().nk_pivoted_panel_active_clusters(
            C, rows, nb, itemsize))
    return _ACTIVE[key]


def pivoted_panel_plain(Pan: torch.Tensor, off: int, p_arr: torch.Tensor,
                        tau: float = 0.0):
    """mf_jax._pivoted_panel in PyTorch: factor the (B, R, T) panel (rows
    [off, P), columns [off, off + T) of each front) with partial pivoting
    restricted to rows whose global row is below p_arr[b] (or the diagonal
    row), clamping pivots smaller than tau to +-tau. Returns a new factored
    panel and piv (B, T) int32 of panel-relative pivot rows."""
    B, R, T = Pan.shape
    Pan = Pan.clone()
    piv = torch.empty((B, T), dtype=torch.int32, device=Pan.device)
    r_idx = torch.arange(R, device=Pan.device)
    elig = (off + r_idx)[None, :] < p_arr.to(torch.int64)[:, None]
    bidx = torch.arange(B, device=Pan.device)
    for k in range(T):
        ok = (r_idx >= k) & (elig | (r_idx == k))
        score = torch.where(ok, Pan[:, :, k].abs(), -1.0)
        sel = torch.argmax(score, dim=1)
        rowk = Pan[:, k, :].clone()
        Pan[:, k, :] = Pan[bidx, sel, :]
        Pan[bidx, sel, :] = rowk
        piv[:, k] = sel.to(torch.int32)
        pv = Pan[:, k, k]
        tau_t = torch.full_like(pv, tau)
        pv = torch.where(pv.abs() < tau_t,
                         torch.where(pv < 0, -tau_t, tau_t), pv)
        Pan[:, k, k] = pv
        if k + 1 < R:
            colv = Pan[:, k + 1:, k] / pv[:, None]
            Pan[:, k + 1:, k + 1:] = fma_plain(-colv[:, :, None],
                                               Pan[:, k, None, k + 1:],
                                               Pan[:, k + 1:, k + 1:])
            Pan[:, k + 1:, k] = colv
    return Pan, piv, seq_to_perm(piv, R)


def pivoted_panel(Pan: torch.Tensor, off: int, p_arr: torch.Tensor,
                  tau: float = 0.0):
    """Restricted-pivot panel LU: Pan (B, R, T) float64 (K1) or float32
    (K2) contiguous, p_arr (B,) int32 true eliminated counts, tau the GESP
    threshold (taken at Pan's dtype). Returns (a new factored panel, piv
    (B, T) int32, perm (B, R) int64). CPU tensors take the plain version;
    CUDA tensors launch csrc/pivoted_panel.cu on clusters of
    panel_launch_config's size (which raises for a panel too tall for it)."""
    if Pan.dim() != 3:
        raise ValueError(f"Pan: expected (B, R, T), got {tuple(Pan.shape)}")
    B, R, T = Pan.shape
    sfx = _float_dtype(Pan, "Pan")
    _check(Pan, "Pan", Pan.dtype, (B, R, T))
    _check(p_arr, "p_arr", torch.int32, (B,))
    if T > PANEL_MAX_T or R < T:
        raise ValueError(f"panel (R={R}, T={T}) needs T <= {PANEL_MAX_T} "
                         f"and R >= T")
    if _route(Pan, p_arr) == "cpu":
        return pivoted_panel_plain(Pan, off, p_arr, tau)
    piv = torch.empty((B, T), dtype=torch.int32, device=Pan.device)
    if B == 0 or T == 0:
        return Pan.clone(), piv, seq_to_perm(piv, R)
    perm = torch.empty((B, R), dtype=torch.int64, device=Pan.device)
    lib = build()
    C, nb = panel_launch_config(B, R, T, Pan.element_size(),
                                active_clusters)
    out = torch.empty_like(Pan)
    # column slabs keep the rows by original index in a scratch copy
    work = Pan.clone() if nb < T else Pan
    err = getattr(lib, f"nk_pivoted_panel_{sfx}")(
        work.data_ptr(), out.data_ptr(), piv.data_ptr(), perm.data_ptr(),
        p_arr.data_ptr(), B, R, T, int(off), float(tau), C, nb,
        _stream(Pan.device))
    if err:
        raise RuntimeError(f"pivoted_panel_{sfx} kernel launch failed "
                           f"(B={B}, R={R}, T={T}, cluster {C}, slab {nb}): "
                           f"CUDA error {err}")
    LAUNCHES[f"pivoted_panel_{sfx}"] += 1
    return out, piv, perm


# --------------------------------------------------------------------------
# K3: ELL front assembly
# --------------------------------------------------------------------------

def ell_assemble_plain(nzval_ext, a_col, a_csrc, a_pos, a_src, p_arr,
                       N: int, P: int, spill: bool = True):
    """mf_jax._assemble (scatter form) in PyTorch: the ELL scatter-add,
    then the spill entries, then the identity on unused pivot positions."""
    B, R, W = a_col.shape
    dev = nzval_ext.device
    F = torch.zeros((B, R, N), dtype=nzval_ext.dtype, device=dev)
    bi = torch.arange(B, device=dev)[:, None, None].expand(B, R, W)
    ri = torch.arange(R, device=dev)[None, :, None].expand(B, R, W)
    F.index_put_((bi, ri, a_col), nzval_ext[a_csrc], accumulate=True)
    if spill:
        E = a_pos.shape[1]
        Ff = F.view(B, N * N)
        real = a_pos < N * N
        be = torch.arange(B, device=dev)[:, None].expand(B, E)
        Ff.index_put_((be[real], a_pos[real]), nzval_ext[a_src[real]],
                      accumulate=True)
    ar = torch.arange(P, device=dev)
    eye = (ar[None, :] >= p_arr.to(torch.int64)[:, None]).to(F.dtype)
    F[:, ar, ar] += eye
    return F


def ell_assemble(nzval_ext, a_col, a_csrc, a_pos, a_src, p_arr,
                 N: int, P: int, spill: bool = True) -> torch.Tensor:
    """Assemble one round's fronts F (B, N, N) at nzval_ext's dtype
    (float64 or float32) from the CSR values nzval_ext (nnz + 1,) (last
    entry zero) and the round plan's ELL
    (a_col, a_csrc: (B, N, W) int64) and spill (a_pos, a_src: (B, E)
    int64) maps; p_arr (B,) int32. CPU tensors take the plain version; CUDA
    tensors launch csrc/ell_assemble.cu."""
    if a_col.dim() != 3 or a_pos.dim() != 2:
        raise ValueError("a_col must be (B, N, W) and a_pos (B, E)")
    B, R, W = a_col.shape
    E = a_pos.shape[1]
    if R != N:
        raise ValueError(f"a_col has {R} rows for fronts of size {N}")
    sfx = _float_dtype(nzval_ext, "nzval_ext")
    _check(nzval_ext, "nzval_ext", nzval_ext.dtype, (nzval_ext.shape[0],))
    for name, t, shape in (("a_col", a_col, (B, N, W)),
                           ("a_csrc", a_csrc, (B, N, W)),
                           ("a_pos", a_pos, (B, E)), ("a_src", a_src, (B, E))):
        _check(t, name, torch.int64, shape)
    _check(p_arr, "p_arr", torch.int32, (B,))
    if _route(nzval_ext, a_col, a_csrc, a_pos, a_src, p_arr) == "cpu":
        return ell_assemble_plain(nzval_ext, a_col, a_csrc, a_pos, a_src,
                                  p_arr, N, P, spill)
    lib = build()
    F = torch.zeros((B, N, N), dtype=nzval_ext.dtype,
                    device=nzval_ext.device)
    err = getattr(lib, f"nk_ell_assemble_{sfx}")(
        F.data_ptr(), nzval_ext.data_ptr(), a_col.data_ptr(),
        a_csrc.data_ptr(), a_pos.data_ptr(), a_src.data_ptr(),
        p_arr.data_ptr(), B, N, W, E, P, nzval_ext.shape[0] - 1,
        int(bool(spill)), _stream(nzval_ext.device))
    if err:
        raise RuntimeError(f"ell_assemble_{sfx} kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[f"ell_assemble_{sfx}"] += 1
    return F


# --------------------------------------------------------------------------
# the refiner's float64 product
# --------------------------------------------------------------------------

def csr_matvec_plain(col, val, x):
    """A x in PyTorch for the ELL operands col / val (n, E), pads (column
    n) after each row's entries: each row's products summed in ELL order
    from zero, as scipy's CSR product sums them. A pad adds nothing, not
    even a zero's sign."""
    n, E = col.shape
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    acc = x.new_zeros((n, x.shape[1]))
    for k in range(E):
        ck = col[:, k]
        acc = torch.where((ck < n)[:, None],
                          acc + val[:, k, None] * xp[ck], acc)
    return acc


def csr_matvec(col, val, x) -> torch.Tensor:
    """y = A x, float64, for x (n, nrhs) contiguous and the ELL operands
    col (n, E) int64 (pads = n after each row's entries) and val (n, E)
    float64. CPU tensors take the plain version; CUDA tensors launch
    csrc/csr_matvec.cu. Both give scipy's CSR product's bits."""
    if col.dim() != 2 or x.dim() != 2:
        raise ValueError(f"col must be (n, E) and x (n, nrhs), got "
                         f"{tuple(col.shape)} and {tuple(x.shape)}")
    n, E = col.shape
    nrhs = x.shape[1]
    _check(col, "col", torch.int64, (n, E))
    _check(val, "val", torch.float64, (n, E))
    _check(x, "x", torch.float64, (n, nrhs))
    if _route(col, val, x) == "cpu":
        return csr_matvec_plain(col, val, x)
    lib = build()
    y = torch.empty_like(x)
    err = lib.nk_csr_matvec_f64(y.data_ptr(), x.data_ptr(), col.data_ptr(),
                                val.data_ptr(), n, E, nrhs,
                                _stream(x.device))
    if err:
        raise RuntimeError(f"csr_matvec_f64 kernel launch failed (n={n}, "
                           f"E={E}, nrhs={nrhs}): CUDA error {err}")
    LAUNCHES["csr_matvec_f64"] += 1
    return y

