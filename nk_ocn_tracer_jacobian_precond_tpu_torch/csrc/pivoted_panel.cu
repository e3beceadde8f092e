// Batched restricted-pivot panel LU in native float64 (kernel K1) and
// float32 (kernel K2), one template, with the row permutation composed on
// the card.
//
// K1 replaces the Pallas kernel pallas_pivoted_panel_df64 and K2 replaces
// pallas_pivoted_panel (both in
// nk_ocn_tracer_jacobian_precond_tpu/solver/pallas_kernels.py). The TPU
// ran the f64 panel in double-f32 planes because it has no f64; the H100
// has native FP64, so K1 works on the f64 panel directly. Each instance
// computes exactly what mf_jax._pivoted_panel computes at its dtype, and
// also writes perm, the composition of the swap sequence that
// mf_jax._seq_to_perm computes from piv.
//
// For each front b and each column step k < T:
//   * pick the first row of max |P[r, k]| over rows r >= k that may pivot
//     (global row off + r < p_arr[b], or r == k); other rows score -1, and
//     ties go to the lowest row, as jnp.argmax does (NaN above all);
//   * swap rows k and sel over all T columns, record sel in piv[b, k] and
//     swap perm[k] and perm[sel];
//   * clamp a pivot with |pv| < tau to +-tau (pv == 0 gives +tau);
//   * divide the column below k by pv (a division, not a product with 1/pv);
//   * rank-1 update P[r, c] = fma(-l[r], u[c], P[r, c]) for r > k, c > k.
// Each update is one fused multiply-add on the CUDA cores, rounded once, in
// ascending k for every element: XLA on the CPU contracts the reference's
// P - l * u that way at both dtypes, and the plain PyTorch version emulates
// the same single rounding (cuda_kernels.fma_plain), so kernel, plain
// version and JAX reference agree bit for bit. No tensor-core MMA (DMMA):
// its in-instruction sums would round differently. The library is built
// with --fmad=false, so that no other expression is contracted behind the
// source's back; float division stays IEEE (-prec-div is on by default).
//
// What bounds it, and the design. The panel's bytes (each read once and
// written once) bound it: a (256, 512, 128) f64 panel is 134 MB, 80 us at
// 3.35 TB/s, against 58 us for its 2 GFLOP of FP64 FMAs. The first port
// kept the panel in global memory and rewrote the trailing block at every
// one of the T dependent steps, one block per front: ~16 GB of traffic for
// 0.27 GB of data, and few-front rounds used few SMs. Here the panel stays
// on chip for all T steps, as the TPU kernel kept it in VMEM:
//   * a front's rows are spread over a thread-block cluster of C CTAs
//     (C <= 8); rank j holds the contiguous row slice [j*rows, (j+1)*rows)
//     in dynamic shared memory, so the panel is read from HBM once and
//     written once;
//   * each step takes three block barriers and, for C > 1, one cluster
//     barrier: every warp reduces the pivot search over the CTA's rows
//     itself; with C > 1 every CTA publishes its best row and score (and
//     the owner of row k its row k) in double-buffered shared slots, and
//     after the cluster barrier every warp reads the C scores through
//     distributed shared memory (ranks own ascending row ranges, so the
//     lowest-row tie rule carries over); the pivot row is copied from the
//     winner's slot, the owners of rows k and sel swap them (with their
//     perm entries) from the published copies, and the multipliers of the
//     CTA's rows are computed in the same pass; the rank-1 update then
//     runs on each CTA's own rows. With C = 1 the swap is done in place
//     and nothing is published, and the CTA has 512 threads (256 in a
//     cluster, where more CTAs share an SM);
//   * the wrapper picks C from B, R and the dtype (panel_launch_config in
//     cuda_kernels.py): a cost model fitted to scripts/panel_sweep.py on
//     the card, fed with the card's own count of active clusters. One
//     CTA per front wins on short panels with many fronts, a cluster of
//     8 on tall panels with few;
//   * a panel too tall for the cluster's shared memory is walked in column
//     slabs of width nb < T, each resident on chip while it is factored.
//     Rows are then kept by their original index in a global work copy;
//     a slab is gathered through perm when it is loaded, receives the
//     earlier slabs' updates left-looking (the same fma chain in the same
//     ascending order, L read from the work copy), is factored as above
//     and written back; the last slab writes the output through perm. The
//     whole panel is the case nb = T.
// What still bounds it is latency: the T steps depend on each other, and a
// step costs about 2 us with one CTA and 3 us in a cluster on an H100
// (scripts/panel_sweep.py), so a panel takes 0.26-0.4 ms at the least,
// far above its bytes' bound. Fewer, cheaper barriers per step (or
// several columns per step) are the next work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// threads per CTA: 512 when one CTA holds the whole front (C = 1), 256 in
// a cluster (more CTAs then share an SM)
constexpr int kThreadsSolo = 512;
constexpr int kThreadsCluster = 256;
constexpr int kMaxWarps = kThreadsSolo / 32;
constexpr int kMaxT = 128;
constexpr int kMaxCluster = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's dynamic maximum

__device__ __forceinline__ double fused(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fused(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ float absval(float x) { return fabsf(x); }

// jnp.argmax order on (score, row): NaN above every number, then the larger
// score, ties to the lower row.
template <typename S>
__device__ __forceinline__ bool better(S s1, int r1, S s2, int r2) {
  const bool n1 = isnan(s1), n2 = isnan(s2);
  if (n1 || n2) return n1 && (!n2 || r1 < r2);
  return s1 > s2 || (s1 == s2 && r1 < r2);
}

template <typename S>
__device__ __forceinline__ void warp_argmax(S& s, int& r) {
  for (int o = 16; o > 0; o >>= 1) {
    const S s2 = __shfl_down_sync(0xffffffffu, s, o);
    const int r2 = __shfl_down_sync(0xffffffffu, r, o);
    if (better(s2, r2, s, r)) {
      s = s2;
      r = r2;
    }
  }
}

// Dynamic shared memory of one CTA: the slab (rows x nb), the pivot row,
// two published best rows and two published rows k, the left-looking
// multipliers, then the scalars and the CTA's perm entries.
template <typename S>
struct Smem {
  S* slab;     // rows * nb
  S* prow;     // nb
  S* pub;      // 2 * nb: this CTA's best row, by step parity
  S* kpub;     // 2 * nb: row k, published by its owner
  S* lcol;     // rows
  S* cand_s;   // 2
  S* red_s;    // kMaxWarps
  int* perm;   // rows
  int* cand_r;     // 2
  int* pub_perm;   // 2
  int* kpub_perm;  // 2
  int* red_r;      // kMaxWarps
};

__host__ __device__ inline size_t smem_bytes(int rows, int nb, int itemsize) {
  const size_t s = static_cast<size_t>(rows) * nb + 5 * static_cast<size_t>(nb)
                   + rows + 2 + kMaxWarps;
  const size_t i = static_cast<size_t>(rows) + 6 + kMaxWarps;
  return (s * itemsize + i * sizeof(int) + 15) / 16 * 16;
}

template <typename S>
__device__ Smem<S> carve(unsigned char* base, int rows, int nb) {
  Smem<S> m;
  S* p = reinterpret_cast<S*>(base);
  m.slab = p;
  p += static_cast<size_t>(rows) * nb;
  m.prow = p;
  p += nb;
  m.pub = p;
  p += 2 * nb;
  m.kpub = p;
  p += 2 * nb;
  m.lcol = p;
  p += rows;
  m.cand_s = p;
  p += 2;
  m.red_s = p;
  p += kMaxWarps;
  int* q = reinterpret_cast<int*>(p);
  m.perm = q;
  q += rows;
  m.cand_r = q;
  q += 2;
  m.pub_perm = q;
  q += 2;
  m.kpub_perm = q;
  q += 2;
  m.red_r = q;
  return m;
}

// work (B, R, T): the input panel; with several slabs, a copy that the
// kernel keeps by original row index. out (B, R, T) the factored panel,
// piv (B, T) int32, perm (B, R) int64.
template <typename S, int kThreads>
__global__ void __launch_bounds__(kThreads)
pivoted_panel_kernel(S* __restrict__ work, S* __restrict__ out,
                     int32_t* __restrict__ piv, int64_t* __restrict__ perm_out,
                     const int32_t* __restrict__ p_arr, int R, int T, int off,
                     S tau, int rows_per, int nb) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  Smem<S> m = carve<S>(smem_raw, rows_per, nb);
  const int lo = min(rank * rows_per, R);
  const int hi = min(lo + rows_per, R);
  const int nrow = hi - lo;
  const int limit = p_arr[b] - off;  // panel rows r < limit may pivot
  const S none = S(-2);              // below every score
  const bool multi = nb < T;
  S* W = work + static_cast<size_t>(b) * R * T;
  S* O = out + static_cast<size_t>(b) * R * T;

  for (int i = tid; i < nrow; i += kThreads) m.perm[i] = lo + i;

  for (int c0 = 0; c0 < T; c0 += nb) {
    const int w = min(nb, T - c0);
    __syncthreads();  // perm (set above, or by the last slab's steps)
    // load the slab's columns of the rows now at positions [lo, hi)
    for (int idx = tid; idx < nrow * w; idx += kThreads) {
      const int i = idx / w, c = idx - i * w;
      m.slab[i * nb + c] = W[static_cast<size_t>(m.perm[i]) * T + c0 + c];
    }
    // left-looking: the earlier columns' updates, k' ascending; U row k'
    // from its owner's slab, L from the work copy
    for (int k = 0; k < c0; ++k) {
      cluster.sync();
      const int owner = k / rows_per;
      const S* urow = cluster.map_shared_rank(m.slab, owner)
                      + static_cast<size_t>(k - owner * rows_per) * nb;
      for (int c = tid; c < w; c += kThreads) m.prow[c] = urow[c];
      const int r0 = max(lo, k + 1);
      for (int r = r0 + tid; r < hi; r += kThreads)
        m.lcol[r - lo] = W[static_cast<size_t>(m.perm[r - lo]) * T + k];
      __syncthreads();
      const int n = hi - r0;
      for (int idx = tid; idx < n * w; idx += kThreads) {
        const int i = r0 - lo + idx / w, c = idx % w;
        m.slab[i * nb + c] = fused(-m.lcol[i], m.prow[c], m.slab[i * nb + c]);
      }
    }

    for (int k = c0; k < c0 + w; ++k) {
      const int kc = k - c0;
      const int par = k & 1;
      const int owner_k = k / rows_per;
      __syncthreads();
      // 1. pivot search over this CTA's rows r >= k: per warp, then every
      //    warp reduces the warps' results itself
      S best = none;
      int bestr = INT_MAX;
      for (int r = max(lo, k) + tid; r < hi; r += kThreads) {
        const S s = (r < limit || r == k)
                        ? absval(m.slab[(r - lo) * nb + kc])
                        : S(-1);
        if (better(s, r, best, bestr)) {
          best = s;
          bestr = r;
        }
      }
      warp_argmax(best, bestr);
      if (lane == 0) {
        m.red_s[warp] = best;
        m.red_r[warp] = bestr;
      }
      __syncthreads();
      best = lane < kWarps ? m.red_s[lane] : none;
      bestr = lane < kWarps ? m.red_r[lane] : INT_MAX;
      warp_argmax(best, bestr);
      const int lb = __shfl_sync(0xffffffffu, bestr, 0);
      const S lbs = __shfl_sync(0xffffffffu, best, 0);
      int sel;
      S pv;
      const int r0 = max(lo, k + 1);
      if (C == 1) {
        // 2'. one CTA holds the whole panel: swap rows k and sel in place
        //     (column kc is left to the update pass), and the multipliers
        //     of rows > k into lcol, from values this pass does not write
        sel = lb;
        S* rk = m.slab + (k - lo) * nb;
        S* rs = m.slab + (sel - lo) * nb;
        pv = rs[kc];
        for (int c = tid; c < w; c += kThreads) {
          const S vk = rk[c], vs = rs[c];
          if (c != kc) {
            rk[c] = vs;
            rs[c] = vk;
          }
          m.prow[c] = vs;
        }
        if (absval(pv) < tau) pv = pv < S(0) ? -tau : tau;
        for (int r = r0 + tid; r < hi; r += kThreads)
          m.lcol[r - lo] = (r == sel ? rk[kc] : m.slab[(r - lo) * nb + kc]) / pv;
        if (tid == 0) {
          const int pk = m.perm[k - lo];
          m.perm[k - lo] = m.perm[sel - lo];
          m.perm[sel - lo] = pk;
          piv[static_cast<size_t>(b) * T + k] = sel;
        }
      } else {
        // 2. publish this CTA's best row, and row k if this CTA owns it
        S* pub = m.pub + par * nb;
        S* kpub = m.kpub + par * nb;
        if (lb != INT_MAX)
          for (int c = tid; c < w; c += kThreads)
            pub[c] = m.slab[(lb - lo) * nb + c];
        if (owner_k == rank)
          for (int c = tid; c < w; c += kThreads)
            kpub[c] = m.slab[(k - lo) * nb + c];
        if (tid == 0) {
          m.cand_s[par] = lbs;
          m.cand_r[par] = lb;
          m.pub_perm[par] = lb != INT_MAX ? m.perm[lb - lo] : 0;
          if (owner_k == rank) m.kpub_perm[par] = m.perm[k - lo];
        }
        cluster.sync();
        // 3. the cluster's pivot: every warp reduces the C published
        //    scores; then the pivot row, the swap and the multipliers of
        //    this CTA's rows > k, all from the published copies
        S s = none;
        int r = INT_MAX;
        if (lane < C) {
          s = *cluster.map_shared_rank(m.cand_s + par, lane);
          r = *cluster.map_shared_rank(m.cand_r + par, lane);
        }
        warp_argmax(s, r);
        sel = __shfl_sync(0xffffffffu, r, 0);
        const int owner_s = sel / rows_per;
        const S* rpub = cluster.map_shared_rank(pub, owner_s);
        const S* rkpub = cluster.map_shared_rank(kpub, owner_k);
        pv = rpub[kc];
        if (absval(pv) < tau) pv = pv < S(0) ? -tau : tau;
        for (int c = tid; c < w; c += kThreads) {
          const S v = rpub[c];
          m.prow[c] = v;
          if (owner_k == rank) m.slab[(k - lo) * nb + c] = v;
          if (owner_s == rank && sel != k)
            m.slab[(sel - lo) * nb + c] = rkpub[c];
        }
        for (int q = r0 + tid; q < hi; q += kThreads)
          m.lcol[q - lo] =
              (q == sel ? rkpub[kc] : m.slab[(q - lo) * nb + kc]) / pv;
        if (tid == 0) {
          if (owner_k == rank)
            m.perm[k - lo] = *cluster.map_shared_rank(m.pub_perm + par,
                                                      owner_s);
          if (owner_s == rank && sel != k)
            m.perm[sel - lo] = *cluster.map_shared_rank(m.kpub_perm + par,
                                                        owner_k);
          if (rank == 0) piv[static_cast<size_t>(b) * T + k] = sel;
        }
      }
      __syncthreads();
      // 4. the GESP-clamped pivot into row k, then the rank-1 update of
      //    this CTA's rows > k over columns >= kc (column kc takes the
      //    multiplier)
      if (owner_k == rank && tid == 0) m.slab[(k - lo) * nb + kc] = pv;
      // element idx = tid + j * kThreads of the (rows > k) x (columns >=
      // kc) block, its row and column stepped without a division
      const int n = hi - r0, nc = w - kc;
      const int di = kThreads / nc, dc = kThreads % nc;
      for (int i = tid / nc, c = tid % nc; i < n;) {
        const int ii = r0 - lo + i, cc = kc + c;
        m.slab[ii * nb + cc] = cc == kc ? m.lcol[ii]
                                        : fused(-m.lcol[ii], m.prow[cc],
                                                m.slab[ii * nb + cc]);
        i += di;
        c += dc;
        if (c >= nc) {
          c -= nc;
          ++i;
        }
      }
    }
    __syncthreads();

    if (c0 + w < T) {
      // more slabs: keep this slab's columns by original row index
      for (int idx = tid; idx < nrow * w; idx += kThreads) {
        const int i = idx / w, c = idx - i * w;
        W[static_cast<size_t>(m.perm[i]) * T + c0 + c] = m.slab[i * nb + c];
      }
      __threadfence();
      cluster.sync();
    } else {
      // the last slab: write the factored rows in their final order
      for (int idx = tid; idx < nrow * w; idx += kThreads) {
        const int i = idx / w, c = idx - i * w;
        O[static_cast<size_t>(lo + i) * T + c0 + c] = m.slab[i * nb + c];
      }
      if (multi) {
        for (int idx = tid; idx < nrow * c0; idx += kThreads) {
          const int i = idx / c0, c = idx - i * c0;
          O[static_cast<size_t>(lo + i) * T + c] =
              W[static_cast<size_t>(m.perm[i]) * T + c];
        }
      }
      for (int i = tid; i < nrow; i += kThreads)
        perm_out[static_cast<size_t>(b) * R + lo + i] = m.perm[i];
    }
  }
  // peers may still read this CTA's published rows and scores
  cluster.sync();
}

// The launch configuration of C CTAs per front, `rows` rows each, for B
// fronts; its kernel instance gets the dynamic shared memory it needs.
template <typename S, int kThreads>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      int64_t B, int64_t C, int rows, int nb, void* stream) {
  const size_t smem = smem_bytes(rows, nb, sizeof(S));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the instance's dynamic shared memory limit, raised when a launch needs
  // more than any before it
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        pivoted_panel_kernel<S, kThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Clusters of this configuration the card keeps active at once, or -1.
template <typename S, int kThreads>
int active(int64_t C, int rows, int nb) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (configure<S, kThreads>(cfg, attr, 1024, C, rows, nb, nullptr)
      != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, pivoted_panel_kernel<S, kThreads>,
                                     &cfg) != cudaSuccess)
    return -1;
  return n;
}

template <typename S, int kThreads>
int launch_with(void* work, void* out, void* piv, void* perm,
                const void* p_arr, int64_t B, int64_t R, int64_t T,
                int64_t off, S tau, int64_t C, int rows, int nb,
                void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  // (a configuration the card cannot schedule is refused by the launch)
  cudaError_t e = configure<S, kThreads>(cfg, attr, B, C, rows, nb, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, pivoted_panel_kernel<S, kThreads>,
                         static_cast<S*>(work), static_cast<S*>(out),
                         static_cast<int32_t*>(piv),
                         static_cast<int64_t*>(perm),
                         static_cast<const int32_t*>(p_arr),
                         static_cast<int>(R), static_cast<int>(T),
                         static_cast<int>(off), tau, rows, nb);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch(void* work, void* out, void* piv, void* perm, const void* p_arr,
           int64_t B, int64_t R, int64_t T, int64_t off, S tau,
           int64_t C, int64_t nb, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (T > kMaxT || R < T || R > INT_MAX / kMaxT || C < 1 || C > kMaxCluster
      || nb < 1 || nb > T || B * C > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = static_cast<int>((R + C - 1) / C);
  if (C == 1)
    return launch_with<S, kThreadsSolo>(work, out, piv, perm, p_arr, B, R, T,
                                        off, tau, C, rows,
                                        static_cast<int>(nb), stream);
  return launch_with<S, kThreadsCluster>(work, out, piv, perm, p_arr, B, R,
                                         T, off, tau, C, rows,
                                         static_cast<int>(nb), stream);
}

}  // namespace

// Factor B panels (B, R, T) from work into out, on clusters of C CTAs in
// column slabs of width nb (nb == T: the whole panel on chip; nb < T: work
// must be a scratch copy of the input, which the kernel overwrites). piv
// (B, T) int32 receives the chosen rows, perm (B, R) int64 their
// composition. Returns the cudaError_t of the launch (0 when accepted).
extern "C" int nk_pivoted_panel_f64(void* work, void* out, void* piv,
                                    void* perm, const void* p_arr, int64_t B,
                                    int64_t R, int64_t T, int64_t off,
                                    double tau, int64_t C, int64_t nb,
                                    void* stream) {
  return launch<double>(work, out, piv, perm, p_arr, B, R, T, off, tau, C, nb,
                        stream);
}

extern "C" int nk_pivoted_panel_f32(void* work, void* out, void* piv,
                                    void* perm, const void* p_arr, int64_t B,
                                    int64_t R, int64_t T, int64_t off,
                                    float tau, int64_t C, int64_t nb,
                                    void* stream) {
  return launch<float>(work, out, piv, perm, p_arr, B, R, T, off, tau, C, nb,
                       stream);
}

// The clusters of C CTAs with `rows` rows and an `nb`-wide slab that the
// card keeps active at once (cudaOccupancyMaxActiveClusters), or -1.
extern "C" int nk_pivoted_panel_active_clusters(int64_t C, int64_t rows,
                                                int64_t nb, int64_t itemsize) {
  if (C < 1 || C > kMaxCluster) return -1;
  const int r = static_cast<int>(rows), n = static_cast<int>(nb);
  if (itemsize == 8)
    return C == 1 ? active<double, kThreadsSolo>(C, r, n)
                  : active<double, kThreadsCluster>(C, r, n);
  return C == 1 ? active<float, kThreadsSolo>(C, r, n)
                : active<float, kThreadsCluster>(C, r, n);
}

// Dynamic shared memory of one CTA, in bytes, for a slice of `rows` rows
// and a slab `nb` columns wide (what cuda_kernels.panel_smem_bytes mirrors).
extern "C" int64_t nk_pivoted_panel_smem(int64_t rows, int64_t nb,
                                         int64_t itemsize) {
  return static_cast<int64_t>(smem_bytes(static_cast<int>(rows),
                                         static_cast<int>(nb),
                                         static_cast<int>(itemsize)));
}
