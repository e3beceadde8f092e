// The diagonal step of the solve's block substitution, read straight from
// the packed pivot block:
//   lower:  y = t + stril(KD, -1) t
//   upper:  x = triu(KD) t
// with t = rhs - g (g, the off-diagonal product of the block row, may be
// absent) and KD a T x T diagonal block of the packed pivot factor K (the
// mf_torch.pack_diag_inv layout: the unit-lower inverse below the
// diagonal, the upper inverse on and above it, in one square).
//
// It replaces no Pallas kernel: the JAX package applies the same triangles
// with jnp.tril / jnp.triu and a matrix product (mf_jax._block_lower_apply /
// _block_upper_apply). In PyTorch that route forms a half-zero copy of the
// square and reads it again in a batched gemv: three block-sizes of
// traffic for each block and direction, where half of one does.
//
// What bounds it: device-memory bandwidth. A block and direction are
// T^2 / 2 entries at 2 nrhs flops each, far below the card's FP64 ridge;
// the least traffic is the triangle's bytes at 3.35 TB/s (t, g and the
// result are T nrhs values each).
//
// The sum order, the same for the kernel and the plain version
// (cuda_kernels.tri_block_apply_plain), so the two agree bit for bit: with
// w the least power of two >= T (at most 32), row i's products
// KD[i, k] t[k] of the entries k = l (mod w) are summed from zero in
// ascending k for each "lane" l (acc + a * t, one product and one add,
// each rounded: the library is built with --fmad=false), then the lanes'
// sums pairwise, l with l + w/2, then l + w/4, down to 1. Every output row
// has one owner and no atomics, so the order is fixed.
//
// K is row-major (mf_torch.pack_diag_inv writes it so on every round), so
// a row of the triangle is contiguous: a group of w lanes of a warp owns a
// pair of output rows, i and T-1-i (the pair holds T-1 or T+1 entries,
// whatever i is), lane l reads its row's entries k = l (mod w), and the
// group sums its lanes by an xor butterfly (offsets w/2, ..., 1). A block
// holds several small fronts (the many whole fronts of the low rounds) or
// a slice of the pairs of one block (the top rounds, B = 1).
//
// t (rhs - g, formed as it is loaded) sits in shared memory by column, and
// right-hand sides are taken NR at a time (a power of two up to 8), each
// column with its own accumulator. The kernel launches on the caller's
// stream, allocates nothing and never synchronises, so a CUDA graph
// captures it as it is.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSmem = 227 * 1024;
constexpr int kSms = 132;
constexpr int kUnroll = 8;          // row entries a lane loads at once

// t = rhs - g of the n rows of nf fronts from b0, columns [j0, j0 + NR)
// (zero past nrhs), into ts[(f * NR + j) * n + k]
template <typename V, int NR>
__device__ void load_t(V* ts, const V* __restrict__ rhs, int64_t rhs_sb,
                       int64_t rhs_sr, const V* __restrict__ g, int64_t b0,
                       int nf, int n, int j0, int nrhs) {
  const int total = nf * n * NR;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int j = idx % NR;
    const int k = (idx / NR) % n;
    const int f = idx / (NR * n);
    V v = V(0);
    if (j0 + j < nrhs) {
      const int64_t b = b0 + f;
      v = rhs[b * rhs_sb + k * rhs_sr + j0 + j];
      if (g != nullptr) v = v - g[(b * n + k) * nrhs + j0 + j];
    }
    ts[(f * NR + j) * n + k] = v;
  }
}

template <typename V, int NR>
__global__ void tri_block_apply(
    V* __restrict__ out, int64_t out_sb, int64_t out_sr,
    const V* __restrict__ rhs, int64_t rhs_sb, int64_t rhs_sr,
    const V* __restrict__ g, const V* __restrict__ kd, int64_t kd_sb,
    int64_t kd_sr, int64_t B, int n, int nrhs, int lower, int w, int F,
    int chunks, int ppg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* ts = reinterpret_cast<V*>(smem_raw);
  const int64_t b0 = static_cast<int64_t>(blockIdx.x / chunks) * F;
  const int ch = blockIdx.x % chunks;
  const int j0 = blockIdx.y * NR;
  const int nf = B - b0 < F ? static_cast<int>(B - b0) : F;
  load_t<V, NR>(ts, rhs, rhs_sb, rhs_sr, g, b0, nf, n, j0, nrhs);
  __syncthreads();

  const int groups = blockDim.x / w;
  const int l = threadIdx.x % w;
  const int np = (n + 1) / 2;
  for (int q = 0; q < ppg; ++q) {
    const int gg = (ch * ppg + q) * groups + threadIdx.x / w;
    const int f = gg / np;
    const int p = gg % np;
    const bool live = f < nf;
    const int64_t b = b0 + f;
    const V* tcol = ts + static_cast<int64_t>(f) * NR * n;
    // the pair's two rows; the middle row of an odd n has no partner
    for (int slot = 0; slot < 2; ++slot) {
      const int r = slot == 0 ? p : n - 1 - p;
      const bool mine = live && (slot == 0 || r != p);
      int k = 0, kend = 0;
      if (mine) {
        k = lower ? l : r + ((l - r % w) + w) % w;
        kend = lower ? r : n;
      }
      V acc[NR];
#pragma unroll
      for (int j = 0; j < NR; ++j) acc[j] = V(0);
      const V* row = kd + b * kd_sb + static_cast<int64_t>(r) * kd_sr;
      // kUnroll entries a lane in flight at once: whole batches, then the
      // rest (fewer than kUnroll * w entries) in one batch cut short by
      // predicates (an entry past the row is neither loaded nor added)
      for (; k + (kUnroll - 1) * w < kend; k += kUnroll * w) {
        V a[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a[u] = row[k + u * w];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int j = 0; j < NR; ++j)
            acc[j] = acc[j] + a[u] * tcol[j * n + k + u * w];
        }
      }
      if (k < kend) {
        V a[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          a[u] = k + u * w < kend ? row[k + u * w] : V(0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k + u * w < kend) {
#pragma unroll
            for (int j = 0; j < NR; ++j)
              acc[j] = acc[j] + a[u] * tcol[j * n + k + u * w];
          }
        }
      }
      // every lane of the warp takes part, live or not
      for (int off = w / 2; off >= 1; off /= 2) {
#pragma unroll
        for (int j = 0; j < NR; ++j)
          acc[j] = acc[j] + __shfl_xor_sync(0xffffffffu, acc[j], off);
      }
      if (mine) {
        V* o = out + b * out_sb + static_cast<int64_t>(r) * out_sr + j0;
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          if (j % w == l && j0 + j < nrhs)
            o[j] = lower ? tcol[j * n + r] + acc[j] : acc[j];
        }
      }
    }
  }
}

int group_width(int64_t n) {
  int w = 1;
  while (w < n && w < 32) w *= 2;
  return w;
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <typename V, int NR>
int launch(V* out, int64_t out_sb, int64_t out_sr, const V* rhs,
           int64_t rhs_sb, int64_t rhs_sr, const V* g, const V* kd,
           int64_t kd_sb, int64_t kd_sr, int64_t B, int n, int nrhs,
           int lower, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = allow_smem(tri_block_apply<V, NR>);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int w = group_width(n);
  const int np = (n + 1) / 2;
  // 8 warps a block, so that t, read once a block, costs each thread few
  // loads (a block of fewer warps on a large T spends its time loading
  // t). At NR columns each group takes up to NR / 2 pairs, so that t
  // stays a small share of the block's bytes, and fewer where that would
  // leave under two blocks an SM
  const int groups = 8 * 32 / w;
  int ppg = NR > 2 ? NR / 2 : 1, F = 1, chunks = 1;
  int64_t blocks = 0;
  for (;;) {
    if (np <= groups) {
      F = groups / np;
      chunks = 1;
      ppg = 1;
    } else {
      F = 1;
      chunks = (np + groups * ppg - 1) / (groups * ppg);
    }
    blocks = (B + F - 1) / F * chunks;
    if (blocks >= 2 * kSms || ppg == 1) break;
    ppg /= 2;
  }
  const int64_t smem = static_cast<int64_t>(F) * n * NR * sizeof(V);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((nrhs + NR - 1) / NR));
  tri_block_apply<V, NR><<<grid, 256, smem, stream>>>(
      out, out_sb, out_sr, rhs, rhs_sb, rhs_sr, g, kd, kd_sb, kd_sr, B, n,
      nrhs, lower, w, F, chunks, ppg);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int dispatch(void* out, int64_t out_sb, int64_t out_sr, const void* rhs,
             int64_t rhs_sb, int64_t rhs_sr, const void* g, const void* kd,
             int64_t kd_sb, int64_t kd_sr, int64_t B, int64_t n,
             int64_t nrhs, int lower, void* stream) {
  if (B <= 0 || n <= 0 || nrhs <= 0) return 0;
  if (n > 4096 || B > (int64_t(1) << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  // the widest column chunk (a power of two up to 8) whose t fits
  int NR = 1;
  while (NR < nrhs && NR < 8) NR *= 2;
  while (NR > 1 && n * NR * static_cast<int64_t>(sizeof(V)) > kMaxSmem)
    NR /= 2;
  V* o = static_cast<V*>(out);
  const V* r = static_cast<const V*>(rhs);
  const V* gg = static_cast<const V*>(g);
  const V* k = static_cast<const V*>(kd);
  const int ni = static_cast<int>(n), ci = static_cast<int>(nrhs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NR) {
    case 1:
      return launch<V, 1>(o, out_sb, out_sr, r, rhs_sb, rhs_sr, gg, k, kd_sb,
                          kd_sr, B, ni, ci, lower, s);
    case 2:
      return launch<V, 2>(o, out_sb, out_sr, r, rhs_sb, rhs_sr, gg, k, kd_sb,
                          kd_sr, B, ni, ci, lower, s);
    case 4:
      return launch<V, 4>(o, out_sb, out_sr, r, rhs_sb, rhs_sr, gg, k, kd_sb,
                          kd_sr, B, ni, ci, lower, s);
    default:
      return launch<V, 8>(o, out_sb, out_sr, r, rhs_sb, rhs_sr, gg, k, kd_sb,
                          kd_sr, B, ni, ci, lower, s);
  }
}

}  // namespace

// out, rhs (B, n, nrhs) with unit column stride and the given batch and
// row strides; g null or (B, n, nrhs) contiguous; kd the (B, n, n)
// diagonal blocks with the given batch and row strides and unit column
// stride. out must not overlap rhs, g or kd. lower != 0 gives
// out = t + stril(kd, -1) t, lower == 0 gives out = triu(kd) t, with
// t = rhs - g. Returns the cudaError_t of the launch (0 when accepted;
// cudaErrorInvalidValue for n > 4096).
extern "C" int nk_tri_block_apply_f64(void* out, int64_t out_sb,
                                      int64_t out_sr, const void* rhs,
                                      int64_t rhs_sb, int64_t rhs_sr,
                                      const void* g, const void* kd,
                                      int64_t kd_sb, int64_t kd_sr,
                                      int64_t B, int64_t n, int64_t nrhs,
                                      int lower, void* stream) {
  return dispatch<double>(out, out_sb, out_sr, rhs, rhs_sb, rhs_sr, g, kd,
                          kd_sb, kd_sr, B, n, nrhs, lower, stream);
}

extern "C" int nk_tri_block_apply_f32(void* out, int64_t out_sb,
                                      int64_t out_sr, const void* rhs,
                                      int64_t rhs_sb, int64_t rhs_sr,
                                      const void* g, const void* kd,
                                      int64_t kd_sb, int64_t kd_sr,
                                      int64_t B, int64_t n, int64_t nrhs,
                                      int lower, void* stream) {
  return dispatch<float>(out, out_sb, out_sr, rhs, rhs_sb, rhs_sr, g, kd,
                         kd_sb, kd_sr, B, n, nrhs, lower, stream);
}
