// Batched restricted-pivot panel LU in native float64 (kernel K1) and
// float32 (kernel K2), one template.
//
// K1 replaces the Pallas kernel pallas_pivoted_panel_df64 and K2 replaces
// pallas_pivoted_panel (both in
// nk_ocn_tracer_jacobian_precond_tpu/solver/pallas_kernels.py). The TPU
// ran the f64 panel in double-f32 planes because it has no f64; the H100
// has native FP64, so K1 works on the f64 panel directly. Each instance
// computes exactly what mf_jax._pivoted_panel computes at its dtype.
//
// For each front b (one thread block) and each column step k < T:
//   * pick the first row of max |P[r, k]| over rows r >= k that may pivot
//     (global row off + r < p_arr[b], or r == k); other rows score -1, and
//     ties go to the lowest row, as jnp.argmax does;
//   * swap rows k and sel over all T columns and record sel in piv[b, k];
//   * clamp a pivot with |pv| < tau to +-tau (pv == 0 gives +tau);
//   * divide the column below k by pv (a division, not a product with 1/pv);
//   * rank-1 update P[r, c] = fma(-l[r], u[c], P[r, c]) for r > k, c > k.
// The update is one fused multiply-add, rounded once: XLA on the CPU
// contracts the reference's P - l * u that way at both dtypes, and unfused
// the two differ by up to 1e-6 at f64 (and by up to 146 at f32) on fronts
// whose restricted pivoting lets elements grow. The plain PyTorch version
// emulates the same single rounding (cuda_kernels.fma_plain), so kernel,
// plain version and JAX reference agree bit for bit. The library is built
// with --fmad=false, so that no other expression is contracted behind the
// source's back; float division stays IEEE (-prec-div is on by default).
//
// What bounds it: latency. The T column steps depend on each other, and one
// block per front walks them with three block barriers a step; the panel
// stays in global memory (served by L2), since a (R, 128) panel fills the
// 227 KB of shared memory at about 220 rows in f64 and 440 rows in f32, and
// the TPU kernels' whole-panel-in-VMEM design does not carry over. Only
// the pivot row lives in shared memory. Rounds with few fronts use few SMs.
// Making it fast (column sub-blocks in shared memory with a GEMM between
// them, several blocks or a cluster per tall front) is later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 128;

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

template <typename S>
__global__ void __launch_bounds__(kThreads)
pivoted_panel_kernel(S* __restrict__ pan, int32_t* __restrict__ piv,
                     const int32_t* __restrict__ p_arr, int R, int T, int off,
                     S tau) {
  __shared__ S rowk[kMaxT];
  __shared__ S red_s[kWarps];
  __shared__ int red_r[kWarps];
  __shared__ int sel_sh;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  S* P = pan + static_cast<size_t>(b) * R * T;
  const int limit = p_arr[b] - off;  // panel rows r < limit may pivot
  const S none = S(-2);              // below every score

  for (int k = 0; k < T; ++k) {
    // 1. pivot search over rows r >= k (rows above k score -1 and can
    //    never win against row k, which always scores >= 0)
    S best = none;
    int bestr = INT_MAX;
    for (int r = k + tid; r < R; r += kThreads) {
      const S s = (r < limit || r == k)
                      ? absval(P[static_cast<size_t>(r) * T + k])
                      : S(-1);
      if (better(s, r, best, bestr)) {
        best = s;
        bestr = r;
      }
    }
    warp_argmax(best, bestr);
    if (lane == 0) {
      red_s[warp] = best;
      red_r[warp] = bestr;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? red_s[lane] : none;
      bestr = lane < kWarps ? red_r[lane] : INT_MAX;
      warp_argmax(best, bestr);
      if (lane == 0) sel_sh = bestr;
    }
    __syncthreads();
    const int sel = sel_sh;

    // 2. swap rows k and sel over every column; stage the new row k
    S* Pk = P + static_cast<size_t>(k) * T;
    S* Ps = P + static_cast<size_t>(sel) * T;
    for (int c = tid; c < T; c += kThreads) {
      const S vk = Pk[c];
      const S vs = Ps[c];
      Pk[c] = vs;
      Ps[c] = vk;
      rowk[c] = vs;
    }
    if (tid == 0) piv[static_cast<size_t>(b) * T + k] = sel;
    __syncthreads();

    // 3. GESP clamp of the pivot
    S pv = rowk[k];
    if (absval(pv) < tau) pv = pv < S(0) ? -tau : tau;
    if (tid == 0) Pk[k] = pv;

    // 4. multipliers and rank-1 update, one warp per row, lanes on columns
    for (int r = k + 1 + warp; r < R; r += kWarps) {
      S* row = P + static_cast<size_t>(r) * T;
      const S l = row[k] / pv;
      for (int c = k + 1 + lane; c < T; c += 32)
        row[c] = fused(-l, rowk[c], row[c]);
      __syncwarp();  // every lane has read row[k] before lane 0 replaces it
      if (lane == 0) row[k] = l;
    }
    __syncthreads();
  }
}

template <typename S>
int launch(void* pan, void* piv, const void* p_arr, int64_t B, int64_t R,
           int64_t T, int64_t off, S tau, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (T > kMaxT || R < T || R > INT_MAX / kMaxT || B > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  pivoted_panel_kernel<S><<<static_cast<unsigned>(B), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<S*>(pan), static_cast<int32_t*>(piv),
      static_cast<const int32_t*>(p_arr), static_cast<int>(R),
      static_cast<int>(T), static_cast<int>(off), tau);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Factor B panels (B, R, T) in place; piv (B, T) receives the chosen rows.
// Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int nk_pivoted_panel_f64(void* pan, void* piv, const void* p_arr,
                                    int64_t B, int64_t R, int64_t T,
                                    int64_t off, double tau, void* stream) {
  return launch<double>(pan, piv, p_arr, B, R, T, off, tau, stream);
}

extern "C" int nk_pivoted_panel_f32(void* pan, void* piv, const void* p_arr,
                                    int64_t B, int64_t R, int64_t T,
                                    int64_t off, float tau, void* stream) {
  return launch<float>(pan, piv, p_arr, B, R, T, off, tau, stream);
}
