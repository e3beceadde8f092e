// Front assembly of one factor round, float64 and float32 (kernel K3), one
// template.
//
// Replaces the Pallas kernel pallas_ell_assemble
// (nk_ocn_tracer_jacobian_precond_tpu/solver/pallas_kernels.py), which
// built out[b, r, n] = sum_w vals[b, r, w] * (a_col[b, r, w] == n) as a
// compare-and-select over a VMEM tile in f32, and takes over the rest of
// mf_jax._assemble: the spill scatter and the identity padding of unused
// pivot positions. The result equals _assemble(impl="scatter") bit for bit
// at either dtype.
//
// Each (b, r) row of a front has at most one entry per column and the spill
// positions are distinct from the ELL positions, so every value is a plain
// store: no atomics and no compare loop. ELL pads carry a_col = 0 and the
// sentinel source a_csrc == nnz (the appended zero); they are skipped, since
// a store would overwrite a real column-0 entry. Spill pads sit at
// positions >= N * N and are skipped too. A second kernel, ordered after the
// first on the same stream, adds 1 on (r, r) for p_arr[b] <= r < P.
//
// What bounds it: device-memory bandwidth. The caller's zero fill writes
// B * N * N elements (2 GB in the largest gx3 round at f64) while the stores
// touch only the nonzeros, so the launch itself is a sparse scatter of
// B * N * W + B * E reads. Fusing the zero fill into the kernel (one write
// per element) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename S>
__global__ void __launch_bounds__(kThreads)
ell_store_kernel(S* __restrict__ F, const S* __restrict__ nz,
                 const int64_t* __restrict__ a_col,
                 const int64_t* __restrict__ a_csrc, int64_t n_ell, int64_t W,
                 int64_t N, int64_t sentinel,
                 const int64_t* __restrict__ a_pos,
                 const int64_t* __restrict__ a_src, int64_t n_spill,
                 int64_t E) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_ell) {
    const int64_t src = a_csrc[i];
    if (src == sentinel) return;
    const int64_t br = i / W;  // b * N + r
    F[br * N + a_col[i]] = nz[src];
  } else if (i < n_ell + n_spill) {
    const int64_t j = i - n_ell;
    const int64_t NN = N * N;
    const int64_t pos = a_pos[j];
    if (pos >= NN) return;
    F[(j / E) * NN + pos] = nz[a_src[j]];
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
identity_pad_kernel(S* __restrict__ F, const int32_t* __restrict__ p_arr,
                    int64_t B, int64_t N, int64_t P) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * P) return;
  const int64_t b = i / P;
  const int64_t r = i - b * P;
  if (r >= p_arr[b]) F[(b * N + r) * N + r] += S(1);
}

template <typename S>
int launch(void* F, const void* nz, const void* a_col, const void* a_csrc,
           const void* a_pos, const void* a_src, const void* p_arr, int64_t B,
           int64_t N, int64_t W, int64_t E, int64_t P, int64_t nnz, int spill,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_ell = B * N * W;
  const int64_t n_spill = spill ? B * E : 0;
  const int64_t n_store = n_ell + n_spill;
  if (n_store > 0) {
    const int64_t blocks = (n_store + kThreads - 1) / kThreads;
    ell_store_kernel<S><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<S*>(F), static_cast<const S*>(nz),
        static_cast<const int64_t*>(a_col), static_cast<const int64_t*>(a_csrc),
        n_ell, W, N, nnz, static_cast<const int64_t*>(a_pos),
        static_cast<const int64_t*>(a_src), n_spill, E);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B * P > 0) {
    const int64_t blocks = (B * P + kThreads - 1) / kThreads;
    identity_pad_kernel<S><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<S*>(F), static_cast<const int32_t*>(p_arr), B, N, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F (B, N, N) must hold zeros. a_col / a_csrc (B, N, W), a_pos / a_src
// (B, E) int64; p_arr (B,) int32; nz (nnz + 1,) with nz[nnz] == 0, of F's
// dtype. Returns the cudaError_t of the launches (0 when both were
// accepted).
extern "C" int nk_ell_assemble_f64(void* F, const void* nz, const void* a_col,
                                   const void* a_csrc, const void* a_pos,
                                   const void* a_src, const void* p_arr,
                                   int64_t B, int64_t N, int64_t W, int64_t E,
                                   int64_t P, int64_t nnz, int spill,
                                   void* stream) {
  return launch<double>(F, nz, a_col, a_csrc, a_pos, a_src, p_arr, B, N, W, E,
                        P, nnz, spill, stream);
}

extern "C" int nk_ell_assemble_f32(void* F, const void* nz, const void* a_col,
                                   const void* a_csrc, const void* a_pos,
                                   const void* a_src, const void* p_arr,
                                   int64_t B, int64_t N, int64_t W, int64_t E,
                                   int64_t P, int64_t nnz, int spill,
                                   void* stream) {
  return launch<float>(F, nz, a_col, a_csrc, a_pos, a_src, p_arr, B, N, W, E,
                       P, nnz, spill, stream);
}
