// The refiner's float64 product y = A x on the card, from the padded
// row-major (ELL) copy of the CSR matrix that the refiner already holds.
// It serves the outer loop's residual (b - y, taken in PyTorch) and the
// float64 Krylov cycles' products.
//
// It replaces no Pallas kernel: the JAX refiner takes its residual on the
// host (scipy's CSR product). Here it keeps the refiner's outer loop on the
// card, and it computes what that host product computes, bit for bit:
//   * one thread owns a row and sums, for each right-hand side, the row's
//     products in ELL order, which is CSR order, from 0.0 as scipy's
//     csr_matvec(s) does (acc = acc + a * x, one product and one add, each
//     rounded);
//   * a row's pads sit after its entries, with column index n: the thread
//     stops at the first one.
// So b - y is scipy's B - A @ X, which forms A @ X first and then
// subtracts. The library is built with --fmad=false, so no multiply-add is
// contracted; the sum does not depend on the launch and takes no atomics,
// so ranks that hold the same x compute the same bits.
//
// What bounds it: device-memory bandwidth. The least traffic is nnz * 12
// bytes of values and int32 column indices, (n + 1) * 4 bytes of row
// pointers, the gathers of x (n * nrhs * 8 bytes at least once) and the
// write of y (n * nrhs * 8), at 3.35 TB/s on an H100 SXM. It reads more:
// the stored ELL operands, int64 indices and pads included, are
// n * E * 16 bytes (E the widest row).
// A block stages its rows' ELL entries in shared memory with coalesced
// loads first (a row's entries are E * 8 bytes apart from the next row's,
// so a warp reading one entry of each of 32 rows would touch 32 sectors),
// at a row stride of E rounded up to odd, which keeps a half-warp's 8-byte
// reads on distinct banks. Right-hand sides are taken 8 at a time, each
// with its own accumulator, so the staged entries are read once per 8.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRows = 128;       // rows (threads) per block
constexpr int kMinRows = 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kRhs = 8;             // right-hand sides per pass

__global__ void __launch_bounds__(kMaxRows)
csr_matvec_kernel(double* __restrict__ y, const double* __restrict__ x,
                  const int64_t* __restrict__ col,
                  const double* __restrict__ val, int64_t n, int64_t E,
                  int64_t Es, int64_t nrhs) {
  extern __shared__ double smem[];
  double* s_val = smem;
  int64_t* s_col = reinterpret_cast<int64_t*>(smem + blockDim.x * Es);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t rows = n - r0 < blockDim.x ? n - r0 : blockDim.x;
  const int64_t total = rows * E;
  for (int64_t i = threadIdx.x; i < total; i += blockDim.x) {
    const int64_t q = i / E;
    const int64_t k = i - q * E;
    s_val[q * Es + k] = val[r0 * E + i];
    s_col[q * Es + k] = col[r0 * E + i];
  }
  __syncthreads();
  if (threadIdx.x >= rows) return;
  const int64_t row = r0 + threadIdx.x;
  const double* v = s_val + threadIdx.x * Es;
  const int64_t* c = s_col + threadIdx.x * Es;
  int64_t len = 0;
  while (len < E && c[len] < n) ++len;
  for (int64_t j0 = 0; j0 < nrhs; j0 += kRhs) {
    const int64_t nj = nrhs - j0 < kRhs ? nrhs - j0 : kRhs;
    double acc[kRhs];
#pragma unroll
    for (int jj = 0; jj < kRhs; ++jj) acc[jj] = 0.0;
    for (int64_t k = 0; k < len; ++k) {
      const double a = v[k];
      const double* xr = x + c[k] * nrhs + j0;
#pragma unroll
      for (int jj = 0; jj < kRhs; ++jj)
        if (jj < nj) acc[jj] = acc[jj] + a * xr[jj];
    }
    const int64_t o = row * nrhs + j0;
#pragma unroll
    for (int jj = 0; jj < kRhs; ++jj)
      if (jj < nj) y[o + jj] = acc[jj];
  }
}

}  // namespace

// y, x (n, nrhs) float64 row-major; col (n, E) int64 with pads = n after
// each row's entries; val (n, E) float64. Returns the cudaError_t of the
// launch (0 when it was accepted; cudaErrorInvalidValue for rows too wide
// for a block's shared memory, E over about 440).
extern "C" int nk_csr_matvec_f64(void* y, const void* x, const void* col,
                                 const void* val, int64_t n, int64_t E,
                                 int64_t nrhs, void* stream) {
  if (n * nrhs <= 0) return 0;
  const int64_t Es = E | 1;
  int64_t rows = kMaxRows;
  while (rows > kMinRows && rows * Es * 16 > kDefaultSmem) rows /= 2;
  const int64_t smem = rows * Es * 16;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        csr_matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + rows - 1) / rows;
  csr_matvec_kernel<<<static_cast<unsigned>(blocks),
                      static_cast<unsigned>(rows), static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(y), static_cast<const double*>(x),
      static_cast<const int64_t*>(col), static_cast<const double*>(val), n, E,
      Es, nrhs);
  return static_cast<int>(cudaGetLastError());
}
