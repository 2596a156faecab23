// Packed real FFT kernels for Hopper (sm_90a): forward, inverse, and the
// fused spectral product + inverse.
//
// Replaces (chowdsp_fft_tpu/ops/pallas_fft.py):
//   K1 rfft_packed_kernel        <- _rfft_kernel / _rfft_tile, called by
//                                   _pallas_rfft_packed_impl
//   K2 irfft_packed_kernel       <- _irfft_kernel / _irfft_core, called by
//                                   _pallas_irfft_packed_impl
//   K3 irfft_packed_kernel<true> <- _irfft_conv_kernel / _packed_product,
//                                   called by _pallas_irfft_conv_impl
//
// What they compute (the JAX package's contracts, not its TPU tiling):
//   * unscaled transforms, irfft(rfft(x)) == N * x;
//   * packed planes (rows, N/2) float32 re/im, DC in re[0], Nyquist in im[0];
//   * ordered bins, or the unordered layout given by a permutation table
//     (position p holds bin perm[p]; ops/tables.py unordered_perm).
//
// What bounds them on the card: bytes. K1 reads 4N B and writes 4N B per
// row, K2 the same, K3 reads 4N B of A (plus B, once per row or shared and
// L2-resident) and writes 4N B. The arithmetic is O(N log N) flops per row,
// far below the H100's flop/byte balance.
//
// Design: one thread block per row. The row is staged in shared memory as
// N/2 complex points (x[2m] + i x[2m+1]); the half-length complex FFT runs
// there as the plan's mixed-radix {4,2,3,5} Stockham stages (stockham.cuh,
// shared with the complex kernel), ping-ponging
// between two padded shared buffers (8.25N bytes per block, so N <= 16384
// fits in 132 KB), then the half-complex split/merge gives the real
// spectrum. Each
// element of the row is read from and written to device memory exactly
// once, with neighbouring threads on neighbouring addresses; unordered
// positions are a gather/scatter inside shared memory, never in device
// memory. Twiddles come from the plan's float32 tables (built in float64
// on the host), read through the read-only cache; no sinf/cosf in kernel.
// Rows are independent, so a ragged batch needs no padding or masking.
// The per-row bodies live in row_fft.cuh, shared with the pipelined forms
// (pipelined_fft.cu).

#include "row_fft.cuh"

#ifndef CHOWDSP_MAX_N
#error "build with -DCHOWDSP_MAX_N=<largest real N> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxN = CHOWDSP_MAX_N;  // 8.25N bytes of shared memory per block
static_assert(two_buffers_bytes(kMaxN / 2) <= kMaxSmemBytes, "MAX_N exceeds shared memory");

// K1: x (rows, N) -> packed planes, row r at yre/yim + r * ystride
// (ystride N/2: two planes; N with yim = yre + N/2: the joint [re | im]
// rows of the JAX package's _rfft_packed_joint).
__global__ void __launch_bounds__(kMaxThreads)
rfft_packed_kernel(const float* __restrict__ x, float* yre, float* yim, int ystride, int n,
                   Radices rad, const float2* __restrict__ stage_tw,
                   const float2* __restrict__ split_tw, const int* __restrict__ perm) {
  extern __shared__ float2 smem[];
  const int M = n / 2;
  const size_t row = blockIdx.x;
  float2* a = smem;
  float2* b = smem + padded(M);
  rfft_row_load(reinterpret_cast<const float2*>(x + row * n), a, M);
  rfft_row_finish(a, b, M, rad, stage_tw, split_tw, perm, yre + row * ystride, yim + row * ystride);
}

// K2 (CONV = false): packed planes (rows, N/2) -> x (rows, N), unscaled.
// K3 (CONV = true): the same on scale * A (.) B, with the bin-0 patch-up
// re[0] = Ar*Br (DC*DC), im[0] = Ai*Bi (Nyq*Nyq); B has b_rows rows,
// 1 (a shared filter, broadcast) or rows.
template <bool CONV>
__global__ void __launch_bounds__(kMaxThreads)
irfft_packed_kernel(const float* __restrict__ are, const float* __restrict__ aim,
                    const float* __restrict__ bre, const float* __restrict__ bim,
                    int b_rows, float scale, float* __restrict__ x, int n,
                    Radices rad, const float2* __restrict__ stage_tw,
                    const float2* __restrict__ split_tw,
                    const int* __restrict__ perm) {
  extern __shared__ float2 smem[];
  __shared__ float nyq;
  const int M = n / 2;
  const size_t row = blockIdx.x;
  float2* a = smem;
  float2* b = smem + padded(M);
  const size_t brow = (CONV && b_rows > 1) ? row : 0;
  irfft_row_load<CONV>(are + row * M, aim + row * M, CONV ? bre + brow * M : nullptr,
                       CONV ? bim + brow * M : nullptr, scale, perm, a, &nyq, M);
  irfft_row_finish(a, b, M, &nyq, rad, stage_tw, split_tw, x + row * n);
}

constexpr int smem_bytes(int n) { return two_buffers_bytes(n / 2); }

}  // namespace

extern "C" {

int hopper_real_fft_max_n() { return kMaxN; }

// K1; ystride is the output row stride in floats (N/2 for two planes, N
// for joint rows). Returns a cudaError_t value; 0 means the launch was
// accepted.
int k1_rfft_packed(const float* x, float* yre, float* yim, int ystride, int rows, int n,
                   const int* radices, int nstages, const void* stage_tw,
                   const void* split_tw, const int* perm, void* stream) {
  if (n < 4 || n > kMaxN || n % 2 || ystride < n / 2) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  if (rows == 0) return 0;
  err = set_smem(rfft_packed_kernel, smem_bytes(kMaxN));
  if (err) return err;
  const int M = n / 2;
  rfft_packed_kernel<<<rows, threads_for(M), smem_bytes(n),
                       static_cast<cudaStream_t>(stream)>>>(
      x, yre, yim, ystride, n, rad, static_cast<const float2*>(stage_tw),
      static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

// K2.
int k2_irfft_packed(const float* yre, const float* yim, float* x, int rows, int n,
                    const int* radices, int nstages, const void* stage_tw,
                    const void* split_tw, const int* perm, void* stream) {
  if (n < 4 || n > kMaxN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  if (rows == 0) return 0;
  err = set_smem(irfft_packed_kernel<false>, smem_bytes(kMaxN));
  if (err) return err;
  const int M = n / 2;
  irfft_packed_kernel<false><<<rows, threads_for(M), smem_bytes(n),
                               static_cast<cudaStream_t>(stream)>>>(
      yre, yim, nullptr, nullptr, 0, 1.0f, x, n, rad,
      static_cast<const float2*>(stage_tw), static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

// K3.
int k3_convolve_irfft_packed(const float* are, const float* aim, const float* bre,
                             const float* bim, int b_rows, float scale, float* x,
                             int rows, int n, const int* radices, int nstages,
                             const void* stage_tw, const void* split_tw,
                             const int* perm, void* stream) {
  if (n < 4 || n > kMaxN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (b_rows != 1 && b_rows != rows) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  if (rows == 0) return 0;
  err = set_smem(irfft_packed_kernel<true>, smem_bytes(kMaxN));
  if (err) return err;
  const int M = n / 2;
  irfft_packed_kernel<true><<<rows, threads_for(M), smem_bytes(n),
                              static_cast<cudaStream_t>(stream)>>>(
      are, aim, bre, bim, b_rows, scale, x, n, rad,
      static_cast<const float2*>(stage_tw), static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
