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

#include "stockham.cuh"

#ifndef CHOWDSP_MAX_N
#error "build with -DCHOWDSP_MAX_N=<largest real N> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxN = CHOWDSP_MAX_N;  // 8.25N bytes of shared memory per block
static_assert(two_buffers_bytes(kMaxN / 2) <= kMaxSmemBytes, "MAX_N exceeds shared memory");

// K1: x (rows, N) -> packed planes (rows, N/2).
__global__ void __launch_bounds__(kMaxThreads)
rfft_packed_kernel(const float* __restrict__ x, float* __restrict__ yre,
                   float* __restrict__ yim, int n, Radices rad,
                   const float2* __restrict__ stage_tw,
                   const float2* __restrict__ split_tw,
                   const int* __restrict__ perm) {
  extern __shared__ float2 smem[];
  const int M = n / 2;
  const size_t row = blockIdx.x;
  float2* a = smem;
  float2* b = smem + padded(M);

  const float2* xr = reinterpret_cast<const float2*>(x + row * n);
  for (int i = threadIdx.x; i < M; i += blockDim.x) a[slot(i)] = xr[i];
  __syncthreads();
  const float2* Z = run_stages<-1>(a, b, M, rad, stage_tw);

  // Split (stockham.cuh split_bin); the Nyquist bin goes to im[0].
  float* ore = yre + row * M;
  float* oim = yim + row * M;
  for (int pos = threadIdx.x; pos < M; pos += blockDim.x) {
    const int k = perm ? __ldg(perm + pos) : pos;
    float re, im;
    if (k == 0) {
      const float2 z0 = Z[slot(0)];
      re = z0.x + z0.y;
      im = z0.x - z0.y;
    } else {
      const float2 X = split_bin(Z[slot(k)], Z[slot(M - k)], __ldg(split_tw + k));
      re = X.x;
      im = X.y;
    }
    ore[pos] = re;
    oim[pos] = im;
  }
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

  const float* pre = are + row * M;
  const float* pim = aim + row * M;
  const size_t brow = (CONV && b_rows > 1) ? row : 0;
  for (int pos = threadIdx.x; pos < M; pos += blockDim.x) {
    float re = pre[pos], im = pim[pos];
    if (CONV) {
      const float br = bre[brow * M + pos], bi = bim[brow * M + pos];
      if (pos == 0) {
        re = re * br;
        im = im * bi;
      } else {
        const float pr = re * br - im * bi;
        im = re * bi + im * br;
        re = pr;
      }
      re *= scale;
      im *= scale;
    }
    if (pos == 0) {  // position 0 is bin 0 in every layout
      nyq = im;
      im = 0.0f;
    }
    a[slot(perm ? __ldg(perm + pos) : pos)] = make_float2(re, im);
  }
  __syncthreads();

  // Merge (stockham.cuh merge_bin), with X[M] the Nyquist bin.
  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    const float2 xr = k == 0 ? make_float2(nyq, 0.0f) : cconj(a[slot(M - k)]);
    b[slot(k)] = merge_bin(a[slot(k)], xr, __ldg(split_tw + k));
  }
  __syncthreads();
  const float2* zt = run_stages<1>(b, a, M, rad, stage_tw);

  // zt == M * (x_even + i x_odd); N * x = 2 * M * x.
  float2* out = reinterpret_cast<float2*>(x + row * n);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const float2 z = zt[slot(i)];
    out[i] = make_float2(2.0f * z.x, 2.0f * z.y);
  }
}

constexpr int smem_bytes(int n) { return two_buffers_bytes(n / 2); }

}  // namespace

extern "C" {

int hopper_real_fft_max_n() { return kMaxN; }

// K1. Returns a cudaError_t value; 0 means the launch was accepted.
int k1_rfft_packed(const float* x, float* yre, float* yim, int rows, int n,
                   const int* radices, int nstages, const void* stage_tw,
                   const void* split_tw, const int* perm, void* stream) {
  if (n < 4 || n > kMaxN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  if (rows == 0) return 0;
  err = set_smem(rfft_packed_kernel, smem_bytes(kMaxN));
  if (err) return err;
  const int M = n / 2;
  rfft_packed_kernel<<<rows, threads_for(M), smem_bytes(n),
                       static_cast<cudaStream_t>(stream)>>>(
      x, yre, yim, n, rad, static_cast<const float2*>(stage_tw),
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
