// Complex FFT kernel for Hopper (sm_90a), forward and backward, ordered or
// in the unordered layout.
//
// Replaces (chowdsp_fft_tpu/ops/pallas_fft.py):
//   K4 cfft_kernel <- _fft_kernel / _cfft_tile / _stockham_rows, called by
//                     _pallas_cfft_pair (dispatch _cfft_pair_impl)
//
// What it computes (the JAX package's contract, not its TPU tiling):
//   * the unscaled complex DFT of each row, exp(-2i*pi*jk/N) forward and
//     exp(+2i*pi*jk/N) backward, N = n1 * 128 with n1 {2,3,5}-smooth;
//   * rows read and written either as two float32 planes (element stride
//     1) or as interleaved complex64 (element stride 2, re and im pointers
//     one float apart);
//   * ordered bins, or the unordered layout given by a permutation table
//     (position p holds bin perm[p]; ops/tables.py cfft_unordered_perm):
//     forward gathers it on store, backward scatters it on load.
//
// What bounds it on the card: bytes. Each row reads 8N B and writes 8N B;
// the arithmetic is O(N log N) flops per row, far below the H100's
// flop/byte balance.
//
// Design: PR 1's real kernels, without the half-complex split. One thread
// block per row holds the N complex points in two padded shared buffers
// (16.5N bytes) and runs the complex plan's own Stockham stages
// (stockham.cuh) between them. Each element is read from and written to
// device memory once, neighbouring threads on neighbouring addresses; the
// unordered order is an index into shared memory, never a device-memory
// pass, so the TPU's ordered-in-kernel gate has no counterpart here.
// MAX_CN = 13824 (n1 = 108) is the largest smooth n1 * 128 whose two
// buffers fit the 227 KB a block may use (16384 would need 270 KB).
// The per-row body lives in row_fft.cuh, shared with the pipelined form
// (pipelined_fft.cu).

#include "row_fft.cuh"

#ifndef CHOWDSP_MAX_CN
#error "build with -DCHOWDSP_MAX_CN=<largest complex N> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxCN = CHOWDSP_MAX_CN;
static_assert(two_buffers_bytes(kMaxCN) <= kMaxSmemBytes, "MAX_CN exceeds shared memory");

// K4. SIGN = -1 forward, +1 backward.
template <int SIGN>
__global__ void __launch_bounds__(kMaxThreads)
cfft_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
            float* __restrict__ yre, float* __restrict__ yim, int stride, int n,
            Radices rad, const float2* __restrict__ stage_tw,
            const int* __restrict__ perm) {
  extern __shared__ float2 smem[];
  const size_t base = static_cast<size_t>(blockIdx.x) * n * stride;
  float2* a = smem;
  float2* b = smem + padded(n);
  cfft_row_load<SIGN>(xre + base, xim + base, stride, perm, a, n);
  cfft_row_finish<SIGN>(a, b, n, rad, stage_tw, perm, yre + base, yim + base, stride);
}

template <int SIGN>
int launch(const float* xre, const float* xim, float* yre, float* yim, int stride,
           int rows, int n, const Radices& rad, const float2* tw, const int* perm,
           cudaStream_t stream) {
  const int err = set_smem(cfft_kernel<SIGN>, two_buffers_bytes(kMaxCN));
  if (err) return err;
  cfft_kernel<SIGN><<<rows, threads_for(n), two_buffers_bytes(n), stream>>>(
      xre, xim, yre, yim, stride, n, rad, tw, perm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hopper_complex_fft_max_n() { return kMaxCN; }

// K4. sign = -1 forward, +1 backward; stride 1 (planes) or 2 (complex64);
// perm NULL for ordered bins. Returns a cudaError_t value; 0 means the
// launch was accepted.
int k4_cfft(const float* xre, const float* xim, float* yre, float* yim, int stride,
            int rows, int n, int sign, const int* radices, int nstages,
            const void* stage_tw, const int* perm, void* stream) {
  if (n < 2 || n > kMaxCN || (stride != 1 && stride != 2) || (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  const int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  if (rows == 0) return 0;
  const float2* tw = static_cast<const float2*>(stage_tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sign < 0 ? launch<-1>(xre, xim, yre, yim, stride, rows, n, rad, tw, perm, s)
                  : launch<1>(xre, xim, yre, yim, stride, rows, n, rad, tw, perm, s);
}

}  // extern "C"
