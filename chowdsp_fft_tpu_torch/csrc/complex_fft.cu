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
// Design: the register-resident pass engine (row_passes.cuh), shared with
// K1. Each row of N points is read once from device memory (complex64 as
// float2, planes as floats) straight into the first pass's registers,
// the plan's stages run fused in pairs with two padded shared buffers
// per row (16.5N bytes) between passes, and the last exchange's reads store
// the row (complex64 as float4 pairs). The unordered order is an index
// into shared memory, never a device-memory pass: the backward scatter is
// the first exchange, the forward gather the last, so the TPU's
// ordered-in-kernel gate has no counterpart here. Small rows share a
// block; the launch geometry comes from ops/row_passes.launch_geometry
// and is checked here. MAX_CN = 13824 (n1 = 108) is the largest smooth
// n1 * 128 whose two buffers fit the 227 KB a block may use (16384 would
// need 270 KB); the composite (K6) runs above it. The per-row body lives in
// row_fft.cuh, shared with the pipelined form (pipelined_fft.cu).

#include "row_fft.cuh"

#ifndef CHOWDSP_MAX_CN
#error "build with -DCHOWDSP_MAX_CN=<largest complex N> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxCN = CHOWDSP_MAX_CN;
static_assert(row_smem_bytes(kMaxCN, 1) <= kMaxSmemBytes, "MAX_CN exceeds shared memory");
static_assert(kMaxCN / kRowPoints <= kMaxThreads, "MAX_CN exceeds the threads of a block");

// The launch bound of blocks up to 768 threads (N <= 12288): ptxas then
// gives a thread 80 registers, which let K4 at N=4096 keep 3 blocks (of
// 256 threads) on an SM where 128 registers allowed 2; it measured a few
// percent faster at N=4096 and 1024 on the H100 (development runs). Larger
// blocks take the 1024-thread bound (64 registers).
constexpr int kSmallBound = 768;

// K4. SIGN = -1 forward, +1 backward; a block takes rows_per_block
// consecutive rows, N/16 threads each. MAXT is the launch bound:
// kSmallBound or 1024.
template <int SIGN, int MAXT>
__global__ void __launch_bounds__(MAXT)
cfft_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
            float* __restrict__ yre, float* __restrict__ yim, int stride, int rows, int n,
            Passes ps, int rows_per_block, const float2* __restrict__ tw,
            const int* __restrict__ perm) {
  extern __shared__ float2 smem[];
  const int tpr = n / kRowPoints;
  const int g = threadIdx.x / tpr;
  const int t = threadIdx.x - g * tpr;
  const int r = blockIdx.x * rows_per_block + g;
  const size_t base = static_cast<size_t>(r < rows ? r : rows - 1) * n * stride;
  float2* a = smem + 2 * g * padded(n);
  cfft_row<SIGN>(xre + base, xim + base, stride, perm, a, a + padded(n), n, ps, tw, yre + base, yim + base,
                 r < rows, t, tpr, NoHook{});
}

template <int SIGN, int MAXT>
int launch_bounded(const float* xre, const float* xim, float* yre, float* yim, int stride, int rows, int n,
           const Passes& ps, int rows_per_block, int threads, int smem, int grid, const float2* tw,
           const int* perm, cudaStream_t stream) {
  const int err = set_smem(cfft_kernel<SIGN, MAXT>, smem);
  if (err) return err;
  cfft_kernel<SIGN, MAXT><<<grid, threads, smem, stream>>>(xre, xim, yre, yim, stride, rows, n, ps,
                                                          rows_per_block, tw, perm);
  return static_cast<int>(cudaGetLastError());
}

template <int SIGN>
int launch(const float* xre, const float* xim, float* yre, float* yim, int stride, int rows, int n,
           const Passes& ps, int rows_per_block, int threads, int smem, int grid, const float2* tw,
           const int* perm, cudaStream_t stream) {
  if (threads <= kSmallBound)
    return launch_bounded<SIGN, kSmallBound>(xre, xim, yre, yim, stride, rows, n, ps, rows_per_block, threads,
                                             smem, grid, tw, perm, stream);
  return launch_bounded<SIGN, 1024>(xre, xim, yre, yim, stride, rows, n, ps, rows_per_block, threads, smem, grid,
                                    tw, perm, stream);
}

}  // namespace

extern "C" {

int hopper_complex_fft_max_n() { return kMaxCN; }

// K4 (forward) blocks resident on one SM at a launch geometry's threads
// and shared bytes; 0 if the query fails.
int hopper_complex_fft_blocks_per_sm(int threads, int smem) {
  int per_sm = 0;
  if (threads < 1 || threads > kMaxThreads) return 0;
  if (threads <= kSmallBound) {
    if (set_smem(cfft_kernel<-1, kSmallBound>, smem) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cfft_kernel<-1, kSmallBound>, threads, smem))
      return 0;
  } else if (set_smem(cfft_kernel<-1, 1024>, smem) ||
             cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cfft_kernel<-1, 1024>, threads, smem)) {
    return 0;
  }
  return per_sm;
}

// K4. sign = -1 forward, +1 backward; stride 1 (planes) or 2 (complex64);
// passes: npasses (r0, r1) pairs of the plan's stages; tw: the N-point
// passes' twiddle tables (ops/row_passes.pass_twiddles); perm NULL for
// ordered bins; then the launch geometry
// (ops/row_passes.launch_geometry), checked here. Returns a cudaError_t
// value; 0 means the launch was accepted.
int k4_cfft(const float* xre, const float* xim, float* yre, float* yim, int stride, int rows, int n, int sign,
            const int* radices, int nstages, const int* passes, int npasses, const void* tw,
            const int* perm, int rows_per_block, int threads, int smem, int grid, void* stream) {
  if (n < 2 || n > kMaxCN || (stride != 1 && stride != 2) || (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  Passes ps;
  err = check_passes(passes, npasses, rad, n, &ps);
  if (err) return err;
  if (rows == 0) return 0;
  err = check_row_geometry(n, rows, rows_per_block, threads, smem, grid);
  if (err) return err;
  const float2* twp = static_cast<const float2*>(tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sign < 0 ? launch<-1>(xre, xim, yre, yim, stride, rows, n, ps, rows_per_block, threads, smem, grid, twp,
                               perm, s)
                  : launch<1>(xre, xim, yre, yim, stride, rows, n, ps, rows_per_block, threads, smem, grid, twp,
                              perm, s);
}

}  // extern "C"
