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
// Design. K1-K3 run the register-resident pass engine (row_passes.cuh)
// with one launch geometry (ops/row_passes.launch_geometry, checked again
// by the C entries): M/16 threads a row, 16 points a thread, two padded
// shared buffers a row (8.25N bytes), several rows a block below 128
// threads. The half-length FFT runs as the plan's stages fused in pairs,
// one exchange and one barrier a pass. K1 reads the row once from device
// memory as N/2 complex points (x[2m] + i x[2m+1]) straight into the
// first pass's registers, and its last exchange's reads do the
// half-complex split and the unordered gather, storing both planes with
// float4 stores. K2/K3 mirror it: the first exchange reads four
// consecutive positions of both planes a thread (float4 where aligned;
// K3 forms scale * A (.) B and the bin-0 patch-up in registers) and
// scatters them to their natural bins in shared memory; the merge rides
// on the first pass's reads (MergeIn), the passes run backward, and the
// last pass stores N * x = 2 z from registers, consecutive threads on
// consecutive samples. The unordered layout is a gather or scatter
// inside shared memory, never in device memory. Each element of a row is
// read from and written to device memory exactly once. Twiddles come
// from float32 tables built in float64 on the host (the passes' tables,
// the plan's split table), read through the read-only cache; no
// sinf/cosf in kernel. Rows are independent, so a ragged batch needs no
// padding. The per-row bodies live in row_fft.cuh, shared with the
// pipelined forms (pipelined_fft.cu).

#include "row_fft.cuh"

#ifndef CHOWDSP_MAX_N
#error "build with -DCHOWDSP_MAX_N=<largest real N> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxN = CHOWDSP_MAX_N;  // 8.25N bytes of shared memory a row
static_assert(two_buffers_bytes(kMaxN / 2) <= kMaxSmemBytes, "MAX_N exceeds shared memory");
// K1-K3's threads a block: M/16 a row, so 512 at MAX_N (the geometry
// puts several small rows in a block only below 128 threads); the launch
// bound leaves the compiler 128 registers a thread.
constexpr int kMaxK1Threads = 512;
static_assert(kMaxN / 2 / kRowPoints <= kMaxK1Threads, "K1-K3 at MAX_N exceed their threads a block");

// K1: x (rows, N) -> packed planes, row r at yre/yim + r * ystride
// (ystride N/2: two planes; N with yim = yre + N/2: the joint [re | im]
// rows of the JAX package's _rfft_packed_joint). A block takes
// rows_per_block consecutive rows, M/16 threads each.
__global__ void __launch_bounds__(kMaxK1Threads)
rfft_packed_kernel(const float* __restrict__ x, float* yre, float* yim, int ystride, int rows, int n,
                   Passes ps, int rows_per_block, const float2* __restrict__ tw,
                   const float2* __restrict__ split_tw, const int* __restrict__ perm) {
  extern __shared__ float2 smem[];
  const int M = n / 2;
  const int tpr = M / kRowPoints;
  const int g = threadIdx.x / tpr;
  const int t = threadIdx.x - g * tpr;
  const int r = blockIdx.x * rows_per_block + g;
  const size_t row = r < rows ? r : rows - 1;
  float2* a = smem + 2 * g * padded(M);
  rfft_row(x + row * n, a, a + padded(M), M, ps, tw, split_tw, perm, yre + row * ystride, yim + row * ystride,
           r < rows, t, tpr, NoHook{});
}

// K2 (CONV = false): packed planes (rows, N/2) -> x (rows, N), unscaled.
// K3 (CONV = true): the same on scale * A (.) B, with the bin-0 patch-up
// re[0] = Ar*Br (DC*DC), im[0] = Ai*Bi (Nyq*Nyq); B has b_rows rows,
// 1 (a shared filter, broadcast) or rows. K1's geometry: a block takes
// rows_per_block consecutive rows, M/16 threads each.
template <bool CONV>
__global__ void __launch_bounds__(kMaxK1Threads)
irfft_packed_kernel(const float* are, const float* aim, const float* __restrict__ bre,
                    const float* __restrict__ bim, int b_rows, float scale, float* x, int rows, int n, Passes ps,
                    int rows_per_block, const float2* __restrict__ tw, const float2* __restrict__ split_tw,
                    const int* __restrict__ perm) {
  extern __shared__ float2 smem[];
  const int M = n / 2;
  const int tpr = M / kRowPoints;
  const int g = threadIdx.x / tpr;
  const int t = threadIdx.x - g * tpr;
  const int r = blockIdx.x * rows_per_block + g;
  const size_t row = r < rows ? r : rows - 1;
  const size_t brow = (CONV && b_rows > 1) ? row : 0;
  float2* a = smem + 2 * g * padded(M);
  irfft_row<CONV>(are + row * M, aim + row * M, CONV ? bre + brow * M : nullptr, CONV ? bim + brow * M : nullptr,
                  scale, perm, a, a + padded(M), M, ps, tw, split_tw, x + row * n, r < rows, t, tpr, NoHook{});
}

// Host: what every grid entry of K1-K3 checks before it launches: N of
// the domain's form, the plan's radices, the pass plan against them,
// and, for rows > 0, the launch geometry (ops/row_passes.launch_geometry)
// against the rows and the kernels' launch bound. Returns a cudaError_t
// value.
int real_row_setup(int n, int rows, const int* radices, int nstages, const int* passes, int npasses,
                   int rows_per_block, int threads, int smem, int grid, Passes* ps) {
  if (n < 4 || n > kMaxN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  err = check_passes(passes, npasses, rad, n / 2, ps);
  if (err || rows == 0) return err;
  err = check_row_geometry(n / 2, rows, rows_per_block, threads, smem, grid);
  if (err) return err;
  return threads > kMaxK1Threads ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// K2/K3's launch, after real_row_setup; the unordered table is read 16
// bytes at a time.
template <bool CONV>
int launch_irfft(const float* are, const float* aim, const float* bre, const float* bim, int b_rows, float scale,
                 float* x, int rows, int n, const Passes& ps, const void* tw, const void* split_tw, const int* perm,
                 int rows_per_block, int threads, int smem, int grid, cudaStream_t stream) {
  if (perm && !aligned16(perm)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem(irfft_packed_kernel<CONV>, smem);
  if (err) return err;
  irfft_packed_kernel<CONV><<<grid, threads, smem, stream>>>(
      are, aim, bre, bim, b_rows, scale, x, rows, n, ps, rows_per_block, static_cast<const float2*>(tw),
      static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hopper_real_fft_max_n() { return kMaxN; }

// Points a thread owns in the row engine (row_passes.cuh) of K1-K4.
int hopper_row_points_per_thread() { return kRowPoints; }

// Blocks resident on one SM at a launch geometry's threads and shared
// bytes, of K1 (which = 1), K2 (2) or K3 (3); 0 if the query fails.
int hopper_real_fft_blocks_per_sm(int which, int threads, int smem) {
  int per_sm = 0;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (threads >= 1 && threads <= kMaxK1Threads) {
    if (which == 1) err = blocks_at(rfft_packed_kernel, threads, smem, &per_sm);
    if (which == 2) err = blocks_at(irfft_packed_kernel<false>, threads, smem, &per_sm);
    if (which == 3) err = blocks_at(irfft_packed_kernel<true>, threads, smem, &per_sm);
  }
  return err ? 0 : per_sm;
}

// K1; ystride is the output row stride in floats (N/2 for two planes, N
// for joint rows); passes: npasses (r0, r1) pairs of the plan's stages
// (ops/row_passes.pass_plan); tw: the passes' twiddle tables
// (ops/row_passes.pass_twiddles); split_tw: the split twiddles in
// position order (the plan's, or gathered to the unordered layout); then the
// launch geometry (ops/row_passes.launch_geometry), checked here. Returns
// a cudaError_t value; 0 means the launch was accepted.
int k1_rfft_packed(const float* x, float* yre, float* yim, int ystride, int rows, int n,
                   const int* radices, int nstages, const int* passes, int npasses, const void* tw,
                   const void* split_tw, const int* perm, int rows_per_block, int threads, int smem,
                   int grid, void* stream) {
  if (ystride < n / 2) return static_cast<int>(cudaErrorInvalidValue);
  Passes ps;
  int err = real_row_setup(n, rows, radices, nstages, passes, npasses, rows_per_block, threads, smem, grid, &ps);
  if (err || rows == 0) return err;
  err = set_smem(rfft_packed_kernel, smem);
  if (err) return err;
  rfft_packed_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, yre, yim, ystride, rows, n, ps, rows_per_block, static_cast<const float2*>(tw),
      static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

// K2: packed planes yre/yim -> x; K1's arguments from the radices on,
// except that split_tw is the plan's split table in bin order.
int k2_irfft_packed(const float* yre, const float* yim, float* x, int rows, int n, const int* radices,
                    int nstages, const int* passes, int npasses, const void* tw, const void* split_tw,
                    const int* perm, int rows_per_block, int threads, int smem, int grid, void* stream) {
  Passes ps;
  const int err =
      real_row_setup(n, rows, radices, nstages, passes, npasses, rows_per_block, threads, smem, grid, &ps);
  if (err || rows == 0) return err;
  return launch_irfft<false>(yre, yim, nullptr, nullptr, 0, 1.0f, x, rows, n, ps, tw, split_tw, perm,
                             rows_per_block, threads, smem, grid, static_cast<cudaStream_t>(stream));
}

// K3: A (rows rows), B (b_rows = 1 or rows), scale -> x; then K2's
// arguments.
int k3_convolve_irfft_packed(const float* are, const float* aim, const float* bre, const float* bim, int b_rows,
                             float scale, float* x, int rows, int n, const int* radices, int nstages,
                             const int* passes, int npasses, const void* tw, const void* split_tw, const int* perm,
                             int rows_per_block, int threads, int smem, int grid, void* stream) {
  if (b_rows != 1 && b_rows != rows) return static_cast<int>(cudaErrorInvalidValue);
  Passes ps;
  const int err =
      real_row_setup(n, rows, radices, nstages, passes, npasses, rows_per_block, threads, smem, grid, &ps);
  if (err || rows == 0) return err;
  return launch_irfft<true>(are, aim, bre, bim, b_rows, scale, x, rows, n, ps, tw, split_tw, perm,
                            rows_per_block, threads, smem, grid, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
