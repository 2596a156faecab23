// Pipelined forms of K1, K2 and K4 for Hopper (sm_90a): persistent blocks
// that load the next row while the current one computes.
//
// Replaces (chowdsp_fft_tpu/ops/pallas_fft.py):
//   K1-db rfft_db_kernel       <- _rfft_db_kernel, called by _rfft_packed_joint_db
//   K2-db irfft_db_kernel      <- _irfft_db_kernel, called by _irfft_packed_db
//   K4-db cfft_db_kernel<SIGN> <- _cfft_db_kernel, called by _cfft_pair_db
//
// What they compute: exactly what K1 (packed real forward, joint
// [re | im] rows or two planes), K2 (unscaled packed real inverse) and K4
// (complex, planes or interleaved) compute, bit for bit: the per-row
// bodies are row_fft.cuh's, run on the same tables. Each serves its grid
// kernel's whole domain (real 256 < N <= MAX_N, complex 256 < N <= MAX_CN).
//
// What bounds them on the card: bytes, as their grid forms. K1 and K2
// read 4N B and write 4N B per row, K4 8N B each way; the O(N log N)
// arithmetic is far below the H100's flop/byte balance.
//
// Design. The JAX forms keep the batch in HBM and drive a two-slot DMA
// pipeline, so that chunk i+1 streams in while chunk i computes. Here:
//   * persistent blocks: grid = min(rows, SMs x resident blocks per SM at
//     the kernel's shared memory); block g walks rows g, g+G, g+2G, ...;
//   * the load of row r+G is issued before row r's stages: 16-byte
//     cp.async.cg copies into an unpadded landing buffer (4N B for K1 and
//     K2, 8N B for K4), waited for (cp.async.wait_group 0, then a barrier)
//     only when row r+G starts. The row body's first pass (K1's load, K2's
//     permuted scatter, K4's scatter) reads the landing buffer into the
//     padded work buffers: a 16-byte copy cannot land in the padded layout
//     (slot(i) = i + i/32 misaligns every odd group of 32 float2);
//   * outputs are plain coalesced stores, as in the grid forms;
//   * K4 above 9216 points: two padded buffers and a landing buffer
//     (24.5N B) exceed the 227 KB a block may use, so the next row is
//     prefetched into registers instead: ordinary loads issued before the
//     stages, at most ceil(MAX_CN / 1024) = 14 float2 per thread, written
//     to shared memory after them.
// Shared memory per block: 12.25N B for K1 and K2 (200 KB at MAX_N =
// 16384), 24.5N B for K4 up to 9216 points, 16.5N B above.

#include "row_fft.cuh"

#ifndef CHOWDSP_MAX_N
#error "build with -DCHOWDSP_MAX_N=<largest real N> (ops/_cuda.py passes it)"
#endif
#ifndef CHOWDSP_MAX_CN
#error "build with -DCHOWDSP_MAX_CN=<largest complex N> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxN = CHOWDSP_MAX_N;
constexpr int kMaxCN = CHOWDSP_MAX_CN;

// K1-db, K2-db: two padded N/2-point buffers and an N-float landing buffer.
constexpr int real_db_smem(int n) { return two_buffers_bytes(n / 2) + 4 * n; }
// K4-db lands rows in shared memory where the 8N B landing buffer fits
// beside the two padded buffers, else prefetches them into registers.
constexpr bool cfft_lands(int n) { return two_buffers_bytes(n) + 8 * n <= kMaxSmemBytes; }
constexpr int cfft_db_smem(int n) { return two_buffers_bytes(n) + (cfft_lands(n) ? 8 * n : 0); }
// float2 per thread of a register-prefetched row (1024 threads above 4096 points).
constexpr int kPrefetch = (kMaxCN + kMaxThreads - 1) / kMaxThreads;
static_assert(real_db_smem(kMaxN) <= kMaxSmemBytes, "K1-db/K2-db at MAX_N exceed shared memory");
static_assert(two_buffers_bytes(kMaxCN) <= kMaxSmemBytes, "K4-db at MAX_CN exceeds shared memory");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Issue the copy of `bytes` (a multiple of 16; both ends 16-byte aligned)
// from device memory into shared memory, 16 B per thread per step.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (int i = threadIdx.x; i < (bytes >> 4); i += blockDim.x) cp_async16(d + 16 * i, s + 16 * i);
}

// K1-db: x (rows, N) -> packed planes at yre/yim + r * ystride (joint
// [re | im] rows: ystride N, yim = yre + N/2).
__global__ void __launch_bounds__(kMaxThreads)
rfft_db_kernel(const float* __restrict__ x, float* yre, float* yim, int ystride, int rows, int n,
               Radices rad, const float2* __restrict__ stage_tw,
               const float2* __restrict__ split_tw, const int* __restrict__ perm) {
  extern __shared__ __align__(16) float2 smem[];
  const int M = n / 2;
  float2* land = smem;
  float2* a = smem + M;
  float2* b = a + padded(M);
  const int G = gridDim.x;
  int row = blockIdx.x;
  copy_async(land, x + static_cast<size_t>(row) * n, 4 * n);
  cp_async_commit();
  for (; row < rows; row += G) {
    cp_async_wait_all();
    __syncthreads();  // the row has landed; the previous row's stores are done with a and b
    rfft_row_load(land, a, M);
    if (row + G < rows) copy_async(land, x + static_cast<size_t>(row + G) * n, 4 * n);
    cp_async_commit();
    const size_t out = static_cast<size_t>(row) * ystride;
    rfft_row_finish(a, b, M, rad, stage_tw, split_tw, perm, yre + out, yim + out);
  }
}

// K2-db: packed planes (rows, N/2) x2 -> x (rows, N), unscaled. The
// landing buffer holds the row's re plane, then its im plane.
__device__ __forceinline__ void fetch_planes(float* land, const float* yre, const float* yim,
                                             int row, int M) {
  copy_async(land, yre + static_cast<size_t>(row) * M, 4 * M);
  copy_async(land + M, yim + static_cast<size_t>(row) * M, 4 * M);
}

__global__ void __launch_bounds__(kMaxThreads)
irfft_db_kernel(const float* __restrict__ yre, const float* __restrict__ yim,
                float* __restrict__ x, int rows, int n, Radices rad,
                const float2* __restrict__ stage_tw, const float2* __restrict__ split_tw,
                const int* __restrict__ perm) {
  extern __shared__ __align__(16) float2 smem[];
  __shared__ float nyq;
  const int M = n / 2;
  float* land = reinterpret_cast<float*>(smem);
  float2* a = smem + M;
  float2* b = a + padded(M);
  const int G = gridDim.x;
  int row = blockIdx.x;
  fetch_planes(land, yre, yim, row, M);
  cp_async_commit();
  for (; row < rows; row += G) {
    cp_async_wait_all();
    __syncthreads();
    irfft_row_load<false>(land, land + M, nullptr, nullptr, 1.0f, perm, a, &nyq, M);
    if (row + G < rows) fetch_planes(land, yre, yim, row + G, M);
    cp_async_commit();
    irfft_row_finish(a, b, M, &nyq, rad, stage_tw, split_tw, x + static_cast<size_t>(row) * n);
  }
}

// K4-db. SIGN = -1 forward, +1 backward; LAND: cp.async into the landing
// buffer (interleaved rows as they are in device memory; planes as the
// re row, then the im row), else register prefetch.
template <int SIGN, bool LAND>
__global__ void __launch_bounds__(kMaxThreads)
cfft_db_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
               float* __restrict__ yre, float* __restrict__ yim, int stride, int rows, int n,
               Radices rad, const float2* __restrict__ stage_tw, const int* __restrict__ perm) {
  extern __shared__ __align__(16) float2 smem[];
  float* land = reinterpret_cast<float*>(smem);
  float2* a = LAND ? smem + n : smem;
  float2* b = a + padded(n);
  const float* lre = land;
  const float* lim = land + (stride == 2 ? 1 : n);
  const int G = gridDim.x;
  float2 reg[kPrefetch];

  auto fetch = [&](int r) {
    const size_t base = static_cast<size_t>(r) * n * stride;
    if (LAND) {
      if (stride == 2) {
        copy_async(land, xre + base, 8 * n);
      } else {
        copy_async(land, xre + base, 4 * n);
        copy_async(land + n, xim + base, 4 * n);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int i = threadIdx.x + j * blockDim.x;
        if (i < n) {
          const size_t at = base + static_cast<size_t>(i) * stride;
          reg[j] = make_float2(xre[at], xim[at]);
        }
      }
    }
  };

  int row = blockIdx.x;
  fetch(row);
  if (LAND) cp_async_commit();
  for (; row < rows; row += G) {
    if (LAND) cp_async_wait_all();
    __syncthreads();
    if (LAND) {
      cfft_row_load<SIGN>(lre, lim, stride, perm, a, n);
    } else {
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int i = threadIdx.x + j * blockDim.x;
        if (i < n) cfft_put<SIGN>(a, perm, i, reg[j]);
      }
      __syncthreads();
    }
    if (row + G < rows) fetch(row + G);
    if (LAND) cp_async_commit();
    const size_t base = static_cast<size_t>(row) * n * stride;
    cfft_row_finish<SIGN>(a, b, n, rad, stage_tw, perm, yre + base, yim + base, stride);
  }
}

// Blocks of `kernel` resident on one SM at `threads` and `smem` bytes.
template <typename K>
int resident_blocks(K kernel, int threads, int smem, int* per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem));
}

// The persistent grid: min(rows, SMs x resident blocks per SM).
template <typename K>
int persistent_grid(K kernel, int threads, int smem, int rows, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return err;
  err = resident_blocks(kernel, threads, smem, &per_sm);
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long cap = static_cast<long long>(sms) * per_sm;
  *grid = rows < cap ? rows : static_cast<int>(cap);
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int real_setup(int n, const int* radices, int nstages, Radices* rad) {
  // Rows of N floats and of N/2 floats are whole 16-byte copies.
  if (n < 16 || n > kMaxN || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  return make_radices(radices, nstages, rad);
}

template <int SIGN, bool LAND>
int launch_cfft_db(const float* xre, const float* xim, float* yre, float* yim, int stride,
                   int rows, int n, const Radices& rad, const float2* tw, const int* perm,
                   cudaStream_t stream) {
  auto kernel = cfft_db_kernel<SIGN, LAND>;
  int err = set_smem(kernel, LAND ? kMaxSmemBytes : two_buffers_bytes(kMaxCN));
  if (err) return err;
  const int threads = threads_for(n);
  if (!LAND && threads * kPrefetch < n) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  err = persistent_grid(kernel, threads, cfft_db_smem(n), rows, &grid);
  if (err) return err;
  kernel<<<grid, threads, cfft_db_smem(n), stream>>>(xre, xim, yre, yim, stride, rows, n, rad, tw, perm);
  return static_cast<int>(cudaGetLastError());
}

template <int SIGN>
int cfft_db(const float* xre, const float* xim, float* yre, float* yim, int stride, int rows,
            int n, const Radices& rad, const float2* tw, const int* perm, cudaStream_t stream) {
  return cfft_lands(n)
             ? launch_cfft_db<SIGN, true>(xre, xim, yre, yim, stride, rows, n, rad, tw, perm, stream)
             : launch_cfft_db<SIGN, false>(xre, xim, yre, yim, stride, rows, n, rad, tw, perm, stream);
}

}  // namespace

extern "C" {

// Blocks of a pipelined kernel resident on one SM at size n (which: 1
// K1-db, 2 K2-db, 4 K4-db forward); 0 if the query fails.
int hopper_pipelined_blocks_per_sm(int which, int n) {
  int per_sm = 0;
  int err = 0;
  if (which == 1 || which == 2) {
    if (n < 16 || n > kMaxN) return 0;
    const int threads = threads_for(n / 2);
    err = which == 1 ? set_smem(rfft_db_kernel, real_db_smem(kMaxN))
                     : set_smem(irfft_db_kernel, real_db_smem(kMaxN));
    if (!err)
      err = which == 1 ? resident_blocks(rfft_db_kernel, threads, real_db_smem(n), &per_sm)
                       : resident_blocks(irfft_db_kernel, threads, real_db_smem(n), &per_sm);
  } else if (which == 4) {
    if (n < 16 || n > kMaxCN) return 0;
    const int threads = threads_for(n);
    if (cfft_lands(n)) {
      err = set_smem(cfft_db_kernel<-1, true>, kMaxSmemBytes);
      if (!err) err = resident_blocks(cfft_db_kernel<-1, true>, threads, cfft_db_smem(n), &per_sm);
    } else {
      err = set_smem(cfft_db_kernel<-1, false>, two_buffers_bytes(kMaxCN));
      if (!err) err = resident_blocks(cfft_db_kernel<-1, false>, threads, cfft_db_smem(n), &per_sm);
    }
  }
  return err ? 0 : per_sm;
}

// K1-db; ystride as k1_rfft_packed's. x and the output rows must be
// 16-byte aligned. Returns a cudaError_t value; 0 means the launch was
// accepted.
int k1db_rfft_packed(const float* x, float* yre, float* yim, int ystride, int rows, int n,
                     const int* radices, int nstages, const void* stage_tw,
                     const void* split_tw, const int* perm, void* stream) {
  Radices rad;
  int err = real_setup(n, radices, nstages, &rad);
  if (err) return err;
  if (ystride < n / 2 || !aligned16(x)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  err = set_smem(rfft_db_kernel, real_db_smem(kMaxN));
  if (err) return err;
  const int threads = threads_for(n / 2);
  int grid = 0;
  err = persistent_grid(rfft_db_kernel, threads, real_db_smem(n), rows, &grid);
  if (err) return err;
  rfft_db_kernel<<<grid, threads, real_db_smem(n), static_cast<cudaStream_t>(stream)>>>(
      x, yre, yim, ystride, rows, n, rad, static_cast<const float2*>(stage_tw),
      static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

// K2-db. yre and yim must be 16-byte aligned.
int k2db_irfft_packed(const float* yre, const float* yim, float* x, int rows, int n,
                      const int* radices, int nstages, const void* stage_tw,
                      const void* split_tw, const int* perm, void* stream) {
  Radices rad;
  int err = real_setup(n, radices, nstages, &rad);
  if (err) return err;
  if (!aligned16(yre) || !aligned16(yim)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  err = set_smem(irfft_db_kernel, real_db_smem(kMaxN));
  if (err) return err;
  const int threads = threads_for(n / 2);
  int grid = 0;
  err = persistent_grid(irfft_db_kernel, threads, real_db_smem(n), rows, &grid);
  if (err) return err;
  irfft_db_kernel<<<grid, threads, real_db_smem(n), static_cast<cudaStream_t>(stream)>>>(
      yre, yim, x, rows, n, rad, static_cast<const float2*>(stage_tw),
      static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

// K4-db, with k4_cfft's arguments. The input rows must be 16-byte aligned
// (xre; and xim for planes).
int k4db_cfft(const float* xre, const float* xim, float* yre, float* yim, int stride, int rows,
              int n, int sign, const int* radices, int nstages, const void* stage_tw,
              const int* perm, void* stream) {
  if (n < 16 || n > kMaxCN || n % 4 || (stride != 1 && stride != 2) || (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(xre) || (stride == 1 && !aligned16(xim))) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  const int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  if (rows == 0) return 0;
  const float2* tw = static_cast<const float2*>(stage_tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sign < 0 ? cfft_db<-1>(xre, xim, yre, yim, stride, rows, n, rad, tw, perm, s)
                  : cfft_db<1>(xre, xim, yre, yim, stride, rows, n, rad, tw, perm, s);
}

}  // extern "C"
