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
//   * the load of row r+G is issued while row r computes: 16-byte
//     cp.async.cg copies into an unpadded landing buffer (4N B for K1 and
//     K2, 8N B for K4), waited for (cp.async.wait_group 0, then a barrier)
//     only when row r+G starts. All three run the row engine
//     (row_passes.cuh) and issue it as soon as the landing buffer has been
//     read: K1 and K4 after their first pass has read it into registers
//     (K4's backward unordered rows after their scatter into the work
//     buffer), K2 after its first exchange has scattered the planes into
//     the padded work buffer (a 16-byte copy cannot land in the padded
//     layout: slot(i) = i + i/32 misaligns every odd group of 32 float2);
//   * outputs are the grid forms' stores.
//   * K4 above 9216 points: two padded buffers and a landing buffer
//     (24.5N B) exceed the 227 KB a block may use, so the next row is
//     prefetched into registers instead (the thread's 16 points), issued
//     as soon as the current row sits in shared memory.
// Shared memory per block: 12.25N B for K1-db and K2-db (200 KB at MAX_N =
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
constexpr int rfft_db_smem(int n) { return row_smem_bytes(n / 2, 1) + 4 * n; }
constexpr int irfft_db_smem(int n) { return row_smem_bytes(n / 2, 1) + 4 * n; }
// K4-db lands rows in shared memory where the 8N B landing buffer fits
// beside the two padded buffers, else prefetches them into registers.
constexpr bool cfft_lands(int n) { return row_smem_bytes(n, 1) + 8 * n <= kMaxSmemBytes; }
constexpr int cfft_db_smem(int n) { return row_smem_bytes(n, 1) + (cfft_lands(n) ? 8 * n : 0); }
constexpr int kMaxK1DbThreads = 512;  // K1-db, K2-db: M/16 at MAX_N, 128 registers a thread
static_assert(rfft_db_smem(kMaxN) <= kMaxSmemBytes, "K1-db at MAX_N exceeds shared memory");
static_assert(kMaxN / 2 / kRowPoints <= kMaxK1DbThreads, "K1-db at MAX_N exceeds its threads a block");
static_assert(irfft_db_smem(kMaxN) <= kMaxSmemBytes, "K2-db at MAX_N exceeds shared memory");
static_assert(row_smem_bytes(kMaxCN, 1) <= kMaxSmemBytes, "K4-db at MAX_CN exceeds shared memory");
static_assert(kMaxCN / kRowPoints <= kMaxThreads, "K4-db at MAX_CN exceeds the threads of a block");

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
// [re | im] rows: ystride N, yim = yre + N/2); M/16 threads a block.
__global__ void __launch_bounds__(kMaxK1DbThreads)
rfft_db_kernel(const float* __restrict__ x, float* yre, float* yim, int ystride, int rows, int n, Passes ps,
               const float2* __restrict__ tw, const float2* __restrict__ split_tw,
               const int* __restrict__ perm) {
  extern __shared__ __align__(16) float2 smem[];
  const int M = n / 2;
  float2* land = smem;
  float2* a = smem + M;
  const int G = gridDim.x;
  int row = blockIdx.x;
  copy_async(land, x + static_cast<size_t>(row) * n, 4 * n);
  cp_async_commit();
  for (; row < rows; row += G) {
    cp_async_wait_all();
    __syncthreads();  // the row has landed; the previous row's stores are done with its buffers
    const int next = row + G;
    const size_t out = static_cast<size_t>(row) * ystride;
    rfft_row(reinterpret_cast<const float*>(land), a, a + padded(M), M, ps, tw, split_tw, perm, yre + out,
             yim + out, true, threadIdx.x, blockDim.x, [&] {
               if (next < rows) copy_async(land, x + static_cast<size_t>(next) * n, 4 * n);
               cp_async_commit();
             });
  }
}

// K2-db: packed planes (rows, N/2) x2 -> x (rows, N), unscaled. The
// landing buffer holds the row's re plane, then its im plane.
__device__ __forceinline__ void fetch_planes(float* land, const float* yre, const float* yim,
                                             int row, int M) {
  copy_async(land, yre + static_cast<size_t>(row) * M, 4 * M);
  copy_async(land + M, yim + static_cast<size_t>(row) * M, 4 * M);
}

__global__ void __launch_bounds__(kMaxK1DbThreads)
irfft_db_kernel(const float* __restrict__ yre, const float* __restrict__ yim, float* __restrict__ x, int rows,
                int n, Passes ps, const float2* __restrict__ tw, const float2* __restrict__ split_tw,
                const int* __restrict__ perm) {
  extern __shared__ __align__(16) float2 smem[];
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
    __syncthreads();  // the row has landed; the previous row's passes are done with a and b
    const int next = row + G;
    irfft_row<false>(land, land + M, nullptr, nullptr, 1.0f, perm, a, b, M, ps, tw, split_tw,
                     x + static_cast<size_t>(row) * n, true, threadIdx.x, blockDim.x, [&] {
                       if (next < rows) fetch_planes(land, yre, yim, next, M);
                       cp_async_commit();
                     });
  }
}

// K4-db. SIGN = -1 forward, +1 backward; N/16 threads a block, MAXT the
// launch bound (as K4's). LAND: cp.async into the landing buffer
// (interleaved rows as they are in device memory; planes as the re row,
// then the im row), else a register prefetch of the thread's 16 points.
template <int SIGN, int MAXT, bool LAND>
__global__ void __launch_bounds__(MAXT)
cfft_db_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
               float* __restrict__ yre, float* __restrict__ yim, int stride, int rows, int n,
               Passes ps, const float2* __restrict__ tw, const int* __restrict__ perm) {
  extern __shared__ __align__(16) float2 smem[];
  float* land = reinterpret_cast<float*>(smem);
  float2* a = LAND ? smem + n : smem;
  float2* b = a + padded(n);
  const float* lre = land;
  const float* lim = land + (stride == 2 ? 1 : n);
  const int G = gridDim.x;
  const int t = threadIdx.x;
  const int tpr = blockDim.x;
  float2 reg[kRowPoints];

  auto fetch = [&](int r) {
    const size_t base = static_cast<size_t>(r) * n * stride;
    if (LAND) {
      if (stride == 2) {
        copy_async(land, xre + base, 8 * n);
      } else {
        copy_async(land, xre + base, 4 * n);
        copy_async(land + n, xim + base, 4 * n);
      }
      cp_async_commit();
    } else {
      const ComplexIn in{xre + base, xim + base, stride == 2};
#pragma unroll
      for (int c = 0; c < kRowPoints; ++c) reg[c] = in(t + c * tpr);
    }
  };

  int row = blockIdx.x;
  fetch(row);
  for (; row < rows; row += G) {
    if (LAND) cp_async_wait_all();
    __syncthreads();  // the row has landed; the previous row's stores are done with a and b
    const int next = row + G;
    const size_t base = static_cast<size_t>(row) * n * stride;
    auto hook = [&] {
      if (next < rows) {
        fetch(next);
      } else if (LAND) {
        cp_async_commit();
      }
    };
    if (LAND) {
      cfft_row<SIGN>(lre, lim, stride, perm, a, b, n, ps, tw, yre + base, yim + base, true, t, tpr, hook);
    } else {
      cfft_row_from<SIGN>(reg, perm, a, b, n, ps, tw, yre + base, yim + base, stride, true, t, tpr, hook);
    }
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

// K1-db, K2-db: N of the domain's form (rows of N floats and of N/2
// floats are whole 16-byte copies), the radices and the pass plan.
int real_setup(int n, const int* radices, int nstages, const int* passes, int npasses, Passes* ps) {
  if (n < 16 || n > kMaxN || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  const int err = make_radices(radices, nstages, &rad);
  return err ? err : check_passes(passes, npasses, rad, n / 2, ps);
}

template <int SIGN, int MAXT, bool LAND>
int launch_cfft_db(const float* xre, const float* xim, float* yre, float* yim, int stride, int rows, int n,
                   const Passes& ps, const float2* tw, const int* perm, cudaStream_t stream) {
  auto kernel = cfft_db_kernel<SIGN, MAXT, LAND>;
  int err = set_smem(kernel, cfft_db_smem(n));
  if (err) return err;
  const int threads = n / kRowPoints;
  int grid = 0;
  err = persistent_grid(kernel, threads, cfft_db_smem(n), rows, &grid);
  if (err) return err;
  kernel<<<grid, threads, cfft_db_smem(n), stream>>>(xre, xim, yre, yim, stride, rows, n, ps, tw, perm);
  return static_cast<int>(cudaGetLastError());
}

template <int SIGN>
int cfft_db(const float* xre, const float* xim, float* yre, float* yim, int stride, int rows, int n,
            const Passes& ps, const float2* tw, const int* perm, cudaStream_t stream) {
  if (n / kRowPoints <= 512)  // up to 8192 points: the landing buffer fits
    return launch_cfft_db<SIGN, 512, true>(xre, xim, yre, yim, stride, rows, n, ps, tw, perm, stream);
  return cfft_lands(n)
             ? launch_cfft_db<SIGN, 1024, true>(xre, xim, yre, yim, stride, rows, n, ps, tw, perm, stream)
             : launch_cfft_db<SIGN, 1024, false>(xre, xim, yre, yim, stride, rows, n, ps, tw, perm, stream);
}

}  // namespace

extern "C" {

// Blocks of a pipelined kernel resident on one SM at size n (which: 1
// K1-db, 2 K2-db, 4 K4-db forward); 0 if the query fails.
int hopper_pipelined_blocks_per_sm(int which, int n) {
  int per_sm = 0;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if ((which == 1 || which == 2) && n >= 16 && n <= kMaxN && n % (2 * kRowPoints) == 0) {
    err = which == 1 ? blocks_at(rfft_db_kernel, n / 2 / kRowPoints, rfft_db_smem(n), &per_sm)
                     : blocks_at(irfft_db_kernel, n / 2 / kRowPoints, irfft_db_smem(n), &per_sm);
  } else if (which == 4 && n >= 16 && n <= kMaxCN && n % kRowPoints == 0) {
    const int threads = n / kRowPoints;
    if (threads <= 512)
      err = blocks_at(cfft_db_kernel<-1, 512, true>, threads, cfft_db_smem(n), &per_sm);
    else
      err = cfft_lands(n) ? blocks_at(cfft_db_kernel<-1, 1024, true>, threads, cfft_db_smem(n), &per_sm)
                          : blocks_at(cfft_db_kernel<-1, 1024, false>, threads, cfft_db_smem(n), &per_sm);
  }
  return err ? 0 : per_sm;
}

// K1-db; k1_rfft_packed's arguments without the launch geometry (one row
// a block, M/16 threads, a persistent grid). x must be 16-byte aligned.
// Returns a cudaError_t value; 0 means the launch was accepted.
int k1db_rfft_packed(const float* x, float* yre, float* yim, int ystride, int rows, int n,
                     const int* radices, int nstages, const int* passes, int npasses, const void* tw,
                     const void* split_tw, const int* perm, void* stream) {
  Passes ps;
  int err = real_setup(n, radices, nstages, passes, npasses, &ps);
  if (err) return err;
  if (ystride < n / 2 || !aligned16(x)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  err = set_smem(rfft_db_kernel, rfft_db_smem(n));
  if (err) return err;
  const int threads = n / 2 / kRowPoints;
  int grid = 0;
  err = persistent_grid(rfft_db_kernel, threads, rfft_db_smem(n), rows, &grid);
  if (err) return err;
  rfft_db_kernel<<<grid, threads, rfft_db_smem(n), static_cast<cudaStream_t>(stream)>>>(
      x, yre, yim, ystride, rows, n, ps, static_cast<const float2*>(tw), static_cast<const float2*>(split_tw),
      perm);
  return static_cast<int>(cudaGetLastError());
}

// K2-db; k2_irfft_packed's arguments without the launch geometry (one
// row a block, M/16 threads, a persistent grid). yre and yim must be
// 16-byte aligned.
int k2db_irfft_packed(const float* yre, const float* yim, float* x, int rows, int n, const int* radices,
                      int nstages, const int* passes, int npasses, const void* tw, const void* split_tw,
                      const int* perm, void* stream) {
  Passes ps;
  int err = real_setup(n, radices, nstages, passes, npasses, &ps);
  if (err) return err;
  if (!aligned16(yre) || !aligned16(yim) || (perm && !aligned16(perm)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  err = set_smem(irfft_db_kernel, irfft_db_smem(n));
  if (err) return err;
  const int threads = n / 2 / kRowPoints;
  int grid = 0;
  err = persistent_grid(irfft_db_kernel, threads, irfft_db_smem(n), rows, &grid);
  if (err) return err;
  irfft_db_kernel<<<grid, threads, irfft_db_smem(n), static_cast<cudaStream_t>(stream)>>>(
      yre, yim, x, rows, n, ps, static_cast<const float2*>(tw), static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

// K4-db; k4_cfft's arguments without the launch geometry (one row a
// block, N/16 threads, a persistent grid). The input rows must be 16-byte
// aligned (xre; and xim for planes).
int k4db_cfft(const float* xre, const float* xim, float* yre, float* yim, int stride, int rows, int n, int sign,
              const int* radices, int nstages, const int* passes, int npasses, const void* tw,
              const int* perm, void* stream) {
  if (n < 16 || n > kMaxCN || n % 4 || (stride != 1 && stride != 2) || (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(xre) || (stride == 1 && !aligned16(xim))) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  Passes ps;
  err = check_passes(passes, npasses, rad, n, &ps);
  if (err) return err;
  if (rows == 0) return 0;
  const float2* twp = static_cast<const float2*>(tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sign < 0 ? cfft_db<-1>(xre, xim, yre, yim, stride, rows, n, ps, twp, perm, s)
                  : cfft_db<1>(xre, xim, yre, yim, stride, rows, n, ps, twp, perm, s);
}

}  // extern "C"
