// K5 for Hopper (sm_90a): the small-N transforms as row-tiled mixed-radix
// FFTs. Complex forward and backward, real forward to packed planes, and
// real inverse from packed planes.
//
// Replaces one TPU kernel of chowdsp_fft_tpu/ops/pallas_fft.py, _small_call
// :2252 (pl.pallas_call :2269), in its three bodies:
//   K5 small_cfft_kernel  <- _small_cfft_kernel  :2299 (via _small_cfft_pair)
//   K5 small_rfft_kernel  <- _small_rfft_kernel  :2310 (via _small_rfft_packed)
//   K5 small_irfft_kernel <- _small_irfft_kernel :2319 (via _small_irfft_packed)
//
// What they compute (the JAX package's contract; the TPU computes it as a
// direct DFT on the MXU, this port as an FFT):
//   * complex: the unscaled DFT of each row, exp(-2i*pi*jk/N) forward and
//     exp(+2i*pi*jk/N) backward, rows as two float32 planes (element
//     stride 1) or interleaved complex64 (the im pointer one float after re);
//   * real forward: packed planes (rows, N/2), DC in re[0] and the Nyquist
//     bin in im[0]; real inverse: the unscaled inverse of those planes;
//   * natural bin order, which is also the unordered layout at these sizes.
//
// What bounds them on the card: bytes. Each row is read and written once:
// 16 B per complex point, 8 B per real sample (4 in, 4 out as packed
// planes). An FFT does 5 N log2 N flops per complex row, 2.5 flops per
// byte moved at N = 256, far below the H100's FP32 balance (~20 per byte);
// a direct DFT's 8 N^2 would be bound by its flops instead.
//
// Design: one block per tile of T = 2^ls consecutive rows, chosen by the
// wrapper (hopper_small.launch_geometry): the largest T whose rows hold at
// most 512 complex points (M = N complex, N/2 real; T = 2 at complex
// N = 256, 4 at real N = 256), with at most 8 points per thread (64
// threads at 512 points).
// In shared memory the tile's rows are interleaved, point i of row r at
// slot((i << ls) + r), so the plan's Stockham stages (stockham.cuh
// run_stages, with 2^ls lanes) keep
// neighbouring threads on neighbouring words, and a warp reads one twiddle
// for its T lanes. The real bodies are K1's and K2's: the M-point
// transform of x[2m] + i x[2m+1] with the split (split_bin) after it; the
// merge (merge_bin), the inverse stages and x2 before the store, slot 0
// carrying (DC, Nyquist) into the merge. The tile's rows are one contiguous
// span of device memory, walked row-fastest up to T = 8 (conflict-free
// shared stores, 4+ consecutive points of a row per warp) and
// point-fastest above (coalesced). A thread issues all its loads before
// its first shared store (load_tile), and its stores and merge steps are
// unrolled the same way (for_points). Twiddles are the plan's float32
// tables (built in float64 on the host: stage_flat, split_tw) read through
// the read-only cache; FP32 FMA only, no sinf/cosf, no TF32, no tensor
// cores. The ragged last tile is masked: its missing rows are zeros that
// are transformed and never stored. Every element of the batch is read
// from and written to device memory once.
//
// Chosen by measurement on the H100 at N=256, B=32768 against tiles of
// 256, 1024 and 2048 points (PERF.md). What limits the kernel is
// how many bytes each SM keeps in flight, since a block's load, stages and
// store follow each other: small tiles put 18-20 blocks on an SM, and
// issuing each thread's 8 loads at once (load_tile) beat loading point by
// point. Tried in development and left out, as slower or no faster: two
// stages fused in registers (fewer shared-memory passes but fewer
// threads), persistent blocks that prefetch the next tile into registers
// (64 registers, fewer blocks), register caps by __launch_bounds__
// (spills), and unrolling each stage's butterflies (a few percent, not
// worth a second copy of stockham.cuh's stage). The lane-interleaved
// layout keeps stockham.cuh's stages as they are; a row-contiguous layout
// would need a stage of its own against stride-R bank conflicts.
//
// Left out: 16-byte vector loads and stores (each thread moves one float2
// or two floats).

#include "stockham.cuh"

#ifndef CHOWDSP_MAX_SMALL_N
#error "build with -DCHOWDSP_MAX_SMALL_N=<largest small N> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxSmallN = CHOWDSP_MAX_SMALL_N;
constexpr int kMaxShift = 16;  // tile rows up to 2^16 (smem bounds them far lower)
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory allowed without opting in
constexpr int kLaneWalkShift = 3;  // tiles of up to 8 rows load and store row-fastest
constexpr int kPerThread = 8;  // tile points per thread (the geometry keeps the tile within)

// Element u of a tile's load/store walk -> row r and point i (element
// r*m + i of the tile's span). Up to 2^kLaneWalkShift rows per tile the walk
// takes the row fastest, the stages' lane order: shared memory sees
// consecutive words, and a warp still covers at least 4 consecutive points
// of each row. Above, it takes the point fastest: consecutive addresses in
// device memory (a row-fastest warp would touch 32 rows), at the price of
// strided shared stores.
struct Elem {
  int r;
  int i;
};

__device__ __forceinline__ Elem elem(int u, int m, int ls) {
  Elem e;
  if (ls <= kLaneWalkShift) {
    e.r = u & ((1 << ls) - 1);
    e.i = u >> ls;
  } else {
    e.r = u / m;
    e.i = u - e.r * m;
  }
  return e;
}

// Runs f(u) for the tile's points u < pts that this thread takes, u =
// threadIdx.x + k * blockDim.x for k < kPerThread, unrolled so the
// compiler can overlap their loads.
template <typename F>
__device__ __forceinline__ void for_points(int pts, F f) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int u = threadIdx.x + k * blockDim.x;
    if (u < pts) f(u);
  }
}

// Loads the tile into shared memory, point i of row r (element g = r*m + i
// of the tile's span, `load(g)`; zeros past `live`) to slot((i << ls) + r).
// Each thread takes at most kPerThread points and issues all its loads
// before its first shared store, so a block has its whole tile in flight.
template <typename Load>
__device__ __forceinline__ void load_tile(float2* a, int m, int ls, int live, Load load) {
  const int pts = m << ls;
  float2 v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int u = threadIdx.x + k * blockDim.x;
    v[k] = make_float2(0.0f, 0.0f);
    if (u < pts) {
      const Elem e = elem(u, m, ls);
      const int g = e.r * m + e.i;
      if (g < live) v[k] = load(g);
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int u = threadIdx.x + k * blockDim.x;
    if (u < pts) {
      const Elem e = elem(u, m, ls);
      a[slot((e.i << ls) + e.r)] = v[k];
    }
  }
  __syncthreads();
}

// Complex. SIGN = -1 forward, +1 backward; INTERLEAVED: complex64 rows
// (float2 loads and stores), else two float32 planes.
template <int SIGN, bool INTERLEAVED>
__global__ void __launch_bounds__(kMaxThreads)
small_cfft_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                  float* __restrict__ yre, float* __restrict__ yim, int rows, int n, int ls,
                  Radices rad, const float2* __restrict__ stage_tw) {
  extern __shared__ float2 smem[];
  const int pts = n << ls;
  float2* a = smem;
  float2* b = smem + padded(pts);
  const int row0 = blockIdx.x << ls;
  const int live = min(rows - row0, 1 << ls) * n;  // elements of the tile's real rows
  const size_t base = static_cast<size_t>(row0) * n;

  load_tile(a, n, ls, live, [&](int g) {
    return INTERLEAVED ? reinterpret_cast<const float2*>(xre)[base + g]
                       : make_float2(xre[base + g], xim[base + g]);
  });
  const float2* z = run_stages<SIGN>(a, b, n, rad, stage_tw, ls);

  for_points(pts, [&](int u) {
    const Elem e = elem(u, n, ls);
    const int g = e.r * n + e.i;
    if (g >= live) return;
    const float2 v = z[slot((e.i << ls) + e.r)];
    if (INTERLEAVED) {
      reinterpret_cast<float2*>(yre)[base + g] = v;
    } else {
      yre[base + g] = v.x;
      yim[base + g] = v.y;
    }
  });
}

// Real forward: x (rows, 2m) -> packed planes (rows, m).
__global__ void __launch_bounds__(kMaxThreads)
small_rfft_kernel(const float* __restrict__ x, float* __restrict__ yre, float* __restrict__ yim,
                  int rows, int m, int ls, Radices rad, const float2* __restrict__ stage_tw,
                  const float2* __restrict__ split_tw) {
  extern __shared__ float2 smem[];
  const int pts = m << ls;
  float2* a = smem;
  float2* b = smem + padded(pts);
  const int row0 = blockIdx.x << ls;
  const int live = min(rows - row0, 1 << ls) * m;
  const size_t base = static_cast<size_t>(row0) * m;
  const float2* xp = reinterpret_cast<const float2*>(x) + base;

  load_tile(a, m, ls, live, [&](int g) { return xp[g]; });
  const float2* Z = run_stages<-1>(a, b, m, rad, stage_tw, ls);

  for_points(pts, [&](int u) {
    const Elem e = elem(u, m, ls);
    const int g = e.r * m + e.i;
    if (g >= live) return;
    float re, im;
    if (e.i == 0) {  // DC and, in im[0], the Nyquist bin
      const float2 z0 = Z[slot(e.r)];
      re = z0.x + z0.y;
      im = z0.x - z0.y;
    } else {
      const float2 X = split_bin(Z[slot((e.i << ls) + e.r)], Z[slot(((m - e.i) << ls) + e.r)],
                                 __ldg(split_tw + e.i));
      re = X.x;
      im = X.y;
    }
    yre[base + g] = re;
    yim[base + g] = im;
  });
}

// Real inverse: packed planes (rows, m) -> x (rows, 2m), unscaled. Slot 0
// of each row keeps (DC, Nyquist) as loaded; the merge reads them apart.
__global__ void __launch_bounds__(kMaxThreads)
small_irfft_kernel(const float* __restrict__ yre, const float* __restrict__ yim,
                   float* __restrict__ x, int rows, int m, int ls, Radices rad,
                   const float2* __restrict__ stage_tw, const float2* __restrict__ split_tw) {
  extern __shared__ float2 smem[];
  const int lanes = 1 << ls;
  const int pts = m << ls;
  float2* a = smem;
  float2* b = smem + padded(pts);
  const int row0 = blockIdx.x << ls;
  const int live = min(rows - row0, lanes) * m;
  const size_t base = static_cast<size_t>(row0) * m;

  load_tile(a, m, ls, live, [&](int g) { return make_float2(yre[base + g], yim[base + g]); });

  // Merge (stockham.cuh merge_bin), in lane order; X[M] is the Nyquist bin.
  for_points(pts, [&](int u) {
    const int k = u >> ls;
    const int r = u & (lanes - 1);
    const float2 v = a[slot(u)];
    float2 xk = v, xr;
    if (k == 0) {
      xk = make_float2(v.x, 0.0f);
      xr = make_float2(v.y, 0.0f);
    } else {
      xr = cconj(a[slot(((m - k) << ls) + r)]);
    }
    b[slot(u)] = merge_bin(xk, xr, __ldg(split_tw + k));
  });
  __syncthreads();
  const float2* zt = run_stages<1>(b, a, m, rad, stage_tw, ls);

  // zt == M * (x_even + i x_odd); N * x = 2 * M * x.
  float2* xp = reinterpret_cast<float2*>(x) + base;
  for_points(pts, [&](int u) {
    const Elem e = elem(u, m, ls);
    const int g = e.r * m + e.i;
    if (g >= live) return;
    const float2 z = zt[slot((e.i << ls) + e.r)];
    xp[g] = make_float2(2.0f * z.x, 2.0f * z.y);
  });
}

// Checks the launch geometry the wrapper computed (hopper_small.launch_geometry)
// and the plan's radices: a tile of 2^ls rows of m points whose two padded
// buffers take exactly `smem` bytes within a block's shared memory, a whole
// number of warps up to kMaxThreads, a grid that covers the rows, and
// radices whose product is m.
int check_launch(int rows, int m, int ls, int threads, int smem, int grid, const int* radices,
                 int nstages, Radices* rad) {
  if (rows < 0 || m < 2 || ls < 0 || ls > kMaxShift || threads < 32 || threads > kMaxThreads ||
      threads % 32 || grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pts = static_cast<long long>(m) << ls;
  if (pts > static_cast<long long>(threads) * kPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = 2 * (pts + (pts >> 5)) * static_cast<long long>(sizeof(float2));
  if (bytes != smem || bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (grid != static_cast<int>((static_cast<long long>(rows) + (1 << ls) - 1) >> ls))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = make_radices(radices, nstages, rad);
  if (err) return err;
  long long prod = 1;
  for (int i = 0; i < rad->count; ++i) prod *= rad->r[i];
  return prod == m ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Opt in to `smem` bytes of dynamic shared memory where that is above the
// default.
template <typename K>
int allow_smem(K kernel, int smem) {
  return smem > kDefaultSmem ? set_smem(kernel, smem) : 0;
}

}  // namespace

extern "C" {

int hopper_small_fft_max_n() { return kMaxSmallN; }

// Tile points per thread: launch_geometry's POINTS_PER_THREAD must equal it.
int hopper_small_fft_points_per_thread() { return kPerThread; }

// Resident blocks per SM of a K5 body (0 complex, 1 real forward, 2 real
// inverse) at `threads` threads and `smem` bytes of dynamic shared memory,
// or -1 for an unknown body.
int hopper_small_fft_blocks_per_sm(int body, int threads, int smem) {
  int blocks = 0;
  cudaError_t err;
  switch (body) {
    case 0:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, small_cfft_kernel<-1, true>,
                                                          threads, smem);
      break;
    case 1:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, small_rfft_kernel, threads, smem);
      break;
    case 2:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, small_irfft_kernel, threads, smem);
      break;
    default:
      return -1;
  }
  return err == cudaSuccess ? blocks : -1;
}

// K5 complex. sign = -1 forward, +1 backward; stride 1 (planes) or 2
// (complex64, xim = xre + 1); radices and stage_tw are the length-n complex
// plan's; ls, threads, smem and grid are launch_geometry's. Returns a
// cudaError_t value; 0 means the launch was accepted.
int k5_small_cfft(const float* xre, const float* xim, float* yre, float* yim, int stride,
                  int rows, int n, int sign, const int* radices, int nstages, const void* stage_tw,
                  int ls, int threads, int smem, int grid, void* stream) {
  if (n > kMaxSmallN || (stride != 1 && stride != 2) || (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = check_launch(rows, n, ls, threads, smem, grid, radices, nstages, &rad);
  if (err || rows == 0) return err;
  const float2* tw = static_cast<const float2*>(stage_tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_LAUNCH(SIGN, IL)                                                                    \
  do {                                                                                         \
    err = allow_smem(small_cfft_kernel<SIGN, IL>, smem);                                       \
    if (err) return err;                                                                       \
    small_cfft_kernel<SIGN, IL><<<grid, threads, smem, s>>>(xre, xim, yre, yim, rows, n, ls,   \
                                                            rad, tw);                          \
  } while (0)
  if (sign < 0 && stride == 2)
    K5_LAUNCH(-1, true);
  else if (sign < 0)
    K5_LAUNCH(-1, false);
  else if (stride == 2)
    K5_LAUNCH(1, true);
  else
    K5_LAUNCH(1, false);
#undef K5_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// K5 real forward: x (rows, n) -> packed planes (rows, n/2). radices,
// stage_tw and split_tw are the length-n real plan's (its stages are the
// n/2-point complex transform's).
int k5_small_rfft(const float* x, float* yre, float* yim, int rows, int n, const int* radices,
                  int nstages, const void* stage_tw, const void* split_tw, int ls, int threads,
                  int smem, int grid, void* stream) {
  if (n > kMaxSmallN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = check_launch(rows, n / 2, ls, threads, smem, grid, radices, nstages, &rad);
  if (err || rows == 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = allow_smem(small_rfft_kernel, smem);
  if (err) return err;
  small_rfft_kernel<<<grid, threads, smem, s>>>(x, yre, yim, rows, n / 2, ls, rad,
                                                static_cast<const float2*>(stage_tw),
                                                static_cast<const float2*>(split_tw));
  return static_cast<int>(cudaGetLastError());
}

// K5 real inverse: packed planes (rows, n/2) -> x (rows, n), unscaled.
int k5_small_irfft(const float* yre, const float* yim, float* x, int rows, int n,
                   const int* radices, int nstages, const void* stage_tw, const void* split_tw,
                   int ls, int threads, int smem, int grid, void* stream) {
  if (n > kMaxSmallN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = check_launch(rows, n / 2, ls, threads, smem, grid, radices, nstages, &rad);
  if (err || rows == 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = allow_smem(small_irfft_kernel, smem);
  if (err) return err;
  small_irfft_kernel<<<grid, threads, smem, s>>>(yre, yim, x, rows, n / 2, ls, rad,
                                                 static_cast<const float2*>(stage_tw),
                                                 static_cast<const float2*>(split_tw));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
