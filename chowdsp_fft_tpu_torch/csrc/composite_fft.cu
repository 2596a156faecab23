// Two-level composite FFT kernels for Hopper (sm_90a): the column FFT in
// the four roles of the complex composite, and the column-blocked packed
// real FFT and its inverse that are the real composite's level 1.
//
// Replaces (chowdsp_fft_tpu/ops/pallas_fft.py):
//   K6  k6_l1, k6_l2, k6_l2_rev, k6_l1_rev <- _cfft_v2_l1_kernel :2531,
//       _cfft_v2_l2_kernel :2556, _cfft_v2_l2_rev_kernel :2587,
//       _cfft_v2_l1_rev_kernel :2621, called through _v2_call :2700 by
//       _cfft_composite_v2 :2741 and by the real composite :3160-3284
//   K7a k7a_rfft_cols  <- _rfft_cols_kernel :1398 (_rfft_packed_cols_impl :1463)
//   K7b k7b_irfft_cols <- _irfft_cols_kernel :1541 (_irfft_packed_cols_impl :1565)
//
// What they compute (the JAX package's contracts, not its TPU tiling):
//   * K6 on a (B, L, M) array of complex points: the unscaled length-L DFT
//     of each of the M columns of each batch row, forward (SIGN = -1) or
//     backward (+1); the input is read as columns (B, L, M) or as rows
//     (B, M, L), the output written as columns or rows; level 2 multiplies
//     by a (L, M) four-step twiddle before (forward) or after (backward)
//     the DFT. Complex data are two float32 planes (element stride 1) or
//     interleaved complex64 (stride 2, im pointer one float after re).
//   * K7a: (B, A, C) float32 -> packed planes (B, C, A/2) of the length-A
//     real DFT of every column, DC in re[0] and Nyquist in im[0]; K7b the
//     unscaled inverse, (B, C, A/2) planes -> (B, A, C).
//
// What bounds them on the card: bytes. Each kernel reads and writes the
// whole array once: 16 B per complex point per level, 8 B per real sample
// (K7a, K7b); level 2 also reads its (L, M) twiddle table, 8 B per point of
// one batch row, shared by the batch and resident in the 50 MB L2 (8 MB at
// N = 2^20). The arithmetic is O(log L) flops per point, far below the
// H100's flop/byte balance.
//
// Design: one thread block per tile of TC adjacent columns of one batch
// row; TC is the largest power of two up to kMaxTile whose two padded
// L*TC-point buffers fit the 227 KB of shared memory (tile_shift: TC = 8
// at L = 1024, 135 KB; 4 at L = 2048; 16 at L <= 512). Column-side loads and stores take one
// TC*4-byte segment per plane and row of the tile (32 B at TC = 8, one
// DRAM sector; 64 B interleaved), consecutive threads on consecutive
// columns, then rows; row-side loads and stores (level 1's transposed
// side) are whole contiguous rows of L points. In shared memory the tile's
// columns are interleaved (point l of column j at l*TC + j), so the
// Stockham stages (stockham.cuh, with 2^ls = TC lanes) keep neighbouring
// threads on neighbouring words. Each element of the array is read from
// and written to device memory once per kernel. Twiddles come from the
// plans' float32 tables and the four-step table, all built in float64 on
// the host and read through the read-only cache; no sinf/cosf. A ragged
// last tile (M not a multiple of TC) is masked.

#include <climits>

#include "stockham.cuh"

#ifndef CHOWDSP_MAX_COL
#error "build with -DCHOWDSP_MAX_COL=<longest column> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxCol = CHOWDSP_MAX_COL;
// A tile's two buffers may take all of a block's shared memory but 1 KB,
// which is left to the kernels' static shared memory (K7b's Nyquist slots).
constexpr int kTileBytes = kMaxSmemBytes - 1024;
static_assert(two_buffers_bytes(kMaxCol) <= kTileBytes, "MAX_COL exceeds shared memory");
constexpr int kMaxTile = 16;

enum { kNoTwiddle = 0, kTwiddleBefore = 1, kTwiddleAfter = 2 };

// Block -> (batch row, first column of its tile).
struct Tile {
  int b;
  int m0;
};

__device__ __forceinline__ Tile tile_of(int M, int ls) {
  const int tiles = (M + (1 << ls) - 1) >> ls;
  Tile t;
  t.b = blockIdx.x / tiles;
  t.m0 = (blockIdx.x - t.b * tiles) << ls;
  return t;
}

// K6. Input (B, L, M) (columns) or (B, M, L) (rows, ROWS_IN), output the
// same way (ROWS_OUT); TW multiplies by tw[l*M + m] before or after.
template <int SIGN, bool ROWS_IN, bool ROWS_OUT, int TW>
__global__ void __launch_bounds__(kMaxThreads)
column_fft_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                  float* __restrict__ yre, float* __restrict__ yim, int stride, int L, int M,
                  int ls, Radices rad, const float2* __restrict__ stage_tw,
                  const float2* __restrict__ tw) {
  extern __shared__ float2 smem[];
  const int lanes = 1 << ls;
  const int pts = L << ls;
  float2* a = smem;
  float2* b = smem + padded(pts);
  const Tile t = tile_of(M, ls);
  const size_t base = static_cast<size_t>(t.b) * L * M;

  for (int u = threadIdx.x; u < pts; u += blockDim.x) {
    int l, j;
    if (ROWS_IN) {
      j = u / L;
      l = u - j * L;
    } else {
      l = u >> ls;
      j = u & (lanes - 1);
    }
    const int m = t.m0 + j;
    float2 v = make_float2(0.0f, 0.0f);
    if (m < M) {
      const size_t at = (base + (ROWS_IN ? static_cast<size_t>(m) * L + l
                                         : static_cast<size_t>(l) * M + m)) * stride;
      v = make_float2(xre[at], xim[at]);
      if (TW == kTwiddleBefore) v = cmul(v, __ldg(tw + static_cast<size_t>(l) * M + m));
    }
    a[slot((l << ls) + j)] = v;
  }
  __syncthreads();
  const float2* z = run_stages<SIGN>(a, b, L, rad, stage_tw, ls);

  for (int u = threadIdx.x; u < pts; u += blockDim.x) {
    int l, j;
    if (ROWS_OUT) {
      j = u / L;
      l = u - j * L;
    } else {
      l = u >> ls;
      j = u & (lanes - 1);
    }
    const int m = t.m0 + j;
    if (m >= M) continue;
    float2 v = z[slot((l << ls) + j)];
    if (TW == kTwiddleAfter) v = cmul(v, __ldg(tw + static_cast<size_t>(l) * M + m));
    const size_t at = (base + (ROWS_OUT ? static_cast<size_t>(m) * L + l
                                        : static_cast<size_t>(l) * M + m)) * stride;
    yre[at] = v.x;
    yim[at] = v.y;
  }
}

// K7a: x (B, A, C) -> packed planes (B, C, A/2). Column c of a batch row
// is staged as H = A/2 complex points x[2h] + i x[2h+1], transformed, and
// split into the real spectrum as K1 does (real_fft.cu).
__global__ void __launch_bounds__(kMaxThreads)
rfft_cols_kernel(const float* __restrict__ x, float* __restrict__ yre,
                 float* __restrict__ yim, int A, int C, int ls, Radices rad,
                 const float2* __restrict__ stage_tw, const float2* __restrict__ split_tw) {
  extern __shared__ float2 smem[];
  const int H = A / 2;
  const int lanes = 1 << ls;
  const int pts = H << ls;
  float2* a = smem;
  float2* b = smem + padded(pts);
  const Tile t = tile_of(C, ls);
  const float* xb = x + static_cast<size_t>(t.b) * A * C;

  for (int u = threadIdx.x; u < pts; u += blockDim.x) {
    const int h = u >> ls;
    const int m = t.m0 + (u & (lanes - 1));
    float2 v = make_float2(0.0f, 0.0f);
    if (m < C) {
      v = make_float2(xb[static_cast<size_t>(2 * h) * C + m],
                      xb[static_cast<size_t>(2 * h + 1) * C + m]);
    }
    a[slot(u)] = v;
  }
  __syncthreads();
  const float2* Z = run_stages<-1>(a, b, H, rad, stage_tw, ls);

  // Split (stockham.cuh split_bin); the Nyquist bin goes to im[0]. Stored
  // as rows of H bins.
  const size_t obase = static_cast<size_t>(t.b) * C * H;
  for (int u = threadIdx.x; u < pts; u += blockDim.x) {
    const int j = u / H;
    const int k = u - j * H;
    const int m = t.m0 + j;
    if (m >= C) continue;
    float re, im;
    if (k == 0) {
      const float2 z0 = Z[slot(j)];
      re = z0.x + z0.y;
      im = z0.x - z0.y;
    } else {
      const float2 X = split_bin(Z[slot((k << ls) + j)], Z[slot(((H - k) << ls) + j)],
                                 __ldg(split_tw + k));
      re = X.x;
      im = X.y;
    }
    const size_t at = obase + static_cast<size_t>(m) * H + k;
    yre[at] = re;
    yim[at] = im;
  }
}

// K7b: packed planes (B, C, A/2) -> x (B, A, C), unscaled: K2's merge and
// inverse stages (real_fft.cu) per column, stored down the columns.
__global__ void __launch_bounds__(kMaxThreads)
irfft_cols_kernel(const float* __restrict__ yre, const float* __restrict__ yim,
                  float* __restrict__ x, int A, int C, int ls, Radices rad,
                  const float2* __restrict__ stage_tw, const float2* __restrict__ split_tw) {
  extern __shared__ float2 smem[];
  __shared__ float nyq[kMaxTile];
  const int H = A / 2;
  const int lanes = 1 << ls;
  const int pts = H << ls;
  float2* a = smem;
  float2* b = smem + padded(pts);
  const Tile t = tile_of(C, ls);
  const size_t ibase = static_cast<size_t>(t.b) * C * H;

  for (int u = threadIdx.x; u < pts; u += blockDim.x) {
    const int j = u / H;
    const int k = u - j * H;
    const int m = t.m0 + j;
    float re = 0.0f, im = 0.0f;
    if (m < C) {
      re = yre[ibase + static_cast<size_t>(m) * H + k];
      im = yim[ibase + static_cast<size_t>(m) * H + k];
    }
    if (k == 0) {  // im[0] holds the Nyquist bin
      nyq[j] = im;
      im = 0.0f;
    }
    a[slot((k << ls) + j)] = make_float2(re, im);
  }
  __syncthreads();

  // Merge (stockham.cuh merge_bin), with X[H] the Nyquist bin.
  for (int u = threadIdx.x; u < pts; u += blockDim.x) {
    const int k = u >> ls;
    const int j = u & (lanes - 1);
    const float2 xr = k == 0 ? make_float2(nyq[j], 0.0f) : cconj(a[slot(((H - k) << ls) + j)]);
    b[slot(u)] = merge_bin(a[slot(u)], xr, __ldg(split_tw + k));
  }
  __syncthreads();
  const float2* zt = run_stages<1>(b, a, H, rad, stage_tw, ls);

  // zt == H * (x_even + i x_odd); A * x = 2 * H * x.
  float* xb = x + static_cast<size_t>(t.b) * A * C;
  for (int u = threadIdx.x; u < pts; u += blockDim.x) {
    const int h = u >> ls;
    const int m = t.m0 + (u & (lanes - 1));
    if (m >= C) continue;
    const float2 z = zt[slot(u)];
    xb[static_cast<size_t>(2 * h) * C + m] = 2.0f * z.x;
    xb[static_cast<size_t>(2 * h + 1) * C + m] = 2.0f * z.y;
  }
}

// log2 of the column tile for columns of 2 <= points <= kMaxCol complex
// points: the largest power of two up to kMaxTile whose two buffers of
// points * tile entries fit kTileBytes (one column always fits, by the
// static_assert above).
int tile_shift(int points) {
  int ls = 0;
  while ((2 << ls) <= kMaxTile && two_buffers_bytes(points << (ls + 1)) <= kTileBytes) ++ls;
  return ls;
}

// Blocks for `batch` rows of ceil(M / 2^ls) tiles, or -1 past the grid.
long long block_count(int batch, int M, int ls) {
  const long long blocks = static_cast<long long>(batch) * ((M + (1 << ls) - 1) >> ls);
  return blocks <= INT_MAX ? blocks : -1;
}

template <int SIGN, bool ROWS_IN, bool ROWS_OUT, int TW>
int launch_column(const float* xre, const float* xim, float* yre, float* yim, int stride,
                  int batch, int L, int M, const int* radices, int nstages,
                  const void* stage_tw, const void* tw, void* stream) {
  if (L < 2 || L > kMaxCol || M < 0 || batch < 0 || (stride != 1 && stride != 2) ||
      (TW != kNoTwiddle && tw == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ls = tile_shift(L);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  if (batch == 0 || M == 0) return 0;
  const long long blocks = block_count(batch, M, ls);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = column_fft_kernel<SIGN, ROWS_IN, ROWS_OUT, TW>;
  const int pts = L << ls;
  err = set_smem(kernel, two_buffers_bytes(pts));
  if (err) return err;
  kernel<<<static_cast<int>(blocks), threads_for(pts), two_buffers_bytes(pts),
           static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, stride, L, M, ls, rad, static_cast<const float2*>(stage_tw),
      static_cast<const float2*>(tw));
  return static_cast<int>(cudaGetLastError());
}

// Checks shared by K7a and K7b, then the tile shift, the radices and the
// grid.
template <typename K>
int launch_real_cols(K kernel, int batch, int A, int C, const int* radices, int nstages,
                     int* ls, Radices* rad, int* blocks) {
  if (A < 4 || A > kMaxCol || A % 2 || C < 0 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *ls = tile_shift(A / 2);
  int err = make_radices(radices, nstages, rad);
  if (err) return err;
  const long long b = block_count(batch, C, *ls);
  if (b < 0) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<int>(b);
  return set_smem(kernel, two_buffers_bytes((A / 2) << *ls));
}

}  // namespace

extern "C" {

int hopper_composite_max_col() { return kMaxCol; }

// The column tile the kernels take for columns of `points` complex points
// (L for K6, A/2 for K7), or -1 outside [2, MAX_COL].
int hopper_composite_col_tile(int points) {
  return points < 2 || points > kMaxCol ? -1 : 1 << tile_shift(points);
}

// K6 level 1, forward: (B, L, M) columns -> (B, M, L) rows. Returns a
// cudaError_t value; 0 means the launch was accepted.
int k6_l1(const float* xre, const float* xim, float* yre, float* yim, int stride, int batch,
          int L, int M, const int* radices, int nstages, const void* stage_tw,
          const void* tw, void* stream) {
  return launch_column<-1, false, true, kNoTwiddle>(xre, xim, yre, yim, stride, batch, L, M,
                                                    radices, nstages, stage_tw, tw, stream);
}

// K6 level 2, forward: twiddle, then column DFTs of (B, L, M), stored as columns.
int k6_l2(const float* xre, const float* xim, float* yre, float* yim, int stride, int batch,
          int L, int M, const int* radices, int nstages, const void* stage_tw,
          const void* tw, void* stream) {
  return launch_column<-1, false, false, kTwiddleBefore>(xre, xim, yre, yim, stride, batch, L, M,
                                                         radices, nstages, stage_tw, tw, stream);
}

// K6 level 2, backward: inverse column DFTs of (B, L, M), then twiddle.
int k6_l2_rev(const float* xre, const float* xim, float* yre, float* yim, int stride,
              int batch, int L, int M, const int* radices, int nstages,
              const void* stage_tw, const void* tw, void* stream) {
  return launch_column<1, false, false, kTwiddleAfter>(xre, xim, yre, yim, stride, batch, L, M,
                                                       radices, nstages, stage_tw, tw, stream);
}

// K6 level 1, backward: (B, M, L) rows -> inverse DFTs -> (B, L, M) columns.
int k6_l1_rev(const float* xre, const float* xim, float* yre, float* yim, int stride,
              int batch, int L, int M, const int* radices, int nstages,
              const void* stage_tw, const void* tw, void* stream) {
  return launch_column<1, true, false, kNoTwiddle>(xre, xim, yre, yim, stride, batch, L, M,
                                                   radices, nstages, stage_tw, tw, stream);
}

// K7a. radices, stage_tw and split_tw are the length-A real plan's.
int k7a_rfft_cols(const float* x, float* yre, float* yim, int batch, int A, int C,
                  const int* radices, int nstages, const void* stage_tw, const void* split_tw,
                  void* stream) {
  int ls, blocks;
  Radices rad;
  const int err = launch_real_cols(rfft_cols_kernel, batch, A, C, radices, nstages, &ls,
                                   &rad, &blocks);
  if (err || blocks == 0) return err;
  const int pts = (A / 2) << ls;
  rfft_cols_kernel<<<blocks, threads_for(pts), two_buffers_bytes(pts),
                     static_cast<cudaStream_t>(stream)>>>(
      x, yre, yim, A, C, ls, rad, static_cast<const float2*>(stage_tw),
      static_cast<const float2*>(split_tw));
  return static_cast<int>(cudaGetLastError());
}

// K7b.
int k7b_irfft_cols(const float* yre, const float* yim, float* x, int batch, int A, int C,
                   const int* radices, int nstages, const void* stage_tw, const void* split_tw,
                   void* stream) {
  int ls, blocks;
  Radices rad;
  const int err = launch_real_cols(irfft_cols_kernel, batch, A, C, radices, nstages, &ls,
                                   &rad, &blocks);
  if (err || blocks == 0) return err;
  const int pts = (A / 2) << ls;
  irfft_cols_kernel<<<blocks, threads_for(pts), two_buffers_bytes(pts),
                      static_cast<cudaStream_t>(stream)>>>(
      yre, yim, x, A, C, ls, rad, static_cast<const float2*>(stage_tw),
      static_cast<const float2*>(split_tw));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
