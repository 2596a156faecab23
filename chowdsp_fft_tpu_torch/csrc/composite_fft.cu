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
//   * K6 level 2 of the real composite (k6_l2_packed, k6_l2_rev_packed):
//     the (B, C, A/2) level-2 grid G is stored as, or gathered from, the
//     ordered packed planes (B, C/2, A) of the length-N = A*C real DFT,
//     by Hermitian symmetry (PackedColumn); grid column 0 takes the DC and
//     Nyquist lines' transforms instead (the real composite :3160-3284).
//
// What bounds them on the card: bytes. Each kernel reads and writes the
// whole array once: 16 B per complex point per level, 8 B per real sample
// (K7a, K7b); level 2 also reads its (L, M) twiddle table, 8 B per point of
// one batch row, shared by the batch and resident in the 50 MB L2 (8 MB at
// N = 2^20). The arithmetic is O(log L) flops per point, far below the
// H100's flop/byte balance.
//
// Design. K6, K7a and K7b run the column engine (col_passes.cuh): a block
// takes a tile of 2^ls adjacent columns of one batch row, 16 points of one
// column a thread, and runs one of three shapes: narrow (at most 4096
// points and 256 threads, two buffers, three blocks an SM), wide (8192
// points, 512 threads, two buffers, one block an SM, where a narrow tile's
// columns would move less than a 32-byte sector a row and plane) or in
// place (8192 points, 512 threads, one buffer, two blocks an SM, for plans
// whose middle passes are (4,4)). The thread loads its points from device
// memory straight into registers, every load issued before the first is
// used (complex64 as float2; K7a's point h as samples 2h and 2h + 1),
// consecutive threads on consecutive columns; the plan's stages run fused
// in pairs, the first from those registers (16 | L), the last back into
// registers, from which the points are stored. K7b folds the merge into
// the reads after its load and stores the even and odd samples from
// registers. K7a's last pass ends in the tile instead: the split needs
// bins k and L - k, which no thread holds together, and the tile's rows of
// packed bins are contiguous in device memory, so consecutive threads
// split and store consecutive bins. The launch geometry comes from
// ops/col_passes.launch_geometry and is checked here; the shape follows
// from its threads and shared bytes. Each element of the array is read
// from and written to device memory once per kernel. Twiddles come from
// float32 tables (the column passes', the plans' split tables, the
// four-step table), all built in float64 on the host and read through the
// read-only cache; no sinf/cosf. A ragged last tile (M not a multiple of
// the tile) is masked.

#include "col_passes.cuh"

#ifndef CHOWDSP_MAX_COL
#error "build with -DCHOWDSP_MAX_COL=<longest column> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxCol = CHOWDSP_MAX_COL;
// One column of the longest length fits a block's two tile buffers.
static_assert(two_buffers_bytes(kMaxCol) <= kMaxSmemBytes, "MAX_COL exceeds shared memory");


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


// How K6 level 2 meets the real composite's ordered packed planes: not at
// all (the complex roles), storing them (forward) or gathering them
// (backward).
enum { kUnpacked = 0, kPackedOut = 1, kPackedIn = 2 };

// Where thread (t, j)'s points l = q*tpc + t (q < 16) of grid column
// k1 = k0 + j, 0 < k1 < A/2, of the real composite's level-2 grid (C, A/2)
// lie in a batch row's ordered packed planes (C/2, A): l < C/2 at row l,
// column k1; l >= C/2, conjugated, at row C-1-l, column A-k1 (bin
// k1 + A*k2 for k1 > A/2 is conj(G[C-1-k2, A-k1])). That is lo + q*step
// and hi - q*step, with lo = t*A + k1, hi = C*A - t*A - k1, step = tpc*A.
// Grid column 0 has no place there: packed columns 0 and A/2 hold the DC
// and Nyquist lines.
struct PackedColumn {
  int C, A, k1, t, tpc;
  __device__ __forceinline__ int lo() const { return t * A + k1; }
  __device__ __forceinline__ int hi() const { return C * A - t * A - k1; }
};

// K6 level 2's forward store from registers into one batch row's packed
// planes, for grid columns k1 > 0. Where C = 16*tpc (every power of two),
// points q < 8 are the first half and the rest the second.
__device__ __forceinline__ void store_packed(const PackedColumn& p, float* re, float* im, const float2* w) {
  const int lo = p.lo(), hi = p.hi(), step = p.tpc * p.A;
  if (kRowPoints * p.tpc == p.C) {
#pragma unroll
    for (int q = 0; q < kRowPoints / 2; ++q) {
      re[lo + q * step] = w[q].x;
      im[lo + q * step] = w[q].y;
    }
#pragma unroll
    for (int q = kRowPoints / 2; q < kRowPoints; ++q) {
      re[hi - q * step] = w[q].x;
      im[hi - q * step] = -w[q].y;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < kRowPoints; ++q) {
    const int l = q * p.tpc + p.t;
    const bool low = 2 * l < p.C;
    const int e = low ? lo + q * step : hi - q * step;
    if (l < p.C) {
      re[e] = w[q].x;
      im[e] = low ? w[q].y : -w[q].y;
    }
  }
}

// Grid column 0 stores none of its own transform: its thread of point
// l < C/2 writes bins A*l and A*l + A/2 from the DC and Nyquist lines'
// transforms (dc, ny: C points each), and the global Nyquist
// X[N/2] = dc[C/2] (real) into im of bin 0.
__device__ __forceinline__ void store_lines(const PackedColumn& p, float* re, float* im, const float2* dc,
                                            const float2* ny) {
#pragma unroll
  for (int q = 0; q < kRowPoints; ++q) {
    const int l = q * p.tpc + p.t;
    if (2 * l < p.C) {
      const float2 d = __ldg(dc + l), n = __ldg(ny + l);
      re[l * p.A] = d.x;
      im[l * p.A] = l == 0 ? __ldg(dc + p.C / 2).x : d.y;
      re[l * p.A + p.A / 2] = n.x;
      im[l * p.A + p.A / 2] = n.y;
    }
  }
}

// K6 level 2's backward load into registers from one batch row's packed
// planes, for grid columns k1 > 0, every load issued before the first is
// used, split in halves as store_packed's; grid column 0 comes from a (C)
// column built from the DC and Nyquist lines instead.
__device__ __forceinline__ void load_packed(const PackedColumn& p, const float* re, const float* im, float2* w) {
  const int lo = p.lo(), hi = p.hi(), step = p.tpc * p.A;
  if (kRowPoints * p.tpc == p.C) {
#pragma unroll
    for (int q = 0; q < kRowPoints / 2; ++q) w[q] = make_float2(__ldg(re + lo + q * step), __ldg(im + lo + q * step));
#pragma unroll
    for (int q = kRowPoints / 2; q < kRowPoints; ++q) {
      w[q] = make_float2(__ldg(re + hi - q * step), -__ldg(im + hi - q * step));
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < kRowPoints; ++q) {
    const int l = q * p.tpc + p.t;
    const bool low = 2 * l < p.C;
    const int e = low ? lo + q * step : hi - q * step;
    if (l < p.C) {
      const float y = __ldg(im + e);
      w[q] = make_float2(__ldg(re + e), low ? y : -y);
    }
  }
}

// The column passes on the registers w of thread (t, j): in place in the
// tile, or between its two buffers.
template <int SIGN, int SHAPE>
__device__ __forceinline__ void col_passes(const ColPlan& plan, float2* w, float2* smem, int ls, int L,
                                           const float2* __restrict__ pass_tw, int t, int tpc, int j) {
  if constexpr (SHAPE == kColInPlace) {
    run_col_passes_in_place<SIGN>(plan, w, TileBuf{smem, ls}, L, pass_tw, t, tpc, j);
  } else {
    run_col_passes<SIGN>(plan, w, TileBuf{smem, ls}, L, pass_tw, t, tpc, j);
  }
}

// K6. Input (B, L, M) (columns) or (B, M, L) (rows, ROWS_IN), output the
// same way (ROWS_OUT); TW multiplies by tw[l*M + m] before or after.
// Thread (t, j) loads points q*tpc + t (q < 16) of column j into
// registers, every load issued before the first is used, and stores the
// same points of the transform from registers. PACK (level 2 of the real
// composite, planes, L = C, M = A/2): the output (kPackedOut) or the input
// (kPackedIn) is the (B, C/2, A) ordered packed planes, grid column 0 in
// `lines` (kPackedOut: the (2B, C) DC then Nyquist line transforms;
// kPackedIn: the (B, C) column 0); `lines` is null for kUnpacked. The
// unpacked roles build both global views before the passes: built after
// them, as the packed forms build theirs, l1 and l1_rev on in-place
// tiles spill 1.3-2.7x the bytes (ptxas, sm_90a) and l1 runs 10% slower
// at 2^20 x 64 on an H100.
template <int SIGN, bool ROWS_IN, bool ROWS_OUT, int TW, int SHAPE, int PACK = kUnpacked>
__global__ void __launch_bounds__(col_threads<SHAPE>(), col_min_blocks<SHAPE>())
column_passes_kernel(const float* __restrict__ xre, const float* __restrict__ xim, float* __restrict__ yre,
                     float* __restrict__ yim, int stride, int L, int M, int ls, ColPlan plan,
                     const float2* __restrict__ pass_tw, const float2* __restrict__ tw,
                     const float2* __restrict__ lines) {
  extern __shared__ float2 smem[];
  const Tile tl = tile_of(M, ls);
  const int cols = min(M - tl.m0, 1 << ls);
  const size_t row = static_cast<size_t>(tl.b) * L * M;
  const bool il = stride == 2;
  if constexpr (PACK == kUnpacked) {
    const size_t in_at = (row + (ROWS_IN ? static_cast<size_t>(tl.m0) * L : tl.m0)) * stride;
    const size_t out_at = (row + (ROWS_OUT ? static_cast<size_t>(tl.m0) * L : tl.m0)) * stride;
    const Global<ROWS_IN, TW == kTwiddleBefore> in{const_cast<float*>(xre) + in_at,
                                                   const_cast<float*>(xim) + in_at, L, M, cols, il, tw + tl.m0};
    const Global<ROWS_OUT, TW == kTwiddleAfter> out{yre + out_at, yim + out_at, L, M, cols, il, tw + tl.m0};
    const int j = threadIdx.x & ((1 << ls) - 1);
    const int t = threadIdx.x >> ls;
    const int tpc = blockDim.x >> ls;
    float2 w[kRowPoints];
#pragma unroll
    for (int q = 0; q < kRowPoints; ++q) w[q] = q * tpc + t < L ? in(q * tpc + t, j) : make_float2(0.0f, 0.0f);
    col_passes<SIGN, SHAPE>(plan, w, smem, ls, L, pass_tw, t, tpc, j);
#pragma unroll
    for (int q = 0; q < kRowPoints; ++q) {
      if (q * tpc + t < L) out.put(q * tpc + t, j, w[q]);
    }
    return;
  }
  const int j = threadIdx.x & ((1 << ls) - 1);
  const int t = threadIdx.x >> ls;
  const int tpc = blockDim.x >> ls;
  float2 w[kRowPoints];
  if constexpr (PACK == kPackedIn) {
#pragma unroll
    for (int q = 0; q < kRowPoints; ++q) w[q] = make_float2(0.0f, 0.0f);
    const PackedColumn p{L, 2 * M, tl.m0 + j, t, tpc};
    if (p.k1 == 0) {
      const float2* col0 = lines + static_cast<size_t>(tl.b) * L;
#pragma unroll
      for (int q = 0; q < kRowPoints; ++q) {
        if (q * tpc + t < L) w[q] = __ldg(col0 + q * tpc + t);
      }
    } else if (j < cols) {
      load_packed(p, xre + row, xim + row, w);
    }
  } else {
    const size_t in_at = (row + (ROWS_IN ? static_cast<size_t>(tl.m0) * L : tl.m0)) * stride;
    const Global<ROWS_IN, TW == kTwiddleBefore> in{const_cast<float*>(xre) + in_at,
                                                   const_cast<float*>(xim) + in_at, L, M, cols, il, tw + tl.m0};
#pragma unroll
    for (int q = 0; q < kRowPoints; ++q) w[q] = q * tpc + t < L ? in(q * tpc + t, j) : make_float2(0.0f, 0.0f);
  }
  col_passes<SIGN, SHAPE>(plan, w, smem, ls, L, pass_tw, t, tpc, j);
  if constexpr (PACK == kPackedOut) {
    const PackedColumn p{L, 2 * M, tl.m0 + j, t, tpc};
    if (p.k1 == 0) {
      const int batch = gridDim.x / ((M + (1 << ls) - 1) >> ls);
      store_lines(p, yre + row, yim + row, lines + static_cast<size_t>(tl.b) * L,
                  lines + static_cast<size_t>(batch + tl.b) * L);
    } else if (j < cols) {
      store_packed(p, yre + row, yim + row, w);
    }
  } else {
    const size_t out_at = (row + (ROWS_OUT ? static_cast<size_t>(tl.m0) * L : tl.m0)) * stride;
    const Global<ROWS_OUT, TW == kTwiddleAfter> out{yre + out_at, yim + out_at, L, M, cols, il, tw + tl.m0};
#pragma unroll
    for (int q = 0; q < kRowPoints; ++q) {
      if (q * tpc + t < L) out.put(q * tpc + t, j, w[q]);
    }
  }
}

// K7a: x (B, A, C) -> packed planes (B, C, A/2). Thread (t, j) loads
// points h = q*tpc + t (q < 16) of column j, z_h = x[2h] + i x[2h+1], into
// registers, every load issued before the first is used; the forward
// passes of the H = A/2-point plan end in the tile, and the split
// (stockham.cuh split_bin, as K1's) reads bins k and H - k there. The
// tile's rows of H packed bins are contiguous in device memory, so the
// store mirrors K7b's load: consecutive threads on consecutive bins of
// the tile's cols*H, both planes written coalesced. Bin 0 holds DC in re
// and the Nyquist bin in im.
template <int SHAPE>
__global__ void __launch_bounds__(col_threads<SHAPE>(), col_min_blocks<SHAPE>())
rfft_col_passes_kernel(const float* __restrict__ x, float* __restrict__ yre, float* __restrict__ yim, int A, int C,
                       int ls, ColPlan plan, const float2* __restrict__ pass_tw,
                       const float2* __restrict__ split_tw) {
  extern __shared__ float2 smem[];
  const int H = A / 2;
  const Tile tl = tile_of(C, ls);
  const int cols = min(C - tl.m0, 1 << ls);
  const int j = threadIdx.x & ((1 << ls) - 1);
  const int t = threadIdx.x >> ls;
  const int tpc = blockDim.x >> ls;
  const RealColsIn in{x + static_cast<size_t>(tl.b) * A * C + tl.m0, C, cols};
  float2 w[kRowPoints];
#pragma unroll
  for (int q = 0; q < kRowPoints; ++q) w[q] = q * tpc + t < H ? in(q * tpc + t, j) : make_float2(0.0f, 0.0f);
  TileBuf z{smem, ls};
  if constexpr (SHAPE == kColInPlace) {
    run_col_passes_in_place<-1, true>(plan, w, z, H, pass_tw, t, tpc, j);
  } else {
    z = run_col_passes<-1, true>(plan, w, z, H, pass_tw, t, tpc, j);
  }
  const int pts = cols * H;
  const size_t out_at = (static_cast<size_t>(tl.b) * C + tl.m0) * H;
  // e / H == umulhi(e, magic) for e * H < 2^32 (e < 16 * H, H <= MAX_COL / 2).
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(H) + 1u;
  // Not unrolled: unrolled 16 (or 2) times, the in-place tile spilled 60 B
  // and ran 8% slower (PERF.md §6, K7a's development runs).
  for (int e = threadIdx.x; e < pts; e += blockDim.x) {
    const int jj = static_cast<int>(__umulhi(static_cast<unsigned>(e), magic));
    const int k = e - jj * H;
    float2 X;
    if (k == 0) {
      const float2 z0 = z(0, jj);
      X = make_float2(z0.x + z0.y, z0.x - z0.y);
    } else {
      X = split_bin(z(k, jj), z(H - k, jj), __ldg(split_tw + k));
    }
    yre[out_at + e] = X.x;
    yim[out_at + e] = X.y;
  }
}

// K7b: packed planes (B, C, A/2) -> x (B, A, C), unscaled: K2's merge and
// inverse transform (real_fft.cu) per column, stored down the columns. The
// tile's rows of packed bins are contiguous in device memory: the load
// reads them with consecutive threads on consecutive bins, every load
// issued before the first shared store, and leaves them in the tile for
// the first pass's merge.
template <int SHAPE>
__global__ void __launch_bounds__(col_threads<SHAPE>(), col_min_blocks<SHAPE>())
irfft_col_passes_kernel(const float* __restrict__ yre, const float* __restrict__ yim, float* __restrict__ x,
                        int A, int C, int ls, ColPlan plan, const float2* __restrict__ pass_tw,
                        const float2* __restrict__ split_tw) {
  extern __shared__ float2 smem[];
  const int H = A / 2;
  const Tile tl = tile_of(C, ls);
  const int cols = min(C - tl.m0, 1 << ls);
  const int pts = cols * H;
  const size_t in_at = (static_cast<size_t>(tl.b) * C + tl.m0) * H;
  const TileBuf tile{smem, ls};
  float2 w[kRowPoints];
#pragma unroll
  for (int c = 0; c < kRowPoints; ++c) {
    const int e = threadIdx.x + c * blockDim.x;
    w[c] = e < pts ? make_float2(__ldg(yre + in_at + e), __ldg(yim + in_at + e)) : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int c = 0; c < kRowPoints; ++c) {
    const int e = threadIdx.x + c * blockDim.x;
    const int jj = e / H;
    if (jj < (1 << ls)) tile.put(e - jj * H, jj, w[c]);
  }
  __syncthreads();
  // The merge (stockham.cuh merge_bin) into thread (t, j)'s points
  // i = q*tpc + t: Z[i] = merge(X[i], conj X[H-i], W_A^i), the DC slot
  // carrying the Nyquist bin X[H] in its imaginary part; then a barrier
  // before the passes write the tile.
  const int j = threadIdx.x & ((1 << ls) - 1);
  const int t = threadIdx.x >> ls;
  const int tpc = blockDim.x >> ls;
#pragma unroll
  for (int q = 0; q < kRowPoints; ++q) {
    const int i = q * tpc + t;
    if (i < H) {
      const float2 xi = tile(i, j);
      w[q] = i == 0 ? merge_bin(make_float2(xi.x, 0.0f), make_float2(xi.y, 0.0f), __ldg(split_tw))
                    : merge_bin(xi, cconj(tile(H - i, j)), __ldg(split_tw + i));
    }
  }
  __syncthreads();
  if constexpr (SHAPE == kColInPlace) {
    run_col_passes_in_place<1>(plan, w, tile, H, pass_tw, t, tpc, j);
  } else {
    run_col_passes<1>(plan, w, tile, H, pass_tw, t, tpc, j);
  }
  const RealCols out{x + static_cast<size_t>(tl.b) * A * C + tl.m0, C, cols};
#pragma unroll
  for (int q = 0; q < kRowPoints; ++q) {
    if (q * tpc + t < H) out.put(q * tpc + t, j, w[q]);
  }
}

// The column engine's kernels by role (hopper_composite_blocks_per_sm).
template <int SHAPE>
const void* col_kernel_of(int role) {
  switch (role) {
    case 0: return reinterpret_cast<const void*>(column_passes_kernel<-1, false, true, kNoTwiddle, SHAPE>);
    case 1: return reinterpret_cast<const void*>(column_passes_kernel<-1, false, false, kTwiddleBefore, SHAPE>);
    case 2: return reinterpret_cast<const void*>(column_passes_kernel<1, false, false, kTwiddleAfter, SHAPE>);
    case 3: return reinterpret_cast<const void*>(column_passes_kernel<1, true, false, kNoTwiddle, SHAPE>);
    case 4: return reinterpret_cast<const void*>(irfft_col_passes_kernel<SHAPE>);
    case 5: return reinterpret_cast<const void*>(rfft_col_passes_kernel<SHAPE>);
    case 6:
      return reinterpret_cast<const void*>(column_passes_kernel<-1, false, false, kTwiddleBefore, SHAPE, kPackedOut>);
    case 7:
      return reinterpret_cast<const void*>(column_passes_kernel<1, false, false, kTwiddleAfter, SHAPE, kPackedIn>);
    default: return nullptr;
  }
}

const void* col_kernel(int role, int shape) {
  return shape == kColNarrow ? col_kernel_of<kColNarrow>(role)
         : shape == kColWide ? col_kernel_of<kColWide>(role) : col_kernel_of<kColInPlace>(role);
}

// The checks every column-engine entry makes: the radices, the pass plan
// against them and L, then (when there is work) the geometry; *run is
// false when there is nothing to launch.
int check_col_launch(int L, int batch, int M, const int* radices, int nstages, const int* passes, int npasses,
                     int ls, int threads, int smem, int grid, ColPlan* plan, bool* run, int* shape) {
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  err = check_col_passes(passes, npasses, rad, L, plan);
  if (err) return err;
  *run = batch > 0 && M > 0;
  return *run ? check_col_geometry(*plan, L, batch, M, ls, threads, smem, grid, shape) : 0;
}

template <int SIGN, bool ROWS_IN, bool ROWS_OUT, int TW, int PACK = kUnpacked>
int launch_column(const float* xre, const float* xim, float* yre, float* yim, int stride, int batch, int L, int M,
                  const int* radices, int nstages, const int* passes, int npasses, const void* pass_tw,
                  const void* tw, int ls, int threads, int smem, int grid, void* stream,
                  const void* lines = nullptr) {
  if (L < 2 || L > kMaxCol || M < 0 || batch < 0 || (stride != 1 && stride != 2) ||
      (TW != kNoTwiddle && tw == nullptr) ||
      (PACK != kUnpacked && (lines == nullptr || stride != 1 || L % 2 || M < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  ColPlan plan;
  bool run;
  int shape;
  int err = check_col_launch(L, batch, M, radices, nstages, passes, npasses, ls, threads, smem, grid, &plan, &run,
                             &shape);
  if (err || !run) return err;
  auto kernel = shape == kColNarrow ? column_passes_kernel<SIGN, ROWS_IN, ROWS_OUT, TW, kColNarrow, PACK>
                : shape == kColWide ? column_passes_kernel<SIGN, ROWS_IN, ROWS_OUT, TW, kColWide, PACK>
                                    : column_passes_kernel<SIGN, ROWS_IN, ROWS_OUT, TW, kColInPlace, PACK>;
  err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, stride, L, M, ls, plan, static_cast<const float2*>(pass_tw), static_cast<const float2*>(tw),
      static_cast<const float2*>(lines));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hopper_composite_max_col() { return kMaxCol; }

// Blocks of a column-engine kernel resident on one SM at a launch
// geometry's shape (0 narrow, 1 wide, 2 in place), threads and shared
// bytes (role 0-3: K6 l1, l2, l2_rev, l1_rev; 4: K7b; 5: K7a; 6, 7: K6 l2,
// l2_rev on the real composite's packed planes); 0 if the query fails.
int hopper_composite_blocks_per_sm(int role, int shape, int threads, int smem) {
  const void* kernel = shape < kColNarrow || shape > kColInPlace ? nullptr : col_kernel(role, shape);
  int per_sm = 0;
  if (kernel == nullptr || threads < 1 || threads > kColMaxThreads ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem))
    return 0;
  return per_sm;
}

// K6 level 1, forward: (B, L, M) columns -> (B, M, L) rows. The arguments:
// x re/im, y re/im, element stride (1 planes, 2 complex64), batch, L, M,
// the length-L plan's radices, the pass plan (npasses (r0, r1) pairs,
// ops/col_passes.pass_plan) and its twiddle tables
// (ops/col_passes.device_twiddles), the four-step table (NULL at level 1),
// then the launch geometry (ops/col_passes.launch_geometry: lanes' shift,
// threads, shared bytes, grid), checked here. Returns a cudaError_t value;
// 0 means the launch was accepted.
int k6_l1(const float* xre, const float* xim, float* yre, float* yim, int stride, int batch, int L, int M,
          const int* radices, int nstages, const int* passes, int npasses, const void* pass_tw, const void* tw,
          int ls, int threads, int smem, int grid, void* stream) {
  return launch_column<-1, false, true, kNoTwiddle>(xre, xim, yre, yim, stride, batch, L, M, radices, nstages,
                                                    passes, npasses, pass_tw, tw, ls, threads, smem, grid, stream);
}

// K6 level 2, forward: twiddle, then column DFTs of (B, L, M), stored as columns.
int k6_l2(const float* xre, const float* xim, float* yre, float* yim, int stride, int batch, int L, int M,
          const int* radices, int nstages, const int* passes, int npasses, const void* pass_tw, const void* tw,
          int ls, int threads, int smem, int grid, void* stream) {
  return launch_column<-1, false, false, kTwiddleBefore>(xre, xim, yre, yim, stride, batch, L, M, radices, nstages,
                                                         passes, npasses, pass_tw, tw, ls, threads, smem, grid,
                                                         stream);
}

// K6 level 2, backward: inverse column DFTs of (B, L, M), then twiddle.
int k6_l2_rev(const float* xre, const float* xim, float* yre, float* yim, int stride, int batch, int L, int M,
              const int* radices, int nstages, const int* passes, int npasses, const void* pass_tw,
              const void* tw, int ls, int threads, int smem, int grid, void* stream) {
  return launch_column<1, false, false, kTwiddleAfter>(xre, xim, yre, yim, stride, batch, L, M, radices, nstages,
                                                       passes, npasses, pass_tw, tw, ls, threads, smem, grid, stream);
}

// K6 level 2 of the real composite, forward: twiddle, then column DFTs of
// the (B, L, M) planes x (L = C, M = A/2, even C), stored into y as the
// (B, C/2, A) ordered packed planes of the length-A*C real DFT; `lines` is
// the (2B, C) complex64 DC (rows < B) and Nyquist (rows >= B) line
// transforms, which give grid column 0's bins and X[N/2]. The other
// arguments are k6_l2's, with no element stride (planes only).
int k6_l2_packed(const float* xre, const float* xim, float* yre, float* yim, const void* lines, int batch, int L,
                 int M, const int* radices, int nstages, const int* passes, int npasses, const void* pass_tw,
                 const void* tw, int ls, int threads, int smem, int grid, void* stream) {
  return launch_column<-1, false, false, kTwiddleBefore, kPackedOut>(xre, xim, yre, yim, 1, batch, L, M, radices,
                                                                     nstages, passes, npasses, pass_tw, tw, ls,
                                                                     threads, smem, grid, stream, lines);
}

// K6 level 2 of the real composite, backward: the (B, L, M) grid gathered
// from the (B, C/2, A) ordered packed planes x (L = C, M = A/2), its
// column 0 from `lines`, the (B, C) complex64 column; then inverse column
// DFTs and the twiddle, stored into the (B, L, M) planes y.
int k6_l2_rev_packed(const float* xre, const float* xim, float* yre, float* yim, const void* lines, int batch,
                     int L, int M, const int* radices, int nstages, const int* passes, int npasses,
                     const void* pass_tw, const void* tw, int ls, int threads, int smem, int grid, void* stream) {
  return launch_column<1, false, false, kTwiddleAfter, kPackedIn>(xre, xim, yre, yim, 1, batch, L, M, radices,
                                                                  nstages, passes, npasses, pass_tw, tw, ls, threads,
                                                                  smem, grid, stream, lines);
}

// K6 level 1, backward: (B, M, L) rows -> inverse DFTs -> (B, L, M) columns.
int k6_l1_rev(const float* xre, const float* xim, float* yre, float* yim, int stride, int batch, int L, int M,
              const int* radices, int nstages, const int* passes, int npasses, const void* pass_tw,
              const void* tw, int ls, int threads, int smem, int grid, void* stream) {
  return launch_column<1, true, false, kNoTwiddle>(xre, xim, yre, yim, stride, batch, L, M, radices, nstages,
                                                   passes, npasses, pass_tw, tw, ls, threads, smem, grid, stream);
}

// K7a. radices, the pass plan and its tables, and split_tw are the
// length-A real plan's (its A/2-point complex transform); then the launch
// geometry over the C columns, as K6's.
int k7a_rfft_cols(const float* x, float* yre, float* yim, int batch, int A, int C, const int* radices, int nstages,
                  const int* passes, int npasses, const void* pass_tw, const void* split_tw, int ls, int threads,
                  int smem, int grid, void* stream) {
  if (A < 4 || A > kMaxCol || A % 2 || C < 0 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  ColPlan plan;
  bool run;
  int shape;
  int err = check_col_launch(A / 2, batch, C, radices, nstages, passes, npasses, ls, threads, smem, grid, &plan, &run,
                             &shape);
  if (err || !run) return err;
  auto kernel = shape == kColNarrow ? rfft_col_passes_kernel<kColNarrow>
                : shape == kColWide ? rfft_col_passes_kernel<kColWide> : rfft_col_passes_kernel<kColInPlace>;
  err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, yre, yim, A, C, ls, plan, static_cast<const float2*>(pass_tw), static_cast<const float2*>(split_tw));
  return static_cast<int>(cudaGetLastError());
}

// K7b. radices, the pass plan and its tables, and split_tw are the
// length-A real plan's (its A/2-point complex transform); then the launch
// geometry over the C columns, as K6's.
int k7b_irfft_cols(const float* yre, const float* yim, float* x, int batch, int A, int C, const int* radices,
                   int nstages, const int* passes, int npasses, const void* pass_tw, const void* split_tw, int ls,
                   int threads, int smem, int grid, void* stream) {
  if (A < 4 || A > kMaxCol || A % 2 || C < 0 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  ColPlan plan;
  bool run;
  int shape;
  int err = check_col_launch(A / 2, batch, C, radices, nstages, passes, npasses, ls, threads, smem, grid, &plan, &run,
                             &shape);
  if (err || !run) return err;
  auto kernel = shape == kColNarrow ? irfft_col_passes_kernel<kColNarrow>
                : shape == kColWide ? irfft_col_passes_kernel<kColWide> : irfft_col_passes_kernel<kColInPlace>;
  err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      yre, yim, x, A, C, ls, plan, static_cast<const float2*>(pass_tw), static_cast<const float2*>(split_tw));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
