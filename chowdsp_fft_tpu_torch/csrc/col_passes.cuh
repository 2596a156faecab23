// Register-resident column engine for Hopper (sm_90a): the mixed-radix FFT
// of each column of a tile of 2^ls adjacent columns of L complex points,
// shared by K6 (the two-level composite's column FFT in its four roles),
// K7a and K7b (the real composite's column-blocked level 1 and its
// inverse), composite_fft.cu.
//
// Replaces, for those kernels, the column stages of
// chowdsp_fft_tpu/ops/pallas_fft.py: _cfft_v2_l1_kernel :2531,
// _cfft_v2_l2_kernel :2556, _cfft_v2_l2_rev_kernel :2587,
// _cfft_v2_l1_rev_kernel :2621, _rfft_cols_kernel :1398 and
// _irfft_cols_kernel :1541.
//
// What bounds it on the card: bytes, 16 B a complex point per level (8 in,
// 8 out), 8 B a real sample. What held the stage engine it replaces far
// from that: one tile of 135 KB (two ping-pong buffers) a block, so one
// block an SM, whose load, five barrier-separated radix-4 stages and store
// ran in series with nothing to overlap them; scalar loads in a grid-stride
// loop, each followed by a shared store; 32-byte column segments.
//
// Design:
//   * a thread owns 16 points of one column, q*tpc + t for q < 16
//     (tpc = ceil(L/16) threads a column), consecutive threads on
//     consecutive columns, so a warp reads and writes whole row segments
//     of the tile on the column side and runs of a row on the row side;
//   * the kernels load those points from device memory straight into
//     registers, every load issued before the first is used, and store
//     them from registers;
//   * passes are the plan's stages, consecutive pairs fused up to 20 points
//     a butterfly (ops/col_passes.pass_plan; (5,5) stays two passes), each
//     a Stockham stage of radix P = R0*R1 (row_passes.cuh's pass_dft). Where
//     16 | L the first pass (4,4) runs on the loaded registers (thread t's
//     butterfly is its own points) and a last pass with P | 16 leaves its
//     outputs in the registers the stores read; otherwise the points go
//     through the tile. K7a's split reads bins k and L - k, which no
//     thread holds together, so its last pass always ends in the tile
//     (TO_TILE);
//   * two shapes of exchange. Two buffers: each pass between takes one
//     butterfly at a time from one buffer to the other (P points live), one
//     barrier a pass; tiles of at most 4096 points and 256 threads (67.6 KB,
//     80 registers: three blocks an SM), or 8192 points and 512 threads
//     (135 KB, one block an SM) where a narrow tile's columns would move
//     less than a 32-byte sector a row and plane. In place, for plans whose
//     passes between the first and the last are all (4,4) (every power of
//     two from 32): one buffer, each thread's one butterfly held in registers across
//     the barrier between the pass's reads and writes; 8192 points, 512
//     threads and 64 registers (ptxas spills 36-60 B a kernel there), two
//     blocks an SM, twice the columns of a narrow tile. The wrappers pick
//     the shape by role
//     (ops/hopper_composite.in_place_role, measured);
//   * twiddles: bin j = j1*R0 + j0 of a pass takes W^(j*p*s) as rows j0
//     and j1*R0 of the pass table ([row*m + p], built in float64, rounded
//     once) multiplied: R0 + R1 - 2 loads a butterfly instead of P - 1.
// Tried on the H100 and left out (development runs, PERF.md): every pass
// kind in place (a thread's ceil(16/P) butterflies held across the
// barrier): with the 12 kinds in one kernel ptxas emitted 8-24 KB of spill
// code at 64 or 128 registers and the kernels ran 2-5x slower than the
// stage engine. In-place tiles of 16384 points (1024 threads) were no
// faster than 8192. An
// L2 prefetch of the next tile (cp.async.bulk.prefetch) and tiles ordered
// batch row fastest did not help overall.
// The launch geometry (pass plan, tile, threads, shared bytes, grid) is
// computed in Python (ops/col_passes.launch_geometry) and checked again by
// check_col_passes and check_col_geometry.

#pragma once

#include "row_passes.cuh"

namespace {

constexpr int kColMaxLanes = 16;  // ops/col_passes.MAX_LANES
// Threads a block: narrow tiles (ops/col_passes.TILE_POINTS) take at most
// 256 and keep three blocks an SM (80 registers a thread); wide and
// in-place tiles (WIDE_TILE_POINTS, IN_PLACE_TILE_POINTS) at most 512
// (ops/col_passes.MAX_THREADS), one or two blocks an SM.
constexpr int kColNarrowThreads = 256;
constexpr int kColMaxThreads = 512;
// The kernels' three shapes: narrow and wide tiles between two buffers,
// and in-place tiles (one buffer, 512 threads, two blocks an SM at 64
// registers) for plans whose passes between the first and the last are
// all (4,4) (ops/col_passes.in_place_plan).
enum { kColNarrow = 0, kColWide = 1, kColInPlace = 2 };
template <int SHAPE>
constexpr int col_threads() { return SHAPE == kColNarrow ? kColNarrowThreads : kColMaxThreads; }
template <int SHAPE>
constexpr int col_min_blocks() { return SHAPE == kColNarrow ? 3 : SHAPE == kColWide ? 1 : 2; }

// A tile buffer in shared memory: point i of column j at slot((i << ls) + j).
struct TileBuf {
  float2* buf;
  int ls;
  __device__ __forceinline__ float2 operator()(int i, int j) const { return buf[slot((i << ls) + j)]; }
  __device__ __forceinline__ void put(int i, int j, float2 v) const { buf[slot((i << ls) + j)] = v; }
};

// A tile's complex points in device memory, from its first column: (B, L,
// M) columns (point i of column j at i*M + j) or, with ROWS, (B, M, L) rows
// (at j*L + i); two float planes, or interleaved complex64 (im one float
// after re). TWIDDLE multiplies point i of column j by the four-step table
// tw[i*M + j] as it is read (an input) or before it is stored (an output).
// Columns j >= cols (a ragged last tile) read as zero and are not stored.
template <bool ROWS, bool TWIDDLE>
struct Global {
  float* re;
  float* im;
  int L, M, cols;
  bool interleaved;
  const float2* tw;
  __device__ __forceinline__ int at(int i, int j) const { return ROWS ? j * L + i : i * M + j; }
  __device__ __forceinline__ float2 operator()(int i, int j) const {
    if (j >= cols) return make_float2(0.0f, 0.0f);
    const int e = at(i, j);
    float2 v = interleaved ? __ldg(reinterpret_cast<const float2*>(re) + e) : make_float2(__ldg(re + e), __ldg(im + e));
    if (TWIDDLE) v = cmul(v, __ldg(tw + i * M + j));
    return v;
  }
  __device__ __forceinline__ void put(int i, int j, float2 v) const {
    if (j >= cols) return;
    const int e = at(i, j);
    if (TWIDDLE) v = cmul(v, __ldg(tw + i * M + j));
    if (interleaved) {
      reinterpret_cast<float2*>(re)[e] = v;
    } else {
      re[e] = v.x;
      im[e] = v.y;
    }
  }
};

// K7a's first loads: point h = x[2h] + i x[2h+1] of column j, from rows
// 2h and 2h + 1 of the (A, C) real tile; columns j >= cols (a ragged last
// tile) read as zero.
struct RealColsIn {
  const float* x;
  int C, cols;
  __device__ __forceinline__ float2 operator()(int h, int j) const {
    if (j >= cols) return make_float2(0.0f, 0.0f);
    return make_float2(__ldg(x + (2 * h) * C + j), __ldg(x + (2 * h + 1) * C + j));
  }
};

// K7b's last stores: point h = H (x[2h] + i x[2h+1]) of column j, times 2
// (A x = 2 H x), at rows 2h and 2h + 1 of the (A, C) real tile.
struct RealCols {
  float* x;
  int C, cols;
  __device__ __forceinline__ void put(int h, int j, float2 v) const {
    if (j >= cols) return;
    x[(2 * h) * C + j] = 2.0f * v.x;
    x[(2 * h + 1) * C + j] = 2.0f * v.y;
  }
};

// A pass plan: pass i's kind, r0*10 + r1 (r1 = 1: one stage), in bits
// [6i, 6i + 6) of `codes` (scalars, so a kernel reads its plan without a
// copy to local memory).
struct ColPlan {
  unsigned long long codes;
  int count;
  __device__ __forceinline__ int kind(int i) const { return static_cast<int>((codes >> (6 * i)) & 63); }
};
constexpr int kColMaxPasses = 10;

// Multiplies register i of a pass's DFT output (bin j = j1*R0 + j0,
// natural_bin) by W_L^(j*p*s) = W^(j0*p*s) * W^(j1*R0*p*s): rows j0 and
// j1*R0 of the pass table (row r at col[r*m]), R0 + R1 - 2 loads and a
// product of two table entries where neither factor is 1; conjugated for
// SIGN = +1.
template <int R0, int R1, int SIGN>
__device__ __forceinline__ void pass_twiddle(float2* v, const float2* __restrict__ col, int m) {
  float2 a[R0], b[R1];
#pragma unroll
  for (int j0 = 1; j0 < R0; ++j0) {
    a[j0] = __ldg(col + j0 * m);
    if (SIGN > 0) a[j0] = cconj(a[j0]);
  }
#pragma unroll
  for (int j1 = 1; j1 < R1; ++j1) {
    b[j1] = __ldg(col + j1 * R0 * m);
    if (SIGN > 0) b[j1] = cconj(b[j1]);
  }
#pragma unroll
  for (int i = 1; i < R0 * R1; ++i) {
    const int j0 = i / R1, j1 = i % R1;
    const float2 w = j1 == 0 ? a[j0] : (j0 == 0 ? b[j1] : cmul(a[j0], b[j1]));
    v[i] = cmul(v[i], w);
  }
}

// One pass of radix P = R0*R1 at stride s over the tile's columns of L
// points, from `src` to `dst` (the two tile buffers): thread (t, j) takes
// butterflies u = t + c*tpc < L/P of column j one at a time (read, DFT,
// twiddle, write: P points live), then the block waits.
template <int R0, int R1, int SIGN>
__device__ __forceinline__ void shared_pass(const TileBuf& src, const TileBuf& dst, int L, int s,
                                            const float2* __restrict__ tw, int t, int tpc, int j) {
  constexpr int P = R0 * R1;
  constexpr int C = (kRowPoints + P - 1) / P;
  const int nb = L / P;
  const int m = nb / s;
  // floor(u / s) == umulhi(u, magic) for u * s < 2^32 (u < L/P, s < L <= MAX_COL).
  const unsigned magic = s == 1 ? 0u : 0xFFFFFFFFu / static_cast<unsigned>(s) + 1u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int u = t + c * tpc;
    if (u < nb) {
      float2 v[P];
#pragma unroll
      for (int k = 0; k < P; ++k) v[k] = src(k * nb + u, j);
      pass_dft<R0, R1, SIGN>(v);
      const int p = s == 1 ? u : static_cast<int>(__umulhi(static_cast<unsigned>(u), magic));
      if (p != 0) pass_twiddle<R0, R1, SIGN>(v, tw + p, m);
      const int base = p * P * s + (u - p * s);
#pragma unroll
      for (int i = 0; i < P; ++i) dst.put(base + natural_bin<R0, R1>(i) * s, j, v[i]);
    }
  }
  __syncthreads();
}

// A (4,4) pass in place in one buffer: thread (t, j)'s one butterfly is
// read, transformed and twiddled, the block waits, it is written back, the
// block waits again.
template <int SIGN>
__device__ __forceinline__ void inplace_pass44(const TileBuf& tile, int L, int s, const float2* __restrict__ tw,
                                               int t, int j) {
  const int nb = L / 16;
  const int m = nb / s;
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(s) + 1u;  // s >= 16 here
  float2 v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = tile(k * nb + t, j);
  pass_dft<4, 4, SIGN>(v);
  const int p = static_cast<int>(__umulhi(static_cast<unsigned>(t), magic));
  if (p != 0) pass_twiddle<4, 4, SIGN>(v, tw + p, m);
  const int base = p * 16 * s + (t - p * s);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 16; ++i) tile.put(base + natural_bin<4, 4>(i) * s, j, v[i]);
  __syncthreads();
}

template <int SIGN>
__device__ __forceinline__ void dispatch_shared(int kind, const TileBuf& src, const TileBuf& dst, int L, int s,
                                                const float2* __restrict__ tw, int t, int tpc, int j) {
  switch (kind) {
    case 44: shared_pass<4, 4, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    case 42: shared_pass<4, 2, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    case 43: shared_pass<4, 3, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    case 45: shared_pass<4, 5, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    case 23: shared_pass<2, 3, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    case 25: shared_pass<2, 5, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    case 33: shared_pass<3, 3, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    case 35: shared_pass<3, 5, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    case 41: shared_pass<4, 1, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    case 21: shared_pass<2, 1, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    case 31: shared_pass<3, 1, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
    default: shared_pass<5, 1, SIGN>(src, dst, L, s, tw, t, tpc, j); break;
  }
}

// The first pass straight from registers, where L % 16 == 0 (so the plan
// opens with a (4,4) pass and the butterfly of thread t is points
// k*L/16 + t: w[k]), written to the tile; then a barrier.
template <int SIGN>
__device__ __forceinline__ void first_pass_from_registers(float2* w, const TileBuf& tile, int L,
                                                          const float2* __restrict__ tw, int t, int j) {
  pass_dft<4, 4, SIGN>(w);
  if (t != 0) pass_twiddle<4, 4, SIGN>(w, tw + t, L / 16);
#pragma unroll
  for (int i = 0; i < 16; ++i) tile.put(t * 16 + natural_bin<4, 4>(i), j, w[i]);
  __syncthreads();
}

// The last pass into registers, where L % 16 == 0 and P divides 16: at
// s = L/P (m = 1: no twiddle) butterfly u = t + c*tpc writes points
// j*L/P + u = (j*C + c)*tpc + t, so register w[j*C + c] holds point
// q*tpc + t, as the loads had them.
template <int R0, int R1, int SIGN>
__device__ __forceinline__ void last_pass_to_registers(float2* w, const TileBuf& tile, int L, int t, int tpc, int j) {
  constexpr int P = R0 * R1;
  constexpr int C = kRowPoints / P;
  const int nb = L / P;
  float2 v[C][P];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < P; ++k) v[c][k] = tile(k * nb + t + c * tpc, j);
    pass_dft<R0, R1, SIGN>(v[c]);
#pragma unroll
    for (int i = 0; i < P; ++i) w[natural_bin<R0, R1>(i) * C + c] = v[c][i];
  }
}

// Whether the last pass (kind) can end in registers: P divides 16.
__device__ __forceinline__ bool ends_in_registers(int kind) {
  return kind == 44 || kind == 42 || kind == 41 || kind == 21;
}

template <int SIGN>
__device__ __forceinline__ void last_pass_dispatch(int kind, float2* w, const TileBuf& tile, int L, int t, int tpc,
                                                   int j) {
  switch (kind) {
    case 44: last_pass_to_registers<4, 4, SIGN>(w, tile, L, t, tpc, j); break;
    case 42: last_pass_to_registers<4, 2, SIGN>(w, tile, L, t, tpc, j); break;
    case 41: last_pass_to_registers<4, 1, SIGN>(w, tile, L, t, tpc, j); break;
    default: last_pass_to_registers<2, 1, SIGN>(w, tile, L, t, tpc, j); break;
  }
}

// In place (one buffer; the plan checked by check_col_geometry): the first
// pass from w, the (4,4) passes between in place, the last into w. With
// TO_TILE (K7a) w is then written back to the buffer between two barriers,
// so the buffer ends holding the transform.
template <int SIGN, bool TO_TILE = false>
__device__ __forceinline__ void run_col_passes_in_place(const ColPlan& plan, float2* w, const TileBuf& a, int L,
                                                        const float2* __restrict__ tw, int t, int tpc, int j) {
  first_pass_from_registers<SIGN>(w, a, L, tw, t, j);
  tw += L;
  int s = 16;
  const int last = plan.count - 1;
  for (int i = 1; i < last; ++i) {
    inplace_pass44<SIGN>(a, L, s, tw, t, j);
    tw += L / s;
    s *= 16;
  }
  last_pass_dispatch<SIGN>(plan.kind(last), w, a, L, t, tpc, j);
  if constexpr (TO_TILE) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRowPoints; ++q) {
      if (q * tpc + t < L) a.put(q * tpc + t, j, w[q]);
    }
    __syncthreads();
  }
}

// The plan on the tile whose points q*tpc + t (q < 16) of column j thread
// (t, j) holds in w, with the tile buffers a and the one after it: the
// first pass from w (16 | L) or from a after w is written there, the
// passes between from one buffer to the other, the last into w (16 | L and
// P | 16) or into a buffer that w is read back from. `w` ends holding the
// same points of the transform.
// With TO_TILE (K7a) the last pass always writes a buffer and w is left
// as it was: the returned buffer holds the transform, the block past the
// last pass's barrier.
template <int SIGN, bool TO_TILE = false>
__device__ __forceinline__ TileBuf run_col_passes(const ColPlan& plan, float2* w, TileBuf a, int L,
                                                  const float2* __restrict__ tw, int t, int tpc, int j) {
  TileBuf b{a.buf + padded(L << a.ls), a.ls};
  const int last = plan.count - 1;
  const bool direct = L % kRowPoints == 0 && last > 0;
  int s;
  if (direct) {
    first_pass_from_registers<SIGN>(w, a, L, tw, t, j);
    s = 16;
  } else {
#pragma unroll
    for (int q = 0; q < kRowPoints; ++q) {
      if (q * tpc + t < L) a.put(q * tpc + t, j, w[q]);
    }
    __syncthreads();
    const int k0 = plan.kind(0);
    dispatch_shared<SIGN>(k0, a, b, L, 1, tw, t, tpc, j);
    const TileBuf x = a;
    a = b;
    b = x;
    s = (k0 / 10) * (k0 % 10);
  }
  if (last == 0) {
    if constexpr (!TO_TILE) {
#pragma unroll
      for (int q = 0; q < kRowPoints; ++q) w[q] = q * tpc + t < L ? a(q * tpc + t, j) : make_float2(0.0f, 0.0f);
    }
    return a;
  }
  tw += L;  // pass i's table holds P*m = L/s entries
  for (int i = 1; i < last; ++i) {
    const int k = plan.kind(i);
    dispatch_shared<SIGN>(k, a, b, L, s, tw, t, tpc, j);
    const TileBuf x = a;
    a = b;
    b = x;
    tw += L / s;
    s *= (k / 10) * (k % 10);
  }
  const int kl = plan.kind(last);
  if (!TO_TILE && direct && ends_in_registers(kl)) {
    last_pass_dispatch<SIGN>(kl, w, a, L, t, tpc, j);
    return a;
  }
  dispatch_shared<SIGN>(kl, a, b, L, s, tw, t, tpc, j);
  if constexpr (!TO_TILE) {
#pragma unroll
    for (int q = 0; q < kRowPoints; ++q) w[q] = q * tpc + t < L ? b(q * tpc + t, j) : make_float2(0.0f, 0.0f);
  }
  return b;
}

// Host: refuse a pass plan that is not the plan's stages in order, fused
// in pairs of the kinds dispatch_col knows or one a pass, or that does not
// multiply out to L. Returns a cudaError_t value.
int check_col_passes(const int* passes, int npasses, const Radices& rad, int L, ColPlan* out) {
  if (npasses < 1 || npasses > kColMaxPasses) return static_cast<int>(cudaErrorInvalidValue);
  int stage = 0, prod = 1;
  out->count = npasses;
  out->codes = 0;
  for (int i = 0; i < npasses; ++i) {
    const int r0 = passes[2 * i], r1 = passes[2 * i + 1];
    const int code = r0 * 10 + r1;
    const bool known = code == 44 || code == 42 || code == 43 || code == 45 || code == 23 || code == 25 ||
                       code == 33 || code == 35 || code == 41 || code == 21 || code == 31 || code == 51;
    if (!known || stage >= rad.count || rad.r[stage] != r0) return static_cast<int>(cudaErrorInvalidValue);
    ++stage;
    if (r1 != 1) {
      if (stage >= rad.count || rad.r[stage] != r1) return static_cast<int>(cudaErrorInvalidValue);
      ++stage;
    }
    out->codes |= static_cast<unsigned long long>(code) << (6 * i);
    prod *= r0 * r1;
  }
  if (stage != rad.count || prod != L) return static_cast<int>(cudaErrorInvalidValue);
  // run_col_passes starts from registers with a (4,4) pass where 16 | L.
  if (L % kRowPoints == 0 && npasses > 1 && (out->codes & 63) != 44) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Host: whether a plan runs in place (one tile buffer): 16 | L, at least two
// passes, (4,4) between the first and the last, and a last pass of P | 16.
bool col_in_place_plan(const ColPlan& plan, int L) {
  if (L % kRowPoints || plan.count < 2) return false;
  for (int i = 1; i + 1 < plan.count; ++i) {
    if (((plan.codes >> (6 * i)) & 63) != 44) return false;
  }
  const int kl = static_cast<int>((plan.codes >> (6 * (plan.count - 1))) & 63);
  return kl == 44 || kl == 42 || kl == 41 || kl == 21;
}

// Host: refuse a geometry that does not cover `batch` rows of M columns of
// L points in tiles of 2^ls columns, ceil(L/16) threads a column and one
// padded tile buffer, or does not fit a block.
// The shape (kColNarrow, kColWide, kColInPlace) follows from the shared
// bytes and threads: one buffer runs in place, which the plan must allow.
int check_col_geometry(const ColPlan& plan, int L, int batch, int M, int ls, int threads, int smem, int grid,
                       int* shape) {
  if (ls < 0 || (1 << ls) > kColMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  const int tpc = (L + kRowPoints - 1) / kRowPoints;
  const long long blocks = static_cast<long long>(batch) * ((M + (1 << ls) - 1) >> ls);
  const int buffer = padded(L << ls) * static_cast<int>(sizeof(float2));
  const bool in_place = smem == buffer;
  if (threads != (tpc << ls) || threads > kColMaxThreads || (smem != 2 * buffer && !in_place) ||
      (in_place && !col_in_place_plan(plan, L)) || smem > kMaxSmemBytes || blocks != grid)
    return static_cast<int>(cudaErrorInvalidValue);
  *shape = in_place ? kColInPlace : threads <= kColNarrowThreads ? kColNarrow : kColWide;
  return 0;
}

}  // namespace
