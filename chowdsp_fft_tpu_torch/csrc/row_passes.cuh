// Register-resident complex row engine for Hopper (sm_90a): the
// mixed-radix FFT of one row of L complex points, shared by K1 (L = N/2,
// then the real split), K2/K3 (L = N/2 backward, the real merge before
// it) and K4 (L = N), in their grid forms (real_fft.cu, complex_fft.cu)
// and their pipelined forms (pipelined_fft.cu).
//
// Replaces, for those kernels, the TPU row engine of
// chowdsp_fft_tpu/ops/pallas_fft.py: _rfft_kernel :1078 (K1, and K1-db's
// _rfft_db_kernel :1628), _irfft_kernel :1111 via _irfft_core :1155 (K2,
// and K2-db's _irfft_db_kernel :1756), _irfft_conv_kernel :1989 (K3) and
// _fft_kernel :620 via _stockham_rows (K4, and K4-db's _cfft_db_kernel
// :739). K5 keeps stockham.cuh's stage/run_stages; K6, K7a and K7b run
// the column engine (col_passes.cuh).
//
// What bounds it on the card: bytes. A complex row moves 16 B per point
// (8 in, 8 out), a real row 8 B per sample; 5 L log2 L flops per row are
// far below the H100's FP32 flop/byte balance. What held the earlier
// engine (stockham.cuh run_stages: one radix-4 butterfly per thread per
// stage, two ping-pong buffers and a block barrier per stage) far from
// that bound was the work between the bytes: a shared-memory round trip,
// a barrier and a runtime division per stage and point, and few rows in
// flight per SM (M/4 threads and two buffers per row).
//
// Design:
//   * passes: the plan's stages are fused in consecutive pairs (Python's
//     ops/row_passes.pass_plan; e.g. 4096 = 16*16*16, 2048 = 16*16*8). A
//     pass is a Stockham stage of radix P = R0*R1: butterfly u reads
//     x[k*(L/P) + u], runs the P-point DFT in registers (the R0- then the
//     R1-point stage, index arithmetic fixed at compile time by the
//     template, inner twiddles float32 constants), multiplies output j by
//     W_L^(j*p*s) from the pass's table (p = u / s by a multiply-high with a magic number
//     computed once per pass) and writes x[p*P*s + j*s + q];
//   * a thread owns kRowPoints = 16 points of a row (L/16 threads per
//     row), ceil(16/P) butterflies of each pass, one at a time: read, DFT,
//     twiddle, write, so P points are live. Passes ping-pong between two
//     padded shared buffers with one barrier each. At N=4096 K4 runs 3
//     passes (3 barriers) where the stage engine ran 6 stages (7 with the
//     load);
//   * the first pass reads the row straight from device memory (or from a
//     pipelined form's landing buffer), 256 contiguous bytes per warp
//     instruction (interleaved complex64 as float2, planes as floats);
//     K2/K3's first pass reads the packed bins their first exchange left
//     in natural order, merged on the way (MergeIn: bins k and M-k and
//     the split twiddle, Nyquist in slot 0's im), so the merge costs no
//     exchange and no barrier of its own;
//   * the last pass leaves the natural-order row in shared memory, and the
//     epilogue's reads of that exchange do each kernel's own work: K1's
//     split (needs Z[k] and Z[M-k]) and unordered gather with float4
//     stores of both planes, K4's gather (forward unordered) and float4
//     stores of complex64 pairs. K4's backward unordered scatter is the
//     first exchange (coalesced loads, scattered shared stores), as is
//     K2/K3's unordered scatter. K2/K3's last pass writes the real samples
//     from registers (run_passes_to: there p = 0, so consecutive threads
//     write consecutive points);
//   * 16 points a thread let small rows share a block: rows_per_block
//     rows (at least 128 threads), each in its own two buffers; a block's
//     ragged rows recompute its last row and store nothing;
//   * twiddles come from float32 tables built in float64 on the host
//     (ops/row_passes.pass_twiddles): pass i's W_L^(j*p*s) at [j*m + p],
//     so a warp reads consecutive or equal entries (a table indexed by
//     the exponent j*p*s made a warp's first-pass twiddle loads touch up
//     to 32 cache lines each); each point's twiddle is read once per
//     pass; no sinf/cosf, no repeated powers, FP32 FMA only. K1's
//     unordered epilogue reads its split twiddles from a table gathered
//     into the unordered layout, in position order.
// Tried on the H100 and left out: one buffer exchanged in place (all of a
// thread's butterflies held in registers across a barrier between the
// pass's reads and its writes). With the 13 pass kinds in one kernel,
// ptxas spilled heavily, whether the kinds were inlined or functions of
// their own, and the kernels ran slower than the stage engine.
// The launch geometry (pass plan, rows per block, threads, shared bytes,
// grid) is computed in Python (ops/row_passes.launch_geometry) and checked
// again by check_row_geometry.

#pragma once

#include "stockham.cuh"

namespace {

constexpr int kRowPoints = 16;  // points a thread owns (ops/row_passes.POINTS_PER_THREAD)
constexpr int kMaxPasses = 16;

// A pass plan: pass i fuses the plan stages r0[i] and r1[i] (r1 = 1: one stage).
struct Passes {
  int count;
  int r0[kMaxPasses];
  int r1[kMaxPasses];
};

// cos, sin of 2*pi*e/P for the fused radices: the float64 values rounded
// to float32, with the exact zeros written as zeros.
#define CHOWDSP_ROOTS(P, ...)                                                      \
  if constexpr (Q == P) {                                                          \
    const float v[2 * P] = {__VA_ARGS__};                                          \
    return make_float2(v[e], static_cast<float>(SIGN) * v[P + e]);                 \
  }

// W = exp(SIGN * 2i*pi*e/Q) for 0 <= e < Q; e is a compile-time index
// after unrolling, so the array reads fold into constants.
template <int Q, int SIGN>
__device__ __forceinline__ float2 inner_root(int e) {
  CHOWDSP_ROOTS(6, 1.0f, 0.5f, -0.5f, -1.0f, -0.5f, 0.5f,
                0.0f, 0.8660254f, 0.8660254f, 0.0f, -0.8660254f, -0.8660254f)
  CHOWDSP_ROOTS(8, 1.0f, 0.70710677f, 0.0f, -0.70710677f, -1.0f, -0.70710677f, 0.0f, 0.70710677f,
                0.0f, 0.70710677f, 1.0f, 0.70710677f, 0.0f, -0.70710677f, -1.0f, -0.70710677f)
  CHOWDSP_ROOTS(9, 1.0f, 0.76604444f, 0.17364818f, -0.5f, -0.9396926f, -0.9396926f, -0.5f, 0.17364818f,
                0.76604444f,
                0.0f, 0.64278764f, 0.9848077f, 0.8660254f, 0.34202015f, -0.34202015f, -0.8660254f,
                -0.9848077f, -0.64278764f)
  CHOWDSP_ROOTS(10, 1.0f, 0.809017f, 0.309017f, -0.309017f, -0.809017f, -1.0f, -0.809017f, -0.309017f,
                0.309017f, 0.809017f,
                0.0f, 0.58778524f, 0.95105654f, 0.95105654f, 0.58778524f, 0.0f, -0.58778524f, -0.95105654f,
                -0.95105654f, -0.58778524f)
  CHOWDSP_ROOTS(12, 1.0f, 0.8660254f, 0.5f, 0.0f, -0.5f, -0.8660254f, -1.0f, -0.8660254f, -0.5f, 0.0f, 0.5f,
                0.8660254f,
                0.0f, 0.5f, 0.8660254f, 1.0f, 0.8660254f, 0.5f, 0.0f, -0.5f, -0.8660254f, -1.0f, -0.8660254f,
                -0.5f)
  CHOWDSP_ROOTS(15, 1.0f, 0.9135454f, 0.6691306f, 0.309017f, -0.104528464f, -0.5f, -0.809017f, -0.9781476f,
                -0.9781476f, -0.809017f, -0.5f, -0.104528464f, 0.309017f, 0.6691306f, 0.9135454f,
                0.0f, 0.40673664f, 0.7431448f, 0.95105654f, 0.9945219f, 0.8660254f, 0.58778524f, 0.20791169f,
                -0.20791169f, -0.58778524f, -0.8660254f, -0.9945219f, -0.95105654f, -0.7431448f, -0.40673664f)
  CHOWDSP_ROOTS(16, 1.0f, 0.9238795f, 0.70710677f, 0.38268343f, 0.0f, -0.38268343f, -0.70710677f, -0.9238795f,
                -1.0f, -0.9238795f, -0.70710677f, -0.38268343f, 0.0f, 0.38268343f, 0.70710677f, 0.9238795f,
                0.0f, 0.38268343f, 0.70710677f, 0.9238795f, 1.0f, 0.9238795f, 0.70710677f, 0.38268343f,
                0.0f, -0.38268343f, -0.70710677f, -0.9238795f, -1.0f, -0.9238795f, -0.70710677f, -0.38268343f)
  CHOWDSP_ROOTS(20, 1.0f, 0.95105654f, 0.809017f, 0.58778524f, 0.309017f, 0.0f, -0.309017f, -0.58778524f,
                -0.809017f, -0.95105654f, -1.0f, -0.95105654f, -0.809017f, -0.58778524f, -0.309017f, 0.0f,
                0.309017f, 0.58778524f, 0.809017f, 0.95105654f,
                0.0f, 0.309017f, 0.58778524f, 0.809017f, 0.95105654f, 1.0f, 0.95105654f, 0.809017f, 0.58778524f,
                0.309017f, 0.0f, -0.309017f, -0.58778524f, -0.809017f, -0.95105654f, -1.0f, -0.95105654f,
                -0.809017f, -0.58778524f, -0.309017f)
  CHOWDSP_ROOTS(25, 1.0f, 0.96858317f, 0.87630665f, 0.7289686f, 0.5358268f, 0.309017f, 0.06279052f,
                -0.18738131f, -0.42577928f, -0.637424f, -0.809017f, -0.9297765f, -0.9921147f, -0.9921147f,
                -0.9297765f, -0.809017f, -0.637424f, -0.42577928f, -0.18738131f, 0.06279052f, 0.309017f,
                0.5358268f, 0.7289686f, 0.87630665f, 0.96858317f,
                0.0f, 0.24868989f, 0.48175368f, 0.6845471f, 0.8443279f, 0.95105654f, 0.9980267f, 0.9822872f,
                0.90482706f, 0.77051324f, 0.58778524f, 0.36812454f, 0.12533323f, -0.12533323f, -0.36812454f,
                -0.58778524f, -0.77051324f, -0.90482706f, -0.9822872f, -0.9980267f, -0.95105654f, -0.8443279f,
                -0.6845471f, -0.48175368f, -0.24868989f)
  return make_float2(1.0f, 0.0f);  // unreachable: every fused radix has its table above
}
#undef CHOWDSP_ROOTS

// The P = R0*R1-point DFT of v in place, input in natural order: the
// R0-point stage (s = 1, m = R1) with its twiddles W_P^(j0*p), then the
// R1-point stage (s = R0, m = 1), as stockham.cuh's stage on registers.
// No scratch array: output bin j1*R0 + j0 is left in v[j0*R1 + j1]
// (natural_bin maps a register to its bin).
template <int R0, int R1, int SIGN>
__device__ __forceinline__ void pass_dft(float2* v) {
  constexpr int P = R0 * R1;
#pragma unroll
  for (int p = 0; p < R1; ++p) {
    float2 b[R0];
#pragma unroll
    for (int k = 0; k < R0; ++k) b[k] = v[k * R1 + p];
    butterfly<R0, SIGN>(b);
#pragma unroll
    for (int j = 0; j < R0; ++j) v[j * R1 + p] = (j * p == 0) ? b[j] : cmul(b[j], inner_root<P, SIGN>(j * p));
  }
  if constexpr (R1 > 1) {
#pragma unroll
    for (int j0 = 0; j0 < R0; ++j0) {
      float2 b[R1];
#pragma unroll
      for (int k = 0; k < R1; ++k) b[k] = v[j0 * R1 + k];
      butterfly<R1, SIGN>(b);
#pragma unroll
      for (int j = 0; j < R1; ++j) v[j0 * R1 + j] = b[j];
    }
  }
}

// The bin of register i after pass_dft<R0, R1>.
template <int R0, int R1>
__host__ __device__ constexpr int natural_bin(int i) { return (i % R1) * R0 + i / R1; }

// Where a pass reads its row: a padded shared buffer (slot layout), or
// complex points in memory (device memory or a landing buffer; generic
// pointers): interleaved float2, or two float planes.
struct SharedIn {
  const float2* buf;
  __device__ __forceinline__ float2 operator()(int i) const { return buf[slot(i)]; }
};

struct ComplexIn {
  const float* re;
  const float* im;
  bool interleaved;
  __device__ __forceinline__ float2 operator()(int i) const {
    return interleaved ? reinterpret_cast<const float2*>(re)[i] : make_float2(re[i], im[i]);
  }
};

// K2/K3's first pass reads: bin k of the half-length spectrum Z, merged
// (stockham.cuh merge_bin) from the packed bins X held in natural order
// in `buf`, Z[k] = merge(X[k], conj X[M-k], w_k) with w_k = split[k] (the
// plan's split table in bin order). Slot 0 holds DC in re and the Nyquist
// bin X[M] in im, so bin 0 merges (DC, 0) with (Nyq, 0); bin M/2 is its
// own partner.
struct MergeIn {
  const float2* buf;
  const float2* __restrict__ split;
  int M;
  __device__ __forceinline__ float2 operator()(int k) const {
    float2 xk = buf[slot(k)];
    float2 xr = cconj(buf[slot(k == 0 ? 0 : M - k)]);
    if (k == 0) {
      xr = make_float2(xk.y, 0.0f);
      xk.y = 0.0f;
    }
    return merge_bin(xk, xr, __ldg(split + k));
  }
};

// Where a pass writes its row: a padded shared buffer.
struct SharedOut {
  float2* __restrict__ buf;
  __device__ __forceinline__ void operator()(int i, float2 v) const { buf[slot(i)] = v; }
};

struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

// One pass of radix P = R0*R1 at stride s over a row of L points, from
// `in` to `out`: thread t of the row's tpr threads takes butterflies
// u = t + c*tpr < L/P one at a time (read, DFT, twiddle, write: P points
// live). No barrier: the caller places it.
template <int R0, int R1, int SIGN, class In, class Out>
__device__ __forceinline__ void row_pass(In in, Out out, int L, int s, const float2* __restrict__ tw, int t,
                                         int tpr) {
  constexpr int P = R0 * R1;
  constexpr int C = (kRowPoints + P - 1) / P;
  const int nb = L / P;
  const int m = nb / s;
  // floor(u / s) == umulhi(u, magic) for u * s < 2^32 (u < L/P, s < L <= 2^14).
  const unsigned magic = s == 1 ? 0u : 0xFFFFFFFFu / static_cast<unsigned>(s) + 1u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int u = t + c * tpr;
    if (u < nb) {
      float2 v[P];
#pragma unroll
      for (int k = 0; k < P; ++k) v[k] = in(k * nb + u);
      pass_dft<R0, R1, SIGN>(v);
      const int p = s == 1 ? u : static_cast<int>(__umulhi(static_cast<unsigned>(u), magic));
      const int q = u - p * s;
      if (p != 0) {
#pragma unroll
        for (int i = 1; i < P; ++i) {
          float2 w = __ldg(tw + natural_bin<R0, R1>(i) * m + p);
          if (SIGN > 0) w = cconj(w);
          v[i] = cmul(v[i], w);
        }
      }
      const int base = p * P * s + q;
#pragma unroll
      for (int i = 0; i < P; ++i) out(base + natural_bin<R0, R1>(i) * s, v[i]);
    }
  }
}

template <int SIGN, class In, class Out>
__device__ __forceinline__ void dispatch_pass(int r0, int r1, In in, Out out, int L, int s,
                                              const float2* __restrict__ tw, int t, int tpr) {
  switch (r0 * 10 + r1) {
    case 44: row_pass<4, 4, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 42: row_pass<4, 2, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 43: row_pass<4, 3, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 45: row_pass<4, 5, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 23: row_pass<2, 3, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 25: row_pass<2, 5, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 33: row_pass<3, 3, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 35: row_pass<3, 5, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 55: row_pass<5, 5, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 41: row_pass<4, 1, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 21: row_pass<2, 1, SIGN>(in, out, L, s, tw, t, tpr); break;
    case 31: row_pass<3, 1, SIGN>(in, out, L, s, tw, t, tpr); break;
    default: row_pass<5, 1, SIGN>(in, out, L, s, tw, t, tpr); break;
  }
}

// All passes, ping-ponging between the padded buffers a and b, a barrier
// after each but the last: the first reads `in` and writes a; after it,
// `hook()` runs once all threads are done reading `in` (a pipelined form
// issues the next row's copy into its landing buffer there). `in` may be
// b itself. The last pass writes its outputs to `last`, in natural order
// (there p = 0, so output j of butterfly u is point j*s + u), and no
// barrier follows it. A plan has at least two passes (check_passes).
template <int SIGN, class In, class Hook, class Out>
__device__ __forceinline__ void run_passes_to(const Passes& ps, In in, float2* a, float2* b, int L,
                                              const float2* __restrict__ tw, int t, int tpr, Hook hook, Out last) {
  dispatch_pass<SIGN>(ps.r0[0], ps.r1[0], in, SharedOut{a}, L, 1, tw, t, tpr);
  __syncthreads();
  hook();
  tw += L;  // pass i's table holds P*m = L/s entries
  int s = ps.r0[0] * ps.r1[0];
  for (int i = 1; i < ps.count - 1; ++i) {
    dispatch_pass<SIGN>(ps.r0[i], ps.r1[i], SharedIn{a}, SharedOut{b}, L, s, tw, t, tpr);
    __syncthreads();
    tw += L / s;
    s *= ps.r0[i] * ps.r1[i];
    float2* tmp = a;
    a = b;
    b = tmp;
  }
  const int i = ps.count - 1;
  dispatch_pass<SIGN>(ps.r0[i], ps.r1[i], SharedIn{a}, last, L, s, tw, t, tpr);
}

// run_passes_to into shared memory, then a barrier: returns the buffer
// that holds the natural-order row (pass i writes a for even i, b for odd
// i, so the last pass writes a when the plan has an odd count).
template <int SIGN, class In, class Hook>
__device__ __forceinline__ float2* run_passes(const Passes& ps, In in, float2* a, float2* b, int L,
                                              const float2* __restrict__ tw, int t, int tpr, Hook hook) {
  float2* dst = ps.count % 2 ? a : b;
  run_passes_to<SIGN>(ps, in, a, b, L, tw, t, tpr, hook, SharedOut{dst});
  __syncthreads();
  return dst;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Host: refuse a pass plan that is not the plan's stages fused in order
// (pairs of the kinds dispatch_pass knows, or single stages), one of
// fewer than two passes (run_passes_to's first and last pass are two;
// every size of the domains has at least two), or a row that the threads
// do not cover. Returns a cudaError_t value.
int check_passes(const int* passes, int npasses, const Radices& rad, int L, Passes* out) {
  if (npasses < 2 || npasses > kMaxPasses || L % kRowPoints) return static_cast<int>(cudaErrorInvalidValue);
  int stage = 0, prod = 1;
  out->count = npasses;
  for (int i = 0; i < npasses; ++i) {
    const int r0 = passes[2 * i], r1 = passes[2 * i + 1];
    const int code = r0 * 10 + r1;
    const bool known = code == 44 || code == 42 || code == 43 || code == 45 || code == 23 || code == 25 ||
                       code == 33 || code == 35 || code == 55 || code == 41 || code == 21 || code == 31 ||
                       code == 51;
    if (!known || stage >= rad.count || rad.r[stage] != r0) return static_cast<int>(cudaErrorInvalidValue);
    ++stage;
    if (r1 != 1) {
      if (stage >= rad.count || rad.r[stage] != r1) return static_cast<int>(cudaErrorInvalidValue);
      ++stage;
    }
    out->r0[i] = r0;
    out->r1[i] = r1;
    prod *= r0 * r1;
  }
  if (stage != rad.count || prod != L) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Bytes of shared memory for `rows_per_block` rows of L points, two
// padded buffers each.
constexpr int row_smem_bytes(int L, int rows_per_block) {
  return rows_per_block * two_buffers_bytes(L);
}

// Host: refuse a grid-form geometry that does not cover `rows` rows of L
// points or does not fit a block.
int check_row_geometry(int L, int rows, int rows_per_block, int threads, int smem, int grid) {
  if (rows_per_block < 1 || threads != rows_per_block * (L / kRowPoints) || threads > kMaxThreads ||
      smem != row_smem_bytes(L, rows_per_block) || smem > kMaxSmemBytes ||
      static_cast<long long>(grid) * rows_per_block < rows ||
      static_cast<long long>(grid - 1) * rows_per_block >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace
