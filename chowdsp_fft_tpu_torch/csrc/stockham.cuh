// Shared-memory mixed-radix Stockham stages (stage/run_stages), run by
// the small-N kernels (small_fft.cu: K5); and what every kernel family
// shares: the padded slot layout, complex arithmetic, the radix
// butterflies, and the real split and merge (also run by the row engine,
// row_passes.cuh, and the column engine, col_passes.cuh).
//
// A block holds one row of M complex points in two padded shared buffers
// and runs the plan's {4,2,3,5} stages between them, FP32 FMA only, with
// twiddles from the plan's float32 tables (built in float64 on the host)
// read through the read-only cache. The result is in natural order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 32;
constexpr int kMaxThreads = 1024;
// Shared memory one block may use on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

struct Radices {
  int count;
  int r[kMaxStages];
};

// Shared-memory slot of complex element i: one float2 of padding after
// every 32. Unordered layouts gather and scatter with stride N1 across a
// warp, and radix-R stages write with stride R; the padding spreads both
// over the banks instead of piling them on one.
__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }
__host__ __device__ constexpr int padded(int m) { return m + (m >> 5); }

// Bytes of two padded M-point complex buffers.
constexpr int two_buffers_bytes(int m) { return 2 * padded(m) * static_cast<int>(sizeof(float2)); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }
__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }
// (x + iy) * i * SIGN
template <int SIGN>
__device__ __forceinline__ float2 mul_i(float2 a) { return make_float2(-SIGN * a.y, SIGN * a.x); }

// The half-complex split and merge of the packed real FFT (real_fft.cu,
// composite_fft.cu). A real row of length 2M is transformed as the M
// complex points x[2m] + i x[2m+1]; Z is their DFT and w = W_2M^k.
// Split, 0 < k < M: X[k] = E + w O, E = (Z[k] + conj Z[M-k]) / 2,
// O = -i (Z[k] - conj Z[M-k]) / 2 (X[0] and the Nyquist bin X[M] are
// Re Z0 + Im Z0 and Re Z0 - Im Z0).
__device__ __forceinline__ float2 split_bin(float2 z, float2 zm, float2 w) {
  const float2 zc = cconj(zm);
  const float2 e = cscale(cadd(z, zc), 0.5f);
  const float2 d = csub(z, zc);
  const float2 o = make_float2(0.5f * d.y, -0.5f * d.x);  // -i/2 * d
  return cadd(e, cmul(w, o));
}

// Merge, the split's inverse: Z[k] = E + i O, E = (X[k] + xr) / 2,
// O = conj(w) (X[k] - xr) / 2, with xr = conj X[M-k] (the Nyquist bin
// X[M] at k = 0).
__device__ __forceinline__ float2 merge_bin(float2 xk, float2 xr, float2 w) {
  const float2 e = cscale(cadd(xk, xr), 0.5f);
  const float2 o = cmul(cconj(w), cscale(csub(xk, xr), 0.5f));
  return cadd(e, mul_i<1>(o));
}

// cos/sin(2*pi*k/R) for the dense radix-3/5 butterflies, float64-rounded.
template <int R> struct Roots;
template <> struct Roots<3> {
  static __device__ __forceinline__ float c(int k) {
    const float v[3] = {1.0f, -0.5f, -0.5f};
    return v[k];
  }
  static __device__ __forceinline__ float s(int k) {
    const float v[3] = {0.0f, 0.86602540378443865f, -0.86602540378443865f};
    return v[k];
  }
};
template <> struct Roots<5> {
  static __device__ __forceinline__ float c(int k) {
    const float v[5] = {1.0f, 0.30901699437494742f, -0.80901699437494742f,
                        -0.80901699437494742f, 0.30901699437494742f};
    return v[k];
  }
  static __device__ __forceinline__ float s(int k) {
    const float v[5] = {0.0f, 0.95105651629515357f, 0.58778525229247313f,
                        -0.58778525229247313f, -0.95105651629515357f};
    return v[k];
  }
};

// Radix-R DFT of v[0..R) in place; SIGN = -1 forward, +1 backward.
template <int R, int SIGN>
__device__ __forceinline__ void butterfly(float2* v) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = mul_i<SIGN>(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[1] = cadd(t1, t3);
    v[2] = csub(t0, t2);
    v[3] = csub(t1, t3);
  } else {
    float2 out[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float2 acc = v[0];
#pragma unroll
      for (int k = 1; k < R; ++k) {
        const int e = (j * k) % R;
        const float2 w = make_float2(Roots<R>::c(e), SIGN * Roots<R>::s(e));
        acc = cadd(acc, cmul(v[k], w));
      }
      out[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = out[j];
  }
}

// One Stockham stage over a length-M complex row in shared memory, or
// over 2^ls such rows interleaved (element i of row `lane` at index
// (i << ls) + lane: K5's row tiles; ls = 0 is one row). Input viewed as (R, m, s), output as (m, R, s): butterfly
// t = p*s + q reads src[k*(M/R) + t], twiddles output j by W_n^(j*p) (the
// stage's (R, m) table, conjugated for SIGN = +1), writes
// dst[p*R*s + j*s + q]. Neighbouring threads take neighbouring lanes.
template <int R, int SIGN>
__device__ void stage(const float2* __restrict__ src, float2* __restrict__ dst,
                      int M, int s, const float2* __restrict__ tw, int ls) {
  const int nb = M / R;
  const int m = nb / s;
  const int lane_mask = (1 << ls) - 1;
  for (int u = threadIdx.x; u < (nb << ls); u += blockDim.x) {
    const int t = u >> ls;
    const int lane = u & lane_mask;
    const int p = t / s;
    const int q = t - p * s;
    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = src[slot(((k * nb + t) << ls) + lane)];
    butterfly<R, SIGN>(v);
    const int out = p * R * s + q;
    dst[slot((out << ls) + lane)] = v[0];
#pragma unroll
    for (int j = 1; j < R; ++j) {
      float2 w = __ldg(tw + j * m + p);
      if (SIGN > 0) w = cconj(w);
      dst[slot(((out + j * s) << ls) + lane)] = cmul(v[j], w);
    }
  }
}

// Run all stages; returns the buffer that holds the natural-order result.
template <int SIGN>
__device__ float2* run_stages(float2* a, float2* b, int M, const Radices& rad,
                              const float2* __restrict__ tw, int ls = 0) {
  int s = 1;
  for (int i = 0; i < rad.count; ++i) {
    const int r = rad.r[i];
    switch (r) {
      case 2: stage<2, SIGN>(a, b, M, s, tw, ls); break;
      case 3: stage<3, SIGN>(a, b, M, s, tw, ls); break;
      case 4: stage<4, SIGN>(a, b, M, s, tw, ls); break;
      default: stage<5, SIGN>(a, b, M, s, tw, ls); break;
    }
    __syncthreads();
    tw += M / s;  // this stage's table holds r * m = M / s entries
    s *= r;
    float2* t = a;
    a = b;
    b = t;
  }
  return a;
}

int make_radices(const int* radices, int count, Radices* out) {
  if (count < 0 || count > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  out->count = count;
  for (int i = 0; i < count; ++i) {
    const int r = radices[i];
    if (r != 2 && r != 3 && r != 4 && r != 5) return static_cast<int>(cudaErrorInvalidValue);
    out->r[i] = r;
  }
  return 0;
}

// Allow `bytes` of dynamic shared memory for `kernel`.
template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// Blocks of `kernel` resident on one SM at `threads` and `smem` bytes
// (allowed first) into *per_sm; returns a cudaError_t value.
template <typename K>
int blocks_at(K kernel, int threads, int smem, int* per_sm) {
  const int err = set_smem(kernel, smem);
  return err ? err
             : static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem));
}

}  // namespace
