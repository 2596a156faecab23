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
// Design: one thread block per row. The row is staged in shared memory as
// N/2 complex points (x[2m] + i x[2m+1]); the half-length complex FFT runs
// there as the plan's mixed-radix {4,2,3,5} Stockham stages, ping-ponging
// between two padded shared buffers (8.25N bytes per block, so N <= 16384
// fits in 132 KB), then the half-complex split/merge gives the real
// spectrum. Each
// element of the row is read from and written to device memory exactly
// once, with neighbouring threads on neighbouring addresses; unordered
// positions are a gather/scatter inside shared memory, never in device
// memory. Twiddles come from the plan's float32 tables (built in float64
// on the host), read through the read-only cache; no sinf/cosf in kernel.
// Rows are independent, so a ragged batch needs no padding or masking.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxN = 16384;  // 8.25N bytes of shared memory per block

struct Radices {
  int count;
  int r[kMaxStages];
};

// Shared-memory slot of complex element i: one float2 of padding after
// every 32. The unordered layout gathers (K1) and scatters (K2, K3) with
// stride N1 across a warp, and radix-R stages write with stride R; the
// padding spreads both over the banks instead of piling them on one.
__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }
__host__ __device__ constexpr int padded(int m) { return m + (m >> 5); }

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

// One Stockham stage over a length-M complex row in shared memory.
// Input viewed as (R, m, s), output as (m, R, s): butterfly t = p*s + q
// reads src[k*(M/R) + t], twiddles output j by W_n^(j*p) (the stage's
// (R, m) table, conjugated for SIGN = +1), writes dst[p*R*s + j*s + q].
template <int R, int SIGN>
__device__ void stage(const float2* __restrict__ src, float2* __restrict__ dst,
                      int M, int s, const float2* __restrict__ tw) {
  const int nb = M / R;
  const int m = nb / s;
  for (int t = threadIdx.x; t < nb; t += blockDim.x) {
    const int p = t / s;
    const int q = t - p * s;
    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = src[slot(k * nb + t)];
    butterfly<R, SIGN>(v);
    const int out = p * R * s + q;
    dst[slot(out)] = v[0];
#pragma unroll
    for (int j = 1; j < R; ++j) {
      float2 w = __ldg(tw + j * m + p);
      if (SIGN > 0) w = cconj(w);
      dst[slot(out + j * s)] = cmul(v[j], w);
    }
  }
}

// Run all stages; returns the buffer that holds the natural-order result.
template <int SIGN>
__device__ float2* run_stages(float2* a, float2* b, int M, const Radices& rad,
                              const float2* __restrict__ tw) {
  int s = 1;
  for (int i = 0; i < rad.count; ++i) {
    const int r = rad.r[i];
    switch (r) {
      case 2: stage<2, SIGN>(a, b, M, s, tw); break;
      case 3: stage<3, SIGN>(a, b, M, s, tw); break;
      case 4: stage<4, SIGN>(a, b, M, s, tw); break;
      default: stage<5, SIGN>(a, b, M, s, tw); break;
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

// K1: x (rows, N) -> packed planes (rows, N/2).
__global__ void __launch_bounds__(kMaxThreads)
rfft_packed_kernel(const float* __restrict__ x, float* __restrict__ yre,
                   float* __restrict__ yim, int n, Radices rad,
                   const float2* __restrict__ stage_tw,
                   const float2* __restrict__ split_tw,
                   const int* __restrict__ perm) {
  extern __shared__ float2 smem[];
  const int M = n / 2;
  const size_t row = blockIdx.x;
  float2* a = smem;
  float2* b = smem + padded(M);

  const float2* xr = reinterpret_cast<const float2*>(x + row * n);
  for (int i = threadIdx.x; i < M; i += blockDim.x) a[slot(i)] = xr[i];
  __syncthreads();
  const float2* Z = run_stages<-1>(a, b, M, rad, stage_tw);

  // Split: X[k] = E[k] + W_N^k O[k], E = (Z[k] + conj Z[M-k]) / 2,
  // O = -i (Z[k] - conj Z[M-k]) / 2; X[0] = Re Z0 + Im Z0 and the
  // Nyquist bin X[M] = Re Z0 - Im Z0 goes to im[0].
  float* ore = yre + row * M;
  float* oim = yim + row * M;
  for (int pos = threadIdx.x; pos < M; pos += blockDim.x) {
    const int k = perm ? __ldg(perm + pos) : pos;
    float re, im;
    if (k == 0) {
      const float2 z0 = Z[slot(0)];
      re = z0.x + z0.y;
      im = z0.x - z0.y;
    } else {
      const float2 z = Z[slot(k)];
      const float2 zc = cconj(Z[slot(M - k)]);
      const float2 e = cscale(cadd(z, zc), 0.5f);
      const float2 d = csub(z, zc);
      const float2 o = make_float2(0.5f * d.y, -0.5f * d.x);  // -i/2 * d
      const float2 X = cadd(e, cmul(__ldg(split_tw + k), o));
      re = X.x;
      im = X.y;
    }
    ore[pos] = re;
    oim[pos] = im;
  }
}

// K2 (CONV = false): packed planes (rows, N/2) -> x (rows, N), unscaled.
// K3 (CONV = true): the same on scale * A (.) B, with the bin-0 patch-up
// re[0] = Ar*Br (DC*DC), im[0] = Ai*Bi (Nyq*Nyq); B has b_rows rows,
// 1 (a shared filter, broadcast) or rows.
template <bool CONV>
__global__ void __launch_bounds__(kMaxThreads)
irfft_packed_kernel(const float* __restrict__ are, const float* __restrict__ aim,
                    const float* __restrict__ bre, const float* __restrict__ bim,
                    int b_rows, float scale, float* __restrict__ x, int n,
                    Radices rad, const float2* __restrict__ stage_tw,
                    const float2* __restrict__ split_tw,
                    const int* __restrict__ perm) {
  extern __shared__ float2 smem[];
  __shared__ float nyq;
  const int M = n / 2;
  const size_t row = blockIdx.x;
  float2* a = smem;
  float2* b = smem + padded(M);

  const float* pre = are + row * M;
  const float* pim = aim + row * M;
  const size_t brow = (CONV && b_rows > 1) ? row : 0;
  for (int pos = threadIdx.x; pos < M; pos += blockDim.x) {
    float re = pre[pos], im = pim[pos];
    if (CONV) {
      const float br = bre[brow * M + pos], bi = bim[brow * M + pos];
      if (pos == 0) {
        re = re * br;
        im = im * bi;
      } else {
        const float pr = re * br - im * bi;
        im = re * bi + im * br;
        re = pr;
      }
      re *= scale;
      im *= scale;
    }
    if (pos == 0) {  // position 0 is bin 0 in every layout
      nyq = im;
      im = 0.0f;
    }
    a[slot(perm ? __ldg(perm + pos) : pos)] = make_float2(re, im);
  }
  __syncthreads();

  // Merge: Z[k] = E + i O, E = (X[k] + conj X[M-k]) / 2,
  // O = W_N^-k (X[k] - conj X[M-k]) / 2, with X[M] the Nyquist bin.
  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    const float2 xk = a[slot(k)];
    const float2 xr = k == 0 ? make_float2(nyq, 0.0f) : cconj(a[slot(M - k)]);
    const float2 e = cscale(cadd(xk, xr), 0.5f);
    const float2 o = cmul(cconj(__ldg(split_tw + k)), cscale(csub(xk, xr), 0.5f));
    b[slot(k)] = cadd(e, mul_i<1>(o));
  }
  __syncthreads();
  const float2* zt = run_stages<1>(b, a, M, rad, stage_tw);

  // zt == M * (x_even + i x_odd); N * x = 2 * M * x.
  float2* out = reinterpret_cast<float2*>(x + row * n);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const float2 z = zt[slot(i)];
    out[i] = make_float2(2.0f * z.x, 2.0f * z.y);
  }
}

// Two padded N/2-point complex buffers.
constexpr int smem_bytes(int n) { return 2 * padded(n / 2) * static_cast<int>(sizeof(float2)); }

int threads_for(int M) {
  int t = ((M / 4 + 31) / 32) * 32;
  if (t < 64) t = 64;
  if (t > kMaxThreads) t = kMaxThreads;
  return t;
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

template <typename K>
int set_smem(K kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kMaxN)));
}

}  // namespace

extern "C" {

int hopper_real_fft_max_n() { return kMaxN; }

// K1. Returns a cudaError_t value; 0 means the launch was accepted.
int k1_rfft_packed(const float* x, float* yre, float* yim, int rows, int n,
                   const int* radices, int nstages, const void* stage_tw,
                   const void* split_tw, const int* perm, void* stream) {
  if (n < 4 || n > kMaxN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  if (rows == 0) return 0;
  err = set_smem(rfft_packed_kernel);
  if (err) return err;
  const int M = n / 2;
  rfft_packed_kernel<<<rows, threads_for(M), smem_bytes(n),
                       static_cast<cudaStream_t>(stream)>>>(
      x, yre, yim, n, rad, static_cast<const float2*>(stage_tw),
      static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

// K2.
int k2_irfft_packed(const float* yre, const float* yim, float* x, int rows, int n,
                    const int* radices, int nstages, const void* stage_tw,
                    const void* split_tw, const int* perm, void* stream) {
  if (n < 4 || n > kMaxN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  if (rows == 0) return 0;
  err = set_smem(irfft_packed_kernel<false>);
  if (err) return err;
  const int M = n / 2;
  irfft_packed_kernel<false><<<rows, threads_for(M), smem_bytes(n),
                               static_cast<cudaStream_t>(stream)>>>(
      yre, yim, nullptr, nullptr, 0, 1.0f, x, n, rad,
      static_cast<const float2*>(stage_tw), static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

// K3.
int k3_convolve_irfft_packed(const float* are, const float* aim, const float* bre,
                             const float* bim, int b_rows, float scale, float* x,
                             int rows, int n, const int* radices, int nstages,
                             const void* stage_tw, const void* split_tw,
                             const int* perm, void* stream) {
  if (n < 4 || n > kMaxN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (b_rows != 1 && b_rows != rows) return static_cast<int>(cudaErrorInvalidValue);
  Radices rad;
  int err = make_radices(radices, nstages, &rad);
  if (err) return err;
  if (rows == 0) return 0;
  err = set_smem(irfft_packed_kernel<true>);
  if (err) return err;
  const int M = n / 2;
  irfft_packed_kernel<true><<<rows, threads_for(M), smem_bytes(n),
                              static_cast<cudaStream_t>(stream)>>>(
      are, aim, bre, bim, b_rows, scale, x, n, rad,
      static_cast<const float2*>(stage_tw), static_cast<const float2*>(split_tw), perm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
