// Per-row bodies of the single-row kernels: K1 (packed real forward),
// K2/K3 (packed real inverse, optionally on a spectral product) and K4
// (complex), shared by their grid forms (real_fft.cu, complex_fft.cu: one
// block per row) and their pipelined forms (pipelined_fft.cu: persistent
// blocks that prefetch the next row). Both forms run these functions on
// the same tables, so their outputs are bit-identical, as the JAX
// package's grid and double-buffered kernels share _rfft_tile,
// _irfft_core and _cfft_tile.
//
// Each body is split where a pipelined block may reuse its input buffer:
// *_load reads the row (from device memory or from a shared landing
// buffer: the pointers are generic) into the padded work buffer `a` and
// ends with a barrier; *_finish runs the stages and stores the row.

#pragma once

#include "stockham.cuh"

namespace {

// K1, load: the row's N real samples as M = N/2 complex points.
__device__ __forceinline__ void rfft_row_load(const float2* __restrict__ x, float2* a, int M) {
  for (int i = threadIdx.x; i < M; i += blockDim.x) a[slot(i)] = x[i];
  __syncthreads();
}

// K1, finish: the half-length FFT, the split (stockham.cuh split_bin) and
// the store of the packed planes, ordered or at position p bin perm[p];
// the Nyquist bin goes to im[0].
__device__ __forceinline__ void rfft_row_finish(float2* a, float2* b, int M, const Radices& rad,
                                                const float2* __restrict__ stage_tw,
                                                const float2* __restrict__ split_tw,
                                                const int* __restrict__ perm, float* ore, float* oim) {
  const float2* Z = run_stages<-1>(a, b, M, rad, stage_tw);
  for (int pos = threadIdx.x; pos < M; pos += blockDim.x) {
    const int k = perm ? __ldg(perm + pos) : pos;
    float re, im;
    if (k == 0) {
      const float2 z0 = Z[slot(0)];
      re = z0.x + z0.y;
      im = z0.x - z0.y;
    } else {
      const float2 X = split_bin(Z[slot(k)], Z[slot(M - k)], __ldg(split_tw + k));
      re = X.x;
      im = X.y;
    }
    ore[pos] = re;
    oim[pos] = im;
  }
}

// K2/K3, load: packed planes (K3: scale * A (.) B with the bin-0 patch-up
// re[0] = Ar*Br, im[0] = Ai*Bi) scattered to natural bin order in `a`;
// the Nyquist bin is set aside in *nyq (shared).
template <bool CONV>
__device__ __forceinline__ void irfft_row_load(const float* pre, const float* pim,
                                               const float* __restrict__ bre,
                                               const float* __restrict__ bim, float scale,
                                               const int* __restrict__ perm, float2* a, float* nyq,
                                               int M) {
  for (int pos = threadIdx.x; pos < M; pos += blockDim.x) {
    float re = pre[pos], im = pim[pos];
    if (CONV) {
      const float br = bre[pos], bi = bim[pos];
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
      *nyq = im;
      im = 0.0f;
    }
    a[slot(perm ? __ldg(perm + pos) : pos)] = make_float2(re, im);
  }
  __syncthreads();
}

// K2/K3, finish: the merge (stockham.cuh merge_bin, X[M] the Nyquist
// bin), the half-length inverse FFT, and the store of N * x.
__device__ __forceinline__ void irfft_row_finish(float2* a, float2* b, int M, const float* nyq,
                                                 const Radices& rad,
                                                 const float2* __restrict__ stage_tw,
                                                 const float2* __restrict__ split_tw, float* x) {
  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    const float2 xr = k == 0 ? make_float2(*nyq, 0.0f) : cconj(a[slot(M - k)]);
    b[slot(k)] = merge_bin(a[slot(k)], xr, __ldg(split_tw + k));
  }
  __syncthreads();
  const float2* zt = run_stages<1>(b, a, M, rad, stage_tw);
  // zt == M * (x_even + i x_odd); N * x = 2 * M * x.
  float2* out = reinterpret_cast<float2*>(x);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const float2 z = zt[slot(i)];
    out[i] = make_float2(2.0f * z.x, 2.0f * z.y);
  }
}

// K4: element i of a row goes to `a` at its natural bin; a backward
// unordered row holds bin perm[i] at position i.
template <int SIGN>
__device__ __forceinline__ void cfft_put(float2* a, const int* __restrict__ perm, int i, float2 v) {
  a[slot(SIGN > 0 && perm ? __ldg(perm + i) : i)] = v;
}

// K4, load: element i of the row at xre[i * stride], xim[i * stride]
// (planes: stride 1; interleaved complex64: stride 2, xim = xre + 1).
template <int SIGN>
__device__ __forceinline__ void cfft_row_load(const float* xre, const float* xim, int stride,
                                              const int* __restrict__ perm, float2* a, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t at = static_cast<size_t>(i) * stride;
    cfft_put<SIGN>(a, perm, i, make_float2(xre[at], xim[at]));
  }
  __syncthreads();
}

// K4, finish: the stages and the store; a forward unordered row takes
// bin perm[p] at position p.
template <int SIGN>
__device__ __forceinline__ void cfft_row_finish(float2* a, float2* b, int n, const Radices& rad,
                                                const float2* __restrict__ stage_tw,
                                                const int* __restrict__ perm, float* yre, float* yim,
                                                int stride) {
  const float2* z = run_stages<SIGN>(a, b, n, rad, stage_tw);
  const int* gather = SIGN < 0 ? perm : nullptr;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 v = z[slot(gather ? __ldg(gather + i) : i)];
    const size_t at = static_cast<size_t>(i) * stride;
    yre[at] = v.x;
    yim[at] = v.y;
  }
}

}  // namespace
