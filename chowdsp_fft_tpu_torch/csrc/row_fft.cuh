// Per-row bodies of the single-row kernels: K1 (packed real forward),
// K2/K3 (packed real inverse, optionally on a spectral product) and K4
// (complex), shared by their grid forms (real_fft.cu, complex_fft.cu) and
// their pipelined forms (pipelined_fft.cu: persistent blocks that prefetch
// the next row). Both forms run these functions on the same tables, so
// their outputs are bit-identical, as the JAX package's grid and
// double-buffered kernels share _rfft_tile, _irfft_core and _cfft_tile.
//
// K1 and K4 run the register-resident pass engine (row_passes.cuh) on two
// padded buffers per row; rfft_row/cfft_row read the row from a generic
// pointer (device memory, or a pipelined form's landing buffer) and call
// `hook` once that input is no longer read. K2/K3 run stockham.cuh's
// stages on two buffers, split where a pipelined block may reuse its
// input: *_load reads the row into the padded work buffer `a` and ends
// with a barrier; *_finish runs the stages and stores the row.

#pragma once

#include "row_passes.cuh"

namespace {

// K1: the row's N real samples (8-byte aligned) as M = N/2 complex points
// x[2m] + i x[2m+1], their M-point FFT, then the last exchange's reads: the
// split (stockham.cuh split_bin, Z[k] and Z[M-k], twiddle split[p]: the
// plan's split table, or for the unordered layout that table gathered to
// position order) and the store of the packed planes, ordered or at
// position p bin perm[p], the Nyquist bin in im[0]; four consecutive positions a thread, float4 stores where both
// planes are 16-byte aligned. Thread t of the row's tpr = M/16; `store`
// false computes and stores nothing (a block's ragged row).
template <class Hook>
__device__ __forceinline__ void rfft_row(const float* x, float2* a, float2* b, int M, const Passes& ps,
                                         const float2* __restrict__ tw, const float2* __restrict__ split,
                                         const int* __restrict__ perm, float* ore, float* oim, bool store, int t,
                                         int tpr, Hook hook) {
  const float2* buf = run_passes<-1>(ps, ComplexIn{x, x + 1, true}, a, b, M, tw, t, tpr, hook);
  if (!store) return;
  const bool vec = aligned16(ore) && aligned16(oim);
#pragma unroll
  for (int c = 0; c < kRowPoints / 4; ++c) {
    const int pos0 = 4 * (t + c * tpr);
    float re[4], im[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = perm ? __ldg(perm + pos0 + e) : pos0 + e;
      if (k == 0) {
        const float2 z0 = buf[slot(0)];
        re[e] = z0.x + z0.y;
        im[e] = z0.x - z0.y;
      } else {
        const float2 X = split_bin(buf[slot(k)], buf[slot(M - k)], __ldg(split + pos0 + e));
        re[e] = X.x;
        im[e] = X.y;
      }
    }
    if (vec) {
      *reinterpret_cast<float4*>(ore + pos0) = make_float4(re[0], re[1], re[2], re[3]);
      *reinterpret_cast<float4*>(oim + pos0) = make_float4(im[0], im[1], im[2], im[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ore[pos0 + e] = re[e];
        oim[pos0 + e] = im[e];
      }
    }
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

// K4, the last exchange's reads: the natural-order row in `buf` stored
// ordered, or (forward unordered, `gather`) position i takes bin
// gather[i]; complex64 as float4 pairs where the output is 16-byte
// aligned. Thread t of the row's tpr = n/16.
__device__ __forceinline__ void cfft_row_store(const float2* buf, const int* __restrict__ gather, float* yre,
                                               float* yim, int stride, int t, int tpr) {
  if (stride == 2) {
    const bool vec = aligned16(yre);
    float2* y = reinterpret_cast<float2*>(yre);
#pragma unroll
    for (int c = 0; c < kRowPoints / 2; ++c) {
      const int i = 2 * (t + c * tpr);
      const float2 a = buf[slot(gather ? __ldg(gather + i) : i)];
      const float2 b = buf[slot(gather ? __ldg(gather + i + 1) : i + 1)];
      if (vec) {
        *reinterpret_cast<float4*>(y + i) = make_float4(a.x, a.y, b.x, b.y);
      } else {
        y[i] = a;
        y[i + 1] = b;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kRowPoints; ++c) {
      const int i = t + c * tpr;
      const float2 v = buf[slot(gather ? __ldg(gather + i) : i)];
      yre[i] = v.x;
      yim[i] = v.y;
    }
  }
}

// K4, a row already in registers: point t + c*tpr in v[c] (the pipelined
// form's register prefetch, or cfft_row's loads). Written to b in natural
// order (a backward unordered row, whose position i holds bin perm[i], is
// scattered), then the passes, then the store.
template <int SIGN, class Hook>
__device__ __forceinline__ void cfft_row_from(const float2 (&v)[kRowPoints], const int* __restrict__ perm,
                                              float2* a, float2* b, int n, const Passes& ps,
                                              const float2* __restrict__ tw, float* yre, float* yim, int stride,
                                              bool store, int t, int tpr, Hook hook) {
#pragma unroll
  for (int c = 0; c < kRowPoints; ++c) {
    const int i = t + c * tpr;
    b[slot(SIGN > 0 && perm ? __ldg(perm + i) : i)] = v[c];
  }
  __syncthreads();
  hook();
  const float2* buf = run_passes<SIGN>(ps, SharedIn{b}, a, b, n, tw, t, tpr, NoHook{});
  if (store) cfft_row_store(buf, SIGN < 0 ? perm : nullptr, yre, yim, stride, t, tpr);
}

// K4: the row's n points, element i at xre[i * stride], xim[i * stride]
// (planes: stride 1; interleaved complex64: stride 2, xim = xre + 1, read
// as float2), forward (SIGN = -1) or backward (+1). An ordered or forward
// row goes straight from memory into the first pass; a backward unordered
// row holds bin perm[i] at position i, so its first exchange scatters the
// coalesced loads into natural order. `store` false stores nothing.
template <int SIGN, class Hook>
__device__ __forceinline__ void cfft_row(const float* xre, const float* xim, int stride,
                                         const int* __restrict__ perm, float2* a, float2* b, int n,
                                         const Passes& ps, const float2* __restrict__ tw, float* yre, float* yim,
                                         bool store, int t, int tpr, Hook hook) {
  const ComplexIn in{xre, xim, stride == 2};
  if (SIGN > 0 && perm) {
    float2 v[kRowPoints];
#pragma unroll
    for (int c = 0; c < kRowPoints; ++c) v[c] = in(t + c * tpr);
    cfft_row_from<SIGN>(v, perm, a, b, n, ps, tw, yre, yim, stride, store, t, tpr, hook);
    return;
  }
  const float2* buf = run_passes<SIGN>(ps, in, a, b, n, tw, t, tpr, hook);
  if (store) cfft_row_store(buf, SIGN < 0 ? perm : nullptr, yre, yim, stride, t, tpr);
}

}  // namespace
