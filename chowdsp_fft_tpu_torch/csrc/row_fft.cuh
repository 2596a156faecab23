// Per-row bodies of the single-row kernels: K1 (packed real forward),
// K2/K3 (packed real inverse, optionally on a spectral product) and K4
// (complex), shared by their grid forms (real_fft.cu, complex_fft.cu) and
// their pipelined forms (pipelined_fft.cu: persistent blocks that prefetch
// the next row). Both forms run these functions on the same tables, so
// their outputs are bit-identical, as the JAX package's grid and
// double-buffered kernels share _rfft_tile, _irfft_core and _cfft_tile.
//
// All of them run the register-resident pass engine (row_passes.cuh) on
// two padded buffers per row; rfft_row, irfft_row and cfft_row read the
// row from a generic pointer (device memory, or a pipelined form's
// landing buffer) and call `hook` once that input is no longer read.

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

// Four consecutive floats at p: one float4 where p is 16-byte aligned
// (`vec`), else four scalar loads. LDG reads device memory through the
// read-only cache; else p may be a generic pointer into shared memory (a
// pipelined form's landing buffer).
template <bool LDG = false>
__device__ __forceinline__ void load4(const float* p, bool vec, float (&v)[4]) {
  if (vec) {
    const float4* q4 = reinterpret_cast<const float4*>(p);
    float4 q;
    if constexpr (LDG) q = __ldg(q4);
    else q = *q4;
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (LDG) v[e] = __ldg(p + e);
      else v[e] = p[e];
    }
  }
}

// K2/K3's first exchange: thread t of the row's tpr = M/16 reads four
// consecutive positions of both packed planes at a time (as K1's store
// writes them; float4 where both planes are 16-byte aligned), K3 forms
// scale * A (.) B with the bin-0 patch-up re[0] = Ar*Br (DC*DC),
// im[0] = Ai*Bi (Nyq*Nyq) in registers (B through the read-only cache),
// and each point goes to `buf` at its natural bin (perm[pos] in the
// unordered layout; a 16-byte aligned table). Position 0 is bin 0 in
// every layout: its slot keeps DC in re and the Nyquist bin in im, which
// MergeIn reads. No barrier.
template <bool CONV>
__device__ __forceinline__ void irfft_row_scatter(const float* pre, const float* pim, const float* __restrict__ bre,
                                                  const float* __restrict__ bim, float scale,
                                                  const int* __restrict__ perm, float2* buf, int t, int tpr) {
  const bool vec = aligned16(pre) && aligned16(pim);
  const bool bvec = CONV && aligned16(bre) && aligned16(bim);
#pragma unroll
  for (int c = 0; c < kRowPoints / 4; ++c) {
    const int pos0 = 4 * (t + c * tpr);
    float re[4], im[4];
    load4(pre + pos0, vec, re);
    load4(pim + pos0, vec, im);
    if (CONV) {
      float br[4], bi[4];
      load4<true>(bre + pos0, bvec, br);
      load4<true>(bim + pos0, bvec, bi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool bin0 = pos0 + e == 0;
        const float pr = bin0 ? re[e] * br[e] : re[e] * br[e] - im[e] * bi[e];
        const float pi = bin0 ? im[e] * bi[e] : re[e] * bi[e] + im[e] * br[e];
        re[e] = pr * scale;
        im[e] = pi * scale;
      }
    }
    int k[4] = {pos0, pos0 + 1, pos0 + 2, pos0 + 3};
    if (perm) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(perm + pos0));
      k[0] = q.x;
      k[1] = q.y;
      k[2] = q.z;
      k[3] = q.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) buf[slot(k[e])] = make_float2(re[e], im[e]);
  }
}

// K2/K3's last pass writes N * x = 2 * z (z = M * (x_even + i x_odd), the
// half-length inverse) straight to device memory: point i as the real
// samples x[2i], x[2i+1]. Consecutive threads hold consecutive points, so
// a warp writes 256 contiguous bytes an instruction. (float4 stores from
// one more exchange ran 3-8% slower on the H100: PERF.md, PR 8.)
struct RealOut {
  float2* x;
  bool store;
  __device__ __forceinline__ void operator()(int i, float2 v) const {
    if (store) x[i] = make_float2(2.0f * v.x, 2.0f * v.y);
  }
};

// K2 (CONV false) and K3 (true): one row of packed planes (K3: A, and B's
// row) to the row's N real samples x, unscaled (irfft(rfft(x)) == N x).
// The first exchange (irfft_row_scatter) fills b with the packed bins in
// natural order; `hook` runs once it is done (a pipelined form issues the
// next row's copy into its landing buffer there); the passes (SIGN = +1)
// read the merged bins from b (MergeIn) and ping-pong between a and b;
// the last pass stores 2 z. Thread t of the row's tpr = M/16; `store`
// false stores nothing (a block's ragged row).
template <bool CONV, class Hook>
__device__ __forceinline__ void irfft_row(const float* pre, const float* pim, const float* __restrict__ bre,
                                          const float* __restrict__ bim, float scale, const int* __restrict__ perm,
                                          float2* a, float2* b, int M, const Passes& ps,
                                          const float2* __restrict__ tw, const float2* __restrict__ split,
                                          float* x, bool store, int t, int tpr, Hook hook) {
  irfft_row_scatter<CONV>(pre, pim, bre, bim, scale, perm, b, t, tpr);
  __syncthreads();
  hook();
  run_passes_to<1>(ps, MergeIn{b, split, M}, a, b, M, tw, t, tpr, NoHook{},
                   RealOut{reinterpret_cast<float2*>(x), store});
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
