// The packed spectral product for Hopper (sm_90a): convolve_accumulate_packed
// (ops/convolve.py) on CUDA tensors, the per-channel product of
// fir_filter_ols and of PartitionedFIR.step / step_k.
//
// Replaces no Pallas kernel. The JAX package leaves the product to XLA
// (chowdsp_fft_tpu/ops/convolve.py, convolve_accumulate_packed: elementwise
// ops). On the card the same function ran as 12 plain-torch ops (four
// broadcast multiplies, a subtract, an add, two slot-0 multiplies, two
// plane-sized cats for the DC/Nyquist patch-up, two scale multiplies), each
// writing a whole plane. This kernel computes, in one pass over packed
// planes a (outer, inner, M), b (outer, M) and an optional accumulator c
// (outer, inner, M),
//
//   y[o, f] = c[o, f] + scale * (a[o, f] (.) b[o]),
//
// (.) the packed product: a complex product in every slot but slot 0, where
// DC (re) and Nyquist (im) are two real products. Every operation rounds
// as the plain ops round it, in their order (__fmul_rn, __fsub_rn,
// __fadd_rn: no FMA contraction; the product, then the scale, then c +), so
// y is the plain version's bit for bit. A unit scale is a multiply by 1,
// which is exact.
//
// What bounds it on the card: bytes. The long-IR cell's product (a 64 x 2 x
// 2^18 per plane, b 64 x 2^18) reads a once (268.4 MB), b once (134.2 MB)
// and writes y once (268.4 MB): 671 MB, 0.200 ms at 3.35 TB/s, against 8
// operations a slot.
//
// Design. Every plane is contiguous; b is broadcast over the inner (frame)
// axis: a filter per stream (outer streams), one filter for all (outer 1),
// or a matched batch (inner 1). A unit is kWidth consecutive slots of one
// outer index and a chunk of `frames` consecutive frames. A thread takes
// units in a grid-stride loop (slots fastest, so a warp's accesses are
// consecutive), loads b once for the unit into registers and walks the
// chunk's frames, so b is read once per chunk and not once per frame.
// kWidth 4 takes 16-byte loads and stores and needs M and every pointer in
// whole float4s; anything else takes kWidth 1 (the wrapper chooses, the
// entry refuses a width the layout does not allow). kMinBlocks holds a
// thread to 64 registers, so at least 4 blocks reside on an SM. The scale
// is a number or one float on the device, read through a pointer (no host
// sync). The kernel allocates nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kMinBlocks = 4;   // blocks an SM at least (__launch_bounds__)
constexpr int kWide = 4;        // slots a unit where the layout allows float4s

__host__ __device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int kWidth>
__device__ __forceinline__ void load(float (&v)[kWidth], const float* p) {
  if constexpr (kWidth == kWide) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else {
    v[0] = *p;
  }
}

template <int kWidth>
__device__ __forceinline__ void store(float* p, const float (&v)[kWidth]) {
  if constexpr (kWidth == kWide)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

template <int kWidth>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
packed_product_kernel(const float* __restrict__ are, const float* __restrict__ aim, const float* __restrict__ bre,
                      const float* __restrict__ bim, const float* __restrict__ cre, const float* __restrict__ cim,
                      float* __restrict__ yre, float* __restrict__ yim, long long inner, int m, int frames,
                      long long chunks, float scale, const float* __restrict__ scale_ptr, long long units) {
  const int vecs = m / kWidth;
  const float s = scale_ptr != nullptr ? *scale_ptr : scale;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; u < units; u += step) {
    const int slot = static_cast<int>(u % vecs) * kWidth;
    const long long rest = u / vecs;
    const long long f0 = (rest % chunks) * frames, o = rest / chunks;
    const long long f1 = f0 + frames < inner ? f0 + frames : inner;
    float br[kWidth], bm[kWidth];
    load(br, bre + o * m + slot);
    load(bm, bim + o * m + slot);
    for (long long f = f0; f < f1; ++f) {
      const long long at = (o * inner + f) * m + slot;
      float xr[kWidth], xm[kWidth], pr[kWidth], pm[kWidth];
      load(xr, are + at);
      load(xm, aim + at);
#pragma unroll
      for (int e = 0; e < kWidth; ++e) {
        if (slot + e == 0) {  // DC * DC, Nyquist * Nyquist
          pr[e] = __fmul_rn(xr[e], br[e]);
          pm[e] = __fmul_rn(xm[e], bm[e]);
        } else {
          pr[e] = __fsub_rn(__fmul_rn(xr[e], br[e]), __fmul_rn(xm[e], bm[e]));
          pm[e] = __fadd_rn(__fmul_rn(xr[e], bm[e]), __fmul_rn(xm[e], br[e]));
        }
        pr[e] = __fmul_rn(pr[e], s);
        pm[e] = __fmul_rn(pm[e], s);
      }
      if (cre != nullptr) {
        float cr[kWidth], cm[kWidth];
        load(cr, cre + at);
        load(cm, cim + at);
#pragma unroll
        for (int e = 0; e < kWidth; ++e) {
          pr[e] = __fadd_rn(cr[e], pr[e]);
          pm[e] = __fadd_rn(cm[e], pm[e]);
        }
      }
      store(yre + at, pr);
      store(yim + at, pm);
    }
  }
}

}  // namespace

extern "C" {

// y = c + scale (a (.) b) over contiguous planes: a, c and y (outer, inner,
// m), b (outer, m) broadcast over inner (cre = cim = NULL: no accumulator).
// scale_ptr: one float on the device, or NULL for `scale`. frames: inner
// indices a unit walks; width: kWide or 1 (kWide needs m and every pointer
// in whole float4s); blocks: the grid of the grid-stride loop.
int packed_product(const float* are, const float* aim, const float* bre, const float* bim, const float* cre,
                   const float* cim, float* yre, float* yim, long long outer, long long inner, int m, int frames,
                   int width, float scale, const float* scale_ptr, int blocks, cudaStream_t stream) {
  if (outer <= 0 || inner <= 0 || m <= 0 || frames <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  if ((cre == nullptr) != (cim == nullptr)) return cudaErrorInvalidValue;
  if (width == kWide) {
    const void* ptrs[] = {are, aim, bre, bim, cre, cim, yre, yim};
    for (const void* p : ptrs)
      if (!aligned(p, 16)) return cudaErrorMisalignedAddress;
    if (m % kWide) return cudaErrorMisalignedAddress;
  } else if (width != 1) {
    return cudaErrorInvalidValue;
  }
  const long long chunks = (inner + frames - 1) / frames;
  const long long units = outer * chunks * (m / width);
  if (blocks > (units + kThreads - 1) / kThreads) return cudaErrorInvalidConfiguration;
  if (width == kWide)
    packed_product_kernel<kWide><<<blocks, kThreads, 0, stream>>>(are, aim, bre, bim, cre, cim, yre, yim, inner, m,
                                                                  frames, chunks, scale, scale_ptr, units);
  else
    packed_product_kernel<1><<<blocks, kThreads, 0, stream>>>(are, aim, bre, bim, cre, cim, yre, yim, inner, m,
                                                              frames, chunks, scale, scale_ptr, units);
  return cudaGetLastError();
}

}  // extern "C"
