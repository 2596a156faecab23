// The quadrature FM discriminator for Hopper (sm_90a): the SDR chain's
// per-channel demodulator (models/sdr.py, stream/demod.fm_demod).
//
// Replaces no Pallas kernel. The JAX package leaves the discriminator to
// XLA (chowdsp_fft_tpu/stream/demod.py, fm_demod: elementwise ops). On the
// card the same ops ran as 12 strided elementwise torch kernels on the
// channelizer's transposed output (the real and imaginary views, two pads,
// three multiplies, an add, a subtract, atan2, the gain), each at
// PyTorch's index-computing rate for strided operands. This kernel
// computes, for every row of z (batch, rows, T), in FP32,
//
//   y[n] = gain * atan2(Im z[n] conj(z[n-1]), Re z[n] conj(z[n-1])),   y[0] = 0,
//
// reading z where it lies and writing y at the strides the wrapper gives
// (those of z, for a dense z). The products and their sum round as the
// plain ops round them (__fmul_rn, __fadd_rn, __fsub_rn: no FMA
// contraction), atan2f is the CUDA math library's (no fast math) and the
// gain is one FP32 multiply, so that a step with Re < 0 and Im near 0
// (noise on the +-pi branch cut) lands on the same side as in the plain
// version.
//
// What bounds it on the card: bytes. It reads 8 bytes and writes 4 a
// sample: at the chain's 256 x 32768, 100.7 MB, 0.030 ms at 3.35 TB/s,
// against some 40 instructions a sample (atan2f's polynomial), which the
// loads hide.
//
// Design. The threads span the axis whose stride is the smaller, so that
// a warp's accesses are consecutive; each thread keeps z[n-1] in
// registers, so that the previous sample is read once a run, not once a
// sample, and starts all of its run's loads before its arithmetic.
//
// - kRowsFast (rows lie closer together than samples: the channelizer's
//   channel-fastest view, row stride 1): a thread owns 2 neighbouring rows
//   and a run of kRun consecutive steps. A warp spans 64 neighbouring
//   rows, so each step is one 512-byte read (16 bytes a thread) and one
//   256-byte write (8 bytes a thread). The step before the run is read
//   once more, mostly from L2 (the run before reads it too). Short runs
//   keep registers, and so occupancy, up: at the chain's shape 4 steps
//   took 0.039 ms, 8 0.041, 16 0.050 and 32 0.072 (H100, graph replay).
// - kTimeFast (contiguous rows, a single row, any other layout): a warp
//   owns a segment of kSegment consecutive samples of one row; in
//   iteration i lane l holds samples 2 (32 i + l) and 2 (32 i + l) + 1 of
//   it, so each iteration is one 512-byte read. The predecessor of a
//   lane's first sample is lane l - 1's second (a shuffle), lane 0's is
//   lane 31's of the iteration before, and the segment's first is read
//   once from memory.
//
// 16-byte loads (8-byte stores) of two samples where the stride is unit
// and the address aligned, else a float2 load (a float store) a sample.
// Strides are runtime 64-bit ints, in complex elements for z and floats
// for y. The layout follows from the strides alone (the wrapper passes it,
// and the entry refuses another); the kernel allocates nothing.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;                // threads a block
constexpr int kRun = 4;                      // steps a thread walks (kRowsFast)
constexpr int kIters = 8;                    // iterations of a warp over its segment (kTimeFast)
constexpr int kSegment = kIters * 32 * 2;    // samples a warp's segment (kTimeFast)
constexpr int kRowsFast = 0;
constexpr int kTimeFast = 1;
constexpr unsigned kFull = 0xffffffffu;

// The threads span rows where rows lie closer together than samples.
__host__ __device__ constexpr int layout_of(int rows, long long row_stride, long long sample_stride) {
  return rows > 1 && row_stride < sample_stride ? kRowsFast : kTimeFast;
}

__host__ __device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// gain * angle(z conj(p)), rounded step by step as the plain ops round it.
__device__ __forceinline__ float discriminate(float2 z, float2 p, float gain) {
  const float dr = __fadd_rn(__fmul_rn(z.x, p.x), __fmul_rn(z.y, p.y));
  const float di = __fsub_rn(__fmul_rn(z.y, p.x), __fmul_rn(z.x, p.y));
  return __fmul_rn(gain, atan2f(di, dr));
}

// Samples n of rows r (at p) and r + 1 (at p + row_stride; zero where
// there is none): one 16-byte load where the two lie side by side.
__device__ __forceinline__ void load_pair(float2 (&v)[2], const float2* p, long long row_stride, bool two, bool wide) {
  if (wide) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = make_float2(w.x, w.y), v[1] = make_float2(w.z, w.w);
  } else {
    v[0] = __ldg(p);
    v[1] = two ? __ldg(p + row_stride) : make_float2(0.f, 0.f);
  }
}

template <int kLayout>
__global__ void __launch_bounds__(kThreads)
fm_demod_kernel(const float2* __restrict__ z, float* __restrict__ y, int rows, int t, long long zb, long long zr,
                long long zt, long long yb, long long yr, long long yt, float gain, long long units) {
  const long long id = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (kLayout == kRowsFast) {
    // Unit id = ((b * runs) + run) * pairs + pair: a warp's lanes take
    // neighbouring pairs of rows.
    if (id >= units) return;
    const int pairs = (rows + 1) / 2, runs = (t + kRun - 1) / kRun;
    const int r = 2 * static_cast<int>(id % pairs);
    const long long rest = id / pairs;
    const int n0 = static_cast<int>(rest % runs) * kRun;
    const long long b = rest / runs;
    const float2* zp = z + b * zb + r * zr;
    float* yp = y + b * yb + r * yr;
    const bool two = r + 1 < rows;
    const bool wide_in = two && zr == 1 && (zt & 1) == 0 && aligned(zp, 16);
    const bool wide_out = two && yr == 1 && (yt & 1) == 0 && aligned(yp, 8);

    float2 prev[2] = {}, cur[kRun][2];
    if (n0 > 0) load_pair(prev, zp + (n0 - 1) * zt, zr, two, wide_in);
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (n0 + k < t) load_pair(cur[k], zp + (n0 + k) * zt, zr, two, wide_in);
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int n = n0 + k;
      if (n >= t) break;
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        out[e] = n == 0 ? 0.f : discriminate(cur[k][e], prev[e], gain);
        prev[e] = cur[k][e];
      }
      float* o = yp + n * yt;
      if (wide_out) {
        *reinterpret_cast<float2*>(o) = make_float2(out[0], out[1]);
      } else {
        o[0] = out[0];
        if (two) o[yr] = out[1];
      }
    }
  } else {
    // Warp id = ((b * rows) + r) * segments + segment; whole warps leave
    // together (the launch rounds up in whole warps), so every lane that
    // stays takes part in the shuffles.
    const long long warp = id / 32;
    const int lane = threadIdx.x & 31;
    if (warp >= units) return;
    const int segments = (t + kSegment - 1) / kSegment;
    const int s0 = static_cast<int>(warp % segments) * kSegment;
    const long long rest = warp / segments;
    const int r = static_cast<int>(rest % rows);
    const long long b = rest / rows;
    const float2* zp = z + b * zb + r * zr;
    float* yp = y + b * yb + r * yr;
    const bool wide_in = zt == 1 && aligned(zp, 16);
    const bool wide_out = yt == 1 && aligned(yp, 8);

    float2 cur[kIters][2];
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int n = s0 + 2 * (32 * i + lane);
      if (n + 1 < t && wide_in) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(zp + n));
        cur[i][0] = make_float2(w.x, w.y), cur[i][1] = make_float2(w.z, w.w);
      } else {
        cur[i][0] = n < t ? __ldg(zp + n * zt) : make_float2(0.f, 0.f);
        cur[i][1] = n + 1 < t ? __ldg(zp + (n + 1) * zt) : make_float2(0.f, 0.f);
      }
    }
    // The sample before lane 0's first: before the segment, then lane 31's last.
    float2 carry = lane == 0 && s0 > 0 ? __ldg(zp + (s0 - 1) * zt) : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      float2 p = make_float2(__shfl_up_sync(kFull, cur[i][1].x, 1), __shfl_up_sync(kFull, cur[i][1].y, 1));
      if (lane == 0) p = carry;
      carry = make_float2(__shfl_sync(kFull, cur[i][1].x, 31), __shfl_sync(kFull, cur[i][1].y, 31));
      const int n = s0 + 2 * (32 * i + lane);
      if (n >= t) continue;
      const float out0 = n == 0 ? 0.f : discriminate(cur[i][0], p, gain);
      const float out1 = discriminate(cur[i][1], cur[i][0], gain);
      float* o = yp + n * yt;
      if (n + 1 < t && wide_out) {
        *reinterpret_cast<float2*>(o) = make_float2(out0, out1);
      } else {
        o[0] = out0;
        if (n + 1 < t) o[yt] = out1;
      }
    }
  }
}

}  // namespace

extern "C" {

// y = the discriminator over each row of z (batch, rows, t): z[b, r, n] at
// z + 2 (b zb + r zr + n zt) floats (a complex64 tensor's data), y[b, r, n]
// at y + b yb + r yr + n yt. layout: the one layout_of gives (kRowsFast 0,
// kTimeFast 1); any other is refused.
int fm_demod(const float* z, float* y, int batch, int rows, int t, long long zb, long long zr, long long zt,
             long long yb, long long yr, long long yt, float gain, int layout, cudaStream_t stream) {
  if (batch <= 0 || rows <= 0 || t <= 0 || !aligned(z, 8) || !aligned(y, 4)) return cudaErrorInvalidValue;
  if (layout != layout_of(rows, zr, zt)) return cudaErrorInvalidConfiguration;
  const auto* zc = reinterpret_cast<const float2*>(z);
  long long units, threads;
  if (layout == kRowsFast) {
    units = static_cast<long long>(batch) * ((rows + 1) / 2) * ((t + kRun - 1) / kRun);
    threads = units;
  } else {
    units = static_cast<long long>(batch) * rows * ((t + kSegment - 1) / kSegment);
    threads = 32 * units;
  }
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (layout == kRowsFast)
    fm_demod_kernel<kRowsFast><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        zc, y, rows, t, zb, zr, zt, yb, yr, yt, gain, units);
  else
    fm_demod_kernel<kTimeFast><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        zc, y, rows, t, zb, zr, zt, yb, yr, yt, gain, units);
  return cudaGetLastError();
}

}  // extern "C"
