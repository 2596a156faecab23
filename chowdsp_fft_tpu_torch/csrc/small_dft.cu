// Small-N direct DFT kernels for Hopper (sm_90a): complex, real forward to
// packed planes, and real inverse from packed planes.
//
// Replaces (chowdsp_fft_tpu/ops/pallas_fft.py), all three run through
// _small_call:
//   K5 small_cfft_kernel  <- _small_cfft_kernel  (via _small_cfft_pair)
//   K5 small_rfft_kernel  <- _small_rfft_kernel  (via _small_rfft_packed)
//   K5 small_irfft_kernel <- _small_irfft_kernel (via _small_irfft_packed)
//
// What they compute (the JAX package's math, natural bin order):
//   * complex: y_k = sum_j x_j W^(jk), W = exp(-+2i*pi/N), unscaled, as
//     the 4-product schoolbook (no Karatsuba: at N <= 64 the 2e-7*N
//     bound leaves under 2x margin);
//   * real forward: packed planes, re_k = sum x_n cos, im_k = sum x_n sin
//     (angle -2*pi*nk/N), with the Nyquist bin sum (-1)^n x_n in im[0];
//   * real inverse, unscaled:
//     x_n = re_0 + (-1)^n im_0 + 2 sum_{k=1}^{N/2-1} (re_k cos - im_k sin)
//     (angle +2*pi*kn/N).
//
// What bounds them on the card: FP32 arithmetic. A direct DFT costs
// 8N flops per complex output (2N per real one) against 16 bytes moved,
// so at N = 256 a row does ~2k flops per byte, far above the H100's
// FP32 balance (~20 flops per byte).
//
// Design: the full N x N table (512 KB at N = 256) does not fit shared
// memory, so a block keeps the N roots W^m (float32, built in float64 on
// the host) and indexes them by (j*k) mod N, advanced by one add and one
// compare per term. A thread owns two output bins (one for odd complex N)
// of RB = 8 rows: its sums over even and odd terms give a bin and its
// partner N/2 away (complex, real inverse) or mirrored about N/4 (real
// forward) with no further work, so each root read from shared memory
// feeds 8 rows of FMAs from registers for two outputs. A block of ~256
// threads covers max(1, 256 / threads-per-row) row groups, so small N
// still fills a block. The rows are staged in shared memory
// once (reads of one row are broadcasts across a warp).
//
// Accuracy: a plain running sum of N = 256 float32 terms leaves the
// 2e-7*N bound in the tail of a large batch (6e-5 against 5.1e-5 over
// 8192 rows, numpy emulation). Each output therefore sums its terms in
// blocks of 32, two chains (even and odd terms) per block, and adds the
// block sums into a running total: 1.5e-5 in the same emulation. No
// tensor cores, no TF32, no sinf/cosf in kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CHOWDSP_MAX_SMALL_N
#error "build with -DCHOWDSP_MAX_SMALL_N=<largest small N> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxSmallN = CHOWDSP_MAX_SMALL_N;
constexpr int kRB = 8;            // rows per thread
constexpr int kBlockTasks = 256;  // target threads per block
constexpr int kTermBlock = 32;    // terms per partial sum (even)

// Row groups per block for `tasks` outputs per row.
int groups_for(int tasks) { return tasks >= kBlockTasks ? 1 : kBlockTasks / tasks; }

__device__ __forceinline__ float2 cadd2(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }

__device__ __forceinline__ void cfma(float2& acc, float2 x, float2 w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.x = fmaf(-x.y, w.y, acc.x);
  acc.y = fmaf(x.x, w.y, acc.y);
  acc.y = fmaf(x.y, w.x, acc.y);
}

__device__ void load_roots(float2* sw, const float2* __restrict__ roots, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) sw[i] = __ldg(roots + i);
}

// Complex direct DFT. SIGN = -1 forward, +1 backward (conjugated roots).
// Rows are read and written at element stride `stride` (1: planes, 2:
// interleaved complex64). PAIR (even n): a thread owns bins k and k + n/2,
// from its even-term and odd-term sums E and O: X[k] = E + O and, since
// W^(j*(k+n/2)) = (-1)^j W^(jk), X[k + n/2] = E - O.
template <int SIGN, bool PAIR>
__global__ void small_cfft_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                                  float* __restrict__ yre, float* __restrict__ yim,
                                  int stride, int rows, int n,
                                  const float2* __restrict__ roots) {
  extern __shared__ float2 smem[];
  float2* sw = smem;
  float2* sx = smem + n;
  const int tasks = PAIR ? n / 2 : n;
  const int groups = blockDim.x / tasks;
  const int tile = groups * kRB;
  const long row0 = static_cast<long>(blockIdx.x) * tile;
  load_roots(sw, roots, n);
  for (int i = threadIdx.x; i < tile * n; i += blockDim.x) {
    const long row = row0 + i / n;
    float2 v = make_float2(0.0f, 0.0f);
    if (row < rows) {
      const long at = (row * n + i % n) * stride;
      v = make_float2(xre[at], xim[at]);
    }
    sx[i] = v;
  }
  __syncthreads();

  const int g = threadIdx.x / tasks;
  const int k = threadIdx.x - g * tasks;
  const float2* xs = sx + g * kRB * n;
  float2 even[kRB], odd[kRB];  // sums over even and odd j
#pragma unroll
  for (int r = 0; r < kRB; ++r) even[r] = odd[r] = make_float2(0.0f, 0.0f);
  int idx = 0;  // (j * k) mod n
  for (int jb = 0; jb < n; jb += kTermBlock) {  // jb is even
    const int jend = min(jb + kTermBlock, n);
    float2 acc0[kRB], acc1[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc0[r] = acc1[r] = make_float2(0.0f, 0.0f);
    int j = jb;
    for (; j + 1 < jend; j += 2) {
      float2 w0 = sw[idx];
      idx += k;
      if (idx >= n) idx -= n;
      float2 w1 = sw[idx];
      idx += k;
      if (idx >= n) idx -= n;
      if (SIGN > 0) {
        w0.y = -w0.y;
        w1.y = -w1.y;
      }
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        cfma(acc0[r], xs[r * n + j], w0);
        cfma(acc1[r], xs[r * n + j + 1], w1);
      }
    }
    if (j < jend) {  // odd n: the last term (j = n - 1 is even)
      float2 w = sw[idx];
      if (SIGN > 0) w.y = -w.y;
#pragma unroll
      for (int r = 0; r < kRB; ++r) cfma(acc0[r], xs[r * n + j], w);
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      even[r] = cadd2(even[r], acc0[r]);
      odd[r] = cadd2(odd[r], acc1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const long row = row0 + g * kRB + r;
    if (row < rows) {
      const long at = (row * n + k) * stride;
      yre[at] = even[r].x + odd[r].x;
      yim[at] = even[r].y + odd[r].y;
      if (PAIR) {
        const long half = static_cast<long>(n / 2) * stride;
        yre[at + half] = even[r].x - odd[r].x;
        yim[at + half] = even[r].y - odd[r].y;
      }
    }
  }
}

// Real forward: x (rows, N) -> packed planes (rows, N/2). With M = N/2, a
// thread owns bins k and M - k: from its sums E and O over even and odd j,
// X[k] = E + O and, x being real, X[M - k] = conj(E - O)
// (W^(j*(M-k)) = (-1)^j conj(W^(jk))). Thread k = 0 gives DC = E + O and
// the Nyquist bin E - O, which goes to im[0].
__global__ void small_rfft_kernel(const float* __restrict__ x, float* __restrict__ yre,
                                  float* __restrict__ yim, int rows, int n,
                                  const float2* __restrict__ roots) {
  extern __shared__ float2 smem[];
  float2* sw = smem;
  float* sx = reinterpret_cast<float*>(smem + n);
  const int m = n / 2;
  const int tasks = m / 2 + 1;
  const int groups = blockDim.x / tasks;
  const int tile = groups * kRB;
  const long row0 = static_cast<long>(blockIdx.x) * tile;
  load_roots(sw, roots, n);
  for (int i = threadIdx.x; i < tile * n; i += blockDim.x) {
    const long row = row0 + i / n;
    sx[i] = row < rows ? x[row * n + i % n] : 0.0f;
  }
  __syncthreads();

  const int g = threadIdx.x / tasks;
  const int k = threadIdx.x - g * tasks;
  const float* xs = sx + g * kRB * n;
  float2 even[kRB], odd[kRB];  // sums over even and odd j
#pragma unroll
  for (int r = 0; r < kRB; ++r) even[r] = odd[r] = make_float2(0.0f, 0.0f);
  int idx = 0;  // (j * k) mod n
  for (int jb = 0; jb < n; jb += kTermBlock) {  // n and kTermBlock are even
    const int jend = min(jb + kTermBlock, n);
    float2 acc0[kRB], acc1[kRB];  // the even and odd terms of this block
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc0[r] = acc1[r] = make_float2(0.0f, 0.0f);
    for (int j = jb; j < jend; j += 2) {
      const float2 w0 = sw[idx];
      idx += k;
      if (idx >= n) idx -= n;
      const float2 w1 = sw[idx];
      idx += k;
      if (idx >= n) idx -= n;
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const float a = xs[r * n + j], b = xs[r * n + j + 1];
        acc0[r].x = fmaf(a, w0.x, acc0[r].x);
        acc0[r].y = fmaf(a, w0.y, acc0[r].y);
        acc1[r].x = fmaf(b, w1.x, acc1[r].x);
        acc1[r].y = fmaf(b, w1.y, acc1[r].y);
      }
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      even[r] = cadd2(even[r], acc0[r]);
      odd[r] = cadd2(odd[r], acc1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const long row = row0 + g * kRB + r;
    if (row >= rows) continue;
    float* ore = yre + row * m;
    float* oim = yim + row * m;
    if (k == 0) {
      ore[0] = even[r].x + odd[r].x;
      oim[0] = even[r].x - odd[r].x;  // Nyquist
    } else {
      ore[k] = even[r].x + odd[r].x;
      oim[k] = even[r].y + odd[r].y;
      if (2 * k != m) {
        ore[m - k] = even[r].x - odd[r].x;
        oim[m - k] = odd[r].y - even[r].y;
      }
    }
  }
}

// Real inverse: packed planes (rows, N/2) -> x (rows, N), unscaled. A
// thread owns samples t and t + N/2: with S and D its sums over odd and
// even k, x[t] uses S + D and x[t + N/2] uses D - S (W^(k*N/2) = (-1)^k).
__global__ void small_irfft_kernel(const float* __restrict__ yre, const float* __restrict__ yim,
                                   float* __restrict__ x, int rows, int n,
                                   const float2* __restrict__ roots) {
  extern __shared__ float2 smem[];
  float2* sw = smem;
  const int m = n / 2;
  const int groups = blockDim.x / m;
  const int tile = groups * kRB;
  float* sre = reinterpret_cast<float*>(smem + n);
  float* sim = sre + tile * m;
  const long row0 = static_cast<long>(blockIdx.x) * tile;
  load_roots(sw, roots, n);
  for (int i = threadIdx.x; i < tile * m; i += blockDim.x) {
    const long row = row0 + i / m;
    const bool in = row < rows;
    sre[i] = in ? yre[row * m + i % m] : 0.0f;
    sim[i] = in ? yim[row * m + i % m] : 0.0f;
  }
  __syncthreads();

  const int g = threadIdx.x / m;
  const int t = threadIdx.x - g * m;  // output samples t and t + m
  const float* rs = sre + g * kRB * m;
  const float* is = sim + g * kRB * m;
  float odd[kRB], even[kRB];  // sums over odd and even k
#pragma unroll
  for (int r = 0; r < kRB; ++r) odd[r] = even[r] = 0.0f;
  // sum_k (re_k cos(2*pi*k*t/N) - im_k sin(2*pi*k*t/N)), k >= 1; with
  // W^m = exp(-2i*pi*m/N) that is re_k W.x + im_k W.y.
  int idx = t;  // (k * t) mod n at k = 1
  for (int kb = 1; kb < m; kb += kTermBlock) {  // kb is odd
    const int kend = min(kb + kTermBlock, m);
    float acc0[kRB], acc1[kRB];  // odd k, even k
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc0[r] = acc1[r] = 0.0f;
    int k = kb;
    for (; k + 1 < kend; k += 2) {
      const float2 w0 = sw[idx];
      idx += t;
      if (idx >= n) idx -= n;
      const float2 w1 = sw[idx];
      idx += t;
      if (idx >= n) idx -= n;
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        acc0[r] = fmaf(rs[r * m + k], w0.x, acc0[r]);
        acc0[r] = fmaf(is[r * m + k], w0.y, acc0[r]);
        acc1[r] = fmaf(rs[r * m + k + 1], w1.x, acc1[r]);
        acc1[r] = fmaf(is[r * m + k + 1], w1.y, acc1[r]);
      }
    }
    if (k < kend) {
      const float2 w = sw[idx];
      idx += t;
      if (idx >= n) idx -= n;
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        acc0[r] = fmaf(rs[r * m + k], w.x, acc0[r]);
        acc0[r] = fmaf(is[r * m + k], w.y, acc0[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      odd[r] += acc0[r];
      even[r] += acc1[r];
    }
  }
  const float alt = (t & 1) ? -1.0f : 1.0f;
  const float alt_half = ((t + m) & 1) ? -1.0f : 1.0f;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const long row = row0 + g * kRB + r;
    if (row < rows) {
      x[row * n + t] = rs[r * m] + alt * is[r * m] + 2.0f * (odd[r] + even[r]);
      x[row * n + t + m] = rs[r * m] + alt_half * is[r * m] + 2.0f * (even[r] - odd[r]);
    }
  }
}

int grid_for(int rows, int tile) { return (rows + tile - 1) / tile; }

}  // namespace

extern "C" {

int hopper_small_dft_max_n() { return kMaxSmallN; }

// Complex. sign = -1 forward, +1 backward; stride 1 (planes) or 2
// (complex64); roots = W^m, m in [0, n), as float2. Returns a
// cudaError_t value; 0 means the launch was accepted.
int k5_small_cfft(const float* xre, const float* xim, float* yre, float* yim, int stride,
                  int rows, int n, int sign, const void* roots, void* stream) {
  if (n < 2 || n > kMaxSmallN || (stride != 1 && stride != 2) || (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const bool pair = n % 2 == 0;
  const int tasks = pair ? n / 2 : n;
  const int groups = groups_for(tasks);
  const int tile = groups * kRB;
  const dim3 grid(grid_for(rows, tile)), block(groups * tasks);
  const size_t smem = static_cast<size_t>(n + tile * n) * sizeof(float2);
  const float2* w = static_cast<const float2*>(roots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sign < 0 && pair)
    small_cfft_kernel<-1, true><<<grid, block, smem, s>>>(xre, xim, yre, yim, stride, rows, n, w);
  else if (sign < 0)
    small_cfft_kernel<-1, false><<<grid, block, smem, s>>>(xre, xim, yre, yim, stride, rows, n, w);
  else if (pair)
    small_cfft_kernel<1, true><<<grid, block, smem, s>>>(xre, xim, yre, yim, stride, rows, n, w);
  else
    small_cfft_kernel<1, false><<<grid, block, smem, s>>>(xre, xim, yre, yim, stride, rows, n, w);
  return static_cast<int>(cudaGetLastError());
}

// Real forward.
int k5_small_rfft(const float* x, float* yre, float* yim, int rows, int n,
                  const void* roots, void* stream) {
  if (n < 4 || n > kMaxSmallN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int tasks = n / 4 + 1;  // bins k and N/2 - k per thread
  const int groups = groups_for(tasks);
  const int tile = groups * kRB;
  const size_t smem = n * sizeof(float2) + static_cast<size_t>(tile) * n * sizeof(float);
  small_rfft_kernel<<<grid_for(rows, tile), groups * tasks, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, yre, yim, rows, n, static_cast<const float2*>(roots));
  return static_cast<int>(cudaGetLastError());
}

// Real inverse.
int k5_small_irfft(const float* yre, const float* yim, float* x, int rows, int n,
                   const void* roots, void* stream) {
  if (n < 4 || n > kMaxSmallN || n % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int groups = groups_for(n / 2);
  const int tile = groups * kRB;
  const size_t smem = n * sizeof(float2) + static_cast<size_t>(tile) * n * sizeof(float);
  small_irfft_kernel<<<grid_for(rows, tile), groups * (n / 2), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      yre, yim, x, rows, n, static_cast<const float2*>(roots));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
