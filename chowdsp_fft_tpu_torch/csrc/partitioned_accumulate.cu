// The offline frequency-domain delay line (FDL) for Hopper (sm_90a): every
// partition of a uniformly partitioned convolution summed in one pass.
//
// Replaces no Pallas kernel. The JAX package leaves this sum to XLA's
// fusion (chowdsp_fft_tpu/stream/ols.py:177-195, apply_offline's loop of
// shifted copies and packed products); on the card the same loop in plain
// torch cost one padded copy of both spectrum planes and five full-plane
// ops per partition. This kernel computes, for every stream s, block b and
// packed slot k,
//
//   Y[s, b, k] = scale * sum_{p = 0}^{min(P-1, b)} X[s, b-p, k] (.) H[s_h, p, k]
//
// where (.) is the packed product (complex, except slot 0, which packs DC
// in re and Nyquist in im: two real products there), s_h is s for a filter
// per stream and 0 for a shared one. X and H stay in the unordered packed
// layout K1 writes: the product does not depend on slot order, and slot 0
// is index 0 in every order.
//
// What bounds it on the card: bytes. It must read X and H once and write Y
// once; at the reverb's shape (64 streams x 118 blocks x 4096 slots, P = 24)
// that is 247.5 + 50.3 + 247.5 MB, 0.163 ms at 3.35 TB/s, against 5.36
// GFLOP of FMAs, 0.08 ms at 67 TFLOP/s.
//
// Design. A thread owns one slot of one stream and walks a run of blocks
// in order (coalesced along k: a warp reads 128 B of each plane per row).
// It holds the filter slots of up to PC = 8 G partitions in registers and
// reads each input row once, adding its products into the PC outputs that
// row feeds: a ring of PC accumulators in registers, in G sub-rings of 8.
// The row walk is unrolled by 8, so every ring index is static and nothing
// spills to local memory. When a row is done, output b = j + p_lo is
// complete in sub-ring 0 and is stored; the completed slot of sub-ring g
// moves to sub-ring g-1, whose freed slot holds the output sub-ring g just
// finished (each output passes through the sub-rings from the last
// partitions to the first). The next 8 rows are loaded while the current
// 8 compute (measured on the H100 at the reverb's shape: 0.235 ms, 69% of
// the bound, against 0.289 ms loading each batch just before its FMAs;
// 156-168 registers at 3 sub-rings, so 3 blocks an SM: capping them at
// 128 for a 4th block spilled and ran 0.39 ms; 64-thread blocks ran the
// same). With more than PC partitions the thread walks the run again
// per chunk of PC and adds into the outputs it wrote itself (one fixed
// order, no atomics). A run shorter than the stream re-reads the PC-1 rows
// before it (the wrapper splits streams into runs only when there are too
// few streams to fill the card). FP32 FMA only: no TF32, no tensor cores.
// The 1/N scale and the slot-0 patch are folded in; ragged slot counts are
// masked. The kernel allocates nothing; the wrapper allocates Y.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;  // slots of a block
constexpr int kRing = 8;       // partitions of a sub-ring, and the unroll of the row walk
constexpr int kMaxGroups = 4;  // sub-rings: up to 32 partitions in registers

template <int G>
__global__ void __launch_bounds__(kThreads)
partitioned_accumulate_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                              const float* __restrict__ hre, const float* __restrict__ him,
                              float* __restrict__ yre, float* __restrict__ yim, int nb, int m,
                              int partitions, int shared_filter, int run, int runs, int tiles, float scale) {
  constexpr int PC = G * kRing;
  const int tile = blockIdx.x % tiles;
  const int rest = blockIdx.x / tiles;
  const int s = rest / runs;
  const int k = tile * kThreads + threadIdx.x;
  if (k >= m) return;
  const int b0 = (rest % runs) * run;
  const int b1 = min(nb, b0 + run);
  const size_t base = static_cast<size_t>(s) * nb * m + k;
  const float* xr = xre + base;
  const float* xi = xim + base;
  float* yr = yre + base;
  float* yi = yim + base;
  const size_t hbase = static_cast<size_t>(shared_filter ? 0 : s) * partitions * m + k;
  const float* hr_in = hre + hbase;
  const float* hi_in = him + hbase;
  const bool dc = k == 0;

  for (int p_lo = 0; p_lo < min(partitions, b1); p_lo += PC) {
    float hr[G][kRing], hi[G][kRing], ar[G][kRing], ai[G][kRing];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int u = 0; u < kRing; ++u) {
        const int p = p_lo + g * kRing + u;
        hr[g][u] = p < partitions ? __ldg(hr_in + static_cast<size_t>(p) * m) : 0.f;
        hi[g][u] = p < partitions ? __ldg(hi_in + static_cast<size_t>(p) * m) : 0.f;
        ar[g][u] = 0.f;
        ai[g][u] = 0.f;
      }
    }
    // Rows j in [j0, j1) feed the outputs b in [b0, b1) through this chunk.
    const int j0 = max(0, b0 - p_lo - PC + 1);
    const int j1 = b1 - p_lo;
    float nr8[kRing], ni8[kRing];
#pragma unroll
    for (int t = 0; t < kRing; ++t) {
      const bool in = j0 + t < j1;
      nr8[t] = in ? __ldg(xr + static_cast<size_t>(j0 + t) * m) : 0.f;
      ni8[t] = in ? __ldg(xi + static_cast<size_t>(j0 + t) * m) : 0.f;
    }
    for (int jj = j0; jj < j1; jj += kRing) {
      float xr8[kRing], xi8[kRing];
#pragma unroll
      for (int t = 0; t < kRing; ++t) {
        xr8[t] = nr8[t];
        xi8[t] = ni8[t];
        const int jn = jj + kRing + t;
        const bool in = jn < j1;
        nr8[t] = in ? __ldg(xr + static_cast<size_t>(jn) * m) : 0.f;
        ni8[t] = in ? __ldg(xi + static_cast<size_t>(jn) * m) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kRing; ++t) {
        // y.re += a.re h.re - a.im h.im, y.im += c.re h.im + c.im h.re: the
        // complex product with a = c = x, and at slot 0 the two real
        // products y.re += x.re h.re, y.im += x.im h.im (a = (x.re, 0),
        // c = (x.im, 0)).
        const float a_r = xr8[t], a_i = dc ? 0.f : xi8[t];
        const float c_r = dc ? xi8[t] : xr8[t], c_i = dc ? 0.f : xi8[t];
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int u = 0; u < kRing; ++u) {
            const int i = (t + u) % kRing;  // output j + p_lo + 8g + u
            ar[g][i] = fmaf(a_r, hr[g][u], ar[g][i]);
            ar[g][i] = fmaf(-a_i, hi[g][u], ar[g][i]);
            ai[g][i] = fmaf(c_r, hi[g][u], ai[g][i]);
            ai[g][i] = fmaf(c_i, hr[g][u], ai[g][i]);
          }
        }
        const int j = jj + t;
        const int b = j + p_lo;  // complete in sub-ring 0
        if (j < j1 && b >= b0) {
          const size_t at = static_cast<size_t>(b) * m;
          const float vr = ar[0][t] * scale, vi = ai[0][t] * scale;
          if (p_lo == 0) {
            yr[at] = vr;
            yi[at] = vi;
          } else {
            yr[at] += vr;
            yi[at] += vi;
          }
        }
#pragma unroll
        for (int g = 0; g + 1 < G; ++g) {
          ar[g][t] = ar[g + 1][t];
          ai[g][t] = ai[g + 1][t];
        }
        ar[G - 1][t] = 0.f;
        ai[G - 1][t] = 0.f;
      }
    }
  }
}

template <int G>
cudaError_t launch(const float* xre, const float* xim, const float* hre, const float* him, float* yre,
                   float* yim, int nb, int m, int partitions, int shared_filter, int run, int runs, int tiles,
                   float scale, unsigned blocks, cudaStream_t stream) {
  partitioned_accumulate_kernel<G><<<blocks, kThreads, 0, stream>>>(
      xre, xim, hre, him, yre, yim, nb, m, partitions, shared_filter, run, runs, tiles, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Y = scale * sum_p X[b-p] (.) H[p] on (streams, nb, m) planes x and y and
// (1 or streams, partitions, m) planes h (shared_filter: one filter for
// every stream). groups: sub-rings of 8 partitions held in registers
// (1..4); run: blocks a thread walks (the last run may be shorter).
int partitioned_accumulate(const float* xre, const float* xim, const float* hre, const float* him, float* yre,
                           float* yim, int streams, int nb, int m, int partitions, int shared_filter, int groups,
                           int run, float scale, cudaStream_t stream) {
  if (streams <= 0 || nb <= 0 || m <= 0 || partitions <= 0 || run <= 0 || groups < 1 || groups > kMaxGroups)
    return cudaErrorInvalidValue;
  const int tiles = (m + kThreads - 1) / kThreads;
  const int runs = (nb + run - 1) / run;
  const long long blocks = static_cast<long long>(streams) * runs * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (groups) {
    case 1:
      return launch<1>(xre, xim, hre, him, yre, yim, nb, m, partitions, shared_filter, run, runs, tiles, scale,
                       grid, stream);
    case 2:
      return launch<2>(xre, xim, hre, him, yre, yim, nb, m, partitions, shared_filter, run, runs, tiles, scale,
                       grid, stream);
    case 3:
      return launch<3>(xre, xim, hre, him, yre, yim, nb, m, partitions, shared_filter, run, runs, tiles, scale,
                       grid, stream);
    default:
      return launch<4>(xre, xim, hre, him, yre, yim, nb, m, partitions, shared_filter, run, runs, tiles, scale,
                       grid, stream);
  }
}

}  // extern "C"
