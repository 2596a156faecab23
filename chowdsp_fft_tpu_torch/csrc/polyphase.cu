// Polyphase FIR decimation for Hopper (sm_90a): the SDR chain's two
// decimators (models/sdr.py: the wideband front end and the audio filter).
//
// Replaces no Pallas kernel. The JAX package leaves the strided
// convolution to XLA (chowdsp_fft_tpu/stream/polyphase.py, _conv_valid:
// lax.conv_general_dilated on overlapped frames). On the card the same
// path ran as a padded, framed copy of the stream (stream.ols's
// _frame_overlap: pad, fill, cat) and cuDNN's grouped direct convolution
// on the frames. This kernel computes, for every row b and every kept
// output m < T / f, with zero initial state,
//
//   y[b, m] = sum_{k < taps} h[k] * x[b, m f - k],   x[b, n < 0] = 0,
//
// reading each row where it lies, at any row and sample stride: no
// frames, no padded or contiguous copy. (The chain's audio filter reads
// the discriminator's output, which lies channel-fastest: a sample
// stride of 256.)
//
// What bounds it on the card: bytes. It must read x once and write y once:
// at the chain's shapes, 2 x 2^24 samples in and 2 x 2^23 out (front end,
// f = 2, 64 taps) and 256 x 32768 in, 256 x 8192 out (audio, f = 4, 64
// taps), 243.3 MB, 0.0726 ms at 3.35 TB/s, against 1.21 G FMAs (2.41
// GFLOP), 0.036 ms at 67 TFLOP/s.
//
// Design. A block owns a tile of consecutive outputs of `rows_per_block`
// rows (one where samples are consecutive, else up to 8). It stages the
// tile's input span [m0 f - (J-1), (m0 + tile) f) of each of its rows in
// shared memory once, phase-major: the samples of phase p = n mod f lie
// together, so that each phase is a plain 1-D correlation with its own
// taps. Where the block's samples form one dense run (a row of
// consecutive samples, or rows interleaved sample by sample, as I and Q
// in the capture), it loads the run in 16-byte chunks (the left edge of
// the stream and the ragged right end zero-filled, the chunks that
// straddle them loaded a float at a time); else it walks (rows, phase,
// index) items with the index fastest, so that a warp's shared stores
// fall on consecutive banks, loading 4 rows a sample in 16 bytes where
// the rows lie next to each other (the audio filter's channel-fastest
// input), else a float at a time. Each thread keeps kLoads loads in
// flight. The taps are staged once, reversed and phase-major, padded
// with zeros to J = f * Q taps (Q taps a phase, a multiple of kOut). A
// thread computes kOut consecutive outputs of one row: per phase it holds
// a register window of 2 kOut samples and kOut taps, loaded as float4s,
// and does kOut * kOut FMAs for each 2 kOut values it loads, so shared
// memory stays off the critical path. Each phase's span has 4 pad floats
// after every 32, so the float4 windows of threads t and t + 4 (32
// floats apart) fall on different banks. Stores are float4s,
// consecutive across a row's threads. Sums are float32 FMAs: no TF32, no
// tensor cores. Factor, taps and strides are runtime ints; the block
// (128, 64 or 32 threads, rows a block) comes from them alone, and
// shrinks only where the spans would pass 48 KB of shared memory, so
// every (rows, T, f, taps, strides) of the domain has one geometry. The
// kernel allocates nothing; the wrapper allocates y.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#ifndef CHOWDSP_MAX_DECIM_TAPS
#error "build with -DCHOWDSP_MAX_DECIM_TAPS=<longest filter> (ops/_cuda.py passes it)"
#endif
#ifndef CHOWDSP_MAX_DECIM_FACTOR
#error "build with -DCHOWDSP_MAX_DECIM_FACTOR=<largest factor> (ops/_cuda.py passes it)"
#endif

namespace {

constexpr int kMaxTaps = CHOWDSP_MAX_DECIM_TAPS;
constexpr int kMaxFactor = CHOWDSP_MAX_DECIM_FACTOR;
constexpr int kOut = 8;                // consecutive outputs a thread; taps a phase come in multiples of it
constexpr int kMaxThreads = 128;       // the largest block; 64 and 32 where the span would not fit
constexpr int kMaxRowsPerBlock = 8;    // rows a block stages together where samples are not consecutive
constexpr int kSmemLimit = 48 * 1024;  // dynamic shared memory allowed without opting in
constexpr int kLoads = 4;              // loads a thread keeps in flight while staging

// Taps a phase, padded to whole windows: ceil(ceil(taps / f) / kOut) * kOut.
__host__ __device__ constexpr int phase_taps(int factor, int taps) {
  return ((taps + factor - 1) / factor + kOut - 1) / kOut * kOut;
}

// Shared offset of sample i of a phase's span: 4 pad floats after each 32.
__host__ __device__ constexpr int padded(int i) { return i + ((i >> 5) << 2); }

constexpr int smem_bytes(int factor, int taps, int threads, int rows_per_block) {
  const int q = phase_taps(factor, taps);
  return 4 * factor * (q + rows_per_block * padded(threads / rows_per_block * kOut + q));
}

struct Geometry {
  int threads;
  int rows_per_block;
};

// The block: as many rows as fit (up to 8, and no more than the rows'
// next power of two) where samples are not consecutive, one where they
// are; then the most threads whose spans and taps fit.
constexpr Geometry geometry(int factor, int taps, bool consecutive, int rows) {
  int rb = 1;
  while (!consecutive && rb < kMaxRowsPerBlock && rb < rows) rb *= 2;
  for (; rb >= 1; rb /= 2)
    for (int threads = kMaxThreads; threads >= 32; threads /= 2)
      if (smem_bytes(factor, taps, threads, rb) <= kSmemLimit) return {threads, rb};
  return {0, 0};
}

constexpr bool domain_fits() {
  for (int f = 1; f <= kMaxFactor; ++f)
    if (smem_bytes(f, kMaxTaps, 32, 1) > kSmemLimit) return false;
  return true;
}
static_assert(domain_fits(), "the longest filter at some factor of the domain passes 48 KB of shared memory");

// kOut consecutive floats of shared memory (16-byte aligned), as float4s.
__device__ __forceinline__ void load_window(float (&v)[kOut], const float* p) {
#pragma unroll
  for (int c = 0; c < kOut; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + c);
    v[c] = a.x, v[c + 1] = a.y, v[c + 2] = a.z, v[c + 3] = a.w;
  }
}

// rb_shift: log2 of the block's rows; x[b, n] lies at x + b * row_stride +
// n * sample_stride.
__global__ void __launch_bounds__(kMaxThreads)
polyphase_decimate_kernel(const float* __restrict__ x, const float* __restrict__ h, float* __restrict__ y,
                          int rows, int t, long long row_stride, long long sample_stride, int m_out, int factor,
                          int taps, int q, int tiles, int rb_shift) {
  extern __shared__ __align__(16) float smem[];
  const int threads = blockDim.x;
  const int rb = 1 << rb_shift;
  const int row_threads = threads >> rb_shift;
  const int tile_len = row_threads * kOut;
  const int seg = tile_len + q;        // samples of one phase's span
  const int stride = padded(seg);      // shared floats of one phase's span
  const int j_len = q * factor;        // padded taps
  const int span = seg * factor;       // staged samples of a row
  float* hp = smem;                    // (factor, q): reversed taps, phase-major
  float* s = smem + factor * q;        // (rows a block, factor, stride): the spans, phase-major
  const int tile = blockIdx.x % tiles;
  const int row0 = (blockIdx.x / tiles) << rb_shift;
  const long long m0 = static_cast<long long>(tile) * tile_len;
  const long long n0 = m0 * factor - (j_len - 1);  // the span's first sample in the row

  // hp[p][i / f] = h[J-1-i] for i = p mod f (zero where J-1-i >= taps):
  // output m is then sum_i hp[i mod f][i / f] * span[(m - m0) f + i].
  for (int i = threadIdx.x; i < j_len; i += threads) {
    const int k = j_len - 1 - i;
    hp[(i % factor) * q + i / factor] = k < taps ? __ldg(h + k) : 0.f;
  }

  const int row_floats = factor * stride;  // shared floats of a row's phases
  if (sample_stride == rb && (rb == 1 || row_stride == 1) && (rows & (rb - 1)) == 0) {
    // Dense: one row of consecutive samples, or rows that interleave
    // sample by sample (the I/Q capture). The block's spans are one run
    // of rb * span floats, loaded in 16-byte chunks, kLoads in flight a
    // thread; `lead` floats of the first chunk lie before the run.
    const float* xr = x + row0 * row_stride;
    const long long first = n0 * rb;        // the run's first float, from xr
    const long long end = static_cast<long long>(t) * rb;
    const int run = span * rb;
    const int lead = static_cast<int>(((reinterpret_cast<uintptr_t>(xr) >> 2) + first) & 3);
    const int chunks = (run + lead + 3) >> 2;
    for (int c0 = threadIdx.x; c0 < chunks; c0 += kLoads * threads) {
      float v[kLoads][4];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int o = 4 * (c0 + u * threads) - lead;  // run index of the chunk's first float
        const long long g = first + o;
        if (o >= 0 && o + 4 <= run && g >= 0 && g + 4 <= end) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(xr + g));
          v[u][0] = w.x, v[u][1] = w.y, v[u][2] = w.z, v[u][3] = w.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[u][e] = o + e < run && g + e >= 0 && g + e < end ? __ldg(xr + g + e) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        // Float o is row o mod rb of span sample i = o / rb, which goes to
        // phase i mod f, index i / f: one division a chunk (offset by 4f,
        // so that it never divides a negative sample).
        const int o = 4 * (c0 + u * threads) - lead;
        int r = o & (rb - 1);
        const int i = (o >> rb_shift) + 4 * factor;
        int p = i % factor, k = i / factor - 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (o + e >= 0 && o + e < run) s[r * row_floats + p * stride + padded(k)] = v[u][e];
          if (++r == rb) {
            r = 0;
            if (++p == factor) p = 0, ++k;
          }
        }
      }
    }
  } else {
    // Items (rows, phase p, index k) with k fastest, so that a warp's
    // shared stores fall on consecutive banks: span sample k f + p of 4
    // rows that lie next to each other (one 16-byte load) where the
    // block's rows are consecutive floats (the audio filter's
    // channel-fastest input), else of one row (a float at a time).
    const int vec = row_stride == 1 && (rb & 3) == 0 && (sample_stride & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? 4 : 1;
    const int items = rb / vec * factor * seg;
    int k = threadIdx.x % seg, pg = threadIdx.x / seg;  // pg = (rows' group) * f + p
    for (int it0 = threadIdx.x; it0 < items; it0 += kLoads * threads) {
      float v[kLoads][4];
      int at[kLoads];  // shared offset of the first row's sample
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int p = pg % factor, r = pg / factor * vec, row = row0 + r;
        const long long n = n0 + static_cast<long long>(k) * factor + p;
        const bool in = it0 + u * threads < items && n >= 0 && n < t;
        at[u] = it0 + u * threads < items ? r * row_floats + p * stride + padded(k) : -1;
        if (vec == 4 && in && row + 4 <= rows) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(x + row + n * sample_stride));
          v[u][0] = w.x, v[u][1] = w.y, v[u][2] = w.z, v[u][3] = w.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[u][e] = e < vec && in && row + e < rows ? __ldg(x + (row + e) * row_stride + n * sample_stride) : 0.f;
        }
        for (k += threads; k >= seg; k -= seg) ++pg;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (at[u] < 0) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < vec) s[at[u] + e * row_floats] = v[u][e];
      }
    }
  }
  __syncthreads();

  // Outputs m0 + kOut*b + j of row r (thread r * row_threads + b): per
  // phase p and window w (taps u of it), acc[j] += hp[p][w + u] *
  // span_p[kOut*b + w + u + j].
  const int r = threadIdx.x / row_threads;
  const int base = (threadIdx.x % row_threads) * kOut;
  float acc[kOut] = {};
  for (int p = 0; p < factor; ++p) {
    const float* sp = s + (r * factor + p) * stride;
    const float* hq = hp + p * q;
    float lo[kOut], hi[kOut], hv[kOut];
    load_window(lo, sp + padded(base));
    for (int w = 0; w < q; w += kOut) {
      load_window(hi, sp + padded(base + w + kOut));
      load_window(hv, hq + w);
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[j] = fmaf(hv[u], u + j < kOut ? lo[u + j] : hi[u + j - kOut], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kOut; ++j) lo[j] = hi[j];
    }
  }

  if (row0 + r >= rows) return;
  const long long m = m0 + base;
  float* yr = y + static_cast<long long>(row0 + r) * m_out + m;
  if (m + kOut <= m_out && (reinterpret_cast<uintptr_t>(yr) & 15) == 0) {
#pragma unroll
    for (int c = 0; c < kOut; c += 4)
      reinterpret_cast<float4*>(yr + c)[0] = make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      if (m + j < m_out) yr[j] = acc[j];
  }
}

}  // namespace

extern "C" {

int hopper_decimate_max_taps() { return kMaxTaps; }
int hopper_decimate_max_factor() { return kMaxFactor; }

// y (rows, t / factor), contiguous, = every factor-th output of the
// zero-state FIR h (taps) over each row of x (rows, t), x[b, n] at x +
// b * row_stride + n * sample_stride. threads, rows_per_block: the block
// the geometry gives (ops/polyphase.decimate_geometry); any other is
// refused.
int polyphase_decimate(const float* x, const float* h, float* y, int rows, int t, long long row_stride,
                       long long sample_stride, int factor, int taps, int threads, int rows_per_block,
                       cudaStream_t stream) {
  if (rows <= 0 || t <= 0 || factor < 1 || factor > kMaxFactor || taps < 1 || taps > kMaxTaps)
    return cudaErrorInvalidValue;
  const Geometry g = geometry(factor, taps, sample_stride == 1, rows);
  if (threads != g.threads || rows_per_block != g.rows_per_block) return cudaErrorInvalidConfiguration;
  const int m_out = t / factor;
  if (m_out <= 0) return cudaErrorInvalidValue;
  int rb_shift = 0;
  while ((1 << rb_shift) < rows_per_block) ++rb_shift;
  const int tile_len = threads / rows_per_block * kOut;
  const int tiles = (m_out + tile_len - 1) / tile_len;
  const long long blocks = static_cast<long long>((rows + rows_per_block - 1) / rows_per_block) * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  polyphase_decimate_kernel<<<static_cast<unsigned>(blocks), threads,
                              smem_bytes(factor, taps, threads, rows_per_block), stream>>>(
      x, h, y, rows, t, row_stride, sample_stride, m_out, factor, taps, phase_taps(factor, taps), tiles, rb_shift);
  return cudaGetLastError();
}

}  // extern "C"
