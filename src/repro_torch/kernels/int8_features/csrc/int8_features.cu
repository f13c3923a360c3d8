// The 8-bit feature path of the smm_kernel lane, and its epilogue, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package this is host code
// (repro/core/backends.py, _int_activations and _finish, around the
// smm_conv kernel).  In the port it ran as some ten torch elementwise ops
// a layer and two scalar reads back to the host (the integer test and the
// scale), each of which stalled the host until the card caught up.  Three
// launches a layer take their place and keep the scale on the device:
//
//   stats     one pass over x: amax = max |x| and whether every element
//             is a whole number (x == rint(x)), folded into a small
//             per-stream accumulator by atomics; the last block to finish
//             turns them into the scale and leaves the accumulator zero
//             for the next launch on the stream (no memset, no host sync):
//               scale = 1                 whole numbers with amax <= 127
//                     = amax / 127        otherwise (IEEE division), or 1
//                                         where amax is not > 0
//   quantize  one pass: q = clamp(rint(x / scale), -127, 127) as whole-
//             number float32 in the contiguous NCHW layout smm_conv takes.
//             x comes in either storage the engine chain hands it: NCHW
//             storage behind an NHWC view (a flat map) or NHWC-contiguous
//             (a block's first layer: transposed through shared memory).
//             With scale 1 the map returns x itself, so the exact case
//             needs no branch.  The main path runs the flat map only
//             before smm_conv's simt instance: the sm90 instance applies
//             the same arithmetic (../../csrc/feature_quant.cuh) to a
//             layer's raw features in its own phase 1b.
//   quantize_pad  the same numbers from NCHW storage into the interior of
//             a plane with a zero border of `pad` pixels (the SAME
//             padding of the next convolution), border written too: a
//             row (b, channel) a blockIdx.y step.
//   max_pool the lane's max pooling of NCHW storage (int8 features held as
//             whole-number float32, or the float32 output of a module):
//             a block a few planes at a time, staged in shared memory
//             (planes of at most 12288 values), a thread an output
//             column; the window's pixels outside the plane skipped
//             (padding never wins), a NaN kept, as torch's max pooling
//             keeps it; the window's first maximum wins.  No indices.
//   epilogue one pass over smm_conv's NCHW output (its channel axis may be
//             padded to whole t_m tiles): y * (float)(layer scale * scale)
//             (the product in double, as the host computed it), + bias,
//             ReLU; written NCHW, which the caller views as NHWC, into
//             the first m of each image's m_out channels (m_out > m: a
//             branch's channel slice of a concatenated output).  The
//             main path runs it only after smm_conv's simt instance: the
//             sm90 instance applies the same arithmetic
//             (../../csrc/layer_epilogue.cuh) in its own store.
//
// The numbers are those of repro.core.backends._int_activations: the
// scale is the correctly rounded amax / 127 (__fdiv_rn), rint rounds half
// to even, the multiply and add round separately (no FMA).  A NaN stays
// NaN through every step (the scale is then 1, as in the reference, and
// the NaN reaches smm_conv, whose sm90 instance traps on it).
//
// Bound on the H100: bytes.  Each pass reads (and writes) float32 once at
// 3.35 TB/s and does a handful of operations an element, so the design is
// 16-byte accesses, enough of them in flight, and nothing beyond one read
// for stats, one read and one write for quantize and for the epilogue.
//
// Plain C interface, loaded with ctypes: each *_launch returns
// cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

#include "feature_quant.cuh"    // quant
#include "layer_epilogue.cuh"   // finish, epilogue_scale

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 32;         // channels a transpose tile
constexpr int kTileElems = 1024;   // elements a transpose tile
constexpr int kPer = kTileElems / kThreads;   // of them a thread
constexpr int kPoolSmemFloats = 12288;        // planes max_pool stages

// accumulator words: max |x| as bits, "some element not whole", blocks done
constexpr int kAmax = 0, kNotWhole = 1, kDone = 2;

__device__ __forceinline__ void fold(float v, unsigned& amax, bool& whole) {
  // |x| as bits orders like |x|; a NaN's bits exceed +inf's, so it wins
  amax = max(amax, __float_as_uint(v) & 0x7fffffffu);
  whole = whole && (v == rintf(v));
}

__global__ void __launch_bounds__(kThreads)
    int8_features_stats_kernel(const float* __restrict__ x, long long n,
                               unsigned* __restrict__ acc,
                               float* __restrict__ scale) {
  unsigned amax = 0;
  bool whole = true;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (long long i = tid; i < n4; i += step) {
    const float4 v = x4[i];
    fold(v.x, amax, whole);
    fold(v.y, amax, whole);
    fold(v.z, amax, whole);
    fold(v.w, amax, whole);
  }
  for (long long j = n4 * 4 + tid; j < n; j += step) {
    fold(x[j], amax, whole);
  }

  // block: warps by shuffles, then the warps' results through shared memory
  __shared__ unsigned s_amax[kThreads / 32];
  __shared__ int s_whole[kThreads / 32];
  amax = __reduce_max_sync(0xffffffffu, amax);
  const int all_whole = __all_sync(0xffffffffu, whole);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_amax[warp] = amax;
    s_whole[warp] = all_whole;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  amax = s_amax[0];
  whole = s_whole[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    amax = max(amax, s_amax[w]);
    whole = whole && s_whole[w];
  }
  atomicMax(acc + kAmax, amax);
  if (!whole) atomicOr(acc + kNotWhole, 1u);
  // publish this block's atomics before counting it done
  __threadfence();
  if (atomicAdd(acc + kDone, 1u) != gridDim.x - 1) return;

  // the last block: every other block's atomics are visible; read the
  // accumulator and leave it zero for the next launch on the stream
  __threadfence();
  const float a = __uint_as_float(atomicExch(acc + kAmax, 0u));
  const bool all = atomicExch(acc + kNotWhole, 0u) == 0u;
  atomicExch(acc + kDone, 0u);
  float s = 1.0f;
  if (!(all && a <= 127.0f) && a > 0.0f) s = __fdiv_rn(a, 127.0f);
  *scale = s;
}

__device__ __forceinline__ float4 quant4(float4 v, float s) {
  return make_float4(quant(v.x, s), quant(v.y, s), quant(v.z, s),
                     quant(v.w, s));
}

// x already in NCHW storage: an elementwise map over the flat buffer
__global__ void __launch_bounds__(kThreads)
    int8_features_quantize_kernel(const float* __restrict__ x,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out, long long n) {
  const float s = *scale;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n4; i += step) o4[i] = quant4(__ldcs(x4 + i), s);
  for (long long j = n4 * 4 + tid; j < n; j += step) out[j] = quant(x[j], s);
}

// x NHWC-contiguous (B, P, C) -> out (B, C, P): a tile of tp pixels x up to
// 32 channels a block, read along (pixel, channel) -- contiguous in x --
// and written along pixels -- contiguous in out -- through shared memory
// (rows padded by one word against bank conflicts).  kC32: C a multiple of
// 32, so every tile is 32 x 32 and its indices are shifts, not divisions.
template <bool kC32>
__global__ void __launch_bounds__(kThreads)
    int8_features_quantize_nhwc_kernel(const float* __restrict__ x,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out, long long p,
                                       int c, int tp) {
  extern __shared__ float tile[];
  const float s = *scale;
  const long long p0 = (long long)blockIdx.x * tp;
  const int c0 = blockIdx.y * kTileC;
  const long long b = blockIdx.z;
  const int tc = kC32 ? kTileC : min(kTileC, c - c0);
  const int np = (int)min((long long)tp, p - p0);
  const float* src = x + (b * p + p0) * c + c0;
  // tp * tc <= kTileElems: each thread's loads all issued before any is used
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int px = kC32 ? i >> 5 : i / tc, ch = i - px * tc;
    if (px < np) v[k] = __ldcs(src + (long long)px * c + ch);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int px = kC32 ? i >> 5 : i / tc, ch = i - px * tc;
    if (px < np) tile[ch * (tp + 1) + px] = quant(v[k], s);
  }
  __syncthreads();
  float* dst = out + (b * c + c0) * p + p0;
  const int span = kC32 ? kTileC : np;    // pixels a channel row of the tile
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int ch = kC32 ? i >> 5 : i / span, px = i - ch * span;
    if (px < np && ch < tc) {
      dst[(long long)ch * p + px] = tile[ch * (tp + 1) + px];
    }
  }
}

// x NCHW storage, rows (b, channel) of h x w -> out rows of (h + 2 pad) x
// (w + 2 pad): the interior quantized, the border zero
__global__ void __launch_bounds__(kThreads)
    int8_features_quantize_pad_kernel(const float* __restrict__ x,
                                      const float* __restrict__ scale,
                                      float* __restrict__ out,
                                      long long rows, int h, int w, int pad) {
  const float s = *scale;
  const int wp = w + 2 * pad, pp = (h + 2 * pad) * wp;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* src = x + r * h * w;
    float* dst = out + r * pp;
    for (int j = blockIdx.x * kThreads + threadIdx.x; j < pp;
         j += gridDim.x * kThreads) {
      const int i = j / wp - pad, k = j % wp - pad;
      dst[j] = (i >= 0 && i < h && k >= 0 && k < w)
                   ? quant(__ldcs(src + i * w + k), s)
                   : 0.0f;
    }
  }
}

// torch's max pooling's rule: a NaN wins, else the first maximum
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// the max of row y of a plane over the columns [x0, x0 + k) that lie in
// it; -inf for a row outside the plane (the padding never wins)
template <int K>
__device__ __forceinline__ float row_max(const float* pl, int h, int w,
                                         int k, int y, int x0) {
  float m = __int_as_float(0xff800000);   // -inf
  if (y < 0 || y >= h) return m;
#pragma unroll
  for (int dx = 0; dx < (K > 0 ? K : k); ++dx) {
    const int c = x0 + dx;
    if (c >= 0 && c < w) m = pool_max(m, pl[y * w + c]);
  }
  return m;
}

// x NCHW storage, rows (b, channel) of h x w -> out rows of ho x wo: a
// block `per` consecutive planes at a time, read into shared memory
// (16-byte loads where the planes line up; kSmem false: a plane past
// kPoolSmemFloats, per = 1, read where it lies); a thread an output
// column of a plane, down its rows (no division an output).  K: the
// window, 0 for any (then k).
template <int K, bool kSmem>
__global__ void __launch_bounds__(kThreads)
    int8_features_max_pool_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, long long rows,
                                  int h, int w, int ho, int wo, int k,
                                  int stride, int pad, int per) {
  extern __shared__ float4 smem4[];
  const float* planes = reinterpret_cast<const float*>(smem4);
  const int p = h * w, po = ho * wo;
  const bool vec =
      (p & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (long long r0 = (long long)blockIdx.x * per; r0 < rows;
       r0 += (long long)gridDim.x * per) {
    const int n = (int)min((long long)per, rows - r0);
    const float* src = x + r0 * p;
    if (kSmem) {
      __syncthreads();   // every window of the last planes is read
      if (vec) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
        for (int i = threadIdx.x; i < n * p / 4; i += kThreads)
          smem4[i] = __ldcs(s4 + i);
      } else {
        for (int i = threadIdx.x; i < n * p; i += kThreads)
          reinterpret_cast<float*>(smem4)[i] = __ldcs(src + i);
      }
      __syncthreads();
    }
    for (int t = threadIdx.x; t < n * wo; t += kThreads) {
      const int q = t / wo, ox = t - q * wo, x0 = ox * stride - pad;
      const float* pl = (kSmem ? planes : src) + q * p;
      float* dst = out + (r0 + q) * po + ox;
      if (K == 3 && stride <= 3) {
        // a window's three row maxima, slid down the column: each row's
        // maximum taken once (rows in order, so the first maximum and a
        // NaN win as in a row-major scan)
        float a = row_max<3>(pl, h, w, 3, -pad, x0);
        float b = row_max<3>(pl, h, w, 3, 1 - pad, x0);
        float c = row_max<3>(pl, h, w, 3, 2 - pad, x0);
        for (int oy = 0; oy < ho; ++oy) {
          if (oy > 0) {
            const int y0 = oy * stride - pad;
            if (stride == 1) {
              a = b;
              b = c;
            } else if (stride == 2) {
              a = c;
              b = row_max<3>(pl, h, w, 3, y0 + 1, x0);
            } else {
              a = row_max<3>(pl, h, w, 3, y0, x0);
              b = row_max<3>(pl, h, w, 3, y0 + 1, x0);
            }
            c = row_max<3>(pl, h, w, 3, y0 + 2, x0);
          }
          dst[oy * wo] = pool_max(pool_max(a, b), c);
        }
      } else {
        for (int oy = 0; oy < ho; ++oy) {
          float m = __int_as_float(0xff800000);   // -inf
          for (int dy = 0; dy < k; ++dy)
            m = pool_max(m, row_max<0>(pl, h, w, k, oy * stride - pad + dy,
                                       x0));
          dst[oy * wo] = m;
        }
      }
    }
  }
}

// y (B, m_in, P) -> out (B, m_out, P), channels 0 .. m - 1, m <= m_in and
// m <= m_out: a row (b, channel) a
// blockIdx.y step, blockIdx.x over the row's pixels
__global__ void __launch_bounds__(kThreads)
    int8_features_epilogue_kernel(const float* __restrict__ y,
                                  const float* __restrict__ x_scale,
                                  double layer_scale,
                                  const float* __restrict__ bias, int relu,
                                  float* __restrict__ out, int m, int m_in,
                                  int m_out, long long p, long long rows,
                                  int vec) {
  const float s = epilogue_scale(layer_scale, x_scale);
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long b = r / m;
    const int ch = (int)(r - b * m);
    const float add = bias == nullptr ? 0.0f : bias[ch];
    const float* src = y + (b * m_in + ch) * p;
    float* dst = out + (b * m_out + ch) * p;
    if (vec) {       // p % 4 == 0 and both buffers 16-byte aligned
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
           i < p / 4; i += (long long)gridDim.x * kThreads) {
        const float4 v = __ldcs(s4 + i);
        d4[i] = make_float4(finish(v.x, s, bias, add, relu),
                            finish(v.y, s, bias, add, relu),
                            finish(v.z, s, bias, add, relu),
                            finish(v.w, s, bias, add, relu));
      }
    } else {
      for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
           i < p; i += (long long)gridDim.x * kThreads) {
        dst[i] = finish(__ldcs(src + i), s, bias, add, relu);
      }
    }
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// acc: three zero words (the stream's accumulator); scale: one float out
extern "C" int int8_features_stats_launch(const float* x, long long n,
                                          unsigned* acc, float* scale,
                                          int max_blocks, void* stream) {
  const long long want = cdiv(n, 4LL * 4 * kThreads);   // 16 floats a thread
  const int blocks = (int)(want < max_blocks ? (want > 0 ? want : 1)
                                             : max_blocks);
  int8_features_stats_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, n, acc, scale);
  return static_cast<int>(cudaGetLastError());
}

// nhwc = 0: x in NCHW storage, n = b * c * p elements; nhwc = 1: x (b, p, c)
extern "C" int int8_features_quantize_launch(const float* x,
                                             const float* scale, float* out,
                                             long long b, long long p, int c,
                                             int nhwc, int max_blocks,
                                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!nhwc) {
    const long long n = b * p * c;
    const long long want = cdiv(n, 4LL * kThreads);
    const int blocks = (int)(want < max_blocks ? want : max_blocks);
    int8_features_quantize_kernel<<<blocks, kThreads, 0, s>>>(x, scale, out,
                                                              n);
    return static_cast<int>(cudaGetLastError());
  }
  const int tc = c < kTileC ? c : kTileC;
  const int tp = kTileElems / tc / 32 * 32;   // a whole number of warps
  const dim3 grid((unsigned)cdiv(p, tp), (unsigned)cdiv(c, kTileC),
                  (unsigned)b);
  const size_t smem = sizeof(float) * tc * (tp + 1);
  if (c % kTileC == 0) {
    int8_features_quantize_nhwc_kernel<true><<<grid, kThreads, smem, s>>>(
        x, scale, out, p, c, tp);
  } else {
    int8_features_quantize_nhwc_kernel<false><<<grid, kThreads, smem, s>>>(
        x, scale, out, p, c, tp);
  }
  return static_cast<int>(cudaGetLastError());
}

// x NCHW storage (rows = b * c planes of h x w); out rows of (h + 2 pad) x
// (w + 2 pad)
extern "C" int int8_features_quantize_pad_launch(const float* x,
                                                 const float* scale,
                                                 float* out, long long rows,
                                                 int h, int w, int pad,
                                                 void* stream) {
  const long long pp = (long long)(h + 2 * pad) * (w + 2 * pad);
  const dim3 grid((unsigned)cdiv(pp, 4LL * kThreads),
                  (unsigned)(rows < 65535 ? rows : 65535));
  int8_features_quantize_pad_kernel<<<grid, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      x, scale, out, rows, h, w, pad);
  return static_cast<int>(cudaGetLastError());
}

// x NCHW storage (rows = b * c planes of h x w); out rows of ho x wo
extern "C" int int8_features_max_pool_launch(const float* x, float* out,
                                             long long rows, int h, int w,
                                             int ho, int wo, int k,
                                             int stride, int pad,
                                             int max_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long p = (long long)h * w;
  const bool staged = p <= kPoolSmemFloats;
  // planes for a thread a column, as shared memory allows
  const long long fit = staged ? kPoolSmemFloats / p : 1;
  const long long want = wo < kThreads ? kThreads / wo : 1;
  const int per = (int)(want < fit ? want : fit);
  const long long chunks = cdiv(rows, per);
  const int blocks = (int)(chunks < max_blocks ? chunks : max_blocks);
  const size_t smem = staged ? sizeof(float) * ((per * p + 3) / 4 * 4) : 0;
#define INT8_FEATURES_MAX_POOL(K, STAGED)                                 \
  int8_features_max_pool_kernel<K, STAGED><<<blocks, kThreads, smem, s>>>( \
      x, out, rows, h, w, ho, wo, k, stride, pad, per)
  if (k == 3 && staged) {
    INT8_FEATURES_MAX_POOL(3, true);
  } else if (k == 3) {
    INT8_FEATURES_MAX_POOL(3, false);
  } else if (staged) {
    INT8_FEATURES_MAX_POOL(0, true);
  } else {
    INT8_FEATURES_MAX_POOL(0, false);
  }
#undef INT8_FEATURES_MAX_POOL
  return static_cast<int>(cudaGetLastError());
}

// y (b, m_in, p) with m <= m_in; bias null or m floats; out (b, m_out, p)
// with m <= m_out, its first m channels written
extern "C" int int8_features_epilogue_launch(const float* y,
                                             const float* x_scale,
                                             double layer_scale,
                                             const float* bias, int relu,
                                             float* out, long long b, int m,
                                             int m_in, int m_out, long long p,
                                             void* stream) {
  const long long rows = b * m;
  const int vec = p % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(y) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long per_row = vec ? p / 4 : p;
  const dim3 grid((unsigned)cdiv(per_row, 4LL * kThreads),
                  (unsigned)(rows < 65535 ? rows : 65535));
  int8_features_epilogue_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      y, x_scale, layer_scale, bias, relu, out, m, m_in, m_out, p, rows,
      vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_features_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
