// CoDR scalar-matrix-multiplication convolution for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/smm_conv/kernel.py
// (_smm_conv_kernel / smm_conv_pallas).  Same operands, same function:
//
//   x       (B, N, RI, CI)        float32, integer-valued input features
//   deltas  (m_tiles, N, U+1)     float32 Δs of each vector's sorted unique
//                                 weights (0-padded)
//   entries (m_tiles, N, L, 4)    int32 (u, m_local, r, c) per repetition;
//                                 padding rows are (U, 0, 0, 0)
//   out     (B, m_tiles*t_m, RO, CO) float32
//
//   out[b, mt*t_m + m_local, y, x] +=
//       value[u] * x[b, n, r + stride*y, c + stride*x]     for every entry
//
// where value = running sum of the Δs (the MPE's differential product,
// paper Eq. 1, folded into the routed add) and value[U] = 0 (the TPU
// kernel's zero product row: padding entries add nothing).
//
// Design (what differs from the TPU kernel and why):
// * The TPU grid (B, m_tiles, N) carries the accumulators across a
//   sequential N axis in VMEM scratch.  CUDA blocks run in no order, so a
//   block owns (b, m_tile, output tile of TILE_ROWS x 32 pixels) and loops
//   over n itself; its t_m x TILE_ROWS x 32 accumulators stay in shared
//   memory for the whole loop (output stationary, written once).
// * The TPU's (U+1, RI, CI) product scratch (about 3.3 MB at VGG16
//   conv1_2) does not fit in 227 KB of shared memory.  Per n the block
//   loads only the input window its tile reads: ((TILE_ROWS-1)*stride + kh)
//   x ((32-1)*stride + kw), the halo included, zero beyond the plane.
// * Strided windows (pl.dslice(r, ro, stride)) become offsets
//   r + stride*y into that window.
// * Per n, warp 0 turns the Δs into values (a warp prefix sum) and groups
//   the entries by m_local (shared-memory counters); every thread then
//   walks the groups for its pixels with the sum in registers and adds it
//   to its accumulator once per group.
// * Accumulation is int32, not float32: the TPU kernel sums in float32,
//   exact only while |acc| < 2^24, and a 256-channel 3x3 layer reaches
//   2304 * 127^2 = 3.7e7.  In int32 (exact while |acc| < 2^31) the
//   float32 output equals float32(conv2d_smm_batched(...)) exactly.
//
// Bound on the H100: against the card's peaks (3.35 TB/s, 1,979 int8
// TOP/s) the function is bound by bytes -- the float32 input and output
// planes.  The kernel reads each input element from device memory once
// per output-channel tile and writes each output once, but it runs the
// 2*nnz operations per pixel on the CUDA cores, one int32 multiply-add
// and one shared-memory load each, and that instruction stream is what
// limits it.  This is the `simt` instance: ops.pick_impl routes strided
// layers (AlexNet conv1, GoogLeNet conv1) and weights outside int8 here;
// stride-1 layers with int8 weights run on the tensor cores in
// smm_conv_sm90.cu (`sm90`), the faster at every VGG16 layer (PERF.md).
//
// Plain C interface, loaded with ctypes: smm_conv_launch returns
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileCols = 32;                       // output columns per tile
constexpr int kRowsPerPass = kThreads / kTileCols;  // 8 output rows per pass

template <int PP>  // output pixels per thread: tile = 8*PP rows x 32 cols
__global__ void __launch_bounds__(kThreads)
smm_conv_kernel(const float* __restrict__ x, const float* __restrict__ deltas,
                const int* __restrict__ entries, float* __restrict__ out,
                int n_in, int ri, int ci, int m_tiles, int u_plus, int l_max,
                int t_m, int ro, int co, int stride, int tile_h, int tile_w,
                int col_tiles) {
  constexpr int kPix = kRowsPerPass * PP * kTileCols;
  extern __shared__ int smem[];
  int* acc = smem;                        // t_m * kPix accumulators
  int* xs = acc + t_m * kPix;             // tile_h * tile_w input window
  int* vals = xs + tile_h * tile_w;       // u_plus unique values
  int* g_val = vals + u_plus;             // l_max values, grouped by m_local
  int* g_off = g_val + l_max;             // l_max window offsets, same order
  int* g_start = g_off + l_max;           // t_m + 1 group bounds
  int* g_cur = g_start + t_m + 1;         // t_m fill cursors

  const int tid = threadIdx.x;
  const int row_tile = blockIdx.x / col_tiles;
  const int col_tile = blockIdx.x - row_tile * col_tiles;
  const int mt = blockIdx.y;
  const int b = blockIdx.z;
  const int oy0 = row_tile * kRowsPerPass * PP;
  const int ox0 = col_tile * kTileCols;
  const int iy0 = oy0 * stride;
  const int ix0 = ox0 * stride;
  const int u_pad = u_plus - 1;

  // this thread's pixels: tile pixel tid + k*kThreads, i.e. tile row
  // py0 + k*8, column px; base[k] is its window offset for tap (0, 0)
  const int px = tid % kTileCols;
  const int py0 = tid / kTileCols;
  int base[PP];
#pragma unroll
  for (int k = 0; k < PP; ++k) {
    base[k] = stride * (py0 + k * kRowsPerPass) * tile_w + stride * px;
  }
  for (int m = 0; m < t_m; ++m) {
#pragma unroll
    for (int k = 0; k < PP; ++k) acc[m * kPix + tid + k * kThreads] = 0;
  }

  for (int n = 0; n < n_in; ++n) {
    __syncthreads();  // every thread is done with the previous n's window
    const float* xp = x + ((size_t)b * n_in + n) * ri * ci;
    for (int i = tid; i < tile_h * tile_w; i += kThreads) {
      const int ty = i / tile_w;
      const int tx = i - ty * tile_w;
      const int gy = iy0 + ty;
      const int gx = ix0 + tx;
      xs[i] = (gy < ri && gx < ci) ? __float2int_rn(xp[(size_t)gy * ci + gx])
                                   : 0;
    }
    if (tid < 32) {
      const int lane = tid;
      const size_t vec = (size_t)mt * n_in + n;
      // values: inclusive prefix sum of the Δs, 32 at a time
      const float* dp = deltas + vec * u_plus;
      int carry = 0;
      for (int u0 = 0; u0 < u_plus; u0 += 32) {
        const int u = u0 + lane;
        int v = u < u_plus ? __float2int_rn(dp[u]) : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += t;
        }
        if (u < u_plus) vals[u] = carry + v;
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
      for (int m = lane; m < t_m; m += 32) g_cur[m] = 0;
      __syncwarp();
      // group the entries by m_local: count, scan, place
      const int* ep = entries + vec * l_max * 4;
      for (int l = lane; l < l_max; l += 32) {
        if (ep[l * 4] != u_pad) atomicAdd(&g_cur[ep[l * 4 + 1]], 1);
      }
      __syncwarp();
      if (lane == 0) {
        int s = 0;
        for (int m = 0; m < t_m; ++m) {
          g_start[m] = s;
          s += g_cur[m];
          g_cur[m] = g_start[m];
        }
        g_start[t_m] = s;
      }
      __syncwarp();
      for (int l = lane; l < l_max; l += 32) {
        const int u = ep[l * 4];
        if (u == u_pad) continue;  // the zero product row adds nothing
        const int pos = atomicAdd(&g_cur[ep[l * 4 + 1]], 1);
        g_val[pos] = vals[u];
        g_off[pos] = ep[l * 4 + 2] * tile_w + ep[l * 4 + 3];
      }
    }
    __syncthreads();
    // routed adds: acc[m] += value * window, one group per m_local
    for (int m = 0; m < t_m; ++m) {
      const int l0 = g_start[m];
      const int l1 = g_start[m + 1];
      if (l0 == l1) continue;
      int a[PP];
#pragma unroll
      for (int k = 0; k < PP; ++k) a[k] = 0;
      for (int l = l0; l < l1; ++l) {
        const int v = g_val[l];
        const int o = g_off[l];
#pragma unroll
        for (int k = 0; k < PP; ++k) a[k] += v * xs[o + base[k]];
      }
#pragma unroll
      for (int k = 0; k < PP; ++k) acc[m * kPix + tid + k * kThreads] += a[k];
    }
  }

  // drain: each thread writes its own pixels, coalesced along columns
  const int ox = ox0 + px;
  for (int m = 0; m < t_m; ++m) {
    float* op = out + (((size_t)b * m_tiles + mt) * t_m + m) * ro * co;
#pragma unroll
    for (int k = 0; k < PP; ++k) {
      const int oy = oy0 + py0 + k * kRowsPerPass;
      if (oy < ro && ox < co) {
        op[(size_t)oy * co + ox] = (float)acc[m * kPix + tid + k * kThreads];
      }
    }
  }
}

size_t smem_bytes(int pp, int t_m, int tile_h, int tile_w, int u_plus,
                  int l_max) {
  const size_t pix = (size_t)kRowsPerPass * pp * kTileCols;
  return sizeof(int) * ((size_t)t_m * pix + (size_t)tile_h * tile_w +
                        u_plus + 2 * (size_t)l_max + 2 * (size_t)t_m + 1);
}

template <int PP>
cudaError_t launch(const float* x, const float* deltas, const int* entries,
                   float* out, int batch, int n_in, int ri, int ci,
                   int m_tiles, int u_plus, int l_max, int t_m, int ro, int co,
                   int stride, int kh, int kw, cudaStream_t stream) {
  const int rows = kRowsPerPass * PP;
  const int tile_h = (rows - 1) * stride + kh;
  const int tile_w = (kTileCols - 1) * stride + kw;
  const size_t bytes = smem_bytes(PP, t_m, tile_h, tile_w, u_plus, l_max);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        smm_conv_kernel<PP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int col_tiles = (co + kTileCols - 1) / kTileCols;
  const int row_tiles = (ro + rows - 1) / rows;
  const dim3 grid(row_tiles * col_tiles, m_tiles, batch);
  smm_conv_kernel<PP><<<grid, kThreads, bytes, stream>>>(
      x, deltas, entries, out, n_in, ri, ci, m_tiles, u_plus, l_max, t_m, ro,
      co, stride, tile_h, tile_w, col_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int smm_conv_launch(const float* x, const float* deltas,
                               const int* entries, float* out, int batch,
                               int n_in, int ri, int ci, int m_tiles,
                               int u_plus, int l_max, int t_m, int ro, int co,
                               int stride, void* stream) {
  const int kh = ri - (ro - 1) * stride;  // input rows a window spans
  const int kw = ci - (co - 1) * stride;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the most pixels per thread whose tile fits the default 48 KB of
  // shared memory; past that, one row pass with the opt-in limit
  for (int pp = 4; pp >= 1; pp /= 2) {
    const int tile_h = (kRowsPerPass * pp - 1) * stride + kh;
    const int tile_w = (kTileCols - 1) * stride + kw;
    if (pp > 1 &&
        smem_bytes(pp, t_m, tile_h, tile_w, u_plus, l_max) > 48 * 1024) {
      continue;
    }
    switch (pp) {
      case 4:
        return launch<4>(x, deltas, entries, out, batch, n_in, ri, ci,
                         m_tiles, u_plus, l_max, t_m, ro, co, stride, kh, kw,
                         s);
      case 2:
        return launch<2>(x, deltas, entries, out, batch, n_in, ri, ci,
                         m_tiles, u_plus, l_max, t_m, ro, co, stride, kh, kw,
                         s);
      default:
        return launch<1>(x, deltas, entries, out, batch, n_in, ri, ci,
                         m_tiles, u_plus, l_max, t_m, ro, co, stride, kh, kw,
                         s);
    }
  }
  return cudaErrorInvalidValue;  // unreachable
}

extern "C" const char* smm_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
