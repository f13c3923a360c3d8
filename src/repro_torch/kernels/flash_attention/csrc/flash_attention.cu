// Flash attention for Hopper (sm_90a): the CUDA-core instance.
//
// ops.py routes bfloat16 with D = Dv in {64, 128} to the tensor-core
// instance, flash_attention_sm90.cu; this kernel takes every other shape
// and float32.
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:67
// (flash_attention_pallas, with _flash_kernel) and the GQA head repeat of
// its wrapper, src/repro/kernels/flash_attention/ops.py:10.  Same
// function:
//
//   q    (B, Sq, Hq, D)     float32 or bfloat16
//   k    (B, Sk, Hkv, D)    q's dtype
//   v    (B, Sk, Hkv, Dv)   q's dtype
//   out  (B, Sq, Hq, Dv)    q's dtype
//
//   s[i, j]  = (q[i] . k[j]) * scale            (scale = D^-1/2, f32)
//              -1e30 where causal and i < j     (top-left: key 0 is
//                                                visible to every row)
//   out[i]   = sum_j softmax(s[i])[j] v[j]      online: f32 running max,
//                                               denominator, accumulator
//                                               from -1e30 / 0 / 0, and
//                                               acc / max(l, 1e-30)
//
// q head h reads kv head h / (Hq / Hkv), as the TPU wrapper's repeat does.
// 1 <= D, Dv <= 256; Hq % Hkv == 0; Sk >= 1 (the wrapper checks them).
//
// Design (what differs from the TPU kernel and why):
// * The TPU grid (B*H, Sq/bq, Sk/bk) carries the running max, denominator
//   and (bq, Dv) accumulator across the sequential kv axis in VMEM
//   scratch.  CUDA blocks run in no order, so one block owns one 64-row q
//   tile of one (batch, q head) and loops over the kv tiles itself, the
//   statistics and the accumulator in registers (output stationary,
//   written once).
// * The TPU wrapper repeats the kv heads and transposes to (B*H, S, D)
//   in device memory.  Here the block indexes the (B, S, H, D) layout
//   directly and reads its kv head in place: no copy.
// * The TPU wrapper snaps bq and bk down to divisors of S, so a prime S
//   runs blocks of one row.  Here the tiles are fixed (64 x 64) and the
//   ragged tails are masked: q rows past Sq are computed and not stored;
//   k columns past Sk are kept out of the max and the sums (p = 0), not
//   given the -1e30 score, which in a row whose max is still -1e30 would
//   count exp(0) = 1.
// * Causal: kv tiles wholly above the diagonal of the block's last valid
//   row are skipped.  The sums are the same: key 0 is visible to every
//   row, so the running max is finite after the first tile, and
//   expf(-1e30 - max) is exactly 0 in f32.
// * Q, K and V tiles are staged in shared memory as f32 (bf16 converted
//   on load); Q and K rows are padded to an odd stride so the 16 k rows a
//   warp reads at one depth fall in 16 banks.  At D = Dv = 256 the
//   staging is 213,760 bytes, under the 227 KB a block may have, so one
//   tile size fits every D; above 48 KB the launch sets
//   cudaFuncAttributeMaxDynamicSharedMemorySize.
// * 256 threads: thread (ty, tx) = (tid / 16, tid % 16) owns rows
//   ty + 16 i (i < 4) and score columns tx + 16 j (j < 4), and the same
//   rows x output columns tx + 16 c.  A row's 16 threads are one half
//   warp, so its max and sum are xor-shuffle reductions (every lane gets
//   the same bits).
//
// Bound on the H100: at the qwen2.5-3b widths (Hq 16, Hkv 2, D 128) and
// S in the thousands the function does ~2 S^2 Hq D flops (causal) on
// ~S (Hq + Hkv) D bf16 values, so it is bound by operations, at the bf16
// tensor-core rate of 989 TFLOP/s.  This kernel does its products with
// f32 FMAs on the CUDA cores (67 TFLOP/s at most) and reads both operands
// of every FMA from shared memory, so it sits far above that bound: it
// keeps float32 within rtol 1e-4 and takes the head dims the tensor-core
// instance does not.  Tensor cores (wgmma on bf16 tiles), TMA staging and
// a warp-specialised pipeline are in flash_attention_sm90.cu.  The sums
// run in a fixed order, so two runs on the same inputs give the same
// bits.
//
// Plain C interface, loaded with ctypes: flash_attention_launch returns
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                   // q rows per block
constexpr int kBK = 64;                   // kv rows per staged tile
constexpr int kGroups = 16;               // row groups (ty) = column groups (tx)
constexpr int kRows = kBQ / kGroups;      // 4 q rows per thread
constexpr int kCols = kBK / kGroups;      // 4 score columns per thread
constexpr int kLdP = kBK + 1;             // row stride of the P tile
constexpr float kNeg = -1e30f;
constexpr int kMaxD = 256;                // largest D and Dv taken

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// max / sum over the 16 lanes of a half warp
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = kGroups / 2; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = kGroups / 2; o > 0; o /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr int qk_stride(int d) { return d | 1; }

// floats of dynamic shared memory: Q and K tiles at an odd stride, the V
// tile at DVT * 16 columns, the P tile
__host__ __device__ constexpr size_t smem_floats(int d, int dvt) {
  return (size_t)(kBQ + kBK) * qk_stride(d) + (size_t)kBK * dvt * kGroups
         + (size_t)kBQ * kLdP;
}

// DVT = output columns per thread: Dv <= 16 * DVT
template <typename T, int DVT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int sk, int hq, int hkv, int d, int dv, int causal,
                       float scale) {
  constexpr int kLdV = DVT * kGroups;
  extern __shared__ float smem[];
  const int ld = qk_stride(d);
  float* qs = smem;                        // [kBQ][ld]
  float* ks = qs + kBQ * ld;               // [kBK][ld]
  float* vs = ks + kBK * ld;               // [kBK][kLdV]
  float* ps = vs + kBK * kLdV;             // [kBQ][kLdP]

  const int tid = threadIdx.x;
  const int tx = tid % kGroups;
  const int ty = tid / kGroups;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const size_t q_row = (size_t)hq * d;      // elements between two positions
  const size_t k_row = (size_t)hkv * d;
  const size_t v_row = (size_t)hkv * dv;
  const T* qb = q + (size_t)b * sq * q_row + (size_t)h * d;
  const T* kb = k + (size_t)b * sk * k_row + (size_t)hk * d;
  const T* vb = v + (size_t)b * sk * v_row + (size_t)hk * dv;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e % d;
    qs[r * ld + c] = q0 + r < sq ? to_f32(qb[(q0 + r) * q_row + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DVT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DVT; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ, sq) - 1;
    n_tiles = min(n_tiles, last_row / kBK + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const int k_valid = min(kBK, sk - k0);
    __syncthreads();   // the previous tile's K, V and P are read (Q staged)
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d, c = e % d;
      ks[r * ld + c] = r < k_valid ? to_f32(kb[(k0 + r) * k_row + c]) : 0.f;
    }
    for (int e = tid; e < kBK * kLdV; e += kThreads) {
      const int r = e / kLdV, c = e % kLdV;
      vs[e] = r < k_valid && c < dv ? to_f32(vb[(k0 + r) * v_row + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kGroups * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + kGroups * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + kGroups * i;
      const int qpos = q0 + row;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + kGroups * j;
        float x = s[i][j] * scale;
        if (causal && qpos < k0 + col) x = kNeg;
        s[i][j] = x;
        if (col < k_valid) mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + kGroups * j;
        const float p = col < k_valid ? expf(s[i][j] - m_new) : 0.f;
        ps[row * kLdP + col] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DVT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < k_valid; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + kGroups * i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < DVT; ++c) {
        const float vv = vs[kk * kLdV + tx + kGroups * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = out + (size_t)b * sq * hq * dv + (size_t)h * dv;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + kGroups * i;
    if (qpos >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DVT; ++c) {
      const int col = tx + kGroups * c;
      if (col < dv)
        store_out(ob + (size_t)qpos * hq * dv + col, acc[i][c] * inv);
    }
  }
}

template <typename T, int DVT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int sq, int sk, int hq, int hkv, int d, int dv,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(d, DVT) * sizeof(float);
  // dynamic shared memory above 48 KB must be allowed per instance; set
  // the instance's largest need (D = 256) once, on its first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, DVT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(kMaxD, DVT) * sizeof(float)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_attention_kernel<T, DVT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, hq, hkv, d, dv,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dv(const void* q, const void* k, const void* v, void* out,
                      int b, int sq, int sk, int hq, int hkv, int d, int dv,
                      int causal, float scale, cudaStream_t stream) {
  // the fewest output columns per thread that cover Dv
  if (dv <= 16)
    return launch<T, 1>(q, k, v, out, b, sq, sk, hq, hkv, d, dv, causal,
                        scale, stream);
  if (dv <= 32)
    return launch<T, 2>(q, k, v, out, b, sq, sk, hq, hkv, d, dv, causal,
                        scale, stream);
  if (dv <= 64)
    return launch<T, 4>(q, k, v, out, b, sq, sk, hq, hkv, d, dv, causal,
                        scale, stream);
  if (dv <= 128)
    return launch<T, 8>(q, k, v, out, b, sq, sk, hq, hkv, d, dv, causal,
                        scale, stream);
  return launch<T, 16>(q, k, v, out, b, sq, sk, hq, hkv, d, dv, causal,
                       scale, stream);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int sq,
                                      int sk, int hq, int hkv, int d, int dv,
                                      int causal, int bf16, float scale,
                                      void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hq < 1 || hkv < 1 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  if (d < 1 || d > kMaxD || dv < 1 || dv > kMaxD || b > 65535 || hq > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_dv<__nv_bfloat16>(q, k, v, out, b, sq, sk, hq, hkv, d, dv,
                                    causal, scale, st);
  return launch_dv<float>(q, k, v, out, b, sq, sk, hq, hkv, d, dv, causal,
                          scale, st);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
