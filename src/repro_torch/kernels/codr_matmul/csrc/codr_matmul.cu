// CoDR unique-index compressed matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/codr_matmul/kernel.py:70
// (codr_matmul_pallas, with _codr_matmul_kernel / _decode_block).  Same
// operands, same function:
//
//   x       (M, K)             float32 or bfloat16 activations
//   packed  (K, N*bits/32)     uint32 words (int32 bit patterns on the
//                              torch side); index j of a word sits at
//                              bits [j*bits, (j+1)*bits)
//   table   (2^bits,)          float32 or bfloat16 sorted unique values
//   scale   (1,)               float32 per-tensor scale (device memory)
//   out     (M, N)             x's dtype
//
//   out[m, n] = scale * sum_k x[m, k] * table[idx(k, n)],   f32 accumulation
//
// bits is one of 1, 2, 4, 8, 16; N is a whole number of words (the
// packer pads the output features).
//
// Design (what differs from the TPU kernel and why):
// * The TPU grid (M/bm, N/bn, K/bk) carries an f32 accumulator tile
//   across the sequential K axis in VMEM scratch.  CUDA blocks run in no
//   order, so a block owns one (BM x 64) output tile and loops over K
//   itself, its accumulators in registers (output stationary, written
//   once).
// * Per 64-row K chunk the block stages x (as f32) and the decoded weight
//   block (as f32) in shared memory; the words and x of the next chunk
//   are loaded into registers while the current chunk is multiplied.
// * The TPU decodes with a masked reduction over all 2^bits table entries
//   (no gather on its vector unit).  Here each word is shifted and masked
//   and the value looked up: from a shared-memory copy of the table for
//   bits <= 8, from device memory through the read-only cache for
//   bits = 16 (65,536 entries, 256 KB in f32, more than shared memory).
// * Ragged M and K are masked (x and weights read as 0); columns past N
//   are computed and not stored.  BM = 4*RM rows with RM in {1,2,4,8},
//   chosen from M, so a decode step (M = 4) wastes no rows.
//
// Bound on the H100: at decode (M = 4) the function moves the packed
// weights, K*N*bits/8 bytes, and little else, so it is bound by bytes at
// 3.35 TB/s.  This first kernel runs one block per 64 output columns: at
// K x N = 2048 x 256 that is 4 blocks on 132 SMs, and no block keeps
// enough loads in flight to approach the bound.  Split-K or a persistent
// design, and tensor cores for prefill, are later work.  The sum over K
// is sequential per output, so results are the same from run to run.
//
// Plain C interface, loaded with ctypes: codr_matmul_launch returns
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;                      // output columns per block
constexpr int kBK = 64;                      // K rows per staged chunk
constexpr int kRowGroups = kThreads / kBN;   // 4: rows ty, ty+4, ...
constexpr int kMaxWords = kBK * kBN * 16 / 32 / kThreads;  // 8 (bits = 16)
constexpr int kSmemTable = 256;              // entries of a bits <= 8 table

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX, typename TT, int RM>
__global__ void __launch_bounds__(kThreads)
codr_matmul_kernel(const TX* __restrict__ x,
                   const uint32_t* __restrict__ packed,
                   const TT* __restrict__ table,
                   const float* __restrict__ scale, TX* __restrict__ out,
                   int m, int k, int n, int bits) {
  constexpr int BM = kRowGroups * RM;
  __shared__ __align__(16) float xs[BM][kBK];
  __shared__ float ws[kBK][kBN];
  __shared__ float tab[kSmemTable];

  const int tid = threadIdx.x;
  const int tx = tid % kBN;
  const int ty = tid / kBN;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int per_word = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const int row_words = n / per_word;          // words of one K row
  const int tile_words = kBN / per_word;       // words of this tile's columns
  const int chunk_words = kBK * tile_words;
  const int word0 = n0 / per_word;
  const bool smem_table = bits <= 8;

  if (smem_table) {
    for (int i = tid; i < (1 << bits); i += kThreads) tab[i] = to_f32(table[i]);
  }
  __syncthreads();

  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.f;
  float xreg[RM];
  uint32_t wreg[kMaxWords];
  uint32_t valid = 0;  // bit j: wreg[j] holds a word inside the matrix

  // global -> registers: chunk starting at K row k0
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int e = tid + j * kThreads;
      const int gm = m0 + e / kBK;
      const int gk = k0 + e % kBK;
      xreg[j] = (gm < m && gk < k) ? to_f32(x[(size_t)gm * k + gk]) : 0.f;
    }
    valid = 0;
#pragma unroll
    for (int j = 0; j < kMaxWords; ++j) {
      const int e = tid + j * kThreads;
      wreg[j] = 0u;
      if (e < chunk_words) {
        const int gk = k0 + e / tile_words;
        const int gw = word0 + e % tile_words;
        if (gk < k && gw < row_words) {
          wreg[j] = packed[(size_t)gk * row_words + gw];
          valid |= 1u << j;
        }
      }
    }
  };

  // registers -> shared memory, decoding the words
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int e = tid + j * kThreads;
      xs[e / kBK][e % kBK] = xreg[j];
    }
#pragma unroll
    for (int j = 0; j < kMaxWords; ++j) {
      const int e = tid + j * kThreads;
      if (e < chunk_words) {
        const int kr = e / tile_words;
        float* dst = &ws[kr][(e % tile_words) * per_word];
        const uint32_t word = wreg[j];
        const bool ok = (valid >> j) & 1u;
        for (int p = 0; p < per_word; ++p) {
          const uint32_t idx = (word >> (p * bits)) & mask;
          const float v = smem_table ? tab[idx] : to_f32(table[idx]);
          dst[p] = ok ? v : 0.f;
        }
      }
    }
  };

  load(0);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    stage();
    __syncthreads();
    if (k0 + kBK < k) load(k0 + kBK);   // in flight during the products
#pragma unroll 4
    for (int kk = 0; kk < kBK; kk += 4) {
      const float w0 = ws[kk][tx];
      const float w1 = ws[kk + 1][tx];
      const float w2 = ws[kk + 2][tx];
      const float w3 = ws[kk + 3][tx];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&xs[ty + kRowGroups * r][kk]);
        acc[r] = fmaf(xv.x, w0, acc[r]);
        acc[r] = fmaf(xv.y, w1, acc[r]);
        acc[r] = fmaf(xv.z, w2, acc[r]);
        acc[r] = fmaf(xv.w, w3, acc[r]);
      }
    }
    __syncthreads();
  }

  const int col = n0 + tx;
  if (col < n) {
    const float s = *scale;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = m0 + ty + kRowGroups * r;
      if (row < m) store_out(out + (size_t)row * n + col, acc[r] * s);
    }
  }
}

template <typename TX, typename TT, int RM>
cudaError_t launch(const void* x, const void* packed, const void* table,
                   const float* scale, void* out, int m, int k, int n,
                   int bits, cudaStream_t stream) {
  constexpr int BM = kRowGroups * RM;
  const dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  codr_matmul_kernel<TX, TT, RM><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint32_t*>(packed),
      static_cast<const TT*>(table), scale, static_cast<TX*>(out), m, k, n,
      bits);
  return cudaGetLastError();
}

template <typename TX, typename TT>
cudaError_t launch_rows(const void* x, const void* packed, const void* table,
                        const float* scale, void* out, int m, int k, int n,
                        int bits, cudaStream_t stream) {
  // the fewest rows per block that cover min(M, 32)
  if (m <= 4)
    return launch<TX, TT, 1>(x, packed, table, scale, out, m, k, n, bits,
                             stream);
  if (m <= 8)
    return launch<TX, TT, 2>(x, packed, table, scale, out, m, k, n, bits,
                             stream);
  if (m <= 16)
    return launch<TX, TT, 4>(x, packed, table, scale, out, m, k, n, bits,
                             stream);
  return launch<TX, TT, 8>(x, packed, table, scale, out, m, k, n, bits,
                           stream);
}

}  // namespace

extern "C" int codr_matmul_launch(const void* x, const void* packed,
                                  const void* table, const void* scale,
                                  void* out, int m, int k, int n, int bits,
                                  int x_bf16, int table_bf16, void* stream) {
  if (bits != 1 && bits != 2 && bits != 4 && bits != 8 && bits != 16)
    return cudaErrorInvalidValue;
  if (m < 1 || k < 1 || n < 1 || n % (32 / bits) != 0)
    return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (table_bf16)
      return launch_rows<__nv_bfloat16, __nv_bfloat16>(x, packed, table, s,
                                                       out, m, k, n, bits, st);
    return launch_rows<__nv_bfloat16, float>(x, packed, table, s, out, m, k,
                                             n, bits, st);
  }
  if (table_bf16)
    return launch_rows<float, __nv_bfloat16>(x, packed, table, s, out, m, k,
                                             n, bits, st);
  return launch_rows<float, float>(x, packed, table, s, out, m, k, n, bits,
                                   st);
}

extern "C" const char* codr_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
