// CoDR unique-index compressed matmul for Hopper (sm_90a): the split-K
// decode instance.
//
// Replaces the Pallas TPU kernel src/repro/kernels/codr_matmul/kernel.py:70
// (codr_matmul_pallas, with _codr_matmul_kernel / _decode_block) at decode
// widths (ops.py routes M <= 16 here, and bits = 16, which the sm90
// instance does not take, up to M = 96).  Same operands and function as
// codr_matmul.cu:
//
//   x       (M, K)             float32 or bfloat16 activations
//   packed  (K, N*bits/32)     uint32 words; index j of a word sits at
//                              bits [j*bits, (j+1)*bits)
//   table   (2^bits,)          float32 or bfloat16 values
//   scale   (1,)               float32 per-tensor scale (device memory)
//   out     (M, N)             x's dtype
//
//   out[m, n] = scale * sum_k x[m, k] * table[idx(k, n)],   f32 accumulation
//
// Bound on the H100: at M = 4 the function moves the packed weights,
// K*N*bits/8 bytes, and little else: 11.3 MB for qwen2.5-3b's down_proj
// at 4 bits, 3.4 us at 3.35 TB/s.  The first kernel (codr_matmul.cu) ran
// one block per 64 columns over all of K (4 blocks for k_proj, 32 for
// down_proj, on 132 SMs) with 4-byte loads, one chunk in flight.
//
// Design:
// * Fill the card.  The grid is (column tile, K slice, row tile).  The
//   host (ops.splitk_plan) picks the widest column tile, 256, 128 or 64
//   columns, that still fills the card, and cuts K into slices so that
//   every projection launches at least 132 blocks and at most as many as
//   are resident at once (two an SM at M <= 4, whose instance is held to
//   128 registers): at M = 4, k_proj 4 tiles x 33 slices, q/o 16 x 16,
//   up/gate 43 x 6, down_proj 16 x 16.  Grids just past a whole round
//   (136, 144, 272 blocks) were slower on the H100: some SMs ran a
//   second round.  Among the rest the host takes the widest tile whose
//   last block reads the partials in the fewest rounds.
// * Load 16 bytes at a time.  A block streams its (slice x tile) of
//   packed words through a ring of four 8 KB stages with cp.async: each
//   thread copies 16-byte pieces (32 indices at 4 bits), neighbouring
//   threads neighbouring addresses, a narrow tile (k_proj: 64 columns,
//   32 bytes a row) spanning K rows rather than columns.  Three stages
//   are in flight while the fourth is multiplied.  Pieces past K or N
//   are zero-filled by the copy.  Where a row is not a whole number of
//   16-byte pieces (N*bits/32 % 4 != 0, or the tile's words) the copies
//   are 4 bytes.
// * Decode cheaply.  The block stages its x slice (RM rows, f32, k-major
//   so one float4 read gives four rows; float32 x by 4-byte cp.async in
//   the ring's first group) and the table in shared memory.  For bits <=
//   4 the table is a pair table, 2^(2 bits) float2: one lookup decodes
//   two indices.  bits = 8 looks up one index at a time; bits = 16 reads
//   the table through the read-only cache (65,536 entries).  The table is
//   kept in 8 copies, lane l reading copy l % 8, which spreads a warp's
//   random lookups over the banks (with one copy they pile onto few
//   banks, and the main loop was bound by them); 16 copies spread them
//   further but cost small projections more to stage than they save.  A thread owns 8 columns of the tile
//   (8*bits bits of a row) and RM rows of x: 8*RM f32 accumulators, 128
//   at RM = 16.  The threads of one column group split the chunk's rows
//   among them.
// * Reduce in a fixed order.  The row lanes of a column group are summed
//   through shared memory in lane order.  With one slice the block
//   writes the output.  Otherwise it writes its f32 partial (slices x M x
//   N), and thread 0 takes a ticket from the tile's int32 counter with
//   one acquire-release atomic; the block that takes the last ticket
//   sums the partials in slice order, writes the output and sets the
//   counter back to 0.  The counters and partials live in one scratch
//   buffer the wrapper keeps per stream (zeroed once when made).  So a
//   call is one launch, repeats bit for bit, uses no float atomics, and
//   needs no clearing or allocation between calls.
// * Cost beyond the bytes: RM FMAs per weight on the CUDA cores (at
//   M = 4, 90 M FMAs for down_proj, 2.7 us at 67 TFLOP/s, beside its
//   3.4 us byte bound), and the partials (slices x M x N x 4 bytes,
//   written and read once, in L2).  Timed on the card with the L2 flushed
//   (PERF.md), a launch takes 10-24 us above a ~5 us launch
//   floor; a small projection's time (q/o, k/v) is latency: the launch,
//   the first bytes from DRAM, the ticket and the last block's reads.
//
// Plain C interface, loaded with ctypes: codr_matmul_splitk_launch returns
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kStageBytes = 8192;
constexpr int kRing = kStages * kStageBytes;       // 32 KB
constexpr int kRep = 8;                            // copies of the table
constexpr int kMaxXBytes = 32768;                  // the x slice, RM x ks f32

// shared memory: the ring, the table copies (pair tables of 2^(2 bits)
// float2 for bits <= 4, 256 float for bits = 8, none for 16), the x slice,
// a flag.  A launch asks for what its bits and slice need, so a small
// projection does not reserve the largest carve-out of the SM.
template <int BITS>
__host__ __device__ constexpr int table_bytes() {
  return BITS <= 4 ? (1 << (2 * BITS)) * kRep * 8 : BITS == 8 ? 256 * kRep * 4
                                                              : 0;
}
template <int BITS>
__host__ __device__ constexpr int smem_bytes(int x_bytes) {
  return kRing + table_bytes<BITS>() + x_bytes + 16;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four partials from L2 (not L1: other blocks wrote them), `left` of them
// inside the row, where N is not a multiple of 4
__device__ __forceinline__ float4 load4(const float* p, int left) {
  return make_float4(__ldcg(p), left > 1 ? __ldcg(p + 1) : 0.f,
                     left > 2 ? __ldcg(p + 2) : 0.f,
                     left > 3 ? __ldcg(p + 3) : 0.f);
}

// scale * v into up to four outputs, `left` of them inside the row
template <typename TX>
__device__ __forceinline__ void store4(TX* o, float4 v, int left, float s) {
  store_out(o, v.x * s);
  if (left > 1) store_out(o + 1, v.y * s);
  if (left > 2) store_out(o + 2, v.z * s);
  if (left > 3) store_out(o + 3, v.w * s);
}

// counter's old value, counter + 1 after; release (this block's writes,
// ordered before by a barrier, are visible first) and acquire (the writes
// of the blocks before it are visible after), at gpu scope
__device__ __forceinline__ int ticket_acq_rel(int* counter) {
  int prev;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(prev)
               : "l"(counter)
               : "memory");
  return prev;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the 8 indices of a column group at 8*BITS bits from `p` (the group's
// first word in shared memory; `sub` is the group's bit offset in it
// for BITS < 4), decoded to f32.  `tab` is this lane's copy of the table:
// entry e at tab[e * kRep] (float2 entries for BITS <= 4)
template <int BITS, typename TT>
__device__ __forceinline__ void decode8(const uint32_t* p, int sub,
                                        const float* tab,
                                        const TT* __restrict__ table,
                                        float (&w)[8]) {
  if constexpr (BITS <= 4) {
    constexpr uint32_t kPairMask = (1u << (2 * BITS)) - 1u;
    const uint32_t v = p[0] >> sub;
    const float2* pt = reinterpret_cast<const float2*>(tab);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = pt[((v >> (2 * BITS * q)) & kPairMask) * kRep];
      w[2 * q] = f.x;
      w[2 * q + 1] = f.y;
    }
  } else if constexpr (BITS == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = tab[((v.x >> (8 * j)) & 255u) * kRep];
      w[4 + j] = tab[((v.y >> (8 * j)) & 255u) * kRep];
    }
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[2 * j] = to_f32(table[u[j] & 0xFFFFu]);
      w[2 * j + 1] = to_f32(table[u[j] >> 16]);
    }
  }
}

// two blocks an SM at RM = 4 (at most 128 registers a thread), one above
template <int BITS, int RM, typename TX, typename TT>
__global__ void __launch_bounds__(kThreads, RM == 4 ? 2 : 1)
codr_matmul_splitk_kernel(const TX* __restrict__ x,
                          const uint32_t* __restrict__ packed,
                          const TT* __restrict__ table,
                          const float* __restrict__ scale,
                          TX* __restrict__ out, float* __restrict__ partial,
                          int* __restrict__ counters, int m, int k, int n,
                          int tn, int ks, int slices) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* tab = reinterpret_cast<float*>(smem + kRing);
  float* xs = reinterpret_cast<float*>(smem + kRing + table_bytes<BITS>());
  int* last_flag = reinterpret_cast<int*>(xs + ks * RM);

  const int tid = threadIdx.x;
  const int ng = tn / 8;                      // column groups of the tile
  const int g = tid % ng;
  const int lane = tid / ng;                  // row lane of the group
  const int n_lanes = kThreads / ng;
  const int n0 = blockIdx.x * tn;
  const int m0 = blockIdx.z * RM;
  const int k_begin = blockIdx.y * ks;
  const int k_end = min(k, k_begin + ks);
  const int row_words = n * BITS / 32;
  const int tile_words = tn * BITS / 32;      // words of one tile row
  const int word0 = n0 * BITS / 32;
  const int chunk_rows = kStageBytes / (tile_words * 4);
  const int n_chunks = (k_end - k_begin + chunk_rows - 1) / chunk_rows;
  // 16-byte pieces when every row of the tile is whole pieces at
  // 16-byte aligned addresses
  const bool vec = (row_words % 4 == 0) && (tile_words % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(packed) & 15u) == 0);

  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int r0 = k_begin + c * chunk_rows;
      const uint32_t dst = smem_u32(smem + (c % kStages) * kStageBytes);
      if (vec) {
        const int per_row = tile_words / 4;
#pragma unroll 1
        for (int p = tid; p < chunk_rows * per_row; p += kThreads) {
          const int r = p / per_row;
          const int w = word0 + 4 * (p % per_row);
          const bool ok = r0 + r < k_end && w < row_words;
          cp_async16(dst + 16 * p,
                     ok ? packed + (size_t)(r0 + r) * row_words + w : packed,
                     ok);
        }
      } else {
#pragma unroll 1
        for (int p = tid; p < chunk_rows * tile_words; p += kThreads) {
          const int r = p / tile_words;
          const int w = word0 + p % tile_words;
          const bool ok = r0 + r < k_end && w < row_words;
          cp_async4(dst + 4 * p,
                    ok ? packed + (size_t)(r0 + r) * row_words + w : packed,
                    ok);
        }
      }
    }
    cp_async_commit();
  };

  // the x slice, k-major (xs[kk * RM + r]): float32 by 4-byte cp.async
  // copies into the first group of the ring, so its latency is the first
  // chunk's; bfloat16 through registers, eight loads in flight
  const int k_len = k_end - k_begin;
  const int x_count = RM * k_len;
  if constexpr (std::is_same<TX, float>::value) {
#pragma unroll 1
    for (int i = tid; i < x_count; i += kThreads) {
      const int r = i / k_len, kk = i % k_len;
      const int gm = m0 + r;
      cp_async4(smem_u32(xs + kk * RM + r),
                gm < m ? x + (size_t)gm * k + k_begin + kk : x, gm < m);
    }
  }
#pragma unroll 1
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  if constexpr (!std::is_same<TX, float>::value) {
    for (int i0 = tid; i0 < x_count; i0 += 8 * kThreads) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        const int gm = m0 + i / k_len;
        v[u] = (i < x_count && gm < m)
                   ? to_f32(x[(size_t)gm * k + k_begin + i % k_len])
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        if (i < x_count) xs[(i % k_len) * RM + i / k_len] = v[u];
      }
    }
  }

  if constexpr (BITS <= 4) {
    constexpr int kEntries = 1 << BITS;
    // a compile-time count of entries a thread, so every load is in
    // flight before the first store
    constexpr int kCopies = kEntries * kEntries * kRep;
    constexpr int kEach = (kCopies + kThreads - 1) / kThreads;
    float2* pt = reinterpret_cast<float2*>(tab);
    float2 v[kEach];
#pragma unroll
    for (int j = 0; j < kEach; ++j) {
      const int e = (tid + j * kThreads) / kRep;
      v[j] = tid + j * kThreads < kCopies
                 ? make_float2(to_f32(table[e % kEntries]),
                               to_f32(table[e / kEntries]))
                 : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kEach; ++j)
      if (tid + j * kThreads < kCopies) pt[tid + j * kThreads] = v[j];
  } else if constexpr (BITS == 8) {
    float v[256 * kRep / kThreads];
#pragma unroll
    for (int j = 0; j < 256 * kRep / kThreads; ++j)
      v[j] = to_f32(table[(tid + j * kThreads) / kRep]);
#pragma unroll
    for (int j = 0; j < 256 * kRep / kThreads; ++j)
      tab[tid + j * kThreads] = v[j];
  }

  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  // the group's bits in a tile row: word g*BITS/4, bit offset for BITS < 4
  const int g_word = g * BITS / 4;
  const int g_sub = (g * 8 * BITS) % 32;

  // the lanes of a warp read kRep copies of the table (lane l the copy
  // l % kRep), so a lookup costs few shared-memory wavefronts whatever
  // the indices
  const float* my_tab = tab + (tid % kRep) * (BITS <= 4 ? 2 : 1);

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(c + kStages - 1);
    const uint32_t* stage =
        reinterpret_cast<const uint32_t*>(smem + (c % kStages) * kStageBytes);
    const int r0 = c * chunk_rows;             // relative to k_begin
    const int rows = min(chunk_rows, k_len - r0);
#pragma unroll 1
    for (int r = lane; r < rows; r += n_lanes) {
      float w[8];
      decode8<BITS, TT>(stage + r * tile_words + g_word, g_sub, my_tab, table,
                        w);
      const float* xr = xs + (r0 + r) * RM;
#pragma unroll
      for (int q = 0; q < RM / 4; ++q) {
        const float4 xv = reinterpret_cast<const float4*>(xr)[q];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * q][j] = fmaf(xv.x, w[j], acc[4 * q][j]);
          acc[4 * q + 1][j] = fmaf(xv.y, w[j], acc[4 * q + 1][j]);
          acc[4 * q + 2][j] = fmaf(xv.z, w[j], acc[4 * q + 2][j]);
          acc[4 * q + 3][j] = fmaf(xv.w, w[j], acc[4 * q + 3][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // sum the row lanes in lane order through the ring, four rows of x at a
  // time (4 x n_lanes x tn f32 = 32 KB); write the output or the partial
  float* red = reinterpret_cast<float*>(smem);
  const int plane = n_lanes * tn;
  const float s = *scale;
  const bool direct = slices == 1;
#pragma unroll
  for (int r0 = 0; r0 < RM; r0 += 4) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float4* dst =
          reinterpret_cast<float4*>(red + rr * plane + lane * tn + 8 * g);
      dst[0] = make_float4(acc[r0 + rr][0], acc[r0 + rr][1], acc[r0 + rr][2],
                           acc[r0 + rr][3]);
      dst[1] = make_float4(acc[r0 + rr][4], acc[r0 + rr][5], acc[r0 + rr][6],
                           acc[r0 + rr][7]);
    }
    __syncthreads();
    for (int i = tid; i < 4 * tn; i += kThreads) {
      const int rr = i / tn, col = i % tn;
      float v = 0.f;
#pragma unroll 8
      for (int l = 0; l < n_lanes; ++l) v += red[rr * plane + l * tn + col];
      const int gm = m0 + r0 + rr, gn = n0 + col;
      if (gm < m && gn < n) {
        if (direct)
          store_out(out + (size_t)gm * n + gn, v * s);
        else
          partial[((size_t)blockIdx.y * m + gm) * n + gn] = v;
      }
    }
    __syncthreads();
  }
  if (direct) return;

  // the last block of this tile to finish sums the partials in slice
  // order.  After the barrier, thread 0 takes a ticket with one
  // acquire-release atomic: every thread's partial writes are visible
  // before it, and the last block reads the others' after it.
  __syncthreads();
  int* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) {
    *last_flag = ticket_acq_rel(counter) == slices - 1;
  }
  __syncthreads();
  if (!*last_flag) return;
  // four neighbouring columns a thread, sixteen slices' loads in flight.
  // Where the tile has fewer quads than threads, G = threads / quads
  // threads share a quad: thread j of them sums the j-th run of slices,
  // and the G sums are added in run order (a fixed order all the same).
  const int quads = RM * tn / 4;
  const int runs = quads >= kThreads ? 1 : kThreads / quads;
  const bool whole = n % 4 == 0;
  float4* run_sum = reinterpret_cast<float4*>(smem);   // the ring is free
  for (int i = tid; i < quads * runs; i += kThreads) {
    const int qd = i % quads, j = i / quads;
    const int gm = m0 + qd / (tn / 4), gn = n0 + 4 * (qd % (tn / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gm < m && gn < n) {
      const float* src = partial + (size_t)gm * n + gn;
      const size_t step = (size_t)m * n;
      const int s_end = (j + 1) * slices / runs;
      for (int s0 = j * slices / runs; s0 < s_end; s0 += 16) {
        float4 t[16];
#pragma unroll
        for (int u = 0; u < 16; ++u)
          t[u] = s0 + u >= s_end ? make_float4(0.f, 0.f, 0.f, 0.f)
                 : whole ? __ldcg(reinterpret_cast<const float4*>(
                               src + (s0 + u) * step))
                         : load4(src + (s0 + u) * step, n - gn);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          v.x += t[u].x;
          v.y += t[u].y;
          v.z += t[u].z;
          v.w += t[u].w;
        }
      }
    }
    if (runs > 1) {
      run_sum[i] = v;
      continue;
    }
    if (gm < m && gn < n) store4(out + (size_t)gm * n + gn, v, n - gn, s);
  }
  if (runs > 1) {
    __syncthreads();
    for (int qd = tid; qd < quads; qd += kThreads) {
      const int gm = m0 + qd / (tn / 4), gn = n0 + 4 * (qd % (tn / 4));
      if (gm >= m || gn >= n) continue;
      float4 v = run_sum[qd];
      for (int j = 1; j < runs; ++j) {
        const float4 t = run_sum[j * quads + qd];
        v.x += t.x;
        v.y += t.y;
        v.z += t.z;
        v.w += t.w;
      }
      store4(out + (size_t)gm * n + gn, v, n - gn, s);
    }
  }
  if (tid == 0) *counter = 0;
}

template <int BITS, int RM, typename TX, typename TT>
cudaError_t launch(const void* x, const void* packed, const void* table,
                   const float* scale, void* out, float* partial,
                   int* counters, int m, int k, int n, int tn, int ks,
                   int slices, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      codr_matmul_splitk_kernel<BITS, RM, TX, TT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<BITS>(kMaxXBytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + tn - 1) / tn, slices, (m + RM - 1) / RM);
  codr_matmul_splitk_kernel<BITS, RM, TX, TT>
      <<<grid, kThreads, smem_bytes<BITS>(ks * RM * 4), stream>>>(
      static_cast<const TX*>(x), static_cast<const uint32_t*>(packed),
      static_cast<const TT*>(table), scale, static_cast<TX*>(out), partial,
      counters, m, k, n, tn, ks, slices);
  return cudaGetLastError();
}

template <int BITS, typename TX, typename TT>
cudaError_t launch_rows(const void* x, const void* packed, const void* table,
                        const float* scale, void* out, float* partial,
                        int* counters, int m, int k, int n, int tn, int ks,
                        int slices, cudaStream_t stream) {
  // rows of x per block: 4, 8 or 16 (ops.splitk_plan's rm)
  if (m <= 4)
    return launch<BITS, 4, TX, TT>(x, packed, table, scale, out, partial,
                                   counters, m, k, n, tn, ks, slices, stream);
  if (m <= 8)
    return launch<BITS, 8, TX, TT>(x, packed, table, scale, out, partial,
                                   counters, m, k, n, tn, ks, slices, stream);
  return launch<BITS, 16, TX, TT>(x, packed, table, scale, out, partial,
                                  counters, m, k, n, tn, ks, slices, stream);
}

template <typename TX, typename TT>
cudaError_t launch_bits(const void* x, const void* packed, const void* table,
                        const float* scale, void* out, float* partial,
                        int* counters, int m, int k, int n, int bits, int tn,
                        int ks, int slices, cudaStream_t stream) {
  switch (bits) {
    case 1:
      return launch_rows<1, TX, TT>(x, packed, table, scale, out, partial,
                                    counters, m, k, n, tn, ks, slices, stream);
    case 2:
      return launch_rows<2, TX, TT>(x, packed, table, scale, out, partial,
                                    counters, m, k, n, tn, ks, slices, stream);
    case 4:
      return launch_rows<4, TX, TT>(x, packed, table, scale, out, partial,
                                    counters, m, k, n, tn, ks, slices, stream);
    case 8:
      return launch_rows<8, TX, TT>(x, packed, table, scale, out, partial,
                                    counters, m, k, n, tn, ks, slices, stream);
    default:
      return launch_rows<16, TX, TT>(x, packed, table, scale, out, partial,
                                     counters, m, k, n, tn, ks, slices,
                                     stream);
  }
}

}  // namespace

// tn in {64, 128, 256}; K cut into `slices` slices of `ks` rows, each
// non-empty, ks * rows-per-block * 4 <= 32 KB; partial (slices, M, N)
// f32 when slices > 1; counters one int32 (zero) per (row tile, column
// tile)
extern "C" int codr_matmul_splitk_launch(const void* x, const void* packed,
                                         const void* table, const void* scale,
                                         void* out, void* partial,
                                         void* counters, int m, int k, int n,
                                         int bits, int x_bf16, int table_bf16,
                                         int tn, int ks, int slices,
                                         void* stream) {
  if (bits != 1 && bits != 2 && bits != 4 && bits != 8 && bits != 16)
    return cudaErrorInvalidValue;
  if (m < 1 || k < 1 || n < 1 || n % (32 / bits) != 0)
    return cudaErrorInvalidValue;
  if (tn != 64 && tn != 128 && tn != 256) return cudaErrorInvalidValue;
  const int rm = m <= 4 ? 4 : m <= 8 ? 8 : 16;
  if (ks < 1 || slices < 1 || (long long)ks * slices < k ||
      (long long)ks * (slices - 1) >= k || ks * rm * 4 > kMaxXBytes ||
      slices > 65535 || (m + rm - 1) / rm > 65535)
    return cudaErrorInvalidValue;
  if (slices > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  float* p = static_cast<float*>(partial);
  int* c = static_cast<int*>(counters);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (table_bf16)
      return launch_bits<__nv_bfloat16, __nv_bfloat16>(
          x, packed, table, s, out, p, c, m, k, n, bits, tn, ks, slices, st);
    return launch_bits<__nv_bfloat16, float>(x, packed, table, s, out, p, c,
                                             m, k, n, bits, tn, ks, slices,
                                             st);
  }
  if (table_bf16)
    return launch_bits<float, __nv_bfloat16>(x, packed, table, s, out, p, c,
                                             m, k, n, bits, tn, ks, slices,
                                             st);
  return launch_bits<float, float>(x, packed, table, s, out, p, c, m, k, n,
                                   bits, tn, ks, slices, st);
}

extern "C" const char* codr_matmul_splitk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
