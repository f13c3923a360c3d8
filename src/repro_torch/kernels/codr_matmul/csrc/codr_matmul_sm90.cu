// CoDR unique-index compressed matmul for Hopper (sm_90a): the tensor-core
// prefill instance.
//
// Replaces the Pallas TPU kernel src/repro/kernels/codr_matmul/kernel.py:70
// (codr_matmul_pallas, with _codr_matmul_kernel / _decode_block) at
// prefill widths (ops.py routes M > 16 with bits 1..8 here).  Same
// operands and function as codr_matmul.cu:
//
//   x       (M, K)             float32 or bfloat16 activations
//   packed  (K, N*bits/32)     uint32 words; index j of a word sits at
//                              bits [j*bits, (j+1)*bits)
//   table   (2^bits,)          float32 or bfloat16 values, bits in 1..8
//   scale   (1,)               float32 per-tensor scale (device memory)
//   out     (M, N)             x's dtype
//
//   out[m, n] = scale * sum_k x[m, k] * table[idx(k, n)],   f32 accumulation
//
// Bound on the H100: at M = 128 the function reads K*N*bits/8 bytes of
// packed weights and does 2*M*K*N flops; at 4 bits the two bounds are
// within a factor of two (down_proj: 3.4 us of bytes, 5.8 us of bf16
// tensor-core work).  The first kernel (codr_matmul.cu) did the products
// as f32 FMAs on the CUDA cores, ~100x the bound.
//
// Design:
// * Tiles.  A block owns a 128 x 128 output tile over a slice of K: 256
//   threads, warpgroup w the rows 64 w .. 64 w + 63.  The grid is (column
//   tile, K slice, row tile); the host (ops.sm90_plan) cuts K into slices
//   of whole 64-row k-tiles so that the blocks fill the card in one round
//   (one block fits on an SM: down_proj at M = 128 is 16 tiles x 8
//   slices).  Per k-tile every thread loads its share of x (8 quads of
//   f32) and of the packed words (bits words, 16-byte loads where rows
//   are whole 16-byte pieces) into registers and stores them, split and
//   decoded, into one of two shared-memory stages.  The two warpgroups
//   run wgmma m64n128k16 on one stage while the next k-tile is stored
//   into the other and the one after is loaded.
// * Layouts.  Both operands are written by the threads in the 128-byte
//   swizzle that a TMA load would give (16-byte chunk c of row r at chunk
//   c ^ (r % 8), 8-row atoms of 1024 bytes): x parts K-major (a row of 64
//   k), as flash_attention_sm90.cu's Q, and the decoded weights MN-major
//   (a k row of 64 columns, two 64-column halves 8 KB apart), as its V,
//   with the transpose bit.  One decoded word of 4-bit indices is one
//   16-byte chunk.  fence.proxy.async makes the writes visible to wgmma.
// * Splitting x.  float32 x goes as three bf16 parts, each the top 16
//   bits of what the earlier ones leave: hi + mid + lo is x exactly (8 +
//   8 + 8 significant bits), at the cost of a mask and a subtraction.
//   Two parts put outputs beyond rtol 2e-3 / atol 2e-4 of the plain
//   version at every main-path shape in an emulation of this arithmetic
//   at M = 128 (tests/test_torch_codr_matmul.py), three put none.  bfloat16 x is one part.
// * Decode.  The table is staged in shared memory in the same three bf16
//   parts, for bits <= 4 as pair tables (one lookup gives two bf16
//   weights).  As it is staged, each thread checks whether its entries
//   are exact in bf16; __syncthreads_or makes the answer the block's.
//   Integer levels of a pack_unique pack always are, and then the weights
//   are one bf16 part.  Otherwise (the tests' random tables) they are
//   three, and part j meets x's parts i with i + j <= 2 (the rest is
//   below 2^-27 of a product).  No host sync and no flag in the pack.
// * Summing.  The tensor cores' f32 accumulation within a wgmma chain is
//   not round-to-nearest: summed over all of K in one accumulator, a few
//   outputs at K = 11008 fell beyond the f32 tolerance.  So each k-tile's
//   products go into a fresh accumulator, added to the slice's sum in
//   f32 registers.  The tensor work is (x parts) x (weight parts) times
//   the function's: 3x for a pack_unique pack and f32 x.
// * Reduce in a fixed order, as codr_matmul_splitk.cu: one slice writes
//   the output; otherwise f32 partials in the wrapper's scratch, an int32
//   ticket per output tile, and the last block sums the partials in
//   slice order, writes the output and sets its counter back to 0.  One
//   launch per call; the same bits from run to run.
// * Costs beyond the bound: x is re-read and re-split by every column
//   tile (86 times at up_proj), the decode and split run on the CUDA
//   cores between the wgmmas, and ptxas gives 242-255 registers a thread
//   (the bits = 8 instances spill up to 116 bytes).
//
// Plain C interface, loaded with ctypes: codr_matmul_sm90_launch returns
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;      // two warpgroups
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kTile = 16384;       // one 128 x 64 or 64 x 128 bf16 tile
constexpr int kHalf = 8192;        // a 64 x 64 half of a B tile

template <typename TX>
struct Smem {
  static constexpr int kXParts = std::is_same<TX, float>::value ? 3 : 1;
  static constexpr int kA = 0;                          // + part * kTile
  static constexpr int kB = kXParts * kTile;            // + part * kTile
  static constexpr int kStage = kB + 3 * kTile;
  static constexpr int kTab = 2 * kStage;         // hi, mid, lo: 1 KB each
  static constexpr int kFlags = kTab + 3072;
  static constexpr int kBytes = kFlags + 16;
  static constexpr int kAlloc = kBytes + 1024;          // slack to align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: the stride between 64-column halves; unused by
// K-major), stride byte offset 1024 (the next 8-row swizzle atom)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the issue / wait
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 16) . B (16 x 128) [+ d]; A K-major, B
// MN-major (transposed), both bf16 in swizzled shared memory
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// byte offset of (row, column c) of a swizzled tile with 128-byte rows
__device__ __forceinline__ uint32_t swz(int row, int c) {
  return row * 128 + ((((c >> 3) ^ row) & 7) << 4) + (c & 7) * 2;
}

// where word j of a thread's share of a k-tile's packed words lies: its
// row in the k-tile and its word in the tile's row (4*BITS words)
template <int BITS>
__device__ __forceinline__ void word_pos(int tid, int j, bool vec, int& row,
                                         int& col) {
  constexpr int kRowWords = 4 * BITS;
  if (BITS >= 4 && vec) {
    const int p = tid + (j / 4) * kThreads;   // 16-byte piece
    row = p / BITS;
    col = 4 * (p % BITS) + j % 4;
  } else {
    const int p = tid + j * kThreads;
    row = p / kRowWords;
    col = p % kRowWords;
  }
}

template <int BITS, typename TX, typename TT>
__global__ void __launch_bounds__(kThreads, 1)
codr_matmul_sm90_kernel(const TX* __restrict__ x,
                        const uint32_t* __restrict__ packed,
                        const TT* __restrict__ table,
                        const float* __restrict__ scale, TX* __restrict__ out,
                        float* __restrict__ partial, int* __restrict__ counters,
                        int m, int k, int n, int kt_per_slice, int slices) {
  using L = Smem<TX>;
  constexpr int XP = L::kXParts;
  constexpr int PW = 32 / BITS;               // indices in a word
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint32_t* tabs = reinterpret_cast<uint32_t*>(base + L::kTab);  // 3 x 256
  int* last_flag = reinterpret_cast<int*>(base + L::kFlags);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.z * kBM;
  const int k_tiles = (k + kBK - 1) / kBK;
  const int t0 = blockIdx.y * kt_per_slice;
  const int nt = min(kt_per_slice, k_tiles - t0);
  const int row_words = n * BITS / 32;
  const int word0 = n0 * BITS / 32;
  const bool w_vec = (row_words % 4 == 0) &&
                     ((reinterpret_cast<uintptr_t>(packed) & 15u) == 0);
  constexpr int kXAlign = 4 * sizeof(TX);
  const bool x_vec = (k % 4 == 0) &&
                     ((reinterpret_cast<uintptr_t>(x) % kXAlign) == 0);

  // ---- the table as three bf16 parts, hi + mid + lo: each the top 16
  // bits of what the earlier ones leave, so the three hold an f32 entry
  // exactly; is every entry exact in bf16 (mid = lo = 0)? -----------------
  bool inexact = false;
  if constexpr (BITS <= 4) {
    constexpr int E = 1 << BITS;
    for (int i = tid; i < E * E; i += kThreads) {
      float a = to_f32(table[i % E]), b = to_f32(table[i / E]);
      inexact |= ((__float_as_uint(a) | __float_as_uint(b)) & 0xFFFFu) != 0;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const uint32_t ah = __float_as_uint(a) & 0xFFFF0000u;
        const uint32_t bh = __float_as_uint(b) & 0xFFFF0000u;
        tabs[p * 256 + i] = __byte_perm(ah, bh, 0x7632);
        a -= __uint_as_float(ah);
        b -= __uint_as_float(bh);
      }
    }
  } else {
    uint16_t* t16 = reinterpret_cast<uint16_t*>(tabs);
    for (int i = tid; i < 256; i += kThreads) {
      float a = to_f32(table[i]);
      inexact |= (__float_as_uint(a) & 0xFFFFu) != 0;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const uint32_t ah = __float_as_uint(a) & 0xFFFF0000u;
        t16[p * 512 + i] = static_cast<uint16_t>(ah >> 16);
        a -= __uint_as_float(ah);
      }
    }
  }
  // uniform to the compiler (a shuffle from lane 0), so ptxas does not
  // serialize the wgmmas that depend on it
  const int w_parts =
      __shfl_sync(0xffffffffu, __syncthreads_or(inexact) ? 3 : 1, 0);

  float xr[8][4];            // x quads of the next k-tile
  uint32_t wr[BITS];         // packed words of the next k-tile

  auto load = [&](int t) {
    const int k0 = (t0 + t) * kBK;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + i * kThreads;
      const int gm = m0 + (e >> 4);
      const int gk = k0 + 4 * (e & 15);
      const TX* src = x + (size_t)gm * k + gk;
      if (gm < m && x_vec && gk + 3 < k) {
        if constexpr (std::is_same<TX, float>::value) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          xr[i][0] = v.x; xr[i][1] = v.y; xr[i][2] = v.z; xr[i][3] = v.w;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          xr[i][0] = __uint_as_float(v.x << 16);
          xr[i][1] = __uint_as_float(v.x & 0xFFFF0000u);
          xr[i][2] = __uint_as_float(v.y << 16);
          xr[i][3] = __uint_as_float(v.y & 0xFFFF0000u);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          xr[i][c] = (gm < m && gk + c < k) ? to_f32(src[c]) : 0.f;
      }
    }
    bool loaded = false;
    if constexpr (BITS >= 4) {
      if (w_vec) {
#pragma unroll
        for (int j = 0; j < BITS; j += 4) {
          int r, c;
          word_pos<BITS>(tid, j, true, r, c);
          const int gk = k0 + r, gw = word0 + c;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (gk < k && gw < row_words)
            v = *reinterpret_cast<const uint4*>(
                packed + (size_t)gk * row_words + gw);
          wr[j] = v.x;
          wr[j + 1] = v.y;
          wr[j + 2] = v.z;
          wr[j + 3] = v.w;
        }
        loaded = true;
      }
    }
    if (!loaded) {
#pragma unroll
      for (int j = 0; j < BITS; ++j) {
        int r, c;
        word_pos<BITS>(tid, j, false, r, c);
        const int gk = k0 + r, gw = word0 + c;
        wr[j] = (gk < k && gw < row_words)
                    ? packed[(size_t)gk * row_words + gw]
                    : 0u;
      }
    }
  };

  // registers -> stage s: x split into XP bf16 parts, words decoded into
  // w_parts bf16 tiles
  auto store = [&](int s) {
    uint8_t* stage = base + s * L::kStage;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + i * kThreads;
      const int row = e >> 4, q = e & 15;
      const uint32_t off = swz(row, 4 * q);
      float v[4] = {xr[i][0], xr[i][1], xr[i][2], xr[i][3]};
#pragma unroll
      for (int p = 0; p < XP; ++p) {
        uint32_t h[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          h[c] = __float_as_uint(v[c]) & 0xFFFF0000u;
          v[c] -= __uint_as_float(h[c]);
        }
        *reinterpret_cast<uint2*>(stage + L::kA + p * kTile + off) =
            make_uint2(__byte_perm(h[0], h[1], 0x7632),
                       __byte_perm(h[2], h[3], 0x7632));
      }
    }
#pragma unroll
    for (int j = 0; j < BITS; ++j) {
      int r, c;
      word_pos<BITS>(tid, j, w_vec, r, c);
      const int col = c * PW;                  // first column in the tile
      const uint32_t word = wr[j];
      for (int p = 0; p < w_parts; ++p) {
        const uint32_t* pt = tabs + p * 256;
        uint32_t d[PW / 2];
        if constexpr (BITS <= 4) {
          constexpr uint32_t kMask = (1u << (2 * BITS)) - 1u;
#pragma unroll
          for (int q = 0; q < PW / 2; ++q)
            d[q] = pt[(word >> (2 * BITS * q)) & kMask];
        } else {
          const uint16_t* t16 = reinterpret_cast<const uint16_t*>(pt);
#pragma unroll
          for (int q = 0; q < 2; ++q)
            d[q] = pack2(t16[(word >> (16 * q)) & 255u],
                         t16[(word >> (16 * q + 8)) & 255u]);
        }
        uint8_t* bt = stage + L::kB + p * kTile + (col / 64) * kHalf;
        const int cc = col % 64;
        if constexpr (PW >= 8) {
#pragma unroll
          for (int u = 0; u < PW / 8; ++u)
            *reinterpret_cast<uint4*>(bt + swz(r, cc + 8 * u)) =
                make_uint4(d[4 * u], d[4 * u + 1], d[4 * u + 2], d[4 * u + 3]);
        } else {
          *reinterpret_cast<uint2*>(bt + swz(r, cc)) = make_uint2(d[0], d[1]);
        }
      }
    }
  };

  // the running sum over the slice, and one k-tile's product: the tensor
  // cores' f32 accumulation is not round-to-nearest, so each k-tile starts
  // a fresh wgmma accumulator and is added to the sum in f32, as the
  // emulation in tests/test_torch_codr_matmul.py models it
  float acc[64], tacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  auto mma = [&](int s) {
    const uint32_t a0 = smem_u32(base + s * L::kStage + L::kA) + wg * 64 * 128;
    const uint32_t b0 = smem_u32(base + s * L::kStage + L::kB);
    fence_regs(tacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = desc_sw128(b0 + kk * 16 * 128, kHalf);
#pragma unroll
      for (int xp = 0; xp < XP; ++xp)
        wgmma_m64n128(tacc, desc_sw128(a0 + xp * kTile + kk * 32, 0), db,
                      kk + xp > 0);
    }
    if (w_parts == 3) {
      // the weights' mid and lo parts against x's leading parts: every
      // product of parts i + j <= 2 (the rest is below 2^-27 of a term)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int wp = 1; wp < 3; ++wp) {
          const uint64_t db =
              desc_sw128(b0 + wp * kTile + kk * 16 * 128, kHalf);
#pragma unroll
          for (int xp = 0; xp + wp < 3 && xp < XP; ++xp)
            wgmma_m64n128(tacc, desc_sw128(a0 + xp * kTile + kk * 32, 0), db,
                          1);
        }
    }
    wgmma_commit();
  };

  // tile t: its wgmmas run while tile t + 1 is stored (from registers
  // loaded during tile t - 1) and tile t + 2 is loaded
  if (nt > 0) {
    load(0);
    store(0);
    if (nt > 1) load(1);
    fence_proxy_async();
    __syncthreads();
  }
  for (int t = 0; t < nt; ++t) {
    mma(t & 1);
    if (t + 1 < nt) {
      store((t + 1) & 1);
      if (t + 2 < nt) load(t + 2);
    }
    wgmma_wait<0>();
    fence_regs(tacc);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += tacc[i];
    fence_proxy_async();
    __syncthreads();   // tile t + 1 is stored; tile t's stage is free
  }

  // ---- epilogue: element 4 j + 2 i + c of acc is row 64 wg + 16 warp +
  // lane / 4 + 8 i, column 8 j + 2 (lane % 4) + c --------------------------
  const int lane = tid % 32;
  const int row0 = m0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  const float sc = *scale;
  const bool direct = slices == 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = row0 + 8 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gn = col0 + 8 * j;      // N is even: gn < n covers gn + 1
      if (gn >= n) continue;
      const float a = acc[4 * j + 2 * i], b = acc[4 * j + 2 * i + 1];
      if (direct)
        store2(out + (size_t)gm * n + gn, a * sc, b * sc);
      else
        store2(partial + ((size_t)blockIdx.y * m + gm) * n + gn, a, b);
    }
  }
  if (direct) return;

  // the last block of this tile to finish sums the partials in slice order
  // (after the barrier thread 0 takes the ticket with one acquire-release
  // atomic)
  __syncthreads();
  int* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) {
    *last_flag = ticket_acq_rel(counter) == slices - 1;
  }
  __syncthreads();
  if (!*last_flag) return;
  // a thread owns 16 quads of the tile (rows tid / 32 + 8 u, four columns
  // at 4 (tid % 32)); slice by slice in order, 16 loads in flight
  constexpr int kQuads = kBM * kBN / 4 / kThreads;   // 16
  const int qc = n0 + 4 * (tid % 32);
  float4 v[kQuads];
#pragma unroll
  for (int u = 0; u < kQuads; ++u) v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sl = 0; sl < slices; ++sl) {
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int gm = m0 + tid / 32 + 8 * u;
      if (gm >= m || qc >= n) continue;
      const float4 t =
          __ldcg(reinterpret_cast<const float4*>(
              partial + ((size_t)sl * m + gm) * n + qc));
      v[u].x += t.x;
      v[u].y += t.y;
      v[u].z += t.z;
      v[u].w += t.w;
    }
  }
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int gm = m0 + tid / 32 + 8 * u;
    if (gm >= m || qc >= n) continue;
    TX* o = out + (size_t)gm * n + qc;   // N % 4 == 0 at bits <= 8
    store2(o, v[u].x * sc, v[u].y * sc);
    store2(o + 2, v[u].z * sc, v[u].w * sc);
  }
  if (tid == 0) *counter = 0;
}

template <int BITS, typename TX, typename TT>
cudaError_t launch(const void* x, const void* packed, const void* table,
                   const float* scale, void* out, float* partial,
                   int* counters, int m, int k, int n, int kt, int slices,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      codr_matmul_sm90_kernel<BITS, TX, TT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<TX>::kAlloc);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + kBN - 1) / kBN, slices, (m + kBM - 1) / kBM);
  codr_matmul_sm90_kernel<BITS, TX, TT>
      <<<grid, kThreads, Smem<TX>::kAlloc, stream>>>(
          static_cast<const TX*>(x), static_cast<const uint32_t*>(packed),
          static_cast<const TT*>(table), scale, static_cast<TX*>(out),
          partial, counters, m, k, n, kt, slices);
  return cudaGetLastError();
}

template <typename TX, typename TT>
cudaError_t launch_bits(const void* x, const void* packed, const void* table,
                        const float* scale, void* out, float* partial,
                        int* counters, int m, int k, int n, int bits, int kt,
                        int slices, cudaStream_t stream) {
  switch (bits) {
    case 1:
      return launch<1, TX, TT>(x, packed, table, scale, out, partial,
                               counters, m, k, n, kt, slices, stream);
    case 2:
      return launch<2, TX, TT>(x, packed, table, scale, out, partial,
                               counters, m, k, n, kt, slices, stream);
    case 4:
      return launch<4, TX, TT>(x, packed, table, scale, out, partial,
                               counters, m, k, n, kt, slices, stream);
    default:
      return launch<8, TX, TT>(x, packed, table, scale, out, partial,
                               counters, m, k, n, kt, slices, stream);
  }
}

}  // namespace

// bits in 1..8; K cut into `slices` slices of `kt` 64-row k-tiles, each
// non-empty; bn must be 128 (the tile width); partial (slices, M, N) f32
// when slices > 1; counters one int32 (zero) per (row tile, column tile)
extern "C" int codr_matmul_sm90_launch(const void* x, const void* packed,
                                       const void* table, const void* scale,
                                       void* out, void* partial,
                                       void* counters, int m, int k, int n,
                                       int bits, int x_bf16, int table_bf16,
                                       int bn, int kt, int slices,
                                       void* stream) {
  if (bits != 1 && bits != 2 && bits != 4 && bits != 8)
    return cudaErrorInvalidValue;
  if (m < 1 || k < 1 || n < 1 || n % (32 / bits) != 0 || bn != kBN)
    return cudaErrorInvalidValue;
  const int k_tiles = (k + kBK - 1) / kBK;
  if (kt < 1 || slices < 1 || (long long)kt * slices < k_tiles ||
      (long long)kt * (slices - 1) >= k_tiles || slices > 65535 ||
      (m + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  if (slices > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  float* p = static_cast<float*>(partial);
  int* c = static_cast<int*>(counters);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (table_bf16)
      return launch_bits<__nv_bfloat16, __nv_bfloat16>(
          x, packed, table, s, out, p, c, m, k, n, bits, kt, slices, st);
    return launch_bits<__nv_bfloat16, float>(x, packed, table, s, out, p, c,
                                             m, k, n, bits, kt, slices, st);
  }
  if (table_bf16)
    return launch_bits<float, __nv_bfloat16>(x, packed, table, s, out, p, c,
                                             m, k, n, bits, kt, slices, st);
  return launch_bits<float, float>(x, packed, table, s, out, p, c, m, k, n,
                                   bits, kt, slices, st);
}

extern "C" const char* codr_matmul_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
