// Flash attention for Hopper (sm_90a): the tensor-core instance.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:67
// (flash_attention_pallas, with _flash_kernel) and the GQA head repeat of
// its wrapper, src/repro/kernels/flash_attention/ops.py:10, for bfloat16
// q / k / v with D = Dv in {64, 128}.  flash_attention.cu is the CUDA-core
// instance and takes every other shape and float32; ops.py routes between
// them.  Same function as there:
//
//   q    (B, Sq, Hq, D)     bfloat16
//   k    (B, Sk, Hkv, D)    bfloat16
//   v    (B, Sk, Hkv, D)    bfloat16
//   out  (B, Sq, Hq, D)     bfloat16
//
//   s[i, j]  = (q[i] . k[j]) * D^-1/2            -1e30 where causal and i < j
//                                                (top-left: key 0 is visible
//                                                to every row)
//   out[i]   = sum_j softmax(s[i])[j] v[j]       online: f32 running max,
//                                                denominator, accumulator,
//                                                acc / max(l, 1e-30)
//
// q head h reads kv head h / (Hq / Hkv) in place (no repeat).
//
// Bound on the H100: at the qwen2.5-3b widths (Hq 16, Hkv 2, D 128) and
// S in the thousands the function does 2 * B * Hq * pairs * (D + Dv) flops
// on ~S * (Hq + 2 Hkv) * D bf16 values, so it is bound by operations, at
// the bf16 tensor-core rate (989 TFLOP/s): 0.0695 ms at B = 1, S = 4096,
// causal.
//
// Design:
// * Roles.  A block owns a 128-row q tile of one (batch, q head): 384
//   threads, warpgroup 0 the producer, warpgroups 1 and 2 the consumers
//   of rows 0..63 and 64..127.  One producer thread issues TMA loads: Q
//   once, then the K and V tiles (64 kv rows each) into a two-stage ring;
//   each stage has a K-full, a V-full and an empty mbarrier, so S = Q.K^T
//   starts before V has landed.  setmaxnreg moves registers from the
//   producer (40) to the consumers (232), but ptxas allocated every path
//   within the 168 a thread has at launch (384 threads, one block per
//   SM): 128-row kv tiles spilled at D = 128, 64-row tiles do not, and
//   neither does a deeper ring help (2, 3 and 4 stages time the same on
//   the H100).  Issuing tile t+1's Q.K^T before tile t's P.V, to run the
//   softmax under it, made ptxas serialize the wgmmas and was slower.
// * Tensor maps describe the (B, S, H, D) layout itself: box 64 x 1 x rows
//   x 1 with 128-byte swizzle, a D = 128 row split into two 64-element
//   boxes (the 128-byte swizzle's limit).  So no transposed or repeated
//   copy is made, rows past Sq / Sk are zero-filled by the TMA, and each
//   64-column half of a tile is one K-major (Q, K) or MN-major (V) wgmma
//   operand.  The maps are encoded on the host for each launch
//   (cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint, so the
//   build links no libcuda) and passed as __grid_constant__ parameters.
// * S = Q.K^T: wgmma m64n64k16, bf16 in, f32 accumulate, A and B both
//   K-major from swizzled shared memory (a 16-wide k-slice is 32 bytes
//   into the swizzled row).  Scale, mask and the online softmax run on
//   the accumulator fragment in registers; a row's max and sum are xor
//   shuffles over the four lanes that hold it, in a fixed order, so two
//   runs give the same bits.
// * O += P.V: wgmma m64n64k16 with A from registers and V an MN-major B
//   (the transpose bit), P in parts.  The bf16 output is held to one bf16
//   ulp of the f32 plain version (rtol 2^-7, atol 1e-6), and P rounded to
//   bf16 before the product fails that bound (SDPA does so).  Two parts,
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), leave a residual of up to
//   2^-18 of P: where a row has few keys and its output cancels to ~1e-4
//   of its terms, that is ~2e-6, beyond the bound (a few elements in ten
//   million, on the card and in an exact emulation).  So P is split into
//   three: P_hi, P_mid = bf16(P - P_hi), P_lo = bf16(P - P_hi - P_mid),
//   every subtraction exact in f32, residual ~2^-27.  The three parts go
//   through the tensor cores against the same V stage.  For 16-bit A the
//   m64 accumulator fragment is the A-register fragment, so the parts are
//   packed in place.  The denominator sums the f32 P.  The cost is twice
//   the function's tensor-core work (P.V three times over); the bound
//   above counts the function's, not the kernel's.
// * What the CUDA-core instance got right stays: kv tiles wholly above
//   the diagonal of the block's last valid row are skipped, tiles that
//   cross the diagonal or Sk are masked per element, columns past Sk are
//   kept out of the max and the sums (p = 0; a -1e30 score in a row whose
//   max is still -1e30 would count exp(0) = 1), rows past Sq are computed
//   and not stored, and the shared-memory attribute is set once per
//   instance.  A barrier wait that never completes traps instead of
//   hanging the card.
//
// Plain C interface, loaded with ctypes: flash_attention_sm90_launch
// returns cudaGetLastError() after the launch (0 = launched), or
// kErrEncode when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBQ = 128;            // q rows per block (two consumers)
constexpr int kBK = 64;             // kv rows per ring stage
constexpr int kParts = 3;           // bf16 parts of P in the P.V product
constexpr int kStages = 2;          // ring depth
constexpr int kThreads = 384;       // producer warpgroup + two consumers
constexpr int kBox = 64;            // bf16 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65,536
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kErrEncode = 10001;
constexpr uint32_t kMaxTries = 1u << 26;   // mbarrier polls before a trap

// shared memory, in bytes from a 1024-aligned base: Q (D / 64 halves of
// kBQ rows), the K and V rings (D / 64 halves of kBK rows per stage),
// then the mbarriers q_full, k_full[kStages], v_full[kStages],
// empty[kStages]
template <int D>
struct Smem {
  static constexpr int kHalves = D / kBox;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;   // slack to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed; a barrier that
// never completes (a fault in this kernel) traps, which fails the launch,
// rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == kMaxTries) __trap();
  }
}

// TMA: box at coordinates (c0 innermost .. c3) into shared memory at dst
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the issue / wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int A, int B>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[A][B][4]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[a][b][j])::"memory");
}

#define FA_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define FA_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, f32) = A (64 x 16) . B (16 x 64) [+ d]; A and B K-major bf16
// in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64); B
// MN-major bf16 in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// Accumulator fragment of a 64 x 64 f32 wgmma tile, thread t of the
// warpgroup (warp w = t / 32, lane l): element 4 j + 2 i + c holds row
// 16 w + l / 4 + 8 i, column 8 j + 2 (l % 4) + c (j < 8, i < 2, c < 2).
// The bf16 A-register fragment of a 64 x 16 tile is the same map for two
// neighbouring j: register r of k-slice kk holds j = 2 (kk % 4) + r / 2,
// i = r % 2, both c.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ out, int sq,
                                int sk, int hq, int hkv, int causal,
                                float scale_log2) {
  using L = Smem<D>;
  constexpr int kO = D / 64;      // 64-column output tiles
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8;                   // + 8 s
  const uint32_t bar_v = bar_k + 8 * kStages;         // + 8 s
  const uint32_t bar_e = bar_v + 8 * kStages;         // + 8 s

  const int h = blockIdx.x % hq;
  const int b = blockIdx.x / hq;
  const int hk = h / (hq / hkv);
  // the longest q tiles (most kv tiles under the causal mask) go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, sq) - 1) / kBK + 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * 128);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, uniform to the compiler (a shuffle from lane 0),
  // so ptxas keeps each role's register budget apart
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kHalves; ++c)
        tma_load_4d(base + L::kQ + c * kBQ * kRowBytes, &tq, bar_q, c * kBox,
                    h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        // the consumers released this stage's previous tile
        if (t >= kStages) mbar_wait(bar_e + 8 * s, ((t / kStages) - 1) & 1);
        const uint32_t k_dst = base + L::kK + s * L::kKVBytes;
        const uint32_t v_dst = base + L::kV + s * L::kKVBytes;
        mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
#pragma unroll
        for (int c = 0; c < L::kHalves; ++c)
          tma_load_4d(k_dst + c * kBK * kRowBytes, &tk, bar_k + 8 * s,
                      c * kBox, hk, t * kBK, b);
        mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
#pragma unroll
        for (int c = 0; c < L::kHalves; ++c)
          tma_load_4d(v_dst + c * kBK * kRowBytes, &tv, bar_v + 8 * s,
                      c * kBox, hk, t * kBK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw takes q rows 64 cw .. 64 cw + 63 -------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int lane = tid % 32;
    // this thread's fragment: rows row0 + 8 i, columns col0 + 8 j + c
    const int row0 = q0 + 64 * cw + 16 * ((tid % 128) / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);

    float o[kO][32];
#pragma unroll
    for (int n = 0; n < kO; ++n)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[n][e] = 0.f;
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.f, 0.f};

    const uint32_t q_smem = base + L::kQ + 64 * cw * kRowBytes;
    mbar_wait(bar_q, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const int k0 = t * kBK;
      const uint32_t k_smem = base + L::kK + s * L::kKVBytes;
      const uint32_t v_smem = base + L::kV + s * L::kKVBytes;

      // S = Q . K^T over D in 16-wide k-slices (32 bytes of a swizzled row)
      float sc[32];
      mbar_wait(bar_k + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t half = kk / 4, off = (kk % 4) * 32;
        wgmma_ss(sc, desc_sw128(q_smem + half * kBQ * kRowBytes + off, 0),
                 desc_sw128(k_smem + half * kBK * kRowBytes + off, 0), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, mask, online softmax (log2 domain: scale_log2 = D^-1/2 log2 e)
      const bool edge =
          k0 + kBK > sk || (causal && k0 + kBK - 1 > q0 + 64 * cw);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e / 2) % 2;
        float x = sc[e] * scale_log2;
        if (edge) {
          const int kv = k0 + 8 * (e / 4) + col0 + e % 2;
          if (kv >= sk)
            x = -CUDART_INF_F;   // past Sk: out of the max, p = 0
          else if (causal && kv > row0 + 8 * i)
            x = kNeg;
        }
        sc[e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = quad_max(mx[i]);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sc[e] = exp2f(sc[e] - m[(e / 2) % 2]);
        sum[(e / 2) % 2] += sc[e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);

      // P = P_hi + P_mid + P_lo, each part packed into A-register
      // fragments; every subtraction is exact in f32
      uint32_t pa[kParts][kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 4 * (2 * kk + r / 2) + 2 * (r % 2);
          float p0 = sc[e], p1 = sc[e + 1];
#pragma unroll
          for (int part = 0; part < kParts; ++part) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
            const float2 hf = __bfloat1622float2(h);
            pa[part][kk][r] = bf16x2_bits(h);
            p0 -= hf.x;
            p1 -= hf.y;
          }
        }
#pragma unroll
      for (int n = 0; n < kO; ++n)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[n][e] *= corr[(e / 2) % 2];

      // O += (P_hi + P_mid + P_lo) . V, 16 kv rows at a time
      mbar_wait(bar_v + 8 * s, parity);
#pragma unroll
      for (int n = 0; n < kO; ++n) fence_regs(o[n]);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int n = 0; n < kO; ++n) {
          const uint64_t db = desc_sw128(
              v_smem + n * kBK * kRowBytes + kk * 16 * kRowBytes,
              kBK * kRowBytes);
#pragma unroll
          for (int part = 0; part < kParts; ++part)
            wgmma_rs(o[n], pa[part][kk], db);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int n = 0; n < kO; ++n) fence_regs(o[n]);
      fence_regs(pa);
      mbar_arrive(bar_e + 8 * s);   // this warpgroup is done with stage s
    }

    // out = acc / max(l, 1e-30), rows past Sq not stored
    __nv_bfloat16* ob = out + ((size_t)b * sq * hq + h) * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = row0 + 8 * i;
      if (qpos >= sq) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = ob + (size_t)qpos * hq * D;
#pragma unroll
      for (int n = 0; n < kO; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * n + 8 * j + col0) =
              __floats2bfloat162_rn(o[n][4 * j + 2 * i] * inv,
                                    o[n][4 * j + 2 * i + 1] * inv);
    }
  }
}

// ---- host -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (B, S, H, W) bf16 tensor, boxes of 64 columns x `rows` positions of
// one head, 128-byte swizzle, out-of-range rows read as zero
bool encode_map(CUtensorMap* map, const void* ptr, int b, int s, int h,
                int w, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)w * 2, (cuuint64_t)h * w * 2,
                                 (cuuint64_t)s * h * w * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dynamic shared memory above 48 KB is allowed once per instance
template <int D>
cudaError_t allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kAlloc);
  return attr;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int hq, int hkv, int causal, float scale,
           cudaStream_t stream) {
  const cudaError_t attr = allow_smem<D>();
  if (attr != cudaSuccess) return attr;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, b, sq, hq, D, kBQ) ||
      !encode_map(&mk, k, b, sk, hkv, D, kBK) ||
      !encode_map(&mv, v, b, sk, hkv, D, kBK))
    return kErrEncode;
  const dim3 grid(b * hq, (sq + kBQ - 1) / kBQ);
  flash_attention_sm90_kernel<D><<<grid, kThreads, Smem<D>::kAlloc, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), sq, sk, hq, hkv, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
int info(int* regs, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = allow_smem<D>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, flash_attention_sm90_kernel<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_attention_sm90_kernel<D>, kThreads,
        Smem<D>::kAlloc);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem_bytes = Smem<D>::kAlloc;
  return 0;
}

}  // namespace

// q, k, v, out contiguous bf16 (B, S, H, D), 16-byte aligned; D = Dv in
// {64, 128}; Hq % Hkv == 0; Sk >= 1; B * Hq < 2^31; ceil(Sq / 128) <= 65535
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out, int b,
                                           int sq, int sk, int hq, int hkv,
                                           int d, int causal, float scale,
                                           void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hq < 1 || hkv < 1 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  if ((long long)b * hq > 0x7fffffffLL || (sq + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, out, b, sq, sk, hq, hkv, causal, scale, st);
  if (d == 128)
    return launch<128>(q, k, v, out, b, sq, sk, hq, hkv, causal, scale, st);
  return cudaErrorInvalidValue;
}

// registers a thread at launch (before setmaxnreg), dynamic shared memory
// bytes and resident blocks per SM of the D instance
extern "C" int flash_attention_sm90_info(int d, int* regs, int* smem_bytes,
                                         int* blocks_per_sm) {
  if (d == 64) return info<64>(regs, smem_bytes, blocks_per_sm);
  if (d == 128) return info<128>(regs, smem_bytes, blocks_per_sm);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_sm90_error_string(int err) {
  if (err == kErrEncode) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
