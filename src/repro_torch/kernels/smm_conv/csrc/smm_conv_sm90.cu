// CoDR scalar-matrix-multiplication convolution for Hopper (sm_90a): the
// tensor-core instance.
//
// Replaces the Pallas TPU kernel src/repro/kernels/smm_conv/kernel.py:88
// (smm_conv_pallas; body _smm_conv_kernel :45, pallas_call :101) for the
// shapes ops.pick_impl routes here: stride 1, weights that fit int8, and a
// window that fits shared memory.  Same operands and function as
// smm_conv.cu (the `simt` instance, which keeps every other shape):
//
//   x       (B, N, RI, CI)        float32, integer-valued input features;
//                                 or, with the epilogue and quantize_x, a
//                                 layer's raw features, which phase 1b
//                                 quantizes against x_scale
//   deltas  (m_tiles, N, U+1)     float32 Δs of each vector's sorted unique
//                                 weights (0-padded)
//   entries (m_tiles, N, L, 4)    int32 (u, m_local, r, c) per repetition;
//                                 padding rows are (U, 0, 0, 0)
//   out     (B, m_tiles*t_m, RO, CO) float32 from int32 sums; or, with the
//           layer's epilogue operands (x_scale on the device, the layer
//           scale, bias or null, relu), the finished layer output: channels
//           0 .. m_rows - 1 of an NCHW output with m_img channels an image
//           (a branch's channel slice of a concatenated output)
//
// Why the tensor cores give the same numbers.  Weights are int8 (running
// sums of the Δs) and x is integer-valued, so every product and sum is an
// integer; wgmma .s32.s8.s8 sums in int32, which is exact while |sum| <
// 2^31 (VGG16's largest is 2304 * 127^2 = 3.7e7), in any order.  So this
// instance equals the plain version bit for bit, as simt does.
//
// Bound on the H100: bytes.  The seven VGG16 launches of a batch-4 request
// read and write 1.56 GB of float32 planes and packed operands, 0.466 ms at
// 3.35 TB/s; their dense int8 work, 638 G operations, takes 0.32 ms at
// 1,979 TOP/s.
//
// Design, one cooperative launch per call, two phases:
// * Phase 1 decodes the packed operands into a dense int8 weight matrix in
//   the wrapper's scratch (one per device and stream, overwritten by every
//   launch; nothing outlives it).  K is ordered (32-channel chunk, tap r,
//   tap c, channel in chunk) and the matrix is stored in the layout of the
//   shared-memory A tiles: [chunk][tap][k half][M_pad rows][16 bytes].  A
//   group is (t_m rows, chunk, k half): 16 vectors whose bytes make 16-byte
//   rows.  A block takes 16 groups at once, a thread a vector: it sums its
//   Δs into its values, stores value[u] for each entry into the zeroed
//   rows -- skipping padding entries, which would otherwise overwrite a
//   real weight at (m_local 0, r 0, c 0) with zero -- and the block writes
//   the rows with 16-byte stores.  Rows and channels past the layer stay
//   zero.  Decoding per output tile would re-read a layer's entries once
//   per pixel tile (~1,400 tiles at conv3_2).
// * Phase 1 also converts x once to int8 in the scratch, [b][chunk][k half]
//   [pixel][16 channels]: a thread reads 32 channels of 4 pixels by 16-byte
//   loads along the pixels and writes 16-byte rows.  A grid barrier (an
//   acq_rel ticket and a generation word that the kernel leaves ready for
//   the next launch) follows; the cooperative launch keeps every block
//   resident.
// * Phase 2 is an implicit GEMM: rows are output channels, columns output
//   pixels, K is (r, c, n).  A block (two warpgroups) owns BM = 128 output
//   channels x 256 pixels (M > 64) or 64 x 512 (M <= 64), walks its tiles
//   in a static persistent schedule (channel tile fastest, so the tiles
//   that share a window run side by side), and loops over 32-channel
//   chunks.  Pixels are linearized as q = y*CI + x over the whole input
//   width: tap (r, c) reads input pixel q + r*CI + c, so a tile's window is
//   one contiguous run of P = BN + (KH-1)*CI + KW-1 pixels, and the outputs
//   at x >= CO (KW-1 a row, under 1% at VGG16's widths) are computed and
//   dropped.
// * Staging.  Both operands are K-major in the no-swizzle layout (8 x
//   16-byte core matrices, SBO 128 bytes along M/N, LBO the distance of the
//   two k halves).  The B tile of tap (r, c) is the window shifted by
//   r*CI + c pixels: the descriptor's start address moves and no data is
//   copied.  A 128-byte swizzle would break that shift, so the layout stays
//   unswizzled; a core matrix is 128 contiguous bytes, which covers all 32
//   banks whatever the shift.  Per (tile, chunk) item, the A tile (BM x
//   taps x 32 bytes) and the window's two k halves (P x 16 bytes each, zero
//   past the plane) arrive by 16-byte cp.async in a ring of three stages:
//   items k + 1 and k + 2 are in flight while item k's wgmmas run.
// * wgmma m64n256k32 .s32.s8.s8, one per tap and warpgroup per chunk, the
//   accumulators in registers (128 int32 a thread).  The epilogue goes
//   through shared memory: each warp stages 8 channels x 128 pixels in the
//   stage its item has finished with and writes each channel's run along
//   the pixels, 256 contiguous bytes a float2 store.
// * The layer's epilogue in the store.  Given the epilogue operands, an
//   instance of its own (kEpi) takes each value int32 -> float32 ->
//   finish() of ../../csrc/layer_epilogue.cuh (x scale, bias, ReLU: the
//   int8_features epilogue's arithmetic, one definition for both) as the
//   accumulators are staged in shared memory, and rows past the layer's
//   channels are not written.  The separate epilogue pass read the float32
//   sums back and wrote them again: 6.3 GB of a vgg16.b64 request, 24% of
//   its device time.  Without the operands the other instance writes the
//   raw sums of every m_tiles*t_m row, as direct calls take them.
// * The layer's quantization in phase 1b.  With the epilogue operands and
//   quantize_x, x is the layer's raw float32 features and phase 1b
//   quantizes each value against the device scale x_scale, with the
//   int8_features quantize pass's numbers (../../csrc/feature_quant.cuh
//   holds the quotient for both), before it converts it to int8: the
//   same float32 bytes read, and the quantize pass's whole-number float32
//   copy (written and read again: 3.44 GB of a vgg16.b64 request, 17% of
//   its device time) is gone.  The quotient is quotient_rcp()'s, RN(v / s)
//   from the reciprocal taken once and two FMA corrections, for a scale
//   in its range, else __fdiv_rn's: the first design divided with
//   __fdiv_rn, whose per-value branch to its slow path serialised the
//   unrolled loop (conv1_2 at batch 64: 1.75 ms, 0.90 over the
//   convolution alone and 0.30 over the quantize pass and the convolution
//   apart).  to_s8q() takes the quotient to its int8 byte, rint and clamp
//   by a min, a max and one add (no conversion instruction).  Uniform
//   tests of the launch pick the loop; without quantize_x x is converted
//   as it is.
// * x outside int8.  The feature path guarantees int8 on the main path,
//   but a direct call does not, and the wrapper cannot look without a host
//   sync.  So every converted value (and every decoded weight) is checked
//   and a value outside [-128, 127] (NaN included) executes __trap(): the
//   launch fails loudly at the next sync and never returns a wrong sum.
//   On raw features the quotient keeps a NaN (and an infinite feature
//   makes the scale infinite, so inf / inf is NaN), and to_s8q() traps on
//   it, so a raw NaN or infinity stops the launch as well.
//
// What the card changed (chip_smoke.py's per-layer rows and cut-down
// variants timed on an H100 80GB HBM3 at 700 W; PERF.md section 6):
// * The plan staged each window from the float32 planes by the threads,
//   converting as they stored.  That version took 0.84 ms at conv3_2
//   (2.81 ms for the seven layers): per (tile, chunk) item ~9.5 us of
//   latency-bound loads, re-reading the float32 input 2.7x for the halo
//   and 2x for the channel tiles.  Converting x once in phase 1 and
//   staging int8 by cp.async cut the seven layers to 1.96 ms.
// * Stores from the accumulator fragment wrote 32-byte pieces of 8 rows:
//   56 of conv1_1's 87 us.  The shared-memory epilogue cut the seven
//   layers to 1.52 ms, 16-byte loads in the conversion to 1.45 ms.
// * Tiles of 64 x 512 at M = 256 were slower than 128 x 256 (0.396 vs
//   0.376 ms at conv3_2).
// * Left (smm_conv_probe.py): at conv3_2 the wgmmas add 0.125 of 0.375 ms
//   (their work takes 0.11 ms at the int8 peak) and phase 1 takes 0.10
//   ms; the loads, stores and barriers of phase 2 do not hide under the
//   wgmmas (one group in flight, no warp specialization).
//
// How it answers the faults of the first kernel (smm_conv.cu):
// * work on the CUDA cores (one int32 multiply-add and one shared-memory
//   load per nonzero per pixel): the products run on the tensor cores as a
//   dense int8 GEMM, zeros included -- 638 G operations instead of ~128 G
//   routed adds, at 1,979 TOP/s instead of ~32 loads a clock per SM;
// * one m_tile (4 channels) per block, so each input element was read M/4
//   times: 128 channels (or all 64) share each staged window, which is
//   read once per channel tile, with a halo of (KH-1)*CI + KW-1 pixels;
// * accumulators in shared memory: in registers;
// * the window staged as int32 one float at a time with a __syncthreads per
//   input channel: x is converted once per launch, and a window of 32
//   channels arrives by cp.async as int8, one barrier per chunk.
//
// Plain C interface, loaded with ctypes: smm_conv_sm90_launch returns
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "feature_quant.cuh"    // quotient_rcp, quotient_rcp_takes
#include "layer_epilogue.cuh"   // finish, epilogue_scale

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kWgN = 256;       // output pixels of one warpgroup's wgmma
constexpr int kStages = 3;      // shared-memory ring of (A tile, window)
constexpr int kHead = 256;      // scratch bytes before the weights: barrier
constexpr int kGroups = kThreads / 16;   // phase-1 groups a block decodes
constexpr int kRow = 136;       // epilogue: floats a staged row (padded)
constexpr int kEpilogueBytes = kThreads / 32 * 8 * kRow * 4;   // a stage
constexpr int kMaxSmem = 232448;

// the call's geometry, computed on the host (ops.sm90_plan mirrors it)
struct Geo {
  int n_in, ri, ci, ro, co;
  int m_out;           // m_tiles * t_m, the channels the GEMM computes
  int m_rows;          // of them the channels written (m_out for raw sums)
  int m_img;           // the output's channels an image (its batch stride)
  int t_m, m_tiles, u_plus, l_max;
  int kh, kw, taps, chunks;
  int m_pad;           // rows of the dense matrix, a multiple of BM
  int bn, p;           // pixels of a tile; of its window
  int n_mt;            // channel tiles
  int tiles_per_img, n_tiles;
  int groups_mt;       // row groups of t_m rows in phase 1
  int stage_a, stage_bytes;
  long long xs_off;    // scratch offset of x in int8: [b][chunk][half][pixel]
};

// the layer's epilogue in the store (read only by the kEpi instances)
struct Epi {
  const float* x_scale;   // one float on the device
  const float* bias;      // m_rows floats, or null
  double layer_scale;
  int relu;
  int quant;              // x is raw features: phase 1b quantizes them
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (K-major: the next core matrix along K), stride byte offset (the
// next 8 rows along M or N)
__device__ __forceinline__ uint64_t desc_noswz(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 16 bytes global -> shared, the bytes past src_bytes (0 or 16) zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the issue / wait
__device__ __forceinline__ void fence_regs(int (&r)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 256, s32) += A (64 x 32, s8) . B (32 x 256, s8); both K-major in
// shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// int8 of an integer-valued float; anything outside [-128, 127] (NaN
// included) stops the launch
__device__ __forceinline__ uint32_t to_s8(float v) {
  if (!(v >= -128.5f && v < 127.5f)) __trap();   // rounds into int8
  return static_cast<uint32_t>(__float2int_rn(v)) & 0xFFu;
}

// int8 of clamp(rint(q), -127, 127), quant()'s numbers for the quotient
// q = v / s; a NaN stops the launch.  Past the clamp, c + 1.5 * 2^23 lies
// in [2^23, 2^24), where a float's unit is 1: its last byte is rint(c),
// half to even, in two's complement
__device__ __forceinline__ uint32_t to_s8q(float q) {
  if (isnan(q)) __trap();
  const float c = fminf(fmaxf(q, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(c, 0x1.8p23f)) & 0xFFu;
}

// one generation of a grid-wide barrier over bar[0] (arrivals) and bar[1]
// (generation): the last block to arrive sets the count back to 0 and
// moves the generation on, so the words are ready for the next launch
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned gen, ticket, now;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(gen)
                 : "l"(bar + 1)
                 : "memory");
    __threadfence();
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(bar)
                 : "memory");
    if (ticket == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;\n" ::"l"(bar)
                   : "memory");
      asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(bar + 1),
                   "r"(gen + 1)
                   : "memory");
    } else {
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                     : "=r"(now)
                     : "l"(bar + 1)
                     : "memory");
      } while (now == gen);
    }
    __threadfence();
  }
  __syncthreads();
}

// phase 1a: (deltas, entries) -> the dense int8 matrix w.  A group is (t_m
// rows, chunk, k half): 16 vectors, whose bytes make 16-byte rows.  A block
// decodes kGroups groups at once, a thread a vector: it sums its Δs into
// its values (int8, in shared memory), then stores value[u] for each entry
// into the groups' zeroed rows, which the block then writes out.
__device__ void decode_weights(const Geo& g, const float* __restrict__ deltas,
                               const int* __restrict__ entries, uint8_t* w,
                               uint8_t* smem) {
  const int tid = threadIdx.x;
  const int rows = g.taps * g.t_m;          // 16-byte rows of a group
  uint8_t* gb = smem;                       // [group][tap][m_local][16]
  int8_t* vals = reinterpret_cast<int8_t*>(smem + kGroups * rows * 16) +
                 tid * g.u_plus;
  const int u_pad = g.u_plus - 1;
  const int n_groups = g.groups_mt * g.chunks * 2;
  for (int g0 = blockIdx.x * kGroups; g0 < n_groups;
       g0 += gridDim.x * kGroups) {
    for (int i = tid; i < kGroups * rows; i += kThreads)
      reinterpret_cast<uint4*>(gb)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    const int grp = g0 + tid / 16;
    const int j = tid % 16;
    const int half = grp % 2;
    const int ch = (grp / 2) % g.chunks;
    const int mt = grp / (2 * g.chunks);
    const int n = ch * 32 + half * 16 + j;
    if (grp < n_groups && mt < g.m_tiles && n < g.n_in) {
      const size_t vec = (size_t)mt * g.n_in + n;
      const float* dp = deltas + vec * g.u_plus;
      int run = 0;
#pragma unroll 4
      for (int u = 0; u < u_pad; ++u) {
        run += __float2int_rn(dp[u]);
        if (static_cast<unsigned>(run + 128) > 255u) __trap();
        vals[u] = static_cast<int8_t>(run);
      }
      const int4* ep = reinterpret_cast<const int4*>(entries) + vec * g.l_max;
      uint8_t* gj = gb + (tid / 16) * rows * 16 + j;
#pragma unroll 4
      for (int l = 0; l < g.l_max; ++l) {
        const int4 e = ep[l];
        if (e.x == u_pad) continue;   // padding: the zero product row
        gj[((e.z * g.kw + e.w) * g.t_m + e.y) * 16] =
            static_cast<uint8_t>(vals[e.x]);
      }
    }
    __syncthreads();
    for (int i = tid; i < kGroups * rows; i += kThreads) {
      const int gr = g0 + i / rows;
      const int ri = i % rows;
      const int tap = ri / g.t_m;
      const int m = (gr / (2 * g.chunks)) * g.t_m + (ri - tap * g.t_m);
      if (gr >= n_groups || m >= g.m_pad) continue;
      const int c = (gr / 2) % g.chunks;
      *reinterpret_cast<uint4*>(
          w + (((size_t)(c * g.taps + tap) * 2 + gr % 2) * g.m_pad + m) * 16) =
          reinterpret_cast<const uint4*>(gb)[i];
    }
    __syncthreads();
  }
}

// phase 1b: x (B, N, RI, CI) float32 -> xs int8, [b][chunk][k half][pixel]
// [16 channels]: a thread a (image, chunk, V pixels), 32 loads of V floats
// along the pixels (coalesced; V = 4 where the plane holds whole 16-byte
// pieces), 2 V 16-byte stores; channels past N are zero.  kQuant: x holds
// raw features, each value quantized against the scale s as it is
// converted (to_s8q() of the quotient: kRcp quotient_rcp()'s with y =
// 1 / s, kDiv __fdiv_rn's).  Every value is checked: one outside int8
// (x as is) or a NaN quotient stops the launch.
enum Quant { kAsIs, kRcp, kDiv };

template <int V, Quant kQuant>
__device__ void convert_x(const Geo& g, int batch, const float* __restrict__ x,
                          float s, uint8_t* xs) {
  using VecT = typename std::conditional<V == 4, float4, float>::type;
  const float y = kQuant == kRcp ? __frcp_rn(s) : 1.0f;
  auto to_int = [&](float v) {
    if constexpr (kQuant == kRcp) return to_s8q(quotient_rcp(v, s, y));
    if constexpr (kQuant == kDiv) return to_s8q(__fdiv_rn(v, s));
    return to_s8(v);
  };
  const int plane = g.ri * g.ci;
  const int groups = plane / V;
  const long long tasks = (long long)batch * g.chunks * groups;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < tasks; t += (long long)gridDim.x * kThreads) {
    const int pix = static_cast<int>(t % groups) * V;
    const long long bc = t / groups;          // b * chunks + chunk
    const int ch = static_cast<int>(bc % g.chunks);
    const int b = static_cast<int>(bc / g.chunks);
    const int n0 = ch * 32;
    const int nc = min(32, g.n_in - n0);
    const float* src = x + ((size_t)b * g.n_in + n0) * plane + pix;
    float v[32][V];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k < nc) {
        const VecT u = *reinterpret_cast<const VecT*>(src + (size_t)k * plane);
        const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
        for (int e = 0; e < V; ++e) v[k][e] = f[e];
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[k][e] = 0.f;
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(xs) + bc * 2 * plane + pix;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      uint32_t r[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 32; ++k)
        r[k / 4] |= to_int(v[k][e]) << (8 * (k % 4));
      dst[e] = make_uint4(r[0], r[1], r[2], r[3]);
      dst[plane + e] = make_uint4(r[4], r[5], r[6], r[7]);
    }
  }
}

// WM: warpgroups along the channels, 2 (BM 128) or 1 (BM 64); kEpi: the
// store applies the layer's epilogue (else it writes the raw sums)
template <int WM, bool kEpi>
__global__ void __launch_bounds__(kThreads, 1)
smm_conv_sm90_kernel(const float* __restrict__ x,
                     const float* __restrict__ deltas,
                     const int* __restrict__ entries, float* __restrict__ out,
                     uint8_t* __restrict__ scratch, const int batch,
                     const Geo g, const Epi epi) {
  constexpr int BM = 64 * WM;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* w = scratch + kHead;
  uint8_t* xs = scratch + g.xs_off;

  decode_weights(g, deltas, entries, w, smem);
  // uniform: the launch's flag, x's alignment and its one scale
  const bool vec4 = g.ri * g.ci % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const float s = kEpi && epi.quant ? *epi.x_scale : 1.0f;
  if (!(kEpi && epi.quant)) {
    if (vec4)
      convert_x<4, kAsIs>(g, batch, x, s, xs);
    else
      convert_x<1, kAsIs>(g, batch, x, s, xs);
  } else if (quotient_rcp_takes(s)) {
    if (vec4)
      convert_x<4, kRcp>(g, batch, x, s, xs);
    else
      convert_x<1, kRcp>(g, batch, x, s, xs);
  } else if (vec4) {
    convert_x<4, kDiv>(g, batch, x, s, xs);
  } else {
    convert_x<1, kDiv>(g, batch, x, s, xs);
  }
  grid_barrier(reinterpret_cast<unsigned*>(scratch));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wm = WM == 2 ? wg : 0;    // this warpgroup's 64 channels
  const int wn = WM == 2 ? 0 : wg;    // and 256 pixels of the tile
  if ((int)blockIdx.x >= g.n_tiles) return;
  // the epilogue's scale, taken once a block
  float escale = 1.0f;
  if constexpr (kEpi) escale = epilogue_scale(epi.layer_scale, epi.x_scale);
  const int my_tiles = (g.n_tiles - 1 - (int)blockIdx.x) / gridDim.x + 1;
  const int items = my_tiles * g.chunks;
  const int plane = g.ri * g.ci;

  // item k: chunk k % chunks of this block's tile k / chunks
  auto tile_of = [&](int k, int& mt, int& b, int& q0) {
    const int t = blockIdx.x + (k / g.chunks) * gridDim.x;
    mt = t % g.n_mt;
    const int pt = t / g.n_mt;
    b = pt / g.tiles_per_img;
    q0 = (pt - b * g.tiles_per_img) * g.bn;
  };

  // copies of item k into stage s, one cp.async group: the A tile from the
  // dense weights, the window's two k halves from xs (zero past the plane)
  auto load = [&](int k, int s) {
    int mt, b, q0;
    tile_of(k, mt, b, q0);
    const int ch = k % g.chunks;
    const uint32_t sa = smem_u32(smem + s * g.stage_bytes);
    const uint8_t* wa =
        w + ((size_t)ch * g.taps * 2 * g.m_pad + (size_t)mt * BM) * 16;
    for (int i = tid; i < g.taps * 2 * BM; i += kThreads) {
      const int seg = i / BM;                   // (tap, k half)
      cp_async16(sa + i * 16,
                 wa + ((size_t)seg * g.m_pad + (i - seg * BM)) * 16);
    }
    const uint32_t sw = sa + g.stage_a;
    const uint8_t* xw = xs + ((size_t)(b * g.chunks + ch) * 2 * plane) * 16;
    for (int i = tid; i < 2 * g.p; i += kThreads) {
      const int half = i >= g.p;
      const int pix = q0 + i - half * g.p;
      const bool in = pix < plane;
      cp_async16(sw + i * 16,
                 xw + ((size_t)half * plane + (in ? pix : 0)) * 16,
                 in ? 16 : 0);
    }
  };

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  auto mma = [&](int s, bool first) {
    const uint8_t* sa = smem + s * g.stage_bytes;
    const uint32_t a0 = smem_u32(sa) + wm * 64 * 16;
    const uint32_t b0 = smem_u32(sa + g.stage_a) + wn * kWgN * 16;
    fence_regs(acc);
    wgmma_fence();
    for (int tap = 0; tap < g.taps; ++tap) {
      const int r = tap / g.kw;
      const int c = tap - r * g.kw;
      wgmma_m64n256k32(acc, desc_noswz(a0 + tap * 2 * BM * 16, BM * 16, 128),
                       desc_noswz(b0 + (r * g.ci + c) * 16, g.p * 16, 128),
                       !(first && tap == 0));
    }
    wgmma_commit();
  };

  // the epilogue, through shared memory: element 4 j + 2 i + c of acc is
  // channel 16 warp + lane / 4 + 8 i of the warpgroup's 64 and pixel 8 j +
  // 2 (lane % 4) + c of its 256.  Each warp puts 8 channels x 128 pixels at
  // a time into its own 4 KB of stage `st` (free once every wgmma of the
  // item is done), then writes each channel's run along the pixels: 256
  // contiguous bytes a float2 store (pixels at x >= CO are dropped).  The
  // layer's epilogue (kEpi) is applied as the accumulators are staged,
  // where a lane's 32 values of a channel are independent work; the
  // stores stay plain copies (applied in the store loop, behind a runtime
  // flag, it added 12-31% to a VGG16 layer's time, here 0-5%)
  auto store = [&](int k, int st) {
    int mt, b, q0;
    tile_of(k, mt, b, q0);
    float* buf = reinterpret_cast<float*>(smem + st * g.stage_bytes) +
                 (tid / 32) * 8 * kRow;
    const int m0 = mt * BM + wm * 64 + warp * 16;
    const int qw = q0 + wn * kWgN;
    const bool vec2 = (g.ci % 2 == 0) && (g.co % 2 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) & 7u) == 0;
    // this lane's channels m0 + lane / 4 + 8 i: their bias (none read
    // past the layer's channels, whose rows are not written)
    float add[2] = {0.0f, 0.0f};
    if constexpr (kEpi) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + lane / 4 + 8 * i;
        if (epi.bias != nullptr && m < g.m_rows) add[i] = epi.bias[m];
      }
    }
    auto value = [&](int a, int i) {
      const float v = static_cast<float>(a);
      if constexpr (kEpi) return finish(v, escale, epi.bias, add[i], epi.relu);
      return v;
    };
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      // this lane's pixels of the 128: 2 lane + 64 h (float2 path)
      int yq[2], xq[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = qw + 128 * jh + 64 * h + 2 * lane;
        yq[h] = q / g.ci;
        xq[h] = q - yq[h] * g.ci;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * jh + jj;
          *reinterpret_cast<float2*>(buf + (lane / 4) * kRow + 8 * jj +
                                     2 * (lane % 4)) =
              make_float2(value(acc[4 * j + 2 * i], i),
                          value(acc[4 * j + 2 * i + 1], i));
        }
        __syncwarp();
#pragma unroll 2
        for (int r = 0; r < 8; ++r) {
          const int m = m0 + 8 * i + r;
          if (m >= g.m_rows) break;
          float* o = out + ((size_t)b * g.m_img + m) * g.ro * g.co;
          if (vec2) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (yq[h] < g.ro && xq[h] < g.co)
                *reinterpret_cast<float2*>(o + (size_t)yq[h] * g.co +
                                           xq[h]) =
                    *reinterpret_cast<const float2*>(buf + r * kRow +
                                                     64 * h + 2 * lane);
            }
          } else {
            for (int h = 0; h < 4; ++h) {
              const int q = qw + 128 * jh + 32 * h + lane;
              const int y = q / g.ci, xx = q - y * g.ci;
              if (y < g.ro && xx < g.co)
                o[(size_t)y * g.co + xx] = buf[r * kRow + 32 * h + lane];
            }
          }
        }
        __syncwarp();
      }
    }
  };

  // items k + 1 and k + 2 are in flight while item k's wgmmas run; one
  // cp.async group an item (empty past the last), so wait_group<1> means
  // item k has landed
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < items) load(k, k);
    cp_async_commit();
  }
  for (int k = 0; k < items; ++k) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();   // item k is in; every wgmma of item k - 1 is done
    const int ch = k % g.chunks;
    mma(k % kStages, ch == 0);
    if (k + kStages - 1 < items)
      load(k + kStages - 1, (k + kStages - 1) % kStages);
    cp_async_commit();
    wgmma_wait0();
    fence_regs(acc);
    if (ch == g.chunks - 1) {
      __syncthreads();   // both warpgroups are done with stage k % kStages
      store(k, k % kStages);
    }
  }
  cp_async_wait<0>();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int WM, bool kEpi>
cudaError_t launch(const float* x, const float* deltas, const int* entries,
                   float* out, void* scratch, int batch, const Geo& g,
                   const Epi& e, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      smm_conv_sm90_kernel<WM, kEpi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int smem = kStages * g.stage_bytes;
  // resident blocks for this device and shared-memory size (the queries
  // cost more host time than a small layer's kernel; kept per thread)
  thread_local int c_dev = -1, c_smem = -1, c_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != c_dev || smem != c_smem) {
    int sms = 0, occ = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, smm_conv_sm90_kernel<WM, kEpi>, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    c_dev = dev;
    c_smem = smem;
    c_blocks = sms * occ;
  }
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  int b = batch;
  Geo geo = g;
  Epi epi = e;
  void* args[] = {&x, &deltas, &entries, &out, &sc, &b, &geo, &epi};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(smm_conv_sm90_kernel<WM, kEpi>),
      dim3(c_blocks), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// stride 1 only (KH = RI - RO + 1, KW = CI - CO + 1); scratch of
// scratch_bytes, its first 8 bytes zero before the first launch on a
// stream (the barrier words; every launch leaves them ready for the next).
// x_scale null: out (B, m_tiles * t_m, RO, CO) takes the raw sums, and
// layer_scale, bias, relu, m_rows, m_img and quantize_x are not read.
// Else out takes the layer's output in channels 0 .. m_rows - 1 (m_rows <=
// m_tiles * t_m) of m_img an image (m_img >= m_rows); bias null or m_rows
// floats; quantize_x 1: x is raw features, quantized against x_scale in
// phase 1b (0: x is whole numbers already).
extern "C" int smm_conv_sm90_launch(const float* x, const float* deltas,
                                    const int* entries, float* out,
                                    void* scratch, long long scratch_bytes,
                                    int batch, int n_in, int ri, int ci,
                                    int m_tiles, int u_plus, int l_max,
                                    int t_m, int ro, int co,
                                    const float* x_scale, double layer_scale,
                                    const float* bias, int relu, int m_rows,
                                    int m_img, int quantize_x, void* stream) {
  if (batch < 1 || n_in < 1 || m_tiles < 1 || t_m < 1 || u_plus < 1 ||
      l_max < 1 || ro < 1 || co < 1 || ro > ri || co > ci)
    return cudaErrorInvalidValue;
  if (x_scale != nullptr &&
      (m_rows < 1 || m_rows > m_tiles * t_m || m_img < m_rows))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(entries) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15u) != 0)
    return cudaErrorInvalidValue;
  Geo g;
  g.n_in = n_in;
  g.ri = ri;
  g.ci = ci;
  g.ro = ro;
  g.co = co;
  g.t_m = t_m;
  g.m_tiles = m_tiles;
  g.m_out = m_tiles * t_m;
  g.m_rows = x_scale != nullptr ? m_rows : g.m_out;
  g.m_img = x_scale != nullptr ? m_img : g.m_out;
  g.u_plus = u_plus;
  g.l_max = l_max;
  g.kh = ri - ro + 1;
  g.kw = ci - co + 1;
  g.taps = g.kh * g.kw;
  g.chunks = cdiv(n_in, 32);
  // two warpgroups along the channels past 64 of them, unless their
  // stages overflow shared memory (a wide kernel): then one, 512 pixels
  const int p2 = kWgN + (g.kh - 1) * ci + g.kw - 1;
  const int wm = g.m_out > 64 && (long long)kStages *
                     ((g.taps * 2 * 128 * 16 + 2 * p2 * 16 + 127) / 128 *
                      128) <= kMaxSmem ? 2 : 1;
  const int bm = 64 * wm;
  g.m_pad = cdiv(g.m_out, bm) * bm;
  g.bn = 2 * kWgN / wm;
  g.p = g.bn + (g.kh - 1) * ci + g.kw - 1;
  g.n_mt = g.m_pad / bm;
  const long long q_img = (long long)ro * ci;
  g.tiles_per_img = static_cast<int>((q_img + g.bn - 1) / g.bn);
  const long long tiles = (long long)batch * g.tiles_per_img * g.n_mt;
  g.groups_mt = cdiv(g.m_pad, t_m);
  g.stage_a = g.taps * 2 * bm * 16;
  g.stage_bytes = (g.stage_a + 2 * g.p * 16 + 127) / 128 * 128;
  if (g.stage_bytes < kEpilogueBytes) g.stage_bytes = kEpilogueBytes;
  g.xs_off = kHead + (long long)g.m_pad * g.chunks * g.taps * 32;
  const long long decode_bytes =
      (long long)kGroups * g.taps * t_m * 16 + (long long)kThreads * u_plus;
  const long long need =
      g.xs_off + (long long)batch * g.chunks * 32 * ri * ci;
  if (tiles > (1LL << 30) || g.p > 16383 ||
      (long long)kStages * g.stage_bytes > kMaxSmem ||
      decode_bytes > (long long)kStages * g.stage_bytes ||
      scratch_bytes < need)
    return cudaErrorInvalidValue;
  g.n_tiles = static_cast<int>(tiles);
  const Epi e = {x_scale, bias, layer_scale, relu,
                 x_scale != nullptr && quantize_x != 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_scale != nullptr) {
    if (wm == 2)
      return launch<2, true>(x, deltas, entries, out, scratch, batch, g, e, s);
    return launch<1, true>(x, deltas, entries, out, scratch, batch, g, e, s);
  }
  if (wm == 2)
    return launch<2, false>(x, deltas, entries, out, scratch, batch, g, e, s);
  return launch<1, false>(x, deltas, entries, out, scratch, batch, g, e, s);
}

extern "C" const char* smm_conv_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
