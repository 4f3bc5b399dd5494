// Flash attention K4 (forward), K5 (dq) and K6 (dk, dv) on Hopper's tensor
// cores (sm_90a: wgmma, TMA, mbarriers), for bf16 and f16 inputs at
// D in {64, 128}, with a plain C interface loaded through ctypes
// (horovod_tpu_torch/ops/flash_attention.py routes to these entries by
// dtype and D; f32 and the other D take csrc/flash_attention.cu).
//
// K4 hvd_flash_fwd_sm90 replaces horovod_tpu/ops/flash_attention.py _fwd
//    (_fwd_kernel): online softmax in f32; o in q's dtype, lse in f32.
// K5 hvd_flash_bwd_dq_sm90 replaces _bwd's dq kernel (_bwd_dq_kernel):
//    p = exp(s - lse), ds = p (dp - delta) scale, dQ = sum_k ds K; dq is
//    per q head, so GQA needs no partials.
// K6 hvd_flash_bwd_dkv_sm90 replaces _bwd's dk/dv kernel
//    (_bwd_dkv_kernel): dV = sum_q p^T dO, dK = sum_q ds^T Q, f32 partials
//    per q head under GQA (summed by the caller: no atomics).
//
// The contract is that of csrc/flash_attention.cu: q, k, v, dO, o, dq, dk,
// dv are contiguous [B, T, H, D], read in place; lse and delta [B, T, Hq]
// f32; segment ids [B, T] int32 or null; T % 128 == 0.  Every product is
// of two input-dtype values, summed in f32 (wgmma .f32.bf16.bf16 /
// .f32.f16.f16: a 16-bit product is exact in f32, so only the order of the
// sums differs); masked scores are -1e30; p is rounded to v's dtype before
// P.V (K4), ds to k's dtype for dQ (K5), p to dO's and ds to q's dtype for
// dV and dK (K6); the outputs are rounded once at the end.  The softmax
// runs in the log2 domain (scores times scale * log2(e), ex2), the same
// function up to f32 rounding.
//
// What bounds them: at the main shape (1, 16384, 8, 64) causal, K4 does
// 4 * D flops per unmasked (query, key) pair, K5 6 * D and K6 8 * D against
// a few MB of inputs: operations, at the tensor cores' 989 TFLOP/s (bf16,
// f16).  The design feeds the tensor cores from shared memory without the
// CUDA cores touching the operands:
//
// - A CTA owns 128 rows (K4, K5: queries; K6: keys): two consumer
//   warpgroups of 64 rows each and one producer warp, 288 threads.  ptxas
//   gives each thread at most 168 registers (three warps share a quarter
//   of the SM's register file), as it did with a producer warpgroup and
//   setmaxnreg; at D = 128 K4 and K6 spill and serialize their wgmmas
//   (PERF.md).
// - TMA loads every tile.  A 4-D tensor map (D, H, T, B) with a box of
//   (64, 1, rows, 1) lands one head's rows as a [rows][64] tile, swizzled
//   by 128 bytes (one 64-wide row of 16-bit values); D = 128 takes two
//   such tiles side by side.  The 128 resident rows are loaded once (K5:
//   Q and dO); the walked tiles (K4: K and V, BK = 128 keys; K5: K and V,
//   64 keys, with their segment ids; K6: Q and dO, 64 queries, with their
//   lse, delta and segment ids) flow through a ring of three stages (K5:
//   four; K4 at D = 128: two, where shared memory runs short) with full
//   and empty mbarriers.
// - K4's consumers issue their tile products in batches: turn i holds the
//   scores of tile i with the P.V product of tile i - 1, and the two
//   consumers take turns (named barriers), so one warpgroup's batch runs
//   on the tensor cores while the other computes its softmax on the CUDA
//   cores.  K5 and K6 wait for each tile's products before they use them:
//   batched, K6's two more accumulator sets overran the registers and it
//   measured slower, and K5 carrying dQ of one tile beside the scores of
//   the next measured slower too.
// - K4: S = Q K^T by wgmma m64n128k16 with both operands in shared memory
//   (K-major); the online softmax in registers, row max and sum reduced
//   across the four threads of a quad; p rounded in registers and packed
//   from the accumulator layout straight into wgmma's A-fragment layout;
//   O += P V by wgmma with P in registers and V in shared memory read
//   MN-major (the transpose bit of a 16-bit wgmma).
// - K5: S = Q K^T and dP = dO V^T (m64n64, shared-memory operands, two
//   wgmma groups: P's exponentials run while dP finishes), P and dS in
//   registers with the thread's rows' lse and delta read once, then dQ +=
//   dS K with dS as the register A operand and the same K tile read
//   MN-major.  dQ stays in f32 registers over the whole walk (one
//   accumulator, where K6 holds two) and is rounded once.  At D = 64 the
//   two consumer warpgroups take turns to issue, as K4's do.
// - K6: S^T = K Q^T and dP^T = V dO^T (shared-memory operands), P^T and
//   dS^T in registers, dV += P^T dO and dK += dS^T Q with the register
//   A operand and dO, Q read MN-major: one shared tile serves both as a
//   K-major and as an MN-major operand.  dK and dV stay in f32 registers
//   over the whole walk and are written once.
// - Mask arithmetic runs only on tiles that straddle the causal diagonal,
//   the window's edge, or a segment boundary; a tile whose rows and
//   columns all share one segment id skips it.  The walked band is
//   _block_gate's (as in flash_attention.cu); K4 and K5 schedule their
//   heaviest causal q tiles first.
//
// The tensor-map encoder cuTensorMapEncodeTiled is a driver-API function;
// it is fetched through the runtime's cudaGetDriverEntryPoint, so the
// library links only the CUDA runtime, like the port's other sources.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

#define DEV __device__ __forceinline__

constexpr int kBf16 = 1, kF16 = 2;  // dtype codes of the Python wrappers
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegL = -1e30f * kLog2e;  // the masked score -1e30, log2
constexpr int kRows = 128;     // resident rows of a CTA: 2 consumers x 64
constexpr int kThreads = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int kCols = 64;      // columns of D per swizzled tile (128 bytes)
constexpr int kBK = 128;       // K4: keys per walked tile
constexpr int kBQ = 64;        // K6: queries per walked tile
constexpr int kBKey = 64;      // K5: keys per walked tile

struct Params {
  const int* seg;
  const float* lse_in;  // K5, K6
  const float* delta;   // K5, K6
  void* o;              // K4: o; K5: dq; K6: dk
  void* o2;             // K6: dv
  float* lse;           // K4
  int T, Hq, Hkv;
  int out_f32;  // K6: dk, dv as f32 partials (GQA), else in q's dtype
  int causal;
  int window;   // 0: none
  float scale;
};

// ---------------------------------------------------------------------------
// PTX wrappers: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

DEV uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

DEV void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

DEV void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Arrive and announce `bytes` of TMA transfers for the current phase.
DEV void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

DEV uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of parity `phase` has completed.  A wait
// of more than 10 s traps, so that a fault in the pipeline ends the launch
// with an error instead of holding the card.
DEV void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t a = smem_u32(bar);
  uint64_t start = 0;
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
    if (done) return;
    if ((i & 1023u) == 0) {
      const uint64_t now = global_ns();
      if (i == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
DEV void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                  int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Named barriers 1 and 2 order the two consumer warpgroups' wgmma issue
// (K4, and K5 at D = 64): warpgroup c waits on barrier 1 + c for its turn
// and hands the turn on by arriving at the other one, so that one
// warpgroup's tile products run on the tensor cores while the other
// computes its softmax.
DEV void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
DEV void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

DEV void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
DEV void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
DEV void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
DEV void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
DEV void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units).
DEV uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFFu) >> 4) |
         (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32) |
         (1ull << 62);
}

// A tile of ROWS rows and D columns is D / 64 swizzled [ROWS][64] blocks,
// each ROWS * 128 bytes, 1024-byte aligned.  As a K-major operand (the
// contracted dimension is D), step kk covers columns 16kk..16kk+15 of rows
// row0..: 8-row groups 1024 bytes apart, the step's 32 bytes inside a
// 128-byte swizzled row.
template <int ROWS>
DEV uint64_t kmajor(const uint16_t* tile, int row0, int kk) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(tile) +
                     (kk >> 2) * ROWS * 128 + row0 * 128 + (kk & 3) * 32;
  return sw128_desc(p, 16, 1024);
}

// As an MN-major operand (the contracted dimension is the rows): step kk
// covers rows 16kk..16kk+15, 8-row groups 1024 bytes apart, and the
// 64-wide column blocks ROWS * 128 bytes apart.
template <int ROWS>
DEV uint64_t mnmajor(const uint16_t* tile, int kk) {
  return sw128_desc(reinterpret_cast<const uint8_t*>(tile) + kk * 2048,
                    ROWS * 128, 1024);
}

// wgmma m64nNk16, f32 accumulators d[N / 2] (thread's rows g and g + 8 of
// its warp's 16, columns 8j + 2t + {0, 1}: d[4j + {0, 1}] row g, d[4j +
// {2, 3}] row g + 8).  ss: A and B from shared memory, both K-major.  rs:
// A from registers (four 32-bit pairs), B from shared memory MN-major.
template <int N, int DT>
struct Mma;

#define HVD_F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HVD_F32 HVD_F8(0), HVD_F8(8), HVD_F8(16), HVD_F8(24)
#define HVD_F64 \
  HVD_F32, HVD_F8(32), HVD_F8(40), HVD_F8(48), HVD_F8(56)
#define HVD_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HVD_R64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

#define HVD_MMA(DTC, TY)                                                    \
  template <>                                                               \
  struct Mma<64, DTC> {                                                     \
    static DEV void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {   \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                      \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "       \
          HVD_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                         \
          : HVD_F32                                                         \
          : "l"(a), "l"(b), "r"(acc));                                      \
    }                                                                       \
    static DEV void rs(float (&d)[32], const uint32_t (&x)[4], uint64_t b,  \
                       int acc) {                                           \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                      \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "       \
          HVD_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"           \
          : HVD_F32                                                         \
          : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "l"(b), "r"(acc));  \
    }                                                                       \
  };                                                                        \
  template <>                                                               \
  struct Mma<128, DTC> {                                                    \
    static DEV void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {   \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                      \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "      \
          HVD_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                         \
          : HVD_F64                                                         \
          : "l"(a), "l"(b), "r"(acc));                                      \
    }                                                                       \
    static DEV void rs(float (&d)[64], const uint32_t (&x)[4], uint64_t b,  \
                       int acc) {                                           \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                      \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "      \
          HVD_R64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"           \
          : HVD_F64                                                         \
          : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "l"(b), "r"(acc));  \
    }                                                                       \
  };

HVD_MMA(kBf16, "bf16")
HVD_MMA(kF16, "f16")

// Two f32 values rounded to the 16-bit dtype and packed, the first in the
// low half: one register of wgmma's A fragment, or two adjacent outputs.
template <int DT>
DEV uint32_t pack2(float lo, float hi) {
  uint32_t u;
  if (DT == kBf16) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    u = *reinterpret_cast<uint32_t*>(&h);
  } else {
    __half2 h = __floats2half2_rn(lo, hi);
    u = *reinterpret_cast<uint32_t*>(&h);
  }
  return u;
}

// The accumulator's values of columns 16kk..16kk+15 (blocks j = 2kk, 2kk+1)
// rounded into the A fragment of k step kk: rows g and g + 8, columns
// 2t, 2t + 1 then 2t + 8, 2t + 9.
template <int DT, int N>
DEV void to_frags(const float (&d)[N], uint32_t (&f)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    f[j / 2][(j & 1) * 2] = pack2<DT>(d[4 * j], d[4 * j + 1]);
    f[j / 2][(j & 1) * 2 + 1] = pack2<DT>(d[4 * j + 2], d[4 * j + 3]);
  }
}

DEV float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

DEV float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

DEV float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

DEV bool keep(int qp, int kp, const Params& a) {
  bool k = !a.causal || qp >= kp;
  if (a.window > 0) k = k && (qp - kp < a.window);
  return k;
}

// Whether the 64 ids at ids[0..64) are all one value (returned in `val`);
// called by a whole warp.
DEV bool uniform64(const int* ids, int& val) {
  const int lane = threadIdx.x & 31;
  int lo = min(ids[2 * lane], ids[2 * lane + 1]);
  int hi = max(ids[2 * lane], ids[2 * lane + 1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  val = lo;
  return lo == hi;
}

// Producer warp: copy N segment ids into dst[0..N) and write whether they
// are one value (dst[N]) and that value (dst[N + 1]).
template <int N>
DEV void stage_segments(int* dst, const int* src) {
  const int lane = threadIdx.x & 31;
  int lo = src[lane], hi = lo;
#pragma unroll
  for (int i = lane; i < N; i += 32) {
    const int s = src[i];
    dst[i] = s;
    lo = min(lo, s);
    hi = max(hi, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    dst[N] = lo == hi;
    dst[N + 1] = lo;
  }
}

// Tiles [first, last) of width BC along the walked sequence that can hold
// an unmasked entry for rows [r0, r0 + BR) (_block_gate).  `rows_are_q`:
// the resident rows are queries (K4, K5) or keys (K6).
template <int BR, int BC>
DEV void band(int r0, bool rows_are_q, const Params& a, int& first,
              int& last) {
  const int n = a.T / BC;
  first = 0;
  last = n;
  if (rows_are_q) {
    if (a.causal) last = min(n, (r0 + BR - 1) / BC + 1);
    if (a.window > 0) first = max(0, (r0 - (a.window - 1)) / BC);
  } else {
    if (a.causal) first = r0 / BC;
    if (a.window > 0) last = min(n, (r0 + BR - 1 + a.window - 1) / BC + 1);
  }
}

// The dynamic shared memory rounded up to 1024 bytes (the 128-byte
// swizzle's period, which TMA and wgmma both assume).
DEV uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

template <int DT>
DEV void store_pair(void* base, int64_t off, float x, float y, bool f32) {
  if (f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(x, y);
  } else {
    *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(base) + off) =
        pack2<DT>(x, y);
  }
}

// ---------------------------------------------------------------------------
// K4: forward.  CTA (q tile of 128 rows, b * Hq + h).
// ---------------------------------------------------------------------------

template <int D>
struct FwdPlan {
  static constexpr int kStages = D == 64 ? 3 : 2;  // what shared memory holds
  static constexpr int kQ = kRows * D * 2;  // bytes of the Q tile
  static constexpr int kKV = kBK * D * 2;   // bytes of one K or V tile
  static constexpr int kTiles = kQ + 2 * kStages * kKV;
  static constexpr int kSeg = kStages * (kBK + 2) * 4;
  static constexpr int kBars = (1 + 2 * kStages) * 8;
  static constexpr int kBytes = 1024 + kTiles + kSeg + kBars;
};

template <int D, int DT>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_sm90(const __grid_constant__ CUtensorMap mq,
             const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv, const Params a) {
  using P = FwdPlan<D>;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t raw[];
  uint8_t* sm = aligned_smem(raw);
  uint16_t* qs = reinterpret_cast<uint16_t*>(sm);
  uint8_t* ks = sm + P::kQ;                     // [stage] of kKV bytes
  uint8_t* vs = sm + P::kQ + kStages * P::kKV;  // [stage] of kKV bytes
  int* kseg = reinterpret_cast<int*>(sm + P::kTiles);  // [stage][kBK + 2]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + P::kTiles + P::kSeg);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int qt = a.T / kRows - 1 - blockIdx.x;  // heaviest causal first
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * kRows;
  int first, last;
  band<kRows, kBK>(q0, true, a, first, last);
  const int n = last - first;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);   // the producer warp's lanes
      mbar_init(&empty[s], 8);   // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= 256) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_tx(qbar, P::kQ);
      for (int c = 0; c < D / kCols; ++c)
        tma_load(reinterpret_cast<uint8_t*>(qs) + c * kRows * 128, &mq, qbar,
                 c * kCols, h, q0, b);
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int k0 = (first + i) * kBK;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      if (a.seg)
        stage_segments<kBK>(kseg + s * (kBK + 2),
                            a.seg + int64_t(b) * a.T + k0);
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * P::kKV);
        for (int c = 0; c < D / kCols; ++c) {
          tma_load(ks + s * P::kKV + c * kBK * 128, &mk, &full[s], c * kCols,
                   hk, k0, b);
          tma_load(vs + s * P::kKV + c * kBK * 128, &mv, &full[s], c * kCols,
                   hk, k0, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128;  // consumer warpgroup 0 or 1
  const int warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + cw * 64;          // this warpgroup's first query
  const int r0 = qw + warp * 16 + g;    // this thread's rows: r0, r0 + 8
  int qs0 = 0, qs1 = 0, qval = 0;
  bool quni = false;
  if (a.seg) {
    const int* sg = a.seg + int64_t(b) * a.T;
    qs0 = sg[r0];
    qs1 = sg[r0 + 8];
    quni = uniform64(sg + qw, qval);
  }
  const float sl2 = a.scale * kLog2e;
  float m[2] = {kNegL, kNegL}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[kBK / 2];
  uint32_t pf[kBK / 16][4];  // P of the previous tile, the A operand

  // Turn i issues S = Q K^T of tile i and O += P V of tile i - 1 as one
  // batch, then (after the batch) the softmax of tile i.  The first and
  // the last turn are peeled off the loop: a wgmma under a branch makes
  // the compiler serialize every wgmma of the kernel.
  auto issue_s = [&](int s) {
    const uint16_t* kt = reinterpret_cast<const uint16_t*>(ks + s * P::kKV);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kBK, DT>::ss(sc, kmajor<kRows>(qs, cw * 64, kk),
                       kmajor<kBK>(kt, 0, kk), kk > 0);
  };
  auto issue_pv = [&](int s) {
    const uint16_t* vt = reinterpret_cast<const uint16_t*>(vs + s * P::kKV);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Mma<D, DT>::rs(o, pf[kk], mnmajor<kBK>(vt, kk), 1);
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  auto softmax = [&](int i, int s) {
    const int k0 = (first + i) * kBK;
    const int* ksg = kseg + s * (kBK + 2);
    const bool mask =
        (a.causal && k0 + kBK - 1 > qw) ||
        (a.window > 0 && qw + 63 - k0 >= a.window) ||
        (a.seg && !(quni && ksg[kBK] && ksg[kBK + 1] == qval));
    float mx[2] = {kNegL, kNegL};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * sl2;
        if (mask) {
          const int c = 8 * j + 2 * t + (e & 1);
          const int qp = (e & 2) ? r0 + 8 : r0;
          bool k = keep(qp, k0 + c, a);
          if (a.seg) k = k && ((e & 2) ? qs1 : qs0) == ksg[c];
          if (!k) x = kNegL;
        }
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = ex2(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(sc[4 * j + e] - m[e >> 1]);
        ps[e >> 1] += p;
        sc[4 * j + e] = p;
      }
    }
    to_frags<DT>(sc, pf);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(ps[r]);
#pragma unroll
    for (int i2 = 0; i2 < D / 2; ++i2) o[i2] *= corr[(i2 >> 1) & 1];
  };

  mbar_wait(qbar, 0);
  if (cw == 1) turn_pass(cw);  // warpgroup 0 issues first
  mbar_wait(&full[0], 0);
  turn_wait(cw);
  wg_fence();
  issue_s(0);
  wg_commit();
  turn_pass(cw);
  wg_wait0();
  hold(sc);
  softmax(0, 0);
  for (int i = 1; i < n; ++i) {
    const int s = i % kStages, sp = (i - 1) % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    turn_wait(cw);
    wg_fence();
    issue_s(s);
    issue_pv(sp);
    wg_commit();
    turn_pass(cw);
    wg_wait0();
    hold(sc);
    hold(o);
    release(sp);
    softmax(i, s);
  }
  turn_wait(cw);
  wg_fence();
  issue_pv((n - 1) % kStages);
  wg_commit();
  if (cw == 0) turn_pass(cw);  // warpgroup 1 takes no turn after this
  wg_wait0();
  hold(o);
  release((n - 1) % kStages);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int64_t off = ((int64_t(b) * a.T + row) * a.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair<DT>(a.o, off + 8 * j + 2 * t, o[4 * j + 2 * r] / l[r],
                     o[4 * j + 2 * r + 1] / l[r], false);
    if (t == 0)
      a.lse[(int64_t(b) * a.T + row) * a.Hq + h] = m[r] * kLn2 + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// K6: dk, dv.  CTA (k tile of 128 rows, b * Hq + h), one per q head.
// ---------------------------------------------------------------------------

template <int D>
struct BwdPlan {
  static constexpr int kStages = 3;
  static constexpr int kKV = kRows * D * 2;  // bytes of the K or V tile
  static constexpr int kQ = kBQ * D * 2;     // bytes of one Q or dO tile
  static constexpr int kTiles = 2 * kKV + 2 * kStages * kQ;
  static constexpr int kVec = 3 * kBQ + 2;   // lse2, delta, seg, uniform
  static constexpr int kVecs = kStages * kVec * 4;
  static constexpr int kBars = (1 + 2 * kStages) * 8;
  static constexpr int kBytes = 1024 + kTiles + kVecs + kBars;
};

template <int D, int DT>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkv_sm90(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mdo, const Params a) {
  using P = BwdPlan<D>;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t raw[];
  uint8_t* sm = aligned_smem(raw);
  uint16_t* ks = reinterpret_cast<uint16_t*>(sm);
  uint16_t* vs = reinterpret_cast<uint16_t*>(sm + P::kKV);
  uint8_t* qs = sm + 2 * P::kKV;                   // [stage] of kQ bytes
  uint8_t* dos = sm + 2 * P::kKV + kStages * P::kQ;
  float* vecs = reinterpret_cast<float*>(sm + P::kTiles);  // [stage][kVec]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + P::kTiles + P::kVecs);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;

  const int kt = blockIdx.x;  // causal: low k tiles see the most q tiles
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
  const int k0 = kt * kRows;
  int first, last;
  band<kRows, kBQ>(k0, false, a, first, last);
  const int n = last - first;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= 256) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * P::kKV);
      for (int c = 0; c < D / kCols; ++c) {
        tma_load(reinterpret_cast<uint8_t*>(ks) + c * kRows * 128, &mk, kvbar,
                 c * kCols, hk, k0, b);
        tma_load(reinterpret_cast<uint8_t*>(vs) + c * kRows * 128, &mv, kvbar,
                 c * kCols, hk, k0, b);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int q0 = (first + i) * kBQ;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      float* vec = vecs + s * P::kVec;
#pragma unroll
      for (int j = lane; j < kBQ; j += 32) {
        const int64_t row = (int64_t(b) * a.T + q0 + j) * a.Hq + h;
        vec[j] = a.lse_in[row] * kLog2e;
        vec[kBQ + j] = a.delta[row];
      }
      if (a.seg)
        stage_segments<kBQ>(reinterpret_cast<int*>(vec + 2 * kBQ),
                            a.seg + int64_t(b) * a.T + q0);
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * P::kQ);
        for (int c = 0; c < D / kCols; ++c) {
          tma_load(qs + s * P::kQ + c * kBQ * 128, &mq, &full[s], c * kCols,
                   h, q0, b);
          tma_load(dos + s * P::kQ + c * kBQ * 128, &mdo, &full[s],
                   c * kCols, h, q0, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128;  // consumer warpgroup 0 or 1
  const int warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + cw * 64;          // this warpgroup's first key
  const int r0 = kw + warp * 16 + g;    // this thread's keys: r0, r0 + 8
  int ks0 = 0, ks1 = 0, kval = 0;
  bool kuni = false;
  if (a.seg) {
    const int* sg = a.seg + int64_t(b) * a.T;
    ks0 = sg[r0];
    ks1 = sg[r0 + 8];
    kuni = uniform64(sg + kw, kval);
  }
  const float sl2 = a.scale * kLog2e;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  // Per q tile: S^T and dP^T, then P^T and dS^T in registers, then dV and
  // dK, each product waited for.
  mbar_wait(kvbar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int q0 = (first + i) * kBQ;
    const uint16_t* qt = reinterpret_cast<const uint16_t*>(qs + s * P::kQ);
    const uint16_t* dot = reinterpret_cast<const uint16_t*>(dos + s * P::kQ);
    const float* lse2 = vecs + s * P::kVec;
    const float* dl = lse2 + kBQ;
    const int* qsg = reinterpret_cast<const int*>(dl + kBQ);
    mbar_wait(&full[s], (i / kStages) & 1);

    float sc[kBQ / 2], dp[kBQ / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kBQ, DT>::ss(sc, kmajor<kRows>(ks, cw * 64, kk),
                       kmajor<kBQ>(qt, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kBQ, DT>::ss(dp, kmajor<kRows>(vs, cw * 64, kk),
                       kmajor<kBQ>(dot, 0, kk), kk > 0);
    wg_commit();
    wg_wait0();
    hold(sc);
    hold(dp);

    const bool mask =
        (a.causal && q0 < kw + 63) ||
        (a.window > 0 && q0 + kBQ - 1 - kw >= a.window) ||
        (a.seg && !(kuni && qsg[kBQ] && qsg[kBQ + 1] == kval));
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = sc[4 * j + e] * sl2;
        if (mask) {
          const int kp = (e & 2) ? r0 + 8 : r0;
          bool k = keep(q0 + c, kp, a);
          if (a.seg) k = k && ((e & 2) ? ks1 : ks0) == qsg[c];
          if (!k) x = kNegL;
        }
        const float p = ex2(x - lse2[c]);
        sc[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - dl[c]) * a.scale;
      }
    }
    uint32_t pf[kBQ / 16][4], df[kBQ / 16][4];
    to_frags<DT>(sc, pf);
    to_frags<DT>(dp, df);

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      Mma<D, DT>::rs(dv, pf[kk], mnmajor<kBQ>(dot, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      Mma<D, DT>::rs(dk, df[kk], mnmajor<kBQ>(qt, kk), 1);
    wg_commit();
    wg_wait0();
    hold(dv);
    hold(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Output rows per q head ([B, T, Hq, D]); with Hq == Hkv that is the kv
  // head itself.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t off = ((int64_t(b) * a.T + r0 + 8 * r) * a.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int64_t at = off + 8 * j + 2 * t;
      store_pair<DT>(a.o, at, dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1],
                     a.out_f32);
      store_pair<DT>(a.o2, at, dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1],
                     a.out_f32);
    }
  }
}

// ---------------------------------------------------------------------------
// K5: dq.  CTA (q tile of 128 rows, b * Hq + h): K6's pipeline with the
// roles swapped.  Q and dO rows are resident, K and V tiles walked.
// ---------------------------------------------------------------------------

template <int D>
struct DqPlan {
  static constexpr int kStages = 4;  // 3: 4% slower (PERF.md)
  static constexpr int kQ = kRows * D * 2;     // bytes of the Q or dO tile
  static constexpr int kKV = kBKey * D * 2;    // bytes of one K or V tile
  static constexpr int kTiles = 2 * kQ + 2 * kStages * kKV;
  static constexpr int kSeg = kStages * (kBKey + 2) * 4;
  static constexpr int kBars = (1 + 2 * kStages) * 8;
  static constexpr int kBytes = 1024 + kTiles + kSeg + kBars;
};

template <int D, int DT>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_sm90(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mdo, const Params a) {
  using P = DqPlan<D>;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t raw[];
  uint8_t* sm = aligned_smem(raw);
  uint16_t* qs = reinterpret_cast<uint16_t*>(sm);
  uint16_t* dos = reinterpret_cast<uint16_t*>(sm + P::kQ);
  uint8_t* ks = sm + 2 * P::kQ;                     // [stage] of kKV bytes
  uint8_t* vs = sm + 2 * P::kQ + kStages * P::kKV;  // [stage] of kKV bytes
  int* kseg = reinterpret_cast<int*>(sm + P::kTiles);  // [stage][kBKey + 2]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + P::kTiles + P::kSeg);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int qt = a.T / kRows - 1 - blockIdx.x;  // heaviest causal first
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * kRows;
  int first, last;
  band<kRows, kBKey>(q0, true, a, first, last);
  const int n = last - first;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);   // the producer warp's lanes
      mbar_init(&empty[s], 8);   // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= 256) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_tx(qbar, 2 * P::kQ);
      for (int c = 0; c < D / kCols; ++c) {
        tma_load(reinterpret_cast<uint8_t*>(qs) + c * kRows * 128, &mq, qbar,
                 c * kCols, h, q0, b);
        tma_load(reinterpret_cast<uint8_t*>(dos) + c * kRows * 128, &mdo,
                 qbar, c * kCols, h, q0, b);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int k0 = (first + i) * kBKey;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      if (a.seg)
        stage_segments<kBKey>(kseg + s * (kBKey + 2),
                              a.seg + int64_t(b) * a.T + k0);
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * P::kKV);
        for (int c = 0; c < D / kCols; ++c) {
          tma_load(ks + s * P::kKV + c * kBKey * 128, &mk, &full[s],
                   c * kCols, hk, k0, b);
          tma_load(vs + s * P::kKV + c * kBKey * 128, &mv, &full[s],
                   c * kCols, hk, k0, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128;  // consumer warpgroup 0 or 1
  const int warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + cw * 64;          // this warpgroup's first query
  const int r0 = qw + warp * 16 + g;    // this thread's rows: r0, r0 + 8
  int qs0 = 0, qs1 = 0, qval = 0;
  bool quni = false;
  if (a.seg) {
    const int* sg = a.seg + int64_t(b) * a.T;
    qs0 = sg[r0];
    qs1 = sg[r0 + 8];
    quni = uniform64(sg + qw, qval);
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = (int64_t(b) * a.T + r0 + 8 * r) * a.Hq + h;
    lse2[r] = a.lse_in[row] * kLog2e;
    dl[r] = a.delta[row];
  }
  const float sl2 = a.scale * kLog2e;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  // Per k tile: S and dP as two wgmma groups; P's exponentials once S is
  // done (wait_group 1) while dP finishes; then dS in registers and dQ +=
  // dS K, waited for.  At D = 64 the two consumer warpgroups take turns
  // to issue (K4's named barriers, two turns a tile), so that one's
  // products run while the other computes; at D = 128 the turns measured
  // slower (PERF.md) and each warpgroup issues when it is ready.
  constexpr bool kTurns = D == 64;
  mbar_wait(qbar, 0);
  if (kTurns && cw == 1) turn_pass(cw);  // warpgroup 0 issues first
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int k0 = (first + i) * kBKey;
    const uint16_t* kt = reinterpret_cast<const uint16_t*>(ks + s * P::kKV);
    const uint16_t* vt = reinterpret_cast<const uint16_t*>(vs + s * P::kKV);
    const int* ksg = kseg + s * (kBKey + 2);
    mbar_wait(&full[s], (i / kStages) & 1);

    float sc[kBKey / 2], dp[kBKey / 2];
    if (kTurns) turn_wait(cw);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kBKey, DT>::ss(sc, kmajor<kRows>(qs, cw * 64, kk),
                         kmajor<kBKey>(kt, 0, kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kBKey, DT>::ss(dp, kmajor<kRows>(dos, cw * 64, kk),
                         kmajor<kBKey>(vt, 0, kk), kk > 0);
    wg_commit();
    if (kTurns) turn_pass(cw);
    wg_wait1();
    hold(sc);

    const bool mask =
        (a.causal && k0 + kBKey - 1 > qw) ||
        (a.window > 0 && qw + 63 - k0 >= a.window) ||
        (a.seg && !(quni && ksg[kBKey] && ksg[kBKey + 1] == qval));
#pragma unroll
    for (int j = 0; j < kBKey / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = sc[4 * j + e] * sl2;
        if (mask) {
          const int qp = (e & 2) ? r0 + 8 : r0;
          bool k = keep(qp, k0 + c, a);
          if (a.seg) k = k && ((e & 2) ? qs1 : qs0) == ksg[c];
          if (!k) x = kNegL;
        }
        sc[4 * j + e] = ex2(x - lse2[e >> 1]);
      }
    }
    wg_wait0();
    hold(dp);
#pragma unroll
    for (int e = 0; e < kBKey / 2; ++e)
      dp[e] = sc[e] * (dp[e] - dl[(e >> 1) & 1]) * a.scale;
    uint32_t df[kBKey / 16][4];
    to_frags<DT>(dp, df);

    if (kTurns) turn_wait(cw);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBKey / 16; ++kk)
      Mma<D, DT>::rs(dq, df[kk], mnmajor<kBKey>(kt, kk), 1);
    wg_commit();
    // Warpgroup 1 takes no turn after its last.
    if (kTurns && (cw == 0 || i + 1 < n)) turn_pass(cw);
    wg_wait0();
    hold(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t off = ((int64_t(b) * a.T + r0 + 8 * r) * a.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair<DT>(a.o, off + 8 * j + 2 * t, dq[4 * j + 2 * r],
                     dq[4 * j + 2 * r + 1], false);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches
// ---------------------------------------------------------------------------

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

constexpr int kErrNoEncoder = 20001;  // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 20002;     // the encoder refused the map

// Tensor map of one head's rows of a contiguous [B, T, H, D] 16-bit
// tensor: dims (D, H, T, B), innermost first, byte strides (2D, 2HD,
// 2THD); a box of (64, 1, rows, 1) lands a [rows][64] tile, 128-byte
// swizzled.
int head_rows_map(CUtensorMap* m, const void* base, int B, int T, int H,
                  int D, int rows, int dt) {
  EncodeFn enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(H) * D * 2,
                                 cuuint64_t(T) * H * D * 2};
  const cuuint32_t box[4] = {cuuint32_t(kCols), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      m, dt == kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, int bytes, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool valid(int B, int T, int Hq, int Hkv, int D, int dtype) {
  return (dtype == kBf16 || dtype == kF16) && (D == 64 || D == 128) &&
         B > 0 && T > 0 && T % kRows == 0 && Hkv > 0 && Hq % Hkv == 0;
}

Params make_params(const int* seg, int T, int Hq, int Hkv, int causal,
                   int window, float scale) {
  Params a{};
  a.seg = seg;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return a;
}

template <int D, int DT>
int fwd(const void* q, const void* k, const void* v, const Params& a, int B,
        void* stream) {
  CUtensorMap mq, mk, mv;
  int rc = head_rows_map(&mq, q, B, a.T, a.Hq, D, kRows, DT);
  if (!rc) rc = head_rows_map(&mk, k, B, a.T, a.Hkv, D, kBK, DT);
  if (!rc) rc = head_rows_map(&mv, v, B, a.T, a.Hkv, D, kBK, DT);
  if (rc) return rc;
  return launch(fwd_sm90<D, DT>, dim3(a.T / kRows, B * a.Hq), kThreads,
                FwdPlan<D>::kBytes, stream, mq, mk, mv, a);
}

template <int D, int DT>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const Params& a, int B, void* stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc = head_rows_map(&mq, q, B, a.T, a.Hq, D, kBQ, DT);
  if (!rc) rc = head_rows_map(&mdo, dout, B, a.T, a.Hq, D, kBQ, DT);
  if (!rc) rc = head_rows_map(&mk, k, B, a.T, a.Hkv, D, kRows, DT);
  if (!rc) rc = head_rows_map(&mv, v, B, a.T, a.Hkv, D, kRows, DT);
  if (rc) return rc;
  return launch(bwd_dkv_sm90<D, DT>, dim3(a.T / kRows, B * a.Hq), kThreads,
                BwdPlan<D>::kBytes, stream, mq, mk, mv, mdo, a);
}

template <int D, int DT>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const Params& a, int B, void* stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc = head_rows_map(&mq, q, B, a.T, a.Hq, D, kRows, DT);
  if (!rc) rc = head_rows_map(&mdo, dout, B, a.T, a.Hq, D, kRows, DT);
  if (!rc) rc = head_rows_map(&mk, k, B, a.T, a.Hkv, D, kBKey, DT);
  if (!rc) rc = head_rows_map(&mv, v, B, a.T, a.Hkv, D, kBKey, DT);
  if (rc) return rc;
  return launch(bwd_dq_sm90<D, DT>, dim3(a.T / kRows, B * a.Hq), kThreads,
                DqPlan<D>::kBytes, stream, mq, mk, mv, mdo, a);
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch, the error of the
// launch's set-up, cudaErrorInvalidValue for arguments it does not take
// (dtype other than 1 = bf16 / 2 = f16, D other than 64 / 128, T % 128,
// Hq % Hkv, a tensor not 16-byte aligned), 20001 when the driver has no
// cuTensorMapEncodeTiled and 20002 when it refuses a tensor map.

extern "C" int hvd_flash_fwd_sm90(const void* q, const void* k,
                                  const void* v, const int* seg, void* o,
                                  float* lse, int B, int T, int Hq, int Hkv,
                                  int D, int dtype, int causal, int window,
                                  float scale, void* stream) {
  if (!valid(B, T, Hq, Hkv, D, dtype) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  Params a = make_params(seg, T, Hq, Hkv, causal, window, scale);
  a.o = o;
  a.lse = lse;
  if (dtype == kBf16)
    return D == 64 ? fwd<64, kBf16>(q, k, v, a, B, stream)
                   : fwd<128, kBf16>(q, k, v, a, B, stream);
  return D == 64 ? fwd<64, kF16>(q, k, v, a, B, stream)
                 : fwd<128, kF16>(q, k, v, a, B, stream);
}

// dq: [B, T, Hq, D] in q's dtype.
extern "C" int hvd_flash_bwd_dq_sm90(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     const int* seg, void* dq, int B, int T,
                                     int Hq, int Hkv, int D, int dtype,
                                     int causal, int window, float scale,
                                     void* stream) {
  if (!valid(B, T, Hq, Hkv, D, dtype) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  Params a = make_params(seg, T, Hq, Hkv, causal, window, scale);
  a.lse_in = lse;
  a.delta = delta;
  a.o = dq;
  if (dtype == kBf16)
    return D == 64 ? bwd_dq<64, kBf16>(q, k, v, dout, a, B, stream)
                   : bwd_dq<128, kBf16>(q, k, v, dout, a, B, stream);
  return D == 64 ? bwd_dq<64, kF16>(q, k, v, dout, a, B, stream)
                 : bwd_dq<128, kF16>(q, k, v, dout, a, B, stream);
}

// dk, dv: [B, T, Hq, D], f32 partials per q head when out_dtype is 0 (GQA),
// else in q's dtype (out_dtype == dtype, Hq == Hkv).
extern "C" int hvd_flash_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* seg, void* dk, void* dv,
    int out_dtype, int B, int T, int Hq, int Hkv, int D, int dtype,
    int causal, int window, float scale, void* stream) {
  if (!valid(B, T, Hq, Hkv, D, dtype) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) ||
      (out_dtype != 0 && out_dtype != dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  Params a = make_params(seg, T, Hq, Hkv, causal, window, scale);
  a.lse_in = lse;
  a.delta = delta;
  a.o = dk;
  a.o2 = dv;
  a.out_f32 = out_dtype == 0;
  if (dtype == kBf16)
    return D == 64 ? bwd_dkv<64, kBf16>(q, k, v, dout, a, B, stream)
                   : bwd_dkv<128, kBf16>(q, k, v, dout, a, B, stream);
  return D == 64 ? bwd_dkv<64, kF16>(q, k, v, dout, a, B, stream)
                 : bwd_dkv<128, kF16>(q, k, v, dout, a, B, stream);
}
