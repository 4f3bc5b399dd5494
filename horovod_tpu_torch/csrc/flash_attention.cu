// Flash-attention kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (horovod_tpu_torch/ops/flash_attention.py).
//
// K4 hvd_flash_fwd replaces horovod_tpu/ops/flash_attention.py _fwd
//    (_fwd_kernel): flash-attention-2 forward, online softmax in f32.
//    Writes o (in q's dtype) and the per-row logsumexp lse (f32).
// K5 hvd_flash_bwd_dq replaces _bwd's dq kernel (_bwd_dq_kernel):
//    p = exp(s - lse), ds = p * (dp - delta) * scale, dQ = sum_k ds K.
// K6 hvd_flash_bwd_dkv replaces _bwd's dk/dv kernel (_bwd_dkv_kernel):
//    dV = sum_q p^T dO, dK = sum_q ds^T Q.  Under GQA it writes f32
//    partials per q head; the group sum happens in the caller, as in the
//    JAX package, so there are no atomics and results are reproducible.
//
// Layout: q, k, v, dO, o, dq, dk, dv are contiguous [B, T, H, D] (the
// public layout, read in place: no transpose to [B*H, T, D]); lse and
// delta are [B, T, Hq] f32; segment ids [B, T] int32 or null.  Inputs are
// f32, bf16 or f16, all the same (dtype code 0 / 1 / 2); D % 8 == 0,
// D <= 256; T % 128 == 0.  Rows are read as 16-byte packs of 8 elements.
//
// Numerics follow the TPU kernels: every product is formed from the
// input-dtype values and accumulated in f32 (a bf16 or f16 product is
// exact in f32, so this is the tensor-core contract up to summation
// order); masked scores are -1e30, not -inf; p is rounded to v's dtype
// before P.V, ds to k's dtype for dQ, p to dO's and ds to q's dtype for
// dV and dK; o, dq, dk, dv are rounded once at the end.
//
// What bounds them on this card: attention at the main shape (T = 16384,
// D = 64) does about 4*T^2/2*D flops per head per matmul pair against
// 4*T*D bytes, so it is bound by operations, not bytes.  This first
// design computes with f32 FMAs on the CUDA cores (67 TFLOP/s peak), not
// the tensor cores (989 TFLOP/s bf16): simple and exact in the sense
// above, and far from the bound.  Each thread block owns a tile of 64
// (or 32) rows and walks the other sequence in tiles staged in shared
// memory as f32; 256 threads form a 16 x 16 grid, each holding a 4 x 4
// (or smaller) register tile of the scores, so each shared-memory read
// feeds two FMAs.  Row statistics (max, sum) are reduced across the 16
// threads of a row with warp shuffles.  The TPU kernels carry m, l and
// acc across the sequential innermost grid axis; here that axis is the
// loop inside the block, and the loop's bounds are the causal / window
// band (what _block_gate does), so causal costs half of full.  Causal
// q tiles are scheduled heaviest first.
//
// Shared-memory rows are padded to DP + 1 floats, so a warp's reads of a
// column (stride DP + 1) fall in distinct banks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr float kNeg = -1e30f;  // _NEG of the JAX module

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* seg;
  const float* lse_in;
  const float* delta;
  void* o;      // K4: o; K5: dq; K6: dk
  void* o2;     // K6: dv
  float* lse;   // K4
  int B, T, Hq, Hkv, D;
  int dtype;      // of q, k, v, dO
  int out_dtype;  // K6: of dk, dv (f32 partials under GQA)
  int causal;
  int window;     // 0: none
  float scale;
};

__device__ __forceinline__ void load8(const void* base, int64_t off, int dt,
                                      float* f) {
  if (dt == 0) {
    const float4* p =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
    const float4 a = p[0];
    const float4 b = p[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const uint16_t*>(base) + off);
    if (dt == 1) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
      }
    } else {
      const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __half22float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
      }
    }
  }
}

__device__ __forceinline__ float round_to(float x, int dt) {
  if (dt == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (dt == 2) return __half2float(__float2half_rn(x));
  return x;
}

__device__ __forceinline__ void store1(void* base, int64_t i, float x,
                                       int dt) {
  if (dt == 0) {
    static_cast<float*>(base)[i] = x;
  } else if (dt == 1) {
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<__half*>(base)[i] = __float2half_rn(x);
  }
}

// Element offset of row t of head h in a contiguous [B, T, H, D] tensor.
__device__ __forceinline__ int64_t row_off(int b, int t, int H, int h, int T,
                                           int D) {
  return ((int64_t(b) * T + t) * H + h) * D;
}

// Stage rows [t0, t0 + R) of head h into dst[R][DP + 1] as f32.
template <int R, int DP>
__device__ __forceinline__ void load_tile(float* dst, const void* src, int b,
                                          int h, int H, int t0,
                                          const Args& a) {
  const int packs = a.D / 8;
  for (int i = threadIdx.x; i < R * packs; i += kThreads) {
    const int r = i / packs;
    const int p = i - r * packs;
    float f[8];
    load8(src, row_off(b, t0 + r, H, h, a.T, a.D) + p * 8, a.dtype, f);
    float* d = dst + r * (DP + 1) + p * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = f[j];
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[i][j] += sum_d A[ra + i][d] * Bm[cb + 16 j][d] over d < D, where A
// and Bm are [*][DP + 1] tiles; row ra + i is this thread's, column
// cb + 16 j too.
template <int DP, int RM, int CN>
__device__ __forceinline__ void dot_rows(float (&acc)[RM][CN], const float* A,
                                         int ra, const float* Bm, int cb,
                                         int D) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[RM], y[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) x[i] = A[(ra + i) * (DP + 1) + d];
#pragma unroll
    for (int j = 0; j < CN; ++j) y[j] = Bm[(cb + 16 * j) * (DP + 1) + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][o] += sum_c P[ra + i][c] * V[c][tx + 16 o] over c < C, where P is
// [*][C + 1] and V is [C][DP + 1].
template <int DP, int RM, int C>
__device__ __forceinline__ void mul_pv(float (&acc)[RM][DP / 16],
                                       const float* P, int ra, const float* V,
                                       int tx) {
  constexpr int ON = DP / 16;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float x[RM], y[ON];
#pragma unroll
    for (int i = 0; i < RM; ++i) x[i] = P[(ra + i) * (C + 1) + c];
#pragma unroll
    for (int o = 0; o < ON; ++o) y[o] = V[c * (DP + 1) + tx + 16 * o];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int o = 0; o < ON; ++o) acc[i][o] = fmaf(x[i], y[o], acc[i][o]);
  }
}

__device__ __forceinline__ bool keep(int qp, int kp, const Args& a) {
  bool k = true;
  if (a.causal) k = qp >= kp;
  if (a.window > 0) k = k && (qp - kp < a.window);
  return k;
}

// Tiles [first, last) of width BC along the walked sequence that can hold
// an unmasked entry for rows [r0, r0 + BR) (_block_gate).  `rows_are_q`:
// the block's rows are queries (K4, K5) or keys (K6).
template <int BR, int BC>
__device__ __forceinline__ void band(int r0, bool rows_are_q, const Args& a,
                                     int& first, int& last) {
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

// ---------------------------------------------------------------------------
// K4: forward.  Block (q tile, b * Hq + h); rows are queries.
// ---------------------------------------------------------------------------
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const Args a) {
  constexpr int RM = BQ / 16, CN = BK / 16, ON = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][DP + 1]
  float* Ks = Qs + BQ * (DP + 1);      // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);      // [BK][DP + 1]
  float* Ps = Vs + BK * (DP + 1);      // [BQ][BK + 1]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ra = ty * RM;
  const int qt = a.T / BQ - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;

  load_tile<BQ, DP>(Qs, a.q, b, h, a.Hq, q0, a);
  int qseg[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
    qseg[i] = a.seg ? a.seg[int64_t(b) * a.T + q0 + ra + i] : 0;
  float m[RM], l[RM], acc[RM][ON];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int o = 0; o < ON; ++o) acc[i][o] = 0.f;
  }
  int first, last;
  band<BQ, BK>(q0, true, a, first, last);
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's readers are done
    load_tile<BK, DP>(Ks, a.k, b, hk, a.Hkv, k0, a);
    load_tile<BK, DP>(Vs, a.v, b, hk, a.Hkv, k0, a);
    __syncthreads();
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    dot_rows<DP, RM, CN>(s, Qs, ra, Ks, tx, a.D);
    int kseg[CN];
#pragma unroll
    for (int j = 0; j < CN; ++j)
      kseg[j] = a.seg ? a.seg[int64_t(b) * a.T + k0 + tx + 16 * j] : 0;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mc = kNeg;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool k = keep(q0 + ra + i, kp, a) && qseg[i] == kseg[j];
        s[i][j] = k ? s[i][j] * a.scale : kNeg;
        mc = fmaxf(mc, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mc));
      const float corr = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        Ps[(ra + i) * (BK + 1) + tx + 16 * j] = round_to(p, a.dtype);
      }
      l[i] = l[i] * corr + half_warp_sum(ps);
      m[i] = mn;
#pragma unroll
      for (int o = 0; o < ON; ++o) acc[i][o] *= corr;
    }
    __syncthreads();
    mul_pv<DP, RM, BK>(acc, Ps, ra, Vs, tx);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = q0 + ra + i;
    const int64_t off = row_off(b, t, a.Hq, h, a.T, a.D);
#pragma unroll
    for (int o = 0; o < ON; ++o) {
      const int d = tx + 16 * o;
      if (d < a.D) store1(a.o, off + d, acc[i][o] / l[i], a.dtype);
    }
    if (tx == 0)
      a.lse[(int64_t(b) * a.T + t) * a.Hq + h] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// K5: dq.  Block (q tile, b * Hq + h); rows are queries.
// ---------------------------------------------------------------------------
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const Args a) {
  constexpr int RM = BQ / 16, CN = BK / 16, ON = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][DP + 1]
  float* dOs = Qs + BQ * (DP + 1);     // [BQ][DP + 1]
  float* Ks = dOs + BQ * (DP + 1);     // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);      // [BK][DP + 1]
  float* dSs = Vs + BK * (DP + 1);     // [BQ][BK + 1]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ra = ty * RM;
  const int qt = a.T / BQ - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;

  load_tile<BQ, DP>(Qs, a.q, b, h, a.Hq, q0, a);
  load_tile<BQ, DP>(dOs, a.dout, b, h, a.Hq, q0, a);
  int qseg[RM];
  float lse[RM], delta[RM], acc[RM][ON];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = int64_t(b) * a.T + q0 + ra + i;
    qseg[i] = a.seg ? a.seg[row] : 0;
    lse[i] = a.lse_in[row * a.Hq + h];
    delta[i] = a.delta[row * a.Hq + h];
#pragma unroll
    for (int o = 0; o < ON; ++o) acc[i][o] = 0.f;
  }
  int first, last;
  band<BQ, BK>(q0, true, a, first, last);
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<BK, DP>(Ks, a.k, b, hk, a.Hkv, k0, a);
    load_tile<BK, DP>(Vs, a.v, b, hk, a.Hkv, k0, a);
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<DP, RM, CN>(s, Qs, ra, Ks, tx, a.D);
    dot_rows<DP, RM, CN>(dp, dOs, ra, Vs, tx, a.D);
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int kp = k0 + tx + 16 * j;
      const int ks = a.seg ? a.seg[int64_t(b) * a.T + kp] : 0;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const bool k = keep(q0 + ra + i, kp, a) && qseg[i] == ks;
        const float x = k ? s[i][j] * a.scale : kNeg;
        const float p = expf(x - lse[i]);
        const float ds = p * (dp[i][j] - delta[i]) * a.scale;
        dSs[(ra + i) * (BK + 1) + tx + 16 * j] = round_to(ds, a.dtype);
      }
    }
    __syncthreads();
    mul_pv<DP, RM, BK>(acc, dSs, ra, Ks, tx);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t off = row_off(b, q0 + ra + i, a.Hq, h, a.T, a.D);
#pragma unroll
    for (int o = 0; o < ON; ++o) {
      const int d = tx + 16 * o;
      if (d < a.D) store1(a.o, off + d, acc[i][o], a.dtype);
    }
  }
}

// ---------------------------------------------------------------------------
// K6: dk, dv.  Block (k tile, b * Hq + h), one per q head; rows are keys.
// ---------------------------------------------------------------------------
template <int DP, int BK, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const Args a) {
  constexpr int RM = BK / 16, CN = BQ / 16, ON = DP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);      // [BK][DP + 1]
  float* Qs = Vs + BK * (DP + 1);      // [BQ][DP + 1]
  float* dOs = Qs + BQ * (DP + 1);     // [BQ][DP + 1]
  float* Ps = dOs + BQ * (DP + 1);     // [BK][BQ + 1]: p, then ds
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ra = ty * RM;
  const int kt = blockIdx.x;  // causal: low k tiles see the most q tiles
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
  const int k0 = kt * BK;

  load_tile<BK, DP>(Ks, a.k, b, hk, a.Hkv, k0, a);
  load_tile<BK, DP>(Vs, a.v, b, hk, a.Hkv, k0, a);
  int kseg[RM];
  float dk[RM][ON], dv[RM][ON];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    kseg[i] = a.seg ? a.seg[int64_t(b) * a.T + k0 + ra + i] : 0;
#pragma unroll
    for (int o = 0; o < ON; ++o) dk[i][o] = dv[i][o] = 0.f;
  }
  int first, last;
  band<BK, BQ>(k0, false, a, first, last);
  for (int qt = first; qt < last; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<BQ, DP>(Qs, a.q, b, h, a.Hq, q0, a);
    load_tile<BQ, DP>(dOs, a.dout, b, h, a.Hq, q0, a);
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<DP, RM, CN>(s, Ks, ra, Qs, tx, a.D);    // s^T
    dot_rows<DP, RM, CN>(dp, Vs, ra, dOs, tx, a.D);  // dp^T
    float ds[RM][CN];
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int qp = q0 + tx + 16 * j;
      const int64_t row = int64_t(b) * a.T + qp;
      const int qs = a.seg ? a.seg[row] : 0;
      const float lse = a.lse_in[row * a.Hq + h];
      const float delta = a.delta[row * a.Hq + h];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const bool k = keep(qp, k0 + ra + i, a) && qs == kseg[i];
        const float x = k ? s[i][j] * a.scale : kNeg;
        const float p = expf(x - lse);
        ds[i][j] = p * (dp[i][j] - delta) * a.scale;
        Ps[(ra + i) * (BQ + 1) + tx + 16 * j] = round_to(p, a.dtype);
      }
    }
    __syncthreads();
    mul_pv<DP, RM, BQ>(dv, Ps, ra, dOs, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        Ps[(ra + i) * (BQ + 1) + tx + 16 * j] = round_to(ds[i][j], a.dtype);
    __syncthreads();
    mul_pv<DP, RM, BQ>(dk, Ps, ra, Qs, tx);
  }
  // Output rows: per q head ([B, T, Hq, D]); with Hq == Hkv that is the
  // kv head itself.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t off = row_off(b, k0 + ra + i, a.Hq, h, a.T, a.D);
#pragma unroll
    for (int o = 0; o < ON; ++o) {
      const int d = tx + 16 * o;
      if (d < a.D) {
        store1(a.o, off + d, dk[i][o], a.out_dtype);
        store1(a.o2, off + d, dv[i][o], a.out_dtype);
      }
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int rows, int tiles_of_rows, size_t smem_floats,
           const Args& a, void* stream) {
  const size_t bytes = smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.T / tiles_of_rows),
                  static_cast<unsigned>(rows));
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Padded head dim: the smallest of 32, 64, 128, 256 that holds D.
int padded(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256; }

template <int DP, int BQ, int BK>
int fwd(const Args& a, void* s) {
  return launch(flash_fwd<DP, BQ, BK>, a.B * a.Hq, BQ,
                (BQ + 2 * BK) * (DP + 1) + BQ * (BK + 1), a, s);
}

template <int DP, int BQ, int BK>
int bwd_dq(const Args& a, void* s) {
  return launch(flash_bwd_dq<DP, BQ, BK>, a.B * a.Hq, BQ,
                (2 * BQ + 2 * BK) * (DP + 1) + BQ * (BK + 1), a, s);
}

template <int DP, int BK, int BQ>
int bwd_dkv(const Args& a, void* s) {
  return launch(flash_bwd_dkv<DP, BK, BQ>, a.B * a.Hq, BK,
                (2 * BK + 2 * BQ) * (DP + 1) + BK * (BQ + 1), a, s);
}

Args make_args(const void* q, const void* k, const void* v, const int* seg,
               int B, int T, int Hq, int Hkv, int D, int dtype, int causal,
               int window, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg = seg;
  a.B = B;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.dtype = dtype;
  a.out_dtype = dtype;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return a;
}

bool valid(const Args& a) {
  return a.dtype >= 0 && a.dtype <= 2 && a.out_dtype >= 0 &&
         a.out_dtype <= 2 && a.D > 0 && a.D <= 256 && a.D % 8 == 0 &&
         a.T > 0 && a.T % 128 == 0 && a.Hkv > 0 && a.Hq % a.Hkv == 0 &&
         a.B > 0;
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (or the error of
// the launch's set-up); cudaErrorInvalidValue for arguments it does not take.
// Tiles: K4 64 x 64 at every D; K5 64 x 64 up to D = 128 and 64 x 32 at
// D <= 256; K6 64 x 64 up to D = 128 and 32 x 32 at D <= 256 (shared
// memory: at most 214 KB, K4 at D = 256).

extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             const int* seg, void* o, float* lse, int B, int T,
                             int Hq, int Hkv, int D, int dtype, int causal,
                             int window, float scale, void* stream) {
  Args a = make_args(q, k, v, seg, B, T, Hq, Hkv, D, dtype, causal, window,
                     scale);
  a.o = o;
  a.lse = lse;
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (padded(D)) {
    case 32: return fwd<32, 64, 64>(a, stream);
    case 64: return fwd<64, 64, 64>(a, stream);
    case 128: return fwd<128, 64, 64>(a, stream);
    default: return fwd<256, 64, 64>(a, stream);
  }
}

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, const int* seg, void* dq,
                                int B, int T, int Hq, int Hkv, int D,
                                int dtype, int causal, int window, float scale,
                                void* stream) {
  Args a = make_args(q, k, v, seg, B, T, Hq, Hkv, D, dtype, causal, window,
                     scale);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.o = dq;
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (padded(D)) {
    case 32: return bwd_dq<32, 64, 64>(a, stream);
    case 64: return bwd_dq<64, 64, 64>(a, stream);
    case 128: return bwd_dq<128, 64, 64>(a, stream);
    default: return bwd_dq<256, 64, 32>(a, stream);
  }
}

// dk, dv: [B, T, Hq, D] in out_dtype (f32 partials per q head under GQA,
// else k's dtype with Hq == Hkv).
extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int* seg, void* dk,
                                 void* dv, int out_dtype, int B, int T, int Hq,
                                 int Hkv, int D, int dtype, int causal,
                                 int window, float scale, void* stream) {
  Args a = make_args(q, k, v, seg, B, T, Hq, Hkv, D, dtype, causal, window,
                     scale);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.o = dk;
  a.o2 = dv;
  a.out_dtype = out_dtype;
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (padded(D)) {
    case 32: return bwd_dkv<32, 64, 64>(a, stream);
    case 64: return bwd_dkv<64, 64, 64>(a, stream);
    case 128: return bwd_dkv<128, 64, 64>(a, stream);
    default: return bwd_dkv<256, 32, 32>(a, stream);
  }
}
