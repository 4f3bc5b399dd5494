// Tiled matrix product for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (horovod_tpu_torch/ops/matmul_kernels.py).
//
// K3 hvd_tiled_matmul replaces horovod_tpu/ops/fused_collectives.py
//    pallas_matmul (_matmul_kernel, the pl.pallas_call at :286): C = A @ B
//    for A (M, K) and B (K, N) in f32, bf16 or f16, products and sums in
//    f32, C in the input dtype.  It is the compute stage of the fused
//    allgather-matmul chunks (fused_allgather_matmul), which ZeRO-3's
//    gather_matmul runs for the transformer's tied head.
//
// What bounds it: at the head chunk (16384, 512) @ (512, 512) f32 the
// product is 8.59 GFLOP against 68 MB of operands and result, so it is
// bound by operations: 0.128 ms at the H100's 67 TFLOP/s f32 rate outside
// the tensor cores, against 0.020 ms for the bytes.  TF32 would change the
// f32 result, so this kernel stays on the CUDA cores (tensor cores, wgmma
// and TMA are later work).
//
// Design: one 256-thread block computes a 128 x 128 tile of C; each thread
// holds an 8 x 8 register tile of f32 sums.  K advances 8 at a time through
// two shared-memory buffers: while the block computes on one, the next
// slice of A and B is loaded into registers and then stored into the
// other, so one barrier per slice suffices.  Operands are read through
// their strides, so B may be a transposed view (the fused path multiplies
// by a gathered weight band's transpose); the loads walk whichever
// dimension is contiguous.  Each thread's 8 rows and 8 columns are split
// into two groups of four 64 apart, so the shared-memory reads are
// 16-byte vectors without bank conflicts, and the shared tiles carry 4
// floats of padding per row for the same reason on the stores.
//
// The TPU kernel pads every dimension to a multiple of 128 and adds each
// K tile's product into the output in the output dtype.  Here nothing is
// padded: loads outside the matrix read zero and stores outside it are
// skipped.  The sum over the whole of K stays in one f32 register per
// output and is rounded once to the output dtype, as the reference's
// docstring promises; k runs in order, so the bits are the same on every
// launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows of C per block
constexpr int kBN = 128;  // columns of C per block
constexpr int kBK = 8;    // depth of one shared-memory slice
constexpr int kPad = 4;   // floats of padding per shared row
constexpr int kLoads = kBM * kBK / kThreads;  // elements per thread per slice

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Four consecutive outputs of one row, as one vector store.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, const float* v) {
  __half2 lo = __floats2half2_rn(v[0], v[1]);
  __half2 hi = __floats2half2_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// C (M, N), row stride ldc, = A (M, K) @ B (K, N), each operand read
// through its two strides.  vec_store: ldc and C's address allow 4-wide
// vector stores of a row.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
tiled_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    T* __restrict__ C, int64_t M, int64_t N, int64_t K,
                    int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
                    int64_t ldc, bool vec_store) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;
  // Which dimension of each operand the loads walk (the contiguous one).
  const bool a_kfast = sak == 1;
  const bool b_nfast = sbn == 1;

  float ra[kLoads], rb[kLoads];
  // Slice loads: element l of the block's (kBM x kBK) A slice and
  // (kBK x kBN) B slice; out of the matrix reads zero.
  auto a_pos = [&](int l, int& mm, int& kk) {
    if (a_kfast) { mm = l / kBK; kk = l % kBK; }
    else { mm = l % kBM; kk = l / kBM; }
  };
  auto b_pos = [&](int l, int& kk, int& nn) {
    if (b_nfast) { kk = l / kBN; nn = l % kBN; }
    else { nn = l / kBK; kk = l % kBK; }
  };
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int l = tid + i * kThreads;
      int mm, kk, nn;
      a_pos(l, mm, kk);
      const int64_t gm = m0 + mm, gka = k0 + kk;
      ra[i] = (gm < M && gka < K) ? to_f32(A[gm * sam + gka * sak]) : 0.f;
      b_pos(l, kk, nn);
      const int64_t gkb = k0 + kk, gn = n0 + nn;
      rb[i] = (gkb < K && gn < N) ? to_f32(B[gkb * sbk + gn * sbn]) : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int l = tid + i * kThreads;
      int mm, kk, nn;
      a_pos(l, mm, kk);
      As[buf][kk][mm] = ra[i];
      b_pos(l, kk, nn);
      Bs[buf][kk][nn] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int64_t slices = (K + kBK - 1) / kBK;
  load(0);
  stash(0);
  __syncthreads();
  for (int64_t s = 0; s < slices; ++s) {
    const int cur = static_cast<int>(s & 1);
    if (s + 1 < slices) load((s + 1) * kBK);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // The other buffer's last readers passed the previous barrier.
    if (s + 1 < slices) stash(cur ^ 1);
    __syncthreads();
  }

  // Rows ty*4 + i and 64 + ty*4 + i; columns tx*4 + j and 64 + tx*4 + j.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gn = n0 + h * 64 + tx * 4;
      T* dst = C + gm * ldc + gn;
      const float* v = &acc[i][h * 4];
      if (vec_store && gn + 3 < N) {
        store4(dst, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) dst[j] = from_f32<T>(v[j]);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int64_t m, int64_t n,
           int64_t k, int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
           int64_t ldc, int vec_store, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((n + kBN - 1) / kBN));
  tiled_matmul_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k, sam, sak, sbk, sbn, ldc, vec_store != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16.  Strides in elements.  Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int hvd_tiled_matmul(const void* a, const void* b, void* c,
                                int64_t m, int64_t n, int64_t k, int64_t sam,
                                int64_t sak, int64_t sbk, int64_t sbn,
                                int64_t ldc, int vec_store, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((m + kBM - 1) / kBM > 2147483647LL || (n + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(a, b, c, m, n, k, sam, sak, sbk, sbn, ldc,
                           vec_store, s);
    case 1:
      return launch<__nv_bfloat16>(a, b, c, m, n, k, sam, sak, sbk, sbn, ldc,
                                   vec_store, s);
    case 2:
      return launch<__half>(a, b, c, m, n, k, sam, sak, sbk, sbn, ldc,
                            vec_store, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
