// Adasum pair-combine kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (horovod_tpu_torch/ops/adasum_kernels.py).
//
// K1 hvd_adasum_dot_norms replaces horovod_tpu/ops/pallas_kernels.py
//    fused_dot_norms (_dot_norms_kernel): [a.b, |a|^2, |b|^2] per row of
//    (k, n) inputs, f32 accumulation for f32, bf16 and f16 inputs.
//    (f16 is what Compression.fp16 puts on the wire: Adasum then combines
//    the float16 deltas.)
// K2 hvd_adasum_scaled_add replaces fused_scaled_add (_scaled_add_kernel):
//    out = ca[row] * a + cb[row] * b, computed at f32, rounded once to the
//    input dtype.
//
// Both are bound by device-memory bytes: a few flops per element against
// 8 (f32) or 4 (bf16, f16) bytes read.  The design therefore reads each
// input once with 16-byte vector loads (4 f32 or 8 bf16 / f16 a thread),
// keeps about one full wave of 256-thread blocks in flight, and writes
// nothing but the result.  Rows may be strided (the tree passes xs[0::2] / xs[1::2] views
// of the stacked buffer); a row whose pointers are not 16-byte aligned
// takes the scalar loop, and the ragged tail is masked, so nothing is
// padded.
//
// The TPU kernel walks one row's blocks in order into one accumulator; on
// Hopper one row (a fused ResNet-50 delta, 25.6M elements) spreads over
// many blocks, which run in no order.  K1 is therefore two passes: pass 1
// writes one f32 partial triple per block into scratch, pass 2 reduces a
// row's partials in a fixed order.  No atomics: every rank runs the same
// tree on the same gathered data and must get the same bits, or the ranks'
// parameters drift apart.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> struct Pack;  // elements in one 16-byte load
template <> struct Pack<float> { static constexpr int N = 4; };
template <> struct Pack<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Pack<__half> { static constexpr int N = 8; };

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

__device__ __forceinline__ void load_pack(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load_pack(const __nv_bfloat16* p, float* f) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load_pack(const __half* p, float* f) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store_pack(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_pack(__nv_bfloat16* p, const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void store_pack(__half* p, const float* f) {
  uint4 v;
  __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Sums three values over the block in a fixed order; thread 0 holds the
// result.  Must be called by all kThreads threads.
__device__ __forceinline__ void block_sum3(float& x, float& y, float& z) {
  __shared__ float s[3][kWarps];
  x = warp_sum(x);
  y = warp_sum(y);
  z = warp_sum(z);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s[0][warp] = x;
    s[1][warp] = y;
    s[2][warp] = z;
  }
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? s[0][lane] : 0.f;
    y = lane < kWarps ? s[1][lane] : 0.f;
    z = lane < kWarps ? s[2][lane] : 0.f;
    x = warp_sum(x);
    y = warp_sum(y);
    z = warp_sum(z);
  }
}

// K1 pass 1: block (blockIdx.x, row) sums its grid-stride share of the
// row and writes one partial triple to partials[row][blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dot_norms_partial(const T* __restrict__ a, const T* __restrict__ b,
                      int64_t n, int64_t lda, int64_t ldb,
                      float* __restrict__ partials) {
  constexpr int V = Pack<T>::N;
  const int64_t row = blockIdx.y;
  const T* ar = a + row * lda;
  const T* br = b + row * ldb;
  const int64_t nvec = (aligned16(ar) && aligned16(br)) ? n / V : 0;
  const int64_t start = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  float dot = 0.f, na = 0.f, nb = 0.f;
  for (int64_t v = start; v < nvec; v += stride) {
    float fa[V], fb[V];
    load_pack(ar + v * V, fa);
    load_pack(br + v * V, fb);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      dot = fmaf(fa[j], fb[j], dot);
      na = fmaf(fa[j], fa[j], na);
      nb = fmaf(fb[j], fb[j], nb);
    }
  }
  for (int64_t i = nvec * V + start; i < n; i += stride) {
    const float x = to_f32(ar[i]);
    const float y = to_f32(br[i]);
    dot = fmaf(x, y, dot);
    na = fmaf(x, x, na);
    nb = fmaf(y, y, nb);
  }
  block_sum3(dot, na, nb);
  if (threadIdx.x == 0) {
    float* p = partials + (row * gridDim.x + blockIdx.x) * 3;
    p[0] = dot;
    p[1] = na;
    p[2] = nb;
  }
}

// K1 pass 2: one block per row reduces the row's partials in a fixed order.
__global__ void __launch_bounds__(kThreads)
    dot_norms_finish(const float* __restrict__ partials, int64_t blocks,
                     float* __restrict__ out) {
  const int64_t row = blockIdx.x;
  const float* p = partials + row * blocks * 3;
  float dot = 0.f, na = 0.f, nb = 0.f;
  for (int64_t i = threadIdx.x; i < blocks; i += kThreads) {
    dot += p[3 * i];
    na += p[3 * i + 1];
    nb += p[3 * i + 2];
  }
  block_sum3(dot, na, nb);
  if (threadIdx.x == 0) {
    out[row * 3] = dot;
    out[row * 3 + 1] = na;
    out[row * 3 + 2] = nb;
  }
}

// K2: grid-stride elementwise pass.  The products and the sum are rounded
// separately (no FMA contraction), as the plain PyTorch version computes
// them, so f32 results agree bit for bit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scaled_add(const float* __restrict__ ca, const float* __restrict__ cb,
               const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ out, int64_t n, int64_t lda, int64_t ldb,
               int64_t ldo) {
  constexpr int V = Pack<T>::N;
  const int64_t row = blockIdx.y;
  const T* ar = a + row * lda;
  const T* br = b + row * ldb;
  T* orow = out + row * ldo;
  const float x = ca[row];
  const float y = cb[row];
  const bool vec = aligned16(ar) && aligned16(br) && aligned16(orow);
  const int64_t nvec = vec ? n / V : 0;
  const int64_t start = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t v = start; v < nvec; v += stride) {
    float fa[V], fb[V], fo[V];
    load_pack(ar + v * V, fa);
    load_pack(br + v * V, fb);
#pragma unroll
    for (int j = 0; j < V; ++j)
      fo[j] = __fadd_rn(__fmul_rn(x, fa[j]), __fmul_rn(y, fb[j]));
    store_pack(orow + v * V, fo);
  }
  for (int64_t i = nvec * V + start; i < n; i += stride) {
    orow[i] = from_f32<T>(__fadd_rn(__fmul_rn(x, to_f32(ar[i])),
                                    __fmul_rn(y, to_f32(br[i]))));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  `blocks` is the number of blocks per
// row, chosen by the caller from n alone so that the partial sums, and
// with them the result's bits, do not depend on the card.  `partials` is
// scratch of k * blocks * 3 floats.  Returns cudaGetLastError().
extern "C" int hvd_adasum_dot_norms(const void* a, const void* b, int64_t n,
                                    int64_t k, int64_t lda, int64_t ldb,
                                    int dtype, void* partials, int64_t blocks,
                                    void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(k));
  float* part = static_cast<float*>(partials);
  if (dtype == 0) {
    dot_norms_partial<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), n, lda,
        ldb, part);
  } else if (dtype == 1) {
    dot_norms_partial<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), n, lda, ldb, part);
  } else if (dtype == 2) {
    dot_norms_partial<__half><<<grid, kThreads, 0, s>>>(
        static_cast<const __half*>(a), static_cast<const __half*>(b), n, lda,
        ldb, part);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_norms_finish<<<static_cast<unsigned>(k), kThreads, 0, s>>>(
      part, blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_adasum_scaled_add(const void* ca, const void* cb,
                                     const void* a, const void* b, void* out,
                                     int64_t n, int64_t k, int64_t lda,
                                     int64_t ldb, int64_t ldo, int dtype,
                                     int64_t blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(k));
  const float* xa = static_cast<const float*>(ca);
  const float* xb = static_cast<const float*>(cb);
  if (dtype == 0) {
    scaled_add<float><<<grid, kThreads, 0, s>>>(
        xa, xb, static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n, lda, ldb, ldo);
  } else if (dtype == 1) {
    scaled_add<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        xa, xb, static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), n, lda, ldb, ldo);
  } else if (dtype == 2) {
    scaled_add<__half><<<grid, kThreads, 0, s>>>(
        xa, xb, static_cast<const __half*>(a), static_cast<const __half*>(b),
        static_cast<__half*>(out), n, lda, ldb, ldo);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
