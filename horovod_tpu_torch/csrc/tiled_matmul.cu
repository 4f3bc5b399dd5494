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
// f32 result, so this kernel stays on the CUDA cores (a tensor-core route
// for 16-bit inputs is later work).
//
// Design, a pipelined SGEMM.  On the head's path both operands are
// contiguous along K: A is the flattened hidden rows, B the transposed view
// of a weight band, so B's columns are rows of the band ("NT").
//
// - One 256-thread block computes a 128 x 128 tile of C.  Its eight warps
//   form a 4 x 2 grid of 32 x 64 warp tiles; a warp's lanes a 4 x 8 grid,
//   each lane holding 8 x 8 f32 sums: rows ly + 4i and columns lx + 8j of
//   its warp's tile.
// - K advances 64 at a time through a ring of three shared stages.  Each
//   stage holds the block's 128 rows of A and 128 columns of B as they lie
//   in memory, [row][k], each row padded by 16 bytes: 16-byte cp.async
//   copies cannot transpose, and the pad puts the rows of one fragment
//   read (4 rows of A, 8 columns of B, whose row indices differ by 1 and
//   whose 16-byte row pitch is odd) in distinct banks.  Two stages are in
//   flight while the third is multiplied; cp.async.wait_group and one
//   barrier per 64-deep stage (8 at K = 512) order them.  Each thread's
//   copy addresses are computed once per block.
// - A fragment read takes four consecutive k of a row (one float4 in f32,
//   8 bytes in bf16 / f16, converted to f32 as it is read), so one read
//   serves four k steps.  The loop over a stage is unrolled and ptxas
//   reads the next fragments during the products on its own: a second,
//   explicit register set measured no faster (PERF.md).  Each thread has
//   up to 255 registers (one block per SM; two blocks of 128 registers
//   spill and measured slower).
// - 256 x 128 block tiles (16 x 8 sums a thread, kBM = 256) read a third
//   fewer values from shared memory per product and measured within 1%:
//   shared-memory bandwidth is not what holds this kernel.
// - The tile of C goes out through shared memory: staged as f32, then
//   written row by row, four values per store.
//
// Layouts that cannot take 16-byte copies (an operand not contiguous
// along K, a row pitch or base address not 16-byte aligned) or 4-wide
// stores (ldc or C's address not 4-element aligned) take the strided path
// of the same kernel: element loads through both strides, walking the
// contiguous dimension, and element stores.  matmul_kernels.vector_path
// chooses, from the strides and pointers alone.
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

#define DEV __device__ __forceinline__

constexpr int kThreads = 256;
constexpr int kBM = 128;    // rows of C per block
constexpr int kTM = kBM / 16;  // rows of C per thread
constexpr int kBN = 128;    // columns of C per block
constexpr int kBK = 64;     // depth of one shared stage
constexpr int kStages = 3;  // stages in the ring
constexpr int kCPad = 8;    // floats of padding per row of the staged C

// Elements per shared row of an operand stage: kBK and 16 bytes of pad.
template <typename T>
__host__ __device__ constexpr int row_elems() {
  return kBK + 16 / static_cast<int>(sizeof(T));
}

// The ring of stages, or the staged tile of C if that is larger.
template <typename T>
constexpr int smem_bytes() {
  const int ring = kStages * (kBM + kBN) * row_elems<T>() * sizeof(T);
  const int out = kBM * (kBN + kCPad) * sizeof(float);
  return ring > out ? ring : out;
}

template <typename T> DEV T from_f32(float x);
template <> DEV float from_f32<float>(float x) { return x; }
template <> DEV __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> DEV __half from_f32<__half>(float x) { return __float2half_rn(x); }

// Four consecutive values of a shared row, as f32.
DEV void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
DEV void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
  f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
}
DEV void load4(const __half* p, float (&f)[4]) {
  const __half2* h = reinterpret_cast<const __half2*>(p);
  const float2 lo = __half22float2(h[0]), hi = __half22float2(h[1]);
  f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
}

// Four consecutive outputs of one row, as one vector store.
DEV void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
DEV void store4(__nv_bfloat16* p, const float4& v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
DEV void store4(__half* p, const float4& v) {
  __half2 lo = __floats2half2_rn(v.x, v.y);
  __half2 hi = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// 16 bytes from global to shared memory, of which the first `bytes` are
// read and the rest zero-filled.
DEV void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
DEV void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
DEV void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's 16-byte copies of an operand's stage (the vector path):
// copy `ch` of rows r + i * kStep (i < kIt) of the block's 128, whose
// starts in global memory (k = 0) are computed once, null outside the
// matrix.  Each stage then only offsets them by its first k.
template <typename T, int ROWS>
struct Copies {
  static constexpr int kPer = 16 / sizeof(T);       // elements per copy
  static constexpr int kChunks = kBK / kPer;        // copies per row
  static constexpr int kStep = kThreads / kChunks;  // rows between copies
  static constexpr int kIt = ROWS / kStep;          // copies per thread
  const T* src[kIt];
  int r, ch;

  // Rows [r0, r0 + ROWS) of an operand whose row r starts at base + r * sr
  // and holds `rows` rows.
  DEV Copies(const T* base, int64_t r0, int64_t rows, int64_t sr)
      : r(threadIdx.x / kChunks), ch(threadIdx.x % kChunks) {
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int64_t gr = r0 + r + i * kStep;
      src[i] = gr < rows ? base + gr * sr + ch * kPer : nullptr;
    }
  }

  // k [k0, k0 + kBK) into dst[ROWS][row_elems]; k >= K reads zero.
  DEV void issue(T* dst, const T* any, int64_t k0, int64_t K) const {
    constexpr int R = row_elems<T>();
    const int64_t left = K - k0 - ch * kPer;
    const int bytes = left <= 0 ? 0
                                : static_cast<int>(left < kPer ? left : kPer) *
                                      static_cast<int>(sizeof(T));
#pragma unroll
    for (int i = 0; i < kIt; ++i)
      cp_async16(dst + (r + i * kStep) * R + ch * kPer,
                 src[i] && bytes ? src[i] + k0 : any, src[i] ? bytes : 0);
  }
};

// The strided path's loads: rows [r0, r0 + ROWS) x k [k0, k0 + kBK) of an
// operand whose element (r, k) lies at src[r * sr + k * sk] (rows >= rows
// or k >= K read zero) into dst[ROWS][row_elems], element by element,
// consecutive threads along the operand's contiguous dimension.
template <typename T, int ROWS>
DEV void load_strided(T* dst, const T* src, int64_t r0, int64_t rows,
                      int64_t k0, int64_t K, int64_t sr, int64_t sk) {
  constexpr int R = row_elems<T>();
  const bool kfast = sk == 1;
#pragma unroll 4
  for (int it = 0; it < ROWS * kBK / kThreads; ++it) {
    const int l = threadIdx.x + it * kThreads;
    const int r = kfast ? l / kBK : l % ROWS;
    const int kk = kfast ? l % kBK : l / ROWS;
    const int64_t gr = r0 + r, gk = k0 + kk;
    dst[r * R + kk] = (gr < rows && gk < K) ? src[gr * sr + gk * sk]
                                            : from_f32<T>(0.f);
  }
}

// C (M, N), row stride ldc, = A (M, K) @ B (K, N), A read through strides
// (sam, sak) and B through (sbk, sbn).  kVec: the vector path (see above).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
tiled_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    T* __restrict__ C, int64_t M, int64_t N, int64_t K,
                    int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
                    int64_t ldc) {
  constexpr int R = row_elems<T>();
  extern __shared__ __align__(16) uint8_t smem[];
  T* As = reinterpret_cast<T*>(smem);  // [stage][kBM][R]
  T* Bs = As + kStages * kBM * R;      // [stage][kBN][R]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int am = (warp >> 1) * 4 * kTM + (lane >> 3);  // rows am + 4i
  const int bn = (warp & 1) * 64 + (lane & 7);    // columns bn + 8j
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;
  const int tiles = static_cast<int>((K + kBK - 1) / kBK);

  const Copies<T, kBM> a_copies(A, m0, M, sam);
  const Copies<T, kBN> b_copies(B, n0, N, sbn);
  auto load = [&](int tile) {
    const int s = tile % kStages;
    const int64_t k0 = int64_t(tile) * kBK;
    if (kVec) {
      a_copies.issue(As + s * kBM * R, A, k0, K);
      b_copies.issue(Bs + s * kBN * R, B, k0, K);
    } else {
      load_strided<T, kBM>(As + s * kBM * R, A, m0, M, k0, K, sam, sak);
      load_strided<T, kBN>(Bs + s * kBN * R, B, n0, N, k0, K, sbn, sbk);
    }
  };

  float acc[kTM][8];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t
    __syncthreads();  // everyone's copies of tile t; tile t - 1 is done
    if (t + kStages - 1 < tiles) load(t + kStages - 1);
    cp_async_commit();

    const int s = t % kStages;
    const T* as = As + (s * kBM + am) * R;
    const T* bs = Bs + (s * kBN + bn) * R;
#pragma unroll
    for (int kq = 0; kq < kBK / 4; ++kq) {
      float fa[kTM][4], fb[8][4];
#pragma unroll
      for (int i = 0; i < kTM; ++i) load4(as + 4 * i * R + 4 * kq, fa[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) load4(bs + 8 * j * R + 4 * kq, fb[j]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(fa[i][kk], fb[j][kk], acc[i][j]);
    }
  }

  // Stage the tile of C as f32, then write it out row by row.
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);  // [kBM][kBN + kCPad]
  constexpr int CR = kBN + kCPad;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) Cs[(am + 4 * i) * CR + bn + 8 * j] = acc[i][j];
  __syncthreads();
  if (kVec) {
#pragma unroll 4
    for (int it = 0; it < kBM * kBN / 4 / kThreads; ++it) {
      const int l = threadIdx.x + it * kThreads;
      const int r = l / (kBN / 4), c = 4 * (l % (kBN / 4));
      const int64_t gm = m0 + r, gn = n0 + c;
      if (gm >= M || gn >= N) continue;
      const float4 v = *reinterpret_cast<const float4*>(&Cs[r * CR + c]);
      T* dst = C + gm * ldc + gn;
      if (gn + 3 < N) {
        store4(dst, v);
      } else {
        const float w[4] = {v.x, v.y, v.z, v.w};
        for (int e = 0; gn + e < N; ++e) dst[e] = from_f32<T>(w[e]);
      }
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kBM * kBN / kThreads; ++it) {
      const int l = threadIdx.x + it * kThreads;
      const int r = l / kBN, c = l % kBN;
      const int64_t gm = m0 + r, gn = n0 + c;
      if (gm < M && gn < N) C[gm * ldc + gn] = from_f32<T>(Cs[r * CR + c]);
    }
  }
}

template <typename T, bool kVec>
int launch_path(const void* a, const void* b, void* c, int64_t m, int64_t n,
                int64_t k, int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
                int64_t ldc, cudaStream_t s) {
  auto kernel = tiled_matmul_kernel<T, kVec>;
  constexpr int bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((n + kBN - 1) / kBN));
  kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k, sam, sak, sbk, sbn, ldc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, void* c, int64_t m, int64_t n,
           int64_t k, int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
           int64_t ldc, int vec, cudaStream_t s) {
  return vec ? launch_path<T, true>(a, b, c, m, n, k, sam, sak, sbk, sbn,
                                    ldc, s)
             : launch_path<T, false>(a, b, c, m, n, k, sam, sak, sbk, sbn,
                                     ldc, s);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16.  Strides in elements.  vec: take the vector
// path (the caller has checked that the layout allows it).  Returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int hvd_tiled_matmul(const void* a, const void* b, void* c,
                                int64_t m, int64_t n, int64_t k, int64_t sam,
                                int64_t sak, int64_t sbk, int64_t sbn,
                                int64_t ldc, int vec, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((m + kBM - 1) / kBM > 2147483647LL || (n + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(a, b, c, m, n, k, sam, sak, sbk, sbn, ldc, vec, s);
    case 1:
      return launch<__nv_bfloat16>(a, b, c, m, n, k, sam, sak, sbk, sbn, ldc,
                                   vec, s);
    case 2:
      return launch<__half>(a, b, c, m, n, k, sam, sak, sbk, sbn, ldc, vec,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
