// Hopper (sm_90a) kernel for softmax attention forward (flash attention):
// the LM substrate's attention with the scores kept out of device memory.
// Plain C entry point, loaded with ctypes by
// repro_torch/kernels/flash_attention/ops.py; it returns cudaGetLastError()
// so the wrapper can raise on a refused launch.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention
// (src/repro/kernels/flash_attention/kernel.py:82, body _flash_kernel :31).
// The same arithmetic: scores q.k * 1/sqrt(D) in float32, masked scores
// -1e30 (not -inf), causal masking top-left (q_pos >= k_pos, also when
// Sq != Sk), an online softmax with running (m, l, acc) starting at
// (-1e30, 0, 0), key tiles wholly above the diagonal skipped, and the
// output acc / max(l, 1e-30) written in q's type (float32 or bfloat16).
//
// Bound on an H100 SXM: operations. qwen3-14b's attention at its 4,096-
// token training sequence (40 heads of D = 128 after GQA expansion, batch
// 1, bfloat16, causal) needs 4 * 40 * sum_q (q + 1) * 128 = 1.72e11 FLOP:
// 0.17 ms at the 989 TFLOP/s bfloat16 tensor-core rate, against 0.05 ms
// for its 168 MB of q, k, v and out. This kernel does its math in float32
// on the CUDA cores (67 TFLOP/s, 2.6 ms for the same work at best), so it
// is far from that bound by design: the tensor-core version (mma, wgmma,
// TMA) is later work.
//
// Design: one block of 256 threads per (head, 64-row query tile). The
// query tile sits in shared memory as float32 for the whole block; key and
// value tiles of 32 rows stream through shared memory (bfloat16 converted
// with __bfloat162float on the way in). Four threads own one query row:
// each computes 8 of the tile's 32 scores (rows of q and k padded by one
// float, so neither read conflicts on a bank), the row's max and sum come
// from two __shfl_xor_sync steps, the probabilities go through shared
// memory, and each thread keeps D/4 of the row's accumulator columns
// (c = t + 4j) in registers, sized at compile time for D <= 64, 128 or 256.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                   // query rows per block
constexpr int kBK = 32;                   // key rows per streamed tile
constexpr int kThreads = 256;             // four threads per query row
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int D) {
  const size_t dp = D + 1;
  return sizeof(float) * (kBQ * dp + kBK * dp + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* sQ = smem;                       // kBQ x DP
  float* sK = sQ + kBQ * DP;              // kBK x DP
  float* sV = sK + kBK * DP;              // kBK x D
  float* sP = sV + kBK * D;               // kBQ x (kBK + 1)
  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;                 // this thread's query row
  const int t = tid & 3;                  // its quarter of the row
  const int qpos = q0 + r;
  const T* qb = q + bh * Sq * static_cast<int64_t>(D);
  const T* kb = k + bh * Sk * static_cast<int64_t>(D);
  const T* vb = v + bh * Sk * static_cast<int64_t>(D);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, c = i - rr * D;
    const int p = q0 + rr;
    sQ[rr * DP + c] =
        p < Sq ? to_f32(qb[static_cast<int64_t>(p) * D + c]) : 0.f;
  }
  constexpr int NJ = DMAX / 4;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {                           // tiles wholly above the diagonal
    const int last = (q0 + kBQ - 1) / kBK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                      // the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D, c = i - rr * D;
      const int p = k0 + rr;
      const bool ok = p < Sk;
      const int64_t at = static_cast<int64_t>(p) * D + c;
      sK[rr * DP + c] = ok ? to_f32(kb[at]) : 0.f;
      sV[rr * D + c] = ok ? to_f32(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * DP + d];
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) s[j] += qd * sK[(t + 4 * j) * DP + d];
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const int kp = k0 + t + 4 * j;
      const bool ok = kp < Sk && (!causal || qpos >= kp);
      s[j] = ok ? s[j] * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m, mx);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      sP[r * (kBK + 1) + t + 4 * j] = p;
      ps += p;
    }
    ps += __shfl_xor_sync(kFull, ps, 1);
    ps += __shfl_xor_sync(kFull, ps, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + ps;
    m = m_new;
    __syncthreads();                      // every row's probabilities

#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = sP[r * (kBK + 1) + kk];
      const float* vr = sV + kk * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = t + 4 * j;
        if (c < D) acc[j] += p * vr[c];
      }
    }
  }

  if (qpos >= Sq) return;
  T* orow = o + (bh * Sq + qpos) * static_cast<int64_t>(D);
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = t + 4 * j;
    if (c < D) store(orow + c, acc[j] / denom);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long BH, int Sq, int Sk, int D, float scale,
                   int causal, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DMAX>;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((Sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, D, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     long long BH, int Sq, int Sk, int D, float scale,
                     int causal, cudaStream_t stream) {
  if (D <= 64) return launch<T, 64>(q, k, v, o, BH, Sq, Sk, D, scale, causal,
                                    stream);
  if (D <= 128) return launch<T, 128>(q, k, v, o, BH, Sq, Sk, D, scale,
                                      causal, stream);
  if (D <= 256) return launch<T, 256>(q, k, v, o, BH, Sq, Sk, D, scale,
                                      causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        long long BH, int Sq, int Sk, int D, float scale,
                        int causal, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? launch_d<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, D, scale,
                                           causal, s)
                 : launch_d<float>(q, k, v, o, BH, Sq, Sk, D, scale, causal,
                                   s);
  return static_cast<int>(err);
}

}  // extern "C"
