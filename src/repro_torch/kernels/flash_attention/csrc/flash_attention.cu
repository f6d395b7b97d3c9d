// Hopper (sm_90a) kernels for softmax attention forward (flash attention):
// the LM substrate's attention with the scores kept out of device memory.
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/flash_attention/ops.py; each returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses)
// so the wrapper can raise on a refused launch.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention
// (src/repro/kernels/flash_attention/kernel.py:82, body _flash_kernel :31).
// Both kernels compute the same function: scores q.k * 1/sqrt(D) in
// float32, masked scores -1e30 (not -inf), causal masking top-left (q_pos
// >= k_pos, also when Sq != Sk), an online softmax with running (m, l, acc)
// starting at (-1e30, 0, 0), key tiles wholly above the diagonal skipped,
// and the output acc / max(l, 1e-30) written in q's type.
//
// Which shapes take which kernel (ops.py::takes_tensor_cores):
// - bfloat16 with D = 64 or 128 (every LM configuration of the repo has
//   D = 128): flash_attention_fwd_sm90, the tensor-core kernel;
// - float32 and float16 at any D <= 256, and bfloat16 at any other
//   D <= 256: flash_attention_fwd, the CUDA-core kernel. float32 stays off
//   the tensor cores because its checks are the reference's 2e-5, which
//   TF32 misses. D > 256 is refused (the accumulator is sized at compile
//   time; no configuration of the repo has D other than 64 or 128).
//
// Bound on an H100 SXM: operations. qwen3-14b's attention at its 4,096-
// token training sequence (40 heads of D = 128 after GQA expansion, batch
// 1, bfloat16, causal) needs 4 * 40 * sum_q (q + 1) * 128 = 1.72e11 FLOP:
// 0.17 ms at the 989 TFLOP/s bfloat16 tensor-core rate, against 0.05 ms
// for its 168 MB of q, k, v and out. The tensor-core kernel does 1.5x the
// function's tensor work: P.V runs twice, on the bfloat16 pair P_hi =
// bf16(p) and P_lo = bf16(p - P_hi), because P rounded once to bfloat16
// misses the card's bf16 checks against the plain version (rtol 1e-2,
// atol 1e-3) on a few elements per call; with the pair the error is the
// output's own rounding. The CUDA-core kernel does its math in float32 at
// 67 TFLOP/s (2.6 ms for the same work at best).
//
// Design: flash_attention_fwd_sm90 (the tensor-core kernel).
// - One CTA per (head, 128-row query tile), heaviest causal tiles first:
//   the last query tile gets the lowest block index, so the CTAs with the
//   most key tiles start in the first wave. 384 threads: warpgroup 0 is the
//   producer (setmaxnreg down to 24 registers; one thread issues every TMA
//   load), warpgroups 1 and 2 are consumers of 64 query rows each
//   (setmaxnreg up to 240).
// - TMA over 3-D tensor maps (BH, S, D), so a ragged tile reads zeros past
//   its own head's end, never the next head's rows; 128-byte swizzle, one
//   64-column box per 128 bytes of a row (two boxes at D = 128). The Q tile
//   is loaded once; K and V tiles of 128 rows go through rings of 2 stages
//   each, with a "full" (TMA bytes) and an "empty" (one arrival per
//   consumer warpgroup) mbarrier per stage: a K stage is refilled as soon
//   as its S = Q.K^T is done, before that tile's P.V. D = 128: 32 KB of Q
//   + 2 x 64 KB of K/V. The maps are encoded on the host per call
//   (cuTensorMapEncodeTiled via cudaGetDriverEntryPoint, so the library
//   needs no -lcuda) and passed as __grid_constant__ parameters.
// - S = Q.K^T: wgmma m64n128k16, bf16 in, float32 accumulate, both operands
//   K-major in shared memory, D/16 instructions per key tile; the first
//   writes S without reading it, so S is dead during P.V.
// - The online softmax runs on the accumulator fragment in registers: row
//   max and row sum across the four threads of a quad by shuffles, exp2
//   (ex2.approx.ftz, the instruction exp2f compiles to, without its
//   denormal scaling) with scale * log2(e) folded into the scores, the
//   causal and k_pos < Sk masks applied only on the last key tile (the
//   diagonal or ragged one; TMA's zeros past Sk are scores of 0, not
//   masked scores, so they are masked there too). l sums the unrounded
//   float32 p.
// - O += P_hi.V + P_lo.V: wgmma m64n{D}k16 with A from registers (the S
//   fragment converts to bf16 pairs in place: the accumulator layout of
//   two n8 blocks is the A fragment of one k16 step) and B = V from shared
//   memory, MN-major (the transpose bit of 16-bit types).
// - Each consumer runs S, softmax, P.V in turn; the two consumers overlap
//   each other's softmax with their products. Keeping S of the next tile
//   in flight beside O and the P pair takes about 192 registers a
//   consumer thread; the variants that tried it spilled and ran slower,
//   and why their consumers did not get setmaxnreg's 240 is not settled
//   (tools/flash_attention_probe.py prints this kernel's registers,
//   spills and any ptxas warning, such as C7508, setmaxnreg ignored).
// - Epilogue: O / max(l, 1e-30) in bfloat16, stored for rows below Sq.
// - A barrier wait that lasts 60 s traps (a correct launch takes
//   milliseconds), so a fault ends the launch instead of hanging the card.
//   A trap is a sticky error: it leaves the process's CUDA context
//   unusable, and the process must exit.
//
// Design: flash_attention_fwd (the CUDA-core kernel): one block of 256
// threads per (head, 64-row query tile). The query tile sits in shared
// memory as float32 for the whole block; key and value tiles of 32 rows
// stream through shared memory (bfloat16 and float16 converted to float32
// on the way in). Four threads own one query row: each computes 8 of the
// tile's 32 scores (rows of q and k padded by one float, so neither read
// conflicts on a bank), the row's max and sum come from two __shfl_xor_sync
// steps, the probabilities go through shared memory, and each thread keeps
// D/4 of the row's accumulator columns (c = t + 4j) in registers, sized at
// compile time for D <= 64, 128 or 256.

#include <cstdint>
#include <cstring>
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// ===========================================================================
// flash_attention_fwd: the CUDA-core kernel (float32 math)
// ===========================================================================
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
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half(x);
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

// ===========================================================================
// flash_attention_fwd_sm90: the tensor-core kernel (bf16 wgmma fed by TMA)
// ===========================================================================
namespace sm90 {

constexpr int kRows = 128;                // query rows per CTA = key rows per tile
constexpr int kThreads = 384;             // producer + two consumer warpgroups
constexpr int kBoxBytes = kRows * 128;    // one TMA box: 128 rows x 64 bf16
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kWaitNs = 60000000000ull;   // 60 s

// Shared memory at D = 64 or 128, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 1024 bytes): Q, K[2], V[2], each a tile of
// D / 64 boxes, then the mbarriers: Q's, and a "full" and an "empty" one
// for each K and each V stage (K and V have rings of their own, so a K
// stage is refilled as soon as its S = Q.K^T is done).
template <int D>
struct Smem {
  static constexpr int kTile = D / 64 * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                    // + stage * kTile
  static constexpr int kV = kK + kStages * kTile;     // + stage * kTile
  static constexpr int kBarQ = kV + kStages * kTile;
  static constexpr int kFullK = kBarQ + 8;            // + stage * 8
  static constexpr int kFullV = kFullK + 8 * kStages;
  static constexpr int kEmptyK = kFullV + 8 * kStages;
  static constexpr int kEmptyV = kEmptyK + 8 * kStages;
  static constexpr int kBytes = kEmptyV + 8 * kStages + 1024;  // + align
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete; trap after 60 s.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try(bar, parity)) {
    if (globaltimer() - t0 > kWaitNs) __trap();
  }
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Registers an in-flight wgmma reads or writes: pinned across the wait so
// the compiler neither reads them early nor reuses them.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define W4(a, i) "=f"(a[i]), "=f"(a[i + 1]), "=f"(a[i + 2]), "=f"(a[i + 3])
#define SS_N128                                                             \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"

// S[64 x 128] = A[64 x 16] . B[16 x 128]: A (Q) and B (K) K-major in
// shared memory. The first step of a tile writes S without reading it ...
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" SS_N128
               : W4(d, 0), W4(d, 4), W4(d, 8), W4(d, 12), W4(d, 16),
                 W4(d, 20), W4(d, 24), W4(d, 28), W4(d, 32), W4(d, 36),
                 W4(d, 40), W4(d, 44), W4(d, 48), W4(d, 52), W4(d, 56),
                 W4(d, 60)
               : "l"(da), "l"(db), "r"(0));
}

// ... and every later one adds to it.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" SS_N128
               : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16),
                 F4(d, 20), F4(d, 24), F4(d, 28), F4(d, 32), F4(d, 36),
                 F4(d, 40), F4(d, 44), F4(d, 48), F4(d, 52), F4(d, 56),
                 F4(d, 60)
               : "l"(da), "l"(db), "r"(1));
}

// O[64 x 128] += A[64 x 16] . B[16 x 128]: A (P) in registers, B (V)
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
        F4(d, 24), F4(d, 28), F4(d, 32), F4(d, 36), F4(d, 40), F4(d, 44),
        F4(d, 48), F4(d, 52), F4(d, 56), F4(d, 60)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 64] += A[64 x 16] . B[16 x 64], as wgmma_rs_n128 at D = 64.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
        F4(d, 24), F4(d, 28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F4
#undef W4
#undef SS_N128

// 2^x with denormals flushed (exp2f's instruction without its scaling).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// S = Q.K^T for one key tile: D/16 steps of 16 columns, 32 bytes into the
// 128-byte rows of a box (the hardware applies the swizzle on the address).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_rows,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    const uint64_t dq = smem_desc(q_rows + off, 16, 1024);
    const uint64_t dk = smem_desc(k_tile + off, 16, 1024);
    if (kk == 0) {
      wgmma_ss_n128_first(sc, dq, dk);
    } else {
      wgmma_ss_n128(sc, dq, dk);
    }
  }
}

// O += P_hi.V + P_lo.V for one key tile: 16 keys (2048 bytes of V rows)
// per step; the MN-major V descriptor steps 1024 bytes per 8 keys and
// 16 KB (one box) per 64 columns.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&hi)[32],
                                         const uint32_t (&lo)[32],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dv = smem_desc(v_tile + kk * 2048, kBoxBytes, 1024);
    if constexpr (D == 128) {
      wgmma_rs_n128(acc, hi + 4 * kk, dv);
      wgmma_rs_n128(acc, lo + 4 * kk, dv);
    } else {
      wgmma_rs_n64(acc, hi + 4 * kk, dv);
      wgmma_rs_n64(acc, lo + 4 * kk, dv);
    }
  }
}

// The online softmax of one key tile on the S fragment, in place: scores
// into the log2 domain, the masks on the edge tile only (the last one: the
// diagonal or the ragged tile; every earlier tile is whole and below the
// diagonal), the new row max across the quad, p = exp2(x - m), and l over
// this thread's columns (summed across the quad at the end). Returns the
// factors that rescale the rows' earlier sums.
__device__ __forceinline__ float2 softmax_tile(float (&sc)[64], float& m0,
                                               float& m1, float& l0,
                                               float& l1, bool edge, int k0,
                                               int row0, int row1, int Sk,
                                               int causal, float scale_log2) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * n + e] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * n + (e & 1);
        const int row = e < 2 ? row0 : row1;
        if (key >= Sk || (causal && key > row)) x = kNegInf;
      }
      sc[4 * n + e] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float2 alpha = make_float2(ex2(m0 - mn0), ex2(m1 - mn1));
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    sc[4 * n] = ex2(sc[4 * n] - mn0);
    sc[4 * n + 1] = ex2(sc[4 * n + 1] - mn0);
    sc[4 * n + 2] = ex2(sc[4 * n + 2] - mn1);
    sc[4 * n + 3] = ex2(sc[4 * n + 3] - mn1);
    ps0 += sc[4 * n] + sc[4 * n + 1];
    ps1 += sc[4 * n + 2] + sc[4 * n + 3];
  }
  l0 = l0 * alpha.x + ps0;
  l1 = l1 * alpha.y + ps1;
  return alpha;
}

// p as the bf16 pair hi + lo, in the A-fragment order: registers
// 4kk..4kk+3 hold keys 16kk..16kk+15 (two 8-column blocks of S).
__device__ __forceinline__ void split_p(const float (&sc)[64],
                                        uint32_t (&hi)[32],
                                        uint32_t (&lo)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float a = sc[2 * i], b = sc[2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = bits(h);
    lo[i] = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, int BH, int Sq,
                            int Sk, float scale_log2, int causal) {
  using L = Smem<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t bar_q = base + L::kBarQ;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int n_kt = (Sk + kRows - 1) / kRows;
  const int n_tiles = causal ? min(n_kt, qt + 1) : n_kt;
  // key tile j lives in stage j % kStages; its barriers' phase parity
  auto stage = [](int j) { return j % kStages; };
  auto parity = [](int j) { return static_cast<uint32_t>(j / kStages) & 1u; };
  auto k_tile = [&](int j) { return base + L::kK + stage(j) * L::kTile; };
  auto v_tile = [&](int j) { return base + L::kV + stage(j) * L::kTile; };
  auto full_k = [&](int j) { return base + L::kFullK + 8 * stage(j); };
  auto full_v = [&](int j) { return base + L::kFullV + 8 * stage(j); };
  auto empty_k = [&](int j) { return base + L::kEmptyK + 8 * stage(j); };
  auto empty_v = [&](int j) { return base + L::kEmptyV + 8 * stage(j); };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 2);             // one arrival per consumer
      mbar_init(empty_v(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kTile);
      for (int b = 0; b < kBoxes; ++b) {
        tma_load(base + L::kQ + b * kBoxBytes, &qmap, bar_q, 64 * b,
                 qt * kRows, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(empty_k(j), parity(j) ^ 1);
        mbar_expect_tx(full_k(j), L::kTile);
        for (int b = 0; b < kBoxes; ++b) {
          tma_load(k_tile(j) + b * kBoxBytes, &kmap, full_k(j), 64 * b,
                   j * kRows, bh);
        }
        mbar_wait(empty_v(j), parity(j) ^ 1);
        mbar_expect_tx(full_v(j), L::kTile);
        for (int b = 0; b < kBoxes; ++b) {
          tma_load(v_tile(j) + b * kBoxBytes, &vmap, full_v(j), 64 * b,
                   j * kRows, bh);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // this thread's rows and first column of each 8-column block of the
    // accumulator fragment (wgmma's m64nN f32 layout)
    const int row0 = qt * kRows + 64 * c + 16 * (t / 32) + lane / 4;
    const int row1 = row0 + 8;
    const int col = 2 * (lane % 4);
    const uint32_t q_rows = base + L::kQ + c * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    uint32_t hi[32], lo[32];
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      float sc[64];
      mbar_wait(full_k(j), parity(j));
      wgmma_fence();
      issue_qk<D>(sc, q_rows, k_tile(j));
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);
      if (t == 0) mbar_arrive(empty_k(j));
      const float2 alpha =
          softmax_tile(sc, m0, m1, l0, l1, j + 1 == n_tiles, j * kRows + col,
                       row0, row1, Sk, causal, scale_log2);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= alpha.x;
        acc[4 * n + 1] *= alpha.x;
        acc[4 * n + 2] *= alpha.y;
        acc[4 * n + 3] *= alpha.y;
      }
      split_p(sc, hi, lo);
      mbar_wait(full_v(j), parity(j));
      wgmma_fence();
      issue_pv<D>(acc, hi, lo, v_tile(j));
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(hi);
      keep(lo);
      if (t == 0) mbar_arrive(empty_v(j));
    }

    l0 += __shfl_xor_sync(kFull, l0, 1);
    l0 += __shfl_xor_sync(kFull, l0, 2);
    l1 += __shfl_xor_sync(kFull, l1, 1);
    l1 += __shfl_xor_sync(kFull, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* out0 = o + (static_cast<int64_t>(bh) * Sq + row0) * D + col;
    __nv_bfloat16* out1 = out0 + 8 * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (row0 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n] / d0, acc[4 * n + 1] / d0);
      }
      if (row1 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime.
cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorNotSupported;
    }
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// (BH, S, D) bf16, contiguous: boxes of 64 columns x 128 rows of one head,
// 128-byte swizzle, zeros past S.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, long long BH,
            int S, int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long BH, int Sq, int Sk, float scale, int causal,
                   cudaStream_t stream) {
  const long long n_cta = (Sq + kRows - 1) / kRows * BH;
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || n_cta > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  EncodeTiled fn;
  cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  if (!encode(fn, &qm, q, BH, Sq, D) || !encode(fn, &km, k, BH, Sk, D) ||
      !encode(fn, &vm, v, BH, Sk, D)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_attention_sm90_kernel<D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_cta), kThreads, Smem<D>::kBytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<int>(BH), Sq,
      Sk, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace sm90

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and out alike).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        long long BH, int Sq, int Sk, int D, float scale,
                        int causal, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_d<float>(q, k, v, o, BH, Sq, Sk, D, scale, causal, s);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, D, scale, causal,
                                  s);
  } else if (dtype == 2) {
    err = launch_d<__half>(q, k, v, o, BH, Sq, Sk, D, scale, causal, s);
  }
  return static_cast<int>(err);
}

// bfloat16 q, k, v and out, D = 64 or 128; q, k and v 16-byte aligned.
int flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                             void* o, long long BH, int Sq, int Sk, int D,
                             float scale, int causal, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 128) {
    err = sm90::launch<128>(q, k, v, o, BH, Sq, Sk, scale, causal, s);
  } else if (D == 64) {
    err = sm90::launch<64>(q, k, v, o, BH, Sq, Sk, scale, causal, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
