// Hopper (sm_90a) kernels for softmax attention (flash attention), forward
// and backward: the LM substrate's attention with the scores kept out of
// device memory.
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/flash_attention/ops.py; each returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses)
// so the wrapper can raise on a refused launch.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention
// (src/repro/kernels/flash_attention/kernel.py:82, body _flash_kernel :31).
// Both kernels compute the same function: scores q.k * 1/sqrt(D) in
// float32, masked scores -1e30 (not -inf), causal masking k_pos <= q_pos +
// q_offset (top-left aligned at q_offset 0, also when Sq != Sk; a q_offset
// >= 0 is where the query rows start in the key sequence, as on a rank of
// a sequence split), an online softmax with running (m, l, acc)
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
//   causal and k_pos < Sk masks applied only on the tiles the diagonal
//   crosses (the last, and the one before where q_offset is not a
//   multiple of 128) and the ragged one (TMA's zeros past Sk are scores
//   of 0, not masked scores, so they are masked there too). l sums the
//   unrounded float32 p.
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

// Backward (no TPU kernel: the reference trains through its pure-JAX
// blockwise attention, which XLA differentiates, while the port's forward
// runs on the kernels above, so its gradient comes from kernels too).
// Given q, k, v and dO, it returns dQ, dK, dV in q's type: P = exp(S -
// lse), dV = P^T dO, dP = dO V^T, dS = P * (dP - delta) with delta =
// rowsum(dO * O) = rowsum(P * dP), dQ = dS K / sqrt(D), dK = dS^T Q /
// sqrt(D), every sum in float32; causal or not, masked as the forward
// (at its q_offset), Sq != Sk. O is the unrounded output (the forward saves neither
// it nor lse, so the first pass recomputes them): delta from the forward's
// bf16-rounded output moves 0.1-0.2 % of the gradient's elements past the
// bf16 checks (atol 1e-3) against the reference's autodiff, which
// differentiates the unrounded softmax. Three launches, no atomics, so two
// calls give bit-identical gradients.
// Bound on an H100 SXM: operations, 5 * Sq * Sk * D * BH FLOP for causal
// attention (twice that without the mask): 429.5 GFLOP at qwen3-14b's
// train_4k (40 heads, S = 4,096, D = 128), 0.434 ms at 989 TFLOP/s bf16.
//
// Which shapes take which backward (ops.py::takes_tensor_cores, the
// forward's rule): bfloat16 at D = 64 or 128 the tensor-core passes
// flash_attention_bwd_{rows,dkdv,dq}_sm90; float32 (its 1e-4 checks are
// beyond TF32), float16 and bfloat16 at any other D <= 256 the CUDA-core
// passes flash_attention_bwd_{rows,dkdv,dq} (ops._backward(...,
// cuda_cores=True) forces them on bf16 too, to test and time them).
//
// Design: the tensor-core backward (bf16 wgmma fed by TMA, as the forward:
// 3-D tensor maps, boxes of 64 columns x 64 rows, 128-byte swizzle, rings
// of stages on "full" and "empty" mbarriers, a wait of 60 s traps). It
// does 14 products of the bound's 5 (S and dP twice more, P and dS as
// several bf16 terms): 2.8x the bound's work, 1.22 ms at the bf16 rate.
// - rows_sm90: a CTA per (head, 128 query rows), a producer warpgroup and
//   two consumer warpgroups of 64 rows; K and V tiles of 128 rows stream.
//   S = Q.K^T and dP = dO.V^T by wgmma, online (m, l, t = sum 2^(x - m)
//   dP) in float32; it writes lse2 = m + log2(l) (the log2 domain of x = s
//   * scale * log2(e), so that passes 2 and 3 form P = 2^(x - lse2) by one
//   fma: converting a natural-log lse back cost a rounding that flipped
//   gradients) and delta = t / l, rowsum(P * dP) of the unrounded P, which
//   is what the plain backward computes. Two products a tile.
// - dkdv_sm90: a CTA per (head, 128 key rows), each warpgroup 64 key rows
//   with their dK and dV in registers (128 a thread at D = 128); K and V
//   stay in shared memory, query tiles of 64 rows stream from the diagonal
//   on with their lse2 and delta. S^T = K.Q^T and dP^T = V.dO^T with the
//   key rows as M, so P^T and dS^T come out in the accumulator layout that
//   is the A fragment of the next products: dV += P^T.dO, dK += dS^T.Q, B
//   MN-major. Registers are the hard part: ptxas compiles every thread of
//   a 384-thread CTA against its 168-register entry budget (setmaxnreg
//   raises a warpgroup's registers at run time, not the budget its code
//   was compiled for), and there this pass spilled (ptxas -v, as
//   tools/flash_attention_probe.py prints it). So it runs as 256 threads
//   without a producer warpgroup: thread 0 issues each tile's loads two
//   tiles ahead once both warpgroups have released the stage, and the
//   consumers get up to 255 registers.
//   dV is issued and waited for before dS is split, so the terms of P and
//   dS are never live together.
// - dq_sm90: a CTA per (head, 128 query rows), producer and two consumer
//   warpgroups; Q, dO resident, each row's lse2 and delta in registers,
//   K and V tiles of 64 rows stream up to the diagonal: S, dP, dS, dQ +=
//   dS.K with K MN-major.
// - Precision: P (in dV) and dS (in dK, dQ) enter the products as sums of
//   bf16 terms (hi = bf16(x), then the bf16 of each remainder), as the
//   forward splits P. One term misses the card's bf16 checks on every
//   causal card-test shape; two pass them, but a flipped rounding of one
//   head's dV or dK shows in GQA's sum of two heads, so those take three
//   (x to about 2^-27); dQ takes two (tools/flash_attention_probe.py has
//   the study).
// - Masks on the diagonal and ragged tiles only (TMA's zeros past Sq or
//   Sk are scores of 0, not masked scores); a query row past Sq gives
//   P = dS = 0 whatever its lse2; a warpgroup skips a tile wholly masked
//   for it but still waits for it and releases it. lse2 and delta are
//   (BH, Sq_pad) scratch, Sq rounded up to 128, so each 64-row slice is
//   one bulk copy; rows past Sq hold 0.
//
// Design: the CUDA-core backward, a simple first kernel in float32 on the
// CUDA cores (67 TFLOP/s), in three passes:
// - rows: the CUDA-core forward kernel's STATS instance recomputes each
//   query row's float32 O and log-sum-exp and writes lse and delta =
//   rowsum(dO * O) in place of the output.
// - dkdv: a block per (head, 64 key rows), K and V resident in shared
//   memory as float32, query tiles of 32 rows streamed from the diagonal
//   on; four threads a key row share its P and dS through shared memory
//   and keep D/4 of its dK and dV columns in registers.
// - dq: a block per (head, 64 query rows), Q and dO resident, key tiles of
//   32 rows up to the diagonal; dQ a row in registers the same way.
// Shared memory at D = 256: 214,528 bytes (dkdv), under the 232,448 a
// block may use.

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

// With STATS, the backward's first pass: instead of the output it writes
// each query row's log-sum-exp (m + log l) and delta = rowsum(dO * O) of
// the unrounded float32 O (o is not written; dO, lse, delta are read and
// written only then).
template <typename T, int DMAX, bool STATS = false>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int D, float scale, int causal, int q_offset,
                       const T* __restrict__ dO, float* __restrict__ lse,
                       float* __restrict__ delta) {
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
    const int last = (q0 + q_offset + kBQ - 1) / kBK + 1;
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
      const bool ok = kp < Sk && (!causal || qpos + q_offset >= kp);
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

  const float denom = fmaxf(l, 1e-30f);
  if constexpr (STATS) {
    float dd = 0.f;
    if (qpos < Sq) {
      const T* drow = dO + (bh * Sq + qpos) * static_cast<int64_t>(D);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = t + 4 * j;
        if (c < D) dd += to_f32(drow[c]) * (acc[j] / denom);
      }
    }
    dd += __shfl_xor_sync(kFull, dd, 1);
    dd += __shfl_xor_sync(kFull, dd, 2);
    if (qpos < Sq && t == 0) {
      lse[bh * Sq + qpos] = m + logf(l);
      delta[bh * Sq + qpos] = dd;
    }
    return;
  }
  if (qpos >= Sq) return;
  T* orow = o + (bh * Sq + qpos) * static_cast<int64_t>(D);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = t + 4 * j;
    if (c < D) store(orow + c, acc[j] / denom);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long BH, int Sq, int Sk, int D, float scale,
                   int causal, int q_offset, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, D, scale, causal,
      q_offset, nullptr, nullptr, nullptr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     long long BH, int Sq, int Sk, int D, float scale,
                     int causal, int q_offset, cudaStream_t stream) {
  if (D <= 64) return launch<T, 64>(q, k, v, o, BH, Sq, Sk, D, scale, causal,
                                    q_offset, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, o, BH, Sq, Sk, D, scale,
                                      causal, q_offset, stream);
  if (D <= 256) return launch<T, 256>(q, k, v, o, BH, Sq, Sk, D, scale,
                                      causal, q_offset, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// ===========================================================================
// flash_attention_bwd_{rows,dkdv,dq}: the backward (CUDA cores, float32)
// ===========================================================================
namespace bwd {

constexpr int kRows = 64;       // rows a block owns (query or key rows)
constexpr int kTile = 32;       // rows a streamed tile
constexpr int kThreads = 256;   // four threads a row
constexpr int kPS = kTile + 1;  // row stride of the P and dS tiles

// Loads rows [r0, r0 + n) of a (S, D) slice into shared memory as float32,
// row stride D + 1, zeros past S.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n, int S, int D) {
  const int DP = D + 1;
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int rr = i / D, c = i - rr * D;
    const int p = r0 + rr;
    dst[rr * DP + c] = p < S ? to_f32(src[static_cast<int64_t>(p) * D + c])
                             : 0.f;
  }
}

// Whether query qpos sees key kpos.
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int q_offset) {
  return qpos < Sq && kpos < Sk && (!causal || qpos + q_offset >= kpos);
}

// Key tiles a query tile reads whose rows' causal positions (row +
// q_offset) are [q0, q0 + kRows): those below its last row's diagonal when
// causal.
__device__ __forceinline__ int key_tiles(int q0, int Sk, int causal) {
  const int n = (Sk + kTile - 1) / kTile;
  const int last = (q0 + kRows - 1) / kTile + 1;
  return causal && last < n ? last : n;
}

// Pass 2: dK and dV. A block per (head, 64 key rows), K and V resident in
// shared memory, query tiles of 32 rows streamed from the first one that
// reaches the block's keys (causal) to the end. Four threads a key row:
// each computes the scores and dP = dO.V of 8 of the tile's queries
// (P = exp(S - lse), dS = P * (dP - delta)), the row's quad shares P and dS
// through shared memory, and each thread keeps D/4 of the row's dK and dV
// columns (c = t + 4j) in registers.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int D,
            float scale, int causal, int q_offset) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* sK = smem;                       // kRows x DP
  float* sV = sK + kRows * DP;            // kRows x DP
  float* sQ = sV + kRows * DP;            // kTile x DP
  float* sO = sQ + kTile * DP;            // kTile x DP (dO)
  float* sP = sO + kTile * DP;            // kRows x kPS
  float* sS = sP + kRows * kPS;           // kRows x kPS (dS)
  float* sL = sS + kRows * kPS;           // kTile (lse)
  float* sD = sL + kTile;                 // kTile (delta)
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int r = threadIdx.x >> 2, t = threadIdx.x & 3;
  const int kpos = k0 + r;
  const int64_t kvo = bh * Sk * static_cast<int64_t>(D);
  const int64_t qo = bh * Sq * static_cast<int64_t>(D);
  load_rows(sK, k + kvo, k0, kRows, Sk, D);
  load_rows(sV, v + kvo, k0, kRows, Sk, D);
  constexpr int NJ = DMAX / 4;
  float gk[NJ], gv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) gk[j] = gv[j] = 0.f;
  const int n_tiles = (Sq + kTile - 1) / kTile;
  // the first query tile with a row that sees key k0 (row + q_offset >= k0)
  const int qt0 = causal ? max(k0 - q_offset, 0) / kTile : 0;
  for (int qt = qt0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();                      // the last tile's readers are done
    load_rows(sQ, q + qo, q0, kTile, Sq, D);
    load_rows(sO, dO + qo, q0, kTile, Sq, D);
    if (threadIdx.x < kTile) {
      const int p = q0 + threadIdx.x;
      sL[threadIdx.x] = p < Sq ? lse[bh * Sq + p] : 0.f;
      sD[threadIdx.x] = p < Sq ? delta[bh * Sq + p] : 0.f;
    }
    __syncthreads();
    float s[kTile / 4], dp[kTile / 4];
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[r * DP + d], vd = sV[r * DP + d];
#pragma unroll
      for (int j = 0; j < kTile / 4; ++j) {
        s[j] += sQ[(t + 4 * j) * DP + d] * kd;
        dp[j] += sO[(t + 4 * j) * DP + d] * vd;
      }
    }
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) {
      const int jq = t + 4 * j;
      const float p = visible(q0 + jq, kpos, Sq, Sk, causal, q_offset)
                          ? expf(s[j] * scale - sL[jq]) : 0.f;
      sP[r * kPS + jq] = p;
      sS[r * kPS + jq] = p * (dp[j] - sD[jq]);
    }
    __syncwarp();                         // the row's quad is one warp's
    for (int jq = 0; jq < kTile; ++jq) {
      const float p = sP[r * kPS + jq], ds = sS[r * kPS + jq];
      const float* qr = sQ + jq * DP;
      const float* orow = sO + jq * DP;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = t + 4 * j;
        if (c < D) {
          gv[j] += p * orow[c];
          gk[j] += ds * qr[c];
        }
      }
    }
  }
  if (kpos >= Sk) return;
  const int64_t row = kvo + static_cast<int64_t>(kpos) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = t + 4 * j;
    if (c < D) {
      store(dk + row + c, gk[j] * scale);
      store(dv + row + c, gv[j]);
    }
  }
}

// Pass 3: dQ. A block per (head, 64 query rows), Q and dO resident, key
// tiles of 32 rows streamed up to the block's diagonal (causal); four
// threads a query row, as pass 2 with the roles of queries and keys
// swapped: dQ = scale * sum_k dS K.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Sq, int Sk, int D, float scale,
          int causal, int q_offset) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* sQ = smem;                       // kRows x DP
  float* sO = sQ + kRows * DP;            // kRows x DP (dO)
  float* sK = sO + kRows * DP;            // kTile x DP
  float* sV = sK + kTile * DP;            // kTile x DP
  float* sS = sV + kTile * DP;            // kRows x kPS (dS)
  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int r = threadIdx.x >> 2, t = threadIdx.x & 3;
  const int qpos = q0 + r;
  const int64_t qo = bh * Sq * static_cast<int64_t>(D);
  const int64_t kvo = bh * Sk * static_cast<int64_t>(D);
  load_rows(sQ, q + qo, q0, kRows, Sq, D);
  load_rows(sO, dO + qo, q0, kRows, Sq, D);
  const float L = qpos < Sq ? lse[bh * Sq + qpos] : 0.f;
  const float Dl = qpos < Sq ? delta[bh * Sq + qpos] : 0.f;
  constexpr int NJ = DMAX / 4;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  const int n_tiles = key_tiles(q0 + q_offset, Sk, causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                      // the last tile's readers are done
    load_rows(sK, k + kvo, k0, kTile, Sk, D);
    load_rows(sV, v + kvo, k0, kTile, Sk, D);
    __syncthreads();
    float s[kTile / 4], dp[kTile / 4];
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * DP + d], od = sO[r * DP + d];
#pragma unroll
      for (int j = 0; j < kTile / 4; ++j) {
        s[j] += qd * sK[(t + 4 * j) * DP + d];
        dp[j] += od * sV[(t + 4 * j) * DP + d];
      }
    }
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) {
      const int kj = t + 4 * j;
      const float p = visible(qpos, k0 + kj, Sq, Sk, causal, q_offset)
                          ? expf(s[j] * scale - L) : 0.f;
      sS[r * kPS + kj] = p * (dp[j] - Dl);
    }
    __syncwarp();                         // the row's quad is one warp's
    for (int kk = 0; kk < kTile; ++kk) {
      const float ds = sS[r * kPS + kk];
      const float* kr = sK + kk * DP;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = t + 4 * j;
        if (c < D) acc[j] += ds * kr[c];
      }
    }
  }
  if (qpos >= Sq) return;
  const int64_t row = qo + static_cast<int64_t>(qpos) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = t + 4 * j;
    if (c < D) store(dq + row + c, acc[j] * scale);
  }
}

size_t dkdv_smem(int D) {
  return sizeof(float) * ((2 * kRows + 2 * kTile) * (D + 1) + 2 * kRows * kPS
                          + 2 * kTile);
}
size_t dq_smem(int D) {
  return sizeof(float) * ((2 * kRows + 2 * kTile) * (D + 1) + kRows * kPS);
}

template <typename T> struct Tag { using type = T; };
template <int N> struct Width { static constexpr int value = N; };

// Calls f(Tag<T>, Width<DMAX>) for the dtype code (0 float32, 1 bfloat16,
// 2 float16) and the accumulator width that holds D (64, 128 or 256).
template <typename F>
cudaError_t dispatch(int dtype, int D, F&& f) {
  if (D <= 0 || D > 256) return cudaErrorInvalidValue;
  auto by_width = [&](auto tag) -> cudaError_t {
    if (D <= 64) return f(tag, Width<64>{});
    if (D <= 128) return f(tag, Width<128>{});
    return f(tag, Width<256>{});
  };
  if (dtype == 0) return by_width(Tag<float>{});
  if (dtype == 1) return by_width(Tag<__nv_bfloat16>{});
  if (dtype == 2) return by_width(Tag<__half>{});
  return cudaErrorInvalidValue;
}

// A grid of (BH, blocks of kRows over S), refused where CUDA cannot launch
// it.
bool grid(long long BH, int S, dim3* g) {
  const long long y = (S + kRows - 1) / kRows;
  if (BH <= 0 || S <= 0 || BH > 0x7fffffffLL || y > 65535) return false;
  *g = dim3(static_cast<unsigned>(BH), static_cast<unsigned>(y));
  return true;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace bwd

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
// into the log2 domain, the masks on an edge tile only (the ragged tile or
// one the diagonal crosses; every other tile is whole and below the
// diagonal), the new row max across the quad, p = exp2(x - m), and l over
// this thread's columns (summed across the quad at the end). row0 and row1
// are the causal positions of this thread's rows. Returns the factors that
// rescale the rows' earlier sums.
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
                            int Sk, float scale_log2, int causal,
                            int q_offset) {
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
  // up to the tile of the last row's last key, qt * kRows + kRows - 1 +
  // q_offset, when causal
  const int n_tiles =
      causal ? min(n_kt, (qt * kRows + kRows - 1 + q_offset) / kRows + 1)
             : n_kt;
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
      // masks on the last tile and, when causal, on any tile past the
      // first row's diagonal (two tiles where q_offset is not a multiple
      // of kRows); the rows' causal positions are row + q_offset
      const bool edge =
          j + 1 == n_tiles ||
          (causal && (j + 1) * kRows - 1 > qt * kRows + q_offset);
      const float2 alpha =
          softmax_tile(sc, m0, m1, l0, l1, edge, j * kRows + col,
                       row0 + q_offset, row1 + q_offset, Sk, causal,
                       scale_log2);
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

// (BH, S, D) bf16, contiguous: boxes of 64 columns x `box_rows` rows of one
// head (128 for the forward), 128-byte swizzle, zeros past S.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, long long BH,
            int S, int D, int box_rows = kRows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long BH, int Sq, int Sk, float scale, int causal,
                   int q_offset, cudaStream_t stream) {
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
      Sk, scale * kLog2e, causal, q_offset);
  return cudaGetLastError();
}

}  // namespace sm90

// ===========================================================================
// flash_attention_bwd_{rows,dkdv,dq}_sm90: the backward on the tensor cores
// (bf16 wgmma fed by TMA)
// ===========================================================================
namespace bwd90 {

constexpr int kThreads = 384;             // producer + two consumer warpgroups
constexpr int kDkdvThreads = 256;         // two warpgroups, no producer
constexpr int kBox = 64 * 128;            // one TMA box: 64 rows x 64 bf16
constexpr int kStages = 2;                // rows pass: K/V tiles of 128 rows
constexpr int kRingStages = 3;            // dkdv, dq: tiles of 64 rows

// The (BH, Sq_pad) rows of lse and delta: Sq rounded up to a whole 128-row
// query tile, so every tile of the rows pass writes all its rows and every
// 64-row slice of them is a 256-byte bulk copy at a 256-byte boundary.
__host__ __device__ __forceinline__ int padded_rows(int Sq) {
  return (Sq + 127) / 128 * 128;
}

// A tile of R rows x D columns (R * D * 2 bytes) into shared memory: D / 64
// column groups of R rows x 128 bytes (128-byte swizzle), each loaded as
// R / 64 boxes.
template <int R, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int bh) {
#pragma unroll
  for (int g = 0; g < D / 64; ++g) {
#pragma unroll
    for (int b = 0; b < R / 64; ++b) {
      sm90::tma_load(dst + g * R * 128 + b * kBox, map, bar, 64 * g,
                     r0 + 64 * b, bh);
    }
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory by one bulk copy, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Descriptor of k-step kk (columns 16kk..16kk+15) of 64 or N rows from row
// `row` (a multiple of 8) of an R-row tile, K-major: 32 bytes a step into
// the 128-byte rows of a column group, 1024 bytes from one 8-row group to
// the next.
template <int R>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int row, int kk) {
  return sm90::smem_desc(tile + (kk / 4) * R * 128 + row * 128 + (kk % 4) * 32,
                         16, 1024);
}

// Descriptor of k-step kk (rows 16kk..16kk+15) of an R-row tile read as a
// K x D operand, MN-major (the transpose bit of 16-bit types): 1024 bytes
// per 8 rows, R * 128 bytes from one 64-column group to the next.
template <int R>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return sm90::smem_desc(tile + kk * 2048, R * 128, 1024);
}

#define F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define W4(a, i) "=f"(a[i]), "=f"(a[i + 1]), "=f"(a[i + 2]), "=f"(a[i + 3])
#define SS_N64                                                              \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"

// S[64 x 64] = A[64 x 16] . B[16 x 64], both K-major in shared memory; the
// first step writes S without reading it ...
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da,
                                                   uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" SS_N64
               : W4(d, 0), W4(d, 4), W4(d, 8), W4(d, 12), W4(d, 16),
                 W4(d, 20), W4(d, 24), W4(d, 28)
               : "l"(da), "l"(db), "r"(0));
}

// ... and every later one adds to it.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" SS_N64
               : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16),
                 F4(d, 20), F4(d, 24), F4(d, 28)
               : "l"(da), "l"(db), "r"(1));
}

#undef F4
#undef W4
#undef SS_N64

// acc[64 x N] = A . B^T over D: A the 64 rows from `a_row` of an RA-row
// tile, B the N rows of an RB-row tile, both (rows, D) K-major.
template <int N, int D, int RA, int RB>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a,
                                         int a_row, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = k_major<RA>(a, a_row, kk);
    const uint64_t db = k_major<RB>(b, 0, kk);
    if constexpr (N == 128) {
      if (kk == 0) {
        sm90::wgmma_ss_n128_first(acc, da, db);
      } else {
        sm90::wgmma_ss_n128(acc, da, db);
      }
    } else {
      if (kk == 0) {
        wgmma_ss_n64_first(acc, da, db);
      } else {
        wgmma_ss_n64(acc, da, db);
      }
    }
  }
}

// A 64 x 64 operand x as N bf16 terms in registers (A fragments): term 0
// is bf16(x), each next one the bf16 of what the earlier ones leave (each
// difference exact in float32), so N terms hold x to about 2^(-9N).
template <int N>
struct Terms {
  uint32_t r[N][16];
};

// x (a 64 x 64 accumulator fragment) as N terms in the A-fragment order:
// register i holds elements 2i and 2i + 1.
template <int N>
__device__ __forceinline__ void split(const float (&x)[32], Terms<N>& out) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float a = x[2 * i], b = x[2 * i + 1];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      out.r[n][i] = sm90::bits(h);
      const float2 hf = __bfloat1622float2(h);
      a -= hf.x;
      b -= hf.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void keep(Terms<N>& a) {
#pragma unroll
  for (int n = 0; n < N; ++n) sm90::keep(a.r[n]);
}

// acc[64 x D] += (sum of the N terms)[64 x 64] . B[64 x D]: the terms from
// registers, smallest first, B the 64 rows of a 64-row tile, MN-major.
template <int D, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const Terms<N>& a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = mn_major<64>(b, kk);
#pragma unroll
    for (int n = N - 1; n >= 0; --n) {
      if constexpr (D == 128) {
        sm90::wgmma_rs_n128(acc, a.r[n] + 4 * kk, db);
      } else {
        sm90::wgmma_rs_n64(acc, a.r[n] + 4 * kk, db);
      }
    }
  }
}

// Terms of P (in dV) and dS (in dK, dQ). One term misses the bf16 checks
// against the plain backward on every causal card-test shape; two pass
// them, but in dV and dK a flipped rounding of one head's gradient shows
// in GQA's sum of two heads (tests/test_torch_cuda_kernels.py::
// test_cuda_mha_backward_reaches_q_k_v), so dV and dK take three; dQ,
// summed over no heads, two (tools/flash_attention_probe.py's study).
constexpr int kTermsDkdv = 3;
constexpr int kTermsDq = 2;

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(sm90::kFull, x, 1);
  return x + __shfl_xor_sync(sm90::kFull, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(sm90::kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(sm90::kFull, x, 2));
}

__device__ __forceinline__ uint32_t aligned_base(uint8_t* smem_raw) {
  return (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
         ~1023u;
}

// Pass 1 shared memory: Q and dO tiles of 128 rows, then a ring of
// kStages (K, V) tiles of 128 rows, then the mbarriers: Q's (Q and dO), a
// "full" (TMA bytes) and an "empty" (one arrival a consumer warpgroup) one
// a stage.
template <int D>
struct RowsSmem {
  static constexpr int kTile = 128 * D * 2;            // 128 rows
  static constexpr int kQ = 0;
  static constexpr int kO = kTile;
  static constexpr int kK = 2 * kTile;                  // + stage * 2 kTile
  static constexpr int kBarQ = kK + kStages * 2 * kTile;
  static constexpr int kFull = kBarQ + 8;               // + stage * 8
  static constexpr int kEmpty = kFull + 8 * kStages;
  static constexpr int kBytes = kEmpty + 8 * kStages + 1024;  // + align
};

// Pass 1: each query row's lse2 = m + log2(l) (the log-sum-exp in the log2
// domain of x = s * scale * log2(e), so that passes 2 and 3 form P =
// 2^(x - lse2) by one fma and need no conversion, a rounding that moved
// gradients past the bf16 checks) and delta = rowsum(P * dP) of the
// unrounded float32 P, online over key tiles of 128: S = Q.K^T and dP =
// dO.V^T by wgmma, then (m, l, t = sum 2^(x - m) dP) in float32. A CTA per
// (head, 128-row query tile), heaviest causal tiles first; rows past Sq
// (up to Sq_pad) get lse2 = delta = 0.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
rows_kernel(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap omap,
            float* __restrict__ lse, float* __restrict__ delta, int BH,
            int Sq, int Sk, float scale_log2, int causal, int q_offset) {
  using L = RowsSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t bar_q = base + L::kBarQ;
  const int n_qt = (Sq + 127) / 128;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int n_kt = (Sk + 127) / 128;
  const int n_tiles =
      causal ? min(n_kt, (qt * 128 + 127 + q_offset) / 128 + 1) : n_kt;
  auto stage = [](int j) { return j % kStages; };
  auto parity = [](int j) { return static_cast<uint32_t>(j / kStages) & 1u; };
  auto k_tile = [&](int j) { return base + L::kK + stage(j) * 2 * L::kTile; };
  auto v_tile = [&](int j) { return k_tile(j) + L::kTile; };
  auto full = [&](int j) { return base + L::kFull + 8 * stage(j); };
  auto empty = [&](int j) { return base + L::kEmpty + 8 * stage(j); };

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role from a value ptxas can prove warp-uniform (a
  // shuffle from lane 0), as CUTLASS derives it
  const int wg = __shfl_sync(sm90::kFull, static_cast<int>(threadIdx.x / 128),
                             0);
  if (wg == 0) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(bar_q, 2 * L::kTile);
      load_tile<128, D>(base + L::kQ, &qmap, bar_q, qt * 128, bh);
      load_tile<128, D>(base + L::kO, &omap, bar_q, qt * 128, bh);
      for (int j = 0; j < n_tiles; ++j) {
        sm90::mbar_wait(empty(j), parity(j) ^ 1);
        sm90::mbar_expect_tx(full(j), 2 * L::kTile);
        load_tile<128, D>(k_tile(j), &kmap, full(j), j * 128, bh);
        load_tile<128, D>(v_tile(j), &vmap, full(j), j * 128, bh);
      }
    }
    return;
  }
  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row0 = qt * 128 + 64 * c + 16 * (t / 32) + lane / 4;
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  float m0 = sm90::kNegInf, m1 = sm90::kNegInf;
  float l0 = 0.f, l1 = 0.f, t0 = 0.f, t1 = 0.f;
  sm90::mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    float s[64], dp[64];
    sm90::mbar_wait(full(j), parity(j));
    sm90::wgmma_fence();
    issue_ss<128, D, 128, 128>(s, base + L::kQ, 64 * c, k_tile(j));
    issue_ss<128, D, 128, 128>(dp, base + L::kO, 64 * c, v_tile(j));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::keep(s);
    sm90::keep(dp);
    if (t == 0) sm90::mbar_arrive(empty(j));
    // the masks on the last tile (the ragged one: TMA's zeros past Sk are
    // scores of 0, not masked scores) and on those the diagonal crosses
    const bool edge =
        j + 1 == n_tiles || (causal && j * 128 + 127 > qt * 128 + q_offset);
    float mx0 = sm90::kNegInf, mx1 = sm90::kNegInf;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * scale_log2;
        if (edge) {
          const int key = j * 128 + 8 * n + col + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (key >= Sk || (causal && key > row + q_offset)) {
            x = sm90::kNegInf;
          }
        }
        s[4 * n + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = sm90::ex2(m0 - mn0), a1 = sm90::ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f, pt0 = 0.f, pt1 = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = sm90::ex2(s[4 * n + e] - mn0);
        const float p1 = sm90::ex2(s[4 * n + 2 + e] - mn1);
        ps0 += p0;
        ps1 += p1;
        pt0 += p0 * dp[4 * n + e];
        pt1 += p1 * dp[4 * n + 2 + e];
      }
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    t0 = t0 * a0 + pt0;
    t1 = t1 * a1 + pt1;
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  t0 = quad_sum(t0);
  t1 = quad_sum(t1);
  if (lane % 4 == 0) {
    const int64_t at = static_cast<int64_t>(bh) * padded_rows(Sq);
    lse[at + row0] = row0 < Sq ? m0 + log2f(l0) : 0.f;
    delta[at + row0] = row0 < Sq ? t0 / l0 : 0.f;
    lse[at + row1] = row1 < Sq ? m1 + log2f(l1) : 0.f;
    delta[at + row1] = row1 < Sq ? t1 / l1 : 0.f;
  }
}

// Pass 2 shared memory: K and V tiles of 128 rows, then a ring of
// kRingStages (Q, dO) tiles of 64 rows, then each stage's 64 lse and 64
// delta values (256 bytes each), then the mbarriers: K/V's, a "full" and
// an "empty" one a stage.
template <int D>
struct DkdvSmem {
  static constexpr int kTile = 64 * D * 2;             // 64 rows
  static constexpr int kK = 0;
  static constexpr int kV = 2 * kTile;
  static constexpr int kQ = 4 * kTile;                  // + stage * 2 kTile
  static constexpr int kL = kQ + kRingStages * 2 * kTile;  // + stage * 512
  static constexpr int kBarKV = kL + kRingStages * 512;
  static constexpr int kFull = kBarKV + 8;
  static constexpr int kEmpty = kFull + 8 * kRingStages;
  static constexpr int kBytes = kEmpty + 8 * kRingStages + 1024;
};

// Pass 2: dK and dV. A CTA per (head, 128-row key tile), key tile 0 (the
// most query tiles when causal) first; each consumer warpgroup owns 64
// key rows and keeps their dK and dV in registers. Query tiles of 64 rows
// stream from the diagonal on (causal) with their lse and delta: S^T =
// K.Q^T and dP^T = V.dO^T with the key rows as M, then P^T = 2^(x - lse2)
// and dS^T = P^T * (dP^T - delta) in the accumulator layout, split into
// kTermsDkdv bf16 terms in place as A fragments: dV += P^T.dO, dK +=
// dS^T.Q, B MN-major from shared memory.
template <int D>
__global__ void __launch_bounds__(kDkdvThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap omap,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int BH, int Sq, int Sk, float scale, float scale_log2,
            int causal, int q_offset) {
  using L = DkdvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint8_t* gbase =
      smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(
                             smem_raw)));
  const uint32_t bar_kv = base + L::kBarKV;
  const int kt = static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int n_qt = (Sq + 63) / 64;
  // the first query tile with a row that sees key kt * 128
  const int qt0 = causal ? max(kt * 128 - q_offset, 0) / 64 : 0;
  const int n_tiles = max(n_qt - qt0, 0);
  auto stage = [](int i) { return i % kRingStages; };
  auto parity = [](int i) {
    return static_cast<uint32_t>(i / kRingStages) & 1u;
  };
  auto q_tile = [&](int i) { return base + L::kQ + stage(i) * 2 * L::kTile; };
  auto o_tile = [&](int i) { return q_tile(i) + L::kTile; };
  auto l_row = [&](int i) { return L::kL + stage(i) * 512; };  // + 256: delta
  auto full = [&](int i) { return base + L::kFull + 8 * stage(i); };
  auto empty = [&](int i) { return base + L::kEmpty + 8 * stage(i); };

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int s = 0; s < kRingStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // no producer warpgroup: thread 0 issues every load, each query tile
  // kRingStages - 1 tiles ahead, once both warpgroups have released the
  // stage it refills (so that the consumers get all of the 255 registers a
  // thread of a 256-thread CTA may use)
  const int64_t rows = static_cast<int64_t>(bh) * padded_rows(Sq);
  auto produce = [&](int i) {
    const int q0 = (qt0 + i) * 64;
    sm90::mbar_wait(empty(i), parity(i) ^ 1);
    sm90::mbar_expect_tx(full(i), 2 * L::kTile + 512);
    load_tile<64, D>(q_tile(i), &qmap, full(i), q0, bh);
    load_tile<64, D>(o_tile(i), &omap, full(i), q0, bh);
    bulk_load(base + l_row(i), lse + rows + q0, 256, full(i));
    bulk_load(base + l_row(i) + 256, delta + rows + q0, 256, full(i));
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    sm90::mbar_expect_tx(bar_kv, 4 * L::kTile);
    load_tile<128, D>(base + L::kK, &kmap, bar_kv, kt * 128, bh);
    load_tile<128, D>(base + L::kV, &vmap, bar_kv, kt * 128, bh);
    for (int i = 0; i < min(kRingStages - 1, n_tiles); ++i) produce(i);
  }
  // the warpgroup's index from a value ptxas can prove warp-uniform (a
  // shuffle from lane 0)
  const int c = __shfl_sync(sm90::kFull, static_cast<int>(threadIdx.x / 128),
                            0);
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int k_wg = kt * 128 + 64 * c;                 // this warpgroup's keys
  const int key0 = k_wg + 16 * (t / 32) + lane / 4;
  const int key1 = key0 + 8;
  const int col = 2 * (lane % 4);
  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;
  if (n_tiles > 0) sm90::mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = (qt0 + i) * 64;
    if (threadIdx.x == 0 && i + kRingStages - 1 < n_tiles) {
      produce(i + kRingStages - 1);       // its stage held tile i - 1
    }
    sm90::mbar_wait(full(i), parity(i));
    if (causal && q0 + q_offset + 64 <= k_wg) {  // every query before every key
      if (t == 0) sm90::mbar_arrive(empty(i));
      continue;
    }
    float s[32], dp[32];
    sm90::wgmma_fence();
    issue_ss<64, D, 128, 64>(s, base + L::kK, 64 * c, q_tile(i));
    issue_ss<64, D, 128, 64>(dp, base + L::kV, 64 * c, o_tile(i));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::keep(s);
    sm90::keep(dp);
    const float* lr = reinterpret_cast<const float*>(gbase + l_row(i));
    const float* dr = lr + 64;
    // masks on the diagonal tile and the ragged one (queries past Sq)
    const bool edge = (causal && q0 + q_offset < k_wg + 64) || q0 + 64 > Sq;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lr + 8 * n + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dr + 8 * n + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x;
        const float dq_ = (e & 1) ? d2.y : d2.x;
        float p = sm90::ex2(fmaf(s[4 * n + e], scale_log2, -lq));
        float ds = p * (dp[4 * n + e] - dq_);
        if (edge) {
          const int q = q0 + 8 * n + col + (e & 1);
          const int key = e < 2 ? key0 : key1;
          if (q >= Sq || (causal && q + q_offset < key)) p = ds = 0.f;
        }
        s[4 * n + e] = p;
        dp[4 * n + e] = ds;
      }
    }
    // dV first, then dK: the P terms die before the dS terms are made
    // (both at once would hold 96 fragment registers beside dK and dV)
    Terms<kTermsDkdv> a;
    split(s, a);
    sm90::wgmma_fence();
    issue_rs<D>(gv, a, o_tile(i));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::keep(gv);
    keep(a);
    split(dp, a);
    sm90::wgmma_fence();
    issue_rs<D>(gk, a, q_tile(i));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::keep(gk);
    keep(a);
    if (t == 0) sm90::mbar_arrive(empty(i));
  }
  const int64_t at = static_cast<int64_t>(bh) * Sk;
  __nv_bfloat16* k0p = dk + (at + key0) * D + col;
  __nv_bfloat16* v0p = dv + (at + key0) * D + col;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (key0 < Sk) {
      *reinterpret_cast<__nv_bfloat162*>(k0p + 8 * n) =
          __floats2bfloat162_rn(gk[4 * n] * scale, gk[4 * n + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(v0p + 8 * n) =
          __floats2bfloat162_rn(gv[4 * n], gv[4 * n + 1]);
    }
    if (key1 < Sk) {
      *reinterpret_cast<__nv_bfloat162*>(k0p + 8 * D + 8 * n) =
          __floats2bfloat162_rn(gk[4 * n + 2] * scale, gk[4 * n + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(v0p + 8 * D + 8 * n) =
          __floats2bfloat162_rn(gv[4 * n + 2], gv[4 * n + 3]);
    }
  }
}

// Pass 3 shared memory: Q and dO tiles of 128 rows, then a ring of
// kRingStages (K, V) tiles of 64 rows, then the mbarriers.
template <int D>
struct DqSmem {
  static constexpr int kTile = 64 * D * 2;             // 64 rows
  static constexpr int kQ = 0;
  static constexpr int kO = 2 * kTile;
  static constexpr int kK = 4 * kTile;                  // + stage * 2 kTile
  static constexpr int kBarQ = kK + kRingStages * 2 * kTile;
  static constexpr int kFull = kBarQ + 8;
  static constexpr int kEmpty = kFull + 8 * kRingStages;
  static constexpr int kBytes = kEmpty + 8 * kRingStages + 1024;
};

// Pass 3: dQ. A CTA per (head, 128-row query tile), heaviest causal tiles
// first; each consumer warpgroup owns 64 query rows, their lse and delta
// in registers and dQ in the accumulator. Key tiles of 64 rows stream up
// to the diagonal: S = Q.K^T and dP = dO.V^T, dS = P * (dP - delta) split
// into kTermsDq bf16 terms in place, dQ += dS.K with K MN-major.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          const __grid_constant__ CUtensorMap omap,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int BH, int Sq, int Sk, float scale,
          float scale_log2, int causal, int q_offset) {
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t bar_q = base + L::kBarQ;
  const int n_qt = (Sq + 127) / 128;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int n_kt = (Sk + 63) / 64;
  const int n_tiles =
      causal ? min(n_kt, (qt * 128 + 127 + q_offset) / 64 + 1) : n_kt;
  auto stage = [](int j) { return j % kRingStages; };
  auto parity = [](int j) {
    return static_cast<uint32_t>(j / kRingStages) & 1u;
  };
  auto k_tile = [&](int j) { return base + L::kK + stage(j) * 2 * L::kTile; };
  auto v_tile = [&](int j) { return k_tile(j) + L::kTile; };
  auto full = [&](int j) { return base + L::kFull + 8 * stage(j); };
  auto empty = [&](int j) { return base + L::kEmpty + 8 * stage(j); };

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kRingStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role from a value ptxas can prove warp-uniform (a
  // shuffle from lane 0), as CUTLASS derives it
  const int wg = __shfl_sync(sm90::kFull, static_cast<int>(threadIdx.x / 128),
                             0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(bar_q, 4 * L::kTile);
      load_tile<128, D>(base + L::kQ, &qmap, bar_q, qt * 128, bh);
      load_tile<128, D>(base + L::kO, &omap, bar_q, qt * 128, bh);
      for (int j = 0; j < n_tiles; ++j) {
        sm90::mbar_wait(empty(j), parity(j) ^ 1);
        sm90::mbar_expect_tx(full(j), 2 * L::kTile);
        load_tile<64, D>(k_tile(j), &kmap, full(j), j * 64, bh);
        load_tile<64, D>(v_tile(j), &vmap, full(j), j * 64, bh);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int q_wg = qt * 128 + 64 * c;                 // this warpgroup's rows
  const int row0 = q_wg + 16 * (t / 32) + lane / 4;
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  // rows up to Sq_pad hold lse = delta = 0 past Sq, so every row reads
  const int64_t rows = static_cast<int64_t>(bh) * padded_rows(Sq);
  const float lse0 = lse[rows + row0];
  const float lse1 = lse[rows + row1];
  const float dl0 = delta[rows + row0], dl1 = delta[rows + row1];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  sm90::mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * 64;
    sm90::mbar_wait(full(j), parity(j));
    if (causal && k0 >= q_wg + q_offset + 64) {  // every key after every row
      if (t == 0) sm90::mbar_arrive(empty(j));
      continue;
    }
    float s[32], dp[32];
    sm90::wgmma_fence();
    issue_ss<64, D, 128, 64>(s, base + L::kQ, 64 * c, k_tile(j));
    issue_ss<64, D, 128, 64>(dp, base + L::kO, 64 * c, v_tile(j));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::keep(s);
    sm90::keep(dp);
    // masks on the diagonal tile and the ragged one (keys past Sk)
    const bool edge = (causal && k0 + 64 > q_wg + q_offset) || k0 + 64 > Sk;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool r1 = e >= 2;
        float p = sm90::ex2(fmaf(s[4 * n + e], scale_log2, -(r1 ? lse1 : lse0)));
        float ds = p * (dp[4 * n + e] - (r1 ? dl1 : dl0));
        if (edge) {
          const int key = k0 + 8 * n + col + (e & 1);
          if (key >= Sk || (causal && key > (r1 ? row1 : row0) + q_offset)) {
            ds = 0.f;
          }
        }
        dp[4 * n + e] = ds;
      }
    }
    Terms<kTermsDq> a;
    split(dp, a);
    sm90::wgmma_fence();
    issue_rs<D>(acc, a, k_tile(j));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::keep(acc);
    keep(a);
    if (t == 0) sm90::mbar_arrive(empty(j));
  }
  __nv_bfloat16* out0 = dq + (static_cast<int64_t>(bh) * Sq + row0) * D + col;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row0 < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n] * scale, acc[4 * n + 1] * scale);
    }
    if (row1 < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * D + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2] * scale,
                                acc[4 * n + 3] * scale);
    }
  }
}

// The four tensor maps of q, k, v and dO (boxes of 64 rows), or false.
bool encode_all(CUtensorMap (&maps)[4], const void* q, const void* k,
                const void* v, const void* dO, long long BH, int Sq, int Sk,
                int D, cudaError_t* err) {
  sm90::EncodeTiled fn;
  *err = sm90::encode_fn(&fn);
  if (*err != cudaSuccess) return false;
  if (!sm90::encode(fn, &maps[0], q, BH, Sq, D, 64) ||
      !sm90::encode(fn, &maps[1], k, BH, Sk, D, 64) ||
      !sm90::encode(fn, &maps[2], v, BH, Sk, D, 64) ||
      !sm90::encode(fn, &maps[3], dO, BH, Sq, D, 64)) {
    *err = cudaErrorInvalidValue;
    return false;
  }
  return true;
}

// A 1-D grid of `tiles` x BH CTAs, refused where CUDA cannot launch it.
bool grid(long long BH, int Sq, int Sk, int tiles, unsigned* g) {
  const long long n = static_cast<long long>(tiles) * BH;
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || BH > 0x7fffffffLL || n > 0x7fffffffLL)
    return false;
  *g = static_cast<unsigned>(n);
  return true;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Calls f(Width<D>) for D = 64 or 128 and bfloat16 (dtype code 1).
template <typename F>
cudaError_t dispatch(int dtype, int D, F&& f) {
  if (dtype != 1) return cudaErrorInvalidValue;
  if (D == 64) return f(bwd::Width<64>{});
  if (D == 128) return f(bwd::Width<128>{});
  return cudaErrorInvalidValue;
}

}  // namespace bwd90

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and out alike).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        long long BH, int Sq, int Sk, int D, float scale,
                        int causal, int q_offset, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_d<float>(q, k, v, o, BH, Sq, Sk, D, scale, causal, q_offset,
                          s);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, D, scale, causal,
                                  q_offset, s);
  } else if (dtype == 2) {
    err = launch_d<__half>(q, k, v, o, BH, Sq, Sk, D, scale, causal, q_offset,
                           s);
  }
  return static_cast<int>(err);
}

// bfloat16 q, k, v and out, D = 64 or 128; q, k and v 16-byte aligned.
int flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                             void* o, long long BH, int Sq, int Sk, int D,
                             float scale, int causal, int q_offset,
                             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 128) {
    err = sm90::launch<128>(q, k, v, o, BH, Sq, Sk, scale, causal, q_offset, s);
  } else if (D == 64) {
    err = sm90::launch<64>(q, k, v, o, BH, Sq, Sk, scale, causal, q_offset, s);
  }
  return static_cast<int>(err);
}

// Backward pass 1: lse and delta (float32, (BH, Sq)) of q, k, v and dO,
// on the CUDA-core forward kernel's STATS instance (its grid and shared
// memory).
int flash_attention_bwd_rows(const void* q, const void* k, const void* v,
                             const void* dO, void* lse, void* delta,
                             long long BH, int Sq, int Sk, int D, float scale,
                             int causal, int q_offset, int dtype,
                             void* stream) {
  static_assert(bwd::kRows == kBQ, "the forward kernel's query tile");
  dim3 g;
  if (!bwd::grid(BH, Sq, &g) || Sk <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(bwd::dispatch(dtype, D, [&](auto tag, auto width) {
    using T = typename decltype(tag)::type;
    auto kernel = flash_attention_kernel<T, decltype(width)::value, true>;
    const size_t smem = smem_bytes(D);
    cudaError_t err = bwd::set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), nullptr, Sq, Sk, D, scale, causal, q_offset,
        static_cast<const T*>(dO), static_cast<float*>(lse),
        static_cast<float*>(delta));
    return cudaGetLastError();
  }));
}

// Backward pass 2: dK and dV ((BH, Sk, D) in the inputs' type).
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                             const void* dO, const void* lse,
                             const void* delta, void* dk, void* dv,
                             long long BH, int Sq, int Sk, int D, float scale,
                             int causal, int q_offset, int dtype,
                             void* stream) {
  dim3 g;
  if (!bwd::grid(BH, Sk, &g) || Sq <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(bwd::dispatch(dtype, D, [&](auto tag, auto width) {
    using T = typename decltype(tag)::type;
    auto kernel = bwd::dkdv_kernel<T, decltype(width)::value>;
    const size_t smem = bwd::dkdv_smem(D);
    cudaError_t err = bwd::set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<g, bwd::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dO),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, D, scale, causal,
        q_offset);
    return cudaGetLastError();
  }));
}

// Backward pass 3: dQ ((BH, Sq, D) in the inputs' type).
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dO, const void* lse, const void* delta,
                           void* dq, long long BH, int Sq, int Sk, int D,
                           float scale, int causal, int q_offset, int dtype,
                           void* stream) {
  dim3 g;
  if (!bwd::grid(BH, Sq, &g) || Sk <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(bwd::dispatch(dtype, D, [&](auto tag, auto width) {
    using T = typename decltype(tag)::type;
    auto kernel = bwd::dq_kernel<T, decltype(width)::value>;
    const size_t smem = bwd::dq_smem(D);
    cudaError_t err = bwd::set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<g, bwd::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dO),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), Sq, Sk, D, scale, causal, q_offset);
    return cudaGetLastError();
  }));
}


// The tensor-core backward: bfloat16 q, k, v and dO (dtype code 1; any
// other is refused), D = 64 or 128, every pointer 16-byte aligned. lse
// (in the log2 domain: lse2 = lse * log2(e)) and delta are (BH, Sq_pad)
// float32 scratch, Sq_pad = Sq rounded up to 128: pass 1 writes every row
// of it, passes 2 and 3 read it.
int flash_attention_bwd_rows_sm90(const void* q, const void* k, const void* v,
                                  const void* dO, void* lse, void* delta,
                                  long long BH, int Sq, int Sk, int D,
                                  float scale, int causal, int q_offset,
                                  int dtype, void* stream) {
  unsigned g;
  if (!bwd90::grid(BH, Sq, Sk, (Sq + 127) / 128, &g)) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(bwd90::dispatch(dtype, D, [&](auto width) {
    constexpr int W = decltype(width)::value;
    CUtensorMap maps[4];
    cudaError_t err;
    if (!bwd90::encode_all(maps, q, k, v, dO, BH, Sq, Sk, W, &err)) {
      return err;
    }
    auto kernel = bwd90::rows_kernel<W>;
    constexpr int smem = bwd90::RowsSmem<W>::kBytes;
    err = bwd90::set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<g, bwd90::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse),
        static_cast<float*>(delta), static_cast<int>(BH), Sq, Sk,
        scale * sm90::kLog2e, causal, q_offset);
    return cudaGetLastError();
  }));
}

int flash_attention_bwd_dkdv_sm90(const void* q, const void* k, const void* v,
                                  const void* dO, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  long long BH, int Sq, int Sk, int D,
                                  float scale, int causal, int q_offset,
                                  int dtype, void* stream) {
  unsigned g;
  if (!bwd90::grid(BH, Sq, Sk, (Sk + 127) / 128, &g)) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(bwd90::dispatch(dtype, D, [&](auto width) {
    constexpr int W = decltype(width)::value;
    CUtensorMap maps[4];
    cudaError_t err;
    if (!bwd90::encode_all(maps, q, k, v, dO, BH, Sq, Sk, W, &err)) {
      return err;
    }
    auto kernel = bwd90::dkdv_kernel<W>;
    constexpr int smem = bwd90::DkdvSmem<W>::kBytes;
    err = bwd90::set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<g, bwd90::kDkdvThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), static_cast<int>(BH), Sq, Sk, scale,
        scale * sm90::kLog2e, causal, q_offset);
    return cudaGetLastError();
  }));
}

int flash_attention_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dq, long long BH,
                                int Sq, int Sk, int D, float scale,
                                int causal, int q_offset, int dtype,
                                void* stream) {
  unsigned g;
  if (!bwd90::grid(BH, Sq, Sk, (Sq + 127) / 128, &g)) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(bwd90::dispatch(dtype, D, [&](auto width) {
    constexpr int W = decltype(width)::value;
    CUtensorMap maps[4];
    cudaError_t err;
    if (!bwd90::encode_all(maps, q, k, v, dO, BH, Sq, Sk, W, &err)) {
      return err;
    }
    auto kernel = bwd90::dq_kernel<W>;
    constexpr int smem = bwd90::DqSmem<W>::kBytes;
    err = bwd90::set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<g, bwd90::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
        static_cast<int>(BH), Sq, Sk, scale, scale * sm90::kLog2e, causal,
        q_offset);
    return cudaGetLastError();
  }));
}

}  // extern "C"
