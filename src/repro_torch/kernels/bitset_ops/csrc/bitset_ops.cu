// Hopper (sm_90a) kernels for the bitset AND+popcount set algebra of the
// per-root Bron-Kerbosch engine. Plain C entry points, loaded with ctypes
// by repro_torch/kernels/bitset_ops/ops.py; each returns cudaGetLastError()
// so the wrapper can raise on a refused launch.
//
// Layout: a bitset row is W 32-bit words (bit i in word i / 32 at position
// i % 32). PyTorch stores the words as int32; the kernels read them as
// uint32_t, bit for bit. Every kernel takes the bucket's root batch R
// explicitly (in the TPU version, vmap prepended it as a grid axis)
// and indexes with 64-bit offsets: R*K*W reaches millions of words.
//
// Counts accumulate in int with __popc. The TPU kernels summed popcounts
// in float32 only because Mosaic has no integer-axis reductions.
//
// Bounds on an H100 SXM (3.35 TB/s HBM; the integer work is a few ALU ops
// per word, far below the card's integer rate, so all three are bound by
// bytes). None of them is made fast yet: coalesced warp-per-row loads for
// W >= 4, shared-memory staging of the rows and fusing the engine's
// per-step elementwise passes are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// and_popcount_rows: out[r, k] = popcount(rows[r, k, :] & mask[r, :])
//
// Replaces repro/kernels/bitset_ops/kernel.py::and_popcount_rows
// (_and_popcount_kernel). Bound: bytes, R*K*W*4 read + R*K*4 written.
// Design: one thread per row looping over its W words; the block's root
// mask is staged once in shared memory, so the row words are the only
// device-memory traffic. Grid (R, ceil(K / 256)).
// ---------------------------------------------------------------------------
__global__ void and_popcount_rows_kernel(const uint32_t* __restrict__ rows,
                                         const uint32_t* __restrict__ mask,
                                         int32_t* __restrict__ out,
                                         int K, int W) {
  extern __shared__ uint32_t smask[];
  const int64_t r = blockIdx.x;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    smask[w] = mask[r * W + w];
  }
  __syncthreads();
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const uint32_t* row = rows + (r * K + k) * static_cast<int64_t>(W);
  int c = 0;
  for (int w = 0; w < W; ++w) c += __popc(row[w] & smask[w]);
  out[r * K + k] = c;
}

// ---------------------------------------------------------------------------
// and_popcount_argmax: per root, the first row of maximal score, where
// score[k] = valid[k] ? popcount(rows[k] & mask) : -1.
//
// Replaces repro/kernels/bitset_ops/kernel.py::and_popcount_argmax
// (_and_popcount_argmax_kernel), fusing the argmax that the TPU version
// left to jnp after the kernel: the function is the same. Bound: bytes,
// R*K*W*4 + R*K (valid) read + R*8 written. Design: one block per root;
// threads stride over K, each keeping (best score, lowest index); a
// shared-memory tree reduction prefers the larger score, then the lower
// index, so ties go to the first row exactly as torch/jnp argmax. Threads
// start from score -2, below every real score, so any K >= 1 yields a real
// row: an all-invalid root gives (0, -1).
// ---------------------------------------------------------------------------
__global__ void and_popcount_argmax_kernel(const uint32_t* __restrict__ rows,
                                           const uint32_t* __restrict__ mask,
                                           const uint8_t* __restrict__ valid,
                                           int32_t* __restrict__ idx_out,
                                           int32_t* __restrict__ best_out,
                                           int K, int W) {
  extern __shared__ uint32_t smask[];
  __shared__ int s_score[kThreads];
  __shared__ int s_idx[kThreads];
  const int64_t r = blockIdx.x;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    smask[w] = mask[r * W + w];
  }
  __syncthreads();
  int best = -2;
  int best_i = 0x7fffffff;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    int score = -1;
    if (valid[r * K + k]) {
      const uint32_t* row = rows + (r * K + k) * static_cast<int64_t>(W);
      score = 0;
      for (int w = 0; w < W; ++w) score += __popc(row[w] & smask[w]);
    }
    if (score > best) {  // k increases: strict > keeps the first max
      best = score;
      best_i = k;
    }
  }
  s_score[threadIdx.x] = best;
  s_idx[threadIdx.x] = best_i;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const int os = s_score[threadIdx.x + stride];
      const int oi = s_idx[threadIdx.x + stride];
      const int ms = s_score[threadIdx.x];
      const int mi = s_idx[threadIdx.x];
      if (os > ms || (os == ms && oi < mi)) {
        s_score[threadIdx.x] = os;
        s_idx[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    idx_out[r] = s_idx[0];
    best_out[r] = s_score[0];
  }
}

// ---------------------------------------------------------------------------
// frame_step: childp = p & wrow, childxp = xp & wrow,
// deg[k] = popcount(rows[k] & childp),
// partner[k] = sum over nonzero words w of (32*w + lowest set bit).
//
// Replaces repro/kernels/bitset_ops/kernel.py::frame_step
// (_frame_step_kernel). Bound: bytes, R*K*W*4 read (+ the small masks)
// and R*K*8 written. Per step of the engine's U=32 bucket this is about
// 0.2 MB, so on this card the floor is the launch latency, not the bytes.
// Design: one thread per row; childp is built once per block in shared
// memory, and the blocks with blockIdx.y == 0 also write childp/childxp.
// Grid (R, ceil(K / 256)).
// ---------------------------------------------------------------------------
__global__ void frame_step_kernel(const uint32_t* __restrict__ rows,
                                  const uint32_t* __restrict__ p,
                                  const uint32_t* __restrict__ xp,
                                  const uint32_t* __restrict__ wrow,
                                  uint32_t* __restrict__ childp,
                                  uint32_t* __restrict__ childxp,
                                  int32_t* __restrict__ deg,
                                  int32_t* __restrict__ partner,
                                  int K, int W) {
  extern __shared__ uint32_t scp[];
  const int64_t r = blockIdx.x;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const uint32_t wr = wrow[r * W + w];
    const uint32_t cp = p[r * W + w] & wr;
    scp[w] = cp;
    if (blockIdx.y == 0) {
      childp[r * W + w] = cp;
      childxp[r * W + w] = xp[r * W + w] & wr;
    }
  }
  __syncthreads();
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const uint32_t* row = rows + (r * K + k) * static_cast<int64_t>(W);
  int d = 0;
  int part = 0;
  for (int w = 0; w < W; ++w) {
    const uint32_t a = row[w] & scp[w];
    d += __popc(a);
    if (a) part += 32 * w + __ffs(static_cast<int>(a)) - 1;
  }
  deg[r * K + k] = d;
  partner[r * K + k] = part;
}

inline unsigned blocks_for(int K) {
  return static_cast<unsigned>((K + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int bitset_and_popcount_rows(const void* rows, const void* mask, void* out,
                             long long R, int K, int W, void* stream) {
  const dim3 grid(static_cast<unsigned>(R), blocks_for(K));
  and_popcount_rows_kernel<<<grid, kThreads, W * sizeof(uint32_t),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(mask),
      static_cast<int32_t*>(out), K, W);
  return static_cast<int>(cudaGetLastError());
}

int bitset_and_popcount_argmax(const void* rows, const void* mask,
                               const void* valid, void* idx, void* best,
                               long long R, int K, int W, void* stream) {
  and_popcount_argmax_kernel<<<static_cast<unsigned>(R), kThreads,
                               W * sizeof(uint32_t),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(idx),
      static_cast<int32_t*>(best), K, W);
  return static_cast<int>(cudaGetLastError());
}

int bitset_frame_step(const void* rows, const void* p, const void* xp,
                      const void* wrow, void* childp, void* childxp,
                      void* deg, void* partner, long long R, int K, int W,
                      void* stream) {
  const dim3 grid(static_cast<unsigned>(R), blocks_for(K));
  frame_step_kernel<<<grid, kThreads, W * sizeof(uint32_t),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(wrow),
      static_cast<uint32_t*>(childp), static_cast<uint32_t*>(childxp),
      static_cast<int32_t*>(deg), static_cast<int32_t*>(partner), K, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
