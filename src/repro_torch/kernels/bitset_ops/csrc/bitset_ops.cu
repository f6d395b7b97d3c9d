// Hopper (sm_90a) kernels for the bitset AND+popcount set algebra of the
// Bron-Kerbosch engine (per-root and persistent lanes, every backend).
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/bitset_ops/ops.py; each returns cudaGetLastError() so
// the wrapper can raise on a refused launch.
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
// Bounds on an H100 SXM (3.35 TB/s HBM; the integer work of the row
// kernels, the census and the many-mask sweep is a few ALU ops per word,
// far below the card's integer rate, so they are bound by bytes; the window
// walk re-reads its rows every step and is bound by operations). None of
// them is made fast yet: coalesced warp-per-row loads for W >= 4,
// shared-memory staging of the rows and fusing the engine's per-step
// elementwise passes are later work.

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

// ---------------------------------------------------------------------------
// dfs_step_window: per lane, up to `steps` masked pivot-BK frame-steps over
// a T-frame stack window (dynamic reduction off, counting only).
//
// Replaces repro/kernels/bitset_ops/kernel.py::dfs_step_window_lanes
// (_dfs_step_window_lanes_kernel, :505/:613) and ::dfs_step_window
// (_dfs_step_window_kernel, :458/:559), whose shared body is _window_walk
// (:333); the single-root form is this launch with L = 1. It computes what
// the plain version ref.dfs_step_window_lanes computes, step for step.
//
// Bound: each branching step sweeps the lane's U adjacency rows once and
// its XC X0 rows twice (AND+popcount against childP and childRb), at most
// K*L*(U + 2*XC)*W word operations; the bytes are the inputs read once.
// At the engine's shapes the bytes bound is the larger one, and both are
// below a microsecond; the kernel's time is its K dependent steps, each
// with four block barriers. Design: one block per lane; the lane's
// window lives in shared memory for all K steps (the point of the TPU
// kernel: the stack does not round-trip device memory between steps);
// A and X0 rows are read from global memory (they stay in L2); every
// reduction is a block reduction whose result all threads read, so the
// walk's control state (depth, done, counters) is held identically by
// every thread and the block takes uniform branches. Counts are int
// __popc sums; argmax ties go to the lowest index, as torch.argmax does.
// The TPU kernel's (8, 128) scratch literals and word/row gates do not
// apply: T and W are runtime sizes bounded only by shared memory.
// ---------------------------------------------------------------------------
constexpr int kWinThreads = 256;
constexpr int kBig = 1 << 30;
constexpr unsigned kFullMask = 0xffffffffu;

struct Acc {
  int a, b, c, d, e;
};

__device__ inline Acc shfl_down(Acc x, int off) {
  x.a = __shfl_down_sync(kFullMask, x.a, off);
  x.b = __shfl_down_sync(kFullMask, x.b, off);
  x.c = __shfl_down_sync(kFullMask, x.c, off);
  x.d = __shfl_down_sync(kFullMask, x.d, off);
  x.e = __shfl_down_sync(kFullMask, x.e, off);
  return x;
}

// (a: first set bit) min; b, c, d: sums
struct MinSum {
  __device__ Acc operator()(Acc x, Acc y) const {
    return Acc{min(x.a, y.a), x.b + y.b, x.c + y.c, x.d + y.d, 0};
  }
};

// (a, b) and (c, d): (score, index) pairs, higher score then lower index
// wins; e: sum
struct PivotArgmax {
  __device__ Acc operator()(Acc x, Acc y) const {
    const bool yu = y.a > x.a || (y.a == x.a && y.b < x.b);
    const bool yx = y.c > x.c || (y.c == x.c && y.d < x.d);
    return Acc{yu ? y.a : x.a, yu ? y.b : x.b, yx ? y.c : x.c,
               yx ? y.d : x.d, x.e + y.e};
  }
};

// Block-wide reduction; every thread returns the result. `scratch` holds
// 33 entries; the leading barrier keeps a previous call's readers safe.
template <class Combine>
__device__ Acc block_reduce(Acc v, Combine comb, Acc ident, Acc* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = comb(v, shfl_down(v, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? scratch[lane] : ident;
    for (int off = 16; off > 0; off >>= 1) v = comb(v, shfl_down(v, off));
    if (lane == 0) scratch[32] = v;
  }
  __syncthreads();
  return scratch[32];
}

__global__ void __launch_bounds__(kWinThreads)
dfs_step_window_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ x_rows,
                       const int32_t* __restrict__ alive0,
                       const uint32_t* __restrict__ win_p,
                       const uint32_t* __restrict__ win_b,
                       const uint32_t* __restrict__ win_xp,
                       const uint32_t* __restrict__ win_rb,
                       const int32_t* __restrict__ win_rsz,
                       const int32_t* __restrict__ dloc,
                       uint32_t* __restrict__ out_p,
                       uint32_t* __restrict__ out_b,
                       uint32_t* __restrict__ out_xp,
                       uint32_t* __restrict__ out_rb,
                       int32_t* __restrict__ out_rsz,
                       int32_t* __restrict__ ctl,
                       int U, int XC, int T, int W, int steps) {
  extern __shared__ uint32_t smem[];
  __shared__ Acc scratch[33];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t lane = blockIdx.x;
  const int TW = T * W;
  uint32_t* sP = smem;
  uint32_t* sB = sP + TW;
  uint32_t* sXp = sB + TW;
  uint32_t* sRb = sXp + TW;
  uint32_t* cP = sRb + TW;
  uint32_t* cXp = cP + W;
  uint32_t* cRb = cXp + W;
  int* sRsz = reinterpret_cast<int*>(cRb + W);

  const uint32_t* A = a + lane * U * static_cast<int64_t>(W);
  const uint32_t* X = x_rows + lane * XC * static_cast<int64_t>(W);
  const int32_t* al0 = alive0 + lane * XC;
  const int64_t wbase = lane * TW;
  for (int i = tid; i < TW; i += nt) {
    sP[i] = win_p[wbase + i];
    sB[i] = win_b[wbase + i];
    sXp[i] = win_xp[wbase + i];
    sRb[i] = win_rb[wbase + i];
  }
  for (int i = tid; i < T; i += nt) sRsz[i] = win_rsz[lane * T + i];
  __syncthreads();

  int dl = dloc[lane];
  int sdone = 0, calls = 0, spx = 0, clq = 0;
  for (int k = 0; k < steps; ++k) {
    const int d = min(max(dl, 0), T - 1);
    // first set bit of the frame's branch set
    int fb = kBig;
    for (int i = tid; i < W; i += nt) {
      const uint32_t bw = sB[d * W + i];
      if (bw) fb = min(fb, 32 * i + __ffs(static_cast<int>(bw)) - 1);
    }
    fb = block_reduce(Acc{fb, 0, 0, 0, 0}, MinSum(),
                      Acc{kBig, 0, 0, 0, 0}, scratch).a;
    const bool has_branch = fb < kBig;
    const bool blocked = has_branch && dl >= T - 1;
    const bool act = !blocked && dl >= 0;
    if (!act) break;  // the walk is done: no later step would act
    ++sdone;
    if (!has_branch) {  // pop
      --dl;
      continue;
    }
    const int w = min(fb, U - 1);
    const int ww = w >> 5;
    const uint32_t wbit = 1u << (w & 31);
    const uint32_t* arow = A + static_cast<int64_t>(w) * W;

    // child sets and their sizes
    int pc_p = 0, pc_x = 0, pc_rb = 0;
    for (int i = tid; i < W; i += nt) {
      const uint32_t wr = arow[i];
      const uint32_t cp = sP[d * W + i] & wr;
      const uint32_t cx = sXp[d * W + i] & wr;
      const uint32_t crb = sRb[d * W + i] | (i == ww ? wbit : 0u);
      cP[i] = cp;
      cXp[i] = cx;
      cRb[i] = crb;
      pc_p += __popc(cp);
      pc_x += __popc(cx);
      pc_rb += __popc(crb);
    }
    const Acc sizes = block_reduce(Acc{kBig, pc_p, pc_x, pc_rb, 0}, MinSum(),
                                   Acc{kBig, 0, 0, 0, 0}, scratch);
    pc_p = sizes.b;
    pc_x = sizes.c;
    pc_rb = sizes.d;

    // pivot scores: child degrees over P ∪ X, X0 rows over the alive set
    // (alive iff alive0 and Rb ⊆ N(x), the closed form of the frame's Rb)
    Acc piv{-2, 0x7fffffff, -2, 0x7fffffff, 0};
    for (int u = tid; u < U; u += nt) {
      const uint32_t* row = A + static_cast<int64_t>(u) * W;
      int deg = 0;
      for (int i = 0; i < W; ++i) deg += __popc(row[i] & cP[i]);
      const bool in_pool = ((cP[u >> 5] | cXp[u >> 5]) >> (u & 31)) & 1u;
      const int score = in_pool ? deg : -1;
      if (score > piv.a) {  // u increases: strict > keeps the first max
        piv.a = score;
        piv.b = u;
      }
    }
    for (int x = tid; x < XC; x += nt) {
      const uint32_t* row = X + static_cast<int64_t>(x) * W;
      int pc = 0, prb = 0;
      for (int i = 0; i < W; ++i) {
        const uint32_t r = row[i];
        pc += __popc(r & cP[i]);
        prb += __popc(r & cRb[i]);
      }
      const bool alive = al0[x] != 0 && prb == pc_rb;
      piv.e += alive;
      const int score = alive ? pc : -1;
      if (score > piv.c) {
        piv.c = score;
        piv.d = x;
      }
    }
    piv = block_reduce(piv, PivotArgmax(),
                       Acc{-2, 0x7fffffff, -2, 0x7fffffff, 0}, scratch);
    const int nal = piv.e;

    ++calls;
    spx += pc_p + pc_x + nal;
    const int crsz = sRsz[d] + 1;
    if (pc_p == 0 && pc_x == 0 && nal == 0 && crsz >= 2) ++clq;
    const bool push = pc_p != 0;
    const uint32_t* prow = piv.c > piv.a
                               ? X + static_cast<int64_t>(piv.d) * W
                               : A + static_cast<int64_t>(piv.b) * W;
    const int cd = min(d + 1, T - 1);
    // current frame: P \ w, X ∪ w, B \ w; child frame at d + 1 if pushed
    for (int i = tid; i < W; i += nt) {
      const uint32_t m = i == ww ? wbit : 0u;
      sP[d * W + i] &= ~m;
      sXp[d * W + i] |= m;
      sB[d * W + i] &= ~m;
      if (push) {
        sP[cd * W + i] = cP[i];
        sB[cd * W + i] = cP[i] & ~prow[i];
        sXp[cd * W + i] = cXp[i];
        sRb[cd * W + i] = cRb[i];
      }
    }
    if (push && tid == 0) sRsz[cd] = crsz;
    __syncthreads();
    if (push) ++dl;
  }

  for (int i = tid; i < TW; i += nt) {
    out_p[wbase + i] = sP[i];
    out_b[wbase + i] = sB[i];
    out_xp[wbase + i] = sXp[i];
    out_rb[wbase + i] = sRb[i];
  }
  for (int i = tid; i < T; i += nt) out_rsz[lane * T + i] = sRsz[i];
  if (tid == 0) {
    int32_t* c = ctl + lane * 8;
    c[0] = dl;
    c[1] = calls;
    c[2] = calls;  // every call of the window walk is a branch
    c[3] = spx;
    c[4] = clq;
    c[5] = sdone;
    c[6] = 0;
    c[7] = 0;
  }
}

// ---------------------------------------------------------------------------
// clique_counts: per root, with pc[k] = popcount(rows[k] & mask),
// n_full = #{k : in_p[k] && pc[k] == |mask| - 1} and
// n_dom  = #{k : in_x[k] && pc[k] == |mask|}.
//
// Replaces repro/kernels/bitset_ops/kernel.py::clique_counts
// (_clique_counts_kernel, :207/:225), the 'hybrid' backend's call-entry
// census over A stacked on the X0 rows. Bound: bytes, R*K*W*4 + 2*R*K
// (selectors) + R*W*4 read and 8*R written. Design: one block per root,
// striding over its K rows, one thread per row; the mask is staged once in
// shared memory and |mask| is a block reduction of its words' popcounts.
// Each thread counts its rows' two flags, and a second block reduction
// writes the two counts: no atomics and no second pass (the TPU version
// emitted per-row flags and summed them outside the kernel only to keep
// its grid steps independent under vmap).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
clique_counts_kernel(const uint32_t* __restrict__ rows,
                     const uint32_t* __restrict__ mask,
                     const uint8_t* __restrict__ in_p,
                     const uint8_t* __restrict__ in_x,
                     int32_t* __restrict__ n_full,
                     int32_t* __restrict__ n_dom, int K, int W) {
  extern __shared__ uint32_t smask[];
  __shared__ Acc scratch[33];
  const int64_t r = blockIdx.x;
  int msize = 0;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const uint32_t m = mask[r * W + w];
    smask[w] = m;
    msize += __popc(m);
  }
  // the reduction's barriers also publish smask
  msize = block_reduce(Acc{kBig, msize, 0, 0, 0}, MinSum(),
                       Acc{kBig, 0, 0, 0, 0}, scratch).b;
  int full = 0, dom = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const uint32_t* row = rows + (r * K + k) * static_cast<int64_t>(W);
    int pc = 0;
    for (int w = 0; w < W; ++w) pc += __popc(row[w] & smask[w]);
    full += in_p[r * K + k] && pc == msize - 1;
    dom += in_x[r * K + k] && pc == msize;
  }
  const Acc sums = block_reduce(Acc{kBig, full, dom, 0, 0}, MinSum(),
                                Acc{kBig, 0, 0, 0, 0}, scratch);
  if (threadIdx.x == 0) {
    n_full[r] = sums.b;
    n_dom[r] = sums.c;
  }
}

// ---------------------------------------------------------------------------
// and_popcount_many: out[r, m, k] = popcount(rows[r, k] & masks[r, m]).
//
// Replaces repro/kernels/bitset_ops/kernel.py::and_popcount_many
// (_and_popcount_many_kernel, :267/:277), the 'rcd' backend's pop-path
// maximality check (rows = P with K = 1, masks = ~X0 rows stacked on ~A).
// Bound: bytes, R*(M + K)*W*4 read and R*M*K*4 written. Design: one thread
// per output element (m, k), looping over the W words; the root's K rows
// are staged in shared memory when K*W words fit in kManySmemWords (always
// at the engine's K = 1, where each thread then sweeps one mask row
// against one staged word vector). Grid (R, up to 65535 element blocks),
// each block striding over the root's M*K elements.
// ---------------------------------------------------------------------------
constexpr int kManySmemWords = 12 * 1024;  // 48 KB: no opt-in needed

__global__ void __launch_bounds__(kThreads)
and_popcount_many_kernel(const uint32_t* __restrict__ rows,
                         const uint32_t* __restrict__ masks,
                         int32_t* __restrict__ out, int K, int M, int W,
                         bool staged) {
  extern __shared__ uint32_t srows[];
  const int64_t r = blockIdx.x;
  const int64_t KW = static_cast<int64_t>(K) * W;
  const uint32_t* grows = rows + r * KW;
  if (staged) {
    for (int64_t i = threadIdx.x; i < KW; i += blockDim.x) srows[i] = grows[i];
    __syncthreads();
  }
  const uint32_t* rws = staged ? srows : grows;
  const int64_t MK = static_cast<int64_t>(M) * K;
  for (int64_t e = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
       e < MK; e += static_cast<int64_t>(gridDim.y) * blockDim.x) {
    const int64_t m = e / K;
    const int k = static_cast<int>(e - m * K);
    const uint32_t* mrow = masks + (r * M + m) * W;
    const uint32_t* krow = rws + static_cast<int64_t>(k) * W;
    int c = 0;
    for (int w = 0; w < W; ++w) c += __popc(krow[w] & mrow[w]);
    out[r * MK + e] = c;
  }
}

// dynamic shared memory of one lane: the four window fields, the three
// child sets and the T frame sizes
inline size_t dfs_step_window_smem(int T, int W) {
  return sizeof(uint32_t) * (4 * static_cast<size_t>(T) * W + 3 * W + T);
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

int bitset_clique_counts(const void* rows, const void* mask, const void* in_p,
                         const void* in_x, void* n_full, void* n_dom,
                         long long R, int K, int W, void* stream) {
  clique_counts_kernel<<<static_cast<unsigned>(R), kThreads,
                         W * sizeof(uint32_t),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(mask),
      static_cast<const uint8_t*>(in_p), static_cast<const uint8_t*>(in_x),
      static_cast<int32_t*>(n_full), static_cast<int32_t*>(n_dom), K, W);
  return static_cast<int>(cudaGetLastError());
}

int bitset_and_popcount_many(const void* rows, const void* masks, void* out,
                             long long R, int K, int M, int W, void* stream) {
  const long long kw = static_cast<long long>(K) * W;
  const bool staged = kw <= kManySmemWords;
  const long long mk_blocks =
      (static_cast<long long>(M) * K + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(R),
                  static_cast<unsigned>(mk_blocks < 65535 ? mk_blocks : 65535));
  and_popcount_many_kernel<<<grid, kThreads,
                             staged ? kw * sizeof(uint32_t) : 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(masks),
      static_cast<int32_t*>(out), K, M, W, staged);
  return static_cast<int>(cudaGetLastError());
}

int bitset_dfs_step_window(const void* a, const void* x_rows,
                           const void* alive0, const void* win_p,
                           const void* win_b, const void* win_xp,
                           const void* win_rb, const void* win_rsz,
                           const void* dloc, void* out_p, void* out_b,
                           void* out_xp, void* out_rb, void* out_rsz,
                           void* ctl, long long L, int U, int XC, int T,
                           int W, int steps, void* stream) {
  const size_t smem = dfs_step_window_smem(T, W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dfs_step_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dfs_step_window_kernel<<<static_cast<unsigned>(L), kWinThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(x_rows),
      static_cast<const int32_t*>(alive0),
      static_cast<const uint32_t*>(win_p), static_cast<const uint32_t*>(win_b),
      static_cast<const uint32_t*>(win_xp),
      static_cast<const uint32_t*>(win_rb),
      static_cast<const int32_t*>(win_rsz), static_cast<const int32_t*>(dloc),
      static_cast<uint32_t*>(out_p), static_cast<uint32_t*>(out_b),
      static_cast<uint32_t*>(out_xp), static_cast<uint32_t*>(out_rb),
      static_cast<int32_t*>(out_rsz), static_cast<int32_t*>(ctl), U, XC, T, W,
      steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
