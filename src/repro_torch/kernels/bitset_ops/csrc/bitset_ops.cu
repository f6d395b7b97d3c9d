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
// Bounds on an H100 SXM (3.35 TB/s HBM): the integer work of the row
// kernels, the census and the many-mask sweep is a few ALU ops per word,
// far below the card's integer rate, so they are bound by bytes, and at
// the engine's shapes by the launch itself (2-5 us), which only fewer
// launches will lower: the engine's entry points on the row kernels
// (lemma8_reduce, pivot_select), on the census (hybrid_census), on
// frame_step (branch_step) and on the many-mask sweep (rcd_dominated) each
// take a whole block of the engine's torch ops into one launch. The
// window walk is bound by the latency of its dependent frame-steps; its
// design (a warp group per lane, each lane's rows staged once per
// launch) is in the note above it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockWarps = kThreads / 32;
constexpr int kBig = 1 << 30;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSmemWords = 12 * 1024;  // 48 KB: no opt-in needed

// ---------------------------------------------------------------------------
// Helpers shared by the kernels below.
// ---------------------------------------------------------------------------

// word j of a register bitset of WT words; a select, so the array stays in
// registers
template <int WT>
__device__ __forceinline__ uint32_t word_of(const uint32_t (&v)[WT], int j) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < WT; ++i) out = i == j ? v[i] : out;
  return out;
}

template <int WT>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&w)[WT]) {
  if constexpr (WT == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (WT == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < WT; ++i) w[i] = __ldg(p + i);
  }
}

// A root's mask of WT words in every thread's registers: lane i < WT loads
// word i and the warp shares it, so the mask needs no alignment.
template <int WT>
__device__ __forceinline__ void mask_words(const uint32_t* m, int lane,
                                           uint32_t (&w)[WT]) {
  const uint32_t v = lane < WT ? __ldg(m + lane) : 0u;
#pragma unroll
  for (int i = 0; i < WT; ++i) w[i] = __shfl_sync(kFullMask, v, i);
}

// Rows of 1, 2 or 4 words read as one 4-, 8- or 16-byte vector: W of those
// and rows aligned to 4W bytes.
inline bool vector_rows(int W, const void* p) {
  return (W == 1 || W == 2 || W == 4) &&
         reinterpret_cast<uintptr_t>(p) % (4 * W) == 0;
}

// Barrier of a group of G warps: its warp, or named barrier group + 1
// (barrier 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int group, int G) {
  if (G == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(32 * G)
                 : "memory");
  }
}

// An argmax candidate: score s and row index i. The larger score wins, then
// the lower index, as torch.argmax and jnp.argmax take the first maximum. A
// thread with no row holds (kNoScore, kNoIndex).
struct Best {
  int s, i;
};
constexpr int kNoScore = -0x7fffffff - 1;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ Best warp_best(Best b) {
  const int s = __reduce_max_sync(kFullMask, b.s);
  const unsigned i = __reduce_min_sync(
      kFullMask, b.s == s ? static_cast<unsigned>(b.i) : 0xffffffffu);
  return Best{s, static_cast<int>(i)};
}

__device__ __forceinline__ Best better(Best a, Best b) {
  return b.s > a.s || (b.s == a.s && b.i < a.i) ? b : a;
}

// Whether the key (score + 1) * K + (K - 1 - index) of scores in [-1, 32 W]
// over K rows fits 32 bits.
inline bool packs(long long K, long long W) {
  return K > 0 && K * (32 * W + 2) <= (1ll << 32);
}

// The warp's best of K rows. Packed (every score in [-1, 32 W] and `packs`):
// one __reduce_max_sync over the key; a thread with no row gives key 0,
// read back as (-1, K - 1), which a real row of the warp's always matches
// or beats. Otherwise two steps: the largest score, then the lowest index
// holding it.
__device__ __forceinline__ Best warp_argmax(Best b, bool packed, uint32_t K) {
  if (!packed) return warp_best(b);
  const uint32_t key = __reduce_max_sync(
      kFullMask, b.s < -1 ? 0u
                          : static_cast<uint32_t>(b.s + 1) * K +
                                (K - 1u - static_cast<uint32_t>(b.i)));
  return Best{static_cast<int>(key / K) - 1,
              static_cast<int>(K - 1u - key % K)};
}

// ---------------------------------------------------------------------------
// and_popcount_rows: out[r, k] = popcount(rows[r, k, :] & mask[r, :])
// and_popcount_argmax: per root, the first row of maximal score, where
// score[k] = valid[k] ? popcount(rows[k] & mask) : -1.
//
// Replace repro/kernels/bitset_ops/kernel.py::and_popcount_rows
// (_and_popcount_kernel, :67) and
// repro/kernels/bitset_ops/kernel.py::and_popcount_argmax
// (_and_popcount_argmax_kernel, :103), fusing the argmax that the TPU
// version left to jnp after its kernel: the function is the same. Bound:
// bytes, R*K*W*4 read (+ R*K valid bytes, R*W mask words) and R*K*4 (the
// rows) or R*8 (the argmax) written. At the engine's shapes (K = U = 32-128
// adjacency rows or XC = 128-2,048 X0 rows of W = 1-4 words, a bucket's
// roots or 64 lanes) that is 0.1-3 MB, under a microsecond on this card,
// so what they pay is the launch and the chain inside one root from the
// launch to its last write.
//
// Design, for a short chain and few blocks:
// - A group of G warps reads one root, G = 1, 2 or 4 by K (row_group: at
//   most two rows a thread up to K = 256), and a 256-thread block holds
//   8 / G roots: the U = 64 bucket's 623 roots are 78 blocks.
// - The root's mask lives in every thread's registers (W = 1, 2, 4) or is
//   read word by word through L1 (any other W); nothing is staged in shared
//   memory and no barrier spans the block.
// - A thread issues the loads of kRowBatch rows at once, as 4-, 8- or
//   16-byte vectors at W = 1, 2 or 4 (rows aligned to 4W bytes); any other
//   W, or rows off that alignment, take the word-by-word instance (WT = 0).
//   The argmax loads its rows with their valid bytes, whatever the bytes
//   say: reading the valid bytes first and only the valid rows costs a
//   round of loads more than the bytes it saves, on an H100 at every
//   scale-12 bucket.
// - The argmax: each thread keeps its first best row (its rows come in
//   order); the warp reduces the packed key (score + 1, ~index) with one
//   __reduce_max_sync (warp_argmax), or, where K * (32 W + 2) does not fit
//   32 bits, in two steps (the largest score, then the lowest index holding
//   it); a group of G > 1 warps combines its warps' bests in shared memory
//   behind a named barrier of its own. An all-invalid root gives (0, -1).
// ---------------------------------------------------------------------------
constexpr int kRowBatch = 4;

struct RowArgs {
  const uint32_t* rows;  // (R, K, W)
  const uint32_t* mask;  // (R, W)
  const uint8_t* valid;  // the argmax: (R, K)
  int32_t* out;          // the rows: (R, K)
  int32_t* idx;          // the argmax: (R,) each
  int32_t* best;
  long long R;
  int K, W;
  int G;       // warps a root (row_group)
  int packed;  // packs(K, W)
};

// Warps a root of K rows: at most two rows a thread up to K = 256. (More
// warps a root past K = 1,024, or batches of 8 rows, were slower at every
// scale-12 bucket on an H100.)
inline int row_group(int K) { return K <= 64 ? 1 : K <= 128 ? 2 : 4; }

template <int WT, bool ARGMAX>
__global__ void __launch_bounds__(kThreads) row_kernel(const RowArgs a) {
  __shared__ Best s_best[kBlockWarps];
  constexpr int WR = WT > 0 ? WT : 1;
  const int G = a.G;
  const int gsize = 32 * G;
  const int group = threadIdx.x / gsize;
  const int gt = threadIdx.x % gsize;
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * (kBlockWarps / G) + group;
  if (r >= a.R) return;
  const int K = a.K;
  const int W = WT > 0 ? WT : a.W;
  const uint32_t* rows = a.rows + r * K * static_cast<long long>(W);
  const uint32_t* mrow = a.mask + r * W;
  uint32_t m[WR];
  if constexpr (WT > 0) mask_words<WT>(mrow, lane, m);

  Best b{kNoScore, kNoIndex};
  for (int k0 = gt; k0 < K; k0 += kRowBatch * gsize) {
    uint32_t w[kRowBatch][WR];
    bool ok[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const int k = k0 + j * gsize;
      ok[j] = k < K && (!ARGMAX || a.valid[r * K + k] != 0);
      if constexpr (WT > 0) {
        if (k < K) load_words<WT>(rows + static_cast<long long>(k) * WT, w[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const int k = k0 + j * gsize;
      if (k >= K) continue;
      if (ARGMAX && !ok[j]) {  // score -1
        if (-1 > b.s) b = Best{-1, k};
        continue;
      }
      int pc = 0;
      if constexpr (WT > 0) {
#pragma unroll
        for (int i = 0; i < WT; ++i) pc += __popc(w[j][i] & m[i]);
      } else {
        const uint32_t* row = rows + static_cast<long long>(k) * W;
        for (int i = 0; i < W; ++i) {
          pc += __popc(__ldg(row + i) & __ldg(mrow + i));
        }
      }
      if constexpr (ARGMAX) {
        if (pc > b.s) b = Best{pc, k};  // k increases: strict > keeps the first
      } else {
        a.out[r * K + k] = pc;
      }
    }
  }
  if constexpr (ARGMAX) {
    b = warp_argmax(b, a.packed != 0, static_cast<uint32_t>(K));
    if (G > 1) {
      if (lane == 0) s_best[threadIdx.x >> 5] = b;
      group_sync(group, G);
      for (int g = group * G; g < group * G + G; ++g) b = better(b, s_best[g]);
    }
    if (gt == 0) {
      a.idx[r] = b.i;
      a.best[r] = b.s;
    }
  }
}

template <bool ARGMAX>
int launch_rows(RowArgs a, cudaStream_t stream) {
  a.G = row_group(a.K);
  a.packed = packs(a.K, a.W);
  const long long per = kBlockWarps / a.G;
  const long long blocks = (a.R + per - 1) / per;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (vector_rows(a.W, a.rows) ? a.W : 0) {
    case 1:
      row_kernel<1, ARGMAX><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 2:
      row_kernel<2, ARGMAX><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 4:
      row_kernel<4, ARGMAX><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      row_kernel<0, ARGMAX><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The engine's two entry points on the row kernels, each one launch on the
// frame's own operands: A (R, U, W), the X0 rows (R, XC, W), P, Xp and Rb
// (R, W), xal (R, XCW) bits over the X0 rows, with U <= 32 W.
//
// lemma8_reduce (counted as and_popcount_rows): the Lemma-8 block of
// repro/core/engine/reductions.py, whose two calls of
// repro/kernels/bitset_ops/kernel.py::and_popcount_rows (:67) it replaces:
// degP2[u] = popcount(A[u] & P), and the X-subset test of the X0 rows
// against the full set. With psize = |P|, full = {u in P : degP2[u] ==
// psize - 1}, psize > 0; where full is not empty, P loses it, Rb gains it,
// rsz grows by n_full = |full|, Xp keeps the vertices adjacent to all of it
// (the AND of its rows) and xal keeps the alive X0 rows x < XC with
// full ⊆ N(x), and loses every bit past XC.
//
// pivot_select (counted as and_popcount_argmax): the body of
// repro/core/engine/pivot.py::branch_set, whose X0 argmax is
// repro/kernels/bitset_ops/kernel.py::and_popcount_argmax (:103): the
// first best universe row over the pool P ∪ Xp (P alone, revised) with
// scores deg - n_full, deg, or its own sweep of A; the first best alive X0
// row against P (XC = 0: none); the X row is the pivot only if its score
// is strictly higher; B = P & ~pivot_row; hybrid: B = P where sum_deg >=
// density * psize * (psize - 1) in float32, in that order (psize = |P|,
// sum_deg: the scores of P's bits below U).
//
// Bound: bytes. lemma8: A, the frame's vectors in and out, degP2, and the
// alive X0 rows of the roots with a full vertex; pivot_select: deg (or A),
// the vectors, the alive X0 rows and the pivot row. At the engine's shapes
// that is well under a microsecond; what the two save is the torch ops
// around the launches they replace, on a loop the host holds back.
//
// Design: a warp per root, 8 roots a block, nothing staged in shared memory.
// - Every operand a root reads whatever its data (A's rows, P, Xp, Rb, xal,
//   rsz, the given scores) is loaded in one first round, so the chain from
//   the launch to the last write holds at most two rounds of device loads:
//   that one and the alive X0 rows.
// - W = 1, 2 or 4 with A and the X0 rows aligned to 4W bytes: P, Xp and A's
//   rows in registers (row 32j + lane in slot j; U <= 32 W gives at most W
//   rows a lane), read once though lemma8 uses them twice (degP2, then the
//   AND of the full rows) and pivot_select takes its pivot row from them
//   (or from the winning lane's X0 row) with one shuffle a word. Word j of
//   full_bits is one __ballot_sync over
//   rows 32j .. 32j + 31, n_full their popcount, common a per-lane AND of the
//   lane's full rows and one __reduce_and_sync a word. Any other W, or rows
//   off that alignment: the word-by-word instance (WT = 0), lemma8's
//   full_bits in shared memory (W words a warp) and common read back from A
//   a word a lane.
// - The X0 rows are read only where they matter: the alive ones (set bits
//   of xal below XC), and in lemma8 only on roots with a full vertex. Both
//   skips are exact: a dead row's bit is 0 in and out, and a root with no
//   full vertex keeps xal. Each lane issues the loads of its rows in
//   kXBatch chunks of 32 rows at once (32 / W: one round at the engine's
//   W = 2 and 4, two at W = 1 with XC = 2,048), and a batch none of whose
//   chunks has an alive row below XC (one ballot over the xal words marks
//   them) is skipped whole; lemma8's new xal words are ballots, 0 for a
//   skipped batch. (Visiting the chunks with an alive row one by one, their
//   indices scanned from the mask, was slower at the U = 64 and U = 128
//   buckets on an H100.)
// - The argmaxes reduce the packed key (warp_argmax) where every score is
//   in [-1, 32 W] and the key fits: the X0 rows and pivot_select's own
//   sweep. Scores given as deg may be any int, so that argmax takes two
//   steps.
// ---------------------------------------------------------------------------
struct FrameArgs {
  const uint32_t* a;       // (R, U, W)
  const uint32_t* x_rows;  // (R, XC, W)
  const uint32_t* p;       // (R, W) each
  const uint32_t* xp;
  const uint32_t* rb;      // lemma8
  const uint32_t* xal;     // (R, XCW)
  const int32_t* rsz;      // lemma8: (R,)
  const int32_t* deg;      // pivot_select: (R, U) or null (its own sweep)
  const int32_t* n_full;   // pivot_select: (R,) or null
  uint32_t* p_out;         // lemma8: P'; pivot_select: B
  uint32_t* xp_out;        // lemma8, as the four below
  uint32_t* rb_out;
  uint32_t* xal_out;
  int32_t* rsz_out;
  int32_t* deg_out;        // degP2 (R, U)
  int32_t* n_full_out;
  long long R;
  int U, XC, XCW, W;
  int warps;               // roots a block
  int revised, hybrid;
  int packed_u, packed_x;  // packs(U, W), packs(XC, W)
  float density;
};

// X0 chunks of 32 rows whose loads a lane issues at once: up to 32 words
// of rows a lane in flight.
template <int WT>
constexpr int kXBatch = WT > 0 ? 32 / WT : 1;

// The root's xal words, read in the kernel's first round of loads: lane l
// holds words l and l + 32 (words past 64, XC > 2,048, are read when
// needed). live() marks the chunks c < 64 with an alive row below XC; call
// it once the first round's loads are used, since its ballots wait for
// these. word(c) needs c warp-uniform.
struct XalWords {
  const uint32_t* xal;
  uint32_t lo, hi;
  __device__ __forceinline__ XalWords(const uint32_t* p, int XCW, int lane)
      : xal(p),
        lo(lane < XCW ? __ldg(p + lane) : 0u),
        hi(lane + 32 < XCW ? __ldg(p + lane + 32) : 0u) {}
  __device__ __forceinline__ uint64_t live(int XC, int lane) const {
    const uint32_t l = __ballot_sync(kFullMask, (lo & below(lane, XC)) != 0u);
    const uint32_t h =
        __ballot_sync(kFullMask, (hi & below(lane + 32, XC)) != 0u);
    return (static_cast<uint64_t>(h) << 32) | l;
  }
  // the bits of chunk c below XC
  __device__ __forceinline__ static uint32_t below(int c, int XC) {
    const int n = XC - 32 * c;
    return n >= 32 ? kFullMask : n > 0 ? (1u << n) - 1u : 0u;
  }
  __device__ __forceinline__ uint32_t word(int c) const {
    return c < 32   ? __shfl_sync(kFullMask, lo, c)
           : c < 64 ? __shfl_sync(kFullMask, hi, c - 32)
                    : __ldg(xal + c);
  }
  // word c of the lane's own (c = lane, lane + 32, ...)
  __device__ __forceinline__ uint32_t own(int c) const {
    return c < 32 ? lo : c < 64 ? hi : __ldg(xal + c);
  }
};

// Whether chunks c0 .. c0 + n - 1 may hold an alive row, by the `live` mask
// of chunks below 64 (c0 >= 64: yes; a batch never straddles chunk 64:
// kXBatch divides it).
__device__ __forceinline__ bool visit(uint64_t live, int c0, int n) {
  return c0 >= 64 || ((live >> c0) & (n >= 64 ? ~0ull : (1ull << n) - 1u));
}

// Chunks c0 .. c0 + NB - 1 of the X0 rows: the lane's row x = 32c + lane is
// alive iff c < XCW, x < XC and bit `lane` of xal word c is set; WT > 0
// loads the alive rows' words, all before any use.
template <int WT, int NB>
__device__ __forceinline__ void x_batch(const uint32_t* X, const XalWords& xw,
                                        int c0, int XCW, int XC, int lane,
                                        bool (&alive)[NB],
                                        uint32_t (&xr)[NB][WT > 0 ? WT : 1]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int c = c0 + b;
    alive[b] = c < XCW && ((xw.word(c) >> lane) & 1u) && 32 * c + lane < XC;
  }
  if constexpr (WT > 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const long long x = 32ll * (c0 + b) + lane;
      if (alive[b]) {
        load_words<WT>(X + x * WT, xr[b]);
      } else {
#pragma unroll
        for (int i = 0; i < WT; ++i) xr[b][i] = 0u;
      }
    }
  }
}

template <int WT>
__global__ void __launch_bounds__(kThreads) lemma8_kernel(const FrameArgs a) {
  extern __shared__ uint32_t s_full[];  // WT = 0: full_bits, W words a warp
  constexpr int WR = WT > 0 ? WT : 1;
  constexpr int NB = kXBatch<WT>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = static_cast<long long>(blockIdx.x) * a.warps + warp;
  if (r >= a.R) return;
  const int U = a.U, XC = a.XC, XCW = a.XCW;
  const int W = WT > 0 ? WT : a.W;
  const long long fw = r * W;
  const uint32_t* A = a.a + r * U * static_cast<long long>(W);
  const uint32_t* P = a.p + fw;
  const int chunks = (U + 31) >> 5;  // <= W

  // one round of loads: A's rows (W <= 4), P, the lane's words of Xp and
  // Rb, xal and rsz
  uint32_t pw[WR], rows[WR][WR];
  int psize = 0;
  if constexpr (WT > 0) {
#pragma unroll
    for (int j = 0; j < WT; ++j) {
      const int u = 32 * j + lane;
      if (u < U) load_words<WT>(A + static_cast<long long>(u) * WT, rows[j]);
    }
  }
  const uint32_t xp_l = WT > 0 && lane < W ? __ldg(a.xp + fw + lane) : 0u;
  const uint32_t rb_l = WT > 0 && lane < W ? __ldg(a.rb + fw + lane) : 0u;
  const XalWords xw(a.xal + r * XCW, XCW, lane);
  const int rsz = a.rsz[r];
  if constexpr (WT > 0) {
    mask_words<WT>(P, lane, pw);
#pragma unroll
    for (int i = 0; i < WT; ++i) psize += __popc(pw[i]);
  } else {
    for (int i = lane; i < W; i += 32) psize += __popc(__ldg(P + i));
    psize = __reduce_add_sync(kFullMask, psize);
  }

  // degP2, the full set (a ballot a word) and, W <= 4, the AND of its rows
  uint32_t* sfull = s_full + static_cast<long long>(warp) * W;
  uint32_t full_w[WR], common[WR];
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    full_w[i] = 0u;
    common[i] = kFullMask;
  }
  int n_full = 0;
  auto chunk = [&](int j) {
    const int u = 32 * j + lane;
    int deg = 0;
    if (u < U) {
      if constexpr (WT > 0) {
#pragma unroll
        for (int i = 0; i < WT; ++i) deg += __popc(rows[j][i] & pw[i]);
      } else {
        const uint32_t* row = A + static_cast<long long>(u) * W;
        for (int i = 0; i < W; ++i) deg += __popc(__ldg(row + i) & __ldg(P + i));
      }
      a.deg_out[r * U + u] = deg;
    }
    const uint32_t pj = WT > 0 ? word_of<WR>(pw, j) : __ldg(P + j);
    const bool full =
        u < U && ((pj >> lane) & 1u) && deg == psize - 1 && psize > 0;
    const uint32_t f = __ballot_sync(kFullMask, full);
    n_full += __popc(f);
    if constexpr (WT > 0) {
      full_w[j] = f;
      if (full) {
#pragma unroll
        for (int i = 0; i < WT; ++i) common[i] &= rows[j][i];
      }
    } else if (lane == 0) {
      sfull[j] = f;
    }
  };
  if constexpr (WT > 0) {
#pragma unroll
    for (int j = 0; j < WT; ++j) {
      if (j < chunks) chunk(j);
    }
#pragma unroll
    for (int i = 0; i < WT; ++i) {
      common[i] = __reduce_and_sync(kFullMask, common[i]);
    }
  } else {
    for (int j = 0; j < chunks; ++j) chunk(j);
    for (int j = chunks + lane; j < W; j += 32) sfull[j] = 0u;
    __syncwarp();
  }

  // the frame's words: P \ full, Xp ∩ common, Rb ∪ full (the identity where
  // full is empty: common is then all ones), lane i < W writing word i
  for (int i = lane; i < W; i += 32) {
    uint32_t f, c, xp, rb;
    if constexpr (WT > 0) {
      f = word_of<WR>(full_w, i);
      c = word_of<WR>(common, i);
      xp = xp_l;
      rb = rb_l;
    } else {
      f = sfull[i];
      c = kFullMask;
      for (int j = 0; j < chunks && n_full > 0; ++j) {
        for (uint32_t bits = sfull[j]; bits; bits &= bits - 1u) {
          const int u = 32 * j + __ffs(static_cast<int>(bits)) - 1;
          c &= __ldg(A + static_cast<long long>(u) * W + i);
        }
      }
      xp = __ldg(a.xp + fw + i);
      rb = __ldg(a.rb + fw + i);
    }
    a.p_out[fw + i] = __ldg(P + i) & ~f;
    a.xp_out[fw + i] = xp & c;
    a.rb_out[fw + i] = rb | f;
  }
  if (lane == 0) {
    a.rsz_out[r] = rsz + n_full;
    a.n_full_out[r] = n_full;
  }

  // the X0 alive set: with no full vertex, as it is (bits past XC too)
  uint32_t* xal_out = a.xal_out + r * XCW;
  if (n_full == 0) {
    for (int c = lane; c < XCW; c += 32) xal_out[c] = xw.own(c);
    return;
  }
  const uint64_t live = xw.live(XC, lane);
  const uint32_t* X = a.x_rows + r * XC * static_cast<long long>(W);
  for (int c0 = 0; c0 < XCW; c0 += NB) {
    if (!visit(live, c0, NB)) {  // no alive row in the batch: its words 0
      if (lane < NB && c0 + lane < XCW) xal_out[c0 + lane] = 0u;
      continue;
    }
    bool alive[NB];
    uint32_t xr[NB][WR];
    x_batch<WT, NB>(X, xw, c0, XCW, XC, lane, alive, xr);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      bool ok = alive[b];  // full ⊆ N(x): no bit of full outside the row
      if constexpr (WT > 0) {
#pragma unroll
        for (int i = 0; i < WT; ++i) ok = ok && (full_w[i] & ~xr[b][i]) == 0u;
      } else if (ok) {
        const uint32_t* row =
            X + (32ll * (c0 + b) + lane) * static_cast<long long>(W);
        for (int i = 0; i < W && ok; ++i) {
          ok = (sfull[i] & ~__ldg(row + i)) == 0u;
        }
      }
      const uint32_t v = __ballot_sync(kFullMask, ok);
      if (lane == b && c0 + b < XCW) xal_out[c0 + b] = v;
    }
  }
}

template <int WT>
__global__ void __launch_bounds__(kThreads) pivot_kernel(const FrameArgs a) {
  constexpr int WR = WT > 0 ? WT : 1;
  constexpr int NB = kXBatch<WT>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = static_cast<long long>(blockIdx.x) * a.warps + warp;
  if (r >= a.R) return;
  const int U = a.U, XC = a.XC, XCW = a.XCW;
  const int W = WT > 0 ? WT : a.W;
  const long long fw = r * W;
  const uint32_t* A = a.a + r * U * static_cast<long long>(W);
  const uint32_t* P = a.p + fw;
  const uint32_t* Xp = a.xp + fw;
  const bool own = a.deg == nullptr;  // score by its own sweep of A
  const int chunks = (U + 31) >> 5;

  // one round of loads: A's rows (W <= 4: the pivot row is taken from
  // them), the scores, P, Xp and xal
  uint32_t pw[WR], xpw[WR], rows[WR][WR];
  if constexpr (WT > 0) {
#pragma unroll
    for (int j = 0; j < WT; ++j) {
      const int u = 32 * j + lane;
      if (u < U) load_words<WT>(A + static_cast<long long>(u) * WT, rows[j]);
    }
  }
  int dl[WR];
  if (!own) {
#pragma unroll
    for (int j = 0; j < WR; ++j) {
      const int u = 32 * j + lane;
      dl[j] = j < chunks && u < U ? a.deg[r * U + u] : 0;
    }
  }
  const int nf = a.n_full != nullptr ? a.n_full[r] : 0;
  const XalWords xw(a.xal + r * XCW, XCW, lane);
  if constexpr (WT > 0) {
    mask_words<WT>(P, lane, pw);
    mask_words<WT>(Xp, lane, xpw);
  }

  // the universe: each lane's first best pool row, and P's scores
  Best bu{kNoScore, kNoIndex};
  long long sum_deg = 0;
  auto chunk = [&](int j) {
    const int u = 32 * j + lane;
    if (u >= U) return;
    const uint32_t pj = WT > 0 ? word_of<WR>(pw, j) : __ldg(P + j);
    const uint32_t xj = WT > 0 ? word_of<WR>(xpw, j) : __ldg(Xp + j);
    const bool in_p = (pj >> lane) & 1u;
    const bool pool = in_p || (!a.revised && ((xj >> lane) & 1u));
    int d = 0;
    if (!own) {  // deg - n_full, wrapping as the int32 tensors do
      const int dj = WT > 0 ? dl[j] : a.deg[r * U + u];
      d = static_cast<int>(static_cast<uint32_t>(dj) -
                           static_cast<uint32_t>(nf));
    } else if constexpr (WT > 0) {
#pragma unroll
      for (int i = 0; i < WT; ++i) d += __popc(rows[j][i] & pw[i]);
    } else {
      const uint32_t* row = A + static_cast<long long>(u) * W;
      for (int i = 0; i < W; ++i) d += __popc(__ldg(row + i) & __ldg(P + i));
    }
    const int s = pool ? d : -1;
    if (s > bu.s || bu.i == kNoIndex) bu = Best{s, u};  // u increases
    if (in_p) sum_deg += d;
  };
  if constexpr (WT > 0) {
#pragma unroll
    for (int j = 0; j < WT; ++j) {
      if (j < chunks) chunk(j);
    }
  } else {
    for (int j = 0; j < chunks; ++j) chunk(j);
  }

  // the X0 rows: each lane's first best alive row against P (W <= 4: and
  // its words, for the pivot row)
  Best bx{kNoScore, kNoIndex};
  const uint64_t live = xw.live(XC, lane);
  uint32_t bx_row[WR];
#pragma unroll
  for (int i = 0; i < WR; ++i) bx_row[i] = 0u;
  const uint32_t* X = a.x_rows + r * XC * static_cast<long long>(W);
  for (int c0 = 0; c0 < XCW; c0 += NB) {
    if (!visit(live, c0, NB)) continue;
    bool alive[NB];
    uint32_t xr[NB][WR];
    x_batch<WT, NB>(X, xw, c0, XCW, XC, lane, alive, xr);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (!alive[b]) continue;
      const int x = 32 * (c0 + b) + lane;
      int s = 0;
      if constexpr (WT > 0) {
#pragma unroll
        for (int i = 0; i < WT; ++i) s += __popc(xr[b][i] & pw[i]);
      } else {
        const uint32_t* row = X + static_cast<long long>(x) * W;
        for (int i = 0; i < W; ++i) s += __popc(__ldg(row + i) & __ldg(P + i));
      }
      if (s > bx.s) {
        bx = Best{s, x};
        if constexpr (WT > 0) {
#pragma unroll
          for (int i = 0; i < WT; ++i) bx_row[i] = xr[b][i];
        }
      }
    }
  }
  bu = warp_argmax(bu, own && a.packed_u, static_cast<uint32_t>(U));
  bx = warp_argmax(bx, a.packed_x != 0, static_cast<uint32_t>(XC));
  const bool x_none = bx.s < 0;  // no alive row: the all-invalid (0, -1)
  if (x_none) bx = Best{-1, 0};
  const bool use_x = XC > 0 && bx.s > bu.s;

  // hybrid: vertex branching (B = P) on a dense P
  bool dense = false;
  if (a.hybrid) {
    int psize = 0;  // |P|: every bit of its words
    if constexpr (WT > 0) {
#pragma unroll
      for (int i = 0; i < WT; ++i) psize += __popc(pw[i]);
    } else {
      for (int i = lane; i < W; i += 32) psize += __popc(__ldg(P + i));
      psize = __reduce_add_sync(kFullMask, psize);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum_deg += __shfl_xor_sync(kFullMask, sum_deg, o);
    }
    dense = __ll2float_rn(sum_deg) >=
            __fmul_rn(__fmul_rn(a.density, __int2float_rn(psize)),
                      __int2float_rn(psize - 1));
  }

  // B = P & ~pivot_row; W <= 4: the pivot row from the registers of the
  // lane that holds it
  if constexpr (WT > 0) {
    const int src = (use_x ? bx.i : bu.i) & 31;
    const int slot = bu.i >> 5;
    uint32_t bw = 0u;
#pragma unroll
    for (int i = 0; i < WT; ++i) {
      // X0 row 0 wins only against scores below -1: no lane holds it
      uint32_t mine = use_x && x_none ? __ldg(X + i) : bx_row[i];
      if (!use_x) {
#pragma unroll
        for (int j = 0; j < WT; ++j) mine = j == slot ? rows[j][i] : mine;
      }
      const uint32_t prow = __shfl_sync(kFullMask, mine, src);
      bw = lane == i ? (dense ? pw[i] : pw[i] & ~prow) : bw;
    }
    if (lane < WT) a.p_out[fw + lane] = bw;
  } else {
    const uint32_t* prow = use_x ? X + static_cast<long long>(bx.i) * W
                                 : A + static_cast<long long>(bu.i) * W;
    for (int i = lane; i < W; i += 32) {
      const uint32_t p = __ldg(P + i);
      a.p_out[fw + i] = dense ? p : p & ~__ldg(prow + i);
    }
  }
}

// One engine launch: the register instance at W = 1, 2 or 4 with A and the
// X0 rows aligned to 4W bytes, else word by word (WT = 0), where lemma8
// keeps W words of full_bits a warp in shared memory (fewer roots a block
// past W = 1,536; refused past kSmemWords).
template <bool LEMMA8>
int launch_frame(FrameArgs a, cudaStream_t stream) {
  if (a.U < 1 || a.W < 1 || a.U > 32ll * a.W || a.XC < 0 || a.XCW < 0 ||
      32ll * a.XCW < a.XC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wt = vector_rows(a.W, a.a) && vector_rows(a.W, a.x_rows) ? a.W : 0;
  a.warps = kBlockWarps;
  size_t smem = 0;
  if (LEMMA8 && wt == 0) {
    const int fit = kSmemWords / a.W;
    if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.warps = fit < kBlockWarps ? fit : kBlockWarps;
    smem = sizeof(uint32_t) * a.warps * a.W;
  }
  a.packed_u = packs(a.U, a.W);
  a.packed_x = packs(a.XC, a.W);
  const long long blocks = (a.R + a.warps - 1) / a.warps;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const int nt = 32 * a.warps;
  switch (wt) {
    case 1:
      if (LEMMA8) lemma8_kernel<1><<<grid, nt, smem, stream>>>(a);
      else pivot_kernel<1><<<grid, nt, smem, stream>>>(a);
      break;
    case 2:
      if (LEMMA8) lemma8_kernel<2><<<grid, nt, smem, stream>>>(a);
      else pivot_kernel<2><<<grid, nt, smem, stream>>>(a);
      break;
    case 4:
      if (LEMMA8) lemma8_kernel<4><<<grid, nt, smem, stream>>>(a);
      else pivot_kernel<4><<<grid, nt, smem, stream>>>(a);
      break;
    default:
      if (LEMMA8) lemma8_kernel<0><<<grid, nt, smem, stream>>>(a);
      else pivot_kernel<0><<<grid, nt, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// frame_step: childp = p & wrow, childxp = xp & wrow,
// deg[k] = popcount(rows[k] & childp),
// partner[k] = sum over nonzero words i of (32 i + lowest set bit), the
// bit's index where deg[k] == 1 and, as the reference defines it, a sum
// of no meaning elsewhere.
//
// Replaces repro/kernels/bitset_ops/kernel.py::frame_step
// (_frame_step_kernel, :167). Bound: bytes, R*K*W*4 read (+ the three
// masks) and R*K*8 (+ the two child sets) written: at the engine's U = 64
// bucket 0.66 MB, 0.2 us on this card, so what it pays is the launch and
// the chain inside one root from the launch to its last write.
//
// Design: the row kernels' geometry (row_kernel above). A group of G = 1,
// 2 or 4 warps reads one root (step_group(K)), 8 / G roots a block. Each
// lane forms childp = p & wrow in registers (W = 1, 2, 4: lane i < W loads
// word i and the warp shares it; nothing in shared memory, no block
// barrier), after issuing the loads of its first kRowBatch rows, as 4-, 8-
// or 16-byte vectors (rows aligned to 4W bytes). deg and partner come from
// the same AND; thread i < W of the group writes word i of the two child
// sets. Any other W, or rows off that alignment, take the word-by-word
// instance (WT = 0), its masks read through L1.
//
// The engine's entry point on it is branch_step (below): the whole branch
// half of a DFS step in one launch.
// ---------------------------------------------------------------------------
struct StepArgs {
  const uint32_t* rows;  // (R, K, W)
  const uint32_t* p;     // (R, W) each
  const uint32_t* xp;
  const uint32_t* wrow;
  uint32_t* childp;      // (R, W) each
  uint32_t* childxp;
  int32_t* deg;          // (R, K) each
  int32_t* partner;
  long long R;
  int K, W;
  int G;  // warps a root (row_group)
};

// popcount and partner term of one AND of row and child words
__device__ __forceinline__ void deg_partner(uint32_t anded, int i, int& d,
                                            int& part) {
  d += __popc(anded);
  if (anded) part += 32 * i + __ffs(static_cast<int>(anded)) - 1;
}

// Warps a root of K rows: one row a thread up to K = 128 (faster than
// row_group's two a thread at the U = 128 bucket on an H100), then 4.
inline int step_group(int K) { return K <= 32 ? 1 : K <= 64 ? 2 : 4; }

template <int WT>
__global__ void __launch_bounds__(kThreads) frame_step_kernel(
    const StepArgs a) {
  constexpr int WR = WT > 0 ? WT : 1;
  const int G = a.G;
  const int gsize = 32 * G;
  const int group = threadIdx.x / gsize;
  const int gt = threadIdx.x % gsize;
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * (kBlockWarps / G) + group;
  if (r >= a.R) return;
  const int K = a.K;
  const int W = WT > 0 ? WT : a.W;
  const long long fw = r * W;
  const uint32_t* rows = a.rows + r * K * static_cast<long long>(W);
  const uint32_t* P = a.p + fw;
  const uint32_t* WROW = a.wrow + fw;

  // first round: the thread's first rows, the mask words, the child sets
  uint32_t w[kRowBatch][WR];
  auto load_batch = [&](int k0) {
    if constexpr (WT > 0) {
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        const int k = k0 + j * gsize;
        if (k < K) load_words<WT>(rows + static_cast<long long>(k) * WT, w[j]);
      }
    }
  };
  load_batch(gt);
  const uint32_t cl =
      WT > 0 && lane < WT ? __ldg(P + lane) & __ldg(WROW + lane) : 0u;
  for (int i = gt; i < W; i += gsize) {
    const uint32_t wr = __ldg(WROW + i);
    a.childp[fw + i] = __ldg(P + i) & wr;
    a.childxp[fw + i] = __ldg(a.xp + fw + i) & wr;
  }
  uint32_t cp[WR];
#pragma unroll
  for (int i = 0; i < WR; ++i) cp[i] = __shfl_sync(kFullMask, cl, i);

  for (int k0 = gt; k0 < K; k0 += kRowBatch * gsize) {
    if (k0 != gt) load_batch(k0);
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const int k = k0 + j * gsize;
      if (k >= K) continue;
      int d = 0, part = 0;
      if constexpr (WT > 0) {
#pragma unroll
        for (int i = 0; i < WT; ++i) deg_partner(w[j][i] & cp[i], i, d, part);
      } else {
        const uint32_t* row = rows + static_cast<long long>(k) * W;
        for (int i = 0; i < W; ++i) {
          deg_partner(__ldg(row + i) & __ldg(P + i) & __ldg(WROW + i), i, d,
                      part);
        }
      }
      a.deg[r * K + k] = d;
      a.partner[r * K + k] = part;
    }
  }
}

int launch_frame_step(StepArgs a, cudaStream_t stream) {
  a.G = step_group(a.K);
  const long long per = kBlockWarps / a.G;
  const long long blocks = (a.R + per - 1) / per;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (vector_rows(a.W, a.rows) ? a.W : 0) {
    case 1:
      frame_step_kernel<1><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 2:
      frame_step_kernel<2><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 4:
      frame_step_kernel<4><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      frame_step_kernel<0><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// branch_step (counted as frame_step): the branch half of the engine's DFS
// step (repro/core/engine/loop.py::dfs_step, apart from its call entry)
// in one launch on the engine's own operands, with frame_step (above) at
// its core: A (R, U, W), the X0 rows (R, XC, W), the DFS stack's buffers
// P, B, Xp, Rb (R, D, W), rsz (R, D) and xal (R, D, XCW), depth (R,)
// int64, live (R,) bool and, for 'rcd', the branch vertex w (R,) int32.
//
// Per root, on slot d = max(depth, 0): w is the first bit of B (32 for an
// empty B) clamped to U - 1, or the given w; has_branch = (B != 0) & live,
// or live with w given; with wbit = {w} and wrow = A[w]: childP = P & wrow,
// childXp = Xp & wrow, deg and partner frame_step's over A against
// childP, childxal = xal & {x < XC : bit w of X0 row x}, childRb = Rb | wbit,
// child_rsz = rsz + 1, whatever has_branch says; where has_branch holds,
// the slot itself loses w from P (and, pivot family, from B) and Xp gains
// it, in place.
//
// Bound: bytes. A's rows, the slot's words, the alive X0 rows' word w / 32
// (a dead row's bit stays 0 either way) and the outputs: at the U = 64
// bucket about 0.5 MB a launch, 0.15 us. The torch ops it replaces (about
// 60 kernels a step: the slot gathers, the first bit, the A and X0 column
// gathers, mask_to_bitset, the where updates and their index_put) are what
// the launch saves, on a loop the host holds back.
//
// Design: a warp a root, 8 roots a block, nothing in shared memory.
// - First round: depth, live, w and, W = 1, 2 or 4 with A aligned to 4W
//   bytes, A's rows in registers (row 32j + lane in slot j). Second: the
//   slot's words (lane i < W loads word i; the warp shares them) and xal.
//   wrow then comes from the registers of the lane holding row w, one
//   shuffle a word, so the only later loads are the X0 column's.
// - The X0 column: lane l owns xal words l, l + 32, ... (the first two
//   loaded in the second round) and reads word w / 32 of each alive row of
//   its words (bit set, row below XC), kColLoads loads in flight; it
//   writes its childxal words itself, so a dead word costs no load, no
//   ballot and no shuffle. (A row a lane, 32 chunks at once with a ballot
//   a chunk, as lemma8_reduce reads its X0 rows, passes over every chunk
//   of a batch with one alive row: slower at the U = 32 and U = 64
//   buckets on an H100, most of all at U = 32's 64 xal words.)
// - The slot is written last, by lane i < W for word i, after the warp has
//   read it (a __syncwarp orders the word-by-word instance, whose lanes
//   read the slot's words again for every row). The stack buffers are
//   read with plain loads: the kernel writes them.
// - Any other W, or A off that alignment: the word-by-word instance
//   (WT = 0), A's and the slot's words read through L1.
// ---------------------------------------------------------------------------
constexpr int kColLoads = 4;

struct BranchArgs {
  const uint32_t* a;       // (R, U, W)
  const uint32_t* x_rows;  // (R, XC, W)
  uint32_t* sp;            // (R, D, W) each; P, B and Xp written in place
  uint32_t* sb;
  uint32_t* sxp;
  const uint32_t* srb;
  const int32_t* srsz;     // (R, D)
  const uint32_t* sxal;    // (R, D, XCW)
  const long long* depth;  // (R,)
  const uint8_t* live;     // (R,)
  const int32_t* w;        // (R,), or null: the pivot family's first bit
  uint8_t* has_branch;     // (R,)
  uint32_t* childp;        // (R, W) each
  uint32_t* childxp;
  uint32_t* childrb;
  uint32_t* childxal;      // (R, XCW)
  int32_t* child_rsz;      // (R,)
  int32_t* deg;            // (R, U) each
  int32_t* partner;
  long long R;
  int U, XC, XCW, W, D;
  int warps;               // roots a block
};

template <int WT>
__global__ void __launch_bounds__(kThreads) branch_kernel(const BranchArgs a) {
  constexpr int WR = WT > 0 ? WT : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = static_cast<long long>(blockIdx.x) * a.warps + warp;
  if (r >= a.R) return;
  const int U = a.U, XC = a.XC, XCW = a.XCW, D = a.D;
  const int W = WT > 0 ? WT : a.W;
  const bool pivot = a.w == nullptr;
  const uint32_t* A = a.a + r * U * static_cast<long long>(W);

  // first round: depth, live, the given w, A's rows (W <= 4)
  const long long dep = a.depth[r];
  const bool live = a.live[r] != 0;
  const int w_in = pivot ? 0 : a.w[r];
  uint32_t rows[WR][WR] = {};
  if constexpr (WT > 0) {
#pragma unroll
    for (int j = 0; j < WT; ++j) {
      const int u = 32 * j + lane;
      if (u < U) load_words<WT>(A + static_cast<long long>(u) * WT, rows[j]);
    }
  }
  // the slot (depth < D is the engine's invariant; kept in bounds here)
  const long long slot =
      r * D + (dep < 0 ? 0 : dep >= D ? D - 1 : static_cast<int>(dep));
  const long long sw = slot * W;

  // second round: the slot's words, rsz and xal
  uint32_t pl = 0u, bl = 0u, xpl = 0u, rbl = 0u;
  if (WT > 0 && lane < W) {
    pl = a.sp[sw + lane];
    bl = a.sb[sw + lane];
    xpl = a.sxp[sw + lane];
    rbl = a.srb[sw + lane];
  }
  const int rsz = a.srsz[slot];
  const XalWords xw(a.sxal + slot * XCW, XCW, lane);

  // w: the given one, or B's first bit (32 when B is empty) clamped
  int w;
  bool any_b = false;
  if (!pivot) {
    w = w_in < 0 ? 0 : w_in > U - 1 ? U - 1 : w_in;
  } else {
    int fb = kBig;
    if constexpr (WT > 0) {
#pragma unroll
      for (int i = WT - 1; i >= 0; --i) {
        const uint32_t b = __shfl_sync(kFullMask, bl, i);
        if (b) fb = 32 * i + __ffs(static_cast<int>(b)) - 1;
      }
    } else {
      for (int i = lane; i < W; i += 32) {
        const uint32_t b = a.sb[sw + i];
        if (b) {
          fb = 32 * i + __ffs(static_cast<int>(b)) - 1;
          break;
        }
      }
      fb = static_cast<int>(__reduce_min_sync(kFullMask,
                                              static_cast<unsigned>(fb)));
    }
    any_b = fb != kBig;
    w = any_b ? (fb < U - 1 ? fb : U - 1) : (32 < U - 1 ? 32 : U - 1);
  }
  const bool hb = pivot ? any_b && live : live;
  const int wj = w >> 5;
  const uint32_t wmask = 1u << (w & 31);

  // the child sets, rsz and has_branch; W <= 4: wrow from the registers of
  // the lane holding row w
  uint32_t cp[WR];
  if constexpr (WT > 0) {
#pragma unroll
    for (int i = 0; i < WT; ++i) {
      uint32_t mine = 0u;
#pragma unroll
      for (int j = 0; j < WT; ++j) mine = j == wj ? rows[j][i] : mine;
      const uint32_t wr = __shfl_sync(kFullMask, mine, w & 31);
      cp[i] = __shfl_sync(kFullMask, pl, i) & wr;
      if (lane == i) {
        const uint32_t wb = i == wj ? wmask : 0u;
        a.childp[r * W + i] = pl & wr;
        a.childxp[r * W + i] = xpl & wr;
        a.childrb[r * W + i] = rbl | wb;
      }
    }
  } else {
    for (int i = lane; i < W; i += 32) {
      const uint32_t wr = __ldg(A + static_cast<long long>(w) * W + i);
      const uint32_t wb = i == wj ? wmask : 0u;
      a.childp[r * W + i] = a.sp[sw + i] & wr;
      a.childxp[r * W + i] = a.sxp[sw + i] & wr;
      a.childrb[r * W + i] = a.srb[sw + i] | wb;
    }
  }
  if (lane == 0) {
    a.child_rsz[r] = rsz + 1;
    a.has_branch[r] = hb;
  }

  // deg and partner over A against childP
  const int chunks = (U + 31) >> 5;
  auto chunk = [&](int j) {
    const int u = 32 * j + lane;
    if (u >= U) return;
    int d = 0, part = 0;
    if constexpr (WT > 0) {
#pragma unroll
      for (int i = 0; i < WT; ++i) deg_partner(rows[j][i] & cp[i], i, d, part);
    } else {
      const uint32_t* row = A + static_cast<long long>(u) * W;
      const uint32_t* wrow = A + static_cast<long long>(w) * W;
      for (int i = 0; i < W; ++i) {
        deg_partner(__ldg(row + i) & a.sp[sw + i] & __ldg(wrow + i), i, d,
                    part);
      }
    }
    a.deg[r * U + u] = d;
    a.partner[r * U + u] = part;
  };
  if constexpr (WT > 0) {
#pragma unroll
    for (int j = 0; j < WT; ++j) {
      if (j < chunks) chunk(j);
    }
  } else {
    for (int j = 0; j < chunks; ++j) chunk(j);
  }

  // childxal: bit w of the alive X0 rows below XC, lane l taking xal
  // words l, l + 32, ...
  uint32_t* cxal = a.childxal + r * XCW;
  const uint32_t* X = a.x_rows + r * XC * static_cast<long long>(W) + wj;
  for (int c = lane; c < XCW; c += 32) {
    uint32_t bits = xw.own(c) & XalWords::below(c, XC);
    uint32_t out = 0u;
    while (bits) {
      int x[kColLoads];
      uint32_t v[kColLoads];
#pragma unroll
      for (int i = 0; i < kColLoads; ++i) {
        x[i] = bits ? __ffs(static_cast<int>(bits)) - 1 : -1;
        bits &= bits - 1u;
        v[i] = x[i] >= 0 ? __ldg(X + (32ll * c + x[i]) * W) : 0u;
      }
#pragma unroll
      for (int i = 0; i < kColLoads; ++i) {
        if (x[i] >= 0 && (v[i] & wmask)) out |= 1u << x[i];
      }
    }
    cxal[c] = out;
  }

  // the slot, in place where the root branches
  if constexpr (WT == 0) __syncwarp();
  if (hb) {
    for (int i = lane; i < W; i += 32) {
      const uint32_t wb = i == wj ? wmask : 0u;
      if constexpr (WT > 0) {
        a.sp[sw + i] = pl & ~wb;
        a.sxp[sw + i] = xpl | wb;
        if (pivot) a.sb[sw + i] = bl & ~wb;
      } else {
        a.sp[sw + i] = a.sp[sw + i] & ~wb;
        a.sxp[sw + i] = a.sxp[sw + i] | wb;
        if (pivot) a.sb[sw + i] = a.sb[sw + i] & ~wb;
      }
    }
  }
}

int launch_branch(BranchArgs a, cudaStream_t stream) {
  if (a.U < 1 || a.W < 1 || a.U > 32ll * a.W || a.XC < 0 || a.XCW < 0 ||
      32ll * a.XCW < a.XC || a.D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.warps = kBlockWarps;
  const long long blocks = (a.R + a.warps - 1) / a.warps;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (vector_rows(a.W, a.a) ? a.W : 0) {
    case 1:
      branch_kernel<1><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 2:
      branch_kernel<2><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 4:
      branch_kernel<4><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      branch_kernel<0><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// clique_counts: per root, with pc[k] = popcount(rows[k] & mask),
// n_full = #{k : in_p[k] && pc[k] == |mask| - 1} and
// n_dom  = #{k : in_x[k] && pc[k] == |mask|}.
//
// Replaces repro/kernels/bitset_ops/kernel.py::clique_counts
// (_clique_counts_kernel, :207/:225), the 'hybrid' backend's call-entry
// census over A stacked on the X0 rows. Bound: bytes, R*K*W*4 + 2*R*K
// (selectors) + R*W*4 read and 8*R written; at the engine's shapes (K = U
// + XC = 2,080 / 576 / 256 rows of W = 1 / 2 / 4 words, 64 lanes or a
// bucket's roots) well under the launch, so what bounds it is the chain
// inside a block between the launch and its one write.
//
// Design: one block per root, and no block-wide step before the row loads.
// - Every warp loads the root's W mask words itself (lane w < W, a loop for
//   a runtime W past 32) and gets |mask| with __popc and __reduce_add_sync:
//   redundant per warp, but no barrier stands between the launch and the
//   rows.
// - A thread issues the loads of up to kCensusBatch rows at once (8- or
//   16-byte vectors at W = 2 and 4, with their selector bytes or bits),
//   the first batch before the mask's. A block has 512 threads when the
//   roots are few (under two a SM: the hybrid lanes' 64, the U = 128
//   bucket's 21) and 256 when they fill the card in waves, never more
//   than one a row (census_threads; measured at the three scale-12
//   buckets by chip_smoke.py's threads_ms).
// - Each warp sums its flags with __reduce_add_sync, and one shared-memory
//   combine behind a single barrier writes the two counts.
// Two entry points share the kernel. bitset_clique_counts keeps the
// reference's contract (stacked rows, bool selectors). bitset_hybrid_census
// reads A and the X0 rows where they lie, as two pointers with no stacked
// copy, derives the selectors from the bitsets (in_p: bit k of P for
// k < U and false on the X0 rows; in_x: bit k of Xp for k < U, bit k - U
// of x_alive after) and also writes |P|'s bits below U.
// ---------------------------------------------------------------------------
constexpr int kCensusBatch = 4;
constexpr int kCensusMaxThreads = 512;

struct CensusArgs {
  const uint32_t* rows;     // stacked (R, K, W); the hybrid census: A (R, U, W)
  const uint32_t* x_rows;   // the hybrid census: (R, XC, W)
  const uint32_t* mask;     // P (R, W)
  const uint32_t* xp;       // the hybrid census: Xp (R, W)
  const uint32_t* x_alive;  // the hybrid census: (R, XCW) bits
  const uint8_t* in_p;      // stacked: (R, K)
  const uint8_t* in_x;
  int32_t* n_full;
  int32_t* n_dom;
  int32_t* psize;           // the hybrid census: |P| below U
  int K, U, XC, XCW, W;
};

// WT: W words as registers (1, 2 or 4; rows 16-byte aligned at W = 4, 8 at
// W = 2), or 0 for a runtime W read word by word. HYB: the hybrid census.
template <int WT, bool HYB>
__global__ void __launch_bounds__(kCensusMaxThreads)
census_kernel(const CensusArgs a) {
  __shared__ int s_full[kCensusMaxThreads / 32];
  __shared__ int s_dom[kCensusMaxThreads / 32];
  constexpr int WR = WT > 0 ? WT : 1;
  const int64_t r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int W = WT > 0 ? WT : a.W;
  const int K = a.K;
  const int nt = blockDim.x;
  const uint32_t* mrow = a.mask + r * W;

  // this thread's first rows: every load issued before the mask's
  uint32_t w[kCensusBatch][WR];
  uint32_t sel[kCensusBatch];   // bit 0: in_p, bit 1: in_x (stacked), or
                                // the row's x_alive word (hybrid, X0 rows)
  auto row_ptr = [&](int k) -> const uint32_t* {
    if constexpr (HYB) {
      return k < a.U ? a.rows + (r * a.U + k) * static_cast<int64_t>(W)
                     : a.x_rows + (r * a.XC + (k - a.U)) *
                                      static_cast<int64_t>(W);
    } else {
      return a.rows + (r * K + k) * static_cast<int64_t>(W);
    }
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kCensusBatch; ++j) {
      const int k = k0 + j * nt;
      if (k >= K) continue;
      if constexpr (WT > 0) load_words<WT>(row_ptr(k), w[j]);
      if constexpr (HYB) {
        const int x = k - a.U;
        sel[j] = x >= 0 ? __ldg(a.x_alive + r * a.XCW + (x >> 5)) : 0u;
      } else {
        sel[j] = (a.in_p[r * K + k] ? 1u : 0u) |
                 (a.in_x[r * K + k] ? 2u : 0u);
      }
    }
  };
  fetch(threadIdx.x);

  // |mask|, P's bits below U and (hybrid) Xp, in every warp: no barrier
  uint32_t m[WR], xpw[WR];
  int msize = 0, psize = 0;
  if constexpr (WT > 0) {
    const uint32_t mw = lane < WT ? __ldg(mrow + lane) : 0u;
    msize = __reduce_add_sync(kFullMask, __popc(mw));
#pragma unroll
    for (int i = 0; i < WT; ++i) m[i] = __shfl_sync(kFullMask, mw, i);
    if constexpr (HYB) {
      const uint32_t xw = lane < WT ? __ldg(a.xp + r * W + lane) : 0u;
#pragma unroll
      for (int i = 0; i < WT; ++i) xpw[i] = __shfl_sync(kFullMask, xw, i);
      const int below = a.U - 32 * lane;   // P's bits of this lane's word
      const uint32_t keep = below >= 32 ? kFullMask
                            : below > 0 ? (1u << below) - 1u : 0u;
      psize = __reduce_add_sync(kFullMask, __popc(mw & keep));
    }
  } else {
    for (int i = lane; i < W; i += 32) {
      const uint32_t mw = __ldg(mrow + i);
      msize += __popc(mw);
      const int below = a.U - 32 * i;
      psize += __popc(mw & (below >= 32 ? kFullMask
                            : below > 0 ? (1u << below) - 1u : 0u));
    }
    msize = __reduce_add_sync(kFullMask, msize);
    psize = __reduce_add_sync(kFullMask, psize);
  }

  int full = 0, dom = 0;
  for (int k0 = threadIdx.x; k0 < K; k0 += kCensusBatch * nt) {
    if (k0 != static_cast<int>(threadIdx.x)) fetch(k0);
#pragma unroll
    for (int j = 0; j < kCensusBatch; ++j) {
      const int k = k0 + j * nt;
      if (k >= K) continue;
      int pc = 0;
      bool ip, ix;
      if constexpr (WT > 0) {
#pragma unroll
        for (int i = 0; i < WT; ++i) pc += __popc(w[j][i] & m[i]);
      } else {
        const uint32_t* row = row_ptr(k);
        for (int i = 0; i < W; ++i) pc += __popc(__ldg(row + i) & __ldg(mrow + i));
      }
      if constexpr (HYB) {
        if (k < a.U) {
          uint32_t pw, xw;
          if constexpr (WT > 0) {
            pw = word_of<WT>(m, k >> 5);
            xw = word_of<WT>(xpw, k >> 5);
          } else {
            pw = __ldg(mrow + (k >> 5));
            xw = __ldg(a.xp + r * W + (k >> 5));
          }
          ip = (pw >> (k & 31)) & 1u;
          ix = (xw >> (k & 31)) & 1u;
        } else {
          ip = false;
          ix = (sel[j] >> ((k - a.U) & 31)) & 1u;
        }
      } else {
        ip = sel[j] & 1u;
        ix = sel[j] & 2u;
      }
      full += ip && pc == msize - 1;
      dom += ix && pc == msize;
    }
  }
  full = __reduce_add_sync(kFullMask, full);
  dom = __reduce_add_sync(kFullMask, dom);
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_full[warp] = full;
    s_dom[warp] = dom;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < nt / 32; ++i) {
      full += s_full[i];
      dom += s_dom[i];
    }
    a.n_full[r] = full;
    a.n_dom[r] = dom;
    if constexpr (HYB) a.psize[r] = psize;
  }
}

// Threads a census block takes for R roots of K rows: 512 when the blocks
// are under two a SM, else 256, and at most K rounded up to whole warps
// (`threads` > 0 forces a count, a multiple of 32, for the measurements of
// chip_smoke.py and the probe).
constexpr long long kCensusFewRoots = 2 * 132;

int census_threads(long long R, int K, int threads) {
  if (threads > 0) return threads;
  const int most = R < kCensusFewRoots ? kCensusMaxThreads : 256;
  const int rows = (K + 31) / 32 * 32;
  return rows < most ? rows : most;
}

template <bool HYB>
int launch_census(const CensusArgs& a, long long R, int threads,
                  bool vec_ok, cudaStream_t stream) {
  const int nt = census_threads(R, a.K, threads);
  if (nt % 32 != 0 || nt > kCensusMaxThreads ||
      R > 0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(R);
  const int W = vec_ok ? a.W : 0;
  switch (W) {
    case 1:
      census_kernel<1, HYB><<<grid, nt, 0, stream>>>(a);
      break;
    case 2:
      census_kernel<2, HYB><<<grid, nt, 0, stream>>>(a);
      break;
    case 4:
      census_kernel<4, HYB><<<grid, nt, 0, stream>>>(a);
      break;
    default:
      census_kernel<0, HYB><<<grid, nt, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// and_popcount_many: out[r, m, k] = popcount(rows[r, k] & masks[r, m]).
//
// Replaces repro/kernels/bitset_ops/kernel.py::and_popcount_many
// (_and_popcount_many_kernel, :267/:277), the reference's 'rcd' pop-path
// maximality check (rows = P with K = 1, masks = ~X0 rows stacked on ~A).
// Bound: bytes, R*(M + K)*W*4 read and R*M*K*4 written: at the U = 64
// bucket (M = 576, W = 2) 4.3 MB, 1.3 us on this card.
//
// Design. Where the K rows hold at most 4 words (K * W <= 4: the check's
// K = 1 at W <= 4), they live in every lane's registers (lane i < K*W
// loads word i and the warp shares it) and a group of G = 1, 2 or 4 warps
// (row_group(M)) sweeps the root's M mask rows, 8 / G roots a block, with
// no staging and no barrier: a thread issues the loads of its first
// kRowBatch mask rows at once, as 4-, 8- or 16-byte vectors at W = 1, 2
// or 4 (masks aligned to 4W bytes, else word by word), and the stores of
// consecutive rows are consecutive. Larger K * W keeps the general
// kernel: the K rows staged in shared memory when they fit kSmemWords
// words, one thread an output element (m, k), a grid of (R, up to 65,535
// element blocks).
//
// The engine's entry point is rcd_dominated (below), which reads the X0
// rows and A where they lie and needs no complement or output matrix.
// ---------------------------------------------------------------------------
constexpr int kManyRegWords = 4;

struct ManyArgs {
  const uint32_t* rows;   // (R, K, W)
  const uint32_t* masks;  // (R, M, W)
  int32_t* out;           // (R, M, K)
  long long R;
  int K, M, W;
  int G;  // warps a root (row_group(M))
};

template <int WT>
__global__ void __launch_bounds__(kThreads) many_reg_kernel(const ManyArgs a) {
  constexpr int WR = WT > 0 ? WT : kManyRegWords;
  const int G = a.G;
  const int gsize = 32 * G;
  const int group = threadIdx.x / gsize;
  const int gt = threadIdx.x % gsize;
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * (kBlockWarps / G) + group;
  if (r >= a.R) return;
  const int K = a.K, M = a.M;
  const int W = WT > 0 ? WT : a.W;
  const int KW = K * W;
  const uint32_t* masks = a.masks + r * M * static_cast<long long>(W);
  int32_t* out = a.out + r * M * static_cast<long long>(K);

  // first round: the thread's first mask rows and the K rows' words
  uint32_t mw[kRowBatch][WR];
  auto load_batch = [&](int m0) {
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const int m = m0 + j * gsize;
      if (m >= M) continue;
      const uint32_t* row = masks + static_cast<long long>(m) * W;
      if constexpr (WT > 0) {
        load_words<WT>(row, mw[j]);
      } else {
#pragma unroll
        for (int i = 0; i < WR; ++i) mw[j][i] = i < W ? __ldg(row + i) : 0u;
      }
    }
  };
  load_batch(gt);
  const uint32_t vl = lane < KW ? __ldg(a.rows + r * KW + lane) : 0u;
  uint32_t rw[kManyRegWords];
#pragma unroll
  for (int i = 0; i < kManyRegWords; ++i) {
    rw[i] = __shfl_sync(kFullMask, vl, i);
  }

  for (int m0 = gt; m0 < M; m0 += kRowBatch * gsize) {
    if (m0 != gt) load_batch(m0);
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const int m = m0 + j * gsize;
      if (m >= M) continue;
      if constexpr (WT > 0) {  // K = kManyRegWords / WT at most
#pragma unroll
        for (int k = 0; k < kManyRegWords / WT; ++k) {
          if (k >= K) break;
          int c = 0;
#pragma unroll
          for (int i = 0; i < WT; ++i) c += __popc(rw[k * WT + i] & mw[j][i]);
          out[static_cast<long long>(m) * K + k] = c;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kManyRegWords; ++k) {
          if (k >= K) break;
          int c = 0;
#pragma unroll
          for (int i = 0; i < kManyRegWords; ++i) {
            const int e = k * W + i;
            // word i of row k, when i < W (e < KW <= 4 then)
            uint32_t v = 0u;
#pragma unroll
            for (int q = 0; q < kManyRegWords; ++q) v = q == e ? rw[q] : v;
            if (i < W) c += __popc(v & mw[j][i]);
          }
          out[static_cast<long long>(m) * K + k] = c;
        }
      }
    }
  }
}

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

int launch_many(const void* rows, const void* masks, void* out, long long R,
                int K, int M, int W, cudaStream_t stream) {
  const long long kw = static_cast<long long>(K) * W;
  if (kw <= kManyRegWords) {
    ManyArgs a{};
    a.rows = static_cast<const uint32_t*>(rows);
    a.masks = static_cast<const uint32_t*>(masks);
    a.out = static_cast<int32_t*>(out);
    a.R = R;
    a.K = K;
    a.M = M;
    a.W = W;
    a.G = row_group(M);
    const long long per = kBlockWarps / a.G;
    const long long blocks = (R + per - 1) / per;
    if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid = static_cast<unsigned>(blocks);
    switch (vector_rows(W, masks) ? W : 0) {
      case 1:
        many_reg_kernel<1><<<grid, kThreads, 0, stream>>>(a);
        break;
      case 2:
        many_reg_kernel<2><<<grid, kThreads, 0, stream>>>(a);
        break;
      case 4:
        many_reg_kernel<4><<<grid, kThreads, 0, stream>>>(a);
        break;
      default:
        many_reg_kernel<0><<<grid, kThreads, 0, stream>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const bool staged = kw <= kSmemWords;
  const long long mk_blocks =
      (static_cast<long long>(M) * K + kThreads - 1) / kThreads;
  if (R > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(R),
                  static_cast<unsigned>(mk_blocks < 65535 ? mk_blocks : 65535));
  and_popcount_many_kernel<<<grid, kThreads,
                             staged ? kw * sizeof(uint32_t) : 0, stream>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(masks),
      static_cast<int32_t*>(out), K, M, W, staged);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// rcd_dominated (counted as and_popcount_many): the 'rcd' maximality test
// of repro/core/engine/pivot.py::rcd_maximality_report, whose
// and_popcount_many call of P against ~X0 rows stacked on ~A it replaces,
// on the engine's operands: A (R, U, W), the X0 rows (R, XC, W), P and Xp
// (R, W), xal (R, XCW). blocked = some selected row x has P & ~x == 0 (the
// alive X0 rows, xal's bits below XC, and the universe rows of Xp's bits
// below U; with an empty P every selected row blocks), and psize = |P|, all
// of its words' bits.
//
// Bound: bytes. P, Xp and xal, the selected rows and the two outputs: at
// the U = 64 bucket's roots about 0.04 MB, so what it pays is the launch
// and the chain to its write. The check it replaces read all XC + U rows of
// a complement the engine kept for the whole bucket, wrote an (R, XC + U)
// count matrix and ran about 30 torch kernels after it.
//
// Design: a warp a root, 8 roots a block. P and Xp (W <= 4: in every
// lane's registers) and xal in the first round; then only the selected
// rows are read, the universe rows of Xp beside the first batch of X0
// chunks (x_batch, as lemma8_reduce reads them: kXBatch chunks of 32 rows
// a lane at once, a batch with no alive row below XC skipped whole); the
// complement is taken in registers; the warp votes with __any_sync after
// each batch and stops at the first blocking row. (Rows read as
// branch_step reads its X0 column, a lane the alive rows of its own xal
// words, were slower at the U = 64 and U = 128 buckets on an H100: a row
// here is W words, not one.) Any other W, or rows off the vector
// alignment: the word-by-word instance (WT = 0).
// ---------------------------------------------------------------------------
struct DomArgs {
  const uint32_t* a;       // (R, U, W)
  const uint32_t* x_rows;  // (R, XC, W)
  const uint32_t* p;       // (R, W) each
  const uint32_t* xp;
  const uint32_t* xal;     // (R, XCW)
  uint8_t* blocked;        // (R,)
  int32_t* psize;          // (R,)
  long long R;
  int U, XC, XCW, W;
  int warps;
};

// P ⊆ row: no bit of P outside the row's words
template <int WT>
__device__ __forceinline__ bool covers(const uint32_t (&pw)[WT > 0 ? WT : 1],
                                       const uint32_t (&row)[WT > 0 ? WT : 1],
                                       const uint32_t* P, const uint32_t* g,
                                       int W) {
  if constexpr (WT > 0) {
    uint32_t rest = 0u;
#pragma unroll
    for (int i = 0; i < WT; ++i) rest |= pw[i] & ~row[i];
    return rest == 0u;
  } else {
    for (int i = 0; i < W; ++i) {
      if (__ldg(P + i) & ~__ldg(g + i)) return false;
    }
    return true;
  }
}

template <int WT>
__global__ void __launch_bounds__(kThreads) dominated_kernel(const DomArgs a) {
  constexpr int WR = WT > 0 ? WT : 1;
  constexpr int NB = kXBatch<WT>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = static_cast<long long>(blockIdx.x) * a.warps + warp;
  if (r >= a.R) return;
  const int U = a.U, XC = a.XC, XCW = a.XCW;
  const int W = WT > 0 ? WT : a.W;
  const long long fw = r * W;
  const uint32_t* A = a.a + r * U * static_cast<long long>(W);
  const uint32_t* P = a.p + fw;
  const uint32_t* Xp = a.xp + fw;

  // first round: P, Xp and xal
  uint32_t pw[WR], xpw[WR];
  const XalWords xw(a.xal + r * XCW, XCW, lane);
  int psize = 0;
  if constexpr (WT > 0) {
    mask_words<WT>(P, lane, pw);
    mask_words<WT>(Xp, lane, xpw);
#pragma unroll
    for (int i = 0; i < WT; ++i) psize += __popc(pw[i]);
  } else {
    for (int i = lane; i < W; i += 32) psize += __popc(__ldg(P + i));
    psize = __reduce_add_sync(kFullMask, psize);
  }
  if (lane == 0) a.psize[r] = psize;

  // the universe rows of Xp (U <= 32 W: chunk j < W)
  bool blocked = false;
  const int chunks = (U + 31) >> 5;
  auto chunk = [&](int j) {
    const int u = 32 * j + lane;
    const uint32_t xj = WT > 0 ? word_of<WR>(xpw, j) : __ldg(Xp + j);
    if (u >= U || !((xj >> lane) & 1u)) return;
    const uint32_t* g = A + static_cast<long long>(u) * W;
    uint32_t row[WR];
    if constexpr (WT > 0) load_words<WT>(g, row);
    blocked = blocked || covers<WT>(pw, row, P, g, W);
  };
  if constexpr (WT > 0) {
#pragma unroll
    for (int j = 0; j < WT; ++j) {
      if (j < chunks) chunk(j);
    }
  } else {
    for (int j = 0; j < chunks; ++j) chunk(j);
  }

  // the alive X0 rows, a batch at a time, until a row blocks
  const uint64_t live = xw.live(XC, lane);
  const uint32_t* X = a.x_rows + r * XC * static_cast<long long>(W);
  for (int c0 = 0; c0 < XCW; c0 += NB) {
    if (__any_sync(kFullMask, blocked)) break;
    if (!visit(live, c0, NB)) continue;
    bool alive[NB];
    uint32_t xr[NB][WR];
    x_batch<WT, NB>(X, xw, c0, XCW, XC, lane, alive, xr);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (!alive[b]) continue;
      const uint32_t* g =
          X + (32ll * (c0 + b) + lane) * static_cast<long long>(W);
      blocked = blocked || covers<WT>(pw, xr[b], P, g, W);
    }
  }
  blocked = __any_sync(kFullMask, blocked);
  if (lane == 0) a.blocked[r] = blocked;
}

int launch_dominated(DomArgs a, cudaStream_t stream) {
  if (a.U < 1 || a.W < 1 || a.U > 32ll * a.W || a.XC < 0 || a.XCW < 0 ||
      32ll * a.XCW < a.XC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.warps = kBlockWarps;
  const long long blocks = (a.R + a.warps - 1) / a.warps;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (vector_rows(a.W, a.a) && vector_rows(a.W, a.x_rows) ? a.W : 0) {
    case 1:
      dominated_kernel<1><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 2:
      dominated_kernel<2><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 4:
      dominated_kernel<4><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      dominated_kernel<0><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
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
// What bounds it: each branching step sweeps the lane's U adjacency rows
// once and its XC X0 rows twice (AND+popcount against childP and childRb).
// At the engine's shapes (U = 32/64/128 with XC = 2,048/512/128 and
// W = 1/2/4, T = 8, 16 steps) those operations and the inputs' bytes each
// take well under a microsecond on the card, so the kernel is bound by
// latency: 16 dependent steps, each a chain of first bit, child sets, row
// sweep, argmax and window update, behind one launch.
//
// Design, against that chain:
// - A group of G warps (G = 1, 2 or 4, chosen by the wrapper from XC and L)
//   walks one lane, and a block holds several lanes. No barrier spans the
//   block, so lanes that stop at different steps never wait for each other.
// - A lane's rows never change during a launch, so they are read from
//   device memory once: its A rows (U*W words) and X0 rows (XC*W words)
//   are staged in shared memory by 1-D bulk asynchronous copies
//   (cp.async.bulk, completing on an mbarrier) while the group loads the
//   window and packs alive0 to bits with warp ballots. A slice whose address
//   or size is not a multiple of 16 bytes is loaded with plain coalesced
//   loads instead; rows too large for the block's shared memory are read
//   from device memory by one warp a lane (the one STAGED = false
//   instance: runtime W, G = 1; no engine shape reaches it). A dead lane
//   (dloc < 0), or a launch of zero steps, copies its window through and
//   stages nothing.
// - For W <= 4 (a template parameter) the child sets childP, childXp and
//   childRb live in registers, every thread holding all W words; a
//   runtime-W instance keeps them in the group's shared memory. Either
//   way the walk's control state (depth, counters) is the same in every
//   thread of the group, and the group's branches are uniform.
// - The reductions are warp collectives. The pivot argmax packs
//   (score + 1, ~index) into one 32-bit key, so one __reduce_max_sync
//   settles the score and the lowest index on a tie (where the key would
//   not fit, a max of the score and then a min of the index); the alive
//   count is one __reduce_add_sync. A group of G > 1 warps combines its
//   warps' results through shared memory behind a named barrier
//   (bar.sync id, 32*G), which also orders its window writes; one warp
//   needs only __syncwarp. An X0 row wins the pivot only if its score is
//   strictly greater than the best adjacency row's, as in the reference.
// Counts are int __popc sums.
// ---------------------------------------------------------------------------
constexpr int kWinMaxThreads = 256;
constexpr long long kWinSmemMax = 232448;  // 227 KB: a block's shared memory
// A staging copy that has not landed after 60 s traps instead of hanging
// the card (a trap is sticky: the process's CUDA context is lost). The
// limit is long because the global timer keeps counting while the card
// serves other work.
constexpr unsigned long long kWaitNs = 60ull * 1000 * 1000 * 1000;

__host__ __device__ constexpr long long align16(long long n) {
  return (n + 15) & ~15ll;
}

// Byte offsets in one lane's shared-memory region: its mbarrier, the
// group's reduction scratch (8 ints a warp), the window (P, B, Xp, Rb, then
// the T frame sizes), the runtime-W child sets and, when staged, alive0's
// bits and the A and X0 rows. ops.py::window_lane_bytes mirrors it, and
// bitset_window_lane_bytes exports it so the card tests can hold the two
// together.
struct WinLayout {
  long long bar, red, win, child, alive, rows_a, rows_x, bytes;
  __host__ __device__ WinLayout(int U, int XC, int T, int W, int G,
                                bool staged) {
    long long o = 0;
    bar = o;
    o += 16;
    red = o;
    o += align16(32ll * G);
    win = o;
    o += align16(4ll * (4ll * T * W + T));
    child = o;
    o += align16(12ll * W);
    alive = rows_a = rows_x = o;
    if (staged) {
      alive = o;
      o += align16(4ll * ((XC + 31ll) / 32));
      rows_a = o;
      o += align16(4ll * U * W);
      rows_x = o;
      o += align16(4ll * XC * W);
    }
    bytes = o;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try(bar, parity)) {
    if (globaltimer() - t0 > kWaitNs) __trap();
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned device memory into shared
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The child sets of a step: registers for a compile-time W, the group's
// shared memory for the runtime-W instance (WT = 0).
template <int WT>
struct ChildSets {
  uint32_t p[WT], x[WT], rb[WT];
  // word j of childP | childXp; a select, so the arrays stay in registers
  __device__ __forceinline__ uint32_t pool(int j) const {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < WT; ++i) v = i == j ? p[i] | x[i] : v;
    return v;
  }
};

template <>
struct ChildSets<0> {
  uint32_t *p, *x, *rb;
  __device__ __forceinline__ uint32_t pool(int j) const { return p[j] | x[j]; }
};

// popcount(row & childP) and, with RB, popcount(row & childRb). Staged rows
// of 2 or 4 words are read as one 8- or 16-byte load.
template <int WT, bool STAGED, bool RB>
__device__ __forceinline__ void row_pops(const uint32_t* row,
                                         const ChildSets<WT>& c, int W,
                                         int& pp, int& prb) {
  pp = 0;
  prb = 0;
  if constexpr (WT == 0) {
    for (int i = 0; i < W; ++i) {
      const uint32_t r = row[i];
      pp += __popc(r & c.p[i]);
      if constexpr (RB) prb += __popc(r & c.rb[i]);
    }
  } else {
    uint32_t r[WT];
    if constexpr (STAGED && WT == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(row);
      r[0] = v.x;
      r[1] = v.y;
    } else if constexpr (STAGED && WT == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(row);
      r[0] = v.x;
      r[1] = v.y;
      r[2] = v.z;
      r[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < WT; ++i) r[i] = row[i];
    }
#pragma unroll
    for (int i = 0; i < WT; ++i) {
      pp += __popc(r[i] & c.p[i]);
      if constexpr (RB) prb += __popc(r[i] & c.rb[i]);
    }
  }
}

// The window walk's pivot candidate is a Best with s = score + 1 (>= 0; -1
// for no row).
__device__ __forceinline__ uint32_t best_key(Best b, int ib, uint32_t imask) {
  return b.s < 0 ? 0u : (static_cast<uint32_t>(b.s) << ib) |
                            (imask - static_cast<uint32_t>(b.i));
}

__device__ __forceinline__ Best key_best(uint32_t key, int ib,
                                         uint32_t imask) {
  return Best{static_cast<int>(key >> ib),
              static_cast<int>(imask - (key & imask))};
}

// The group's best adjacency row (u), best X0 row (x) and alive count, from
// each thread's own; the lowest index wins a tie.
template <int G>
__device__ __forceinline__ void group_pivot(Best& u, Best& x, int& nal,
                                            bool packed, int ib, int* red,
                                            int group, int warp, int lane) {
  const uint32_t imask = (1u << ib) - 1u;
  nal = __reduce_add_sync(kFullMask, nal);
  if (packed) {
    uint32_t ku = __reduce_max_sync(kFullMask, best_key(u, ib, imask));
    uint32_t kx = __reduce_max_sync(kFullMask, best_key(x, ib, imask));
    if constexpr (G > 1) {
      if (lane == 0) {
        red[8 * warp] = static_cast<int>(ku);
        red[8 * warp + 1] = static_cast<int>(kx);
        red[8 * warp + 2] = nal;
      }
      group_sync(group, G);
      nal = 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        ku = max(ku, static_cast<uint32_t>(red[8 * g]));
        kx = max(kx, static_cast<uint32_t>(red[8 * g + 1]));
        nal += red[8 * g + 2];
      }
    }
    u = key_best(ku, ib, imask);
    x = key_best(kx, ib, imask);
  } else {
    u = warp_best(u);
    x = warp_best(x);
    if constexpr (G > 1) {
      if (lane == 0) {
        red[8 * warp] = u.s;
        red[8 * warp + 1] = u.i;
        red[8 * warp + 2] = x.s;
        red[8 * warp + 3] = x.i;
        red[8 * warp + 4] = nal;
      }
      group_sync(group, G);
      u = x = Best{-1, 0x7fffffff};
      nal = 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        u = better(u, Best{red[8 * g], red[8 * g + 1]});
        x = better(x, Best{red[8 * g + 2], red[8 * g + 3]});
        nal += red[8 * g + 4];
      }
    }
  }
}

struct WinArgs {
  const uint32_t* a;
  const uint32_t* x_rows;
  const int32_t* alive0;
  const uint32_t* win[4];  // P, B, Xp, Rb
  const int32_t* win_rsz;
  const int32_t* dloc;
  uint32_t* out[4];
  int32_t* out_rsz;
  int32_t* ctl;
  long long L;
  int U, XC, T, W, steps;
  int lanes_per_block;
  int lane_bytes;  // WinLayout(...).bytes
  int index_bits;  // 2^index_bits > max(U, XC)
  int packed;      // (score + 1, ~index) fits 32 bits
};

template <int WT, int G, bool STAGED>
__global__ void __launch_bounds__(kWinMaxThreads)
dfs_step_window_kernel(const WinArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kGroup = 32 * G;
  const int group = threadIdx.x / kGroup;
  const int gt = threadIdx.x % kGroup;
  const int warp = gt >> 5;
  const int lane_id = gt & 31;
  const long long lane =
      static_cast<long long>(blockIdx.x) * args.lanes_per_block + group;
  if (lane >= args.L) return;
  const int U = args.U, XC = args.XC, T = args.T;
  const int W = WT > 0 ? WT : args.W;
  const int TW = T * W;
  const long long wbase = lane * TW;
  int dl = args.dloc[lane];

  if (dl < 0 || args.steps <= 0) {  // nothing to walk: copy through
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      for (int i = gt; i < TW; i += kGroup) {
        args.out[f][wbase + i] = args.win[f][wbase + i];
      }
    }
    for (int i = gt; i < T; i += kGroup) {
      args.out_rsz[lane * T + i] = args.win_rsz[lane * T + i];
    }
    if (gt < 8) args.ctl[lane * 8 + gt] = gt == 0 ? dl : 0;
    return;
  }

  unsigned char* region =
      smem + static_cast<long long>(group) * args.lane_bytes;
  const WinLayout lay(U, XC, T, W, G, STAGED);
  uint64_t* bar = reinterpret_cast<uint64_t*>(region + lay.bar);
  int* red = reinterpret_cast<int*>(region + lay.red);
  uint32_t* swin = reinterpret_cast<uint32_t*>(region + lay.win);
  uint32_t* sP = swin;
  uint32_t* sB = sP + TW;
  uint32_t* sXp = sB + TW;
  uint32_t* sRb = sXp + TW;
  int* sRsz = reinterpret_cast<int*>(sRb + TW);
  const uint32_t* A = args.a + lane * U * static_cast<long long>(W);
  const uint32_t* X = args.x_rows + lane * XC * static_cast<long long>(W);
  const int32_t* al0 = args.alive0 + lane * XC;
  const uint32_t* rows_a = A;
  const uint32_t* rows_x = X;
  const uint32_t* s_alive = nullptr;
  if constexpr (STAGED) {
    uint32_t* sA = reinterpret_cast<uint32_t*>(region + lay.rows_a);
    uint32_t* sX = reinterpret_cast<uint32_t*>(region + lay.rows_x);
    uint32_t* sAl = reinterpret_cast<uint32_t*>(region + lay.alive);
    const uint32_t bytes_a = 4u * U * W;
    const uint32_t bytes_x = 4u * XC * W;
    const bool bulk_a = ((reinterpret_cast<uintptr_t>(A) | bytes_a) & 15) == 0;
    const bool bulk_x = ((reinterpret_cast<uintptr_t>(X) | bytes_x) & 15) == 0;
    if (gt == 0) mbar_init(bar);
    group_sync(group, G);
    if (gt == 0) {
      mbar_expect_tx(bar, (bulk_a ? bytes_a : 0u) + (bulk_x ? bytes_x : 0u));
      if (bulk_a) bulk_load(sA, A, bytes_a, bar);
      if (bulk_x) bulk_load(sX, X, bytes_x, bar);
    }
    if (!bulk_a) {
      for (int i = gt; i < U * W; i += kGroup) sA[i] = A[i];
    }
    if (!bulk_x) {
      for (int i = gt; i < XC * W; i += kGroup) sX[i] = X[i];
    }
    for (int x0 = 32 * warp; x0 < XC; x0 += kGroup) {  // 32 rows a ballot
      const int x = x0 + lane_id;
      const unsigned bits = __ballot_sync(kFullMask, x < XC && al0[x] != 0);
      if (lane_id == 0) sAl[x0 >> 5] = bits;
    }
    rows_a = sA;
    rows_x = sX;
    s_alive = sAl;
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    for (int i = gt; i < TW; i += kGroup) swin[f * TW + i] = args.win[f][wbase + i];
  }
  for (int i = gt; i < T; i += kGroup) sRsz[i] = args.win_rsz[lane * T + i];
  if constexpr (STAGED) mbar_wait(bar, 0);
  group_sync(group, G);

  ChildSets<WT> c;
  if constexpr (WT == 0) {
    c.p = reinterpret_cast<uint32_t*>(region + lay.child);
    c.x = c.p + W;
    c.rb = c.x + W;
  }
  const int nw = WT > 0 ? WT : W;
  const int ib = args.index_bits;
  const bool packed = args.packed != 0;
  int sdone = 0, calls = 0, spx = 0, clq = 0;
  for (int k = 0; k < args.steps; ++k) {
    const int d = min(max(dl, 0), T - 1);
    // first set bit of the frame's branch set
    const uint32_t* fB = sB + d * nw;
    int fb = kBig;
#pragma unroll
    for (int i = nw - 1; i >= 0; --i) {
      const uint32_t bw = fB[i];
      if (bw) fb = 32 * i + __ffs(static_cast<int>(bw)) - 1;
    }
    const bool has_branch = fb < kBig;
    if (dl < 0 || (has_branch && dl >= T - 1)) break;  // the walk is done
    ++sdone;
    if (!has_branch) {  // pop
      --dl;
      continue;
    }
    const int w = min(fb, U - 1);
    const int ww = w >> 5;
    const uint32_t wbit = 1u << (w & 31);
    const int crsz = sRsz[d] + 1;
    const uint32_t* arow = rows_a + static_cast<long long>(w) * nw;

    // child sets and their sizes
    int pc_p = 0, pc_x = 0, pc_rb = 0;
    if constexpr (WT > 0) {
#pragma unroll
      for (int i = 0; i < WT; ++i) {
        const uint32_t wr = arow[i];
        c.p[i] = sP[d * WT + i] & wr;
        c.x[i] = sXp[d * WT + i] & wr;
        c.rb[i] = sRb[d * WT + i] | (i == ww ? wbit : 0u);
        pc_p += __popc(c.p[i]);
        pc_x += __popc(c.x[i]);
        pc_rb += __popc(c.rb[i]);
      }
    } else {
      for (int i = gt; i < W; i += kGroup) {
        const uint32_t wr = arow[i];
        c.p[i] = sP[d * W + i] & wr;
        c.x[i] = sXp[d * W + i] & wr;
        c.rb[i] = sRb[d * W + i] | (i == ww ? wbit : 0u);
      }
      group_sync(group, G);
      for (int i = 0; i < W; ++i) {
        pc_p += __popc(c.p[i]);
        pc_x += __popc(c.x[i]);
        pc_rb += __popc(c.rb[i]);
      }
    }

    // pivot scores: child degrees over P ∪ X, X0 rows over the alive set
    // (alive iff alive0 and Rb ⊆ N(x), the closed form of the frame's Rb).
    // With childP empty there is no child frame, so no pivot to pick.
    Best bu{-1, 0}, bx{-1, 0};
    if (pc_p != 0) {
      for (int u = gt; u < U; u += kGroup) {
        int deg, unused;
        row_pops<WT, STAGED, false>(rows_a + static_cast<long long>(u) * nw,
                                    c, W, deg, unused);
        const int s = (c.pool(u >> 5) >> (u & 31)) & 1u ? deg + 1 : 0;
        if (s > bu.s) bu = Best{s, u};  // u increases: strict > keeps the first
      }
    }
    int nal = 0;
#pragma unroll 4
    for (int x = gt; x < XC; x += kGroup) {
      int pc, prb;
      row_pops<WT, STAGED, true>(rows_x + static_cast<long long>(x) * nw, c,
                                 W, pc, prb);
      bool alive;
      if constexpr (STAGED) {
        alive = (s_alive[x >> 5] >> (x & 31)) & 1u;
      } else {
        alive = al0[x] != 0;
      }
      alive = alive && prb == pc_rb;
      nal += alive;
      const int s = alive ? pc + 1 : 0;
      if (s > bx.s) bx = Best{s, x};
    }
    group_pivot<G>(bu, bx, nal, packed, ib, red, group, warp, lane_id);

    ++calls;
    spx += pc_p + pc_x + nal;
    if (pc_p == 0 && pc_x == 0 && nal == 0 && crsz >= 2) ++clq;
    const bool push = pc_p != 0;
    const uint32_t* prow =
        bx.s > bu.s ? rows_x + static_cast<long long>(bx.i) * nw
                    : rows_a + static_cast<long long>(bu.i) * nw;
    const int cd = min(d + 1, T - 1);
    // current frame: P \ w, X ∪ w, B \ w; child frame at d + 1 if pushed
    for (int i = gt; i < nw; i += kGroup) {
      uint32_t cp, cx, crb;
      if constexpr (WT > 0) {
        cp = cx = crb = 0;
#pragma unroll
        for (int j = 0; j < WT; ++j) {
          if (j == i) {
            cp = c.p[j];
            cx = c.x[j];
            crb = c.rb[j];
          }
        }
      } else {
        cp = c.p[i];
        cx = c.x[i];
        crb = c.rb[i];
      }
      const uint32_t m = i == ww ? wbit : 0u;
      sP[d * nw + i] &= ~m;
      sXp[d * nw + i] |= m;
      sB[d * nw + i] &= ~m;
      if (push) {
        sP[cd * nw + i] = cp;
        sB[cd * nw + i] = cp & ~prow[i];
        sXp[cd * nw + i] = cx;
        sRb[cd * nw + i] = crb;
      }
    }
    if (push && gt == 0) sRsz[cd] = crsz;
    group_sync(group, G);
    if (push) ++dl;
  }

  group_sync(group, G);
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    for (int i = gt; i < TW; i += kGroup) args.out[f][wbase + i] = swin[f * TW + i];
  }
  for (int i = gt; i < T; i += kGroup) args.out_rsz[lane * T + i] = sRsz[i];
  if (gt == 0) {
    int32_t* out = args.ctl + lane * 8;
    out[0] = dl;
    out[1] = calls;
    out[2] = calls;  // every call of the window walk is a branch
    out[3] = spx;
    out[4] = clq;
    out[5] = sdone;
    out[6] = 0;
    out[7] = 0;
  }
}

template <int WT, int G, bool STAGED>
int launch_window(const WinArgs& args, long long smem, cudaStream_t stream) {
  auto* kernel = dfs_step_window_kernel<WT, G, STAGED>;
  if (smem > 48 * 1024) {  // the opt-in is per instantiation
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks =
      (args.L + args.lanes_per_block - 1) / args.lanes_per_block;
  kernel<<<static_cast<unsigned>(blocks), 32 * G * args.lanes_per_block,
           static_cast<size_t>(smem), stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int WT>
int launch_window_w(const WinArgs& args, int group, long long smem,
                    cudaStream_t stream) {
  if (group == 1) return launch_window<WT, 1, true>(args, smem, stream);
  if (group == 2) return launch_window<WT, 2, true>(args, smem, stream);
  return launch_window<WT, 4, true>(args, smem, stream);
}

inline int bit_length(long long v) {
  int n = 0;
  for (; v > 0; v >>= 1) ++n;
  return n;
}

}  // namespace

extern "C" {

int bitset_and_popcount_rows(const void* rows, const void* mask, void* out,
                             long long R, int K, int W, void* stream) {
  RowArgs a{};
  a.rows = static_cast<const uint32_t*>(rows);
  a.mask = static_cast<const uint32_t*>(mask);
  a.out = static_cast<int32_t*>(out);
  a.R = R;
  a.K = K;
  a.W = W;
  return launch_rows<false>(a, static_cast<cudaStream_t>(stream));
}

int bitset_and_popcount_argmax(const void* rows, const void* mask,
                               const void* valid, void* idx, void* best,
                               long long R, int K, int W, void* stream) {
  RowArgs a{};
  a.rows = static_cast<const uint32_t*>(rows);
  a.mask = static_cast<const uint32_t*>(mask);
  a.valid = static_cast<const uint8_t*>(valid);
  a.idx = static_cast<int32_t*>(idx);
  a.best = static_cast<int32_t*>(best);
  a.R = R;
  a.K = K;
  a.W = W;
  return launch_rows<true>(a, static_cast<cudaStream_t>(stream));
}

// The Lemma-8 pass: reads A, the X0 rows, P, Xp, xal, Rb and rsz; writes
// P', Xp', xal', Rb', rsz', degP2 (R, U) and n_full (R,).
int bitset_lemma8_reduce(const void* a_rows, const void* x_rows,
                         const void* p, const void* xp, const void* xal,
                         const void* rb, const void* rsz, void* p_out,
                         void* xp_out, void* xal_out, void* rb_out,
                         void* rsz_out, void* deg_out, void* n_full_out,
                         long long R, int U, int XC, int XCW, int W,
                         void* stream) {
  FrameArgs a{};
  a.a = static_cast<const uint32_t*>(a_rows);
  a.x_rows = static_cast<const uint32_t*>(x_rows);
  a.p = static_cast<const uint32_t*>(p);
  a.xp = static_cast<const uint32_t*>(xp);
  a.xal = static_cast<const uint32_t*>(xal);
  a.rb = static_cast<const uint32_t*>(rb);
  a.rsz = static_cast<const int32_t*>(rsz);
  a.p_out = static_cast<uint32_t*>(p_out);
  a.xp_out = static_cast<uint32_t*>(xp_out);
  a.xal_out = static_cast<uint32_t*>(xal_out);
  a.rb_out = static_cast<uint32_t*>(rb_out);
  a.rsz_out = static_cast<int32_t*>(rsz_out);
  a.deg_out = static_cast<int32_t*>(deg_out);
  a.n_full_out = static_cast<int32_t*>(n_full_out);
  a.R = R;
  a.U = U;
  a.XC = XC;
  a.XCW = XCW;
  a.W = W;
  return launch_frame<true>(a, static_cast<cudaStream_t>(stream));
}

// The pivot select: reads A, the X0 rows, P, Xp, xal and, given (non-null),
// deg (R, U) and n_full (R,); writes B (R, W). `density` is the hybrid
// switch's threshold as float32.
int bitset_pivot_select(const void* a_rows, const void* x_rows, const void* p,
                        const void* xp, const void* xal, const void* deg,
                        const void* n_full, void* b_out, long long R, int U,
                        int XC, int XCW, int W, int revised, int hybrid,
                        float density, void* stream) {
  FrameArgs a{};
  a.a = static_cast<const uint32_t*>(a_rows);
  a.x_rows = static_cast<const uint32_t*>(x_rows);
  a.p = static_cast<const uint32_t*>(p);
  a.xp = static_cast<const uint32_t*>(xp);
  a.xal = static_cast<const uint32_t*>(xal);
  a.deg = static_cast<const int32_t*>(deg);
  a.n_full = static_cast<const int32_t*>(n_full);
  a.p_out = static_cast<uint32_t*>(b_out);
  a.R = R;
  a.U = U;
  a.XC = XC;
  a.XCW = XCW;
  a.W = W;
  a.revised = revised;
  a.hybrid = hybrid;
  a.density = density;
  return launch_frame<false>(a, static_cast<cudaStream_t>(stream));
}

int bitset_frame_step(const void* rows, const void* p, const void* xp,
                      const void* wrow, void* childp, void* childxp,
                      void* deg, void* partner, long long R, int K, int W,
                      void* stream) {
  StepArgs a{};
  a.rows = static_cast<const uint32_t*>(rows);
  a.p = static_cast<const uint32_t*>(p);
  a.xp = static_cast<const uint32_t*>(xp);
  a.wrow = static_cast<const uint32_t*>(wrow);
  a.childp = static_cast<uint32_t*>(childp);
  a.childxp = static_cast<uint32_t*>(childxp);
  a.deg = static_cast<int32_t*>(deg);
  a.partner = static_cast<int32_t*>(partner);
  a.R = R;
  a.K = K;
  a.W = W;
  return launch_frame_step(a, static_cast<cudaStream_t>(stream));
}

// The branch half of a DFS step: reads A, the X0 rows, the stack's slot
// max(depth, 0) (P, B, Xp, Rb, rsz, xal; D slots), live and, non-null, w
// ('rcd'); writes has_branch, the child frame's P, Xp, Rb, xal and rsz,
// deg and partner (R, U), and the slot's P, Xp and (w null) B in place.
int bitset_branch_step(const void* a_rows, const void* x_rows, void* sp,
                       void* sb, void* sxp, const void* srb,
                       const void* srsz, const void* sxal, const void* depth,
                       const void* live, const void* w, void* has_branch,
                       void* childp, void* childxp, void* childxal,
                       void* childrb, void* child_rsz, void* deg,
                       void* partner, long long R, int U, int XC, int XCW,
                       int W, int D, void* stream) {
  BranchArgs a{};
  a.a = static_cast<const uint32_t*>(a_rows);
  a.x_rows = static_cast<const uint32_t*>(x_rows);
  a.sp = static_cast<uint32_t*>(sp);
  a.sb = static_cast<uint32_t*>(sb);
  a.sxp = static_cast<uint32_t*>(sxp);
  a.srb = static_cast<const uint32_t*>(srb);
  a.srsz = static_cast<const int32_t*>(srsz);
  a.sxal = static_cast<const uint32_t*>(sxal);
  a.depth = static_cast<const long long*>(depth);
  a.live = static_cast<const uint8_t*>(live);
  a.w = static_cast<const int32_t*>(w);
  a.has_branch = static_cast<uint8_t*>(has_branch);
  a.childp = static_cast<uint32_t*>(childp);
  a.childxp = static_cast<uint32_t*>(childxp);
  a.childxal = static_cast<uint32_t*>(childxal);
  a.childrb = static_cast<uint32_t*>(childrb);
  a.child_rsz = static_cast<int32_t*>(child_rsz);
  a.deg = static_cast<int32_t*>(deg);
  a.partner = static_cast<int32_t*>(partner);
  a.R = R;
  a.U = U;
  a.XC = XC;
  a.XCW = XCW;
  a.W = W;
  a.D = D;
  return launch_branch(a, static_cast<cudaStream_t>(stream));
}

// `threads`: the census block's threads, 0 for census_threads' choice.
int bitset_clique_counts(const void* rows, const void* mask, const void* in_p,
                         const void* in_x, void* n_full, void* n_dom,
                         long long R, int K, int W, int threads,
                         void* stream) {
  CensusArgs a{};
  a.rows = static_cast<const uint32_t*>(rows);
  a.mask = static_cast<const uint32_t*>(mask);
  a.in_p = static_cast<const uint8_t*>(in_p);
  a.in_x = static_cast<const uint8_t*>(in_x);
  a.n_full = static_cast<int32_t*>(n_full);
  a.n_dom = static_cast<int32_t*>(n_dom);
  a.K = K;
  a.U = K;
  a.W = W;
  return launch_census<false>(a, R, threads, vector_rows(W, rows),
                              static_cast<cudaStream_t>(stream));
}

// The hybrid census: A (R, U, W) and the X0 rows (R, XC, W) where they lie,
// P and Xp (R, W), x_alive (R, XCW) bits; writes n_full, n_dom and |P|.
int bitset_hybrid_census(const void* a_rows, const void* x_rows,
                         const void* p, const void* xp, const void* x_alive,
                         void* n_full, void* n_dom, void* psize, long long R,
                         int U, int XC, int XCW, int W, int threads,
                         void* stream) {
  CensusArgs a{};
  a.rows = static_cast<const uint32_t*>(a_rows);
  a.x_rows = static_cast<const uint32_t*>(x_rows);
  a.mask = static_cast<const uint32_t*>(p);
  a.xp = static_cast<const uint32_t*>(xp);
  a.x_alive = static_cast<const uint32_t*>(x_alive);
  a.n_full = static_cast<int32_t*>(n_full);
  a.n_dom = static_cast<int32_t*>(n_dom);
  a.psize = static_cast<int32_t*>(psize);
  a.K = U + XC;
  a.U = U;
  a.XC = XC;
  a.XCW = XCW;
  a.W = W;
  const bool vec_ok = vector_rows(W, a_rows) && vector_rows(W, x_rows);
  return launch_census<true>(a, R, threads, vec_ok,
                             static_cast<cudaStream_t>(stream));
}

int bitset_and_popcount_many(const void* rows, const void* masks, void* out,
                             long long R, int K, int M, int W, void* stream) {
  return launch_many(rows, masks, out, R, K, M, W,
                     static_cast<cudaStream_t>(stream));
}

// The rcd maximality test: reads A, the X0 rows, P, Xp and xal; writes
// blocked (R,) and |P| (R,).
int bitset_rcd_dominated(const void* a_rows, const void* x_rows,
                         const void* p, const void* xp, const void* xal,
                         void* blocked, void* psize, long long R, int U,
                         int XC, int XCW, int W, void* stream) {
  DomArgs a{};
  a.a = static_cast<const uint32_t*>(a_rows);
  a.x_rows = static_cast<const uint32_t*>(x_rows);
  a.p = static_cast<const uint32_t*>(p);
  a.xp = static_cast<const uint32_t*>(xp);
  a.xal = static_cast<const uint32_t*>(xal);
  a.blocked = static_cast<uint8_t*>(blocked);
  a.psize = static_cast<int32_t*>(psize);
  a.R = R;
  a.U = U;
  a.XC = XC;
  a.XCW = XCW;
  a.W = W;
  return launch_dominated(a, static_cast<cudaStream_t>(stream));
}


// Bytes of one lane's shared-memory region (WinLayout), at most INT_MAX.
int bitset_window_lane_bytes(int U, int XC, int T, int W, int group,
                             int staged) {
  const long long n = WinLayout(U, XC, T, W, group, staged != 0).bytes;
  return static_cast<int>(n < 0x7fffffffll ? n : 0x7fffffffll);
}

// The launch geometry (group, lanes_per_block, staged, index_bits, packed)
// comes from ops.py::window_geometry; a geometry this file cannot run is
// refused (cudaErrorInvalidValue), never computed some other way. Rows
// read from device memory (staged = 0) take group 1.
int bitset_dfs_step_window(const void* a, const void* x_rows,
                           const void* alive0, const void* win_p,
                           const void* win_b, const void* win_xp,
                           const void* win_rb, const void* win_rsz,
                           const void* dloc, void* out_p, void* out_b,
                           void* out_xp, void* out_rb, void* out_rsz,
                           void* ctl, long long L, int U, int XC, int T,
                           int W, int steps, int group, int lanes_per_block,
                           int staged, int index_bits, int packed,
                           void* stream) {
  if ((group != 1 && group != 2 && group != 4) ||
      (staged == 0 && group != 1) || lanes_per_block < 1 ||
      32 * group * lanes_per_block > kWinMaxThreads || index_bits < 1 ||
      index_bits > 31 || (1ll << index_bits) <= (U > XC ? U : XC) ||
      (packed && bit_length(32ll * W + 1) + index_bits > 32) ||
      (L + lanes_per_block - 1) / lanes_per_block > 0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem =
      WinLayout(U, XC, T, W, group, staged != 0).bytes * lanes_per_block;
  if (smem > kWinSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  WinArgs args;
  args.a = static_cast<const uint32_t*>(a);
  args.x_rows = static_cast<const uint32_t*>(x_rows);
  args.alive0 = static_cast<const int32_t*>(alive0);
  args.win[0] = static_cast<const uint32_t*>(win_p);
  args.win[1] = static_cast<const uint32_t*>(win_b);
  args.win[2] = static_cast<const uint32_t*>(win_xp);
  args.win[3] = static_cast<const uint32_t*>(win_rb);
  args.win_rsz = static_cast<const int32_t*>(win_rsz);
  args.dloc = static_cast<const int32_t*>(dloc);
  args.out[0] = static_cast<uint32_t*>(out_p);
  args.out[1] = static_cast<uint32_t*>(out_b);
  args.out[2] = static_cast<uint32_t*>(out_xp);
  args.out[3] = static_cast<uint32_t*>(out_rb);
  args.out_rsz = static_cast<int32_t*>(out_rsz);
  args.ctl = static_cast<int32_t*>(ctl);
  args.L = L;
  args.U = U;
  args.XC = XC;
  args.T = T;
  args.W = W;
  args.steps = steps;
  args.lanes_per_block = lanes_per_block;
  args.lane_bytes = static_cast<int>(smem / lanes_per_block);
  args.index_bits = index_bits;
  args.packed = packed;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged == 0) return launch_window<0, 1, false>(args, smem, s);
  switch (W) {
    case 1:
      return launch_window_w<1>(args, group, smem, s);
    case 2:
      return launch_window_w<2>(args, group, smem, s);
    case 3:
      return launch_window_w<3>(args, group, smem, s);
    case 4:
      return launch_window_w<4>(args, group, smem, s);
    default:
      return launch_window_w<0>(args, group, smem, s);
  }
}

}  // extern "C"
