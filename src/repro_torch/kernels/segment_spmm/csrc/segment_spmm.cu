// Hopper (sm_90a) kernel for batched dense-adjacency message passing: the
// GNN substrate's aggregation over many small graphs (out[b] = adj[b] @
// x[b]). Plain C entry points, loaded with ctypes by
// repro_torch/kernels/segment_spmm/ops.py; dense_spmm returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Replaces repro/kernels/segment_spmm/kernel.py::dense_spmm
// (src/repro/kernels/segment_spmm/kernel.py:32, body _spmm_kernel :23),
// which runs the batched (N x N) @ (N x F) product on the MXU.
//
// Contract: adj (B, N, N) float32 with rows the destinations and columns
// the sources, x (B, N, F) float32, out (B, N, F) float32; any N and F.
// Each output is a float32 sum over s = 0 .. N-1 in order (FMA).
//
// Bound on an H100 SXM: bytes, and below them the launch. At the molecule
// cell (B = 128 graphs of N = 30 nodes) with F = 128 the function moves
// 4*(B*N*N + 2*B*N*F) bytes, about 4.4 MB: 1.3 us at 3.35 TB/s; its
// 2*B*N*N*F = 29.5 MFLOP are 0.44 us at 67 TFLOP/s on the CUDA cores.
// Why not tensor cores: the contract is float32 within 1e-5 of the plain
// version, which TF32 (10-bit mantissa) misses, and the arithmetic is
// already under the launch.
//
// Design: fewer instructions between the launch and the stores, so that
// the launch is most of the time.
// - A block owns destination rows of one graph (all N of them at the
//   molecule cell) and up to 128 feature columns, so B = 128 graphs are
//   128 blocks, one wave on 132 SMs. A thread owns one group of 4
//   neighbouring columns in RPT rows (a template parameter: 1, 2, 4 or 8;
//   4 at the molecule cell), so each float4 of features it reads from
//   shared memory feeds 4*RPT FMAs: with a thread per output group,
//   shared-memory traffic cost more than the FMAs. When a few large graphs
//   would give under 66 blocks (half the SMs), RPT halves instead.
// - Staging: when every run the block copies is 16-byte aligned in address
//   and size (adj[b]'s rows of the block and x[b], or x[b]'s column range
//   row by row), warp 0 issues 1-D bulk copies (cp.async.bulk, the TMA
//   without a tensor map) into dynamic shared memory, completing on one
//   mbarrier; no thread spends loads or address arithmetic on them. At the
//   molecule cell that is two copies a block: adj[b] (3,600 B) and x[b]
//   (15,360 B).
// - When a graph's tile does not fit kOneStageBytes, the block walks the
//   sources in tiles of 32 through a two-stage ring of bulk copies, each
//   stage on its own mbarrier, so the next tile lands while this one is
//   summed. Any N and F run.
// - Where alignment forbids bulk copies (N = 7 with F = 3, an odd N, an F
//   above 128 that is not a multiple of 4), the block loads its tiles with
//   plain loads, eight a thread in flight and float4 feature rows where F
//   allows: a path of the same kernel chosen from the shape on the host
//   (dense_spmm_path reports it), not a fallback on failure.
// - Each thread sums over s = 0 .. N-1 in order with float32 FMA, 4*RPT
//   independent accumulators; the adjacency word is a broadcast within a
//   warp and the features are float4 reads. The sum is bound by the
//   latency of its shared loads (8 warps a block), so the loop over s is
//   unrolled by 8 and carries no per-row test. Stores are float4 when F
//   is a multiple of 4.
// - A bulk copy that has not landed after 60 s traps instead of hanging
//   the card (a trap is sticky: the process's CUDA context is lost).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;               // rows a thread owns, at most
constexpr int kMaxCols = 128;             // feature columns a block owns
constexpr int kDepth = 32;                // sources per ring stage
constexpr int kRingRows = 256;            // destination rows a ring block owns
constexpr long long kMinBlocks = 66;      // half the H100's 132 SMs
constexpr long long kOneStageBytes = 96 * 1024;
constexpr int kSmemMax = 232448;          // 227 KB: a block's shared memory
constexpr int kBarBytes = 16;             // two mbarriers
constexpr unsigned long long kWaitNs = 60ull * 1000 * 1000 * 1000;

// How a launch cuts the work and stages it (the host computes it from the
// shape and the two input addresses; the kernel takes it by value).
struct Plan {
  int N, F;
  int cols;        // feature columns a block owns (fewer in the last chunk)
  int chunks;      // ceil(F / cols)
  int groups;      // ceil(cols / 4): column groups of a block row
  int sets;        // kThreads / groups: threads of one column group
  int rpt;         // rows a thread owns: 1, 2, 4 or 8
  int rows;        // destination rows a block owns (fewer in the last tile)
  int row_tiles;   // ceil(N / rows)
  int depth;       // sources per stage: N for one stage, else kDepth
  int stages;      // 1, or 2 for the ring
  int a_stride;    // shared row stride of the adjacency tile (floats)
  int x_stride;    // shared row stride of the feature tile (floats)
  int a_floats;    // the adjacency tile's floats, a multiple of 4
  int stage_floats;
  int bulk;        // 1: bulk copies on mbarriers; 0: plain loads
  int x_vec;       // plain loads: x's rows 16-byte aligned (float4 loads)
  long long smem;  // dynamic shared memory bytes
};

long long round4(long long n) { return (n + 3) & ~3ll; }

Plan make_plan(const void* adj, const void* x, long long B, int N, int F) {
  Plan p{};
  p.N = N;
  p.F = F;
  p.cols = F <= kMaxCols ? F : kMaxCols;
  p.chunks = (F + p.cols - 1) / p.cols;
  p.groups = (p.cols + 3) / 4;
  p.sets = kThreads / p.groups;
  p.x_stride = p.cols == F ? F : static_cast<int>(round4(p.cols));
  // rows a thread owns: enough for all N rows, halved while the grid would
  // fill under half the SMs (a few large graphs), at least 1
  int rpt = 1;
  while (rpt < kMaxRows && rpt * p.sets < N) rpt *= 2;
  auto blocks = [&](int r) {
    const long long rows = static_cast<long long>(r) * p.sets;
    return B * ((N + rows - 1) / rows) * p.chunks;
  };
  while (rpt > 1 && blocks(rpt) < kMinBlocks) rpt /= 2;
  int rows = N < rpt * p.sets ? N : rpt * p.sets;
  const long long one_a = round4(static_cast<long long>(rows) * N);
  const long long one =
      kBarBytes + 4 * (one_a + static_cast<long long>(N) * p.x_stride);
  if (one <= kOneStageBytes) {
    p.depth = N;
    p.stages = 1;
    p.a_stride = N;
    p.a_floats = static_cast<int>(one_a);
  } else {
    rows = rows < kRingRows ? rows : kRingRows;
    p.depth = kDepth;
    p.stages = 2;
    p.a_stride = kDepth;
    p.a_floats = rows * kDepth;
  }
  p.rows = rows;
  p.rpt = 1;
  while (p.rpt * p.sets < rows) p.rpt *= 2;
  p.row_tiles = (N + rows - 1) / rows;
  p.stage_floats = p.a_floats + p.depth * p.x_stride;
  p.smem = kBarBytes + 4ll * p.stages * p.stage_floats;
  // every run a block copies is 16-byte aligned in address and size:
  // adjacency runs start at b*N*N + d0*N (one stage: rows*N floats) or
  // b*N*N + d*N + s0 (the ring: 32 floats); feature runs at b*N*F + s0*F
  // (all F columns) or b*N*F + s*F + f0 (a column range)
  const bool aligned = reinterpret_cast<uintptr_t>(adj) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long n = N, f = F;
  const bool a_ok = p.stages == 1 ? (n * n) % 4 == 0 && (rows * n) % 4 == 0
                                  : n % 4 == 0;
  const bool x_ok = p.cols == F ? (n * f) % 4 == 0 : f % 4 == 0;
  p.bulk = aligned && a_ok && x_ok;
  p.x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && f % 4 == 0;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

// `bytes` (a multiple of 16) from 16-byte aligned device memory into
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The block's share of one graph: destination rows [d0, d0 + rw) and
// feature columns [f0, f0 + cw) of graph b.
struct Tile {
  const float* A;   // adj[b]
  const float* X;   // x[b]
  int d0, rw, f0, cw;
};

// Warp 0 stages source tile t (sources [s0, s0 + sw)) by bulk copies on
// `bar`: lane 0 arms the barrier with the tile's bytes, then the lanes
// issue the runs.
__device__ void issue_tile(const Plan& p, const Tile& tl, int t, float* sa,
                           uint64_t* bar) {
  const int lane = threadIdx.x;
  const int s0 = t * p.depth;
  const int sw = min(p.depth, p.N - s0);
  float* sx = sa + p.a_floats;
  if (lane == 0) {
    mbar_expect_tx(bar, 4u * (tl.rw * sw + sw * tl.cw));
  }
  __syncwarp();
  if (p.stages == 1) {       // the block's rows, all sources: one run
    if (lane == 0) {
      bulk_load(sa, tl.A + static_cast<int64_t>(tl.d0) * p.N,
                4u * tl.rw * p.N, bar);
    }
  } else {
    for (int r = lane; r < tl.rw; r += 32) {
      bulk_load(sa + r * p.a_stride,
                tl.A + static_cast<int64_t>(tl.d0 + r) * p.N + s0, 4u * sw,
                bar);
    }
  }
  if (p.cols == p.F) {       // every column: one run of sw rows
    if (lane == 0) {
      bulk_load(sx, tl.X + static_cast<int64_t>(s0) * p.F, 4u * sw * p.F,
                bar);
    }
  } else {
    for (int s = lane; s < sw; s += 32) {
      bulk_load(sx + s * p.x_stride,
                tl.X + static_cast<int64_t>(s0 + s) * p.F + tl.f0,
                4u * tl.cw, bar);
    }
  }
}

// A rows x cols block of `src` (row stride ld) into `dst` (row stride
// dst_ld) by all threads, kBatch loads a thread in flight at a time. T is
// float, or float4 where the rows are 16-byte aligned (lengths then count
// float4s).
template <typename T>
__device__ void load_block(float* dst, int dst_ld, const float* src,
                           int64_t ld, int rows, int cols) {
  constexpr int kBatch = 8;
  const int n = rows * cols;
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    T v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      if (e < n) {
        const int r = e / cols, c = e - r * cols;
        at[j] = r * dst_ld + c;
        v[j] = __ldg(s + r * ld + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (e0 + j * kThreads < n) d[at[j]] = v[j];
    }
  }
}

// All threads load source tile t with plain loads (shapes or addresses
// that bulk copies refuse); feature rows as float4 where F allows.
template <bool VEC>
__device__ void load_tile(const Plan& p, const Tile& tl, int t, float* sa) {
  const int s0 = t * p.depth;
  const int sw = min(p.depth, p.N - s0);
  load_block<float>(sa, p.a_stride,
                    tl.A + static_cast<int64_t>(tl.d0) * p.N + s0, p.N,
                    tl.rw, sw);
  const float* xs = tl.X + static_cast<int64_t>(s0) * p.F + tl.f0;
  if (VEC && p.x_vec) {
    load_block<float4>(sa + p.a_floats, p.x_stride / 4, xs, p.F / 4, sw,
                       tl.cw / 4);
  } else {
    load_block<float>(sa + p.a_floats, p.x_stride, xs, p.F, sw, tl.cw);
  }
}

// VEC: F is a multiple of 4, so shared feature rows and output rows take
// float4 accesses. RPT: rows a thread owns (Plan::rpt). BULK: Plan::bulk
// (an instance of its own, so that the plain loads' registers do not
// weigh on the bulk path).
template <bool VEC, int RPT, bool BULK>
__global__ void __launch_bounds__(kThreads)
dense_spmm_kernel(const float* __restrict__ adj, const float* __restrict__ x,
                  float* __restrict__ out, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* stage0 = reinterpret_cast<float*>(smem + kBarBytes);
  int blk = blockIdx.x;
  const int chunk = blk % p.chunks;
  blk /= p.chunks;
  const int rtile = blk % p.row_tiles;
  const int64_t b = blk / p.row_tiles;
  Tile tl;
  tl.A = adj + b * p.N * static_cast<int64_t>(p.N);
  tl.X = x + b * p.N * static_cast<int64_t>(p.F);
  tl.d0 = rtile * p.rows;
  tl.rw = min(p.rows, p.N - tl.d0);
  tl.f0 = chunk * p.cols;
  tl.cw = min(p.cols, p.F - tl.f0);
  const int n_tiles = (p.N + p.depth - 1) / p.depth;

  if constexpr (BULK) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < p.stages; ++s) mbar_init(bars + s);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int t = 0; t < p.stages && t < n_tiles; ++t) {
        issue_tile(p, tl, t, stage0 + t * p.stage_floats, bars + t);
      }
    }
  }

  // this thread's outputs: columns 4g .. 4g + 3 of the chunk in rows
  // rs + j * sets, j < RPT
  const int g = threadIdx.x % p.groups;
  const int rs = threadIdx.x / p.groups;
  const int col = 4 * g;
  const bool active = rs < p.sets && col < tl.cw;
  int nrows = 0;                          // rows of this tile it owns
  int aoff[RPT];                          // their adjacency rows, clamped
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = rs + j * p.sets;
    nrows += r < tl.rw;
    aoff[j] = (r < tl.rw ? r : tl.rw - 1) * p.a_stride;
  }
  float4 acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % p.stages;
    const float* sa = stage0 + st * p.stage_floats;
    const float* sx = sa + p.a_floats + col;
    const int sw = min(p.depth, p.N - t * p.depth);
    if constexpr (BULK) {
      mbar_wait(bars + st, (t / p.stages) & 1);
    } else {
      load_tile<VEC>(p, tl, t, stage0 + st * p.stage_floats);
      __syncthreads();
    }
    if (active) {
      // unrolled so that several sources' shared loads are in flight: the
      // sum is bound by their latency, with 8 warps a block; rows past
      // the tile repeat its last row and are not stored
#pragma unroll 8
      for (int s = 0; s < sw; ++s) {
        const float* xs = sx + s * p.x_stride;
        float4 v;
        if constexpr (VEC) {
          v = *reinterpret_cast<const float4*>(xs);
        } else {
          v.x = xs[0];
          v.y = col + 1 < tl.cw ? xs[1] : 0.f;
          v.z = col + 2 < tl.cw ? xs[2] : 0.f;
          v.w = col + 3 < tl.cw ? xs[3] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float a = sa[aoff[j] + s];
          acc[j].x = fmaf(a, v.x, acc[j].x);
          acc[j].y = fmaf(a, v.y, acc[j].y);
          acc[j].z = fmaf(a, v.z, acc[j].z);
          acc[j].w = fmaf(a, v.w, acc[j].w);
        }
      }
    }
    if (t + 1 < n_tiles) {
      __syncthreads();       // every thread is done with this stage
      if (BULK && threadIdx.x < 32 && t + p.stages < n_tiles) {
        issue_tile(p, tl, t + p.stages, stage0 + st * p.stage_floats,
                   bars + st);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    if (j >= nrows) break;
    float* o = out + (b * p.N + tl.d0 + rs + j * p.sets) *
                         static_cast<int64_t>(p.F) + tl.f0 + col;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(o) = acc[j];
    } else {
      o[0] = acc[j].x;
      if (col + 1 < tl.cw) o[1] = acc[j].y;
      if (col + 2 < tl.cw) o[2] = acc[j].z;
      if (col + 3 < tl.cw) o[3] = acc[j].w;
    }
  }
}

template <bool VEC, int RPT, bool BULK>
cudaError_t launch(const float* adj, const float* x, float* out, long long B,
                   const Plan& p, cudaStream_t stream) {
  static bool opted_in = false;   // above 48 KB needs the attribute, once
  if (p.smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_spmm_kernel<VEC, RPT, BULK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const long long blocks = B * p.row_tiles * p.chunks;
  if (blocks > 0x7fffffffll || p.smem > kSmemMax) return cudaErrorInvalidValue;
  dense_spmm_kernel<VEC, RPT, BULK><<<static_cast<unsigned>(blocks),
                                      kThreads, p.smem, stream>>>(adj, x,
                                                                  out, p);
  return cudaGetLastError();
}

template <bool VEC, bool BULK>
cudaError_t launch_rows(const float* adj, const float* x, float* out,
                        long long B, const Plan& p, cudaStream_t stream) {
  switch (p.rpt) {
    case 1:
      return launch<VEC, 1, BULK>(adj, x, out, B, p, stream);
    case 2:
      return launch<VEC, 2, BULK>(adj, x, out, B, p, stream);
    case 4:
      return launch<VEC, 4, BULK>(adj, x, out, B, p, stream);
    default:
      return launch<VEC, kMaxRows, BULK>(adj, x, out, B, p, stream);
  }
}

template <bool VEC>
cudaError_t launch_path(const float* adj, const float* x, float* out,
                        long long B, const Plan& p, cudaStream_t stream) {
  return p.bulk ? launch_rows<VEC, true>(adj, x, out, B, p, stream)
                : launch_rows<VEC, false>(adj, x, out, B, p, stream);
}

}  // namespace

extern "C" {

int dense_spmm(const void* adj, const void* x, void* out, long long B, int N,
               int F, void* stream) {
  const Plan p = make_plan(adj, x, B, N, F);
  const auto a = static_cast<const float*>(adj);
  const auto xf = static_cast<const float*>(x);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = F % 4 == 0 ? launch_path<true>(a, xf, o, B, p, s)
                                     : launch_path<false>(a, xf, o, B, p, s);
  return static_cast<int>(err);
}

// The path dense_spmm takes for these inputs: bit 0 bulk copies (else
// plain loads), bit 1 the two-stage ring (else one stage), bit 2 float4
// rows (F a multiple of 4), bits 4-7 the rows a thread owns; bits 8 and up
// the blocks per graph.
int dense_spmm_path(const void* adj, const void* x, long long B, int N,
                    int F) {
  const Plan p = make_plan(adj, x, B, N, F);
  return p.bulk | (p.stages == 2) << 1 | (F % 4 == 0) << 2 | p.rpt << 4 |
         (p.row_tiles * p.chunks) << 8;
}

}  // extern "C"
