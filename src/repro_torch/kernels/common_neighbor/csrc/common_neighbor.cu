// Hopper (sm_90a) kernels for the per-edge common-neighbour test (the
// Lemma-4 triangle test of the paper's non-triangle edge reduction).
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/common_neighbor/ops.py; each returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Replaces repro/kernels/common_neighbor/kernel.py::has_common_neighbor
// (src/repro/kernels/common_neighbor/kernel.py:30, body _cn_kernel :20).
// The TPU kernel compares a whole (BE, D, D) tile of entry pairs on the
// VPU; that dense compare is not carried over.
//
// Contract: rows of D int32 entries; every negative entry is padding (not
// only -1) and may sit anywhere in a row, real entries are any int32 >= 0,
// duplicates allowed, no maximum D. Output: one byte per edge (torch.bool),
// bit-exact against the all-pairs formula.
//
// Bound on an H100 SXM: bytes, counted from the data. On rows gathered
// beforehand any design must read, for an edge whose rows share an entry,
// the two entries that show it (a 32-byte sector of each row), and for an
// edge whose rows share none, both rows whole: at the Graph500 scale-12
// width (E = 48,597, D = 1,336; 95 % of edges in a triangle) 27 MB, 0.0082
// ms at 3.35 TB/s, against 2*E*D*4 = 519 MB (0.155 ms) for both rows whole.
// The entry point on the padded (N, D) table need read the table once at
// most (N*D*4 = 21.9 MB at scale 12, 235 MB at scale 14).
//
// Design: one row's real entries are staged into an open-addressing hash
// set in shared memory (a power of two of slots, load factor <= 1/2,
// linear probing, -1 empty, atomicCAS inserts so duplicates stay single; a
// lane's four first probes, inserts or lookups, go out together), read in
// 16-byte vector loads (V a lane in flight; batches past a row's known
// count or end are skipped team-uniformly); the other row is swept in
// 16-byte loads, a vector a lane first and V after, each real entry looked
// up, up to the first batch that holds a match. Each edge goes first to a
// group of L lanes of a warp with a small set of its own, which stages one
// tile of its row (t real entries, half its set) and sweeps the other row
// once: most edges of a Kronecker graph end there, their staged row short
// or a match in the first tile. An edge with no match and real entries
// still unstaged goes on a queue, with where its group stopped. A second
// launch takes the queue, a block of 128 threads an edge with a set of up
// to 4,096 slots: it stages the remaining entries in tiles of T = 2,048
// (on the padded table one tile, sized to the count, where it fits) and
// sweeps the other row once a tile. So an edge's work is deg(a) + deg(b) *
// (1 + ceil(rest / T)) hash operations, rest being what its group left:
// at most deg(a) + 2 deg(b) for every staged row of up to t + T real
// entries (t = 256 on rows gathered beforehand, 32 on the padded table),
// not deg(a) * deg(b) compares. An edge its group decides reads each row
// at most once; a queued edge reads its swept row once more a tile. The
// queue keeps the block-wide code out of the groups' launch, whose
// registers (64 and 48 a thread) set how many edges are in flight: an
// edge's work is a chain of dependent loads and a few random
// shared-memory accesses a lane, so what bounds a launch is how many
// edges are in flight and the shared-memory pipe. Small groups with small
// sets did best (the geometry below; PERF.md lists those tried). Every
// launch keeps under 48 KB of shared memory a block. Rows need no
// alignment: a row's first and last 16-byte blocks, where they stick out
// of the row, are read entry by entry.
//
// Rows gathered beforehand (`common_neighbor_has_common`, two launches:
// the groups, then the queue): no count is known, so the group stages
// adj_u's row and sweeps adj_v's. The entry point on the padded table
// (`common_neighbor_count_real`, `common_neighbor_edges`, then
// `common_neighbor_edges_rest`) reads the rows in place by edge id: a
// first launch counts each table row's real entries (the table read
// once), so that the edge launches stage the row with fewer real entries,
// size its set to that count, and stop reading either row once they have
// seen all its real entries (on a row whose padding is a tail, the real
// entries and no more). Edge ids outside [0, N) are never read through:
// the edge gets false and the edge launch sets status[0] to 1, which the
// wrapper raises on.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Launch geometry: lanes an edge, warps a block, most set slots a group;
// 16-byte vectors a lane loads per batch (more in flight on rows gathered
// beforehand, fewer registers, so more edges in flight, on the padded
// table, whose rows the entry point reads only up to their real entries);
// the queue's launch: warps a block (a block an edge), most set slots.
constexpr int kRowsLanes = 16, kRowsWarps = 2, kRowsSlots = 512;
constexpr int kRowsVecs = 4;
constexpr int kEdgesLanes = 8, kEdgesWarps = 4, kEdgesSlots = 64;
constexpr int kEdgesVecs = 2;
constexpr int kRestWarps = 4, kRestSlots = 4096, kRestVecs = 2;
constexpr int kMinSlots = 64;     // smallest set (a power of two)
constexpr int kCountWarps = 8;    // rows per block of the count launch

// A row: its first entry, its length, and its count of real entries, or
// -1 where that count is unknown.
struct Row {
  const int32_t* p;
  int len;
  int real;
};

// The L lanes of a warp (L a power of two up to 32) that work on one edge.
template <int L>
struct Group {
  static constexpr int kSize = L;
  unsigned mask;   // the group's lanes in the warp
  int lane;        // this lane's place in the group
  __device__ explicit Group(int warp_lane)
      : mask(L == 32 ? 0xffffffffu
                     : ((1u << (L & 31)) - 1) << (warp_lane & ~(L - 1))),
        lane(warp_lane & (L - 1)) {}
  __device__ void sync() const { __syncwarp(mask); }
  __device__ bool any(bool p) const { return __any_sync(mask, p); }
  __device__ int sum(int n) const { return __reduce_add_sync(mask, n); }
};

// The T threads of a block (T a multiple of 32) that work on one edge;
// `red` is T / 32 ints of shared memory.
template <int T>
struct Block {
  static constexpr int kSize = T;
  int lane;
  int* red;
  __device__ void sync() const { __syncthreads(); }
  __device__ bool any(bool p) const { return __syncthreads_or(p) != 0; }
  __device__ int sum(int n) const {
    n = __reduce_add_sync(0xffffffffu, n);
    if ((lane & 31) == 0) red[lane >> 5] = n;
    __syncthreads();
    int t = 0;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) t += red[w];
    __syncthreads();
    return t;
  }
};

// Where the staging of a row stands: its next 16-byte block, and its real
// entries still unstaged (where its count is unknown, its length less the
// real entries staged).
struct Cursor {
  int next;
  int left;
};

// An edge a group of lanes queued: the edge, and where the group stopped
// staging.
struct Queued {
  int64_t e;
  Cursor c;
};

// The entry offset of a row's first entry within its 16-byte block.
__device__ __forceinline__ int head(const int32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ int4 none4() { return make_int4(-1, -1, -1, -1); }

// The row's k-th 16-byte block (entries 4k - o .. 4k - o + 3), with every
// entry outside the row read as -1 and never loaded.
__device__ __forceinline__ int4 load_vec(const int32_t* p, int o, int len,
                                         int k) {
  const int j = 4 * k - o;
  if (j >= 0 && j + 4 <= len)
    return *reinterpret_cast<const int4*>(p + j);
  int4 v;
  v.x = j >= 0 && j < len ? p[j] : -1;
  v.y = j + 1 >= 0 && j + 1 < len ? p[j + 1] : -1;
  v.z = j + 2 >= 0 && j + 2 < len ? p[j + 2] : -1;
  v.w = j + 3 < len ? p[j + 3] : -1;
  return v;
}

__device__ __forceinline__ int real4(int4 v) {
  return (v.x >= 0) + (v.y >= 0) + (v.z >= 0) + (v.w >= 0);
}

// A batch of a row: vectors next + lane + L * i (i < V) of the nv from
// `next`, a lane each; skipped past nv, team-uniformly.
template <int L, int V>
__device__ __forceinline__ void load_batch(int4 (&x)[V], const Row& r, int o,
                                           int next, int nv, int lane) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (L * i < nv)
      x[i] = lane + L * i < nv ? load_vec(r.p, o, r.len, next + lane + L * i)
                               : none4();
}

__device__ __forceinline__ unsigned slot_of(int32_t x, int shift) {
  return (static_cast<unsigned>(x) * 0x9E3779B1u) >> shift;
}

// Insert the real entries of v: the four first probes' atomicCAS in
// flight together, then, for an entry whose first slot held another value,
// linear probing on from there.
__device__ __forceinline__ void insert4(int32_t* set, unsigned mask,
                                        int shift, int4 v) {
  const int32_t x[4] = {v.x, v.y, v.z, v.w};
  unsigned s[4];
  int32_t old[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s[c] = slot_of(x[c], shift);
    old[c] = x[c] >= 0 ? atomicCAS(set + s[c], -1, x[c]) : -1;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (old[c] == -1 || old[c] == x[c]) continue;
    for (unsigned t = (s[c] + 1) & mask;; t = (t + 1) & mask) {
      const int32_t o = atomicCAS(set + t, -1, x[c]);
      if (o == -1 || o == x[c]) break;
    }
  }
}

// Does the set hold a real entry of v? The four first probes' loads in
// flight together, then linear probing on for an entry whose first slot
// held another value.
__device__ __forceinline__ bool contains4(const int32_t* set, unsigned mask,
                                          int shift, int4 v) {
  const int32_t x[4] = {v.x, v.y, v.z, v.w};
  unsigned s[4];
  int32_t y[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s[c] = slot_of(x[c], shift);
    y[c] = x[c] >= 0 ? set[s[c]] : -1;
  }
  bool hit = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (x[c] < 0 || y[c] < 0) continue;
    if (y[c] == x[c]) {
      hit = true;
      continue;
    }
    for (unsigned t = (s[c] + 1) & mask;; t = (t + 1) & mask) {
      const int32_t z = set[t];
      if (z == x[c]) {
        hit = true;
        break;
      }
      if (z < 0) break;
    }
  }
  return hit;
}

__device__ __forceinline__ int next_pow2(int x) {
  return x <= 1 ? 1 : 1 << (32 - __clz(x - 1));
}

// Does row b hold an entry of the set? The team sweeps b's real entries
// (all of them, or its known count), L vectors first, V * L after, and
// stops at the first batch with a match. Every lane of the team returns
// the same answer.
template <int V, class Team>
__device__ bool sweep(const Team& g, const Row& b, const int32_t* set,
                      unsigned mask, int shift) {
  constexpr int L = Team::kSize;
  const int o = head(b.p);
  const int nvec = (o + b.len + 3) >> 2;
  int left = b.real >= 0 ? b.real : b.len;
  for (int next = 0; next < nvec && left > 0;) {
    int nv = min((next == 0 ? 1 : V) * L, nvec - next);
    if (next == 0 && b.real >= 0) nv = min(nv, (o + left + 3) >> 2);
    int4 x[V];
    load_batch<L, V>(x, b, o, next, nv, g.lane);
    bool hit = false;
    int seen = 0;
#pragma unroll
    for (int i = 0; i < V && L * i < nv; ++i) {
      const int r = real4(x[i]);
      if (r) hit |= contains4(set, mask, shift, x[i]);
      seen += r;
    }
    if (g.any(hit)) return true;
    left -= g.sum(seen);
    next += nv;
  }
  return false;
}

// Do rows a and b share a real entry? The team stages a's real entries
// from c on into its set (`max_slots` slots of shared memory) tile by
// tile, at most `tiles` tiles, and sweeps b against each tile. Returns 1
// or 0, the same on every lane of the team, or -1 where `tiles` tiles met
// no match and a has real entries left (c then points past the staged).
template <int V, class Team>
__device__ int rows_meet(const Team& g, const Row& a, const Row& b,
                         Cursor& c, int32_t* set, int max_slots, int tiles) {
  constexpr int L = Team::kSize;
  if (a.real == 0 || b.real == 0) return 0;
  const int o = head(a.p);
  const int nvec = (o + a.len + 3) >> 2;
  // a known count that fits in half the set takes one tile, sized to it
  const bool one_tile = a.real >= 0 && 2 * c.left <= max_slots;
  const int slots = one_tile ? max(kMinSlots, next_pow2(2 * c.left))
                             : max_slots;
  const unsigned mask = slots - 1;
  const int shift = __clz(slots) + 1;        // 32 - log2(slots)
  for (int tile = 0; c.next < nvec && c.left > 0; ++tile) {
    if (tile == tiles) return -1;
    int4* set4 = reinterpret_cast<int4*>(set);
    for (int i = g.lane; i < slots / 4; i += L) set4[i] = none4();
    g.sync();
    int staged = 0;
    while (c.next < nvec && c.left > 0) {
      int nv = min(V * L, nvec - c.next);
      if (c.next == 0 && a.real >= 0) nv = min(nv, (o + c.left + 3) >> 2);
      if (!one_tile) nv = min(nv, (slots / 2 - staged) >> 2);
      if (nv <= 0) break;                    // the tile is full
      int4 x[V];
      load_batch<L, V>(x, a, o, c.next, nv, g.lane);
      int n = 0;
#pragma unroll
      for (int i = 0; i < V && L * i < nv; ++i) {
        const int r = real4(x[i]);
        if (r) insert4(set, mask, shift, x[i]);
        n += r;
      }
      n = g.sum(n);
      staged += n;
      c.left -= n;
      c.next += nv;
    }
    g.sync();
    if (staged > 0 && sweep<V>(g, b, set, mask, shift)) return 1;
    g.sync();                                // the next tile clears the set
  }
  return 0;
}

// Rows gathered beforehand: edge e's group stages adj_u's row (its count
// unknown) in one tile of its own set, and queues the edge where that
// does not decide it. Held to 64 registers a thread (16 blocks a
// multiprocessor), what the group's code takes without a queue.
__global__ void __launch_bounds__(32 * kRowsWarps, 16)
cn_rows_kernel(const int32_t* __restrict__ adj_u,
               const int32_t* __restrict__ adj_v, uint8_t* __restrict__ out,
               int64_t E, int D, int slots, Queued* __restrict__ queue,
               int32_t* __restrict__ queued) {
  constexpr int L = kRowsLanes, G = 32 * kRowsWarps / L;
  extern __shared__ int4 sets[];
  const int group = threadIdx.x / L;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * G + group;
  if (e >= E) return;
  const Group<L> g(threadIdx.x & 31);
  Cursor c{0, D};
  const int hit = rows_meet<kRowsVecs>(
      g, Row{adj_u + e * D, D, -1}, Row{adj_v + e * D, D, -1}, c,
      reinterpret_cast<int32_t*>(sets) + group * slots, slots, 1);
  if (g.lane == 0) {
    if (hit >= 0)
      out[e] = hit;
    else
      queue[atomicAdd(queued, 1)] = Queued{e, c};
  }
}

// The queued edges of rows gathered beforehand, a block an edge.
__global__ void __launch_bounds__(32 * kRestWarps)
cn_rows_rest_kernel(const int32_t* __restrict__ adj_u,
                    const int32_t* __restrict__ adj_v,
                    uint8_t* __restrict__ out, int D, int slots,
                    const Queued* __restrict__ queue,
                    const int32_t* __restrict__ queued) {
  extern __shared__ int4 sets[];
  __shared__ int red[kRestWarps];
  const Block<32 * kRestWarps> b{static_cast<int>(threadIdx.x), red};
  const int n = *queued;
  for (int q = blockIdx.x; q < n; q += gridDim.x) {
    const int64_t e = queue[q].e;
    Cursor c = queue[q].c;
    const int hit = rows_meet<kRestVecs>(
        b, Row{adj_u + e * D, D, -1}, Row{adj_v + e * D, D, -1}, c,
        reinterpret_cast<int32_t*>(sets), slots, INT_MAX);
    if (threadIdx.x == 0) out[e] = hit;
  }
}

__global__ void __launch_bounds__(32 * kCountWarps)
cn_count_kernel(const int32_t* __restrict__ adj, int64_t N, int D,
                int32_t* __restrict__ real, int32_t* __restrict__ status) {
  if (blockIdx.x == 0 && threadIdx.x < 2) status[threadIdx.x] = 0;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kCountWarps
                    + (threadIdx.x >> 5);
  if (r >= N) return;
  const int32_t* p = adj + r * D;
  const int o = head(p);
  const int nvec = (o + D + 3) >> 2;
  int n = 0;
#pragma unroll 4
  for (int k = lane; k < nvec; k += 32) n += real4(load_vec(p, o, D, k));
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0) real[r] = n;
}

// Edge e's rows in the (N, D) table, the one with fewer real entries as a
// (the staged one); false where an id lies outside [0, N).
template <typename Id>
__device__ __forceinline__ bool edge_rows(
    const int32_t* adj, const int32_t* real, int64_t N, int D,
    const Id* edges, int64_t stride_e, int64_t stride_c, int64_t e, Row& a,
    Row& b) {
  const int64_t iu = static_cast<int64_t>(edges[e * stride_e]);
  const int64_t iv = static_cast<int64_t>(edges[e * stride_e + stride_c]);
  if (iu < 0 || iu >= N || iv < 0 || iv >= N) return false;
  const int ru = real[iu], rv = real[iv];
  const Row u{adj + iu * D, D, ru}, v{adj + iv * D, D, rv};
  a = rv < ru ? v : u;
  b = rv < ru ? u : v;
  return true;
}

// The entry point's edge launch: edge e's group stages its shorter row
// in one tile of its own set, and queues the edge where that does not
// decide it (status[1] counts the queue). Held to 48 registers a thread
// (10 blocks a multiprocessor), what the group's code takes without a
// queue.
template <typename Id>
__global__ void __launch_bounds__(32 * kEdgesWarps, 10)
cn_edges_kernel(const int32_t* __restrict__ adj,
                const int32_t* __restrict__ real, int64_t N, int D,
                const Id* __restrict__ edges, int64_t stride_e,
                int64_t stride_c, uint8_t* __restrict__ out, int64_t E,
                int slots, Queued* __restrict__ queue,
                int32_t* __restrict__ status) {
  constexpr int L = kEdgesLanes, G = 32 * kEdgesWarps / L;
  extern __shared__ int4 sets[];
  const int group = threadIdx.x / L;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * G + group;
  if (e >= E) return;
  const Group<L> g(threadIdx.x & 31);
  Row a, b;
  if (!edge_rows(adj, real, N, D, edges, stride_e, stride_c, e, a, b)) {
    if (g.lane == 0) {
      out[e] = 0;
      atomicExch(status, 1);
    }
    return;
  }
  Cursor c{0, a.real};
  const int hit = rows_meet<kEdgesVecs>(
      g, a, b, c, reinterpret_cast<int32_t*>(sets) + group * slots, slots, 1);
  if (g.lane == 0) {
    if (hit >= 0)
      out[e] = hit;
    else
      queue[atomicAdd(status + 1, 1)] = Queued{e, c};
  }
}

// The entry point's queued edges, a block an edge.
template <typename Id>
__global__ void __launch_bounds__(32 * kRestWarps)
cn_edges_rest_kernel(const int32_t* __restrict__ adj,
                     const int32_t* __restrict__ real, int64_t N, int D,
                     const Id* __restrict__ edges, int64_t stride_e,
                     int64_t stride_c, uint8_t* __restrict__ out, int slots,
                     const Queued* __restrict__ queue,
                     const int32_t* __restrict__ status) {
  extern __shared__ int4 sets[];
  __shared__ int red[kRestWarps];
  const Block<32 * kRestWarps> blk{static_cast<int>(threadIdx.x), red};
  const int n = status[1];
  for (int q = blockIdx.x; q < n; q += gridDim.x) {
    const int64_t e = queue[q].e;
    Row a, b;
    edge_rows(adj, real, N, D, edges, stride_e, stride_c, e, a, b);
    Cursor c = queue[q].c;
    const int hit = rows_meet<kRestVecs>(
        blk, a, b, c, reinterpret_cast<int32_t*>(sets), slots, INT_MAX);
    if (threadIdx.x == 0) out[e] = hit;
  }
}

unsigned blocks_of(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

// Set slots a group: at least twice the row width (a power of two from
// kMinSlots), at most `most`; a longer row is staged in tiles.
int group_slots(int D, int most) {
  int s = kMinSlots;
  while (s < most && s < 2LL * D) s *= 2;
  return s;
}

// Blocks of a queue's launch: 16 a multiprocessor, at most one an edge.
unsigned rest_blocks(long long E) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<unsigned>(E < 16LL * sms ? E : 16LL * sms);
}

// The entry point's edge launches: the groups, then the queue.
template <typename Id>
int launch_edges(const void* adj, const void* real, long long N, int D,
                 const void* edges, long long stride_e, long long stride_c,
                 void* out, long long E, void* queue, void* status,
                 cudaStream_t stream) {
  constexpr int G = 32 * kEdgesWarps / kEdgesLanes;
  const int slots = group_slots(D, kEdgesSlots);
  cn_edges_kernel<Id><<<blocks_of(E, G), 32 * kEdgesWarps,
                        static_cast<size_t>(G) * slots * 4, stream>>>(
      static_cast<const int32_t*>(adj), static_cast<const int32_t*>(real), N,
      D, static_cast<const Id*>(edges), stride_e, stride_c,
      static_cast<uint8_t*>(out), E, slots, static_cast<Queued*>(queue),
      static_cast<int32_t*>(status));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int rest = group_slots(D, kRestSlots);
  cn_edges_rest_kernel<Id><<<rest_blocks(E), 32 * kRestWarps,
                             static_cast<size_t>(rest) * 4, stream>>>(
      static_cast<const int32_t*>(adj), static_cast<const int32_t*>(real), N,
      D, static_cast<const Id*>(edges), stride_e, stride_c,
      static_cast<uint8_t*>(out), rest, static_cast<const Queued*>(queue),
      static_cast<const int32_t*>(status));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// adj_u, adj_v: (E, D) rows gathered beforehand; E > 0. Two launches: the
// groups, then a block an edge for the edges they queue (`queue`: room
// for E entries of 16 bytes; `queued`: one int32, zeroed here).
int common_neighbor_has_common(const void* adj_u, const void* adj_v,
                               void* out, long long E, int D, void* queue,
                               void* queued, void* stream) {
  constexpr int G = 32 * kRowsWarps / kRowsLanes;
  const auto s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaMemsetAsync(queued, 0, 4, s));
  if (err != 0) return err;
  const int slots = group_slots(D, kRowsSlots);
  cn_rows_kernel<<<blocks_of(E, G), 32 * kRowsWarps,
                   static_cast<size_t>(G) * slots * 4, s>>>(
      static_cast<const int32_t*>(adj_u), static_cast<const int32_t*>(adj_v),
      static_cast<uint8_t*>(out), E, D, slots, static_cast<Queued*>(queue),
      static_cast<int32_t*>(queued));
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int rest = group_slots(D, kRestSlots);
  cn_rows_rest_kernel<<<rest_blocks(E), 32 * kRestWarps,
                        static_cast<size_t>(rest) * 4, s>>>(
      static_cast<const int32_t*>(adj_u), static_cast<const int32_t*>(adj_v),
      static_cast<uint8_t*>(out), D, rest,
      static_cast<const Queued*>(queue),
      static_cast<const int32_t*>(queued));
  return static_cast<int>(cudaGetLastError());
}

// The entry point's first launch: real[r] = the real entries of the (N, D)
// table's row r; zeroes status[0] (ids out of range) and status[1] (edges
// queued).
int common_neighbor_count_real(const void* adj, long long N, int D,
                               void* real, void* status, void* stream) {
  cn_count_kernel<<<blocks_of(N > 0 ? N : 1, kCountWarps), 32 * kCountWarps,
                    0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj), N, D, static_cast<int32_t*>(real),
      static_cast<int32_t*>(status));
  return static_cast<int>(cudaGetLastError());
}

// The entry point's second and third launches: edge e = (edges[e *
// stride_e], edges[e * stride_e + stride_c]), int64 ids if ids64 else
// int32; E > 0; the groups, then a block an edge for the edges they queue
// (`queue`: room for E entries of 16 bytes, counted in status[1]).
int common_neighbor_edges(const void* adj, const void* real, long long N,
                          int D, const void* edges, int ids64,
                          long long stride_e, long long stride_c, void* out,
                          long long E, void* queue, void* status,
                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return ids64 ? launch_edges<int64_t>(adj, real, N, D, edges, stride_e,
                                       stride_c, out, E, queue, status, s)
               : launch_edges<int32_t>(adj, real, N, D, edges, stride_e,
                                       stride_c, out, E, queue, status, s);
}

}  // extern "C"
