// Hopper (sm_90a) kernel for the per-edge common-neighbour test (the
// Lemma-4 triangle test of the paper's non-triangle edge reduction).
// Plain C entry point, loaded with ctypes by
// repro_torch/kernels/common_neighbor/ops.py; it returns cudaGetLastError()
// so the wrapper can raise on a refused launch.
//
// Replaces repro/kernels/common_neighbor/kernel.py::has_common_neighbor
// (src/repro/kernels/common_neighbor/kernel.py:30, body _cn_kernel :20).
// The TPU kernel compares a whole (BE, D, D) tile of entry pairs on the
// VPU; that dense compare is not carried over.
//
// Contract: adj_u, adj_v are (E, D) int32 rows, -1 marks padding, and -1
// may sit anywhere in a row (the reference neither sorts nor tail-pads), so
// no merge or binary search: every real entry of one row is compared with
// every real entry of the other until a match is found.
//
// Bound on an H100 SXM: bytes. The function must read both gathered rows,
// 2*E*D*4 bytes (519 MB at the Graph500 scale-12 width, E = 48,597 and
// D = 1,336: 0.155 ms at 3.35 TB/s); the compares of real pairs, at most
// sum deg(u)*deg(v) = 1.23e9 there, are a tenth of that time at the card's
// 67 T/s non-tensor rate.
//
// Design: one warp per edge. A first pass counts each row's real entries
// (ballot + popc). The row with fewer real entries is compacted into the
// warp's slice of shared memory (kTile entries at a time); the lanes then
// sweep the other row 32 entries at a time, each lane comparing its entry
// with the staged ones (a broadcast read), skipping 32-entry chunks with no
// real entry, and the warp stops at the first chunk where __any_sync finds
// a match: 95 % of the scale-12 graph's edges lie in a triangle. Each row
// is read twice (count, then stage or sweep); the second read is meant to
// hit L1/L2. Output: one byte per edge (torch.bool), bit-exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // edges per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;               // staged entries per warp (4 KB)
constexpr unsigned kFull = 0xffffffffu;

__device__ int count_real(const int32_t* __restrict__ row, int D, int lane) {
  int n = 0;
  for (int j0 = 0; j0 < D; j0 += 32) {
    const int j = j0 + lane;
    n += __popc(__ballot_sync(kFull, j < D && row[j] >= 0));
  }
  return n;
}

__global__ void __launch_bounds__(kThreads)
has_common_neighbor_kernel(const int32_t* __restrict__ adj_u,
                           const int32_t* __restrict__ adj_v,
                           uint8_t* __restrict__ out, int64_t E, int D) {
  __shared__ int32_t tiles[kWarps][kTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (e >= E) return;                     // the whole warp leaves together
  const int32_t* u = adj_u + e * D;
  const int32_t* v = adj_v + e * D;
  const int nu = count_real(u, D, lane);
  const int nv = count_real(v, D, lane);
  const int32_t* staged = nu <= nv ? u : v;
  const int32_t* swept = nu <= nv ? v : u;
  const int ns = nu <= nv ? nu : nv;
  int32_t* tile = tiles[warp];
  const unsigned below = (1u << lane) - 1u;
  bool hit = false;                       // uniform across the warp
  for (int t0 = 0; t0 < ns && !hit; t0 += kTile) {
    // real entries t0 .. t0 + kTile - 1 of the staged row, in row order
    int base = 0;
    for (int j0 = 0; j0 < D && base < t0 + kTile; j0 += 32) {
      const int j = j0 + lane;
      const int32_t x = j < D ? staged[j] : -1;
      const unsigned m = __ballot_sync(kFull, x >= 0);
      const int pos = base + __popc(m & below);
      if (x >= 0 && pos >= t0 && pos < t0 + kTile) tile[pos - t0] = x;
      base += __popc(m);
    }
    __syncwarp();
    const int nt = min(kTile, ns - t0);
    for (int j0 = 0; j0 < D; j0 += 32) {
      const int j = j0 + lane;
      const int32_t x = j < D ? swept[j] : -1;
      if (!__any_sync(kFull, x >= 0)) continue;
      bool mine = false;
      if (x >= 0) {
        for (int k = 0; k < nt; ++k) {
          if (tile[k] == x) {
            mine = true;
            break;
          }
        }
      }
      if (__any_sync(kFull, mine)) {
        hit = true;
        break;
      }
    }
    __syncwarp();                         // the next tile overwrites it
  }
  if (lane == 0) out[e] = hit ? 1 : 0;
}

}  // namespace

extern "C" {

int common_neighbor_has_common(const void* adj_u, const void* adj_v,
                               void* out, long long E, int D, void* stream) {
  const long long blocks = (E + kWarps - 1) / kWarps;
  has_common_neighbor_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj_u), static_cast<const int32_t*>(adj_v),
      static_cast<uint8_t*>(out), E, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
