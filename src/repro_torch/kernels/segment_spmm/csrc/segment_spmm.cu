// Hopper (sm_90a) kernel for batched dense-adjacency message passing: the
// GNN substrate's aggregation over many small graphs (out[b] = adj[b] @
// x[b]). Plain C entry point, loaded with ctypes by
// repro_torch/kernels/segment_spmm/ops.py; it returns cudaGetLastError()
// so the wrapper can raise on a refused launch.
//
// Replaces repro/kernels/segment_spmm/kernel.py::dense_spmm
// (src/repro/kernels/segment_spmm/kernel.py:32, body _spmm_kernel :23),
// which runs the batched (N x N) @ (N x F) product on the MXU.
//
// Contract: adj (B, N, N) float32 with rows the destinations and columns
// the sources, x (B, N, F) float32, out (B, N, F) float32; any N and F.
// Each output is a float32 sum over s = 0 .. N-1 in order (FMA).
//
// Bound on an H100 SXM: bytes. At the molecule cell (B = 128 graphs of
// N = 30 nodes) with F = 128 the function moves 4*(B*N*N + 2*B*N*F) bytes,
// about 4.4 MB: 1.3 us at 3.35 TB/s, below the few-microsecond launch
// floor; its 2*B*N*N*F = 29.5 MFLOP are 0.44 us at 67 TFLOP/s (float32
// off the tensor cores). So the launch, not the card, bounds it.
//
// Design: one block per (graph, 32-row tile of destinations, 64-column
// tile of features). The block walks the sources in 32-wide tiles: it
// stages the 32 x 32 adjacency tile and the 32 x 64 feature tile in shared
// memory, zero outside N and F, and each of its 256 threads accumulates 8
// outputs of one feature column with float32 FMA (a warp reads one
// adjacency word, broadcast, and 32 neighbouring features). Tiling over N means no limit on N.
// Tensor cores (mma, wgmma) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                 // destinations per block
constexpr int kCols = 64;                 // features per block
constexpr int kDepth = 32;                // sources per staged tile
constexpr int kThreads = 256;
constexpr int kPerThread = kRows * kCols / kThreads;   // 8 outputs

__global__ void __launch_bounds__(kThreads)
dense_spmm_kernel(const float* __restrict__ adj, const float* __restrict__ x,
                  float* __restrict__ out, int N, int F) {
  __shared__ float sa[kRows][kDepth];
  __shared__ float sx[kDepth][kCols];
  const int64_t b = blockIdx.x;
  const int d0 = blockIdx.y * kRows;
  const int f0 = blockIdx.z * kCols;
  const int tx = threadIdx.x % kCols;     // feature column in the tile
  const int ty = threadIdx.x / kCols;     // rows ty, ty + 4, ..., ty + 28
  const float* A = adj + b * N * static_cast<int64_t>(N);
  const float* X = x + b * N * static_cast<int64_t>(F);
  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < N; s0 += kDepth) {
    for (int i = threadIdx.x; i < kRows * kDepth; i += kThreads) {
      const int r = i / kDepth, c = i % kDepth;
      const int d = d0 + r, s = s0 + c;
      sa[r][c] = d < N && s < N ? A[static_cast<int64_t>(d) * N + s] : 0.f;
    }
    for (int i = threadIdx.x; i < kDepth * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const int s = s0 + r, f = f0 + c;
      sx[r][c] = s < N && f < F ? X[static_cast<int64_t>(s) * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kDepth; ++k) {
      const float xv = sx[k][tx];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        acc[i] = fmaf(sa[ty + 4 * i][k], xv, acc[i]);
      }
    }
    __syncthreads();
  }
  const int f = f0 + tx;
  if (f >= F) return;
  float* O = out + b * N * static_cast<int64_t>(F);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int d = d0 + ty + 4 * i;
    if (d < N) O[static_cast<int64_t>(d) * F + f] = acc[i];
  }
}

}  // namespace

extern "C" {

int dense_spmm(const void* adj, const void* x, void* out, long long B, int N,
               int F, void* stream) {
  const dim3 grid(static_cast<unsigned>(B),
                  static_cast<unsigned>((N + kRows - 1) / kRows),
                  static_cast<unsigned>((F + kCols - 1) / kCols));
  dense_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(adj), static_cast<const float*>(x),
      static_cast<float*>(out), N, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
