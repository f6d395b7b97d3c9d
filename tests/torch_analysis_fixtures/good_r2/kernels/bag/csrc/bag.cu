// A bag backward: each id's row of the table gradient gets its bag's
// gradient added with float atomics, so the output must start at zero.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ void add_row(float* row, const float* g, int D) {
  for (int c = 0; c < D; ++c) atomicAdd(row + c, g[c]);
}

__global__ void bag_bwd_kernel(const float* __restrict__ grad_out,
                               const int32_t* __restrict__ ids,
                               float* __restrict__ grad_table, int B,
                               int D) {
  const int b = blockIdx.x;
  if (b >= B) return;
  float* row = grad_table + static_cast<int64_t>(ids[b]) * D;
  add_row(row, grad_out + b * D, D);
}

__global__ void count_kernel(const int32_t* __restrict__ ids,
                             int32_t* __restrict__ counts, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) atomicAdd(counts + ids[b], 1);
}

}  // namespace

extern "C" {

int bag_bwd(const void* grad_out, const void* ids, void* grad_table, int B,
            int D, void* stream) {
  auto* t = static_cast<float*>(grad_table);
  bag_bwd_kernel<<<B, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad_out), static_cast<const int32_t*>(ids),
      t, B, D);
  return static_cast<int>(cudaGetLastError());
}

int bag_counts(const void* ids, void* counts, int B, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaMemsetAsync(counts, 0, 4 * B, s));
  if (err != 0) return err;
  count_kernel<<<(B + 255) / 256, 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(counts), B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
