// Hopper (sm_90a) kernel for the EmbeddingBag sum (the recsys substrate's
// multi-hot gather + bag reduce). Plain C entry point, loaded with ctypes
// by repro_torch/kernels/embedding_bag/ops.py; it returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Replaces repro/kernels/embedding_bag/kernel.py::embedding_bag_sum
// (src/repro/kernels/embedding_bag/kernel.py:47, body _bag_kernel :22).
// The TPU kernel turns the gather into one-hot(ids) @ table GEMMs over
// vocabulary tiles, because the TPU has no fast data-dependent gather
// inside a kernel; that workaround reads every row of the table and is not
// carried over.
//
// Contract: table (V, D) float32, ids (B, L) int32; an id < 0 is padding
// and adds nothing; an id >= V is out of contract and reads row V - 1
// (the reference's jnp gather clamps the same way), so no id ever reads
// outside the table. Sums are float32, slot by slot in order.
//
// Bound on an H100 SXM: bytes. The function must read the ids, the table
// rows the bags name (one row of D floats per real id) and write B*D
// floats; at the two-tower item-history width (V = 2^24, D = 128,
// B = 65,536, L = 32, bags of 1..32 ids) that is about 0.55 GB, 0.17 ms at
// 3.35 TB/s. The adds are D per real id, far below any compute bound.
//
// Design: one warp per bag, lanes across D with 16-byte (float4) loads
// when D is a multiple of 4 and the table 16-byte aligned, else one float
// per lane. A lane loads 32 of the bag's ids at once and the warp walks
// them with __shfl_sync, so every row load is independent of the last and
// the loop can keep several in flight. Row offsets are 64-bit: at V = 2^24,
// D = 128 they reach 2^31.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // bags per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_sum_kernel(const float* __restrict__ table,
                         const int32_t* __restrict__ ids,
                         float* __restrict__ out, int64_t B, int L,
                         int64_t V, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;                     // the whole warp leaves together
  const int32_t* bag = ids + b * L;
  float* dst = out + b * D;
  for (int c0 = 0; c0 < D; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool mine = c < D;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int32_t my_id = l0 + lane < L ? bag[l0 + lane] : -1;
      const int n = L - l0 < 32 ? L - l0 : 32;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const int64_t id = __shfl_sync(kFull, my_id, k);
        if (id < 0 || !mine) continue;
        const float* row = table + (id < V ? id : V - 1) * D + c;
        if constexpr (VEC == 4) {
          const float4 x = *reinterpret_cast<const float4*>(row);
          acc[0] += x.x;
          acc[1] += x.y;
          acc[2] += x.z;
          acc[3] += x.w;
        } else {
          acc[0] += row[0];
        }
      }
    }
    if (mine) {
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        dst[c] = acc[0];
      }
    }
  }
}

}  // namespace

extern "C" {

int embedding_bag_sum(const void* table, const void* ids, void* out,
                      long long B, int L, long long V, int D, int vec4,
                      void* stream) {
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  auto* o = static_cast<float*>(out);
  if (vec4) {
    embedding_bag_sum_kernel<4><<<blocks, kThreads, 0, s>>>(t, i, o, B, L, V,
                                                            D);
  } else {
    embedding_bag_sum_kernel<1><<<blocks, kThreads, 0, s>>>(t, i, o, B, L, V,
                                                            D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
