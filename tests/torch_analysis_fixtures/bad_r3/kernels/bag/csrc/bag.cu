// Three entry points whose ctypes declarations disagree with them.
#include <cuda_runtime.h>

extern "C" {

int bag_sum(const void* table, const void* ids, void* out, long long B,
            int L, int D, void* stream) {
  return 0;
}

int bag_scale(void* out, long long n, float alpha, void* stream) {
  return 0;
}

int bag_mean(const void* table, const void* ids, void* out, long long B,
             int L, int D, void* stream) {
  return 0;
}

}  // extern "C"
