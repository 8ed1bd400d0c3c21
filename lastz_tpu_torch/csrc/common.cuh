// Shared helpers for the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lastz {

constexpr unsigned kFullMask = 0xffffffffu;

// int32 arithmetic that wraps like XLA's (and the reference's 32-bit
// scores) instead of being undefined on signed overflow
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// floor division (Python/JAX `//`); CUDA's `/` truncates toward zero
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

}  // namespace lastz
