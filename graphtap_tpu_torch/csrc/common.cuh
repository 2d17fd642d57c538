// Device helpers shared by the port's kernels (panel_route.cu, shuffle.cu).
//
// The value types, ⊗ and ⊕ kinds as the wrappers number them
// (kernels/panel_kernels.py: _DTYPES, _MUL_KINDS, _REDUCE_KINDS), the
// saturating min-plus ⊗, the ⊕ combine and its atomic form, and a
// grid-stride fill.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace gt {

constexpr int LANES = 128;
constexpr int THREADS = 256;

enum Dtype { F32 = 0, F64 = 1, I32 = 2 };
enum MulKind { MUL_NONE = 0, MUL_MUL = 1, MUL_ADD_SAT = 2 };
enum ReduceKind { RED_SUM = 0, RED_MIN = 1, RED_MAX = 2 };

// min-plus ⊗: INF stays INF, so INF + w never wraps (panel_kernels.py:134,
// shuffle_kernels.py:59-61).
template <typename T>
__device__ __forceinline__ T add_sat(T acc, T w, T fill) {
  return acc >= fill ? fill : acc + w;
}
template <>
__device__ __forceinline__ int add_sat<int>(int acc, int w, int fill) {
  // below INF the sum is the Pallas kernels' int32 add (two's complement)
  return acc >= fill ? fill
                     : static_cast<int>(static_cast<unsigned>(acc) +
                                        static_cast<unsigned>(w));
}

template <int RED, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (RED == RED_SUM) {
    return a + b;
  } else if constexpr (RED == RED_MIN) {
    return a < b ? a : b;
  } else {
    return a > b ? a : b;
  }
}

// Works on global and shared memory alike (f32/f64 atomicAdd, int32 all).
template <int RED, typename T>
__device__ __forceinline__ void atomic_combine(T* addr, T v) {
  if constexpr (RED == RED_SUM) {
    atomicAdd(addr, v);
  } else if constexpr (RED == RED_MIN) {
    atomicMin(addr, v);
  } else {
    atomicMax(addr, v);
  }
}

// ⊗ of one contribution with its weight pw[e] (MUL_NONE: none).
template <typename T, int MUL>
__device__ __forceinline__ T apply_mul(T v, const T* __restrict__ pw,
                                       long long e, T fill) {
  if constexpr (MUL == MUL_MUL) {
    return v * pw[e];
  } else if constexpr (MUL == MUL_ADD_SAT) {
    return add_sat<T>(v, pw[e], fill);
  } else {
    return v;
  }
}

template <typename T>
__global__ void fill_kernel(T* __restrict__ y, long long n, T v) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    y[i] = v;
  }
}

// Grid size of a grid-stride loop over n elements.
inline unsigned stride_blocks(long long n) {
  const long long want = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(want < 65536 ? (want > 0 ? want : 1) : 65536);
}

template <typename T>
void launch_fill(T* y, long long n, T v, cudaStream_t st) {
  if (n > 0) fill_kernel<T><<<stride_blocks(n), THREADS, 0, st>>>(y, n, v);
}

}  // namespace gt
