// Hopper (sm_90a) kernel of the blocked one-hot SpMV reduce.
//
// Hand-written CUDA C++ counterpart of the Pallas kernel in
// graphtap_tpu/kernels/pallas_spmv.py:
//
//   K5 segment_reduce_kernel  replaces pallas_segment_reduce
//                             (_reduce_kernel :115-138, call :144-162)
//
// What it computes. The host plan (build_pallas_plan) regroups the edges
// by 128-row destination block and pads each block's run to whole chunks
// of 2048 contributions; lrows[e] in [0, 128) is an edge's row within its
// block and chunk_block[i] the block of chunk i. y (nblocks, 128) starts at
// the ⊕-identity and every contribution of chunk i is ⊕-folded into
// y[chunk_block[i], lrows[e]]. Padding carries the ⊕-identity (the caller
// masks contrib by the plan's evalid first, as the JAX executor does), and
// trailing all-padding chunks point at the last real block, so the kernel,
// like the Pallas one, reads no validity mask.
//
// What bounds it on the card: bytes. Per contribution one value and one
// int32 lrows read, one ⊕; per chunk one chunk_block read; y written once.
// Far below the card's ~20 operations per byte, so a call is held to
// (bytes moved) / 3.35 TB/s.
//
// Design, simple first. The Pallas grid walks chunks in order and folds
// each with a one-hot select and a column reduction of a (2048, 128)
// register tile into a VMEM-resident y. Blocks here run in no order, so:
// one block per chunk; each thread folds a run of 8 consecutive
// contributions in registers while their row stays the same (edges come
// row-sorted on the PageRank path, so this saves most shared atomics),
// then ⊕-folds each run into 128 shared-memory lanes with shared atomics;
// the block adds its lanes to y with one global atomic per lane, after y
// was filled with the identity (K8's design). Float sums are reordered
// against the Pallas kernel's chunk order; int32 min and max stay exact.
//
// The launcher is extern "C" (bound with ctypes), launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
// Element offsets are 64-bit.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"

using namespace gt;

namespace {

constexpr int CHUNK = 2048;                // contributions per chunk
constexpr int PER_THREAD = CHUNK / THREADS;  // 8

template <typename T, int RED>
__global__ void __launch_bounds__(THREADS)
segment_reduce_kernel(const T* __restrict__ contrib,
                      const int* __restrict__ lrows,
                      const int* __restrict__ chunk_block, T* __restrict__ y,
                      T ident) {
  __shared__ T acc[LANES];
  for (int l = threadIdx.x; l < LANES; l += blockDim.x) acc[l] = ident;
  __syncthreads();
  const long long e0 = static_cast<long long>(blockIdx.x) * CHUNK +
                       static_cast<long long>(threadIdx.x) * PER_THREAD;
  int cur = lrows[e0];
  T run = contrib[e0];
#pragma unroll
  for (int k = 1; k < PER_THREAD; ++k) {
    const int lr = lrows[e0 + k];
    const T v = contrib[e0 + k];
    if (lr == cur) {
      run = combine<RED, T>(run, v);
    } else {
      atomic_combine<RED>(&acc[cur], run);
      cur = lr;
      run = v;
    }
  }
  atomic_combine<RED>(&acc[cur], run);
  __syncthreads();
  const long long row = chunk_block[blockIdx.x];
  for (int l = threadIdx.x; l < LANES; l += blockDim.x) {
    atomic_combine<RED>(y + row * LANES + l, acc[l]);
  }
}

template <typename T, int RED>
void launch_kernel(const void* c, const void* lr, const void* cb, void* y,
                   long long nchunks, T ident, cudaStream_t st) {
  segment_reduce_kernel<T, RED><<<static_cast<unsigned>(nchunks), THREADS,
                                  0, st>>>(
      static_cast<const T*>(c), static_cast<const int*>(lr),
      static_cast<const int*>(cb), static_cast<T*>(y), ident);
}

template <typename T>
int launch_segment_reduce(const void* c, const void* lr, const void* cb,
                          void* y, long long nchunks, long long nblocks,
                          int red, double identity, cudaStream_t st) {
  if (red != RED_SUM && !std::is_same<T, int>::value) {
    return cudaErrorInvalidValue;   // no float atomicMin/Max
  }
  const T ident = static_cast<T>(identity);
  launch_fill<T>(static_cast<T*>(y), nblocks * LANES, ident, st);
  if (nchunks > 0) {
    if (red == RED_SUM) {
      launch_kernel<T, RED_SUM>(c, lr, cb, y, nchunks, ident, st);
    } else if constexpr (std::is_same<T, int>::value) {
      if (red == RED_MIN) {
        launch_kernel<T, RED_MIN>(c, lr, cb, y, nchunks, ident, st);
      } else if (red == RED_MAX) {
        launch_kernel<T, RED_MAX>(c, lr, cb, y, nchunks, ident, st);
      } else {
        return cudaErrorInvalidValue;
      }
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gt_segment_reduce(const void* contrib, const void* lrows,
                      const void* chunk_block, void* y, long long nchunks,
                      long long nblocks, int dtype, int reduce_kind,
                      double identity, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_segment_reduce<float>(contrib, lrows, chunk_block, y,
                                          nchunks, nblocks, reduce_kind,
                                          identity, st);
    case F64:
      return launch_segment_reduce<double>(contrib, lrows, chunk_block, y,
                                           nchunks, nblocks, reduce_kind,
                                           identity, st);
    case I32:
      return launch_segment_reduce<int>(contrib, lrows, chunk_block, y,
                                        nchunks, nblocks, reduce_kind,
                                        identity, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
