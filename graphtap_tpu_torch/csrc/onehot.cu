// Hopper (sm_90a) kernel of the blocked one-hot SpMV reduce.
//
// Hand-written CUDA C++ counterpart of the Pallas kernel in
// graphtap_tpu/kernels/pallas_spmv.py:
//
//   K5 gt_segment_reduce      replaces pallas_segment_reduce
//                             (_reduce_kernel :115-138, call :144-162)
//   K5 gt_segment_reduce_gather   the same fold, its contributions made
//                             in pass (a) from the plan: also replaces
//                             the gather, ⊗ and padding mask the JAX
//                             executor leaves to XLA before the call
//                             (executor.py:203-221)
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
// int32 lrows read, one ⊕; y written once (the chunks' lane partials go
// out and back through L2). Far below the card's ~20
// operations per byte, so a call is held to (bytes moved) / 3.35 TB/s.
//
// Design. The Pallas grid walks chunks in order and folds each with a
// one-hot select and a column reduction of a (2048, 128) register tile
// into a VMEM-resident y, so its float sums come out the same on every
// call. Blocks here run in no order, and a fold with atomics rounds in
// another order on every call, which kept f32 PageRank's absolute
// convergence vote from ever closing. So the fold runs in a fixed order
// (common.cuh: chunk_fold_kernel, kernels/fold_order.py), in two passes:
// (a) one 256-thread block per chunk loads its 2,048 contributions and
// lrows, eight a thread; each lane's contributions fold in runs of 32
// (each from the ⊕-identity) and then the runs' results in order, so a
// chunk of one hub row folds in a chain of 32 + 64 steps over 64 threads,
// where one thread folded 2,048; each warp ranks its slots within their
// lanes (__match_any_sync rounds over per-warp lane counts), and the
// values go to shared memory sorted by lane. (b) one thread per
// (block, lane) folds the block's chunk partials in chunk order, in runs
// of 64 and then the runs' results, from the ⊕-identity, and writes y
// once. The chunk list is built once per upload from chunk_block
// (kernels/fold_order.py::chunk_lists). The result equals the plain
// version's (segment_reduce_plain, the same order) bit for bit.
//
// The gathering form. Built in torch, the contributions cost a pass per
// operation over every plan slot (the x gather, the ⊗'s compare, add and
// select, the padding's select: 27 B a slot unweighted, 62 B under the
// min-plus ⊗, with K5's own reads), where the work needs the plan's
// cols, lrows and ev (9 B a slot) and its weights (13 B). So pass (a)
// reads those streams once, evict-first, gathers x[cols[e]] (x, 4-8 MB,
// stays in the 50 MB L2) and applies the ⊗ itself (common.cuh:
// chunk_fold_kernel's GATHER); a padding slot takes the ⊕-identity, as
// the masked contribution did, so the fold and its bits are the same.
//
// The launcher is extern "C" (bound with ctypes), launches on the
// caller's stream, allocates nothing (the scratch is the caller's), and
// returns cudaGetLastError(). Element offsets are 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

using namespace gt;

namespace {

constexpr int CHUNK = 2048;                // contributions per chunk

template <typename T>
int launch_segment_reduce(const void* c, const void* lr, const void* chunks,
                          const void* rptr, const void* gptr, void* part,
                          void* gpart, void* y, long long nitems,
                          long long nblocks, long long ngroups, int red,
                          double identity, cudaStream_t st) {
  return launch_chunk_fold<T, int, CHUNK, false>(
      c, lr, nullptr, chunks, rptr, gptr, part, gpart, y, nitems, nblocks,
      ngroups, red, identity, st);
}

template <typename T>
int launch_segment_reduce_gather(const void* x, const void* lr,
                                 const void* cols, const void* ev,
                                 const void* w, const void* chunks,
                                 const void* rptr, const void* gptr,
                                 void* part, void* gpart, void* y,
                                 long long nitems, long long nblocks,
                                 long long ngroups, int mul, int red,
                                 double identity, cudaStream_t st) {
  switch (mul) {
    case MUL_NONE:
      return launch_chunk_fold<T, int, CHUNK, false, MUL_NONE>(
          x, lr, ev, chunks, rptr, gptr, part, gpart, y, nitems, nblocks,
          ngroups, red, identity, st, cols, w);
    case MUL_MUL:
      return launch_chunk_fold<T, int, CHUNK, false, MUL_MUL>(
          x, lr, ev, chunks, rptr, gptr, part, gpart, y, nitems, nblocks,
          ngroups, red, identity, st, cols, w);
    case MUL_ADD_SAT:
      return launch_chunk_fold<T, int, CHUNK, false, MUL_ADD_SAT>(
          x, lr, ev, chunks, rptr, gptr, part, gpart, y, nitems, nblocks,
          ngroups, red, identity, st, cols, w);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The chunk list (kernels/fold_order.py::chunk_lists): chunks (nitems)
// int32, by row block in chunk order, -1 for a block with no chunk; gptr
// (ngroups + 1) its runs; rptr (nblocks + 1) each block's runs. part
// (nitems, 128), gpart (ngroups, 128): scratch.
int gt_segment_reduce(const void* contrib, const void* lrows,
                      const void* chunks, const void* rptr, const void* gptr,
                      void* part, void* gpart, void* y, long long nitems,
                      long long nblocks, long long ngroups, int dtype,
                      int reduce_kind, double identity, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_segment_reduce<float>(contrib, lrows, chunks, rptr,
                                          gptr, part, gpart, y, nitems,
                                          nblocks, ngroups, reduce_kind,
                                          identity, st);
    case F64:
      return launch_segment_reduce<double>(contrib, lrows, chunks, rptr,
                                           gptr, part, gpart, y, nitems,
                                           nblocks, ngroups, reduce_kind,
                                           identity, st);
    case I32:
      return launch_segment_reduce<int>(contrib, lrows, chunks, rptr, gptr,
                                        part, gpart, y, nitems, nblocks,
                                        ngroups, reduce_kind, identity, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same fold of x[cols[e]] ⊗ w[e] (mul_kind; w NULL under MUL_NONE)
// where ev[e] is set and of the identity where it is not: x (any length
// past the largest col), cols (nitems' chunks x 2048) int32, ev int8.
int gt_segment_reduce_gather(const void* x, const void* lrows,
                             const void* cols, const void* ev, const void* w,
                             const void* chunks, const void* rptr,
                             const void* gptr, void* part, void* gpart,
                             void* y, long long nitems, long long nblocks,
                             long long ngroups, int dtype, int mul_kind,
                             int reduce_kind, double identity,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_segment_reduce_gather<float>(
          x, lrows, cols, ev, w, chunks, rptr, gptr, part, gpart, y, nitems,
          nblocks, ngroups, mul_kind, reduce_kind, identity, st);
    case F64:
      return launch_segment_reduce_gather<double>(
          x, lrows, cols, ev, w, chunks, rptr, gptr, part, gpart, y, nitems,
          nblocks, ngroups, mul_kind, reduce_kind, identity, st);
    case I32:
      return launch_segment_reduce_gather<int>(
          x, lrows, cols, ev, w, chunks, rptr, gptr, part, gpart, y, nitems,
          nblocks, ngroups, mul_kind, reduce_kind, identity, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
