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
// min-plus ⊗, with K5's own reads). So pass (a) makes them itself: it
// gathers x (4-8 MB, stays in the 50 MB L2) and applies the ⊗; a padding
// slot takes the ⊕-identity, as the masked contribution did, so the fold
// and its bits are the same. What bounds it: not the card's memory (a
// block a chunk that read the plan's cols, lrows and ev and gathered x in
// slot order ran at ~40% of its 9 B a slot bound) and not the latency of
// its two dependent loads (persistent blocks that gathered chunk k+1
// into a shared-memory ring while chunk k folded ran slower at every
// depth and blocks an SM tried), but the SM's load pipe: a warp's gather
// of 32 scattered values costs a pass per distinct 128-byte line (0.76 a
// slot in plan order at RMAT-18), and it shares that pipe with the
// fold's shared-memory traffic, so the card only holds it busier with
// more blocks. So the kernel reads gather tables built once per upload
// (kernels/onehot_spmv.py::gather_tables): each chunk's edges sorted by
// col, so a warp's 32 gathers touch fewer lines (0.51 a slot), each with
// its slot's place in the chunk's fold order, and each chunk's slots a
// lane. The place is static (K5 keeps every slot, padding included), so
// the kernel writes each gathered value where chunk_fold_kernel's rank
// and sort would have put it, with no rank, sort or padding slot to
// load: 6 B an edge in place of 9 B a slot (gather_fold_kernel). The
// fold from there is chunk_fold_kernel's (common.cuh: lane_bounds,
// fold_runs), so the bits are the same.
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
// K5 from the plan: blocks an SM holds (the registers are capped for them)
constexpr int GATHER_BLOCKS_PER_SM = 6;

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

// ------------------------------------------- K5 from the plan: gathering
// Pass (a) of K5 from the plan over the nitems list items (chunks[k], or
// -1: a null item, identity partials) into part (nitems, 128), from the
// plan's gather tables (kernels/onehot_spmv.py::gather_tables): chunk c's
// edges are entries eptr[c] .. eptr[c+1]-1, sorted by col, each its col
// (ecol), its weight (ew, weighted forms) and its slot's position in the
// chunk's fold order (edest: by lane, then slot); lcount[c][l] is the
// slots of lane l in chunk c, padding included. The block fills s.val with
// the ⊕-identity where the chunk has padding (the places no edge takes),
// gathers x[ecol[k]] ⊗ ew[k] into s.val at edest[k], sets the lanes'
// bounds from lcount (lane_bounds) and folds (fold_runs): the same values
// in the same places as chunk_fold_kernel's rank and sort put them, so
// the same bits. Thread t holds entries t + 256 j.
template <typename T, int RED, int MUL>
__global__ void __launch_bounds__(CHUNK_FOLD_THREADS, GATHER_BLOCKS_PER_SM)
gather_fold_kernel(const T* __restrict__ x, const int* __restrict__ ecol,
                   const int16_t* __restrict__ edest,
                   const T* __restrict__ ew, const int* __restrict__ eptr,
                   const int16_t* __restrict__ lcount,
                   const int* __restrict__ chunks, T* __restrict__ part,
                   T ident) {
  constexpr int E = CHUNK / CHUNK_FOLD_THREADS;   // entries of a thread
  __shared__ ChunkFoldSmem<T, CHUNK> s;
  const int t = threadIdx.x;
  const int chunk = __ldg(chunks + blockIdx.x);
  T acc = ident;                 // thread t < 128: lane t's partial
  if (chunk >= 0) {              // the same in the whole block
    const long long e0 = __ldg(eptr + chunk);
    const int n = static_cast<int>(__ldg(eptr + chunk + 1) - e0);
    int col[E], dst[E];
    T v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int k = t + CHUNK_FOLD_THREADS * j;
      if (k < n) {
        col[j] = __ldcs(ecol + e0 + k);
        dst[j] = __ldcs(edest + e0 + k);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {   // every gather before its first use
      if (t + CHUNK_FOLD_THREADS * j < n) v[j] = __ldg(x + col[j]);
    }
    if constexpr (MUL != MUL_NONE) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int k = t + CHUNK_FOLD_THREADS * j;
        if (k < n) v[j] = mul_value<T, MUL>(v[j], __ldcs(ew + e0 + k), ident);
      }
    }
    if (n < CHUNK) {               // the padding's places: the identity
      for (int p = t; p < CHUNK + CHUNK / 32; p += CHUNK_FOLD_THREADS) {
        s.val[p] = ident;
      }
    }
    if (t < 32) {
      const short4 q = __ldg(reinterpret_cast<const short4*>(
          lcount + static_cast<long long>(chunk) * LANES) + t);
      const int c[4] = {q.x, q.y, q.z, q.w};
      lane_bounds(s, c);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (t + CHUNK_FOLD_THREADS * j < n) s.val[chunk_skew(dst[j])] = v[j];
    }
    __syncthreads();
    acc = fold_runs<T, RED, CHUNK, false>(s, ident);
  }
  if (t < LANES) part[static_cast<long long>(blockIdx.x) * LANES + t] = acc;
}

template <typename T, int MUL>
int launch_gather_mul(const void* x, const void* ecol, const void* edest,
                      const void* ew, const void* eptr, const void* lcount,
                      const void* chunks, const void* rptr, const void* gptr,
                      void* part, void* gpart, void* y, long long nitems,
                      long long nblocks, long long ngroups, int red,
                      double identity, cudaStream_t st) {
  const T ident = static_cast<T>(identity);
  const int rc = dispatch_red(red, [&](auto rk) {
    constexpr int RED = decltype(rk)::value;
    if (nitems > 0) {
      gather_fold_kernel<T, RED, MUL>
          <<<static_cast<unsigned>(nitems), CHUNK_FOLD_THREADS, 0, st>>>(
              static_cast<const T*>(x), static_cast<const int*>(ecol),
              static_cast<const int16_t*>(edest), static_cast<const T*>(ew),
              static_cast<const int*>(eptr),
              static_cast<const int16_t*>(lcount),
              static_cast<const int*>(chunks), static_cast<T*>(part), ident);
    }
    launch_row_fold<T, RED>(part, rptr, gptr, nullptr, gpart, y, nblocks,
                            ngroups, ident, st);
  });
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

template <typename T>
int launch_segment_reduce_gather(const void* x, const void* ecol,
                                 const void* edest, const void* ew,
                                 const void* eptr, const void* lcount,
                                 const void* chunks, const void* rptr,
                                 const void* gptr, void* part, void* gpart,
                                 void* y, long long nitems, long long nblocks,
                                 long long ngroups, int mul, int red,
                                 double identity, cudaStream_t st) {
  switch (mul) {
    case MUL_NONE:
      return launch_gather_mul<T, MUL_NONE>(
          x, ecol, edest, ew, eptr, lcount, chunks, rptr, gptr, part, gpart,
          y, nitems, nblocks, ngroups, red, identity, st);
    case MUL_MUL:
      return launch_gather_mul<T, MUL_MUL>(
          x, ecol, edest, ew, eptr, lcount, chunks, rptr, gptr, part, gpart,
          y, nitems, nblocks, ngroups, red, identity, st);
    case MUL_ADD_SAT:
      return launch_gather_mul<T, MUL_ADD_SAT>(
          x, ecol, edest, ew, eptr, lcount, chunks, rptr, gptr, part, gpart,
          y, nitems, nblocks, ngroups, red, identity, st);
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

// The same fold of x[cols[e]] ⊗ w[e] (mul_kind) where the plan's ev[e]
// is set and of the identity where it is not, from the plan's gather
// tables: ecol (nedges) int32, edest (nedges) int16, ew (nedges; NULL
// under MUL_NONE), eptr (nchunks + 1) int32, lcount (nchunks, 128) int16;
// x any length past the largest col.
int gt_segment_reduce_gather(const void* x, const void* ecol,
                             const void* edest, const void* ew,
                             const void* eptr, const void* lcount,
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
          x, ecol, edest, ew, eptr, lcount, chunks, rptr, gptr, part, gpart,
          y, nitems, nblocks, ngroups, mul_kind, reduce_kind, identity, st);
    case F64:
      return launch_segment_reduce_gather<double>(
          x, ecol, edest, ew, eptr, lcount, chunks, rptr, gptr, part, gpart,
          y, nitems, nblocks, ngroups, mul_kind, reduce_kind, identity, st);
    case I32:
      return launch_segment_reduce_gather<int>(
          x, ecol, edest, ew, eptr, lcount, chunks, rptr, gptr, part, gpart,
          y, nitems, nblocks, ngroups, mul_kind, reduce_kind, identity, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
