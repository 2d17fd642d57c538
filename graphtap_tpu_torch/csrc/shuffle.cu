// Hopper (sm_90a) kernels of the v1 static-shuffle SpMV pipeline.
//
// Hand-written CUDA C++ counterparts of the three Pallas kernels in
// graphtap_tpu/kernels/shuffle_kernels.py:
//
//   K6 expand_kernel          replaces expand_stream  (_expand_body, :42-103)
//   K7 group_gather_kernel    replaces group_stream   (_group_pass_body,
//                                                      :110-170)
//   K8 gt_grouped_reduce      replaces grouped_reduce (_reduce_body, :177-233)
//
// What they compute. The host planner (shuffle_plan.py) lays the edges out
// as a stream of (rows, 128) slots in (row-super, column, row) order.
//   K6: out[r,l] = ev[r,l] ? x3d[grp[r/8], slot[r,l], lane[r,l]] ⊗ w[r,l]
//       : fill, ⊗ in {none, mul, add_sat}; x3d is x cut into 8192-column
//       (64,128) windows. The engine also runs it twice on the compact y
//       (the monotone compact -> dense expansion).
//   K7: per super s and radix pass p, out[s, frag_dst[s,p,r,j], l] =
//       in[s, r, frag_idx[s,p,r,j*128+l]] where both are >= 0; unwritten
//       slots hold the fill. The passes compose (each moves every occupied
//       slot of a super to one slot of the same super), so the kernel runs
//       them as one gather: out[d] = src[d] >= 0 ? in[src[d]] : fill, with
//       src the composed index (shuffle_kernels.py::group_index, built once
//       per upload).
//   K8: y (nblocks,128) = identity; each 8-row chunk i ⊕-folds its valid
//       elements into y[chunk_block[i], lr].
// The plans are the bytes the Pallas kernels read, so each kernel can be
// held against its twin.
//
// What bounds them on the card: bytes. Per stream slot K6 reads three int8
// plan bytes and one gathered x value and writes one value (f32: 3 + 4 + 4
// B, the gather mostly hitting L2, x being at most tens of MB); K7 reads
// one int32 index and, for a live slot, one source value, and writes one
// value (f32: 4 + 4 + 4 B); K8 reads one ev byte per slot of a listed
// chunk and the value and lane byte of a valid one, and writes y once
// (128 lane partials per chunk of a multi-chunk row block go out and back
// through L2). None does more
// than a handful of operations per byte, far under the card's ~20 per byte
// in f32, so each is held to (bytes moved) / 3.35 TB/s.
//
// Design. K6: one 256-thread block per 8-row step (1,024 slots; the
// step is blockIdx.x, so no division), grp[step] read once a block, four
// consecutive slots a thread: one 4-byte streaming load each of ev, slot
// and lane (and the 16-byte weight word under a ⊗) where one thread a
// slot made three 1-byte loads, then four independent gathers from the
// step's window through the read-only path, the ⊗, and one 16-byte
// streaming store (two for f64). The stream is ~49% padding at RMAT-20,
// in whole 4-slot groups: for a group whose four ev bytes are 0 no slot,
// lane or weight is loaded (12% less time on the H100 than loading
// them). Staging a window in shared memory by TMA for a chunk of up to 8
// steps that read it, and gathering from there, lost to the block a step
// (PERF.md): a run of steps on one window is short (median 1 at
// RMAT-20), and a step's gathers walk its window in column order, a few
// L1/L2 lines. K7: on the TPU each pass of each super
// is a sequential grid walking source vregs and writing prefetch-addressed
// destination rows of a VMEM-resident block, later writes winning. Run
// pass by pass here, each pass would fill the whole stream, read ~14
// frag_idx bytes a slot and scatter partial-sector stores from many
// blocks. Instead the npasses passes are one gather through their
// composed int32 index: each thread owns 4 consecutive output slots,
// loads their indices as one 16-byte streaming load, issues four
// independent source loads through the read-only path and writes the four
// values as one 16-byte streaming store (two for f64), the fill where the
// index is -1. Index math is 32-bit (the wrapper raises for a stream of
// 2^31 slots or more). The output slots of a block read sources of one
// super (2 MB in f32 at rps 4096), so the gather mostly hits the 50 MB L2,
// and the kernel streams ~12 B a slot in f32. A gather has no order: the
// result equals the pass-by-pass plain version bit for bit.
// K8: the TPU folds chunks in grid order into a resident y; here the
// fold runs in a fixed order in two passes (common.cuh), as K5's does:
// (a) one 256-thread block per chunk of the chunk list, which leaves out
// the chunks with no valid slot (43% at the RMAT-20 degree plan) and is
// built once per upload from chunk_block and ev
// (kernels/fold_order.py::chunk_lists); a thread loads every slot's lane
// and value and masks them by its ev byte. The lanes of a chunk come in
// no order, so each warp ranks its valid slots within their lanes by
// __match_any_sync rounds over per-warp lane counts, and the values go to
// shared memory sorted by lane; each lane's values fold in runs of 32,
// then the runs' results, into the list's (nitems, 128) partials.
// (b) one thread per (block, lane) folds the block's partials in list
// order (runs of 64, then the runs' results) from the ⊕-identity and
// writes y once. Float sums come out the same on every call and equal the
// plain version's bit for bit.
//
// The launchers are extern "C" (bound with ctypes), launch on the caller's
// stream, allocate nothing (K8's scratch is the caller's), and return
// cudaGetLastError(). Element offsets are 64-bit (K7's 32-bit).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"

using namespace gt;

namespace {

constexpr int SUB = 8;         // rows per expand step (one grp entry)
constexpr int WROWS = 64;      // rows of an x window: 64 x 128 = 8192 columns
constexpr int RED_ROWS = 8;    // stream rows per reduce chunk
constexpr int CHUNK_EL = RED_ROWS * LANES;
constexpr int GROUP_VEC = 4;   // K7 output slots per thread

// ---------------------------------------------------------------- K6
// One 256-thread block per 8-row step (1,024 slots, one grp entry), four
// consecutive slots a thread: slots 4t .. 4t+3 of step blockIdx.x.
constexpr int STEP_EL = SUB * LANES;
constexpr int WIN_EL = WROWS * LANES;   // values of one x window

// byte k of a word, as the signed int8 the plan holds
__device__ __forceinline__ int byte_at(unsigned word, int k) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * k)) & 0xffu));
}

// The thread's four ev bytes, and only where any is set its slot and
// lane bytes and weights; then four gathers from the step's window.
template <typename T, int MUL>
__global__ void __launch_bounds__(THREADS)
expand_kernel(const T* __restrict__ x3d, const int* __restrict__ grp,
              const unsigned* __restrict__ slot4,
              const unsigned* __restrict__ lane4,
              const unsigned* __restrict__ ev4, const T* __restrict__ w,
              T* __restrict__ out, T fill) {
  const unsigned g = blockIdx.x * (STEP_EL / 4) + threadIdx.x;
  const unsigned ev = __ldcs(ev4 + g);
  unsigned slot = 0, lane = 0;
  T wv[4];
  if (ev != 0) {
    slot = __ldcs(slot4 + g);
    lane = __ldcs(lane4 + g);
    if constexpr (MUL != MUL_NONE) load4<T>(w, g, wv);
  }
  const T* win = x3d + static_cast<long long>(__ldg(grp + blockIdx.x)) *
                           WIN_EL;
  T v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = fill;
    if (byte_at(ev, k) != 0) {
      const int e = byte_at(slot, k) * LANES + byte_at(lane, k);
      v[k] = apply_mul<T, MUL>(__ldg(win + e), wv, k, fill);
    }
  }
  store4<T>(out, g, v[0], v[1], v[2], v[3]);
}

// ---------------------------------------------------------------- K7
// One thread per GROUP_VEC consecutive output slots of the n-slot stream
// (n a multiple of 128), grid-stride over the n / 4 groups.
template <typename T>
__device__ __forceinline__ T gather_one(const T* __restrict__ in, int s,
                                        T fill) {
  return s >= 0 ? __ldg(in + s) : fill;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
group_gather_kernel(const T* __restrict__ in, const int4* __restrict__ src,
                    T* __restrict__ out, unsigned ngroups, T fill) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned g = blockIdx.x * blockDim.x + threadIdx.x; g < ngroups;
       g += stride) {
    const int4 s = __ldcs(src + g);
    const T a = gather_one(in, s.x, fill);
    const T b = gather_one(in, s.y, fill);
    const T c = gather_one(in, s.z, fill);
    const T d = gather_one(in, s.w, fill);
    store4<T>(out, g, a, b, c, d);
  }
}

// ---------------------------------------------------------------- launch
template <typename T>
int launch_expand(const void* x3d, const void* grp, const void* slot,
                  const void* lane, const void* ev, const void* w, void* out,
                  long long rows, int mul_kind, double fill,
                  cudaStream_t st) {
  const unsigned steps = static_cast<unsigned>(rows / SUB);
  if (steps == 0) return cudaGetLastError();
  const T* xs = static_cast<const T*>(x3d);
  const int* g = static_cast<const int*>(grp);
  const unsigned* sl = static_cast<const unsigned*>(slot);
  const unsigned* ln = static_cast<const unsigned*>(lane);
  const unsigned* e = static_cast<const unsigned*>(ev);
  const T* ws = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  const T f = static_cast<T>(fill);
  switch (mul_kind) {
    case MUL_NONE:
      expand_kernel<T, MUL_NONE><<<steps, THREADS, 0, st>>>(xs, g, sl, ln, e,
                                                            ws, o, f);
      break;
    case MUL_MUL:
      expand_kernel<T, MUL_MUL><<<steps, THREADS, 0, st>>>(xs, g, sl, ln, e,
                                                           ws, o, f);
      break;
    case MUL_ADD_SAT:
      expand_kernel<T, MUL_ADD_SAT><<<steps, THREADS, 0, st>>>(
          xs, g, sl, ln, e, ws, o, f);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
int launch_group(const void* in, const void* src, void* out, long long n,
                 double fill, cudaStream_t st) {
  const long long ngroups = n / GROUP_VEC;
  if (ngroups > 0) {
    // one group a thread (20,000 blocks, ~19 waves on 132 SMs, at the
    // RMAT-20 degree plan); past 65,536 blocks the grid-stride loop
    const long long want = (ngroups + THREADS - 1) / THREADS;
    const unsigned grid = static_cast<unsigned>(want < 65536 ? want : 65536);
    group_gather_kernel<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(in), static_cast<const int4*>(src),
        static_cast<T*>(out), static_cast<unsigned>(ngroups),
        static_cast<T>(fill));
  }
  return cudaGetLastError();
}

template <typename T>
int launch_reduce(const void* c, const void* lr, const void* ev,
                  const void* chunks, const void* rptr, const void* gptr,
                  void* part, void* gpart, void* y, long long nitems,
                  long long nblocks, long long ngroups, int red,
                  double identity, cudaStream_t st) {
  return launch_chunk_fold<T, int8_t, CHUNK_EL, true>(
      c, lr, ev, chunks, rptr, gptr, part, gpart, y, nitems, nblocks,
      ngroups, red, identity, st);
}

}  // namespace

extern "C" {

// K6 over rows (a multiple of 8, rows * 128 < 2^32) stream rows: slot,
// lane and ev 4-byte aligned, w and out 16-byte aligned.
int gt_expand_stream(const void* x3d, const void* grp, const void* slot,
                     const void* lane, const void* ev, const void* w,
                     void* out, long long rows, int dtype, int mul_kind,
                     double fill, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((w == nullptr && mul_kind != MUL_NONE) || rows < 0 || rows % SUB ||
      rows * LANES >= (1LL << 32)) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case F32:
      return launch_expand<float>(x3d, grp, slot, lane, ev, w, out, rows,
                                  mul_kind, fill, st);
    case F64:
      return launch_expand<double>(x3d, grp, slot, lane, ev, w, out, rows,
                                   mul_kind, fill, st);
    case I32:
      return launch_expand<int>(x3d, grp, slot, lane, ev, w, out, rows,
                                mul_kind, fill, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// K7: out[d] = src[d] >= 0 ? in[src[d]] : fill over n slots (n < 2^31, a
// multiple of GROUP_VEC; src and out 16-byte aligned).
int gt_group_gather(const void* in, const void* src, void* out, long long n,
                    int dtype, double fill, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n % GROUP_VEC != 0 || n >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case F32:
      return launch_group<float>(in, src, out, n, fill, st);
    case F64:
      return launch_group<double>(in, src, out, n, fill, st);
    case I32:
      return launch_group<int>(in, src, out, n, fill, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The chunk list (kernels/fold_order.py::chunk_lists): chunks (nitems)
// int32, by row block, the chunks with no valid slot left out, -1 for a
// block left with none; gptr (ngroups + 1) its runs; rptr (nblocks + 1)
// each block's runs. part (nitems, 128), gpart (ngroups, 128): scratch.
int gt_grouped_reduce(const void* c, const void* lr, const void* ev,
                      const void* chunks, const void* rptr, const void* gptr,
                      void* part, void* gpart, void* y, long long nitems,
                      long long nblocks, long long ngroups, int dtype,
                      int reduce_kind, double identity, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_reduce<float>(c, lr, ev, chunks, rptr, gptr, part,
                                  gpart, y, nitems, nblocks, ngroups,
                                  reduce_kind, identity, st);
    case F64:
      return launch_reduce<double>(c, lr, ev, chunks, rptr, gptr, part,
                                   gpart, y, nitems, nblocks, ngroups,
                                   reduce_kind, identity, st);
    case I32:
      return launch_reduce<int>(c, lr, ev, chunks, rptr, gptr, part, gpart,
                                y, nitems, nblocks, ngroups, reduce_kind,
                                identity, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
