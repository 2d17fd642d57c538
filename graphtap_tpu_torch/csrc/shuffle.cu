// Hopper (sm_90a) kernels of the v1 static-shuffle SpMV pipeline.
//
// Hand-written CUDA C++ counterparts of the three Pallas kernels in
// graphtap_tpu/kernels/shuffle_kernels.py:
//
//   K6 expand_kernel          replaces expand_stream  (_expand_body, :42-103)
//   K7 group_pass_kernel      replaces group_stream   (_group_pass_body,
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
//       in[s, r, frag_idx[s,p,r,j*128+l]] where both are >= 0.
//   K8: y (nblocks,128) = identity; each 8-row chunk i ⊕-folds its valid
//       elements into y[chunk_block[i], lr].
// The plans are the bytes the Pallas kernels read, so each kernel can be
// held against its twin.
//
// What bounds them on the card: bytes. Per stream slot K6 reads three int8
// plan bytes and one gathered x value and writes one value (f32: 3 + 4 + 4
// B, the gather mostly hitting L2, x being at most tens of MB); K7 reads
// up to SMAX*128 int8 frag_idx bytes per source row and pass (SMAX is 13-14
// on RMAT graphs: up to 1.8 KB against the row's 512 B of f32 values) and
// writes the row's values once; K8 reads the value and two int8 bytes per
// slot and writes and reads back 128 lane partials per chunk. None does
// more than a handful of operations per byte, far under the card's ~20 per
// byte in f32, so each is held to (bytes moved) / 3.35 TB/s.
//
// Design, simple first. K6: one thread per slot, grid-stride, coalesced
// plan reads, the x value a gather. K7: on the TPU each pass of each super
// is a sequential grid walking source vregs and writing prefetch-addressed
// destination rows of a VMEM-resident block, later writes winning; here
// one launch covers every super of a pass, a block of 8 x 128 threads
// stages 8 source rows in shared memory, and each thread scatters its
// lane of each fragment straight to device memory. The scatter is
// order-free because no (row, lane) of a super is written twice in a pass
// (validate_shuffle_plans checks it on the host). The Pallas output block
// is never initialised (holes hold garbage the reduce plan's ev masks);
// here each pass output is first filled with the ⊕-identity, so runs are
// deterministic. K8: the TPU folds chunks in grid order into a resident y;
// here the fold runs in two passes in a fixed order (common.cuh), as K5's
// does: (a) one 128-thread block per chunk folds each lane's valid slots
// in index order into an (nchunks, 128) scratch; (b) one thread per
// (block, lane) folds the block's chunk partials in chunk order (in runs of
// 64, then the runs' results: a degree SpMV's hub block has thousands of
// chunks) from the ⊕-identity and writes y once. Float sums come out the
// same on every call and equal the plain version's bit for bit; the block
// -> chunks lists are built once per upload from chunk_block
// (kernels/fold_order.py).
//
// The launchers are extern "C" (bound with ctypes), launch on the caller's
// stream, allocate nothing (K8's scratch is the caller's), and return
// cudaGetLastError(). Element offsets are 64-bit.

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
constexpr int GROUP_RPB = 8;   // K7 source rows per block

// ---------------------------------------------------------------- K6
template <typename T, int MUL>
__global__ void __launch_bounds__(THREADS)
expand_kernel(const T* __restrict__ x3d, const int* __restrict__ grp,
              const int8_t* __restrict__ slot, const int8_t* __restrict__ lane,
              const int8_t* __restrict__ ev, const T* __restrict__ w,
              T* __restrict__ out, long long n, T fill) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    T v = fill;
    if (ev[e] != 0) {
      const long long win = grp[(e / LANES) / SUB];
      const T g = x3d[(win * WROWS + slot[e]) * LANES + lane[e]];
      v = apply_mul<T, MUL>(g, w, e, fill);
    }
    out[e] = v;
  }
}

// ---------------------------------------------------------------- K7
// Block: GROUP_RPB source rows (threadIdx.y) x 128 lanes (threadIdx.x).
// Row gr = s * rps + r of the stream; its fragment j writes lane l of
// destination row s * rps + frag_dst[s,p,r,j] from source lane
// frag_idx[s,p,r,j*128+l]. frag_dst is padded with -1 past a row's last
// fragment, frag_idx with -1 at lanes the fragment leaves alone.
template <typename T>
__global__ void __launch_bounds__(GROUP_RPB * LANES)
group_pass_kernel(const T* __restrict__ in, const int* __restrict__ frag_dst,
                  const int8_t* __restrict__ frag_idx, T* __restrict__ out,
                  long long nrows, int rps, int npasses, int pass, int smax) {
  __shared__ T rows[GROUP_RPB][LANES];
  const int l = threadIdx.x;
  const long long gr =
      static_cast<long long>(blockIdx.x) * GROUP_RPB + threadIdx.y;
  const bool live = gr < nrows;
  if (live) rows[threadIdx.y][l] = in[gr * LANES + l];
  __syncthreads();
  if (!live) return;
  const long long s = gr / rps;
  const long long r = gr - s * rps;
  const long long f0 = ((s * npasses + pass) * rps + r) * smax;
  for (int j = 0; j < smax; ++j) {
    const int d = frag_dst[f0 + j];         // the same for the row's lanes
    if (d < 0) continue;
    const int idx = frag_idx[(f0 + j) * LANES + l];
    if (idx >= 0) out[(s * rps + d) * LANES + l] = rows[threadIdx.y][idx];
  }
}

// ---------------------------------------------------------------- launch
template <typename T>
int launch_expand(const void* x3d, const void* grp, const void* slot,
                  const void* lane, const void* ev, const void* w, void* out,
                  long long rows, int mul_kind, double fill,
                  cudaStream_t st) {
  const long long n = rows * LANES;
  const T* xs = static_cast<const T*>(x3d);
  const int* g = static_cast<const int*>(grp);
  const int8_t* sl = static_cast<const int8_t*>(slot);
  const int8_t* ln = static_cast<const int8_t*>(lane);
  const int8_t* e = static_cast<const int8_t*>(ev);
  const T* ws = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  const T f = static_cast<T>(fill);
  const unsigned blocks = stride_blocks(n);
  switch (mul_kind) {
    case MUL_NONE:
      expand_kernel<T, MUL_NONE><<<blocks, THREADS, 0, st>>>(
          xs, g, sl, ln, e, ws, o, n, f);
      break;
    case MUL_MUL:
      expand_kernel<T, MUL_MUL><<<blocks, THREADS, 0, st>>>(
          xs, g, sl, ln, e, ws, o, n, f);
      break;
    case MUL_ADD_SAT:
      expand_kernel<T, MUL_ADD_SAT><<<blocks, THREADS, 0, st>>>(
          xs, g, sl, ln, e, ws, o, n, f);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
int launch_group(const void* in, const void* frag_dst, const void* frag_idx,
                 void* out, long long nsupers, int rps, int npasses, int pass,
                 int smax, double fill, cudaStream_t st) {
  const long long nrows = nsupers * rps;
  T* o = static_cast<T*>(out);
  launch_fill<T>(o, nrows * LANES, static_cast<T>(fill), st);
  if (nrows > 0) {
    const dim3 block(LANES, GROUP_RPB);
    const unsigned grid =
        static_cast<unsigned>((nrows + GROUP_RPB - 1) / GROUP_RPB);
    group_pass_kernel<T><<<grid, block, 0, st>>>(
        static_cast<const T*>(in), static_cast<const int*>(frag_dst),
        static_cast<const int8_t*>(frag_idx), o, nrows, rps, npasses, pass,
        smax);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_reduce(const void* c, const void* lr, const void* ev,
                  const void* rptr, const void* gptr, const void* idx,
                  void* part, void* gpart, void* y, long long nchunks,
                  long long nblocks, long long ngroups, int red,
                  double identity, cudaStream_t st) {
  return launch_chunk_fold<T, int8_t, CHUNK_EL>(
      c, lr, ev, rptr, gptr, idx, part, gpart, y, nchunks, nblocks, ngroups,
      red, identity, st);
}

}  // namespace

extern "C" {

int gt_expand_stream(const void* x3d, const void* grp, const void* slot,
                     const void* lane, const void* ev, const void* w,
                     void* out, long long rows, int dtype, int mul_kind,
                     double fill, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w == nullptr && mul_kind != MUL_NONE) return cudaErrorInvalidValue;
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

int gt_group_pass(const void* in, const void* frag_dst, const void* frag_idx,
                  void* out, long long nsupers, int rps, int npasses,
                  int pass, int smax, int dtype, double fill, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_group<float>(in, frag_dst, frag_idx, out, nsupers, rps,
                                 npasses, pass, smax, fill, st);
    case F64:
      return launch_group<double>(in, frag_dst, frag_idx, out, nsupers, rps,
                                  npasses, pass, smax, fill, st);
    case I32:
      return launch_group<int>(in, frag_dst, frag_idx, out, nsupers, rps,
                               npasses, pass, smax, fill, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The block -> chunks lists (kernels/fold_order.py::fold_lists): idx
// (nchunks) the chunks by block, in chunk order; gptr (ngroups + 1) the
// runs in idx; rptr (nblocks + 1) each block's runs. part (nchunks, 128)
// and gpart (ngroups, 128): scratch.
int gt_grouped_reduce(const void* c, const void* lr, const void* ev,
                      const void* rptr, const void* gptr, const void* idx,
                      void* part, void* gpart, void* y, long long nchunks,
                      long long nblocks, long long ngroups, int dtype,
                      int reduce_kind, double identity, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_reduce<float>(c, lr, ev, rptr, gptr, idx, part, gpart, y,
                                  nchunks, nblocks, ngroups, reduce_kind,
                                  identity, st);
    case F64:
      return launch_reduce<double>(c, lr, ev, rptr, gptr, idx, part, gpart,
                                   y, nchunks, nblocks, ngroups, reduce_kind,
                                   identity, st);
    case I32:
      return launch_reduce<int>(c, lr, ev, rptr, gptr, idx, part, gpart, y,
                                nchunks, nblocks, ngroups, reduce_kind,
                                identity, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
