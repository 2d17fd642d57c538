// Hopper (sm_90a) kernel of the v2 windowed-gather SpMV pipeline.
//
// Hand-written CUDA C++ counterpart of the two Pallas kernels in
// graphtap_tpu/kernels/gather_kernels.py:
//
//   K9  windowed_gather_kernel<T, MUL>, block_rows 8,
//       replaces windowed_gather   (_wg_body :51-85, call :236-298)
//   K10 windowed_gather_kernel<T, MUL_NONE>, block_rows 64,
//       replaces windowed_gather64 (_wg64_body :142-163, call :202-224)
//
// What they compute. Output step i covers block_rows rows of 128 lanes.
// For output slot (i, r, l): m = meta[i,r,l] (uint8), sid = m >> 3,
// j = m & 7; the slot holds
//     src[wsel[i*nsub + sid]*8 + j, cidx[base[i] + sid, j, l]]
// if sid < min(nact[i], nsub), else the fill. K9 then applies the ⊗ to
// every slot (mul: * w; add_sat: saturating at the fill) and sets sid-31
// slots back to the fill, so a never-written slot holds fill ⊗ w under
// mul, as the Pallas kernel's last-subop pass leaves it (:73-85).
//
// What bounds them on the card: bytes. Per output slot one uint8 meta
// byte, for a live slot one int8 cidx byte and one source value, (K9
// weighted) one weight, and one value written; wsel, base and nact are
// per step and stay in L1/L2. Under one operation per slot, far below the
// card's ~20 operations per byte in f32, so each call is held to (bytes
// moved) / 3.35 TB/s.
//
// Design, simple first. The Pallas kernel walks (step, subop) on a
// sequential grid with the (8,128) source window in VMEM, a lane crossbar
// by cidx and a sublane crossbar by j, keeping a slot where its sid equals
// the subop. The value of a slot depends only on its own meta byte, so
// here the kernel is output-stationary: one thread per output slot, grid-
// stride, coalesced meta reads and writes, the cidx byte and the source
// value two dependent gathers; Hopper's 50 MB L2 takes the place of the
// window DMA. One launch covers every step: the TPU's segmented driver
// (one pallas_call per 2048 steps) exists for its SMEM budget and has no
// counterpart here.
//
// The launcher is extern "C" (bound with ctypes), launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
// Element offsets are 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

using namespace gt;

namespace {

constexpr int SUB = 8;           // rows of a source window
constexpr int SID_INVALID = 31;  // meta sid of a slot that holds the fill

template <typename T, int MUL>
__global__ void __launch_bounds__(THREADS)
windowed_gather_kernel(const T* __restrict__ src, const int* __restrict__ wsel,
                       const int* __restrict__ base,
                       const int* __restrict__ nact,
                       const int8_t* __restrict__ cidx,
                       const uint8_t* __restrict__ meta,
                       const T* __restrict__ w, T* __restrict__ out,
                       long long n, int nsub, int step_el, T fill) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const int m = meta[e];                   // upcast before any compare
    const int sid = m >> 3;
    const int j = m & 7;
    const long long i = e / step_el;
    const int l = static_cast<int>(e % LANES);
    const int na = nact[i];
    T v = fill;
    if (sid < (na < nsub ? na : nsub)) {
      const long long win = wsel[i * nsub + sid];
      const long long blk = static_cast<long long>(base[i]) + sid;
      const int c = cidx[(blk * SUB + j) * LANES + l];
      v = src[(win * SUB + j) * LANES + c];
    }
    if constexpr (MUL != MUL_NONE) {
      v = sid == SID_INVALID ? fill : apply_mul<T, MUL>(v, w, e, fill);
    }
    out[e] = v;
  }
}

template <typename T>
int launch_gather(const void* src, const void* wsel, const void* base,
                  const void* nact, const void* cidx, const void* meta,
                  const void* w, void* out, long long nsteps, int nsub,
                  int block_rows, int mul_kind, double fill,
                  cudaStream_t st) {
  const int step_el = block_rows * LANES;
  const long long n = nsteps * step_el;
  if (n == 0) return cudaGetLastError();
  const T* s = static_cast<const T*>(src);
  const int* ws = static_cast<const int*>(wsel);
  const int* b = static_cast<const int*>(base);
  const int* na = static_cast<const int*>(nact);
  const int8_t* c = static_cast<const int8_t*>(cidx);
  const uint8_t* m = static_cast<const uint8_t*>(meta);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  const T f = static_cast<T>(fill);
  const unsigned blocks = stride_blocks(n);
  switch (mul_kind) {
    case MUL_NONE:
      windowed_gather_kernel<T, MUL_NONE><<<blocks, THREADS, 0, st>>>(
          s, ws, b, na, c, m, wt, o, n, nsub, step_el, f);
      break;
    case MUL_MUL:
      windowed_gather_kernel<T, MUL_MUL><<<blocks, THREADS, 0, st>>>(
          s, ws, b, na, c, m, wt, o, n, nsub, step_el, f);
      break;
    case MUL_ADD_SAT:
      windowed_gather_kernel<T, MUL_ADD_SAT><<<blocks, THREADS, 0, st>>>(
          s, ws, b, na, c, m, wt, o, n, nsub, step_el, f);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K9 (block_rows 8, any ⊗) and K10 (block_rows 64, mul_kind MUL_NONE).
int gt_windowed_gather(const void* src, const void* wsel, const void* base,
                       const void* nact, const void* cidx, const void* meta,
                       const void* w, void* out, long long nsteps, int nsub,
                       int block_rows, int dtype, int mul_kind, double fill,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w == nullptr && mul_kind != MUL_NONE) return cudaErrorInvalidValue;
  if (nsub < 1 || nsub > SID_INVALID || block_rows % SUB != 0 ||
      block_rows <= 0) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case F32:
      return launch_gather<float>(src, wsel, base, nact, cidx, meta, w, out,
                                  nsteps, nsub, block_rows, mul_kind, fill,
                                  st);
    case F64:
      return launch_gather<double>(src, wsel, base, nact, cidx, meta, w, out,
                                   nsteps, nsub, block_rows, mul_kind, fill,
                                   st);
    case I32:
      return launch_gather<int>(src, wsel, base, nact, cidx, meta, w, out,
                                nsteps, nsub, block_rows, mul_kind, fill, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
