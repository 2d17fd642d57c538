// Hopper (sm_90a) kernels of the v2 windowed-gather SpMV pipeline.
//
// Hand-written CUDA C++ counterparts of the two Pallas kernels in
// graphtap_tpu/kernels/gather_kernels.py:
//
//   K9  windowed_gather_kernel<T, MUL>, block_rows 8,
//       replaces windowed_gather   (_wg_body :51-85, call :236-298)
//   K10 windowed_gather64_kernel<T>, block_rows 64,
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
// K9. The Pallas kernel walks (step, subop) on a sequential grid with the
// (8,128) source window in VMEM, a lane crossbar by cidx and a sublane
// crossbar by j, keeping a slot where its sid equals the subop. The value
// of a slot depends only on its own meta byte, so here the kernel is
// output-stationary, one 256-thread block per 8-row step (1,024 slots, the
// step is blockIdx.x: no division): the step's nact, base and wsel entries
// are loaded once per block (wsel into shared memory), and each thread
// resolves 4 slots, 4t .. 4t+3: one 4-byte meta load, its 16-byte weight
// word issued beside it under a ⊗, four independent cidx byte loads, then
// four independent value loads, and one 16-byte streaming store. So the
// dependent chain a slot pays is meta -> cidx -> value, with four chains in
// flight a thread; Hopper's 50 MB L2 takes the place of the window DMA.
// The cidx byte is used signed, as the plain version uses it, and a source
// slot below 0 reads the fill. One launch covers every step: the TPU's
// segmented driver (one pallas_call per 2048 steps) exists for its SMEM
// budget and has no counterpart here.
//
// K10 exists to fetch each (8,128) source window once per 64-row step and
// spend it on the step's 8,192 slots; K9's per-slot form fetches a cidx
// byte and a source value again for every slot. Here one 256-thread block
// owns one step (the step is blockIdx.x: no division); each thread holds
// 32 slots in registers, their meta bytes as eight coalesced 4-byte loads
// (slots 4*(t + 256*g) .. +3, g = 0..7, so a warp's loads and its 16-byte
// stores are contiguous). The step's subops s < min(nact, nsub) are staged in
// rounds of HALF: a ring of RING = 2 * HALF stages in shared memory, each
// one source window (4 KB in f32/i32, 8 KB in f64) and its 1 KB cidx
// block, filled with 16-byte cp.async; round r + 1 is copied into one half
// while round r resolves from the other. In a round each thread resolves
// its slots whose sid falls in it as win[sid][j][cidx[sid][j][l]], both
// from shared memory, so a slot costs one test per round, not one per
// subop. Slots no subop resolves keep the fill. The output is written
// once, as 16-byte streaming stores. The ring, not all 30 windows at once,
// because 30 f64 stages (270 KB) exceed the 227 KB a block may have; RING
// stages take 80 KB in f32 and 144 KB in f64. A step's windows all pass
// through one SM, so a stage of few steps is bound by a few dependent
// memory round trips a step rather than by bytes. A window or cidx block
// outside its table is not copied (a validated plan has none), and a lane
// is taken mod 128.
//
// The launchers are extern "C" (bound with ctypes), launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().
// Element offsets are 64-bit.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"

using namespace gt;

namespace {

constexpr int SUB = 8;           // rows of a source window
constexpr int SID_INVALID = 31;  // meta sid of a slot that holds the fill

constexpr int VEC = 4;                       // slots per meta word / store
constexpr int STEP_EL = SUB * LANES;         // 1,024 slots of a K9 step

// w[4g .. 4g+3] as one 16-byte streaming load (two for f64); w 16-byte
// aligned
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ w, unsigned g,
                                      T* v) {
  if constexpr (sizeof(T) == 8) {
    const double2* p = reinterpret_cast<const double2*>(w) + 2 * g;
    const double2 a = __ldcs(p);
    const double2 b = __ldcs(p + 1);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(w) + g);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(w) + g);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
}

template <typename T, int MUL>
__global__ void __launch_bounds__(THREADS)
windowed_gather_kernel(const T* __restrict__ src, const int* __restrict__ wsel,
                       const int* __restrict__ base,
                       const int* __restrict__ nact,
                       const int8_t* __restrict__ cidx,
                       const uint8_t* __restrict__ meta,
                       const T* __restrict__ w, T* __restrict__ out, int nsub,
                       T fill) {
  __shared__ int s_ws[SID_INVALID];
  const long long i = blockIdx.x;
  const int t = threadIdx.x;
  // the step's scalars, once: wsel into shared memory, nact and base into
  // registers, side by side with this thread's meta word and weights
  if (t < nsub) s_ws[t] = wsel[i * nsub + t];
  const int na = nact[i];
  const int ns = na < nsub ? na : nsub;
  const long long b0 = base[i];
  const unsigned m =
      __ldcs(reinterpret_cast<const unsigned*>(meta + i * STEP_EL) + t);
  T wv[VEC];
  if constexpr (MUL != MUL_NONE) load4<T>(w + i * STEP_EL, t, wv);
  const int l0 = (VEC * t) & (LANES - 1);
  int c[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int mb = (m >> (8 * k)) & 0xff;
    c[k] = 0;
    if ((mb >> 3) < ns) {
      c[k] = __ldg(cidx + ((b0 + (mb >> 3)) * SUB + (mb & 7)) * LANES + l0 +
                   k);
    }
  }
  __syncthreads();                           // s_ws is in
  T v[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int mb = (m >> (8 * k)) & 0xff;
    const int sid = mb >> 3;
    v[k] = fill;
    if (sid < ns) {
      const long long e =
          (static_cast<long long>(s_ws[sid]) * SUB + (mb & 7)) * LANES + c[k];
      if (e >= 0) v[k] = __ldg(src + e);
    }
    if constexpr (MUL != MUL_NONE) {
      v[k] = sid == SID_INVALID ? fill : apply_mul<T, MUL>(v[k], wv, k, fill);
    }
  }
  store4<T>(out + i * STEP_EL, t, v[0], v[1], v[2], v[3]);
}

template <typename T>
int launch_gather(const void* src, const void* wsel, const void* base,
                  const void* nact, const void* cidx, const void* meta,
                  const void* w, void* out, long long nsteps, int nsub,
                  int mul_kind, double fill, cudaStream_t st) {
  if (nsteps == 0) return cudaGetLastError();
  const T* s = static_cast<const T*>(src);
  const int* ws = static_cast<const int*>(wsel);
  const int* b = static_cast<const int*>(base);
  const int* na = static_cast<const int*>(nact);
  const int8_t* c = static_cast<const int8_t*>(cidx);
  const uint8_t* m = static_cast<const uint8_t*>(meta);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  const T f = static_cast<T>(fill);
  const unsigned blocks = static_cast<unsigned>(nsteps);
  switch (mul_kind) {
    case MUL_NONE:
      windowed_gather_kernel<T, MUL_NONE><<<blocks, THREADS, 0, st>>>(
          s, ws, b, na, c, m, wt, o, nsub, f);
      break;
    case MUL_MUL:
      windowed_gather_kernel<T, MUL_MUL><<<blocks, THREADS, 0, st>>>(
          s, ws, b, na, c, m, wt, o, nsub, f);
      break;
    case MUL_ADD_SAT:
      windowed_gather_kernel<T, MUL_ADD_SAT><<<blocks, THREADS, 0, st>>>(
          s, ws, b, na, c, m, wt, o, nsub, f);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K10
constexpr int BLK64 = 64;                    // output rows of a K10 step
constexpr int STEP64_EL = BLK64 * LANES;     // 8,192 slots
constexpr int WIN_EL = SUB * LANES;          // values of one source window
constexpr int HALF = 8;                      // subops of one round
constexpr int RING = 2 * HALF;               // window stages: two rounds
constexpr int NVEC = STEP64_EL / (THREADS * VEC);   // 8 words a thread

// shared memory of one K10 block: RING windows of T, then RING cidx blocks
template <typename T>
constexpr int gather64_smem() {
  return RING * WIN_EL * static_cast<int>(sizeof(T)) + RING * WIN_EL;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
windowed_gather64_kernel(const T* __restrict__ src,
                         const int* __restrict__ wsel,
                         const int* __restrict__ base,
                         const int* __restrict__ nact,
                         const int8_t* __restrict__ cidx,
                         const uint8_t* __restrict__ meta,
                         T* __restrict__ out, int nsub,
                         long long src_windows, long long cidx_blocks,
                         T fill) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_win = reinterpret_cast<T*>(smem);                    // [RING][WIN_EL]
  int8_t* s_cidx = reinterpret_cast<int8_t*>(smem + RING * WIN_EL *
                                             sizeof(T));    // [RING][WIN_EL]
  __shared__ int s_ws[SID_INVALID];
  const long long i = blockIdx.x;
  const int t = threadIdx.x;
  // the step's wsel entries, nact and base, loaded side by side
  if (t < nsub) s_ws[t] = wsel[i * nsub + t];
  const int na = nact[i];
  const int ns = na < nsub ? na : nsub;
  const long long b0 = base[i];

  // each thread's meta words, read while the step's wsel lands
  const unsigned* m32 =
      reinterpret_cast<const unsigned*>(meta + i * STEP64_EL);
  unsigned m[NVEC];
#pragma unroll
  for (int g = 0; g < NVEC; ++g) m[g] = __ldcs(m32 + t + THREADS * g);
  T v[NVEC * VEC];
#pragma unroll
  for (int k = 0; k < NVEC * VEC; ++k) v[k] = fill;
  __syncthreads();

  // copy round r's subops (r*HALF .. r*HALF + HALF-1, below ns) into its
  // half of the ring: 16-byte chunks, spread over the block
  auto load_round = [&](int r) {
    constexpr int WCH = WIN_EL * static_cast<int>(sizeof(T)) / 16;
    constexpr int CCH = WIN_EL / 16;
    const int s0 = r * HALF;
    const int h = (r & 1) * HALF;
    for (int q = t; q < HALF * WCH; q += THREADS) {
      const int k = q / WCH;
      if (s0 + k >= ns) break;
      const long long w = s_ws[s0 + k];
      if (w >= 0 && w < src_windows) {
        cp_async16(reinterpret_cast<char*>(s_win + (h + k) * WIN_EL) +
                       16 * (q % WCH),
                   reinterpret_cast<const char*>(src + w * WIN_EL) +
                       16 * (q % WCH));
      }
    }
    for (int q = t; q < HALF * CCH; q += THREADS) {
      const int k = q / CCH;
      if (s0 + k >= ns) break;
      const long long b = b0 + s0 + k;
      if (b >= 0 && b < cidx_blocks) {
        cp_async16(s_cidx + (h + k) * WIN_EL + 16 * (q % CCH),
                   cidx + b * WIN_EL + 16 * (q % CCH));
      }
    }
  };

  const int nrounds = (ns + HALF - 1) / HALF;
  if (nrounds > 0) load_round(0);
  cp_async_commit();
  for (int r = 0; r < nrounds; ++r) {
    if (r + 1 < nrounds) load_round(r + 1);
    cp_async_commit();
    cp_async_wait<1>();                      // round r's copies landed
    __syncthreads();
    const int s0 = r * HALF;
    const int h = (r & 1) * HALF;
#pragma unroll
    for (int g = 0; g < NVEC; ++g) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int mb = (m[g] >> (8 * k)) & 0xff;
        const int sid = mb >> 3;
        const unsigned d = static_cast<unsigned>(sid - s0);
        if (sid < ns && d < HALF) {
          const int st = (h + static_cast<int>(d)) * WIN_EL + (mb & 7) *
                                                                  LANES;
          const int l = (VEC * t + k) & (LANES - 1);
          v[g * VEC + k] = s_win[st + (s_cidx[st + l] & (LANES - 1))];
        }
      }
    }
    __syncthreads();                         // the half is free for r + 2
  }
  T* o = out + i * STEP64_EL;
#pragma unroll
  for (int g = 0; g < NVEC; ++g) {
    store4<T>(o, t + THREADS * g, v[g * VEC], v[g * VEC + 1],
              v[g * VEC + 2], v[g * VEC + 3]);
  }
}

template <typename T>
int launch_gather64(const void* src, const void* wsel, const void* base,
                    const void* nact, const void* cidx, const void* meta,
                    void* out, long long nsteps, int nsub,
                    long long src_windows, long long cidx_blocks,
                    double fill, cudaStream_t st) {
  constexpr int smem = gather64_smem<T>();
  // above 48 KB a block's shared memory is opted into once per type
  static const cudaError_t opt = cudaFuncSetAttribute(
      windowed_gather64_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt != cudaSuccess) return opt;
  if (nsteps > 0) {
    windowed_gather64_kernel<T><<<static_cast<unsigned>(nsteps), THREADS,
                                  smem, st>>>(
        static_cast<const T*>(src), static_cast<const int*>(wsel),
        static_cast<const int*>(base), static_cast<const int*>(nact),
        static_cast<const int8_t*>(cidx), static_cast<const uint8_t*>(meta),
        static_cast<T*>(out), nsub, src_windows, cidx_blocks,
        static_cast<T>(fill));
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K9: 8-row steps, any ⊗. meta (nsteps, 8, 128), w (nsteps, 8, 128) and
// out 16-byte aligned.
int gt_windowed_gather(const void* src, const void* wsel, const void* base,
                       const void* nact, const void* cidx, const void* meta,
                       const void* w, void* out, long long nsteps, int nsub,
                       int dtype, int mul_kind, double fill, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w == nullptr && mul_kind != MUL_NONE) return cudaErrorInvalidValue;
  if (nsub < 1 || nsub > SID_INVALID || nsteps < 0 ||
      nsteps >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case F32:
      return launch_gather<float>(src, wsel, base, nact, cidx, meta, w, out,
                                  nsteps, nsub, mul_kind, fill, st);
    case F64:
      return launch_gather<double>(src, wsel, base, nact, cidx, meta, w, out,
                                   nsteps, nsub, mul_kind, fill, st);
    case I32:
      return launch_gather<int>(src, wsel, base, nact, cidx, meta, w, out,
                                nsteps, nsub, mul_kind, fill, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// K10: 64-row steps, no ⊗. src (src_windows * 8, 128), cidx
// (cidx_blocks, 8, 128), meta (nsteps, 64, 128); src, cidx, meta and out
// 16-byte aligned.
int gt_windowed_gather64(const void* src, const void* wsel, const void* base,
                         const void* nact, const void* cidx,
                         const void* meta, void* out, long long nsteps,
                         int nsub, long long src_windows,
                         long long cidx_blocks, int dtype, double fill,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nsub < 1 || nsub > SID_INVALID || nsteps < 0 ||
      nsteps >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case F32:
      return launch_gather64<float>(src, wsel, base, nact, cidx, meta, out,
                                    nsteps, nsub, src_windows, cidx_blocks,
                                    fill, st);
    case F64:
      return launch_gather64<double>(src, wsel, base, nact, cidx, meta, out,
                                     nsteps, nsub, src_windows, cidx_blocks,
                                     fill, st);
    case I32:
      return launch_gather64<int>(src, wsel, base, nact, cidx, meta, out,
                                  nsteps, nsub, src_windows, cidx_blocks,
                                  fill, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
