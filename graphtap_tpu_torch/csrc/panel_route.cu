// Hopper (sm_90a) kernels of the v3 panel-route SpMV pipeline.
//
// Hand-written CUDA C++ counterparts of the Pallas kernels of
// graphtap_tpu/kernels/panel_kernels.py:
//
//   K1  route_xr_exp_kernel   replaces route_xr_exp  (_xr_exp_body, :140-273)
//   K2  route_passa_kernel    replaces route_passa   (_route_body, :80-137,
//                             :435-485), two-layer 64-row and single-layer
//                             32-row (out_rows, two_layer)
//   K3  route_fold_kernel     replaces route_fold    (_route_fold_body,
//                             :276-404)
//   K4  hub_fold_kernel       replaces hub_fold      (_hub_body, :488-528)
//   K11 route_expand_kernel   replaces route_expand  (_route_body, :407-432)
//   K12 fold_stripes_kernel   replaces fold_stripes  (_fold_body, :531-554)
//   K13 colsum_chunks_kernel  replaces colsum_chunks (_chunk_body, :557-593)
//
// K1-K4 carry the fused PageRank superstep; K2 single-layer, K11, K12 and
// K13 are the staged (unfused) pipeline's: x -> x_ext (K2 single-layer),
// x_ext -> contributions (K11, the second stage of K1), the corner turn and
// the fixr route (K2), the chunk fold (K13); K12 is the per-panel 8-row
// fold (pass B).
//
// K1-K3 each have a gated launch, the frontier-gated variant of the Pallas
// kernels' plan_idx branch (:226-242, :356-372, :453-461): panel p reads
// plan block plan_idx[p] (and K1 its weight block there) instead of block
// p; window bases, and K3's row -> bands list, stay panel p's. A panel whose
// plan_idx is the route's fill block (fill_block, an all-0xF8 plan that
// routes pure ⊕-identity; validate_meta checks it on the host) skips its
// gathers: K1 writes fill ⊗ w, K2 writes fill, K3 writes fill band
// partials. That is what the fill plan computes, so a
// gated launch equals its plain version fed that plan; on the TPU the
// same redirection makes the revolving buffers skip their fetches.
// plan_idx == nullptr is the static launch, unchanged.
//
// What they compute. The host planner (panel_plan.py) turns the sparse
// matrix into uint8 route plans over (64,128) panels. A route reads 8-row
// source bands and, for output slot (r, l):
//   m = idx3[r,l] & 127; s = (idx3[r,l] >= 128 ? sel_b : sel_a)[r, m];
//   band = s >> 3, row = s & 7;
//   out = band < nsrc ? src_band[band][row, idx1[band*8+row, m]] : fill.
// A single-layer route (the x -> x_ext route) has no sel_b and ignores the
// pick bit. On the TPU that is three crossbar stages over registers; here
// it is three dependent byte loads and one value load per output. The
// plans are the same bytes the Pallas kernels read, so each kernel can be
// checked against its twin.
//
// What bounds them on the card: memory traffic and latency, not arithmetic.
// Per output each route reads 3 plan bytes plus one value; the value and
// idx1/sel reads are data-dependent gathers inside 128-lane rows. Read
// from device memory, that is a chain of four dependent loads a slot, and
// most of K1's and K3's bytes are plan bytes (~0.5 KB of plan per 4 KB f32
// panel). So K1, K2, K3 and K11 share one plan ring (plan_ring below):
// persistent blocks, each walking panels blockIdx.x, + gridDim.x, ...,
// copy each panel's contiguous plan block (and, in K2's staged form, its
// source windows; in K11, its x_ext block) into a shared-memory stage with
// TMA bulk copies on an mbarrier, one panel's copies landing while the
// block resolves another; the sel -> idx1 chains resolve out of shared
// memory (K1, K2 and K11: four slots a thread from one 4-byte idx3 word;
// K3: one (band, lane) a thread), the value last: from shared memory (K1's
// expand stage and K11, one helper: expand_stage; K2 staged) or by a
// read-only load of device memory. Per panel the plan arrives in one bulk
// read, so the kernels are held to bytes, not to the chain. K1 builds its 32x128 x_ext panel in shared memory (x_ext never
// goes to device memory) and expands it; K3 folds each routed 8-row band
// in registers, in row order, into a
// (npanels*8, 128) scratch of band partials; then one thread per (y row,
// lane) folds its row's bands in ascending band (panel) order, the Pallas
// grid's order, in runs of 64 and then the runs' results, from the
// identity, and writes y once (common.cuh, pass (b); the row -> bands
// lists are built once per upload from dst and seg, kernels/fold_order.py).
// So its float sums come out the same on every call, and equal the plain
// version's bit for bit: an atomic fold, whose order changed from call to
// call, kept f32 PageRank's convergence vote from closing.
//
// K13 folds in the Pallas grid's order too: each y row from the identity,
// its chunks in ascending chunk order (the row -> chunks list, built once
// per upload), each chunk's 8 rows in row order into a part first; y is
// written once, with no atomic and no fill pass, so its float sums equal
// the plain version's bit for bit on every call. A row of many chunks (a
// hub row) has its parts folded across the card first and its chain run
// by a block that stages them in shared memory (see colsum_chunks_kernel).
// K12 needs no atomics: one thread per output folds its 8 rows in order.
// K12 moves each byte once, K13 too but for its long rows' parts; both are
// bound by device memory. K4 runs one 128-thread block per row: warp
// shuffles for the xor shifts 1..16 and shared memory for 32 and 64, in
// the Pallas kernel's order, so it is bit-exact. All element offsets are
// 64-bit.
//
// The launchers are extern "C" (bound with ctypes), launch on the caller's
// stream, allocate nothing, and return cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"

using namespace gt;

namespace {

constexpr int STRIPE = 8;
constexpr int PROWS = 64;   // rows of a contribution / corner-turn panel
constexpr int XROWS = 32;   // rows of an x_ext panel

__host__ __device__ __forceinline__ long long route_rows(int src_rows,
                                                         int out_rows,
                                                         bool two_layer) {
  return src_rows + (two_layer ? 3LL : 2LL) * out_rows;
}

// Rows of an expand-route plan block (two-layer, x_ext source, 64 out).
constexpr int EX_PROWS = XROWS + 3 * PROWS;

// Plan block of block p: p itself (static) or plan_idx[p] (gated).
__device__ __forceinline__ long long plan_block(const int* __restrict__ pidx,
                                                long long p) {
  return pidx == nullptr ? p : static_cast<long long>(pidx[p]);
}

// ------------------------------------------------------- the plan ring
// K1-K3's and K11's persistent walk over panels through shared-memory
// stages (the TMA helpers are common.cuh's). A stage holds one panel's
// whole plan block (one TMA bulk copy, contiguous and 128-byte aligned)
// and whatever else the kernel copies beside it; every copy of a stage
// completes on the stage's mbarrier.
constexpr int VEC = 4;                       // slots a thread resolves at once
constexpr int WIN_EL = STRIPE * LANES;       // values of one source window
constexpr int SMEM_BLOCK = 232448;           // shared memory a block may have
constexpr int MBAR_BYTES = 8;                // one mbarrier a stage

// Called by warp 0: lane 0 arrives on bar expecting plan block q's
// plan_bytes plus `extra` bytes that other lanes copy on the same phase,
// and copies block q into dst. A gated panel at the fill block copies
// nothing and arrives expecting 0 bytes, so its stage's phase completes.
// A launch reads each plan block once, so the copy carries an L2
// evict-first hint: the plan stream (255 MB for K3's fixr at RMAT-20)
// does not push the gathers' sources out of L2 (K3's fix2 source, 16.8
// MB, stays there).
__device__ __forceinline__ void plan_copy(uint64_t* bar, void* dst,
                                          const uint8_t* __restrict__ plan,
                                          long long q, int plan_bytes,
                                          bool fill_panel, unsigned extra) {
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive_tx(bar, fill_panel ? 0u : plan_bytes + extra);
    if (!fill_panel) {
      asm volatile(
          "{\n.reg .b64 pol;\n"
          "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".L2::cache_hint [%0], [%1], %2, [%3], pol;\n}\n" ::"r"(
              smem_addr(dst)),
          "l"(plan + q * plan_bytes), "r"(plan_bytes), "r"(smem_addr(bar))
          : "memory");
    }
  }
}

// The walk: warp 0 fills stage s with panel p by load(p, s) (TMA copies
// completing on bar[s]); body(p, s) runs once they have landed; the stage
// is refilled with panel p + stages*gridDim.x as soon as every thread is
// done with it, so with two stages one panel's copies land while the
// other resolves. bar: `stages` mbarriers in shared memory.
template <typename Load, typename Body>
__device__ __forceinline__ void plan_ring(long long npanels, int stages,
                                          uint64_t* bar, Load&& load,
                                          Body&& body) {
  const int t = threadIdx.x;
  const long long G = gridDim.x;
  if (t == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bar[s], 1);
    fence_mbar_init();
  }
  __syncthreads();
  long long p = blockIdx.x;
  if (t < 32) {
    for (int s = 0; s < stages && p + s * G < npanels; ++s) {
      load(p + s * G, s);
    }
  }
  for (int k = 0; p < npanels; ++k, p += G) {
    const int s = k % stages;
    mbar_wait(&bar[s], (k / stages) & 1);
    body(p, s);
    __syncthreads();                 // stage s is free for the next panel
    if (t < 32 && p + stages * G < npanels) {
      fence_async_smem();
      load(p + stages * G, s);
    }
  }
}

// One route slot resolved out of a plan block in shared memory: its sel
// byte (sel_b where the pick bit of i3 is set, in a two-layer route) and
// idx1 lane; returns false for a band >= nsrc (the fill).
__device__ __forceinline__ bool slot_at(const uint8_t* idx1,
                                        const uint8_t* sel_a,
                                        const uint8_t* sel_b, int r, int i3,
                                        int nsrc, int* band, int* row,
                                        int* lane) {
  const int m = i3 & 127;
  const int sv = (i3 >= 128 ? sel_b : sel_a)[r * LANES + m];
  *band = sv >> 3;
  *row = sv & 7;
  if (*band >= nsrc) return false;
  *lane = idx1[(*band * STRIPE + *row) * LANES + m] & (LANES - 1);
  return true;
}

// v[k] ⊗= the weights pw[4g + k] (one 16-byte word; MUL_NONE: none).
template <typename T, int MUL>
__device__ __forceinline__ void mul4(T (&v)[VEC], const T* __restrict__ pw,
                                     unsigned g, T fill) {
  if constexpr (MUL != MUL_NONE) {
    T wv[VEC];
    load4<T>(pw, g, wv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = apply_mul<T, MUL>(v[k], wv, k, fill);
  }
}

// The expand route of one panel, out of shared memory (K1's second stage,
// and K11): the plan block ex [idx1 (32), sel_a, sel_b, idx3 (64 each)]
// routes the 32-row x_ext panel xe (4 source bands; bands 4..31 are the
// fill) two-layer into the 64-row panel po, then ⊗ with the panel's
// weights pw. Each of the NT threads resolves four slots at a time: one
// 4-byte idx3 word, four sel -> idx1 -> value chains, a 16-byte weight
// word under mul/add_sat, and one 16-byte streaming store.
template <typename T, int MUL, int NT>
__device__ __forceinline__ void expand_stage(const uint8_t* ex, const T* xe,
                                             const T* __restrict__ pw,
                                             T* __restrict__ po, T fill) {
  const int t = threadIdx.x;
  const uint8_t* ei1 = ex;
  const uint8_t* esa = ei1 + XROWS * LANES;
  const uint8_t* esb = esa + PROWS * LANES;
  const uint8_t* ei3 = esb + PROWS * LANES;
#pragma unroll 2
  for (int g = 0; g < PROWS * LANES / (NT * VEC); ++g) {
    const int e = VEC * (t + NT * g);
    const unsigned w3 = *reinterpret_cast<const unsigned*>(ei3 + e);
    T v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      int band, row, l;
      v[k] = slot_at(ei1, esa, esb, e >> 7, (w3 >> (8 * k)) & 0xff,
                     XROWS / STRIPE, &band, &row, &l)
                 ? xe[(band * STRIPE + row) * LANES + l]
                 : fill;
    }
    mul4<T, MUL>(v, pw, t + NT * g, fill);
    store4<T>(po, t + NT * g, v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------- K1
// x table -> (64,128) contribution panel per panel: the single-layer
// x -> x_ext route of the panel's nwin x windows into shared memory, the
// two-layer expand route out of it (expand_stage), then ⊗ with the weight
// stream. Plan
// block per panel: [xr_idx1 (nwin*8), xr_sel_a (32), xr_idx3 (32),
// ex_idx1 (32), ex_sel_a (64), ex_sel_b (64), ex_idx3 (64)] rows of 128.
//
// Plan ring of XE_STAGES stages, each one plan block (61,440 bytes at
// nwin 24), and beside them the x_ext panel xe (16 KB f32, 32 KB f64): one
// block an SM, of 512 threads (16 warps hide the x gathers' L2 latency
// better than 8 did at RMAT-20). Stage 1 resolves four slots a thread out
// of the staged plan, the x value by a read-only load (24 windows, 96 KB
// in f32, do not fit beside two stages; the x table sits in L2), into xe;
// stage 2 (expand_stage) resolves four slots a thread wholly out of
// shared memory, reads a 16-byte weight word under mul/add_sat, and writes
// one 16-byte streaming store. Gated: plan (and weight) block
// plan_idx[p], bases still panel p's; a panel at fill_block copies nothing
// and writes fill ⊗ w.
constexpr int XE_STAGES = 2;
constexpr int XE_THREADS = 512;

__host__ __device__ __forceinline__ long long xe_plan_bytes(int nwin) {
  return (route_rows(nwin * STRIPE, XROWS, false) + EX_PROWS) * LANES;
}
inline long long xe_smem(int nwin, long long value_bytes) {
  return XE_STAGES * (xe_plan_bytes(nwin) + MBAR_BYTES) +
         static_cast<long long>(XROWS) * LANES * value_bytes;
}

template <typename T, int MUL>
__global__ void __launch_bounds__(XE_THREADS, 1)
route_xr_exp_kernel(const T* __restrict__ x2d, const int* __restrict__ bases,
                    const uint8_t* __restrict__ plan,
                    const T* __restrict__ w, T* __restrict__ out,
                    long long npanels, int nwin, T fill,
                    const int* __restrict__ plan_idx, int fill_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sr = nwin * STRIPE;
  const int xr_bytes = static_cast<int>(route_rows(sr, XROWS, false)) * LANES;
  const int plan_bytes = static_cast<int>(xe_plan_bytes(nwin));
  T* xe = reinterpret_cast<T*>(smem + XE_STAGES * plan_bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(xe + XROWS * LANES);
  const int t = threadIdx.x;
  auto load = [&](long long p, int s) {
    const long long q = plan_block(plan_idx, p);
    plan_copy(&bar[s], smem + s * plan_bytes, plan, q, plan_bytes,
              plan_idx != nullptr && q == fill_block, 0);
  };
  plan_ring(npanels, XE_STAGES, bar, load, [&](long long p, int s) {
    const long long q = plan_block(plan_idx, p);
    T* po = out + p * PROWS * LANES;
    const T* pw = (MUL == MUL_NONE) ? nullptr : w + q * PROWS * LANES;
    if (plan_idx != nullptr && q == fill_block) {
#pragma unroll
      for (int g = 0; g < PROWS * LANES / (XE_THREADS * VEC); ++g) {
        T v[VEC] = {fill, fill, fill, fill};
        mul4<T, MUL>(v, pw, t + XE_THREADS * g, fill);
        store4<T>(po, t + XE_THREADS * g, v[0], v[1], v[2], v[3]);
      }
      return;
    }
    // stage 1: x -> xe, single-layer (the pick bit is ignored)
    const uint8_t* xi1 = smem + s * plan_bytes;
    const uint8_t* xsa = xi1 + sr * LANES;
    const uint8_t* xi3 = xsa + XROWS * LANES;
    const int* pb = bases + p * nwin;
#pragma unroll
    for (int g = 0; g < XROWS * LANES / (XE_THREADS * VEC); ++g) {
      const int e = VEC * (t + XE_THREADS * g);
      const unsigned w3 = *reinterpret_cast<const unsigned*>(xi3 + e);
      T v[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        int band, row, l;
        v[k] = fill;
        if (slot_at(xi1, xsa, xsa, e >> 7, (w3 >> (8 * k)) & 0x7f, nwin,
                    &band, &row, &l)) {
          const long long b = __ldg(pb + band);
          v[k] = __ldg(x2d + (b * STRIPE + row) * LANES + l);
        }
      }
      put4<T>(xe, t + XE_THREADS * g, v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    // stage 2: xe (4 source bands) -> 64 rows, two-layer, then ⊗ w
    expand_stage<T, MUL, XE_THREADS>(xi1 + xr_bytes, xe, pw, po, fill);
  });
}

// ---------------------------------------------------------------- K11
// x_ext table (npanels*32, 128) -> (64,128) contribution panel per panel:
// K1's second stage alone. Plan rows per panel: [idx1 (32), sel_a (64),
// sel_b (64), idx3 (64)], 28,672 bytes.
//
// What bounds it: bytes. Per panel the 28,672-byte plan block and the
// panel's own x_ext block (16 KB in f32/int32, 32 KB in f64) come in and
// 32 KB (64 KB) of contributions go out, read once each; every route read
// is then a shared-memory read. So K11 runs on the plan ring: persistent
// blocks, a stage holding the panel's plan block (plan_copy, evict-first)
// and its x_ext block beside it (one bulk copy on the same mbarrier), two
// stages a block (90,128 bytes in f32: two blocks an SM; 122,896 in f64:
// one), so one panel's 44.7 KB land while the other resolves; the body is
// expand_stage, four slots a thread of EX_THREADS (512 threads were no
// faster than 256 at RMAT-20 on the H100: PERF.md).
constexpr int EX_STAGES = 2;
constexpr int EX_THREADS = 256;

template <typename T>
__host__ __device__ constexpr int ex_stage_bytes() {
  return EX_PROWS * LANES + XROWS * LANES * static_cast<int>(sizeof(T));
}
template <typename T>
constexpr long long ex_smem() {
  return EX_STAGES * (ex_stage_bytes<T>() + MBAR_BYTES);
}

template <typename T, int MUL>
__global__ void __launch_bounds__(EX_THREADS)
route_expand_kernel(const T* __restrict__ x_ext,
                    const uint8_t* __restrict__ plan,
                    const T* __restrict__ w, T* __restrict__ out,
                    long long npanels, T fill) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PLAN = EX_PROWS * LANES;
  constexpr int STAGE = ex_stage_bytes<T>();
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + EX_STAGES * STAGE);
  auto load = [&](long long p, int s) {
    unsigned char* dst = smem + s * STAGE;
    plan_copy(&bar[s], dst, plan, p, PLAN, false, STAGE - PLAN);
    if ((threadIdx.x & 31) == 0) {
      bulk_load(dst + PLAN, x_ext + p * XROWS * LANES, STAGE - PLAN, &bar[s]);
    }
  };
  plan_ring(npanels, EX_STAGES, bar, load, [&](long long p, int s) {
    const uint8_t* ex = smem + s * STAGE;
    const T* pw = (MUL == MUL_NONE) ? nullptr : w + p * PROWS * LANES;
    expand_stage<T, MUL, EX_THREADS>(ex, reinterpret_cast<const T*>(ex + PLAN),
                                     pw, out + p * PROWS * LANES, fill);
  });
}

// ---------------------------------------------------------------- K2
// Corner turn: the panel's nwin 8-row windows of src (block indices
// bases[p*nwin + band]) routed into an out_rows-row panel: two-layer
// (64 rows; plan [idx1 (nwin*8), sel_a, sel_b, idx3]) or single-layer
// (the x -> x_ext route, 32 rows; plan [idx1, sel_a, idx3]).
//
// A plan ring of two stages. In the STAGED form a stage also holds the
// panel's nwin source windows beside the plan block (one bulk copy each,
// 4 KB in f32/int32, 8 KB in f64). Each thread resolves 4 slots at a
// time: one 4-byte idx3 word, then four independent sel -> idx1 -> value
// chains, all out of shared memory (STAGED) or the last one a read-only
// load of device memory (unstaged: the windows do not fit two stages), and
// one 16-byte streaming store. A window whose base lies outside the source
// table is not copied (a validated plan has none), a band >= nwin is the
// fill and reads nothing, and a lane is taken mod 128. Gated: plan block
// plan_idx[p], bases still panel p's; a panel pointed at fill_block copies
// nothing and writes the fill.
constexpr int PASSA_STAGES = 2;

template <typename T, bool STAGED>
__global__ void __launch_bounds__(THREADS)
route_passa_kernel(const T* __restrict__ src, const int* __restrict__ bases,
                   const uint8_t* __restrict__ plan, T* __restrict__ out,
                   long long npanels, int nwin, int out_rows, bool two_layer,
                   T fill, const int* __restrict__ plan_idx, int fill_block,
                   long long src_windows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sr = nwin * STRIPE;
  const int plan_bytes =
      static_cast<int>(route_rows(sr, out_rows, two_layer)) * LANES;
  const int stage_bytes =
      plan_bytes + (STAGED ? nwin * WIN_EL * static_cast<int>(sizeof(T)) : 0);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem + PASSA_STAGES * stage_bytes);
  const int t = threadIdx.x;
  const int lane = t & 31;

  // warp 0: copy panel p's plan block (and windows) into stage s
  auto load = [&](long long p, int s) {
    const long long q = plan_block(plan_idx, p);
    const bool fill_panel = plan_idx != nullptr && q == fill_block;
    unsigned char* dst = smem + s * stage_bytes;
    long long wb = -1;
    unsigned mine = 0;
    if (STAGED && !fill_panel && lane < nwin) {    // nwin <= 32 when STAGED
      wb = bases[p * nwin + lane];
      if (wb >= 0 && wb < src_windows) mine = WIN_EL * sizeof(T);
    }
    unsigned bytes = mine;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      bytes += __shfl_xor_sync(FULL_MASK, bytes, o);
    }
    plan_copy(&bar[s], dst, plan, q, plan_bytes, fill_panel, bytes);
    if (mine != 0) {
      bulk_load(dst + plan_bytes + lane * mine, src + wb * WIN_EL, mine,
                &bar[s]);
    }
  };

  const int nvec = out_rows * LANES / (THREADS * VEC);   // 8 or 4
  plan_ring(npanels, PASSA_STAGES, bar, load, [&](long long p, int s) {
    const long long q = plan_block(plan_idx, p);
    T* po = out + p * out_rows * LANES;
    if (plan_idx != nullptr && q == fill_block) {
      for (int g = 0; g < nvec; ++g) {
        store4<T>(po, t + THREADS * g, fill, fill, fill, fill);
      }
      return;
    }
    const uint8_t* idx1 = smem + s * stage_bytes;
    const uint8_t* sel_a = idx1 + sr * LANES;
    const uint8_t* sel_b = two_layer ? sel_a + out_rows * LANES : sel_a;
    const uint8_t* idx3 = sel_a + (two_layer ? 2 : 1) * out_rows * LANES;
    const T* win = reinterpret_cast<const T*>(idx1 + plan_bytes);
    const int* pb = bases + p * nwin;
#pragma unroll 2
    for (int g = 0; g < nvec; ++g) {
      const int e = VEC * (t + THREADS * g);
      const unsigned w3 = *reinterpret_cast<const unsigned*>(idx3 + e);
      T v[VEC];
#pragma unroll
      for (int k4 = 0; k4 < VEC; ++k4) {
        int band, row, l;
        v[k4] = fill;
        if (slot_at(idx1, sel_a, sel_b, e >> 7, (w3 >> (8 * k4)) & 0xff,
                    nwin, &band, &row, &l)) {
          if constexpr (STAGED) {
            v[k4] = win[band * WIN_EL + row * LANES + l];
          } else {
            const long long b = __ldg(pb + band);
            v[k4] = __ldg(src + (b * STRIPE + row) * LANES + l);
          }
        }
      }
      store4<T>(po, t + THREADS * g, v[0], v[1], v[2], v[3]);
    }
  });
}

// ---------------------------------------------------------------- K3
// Pass (a): route as K2 (two-layer, 64 rows, values by read-only loads:
// fixr's 31 windows are 124 KB, more than fit beside the plan) and fold
// each routed 8-row band ob lane-wise in registers, rows 0..7 in order,
// into part[(p*8 + ob), l]. A plan ring of `stages` stages of one plan
// block each (two where two fit a block, to nwin 89; one to nwin 202; the
// wrapper's fold_stages picks). One thread a (band, lane), 1,024 threads:
// per row one idx3 byte and one chain out of the staged plan, 8
// independent chains a thread, then one store of the band partial.
//
// What bounds it: each 4-byte gather moves a 32-byte sector from L2 to the
// SM (a fixr panel touches ~90% of the sectors of its ~21.5 distinct
// windows, 8,192 gathers). So a block asks for at least FOLD_SMEM_MIN
// bytes of shared memory, more than half an SM's: one block runs an SM,
// and the SM's L1 keeps ~124 KB, room for a panel's windows (86 KB on
// average at RMAT-20's fixr), where two blocks an SM left it ~28 KB. A
// gated panel pointed at the fill block copies nothing and writes the
// fill (what the fill plan folds to).
constexpr int FOLD_THREADS = STRIPE * LANES;   // one (band, lane) a thread
constexpr int FOLD_SMEM_MIN = 118784;          // 116 KB: one block an SM

template <typename T, int RED>
__global__ void __launch_bounds__(FOLD_THREADS, 1)
route_fold_kernel(const T* __restrict__ src, const int* __restrict__ bases,
                  const uint8_t* __restrict__ plan, T* __restrict__ part,
                  long long npanels, int nwin, int stages, T fill,
                  const int* __restrict__ plan_idx, int fill_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sr = nwin * STRIPE;
  const int plan_bytes = static_cast<int>(route_rows(sr, PROWS, true)) * LANES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + stages * plan_bytes);
  const int t = threadIdx.x;
  const int ob = t >> 7;                     // the thread's band
  const int l = t & (LANES - 1);             // and lane
  auto load = [&](long long p, int s) {
    const long long q = plan_block(plan_idx, p);
    plan_copy(&bar[s], smem + s * plan_bytes, plan, q, plan_bytes,
              plan_idx != nullptr && q == fill_block, 0);
  };
  plan_ring(npanels, stages, bar, load, [&](long long p, int s) {
    const long long q = plan_block(plan_idx, p);
    T* pp = part + p * STRIPE * LANES;
    if (plan_idx != nullptr && q == fill_block) {
      pp[t] = fill;
      return;
    }
    const uint8_t* idx1 = smem + s * plan_bytes;
    const uint8_t* sel_a = idx1 + sr * LANES;
    const uint8_t* sel_b = sel_a + PROWS * LANES;
    const uint8_t* idx3 = sel_b + PROWS * LANES;
    const int* pb = bases + p * nwin;
    T v[STRIPE];
#pragma unroll
    for (int r = 0; r < STRIPE; ++r) {
      const int row_out = ob * STRIPE + r;
      int band, row, lane;
      v[r] = fill;
      if (slot_at(idx1, sel_a, sel_b, row_out, idx3[row_out * LANES + l],
                  nwin, &band, &row, &lane)) {
        const long long b = __ldg(pb + band);
        v[r] = __ldg(src + (b * STRIPE + row) * LANES + lane);
      }
    }
    T acc = v[0];
#pragma unroll
    for (int r = 1; r < STRIPE; ++r) acc = combine<RED>(acc, v[r]);
    pp[t] = acc;
  });
}

// ---------------------------------------------------------------- K4
// One row per 128-thread block. The xor butterfly over lane shifts
// 1, 2, 4, 8, 16 (warp shuffles), then 32 and 64 (shared memory), with
// snapshots at group widths 32/64/128 picked by the row's hub code.
template <typename T, int RED>
__global__ void __launch_bounds__(LANES)
hub_fold_kernel(const T* __restrict__ v, const uint8_t* __restrict__ hm,
                T* __restrict__ out) {
  __shared__ T buf[LANES];
  const int l = threadIdx.x;
  const long long i = static_cast<long long>(blockIdx.x) * LANES + l;
  const T x = v[i];
  T acc = x;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    acc = combine<RED>(acc, __shfl_xor_sync(0xffffffffu, acc, s));
  }
  const T a32 = acc;
  buf[l] = acc;
  __syncthreads();
  acc = combine<RED>(acc, buf[l ^ 32]);
  __syncthreads();
  const T a64 = acc;
  buf[l] = acc;
  __syncthreads();
  acc = combine<RED>(acc, buf[l ^ 64]);
  const int code = hm[i];
  out[i] = code == 32 ? a32 : code == 64 ? a64 : code == 128 ? acc : x;
}

// ---------------------------------------------------------------- K12
// Pass B: output row r (row d of panel r/8) is the ⊕ of input rows
// r*8 .. r*8+7, folded in that order. One thread per output slot.
template <typename T, int RED>
__global__ void __launch_bounds__(THREADS)
fold_stripes_kernel(const T* __restrict__ s1, T* __restrict__ out,
                    long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const T* src = s1 + (i >> 7) * STRIPE * LANES + (i & 127);
    T acc = src[0];
#pragma unroll
    for (int k = 1; k < STRIPE; ++k) acc = combine<RED>(acc, src[k * LANES]);
    out[i] = acc;
  }
}

// ---------------------------------------------------------------- launch
// A ring kernel (K1-K3) opted in to a block's whole shared memory, as a
// kernel past 48 KB must be, once per kernel: Id names the kernel instance.
template <typename T, int KERNEL, int FORM>
struct RingId {};

template <typename Id, typename Kern>
cudaError_t ring_ready(Kern kern) {
  static const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BLOCK);
  return rc;
}

// Blocks of `threads` with `smem` bytes of dynamic shared memory each that
// one SM holds at once (ready: ring_ready's result for kern).
template <typename Kern>
cudaError_t ring_blocks_per_sm(Kern kern, cudaError_t ready, int threads,
                               long long smem, int* per_sm) {
  if (ready != cudaSuccess) return ready;
  if (smem > SMEM_BLOCK) return cudaErrorInvalidValue;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kern, threads, static_cast<size_t>(smem));
  if (rc != cudaSuccess) return rc;
  return *per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Launch a ring kernel on a persistent grid: as many blocks as the SMs
// hold at once at this footprint, at most npanels.
template <typename Kern, typename... Args>
int ring_launch(Kern kern, cudaError_t ready, int threads, long long smem,
                long long npanels, cudaStream_t st, Args... args) {
  if (npanels <= 0) return cudaGetLastError();
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t rc = ring_blocks_per_sm(kern, ready, threads, smem, &per_sm);
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc != cudaSuccess) return rc;
  const long long cap = static_cast<long long>(sms) * per_sm;
  kern<<<static_cast<unsigned>(npanels < cap ? npanels : cap), threads,
         static_cast<size_t>(smem), st>>>(args...);
  return cudaGetLastError();
}

// K3's footprint: `stages` plan blocks of nwin windows, an mbarrier each,
// and at least FOLD_SMEM_MIN bytes (one block an SM).
inline long long fold_smem(int nwin, int stages) {
  const long long ring = stages * (route_rows(nwin * STRIPE, PROWS, true) *
                                       LANES +
                                   MBAR_BYTES);
  return ring < FOLD_SMEM_MIN ? FOLD_SMEM_MIN : ring;
}

template <typename T, int MUL>
int launch_xr_exp_mul(const void* x2d, const void* bases, const void* plan,
                      const void* w, void* out, long long npanels, int nwin,
                      double fill, const int* pidx, int fill_block,
                      cudaStream_t st) {
  auto kern = route_xr_exp_kernel<T, MUL>;
  return ring_launch(kern, ring_ready<RingId<T, 1, MUL>>(kern), XE_THREADS,
                     xe_smem(nwin, sizeof(T)), npanels, st,
                     static_cast<const T*>(x2d),
                     static_cast<const int*>(bases),
                     static_cast<const uint8_t*>(plan),
                     static_cast<const T*>(w), static_cast<T*>(out),
                     npanels, nwin, static_cast<T>(fill), pidx, fill_block);
}

template <typename T>
int launch_xr_exp(const void* x2d, const void* bases, const void* plan,
                  const void* w, void* out, long long npanels, int nwin,
                  int mul_kind, double fill, const int* pidx, int fill_block,
                  cudaStream_t st) {
  switch (mul_kind) {
    case MUL_NONE:
      return launch_xr_exp_mul<T, MUL_NONE>(x2d, bases, plan, w, out,
                                            npanels, nwin, fill, pidx,
                                            fill_block, st);
    case MUL_MUL:
      return launch_xr_exp_mul<T, MUL_MUL>(x2d, bases, plan, w, out, npanels,
                                           nwin, fill, pidx, fill_block, st);
    case MUL_ADD_SAT:
      return launch_xr_exp_mul<T, MUL_ADD_SAT>(x2d, bases, plan, w, out,
                                               npanels, nwin, fill, pidx,
                                               fill_block, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Blocks an SM holds at once of K1 (kernel 1; its no-⊗ instance), K3's
// pass (a) (kernel 3, at ring depth `stages`; its sum instance) or K11
// (kernel 11; its no-⊗ instance; nwin and stages unused).
template <typename T>
int ring_blocks(int kernel, int nwin, int stages, int* per_sm) {
  if (kernel == 1) {
    auto kern = route_xr_exp_kernel<T, MUL_NONE>;
    return ring_blocks_per_sm(kern, ring_ready<RingId<T, 1, MUL_NONE>>(kern),
                              XE_THREADS, xe_smem(nwin, sizeof(T)), per_sm);
  }
  if (kernel == 3) {
    auto kern = route_fold_kernel<T, RED_SUM>;
    return ring_blocks_per_sm(kern, ring_ready<RingId<T, 3, RED_SUM>>(kern),
                              FOLD_THREADS, fold_smem(nwin, stages), per_sm);
  }
  if (kernel == 11) {
    auto kern = route_expand_kernel<T, MUL_NONE>;
    return ring_blocks_per_sm(kern,
                              ring_ready<RingId<T, 11, MUL_NONE>>(kern),
                              EX_THREADS, ex_smem<T>(), per_sm);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int MUL>
int launch_expand_mul(const void* x_ext, const void* plan, const void* w,
                      void* out, long long npanels, double fill,
                      cudaStream_t st) {
  auto kern = route_expand_kernel<T, MUL>;
  return ring_launch(kern, ring_ready<RingId<T, 11, MUL>>(kern), EX_THREADS,
                     ex_smem<T>(), npanels, st, static_cast<const T*>(x_ext),
                     static_cast<const uint8_t*>(plan),
                     static_cast<const T*>(w), static_cast<T*>(out), npanels,
                     static_cast<T>(fill));
}

template <typename T>
int launch_expand(const void* x_ext, const void* plan, const void* w,
                  void* out, long long npanels, int mul_kind, double fill,
                  cudaStream_t st) {
  switch (mul_kind) {
    case MUL_NONE:
      return launch_expand_mul<T, MUL_NONE>(x_ext, plan, w, out, npanels,
                                            fill, st);
    case MUL_MUL:
      return launch_expand_mul<T, MUL_MUL>(x_ext, plan, w, out, npanels, fill,
                                           st);
    case MUL_ADD_SAT:
      return launch_expand_mul<T, MUL_ADD_SAT>(x_ext, plan, w, out, npanels,
                                               fill, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// staged: the windows beside the plan in each stage (the wrapper's
// passa_form picks it from nwin and the value size).
template <typename T, bool STAGED>
int launch_passa_form(const void* src, const void* bases,
                      const void* plan, void* out, long long npanels,
                      int nwin, int out_rows, int two_layer, double fill,
                      const int* pidx, int fill_block, long long src_windows,
                      cudaStream_t st) {
  const long long stage =
      route_rows(nwin * STRIPE, out_rows, two_layer != 0) * LANES +
      (STAGED ? static_cast<long long>(nwin) * WIN_EL * sizeof(T) : 0);
  if (STAGED && nwin > 32) return cudaErrorInvalidValue;
  auto kern = route_passa_kernel<T, STAGED>;
  return ring_launch(kern, ring_ready<RingId<T, 2, STAGED>>(kern), THREADS,
                     PASSA_STAGES * (stage + MBAR_BYTES), npanels, st,
                     static_cast<const T*>(src),
                     static_cast<const int*>(bases),
                     static_cast<const uint8_t*>(plan), static_cast<T*>(out),
                     npanels, nwin, out_rows, two_layer != 0,
                     static_cast<T>(fill), pidx, fill_block, src_windows);
}

template <typename T>
int launch_passa(const void* src, const void* bases, const void* plan,
                 void* out, long long npanels, int nwin, int out_rows,
                 int two_layer, double fill, const int* pidx, int fill_block,
                 long long src_windows, int staged, cudaStream_t st) {
  if (npanels <= 0) return cudaGetLastError();
  return staged ? launch_passa_form<T, true>(src, bases, plan, out, npanels,
                                             nwin, out_rows, two_layer, fill,
                                             pidx, fill_block, src_windows,
                                             st)
                : launch_passa_form<T, false>(src, bases, plan, out, npanels,
                                              nwin, out_rows, two_layer, fill,
                                              pidx, fill_block, src_windows,
                                              st);
}

template <typename T>
int launch_fold_stripes(const void* s1, void* out, long long nrows_out,
                        int red, cudaStream_t st) {
  const long long n = nrows_out * LANES;
  if (n == 0) return cudaGetLastError();
  const T* src = static_cast<const T*>(s1);
  T* o = static_cast<T*>(out);
  switch (red) {
    case RED_SUM:
      fold_stripes_kernel<T, RED_SUM><<<stride_blocks(n), THREADS, 0, st>>>(
          src, o, n);
      break;
    case RED_MIN:
      fold_stripes_kernel<T, RED_MIN><<<stride_blocks(n), THREADS, 0, st>>>(
          src, o, n);
      break;
    case RED_MAX:
      fold_stripes_kernel<T, RED_MAX><<<stride_blocks(n), THREADS, 0, st>>>(
          src, o, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K13
// y[r, l] = ident ⊕ part(c_0) ⊕ part(c_1) ⊕ ... over the chunks c_k =
// idx[k], k = ptr[r] .. ptr[r+1]-1 (ascending c: the Pallas grid's order),
// part(c) = ystack[8c, l] ⊕ ... ⊕ ystack[8c+7, l] in row order.
//
// A row of at most `longest` chunks (nearly all: one chunk each) is one
// thread per (row, lane) reading its chunks' rows itself, two chunks' 16
// loads in flight. A longer row (a hub row: one holds 4,282 of the 36,280
// chunks of the RMAT-20 PageRank meta's fixr fold, over 32,768 rows) would
// make that thread's chain the kernel's time, so
// its parts are folded first, over the whole card (colsum_parts_kernel),
// and the chain runs on one block per (long row, 16 lanes), which copies
// the row's parts into shared memory by TMA, eight 4 KB tiles in flight,
// while 16 threads fold them in order.

template <typename T, int RED>
__device__ __forceinline__ T chunk_part(const T* __restrict__ src) {
  T part = src[0];
#pragma unroll
  for (int q = 1; q < STRIPE; ++q) part = combine<RED>(part, src[q * LANES]);
  return part;
}

// Long rows' parts, 16-lane-group major: for the j-th of the npos list
// positions pos[] of the long rows (long rows in order, each its chunks in
// list order), gpart[(g * npos + j) * COLSUM_LG + l'] = part(idx[pos[j]])
// at lane g * COLSUM_LG + l'. So a long row's parts of one lane group are
// one contiguous run, which its block copies by TMA.
constexpr int COLSUM_LG = 16;                       // lanes a long block
constexpr int COLSUM_SPLIT = LANES / COLSUM_LG;     // long blocks a row
constexpr int COLSUM_STAGES = 8;                    // tiles in flight
constexpr int COLSUM_TILE = 4096;                   // bytes a tile

template <typename T, int RED>
__global__ void __launch_bounds__(THREADS)
colsum_parts_kernel(const T* __restrict__ ystack, const int* __restrict__ idx,
                    const int* __restrict__ pos, T* __restrict__ gpart,
                    long long npos) {
  const long long n = npos * LANES;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long j = i >> 7;
    const int l = static_cast<int>(i & 127);
    gpart[((l / COLSUM_LG) * npos + j) * COLSUM_LG + l % COLSUM_LG] =
        chunk_part<T, RED>(ystack +
                           static_cast<long long>(idx[pos[j]]) * STRIPE *
                               LANES + l);
  }
}

// Blocks [0, COLSUM_SPLIT * nlong): long row longs[b / COLSUM_SPLIT], its
// COLSUM_LG lanes from COLSUM_LG * (b % COLSUM_SPLIT), on warp 0 (the
// block's other warps leave at once): lane 0 keeps COLSUM_STAGES tiles of
// the row's parts in flight into shared memory by TMA (each on its stage's
// mbarrier), and lanes 0..COLSUM_LG-1 fold them in order. The rest: the
// short rows, grid-stride over (row, lane).
template <typename T, int RED>
__global__ void __launch_bounds__(THREADS)
colsum_chunks_kernel(const T* __restrict__ ystack,
                     const int* __restrict__ ptr, const int* __restrict__ idx,
                     const int* __restrict__ longs,
                     const T* __restrict__ gpart,
                     T* __restrict__ y, long long nblocks, int nlong,
                     long long npos, int longest, T ident) {
  constexpr int TP = COLSUM_TILE / (COLSUM_LG * sizeof(T));  // parts a tile
  __shared__ __align__(128) T buf[COLSUM_STAGES][TP * COLSUM_LG];
  __shared__ uint64_t bar[COLSUM_STAGES];
  const long long nlb = static_cast<long long>(COLSUM_SPLIT) * nlong;
  if (blockIdx.x < nlb) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const int i = blockIdx.x / COLSUM_SPLIT;
    const int g = blockIdx.x % COLSUM_SPLIT;
    const long long r = longs[i];
    const int n = ptr[r + 1] - ptr[r];
    long long off = 0;                         // the row's first position j
    for (int q = 0; q < i; ++q) off += ptr[longs[q] + 1] - ptr[longs[q]];
    const T* src = gpart + (g * npos + off) * COLSUM_LG;
    const int ntiles = (n + TP - 1) / TP;
    auto load = [&](int j, int s) {
      if (lane == 0) {
        const unsigned bytes = static_cast<unsigned>(
            min(TP, n - j * TP) * COLSUM_LG * sizeof(T));
        mbar_arrive_tx(&bar[s], bytes);
        bulk_load(buf[s], src + static_cast<long long>(j) * TP * COLSUM_LG,
                  bytes, &bar[s]);
      }
    };
    if (lane == 0) {
      for (int s = 0; s < COLSUM_STAGES; ++s) mbar_init(&bar[s], 1);
      fence_mbar_init();
    }
    __syncwarp();
    for (int s = 0; s < COLSUM_STAGES && s < ntiles; ++s) load(s, s);
    T acc = ident;
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % COLSUM_STAGES;
      mbar_wait(&bar[s], (j / COLSUM_STAGES) & 1);
      if (lane < COLSUM_LG) {
        // 16 shared-memory loads in flight ahead of the ordered folds
        const T* b = buf[s] + lane;
        const int cnt = min(TP, n - j * TP);
        int p = 0;
        for (; p + 16 <= cnt; p += 16) {
          T v[16];
#pragma unroll
          for (int q = 0; q < 16; ++q) v[q] = b[(p + q) * COLSUM_LG];
#pragma unroll
          for (int q = 0; q < 16; ++q) acc = combine<RED>(acc, v[q]);
        }
        for (; p < cnt; ++p) acc = combine<RED>(acc, b[p * COLSUM_LG]);
      }
      __syncwarp();                 // stage s is free for tile j + STAGES
      if (j + COLSUM_STAGES < ntiles) {
        if (lane == 0) fence_async_smem();
        load(j + COLSUM_STAGES, s);
      }
    }
    if (lane < COLSUM_LG) y[r * LANES + g * COLSUM_LG + lane] = acc;
    return;
  }
  const long long stride =
      (static_cast<long long>(gridDim.x) - nlb) * blockDim.x;
  for (long long i = (static_cast<long long>(blockIdx.x) - nlb) *
                         blockDim.x + threadIdx.x;
       i < nblocks * LANES; i += stride) {
    const long long r = i >> 7;
    const int l = static_cast<int>(i & 127);
    const int end = ptr[r + 1];
    int k = ptr[r];
    if (end - k > longest) continue;          // a long row's block writes it
    auto chunk = [&](int q) {
      return ystack + static_cast<long long>(idx[q]) * STRIPE * LANES + l;
    };
    T acc = ident;
    for (; k + 2 <= end; k += 2) {
      T v[2][STRIPE];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const T* src = chunk(k + j);
#pragma unroll
        for (int q = 0; q < STRIPE; ++q) v[j][q] = src[q * LANES];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        T p = v[j][0];
#pragma unroll
        for (int q = 1; q < STRIPE; ++q) p = combine<RED>(p, v[j][q]);
        acc = combine<RED>(acc, p);
      }
    }
    if (k < end) acc = combine<RED>(acc, chunk_part<T, RED>(chunk(k)));
    y[i] = acc;
  }
}

// K13: the long rows' parts (colsum_parts_kernel over their npos list
// positions `pos`, into part: npos * 128 values), then
// colsum_chunks_kernel: COLSUM_SPLIT blocks a long row (`longs`, nlong of
// them) ahead of the short rows' grid-stride blocks.
template <typename T>
int launch_colsum(const void* ystack, const void* ptr, const void* idx,
                  const void* longs, const void* pos, void* part, void* y,
                  long long nblocks, int nlong, long long npos, int longest,
                  int red, double identity, cudaStream_t st) {
  if (nblocks <= 0) return cudaGetLastError();
  const int rc = dispatch_red(red, [&](auto r) {
    constexpr int RED = decltype(r)::value;
    const T* src = static_cast<const T*>(ystack);
    const int* ix = static_cast<const int*>(idx);
    if (npos > 0) {
      colsum_parts_kernel<T, RED>
          <<<stride_blocks(npos * LANES), THREADS, 0, st>>>(
              src, ix, static_cast<const int*>(pos), static_cast<T*>(part),
              npos);
    }
    colsum_chunks_kernel<T, RED>
        <<<static_cast<unsigned>(COLSUM_SPLIT) * nlong +
               stride_blocks(nblocks * LANES),
           THREADS, 0, st>>>(
            src, static_cast<const int*>(ptr), ix,
            static_cast<const int*>(longs), static_cast<const T*>(part),
            static_cast<T*>(y), nblocks, nlong, npos, longest,
            static_cast<T>(identity));
  });
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

// K3: pass (a) over npanels panels into part (npanels*8, 128) through a
// plan ring of `stages` stages (1 or 2; the wrapper's fold_stages), then
// pass (b) over the nrows rows of y by the row -> bands lists.
template <typename T>
int launch_fold(const void* src, const void* bases, const void* plan,
                const void* rptr, const void* gptr, const void* idx,
                void* part, void* gpart, void* y, long long nrows,
                long long ngroups, long long npanels, int nwin, int stages,
                int red, double fill, const int* pidx, int fill_block,
                cudaStream_t st) {
  if (stages < 1 || stages > 2) return cudaErrorInvalidValue;
  const T f = static_cast<T>(fill);
  int err = cudaSuccess;
  const int rc = dispatch_red(red, [&](auto r) {
    constexpr int RED = decltype(r)::value;
    auto kern = route_fold_kernel<T, RED>;
    err = ring_launch(kern, ring_ready<RingId<T, 3, RED>>(kern),
                      FOLD_THREADS, fold_smem(nwin, stages), npanels, st,
                      static_cast<const T*>(src),
                      static_cast<const int*>(bases),
                      static_cast<const uint8_t*>(plan),
                      static_cast<T*>(part), npanels, nwin, stages, f, pidx,
                      fill_block);
    if (err == cudaSuccess) {
      launch_row_fold<T, RED>(part, rptr, gptr, idx, gpart, y, nrows,
                              ngroups, f, st);
    }
  });
  if (rc != cudaSuccess) return rc;
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int launch_hub(const void* v, const void* hm, void* out, long long nrows,
               int red, cudaStream_t st) {
  const T* vs = static_cast<const T*>(v);
  const uint8_t* h = static_cast<const uint8_t*>(hm);
  T* o = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(nrows);
  switch (red) {
    case RED_SUM:
      hub_fold_kernel<T, RED_SUM><<<grid, LANES, 0, st>>>(vs, h, o);
      break;
    case RED_MIN:
      hub_fold_kernel<T, RED_MIN><<<grid, LANES, 0, st>>>(vs, h, o);
      break;
    case RED_MAX:
      hub_fold_kernel<T, RED_MAX><<<grid, LANES, 0, st>>>(vs, h, o);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// plan_idx: nullptr for the static launch, else (npanels,) int32 plan
// block per panel (gated); fill_block: the route's all-fill plan block.
// Two plan blocks and the x_ext panel must fit a block's shared memory;
// plan and w 16-byte aligned.
int gt_route_xr_exp(const void* x2d, const void* bases, const void* plan,
                    const void* w, void* out, long long npanels, int nwin,
                    int dtype, int mul_kind, double fill,
                    const void* plan_idx, int fill_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pidx = static_cast<const int*>(plan_idx);
  switch (dtype) {
    case F32:
      return launch_xr_exp<float>(x2d, bases, plan, w, out, npanels, nwin,
                                  mul_kind, fill, pidx, fill_block, st);
    case F64:
      return launch_xr_exp<double>(x2d, bases, plan, w, out, npanels, nwin,
                                   mul_kind, fill, pidx, fill_block, st);
    case I32:
      return launch_xr_exp<int>(x2d, bases, plan, w, out, npanels, nwin,
                                mul_kind, fill, pidx, fill_block, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// out_rows: 64 (two_layer = 1, the corner turn and the fixr route) or 32
// (two_layer = 0, the x -> x_ext route); src (src_windows * 8, 128); src
// and plan 16-byte aligned; staged: the panels' windows are copied into
// shared memory beside their plan blocks (two stages must fit a block).
int gt_route_passa(const void* src, const void* bases, const void* plan,
                   void* out, long long npanels, int nwin, int out_rows,
                   int two_layer, int dtype, double fill,
                   const void* plan_idx, int fill_block,
                   long long src_windows, int staged, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pidx = static_cast<const int*>(plan_idx);
  if (nwin < 1 || (out_rows != PROWS && out_rows != XROWS) ||
      out_rows * LANES % (THREADS * VEC) != 0) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case F32:
      return launch_passa<float>(src, bases, plan, out, npanels, nwin,
                                 out_rows, two_layer, fill, pidx, fill_block,
                                 src_windows, staged, st);
    case F64:
      return launch_passa<double>(src, bases, plan, out, npanels, nwin,
                                  out_rows, two_layer, fill, pidx,
                                  fill_block, src_windows, staged, st);
    case I32:
      return launch_passa<int>(src, bases, plan, out, npanels, nwin,
                               out_rows, two_layer, fill, pidx, fill_block,
                               src_windows, staged, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// x_ext, plan and w 16-byte aligned.
int gt_route_expand(const void* x_ext, const void* plan, const void* w,
                    void* out, long long npanels, int dtype, int mul_kind,
                    double fill, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_expand<float>(x_ext, plan, w, out, npanels, mul_kind,
                                  fill, st);
    case F64:
      return launch_expand<double>(x_ext, plan, w, out, npanels, mul_kind,
                                   fill, st);
    case I32:
      return launch_expand<int>(x_ext, plan, w, out, npanels, mul_kind, fill,
                                st);
    default:
      return cudaErrorInvalidValue;
  }
}

int gt_fold_stripes(const void* s1, void* out, long long nrows_out,
                    int dtype, int reduce_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_fold_stripes<float>(s1, out, nrows_out, reduce_kind, st);
    case F64:
      return launch_fold_stripes<double>(s1, out, nrows_out, reduce_kind, st);
    case I32:
      return launch_fold_stripes<int>(s1, out, nrows_out, reduce_kind, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int gt_colsum_chunks(const void* ystack, const void* ptr, const void* idx,
                     const void* longs, const void* pos, void* part, void* y,
                     long long nblocks, int nlong, long long npos,
                     int longest, int dtype, int reduce_kind,
                     double identity, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_colsum<float>(ystack, ptr, idx, longs, pos, part, y,
                                  nblocks, nlong, npos, longest, reduce_kind,
                                  identity, st);
    case F64:
      return launch_colsum<double>(ystack, ptr, idx, longs, pos, part, y,
                                   nblocks, nlong, npos, longest,
                                   reduce_kind, identity, st);
    case I32:
      return launch_colsum<int>(ystack, ptr, idx, longs, pos, part, y,
                                nblocks, nlong, npos, longest, reduce_kind,
                                identity, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The row -> bands lists (kernels/fold_order.py::fold_lists): idx
// (npanels*8) the bands by y row, ascending; gptr (ngroups + 1) the runs
// in idx; rptr (nrows + 1) each row's runs. part (npanels*8, 128) and
// gpart (ngroups, 128): scratch. stages: pass (a)'s ring depth, 1 or 2
// (its plan blocks must fit a block's shared memory); src, plan and part
// 16-byte aligned.
int gt_route_fold(const void* src, const void* bases, const void* plan,
                  const void* rptr, const void* gptr, const void* idx,
                  void* part, void* gpart, void* y, long long nrows,
                  long long ngroups, long long npanels, int nwin, int stages,
                  int dtype, int reduce_kind, double fill,
                  const void* plan_idx, int fill_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pidx = static_cast<const int*>(plan_idx);
  switch (dtype) {
    case F32:
      return launch_fold<float>(src, bases, plan, rptr, gptr, idx, part,
                                gpart, y, nrows, ngroups, npanels, nwin,
                                stages, reduce_kind, fill, pidx, fill_block,
                                st);
    case F64:
      return launch_fold<double>(src, bases, plan, rptr, gptr, idx, part,
                                 gpart, y, nrows, ngroups, npanels, nwin,
                                 stages, reduce_kind, fill, pidx, fill_block,
                                 st);
    case I32:
      return launch_fold<int>(src, bases, plan, rptr, gptr, idx, part, gpart,
                              y, nrows, ngroups, npanels, nwin, stages,
                              reduce_kind, fill, pidx, fill_block, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int gt_hub_fold(const void* v, const void* hm, void* out, long long nrows,
                int dtype, int reduce_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_hub<float>(v, hm, out, nrows, reduce_kind, st);
    case F64:
      return launch_hub<double>(v, hm, out, nrows, reduce_kind, st);
    case I32:
      return launch_hub<int>(v, hm, out, nrows, reduce_kind, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// *per_sm = the blocks of K1 (kernel 1), K3's pass (a) (kernel 3, ring
// depth `stages`) or K11 (kernel 11) that one SM holds at once at this
// value type and nwin.
int gt_ring_blocks_per_sm(int kernel, int dtype, int nwin, int stages,
                          int* per_sm) {
  switch (dtype) {
    case F32:
      return ring_blocks<float>(kernel, nwin, stages, per_sm);
    case F64:
      return ring_blocks<double>(kernel, nwin, stages, per_sm);
    case I32:
      return ring_blocks<int>(kernel, nwin, stages, per_sm);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* gt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
