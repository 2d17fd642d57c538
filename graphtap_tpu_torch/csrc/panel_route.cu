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
// x_ext -> contributions (K11, the second half of K1), the corner turn and
// the fixr route (K2), the chunk fold (K13); K12 is the per-panel 8-row
// fold (pass B).
//
// K1-K3 each have a gated launch, the frontier-gated variant of the Pallas
// kernels' plan_idx branch (:226-242, :356-372, :453-461): block p reads
// plan block plan_idx[p] (and K1 its weight block there) instead of block
// p; window bases, and K3's row -> bands list, stay panel p's. A block whose
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
// idx1/sel reads are data-dependent gathers inside 128-lane rows (one or
// two cache lines each), so the kernels are bound by L1/L2 gather latency
// and by the plan stream (~0.4-0.5 KB of plan per 4 KB f32 panel). K1, K3
// and K11 keep it simple: one thread block per panel, 256 threads striding
// over its slots, so neighbouring threads read neighbouring plan bytes and
// write neighbouring outputs (coalesced). K2 moves each panel's plan
// block, and where two stages fit its source windows, into shared memory
// with TMA bulk copies, double-buffered in persistent blocks, and resolves
// four slots a thread out of it (see K2 below): per panel one bulk read
// and one bulk write, so it is held to bytes, not to a chain of four
// dependent device loads a slot. One device function routes a
// panel (route_panel) for K1's two stages and K11, and one expands an
// x_ext panel held in shared memory (expand_panel) for K1 and K11: K1
// builds its 32x128 x_ext panel there, so x_ext never goes to device
// memory; K11 loads it there from the x_ext table. K3 folds each routed
// 8-row band in registers, in row order, into a (npanels*8, 128) scratch
// of band partials; then one thread per (y row, lane) folds its row's
// bands in ascending band (panel) order, the Pallas grid's order, in runs
// of 64 and then the runs' results, from the identity, and writes y once
// (common.cuh, pass (b); the row -> bands lists are built once per upload
// from dst and seg, kernels/fold_order.py). So
// its float sums come out the same on every call, and equal the plain
// version's bit for bit: an atomic fold, whose order changed from call to
// call, kept f32 PageRank's convergence vote from closing. K13 still adds
// each staged chunk to y with one atomic per (chunk, lane) after a fill
// pass (f32/f64 atomicAdd, int32 atomicMin/Max), so its float sums round
// in no fixed order; no app path runs it. K12 needs no atomics:
// one thread per output folds its 8 rows in order. K12 and K13 move each
// byte once and are bound by device memory. K4 runs one 128-thread block
// per row: warp shuffles for the xor shifts 1..16 and shared memory for 32
// and 64, in the Pallas kernel's order, so it is bit-exact. All element
// offsets are 64-bit.
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

// One output slot (r, l) of a route. src_row(band, row) points at the 128
// values of source row `row` of band `band`. sel_b == nullptr is a
// single-layer route: layer a is read whatever the pick bit says.
template <typename T, typename SrcRow>
__device__ __forceinline__ T route_slot(const uint8_t* __restrict__ idx1,
                                        const uint8_t* __restrict__ sel_a,
                                        const uint8_t* __restrict__ sel_b,
                                        const uint8_t* __restrict__ idx3,
                                        int r, int l, int nsrc, T fill,
                                        SrcRow src_row) {
  const int i3 = idx3[r * LANES + l];
  const int m = i3 & 127;
  const uint8_t* sel = (sel_b != nullptr && i3 >= 128) ? sel_b : sel_a;
  const int s = sel[r * LANES + m];
  const int band = s >> 3;
  if (band >= nsrc) return fill;           // no landing: the ⊕-identity
  const int row = s & 7;
  const int lane = idx1[(band * STRIPE + row) * LANES + m];
  return src_row(band, row)[lane];
}

// One panel's packed plan block: [idx1 (src_rows), sel_a (out_rows),
// sel_b (out_rows, two-layer only), idx3 (out_rows)].
struct Route {
  const uint8_t* idx1;
  const uint8_t* sel_a;
  const uint8_t* sel_b;     // nullptr: single landing layer
  const uint8_t* idx3;
};

__host__ __device__ __forceinline__ long long route_rows(int src_rows,
                                                         int out_rows,
                                                         bool two_layer) {
  return src_rows + (two_layer ? 3LL : 2LL) * out_rows;
}

__device__ __forceinline__ Route route_at(const uint8_t* blk, int src_rows,
                                          int out_rows, bool two_layer) {
  Route r;
  r.idx1 = blk;
  r.sel_a = blk + static_cast<long long>(src_rows) * LANES;
  r.sel_b = two_layer ? r.sel_a + out_rows * LANES : nullptr;
  r.idx3 = r.sel_a + (two_layer ? 2 : 1) * out_rows * LANES;
  return r;
}

// Rows of an expand-route plan block (two-layer, x_ext source, 64 out).
constexpr int EX_PROWS = XROWS + 3 * PROWS;

// Route all out_rows x 128 slots of one panel; store(e, v) takes slot e.
template <typename T, typename SrcRow, typename Store>
__device__ __forceinline__ void route_panel(const Route& rt, int out_rows,
                                            int nsrc, T fill, SrcRow src_row,
                                            Store store) {
  for (int e = threadIdx.x; e < out_rows * LANES; e += blockDim.x) {
    store(e, route_slot<T>(rt.idx1, rt.sel_a, rt.sel_b, rt.idx3, e >> 7,
                           e & 127, nsrc, fill, src_row));
  }
}

// The expand route of one panel (K1's second stage, and K11): the 32-row
// x_ext panel xe (4 source bands, in shared memory) routed two-layer into
// the 64-row panel po, then ⊗ with the panel's weights pw.
template <typename T, int MUL>
__device__ __forceinline__ void expand_panel(const uint8_t* ex_blk,
                                             const T* xe,
                                             const T* __restrict__ pw,
                                             T* __restrict__ po, T fill) {
  const Route ex = route_at(ex_blk, XROWS, PROWS, true);
  auto xe_row = [&](int band, int row) -> const T* {
    return xe + (band * STRIPE + row) * LANES;
  };
  route_panel<T>(ex, PROWS, XROWS / STRIPE, fill, xe_row, [&](int e, T v) {
    po[e] = apply_mul<T, MUL>(v, pw, e, fill);
  });
}

// Plan block of block p: p itself (static) or plan_idx[p] (gated).
__device__ __forceinline__ long long plan_block(const int* __restrict__ pidx,
                                                long long p) {
  return pidx == nullptr ? p : static_cast<long long>(pidx[p]);
}

// ---------------------------------------------------------------- K1
// x table -> (64,128) contribution panel per block: the single-layer
// x -> x_ext route of the panel's nwin x windows into shared memory, the
// two-layer expand route out of it, then ⊗ with the weight stream.
// Plan rows per panel: [xr_idx1 (nwin*8), xr_sel_a (32), xr_idx3 (32),
// ex_idx1 (32), ex_sel_a (64), ex_sel_b (64), ex_idx3 (64)].
template <typename T, int MUL>
__global__ void __launch_bounds__(THREADS)
route_xr_exp_kernel(const T* __restrict__ x2d, const int* __restrict__ bases,
                    const uint8_t* __restrict__ plan,
                    const T* __restrict__ w, T* __restrict__ out, int nwin,
                    T fill, const int* __restrict__ plan_idx,
                    int fill_block) {
  __shared__ T xe[XROWS * LANES];
  const long long p = blockIdx.x;
  const long long q = plan_block(plan_idx, p);
  T* po = out + p * PROWS * LANES;
  const T* pw = (MUL == MUL_NONE) ? nullptr : w + q * PROWS * LANES;
  if (plan_idx != nullptr && q == fill_block) {
    for (int e = threadIdx.x; e < PROWS * LANES; e += blockDim.x) {
      po[e] = apply_mul<T, MUL>(fill, pw, e, fill);
    }
    return;
  }
  const int sr = nwin * STRIPE;
  const long long xr_rows = route_rows(sr, XROWS, false);
  const uint8_t* blk = plan + q * (xr_rows + EX_PROWS) * LANES;
  const int* pb = bases + p * nwin;
  auto x_row = [&](int band, int row) -> const T* {
    return x2d + (static_cast<long long>(pb[band]) * STRIPE + row) * LANES;
  };
  route_panel<T>(route_at(blk, sr, XROWS, false), XROWS, nwin, fill, x_row,
                 [&](int e, T v) { xe[e] = v; });
  __syncthreads();
  expand_panel<T, MUL>(blk + xr_rows * LANES, xe, pw, po, fill);
}

// ---------------------------------------------------------------- K11
// x_ext table (npanels*32, 128) -> (64,128) contribution panel per block:
// the panel's own x_ext block loaded into shared memory, then K1's expand
// stage. Plan rows per panel: [idx1 (32), sel_a (64), sel_b (64),
// idx3 (64)].
template <typename T, int MUL>
__global__ void __launch_bounds__(THREADS)
route_expand_kernel(const T* __restrict__ x_ext,
                    const uint8_t* __restrict__ plan,
                    const T* __restrict__ w, T* __restrict__ out, T fill) {
  __shared__ T xe[XROWS * LANES];
  const long long p = blockIdx.x;
  const T* src = x_ext + p * XROWS * LANES;
  for (int e = threadIdx.x; e < XROWS * LANES; e += blockDim.x) {
    xe[e] = src[e];
  }
  __syncthreads();
  const T* pw = (MUL == MUL_NONE) ? nullptr : w + p * PROWS * LANES;
  expand_panel<T, MUL>(plan + p * EX_PROWS * LANES, xe, pw,
                       out + p * PROWS * LANES, fill);
}

// ---------------------------------------------------------------- K2
// Corner turn: the panel's nwin 8-row windows of src (block indices
// bases[p*nwin + band]) routed into an out_rows-row panel: two-layer
// (64 rows; plan [idx1 (nwin*8), sel_a, sel_b, idx3]) or single-layer
// (the x -> x_ext route, 32 rows; plan [idx1, sel_a, idx3]).
//
// Persistent blocks (a grid of at most the blocks the SMs hold at once),
// each walking panels blockIdx.x, + gridDim.x, ... through a ring of two
// shared-memory stages. A stage holds one panel's whole plan block (one
// TMA bulk copy, contiguous and 128-byte aligned) and, in the STAGED form,
// the panel's nwin source windows beside it (one bulk copy each, 4 KB in
// f32/int32, 8 KB in f64); both complete on the stage's mbarrier. Warp 0
// issues panel p + 2*gridDim.x into a stage as soon as the block has
// resolved panel p out of it, so one panel's copies land while the other
// resolves. Each thread resolves 4 slots at a time: one 4-byte idx3 word,
// then four independent sel -> idx1 -> value chains, all out of shared
// memory (STAGED) or the last one a read-only load of device memory
// (unstaged: the windows do not fit two stages), and one 16-byte
// streaming store. A window whose base lies outside the source table is
// not copied (a validated plan has none), a band >= nwin is the fill and
// reads nothing, and a lane is taken mod 128. Gated: plan block
// plan_idx[p], bases still panel p's; a panel pointed at fill_block copies
// nothing and writes the fill.
constexpr int VEC = 4;                       // slots a thread resolves at once
constexpr int WIN_EL = STRIPE * LANES;       // values of one source window
constexpr int PASSA_STAGES = 2;
constexpr int SMEM_BLOCK = 232448;           // shared memory a block may have

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
// one arrival that also expects `bytes` of bulk copies on this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

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
  const long long G = gridDim.x;
  if (t == 0) {
    for (int s = 0; s < PASSA_STAGES; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

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
    if (lane == 0) {
      mbar_arrive_tx(&bar[s], fill_panel ? 0u : bytes + plan_bytes);
      if (!fill_panel) {
        bulk_load(dst, plan + q * plan_bytes, plan_bytes, &bar[s]);
      }
    }
    if (mine != 0) {
      bulk_load(dst + plan_bytes + lane * mine, src + wb * WIN_EL, mine,
                &bar[s]);
    }
  };

  long long p = blockIdx.x;
  if (t < 32) {
    for (int s = 0; s < PASSA_STAGES && p + s * G < npanels; ++s) {
      load(p + s * G, s);
    }
  }
  const int nvec = out_rows * LANES / (THREADS * VEC);   // 8 or 4
  for (int k = 0; p < npanels; ++k, p += G) {
    const int s = k % PASSA_STAGES;
    mbar_wait(&bar[s], (k / PASSA_STAGES) & 1);
    const long long q = plan_block(plan_idx, p);
    T* po = out + p * out_rows * LANES;
    if (plan_idx != nullptr && q == fill_block) {
      for (int g = 0; g < nvec; ++g) {
        store4<T>(po, t + THREADS * g, fill, fill, fill, fill);
      }
    } else {
      const uint8_t* idx1 = smem + s * stage_bytes;
      const uint8_t* sel_a = idx1 + sr * LANES;
      const uint8_t* sel_b = two_layer ? sel_a + out_rows * LANES : sel_a;
      const uint8_t* idx3 = sel_a + (two_layer ? 2 : 1) * out_rows * LANES;
      const T* win = reinterpret_cast<const T*>(idx1 + plan_bytes);
      const int* pb = bases + p * nwin;
#pragma unroll 2
      for (int g = 0; g < nvec; ++g) {
        const int e = VEC * (t + THREADS * g);
        const int r = e >> 7;
        const unsigned w3 = *reinterpret_cast<const unsigned*>(idx3 + e);
        T v[VEC];
#pragma unroll
        for (int k4 = 0; k4 < VEC; ++k4) {
          const int i3 = (w3 >> (8 * k4)) & 0xff;
          const int m = i3 & 127;
          const int sv = (i3 >= 128 ? sel_b : sel_a)[r * LANES + m];
          const int band = sv >> 3;
          const int row = sv & 7;
          v[k4] = fill;
          if (band < nwin) {
            const int l = idx1[(band * STRIPE + row) * LANES + m] &
                          (LANES - 1);
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
    }
    __syncthreads();                 // stage s is free for panel p + 2G
    if (t < 32 && p + PASSA_STAGES * G < npanels) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(p + PASSA_STAGES * G, s);
    }
  }
}

// ---------------------------------------------------------------- K3
// Pass (a): route as K2 and fold each routed 8-row band (ob) lane-wise in
// registers, rows 0..7 in order, into part[(p*8 + ob), l]. A gated panel
// pointed at the fill block writes the fill (what the fill plan folds to).
template <typename T, int RED>
__global__ void __launch_bounds__(THREADS)
route_fold_kernel(const T* __restrict__ src, const int* __restrict__ bases,
                  const uint8_t* __restrict__ plan, T* __restrict__ part,
                  int nwin, T fill, const int* __restrict__ plan_idx,
                  int fill_block) {
  const long long p = blockIdx.x;
  const long long q = plan_block(plan_idx, p);
  T* pp = part + p * STRIPE * LANES;
  if (plan_idx != nullptr && q == fill_block) {
    for (int t = threadIdx.x; t < STRIPE * LANES; t += blockDim.x) {
      pp[t] = fill;
    }
    return;
  }
  const int sr = nwin * STRIPE;
  const Route rt = route_at(plan + q * route_rows(sr, PROWS, true) * LANES,
                            sr, PROWS, true);
  const int* pb = bases + p * nwin;
  auto src_row = [&](int band, int row) -> const T* {
    return src + (static_cast<long long>(pb[band]) * STRIPE + row) * LANES;
  };
  for (int t = threadIdx.x; t < STRIPE * LANES; t += blockDim.x) {
    const int ob = t >> 7;
    const int l = t & 127;
    T acc = route_slot<T>(rt.idx1, rt.sel_a, rt.sel_b, rt.idx3, ob * STRIPE,
                          l, nwin, fill, src_row);
#pragma unroll
    for (int r = 1; r < STRIPE; ++r) {
      acc = combine<RED>(acc, route_slot<T>(rt.idx1, rt.sel_a, rt.sel_b,
                                            rt.idx3, ob * STRIPE + r, l,
                                            nwin, fill, src_row));
    }
    pp[t] = acc;
  }
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

// ---------------------------------------------------------------- K13
// Chunk fold: chunk c (rows c*8 .. c*8+7 of ystack) folded lane-wise in
// registers and ⊕-ed into y row chunk_dst[c] with one atomic per lane. One
// thread per (chunk, lane), two chunks per 256-thread block. y holds the
// identity before the first block runs (fill_kernel on the same stream).
template <typename T, int RED>
__global__ void __launch_bounds__(THREADS)
colsum_chunks_kernel(const T* __restrict__ ystack,
                     const int* __restrict__ chunk_dst, T* __restrict__ y,
                     long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long c = i >> 7;
    const int l = static_cast<int>(i & 127);
    const T* src = ystack + c * STRIPE * LANES + l;
    T acc = src[0];
#pragma unroll
    for (int k = 1; k < STRIPE; ++k) acc = combine<RED>(acc, src[k * LANES]);
    atomic_combine<RED>(y + static_cast<long long>(chunk_dst[c]) * LANES + l,
                        acc);
  }
}

// ---------------------------------------------------------------- launch
template <typename T>
int launch_xr_exp(const void* x2d, const void* bases, const void* plan,
                  const void* w, void* out, long long npanels, int nwin,
                  int mul_kind, double fill, const int* pidx, int fill_block,
                  cudaStream_t st) {
  const T* xs = static_cast<const T*>(x2d);
  const int* b = static_cast<const int*>(bases);
  const uint8_t* pl = static_cast<const uint8_t*>(plan);
  const T* ws = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  const T f = static_cast<T>(fill);
  const dim3 grid(static_cast<unsigned>(npanels));
  switch (mul_kind) {
    case MUL_NONE:
      route_xr_exp_kernel<T, MUL_NONE><<<grid, THREADS, 0, st>>>(
          xs, b, pl, ws, o, nwin, f, pidx, fill_block);
      break;
    case MUL_MUL:
      route_xr_exp_kernel<T, MUL_MUL><<<grid, THREADS, 0, st>>>(
          xs, b, pl, ws, o, nwin, f, pidx, fill_block);
      break;
    case MUL_ADD_SAT:
      route_xr_exp_kernel<T, MUL_ADD_SAT><<<grid, THREADS, 0, st>>>(
          xs, b, pl, ws, o, nwin, f, pidx, fill_block);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
int launch_expand(const void* x_ext, const void* plan, const void* w,
                  void* out, long long npanels, int mul_kind, double fill,
                  cudaStream_t st) {
  const T* xs = static_cast<const T*>(x_ext);
  const uint8_t* pl = static_cast<const uint8_t*>(plan);
  const T* ws = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  const T f = static_cast<T>(fill);
  const dim3 grid(static_cast<unsigned>(npanels));
  switch (mul_kind) {
    case MUL_NONE:
      route_expand_kernel<T, MUL_NONE><<<grid, THREADS, 0, st>>>(xs, pl, ws,
                                                                 o, f);
      break;
    case MUL_MUL:
      route_expand_kernel<T, MUL_MUL><<<grid, THREADS, 0, st>>>(xs, pl, ws, o,
                                                                f);
      break;
    case MUL_ADD_SAT:
      route_expand_kernel<T, MUL_ADD_SAT><<<grid, THREADS, 0, st>>>(
          xs, pl, ws, o, f);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Above 48 KB a block's shared memory is opted into once per kernel.
template <typename T, bool STAGED>
cudaError_t passa_opt_in() {
  static const cudaError_t rc = cudaFuncSetAttribute(
      route_passa_kernel<T, STAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BLOCK);
  return rc;
}

// staged: the windows beside the plan in each stage (the wrapper's
// passa_form picks it from nwin and the value size); the grid is as many
// blocks as the SMs hold at once at this footprint, at most npanels.
template <typename T, bool STAGED>
int launch_passa_form(const void* src, const void* bases,
                      const void* plan, void* out, long long npanels,
                      int nwin, int out_rows, int two_layer, double fill,
                      const int* pidx, int fill_block, long long src_windows,
                      cudaStream_t st) {
  const long long stage =
      route_rows(nwin * STRIPE, out_rows, two_layer != 0) * LANES +
      (STAGED ? static_cast<long long>(nwin) * WIN_EL * sizeof(T) : 0);
  const long long smem = PASSA_STAGES * stage + PASSA_STAGES * 8;
  if (smem > SMEM_BLOCK || (STAGED && nwin > 32)) return cudaErrorInvalidValue;
  const cudaError_t opt = passa_opt_in<T, STAGED>();
  if (opt != cudaSuccess) return opt;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, route_passa_kernel<T, STAGED>, THREADS,
        static_cast<size_t>(smem));
  }
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = static_cast<long long>(sms) * per_sm;
  route_passa_kernel<T, STAGED>
      <<<static_cast<unsigned>(npanels < cap ? npanels : cap), THREADS,
         static_cast<size_t>(smem), st>>>(
          static_cast<const T*>(src), static_cast<const int*>(bases),
          static_cast<const uint8_t*>(plan), static_cast<T*>(out), npanels,
          nwin, out_rows, two_layer != 0, static_cast<T>(fill), pidx,
          fill_block, src_windows);
  return cudaGetLastError();
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

template <typename T>
int launch_colsum(const void* ystack, const void* chunk_dst, void* y,
                  long long nchunks, long long nblocks, int red,
                  double identity, cudaStream_t st) {
  if (red != RED_SUM && !std::is_same<T, int>::value) {
    return cudaErrorInvalidValue;   // no float atomicMin/Max
  }
  T* yt = static_cast<T*>(y);
  launch_fill<T>(yt, nblocks * LANES, static_cast<T>(identity), st);
  const long long n = nchunks * LANES;
  if (n > 0) {
    const T* src = static_cast<const T*>(ystack);
    const int* d = static_cast<const int*>(chunk_dst);
    if (red == RED_SUM) {
      colsum_chunks_kernel<T, RED_SUM><<<stride_blocks(n), THREADS, 0, st>>>(
          src, d, yt, n);
    } else if constexpr (std::is_same<T, int>::value) {
      if (red == RED_MIN) {
        colsum_chunks_kernel<T, RED_MIN>
            <<<stride_blocks(n), THREADS, 0, st>>>(src, d, yt, n);
      } else if (red == RED_MAX) {
        colsum_chunks_kernel<T, RED_MAX>
            <<<stride_blocks(n), THREADS, 0, st>>>(src, d, yt, n);
      } else {
        return cudaErrorInvalidValue;
      }
    }
  }
  return cudaGetLastError();
}

// K3: pass (a) over npanels panels into part (npanels*8, 128), then pass
// (b) over the nrows rows of y by the row -> bands lists.
template <typename T>
int launch_fold(const void* src, const void* bases, const void* plan,
                const void* rptr, const void* gptr, const void* idx,
                void* part, void* gpart, void* y, long long nrows,
                long long ngroups, long long npanels, int nwin, int red,
                double fill, const int* pidx, int fill_block,
                cudaStream_t st) {
  const T f = static_cast<T>(fill);
  const int rc = dispatch_red(red, [&](auto r) {
    constexpr int RED = decltype(r)::value;
    if (npanels > 0) {
      route_fold_kernel<T, RED>
          <<<static_cast<unsigned>(npanels), THREADS, 0, st>>>(
              static_cast<const T*>(src), static_cast<const int*>(bases),
              static_cast<const uint8_t*>(plan), static_cast<T*>(part), nwin,
              f, pidx, fill_block);
    }
    launch_row_fold<T, RED>(part, rptr, gptr, idx, gpart, y, nrows, ngroups,
                            f, st);
  });
  return rc != cudaSuccess ? rc : cudaGetLastError();
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

int gt_colsum_chunks(const void* ystack, const void* chunk_dst, void* y,
                     long long nchunks, long long nblocks, int dtype,
                     int reduce_kind, double identity, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_colsum<float>(ystack, chunk_dst, y, nchunks, nblocks,
                                  reduce_kind, identity, st);
    case F64:
      return launch_colsum<double>(ystack, chunk_dst, y, nchunks, nblocks,
                                   reduce_kind, identity, st);
    case I32:
      return launch_colsum<int>(ystack, chunk_dst, y, nchunks, nblocks,
                                reduce_kind, identity, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The row -> bands lists (kernels/fold_order.py::fold_lists): idx
// (npanels*8) the bands by y row, ascending; gptr (ngroups + 1) the runs
// in idx; rptr (nrows + 1) each row's runs. part (npanels*8, 128) and
// gpart (ngroups, 128): scratch.
int gt_route_fold(const void* src, const void* bases, const void* plan,
                  const void* rptr, const void* gptr, const void* idx,
                  void* part, void* gpart, void* y, long long nrows,
                  long long ngroups, long long npanels, int nwin, int dtype,
                  int reduce_kind, double fill, const void* plan_idx,
                  int fill_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pidx = static_cast<const int*>(plan_idx);
  switch (dtype) {
    case F32:
      return launch_fold<float>(src, bases, plan, rptr, gptr, idx, part,
                                gpart, y, nrows, ngroups, npanels, nwin,
                                reduce_kind, fill, pidx, fill_block, st);
    case F64:
      return launch_fold<double>(src, bases, plan, rptr, gptr, idx, part,
                                 gpart, y, nrows, ngroups, npanels, nwin,
                                 reduce_kind, fill, pidx, fill_block, st);
    case I32:
      return launch_fold<int>(src, bases, plan, rptr, gptr, idx, part, gpart,
                              y, nrows, ngroups, npanels, nwin, reduce_kind,
                              fill, pidx, fill_block, st);
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

const char* gt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
