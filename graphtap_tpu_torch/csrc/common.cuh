// Device helpers shared by the port's kernels (panel_route.cu, shuffle.cu,
// gather.cu, onehot.cu, probe.cu).
//
// The value types, ⊗ and ⊕ kinds as the wrappers number them
// (kernels/panel_kernels.py: _DTYPES, _MUL_KINDS, _REDUCE_KINDS), the
// saturating min-plus ⊗, the ⊕ combine, 16-byte stores and loads of four
// values, the Hopper TMA helpers (mbarriers, bulk copies both ways, bulk
// groups) of the plan rings of K1-K3 and K11, of P1's copy ring and of
// K13's long rows, and the two fixed-order passes of the K3, K5 and K8
// folds.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace gt {

constexpr int LANES = 128;
constexpr int THREADS = 256;

enum Dtype { F32 = 0, F64 = 1, I32 = 2 };
enum MulKind { MUL_NONE = 0, MUL_MUL = 1, MUL_ADD_SAT = 2 };
enum ReduceKind { RED_SUM = 0, RED_MIN = 1, RED_MAX = 2 };

// a + b and a * b as one IEEE-rounded operation each: never contracted
// into an FMA with a neighbouring ⊗ or ⊕, so a ⊗ rounds as the plain
// version's elementwise torch op does; int32 wraps (two's complement), as
// the Pallas kernels' and torch's int32 arithmetic does.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ int add_rn(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ int mul_rn(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) *
                          static_cast<unsigned>(b));
}

// min-plus ⊗: INF stays INF, so INF + w never wraps (panel_kernels.py:134,
// shuffle_kernels.py:59-61).
template <typename T>
__device__ __forceinline__ T add_sat(T acc, T w, T fill) {
  return acc >= fill ? fill : add_rn(acc, w);
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

// ⊗ of one contribution v with its weight w (MUL_NONE: v).
template <typename T, int MUL>
__device__ __forceinline__ T mul_value(T v, T w, T fill) {
  if constexpr (MUL == MUL_MUL) {
    return mul_rn(v, w);
  } else if constexpr (MUL == MUL_ADD_SAT) {
    return add_sat<T>(v, w, fill);
  } else {
    return v;
  }
}

// ⊗ of one contribution with its weight pw[e] (MUL_NONE: none, pw unread).
template <typename T, int MUL>
__device__ __forceinline__ T apply_mul(T v, const T* __restrict__ pw,
                                       long long e, T fill) {
  if constexpr (MUL == MUL_NONE) {
    return v;
  } else {
    return mul_value<T, MUL>(v, pw[e], fill);
  }
}

// out[4g .. 4g+3] = a, b, c, d as one 16-byte streaming store (two for
// f64): evict-first, so the output stream does not push a gather's sources
// out of L2. out must be 16-byte aligned (K7, K10).
template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ out, unsigned g,
                                       T a, T b, T c, T d);
template <>
__device__ __forceinline__ void store4<float>(float* __restrict__ out,
                                              unsigned g, float a, float b,
                                              float c, float d) {
  __stcs(reinterpret_cast<float4*>(out) + g, make_float4(a, b, c, d));
}
template <>
__device__ __forceinline__ void store4<int>(int* __restrict__ out,
                                            unsigned g, int a, int b, int c,
                                            int d) {
  __stcs(reinterpret_cast<int4*>(out) + g, make_int4(a, b, c, d));
}
template <>
__device__ __forceinline__ void store4<double>(double* __restrict__ out,
                                               unsigned g, double a,
                                               double b, double c,
                                               double d) {
  double2* o = reinterpret_cast<double2*>(out) + 2 * g;
  __stcs(o, make_double2(a, b));
  __stcs(o + 1, make_double2(c, d));
}

// out[4g .. 4g+3] = a, b, c, d as one 16-byte store (two for f64), with
// no cache hint: K1's x_ext panel in shared memory. out must be 16-byte
// aligned.
template <typename T>
__device__ __forceinline__ void put4(T* __restrict__ out, unsigned g, T a,
                                     T b, T c, T d) {
  if constexpr (std::is_same<T, double>::value) {
    double2* o = reinterpret_cast<double2*>(out) + 2 * g;
    o[0] = make_double2(a, b);
    o[1] = make_double2(c, d);
  } else if constexpr (std::is_same<T, float>::value) {
    reinterpret_cast<float4*>(out)[g] = make_float4(a, b, c, d);
  } else {
    reinterpret_cast<int4*>(out)[g] = make_int4(a, b, c, d);
  }
}

// v = in[4g .. 4g+3] as one 16-byte streaming load (two for f64): a
// stream read once per launch (K1's weights). in must be 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ in, unsigned g,
                                      T (&v)[4]) {
  if constexpr (std::is_same<T, double>::value) {
    const double2* i = reinterpret_cast<const double2*>(in) + 2 * g;
    const double2 a = __ldcs(i), b = __ldcs(i + 1);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(in) + g);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(in) + g);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
}

// ------------------------------------------------------------- TMA (sm_90)
// One thread drives each copy; the data never passes through registers.
// A bulk load completes on an mbarrier in shared memory: the thread that
// issues it first arrives on the barrier expecting the phase's bytes
// (mbar_arrive_tx), and any thread waits for the phase's parity
// (mbar_wait). A bulk store from shared memory joins the issuing thread's
// current bulk group (bulk_commit closes it); bulk_wait_read<N> returns
// once all but the newest N groups have read their shared memory, which
// may then be reused or released. Sizes are multiples of 16 bytes, both
// ends 16-byte aligned.
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
// `bytes` from device memory into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// `bytes` from shared memory into device memory, in the current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Fences between the generic proxy (threads) and the async proxy (TMA):
// an initialized mbarrier is seen by the bulk copies that complete on it,
// and shared memory the threads have used is ordered before the bulk
// copies that next write or read it.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Grid size of a grid-stride loop over n elements.
inline unsigned stride_blocks(long long n) {
  const long long want = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(want < 65536 ? (want > 0 ? want : 1) : 65536);
}

// Call f with the ⊕ kind as a compile-time constant; an unknown kind is
// cudaErrorInvalidValue.
template <typename F>
int dispatch_red(int red, F&& f) {
  switch (red) {
    case RED_SUM:
      f(std::integral_constant<int, RED_SUM>{});
      return cudaSuccess;
    case RED_MIN:
      f(std::integral_constant<int, RED_MIN>{});
      return cudaSuccess;
    case RED_MAX:
      f(std::integral_constant<int, RED_MAX>{});
      return cudaSuccess;
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- fixed-order float folds
// K3, K5 and K8 fold in two passes, in a fixed order, so that a float sum
// is the same on every call (kernels/fold_order.py): (a) per chunk or band,
// 128 lane partials into a scratch table (the caller's); (b) per (row,
// lane) of y, the partials of the row's list in list order, in runs of
// GROUP folded from the ⊕-identity and then the runs' results in order,
// written once. No atomic ⊕, no fill pass.

constexpr unsigned FULL_MASK = 0xffffffffu;

// Pass (b), one level: out[r, l] = ident ⊕ src[i_0, l] ⊕ ... ⊕ src[i_k, l]
// over the list positions k = ptr[r] .. ptr[r+1]-1 in order, i_k = idx[k]
// (idx == nullptr: i_k = k). One thread per (r, lane), grid-stride; the
// values are loaded BATCH at a time (independent loads in flight) and
// folded in list order.
template <typename T, int RED>
__global__ void __launch_bounds__(THREADS)
list_fold_kernel(const T* __restrict__ src, const int* __restrict__ ptr,
                 const int* __restrict__ idx, T* __restrict__ out,
                 long long n, T ident) {
  constexpr int BATCH = 16;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long r = i >> 7;
    const int l = static_cast<int>(i & 127);
    const int end = ptr[r + 1];
    int k = ptr[r];
    auto at = [&](int q) -> T {
      const long long row = idx != nullptr ? idx[q] : q;
      return src[row * LANES + l];
    };
    T acc = ident;
    for (; k + BATCH <= end; k += BATCH) {
      T x[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) x[j] = at(k + j);
#pragma unroll
      for (int j = 0; j < BATCH; ++j) acc = combine<RED>(acc, x[j]);
    }
    for (; k < end; ++k) acc = combine<RED>(acc, at(k));
    out[i] = acc;
  }
}

// Pass (b): each run g of up to GROUP partials (idx[gptr[g] .. gptr[g+1]))
// folded into gpart[g]; then each row r's runs (gpart[rptr[r] ..
// rptr[r+1])) folded into y[r] (kernels/fold_order.py::fold_lists).
template <typename T, int RED>
void launch_row_fold(const void* part, const void* rptr, const void* gptr,
                     const void* idx, void* gpart, void* y, long long nrows,
                     long long ngroups, T ident, cudaStream_t st) {
  if (ngroups > 0) {
    list_fold_kernel<T, RED><<<stride_blocks(ngroups * LANES), THREADS, 0,
                               st>>>(
        static_cast<const T*>(part), static_cast<const int*>(gptr),
        static_cast<const int*>(idx), static_cast<T*>(gpart),
        ngroups * LANES, ident);
  }
  if (nrows > 0) {
    list_fold_kernel<T, RED><<<stride_blocks(nrows * LANES), THREADS, 0,
                               st>>>(
        static_cast<const T*>(gpart), static_cast<const int*>(rptr), nullptr,
        static_cast<T*>(y), nrows * LANES, ident);
  }
}

// ------------------------------------------------ K5's and K8's chunk fold
// Pass (a): the chunk's kept entries fold into 128 lane partials, in the
// order of fold_order.py: each lane's entries, in index order, cut into
// runs of CHUNK_FOLD_RUN, each run folded from the ⊕-identity, then the
// lane's runs' results in order from the ⊕-identity. chunk_fold_kernel
// runs one CHUNK_FOLD_THREADS-thread block per item k of the chunk list
// (kernels/fold_order.py::chunk_lists): chunks[k], or -1, a null item
// whose lane partials are the identity, into part[k]. K5 from the plan
// puts its values in their sorted places from tables built once per
// upload and runs the same fold from there (lane_bounds, fold_runs;
// onehot.cu). Pass (b) is launch_row_fold over the list positions.
//
// Warp w owns the chunk's slots [w SEG, (w+1) SEG) and its thread i the
// slots w SEG + i + 32 j, j = 0 .. SEG/32 - 1 (coalesced loads; K8 loads
// every slot's lane and value and masks by ev after, which measured
// faster than loading them only where ev is set). The kept values go to
// shared memory sorted by lane, stably (val, one word of skew every 32
// entries, so that runs CHUNK_FOLD_RUN apart start in other banks), with
// each lane's bounds; then thread r folds run r (its lane from a run ->
// lane table) and thread l < 128 folds lane l's runs. A hub chunk's
// critical path is so CHUNK_FOLD_RUN + CHUNK / CHUNK_FOLD_RUN dependent
// ⊕s, where one thread folded up to CHUNK.
//
// Each warp ranks its segment's kept entries within their lanes, round j
// by round j (index order in the segment): __match_any_sync finds the
// round's equal lanes, and a per-warp count of each lane in shared
// memory gives the earlier rounds' share; then warp 0 turns the warps'
// counts of each lane into each warp's first rank, the lane's count and
// bounds. Two block barriers, no block-wide sort. (A rotation that placed
// K5's row-sorted chunks without the rank measured no faster: the H100,
// RMAT-20, 0.0861 and 0.0871 ms against 0.0843 and 0.0788 without it.)
//
// MASKED (K8) masks the slots by ev; its lanes are short (a chunk's
// longest lane has a median of 64 entries at RMAT-20), so a run folds to
// its end (SHORT_RUNS), at 8 blocks an SM. K5 reads no mask (its padding
// carries the identity); its lanes are long (median 466), so a run keeps
// all CHUNK_FOLD_RUN loads in flight, at 6 blocks an SM (0.1087 ms at 8
// with K8's run fold). Occupancy is what the fold buys time with (K8
// 0.137 ms at 8 blocks an SM and 32 registers against 0.179 at 50), so
// the registers are capped.
constexpr int CHUNK_FOLD_RUN = 32;   // entries per run (fold_order.py::RUN)
constexpr int CHUNK_FOLD_THREADS = 256;
constexpr int CHUNK_FOLD_WARPS = CHUNK_FOLD_THREADS / 32;

__device__ __forceinline__ int chunk_skew(int p) { return p + (p >> 5); }

template <typename T, int CHUNK>
struct alignas(16) ChunkFoldSmem {
  T val[CHUNK + CHUNK / 32];       // kept values, by lane, skewed
  T runres[CHUNK / CHUNK_FOLD_RUN + LANES];
  int hist[CHUNK_FOLD_WARPS][LANES];   // per-warp counts of each lane
  int start[LANES];                // each lane's first sorted position
  int end[LANES];                  // its end
  int runbase[LANES + 1];          // each lane's first run
  unsigned char runlane[CHUNK / CHUNK_FOLD_RUN + LANES];   // each run's lane
};

// Warp 0, thread id: from the entries c[j] of lanes 4 id + j, each
// lane's start (the exclusive scan of the counts) and end, its first run
// (runbase, and the total at [LANES]) and each run's lane (runlane). A
// count and its runs share one 32-bit scan (at most CHUNK entries, CHUNK /
// RUN + 128 runs).
template <typename S>
__device__ __forceinline__ void lane_bounds(S& s, const int (&c)[4]) {
  const int id = threadIdx.x;
  int pk[4], tot = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pk[j] = tot;
    tot += c[j] | (((c[j] + CHUNK_FOLD_RUN - 1) / CHUNK_FOLD_RUN) << 16);
  }
  int incl = tot;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, d);
    if (id >= d) incl += y;
  }
  const int base = incl - tot;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int l = 4 * id + j;
    const int e = base + pk[j];
    s.start[l] = e & 0xffff;
    s.end[l] = (e & 0xffff) + c[j];
    s.runbase[l] = e >> 16;
    const int nr = (c[j] + CHUNK_FOLD_RUN - 1) / CHUNK_FOLD_RUN;
    for (int r = e >> 16; r < (e >> 16) + nr; ++r) {
      s.runlane[r] = static_cast<unsigned char>(l);
    }
  }
  if (id == 31) s.runbase[LANES] = incl >> 16;
}

// Warp 0: the warps' counts of each lane in hist become each warp's first
// rank of the lane, and the lanes' totals their bounds (lane_bounds).
template <typename S>
__device__ __forceinline__ void lane_runs(S& s) {
  const int id = threadIdx.x;
  int c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int l = 4 * id + j;
    int n = 0;
#pragma unroll
    for (int k = 0; k < CHUNK_FOLD_WARPS; ++k) {
      const int h = s.hist[k][l];
      s.hist[k][l] = n;
      n += h;
    }
    c[j] = n;
  }
  lane_bounds(s, c);
}

// The fold of the values in s.val, sorted by lane (skewed), with the
// lanes' bounds and runs (lane_bounds): thread r folds run r into
// s.runres, then thread l < 128 folds lane l's runs. Returns lane t's
// partial in thread t < 128 (the identity in the others). The caller
// synchronizes before the first read of s.val and before s is used again.
template <typename T, int RED, int CHUNK, bool SHORT_RUNS>
__device__ __forceinline__ T fold_runs(ChunkFoldSmem<T, CHUNK>& s,
                                       T ident) {
  const int t = threadIdx.x;
  const int nruns = s.runbase[LANES];
  for (int r = t; r < nruns; r += CHUNK_FOLD_THREADS) {
    const int l = s.runlane[r];
    const int from = s.start[l] + (r - s.runbase[l]) * CHUNK_FOLD_RUN;
    const int to = min(from + CHUNK_FOLD_RUN, s.end[l]);
    T x = ident;
    if constexpr (SHORT_RUNS) {   // short runs (K8: ~7 entries a lane)
#pragma unroll 8
      for (int e = from; e < to; ++e) {
        x = combine<RED>(x, s.val[chunk_skew(e)]);
      }
    } else {                      // long runs: all their loads in flight
#pragma unroll
      for (int e = 0; e < CHUNK_FOLD_RUN; ++e) {
        if (from + e < to) {
          x = combine<RED>(x, s.val[chunk_skew(from + e)]);
        }
      }
    }
    s.runres[r] = x;
  }
  __syncthreads();
  T acc = ident;
  if (t < LANES) {
    const int end = s.runbase[t + 1];
#pragma unroll 4
    for (int r = s.runbase[t]; r < end; ++r) {
      acc = combine<RED>(acc, s.runres[r]);
    }
  }
  return acc;
}

// The fold of one chunk by the whole block: thread t = 32 w + i holds the
// chunk's slots w SEG + i + 32 j as v[j] (the value) and ln[j] (its lane,
// -1 where the slot is not kept): each warp ranks its slots within their
// lanes, the values go to s.val sorted by lane, and fold_runs folds them.
// Returns lane t's partial in thread t < 128 (the identity in the others).
// Four block barriers; the last read of s follows the last one, so the
// caller synchronizes before s is used again.
template <typename T, int RED, int CHUNK, bool SHORT_RUNS, int E>
__device__ __forceinline__ T fold_kept(ChunkFoldSmem<T, CHUNK>& s,
                                       const T (&v)[E], int (&ln)[E],
                                       T ident) {
  static_assert(E * 32 * CHUNK_FOLD_WARPS == CHUNK, "whole rounds");
  const int t = threadIdx.x, i = t & 31, w = t >> 5;
  // ranks within the warp's segment: ln[j] becomes lane | rank << 8
  int* hist = s.hist[w];
  reinterpret_cast<int4*>(hist)[i] = make_int4(0, 0, 0, 0);
  __syncwarp();
  const unsigned below = (1u << i) - 1u;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int l = ln[j];
    const unsigned peers = __match_any_sync(FULL_MASK, l >= 0 ? l
                                                       : LANES + i);
    const int before = l >= 0 ? hist[l] : 0;
    __syncwarp();
    if (l >= 0 && (peers & below) == 0) {
      hist[l] = before + __popc(peers);
    }
    __syncwarp();
    if (l >= 0) ln[j] = l | (before + __popc(peers & below)) << 8;
  }
  __syncthreads();
  if (t < 32) lane_runs(s);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (ln[j] >= 0) {
      const int l = ln[j] & 0xff;
      s.val[chunk_skew(s.start[l] + hist[l] + (ln[j] >> 8))] = v[j];
    }
  }
  __syncthreads();
  return fold_runs<T, RED, CHUNK, SHORT_RUNS>(s, ident);
}

// K5 on contributions and K8: c and lane are streams read once
// (evict-first loads); MASKED drops the slots whose ev byte is 0.
template <typename T, int RED, typename L, int CHUNK, bool MASKED>
__global__ void __launch_bounds__(CHUNK_FOLD_THREADS, MASKED ? 8 : 6)
chunk_fold_kernel(const T* __restrict__ c, const L* __restrict__ lane,
                  const int8_t* __restrict__ ev,
                  const int* __restrict__ chunks, T* __restrict__ part,
                  T ident) {
  constexpr int SEG = CHUNK / CHUNK_FOLD_WARPS;   // slots of a warp
  constexpr int E = SEG / 32;                     // slots of a thread
  __shared__ ChunkFoldSmem<T, CHUNK> s;
  const int t = threadIdx.x, i = t & 31, w = t >> 5;
  const int chunk = __ldg(chunks + blockIdx.x);
  T acc = ident;                 // thread t < 128: lane t's partial
  if (chunk >= 0) {              // the same in the whole block
    const long long base =
        static_cast<long long>(chunk) * CHUNK + w * SEG + i;
    const L* lp = lane + base;
    const T* cp = c + base;
    T v[E];
    int ln[E];                   // the lane, -1 where not kept
#pragma unroll
    for (int j = 0; j < E; ++j) {
      ln[j] = static_cast<int>(__ldcs(lp + 32 * j));
      v[j] = __ldcs(cp + 32 * j);
      if constexpr (MASKED) {    // every load, then the mask
        if (__ldcs(ev + base + 32 * j) == 0) ln[j] = -1;
      }
    }
    acc = fold_kept<T, RED, CHUNK, MASKED>(s, v, ln, ident);
  }
  if (t < LANES) part[static_cast<long long>(blockIdx.x) * LANES + t] = acc;
}

// K5 on contributions and K8: pass (a) over the nitems list items into
// part (nitems, 128), then pass (b) by launch_row_fold over the list
// positions into y (nblocks, 128).
template <typename T, typename L, int CHUNK, bool MASKED>
int launch_chunk_fold(const void* c, const void* lane, const void* ev,
                      const void* chunks, const void* rptr,
                      const void* gptr, void* part, void* gpart, void* y,
                      long long nitems, long long nblocks, long long ngroups,
                      int red, double identity, cudaStream_t st) {
  const T ident = static_cast<T>(identity);
  const int rc = dispatch_red(red, [&](auto rk) {
    constexpr int RED = decltype(rk)::value;
    if (nitems > 0) {
      chunk_fold_kernel<T, RED, L, CHUNK, MASKED>
          <<<static_cast<unsigned>(nitems), CHUNK_FOLD_THREADS, 0, st>>>(
              static_cast<const T*>(c), static_cast<const L*>(lane),
              static_cast<const int8_t*>(ev),
              static_cast<const int*>(chunks), static_cast<T*>(part),
              ident);
    }
    launch_row_fold<T, RED>(part, rptr, gptr, nullptr, gpart, y, nblocks,
                            ngroups, ident, st);
  });
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

}  // namespace gt
