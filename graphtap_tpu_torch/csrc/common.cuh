// Device helpers shared by the port's kernels (panel_route.cu, shuffle.cu,
// gather.cu, onehot.cu, probe.cu).
//
// The value types, ⊗ and ⊕ kinds as the wrappers number them
// (kernels/panel_kernels.py: _DTYPES, _MUL_KINDS, _REDUCE_KINDS), the
// saturating min-plus ⊗, the ⊕ combine and its atomic form, a grid-stride
// fill, 16-byte stores and loads of four values, the Hopper TMA helpers
// (mbarriers, bulk copies both ways, bulk groups) of the plan rings of
// K1-K3 and K11 and of P1's copy ring, and the two fixed-order passes of
// the K3, K5 and K8 folds.

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

// min-plus ⊗: INF stays INF, so INF + w never wraps (panel_kernels.py:134,
// shuffle_kernels.py:59-61).
template <typename T>
__device__ __forceinline__ T add_sat(T acc, T w, T fill) {
  return acc >= fill ? fill : acc + w;
}
template <>
__device__ __forceinline__ int add_sat<int>(int acc, int w, int fill) {
  // below INF the sum is the Pallas kernels' int32 add (two's complement)
  return acc >= fill ? fill
                     : static_cast<int>(static_cast<unsigned>(acc) +
                                        static_cast<unsigned>(w));
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

// Works on global and shared memory alike (f32/f64 atomicAdd, int32 all).
template <int RED, typename T>
__device__ __forceinline__ void atomic_combine(T* addr, T v) {
  if constexpr (RED == RED_SUM) {
    atomicAdd(addr, v);
  } else if constexpr (RED == RED_MIN) {
    atomicMin(addr, v);
  } else {
    atomicMax(addr, v);
  }
}

// ⊗ of one contribution with its weight pw[e] (MUL_NONE: none).
template <typename T, int MUL>
__device__ __forceinline__ T apply_mul(T v, const T* __restrict__ pw,
                                       long long e, T fill) {
  if constexpr (MUL == MUL_MUL) {
    return v * pw[e];
  } else if constexpr (MUL == MUL_ADD_SAT) {
    return add_sat<T>(v, pw[e], fill);
  } else {
    return v;
  }
}

template <typename T>
__global__ void fill_kernel(T* __restrict__ y, long long n, T v) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    y[i] = v;
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

template <typename T>
void launch_fill(T* y, long long n, T v, cudaStream_t st) {
  if (n > 0) fill_kernel<T><<<stride_blocks(n), THREADS, 0, st>>>(y, n, v);
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
// written once. No atomics, no fill pass.

constexpr unsigned FULL_MASK = 0xffffffffu;

// Pass (a) of K5 and K8: one 128-thread block per chunk of CHUNK entries;
// entry e goes to lane lane[e] (skipped where ev[e] == 0; ev == nullptr:
// none skipped), and thread l folds lane l's entries one at a time in index
// order. To hand each thread its entries without a scan of the whole chunk
// per lane, the block sorts the chunk's values by lane in shared memory,
// stably: thread t holds entries r*128 + t (r = 0 .. CHUNK/128-1) in
// registers; a shared histogram gives each lane's start; then, round r by
// round r, each warp ranks its entries among equal lanes (__match_any_sync)
// and places them after those of earlier warps and rounds. A lane with many
// entries (a hub row) costs a chain of that many adds out of shared memory,
// and nothing more.
template <typename T, int RED, typename L, int CHUNK>
__global__ void __launch_bounds__(LANES)
chunk_lanes_kernel(const T* __restrict__ c, const L* __restrict__ lane,
                   const int8_t* __restrict__ ev, T* __restrict__ part,
                   T ident) {
  constexpr int R = CHUNK / LANES;
  constexpr int NW = LANES / 32;
  __shared__ T s_val[CHUNK];            // kept values, by lane, index order
  __shared__ int s_count[LANES];        // kept entries per lane
  __shared__ int s_next[LANES];         // next free slot of each lane
  __shared__ int s_warp[NW][LANES];     // this round's entries per warp, lane
  __shared__ int s_wsum[NW];
  const int t = threadIdx.x;
  const int tid = t & 31;
  const int w = t >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * CHUNK;
  s_count[t] = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) s_warp[k][t] = 0;
  __syncthreads();
  int l[R];
  T v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long e = base + r * LANES + t;
    l[r] = static_cast<int>(lane[e]);
    if (ev != nullptr && ev[e] == 0) l[r] = -1;
    v[r] = c[e];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (l[r] >= 0) atomicAdd(&s_count[l[r]], 1);   // an integer count
  }
  __syncthreads();
  // exclusive scan of the counts over the lanes: each lane's first slot
  const int cnt = s_count[t];
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, d);
    if (tid >= d) incl += y;
  }
  if (tid == 31) s_wsum[w] = incl;
  __syncthreads();
  int start = incl - cnt;
  for (int k = 0; k < w; ++k) start += s_wsum[k];
  s_next[t] = start;
  __syncthreads();
  const unsigned below = (1u << tid) - 1u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned peers = __match_any_sync(FULL_MASK, l[r]);
    const int rank = __popc(peers & below);
    if (l[r] >= 0 && rank == 0) s_warp[w][l[r]] = __popc(peers);
    __syncthreads();
    if (l[r] >= 0) {
      int pos = s_next[l[r]] + rank;
      for (int k = 0; k < w; ++k) pos += s_warp[k][l[r]];
      s_val[pos] = v[r];
    }
    __syncthreads();
    int add = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      add += s_warp[k][t];
      s_warp[k][t] = 0;
    }
    s_next[t] += add;
    __syncthreads();
  }
  T acc = ident;
#pragma unroll 8
  for (int k = start; k < start + cnt; ++k) acc = combine<RED>(acc, s_val[k]);
  part[static_cast<long long>(blockIdx.x) * LANES + t] = acc;
}

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

// K5 and K8: pass (a) over nchunks chunks into part (nchunks, 128), then
// pass (b) over the nblocks row blocks of y by the block -> chunks lists.
template <typename T, typename L, int CHUNK>
int launch_chunk_fold(const void* c, const void* lane, const void* ev,
                      const void* rptr, const void* gptr, const void* idx,
                      void* part, void* gpart, void* y, long long nchunks,
                      long long nblocks, long long ngroups, int red,
                      double identity, cudaStream_t st) {
  const T ident = static_cast<T>(identity);
  const int rc = dispatch_red(red, [&](auto r) {
    constexpr int RED = decltype(r)::value;
    if (nchunks > 0) {
      chunk_lanes_kernel<T, RED, L, CHUNK>
          <<<static_cast<unsigned>(nchunks), LANES, 0, st>>>(
              static_cast<const T*>(c), static_cast<const L*>(lane),
              static_cast<const int8_t*>(ev), static_cast<T*>(part), ident);
    }
    launch_row_fold<T, RED>(part, rptr, gptr, idx, gpart, y, nblocks,
                            ngroups, ident, st);
  });
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

}  // namespace gt
