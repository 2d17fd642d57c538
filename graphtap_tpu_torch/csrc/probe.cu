// Hopper (sm_90a) kernels of the port's device-memory probes.
//
// Hand-written CUDA C++ counterparts of the Pallas probes in tools_dev/:
//
//   P1 copy_tile_kernel   replaces bw_probe.py copy_1d / copy_2d
//                         (_copy_kernel :45, calls :55, :80)
//   P2 stream_sum_kernel  replaces bw_probe.py multi_stream_sum
//                         (kern :118, call :126)
//   P3 route_like_kernel  replaces route_cost_probe.py route_like
//                         (_body :36, call :57)
//
// What they compute. P1: y = x, one block per (bm rows, bn columns) tile
// of a row-major (rows, cols) array, as the Pallas grid steps one block
// per tile. P2: o = ((x0 + x1) + x2) + x3 over 2 or 4 f32 streams, one
// block per (bm, lanes) tile. P3: per panel i, the sum of its nwin
// (8, 128) f32 windows x2d[bases[i*nwin + t]*8 : +8] in order t = 0 ..
// nwin-1, written 8 times into the (64, 128) output panel i.
//
// What bounds them on the card: bytes. P1 and P2 do no arithmetic (P2 one
// add per input element); P3 reads nwin windows and writes 8 copies of
// their sum, nwin - 1 adds per window element. All are far below the
// card's ~20 operations per byte, so each is held to (bytes moved) / 3.35
// TB/s, and P1 and P2 measure the rate the card really reaches, which the
// other kernels' bounds can be set against. P3 measures what one panel
// costs under the gather pattern of K1-K3 (nwin data-dependent 4 KB
// windows), as a function of nwin and of the windows' locality.
//
// Design: simple, one block per tile or panel as the Pallas grid walks
// them; 16-byte vector loads and stores, neighbouring threads on
// neighbouring addresses. The launchers are extern "C" (bound with
// ctypes), launch on the caller's stream, allocate nothing, check the
// shapes they need, and return cudaGetLastError(). Offsets are 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

using namespace gt;

namespace {

constexpr int VEC = 16;          // bytes per vector access
constexpr int STRIPE = 8;
constexpr int PROWS = 64;
constexpr int WIN_EL = STRIPE * LANES;   // f32 elements of one window

// P1: tile (ti, tj) is rows ti*bm .. +bm, vectors tj*bn .. +bn of a
// (rows, row_vecs) array of 16-byte vectors.
__global__ void __launch_bounds__(THREADS)
copy_tile_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                 long long row_vecs, int bm, int bn, long long tiles_per_row) {
  const long long tile = blockIdx.x;
  const long long ti = tile / tiles_per_row;
  const long long tj = tile - ti * tiles_per_row;
  const long long base = ti * bm * row_vecs + tj * bn;
  const int n = bm * bn;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / bn;
    const long long off = base + r * row_vecs + (e - r * bn);
    y[off] = x[off];
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// P2: block b sums the streams over elements b*n .. +n (n = bm * lanes,
// in float4 units), in stream order.
__global__ void __launch_bounds__(THREADS)
stream_sum_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                  const float4* __restrict__ c, const float4* __restrict__ d,
                  float4* __restrict__ o, int n) {
  const long long base = static_cast<long long>(blockIdx.x) * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    float4 acc = add4(a[base + e], b[base + e]);
    if (c != nullptr) acc = add4(add4(acc, c[base + e]), d[base + e]);
    o[base + e] = acc;
  }
}

// P3: block p sums its panel's nwin windows (float4 units) in order and
// writes the sum into the panel's 8 bands.
__global__ void __launch_bounds__(THREADS)
route_like_kernel(const float4* __restrict__ x2d, const int* __restrict__ bases,
                  float4* __restrict__ out, int nwin) {
  constexpr int W4 = WIN_EL / 4;
  const long long p = blockIdx.x;
  const int* pb = bases + p * nwin;
  float4* po = out + p * (PROWS * LANES / 4);
  for (int e = threadIdx.x; e < W4; e += blockDim.x) {
    float4 acc = x2d[static_cast<long long>(pb[0]) * W4 + e];
    for (int t = 1; t < nwin; ++t) {
      acc = add4(acc, x2d[static_cast<long long>(pb[t]) * W4 + e]);
    }
#pragma unroll
    for (int k = 0; k < PROWS / STRIPE; ++k) po[k * W4 + e] = acc;
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % VEC) == 0;
}

}  // namespace

extern "C" {

// A (rows, row_bytes) array in (bm, bn_bytes) tiles; bn_bytes a multiple
// of 16 dividing row_bytes, bm dividing rows.
int gt_probe_copy(const void* x, void* y, long long rows, long long row_bytes,
                  int bm, long long bn_bytes, void* stream) {
  if (rows <= 0 || bm <= 0 || bn_bytes <= 0 || bn_bytes % VEC ||
      row_bytes % bn_bytes || rows % bm || !aligned(x) || !aligned(y)) {
    return cudaErrorInvalidValue;
  }
  const long long tiles_per_row = row_bytes / bn_bytes;
  const long long tiles = rows / bm * tiles_per_row;
  const int bn = static_cast<int>(bn_bytes / VEC);
  if (tiles > 0x7fffffffLL || static_cast<long long>(bm) * bn > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  copy_tile_kernel<<<static_cast<unsigned>(tiles), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), row_bytes / VEC,
      bm, bn, tiles_per_row);
  return cudaGetLastError();
}

// nstreams 2 (c, d NULL) or 4 f32 streams of (rows, lanes) in (bm, lanes)
// blocks; lanes a multiple of 4, bm dividing rows.
int gt_probe_stream_sum(const void* a, const void* b, const void* c,
                        const void* d, void* o, int nstreams, long long rows,
                        int lanes, int bm, void* stream) {
  const bool four = nstreams == 4;
  if ((nstreams != 2 && !four) || (four && (c == nullptr || d == nullptr)) ||
      rows <= 0 || bm <= 0 || rows % bm || lanes % 4 || !aligned(a) ||
      !aligned(b) || !aligned(o) || (four && (!aligned(c) || !aligned(d)))) {
    return cudaErrorInvalidValue;
  }
  stream_sum_kernel<<<static_cast<unsigned>(rows / bm), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      four ? static_cast<const float4*>(c) : nullptr,
      four ? static_cast<const float4*>(d) : nullptr,
      static_cast<float4*>(o), bm * lanes / 4);
  return cudaGetLastError();
}

// x2d (nblocks*8, 128) f32, bases (npanels*nwin) int32 in [0, nblocks),
// out (npanels*64, 128) f32.
int gt_probe_route_like(const void* x2d, const void* bases, void* out,
                        long long npanels, int nwin, void* stream) {
  if (npanels <= 0 || nwin <= 0 || !aligned(x2d) || !aligned(out)) {
    return cudaErrorInvalidValue;
  }
  route_like_kernel<<<static_cast<unsigned>(npanels), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x2d), static_cast<const int*>(bases),
      static_cast<float4*>(out), nwin);
  return cudaGetLastError();
}

}  // extern "C"
