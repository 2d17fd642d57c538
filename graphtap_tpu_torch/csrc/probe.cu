// Hopper (sm_90a) kernels of the port's device-memory probes.
//
// Hand-written CUDA C++ counterparts of the Pallas probes in tools_dev/:
//
//   P1 copy_chunk_kernel  replaces bw_probe.py copy_1d / copy_2d
//                         (_copy_kernel :45, calls :55, :80)
//   P2 stream_sum_kernel  replaces bw_probe.py multi_stream_sum
//                         (kern :118, call :126)
//   P3 route_like_kernel  replaces route_cost_probe.py route_like
//                         (_body :36, call :57)
//
// What they compute. P1: y = x, a row-major (rows, cols) array copied in
// (bm rows, bn columns) tiles, tile by tile as the Pallas grid steps. P2:
// o = ((x0 + x1) + x2) + x3 over 2 or 4 f32 streams. P3: per panel i,
// the sum of its nwin (8, 128) f32 windows x2d[bases[i*nwin + t]*8 : +8]
// in order t = 0 .. nwin-1, written 8 times into the (64, 128) output
// panel i.
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
// Design. P1 measures TMA bulk copies, global -> shared on an mbarrier
// and bulk stores back, no value in registers, with one block a chunk.
// The plan rings of K1-K3 and K11 move their plans with the same copies
// but walk them in persistent blocks, a design that ran about 3% behind
// this one on the H100 (PERF.md). The copy is cut, in tile order, into
// chunks: up to chunk_rows consecutive rows of one tile (a row segment
// wider than a chunk splits into pieces of one row; bw_probe.py's
// copy_chunks picks them), so the tile geometry sets the length and
// stride of every row segment. Block c, one warp, copies chunk c: lane 0
// arrives on the mbarrier expecting the chunk's bytes, lane r loads rows
// r, r + 32, ... global -> shared, every lane waits for the barrier and
// stores its rows back shared -> global in its own bulk group, and the
// block ends once its stores have read shared memory
// (cp.async.bulk.wait_group.read). The ring is the SM's resident blocks:
// as many chunks in flight an SM as its shared memory holds (six of 32
// KB), handed out in tile order by the block scheduler as blocks end.
// Persistent blocks walking a ring of stages, chunk c to block c mod
// grid, were 3% slower on the H100, and taking the chunks from a global
// counter was no faster than this (PERF.md). P2 does not take the TPU's
// (64, 1024) blocks as its grid: their 536 blocks at the kernels-line
// shape leave 8 SMs a fifth block to finish alone. Each 256-thread block
// sums a 16 KB chunk of every stream (~8,600 blocks), four float4s a
// thread, every load of the chunk issued before the first add, the
// stores streaming (evict-first), the last chunk guarded. Streaming loads
// as well were no faster on the H100, and streaming loads with plain
// stores 3% slower; bringing the chunks into shared memory by TMA, as P1
// does, and summing from there was no faster either (PERF.md). P3:
// simple, one block per panel as the Pallas grid walks them; 16-byte
// vector loads and stores, neighbouring threads on neighbouring
// addresses. The launchers are extern "C" (bound with ctypes), launch on
// the caller's stream, allocate nothing, check the shapes they need, and
// return cudaGetLastError(). Offsets are 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

using namespace gt;

namespace {

constexpr int VEC = 16;          // bytes per vector access
constexpr int SMEM_BLOCK = 232448;   // shared memory a block may have
constexpr int MBAR_BYTES = 8;        // P1's mbarrier, beside its chunk
constexpr int STRIPE = 8;
constexpr int PROWS = 64;
constexpr int WIN_EL = STRIPE * LANES;   // f32 elements of one window

// P1: tile (ti, tj) is rows ti*bm .. +bm, bytes tj*bn_bytes .. +bn_bytes
// of a (rows, row_bytes) array. A tile is rchunks x pieces chunks, in
// order: rows rc*chunk_rows .. +chunk_rows (fewer in the last), bytes
// pc*piece .. +piece of the tile's segment (less in the last piece).
struct CopyGeom {
  long long row_bytes, bn_bytes, tiles_per_row, nchunks;
  int bm, chunk_rows, rchunks, pieces, piece;
};

constexpr int COPY_THREADS = 32;   // one warp a chunk

// Chunk c's byte offset in the array, its rows and the bytes of each of
// its row segments.
__device__ __forceinline__ void copy_chunk(const CopyGeom& g, long long c,
                                           long long* off, int* nr,
                                           int* seg) {
  const long long per_tile = static_cast<long long>(g.rchunks) * g.pieces;
  const long long tile = c / per_tile;
  const int k = static_cast<int>(c - tile * per_tile);
  const int rc = k / g.pieces;
  const int pc = k - rc * g.pieces;
  const long long ti = tile / g.tiles_per_row;
  const long long tj = tile - ti * g.tiles_per_row;
  const int r0 = rc * g.chunk_rows;
  *nr = min(g.chunk_rows, g.bm - r0);
  *seg = static_cast<int>(min(static_cast<long long>(g.piece),
                              g.bn_bytes - static_cast<long long>(pc) *
                                               g.piece));
  *off = (ti * g.bm + r0) * g.row_bytes + tj * g.bn_bytes +
         static_cast<long long>(pc) * g.piece;
}

// Block c copies chunk c through shared memory: lane r moves rows r,
// r + 32, ... by TMA, lane 0 drives the mbarrier.
__global__ void __launch_bounds__(COPY_THREADS)
copy_chunk_kernel(const unsigned char* __restrict__ x,
                  unsigned char* __restrict__ y, CopyGeom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  long long off;
  int nr, seg;
  copy_chunk(g, blockIdx.x, &off, &nr, &seg);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem + g.chunk_rows * g.piece);
  if (lane == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_arrive_tx(bar, static_cast<unsigned>(nr * seg));
  }
  __syncwarp();
  for (int r = lane; r < nr; r += COPY_THREADS) {
    bulk_load(smem + r * seg, x + off + r * g.row_bytes, seg, bar);
  }
  mbar_wait(bar, 0);
  fence_async_smem();
  for (int r = lane; r < nr; r += COPY_THREADS) {
    bulk_store(y + off + r * g.row_bytes, smem + r * seg, seg);
  }
  bulk_commit();
  bulk_wait_read<0>();
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// P2: block b sums the streams over float4s b*SUM_CHUNK .. +SUM_CHUNK
// (the last block's chunk may be partial), SUM_VEC a thread: every load
// of the chunk, for all NS streams, is issued before the first add, and
// the stores stream (evict-first: nothing reads the output again). The
// adds keep the stream order.
constexpr int SUM_VEC = 4;                    // float4s a thread, a stream
constexpr int SUM_CHUNK = THREADS * SUM_VEC;  // float4s a block (16 KB)

template <int NS>
__global__ void __launch_bounds__(THREADS)
stream_sum_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                  const float4* __restrict__ c, const float4* __restrict__ d,
                  float4* __restrict__ o, long long n4) {
  const float4* in[4] = {a, b, c, d};
  const long long base =
      static_cast<long long>(blockIdx.x) * SUM_CHUNK + threadIdx.x;
  float4 v[NS][SUM_VEC];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int k = 0; k < SUM_VEC; ++k) {
      const long long e = base + k * THREADS;
      if (e < n4) v[s][k] = in[s][e];
    }
  }
#pragma unroll
  for (int k = 0; k < SUM_VEC; ++k) {
    const long long e = base + k * THREADS;
    if (e < n4) {
      float4 acc = add4(v[0][k], v[1][k]);
      if constexpr (NS == 4) acc = add4(add4(acc, v[2][k]), v[3][k]);
      __stcs(o + e, acc);
    }
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
// of 16 dividing row_bytes, bm dividing rows. chunk_rows (1 .. bm) rows of
// `pieces` pieces of piece_bytes (a multiple of 16; the last piece of a
// segment holds the rest) make a chunk (bw_probe.py::copy_chunks); one
// chunk and its mbarrier must fit a block's shared memory. One block a
// chunk.
int gt_probe_copy(const void* x, void* y, long long rows, long long row_bytes,
                  int bm, long long bn_bytes, int chunk_rows, int pieces,
                  long long piece_bytes, void* stream) {
  if (rows <= 0 || bm <= 0 || bn_bytes <= 0 || bn_bytes % VEC ||
      row_bytes % bn_bytes || rows % bm || !aligned(x) || !aligned(y) ||
      chunk_rows < 1 || chunk_rows > bm || pieces < 1 || piece_bytes <= 0 ||
      piece_bytes % VEC || (pieces - 1) * piece_bytes >= bn_bytes ||
      pieces * piece_bytes < bn_bytes) {
    return cudaErrorInvalidValue;
  }
  CopyGeom g;
  g.row_bytes = row_bytes;
  g.bn_bytes = bn_bytes;
  g.tiles_per_row = row_bytes / bn_bytes;
  g.bm = bm;
  g.chunk_rows = chunk_rows;
  g.rchunks = (bm + chunk_rows - 1) / chunk_rows;
  g.pieces = pieces;
  g.piece = static_cast<int>(piece_bytes);
  g.nchunks = rows / bm * g.tiles_per_row * g.rchunks * pieces;
  const long long smem =
      static_cast<long long>(chunk_rows) * piece_bytes + MBAR_BYTES;
  if (smem > SMEM_BLOCK || g.nchunks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  static const cudaError_t ready = cudaFuncSetAttribute(
      copy_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BLOCK);
  if (ready != cudaSuccess) return ready;
  copy_chunk_kernel<<<static_cast<unsigned>(g.nchunks), COPY_THREADS,
                      static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), g);
  return cudaGetLastError();
}

// *per_sm = the P1 blocks (chunks in flight) one SM holds at once for
// chunks of chunk_bytes.
int gt_probe_copy_blocks_per_sm(long long chunk_bytes, int* per_sm) {
  const long long smem = chunk_bytes + MBAR_BYTES;
  if (chunk_bytes <= 0 || smem > SMEM_BLOCK) return cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      copy_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BLOCK);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, copy_chunk_kernel, COPY_THREADS, static_cast<size_t>(smem));
  }
  return rc;
}

// nstreams 2 (c, d NULL) or 4 f32 streams of (rows, lanes), validated in
// (bm, lanes) blocks as the Pallas probe cuts them (bm dividing rows,
// lanes a multiple of 4); bm does not set the grid: SUM_CHUNK float4s a
// block.
int gt_probe_stream_sum(const void* a, const void* b, const void* c,
                        const void* d, void* o, int nstreams, long long rows,
                        int lanes, int bm, void* stream) {
  const bool four = nstreams == 4;
  if ((nstreams != 2 && !four) || (four && (c == nullptr || d == nullptr)) ||
      rows <= 0 || bm <= 0 || rows % bm || lanes <= 0 || lanes % 4 ||
      !aligned(a) || !aligned(b) || !aligned(o) ||
      (four && (!aligned(c) || !aligned(d)))) {
    return cudaErrorInvalidValue;
  }
  const long long n4 = rows * lanes / 4;
  const long long grid = (n4 + SUM_CHUNK - 1) / SUM_CHUNK;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* fa = static_cast<const float4*>(a);
  const float4* fb = static_cast<const float4*>(b);
  float4* fo = static_cast<float4*>(o);
  if (four) {
    stream_sum_kernel<4><<<static_cast<unsigned>(grid), THREADS, 0, st>>>(
        fa, fb, static_cast<const float4*>(c), static_cast<const float4*>(d),
        fo, n4);
  } else {
    stream_sum_kernel<2><<<static_cast<unsigned>(grid), THREADS, 0, st>>>(
        fa, fb, nullptr, nullptr, fo, n4);
  }
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
