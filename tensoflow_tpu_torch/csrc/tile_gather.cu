// Row and lane gathers: the card's counterparts of the four Pallas probes
// of scripts/microbench_r3.py.
//
//    kernel              probe (microbench_r3.py)
//    row_gather_kernel   kern :68 (f32 row gather in one tile), kern_g :98
//                        (the same over many tiles), kern3 :155 (bf16)
//    lane_gather_kernel  kern2 :126 (f32 lane gather)
//
// The probes asked whether a gather can run INSIDE a kernel on a tile that
// sits in the TPU's VMEM.  On this card the tile needs no staging: the
// H100's 50 MB L2 holds the probes' 1.31 MB table and serves every
// repeated row.
//
// Bound.  Bytes: table + indices read once, output written once, over the
// HBM rate (a gather does no arithmetic).  A single 256-row tile moves
// 0.26-2.6 MB: about what the card must keep in flight to reach its rate
// at all (3.35 TB/s x ~0.7 us of DRAM latency ~ 2.3 MB), so a tile is
// bound by latency, two dependent loads (the index, then the row), and by
// the launch floor, not by bandwidth.  The gridded probe (131,072 rows,
// 671 MB written) is bound by the HBM write rate.
//
//  * row_gather_kernel: out[r, :] = table[idx[r], :].  A gather copies
//    bits, so the kernel moves 16-byte words whatever the element type.
//    A unit is one row x one 512-byte column chunk, moved by one warp:
//    lane 0 loads the row index and a shuffle broadcasts it, every lane
//    loads its 16-byte word of the row and stores it streaming (__stcs:
//    nobody reads the output again).  Block b serves chunk b % chunks, so
//    neighbouring blocks write neighbouring chunks of the same rows.  The
//    geometry (ops/tile_gather.row_gather_geometry) gives every SM work
//    at every probe shape: a block holds at most 8 warps, and fewer where
//    that leaves fewer blocks than SMs, and the grid covers every row in
//    one pass.  Loads in flight come from the warps resident on every SM,
//    not from several rows a warp: measured on an NVIDIA H100 80GB HBM3 at
//    700 W (PERF.md §6), 2-4 rows a warp were slower at a tile and no
//    faster on the gridded probe, and persistent grids that walk the rows
//    were slower still.  The kernel still walks the rows in a grid-stride
//    loop, so any grid of a multiple of the chunks is right.  Indices are
//    not checked (the probes' are in range; the plain version raises on
//    one that is not).
//  * lane_gather_kernel: out[r, c] = table[r, idx[r, c]] on 4-byte words.
//    One table row a block (256 rows give every SM work), its columns
//    split over the block's threads: a thread reads its four indices as
//    one int4 before the row is in, stages four columns of the row in
//    shared memory with one 16-byte load, then gathers four values from
//    shared memory and stores them as one 16-byte word.  Random indices
//    make bank conflicts in that read: they are the expected cost.  A
//    width that is not a multiple of four (rows not 16-byte aligned)
//    takes the same steps one word at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK16 = 32;           // 16-byte words of a chunk (512 B)
constexpr int ROW_THREADS = 256;      // at most, row gather (8 warps)
constexpr int LANE_THREADS = 256;     // at most, lane gather
constexpr int LANE_SMEM = 48 * 1024;  // static limit: no attribute call

__global__ void __launch_bounds__(ROW_THREADS)
row_gather_kernel(const uint4* __restrict__ table,
                  const int* __restrict__ idx, uint4* __restrict__ out,
                  int w16, int n_rows, int chunks) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int c = (blockIdx.x % chunks) * CHUNK16 + lane;
  const bool live = c < w16;  // the last chunk may be narrower
  const int stride = gridDim.x / chunks * warps;
  for (int r = blockIdx.x / chunks * warps + (threadIdx.x >> 5); r < n_rows;
       r += stride) {
    const int src = __shfl_sync(0xffffffffu, lane == 0 ? __ldg(idx + r) : 0,
                                0);
    if (live) __stcs(out + (size_t)r * w16 + c,
                     __ldg(table + (size_t)src * w16 + c));
  }
}

template <bool VEC>
__global__ void __launch_bounds__(LANE_THREADS)
lane_gather_kernel(const uint32_t* __restrict__ table,
                   const int* __restrict__ idx, uint32_t* __restrict__ out,
                   int width) {
  extern __shared__ uint4 row_s4[];   // [width] 4-byte words
  const uint32_t* row_s = reinterpret_cast<const uint32_t*>(row_s4);
  const size_t base = (size_t)blockIdx.x * width;
  const int t = threadIdx.x;
  if (VEC) {
    const int w4 = width >> 2;
    const uint4* t4 = reinterpret_cast<const uint4*>(table + base);
    const int4* i4 = reinterpret_cast<const int4*>(idx + base);
    uint4* o4 = reinterpret_cast<uint4*>(out + base);
    int4 j = t < w4 ? __ldg(i4 + t) : make_int4(0, 0, 0, 0);
    for (int c = t; c < w4; c += blockDim.x) row_s4[c] = __ldg(t4 + c);
    __syncthreads();
    for (int c = t; c < w4; c += blockDim.x) {
      if (c != t) j = __ldg(i4 + c);
      __stcs(o4 + c, make_uint4(row_s[j.x], row_s[j.y], row_s[j.z],
                                row_s[j.w]));
    }
  } else {
    uint32_t* rs = reinterpret_cast<uint32_t*>(row_s4);
    for (int c = t; c < width; c += blockDim.x)
      rs[c] = __ldg(table + base + c);
    __syncthreads();
    for (int c = t; c < width; c += blockDim.x)
      __stcs(out + base + c, row_s[__ldg(idx + base + c)]);
  }
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// table [*, row_bytes], idx [n_rows] int32, out [n_rows, row_bytes];
// row_bytes a multiple of 16, table and out 16-byte aligned.  blocks and
// warps (a block, at most 8) as ops/tile_gather.row_gather_geometry gives
// them; blocks a multiple of the row's 512-byte chunks.
extern "C" int tile_row_gather(const void* table, const int* idx, void* out,
                               int row_bytes, int n_rows, int blocks,
                               int warps, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || n_rows <= 0 || blocks <= 0 ||
      warps < 1 || warps * 32 > ROW_THREADS || misaligned(table) ||
      misaligned(out))
    return (int)cudaErrorInvalidValue;
  const int w16 = row_bytes / 16;
  const int chunks = (w16 + CHUNK16 - 1) / CHUNK16;
  if (blocks % chunks != 0) return (int)cudaErrorInvalidValue;
  row_gather_kernel<<<blocks, warps * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, idx, (uint4*)out, w16, n_rows, chunks);
  return (int)cudaGetLastError();
}

// table, out [n_rows, width] of 4-byte words, idx [n_rows, width] int32;
// one block a row of `threads` threads (ops/tile_gather.lane_gather_geometry);
// vec: width a multiple of 4 and every pointer 16-byte aligned.
extern "C" int tile_lane_gather(const void* table, const int* idx, void* out,
                                int n_rows, int width, int threads, int vec,
                                void* stream) {
  const size_t smem = (size_t)width * sizeof(uint32_t);
  if (n_rows <= 0 || width <= 0 || threads < 32 || threads > LANE_THREADS ||
      smem > LANE_SMEM ||
      (vec && (width % 4 != 0 || misaligned(table) || misaligned(idx) ||
               misaligned(out))))
    return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  if (vec)
    lane_gather_kernel<true><<<n_rows, threads, smem, s>>>(
        (const uint32_t*)table, idx, (uint32_t*)out, width);
  else
    lane_gather_kernel<false><<<n_rows, threads, smem, s>>>(
        (const uint32_t*)table, idx, (uint32_t*)out, width);
  return (int)cudaGetLastError();
}
