// Gathers from a tile staged in shared memory.
//
// Replaces the four Pallas probes of scripts/microbench_r3.py (kern :68,
// kern_g :98, kern2 :126, kern3 :155), which asked whether a gather can run
// INSIDE a kernel on a tile that sits in fast memory, as groundwork for
// moving the stencil head's row gather into the head.  The counterpart on
// this card stages the table (or a column slab of it) in shared memory and
// gathers from there.
//
// Bound: bytes only (a gather does no arithmetic): table + indices read
// once, output written once, over the HBM rate.
//
//  * tile_row_gather: out[r, :] = table[idx[r], :].  A gather copies bits,
//    so the kernel is blind to the element type and moves 16-byte words:
//    the same code serves the float32 and the bfloat16 probe.  A
//    [256, 1280] float32 table (1.31 MB) does not fit a block's 227 KB of
//    shared memory, so the table is cut into column slabs of 512 bytes a
//    row ([256, 512 B] = 128 KB), one slab per block.  The grid is
//    (slabs, row groups); a block loads its slab ONCE and then walks all
//    the rows of its group, one warp per output row: lane l copies the
//    16-byte word l of slab row idx[r], so a warp reads 512 contiguous
//    bytes of shared memory (no bank conflict) and writes 512 contiguous
//    bytes of the output.  Indices are not checked (the probes' are in
//    range; the plain version raises on one that is not).
//  * tile_lane_gather: out[r, c] = table[r, idx[r, c]] on 4-byte words.
//    One warp per table row: the row goes to shared memory, idx[r, :] is
//    read coalesced, and each lane reads row_s[idx] (bank conflicts on
//    random indices are the expected cost).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLAB16 = 32;          // 16-byte words per slab row (512 B)
constexpr int ROW_THREADS = 1024;   // 32 warps: enough stores in flight
constexpr int LANE_WARPS = 8;       // table rows per block (lane gather)
constexpr int MAX_SMEM = 232448;    // 227 KB

__global__ void __launch_bounds__(ROW_THREADS)
row_gather_kernel(const uint4* __restrict__ table,
                  const int* __restrict__ idx, uint4* __restrict__ out,
                  int table_rows, int w16, int n_rows, int rows_per_block) {
  extern __shared__ uint4 slab[];   // [table_rows][SLAB16]
  const int c0 = blockIdx.x * SLAB16;
  const int cw = min(SLAB16, w16 - c0);
  for (int i = threadIdx.x; i < table_rows * SLAB16; i += blockDim.x) {
    const int r = i / SLAB16, c = i % SLAB16;
    if (c < cw) slab[i] = __ldg(table + (size_t)r * w16 + c0 + c);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(n_rows, r_begin + rows_per_block);
  if (lane >= cw) return;
  for (int r = r_begin + warp; r < r_end; r += n_warps) {
    const int src = __ldg(idx + r);
    out[(size_t)r * w16 + c0 + lane] = slab[src * SLAB16 + lane];
  }
}

__global__ void __launch_bounds__(LANE_WARPS * 32)
lane_gather_kernel(const uint32_t* __restrict__ table,
                   const int* __restrict__ idx, uint32_t* __restrict__ out,
                   int n_rows, int width) {
  extern __shared__ uint32_t rows_s[];   // [LANE_WARPS][width]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * LANE_WARPS + warp;
  if (r >= n_rows) return;               // whole warps leave together
  uint32_t* row_s = rows_s + (size_t)warp * width;
  const size_t base = (size_t)r * width;
  for (int c = lane; c < width; c += 32) row_s[c] = __ldg(table + base + c);
  __syncwarp();
  for (int c = lane; c < width; c += 32)
    out[base + c] = row_s[__ldg(idx + base + c)];
}

}  // namespace

// table [table_rows, row_bytes], idx [n_rows] int32, out [n_rows,
// row_bytes]; row_bytes a multiple of 16, all pointers 16-byte aligned.
// grid_y: number of row groups (each block loads its slab once and walks
// ceil(n_rows / grid_y) rows).
extern "C" int tile_row_gather(const void* table, const int* idx, void* out,
                               int table_rows, int row_bytes, int n_rows,
                               int grid_y, void* stream) {
  const size_t smem = (size_t)table_rows * SLAB16 * sizeof(uint4);
  if (row_bytes <= 0 || row_bytes % 16 != 0 || table_rows <= 0 ||
      n_rows <= 0 || grid_y <= 0 || grid_y > 65535 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      row_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int w16 = row_bytes / 16;
  const int slabs = (w16 + SLAB16 - 1) / SLAB16;
  const int rows_per_block = (n_rows + grid_y - 1) / grid_y;
  row_gather_kernel<<<dim3(slabs, grid_y), ROW_THREADS, smem,
                      (cudaStream_t)stream>>>(
      (const uint4*)table, idx, (uint4*)out, table_rows, w16, n_rows,
      rows_per_block);
  return (int)cudaGetLastError();
}

// table, out [n_rows, width] of 4-byte words, idx [n_rows, width] int32.
extern "C" int tile_lane_gather(const void* table, const int* idx, void* out,
                                int n_rows, int width, void* stream) {
  const size_t smem = (size_t)LANE_WARPS * width * sizeof(uint32_t);
  if (n_rows <= 0 || width <= 0 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lane_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + LANE_WARPS - 1) / LANE_WARPS;
  lane_gather_kernel<<<blocks, LANE_WARPS * 32, smem,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)table, idx, (uint32_t*)out, n_rows, width);
  return (int)cudaGetLastError();
}
