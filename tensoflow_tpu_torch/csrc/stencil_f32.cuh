// Building blocks of the float32 stencil-head kernels (stencil_head_fwd.cu,
// stencil_head_bwd.cu): the widths they are built for, the row tile, the
// cp.async ring that streams the weights through shared memory, and the
// register-blocked FMA steps of their matrix products.
//
// Tile: 16 rows of the head's input x 7 stencil points = 112 X rows, row
// s*16 + r (S=1 uses rows 0..15 and leaves 16..111 as padding).  X is kept
// TRANSPOSED in shared memory, [k][m] with a row pitch of MS = 116 floats:
// a thread reads the 4 X rows of one k as one float4, and the tap threads
// (8 channels x 4 rows a warp) write it without bank conflicts.
//
// Weights: W0 [XF][HF], W0^T [HF][XF], W1 [HF][OF] and W1^T [OF][HF], zero
// padded (ops/stencil.py pack_weights_f32), stream through a ring of chunk
// slots filled by cp.async, one __syncthreads a chunk, the next chunk(s) in
// flight while this one is multiplied: the forward two slots of 24 rows,
// the backward and the weight-gradient product two of 32 (fewer, larger
// chunks measured faster than three of 16 where shared memory allows).  The
// chunk sequence repeats for every tile, so the ring runs on across tiles
// and a tile's first chunks arrive while its taps are computed.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace f32k {

constexpr int HF = 256;    // hidden width the kernels are built for (H <= HF)
constexpr int XF = 144;    // X row width: 3C+E < XF, column XF-1 is all ones
                           // in the backward's workspace (its dW0 row is db0)
constexpr int OF = 144;    // layer-1 width: O <= OF
constexpr int TR = 16;     // rows of the head's input per tile
constexpr int MT = 112;    // X rows per tile (7 stencil points x TR)
constexpr int MS = 116;    // row pitch of transposed X / dz / dX in smem
// the weight-gradient product's ring: AKC rows of both operands a chunk,
// ASTAGE slots
constexpr int AKC = 32, ASTAGE = 2;
// the most rows one split-K partial of a weight gradient sums: a float32
// chain of ~7,000 products (one split per SM at N = 131,072, S = 7) put
// the bias gradient, a column of ones in X, 1e-5 from float64
constexpr int AKMAX = 1024;
// the forward's ring: FKC rows of W0 a chunk (FKC / 2 of each half of W1),
// FSTAGE slots
constexpr int FKC = 24, FSTAGE = 2;

constexpr int FWD_NT = 448;    // 28 row groups x 16 column groups, 2 blocks/SM
constexpr int BWD_NT = 448;    // 28 row groups x 16 column groups, 1 block/SM
constexpr int ATB_NT = 288;    // 18 row groups x 16 column groups

// ring slot (floats) and shared memory (bytes) of each kernel
constexpr int FWD_SLOT = FKC * OF;           // W0 half FKCx128, W1 FKCx144
// the backward's ring: BKC weight rows a chunk (KH of W1^T), BSTAGE slots
constexpr int BKC = 32, KH = 16, BSTAGE = 2;
constexpr int BWD_SLOT = BKC * XF;           // W1^T KHx256, W0 BKCx128,
                                             // W0^T BKCx144
constexpr size_t SMEM_FWD =
    4 * ((size_t)XF * MS + FSTAGE * FWD_SLOT + (size_t)HF * TR);
constexpr size_t SMEM_BWD =
    4 * ((size_t)XF * MS + (size_t)128 * MS + BSTAGE * BWD_SLOT +
         (size_t)OF * TR + (size_t)TR * HF + 16 * (size_t)BWD_NT);
constexpr int ATB_SLOT = AKC * (XF + 128);   // A chunk AKCx144, B AKCx128
constexpr size_t SMEM_ATB = 4 * (size_t)ASTAGE * ATB_SLOT;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte asynchronous copy global -> shared; zero fill where !ok (src is
// then not read, but must still be a valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     bool ok = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[i][j] += A[k][ra(i)] * Bw[k][cb(j)] for k < kn (a multiple of 4):
// rows a0..a0+3 and a1..a1+3 of the transposed A (pitch lda), columns
// b0..b0+3 and b1..b1+3 of B (pitch ldb).  4 float4 loads a k, 64 FMAs.
__device__ __forceinline__ void fma_8x8(float (&acc)[8][8], const float* A,
                                        int lda, int a0, int a1,
                                        const float* Bw, int ldb, int b0,
                                        int b1, int kn) {
  for (int k4 = 0; k4 < kn; k4 += 4) {
#pragma unroll
    for (int kk = k4; kk < k4 + 4; ++kk) {
      const float4 x0 = ld4(A + kk * lda + a0), x1 = ld4(A + kk * lda + a1);
      const float4 w0 = ld4(Bw + kk * ldb + b0), w1 = ld4(Bw + kk * ldb + b1);
      const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float b[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][j] += A[k][a0 + i] * Bw[k][cb(j)], 4 rows x 8 columns (b0..b0+3,
// b1..b1+3), k < kn (a multiple of 4)
__device__ __forceinline__ void fma_4x8(float (&acc)[4][8], const float* A,
                                        int lda, int a0, const float* Bw,
                                        int ldb, int b0, int b1, int kn) {
  for (int k4 = 0; k4 < kn; k4 += 4) {
#pragma unroll
    for (int kk = k4; kk < k4 + 4; ++kk) {
      const float4 x = ld4(A + kk * lda + a0);
      const float4 w0 = ld4(Bw + kk * ldb + b0), w1 = ld4(Bw + kk * ldb + b1);
      const float a[4] = {x.x, x.y, x.z, x.w};
      const float b[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][j] += A[k][a0 + i] * Bw[k][b0 + j], 4x4, k < kn (multiple of 4)
__device__ __forceinline__ void fma_4x4(float (&acc)[4][4], const float* A,
                                        int lda, int a0, const float* Bw,
                                        int ldb, int b0, int kn) {
  for (int k4 = 0; k4 < kn; k4 += 4) {
#pragma unroll
    for (int kk = k4; kk < k4 + 4; ++kk) {
      const float4 x = ld4(A + kk * lda + a0), w = ld4(Bw + kk * ldb + b0);
      const float a[4] = {x.x, x.y, x.z, x.w}, b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][j] += A[k][a0 + i] * Bw[k][col j], 4 rows x 9 columns: b0..b0+3,
// b1..b1+3 and b2; KN k (a full chunk)
template <int KN>
__device__ __forceinline__ void fma_4x9(float (&acc)[4][9], const float* A,
                                        int lda, int a0, const float* Bw,
                                        int ldb, int b0, int b1, int b2) {
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    const float4 x = ld4(A + kk * lda + a0);
    const float4 w0 = ld4(Bw + kk * ldb + b0), w1 = ld4(Bw + kk * ldb + b1);
    const float a[4] = {x.x, x.y, x.z, x.w};
    const float b[9] = {w0.x, w0.y, w0.z, w0.w, w1.x,
                        w1.y, w1.z, w1.w, Bw[kk * ldb + b2]};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 9; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The tap threads: warp-sized groups of 32 (row, channel) items, 4 rows x
// 8 channels each, so that patch loads come in 32-byte segments and
// transposed X stores hit 32 distinct banks.  Group q of ceil(C/8) * 4.
__device__ __forceinline__ int tap_groups(int C) { return (C + 7) / 8 * 4; }
__device__ __forceinline__ void tap_item(int q, int lane, int* rr, int* c) {
  *rr = (q & 3) * 4 + (lane & 3);
  *c = (q >> 2) * 8 + (lane >> 2);
}

// The centre PE of one row and its rolls by -3 / +3 (zeros past N).
__device__ __forceinline__ void pe_row(const float* pe, int row, int N,
                                       int e, int E, float* p0, float* pm3,
                                       float* pp3) {
  *p0 = *pm3 = *pp3 = 0.f;
  if (row < N) {
    *p0 = pe[(size_t)row * E + e];
    *pm3 = pe[(size_t)row * E + (e + 3) % E];
    *pp3 = pe[(size_t)row * E + (e + E - 3) % E];
  }
}

// Blocks of a kernel that fit on one SM; its registers and local memory.
template <typename K>
inline int kernel_info(K kern, int nt, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, nt,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  out[3] = (int)smem;
  return 0;
}

}  // namespace f32k
