// Shared device code of the stencil-head kernels (stencil_head_fwd.cu,
// stencil_head_bwd.cu).  See those files for what each kernel replaces.
//
// Layouts (same as the JAX package, tensoflow_tpu/ops/pallas_stencil.py):
//   pp[b*3+i]  [N, 16C]  plane patches, slot (du+1)*4+(dv+1), du,dv in [-1,2]
//   lp[b*3+i]  [N, 4C]   line patches, slot dx+1
//   fr         [N, 64]   f32 fraction/sigma lanes, branch b at 32b+ (see
//                        tensor_field.vm_patch_gather)
//   pe         [N, E]    centre-point PE (storage type T)
//   rot        [S, 4, E] f32 PE linear-combination table
//   w0big      [XW, H]   layer-0 weights in X-row order, zero pad rows
//   V          [N, VW]   saved tap variants: PV (i-major, pv) then LV
//
// Rounding: every [row, C]-wide elementwise op rounds to T (bf16 or f32)
// exactly as the plain PyTorch version (ops/stencil.py) does op by op;
// __fmul_rn/__fadd_rn keep nvcc from contracting them into FMAs.  The
// matrix products take T-rounded operands and accumulate in f32: on the
// tensor cores (mma.sync m16n8k16) for bf16, as FMAs for float32 (so a
// float32 kernel can be held to the plain version in float64).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace sh {

constexpr int TN = 8;      // rows per tile
constexpr int NT = 256;    // threads per block
constexpr int FS = 32;     // fr lanes per mip branch
constexpr int KC = 16;     // W0 rows staged in shared memory per chunk
constexpr int JMAX = 8;    // hidden columns per thread (H <= 256)

template <typename T> struct Cd;
template <> struct Cd<float> {
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ float ld(const float* p, size_t i) {
    return p[i];
  }
  static __device__ __forceinline__ void st(float* p, size_t i, float v) {
    p[i] = v;
  }
};
template <> struct Cd<__nv_bfloat16> {
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p,
                                             size_t i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, size_t i,
                                            float v) {
    p[i] = __float2bfloat16_rn(v);
  }
};

// one elementwise op in the working type T
template <typename T>
__device__ __forceinline__ float mul(float a, float b) {
  return Cd<T>::rnd(__fmul_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float add(float a, float b) {
  return Cd<T>::rnd(__fadd_rn(a, b));
}

// hat (linear B-spline) weight of patch slot k at shifted coordinate r
__device__ __forceinline__ float hat(float r, int k) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(r, (float)k))));
}

// stencil point s, plane i -> (plane variant, line variant); the 7-point
// order is [centre, +x, -x, +y, -y, +z, -z]; matMode ((0,1),(0,2),(1,2)),
// vecMode (2,1,0).
__device__ __forceinline__ void stencil_map(int s, int i, int* pv, int* lv) {
  *pv = 0;
  *lv = 0;
  if (s == 0) return;
  const int d = (s - 1) / 2;
  const bool pos = ((s - 1) % 2) == 0;
  const int ma = (i == 2) ? 1 : 0;
  const int mb = (i == 0) ? 1 : 2;
  const int vc = 2 - i;
  if (d == ma) *pv = pos ? 1 : 2;
  else if (d == mb) *pv = pos ? 3 : 4;
  else if (d == vc) *lv = pos ? 1 : 2;
}

struct Ptrs6 {
  const void* p[6];
};
struct MPtrs6 {
  void* p[6];
};

// Centre-point PE -> the S stencil-point PEs (trig addition, see
// tenso_sdf._pe_rot_table), written as X columns [3C, 3C+E) and the zero
// pad [3C+E, XW) for local row r.  pe already holds T-rounded values.
template <typename T, int S>
__device__ __forceinline__ void fill_pe(float* Xs, int r, int e, int C,
                                        int E, int XW, const T* pe,
                                        const float* rot, int row, int N) {
  float p0 = 0.f, pm3 = 0.f, pp3 = 0.f;
  if (row < N) {
    p0 = Cd<T>::ld(pe, (size_t)row * E + e);
    pm3 = Cd<T>::ld(pe, (size_t)row * E + (e + 3) % E);
    pp3 = Cd<T>::ld(pe, (size_t)row * E + (e + E - 3) % E);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float v = p0;
    if (s > 0) {
      const float* R = rot + (size_t)s * 4 * E;
      v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p0, R[e]),
                                        __fmul_rn(pm3, R[E + e])),
                              __fmul_rn(pp3, R[2 * E + e])),
                    R[3 * E + e]);
    }
    Xs[(s * TN + r) * XW + 3 * C + e] = Cd<T>::rnd(v);
  }
}

// The tile's S*TN rows (row s*TN + r: stencil point s of local row r),
// padded to whole 16-row tiles of the tensor-core path.
template <int S>
struct Rows {
  static constexpr int MT = (S * TN + 15) / 16;   // 16-row tiles
  static constexpr int MR = MT * 16;               // padded rows
  static constexpr int SP = 2 * MT;                // stencil slots held (>= S)
};

// Who holds which layer-0 output: every thread holds, for one local row
// and all stencil points, H/32 hidden columns c -> col(c).  float32 (FMA
// path): warp = row, lane + 32c = column.  bf16 (tensor-core path): the
// m16n8k16 accumulator layout, rows lane/4, warp w owning columns
// [w*H/8, (w+1)*H/8).  slot() numbers the 32 threads sharing a row.
template <typename T> struct Own;
template <> struct Own<float> {
  static __device__ __forceinline__ int row(int lane, int warp) {
    return warp;
  }
  static __device__ __forceinline__ int slot(int lane, int warp) {
    return lane;
  }
  static __device__ __forceinline__ int col(int c, int H, int lane,
                                            int warp) {
    return lane + 32 * c;
  }
};
template <> struct Own<__nv_bfloat16> {
  static __device__ __forceinline__ int row(int lane, int warp) {
    return lane >> 2;
  }
  static __device__ __forceinline__ int slot(int lane, int warp) {
    return warp * 4 + (lane & 3);
  }
  static __device__ __forceinline__ int col(int c, int H, int lane,
                                            int warp) {
    return 8 * (warp * (H / 64) + (c >> 1)) + 2 * (lane & 3) + (c & 1);
  }
};

// Two consecutive bf16 as one 32-bit register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg_pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// d += A.B on the tensor cores: A 16x16 (row), B 16x8 (col), bf16 in,
// f32 accumulate.
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [16mt, 16mt+16) and columns [k0, k0+16) of a
// row-major bf16 matrix in shared memory with row stride ld.
__device__ __forceinline__ void ld_a(uint32_t (&a)[4],
                                     const __nv_bfloat16* m, int ld, int mt,
                                     int k0, int lane) {
  const __nv_bfloat16* p = m + (16 * mt + (lane >> 2)) * ld + k0 +
                           2 * (lane & 3);
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// z = X.W0 + b0 for the tile's rows, held as Own<T> says: acc[s][c].
// float32: W0 staged KC rows at a time in W0c (stride WS), FMA.
// bf16: X copied to Xb (bf16, rows padded to Rows<S>::MR, stride XW+8),
// W0^T fragments read from w0t [H, XW] in device memory, mma.sync.
template <typename T, int S>
__device__ __forceinline__ void layer0(float (&acc)[Rows<S>::SP][JMAX],
                                       const float* Xs, __nv_bfloat16* Xb,
                                       float* W0c, int WS, const T* w0big,
                                       const T* w0t, const float* b0, int XW,
                                       int H, int lane, int warp, int tid) {
  const int JN = H / 32;
#pragma unroll
  for (int c = 0; c < JMAX; ++c) {
    const float b = (c < JN) ? b0[Own<T>::col(c, H, lane, warp)] : 0.f;
#pragma unroll
    for (int s = 0; s < Rows<S>::SP; ++s) acc[s][c] = b;
  }
  if constexpr (std::is_same<T, float>::value) {
    for (int k0 = 0; k0 < XW; k0 += KC) {
      __syncthreads();
      for (int idx = tid; idx < KC * H; idx += NT) {
        const int kk = idx / H, j = idx % H;
        W0c[kk * WS + j] = w0big[(size_t)(k0 + kk) * H + j];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float x[S];
#pragma unroll
        for (int s = 0; s < S; ++s) x[s] = Xs[(s * TN + warp) * XW + k0 + kk];
#pragma unroll
        for (int c = 0; c < JMAX; ++c) {
          if (c < JN) {
            const float w = W0c[kk * WS + lane + 32 * c];
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s][c] = fmaf(x[s], w, acc[s][c]);
          }
        }
      }
    }
  } else {
    constexpr int MT = Rows<S>::MT;
    const int XB = XW + 8;
    __syncthreads();                          // X is complete
    for (int idx = tid; idx < MT * 16 * XW; idx += NT) {
      const int row = idx / XW, k = idx % XW;
      Xb[row * XB + k] =
          __float2bfloat16_rn(row < S * TN ? Xs[row * XW + k] : 0.f);
    }
    __syncthreads();
    const int ntw = H / 64;                   // 8-column tiles per warp
    for (int k0 = 0; k0 < XW; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ld_a(a[mt], Xb, XB, mt, k0, lane);
#pragma unroll
      for (int nt = 0; nt < JMAX / 2; ++nt) {
        if (nt < ntw) {
          const T* bp = w0t + (size_t)(8 * (warp * ntw + nt) + (lane >> 2)) *
                                  XW + k0 + 2 * (lane & 3);
          const uint32_t b0r = ldg_pair(bp), b1r = ldg_pair(bp + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_bf16(acc[2 * mt][2 * nt], acc[2 * mt][2 * nt + 1],
                     acc[2 * mt + 1][2 * nt], acc[2 * mt + 1][2 * nt + 1],
                     a[mt], b0r, b1r);
        }
      }
    }
  }
}

}  // namespace sh
