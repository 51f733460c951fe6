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
//   V          [N, VW]   saved tap variants: PV (i-major, pv) then LV
//
// Rounding: every [row, C]-wide elementwise op rounds to T (bf16 or f32)
// as the plain PyTorch version (ops/stencil.py) does op by op (see the
// arithmetic policies below); the _rn intrinsics keep nvcc from
// contracting a multiply and an add into an FMA.  The
// matrix products take T-rounded operands and accumulate in f32: on the
// tensor cores (wgmma, stencil_sm90.cuh) for bf16, as register-blocked
// FMAs for float32 (stencil_f32.cuh; so a float32 kernel can be held to
// the plain version in float64).
//
// The tap arithmetic lives here once (plane_variants .. route_line),
// written over an arithmetic policy (F32, Bf2 below): the float32 kernels
// (112-row tiles, one channel per thread) and the bf16 kernels (128-row
// tiles, four channels = two packed pairs per thread) both call it.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sh {

constexpr int FS = 32;     // fr lanes per mip branch

// storage type T <-> float: load, and round as a store would
template <typename T> struct Cd;
template <> struct Cd<float> {
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ float ld(const float* p, size_t i) {
    return p[i];
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
};

// Arithmetic of the [row, C]-wide elementwise ops: values V, each op
// rounded to the working type.  w() makes a per-row weight (an f32
// scalar) a V.  F32: one float32 channel.  Bf2: two bf16 channels in one
// register, packed multiplies and adds that round once to bf16: the
// product of two bf16 is exact in f32, so mul equals "f32 op, then round";
// add rounds the exact sum once where "f32 add, then round" rounds twice,
// one bf16 ulp apart on rare ties, inside the kernels' tolerance.  The
// _rn forms keep nvcc from contracting a mul and an add into an fma.
struct F32 {
  using V = float;
  static __device__ __forceinline__ V w(float x) { return x; }
  static __device__ __forceinline__ V zero() { return 0.f; }
  static __device__ __forceinline__ V mul(V a, V b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ V add(V a, V b) { return __fadd_rn(a, b); }
};
struct Bf2 {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ V w(float x) {
    return __float2bfloat162_rn(x);
  }
  static __device__ __forceinline__ V zero() {
    return __float2bfloat162_rn(0.f);
  }
  static __device__ __forceinline__ V mul(V a, V b) { return __hmul2_rn(a, b); }
  static __device__ __forceinline__ V add(V a, V b) { return __hadd2_rn(a, b); }
};

template <typename A> using Val = typename A::V;

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

template <int S> struct Var {
  static constexpr int NPV = (S > 1) ? 5 : 1;   // plane tap variants
  static constexpr int NLV = (S > 1) ? 3 : 1;   // line tap variants
};

// The fr lanes of one row, mip branch and plane.
struct Frac {
  float wgt, fu, fv, su, sv, fx, sx;
};
__device__ __forceinline__ Frac load_frac(const float* f, int i) {
  Frac q;
  q.wgt = f[9];
  q.fu = f[2 * i];
  q.fv = f[2 * i + 1];
  q.su = f[10 + 2 * i];
  q.sv = f[11 + 2 * i];
  q.fx = f[6 + i];
  q.sx = f[16 + i];
  return q;
}

// Plane tap variants of one channel from its 16 patch slots sl: centre,
// u+, u-, v+, v- (factorised separable form of `_variants`).
template <typename A, int S>
__device__ __forceinline__ void plane_variants(const Val<A> (&sl)[16],
                                               const Frac& q,
                                               Val<A> (&pv)[Var<S>::NPV]) {
  const Val<A> wv0[2] = {A::w(__fmul_rn(q.wgt, hat(q.fv, 0))),
                         A::w(__fmul_rn(q.wgt, hat(q.fv, 1)))};
  // Rv[ku] = sum_kv wv0[kv] * slot(ku, kv)
  Val<A> rv[4];
#pragma unroll
  for (int ku = -1; ku <= 2; ++ku)
    rv[ku + 1] = A::add(A::mul(wv0[0], sl[(ku + 1) * 4 + 1]),
                        A::mul(wv0[1], sl[(ku + 1) * 4 + 2]));
  pv[0] = A::add(A::mul(A::w(hat(q.fu, 0)), rv[1]),
                 A::mul(A::w(hat(q.fu, 1)), rv[2]));
  if constexpr (S > 1) {
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {       // u+, u-
      const float ru_ = __fadd_rn(q.fu, sg == 0 ? q.su : -q.su);
      Val<A> acc = A::mul(A::w(hat(ru_, -1)), rv[0]);
#pragma unroll
      for (int ku = 0; ku <= 2; ++ku)
        acc = A::add(acc, A::mul(A::w(hat(ru_, ku)), rv[ku + 1]));
      pv[1 + sg] = acc;
    }
    const Val<A> wu0[2] = {A::w(__fmul_rn(q.wgt, hat(q.fu, 0))),
                           A::w(__fmul_rn(q.wgt, hat(q.fu, 1)))};
    Val<A> ru[4];
#pragma unroll
    for (int kv = -1; kv <= 2; ++kv)
      ru[kv + 1] = A::add(A::mul(wu0[0], sl[1 * 4 + kv + 1]),
                          A::mul(wu0[1], sl[2 * 4 + kv + 1]));
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {       // v+, v-
      const float rvv = __fadd_rn(q.fv, sg == 0 ? q.sv : -q.sv);
      Val<A> acc = A::mul(A::w(hat(rvv, -1)), ru[0]);
#pragma unroll
      for (int kv = 0; kv <= 2; ++kv)
        acc = A::add(acc, A::mul(A::w(hat(rvv, kv)), ru[kv + 1]));
      pv[3 + sg] = acc;
    }
  }
}

// Line tap variants of one channel from its 4 line slots: centre, +, -.
template <typename A, int S>
__device__ __forceinline__ void line_variants(const Val<A> (&ls)[4],
                                              const Frac& q,
                                              Val<A> (&lv)[Var<S>::NLV]) {
  const Val<A> wgt_b = A::w(q.wgt);
#pragma unroll
  for (int v = 0; v < Var<S>::NLV; ++v) {
    Val<A> tap;
    if (v == 0) {
      tap = A::add(A::mul(A::w(hat(q.fx, 0)), ls[1]),
                   A::mul(A::w(hat(q.fx, 1)), ls[2]));
    } else {
      const float rx = __fadd_rn(q.fx, v == 1 ? q.sx : -q.sx);
      tap = A::mul(A::w(hat(rx, -1)), ls[0]);
#pragma unroll
      for (int k = 0; k <= 2; ++k)
        tap = A::add(tap, A::mul(A::w(hat(rx, k)), ls[k + 1]));
    }
    lv[v] = A::mul(wgt_b, tap);
  }
}

// X columns of plane i for the S stencil points: variant products.
template <typename A, int S>
__device__ __forceinline__ void x_products(int i,
                                           const Val<A> (&pv)[Var<S>::NPV],
                                           const Val<A> (&lv)[Var<S>::NLV],
                                           Val<A> (&x)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    int a, l;
    stencil_map(s, i, &a, &l);
    x[s] = A::mul(pv[a], lv[l]);
  }
}

// Product rule: the variant cotangents of plane i from dX (dx[s], already
// rounded to the working type).
template <typename A, int S>
__device__ __forceinline__ void product_rule(int i, const Val<A> (&dx)[S],
                                             const Val<A> (&pv)[Var<S>::NPV],
                                             const Val<A> (&lv)[Var<S>::NLV],
                                             Val<A> (&dPV)[Var<S>::NPV],
                                             Val<A> (&dLV)[Var<S>::NLV]) {
#pragma unroll
  for (int v = 0; v < Var<S>::NPV; ++v) dPV[v] = A::zero();
#pragma unroll
  for (int v = 0; v < Var<S>::NLV; ++v) dLV[v] = A::zero();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    int a, l;
    stencil_map(s, i, &a, &l);
    const Val<A> dxi = dx[s];
    dPV[a] = A::add(dPV[a], A::mul(dxi, lv[l]));
    dLV[l] = A::add(dLV[l], A::mul(dxi, pv[a]));
  }
}

// Transposed hat weights: plane variant cotangents -> the 16 patch slots.
template <typename A, int S>
__device__ __forceinline__ void route_plane(const Val<A> (&dPV)[Var<S>::NPV],
                                            const Frac& q, Val<A> (&g)[16]) {
  const Val<A> wv0[2] = {A::w(__fmul_rn(q.wgt, hat(q.fv, 0))),
                         A::w(__fmul_rn(q.wgt, hat(q.fv, 1)))};
  const Val<A> wu0[2] = {A::w(__fmul_rn(q.wgt, hat(q.fu, 0))),
                         A::w(__fmul_rn(q.wgt, hat(q.fu, 1)))};
  // dRv[ku]: centre and u-shifted variants (shared centre-v weights)
  Val<A> drv[4] = {A::zero(), A::zero(), A::zero(), A::zero()};
  drv[1] = A::mul(A::w(hat(q.fu, 0)), dPV[0]);
  drv[2] = A::mul(A::w(hat(q.fu, 1)), dPV[0]);
  Val<A> dru[4] = {A::zero(), A::zero(), A::zero(), A::zero()};
  if constexpr (S > 1) {
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {
      const float ru_ = __fadd_rn(q.fu, sg == 0 ? q.su : -q.su);
#pragma unroll
      for (int ku = -1; ku <= 2; ++ku)
        drv[ku + 1] = A::add(drv[ku + 1],
                             A::mul(A::w(hat(ru_, ku)), dPV[1 + sg]));
    }
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {
      const float rvv = __fadd_rn(q.fv, sg == 0 ? q.sv : -q.sv);
#pragma unroll
      for (int kv = -1; kv <= 2; ++kv)
        dru[kv + 1] = A::add(dru[kv + 1],
                             A::mul(A::w(hat(rvv, kv)), dPV[3 + sg]));
    }
  }
#pragma unroll
  for (int ku = -1; ku <= 2; ++ku) {
#pragma unroll
    for (int kv = -1; kv <= 2; ++kv) {
      Val<A> v = A::zero();
      if (kv == 0 || kv == 1) v = A::mul(wv0[kv == 1 ? 1 : 0], drv[ku + 1]);
      if (S > 1 && (ku == 0 || ku == 1))
        v = A::add(v, A::mul(wu0[ku == 1 ? 1 : 0], dru[kv + 1]));
      g[(ku + 1) * 4 + kv + 1] = v;
    }
  }
}

// The same for the line variants -> the 4 line slots.
template <typename A, int S>
__device__ __forceinline__ void route_line(const Val<A> (&dLV)[Var<S>::NLV],
                                           const Frac& q,
                                           Val<A> (&dline)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) dline[k] = A::zero();
  const Val<A> wgt_b = A::w(q.wgt);
#pragma unroll
  for (int v = 0; v < Var<S>::NLV; ++v) {
    const Val<A> g = A::mul(wgt_b, dLV[v]);
    if (v == 0) {
      dline[1] = A::add(dline[1], A::mul(A::w(hat(q.fx, 0)), g));
      dline[2] = A::add(dline[2], A::mul(A::w(hat(q.fx, 1)), g));
    } else {
      const float rx = __fadd_rn(q.fx, v == 1 ? q.sx : -q.sx);
#pragma unroll
      for (int k = -1; k <= 2; ++k)
        dline[k + 1] = A::add(dline[k + 1],
                              A::mul(A::w(hat(rx, k)), g));
    }
  }
}

// PE of stencil point s from the centre PE p0 and its rolls by -3 / +3
// (trig addition, see tenso_sdf._pe_rot_table), rounded to T.
template <typename T>
__device__ __forceinline__ float pe_point(int s, int e, int E, float p0,
                                          float pm3, float pp3,
                                          const float* rot) {
  if (s == 0) return Cd<T>::rnd(p0);
  const float* R = rot + (size_t)s * 4 * E;
  return Cd<T>::rnd(__fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(p0, R[e]), __fmul_rn(pm3, R[E + e])),
                __fmul_rn(pp3, R[2 * E + e])),
      R[3 * E + e]));
}

// softplus(beta=100) of z = zs / 100 and its derivative, in float32:
// e = exp(-|zs|) and log(1 + e) from the special-function unit (ex2, lg2;
// absolute error ~4e-7 on log(1 + e), i.e. ~4e-9 on h), the quotients as
// a product with 0.01f and a correctly rounded reciprocal.  IEEE divisions
// cost several times more and take a slow path on denormal operands (e is
// one for zs < -87), so their time depended on the data; measured on an
// NVIDIA H100 80GB HBM3 at 700 W, this form took 0.15-0.25 ms less a call
// than expf / log1pf at N=131,072 (bench/stencil_phases.py), with the same
// error against float64.  At zs == 0 the slope is exactly 1/2.
__device__ __forceinline__ void softplus100(float zs, float* h, float* sig) {
  const float e = __expf(-fabsf(zs));
  const float r = __frcp_rn(1.f + e);
  *h = (fmaxf(zs, 0.f) + __logf(1.f + e)) * 0.01f;
  *sig = zs >= 0.f ? r : e * r;
}
// The same from the special-function unit (ex2, lg2, rcp: relative error
// ~1e-6 before the result is rounded to bf16, which keeps 8 bits).
__device__ __forceinline__ void softplus100_fast(float zs, float* h,
                                                 float* sig) {
  const float e = __expf(-fabsf(zs));
  *h = (fmaxf(zs, 0.f) + __logf(1.f + e)) * 0.01f;
  *sig = __fdividef(zs >= 0.f ? 1.f : e, 1.f + e);
}

}  // namespace sh
