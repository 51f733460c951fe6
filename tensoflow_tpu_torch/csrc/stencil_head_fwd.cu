// Stencil-head forward kernel for Hopper (sm_90a).
//
// Replaces: tensoflow_tpu/ops/pallas_stencil.py `_fwd_kernel` (built by
// `_build_fwd`, pallas_call at :354).  Per row it forms the hat-weight taps
// of 3 plane patches (4x4 texels) and 3 line patches (4 texels) for the
// 7-point FD stencil (factorised separable form of `_variants`), the
// plane*line products plus the stencil-point PEs as one X row, then
// z = X.W0 + b0, softplus(beta=100), and layer 1: the full head for the
// centre point, the sdf column only for the 6 offset points.  With a V
// pointer it also writes the tap variants for the backward.
//
// Bound on the H100: bytes.  Per row it must read 60C patch values plus
// fr/pe (~4.5 KB at C=36 in bf16) and write out_c, out_off and V (~2.3
// KB); its ~0.5 MFLOP per row sits far below the card's op:byte balance.
//
// Design (first, simple version): one block of 256 threads per tile of 8
// rows.  The tile's X [S*8, XW] is built in shared memory (f32 holding
// T-rounded values).  Layer 0 (see layer0 in stencil_common.cuh): for
// bf16, X as bf16 [64, XW] on the tensor cores, W0^T fragments read from
// device memory (L2-resident); for float32, FMAs with W0 staged 16 rows at
// a time.  Each thread then holds one row's z for all 7 stencil points and
// H/32 hidden columns.  The bf16 rounding points of the TPU kernel are
// kept op by op, so the kernel matches the plain PyTorch version up to the
// f32 summation order of the matrix products.  TMA, wgmma and a larger
// row tile (the per-tile phases and their barriers now take most of the
// time) are work for a later change.
#include "stencil_common.cuh"

using namespace sh;

template <typename T, int S, int B>
__global__ void __launch_bounds__(NT)
stencil_fwd_kernel(int N, int C, int E, int H, int O, int XW, Ptrs6 pp,
                   Ptrs6 lp, const float* __restrict__ fr,
                   const T* __restrict__ pe, const float* __restrict__ rot,
                   const T* __restrict__ w0big, const T* __restrict__ w0t,
                   const float* __restrict__ b0, const T* __restrict__ w1,
                   const T* __restrict__ w1row, float* __restrict__ out_c,
                   float* __restrict__ out_off, T* __restrict__ v_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NPV = (S > 1) ? 5 : 1;
  constexpr int NLV = (S > 1) ? 3 : 1;
  constexpr int GO = S > 1 ? S - 1 : 1;
  float* Xs = reinterpret_cast<float*>(smem_raw);   // [S*TN, XW]
  float* hc = Xs + S * TN * XW;              // [TN, H]
  float* red = hc + TN * H;                  // [GO, TN, 32]
  float* W0c = red + GO * TN * 32;           // float32: [KC, H]
  __nv_bfloat16* Xb = reinterpret_cast<__nv_bfloat16*>(W0c);  // bf16: X
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TN;
  const int VW = (NPV + NLV) * 3 * C;

  // ---- tap variants and the field columns of X ------------------------
  for (int idx = tid; idx < TN * C; idx += NT) {
    const int rr = idx / C, c = idx % C;
    const int row = row0 + rr;
    const bool ok = row < N;
    float PV[3][NPV], LV[3][NLV];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int v = 0; v < NPV; ++v) PV[i][v] = 0.f;
#pragma unroll
      for (int v = 0; v < NLV; ++v) LV[i][v] = 0.f;
    }
    if (ok) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float* f = fr + (size_t)row * 2 * FS + b * FS;
        const float wgt = f[9];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const T* P = (const T*)pp.p[b * 3 + i] + (size_t)row * 16 * C + c;
          float sl[16];
#pragma unroll
          for (int q = 0; q < 16; ++q) sl[q] = Cd<T>::ld(P, (size_t)q * C);
          const float fu = f[2 * i], fv = f[2 * i + 1];
          const float su = f[10 + 2 * i], sv = f[11 + 2 * i];
          const float wv0[2] = {Cd<T>::rnd(__fmul_rn(wgt, hat(fv, 0))),
                                Cd<T>::rnd(__fmul_rn(wgt, hat(fv, 1)))};
          // Rv[ku] = sum_kv wv0[kv] * slot(ku, kv)
          float rv[4];
#pragma unroll
          for (int ku = -1; ku <= 2; ++ku)
            rv[ku + 1] = add<T>(mul<T>(wv0[0], sl[(ku + 1) * 4 + 1]),
                                mul<T>(wv0[1], sl[(ku + 1) * 4 + 2]));
          float pv[NPV];
          pv[0] = add<T>(mul<T>(Cd<T>::rnd(hat(fu, 0)), rv[1]),
                         mul<T>(Cd<T>::rnd(hat(fu, 1)), rv[2]));
          if (S > 1) {
#pragma unroll
            for (int sg = 0; sg < 2; ++sg) {       // u+, u-
              const float ru_ = __fadd_rn(fu, sg == 0 ? su : -su);
              float acc = mul<T>(Cd<T>::rnd(hat(ru_, -1)), rv[0]);
#pragma unroll
              for (int ku = 0; ku <= 2; ++ku)
                acc = add<T>(acc, mul<T>(Cd<T>::rnd(hat(ru_, ku)),
                                         rv[ku + 1]));
              pv[1 + sg] = acc;
            }
            const float wu0[2] = {Cd<T>::rnd(__fmul_rn(wgt, hat(fu, 0))),
                                  Cd<T>::rnd(__fmul_rn(wgt, hat(fu, 1)))};
            float ru[4];
#pragma unroll
            for (int kv = -1; kv <= 2; ++kv)
              ru[kv + 1] = add<T>(mul<T>(wu0[0], sl[1 * 4 + kv + 1]),
                                  mul<T>(wu0[1], sl[2 * 4 + kv + 1]));
#pragma unroll
            for (int sg = 0; sg < 2; ++sg) {       // v+, v-
              const float rvv = __fadd_rn(fv, sg == 0 ? sv : -sv);
              float acc = mul<T>(Cd<T>::rnd(hat(rvv, -1)), ru[0]);
#pragma unroll
              for (int kv = 0; kv <= 2; ++kv)
                acc = add<T>(acc, mul<T>(Cd<T>::rnd(hat(rvv, kv)),
                                         ru[kv + 1]));
              pv[3 + sg] = acc;
            }
          }
#pragma unroll
          for (int v = 0; v < NPV; ++v)
            PV[i][v] = (b == 0) ? pv[v] : add<T>(PV[i][v], pv[v]);
          // line taps
          const T* L = (const T*)lp.p[b * 3 + i] + (size_t)row * 4 * C + c;
          float ls[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) ls[q] = Cd<T>::ld(L, (size_t)q * C);
          const float fx = f[6 + i], sx = f[16 + i];
          const float wgt_b = Cd<T>::rnd(wgt);
#pragma unroll
          for (int v = 0; v < NLV; ++v) {
            float tap;
            if (v == 0) {
              tap = add<T>(mul<T>(Cd<T>::rnd(hat(fx, 0)), ls[1]),
                           mul<T>(Cd<T>::rnd(hat(fx, 1)), ls[2]));
            } else {
              const float rx = __fadd_rn(fx, v == 1 ? sx : -sx);
              tap = mul<T>(Cd<T>::rnd(hat(rx, -1)), ls[0]);
#pragma unroll
              for (int k = 0; k <= 2; ++k)
                tap = add<T>(tap, mul<T>(Cd<T>::rnd(hat(rx, k)), ls[k + 1]));
            }
            const float t = mul<T>(wgt_b, tap);
            LV[i][v] = (b == 0) ? t : add<T>(LV[i][v], t);
          }
        }
      }
      if (v_out != nullptr) {
        T* Vr = v_out + (size_t)row * VW;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int v = 0; v < NPV; ++v)
            Cd<T>::st(Vr, (size_t)(i * NPV + v) * C + c, PV[i][v]);
#pragma unroll
          for (int v = 0; v < NLV; ++v)
            Cd<T>::st(Vr, (size_t)3 * NPV * C + (i * NLV + v) * C + c,
                      LV[i][v]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        int a, l;
        stencil_map(s, i, &a, &l);
        Xs[(s * TN + rr) * XW + i * C + c] = mul<T>(PV[i][a], LV[i][l]);
      }
    }
  }
  // ---- PE columns and zero pad of X -----------------------------------
  for (int idx = tid; idx < TN * E; idx += NT) {
    const int rr = idx / E, e = idx % E;
    fill_pe<T, S>(Xs, rr, e, C, E, XW, pe, rot, row0 + rr, N);
  }
  const int padw = XW - 3 * C - E;
  for (int idx = tid; idx < S * TN * padw; idx += NT)
    Xs[(idx / padw) * XW + 3 * C + E + idx % padw] = 0.f;

  // ---- layer 0 + softplus ---------------------------------------------
  float acc[Rows<S>::SP][JMAX];
  layer0<T, S>(acc, Xs, Xb, W0c, H, w0big, w0t, b0, XW, H, lane, warp, tid);
  const int JN = H / 32;
  const int rr = Own<T>::row(lane, warp), slot = Own<T>::slot(lane, warp);
  float part[GO];
#pragma unroll
  for (int s = 0; s < GO; ++s) part[s] = 0.f;
#pragma unroll
  for (int c = 0; c < JMAX; ++c) {
    if (c < JN) {
      const int col = Own<T>::col(c, H, lane, warp);
      const float w1r = (S > 1) ? Cd<T>::ld(w1row, col) : 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float zs = 100.f * acc[s][c];
        const float h = Cd<T>::rnd(
            (fmaxf(zs, 0.f) + log1pf(expf(-fabsf(zs)))) / 100.f);
        if (s == 0) hc[rr * H + col] = h;
        else part[s - 1] = fmaf(h, w1r, part[s - 1]);
      }
    }
  }
  // ---- offsets: sdf column only (32 partial sums per row, fixed order) --
  if (S > 1) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) red[(s * TN + rr) * 32 + slot] = part[s];
  }
  __syncthreads();
  if (S > 1) {
    for (int idx = tid; idx < (S - 1) * TN; idx += NT) {
      const int s = idx / TN, r = idx % TN;
      float sum = 0.f;
      for (int q = 0; q < 32; ++q) sum += red[idx * 32 + q];
      if (row0 + r < N) out_off[(size_t)s * N + row0 + r] = sum;
    }
  }
  // ---- centre: full layer 1 -------------------------------------------
  for (int idx = tid; idx < TN * O; idx += NT) {
    const int r = idx / O, o = idx % O;
    if (row0 + r >= N) continue;
    float sum = 0.f;
    for (int j = 0; j < H; ++j)
      sum = fmaf(hc[r * H + j], Cd<T>::ld(w1, (size_t)j * O + o), sum);
    out_c[(size_t)(row0 + r) * O + o] = sum;
  }
}

template <typename T, int S, int B>
static cudaError_t launch(int N, int C, int E, int H, int O, int XW,
                          const void* const* pp, const void* const* lp,
                          const float* fr, const void* pe, const float* rot,
                          const void* w0big, const void* w0t,
                          const float* b0, const void* w1, const void* w1row,
                          float* out_c, float* out_off, void* v_out,
                          cudaStream_t stream) {
  Ptrs6 P, L;
  for (int k = 0; k < 6; ++k) {
    P.p[k] = k < 3 * B ? pp[k] : nullptr;
    L.p[k] = k < 3 * B ? lp[k] : nullptr;
  }
  constexpr int GO = S > 1 ? S - 1 : 1;
  const size_t operand =                     // W0 chunks (FMA) or X in bf16
      std::is_same<T, float>::value
          ? sizeof(float) * KC * H
          : sizeof(__nv_bfloat16) * Rows<S>::MR * (XW + 8);
  const size_t smem =
      sizeof(float) * ((size_t)S * TN * XW + TN * H + GO * TN * 32) +
      operand;
  auto kern = stencil_fwd_kernel<T, S, B>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (N + TN - 1) / TN;
  kern<<<grid, NT, smem, stream>>>(
      N, C, E, H, O, XW, P, L, fr, (const T*)pe, rot, (const T*)w0big,
      (const T*)w0t, b0, (const T*)w1, (const T*)w1row, out_c, out_off,
      (T*)v_out);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int stencil_head_fwd(int dtype, int S, int B, int N, int C, int E,
                                int H, int O, int XW, const void* const* pp,
                                const void* const* lp, const float* fr,
                                const void* pe, const float* rot,
                                const void* w0big, const void* w0t,
                                const float* b0, const void* w1,
                                const void* w1row, float* out_c,
                                float* out_off, void* v_out, void* stream) {
  // the bf16 (tensor-core) path gives each warp H/8 columns in 8-wide tiles
  if (H % 32 != 0 || (dtype == 1 && H % 64 != 0) || H > 32 * JMAX ||
      XW % KC != 0 || 3 * C + E > XW || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SH_CASE(TT, SS, BB)                                                 \
  return (int)launch<TT, SS, BB>(N, C, E, H, O, XW, pp, lp, fr, pe, rot,    \
                                 w0big, w0t, b0, w1, w1row, out_c, out_off,  \
                                 v_out, st)
  if (dtype == 0) {
    if (S == 7 && B == 1) SH_CASE(float, 7, 1);
    if (S == 7 && B == 2) SH_CASE(float, 7, 2);
    if (S == 1 && B == 1) SH_CASE(float, 1, 1);
    if (S == 1 && B == 2) SH_CASE(float, 1, 2);
  } else if (dtype == 1) {
    if (S == 7 && B == 1) SH_CASE(__nv_bfloat16, 7, 1);
    if (S == 7 && B == 2) SH_CASE(__nv_bfloat16, 7, 2);
    if (S == 1 && B == 1) SH_CASE(__nv_bfloat16, 1, 1);
    if (S == 1 && B == 2) SH_CASE(__nv_bfloat16, 1, 2);
  }
#undef SH_CASE
  return (int)cudaErrorInvalidValue;
}
