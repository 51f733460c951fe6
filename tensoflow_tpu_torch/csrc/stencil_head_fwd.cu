// Stencil-head forward kernels for Hopper (sm_90a).
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
// bf16 (stencil_fwd_bf16, the training path): one persistent block of two
// warpgroups per SM walks tiles of 128 X rows (16 rows x 7 stencil points
// + one 16-row pad group, row s*16 + r; 128 rows for S=1).  W0 and W1
// arrive once per block by bulk asynchronous copies (already in wgmma's
// operand layout, see stencil_sm90.cuh) and stay in shared memory.  A
// thread forms the taps of one (row, plane, 4 channels) from 8-byte
// loads, in packed bf16x2 arithmetic (two channels an instruction, each
// op rounded once to bf16), and writes its X values once, as bf16,
// straight into the operand layout.  z = X.W0 is one wgmma chain per
// warpgroup (m64 n256, 9 k-steps, accumulator started at b0); softplus
// runs on the accumulator fragment (special-function unit: ex2, lg2),
// whose bf16 pairs are at once the A fragments of layer 1 (m64 n144 from
// registers, 16 k-steps): column 0 of its result is the offset points'
// sdf, so all eight stencil groups share one instruction stream and h
// never touches shared memory.  Both weight matrices resident (147 KB)
// leave no room for a ring of patch stages beside X, so patches come
// through registers instead of bulk copies.
//
// float32 (stencil_fwd_f32): 8-row tiles, FMAs with W0 staged 16 rows at a
// time, no tensor cores: it is held to the plain version in float64.
// Both call the same tap arithmetic (stencil_common.cuh) and keep the TPU
// kernel's bf16 rounding points op by op.
//
// -DSH_SKIP_TAPS / -DSH_SKIP_SOFTPLUS leave a phase of the bf16 kernel out:
// wrong results, built only by bench/stencil_phases.py to time the rest.
#include "stencil_common.cuh"
#include "stencil_sm90.cuh"

using namespace sh;

// ---------------------------------------------------------------------------
// float32
// ---------------------------------------------------------------------------

template <int S, int B>
__global__ void __launch_bounds__(NT)
stencil_fwd_f32(int N, int C, int E, int H, int O, int XW, Ptrs6 pp,
                Ptrs6 lp, const float* __restrict__ fr,
                const float* __restrict__ pe, const float* __restrict__ rot,
                const float* __restrict__ w0big,
                const float* __restrict__ b0, const float* __restrict__ w1,
                const float* __restrict__ w1row, float* __restrict__ out_c,
                float* __restrict__ out_off, float* __restrict__ v_out) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
  constexpr int GO = S > 1 ? S - 1 : 1;
  float* Xs = reinterpret_cast<float*>(smem_raw);   // [S*TN, XW]
  float* hc = Xs + S * TN * XW;              // [TN, H]
  float* red = hc + TN * H;                  // [GO, TN, 32]
  float* W0c = red + GO * TN * 32;           // [KC, H]
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
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const Frac q = load_frac(f, i);
          const T* P = (const T*)pp.p[b * 3 + i] + (size_t)row * 16 * C + c;
          float sl[16], pv[NPV];
#pragma unroll
          for (int k = 0; k < 16; ++k) sl[k] = P[(size_t)k * C];
          plane_variants<F32, S>(sl, q, pv);
#pragma unroll
          for (int v = 0; v < NPV; ++v)
            PV[i][v] = (b == 0) ? pv[v] : F32::add(PV[i][v], pv[v]);
          const T* L = (const T*)lp.p[b * 3 + i] + (size_t)row * 4 * C + c;
          float ls[4], lv[NLV];
#pragma unroll
          for (int k = 0; k < 4; ++k) ls[k] = L[(size_t)k * C];
          line_variants<F32, S>(ls, q, lv);
#pragma unroll
          for (int v = 0; v < NLV; ++v)
            LV[i][v] = (b == 0) ? lv[v] : F32::add(LV[i][v], lv[v]);
        }
      }
      if (v_out != nullptr) {
        T* Vr = v_out + (size_t)row * VW;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int v = 0; v < NPV; ++v)
            Vr[(size_t)(i * NPV + v) * C + c] = PV[i][v];
#pragma unroll
          for (int v = 0; v < NLV; ++v)
            Vr[(size_t)3 * NPV * C + (i * NLV + v) * C + c] = LV[i][v];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float x[S];
      x_products<F32, S>(i, PV[i], LV[i], x);
#pragma unroll
      for (int s = 0; s < S; ++s) Xs[(s * TN + rr) * XW + i * C + c] = x[s];
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

  // ---- layer 0 + softplus: warp = row, lane + 32c = hidden column ------
  float acc[S][JMAX];
  layer0<S>(acc, Xs, W0c, H, w0big, b0, XW, H, lane, warp, tid);
  const int JN = H / 32;
  const int rr = warp;
  float part[GO];
#pragma unroll
  for (int s = 0; s < GO; ++s) part[s] = 0.f;
#pragma unroll
  for (int c = 0; c < JMAX; ++c) {
    if (c < JN) {
      const int col = lane + 32 * c;
      const float w1r = (S > 1) ? w1row[col] : 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float h, sig;
        softplus100(100.f * acc[s][c], &h, &sig);
        if (s == 0) hc[rr * H + col] = h;
        else part[s - 1] = fmaf(h, w1r, part[s - 1]);
      }
    }
  }
  // ---- offsets: sdf column only (32 partial sums per row, fixed order) --
  if (S > 1) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) red[(s * TN + rr) * 32 + lane] = part[s];
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
      sum = fmaf(hc[r * H + j], w1[(size_t)j * O + o], sum);
    out_c[(size_t)(row0 + r) * O + o] = sum;
  }
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr size_t FWD_SMEM = 2 * W_BYTES + X_BYTES + 16;

}  // namespace

template <int S, int B>
__global__ void __launch_bounds__(NTH, 1)
stencil_fwd_bf16(int N, int C, int E, int O, Ptrs6 pp, Ptrs6 lp,
                 const float* __restrict__ fr, const bf16* __restrict__ pe,
                 const float* __restrict__ rot,
                 const bf16* __restrict__ w0t, const float* __restrict__ b0,
                 const bf16* __restrict__ w1t, float* __restrict__ out_c,
                 float* __restrict__ out_off, bf16* __restrict__ v_out) {
  using T = bf16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
  constexpr int TNB = Tile<S>::ROWS;
  unsigned char* W0s = smem_raw;             // tiled [XP, HP]
  unsigned char* W1s = W0s + W_BYTES;        // tiled [OP, HP]
  unsigned char* Xs = W1s + W_BYTES;         // tiled [MR, XP]
  uint64_t* bar = reinterpret_cast<uint64_t*>(Xs + X_BYTES);
  const int tid = threadIdx.x;
  const int lane = tid & 31, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int VW = (NPV + NLV) * 3 * C;
  const int CG = C / 4;
  const int n_tiles = (N + TNB - 1) / TNB;

  if (tid == 0) mbar_init(bar, 1);
  // pad rows and pad columns of X stay zero for the block's life
  for (int idx = tid; idx < X_BYTES / 16; idx += NTH)
    reinterpret_cast<uint4*>(Xs)[idx] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar, 2 * W_BYTES);
    bulk_load(W0s, w0t, W_BYTES, bar);
    bulk_load(W1s, w1t, W_BYTES, bar);
  }
  bool weights_here = false;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TNB;
    __syncthreads();                 // both warpgroups have read the last X
#ifndef SH_SKIP_TAPS
    // ---- taps: one (row, plane, 4 channels = 2 packed pairs) per thread --
    for (int idx = tid; idx < TNB * 3 * CG; idx += NTH) {
      const int rr = idx / (3 * CG), rem = idx % (3 * CG);
      const int i = rem / CG, c0 = 4 * (rem % CG);
      const int row = row0 + rr;
      const bool ok = row < N;
      V2 PV[2][NPV], LV[2][NLV];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        Frac q = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        uint2 pu[16], lu[4];
#pragma unroll
        for (int k = 0; k < 16; ++k) pu[k] = make_uint2(0, 0);
#pragma unroll
        for (int k = 0; k < 4; ++k) lu[k] = make_uint2(0, 0);
        if (ok) {
          q = load_frac(fr + (size_t)row * 2 * FS + b * FS, i);
          const T* P = (const T*)pp.p[b * 3 + i] + (size_t)row * 16 * C + c0;
          const T* L = (const T*)lp.p[b * 3 + i] + (size_t)row * 4 * C + c0;
#pragma unroll
          for (int k = 0; k < 16; ++k)
            pu[k] = __ldg(reinterpret_cast<const uint2*>(P + k * C));
#pragma unroll
          for (int k = 0; k < 4; ++k)
            lu[k] = __ldg(reinterpret_cast<const uint2*>(L + k * C));
        }
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          V2 sl[16], ls[4], pv[NPV], lv[NLV];
#pragma unroll
          for (int k = 0; k < 16; ++k) sl[k] = as_pair(pr ? pu[k].y : pu[k].x);
#pragma unroll
          for (int k = 0; k < 4; ++k) ls[k] = as_pair(pr ? lu[k].y : lu[k].x);
          plane_variants<Bf2, S>(sl, q, pv);
          line_variants<Bf2, S>(ls, q, lv);
#pragma unroll
          for (int v = 0; v < NPV; ++v)
            PV[pr][v] = (b == 0) ? pv[v] : Bf2::add(PV[pr][v], pv[v]);
#pragma unroll
          for (int v = 0; v < NLV; ++v)
            LV[pr][v] = (b == 0) ? lv[v] : Bf2::add(LV[pr][v], lv[v]);
        }
      }
      if (ok && v_out != nullptr) {
        T* Vr = v_out + (size_t)row * VW + c0;
#pragma unroll
        for (int v = 0; v < NPV; ++v)
          *reinterpret_cast<uint2*>(Vr + (i * NPV + v) * C) =
              make_uint2(as_u32(PV[0][v]), as_u32(PV[1][v]));
#pragma unroll
        for (int v = 0; v < NLV; ++v)
          *reinterpret_cast<uint2*>(Vr + 3 * NPV * C + (i * NLV + v) * C) =
              make_uint2(as_u32(LV[0][v]), as_u32(LV[1][v]));
      }
      V2 x[2][S];
      x_products<Bf2, S>(i, PV[0], LV[0], x[0]);
      x_products<Bf2, S>(i, PV[1], LV[1], x[1]);
#pragma unroll
      for (int s = 0; s < S; ++s)
        *reinterpret_cast<uint2*>(Xs + tiled(s * TNB + rr, i * C + c0, XP)) =
            make_uint2(as_u32(x[0][s]), as_u32(x[1][s]));
    }
    // ---- PE columns of X ------------------------------------------------
    for (int idx = tid; idx < TNB * E; idx += NTH) {
      const int rr = idx / E, e = idx % E;
      const int row = row0 + rr;
      float p0 = 0.f, pm3 = 0.f, pp3 = 0.f;
      if (row < N) {
        p0 = Cd<T>::ld(pe, (size_t)row * E + e);
        pm3 = Cd<T>::ld(pe, (size_t)row * E + (e + 3) % E);
        pp3 = Cd<T>::ld(pe, (size_t)row * E + (e + E - 3) % E);
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
        *reinterpret_cast<T*>(Xs + tiled(s * TNB + rr, 3 * C + e, XP)) =
            __float2bfloat16_rn(pe_point<T>(s, e, E, p0, pm3, pp3, rot));
    }
#endif  // SH_SKIP_TAPS
    fence_async();
    __syncthreads();
    if (!weights_here) {
      mbar_wait(bar, 0);
      weights_here = true;
    }
    __syncwarp();

    // ---- z = X.W0 + b0: m64 n256 per warpgroup ------------------------
    float acc[HP / 2];
#pragma unroll
    for (int j = 0; j < HP / 8; ++j) {
      const float2 bb =
          __ldg(reinterpret_cast<const float2*>(b0 + 8 * j + 2 * (lane & 3)));
      acc[4 * j] = acc[4 * j + 2] = bb.x;
      acc[4 * j + 1] = acc[4 * j + 3] = bb.y;
    }
    {
      const uint64_t da =
          make_desc(smem_u32(Xs) + wg * 8 * XP * 16, 128, XP * 16);
      const uint64_t db = make_desc(smem_u32(W0s), HP * 16, 128);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < XP / 16; ++k)
        wgmma_ss_n256<0, 1>(acc, desc_add(da, 256 * k),
                            desc_add(db, 2 * HP * 16 * k));
      wgmma_commit();
      wgmma_wait();
    }
    // ---- softplus on the fragment -> A fragments of layer 1 -----------
    uint32_t hp[HP / 4];
#pragma unroll
    for (int k = 0; k < HP / 4; ++k) {
      float h0 = acc[2 * k], h1 = acc[2 * k + 1];
#ifndef SH_SKIP_SOFTPLUS
      float sig;
      softplus100_fast(100.f * acc[2 * k], &h0, &sig);
      softplus100_fast(100.f * acc[2 * k + 1], &h1, &sig);
#endif
      hp[k] = pack_bf16(h0, h1);
    }
    float o1[OP / 2];
#pragma unroll
    for (int k = 0; k < OP / 2; ++k) o1[k] = 0.f;
    {
      const uint64_t d1 = make_desc(smem_u32(W1s), 128, HP * 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HP / 16; ++k)
        wgmma_rs_n144<0>(o1, &hp[4 * k], desc_add(d1, 256 * k));
      wgmma_commit();
      wgmma_wait();
    }
    // ---- outputs ---------------------------------------------------------
    const int m = 64 * wg + 16 * warp + (lane >> 2);   // X row; and m + 8
    const int s = (S > 1) ? m / TNB : 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + (m + 8 * half) % TNB;
      if (row >= N) continue;
      if (s == 0) {
#pragma unroll
        for (int j = 0; j < OP / 8; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          if (col < O) out_c[(size_t)row * O + col] = o1[4 * j + 2 * half];
          if (col + 1 < O)
            out_c[(size_t)row * O + col + 1] = o1[4 * j + 2 * half + 1];
        }
      } else if (s < S && (lane & 3) == 0) {
        out_off[(size_t)(s - 1) * N + row] = o1[2 * half];
      }
    }
  }
  if (!weights_here) mbar_wait(bar, 0);      // never leave a copy in flight
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int S, int B>
static cudaError_t launch_f32(int N, int C, int E, int H, int O, int XW,
                              const Ptrs6& P, const Ptrs6& L, const float* fr,
                              const void* pe, const float* rot,
                              const void* w0, const float* b0, const void* w1,
                              const void* w1row, float* out_c, float* out_off,
                              void* v_out, cudaStream_t stream) {
  constexpr int GO = S > 1 ? S - 1 : 1;
  const size_t smem = sizeof(float) * ((size_t)S * TN * XW + TN * H +
                                       GO * TN * 32 + KC * H);
  auto kern = stencil_fwd_f32<S, B>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(N + TN - 1) / TN, NT, smem, stream>>>(
      N, C, E, H, O, XW, P, L, fr, (const float*)pe, rot, (const float*)w0,
      b0, (const float*)w1, (const float*)w1row, out_c, out_off,
      (float*)v_out);
  return cudaGetLastError();
}

template <int S, int B>
static cudaError_t launch_bf16(int n_sm, int N, int C, int E, int O,
                               const Ptrs6& P, const Ptrs6& L,
                               const float* fr, const void* pe,
                               const float* rot, const void* w0,
                               const float* b0, const void* w1, float* out_c,
                               float* out_off, void* v_out,
                               cudaStream_t stream) {
  constexpr int TNB = Tile<S>::ROWS;
  auto kern = stencil_fwd_bf16<S, B>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + TNB - 1) / TNB;
  kern<<<n_tiles < n_sm ? n_tiles : n_sm, sm90::NTH, FWD_SMEM, stream>>>(
      N, C, E, O, P, L, fr, (const bf16*)pe, rot, (const bf16*)w0, b0,
      (const bf16*)w1, out_c, out_off, (bf16*)v_out);
  return cudaGetLastError();
}

// dtype 0 = float32: w0 [XW, H] with zero pad rows, b0 [H], w1 [H, O],
// w1row [H] (column 0 of w1).  dtype 1 = bfloat16: w0 and w1 are the
// padded, tiled operands of ops/stencil.py pack_weights_bf16 ([XP, HP] and
// [OP, HP] of W1^T), b0 [HP] zero padded, w1row unused; XW and H are
// checked against the built widths.  Returns a cudaError_t (0 = success).
extern "C" int stencil_head_fwd(int dtype, int S, int B, int n_sm, int N,
                                int C, int E, int H, int O, int XW,
                                const void* const* pp, const void* const* lp,
                                const float* fr, const void* pe,
                                const float* rot, const void* w0,
                                const float* b0, const void* w1,
                                const void* w1row, float* out_c,
                                float* out_off, void* v_out, void* stream) {
  if (N <= 0 || n_sm <= 0 || (B != 1 && B != 2))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && (H % 32 != 0 || H > 32 * JMAX || XW % KC != 0 ||
                     3 * C + E > XW))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (C % 4 != 0 || 3 * C + E >= sm90::XP || H > sm90::HP ||
                     O > sm90::OP || XW != sm90::XP))
    return (int)cudaErrorInvalidValue;
  Ptrs6 P, L;
  for (int k = 0; k < 6; ++k) {
    P.p[k] = k < 3 * B ? pp[k] : nullptr;
    L.p[k] = k < 3 * B ? lp[k] : nullptr;
  }
  cudaStream_t st = (cudaStream_t)stream;
#define SH_CASE(SS, BB)                                                      \
  if (S == SS && B == BB)                                                    \
    return (int)(dtype == 0                                                  \
                     ? launch_f32<SS, BB>(N, C, E, H, O, XW, P, L, fr, pe,   \
                                          rot, w0, b0, w1, w1row, out_c,     \
                                          out_off, v_out, st)                \
                     : launch_bf16<SS, BB>(n_sm, N, C, E, O, P, L, fr, pe,   \
                                           rot, w0, b0, w1, out_c, out_off,  \
                                           v_out, st))
  if (dtype == 0 || dtype == 1) {
    SH_CASE(7, 1);
    SH_CASE(7, 2);
    SH_CASE(1, 1);
    SH_CASE(1, 2);
  }
#undef SH_CASE
  return (int)cudaErrorInvalidValue;
}
