// Stencil-head backward kernels for Hopper (sm_90a).
//
// Replaces: tensoflow_tpu/ops/pallas_stencil.py `_bwd_kernel` (built by
// `_build_bwd`, pallas_call at :577).  From the saved tap variants V it
// rebuilds X and z, backpropagates through softplus(beta=100) and both
// layers, and sends the variant cotangents through the product rule and
// the transposed hat weights to the patch cotangents dP [N,16C] and
// dL [N,4C], plus dpe [N,E].  It also sums dW0, db0, dW1 and the
// offset-point sdf-column gradient dw1row over all rows.  The scatter-add
// of dP/dL into the atlas (the VJP of the row gather) stays outside.
//
// Bound on the H100: bytes.  Per row it must read V, fr, pe and the
// output cotangents and write dP, dL and dpe (~7 KB at C=36 in bf16);
// its ~1.5 MFLOP per row sits below the card's op:byte balance.
//
// Cross-tile sums: the TPU kernel carries the weight gradients in
// resident outputs across a SEQUENTIAL grid.  Hopper blocks run in no
// order, so the sums over rows are taken in deterministic steps (no
// atomics; against the plain version only the f32 summation order
// differs): a row kernel that leaves X, dz, the centre h and the rounded
// centre cotangent in a workspace, products over that workspace with one
// partial per block, and fixed-order column sums of the partials.
//
// bf16 (the training path):
//   1. stencil_bwd_rows_bf16 — one persistent block of two warpgroups per
//      SM walks tiles of 128 X rows (row s*16 + r, as the forward).  W0
//      and W1 arrive once per block by bulk copies, in wgmma's operand
//      layout (stencil_sm90.cuh); the one copy of W0 serves z = X.W0
//      (MN-major view) and dX = dz.W0^T (K-major view), W1 serves
//      dh = g.W1^T.  X is written once as bf16 in operand layout and
//      leaves for the workspace as one bulk store; its last column is
//      all ones, so that db0 falls out of the dW0 product.  softplus' and
//      dz run on the accumulator fragment; dz goes to the workspace in
//      operand layout with 128-byte coalesced stores and, packed, is the
//      A fragment of dX (m64 n144 from registers).  dX returns through
//      shared memory to the (row, plane, 4 channels) threads that apply
//      the product rule and route to dP / dL with 8-byte stores.
//   2. stencil_bwd_atb_bf16 — dW0^T = dz^T.X and dW1 = h^T.g over the
//      workspace: four warpgroups (m64 n144 each), tiles read back by bulk
//      copies into a two-stage ring as MN-major operands, one partial per
//      block.  The weight gradients are not kept in the row kernel's
//      registers: 256 x 144 f32 beside the z and dX fragments does not
//      fit 64K registers.
//   3. stencil_bwd_colsum — fixed-order sums of the partials.
// float32: 8-row tiles, FMA products (stencil_bwd_rows_f32,
// stencil_bwd_atb_f32), held to the plain version in float64.
// Both paths call the same tap arithmetic (stencil_common.cuh) and keep
// the TPU kernel's bf16 rounding points op by op.
//
// -DSH_SKIP_TAPS / -DSH_SKIP_SOFTPLUS / -DSH_SKIP_WORKSPACE leave a phase of
// the bf16 row kernel out: wrong results, built only by
// bench/stencil_phases.py to time the rest.
#include "stencil_common.cuh"
#include "stencil_sm90.cuh"

using namespace sh;

namespace {

constexpr int JC = 32;     // hidden columns of W0^T staged per chunk (dX)
constexpr int KMAX = 6;    // X columns per lane in dX (XW <= 192)
constexpr int BM = 64, BN = 64, BK = 16;   // split-K product tiles (FMA)
constexpr int NSPLIT = 64;                  // K chunks of the products

__host__ __device__ inline int wc_floats(int H, int XW) {
  const int a = KC * (H + 1), b = JC * (XW + 1);
  return a > b ? a : b;
}

template <int S>
__host__ __device__ inline size_t rows_smem_f32(int C, int H, int O, int XW) {
  const int VW = (Var<S>::NPV + Var<S>::NLV) * 3 * C;
  return 4 * ((size_t)S * TN * XW + wc_floats(H, XW) + TN * O +
              (S > 1 ? S - 1 : 1) * TN + (size_t)TN * VW +
              (size_t)S * TN * H);
}

}  // namespace

// ---------------------------------------------------------------------------
// float32
// ---------------------------------------------------------------------------

template <int S, int B>
__global__ void __launch_bounds__(NT, 2)
stencil_bwd_rows_f32(int N, int C, int E, int H, int O, int XW,
                     const float* __restrict__ fr,
                     const float* __restrict__ V,
                     const float* __restrict__ pe,
                     const float* __restrict__ rot,
                     const float* __restrict__ w0big,
                     const float* __restrict__ b0,
                     const float* __restrict__ w1t,
                     const float* __restrict__ w1row,
                     const float* __restrict__ g_c,
                     const float* __restrict__ g_off, MPtrs6 dP, MPtrs6 dL,
                     float* __restrict__ dpe, float* __restrict__ xg,
                     float* __restrict__ dzg, float* __restrict__ hg,
                     float* __restrict__ p_db0,
                     float* __restrict__ p_dw1row) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
  const int VW = (NPV + NLV) * 3 * C;
  float* Xs = reinterpret_cast<float*>(smem_raw);   // [S*TN, XW] X, then dX
  float* Wc = Xs + S * TN * XW;              // W0 / W0^T chunks
  float* gcs = Wc + wc_floats(H, XW);        // [TN, O]
  float* gos = gcs + TN * O;                 // [S-1 (>=1), TN]
  float* Vs = gos + (S > 1 ? S - 1 : 1) * TN;   // [TN, VW]
  float* dzs = Vs + TN * VW;                 // [S*TN, H]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int JN = H / 32;
  const int zr = warp;                       // this thread's row of z / dz
  const int XWP = XW + 1;                    // padded stride of W0^T chunks
  const int n_tiles = (N + TN - 1) / TN;
  float db_acc[JMAX], w1r_acc[JMAX];
#pragma unroll
  for (int c = 0; c < JMAX; ++c) db_acc[c] = w1r_acc[c] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TN;
    const size_t xrow0 = (size_t)tile * S * TN;   // workspace row of (s=0, r=0)
    __syncthreads();
    // ---- load V, cotangents ------------------------------------------
    const size_t v_end = (size_t)N * VW;
#pragma unroll 4
    for (int idx = tid; idx < TN * VW; idx += NT) {
      const size_t g = (size_t)row0 * VW + idx;
      Vs[idx] = g < v_end ? V[g] : 0.f;
    }
    for (int idx = tid; idx < TN * O; idx += NT) {
      const int rr = idx / O;
      gcs[idx] = (row0 + rr < N) ? g_c[(size_t)row0 * O + idx] : 0.f;
    }
    if (S > 1) {
      for (int idx = tid; idx < (S - 1) * TN; idx += NT) {
        const int s = idx / TN, rr = idx % TN;
        gos[idx] = (row0 + rr < N) ? g_off[(size_t)s * N + row0 + rr] : 0.f;
      }
    }
    __syncthreads();
    // ---- rebuild X ----------------------------------------------------
    for (int idx = tid; idx < TN * C; idx += NT) {
      const int rr = idx / C, c = idx % C;
      const float* vr = Vs + rr * VW;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float pv[NPV], lv[NLV], x[S];
#pragma unroll
        for (int v = 0; v < NPV; ++v) pv[v] = vr[(i * NPV + v) * C + c];
#pragma unroll
        for (int v = 0; v < NLV; ++v)
          lv[v] = vr[3 * NPV * C + (i * NLV + v) * C + c];
        x_products<F32, S>(i, pv, lv, x);
#pragma unroll
        for (int s = 0; s < S; ++s) Xs[(s * TN + rr) * XW + i * C + c] = x[s];
      }
    }
    for (int idx = tid; idx < TN * E; idx += NT) {
      const int rr = idx / E, e = idx % E;
      fill_pe<T, S>(Xs, rr, e, C, E, XW, pe, rot, row0 + rr, N);
    }
    const int padw = XW - 3 * C - E;
    for (int idx = tid; idx < S * TN * padw; idx += NT)
      Xs[(idx / padw) * XW + 3 * C + E + idx % padw] = 0.f;

    // ---- layer 0; X to the workspace ---------------------------------
    float acc[S][JMAX];
    layer0<S>(acc, Xs, Wc, H + 1, w0big, b0, XW, H, lane, warp, tid);
    for (int idx = tid; idx < S * TN * XW; idx += NT)
      xg[xrow0 * XW + idx] = Xs[idx];

    // ---- softplus', layer 1 backward -> dz ---------------------------
    float dh[JMAX];
#pragma unroll
    for (int c = 0; c < JMAX; ++c) dh[c] = 0.f;
    for (int o = 0; o < O; ++o) {
      const float g = gcs[zr * O + o];
#pragma unroll
      for (int c = 0; c < JMAX; ++c)
        if (c < JN) dh[c] = fmaf(g, w1t[(size_t)o * H + lane + 32 * c], dh[c]);
    }
#pragma unroll
    for (int c = 0; c < JMAX; ++c) {
      if (c < JN) {
        const int j = lane + 32 * c;
        const float w1r = (S > 1) ? w1row[j] : 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float h, sig, dz;
          softplus100(100.f * acc[s][c], &h, &sig);
          if (s == 0) {
            hg[(size_t)(row0 + zr) * H + j] = h;
            dz = dh[c] * sig;
          } else {
            const float go = gos[(s - 1) * TN + zr];
            w1r_acc[c] = fmaf(h, go, w1r_acc[c]);
            dz = go * w1r * sig;
          }
          db_acc[c] += dz;
          dzs[(size_t)(s * TN + zr) * H + j] = dz;
          dzg[(xrow0 + s * TN + zr) * H + j] = dz;
        }
      }
    }

    // ---- dX = dz . W0^T -> Xs: warp = row (its S points), lanes = X
    // columns; W0^T staged in Wc ----------------------------------------
    float dx[S][KMAX];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) dx[s][kk] = 0.f;
    for (int j0 = 0; j0 < H; j0 += JC) {
      __syncthreads();
      for (int idx = tid; idx < XW * JC; idx += NT) {
        const int k = idx / JC, jc = idx % JC;
        Wc[jc * XWP + k] = w0big[(size_t)k * H + j0 + jc];
      }
      __syncthreads();
#pragma unroll 4
      for (int jc = 0; jc < JC; ++jc) {
        float d[S];
#pragma unroll
        for (int s = 0; s < S; ++s)
          d[s] = dzs[(size_t)(s * TN + warp) * H + j0 + jc];
#pragma unroll
        for (int kk = 0; kk < KMAX; ++kk) {
          const int k = lane + 32 * kk;
          if (k < XW) {
            const float w = Wc[jc * XWP + k];
#pragma unroll
            for (int s = 0; s < S; ++s) dx[s][kk] = fmaf(d[s], w, dx[s][kk]);
          }
        }
      }
    }
    // Xs was last read before the chunk loop's barriers: overwrite it
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
      const int k = lane + 32 * kk;
      if (k < XW) {
#pragma unroll
        for (int s = 0; s < S; ++s) Xs[(s * TN + warp) * XW + k] = dx[s][kk];
      }
    }
    __syncthreads();
    // ---- product rule + hat-weight routing ---------------------------
    for (int idx = tid; idx < TN * C; idx += NT) {
      const int rr = idx / C, c = idx % C;
      const int row = row0 + rr;
      if (row >= N) continue;
      const float* vr = Vs + rr * VW;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float pv[NPV], lv[NLV], dxs[S], dPV[NPV], dLV[NLV];
#pragma unroll
        for (int v = 0; v < NPV; ++v) pv[v] = vr[(i * NPV + v) * C + c];
#pragma unroll
        for (int v = 0; v < NLV; ++v)
          lv[v] = vr[3 * NPV * C + (i * NLV + v) * C + c];
#pragma unroll
        for (int s = 0; s < S; ++s) dxs[s] = Xs[(s * TN + rr) * XW + i * C + c];
        product_rule<F32, S>(i, dxs, pv, lv, dPV, dLV);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const Frac q = load_frac(fr + (size_t)row * 2 * FS + b * FS, i);
          float g[16], dline[4];
          route_plane<F32, S>(dPV, q, g);
          route_line<F32, S>(dLV, q, dline);
          T* dp = (T*)dP.p[b * 3 + i] + (size_t)row * 16 * C + c;
#pragma unroll
          for (int k = 0; k < 16; ++k) dp[(size_t)k * C] = g[k];
          T* dl = (T*)dL.p[b * 3 + i] + (size_t)row * 4 * C + c;
#pragma unroll
          for (int k = 0; k < 4; ++k) dl[(size_t)k * C] = dline[k];
        }
      }
    }
    // ---- dpe: adjoint of the trig-addition PE offsets ----------------
    for (int idx = tid; idx < TN * E; idx += NT) {
      const int rr = idx / E, e = idx % E;
      const int row = row0 + rr;
      if (row >= N) continue;
      float a = Xs[rr * XW + 3 * C + e];
      for (int s = 1; s < S; ++s) {
        const float* R = rot + (size_t)s * 4 * E;
        const int em = (e + E - 3) % E, ep = (e + 3) % E;
        const float t0 = __fmul_rn(Xs[(s * TN + rr) * XW + 3 * C + e], R[e]);
        const float t1 =
            __fmul_rn(Xs[(s * TN + rr) * XW + 3 * C + em], R[E + em]);
        const float t2 =
            __fmul_rn(Xs[(s * TN + rr) * XW + 3 * C + ep], R[2 * E + ep]);
        a = __fadd_rn(__fadd_rn(__fadd_rn(a, t0), t1), t2);
      }
      dpe[(size_t)row * E + e] = a;
    }
  }
  // ---- this thread's db0 / dw1row sums over its tiles ----------------
  const size_t w = (size_t)blockIdx.x * TN + zr;
#pragma unroll
  for (int c = 0; c < JMAX; ++c) {
    if (c < JN) {
      const int j = lane + 32 * c;
      p_db0[w * H + j] = db_acc[c];
      p_dw1row[w * H + j] = w1r_acc[c];
    }
  }
}

// part[z] = A[k0:k1]^T . B[k0:k1] for K chunk z = blockIdx.z of kchunk
// rows; A [K, M] and B [K, Nc] row-major float32.
__global__ void __launch_bounds__(256)
stencil_bwd_atb_f32(int K, int M, int Nc, int kchunk,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    float* __restrict__ part) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // 4 columns x 4 rows each
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BK * BM / 256; ++q) {
      const int idx = tid + 256 * q;
      const int kk = idx / BM, mm = idx % BM;
      const int k = k0 + kk;
      As[kk][mm] =
          (k < k_end && m0 + mm < M) ? A[(size_t)k * M + m0 + mm] : 0.f;
      Bs[kk][mm] =
          (k < k_end && n0 + mm < Nc) ? Bm[(size_t)k * Nc + n0 + mm] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < Nc)
        part[((size_t)blockIdx.z * M + m) * Nc + n] = acc[i][j];
    }
  }
}

// out[w] = sum over r of in[r, w] (in [R, W]), in a fixed order.
__global__ void __launch_bounds__(256)
stencil_bwd_colsum(int R, int W, const float* __restrict__ in,
                   float* __restrict__ out) {
  __shared__ float part[8][33];
  const int lane = threadIdx.x, g = threadIdx.y;
  const int w = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (w < W)
    for (int r = g; r < R; r += 8) s += in[(size_t)r * W + w];
  part[g][lane] = s;
  __syncthreads();
  if (g == 0 && w < W) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += part[q][lane];
    out[w] = t;
  }
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int DZ_BYTES = MR * HP * 2;       // one dz tile

// The saved tap variants of plane i for four channels, as two packed
// pairs: pv[pair][variant], lv[pair][variant]; zeros where !ok.
template <int S>
__device__ __forceinline__ void load_variants(
    const bf16* V, bool ok, size_t at, int i, int C,
    V2 (&pv)[2][Var<S>::NPV], V2 (&lv)[2][Var<S>::NLV]) {
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
#pragma unroll
  for (int v = 0; v < NPV; ++v) {
    const uint2 u = ok ? __ldg(reinterpret_cast<const uint2*>(
                             V + at + (i * NPV + v) * C))
                       : make_uint2(0, 0);
    pv[0][v] = as_pair(u.x);
    pv[1][v] = as_pair(u.y);
  }
#pragma unroll
  for (int v = 0; v < NLV; ++v) {
    const uint2 u = ok ? __ldg(reinterpret_cast<const uint2*>(
                             V + at + 3 * NPV * C + (i * NLV + v) * C))
                       : make_uint2(0, 0);
    lv[0][v] = as_pair(u.x);
    lv[1][v] = as_pair(u.y);
  }
}
constexpr int PEW = 32;                     // dX PE columns kept in f32
constexpr size_t ROWS_SMEM =
    2 * W_BYTES + X_BYTES + MR * PEW * 4 + (NTH / 32) * HP * 4 + 16;
constexpr int ATB_TH = 512;                 // four warpgroups
constexpr size_t ATB_SMEM = 2 * (DZ_BYTES + X_BYTES) + 16;

}  // namespace

template <int S, int B>
__global__ void __launch_bounds__(NTH, 1)
stencil_bwd_rows_bf16(int N, int C, int E, int O,
                      const float* __restrict__ fr,
                      const bf16* __restrict__ V,
                      const bf16* __restrict__ pe,
                      const float* __restrict__ rot,
                      const bf16* __restrict__ w0t,
                      const float* __restrict__ b0,
                      const bf16* __restrict__ w1t,
                      const float* __restrict__ w1row,
                      const float* __restrict__ g_c,
                      const float* __restrict__ g_off, MPtrs6 dP, MPtrs6 dL,
                      float* __restrict__ dpe, unsigned char* __restrict__ xg,
                      unsigned char* __restrict__ dzg,
                      unsigned char* __restrict__ hg,
                      unsigned char* __restrict__ gcg,
                      float* __restrict__ p_dw1row) {
  using T = bf16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
  constexpr int TNB = Tile<S>::ROWS;
  constexpr int XPB = XP * 2;                // row pitch of dX in R
  unsigned char* W0s = smem_raw;             // tiled [XP, HP]
  unsigned char* W1s = W0s + W_BYTES;        // tiled [OP, HP]
  // R: X (tiled [MR, XP]), then the rounded g_c (tiled [TNB, OP]), then
  // dX (bf16, row-major [MR, XP])
  unsigned char* R = W1s + W_BYTES;
  float* pes = reinterpret_cast<float*>(R + X_BYTES);   // [MR, PEW] dX of PE
  float* w1acc = pes + MR * PEW;             // [warps, HP] dw1row sums
  uint64_t* bar = reinterpret_cast<uint64_t*>(w1acc + (NTH / 32) * HP);
  const int tid = threadIdx.x;
  const int lane = tid & 31, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int qd = lane & 3;
  const int VW = (NPV + NLV) * 3 * C;
  const int CG = C / 4;
  const int K0 = 3 * C + E;
  const int n_tiles = (N + TNB - 1) / TNB;
  // this thread's fragment rows m, m + 8; their stencil point
  const int m = 64 * wg + 16 * warp + (lane >> 2);
  const int s_frag = (S > 1) ? m / TNB : 0;
  const bool centre = s_frag == 0;

  if (tid == 0) mbar_init(bar, 1);
  for (int idx = tid; idx < (NTH / 32) * HP; idx += NTH) w1acc[idx] = 0.f;
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar, 2 * W_BYTES);
    bulk_load(W0s, w0t, W_BYTES, bar);
    bulk_load(W1s, w1t, W_BYTES, bar);
  }
  bool weights_here = false;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TNB;
    __syncthreads();                 // the last tile's dX has been read
#ifndef SH_SKIP_TAPS
    // ---- rebuild X from V: one (row, plane, 2 packed pairs) per thread --
    for (int idx = tid; idx < TNB * 3 * CG; idx += NTH) {
      const int rr = idx / (3 * CG), rem = idx % (3 * CG);
      const int i = rem / CG, c0 = 4 * (rem % CG);
      const int row = row0 + rr;
      V2 pv[2][NPV], lv[2][NLV], x[2][S];
      load_variants<S>(V, row < N, (size_t)row * VW + c0, i, C, pv, lv);
      x_products<Bf2, S>(i, pv[0], lv[0], x[0]);
      x_products<Bf2, S>(i, pv[1], lv[1], x[1]);
#pragma unroll
      for (int s = 0; s < S; ++s)
        *reinterpret_cast<uint2*>(R + tiled(s * TNB + rr, i * C + c0, XP)) =
            make_uint2(as_u32(x[0][s]), as_u32(x[1][s]));
    }
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
        *reinterpret_cast<T*>(R + tiled(s * TNB + rr, 3 * C + e, XP)) =
            __float2bfloat16_rn(pe_point<T>(s, e, E, p0, pm3, pp3, rot));
    }
#endif  // SH_SKIP_TAPS
    // pad columns: zero, the last one all ones (its dW0 row is db0)
    const int padw = XP - K0;
    for (int idx = tid; idx < MR * padw; idx += NTH) {
      const int col = K0 + idx % padw;
      *reinterpret_cast<T*>(R + tiled(idx / padw, col, XP)) =
          __float2bfloat16_rn(col == XP - 1 ? 1.f : 0.f);
    }
    // pad rows (the eighth stencil group): zero
    for (int idx = tid; idx < (MR - S * TNB) * K0; idx += NTH)
      *reinterpret_cast<T*>(R + tiled(S * TNB + idx / K0, idx % K0, XP)) =
          __float2bfloat16_rn(0.f);
    fence_async();
    __syncthreads();
#ifndef SH_SKIP_WORKSPACE
    if (tid == 0) bulk_store(xg + (size_t)tile * X_BYTES, R, X_BYTES);
#endif
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
          __ldg(reinterpret_cast<const float2*>(b0 + 8 * j + 2 * qd));
      acc[4 * j] = acc[4 * j + 2] = bb.x;
      acc[4 * j + 1] = acc[4 * j + 3] = bb.y;
    }
    {
      const uint64_t da =
          make_desc(smem_u32(R) + wg * 8 * XP * 16, 128, XP * 16);
      const uint64_t db = make_desc(smem_u32(W0s), HP * 16, 128);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < XP / 16; ++k)
        wgmma_ss_n256<0, 1>(acc, desc_add(da, 256 * k),
                            desc_add(db, 2 * HP * 16 * k));
      wgmma_commit();
      wgmma_wait();
    }
    if (tid == 0) bulk_store_wait_read();    // X has left R
    __syncthreads();
    // ---- the centre cotangent, rounded, as the A operand of dh ---------
    for (int idx = tid; idx < TNB * OP; idx += NTH) {
      const int rr = idx / OP, o = idx % OP;
      const int row = row0 + rr;
      const float g =
          (row < N && o < O) ? __ldg(g_c + (size_t)row * O + o) : 0.f;
      *reinterpret_cast<T*>(R + tiled(rr, o, OP)) = __float2bfloat16_rn(g);
    }
    fence_async();
    __syncthreads();
#ifndef SH_SKIP_WORKSPACE
    if (tid == 0)
      bulk_store(gcg + (size_t)tile * TNB * OP * 2, R, TNB * OP * 2);
#endif
    __syncwarp();

    // ---- softplus and its slope on the fragment ------------------------
    // afterwards acc holds sigmoid (centre rows) or dz (offset rows)
    float go[2] = {0.f, 0.f};
    if (S > 1 && s_frag >= 1 && s_frag < S) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + (m + 8 * half) % TNB;
        if (row < N) go[half] = __ldg(g_off + (size_t)(s_frag - 1) * N + row);
      }
    }
    unsigned char* hg_t = hg + (size_t)tile * TNB * HP * 2;
#ifndef SH_SKIP_SOFTPLUS
#pragma unroll
    for (int j = 0; j < HP / 8; ++j) {
      const int col = 8 * j + 2 * qd;
      float h[2][2];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float sig;
          softplus100_fast(100.f * acc[4 * j + 2 * half + t], &h[half][t],
                           &sig);
          h[half][t] = Cd<T>::rnd(h[half][t]);
          acc[4 * j + 2 * half + t] = sig;
        }
      if (centre) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint32_t*>(
              hg_t + tiled((m + 8 * half) % TNB, col, HP)) =
              pack_bf16(h[half][0], h[half][1]);
      } else {
        const float2 w1r = __ldg(reinterpret_cast<const float2*>(w1row + col));
        float v0 = fmaf(h[0][0], go[0], h[1][0] * go[1]);
        float v1 = fmaf(h[0][1], go[0], h[1][1] * go[1]);
#pragma unroll
        for (int sh_ = 4; sh_ < 32; sh_ <<= 1) {
          v0 += __shfl_xor_sync(0xffffffffu, v0, sh_);
          v1 += __shfl_xor_sync(0xffffffffu, v1, sh_);
        }
        if (lane < 4) {
          float* wa = w1acc + (tid >> 5) * HP + col;
          wa[0] += v0;
          wa[1] += v1;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          acc[4 * j + 2 * half] =
              Cd<T>::rnd(go[half] * w1r.x * acc[4 * j + 2 * half]);
          acc[4 * j + 2 * half + 1] =
              Cd<T>::rnd(go[half] * w1r.y * acc[4 * j + 2 * half + 1]);
        }
      }
    }
#endif  // SH_SKIP_SOFTPLUS
    // ---- dh = g_c.W1^T in four n64 quarters; dz = dh * sigmoid ---------
    if (S == 1 || wg == 0) {
      const uint64_t da =
          make_desc(smem_u32(R) + wg * 8 * OP * 16, 128, OP * 16);
#pragma unroll
      for (int quarter = 0; quarter < 4; ++quarter) {
        float dq[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) dq[k] = 0.f;
        const uint64_t db =
            make_desc(smem_u32(W1s) + quarter * 1024, HP * 16, 128);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < OP / 16; ++k)
          wgmma_ss_n64<0, 1>(dq, desc_add(da, 256 * k),
                             desc_add(db, 2 * HP * 16 * k));
        wgmma_commit();
        wgmma_wait();
        if (centre) {
#pragma unroll
          for (int k = 0; k < 32; ++k)
            acc[32 * quarter + k] =
                Cd<T>::rnd(dq[k] * acc[32 * quarter + k]);
        }
      }
    }
    // ---- dz: to the workspace (operand layout) and, packed, A of dX -----
    uint32_t dzp[HP / 4];
    unsigned char* dz_t = dzg + (size_t)tile * DZ_BYTES;
#pragma unroll
    for (int j = 0; j < HP / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t p =
            pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        dzp[2 * j + half] = p;
#ifndef SH_SKIP_WORKSPACE
        *reinterpret_cast<uint32_t*>(
            dz_t + tiled(m + 8 * half, 8 * j + 2 * qd, HP)) = p;
#endif
      }
    }
    float dx[XP / 2];
#pragma unroll
    for (int k = 0; k < XP / 2; ++k) dx[k] = 0.f;
    {
      const uint64_t db = make_desc(smem_u32(W0s), 128, HP * 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HP / 16; ++k)
        wgmma_rs_n144<0>(dx, &dzp[4 * k], desc_add(db, 256 * k));
      wgmma_commit();
      wgmma_wait();
    }
    if (tid == 0) bulk_store_wait_read();    // g_c has left R
    __syncthreads();                         // and dh has read it
    // ---- dX -> R (bf16, as the product rule rounds it) and pes (f32) ----
#pragma unroll
    for (int j = 0; j < XP / 8; ++j) {
      const int col = 8 * j + 2 * qd;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int mm = m + 8 * half;
        *reinterpret_cast<uint32_t*>(R + mm * XPB + col * 2) =
            pack_bf16(dx[4 * j + 2 * half], dx[4 * j + 2 * half + 1]);
#pragma unroll
        for (int t = 0; t < 2; ++t)
          if (col + t >= 3 * C && col + t < K0)
            pes[mm * PEW + col + t - 3 * C] = dx[4 * j + 2 * half + t];
      }
    }
    __syncthreads();
#ifndef SH_SKIP_TAPS
    // ---- product rule + hat-weight routing ------------------------------
    for (int idx = tid; idx < TNB * 3 * CG; idx += NTH) {
      const int rr = idx / (3 * CG), rem = idx % (3 * CG);
      const int i = rem / CG, c0 = 4 * (rem % CG);
      const int row = row0 + rr;
      if (row >= N) continue;
      V2 pv[2][NPV], lv[2][NLV], dxs[2][S], dPV[2][NPV], dLV[2][NLV];
      load_variants<S>(V, true, (size_t)row * VW + c0, i, C, pv, lv);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            R + (s * TNB + rr) * XPB + (i * C + c0) * 2);
        dxs[0][s] = as_pair(u.x);
        dxs[1][s] = as_pair(u.y);
      }
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
        product_rule<Bf2, S>(i, dxs[pr], pv[pr], lv[pr], dPV[pr], dLV[pr]);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const Frac q = load_frac(fr + (size_t)row * 2 * FS + b * FS, i);
        V2 g[2][16], dline[2][4];
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          route_plane<Bf2, S>(dPV[pr], q, g[pr]);
          route_line<Bf2, S>(dLV[pr], q, dline[pr]);
        }
        T* dp = (T*)dP.p[b * 3 + i] + (size_t)row * 16 * C + c0;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          *reinterpret_cast<uint2*>(dp + k * C) =
              make_uint2(as_u32(g[0][k]), as_u32(g[1][k]));
        T* dl = (T*)dL.p[b * 3 + i] + (size_t)row * 4 * C + c0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          *reinterpret_cast<uint2*>(dl + k * C) =
              make_uint2(as_u32(dline[0][k]), as_u32(dline[1][k]));
      }
    }
    // ---- dpe: adjoint of the trig-addition PE offsets ------------------
    for (int idx = tid; idx < TNB * E; idx += NTH) {
      const int rr = idx / E, e = idx % E;
      const int row = row0 + rr;
      if (row >= N) continue;
      float a = pes[rr * PEW + e];
      for (int s = 1; s < S; ++s) {
        const float* Rt = rot + (size_t)s * 4 * E;
        const float* ps = pes + (s * TNB + rr) * PEW;
        const int em = (e + E - 3) % E, ep = (e + 3) % E;
        const float t0 = __fmul_rn(ps[e], Rt[e]);
        const float t1 = __fmul_rn(ps[em], Rt[E + em]);
        const float t2 = __fmul_rn(ps[ep], Rt[2 * E + ep]);
        a = __fadd_rn(__fadd_rn(__fadd_rn(a, t0), t1), t2);
      }
      dpe[(size_t)row * E + e] = a;
    }
#endif  // SH_SKIP_TAPS
  }
  if (!weights_here) mbar_wait(bar, 0);      // never leave a copy in flight
  // ---- this block's dw1row sums ------------------------------------------
  __syncthreads();
  for (int col = tid; col < HP; col += NTH) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NTH / 32; ++w) t += w1acc[w * HP + col];
    p_dw1row[(size_t)blockIdx.x * HP + col] = t;
  }
}

// part[block] = sum over the block's tiles of A_t^T . B_t, [HP, XP] f32.
// A_t [KT, HP] and B_t [KT, XP] are bf16 tiles in operand layout, tile t
// of A at A + t*KT*HP*2 bytes (B alike).  A stage of the ring holds
// 128 / KT tiles of each.
template <int KT>
__global__ void __launch_bounds__(ATB_TH, 1)
stencil_bwd_atb_bf16(int n_tiles, const unsigned char* __restrict__ A,
                     const unsigned char* __restrict__ Bm,
                     float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int G = MR / KT;                  // tiles per stage
  constexpr int A_T = KT * HP * 2, B_T = KT * XP * 2;
  unsigned char* As = smem_raw;               // [2][DZ_BYTES]
  unsigned char* Bs = As + 2 * DZ_BYTES;      // [2][X_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + 2 * X_BYTES);
  const int tid = threadIdx.x;
  const int lane = tid & 31, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int n_stages = (n_tiles + G - 1) / G;
  const int per = (n_stages + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * per;
  const int mine = max(0, min(per, n_stages - first));

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
  }
  __syncthreads();
  auto fetch = [&](int it) {
    const int st = first + it, slot = it & 1;
    const int tiles = min(G, n_tiles - st * G);
    mbar_expect(full + slot, tiles * (A_T + B_T));
    bulk_load(As + slot * DZ_BYTES, A + (size_t)st * G * A_T, tiles * A_T,
              full + slot);
    bulk_load(Bs + slot * X_BYTES, Bm + (size_t)st * G * B_T, tiles * B_T,
              full + slot);
  };
  if (tid == 0) {
    if (mine > 0) fetch(0);
    if (mine > 1) fetch(1);
  }
  float acc[XP / 2];
#pragma unroll
  for (int k = 0; k < XP / 2; ++k) acc[k] = 0.f;
  for (int it = 0; it < mine; ++it) {
    const int slot = it & 1;
    mbar_wait(full + slot, (it >> 1) & 1);
    const int tiles = min(G, n_tiles - (first + it) * G);
    // MN-major operands: K runs over the tile's rows
    const uint32_t a0 = smem_u32(As + slot * DZ_BYTES) + wg * 8 * 128;
    const uint32_t b0 = smem_u32(Bs + slot * X_BYTES);
    wgmma_fence();
    for (int g = 0; g < tiles; ++g) {
      const uint64_t da = make_desc(a0 + g * A_T, HP * 16, 128);
      const uint64_t db = make_desc(b0 + g * B_T, XP * 16, 128);
#pragma unroll
      for (int k = 0; k < KT / 16; ++k)
        wgmma_ss_n144<1, 1>(acc, desc_add(da, 2 * HP * 16 * k),
                            desc_add(db, 2 * XP * 16 * k));
    }
    wgmma_commit();
    wgmma_wait();
    __syncthreads();                 // every warpgroup has read the stage
    if (tid == 0 && it + 2 < mine) fetch(it + 2);
  }
  const int m = 64 * wg + 16 * warp + (lane >> 2);
  float* out = part + (size_t)blockIdx.x * HP * XP;
#pragma unroll
  for (int j = 0; j < XP / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + (size_t)m * XP + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(m + 8) * XP + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

namespace {

// Workspace carve-up (byte offsets, each 256-aligned).
struct Layout {
  int nblk, n_tiles, nblk_dw0, nblk_dw1;
  size_t xg, dzg, hg, gcg, p_db0, p_dw1row, p_dw0, p_dw1, total;
};

size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off += (bytes + 255) / 256 * 256;
  return at;
}

Layout layout_f32(int S, int n_sm, int N, int H, int O, int XW) {
  Layout L = {};
  L.n_tiles = (N + TN - 1) / TN;
  L.nblk = L.n_tiles < 2 * n_sm ? L.n_tiles : 2 * n_sm;
  const size_t rows = (size_t)L.n_tiles * TN;
  size_t off = 0;
  L.xg = take(&off, rows * S * XW * 4);
  L.dzg = take(&off, rows * S * H * 4);
  L.hg = take(&off, rows * H * 4);
  L.p_db0 = take(&off, (size_t)L.nblk * TN * H * 4);
  L.p_dw1row = take(&off, (size_t)L.nblk * TN * H * 4);
  L.p_dw0 = take(&off, (size_t)NSPLIT * XW * H * 4);
  L.p_dw1 = take(&off, (size_t)NSPLIT * H * O * 4);
  L.total = off;
  return L;
}

Layout layout_bf16(int S, int n_sm, int N) {
  Layout L = {};
  const int tnb = S > 1 ? 16 : MR;
  L.n_tiles = (N + tnb - 1) / tnb;
  L.nblk = L.n_tiles < n_sm ? L.n_tiles : n_sm;
  L.nblk_dw0 = L.nblk;                       // stages of one tile
  const int st1 = (L.n_tiles * tnb + MR - 1) / MR;   // stages of 128 rows
  L.nblk_dw1 = st1 < n_sm ? st1 : n_sm;
  size_t off = 0;
  L.xg = take(&off, (size_t)L.n_tiles * X_BYTES);
  L.dzg = take(&off, (size_t)L.n_tiles * DZ_BYTES);
  L.hg = take(&off, (size_t)L.n_tiles * tnb * HP * 2);
  L.gcg = take(&off, (size_t)L.n_tiles * tnb * OP * 2);
  L.p_dw1row = take(&off, (size_t)L.nblk * HP * 4);
  L.p_dw0 = take(&off, (size_t)L.nblk_dw0 * HP * XP * 4);
  L.p_dw1 = take(&off, (size_t)L.nblk_dw1 * HP * OP * 4);
  L.total = off;
  return L;
}

cudaError_t colsum(int R, int W, const float* in, float* out,
                   cudaStream_t stream) {
  stencil_bwd_colsum<<<(W + 31) / 32, dim3(32, 8), 0, stream>>>(R, W, in,
                                                                 out);
  return cudaGetLastError();
}

cudaError_t atb_f32(int K, int M, int Nc, const float* A, const float* Bm,
                    float* part, float* out, cudaStream_t stream) {
  int kchunk = (K + NSPLIT - 1) / NSPLIT;
  kchunk = (kchunk + BK - 1) / BK * BK;
  const int nsplit = (K + kchunk - 1) / kchunk;
  const dim3 grid((M + BM - 1) / BM, (Nc + BN - 1) / BN, nsplit);
  stencil_bwd_atb_f32<<<grid, 256, 0, stream>>>(K, M, Nc, kchunk, A, Bm,
                                                part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return colsum(nsplit, M * Nc, part, out, stream);
}

struct Args {
  int n_sm, N, C, E, H, O, XW;
  const float* fr;
  const void *V, *pe;
  const float* rot;
  const void* w0;
  const float* b0;
  const void *w1, *w1row;
  const float *g_c, *g_off;
  MPtrs6 dP, dL;
  float* dpe;
  char* ws;
  float *dw0, *db0, *dw1, *dw1row;
  cudaStream_t stream;
};

template <int S, int B>
cudaError_t launch_f32(const Args& a) {
  const Layout L = layout_f32(S, a.n_sm, a.N, a.H, a.O, a.XW);
  float* xg = reinterpret_cast<float*>(a.ws + L.xg);
  float* dzg = reinterpret_cast<float*>(a.ws + L.dzg);
  float* hg = reinterpret_cast<float*>(a.ws + L.hg);
  float* p_db0 = reinterpret_cast<float*>(a.ws + L.p_db0);
  float* p_dw1row = reinterpret_cast<float*>(a.ws + L.p_dw1row);
  const size_t smem = rows_smem_f32<S>(a.C, a.H, a.O, a.XW);
  auto kern = stencil_bwd_rows_f32<S, B>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<L.nblk, NT, smem, a.stream>>>(
      a.N, a.C, a.E, a.H, a.O, a.XW, a.fr, (const float*)a.V,
      (const float*)a.pe, a.rot, (const float*)a.w0, a.b0,
      (const float*)a.w1, (const float*)a.w1row, a.g_c, a.g_off, a.dP, a.dL,
      a.dpe, xg, dzg, hg, p_db0, p_dw1row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int wr = L.nblk * TN;       // partial rows: (block, z row)
  err = colsum(wr, a.H, p_db0, a.db0, a.stream);
  if (err != cudaSuccess) return err;
  err = colsum(wr, a.H, p_dw1row, a.dw1row, a.stream);
  if (err != cudaSuccess) return err;
  // dW0 over all S * n_tiles * TN workspace rows (pad rows carry dz = 0)
  err = atb_f32(L.n_tiles * TN * S, a.XW, a.H, xg, dzg,
                reinterpret_cast<float*>(a.ws + L.p_dw0), a.dw0, a.stream);
  if (err != cudaSuccess) return err;
  return atb_f32(a.N, a.H, a.O, hg, a.g_c,
                 reinterpret_cast<float*>(a.ws + L.p_dw1), a.dw1, a.stream);
}

template <int KT>
cudaError_t atb_bf16(int n_tiles, int nblk, const unsigned char* A,
                     const unsigned char* Bm, float* part, float* out,
                     cudaStream_t stream) {
  auto kern = stencil_bwd_atb_bf16<KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ATB_SMEM);
  if (err != cudaSuccess) return err;
  kern<<<nblk, ATB_TH, ATB_SMEM, stream>>>(n_tiles, A, Bm, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return colsum(nblk, HP * XP, part, out, stream);
}

template <int S, int B>
cudaError_t launch_bf16(const Args& a) {
  const Layout L = layout_bf16(S, a.n_sm, a.N);
  unsigned char* ws = reinterpret_cast<unsigned char*>(a.ws);
  float* p_dw1row = reinterpret_cast<float*>(a.ws + L.p_dw1row);
  auto kern = stencil_bwd_rows_bf16<S, B>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ROWS_SMEM);
  if (err != cudaSuccess) return err;
  kern<<<L.nblk, NTH, ROWS_SMEM, a.stream>>>(
      a.N, a.C, a.E, a.O, a.fr, (const bf16*)a.V, (const bf16*)a.pe, a.rot,
      (const bf16*)a.w0, a.b0, (const bf16*)a.w1, (const float*)a.w1row,
      a.g_c, a.g_off, a.dP, a.dL, a.dpe, ws + L.xg, ws + L.dzg, ws + L.hg,
      ws + L.gcg, p_dw1row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = colsum(L.nblk, HP, p_dw1row, a.dw1row, a.stream);
  if (err != cudaSuccess) return err;
  // dW0^T [HP, XP] (db0 in its last column) and dW1 [HP, OP]
  err = atb_bf16<MR>(L.n_tiles, L.nblk_dw0, ws + L.dzg, ws + L.xg,
                     reinterpret_cast<float*>(a.ws + L.p_dw0), a.dw0,
                     a.stream);
  if (err != cudaSuccess) return err;
  return atb_bf16<Tile<S>::ROWS>(
      L.n_tiles, L.nblk_dw1, ws + L.hg, ws + L.gcg,
      reinterpret_cast<float*>(a.ws + L.p_dw1), a.dw1, a.stream);
}

bool bad_shape(int dtype, int S, int B, int n_sm, int N, int C, int E, int H,
               int O, int XW) {
  if ((S != 1 && S != 7) || (B != 1 && B != 2) || N <= 0 || n_sm <= 0)
    return true;
  if (dtype == 0)
    return H % 32 != 0 || H > 32 * JMAX || H % JC != 0 || XW % KC != 0 ||
           XW > 32 * KMAX || 3 * C + E > XW;
  if (dtype == 1)
    return C % 4 != 0 || 3 * C + E >= XP || E > PEW || H > HP || O > OP ||
           XW != XP;
  return true;
}

}  // namespace

// Bytes of the device workspace stencil_head_bwd needs (the caller
// allocates it); 0 for shapes the kernels do not take.
extern "C" long long stencil_head_bwd_workspace(int dtype, int S, int B,
                                                int n_sm, int N, int C,
                                                int E, int H, int O,
                                                int XW) {
  if (bad_shape(dtype, S, B, n_sm, N, C, E, H, O, XW)) return 0;
  return (long long)(dtype == 1 ? layout_bf16(S, n_sm, N)
                                : layout_f32(S, n_sm, N, H, O, XW))
      .total;
}

// dtype 0 = float32: w0 [XW, H], b0 [H], w1 = W1 transposed [O, H], w1row
// [H] in float32; outputs dw0 [XW, H], db0 [H], dw1 [H, O], dw1row [H].
// dtype 1 = bfloat16: w0 and w1 are the padded, tiled operands of
// ops/stencil.py pack_weights_bf16, b0 and w1row [HP] float32, zero
// padded; outputs dw0 = dW0^T [HP, XP] whose last column is db0 (db0
// itself is not written), dw1 [HP, OP], dw1row [HP].  All outputs f32.
// Returns a cudaError_t (0 = success).
extern "C" int stencil_head_bwd(int dtype, int S, int B, int n_sm, int N,
                                int C, int E, int H, int O, int XW,
                                const float* fr, const void* V,
                                const void* pe, const float* rot,
                                const void* w0, const float* b0,
                                const void* w1, const void* w1row,
                                const float* g_c, const float* g_off,
                                void* const* dP, void* const* dL, float* dpe,
                                void* workspace, float* dw0, float* db0,
                                float* dw1, float* dw1row, void* stream) {
  if (bad_shape(dtype, S, B, n_sm, N, C, E, H, O, XW))
    return (int)cudaErrorInvalidValue;
  Args a = {n_sm, N,  C,     E,   H,   O,   XW,  fr,  V,      pe,
            rot,  w0, b0,    w1,  w1row, g_c, g_off, {}, {}, dpe,
            static_cast<char*>(workspace), dw0, db0, dw1, dw1row,
            (cudaStream_t)stream};
  for (int k = 0; k < 6; ++k) {
    a.dP.p[k] = k < 3 * B ? dP[k] : nullptr;
    a.dL.p[k] = k < 3 * B ? dL[k] : nullptr;
  }
#define SH_CASE(SS, BB)                                     \
  if (S == SS && B == BB)                                   \
    return (int)(dtype == 0 ? launch_f32<SS, BB>(a)         \
                            : launch_bf16<SS, BB>(a))
  SH_CASE(7, 1);
  SH_CASE(7, 2);
  SH_CASE(1, 1);
  SH_CASE(1, 2);
#undef SH_CASE
  return (int)cudaErrorInvalidValue;
}
