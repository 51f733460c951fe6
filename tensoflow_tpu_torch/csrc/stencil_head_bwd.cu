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
// its ~1.5 MFLOP per row sits below the card's op:byte balance.  In this
// version the per-tile phases, their barriers and the workspace round
// trip take most of the time, not the products.
//
// Cross-tile sums: the TPU kernel carries the weight gradients in
// resident outputs across a SEQUENTIAL grid.  Hopper blocks run in no
// order, so the sums over rows are taken in three deterministic steps
// (no atomics; against the plain version only the f32 summation order
// differs):
//   1. stencil_bwd_rows — persistent blocks (two per SM) walk 8-row
//      tiles.  Per tile: V -> X in shared memory, layer 0 (layer0 in
//      stencil_common.cuh), softplus and its derivative, dz =
//      (dh * sigmoid).T, dX = dz.W0^T (bf16: tensor cores, W0 fragments
//      from device memory; float32: FMAs, W0^T staged 32 hidden columns
//      at a time), then the product rule, hat-weight routing and the PE
//      adjoint.  It writes X, dz and the centre h (all already T-rounded,
//      so storing them in T is exact) to a workspace, and keeps each
//      thread's db0 / dw1row sums in registers across its tiles.
//   2. stencil_bwd_atb(_mma) — dW0 = X^T.dz and dW1 = h^T.g_c as split-K
//      products: one partial [M, N] per K chunk, 64x64 output tiles
//      (bf16: tensor cores, three blocks per SM to hide the load latency;
//      float32: 4x4 FMA outputs per thread).
//   3. stencil_bwd_colsum — sums the partials (and the per-thread db0 /
//      dw1row sums) in a fixed order.
// The bf16 rounding points of the TPU kernel are kept op by op.
#include "stencil_common.cuh"

using namespace sh;

namespace {

constexpr int JC = 32;     // hidden columns of W0^T staged per chunk (dX)
constexpr int KMAX = 6;    // X columns per lane in dX (XW <= 192)
constexpr int BM = 64, BN = 64, BK = 16;   // split-K product tiles (FMA)
constexpr int AK = 32;                      // K rows per stage (tensor cores)
constexpr int NSPLIT = 64;                  // K chunks of the products

__host__ __device__ inline int wc_floats(int H, int XW) {
  const int a = KC * (H + 1), b = JC * (XW + 1);
  return a > b ? a : b;
}

// Floats of the W0 staging area (float32) or of X in bf16 (bf16 path).
template <typename T, int S>
__host__ __device__ inline int operand_floats(int H, int XW) {
  return std::is_same<T, float>::value ? wc_floats(H, XW)
                                       : Rows<S>::MR * (XW + 8) / 2;
}

template <typename T, int S>
__host__ __device__ inline size_t rows_smem(int C, int E, int H, int O,
                                            int XW) {
  constexpr int NPV = (S > 1) ? 5 : 1;
  constexpr int NLV = (S > 1) ? 3 : 1;
  const int VW = (NPV + NLV) * 3 * C;
  const size_t f = (size_t)S * TN * XW + operand_floats<T, S>(H, XW) +
                   TN * O + (S > 1 ? S - 1 : 1) * TN;
  return 4 * f + sizeof(T) * ((size_t)TN * VW +
                              (size_t)Rows<S>::MR * (H + 8));
}

}  // namespace

template <typename T, int S, int B>
__global__ void __launch_bounds__(NT, 2)
stencil_bwd_rows(int N, int C, int E, int H, int O, int XW,
                 const float* __restrict__ fr, const T* __restrict__ V,
                 const T* __restrict__ pe, const float* __restrict__ rot,
                 const T* __restrict__ w0big, const T* __restrict__ w0t,
                 const float* __restrict__ b0,
                 const T* __restrict__ w1t, const T* __restrict__ w1row,
                 const float* __restrict__ g_c,
                 const float* __restrict__ g_off, MPtrs6 dP, MPtrs6 dL,
                 float* __restrict__ dpe, T* __restrict__ xg,
                 T* __restrict__ dzg, T* __restrict__ hg,
                 float* __restrict__ p_db0, float* __restrict__ p_dw1row) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NPV = (S > 1) ? 5 : 1;
  constexpr int NLV = (S > 1) ? 3 : 1;
  const int VW = (NPV + NLV) * 3 * C;
  constexpr int MR = Rows<S>::MR;
  float* Xs = reinterpret_cast<float*>(smem_raw);   // [S*TN, XW] X, then dX
  float* Wc = Xs + S * TN * XW;              // float32: W0 chunks
  __nv_bfloat16* Xb = reinterpret_cast<__nv_bfloat16*>(Wc);  // bf16: X
  float* gcs = Wc + operand_floats<T, S>(H, XW);   // [TN, O]
  float* gos = gcs + TN * O;                 // [S-1 (>=1), TN]
  T* Vs = reinterpret_cast<T*>(gos + (S > 1 ? S - 1 : 1) * TN);  // [TN, VW]
  T* dzs = Vs + TN * VW;                     // [MR, DZW] dz in T
  const int DZW = H + 8;                     // row stride of dzs
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int JN = H / 32;
  const int zr = Own<T>::row(lane, warp);    // this thread's row of z / dz
  const int XWP = XW + 1;                    // padded stride of W0^T chunks
  const int n_tiles = (N + TN - 1) / TN;
  float db_acc[JMAX], w1r_acc[JMAX];
#pragma unroll
  for (int c = 0; c < JMAX; ++c) db_acc[c] = w1r_acc[c] = 0.f;
  // pad rows of dz: read as zeros by the tensor-core dX, never written
  for (int idx = tid; idx < (MR - S * TN) * DZW; idx += NT)
    dzs[S * TN * DZW + idx] = T(0.f);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TN;
    const size_t xrow0 = (size_t)tile * S * TN;   // workspace row of (s=0, r=0)
    __syncthreads();
    // ---- load V, cotangents ------------------------------------------
    const size_t v_end = (size_t)N * VW;
#pragma unroll 4
    for (int idx = tid; idx < TN * VW; idx += NT) {
      const size_t g = (size_t)row0 * VW + idx;
      Vs[idx] = g < v_end ? V[g] : T(0.f);
    }
    for (int idx = tid; idx < TN * O; idx += NT) {
      const int rr = idx / O;
      gcs[idx] = (row0 + rr < N)
                     ? Cd<T>::rnd(g_c[(size_t)row0 * O + idx]) : 0.f;
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
      const T* vr = Vs + rr * VW;
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          int a, l;
          stencil_map(s, i, &a, &l);
          Xs[(s * TN + rr) * XW + i * C + c] =
              mul<T>(Cd<T>::ld(vr, (i * NPV + a) * C + c),
                     Cd<T>::ld(vr, 3 * NPV * C + (i * NLV + l) * C + c));
        }
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
    float acc[Rows<S>::SP][JMAX];
    layer0<T, S>(acc, Xs, Xb, Wc, H + 1, w0big, w0t, b0, XW, H, lane, warp,
                 tid);
    for (int idx = tid; idx < S * TN * XW; idx += NT)
      Cd<T>::st(xg, xrow0 * XW + idx, Xs[idx]);

    // ---- softplus', layer 1 backward -> dz ---------------------------
    float dh[JMAX];
#pragma unroll
    for (int c = 0; c < JMAX; ++c) dh[c] = 0.f;
    for (int o = 0; o < O; ++o) {
      const float g = gcs[zr * O + o];
#pragma unroll
      for (int c = 0; c < JMAX; ++c)
        if (c < JN)
          dh[c] = fmaf(g, Cd<T>::ld(w1t, (size_t)o * H +
                                             Own<T>::col(c, H, lane, warp)),
                       dh[c]);
    }
#pragma unroll
    for (int c = 0; c < JMAX; ++c) {
      if (c < JN) {
        const int j = Own<T>::col(c, H, lane, warp);
        const float w1r = (S > 1) ? Cd<T>::ld(w1row, j) : 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float zs = 100.f * acc[s][c];
          const float e = expf(-fabsf(zs));
          const float h = Cd<T>::rnd((fmaxf(zs, 0.f) + log1pf(e)) / 100.f);
          const float sig = (zs >= 0.f ? 1.f : e) / (1.f + e);
          float dz;
          if (s == 0) {
            Cd<T>::st(hg, (size_t)(row0 + zr) * H + j, h);
            dz = Cd<T>::rnd(dh[c] * sig);
          } else {
            const float go = gos[(s - 1) * TN + zr];
            w1r_acc[c] = fmaf(h, go, w1r_acc[c]);
            dz = Cd<T>::rnd(go * w1r * sig);
          }
          db_acc[c] += dz;
          Cd<T>::st(dzs, (size_t)(s * TN + zr) * DZW + j, dz);
          Cd<T>::st(dzg, (xrow0 + s * TN + zr) * H + j, dz);
        }
      }
    }

    // ---- dX = dz . W0^T -> Xs -----------------------------------------
    if constexpr (std::is_same<T, float>::value) {
      // warp = row (its S points), lanes = X columns; W0^T staged in Wc
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
            d[s] = dzs[(size_t)(s * TN + warp) * DZW + j0 + jc];
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk) {
            const int k = lane + 32 * kk;
            if (k < XW) {
              const float w = Wc[jc * XWP + k];
#pragma unroll
              for (int s = 0; s < S; ++s)
                dx[s][kk] = fmaf(d[s], w, dx[s][kk]);
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
    } else {
      // tensor cores: warp -> one 16-row tile of dz and every wpm-th
      // 8-column tile of dX; W0 fragments read from w0big [XW, H]
      constexpr int MT = Rows<S>::MT;
      constexpr int WPM = (NT / 32) / MT;      // warps per 16-row tile
      constexpr int NXMAX = (32 * KMAX / 8 + WPM - 1) / WPM;
      const int mt = warp / WPM, part = warp % WPM;
      const int nxt = XW / 8;
      float dx[NXMAX][4];
#pragma unroll
      for (int i = 0; i < NXMAX; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) dx[i][q] = 0.f;
      __syncthreads();                         // dz complete; X read
      for (int j0 = 0; j0 < H; j0 += 16) {
        uint32_t a[4];
        ld_a(a, dzs, DZW, mt, j0, lane);
#pragma unroll
        for (int i = 0; i < NXMAX; ++i) {
          const int n = part + i * WPM;
          if (n < nxt) {
            const T* bp = w0big + (size_t)(8 * n + (lane >> 2)) * H + j0 +
                          2 * (lane & 3);
            mma_bf16(dx[i][0], dx[i][1], dx[i][2], dx[i][3], a,
                     ldg_pair(bp), ldg_pair(bp + 8));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NXMAX; ++i) {
        const int n = part + i * WPM;
        if (n < nxt) {
          const int row = 16 * mt + (lane >> 2);
          const int k = 8 * n + 2 * (lane & 3);
          if (row < S * TN) {
            Xs[row * XW + k] = dx[i][0];
            Xs[row * XW + k + 1] = dx[i][1];
          }
          if (row + 8 < S * TN) {
            Xs[(row + 8) * XW + k] = dx[i][2];
            Xs[(row + 8) * XW + k + 1] = dx[i][3];
          }
        }
      }
    }
    __syncthreads();
    // ---- product rule + hat-weight routing ---------------------------
    for (int idx = tid; idx < TN * C; idx += NT) {
      const int rr = idx / C, c = idx % C;
      const int row = row0 + rr;
      if (row >= N) continue;
      const T* vr = Vs + rr * VW;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float dPV[NPV], dLV[NLV];
#pragma unroll
        for (int v = 0; v < NPV; ++v) dPV[v] = 0.f;
#pragma unroll
        for (int v = 0; v < NLV; ++v) dLV[v] = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          int a, l;
          stencil_map(s, i, &a, &l);
          const float dxi = Cd<T>::rnd(Xs[(s * TN + rr) * XW + i * C + c]);
          const float pvv = Cd<T>::ld(vr, (i * NPV + a) * C + c);
          const float lvv = Cd<T>::ld(vr, 3 * NPV * C + (i * NLV + l) * C + c);
          dPV[a] = add<T>(dPV[a], mul<T>(dxi, lvv));
          dLV[l] = add<T>(dLV[l], mul<T>(dxi, pvv));
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const float* f = fr + (size_t)row * 2 * FS + b * FS;
          const float wgt = f[9];
          const float fu = f[2 * i], fv = f[2 * i + 1];
          const float su = f[10 + 2 * i], sv = f[11 + 2 * i];
          const float fx = f[6 + i], sx = f[16 + i];
          const float wv0[2] = {Cd<T>::rnd(__fmul_rn(wgt, hat(fv, 0))),
                                Cd<T>::rnd(__fmul_rn(wgt, hat(fv, 1)))};
          const float wu0[2] = {Cd<T>::rnd(__fmul_rn(wgt, hat(fu, 0))),
                                Cd<T>::rnd(__fmul_rn(wgt, hat(fu, 1)))};
          // dRv[ku]: centre and u-shifted variants (shared centre-v weights)
          float drv[4] = {0.f, 0.f, 0.f, 0.f};
          drv[1] = mul<T>(Cd<T>::rnd(hat(fu, 0)), dPV[0]);
          drv[2] = mul<T>(Cd<T>::rnd(hat(fu, 1)), dPV[0]);
          float dru[4] = {0.f, 0.f, 0.f, 0.f};
          if (S > 1) {
#pragma unroll
            for (int sg = 0; sg < 2; ++sg) {
              const float ru_ = __fadd_rn(fu, sg == 0 ? su : -su);
#pragma unroll
              for (int ku = -1; ku <= 2; ++ku)
                drv[ku + 1] = add<T>(drv[ku + 1],
                                     mul<T>(Cd<T>::rnd(hat(ru_, ku)),
                                            dPV[1 + sg]));
            }
#pragma unroll
            for (int sg = 0; sg < 2; ++sg) {
              const float rvv = __fadd_rn(fv, sg == 0 ? sv : -sv);
#pragma unroll
              for (int kv = -1; kv <= 2; ++kv)
                dru[kv + 1] = add<T>(dru[kv + 1],
                                     mul<T>(Cd<T>::rnd(hat(rvv, kv)),
                                            dPV[3 + sg]));
            }
          }
          T* dp = (T*)dP.p[b * 3 + i] + (size_t)row * 16 * C + c;
#pragma unroll
          for (int ku = -1; ku <= 2; ++ku) {
#pragma unroll
            for (int kv = -1; kv <= 2; ++kv) {
              float g = 0.f;
              if (kv == 0 || kv == 1) g = mul<T>(wv0[kv == 1 ? 1 : 0], drv[ku + 1]);
              if (S > 1 && (ku == 0 || ku == 1))
                g = add<T>(g, mul<T>(wu0[ku == 1 ? 1 : 0], dru[kv + 1]));
              Cd<T>::st(dp, (size_t)((ku + 1) * 4 + kv + 1) * C, g);
            }
          }
          float dline[4] = {0.f, 0.f, 0.f, 0.f};
          const float wgt_b = Cd<T>::rnd(wgt);
#pragma unroll
          for (int v = 0; v < NLV; ++v) {
            const float g = mul<T>(wgt_b, dLV[v]);
            if (v == 0) {
              dline[1] = add<T>(dline[1], mul<T>(Cd<T>::rnd(hat(fx, 0)), g));
              dline[2] = add<T>(dline[2], mul<T>(Cd<T>::rnd(hat(fx, 1)), g));
            } else {
              const float rx = __fadd_rn(fx, v == 1 ? sx : -sx);
#pragma unroll
              for (int k = -1; k <= 2; ++k)
                dline[k + 1] = add<T>(dline[k + 1],
                                      mul<T>(Cd<T>::rnd(hat(rx, k)), g));
            }
          }
          T* dl = (T*)dL.p[b * 3 + i] + (size_t)row * 4 * C + c;
#pragma unroll
          for (int k = 0; k < 4; ++k) Cd<T>::st(dl, (size_t)k * C, dline[k]);
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
      const int j = Own<T>::col(c, H, lane, warp);
      p_db0[w * H + j] = db_acc[c];
      p_dw1row[w * H + j] = w1r_acc[c];
    }
  }
}

// part[z] = A[k0:k1]^T . B[k0:k1] for K chunk z = blockIdx.z of kchunk
// rows; A [K, M] and B [K, Nc] row-major, each element rounded to T on
// load (a no-op where it is stored in T).
template <typename T, typename TA, typename TB>
__global__ void __launch_bounds__(256)
stencil_bwd_atb(int K, int M, int Nc, int kchunk,
                const TA* __restrict__ A, const TB* __restrict__ Bm,
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
      As[kk][mm] = (k < k_end && m0 + mm < M)
                       ? Cd<T>::rnd(Cd<TA>::ld(A, (size_t)k * M + m0 + mm))
                       : 0.f;
      Bs[kk][mm] = (k < k_end && n0 + mm < Nc)
                       ? Cd<T>::rnd(Cd<TB>::ld(Bm, (size_t)k * Nc + n0 + mm))
                       : 0.f;
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

// The same product for bf16 operands on the tensor cores: 64x64 output
// tiles, 8 warps of 32x16; A^T and B^T tiles staged in shared memory
// ([m][k] and [n][k], so that each mma fragment register is one 32-bit
// load), AK rows of K per stage.
template <typename TB>
__global__ void __launch_bounds__(256, 3)
stencil_bwd_atb_mma(int K, int M, int Nc, int kchunk,
                    const __nv_bfloat16* __restrict__ A,
                    const TB* __restrict__ Bm, float* __restrict__ part) {
  constexpr int LDS = AK + 8;                 // row stride: no bank conflicts
  __shared__ __align__(16) __nv_bfloat16 At[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bt[BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += AK) {
#pragma unroll
    for (int q = 0; q < AK * BM / 256; ++q) {
      const int idx = tid + 256 * q;
      const int kk = idx / BM, mm = idx % BM;
      const int k = k0 + kk;
      At[mm * LDS + kk] = (k < k_end && m0 + mm < M)
                              ? A[(size_t)k * M + m0 + mm]
                              : __float2bfloat16_rn(0.f);
      Bt[mm * LDS + kk] = __float2bfloat16_rn(
          (k < k_end && n0 + mm < Nc)
              ? Cd<TB>::ld(Bm, (size_t)k * Nc + n0 + mm) : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < AK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ld_a(a[i], At, LDS, 2 * wm + i, ks, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* bp =
            Bt + (wn * 16 + j * 8 + (lane >> 2)) * LDS + ks + 2 * (lane & 3);
        const uint32_t b0 = ld_pair(bp), b1 = ld_pair(bp + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_bf16(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3],
                   a[i], b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + wm * 32 + i * 16 + (lane >> 2);
      const int n = n0 + wn * 16 + j * 8 + 2 * (lane & 3);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int mq = m + (q >> 1) * 8, nq = n + (q & 1);
        if (mq < M && nq < Nc)
          part[((size_t)blockIdx.z * M + mq) * Nc + nq] = acc[i][j][q];
      }
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

namespace {

// Workspace carve-up (byte offsets, each 256-aligned).
struct Layout {
  int nblk, n_tiles;
  size_t xg, dzg, hg, p_db0, p_dw1row, p_dw0, p_dw1, total;
};

Layout layout(int es, int S, int n_sm, int N, int H, int O, int XW) {
  Layout L;
  L.n_tiles = (N + TN - 1) / TN;
  L.nblk = L.n_tiles < 2 * n_sm ? L.n_tiles : 2 * n_sm;
  const size_t rows = (size_t)L.n_tiles * TN;
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  L.xg = take(rows * S * XW * es);
  L.dzg = take(rows * S * H * es);
  L.hg = take(rows * H * es);
  L.p_db0 = take((size_t)L.nblk * TN * H * 4);
  L.p_dw1row = take((size_t)L.nblk * TN * H * 4);
  L.p_dw0 = take((size_t)NSPLIT * XW * H * 4);
  L.p_dw1 = take((size_t)NSPLIT * H * O * 4);
  L.total = off;
  return L;
}

template <typename T, typename TB>
cudaError_t atb(int K, int M, int Nc, const T* A, const TB* Bm, float* part,
                float* out, cudaStream_t stream) {
  int kchunk = (K + NSPLIT - 1) / NSPLIT;
  kchunk = (kchunk + AK - 1) / AK * AK;
  const int nsplit = (K + kchunk - 1) / kchunk;
  const dim3 grid((M + BM - 1) / BM, (Nc + BN - 1) / BN, nsplit);
  if constexpr (std::is_same<T, float>::value)
    stencil_bwd_atb<T, T, TB><<<grid, 256, 0, stream>>>(K, M, Nc, kchunk, A,
                                                         Bm, part);
  else
    stencil_bwd_atb_mma<TB><<<grid, 256, 0, stream>>>(K, M, Nc, kchunk, A,
                                                      Bm, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stencil_bwd_colsum<<<(M * Nc + 31) / 32, dim3(32, 8), 0, stream>>>(
      nsplit, M * Nc, part, out);
  return cudaGetLastError();
}

template <typename T, int S, int B>
cudaError_t launch(int n_sm, int N, int C, int E, int H, int O, int XW,
                   const float* fr, const void* V, const void* pe,
                   const float* rot, const void* w0big, const void* w0t,
                   const float* b0, const void* w1t, const void* w1row,
                   const float* g_c,
                   const float* g_off, void* const* dP, void* const* dL,
                   float* dpe, void* workspace, float* dw0, float* db0,
                   float* dw1, float* dw1row, cudaStream_t stream) {
  MPtrs6 P, Lp;
  for (int k = 0; k < 6; ++k) {
    P.p[k] = k < 3 * B ? dP[k] : nullptr;
    Lp.p[k] = k < 3 * B ? dL[k] : nullptr;
  }
  const Layout L = layout(sizeof(T), S, n_sm, N, H, O, XW);
  char* ws = static_cast<char*>(workspace);
  T* xg = reinterpret_cast<T*>(ws + L.xg);
  T* dzg = reinterpret_cast<T*>(ws + L.dzg);
  T* hg = reinterpret_cast<T*>(ws + L.hg);
  float* p_db0 = reinterpret_cast<float*>(ws + L.p_db0);
  float* p_dw1row = reinterpret_cast<float*>(ws + L.p_dw1row);
  const size_t smem = rows_smem<T, S>(C, E, H, O, XW);
  auto kern = stencil_bwd_rows<T, S, B>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<L.nblk, NT, smem, stream>>>(
      N, C, E, H, O, XW, fr, (const T*)V, (const T*)pe, rot,
      (const T*)w0big, (const T*)w0t, b0, (const T*)w1t, (const T*)w1row,
      g_c, g_off, P, Lp,
      dpe, xg, dzg, hg, p_db0, p_dw1row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int wr = L.nblk * TN;       // partial rows: (block, z row)
  stencil_bwd_colsum<<<(H + 31) / 32, dim3(32, 8), 0, stream>>>(wr, H, p_db0,
                                                                 db0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stencil_bwd_colsum<<<(H + 31) / 32, dim3(32, 8), 0, stream>>>(
      wr, H, p_dw1row, dw1row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dW0 over all S * n_tiles * TN workspace rows (pad rows carry dz = 0)
  err = atb<T, T>(L.n_tiles * TN * S, XW, H, xg, dzg,
                  reinterpret_cast<float*>(ws + L.p_dw0), dw0, stream);
  if (err != cudaSuccess) return err;
  return atb<T, float>(N, H, O, hg, g_c,
                       reinterpret_cast<float*>(ws + L.p_dw1), dw1, stream);
}

bool bad_shape(int dtype, int S, int B, int n_sm, int N, int C, int E, int H,
               int XW) {
  // the bf16 (tensor-core) path gives each warp H/8 columns in 8-wide tiles
  return (dtype != 0 && dtype != 1) || (S != 1 && S != 7) ||
         (B != 1 && B != 2) || H % 32 != 0 || (dtype == 1 && H % 64 != 0) ||
         H > 32 * JMAX || H % JC != 0 || XW % KC != 0 || XW > 32 * KMAX ||
         3 * C + E > XW || N <= 0 || n_sm <= 0;
}

}  // namespace

// Bytes of the device workspace stencil_head_bwd needs (the caller
// allocates it); 0 for shapes the kernels do not take.
extern "C" long long stencil_head_bwd_workspace(int dtype, int S, int B,
                                                int n_sm, int N, int C,
                                                int E, int H, int O,
                                                int XW) {
  if (bad_shape(dtype, S, B, n_sm, N, C, E, H, XW))
    return 0;
  return (long long)layout(dtype == 1 ? 2 : 4, S, n_sm, N, H, O, XW).total;
}

// dtype: 0 = float32, 1 = bfloat16.  w1t is W1 transposed [O, H]; dw0
// [XW, H], db0 [H], dw1 [H, O] and dw1row [H] are f32 outputs.  Returns a
// cudaError_t (0 = success).
extern "C" int stencil_head_bwd(int dtype, int S, int B, int n_sm, int N,
                                int C, int E, int H, int O, int XW,
                                const float* fr, const void* V,
                                const void* pe, const float* rot,
                                const void* w0big, const void* w0t,
                                const float* b0, const void* w1t,
                                const void* w1row, const float* g_c,
                                const float* g_off, void* const* dP,
                                void* const* dL, float* dpe, void* workspace, float* dw0, float* db0,
                                float* dw1, float* dw1row, void* stream) {
  if (bad_shape(dtype, S, B, n_sm, N, C, E, H, XW))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SH_CASE(TT, SS, BB)                                                  \
  return (int)launch<TT, SS, BB>(n_sm, N, C, E, H, O, XW, fr, V, pe, rot,    \
                                 w0big, w0t, b0, w1t, w1row, g_c, g_off, dP, \
                                 dL,                                         \
                                 dpe, workspace, dw0, db0, dw1, dw1row, st)
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
