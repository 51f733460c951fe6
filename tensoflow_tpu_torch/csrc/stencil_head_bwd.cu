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
// Bound on the H100: in bf16, bytes.  Per row it must read V, fr, pe and
// the output cotangents and write dP, dL and dpe (~7 KB at C=36 in bf16);
// its ~1.5 MFLOP per row sits below the tensor cores' op:byte balance.  In
// float32, operations (~1.5 MFLOP per row at the FMA pipe's 67 TFLOP/s).
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
// float32 (every published config's own gather_dtype): full float32 FMAs,
// held to the plain version in float64.
//   1. stencil_bwd_rows_f32 — one persistent block of 448 threads per SM
//      (128 registers, 217 KB of shared memory) walks tiles of 16 rows x 7
//      points = 112 X rows, X transposed in shared memory.  dh = g.W1^T for
//      the centre, then two passes over the hidden halves: z as 4x8
//      register blocks, softplus' on the registers, dz^T of the half into
//      shared memory, and dX += dz.W0^T as 4x9 blocks kept in registers
//      across the halves (one pass of 64 z accumulators beside dX spilled
//      at the 128-register cap).  W1^T, W0 and W0^T stream through a
//      two-slot cp.async ring of 32 rows (stencil_f32.cuh).  X (with a
//      ones column, so that db0 is the last row of dW0), dz, the centre h
//      and the padded centre cotangent go to a workspace; each thread's
//      dw1row terms are summed over its rows in registers and shared
//      memory.
//   2. stencil_bwd_atb_f32 — dW0 = X^T.dz and dW1^T = g^T.h over the
//      workspace: 144 x 128 output tiles of 288 threads, 8x8 a thread, both
//      operands staged 32 rows at a time through a two-slot cp.async ring,
//      one partial per split of K.
//   3. stencil_bwd_colsum — fixed-order sums of the partials (and of the
//      blocks' dw1row), so that two runs give bit-identical gradients.
// Both paths call the same tap arithmetic (stencil_common.cuh) and keep
// the TPU kernel's bf16 rounding points op by op.
//
// -DSH_SKIP_TAPS / -DSH_SKIP_SOFTPLUS / -DSH_SKIP_WORKSPACE (both row
// kernels), -DSH_SKIP_Z / -DSH_SKIP_LAYER1 / -DSH_SKIP_DX (the float32 row
// kernel's products) leave a phase out: wrong results, built only by
// bench/stencil_phases.py to time the rest.
#include "stencil_common.cuh"
#include "stencil_f32.cuh"
#include "stencil_sm90.cuh"

using namespace sh;

// ---------------------------------------------------------------------------
// float32
// ---------------------------------------------------------------------------

// One persistent block of 448 threads per SM walks tiles of 16 rows = 112
// X rows (row s*16 + r).  Per tile:
//   build  X^T from V into XT (and X, with its ones column, to the
//          workspace); the centre cotangent g^T into Gs (and, padded, to
//          the workspace);
//   dh     = g.W1^T for the 16 centre rows, 4x4 blocks, into DH;
//   then for each half p of the hidden columns:
//   z      = X.W0 + b0 over the half, 4x8 blocks (rows ry*4..; columns
//          128p + cx*4.., 128p + 64+cx*4..); softplus' on the registers:
//          dz = dh*sig (centre), g_off*w1row*sig (offsets), 0 (padding);
//          dz and the centre h to the workspace, dz^T into D; the offset
//          rows' h.g_off summed per thread (dw1row) in shared memory;
//   dX    += dz.W0^T over the half, 4x9 blocks (rows ry*4..; columns
//          cx*4.., 64+cx*4.., 128+cx), kept in registers across halves;
//   route  dX^T into XT (X is no longer read); product rule + transposed
//          hat weights -> dP, dL; dpe.
// Two halves keep 32 z and 36 dX accumulators a thread, so that 448
// threads stay within 128 registers.  W1^T, W0 and W0^T stream through
// the ring (stencil_f32.cuh).
template <int S, int B>
__global__ void __launch_bounds__(f32k::BWD_NT, 1)
stencil_bwd_rows_f32(int N, int C, int E, int O,
                     const float* __restrict__ fr,
                     const float* __restrict__ V,
                     const float* __restrict__ pe,
                     const float* __restrict__ rot,
                     const float* __restrict__ w0,
                     const float* __restrict__ w0t,
                     const float* __restrict__ b0,
                     const float* __restrict__ w1t,
                     const float* __restrict__ w1row,
                     const float* __restrict__ g_c,
                     const float* __restrict__ g_off, MPtrs6 dP, MPtrs6 dL,
                     float* __restrict__ dpe, float* __restrict__ xg,
                     float* __restrict__ dzg, float* __restrict__ hg,
                     float* __restrict__ gcg,
                     float* __restrict__ p_dw1row) {
  using T = float;
  using namespace f32k;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
  constexpr int NW = BWD_NT / 32;
  float* XT = reinterpret_cast<float*>(smem_raw);  // X^T, then dX^T [XF][MS]
  float* D = XT + XF * MS;                   // dz^T of one half [128][MS]
  float* ring = D + 128 * MS;                // [BSTAGE][BWD_SLOT]
  float* Gs = ring + BSTAGE * BWD_SLOT;      // g_c^T [OF][TR]
  float* DH = Gs + OF * TR;                  // dh [TR][HF]
  float* W1A = DH + TR * HF;                 // [16][BWD_NT] dw1row sums
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ry = tid >> 4, cx = tid & 15;    // 4-row, 8/9-column blocks
  const int VW = (NPV + NLV) * 3 * C;
  const int K0 = 3 * C + E, XK = round4(K0), OK = round4(O);
  const int nko = (OK + KH - 1) / KH, nkc = (XK + BKC - 1) / BKC;
  const int nhalf = nkc + 128 / BKC;         // ring chunks of one half
  const int nch = nko + 2 * nhalf;           // ring chunks per tile
  const int n_tiles = (N + TR - 1) / TR;
  // this thread's dw1row sums, per half and column, over its rows: in
  // shared memory (registers are the scarcer resource here)
#pragma unroll
  for (int j = 0; j < 16; ++j) W1A[j * BWD_NT + tid] = 0.f;

  int g = 0;                                 // ring chunks consumed
  auto fetch = [&](int ga) {
    const int q = ga % nch;
    float* slot = ring + (ga % BSTAGE) * BWD_SLOT;
    if (q < nko) {                           // W1^T rows o0.., 256 wide
      const int o0 = q * KH, kn = min(KH, OK - o0);
      for (int idx = tid; idx < kn * (HF / 4); idx += BWD_NT) {
        const int r = idx / (HF / 4), c4 = (idx % (HF / 4)) * 4;
        cp16(slot + r * HF + c4, w1t + (size_t)(o0 + r) * HF + c4);
      }
    } else {
      const int p = (q - nko) / nhalf, q3 = (q - nko) % nhalf;
      if (q3 < nkc) {                        // W0 rows k0.., half p
        const int k0 = q3 * BKC, kn = min(BKC, XK - k0);
        for (int idx = tid; idx < kn * 32; idx += BWD_NT) {
          const int r = idx >> 5, c4 = (idx & 31) * 4;
          cp16(slot + r * 128 + c4,
               w0 + (size_t)(k0 + r) * HF + 128 * p + c4);
        }
      } else {                               // W0^T rows j0.., XF wide
        const int j0 = 128 * p + (q3 - nkc) * BKC;
        for (int idx = tid; idx < BKC * (XF / 4); idx += BWD_NT) {
          const int r = idx / (XF / 4), c4 = (idx % (XF / 4)) * 4;
          cp16(slot + r * XF + c4, w0t + (size_t)(j0 + r) * XF + c4);
        }
      }
    }
    cp_commit();
  };
  auto next_chunk = [&]() -> const float* {
    cp_wait<BSTAGE - 2>();
    __syncthreads();
    fetch(g + BSTAGE - 1);
    return ring + (g++ % BSTAGE) * BWD_SLOT;
  };
  for (int q = 0; q < BSTAGE - 1; ++q) fetch(q);
  // Start late by 0-98 us, spread over the blocks, so that the blocks'
  // memory-bound phases (build, routing) and FMA-bound ones (z, dX) do not
  // run in step across the card (measured: 8.70 -> 8.41 ms at B=2, 7.51 ->
  // 6.94 ms at B=1, N=131,072, on an NVIDIA H100 80GB HBM3 at 700 W;
  // bench/stencil_phases.py).
  for (int w = (blockIdx.x * 37) % 64 * 100 / 64; w > 0; w -= 5)
    __nanosleep(5000);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    const size_t xr0 = (size_t)tile * S * TR;     // workspace row of (0, 0)
    __syncthreads();                 // the last tile's readers of XT are done
#ifndef SH_SKIP_TAPS
    // ---- build: X^T from V, X to the workspace --------------------------
    for (int q = warp; q < tap_groups(C); q += NW) {
      int rr, c;
      tap_item(q, lane, &rr, &c);
      if (c >= C) continue;
      const int row = row0 + rr;
      const bool ok = row < N;
      const float* vr = V + (size_t)row * VW + c;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float pv[NPV], lv[NLV], x[S];
#pragma unroll
        for (int v = 0; v < NPV; ++v)
          pv[v] = ok ? __ldg(vr + (i * NPV + v) * C) : 0.f;
#pragma unroll
        for (int v = 0; v < NLV; ++v)
          lv[v] = ok ? __ldg(vr + 3 * NPV * C + (i * NLV + v) * C) : 0.f;
        x_products<F32, S>(i, pv, lv, x);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          XT[(i * C + c) * MS + s * TR + rr] = x[s];
          xg[(xr0 + s * TR + rr) * XF + i * C + c] = x[s];
        }
      }
    }
    for (int idx = tid; idx < TR * E; idx += BWD_NT) {
      const int rr = idx / E, e = idx % E;
      float p0, pm3, pp3;
      pe_row(pe, row0 + rr, N, e, E, &p0, &pm3, &pp3);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float x = pe_point<T>(s, e, E, p0, pm3, pp3, rot);
        XT[(3 * C + e) * MS + s * TR + rr] = x;
        xg[(xr0 + s * TR + rr) * XF + 3 * C + e] = x;
      }
    }
#endif  // SH_SKIP_TAPS
    // pad rows of X^T up to XK: zero (XT held dX last tile)
    for (int idx = tid; idx < (XK - K0) * MT; idx += BWD_NT)
      XT[(K0 + idx / MT) * MS + idx % MT] = 0.f;
    // pad columns of X in the workspace: zero, the last one all ones
#ifndef SH_SKIP_WORKSPACE
    for (int idx = tid; idx < S * TR * (XF - K0); idx += BWD_NT) {
      const int col = K0 + idx % (XF - K0);
      xg[(xr0 + idx / (XF - K0)) * XF + col] = col == XF - 1 ? 1.f : 0.f;
    }
#endif
    // the centre cotangent: g^T into Gs (zero past O and N), padded to OF
    // columns in the workspace
    for (int idx = tid; idx < TR * OF; idx += BWD_NT) {
      const int r = idx / OF, o = idx % OF;
      const int row = row0 + r;
      const float v = (row < N && o < O) ? __ldg(g_c + (size_t)row * O + o)
                                         : 0.f;
      Gs[o * TR + r] = v;
#ifndef SH_SKIP_WORKSPACE
      gcg[((size_t)tile * TR + r) * OF + o] = v;
#endif
    }

    // ---- dh = g.W1^T: 16 rows x HF as 4x4 blocks -> DH -------------------
    {
      const bool act = tid < (TR / 4) * (HF / 4);
      const int hy = tid / (HF / 4), hx = tid % (HF / 4);
      float dh[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dh[i][j] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < nko; ++kc) {
        const float* W = next_chunk();
#ifndef SH_SKIP_LAYER1
        if (act)
          fma_4x4(dh, Gs + kc * KH * TR, TR, hy * 4, W, HF, hx * 4,
                  min(KH, OK - kc * KH));
#endif
      }
      if (act) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st4(DH + (hy * 4 + i) * HF + hx * 4, dh[i][0], dh[i][1], dh[i][2],
              dh[i][3]);
      }
    }

    float dx[4][9];                          // dX = dz.W0^T, both halves
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 9; ++j) dx[i][j] = 0.f;
#pragma unroll 1
    for (int p = 0; p < 2; ++p) {
      // ---- z = X.W0 + b0 over the half ------------------------------------
      float acc[4][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bj =
            __ldg(b0 + 128 * p + (j < 4 ? cx * 4 + j : 64 + cx * 4 + j - 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = bj;
      }
#pragma unroll 1
      for (int kc = 0; kc < nkc; ++kc) {
        const float* W = next_chunk();
#ifndef SH_SKIP_Z
        fma_4x8(acc, XT + kc * BKC * MS, MS, ry * 4, W, 128, cx * 4,
                64 + cx * 4, min(BKC, XK - kc * BKC));
#endif
      }
      // ---- softplus' -> dz; workspace; dz^T into D -----------------------
      // (D's last readers, the previous half's dX, passed a ring barrier)
      float w1p[8];                          // this half's dw1row terms
#pragma unroll
      for (int j = 0; j < 8; ++j) w1p[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ry * 4 + i;
        const int s = m / TR, r = m % TR, row = row0 + r;
        const float go = (s >= 1 && s < S && row < N)
                             ? __ldg(g_off + (size_t)(s - 1) * N + row)
                             : 0.f;
        float hv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = 128 * p + (j < 4 ? cx * 4 + j : 64 + cx * 4 + j - 4);
          float h = acc[i][j], sig = 1.f, dz = 0.f;
#ifndef SH_SKIP_SOFTPLUS
          softplus100(100.f * acc[i][j], &h, &sig);
#endif
          hv[j] = h;
          if (s == 0) {
            dz = DH[r * HF + n] * sig;
          } else if (s < S) {
            w1p[j] = fmaf(h, go, w1p[j]);
            dz = go * __ldg(w1row + n) * sig;
          }
          acc[i][j] = dz;
        }
#ifndef SH_SKIP_WORKSPACE
        if (s == 0) {
          float* hr = hg + ((size_t)tile * TR + r) * HF + 128 * p;
          st4(hr + cx * 4, hv[0], hv[1], hv[2], hv[3]);
          st4(hr + 64 + cx * 4, hv[4], hv[5], hv[6], hv[7]);
        }
        if (s < S) {
          float* dr = dzg + (xr0 + m) * HF + 128 * p;
          st4(dr + cx * 4, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          st4(dr + 64 + cx * 4, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
#endif
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nl = j < 4 ? cx * 4 + j : 64 + cx * 4 + j - 4;
        st4(D + nl * MS + ry * 4, acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        W1A[(p * 8 + j) * BWD_NT + tid] += w1p[j];
      }
      // ---- dX += dz.W0^T over the half ------------------------------------
#pragma unroll 1
      for (int kc = 0; kc < 128 / BKC; ++kc) {
        const float* W = next_chunk();
#ifndef SH_SKIP_DX
        fma_4x9<BKC>(dx, D + kc * BKC * MS, MS, ry * 4, W, XF, cx * 4,
                     64 + cx * 4, 128 + cx);
#endif
      }
    }
    // ---- dX^T into XT (its readers, the second half's z, passed a ring
    // barrier) ------------------------------------------------------------
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int k = j < 4 ? cx * 4 + j : (j < 8 ? 64 + cx * 4 + j - 4
                                                : 128 + cx);
      st4(XT + k * MS + ry * 4, dx[0][j], dx[1][j], dx[2][j], dx[3][j]);
    }
    __syncthreads();
#ifndef SH_SKIP_TAPS
    // ---- product rule + hat-weight routing -----------------------------
    for (int q = warp; q < tap_groups(C); q += NW) {
      int rr, c;
      tap_item(q, lane, &rr, &c);
      const int row = row0 + rr;
      if (c >= C || row >= N) continue;
      const float* vr = V + (size_t)row * VW + c;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float pv[NPV], lv[NLV], dxs[S], dPV[NPV], dLV[NLV];
#pragma unroll
        for (int v = 0; v < NPV; ++v) pv[v] = __ldg(vr + (i * NPV + v) * C);
#pragma unroll
        for (int v = 0; v < NLV; ++v)
          lv[v] = __ldg(vr + 3 * NPV * C + (i * NLV + v) * C);
#pragma unroll
        for (int s = 0; s < S; ++s) dxs[s] = XT[(i * C + c) * MS + s * TR + rr];
        product_rule<F32, S>(i, dxs, pv, lv, dPV, dLV);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const Frac q2 = load_frac(fr + (size_t)row * 2 * FS + b * FS, i);
          float gg[16], dline[4];
          route_plane<F32, S>(dPV, q2, gg);
          route_line<F32, S>(dLV, q2, dline);
          T* dp = (T*)dP.p[b * 3 + i] + (size_t)row * 16 * C + c;
#pragma unroll
          for (int k = 0; k < 16; ++k) dp[(size_t)k * C] = gg[k];
          T* dl = (T*)dL.p[b * 3 + i] + (size_t)row * 4 * C + c;
#pragma unroll
          for (int k = 0; k < 4; ++k) dl[(size_t)k * C] = dline[k];
        }
      }
    }
    // ---- dpe: adjoint of the trig-addition PE offsets ------------------
    for (int idx = tid; idx < TR * E; idx += BWD_NT) {
      const int rr = idx / E, e = idx % E;
      const int row = row0 + rr;
      if (row >= N) continue;
      const float* P = XT + (3 * C) * MS + rr;    // dX^T of the PE columns
      float a = P[e * MS];
      for (int s = 1; s < S; ++s) {
        const float* R = rot + (size_t)s * 4 * E;
        const int em = (e + E - 3) % E, ep = (e + 3) % E;
        const float t0 = __fmul_rn(P[e * MS + s * TR], R[e]);
        const float t1 = __fmul_rn(P[em * MS + s * TR], R[E + em]);
        const float t2 = __fmul_rn(P[ep * MS + s * TR], R[2 * E + ep]);
        a = __fadd_rn(__fadd_rn(__fadd_rn(a, t0), t1), t2);
      }
      dpe[(size_t)row * E + e] = a;
    }
#endif  // SH_SKIP_TAPS
  }
  cp_wait<0>();                              // never leave a copy in flight
  // ---- this block's dw1row: the 28 row groups summed in order -----------
  __syncthreads();
  for (int n = tid; n < HF; n += BWD_NT) {
    const int p = n >> 7, nl = n & 127;
    const int j = (nl < 64 ? 0 : 4) + (nl & 3), c = (nl & 63) >> 2;
    float t = 0.f;
    for (int y = 0; y < MT / 4; ++y)
      t += W1A[(p * 8 + j) * BWD_NT + y * 16 + c];
    p_dw1row[(size_t)blockIdx.x * HF + n] = t;
  }
}

// part[z] = A[k0:k1]^T . B[k0:k1][128x:128x+128] for the K chunk z =
// blockIdx.y of kchunk rows and the column half x = blockIdx.x: A [K, XF]
// and B [K, HF] row-major float32, part [nsplit, XF, HF].  A 144 x 128
// output tile, 8x8 a thread (rows ty*4.., 72+ty*4..; columns tx*4..,
// 64+tx*4..), both operands staged 32 rows at a time through a two-slot
// cp.async ring (rows past the chunk are zero filled).
__global__ void __launch_bounds__(f32k::ATB_NT, 2)
stencil_bwd_atb_f32(int K, int kchunk, const float* __restrict__ A,
                    const float* __restrict__ Bm, float* __restrict__ part) {
  using namespace f32k;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [ASTAGE][ATB_SLOT]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int c0 = 128 * blockIdx.x;
  const int k_begin = blockIdx.y * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int n_it = (k_end - k_begin + AKC - 1) / AKC;
  auto fetch = [&](int it) {
    float* As = ring + (it % ASTAGE) * ATB_SLOT;
    float* Bs = As + AKC * XF;
    const int k0 = k_begin + it * AKC;
    if (it < n_it) {
      for (int idx = tid; idx < AKC * (XF / 4); idx += ATB_NT) {
        const int r = idx / (XF / 4), c4 = (idx % (XF / 4)) * 4;
        const bool ok = k0 + r < k_end;
        cp16(As + r * XF + c4, ok ? A + (size_t)(k0 + r) * XF + c4 : A, ok);
      }
      for (int idx = tid; idx < AKC * 32; idx += ATB_NT) {
        const int r = idx >> 5, c4 = (idx & 31) * 4;
        const bool ok = k0 + r < k_end;
        cp16(Bs + r * 128 + c4,
             ok ? Bm + (size_t)(k0 + r) * HF + c0 + c4 : Bm, ok);
      }
    }
    cp_commit();
  };
  for (int q = 0; q < ASTAGE - 1; ++q) fetch(q);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int it = 0; it < n_it; ++it) {
    cp_wait<ASTAGE - 2>();
    __syncthreads();
    fetch(it + ASTAGE - 1);
    const float* As = ring + (it % ASTAGE) * ATB_SLOT;
    fma_8x8(acc, As, XF, ty * 4, 72 + ty * 4, As + AKC * XF, 128, tx * 4,
            64 + tx * 4, AKC);
  }
  cp_wait<0>();
  float* out = part + (size_t)blockIdx.y * XF * HF + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = i < 4 ? ty * 4 + i : 72 + ty * 4 + i - 4;
    st4(out + (size_t)m * HF + tx * 4, acc[i][0], acc[i][1], acc[i][2],
        acc[i][3]);
    st4(out + (size_t)m * HF + 64 + tx * 4, acc[i][4], acc[i][5], acc[i][6],
        acc[i][7]);
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
  size_t xg, dzg, hg, gcg, p_dw1row, p_dw0, p_dw1, total;
};

size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off += (bytes + 255) / 256 * 256;
  return at;
}

// float32: per tile X [S*TR, XF], dz [S*TR, HF], the centre h [TR, HF]
// and cotangent [TR, OF]; one dw1row partial per block; the split-K
// partials of dW0 and dW1^T [nsplit, XF, HF] each.
int atb_splits(int n_sm, int K, int* kchunk) {
  int ns = (K + 255) / 256;
  if (ns > n_sm) ns = n_sm;
  if (ns < (K + f32k::AKMAX - 1) / f32k::AKMAX)
    ns = (K + f32k::AKMAX - 1) / f32k::AKMAX;
  int kc = (K + ns - 1) / ns;
  kc = (kc + f32k::AKC - 1) / f32k::AKC * f32k::AKC;
  *kchunk = kc;
  return (K + kc - 1) / kc;
}

Layout layout_f32(int S, int n_sm, int per_sm, int N) {
  using namespace f32k;
  Layout L = {};
  L.n_tiles = (N + TR - 1) / TR;
  L.nblk = L.n_tiles < per_sm * n_sm ? L.n_tiles : per_sm * n_sm;
  int kc;
  L.nblk_dw0 = atb_splits(n_sm, L.n_tiles * S * TR, &kc);
  L.nblk_dw1 = atb_splits(n_sm, L.n_tiles * TR, &kc);
  const size_t rows = (size_t)L.n_tiles * TR;
  size_t off = 0;
  L.xg = take(&off, rows * S * XF * 4);
  L.dzg = take(&off, rows * S * HF * 4);
  L.hg = take(&off, rows * HF * 4);
  L.gcg = take(&off, rows * OF * 4);
  L.p_dw1row = take(&off, (size_t)L.nblk * HF * 4);
  L.p_dw0 = take(&off, (size_t)L.nblk_dw0 * XF * HF * 4);
  L.p_dw1 = take(&off, (size_t)L.nblk_dw1 * XF * HF * 4);
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

// out [XF, HF] = A^T . B over K rows (A [K, XF], B [K, HF]): split-K
// partials, then their fixed-order column sums.
cudaError_t atb_f32(int n_sm, int K, const float* A, const float* Bm,
                    float* part, float* out, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        stencil_bwd_atb_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)f32k::SMEM_ATB);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  int kchunk;
  const int ns = atb_splits(n_sm, K, &kchunk);
  stencil_bwd_atb_f32<<<dim3(f32k::HF / 128, ns), f32k::ATB_NT,
                        f32k::SMEM_ATB, stream>>>(K, kchunk, A, Bm, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return colsum(ns, f32k::XF * f32k::HF, part, out, stream);
}

struct Args {
  int n_sm, N, C, E, H, O, XW;
  const float* fr;
  const void *V, *pe;
  const float* rot;
  const void *w0, *w0t;
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
int rows_per_sm_f32() {
  static int per_sm = 0;                     // blocks per SM, asked once
  if (per_sm == 0) {
    int info[4];
    if (f32k::kernel_info(stencil_bwd_rows_f32<S, B>, f32k::BWD_NT,
                          f32k::SMEM_BWD, info) != 0)
      return 0;
    per_sm = info[0];
  }
  return per_sm;
}

template <int S, int B>
cudaError_t launch_f32(const Args& a) {
  using namespace f32k;
  const int per_sm = rows_per_sm_f32<S, B>();
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const Layout L = layout_f32(S, a.n_sm, per_sm, a.N);
  float* xg = reinterpret_cast<float*>(a.ws + L.xg);
  float* dzg = reinterpret_cast<float*>(a.ws + L.dzg);
  float* hg = reinterpret_cast<float*>(a.ws + L.hg);
  float* gcg = reinterpret_cast<float*>(a.ws + L.gcg);
  float* p_dw1row = reinterpret_cast<float*>(a.ws + L.p_dw1row);
  stencil_bwd_rows_f32<S, B><<<L.nblk, BWD_NT, SMEM_BWD, a.stream>>>(
      a.N, a.C, a.E, a.O, a.fr, (const float*)a.V, (const float*)a.pe,
      a.rot, (const float*)a.w0, (const float*)a.w0t, a.b0,
      (const float*)a.w1, (const float*)a.w1row, a.g_c, a.g_off, a.dP, a.dL,
      a.dpe, xg, dzg, hg, gcg, p_dw1row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = colsum(L.nblk, HF, p_dw1row, a.dw1row, a.stream);
  if (err != cudaSuccess) return err;
  // dW0 (its last row is db0) over all S * 16 rows of every tile, and
  // dW1^T over the centre rows; padding rows carry dz = 0 and g = 0
  err = atb_f32(a.n_sm, L.n_tiles * S * TR, xg, dzg,
                reinterpret_cast<float*>(a.ws + L.p_dw0), a.dw0, a.stream);
  if (err != cudaSuccess) return err;
  return atb_f32(a.n_sm, L.n_tiles * TR, gcg, hg,
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
    return C < 1 || E < 1 || 3 * C + E >= f32k::XF || H > f32k::HF ||
           O > f32k::OF || XW != f32k::XF;
  if (dtype == 1)
    return C % 4 != 0 || 3 * C + E >= XP || E > PEW || H > HP || O > OP ||
           XW != XP;
  return true;
}

int per_sm_f32(int S, int B) {
  if (S == 7)
    return B == 1 ? rows_per_sm_f32<7, 1>() : rows_per_sm_f32<7, 2>();
  return B == 1 ? rows_per_sm_f32<1, 1>() : rows_per_sm_f32<1, 2>();
}

}  // namespace

// Bytes of the device workspace stencil_head_bwd needs (the caller
// allocates it); 0 for shapes the kernels do not take.
extern "C" long long stencil_head_bwd_workspace(int dtype, int S, int B,
                                                int n_sm, int N, int C,
                                                int E, int H, int O,
                                                int XW) {
  if (bad_shape(dtype, S, B, n_sm, N, C, E, H, O, XW)) return 0;
  if (dtype == 1) return (long long)layout_bf16(S, n_sm, N).total;
  const int per_sm = per_sm_f32(S, B);
  return per_sm > 0 ? (long long)layout_f32(S, n_sm, per_sm, N).total : 0;
}

// dtype 0 = float32: the padded operands of ops/stencil.py
// pack_weights_f32: w0 [XF, HF], w0t = W0^T [HF, XF], b0 [HF], w1 = W1^T
// [OF, HF], w1row [HF]; outputs dw0 [XF, HF] whose last row is db0 (db0
// itself is not written), dw1 = dW1^T [XF, HF], dw1row [HF].
// dtype 1 = bfloat16: w0 and w1 are the padded, tiled operands of
// ops/stencil.py pack_weights_bf16, w0t unused, b0 and w1row [HP] float32,
// zero padded; outputs dw0 = dW0^T [HP, XP] whose last column is db0 (db0
// itself is not written), dw1 [HP, OP], dw1row [HP].  All outputs f32.
// Returns a cudaError_t (0 = success).
extern "C" int stencil_head_bwd(int dtype, int S, int B, int n_sm, int N,
                                int C, int E, int H, int O, int XW,
                                const float* fr, const void* V,
                                const void* pe, const float* rot,
                                const void* w0, const void* w0t,
                                const float* b0, const void* w1,
                                const void* w1row, const float* g_c,
                                const float* g_off, void* const* dP,
                                void* const* dL, float* dpe,
                                void* workspace, float* dw0, float* db0,
                                float* dw1, float* dw1row, void* stream) {
  if (bad_shape(dtype, S, B, n_sm, N, C, E, H, O, XW))
    return (int)cudaErrorInvalidValue;
  Args a = {n_sm, N,  C,   E,     H,   O,     XW, fr, V,  pe,
            rot,  w0, w0t, b0,    w1,  w1row, g_c, g_off, {}, {},
            dpe,  static_cast<char*>(workspace), dw0, db0, dw1, dw1row,
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

// A float32 backward kernel's blocks per SM, registers a thread, local
// (spill) bytes a thread and shared memory a block, into out[0..3]:
// which 0 = the row kernel (S in {1, 7}, B in {1, 2}), 1 = the weight-
// gradient product.  Returns a cudaError_t (0 = success).
extern "C" int stencil_head_bwd_f32_info(int which, int S, int B, int* out) {
  if (which == 1)
    return f32k::kernel_info(stencil_bwd_atb_f32, f32k::ATB_NT,
                             f32k::SMEM_ATB, out);
#define SH_INFO(SS, BB)                                                      \
  if (which == 0 && S == SS && B == BB)                                      \
    return f32k::kernel_info(stencil_bwd_rows_f32<SS, BB>, f32k::BWD_NT,     \
                             f32k::SMEM_BWD, out)
  SH_INFO(7, 1);
  SH_INFO(7, 2);
  SH_INFO(1, 1);
  SH_INFO(1, 2);
#undef SH_INFO
  return (int)cudaErrorInvalidValue;
}
