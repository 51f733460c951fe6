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
// Bound on the H100: in bf16, bytes.  Per row it must read 60C patch
// values plus fr/pe (~4.5 KB at C=36 in bf16) and write out_c, out_off and
// V (~2.3 KB); its ~0.5 MFLOP per row sits far below the tensor cores'
// op:byte balance.  In float32, operations: the same ~0.5 MFLOP per row at
// the 67 TFLOP/s of the FMA pipe take longer than its ~21.6 KB per row
// (B=2) at 3.35 TB/s.
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
// float32 (stencil_fwd_f32, every published config's own gather_dtype):
// full float32 FMAs, no tensor cores (TF32 would change the arithmetic the
// reference defines), held to the plain version in float64.  Persistent
// blocks of 448 threads, two per SM (72 registers a thread, 111 KB of
// shared memory a block), walk tiles of 16 rows x 7 stencil points = 112
// X rows.  A warp's taps cover 4 rows x 8 channels (32-byte loads) and
// write X transposed into shared memory; z = X.W0 runs in two passes over
// the hidden halves as 4x8 register blocks a thread (three float4 shared
// loads for 32 FMAs), over W0 streamed through a two-slot cp.async ring of
// 24 rows (stencil_f32.cuh); softplus from the special-function unit;
// the offsets' sdf column by a fixed-order warp reduction; layer 1 as
// 4x4 blocks over streamed W1, split over its K between two thread groups.
// Its taps are bound by device memory and its products by the FMA pipe;
// the two overlap only as far as the blocks run out of phase (PERF.md).
// Both types call the same tap arithmetic (stencil_common.cuh) and keep
// the TPU kernel's bf16 rounding points op by op.
//
// -DSH_SKIP_TAPS / -DSH_SKIP_SOFTPLUS (both kernels), -DSH_SKIP_Z /
// -DSH_SKIP_LAYER1 (the float32 kernel's products) leave a phase out:
// wrong results, built only by bench/stencil_phases.py to time the rest.
#include "stencil_common.cuh"
#include "stencil_f32.cuh"
#include "stencil_sm90.cuh"

using namespace sh;

// ---------------------------------------------------------------------------
// float32
// ---------------------------------------------------------------------------

// Persistent blocks of 448 threads, two per SM, walk tiles of 16 rows = 112
// X rows.  Per tile: the taps write X^T into shared memory; z = X.W0 + b0
// in two passes over the hidden halves, each thread a 4x8 register block
// (rows ry*4..; columns cx*4.., 64+cx*4.. of the half) fed by three float4
// loads a k; softplus on the registers: the centre's h goes to shared
// memory, the offset points' sdf column is summed against w1row in
// registers and then across the 16 column threads of a row by a
// fixed-order warp reduction; layer 1 of the centre as 4x4 register blocks
// over W1 chunks, split over its K (the hidden width) between two thread
// groups whose partials are added in a fixed order.  W0 and W1 stream
// through the ring (stencil_f32.cuh).  32 accumulators a thread keep 28
// warps a SM within 72 registers.
template <int S, int B>
__global__ void __launch_bounds__(f32k::FWD_NT, 2)
stencil_fwd_f32(int N, int C, int E, int O, Ptrs6 pp, Ptrs6 lp,
                const float* __restrict__ fr, const float* __restrict__ pe,
                const float* __restrict__ rot, const float* __restrict__ w0,
                const float* __restrict__ b0, const float* __restrict__ w1,
                const float* __restrict__ w1row, float* __restrict__ out_c,
                float* __restrict__ out_off, float* __restrict__ v_out) {
  using T = float;
  using namespace f32k;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
  constexpr int NW = FWD_NT / 32;
  constexpr int L1U = 2 * (TR / 4) * (OF / 4);   // layer-1 units: 288
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* Xs = reinterpret_cast<float*>(smem_raw);   // X^T [XF][MS]
  float* ring = Xs + XF * MS;                // [FSTAGE][FWD_SLOT]
  float* Hc = ring + FSTAGE * FWD_SLOT;      // centre h^T [HF][TR]
  const int ry = tid >> 4, cx = tid & 15;
  const int VW = (NPV + NLV) * 3 * C;
  const int K0 = 3 * C + E, XK = round4(K0);
  const int nkc = (XK + FKC - 1) / FKC;
  const int nk1 = (128 + FKC / 2 - 1) / (FKC / 2);   // W1 chunks
  const int nch = 2 * nkc + nk1;             // ring chunks per tile
  const int n_tiles = (N + TR - 1) / TR;

  // X^T is zero where no tap writes: pad rows k >= 3C+E, and for S=1 the
  // X rows m >= 16
  for (int idx = tid; idx < XF * MS; idx += FWD_NT) Xs[idx] = 0.f;
  __syncthreads();
  int g = 0;                                 // ring chunks consumed
  auto fetch = [&](int ga) {
    const int q = ga % nch;
    float* slot = ring + (ga % FSTAGE) * FWD_SLOT;
    if (q < 2 * nkc) {                       // W0 [k0.., 128p..128p+127]
      const int p = q / nkc, k0 = (q % nkc) * FKC;
      const int kn = min(FKC, XK - k0);
      for (int idx = tid; idx < kn * 32; idx += FWD_NT) {
        const int r = idx >> 5, c4 = (idx & 31) * 4;
        cp16(slot + r * 128 + c4, w0 + (size_t)(k0 + r) * HF + 128 * p + c4);
      }
    } else {                                 // W1 rows j0.. and 128+j0..
      const int j0 = (q - 2 * nkc) * (FKC / 2);
      const int kn = min(FKC / 2, 128 - j0);
      for (int idx = tid; idx < 2 * kn * (OF / 4); idx += FWD_NT) {
        const int r = idx / (OF / 4), c4 = (idx % (OF / 4)) * 4;
        const int j = r < kn ? j0 + r : 128 + j0 + r - kn;
        cp16(slot + r * OF + c4, w1 + (size_t)j * OF + c4);
      }
    }
    cp_commit();
  };
  auto next_chunk = [&]() -> const float* {
    cp_wait<FSTAGE - 2>();
    __syncthreads();
    fetch(g + FSTAGE - 1);
    return ring + (g++ % FSTAGE) * FWD_SLOT;
  };
  for (int q = 0; q < FSTAGE - 1; ++q) fetch(q);
  // Start late by 0-59 us, spread over the blocks.  Started together, the
  // blocks run their memory-bound taps and their FMA-bound products in
  // step across the card; offset starts let some blocks' taps run beside
  // others' products (measured: 3.46 -> 3.34 ms a call at B=2, N=131,072
  // on an NVIDIA H100 80GB HBM3 at 700 W, bench/stencil_phases.py).
  for (int w = (blockIdx.x * 37) % 64 * 60 / 64; w > 0; w -= 5)
    __nanosleep(5000);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
#ifndef SH_SKIP_TAPS
    // ---- taps: (row, channel) items, written to X^T and V --------------
    // (the last tile's readers of Xs and Hc have passed a ring barrier)
    for (int q = warp; q < tap_groups(C); q += NW) {
      int rr, c;
      tap_item(q, lane, &rr, &c);
      if (c >= C) continue;
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
            const Frac q2 = load_frac(f, i);
            const T* P = (const T*)pp.p[b * 3 + i] + (size_t)row * 16 * C + c;
            float sl[16], pv[NPV];
#pragma unroll
            for (int k = 0; k < 16; ++k) sl[k] = __ldg(P + (size_t)k * C);
            plane_variants<F32, S>(sl, q2, pv);
#pragma unroll
            for (int v = 0; v < NPV; ++v)
              PV[i][v] = (b == 0) ? pv[v] : F32::add(PV[i][v], pv[v]);
            const T* L = (const T*)lp.p[b * 3 + i] + (size_t)row * 4 * C + c;
            float ls[4], lv[NLV];
#pragma unroll
            for (int k = 0; k < 4; ++k) ls[k] = __ldg(L + (size_t)k * C);
            line_variants<F32, S>(ls, q2, lv);
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
        for (int s = 0; s < S; ++s) Xs[(i * C + c) * MS + s * TR + rr] = x[s];
      }
    }
    // ---- PE columns of X ------------------------------------------------
    for (int idx = tid; idx < TR * E; idx += FWD_NT) {
      const int rr = idx / E, e = idx % E;
      float p0, pm3, pp3;
      pe_row(pe, row0 + rr, N, e, E, &p0, &pm3, &pp3);
#pragma unroll
      for (int s = 0; s < S; ++s)
        Xs[(3 * C + e) * MS + s * TR + rr] =
            pe_point<T>(s, e, E, p0, pm3, pp3, rot);
    }
#endif  // SH_SKIP_TAPS

    // ---- layer 0 + softplus, two passes over the hidden halves ----------
    float part[4];                           // offset rows: h . w1row
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i] = 0.f;
#pragma unroll 1
    for (int p = 0; p < 2; ++p) {
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
        fma_4x8(acc, Xs + kc * FKC * MS, MS, ry * 4, W, 128, cx * 4,
                64 + cx * 4, min(FKC, XK - kc * FKC));
#endif
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ry * 4 + i;
        const int s = m / TR, r = m % TR;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = 128 * p + (j < 4 ? cx * 4 + j : 64 + cx * 4 + j - 4);
          float h = acc[i][j], sig;
#ifndef SH_SKIP_SOFTPLUS
          softplus100(100.f * acc[i][j], &h, &sig);
#endif
          if (s == 0) Hc[n * TR + r] = h;
          else part[i] = fmaf(h, __ldg(w1row + n), part[i]);
        }
      }
    }
    // ---- offsets: sdf column, summed over the 16 column threads ----------
    if (S > 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = part[i];
#pragma unroll
        for (int o = 8; o >= 1; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        const int m = ry * 4 + i;
        const int s = m / TR, row = row0 + m % TR;
        if (cx == 0 && s >= 1 && s < S && row < N)
          out_off[(size_t)(s - 1) * N + row] = v;
      }
    }
    // ---- centre: layer 1, 16 rows x OF as 4x4 blocks; unit u < 144 sums
    // hidden rows 0..127, unit u + 144 rows 128..255 (a chunk holds kn of
    // each) ----------------------------------------------------------------
    const bool l1 = tid < L1U;
    const int half = tid / (L1U / 2), blk = tid % (L1U / 2);
    const int hy = blk / (OF / 4), ox = blk % (OF / 4);
    float o1[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o1[i][j] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < nk1; ++kc) {
      const float* W = next_chunk();
#ifndef SH_SKIP_LAYER1
      const int j0 = kc * (FKC / 2), kn = min(FKC / 2, 128 - j0);
      if (l1)
        fma_4x4(o1, Hc + (128 * half + j0) * TR, TR, hy * 4,
                W + half * kn * OF, OF, ox * 4, kn);
#endif
    }
    // the second half's partials through shared memory (Hc: its readers
    // are done after this barrier), added to the first half's in order
    __syncthreads();
    if (l1 && half == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st4(Hc + (hy * 4 + i) * OF + ox * 4, o1[i][0], o1[i][1], o1[i][2],
            o1[i][3]);
    }
    __syncthreads();
    if (l1 && half == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + hy * 4 + i;
        if (row >= N) continue;
        const float4 o2 = ld4(Hc + (hy * 4 + i) * OF + ox * 4);
        const float add[4] = {o2.x, o2.y, o2.z, o2.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ox * 4 + j < O)
            out_c[(size_t)row * O + ox * 4 + j] = o1[i][j] + add[j];
      }
    }
  }
  cp_wait<0>();                              // never leave a copy in flight
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
static cudaError_t launch_f32(int n_sm, int N, int C, int E, int O,
                              const Ptrs6& P, const Ptrs6& L, const float* fr,
                              const void* pe, const float* rot,
                              const void* w0, const float* b0, const void* w1,
                              const void* w1row, float* out_c, float* out_off,
                              void* v_out, cudaStream_t stream) {
  auto kern = stencil_fwd_f32<S, B>;
  static int per_sm = 0;                     // blocks per SM, asked once
  if (per_sm == 0) {
    int info[4];
    const int err =
        f32k::kernel_info(kern, f32k::FWD_NT, f32k::SMEM_FWD, info);
    if (err != 0) return (cudaError_t)err;
    per_sm = info[0];
  }
  const int n_tiles = (N + f32k::TR - 1) / f32k::TR;
  const int slots = per_sm * n_sm;
  kern<<<n_tiles < slots ? n_tiles : slots, f32k::FWD_NT, f32k::SMEM_FWD,
         stream>>>(N, C, E, O, P, L, fr, (const float*)pe, rot,
                   (const float*)w0, b0, (const float*)w1,
                   (const float*)w1row, out_c, out_off, (float*)v_out);
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

// dtype 0 = float32: the padded operands of ops/stencil.py
// pack_weights_f32: w0 [XF, HF], b0 [HF], w1 [HF, OF], w1row [HF] (column
// 0 of W1).  dtype 1 = bfloat16: w0 and w1 are the padded, tiled operands
// of ops/stencil.py pack_weights_bf16 ([XP, HP] and [OP, HP] of W1^T), b0
// [HP] zero padded, w1row unused.  XW and H are checked against the built
// widths.  Returns a cudaError_t (0 = success).
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
  if (dtype == 0 && (C < 1 || E < 1 || 3 * C + E >= f32k::XF ||
                     H > f32k::HF || O > f32k::OF || XW != f32k::XF))
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
                     ? launch_f32<SS, BB>(n_sm, N, C, E, O, P, L, fr, pe,    \
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

// The float32 forward kernel's blocks per SM, registers a thread, local
// (spill) bytes a thread and shared memory a block, into out[0..3], for
// S in {1, 7}, B in {1, 2}.  Returns a cudaError_t (0 = success).
extern "C" int stencil_head_fwd_f32_info(int S, int B, int* out) {
#define SH_INFO(SS, BB)                                                      \
  if (S == SS && B == BB)                                                    \
    return f32k::kernel_info(stencil_fwd_f32<SS, BB>, f32k::FWD_NT,          \
                             f32k::SMEM_FWD, out)
  SH_INFO(7, 1);
  SH_INFO(7, 2);
  SH_INFO(1, 1);
  SH_INFO(1, 2);
#undef SH_INFO
  return (int)cudaErrorInvalidValue;
}
