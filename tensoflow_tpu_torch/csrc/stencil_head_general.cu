// General-width stencil-head kernels for Hopper (sm_90a): forward and
// backward for the widths the fast kernels (stencil_head_fwd.cu,
// stencil_head_bwd.cu) are not built for.
//
// Replaces, at those widths: tensoflow_tpu/ops/pallas_stencil.py
// `_fwd_kernel` (pallas_call at :354) and `_bwd_kernel` (pallas_call at
// :577), which size their X scratch from the shapes (`_xw`) and take any H
// and O as whole blocks.  The fast kernels are compiled for 3C+E < 144,
// H <= 256, O <= 144 (and, in bf16, C % 4 == 0, E <= 32); these take
// 3C+E <= 2048, H <= 4096, O <= 4096 in float32 and bf16, any C and E,
// S in {1, 7}, B in {1, 2}, static or dynamic sigma lanes.  The route is
// chosen by ops/stencil.py head_route.
//
// Bound on the H100: operations, float32 FMAs on the FMA pipe (67
// TFLOP/s; no tensor cores: TF32 would change the arithmetic the reference
// defines).  At NeuS's widths (C=36, E=39, H=256, O=257) a row costs ~0.66
// MFLOP forward and ~1.85 MFLOP backward against ~22 KB of device memory.
//
// The block's shape and its register blocks are compile-time; the widths
// are runtime values that set only loop trip counts, a ring chunk's rows
// and the tile's rows.  The launcher computes them once (Plan, passed by
// value, so that the kernels read them from the constant bank and not
// from registers; ops/stencil.py gen_plan mirrors it).
//   stencil_gen_fwd — persistent blocks of 448 threads (28 row groups x 16
//     column groups; two a SM where shared memory allows, 112 KB at
//     NeuS's widths) walk tiles of TR rows of the head's input = M = S*TR
//     X rows (TR = 16 for S = 7 while shared memory fits:
//     ops/stencil.py gen_tile_rows).  The taps (4 rows x 8 channels a
//     warp) write X TRANSPOSED into shared memory, [k][m], so that one
//     float4 gives a thread its 4 rows.  z = X.W0 + b0 in passes of 128
//     hidden columns, each thread a 4x8 register block (three float4 loads
//     for 32 FMAs), W0 streamed through a two-slot cp.async ring with one
//     barrier a chunk.  The chunk sequence repeats every tile, so the ring
//     runs on across tiles and a tile's first chunks arrive while its
//     taps run; a cursor tracks it (no division by a runtime count).
//     softplus on the registers; the centre's h (transposed) stays in
//     shared memory, the offsets' h.w1row is summed in registers and over
//     the 16 column threads by a fixed-order warp reduction.  Layer 1 of
//     the centre rows as 4x8 blocks over W1 streamed through the same
//     ring, its K (the hidden width) split between thread groups (three
//     at NeuS's widths) whose partials are added in a fixed order.
//   stencil_gen_bwd_rows — one persistent block of 448 threads a SM, the
//     same tiles and X^T.  Per pass of 128 hidden columns: dh = g.W1^T for
//     the centre rows as 4x8 blocks (K split between up to 4 groups,
//     summed in order), z again as 4x8 blocks, dz = dh * softplus'(z)
//     into shared memory (transposed), dX += dz.W0^T as 4x10 register
//     blocks.  Up to 3C+E = 159 (one dX window, see DXW) dX stays in
//     registers across all passes and then replaces X^T; wider X keeps
//     dX^T in a per-block scratch of the workspace.  W1^T, W0 and W0^T
//     stream through one two-slot ring.  X (with a ones column at 3C+E,
//     whose dW0 row is db0), dz, the centre h and cotangent go to a
//     workspace; the offset rows' h.g_off (dw1row) is summed per pass in a
//     fixed order into one partial a block.  The product rule and the
//     transposed hat weights route dX to dP, dL and dpe.  Both row kernels
//     start a block of several tiles late by a delay spread over the
//     blocks, so that memory-bound taps and FMA-bound products do not run
//     in step across the card.
//   stencil_gen_atb — part[z] = A^T.B over split z of the workspace's rows
//     (at most 1024 rows a split: the bias-gradient accuracy cap), output
//     tiles of up to 256 rows sized to the widths, 8x8 a thread, both
//     operands through a two-slot cp.async ring of 32 rows.  dW0 = X^T.dz,
//     dW1 = h^T.g.
//   stencil_gen_colsum — fixed-order sums of the partials, so that two
//     runs give bit-identical gradients (no atomics anywhere).
// What bounds them now: the products run at ~40 TFLOP/s on their own; the
// taps (memory-bound, ~1 ms forward, ~2.8 ms backward at B=2) overlap
// them only across blocks, and the backward row kernel holds one block a
// SM (PERF.md).
// All products are float32 FMAs on float32 operands; in bf16 the operands
// are rounded where the plain version (ops/stencil.py stencil_head_plain)
// rounds them: the taps op by op, X, h, dh and dX to bf16, W0 and W1 to
// bf16 (by the caller), float32 accumulation.
//
// -DSH_SKIP_TAPS / _SOFTPLUS / _WORKSPACE / _Z / _LAYER1 / _DX leave a
// phase out: wrong results, built only by bench/stencil_phases.py to time
// the rest.
#include "stencil_common.cuh"
#include "stencil_f32.cuh"

using namespace sh;
using f32k::cp16;
using f32k::cp_commit;
using f32k::cp_wait;
using f32k::ld4;
using f32k::st4;

namespace gen {

constexpr int NT = 448;       // threads a row-kernel block
constexpr int NW = NT / 32;   // its warps
constexpr int HW = 128;       // hidden columns a pass: cx*4.., 64+cx*4..
// floats of a forward ring slot (15.5 KB: 30 rows of W0's 128 columns,
// or 3 groups x 5 rows of W1's 264 at NeuS's widths; one of 3,328 floats
// measured 2.5 % slower)
constexpr int FSLOT = 3960;
constexpr int BSLOT = 5120;   // floats of a backward ring slot (20 KB)
// K groups of the backward's dh product at most (4: chunks of 40 W1^T
// rows; 7 groups of 5 rows measured 0.1-0.2 ms a call slower)
constexpr int DHG = 4;
constexpr int STAGE = 2;      // ring slots (a third in the backward
                              // measured no faster)
// dX columns a thread block keeps in registers (4x10 a thread: columns
// cx*4.., 64+cx*4.., 128+cx, 144+cx).  K4 = round4(3C+E+1) <= DXW, i.e.
// 3C+E <= 159, keeps all of dX in registers across the hidden passes;
// wider X takes windows of DXW columns, each read from and written back
// to a per-block dX^T scratch in the workspace (L2-resident: shared
// memory would not hold it beside X^T at the widest X) once a pass.
constexpr int DXW = 160;
constexpr int XKC = BSLOT / DXW;   // W0^T rows of a dX chunk: 32
constexpr int TRMAX7 = 16;    // rows of the head's input a tile, S = 7
constexpr int TRMAX1 = 112;   // S = 1 (at most 112 X rows: 28 row groups)
constexpr int ATB_NT = 320;   // threads of a weight-gradient block at most
constexpr int AKC = 32;       // rows of its ring chunk
constexpr int AKMAX = 1024;   // rows one weight-gradient partial sums
constexpr size_t SMEM_MAX = 232448;   // the most one block may ask for

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Everything the widths decide, computed once by the launcher and passed
// by value (the kernels read it from the constant bank, not registers).
// ops/stencil.py gen_plan mirrors it.
struct Plan {
  int K, K4, H4, O4;      // X columns 3C+E, X row width (ones column at K),
                          // hidden and layer-1 widths rounded up to 4
  int TR, M, MS, TRP;     // tile rows, X rows S*TR, X^T pitch, TR to 4
  int MSF;                // the forward's X^T pitch (no pad: the two
                          // blocks a SM need the room)
  int npass;              // hidden passes of HW columns
  // forward: W0 chunks of kzf rows (nkzf a pass); layer 1 in n1pass
  // column passes of owp = 8 cgp columns, rg1 x cgp units of 4x8, its K
  // split into g1 groups of kq1 rows a chunk (nk1 chunks a pass)
  int kzf, nkzf, rg1, cgp, owp, n1pass, g1, kq1, nk1, nchf;
  // backward: dh units of 4x8 (rgd row groups x 16), its K split into gd
  // groups of kqd rows a chunk (nkd chunks a pass); W0 chunks of kzb rows
  // (nkzb a pass); nwin dX windows of nkx chunks a pass; perpass
  // chunks a pass in all
  int rgd, gd, kqd, nkd, kzb, nkzb, nwin, nkx, perpass;
  int r0f;                // floats of the forward's X^T / partials region
};

__host__ inline Plan make_plan(int S, int C, int E, int H, int O, int TR) {
  Plan p;
  p.K = 3 * C + E;
  p.K4 = round4(p.K + 1);
  p.H4 = round4(H);
  p.O4 = round4(O);
  p.TR = TR;
  p.M = S * TR;
  p.MS = round4(p.M) + 4;
  p.MSF = round4(p.M);
  p.TRP = round4(TR);
  p.npass = cdiv(p.H4, HW);
  p.kzf = FSLOT / HW;
  p.nkzf = cdiv(p.K4, p.kzf);
  p.rg1 = p.TRP / 4;
  const int cg1 = cdiv(p.O4, 8);
  int cgmax = NT / p.rg1;
  if (cgmax > FSLOT / 32) cgmax = FSLOT / 32;      // 4 rows fit a slot
  p.n1pass = cdiv(cg1, cgmax);
  p.cgp = cdiv(cg1, p.n1pass);
  p.owp = 8 * p.cgp;
  p.g1 = NT / (p.rg1 * p.cgp);
  if (p.g1 > FSLOT / (4 * p.owp)) p.g1 = FSLOT / (4 * p.owp);
  p.kq1 = FSLOT / (p.owp * p.g1);
  p.nk1 = cdiv(p.H4, p.g1 * p.kq1);
  p.nchf = p.npass * p.nkzf + p.n1pass * p.nk1;
  p.rgd = p.TRP / 4;
  p.gd = NT / (p.rgd * 16);
  if (p.gd > DHG) p.gd = DHG;
  if (p.gd > p.MS / p.TRP) p.gd = p.MS / p.TRP;    // partials fit D
  p.kqd = BSLOT / (HW * p.gd);
  p.nkd = cdiv(p.O4, p.gd * p.kqd);
  p.kzb = BSLOT / HW;
  p.nkzb = cdiv(p.K4, p.kzb);
  p.nwin = cdiv(p.K4, DXW);
  p.nkx = HW / XKC;
  p.perpass = p.nkd + p.nkzb + p.nwin * p.nkx;
  const int l1 = (p.g1 - 1) * p.TRP * p.owp;
  p.r0f = p.K4 * p.MSF > l1 ? p.K4 * p.MSF : l1;
  return p;
}

// shared memory (bytes) of a forward / backward row block
__host__ inline size_t smem_fwd(const Plan& p) {
  return 4 * ((size_t)p.r0f + STAGE * FSLOT + (size_t)p.H4 * p.TRP);
}
__host__ inline size_t smem_bwd(const Plan& p) {
  return 4 * ((size_t)p.K4 * p.MS + (size_t)HW * p.MS + STAGE * BSLOT +
              (size_t)p.O4 * p.TRP +
              (size_t)p.TRP * HW + (size_t)NW * HW);
}

// split-K plan of a weight-gradient product over k rows: (splits, rows a
// split), each split at most AKMAX rows, a multiple of 32
__host__ inline void splits(long long k, int* ns, int* chunk) {
  const long long n0 = (k + AKMAX - 1) / AKMAX;
  long long c = (k + n0 - 1) / n0;
  c = (c + 31) / 32 * 32;
  *chunk = (int)c;
  *ns = (int)((k + c - 1) / c);
}

// The output tiles of a weight-gradient product [na, nb]: a block of rga
// row groups x cgb column groups (8 x 8 a thread, at most ATB_NT threads)
// takes 8 rga <= 256 rows x 8 cgb columns; ta x tb such tiles.
struct AtbShape {
  int rga, cgb, ta, tb;
  __host__ AtbShape(int na, int nb) {
    ta = cdiv(na, 256);
    rga = cdiv(cdiv(na, ta), 8);
    int cgmax = ATB_NT / rga;
    if (cgmax > 32) cgmax = 32;
    tb = cdiv(nb, 8 * cgmax);
    cgb = cdiv(cdiv(nb, tb), 8);
  }
};

inline size_t pad256(size_t b) { return (b + 255) / 256 * 256; }

// The workspace of stencil_gen_bwd, piece by piece (bytes from its start).
struct Layout {
  size_t xg, dzg, hg, gcg, pw1, dxs, part0, part1, total;
  int tiles, ns0, ch0, ns1, ch1;
  Layout(int S, int N, const Plan& p, int grid) {
    tiles = (N + p.TR - 1) / p.TR;
    const long long r0 = (long long)tiles * S * p.TR,
                    r1 = (long long)tiles * p.TR;
    splits(r0, &ns0, &ch0);
    splits(r1, &ns1, &ch1);
    size_t at = 0;
    xg = at;    at += pad256(4 * (size_t)r0 * p.K4);
    dzg = at;   at += pad256(4 * (size_t)r0 * p.H4);
    hg = at;    at += pad256(4 * (size_t)r1 * p.H4);
    gcg = at;   at += pad256(4 * (size_t)r1 * p.O4);
    pw1 = at;   at += pad256(4 * (size_t)grid * p.H4);
    dxs = at;   at += p.nwin > 1 ? pad256(4 * (size_t)grid * p.K4 * p.MS) : 0;
    part0 = at; at += pad256(4 * (size_t)ns0 * p.K4 * p.H4);
    part1 = at; at += pad256(4 * (size_t)ns1 * p.H4 * p.O4);
    total = at;
  }
};

// storage type T: store a value already rounded to T
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// The arithmetic policy of the [row, C]-wide elementwise ops for storage
// type T: float32, or one bf16 channel in a float with every op rounded
// to bf16 (what PyTorch's bf16 ops do: compute in float32, round once).
struct Bf1 {
  using V = float;
  static __device__ __forceinline__ V w(float x) {
    return Cd<__nv_bfloat16>::rnd(x);
  }
  static __device__ __forceinline__ V zero() { return 0.f; }
  static __device__ __forceinline__ V mul(V a, V b) {
    return Cd<__nv_bfloat16>::rnd(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ V add(V a, V b) {
    return Cd<__nv_bfloat16>::rnd(__fadd_rn(a, b));
  }
};
template <typename T> struct Pol;
template <> struct Pol<float> { using A = F32; };
template <> struct Pol<__nv_bfloat16> { using A = Bf1; };

// acc[i][j] += A[k][a0 + i] * Bw[k][cb(j)] for k < kn: 4 rows of the
// transposed A (pitch lda) x 8 columns of B (b0..b0+3, b1..b1+3, pitch
// ldb).  Three float4 loads a k for 32 FMAs.
__device__ __forceinline__ void fma48(float (&acc)[4][8], const float* A,
                                      int lda, int a0, const float* Bw,
                                      int ldb, int b0, int b1, int kn) {
#pragma unroll 4
  for (int kk = 0; kk < kn; ++kk) {
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

// dx[i][j] += D[k][a0 + i] * W[k][dx_col(j)] over a chunk of XKC rows (W
// pitch DXW): 3 float4 and 2 scalar loads a k for 40 FMAs.
__device__ __forceinline__ void fma_dx(float (&dx)[4][10], const float* D,
                                       int lda, int a0, const float* W,
                                       int cx) {
#pragma unroll 4
  for (int kk = 0; kk < XKC; ++kk) {
    const float4 x = ld4(D + kk * lda + a0);
    const float* w = W + kk * DXW;
    const float4 w0 = ld4(w + cx * 4), w1 = ld4(w + 64 + cx * 4);
    const float a[4] = {x.x, x.y, x.z, x.w};
    const float b[10] = {w0.x, w0.y, w0.z, w0.w, w1.x,
                         w1.y, w1.z, w1.w, w[128 + cx], w[144 + cx]};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 10; ++j) dx[i][j] = fmaf(a[i], b[j], dx[i][j]);
  }
}
// column (within its window) of dX entry j of column thread cx
__device__ __forceinline__ int dx_col(int j, int cx) {
  return j < 4 ? cx * 4 + j : (j < 8 ? 64 + cx * 4 + j - 4
                                     : 128 + 16 * (j - 8) + cx);
}
// hidden column (within its pass) of z entry j of column thread cx
__device__ __forceinline__ int z_col(int j, int cx) {
  return j < 4 ? cx * 4 + j : 64 + cx * 4 + j - 4;
}

// This thread's float4s of a [rows][w4] block copied by nt threads, in
// order idx = tid, tid + nt, ...: (row, column) of the first and the step,
// so that a copy loop divides by no runtime width.
struct Walk {
  int r0, c0, dr, dc, w4;
  __device__ __forceinline__ Walk(int tid, int nt, int w) {
    w4 = w;
    r0 = tid / w;
    c0 = tid % w;
    dr = nt / w;
    dc = nt % w;
  }
  __device__ __forceinline__ void step(int& r, int& c) const {
    r += dr;
    c += dc;
    if (c >= w4) {
      c -= w4;
      ++r;
    }
  }
};

// The tap items: warp-sized groups of 4 rows x 8 channels, so that patch
// loads come in 32-byte segments and transposed X stores spread over the
// banks.  Group q of tap_groups(TR, C).
__device__ __forceinline__ int tap_groups(int TR, int C) {
  return (TR + 3) / 4 * ((C + 7) / 8);
}
__device__ __forceinline__ void tap_item(int q, int TR, int lane, int* rr,
                                         int* c) {
  const int rb = (TR + 3) / 4;
  *rr = (q % rb) * 4 + (lane & 3);
  *c = (q / rb) * 8 + (lane >> 2);
}

}  // namespace gen

using namespace gen;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// w0 [K4][H4], b0 [H4], w1 [H4][O4], w1row [H4]: zero padded float32 (in
// bf16 holding bf16 values).  out_c [N, O], out_off [S-1, N] (S = 7),
// v_out [N, VW] or null.
template <typename T, int S, int B>
__global__ void __launch_bounds__(NT, 2)
stencil_gen_fwd(const Plan P, int N, int C, int E, int O, Ptrs6 pp,
                Ptrs6 lp, const float* __restrict__ fr,
                const T* __restrict__ pe, const float* __restrict__ rot,
                const float* __restrict__ w0, const float* __restrict__ b0,
                const float* __restrict__ w1,
                const float* __restrict__ w1row, float* __restrict__ out_c,
                float* __restrict__ out_off, T* __restrict__ v_out) {
  using A = typename Pol<T>::A;
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);  // X^T [K4][MS]; after
                                                   // layer 0 the layer-1
                                                   // partials
  float* ring = Xs + P.r0f;                        // [STAGE][FSLOT]
  float* Hc = ring + STAGE * FSLOT;                // centre h^T [H4][TRP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ry = tid >> 4, cx = tid & 15;          // 4-row, 8-column blocks
  const bool rows_on = ry * 4 < P.M;
  const int TR = P.TR, MS = P.MSF, TRP = P.TRP;
  const int VW = (NPV + NLV) * 3 * C;
  const int n_tiles = (N + TR - 1) / TR;
  const int nz = P.npass * P.nkzf;                 // layer-0 chunks a tile
  // layer 1: unit (row group hy, column group ox) of K group g1i
  const int u1 = P.rg1 * P.cgp;
  const int g1i = tid / u1, hy = (tid % u1) / P.cgp, ox = (tid % u1) % P.cgp;
  const bool l1 = g1i < P.g1;

  // X^T is zero where no tap writes (X rows past M); the centre h^T too
  // (rows past TR)
  for (int idx = tid; idx < P.r0f; idx += NT) Xs[idx] = 0.f;
  for (int idx = tid; idx < P.H4 * TRP; idx += NT) Hc[idx] = 0.f;
  __syncthreads();
  // The ring's chunk sequence of a tile, repeated every tile: W0 rows
  // kc*kzf.. of hidden pass p for each p and kc, then W1 rows of the
  // layer-1 K chunks for each column pass.  fetch_next() issues the next
  // chunk of the sequence, tracked by a cursor (no division by a runtime
  // count).
  int g = 0;                                 // ring chunks consumed
  int fq = 0, fa = 0, fb = 0;                // cursor: index, outer, inner
  int fs = 0;                                // slot of the next fetch
  auto fetch_next = [&]() {
    float* slot = ring + fs * FSLOT;
    fs = fs + 1 == STAGE ? 0 : fs + 1;
    if (fq < nz) {                           // W0 rows k0.., pass fa
      const int k0 = fb * P.kzf, kn = min(P.kzf, P.K4 - k0);
      for (int idx = tid; idx < kn * (HW / 4); idx += NT) {
        const int r = idx / (HW / 4), c4 = (idx % (HW / 4)) * 4;
        const int col = fa * HW + c4;
        const bool ok = col < P.H4;
        cp16(slot + r * HW + c4, ok ? w0 + (size_t)(k0 + r) * P.H4 + col : w0,
             ok);
      }
      if (++fb == P.nkzf) { fb = 0; ++fa; }
    } else {                                 // W1 rows j0.., columns o0..
      const int o0 = fa * P.owp, j0 = fb * P.g1 * P.kq1;
      const Walk wk(tid, NT, P.owp / 4);
      for (int r = wk.r0, c = wk.c0; r < P.g1 * P.kq1; wk.step(r, c)) {
        const bool ok = j0 + r < P.H4 && o0 + 4 * c < P.O4;
        cp16(slot + r * P.owp + 4 * c,
             ok ? w1 + (size_t)(j0 + r) * P.O4 + o0 + 4 * c : w1, ok);
      }
      if (++fb == P.nk1) { fb = 0; ++fa; }
    }
    if (++fq == nz) { fa = 0; fb = 0; }
    if (fq == P.nchf) { fq = 0; fa = 0; fb = 0; }
    cp_commit();
  };
  // wait for chunk g, make it visible, start the next chunk of the
  // sequence into the slot whose readers have just passed the barrier;
  // chunk g's slot
  auto next_chunk = [&]() -> const float* {
    cp_wait<STAGE - 2>();
    __syncthreads();
    fetch_next();
    return ring + (g++ % STAGE) * FSLOT;
  };
  for (int q = 0; q < STAGE - 1; ++q) fetch_next();
  // A block of many tiles starts late by 0-60 us, spread over the blocks,
  // so that the blocks' memory-bound taps and FMA-bound products do not
  // run in step across the card (as the fast kernels do; measured 0.1 ms
  // a call faster here, 0-30 and 0-120 us slower).  A block of a few
  // tiles (a render or relight chunk) starts at once.
  if (n_tiles >= 8 * (int)gridDim.x)
    for (int w = (blockIdx.x * 37) % 64 * 60 / 64; w > 0; w -= 5)
      __nanosleep(5000);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    // the last tile's readers of Xs (layer-1 partials) and Hc are done;
    // then X^T's pad rows past 3C+E are zero again
    __syncthreads();
    for (int idx = tid; idx < (P.K4 - P.K) * MS; idx += NT)
      Xs[P.K * MS + idx] = 0.f;
#ifndef SH_SKIP_TAPS
    // ---- taps: (row, channel) items; X^T and V -------------------------
    for (int q = warp; q < tap_groups(TR, C); q += NW) {
      int rr, c;
      tap_item(q, TR, lane, &rr, &c);
      if (rr >= TR || c >= C) continue;
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
            const T* Pp = (const T*)pp.p[b * 3 + i] + (size_t)row * 16 * C + c;
            float sl[16], pv[NPV];
#pragma unroll
            for (int k = 0; k < 16; ++k) sl[k] = Cd<T>::ld(Pp, (size_t)k * C);
            plane_variants<A, S>(sl, q2, pv);
#pragma unroll
            for (int v = 0; v < NPV; ++v)
              PV[i][v] = (b == 0) ? pv[v] : A::add(PV[i][v], pv[v]);
            const T* L = (const T*)lp.p[b * 3 + i] + (size_t)row * 4 * C + c;
            float ls[4], lv[NLV];
#pragma unroll
            for (int k = 0; k < 4; ++k) ls[k] = Cd<T>::ld(L, (size_t)k * C);
            line_variants<A, S>(ls, q2, lv);
#pragma unroll
            for (int v = 0; v < NLV; ++v)
              LV[i][v] = (b == 0) ? lv[v] : A::add(LV[i][v], lv[v]);
          }
        }
        if (v_out != nullptr) {
          T* Vr = v_out + (size_t)row * VW;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int v = 0; v < NPV; ++v)
              st(Vr, (size_t)(i * NPV + v) * C + c, PV[i][v]);
#pragma unroll
            for (int v = 0; v < NLV; ++v)
              st(Vr, (size_t)3 * NPV * C + (i * NLV + v) * C + c, LV[i][v]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float x[S];
        x_products<A, S>(i, PV[i], LV[i], x);
#pragma unroll
        for (int s = 0; s < S; ++s) Xs[(i * C + c) * MS + s * TR + rr] = x[s];
      }
    }
    // ---- PE columns (zero past N) ---------------------------------------
    for (int idx = tid; idx < TR * E; idx += NT) {
      const int rr = idx / E, e = idx % E, row = row0 + rr;
      float p0 = 0.f, pm3 = 0.f, pp3 = 0.f;
      if (row < N) {
        p0 = Cd<T>::ld(pe, (size_t)row * E + e);
        pm3 = Cd<T>::ld(pe, (size_t)row * E + (e + 3) % E);
        pp3 = Cd<T>::ld(pe, (size_t)row * E + (e + E - 3) % E);
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
        Xs[(3 * C + e) * MS + s * TR + rr] =
            row < N ? pe_point<T>(s, e, E, p0, pm3, pp3, rot) : 0.f;
    }
#endif  // SH_SKIP_TAPS

    // ---- layer 0 + softplus, passes of HW hidden columns ----------------
    float part[4];                           // offset rows: h . w1row
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i] = 0.f;
#pragma unroll 1
    for (int p = 0; p < P.npass; ++p) {
      float acc[4][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = p * HW + z_col(j, cx);
        const float bj = n < P.H4 ? __ldg(b0 + n) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = bj;
      }
#pragma unroll 1
      for (int kc = 0; kc < P.nkzf; ++kc) {
        const float* W = next_chunk();
#ifndef SH_SKIP_Z
        if (rows_on)
          fma48(acc, Xs + kc * P.kzf * MS, MS, ry * 4, W, HW, cx * 4,
                64 + cx * 4, min(P.kzf, P.K4 - kc * P.kzf));
#endif
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ry * 4 + i;
        if (m >= P.M) break;
        const int s = m / TR, r = m % TR;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = p * HW + z_col(j, cx);
          if (n >= P.H4) continue;
          float h = acc[i][j], sig;
#ifndef SH_SKIP_SOFTPLUS
          softplus100(100.f * acc[i][j], &h, &sig);
#endif
          h = Cd<T>::rnd(h);
          if (s == 0) Hc[n * TRP + r] = h;
          else part[i] = fmaf(h, __ldg(w1row + n), part[i]);
        }
      }
    }
    // ---- offsets: the sdf column, summed over the 16 column threads -----
    if (S > 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = part[i];
#pragma unroll
        for (int o = 8; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        const int m = ry * 4 + i, s = m / TR, row = row0 + m % TR;
        if (cx == 0 && m < P.M && s >= 1 && row < N)
          out_off[(size_t)(s - 1) * N + row] = v;
      }
    }
    // ---- layer 1 of the centre rows: 4x8 units, K split in g1 groups ----
#pragma unroll 1
    for (int pq = 0; pq < P.n1pass; ++pq) {
      const int o0 = pq * P.owp;
      float o1[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) o1[i][j] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < P.nk1; ++kc) {
        const float* W = next_chunk();
#ifndef SH_SKIP_LAYER1
        const int j0 = (kc * P.g1 + g1i) * P.kq1;
        const int kn = min(P.kq1, P.H4 - j0);
        if (l1 && kn > 0)
          fma48(o1, Hc + j0 * TRP, TRP, hy * 4, W + g1i * P.kq1 * P.owp,
                P.owp, ox * 4, 4 * P.cgp + ox * 4, kn);
#endif
      }
      // groups 1.. hand their partials to group 0 through Xs (its last
      // readers, layer 0, passed a ring barrier), added in group order
      if (l1 && g1i >= 1) {
        float* d0 = Xs + (size_t)(g1i - 1) * TRP * P.owp;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* d = d0 + (hy * 4 + i) * P.owp;
          st4(d + ox * 4, o1[i][0], o1[i][1], o1[i][2], o1[i][3]);
          st4(d + 4 * P.cgp + ox * 4, o1[i][4], o1[i][5], o1[i][6], o1[i][7]);
        }
      }
      __syncthreads();
      if (l1 && g1i == 0) {
        for (int gq = 1; gq < P.g1; ++gq) {
          const float* d0 = Xs + (size_t)(gq - 1) * TRP * P.owp;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* d = d0 + (hy * 4 + i) * P.owp;
            const float4 a = ld4(d + ox * 4), b = ld4(d + 4 * P.cgp + ox * 4);
            o1[i][0] += a.x; o1[i][1] += a.y; o1[i][2] += a.z; o1[i][3] += a.w;
            o1[i][4] += b.x; o1[i][5] += b.y; o1[i][6] += b.z; o1[i][7] += b.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = hy * 4 + i, row = row0 + r;
          if (r >= TR || row >= N) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int o =
                o0 + (j < 4 ? ox * 4 + j : 4 * P.cgp + ox * 4 + j - 4);
            if (o < O) out_c[(size_t)row * O + o] = o1[i][j];
          }
        }
      }
    }
  }
  cp_wait<0>();                              // never leave a copy in flight
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// w0 [K4][H4], w0t [H4][K4], b0 [H4], w1t = W1^T [O4][H4], w1row [H4]:
// zero padded float32.  Workspace rows of tile t: X and dz rows t*S*TR +
// s*TR + r, h and the cotangent rows t*TR + r.  p_dw1row [grid][H4]: this
// block's dw1row, summed over its tiles in order.  dxs [grid][K4][MS]:
// the blocks' dX^T past one window (null for one window).
template <typename T, int S, int B>
__global__ void __launch_bounds__(NT, 1)
stencil_gen_bwd_rows(const Plan P, int N, int C, int E, int O,
                     const float* __restrict__ fr, const T* __restrict__ V,
                     const T* __restrict__ pe, const float* __restrict__ rot,
                     const float* __restrict__ w0,
                     const float* __restrict__ w0t,
                     const float* __restrict__ b0,
                     const float* __restrict__ w1t,
                     const float* __restrict__ w1row,
                     const float* __restrict__ g_c,
                     const float* __restrict__ g_off, MPtrs6 dP, MPtrs6 dL,
                     float* __restrict__ dpe, float* __restrict__ xg,
                     float* __restrict__ dzg, float* __restrict__ hg,
                     float* __restrict__ gcg, float* __restrict__ p_dw1row,
                     float* __restrict__ dxs) {
  using A = typename Pol<T>::A;
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int TR = P.TR, MS = P.MS, TRP = P.TRP;
  const bool win1 = P.nwin == 1;
  float* Xs = reinterpret_cast<float*>(smem_raw);  // X^T [K4][MS]
  // dX^T [K4][MS]: X^T's buffer once the last pass has read X (one
  // window), else this block's scratch in the workspace
  float* DXs = win1 ? Xs : dxs + (size_t)blockIdx.x * P.K4 * MS;
  // dz^T of one pass [HW][MS]; before it, the dh partials [gd][TRP][HW]
  float* D = Xs + (size_t)P.K4 * MS;
  float* ring = D + (size_t)HW * MS;               // [STAGE][BSLOT]
  float* Gs = ring + STAGE * BSLOT;                // g_c^T [O4][TRP]
  float* DH = Gs + (size_t)P.O4 * TRP;             // dh of a pass [TRP][HW]
  float* W1S = DH + TRP * HW;                      // [NW][HW] dw1row terms
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ry = tid >> 4, cx = tid & 15;
  const bool rows_on = ry * 4 < P.M;
  const int VW = (NPV + NLV) * 3 * C;
  const int n_tiles = (N + TR - 1) / TR;
  // dh units: (row group dy, column group cx) of K group gdi
  const int gdi = tid / (P.rgd * 16), dy = (tid % (P.rgd * 16)) >> 4;
  const bool dh_on = gdi < P.gd;

  for (int idx = tid; idx < P.K4 * MS; idx += NT) Xs[idx] = 0.f;
  for (int idx = tid; idx < P.O4 * TRP; idx += NT) Gs[idx] = 0.f;
  __syncthreads();
  // The ring's chunk sequence of a pass, repeated every pass and tile:
  // W1^T rows of the dh K chunks, W0 rows kc*kzb.., then W0^T rows of the
  // pass's dX chunks for each window.  fetch_next() issues the next chunk,
  // tracked by a cursor (no division by a runtime count).
  int g = 0;                                 // ring chunks consumed
  int fq = 0, fp = 0, fw = 0, fc = 0;        // cursor: index in the pass,
                                             // pass, dX window and chunk
  int fs = 0;                                // slot of the next fetch
  auto fetch_next = [&]() {
    float* slot = ring + fs * BSLOT;
    fs = fs + 1 == STAGE ? 0 : fs + 1;
    if (fq < P.nkd) {                        // W1^T rows o0.., pass fp
      const int o0 = fq * P.gd * P.kqd;
      for (int idx = tid; idx < P.gd * P.kqd * (HW / 4); idx += NT) {
        const int r = idx / (HW / 4), c4 = (idx % (HW / 4)) * 4;
        const int col = fp * HW + c4;
        const bool ok = o0 + r < P.O4 && col < P.H4;
        cp16(slot + r * HW + c4,
             ok ? w1t + (size_t)(o0 + r) * P.H4 + col : w1t, ok);
      }
    } else if (fq < P.nkd + P.nkzb) {        // W0 rows k0.., pass fp
      const int k0 = (fq - P.nkd) * P.kzb;
      const int kn = min(P.kzb, P.K4 - k0);
      for (int idx = tid; idx < kn * (HW / 4); idx += NT) {
        const int r = idx / (HW / 4), c4 = (idx % (HW / 4)) * 4;
        const int col = fp * HW + c4;
        const bool ok = col < P.H4;
        cp16(slot + r * HW + c4, ok ? w0 + (size_t)(k0 + r) * P.H4 + col : w0,
             ok);
      }
    } else {                                 // W0^T rows j0.., window fw
      const int k0 = fw * DXW, j0 = fp * HW + fc * XKC;
      for (int idx = tid; idx < XKC * (DXW / 4); idx += NT) {
        const int r = idx / (DXW / 4), c4 = (idx % (DXW / 4)) * 4;
        const bool ok = j0 + r < P.H4 && k0 + c4 < P.K4;
        cp16(slot + r * DXW + c4,
             ok ? w0t + (size_t)(j0 + r) * P.K4 + k0 + c4 : w0t, ok);
      }
      if (++fc == P.nkx) { fc = 0; ++fw; }
    }
    if (++fq == P.perpass) {
      fq = fw = fc = 0;
      if (++fp == P.npass) fp = 0;
    }
    cp_commit();
  };
  auto next_chunk = [&]() -> const float* {
    cp_wait<STAGE - 2>();
    __syncthreads();
    fetch_next();
    return ring + (g++ % STAGE) * BSLOT;
  };
  for (int q = 0; q < STAGE - 1; ++q) fetch_next();
  // a block of many tiles starts late by 0-160 us (about one tile's time),
  // spread over the blocks: measured 0.7 ms a call faster than 0-100 us
  // (itself 0.3-0.5 ms faster than starting together), 0.1-0.3 ms faster
  // than 0-240 or 0-320 us (B=2, N=131,072, NeuS's widths)
  if (n_tiles >= 8 * (int)gridDim.x)
    for (int w = (blockIdx.x * 37) % 64 * 160 / 64; w > 0; w -= 5)
      __nanosleep(5000);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    const size_t xr0 = (size_t)tile * S * TR;      // workspace row of (0, 0)
    const size_t hr0 = (size_t)tile * TR;          // h / g rows
    // the last tile's readers of Xs / DXs (routing) are done; X^T's pad
    // rows past 3C+E are zero again (Xs held dX^T)
    __syncthreads();
    for (int idx = tid; idx < (P.K4 - P.K) * MS; idx += NT)
      Xs[P.K * MS + idx] = 0.f;
#ifndef SH_SKIP_TAPS
    // ---- build: X^T from V, X to the workspace --------------------------
    for (int q = warp; q < tap_groups(TR, C); q += NW) {
      int rr, c;
      tap_item(q, TR, lane, &rr, &c);
      if (rr >= TR || c >= C) continue;
      const int row = row0 + rr;
      const bool ok = row < N;
      const T* vr = V + (size_t)row * VW + c;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float pv[NPV], lv[NLV], x[S];
#pragma unroll
        for (int v = 0; v < NPV; ++v)
          pv[v] = ok ? Cd<T>::ld(vr, (size_t)(i * NPV + v) * C) : 0.f;
#pragma unroll
        for (int v = 0; v < NLV; ++v)
          lv[v] = ok ? Cd<T>::ld(vr, (size_t)3 * NPV * C + (i * NLV + v) * C)
                     : 0.f;
        x_products<A, S>(i, pv, lv, x);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          Xs[(i * C + c) * MS + s * TR + rr] = x[s];
#ifndef SH_SKIP_WORKSPACE
          xg[(xr0 + s * TR + rr) * P.K4 + i * C + c] = x[s];
#endif
        }
      }
    }
    for (int idx = tid; idx < TR * E; idx += NT) {
      const int rr = idx / E, e = idx % E, row = row0 + rr;
      float p0 = 0.f, pm3 = 0.f, pp3 = 0.f;
      if (row < N) {
        p0 = Cd<T>::ld(pe, (size_t)row * E + e);
        pm3 = Cd<T>::ld(pe, (size_t)row * E + (e + 3) % E);
        pp3 = Cd<T>::ld(pe, (size_t)row * E + (e + E - 3) % E);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float x = row < N ? pe_point<T>(s, e, E, p0, pm3, pp3, rot) : 0.f;
        Xs[(3 * C + e) * MS + s * TR + rr] = x;
#ifndef SH_SKIP_WORKSPACE
        xg[(xr0 + s * TR + rr) * P.K4 + 3 * C + e] = x;
#endif
      }
    }
#endif  // SH_SKIP_TAPS
#ifndef SH_SKIP_WORKSPACE
    // the workspace's ones column (its dW0 row is db0) and pad columns
    for (int idx = tid; idx < P.M * (P.K4 - P.K); idx += NT) {
      const int m = idx / (P.K4 - P.K), col = P.K + idx % (P.K4 - P.K);
      xg[(xr0 + m) * P.K4 + col] = col == P.K ? 1.f : 0.f;
    }
#endif
    // the centre cotangent: g^T into Gs (zero past O and N), padded to O4
    // columns in the workspace
    for (int idx = tid; idx < TR * P.O4; idx += NT) {
      const int r = idx / P.O4, o = idx % P.O4, row = row0 + r;
      const float v = (row < N && o < O) ? __ldg(g_c + (size_t)row * O + o)
                                         : 0.f;
      Gs[o * TRP + r] = v;
#ifndef SH_SKIP_WORKSPACE
      gcg[(hr0 + r) * P.O4 + o] = v;
#endif
    }

    float dx[4][10];                         // dX = dz.W0^T, one window
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 10; ++j) dx[i][j] = 0.f;
#pragma unroll 1
    for (int p = 0; p < P.npass; ++p) {
      // ---- dh = g.W1^T of the pass: 4x8 units, K split in gd groups -----
      {
        float a[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
#pragma unroll 1
        for (int kc = 0; kc < P.nkd; ++kc) {
          const float* W = next_chunk();
#ifndef SH_SKIP_LAYER1
          const int o0 = (kc * P.gd + gdi) * P.kqd;
          const int kn = min(P.kqd, P.O4 - o0);
          if (dh_on && kn > 0)
            fma48(a, Gs + o0 * TRP, TRP, dy * 4, W + gdi * P.kqd * HW, HW,
                  cx * 4, 64 + cx * 4, kn);
#endif
        }
        // every group's partial into D (its last readers, the previous
        // pass's dX, passed a ring barrier); summed in group order
        if (dh_on) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* d = D + ((size_t)gdi * TRP + dy * 4 + i) * HW;
            st4(d + cx * 4, a[i][0], a[i][1], a[i][2], a[i][3]);
            st4(d + 64 + cx * 4, a[i][4], a[i][5], a[i][6], a[i][7]);
          }
        }
        __syncthreads();
        for (int idx = tid; idx < TRP * HW; idx += NT) {
          float t = D[idx];
          for (int gq = 1; gq < P.gd; ++gq)
            t += D[(size_t)gq * TRP * HW + idx];
          DH[idx] = t;
        }
      }
      // ---- z = X.W0 + b0 over the pass -----------------------------------
      float acc[4][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = p * HW + z_col(j, cx);
        const float bj = n < P.H4 ? __ldg(b0 + n) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = bj;
      }
#pragma unroll 1
      for (int kc = 0; kc < P.nkzb; ++kc) {
        const float* W = next_chunk();
#ifndef SH_SKIP_Z
        if (rows_on)
          fma48(acc, Xs + kc * P.kzb * MS, MS, ry * 4, W, HW, cx * 4,
                64 + cx * 4, min(P.kzb, P.K4 - kc * P.kzb));
#endif
      }
      // ---- softplus' -> dz; workspace; dz^T into D; dw1row terms ---------
      // (D's readers, the dh sums, and DH's writers passed a ring barrier)
      float w1p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w1p[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ry * 4 + i;
        const bool mv = m < P.M;
        const int s = m / TR, r = m % TR, row = row0 + r;
        const float go = (mv && s >= 1 && row < N)
                             ? __ldg(g_off + (size_t)(s - 1) * N + row)
                             : 0.f;
        float hv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int nl = z_col(j, cx), n = p * HW + nl;
          float dz = 0.f, h = 0.f;
          if (mv && n < P.H4) {
            float sig = 1.f;
            h = acc[i][j];
#ifndef SH_SKIP_SOFTPLUS
            softplus100(100.f * acc[i][j], &h, &sig);
#endif
            h = Cd<T>::rnd(h);
            float dh;
            if (s == 0) {
              dh = Cd<T>::rnd(DH[r * HW + nl]);
            } else {
              dh = Cd<T>::rnd(go * __ldg(w1row + n));
              w1p[j] = fmaf(h, go, w1p[j]);
            }
            dz = dh * sig;
          }
          hv[j] = h;
          acc[i][j] = dz;
        }
#ifndef SH_SKIP_WORKSPACE
        if (mv) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int n = p * HW + hf * 64 + cx * 4, j = hf * 4;
            if (n >= P.H4) continue;
            if (s == 0)
              st4(hg + (hr0 + r) * P.H4 + n, hv[j], hv[j + 1], hv[j + 2],
                  hv[j + 3]);
            st4(dzg + (xr0 + m) * P.H4 + n, acc[i][j], acc[i][j + 1],
                acc[i][j + 2], acc[i][j + 3]);
          }
        }
#endif
      }
      if (rows_on) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st4(D + z_col(j, cx) * MS + ry * 4, acc[0][j], acc[1][j], acc[2][j],
              acc[3][j]);
      }
      // the warp's two row groups, then one row of W1S a warp
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = w1p[j] + __shfl_xor_sync(0xffffffffu, w1p[j], 16);
        if (lane < 16) W1S[warp * HW + z_col(j, cx)] = v;
      }
      // ---- dX += dz.W0^T over the pass, window by window ------------------
#pragma unroll 1
      for (int w = 0; w < P.nwin; ++w) {
        if (!win1) {                         // this window's dX^T so far
#pragma unroll
          for (int j = 0; j < 10; ++j) {
            const int k = w * DXW + dx_col(j, cx);
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (p > 0 && k < P.K4 && rows_on) v = ld4(DXs + k * MS + ry * 4);
            dx[0][j] = v.x; dx[1][j] = v.y; dx[2][j] = v.z; dx[3][j] = v.w;
          }
        }
#pragma unroll 1
        for (int kc = 0; kc < P.nkx; ++kc) {
          const float* W = next_chunk();
#ifndef SH_SKIP_DX
          if (rows_on) fma_dx(dx, D + kc * XKC * MS, MS, ry * 4, W, cx);
#endif
        }
        if (!win1 && rows_on) {
#pragma unroll
          for (int j = 0; j < 10; ++j) {
            const int k = w * DXW + dx_col(j, cx);
            if (k < P.K4)
              st4(DXs + k * MS + ry * 4, dx[0][j], dx[1][j], dx[2][j],
                  dx[3][j]);
          }
        }
      }
      // ---- this pass's dw1row: the warps' rows summed in order ------------
      // (W1S's writers passed the dX chunks' barriers; its next writers
      // come after the next pass's)
      if (tid < HW && p * HW + tid < P.H4) {
        float t = 0.f;
        for (int w = 0; w < NW; ++w) t += W1S[w * HW + tid];
        float* o = p_dw1row + (size_t)blockIdx.x * P.H4 + p * HW + tid;
        *o = tile == (int)blockIdx.x ? t : *o + t;
      }
    }
    // ---- one window: dX^T into Xs (X's last readers, the last pass's z,
    // passed a ring barrier) ------------------------------------------------
    if (win1 && rows_on) {
#pragma unroll
      for (int j = 0; j < 10; ++j) {
        const int k = dx_col(j, cx);
        if (k < P.K4)
          st4(Xs + k * MS + ry * 4, dx[0][j], dx[1][j], dx[2][j], dx[3][j]);
      }
    }
    __syncthreads();
#ifndef SH_SKIP_TAPS
    // ---- product rule + hat-weight routing -----------------------------
    for (int q = warp; q < tap_groups(TR, C); q += NW) {
      int rr, c;
      tap_item(q, TR, lane, &rr, &c);
      const int row = row0 + rr;
      if (rr >= TR || c >= C || row >= N) continue;
      const T* vr = V + (size_t)row * VW + c;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float pv[NPV], lv[NLV], dxs[S], dPV[NPV], dLV[NLV];
#pragma unroll
        for (int v = 0; v < NPV; ++v)
          pv[v] = Cd<T>::ld(vr, (size_t)(i * NPV + v) * C);
#pragma unroll
        for (int v = 0; v < NLV; ++v)
          lv[v] = Cd<T>::ld(vr, (size_t)3 * NPV * C + (i * NLV + v) * C);
#pragma unroll
        for (int s = 0; s < S; ++s)
          dxs[s] = Cd<T>::rnd(DXs[(i * C + c) * MS + s * TR + rr]);
        product_rule<A, S>(i, dxs, pv, lv, dPV, dLV);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const Frac q2 = load_frac(fr + (size_t)row * 2 * FS + b * FS, i);
          float gg[16], dline[4];
          route_plane<A, S>(dPV, q2, gg);
          route_line<A, S>(dLV, q2, dline);
          T* dp = (T*)dP.p[b * 3 + i] + (size_t)row * 16 * C + c;
#pragma unroll
          for (int k = 0; k < 16; ++k) st(dp, (size_t)k * C, gg[k]);
          T* dl = (T*)dL.p[b * 3 + i] + (size_t)row * 4 * C + c;
#pragma unroll
          for (int k = 0; k < 4; ++k) st(dl, (size_t)k * C, dline[k]);
        }
      }
    }
    // ---- dpe: adjoint of the trig-addition PE offsets -------------------
    for (int idx = tid; idx < TR * E; idx += NT) {
      const int rr = idx / E, e = idx % E, row = row0 + rr;
      if (row >= N) continue;
      const float* Pt = DXs + (3 * C) * MS + rr;   // dX^T of the PE columns
      float a = Cd<T>::rnd(Pt[e * MS]);
      for (int s = 1; s < S; ++s) {
        const float* R = rot + (size_t)s * 4 * E;
        const int em = (e + E - 3) % E, ep = (e + 3) % E;
        const float t0 = __fmul_rn(Cd<T>::rnd(Pt[e * MS + s * TR]), R[e]);
        const float t1 =
            __fmul_rn(Cd<T>::rnd(Pt[em * MS + s * TR]), R[E + em]);
        const float t2 =
            __fmul_rn(Cd<T>::rnd(Pt[ep * MS + s * TR]), R[2 * E + ep]);
        a = __fadd_rn(__fadd_rn(__fadd_rn(a, t0), t1), t2);
      }
      dpe[(size_t)row * E + e] = Cd<T>::rnd(a);
    }
#endif  // SH_SKIP_TAPS
  }
  cp_wait<0>();                              // never leave a copy in flight
}

// part[z][a][b] = sum over rows k of split z of A[k][a] * Bm[k][b]: A
// [K, na], Bm [K, nb] row-major float32 (na, nb multiples of 4), part
// [splits, na, nb].  A block of rga x cgb threads takes a tile of 8 rga
// rows (ty*4.., 4 rga + ty*4..) x 8 cgb columns (tx*4.., 4 cgb + tx*4..),
// both operands through a two-slot cp.async ring of AKC rows (zero past
// the split and the widths).
__global__ void __launch_bounds__(ATB_NT, 2)
stencil_gen_atb(long long K, int kchunk, const float* __restrict__ A, int na,
                const float* __restrict__ Bm, int nb,
                float* __restrict__ part, int rga, int cgb) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int TA = 8 * rga, TB = 8 * cgb, slot = AKC * (TA + TB);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ty = tid / cgb, tx = tid % cgb;
  const int a0 = blockIdx.y * TA, b0 = blockIdx.x * TB;
  const long long k_begin = (long long)blockIdx.z * kchunk;
  const long long k_end = min(K, k_begin + kchunk);
  const int n_it = (int)((k_end - k_begin + AKC - 1) / AKC);
  auto fetch = [&](int it) {
    float* As = ring + (it & 1) * slot;
    float* Bs = As + AKC * TA;
    const long long k0 = k_begin + (long long)it * AKC;
    if (it < n_it) {
      const Walk wa(tid, nt, TA / 4), wb(tid, nt, TB / 4);
      for (int r = wa.r0, c = wa.c0; r < AKC; wa.step(r, c)) {
        const bool ok = k0 + r < k_end && a0 + 4 * c < na;
        cp16(As + r * TA + 4 * c,
             ok ? A + (size_t)(k0 + r) * na + a0 + 4 * c : A, ok);
      }
      for (int r = wb.r0, c = wb.c0; r < AKC; wb.step(r, c)) {
        const bool ok = k0 + r < k_end && b0 + 4 * c < nb;
        cp16(Bs + r * TB + 4 * c,
             ok ? Bm + (size_t)(k0 + r) * nb + b0 + 4 * c : Bm, ok);
      }
    }
    cp_commit();
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  fetch(0);
#pragma unroll 1
  for (int it = 0; it < n_it; ++it) {
    cp_wait<0>();
    __syncthreads();
    fetch(it + 1);
    const float* As = ring + (it & 1) * slot;
    const float* Bs = As + AKC * TA;
#pragma unroll 4
    for (int kk = 0; kk < AKC; ++kk) {
      const float4 x0 = ld4(As + kk * TA + ty * 4);
      const float4 x1 = ld4(As + kk * TA + 4 * rga + ty * 4);
      const float4 y0 = ld4(Bs + kk * TB + tx * 4);
      const float4 y1 = ld4(Bs + kk * TB + 4 * cgb + tx * 4);
      const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float b[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_wait<0>();
  float* out = part + (size_t)blockIdx.z * na * nb;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int a = a0 + (i < 4 ? ty * 4 + i : 4 * rga + ty * 4 + i - 4);
    if (a >= na) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int b = b0 + hf * 4 * cgb + tx * 4;
      if (b < nb)
        st4(out + (size_t)a * nb + b, acc[i][hf * 4], acc[i][hf * 4 + 1],
            acc[i][hf * 4 + 2], acc[i][hf * 4 + 3]);
    }
  }
}

// out[w] = sum over r of in[r, w] (in [R, W]), in a fixed order.
__global__ void __launch_bounds__(256)
stencil_gen_colsum(int R, long long W, const float* __restrict__ in,
                   float* __restrict__ out) {
  __shared__ float part[8][33];
  const int lane = threadIdx.x, g = threadIdx.y;
  const long long w = (long long)blockIdx.x * 32 + lane;
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
// launch
// ---------------------------------------------------------------------------

namespace {

bool bad_shape(int dtype, int S, int B, int N, int C, int E, int H, int O,
               int TR, int grid) {
  const int trmax = S == 7 ? TRMAX7 : TRMAX1;
  return (dtype != 0 && dtype != 1) || (S != 1 && S != 7) ||
         (B != 1 && B != 2) || N <= 0 || C < 1 || E < 1 || H < 1 || O < 1 ||
         3 * C + E > 2048 || H > 4096 || O > 4096 || TR < 1 || TR > trmax ||
         grid < 1;
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int S, int B>
cudaError_t launch_fwd(int N, int C, int E, int H, int O, int TR, int grid,
                       const Ptrs6& Pp, const Ptrs6& L, const float* fr,
                       const void* pe, const float* rot, const float* w0,
                       const float* b0, const float* w1, const float* w1row,
                       float* out_c, float* out_off, void* v_out,
                       cudaStream_t st) {
  const Plan P = make_plan(S, C, E, H, O, TR);
  const size_t smem = smem_fwd(P);
  auto kern = stencil_gen_fwd<T, S, B>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, st>>>(P, N, C, E, O, Pp, L, fr, (const T*)pe, rot,
                               w0, b0, w1, w1row, out_c, out_off, (T*)v_out);
  return cudaGetLastError();
}

struct BwdArgs {
  int N, C, E, H, O, TR, grid;
  const float* fr;
  const void* V;
  const void* pe;
  const float *rot, *w0, *w0t, *b0, *w1t, *w1row, *g_c, *g_off;
  MPtrs6 dP, dL;
  float* dpe;
  char* ws;
  float *dw0, *dw1, *dw1row;
  cudaStream_t st;
};

cudaError_t colsum(int R, long long W, const float* in, float* out,
                   cudaStream_t st) {
  stencil_gen_colsum<<<(unsigned)((W + 31) / 32), dim3(32, 8), 0, st>>>(
      R, W, in, out);
  return cudaGetLastError();
}

size_t atb_smem(const AtbShape& s) {
  return 4 * (size_t)2 * AKC * 8 * (s.rga + s.cgb);
}

cudaError_t atb(long long K, int ns, int chunk, const float* A, int na,
                const float* Bm, int nb, float* part, cudaStream_t st) {
  const AtbShape s(na, nb);
  const size_t smem = atb_smem(s);
  cudaError_t err = set_smem(stencil_gen_atb, smem);
  if (err != cudaSuccess) return err;
  stencil_gen_atb<<<dim3(s.tb, s.ta, ns), s.rga * s.cgb, smem, st>>>(
      K, chunk, A, na, Bm, nb, part, s.rga, s.cgb);
  return cudaGetLastError();
}

template <typename T, int S, int B>
cudaError_t launch_bwd(const BwdArgs& a) {
  const Plan P = make_plan(S, a.C, a.E, a.H, a.O, a.TR);
  const Layout lay(S, a.N, P, a.grid);
  const size_t smem = smem_bwd(P);
  auto kern = stencil_gen_bwd_rows<T, S, B>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  float* xg = (float*)(a.ws + lay.xg);
  float* dzg = (float*)(a.ws + lay.dzg);
  float* hg = (float*)(a.ws + lay.hg);
  float* gcg = (float*)(a.ws + lay.gcg);
  float* pw1 = (float*)(a.ws + lay.pw1);
  float* dxs = P.nwin > 1 ? (float*)(a.ws + lay.dxs) : nullptr;
  float* part0 = (float*)(a.ws + lay.part0);
  float* part1 = (float*)(a.ws + lay.part1);
  const int grid = a.grid < lay.tiles ? a.grid : lay.tiles;
  kern<<<grid, NT, smem, a.st>>>(
      P, a.N, a.C, a.E, a.O, a.fr, (const T*)a.V, (const T*)a.pe, a.rot,
      a.w0, a.w0t, a.b0, a.w1t, a.w1row, a.g_c, a.g_off, a.dP, a.dL, a.dpe,
      xg, dzg, hg, gcg, pw1, dxs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long r0 = (long long)lay.tiles * S * a.TR;
  const long long r1 = (long long)lay.tiles * a.TR;
  if ((err = atb(r0, lay.ns0, lay.ch0, xg, P.K4, dzg, P.H4, part0, a.st)))
    return err;
  if ((err = atb(r1, lay.ns1, lay.ch1, hg, P.H4, gcg, P.O4, part1, a.st)))
    return err;
  if ((err = colsum(lay.ns0, (long long)P.K4 * P.H4, part0, a.dw0, a.st)))
    return err;
  if ((err = colsum(lay.ns1, (long long)P.H4 * P.O4, part1, a.dw1, a.st)))
    return err;
  return colsum(grid, P.H4, pw1, a.dw1row, a.st);
}

template <typename T, int S, int B>
int info_rows(int kind, const Plan& P, int* out) {
  return kind == 0 ? f32k::kernel_info(stencil_gen_fwd<T, S, B>, NT,
                                       smem_fwd(P), out)
                   : f32k::kernel_info(stencil_gen_bwd_rows<T, S, B>, NT,
                                       smem_bwd(P), out);
}

}  // namespace

// Bytes of shared memory a block of the forward (kind 0) or backward row
// kernel (kind 1) asks for at TR rows a tile; 0 for a shape these kernels
// do not take.
extern "C" long long stencil_gen_smem(int kind, int S, int C, int E, int H,
                                      int O, int TR) {
  if (bad_shape(0, S, 1, 1, C, E, H, O, TR, 1)) return 0;
  const Plan P = make_plan(S, C, E, H, O, TR);
  return (long long)(kind == 0 ? smem_fwd(P) : smem_bwd(P));
}

// Bytes of the device workspace stencil_gen_bwd needs at `grid` row
// blocks (the caller allocates it); 0 for a shape these kernels do not
// take.
extern "C" long long stencil_gen_bwd_workspace(int S, int N, int C, int E,
                                               int H, int O, int TR,
                                               int grid) {
  if (bad_shape(0, S, 1, N, C, E, H, O, TR, grid)) return 0;
  return (long long)Layout(S, N, make_plan(S, C, E, H, O, TR), grid).total;
}

// What the card gives a general kernel at these widths: out = blocks per
// SM, registers and local (spill) bytes a thread, shared memory a block.
// kind 0 = stencil_gen_fwd<T,S,B>, 1 = stencil_gen_bwd_rows<T,S,B> (at TR
// rows a tile), 2 = stencil_gen_atb at dW0's output [K4, H4], 3 = at
// dW1's [H4, O4].  Returns a cudaError_t (0 = success).
extern "C" int stencil_gen_info(int kind, int dtype, int S, int B, int C,
                                int E, int H, int O, int TR, int* out) {
  if (bad_shape(dtype, S, B, 1, C, E, H, O, TR, 1) || kind < 0 || kind > 3)
    return (int)cudaErrorInvalidValue;
  const Plan P = make_plan(S, C, E, H, O, TR);
  if (kind >= 2) {
    const AtbShape s = kind == 2 ? AtbShape(P.K4, P.H4) : AtbShape(P.H4, P.O4);
    return f32k::kernel_info(stencil_gen_atb, s.rga * s.cgb, atb_smem(s),
                             out);
  }
#define GEN_CASE(SS, BB)                                                 \
  if (S == SS && B == BB)                                                \
    return dtype == 0 ? info_rows<float, SS, BB>(kind, P, out)           \
                      : info_rows<__nv_bfloat16, SS, BB>(kind, P, out)
  GEN_CASE(7, 1);
  GEN_CASE(7, 2);
  GEN_CASE(1, 1);
  GEN_CASE(1, 2);
#undef GEN_CASE
  return (int)cudaErrorInvalidValue;
}

// dtype 0 = float32, 1 = bfloat16 patches, V and pe; the weights are the
// zero-padded float32 operands of ops/stencil.py pack_weights_general:
// w0 [K4, H4], b0 [H4], w1 [H4, O4], w1row [H4] (K4 = round4(3C+E+1),
// H4 = round4(H), O4 = round4(O)).  TR: rows of the head's input a tile;
// grid: persistent blocks (ops/stencil.py gen_grid).  Returns a
// cudaError_t (0 = success).
extern "C" int stencil_gen_fwd_launch(int dtype, int S, int B, int N, int C,
                                      int E, int H, int O, int TR, int grid,
                                      const void* const* pp,
                                      const void* const* lp, const float* fr,
                                      const void* pe, const float* rot,
                                      const float* w0, const float* b0,
                                      const float* w1, const float* w1row,
                                      float* out_c, float* out_off,
                                      void* v_out, void* stream) {
  if (bad_shape(dtype, S, B, N, C, E, H, O, TR, grid))
    return (int)cudaErrorInvalidValue;
  Ptrs6 P, L;
  for (int k = 0; k < 6; ++k) {
    P.p[k] = k < 3 * B ? pp[k] : nullptr;
    L.p[k] = k < 3 * B ? lp[k] : nullptr;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (N + TR - 1) / TR;
  if (grid > tiles) grid = tiles;
#define GEN_CASE(SS, BB)                                                    \
  if (S == SS && B == BB)                                                   \
    return (int)(dtype == 0                                                 \
                     ? launch_fwd<float, SS, BB>(N, C, E, H, O, TR, grid,   \
                                                 P, L, fr, pe, rot, w0, b0, \
                                                 w1, w1row, out_c, out_off, \
                                                 v_out, st)                 \
                     : launch_fwd<__nv_bfloat16, SS, BB>(                   \
                           N, C, E, H, O, TR, grid, P, L, fr, pe, rot, w0,  \
                           b0, w1, w1row, out_c, out_off, v_out, st))
  GEN_CASE(7, 1);
  GEN_CASE(7, 2);
  GEN_CASE(1, 1);
  GEN_CASE(1, 2);
#undef GEN_CASE
  return (int)cudaErrorInvalidValue;
}

// The backward: w0 [K4, H4], w0t = W0^T [H4, K4], b0 [H4], w1t = W1^T
// [O4, H4], w1row [H4] (as the forward's, zero padded float32); g_c [N, O],
// g_off [S-1, N] float32; dP / dL in the patch dtype, dpe [N, E] float32.
// Outputs dw0 [K4, H4] (row 3C+E is db0), dw1 [H4, O4], dw1row [H4], all
// float32.  ws_bytes must be stencil_gen_bwd_workspace's at the same grid.
// Returns a cudaError_t (0 = success).
extern "C" int stencil_gen_bwd_launch(
    int dtype, int S, int B, int N, int C, int E, int H, int O, int TR,
    int grid, const float* fr, const void* V, const void* pe,
    const float* rot, const float* w0, const float* w0t, const float* b0,
    const float* w1t, const float* w1row, const float* g_c,
    const float* g_off, void* const* dP, void* const* dL, float* dpe,
    void* workspace, long long ws_bytes, float* dw0, float* dw1,
    float* dw1row, void* stream) {
  if (bad_shape(dtype, S, B, N, C, E, H, O, TR, grid) ||
      ws_bytes !=
          (long long)Layout(S, N, make_plan(S, C, E, H, O, TR), grid).total)
    return (int)cudaErrorInvalidValue;
  BwdArgs a = {N,     C,   E,   H,     O,   TR,    grid, fr, V,  pe,
               rot,   w0,  w0t, b0,    w1t, w1row, g_c,  g_off, {}, {},
               dpe,   static_cast<char*>(workspace), dw0, dw1, dw1row,
               (cudaStream_t)stream};
  for (int k = 0; k < 6; ++k) {
    a.dP.p[k] = k < 3 * B ? dP[k] : nullptr;
    a.dL.p[k] = k < 3 * B ? dL[k] : nullptr;
  }
#define GEN_CASE(SS, BB)                                         \
  if (S == SS && B == BB)                                        \
    return (int)(dtype == 0 ? launch_bwd<float, SS, BB>(a)       \
                            : launch_bwd<__nv_bfloat16, SS, BB>(a))
  GEN_CASE(7, 1);
  GEN_CASE(7, 2);
  GEN_CASE(1, 1);
  GEN_CASE(1, 2);
#undef GEN_CASE
  return (int)cudaErrorInvalidValue;
}
