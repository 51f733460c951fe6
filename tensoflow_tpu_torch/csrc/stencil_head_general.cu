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
// Design (simple first; a later change can make it fast):
//   stencil_gen_fwd — one block of 256 threads a tile of TR rows of the
//     head's input = S*TR X rows (TR from the widths, so that shared memory
//     fits: ops/stencil.py gen_tile_rows).  The taps (stencil_common.cuh,
//     one (row, channel) a thread) write X rows into shared memory and the
//     tap variants V to global memory for the backward.  Then over the
//     hidden width in chunks of 64 columns: z = X.W0[:, chunk] + b0 as
//     register blocks (up to 8 rows x 4 columns a thread), W0 staged 32
//     rows at a time through shared memory; softplus(beta=100); the
//     centre's h into shared memory, the offsets' h.w1row summed in
//     registers (a fixed-order warp reduction at the end).  Last, layer 1
//     of the centre rows over the whole hidden width, 64 output columns at
//     a time, W1 staged the same way.
//   stencil_gen_bwd_rows — the same tile: X rebuilt from V (with a ones
//     column at 3C+E, whose dW0 row is db0), the centre cotangent in shared
//     memory; per hidden chunk dh = g.W1^T (centre) or g_off * w1row
//     (offsets), z again, dz = dh * softplus'(z); dX += dz.W0^T[chunk]
//     accumulated in shared memory.  Then the product rule and the
//     transposed hat weights route dX to dP and dL, and the PE columns to
//     dpe.  X, dz, the centre h and cotangent go to a workspace, with one
//     dw1row partial per tile (its offset rows' h.g_off, summed in order).
//   stencil_gen_atb — part[z] = A^T.B over split z of the workspace's rows
//     (at most 1024 rows a split), 64 x 64 output tiles, both operands
//     staged 32 rows at a time: dW0 = X^T.dz, dW1 = h^T.g.
//   stencil_gen_colsum — fixed-order sums of the partials, so that two
//     runs give bit-identical gradients (no atomics anywhere).
// All products are float32 FMAs on float32 operands; in bf16 the operands
// are rounded where the plain version (ops/stencil.py stencil_head_plain)
// rounds them: the taps op by op, X, h, dh and dX to bf16, W0 and W1 to
// bf16 (by the caller), float32 accumulation.
#include "stencil_common.cuh"

using namespace sh;

namespace gen {

constexpr int NT = 256;       // threads a block: 16 row x 16 column groups
constexpr int RMAX = 8;       // X rows a thread at most (tiles <= 128 rows)
constexpr int KC = 32;        // rows of a staged operand chunk
constexpr int NC = 64;        // columns of a product tile
constexpr int NCP = NC + 4;   // row pitch of the dz chunk in shared memory
constexpr int TRMAX7 = 16;    // rows of the head's input a tile, S = 7
constexpr int TRMAX1 = 128;   // S = 1
constexpr int AKMAX = 1024;   // rows one weight-gradient partial sums
constexpr size_t SMEM_MAX = 232448;   // the most one block may ask for

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// The widths of one head: K = 3C+E X columns, K4 = X row width in the
// workspace (room for the ones column at K), XP its pitch in shared
// memory, H4 / O4 hidden and layer-1 widths rounded up to 4.
struct Dims {
  int K, K4, XP, H4, O4;
  __host__ __device__ Dims(int C, int E, int H, int O) {
    K = 3 * C + E;
    K4 = round4(K + 1);
    XP = K4 + 4;
    H4 = round4(H);
    O4 = round4(O);
  }
};

__host__ inline size_t smem_fwd(int S, const Dims& d, int tr) {
  return 4 * ((size_t)S * tr * d.XP + (size_t)tr * (d.H4 + 4) + KC * NC);
}
__host__ inline size_t smem_bwd(int S, const Dims& d, int tr) {
  return 4 * (2 * (size_t)S * tr * d.XP + (size_t)tr * (d.O4 + 4) +
              (size_t)S * tr * NCP + KC * NC + 16 * NC);
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

inline size_t pad256(size_t b) { return (b + 255) / 256 * 256; }

// The workspace of stencil_gen_bwd, piece by piece (bytes from its start).
struct Layout {
  size_t xg, dzg, hg, gcg, pw1, part0, part1, total;
  int tiles, ns0, ch0, ns1, ch1;
  Layout(int S, int N, const Dims& d, int tr) {
    tiles = (N + tr - 1) / tr;
    const long long r0 = (long long)tiles * S * tr, r1 = (long long)tiles * tr;
    splits(r0, &ns0, &ch0);
    splits(r1, &ns1, &ch1);
    size_t at = 0;
    xg = at;    at += pad256(4 * (size_t)r0 * d.K4);
    dzg = at;   at += pad256(4 * (size_t)r0 * d.H4);
    hg = at;    at += pad256(4 * (size_t)r1 * d.H4);
    gcg = at;   at += pad256(4 * (size_t)r1 * d.O4);
    pw1 = at;   at += pad256(4 * (size_t)tiles * d.H4);
    part0 = at; at += pad256(4 * (size_t)ns0 * d.K4 * d.H4);
    part1 = at; at += pad256(4 * (size_t)ns1 * d.H4 * d.O4);
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += sum over k < kdim of A[m_i][k] * B[k][col0 + 4 cx + j], for
// this thread's rows m_i = ry + 16 i < rows (ry = tid / 16, cx = tid % 16).
// A: shared memory, row pitch lda (a multiple of 4), finite up to
// round4(kdim).  B: global, [kdim, ncols] row-major, row pitch ldb (a
// multiple of 4, ncols too), staged KC rows at a time through Bs [KC][NC],
// zero past kdim and ncols.  Starts with a barrier: what the block wrote
// to A before the call is visible.
__device__ __forceinline__ void tile_mm(float (&acc)[RMAX][4],
                                        const float* A, int lda, int rows,
                                        const float* __restrict__ B, int ldb,
                                        int kdim, int ncols, int col0,
                                        float* Bs) {
  const int tid = threadIdx.x, ry = tid >> 4, cx = tid & 15;
  for (int k0 = 0; k0 < kdim; k0 += KC) {
    __syncthreads();                 // the last chunk's readers are done
    for (int idx = tid; idx < KC * NC / 4; idx += NT) {
      const int r = idx / (NC / 4), c4 = (idx % (NC / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < kdim && col0 + c4 < ncols)
        v = __ldg(reinterpret_cast<const float4*>(
            B + (size_t)(k0 + r) * ldb + col0 + c4));
      *reinterpret_cast<float4*>(Bs + r * NC + c4) = v;
    }
    __syncthreads();
    const int kn = round4(min(KC, kdim - k0));
#pragma unroll 1
    for (int kk = 0; kk < kn; kk += 4) {
      float4 b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = ld4(Bs + (kk + q) * NC + cx * 4);
#pragma unroll
      for (int i = 0; i < RMAX; ++i) {
        const int m = ry + 16 * i;
        if (m >= rows) break;
        const float4 a = ld4(A + (size_t)m * lda + k0 + kk);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(av[q], b[q].x, acc[i][0]);
          acc[i][1] = fmaf(av[q], b[q].y, acc[i][1]);
          acc[i][2] = fmaf(av[q], b[q].z, acc[i][2]);
          acc[i][3] = fmaf(av[q], b[q].w, acc[i][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[RMAX][4]) {
#pragma unroll
  for (int i = 0; i < RMAX; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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
__global__ void __launch_bounds__(NT)
stencil_gen_fwd(int N, int C, int E, int H, int O, int TR, Ptrs6 pp,
                Ptrs6 lp, const float* __restrict__ fr,
                const T* __restrict__ pe, const float* __restrict__ rot,
                const float* __restrict__ w0, const float* __restrict__ b0,
                const float* __restrict__ w1,
                const float* __restrict__ w1row, float* __restrict__ out_c,
                float* __restrict__ out_off, T* __restrict__ v_out) {
  using A = typename Pol<T>::A;
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
  extern __shared__ __align__(16) float smem[];
  const Dims d(C, E, H, O);
  const int M = S * TR, HP = d.H4 + 4;
  float* Xs = smem;                          // X [M][XP]
  float* Hc = Xs + (size_t)M * d.XP;         // centre h [TR][HP]
  float* Bs = Hc + (size_t)TR * HP;          // staged operand [KC][NC]
  const int tid = threadIdx.x, ry = tid >> 4, cx = tid & 15;
  const int row0 = blockIdx.x * TR;
  const int VW = (NPV + NLV) * 3 * C;

  for (int idx = tid; idx < M * d.XP; idx += NT) Xs[idx] = 0.f;
  __syncthreads();
  // ---- taps: one (row, channel) a thread; X rows and V ------------------
  for (int q = tid; q < TR * C; q += NT) {
    const int r = q / C, c = q % C, row = row0 + r;
    if (row >= N) continue;
    float PV[3][NPV], LV[3][NLV];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float* f = fr + (size_t)row * 2 * FS + b * FS;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const Frac q2 = load_frac(f, i);
        const T* P = (const T*)pp.p[b * 3 + i] + (size_t)row * 16 * C + c;
        float sl[16], pv[NPV];
#pragma unroll
        for (int k = 0; k < 16; ++k) sl[k] = Cd<T>::ld(P, (size_t)k * C);
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
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float x[S];
      x_products<A, S>(i, PV[i], LV[i], x);
#pragma unroll
      for (int s = 0; s < S; ++s)
        Xs[(size_t)(s * TR + r) * d.XP + i * C + c] = x[s];
    }
  }
  // ---- PE columns -----------------------------------------------------
  for (int idx = tid; idx < TR * E; idx += NT) {
    const int r = idx / E, e = idx % E, row = row0 + r;
    if (row >= N) continue;
    const float p0 = Cd<T>::ld(pe, (size_t)row * E + e);
    const float pm3 = Cd<T>::ld(pe, (size_t)row * E + (e + 3) % E);
    const float pp3 = Cd<T>::ld(pe, (size_t)row * E + (e + E - 3) % E);
#pragma unroll
    for (int s = 0; s < S; ++s)
      Xs[(size_t)(s * TR + r) * d.XP + 3 * C + e] =
          pe_point<T>(s, e, E, p0, pm3, pp3, rot);
  }

  // ---- layer 0 + softplus over hidden chunks --------------------------
  float part[RMAX];                          // offset rows: h . w1row
#pragma unroll
  for (int i = 0; i < RMAX; ++i) part[i] = 0.f;
  float acc[RMAX][4];
#pragma unroll 1
  for (int h0 = 0; h0 < d.H4; h0 += NC) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = h0 + cx * 4 + j;
      const float bj = n < d.H4 ? __ldg(b0 + n) : 0.f;
#pragma unroll
      for (int i = 0; i < RMAX; ++i) acc[i][j] = bj;
    }
    tile_mm(acc, Xs, d.XP, M, w0, d.H4, d.K, d.H4, h0, Bs);
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      const int m = ry + 16 * i;
      if (m >= M) break;
      const int s = m / TR, r = m % TR;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = h0 + cx * 4 + j;
        if (n >= d.H4) continue;
        float h, sig;
        softplus100(100.f * acc[i][j], &h, &sig);
        h = Cd<T>::rnd(h);
        if (s == 0) Hc[(size_t)r * HP + n] = h;
        else part[i] = fmaf(h, __ldg(w1row + n), part[i]);
      }
    }
  }
  // ---- offsets: the sdf column, summed over the 16 column threads -----
  if (S > 1) {
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      float v = part[i];
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int m = ry + 16 * i, s = m / TR, row = row0 + m % TR;
      if (cx == 0 && m < M && s >= 1 && row < N)
        out_off[(size_t)(s - 1) * N + row] = v;
    }
  }
  // ---- layer 1 of the centre rows, 64 output columns at a time --------
#pragma unroll 1
  for (int o0 = 0; o0 < d.O4; o0 += NC) {
    zero_acc(acc);
    tile_mm(acc, Hc, HP, TR, w1, d.O4, d.H4, d.O4, o0, Bs);
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      const int r = ry + 16 * i, row = row0 + r;
      if (r >= TR) break;
      if (row >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + cx * 4 + j;
        if (o < O) out_c[(size_t)row * O + o] = acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// w0 [K4][H4], w0t [H4][K4], b0 [H4], w1t = W1^T [O4][H4], w1row [H4]:
// zero padded float32.  Workspace rows of tile t: X and dz rows t*S*TR +
// s*TR + r, h and the cotangent rows t*TR + r.
template <typename T, int S, int B>
__global__ void __launch_bounds__(NT)
stencil_gen_bwd_rows(int N, int C, int E, int H, int O, int TR,
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
                     float* __restrict__ gcg, float* __restrict__ p_dw1row) {
  using A = typename Pol<T>::A;
  constexpr int NPV = Var<S>::NPV, NLV = Var<S>::NLV;
  extern __shared__ __align__(16) float smem[];
  const Dims d(C, E, H, O);
  const int M = S * TR, OPi = d.O4 + 4;
  float* Xs = smem;                          // X [M][XP]
  float* DX = Xs + (size_t)M * d.XP;         // dX [M][XP]
  float* Gs = DX + (size_t)M * d.XP;         // centre cotangent [TR][OPi]
  float* Dz = Gs + (size_t)TR * OPi;         // dz of one chunk [M][NCP]
  float* Bs = Dz + (size_t)M * NCP;          // staged operand [KC][NC]
  float* W1A = Bs + KC * NC;                 // dw1row terms [16][NC]
  const int tid = threadIdx.x, ry = tid >> 4, cx = tid & 15;
  const int row0 = blockIdx.x * TR;
  const size_t xr0 = (size_t)blockIdx.x * M;     // workspace X / dz rows
  const size_t hr0 = (size_t)blockIdx.x * TR;    // workspace h / g rows
  const int VW = (NPV + NLV) * 3 * C;

  for (int idx = tid; idx < 2 * M * d.XP; idx += NT) Xs[idx] = 0.f;
  __syncthreads();
  // ---- X from V (zero past N), with a ones column at K ------------------
  for (int q = tid; q < TR * C; q += NT) {
    const int r = q / C, c = q % C, row = row0 + r;
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
        const int m = s * TR + r;
        Xs[(size_t)m * d.XP + i * C + c] = x[s];
        xg[(xr0 + m) * d.K4 + i * C + c] = x[s];
      }
    }
  }
  for (int idx = tid; idx < TR * E; idx += NT) {
    const int r = idx / E, e = idx % E, row = row0 + r;
    float p0 = 0.f, pm3 = 0.f, pp3 = 0.f;
    if (row < N) {
      p0 = Cd<T>::ld(pe, (size_t)row * E + e);
      pm3 = Cd<T>::ld(pe, (size_t)row * E + (e + 3) % E);
      pp3 = Cd<T>::ld(pe, (size_t)row * E + (e + E - 3) % E);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int m = s * TR + r;
      const float x = row < N ? pe_point<T>(s, e, E, p0, pm3, pp3, rot) : 0.f;
      Xs[(size_t)m * d.XP + 3 * C + e] = x;
      xg[(xr0 + m) * d.K4 + 3 * C + e] = x;
    }
  }
  // the ones column (W0's row K is zero: z does not see it) and the pad
  for (int idx = tid; idx < M * (d.K4 - d.K); idx += NT) {
    const int m = idx / (d.K4 - d.K), col = d.K + idx % (d.K4 - d.K);
    const float v = col == d.K ? 1.f : 0.f;
    Xs[(size_t)m * d.XP + col] = v;
    xg[(xr0 + m) * d.K4 + col] = v;
  }
  // the centre cotangent, zero past O and N
  for (int idx = tid; idx < TR * d.O4; idx += NT) {
    const int r = idx / d.O4, o = idx % d.O4, row = row0 + r;
    const float v = (row < N && o < O) ? __ldg(g_c + (size_t)row * O + o)
                                       : 0.f;
    Gs[(size_t)r * OPi + o] = v;
    gcg[(hr0 + r) * d.O4 + o] = v;
  }

  float acc[RMAX][4], adh[RMAX][4];
#pragma unroll 1
  for (int h0 = 0; h0 < d.H4; h0 += NC) {
    // ---- dh = g.W1^T for the centre rows ------------------------------
    zero_acc(adh);
    tile_mm(adh, Gs, OPi, TR, w1t, d.H4, d.O4, d.H4, h0, Bs);
    // ---- z = X.W0 + b0 --------------------------------------------------
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = h0 + cx * 4 + j;
      const float bj = n < d.H4 ? __ldg(b0 + n) : 0.f;
#pragma unroll
      for (int i = 0; i < RMAX; ++i) acc[i][j] = bj;
    }
    tile_mm(acc, Xs, d.XP, M, w0, d.H4, d.K, d.H4, h0, Bs);
    // ---- softplus' -> dz; workspace; dw1row terms -----------------------
    float w1p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      const int m = ry + 16 * i;
      if (m >= M) break;
      const int s = m / TR, r = m % TR, row = row0 + r;
      const float go = (s >= 1 && row < N)
                           ? __ldg(g_off + (size_t)(s - 1) * N + row)
                           : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = h0 + cx * 4 + j;
        float dz = 0.f;
        if (n < d.H4) {
          float h, sig;
          softplus100(100.f * acc[i][j], &h, &sig);
          h = Cd<T>::rnd(h);
          float dh;
          if (s == 0) {
            dh = Cd<T>::rnd(adh[i][j]);
            hg[(hr0 + r) * d.H4 + n] = h;
          } else {
            dh = Cd<T>::rnd(go * __ldg(w1row + n));
            w1p[j] = fmaf(h, go, w1p[j]);
          }
          dz = dh * sig;
          dzg[(xr0 + m) * d.H4 + n] = dz;
        }
        Dz[(size_t)m * NCP + cx * 4 + j] = dz;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) W1A[ry * NC + cx * 4 + j] = w1p[j];
    __syncthreads();
    if (tid < NC && h0 + tid < d.H4) {
      float t = 0.f;
      for (int y = 0; y < 16; ++y) t += W1A[y * NC + tid];
      p_dw1row[(size_t)blockIdx.x * d.H4 + h0 + tid] = t;
    }
    // ---- dX += dz.W0^T[h0:h0+kh] ----------------------------------------
    const int kh = min(NC, d.H4 - h0);
#pragma unroll 1
    for (int k0 = 0; k0 < d.K4; k0 += NC) {
      zero_acc(acc);
      tile_mm(acc, Dz, NCP, M, w0t + (size_t)h0 * d.K4, d.K4, kh, d.K4, k0,
              Bs);
#pragma unroll
      for (int i = 0; i < RMAX; ++i) {
        const int m = ry + 16 * i;
        if (m >= M) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + cx * 4 + j;
          if (k < d.K4) DX[(size_t)m * d.XP + k] += acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  // ---- product rule + hat-weight routing ------------------------------
  for (int q = tid; q < TR * C; q += NT) {
    const int r = q / C, c = q % C, row = row0 + r;
    if (row >= N) continue;
    const T* vr = V + (size_t)row * VW + c;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float pv[NPV], lv[NLV], dxs[S], dPV[NPV], dLV[NLV];
#pragma unroll
      for (int v = 0; v < NPV; ++v) pv[v] = Cd<T>::ld(vr, (size_t)(i * NPV + v) * C);
#pragma unroll
      for (int v = 0; v < NLV; ++v)
        lv[v] = Cd<T>::ld(vr, (size_t)3 * NPV * C + (i * NLV + v) * C);
#pragma unroll
      for (int s = 0; s < S; ++s)
        dxs[s] = Cd<T>::rnd(DX[(size_t)(s * TR + r) * d.XP + i * C + c]);
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
    const int r = idx / E, e = idx % E, row = row0 + r;
    if (row >= N) continue;
    const float* P = DX + (size_t)r * d.XP + 3 * C;   // stencil point 0
    const size_t ps = (size_t)TR * d.XP;               // to the next point
    float a = Cd<T>::rnd(P[e]);
    for (int s = 1; s < S; ++s) {
      const float* R = rot + (size_t)s * 4 * E;
      const int em = (e + E - 3) % E, ep = (e + 3) % E;
      const float t0 = __fmul_rn(Cd<T>::rnd(P[s * ps + e]), R[e]);
      const float t1 = __fmul_rn(Cd<T>::rnd(P[s * ps + em]), R[E + em]);
      const float t2 = __fmul_rn(Cd<T>::rnd(P[s * ps + ep]), R[2 * E + ep]);
      a = __fadd_rn(__fadd_rn(__fadd_rn(a, t0), t1), t2);
    }
    dpe[(size_t)row * E + e] = Cd<T>::rnd(a);
  }
}

// part[z][a][b] = sum over rows k of split z of A[k][a] * Bm[k][b]: A
// [K, na], Bm [K, nb] row-major float32 (na, nb multiples of 4), part
// [splits, na, nb].  A 64 x 64 output tile a block, 4 x 4 a thread, both
// operands staged KC rows at a time (zero past the split).
__global__ void __launch_bounds__(NT)
stencil_gen_atb(long long K, int kchunk, const float* __restrict__ A, int na,
                const float* __restrict__ Bm, int nb,
                float* __restrict__ part) {
  __shared__ __align__(16) float As[KC][NC];
  __shared__ __align__(16) float Bs[KC][NC];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int a0 = blockIdx.y * NC, b0 = blockIdx.x * NC;
  const long long k_begin = (long long)blockIdx.z * kchunk;
  const long long k_end = min(K, k_begin + kchunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (long long k0 = k_begin; k0 < k_end; k0 += KC) {
    __syncthreads();
    for (int idx = tid; idx < 2 * KC * NC / 4; idx += NT) {
      const int w = idx / (KC * NC / 4), rem = idx % (KC * NC / 4);
      const int r = rem / (NC / 4), c4 = (rem % (NC / 4)) * 4;
      const int n = w ? nb : na, c0 = w ? b0 : a0;
      const float* src = w ? Bm : A;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < k_end && c0 + c4 < n)
        v = __ldg(reinterpret_cast<const float4*>(
            src + (size_t)(k0 + r) * n + c0 + c4));
      *reinterpret_cast<float4*>(w ? &Bs[r][c4] : &As[r][c4]) = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a = ld4(&As[kk][ty * 4]), b = ld4(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  float* out = part + (size_t)blockIdx.z * na * nb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty * 4 + i;
    if (a >= na) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tx * 4 + j;
      if (b < nb) out[(size_t)a * nb + b] = acc[i][j];
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
               int TR) {
  const int trmax = S == 7 ? TRMAX7 : TRMAX1;
  return (dtype != 0 && dtype != 1) || (S != 1 && S != 7) ||
         (B != 1 && B != 2) || N <= 0 || C < 1 || E < 1 || H < 1 || O < 1 ||
         3 * C + E > 2048 || H > 4096 || O > 4096 || TR < 1 || TR > trmax;
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int S, int B>
cudaError_t launch_fwd(int N, int C, int E, int H, int O, int TR,
                       const Ptrs6& P, const Ptrs6& L, const float* fr,
                       const void* pe, const float* rot, const float* w0,
                       const float* b0, const float* w1, const float* w1row,
                       float* out_c, float* out_off, void* v_out,
                       cudaStream_t st) {
  const Dims d(C, E, H, O);
  const size_t smem = smem_fwd(S, d, TR);
  auto kern = stencil_gen_fwd<T, S, B>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<(N + TR - 1) / TR, NT, smem, st>>>(
      N, C, E, H, O, TR, P, L, fr, (const T*)pe, rot, w0, b0, w1, w1row,
      out_c, out_off, (T*)v_out);
  return cudaGetLastError();
}

struct BwdArgs {
  int N, C, E, H, O, TR;
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

cudaError_t atb(long long K, int ns, int chunk, const float* A, int na,
                const float* Bm, int nb, float* part, cudaStream_t st) {
  const dim3 grid((nb + NC - 1) / NC, (na + NC - 1) / NC, ns);
  stencil_gen_atb<<<grid, NT, 0, st>>>(K, chunk, A, na, Bm, nb, part);
  return cudaGetLastError();
}

template <typename T, int S, int B>
cudaError_t launch_bwd(const BwdArgs& a) {
  const Dims d(a.C, a.E, a.H, a.O);
  const Layout lay(S, a.N, d, a.TR);
  const size_t smem = smem_bwd(S, d, a.TR);
  auto kern = stencil_gen_bwd_rows<T, S, B>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  float* xg = (float*)(a.ws + lay.xg);
  float* dzg = (float*)(a.ws + lay.dzg);
  float* hg = (float*)(a.ws + lay.hg);
  float* gcg = (float*)(a.ws + lay.gcg);
  float* pw1 = (float*)(a.ws + lay.pw1);
  float* part0 = (float*)(a.ws + lay.part0);
  float* part1 = (float*)(a.ws + lay.part1);
  kern<<<lay.tiles, NT, smem, a.st>>>(
      a.N, a.C, a.E, a.H, a.O, a.TR, a.fr, (const T*)a.V, (const T*)a.pe,
      a.rot, a.w0, a.w0t, a.b0, a.w1t, a.w1row, a.g_c, a.g_off, a.dP, a.dL,
      a.dpe, xg, dzg, hg, gcg, pw1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long r0 = (long long)lay.tiles * S * a.TR;
  const long long r1 = (long long)lay.tiles * a.TR;
  if ((err = atb(r0, lay.ns0, lay.ch0, xg, d.K4, dzg, d.H4, part0, a.st)))
    return err;
  if ((err = atb(r1, lay.ns1, lay.ch1, hg, d.H4, gcg, d.O4, part1, a.st)))
    return err;
  if ((err = colsum(lay.ns0, (long long)d.K4 * d.H4, part0, a.dw0, a.st)))
    return err;
  if ((err = colsum(lay.ns1, (long long)d.H4 * d.O4, part1, a.dw1, a.st)))
    return err;
  return colsum(lay.tiles, d.H4, pw1, a.dw1row, a.st);
}

}  // namespace

// Bytes of shared memory a block of the forward (kind 0) or backward row
// kernel (kind 1) asks for at TR rows a tile; 0 for a shape these kernels
// do not take.
extern "C" long long stencil_gen_smem(int kind, int S, int C, int E, int H,
                                      int O, int TR) {
  if (bad_shape(0, S, 1, 1, C, E, H, O, TR)) return 0;
  const Dims d(C, E, H, O);
  return (long long)(kind == 0 ? smem_fwd(S, d, TR) : smem_bwd(S, d, TR));
}

// Bytes of the device workspace stencil_gen_bwd needs (the caller
// allocates it); 0 for a shape these kernels do not take.
extern "C" long long stencil_gen_bwd_workspace(int S, int N, int C, int E,
                                               int H, int O, int TR) {
  if (bad_shape(0, S, 1, N, C, E, H, O, TR)) return 0;
  return (long long)Layout(S, N, Dims(C, E, H, O), TR).total;
}

// dtype 0 = float32, 1 = bfloat16 patches, V and pe; the weights are the
// zero-padded float32 operands of ops/stencil.py pack_weights_general:
// w0 [K4, H4], b0 [H4], w1 [H4, O4], w1row [H4] (K4 = round4(3C+E+1),
// H4 = round4(H), O4 = round4(O)).  TR: rows of the head's input a block.
// Returns a cudaError_t (0 = success).
extern "C" int stencil_gen_fwd_launch(int dtype, int S, int B, int N, int C,
                                      int E, int H, int O, int TR,
                                      const void* const* pp,
                                      const void* const* lp, const float* fr,
                                      const void* pe, const float* rot,
                                      const float* w0, const float* b0,
                                      const float* w1, const float* w1row,
                                      float* out_c, float* out_off,
                                      void* v_out, void* stream) {
  if (bad_shape(dtype, S, B, N, C, E, H, O, TR))
    return (int)cudaErrorInvalidValue;
  Ptrs6 P, L;
  for (int k = 0; k < 6; ++k) {
    P.p[k] = k < 3 * B ? pp[k] : nullptr;
    L.p[k] = k < 3 * B ? lp[k] : nullptr;
  }
  cudaStream_t st = (cudaStream_t)stream;
#define GEN_CASE(SS, BB)                                                    \
  if (S == SS && B == BB)                                                   \
    return (int)(dtype == 0                                                 \
                     ? launch_fwd<float, SS, BB>(N, C, E, H, O, TR, P, L,   \
                                                 fr, pe, rot, w0, b0, w1,   \
                                                 w1row, out_c, out_off,     \
                                                 v_out, st)                 \
                     : launch_fwd<__nv_bfloat16, SS, BB>(                   \
                           N, C, E, H, O, TR, P, L, fr, pe, rot, w0, b0,    \
                           w1, w1row, out_c, out_off, v_out, st))
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
// float32.  ws_bytes must be stencil_gen_bwd_workspace's.  Returns a
// cudaError_t (0 = success).
extern "C" int stencil_gen_bwd_launch(
    int dtype, int S, int B, int N, int C, int E, int H, int O, int TR,
    const float* fr, const void* V, const void* pe, const float* rot,
    const float* w0, const float* w0t, const float* b0, const float* w1t,
    const float* w1row, const float* g_c, const float* g_off,
    void* const* dP, void* const* dL, float* dpe, void* workspace,
    long long ws_bytes, float* dw0, float* dw1, float* dw1row,
    void* stream) {
  if (bad_shape(dtype, S, B, N, C, E, H, O, TR) ||
      ws_bytes != (long long)Layout(S, N, Dims(C, E, H, O), TR).total)
    return (int)cudaErrorInvalidValue;
  BwdArgs a = {N,   C,     E,   H,     O,   TR,  fr,  V,  pe, rot,
               w0,  w0t,   b0,  w1t,   w1row, g_c, g_off, {}, {}, dpe,
               static_cast<char*>(workspace), dw0, dw1, dw1row,
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
