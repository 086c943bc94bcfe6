// Backward of the Mamba2 SSD chunk scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd's gradient,
// which the JAX package takes by autodiff through
// src/repro/models/ssm.py::ssd_chunked (it has no Pallas backward): from
// x [B, S, H, P], dt [B, S, H] f32, a [H] f32, B and C [B, S, G, N], the
// states entering each chunk [B * H, nc, P, N] f32 (the forward kernel's
// scratch after its fold), dy [B, S, H, P] and an optional cotangent of the
// final state [B, H, P, N] f32 -> dx, dB, dC in x's dtype, ddt [B, S, H]
// and da [H] in f32. Per (batch, head) and chunk of L steps, with
// cum_i = sum_{k <= i} a dt_k, total = cum_L, S the state entering the
// chunk, dS' the gradient of the state leaving it, M_ij = (C_i . B_j)
// e^{cum_i - cum_j} (j <= i) and q_ij = dy_i . x_j (kernels/ref.py::
// ssd_bwd_ref writes the same formulas out in PyTorch):
//   dS'(c - 1) = e^{total_c} dS'(c) + sum_i e^{cum_i} dy_i C_i^T
//   dx_j  = dt_j sum_{i >= j} M_ij dy_i + e^{total - cum_j} dt_j dS' B_j
//   dC_i  = sum_{j <= i} W_ij B_j + e^{cum_i} S^T dy_i
//   dB_j  = sum_{i >= j} W_ij C_i + e^{total - cum_j} dt_j dS'^T x_j
//           with W_ij = e^{cum_i - cum_j} dt_j q_ij
//   ddt_j = sum_{i >= j} M_ij q_ij + e^{total - cum_j} x_j^T dS' B_j
//           + a sum_{m >= j} g_m,   g = d/d cum (see ssd_bwd_ddt)
//   da    = sum over every step of dt_k sum_{m >= k} g_m
//
// Bound on the H100 at mamba2-370m's train shape (x [8, 512, 32, 64], G 1,
// N 128, L 128, bf16): the formulas take (3 N + 2 P) L (L + 1) + 10 L P N
// flops per head and chunk, 19.4 GFLOP a call, 0.0196 ms on the bf16
// tensor cores, under the 89 MB that must be read and written once, 0.0266
// ms at 3.35 TB/s; at the units of this design, every product with a split
// operand counted twice, the 35.5 GFLOP take 0.0359 ms and bound it.
//
// Design: in bf16 (the train step's path) the intra-chunk part is
// attention without a softmax (C the query, B the key, dt x the value, the
// decay the mask), so its gradient is FlashAttention-2's backward. Five
// grids on the caller's stream:
//   ssd_bwd_contrib_tc: each chunk's sum_i e^{cum_i} dy_i C_i^T [P, N] and
//     decay e^{total}, to f32 scratch: the forward's state grid with dy for
//     x and C e^{cum} for B w;
//   ssd_bwd_fold: the reverse fold dS'(c - 1) = e^{total_c} dS'(c) +
//     contribution(c), each contribution replaced by its chunk's dS'; the
//     only sequential part, P N values a chunk, eight chunks' loads in
//     flight;
//   ssd_bwd_chunk_tc: three blocks of 4 warps per (batch, head, chunk):
//     the query side (per tile of 16 i rows: dC_i and the row term of g,
//     sum_j W_ij (C_i . B_j) + e^{cum_i} C_i . S^T dy_i) and the key side
//     as two blocks (per tile of 16 j rows: dx_j with x_j . dS' B_j; dB_j
//     with the column sums sum_i M_ij q_ij). Each computes its own 16 x 16
//     tiles of C . B^T and of q in registers, decays them there and feeds
//     them as the A fragments of the next product, so M and W never reach
//     shared memory; q is computed once per tile on each side. dC, dB go
//     to f32 scratch per head, dx straight out; the g terms to `rows`;
//   ssd_bwd_ddt: per chunk, g from those terms, its suffix sums, ddt and
//     the chunk's share of da;
//   ssd_bwd_reduce: dB and dC summed over a group's heads in head order,
//     rounded once; da over (batch, chunk) in order.
// Every product runs on the tensor cores (mma.sync m16n8k16, bf16 inputs,
// f32 accumulators). C . B^T and q have bf16 operands, exact. Each f32
// operand (the decayed M and W, C e^{cum}, S and dS') is split into hi +
// lo bf16, two products, about 16 of its 24 bits: near 2^-17 relative,
// inside the one bf16 unit of the outputs' tolerance. The row and column
// terms of g are summed from the f32 tiles in registers, not from split
// products, since da adds them up over every step. What bounds it on the
// card is latency: a block holds the chunk's operands in shared memory
// (bf16 x or dy, B or C; the f32 state, split in place into bf16 halves
// that ldmatrix reads), 114,688 bytes at L 128, P 64, N 128, so two blocks
// of 4 warps share an SM (three at N = 64). The design keeps several
// independent products in flight in every step (four 8-column tiles take
// their fragments, then their hi, then their lo products), copies with
// 16-byte cp.async, and reads a warp's own rows (dy and C of its i rows, x
// and B of its j rows) from a buffer of its own, filled a tile ahead. A
// warp takes the 16-row tiles w and 7 - w: the same share of the triangle
// on either side. No float atomics: every sum runs in a fixed order, so
// two calls give the same bits. Limits (the launcher and ssd.py's
// bwd_limit check them): L <= 128, P <= 64, N <= 256, P and N multiples of
// 8, 16-byte aligned inputs, the shared memory within 232,448 bytes.
//
// In f32 (the smoke configurations' card-against-CPU reference) every
// product runs in f32 on the CUDA cores (register tiles of 4 x 4), four
// grids:
// ssd_bwd_contrib, the same fold, ssd_bwd_chunk (one block per chunk: x,
// dy and an L x L matrix in shared memory; B, C, S and dS' through it in
// tiles of 32 columns of N, twice) and the same reduce. Limits: L P <=
// 8192, L <= 256, the chunk grid's shared memory within 232,448 bytes: at
// P = 64, chunks up to 128.
//
// A last chunk shorter than L runs as it is on either path.

#include <math.h>

#include "ssd_common.cuh"

// Phase stamps for tools/kernel_phases.py, compiled in only with
// -DKERNEL_PHASES: thread 0 of blocks 0, 1 and 2 (the bf16 chunk grid's
// three kinds of block for the first chunk) writes clock64() at each
// numbered point of its life (PHASE below), read back by read_phases.
#ifdef KERNEL_PHASES
__device__ unsigned long long g_phases[3][32];
#define PHASE(i)                                                   \
  do {                                                             \
    if (threadIdx.x == 0 && blockIdx.x < 3 && (i) < 32)            \
      g_phases[blockIdx.x][(i)] = clock64();                       \
  } while (0)
extern "C" int read_phases(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phases, sizeof(g_phases));
}
extern "C" int clear_phases() {
  static const unsigned long long zero[3][32] = {};
  return (int)cudaMemcpyToSymbol(g_phases, zero, sizeof(g_phases));
}
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 32;   // columns of N a tile of ssd_bwd_chunk (f32)
constexpr int kLP = 2;    // 4 x 4 tiles of [L, P] a thread keeps (f32)
constexpr int kMaxL = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// shared-memory layouts (ssd.py mirrors them)
// ---------------------------------------------------------------------------

// ssd_bwd_contrib: dy [L, P4], C e^{cum} [L, nb4], dt, cum [L4] (all f32)
struct ContribLayout {
  int P4, nb4;
  size_t cw, dt, cum, total;
};
__host__ __device__ inline ContribLayout contrib_layout(int L, int P,
                                                        int nb) {
  ContribLayout y;
  y.P4 = round_up(P, 4);
  y.nb4 = round_up(nb, 4);
  size_t o = align16((size_t)L * y.P4 * 4);
  y.cw = o;
  o += align16((size_t)L * y.nb4 * 4);
  y.dt = o;
  o += align16((size_t)round_up(L, 4) * 4);
  y.cum = o;
  o += align16((size_t)round_up(L, 4) * 4);
  y.total = o;
  return y;
}

// ssd_bwd_chunk: x, dy [L4, P4]; the L x L matrix [L4, MS]; a tile area
// that holds, in turn, the first pass's K-major tiles (B, C [kNT, LS],
// S, dS' [kNT, PS]), the reductions' partial sums (rows [L4, LB], cols
// [L4, LB], x dS' B [L4, PB], dy S C [L4, PB]) and the second pass's
// row-major tiles (B, C [L4, NS], S, dS' [P4, NS]); dt, cum, g, ddt [L4];
// a reduction buffer [kThreads] (all f32)
struct ChunkLayout {
  int P4, L4, MS, LS, PS, NS, LB, PB;
  size_t dy, m, t, dt, cum, g, dd, red, total;
};
__host__ __device__ inline ChunkLayout chunk_layout(int L, int P) {
  ChunkLayout y;
  y.P4 = round_up(P, 4);
  y.L4 = round_up(L, 4);
  y.MS = y.L4 + 4;
  y.LS = y.L4 + 4;
  y.PS = y.P4 + 4;
  y.NS = kNT + 4;
  y.LB = y.L4 / 4;
  y.PB = y.P4 / 4;
  size_t o = align16((size_t)y.L4 * y.P4 * 4);
  y.dy = o;
  o += align16((size_t)y.L4 * y.P4 * 4);
  y.m = o;
  o += align16((size_t)y.L4 * y.MS * 4);
  y.t = o;
  const size_t pass1 = (size_t)kNT * (2 * y.LS + 2 * y.PS);
  const size_t parts = (size_t)y.L4 * (2 * y.LB + 2 * y.PB);
  const size_t pass2 = (size_t)y.NS * (2 * y.L4 + 2 * y.P4);
  size_t area = pass1 > parts ? pass1 : parts;
  area = area > pass2 ? area : pass2;
  o += align16(area * 4);
  y.dt = o;
  o += align16((size_t)y.L4 * 4);
  y.cum = o;
  o += align16((size_t)y.L4 * 4);
  y.g = o;
  o += align16((size_t)y.L4 * 4);
  y.dd = o;
  o += align16((size_t)y.L4 * 4);
  y.red = o;
  o += align16((size_t)kThreads * 4);
  y.total = o;
  return y;
}

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

// dst[r * sstride + col] = src[r * gstride + col] as f32 for r < rows and
// col < cols, 0 for rows <= r < rowsp or cols <= col < colsp
template <typename T>
__device__ void stage_rows(float* dst, int sstride, const T* src,
                           size_t gstride, int rows, int cols, int rowsp,
                           int colsp) {
  for (int e = threadIdx.x; e < rowsp * colsp; e += kThreads) {
    const int r = e / colsp, col = e - r * colsp;
    dst[r * sstride + col] =
        (r < rows && col < cols) ? to_f(src[r * gstride + col]) : 0.f;
  }
}

// dst[col * sstride + r] = src[r * gstride + col] (the tile K-major), the
// same bounds as stage_rows
template <typename T>
__device__ void stage_cols(float* dst, int sstride, const T* src,
                           size_t gstride, int rows, int cols, int rowsp,
                           int colsp) {
  for (int e = threadIdx.x; e < rowsp * colsp; e += kThreads) {
    const int r = e / colsp, col = e - r * colsp;
    dst[col * sstride + r] =
        (r < rows && col < cols) ? to_f(src[r * gstride + col]) : 0.f;
  }
}

// inclusive scan of v[0, n) in place (n <= kThreads), from the front or,
// with `reverse`, from the back (v[i] = sum_{m >= i} v[m]); Hillis-Steele
// in shared memory, the same order of additions on every call
__device__ void block_scan(float* v, int n, bool reverse) {
  const int i = threadIdx.x;
  for (int o = 1; o < n; o <<= 1) {
    float t = 0.f;
    if (i < n) {
      const int src = reverse ? i + o : i - o;
      if (src >= 0 && src < n) t = v[src];
    }
    __syncthreads();
    if (i < n) v[i] += t;
    __syncthreads();
  }
}

// the block's sum of each thread's v, by a fixed tree: every thread gets it
__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// cum[i] = sum_{t <= i} dt_s[t] a for i < Lc (dt_s staged by the caller)
__device__ void chunk_cum(const float* dt_s, float a, float* cum, int Lc) {
  for (int i = threadIdx.x; i < Lc; i += kThreads) cum[i] = dt_s[i] * a;
  __syncthreads();
  block_scan(cum, Lc, false);
}

// ---------------------------------------------------------------------------
// grid 1: each chunk's sum_i e^{cum_i} dy_i C_i^T and decay
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_contrib(const T* __restrict__ dy, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ cm,
                    float* __restrict__ gs, float* __restrict__ dec, int S,
                    int H, int P, int G, int N, int L, int nc, int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int part = blockIdx.x % ns;  // N parts fastest, then chunks
  const Chunk k = chunk_of(blockIdx.x / ns, H, G, S, L, nc);
  const int nb = round_up((N + ns - 1) / ns, 8), n0 = part * nb;
  const int nbc = max(0, min(nb, N - n0));
  const ContribLayout ly = contrib_layout(L, P, nb);
  const int P4 = ly.P4, nb4 = ly.nb4;
  float* dy_s = reinterpret_cast<float*>(smem);          // [Lc, P4]
  float* cw_s = reinterpret_cast<float*>(smem + ly.cw);  // [Lc, nb4]
  float* dt_s = reinterpret_cast<float*>(smem + ly.dt);
  float* cum = reinterpret_cast<float*>(smem + ly.cum);

  const size_t row0 = (size_t)k.b * S + k.c0;
  stage_rows<T>(dy_s, P4, dy + (row0 * H + k.h) * P, (size_t)H * P, k.Lc, P,
                k.Lc, P4);
  for (int i = tid; i < k.Lc; i += kThreads) dt_s[i] = dt[(row0 + i) * H + k.h];
  __syncthreads();
  chunk_cum(dt_s, a[k.h], cum, k.Lc);
  const float total = cum[k.Lc - 1];
  const T* csrc = cm + (row0 * G + k.g) * N + n0;
  for (int e = tid; e < k.Lc * nb4; e += kThreads) {
    const int i = e / nb4, n = e - i * nb4;
    cw_s[e] = n < nbc ? to_f(csrc[(size_t)i * G * N + n]) * expf(cum[i])
                      : 0.f;
  }
  __syncthreads();

  // [P, nbc] = dy^T (C e^{cum}), 4 x 4 outputs a thread
  float* out = gs + ((size_t)k.bh * nc + k.c) * P * N;
  const int PT = P4 / 4, NT = nb4 / 4;
  for (int tt = tid; tt < PT * NT; tt += kThreads) {
    const int ni = tt % NT, pi = tt / NT;
    float acc[4][4] = {};
    for (int j = 0; j < k.Lc; ++j) {
      float yv[4], cv[4];
      load4(dy_s + j * P4 + 4 * pi, yv);
      load4(cw_s + j * nb4 + 4 * ni, cv);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] += yv[u] * cv[w];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = 4 * pi + u;
      if (p >= P) continue;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int n = 4 * ni + w;
        if (n < nbc) out[(size_t)p * N + n0 + n] = acc[u][w];
      }
    }
  }
  if (part == 0 && tid == 0) dec[(size_t)k.bh * nc + k.c] = expf(total);
}

// ---------------------------------------------------------------------------
// grid 2: the reverse fold
// ---------------------------------------------------------------------------

constexpr int kFold = 4;  // elements a thread
constexpr int kFoldU = 8;  // chunks whose loads a thread has in flight

__global__ void __launch_bounds__(kThreads)
    ssd_bwd_fold(float* __restrict__ gs, const float* __restrict__ dec,
                 const float* __restrict__ dfinal, int nc, int PN,
                 int nblk) {
  const int bh = blockIdx.x / nblk, eb = blockIdx.x % nblk;
  float* base = gs + (size_t)bh * nc * PN;
  const float* db = dec + (size_t)bh * nc;
  int es[kFold];
  float g[kFold];
#pragma unroll
  for (int f = 0; f < kFold; ++f) {
    es[f] = (eb * kFold + f) * kThreads + threadIdx.x;
    g[f] = (dfinal != nullptr && es[f] < PN)
               ? dfinal[(size_t)bh * PN + es[f]]
               : 0.f;
  }
  // kFoldU chunks at a time, from the last: their contributions read at
  // once, then folded in order, each replaced by its chunk's dS'
  for (int c0 = nc - 1; c0 >= 0; c0 -= kFoldU) {
    float u[kFoldU][kFold];
#pragma unroll
    for (int q = 0; q < kFoldU; ++q)
#pragma unroll
      for (int f = 0; f < kFold; ++f)
        u[q][f] = (c0 - q >= 0 && es[f] < PN)
                      ? base[(size_t)(c0 - q) * PN + es[f]]
                      : 0.f;
#pragma unroll
    for (int q = 0; q < kFoldU; ++q) {
      if (c0 - q < 0) break;
      const float d = db[c0 - q];
      float* row = base + (size_t)(c0 - q) * PN;
#pragma unroll
      for (int f = 0; f < kFold; ++f) {
        if (es[f] >= PN) continue;
        row[es[f]] = g[f];  // dS' of chunk c0 - q
        g[f] = d * g[f] + u[q][f];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// grid 3: one chunk's dx, ddt, share of da, and its head's dB, dC
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ st,
                  const float* __restrict__ gs, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ ddt,
                  float* __restrict__ dapart, float* __restrict__ dbp,
                  float* __restrict__ dcp, int S, int H, int P, int G, int N,
                  int L, int nc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const Chunk k = chunk_of(blockIdx.x, H, G, S, L, nc);
  const ChunkLayout ly = chunk_layout(L, P);
  const int P4 = ly.P4, L4 = ly.L4, MS = ly.MS, LS = ly.LS, PS = ly.PS;
  const int NS = ly.NS, LB = ly.LB, PB = ly.PB, Lc = k.Lc;
  float* x_s = reinterpret_cast<float*>(smem);           // [L4, P4]
  float* dy_s = reinterpret_cast<float*>(smem + ly.dy);  // [L4, P4]
  float* m_s = reinterpret_cast<float*>(smem + ly.m);    // [L4, MS]
  float* area = reinterpret_cast<float*>(smem + ly.t);
  float* dt_s = reinterpret_cast<float*>(smem + ly.dt);
  float* cum = reinterpret_cast<float*>(smem + ly.cum);
  float* gv = reinterpret_cast<float*>(smem + ly.g);
  float* dd = reinterpret_cast<float*>(smem + ly.dd);
  float* red = reinterpret_cast<float*>(smem + ly.red);
  const float ah = a[k.h];

  const size_t row0 = (size_t)k.b * S + k.c0;  // first step of the chunk
  const size_t xoff = (row0 * H + k.h) * P, xstride = (size_t)H * P;
  const size_t boff = (row0 * G + k.g) * N, bstride = (size_t)G * N;
  const float* sp = st + ((size_t)k.bh * nc + k.c) * P * N;  // S
  const float* gp = gs + ((size_t)k.bh * nc + k.c) * P * N;  // dS'
  stage_rows<T>(x_s, P4, x + xoff, xstride, Lc, P, L4, P4);
  stage_rows<T>(dy_s, P4, dy + xoff, xstride, Lc, P, L4, P4);
  for (int i = tid; i < L4; i += kThreads) {
    dt_s[i] = i < Lc ? dt[(row0 + i) * H + k.h] : 0.f;
    cum[i] = 0.f;
  }
  for (int e = tid; e < L4 * MS; e += kThreads) m_s[e] = 0.f;
  __syncthreads();
  chunk_cum(dt_s, ah, cum, Lc);
  const float total = cum[Lc - 1];

  // ---- pass 1 over N: C . B^T into m_s; dS' B_j and S C_i in registers
  // (thread tile t covers rows 4 rb .. 4 rb + 3 and columns 4 pb .. of
  // [L, P]); <dS', S> per thread
  float gb[kLP][4][4] = {}, sc[kLP][4][4] = {};
  float gsdot = 0.f;
  float* bt = area;                 // [kNT, LS] B^T
  float* ct = bt + kNT * LS;        // [kNT, LS] C^T
  float* stt = ct + kNT * LS;       // [kNT, PS] S^T
  float* gtt = stt + kNT * PS;      // [kNT, PS] dS'^T
  for (int n0 = 0; n0 < N; n0 += kNT) {
    const int nt = min(kNT, N - n0);
    __syncthreads();  // the last tile is consumed
    stage_cols<T>(bt, LS, bm + boff + n0, bstride, Lc, nt, L4, kNT);
    stage_cols<T>(ct, LS, cm + boff + n0, bstride, Lc, nt, L4, kNT);
    stage_cols<float>(stt, PS, sp + n0, (size_t)N, P, nt, P4, kNT);
    stage_cols<float>(gtt, PS, gp + n0, (size_t)N, P, nt, P4, kNT);
    __syncthreads();
    // C . B^T on and below the diagonal, 4 x 4 blocks (ib >= jb)
    for (int e = tid; e < LB * LB; e += kThreads) {
      const int ib = e / LB, jb = e - ib * LB;
      if (jb > ib) continue;
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) load4(m_s + (4 * ib + u) * MS + 4 * jb,
                                        acc[u]);
      for (int kk = 0; kk < kNT; ++kk) {
        float cv[4], bv[4];
        load4(ct + kk * LS + 4 * ib, cv);
        load4(bt + kk * LS + 4 * jb, bv);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][w] += cv[u] * bv[w];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(m_s + (4 * ib + u) * MS + 4 * jb) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
#pragma unroll
    for (int t = 0; t < kLP; ++t) {
      const int tt = tid + t * kThreads;
      if (tt >= LB * PB) continue;
      const int rb = tt / PB, pb = tt - rb * PB;
      for (int kk = 0; kk < kNT; ++kk) {
        float bv[4], cv[4], gvv[4], sv[4];
        load4(bt + kk * LS + 4 * rb, bv);
        load4(ct + kk * LS + 4 * rb, cv);
        load4(gtt + kk * PS + 4 * pb, gvv);
        load4(stt + kk * PS + 4 * pb, sv);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            gb[t][u][v] += bv[u] * gvv[v];
            sc[t][u][v] += cv[u] * sv[v];
          }
      }
    }
    for (int e = tid; e < kNT * P4; e += kThreads) {
      const int kk = e / P4, p = e - kk * P4;
      gsdot += gtt[kk * PS + p] * stt[kk * PS + p];
    }
  }
  __syncthreads();

  // ---- M = (C . B^T) e^{cum_i - cum_j} in place; R = M q reduced by rows
  // (sum_j dt_j R_ij, the T terms' + side) and columns (sum_i R_ij)
  float* rowp = area;               // [L4, LB]
  float* colp = rowp + L4 * LB;     // [L4, LB]
  float* xgbp = colp + L4 * LB;     // [L4, PB]
  float* scp = xgbp + L4 * PB;      // [L4, PB]
  for (int e = tid; e < LB * LB; e += kThreads) {
    const int ib = e / LB, jb = e - ib * LB;
    if (jb > ib) continue;
    float q[4][4] = {};
    for (int p = 0; p < P4; p += 4) {
      float yv[4][4], xv[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        load4(dy_s + (4 * ib + u) * P4 + p, yv[u]);
        load4(x_s + (4 * jb + u) * P4 + p, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int v = 0; v < 4; ++v) q[u][w] += yv[u][v] * xv[w][v];
    }
    float rs[4] = {}, cs[4] = {};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * ib + u;
      float mv[4];
      load4(m_s + i * MS + 4 * jb, mv);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = 4 * jb + w;
        float mij = 0.f;
        if (i < Lc && j <= i) mij = mv[w] * expf(cum[i] - cum[j]);
        mv[w] = mij;
        const float r = mij * q[u][w];
        rs[u] += dt_s[j] * r;
        cs[w] += r;
      }
      *reinterpret_cast<float4*>(m_s + i * MS + 4 * jb) =
          make_float4(mv[0], mv[1], mv[2], mv[3]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      rowp[(4 * ib + u) * LB + jb] = rs[u];
      colp[(4 * jb + u) * LB + ib] = cs[u];
    }
  }
  __syncthreads();

  // ---- dx = dt_j M^T dy + e^{total - cum_j} dt_j dS' B_j; the per-row
  // partial sums of x_j^T dS' B_j and dy_i^T S C_i
#pragma unroll
  for (int t = 0; t < kLP; ++t) {
    const int tt = tid + t * kThreads;
    if (tt >= LB * PB) continue;
    const int rb = tt / PB, pb = tt - rb * PB;
    float acc[4][4] = {};
    for (int i = 4 * rb; i < Lc; ++i) {
      float mv[4], yv[4];
      load4(m_s + i * MS + 4 * rb, mv);
      load4(dy_s + i * P4 + 4 * pb, yv);
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[w][v] += mv[w] * yv[v];
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int j = 4 * rb + w;
      float xv[4], yv[4];
      load4(x_s + j * P4 + 4 * pb, xv);
      load4(dy_s + j * P4 + 4 * pb, yv);
      float xs = 0.f, ys = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        xs += xv[v] * gb[t][w][v];
        ys += yv[v] * sc[t][w][v];
      }
      xgbp[j * PB + pb] = xs;
      scp[j * PB + pb] = ys;
      if (j >= Lc) continue;
      const float dtj = dt_s[j], tl = expf(total - cum[j]) * dtj;
      T* out = dx + xoff + (size_t)j * xstride;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int p = 4 * pb + v;
        if (p < P) store(out + p, dtj * acc[w][v] + tl * gb[t][w][v]);
      }
    }
  }
  __syncthreads();

  // ---- g = d/d cum, ddt, and the chunk's share of da
  float sterm = 0.f;
  if (tid < L4) {
    const int kk = tid;
    float colr = 0.f, rowt = 0.f, xgb = 0.f, sdc = 0.f;
    for (int ib = kk / 4; ib < LB; ++ib) colr += colp[kk * LB + ib];
    for (int jb = 0; jb <= kk / 4; ++jb) rowt += rowp[kk * LB + jb];
    for (int pb = 0; pb < PB; ++pb) {
      xgb += xgbp[kk * PB + pb];
      sdc += scp[kk * PB + pb];
    }
    float g = 0.f, d = 0.f;
    if (kk < Lc) {
      const float tl = expf(total - cum[kk]);
      sterm = tl * dt_s[kk] * xgb;
      d = colr + tl * xgb;
      g = rowt - dt_s[kk] * colr + expf(cum[kk]) * sdc - sterm;
    }
    gv[kk] = g;
    dd[kk] = d;
  }
  const float ssum = block_sum(sterm, red);
  const float gsum = block_sum(gsdot, red);
  if (tid == 0) gv[Lc - 1] += expf(total) * gsum + ssum;
  __syncthreads();
  block_scan(gv, Lc, true);  // dda_k = sum_{m >= k} g_m
  float dap = 0.f;
  if (tid < Lc) {
    ddt[(row0 + tid) * H + k.h] = dd[tid] + ah * gv[tid];
    dap = dt_s[tid] * gv[tid];
  }
  const float dsum = block_sum(dap, red);
  if (tid == 0) dapart[(size_t)k.bh * nc + k.c] = dsum;

  // ---- W = e^{cum_i - cum_j} dt_j q_ij into m_s
  for (int e = tid; e < LB * LB; e += kThreads) {
    const int ib = e / LB, jb = e - ib * LB;
    if (jb > ib) continue;
    float q[4][4] = {};
    for (int p = 0; p < P4; p += 4) {
      float yv[4][4], xv[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        load4(dy_s + (4 * ib + u) * P4 + p, yv[u]);
        load4(x_s + (4 * jb + u) * P4 + p, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int v = 0; v < 4; ++v) q[u][w] += yv[u][v] * xv[w][v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * ib + u;
      float wv[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = 4 * jb + w;
        wv[w] = (i < Lc && j <= i)
                    ? expf(cum[i] - cum[j]) * dt_s[j] * q[u][w]
                    : 0.f;
      }
      *reinterpret_cast<float4*>(m_s + i * MS + 4 * jb) =
          make_float4(wv[0], wv[1], wv[2], wv[3]);
    }
  }

  // ---- pass 2 over N: dC = W B + e^{cum_i} S^T dy_i, dB = W^T C +
  // e^{total - cum_j} dt_j dS'^T x_j, for this head, to f32 scratch
  float* br = area;              // [L4, NS]
  float* cr = br + L4 * NS;      // [L4, NS]
  float* sr = cr + L4 * NS;      // [P4, NS]
  float* gr = sr + P4 * NS;      // [P4, NS]
  const int NB = kNT / 4;
  const size_t poff = (row0 * H + k.h) * N, pstride = (size_t)H * N;
  for (int n0 = 0; n0 < N; n0 += kNT) {
    const int nt = min(kNT, N - n0);
    __syncthreads();  // W written, or the last tile consumed
    stage_rows<T>(br, NS, bm + boff + n0, bstride, Lc, nt, L4, kNT);
    stage_rows<T>(cr, NS, cm + boff + n0, bstride, Lc, nt, L4, kNT);
    stage_rows<float>(sr, NS, sp + n0, (size_t)N, P, nt, P4, kNT);
    stage_rows<float>(gr, NS, gp + n0, (size_t)N, P, nt, P4, kNT);
    __syncthreads();
    for (int tt = tid; tt < LB * NB; tt += kThreads) {
      const int rb = tt / NB, nb = tt - rb * NB;
      // dC rows i = 4 rb + u: sum over j <= i of W_ij B_j
      float acc[4][4] = {};
      const int jmax = min(4 * rb + 4, Lc);
      for (int j = 0; j < jmax; ++j) {
        float bv[4];
        load4(br + j * NS + 4 * nb, bv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float wij = m_s[(4 * rb + u) * MS + j];
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] += wij * bv[v];
        }
      }
      float acs[4][4] = {};
      for (int p = 0; p < P; ++p) {
        float sv[4];
        load4(sr + p * NS + 4 * nb, sv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float yv = dy_s[(4 * rb + u) * P4 + p];
#pragma unroll
          for (int v = 0; v < 4; ++v) acs[u][v] += yv * sv[v];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * rb + u;
        if (i >= Lc) continue;
        const float ec = expf(cum[i]);
        float* out = dcp + poff + (size_t)i * pstride + n0;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (4 * nb + v < nt) out[4 * nb + v] = acc[u][v] + ec * acs[u][v];
      }
      // dB rows j = 4 rb + w: sum over i >= j of W_ij C_i
      float bcc[4][4] = {};
      for (int i = 4 * rb; i < Lc; ++i) {
        float wv[4], cv[4];
        load4(m_s + i * MS + 4 * rb, wv);
        load4(cr + i * NS + 4 * nb, cv);
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int v = 0; v < 4; ++v) bcc[w][v] += wv[w] * cv[v];
      }
      float bgs[4][4] = {};
      for (int p = 0; p < P; ++p) {
        float gvv[4];
        load4(gr + p * NS + 4 * nb, gvv);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float xv = x_s[(4 * rb + w) * P4 + p];
#pragma unroll
          for (int v = 0; v < 4; ++v) bgs[w][v] += xv * gvv[v];
        }
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = 4 * rb + w;
        if (j >= Lc) continue;
        const float tl = expf(total - cum[j]) * dt_s[j];
        float* out = dbp + poff + (size_t)j * pstride + n0;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (4 * nb + v < nt) out[4 * nb + v] = bcc[w][v] + tl * bgs[w][v];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// grid 4: dB, dC over a group's heads; da over (batch, chunk)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce(const float* __restrict__ dbp,
                   const float* __restrict__ dcp,
                   const float* __restrict__ dapart, T* __restrict__ db,
                   T* __restrict__ dc, float* __restrict__ da, long long rows,
                   int H, int G, int N, int B, int nc) {
  const int rep = H / G;
  const long long total = rows * G * N;  // rows = B * S
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long rg = e / N;  // (row, group)
    const int n = (int)(e - rg * N);
    const long long row = rg / G;
    const int g = (int)(rg - row * G);
    const size_t src = ((size_t)row * H + (size_t)g * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += dbp[src + (size_t)r * N];
      sc += dcp[src + (size_t)r * N];
    }
    store(db + e, sb);
    store(dc + e, sc);
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float s = 0.f;
      for (int b = 0; b < B; ++b)
        for (int c = 0; c < nc; ++c)
          s += dapart[((size_t)b * H + h) * nc + c];
      da[h] = s;
    }
}

// ---------------------------------------------------------------------------
// bf16: every product on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTc = 128;  // threads of a bf16 chunk-grid block: 4 warps
constexpr int kTcWarps = kTc / 32;
constexpr int kTcMaxL = 128;  // 8 tiles of 16 rows, two a warp
constexpr int kTcMaxP = 64;   // the key side's dx tile: 8 columns of 8
constexpr int kTcMaxN = 256;

// the two bf16 of a fragment register as f32
__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// grid 1 (bf16): each chunk's sum_i e^{cum_i} dy_i C_i^T [P, N] and decay,
// the forward's state grid (ssd.cu) with dy for x and C e^{cum} for B w:
// dy^T on the tensor cores against C e^{cum} split into hi + lo
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_contrib_tc(const bf16* __restrict__ dy,
                       const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const bf16* __restrict__ cm, float* __restrict__ gs,
                       float* __restrict__ dec, int S, int H, int P, int G,
                       int N, int L, int nc, int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int part = blockIdx.x % ns;  // N parts fastest, then chunks
  const Chunk k = chunk_of(blockIdx.x / ns, H, G, S, L, nc);
  const int nb = round_up((N + ns - 1) / ns, 8), n0 = part * nb;
  const int nbc = max(0, min(nb, N - n0));
  const StateTC ly = state_tc(L, P, nb);
  const int PS = ly.PS, NBS = ly.NBS, K16 = round_up(k.Lc, 16);
  bf16* dy_s = reinterpret_cast<bf16*>(smem);            // [K16, PS]
  bf16* chi = reinterpret_cast<bf16*>(smem + ly.bhi);    // [K16, NBS]
  bf16* clo = reinterpret_cast<bf16*>(smem + ly.blo);    // [K16, NBS]
  float* dt_s = reinterpret_cast<float*>(smem + ly.dt);
  float* cum = reinterpret_cast<float*>(smem + ly.cum);
  float* ec = reinterpret_cast<float*>(smem + ly.w);
  float* sums = reinterpret_cast<float*>(smem + ly.sums);

  // every copy in flight at once: dy, the raw C columns (into chi), dt
  const size_t row0 = (size_t)k.b * S + k.c0;
  stage<kThreads>(dy_s, PS, dy + (row0 * H + k.h) * P, (size_t)H * P, k.Lc,
                  P, K16, ly.P16, true);
  stage<kThreads>(chi, NBS, cm + (row0 * G + k.g) * N + n0, (size_t)G * N,
                  k.Lc, nbc, K16, nb, true);
  for (int i = tid; i < k.Lc; i += kThreads) dt_s[i] = dt[(row0 + i) * H + k.h];
  __syncthreads();
  chunk_cumsum<kThreads>(dt_s, a[k.h], cum, sums, k.Lc);
  const float total = cum[k.Lc - 1];
  for (int i = tid; i < K16; i += kThreads)
    ec[i] = i < k.Lc ? expf(cum[i]) : 0.f;
  cp_async_wait_all();
  __syncthreads();
  // C e^{cum}, split into hi + lo in place, 8 values a thread at a time
  // (the copy zeroed columns nbc .. nb and rows Lc .. K16)
  for (int e = tid; e < K16 * nb / 8; e += kThreads) {
    const int i = e / (nb / 8), n = 8 * (e - i * (nb / 8));
    uint4* hp = reinterpret_cast<uint4*>(chi + i * NBS + n);
    const uint4 raw = *hp;
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = unpack(w[q]);
      split_pack(v.x * ec[i], v.y * ec[i], hi[q], lo[q]);
    }
    *hp = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(clo + i * NBS + n) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();

  // [P, nbc] = dy^T (C e^{cum}): a warp takes 16 rows of P and up to
  // kCN 8-column tiles of N, all in flight at once; both operands read
  // K-major (K = the chunk's steps)
  constexpr int kCN = 8;
  float* out = gs + ((size_t)k.bh * nc + k.c) * P * N;
  const int mtn = ly.P16 / 16, ntn = nb / 8, ngr = (ntn + kCN - 1) / kCN;
  for (int t = warp; t < mtn * ngr; t += kWarps) {
    const int mt = t % mtn, nt0 = (t / mtn) * kCN;
    float c[kCN][4] = {};
    for (int k0 = 0; k0 < K16; k0 += 16) {
      uint32_t af[4], bh[kCN][2], bl[kCN][2];
      lds_a_t(af, dy_s, PS, k0, mt * 16);
#pragma unroll
      for (int u = 0; u < kCN; ++u)
        if (nt0 + u < ntn) {
          lds_b_t(bh[u], chi, NBS, k0, (nt0 + u) * 8);
          lds_b_t(bl[u], clo, NBS, k0, (nt0 + u) * 8);
        }
#pragma unroll
      for (int u = 0; u < kCN; ++u)
        if (nt0 + u < ntn) mma(c[u], af, bh[u]);
#pragma unroll
      for (int u = 0; u < kCN; ++u)
        if (nt0 + u < ntn) mma(c[u], af, bl[u]);
    }
#pragma unroll
    for (int u = 0; u < kCN; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + gid + 8 * h;
        const int n = (nt0 + u) * 8 + 2 * tig;  // nbc, N: multiples of 8
        if (nt0 + u < ntn && p < P && n < nbc)
          *reinterpret_cast<float2*>(out + (size_t)p * N + n0 + n) =
              make_float2(c[u][2 * h], c[u][2 * h + 1]);
      }
  }
  if (part == 0 && tid == 0) dec[(size_t)k.bh * nc + k.c] = expf(total);
}

// ssd_bwd_chunk_tc: three slots, each kind of block filling them with its
// own operands, read by every warp (all rows of the chunk): [L16, P16 + 8]
// bf16 (x on the query side, dy on the key side), [L16, Np + 8] bf16 (B on
// the query side, C on the key side) and the state [P16, HS = Np + 4] f32
// (S on the query side, dS' on the key side), each row then split in place
// into its hi and lo halves, [hi (Np) | lo (Np) | 8] bf16 in the same bytes;
// then dt and cum [L16]; then each warp's own rows, [16, P16 + 8] and [16,
// Np + 8] bf16 (dy and C of its i rows, or x and B of its j rows), copied
// one tile ahead. Every row is 16 bytes past a multiple of 32, so the eight
// rows of an ldmatrix read hit distinct banks. Four floats of reductions
// sit in the padding of warp 0's first own row, which no copy writes. At
// L 128, P 64, N 128 that is 114,688 bytes: two blocks an SM.
struct ChunkTC {
  int L16, P16, Np, PS, CS, HS;
  size_t s1, s2, dt, cum, own, total;
};
__host__ __device__ inline ChunkTC chunk_tc(int L, int P, int N) {
  ChunkTC y;
  y.L16 = round_up(L, 16);
  y.P16 = round_up(P, 16);
  y.Np = round_up(N, 16);
  y.PS = y.P16 + 8;
  y.CS = y.Np + 8;
  y.HS = y.Np + 4;
  size_t o = align16((size_t)y.L16 * y.PS * 2);
  y.s1 = o;
  o += align16((size_t)y.L16 * y.CS * 2);
  y.s2 = o;
  o += align16((size_t)y.P16 * y.HS * 4);
  y.dt = o;
  o += align16((size_t)y.L16 * 4);
  y.cum = o;
  o += align16((size_t)y.L16 * 4);
  y.own = o;
  o += (size_t)kTcWarps * 16 * (y.PS + y.CS) * 2;
  y.total = o;
  return y;
}

// what a block of the chunk grid works on
struct TcArgs {
  const bf16 *x, *bm, *cm, *dy;
  const float *dt, *a, *st, *gs;
  bf16* dx;
  float *dbp, *dcp, *rows;  // rows: q row terms, column sums, dS' terms,
                            // and each chunk's last-step term of g
  int S, H, P, G, N, L, nc;
};

struct TcBlock {
  Chunk k;
  const bf16 *s0, *s1, *s2;  // s2: the state's rows [hi | lo | 8], SR apart
  bf16 *op, *on;             // this warp's own rows: [16, PS], [16, CS]
  const float *dt, *cum;
  int PS, CS, SR, Np, nmt, pk, nk;  // strides, lo's offset; tiles; k-steps
  size_t row0, xoff, boff, cb;      // cb: (batch, head, chunk) index
  float total;
};

// rows r0 .. r0 + 15 (zero from row nrows on) and columns 0 .. cols of a
// bf16 matrix in device memory (`ld` elements a row) into [16, ss] shared
// memory, zero up to colsp (a multiple of 8): 16-byte cp.async copies by
// the calling warp alone, complete after its cp_async_wait_all()
__device__ __forceinline__ void warp_rows(bf16* dst, int ss, const bf16* src,
                                          size_t ld, int r0, int nrows,
                                          int cols, int colsp) {
  const int lane = threadIdx.x & 31, cv = colsp / 8;
  for (int e = lane; e < 16 * cv; e += 32) {
    const int r = e / cv, c = (e - r * cv) * 8;
    bf16* d = dst + r * ss + c;
    if (r0 + r < nrows && c < cols)
      cp_async16(d, src + (size_t)(r0 + r) * ld + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}
// The A fragment (16 x 16, row-major) of 16 rows kept row by row in shared
// memory, columns k0 .. k0 + 15
__device__ __forceinline__ void lds_a(uint32_t* a, const bf16* s, int ss,
                                      int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (lane & 15) * ss + k0 + 8 * (lane >> 4);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}
// ldmatrix of four 8 x 8 blocks, transposed or not, lane l giving the
// address of row l % 8 of block l / 8
__device__ __forceinline__ void ldsm4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// The B fragments (k = columns k0 .. k0 + 15) of the 8-column tiles at
// rows n0 and n0 + 8 of a bf16 matrix kept row by row (rows n, K along
// each row): r = {tile n0: b0, b1, tile n0 + 8: b0, b1}
__device__ __forceinline__ void lds_b_rows2(uint32_t* r, const bf16* s,
                                            int ss, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm4(r, s + (n0 + (lane & 7) + 8 * (lane >> 4)) * ss + k0 +
               8 * ((lane >> 3) & 1));
}
// The B fragments (k = rows k0 .. k0 + 15) of the 8-column tiles at columns
// n0 and n0 + 8 of a bf16 matrix kept K-major: r as above
__device__ __forceinline__ void lds_b_t2(uint32_t* r, const bf16* s, int ss,
                                         int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm4_t(r, s + (k0 + (lane & 15)) * ss + n0 + 8 * (lane >> 4));
}
// The hi and lo B fragments (k = rows k0 .., n = columns n0 ..) of the
// split state, rows `rs` apart with lo `lo` past hi: r = {hi b0, b1, lo b0,
// b1}
__device__ __forceinline__ void lds_b_split(uint32_t* r, const bf16* s,
                                            int rs, int lo, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm4_t(r, s + (k0 + (lane & 15)) * rs + (lane >> 4) * lo + n0);
}
// ... of its transpose (k = columns k0 .., n = rows n0 ..)
__device__ __forceinline__ void lds_bt_split(uint32_t* r, const bf16* s,
                                             int rs, int lo, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm4(r, s + (n0 + (lane & 7)) * rs + (lane >> 4) * lo + k0 +
               8 * ((lane >> 3) & 1));
}
// the sum over a quad (the four lanes that share a fragment row), in a
// fixed order: every lane gets it
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A warp's own rows for one tile, in its buffer: the P-wide fragments (dy_i
// or x_j, K = P) read into registers once, the N-wide ones (C_i or B_j,
// K = N) read from the buffer each time they are used (keeping them in
// registers too measured no faster at N = 64 and slower at N = 128, where
// the registers spill)
struct OwnRows {
  uint32_t p[4][4];
  const bf16* on;
  int cs;
  // wait for the copies, then read the P-wide fragments
  __device__ __forceinline__ void load(const TcBlock& t) {
    cp_async_wait_all();
    __syncwarp();
    on = t.on;
    cs = t.CS;
#pragma unroll
    for (int kp = 0; kp < 4; ++kp)
      if (kp < t.pk) lds_a(p[kp], t.op, t.PS, 16 * kp);
  }
  // the N-wide fragment kn
  __device__ __forceinline__ void get(int kn, uint32_t* a) const {
    lds_a(a, on, cs, 16 * kn);
  }
};

// copy the own rows of tile mt (if there is one) into the warp's buffer
// once the warp is done with the last ones: P-wide rows of `pm`, N-wide
// rows of `nm`
__device__ __forceinline__ void own_rows(const TcArgs& g, const TcBlock& t,
                                         int mt, const bf16* pm,
                                         const bf16* nm) {
  if (mt >= t.nmt) return;
  __syncwarp();
  warp_rows(t.op, t.PS, pm + t.xoff, (size_t)g.H * g.P, 16 * mt, t.k.Lc,
            g.P, t.PS - 8);
  warp_rows(t.on, t.CS, nm + t.boff, (size_t)g.G * g.N, 16 * mt, t.k.Lc,
            g.N, t.CS - 8);
}

// The products below keep several accumulators in flight: four 8-column
// tiles at a time take their fragments first, then their hi products, then
// their lo products, so no mma waits on the one before it.

// acc[nt] += a . B, B the split state (hi, then lo), for the 8-column
// tiles nt < ntn: `t` picks the layout (false: B rows k, columns n; true:
// B^T's, the state read transposed)
template <int NT, bool T>
__device__ __forceinline__ void mma_state(float (*acc)[4], const uint32_t* a,
                                          const bf16* s, int rs, int lo,
                                          int k0, int ntn) {
#pragma unroll
  for (int n4 = 0; n4 < NT; n4 += 4) {
    if (n4 >= ntn) break;
    uint32_t b[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n4 + u < ntn) {
        if constexpr (T)
          lds_bt_split(b[u], s, rs, lo, k0, 8 * (n4 + u));
        else
          lds_b_split(b[u], s, rs, lo, k0, 8 * (n4 + u));
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n4 + u < ntn) mma(acc[n4 + u], a, b[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n4 + u < ntn) mma(acc[n4 + u], a, b[u] + 2);
  }
}
// acc[nt] += (ahi + alo) . B for the 8-column tiles nt < ntn of a bf16
// matrix kept K-major in shared memory (rows k0 .. k0 + 15)
template <int NT>
__device__ __forceinline__ void mma_split(float (*acc)[4], const uint32_t* ahi,
                                          const uint32_t* alo, const bf16* s,
                                          int ss, int k0, int ntn) {
#pragma unroll
  for (int n4 = 0; n4 < NT; n4 += 4) {
    if (n4 >= ntn) break;
    uint32_t b[2][4];  // tiles n4, n4 + 1 and n4 + 2, n4 + 3
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (n4 + 2 * u < ntn) lds_b_t2(b[u], s, ss, k0, 8 * (n4 + 2 * u));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n4 + u < ntn) mma(acc[n4 + u], ahi, b[u / 2] + 2 * (u % 2));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n4 + u < ntn) mma(acc[n4 + u], alo, b[u / 2] + 2 * (u % 2));
  }
}
// c[h] += a[k] . rows r0 + 8 h .. of a bf16 matrix in shared memory (K
// along each row), k-steps k < nk, the two halves side by side
template <int K>
__device__ __forceinline__ void mma_rows(float (*c)[4], uint32_t (*a)[4],
                                         const bf16* s, int ss, int r0,
                                         int nk) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k >= nk) break;
    uint32_t b[4];
    lds_b_rows2(b, s, ss, 16 * k, r0);
    mma(c[0], a[k], b);
    mma(c[1], a[k], b + 2);
  }
}
// ... with the N-wide A fragments of a warp's own rows
template <int NTM>
__device__ __forceinline__ void mma_rows_own(float (*c)[4],
                                             const OwnRows& own,
                                             const bf16* s, int ss, int r0,
                                             int nk) {
#pragma unroll
  for (int k = 0; k < NTM / 2; ++k) {
    if (k >= nk) break;
    uint32_t a[4], b[4];
    own.get(k, a);
    lds_b_rows2(b, s, ss, 16 * k, r0);
    mma(c[0], a, b);
    mma(c[1], a, b + 2);
  }
}

// Query side, tile mt (rows i of the chunk): dC_i = e^{cum_i} S^T dy_i +
// sum_{j <= i} W_ij B_j for this head, to f32 scratch, and the row term of
// g, sum_j W_ij (C_i . B_j) + e^{cum_i} C_i . S^T dy_i. Slots: x, B, S.
template <int NTM>
__device__ void query_tile(const TcArgs& g, const TcBlock& t, int mt,
                           int next, int ph) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int i_lo = 16 * mt, Lc = t.k.Lc, ntn = 2 * t.nk;
  OwnRows ci;  // dy_i (K = P), C_i (K = N)
  ci.load(t);
  auto& ya = ci.p;
  PHASE(ph);

  // S^T dy_i (K = P), then its row term against C_i, then e^{cum_i}
  float acc[NTM][4];
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kp = 0; kp < 4; ++kp)
    if (kp < t.pk)
      mma_state<NTM, false>(acc, ya[kp], t.s2, t.SR, t.Np, 16 * kp, ntn);
  const int i0 = i_lo + gid, i1 = i0 + 8;
  float rs[2] = {0.f, 0.f};  // the row term's share, rows i0 and i1
#pragma unroll
  for (int kn = 0; kn < NTM / 2; ++kn) {
    if (kn >= t.nk) break;
    uint32_t cf[4];
    ci.get(kn, cf);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 ca = unpack(cf[2 * h]), cb = unpack(cf[2 * h + 1]);
      const float* r = acc[2 * kn + h];
      rs[0] += r[0] * ca.x + r[1] * ca.y;
      rs[1] += r[2] * cb.x + r[3] * cb.y;
    }
  }
  const float cum0 = i0 < Lc ? t.cum[i0] : 0.f;
  const float cum1 = i1 < Lc ? t.cum[i1] : 0.f;
  const float e0 = i0 < Lc ? expf(cum0) : 0.f;
  const float e1 = i1 < Lc ? expf(cum1) : 0.f;
  rs[0] *= e0;
  rs[1] *= e1;
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt) {
    acc[nt][0] *= e0;
    acc[nt][1] *= e0;
    acc[nt][2] *= e1;
    acc[nt][3] *= e1;
  }
  PHASE(ph + 1);

  // sum_{j <= i} W_ij B_j, 16 columns j at a time up to the diagonal
  for (int ks = 0; ks <= mt; ++ks) {
    const int j0 = 16 * ks;
    float q[2][4] = {}, sc[2][4] = {};  // dy . x^T, C . B^T
    mma_rows<4>(q, ya, t.s0, t.PS, j0, t.pk);
    mma_rows_own<NTM>(sc, ci, t.s1, t.CS, j0, t.nk);
    // W_ij = e^{cum_i - cum_j} dt_j q_ij (j <= i < Lc) -> hi, lo A
    // fragments (the accumulator's layout is the A layout)
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float cj[2], dj[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + 8 * h2 + 2 * tig + u;
        cj[u] = t.cum[j];
        dj[u] = t.dt[j];
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = i0 + 8 * rr;
        const float ci_ = rr ? cum1 : cum0;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + 8 * h2 + 2 * tig + u;
          v[u] = (j <= i && i < Lc)
                     ? q[h2][2 * rr + u] * expf(ci_ - cj[u]) * dj[u]
                     : 0.f;
          rs[rr] += v[u] * sc[h2][2 * rr + u];
        }
        split_pack(v[0], v[1], ahi[2 * h2 + rr], alo[2 * h2 + rr]);
      }
    }
    mma_split<NTM>(acc, ahi, alo, t.s1, t.CS, j0, ntn);
  }
  PHASE(ph + 2);

  const size_t hrow = (size_t)g.H * g.N;
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt) {
    const int n = 8 * nt + 2 * tig;
    if (nt >= ntn || n >= g.N) break;
    float* o = g.dcp + (t.row0 * g.H + t.k.h) * g.N + n;
    if (i0 < Lc)
      *reinterpret_cast<float2*>(o + i0 * hrow) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (i1 < Lc)
      *reinterpret_cast<float2*>(o + i1 * hrow) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
  own_rows(g, t, next, g.dy, g.cm);
  const float r0 = quad_sum(rs[0]), r1 = quad_sum(rs[1]);
  float* qrow = g.rows + t.cb * g.L;
  if (tig == 0) {
    if (i0 < Lc) qrow[i0] = r0;
    if (i1 < Lc) qrow[i1] = r1;
  }
  PHASE(ph + 3);
}

// Key side, dB: tile mt (rows j): dB_j = e^{total - cum_j} dt_j dS'^T x_j
// + sum_{i >= j} W_ij C_i for this head, to f32 scratch, and the column
// sums sum_i M_ij q_ij that ddt and g take. Slots: dy, C, dS'.
template <int NTM>
__device__ void keyb_tile(const TcArgs& g, const TcBlock& t, int mt,
                          int next, size_t nbhc, int ph) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int j_lo = 16 * mt, Lc = t.k.Lc, ntn = 2 * t.nk;
  OwnRows bj;  // x_j (K = P), B_j (K = N)
  bj.load(t);
  auto& xa = bj.p;
  PHASE(ph);

  // dS'^T x_j (K = P) times e^{total - cum_j} dt_j
  float acc[NTM][4];
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kp = 0; kp < 4; ++kp)
    if (kp < t.pk)
      mma_state<NTM, false>(acc, xa[kp], t.s2, t.SR, t.Np, 16 * kp, ntn);
  const int j0 = j_lo + gid, j1 = j0 + 8;
  const float cum0 = j0 < Lc ? t.cum[j0] : 0.f;
  const float cum1 = j1 < Lc ? t.cum[j1] : 0.f;
  const float dt0 = j0 < Lc ? t.dt[j0] : 0.f, dt1 = j1 < Lc ? t.dt[j1] : 0.f;
  const float t0 = j0 < Lc ? expf(t.total - cum0) * dt0 : 0.f;
  const float t1 = j1 < Lc ? expf(t.total - cum1) * dt1 : 0.f;
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt) {
    acc[nt][0] *= t0;
    acc[nt][1] *= t0;
    acc[nt][2] *= t1;
    acc[nt][3] *= t1;
  }
  PHASE(ph + 1);

  // sum_{i >= j} W_ij C_i, 16 rows i at a time from the diagonal down
  float cs[2] = {0.f, 0.f};  // sum_i M_ij q_ij, rows j0 and j1
  for (int ks = mt; ks < t.nmt; ++ks) {
    const int ib = 16 * ks;
    float q[2][4] = {}, sc[2][4] = {};  // q^T, (C . B^T)^T: rows j, cols i
    mma_rows<4>(q, xa, t.s0, t.PS, ib, t.pk);
    mma_rows_own<NTM>(sc, bj, t.s1, t.CS, ib, t.nk);
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float cm_[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) cm_[u] = t.cum[ib + 8 * h2 + 2 * tig + u];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = j0 + 8 * rr;
        const float cj = rr ? cum1 : cum0, dj = rr ? dt1 : dt0;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = ib + 8 * h2 + 2 * tig + u;
          const float qd = (i >= j && i < Lc)
                               ? q[h2][2 * rr + u] * expf(cm_[u] - cj)
                               : 0.f;
          cs[rr] += qd * sc[h2][2 * rr + u];  // M_ij q_ij
          v[u] = qd * dj;                     // W_ij
        }
        split_pack(v[0], v[1], ahi[2 * h2 + rr], alo[2 * h2 + rr]);
      }
    }
    mma_split<NTM>(acc, ahi, alo, t.s1, t.CS, ib, ntn);
  }
  PHASE(ph + 2);

  const size_t hrow = (size_t)g.H * g.N;
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt) {
    const int n = 8 * nt + 2 * tig;
    if (nt >= ntn || n >= g.N) break;
    float* o = g.dbp + (t.row0 * g.H + t.k.h) * g.N + n;
    if (j0 < Lc)
      *reinterpret_cast<float2*>(o + j0 * hrow) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (j1 < Lc)
      *reinterpret_cast<float2*>(o + j1 * hrow) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
  own_rows(g, t, next, g.x, g.bm);
  const float c0 = quad_sum(cs[0]), c1 = quad_sum(cs[1]);
  float* colr = g.rows + (nbhc + t.cb) * g.L;
  if (tig == 0) {
    if (j0 < Lc) colr[j0] = c0;
    if (j1 < Lc) colr[j1] = c1;
  }
  PHASE(ph + 3);
}

// Key side, dx: tile mt (rows j): u_j = e^{total - cum_j} dS' B_j +
// sum_{i >= j} M_ij dy_i, dx_j = dt_j u_j, and e^{total - cum_j} x_j .
// dS' B_j for ddt and g. Slots: dy, C, dS' (read transposed). Returns the
// thread's share of sum_j dt_j e^{total - cum_j} x_j . dS' B_j.
template <int NTM>
__device__ float keyx_tile(const TcArgs& g, const TcBlock& t, int mt,
                           int next, size_t nbhc, int ph) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int j_lo = 16 * mt, Lc = t.k.Lc, ptn = 2 * t.pk;
  const size_t ldx = (size_t)g.H * g.P;
  OwnRows bj;  // x_j (for x_j . dS' B_j), B_j (K = N)
  bj.load(t);
  auto& xa = bj.p;
  PHASE(ph);

  // dS' B_j (K = N)
  float acc[8][4];
#pragma unroll
  for (int pt = 0; pt < 8; ++pt)
    acc[pt][0] = acc[pt][1] = acc[pt][2] = acc[pt][3] = 0.f;
#pragma unroll
  for (int kn = 0; kn < NTM / 2; ++kn) {
    if (kn >= t.nk) break;
    uint32_t af[4];
    bj.get(kn, af);
    mma_state<8, true>(acc, af, t.s2, t.SR, t.Np, 16 * kn, ptn);
  }
  const int j0 = j_lo + gid, j1 = j0 + 8;
  float s0 = 0.f, s1 = 0.f;  // x_j . dS' B_j
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) {
    if (kp >= t.pk) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 u0 = unpack(xa[kp][2 * h]), u1 = unpack(xa[kp][2 * h + 1]);
      const float* r = acc[2 * kp + h];
      s0 += r[0] * u0.x + r[1] * u0.y;
      s1 += r[2] * u1.x + r[3] * u1.y;
    }
  }
  const float cum0 = j0 < Lc ? t.cum[j0] : 0.f;
  const float cum1 = j1 < Lc ? t.cum[j1] : 0.f;
  const float e0 = j0 < Lc ? expf(t.total - cum0) : 0.f;
  const float e1 = j1 < Lc ? expf(t.total - cum1) : 0.f;
  const float k0 = e0 * quad_sum(s0), k1 = e1 * quad_sum(s1);
#pragma unroll
  for (int pt = 0; pt < 8; ++pt) {
    acc[pt][0] *= e0;
    acc[pt][1] *= e0;
    acc[pt][2] *= e1;
    acc[pt][3] *= e1;
  }
  PHASE(ph + 1);

  // sum_{i >= j} M_ij dy_i, 16 rows i at a time from the diagonal down
  for (int ks = mt; ks < t.nmt; ++ks) {
    const int ib = 16 * ks;
    float sc[2][4] = {};  // (C . B^T)^T: rows j, cols i
    mma_rows_own<NTM>(sc, bj, t.s1, t.CS, ib, t.nk);
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float cm_[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) cm_[u] = t.cum[ib + 8 * h2 + 2 * tig + u];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = j0 + 8 * rr;
        const float cj = rr ? cum1 : cum0;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = ib + 8 * h2 + 2 * tig + u;
          v[u] = (i >= j && i < Lc)
                     ? sc[h2][2 * rr + u] * expf(cm_[u] - cj)
                     : 0.f;
        }
        split_pack(v[0], v[1], ahi[2 * h2 + rr], alo[2 * h2 + rr]);
      }
    }
    mma_split<8>(acc, ahi, alo, t.s0, t.PS, ib, ptn);
  }
  PHASE(ph + 2);
  own_rows(g, t, next, g.x, g.bm);

  const float d0 = j0 < Lc ? t.dt[j0] : 0.f, d1 = j1 < Lc ? t.dt[j1] : 0.f;
#pragma unroll
  for (int pt = 0; pt < 8; ++pt) {
    const int p = 8 * pt + 2 * tig;
    if (pt >= ptn || p >= g.P) break;
    bf16* o = g.dx + t.xoff + p;
    if (j0 < Lc)
      *reinterpret_cast<__nv_bfloat162*>(o + j0 * ldx) =
          __floats2bfloat162_rn(d0 * acc[pt][0], d0 * acc[pt][1]);
    if (j1 < Lc)
      *reinterpret_cast<__nv_bfloat162*>(o + j1 * ldx) =
          __floats2bfloat162_rn(d1 * acc[pt][2], d1 * acc[pt][3]);
  }
  float* krow = g.rows + (2 * nbhc + t.cb) * g.L;
  if (tig == 0) {
    if (j0 < Lc) krow[j0] = k0;
    if (j1 < Lc) krow[j1] = k1;
  }
  PHASE(ph + 3);
  return tig == 0 ? d0 * k0 + d1 * k1 : 0.f;
}

// the block's sum of each thread's v, warps in order: thread 0 gets it
__device__ __forceinline__ float tc_block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kTcWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// blocks an SM holds by shared memory at P 64: 3 up to N = 64, 2 up to
// N = 128, 1 at N = 256; the registers a thread may take follow
template <int NTM>
constexpr int tc_min_blocks() {
  return NTM <= 8 ? 3 : (NTM <= 16 ? 2 : 1);
}

// grid 3 (bf16): three blocks per (batch, head, chunk), FlashAttention-2's
// backward laid out for this scan: the query side (dC), and the key side
// as two blocks (dx; dB), so that each block's operands fit beside a
// second block on the SM. Warp w takes the 16-row tiles w and 7 - w, the
// same share of the triangle on either side.
template <int NTM>
__global__ void __launch_bounds__(kTc, tc_min_blocks<NTM>())
    ssd_bwd_chunk_tc(const TcArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  PHASE(0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kind = blockIdx.x % 3;  // 0 query, 1 key dx, 2 key dB
  const ChunkTC ly = chunk_tc(g.L, g.P, g.N);
  TcBlock t;
  t.k = chunk_of(blockIdx.x / 3, g.H, g.G, g.S, g.L, g.nc);
  const int Lc = t.k.Lc, K16 = round_up(Lc, 16);
  t.PS = ly.PS;
  t.CS = ly.CS;
  t.SR = 2 * ly.HS;
  t.Np = ly.Np;
  t.nmt = K16 / 16;
  t.pk = ly.P16 / 16;
  t.nk = ly.Np / 16;
  t.row0 = (size_t)t.k.b * g.S + t.k.c0;
  t.xoff = (t.row0 * g.H + t.k.h) * g.P;
  t.boff = (t.row0 * g.G + t.k.g) * g.N;
  t.cb = (size_t)t.k.bh * g.nc + t.k.c;
  const size_t soff = t.cb * g.P * g.N;
  bf16* s0 = reinterpret_cast<bf16*>(smem);
  bf16* s1 = reinterpret_cast<bf16*>(smem + ly.s1);
  float* s2 = reinterpret_cast<float*>(smem + ly.s2);
  float* dt_s = reinterpret_cast<float*>(smem + ly.dt);
  float* cum = reinterpret_cast<float*>(smem + ly.cum);
  t.op = reinterpret_cast<bf16*>(smem + ly.own) + warp * 16 * (ly.PS + ly.CS);
  t.on = t.op + 16 * ly.PS;
  // warp 0's first own row's padding
  float* red = reinterpret_cast<float*>(smem + ly.own + ly.P16 * 2);

  // every copy in flight at once: the three slots, dt
  stage<kTc>(s0, ly.PS, (kind == 0 ? g.x : g.dy) + t.xoff,
             (size_t)g.H * g.P, Lc, g.P, K16, ly.P16, true);
  stage<kTc>(s1, ly.CS, (kind == 0 ? g.bm : g.cm) + t.boff,
             (size_t)g.G * g.N, Lc, g.N, K16, ly.Np, true);
  stage<kTc>(s2, ly.HS, (kind == 0 ? g.st : g.gs) + soff, (size_t)g.N, g.P,
             g.N, ly.P16, ly.Np, true);
  // and each warp's own rows of its first tile
  own_rows(g, t, warp, kind == 0 ? g.dy : g.x, kind == 0 ? g.cm : g.bm);
  for (int i = tid; i < K16; i += kTc)
    dt_s[i] = i < Lc ? g.dt[(t.row0 + i) * g.H + t.k.h] : 0.f;
  __syncthreads();
  chunk_cumsum<kTc>(dt_s, g.a[t.k.h], cum, red, Lc);
  for (int i = Lc + tid; i < K16; i += kTc) cum[i] = 0.f;
  cp_async_wait_all();
  __syncthreads();
  // each row of the state into its hi and lo halves, in place: a warp reads
  // the whole row before it writes it. The dx block also takes <dS', S>
  // from the f32 values, S read from device memory (N a multiple of 8).
  float dot = 0.f;
  const float* sp = g.st + soff;
  for (int p = warp; p < ly.P16; p += kTcWarps) {
    float4 v[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c4 = lane + 32 * q;
      v[q] = 4 * c4 < ly.Np
                 ? *reinterpret_cast<const float4*>(s2 + p * ly.HS + 4 * c4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      if (kind == 1 && p < g.P && 4 * c4 < g.N) {
        const float4 u = __ldg(
            reinterpret_cast<const float4*>(sp + (size_t)p * g.N) + c4);
        dot += u.x * v[q].x + u.y * v[q].y + u.z * v[q].z + u.w * v[q].w;
      }
    }
    __syncwarp();
    bf16* row = reinterpret_cast<bf16*>(s2 + p * ly.HS);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c4 = lane + 32 * q;
      if (4 * c4 >= ly.Np) continue;
      uint32_t hi[2], lo[2];
      split_pack(v[q].x, v[q].y, hi[0], lo[0]);
      split_pack(v[q].z, v[q].w, hi[1], lo[1]);
      *reinterpret_cast<uint2*>(row + 4 * c4) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(row + ly.Np + 4 * c4) =
          make_uint2(lo[0], lo[1]);
    }
  }
  __syncthreads();
  t.s0 = s0;
  t.s1 = s1;
  t.s2 = reinterpret_cast<const bf16*>(s2);
  t.dt = dt_s;
  t.cum = cum;
  t.total = cum[Lc - 1];
  PHASE(1);

  const size_t nbhc = (size_t)gridDim.x / 3;
  float sterm = 0.f;
  for (int pick = 0; pick < 2; ++pick) {
    const int mt = pick == 0 ? warp : 7 - warp;
    const int next = pick == 0 ? 7 - warp : t.nmt;  // the next tile, if any
    if (mt >= t.nmt) continue;
    if (kind == 0)
      query_tile<NTM>(g, t, mt, next, 2 + 4 * pick);
    else if (kind == 1)
      sterm += keyx_tile<NTM>(g, t, mt, next, nbhc, 2 + 4 * pick);
    else
      keyb_tile<NTM>(g, t, mt, next, nbhc, 2 + 4 * pick);
  }
  PHASE(10);
  if (kind != 1) return;
  // the chunk's last-step term of g: e^{total} <dS', S> + sum_j dt_j
  // e^{total - cum_j} x_j . dS' B_j
  const float dsum = tc_block_sum(dot, red);
  const float ssum = tc_block_sum(sterm, red);
  if (tid == 0) g.rows[3 * nbhc * g.L + t.cb] = expf(t.total) * dsum + ssum;
  PHASE(11);
}

// grid 4 (bf16): per (batch, head, chunk), g from the three blocks' terms
// (g_j = row_j - dt_j (col_j + dS'_j), the last step's term at Lc - 1),
// its suffix sums dda_k = sum_{m >= k} g_m, ddt = col + dS' + a dda and
// the chunk's share of da, sum_k dt_k dda_k, in a fixed order
__global__ void __launch_bounds__(kTc)
    ssd_bwd_ddt(const float* __restrict__ dt, const float* __restrict__ a,
                const float* __restrict__ rows, float* __restrict__ ddt,
                float* __restrict__ dapart, int S, int H, int G, int L,
                int nc) {
  __shared__ float part[kTcWarps];
  const Chunk k = chunk_of(blockIdx.x, H, G, S, L, nc);
  const size_t nbhc = gridDim.x, cb = (size_t)k.bh * nc + k.c;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const size_t row0 = (size_t)k.b * S + k.c0;
  float dti = 0.f, kc = 0.f, gi = 0.f;
  if (i < k.Lc) {
    dti = dt[(row0 + i) * H + k.h];
    kc = rows[(nbhc + cb) * L + i] + rows[(2 * nbhc + cb) * L + i];
    gi = rows[cb * L + i] - dti * kc;
    if (i == k.Lc - 1) gi += rows[3 * nbhc * L + cb];
  }
  float v = gi;  // suffix sums within the warp, then the later warps'
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += u;
  }
  if (lane == 0) part[warp] = v;
  __syncthreads();
  for (int w = warp + 1; w < kTcWarps; ++w) v += part[w];
  if (i < k.Lc) ddt[(row0 + i) * H + k.h] = kc + a[k.h] * v;
  float d = dti * v;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
  __syncthreads();
  if (lane == 0) part[warp] = d;
  __syncthreads();
  if (i == 0) {
    float s = 0.f;
    for (int w = 0; w < kTcWarps; ++w) s += part[w];
    dapart[cb] = s;
  }
}

// host side

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the reverse fold and the heads' sum, grids of either path
cudaError_t fold(float* gs, const float* dec, const float* dfinal, int B,
                 int H, int P, int N, int nc, cudaStream_t s) {
  const int PN = P * N;
  const int nblk = (PN + kFold * kThreads - 1) / (kFold * kThreads);
  ssd_bwd_fold<<<(unsigned)((long long)B * H * nblk), kThreads, 0, s>>>(
      gs, dec, dfinal, nc, PN, nblk);
  return cudaGetLastError();
}
template <typename T>
cudaError_t reduce(const float* dbp, const float* dcp, const float* dapart,
                   T* db, T* dc, float* da, int B, int S, int H, int G,
                   int N, int nc, cudaStream_t s) {
  const long long total = (long long)B * S * G * N;
  long long grid = (total + kThreads - 1) / kThreads;
  grid = grid < 1 ? 1 : (grid > 65535 ? 65535 : grid);
  ssd_bwd_reduce<T><<<(unsigned)grid, kThreads, 0, s>>>(
      dbp, dcp, dapart, db, dc, da, (long long)B * S, H, G, N, B, nc);
  return cudaGetLastError();
}

int launch_f32(const float* x, const float* dt, const float* a,
               const float* bm, const float* cm, const float* st,
               const float* dy, const float* dfinal, float* dx, float* ddt,
               float* da, float* db, float* dc, float* gs, float* dec,
               float* dapart, float* dbp, float* dcp, int B, int S, int H,
               int P, int G, int N, int L, int ns, cudaStream_t s) {
  const int nc = (S + L - 1) / L;
  const int nb = round_up((N + ns - 1) / ns, 8);
  const size_t sm1 = contrib_layout(L, P, nb).total;
  const size_t sm3 = chunk_layout(L, P).total;
  if (sm1 > kMaxSmem || sm3 > kMaxSmem || L > kMaxL ||
      (long long)round_up(L, 4) * round_up(P, 4) > 16LL * kLP * kThreads)
    return (int)cudaErrorInvalidValue;
  static size_t opted1 = 48 * 1024, opted3 = 48 * 1024;
  cudaError_t err = opt_in(ssd_bwd_contrib<float>, sm1, opted1);
  if (err == cudaSuccess)
    err = opt_in(ssd_bwd_chunk<float>, sm3, opted3);
  if (err != cudaSuccess) return (int)err;
  const long long bh = (long long)B * H;
  ssd_bwd_contrib<float><<<(unsigned)(bh * nc * ns), kThreads, sm1, s>>>(
      dy, dt, a, cm, gs, dec, S, H, P, G, N, L, nc, ns);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = fold(gs, dec, dfinal, B, H, P, N, nc, s);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk<float><<<(unsigned)(bh * nc), kThreads, sm3, s>>>(
      x, dt, a, bm, cm, st, gs, dy, dx, ddt, dapart, dbp, dcp, S, H, P, G,
      N, L, nc);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = reduce<float>(dbp, dcp, dapart, db, dc, da, B, S, H, G, N, nc, s);
  return (int)err;
}

template <int NTM>
cudaError_t chunk_tc_launch(const TcArgs& g, long long blocks, size_t smem,
                            cudaStream_t s) {
  static size_t opted = 48 * 1024;
  const cudaError_t err = opt_in(ssd_bwd_chunk_tc<NTM>, smem, opted);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_tc<NTM><<<(unsigned)blocks, kTc, smem, s>>>(g);
  return cudaGetLastError();
}

int launch_tc(const bf16* x, const float* dt, const float* a,
              const bf16* bm, const bf16* cm, const float* st,
              const bf16* dy, const float* dfinal, bf16* dx, float* ddt,
              float* da, bf16* db, bf16* dc, float* gs, float* dec,
              float* dapart, float* dbp, float* dcp, float* rows, int B,
              int S, int H, int P, int G, int N, int L, int ns,
              cudaStream_t s) {
  const int nc = (S + L - 1) / L;
  const int nb = round_up((N + ns - 1) / ns, 8);
  const size_t sm1 = state_tc(L, P, nb).total;
  const size_t sm3 = chunk_tc(L, P, N).total;
  if (L > kTcMaxL || P > kTcMaxP || N > kTcMaxN || P % 8 != 0 ||
      N % 8 != 0 || sm1 > kMaxSmem || sm3 > kMaxSmem || rows == nullptr ||
      !aligned16(x) || !aligned16(dy) || !aligned16(bm) || !aligned16(cm) ||
      !aligned16(st) || !aligned16(gs))
    return (int)cudaErrorInvalidValue;
  static size_t opted1 = 48 * 1024;
  cudaError_t err = opt_in(ssd_bwd_contrib_tc, sm1, opted1);
  if (err != cudaSuccess) return (int)err;
  const long long bh = (long long)B * H;
  ssd_bwd_contrib_tc<<<(unsigned)(bh * nc * ns), kThreads, sm1, s>>>(
      dy, dt, a, cm, gs, dec, S, H, P, G, N, L, nc, ns);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = fold(gs, dec, dfinal, B, H, P, N, nc, s);
  if (err != cudaSuccess) return (int)err;
  const TcArgs g{x, bm, cm, dy, dt, a, st, gs, dx, dbp, dcp, rows,
                 S, H, P, G, N, L, nc};
  const int ntm = round_up(N, 16) / 8;
  err = ntm <= 8 ? chunk_tc_launch<8>(g, 3 * bh * nc, sm3, s)
        : ntm <= 16 ? chunk_tc_launch<16>(g, 3 * bh * nc, sm3, s)
                    : chunk_tc_launch<32>(g, 3 * bh * nc, sm3, s);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_ddt<<<(unsigned)(bh * nc), kTc, 0, s>>>(dt, a, rows, ddt, dapart, S,
                                                  H, G, L, nc);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = reduce<bf16>(dbp, dcp, dapart, db, dc, da, B, S, H, G, N, nc, s);
  return (int)err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC share it; dt,
// a, the states, the final state's cotangent `dfinal` (null for none),
// ddt and da are float32). `states` are the forward's states entering each
// chunk, [B * H, ceil(S / L), P, N]. f32 scratch: `gs` as large as
// `states`, `dec` and `dapart` B * H * ceil(S / L) floats, `dbp` and `dcp`
// B * S * H * N floats each; in bf16 also `rows`, (3 L + 1) B * H *
// ceil(S / L) floats (null in f32), and x, dy, B, C, the states and `gs`
// 16-byte aligned. `ns` (1 or 2) cuts N over the first grid's blocks. Four
// grids on `stream` in f32, five in bf16; returns the first failing
// launch's cudaError_t (0 on success), never synchronises.
extern "C" int ssd_bwd(int dtype, const void* x, const void* dt,
                       const void* a, const void* bm, const void* cm,
                       const void* states, const void* dy,
                       const void* dfinal, void* dx, void* ddt, void* da,
                       void* db, void* dc, void* gs, void* dec, void* dapart,
                       void* dbp, void* dcp, void* rows, int B, int S, int H,
                       int P, int G, int N, int L, int ns, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      N <= 0 || L <= 0 || ns < 1 || ns > 2 || gs == nullptr ||
      dec == nullptr || dapart == nullptr || dbp == nullptr ||
      dcp == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* stf = static_cast<const float*>(states);
  const float* dff = static_cast<const float*>(dfinal);
  float* ddtf = static_cast<float*>(ddt);
  float* daf = static_cast<float*>(da);
  float* gsf = static_cast<float*>(gs);
  float* decf = static_cast<float*>(dec);
  float* dapf = static_cast<float*>(dapart);
  float* dbpf = static_cast<float*>(dbp);
  float* dcpf = static_cast<float*>(dcp);
  if (dtype == 0)
    return launch_f32(
        static_cast<const float*>(x), dtf, af, static_cast<const float*>(bm),
        static_cast<const float*>(cm), stf, static_cast<const float*>(dy),
        dff, static_cast<float*>(dx), ddtf, daf, static_cast<float*>(db),
        static_cast<float*>(dc), gsf, decf, dapf, dbpf, dcpf, B, S, H, P, G,
        N, L, ns, s);
  if (dtype == 1)
    return launch_tc(
        static_cast<const bf16*>(x), dtf, af, static_cast<const bf16*>(bm),
        static_cast<const bf16*>(cm), stf, static_cast<const bf16*>(dy), dff,
        static_cast<bf16*>(dx), ddtf, daf, static_cast<bf16*>(db),
        static_cast<bf16*>(dc), gsf, decf, dapf, dbpf, dcpf,
        static_cast<float*>(rows), B, S, H, P, G, N, L, ns, s);
  return (int)cudaErrorInvalidValue;
}
