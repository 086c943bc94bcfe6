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
//           + a sum_{m >= j} g_m,   g = d/d cum (see ssd_bwd_chunk)
//   da    = sum over every step of dt_k sum_{m >= k} g_m
//
// Bound on the H100: the operations. Per head and chunk of L = 128 at
// mamba2-370m's P = 64, N = 128 the products take about 2 (L^2 (N + 2 P)
// / 2 + L^2 N + 6 L P N) flops, 23 MFLOP, against (4 P + 2 N) L bytes of
// bf16 input and output plus the f32 state (P N 4 bytes): far past the
// 295 flops a byte where the bytes would bound it, on any unit.
//
// Design: a simple kernel that is right, every product in f32 on the CUDA
// cores (register tiles of 4 x 4), no atomics, so two calls give the same
// bits. Four grids on the caller's stream:
//   ssd_bwd_contrib, one block per (batch, head, chunk, part of N): the
//     chunk's sum_i e^{cum_i} dy_i C_i^T [P, N] and its decay e^{total},
//     to f32 scratch (the forward's first grid with dy for x and
//     C e^{cum} for B w);
//   ssd_bwd_fold, blocks over (batch, head, P N / 1024): folds the chunks
//     in reverse, dS'(c - 1) = e^{total_c} dS'(c) + contribution(c),
//     replacing each contribution with the dS' of its chunk; the only
//     sequential part, P N values a chunk;
//   ssd_bwd_chunk, one block per (batch, head, chunk): everything else.
//     x, dy and an L x L matrix stay in shared memory; B, C, S and dS' go
//     through it in tiles of 32 columns of N, twice: the first pass sums
//     C . B^T into the matrix and dS' B_j, S C_i in registers; then M, dx,
//     the cum gradient g (its terms reduced in a fixed order), ddt and the
//     chunk's share of da; the matrix is overwritten with W, and the
//     second pass writes dB and dC for the head, f32, to scratch;
//   ssd_bwd_reduce: dB and dC summed over a group's heads in head order,
//     rounded once to x's dtype; da summed over (batch, chunk) in order.
// A last chunk shorter than L runs as it is. The limits (checked by the
// launcher and by ssd.py's wrapper): L P <= 16 * 2 * 256 (the register
// tiles of dS' B_j and S C_i), L <= 256, and ssd_bwd_chunk's shared memory
// (ssd.py's bwd_smem_bytes mirrors it) within 232,448 bytes: at P = 64,
// chunks up to 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNT = 32;   // columns of N a tile of ssd_bwd_chunk
constexpr int kLP = 2;    // 4 x 4 tiles of [L, P] a thread keeps
constexpr int kMaxL = 256;
constexpr size_t kMaxSmem = 232448;  // per block on sm_90

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}
__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
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

// the (batch, head, chunk) of a block index without its fastest part
struct Chunk {
  int bh, b, h, g, c, c0, Lc;
};
__device__ __forceinline__ Chunk chunk_of(int bid, int H, int G, int S,
                                          int L, int nc) {
  Chunk k;
  k.c = bid % nc;
  k.bh = bid / nc;
  k.b = k.bh / H;
  k.h = k.bh - k.b * H;
  k.g = k.h / (H / G);
  k.c0 = k.c * L;
  k.Lc = min(L, S - k.c0);
  return k;
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
  for (int c = nc - 1; c >= 0; --c) {
    const float d = db[c];
    float* row = base + (size_t)c * PN;
#pragma unroll
    for (int f = 0; f < kFold; ++f) {
      if (es[f] >= PN) continue;
      const float u = row[es[f]];
      row[es[f]] = g[f];  // dS' of chunk c
      g[f] = d * g[f] + u;
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

// host side

template <typename K>
cudaError_t opt_in(K kernel, size_t bytes, size_t& opted) {
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess) opted = kMaxSmem;
  return err;
}

template <typename T>
int launch(const T* x, const float* dt, const float* a, const T* bm,
           const T* cm, const float* st, const T* dy, const float* dfinal,
           T* dx, float* ddt, float* da, T* db, T* dc, float* gs, float* dec,
           float* dapart, float* dbp, float* dcp, int B, int S, int H, int P,
           int G, int N, int L, int ns, cudaStream_t s) {
  const int nc = (S + L - 1) / L;
  const int nb = round_up((N + ns - 1) / ns, 8);
  const size_t sm1 = contrib_layout(L, P, nb).total;
  const size_t sm3 = chunk_layout(L, P).total;
  if (sm1 > kMaxSmem || sm3 > kMaxSmem || L > kMaxL ||
      (long long)round_up(L, 4) * round_up(P, 4) > 16LL * kLP * kThreads)
    return (int)cudaErrorInvalidValue;
  static size_t opted1 = 48 * 1024, opted3 = 48 * 1024;
  cudaError_t err = opt_in(ssd_bwd_contrib<T>, sm1, opted1);
  if (err == cudaSuccess)
    err = opt_in(ssd_bwd_chunk<T>, sm3, opted3);
  if (err != cudaSuccess) return (int)err;
  const long long bh = (long long)B * H;
  ssd_bwd_contrib<T><<<(unsigned)(bh * nc * ns), kThreads, sm1, s>>>(
      dy, dt, a, cm, gs, dec, S, H, P, G, N, L, nc, ns);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int PN = P * N;
  const int nblk = (PN + kFold * kThreads - 1) / (kFold * kThreads);
  ssd_bwd_fold<<<(unsigned)(bh * nblk), kThreads, 0, s>>>(gs, dec, dfinal,
                                                          nc, PN, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk<T><<<(unsigned)(bh * nc), kThreads, sm3, s>>>(
      x, dt, a, bm, cm, st, gs, dy, dx, ddt, dapart, dbp, dcp, S, H, P, G,
      N, L, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * S * G * N;
  long long grid = (total + kThreads - 1) / kThreads;
  grid = grid < 1 ? 1 : (grid > 65535 ? 65535 : grid);
  ssd_bwd_reduce<T><<<(unsigned)grid, kThreads, 0, s>>>(
      dbp, dcp, dapart, db, dc, da, (long long)B * S, H, G, N, B, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC share it; dt,
// a, the states, the final state's cotangent `dfinal` (null for none),
// ddt and da are float32). `states` are the forward's states entering each
// chunk, [B * H, ceil(S / L), P, N]. f32 scratch: `gs` as large as
// `states`, `dec` and `dapart` B * H * ceil(S / L) floats, `dbp` and `dcp`
// B * S * H * N floats each. `ns` (1 or 2) cuts N over the first grid's
// blocks. Four grids on `stream`; returns the first failing launch's
// cudaError_t (0 on success), never synchronises.
extern "C" int ssd_bwd(int dtype, const void* x, const void* dt,
                       const void* a, const void* bm, const void* cm,
                       const void* states, const void* dy,
                       const void* dfinal, void* dx, void* ddt, void* da,
                       void* db, void* dc, void* gs, void* dec, void* dapart,
                       void* dbp, void* dcp, int B, int S, int H, int P,
                       int G, int N, int L, int ns, void* stream) {
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
    return launch<float>(
        static_cast<const float*>(x), dtf, af, static_cast<const float*>(bm),
        static_cast<const float*>(cm), stf, static_cast<const float*>(dy),
        dff, static_cast<float*>(dx), ddtf, daf, static_cast<float*>(db),
        static_cast<float*>(dc), gsf, decf, dapf, dbpf, dcpf, B, S, H, P, G,
        N, L, ns, s);
  if (dtype == 1)
    return launch<bf16>(
        static_cast<const bf16*>(x), dtf, af, static_cast<const bf16*>(bm),
        static_cast<const bf16*>(cm), stf, static_cast<const bf16*>(dy), dff,
        static_cast<bf16*>(dx), ddtf, daf, static_cast<bf16*>(db),
        static_cast<bf16*>(dc), gsf, decf, dapf, dbpf, dcpf, B, S, H, P, G,
        N, L, ns, s);
  return (int)cudaErrorInvalidValue;
}
