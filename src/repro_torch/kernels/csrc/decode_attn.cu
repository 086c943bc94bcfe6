// Single-token GQA decode attention, hand-written for Hopper (sm_90a):
// flash-decoding over a dense cache with a validity mask or over a paged
// pool read through a page table, any group size. One kernel body serves
// both; a template parameter says how a position is found and whether it
// is attended.
//
// Replaces the Pallas TPU kernels
// src/repro/kernels/decode_attn.py::decode_attn (_decode_kernel):
// q [B, Hq, D], K/V [B, T, Hkv, D], valid [B, T] (bytes, 0 or 1) ->
// out [B, Hq, D] in q's dtype. The mask carries every cache layout: slot
// occupancy, rolling sliding-window slots, windows;
// and src/repro/kernels/decode_attn.py::paged_decode_attn
// (_paged_decode_kernel): the same q against page pools K/V [P, page, Hkv,
// D] through a page table [B, NP] i32 (-1 = unallocated) and pos [B] i32.
// Position t of row b lives at row pt[b, t / page] * page + t % page of the
// pool and is attended iff t <= pos[b] and its page is allocated; the
// kernel works on the logical cache of T = NP * page positions.
// A masked score is -1e30, as in the Pallas kernels and the plain versions,
// so a row with no attended position gets uniform weights: the mean of V
// over all T (for the paged cache, over the NP * page positions the table
// addresses, a -1 page read as page 0, as the Pallas kernel's DMA clamps
// it and the plain version's gather does).
//
// Bound on the H100: memory. Each attended K and V row is read once (at
// zamba2-2.7b's decode, B = 8, T = 332, Hkv = 32, D = 80 in bf16: about
// 27 MB, 8 us at 3.35 TB/s; at llama3-8b's, paged or dense, Hkv = 8, D =
// 128, context 160: about 5.2 MB, 1.6 us); the arithmetic is 4 * Hq * D
// flops per position, two orders of magnitude under the bf16 rate.
//
// Design: the TPU grid (B, Hkv, T / bt) or (B, Hkv, NP) carries the online
// softmax across its sequential last axis in VMEM scratch. Here the T axis
// of one (row, kv head) is cut into `nsplit` spans, one block each, and a
// group of more than kGroupMax = 16 query heads into slices, one block
// each: a block is one (row, kv head, head slice, span). A decode call is
// short, so what costs time is the chain of round trips to memory inside a
// block, not the arithmetic. A block first reads, with q, what says where
// each position of its first tile lives and whether it is attended (dense:
// the tile's mask bytes; paged: pos[b] and the page id of each position,
// so a 128-position tile at page 16 reads 8 table entries), keeps the
// tile's row indices in shared memory, then issues 16-byte cp.async copies
// of every K and V row of the tile at once (up to 128 positions, the
// wrapper sizes the tile to about 36 KB of shared memory; a tile may cross
// any number of pages; rows padded by 16 bytes so that the 16-byte reads of
// eight lanes hit distinct banks; a row whose bytes are no multiple of 16,
// or an unaligned pointer, takes a scalar copy into the same layout), and
// scores the whole tile at once: one thread (or up to 8 lanes meeting by
// shuffles) per (head, position) score, one warp per head for the softmax,
// and a P.V product in which each thread owns fixed (head, 16-byte column
// chunk) outputs and, where there are fewer outputs than threads, a share
// of the positions (the shares are added in shared memory at the end);
// accumulators live in registers, at most 32 floats a thread. At the
// serving shapes a span is one tile; a longer span walks its tiles with the
// online softmax. A masked score is -1e30, so a tile with no attended
// position adds weight exp(-1e30 - M) = 0 when its row has an attended
// position elsewhere: such a tile is not read at all (tiles past pos[b] or
// on -1 pages, and the empty tiles of a row that a short prompt leaves
// mostly empty), and a row with none reads and averages V over all T. A
// page id past the pool's end is a caller's bug: a device assert stops the
// kernel, as an out-of-range index stops the plain version. With
// nsplit = 1 the block writes the output itself.
// Otherwise the spans of one (row, kv head, slice), at most kMaxSplit = 8
// (Hopper's portable cluster size), run as one thread-block cluster: each
// leaves its partial (max, sum, unnormalised accumulator, f32) in shared
// memory and, after a cluster barrier, merges a slice of the output
// (weights exp(m_i - M)) reading the others' partials through distributed
// shared memory: no scratch, no fence, no atomics, one launch per call (no
// second grid on a host-bound decode step). A longer cache walks more
// tiles a span. The split comes from shapes alone, never from pos, so a
// call makes no host sync.

#include <assert.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Phase stamps for tools/kernel_phases.py, compiled in only with
// -DKERNEL_PHASES: thread 0 of blocks 0 and 1 writes clock64() at each
// numbered point of its life (PHASE below), read back by read_phases.
#ifdef KERNEL_PHASES
__device__ unsigned long long g_phases[2][32];
#define PHASE(i)                                                   \
  do {                                                             \
    if (threadIdx.x == 0 && blockIdx.x < 2 && (i) < 32)            \
      g_phases[blockIdx.x][(i)] = clock64();                       \
  } while (0)
extern "C" int read_phases(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phases, sizeof(g_phases));
}
extern "C" int clear_phases() {
  static const unsigned long long zero[2][32] = {};
  return (int)cudaMemcpyToSymbol(g_phases, zero, sizeof(g_phases));
}
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupMax = 16;  // query heads per block
constexpr int kMaxD = 256;     // head dim
constexpr int kMaxTile = 128;  // positions staged at once
constexpr int kMaxSplit = 8;   // spans per (row, kv head): one cluster
constexpr int kAcc = 32;       // accumulator floats per thread
constexpr float kMasked = -1e30f;

// where the positions of a row live and which are attended
struct Cache {
  const uint8_t* valid;  // dense: [B, T] bytes
  const int* pt;         // paged: [B, NP] page ids, -1 = unallocated
  const int* pos;        // paged: [B], position pos[b] is attended
  int page, NP, P;       // paged: page size, table width, pool pages
};

// 16-byte chunks of a row in shared memory, as floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void load(const unsigned char* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void load(const unsigned char* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Shared memory of a block with a slice of gsz heads and tiles of `tile`
// positions, in bytes from the start: K and V tiles [tile, rowb] each
// (later the P.V shares, then the span's partial), q [gsz, nchunk * E]
// f32, scores [gsz, tile] f32, running (m, l, rescale) [gsz] f32, the
// merge's span weights [gsz, kMaxSplit] and sums [gsz], the tile's cache
// rows [tile] i32 and mask bytes [tile].
struct Layout {
  int nchunk;  // 16-byte chunks of a K/V row (zero-padded past D)
  int rowb;    // bytes between staged rows
  size_t q, s, m, l, c, w, lsum, rows, mask, total;
};
__host__ __device__ inline Layout layout(int D, int esize, int gsz,
                                         int tile) {
  Layout y;
  y.nchunk = (D * esize + 15) / 16;
  y.rowb = y.nchunk * 16 + 16;
  const int E = 16 / esize;
  size_t o = align16((size_t)2 * tile * y.rowb);
  // at the end the tile's bytes hold the P.V shares, then the partial
  const size_t red = sizeof(float) * kThreads * E;
  const size_t partial = sizeof(float) * gsz * (D + 2);
  if (o < red) o = align16(red);
  if (o < partial) o = align16(partial);
  y.q = o;
  o += align16(sizeof(float) * gsz * y.nchunk * E);
  y.s = o;
  o += align16(sizeof(float) * gsz * tile);
  y.m = o;
  o += align16(sizeof(float) * gsz);
  y.l = o;
  o += align16(sizeof(float) * gsz);
  y.c = o;
  o += align16(sizeof(float) * gsz);
  y.w = o;
  o += align16(sizeof(float) * gsz * kMaxSplit);
  y.lsum = o;
  o += align16(sizeof(float) * gsz);
  y.rows = o;
  o += align16(sizeof(int) * tile);
  y.mask = o;
  o += align16(tile);
  y.total = o;
  return y;
}

// One (row, kv head, head slice, span) block; kPaged picks how a position
// is found (the pool row through the page table, or row b's own slot) and
// whether it is attended (t <= pos[b] on an allocated page, or its mask
// byte).
template <typename T, bool kPaged>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const Cache cache, T* __restrict__ out, int Hq,
    int Hkv, int D, int Tn, float scale, int gslices, int gsz, int nsplit,
    int span, int tile, int vec) {
  constexpr int E = Vec<T>::E;
  constexpr int R = kAcc / E;  // output items a thread can own
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout ly = layout(D, sizeof(T), gsz, tile);
  unsigned char* kv = smem;
  float* q_s = reinterpret_cast<float*>(smem + ly.q);  // [gsz, Dp]
  float* s_s = reinterpret_cast<float*>(smem + ly.s);  // [gsz, tile]
  float* m_s = reinterpret_cast<float*>(smem + ly.m);
  float* l_s = reinterpret_cast<float*>(smem + ly.l);
  float* c_s = reinterpret_cast<float*>(smem + ly.c);
  int* rows_s = reinterpret_cast<int*>(smem + ly.rows);  // [tile]
  uint8_t* mask_s = smem + ly.mask;                      // [tile]

  PHASE(0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // spans fastest (a cluster's blocks are consecutive), then slices, then
  // (row, kv head)
  const int split = blockIdx.x % nsplit;
  const int gs = (blockIdx.x / nsplit) % gslices;
  const int bh = blockIdx.x / nsplit / gslices;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int G = Hq / Hkv;
  const int g0 = gs * gsz, gn = min(gsz, G - g0);
  const int lo = split * span, hi = min(Tn, lo + span);
  const int nchunk = ly.nchunk, rowb = ly.rowb, Dp = nchunk * E;

  // K/V row r of the cache (dense: b * T + t; paged: a pool row) starts at
  // base + r * kstride
  const size_t kstride = (size_t)Hkv * D;
  const T* kbase = k + (size_t)h * D;
  const T* vbase = v + (size_t)h * D;
  auto load_tile = [&](int t0) {
    const int ntok = min(tile, hi - t0);
    if (vec) {
      const int n16 = ntok * nchunk;
      for (int x = tid; x < 2 * n16; x += kThreads) {
        const int which = x >= n16, y = x - which * n16;
        const int j = y / nchunk, c = y - j * nchunk;
        const T* src =
            (which ? vbase : kbase) + (size_t)rows_s[j] * kstride + c * E;
        cp_async16(kv + (which * tile + j) * rowb + c * 16, src);
      }
      cp_async_commit();
    } else {
      const int n = ntok * Dp;
      for (int x = tid; x < 2 * n; x += kThreads) {
        const int which = x >= n, y = x - which * n;
        const int j = y / Dp, d = y - j * Dp;
        const T* src = (which ? vbase : kbase) + (size_t)rows_s[j] * kstride;
        T* dst = reinterpret_cast<T*>(kv + (which * tile + j) * rowb);
        dst[d] = d < D ? src[d] : from_f<T>(0.f);
      }
    }
  };
  // thread tid probes the tile's position tid (tile <= kThreads): its cache
  // row and whether it is attended; the first tile's probe is read with q,
  // each later one's while the tile before it is scored
  const uint8_t* vrow = kPaged ? nullptr : cache.valid + (size_t)b * Tn;
  const int* ptrow = kPaged ? cache.pt + (size_t)b * cache.NP : nullptr;
  const int last = kPaged ? cache.pos[b] : 0;  // inclusive
  struct Probe {
    int row;
    uint8_t ok;
  };
  auto probe = [&](int t0) -> Probe {
    Probe p{0, 0};
    if (t0 < hi && tid < min(tile, hi - t0)) {
      const int t = t0 + tid;
      if constexpr (kPaged) {
        const int pg = ptrow[t / cache.page];
        assert(pg < cache.P);  // a page id past the pool: a corrupt table
        p.row = max(pg, 0) * cache.page + t % cache.page;
        p.ok = t <= last && pg >= 0;
      } else {
        p.row = b * Tn + t;
        p.ok = vrow[t];
      }
    }
    return p;
  };
  auto stage = [&](const Probe& p) {
    if (tid < tile) {
      rows_s[tid] = p.row;
      mask_s[tid] = p.ok;
    }
  };
  Probe mine = probe(lo);
  // whether a tile is read (block-uniform): when it holds an attended
  // position, or when its row holds none at all (the mean of V); a tile
  // with none in a row with one elsewhere adds exp(-1e30 - m) = 0 wherever
  // it would be merged, so its K/V are not read. The row is scanned once,
  // and only if a tile of the span is empty.
  int row_any = -1;
  auto tile_live = [&](uint8_t ok) -> bool {
    if (__syncthreads_or(ok)) return true;
    if (row_any < 0) {
      int any = 0;
      if constexpr (kPaged) {
        for (int pi = tid; pi < cache.NP && pi * cache.page <= last;
             pi += kThreads)
          any |= ptrow[pi] >= 0;
      } else {
        for (int t = tid; t < Tn; t += kThreads) any |= vrow[t];
      }
      row_any = __syncthreads_or(any);
    }
    return !row_any;
  };

  // q as f32, its loads in flight together
  const size_t qbase = ((size_t)b * Hq + (size_t)h * G + g0) * D;
  constexpr int kQ = 8;
  for (int x0 = tid; x0 < gn * Dp; x0 += kQ * kThreads) {
    float qv[kQ];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const int x = x0 + u * kThreads, g = x / Dp, d = x - g * Dp;
      qv[u] = (x < gn * Dp && d < D) ? to_f(q[qbase + (size_t)g * D + d])
                                     : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kQ; ++u)
      if (x0 + u * kThreads < gn * Dp) q_s[x0 + u * kThreads] = qv[u];
  }
  if (tid < gn) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  stage(mine);
  bool live = tile_live(mine.ok);  // also the barrier after q and the state
  PHASE(1);
  if (live) load_tile(lo);  // every copy of the tile in flight at once

  // P.V outputs: `items` (head, chunk) pairs; with fewer items than threads
  // each item's positions are shared by `jparts` threads
  const int items = gn * nchunk;
  const int jparts = items >= kThreads ? 1 : kThreads / items;
  float acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  int sl = 1;  // lanes that share one score
  while (sl < 8 && gn * tile * sl < kThreads) sl <<= 1;

  for (int t0 = lo; t0 < hi; t0 += tile) {
    const int ntok = min(tile, hi - t0);
    const Probe next = probe(t0 + tile);
    if (live) {
      if (vec) cp_async_wait_all();
      __syncthreads();  // the tile is in place
      PHASE(2 + 4 * min(5, (t0 - lo) / tile));  // 2-25: four a tile

      // scores; every thread runs the same rounds, so the shuffles always see
      // full warps
      const int nscore = gn * ntok * sl;
      for (int base = 0; base < nscore; base += kThreads) {
        const int x = base + tid;
        const int part_ = x & (sl - 1), sid = x / sl;
        const int g = sid / ntok, j = sid - g * ntok;
        float s = 0.f;
        if (x < nscore) {
          const unsigned char* kr = kv + j * rowb;
          const float* qr = q_s + g * Dp;
          for (int c = part_; c < nchunk; c += sl) {
            float kf[E];
            Vec<T>::load(kr + c * 16, kf);
#pragma unroll
            for (int e = 0; e < E; ++e) s += qr[c * E + e] * kf[e];
          }
        }
        for (int o = sl / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (x < nscore && part_ == 0)
          s_s[g * tile + j] = mask_s[j] ? s * scale : kMasked;
      }
      __syncthreads();

      PHASE(3 + 4 * min(5, (t0 - lo) / tile));
      // online softmax, one warp per query head
      for (int g = warp; g < gn; g += kWarps) {
        float* sr = s_s + g * tile;
        float mt = -INFINITY;
        for (int j = lane; j < ntok; j += 32) mt = fmaxf(mt, sr[j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mt);
        float sum = 0.f;
        for (int j = lane; j < ntok; j += 32) {
          const float e = expf(sr[j] - m_new);
          sr[j] = e;
          sum += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
          c_s[g] = corr;
        }
      }
      __syncthreads();

      PHASE(4 + 4 * min(5, (t0 - lo) / tile));
      // acc = acc * corr + P . V
      const unsigned char* vb = kv + tile * rowb;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int x = tid + r * kThreads;
        if (x < items * jparts) {
          const int item = x % items, jp = x / items;
          const int g = item / nchunk, c = item - g * nchunk;
          const float corr = c_s[g];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] *= corr;
          const float* pr = s_s + g * tile;
          for (int j = jp; j < ntok; j += jparts) {
            float vf[E];
            Vec<T>::load(vb + j * rowb + c * 16, vf);
            const float p = pr[j];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][e] += p * vf[e];
          }
        }
      }
    }
    PHASE(5 + 4 * min(5, (t0 - lo) / tile));
    if (t0 + tile < hi) {  // a longer span: the next tile into the same bytes
      __syncthreads();
      stage(next);
      live = tile_live(next.ok);
      if (live) load_tile(t0 + tile);
    }
  }
  __syncthreads();  // the tile's bytes are free
  PHASE(26);

  if (jparts > 1) {  // add the position shares of each item (R = 1 here)
    float* red = reinterpret_cast<float*>(kv);
    if (tid < items * jparts)
#pragma unroll
      for (int e = 0; e < E; ++e) red[tid * E + e] = acc[0][e];
    __syncthreads();
    if (tid < items)
      for (int p = 1; p < jparts; ++p)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[0][e] += red[(tid + p * items) * E + e];
  }

  // this span's partial in the tile's bytes: [gsz] m, [gsz] l, [gsz, D] acc
  float* pm = reinterpret_cast<float*>(kv);
  if (jparts > 1 && nsplit > 1) __syncthreads();  // the shares are read
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int x = tid + r * kThreads;
    if (x < items) {
      const int g = x / nchunk, c = x - g * nchunk;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = c * E + e;
        if (d < D) {
          if (nsplit == 1)
            out[qbase + (size_t)g * D + d] =
                from_f<T>(acc[r][e] / fmaxf(l_s[g], 1e-30f));
          else
            pm[2 * gsz + g * D + d] = acc[r][e];
        }
      }
    }
  }
  if (nsplit == 1) return;
  if (tid < gn) {
    pm[tid] = m_s[tid];
    pm[gsz + tid] = l_s[tid];
  }

  // each block of the cluster merges a slice of the outputs
  PHASE(27);
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  PHASE(28);
  float* w_s = reinterpret_cast<float*>(smem + ly.w);  // [gsz, kMaxSplit]
  float* lsum_s = reinterpret_cast<float*>(smem + ly.lsum);
  if (tid < gn) {
    float M = -INFINITY;
    for (int i = 0; i < nsplit; ++i)
      M = fmaxf(M, cl.map_shared_rank(pm, i)[tid]);
    float L = 0.f;
    for (int i = 0; i < nsplit; ++i) {
      const float* pi = cl.map_shared_rank(pm, i);
      const float w = expf(pi[tid] - M);
      w_s[tid * kMaxSplit + i] = w;
      L += pi[gsz + tid] * w;
    }
    lsum_s[tid] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int per = (gn * D + nsplit - 1) / nsplit;
  for (int x = split * per + tid; x < min(gn * D, (split + 1) * per);
       x += kThreads) {
    const int g = x / D;
    float o = 0.f;
    for (int i = 0; i < nsplit; ++i)
      o += w_s[g * kMaxSplit + i] * cl.map_shared_rank(pm, i)[2 * gsz + x];
    out[qbase + x] = from_f<T>(o / lsum_s[g]);
  }
  PHASE(29);
  cl.sync();  // keep this block's partial alive until all have read it
}

// two kernels (not one template) so that a profile tells them apart by name
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_decode(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const Cache cache,
                 T* __restrict__ out, int Hq, int Hkv, int D, int Tn,
                 float scale, int gslices, int gsz, int nsplit, int span,
                 int tile, int vec) {
  decode_block<T, false>(q, k, v, cache, out, Hq, Hkv, D, Tn, scale, gslices,
                         gsz, nsplit, span, tile, vec);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const Cache cache,
                 T* __restrict__ out, int Hq, int Hkv, int D, int Tn,
                 float scale, int gslices, int gsz, int nsplit, int span,
                 int tile, int vec) {
  decode_block<T, true>(q, k, v, cache, out, Hq, Hkv, D, Tn, scale, gslices,
                        gsz, nsplit, span, tile, vec);
}

template <typename T, bool kPaged>
int launch(const void* q, const void* k, const void* v, const Cache& cache,
           void* out, int B, int Hq, int Hkv, int D, int Tn, float scale,
           int gslices, int gsz, int nsplit, int span, int tile, int vec,
           cudaStream_t s) {
  auto kernel = kPaged ? paged_decode<T> : dense_decode<T>;
  const size_t smem = layout(D, sizeof(T), gsz, tile).total;
  static size_t opted = 48 * 1024;  // per kernel: the most asked for so far
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const long long blocks = (long long)B * Hkv * gslices * nsplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;  // the spans of a (row, kv head, slice)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache, static_cast<T*>(out), Hq, Hkv, D, Tn,
      scale, gslices, gsz, nsplit, span, tile, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the split shared by both entry points: the group G = Hq / Hkv in
// `gslices` slices of at most `gsz` <= 16 heads, T in `nsplit` <= 8 spans
// of `span` positions (the last one shorter), each staged `tile` <= 128
// positions at a time
bool plan_ok(int B, int Hq, int Hkv, int D, int Tn, int gslices, int gsz,
             int nsplit, int span, int tile) {
  return !(B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxD ||
           Tn <= 0 || gsz <= 0 || gsz > kGroupMax || gslices <= 0 ||
           (long long)gslices * gsz < Hq / Hkv ||
           (long long)(gslices - 1) * gsz >= Hq / Hkv || nsplit <= 0 ||
           nsplit > kMaxSplit || span <= 0 || (long long)nsplit * span < Tn ||
           (long long)(nsplit - 1) * span >= Tn || tile <= 0 ||
           tile > kMaxTile);
}

template <bool kPaged>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const Cache& cache, void* out, int B, int Hq, int Hkv, int D,
             int Tn, float scale, int gslices, int gsz, int nsplit, int span,
             int tile, int vec, void* stream) {
  if (!plan_ok(B, Hq, Hkv, D, Tn, gslices, gsz, nsplit, span, tile))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec && (D * 4) % 16) return (int)cudaErrorInvalidValue;
    return launch<float, kPaged>(q, k, v, cache, out, B, Hq, Hkv, D, Tn,
                                 scale, gslices, gsz, nsplit, span, tile, vec,
                                 s);
  }
  if (dtype == 1) {
    if (vec && (D * 2) % 16) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16, kPaged>(q, k, v, cache, out, B, Hq, Hkv, D,
                                         Tn, scale, gslices, gsz, nsplit,
                                         span, tile, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); valid holds
// one byte per (row, position). The plan (gslices, gsz, nsplit, span,
// tile) is the wrapper's, checked by plan_ok. `vec` = 1 when every K/V row
// starts 16-byte aligned. Launches on `stream`, returns the launch's
// cudaError_t (0 on success), never synchronises.
extern "C" int decode_attn(int dtype, const void* q, const void* k,
                           const void* v, const void* valid, void* out, int B,
                           int Hq, int Hkv, int D, int Tn, float scale,
                           int gslices, int gsz, int nsplit, int span,
                           int tile, int vec, void* stream) {
  Cache cache = {};
  cache.valid = static_cast<const uint8_t*>(valid);
  if ((long long)B * Tn > INT32_MAX) return (int)cudaErrorInvalidValue;
  return dispatch<false>(dtype, q, k, v, cache, out, B, Hq, Hkv, D, Tn, scale,
                         gslices, gsz, nsplit, span, tile, vec, stream);
}

// The paged pool: kp/vp [P, page, Hkv, D], pt [B, NP] i32 (-1 =
// unallocated), pos [B] i32; the plan is made for T = NP * page positions,
// as for a dense cache of that length.
extern "C" int paged_decode_attn(int dtype, const void* q, const void* kp,
                                 const void* vp, const int* pt, const int* pos,
                                 void* out, int B, int Hq, int Hkv, int D,
                                 int page, int NP, int P, float scale,
                                 int gslices, int gsz, int nsplit, int span,
                                 int tile, int vec, void* stream) {
  if (page <= 0 || NP <= 0 || P <= 0 || (long long)NP * page > INT32_MAX ||
      (long long)P * page > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  Cache cache = {};
  cache.pt = pt;
  cache.pos = pos;
  cache.page = page;
  cache.NP = NP;
  cache.P = P;
  return dispatch<true>(dtype, q, kp, vp, cache, out, B, Hq, Hkv, D,
                        NP * page, scale, gslices, gsz, nsplit, span, tile,
                        vec, stream);
}
