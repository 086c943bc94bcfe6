// Top-k + logsumexp summary of logits rows, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_lse.py::topk_lse
// (_topk_lse_kernel): logits [T, V] f32 or bf16 (read in their own dtype;
// bf16 -> f32 is exact) -> top-k values [T, k] f32 (descending, ties to the
// lowest vocab index, -0.0 tied with +0.0, as the Pallas kernel orders
// them), their vocab indices [T, k] i32 and the exact logsumexp [T] f32,
// for any k in (0, V].
//
// Bound on the H100: memory. The logits are read once (T * V * 2 bytes in
// bf16, 2.1 MB at T = 8, V = 128256; 4.1 MB in f32) and the outputs are
// tiny, so the floor is 0.6-1.2 us at 3.35 TB/s; the arithmetic (one exp
// per logit) is far below the card's rate.
//
// Design: the TPU kernel walks the vocab axis in order on one core and
// merges a running top-k by k rounds of argmax in VMEM scratch. Here a
// row's vocab is cut into C <= 8 contiguous chunks, one block each, and the
// C blocks of a row run as one thread-block cluster, so a call is one
// launch and the row's blocks meet through distributed shared memory. A
// call is short, so what costs time is the chain of barriers and round
// trips inside a block (each cluster-wide step, a barrier with its reads of
// the other blocks, costs a few microseconds: tools/kernel_phases.py), not
// the bytes; the design keeps the cluster-wide steps to one:
//   1. each block reads its chunk once (16-byte loads when rows are
//      16-byte aligned), keeps a running (max, sumexp) per thread for the
//      lse and maps each logit to an order-preserving 32-bit key (the float's
//      bits, flipped so that unsigned order is value order; -0.0 becomes
//      +0.0 first, as the Pallas kernel treats them as equal) kept in shared
//      memory (a chunk past KEY_CACHE_MAX keys reads the rest again);
//   2. a lower bound on the row's k-th largest key K*, per block: where k
//      is at most the block's threads that own logits, the k-th largest of
//      their largest keys (the k-th largest of a subset of the row is at
//      most the row's), found by a radix select within the block: one pass
//      per 8-bit digit from the top (4 for f32 keys, 2 for bf16, whose low
//      16 bits follow the sign), each a shared-memory histogram (a warp's
//      lanes that hit one bin add once, by __match_any_sync: logits share
//      their top bits) and a scan that picks the digit holding the k-th key;
//   3. every key at or above the block's bound is a candidate: (key << 32
//      | ~index) goes to the block's own region of the first block's shared
//      memory, in index order (the rest of the region zeroed), with the
//      block's (max, sumexp) and candidate count; after the one cluster
//      barrier the first block finds the exact K* among the candidates by
//      the same select, keeps every candidate above it and the
//      lowest-index ones equal to it, k in all, sorts them by a bitonic
//      sort (descending: value descending, index ascending, as the
//      composite is unique; in registers by one warp up to 64) and writes
//      them and the lse. About 70 candidates a block at the serving shape
//      (T = 8, V = 128256, k = 64);
//   4. where a block's candidates overflow its region (a k past the
//      block's threads, or many ties), the same select runs over the
//      cluster instead (histograms summed through distributed shared memory
//      after a barrier a pass) among the keys at or above each block's
//      bound; the survivors (a scan of per-thread counts over contiguous
//      ranges, then the lower blocks' counts) go to the first block's
//      shared memory (k <= SORT_SMEM_MAX) or to global scratch that the
//      wrapper allocates, and are sorted there. Any k in (0, V] is exact.

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

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // Hopper's portable cluster size
constexpr int kBins = 256;      // 8-bit digits
constexpr int kUnroll = 4;      // 16-byte loads in flight per thread

typedef unsigned long long u64;

// order-preserving key of a float: unsigned order = value order
__device__ __forceinline__ uint32_t to_key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;  // -0.0 ties +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a 16-byte load as floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// (max, sum of exp(x - max)) of two parts
__device__ __forceinline__ void merge(float& m, float& s, float om, float os) {
  const float M = fmaxf(m, om);
  if (M == -INFINITY) return;  // both empty or all -inf
  if (isinf(M)) {              // a +inf logit: the lse is +inf
    m = M;
    s = 1.f;
    return;
  }
  s = s * expf(m - M) + os * expf(om - M);
  m = M;
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// dynamic shared memory: keys [keycap] u32, the candidate and survivor
// buffer [2 * cap] u64 (the first block's is used), histograms [2][kBins]
struct Layout {
  size_t keys, sort, hist, total;
};
__host__ __device__ inline Layout layout(int keycap, int cap) {
  Layout y;
  y.keys = 0;
  y.sort = align16(sizeof(uint32_t) * (size_t)keycap);
  y.hist = y.sort + align16(sizeof(u64) * 2 * (size_t)cap);
  y.total = y.hist + sizeof(int) * 2 * kBins;
  return y;
}

// in-place bitonic sort of a[0, n), n a power of two, largest first
__device__ void bitonic_desc(u64* a, int n) {
  const int tid = threadIdx.x;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const u64 x = a[lo], y = a[hi];
        if ((x < y) == desc) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// the same for n <= 64, by one warp in registers: lane l holds elements l
// and l + 32, pairs meet by shuffles (or in one lane at stride 32); each
// lane writes its elements below k
__device__ void warp_bitonic_desc(const u64* a, int n, int k, float* vals,
                                  int* idx) {
  const int lane = threadIdx.x & 31;
  u64 r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) r[h] = lane + 32 * h < n ? a[lane + 32 * h] : 0;
  for (int size = 2; size <= 64; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // size 64: the pair is (l, l + 32), descending
        const u64 x = r[0], y = r[1];
        r[0] = x > y ? x : y;
        r[1] = x > y ? y : x;
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = lane + 32 * h;
        const u64 other = __shfl_xor_sync(0xffffffffu, r[h], stride);
        const bool desc = (e & size) == 0, low = (e & stride) == 0;
        const u64 hi = r[h] > other ? r[h] : other;
        const u64 lo = r[h] > other ? other : r[h];
        r[h] = low == desc ? hi : lo;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = lane + 32 * h;
    if (e < k) {
      vals[e] = from_key((uint32_t)(r[h] >> 32));
      idx[e] = (int)~(uint32_t)(r[h] & 0xffffffffull);
    }
  }
}

// a[0, n) (n a power of two >= k, padded with 0) sorted, largest first;
// the first k written as values and indices (the whole block calls it)
__device__ void sort_and_write(u64* a, int n, int k, float* vals, int* idx) {
  if (n <= 64) {
    if (threadIdx.x < 32) warp_bitonic_desc(a, n, k, vals, idx);
    return;
  }
  bitonic_desc(a, n);
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const u64 c = a[i];
    vals[i] = from_key((uint32_t)(c >> 32));
    idx[i] = (int)~(uint32_t)(c & 0xffffffffull);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_lse_kernel(const T* __restrict__ logits, int V, int k, int chunk,
                    int keycap, int cap, int nsort, u64* __restrict__ scratch,
                    int vec, float* __restrict__ vals, int* __restrict__ idx,
                    float* __restrict__ lse) {
  constexpr int E = Vec<T>::E;
  // bf16 keys carry 16 bits: the low 16 follow the sign bit
  constexpr int npass = sizeof(T) == 2 ? 2 : 4;
  PHASE(0);
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int row_i = blockIdx.x / C;
  const int v0 = rank * chunk, n = min(chunk, V - v0);
  const T* row = logits + (size_t)row_i * V + v0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout ly = layout(keycap, cap);
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + ly.keys);
  u64* sbuf = reinterpret_cast<u64*>(smem + ly.sort);  // [2 * cap]
  int* hist = reinterpret_cast<int*>(smem + ly.hist);  // [2][kBins]
  __shared__ float red_m[kWarps], red_s[kWarps];
  __shared__ float row_ms[2 * kMaxCluster];  // first block: blocks' (m, s)
  __shared__ int cand_n[kMaxCluster];        // every block's candidates
  __shared__ int scan_w[kWarps], cnt_w[2][kWarps];
  __shared__ int sel[2];      // chosen digit, keys above its bin
  __shared__ int blk_cnt[2];  // keys above K*, keys equal to it

  // a block may touch another's shared memory only once every block of the
  // cluster runs: each thread arrives at a cluster barrier here and waits
  // on it just before its first such access, long after
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  auto get_key = [&](int i) -> uint32_t {
    return i < keycap ? keys[i] : to_key(to_f(row[i]));
  };

  // 1. one read: keys, each thread's largest key, running (max, sumexp)
  // (sum of 2^((x - max) log2 e): ex2 with the scaled argument, whose
  // rounding is a few f32 units relative on each term)
  constexpr float kLog2e = 1.4426950408889634f;
  float m = -INFINITY, s = 0.f;
  uint32_t kmax = 0;
  auto fold = [&](const float* x, int cnt) {
    float vm = -INFINITY;
    for (int e = 0; e < cnt; ++e) vm = fmaxf(vm, x[e]);
    if (vm > m) {
      s = isinf(vm) ? 0.f : s * exp2f((m - vm) * kLog2e);
      m = vm;
    }
    if (isfinite(m))
      for (int e = 0; e < cnt; ++e) s += exp2f((x[e] - m) * kLog2e);
  };
  if (vec) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    const int nv = n / E;  // n is a multiple of E here
    for (int base = tid; base < nv; base += kThreads * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int vi = base + u * kThreads;
        if (vi < nv) raw[u] = __ldg(row4 + vi);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int vi = base + u * kThreads;
        if (vi < nv) {
          float x[E];
          Vec<T>::unpack(raw[u], x);
          fold(x, E);
          uint32_t kk[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            kk[e] = to_key(x[e]);
            kmax = max(kmax, kk[e]);
          }
          if (vi * E < keycap) {  // keycap is a multiple of 8
            uint4* dst = reinterpret_cast<uint4*>(keys + vi * E);
#pragma unroll
            for (int w = 0; w < E / 4; ++w)
              dst[w] = make_uint4(kk[4 * w], kk[4 * w + 1], kk[4 * w + 2],
                                  kk[4 * w + 3]);
          }
        }
      }
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      const float x = to_f(row[i]);
      fold(&x, 1);
      const uint32_t kk = to_key(x);
      kmax = max(kmax, kk);
      if (i < keycap) keys[i] = kk;
    }
  }
  PHASE(1);
  // the block's (max, sumexp), for the first block to merge
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, om, os);
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();  // also: every key is in shared memory
  PHASE(2);
  float bm = -INFINITY, bs = 0.f;
  if (tid == 0)
    for (int w = 0; w < kWarps; ++w) merge(bm, bs, red_m[w], red_s[w]);

  // 2. radix select: the k-th largest of the keys that `each` hands over
  // (those >= lo), over the cluster, or over this block alone when `local`.
  // Histograms alternate between two buffers, so one barrier a pass
  // suffices: a buffer is zeroed two passes after its last remote read,
  // with a barrier between.
  int pass_no = 0;
  // one add per distinct digit among a warp's lanes (a warp calls it
  // together): logits share their top bits, and lanes that add to one bin
  // of shared memory at once are served one at a time
  auto hist_add = [&](int* h, bool hit, uint32_t digit) {
    if (__any_sync(0xffffffffu, hit)) {
      const unsigned peers = __match_any_sync(0xffffffffu,
                                              hit ? digit : 0xffffffffu);
      if (hit && lane == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
    }
  };
  auto radix_select = [&](auto each, uint32_t lo, int kk, bool local,
                          uint32_t& prefix, uint32_t& pmask, int& krem) {
    const int nblk = local ? 1 : C;
    prefix = 0u;
    pmask = 0u;
    krem = kk;
    for (int p = 0; p < npass; ++p, ++pass_no) {
      const int shift = 24 - 8 * p;
      int* h = hist + (pass_no & 1) * kBins;
      for (int i = tid; i < kBins; i += kThreads) h[i] = 0;
      __syncthreads();
      const uint32_t pf = prefix, pm = pmask;
      each([&](bool in, uint32_t key) {
        hist_add(h, in && key >= lo && (key & pm) == pf,
                 (key >> shift) & 0xffu);
      });
      if (local)
        __syncthreads();
      else
        cl.sync();
      // thread tid < 256 holds digit 255 - tid: an inclusive scan gives the
      // count of keys at or above each digit; one thread holds the k-th
      const int d = kBins - 1 - tid;
      int c = 0, x = 0;
      if (warp < kBins / 32) {
        int part[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          part[r] = r < nblk ? (local ? h : cl.map_shared_rank(h, r))[d] : 0;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) c += part[r];
        x = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        if (lane == 31) scan_w[warp] = x;
      }
      __syncthreads();
      if (warp < kBins / 32) {
        for (int w = 0; w < warp; ++w) x += scan_w[w];
        if (x - c < krem && x >= krem) {
          sel[0] = d;
          sel[1] = x - c;
        }
      }
      __syncthreads();
      prefix |= (uint32_t)sel[0] << shift;
      pmask |= 0xffu << shift;
      krem -= sel[1];
      PHASE(5 + pass_no);  // 5-12: each pass
    }
  };

  // a lower bound on K*: the k-th largest key of a subset of the row is at
  // most the row's, so where at least k of this block's threads own logits,
  // the k-th largest of their largest keys bounds K* for this block's keys
  // (a select within the block: no cluster barrier); each block filters
  // its own keys by its own bound, and every key >= K* passes
  uint32_t lower = 0u, prefix, pmask;
  int krem;
  const int owners = min(kThreads, vec ? n / E : n);
  if (k <= owners) {
    radix_select([&](auto f) { f(tid < owners, kmax); }, 0u, k, true, prefix,
                 pmask, krem);
    lower = prefix;  // for bf16 the low 16 bits are 0: still a lower bound
  }
  PHASE(3);

  // per-thread counts over contiguous ranges of the block's keys (odd
  // length: distinct banks), scanned over the block -> each thread's first
  // slot and the block's totals
  int len = (n + kThreads - 1) / kThreads;
  len |= 1;
  const int i0 = min(n, tid * len), i1 = min(n, i0 + len);
  auto scan2 = [&](int& a, int& b, int& ta, int& tb) {
    int xa = a, xb = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(0xffffffffu, xa, o);
      const int yb = __shfl_up_sync(0xffffffffu, xb, o);
      if (lane >= o) {
        xa += ya;
        xb += yb;
      }
    }
    if (lane == 31) {
      cnt_w[0][warp] = xa;
      cnt_w[1][warp] = xb;
    }
    __syncthreads();
    a = xa - a;  // exclusive
    b = xb - b;
    ta = tb = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) {
        a += cnt_w[0][w];
        b += cnt_w[1][w];
      }
      ta += cnt_w[0][w];
      tb += cnt_w[1][w];
    }
    __syncthreads();  // cnt_w is free again
  };

  // 3. candidates: every key at or above the block's bound, as (key << 32 |
  // ~index), into block r's region [r * R, (r + 1) * R) of the first
  // block's buffer in index order, the rest of the region zeroed (a real
  // key is above 0); with the blocks' (max, sumexp) and candidate counts,
  // pushed too, the first block needs nothing of the others after one
  // cluster barrier
  const int R = cap / C;
  int c_at = 0, none = 0, c_tot, none_tot;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) c_at += get_key(i) >= lower;
  scan2(c_at, none, c_tot, none_tot);
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  u64* cbuf = cl.map_shared_rank(sbuf, 0);
  if (tid == 0) {
    float* ms0 = cl.map_shared_rank(row_ms, 0);
    ms0[2 * rank] = bm;
    ms0[2 * rank + 1] = bs;
  }
  if (tid < C) cl.map_shared_rank(cand_n, tid)[rank] = c_tot;
  if (c_tot <= R) {
    u64* region = cbuf + rank * R;
    for (int i = i0; i < i1; ++i) {
      const uint32_t key = get_key(i);
      if (key >= lower)
        region[c_at++] = ((u64)key << 32) | (u64)(~(uint32_t)(v0 + i));
    }
    for (int j = c_tot + tid; j < R; j += kThreads) region[j] = 0ull;
  }
  cl.sync();
  PHASE(4);
  bool fits = true;
  for (int r = 0; r < C; ++r) fits &= cand_n[r] <= R;
  if (rank == 0 && tid == 0) {
    float M = -INFINITY, S = 0.f;
    for (int r = 0; r < C; ++r) merge(M, S, row_ms[2 * r], row_ms[2 * r + 1]);
    lse[row_i] = isfinite(M) ? M + logf(S) : M;
  }
  if (fits) {  // the first block selects among the C * R candidates
    if (rank != 0) return;
    const int nc = C * R;
    radix_select([&](auto f) {  // warp-uniform
      for (int base = warp * 32; base < nc; base += kThreads) {
        const int j = base + lane;
        f(j < nc, j < nc ? (uint32_t)(sbuf[j] >> 32) : 0u);
      }
    }, 1u, k, true, prefix, pmask, krem);
    const uint32_t kstar = prefix, kmask = pmask;
    const int ties = krem, above = k - ties;
    int clen = (nc + kThreads - 1) / kThreads;
    clen |= 1;
    const int j0 = min(nc, tid * clen), j1 = min(nc, j0 + clen);
    int gt_at = 0, eq_at = 0, tg, te;
    for (int j = j0; j < j1; ++j) {
      const uint32_t kk = (uint32_t)(sbuf[j] >> 32) & kmask;
      gt_at += kk > kstar;
      eq_at += kk == kstar;
    }
    scan2(gt_at, eq_at, tg, te);
    u64* out = sbuf + cap;  // the survivors, in the buffer's second half
    for (int j = j0; j < j1; ++j) {
      const u64 c = sbuf[j];
      const uint32_t kk = (uint32_t)(c >> 32) & kmask;
      if (kk > kstar) {
        out[gt_at++] = c;
      } else if (kk == kstar) {
        if (eq_at < ties) out[above + eq_at] = c;
        ++eq_at;
      }
    }
    for (int j = k + tid; j < nsort; j += kThreads) out[j] = 0ull;
    __syncthreads();
    sort_and_write(out, nsort, k, vals + (size_t)row_i * k,
                   idx + (size_t)row_i * k);
    PHASE(15);
    return;
  }

  // 4. too many candidates (a large k, or ties): the exact k-th largest K*
  // by a select over the cluster among the keys at or above each block's
  // bound, then every key above K* and the lowest-index keys equal to it
  radix_select([&](auto f) {  // warp-uniform, four keys in flight
    for (int base = warp * 32; base < n; base += 4 * kThreads) {
      uint32_t kk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kThreads + lane;
        kk[u] = i < n ? get_key(i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) f(base + u * kThreads + lane < n, kk[u]);
    }
  }, lower, k, false, prefix, pmask, krem);
  const uint32_t kstar = prefix, kmask = pmask;
  const int ties = krem, above = k - ties;  // keys == K* taken, keys > K*
  int gt_at = 0, eq_at = 0, tg, te;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const uint32_t kk = get_key(i) & kmask;
    gt_at += kk > kstar;
    eq_at += kk == kstar;
  }
  scan2(gt_at, eq_at, tg, te);
  if (tid == 0) {
    blk_cnt[0] = tg;
    blk_cnt[1] = te;
  }
  cl.sync();
  PHASE(13);
  {
    int below[2][kMaxCluster];  // the lower blocks' counts, read together
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const int* rc = cl.map_shared_rank(blk_cnt, r < rank ? r : rank);
      below[0][r] = r < rank ? rc[0] : 0;
      below[1][r] = r < rank ? rc[1] : 0;
    }
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      gt_at += below[0][r];
      eq_at += below[1][r];
    }
  }
  const bool in_smem = nsort <= cap;
  u64* buf = in_smem ? cbuf : scratch + (size_t)row_i * nsort;
  for (int i = i0; i < i1; ++i) {
    const uint32_t key = get_key(i), kk = key & kmask;
    const u64 comp = ((u64)key << 32) | (u64)(~(uint32_t)(v0 + i));
    if (kk > kstar) {
      buf[gt_at++] = comp;
    } else if (kk == kstar) {
      if (eq_at < ties) buf[above + eq_at] = comp;
      ++eq_at;
    }
  }
  if (rank == 0)  // padding sorts last: every real composite is above 0
    for (int i = k + tid; i < nsort; i += kThreads) buf[i] = 0ull;
  if (!in_smem) __threadfence();
  cl.sync();
  PHASE(14);
  if (rank != 0) return;

  // order the k survivors and write them
  if (!in_smem) __threadfence();
  sort_and_write(in_smem ? sbuf : buf, nsort, k, vals + (size_t)row_i * k,
                 idx + (size_t)row_i * k);
  PHASE(15);
}

template <typename T>
int launch(const void* logits, int T_, int V, int k, int C, int chunk,
           int keycap, int cap, int nsort, u64* scratch, int vec, float* vals,
           int* idx, float* lse, cudaStream_t s) {
  const size_t smem = layout(keycap, cap).total;
  static size_t opted = 48 * 1024;  // per T: the most asked for so far
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_lse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)T_ * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;  // the blocks of one row
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, topk_lse_kernel<T>, static_cast<const T*>(logits), V, k, chunk,
      keycap, cap, nsort, scratch, vec, vals, idx, lse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 logits [T, V], contiguous. The row is
// cut into C <= 8 chunks of `chunk` entries (the last one shorter), one
// block each; a block keeps its first `keycap` keys (a multiple of 8) in
// shared memory. The first block's buffer holds `cap` (a power of two)
// candidates or survivors; past that, the k survivors are sorted in
// `scratch` [T, nsort] u64, nsort a power of two >= k (unused when nsort
// <= cap). `vec` = 1 when every row and chunk starts 16-byte aligned.
// Launches on `stream`, returns the launch's cudaError_t (0 on success),
// never synchronises.
extern "C" int topk_lse(int dtype, const void* logits, int T, int V, int k,
                        int C, int chunk, int keycap, int cap, int nsort,
                        void* scratch, int vec, float* vals, int* idx,
                        float* lse, void* stream) {
  const int E = dtype == 0 ? 4 : 8;
  if (T <= 0 || V <= 0 || k <= 0 || k > V || C <= 0 || C > kMaxCluster ||
      chunk <= 0 || (long long)C * chunk < V ||
      (long long)(C - 1) * chunk >= V || keycap < 0 || keycap % 8 ||
      cap < 2 || (cap & (cap - 1)) || nsort < k || (nsort & (nsort - 1)) ||
      (nsort > cap && !scratch) || (long long)T * C > INT32_MAX ||
      (dtype != 0 && dtype != 1) || (vec && (chunk % E || V % E)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* scr = static_cast<u64*>(scratch);
  if (dtype == 0)
    return launch<float>(logits, T, V, k, C, chunk, keycap, cap, nsort, scr,
                         vec, vals, idx, lse, s);
  return launch<__nv_bfloat16>(logits, T, V, k, C, chunk, keycap, cap, nsort,
                               scr, vec, vals, idx, lse, s);
}
