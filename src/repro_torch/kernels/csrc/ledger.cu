// Fused recycle-ledger transaction (record + priority), hand-written for
// Hopper (sm_90a): one launch, each block owning one tile of the table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ledger.py::
// ledger_record_priority (_ledger_kernel, the "fori" variant, and
// _ledger_block_kernel, the "block" variant). One transaction on the table
// (ema f32, count i32, last_seen i32, owner i32; [capacity] each, capacity a
// power of two) for a batch of B items (ids i32, losses f32, valid u8 or
// none, step: a device i32):
//   * each id hashes to slot = fib32(id) ^ (>> 16) & (capacity - 1), with
//     the multiply wrapping at 32 bits (src/repro/core/history.py:44-49);
//   * the new EMA / count come from the PRE-batch snapshot;
//   * only valid items write; per slot the last valid item in batch order
//     wins;
//   * every item, masked or not, is then scored against the UPDATED table:
//     ema * exp2(age / half_life) if the slot's owner is its id, else
//     unseen_priority (so an id evicted within the batch reads as unseen);
//     age / inf = 0 gives a boost of exactly 1.
// The four output arrays are new tables (the functional contract of the
// JAX version); the inputs are left as they were.
//
// Bound on the H100: memory. The outputs are whole tables, so the least
// traffic is reading the four input arrays and writing the four outputs
// once, 32 bytes a slot (2 MB at capacity 65536, 0.63 us at 3.35 TB/s; 8 MB
// at 2^18, 2.5 us); the batch adds 13 bytes an item. At the train path's
// sizes one launch's latency is longer than that.
//
// Design: the Pallas "block" variant's decomposition, without its program
// order. The table is cut into `tiles` tiles of capacity / tiles slots (a
// power of two, chosen by kernels/ledger.py::tile_plan); block t owns tile
// t and everything that lands in it, and keeps the tile in shared memory:
//   0. it issues the tile's copy from the input arrays into shared memory
//      (16-byte cp.async, all in flight at once), reads the step and clears
//      its winner array;
//   1. walk: meanwhile it reads the batch's ids with their valid bytes (16
//      and 4 bytes a load, the next loads in flight while the last are
//      hashed) and keeps the items whose slot lies in its tile: a valid
//      item atomicMax-es its batch index into the tile's winner array in
//      shared memory (the maximum does not depend on the order the atomics
//      land in, so the last valid item in batch order wins,
//      deterministically), and every item's (index, id) goes to the tile's
//      item list in shared memory;
//   2. patch: each list entry reads its loss (all of a thread's in flight
//      at once); a winner writes the slot's new EMA, count, step and id
//      over the tile's snapshot in shared memory, computed from that
//      snapshot;
//   3. after __syncthreads the block writes the tile out (16-byte stores)
//      and scores its items against the tile in shared memory. An item's
//      slot lies in exactly one tile, so exactly one block writes its
//      priority.
// Every block walks the whole batch; no block reads what another writes:
// no grid-wide barrier, no global scratch, no global atomic. Each block
// starts its walk at its own place in the batch, so that blocks do not all
// ask the same L2 lines at once. Both of the JAX package's variant names
// ("fori", "block") take this launch.
// The walk's code stays small: a walk unrolled eight loads deep, with the
// list appends batched a warp at a time, was slower at small batches. When
// more of the batch lands in a tile than its list holds, phase 2 reads the
// winners from the winner array and phase 3 walks the batch again. The EMA
// is computed with explicit round-to-nearest multiplies and add so that no
// FMA contraction changes it against the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
constexpr int kDepth = 4;   // 16-byte id loads in flight a thread, twice
constexpr int kHeader = 4;  // ints: the item list's fill count, padding
constexpr unsigned kFib32 = 0x9E3779B9u;

struct Batch {
  const int* ids;
  const float* losses;
  const uint8_t* valid;  // nullptr = every item writes
  const int* step;       // device scalar
  int n;
};

struct Params {
  float decay, one_minus_decay, unseen, half_life;
  unsigned mask;  // capacity - 1
};

__device__ __forceinline__ unsigned slot_of(int id, unsigned mask) {
  unsigned h = static_cast<unsigned>(id) * kFib32;  // wraps at 32 bits
  return (h ^ (h >> 16)) & mask;
}

// A block's shared memory (ints): the header (the fill count at 0), the
// tile (ema as bits, count, last_seen, owner [slots] each), the item list
// [room] of (batch index, id), the winner array [slots] (batch index, -1 =
// none).
struct Tile {
  int* fill;
  int* tab;
  int2* items;
  int* win;
  unsigned base, slots;
  int room;
};

__device__ __forceinline__ Tile tile_of(int* smem, unsigned slots, int room) {
  Tile t;
  t.fill = smem;
  t.tab = smem + kHeader;
  t.items = reinterpret_cast<int2*>(t.tab + 4 * slots);
  t.win = reinterpret_cast<int*>(t.items + room);
  t.base = blockIdx.x * slots;
  t.slots = slots;
  t.room = room;
  return t;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Item i (slot `loc` of the tile) lands in the tile: a writer claims the
// slot, and the item joins the list.
__device__ __forceinline__ void claim(const Tile& t, int i, int id,
                                      unsigned loc, bool writes) {
  if (writes) atomicMax(t.win + loc, i);
  const int k = atomicAdd(t.fill, 1);
  if (k < t.room) t.items[k] = make_int2(i, id);
}

// Walk the whole batch, kDepth 16-byte id loads (and their valid bytes) in
// flight a thread while the previous kDepth are hashed, starting this
// block's share of the way round, so that blocks walking the same items do
// not all ask the same L2 lines at once; claim each item whose slot lies in
// the block's tile.
__device__ __forceinline__ void walk(const Tile& t, const Batch& b,
                                     const Params& p, int ids_vec) {
  const int tid = threadIdx.x;
  const int nv = ids_vec ? b.n / 4 : 0;
  const int4* ids4 = reinterpret_cast<const int4*>(b.ids);
  const unsigned* valid4 = reinterpret_cast<const unsigned*>(b.valid);
  const int rot = (int)((long long)blockIdx.x * nv / gridDim.x);
  const auto at = [&](int j) {
    return j < nv - rot ? j + rot : j + rot - nv;
  };
  int4 r[kDepth];
  unsigned vb[kDepth];
  const auto load = [&](int j0) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int j = j0 + u * kThreads;
      r[u] = j < nv ? __ldg(ids4 + at(j)) : make_int4(0, 0, 0, 0);
      vb[u] = j < nv && valid4 != nullptr ? __ldg(valid4 + at(j)) : ~0u;
    }
  };
  load(tid);
  for (int j0 = tid; j0 < nv; j0 += kDepth * kThreads) {
    int4 rn[kDepth];
    unsigned vn[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) rn[u] = r[u], vn[u] = vb[u];
    load(j0 + kDepth * kThreads);
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int j = j0 + u * kThreads;
      if (j >= nv) break;
      const int i0 = 4 * at(j);
      const int ids[4] = {rn[u].x, rn[u].y, rn[u].z, rn[u].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned s = slot_of(ids[k], p.mask) - t.base;
        if (s < t.slots)
          claim(t, i0 + k, ids[k], s, vn[u] >> (8 * k) & 0xffu);
      }
    }
  }
  for (int i = 4 * nv + tid; i < b.n; i += kThreads) {
    const int id = __ldg(b.ids + i);
    const unsigned s = slot_of(id, p.mask) - t.base;
    if (s < t.slots)
      claim(t, i, id, s, b.valid == nullptr || b.valid[i] != 0);
  }
}

// the slot's new values from the tile's snapshot, for a winner (id, loss)
__device__ __forceinline__ void patch(const Tile& t, const Params& p,
                                      unsigned loc, int id, float loss,
                                      int step) {
  int* count = t.tab + t.slots;
  int* last_seen = t.tab + 2 * t.slots;
  int* owner = t.tab + 3 * t.slots;
  const bool fresh = owner[loc] != id;
  const float prev = fresh ? loss : __int_as_float(t.tab[loc]);
  t.tab[loc] = __float_as_int(__fadd_rn(__fmul_rn(p.decay, prev),
                                        __fmul_rn(p.one_minus_decay, loss)));
  count[loc] = fresh ? 1 : count[loc] + 1;
  last_seen[loc] = step;
  owner[loc] = id;
}

__device__ __forceinline__ float score(const Tile& t, const Params& p,
                                       unsigned loc, int id, int step) {
  if (t.tab[3 * t.slots + loc] != id) return p.unseen;
  const int age = max(step - t.tab[2 * t.slots + loc], 0);
  return __int_as_float(t.tab[loc]) *
         exp2f(static_cast<float>(age) / p.half_life);
}

// vec: the tile's slots are a multiple of 4 and every table pointer is
// 16-byte aligned; ids_vec: ids is 16-byte aligned and valid (where given)
// 4-byte aligned. Two blocks fit an SM (at most 64 registers a thread), so
// 256 tiles run in one wave.
__global__ void __launch_bounds__(kThreads, 2)
    ledger_tiles(Batch b, Params p, const float* __restrict__ ema_in,
                 const int* __restrict__ count_in,
                 const int* __restrict__ last_seen_in,
                 const int* __restrict__ owner_in, float* __restrict__ out,
                 unsigned slots, int room, int vec, int ids_vec) {
  extern __shared__ __align__(16) int smem[];
  const int tid = threadIdx.x;
  const Tile t = tile_of(smem, slots, room);
  const size_t cap = (size_t)p.mask + 1;
  const int* src[4] = {reinterpret_cast<const int*>(ema_in), count_in,
                       last_seen_in, owner_in};
  PHASE(0);

  // 0. the tile's snapshot into shared memory, in flight during the walk
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int* from = src[a] + t.base;
    int* to = t.tab + a * slots;
    if (vec) {
      for (unsigned r = 4 * tid; r < slots; r += 4 * kThreads)
        cp_async16(to + r, from + r);
    } else {
      for (unsigned r = tid; r < slots; r += kThreads) to[r] = from[r];
    }
  }
  const int step = __ldg(b.step);
  for (unsigned s = tid; s < slots; s += kThreads) t.win[s] = -1;
  if (tid < kHeader) t.fill[tid] = 0;
  __syncthreads();
  PHASE(1);

  // 1. the walk
  walk(t, b, p, ids_vec);
  PHASE(2);
  if (vec) cp_async_wait_all();
  __syncthreads();
  PHASE(3);

  // 2. the winners' slots, patched in the tile: each list entry reads its
  // loss, kDepth entries in flight a thread
  const int fill = *t.fill;
  if (fill <= room) {
    for (int k0 = tid; k0 < fill; k0 += kDepth * kThreads) {
      int2 it[kDepth];
      float loss[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int k = k0 + u * kThreads;
        it[u] = k < fill ? t.items[k] : make_int2(0, 0);
        loss[u] = k < fill ? __ldg(b.losses + it[u].x) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (k0 + u * kThreads >= fill) break;
        const unsigned loc = slot_of(it[u].y, p.mask) - t.base;
        if (t.win[loc] == it[u].x) patch(t, p, loc, it[u].y, loss[u], step);
      }
    }
  } else {
    for (unsigned s = tid; s < slots; s += kThreads) {
      const int w = t.win[s];
      if (w >= 0) patch(t, p, s, __ldg(b.ids + w), __ldg(b.losses + w), step);
    }
  }
  __syncthreads();
  PHASE(4);

  // 3. the tile out, and the tile's items scored against it
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    int* to = reinterpret_cast<int*>(out) + a * cap + t.base;
    const int* from = t.tab + a * slots;
    if (vec) {
      for (unsigned r = 4 * tid; r < slots; r += 4 * kThreads)
        *reinterpret_cast<int4*>(to + r) =
            *reinterpret_cast<const int4*>(from + r);
    } else {
      for (unsigned r = tid; r < slots; r += kThreads) to[r] = from[r];
    }
  }
  float* priority = out + 4 * cap;
  if (fill <= room) {
    for (int k = tid; k < fill; k += kThreads) {
      const int2 it = t.items[k];
      priority[it.x] =
          score(t, p, slot_of(it.y, p.mask) - t.base, it.y, step);
    }
  } else {
    for (int i = tid; i < b.n; i += kThreads) {
      const int id = __ldg(b.ids + i);
      const unsigned loc = slot_of(id, p.mask) - t.base;
      if (loc < slots) priority[i] = score(t, p, loc, id, step);
    }
  }
  PHASE(5);
}

}  // namespace

// One transaction on `stream`: `tiles` blocks of capacity / tiles slots
// (both powers of two), each with `room` entries of item list. Dynamic
// shared memory: 4 * (4 + 5 * slots) + 8 * room bytes (kernels/ledger.py::
// tile_plan). `out` holds the four output arrays and then the n
// priorities, back to back. Returns the launch's cudaError_t (0 on
// success); nothing is synchronised.
extern "C" int ledger_record_priority(
    int capacity, int tiles, int room, const float* ema, const int* count,
    const int* last_seen, const int* owner, const int* ids,
    const float* losses, const uint8_t* valid, const int* step, int n,
    float decay, float one_minus_decay, float unseen, float half_life,
    float* out, void* stream) {
  if (capacity <= 0 || (capacity & (capacity - 1)) || tiles <= 0 ||
      (tiles & (tiles - 1)) || tiles > capacity || room < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  const unsigned slots = (unsigned)(capacity / tiles);
  const size_t smem = 4 * (kHeader + 5 * (size_t)slots) + 8 * (size_t)room;
  static size_t opted = 48 * 1024;  // the most asked for so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        ledger_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  const auto aligned = [](const void* x, uintptr_t m) {
    return reinterpret_cast<uintptr_t>(x) % m == 0;
  };
  const int vec = slots % 4 == 0 && aligned(ema, 16) && aligned(count, 16) &&
                  aligned(last_seen, 16) && aligned(owner, 16) &&
                  aligned(out, 16);
  const int ids_vec = aligned(ids, 16) && aligned(valid, 4);
  const Batch b{ids, losses, valid, step, n};
  const Params p{decay, one_minus_decay, unseen, half_life,
                 (unsigned)capacity - 1u};
  ledger_tiles<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      b, p, ema, count, last_seen, owner, out, slots, room, vec, ids_vec);
  return (int)cudaGetLastError();
}
