// Fused recycle-ledger transaction (record + priority), hand-written for
// Hopper (sm_90a).
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
// Bound on the H100: memory, and at the path's sizes launch latency. The
// outputs are whole tables, so the least traffic is reading the four input
// arrays and writing the four outputs once (2 MB at capacity 65536, about
// 0.6 us at 3.35 TB/s); the batch itself is a few hundred bytes.
//
// Design: the Pallas versions are a serial loop over items (fori) and a
// sequential tile grid whose second pass depends on program order. Hopper
// blocks have no order, so the transaction is cut at the points that need a
// grid-wide barrier, and a kernel boundary is that barrier:
//   1. copy: every slot of the input table to the output table, and the
//      scratch `last` (one i32 per slot) to -1 (grid-stride over capacity);
//   2. claim: each valid item atomicMax-es its batch index into last[slot];
//      the maximum is the same whatever order the atomics land in, so the
//      winner (the last valid item in batch order) is deterministic;
//   3. write: the winner of each slot computes its EMA and count from the
//      input snapshot (never touched by this launch) and writes the
//      output table;
//   4. score: every item reads the updated output table.
// "block" runs 2-4 as three grids over the items; "fori" (small batches)
// runs 2-4 in one block separated by __syncthreads, one launch fewer. The
// EMA is computed with explicit round-to-nearest multiplies and add so that
// no FMA contraction changes it against the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFib32 = 0x9E3779B9u;

struct Table {
  float* ema;
  int* count;
  int* last_seen;
  int* owner;
};

struct Batch {
  const int* ids;
  const float* losses;
  const uint8_t* valid;  // nullptr = every item writes
  const int* step;       // device scalar
  int n;
};

struct Params {
  float decay, one_minus_decay, unseen, half_life;
  int capacity;
};

__device__ __forceinline__ int slot_of(int id, int capacity) {
  unsigned h = static_cast<unsigned>(id) * kFib32;  // wraps at 32 bits
  h ^= h >> 16;
  return static_cast<int>(h & static_cast<unsigned>(capacity - 1));
}

__device__ __forceinline__ bool is_valid(const Batch& b, int i) {
  return b.valid == nullptr || b.valid[i] != 0;
}

__global__ void __launch_bounds__(kThreads)
    ledger_copy(int capacity, const float* __restrict__ ema,
                const int* __restrict__ count,
                const int* __restrict__ last_seen,
                const int* __restrict__ owner, Table out, int* last) {
  for (int s = blockIdx.x * kThreads + threadIdx.x; s < capacity;
       s += gridDim.x * kThreads) {
    out.ema[s] = ema[s];
    out.count[s] = count[s];
    out.last_seen[s] = last_seen[s];
    out.owner[s] = owner[s];
    last[s] = -1;
  }
}

__device__ __forceinline__ void claim(const Batch& b, const Params& p, int i,
                                      int* last) {
  if (is_valid(b, i)) atomicMax(last + slot_of(b.ids[i], p.capacity), i);
}

__device__ __forceinline__ void write(const Batch& b, const Params& p, int i,
                                      const float* __restrict__ ema_in,
                                      const int* __restrict__ count_in,
                                      const int* __restrict__ owner_in,
                                      const int* last, Table out) {
  if (!is_valid(b, i)) return;
  const int id = b.ids[i];
  const int slot = slot_of(id, p.capacity);
  if (__ldcg(last + slot) != i) return;  // a later valid item owns the slot
  const float loss = b.losses[i];
  const bool fresh = owner_in[slot] != id;
  const float prev = fresh ? loss : ema_in[slot];
  out.ema[slot] = __fadd_rn(__fmul_rn(p.decay, prev),
                            __fmul_rn(p.one_minus_decay, loss));
  out.count[slot] = fresh ? 1 : count_in[slot] + 1;
  out.last_seen[slot] = *b.step;
  out.owner[slot] = id;
}

__device__ __forceinline__ void score(const Batch& b, const Params& p, int i,
                                      Table out, float* priority) {
  const int id = b.ids[i];
  const int slot = slot_of(id, p.capacity);
  float val = p.unseen;
  if (__ldcg(out.owner + slot) == id) {
    const int age = max(*b.step - __ldcg(out.last_seen + slot), 0);
    val = __ldcg(out.ema + slot) *
          exp2f(static_cast<float>(age) / p.half_life);
  }
  priority[i] = val;
}

__global__ void __launch_bounds__(kThreads)
    ledger_claim(Batch b, Params p, int* last) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < b.n) claim(b, p, i, last);
}

__global__ void __launch_bounds__(kThreads)
    ledger_write(Batch b, Params p, const float* __restrict__ ema_in,
                 const int* __restrict__ count_in,
                 const int* __restrict__ owner_in, const int* last,
                 Table out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < b.n) write(b, p, i, ema_in, count_in, owner_in, last, out);
}

__global__ void __launch_bounds__(kThreads)
    ledger_score(Batch b, Params p, Table out, float* priority) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < b.n) score(b, p, i, out, priority);
}

// The three item phases in one block: __syncthreads is the barrier.
__global__ void __launch_bounds__(kThreads)
    ledger_single_block(Batch b, Params p, const float* __restrict__ ema_in,
                        const int* __restrict__ count_in,
                        const int* __restrict__ owner_in, int* last,
                        Table out, float* priority) {
  for (int i = threadIdx.x; i < b.n; i += kThreads) claim(b, p, i, last);
  __syncthreads();
  for (int i = threadIdx.x; i < b.n; i += kThreads)
    write(b, p, i, ema_in, count_in, owner_in, last, out);
  __syncthreads();
  for (int i = threadIdx.x; i < b.n; i += kThreads)
    score(b, p, i, out, priority);
}

}  // namespace

// variant: 0 = "fori" (phases 2-4 in one block), 1 = "block" (three grids).
// `last` is scratch of `capacity` i32. Returns the cudaError_t of the
// launches (0 on success); nothing is synchronised.
extern "C" int ledger_record_priority(
    int variant, int capacity, const float* ema, const int* count,
    const int* last_seen, const int* owner, const int* ids,
    const float* losses, const uint8_t* valid, const int* step, int n,
    float decay, float one_minus_decay, float unseen, float half_life,
    float* ema_out, int* count_out, int* last_seen_out, int* owner_out,
    float* priority, int* last, void* stream) {
  if (capacity <= 0 || (capacity & (capacity - 1)) || n < 0 ||
      (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Table out{ema_out, count_out, last_seen_out, owner_out};
  const Batch b{ids, losses, valid, step, n};
  const Params p{decay, one_minus_decay, unseen, half_life, capacity};
  const int need = (capacity + kThreads - 1) / kThreads;
  const int copy_blocks = need < 1024 ? need : 1024;
  ledger_copy<<<copy_blocks, kThreads, 0, s>>>(capacity, ema, count,
                                               last_seen, owner, out, last);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 0) return (int)e;
  if (variant == 0) {
    ledger_single_block<<<1, kThreads, 0, s>>>(b, p, ema, count, owner, last,
                                               out, priority);
    return (int)cudaGetLastError();
  }
  const int item_blocks = (n + kThreads - 1) / kThreads;
  ledger_claim<<<item_blocks, kThreads, 0, s>>>(b, p, last);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ledger_write<<<item_blocks, kThreads, 0, s>>>(b, p, ema, count, owner, last,
                                                out);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ledger_score<<<item_blocks, kThreads, 0, s>>>(b, p, out, priority);
  return (int)cudaGetLastError();
}
