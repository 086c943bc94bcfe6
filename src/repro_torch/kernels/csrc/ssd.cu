// Mamba2 SSD chunk scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd
// (_ssd_kernel): x [B, S, H, P], dt [B, S, H] f32 (positive), a [H] f32
// (negative), B and C [B, S, G, N] -> y [B, S, H, P] in x's dtype and the
// final state [B, H, P, N] f32. Per chunk of L steps, with
// cum = cumsum(dt * a) inside the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//         + exp(cum_i) C_i . state                                  (inter)
//   state = exp(cum_L) state + sum_j x_j (B_j exp(cum_L - cum_j) dt_j)^T
//
// Bound on the H100: at the serving shapes, the operations. A chunk of
// L = 128 costs about 2 L^2 N / 2 + 2 L^2 P / 2 + 4 L N P flops per head
// (7.3 MFLOP at mamba2-370m's P = 64, N = 128), against
// (2 P + 2 N) L bytes of bf16 input, so the f32 work outweighs the bytes
// even at the CUDA cores' 67 TFLOP/s; the scan is no tensor-core kernel yet.
//
// Design: the TPU grid (B, H, chunks) runs its chunk axis in order and
// carries the [P, N] state in VMEM scratch. Hopper blocks have no order, so
// one block owns one (batch, head) and loops over the chunks itself, with
// the f32 state in shared memory. Each chunk's x, B and C rows are staged
// in shared memory as f32 (B and the state padded by one float per row so
// that neighbouring lanes hit distinct banks); B and C are read at group
// h / (H / G), never expanded H-wide. The [L, L] score matrix is built
// kRows rows at a time, and only on and below the diagonal, so
// exp(cum_i - cum_j) is never taken where it would overflow (i < j). A
// last chunk shorter than L is run as it is (the TPU kernel pads it with
// dt = 0 steps, exact no-ops). At L = 128, N = 128, P = 64 the block holds
// about 216 KB of shared memory (dynamic, opted in past 48 KB), so one
// block runs per SM; B * H blocks (32 for mamba2-370m at batch 1) leave
// most SMs idle: splitting the chunks across blocks is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // score rows built at a time
constexpr size_t kMaxSmem = 232448;  // per block on sm_90

size_t smem_floats(int L, int P, int N) {
  return (size_t)P * (N + 1)      // state
         + (size_t)L * (N + 1)    // B
         + (size_t)L * N          // C
         + (size_t)L * P          // x
         + (size_t)kRows * L      // scores
         + 3 * (size_t)L;         // dt, cum, tail weights
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a, const T* __restrict__ bm,
             const T* __restrict__ cm, T* __restrict__ y,
             float* __restrict__ state_out, int S, int H, int P, int G, int N,
             int L) {
  extern __shared__ float sm[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  float* st = sm;                 // [P, N + 1]
  float* b_s = st + P * (N + 1);  // [L, N + 1]
  float* c_s = b_s + L * (N + 1); // [L, N]
  float* x_s = c_s + L * N;       // [L, P]
  float* att = x_s + L * P;       // [kRows, L]
  float* dt_s = att + kRows * L;  // [L]
  float* cum = dt_s + L;          // [L]
  float* w_s = cum + L;           // [L] exp(cum_last - cum_j) dt_j

  for (int e = tid; e < P * (N + 1); e += kThreads) st[e] = 0.f;
  const float ah = a[h];

  for (int c0 = 0; c0 < S; c0 += L) {
    const int Lc = min(L, S - c0);
    __syncthreads();  // the previous chunk is done with the staged rows
    for (int e = tid; e < Lc * P; e += kThreads) {
      const int i = e / P, p = e - i * P;
      x_s[e] = to_f(x[(((size_t)b * S + c0 + i) * H + h) * P + p]);
    }
    for (int e = tid; e < Lc * N; e += kThreads) {
      const int i = e / N, n = e - i * N;
      const size_t off = (((size_t)b * S + c0 + i) * G + g) * N + n;
      b_s[i * (N + 1) + n] = to_f(bm[off]);
      c_s[e] = to_f(cm[off]);
    }
    for (int i = tid; i < Lc; i += kThreads)
      dt_s[i] = dt[((size_t)b * S + c0 + i) * H + h];
    __syncthreads();
    if (tid == 0) {  // L <= a few hundred steps: a serial cumsum is cheap
      float run = 0.f;
      for (int i = 0; i < Lc; ++i) {
        run += dt_s[i] * ah;
        cum[i] = run;
      }
    }
    __syncthreads();
    const float total = cum[Lc - 1];
    for (int j = tid; j < Lc; j += kThreads)
      w_s[j] = expf(total - cum[j]) * dt_s[j];

    // outputs, kRows rows at a time: scores on and below the diagonal,
    // then y = scores @ x + exp(cum_i) C_i . state (the state entering
    // this chunk: it is updated only after every row is out)
    for (int i0 = 0; i0 < Lc; i0 += kRows) {
      const int nr = min(kRows, Lc - i0);
      const int ncol = min(Lc, i0 + nr);  // columns any of these rows needs
      for (int e = tid; e < nr * ncol; e += kThreads) {
        const int r = e / ncol, j = e - r * ncol;
        const int i = i0 + r;
        float s = 0.f;
        if (j <= i) {
          const float* ci = c_s + i * N;
          const float* bj = b_s + j * (N + 1);
          for (int n = 0; n < N; ++n) s += ci[n] * bj[n];
          s *= expf(cum[i] - cum[j]) * dt_s[j];
        }
        att[r * L + j] = s;
      }
      __syncthreads();
      for (int e = tid; e < nr * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        const int i = i0 + r;
        const float* ar = att + r * L;
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra += ar[j] * x_s[j * P + p];
        const float* ci = c_s + i * N;
        const float* sp = st + p * (N + 1);
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter += ci[n] * sp[n];
        y[(((size_t)b * S + c0 + i) * H + h) * P + p] =
            from_f<T>(intra + expf(cum[i]) * inter);
      }
      __syncthreads();
    }

    // state' = exp(total) state + x^T (B * w)
    const float decay = expf(total);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      float s = 0.f;
      for (int j = 0; j < Lc; ++j)
        s += x_s[j * P + p] * (b_s[j * (N + 1) + n] * w_s[j]);
      st[p * (N + 1) + n] = st[p * (N + 1) + n] * decay + s;
    }
  }
  __syncthreads();
  float* so = state_out + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    so[e] = st[p * (N + 1) + n];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, void* y, float* state, int B, int S, int H, int P,
           int G, int N, int L, cudaStream_t s) {
  const size_t smem = smem_floats(L, P, N) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan<T><<<B * H, kThreads, smem, s>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), state, S, H, P, G, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt, a and the
// state are float32). Launches on `stream`, returns the launch's cudaError_t
// (0 on success), never synchronises.
extern "C" int ssd(int dtype, const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, void* y, void* state, int B,
                   int S, int H, int P, int G, int N, int L, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      N <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* stf = static_cast<float*>(state);
  if (dtype == 0)
    return launch<float>(x, dtf, af, bm, cm, y, stf, B, S, H, P, G, N, L, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, af, bm, cm, y, stf, B, S, H, P, G, N,
                                 L, s);
  return (int)cudaErrorInvalidValue;
}
