// Gradient of the Mamba-1 selective scan, for Hopper (sm_90a).
//
// The JAX package has no Pallas backward for repro/kernels/mamba_scan/
// kernel.py (mamba_scan_pallas): it trains by differentiating its jnp
// scan (repro/models/mamba.py, mode "train").  This is that gradient.
// With a_t = exp(delta_t A) and g_t = dy_t (x) C_t + a_{t+1} . g_{t+1} (the
// gradient that reaches h_t; h_T itself takes none), for every batch row b,
// channel d and state n:
//
//   dC_t[n]  = sum_d dy_t[d] h_t[d,n]
//   dB_t[n]  = sum_d g_t[d,n] delta_t[d] x_t[d]
//   dx_t[d]  = sum_n g_t[d,n] delta_t[d] B_t[n] + D[d] dy_t[d]
//   ddt_t[d] = sum_n g_t[d,n] (x_t[d] B_t[n] + A[d,n] a_t[d,n] h_{t-1}[d,n])
//   dA[d,n]  = sum_{b,t} g_t[d,n] delta_t[d] a_t[d,n] h_{t-1}[d,n]
//   dD[d]    = sum_{b,t} dy_t[d] x_t[d]
//
// x, delta, B, C and dy share one type, fp32 or bf16, widened to fp32 as
// they are staged; A and D are fp32.  dx and ddelta are written in x's
// type, dB and dC in it too, dA and dD in fp32.
//
// Design.  mamba_scan.cu's train launch writes the state entering each
// chunk of kChunk = 32 steps (edges [B, Dm, n_chunks, N] fp32).
// - A block owns 64 channels of one batch row, as the forward's does: a
//   thread owns 4 states of one channel (K = ceil(N / 4) groups of 64
//   threads), so g, a_{t+1} and the dA sums are registers.  It walks the
//   chunks from the last to the first, staging each chunk's x, delta, dy,
//   B and C in shared memory (fp32).
// - A chunk is taken in two halves of 16 steps, the later first.  From the
//   edge state the thread recomputes the state after the first half, then
//   for each half recomputes and keeps its 16 states h_{t-1} in registers
//   and runs g backwards over them.  The recompute repeats the forward's
//   arithmetic (ex2.approx of delta * A log2 e, the same FMA), so it gives
//   the forward's states.
// - No float atomics: every sum has one owner and a fixed order, so two
//   launches give the same bits (training runs under deterministic
//   algorithms, and a restored run must repeat a step bit for bit).
//   * dx, ddelta: each thread sums its 4 states, stores its part; after
//     the chunk, the K parts of a (step, channel) are added in group order.
//   * dB, dC (sums over channels): a warp adds its 32 channels' 8 values
//     (4 states of dB and of dC) by a butterfly of shuffles in which each
//     level halves the values a lane keeps (9 shuffles for 8 sums); the
//     block adds its two warps' sums of each state and writes a partial
//     per block of 64 channels, dbc_part [2, Dm/64, B, T, N] fp32.
//   * dA, dD: per batch row, dA_part [B, Dm, N] and dD_part [B, Dm].
//   A second launch (mamba_scan_bwd_reduce_kernel) adds the channel
//   blocks' partials of dB and dC in block order, and the batch rows'
//   partials of dA and dD in row order.
// Any T >= 1, any Dm and 1 <= N <= 32.
//
// Bound.  At falcon-mamba-7b's training shape (B = 1, T = 4096,
// Dm = 8192, N = 16, bf16) the gradient must read x, delta, dy (67 MB
// each) and the edges (67 MB), and write dx and ddelta (67 MB each):
// ~0.40 GB, 0.12 ms at 3.35 TB/s.  It needs B*T*Dm*N = 537 M exps, 0.13 ms
// at 16 ex2 a clock on each of the 132 SMs (1.98 GHz), the higher floor.
// This kernel evaluates 2.5 exps a state and step (the half-chunk
// recomputes and the reverse step), writes and reads the dB/dC partials
// (2 x 34 MB), and runs 8 warps a block with no copy in flight while it
// computes: it is written to be right, not fast.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 4;      // states a thread keeps
constexpr int kChannels = 64;   // channels a block keeps
constexpr int kChunk = 32;      // steps between edges (the forward's kChunk)
constexpr int kHalf = kChunk / 2;  // states a thread keeps in registers
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The forward's exp: a_t = ex2.approx(delta_t * (A * log2 e)).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

static_assert(kStates == 4, "load_states reads one float4");
__device__ __forceinline__ void load_states(const float* p, float v[kStates]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

// The sums over a warp's 32 lanes of v[0..7]: lane l returns the sum of
// v[(l >> 2) & 7].  Each level exchanges half of the values a lane still
// holds with the lane 16, 8, 4 apart and keeps the other half, summed;
// the last two levels add within groups of 4 lanes.
__device__ __forceinline__ float warp_sum8(const float v[8], int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // w[i]: value 4 h16 + i
    const float send = h16 ? v[i] : v[i + 4];
    const float keep = h16 ? v[i + 4] : v[i];
    w[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  float u[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // u[i]: value 4 h16 + 2 h8 + i
    const float send = h8 ? w[i] : w[i + 2];
    const float keep = h8 ? w[i + 2] : w[i];
    u[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  const float send = h4 ? u[0] : u[1];
  float r = (h4 ? u[1] : u[0]) + __shfl_xor_sync(kFull, send, 4);
  r += __shfl_xor_sync(kFull, r, 2);
  r += __shfl_xor_sync(kFull, r, 1);
  return r;
}

// Shared memory: x, delta, dy [kChunk][kChannels]; B, C [kChunk][np];
// the dx and ddelta parts [2][kChunk][K][kChannels]; the two warps' dB and
// dC sums [2][kChunk][2][np] (all fp32).
template <int K>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return (3 * kChunk * kChannels + 2 * kChunk * kStates * K +
          2 * kChunk * K * kChannels + 2 * kChunk * 2 * kStates * K) *
         sizeof(float);
}

// K groups of 64 threads; grid (ceil(Dm / 64), B), bwd_smem_bytes<K>().
template <typename T, int K>
__global__ void __launch_bounds__(kChannels * K)
mamba_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ Dp,
                      const T* __restrict__ dy,
                      const float* __restrict__ edges, T* __restrict__ dx,
                      T* __restrict__ ddelta, float* __restrict__ dbc_part,
                      float* __restrict__ dA_part,
                      float* __restrict__ dD_part, int T_len, int Dm, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kThreads = K * kChannels;
  constexpr int np = kStates * K;  // states, padded with zero B and C
  float* xs = reinterpret_cast<float*>(smem);
  float* ds = xs + kChunk * kChannels;
  float* dys = ds + kChunk * kChannels;
  float* bs = dys + kChunk * kChannels;
  float* cs = bs + kChunk * np;
  float* part_x = cs + kChunk * np;
  float* part_d = part_x + kChunk * K * kChannels;
  float* red = part_d + kChunk * K * kChannels;

  const int tid = threadIdx.x;
  const int k = tid / kChannels;  // warp-uniform: kChannels % 32 == 0
  const int c = tid % kChannels;
  const int lane = tid % 32;
  const int wc = c / 32;          // which warp of the group
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int d0 = blk * kChannels;
  const int d = d0 + c;
  const bool live = d < Dm;
  const int valid_cols = min(kChannels, Dm - d0);
  const int64_t row0 = static_cast<int64_t>(b) * T_len;
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  const int64_t n_bc = static_cast<int64_t>(gridDim.y) * T_len * N;

  float Av[kStates], a2[kStates], g[kStates], a_next[kStates], dA[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    const int n = k * kStates + j;
    Av[j] = live && n < N ? A[static_cast<int64_t>(d) * N + n] : 0.f;
    a2[j] = Av[j] * kLog2e;
    g[j] = 0.f;
    a_next[j] = 0.f;  // a_T: g_T is zero
    dA[j] = 0.f;
  }
  const float dd = live ? Dp[d] : 0.f;
  float dD = 0.f;

  for (int chunk = n_chunks - 1; chunk >= 0; --chunk) {
    const int t0 = chunk * kChunk;
    const int rows = min(kChunk, T_len - t0);
    // every thread is done with the last chunk's staged inputs and parts
    __syncthreads();
    // steps past T and channels past Dm read as zero: delta = 0 makes a
    // step the identity, and dy = 0 keeps g at zero
    for (int i = tid; i < kChunk * kChannels; i += kThreads) {
      const int r = i / kChannels, cc = i % kChannels;
      const bool valid = r < rows && cc < valid_cols;
      const int64_t off = (row0 + t0 + r) * Dm + d0 + cc;
      xs[i] = valid ? widen(x[off]) : 0.f;
      ds[i] = valid ? widen(delta[off]) : 0.f;
      dys[i] = valid ? widen(dy[off]) : 0.f;
    }
    for (int i = tid; i < kChunk * np; i += kThreads) {
      const int r = i / np, n = i % np;
      const bool valid = r < rows && n < N;
      const int64_t off = (row0 + t0 + r) * N + n;
      bs[i] = valid ? widen(Bm[off]) : 0.f;
      cs[i] = valid ? widen(Cm[off]) : 0.f;
    }
    __syncthreads();

    float h0[kStates], hm[kStates];
#pragma unroll
    for (int j = 0; j < kStates; ++j) {
      const int n = k * kStates + j;
      h0[j] = live && n < N
                  ? edges[((static_cast<int64_t>(b) * Dm + d) * n_chunks +
                           chunk) * N + n]
                  : 0.f;
      hm[j] = h0[j];
    }
    // the state after the first half
#pragma unroll
    for (int s = 0; s < kHalf; ++s) {
      const float dl = ds[s * kChannels + c];
      const float dlx = dl * xs[s * kChannels + c];
      float bv[kStates];
      load_states(bs + s * np + k * kStates, bv);
#pragma unroll
      for (int j = 0; j < kStates; ++j)
        hm[j] = fmaf(ex2(dl * a2[j]), hm[j], dlx * bv[j]);
    }

#pragma unroll 1
    for (int half = 1; half >= 0; --half) {
      const int base = half * kHalf;
      // h_{t-1} of the half's 16 steps
      float hp[kHalf][kStates], hc[kStates];
#pragma unroll
      for (int j = 0; j < kStates; ++j) hc[j] = half ? hm[j] : h0[j];
#pragma unroll
      for (int s = 0; s < kHalf; ++s) {
        const int t = base + s;
        const float dl = ds[t * kChannels + c];
        const float dlx = dl * xs[t * kChannels + c];
        float bv[kStates];
        load_states(bs + t * np + k * kStates, bv);
#pragma unroll
        for (int j = 0; j < kStates; ++j) {
          hp[s][j] = hc[j];
          hc[j] = fmaf(ex2(dl * a2[j]), hc[j], dlx * bv[j]);
        }
      }
      // g backwards over the half
#pragma unroll
      for (int s = kHalf - 1; s >= 0; --s) {
        const int t = base + s;
        const float dl = ds[t * kChannels + c];
        const float xv = xs[t * kChannels + c];
        const float dyv = dys[t * kChannels + c];
        const float dlx = dl * xv;
        float bv[kStates], cv[kStates], v[2 * kStates];
        load_states(bs + t * np + k * kStates, bv);
        load_states(cs + t * np + k * kStates, cv);
        float sx = 0.f, sd = 0.f;
#pragma unroll
        for (int j = 0; j < kStates; ++j) {
          const float a = ex2(dl * a2[j]);
          g[j] = fmaf(a_next[j], g[j], dyv * cv[j]);
          const float ht = fmaf(a, hp[s][j], dlx * bv[j]);
          const float gah = g[j] * a * hp[s][j];
          v[j] = g[j] * dlx;           // dB_t[n]'s term
          v[kStates + j] = dyv * ht;   // dC_t[n]'s term
          sx = fmaf(g[j], bv[j], sx);
          sd = fmaf(g[j], xv * bv[j], sd);
          sd = fmaf(gah, Av[j], sd);
          dA[j] = fmaf(gah, dl, dA[j]);
          a_next[j] = a;
        }
        dD = fmaf(dyv, xv, dD);
        const float r = warp_sum8(v, lane);
        if (lane % 4 == 0) {
          const int idx = (lane >> 2) & 7;
          red[((wc * kChunk + t) * 2 + idx / kStates) * np + k * kStates +
              idx % kStates] = r;
        }
        part_x[(t * K + k) * kChannels + c] =
            dl * sx + (k == 0 ? dd * dyv : 0.f);
        part_d[(t * K + k) * kChannels + c] = sd;
      }
    }
    __syncthreads();
    // dx and ddelta: thread (k, c) adds the K parts of steps k, k + K, ...
    for (int t = k; t < rows; t += K) {
      float sx = part_x[t * K * kChannels + c];
      float sd = part_d[t * K * kChannels + c];
      for (int q = 1; q < K; ++q) {
        sx += part_x[(t * K + q) * kChannels + c];
        sd += part_d[(t * K + q) * kChannels + c];
      }
      if (live) {
        const int64_t off = (row0 + t0 + t) * Dm + d;
        store(dx + off, sx);
        store(ddelta + off, sd);
      }
    }
    // this block's partial dB and dC: its two warps' sums, in order
    for (int i = tid; i < kChunk * 2 * np; i += kThreads) {
      const int t = i / (2 * np), w = i / np % 2, n = i % np;
      if (t < rows && n < N) {
        const float sum = red[(t * 2 + w) * np + n] +
                          red[((kChunk + t) * 2 + w) * np + n];
        dbc_part[(static_cast<int64_t>(w) * gridDim.x + blk) * n_bc +
                 (row0 + t0 + t) * N + n] = sum;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kStates; ++j) {
      const int n = k * kStates + j;
      if (n < N) dA_part[(static_cast<int64_t>(b) * Dm + d) * N + n] = dA[j];
    }
    if (k == 0) dD_part[static_cast<int64_t>(b) * Dm + d] = dD;
  }
}

// dB, dC = the channel blocks' partials added in block order; dA, dD = the
// batch rows' partials added in row order.  One thread an output.
template <typename T>
__global__ void mamba_scan_bwd_reduce_kernel(
    const float* __restrict__ dbc_part, const float* __restrict__ dA_part,
    const float* __restrict__ dD_part, T* __restrict__ dBm,
    T* __restrict__ dCm, float* __restrict__ dA, float* __restrict__ dD,
    int batch, int T_len, int Dm, int N, int n_blk) {
  const int64_t n_bc = static_cast<int64_t>(batch) * T_len * N;
  const int64_t n_a = static_cast<int64_t>(Dm) * N;
  const int64_t total = 2 * n_bc + n_a + Dm;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < 2 * n_bc) {
      const int w = i >= n_bc;
      const int64_t j = i - w * n_bc;
      const float* p = dbc_part + w * n_blk * n_bc + j;
      float sum = 0.f;
      for (int q = 0; q < n_blk; ++q) sum += p[q * n_bc];
      store((w ? dCm : dBm) + j, sum);
    } else if (i < 2 * n_bc + n_a) {
      const int64_t j = i - 2 * n_bc;
      float sum = 0.f;
      for (int q = 0; q < batch; ++q) sum += dA_part[q * n_a + j];
      dA[j] = sum;
    } else {
      const int64_t j = i - 2 * n_bc - n_a;
      float sum = 0.f;
      for (int q = 0; q < batch; ++q) sum += dD_part[q * Dm + j];
      dD[j] = sum;
    }
  }
}

struct Args {
  const void *x, *delta, *A, *Bm, *Cm, *Dp, *dy, *edges;
  void *dx, *ddelta, *dA, *dBm, *dCm, *dD, *dbc_part, *dA_part, *dD_part;
  int batch, T_len, Dm, N;
  cudaStream_t stream;
};

template <typename T, int K>
int launch(const Args& a) {
  auto kernel = mamba_scan_bwd_kernel<T, K>;
  constexpr int smem = static_cast<int>(bwd_smem_bytes<K>());
  // above 48 KB only as opted-in dynamic shared memory; set once per
  // instantiation
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int n_blk = (a.Dm + kChannels - 1) / kChannels;
  kernel<<<dim3(n_blk, a.batch), K * kChannels, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.delta),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), static_cast<const float*>(a.Dp),
      static_cast<const T*>(a.dy), static_cast<const float*>(a.edges),
      static_cast<T*>(a.dx), static_cast<T*>(a.ddelta),
      static_cast<float*>(a.dbc_part), static_cast<float*>(a.dA_part),
      static_cast<float*>(a.dD_part), a.T_len, a.Dm, a.N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = 2 * static_cast<int64_t>(a.batch) * a.T_len * a.N +
                        static_cast<int64_t>(a.Dm) * (a.N + 1);
  constexpr int kReduceThreads = 256;
  const int64_t blocks = (total + kReduceThreads - 1) / kReduceThreads;
  mamba_scan_bwd_reduce_kernel<T>
      <<<static_cast<int>(blocks < 4096 ? blocks : 4096), kReduceThreads, 0,
         a.stream>>>(
          static_cast<const float*>(a.dbc_part),
          static_cast<const float*>(a.dA_part),
          static_cast<const float*>(a.dD_part), static_cast<T*>(a.dBm),
          static_cast<T*>(a.dCm), static_cast<float*>(a.dA),
          static_cast<float*>(a.dD), a.batch, a.T_len, a.Dm, a.N, n_blk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a) {
  switch ((a.N + kStates - 1) / kStates) {
    case 1: return launch<T, 1>(a);
    case 2: return launch<T, 2>(a);
    case 3: return launch<T, 3>(a);
    case 4: return launch<T, 4>(a);
    case 5: return launch<T, 5>(a);
    case 6: return launch<T, 6>(a);
    case 7: return launch<T, 7>(a);
    case 8: return launch<T, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Two launches on `stream` (the gradient, then the reduction of its
// partials); returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for N outside [1, 32], a batch past the grid or an
// unknown dtype.  dtype 0: x, delta, Bm, Cm, dy, dx, ddelta, dBm and dCm
// are fp32; 1: bf16.  All pointers are device pointers to contiguous data:
// x, delta, dy, dx, ddelta [B, T, Dm]; A, dA [Dm, N] fp32; Bm, Cm, dBm,
// dCm [B, T, N]; Dp, dD [Dm] fp32; edges [B, Dm, ceil(T / 32), N] fp32
// from mamba_scan_train_launch; the scratch dbc_part [2, ceil(Dm / 64), B,
// T, N], dA_part [B, Dm, N] and dD_part [B, Dm], fp32.
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* delta, const void* A, const void* Bm,
    const void* Cm, const void* Dp, const void* dy, const void* edges,
    void* dx, void* ddelta, void* dA, void* dBm, void* dCm, void* dD,
    void* dbc_part, void* dA_part, void* dD_part, int batch, int T, int Dm,
    int N, int dtype, void* stream) {
  if (N < 1 || N > 32 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || T <= 0 || Dm <= 0) return static_cast<int>(cudaSuccess);
  const Args a{x, delta, A, Bm, Cm, Dp, dy, edges, dx, ddelta, dA, dBm, dCm,
               dD, dbc_part, dA_part, dD_part, batch, T, Dm, N,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return dispatch<float>(a);
    case 1: return dispatch<__nv_bfloat16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
