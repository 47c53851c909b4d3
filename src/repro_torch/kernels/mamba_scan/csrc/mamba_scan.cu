// Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan/kernel.py
// (mamba_scan_pallas -> _mamba_kernel).  For every batch row b, channel d
// and state n, from h_0 = 0:
//
//   h_t[d,n] = exp(delta_t[d] * A[d,n]) * h_{t-1}[d,n]
//              + (delta_t[d] * x_t[d]) * B_t[n]
//   y_t[d]   = sum_n C_t[n] * h_t[d,n] + D[d] * x_t[d]
//
// x, delta, B and C share one type, fp32 or bf16, and are widened to fp32
// as they are read, as the Pallas kernel casts inside its body; A and D
// are fp32.  It writes y [B, T, Dm] in x's type, rounded once from the
// fp32 sum, and the final state h_T [B, Dm, N] in fp32.  The TPU kernel
// returned only y (its state lived in VMEM scratch), so the JAX serve path
// ran its prefill through the jnp reference to get h_T; here prefill runs
// this kernel and takes h_T from it.
//
// Design.  The only serial work of a step is h = a * h + b, one FMA a
// state; everything else is taken off that chain.
// - A block owns 64 channels of one batch row and walks T in chunks of 32
//   steps.  A thread owns 4 states of one channel (K = ceil(N / 4) groups
//   of 64 threads, K a template parameter; N is padded to 4K with zero B
//   and C), so its states are independent FMA chains in registers.
// - x and delta (32 x 64 values a chunk) are staged in shared memory by
//   cp.async, three stages deep: while a chunk is computed, the next two
//   are in flight.  B and C (32 x 4K values, read by every channel) are
//   loaded into registers while a chunk is computed and stored widened to
//   fp32 after it, so no thread widens them again.  Steps past T and
//   channels past Dm are zero-filled (delta = 0 makes a step the
//   identity), so the step loop is fully unrolled with no bounds.
// - exp(delta * A) is ex2.approx of delta * (A * log2 e), with A * log2 e
//   in a register.  The exps and delta * x * B of 16 steps are computed
//   ahead of those steps' FMA chain, so the special-function units and
//   the loads pipeline across steps.
// - No shuffles: each thread stores its 4-state part of y_t to shared
//   memory (group 0's part starts with D x_t), by a store that does not
//   order the loads around it.  The block sums the K parts of each (step,
//   channel) and writes y in rows of 64 channels one chunk later, from a
//   second buffer of parts, so a chunk costs one barrier.
// Train variant (mamba_scan_train_launch): the kernel instantiated with
// kEdges also writes the state entering each window of kAhead = 16 steps,
// edges [B, ceil(T / 16), K, Dm, 4] fp32 (state 4k + i of channel d at
// [.., k, d, i]; window 0's is zero, states past N too), from which the
// backward (mamba_scan_bwd.cu) recomputes a window's states.  A thread
// writes its 4 states as one 16-byte store, so a warp's store is 512
// contiguous bytes.  The serve launch instantiates the kernel without, so
// its code is the same as before.
// Any T >= 1, any Dm and 1 <= N <= 32.  Rows whose bytes (or whose
// tensors' starts) are not a multiple of 16 are staged by plain loads.
//
// Bound.  At the serve path's prefill shape (B = 1, T = 1536, Dm = 8192,
// N = 16) the scan moves x, delta and y once (50 MB each in fp32, 25 MB in
// bf16) and B, C, A, D and h_T (< 1 MB): ~152 MB, 0.045 ms at 3.35 TB/s,
// ~76 MB and 0.023 ms in bf16.  It evaluates B*T*Dm*N = 201 M exps; the
// special-function units issue 16 ex2 a clock on each of the 132 SMs,
// 0.048 ms at 1.98 GHz, the higher floor in either type.  A step of a
// thread issues ~26 instructions (9 FMUL, 8 FFMA, 4 MUFU, 4 loads, 1
// store) for its 4 states; the 128 blocks of 8 warps, one an SM, issue
// them in about the time of the exps.  What is left between the kernel
// and that floor is the copies' and y's instructions and the barrier a
// chunk, with 2 warps a scheduler to hide latency.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 4;     // states a thread keeps
constexpr int kChannels = 64;  // channels a block keeps
constexpr int kChunk = 32;     // steps a stage holds
constexpr int kAhead = 16;     // steps whose exps are computed ahead
constexpr int kStages = 3;     // chunks in shared memory at once
// B and C values of a chunk a thread stages: kChunk * np over 64 * groups
constexpr int kBcPerThread = kChunk * kStates / kChannels;
static_assert(kBcPerThread * kChannels == kChunk * kStates,
              "a chunk's B and C must split evenly over the block");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ T zero() {
  return T(0.f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// A thread's kStates consecutive fp32 values from shared memory.
static_assert(kStates == 4, "load_states reads one float4");
__device__ __forceinline__ void load_states(const float* p, float v[kStates]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

// A store to shared memory that does not order the loads around it (no
// memory clobber): the partial sums never alias the staged inputs.  They
// are read only after the next barrier, and fence_then_sync orders them
// before it.
__device__ __forceinline__ void store_partial(float* p, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                  "f"(v));
}

// A compiler fence, then the block barrier: every store_partial issued
// before (a volatile asm, kept in order with this one) lands before any
// load after the barrier is issued.
__device__ __forceinline__ void fence_then_sync() {
  asm volatile("" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One asynchronous copy of 16 bytes, or 16 zero bytes when !valid (the
// copy's source size 0 reads nothing and fills the destination with zeros).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage a kChunk x kChannels tile of x or delta (row stride Dm in global
// memory); rows >= valid_rows and columns >= valid_cols read as zero.
// aligned: every row starts on 16 bytes, so 16-byte cp.async copies move
// it (they never straddle valid_cols), with every index known at compile
// time; otherwise plain loads and stores.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int64_t Dm,
                                           int valid_rows, int valid_cols,
                                           bool aligned) {
  if (aligned) {
    constexpr int per = 16 / sizeof(T), vcols = kChannels / per;
    constexpr int copies = kChunk * vcols;
#pragma unroll
    for (int q = 0; q < (copies + kThreads - 1) / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (copies % kThreads != 0 && i >= copies) break;
      const int r = i / vcols, c = i % vcols * per;
      const bool valid = r < valid_rows && c < valid_cols;
      cp_async16(dst + r * kChannels + c, valid ? src + r * Dm + c : src,
                 valid);
    }
    return;
  }
  for (int i = threadIdx.x; i < kChunk * kChannels; i += kThreads) {
    const int r = i / kChannels, c = i % kChannels;
    dst[i] = r < valid_rows && c < valid_cols ? src[r * Dm + c] : zero<T>();
  }
}

// A stage: x and delta [kChunk][kChannels] in T, then B and C
// [kChunk][kStates * K] in fp32.
template <typename T, int K>
__host__ __device__ constexpr size_t stage_bytes() {
  return 2 * kChunk * kChannels * sizeof(T) +
         2 * kChunk * kStates * K * sizeof(float);
}

// kStages stages, then two buffers of y's partial sums
// [kChunk][K][kChannels] (a chunk's, and the one before it).
template <typename T, int K>
__host__ __device__ constexpr size_t smem_bytes() {
  return kStages * stage_bytes<T, K>() +
         2 * kChunk * K * kChannels * sizeof(float);
}

// K groups of 64 threads, each thread kStates states of a channel;
// grid (ceil(Dm / 64), B), smem_bytes<T, K>() of shared memory; kEdges:
// also write the state entering each chunk to edges.
template <typename T, int K, bool kEdges>
__global__ void __launch_bounds__(kChannels * K)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ Dp,
                  T* __restrict__ y, float* __restrict__ h_out,
                  float* __restrict__ edges, int T_len, int Dm, int N,
                  bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kThreads = K * kChannels;
  constexpr int np = kStates * K;  // states, padded with zero B and C
  constexpr size_t per_stage = stage_bytes<T, K>();
  auto part_of = [&](int chunk) {
    return reinterpret_cast<float*>(smem + kStages * per_stage) +
           (chunk & 1) * kChunk * K * kChannels;
  };
  auto xs_of = [&](int chunk) {
    return reinterpret_cast<T*>(smem + (chunk % kStages) * per_stage);
  };
  auto bs_of = [&](int chunk) {
    return reinterpret_cast<float*>(xs_of(chunk) + 2 * kChunk * kChannels);
  };

  const int tid = threadIdx.x;
  const int k = tid / kChannels;  // warp-uniform: kChannels % 32 == 0
  const int c = tid % kChannels;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const bool live = d < Dm;
  const int valid_cols = min(kChannels, Dm - d0);
  const int64_t row0 = static_cast<int64_t>(b) * T_len;

  float a2[kStates], h[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    const int n = k * kStates + j;
    a2[j] = live && n < N ? A[static_cast<int64_t>(d) * N + n] * kLog2e : 0.f;
    h[j] = 0.f;
  }
  const float dd = live ? Dp[d] : 0.f;

  // B and C of a chunk are kChunk * np values each, kBcPerThread of each
  // a thread: loaded into registers while a chunk is computed, widened
  // and stored after it (np is a multiple of kStates: zero columns >= N)
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  const int n_edges = (T_len + kAhead - 1) / kAhead;
  T bc[2][kBcPerThread];
  auto load_bc = [&](int chunk) {
    const int t0 = chunk * kChunk;
#pragma unroll
    for (int q = 0; q < kBcPerThread; ++q) {
      const int i = tid + q * kThreads;
      const int r = i / np, n = i % np;
      const bool valid = t0 + r < T_len && n < N;
      const int64_t off = (row0 + t0 + r) * N + n;
      bc[0][q] = valid ? Bm[off] : zero<T>();
      bc[1][q] = valid ? Cm[off] : zero<T>();
    }
  };
  auto store_bc = [&](int chunk) {
    float* bs = bs_of(chunk);
#pragma unroll
    for (int q = 0; q < kBcPerThread; ++q) {
      const int i = tid + q * kThreads;
      bs[i] = widen(bc[0][q]);
      bs[kChunk * np + i] = widen(bc[1][q]);
    }
  };
  auto issue_x = [&](int chunk) {
    const int t0 = chunk * kChunk;
    const int rows = min(kChunk, T_len - t0);
    const int64_t off = (row0 + t0) * Dm + d0;
    T* xs = xs_of(chunk);
    stage_tile<T, kThreads>(xs, x + off, Dm, rows, valid_cols, aligned);
    stage_tile<T, kThreads>(xs + kChunk * kChannels, delta + off, Dm, rows,
                            valid_cols, aligned);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) {
      issue_x(s);
      load_bc(s);
      store_bc(s);
    }
    cp_async_commit();
  }
  // y of a chunk: thread (k, c) sums the K partials of steps k, k + K, ...
  // of channel c
  auto write_y = [&](int chunk) {
    const float* part = part_of(chunk);
    const int t0 = chunk * kChunk;
#pragma unroll
    for (int q = 0; q < (kChunk + K - 1) / K; ++q) {
      const int t = k + q * K;
      if (t >= kChunk) break;
      float acc = part[t * K * kChannels + c];
#pragma unroll
      for (int g = 1; g < K; ++g) acc += part[(t * K + g) * kChannels + c];
      if (live && t0 + t < T_len) store(y + (row0 + t0 + t) * Dm + d, acc);
    }
  };

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    // One barrier a chunk.  After it: the chunk's copies have landed (one
    // group a chunk, kStages - 2 younger ones may still be in flight);
    // every thread is done computing the chunk before, so its partials are
    // complete and its stage is free for the next issue; and every thread
    // is done writing y of the chunk before that, whose partials' buffer
    // this chunk fills.
    cp_async_wait<kStages - 2>();
    fence_then_sync();
    const int next = chunk + kStages - 1;
    if (next < n_chunks) {
      issue_x(next);
      load_bc(next);
    }
    cp_async_commit();
    if (chunk > 0) write_y(chunk - 1);

    const T* xs = xs_of(chunk);
    const T* ds = xs + kChunk * kChannels;
    const float* bs = bs_of(chunk) + k * kStates;
    const float* cs = bs + kChunk * np;
    float* part = part_of(chunk);
#pragma unroll
    for (int t0 = 0; t0 < kChunk; t0 += kAhead) {
      if (kEdges && live) {
        // the state entering this window
        const int e = (chunk * kChunk + t0) / kAhead;
        if (e < n_edges)
          *reinterpret_cast<float4*>(
              edges + (((static_cast<int64_t>(b) * n_edges + e) * K + k) *
                           Dm + d) * kStates) =
              make_float4(h[0], h[1], h[2], h[3]);
      }
      // everything of kAhead steps that does not depend on h; group 0
      // starts y_t with D x_t
      float a[kAhead][kStates], bx[kAhead][kStates], p[kAhead];
#pragma unroll
      for (int s = 0; s < kAhead; ++s) {
        const int t = t0 + s;
        const float dl = widen(ds[t * kChannels + c]);
        const float xv = widen(xs[t * kChannels + c]);
        const float dx = dl * xv;
        p[s] = k == 0 ? dd * xv : 0.f;
        float bv[kStates];
        load_states(bs + t * np, bv);
#pragma unroll
        for (int j = 0; j < kStates; ++j) {
          a[s][j] = ex2(dl * a2[j]);
          bx[s][j] = dx * bv[j];
        }
      }
      // the chain: one FMA a state and step, and this thread's part of y
#pragma unroll
      for (int s = 0; s < kAhead; ++s) {
        float cv[kStates];
        load_states(cs + (t0 + s) * np, cv);
#pragma unroll
        for (int j = 0; j < kStates; ++j) {
          h[j] = fmaf(a[s][j], h[j], bx[s][j]);
          p[s] = fmaf(cv[j], h[j], p[s]);
        }
      }
#pragma unroll
      for (int s = 0; s < kAhead; ++s)
        store_partial(part + ((t0 + s) * K + k) * kChannels + c, p[s]);
    }
    if (next < n_chunks) store_bc(next);
  }
  fence_then_sync();
  write_y(n_chunks - 1);
  if (live) {
#pragma unroll
    for (int j = 0; j < kStates; ++j) {
      const int n = k * kStates + j;
      if (n < N) h_out[(static_cast<int64_t>(b) * Dm + d) * N + n] = h[j];
    }
  }
}

// Whether every row start of both tensors lies on 16 bytes.
bool rows_aligned16(const void* p, const void* q, int64_t row_bytes) {
  return ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(q) |
           static_cast<uintptr_t>(row_bytes)) % 16) == 0;
}

template <typename T, int K, bool kEdges>
int launch(const void* x, const void* delta, const void* A, const void* Bm,
           const void* Cm, const void* Dp, void* y, void* h_out, void* edges,
           int batch, int T_len, int Dm, int N, cudaStream_t stream) {
  auto kernel = mamba_scan_kernel<T, K, kEdges>;
  constexpr int smem = static_cast<int>(smem_bytes<T, K>());
  // above 48 KB only as opted-in dynamic shared memory; set once per
  // instantiation, outside any CUDA graph capture of a launch
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const bool aligned =
      rows_aligned16(x, delta, static_cast<int64_t>(Dm) * sizeof(T));
  const dim3 grid((Dm + kChannels - 1) / kChannels, batch);
  kernel<<<grid, K * kChannels, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dp),
      static_cast<T*>(y), static_cast<float*>(h_out),
      static_cast<float*>(edges), T_len, Dm, N, aligned);
  return static_cast<int>(cudaGetLastError());
}


template <typename T>
int dispatch(const void* x, const void* delta, const void* A, const void* Bm,
             const void* Cm, const void* Dp, void* y, void* h_out,
             void* edges, int batch, int T_len, int Dm, int N,
             cudaStream_t stream) {
  switch ((N + kStates - 1) / kStates) {
#define MAMBA_SCAN_CASE(K)                                                 \
  case K:                                                                  \
    return edges ? launch<T, K, true>(x, delta, A, Bm, Cm, Dp, y, h_out,   \
                                      edges, batch, T_len, Dm, N, stream)  \
                 : launch<T, K, false>(x, delta, A, Bm, Cm, Dp, y, h_out,  \
                                       edges, batch, T_len, Dm, N, stream);
    MAMBA_SCAN_CASE(1) MAMBA_SCAN_CASE(2) MAMBA_SCAN_CASE(3)
    MAMBA_SCAN_CASE(4) MAMBA_SCAN_CASE(5) MAMBA_SCAN_CASE(6)
    MAMBA_SCAN_CASE(7) MAMBA_SCAN_CASE(8)
#undef MAMBA_SCAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch on `stream`, with edges or without (nullptr); returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for N
// outside [1, 32], a batch past the grid or an unknown dtype.
int scan(const void* x, const void* delta, const void* A, const void* Bm,
         const void* Cm, const void* Dp, void* y, void* h_out, void* edges,
         int batch, int T, int Dm, int N, int dtype, void* stream) {
  if (N < 1 || N > 32 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || T <= 0 || Dm <= 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, delta, A, Bm, Cm, Dp, y, h_out, edges, batch,
                             T, Dm, N, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, delta, A, Bm, Cm, Dp, y, h_out,
                                     edges, batch, T, Dm, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for N outside [1, 32], a batch past the grid or an
// unknown dtype.  dtype 0: x, delta, Bm, Cm and y are fp32; 1: bf16.  All
// pointers are device pointers to contiguous data: x, delta and y
// [B, T, Dm]; A [Dm, N] fp32; Bm, Cm [B, T, N]; Dp [Dm] fp32; h_out
// [B, Dm, N] fp32.
extern "C" int mamba_scan_launch(const void* x, const void* delta,
                                 const void* A, const void* Bm, const void* Cm,
                                 const void* Dp, void* y, void* h_out,
                                 int batch, int T, int Dm, int N, int dtype,
                                 void* stream) {
  return scan(x, delta, A, Bm, Cm, Dp, y, h_out, nullptr, batch, T, Dm, N,
              dtype, stream);
}

// mamba_scan_launch that also writes edges [B, ceil(T / 16), ceil(N / 4),
// Dm, 4] fp32, the state entering each window of 16 steps (training's
// forward).
extern "C" int mamba_scan_train_launch(const void* x, const void* delta,
                                       const void* A, const void* Bm,
                                       const void* Cm, const void* Dp,
                                       void* y, void* h_out, void* edges,
                                       int batch, int T, int Dm, int N,
                                       int dtype, void* stream) {
  return scan(x, delta, A, Bm, Cm, Dp, y, h_out, edges, batch, T, Dm, N,
              dtype, stream);
}
