// Blocked online-softmax prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas -> _flash_kernel).  For every batch b, query head
// h and query row i (absolute position qpos = i + S - T: the queries sit at
// the tail of the context):
//
//   o[b,h,i,:] = sum_j softmax_j(scale * q[b,h,i,:] . k[b,h/G,j,:]) v[b,h/G,j,:]
//
// over the keys j the row may see: j <= qpos when causal, j > qpos - window
// when a window is given, and j < S.  G = Hq / Hkv (GQA: q head h reads kv
// head h / G, as jnp.repeat along heads).  A row that sees no key gives 0.
//
// Design.  The TPU kernel runs a sequential grid over KV blocks and carries
// the accumulator in VMEM from one grid step to the next.  Blocks of a GPU
// grid run in no order, so here one block owns a tile of BQ = 64 query rows
// of one (batch, q head) and loops over the KV tiles that tile can reach
// (the causal bound and the window bound), skipping the rest.  A tile of K
// and V (BK rows) is staged in shared memory as fp32 and shared by the 64
// rows.  Four threads own one query row: they compute its scores for
// BK / 4 keys each, take the row max and sum with two shuffles, and each
// keeps a quarter of the row's fp32 accumulator in registers (d = lane4 +
// 4 i).  The running max m and sum l live in registers, replicated over the
// four threads, so the online softmax needs no shared state.  Ragged T and
// S are masked in the kernel (the Pallas kernel required T % block_q == 0).
// Shared-memory rows are padded to D + 1 floats so the strided reads hit
// distinct banks.
//
// Bound.  At the serve path's prefill (B = 1, Hq = 32, Hkv = 16, T = S =
// 1536, D = 128, bf16) a layer does 4 * Hq * D * (visible pairs) flops:
// 19.3 GFLOP causal, 17.2 GFLOP with the 1024 window, which the tensor
// cores could do in about 0.02 ms; its bytes (q, k, v, o: 37.7 MB) take
// 0.011 ms at 3.35 TB/s.  So it is bound by operations.  This kernel does
// its products on the fp32 CUDA cores (67 TFLOP/s at most) from shared
// memory, so it cannot come near that bound: wgmma tiles fed by TMA are the
// work of a later change.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                         // query rows per block
constexpr int kLanesPerRow = kThreads / kBQ;   // 4 threads own one row

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Stage rows [row0, row0 + n_rows) of a [rows_total, D] matrix into shared
// memory as fp32 with row stride `ld`, 16-byte loads; rows past rows_total
// read as zeros.  D * sizeof(T) is a multiple of 16 (checked by the host).
template <typename T>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int ld,
                                           const T* __restrict__ src,
                                           int row0, int n_rows,
                                           int rows_total, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs_per_row = D / kVec;
  const int total = n_rows * vecs_per_row;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / vecs_per_row;
    const int c = (idx - r * vecs_per_row) * kVec;
    float* out = dst + r * ld + c;
    if (row0 + r < rows_total) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * D + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = to_float(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = 0.f;
    }
  }
}

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Hq, int Hkv, int T_len, int S, int D, float scale,
                       int causal, int window) {
  constexpr int kKeysPerLane = BK / kLanesPerRow;
  constexpr int kAccPerLane = DMAX / kLanesPerRow;
  extern __shared__ float smem[];
  const int ldq = D + 1;
  float* q_s = smem;                        // [kBQ][D + 1]
  float* k_s = q_s + kBQ * ldq;             // [BK][D + 1]
  float* v_s = k_s + BK * ldq;              // [BK][D]
  float* p_s = v_s + BK * D;                // [kBQ][BK + 1]

  const int q_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = q_tile * kBQ;
  const int off = S - T_len;

  const T* qb = q + (static_cast<int64_t>(b) * Hq + h) * T_len * D;
  const T* kb = k + (static_cast<int64_t>(b) * Hkv + hk) * S * D;
  const T* vb = v + (static_cast<int64_t>(b) * Hkv + hk) * S * D;
  T* ob = o + (static_cast<int64_t>(b) * Hq + h) * T_len * D;

  const int row = threadIdx.x / kLanesPerRow;   // 0 .. kBQ-1
  const int lane4 = threadIdx.x % kLanesPerRow;
  const int qpos = q0 + row + off;

  // KV range the tile's rows can reach (absolute key positions)
  const int tile_rows = min(kBQ, T_len - q0);
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + tile_rows - 1 + off + 1);
  if (window >= 0) k_lo = max(0, q0 + off - window + 1);

  stage_rows<T>(q_s, ldq, qb, q0, kBQ, T_len, D);

  float acc[kAccPerLane];
#pragma unroll
  for (int i = 0; i < kAccPerLane; ++i) acc[i] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int kv0 = (k_lo / BK) * BK; kv0 < k_hi; kv0 += BK) {
    __syncthreads();  // the previous tile's k_s / v_s are no longer read
    stage_rows<T>(k_s, ldq, kb, kv0, BK, S, D);
    stage_rows<T>(v_s, D, vb, kv0, BK, S, D);
    __syncthreads();

    float s[kKeysPerLane];
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) s[c] = 0.f;
    const float* qrow = q_s + row * ldq;
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c)
        s[c] = fmaf(qv, k_s[(lane4 + kLanesPerRow * c) * ldq + d], s[c]);
    }

    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const int kpos = kv0 + lane4 + kLanesPerRow * c;
      bool ok = kpos < S;
      if (causal) ok = ok && kpos <= qpos;
      if (window >= 0) ok = ok && kpos > qpos - window;
      s[c] = ok ? s[c] * scale : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[c]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    // a row with nothing visible so far keeps m = -inf and l = 0
    const float alpha = (m == -CUDART_INF_F) ? 0.f : expf(m - m_new);
    float psum = 0.f;
    float* prow = p_s + row * (BK + 1);
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const float p = (s[c] == -CUDART_INF_F) ? 0.f : expf(s[c] - m_new);
      psum += p;
      prow[lane4 + kLanesPerRow * c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's four lanes share a warp: p_s row is written

#pragma unroll
    for (int i = 0; i < kAccPerLane; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float* vrow = v_s + j * D + lane4;
#pragma unroll
      for (int i = 0; i < kAccPerLane; ++i) {
        if (lane4 + kLanesPerRow * i < D)
          acc[i] = fmaf(p, vrow[kLanesPerRow * i], acc[i]);
      }
    }
    __syncwarp();  // p_s row is read before the next tile overwrites it
  }

  if (row < tile_rows) {
    const float inv = (l == 0.f) ? 0.f : 1.f / l;
    T* orow = ob + static_cast<int64_t>(q0 + row) * D;
#pragma unroll
    for (int i = 0; i < kAccPerLane; ++i) {
      const int d = lane4 + kLanesPerRow * i;
      if (d < D) orow[d] = from_float<T>(acc[i] * inv);
    }
  }
}

template <typename T, int DMAX, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int T_len, int S, int D, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBQ) * (D + 1) + static_cast<size_t>(BK) * (D + 1) +
       static_cast<size_t>(BK) * D + static_cast<size_t>(kBQ) * (BK + 1));
  auto kernel = flash_attention_kernel<T, DMAX, BK>;
  // above 48 KB only as opted-in dynamic shared memory; set once per
  // instantiation, outside any CUDA graph capture that replays the launch
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) *
                         (kBQ * (DMAX + 1) + BK * (DMAX + 1) + BK * DMAX +
                          kBQ * (BK + 1))));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((T_len + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, T_len, S, D,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int T_len, int S, int D, float scale,
               int causal, int window, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32, 64>(q, k, v, o, B, Hq, Hkv, T_len, S, D, scale,
                             causal, window, stream);
  if (D <= 64)
    return launch<T, 64, 64>(q, k, v, o, B, Hq, Hkv, T_len, S, D, scale,
                             causal, window, stream);
  if (D <= 128)
    return launch<T, 128, 32>(q, k, v, o, B, Hq, Hkv, T_len, S, D, scale,
                              causal, window, stream);
  return launch<T, 256, 32>(q, k, v, o, B, Hq, Hkv, T_len, S, D, scale,
                            causal, window, stream);
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  q/o are
// contiguous [B, Hq, T, D], k/v contiguous [B, Hkv, S, D], all of one dtype
// (dtype 0: float32, 1: bfloat16), 16-byte aligned.  window < 0 means no
// window.  The host checks Hq % Hkv == 0, D % 8 == 0 and 8 <= D <= 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int T_len, int S, int D,
                                      float scale, int causal, int window,
                                      int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || T_len <= 0 || D <= 0 || D > 256 || Hkv <= 0 ||
      Hq % Hkv != 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Hq, Hkv, T_len, S, D, scale,
                             causal, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, T_len, S, D,
                                     scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
