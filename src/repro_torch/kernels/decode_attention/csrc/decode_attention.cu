// Single-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas -> _decode_kernel).  For every batch row b and
// query head h, with n = cache_len[b]:
//
//   o[b,h,:] = sum_j softmax_j(scale * q[b,h,:] . k[b,h/G,j,:]) v[b,h/G,j,:]
//
// over the cache slots j in [max(0, n - window), min(n, S)) (no window: from
// 0).  G = Hq / Hkv.  A row with no valid slot gives 0.
//
// Design.  One block per (kv head, batch row) serves the G query heads
// that share the kv head, so each K and V row is read from device memory
// once for all of them.  The TPU kernel padded the group to 8 rows for the
// TPU's sublane minimum; here the group is taken as it is.  The block reads
// its cache_len from device memory (no host sync), skips the slots outside
// the valid range, and streams the rest in tiles of BK rows: 16-byte
// coalesced loads into shared memory as fp32, scores by (row, key) pairs,
// an online softmax per row (one warp per row, shuffle reductions), then
// P.V with each thread owning (row, d) outputs.  The fp32 accumulator, the
// running max and sum live in shared memory, which keeps the kernel one
// instantiation per dtype for any G and any D up to 256.
//
// Bound.  Decode reads the valid prefix of the cache once and does 4 flops
// per cached element per query head in the group: at the serve path's
// shape (B = 4, Hq = 32, Hkv = 16, S = 2048, D = 128, bf16, G = 2) that is
// 1 flop per byte, far below the card's ~295 flops per byte, so it is
// bound by bytes.  One block per (kv head, batch row) gives only 64 blocks
// for 132 SMs there; splitting the KV range over more blocks (split-KV) and
// TMA-fed tiles are the work of a later change.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;  // cache rows per tile

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

// Stage rows [row0, row0 + n_rows) of a [.., D] matrix as fp32 with row
// stride `ld`; rows at or past row_end read as zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int ld,
                                           const T* __restrict__ src,
                                           int row0, int n_rows, int row_end,
                                           int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs_per_row = D / kVec;
  const int total = n_rows * vecs_per_row;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / vecs_per_row;
    const int c = (idx - r * vecs_per_row) * kVec;
    float* out = dst + r * ld + c;
    if (row0 + r < row_end) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ cache_len,
                        T* __restrict__ o, int Hq, int Hkv, int S, int D,
                        float scale, int window) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int ld = D + 1;
  float* q_s = smem;                    // [G][D + 1]
  float* k_s = q_s + G * ld;            // [kBK][D + 1]
  float* v_s = k_s + kBK * ld;          // [kBK][D]
  float* p_s = v_s + kBK * D;           // [G][kBK + 1]
  float* acc_s = p_s + G * (kBK + 1);   // [G][D]
  float* m_s = acc_s + G * D;           // [G]
  float* l_s = m_s + G;                 // [G]
  float* alpha_s = l_s + G;             // [G]

  const int n = cache_len[b];
  const int hi = min(n, S);
  const int lo = window >= 0 ? max(0, n - window) : 0;

  const T* qb = q + (static_cast<int64_t>(b) * Hq + hk * G) * D;
  const T* kb = k + (static_cast<int64_t>(b) * Hkv + hk) * S * D;
  const T* vb = v + (static_cast<int64_t>(b) * Hkv + hk) * S * D;
  T* ob = o + (static_cast<int64_t>(b) * Hq + hk * G) * D;

  stage_rows<T>(q_s, ld, qb, 0, G, G, D);
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) acc_s[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_s[g] = -CUDART_INF_F;
    l_s[g] = 0.f;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;

  for (int kv0 = (lo / kBK) * kBK; kv0 < hi; kv0 += kBK) {
    __syncthreads();  // the previous tile is fully consumed
    stage_rows<T>(k_s, ld, kb, kv0, kBK, hi, D);
    stage_rows<T>(v_s, D, vb, kv0, kBK, hi, D);
    __syncthreads();

    // scores of every (row, key) pair of the tile
    for (int idx = threadIdx.x; idx < G * kBK; idx += blockDim.x) {
      const int g = idx / kBK;
      const int j = idx - g * kBK;
      const float* qrow = q_s + g * ld;
      const float* krow = k_s + j * ld;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
      const int pos = kv0 + j;
      const bool ok = pos >= lo && pos < hi;
      p_s[g * (kBK + 1) + j] = ok ? s * scale : -CUDART_INF_F;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int g = warp; g < G; g += n_warps) {
      float* prow = p_s + g * (kBK + 1);
      float tmax = -CUDART_INF_F;
      for (int j = lane; j < kBK; j += 32) tmax = fmaxf(tmax, prow[j]);
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, sh));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.f;
      for (int j = lane; j < kBK; j += 32) {
        const float s = prow[j];
        const float p = (s == -CUDART_INF_F) ? 0.f : expf(s - m_new);
        prow[j] = p;
        psum += p;
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, sh);
      if (lane == 0) {
        const float alpha = (m_old == -CUDART_INF_F) ? 0.f : expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
    for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
      const int g = idx / D;
      const int d = idx - g * D;
      const float* prow = p_s + g * (kBK + 1);
      float a = acc_s[idx] * alpha_s[g];
      for (int j = 0; j < kBK; ++j) a = fmaf(prow[j], v_s[j * D + d], a);
      acc_s[idx] = a;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const float l = l_s[g];
    ob[idx] = from_float<T>(l == 0.f ? 0.f : acc_s[idx] / l);
  }
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) *
         (static_cast<size_t>(G) * (D + 1) + static_cast<size_t>(kBK) * (D + 1) +
          static_cast<size_t>(kBK) * D + static_cast<size_t>(G) * (kBK + 1) +
          static_cast<size_t>(G) * D + 3 * static_cast<size_t>(G));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* o, int B, int Hq, int Hkv, int S, int D, float scale,
           int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(Hq / Hkv, D);
  auto kernel = decode_attention_kernel<T>;
  // opt in once to the most shared memory a block may take; done outside
  // any CUDA graph capture that replays the launch
  static int opted_in = 0;
  if (!opted_in) {
    int dev = 0, max_optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = max_optin;
  }
  if (smem > static_cast<size_t>(opted_in))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lens),
      static_cast<T*>(o), Hq, Hkv, S, D, scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  q/o are
// contiguous [B, Hq, D], k/v contiguous [B, Hkv, S, D] of one dtype
// (dtype 0: float32, 1: bfloat16), 16-byte aligned; cache_len is int32[B]
// on the device.  window < 0 means no window.  The host checks
// Hq % Hkv == 0, D % 8 == 0 and 8 <= D <= 256.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* cache_len,
                                       void* o, int B, int Hq, int Hkv, int S,
                                       int D, float scale, int window,
                                       int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 ||
      D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, cache_len, o, B, Hq, Hkv, S, D, scale,
                         window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, cache_len, o, B, Hq, Hkv, S, D,
                                 scale, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
