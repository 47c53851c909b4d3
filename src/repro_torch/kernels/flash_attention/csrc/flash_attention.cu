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
// Given an lse buffer (training), both routes also write each row's
// log-sum-exp of the scaled scores, fp32 [B, Hq, T] (+inf for a row that
// sees no key), which the backward (flash_attention_bwd.cu) reads; serve
// launches pass null and write nothing more.
//
// Bound.  At the serve path's prefill (B = 1, Hq = 32, Hkv = 16, T = S =
// 1536, D = 128, bf16) a layer does 4 * Hq * D * (visible pairs) flops:
// 19.3 GFLOP causal, 17.2 GFLOP with the 1024 window, which the bf16
// tensor cores (989 TFLOP/s) could do in about 0.02 ms; its bytes (q, k, v,
// o: 37.7 MB) take 0.011 ms at 3.35 TB/s.  So it is bound by operations,
// and only the tensor cores come near that bound.
//
// Two routes, chosen by the host from the dtype and D before the launch
// (kernel.py: flash_route):
//
// * The tensor-core route (bf16, D % 16 == 0), flash_attention_kernel_tc.
//   The TPU kernel runs a sequential grid over KV blocks and carries the
//   accumulator in VMEM between grid steps; here one block owns 64 * NWG
//   query rows of one (batch, q head) and loops over the KV tiles those
//   rows can reach, skipping the rest (past the causal diagonal, before the
//   window's edge); only the diagonal, edge and ragged tiles are masked.
//   One producer warp keeps a ring of NST stages of K and V tiles (64 keys
//   x D) full with TMA loads, each stage with a "full" and an "empty"
//   mbarrier, and loads Q once.  TMA writes every tile in 128-byte
//   swizzled rows of 64 columns, the layout wgmma's shared-memory
//   descriptors read; rows past T or S and columns past D arrive as zeros,
//   which also pads any D % 16 == 0 up to the instantiated width DP (64,
//   128 or 256).  Each consumer warpgroup owns 64 rows: S = Q K^T by
//   wgmma m64n64k16 (both operands in shared memory, fp32 accumulators),
//   the online softmax on the accumulator fragments in registers (exp2
//   with scale * log2 e folded in, row max and sum over the four lanes of
//   a quad), then P, rounded to bf16 in registers, is the register A
//   operand of wgmma m64n64k16 against V read through the transposed-B
//   descriptor; O stays in fp32 registers.  Blocks run longest first (the
//   last query tile first), which balances the causal triangle over the
//   132 SMs.
//
// * The SIMT route (fp32, and bf16 with D % 16 != 0),
//   flash_attention_kernel: one block per 64-query tile on the fp32 CUDA
//   cores.  It is the exact route: fp32 on the tensor cores would be TF32.
//   A tile of K and V (BK rows) is staged in shared memory as fp32 and
//   shared by the 64 rows.  Four threads own one query row: they compute
//   its scores for BK / 4 keys each, take the row max and sum with two
//   shuffles, and each keeps a quarter of the row's fp32 accumulator in
//   registers (d = lane4 + 4 i).  The running max m and sum l live in
//   registers, replicated over the four threads, so the online softmax
//   needs no shared state.  Shared-memory rows are padded to D + 1 floats
//   so the strided reads hit distinct banks.  It does its products on the
//   fp32 CUDA cores (67 TFLOP/s at most).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper_tc.cuh"

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
                       float* __restrict__ lse, int Hq, int Hkv, int T_len,
                       int S, int D, float scale, int causal, int window) {
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
    // the row's log-sum-exp of the scaled scores, for the backward; +inf
    // where the row sees no key (its probabilities are then all 0)
    if (lse != nullptr && lane4 == 0)
      lse[(static_cast<int64_t>(b) * Hq + h) * T_len + q0 + row] =
          (l == 0.f) ? CUDART_INF_F : m + logf(l);
  }
}

template <typename T, int DMAX, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int T_len, int S, int D, float scale,
           int causal, int window, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, T_len, S,
      D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int T_len, int S, int D,
               float scale, int causal, int window, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32, 64>(q, k, v, o, lse, B, Hq, Hkv, T_len, S, D, scale,
                             causal, window, stream);
  if (D <= 64)
    return launch<T, 64, 64>(q, k, v, o, lse, B, Hq, Hkv, T_len, S, D, scale,
                             causal, window, stream);
  if (D <= 128)
    return launch<T, 128, 32>(q, k, v, o, lse, B, Hq, Hkv, T_len, S, D,
                              scale, causal, window, stream);
  return launch<T, 256, 32>(q, k, v, o, lse, B, Hq, Hkv, T_len, S, D, scale,
                            causal, window, stream);
}


__global__ void fill_inf(float* __restrict__ x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = CUDART_INF_F;
}

// ---------------------------------------------------------------------------
// The tensor-core route: bf16, D % 16 == 0, D <= 256.
namespace tc {

constexpr int kBK = 64;        // keys per KV tile

// Shared memory of one block: Q [DP/64][BQ][64], then NST stages of K and
// of V, each [DP/64][64][64], all bf16 in 128-byte swizzled rows; then the
// barriers.
template <int DP, int NWG, int NST>
struct Smem {
  static constexpr int kBQ = 64 * NWG;
  static constexpr int kCB = DP / kColBlock;
  static constexpr int kQElems = kBQ * DP;
  static constexpr int kTileElems = kBK * DP;
  static constexpr size_t kBytes =
      2 * static_cast<size_t>(kQElems + 2 * NST * kTileElems) +
      8 * (1 + 2 * NST) + 1024;  // + alignment slack
};

template <int DP, int NWG, int NST>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
flash_attention_kernel_tc(__grid_constant__ const CUtensorMap map_q,
                          __grid_constant__ const CUtensorMap map_k,
                          __grid_constant__ const CUtensorMap map_v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Hq, int Hkv,
                          int T_len, int S, int D, float scale_log2,
                          int causal, int window) {
  using L = Smem<DP, NWG, NST>;
  constexpr int kBQ = L::kBQ;
  constexpr int kCB = L::kCB;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* k_s = q_s + L::kQElems;
  __nv_bfloat16* v_s = k_s + NST * L::kTileElems;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + NST * L::kTileElems);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NST;

  // longest tiles first: the last query tile reaches the most keys
  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int h = bh % Hq;
  const int b = bh / Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q0 = q_tile * kBQ;
  const int off = S - T_len;

  // KV tiles the block's rows can reach
  const int rows = min(kBQ, T_len - q0);
  const int k_hi = causal ? max(0, min(S, q0 + rows + off)) : S;
  const int k_lo = window >= 0 ? max(0, q0 + off - window + 1) : 0;
  const int kt_begin = k_lo / kBK;
  const int kt_end = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : kt_begin;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: one thread keeps the ring of K / V tiles full
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * L::kQElems);
      for (int c = 0; c < kCB; ++c)
        tma_load_3d(q_s + c * kBQ * kColBlock, &map_q, q_full, c * kColBlock,
                    q0, bh);
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int st = it % NST;
        if (it >= NST) mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * 2 * L::kTileElems);
        __nv_bfloat16* ks = k_s + st * L::kTileElems;
        __nv_bfloat16* vs = v_s + st * L::kTileElems;
        for (int c = 0; c < kCB; ++c) {
          tma_load_3d(ks + c * kBK * kColBlock, &map_k, &full[st],
                      c * kColBlock, kt * kBK, bkv);
          tma_load_3d(vs + c * kBK * kColBlock, &map_v, &full[st],
                      c * kColBlock, kt * kBK, bkv);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [q0 + 64 wg, + 64)
  const int wg = warp / 4;
  const int g = lane / 4;   // row within the warp's 8-row half
  const int tq = lane % 4;  // column pair within an 8-column block
  const int wrow0 = q0 + 64 * wg;                // first row of the warpgroup
  const int r0 = wrow0 + 16 * (warp % 4) + g;    // this thread's two rows
  const int r1 = r0 + 8;
  const int qp0 = r0 + off, qp1 = r1 + off;      // their context positions
  const bool wg_live = wrow0 < T_len;
  const int wq_first = wrow0 + off;
  const int wq_last = min(wrow0 + 63, T_len - 1) + off;
  const int wg_hi = causal ? min(S, wq_last + 1) : S;
  const int wg_lo = window >= 0 ? max(0, wq_first - window + 1) : 0;

  float acc[kCB][32];
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  }
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max (raw scores)
  float l0 = 0.f, l1 = 0.f;                      // this thread's partial sums

  mbar_wait(q_full, 0);
  const __nv_bfloat16* q_wg = q_s + 64 * wg * kColBlock;

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int st = it % NST;
    mbar_wait(&full[st], (it / NST) & 1);
    const int kv0 = kt * kBK;
    if (wg_live && kv0 < wg_hi && kv0 + kBK > wg_lo) {
      const __nv_bfloat16* ks = k_s + st * L::kTileElems;
      const __nv_bfloat16* vs = v_s + st * L::kTileElems;

      // S = Q K^T on the tensor cores
      float s[32];
      fence_acc(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk / 4, w = (kk % 4) * 16;
        wgmma_ss(s,
                 sw128_desc(q_wg + c * kBQ * kColBlock + w, 16),
                 sw128_desc(ks + c * kBK * kColBlock + w, 16), kk > 0);
      }
      wgmma_commit_and_wait();
      fence_acc(s);

      // masks only on the diagonal, window-edge and ragged tiles
      const bool need_mask =
          kv0 + kBK > S || (causal && kv0 + kBK - 1 > wq_first) ||
          (window >= 0 && kv0 <= wq_last - window);
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = kv0 + 8 * i + 2 * tq + (j & 1);
            const int qp = (j & 2) ? qp1 : qp0;
            bool ok = key < S;
            if (causal) ok = ok && key <= qp;
            if (window >= 0) ok = ok && key > qp - window;
            if (!ok) s[4 * i + j] = -CUDART_INF_F;
          }
        }
      }

      // online softmax on the fragments: a quad of lanes holds a row
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with nothing visible yet keeps m = -inf: its p and alpha are 0
      const float mu0 = mn0 == -CUDART_INF_F ? 0.f : mn0 * scale_log2;
      const float mu1 = mn1 == -CUDART_INF_F ? 0.f : mn1 * scale_log2;
      const float alpha0 = exp2f(m0 * scale_log2 - mu0);
      const float alpha1 = exp2f(m1 * scale_log2 - mu1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[4 * i] = exp2f(fmaf(s[4 * i], scale_log2, -mu0));
        s[4 * i + 1] = exp2f(fmaf(s[4 * i + 1], scale_log2, -mu0));
        s[4 * i + 2] = exp2f(fmaf(s[4 * i + 2], scale_log2, -mu1));
        s[4 * i + 3] = exp2f(fmaf(s[4 * i + 3], scale_log2, -mu1));
        ps0 += s[4 * i] + s[4 * i + 1];
        ps1 += s[4 * i + 2] + s[4 * i + 3];
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;

      // P as bf16 A fragments: the accumulator layout of S is the
      // register-A layout of P, 16 keys per fragment
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O = O * alpha + P V on the tensor cores
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[c][4 * i] *= alpha0;
          acc[c][4 * i + 1] *= alpha0;
          acc[c][4 * i + 2] *= alpha1;
          acc[c][4 * i + 3] *= alpha1;
        }
        fence_acc(acc[c]);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16 keys a step: two 8-row groups
          wgmma_rs_tb(acc[c], pa[kk],
                      sw128_desc(vs + (c * kBK + kk * 16) * kColBlock,
                                 kBK * kColBlock * 2));
      }
      wgmma_commit_and_wait();
#pragma unroll
      for (int c = 0; c < kCB; ++c) fence_acc(acc[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // normalise and store the rows inside T
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (lse != nullptr && tq == 0) {
    // log-sum-exp of the scaled scores: p = 2^((s - m) scale_log2), so
    // lse = (m scale_log2 + log2 l) ln 2; +inf where a row sees no key
    constexpr float kLn2 = 0.69314718055994531f;
    float* lb = lse + static_cast<int64_t>(bh) * T_len;
    if (r0 < T_len)
      lb[r0] = l0 > 0.f ? (m0 * scale_log2 + log2f(l0)) * kLn2 : CUDART_INF_F;
    if (r1 < T_len)
      lb[r1] = l1 > 0.f ? (m1 * scale_log2 + log2f(l1)) * kLn2 : CUDART_INF_F;
  }
  __nv_bfloat16* ob =
      o + static_cast<int64_t>(bh) * T_len * D;
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = c * kColBlock + 8 * i + 2 * tq;
      if (col < D) {
        if (r0 < T_len)
          *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(r0) * D +
                                       col) =
              pack_bf16(acc[c][4 * i] * inv0, acc[c][4 * i + 1] * inv0);
        if (r1 < T_len)
          *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(r1) * D +
                                       col) =
              pack_bf16(acc[c][4 * i + 2] * inv1, acc[c][4 * i + 3] * inv1);
      }
    }
  }
}

template <int DP, int NWG, int NST>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int T_len, int S, int D, float scale,
           int causal, int window, cudaStream_t stream) {
  using L = Smem<DP, NWG, NST>;
  CUtensorMap map_q, map_k, map_v;
  if (!encode_map(&map_q, q, D, T_len, B * Hq, L::kBQ) ||
      !encode_map(&map_k, k, D, S, B * Hkv, kBK) ||
      !encode_map(&map_v, v, D, S, B * Hkv, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_kernel_tc<DP, NWG, NST>;
  // above 48 KB only as opted-in dynamic shared memory; set once per
  // instantiation, outside any CUDA graph capture that replays the launch
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(B * Hq, (T_len + L::kBQ - 1) / L::kBQ);
  kernel<<<grid, 128 * NWG + 32, L::kBytes, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv,
      T_len, S, D, scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Launch the SIMT route on `stream`; returns a cudaError_t (0 on success).
// q/o are contiguous [B, Hq, T, D], k/v contiguous [B, Hkv, S, D], all of
// one dtype (dtype 0: float32, 1: bfloat16), 16-byte aligned.  window < 0
// means no window.  lse, when not null, is fp32 [B, Hq, T] and receives
// each row's log-sum-exp (the backward's input); serve launches pass null.
// The host checks Hq % Hkv == 0, D % 8 == 0 and 8 <= D <= 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Hq, int Hkv, int T_len,
                                      int S, int D, float scale, int causal,
                                      int window, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || T_len <= 0 || D <= 0 || D > 256 || Hkv <= 0 ||
      Hq % Hkv != 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, lse_f, B, Hq, Hkv, T_len, S, D,
                             scale, causal, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse_f, B, Hq, Hkv, T_len, S,
                                     D, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch the tensor-core route on `stream`: bf16 only, layouts and lse as
// above, D % 16 == 0 and D <= 256.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int Hq, int Hkv, int T_len,
                                         int S, int D, float scale,
                                         int causal, int window,
                                         void* stream) {
  if (B <= 0 || Hq <= 0 || T_len <= 0 || D <= 0 || D > 256 || D % 16 != 0 ||
      Hkv <= 0 || Hq % Hkv != 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (S == 0) {  // no key: every row gives 0, and its lse is +inf
    if (lse_f != nullptr) {
      const int rows = B * Hq * T_len;
      fill_inf<<<(rows + 255) / 256, 256, 0, st>>>(lse_f, rows);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaMemsetAsync(
        o, 0, static_cast<size_t>(B) * Hq * T_len * D * 2, st));
  }
  if (D <= 64)
    return tc::launch<64, 2, 3>(q, k, v, o, lse_f, B, Hq, Hkv, T_len, S, D,
                                scale, causal, window, st);
  if (D <= 128)
    return tc::launch<128, 2, 3>(q, k, v, o, lse_f, B, Hq, Hkv, T_len, S, D,
                                 scale, causal, window, st);
  // one consumer warpgroup: with two, the block's 288 threads are given
  // registers as if they were 384 (168 a thread), and 128 fp32 accumulators
  // of O spill
  return tc::launch<256, 1, 3>(q, k, v, o, lse_f, B, Hq, Hkv, T_len, S, D,
                               scale, causal, window, st);
}
