// Backward of blocked prefill attention for Hopper (sm_90a): dQ, dK, dV.
//
// The gradient of the function that flash_attention.cu computes, which
// replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas).  No Pallas kernel has a backward: the JAX
// training path differentiates its jnp reference by XLA's autodiff
// (repro/models/attention.py, use_pallas=False).  This kernel computes the
// same gradient.  With s = scale * q . k over the keys a row may see (the
// forward's causal / window / tail convention) and lse the row's
// log-sum-exp that the forward wrote:
//
//   P     = exp(s - lse)                  (0 where masked)
//   delta = sum_d dO . O                  (per query row)
//   dV    = P^T dO
//   dS    = P o (dO V^T - delta)
//   dQ    = scale * dS K
//   dK    = scale * dS^T Q
//
// summed over the G = Hq / Hkv query heads that share a KV head for dK and
// dV.  Everything accumulates in fp32; inputs and gradients are fp32 or
// bf16 (one type).  A row that sees no key has lse = +inf and gives zero
// gradients, never NaN.
//
// Bound.  Five products of the visible (query, key) pairs, 10 * Hq * D
// flops a pair: at the training path (B = 1, Hq = 24, Hkv = 8, T = S =
// 4096, D = 128, causal, bf16) 258 GFLOP, 0.26 ms on the bf16 tensor cores
// (989 TFLOP/s); its bytes (q, k, v, o, dO, lse in; dq, dk, dv out) take
// 0.03 ms at 3.35 TB/s.  It is bound by operations.
//
// Design: FlashAttention-2's backward without atomics, on the fp32 CUDA
// cores (SIMT; the tensor cores wait for a later round), in three launches:
//
// * attn_bwd_preprocess: delta, one warp a row;
// * attn_bwd_dkdv: one block per (batch, KV head, tile of BKV keys).  The
//   tile's K and V are staged once in shared memory as fp32; the block then
//   loops over the group's query heads and over the query tiles (BQ rows)
//   that can see the tile, recomputes S and dO V^T for the tile pair (a
//   thread computes a 4 x 4 or 2 x 2 patch, rows sy + 16 a, keys sx + 16 b),
//   writes P and dS to shared memory, and adds P^T dO and dS^T Q into
//   registers (a thread owns keys ty + 8 a and head-dim columns tx + 32 c,
//   so the column loads of a warp are consecutive).  dK and dV are written
//   once, by the block that owns the tile;
// * attn_bwd_dq: one block per (batch, query head, tile of BQ rows), the
//   longest tiles first; it loops over the KV tiles the rows see,
//   recomputes S, P, dO V^T and dS, and adds dS K into registers (rows
//   ty + 8 a, columns tx + 32 c); dQ is written once.
//
// Every sum has one owner and a fixed order, so two identical calls give
// bit-identical gradients.  Shared-memory rows are padded to D + 1 floats
// (D + 1 is odd) so that the strided reads of 16 rows hit distinct banks.
// Tiles: D <= 64 and D <= 128 take BQ = BKV = 64; D <= 256 takes BQ = BKV
// = 32, which keeps the staged tiles inside the 227 KB of shared memory a
// block may have and the accumulators at 32 a thread.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

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

// Each row's lse and delta into shared memory (0 past the last row).
__device__ __forceinline__ void stage_stats(float* __restrict__ lse_s,
                                            float* __restrict__ dl_s,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            int row0, int n_rows,
                                            int rows_total) {
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    const bool in = row0 + r < rows_total;
    lse_s[r] = in ? lse[row0 + r] : 0.f;
    dl_s[r] = in ? delta[row0 + r] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int i, int key, int T_len, int S,
                                        int off, int causal, int window) {
  const int qpos = i + off;
  bool ok = i < T_len && key < S;
  if (causal) ok = ok && key <= qpos;
  if (window >= 0) ok = ok && key > qpos - window;
  return ok;
}

// The thread's patch of S = Q K^T and of dP = dO V^T for one (query tile,
// key tile) pair, both read from shared memory: rows sy + 16 a, keys
// sx + 16 b.
template <int SR, int SC>
__device__ __forceinline__ void scores(float (&s)[SR][SC], float (&dp)[SR][SC],
                                       const float* __restrict__ q_s,
                                       const float* __restrict__ do_s,
                                       const float* __restrict__ k_s,
                                       const float* __restrict__ v_s, int ld,
                                       int D, int sy, int sx) {
#pragma unroll
  for (int a = 0; a < SR; ++a) {
#pragma unroll
    for (int b = 0; b < SC; ++b) s[a][b] = dp[a][b] = 0.f;
  }
  for (int d = 0; d < D; ++d) {
    float qv[SR], dov[SR], kv[SC], vv[SC];
#pragma unroll
    for (int a = 0; a < SR; ++a) {
      qv[a] = q_s[(sy + 16 * a) * ld + d];
      dov[a] = do_s[(sy + 16 * a) * ld + d];
    }
#pragma unroll
    for (int b = 0; b < SC; ++b) {
      kv[b] = k_s[(sx + 16 * b) * ld + d];
      vv[b] = v_s[(sx + 16 * b) * ld + d];
    }
#pragma unroll
    for (int a = 0; a < SR; ++a) {
#pragma unroll
      for (int b = 0; b < SC; ++b) {
        s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
        dp[a][b] = fmaf(dov[a], vv[b], dp[a][b]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_preprocess(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + static_cast<int64_t>(row) * D;
  const T* drow = dout + static_cast<int64_t>(row) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_float(orow[d]), to_float(drow[d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int DMAX, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
              int T_len, int S, int D, float scale, int causal, int window) {
  constexpr int kCols = DMAX / 32;   // head-dim columns a thread owns
  constexpr int kKeys = BKV / 8;     // keys a thread owns
  constexpr int SR = BQ / 16, SC = BKV / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;                     // [BKV][ld]
  float* v_s = k_s + BKV * ld;           // [BKV][ld]
  float* q_s = v_s + BKV * ld;           // [BQ][ld]
  float* do_s = q_s + BQ * ld;           // [BQ][ld]
  float* p_s = do_s + BQ * ld;           // [BQ][BKV + 1]
  float* ds_s = p_s + BQ * (BKV + 1);    // [BQ][BKV + 1]
  float* lse_s = ds_s + BQ * (BKV + 1);  // [BQ]
  float* dl_s = lse_s + BQ;              // [BQ]

  const int kv0 = blockIdx.x * BKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int off = S - T_len;
  const int kv_last = min(kv0 + BKV, S) - 1;
  // the query rows that can see a key of the tile
  const int i_lo = causal ? max(0, kv0 - off) : 0;
  const int i_hi = window >= 0 ? min(T_len, kv_last + window - off) : T_len;

  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + hk) * S;
  stage_rows<T>(k_s, ld, k + kv_base * D, kv0, BKV, S, D);
  stage_rows<T>(v_s, ld, v + kv_base * D, kv0, BKV, S, D);

  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int sx = threadIdx.x % 16, sy = threadIdx.x / 16;
  float acc_dk[kKeys][kCols], acc_dv[kKeys][kCols];
#pragma unroll
  for (int a = 0; a < kKeys; ++a) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_dk[a][c] = acc_dv[a][c] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int64_t row_base = (static_cast<int64_t>(b) * Hq + hk * G + g) *
                             T_len;
    const T* qb = q + row_base * D;
    const T* dob = dout + row_base * D;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's q_s .. dl_s are no longer read
      stage_rows<T>(q_s, ld, qb, q0, BQ, T_len, D);
      stage_rows<T>(do_s, ld, dob, q0, BQ, T_len, D);
      stage_stats(lse_s, dl_s, lse + row_base, delta + row_base, q0, BQ,
                  T_len);
      __syncthreads();

      float s[SR][SC], dp[SR][SC];
      scores<SR, SC>(s, dp, q_s, do_s, k_s, v_s, ld, D, sy, sx);
#pragma unroll
      for (int a = 0; a < SR; ++a) {
#pragma unroll
        for (int bb = 0; bb < SC; ++bb) {
          const int r = sy + 16 * a, c = sx + 16 * bb;
          const float p =
              visible(q0 + r, kv0 + c, T_len, S, off, causal, window)
                  ? expf(fmaf(s[a][bb], scale, -lse_s[r]))
                  : 0.f;
          p_s[r * (BKV + 1) + c] = p;
          ds_s[r * (BKV + 1) + c] = p * (dp[a][bb] - dl_s[r]);
        }
      }
      __syncthreads();

      for (int r = 0; r < BQ; ++r) {
        float dov[kCols], qv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = tx + 32 * c;
          dov[c] = d < D ? do_s[r * ld + d] : 0.f;
          qv[c] = d < D ? q_s[r * ld + d] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kKeys; ++a) {
          const float p = p_s[r * (BKV + 1) + ty + 8 * a];
          const float ds = ds_s[r * (BKV + 1) + ty + 8 * a];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc_dv[a][c] = fmaf(p, dov[c], acc_dv[a][c]);
            acc_dk[a][c] = fmaf(ds, qv[c], acc_dk[a][c]);
          }
        }
      }
    }
  }

  T* dkb = dk + kv_base * D;
  T* dvb = dv + kv_base * D;
#pragma unroll
  for (int a = 0; a < kKeys; ++a) {
    const int j = kv0 + ty + 8 * a;
    if (j >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 32 * c;
      if (d < D) {
        dkb[static_cast<int64_t>(j) * D + d] =
            from_float<T>(acc_dk[a][c] * scale);
        dvb[static_cast<int64_t>(j) * D + d] = from_float<T>(acc_dv[a][c]);
      }
    }
  }
}

template <typename T, int DMAX, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dq, int Hq, int Hkv, int T_len, int S, int D,
            float scale, int causal, int window) {
  constexpr int kCols = DMAX / 32;   // head-dim columns a thread owns
  constexpr int kRows = BQ / 8;      // query rows a thread owns
  constexpr int SR = BQ / 16, SC = BKV / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;                     // [BQ][ld]
  float* do_s = q_s + BQ * ld;           // [BQ][ld]
  float* k_s = do_s + BQ * ld;           // [BKV][ld]
  float* v_s = k_s + BKV * ld;           // [BKV][ld]
  float* ds_s = v_s + BKV * ld;          // [BQ][BKV + 1]
  float* lse_s = ds_s + BQ * (BKV + 1);  // [BQ]
  float* dl_s = lse_s + BQ;              // [BQ]

  // longest tiles first: the last query tile sees the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = S - T_len;
  const int rows = min(BQ, T_len - q0);
  const int k_hi = causal ? max(0, min(S, q0 + rows + off)) : S;
  const int k_lo = window >= 0 ? max(0, q0 + off - window + 1) : 0;

  const int64_t row_base = (static_cast<int64_t>(b) * Hq + h) * T_len;
  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + hk) * S;
  stage_rows<T>(q_s, ld, q + row_base * D, q0, BQ, T_len, D);
  stage_rows<T>(do_s, ld, dout + row_base * D, q0, BQ, T_len, D);
  stage_stats(lse_s, dl_s, lse + row_base, delta + row_base, q0, BQ, T_len);

  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int sx = threadIdx.x % 16, sy = threadIdx.x / 16;
  float acc[kRows][kCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
  }

  for (int kv0 = (k_lo / BKV) * BKV; kv0 < k_hi; kv0 += BKV) {
    __syncthreads();  // the previous tile's k_s, v_s, ds_s are no longer read
    stage_rows<T>(k_s, ld, k + kv_base * D, kv0, BKV, S, D);
    stage_rows<T>(v_s, ld, v + kv_base * D, kv0, BKV, S, D);
    __syncthreads();

    float s[SR][SC], dp[SR][SC];
    scores<SR, SC>(s, dp, q_s, do_s, k_s, v_s, ld, D, sy, sx);
#pragma unroll
    for (int a = 0; a < SR; ++a) {
#pragma unroll
      for (int bb = 0; bb < SC; ++bb) {
        const int r = sy + 16 * a, c = sx + 16 * bb;
        const float p =
            visible(q0 + r, kv0 + c, T_len, S, off, causal, window)
                ? expf(fmaf(s[a][bb], scale, -lse_s[r]))
                : 0.f;
        ds_s[r * (BKV + 1) + c] = p * (dp[a][bb] - dl_s[r]);
      }
    }
    __syncthreads();

    for (int j = 0; j < BKV; ++j) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + 32 * c;
        kv[c] = d < D ? k_s[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const float ds = ds_s[(ty + 8 * a) * (BKV + 1) + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[a][c] = fmaf(ds, kv[c], acc[a][c]);
      }
    }
  }

  T* dqb = dq + row_base * D;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = q0 + ty + 8 * a;
    if (i >= T_len) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 32 * c;
      if (d < D)
        dqb[static_cast<int64_t>(i) * D + d] = from_float<T>(acc[a][c] * scale);
    }
  }
}

template <int BQ, int BKV>
constexpr size_t dkdv_floats(int d) {
  return static_cast<size_t>(2 * BKV + 2 * BQ) * (d + 1) +
         2 * static_cast<size_t>(BQ) * (BKV + 1) + 2 * BQ;
}
template <int BQ, int BKV>
constexpr size_t dq_floats(int d) {
  return static_cast<size_t>(2 * BKV + 2 * BQ) * (d + 1) +
         static_cast<size_t>(BQ) * (BKV + 1) + 2 * BQ;
}

template <typename T, int DMAX, int BQ, int BKV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Hq, int Hkv, int T_len, int S,
           int D, float scale, int causal, int window, cudaStream_t stream) {
  auto dkdv = attn_bwd_dkdv<T, DMAX, BQ, BKV>;
  auto dqk = attn_bwd_dq<T, DMAX, BQ, BKV>;
  // above 48 KB only as opted-in dynamic shared memory; set once per
  // instantiation, outside any CUDA graph capture that replays the launch
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * dkdv_floats<BQ, BKV>(DMAX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * dq_floats<BQ, BKV>(DMAX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int rows = B * Hq * T_len;
  attn_bwd_preprocess<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                           kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_kv((S + BKV - 1) / BKV, Hkv, B);
  dkdv<<<grid_kv, kThreads, sizeof(float) * dkdv_floats<BQ, BKV>(D),
         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, T_len, S, D, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q((T_len + BQ - 1) / BQ, Hq, B);
  dqk<<<grid_q, kThreads, sizeof(float) * dq_floats<BQ, BKV>(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Hq, Hkv, T_len, S, D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int T_len, int S,
               int D, float scale, int causal, int window,
               cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64, 64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 Hq, Hkv, T_len, S, D, scale, causal, window,
                                 stream);
  if (D <= 128)
    return launch<T, 128, 64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  B, Hq, Hkv, T_len, S, D, scale, causal,
                                  window, stream);
  return launch<T, 256, 32, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                Hq, Hkv, T_len, S, D, scale, causal, window,
                                stream);
}

}  // namespace

// Launch the backward on `stream`: three kernels (delta, dK/dV, dQ).
// Returns a cudaError_t (0 on success), checked after every launch.
// q/o/dout/dq are contiguous [B, Hq, T, D], k/v/dk/dv contiguous
// [B, Hkv, S, D], all of one dtype (dtype 0: float32, 1: bfloat16) and
// 16-byte aligned; lse (the forward's) and delta (scratch) are fp32
// [B, Hq, T].  window < 0 means no window.  The host checks
// Hq % Hkv == 0, D % 8 == 0 and 8 <= D <= 256.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int T_len, int S, int D, float scale,
    int causal, int window, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || T_len <= 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      Hkv <= 0 || Hq % Hkv != 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0) {  // no key: dQ is 0 and dK, dV are empty
    const size_t elem = dtype == 0 ? 4 : 2;
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, static_cast<size_t>(B) * Hq * T_len * D * elem, st));
  }
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, B,
                             Hq, Hkv, T_len, S, D, scale, causal, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, dout, lse_f, delta_f, dq, dk,
                                     dv, B, Hq, Hkv, T_len, S, D, scale,
                                     causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
