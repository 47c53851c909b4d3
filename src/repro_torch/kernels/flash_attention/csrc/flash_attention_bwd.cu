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
// gradients, never NaN.  Every output tile has one owner block and a fixed
// order of summation, with no atomics, so two identical calls give
// bit-identical gradients.
//
// Bound.  Five products of the visible (query, key) pairs, 10 * Hq * D
// flops a pair: at the training path (B = 1, Hq = 24, Hkv = 8, T = S =
// 4096, D = 128, causal, bf16) 258 GFLOP, 0.26 ms on the bf16 tensor cores
// (989 TFLOP/s); its bytes (q, k, v, o, dO, lse in; dq, dk, dv out) take
// 0.03 ms at 3.35 TB/s.  It is bound by operations, and only the tensor
// cores come near that bound.
//
// Two routes, chosen by the host from the dtype before the launch
// (kernel.py: flash_bwd_route), each three launches: delta, then dK / dV
// with one block per tile of keys, then dQ with one block per tile of
// query rows (which computes S and dP again: seven products, not five,
// the price of having no atomics).
//
// * The tensor-core route (bf16, every D the host admits: a multiple of 8
//   up to 256): attn_bwd_dkdv_tc and attn_bwd_dq_tc, built like the
//   forward's flash_attention_kernel_tc from the helpers in hopper_tc.cuh.
//   TMA writes every tile in 128-byte swizzled rows, D padded to DP = 64,
//   128 or 256 columns (rows past T or S and columns past D arrive as
//   zeros, so they add nothing to a product; TMA needs only rows of a
//   multiple of 16 bytes).
//   - dK / dV: a block owns 64 * NWG keys of one (batch, KV head); each
//     consumer warpgroup owns 64 of them and keeps its dK and dV in fp32
//     registers.  K and V are loaded once.  A producer warp streams the Q
//     and dO tiles (64 rows) of every query head of the group and every
//     query tile that can see the keys, with their lse and delta, through
//     a ring of NST stages with "full" and "empty" mbarriers.  For each
//     stage: S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 (both
//     operands in shared memory), P^T = exp2(S^T scale log2e - lse log2e)
//     (masked only on diagonal, window-edge and ragged tiles), dS^T =
//     P^T o (dP^T - delta), then dV += P^T dO and dK += dS^T Q with P^T and
//     dS^T as register A operands and dO, Q read through the transposed-B
//     descriptor.  With two consumer warpgroups the producer is a whole
//     warpgroup that gives its registers to them (setmaxnreg 40 / 232):
//     two 64 x 128 fp32 accumulators take 128 registers a thread, S^T and
//     dP^T 64 more.  At D = 256 a block owns half of dK's and dV's columns
//     (two blocks a key tile, each computing S^T and dP^T), which keeps
//     the accumulators at 128 registers.
//   - dQ: a block owns 64 * NWG query rows of one (batch, query head),
//     longest tiles first; a ring of K and V tiles (64 keys) as in the
//     forward; S = Q K^T and dP = dO V^T, P and dS as above, dQ += dS K with
//     K through the transposed-B descriptor.  dQ is written once.
//   The products take P and dS as bf16 A operands.  One bf16 rounding of
//   them (2^-9 relative) leaves the gradients about as far from the fp32
//   plain version as those of PyTorch's own backward, which rounds once:
//   2.5e-3 to 3.3e-3 in norm (chip_smoke.py, library_rel_norm_err), over
//   the 1e-3 this backward is held to.  So each is split into hi = bf16(x)
//   and lo = bf16(x - hi), and both are multiplied: x is carried to about
//   16 bits for twice the tensor-core work of those three products (ten
//   products a visible tile pair in all).
//
// * The SIMT route (fp32): FlashAttention-2's backward on the fp32 CUDA
//   cores, exact in fp32 (on the tensor cores fp32 would be TF32).
//   - attn_bwd_preprocess: delta, one warp a row;
//   - attn_bwd_dkdv: one block per (batch, KV head, tile of BKV keys).  The
//     tile's K and V are staged once in shared memory as fp32; the block
//     then loops over the group's query heads and over the query tiles (BQ
//     rows) that can see the tile, recomputes S and dO V^T for the tile
//     pair (a thread computes a 4 x 4 or 2 x 2 patch, rows sy + 16 a, keys
//     sx + 16 b), writes P and dS to shared memory, and sums P^T dO and
//     dS^T Q over the tile's BQ rows in registers (a thread owns keys
//     ty + 8 a and head-dim columns tx + 32 c, so the column loads of a
//     warp are consecutive), then adds the tile's sums to the running
//     ones.  Two chains, of BQ rows and of the G * T / BQ tiles: one chain
//     of all G * T rows a key sees lost accuracy as the group grew (at
//     mistral-large-123b's group of 12 and 4,096 queries, entries 6e-5
//     from the plain version, over its 1e-5 + 1e-4 |x|);
//   - attn_bwd_dq: one block per (batch, query head, tile of BQ rows), the
//     longest tiles first; it loops over the KV tiles the rows see,
//     recomputes S, P, dO V^T and dS, and adds dS K into registers (rows
//     ty + 8 a, columns tx + 32 c).
//   Shared-memory rows are padded to D + 1 floats (D + 1 is odd) so that
//   the strided reads of 16 rows hit distinct banks.  Tiles: D <= 64 and
//   D <= 128 take BQ = BKV = 64; D <= 256 takes BQ = BKV = 32, which keeps
//   the staged tiles inside the 227 KB of shared memory a block may have
//   and the accumulators at 32 a thread.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kThreads = 256;

// Stage rows [row0, row0 + n_rows) of a [rows_total, D] fp32 matrix into
// shared memory with row stride `ld`, 16-byte loads; rows past rows_total
// read as zeros.  D is a multiple of 4 (checked by the host).
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int ld,
                                           const float* __restrict__ src,
                                           int row0, int n_rows,
                                           int rows_total, int D) {
  constexpr int kVec = 4;
  const int vecs_per_row = D / kVec;
  const int total = n_rows * vecs_per_row;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / vecs_per_row;
    const int c = (idx - r * vecs_per_row) * kVec;
    float* out = dst + r * ld + c;
    if (row0 + r < rows_total) {
      const float4 vals = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(row0 + r) * D + c);
      out[0] = vals.x;
      out[1] = vals.y;
      out[2] = vals.z;
      out[3] = vals.w;
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

__global__ void __launch_bounds__(kThreads)
attn_bwd_preprocess(const float* __restrict__ o,
                    const float* __restrict__ dout,
                    float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* orow = o + static_cast<int64_t>(row) * D;
  const float* drow = dout + static_cast<int64_t>(row) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(orow[d], drow[d], acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

template <int DMAX, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv,
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
  stage_rows(k_s, ld, k + kv_base * D, kv0, BKV, S, D);
  stage_rows(v_s, ld, v + kv_base * D, kv0, BKV, S, D);

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
    const float* qb = q + row_base * D;
    const float* dob = dout + row_base * D;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's q_s .. dl_s are no longer read
      stage_rows(q_s, ld, qb, q0, BQ, T_len, D);
      stage_rows(do_s, ld, dob, q0, BQ, T_len, D);
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

      // the tile's sums over its rows, then into the running sums
      float tile_dk[kKeys][kCols], tile_dv[kKeys][kCols];
#pragma unroll
      for (int a = 0; a < kKeys; ++a) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) tile_dk[a][c] = tile_dv[a][c] = 0.f;
      }
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
            tile_dv[a][c] = fmaf(p, dov[c], tile_dv[a][c]);
            tile_dk[a][c] = fmaf(ds, qv[c], tile_dk[a][c]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kKeys; ++a) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_dv[a][c] += tile_dv[a][c];
          acc_dk[a][c] += tile_dk[a][c];
        }
      }
    }
  }

  float* dkb = dk + kv_base * D;
  float* dvb = dv + kv_base * D;
#pragma unroll
  for (int a = 0; a < kKeys; ++a) {
    const int j = kv0 + ty + 8 * a;
    if (j >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 32 * c;
      if (d < D) {
        dkb[static_cast<int64_t>(j) * D + d] = acc_dk[a][c] * scale;
        dvb[static_cast<int64_t>(j) * D + d] = acc_dv[a][c];
      }
    }
  }
}

template <int DMAX, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int Hq, int Hkv, int T_len, int S, int D,
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
  stage_rows(q_s, ld, q + row_base * D, q0, BQ, T_len, D);
  stage_rows(do_s, ld, dout + row_base * D, q0, BQ, T_len, D);
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
    stage_rows(k_s, ld, k + kv_base * D, kv0, BKV, S, D);
    stage_rows(v_s, ld, v + kv_base * D, kv0, BKV, S, D);
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

  float* dqb = dq + row_base * D;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = q0 + ty + 8 * a;
    if (i >= T_len) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 32 * c;
      if (d < D)
        dqb[static_cast<int64_t>(i) * D + d] = acc[a][c] * scale;
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

template <int DMAX, int BQ, int BKV>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* dq,
           float* dk, float* dv, int B, int Hq, int Hkv, int T_len, int S,
           int D, float scale, int causal, int window, cudaStream_t stream) {
  auto dkdv = attn_bwd_dkdv<DMAX, BQ, BKV>;
  auto dqk = attn_bwd_dq<DMAX, BQ, BKV>;
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
  attn_bwd_preprocess<<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                        kThreads, 0, stream>>>(o, dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_kv((S + BKV - 1) / BKV, Hkv, B);
  dkdv<<<grid_kv, kThreads, sizeof(float) * dkdv_floats<BQ, BKV>(D),
         stream>>>(q, k, v, dout, lse, delta, dk, dv, Hq, Hkv, T_len, S, D,
                   scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q((T_len + BQ - 1) / BQ, Hq, B);
  dqk<<<grid_q, kThreads, sizeof(float) * dq_floats<BQ, BKV>(D), stream>>>(
      q, k, v, dout, lse, delta, dq, Hq, Hkv, T_len, S, D, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* delta, float* dq, float* dk, float* dv, int B, int Hq,
               int Hkv, int T_len, int S, int D, float scale, int causal,
               int window, cudaStream_t stream) {
  if (D <= 64)
    return launch<64, 64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                              Hkv, T_len, S, D, scale, causal, window, stream);
  if (D <= 128)
    return launch<128, 64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               Hq, Hkv, T_len, S, D, scale, causal, window,
                               stream);
  return launch<256, 32, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                             Hkv, T_len, S, D, scale, causal, window, stream);
}

// ---------------------------------------------------------------------------
// The tensor-core route: bf16, D % 8 == 0, D <= 256.

// delta = sum_d dO . O for bf16 rows, one warp a row, 16-byte loads.
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta_bf16(const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint4* orow = reinterpret_cast<const uint4*>(
      o + static_cast<int64_t>(row) * D);
  const uint4* drow = reinterpret_cast<const uint4*>(
      dout + static_cast<int64_t>(row) * D);
  float acc = 0.f;
  for (int c = lane; c < D / 8; c += 32) {
    const uint4 a = orow[c], b = drow[c];
    const __nv_bfloat162* av = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* bv = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(av[e]), y = __bfloat1622float2(bv[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

namespace tc {

constexpr int kRows = 64;  // rows of a streamed tile: Q / dO (dK / dV), K / V (dQ)
constexpr float kLog2e = 1.4426950408889634f;

template <uint32_t N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <uint32_t N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// A 64 x 64 fp32 accumulator as the register-A operands of four k16 steps
// (its layout is theirs, as in the forward), split into hi = bf16(x) and
// lo = bf16(x - hi).
__device__ __forceinline__ void split_fragments(const float (&x)[32],
                                                uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

// Threads of a dK / dV block: NWG consumer warpgroups, then the producer:
// a whole warpgroup when it gives registers away (NWG > 1), else a warp.
template <int NWG>
constexpr int dkdv_threads() { return 128 * NWG + (NWG > 1 ? 128 : 32); }

// Shared memory of a dK / dV block: K and V [DP/64][BKV][64], NST stages
// of Q and of dO [DP/64][64][64] (bf16, 128-byte swizzled rows), each
// stage's lse (log2 units) and delta, then the barriers.
template <int DP, int NWG, int NST>
struct DkdvSmem {
  static constexpr int kCB = DP / kColBlock;
  static constexpr int kBKV = 64 * NWG;
  static constexpr int kKVElems = kBKV * DP;
  static constexpr int kStageElems = kRows * DP;
  static constexpr size_t kBytes =
      2 * static_cast<size_t>(2 * kKVElems + 2 * NST * kStageElems) +
      4 * 2 * NST * kRows + 8 * (1 + 2 * NST) + 1024;  // + alignment slack
};

template <int DP, int NWG, int NST, int NSPLIT>
__global__ void __launch_bounds__(128 * NWG + (NWG > 1 ? 128 : 32), 1)
attn_bwd_dkdv_tc(__grid_constant__ const CUtensorMap map_q,
                 __grid_constant__ const CUtensorMap map_do,
                 __grid_constant__ const CUtensorMap map_k,
                 __grid_constant__ const CUtensorMap map_v,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int T_len,
                 int S, int D, float scale, float scale_log2, int causal,
                 int window) {
  using L = DkdvSmem<DP, NWG, NST>;
  constexpr int kCB = L::kCB;
  constexpr int kCBO = kCB / NSPLIT;  // column blocks of dK / dV owned
  constexpr int kBKV = L::kBKV;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* v_s = k_s + L::kKVElems;
  __nv_bfloat16* q_s = v_s + L::kKVElems;
  __nv_bfloat16* do_s = q_s + NST * L::kStageElems;
  float* lse_s = reinterpret_cast<float*>(do_s + NST * L::kStageElems);
  float* dl_s = lse_s + NST * kRows;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + NST * kRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NST;

  // longest tiles first: with the causal mask the first keys are seen by
  // the most query rows
  const int split = blockIdx.x % NSPLIT;
  const int bkv = blockIdx.x / NSPLIT;  // b * Hkv + hk
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int G = Hq / Hkv;
  const int kv0 = blockIdx.y * kBKV;
  const int off = S - T_len;
  const int kv_last = min(kv0 + kBKV, S) - 1;
  // the query tiles whose rows can see a key of the block
  const int i_lo = causal ? max(0, kv0 - off) : 0;
  const int i_hi = window >= 0 ? min(T_len, kv_last + window - off) : T_len;
  const int qt_begin = i_lo / kRows;
  const int n_qt = i_hi > i_lo ? (i_hi + kRows - 1) / kRows - qt_begin : 0;
  const int n_it = G * n_qt;  // stages: heads outer, query tiles inner

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 32);         // the producer warp's lanes
      mbar_init(&empty[s], 4 * NWG);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- producer: its first warp keeps the ring of Q / dO tiles full
    if constexpr (NWG > 1) setmaxnreg_dec<40>();
    if (warp == 4 * NWG) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * 2 * L::kKVElems);
        for (int c = 0; c < kCB; ++c) {
          tma_load_3d(k_s + c * kBKV * kColBlock, &map_k, kv_full,
                      c * kColBlock, kv0, bkv);
          tma_load_3d(v_s + c * kBKV * kColBlock, &map_v, kv_full,
                      c * kColBlock, kv0, bkv);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % NST;
        const int bh = b * Hq + hk * G + it / n_qt;
        const int q0 = (qt_begin + it % n_qt) * kRows;
        if (it >= NST) mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
        // rows past T see nothing: lse +inf makes their P 0
        for (int r = lane; r < kRows; r += 32) {
          const int i = q0 + r;
          const int64_t at = static_cast<int64_t>(bh) * T_len + i;
          lse_s[st * kRows + r] = i < T_len ? lse[at] * kLog2e : CUDART_INF_F;
          dl_s[st * kRows + r] = i < T_len ? delta[at] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * 2 * L::kStageElems);
          __nv_bfloat16* qs = q_s + st * L::kStageElems;
          __nv_bfloat16* ds = do_s + st * L::kStageElems;
          for (int c = 0; c < kCB; ++c) {
            tma_load_3d(qs + c * kRows * kColBlock, &map_q, &full[st],
                        c * kColBlock, q0, bh);
            tma_load_3d(ds + c * kRows * kColBlock, &map_do, &full[st],
                        c * kColBlock, q0, bh);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys [kv0 + 64 wg, + 64)
  if constexpr (NWG > 1) setmaxnreg_inc<232>();
  const int wg = warp / 4;
  const int g = lane / 4;   // row within the warp's 8-row half
  const int tq = lane % 4;  // column pair within an 8-column block
  const int wk0 = kv0 + 64 * wg;                   // first key of the warpgroup
  const int kr0 = wk0 + 16 * (warp % 4) + g;       // this thread's two keys
  const int kr1 = kr0 + 8;
  const int wk_last = min(wk0 + 63, S - 1);
  const bool wg_live = wk0 < S;

  float acc_dk[kCBO][32], acc_dv[kCBO][32];
#pragma unroll
  for (int c = 0; c < kCBO; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dk[c][i] = acc_dv[c][i] = 0.f;
  }

  mbar_wait(kv_full, 0);
  const __nv_bfloat16* k_wg = k_s + 64 * wg * kColBlock;
  const __nv_bfloat16* v_wg = v_s + 64 * wg * kColBlock;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % NST;
    const int q0 = (qt_begin + it % n_qt) * kRows;
    const int qp_first = q0 + off, qp_last = q0 + kRows - 1 + off;
    bool live = wg_live;
    if (causal) live = live && wk0 <= qp_last;
    if (window >= 0) live = live && wk_last > qp_first - window;
    mbar_wait(&full[st], (it / NST) & 1);
    if (live) {
      const __nv_bfloat16* qs = q_s + st * L::kStageElems;
      const __nv_bfloat16* dos = do_s + st * L::kStageElems;

      // S^T = K Q^T and dP^T = V dO^T on the tensor cores
      float s[32], dp[32];
      fence_acc(s);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk / 4, w = (kk % 4) * 16;
        wgmma_ss(s, sw128_desc(k_wg + c * kBKV * kColBlock + w, 16),
                 sw128_desc(qs + c * kRows * kColBlock + w, 16), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk / 4, w = (kk % 4) * 16;
        wgmma_ss(dp, sw128_desc(v_wg + c * kBKV * kColBlock + w, 16),
                 sw128_desc(dos + c * kRows * kColBlock + w, 16), kk > 0);
      }
      wgmma_commit_and_wait();
      fence_acc(s);
      fence_acc(dp);

      // P^T and dS^T on the fragments: rows are keys, columns query rows;
      // masks only on the diagonal, window-edge and ragged tiles
      const bool need_mask =
          wk0 + 63 >= S || (causal && wk0 + 63 > qp_first) ||
          (window >= 0 && wk0 <= qp_last - window);
      const float* ls = lse_s + st * kRows;
      const float* dls = dl_s + st * kRows;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 8 * i + 2 * tq + (j & 1);
          float p = exp2f(fmaf(s[4 * i + j], scale_log2, -ls[col]));
          if (need_mask) {
            const int key = (j & 2) ? kr1 : kr0;
            const int qp = qp_first + col;
            bool ok = key < S;
            if (causal) ok = ok && key <= qp;
            if (window >= 0) ok = ok && key > qp - window;
            if (!ok) p = 0.f;
          }
          s[4 * i + j] = p;
          dp[4 * i + j] = p * (dp[4 * i + j] - dls[col]);
        }
      }
      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
      split_fragments(s, p_hi, p_lo);
      split_fragments(dp, ds_hi, ds_lo);

      // dV += P^T dO and dK += dS^T Q on the tensor cores
#pragma unroll
      for (int c = 0; c < kCBO; ++c) {
        fence_acc(acc_dv[c]);
        fence_acc(acc_dk[c]);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kCBO; ++c) {
        const int cc = split * kCBO + c;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 16 query rows a step
          const uint64_t d_do = sw128_desc(
              dos + (cc * kRows + kk * 16) * kColBlock, kRows * kColBlock * 2);
          const uint64_t d_q = sw128_desc(
              qs + (cc * kRows + kk * 16) * kColBlock, kRows * kColBlock * 2);
          wgmma_rs_tb(acc_dv[c], p_hi[kk], d_do);
          wgmma_rs_tb(acc_dv[c], p_lo[kk], d_do);
          wgmma_rs_tb(acc_dk[c], ds_hi[kk], d_q);
          wgmma_rs_tb(acc_dk[c], ds_lo[kk], d_q);
        }
      }
      wgmma_commit_and_wait();
#pragma unroll
      for (int c = 0; c < kCBO; ++c) {
        fence_acc(acc_dv[c]);
        fence_acc(acc_dk[c]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // dK and dV of the keys inside S, written once
  const int64_t base = static_cast<int64_t>(bkv) * S;
#pragma unroll
  for (int c = 0; c < kCBO; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = (split * kCBO + c) * kColBlock + 8 * i + 2 * tq;
      if (col < D) {
        if (kr0 < S) {
          const int64_t at = (base + kr0) * D + col;
          *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(
              acc_dk[c][4 * i] * scale, acc_dk[c][4 * i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + at) =
              pack_bf16(acc_dv[c][4 * i], acc_dv[c][4 * i + 1]);
        }
        if (kr1 < S) {
          const int64_t at = (base + kr1) * D + col;
          *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(
              acc_dk[c][4 * i + 2] * scale, acc_dk[c][4 * i + 3] * scale);
          *reinterpret_cast<uint32_t*>(dv + at) =
              pack_bf16(acc_dv[c][4 * i + 2], acc_dv[c][4 * i + 3]);
        }
      }
    }
  }
}

// Shared memory of a dQ block: Q and dO [DP/64][BQ][64], then NST stages
// of K and of V [DP/64][64][64], bf16 in 128-byte swizzled rows; then the
// barriers.
template <int DP, int NWG, int NST>
struct DqSmem {
  static constexpr int kBQ = 64 * NWG;
  static constexpr int kCB = DP / kColBlock;
  static constexpr int kQElems = kBQ * DP;
  static constexpr int kTileElems = kRows * DP;
  static constexpr size_t kBytes =
      2 * static_cast<size_t>(2 * kQElems + 2 * NST * kTileElems) +
      8 * (1 + 2 * NST) + 1024;  // + alignment slack
};

template <int DP, int NWG, int NST>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
attn_bwd_dq_tc(__grid_constant__ const CUtensorMap map_q,
               __grid_constant__ const CUtensorMap map_do,
               __grid_constant__ const CUtensorMap map_k,
               __grid_constant__ const CUtensorMap map_v,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int T_len,
               int S, int D, float scale, float scale_log2, int causal,
               int window) {
  using L = DqSmem<DP, NWG, NST>;
  constexpr int kBQ = L::kBQ;
  constexpr int kCB = L::kCB;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* do_s = q_s + L::kQElems;
  __nv_bfloat16* k_s = do_s + L::kQElems;
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
  const int kt_begin = k_lo / kRows;
  const int kt_end = k_hi > k_lo ? (k_hi + kRows - 1) / kRows : kt_begin;

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
      mbar_expect_tx(q_full, 2 * 2 * L::kQElems);
      for (int c = 0; c < kCB; ++c) {
        tma_load_3d(q_s + c * kBQ * kColBlock, &map_q, q_full, c * kColBlock,
                    q0, bh);
        tma_load_3d(do_s + c * kBQ * kColBlock, &map_do, q_full,
                    c * kColBlock, q0, bh);
      }
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int st = it % NST;
        if (it >= NST) mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * 2 * L::kTileElems);
        __nv_bfloat16* ks = k_s + st * L::kTileElems;
        __nv_bfloat16* vs = v_s + st * L::kTileElems;
        for (int c = 0; c < kCB; ++c) {
          tma_load_3d(ks + c * kRows * kColBlock, &map_k, &full[st],
                      c * kColBlock, kt * kRows, bkv);
          tma_load_3d(vs + c * kRows * kColBlock, &map_v, &full[st],
                      c * kColBlock, kt * kRows, bkv);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [q0 + 64 wg, + 64)
  const int wg = warp / 4;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int wrow0 = q0 + 64 * wg;
  const int r0 = wrow0 + 16 * (warp % 4) + g;  // this thread's two rows
  const int r1 = r0 + 8;
  const int qp0 = r0 + off, qp1 = r1 + off;
  const bool wg_live = wrow0 < T_len;
  const int wq_first = wrow0 + off;
  const int wq_last = min(wrow0 + 63, T_len - 1) + off;
  const int wg_hi = causal ? min(S, wq_last + 1) : S;
  const int wg_lo = window >= 0 ? max(0, wq_first - window + 1) : 0;
  // the rows' lse (log2 units; +inf past T: P = 0) and delta
  const float* lb = lse + static_cast<int64_t>(bh) * T_len;
  const float* db = delta + static_cast<int64_t>(bh) * T_len;
  const float lr0 = r0 < T_len ? lb[r0] * kLog2e : CUDART_INF_F;
  const float lr1 = r1 < T_len ? lb[r1] * kLog2e : CUDART_INF_F;
  const float dr0 = r0 < T_len ? db[r0] : 0.f;
  const float dr1 = r1 < T_len ? db[r1] : 0.f;

  float acc[kCB][32];
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  }

  mbar_wait(q_full, 0);
  const __nv_bfloat16* q_wg = q_s + 64 * wg * kColBlock;
  const __nv_bfloat16* do_wg = do_s + 64 * wg * kColBlock;

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int st = it % NST;
    mbar_wait(&full[st], (it / NST) & 1);
    const int kv0 = kt * kRows;
    if (wg_live && kv0 < wg_hi && kv0 + kRows > wg_lo) {
      const __nv_bfloat16* ks = k_s + st * L::kTileElems;
      const __nv_bfloat16* vs = v_s + st * L::kTileElems;

      // S = Q K^T and dP = dO V^T on the tensor cores
      float s[32], dp[32];
      fence_acc(s);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk / 4, w = (kk % 4) * 16;
        wgmma_ss(s, sw128_desc(q_wg + c * kBQ * kColBlock + w, 16),
                 sw128_desc(ks + c * kRows * kColBlock + w, 16), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk / 4, w = (kk % 4) * 16;
        wgmma_ss(dp, sw128_desc(do_wg + c * kBQ * kColBlock + w, 16),
                 sw128_desc(vs + c * kRows * kColBlock + w, 16), kk > 0);
      }
      wgmma_commit_and_wait();
      fence_acc(s);
      fence_acc(dp);

      // P and dS on the fragments, masks only where a pair is hidden
      const bool need_mask =
          kv0 + kRows > S || (causal && kv0 + kRows - 1 > wq_first) ||
          (window >= 0 && kv0 <= wq_last - window);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool second = j & 2;
          float p = exp2f(fmaf(s[4 * i + j], scale_log2, second ? -lr1 : -lr0));
          if (need_mask) {
            const int key = kv0 + 8 * i + 2 * tq + (j & 1);
            const int qp = second ? qp1 : qp0;
            bool ok = key < S;
            if (causal) ok = ok && key <= qp;
            if (window >= 0) ok = ok && key > qp - window;
            if (!ok) p = 0.f;
          }
          dp[4 * i + j] = p * (dp[4 * i + j] - (second ? dr1 : dr0));
        }
      }
      uint32_t ds_hi[4][4], ds_lo[4][4];
      split_fragments(dp, ds_hi, ds_lo);

      // dQ += dS K on the tensor cores
#pragma unroll
      for (int c = 0; c < kCB; ++c) fence_acc(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step
          const uint64_t d_k = sw128_desc(
              ks + (c * kRows + kk * 16) * kColBlock, kRows * kColBlock * 2);
          wgmma_rs_tb(acc[c], ds_hi[kk], d_k);
          wgmma_rs_tb(acc[c], ds_lo[kk], d_k);
        }
      }
      wgmma_commit_and_wait();
#pragma unroll
      for (int c = 0; c < kCB; ++c) fence_acc(acc[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // dQ of the rows inside T, written once
  __nv_bfloat16* qb = dq + static_cast<int64_t>(bh) * T_len * D;
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = c * kColBlock + 8 * i + 2 * tq;
      if (col < D) {
        if (r0 < T_len)
          *reinterpret_cast<uint32_t*>(qb + static_cast<int64_t>(r0) * D +
                                       col) =
              pack_bf16(acc[c][4 * i] * scale, acc[c][4 * i + 1] * scale);
        if (r1 < T_len)
          *reinterpret_cast<uint32_t*>(qb + static_cast<int64_t>(r1) * D +
                                       col) =
              pack_bf16(acc[c][4 * i + 2] * scale, acc[c][4 * i + 3] * scale);
      }
    }
  }
}

// Above 48 KB only as opted-in dynamic shared memory; set once per
// instantiation, outside any CUDA graph capture that replays the launch.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

// The three launches of the route.  KNWG / KNST / NSPLIT shape the dK / dV
// kernel, QNWG / QNST the dQ kernel.
template <int DP, int KNWG, int KNST, int NSPLIT, int QNWG, int QNST>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Hq, int Hkv, int T_len, int S,
           int D, float scale, int causal, int window, cudaStream_t stream) {
  using LK = DkdvSmem<DP, KNWG, KNST>;
  using LQ = DqSmem<DP, QNWG, QNST>;
  CUtensorMap kv_q, kv_do, kv_k, kv_v, q_q, q_do, q_k, q_v;
  if (!encode_map(&kv_q, q, D, T_len, B * Hq, kRows) ||
      !encode_map(&kv_do, dout, D, T_len, B * Hq, kRows) ||
      !encode_map(&kv_k, k, D, S, B * Hkv, LK::kBKV) ||
      !encode_map(&kv_v, v, D, S, B * Hkv, LK::kBKV) ||
      !encode_map(&q_q, q, D, T_len, B * Hq, LQ::kBQ) ||
      !encode_map(&q_do, dout, D, T_len, B * Hq, LQ::kBQ) ||
      !encode_map(&q_k, k, D, S, B * Hkv, kRows) ||
      !encode_map(&q_v, v, D, S, B * Hkv, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  auto dkdv = attn_bwd_dkdv_tc<DP, KNWG, KNST, NSPLIT>;
  auto dqk = attn_bwd_dq_tc<DP, QNWG, QNST>;
  static bool dkdv_in = false, dq_in = false;
  cudaError_t err = opt_in(dkdv, LK::kBytes, dkdv_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = opt_in(dqk, LQ::kBytes, dq_in);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows = B * Hq * T_len;
  attn_bwd_delta_bf16<<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                        kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale_log2 = scale * kLog2e;
  const dim3 grid_kv(B * Hkv * NSPLIT, (S + LK::kBKV - 1) / LK::kBKV);
  dkdv<<<grid_kv, dkdv_threads<KNWG>(), LK::kBytes, stream>>>(
      kv_q, kv_do, kv_k, kv_v, lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Hq,
      Hkv, T_len, S, D, scale, scale_log2, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q(B * Hq, (T_len + LQ::kBQ - 1) / LQ::kBQ);
  dqk<<<grid_q, 128 * QNWG + 32, LQ::kBytes, stream>>>(
      q_q, q_do, q_k, q_v, lse, delta, static_cast<__nv_bfloat16*>(dq), Hq,
      Hkv, T_len, S, D, scale, scale_log2, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Launch the SIMT route on `stream`: three kernels (delta, dK/dV, dQ).
// Returns a cudaError_t (0 on success), checked after every launch.
// q/o/dout/dq are contiguous [B, Hq, T, D], k/v/dk/dv contiguous
// [B, Hkv, S, D], all fp32 and 16-byte aligned; lse (the forward's) and
// delta (scratch) are fp32 [B, Hq, T].  window < 0 means no window.  The
// host checks Hq % Hkv == 0, D % 8 == 0 and 8 <= D <= 256.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int T_len, int S, int D, float scale,
    int causal, int window, void* stream) {
  if (B <= 0 || Hq <= 0 || T_len <= 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      Hkv <= 0 || Hq % Hkv != 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0)  // no key: dQ is 0 and dK, dV are empty
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, static_cast<size_t>(B) * Hq * T_len * D * sizeof(float), st));
  return dispatch_d(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), B, Hq, Hkv, T_len, S,
      D, scale, causal, window, st);
}

// Launch the tensor-core route on `stream`: bf16 only, layouts, lse and
// delta as above, D % 8 == 0 and D <= 256 (padded with zeros to 64, 128 or
// 256 columns in shared memory).  Three kernels (delta, dK/dV, dQ);
// returns a cudaError_t (0 on success), checked after every launch.
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int T_len, int S, int D, float scale,
    int causal, int window, void* stream) {
  if (B <= 0 || Hq <= 0 || T_len <= 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      Hkv <= 0 || Hq % Hkv != 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0)  // no key: dQ is 0 and dK, dV are empty
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, static_cast<size_t>(B) * Hq * T_len * D * 2, st));
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (D <= 64)
    return tc::launch<64, 2, 4, 1, 2, 3>(q, k, v, o, dout, lse_f, delta_f, dq,
                                         dk, dv, B, Hq, Hkv, T_len, S, D,
                                         scale, causal, window, st);
  if (D <= 128)
    return tc::launch<128, 2, 3, 1, 2, 3>(q, k, v, o, dout, lse_f, delta_f,
                                          dq, dk, dv, B, Hq, Hkv, T_len, S, D,
                                          scale, causal, window, st);
  // one consumer warpgroup a block, and dK / dV in two column halves: the
  // accumulators of a thread stay at 128 registers
  return tc::launch<256, 1, 2, 2, 1, 2>(q, k, v, o, dout, lse_f, delta_f, dq,
                                        dk, dv, B, Hq, Hkv, T_len, S, D,
                                        scale, causal, window, st);
}
