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
// Bound.  Decode reads the valid prefix of the cache once and does 4 flops
// per cached element per query head in the group: at the serve path's
// shape (B = 4, Hq = 32, Hkv = 16, S = 2048, D = 128, bf16, G = 2) that is
// 1 flop per byte, far below the card's ~295 flops per byte, so it is
// bound by bytes: 29 MB, 0.0086 ms at 3.35 TB/s.  What the card needs is
// enough loads in flight on every SM.
//
// Design: split-KV, two launches.  The TPU kernel walks one row's cache in
// a sequential grid; one block per (kv head, batch row) would give only
// B * Hkv blocks (64 at the path's shape, for 132 SMs).
//
// * decode_attention_kernel_split, grid (n_splits, Hkv * n_chunks, B): the
//   host cuts [0, S) into splits of L slots (a multiple of 64, chosen from
//   the shapes alone so that the grid has at least 2 * 132 blocks where S
//   allows), and a block serves one split of one kv head for the group of
//   query heads that share it (at most GMAX of them; a larger group is cut
//   into n_chunks chunks), so each K and V row is read from device memory
//   once for the whole group.  The block reads its cache_len on the device
//   (no host sync, so a step can be captured in a CUDA graph); a split that
//   misses the row's valid range writes m = -inf, l = 0 and exits.  The
//   query rows live in fp32 registers, pre-scaled by scale * log2 e.  A
//   group of LPR lanes (a power of two, LPR * 16 bytes >= a row) reads one
//   K row and one V row straight from device memory, 16 bytes a lane, U
//   rows a lane at a time so that U loads are in flight; the score is a
//   shuffle reduction over the group, and each lane keeps the fp32
//   accumulator of its own columns, with a running max and sum per query
//   head (an online softmax in base 2).  The lane groups of a warp merge by
//   shuffles, the four warps through shared memory, and the block writes
//   its partial (m, l, acc[G, D]) in fp32 to a scratch tensor the wrapper
//   allocates.
// * decode_attention_kernel_combine: one warp per (b, q head) rescales the
//   splits by 2^(m_i - M), sums, divides by the rescaled l and writes o in
//   the output dtype.  One code path serves fp32 and bf16.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;  // four warps a split block
constexpr int kWarps = kThreads / 32;
constexpr int kDMax = 256;

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

// The V = 16 / sizeof(T) values of a 16-byte vector as floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw,
                                       float (&out)[16 / sizeof(T)]) {
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e)
    out[e] = to_float(vals[e]);
}

template <typename T, int VPL, int GMAX, int U>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel_split(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int32_t* __restrict__ cache_len,
                              float* __restrict__ part_ml,
                              float* __restrict__ part_acc, int Hq, int Hkv,
                              int S, int D, int L, int n_splits, int n_chunks,
                              int chunk_heads, int lpr, float scale_log2,
                              int window) {
  constexpr int V = 16 / sizeof(T);  // values in a 16-byte vector
  constexpr int E = VPL * V;         // values of a row a lane owns
  __shared__ float m_s[kWarps][GMAX];
  __shared__ float l_s[kWarps][GMAX];
  __shared__ float acc_s[kWarps][GMAX][kDMax];

  const int split = blockIdx.x;
  const int hk = blockIdx.y / n_chunks;
  const int g0 = (blockIdx.y % n_chunks) * chunk_heads;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int ng = min(chunk_heads, G - g0);  // query heads of this block
  const int h0 = hk * G + g0;
  // partial of (b, h0 + g, split) at row (b * Hq + h0 + g) * n_splits + split
  const int64_t prow = (static_cast<int64_t>(b) * Hq + h0) * n_splits + split;

  const int n = cache_len[b];
  const int lo = max(window >= 0 ? max(0, n - window) : 0, split * L);
  const int hi = min(min(n, S), (split + 1) * L);
  if (lo >= hi) {
    for (int g = threadIdx.x; g < ng; g += kThreads) {
      part_ml[(prow + static_cast<int64_t>(g) * n_splits) * 2] = -CUDART_INF_F;
      part_ml[(prow + static_cast<int64_t>(g) * n_splits) * 2 + 1] = 0.f;
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int li = lane % lpr;              // lane within its row group
  const int n_groups = kWarps * (32 / lpr);
  const int group = warp * (32 / lpr) + lane / lpr;

  // this lane's columns: vectors li + lpr * j, j < VPL
  int col[VPL];
  bool col_ok[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    col[j] = (li + lpr * j) * V;
    col_ok[j] = col[j] < D;
  }

  float qf[GMAX][E];
  float acc[GMAX][E];
  float m[GMAX], l[GMAX];
  const T* qb = q + (static_cast<int64_t>(b) * Hq + h0) * D;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      float vals[V];
      if (g < ng && col_ok[j]) {
        unpack<T>(*reinterpret_cast<const uint4*>(qb + g * D + col[j]), vals);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) vals[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        qf[g][j * V + e] = vals[e] * scale_log2;
        acc[g][j * V + e] = 0.f;
      }
    }
  }

  const int64_t kv_off = (static_cast<int64_t>(b) * Hkv + hk) * S * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  for (int base = lo; base < hi; base += n_groups * U) {
    // U rows of K and V for this lane group, all loads issued first
    uint4 kr[U][VPL], vr[U][VPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u * n_groups + group;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (row < hi && col_ok[j]) {
          const int64_t at = static_cast<int64_t>(row) * D + col[j];
          kr[u][j] = __ldg(reinterpret_cast<const uint4*>(kb + at));
          vr[u][j] = __ldg(reinterpret_cast<const uint4*>(vb + at));
        } else {
          kr[u][j] = make_uint4(0, 0, 0, 0);
          vr[u][j] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    // scores (base-2 logits) of the U rows for every query head
    float s[U][GMAX];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float vals[V];
        unpack<T>(kr[u][j], vals);
#pragma unroll
        for (int e = 0; e < V; ++e) kf[j * V + e] = vals[e];
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qf[g][e], kf[e], dot);
        s[u][g] = dot;
      }
    }
    for (int off = lpr / 2; off > 0; off /= 2) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * n_groups + group >= hi) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) s[u][g] = -CUDART_INF_F;
      }
    }
    // online softmax: rescale by 2^(m_old - m_new), add p . V
    float vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float vals[V];
        unpack<T>(vr[u][j], vals);
#pragma unroll
        for (int e = 0; e < V; ++e) vf[u][j * V + e] = vals[e];
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= ng) break;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      // nothing valid yet keeps m = -inf; then p and alpha are 0
      const float mu = mx == -CUDART_INF_F ? 0.f : mx;
      const float alpha = exp2f(m[g] - mu);
      float p[U];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = exp2f(s[u][g] - mu);
        psum += p[u];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[g][e] = a;
      }
    }
  }

  // merge the lane groups of the warp (partners share their columns)
  for (int off = lpr; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float mu = mx == -CUDART_INF_F ? 0.f : mx;
      const float a = exp2f(m[g] - mu), c = exp2f(mo - mu);
      l[g] = l[g] * a + lo_ * c;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float other = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + other * c;
      }
    }
  }
  // then the warps, through shared memory
  if (lane < lpr) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (li == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (col_ok[j]) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc_s[warp][g][col[j] + e] = acc[g][j * V + e];
        }
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    const float mu = mx == -CUDART_INF_F ? 0.f : mx;
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(m_s[w][g] - mu);
      a = fmaf(c, acc_s[w][g][d], a);
      lsum = fmaf(c, l_s[w][g], lsum);
    }
    const int64_t r = prow + static_cast<int64_t>(g) * n_splits;
    part_acc[r * D + d] = a;
    if (d == 0) {
      part_ml[r * 2] = mx;
      part_ml[r * 2 + 1] = lsum;
    }
  }
}

// o[row, :] from the row's n_splits partials; one warp per (b, q head).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel_combine(const float* __restrict__ part_ml,
                                const float* __restrict__ part_acc,
                                T* __restrict__ o, int rows, int n_splits,
                                int D) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* ml = part_ml + static_cast<int64_t>(row) * n_splits * 2;
  const float* pa = part_acc + static_cast<int64_t>(row) * n_splits * D;
  float mx = -CUDART_INF_F;
  for (int s = lane; s < n_splits; s += 32) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float lsum = 0.f;
  for (int s = lane; s < n_splits; s += 32)
    if (ml[2 * s] != -CUDART_INF_F)
      lsum += exp2f(ml[2 * s] - mx) * ml[2 * s + 1];
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  T* orow = o + static_cast<int64_t>(row) * D;
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float ms = ml[2 * s];
      // an empty split wrote no accumulator
      if (ms != -CUDART_INF_F)
        a = fmaf(exp2f(ms - mx), pa[static_cast<int64_t>(s) * D + d], a);
    }
    orow[d] = from_float<T>(a * inv);
  }
}

template <typename T, int VPL, int GMAX>
int launch_split(const void* q, const void* k, const void* v,
                 const void* lens, float* part_ml, float* part_acc, int B,
                 int Hq, int Hkv, int S, int D, int L, int n_splits,
                 int n_chunks, int chunk_heads, int lpr, float scale_log2,
                 int window, cudaStream_t stream, int* launched) {
  // rows in flight per lane group, fewer where the group's registers grow
  constexpr int U0 = GMAX <= 2 ? 8 : (GMAX <= 4 ? 4 : 2);
  constexpr int U = U0 / VPL;
  const dim3 grid(n_splits, Hkv * n_chunks, B);
  launched[0] = static_cast<int>(grid.x);
  launched[1] = static_cast<int>(grid.y);
  launched[2] = static_cast<int>(grid.z);
  launched[3] = GMAX;
  launched[4] = chunk_heads;
  decode_attention_kernel_split<T, VPL, GMAX, U>
      <<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lens), part_ml,
      part_acc, Hq, Hkv, S, D, L, n_splits, n_chunks, chunk_heads, lpr,
      scale_log2, window);
  return static_cast<int>(cudaGetLastError());
}

// GMAX from the group G = Hq / Hkv: 2 or 4 heads a block for G <= 4, else
// 8, with a group larger than 8 cut into n_chunks = ceil(G / 8) chunks of
// chunk_heads = ceil(G / n_chunks) heads (G = 12: two blocks of 6).
template <typename T, int VPL>
int dispatch_g(const void* q, const void* k, const void* v, const void* lens,
               float* part_ml, float* part_acc, int B, int Hq, int Hkv, int S,
               int D, int L, int n_splits, int lpr, float scale_log2,
               int window, cudaStream_t stream, int* launched) {
  const int G = Hq / Hkv;
  if (G <= 2)
    return launch_split<T, VPL, 2>(q, k, v, lens, part_ml, part_acc, B, Hq,
                                   Hkv, S, D, L, n_splits, 1, G, lpr,
                                   scale_log2, window, stream, launched);
  if (G <= 4)
    return launch_split<T, VPL, 4>(q, k, v, lens, part_ml, part_acc, B, Hq,
                                   Hkv, S, D, L, n_splits, 1, G, lpr,
                                   scale_log2, window, stream, launched);
  const int n_chunks = (G + 7) / 8;
  const int chunk_heads = (G + n_chunks - 1) / n_chunks;
  return launch_split<T, VPL, 8>(q, k, v, lens, part_ml, part_acc, B, Hq, Hkv,
                                 S, D, L, n_splits, n_chunks, chunk_heads, lpr,
                                 scale_log2, window, stream, launched);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* o, float* part_ml, float* part_acc, int B, int Hq, int Hkv,
           int S, int D, int L, int n_splits, float scale, int window,
           cudaStream_t stream, int* launched) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = (D + V - 1) / V;  // 16-byte vectors in a row
  int lpr = 4;
  while (lpr < vecs && lpr < 32) lpr *= 2;
  const float scale_log2 = scale * 1.4426950408889634f;
  int err;
  if constexpr (V == 8)  // bf16: a row of D <= 256 is at most 32 vectors
    err = dispatch_g<T, 1>(q, k, v, lens, part_ml, part_acc, B, Hq, Hkv, S, D,
                           L, n_splits, lpr, scale_log2, window, stream,
                           launched);
  else
    err = vecs <= 32
        ? dispatch_g<T, 1>(q, k, v, lens, part_ml, part_acc, B, Hq, Hkv, S,
                           D, L, n_splits, lpr, scale_log2, window, stream,
                           launched)
        : dispatch_g<T, 2>(q, k, v, lens, part_ml, part_acc, B, Hq, Hkv, S,
                           D, L, n_splits, lpr, scale_log2, window, stream,
                           launched);
  if (err != 0) return err;
  const int rows = B * Hq;
  decode_attention_kernel_combine<T>
      <<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          part_ml, part_acc, static_cast<T*>(o), rows, n_splits, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both kernels on `stream`; returns a cudaError_t (0 on success).
// q/o are contiguous [B, Hq, D], k/v contiguous [B, Hkv, S, D] of one dtype
// (dtype 0: float32, 1: bfloat16), 16-byte aligned; cache_len is int32[B]
// on the device.  window < 0 means no window.  The host splits [0, S) into
// n_splits splits of L slots (L % 64 == 0, n_splits * L >= S) and passes
// fp32 scratch part_ml [B, Hq, n_splits, 2] and part_acc [B, Hq, n_splits,
// D].  The host checks Hq % Hkv == 0, D % 8 == 0 and 8 <= D <= 256.  The
// split kernel's launch is written to launched[5]: its grid (x, y, z),
// GMAX and the query heads a block serves (y = Hkv * n_chunks).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* cache_len,
                                       void* o, void* part_ml, void* part_acc,
                                       int B, int Hq, int Hkv, int S, int D,
                                       int L, int n_splits, float scale,
                                       int window, int dtype, void* stream,
                                       int* launched) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 ||
      D > kDMax || L <= 0 || L % 64 != 0 || n_splits <= 0 ||
      static_cast<int64_t>(n_splits) * L < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (dtype == 0)
    return launch<float>(q, k, v, cache_len, o, ml, acc, B, Hq, Hkv, S, D, L,
                         n_splits, scale, window, st, launched);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, cache_len, o, ml, acc, B, Hq, Hkv,
                                 S, D, L, n_splits, scale, window, st,
                                 launched);
  return static_cast<int>(cudaErrorInvalidValue);
}
