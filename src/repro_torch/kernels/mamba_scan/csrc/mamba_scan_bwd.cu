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
// Design.  mamba_scan.cu's train launch writes the state entering every
// window of kWin = 16 steps (edges [B, ceil(T / 16), ceil(N / 4), Dm, 4]
// fp32).  T is cut into segments of whole windows (the host's plan,
// kernel.bwd_plan: at least two where T allows, more until the grid has
// 256 blocks), and only g crosses a segment's end.  Three launches:
// - carry (mamba_scan_bwd_carry_kernel): the steps after the first
//   segment, in pieces of at most 128 steps staged in shared memory, a
//   thread per 4 states of a channel.  For a piece of steps f..e it runs g
//   backwards from zero and writes L = a_f g_f and P = a_f ... a_e
//   (carry [2, B, n_pieces, Dm, N]).
// - main (mamba_scan_bwd_kernel): grid (channel blocks, segments, B).  A
//   block owns a segment of one batch row and 64 channels; a thread owns 4
//   states of a channel (KP = 2^ceil(log2(N / 4)) threads a channel, side
//   by side in the warp): 256 threads at N = 16, two blocks an SM.  Its
//   prologue folds the later pieces' (L, P), from the last to the first,
//   into the carry G that enters its segment (G = L + P G), and its walk
//   starts from it.  It walks its windows in reverse, each as two halves
//   of 8 steps: from the window's edge it recomputes the state after the
//   first half, then for each half (the later first) recomputes and keeps
//   the 8 states h_t and decays a_t in registers (the forward's
//   arithmetic: ex2.approx of delta * A log2 e and the same FMA, so the
//   same states) and runs g backwards over them: 1.5 exps a state and
//   step.  A window's x, delta, dy, B, C and edge are staged by cp.async
//   two windows ahead, three stages deep, and read as they are (widened in
//   registers); one barrier a window.
// - reduce (mamba_scan_bwd_reduce_kernel): the fixed-order sums below.
// No float atomics: every sum has one owner and a fixed order, so two
// launches give the same bits (training runs under deterministic
// algorithms, and a restored run must repeat a step bit for bit).
//   * dx, ddelta: a thread's 4 states' parts, summed over the channel's KP
//     lanes by a butterfly of shuffles, staged in shared memory and written
//     a window at a time in 16-byte rows.
//   * dB, dC (sums over channels): a warp adds its channels' values by a
//     butterfly in which each level halves the values a lane keeps; the
//     block adds its warps' sums in warp order and writes one partial per
//     channel block, dbc_part [2, n_blk, B, T, N] fp32 (each step has one
//     segment, so one owner).
//   * dA, dD: one partial per batch row and segment, dA_part [B, n_seg,
//     Dm, N], dD_part [B, n_seg, Dm].
//   The reduce launch adds the channel blocks' partials of dB and dC in
//   block order, and those of dA and dD in (row, segment) order.
// Any T >= 1, any Dm and 1 <= N <= 32.  Rows whose bytes (or whose
// tensors' starts) are not a multiple of 16 are staged by plain loads.
//
// Bound.  At falcon-mamba-7b's training shape (B = 1, T = 4096,
// Dm = 8192, N = 16, bf16) the gradient must read x, delta, dy (67 MB
// each) and the edges (134 MB), and write dx and ddelta (67 MB each):
// ~0.47 GB, 0.14 ms at 3.35 TB/s; it needs B*T*Dm*N = 537 M exps, 0.13 ms
// at 16 ex2 a clock on each of the 132 SMs (1.98 GHz), and 20.5 FLOPs a
// state and step (an FMA as two), 0.16 ms at 67 TFLOP/s, the floor.  This
// design evaluates 1.5 exps a state and step in the main launch and 0.5
// in the carry's (two segments there), and issues about 28 instructions a
// state and step (the gradient's 9 FMAs and products, the recompute's 6,
// the two butterflies' shuffles and selects); those and the shared-memory
// traffic of its loads and shuffles, not the exps, are its floor.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 16;           // steps between edges: a window
constexpr int kCarryStates = 4;    // states a carry thread keeps
constexpr int kCarryChannels = 64;  // channels a carry block keeps
constexpr int kPiece = 128;        // at most this many steps a carry piece
constexpr int kMaxThreads = 512;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

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

// 4 consecutive T of shared memory (8 or 16 bytes, aligned) as fp32.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// 16 bytes of T from 16 / sizeof(T) floats.
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// The forward's exp: a_t = ex2.approx(delta_t * (A * log2 e)).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// An asynchronous copy of 16 bytes of which the first `bytes` are read
// and the rest filled with zeros (bytes 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------- carry
// Grid (ceil(Dm / 64), n_pieces, B), K groups of 64 threads, a thread 4
// states of a channel.  Piece p holds steps f = seg_len + p piece_len ..
// e = min(T, f + piece_len) - 1; from g = 0 after e:
//   g_t = a_{t+1} g_{t+1} + dy_t C_t,  L = a_f g_f,  P = a_f ... a_e,
// written to carry[0 / 1][b][p][d][n].  The piece's delta and dy
// [kPiece][64] and C [kPiece * N] are staged in shared memory (cp.async
// when `aligned`, as in the main launch), C widened once to fp32
// [kPiece][4K]; steps past e read as zero (delta = 0: a = 1, and g stays
// 0 above the piece).
template <typename T, int K>
struct Carry {
  static constexpr int kThreads = kCarryChannels * K;
  static constexpr int kRaw = kPiece * kCarryChannels * sizeof(T);
  static constexpr int kRawC = kPiece * 4 * K * sizeof(T);
  static constexpr int kSmem = 2 * kRaw + kRawC + kPiece * 4 * K * 4;
};

template <typename T, int K>
__global__ void __launch_bounds__(Carry<T, K>::kThreads, K <= 4 ? 2 : 1)
mamba_scan_bwd_carry_kernel(const T* __restrict__ delta,
                            const float* __restrict__ A,
                            const T* __restrict__ Cm,
                            const T* __restrict__ dy,
                            float* __restrict__ carry, int T_len, int Dm,
                            int N, int seg_len, int piece_len, bool aligned) {
  constexpr int kThreads = Carry<T, K>::kThreads, np = 4 * K;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ds = reinterpret_cast<T*>(smem);
  T* ys = ds + kPiece * kCarryChannels;
  T* craw = ys + kPiece * kCarryChannels;
  float* cf = reinterpret_cast<float*>(smem + 2 * Carry<T, K>::kRaw +
                                       Carry<T, K>::kRawC);
  const int tid = threadIdx.x;
  const int k = tid / kCarryChannels, c = tid % kCarryChannels;
  const int d0 = blockIdx.x * kCarryChannels, d = d0 + c;
  const int p = blockIdx.y, b = blockIdx.z, n_pieces = gridDim.y;
  const bool live = d < Dm;
  const int valid_cols = min(kCarryChannels, Dm - d0);
  const int f = seg_len + p * piece_len;
  const int len = min(T_len, f + piece_len) - f;
  const int steps = (len + kWin - 1) / kWin * kWin;
  const int64_t row0 = static_cast<int64_t>(b) * T_len;

  if (aligned) {
    constexpr int per = 16 / sizeof(T), vcols = kCarryChannels / per;
    for (int i = tid; i < 2 * steps * vcols; i += kThreads) {
      const int q = i >= steps * vcols, r = (i - q * steps * vcols) / vcols;
      const int cc = i % vcols * per;
      const int n = r < len ? max(0, min(per, valid_cols - cc)) : 0;
      const T* src = q ? dy : delta;
      cp_async16((q ? ys : ds) + r * kCarryChannels + cc,
                 n ? src + (row0 + f + r) * Dm + d0 + cc : src,
                 n * static_cast<int>(sizeof(T)));
    }
    const int nc = (len * N + per - 1) / per;
    for (int i = tid; i < nc; i += kThreads) {
      const int n = min(per, len * N - i * per);
      cp_async16(craw + i * per, Cm + (row0 + f) * N + i * per,
                 n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = tid; i < 2 * steps * kCarryChannels; i += kThreads) {
      const int q = i >= steps * kCarryChannels;
      const int r = (i - q * steps * kCarryChannels) / kCarryChannels;
      const int cc = i % kCarryChannels;
      (q ? ys : ds)[r * kCarryChannels + cc] =
          r < len && cc < valid_cols
              ? (q ? dy : delta)[(row0 + f + r) * Dm + d0 + cc] : zero<T>();
    }
    for (int i = tid; i < len * N; i += kThreads)
      craw[i] = Cm[(row0 + f) * N + i];
  }
  cp_async_commit();

  float a2[kCarryStates], g[kCarryStates], an[kCarryStates],
      P[kCarryStates];
#pragma unroll
  for (int j = 0; j < kCarryStates; ++j) {
    const int n = k * kCarryStates + j;
    a2[j] = live && n < N ? A[static_cast<int64_t>(d) * N + n] * kLog2e : 0.f;
    g[j] = 0.f;
    an[j] = 1.f;
    P[j] = 1.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < steps * np; i += kThreads) {
    const int r = i / np, n = i % np;
    cf[i] = r < len && n < N ? widen(craw[r * N + n]) : 0.f;
  }
  __syncthreads();
  for (int t1 = steps - 1; t1 >= 0; t1 -= kWin) {
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
      const int t = t1 - i;
      const float dl = widen(ds[t * kCarryChannels + c]);
      const float yv = widen(ys[t * kCarryChannels + c]);
      const float4 cv4 = reinterpret_cast<const float4*>(cf + t * np)[k];
      const float cv[kCarryStates] = {cv4.x, cv4.y, cv4.z, cv4.w};
#pragma unroll
      for (int j = 0; j < kCarryStates; ++j) {
        const float a = ex2(dl * a2[j]);
        g[j] = fmaf(an[j], g[j], yv * cv[j]);
        P[j] *= a;
        an[j] = a;
      }
    }
  }
  if (live) {
    const int64_t plane = static_cast<int64_t>(gridDim.z) * n_pieces * Dm * N;
    float* out = carry + ((static_cast<int64_t>(b) * n_pieces + p) * Dm + d) * N;
#pragma unroll
    for (int j = 0; j < kCarryStates; ++j) {
      const int n = k * kCarryStates + j;
      if (n < N) {
        out[n] = an[j] * g[j];
        out[plane + n] = P[j];
      }
    }
  }
}

// ----------------------------------------------------------------- main
template <typename T, int KP>
struct Main {
  // KP threads a channel, 4 states each (N padded to 4 KP), 64 channels a
  // block: 64 KP threads, and KP lanes of a channel side by side in a warp
  static constexpr int kCB = 64;                   // channels a block keeps
  static constexpr int kThreads = kCB * KP;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kCW = 32 / KP;              // channels a warp keeps
  static constexpr int kNP = 4 * KP;               // states, padded
  static constexpr int kMinBlocks = kMaxThreads / kThreads;  // 128 registers
  // shared memory, in bytes, in this order: three stages of a window's
  // inputs as they are in global memory (x, delta, dy [kWin][kCB], B and
  // C [kWin][kNP] each, in T, states past N zero); two windows of the
  // warps' dB/dC sums, red [kWin][kWarps][2 kNP]; two windows of dx and
  // ddelta, out [2][kWin][kCB]; three windows' edges [KP][kCB][4] (fp32).
  static constexpr int kRawChan = kWin * kCB * sizeof(T);
  static constexpr int kRawBC = kWin * kNP * sizeof(T);
  static constexpr int kRaw = 3 * kRawChan + 2 * kRawBC;
  static constexpr int kRed = kWin * kWarps * 2 * kNP * 4;
  static constexpr int kOut = 2 * kWin * kCB * 4;
  static constexpr int kEdge = KP * kCB * 16;
  static constexpr int kSmem = 3 * (kRaw + kEdge) + 2 * (kRed + kOut);
  static_assert(KP >= 1 && KP <= 8 && (KP & (KP - 1)) == 0, "KP");
  static_assert(kRaw % 16 == 0 && kRawChan % 16 == 0, "16-byte stages");
};

// Grid (n_blk, n_seg, B), Main<T, KP>::kThreads threads, kSmem bytes.
template <typename T, int KP>
__global__ void __launch_bounds__(Main<T, KP>::kThreads,
                                  Main<T, KP>::kMinBlocks)
mamba_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ Dp,
                      const T* __restrict__ dy,
                      const float* __restrict__ edges,
                      const float* __restrict__ carry, T* __restrict__ dx,
                      T* __restrict__ ddelta, float* __restrict__ dbc_part,
                      float* __restrict__ dA_part,
                      float* __restrict__ dD_part, int T_len, int Dm, int N,
                      int seg_len, int piece_len, int n_pieces,
                      bool aligned, bool edges_aligned) {
  using M = Main<T, KP>;
  constexpr int CB = M::kCB, NP = M::kNP, kThreads = M::kThreads;
  constexpr int kHalf = kWin / 2;  // steps a thread keeps in registers
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw_base = smem;
  float* red_base = reinterpret_cast<float*>(smem + 3 * M::kRaw);
  float* out_base = red_base + 2 * M::kRed / 4;
  float* edge_base = out_base + 2 * M::kOut / 4;

  const int tid = threadIdx.x;
  const int lane = tid % 32, wi = tid / 32;
  const int k = lane % KP;                 // group of 4 states
  const int c = wi * M::kCW + lane / KP;  // channel in the block
  const int blk = blockIdx.x, seg = blockIdx.y, b = blockIdx.z;
  const int n_seg = gridDim.y, batch = gridDim.z;
  const int d0 = blk * CB, d = d0 + c;
  const bool live = d < Dm;
  const int valid_cols = min(CB, Dm - d0);
  const int64_t row0 = static_cast<int64_t>(b) * T_len;
  const int t_lo = seg * seg_len;
  const int n_w = (min(seg_len, T_len - t_lo) + kWin - 1) / kWin;
  const int e_lo = t_lo / kWin;
  const int n_edges = (T_len + kWin - 1) / kWin;
  const int K4 = (N + 3) / 4;
  const int64_t n_bc = static_cast<int64_t>(batch) * T_len * N;

  // a2 = A log2 e; the ddelta term sum_n g A a h_{t-1} is taken as
  // ln 2 sum_n g a2 a h_{t-1}
  float a2[4], g[4], an[4], dA[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 4 * k + j;
    a2[j] = live && n < N ? A[static_cast<int64_t>(d) * N + n] * kLog2e : 0.f;
    g[j] = 0.f;
    an[j] = 1.f;  // g enters the segment's last step as G: a = 1, g = G
    dA[j] = 0.f;
  }
  const float dd = live ? Dp[d] : 0.f;
  float dD = 0.f;
  // G: the later pieces folded from the last to the first
  if (seg + 1 < n_seg && live) {
    const int64_t plane = static_cast<int64_t>(batch) * n_pieces * Dm * N;
    for (int p = n_pieces - 1; p >= seg * seg_len / piece_len; --p) {
      const float* L =
          carry + ((static_cast<int64_t>(b) * n_pieces + p) * Dm + d) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * k + j < N)
          g[j] = fmaf(L[plane + 4 * k + j], g[j], L[4 * k + j]);
    }
  }

  // raw inputs and the edge of window w: 16-byte cp.async copies when
  // `aligned` (zero-filled past the valid bytes), else plain loads; steps
  // past T and channels past Dm read as zero (delta = 0 makes a step the
  // identity, and dy = 0 keeps g at zero)
  auto stage = [&](int w) {
    unsigned char* raw = raw_base + w % 3 * M::kRaw;
    const int t0 = t_lo + w * kWin;
    const int rows = min(kWin, T_len - t0);
    T* xs = reinterpret_cast<T*>(raw);
    T* bs = reinterpret_cast<T*>(raw + 3 * M::kRawChan);
    T* cs = reinterpret_cast<T*>(raw + 3 * M::kRawChan + M::kRawBC);
    const int64_t bc0 = (row0 + t0) * N;
    // the edge: K4 x CB 16-byte rows, one a channel
    float* es = edge_base + w % 3 * KP * CB * 4;
    const float* esrc = edges + ((static_cast<int64_t>(b) * n_edges + e_lo +
                                  w) * K4 * Dm + d0) * 4;
#pragma unroll
    for (int q = 0; q < (KP * CB + kThreads - 1) / kThreads; ++q) {
      const int i = tid + q * kThreads;
      const int k4 = i / CB, cc = i % CB;
      if (k4 < K4) {
        const float* src = esrc + (static_cast<int64_t>(k4) * Dm + cc) * 4;
        float* dst = es + i * 4;
        if (edges_aligned) {
          cp_async16(dst, cc < valid_cols ? src : edges,
                     cc < valid_cols ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[e] = cc < valid_cols ? src[e] : 0.f;
        }
      }
    }
    if (aligned) {
      constexpr int per = 16 / sizeof(T), vcols = CB / per;
      constexpr int n_cp = 3 * kWin * vcols;
#pragma unroll
      for (int q = 0; q < (n_cp + kThreads - 1) / kThreads; ++q) {
        const int i = tid + q * kThreads;
        if (n_cp % kThreads != 0 && i >= n_cp) break;
        const int a3 = i / (kWin * vcols), r = i / vcols % kWin;
        const int cc = i % vcols * per;
        const int n = r < rows ? max(0, min(per, valid_cols - cc)) : 0;
        const T* src = a3 == 0 ? x : a3 == 1 ? delta : dy;
        cp_async16(xs + (a3 * kWin + r) * CB + cc,
                   n ? src + (row0 + t0 + r) * Dm + d0 + cc : src,
                   n * static_cast<int>(sizeof(T)));
      }
      // B and C: rows of N values (whole copies: aligned needs N
      // sizeof(T) % 16 == 0) at a stride of NP
      const int vrow = N / per, vbc = kWin * vrow;
      for (int i = tid; i < 2 * vbc; i += kThreads) {
        const int q = i >= vbc, e = i - q * vbc, r = e / vrow;
        const int col = (e - r * vrow) * per;
        const T* src = q ? Cm : Bm;
        cp_async16((q ? cs : bs) + r * NP + col,
                   r < rows ? src + bc0 + r * N + col : src,
                   r < rows ? 16 : 0);
      }
      return;
    }
    for (int i = tid; i < 3 * kWin * CB; i += kThreads) {
      const int q = i / (kWin * CB), r = i / CB % kWin, cc = i % CB;
      const T* src = q == 0 ? x : q == 1 ? delta : dy;
      xs[i] = r < rows && cc < valid_cols
                  ? src[(row0 + t0 + r) * Dm + d0 + cc] : zero<T>();
    }
    for (int i = tid; i < 2 * kWin * NP; i += kThreads) {
      const int q = i >= kWin * NP, e = i - q * kWin * NP;
      const int r = e / NP, n = e % NP;
      (q ? cs : bs)[e] = r < rows && n < N ? (q ? Cm : Bm)[bc0 + r * N + n]
                                           : zero<T>();
    }
  };
  // window w's sums to global memory: dB, dC (the warps' sums added in
  // warp order) and dx, ddelta
  auto flush = [&](int w) {
    const float* red = red_base + (w & 1) * kWin * M::kWarps * 2 * NP;
    const float* out = out_base + (w & 1) * 2 * kWin * CB;
    const int t0 = t_lo + w * kWin;
    // two states a thread: the pair (n, n + 1) lies in one row of dB or
    // dC when N is even
    constexpr int n_pairs = kWin * NP;  // kWin steps x 2 NP values / 2
#pragma unroll
    for (int q = 0; q < (n_pairs + kThreads - 1) / kThreads; ++q) {
      const int i = tid + q * kThreads;
      const int s = i / NP, v = i % NP * 2;
      const int which = v / NP, n = v % NP;
      if ((n_pairs % kThreads == 0 || i < n_pairs) && n < N &&
          t0 + s < T_len) {
        const float* r = red + s * M::kWarps * 2 * NP + v;
        float2 sum = *reinterpret_cast<const float2*>(r);
#pragma unroll
        for (int w2 = 1; w2 < M::kWarps; ++w2) {
          const float2 e = *reinterpret_cast<const float2*>(r + w2 * 2 * NP);
          sum.x += e.x;
          sum.y += e.y;
        }
        float* o = dbc_part + (static_cast<int64_t>(which) * gridDim.x + blk) *
                                  n_bc + (row0 + t0 + s) * N + n;
        if (N % 2 == 0) {
          *reinterpret_cast<float2*>(o) = sum;
        } else {
          o[0] = sum.x;
          if (n + 1 < N) o[1] = sum.y;
        }
      }
    }
    // dx and ddelta: 16 bytes a thread when rows are 16-byte aligned (a
    // row of 64 channels is then whole vectors or none)
    if (aligned) {
      constexpr int per = 16 / sizeof(T), n_vec = 2 * kWin * CB / per;
#pragma unroll
      for (int q = 0; q < (n_vec + kThreads - 1) / kThreads; ++q) {
        const int i = (tid + q * kThreads) * per;
        const int which = i / (kWin * CB), s = i / CB % kWin, cc = i % CB;
        if ((n_vec % kThreads == 0 || i < 2 * kWin * CB) &&
            cc < valid_cols && t0 + s < T_len) {
          float v[per];
#pragma unroll
          for (int j = 0; j < per; j += 4) {
            const float4 e = *reinterpret_cast<const float4*>(out + i + j);
            v[j] = e.x, v[j + 1] = e.y, v[j + 2] = e.z, v[j + 3] = e.w;
          }
          store16((which ? ddelta : dx) + (row0 + t0 + s) * Dm + d0 + cc, v);
        }
      }
      return;
    }
    for (int i = tid; i < 2 * kWin * CB; i += kThreads) {
      const int which = i / (kWin * CB), s = i / CB % kWin, cc = i % CB;
      if (cc < valid_cols && t0 + s < T_len)
        store((which ? ddelta : dx) + (row0 + t0 + s) * Dm + d0 + cc, out[i]);
    }
  };

  // the padding states of B and C (cp.async writes only the first N)
  if (aligned && N < NP) {
    for (int i = tid; i < 3 * 2 * kWin * NP; i += kThreads) {
      const int st = i / (2 * kWin * NP), e = i % (2 * kWin * NP);
      if (e % NP >= N)
        reinterpret_cast<T*>(raw_base + st * M::kRaw + 3 * M::kRawChan)[e] =
            zero<T>();
    }
  }
  stage(n_w - 1);
  cp_async_commit();
  if (n_w >= 2) stage(n_w - 2);
  cp_async_commit();

  for (int w = n_w - 1; w >= 0; --w) {
    // One barrier a window.  After it: window w's inputs and edge have
    // landed (staged two windows ahead, three stages deep: one commit group
    // a window, the newest may still be in flight); every thread is done
    // with window w + 1's compute, so its sums are complete, the sums'
    // buffers of parity w + 1 are free, and so are window w + 1's stage and
    // edge buffer, which window w - 2's take.
    cp_async_wait<1>();
    __syncthreads();
    if (w >= 2) stage(w - 2);
    cp_async_commit();
    if (w + 1 < n_w) flush(w + 1);

    const unsigned char* raw = raw_base + w % 3 * M::kRaw;
    const T* xs = reinterpret_cast<const T*>(raw) + c;
    const T* ds = xs + kWin * CB;
    const T* ys = ds + kWin * CB;
    const T* bs = reinterpret_cast<const T*>(raw + 3 * M::kRawChan) + 4 * k;
    const T* cs = bs + kWin * NP;
    float* red = red_base + (w & 1) * kWin * M::kWarps * 2 * NP +
                 wi * 2 * NP;
    float* out = out_base + (w & 1) * 2 * kWin * CB + c;
    // the state entering the window (states past N read as zero)
    const float4* edge = reinterpret_cast<const float4*>(
        edge_base + w % 3 * KP * CB * 4) + k * CB + c;
    auto edge_state = [&](float h[4]) {
      const float4 e = *edge;
      h[0] = e.x, h[1] = e.y, h[2] = e.z, h[3] = e.w;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * k + j >= N) h[j] = 0.f;
    };
    // the state after the first half
    float hm[4];
    edge_state(hm);
#pragma unroll
    for (int s = 0; s < kHalf; ++s) {
      const float dl = widen(ds[s * CB]), dlx = dl * widen(xs[s * CB]);
      float bj[4];
      load4(bs + s * NP, bj);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hm[j] = fmaf(ex2(dl * a2[j]), hm[j], dlx * bj[j]);
    }
#pragma unroll 1
    for (int half = 1; half >= 0; --half) {
      const int base = half * kHalf;
      // the half's states h_t and decays a_t
      float h0[4], h[kHalf][4], a[kHalf][4];
      if (half) {
#pragma unroll
        for (int j = 0; j < 4; ++j) h0[j] = hm[j];
      } else {
        edge_state(h0);
      }
#pragma unroll
      for (int s = 0; s < kHalf; ++s) {
        const int t = base + s;
        const float dl = widen(ds[t * CB]), dlx = dl * widen(xs[t * CB]);
        float bj[4];
        load4(bs + t * NP, bj);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[s][j] = ex2(dl * a2[j]);
          h[s][j] = fmaf(a[s][j], s ? h[s - 1][j] : h0[j], dlx * bj[j]);
        }
      }
      // g backwards over the half
#pragma unroll
      for (int s = kHalf - 1; s >= 0; --s) {
        const int t = base + s;
        const float xv = widen(xs[t * CB]), dl = widen(ds[t * CB]);
        const float4 ch = make_float4(dl, dl * xv, xv, widen(ys[t * CB]));
        float bj[4], cj[4];
        load4(bs + t * NP, bj);
        load4(cs + t * NP, cj);
        float p0 = 0.f, p1 = 0.f, v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          g[j] = fmaf(an[j], g[j], ch.w * cj[j]);
          const float gah = g[j] * (a[s][j] * (s ? h[s - 1][j] : h0[j]));
          v[j] = g[j] * ch.y;         // dB_t[n]'s term
          v[4 + j] = ch.w * h[s][j];  // dC_t[n]'s term
          p0 = fmaf(g[j], bj[j], p0);
          p1 = fmaf(gah, a2[j], p1);
          dA[j] = fmaf(gah, ch.x, dA[j]);
          an[j] = a[s][j];
        }
        dD = fmaf(ch.w, ch.z, dD);
        // dx and ddelta: the channel's KP lanes' parts
        const float q0 = ch.x * p0, q1 = fmaf(ch.z, p0, kLn2 * p1);
        if constexpr (KP == 1) {
          out[t * CB] = q0 + dd * ch.w;
          out[(kWin + t) * CB] = q1;
        } else {
          const bool hi = lane & (KP / 2);
          float r = (hi ? q1 : q0) +
                    __shfl_xor_sync(kFull, hi ? q0 : q1, KP / 2);
#pragma unroll
          for (int off = KP / 4; off >= 1; off /= 2)
            r += __shfl_xor_sync(kFull, r, off);
          if (k == 0) out[t * CB] = r + dd * ch.w;
          if (k == KP / 2) out[(kWin + t) * CB] = r;
        }
        // dB and dC: the warp's channels' values; level 16 keeps dB's (lane
        // bit 4 clear) or dC's, level 8 two of the four states, level 4 one
        const bool h16 = lane & 16;
        float w4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w4[j] = (h16 ? v[4 + j] : v[j]) +
                  __shfl_xor_sync(kFull, h16 ? v[j] : v[4 + j], 16);
        const bool h8 = lane & 8;
        float w2[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          w2[j] = (h8 ? w4[2 + j] : w4[j]) +
                  __shfl_xor_sync(kFull, h8 ? w4[j] : w4[2 + j], 8);
        float* rs = red + t * M::kWarps * 2 * NP + (h16 ? NP : 0) + 4 * k +
                    (h8 ? 2 : 0);
        if constexpr (M::kCW >= 8) {
          const bool h4 = lane & 4;
          float r = (h4 ? w2[1] : w2[0]) +
                    __shfl_xor_sync(kFull, h4 ? w2[0] : w2[1], 4);
#pragma unroll
          for (int off = 2; off >= KP; off /= 2)
            r += __shfl_xor_sync(kFull, r, off);
          if ((lane & (4 - KP)) == 0) rs[h4 ? 1 : 0] = r;
        } else {
          rs[0] = w2[0];
          rs[1] = w2[1];
        }
      }
    }
  }
  __syncthreads();
  flush(0);
  if (live) {
    const int64_t part = (static_cast<int64_t>(b) * n_seg + seg) * Dm + d;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * k + j < N) dA_part[part * N + 4 * k + j] = dA[j];
    if (k == 0) dD_part[part] = dD;
  }
}

// dB, dC = the channel blocks' partials added in block order; dA, dD = the
// (batch row, segment) partials added in that order.  One thread an output.
template <typename T>
__global__ void mamba_scan_bwd_reduce_kernel(
    const float* __restrict__ dbc_part, const float* __restrict__ dA_part,
    const float* __restrict__ dD_part, T* __restrict__ dBm,
    T* __restrict__ dCm, float* __restrict__ dA, float* __restrict__ dD,
    int batch, int T_len, int Dm, int N, int n_blk, int n_seg) {
  const int64_t n_bc = static_cast<int64_t>(batch) * T_len * N;
  const int64_t n_a = static_cast<int64_t>(Dm) * N;
  const int64_t total = 2 * n_bc + n_a + Dm;
  const int n_parts = batch * n_seg;
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
      for (int q = 0; q < n_parts; ++q) sum += dA_part[q * n_a + j];
      dA[j] = sum;
    } else {
      const int64_t j = i - 2 * n_bc - n_a;
      float sum = 0.f;
      for (int q = 0; q < n_parts; ++q) sum += dD_part[q * Dm + j];
      dD[j] = sum;
    }
  }
}

struct Args {
  const void *x, *delta, *A, *Bm, *Cm, *Dp, *dy, *edges;
  void *dx, *ddelta, *dA, *dBm, *dCm, *dD, *dbc_part, *dA_part, *dD_part,
      *carry;
  int batch, T_len, Dm, N, seg_len, piece_len, n_seg, n_pieces, n_blk;
  cudaStream_t stream;
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Opt a kernel in to its dynamic shared memory (above 48 KB), once per
// instantiation, outside any CUDA graph capture of a launch.
template <typename F>
cudaError_t opt_in(F kernel, int smem, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  *done = err == cudaSuccess;
  return err;
}
template <typename T, int KP>
cudaError_t opt_in_main() {
  static bool done = false;
  return opt_in(mamba_scan_bwd_kernel<T, KP>, Main<T, KP>::kSmem, &done);
}
template <typename T, int K>
cudaError_t opt_in_carry() {
  static bool done = false;
  return opt_in(mamba_scan_bwd_carry_kernel<T, K>, Carry<T, K>::kSmem, &done);
}

template <typename T, int KP>
int launch_main(const Args& a, bool aligned) {
  using M = Main<T, KP>;
  auto kernel = mamba_scan_bwd_kernel<T, KP>;
  const cudaError_t err = opt_in_main<T, KP>();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.n_blk, a.n_seg, a.batch), M::kThreads, M::kSmem,
           a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.delta),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), static_cast<const float*>(a.Dp),
      static_cast<const T*>(a.dy), static_cast<const float*>(a.edges),
      static_cast<const float*>(a.carry), static_cast<T*>(a.dx),
      static_cast<T*>(a.ddelta), static_cast<float*>(a.dbc_part),
      static_cast<float*>(a.dA_part), static_cast<float*>(a.dD_part),
      a.T_len, a.Dm, a.N, a.seg_len, a.piece_len, a.n_pieces, aligned,
      aligned16(a.edges));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_carry(const Args& a, bool aligned) {
  const cudaError_t err = opt_in_carry<T, K>();
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba_scan_bwd_carry_kernel<T, K>
      <<<dim3((a.Dm + kCarryChannels - 1) / kCarryChannels, a.n_pieces,
              a.batch),
         Carry<T, K>::kThreads, Carry<T, K>::kSmem, a.stream>>>(
          static_cast<const T*>(a.delta), static_cast<const float*>(a.A),
          static_cast<const T*>(a.Cm), static_cast<const T*>(a.dy),
          static_cast<float*>(a.carry), a.T_len, a.Dm, a.N, a.seg_len,
          a.piece_len, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_all(const Args& a) {
  // 16-byte copies: every tensor's start and a row of x, of B and of C on
  // 16 bytes
  const bool aligned =
      aligned16(a.x) && aligned16(a.delta) && aligned16(a.dy) &&
      aligned16(a.Bm) && aligned16(a.Cm) &&
      static_cast<int64_t>(a.Dm) * sizeof(T) % 16 == 0 &&
      a.N * sizeof(T) % 16 == 0;
  int rc = 0;
  if (a.n_pieces > 0) {
    switch ((a.N + kCarryStates - 1) / kCarryStates) {
#define MAMBA_BWD_CARRY(K) \
  case K: rc = launch_carry<T, K>(a, aligned); break;
      MAMBA_BWD_CARRY(1) MAMBA_BWD_CARRY(2) MAMBA_BWD_CARRY(3)
      MAMBA_BWD_CARRY(4) MAMBA_BWD_CARRY(5) MAMBA_BWD_CARRY(6)
      MAMBA_BWD_CARRY(7) MAMBA_BWD_CARRY(8)
#undef MAMBA_BWD_CARRY
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
  }
  const int groups = (a.N + 3) / 4;
  if (groups <= 1) rc = launch_main<T, 1>(a, aligned);
  else if (groups <= 2) rc = launch_main<T, 2>(a, aligned);
  else if (groups <= 4) rc = launch_main<T, 4>(a, aligned);
  else rc = launch_main<T, 8>(a, aligned);
  if (rc != 0) return rc;
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
          static_cast<float*>(a.dD), a.batch, a.T_len, a.Dm, a.N, a.n_blk,
          a.n_seg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KP>
int occupancy(int* blocks, int* threads, int* smem) {
  using M = Main<T, KP>;
  auto kernel = mamba_scan_bwd_kernel<T, KP>;
  const cudaError_t err = opt_in_main<T, KP>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = M::kThreads;
  *smem = M::kSmem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, M::kThreads, M::kSmem));
}

template <typename T>
int occupancy_of(int N, int* blocks, int* threads, int* smem) {
  const int groups = (N + 3) / 4;
  if (groups <= 1) return occupancy<T, 1>(blocks, threads, smem);
  if (groups <= 2) return occupancy<T, 2>(blocks, threads, smem);
  if (groups <= 4) return occupancy<T, 4>(blocks, threads, smem);
  return occupancy<T, 8>(blocks, threads, smem);
}

}  // namespace

// Three launches on `stream`: the carry (only when T has more than one
// segment), the gradient and the sums of its partials; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for N
// outside [1, 32], a batch past the grid, a plan the kernels do not take
// (or whose counts disagree with seg_len and piece_len) or an unknown
// dtype.  dtype 0: x, delta, Bm, Cm, dy, dx, ddelta, dBm and
// dCm are fp32; 1: bf16.  All pointers are device pointers to contiguous
// data: x, delta, dy, dx, ddelta [B, T, Dm]; A, dA [Dm, N] fp32; Bm, Cm,
// dBm, dCm [B, T, N]; Dp, dD [Dm] fp32; edges [B, ceil(T / 16),
// ceil(N / 4), Dm, 4] fp32 from mamba_scan_train_launch.  The plan:
// segments of seg_len steps and carry pieces of piece_len, both multiples
// of 16, piece_len dividing seg_len; the scratch (fp32) dbc_part [2,
// n_blk, B, T, N], dA_part [B, n_seg, Dm, N], dD_part [B, n_seg, Dm] and
// carry [2, B, n_pieces, Dm, N], with n_blk = ceil(Dm / 64), n_seg =
// ceil(T / seg_len) and n_pieces = ceil((T - seg_len) / piece_len) when
// n_seg > 1, else 0 and carry unused: the caller passes the three counts
// its scratch was sized by, and they are checked against these.
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* delta, const void* A, const void* Bm,
    const void* Cm, const void* Dp, const void* dy, const void* edges,
    void* dx, void* ddelta, void* dA, void* dBm, void* dCm, void* dD,
    void* dbc_part, void* dA_part, void* dD_part, void* carry, int batch,
    int T, int Dm, int N, int seg_len, int piece_len, int n_seg,
    int n_pieces, int n_blk, int dtype, void* stream) {
  if (N < 1 || N > 32 || batch > 65535 || seg_len < kWin ||
      seg_len % kWin != 0 || piece_len < kWin || piece_len % kWin != 0 ||
      seg_len % piece_len != 0 || n_seg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || T <= 0 || Dm <= 0) return static_cast<int>(cudaSuccess);
  const int want_seg = (T + seg_len - 1) / seg_len;
  const int want_pieces =
      want_seg > 1 ? (T - seg_len + piece_len - 1) / piece_len : 0;
  if (n_seg != want_seg || n_pieces != want_pieces ||
      n_blk != (Dm + Main<float, 1>::kCB - 1) / Main<float, 1>::kCB)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, delta, A, Bm, Cm, Dp, dy, edges, dx, ddelta, dA, dBm, dCm,
               dD, dbc_part, dA_part, dD_part, carry, batch, T, Dm, N,
               seg_len, piece_len, n_seg, n_pieces, n_blk,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_all<float>(a);
    case 1: return launch_all<__nv_bfloat16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The gradient launch's threads a block, dynamic shared memory a block and
// the blocks an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// for N states and dtype; returns a cudaError_t.
extern "C" int mamba_scan_bwd_occupancy(int N, int dtype, int* blocks,
                                        int* threads, int* smem) {
  if (N < 1 || N > 32) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return occupancy_of<float>(N, blocks, threads, smem);
    case 1: return occupancy_of<__nv_bfloat16>(N, blocks, threads, smem);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
