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
// It writes y [B, T, Dm] and the final state h_T [B, Dm, N], all fp32.  The
// TPU kernel returned only y (its state lived in VMEM scratch), so the JAX
// serve path ran its prefill through the jnp reference to get h_T; here
// prefill runs this kernel and takes h_T from it.
//
// Design.  The TPU kernel carried h across a sequential grid axis of time
// chunks; GPU blocks run in no order, so here each thread walks the whole
// of T itself and keeps its state element in a register.  One thread per
// (b, d, n) state element: the P lanes of a channel (P = N rounded up to a
// power of two, at most 32, so a channel never straddles a warp) reduce
// y_t with P-wide xor shuffles, and lanes n >= N hold a zero state.  Loads
// of x_t and delta_t are one address per channel, coalesced across the
// channels of a warp; B_t and C_t are shared by every channel and stay in
// the L1 cache.  Any T >= 1, any Dm and 1 <= N <= 32.
//
// Bound.  At the serve path's prefill shape (B = 1, T = 1536, Dm = 8192,
// N = 16) the scan moves ~152 MB (x, delta and y, 50 MB each, once) and
// does ~1.4 GFLOP, so it is bound by bytes: ~0.045 ms at 3.35 TB/s.  This
// kernel issues a shuffle reduction and an exp per state element per step
// and walks T serially in each thread; keeping a channel's N states in one
// thread, staging x/delta/B/C chunks in shared memory and a chunked
// (SSD-style) parallel scan over T are the work of a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int P>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ delta,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ Dp,
                  float* __restrict__ y, float* __restrict__ h_out,
                  int batch, int T, int Dm, int N) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t c = g / P;            // channel index over batch * Dm
  const int n = static_cast<int>(g % P);
  if (c >= static_cast<int64_t>(batch) * Dm) return;  // whole groups only
  const int b = static_cast<int>(c / Dm);
  const int d = static_cast<int>(c % Dm);
  const int lane = threadIdx.x & 31;
  // this channel's P lanes (P & 31 keeps the shift defined when P == 32)
  const unsigned mask =
      P == 32 ? 0xffffffffu : (((1u << (P & 31)) - 1u) << (lane & ~(P - 1)));
  const bool live = n < N;

  const float a = live ? A[static_cast<int64_t>(d) * N + n] : 0.f;
  const float dd = Dp[d];
  const int64_t row0 = static_cast<int64_t>(b) * T;
  float h = 0.f;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const int64_t off = (row0 + t) * Dm + d;
    const float xt = x[off];
    const float dt = delta[off];
    float bn = 0.f, cn = 0.f;
    if (live) {
      bn = Bm[(row0 + t) * N + n];
      cn = Cm[(row0 + t) * N + n];
    }
    h = expf(dt * a) * h + (dt * xt) * bn;
    float part = h * cn;
#pragma unroll
    for (int o = P / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(mask, part, o);
    if (n == 0) y[off] = part + xt * dd;
  }
  if (live) h_out[(static_cast<int64_t>(b) * Dm + d) * N + n] = h;
}

template <int P>
void launch(const float* x, const float* delta, const float* A, const float* Bm,
            const float* Cm, const float* Dp, float* y, float* h_out,
            int batch, int T, int Dm, int N, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(batch) * Dm * P;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  mamba_scan_kernel<P><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, delta, A, Bm, Cm, Dp, y, h_out, batch, T, Dm, N);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for N outside [1, 32] or a grid too large.  All
// pointers are device pointers to contiguous fp32 data: x, delta and y
// [B, T, Dm]; A [Dm, N]; Bm, Cm [B, T, N]; Dp [Dm]; h_out [B, Dm, N].
extern "C" int mamba_scan_launch(const void* x, const void* delta,
                                 const void* A, const void* Bm, const void* Cm,
                                 const void* Dp, void* y, void* h_out,
                                 int batch, int T, int Dm, int N,
                                 void* stream) {
  if (N < 1 || N > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || T <= 0 || Dm <= 0) return static_cast<int>(cudaSuccess);
  int P = 1;
  while (P < N) P <<= 1;
  if (static_cast<int64_t>(batch) * Dm * P / kThreads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(delta);
  const auto* af = static_cast<const float*>(A);
  const auto* bf = static_cast<const float*>(Bm);
  const auto* cf = static_cast<const float*>(Cm);
  const auto* pf = static_cast<const float*>(Dp);
  auto* yf = static_cast<float*>(y);
  auto* hf = static_cast<float*>(h_out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: launch<1>(xf, df, af, bf, cf, pf, yf, hf, batch, T, Dm, N, s); break;
    case 2: launch<2>(xf, df, af, bf, cf, pf, yf, hf, batch, T, Dm, N, s); break;
    case 4: launch<4>(xf, df, af, bf, cf, pf, yf, hf, batch, T, Dm, N, s); break;
    case 8: launch<8>(xf, df, af, bf, cf, pf, yf, hf, batch, T, Dm, N, s); break;
    case 16: launch<16>(xf, df, af, bf, cf, pf, yf, hf, batch, T, Dm, N, s); break;
    default: launch<32>(xf, df, af, bf, cf, pf, yf, hf, batch, T, Dm, N, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
