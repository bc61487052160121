// Persistent fused PDHG kernel for the P1-LR window LP (CUDA C++, sm_90a).
//
// Replaces the JAX package's kernels/pdhg_fused.py::_pallas_phase, which
// runs `iters` iterations of _fused_step with the eight state tensors held
// in TPU VMEM.  Here one thread block owns one window of the padded batch
// and runs the whole iteration loop inside the kernel (the loop takes the
// place of the Pallas sequential grid), so the state never leaves the
// card between iterations.  The arithmetic is that of
// repro_torch/kernels/pdhg_fused.py::_fused_step; only the summation
// order differs (fixed here, so results repeat run to run).
//
// Layout (per window; all arrays contiguous, window-major):
//   x, tau_x (N,M,H+1)   y_eq, sig_eq (N,M)   y_mem, sig_mem, R (N)
//   A, y_ax, T, L, tau_A, tau_prec, tAT, tAL (N,H,U)
//   y_route, y_lat, y_load, sig_route, sig_lat, sig_load, ddl, s_u (U)
//   sizes (M,H+1)        m_idx (U) int32, the user's model, -1 = padding
//
// Threads stride over users: a thread owns all N*H entries of its users,
// so the three per-user duals are thread-local sums in n-major, h-minor
// order.  x, its over-relaxed copy, y_eq, y_mem and the (N,H,M) user
// contraction live in shared memory; A, y_ax and the (N,H,U) constants stay
// in global memory (about 0.35 MB a window in float32, 0.7 MB in float64 at
// N=6, U=600, H=3, so a 16-window batch sits in the 50 MB L2).  Each
// iteration has three phases separated by __syncthreads():
//   1. K^T y contraction gsub[n,h,m] = sum_u y_ax[n,h,u] [m_u = m]: one warp
//      per (n,h) row, per-lane partials over a strided user range, then a
//      fixed butterfly of shuffles (no atomics);
//   2. the clipped x prox step and its over-relaxation xb;
//   3. per user: the A prox step, over-relaxation, K on (xb, Ab) and every
//      user-indexed dual ascent; the x-side duals y_eq / y_mem from xb.
//
// What bounds it on an H100: not bytes and not FLOPs.  A window's work per
// iteration is ~22 operations on each of its N*H*U routing entries (about
// 0.25 MFLOP at N=6, U=600), and one block per window keeps 16 of the 132
// SMs busy, so each iteration costs the latency of its three block-wide
// barriers plus the L2 round trips of one SM streaming ~10 (N,H,U) arrays
// (chip_smoke.py measured 21.5 us per float32 iteration of the 16-window
// grid on an H100 SXM at 700 W, where the operation bound is 0.05 us).
// The design keeps every iteration inside one launch (no per-iteration
// launch or device-memory round trip of the x-side state) and keeps the
// reductions deterministic.  Splitting a window's users across a cluster
// of CTAs is the next step for speed.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxModels = 16;   // MAX_MODELS in pdhg_fused.py
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
struct Params {
  // state, advanced in place (never read through the read-only cache:
  // the kernel writes it)
  T* x;
  T* A;
  T* y_eq;
  T* y_mem;
  T* y_route;
  T* y_lat;
  T* y_load;
  T* y_ax;
  // constants
  const int* m_idx;
  const T* sizes;
  const T* R;
  const T* ddl;
  const T* s_u;
  const T* Tm;
  const T* Lm;
  const T* sig_eq;
  const T* sig_mem;
  const T* sig_route;
  const T* sig_lat;
  const T* sig_load;
  const T* tau_x;
  const T* tau_A;
  const T* tau_prec;
  const T* tAT;
  const T* tAL;
  int N, M, H, U, iters;
};

template <typename T>
__device__ __forceinline__ T clip01(T v) {
  return v < T(0) ? T(0) : (v > T(1) ? T(1) : v);
}

template <typename T>
__device__ __forceinline__ T relu(T v) {
  return v < T(0) ? T(0) : v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pdhg_fused_kernel(Params<T> p) {
  const int N = p.N, M = p.M, H = p.H, U = p.U, Hp1 = H + 1;
  const int NX = N * M * Hp1, NM = N * M, NH = N * H;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_x = reinterpret_cast<T*>(smem_raw);
  T* s_xb = s_x + NX;
  T* s_tau_x = s_xb + NX;
  T* s_sizes = s_tau_x + NX;          // M*(H+1)
  T* s_y_eq = s_sizes + M * Hp1;      // N*M
  T* s_sig_eq = s_y_eq + NM;          // N*M
  T* s_y_mem = s_sig_eq + NM;         // N
  T* s_gsub = s_y_mem + N;            // N*H*M

  // this window's slices
  const size_t nhu = static_cast<size_t>(NH) * U;
  T* x = p.x + b * NX;
  T* A = p.A + b * nhu;
  T* y_eq = p.y_eq + b * NM;
  T* y_mem = p.y_mem + b * N;
  T* y_route = p.y_route + b * U;
  T* y_lat = p.y_lat + b * U;
  T* y_load = p.y_load + b * U;
  T* y_ax = p.y_ax + b * nhu;
  const int* m_idx = p.m_idx + b * U;
  const T* R = p.R + b * N;
  const T* ddl = p.ddl + b * U;
  const T* s_u = p.s_u + b * U;
  const T* Tm = p.Tm + b * nhu;
  const T* Lm = p.Lm + b * nhu;
  const T* sig_mem = p.sig_mem + b * N;
  const T* sig_route = p.sig_route + b * U;
  const T* sig_lat = p.sig_lat + b * U;
  const T* sig_load = p.sig_load + b * U;
  const T* tau_A = p.tau_A + b * nhu;
  const T* tau_prec = p.tau_prec + b * nhu;
  const T* tAT = p.tAT + b * nhu;
  const T* tAL = p.tAL + b * nhu;

  for (int i = tid; i < NX; i += kThreads) {
    s_x[i] = x[i];
    s_tau_x[i] = p.tau_x[b * NX + i];
  }
  for (int i = tid; i < M * Hp1; i += kThreads) s_sizes[i] = p.sizes[b * M * Hp1 + i];
  for (int i = tid; i < NM; i += kThreads) {
    s_y_eq[i] = y_eq[i];
    s_sig_eq[i] = p.sig_eq[b * NM + i];
  }
  for (int i = tid; i < N; i += kThreads) s_y_mem[i] = y_mem[i];
  __syncthreads();

  for (int it = 0; it < p.iters; ++it) {
    // (1) gsub[n,h,m] = sum_u y_ax[n,h,u] [m_u == m]
    for (int row = warp; row < NH; row += kWarps) {
      T part[kMaxModels];
#pragma unroll
      for (int m = 0; m < kMaxModels; ++m) part[m] = T(0);
      const T* yr = y_ax + static_cast<size_t>(row) * U;
      for (int u = lane; u < U; u += 32) {
        const T v = yr[u];
        const int mu = m_idx[u];
#pragma unroll
        for (int m = 0; m < kMaxModels; ++m) part[m] += (mu == m) ? v : T(0);
      }
#pragma unroll
      for (int m = 0; m < kMaxModels; ++m) {
        if (m < M) {  // warp-uniform
          T s = part[m];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
          if (lane == 0) s_gsub[row * M + m] = s;
        }
      }
    }
    __syncthreads();

    // (2) x prox step and over-relaxation
    for (int i = tid; i < NX; i += kThreads) {
      const int h = i % Hp1, nm = i / Hp1, m = nm % M, n = nm / M;
      T gx = s_y_eq[nm] + s_y_mem[n] * s_sizes[m * Hp1 + h];
      if (h > 0) gx = gx + (-s_gsub[(n * H + h - 1) * M + m]);
      const T xo = s_x[i];
      const T xn = clip01(xo - s_tau_x[i] * gx);
      s_x[i] = xn;
      s_xb[i] = T(2) * xn - xo;
    }
    __syncthreads();

    // (3) A prox step, over-relaxation, K on (xb, Ab), dual ascent
    for (int u = tid; u < U; u += kThreads) {
      const int mu = m_idx[u];
      const T yr = y_route[u], yl = y_lat[u], yd = y_load[u];
      T kr = T(0), kl = T(0), kd = T(0);
      for (int n = 0; n < N; ++n) {
        for (int h = 0; h < H; ++h) {
          const size_t k = static_cast<size_t>(n * H + h) * U + u;
          const T a = A[k], ya = y_ax[k];
          const T an = clip01(a - tau_A[k] * (yr + ya) - tAT[k] * yl - tAL[k] * yd + tau_prec[k]);
          A[k] = an;
          const T ab = T(2) * an - a;
          kr += ab;
          kl += ab * Tm[k];
          kd += ab * Lm[k];
          const T xa = mu >= 0 ? s_xb[(n * M + mu) * Hp1 + h + 1] : T(0);
          y_ax[k] = relu(ya + T(0.5) * (ab - xa));
        }
      }
      y_route[u] = relu(yr + sig_route[u] * (kr - T(1)));
      y_lat[u] = relu(yl + sig_lat[u] * (kl - ddl[u]));
      y_load[u] = relu(yd + sig_load[u] * (kd - s_u[u]));
    }
    for (int i = tid; i < NM; i += kThreads) {
      T k = T(0);
      for (int h = 0; h < Hp1; ++h) k += s_xb[i * Hp1 + h];
      s_y_eq[i] = s_y_eq[i] + s_sig_eq[i] * (k - T(1));
    }
    for (int n = tid; n < N; n += kThreads) {
      T k = T(0);
      for (int i = 0; i < M * Hp1; ++i) k += s_xb[n * M * Hp1 + i] * s_sizes[i];
      s_y_mem[n] = relu(s_y_mem[n] + sig_mem[n] * (k - R[n]));
    }
    __syncthreads();
  }

  for (int i = tid; i < NX; i += kThreads) x[i] = s_x[i];
  for (int i = tid; i < NM; i += kThreads) y_eq[i] = s_y_eq[i];
  for (int i = tid; i < N; i += kThreads) y_mem[i] = s_y_mem[i];
}

template <typename T>
int launch(T* x, T* A, T* y_eq, T* y_mem, T* y_route, T* y_lat, T* y_load, T* y_ax,
           const int* m_idx, const T* sizes, const T* R, const T* ddl, const T* s_u,
           const T* Tm, const T* Lm, const T* sig_eq, const T* sig_mem, const T* sig_route,
           const T* sig_lat, const T* sig_load, const T* tau_x, const T* tau_A,
           const T* tau_prec, const T* tAT, const T* tAL, int B, int N, int M, int H, int U,
           int iters, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || M > kMaxModels || H <= 0 || U <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T> p{x,     A,      y_eq,    y_mem,     y_route, y_lat,    y_load,
              y_ax,  m_idx,  sizes,   R,         ddl,     s_u,      Tm,
              Lm,    sig_eq, sig_mem, sig_route, sig_lat, sig_load, tau_x,
              tau_A, tau_prec, tAT,   tAL,       N,       M,        H,
              U,     iters};
  const int Hp1 = H + 1;
  const size_t smem =
      sizeof(T) * (3 * static_cast<size_t>(N * M * Hp1) + M * Hp1 + 2 * N * M + N + N * H * M);
  cudaError_t err = cudaFuncSetAttribute(pdhg_fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pdhg_fused_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PDHG_ARGS(T)                                                                      \
  T *x, T *A, T *y_eq, T *y_mem, T *y_route, T *y_lat, T *y_load, T *y_ax,                \
      const int *m_idx, const T *sizes, const T *R, const T *ddl, const T *s_u,           \
      const T *Tm, const T *Lm, const T *sig_eq, const T *sig_mem, const T *sig_route,    \
      const T *sig_lat, const T *sig_load, const T *tau_x, const T *tau_A,                \
      const T *tau_prec, const T *tAT, const T *tAL, int B, int N, int M, int H, int U,   \
      int iters, void *stream
#define PDHG_FWD                                                                          \
  x, A, y_eq, y_mem, y_route, y_lat, y_load, y_ax, m_idx, sizes, R, ddl, s_u, Tm, Lm,     \
      sig_eq, sig_mem, sig_route, sig_lat, sig_load, tau_x, tau_A, tau_prec, tAT, tAL, B, \
      N, M, H, U, iters, stream

// Plain C entry points, loaded with ctypes.  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int pdhg_fused_f32(PDHG_ARGS(float)) { return launch<float>(PDHG_FWD); }
extern "C" int pdhg_fused_f64(PDHG_ARGS(double)) { return launch<double>(PDHG_FWD); }
