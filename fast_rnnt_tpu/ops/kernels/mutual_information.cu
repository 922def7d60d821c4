// Mutual-information lattice recursion for NVIDIA GPUs (sm_90a), called
// from JAX through the XLA foreign function interface.
//
// Layout is the library's s-major "rows" form (ops/recursion.py):
//   px     [S, B, T1]   T1 = T + 1 (regular) or T (modified)
//   py     [S+1, B, T]
//   p      [S+1, B, T+1] float32 (forward output, backward residual)
//   boundary [B, 4] int32 rows of (s_begin, t_begin, s_end, t_end)
//   lo     [B, T] int32 pruning-band starts (used when K > 0)
//
// One block per utterance walks the lattice as a wavefront: thread s owns
// row s, keeps its own last cell in a register and exchanges one value per
// step with its neighbour row through a double-buffered shared array, so
// every step costs one __syncthreads and the carry never leaves the SM.
// Each thread loads its row's operands for kChunk steps at a time, ahead
// of the steps that use them, so the steps wait on no global memory.
// Regular lattices advance along anti-diagonals (cell t = w - s at step w,
// S+T+1 steps); modified lattices depend only on the previous column, so
// every row advances together (t = w, T+1 steps).  This is the design of
// the reference's CUDA wavefront, with the whole lattice in one launch per
// direction instead of one launch per tile diagonal.
//
// The kernels take float32 lattices (the Python wrapper widens narrower
// storage: a bf16 load path measured slower than XLA's cast around the
// call).  The -inf conventions are those of ops/numerics.py:
// logaddexp(-inf, -inf) = -inf and safe_exp maps overflowing or NaN
// exponents to 0.  The forward
// carries p in double and the backward forms p + px - p' in double: |p|
// grows to thousands over a long lattice, where a float32 ulp is ~5e-4, so
// float32 additions of O(1) arcs would accumulate that error along every
// path.  exp/log1p run in float32 on the O(1) differences.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxRows = 1024;  // one thread per lattice row
constexpr int kChunk = 16;      // wavefront steps per batch of loads

__device__ __forceinline__ double log_add(double x, double y) {
  const double m = fmax(x, y);
  if (m == -INFINITY) return -INFINITY;
  return m + static_cast<double>(
                 log1pf(expf(static_cast<float>(-fabs(x - y)))));
}

__device__ __forceinline__ float safe_exp(float x) {
  return (isnan(x) || x > 88.6f) ? 0.f : expf(x);
}

struct Masks {
  int sb, tb, se, te, T, K;
  bool modified;
  const int32_t* lo;  // row b of lo, or nullptr when K == 0

  __device__ __forceinline__ bool band(int s, int t) const {
    if (K <= 0) return true;
    const int l = __ldg(lo + min(t, T - 1));  // regular px column T: edge
    return s >= l && s < l + K;
  }
  // px[s, t]: arc (s, t) -> (s+1, t + modified)
  __device__ __forceinline__ bool px_ok(int s, int t) const {
    const int t_hi = modified ? te - 1 : te;
    return s >= sb && s < se && t >= tb && t <= t_hi && band(s, t);
  }
  // py[s, t]: arc (s, t) -> (s, t+1)
  __device__ __forceinline__ bool py_ok(int s, int t) const {
    return s >= sb && s <= se && t >= tb && t < te && band(s, t);
  }
};

__device__ __forceinline__ Masks make_masks(const int32_t* boundary,
                                            const int32_t* lo, int b, int T,
                                            int K, bool modified) {
  Masks m;
  m.sb = boundary[4 * b + 0];
  m.tb = boundary[4 * b + 1];
  m.se = boundary[4 * b + 2];
  m.te = boundary[4 * b + 3];
  m.T = T;
  m.K = (T > 0) ? K : 0;
  m.modified = modified;
  m.lo = (m.K > 0) ? lo + static_cast<size_t>(b) * T : nullptr;
  return m;
}

template <bool kModified>
__global__ void mi_forward_kernel(const float* __restrict__ px,
                                  const float* __restrict__ py,
                                  const int32_t* __restrict__ boundary,
                                  const int32_t* __restrict__ lo, int K, int S,
                                  int B, int Tn, float* __restrict__ p,
                                  float* __restrict__ scores) {
  extern __shared__ double fwd_buf[];  // [2][blockDim.x]
  double* buf = fwd_buf;
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int n = blockDim.x;
  const int T1 = kModified ? Tn : Tn + 1;
  const Masks m = make_masks(boundary, lo, b, Tn, K, kModified);
  const bool row = s <= S;

  const float* px_row =
      (row && s >= 1) ? px + (static_cast<size_t>(s - 1) * B + b) * T1 : nullptr;
  const float* py_row = row ? py + (static_cast<size_t>(s) * B + b) * Tn : nullptr;
  float* p_row = row ? p + (static_cast<size_t>(s) * B + b) * (Tn + 1) : nullptr;

  buf[s] = -INFINITY;
  buf[n + s] = -INFINITY;
  __syncthreads();

  double own = -INFINITY;  // p[s, t-1]
  const int steps = kModified ? Tn + 1 : S + Tn + 1;
  for (int w0 = 0; w0 < steps; w0 += kChunk) {
    // This chunk's arcs, masked to -inf, loaded together so that their
    // latencies overlap; the steps below then wait on no global memory.
    float vx[kChunk], vy[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = kModified ? w0 + j : w0 + j - s;
      const int tx = kModified ? t - 1 : t;  // predecessor column
      const bool in = row && t >= 0 && t <= Tn;
      vx[j] = (in && s >= 1 && tx >= 0 && m.px_ok(s - 1, tx))
                  ? px_row[tx] : -INFINITY;
      vy[j] = (in && t >= 1 && m.py_ok(s, t - 1))
                  ? py_row[t - 1] : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int w = w0 + j;
      if (w >= steps) break;  // uniform across the block
      const double* prev = buf + ((w + 1) & 1) * n;
      double* cur = buf + (w & 1) * n;
      const int t = kModified ? w : w - s;
      double val = -INFINITY;
      if (row && t >= 0 && t <= Tn) {
        double a = s >= 1 ? prev[s - 1] + vx[j] : -INFINITY;
        if (s == m.sb && t == m.tb) a = log_add(a, 0.0);
        val = log_add(a, own + vy[j]);
        p_row[t] = static_cast<float>(val);
        own = val;
        if (s == m.se && t == m.te) scores[b] = static_cast<float>(val);
      }
      cur[s] = val;
      __syncthreads();
    }
  }
}

template <bool kModified>
__global__ void mi_backward_kernel(const float* __restrict__ px,
                                   const float* __restrict__ py,
                                   const float* __restrict__ p,
                                   const int32_t* __restrict__ boundary,
                                   const int32_t* __restrict__ lo, int K,
                                   const float* __restrict__ ans_grad, int S,
                                   int B, int Tn, float* __restrict__ px_grad,
                                   float* __restrict__ py_grad) {
  extern __shared__ float bwd_buf[];  // g: [2][n], then p: [2][n]
  float* buf = bwd_buf;
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int n = blockDim.x;
  const int T1 = kModified ? Tn : Tn + 1;
  const Masks m = make_masks(boundary, lo, b, Tn, K, kModified);
  const bool row = s <= S;
  const float seed = ans_grad[b];

  const size_t px_off = (static_cast<size_t>(s) * B + b) * T1;
  const float* px_row = (row && s < S) ? px + px_off : nullptr;
  float* gx_row = (row && s < S) ? px_grad + px_off : nullptr;
  const size_t py_off = (static_cast<size_t>(s) * B + b) * Tn;
  const float* py_row = row ? py + py_off : nullptr;
  float* gy_row = row ? py_grad + py_off : nullptr;
  const float* p_row =
      row ? p + (static_cast<size_t>(s) * B + b) * (Tn + 1) : nullptr;

  float* gbuf = buf;
  float* pbuf = buf + 2 * n;
  gbuf[s] = 0.f;
  gbuf[n + s] = 0.f;
  pbuf[s] = -INFINITY;
  pbuf[n + s] = -INFINITY;
  __syncthreads();

  float own_g = 0.f;        // g[s, t+1]
  float own_p = -INFINITY;  // p[s, t+1]
  const int steps = kModified ? Tn + 1 : S + Tn + 1;
  for (int w0 = steps - 1; w0 >= 0; w0 -= kChunk) {
    float vp[kChunk], vx[kChunk], vy[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = kModified ? w0 - j : w0 - j - s;
      const bool in = row && t >= 0 && t <= Tn;
      vp[j] = in ? p_row[t] : -INFINITY;
      vx[j] = (in && s < S && (!kModified || t < Tn) && m.px_ok(s, t))
                  ? px_row[t] : -INFINITY;
      vy[j] = (in && t < Tn && m.py_ok(s, t)) ? py_row[t] : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int w = w0 - j;
      if (w < 0) break;  // uniform across the block
      const float* prev_g = gbuf + ((w + 1) & 1) * n;
      const float* prev_p = pbuf + ((w + 1) & 1) * n;
      float* cur_g = gbuf + (w & 1) * n;
      float* cur_p = pbuf + (w & 1) * n;
      const int t = kModified ? w : w - s;
      float g = 0.f;
      float pc = -INFINITY;
      if (row && t >= 0 && t <= Tn) {
        pc = vp[j];
        // symbol arc (s, t) -> (s+1, t + modified): its target is what row
        // s+1 published on the previous step; a masked arc has vx = -inf
        // and so a zero term
        float h = 0.f;
        if (s < S && (!kModified || t < Tn)) {
          h = prev_g[s + 1] * safe_exp(static_cast<float>(
                  static_cast<double>(pc) + vx[j] - prev_p[s + 1]));
          gx_row[t] = h;
        }
        // blank arc (s, t) -> (s, t+1): this thread's previous cell
        float hy = 0.f;
        if (t < Tn) {
          hy = own_g * safe_exp(static_cast<float>(
                   static_cast<double>(pc) + vy[j] - own_p));
          gy_row[t] = hy;
        }
        g = h + hy + ((s == m.se && t == m.te) ? seed : 0.f);
        own_g = g;
        own_p = pc;
      }
      cur_g[s] = g;
      cur_p[s] = pc;
      __syncthreads();
    }
  }
}

int block_threads(int S) { return ((S + 1 + 31) / 32) * 32; }

void launch_forward(cudaStream_t stream, const float* px, const float* py,
                    const int32_t* boundary, const int32_t* lo, int K, int S,
                    int B, int Tn, bool modified, float* p, float* scores) {
  const int n = block_threads(S);
  const size_t smem = 2 * n * sizeof(double);
  if (modified) {
    mi_forward_kernel<true><<<B, n, smem, stream>>>(
        px, py, boundary, lo, K, S, B, Tn, p, scores);
  } else {
    mi_forward_kernel<false><<<B, n, smem, stream>>>(
        px, py, boundary, lo, K, S, B, Tn, p, scores);
  }
}

void launch_backward(cudaStream_t stream, const float* px, const float* py,
                     const float* p, const int32_t* boundary,
                     const int32_t* lo, int K, const float* ans_grad, int S,
                     int B, int Tn, bool modified, float* px_grad,
                     float* py_grad) {
  const int n = block_threads(S);
  const size_t smem = 4 * n * sizeof(float);
  if (modified) {
    mi_backward_kernel<true><<<B, n, smem, stream>>>(
        px, py, p, boundary, lo, K, ans_grad, S, B, Tn, px_grad, py_grad);
  } else {
    mi_backward_kernel<false><<<B, n, smem, stream>>>(
        px, py, p, boundary, lo, K, ans_grad, S, B, Tn, px_grad, py_grad);
  }
}

using F32 = ffi::Buffer<ffi::F32>;

ffi::Error check_shapes(const F32& px, const F32& py, int* S, int* B, int* Tn,
                        bool* modified) {
  const auto dx = px.dimensions();
  const auto dy = py.dimensions();
  if (dx.size() != 3 || dy.size() != 3) {
    return ffi::Error::InvalidArgument("px and py must be rank 3");
  }
  *S = static_cast<int>(dy[0]) - 1;
  *B = static_cast<int>(dy[1]);
  *Tn = static_cast<int>(dy[2]);
  if (dx[0] != *S || dx[1] != *B || (dx[2] != *Tn && dx[2] != *Tn + 1)) {
    return ffi::Error::InvalidArgument("px shape does not match py");
  }
  if (*S + 1 > kMaxRows) {
    return ffi::Error::InvalidArgument("S + 1 exceeds 1024 lattice rows");
  }
  *modified = dx[2] == *Tn;
  return ffi::Error::Success();
}

ffi::Error finish() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error MiForwardImpl(cudaStream_t stream, F32 px, F32 py,
                         ffi::Buffer<ffi::S32> boundary,
                         ffi::Buffer<ffi::S32> lo, int64_t K,
                         ffi::Result<F32> p, ffi::Result<F32> scores) {
  int S, B, Tn;
  bool modified;
  const ffi::Error e = check_shapes(px, py, &S, &B, &Tn, &modified);
  if (e.failure()) return e;
  if (B == 0) return ffi::Error::Success();
  launch_forward(stream, px.typed_data(), py.typed_data(),
                 boundary.typed_data(), lo.typed_data(), static_cast<int>(K),
                 S, B, Tn, modified, p->typed_data(), scores->typed_data());
  return finish();
}

ffi::Error MiBackwardImpl(cudaStream_t stream, F32 px, F32 py, F32 p,
                          ffi::Buffer<ffi::S32> boundary,
                          ffi::Buffer<ffi::S32> lo, F32 ans_grad, int64_t K,
                          ffi::Result<F32> px_grad, ffi::Result<F32> py_grad) {
  int S, B, Tn;
  bool modified;
  const ffi::Error e = check_shapes(px, py, &S, &B, &Tn, &modified);
  if (e.failure()) return e;
  if (B == 0) return ffi::Error::Success();
  launch_backward(stream, px.typed_data(), py.typed_data(), p.typed_data(),
                  boundary.typed_data(), lo.typed_data(), static_cast<int>(K),
                  ans_grad.typed_data(), S, B, Tn, modified,
                  px_grad->typed_data(), py_grad->typed_data());
  return finish();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(FrtMiForward, MiForwardImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<F32>()                    // px
                                  .Arg<F32>()                    // py
                                  .Arg<ffi::Buffer<ffi::S32>>()  // boundary
                                  .Arg<ffi::Buffer<ffi::S32>>()  // lo
                                  .Attr<int64_t>("K")
                                  .Ret<F32>()  // p
                                  .Ret<F32>()  // scores
);

XLA_FFI_DEFINE_HANDLER_SYMBOL(FrtMiBackward, MiBackwardImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<F32>()                    // px
                                  .Arg<F32>()                    // py
                                  .Arg<F32>()                    // p
                                  .Arg<ffi::Buffer<ffi::S32>>()  // boundary
                                  .Arg<ffi::Buffer<ffi::S32>>()  // lo
                                  .Arg<F32>()                    // ans_grad
                                  .Attr<int64_t>("K")
                                  .Ret<F32>()  // px_grad
                                  .Ret<F32>()  // py_grad
);
