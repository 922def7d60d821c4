// CPU reference implementation of the mutual-information lattice recursion.
//
// Native-oracle counterpart of the reference's CUDA kernels
// (tf_fast_rnnt/csrc/mutual_information_cuda.cu:174-422 forward,
// :490-760 backward), written as straightforward O(B*S*T) loops: the
// accelerator paths are the XLA core and the GPU kernels (ops/), and the
// native layer's job is host-side verification.
// Exposed through ctypes (csrc/__init__.py); see also tests/test_csrc.py
// which closes the JAX / numpy / C++ oracle triangle.
//
// Semantics (identical to the JAX core, ops/recursion.py):
//   p[b, s_begin, t_begin] = 0
//   regular  (T1 == T+1): p[s,t] = logadd(p[s-1,t]   + px[s-1,t],
//                                         p[s,t-1]   + py[s,t-1])
//   modified (T1 == T):   p[s,t] = logadd(p[s-1,t-1] + px[s-1,t-1],
//                                         p[s,t-1]   + py[s,t-1])
//   scores[b] = p[b, s_end, t_end]
// Backward emits occupancy probabilities px_grad/py_grad seeded with
// ans_grad at (s_end, t_end).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kNegInf = -std::numeric_limits<float>::infinity();

// -inf/NaN-safe log(exp(a) + exp(b)): returns the max when the difference
// is NaN (mirrors LogAdd, reference mutual_information.h:54-83).
inline float LogAdd(float a, float b) {
  float mx = a > b ? a : b;
  if (!(mx > kNegInf)) return mx;  // both -inf (or NaN): return max
  float d = a > b ? b - a : a - b;
  return mx + std::log1p(std::exp(d));
}

// exp() with inf/NaN mapped to 0 (reference mutual_information_cuda.cu:430).
inline float SafeExp(float x) {
  if (std::isnan(x) || x > 80.0f) return 0.0f;
  return std::exp(x);
}

}  // namespace

extern "C" {

// px: [B, S, T1]; py: [B, S+1, T]; boundary: [B, 4]; outputs:
// p: [B, S+1, T+1] (callers may pass garbage-initialized memory),
// scores: [B].  T1 must be T (modified) or T+1 (regular).
void frt_mi_forward(const float* px, const float* py, const int32_t* boundary,
                    float* p, float* scores, int32_t B, int32_t S, int32_t T1,
                    int32_t T) {
  const bool modified = (T1 == T);
  const int64_t p_row = T + 1, p_mat = (int64_t)(S + 1) * (T + 1);
  const int64_t px_mat = (int64_t)S * T1, py_mat = (int64_t)(S + 1) * T;
  for (int32_t b = 0; b < B; ++b) {
    const int32_t sb = boundary[4 * b], tb = boundary[4 * b + 1];
    const int32_t se = boundary[4 * b + 2], te = boundary[4 * b + 3];
    float* pb = p + b * p_mat;
    const float* pxb = px + b * px_mat;
    const float* pyb = py + b * py_mat;
    for (int64_t i = 0; i < p_mat; ++i) pb[i] = kNegInf;
    pb[sb * p_row + tb] = 0.0f;
    for (int32_t s = sb; s <= se; ++s) {
      for (int32_t t = tb; t <= te; ++t) {
        if (s == sb && t == tb) continue;
        float term_x = kNegInf, term_y = kNegInf;
        if (modified) {
          if (s > sb && t > tb)
            term_x = pb[(s - 1) * p_row + (t - 1)] + pxb[(s - 1) * T1 + (t - 1)];
        } else {
          if (s > sb) term_x = pb[(s - 1) * p_row + t] + pxb[(s - 1) * T1 + t];
        }
        if (t > tb) term_y = pb[s * p_row + (t - 1)] + pyb[s * T + (t - 1)];
        pb[s * p_row + t] = LogAdd(term_x, term_y);
      }
    }
    scores[b] = pb[se * p_row + te];
  }
}

// Occupancy backward; px_grad/py_grad must be zero-initialized by the
// caller or are fully overwritten here (we memset them).
void frt_mi_backward(const float* px, const float* py, const float* p,
                     const int32_t* boundary, const float* ans_grad,
                     float* px_grad, float* py_grad, int32_t B, int32_t S,
                     int32_t T1, int32_t T) {
  const bool modified = (T1 == T);
  const int64_t p_row = T + 1, p_mat = (int64_t)(S + 1) * (T + 1);
  const int64_t px_mat = (int64_t)S * T1, py_mat = (int64_t)(S + 1) * T;
  std::memset(px_grad, 0, sizeof(float) * (size_t)B * px_mat);
  std::memset(py_grad, 0, sizeof(float) * (size_t)B * py_mat);
  std::vector<float> g((size_t)(S + 1) * (T + 1));
  for (int32_t b = 0; b < B; ++b) {
    const int32_t sb = boundary[4 * b], tb = boundary[4 * b + 1];
    const int32_t se = boundary[4 * b + 2], te = boundary[4 * b + 3];
    const float* pb = p + b * p_mat;
    const float* pxb = px + b * px_mat;
    const float* pyb = py + b * py_mat;
    float* pxg = px_grad + b * px_mat;
    float* pyg = py_grad + b * py_mat;
    std::fill(g.begin(), g.end(), 0.0f);
    g[se * p_row + te] = ans_grad[b];
    for (int32_t s = se; s >= sb; --s) {
      for (int32_t t = te; t >= tb; --t) {
        const float here = pb[s * p_row + t];
        if (!(here > kNegInf)) continue;
        if (s < se) {
          if (modified) {
            if (t < te) {
              const float w =
                  SafeExp(here + pxb[s * T1 + t] - pb[(s + 1) * p_row + t + 1]);
              const float v = w * g[(s + 1) * p_row + t + 1];
              pxg[s * T1 + t] = v;
              g[s * p_row + t] += v;
            }
          } else {
            const float w =
                SafeExp(here + pxb[s * T1 + t] - pb[(s + 1) * p_row + t]);
            const float v = w * g[(s + 1) * p_row + t];
            pxg[s * T1 + t] = v;
            g[s * p_row + t] += v;
          }
        }
        if (t < te) {
          const float w = SafeExp(here + pyb[s * T + t] - pb[s * p_row + t + 1]);
          const float v = w * g[s * p_row + t + 1];
          pyg[s * T + t] = v;
          g[s * p_row + t] += v;
        }
      }
    }
  }
}

// Inclusive running minimum along the last dim of an int32 [B, T] array
// (counterpart of the reference Cummin op, tf_fast_rnnt_op.cc:135-165).
void frt_cummin(const int32_t* x, int32_t* out, int32_t B, int32_t T) {
  for (int32_t b = 0; b < B; ++b) {
    int32_t m = INT32_MAX;  // re-minned at t = 0; also avoids an OOB read when T == 0
    for (int32_t t = 0; t < T; ++t) {
      const int32_t v = x[(int64_t)b * T + t];
      m = v < m ? v : m;
      out[(int64_t)b * T + t] = m;
    }
  }
}

}  // extern "C"
