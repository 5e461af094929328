// Fused Adam update over one flat f32 parameter vector, written for Hopper
// (sm_90a), in four modes.
//
// Replaces the Pallas TPU kernel tools/probe_adam_bw.py::adam_pl (body
// adam_kernel), the same update over the same flat MiDaS parameter vector:
//   mode 0 (adam_pl): mu' = b1 mu + (1 - b1) g;  nu' = b2 nu + (1 - b2) g^2;
//                     p' = p - lr mu' / (sqrt(nu') + eps)
// and the optax updates the JAX package's fine-tune path makes with it
// (robust_cvd_tpu/training/fine_tune.py:486-494), in optax's order, with
// t = count + 1 (optax's safe increment), b^t as the f32 rounding of the
// power (bc = 1 - b^t in f32), mu_hat = mu' / bc1, nu_hat = nu' / bc2 and
// p' = p + (-lr) u:
//   mode 1, optax.adam:   u = mu_hat / (sqrt(nu_hat) + eps);
//   mode 2, optax.radam (scale_by_radam, threshold 5, eps_root 0):
//     ro_inf = 2 / (1 - b2) - 1, ro = ro_inf - 2 t b2^t / (1 - b2^t) and
//     r = sqrt((ro - 4)(ro - 2) ro_inf / ((ro_inf - 4)(ro_inf - 2) ro)), all
//     in f32 (at small t, 1 - b2^t cancels, and a double ro would move the
//     steps at which the branch turns); u = r mu_hat / (sqrt(nu_hat) + eps)
//     where ro >= 5, else u = mu_hat;
//   mode 3, optax.adam(mu_dtype=bfloat16): mu is a bf16 buffer. It is
//     widened to f32, mu' = (1 - b1) g + b1' mu with b1' = bf16(b1) (JAX's
//     weakly typed b1 takes mu's type), the update is mode 1's from the
//     unrounded mu', and mu' is stored rounded to nearest even, as optax
//     casts mu after the update.
// Modes 2 and 3 round every operation on its own (no fused multiply-add),
// in optax's order, as the plain version's separate PyTorch ops do: the
// kernel then agrees with it bit for bit, where a contracted update would
// move p' by an ulp of p (at RAdam's early steps the update is small
// beside p), and a bf16 mu by an ulp where m' lands near a rounding
// boundary.
//
// p, mu and nu are updated in place: the same function over the same
// streams as adam_pl's three outputs. The step is guarded by a device flag
// (the fine-tune step's non-finite guard): every thread reads it first and,
// when it is 0, writes nothing. The kernel reads the step count but never
// writes it, because other blocks may still be reading it; the caller adds
// the flag to the count after the launch.
//
// Bound: device-memory bytes. Per element modes 0-2 read 16 bytes and
// write 12 (28 B), mode 3 reads 14 and writes 10 (24 B), for ~12-16 flops,
// far below the card's ratio of flops to bytes, with no reuse, so there is
// nothing to stage in shared memory and no use for tensor cores: a
// grid-stride loop of 16-byte (float4) loads and stores over the aligned
// buffers (8-byte loads of four bf16 for mode 3's mu), plus a scalar tail
// for n % 4.
//
// Plain C interface, bound with ctypes; the caller passes PyTorch's current
// stream. Returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

enum Mode : int { kAdamPl = 0, kAdam = 1, kRAdam = 2, kAdamMuBf16 = 3 };

struct Consts {
  float b1, c1;  // b1 and (1 - b1), each rounded once from the caller's double
  float b2, c2;
  float eps;
  float lr;      // adam_pl: p - lr * u
  float neg_lr;  // optax: p + (-lr) * u
  float b1_mu;   // mode 3: b1 in mu's type (bf16), held exactly in f32
  float ro_inf;  // mode 2: 2 / (1 - b2) - 1
  float ro_den;  // mode 2: (ro_inf - 4)(ro_inf - 2), formed in double as
                 // optax's Python floats are
};

struct Step {
  float bc1, bc2;  // 1 - b^t
  float r;         // mode 2: the rectification factor
  bool rect;       // mode 2: ro >= 5
};

// Bias corrections (and RAdam's rectification) for the step about to be
// taken; the same for every element.
__device__ __forceinline__ Step step_consts(const Consts& k, int count, int mode) {
  Step s{1.f, 1.f, 1.f, false};
  if (mode == kAdamPl) return s;
  const int t = count < INT32_MAX ? count + 1 : count;  // optax safe_increment
  const float b1t = static_cast<float>(pow(static_cast<double>(k.b1), static_cast<double>(t)));
  const float b2t = static_cast<float>(pow(static_cast<double>(k.b2), static_cast<double>(t)));
  s.bc1 = 1.f - b1t;
  s.bc2 = 1.f - b2t;
  if (mode == kRAdam) {
    // optax: ro = ro_inf - 2 * t * b2t / (1 - b2t), left to right in f32
    const float ro = __fsub_rn(k.ro_inf,
                               __fdiv_rn(__fmul_rn(static_cast<float>(2 * t), b2t), s.bc2));
    const float num = __fmul_rn(__fmul_rn(__fsub_rn(ro, 4.f), __fsub_rn(ro, 2.f)), k.ro_inf);
    s.r = __fsqrt_rn(__fdiv_rn(num, __fmul_rn(k.ro_den, ro)));
    s.rect = ro >= 5.f;
  }
  return s;
}

template <int MODE>
__device__ __forceinline__ void update(const Consts& k, const Step& s, float& p, float g,
                                       float& m, float& v) {
  if (MODE == kAdamPl) {
    m = k.b1 * m + k.c1 * g;
    v = k.b2 * v + k.c2 * g * g;
    p = p - k.lr * (m / (sqrtf(v) + k.eps));
    return;
  }
  if (MODE == kAdam) {
    m = k.c1 * g + k.b1 * m;
    v = k.c2 * (g * g) + k.b2 * v;
    const float u = (m / s.bc1) / (sqrtf(v / s.bc2) + k.eps);
    p = p + k.neg_lr * u;
    return;
  }
  // modes 2 and 3: every product, sum, quotient and root rounded on its
  // own, in optax's order (no fused multiply-add)
  m = __fadd_rn(__fmul_rn(k.c1, g), __fmul_rn(MODE == kAdamMuBf16 ? k.b1_mu : k.b1, m));
  v = __fadd_rn(__fmul_rn(k.c2, __fmul_rn(g, g)), __fmul_rn(k.b2, v));
  const float mu_hat = __fdiv_rn(m, s.bc1);
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), k.eps);
  float u;
  if (MODE == kRAdam) {
    u = s.rect ? __fdiv_rn(__fmul_rn(s.r, mu_hat), denom) : mu_hat;
  } else {
    u = __fdiv_rn(mu_hat, denom);
  }
  p = __fadd_rn(p, __fmul_rn(k.neg_lr, u));
}

// Loads and stores of the first moment: four at a time, and one.
template <int MODE>
struct MuAccess {
  using T = float;
  static __device__ __forceinline__ float4 load4(const T* mu, int64_t i) {
    return reinterpret_cast<const float4*>(mu)[i];
  }
  static __device__ __forceinline__ void store4(T* mu, int64_t i, float4 m) {
    reinterpret_cast<float4*>(mu)[i] = m;
  }
  static __device__ __forceinline__ float load(const T* mu, int64_t i) { return mu[i]; }
  static __device__ __forceinline__ void store(T* mu, int64_t i, float m) { mu[i] = m; }
};

template <>
struct MuAccess<kAdamMuBf16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float4 load4(const T* mu, int64_t i) {
    const uint2 raw = reinterpret_cast<const uint2*>(mu)[i];
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &raw.x, 4);
    memcpy(&hi, &raw.y, 4);
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store4(T* mu, int64_t i, float4 m) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(m.x, m.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(m.z, m.w);
    uint2 raw;
    memcpy(&raw.x, &lo, 4);
    memcpy(&raw.y, &hi, 4);
    reinterpret_cast<uint2*>(mu)[i] = raw;
  }
  static __device__ __forceinline__ float load(const T* mu, int64_t i) {
    return __bfloat162float(mu[i]);
  }
  static __device__ __forceinline__ void store(T* mu, int64_t i, float m) {
    mu[i] = __float2bfloat16_rn(m);
  }
};

template <int MODE>
__global__ void __launch_bounds__(256)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
            typename MuAccess<MODE>::T* __restrict__ mu, float* __restrict__ nu,
            int64_t n, Consts k, const int* __restrict__ count,
            const bool* __restrict__ ok) {
  using Mu = MuAccess<MODE>;
  if (!*ok) return;
  const Step s = step_consts(k, *count, MODE);

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n4 = n / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* v4 = reinterpret_cast<float4*>(nu);
  for (int64_t i = tid; i < n4; i += stride) {
    float4 pv = p4[i], vv = v4[i];
    float4 mv = Mu::load4(mu, i);
    const float4 gv = g4[i];
    update<MODE>(k, s, pv.x, gv.x, mv.x, vv.x);
    update<MODE>(k, s, pv.y, gv.y, mv.y, vv.y);
    update<MODE>(k, s, pv.z, gv.z, mv.z, vv.z);
    update<MODE>(k, s, pv.w, gv.w, mv.w, vv.w);
    p4[i] = pv;
    Mu::store4(mu, i, mv);
    v4[i] = vv;
  }
  for (int64_t i = 4 * n4 + tid; i < n; i += stride) {
    float pv = p[i], mv = Mu::load(mu, i), vv = nu[i];
    update<MODE>(k, s, pv, g[i], mv, vv);
    p[i] = pv;
    Mu::store(mu, i, mv);
    nu[i] = vv;
  }
}

// f32 -> bf16 -> f32 with round to nearest even (finite inputs).
float bf16_round(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  u &= 0xFFFF0000u;
  std::memcpy(&x, &u, 4);
  return x;
}

}  // namespace

// mode: 0 adam_pl (no bias correction), 1 optax.adam, 2 optax.radam, 3
// optax.adam with a bf16 first moment (mu points to n bf16 values; for the
// other modes, n f32 values).
extern "C" int adam_launch(float* p, const float* g, void* mu, float* nu,
                           int64_t n, double lr, double b1, double b2,
                           double eps, int mode, const int* count,
                           const bool* ok, cudaStream_t stream) {
  // Python floats are doubles: (1 - b) is formed in double and rounded
  // once, as JAX does with its weakly typed scalars.
  Consts k;
  k.b1 = static_cast<float>(b1);
  k.c1 = static_cast<float>(1.0 - b1);
  k.b2 = static_cast<float>(b2);
  k.c2 = static_cast<float>(1.0 - b2);
  k.eps = static_cast<float>(eps);
  k.lr = static_cast<float>(lr);
  k.neg_lr = static_cast<float>(-lr);
  k.b1_mu = bf16_round(k.b1);
  const double ro_inf = 2.0 / (1.0 - b2) - 1.0;
  k.ro_inf = static_cast<float>(ro_inf);
  k.ro_den = static_cast<float>((ro_inf - 4.0) * (ro_inf - 2.0));
  constexpr int threads = 256;
  const int64_t want = (n / 4 + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
  switch (mode) {
    case kAdamPl:
      adam_kernel<kAdamPl><<<blocks, threads, 0, stream>>>(
          p, g, static_cast<float*>(mu), nu, n, k, count, ok);
      break;
    case kAdam:
      adam_kernel<kAdam><<<blocks, threads, 0, stream>>>(
          p, g, static_cast<float*>(mu), nu, n, k, count, ok);
      break;
    case kRAdam:
      adam_kernel<kRAdam><<<blocks, threads, 0, stream>>>(
          p, g, static_cast<float*>(mu), nu, n, k, count, ok);
      break;
    case kAdamMuBf16:
      adam_kernel<kAdamMuBf16><<<blocks, threads, 0, stream>>>(
          p, g, static_cast<__nv_bfloat16*>(mu), nu, n, k, count, ok);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
