// Fused Adam update over one flat f32 parameter vector, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tools/probe_adam_bw.py::adam_pl (body
// adam_kernel), the same update over the same flat MiDaS parameter vector:
//   mu' = b1 mu + (1 - b1) g;  nu' = b2 nu + (1 - b2) g^2;
//   p'  = p - lr mu' / (sqrt(nu') + eps)
// With bias_correction = 1 it computes what optax.adam(lr) computes on the
// fine-tune path instead, in optax's order: t = count + 1,
// mu_hat = mu' / (1 - b1^t), nu_hat = nu' / (1 - b2^t) (factors in f32, the
// power correctly rounded as XLA computes it), u = mu_hat / (sqrt(nu_hat) +
// eps), p' = p + (-lr) u.
//
// p, mu and nu are updated in place: the same function over the same seven
// streams as adam_pl's three outputs. The step is guarded by a device flag
// (the fine-tune step's non-finite guard): every thread reads it first and,
// when it is 0, writes nothing. The kernel reads the step count but never
// writes it, because other blocks may still be reading it; the caller adds
// the flag to the count after the launch.
//
// Bound: device-memory bytes. Per element it reads 16 bytes and writes 12
// (7 f32 streams) for ~12 flops, far below the card's ratio of flops to
// bytes, with no reuse, so there is nothing to stage in shared memory and
// no use for tensor cores: a grid-stride loop of 16-byte (float4) loads and
// stores over the aligned buffers, plus a scalar tail for n % 4.
//
// Plain C interface, bound with ctypes; the caller passes PyTorch's current
// stream. Returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Consts {
  float b1, c1;  // b1 and (1 - b1), each rounded once from the caller's double
  float b2, c2;
  float eps;
  float lr;      // adam_pl: p - lr * u
  float neg_lr;  // optax: p + (-lr) * u
  int bias_correction;
};

// Correction factors 1 - b^t for the step about to be taken.
__device__ __forceinline__ void correction(const Consts& k, int count,
                                           float* bc1, float* bc2) {
  const int t = count < INT32_MAX ? count + 1 : count;  // optax safe_increment
  *bc1 = 1.f - static_cast<float>(pow(static_cast<double>(k.b1), static_cast<double>(t)));
  *bc2 = 1.f - static_cast<float>(pow(static_cast<double>(k.b2), static_cast<double>(t)));
}

__device__ __forceinline__ void update(const Consts& k, float bc1, float bc2,
                                       float& p, float g, float& m, float& v) {
  if (k.bias_correction) {
    m = k.c1 * g + k.b1 * m;
    v = k.c2 * (g * g) + k.b2 * v;
    const float u = (m / bc1) / (sqrtf(v / bc2) + k.eps);
    p = p + k.neg_lr * u;
  } else {
    m = k.b1 * m + k.c1 * g;
    v = k.b2 * v + k.c2 * g * g;
    p = p - k.lr * (m / (sqrtf(v) + k.eps));
  }
}

__global__ void __launch_bounds__(256)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ mu, float* __restrict__ nu, int64_t n,
            Consts k, const int* __restrict__ count,
            const bool* __restrict__ ok) {
  if (!*ok) return;
  float bc1 = 1.f, bc2 = 1.f;
  if (k.bias_correction) correction(k, *count, &bc1, &bc2);

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n4 = n / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(mu);
  float4* v4 = reinterpret_cast<float4*>(nu);
  for (int64_t i = tid; i < n4; i += stride) {
    float4 pv = p4[i], mv = m4[i], vv = v4[i];
    const float4 gv = g4[i];
    update(k, bc1, bc2, pv.x, gv.x, mv.x, vv.x);
    update(k, bc1, bc2, pv.y, gv.y, mv.y, vv.y);
    update(k, bc1, bc2, pv.z, gv.z, mv.z, vv.z);
    update(k, bc1, bc2, pv.w, gv.w, mv.w, vv.w);
    p4[i] = pv;
    m4[i] = mv;
    v4[i] = vv;
  }
  for (int64_t i = 4 * n4 + tid; i < n; i += stride) {
    float pv = p[i], mv = mu[i], vv = nu[i];
    update(k, bc1, bc2, pv, g[i], mv, vv);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = vv;
  }
}

}  // namespace

extern "C" int adam_launch(float* p, const float* g, float* mu, float* nu,
                           int64_t n, double lr, double b1, double b2,
                           double eps, int bias_correction, const int* count,
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
  k.bias_correction = bias_correction;
  constexpr int threads = 256;
  const int64_t want = (n / 4 + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
  adam_kernel<<<blocks, threads, 0, stream>>>(p, g, mu, nu, n, k, count, ok);
  return static_cast<int>(cudaGetLastError());
}
