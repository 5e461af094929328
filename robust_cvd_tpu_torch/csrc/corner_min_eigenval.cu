// Corner response for constraint sampling, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel robust_cvd_tpu/ops/pallas_kernels.py
// ::corner_min_eigenval_fused (body _corner_kernel). For each frame of an
// (N, H, W) f32 gray stack it computes Sobel-3 dx and dy with reflect-101
// borders, 3x3 box sums of dx*dx, dx*dy and dy*dy (the products are
// reflect-101 padded too), and the smaller eigenvalue
// 0.5 * ((A + C) - sqrt((A - C)^2 + 4 B^2)) of [[A, B], [B, C]]: OpenCV's
// cornerMinEigenVal(blockSize=3, ksize=3) up to scale.
//
// Bound: device-memory bytes. The function reads 4 bytes and writes 4 bytes
// per pixel and does ~60 flops per pixel, far below the card's ratio of
// flops to bytes. The TPU kernel held one whole frame in VMEM; here a block
// owns a TILE_H x TILE_W output tile and stages it with a 2-pixel halo in
// shared memory, so each input pixel is read from device memory about
// (TILE_H + 4)(TILE_W + 4) / (TILE_H TILE_W) = 1.4 times and the
// intermediates (dx, dy, products) never leave the SM.
//
// Border rule: the reference pads the gray image for the derivatives and
// then pads the PRODUCT maps for the box sums. A product one pixel outside
// the image is therefore the product at the mirrored pixel inside it (dy
// changes sign under the mirror, so recomputing the derivative outside the
// image would flip dx*dy). The kernel mirrors the ring position before it
// takes the derivative, which reproduces that rule.
//
// Plain C interface, bound with ctypes; the caller passes PyTorch's current
// stream. Returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int GW = TILE_W + 4;  // gray tile width with a 2-pixel halo
constexpr int GH = TILE_H + 4;
constexpr int PW = TILE_W + 2;  // product tile width with a 1-pixel ring
constexpr int PH = TILE_H + 2;

// Reflect-101 index (numpy "reflect", OpenCV BORDER_REFLECT_101) for
// positions at most n - 1 outside [0, n); clamped beyond that, where the
// value is never used.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(TILE_W * TILE_H)
corner_min_eigenval_kernel(const float* __restrict__ gray,
                           float* __restrict__ out, int h, int w) {
  __shared__ float g[GH][GW];
  __shared__ float pa[PH][PW];
  __shared__ float pb[PH][PW];
  __shared__ float pc[PH][PW];

  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* img = gray + blockIdx.z * plane;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  constexpr int NT = TILE_W * TILE_H;

  // 1. Gray tile plus a 2-pixel halo, borders mirrored.
  for (int i = tid; i < GH * GW; i += NT) {
    const int ly = i / GW, lx = i % GW;
    const int gy = reflect101(y0 - 2 + ly, h);
    const int gx = reflect101(x0 - 2 + lx, w);
    g[ly][lx] = img[static_cast<size_t>(gy) * w + gx];
  }
  __syncthreads();

  // 2. Structure-tensor products on the tile plus a 1-pixel ring. A ring
  // position outside the image takes the product of its mirror image.
  for (int i = tid; i < PH * PW; i += NT) {
    const int ly = i / PW, lx = i % PW;
    const int py = y0 - 1 + ly, px = x0 - 1 + lx;
    float a = 0.f, b = 0.f, c = 0.f;
    if (py <= h && px <= w) {
      // gray tile index of the (mirrored) centre pixel
      const int cy = reflect101(py, h) - (y0 - 2);
      const int cx = reflect101(px, w) - (x0 - 2);
      const float ul = g[cy - 1][cx - 1], up = g[cy - 1][cx], ur = g[cy - 1][cx + 1];
      const float le = g[cy][cx - 1], ri = g[cy][cx + 1];
      const float dl = g[cy + 1][cx - 1], dn = g[cy + 1][cx], dr = g[cy + 1][cx + 1];
      const float dx = -ul + ur - 2.f * le + 2.f * ri - dl + dr;
      const float dy = -ul - 2.f * up - ur + dl + 2.f * dn + dr;
      a = dx * dx;
      b = dx * dy;
      c = dy * dy;
    }
    pa[ly][lx] = a;
    pb[ly][lx] = b;
    pc[ly][lx] = c;
  }
  __syncthreads();

  // 3. 3x3 box sums and the smaller eigenvalue, one pixel per thread.
  const int ox = x0 + threadIdx.x, oy = y0 + threadIdx.y;
  if (ox >= w || oy >= h) return;
  float A = 0.f, B = 0.f, C = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      A += pa[threadIdx.y + dy][threadIdx.x + dx];
      B += pb[threadIdx.y + dy][threadIdx.x + dx];
      C += pc[threadIdx.y + dy][threadIdx.x + dx];
    }
  }
  const float d = A - C;
  out[blockIdx.z * plane + static_cast<size_t>(oy) * w + ox] =
      0.5f * ((A + C) - sqrtf(d * d + 4.f * B * B));
}

}  // namespace

extern "C" int corner_min_eigenval_launch(const float* gray, float* out,
                                          int n, int h, int w,
                                          cudaStream_t stream) {
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, n);
  corner_min_eigenval_kernel<<<grid, block, 0, stream>>>(gray, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
