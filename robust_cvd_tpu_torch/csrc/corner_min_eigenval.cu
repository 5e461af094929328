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
// per pixel and does ~50 flops per pixel, far below the card's ratio of
// flops to bytes: 8 B x 8.6 M pixels = 68.8 MB at 3.35 TB/s is 0.0205 ms at
// the path's 100 x 224 x 384. What the design does about it:
//
// - A warp is a walker: it owns a band of BAND = 128 columns (4 per lane)
//   and walks down a strip of STRIP = 32 output rows. Each gray row is read
//   from device memory once per walker, so a pixel is read (STRIP + 4) /
//   STRIP x (BAND + 8) / BAND = 1.2 times (the halo rows and columns).
// - Loads stay in flight while the warp computes: the warp's gray rows go
//   through a ring of RING = 3 rows in shared memory, fed by cp.async
//   (16-byte .cg copies where W % 4 == 0 and both pointers are 16-byte
//   aligned, else 4-byte .ca copies), one commit group per row, RING - 1
//   rows ahead of the one being computed. Walkers are independent (only
//   __syncwarp), so no warp waits for another.
// - Each lane keeps a rolling window in registers: the last three gray rows
//   (its 4 columns plus 2 on each side) and the last three rows of
//   horizontally summed products; each loaded row is used for every output
//   row that needs it. A lane writes 4 outputs a row (one float4 store on
//   the aligned path).
// - Borders only where there are borders: rows are mirrored only in strips
//   and columns only in bands whose gray halo leaves the image (the first
//   and last of a frame); interior walkers run no mirror code.
// - Frames are folded into the walker index (blockIdx.x), not gridDim.z.
//
// What bounds it now is issue as much as bandwidth: about 170 instructions
// a lane per step for 4 outputs. RING, WARPS and STRIP were chosen by
// tools/sweep_corner_cuda.py on an H100: a deeper ring was slower, not
// faster (6 rows: +7%), and at the path's shape 2,100 walkers fill the
// card's 132 SMs in one wave of 16 warps an SM (STRIP 28 takes two: +31%).
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a): 106 registers on the float4 path,
// 117 on the scalar path, 13,056 bytes of shared memory a block, no spills.
//
// Plain C interface, bound with ctypes; the caller passes PyTorch's current
// stream. Returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int BAND = 128;       // columns a walker owns, 4 per lane
constexpr int STRIP = 32;       // output rows a walker walks
constexpr int WARPS = 8;        // walkers per block
constexpr int RING = 3;         // gray rows in the ring; RING - 1 in flight
constexpr int ROW = BAND + 8;   // ring row: columns x0 - 4 .. x0 + BAND + 3

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One MUFU instruction instead of the IEEE square root's sequence, which
// costs the walk measurable issue time; its error is a few units in the
// last place, far inside the kernel's tolerance against the plain version.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One walker: band x0 .. x0 + BAND - 1, output rows y0 .. y1 - 1 of one frame.
struct Walker {
  const float* img;
  float* dst;
  float (*ring)[ROW];
  int h, w, x0, lane, c;
  int qs;         // first product row computed (qs - 1 is the first gray row)
  int nrows;      // gray rows walked
  bool top, bottom;  // the strip holds row 0, row h - 1
  bool mirror;       // the walk's gray rows reach row -1 or h
  bool left, right;  // the band's gray halo reaches column -1, w
};

// Queue gray row `i` of the walk (logical row qs - 1 + i, mirrored at -1
// and h) into ring slot i % RING; always commits a group, so the count of
// groups is the same in every lane and every step.
template <bool VEC>
__device__ __forceinline__ void issue(const Walker& k, int i) {
  if (i < k.nrows) {
    int t = k.qs - 1 + i;
    if (k.mirror) t = t < 0 ? -t : (t >= k.h ? 2 * k.h - 2 - t : t);
    const float* src = k.img + static_cast<size_t>(t) * k.w;
    float* row = k.ring[i % RING];
    if constexpr (VEC) {  // 16-byte chunks, each wholly inside or outside the row
      for (int j = k.lane; j < ROW / 4; j += 32) {
        const int col = k.x0 - 4 + 4 * j;
        if (col >= 0 && col < k.w) cp_async16(row + 4 * j, src + col);
      }
    } else {
      for (int j = k.lane; j < ROW; j += 32) {
        const int col = k.x0 - 4 + j;
        if (col >= 0 && col < k.w) cp_async4(row + j, src + col);
      }
    }
  }
  cp_async_commit();
}

// Smaller eigenvalue of the box sums pa + pb + pc (each a row of 4 columns
// of A, B and C) stored at output row o.
template <bool VEC>
__device__ __forceinline__ void emit(const Walker& k, int o, const float (&pa)[12],
                                     const float (&pb)[12], const float (&pc)[12]) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float A = pa[j] + pb[j] + pc[j];
    const float B = pa[4 + j] + pb[4 + j] + pc[4 + j];
    const float C = pa[8 + j] + pb[8 + j] + pc[8 + j];
    const float d = A - C;
    v[j] = 0.5f * ((A + C) - sqrt_approx(d * d + 4.f * B * B));
  }
  float* dst = k.dst + static_cast<size_t>(o) * k.w + k.c;
  if constexpr (VEC) {
    if (k.c < k.w) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k.c + j < k.w) dst[j] = v[j];
  }
}

// Sums of 3 neighbours at the 4 output columns from the products at the 6
// columns around them, the two middle pairs shared.
__device__ __forceinline__ void hsum3(const float (&x)[6], float* out) {
  const float t = x[1] + x[2], u = x[3] + x[4];
  out[0] = x[0] + t;
  out[1] = t + x[3];
  out[2] = x[2] + u;
  out[3] = u + x[5];
}

// Step i of the walk: gray row i lands in gp (gm, g0 hold rows i - 2 and
// i - 1); from i = 2 on, product row q = qs + i - 2 lands in pc (pa, pb
// hold q - 2 and q - 1) and output row q - 1 is written. The caller
// rotates the roles of the register arrays instead of copying them.
template <bool VEC>
__device__ __forceinline__ void step(const Walker& k, int i, const float (&gm)[8],
                                     const float (&g0)[8], float (&gp)[8],
                                     const float (&pa)[12], const float (&pb)[12],
                                     float (&pc)[12]) {
  __syncwarp();  // every lane has read slot (i - 1) % RING, refilled next
  issue<VEC>(k, i + RING - 1);
  cp_async_wait<RING - 1>();  // row i has landed
  __syncwarp();
  float* row = k.ring[i % RING];
  if (k.left || k.right) {  // gray halo from the mirror: column -1 <- 1, w <- w - 2
    if (k.left && k.lane == 0) row[3] = row[5];
    if (k.right && k.lane == 1) row[k.w - k.x0 + 4] = row[k.w - k.x0 + 2];
    __syncwarp();
  }
  // columns c - 2 .. c + 5 are ring positions 4 lane + 2 .. 4 lane + 9
  const float* src = row + 4 * k.lane + 2;
  const float2 l = *reinterpret_cast<const float2*>(src);
  const float4 m = *reinterpret_cast<const float4*>(src + 2);
  const float2 r = *reinterpret_cast<const float2*>(src + 6);
  gp[0] = l.x, gp[1] = l.y, gp[2] = m.x, gp[3] = m.y;
  gp[4] = m.z, gp[5] = m.w, gp[6] = r.x, gp[7] = r.y;
  if (i < 2) return;

  // Sobel, separably: s = [1 2 1] and d = [-1 0 1] down the columns, then
  // dx = s(x + 1) - s(x - 1), dy = d(x - 1) + 2 d(x) + d(x + 1), at the six
  // columns c - 1 .. c + 4 (product index j is column c - 1 + j).
  float s[8], d[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = gm[j] + 2.f * g0[j] + gp[j];
    d[j] = gp[j] - gm[j];
  }
  float a[6], b[6], cc[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float dx = s[j + 2] - s[j];
    const float dy = d[j] + 2.f * d[j + 1] + d[j + 2];
    a[j] = dx * dx;
    b[j] = dx * dy;
    cc[j] = dy * dy;
  }
  if (k.left || k.right) {  // products outside the image take their mirror's
    if (k.left && k.lane == 0) a[0] = a[2], b[0] = b[2], cc[0] = cc[2];
    if (k.right) {
#pragma unroll
      for (int j = 2; j < 6; ++j)
        if (k.c - 1 + j == k.w) a[j] = a[j - 2], b[j] = b[j - 2], cc[j] = cc[j - 2];
    }
  }
  hsum3(a, pc);
  hsum3(b, pc + 4);
  hsum3(cc, pc + 8);

  const int q = k.qs + i - 2;
  if (i >= 4) {
    emit<VEC>(k, q - 1, pa, pb, pc);
  } else if (k.top && q == 1) {  // product row -1 is row 1
    emit<VEC>(k, 0, pc, pb, pc);
  }
  if (k.bottom && q == k.h - 1) emit<VEC>(k, q, pb, pc, pb);  // row h is row h - 2
}

template <bool VEC>
__global__ void __launch_bounds__(32 * WARPS)
corner_min_eigenval_kernel(const float* __restrict__ gray, float* __restrict__ out,
                           int h, int w, int bands, int strips, long long walkers) {
  __shared__ __align__(16) float ring[WARPS][RING][ROW];
  const int warp = threadIdx.x / 32;
  const long long id = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (id >= walkers) return;  // the whole warp
  const int band = static_cast<int>(id % bands);
  const long long fs = id / bands;
  const int strip = static_cast<int>(fs % strips);
  const size_t frame = static_cast<size_t>(fs / strips);

  Walker k;
  k.img = gray + frame * h * w;
  k.dst = out + frame * h * w;
  k.ring = ring[warp];
  k.h = h;
  k.w = w;
  k.lane = threadIdx.x % 32;
  k.x0 = band * BAND;
  k.c = k.x0 + 4 * k.lane;
  const int y0 = strip * STRIP, y1 = min(y0 + STRIP, h);
  k.top = y0 == 0;
  k.bottom = y1 == h;
  k.left = k.x0 == 0;
  k.right = k.x0 + BAND + 2 > w;  // the gray halo reaches column w
  // product rows qs .. qe: the strip's rows and one on each side, except
  // outside the image (rows -1 and h are mirrored when written)
  k.qs = k.top ? 0 : y0 - 1;
  const int qe = k.bottom ? h - 1 : y1;
  k.nrows = qe - k.qs + 3;
  k.mirror = k.top || qe + 1 >= h;

  for (int i = 0; i < RING - 1; ++i) issue<VEC>(k, i);
  float g[3][8], p[3][12];
  for (int i = 0; i < k.nrows; i += 3) {
    step<VEC>(k, i, g[1], g[2], g[0], p[1], p[2], p[0]);
    if (i + 1 >= k.nrows) break;
    step<VEC>(k, i + 1, g[2], g[0], g[1], p[2], p[0], p[1]);
    if (i + 2 >= k.nrows) break;
    step<VEC>(k, i + 2, g[0], g[1], g[2], p[0], p[1], p[2]);
  }
}

}  // namespace

extern "C" int corner_min_eigenval_launch(const float* gray, float* out,
                                          int n, int h, int w,
                                          cudaStream_t stream) {
  const int bands = (w + BAND - 1) / BAND;
  const int strips = (h + STRIP - 1) / STRIP;
  const long long walkers = static_cast<long long>(n) * strips * bands;
  const long long blocks = (walkers + WARPS - 1) / WARPS;
  if (n < 0 || h < 2 || w < 2 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(gray) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    corner_min_eigenval_kernel<true><<<static_cast<unsigned>(blocks), 32 * WARPS, 0, stream>>>(
        gray, out, h, w, bands, strips, walkers);
  } else {
    corner_min_eigenval_kernel<false><<<static_cast<unsigned>(blocks), 32 * WARPS, 0, stream>>>(
        gray, out, h, w, bands, strips, walkers);
  }
  return static_cast<int>(cudaGetLastError());
}
