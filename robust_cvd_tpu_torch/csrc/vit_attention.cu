// Flash attention of the ViT encoder (models/dpt.py::Attention), written for
// Hopper (sm_90a): softmax(q k^T / 8) v over heads of width 64, forward and
// backward, in float32 with 3xTF32 products.
//
// Replaces no TPU kernel: the JAX package has no DPT and no attention
// kernel. It replaces a library call, F.scaled_dot_product_attention on
// float32, whose CUTLASS sm80 kernels (mma.sync, three TF32 products a
// float32 one) took 43.5 ms of the 116.5-ms DPT-Large train step.
//
// Contract. qkv is the projection's output as it lies, (B, N, 3, H, 64)
// float32, contiguous; out is (B, N, H, 64), so the output projection reads
// a view. N is any length >= 1. No mask, no dropout. The forward also
// writes each row's log-sum-exp, in base 2 and in units of the scaled
// scores (lse2 = log2 sum_j 2^(s_j log2(e) / 8)), for the backward. The
// backward writes dq, dk and dv into one (B, N, 3, H, 64) gradient of qkv.
//
// Arithmetic. Every product a.b is a_hi b_hi + a_hi b_lo + a_lo b_hi on the
// tensor cores (TF32 wgmma, float32 sums), with hi = tf32_rna(x) and
// lo = tf32_rna(x - hi): float32 accuracy, as CUTLASS's OpMultiplyAddFastF32
// gives SDPA. The softmax, its running max and sum, D = rowsum(dO o O) and
// every elementwise step are float32. exp is exp2 of log2(e)-scaled scores.
//
// Bound. At DPT-Large's cell shape (B 4, N 1,009, H 16) a forward call is
// 16.68 GFLOP of products (4 N^2 64 a frame and head), 33.7 us at the
// card's 495 TFLOP/s TF32 and 101 us at three TF32 products each; the
// backward twice that (33.36 GFLOP, 67.4 / 202 us). The tensor cores bound
// it: the bytes (qkv, out, the gradients: ~66 MB a call) take ~20 us.
//
// Design.
// - wgmma.mma_async m64nNk8 tf32 with A from registers and B from shared
//   memory. TF32 wgmma reads shared-memory operands K-major only (no
//   transpose bit), so each B operand lies in shared memory with its
//   contraction axis contiguous, in 128-byte swizzled atoms (8 rows of
//   128 B, 16-byte chunk c of row r at c ^ r). The A operands of the
//   second products (P, dS) are the first products' accumulators, kept in
//   registers: the accumulator gives a thread columns (2t, 2t + 1) of each
//   group of 8 where the A fragment wants (t, t + 4), so the contraction
//   axis is permuted within each group of 8 (logical l <- physical 2l for
//   l < 4, 2(l - 4) + 1 else) and the matching B operands (V^T, K^T, Q^T,
//   dO^T) are laid out in that order. No shuffle, no shared-memory trip.
// - Pre-passes (flash_attention_*_prep) split K, V, Q and dO into hi and
//   lo, transpose where the operand needs it, and write each tile as the
//   exact image of its shared-memory stage; one thread of the main kernels'
//   producer warpgroup then moves a stage with bulk copies on the TMA engine
//   (cp.async.bulk, completion on an mbarrier) into a ring, while two
//   consumer warpgroups of 64 rows each compute (setmaxnreg moves the
//   producer warpgroup's registers to them). The pre-passes move
//   bytes at the memory's rate (~15% of a call's time).
// - Forward: a CTA holds 128 query rows (Q hi/lo in registers) and walks
//   the keys in tiles of 64 (3-stage ring: K and V^T, hi and lo, 64 KiB),
//   online softmax in float32, the ragged last tile masked to -inf.
// - Backward, FlashAttention-2's: D = rowsum(dO o O) in the pre-pass; then
//   dk/dv and dq in two kernels, each recomputing S and P from q, k and the
//   saved log-sum-exp. flash_attention_bwd_dkdv holds 128 key rows a CTA
//   (raw K, V in shared memory, dK and dV in registers) and walks the
//   queries in tiles of 32; flash_attention_bwd_dq holds 128 query rows
//   and walks the keys in tiles of 32. dq is a separate pass, not float32
//   atomics: it recomputes q k^T and dO v^T (7 products of a tile where
//   atomics need 5), and it is bitwise deterministic.
//
// No kernel allocates or synchronises: the wrapper (ops/attention.py)
// passes outputs and scratch (torch.empty) and PyTorch's current stream,
// so a CUDA graph captures the calls unchanged. Plain C interface, bound
// with ctypes; each launcher returns the first launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 64;  // head width
constexpr float kScale = 0.18033688011112042f;  // log2(e) / sqrt(64)
constexpr int kConsumers = 2;  // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup
// Registers a thread after setmaxnreg: the producer gives its share to the
// consumers (2 x 128 x 232 + 128 x 40 <= 65,536).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kRowsPerCta = 64 * kConsumers;
constexpr int kPrepThreads = 256;

// Images: a tile of `rows` rows (the product's N) by 32 or 64 values along
// the contraction (K), hi then lo.
constexpr int kImage64 = 64 * kD * 4;  // 64 x 64 floats, 16 KiB
constexpr int kImage32 = 32 * kD * 4;  // 32 x 64 or 64 x 32 floats, 8 KiB
// forward: key tiles of 64: K (64 x 64) and V^T (64 x 64 keys), hi and lo
constexpr int kFwdTile = 64;
constexpr int kFwdStageBytes = 4 * kImage64;  // 64 KiB
constexpr int kFwdStages = 3;
// backward: tiles of 32 rows
constexpr int kBwdTile = 32;
// dq pass, key tiles: K (32 x 64), V (32 x 64), K^T (64 x 32 keys)
constexpr int kDqStageBytes = 6 * kImage32;  // 48 KiB
constexpr int kDqStages = 4;
// dk/dv pass, query tiles: Q, dO (32 x 64), Q^T, dO^T (64 x 32 queries),
// then the tile's lse2 and D (32 floats each)
constexpr int kDkvImageBytes = 8 * kImage32;  // 64 KiB
constexpr int kDkvTileBytes = kDkvImageBytes + 2 * kBwdTile * 4;  // in device memory
constexpr int kDkvStageBytes = kDkvImageBytes + 1024;  // in shared memory, 1 KiB aligned
constexpr int kDkvStages = 2;
constexpr int kRawPitch = kD + 4;  // raw K and V rows in shared memory (conflict-free fragments)
constexpr int kDkvRawBytes = 2 * kRowsPerCta * kRawPitch * 4;

constexpr int kFwdSmem = kFwdStages * kFwdStageBytes + 1024;
constexpr int kDqSmem = kDqStages * kDqStageBytes + 1024;
constexpr int kDkvSmem = kDkvRawBytes + kDkvStages * kDkvStageBytes + 1024;
static_assert(kDkvRawBytes % 1024 == 0, "stages must start on 1 KiB");
static_assert(kDkvSmem <= 232448 && kFwdSmem <= 232448 && kDqSmem <= 232448, "shared memory");

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Bulk copy (TMA engine) of `bytes` from device memory into shared memory,
// completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int M>
__device__ __forceinline__ void fence_regs(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Keeps A fragments live until the wgmma reading them has been waited for
// (the asm statements issuing it do not tell the compiler they read late).
template <int KS>
__device__ __forceinline__ void fence_frags(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(hi[ks][i]), "+r"(lo[ks][i])::"memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 B apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// D(64 x 64) = A(64 x 8, registers) B(8 x 64, shared memory) + (add ? D : 0),
// TF32.
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// D(64 x 32) = A(64 x 8, registers) B(8 x 32, shared memory) + (add ? D : 0),
// TF32.
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// D = A B over KS steps of 8 along K in 3xTF32: A's hi/lo fragments in
// registers, B's hi and lo images at descriptors bhi and blo, whose halves
// (K 0-31 and 32-63) lie `half` 16-byte units apart. The tensor cores add
// into D rounding toward zero, so the small cross terms go first, while D
// is small, and a chain is one tile long: callers add tiles in float32.
template <int NREG, int KS>
__device__ __forceinline__ void gemm3(float (&d)[NREG], const uint32_t (&hi)[KS][4],
                                      const uint32_t (&lo)[KS][4], uint64_t bhi, uint64_t blo,
                                      int half) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t off = static_cast<uint64_t>((ks / 4) * half + (ks % 4) * 2);
    mma(d, lo[ks], bhi + off, ks > 0);
    mma(d, hi[ks], blo + off, 1);
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    mma(d, hi[ks], bhi + static_cast<uint64_t>((ks / 4) * half + (ks % 4) * 2), 1);
}

template <int M>
__device__ __forceinline__ void zero(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) r[i] = 0.f;
}

template <int M>
__device__ __forceinline__ void add(float (&acc)[M], const float (&tile)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] += tile[i];
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

template <int KS>
__device__ __forceinline__ void split_frags(const float (&x)[KS][4], uint32_t (&hi)[KS][4],
                                            uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[ks][i], hi[ks][i], lo[ks][i]);
}

// An accumulator (64 x 8 KS) as the A operand of the next product, hi/lo,
// with the contraction axis permuted within groups of 8 (see the note).
template <int KS, int NREG>
__device__ __forceinline__ void acc_frags(const float (&acc)[NREG], uint32_t (&hi)[KS][4],
                                          uint32_t (&lo)[KS][4]) {
  static_assert(NREG == 4 * KS, "one k step per 8 accumulator columns");
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    split(acc[4 * ks + 0], hi[ks][0], lo[ks][0]);
    split(acc[4 * ks + 2], hi[ks][1], lo[ks][1]);
    split(acc[4 * ks + 1], hi[ks][2], lo[ks][2]);
    split(acc[4 * ks + 3], hi[ks][3], lo[ks][3]);
  }
}

// The A fragments (k steps of 8 over 64 columns) of a thread's two rows:
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each step; a missing row
// reads 0.
__device__ __forceinline__ void row_frags(const float* r0, const float* r1, int t,
                                          float (&a)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    a[ks][0] = r0 ? __ldg(r0 + 8 * ks + t) : 0.f;
    a[ks][1] = r1 ? __ldg(r1 + 8 * ks + t) : 0.f;
    a[ks][2] = r0 ? __ldg(r0 + 8 * ks + t + 4) : 0.f;
    a[ks][3] = r1 ? __ldg(r1 + 8 * ks + t + 4) : 0.f;
  }
}

__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------------ images

// Row n and first K value k0 of 16-byte chunk `chunk` of an image of `rows`
// rows: halves of 32 K values (rows x 128 B each), 1 KiB atoms of 8 rows,
// chunk c of row r at position c ^ r.
__device__ __forceinline__ void image_coord(int chunk, int rows, int& n, int& k0) {
  const int half = chunk / (rows * 8), rem = chunk % (rows * 8);
  const int r = (rem >> 3) & 7;
  n = (rem >> 6) * 8 + r;
  k0 = half * 32 + (((rem & 7) ^ r) << 2);
}

// The source row of logical position l along a permuted contraction axis.
__device__ __forceinline__ int perm_row(int l) {
  const int i = l & 7;
  return (l & ~7) | (i < 4 ? 2 * i : 2 * i - 7);
}

__device__ __forceinline__ void store_split(float* hi, float* lo, int chunk, float4 x) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  reinterpret_cast<uint4*>(hi)[chunk] = make_uint4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<uint4*>(lo)[chunk] = make_uint4(l[0], l[1], l[2], l[3]);
}

// Writes the hi and lo images (each `rows` x 64 or 64 x `rows` floats) of a
// tile held in shared memory as src[row][d] (pitch kD + 1): `transposed`
// makes d the image's rows and the tile's rows (permuted) its K axis.
__device__ __forceinline__ void write_image(const float* src, int rows, bool transposed,
                                            float* hi, float* lo) {
  constexpr int p = kD + 1;
  const int img_rows = transposed ? kD : rows;
  for (int c = threadIdx.x; c < rows * kD / 4; c += blockDim.x) {
    int n, k0;
    image_coord(c, img_rows, n, k0);
    float4 x;
    if (transposed) {
      x = make_float4(src[perm_row(k0) * p + n], src[perm_row(k0 + 1) * p + n],
                      src[perm_row(k0 + 2) * p + n], src[perm_row(k0 + 3) * p + n]);
    } else {
      const float* s = src + n * p + k0;
      x = make_float4(s[0], s[1], s[2], s[3]);
    }
    store_split(hi, lo, c, x);
  }
}

// `rows` rows of 64 floats (row stride `stride`, rows from `first`, zeros at
// and beyond n) into shared memory at pitch kD + 1.
__device__ __forceinline__ void load_tile(const float* base, size_t stride, int first, int rows,
                                          int n, float* dst) {
  for (int i = threadIdx.x; i < rows * kD / 4; i += blockDim.x) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < n) v = __ldg(reinterpret_cast<const float4*>(base + (first + r) * stride + c));
    float* d = dst + r * (kD + 1) + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// ------------------------------------------------------------ pre-passes

// Forward: each key tile of 64 as its stage image: K (hi, lo), V^T (hi, lo).
__global__ void __launch_bounds__(kPrepThreads) flash_attention_fwd_prep(
    const float* __restrict__ qkv, float* __restrict__ img, int N, int H, int T) {
  __shared__ float sk[kFwdTile * (kD + 1)], sv[kFwdTile * (kD + 1)];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t stride = static_cast<size_t>(3) * H * kD;
  const float* kb = qkv + static_cast<size_t>(b) * N * stride + (H + h) * kD;
  load_tile(kb, stride, j * kFwdTile, kFwdTile, N, sk);
  load_tile(kb + H * kD, stride, j * kFwdTile, kFwdTile, N, sv);
  __syncthreads();
  float* out = img + (static_cast<size_t>(bh) * T + j) * (kFwdStageBytes / 4);
  constexpr int f = kImage64 / 4;
  write_image(sk, kFwdTile, false, out, out + f);
  write_image(sv, kFwdTile, true, out + 2 * f, out + 3 * f);
}

// Backward: blockIdx.z 0 writes each key tile of 32 as the dq pass's stage
// image (K, V, K^T); 1 writes each query tile of 32 as the dk/dv pass's (Q,
// dO, Q^T, dO^T, the rows' lse2 and D = rowsum(dO o O)) and D to dvec.
__global__ void __launch_bounds__(kPrepThreads) flash_attention_bwd_prep(
    const float* __restrict__ qkv, const float* __restrict__ out, const float* __restrict__ lse,
    const float* __restrict__ dout, float* __restrict__ kv_img, float* __restrict__ q_img,
    float* __restrict__ dvec, int N, int H, int T, int lse_stride) {
  __shared__ float sa[kBwdTile * (kD + 1)], sb[kBwdTile * (kD + 1)], so[kBwdTile * (kD + 1)];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int first = j * kBwdTile;
  const size_t stride = static_cast<size_t>(3) * H * kD, ostride = static_cast<size_t>(H) * kD;
  const float* qb = qkv + static_cast<size_t>(b) * N * stride + h * kD;
  constexpr int f = kImage32 / 4;
  if (blockIdx.z == 0) {
    load_tile(qb + H * kD, stride, first, kBwdTile, N, sa);
    load_tile(qb + 2 * H * kD, stride, first, kBwdTile, N, sb);
    __syncthreads();
    float* o = kv_img + (static_cast<size_t>(bh) * T + j) * (kDqStageBytes / 4);
    write_image(sa, kBwdTile, false, o, o + f);
    write_image(sb, kBwdTile, false, o + 2 * f, o + 3 * f);
    write_image(sa, kBwdTile, true, o + 4 * f, o + 5 * f);
    return;
  }
  const size_t orow = static_cast<size_t>(b) * N * ostride + h * kD;
  load_tile(qb, stride, first, kBwdTile, N, sa);
  load_tile(dout + orow, ostride, first, kBwdTile, N, sb);
  load_tile(out + orow, ostride, first, kBwdTile, N, so);
  __syncthreads();
  float* o = q_img + (static_cast<size_t>(bh) * T + j) * (kDkvTileBytes / 4);
  write_image(sa, kBwdTile, false, o, o + f);
  write_image(sb, kBwdTile, false, o + 2 * f, o + 3 * f);
  write_image(sa, kBwdTile, true, o + 4 * f, o + 5 * f);
  write_image(sb, kBwdTile, true, o + 6 * f, o + 7 * f);
  if (threadIdx.x < kBwdTile) {
    const int r = threadIdx.x, n = first + r;
    float dsum = 0.f, l = INFINITY;  // a missing row: P = 2^-inf = 0
    if (n < N) {
      for (int d = 0; d < kD; ++d) dsum = fmaf(sb[r * (kD + 1) + d], so[r * (kD + 1) + d], dsum);
      l = lse[static_cast<size_t>(bh) * lse_stride + n];
      dvec[static_cast<size_t>(bh) * T * kBwdTile + n] = dsum;
    }
    o[8 * f + r] = l;
    o[8 * f + kBwdTile + r] = dsum;
  }
}

// ------------------------------------------------------------ main kernels

// The producer thread: stage images of `tiles` tiles from `src` (tile stride
// `tile_bytes`, `bytes` of each) into the ring at `ring` (stage stride
// `stage_bytes`), `stages` deep, each on full[s] once the consumers have
// released it on empty[s].
__device__ __forceinline__ void produce(const uint8_t* src, int tiles, int tile_bytes, int bytes,
                                        uint8_t* ring, int stage_bytes, int stages,
                                        uint64_t* full, uint64_t* empty) {
  for (int j = 0; j < tiles; ++j) {
    const int s = j % stages;
    if (j >= stages) mbar_wait(&empty[s], ((j / stages) - 1) & 1);
    mbar_expect_tx(&full[s], bytes);
    const uint8_t* from = src + static_cast<size_t>(j) * tile_bytes;
    uint8_t* to = ring + static_cast<size_t>(s) * stage_bytes;
    for (int off = 0; off < bytes; off += 16384) {
      const int n = bytes - off < 16384 ? bytes - off : 16384;
      bulk_load(to + off, from + off, n, &full[s]);
    }
  }
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// Forward. Grid (ceil(N / 128), B H); 2 consumer warpgroups of 64 query
// rows and a producer warpgroup.
__global__ void __launch_bounds__(kThreads, 1) flash_attention_fwd(
    const float* __restrict__ qkv, const uint8_t* __restrict__ img, float* __restrict__ out,
    float* __restrict__ lse, int N, int H, int T, int lse_stride) {
  extern __shared__ uint8_t dyn[];
  uint8_t* ring = align_1k(dyn);
  __shared__ __align__(8) uint64_t full[kFwdStages], empty[kFwdStages];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_ring(full, empty, kFwdStages);
  __syncthreads();
  if (warp >= 4 * kConsumers) {
    regs_dec<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0)
      produce(img + static_cast<size_t>(bh) * T * kFwdStageBytes, T, kFwdStageBytes,
              kFwdStageBytes, ring, kFwdStageBytes, kFwdStages, full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRowsPerCta + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int row1 = row0 + 8;
  const size_t stride = static_cast<size_t>(3) * H * kD;
  const float* qb = qkv + static_cast<size_t>(b) * N * stride + h * kD;
  uint32_t qh[8][4], ql[8][4];
  {
    float q[8][4];
    row_frags(row0 < N ? qb + row0 * stride : nullptr, row1 < N ? qb + row1 * stride : nullptr, t,
              q);
    split_frags(q, qh, ql);
  }
  float o[32];
  zero(o);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < T; ++j) {
    const int s = j % kFwdStages;
    mbar_wait(&full[s], (j / kFwdStages) & 1);
    const uint8_t* st = ring + s * kFwdStageBytes;
    float sc[32];
    wg_fence();
    gemm3(sc, qh, ql, desc_sw128(st), desc_sw128(st + kImage64), kFwdTile * 8);
    wg_commit();
    wg_wait0();
    fence_frags(qh, ql);
    fence_regs(sc);
    if ((j + 1) * kFwdTile > N) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * kFwdTile + 8 * jj + 2 * t + e >= N) sc[4 * jj + e] = sc[4 * jj + 2 + e] = -INFINITY;
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      x0 = fmaxf(x0, fmaxf(sc[4 * jj], sc[4 * jj + 1]));
      x1 = fmaxf(x1, fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
    }
    const float n0 = fmaxf(m0, quad_max(x0) * kScale), n1 = fmaxf(m1, quad_max(x1) * kScale);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * jj + e] = exp2f(fmaf(sc[4 * jj + e], kScale, -m0));
        sc[4 * jj + 2 + e] = exp2f(fmaf(sc[4 * jj + 2 + e], kScale, -m1));
        l0 += sc[4 * jj + e];
        l1 += sc[4 * jj + 2 + e];
      }
    }
    uint32_t ph[8][4], pl[8][4];
    acc_frags<8>(sc, ph, pl);
    float pv[32];
    wg_fence();
    gemm3(pv, ph, pl, desc_sw128(st + 2 * kImage64), desc_sw128(st + 3 * kImage64),
          kFwdTile * 8);
    wg_commit();
    wg_wait0();
    fence_frags(ph, pl);
    fence_regs(pv);
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      o[4 * jj] = fmaf(o[4 * jj], a0, pv[4 * jj]);
      o[4 * jj + 1] = fmaf(o[4 * jj + 1], a0, pv[4 * jj + 1]);
      o[4 * jj + 2] = fmaf(o[4 * jj + 2], a1, pv[4 * jj + 2]);
      o[4 * jj + 3] = fmaf(o[4 * jj + 3], a1, pv[4 * jj + 3]);
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const size_t ostride = static_cast<size_t>(H) * kD;
  float* ob = out + static_cast<size_t>(b) * N * ostride + h * kD + 2 * t;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (row0 < N)
      *reinterpret_cast<float2*>(ob + row0 * ostride + 8 * jj) =
          make_float2(o[4 * jj] * i0, o[4 * jj + 1] * i0);
    if (row1 < N)
      *reinterpret_cast<float2*>(ob + row1 * ostride + 8 * jj) =
          make_float2(o[4 * jj + 2] * i1, o[4 * jj + 3] * i1);
  }
  if (t == 0) {
    float* lb = lse + static_cast<size_t>(bh) * lse_stride;
    if (row0 < N) lb[row0] = m0 + log2f(l0);
    if (row1 < N) lb[row1] = m1 + log2f(l1);
  }
}

// Backward, dq. Grid (ceil(N / 128), B H); 128 query rows a CTA (Q and dO
// raw in registers, dq accumulated there), key tiles of 32.
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dq(
    const float* __restrict__ qkv, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, const uint8_t* __restrict__ img, float* __restrict__ dqkv,
    int N, int H, int T, int lse_stride) {
  extern __shared__ uint8_t dyn[];
  uint8_t* ring = align_1k(dyn);
  __shared__ __align__(8) uint64_t full[kDqStages], empty[kDqStages];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_ring(full, empty, kDqStages);
  __syncthreads();
  if (warp >= 4 * kConsumers) {
    regs_dec<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0)
      produce(img + static_cast<size_t>(bh) * T * kDqStageBytes, T, kDqStageBytes, kDqStageBytes,
              ring, kDqStageBytes, kDqStages, full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRowsPerCta + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int row1 = row0 + 8;
  const size_t stride = static_cast<size_t>(3) * H * kD, ostride = static_cast<size_t>(H) * kD;
  const float* qb = qkv + static_cast<size_t>(b) * N * stride + h * kD;
  const float* db = dout + static_cast<size_t>(b) * N * ostride + h * kD;
  float q[8][4], d[8][4];
  row_frags(row0 < N ? qb + row0 * stride : nullptr, row1 < N ? qb + row1 * stride : nullptr, t,
            q);
  row_frags(row0 < N ? db + row0 * ostride : nullptr, row1 < N ? db + row1 * ostride : nullptr, t,
            d);
  const float* lb = lse + static_cast<size_t>(bh) * lse_stride;
  const float* vb = dvec + static_cast<size_t>(bh) * T * kBwdTile;
  const float L0 = row0 < N ? lb[row0] : 0.f, L1 = row1 < N ? lb[row1] : 0.f;
  const float D0 = row0 < N ? vb[row0] : 0.f, D1 = row1 < N ? vb[row1] : 0.f;
  float dq[32];
  zero(dq);
  for (int j = 0; j < T; ++j) {
    const int s = j % kDqStages;
    mbar_wait(&full[s], (j / kDqStages) & 1);
    const uint8_t* st = ring + s * kDqStageBytes;
    float sc[16], dp[16];
    {
      uint32_t hi[8][4], lo[8][4];
      split_frags(q, hi, lo);
      wg_fence();
      gemm3(sc, hi, lo, desc_sw128(st), desc_sw128(st + kImage32), kBwdTile * 8);
      wg_commit();
      wg_wait0();
      fence_frags(hi, lo);
    }
    {
      uint32_t hi[8][4], lo[8][4];
      split_frags(d, hi, lo);
      wg_fence();
      gemm3(dp, hi, lo, desc_sw128(st + 2 * kImage32), desc_sw128(st + 3 * kImage32),
            kBwdTile * 8);
      wg_commit();
      wg_wait0();
      fence_frags(hi, lo);
    }
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j * kBwdTile + 8 * jj + 2 * t + e < N;
        const float p0 = ok ? exp2f(fmaf(sc[4 * jj + e], kScale, -L0)) : 0.f;
        const float p1 = ok ? exp2f(fmaf(sc[4 * jj + 2 + e], kScale, -L1)) : 0.f;
        sc[4 * jj + e] = p0 * (dp[4 * jj + e] - D0);
        sc[4 * jj + 2 + e] = p1 * (dp[4 * jj + 2 + e] - D1);
      }
    uint32_t hi[4][4], lo[4][4];
    acc_frags<4>(sc, hi, lo);
    float tile[32];
    wg_fence();
    gemm3(tile, hi, lo, desc_sw128(st + 4 * kImage32), desc_sw128(st + 5 * kImage32), kD * 8);
    wg_commit();
    wg_wait0();
    fence_frags(hi, lo);
    fence_regs(tile);
    if (lane == 0) mbar_arrive(&empty[s]);
    add(dq, tile);
  }
  float* gb = dqkv + static_cast<size_t>(b) * N * stride + h * kD + 2 * t;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (row0 < N)
      *reinterpret_cast<float2*>(gb + row0 * stride + 8 * jj) =
          make_float2(dq[4 * jj] * 0.125f, dq[4 * jj + 1] * 0.125f);
    if (row1 < N)
      *reinterpret_cast<float2*>(gb + row1 * stride + 8 * jj) =
          make_float2(dq[4 * jj + 2] * 0.125f, dq[4 * jj + 3] * 0.125f);
  }
}

// Backward, dk and dv. Grid (ceil(N / 128), B H); 128 key rows a CTA (raw K
// and V in shared memory, dK and dV in registers), query tiles of 32.
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dkdv(
    const float* __restrict__ qkv, const uint8_t* __restrict__ img, float* __restrict__ dqkv,
    int N, int H, int T) {
  extern __shared__ uint8_t dyn[];
  uint8_t* base = align_1k(dyn);
  float* raw = reinterpret_cast<float*>(base);  // K rows, then V rows, pitch kRawPitch
  uint8_t* ring = base + kDkvRawBytes;
  __shared__ __align__(8) uint64_t full[kDkvStages], empty[kDkvStages];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kRowsPerCta;
  const size_t stride = static_cast<size_t>(3) * H * kD;
  const float* kb = qkv + static_cast<size_t>(b) * N * stride + (H + h) * kD;
  init_ring(full, empty, kDkvStages);
  for (int i = threadIdx.x; i < 2 * kRowsPerCta * kD / 4; i += blockDim.x) {
    const int which = i / (kRowsPerCta * kD / 4), rem = i % (kRowsPerCta * kD / 4);
    const int r = rem / (kD / 4), c = (rem % (kD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < N)
      v = __ldg(reinterpret_cast<const float4*>(kb + which * H * kD + (first + r) * stride + c));
    *reinterpret_cast<float4*>(raw + (which * kRowsPerCta + r) * kRawPitch + c) = v;
  }
  __syncthreads();
  if (warp >= 4 * kConsumers) {
    regs_dec<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0)
      produce(img + static_cast<size_t>(bh) * T * kDkvTileBytes, T, kDkvTileBytes, kDkvTileBytes,
              ring, kDkvStageBytes, kDkvStages, full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // local rows lr0, lr0 + 8
  const float* rk0 = raw + lr0 * kRawPitch;
  const float* rv0 = raw + (kRowsPerCta + lr0) * kRawPitch;
  float dk[32], dv[32];
  zero(dk);
  zero(dv);
  for (int j = 0; j < T; ++j) {
    const int s = j % kDkvStages;
    mbar_wait(&full[s], (j / kDkvStages) & 1);
    const uint8_t* st = ring + s * kDkvStageBytes;
    float sc[16], dp[16];
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* r0 = which ? rv0 : rk0;
      float a[8][4];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        a[ks][0] = r0[8 * ks + t];
        a[ks][1] = r0[8 * kRawPitch + 8 * ks + t];
        a[ks][2] = r0[8 * ks + t + 4];
        a[ks][3] = r0[8 * kRawPitch + 8 * ks + t + 4];
      }
      uint32_t hi[8][4], lo[8][4];
      split_frags(a, hi, lo);
      wg_fence();
      if (which == 0)
        gemm3(sc, hi, lo, desc_sw128(st), desc_sw128(st + kImage32), kBwdTile * 8);
      else
        gemm3(dp, hi, lo, desc_sw128(st + 2 * kImage32), desc_sw128(st + 3 * kImage32),
              kBwdTile * 8);
      wg_commit();
      wg_wait0();
      fence_frags(hi, lo);
    }
    fence_regs(sc);
    fence_regs(dp);
    const float* ls = reinterpret_cast<const float*>(st + kDkvImageBytes);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + 2 * t + e;
        const float L = ls[c], Dc = ls[kBwdTile + c];
        const float p0 = exp2f(fmaf(sc[4 * jj + e], kScale, -L));
        const float p1 = exp2f(fmaf(sc[4 * jj + 2 + e], kScale, -L));
        sc[4 * jj + e] = p0;
        sc[4 * jj + 2 + e] = p1;
        dp[4 * jj + e] = p0 * (dp[4 * jj + e] - Dc);
        dp[4 * jj + 2 + e] = p1 * (dp[4 * jj + 2 + e] - Dc);
      }
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
    acc_frags<4>(sc, ph, pl);
    acc_frags<4>(dp, sh, sl);
    float tv[32], tk[32];
    wg_fence();
    gemm3(tv, ph, pl, desc_sw128(st + 6 * kImage32), desc_sw128(st + 7 * kImage32), kD * 8);
    gemm3(tk, sh, sl, desc_sw128(st + 4 * kImage32), desc_sw128(st + 5 * kImage32), kD * 8);
    wg_commit();
    wg_wait0();
    fence_frags(ph, pl);
    fence_frags(sh, sl);
    fence_regs(tv);
    fence_regs(tk);
    if (lane == 0) mbar_arrive(&empty[s]);
    add(dv, tv);
    add(dk, tk);
  }
  const int row0 = first + lr0, row1 = row0 + 8;
  float* gk = dqkv + static_cast<size_t>(b) * N * stride + (H + h) * kD + 2 * t;
  float* gv = gk + H * kD;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (row0 < N) {
      *reinterpret_cast<float2*>(gk + row0 * stride + 8 * jj) =
          make_float2(dk[4 * jj] * 0.125f, dk[4 * jj + 1] * 0.125f);
      *reinterpret_cast<float2*>(gv + row0 * stride + 8 * jj) =
          make_float2(dv[4 * jj], dv[4 * jj + 1]);
    }
    if (row1 < N) {
      *reinterpret_cast<float2*>(gk + row1 * stride + 8 * jj) =
          make_float2(dk[4 * jj + 2] * 0.125f, dk[4 * jj + 3] * 0.125f);
      *reinterpret_cast<float2*>(gv + row1 * stride + 8 * jj) =
          make_float2(dv[4 * jj + 2], dv[4 * jj + 3]);
    }
  }
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

int set_smem() {
  static int err = -1;
  if (err < 0) {
    err = static_cast<int>(cudaFuncSetAttribute(
        flash_attention_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem));
    if (!err)
      err = static_cast<int>(cudaFuncSetAttribute(
          flash_attention_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem));
    if (!err)
      err = static_cast<int>(cudaFuncSetAttribute(
          flash_attention_bwd_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem));
  }
  return err;
}

}  // namespace

// Bytes of scratch a call needs (backward != 0: the backward's), and the
// length of a (frame, head)'s log-sum-exp row.
extern "C" long long vit_attention_scratch_bytes(int B, int N, int H, int backward) {
  const long long bh = static_cast<long long>(B) * H;
  if (!backward) return bh * tiles(N, kFwdTile) * kFwdStageBytes;
  const long long t = tiles(N, kBwdTile);
  return bh * t * (kDqStageBytes + kDkvTileBytes + kBwdTile * 4);
}

extern "C" int vit_attention_lse_stride(int N) { return tiles(N, kFwdTile) * kFwdTile; }

extern "C" int vit_attention_forward(const float* qkv, float* out, float* lse, void* scratch,
                                     int B, int N, int H, cudaStream_t stream) {
  if (int err = set_smem()) return err;
  const int t = tiles(N, kFwdTile), bh = B * H;
  float* img = static_cast<float*>(scratch);
  flash_attention_fwd_prep<<<dim3(t, bh), kPrepThreads, 0, stream>>>(qkv, img, N, H, t);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  flash_attention_fwd<<<dim3(tiles(N, kRowsPerCta), bh), kThreads, kFwdSmem, stream>>>(
      qkv, reinterpret_cast<const uint8_t*>(img), out, lse, N, H, t, t * kFwdTile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vit_attention_backward(const float* qkv, const float* out, const float* lse,
                                      const float* dout, float* dqkv, void* scratch, int B,
                                      int N, int H, cudaStream_t stream) {
  if (int err = set_smem()) return err;
  const int t = tiles(N, kBwdTile), bh = B * H;
  uint8_t* kv_img = static_cast<uint8_t*>(scratch);
  uint8_t* q_img = kv_img + static_cast<size_t>(bh) * t * kDqStageBytes;
  float* dvec = reinterpret_cast<float*>(q_img + static_cast<size_t>(bh) * t * kDkvTileBytes);
  const int lse_stride = vit_attention_lse_stride(N);
  flash_attention_bwd_prep<<<dim3(t, bh, 2), kPrepThreads, 0, stream>>>(
      qkv, out, lse, dout, reinterpret_cast<float*>(kv_img), reinterpret_cast<float*>(q_img), dvec,
      N, H, t, lse_stride);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  flash_attention_bwd_dkdv<<<dim3(tiles(N, kRowsPerCta), bh), kThreads, kDkvSmem, stream>>>(
      qkv, q_img, dqkv, N, H, t);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  flash_attention_bwd_dq<<<dim3(tiles(N, kRowsPerCta), bh), kThreads, kDqSmem, stream>>>(
      qkv, dout, lse, dvec, kv_img, dqkv, N, H, t, lse_stride);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spill) bytes a thread and shared bytes a block
// (static plus dynamic) of kernel `which`: 0 fwd_prep, 1 fwd, 2 bwd_prep,
// 3 bwd_dkdv, 4 bwd_dq.
extern "C" int vit_attention_kernel_info(int which, int* regs, int* local, int* smem) {
  const void* fns[] = {reinterpret_cast<const void*>(flash_attention_fwd_prep),
                       reinterpret_cast<const void*>(flash_attention_fwd),
                       reinterpret_cast<const void*>(flash_attention_bwd_prep),
                       reinterpret_cast<const void*>(flash_attention_bwd_dkdv),
                       reinterpret_cast<const void*>(flash_attention_bwd_dq)};
  const int dyn[] = {0, kFwdSmem, 0, kDkvSmem, kDqSmem};
  if (which < 0 || which > 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  if (cudaError_t err = cudaFuncGetAttributes(&a, fns[which])) return static_cast<int>(err);
  *regs = a.numRegs;
  *local = static_cast<int>(a.localSizeBytes);
  *smem = static_cast<int>(a.sharedSizeBytes) + dyn[which];
  return 0;
}
