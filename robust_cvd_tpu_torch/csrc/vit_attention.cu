// Flash attention of the ViT encoder (models/dpt.py::Attention), written for
// Hopper (sm_90a): softmax(q k^T / 8) v over heads of width 64, forward and
// backward, in float32 with 3xTF32 products; and, at head width 32, Swin
// V2's window attention (see "Swin V2's windows" below).
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
// Relative-position bias (BEiT, models/beit.py): softmax(q k^T / 8 + B) v
// with B[i, j] = T[idx(i, j)], T a per-head table of R = (2 Wh - 1)
// (2 Ww - 1) + 3 entries (H, R) and idx timm's relative position index on
// the Wh x Ww token grid. The *_bias kernels are the three main kernels
// with the bias gathered in, and the backward also writes dT, the table's
// gradient: dT[r] = sum over frames and (i, j) with idx(i, j) = r of dS.
// - The index in closed form. For a patch token n at (y, x) the wrapper
//   passes c_n = y (2 Ww - 1) + x (pos, -1 for the class token, padded with
//   0 past the kernels' 128-row tiles); then idx(i, j) = K0 + c_i - c_j with
//   K0 = (Wh - 1)(2 Ww - 1) + Ww - 1, and the class token's row, column and
//   diagonal are R - 3, R - 2 and R - 1. A row precomputes (rk, f, rc) so
//   that idx = c_j < 0 ? rc : rk - f c_j: one multiply-add and a select an
//   element. No (B, H, N, N) or (H, N, N) bias is written anywhere.
// - The table is read through the L1 (__ldg): a CTA's 128 rows and one key
//   tile touch a few hundred entries, and the kernels' shared memory (up to
//   203,808 B of the 232,448 a block may have) has no room for a 28 KB
//   table beside the ring at 1,793 tokens (32 x 56 grid) in the dk/dv pass.
// - The bias is added in base-2 units, s2 = s log2(e) / 8 + b log2(e), so
//   the online softmax, the saved log-sum-exp and the backward's
//   recomputed P all see the same biased scores.
// - dT is accumulated in the dq pass, which already visits every (i, j)
//   of its 128 query rows, off the tensor cores' path and without shared-
//   memory atomics. Each consumer warpgroup stages its 64 x 32 tile of dS
//   diagonal-major (row u of the stage holds the diagonals row - key = u
//   and u - 64) and hands it to a walker, one of two otherwise idle warps
//   of the producer warpgroup, through an mbarrier pair; two stages a
//   warpgroup let the consumers run a tile ahead. Walker lane l owns stage
//   rows l and l + 32, so whole diagonals, and only one diagonal can hold
//   an index within a tile: it sums each run of one index in float32 and
//   adds it into the warpgroup's copy of the CTA's window of the table
//   (the indices its rows can reach, at most 3/4 (R - 3) + 128 entries:
//   3,789 of the 6,996 at 1,793 tokens), with no two lanes on one entry. At the end the CTA adds the two copies into dT in device memory
//   with float atomics, summing frames and query blocks. dq, dk and dv stay
//   bitwise deterministic; dT's float32 sums are not (the device atomics'
//   order varies), within float32 rounding. Beside the tensor cores'
//   operand reads a shared-memory round trip costs ~400-700 cycles, so the
//   walker puts its loads in flight together and the consumer arrives on a
//   stage's barrier only after the tile's last product has been waited for
//   (its release then finds the stores done). Tables of up to kMaxTable
//   entries (12,799: a 40 x 81 grid) fit.
// - Tried (BEiT's cell shape, (4, 1793, 16), 32 x 56 grid; the dq pass
//   without dT 1.22 ms, with it, walked by the consumers after the tile's
//   last product, 2.31 ms): before, one shared-memory float atomic an
//   element of dS (a compare-and-swap loop on sm_90) 5.64 ms for the
//   backward, pre-summed pairs 4.58, a lane's run of a warp's tile 4.20,
//   the warpgroup's diagonals in runs, written where the index changes,
//   4.31 (kept in the form "a run a pass", 4.10), two producer warps
//   walking behind named barriers 5.07. Then (the dq pass alone, a call):
//   the ring at 2, 3 and 4 stages without dT 1.22, 1.23, 1.19 ms (depth is
//   not the lever); walker warps behind mbarriers, a lane's runs written
//   where they end 2.80 (divergent writes, spills); run sums in place,
//   then a run of all lanes a pass 2.09-2.12; each run added into dT in
//   device memory with a float atomic instead of shared copies 2.60-2.88
//   (the atomics cost more than the shared-memory round trips); the stage
//   released after the sums, its arrive once the product is waited for,
//   1.85; a conflict-free pitch and the class token apart 1.78; the rows'
//   offsets for the gathers in two registers instead of six 1.75 (kept;
//   spills 88 -> 64 bytes); the stores beside the in-flight product 1.81
//   (spills 120 bytes); the stage's release asked early with test_wait
//   1.92; the walkers' release folded into the ring's barrier 1.75.
//
// Swin V2's windows (models/swin2.py::WindowAttention): softmax(q k^T + B +
// M) v over heads of width 32, each "frame" of the batch one window of Wh x
// Ww tokens (N = Wh Ww, the windows of every image in order), the scores at
// scale 1 (the cosine attention's temperature is folded into q by the
// caller), B the continuous position bias (a per-head table of R = (2 Wh -
// 1)(2 Ww - 1) entries, made by ordinary torch ops) and M the shift mask.
// The *_window and *_window_mask kernels are the bias kernels' templates
// (fwd_body, dkdv_body, dq_body over <D, mode>) at D = 32, beside
// pre-passes at 32 (flash_attention_*_prep32):
// - Head width 32. A 32-float K-major row is exactly one 128-byte swizzle
//   atom, so q k^T contracts in 4 k steps of 8 (one half of the image, the
//   second never read) and the products with the head width as their N
//   (p v, dS k, P^T dO, dS^T q) are m64n32k8 (16 accumulator registers),
//   their B images D = 32 rows of K-major keys, two halves of 32 keys 4 KiB
//   apart. The tiling is kernel 3's (128 query rows a CTA, key tiles of 64
//   forward and 32 backward, the same rings at half the bytes); the
//   registers freed are not spent.
// - No class token: pos holds c_n for every token, idx = K0 + c_i - c_j
//   (the same closed form, its class-token selects compiled out), the dq
//   pass's window starts at the block's first row and its class entries
//   are neither staged nor flushed.
// - The mask: with region codes (nW, pos length) int32, window b's row b
//   mod nW, the gathered bias takes -100 where the row's and the key's
//   codes differ, before it is scaled to base 2 (timm adds -100 to the
//   biased scores); dT takes dS unmasked, as the table's gradient does in
//   the written-out version (masked entries have P ~ e^-100, dS ~ 0).
// - dT is summed in the dq pass by the walker warps, as for BEiT: the
//   walk's rule (an index a diagonal, runs that change where a row or a
//   key crosses a grid row) does not depend on the grid.
// - No zero-padding of d to 64 was tried.
//
// No kernel allocates or synchronises: the wrapper (ops/attention.py)
// passes outputs and scratch (torch.empty) and PyTorch's current stream,
// so a CUDA graph captures the calls unchanged. Plain C interface, bound
// with ctypes; each launcher returns the first launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kConsumers = 2;  // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup
// Registers a thread after setmaxnreg: the producer gives its share to the
// consumers (2 x 128 x 232 + 128 x 40 <= 65,536).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kRowsPerCta = 64 * kConsumers;
constexpr int kPrepThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// The kernels' modes: no bias (ViT); the relative-position bias with a
// class token (BEiT); Swin V2's windows (no class token, the scores'
// scale 1), without and with the shift mask.
enum Mode { kPlain, kBias, kWindow, kWindowMask };

template <int kMode>
struct Traits {
  static constexpr bool bias = kMode != kPlain;
  static constexpr bool cls = kMode == kBias;
  static constexpr bool mask = kMode == kWindowMask;
  static constexpr bool window = kMode == kWindow || kMode == kWindowMask;
  // log2(e) times the scores' scale: 1 / sqrt(64) (ViT, BEiT), or 1 (the
  // windows: q carries Swin V2's temperature); and that scale, dq's and
  // dk's factor
  static constexpr float scale2 = window ? kLog2e : 0.18033688011112042f;
  static constexpr float grad = window ? 1.f : 0.125f;
};

constexpr int kFwdTile = 64;  // forward: key tiles of 64
constexpr int kFwdStages = 3;
constexpr int kBwdTile = 32;  // backward: tiles of 32 rows
constexpr int kDqStages = 4;
constexpr int kDkvStages = 2;
// dq pass with a bias: a 2-stage ring (4 would gain ~3%: the stages' room
// goes to dT), each consumer warpgroup's two dS stages, the walkers' run
// sums, then a copy a warpgroup of the CTA's window of dT
constexpr int kDqBiasStages = 2;
constexpr int kDqBiasSmemMax = 232448 - 1024;  // 1 KiB left for the static barriers

// Tiles and shared memory at head width D (64 or 32). Images: a tile of
// `rows` rows (the product's N) by 32 or 64 values along the contraction
// (K), hi then lo.
template <int D>
struct Geo {
  static_assert(D == 64 || D == 32, "head width");
  static constexpr int kImage64 = 64 * D * 4;  // 64 x D or D x 64 floats (16 KiB at 64)
  static constexpr int kImage32 = 32 * D * 4;  // 32 x D or D x 32 floats
  // forward: K (64 x D) and V^T (D x 64 keys), hi and lo
  static constexpr int kFwdStageBytes = 4 * kImage64;
  // dq pass, key tiles: K (32 x D), V (32 x D), K^T (D x 32 keys)
  static constexpr int kDqStageBytes = 6 * kImage32;
  // dk/dv pass, query tiles: Q, dO (32 x D), Q^T, dO^T (D x 32 queries),
  // then the tile's lse2 and D (32 floats each)
  static constexpr int kDkvImageBytes = 8 * kImage32;
  static constexpr int kDkvTileBytes = kDkvImageBytes + 2 * kBwdTile * 4;  // in device memory
  static constexpr int kDkvStageBytes = kDkvImageBytes + 1024;  // in shared memory, 1 KiB aligned
  static constexpr int kRawPitch = D + 4;  // raw K and V rows (conflict-free fragments)
  static constexpr int kDkvRawBytes = 2 * kRowsPerCta * kRawPitch * 4;
  static constexpr int kFwdSmem = kFwdStages * kFwdStageBytes + 1024;
  static constexpr int kDqSmem = kDqStages * kDqStageBytes + 1024;
  static constexpr int kDkvSmem = kDkvRawBytes + kDkvStages * kDkvStageBytes + 1024;
  static constexpr int kDqBiasRingSmem = kDqBiasStages * kDqStageBytes + 1024;
  static_assert(kDkvRawBytes % 1024 == 0, "stages must start on 1 KiB");
  static_assert(kDkvSmem <= 232448 && kFwdSmem <= 232448 && kDqSmem <= 232448, "shared memory");
};
// A dS stage, diagonal-major: row u = (row - key) mod 64 of the warpgroup's
// 64 x 32 tile holds, at column c, the element of key c. At a pitch of 37
// (5 mod 32) a consumer warp's 32 stores of one accumulator register, and
// a walker warp's reads of key c of 32 rows, each fall on 32 banks.
constexpr int kSkewPitch = 37;
constexpr int kSkewStage = 64 * kSkewPitch;  // floats
constexpr int kDtStageBytes = kConsumers * 2 * kSkewStage * 4;
// The walkers' run sums of a tile: at most 32 a stage row, two rows a lane
constexpr int kRunBytes = kConsumers * 2 * 32 * 32 * 4;
// A copy holds the class token's three entries, then the window.
constexpr int kDtClass = 3;
template <int D>
constexpr int kMaxCopy =
    (kDqBiasSmemMax - Geo<D>::kDqBiasRingSmem - kDtStageBytes - kRunBytes) / 8 & ~3;
// A CTA's window is at most 3/4 (R - 3) + 128 entries (see the note), so
// every table of up to kMaxTable entries fits (BEiT's, at 64).
constexpr int kMaxTable = 4 * (kMaxCopy<64> - kDtClass - 128) / 3 + 3;
constexpr int kPosTile = kRowsPerCta;  // pos is padded to a multiple of this
constexpr float kMaskValue = -100.f;  // Swin's shift mask, added to the bias

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

// The A fragments (KS k steps of 8 over 8 KS columns) of a thread's two
// rows: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each step; a
// missing row reads 0.
template <int KS>
__device__ __forceinline__ void row_frags(const float* r0, const float* r1, int t,
                                          float (&a)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
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

// ------------------------------------------------------- relative positions

// The bias of one call: the tables (H, R), the tokens' grid offsets `pos`
// (see the note) and K0. Null `table` in the kernels without a bias.
struct RelBias {
  const float* table;
  const int* pos;
  float* dtable;  // (H, R), the backward's dT, zeroed by the caller
  int R, K0, ww;  // ww: the grid's width
  int copy;       // the dq pass's floats a copy of dT (dq_bias_copy)
  // the shift mask's region codes (nW, rstride) int32 of the windows b mod
  // nW, or null
  const int* region;
  int nW, rstride;
};

// A query row's (rk, f, rc): its index is c_j < 0 ? rc : rk - f c_j (with
// a class token), rk - c_j (without).
struct RelRow {
  int rk, f, rc;
};

template <bool kCls>
__device__ __forceinline__ RelRow rel_row(const RelBias& rb, int i) {
  const int c = __ldg(rb.pos + i);
  if constexpr (!kCls) return {rb.K0 + c, 1, 0};
  const bool cls = c < 0;
  return {cls ? rb.R - 3 : rb.K0 + c, cls ? 0 : 1, cls ? rb.R - 1 : rb.R - 2};
}

template <bool kCls>
__device__ __forceinline__ int rel_index(const RelRow& r, int cj) {
  if constexpr (!kCls) return r.rk - cj;
  return cj < 0 ? r.rc : r.rk - r.f * cj;
}

// The same from the row's offset c_i alone (two registers a thread's rows
// where RelRow takes six).
template <bool kCls>
__device__ __forceinline__ int rel_index(const RelBias& rb, int ci, int cj) {
  if constexpr (!kCls) return rb.K0 + ci - cj;
  return cj < 0 ? (ci < 0 ? rb.R - 1 : rb.R - 2) : (ci < 0 ? rb.R - 3 : rb.K0 + ci - cj);
}

// The shift mask's term between two tokens' region codes.
__device__ __forceinline__ float mask_term(int a, int b) { return a != b ? kMaskValue : 0.f; }

// The region codes of the window of frame b (b mod nW), or null.
__device__ __forceinline__ const int* region_row(const RelBias& rb, int b) {
  return rb.region + static_cast<size_t>(b % rb.nW) * rb.rstride;
}

// The dq pass's consumer warpgroups (threads 0-255) and its two walker
// warps (288-351; the producer warpgroup's others have returned).
__device__ __forceinline__ void dt_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * kConsumers + 64) : "memory");
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

// Writes the hi and lo images (each `rows` x D or D x `rows` floats) of a
// tile held in shared memory as src[row][d] (pitch D + 1): `transposed`
// makes d the image's rows and the tile's rows (permuted) its K axis.
template <int D>
__device__ __forceinline__ void write_image(const float* src, int rows, bool transposed,
                                            float* hi, float* lo) {
  constexpr int p = D + 1;
  const int img_rows = transposed ? D : rows;
  for (int c = threadIdx.x; c < rows * D / 4; c += blockDim.x) {
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

// `rows` rows of D floats (row stride `stride`, rows from `first`, zeros at
// and beyond n) into shared memory at pitch D + 1.
template <int D>
__device__ __forceinline__ void load_tile(const float* base, size_t stride, int first, int rows,
                                          int n, float* dst) {
  for (int i = threadIdx.x; i < rows * D / 4; i += blockDim.x) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < n) v = __ldg(reinterpret_cast<const float4*>(base + (first + r) * stride + c));
    float* d = dst + r * (D + 1) + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// ------------------------------------------------------------ pre-passes

// Forward: each key tile of 64 as its stage image: K (hi, lo), V^T (hi, lo).
template <int D>
__device__ __forceinline__ void fwd_prep_body(const float* __restrict__ qkv,
                                              float* __restrict__ img, int N, int H, int T) {
  using G = Geo<D>;
  __shared__ float sk[kFwdTile * (D + 1)], sv[kFwdTile * (D + 1)];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t stride = static_cast<size_t>(3) * H * D;
  const float* kb = qkv + static_cast<size_t>(b) * N * stride + (H + h) * D;
  load_tile<D>(kb, stride, j * kFwdTile, kFwdTile, N, sk);
  load_tile<D>(kb + H * D, stride, j * kFwdTile, kFwdTile, N, sv);
  __syncthreads();
  float* out = img + (static_cast<size_t>(bh) * T + j) * (G::kFwdStageBytes / 4);
  constexpr int f = G::kImage64 / 4;
  write_image<D>(sk, kFwdTile, false, out, out + f);
  write_image<D>(sv, kFwdTile, true, out + 2 * f, out + 3 * f);
}

__global__ void __launch_bounds__(kPrepThreads) flash_attention_fwd_prep(
    const float* __restrict__ qkv, float* __restrict__ img, int N, int H, int T) {
  fwd_prep_body<64>(qkv, img, N, H, T);
}

__global__ void __launch_bounds__(kPrepThreads) flash_attention_fwd_prep32(
    const float* __restrict__ qkv, float* __restrict__ img, int N, int H, int T) {
  fwd_prep_body<32>(qkv, img, N, H, T);
}

// Backward: blockIdx.z 0 writes each key tile of 32 as the dq pass's stage
// image (K, V, K^T); 1 writes each query tile of 32 as the dk/dv pass's (Q,
// dO, Q^T, dO^T, the rows' lse2 and D = rowsum(dO o O)) and D to dvec.
template <int D>
__device__ __forceinline__ void bwd_prep_body(
    const float* __restrict__ qkv, const float* __restrict__ out, const float* __restrict__ lse,
    const float* __restrict__ dout, float* __restrict__ kv_img, float* __restrict__ q_img,
    float* __restrict__ dvec, int N, int H, int T, int lse_stride) {
  using G = Geo<D>;
  __shared__ float sa[kBwdTile * (D + 1)], sb[kBwdTile * (D + 1)], so[kBwdTile * (D + 1)];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int first = j * kBwdTile;
  const size_t stride = static_cast<size_t>(3) * H * D, ostride = static_cast<size_t>(H) * D;
  const float* qb = qkv + static_cast<size_t>(b) * N * stride + h * D;
  constexpr int f = G::kImage32 / 4;
  if (blockIdx.z == 0) {
    load_tile<D>(qb + H * D, stride, first, kBwdTile, N, sa);
    load_tile<D>(qb + 2 * H * D, stride, first, kBwdTile, N, sb);
    __syncthreads();
    float* o = kv_img + (static_cast<size_t>(bh) * T + j) * (G::kDqStageBytes / 4);
    write_image<D>(sa, kBwdTile, false, o, o + f);
    write_image<D>(sb, kBwdTile, false, o + 2 * f, o + 3 * f);
    write_image<D>(sa, kBwdTile, true, o + 4 * f, o + 5 * f);
    return;
  }
  const size_t orow = static_cast<size_t>(b) * N * ostride + h * D;
  load_tile<D>(qb, stride, first, kBwdTile, N, sa);
  load_tile<D>(dout + orow, ostride, first, kBwdTile, N, sb);
  load_tile<D>(out + orow, ostride, first, kBwdTile, N, so);
  __syncthreads();
  float* o = q_img + (static_cast<size_t>(bh) * T + j) * (G::kDkvTileBytes / 4);
  write_image<D>(sa, kBwdTile, false, o, o + f);
  write_image<D>(sb, kBwdTile, false, o + 2 * f, o + 3 * f);
  write_image<D>(sa, kBwdTile, true, o + 4 * f, o + 5 * f);
  write_image<D>(sb, kBwdTile, true, o + 6 * f, o + 7 * f);
  if (threadIdx.x < kBwdTile) {
    const int r = threadIdx.x, n = first + r;
    float dsum = 0.f, l = INFINITY;  // a missing row: P = 2^-inf = 0
    if (n < N) {
      for (int d = 0; d < D; ++d) dsum = fmaf(sb[r * (D + 1) + d], so[r * (D + 1) + d], dsum);
      l = lse[static_cast<size_t>(bh) * lse_stride + n];
      dvec[static_cast<size_t>(bh) * T * kBwdTile + n] = dsum;
    }
    o[8 * f + r] = l;
    o[8 * f + kBwdTile + r] = dsum;
  }
}

__global__ void __launch_bounds__(kPrepThreads) flash_attention_bwd_prep(
    const float* __restrict__ qkv, const float* __restrict__ out, const float* __restrict__ lse,
    const float* __restrict__ dout, float* __restrict__ kv_img, float* __restrict__ q_img,
    float* __restrict__ dvec, int N, int H, int T, int lse_stride) {
  bwd_prep_body<64>(qkv, out, lse, dout, kv_img, q_img, dvec, N, H, T, lse_stride);
}

__global__ void __launch_bounds__(kPrepThreads) flash_attention_bwd_prep32(
    const float* __restrict__ qkv, const float* __restrict__ out, const float* __restrict__ lse,
    const float* __restrict__ dout, float* __restrict__ kv_img, float* __restrict__ q_img,
    float* __restrict__ dvec, int N, int H, int T, int lse_stride) {
  bwd_prep_body<32>(qkv, out, lse, dout, kv_img, q_img, dvec, N, H, T, lse_stride);
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
// rows and a producer warpgroup. kMode: rb's bias (and mask) added to the
// scores, or none.
template <int D, int kMode>
__device__ __forceinline__ void fwd_body(const float* __restrict__ qkv,
                                         const uint8_t* __restrict__ img,
                                         float* __restrict__ out, float* __restrict__ lse, int N,
                                         int H, int T, int lse_stride, const RelBias& rb) {
  using G = Geo<D>;
  using M = Traits<kMode>;
  constexpr int KS = D / 8;  // k steps of q k^T
  constexpr int NO = D / 2;  // registers of an output tile (64 x D)
  constexpr float kScale = M::scale2;
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
      produce(img + static_cast<size_t>(bh) * T * G::kFwdStageBytes, T, G::kFwdStageBytes,
              G::kFwdStageBytes, ring, G::kFwdStageBytes, kFwdStages, full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRowsPerCta + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int row1 = row0 + 8;
  const size_t stride = static_cast<size_t>(3) * H * D;
  const float* qb = qkv + static_cast<size_t>(b) * N * stride + h * D;
  uint32_t qh[KS][4], ql[KS][4];
  {
    float q[KS][4];
    row_frags<KS>(row0 < N ? qb + row0 * stride : nullptr,
                  row1 < N ? qb + row1 * stride : nullptr, t, q);
    split_frags(q, qh, ql);
  }
  // with a bias the scores are scaled to base 2 as they are biased
  constexpr float sm = M::bias ? 1.f : kScale;
  RelRow r0, r1;
  const float* tb = nullptr;
  const int* rg = nullptr;  // the window's region codes
  int g0 = 0, g1 = 0;       // the rows'
  if constexpr (M::bias) {
    r0 = rel_row<M::cls>(rb, row0);
    r1 = rel_row<M::cls>(rb, row1);
    tb = rb.table + static_cast<size_t>(h) * rb.R;
  }
  if constexpr (M::mask) {
    rg = region_row(rb, b);
    g0 = __ldg(rg + row0);
    g1 = __ldg(rg + row1);
  }
  float o[NO];
  zero(o);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < T; ++j) {
    const int s = j % kFwdStages;
    mbar_wait(&full[s], (j / kFwdStages) & 1);
    const uint8_t* st = ring + s * G::kFwdStageBytes;
    float sc[32];
    wg_fence();
    gemm3(sc, qh, ql, desc_sw128(st), desc_sw128(st + G::kImage64), kFwdTile * 8);
    wg_commit();
    wg_wait0();
    fence_frags(qh, ql);
    fence_regs(sc);
    if constexpr (M::bias) {
      const int* pj = rb.pos + j * kFwdTile + 2 * t;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cj = __ldg(pj + 8 * jj + e);
          float b0 = __ldg(tb + rel_index<M::cls>(r0, cj));
          float b1 = __ldg(tb + rel_index<M::cls>(r1, cj));
          if constexpr (M::mask) {
            const int gj = __ldg(rg + j * kFwdTile + 8 * jj + 2 * t + e);
            b0 += mask_term(g0, gj);
            b1 += mask_term(g1, gj);
          }
          sc[4 * jj + e] = fmaf(sc[4 * jj + e], kScale, b0 * kLog2e);
          sc[4 * jj + 2 + e] = fmaf(sc[4 * jj + 2 + e], kScale, b1 * kLog2e);
        }
    }
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
    const float n0 = fmaxf(m0, quad_max(x0) * sm), n1 = fmaxf(m1, quad_max(x1) * sm);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * jj + e] = exp2f(fmaf(sc[4 * jj + e], sm, -m0));
        sc[4 * jj + 2 + e] = exp2f(fmaf(sc[4 * jj + 2 + e], sm, -m1));
        l0 += sc[4 * jj + e];
        l1 += sc[4 * jj + 2 + e];
      }
    }
    uint32_t ph[8][4], pl[8][4];
    acc_frags<8>(sc, ph, pl);
    float pv[NO];
    wg_fence();
    gemm3(pv, ph, pl, desc_sw128(st + 2 * G::kImage64), desc_sw128(st + 3 * G::kImage64), D * 8);
    wg_commit();
    wg_wait0();
    fence_frags(ph, pl);
    fence_regs(pv);
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      o[4 * jj] = fmaf(o[4 * jj], a0, pv[4 * jj]);
      o[4 * jj + 1] = fmaf(o[4 * jj + 1], a0, pv[4 * jj + 1]);
      o[4 * jj + 2] = fmaf(o[4 * jj + 2], a1, pv[4 * jj + 2]);
      o[4 * jj + 3] = fmaf(o[4 * jj + 3], a1, pv[4 * jj + 3]);
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const size_t ostride = static_cast<size_t>(H) * D;
  float* ob = out + static_cast<size_t>(b) * N * ostride + h * D + 2 * t;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
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

__global__ void __launch_bounds__(kThreads, 1) flash_attention_fwd(
    const float* __restrict__ qkv, const uint8_t* __restrict__ img, float* __restrict__ out,
    float* __restrict__ lse, int N, int H, int T, int lse_stride) {
  fwd_body<64, kPlain>(qkv, img, out, lse, N, H, T, lse_stride, RelBias{});
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_fwd_bias(
    const float* __restrict__ qkv, const uint8_t* __restrict__ img, float* __restrict__ out,
    float* __restrict__ lse, int N, int H, int T, int lse_stride, RelBias rb) {
  fwd_body<64, kBias>(qkv, img, out, lse, N, H, T, lse_stride, rb);
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_fwd_window(
    const float* __restrict__ qkv, const uint8_t* __restrict__ img, float* __restrict__ out,
    float* __restrict__ lse, int N, int H, int T, int lse_stride, RelBias rb) {
  fwd_body<32, kWindow>(qkv, img, out, lse, N, H, T, lse_stride, rb);
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_fwd_window_mask(
    const float* __restrict__ qkv, const uint8_t* __restrict__ img, float* __restrict__ out,
    float* __restrict__ lse, int N, int H, int T, int lse_stride, RelBias rb) {
  fwd_body<32, kWindowMask>(qkv, img, out, lse, N, H, T, lse_stride, rb);
}

// dT (see the note). Each consumer warpgroup stages its dS tile (64 query
// rows x 32 keys) diagonal-major before the tile's last product (stage_dt)
// and, once that product is waited for, signals its walker, a warp of the
// producer warpgroup, which sums the stage's runs of one index, hands the
// stage back and adds the runs into the warpgroup's copy of the CTA's
// window of dT (walk_dt). Stage row u holds the diagonals u (keys 0 to 63
// - u) and u - 64 (the rest), so the walker lane that owns rows u and u +
// 32 owns whole diagonals. Along a diagonal the index stays while the row
// and the key step alike (both +1, or both across a grid row) and moves by
// +-(Ww - 1) where only one crosses; the class token's row and column keep
// that rule through the offset -1 that pos gives them (their elements are
// staged as 0 and go to the copy's first three entries with shared-memory
// atomics, in the first key tile and the first CTA's first warp only),
// and padded rows and keys stage 0.
__device__ __forceinline__ void stage_dt(float* st, float* cls, const float (&sc)[16], int g,
                                         int t, int wrow, bool cls_row, bool cls_col) {
  if (cls_row || cls_col) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = wrow + g + 8 * a, c = 8 * jj + 2 * t + e;
          float v = sc[4 * jj + 2 * a + e];
          const bool row = cls_row && a == 0, col = cls_col && c == 0;
          if (row || col) {
            atomicAdd(cls + (row ? (col ? 2 : 0) : 1), v);
            v = 0.f;
          }
          st[((r - c) & 63) * kSkewPitch + c] = v;
        }
    return;
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = wrow + g + 8 * a, c = 8 * jj + 2 * t + e;
        st[((r - c) & 63) * kSkewPitch + c] = sc[4 * jj + 2 * a + e];
      }
}

// A walker lane's two stage rows, in key order, side by side (their loads
// in flight together: beside the tensor cores' operand reads a shared-
// memory round trip takes hundreds of cycles): the sum of each run of one
// index, in rank order, to `ra` / `rb` (stride 32: the warp's lanes side by
// side). brk bit c: a run ends at key c. Returns the runs, popc(brk).
__device__ __forceinline__ int2 sum_runs(const float* __restrict__ a, const float* __restrict__ b,
                                         float* __restrict__ ra, float* __restrict__ rb,
                                         uint32_t brka, uint32_t brkb) {
  float acca = 0.f, accb = 0.f;
  int ma = 0, mb = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float xa[4] = {a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]};
    const float xb[4] = {b[4 * q], b[4 * q + 1], b[4 * q + 2], b[4 * q + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acca += xa[e];
      accb += xb[e];
      if ((brka >> (4 * q + e)) & 1u) {
        ra[32 * ma++] = acca;
        acca = 0.f;
      }
      if ((brkb >> (4 * q + e)) & 1u) {
        rb[32 * mb++] = accb;
        accb = 0.f;
      }
    }
  }
  return make_int2(ma, mb);
}

// A stage row's runs in turn: run m's index from run m - 1's. rb / cw bit
// c: the row / key of the row's element c crosses a grid row at the next
// element; at key sc the row's second diagonal starts, at index idx1.
struct RunIndex {
  uint32_t brk, rb, cw;
  int sc, idx, idx1;

  // the index of the current run; moves to the next
  __device__ __forceinline__ int next(int step) {
    const int i = idx;
    const int e = __ffs(brk) - 1;
    brk &= brk - 1;
    idx = e == sc ? idx1
                  : idx + step * (static_cast<int>((rb >> e) & 1u) -
                                  static_cast<int>((cw >> e) & 1u));
    return i;
  }
};

// The entry, counted from 1 at index lo, of the window that run sum v of
// index i adds into; 0 where it adds nothing (a zero sum: padded rows and
// keys stage 0 and may take any index).
__device__ __forceinline__ int run_slot(float v, int i, int lo, int len) {
  return v != 0.f && static_cast<unsigned>(i - lo) < static_cast<unsigned>(len) ? i - lo + 1 : 0;
}

// The walker of consumer warpgroup w: for each key tile, once the
// warpgroup has staged it, lane l sums the runs of stage rows l and l + 32
// (whole diagonals, see the note) into `runs` (its column of two 32 x 32
// blocks) and hands the stage back; then the warp's lanes add their runs
// into the warpgroup's copy of the window (dt: the entry of index lo), two
// runs of each row a pass: neighbouring runs of a row differ in index, and
// the two rows' diagonals differ, so a pass's four entries do.
__device__ __forceinline__ void walk_dt(const float* stg, float* runs, float* dt, uint64_t* full,
                                        uint64_t* empty, int T, int w, int lane, int lo, int len,
                                        const RelBias& rb) {
  const int* pr = rb.pos + blockIdx.x * kRowsPerCta + 64 * w + lane;
  const int pa = __ldg(pr), pb = __ldg(pr + 32);
  // bit r: row r + 1 of the warpgroup's 64 crosses a grid row
  const uint32_t wa = __ballot_sync(~0u, __ldg(pr + 1) - pa != 1);
  const uint32_t wb = __ballot_sync(~0u, __ldg(pr + 33) - pb != 1);
  // bit c: the row of stage row u's element c, (u + c) mod 64, crosses
  const uint32_t rba = __funnelshift_r(wa, wb, lane), rbb = __funnelshift_r(wb, wa, lane);
  const int rka = rb.K0 + pa, rkb = rb.K0 + pb, rk0 = __shfl_sync(~0u, rka, 0);
  const int sc = 31 - lane;  // row l + 32's second diagonal starts at key 32 - l
  const int step = rb.ww - 1;
  float* ra = runs + lane;
  float* rbuf = runs + 32 * 32 + lane;
  float* d = dt - 1;  // run_slot's 1-based entries
  for (int j = 0; j < T; ++j) {
    const int s = j & 1;
    const int pc = __ldg(rb.pos + j * kBwdTile + lane);
    const uint32_t cw = __ballot_sync(~0u, __ldg(rb.pos + j * kBwdTile + lane + 1) - pc != 1);
    const int p0 = __shfl_sync(~0u, pc, 0), p1 = __shfl_sync(~0u, pc, (32 - lane) & 31);
    RunIndex a{(rba ^ cw) | 0x80000000u, rba, cw, 32, rka - p0, 0};
    RunIndex b{(rbb ^ cw) | (1u << sc) | 0x80000000u, rbb, cw, sc, rkb - p0, rk0 - p1};
    mbar_wait(&full[s], (j >> 1) & 1);
    const float* st = stg + s * kSkewStage;
    const int2 n = sum_runs(st + lane * kSkewPitch, st + (lane + 32) * kSkewPitch, ra, rbuf,
                            a.brk, b.brk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    const int passes = __reduce_max_sync(~0u, max(n.x, n.y));
    for (int m = 0; m < passes; m += 2) {
      int k[4];
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool row_a = r < 2;
        const int mm = m + (r & 1);
        const bool has = mm < (row_a ? n.x : n.y);
        v[r] = has ? (row_a ? ra : rbuf)[32 * mm] : 0.f;
        k[r] = has ? run_slot(v[r], row_a ? a.next(step) : b.next(step), lo, len) : 0;
      }
      float old[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) old[r] = k[r] ? d[k[r]] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (k[r]) d[k[r]] = old[r] + v[r];
    }
    __syncwarp();
  }
}

// The CTA's window of dT: the indices of its patch-token rows, from lo,
// len of them (0 without one). kCls: token 0 is the class token.
template <bool kCls>
__device__ __forceinline__ int2 cta_window(const RelBias& rb, int N) {
  const int first = max(blockIdx.x * kRowsPerCta, kCls ? 1 : 0);
  const int last = min(blockIdx.x * kRowsPerCta + kRowsPerCta - 1, N - 1);
  if (first > last) return make_int2(0, 0);
  const int lo = __ldg(rb.pos + first);
  return make_int2(lo, rb.K0 + __ldg(rb.pos + last) - lo + 1);
}

// Thread i of dt_sync's 320: zeroes its share of the two copies, or adds
// their sum into dT in device memory with float atomics.
__device__ __forceinline__ void dt_zero(float* copies, int copy, int i) {
  for (int k = i; k < 2 * copy; k += 128 * kConsumers + 64) copies[k] = 0.f;
}

template <bool kCls>
__device__ __forceinline__ void dt_flush(const float* copies, const RelBias& rb, int h, int N,
                                         int i) {
  float* out = rb.dtable + static_cast<size_t>(h) * rb.R;
  const int2 win = cta_window<kCls>(rb, N);
  const int lo = win.x, len = win.y;
  for (int k = i + (kCls ? 0 : kDtClass); k < kDtClass + len; k += 128 * kConsumers + 64) {
    const float v = copies[k] + copies[rb.copy + k];
    if (v != 0.f) atomicAdd(out + (k < kDtClass ? rb.R - kDtClass + k : lo + k - kDtClass), v);
  }
}

// Backward, dq. Grid (ceil(N / 128), B H); 128 query rows a CTA (Q and dO
// raw in registers, dq accumulated there), key tiles of 32. With a bias
// (kMode): the scores biased, and dS added into the head's dT by two
// walker warps (see the note).
template <int D, int kMode>
__device__ __forceinline__ void dq_body(const float* __restrict__ qkv,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ dvec,
                                        const uint8_t* __restrict__ img,
                                        float* __restrict__ dqkv, int N, int H, int T,
                                        int lse_stride, const RelBias& rb) {
  using G = Geo<D>;
  using M = Traits<kMode>;
  constexpr bool kBias = M::bias;
  constexpr int KS = D / 8;
  constexpr int NO = D / 2;
  constexpr float kScale = M::scale2;
  constexpr int kStages = kBias ? kDqBiasStages : kDqStages;
  extern __shared__ uint8_t dyn[];
  uint8_t* ring = align_1k(dyn);
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_ring(full, empty, kStages);
  // with a bias, after the ring: each consumer warpgroup's two dS stages,
  // the walkers' run sums, then each warpgroup's copy of dT (the class
  // token's entries, then the CTA's window), and the stages' barriers
  uint64_t* dt_full = nullptr;
  uint64_t* dt_empty = nullptr;
  float* stg = nullptr;
  float* copies = nullptr;
  if constexpr (kBias) {
    __shared__ __align__(8) uint64_t dt_bars[4 * kConsumers];
    dt_full = dt_bars;
    dt_empty = dt_bars + 2 * kConsumers;
    if (threadIdx.x == 0) {
      for (int i = 0; i < 2 * kConsumers; ++i) {
        mbar_init(&dt_full[i], 4);  // the warpgroup's warps
        mbar_init(&dt_empty[i], 1);  // the walker
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    stg = reinterpret_cast<float*>(dyn + (ring - dyn) + kStages * G::kDqStageBytes);
    copies = stg + 2 * kConsumers * kSkewStage + kRunBytes / 4;
  }
  __syncthreads();
  if (warp >= 4 * kConsumers) {
    regs_dec<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0)
      produce(img + static_cast<size_t>(bh) * T * G::kDqStageBytes, T, G::kDqStageBytes,
              G::kDqStageBytes, ring, G::kDqStageBytes, kStages, full, empty);
    if constexpr (kBias) {
      const int w = warp - 4 * kConsumers - 1;
      if (w == 0 || w == 1) {
        const int i = 128 * kConsumers + 32 * w + lane;
        dt_zero(copies, rb.copy, i);
        dt_sync();
        const int2 win = cta_window<M::cls>(rb, N);
        walk_dt(stg + 2 * w * kSkewStage, stg + 2 * kConsumers * kSkewStage + w * 2 * 32 * 32,
                copies + w * rb.copy + kDtClass, dt_full + 2 * w, dt_empty + 2 * w, T, w, lane,
                win.x, win.y, rb);
        dt_sync();
        dt_flush<M::cls>(copies, rb, h, N, i);
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  if constexpr (kBias) {
    dt_zero(copies, rb.copy, threadIdx.x);
    dt_sync();
  }
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRowsPerCta + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int row1 = row0 + 8;
  const size_t stride = static_cast<size_t>(3) * H * D, ostride = static_cast<size_t>(H) * D;
  const float* qb = qkv + static_cast<size_t>(b) * N * stride + h * D;
  const float* db = dout + static_cast<size_t>(b) * N * ostride + h * D;
  float q[KS][4], d[KS][4];
  row_frags<KS>(row0 < N ? qb + row0 * stride : nullptr, row1 < N ? qb + row1 * stride : nullptr,
                t, q);
  row_frags<KS>(row0 < N ? db + row0 * ostride : nullptr,
                row1 < N ? db + row1 * ostride : nullptr, t, d);
  const float* lb = lse + static_cast<size_t>(bh) * lse_stride;
  const float* vb = dvec + static_cast<size_t>(bh) * T * kBwdTile;
  const float L0 = row0 < N ? lb[row0] : 0.f, L1 = row1 < N ? lb[row1] : 0.f;
  const float D0 = row0 < N ? vb[row0] : 0.f, D1 = row1 < N ? vb[row1] : 0.f;
  int ci0 = 0, ci1 = 0;  // the rows' offsets c_i
  const float* tb = nullptr;
  const int* rg = nullptr;  // the window's region codes
  int g0 = 0, g1 = 0;       // the rows'
  if constexpr (kBias) {
    ci0 = __ldg(rb.pos + row0);
    ci1 = __ldg(rb.pos + row1);
    tb = rb.table + static_cast<size_t>(h) * rb.R;
  }
  if constexpr (M::mask) {
    rg = region_row(rb, b);
    g0 = __ldg(rg + row0);
    g1 = __ldg(rg + row1);
  }
  float dq[NO];
  zero(dq);
  for (int j = 0; j < T; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint8_t* st = ring + s * G::kDqStageBytes;
    float sc[16], dp[16];
    {
      uint32_t hi[KS][4], lo[KS][4];
      split_frags(q, hi, lo);
      wg_fence();
      gemm3(sc, hi, lo, desc_sw128(st), desc_sw128(st + G::kImage32), kBwdTile * 8);
      wg_commit();
      wg_wait0();
      fence_frags(hi, lo);
    }
    {
      uint32_t hi[KS][4], lo[KS][4];
      split_frags(d, hi, lo);
      wg_fence();
      gemm3(dp, hi, lo, desc_sw128(st + 2 * G::kImage32), desc_sw128(st + 3 * G::kImage32),
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
        const int col = j * kBwdTile + 8 * jj + 2 * t + e;
        const bool ok = col < N;
        if constexpr (kBias) {
          const int cj = __ldg(rb.pos + col);
          float b0 = __ldg(tb + rel_index<M::cls>(rb, ci0, cj));
          float b1 = __ldg(tb + rel_index<M::cls>(rb, ci1, cj));
          if constexpr (M::mask) {
            const int gj = __ldg(rg + col);
            b0 += mask_term(g0, gj);
            b1 += mask_term(g1, gj);
          }
          const float p0 = ok ? exp2f(fmaf(sc[4 * jj + e], kScale, fmaf(b0, kLog2e, -L0))) : 0.f;
          const float p1 =
              ok ? exp2f(fmaf(sc[4 * jj + 2 + e], kScale, fmaf(b1, kLog2e, -L1))) : 0.f;
          sc[4 * jj + e] = p0 * (dp[4 * jj + e] - D0);
          sc[4 * jj + 2 + e] = p1 * (dp[4 * jj + 2 + e] - D1);
        } else {
          const float p0 = ok ? exp2f(fmaf(sc[4 * jj + e], kScale, -L0)) : 0.f;
          const float p1 = ok ? exp2f(fmaf(sc[4 * jj + 2 + e], kScale, -L1)) : 0.f;
          sc[4 * jj + e] = p0 * (dp[4 * jj + e] - D0);
          sc[4 * jj + 2 + e] = p1 * (dp[4 * jj + 2 + e] - D1);
        }
      }
    const int sb = 2 * wg + (j & 1);  // with a bias, the tile's dS stage
    if constexpr (kBias) {
      if (j >= 2) mbar_wait(&dt_empty[sb], ((j >> 1) - 1) & 1);
      stage_dt(stg + sb * kSkewStage, copies + wg * rb.copy, sc, g, t, (warp & 3) * 16,
               M::cls && row0 == 0, M::cls && j == 0);
    }
    uint32_t hi[4][4], lo[4][4];
    acc_frags<4>(sc, hi, lo);
    float tile[NO];
    wg_fence();
    gemm3(tile, hi, lo, desc_sw128(st + 4 * G::kImage32), desc_sw128(st + 5 * G::kImage32),
          D * 8);
    wg_commit();
    wg_wait0();
    fence_frags(hi, lo);
    fence_regs(tile);
    if (lane == 0) mbar_arrive(&empty[s]);
    if constexpr (kBias) {
      // to the walker once the stores are long done (the arrive releases them)
      __syncwarp();
      if (lane == 0) mbar_arrive(&dt_full[sb]);
    }
    add(dq, tile);
  }
  float* gb = dqkv + static_cast<size_t>(b) * N * stride + h * D + 2 * t;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    if (row0 < N)
      *reinterpret_cast<float2*>(gb + row0 * stride + 8 * jj) =
          make_float2(dq[4 * jj] * M::grad, dq[4 * jj + 1] * M::grad);
    if (row1 < N)
      *reinterpret_cast<float2*>(gb + row1 * stride + 8 * jj) =
          make_float2(dq[4 * jj + 2] * M::grad, dq[4 * jj + 3] * M::grad);
  }
  if constexpr (kBias) {
    dt_sync();
    dt_flush<M::cls>(copies, rb, h, N, threadIdx.x);
  }
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dq(
    const float* __restrict__ qkv, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, const uint8_t* __restrict__ img, float* __restrict__ dqkv,
    int N, int H, int T, int lse_stride) {
  dq_body<64, kPlain>(qkv, dout, lse, dvec, img, dqkv, N, H, T, lse_stride, RelBias{});
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dq_bias(
    const float* __restrict__ qkv, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, const uint8_t* __restrict__ img, float* __restrict__ dqkv,
    int N, int H, int T, int lse_stride, RelBias rb) {
  dq_body<64, kBias>(qkv, dout, lse, dvec, img, dqkv, N, H, T, lse_stride, rb);
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dq_window(
    const float* __restrict__ qkv, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, const uint8_t* __restrict__ img, float* __restrict__ dqkv,
    int N, int H, int T, int lse_stride, RelBias rb) {
  dq_body<32, kWindow>(qkv, dout, lse, dvec, img, dqkv, N, H, T, lse_stride, rb);
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dq_window_mask(
    const float* __restrict__ qkv, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, const uint8_t* __restrict__ img, float* __restrict__ dqkv,
    int N, int H, int T, int lse_stride, RelBias rb) {
  dq_body<32, kWindowMask>(qkv, dout, lse, dvec, img, dqkv, N, H, T, lse_stride, rb);
}

// Backward, dk and dv. Grid (ceil(N / 128), B H); 128 key rows a CTA (raw K
// and V in shared memory, dK and dV in registers), query tiles of 32.
// With a bias (kMode): the scores biased.
template <int D, int kMode>
__device__ __forceinline__ void dkdv_body(const float* __restrict__ qkv,
                                          const uint8_t* __restrict__ img,
                                          float* __restrict__ dqkv, int N, int H, int T,
                                          const RelBias& rb) {
  using G = Geo<D>;
  using M = Traits<kMode>;
  constexpr int KS = D / 8;
  constexpr int NO = D / 2;
  constexpr int P = G::kRawPitch;
  constexpr float kScale = M::scale2;
  extern __shared__ uint8_t dyn[];
  uint8_t* base = align_1k(dyn);
  float* raw = reinterpret_cast<float*>(base);  // K rows, then V rows, pitch kRawPitch
  uint8_t* ring = base + G::kDkvRawBytes;
  __shared__ __align__(8) uint64_t full[kDkvStages], empty[kDkvStages];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kRowsPerCta;
  const size_t stride = static_cast<size_t>(3) * H * D;
  const float* kb = qkv + static_cast<size_t>(b) * N * stride + (H + h) * D;
  init_ring(full, empty, kDkvStages);
  for (int i = threadIdx.x; i < 2 * kRowsPerCta * D / 4; i += blockDim.x) {
    const int which = i / (kRowsPerCta * D / 4), rem = i % (kRowsPerCta * D / 4);
    const int r = rem / (D / 4), c = (rem % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < N)
      v = __ldg(reinterpret_cast<const float4*>(kb + which * H * D + (first + r) * stride + c));
    *reinterpret_cast<float4*>(raw + (which * kRowsPerCta + r) * P + c) = v;
  }
  __syncthreads();
  if (warp >= 4 * kConsumers) {
    regs_dec<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0)
      produce(img + static_cast<size_t>(bh) * T * G::kDkvTileBytes, T, G::kDkvTileBytes,
              G::kDkvTileBytes, ring, G::kDkvStageBytes, kDkvStages, full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // local rows lr0, lr0 + 8
  const float* rk0 = raw + lr0 * P;
  const float* rv0 = raw + (kRowsPerCta + lr0) * P;
  int c0 = 0, c1 = 0;  // the key rows' grid offsets
  const float* tb = nullptr;
  const int* rg = nullptr;  // the window's region codes
  int g0 = 0, g1 = 0;       // the key rows'
  if constexpr (M::bias) {
    c0 = __ldg(rb.pos + first + lr0);
    c1 = __ldg(rb.pos + first + lr0 + 8);
    tb = rb.table + static_cast<size_t>(h) * rb.R;
  }
  if constexpr (M::mask) {
    rg = region_row(rb, b);
    g0 = __ldg(rg + first + lr0);
    g1 = __ldg(rg + first + lr0 + 8);
  }
  float dk[NO], dv[NO];
  zero(dk);
  zero(dv);
  for (int j = 0; j < T; ++j) {
    const int s = j % kDkvStages;
    // the tile's bias, gathered before the products it does not depend on
    float bias[16];
    if constexpr (M::bias) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = j * kBwdTile + 8 * jj + 2 * t + e;
          const RelRow q = rel_row<M::cls>(rb, qi);
          bias[4 * jj + e] = __ldg(tb + rel_index<M::cls>(q, c0));
          bias[4 * jj + 2 + e] = __ldg(tb + rel_index<M::cls>(q, c1));
          if constexpr (M::mask) {
            const int gq = __ldg(rg + qi);
            bias[4 * jj + e] += mask_term(gq, g0);
            bias[4 * jj + 2 + e] += mask_term(gq, g1);
          }
        }
    }
    mbar_wait(&full[s], (j / kDkvStages) & 1);
    const uint8_t* st = ring + s * G::kDkvStageBytes;
    float sc[16], dp[16];
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* r0 = which ? rv0 : rk0;
      float a[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        a[ks][0] = r0[8 * ks + t];
        a[ks][1] = r0[8 * P + 8 * ks + t];
        a[ks][2] = r0[8 * ks + t + 4];
        a[ks][3] = r0[8 * P + 8 * ks + t + 4];
      }
      uint32_t hi[KS][4], lo[KS][4];
      split_frags(a, hi, lo);
      wg_fence();
      if (which == 0)
        gemm3(sc, hi, lo, desc_sw128(st), desc_sw128(st + G::kImage32), kBwdTile * 8);
      else
        gemm3(dp, hi, lo, desc_sw128(st + 2 * G::kImage32), desc_sw128(st + 3 * G::kImage32),
              kBwdTile * 8);
      wg_commit();
      wg_wait0();
      fence_frags(hi, lo);
    }
    fence_regs(sc);
    fence_regs(dp);
    const float* ls = reinterpret_cast<const float*>(st + G::kDkvImageBytes);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + 2 * t + e;
        const float L = ls[c], Dc = ls[kBwdTile + c];
        float p0, p1;
        if constexpr (M::bias) {
          p0 = exp2f(fmaf(sc[4 * jj + e], kScale, fmaf(bias[4 * jj + e], kLog2e, -L)));
          p1 = exp2f(fmaf(sc[4 * jj + 2 + e], kScale, fmaf(bias[4 * jj + 2 + e], kLog2e, -L)));
        } else {
          p0 = exp2f(fmaf(sc[4 * jj + e], kScale, -L));
          p1 = exp2f(fmaf(sc[4 * jj + 2 + e], kScale, -L));
        }
        sc[4 * jj + e] = p0;
        sc[4 * jj + 2 + e] = p1;
        dp[4 * jj + e] = p0 * (dp[4 * jj + e] - Dc);
        dp[4 * jj + 2 + e] = p1 * (dp[4 * jj + 2 + e] - Dc);
      }
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
    acc_frags<4>(sc, ph, pl);
    acc_frags<4>(dp, sh, sl);
    float tv[NO], tk[NO];
    wg_fence();
    gemm3(tv, ph, pl, desc_sw128(st + 6 * G::kImage32), desc_sw128(st + 7 * G::kImage32), D * 8);
    gemm3(tk, sh, sl, desc_sw128(st + 4 * G::kImage32), desc_sw128(st + 5 * G::kImage32), D * 8);
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
  float* gk = dqkv + static_cast<size_t>(b) * N * stride + (H + h) * D + 2 * t;
  float* gv = gk + H * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    if (row0 < N) {
      *reinterpret_cast<float2*>(gk + row0 * stride + 8 * jj) =
          make_float2(dk[4 * jj] * M::grad, dk[4 * jj + 1] * M::grad);
      *reinterpret_cast<float2*>(gv + row0 * stride + 8 * jj) =
          make_float2(dv[4 * jj], dv[4 * jj + 1]);
    }
    if (row1 < N) {
      *reinterpret_cast<float2*>(gk + row1 * stride + 8 * jj) =
          make_float2(dk[4 * jj + 2] * M::grad, dk[4 * jj + 3] * M::grad);
      *reinterpret_cast<float2*>(gv + row1 * stride + 8 * jj) =
          make_float2(dv[4 * jj + 2], dv[4 * jj + 3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dkdv(
    const float* __restrict__ qkv, const uint8_t* __restrict__ img, float* __restrict__ dqkv,
    int N, int H, int T) {
  dkdv_body<64, kPlain>(qkv, img, dqkv, N, H, T, RelBias{});
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dkdv_bias(
    const float* __restrict__ qkv, const uint8_t* __restrict__ img, float* __restrict__ dqkv,
    int N, int H, int T, RelBias rb) {
  dkdv_body<64, kBias>(qkv, img, dqkv, N, H, T, rb);
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dkdv_window(
    const float* __restrict__ qkv, const uint8_t* __restrict__ img, float* __restrict__ dqkv,
    int N, int H, int T, RelBias rb) {
  dkdv_body<32, kWindow>(qkv, img, dqkv, N, H, T, rb);
}

__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dkdv_window_mask(
    const float* __restrict__ qkv, const uint8_t* __restrict__ img, float* __restrict__ dqkv,
    int N, int H, int T, RelBias rb) {
  dkdv_body<32, kWindowMask>(qkv, img, dqkv, N, H, T, rb);
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

// The main kernels of a (width, mode), and their shared memory: the dq
// pass's with a bias is the largest a launch may ask (its copies of dT
// vary with the grid).
template <int D, int kMode>
struct Kernels;

template <>
struct Kernels<64, kPlain> {
  static constexpr auto fwd = flash_attention_fwd;
  static constexpr auto dkdv = flash_attention_bwd_dkdv;
  static constexpr auto dq = flash_attention_bwd_dq;
};
template <>
struct Kernels<64, kBias> {
  static constexpr auto fwd = flash_attention_fwd_bias;
  static constexpr auto dkdv = flash_attention_bwd_dkdv_bias;
  static constexpr auto dq = flash_attention_bwd_dq_bias;
};
template <>
struct Kernels<32, kWindow> {
  static constexpr auto fwd = flash_attention_fwd_window;
  static constexpr auto dkdv = flash_attention_bwd_dkdv_window;
  static constexpr auto dq = flash_attention_bwd_dq_window;
};
template <>
struct Kernels<32, kWindowMask> {
  static constexpr auto fwd = flash_attention_fwd_window_mask;
  static constexpr auto dkdv = flash_attention_bwd_dkdv_window_mask;
  static constexpr auto dq = flash_attention_bwd_dq_window_mask;
};

template <int D, int kMode>
int set_smem() {
  using K = Kernels<D, kMode>;
  static int err = -1;
  if (err < 0) {
    err = static_cast<int>(cudaFuncSetAttribute(
        K::fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::kFwdSmem));
    if (!err)
      err = static_cast<int>(
          cudaFuncSetAttribute(K::dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Traits<kMode>::bias ? kDqBiasSmemMax : Geo<D>::kDqSmem));
    if (!err)
      err = static_cast<int>(cudaFuncSetAttribute(
          K::dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::kDkvSmem));
  }
  return err;
}

template <int D>
int dq_bias_smem(int copy) {
  return Geo<D>::kDqBiasRingSmem + kDtStageBytes + kRunBytes + 8 * copy;
}

// The floats a copy of dT takes in the dq pass on a wh x ww grid of N = cls
// + wh ww tokens (cls: a class token first): the class token's three
// entries and the largest window of a CTA's rows, rounded up to 4. The
// window of rows first..last (its patch tokens) runs from c_first to K0 +
// c_last, c_n = y (2 Ww - 1) + x of patch n at (y, x); at most K0 + 127 +
// dy (Ww - 1) + 1 entries, dy <= Wh - 1 the grid rows the block spans past
// its first: 3/4 (R - 3) + 128.
int dq_bias_copy(int N, int wh, int ww, int cls) {
  const auto c = [ww, cls](int n) { return (n - cls) / ww * (2 * ww - 1) + (n - cls) % ww; };
  const int k0 = (wh - 1) * (2 * ww - 1) + ww - 1;
  int len = 0;
  for (int first = 0; first < N; first += kRowsPerCta) {
    const int f = first > cls ? first : cls, l = first + kRowsPerCta - 1 < N ? first + kRowsPerCta - 1 : N - 1;
    if (f <= l && k0 + c(l) - c(f) + 1 > len) len = k0 + c(l) - c(f) + 1;
  }
  return (kDtClass + len + 3) & ~3;
}

}  // namespace

// Bytes of scratch a call needs at head width D (backward != 0: the
// backward's), and the length of a (frame, head)'s log-sum-exp row.
extern "C" long long vit_attention_scratch_bytes_width(int B, int N, int H, int D,
                                                       int backward) {
  const long long bh = static_cast<long long>(B) * H;
  const bool w64 = D == 64;
  if (!backward) return bh * tiles(N, kFwdTile) * (w64 ? Geo<64>::kFwdStageBytes : Geo<32>::kFwdStageBytes);
  const long long t = tiles(N, kBwdTile);
  return bh * t *
         (w64 ? Geo<64>::kDqStageBytes + Geo<64>::kDkvTileBytes
              : Geo<32>::kDqStageBytes + Geo<32>::kDkvTileBytes) +
         bh * t * kBwdTile * 4;
}

extern "C" int vit_attention_lse_stride(int N) { return tiles(N, kFwdTile) * kFwdTile; }

// The largest table (entries a head) the bias kernels take at head width
// 64, and the length pos (and each window's region codes) must have for N
// tokens.
extern "C" int vit_attention_max_table() { return kMaxTable; }

// The floats of each of the dq pass's two copies of dT on a wh x ww grid
// with a class token (cls 1) or without (0).
extern "C" int vit_attention_dq_bias_copy_cls(int wh, int ww, int cls) {
  return dq_bias_copy(cls + wh * ww, wh, ww, cls);
}

extern "C" int vit_attention_pos_length(int N) { return tiles(N, kPosTile) * kPosTile + 32; }

namespace {

template <int D, int kMode>
int forward_t(const float* qkv, float* out, float* lse, void* scratch, int B, int N, int H,
              const RelBias& rb, cudaStream_t stream) {
  using K = Kernels<D, kMode>;
  if (int err = set_smem<D, kMode>()) return err;
  const int t = tiles(N, kFwdTile), bh = B * H;
  float* img = static_cast<float*>(scratch);
  const auto prep = D == 64 ? flash_attention_fwd_prep : flash_attention_fwd_prep32;
  prep<<<dim3(t, bh), kPrepThreads, 0, stream>>>(qkv, img, N, H, t);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  const dim3 grid(tiles(N, kRowsPerCta), bh);
  const uint8_t* im = reinterpret_cast<const uint8_t*>(img);
  if constexpr (Traits<kMode>::bias)
    K::fwd<<<grid, kThreads, Geo<D>::kFwdSmem, stream>>>(qkv, im, out, lse, N, H, t, t * kFwdTile,
                                                          rb);
  else
    K::fwd<<<grid, kThreads, Geo<D>::kFwdSmem, stream>>>(qkv, im, out, lse, N, H, t, t * kFwdTile);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kMode>
int backward_t(const float* qkv, const float* out, const float* lse, const float* dout,
               float* dqkv, void* scratch, int B, int N, int H, const RelBias& rb,
               cudaStream_t stream) {
  using K = Kernels<D, kMode>;
  using G = Geo<D>;
  if (int err = set_smem<D, kMode>()) return err;
  const int t = tiles(N, kBwdTile), bh = B * H;
  uint8_t* kv_img = static_cast<uint8_t*>(scratch);
  uint8_t* q_img = kv_img + static_cast<size_t>(bh) * t * G::kDqStageBytes;
  float* dvec = reinterpret_cast<float*>(q_img + static_cast<size_t>(bh) * t * G::kDkvTileBytes);
  const int lse_stride = tiles(N, kFwdTile) * kFwdTile;
  const auto prep = D == 64 ? flash_attention_bwd_prep : flash_attention_bwd_prep32;
  prep<<<dim3(t, bh, 2), kPrepThreads, 0, stream>>>(
      qkv, out, lse, dout, reinterpret_cast<float*>(kv_img), reinterpret_cast<float*>(q_img), dvec,
      N, H, t, lse_stride);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  const dim3 grid(tiles(N, kRowsPerCta), bh);
  if constexpr (Traits<kMode>::bias)
    K::dkdv<<<grid, kThreads, G::kDkvSmem, stream>>>(qkv, q_img, dqkv, N, H, t, rb);
  else
    K::dkdv<<<grid, kThreads, G::kDkvSmem, stream>>>(qkv, q_img, dqkv, N, H, t);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  if constexpr (Traits<kMode>::bias)
    K::dq<<<grid, kThreads, dq_bias_smem<D>(rb.copy), stream>>>(qkv, dout, lse, dvec, kv_img,
                                                                dqkv, N, H, t, lse_stride, rb);
  else
    K::dq<<<grid, kThreads, G::kDqSmem, stream>>>(qkv, dout, lse, dvec, kv_img, dqkv, N, H, t,
                                                  lse_stride);
  return static_cast<int>(cudaGetLastError());
}

// The bias of a wh x ww grid of N = cls + wh ww tokens at head width D,
// with the shift mask's region codes or none; an invalid R where the
// kernels do not take it: a class token at 64 (BEiT), none at 32 (the
// windows).
RelBias grid_bias(const float* table, const int* pos, const int* region, float* dtable, int N,
                  int D, int wh, int ww, int cls, int nW) {
  const int R = (2 * wh - 1) * (2 * ww - 1) + 3 * cls;
  const bool form = D == 64 ? cls == 1 && region == nullptr : D == 32 && cls == 0;
  const bool ok = form && wh >= 0 && ww >= 0 && N == cls + wh * ww && nW >= 1 &&
                  (D == 32 || R <= kMaxTable);
  const int copy = ok ? dq_bias_copy(N, wh, ww, cls) : 0;
  const int max_copy = D == 64 ? kMaxCopy<64> : kMaxCopy<32>;
  return {table, pos, dtable, ok && copy <= max_copy ? R : -1, (wh - 1) * (2 * ww - 1) + ww - 1,
          ww, copy, region, nW, tiles(N, kPosTile) * kPosTile + 32};
}

}  // namespace

extern "C" int vit_attention_forward(const float* qkv, float* out, float* lse, void* scratch,
                                     int B, int N, int H, cudaStream_t stream) {
  return forward_t<64, kPlain>(qkv, out, lse, scratch, B, N, H, RelBias{}, stream);
}

extern "C" int vit_attention_backward(const float* qkv, const float* out, const float* lse,
                                      const float* dout, float* dqkv, void* scratch, int B,
                                      int N, int H, cudaStream_t stream) {
  return backward_t<64, kPlain>(qkv, out, lse, dout, dqkv, scratch, B, N, H, RelBias{}, stream);
}

// With the relative-position bias of a wh x ww grid at head width D: 64
// with a class token (cls 1, BEiT), or 32 without (cls 0: Swin V2's
// windows of wh x ww tokens, the frames B the windows of every image in
// order, scores at scale 1). table (H, R) float32 with R = (2 wh - 1)
// (2 ww - 1) + 3 cls (at most vit_attention_max_table() at 64), pos
// (vit_attention_pos_length(N) int32, see the note); the shift mask where
// region is not null: (nW, vit_attention_pos_length(N)) int32 region
// codes, window b taking row b mod nW. The backward adds the table's
// gradient into dtable (H, R), which the caller zeroes.
extern "C" int vit_attention_forward_biased(const float* qkv, const float* table, const int* pos,
                                            const int* region, float* out, float* lse,
                                            void* scratch, int B, int N, int H, int D, int wh,
                                            int ww, int cls, int nW, cudaStream_t stream) {
  const RelBias rb = grid_bias(table, pos, region, nullptr, N, D, wh, ww, cls, nW);
  if (rb.R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return forward_t<64, kBias>(qkv, out, lse, scratch, B, N, H, rb, stream);
  if (region) return forward_t<32, kWindowMask>(qkv, out, lse, scratch, B, N, H, rb, stream);
  return forward_t<32, kWindow>(qkv, out, lse, scratch, B, N, H, rb, stream);
}

extern "C" int vit_attention_backward_biased(const float* qkv, const float* table,
                                             const int* pos, const int* region, const float* out,
                                             const float* lse, const float* dout, float* dqkv,
                                             float* dtable, void* scratch, int B, int N, int H,
                                             int D, int wh, int ww, int cls, int nW,
                                             cudaStream_t stream) {
  const RelBias rb = grid_bias(table, pos, region, dtable, N, D, wh, ww, cls, nW);
  if (rb.R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return backward_t<64, kBias>(qkv, out, lse, dout, dqkv, scratch, B, N, H, rb, stream);
  if (region)
    return backward_t<32, kWindowMask>(qkv, out, lse, dout, dqkv, scratch, B, N, H, rb, stream);
  return backward_t<32, kWindow>(qkv, out, lse, dout, dqkv, scratch, B, N, H, rb, stream);
}

// Registers a thread, local (spill) bytes a thread and shared bytes a block
// (static plus dynamic) of kernel `which`: 0 fwd_prep, 1 fwd, 2 bwd_prep,
// 3 bwd_dkdv, 4 bwd_dq, 5 fwd_bias, 6 bwd_dkdv_bias, 7 bwd_dq_bias (its
// ring and the warpgroups' stages; a grid adds its two copies of dT, 8
// vit_attention_dq_bias_copy_cls bytes); at head width 32: 8 fwd_prep32,
// 9 bwd_prep32, 10 fwd_window, 11 bwd_dkdv_window, 12 bwd_dq_window,
// 13 fwd_window_mask, 14 bwd_dkdv_window_mask, 15 bwd_dq_window_mask.
extern "C" int vit_attention_kernel_info(int which, int* regs, int* local, int* smem) {
  const void* fns[] = {reinterpret_cast<const void*>(flash_attention_fwd_prep),
                       reinterpret_cast<const void*>(flash_attention_fwd),
                       reinterpret_cast<const void*>(flash_attention_bwd_prep),
                       reinterpret_cast<const void*>(flash_attention_bwd_dkdv),
                       reinterpret_cast<const void*>(flash_attention_bwd_dq),
                       reinterpret_cast<const void*>(flash_attention_fwd_bias),
                       reinterpret_cast<const void*>(flash_attention_bwd_dkdv_bias),
                       reinterpret_cast<const void*>(flash_attention_bwd_dq_bias),
                       reinterpret_cast<const void*>(flash_attention_fwd_prep32),
                       reinterpret_cast<const void*>(flash_attention_bwd_prep32),
                       reinterpret_cast<const void*>(flash_attention_fwd_window),
                       reinterpret_cast<const void*>(flash_attention_bwd_dkdv_window),
                       reinterpret_cast<const void*>(flash_attention_bwd_dq_window),
                       reinterpret_cast<const void*>(flash_attention_fwd_window_mask),
                       reinterpret_cast<const void*>(flash_attention_bwd_dkdv_window_mask),
                       reinterpret_cast<const void*>(flash_attention_bwd_dq_window_mask)};
  using G = Geo<64>;
  using W = Geo<32>;
  const int w_dq = W::kDqBiasRingSmem + kDtStageBytes + kRunBytes;
  const int dyn[] = {0, G::kFwdSmem, 0, G::kDkvSmem, G::kDqSmem, G::kFwdSmem, G::kDkvSmem,
                     G::kDqBiasRingSmem + kDtStageBytes + kRunBytes,
                     0, 0, W::kFwdSmem, W::kDkvSmem, w_dq, W::kFwdSmem, W::kDkvSmem, w_dq};
  if (which < 0 || which > 15) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  if (cudaError_t err = cudaFuncGetAttributes(&a, fns[which])) return static_cast<int>(err);
  *regs = a.numRegs;
  *local = static_cast<int>(a.localSizeBytes);
  *smem = static_cast<int>(a.sharedSizeBytes) + dyn[which];
  return 0;
}
