// Causal (optionally sliding-window) GQA flash attention for Hopper
// (sm_90a) in bf16 on the tensor cores: wgmma for both products, K and V
// streamed by TMA into a ring of shared-memory stages, one producer warp
// and two consumer warpgroups per block.
//
// Replaces the TPU kernel `_kernel` (:26) of
// src/repro/kernels/flash_attention.py, reached from `flash_attention`
// (:82, `pallas_call` at :100), for bf16 inputs at head dim 64, 80, 112
// or 128 (kernels/flash_attention.py:route says which inputs come here;
// float32, and bf16 at hd 16 and 32, go to csrc/flash_attention.cu). hd 80
// is stablelm-3b's, 112 kimi-k2's (after the model's repeat of its 8 KV
// heads to 64). For query head h
// of batch b (KV head h / n_rep) and every query row i:
//   s_ij = (q_i . k_j)                 wgmma, bf16 x bf16 products summed
//                                      in f32 (exact products, as the TPU
//                                      kernel's widened f32 logits)
//   x_ij = s_ij * (log2(e) / sqrt(hd)) in f32, after the product (q is not
//                                      pre-scaled in bf16)
//   x_ij = -1e30 where key j is masked (causal j > i; window j <= i - W),
//          set after the scaling so that it stays finite; -inf for keys
//          past the end of the sequence (a ragged last tile)
//   online softmax (m, l, acc) in f32 registers, the TPU kernel's, in
//   base 2: m' = max(m, max_j x), alpha = 2^(m - m'), p = 2^(x - m'),
//   l' = l alpha + sum p, acc' = acc alpha + p v
//   out_i = acc / max(l, 1e-30), rounded to bf16.
// What rounds where: p is rounded to bf16 for the p.v product (wgmma takes
// bf16 operands), where the TPU kernel keeps f32 p; l sums the unrounded p.
// The -1e30 mask keeps the TPU kernel's behaviour: a visited tile that is
// fully masked for a row adds 2^0 = 1 terms while that row's m is still
// -1e30, and the row's first real key wipes them (alpha = 0); -inf there
// would give NaN. Tiles above the causal diagonal or left of the window are
// skipped with the TPU kernel's tile predicate; only tiles that cross the
// diagonal, the window's edge or the sequence's end are masked.
//
// Bound. At the serve path's shape (one full-width qwen3-4b layer: B 4,
// S 512, 32 query heads and, after the model's repeat, 32 KV heads,
// hd 128, bf16, causal) the function reads q, k, v and writes out once,
// 67.1 MB, 0.020 ms at 3.35 TB/s; its 8.61 GFLOP of products (the causal
// half) take 0.0087 ms at the bf16 tensor-core rate (989 TFLOP/s): bytes
// bound it. With 128 x 128 tiles the kernel computes 10 of the 16 tile
// pairs of each (batch, head), 10.7 GFLOP. At the zoo's widths (B 4, S 512,
// causal): hd 80 with 32 heads (stablelm-3b) moves 41.9 MB, 0.0125 ms, and
// does 5.37 GFLOP, 0.0054 ms; hd 112 with 64 heads (kimi-k2) moves
// 117.4 MB, 0.0351 ms, and does 15.0 GFLOP, 0.0152 ms: bytes bound both.
//
// Design. Grid (query tiles of 128, H, B): 512 blocks at the path's shape,
// the heaviest query tiles first. 288 threads: warpgroups 0 and 1 each own
// 64 query rows; warp 8 is the producer, one of whose threads issues every
// TMA load. Shared memory, all 1024-byte aligned, 128-byte swizzled as TMA
// writes it and wgmma reads it, each tile as HDP/64 column halves of
// [rows][64] bf16, HDP = hd rounded up to a multiple of 64 (64 at hd 64,
// 128 at hd 80, 112 and 128): Q [128 x HDP] (32 KB at HDP 128), then 2
// stages of K and of V [128 x HDP] (64 KB per stage), and 5 mbarriers:
// 161 KB at HDP 128 (81 KB at 64), so one block per SM. q k^T is wgmma
// m64n128k16 with both operands in shared memory (K-major), hd/16 k-steps
// (5 at hd 80, 7 at 112); p v is wgmma m64n{hd}k16 with p in registers
// (the accumulator's fragment is the A operand's, so p needs no shuffle;
// it is packed to bf16 as the softmax makes it) and V read transposed
// (MN-major) from the same tile, so V needs no transposed copy: n64 or
// n128 at hd 64 and 128, and at hd 80 and 112 n64 on the first column
// half and n16 or n48 on the second. The two warpgroups take turns at
// issuing q k^T (named barriers), so that one's softmax overlaps the
// other's products. Masks are taken without branches and only on the
// tiles that cross the diagonal, the window's edge or the sequence's end.
// Registers: 166 per thread, no spills at hd 128, under the cap of 168 for
// 288 threads at one block per SM (the register file is shared out by SM
// quarter, and one quarter holds three of the nine warps); a consumer
// thread holds 64 f32 logits, hd/2 f32 outputs (40 at hd 80, 56 at 112)
// and 32 packed p registers. Full and empty mbarriers per stage carry the
// ring; the producer waits for both consumer warpgroups to release a stage
// (8 warp arrivals) before it refills it. The output is staged through the
// warpgroup's own rows of the Q tile (the same swizzle, no bank conflicts)
// and written with 16-byte stores, hd/8 a row, rows past the sequence's
// end skipped.
// What bounds it now is its own arithmetic, not its loads (a copy without
// its loads ran as long; one without its math, well under half as long):
// each warpgroup still waits for its q k^T before its softmax and for its
// p v before the next tile. Three changes that went past the register cap
// spilled and ran slower, so they are not kept: two query tiles per block,
// a third K/V stage, and issuing one tile's p v with the next tile's q k^T
// (a second logit accumulator; setmaxnreg with a producer warpgroup did
// not lift nvcc's allocation of 168).
//
// The padded tile (hd 80, 112). A 160- or 224-byte row does not fit one
// 128-byte swizzle row, so a row is kept as two 64-column halves, each
// loaded by its own TMA box of 64 columns, as at hd 128. The tensor maps
// keep the real hd as their inner dimension, so the second box runs past
// it: TMA fills columns hd..127 with zeros and reads none of them from
// memory (the next head's columns in the model layout stay unread). TMA
// reports the whole box to the mbarrier, zero-filled columns included (as
// it does for rows past the sequence's end), so each stage expects the
// padded tile's bytes, 2 x 128 x HDP x 2. The zero columns are never read
// by a product: q k^T stops at hd and p v's second half is hd - 64 wide.
// Shared memory is hd 128's 161 KB, one block per SM as there.
//
// Layouts. Tensor maps are built per launch over the caller's strides
// (batch, sequence, head; the head dim contiguous), so the model layout
// [B, S, H, hd] and the head-major [B, H, S, hd] take the same kernel
// without a copy; the map orders sequence and head by stride. TMA needs a
// 16-byte aligned base and strides that are multiples of 16 bytes: the
// wrapper checks both and raises. TMA fills rows past the sequence's end
// with zeros. cuTensorMapEncodeTiled lives in libcuda: it is looked up once
// through the CUDA runtime's entry-point query, so the library links no
// -lcuda.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                 // query rows per block
constexpr int kBK = 128;                 // keys per tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct TcArgs {
  __nv_bfloat16* o;
  long long os[3];                       // out strides: batch, seq, head
  int heads, kv_heads, seq, causal, window;
  int seq_inner[3];                      // q, k, v maps: seq before head
};

// the shared tiles' width: hd rounded up to whole 64-column halves
__host__ __device__ constexpr int padded(int hd) {
  return 64 * ((hd + 63) / 64);
}

template <int HD>
constexpr int smem_bytes() {
  return 1024 + kBQ * padded(HD) * 2 + 2 * kStages * kBK * padded(HD) * 2 +
         8 * (2 * kStages + 1);
}

// ---- shared memory, barriers, TMA ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
      :: "r"(bar) : "memory");
}

// a wait that has not ended after 2^26 polls (seconds) is a fault of the
// kernel: trap, so that the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// one box of [rows][64] bf16 at (column d, row s) of head h, batch b; the
// map's dims are (hd, seq, head, batch), or (hd, head, seq, batch) when the
// head stride is the smaller
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int seq_inner, int d,
                                         int s, int h, int b) {
  const int c1 = seq_inner ? s : h, c2 = seq_inner ? h : s;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(c1),
         "r"(c2), "r"(b), "r"(bar)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: the stride between 64-element column halves),
// stride byte offset (the stride between 8-row groups), all >> 4
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the two consumer warpgroups take turns at issuing their q k^T products
// (named barriers 3 and 4, both warpgroups' 256 threads): each waits for
// the other's turn to have passed, so that one's softmax runs while the
// other's products occupy the tensor cores
__device__ __forceinline__ void turn_wait(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync 4, 256;\n" ::: "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive 4, 256;\n" ::: "memory");
  else
    asm volatile("bar.arrive 3, 256;\n" ::: "memory");
}

// keep the compiler from touching wgmma's registers across the wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// p v's products, A (p, bf16) from registers, B (V) MN-major from shared
// memory: m64n{n}k16 into the accumulator's registers d[OFF, OFF + n / 2),
// its columns [2 OFF, 2 OFF + n) (8-column chunk j of the product in
// d[OFF + 4 j .. OFF + 4 j + 3])
template <int OFF, int R>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[R],
    const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 64 <= R, "accumulator too short");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]),
        "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]),
        "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]),
        "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]),
        "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]),
        "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]),
        "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int OFF, int R>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[R],
    const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 32 <= R, "accumulator too short");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int OFF, int R>
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[R],
    const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 24 <= R, "accumulator too short");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int OFF, int R>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[R],
    const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 8 <= R, "accumulator too short");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o += p v over one 16-key step, V's tile at vaddr (its first column
// half; the second, if any, kHalf bytes further): one instruction at hd 64
// and 128; at hd 80 and 112 n64 on the first half into o[0, 32) and n16 or
// n48 on the second into o[32, 40) or o[32, 56), the real columns only
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t vaddr, uint32_t kHalf) {
  const uint64_t lo = desc(vaddr, kHalf, 1024);
  if constexpr (HD == 64) {
    wgmma_rs_n64<0>(o, a, lo);
  } else if constexpr (HD == 128) {
    wgmma_rs_n128<0>(o, a, lo);
  } else {
    static_assert(HD == 80 || HD == 112, "head dim 64, 80, 112 or 128");
    const uint64_t hi = desc(vaddr + kHalf, kHalf, 1024);
    wgmma_rs_n64<0>(o, a, lo);
    if constexpr (HD == 80)
      wgmma_rs_n16<32>(o, a, hi);
    else
      wgmma_rs_n48<32>(o, a, hi);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- the kernel -----------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const TcArgs a) {
  constexpr int HDP = padded(HD);              // the tiles' width
  constexpr int NH = HDP / 64;                 // 128-byte column halves
  constexpr uint32_t kHalfQ = kBQ * 128;       // bytes of one half of Q
  constexpr uint32_t kHalfK = kBK * 128;
  constexpr uint32_t kTile = kBK * HDP * 2;    // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // 1024-byte aligned base
  uint8_t* const qgen = smem_raw + (sq - raw);
  const uint32_t sk = sq + kBQ * HDP * 2;      // kStages K tiles
  const uint32_t sv = sk + kStages * kTile;    // kStages V tiles
  const uint32_t bars = sv + kStages * kTile;  // full[s], empty[s], q
  const uint32_t qbar = bars + 16 * kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.heads / a.kv_heads);
  const int q_start = qt * kBQ;
  // the visible key tiles [lo, hi): the TPU kernel's tile predicate
  int hi = (a.seq + kBK - 1) / kBK;
  if (a.causal) hi = min(hi, (q_start + kBQ - 1) / kBK + 1);
  int lo = 0;
  if (a.window > 0) {                    // k_start + kBK - 1 > q_start - W
    const int x = q_start - a.window - kBK + 1;
    lo = x < 0 ? 0 : x / kBK + 1;
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                  // the producer's arrival
      mbar_init(bars + 8 * (kStages + s), 8);      // one per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                         // the producer warp
    if (tid == kConsumers) {
      // whole boxes: TMA counts the zero-filled columns past hd and rows
      // past the sequence's end as bytes delivered
      mbar_expect_tx(qbar, kBQ * HDP * 2);
      for (int c = 0; c < NH; ++c)
        tma_load(sq + c * kHalfQ, &tq, qbar, a.seq_inner[0], 64 * c, q_start,
                 h, b);
      for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
        const int s = i % kStages;
        mbar_wait(bars + 8 * (kStages + s), ((i / kStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * kTile);
        for (int c = 0; c < NH; ++c) {
          tma_load(sk + s * kTile + c * kHalfK, &tk, full, a.seq_inner[1],
                   64 * c, kt * kBK, kvh, b);
          tma_load(sv + s * kTile + c * kHalfK, &tv, full, a.seq_inner[2],
                   64 * c, kt * kBK, kvh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the
  // block; this thread holds rows r0 and r0 + 8 of them, and of each
  // 8-column chunk j the columns 8 j + 2 (lane % 4) + {0, 1}
  const int wg = tid / 128, lane = tid % 32;
  const int r0 = (tid % 128) / 32 * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl2 = kLog2e / sqrtf(static_cast<float>(HD));
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.0f, 0.0f};
  const uint32_t qa = sq + wg * 64 * 128;          // this warpgroup's Q rows
  if (wg == 1) turn_pass(wg);                      // warpgroup 0 goes first
  mbar_wait(qbar, 0);

  for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
    const int s = i % kStages;
    mbar_wait(bars + 8 * s, (i / kStages) & 1);
    const uint32_t kb = sk + s * kTile, vb = sv + s * kTile;

    // s = q k^T: [64 x 128] per warpgroup, K-major operands, k16 steps
    float sc[64];
#pragma unroll
    for (int n = 0; n < 64; ++n) sc[n] = 0.0f;
    pin(sc);
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;       // 16 columns, 32 bytes
      wgmma_ss_n128(sc, desc(qa + (kk / 4) * kHalfQ + step, 16, 1024),
                    desc(kb + (kk / 4) * kHalfK + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait_all();
    pin(sc);

    uint32_t pa[kBK / 16][4];                    // p in bf16
    // scale; mask, without branches, only the tiles that cross the
    // diagonal, the window's edge or the sequence's end; then the online
    // softmax (base 2) over the 4 lanes of a row
    const int k0 = kt * kBK;
    const bool edge = k0 + kBK > a.seq ||
                      (a.causal && k0 + kBK - 1 > q_start) ||
                      (a.window > 0 && k0 <= q_start + kBQ - 1 - a.window);
#pragma unroll
    for (int n = 0; n < 64; ++n) sc[n] *= sl2;
    if (edge) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qpos = q_start + wg * 64 + r0 + 8 * hr;
        // key kpos is seen if lo_ok < kpos <= hi_ok
        const int hi_ok = a.causal ? qpos : INT_MAX;
        const int lo_ok = a.window > 0 ? qpos - a.window : INT_MIN;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = k0 + 8 * j + cq + c;
            float x = sc[4 * j + 2 * hr + c];
            x = (kpos > hi_ok || kpos <= lo_ok) ? kNegBig : x;
            sc[4 * j + 2 * hr + c] = kpos >= a.seq ? -INFINITY : x;
          }
        }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = exp2f(m[hr] - m_new);
      // p, summed in f32 and packed to bf16 as it comes: the pair of
      // columns 8 j + cq + {0, 1} is the A operand's register
      // pa[j / 2][2 (j % 2) + hr] (the accumulator's own fragment)
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = exp2f(sc[4 * j + 2 * hr] - m_new);
        const float p1 = exp2f(sc[4 * j + 2 * hr + 1] - m_new);
        sum += p0;
        sum += p1;
        pa[j / 2][2 * (j % 2) + hr] = pack_bf16(p0, p1);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 2 * hr] *= alpha;
        o[4 * j + 2 * hr + 1] *= alpha;
      }
    }

    // o += p v: p (bf16) from registers, V [keys x hd] read MN-major
    pin(o);
    pin(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<HD>(o, pa[kk], vb + kk * 16 * 128, kHalfK);
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    pin(pa);
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));   // release stage s
  }

  // out = acc / max(l, 1e-30) in bf16, staged in this warpgroup's own rows
  // of the Q tile (same swizzle: chunk ^ (row % 8)), then 16-byte stores of
  // the hd / 8 real chunks of a row
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float denom = fmaxf(l[hr], 1e-30f);
    const int row = wg * 64 + r0 + 8 * hr;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const uint32_t off = (j / 8) * kHalfQ + row * 128 +
                           (((j % 8) ^ (row % 8)) * 16) + cq * 2;
      *reinterpret_cast<uint32_t*>(qgen + off) =
          pack_bf16(o[4 * j + 2 * hr] / denom, o[4 * j + 2 * hr + 1] / denom);
    }
  }
  if (wg == 0)                       // this warpgroup's 128 threads only
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  __nv_bfloat16* out = a.o + b * a.os[0] + h * a.os[2];
  constexpr int kChunks = HD / 8;                  // 16-byte chunks per row
  for (int idx = tid % 128; idx < 64 * kChunks; idx += 128) {
    const int row = wg * 64 + idx / kChunks, c = idx % kChunks;
    const int spos = q_start + row;
    if (spos >= a.seq) continue;
    const uint32_t off = (c / 8) * kHalfQ + row * 128 +
                         (((c % 8) ^ (row % 8)) * 16);
    *reinterpret_cast<uint4*>(out + spos * a.os[1] + c * 8) =
        *reinterpret_cast<const uint4*>(qgen + off);
  }
  if (wg == 0) turn_wait(wg);        // warpgroup 1's last turn
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the runtime has loaded
cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// the 4-d map of one operand: dims (hd, seq, heads, batch), sequence and
// head swapped when the head stride is the smaller; boxes of 64 x rows
cudaError_t make_map(CUtensorMap* map, int* seq_inner, EncodeTiledFn encode,
                     const void* ptr, int hd, int seq, int heads, int batch,
                     const long long* st /* batch, seq, head */, int rows) {
  *seq_inner = st[1] <= st[2];
  const cuuint64_t sb = static_cast<cuuint64_t>(st[1]) * 2;
  const cuuint64_t hb = static_cast<cuuint64_t>(st[2]) * 2;
  const cuuint64_t bb = static_cast<cuuint64_t>(st[0]) * 2;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), 0, 0,
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {0, 0, bb};
  cuuint32_t box[4] = {64, 1, 1, 1};
  if (*seq_inner) {
    dims[1] = seq; dims[2] = heads; strides[0] = sb; strides[1] = hb;
    box[1] = rows;
  } else {
    dims[1] = heads; dims[2] = seq; strides[0] = hb; strides[1] = sb;
    box[2] = rows;
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, TcArgs& a,
              int batch, const long long* strides, cudaStream_t st) {
  EncodeTiledFn encode = nullptr;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  const void* ptrs[3] = {q, k, v};
  CUtensorMap* maps[3] = {&tq, &tk, &tv};
  const int heads[3] = {a.heads, a.kv_heads, a.kv_heads};
  const int rows[3] = {kBQ, kBK, kBK};
  for (int n = 0; n < 3; ++n) {
    err = make_map(maps[n], &a.seq_inner[n], encode, ptrs[n], HD, a.seq,
                   heads[n], batch, strides + 3 * n, rows[n]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int bytes = smem_bytes<HD>();
  auto kern = flash_attention_tc_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + kBQ - 1) / kBQ, a.heads, batch);
  kern<<<grid, kThreads, bytes, st>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and out; hd 64, 80, 112 or 128. strides: 12 element strides,
// (batch, seq, head) for q, k, v and out in that order; the head dim is
// contiguous, the bases 16-byte aligned and the q, k, v strides multiples
// of 8 elements (TMA's rule), heads a multiple of kv_heads. Returns a
// cudaError_t: the launch's own (cudaGetLastError), a failure to build a
// tensor map, or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int flash_attention_tc_launch(
    int hd, int batch, int heads, int kv_heads, int seq, int causal,
    int window, const void* q, const void* k, const void* v, void* o,
    const long long* strides, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || seq < 1 ||
      heads % kv_heads != 0 || batch > 65535 || heads > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[3] = {q, k, v};
  for (int n = 0; n < 3; ++n) {
    if (reinterpret_cast<uintptr_t>(ptrs[n]) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int d = 0; d < 3; ++d)
      if (strides[3 * n + d] % 8 != 0 || strides[3 * n + d] < 1)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  TcArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  for (int n = 0; n < 3; ++n) a.os[n] = strides[9 + n];
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.seq = seq;
  a.causal = causal;
  a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_hd<64>(q, k, v, a, batch, strides, st);
  if (hd == 80) return launch_hd<80>(q, k, v, a, batch, strides, st);
  if (hd == 112) return launch_hd<112>(q, k, v, a, batch, strides, st);
  if (hd == 128) return launch_hd<128>(q, k, v, a, batch, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
