// Chunked WKV6 scan (the RWKV6 time-mix recurrence) for Hopper (sm_90a):
// the state's value columns split over two blocks per (batch, head), the
// next chunk's inputs loaded by TMA while the current chunk's products run,
// the products of bf16 inputs on the tensor cores at about f32's precision
// and those of f32 inputs on the CUDA cores in f32.
//
// Replaces the TPU kernel `_kernel` (:30) of src/repro/kernels/rwkv6_scan.py,
// reached from `rwkv6_scan` (:81, `pallas_call` at :96). Per (batch, head),
// with the f32 state S [hd, hd] (key x value) carried from chunk to chunk
// and, inside a chunk of C steps, the log decays lw (<= 0), their exclusive
// cumulative sum ls (computed as cumsum(lw) - lw, as the TPU kernel does)
// and the chunk's total ls_C = ls[C-1] + lw[C-1]:
//   y_i  = (r_i e^{ls_i}) S                                  inter-chunk
//        + sum_{l<i} (sum_d r_id e^{ls_id - c_d} k_ld e^{c_d - ls_(l+1)d}) v_l
//        + (sum_d r_id u_d k_id) v_i                         diagonal bonus
//   S'   = diag(e^{ls_C}) S + sum_l (k_l e^{ls_C - ls_(l+1)})^T v_l
// with c = ls_C / 2: the TPU kernel re-centres both factors of the intra-
// chunk decay at half the chunk's decay (|ls - c| <= |ls_C| / 2), so each
// stays within f32 range while |ls_C| < 2 * 88, e.g. C 32 at log decays
// down to -5.5 per step, or C 8 down to -22; beyond that the factors
// overflow, in the TPU kernel as here. The strictly lower part and the
// diagonal bonus are kept apart, as there. u arrives as f32 (the wrapper
// widens the model's bf16 bonus). What rounds differently from the TPU
// kernel, all f32 round-off: the inter-chunk and carry factors are the
// re-centred ones times e^{c} (r e^{ls - c} e^{c}, k e^{c - ls'} e^{c}),
// one more rounding each; the cumulative sum adds in segments (below); the
// products sum in orders of their own. For bf16 inputs (at hd >= 64 and
// chunks over 8) the products run as mma.sync m16n8k8 in TF32 with each
// f32 operand split into two TF32 parts, x = hi + lo, and a b taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi (v, widened from bf16, is a TF32
// number: its low part is 0): the dropped a_lo b_lo is 2^-22 of the
// product, so the sums keep about f32's precision (TF32 alone, 2^-11,
// would not); f32 inputs keep f32 arithmetic on the CUDA cores.
//
// Bound. At one rwkv6-7b layer of the serve path (B 4, T 512, 64 heads of
// 64, chunk 32, bf16 r/k/v/y, f32 log decay and state) the scan needs
// 2 (2 hd^2 + (C + 1) hd) f32 operations per token and head (the inter-
// chunk term and the state update, hd^2 multiply-adds each; the strictly
// lower scores, the diagonal bonus and their product with v, (C + 1) hd),
// 2.70 GFLOP, 0.040 ms at the card's 67 TFLOP/s f32 rate, and moves
// 0.109 GB (0.033 ms at 3.35 TB/s): operations bound it. This kernel does
// 0.26 GFLOP more: both blocks of a head form the chunk's factors and its
// whole score triangle (C (C - 1) / 2 hd multiply-adds), where one would do.
// Sharing them through a thread-block cluster's distributed shared memory
// was tried (four blocks a head, three cluster barriers a chunk, each of
// which compiles to a GPU-wide memory fence): it ran slower than
// recomputing.
//
// Design. Grid (2, H, B), 128 threads: block j of (batch, head) owns value
// columns [j hd/2, (j + 1) hd/2) of the state, which it keeps in shared
// memory ([column][d], hd x hd/2 f32), and writes those columns of y and of
// the final state. The inter-chunk term and the state update split over the
// two blocks with no redundancy. Each chunk, in order:
//   1. wait for the chunk's raw r, k, lw and own v columns (one mbarrier);
//   2. the exclusive cumulative sum of lw per channel, in parallel: the
//      chunk is cut into 128 / hd segments (2 at hd 64), neighbouring lanes
//      pass their segment sums by shuffles; the same threads form the
//      re-centred factors r e^{ls-c} and k e^{c-ls'} (f32, transposed,
//      [d][C + 4]), e^{c} and e^{ls_C} per channel; the block widens its v
//      columns to f32 and takes the bonus of each step (a warp per step);
//   3. one thread issues the next chunk's four TMA boxes into the raw
//      buffer, which the chunk no longer reads: they land while 4-7 run;
//   4. the strictly lower score triangle: bf16, 16 x 16 tiles below the
//      diagonal, a warp each on the tensor cores; f32, 2 x 4 tiles a
//      thread (a float2 of r factors and a float4 of k factors per
//      channel); the bonus diagonal;
//   5. both factor arrays times e^{c} in place: r e^{ls}, k e^{ls_C-ls'};
//   6. y for the block's columns: bf16, 16 x 16 tiles a warp on the tensor
//      cores; f32, two columns and C/8 consecutive rows a thread with the
//      state's columns in registers; the score triangle above the diagonal
//      skipped;
//   7. the state update: bf16, 16 x 16 tiles a warp on the tensor cores;
//      f32, two columns and eight rows a thread, v's columns in registers.
//      e^{ls_C} is taken once per channel in step 2.
// Shared memory at hd 64, C 32: 55,440 bytes in bf16 (65,680 in f32, whose
// raw r, k and v are twice as wide), so four blocks fit on an SM in bf16
// (three in f32), and four by registers (at most 128 a thread). At the
// path's shape that is 512 blocks: one wave. Loads come by TMA when every
// row starts 16-byte aligned (the model's tensors do), else by plain loads.
// The kernel is compiled for chunks of at most 8, 16, 32 and 64 steps, and
// head dims 8, 16, 32, 64 and 128; the wrapper refuses any other.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "mma_tf32.cuh"   // tf32, mma_tf32, SplitA, mma3

namespace {

constexpr int kThreads = 128;
constexpr int kVSplit = 2;       // blocks per (batch, head)

struct ScanArgs {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;        // log decay
  const float* u;         // [H, hd] f32, contiguous
  const float* s0;        // [B, H, hd, hd] f32, contiguous
  void* y;
  float* s_out;           // [B, H, hd, hd] f32, contiguous
  long long rs[3], ks[3], vs[3], ws[3], ys[3];  // strides: batch, head, time
  int heads, steps, chunk;
  int tma;                // rows come by TMA (aligned), else plain loads
  int seq_inner[4];       // r, k, log_w, v maps: time before head
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// byte offsets of the shared-memory arrays, for head dim hd and chunks of
// at most cm steps; q = hd / kVSplit is a block's share of the value
// columns (of v, y and the state)
struct Smem {
  int r, k, lw, v, rd, kd, ec, dc, a, v32, s, dg, bar, bytes;
};

__host__ __device__ inline Smem smem_layout(int hd, int cm, int es) {
  const int q = hd / kVSplit;
  Smem m;
  int o = 0;
  m.r = o;   o = align128(o + cm * hd * es);          // raw, input dtype
  m.k = o;   o = align128(o + cm * hd * es);          // (TMA writes at
  m.lw = o;  o = align128(o + cm * hd * 4);           // 128-byte aligned
  m.v = o;   o = align16(o + cm * q * es);            // addresses)
  m.rd = o;  o = align16(o + hd * (cm + 4) * 4);      // r factors, [d][t]
  m.kd = o;  o = align16(o + hd * (cm + 4) * 4);      // k factors, [d][t]
  m.ec = o;  o = align16(o + hd * 4);                 // e^{c}
  m.dc = o;  o = align16(o + hd * 4);                 // e^{ls_C}
  m.a = o;   o = align16(o + cm * (cm + 4) * 4);      // scores
  m.v32 = o; o = align16(o + cm * (q + 4) * 4);       // own columns of v
  m.s = o;   o = align16(o + q * (hd + 4) * 4);       // own state, [col][d]
  m.dg = o;  o = align16(o + cm * 4);                 // bonus diagonal
  m.bar = o; o = align16(o + 8);                      // TMA completion
  m.bytes = o;
  return m;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [0, n) of a slab (row elements of T_ at row stride `stride`
// elements) into shared memory [n][row], with plain loads: the path for
// rows that do not start 16-byte aligned
template <typename T_>
__device__ __forceinline__ void load_rows(T_* dst, const T_* src,
                                          long long stride, int n, int row) {
  for (int idx = threadIdx.x; idx < n * row; idx += kThreads) {
    const int t = idx / row, d = idx % row;
    dst[t * row + d] = src[t * stride + d];
  }
}

// ---- TMA and its barrier -------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// one box of a 4-d map at (column d, time t) of head h, batch b; the map's
// dims are (hd, time, head, batch), or (hd, head, time, batch) when the
// head stride is the smaller
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, int seq_inner, int d,
                                         int t, int h, int b) {
  const int c1 = seq_inner ? t : h, c2 = seq_inner ? h : t;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(d),
         "r"(c1), "r"(c2), "r"(b), "r"(bar)
      : "memory");
}

template <typename T, int HD, int CM>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : 2)
rwkv6_scan_kernel(const __grid_constant__ CUtensorMap tr,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tv, const ScanArgs a) {
  constexpr int Q = HD / kVSplit;            // own value columns
  constexpr int NG = 2 * kThreads / Q;       // groups of Q / 2 threads
  constexpr int G = kThreads / HD;           // cumsum segments per channel
  constexpr int P = HD + 4;                  // state column (float4-aligned)
  constexpr int PA = CM + 4;                 // factor and score rows
  constexpr int QP = Q + 4;                  // v row (float4-aligned)
  // bf16 inputs at hd >= 64 and chunks over 8: the products on the tensor
  // cores (mma.sync, TF32 in three parts, about f32's precision)
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value && HD >= 64 &&
                        CM >= 16;
  constexpr int RPT = (CM + NG - 1) / NG;    // y rows per thread
  constexpr int D4 = (HD / 4 + NG - 1) / NG; // state row quads per thread
  constexpr int SEG = (CM + G - 1) / G;      // longest cumsum segment
  const int C = a.chunk;
  const Smem L = smem_layout(HD, CM, static_cast<int>(sizeof(T)));
  extern __shared__ __align__(128) uint8_t sm[];
  T* R = reinterpret_cast<T*>(sm + L.r);
  T* K = reinterpret_cast<T*>(sm + L.k);
  float* LW = reinterpret_cast<float*>(sm + L.lw);
  T* V = reinterpret_cast<T*>(sm + L.v);
  float* RT = reinterpret_cast<float*>(sm + L.rd);   // [d][t]
  float* KT = reinterpret_cast<float*>(sm + L.kd);   // [d][t]
  float* EC = reinterpret_cast<float*>(sm + L.ec);
  float* DC = reinterpret_cast<float*>(sm + L.dc);   // e^{ls_C}
  float* A = reinterpret_cast<float*>(sm + L.a);
  float* V32 = reinterpret_cast<float*>(sm + L.v32);
  float* S = reinterpret_cast<float*>(sm + L.s);     // [col][d]
  float* DG = reinterpret_cast<float*>(sm + L.dg);

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * Q;             // own value columns
  const T* r = static_cast<const T*>(a.r) + b * a.rs[0] + h * a.rs[1];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1] + q0;
  const float* lw = a.lw + b * a.ws[0] + h * a.ws[1];
  T* y = static_cast<T*>(a.y) + b * a.ys[0] + h * a.ys[1] + q0;
  const long long sbase = (static_cast<long long>(b) * a.heads + h) * HD * HD;
  const uint32_t bar = smem_u32(sm + L.bar);
  // the chunk at c0 into the raw buffer: four TMA boxes issued by one
  // thread and completed on `bar`, or plain loads by every thread
  auto load_chunk = [&](int c0) {
    if (a.tma) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"(C * (2 * HD * static_cast<int>(sizeof(T))
                                           + 4 * HD
                                           + Q * static_cast<int>(sizeof(T))))
                     : "memory");
        tma_load(R, &tr, bar, a.seq_inner[0], 0, c0, h, b);
        tma_load(K, &tk, bar, a.seq_inner[1], 0, c0, h, b);
        tma_load(LW, &tw, bar, a.seq_inner[2], 0, c0, h, b);
        tma_load(V, &tv, bar, a.seq_inner[3], q0, c0, h, b);
      }
    } else {
      load_rows(R, r + c0 * a.rs[2], a.rs[2], C, HD);
      load_rows(K, k + c0 * a.ks[2], a.ks[2], C, HD);
      load_rows(LW, lw + c0 * a.ws[2], a.ws[2], C, HD);
      load_rows(V, v + c0 * a.vs[2], a.vs[2], C, Q);
    }
  };

  // the state's own columns, column-major; zeros where a chunk shorter than
  // CM leaves the factors, the scores and v unwritten
  for (int idx = tid; idx < HD * Q; idx += kThreads)
    S[(idx % Q) * P + idx / Q] = a.s0[sbase + (idx / Q) * HD + q0 + idx % Q];
  for (int idx = tid; idx < HD * PA; idx += kThreads) {
    RT[idx] = 0.0f;
    KT[idx] = 0.0f;
  }
  for (int idx = tid; idx < CM * PA; idx += kThreads) A[idx] = 0.0f;
  for (int idx = tid; idx < CM * QP; idx += kThreads) V32[idx] = 0.0f;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_chunk(0);

  // the cumsum: G neighbouring lanes share a channel, one segment each
  const int cd = tid / G, cg = tid % G;
  const int seg_len = (C + G - 1) / G;
  const int t_lo = min(C, cg * seg_len), t_hi = min(C, t_lo + seg_len);
  // y: this thread's column and rows [i_lo, i_lo + RPT); the state: its
  // column and row quads 4 (grp + NG n)
  const int col = 2 * (tid % (Q / 2)), grp = tid / (Q / 2);
  const int i_lo = grp * RPT;
  // the tensor cores' fragments: this lane's group (row) and thread (column)
  const int mg = lane / 4, mt = lane % 4;

  for (int c0 = 0, ci = 0; c0 < a.steps; c0 += C, ++ci) {
    // 1. the chunk's inputs have landed, and the last chunk is done
    if (a.tma) mbar_wait(bar, ci & 1);
    __syncthreads();

    // 2. cumsum by segments (the segment sums pass between neighbouring
    //    lanes); the re-centred factors, e^{c} and ls_C; own v in f32; the
    //    bonus diagonal
    {
      float tot = 0.0f;
#pragma unroll
      for (int n = 0; n < SEG; ++n)
        if (t_lo + n < t_hi) tot += LW[(t_lo + n) * HD + cd];
      float off = 0.0f, all = 0.0f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float x = __shfl_sync(0xffffffffu, tot, (lane & ~(G - 1)) + g);
        if (g == cg) off = all;
        all += x;
      }
      // all = cumsum(lw)[C - 1], added as the last segment's thread adds it
      const float lw_last = LW[(C - 1) * HD + cd];
      const float lt = (all - lw_last) + lw_last;
      const float c = 0.5f * lt;
      if (cg == 0) {
        EC[cd] = expf(c);
        DC[cd] = expf(lt);
      }
      float run = 0.0f;
#pragma unroll
      for (int n = 0; n < SEG; ++n) {
        const int t = t_lo + n;
        if (t < t_hi) {
          const float w = LW[t * HD + cd];
          run += w;
          const float ls = (off + run) - w;   // cumsum(lw) - lw
          RT[cd * PA + t] = to_f32(R[t * HD + cd]) * expf(ls - c);
          KT[cd * PA + t] = to_f32(K[t * HD + cd]) * expf(c - (ls + w));
        }
      }
    }
    for (int idx = tid; idx < C * Q; idx += kThreads)
      V32[(idx / Q) * QP + idx % Q] = to_f32(V[idx]);
    {
      // the bonus r . (u * k) of each step: a warp per step, steps
      // interleaved so that the warp's reductions overlap
      float ud[(HD + 31) / 32];
#pragma unroll
      for (int e = 0; e < (HD + 31) / 32; ++e)
        ud[e] = lane + 32 * e < HD ? a.u[h * HD + lane + 32 * e] : 0.0f;
#pragma unroll
      for (int n = 0; n < (CM + kThreads / 32 - 1) / (kThreads / 32); ++n) {
        const int t = warp + (kThreads / 32) * n;
        float s = 0.0f;
        if (t < C) {
#pragma unroll
          for (int e = 0; e < (HD + 31) / 32; ++e) {
            const int d = lane + 32 * e;
            if (d < HD)
              s += (to_f32(R[t * HD + d]) * ud[e]) * to_f32(K[t * HD + d]);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0 && t < C) DG[t] = s;
      }
    }
    __syncthreads();

    // 3. the next chunk's loads, into the raw buffer this chunk is done with
    if (c0 + C < a.steps) load_chunk(c0 + C);

    // 4. the strictly lower score triangle in 2 x 4 tiles (rows i0, i0 + 1,
    //    columns l0 .. l0 + 3, l0 <= i0), and the bonus diagonal
    if constexpr (kMma) {
      // 16 x 16 tiles below the diagonal (two m16n8 products sharing the
      // rows' operand), a warp each
      constexpr int NP = CM / 16;
      for (int item = warp; item < NP * NP; item += kThreads / 32) {
        const int i0 = 16 * (item / NP), l0 = 16 * (item % NP);
        if (l0 > i0 || i0 >= C) continue;
        float c[2][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < HD; k0 += 8) {
          const float* x = RT + (k0 + mt) * PA + i0 + mg;
          const float av[4] = {x[0], x[8], x[4 * PA], x[4 * PA + 8]};
          const SplitA sa(av);
          const float* z = KT + (k0 + mt) * PA + l0 + mg;
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma3<false>(c[n], sa, z[8 * n], z[4 * PA + 8 * n]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + mg + 8 * (e / 2);
            const int l = l0 + 8 * n + 2 * mt + e % 2;
            if (i < C && l < i) A[i * PA + l] = c[n][e];
          }
      }
    } else {
      for (int p = tid;; p += kThreads) {
        int ti = 0, before = 0;                // tile row ti holds ti / 2 + 1
        while (ti < CM / 2 && before + ti / 2 + 1 <= p) before += ti++ / 2 + 1;
        if (ti >= CM / 2 || 2 * ti >= C) break;
        const int i0 = 2 * ti, l0 = 4 * (p - before);
        float s[2][4] = {};
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          const float2 x = *reinterpret_cast<const float2*>(RT + d * PA + i0);
          const float4 z = *reinterpret_cast<const float4*>(KT + d * PA + l0);
          s[0][0] += x.x * z.x; s[0][1] += x.x * z.y;
          s[0][2] += x.x * z.z; s[0][3] += x.x * z.w;
          s[1][0] += x.y * z.x; s[1][1] += x.y * z.y;
          s[1][2] += x.y * z.z; s[1][3] += x.y * z.w;
        }
#pragma unroll
        for (int di = 0; di < 2; ++di)
#pragma unroll
          for (int dl = 0; dl < 4; ++dl) {
            const int i = i0 + di, l = l0 + dl;
            if (i < C && l < i) A[i * PA + l] = s[di][dl];
          }
      }
    }
    for (int t = tid; t < C; t += kThreads) A[t * PA + t] = DG[t];
    __syncthreads();

    // 5. r e^{ls} and k e^{ls_C - ls'} in place: the re-centred factors
    //    times e^{c}
    for (int idx = tid; idx < HD * (CM / 4); idx += kThreads) {
      const int d = idx / (CM / 4), t = 4 * (idx % (CM / 4));
      const float e = EC[d];
      float4* rp = reinterpret_cast<float4*>(RT + d * PA + t);
      float4* kp = reinterpret_cast<float4*>(KT + d * PA + t);
      float4 x = *rp, z = *kp;
      x.x *= e; x.y *= e; x.z *= e; x.w *= e;
      z.x *= e; z.y *= e; z.z *= e; z.w *= e;
      *rp = x;
      *kp = z;
    }
    __syncthreads();

    // 6. y = (r e^{ls}) S + A v for the block's columns
    if constexpr (kMma) {
      // 16 x 16 tiles of y (two m16n8 products sharing the rows' operand),
      // a warp each: the inter-chunk term over d, then the intra-chunk
      // term over the steps at or below the tile's rows
      constexpr int NP = Q / 16;
      for (int item = warp; item < (CM / 16) * NP; item += kThreads / 32) {
        const int i0 = 16 * (item / NP), n0 = 16 * (item % NP);
        if (i0 >= C) continue;
        float c[2][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < HD; k0 += 8) {
          const float* x = RT + (k0 + mt) * PA + i0 + mg;
          const float av[4] = {x[0], x[8], x[4 * PA], x[4 * PA + 8]};
          const SplitA sa(av);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float* z = S + (n0 + 8 * n + mg) * P + k0 + mt;
            mma3<false>(c[n], sa, z[0], z[4]);
          }
        }
#pragma unroll
        for (int k0 = 0; k0 < CM; k0 += 8) {
          if (k0 > i0 + 15) break;           // A = 0 above the diagonal
          const float* x = A + (i0 + mg) * PA + k0 + mt;
          const float av[4] = {x[0], x[8 * PA], x[4], x[8 * PA + 4]};
          const SplitA sa(av);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float* z = V32 + (k0 + mt) * QP + n0 + 8 * n + mg;
            mma3<true>(c[n], sa, z[0], z[4 * QP]);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + mg + 8 * (e / 2);
            if (i < C)
              store(y + (c0 + i) * a.ys[2] + n0 + 8 * n + 2 * mt + e % 2,
                    c[n][e]);
          }
      }
      __syncthreads();           // every read of the chunk's input state

      // 7. S' = diag(e^{ls_C}) S + (k e^{ls_C - ls'})^T v: 16 x 16 tiles
      //    of the block's columns, a warp each
      for (int item = warp; item < (HD / 16) * NP; item += kThreads / 32) {
        const int d0 = 16 * (item / NP), n0 = 16 * (item % NP);
        float c[2][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < CM; k0 += 8) {
          const float* x = KT + (d0 + mg) * PA + k0 + mt;
          const float av[4] = {x[0], x[8 * PA], x[4], x[8 * PA + 4]};
          const SplitA sa(av);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float* z = V32 + (k0 + mt) * QP + n0 + 8 * n + mg;
            mma3<true>(c[n], sa, z[0], z[4 * QP]);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = d0 + mg + 8 * (e / 2);
            float* sp = S + (n0 + 8 * n + 2 * mt + e % 2) * P + d;
            *sp = DC[d] * *sp + c[n][e];
          }
      }
    } else {
      // y for own columns col, col + 1, rows i_lo + m
      float vc[2][CM];                         // own columns of v
      {
        float acc[RPT][2];
#pragma unroll
        for (int m = 0; m < RPT; ++m) acc[m][0] = acc[m][1] = 0.0f;
#pragma unroll
        for (int hh = 0; hh < HD; hh += HD / 2) {  // the state's columns
          float sc[2][HD / 2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int d = 0; d < HD / 2; d += 4) {
              const float4 s4 = *reinterpret_cast<const float4*>(
                  S + (col + e) * P + hh + d);
              sc[e][d] = s4.x; sc[e][d + 1] = s4.y;
              sc[e][d + 2] = s4.z; sc[e][d + 3] = s4.w;
            }
          if (i_lo < C) {
#pragma unroll
            for (int d = 0; d < HD / 2; ++d) {
              const float* x = RT + (hh + d) * PA + i_lo;
              if constexpr (RPT % 4 == 0) {
#pragma unroll
                for (int m = 0; m < RPT; m += 4) {
                  const float4 x4 = *reinterpret_cast<const float4*>(x + m);
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    acc[m][e] += x4.x * sc[e][d];
                    acc[m + 1][e] += x4.y * sc[e][d];
                    acc[m + 2][e] += x4.z * sc[e][d];
                    acc[m + 3][e] += x4.w * sc[e][d];
                  }
                }
              } else {
#pragma unroll
                for (int m = 0; m < RPT; ++m)
#pragma unroll
                  for (int e = 0; e < 2; ++e) acc[m][e] += x[m] * sc[e][d];
              }
            }
          }
        }
#pragma unroll
        for (int l = 0; l < CM; ++l) {
          const float2 w2 =
              *reinterpret_cast<const float2*>(V32 + l * QP + col);
          vc[0][l] = w2.x;
          vc[1][l] = w2.y;
        }
#pragma unroll
        for (int m = 0; m < RPT; ++m) {
          const int i = i_lo + m;
          if (i >= C) break;
          const float* x = A + i * PA;
          float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
          for (int l = 0; l < CM; l += 4) {
            if (l > i) break;                  // A[i][l] = 0 above the diagonal
            const float4 a4 = *reinterpret_cast<const float4*>(x + l);
            s0 += a4.x * vc[0][l];
            s0 += a4.y * vc[0][l + 1];
            s0 += a4.z * vc[0][l + 2];
            s0 += a4.w * vc[0][l + 3];
            s1 += a4.x * vc[1][l];
            s1 += a4.y * vc[1][l + 1];
            s1 += a4.z * vc[1][l + 2];
            s1 += a4.w * vc[1][l + 3];
          }
          T* yp = y + (c0 + i) * a.ys[2] + col;
          store(yp, acc[m][0] + s0);
          store(yp + 1, acc[m][1] + s1);
        }
      }
      __syncthreads();           // every read of the chunk's input state

      // S' for own columns, state rows 4 (grp + NG n) + {0, 1, 2, 3}
#pragma unroll
      for (int n = 0; n < D4; ++n) {
        const int d = 4 * (grp + NG * n);
        if (d >= HD) break;
        float sv[4][2] = {};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* x = KT + (d + e) * PA;
#pragma unroll
          for (int l = 0; l < CM; l += 4) {
            const float4 k4 = *reinterpret_cast<const float4*>(x + l);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              sv[e][c] += k4.x * vc[c][l];
              sv[e][c] += k4.y * vc[c][l + 1];
              sv[e][c] += k4.z * vc[c][l + 2];
              sv[e][c] += k4.w * vc[c][l + 3];
            }
          }
        }
        const float4 dc4 = *reinterpret_cast<const float4*>(DC + d);
        const float dec[4] = {dc4.x, dc4.y, dc4.z, dc4.w};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float4* sp = reinterpret_cast<float4*>(S + (col + c) * P + d);
          float4 st = *sp;
          st.x = dec[0] * st.x + sv[0][c];
          st.y = dec[1] * st.y + sv[1][c];
          st.z = dec[2] * st.z + sv[2][c];
          st.w = dec[3] * st.w + sv[3][c];
          *sp = st;
        }
      }
  
    }
  }
  __syncthreads();
  for (int idx = tid; idx < HD * Q; idx += kThreads)
    a.s_out[sbase + (idx / Q) * HD + q0 + idx % Q] = S[(idx % Q) * P + idx / Q];
}

// the smallest compiled chunk bound that holds `chunk` (0: none)
inline int chunk_bound(int chunk) {
  const int bounds[4] = {8, 16, 32, 64};
  for (int n = 0; n < 4; ++n)
    if (chunk <= bounds[n]) return bounds[n];
  return 0;
}

template <typename T, int HD, int CM>
cudaError_t prepare(int* bytes) {
  const Smem m = smem_layout(HD, CM, static_cast<int>(sizeof(T)));
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (m.bytes > max_smem) return cudaErrorInvalidValue;
  auto kern = rwkv6_scan_kernel<T, HD, CM>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             m.bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  *bytes = m.bytes;
  return err;
}

template <typename T, int HD, int CM>
int launch_cm(const ScanArgs& a, const CUtensorMap* maps, int batch,
              cudaStream_t st) {
  int bytes = 0;
  const cudaError_t err = prepare<T, HD, CM>(&bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(kVSplit, a.heads, batch);
  rwkv6_scan_kernel<T, HD, CM><<<grid, kThreads, bytes, st>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

// blocks of the kernel that fit on one SM by its shared memory, its
// registers and its threads
template <typename T, int HD, int CM>
int info_cm(int* out) {
  int bytes = 0;
  cudaError_t err = prepare<T, HD, CM>(&bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, rwkv6_scan_kernel<T, HD, CM>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, smem_sm = 0, reserved = 0, regs_sm = 0, threads_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &regs_sm, cudaDevAttrMaxRegistersPerMultiprocessor, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &threads_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int warp_regs = (fa.numRegs * 32 + 255) / 256 * 256;
  int per_sm = smem_sm / (bytes + reserved);
  per_sm = min(per_sm, regs_sm / (warp_regs * (kThreads / 32)));
  per_sm = min(per_sm, threads_sm / kThreads);
  out[0] = kVSplit;
  out[1] = kThreads;
  out[2] = bytes;
  out[3] = per_sm;
  out[4] = fa.numRegs;
  return 0;
}

// (kind, hd, chunk bound) -> F<T, HD, CM>::run(args...)
template <template <typename, int, int> class F, typename... Args>
int dispatch(int kind, int hd, int cm, Args... args) {
#define SCAN_CASE(TT, HH, CC)                                   \
  if (hd == HH && cm == CC) return F<TT, HH, CC>::run(args...);
#define SCAN_CASES(TT)                                          \
  SCAN_CASE(TT, 8, 8) SCAN_CASE(TT, 8, 16) SCAN_CASE(TT, 8, 32)   \
  SCAN_CASE(TT, 8, 64)                                            \
  SCAN_CASE(TT, 16, 8) SCAN_CASE(TT, 16, 16) SCAN_CASE(TT, 16, 32) \
  SCAN_CASE(TT, 16, 64) SCAN_CASE(TT, 32, 8) SCAN_CASE(TT, 32, 16) \
  SCAN_CASE(TT, 32, 32) SCAN_CASE(TT, 32, 64) SCAN_CASE(TT, 64, 8) \
  SCAN_CASE(TT, 64, 16) SCAN_CASE(TT, 64, 32) SCAN_CASE(TT, 64, 64) \
  SCAN_CASE(TT, 128, 8) SCAN_CASE(TT, 128, 16) SCAN_CASE(TT, 128, 32) \
  SCAN_CASE(TT, 128, 64)
  if (kind == 0) { SCAN_CASES(float) }
  if (kind == 1) { SCAN_CASES(__nv_bfloat16) }
#undef SCAN_CASES
#undef SCAN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int HD, int CM>
struct Launch {
  static int run(const ScanArgs* a, const CUtensorMap* maps, int batch,
                 cudaStream_t st) {
    return launch_cm<T, HD, CM>(*a, maps, batch, st);
  }
};

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

// the 4-d map of one [B, T, H, hd] operand (element strides batch, head,
// time): dims (hd, time, head, batch), time and head swapped when the head
// stride is the smaller; boxes of `cols` x `rows` (one head, one batch)
cudaError_t make_map(CUtensorMap* map, int* seq_inner, EncodeTiledFn encode,
                     const void* ptr, int f32, int hd, int steps, int heads,
                     int batch, const long long* st, int cols, int rows) {
  const cuuint64_t es = f32 ? 4 : 2;
  *seq_inner = st[2] <= st[1];
  const cuuint64_t tb = static_cast<cuuint64_t>(st[2]) * es;
  const cuuint64_t hb = static_cast<cuuint64_t>(st[1]) * es;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), 0, 0,
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {0, 0, static_cast<cuuint64_t>(st[0]) * es};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, 1, 1};
  if (*seq_inner) {
    dims[1] = steps; dims[2] = heads; strides[0] = tb; strides[1] = hb;
    box[1] = rows;
  } else {
    dims[1] = heads; dims[2] = steps; strides[0] = hb; strides[1] = tb;
    box[2] = rows;
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int HD, int CM>
struct Info {
  static int run(int* out) { return info_cm<T, HD, CM>(out); }
};

}  // namespace

// kind: 0 = float32, 1 = bfloat16 (r, k, v and y alike). hd: 8, 16, 32, 64
// or 128; chunk at most 64. strides: 15 element strides, (batch, head, time)
// for r, k, v, log_w and y in that order; the head dim is contiguous. steps
// must be a multiple of chunk. tma: 1 if every row of r, k, v and log_w
// starts 16-byte aligned (bases and strides), so that the rows are copied
// by TMA; 0 for plain loads. Returns a cudaError_t: the launch's own
// (cudaGetLastError), a failure to build a tensor map, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int rwkv6_scan_launch(
    int kind, int batch, int heads, int steps, int hd, int chunk, int tma,
    const void* r, const void* k, const void* v, const float* lw,
    const float* u, const float* s0, void* y, float* s_out,
    const long long* strides, void* stream) {
  const int cm = chunk_bound(chunk);
  if (batch < 1 || heads < 1 || steps < 1 || chunk < 1 || cm == 0 ||
      steps % chunk != 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.lw = lw;
  a.u = u;
  a.s0 = s0;
  a.y = y;
  a.s_out = s_out;
  for (int n = 0; n < 3; ++n) {
    a.rs[n] = strides[n];
    a.ks[n] = strides[3 + n];
    a.vs[n] = strides[6 + n];
    a.ws[n] = strides[9 + n];
    a.ys[n] = strides[12 + n];
  }
  a.heads = heads;
  a.steps = steps;
  a.chunk = chunk;
  a.tma = tma;
  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  for (int n = 0; n < 4; ++n) a.seq_inner[n] = 1;
  if (tma) {
    EncodeTiledFn encode = nullptr;
    cudaError_t err = encode_fn(&encode);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* ptrs[4] = {r, k, lw, v};
    const int f32[4] = {kind == 0, kind == 0, 1, kind == 0};
    const int cols[4] = {hd, hd, hd, hd / kVSplit};
    const int sidx[4] = {0, 3, 9, 6};   // r, k, log_w, v in `strides`
    for (int n = 0; n < 4; ++n) {
      err = make_map(&maps[n], &a.seq_inner[n], encode, ptrs[n], f32[n], hd,
                     steps, heads, batch, strides + sidx[n], cols[n], chunk);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return dispatch<Launch>(kind, hd, cm, static_cast<const ScanArgs*>(&a),
                          static_cast<const CUtensorMap*>(maps), batch,
                          static_cast<cudaStream_t>(stream));
}

// The launch's shape for (kind, hd, chunk): out[0] blocks per (batch,
// head), out[1] threads per block, out[2] shared bytes per block, out[3]
// blocks that fit on one SM by shared memory, registers and threads,
// out[4] registers per thread. Returns a cudaError_t.
extern "C" int rwkv6_scan_info(int kind, int hd, int chunk, int* out) {
  const int cm = chunk_bound(chunk);
  if (chunk < 1 || cm == 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Info>(kind, hd, cm, out);
}
