// Causal (optionally sliding-window) GQA flash attention for Hopper
// (sm_90a) with the products on the tensor cores at about f32's precision:
// the kernel for float32 inputs at every head dim, and for bf16 at the head
// dims the wgmma kernel does not take (16, 32).
//
// Replaces the TPU kernel `_kernel` (:26) of
// src/repro/kernels/flash_attention.py, reached from `flash_attention`
// (:82, `pallas_call` at :100). For query head h of batch b (KV head
// h / n_rep) and every query row i:
//   s_ij = (q_i . k_j) / sqrt(hd)           in f32, q, k, v widened to f32
//   s_ij = -1e30 where key j is masked       (causal j > i; window j <= i - W)
//   out_i = sum_j softmax_j(s_i) v_j         online: (m, l, acc) in f32
// with the TPU kernel's online-softmax arithmetic: m' = max(m, max_j s),
// alpha = exp(m - m'), p = exp(s - m'), l' = l alpha + sum p,
// acc' = acc alpha + p v, and out = acc / max(l, 1e-30). Masked logits are
// -1e30, not -inf, as in the TPU kernel: a tile that the query block sees
// but that is fully masked for one of its rows adds exp(0) = 1 terms while
// that row's m is still -1e30, and the row's first real key wipes them
// (alpha = exp(-1e30 - m) = 0); with -inf those rows would give NaN. Keys
// past the end of the sequence (a ragged last tile) get -inf instead and
// add exactly nothing. Tiles above the causal diagonal or left of the
// window are skipped with the TPU kernel's tile predicate.
//
// Softmax in base 2, as the tensor-core kernel takes it: x = s log2(e) /
// sqrt(hd) in f32 after the product, p = 2^(x - m), alpha = 2^(m - m');
// that is the TPU kernel's exp(s / sqrt(hd) - m) to f32 round-off.
//
// Products. q k^T and p v run as mma.sync m16n8k8 in TF32 with f32 sums,
// each f32 operand split into two TF32 parts and a b taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi (mma_tf32.cuh: hi rounded to TF32 as
// cvt.rna does, lo = x - hi, which the tensor cores truncate to TF32). One
// TF32 part a term would miss the f32 tolerance (2e-5) by some 50x; three
// keep about f32's precision. bf16 inputs widened to f32 are TF32 numbers
// as they stand, so in bf16 q k^T takes one product a term and p v two (p
// split, v exact). The TF32 here is explicit, in the PTX, and always in
// these parts: PyTorch's TF32 switches (which chip_smoke.py turns off for
// its matmuls) do not govern it.
//
// Bound. At B 4, S 512, 32 heads of 128, causal, f32 the function reads q,
// k, v and writes out once, 134.2 MB (0.0401 ms at 3.35 TB/s), and does
// 8.61 GFLOP of products (the causal half of 4 B H S^2 hd); in three TF32
// products that is 25.8 GFLOP, 0.0522 ms at the card's 494.5 TFLOP/s dense
// TF32 rate, which bounds it (the CUDA cores' 67 TFLOP/s f32 would take
// 0.128 ms). That rate is wgmma's: mma.sync in TF32 peaks near 256 TFLOP/s
// on an H100 (a chain-free loop of m16n8k8, eight warps an SM), which puts
// this design's floor near 0.10 ms; the kernel runs at about 40% of it
// (PERF.md), held back by the latency of each warp's chain of shared loads,
// splits and products with two warps a scheduler.
//
// Design. Grid (query tiles of 64, H, B), the tiles with the most keys
// launched first; 4 warps, each owning 16 query rows (one m16 tile). The
// block loads its 64 x hd query tile once and streams key tiles of BK rows
// of K and V through a two-slot shared-memory ring by cp.async: tile t + 1
// is in flight while tile t's products run, one block barrier on each side
// of a tile. A warp whose 16 rows a tile masks entirely (above the
// diagonal, or left of the window) skips it. Per key tile a warp computes
// S = Q K^T as hd/8 k-steps over BK/8 n8 tiles with S in registers (q's
// parts split once a k-step, k's as they are read), takes the row max and
// sum over the 4 lanes of each quad by shuffles, and adds P V as BK/8
// k-steps over hd/8 n8 tiles with O in registers (hd/2 floats a thread).
// P needs no move from the C layout to the A layout: the k-index of p v is
// a key index in any order, so k-step kk takes key kk*8 + 2t as k-index t
// and key kk*8 + 2t + 1 as t + 4, which are the keys the lane holds in its
// C fragment, and V's B fragment is read in that order. Rows are padded by
// 16 bytes (f32 +4, bf16 +8), so every fragment load of Q, K and V hits 32
// distinct banks (pairs of bf16 lanes share a word). Copies are 16 bytes
// when every row of q, k and v starts 16-byte aligned (bases and strides;
// the model's tensors do), else 4 bytes when 4-byte aligned, else (bf16 at
// an odd element) plain loads: `copy`, chosen per launch by the wrapper
// (kernels/flash_attention.py:plan). Any strides are taken (batch,
// sequence, head; the head dim is contiguous), so the model layout
// [B, S, H, hd] and the head-major one take the same kernel. BK is 32 for
// f32 at hd >= 80 (two blocks an SM: 101 KB of shared memory at hd 128)
// and 64 elsewhere, chosen on the card (benchmarks/torch_flash_key_tile.py,
// PERF.md). Built without -fmad=false: the products sum in an order the
// plain version does not fix anyway.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"   // mma_tf32, SplitFast, mma3_fast, mma2_fast

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block, 16 a warp
constexpr int kStages = 2;         // key tiles in the cp.async ring
constexpr float kNegInf = -1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // strides: batch, seq, head
  int heads, kv_heads, seq, causal, window;
  int copy;                              // 16, 4 or 2: see the header
};

// keys per tile (FLASH_KEY_TILE overrides it, to time other tiles)
template <typename T, int HD>
__host__ __device__ constexpr int key_tile() {
#ifdef FLASH_KEY_TILE
  return FLASH_KEY_TILE;
#else
  return sizeof(T) == 4 && HD >= 80 ? 32 : 64;
#endif
}

// shared-memory row pitch in elements: rows padded by 16 bytes
template <typename T, int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 16 / static_cast<int>(sizeof(T));
}

// the query tile and the two K and V tiles of the cp.async ring
template <typename T, int HD>
__host__ __device__ constexpr int smem_bytes() {
  return (kBQ + 2 * kStages * key_tile<T, HD>()) * pitch<T, HD>() *
         static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N (16 or 4) bytes from global to shared, asynchronously; src_bytes 0
// fills the destination with zeros
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// copies of N bytes: rows [r0, r0 + ROWS) of one head (row stride `ss`
// elements) into shared [ROWS][pitch]; rows at or past `seq` get zeros
template <typename T, int HD, int ROWS, int N>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long ss,
                                          int r0, int seq) {
  constexpr int E = N / static_cast<int>(sizeof(T));   // elements a copy
  constexpr int C = HD / E;                            // copies a row
  constexpr int P = pitch<T, HD>();
#pragma unroll
  for (int j = 0; j < (ROWS * C + kThreads - 1) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (ROWS * C % kThreads != 0 && i >= ROWS * C) break;
    const int r = i / C, c = i % C * E;
    const bool in = r0 + r < seq;
    cp_async<N>(dst + r * P + c, in ? src + (r0 + r) * ss + c : src,
                in ? N : 0);
  }
}

template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ss,
                                          int r0, int seq, int copy) {
  if (copy == 16) {
    copy_rows<T, HD, ROWS, 16>(dst, src, ss, r0, seq);
  } else if (copy == 4) {
    copy_rows<T, HD, ROWS, 4>(dst, src, ss, r0, seq);
  } else {   // bf16 rows at an odd element: plain loads
    constexpr int P = pitch<T, HD>();
    for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      dst[r * P + c] = r0 + r < seq ? src[(r0 + r) * ss + c]
                                    : static_cast<T>(0.0f);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const FlashArgs a) {
  // bf16 widened to f32 is a TF32 number: no low part
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BK = key_tile<T, HD>();
  constexpr int S = kStages;
  constexpr int P = pitch<T, HD>();
  constexpr int NS = BK / 8;       // n8 tiles of logits a warp
  constexpr int NO = HD / 8;       // n8 tiles of output a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // [kBQ][P]
  T* kbuf = qs + kBQ * P;                   // [S][BK][P]
  T* vbuf = kbuf + S * BK * P;              // [S][BK][P]

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.heads / a.kv_heads);
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  T* o = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[2];

  // the key tiles the TPU kernel's predicate keeps form one range
  const int n_tiles = (a.seq + BK - 1) / BK;
  const int kt_end =
      a.causal ? min(n_tiles, (q_start + kBQ - 1) / BK + 1) : n_tiles;
  const int first = q_start - a.window - BK + 1;   // keep k_start > first
  const int kt_begin = a.window > 0 && first >= 0 ? first / BK + 1 : 0;

  // tile kt_begin + i goes to ring slot i % S, in commit group i (the query
  // tile in group 0); the first S - 1 are started here
  auto fetch = [&](int kt) {
    if (kt < kt_end) {
      const int slot = (kt - kt_begin) % S;
      load_rows<T, HD, BK>(kbuf + slot * BK * P, k, a.ks[1], kt * BK, a.seq,
                           a.copy);
      load_rows<T, HD, BK>(vbuf + slot * BK * P, v, a.vs[1], kt * BK, a.seq,
                           a.copy);
    }
    cp_async_commit();
  };
  load_rows<T, HD, kBQ>(qs, q, a.qs[1], q_start, a.seq, a.copy);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) fetch(kt_begin + i);

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  // rows g and g + 8 of the warp's 16: m and the lane's share of l
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  // logits in base 2, as the tensor-core kernel takes them:
  // x = s log2(e) / sqrt(hd), p = 2^(x - m)
  const float scale = 1.44269504088896341f / sqrtf(static_cast<float>(HD));
  const int row0 = q_start + warp * 16 + g;
  const T* qw = qs + (warp * 16 + g) * P;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    fetch(kt + S - 1);     // into the slot that tile kt - 1 freed
    cp_async_wait<S - 1>();
    __syncthreads();       // tile kt has landed for every thread
    const int slot = (kt - kt_begin) % S;
    const T* ks = kbuf + slot * BK * P;
    const T* vs = vbuf + slot * BK * P;

    // a tile that masks every row of the warp changes nothing: each row's
    // m is a real logit by then, or becomes one later and wipes the tile
    const int k_start = kt * BK, w_row = q_start + warp * 16;
    if (!(a.causal && k_start > w_row + 15) &&
        !(a.window > 0 && k_start + BK - 1 <= w_row - a.window)) {
      // S = Q K^T: hd/8 k-steps over BK/8 n8 tiles
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int d = kk * 8 + t;
        const float qa[4] = {to_f32(qw[d]), to_f32(qw[8 * P + d]),
                             to_f32(qw[d + 4]), to_f32(qw[8 * P + d + 4])};
        if constexpr (kExact) {
          const uint32_t qb[4] = {__float_as_uint(qa[0]),
                                  __float_as_uint(qa[1]),
                                  __float_as_uint(qa[2]),
                                  __float_as_uint(qa[3])};
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const T* kr = ks + (n * 8 + g) * P + d;
            mma_tf32(s[n], qb, __float_as_uint(to_f32(kr[0])),
                     __float_as_uint(to_f32(kr[4])));
          }
        } else {
          const SplitFast qsplit(qa);
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const T* kr = ks + (n * 8 + g) * P + d;
            mma3_fast(s[n], qsplit, kr[0], kr[4]);
          }
        }
      }

      // scale, mask, online softmax; lane (g, t) holds keys n*8 + 2t, +1
      // of rows g (s[n][0..1]) and g + 8 (s[n][2..3])
      const bool whole =
          (!a.causal || k_start + BK - 1 <= q_start) &&
          (a.window == 0 || k_start > q_start + kBQ - 1 - a.window) &&
          k_start + BK <= a.seq;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (!whole) {
            const int kpos = k_start + n * 8 + 2 * t + (e & 1);
            const int qpos = row0 + (e >> 1) * 8;
            if (kpos >= a.seq)
              x = -INFINITY;
            else if ((a.causal && kpos > qpos) ||
                     (a.window > 0 && kpos <= qpos - a.window))
              x = kNegInf;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - m[e >> 1]);
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

      // O += P V: k-step kk takes keys kk*8 + 2t (k-index t) and
      // kk*8 + 2t + 1 (k-index t + 4), the lane's own p
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const float pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        const SplitFast psplit(pa);
        const T* vr = vs + (kk * 8 + 2 * t) * P + g;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          if constexpr (kExact)
            mma2_fast(acc[j], psplit, to_f32(vr[j * 8]),
                      to_f32(vr[P + j * 8]));
          else
            mma3_fast(acc[j], psplit, vr[j * 8], vr[P + j * 8]);
        }
      }
    }
    __syncthreads();       // slot `slot` is free for tile kt + S
  }

  // the quad's shares of l, then out = acc / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int s_row = row0 + 8 * r;
    if (s_row >= a.seq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + s_row * a.os[1] + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      store2(orow + j * 8, acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
  }
}

// opt in to the dynamic shared memory of instantiation (T, HD)
template <typename T, int HD>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<T, HD>());
}

template <typename T, int HD>
int launch_hd(const FlashArgs& a, int batch, cudaStream_t st) {
  cudaError_t err = prepare<T, HD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + kBQ - 1) / kBQ, a.heads, batch);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem_bytes<T, HD>(), st>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// out: keys per tile, threads, dynamic shared bytes per block, blocks per
// SM (the occupancy calculator's), registers per thread
template <typename T, int HD>
int info_hd(int* out) {
  cudaError_t err = prepare<T, HD>();
  cudaFuncAttributes fa;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, flash_attention_kernel<T, HD>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[3], flash_attention_kernel<T, HD>, kThreads,
        smem_bytes<T, HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = key_tile<T, HD>();
  out[1] = kThreads;
  out[2] = smem_bytes<T, HD>();
  out[4] = fa.numRegs;
  return 0;
}

struct Launch {
  template <typename T, int HD>
  static int run(const FlashArgs& a, int batch, cudaStream_t st) {
    return launch_hd<T, HD>(a, batch, st);
  }
};

struct Info {
  template <typename T, int HD>
  static int run(int* out) {
    return info_hd<T, HD>(out);
  }
};

template <typename F, typename T, typename... Args>
int by_hd(int hd, Args... args) {
  switch (hd) {
    case 16: return F::template run<T, 16>(args...);
    case 32: return F::template run<T, 32>(args...);
    case 64: return F::template run<T, 64>(args...);
    case 80: return F::template run<T, 80>(args...);
    case 112: return F::template run<T, 112>(args...);
    case 128: return F::template run<T, 128>(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F, typename... Args>
int dispatch(int kind, int hd, Args... args) {
  if (kind == 0) return by_hd<F, float>(hd, args...);
  if (kind == 1) return by_hd<F, __nv_bfloat16>(hd, args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// kind: 0 = float32, 1 = bfloat16 (q, k, v and out alike). hd: 16, 32, 64,
// 80, 112 or 128. strides: 12 element strides, (batch, seq, head) for q, k,
// v and out in that order; the head dim is contiguous, out's strides are
// even and its base 2-element aligned (pairs are stored). copy: 16 if every
// row of q, k and v starts 16-byte aligned, 4 if 4-byte aligned, else 2
// (bf16 only). heads must be a multiple of kv_heads. Returns a cudaError_t:
// the launch's own (cudaGetLastError) or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int flash_attention_launch(
    int kind, int hd, int batch, int heads, int kv_heads, int seq,
    int causal, int window, int copy, const void* q, const void* k,
    const void* v, void* o, const long long* strides, void* stream) {
  const int es = kind == 0 ? 4 : 2;
  if (batch < 1 || heads < 1 || kv_heads < 1 || seq < 1 ||
      heads % kv_heads != 0 || batch > 65535 || heads > 65535 || window < 0 ||
      !(copy == 16 || copy == 4 || (copy == 2 && kind == 1)) ||
      reinterpret_cast<uintptr_t>(o) % (2 * es) != 0 || strides[9] % 2 ||
      strides[10] % 2 || strides[11] % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int n = 0; n < 3; ++n) {
    a.qs[n] = strides[n];
    a.ks[n] = strides[3 + n];
    a.vs[n] = strides[6 + n];
    a.os[n] = strides[9 + n];
  }
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.seq = seq;
  a.causal = causal;
  a.window = window;
  a.copy = copy;
  return dispatch<Launch>(kind, hd, static_cast<const FlashArgs&>(a), batch,
                          static_cast<cudaStream_t>(stream));
}

// The launch's shape for (kind, hd) on the current card: out[0] keys per
// tile, out[1] threads per block, out[2] dynamic shared bytes per block,
// out[3] blocks per SM, out[4] registers per thread. Returns a cudaError_t.
extern "C" int flash_attention_info(int kind, int hd, int* out) {
  return dispatch<Info>(kind, hd, out);
}
