// Causal (optionally sliding-window) GQA flash attention for Hopper
// (sm_90a), in f32 on the CUDA cores: the kernel for float32 inputs and for
// the head dims the tensor-core kernel does not take.
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
// Bound. At the serve path's shape (one full-width qwen3-4b layer: B 4,
// S 512, 32 query heads and, after the model's repeat, 32 KV heads,
// hd 128, bf16, causal) the function reads q, k, v and writes out once,
// 4 x 33.6 MB = 67 MB (0.020 ms at 3.35 TB/s), and does 8.59 GFLOP of
// products (causal half of 4 B H S^2 hd), 0.0087 ms at the bf16 tensor-core
// rate: bytes bound it on this card. This kernel computes in f32 on the
// CUDA cores, the TPU kernel's arithmetic; at the card's 67 TFLOP/s f32 rate
// the same products take at least 0.13 ms, so it cannot reach the bound.
// It takes float32 inputs at every head dim, and bf16 at head dims 16 and
// 32; bf16 at 64, 80, 112 and 128 goes to the tensor-core kernel,
// flash_attention_tc.cu, which rounds p to bf16
// (kernels/flash_attention.py:route). Its bf16 instantiations at those
// dims stay, reached only through the wrapper's kernel="cc", to time the
// two kernels on the same inputs; its bf16 loads are 2-byte scalars.
//
// Design. Grid (query tiles of 64, H, B); 256 threads as 16 x 16. A block
// keeps its 64 x hd query tile in shared memory and streams 64-key tiles of
// K and V through shared memory (all f32; rows padded by one word so that
// the 16 threads of a row group hit 16 banks). Each thread computes a 4 x 4
// piece of the 64 x 64 logits (rows 4 ty + i, keys tx + 16 j), reduces the
// row max and sum over the 16 threads of its row group with shuffles, keeps
// m and l for its 4 rows, writes p to shared memory, and accumulates its
// 4 x hd/16 piece of the output (columns tx + 16 c; hd 80 and 112 give 5
// and 7 columns a thread). The inputs are read through strides (batch,
// sequence, head; the head dim is contiguous), so
// the model layout [B, S, H, hd] and the head-major one take the same kernel
// without a transposed copy. At hd 128 a block holds 115 KB of shared
// memory (dynamic, opted in), at hd 112 103 KB, at hd 80 79 KB. Built
// without -fmad=false: the products are sums in an order the plain version
// does not fix anyway.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // strides: batch, seq, head
  int heads, kv_heads, seq, causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const FlashArgs a) {
  constexpr int QS = HD + 1;
  constexpr int KS = HD + 1;
  constexpr int VS = HD;
  constexpr int PS = kBK + 1;
  constexpr int DC = HD / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                // [kBQ][QS]
  float* ks = qs + kBQ * QS;       // [kBK][KS]
  float* vs = ks + kBK * KS;       // [kBK][VS]
  float* ps = vs + kBK * VS;       // [kBQ][PS]

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.heads / a.kv_heads);
  const int q_start = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  T* o = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[2];

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, s = q_start + r;
    qs[r * QS + d] = s < a.seq ? to_f32(q[s * a.qs[1] + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const int n_tiles = (a.seq + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * kBK;
    // the TPU kernel's tile predicate (uniform over the block)
    if (a.causal && k_start > q_start + kBQ - 1) break;
    if (a.window > 0 && !(k_start + kBK - 1 > q_start - a.window)) continue;

    __syncthreads();               // the last tile's ks, vs, ps are read
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD, s = k_start + r;
      const bool in = s < a.seq;
      ks[r * KS + d] = in ? to_f32(k[s * a.ks[1] + d]) : 0.0f;
      vs[r * VS + d] = in ? to_f32(v[s * a.vs[1] + d]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_start + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (kpos >= a.seq) {
          x = -INFINITY;
        } else {
          bool ok = true;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window > 0) ok = ok && kpos > qpos - a.window;
          if (!ok) x = kNegInf;
        }
        sc[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = vs[j * VS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q_start + ty * 4 + i;
    if (s >= a.seq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(o + s * a.os[1] + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch_hd(const FlashArgs& a, int batch, cudaStream_t st) {
  const int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  auto kern = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + kBQ - 1) / kBQ, a.heads, batch);
  kern<<<grid, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const FlashArgs& a, int hd, int batch, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, batch, st);
    case 32: return launch_hd<T, 32>(a, batch, st);
    case 64: return launch_hd<T, 64>(a, batch, st);
    case 80: return launch_hd<T, 80>(a, batch, st);
    case 112: return launch_hd<T, 112>(a, batch, st);
    case 128: return launch_hd<T, 128>(a, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 = float32, 1 = bfloat16 (q, k, v and out alike). hd: 16, 32, 64,
// 80, 112 or 128. strides: 12 element strides, (batch, seq, head) for q, k,
// v and out in that order; the head dim is contiguous. heads must be a
// multiple of kv_heads. Returns a cudaError_t: the launch's own
// (cudaGetLastError) or cudaErrorInvalidValue for arguments the kernel does
// not take.
extern "C" int flash_attention_launch(
    int kind, int hd, int batch, int heads, int kv_heads, int seq,
    int causal, int window, const void* q, const void* k, const void* v,
    void* o, const long long* strides, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || seq < 1 ||
      heads % kv_heads != 0 || batch > 65535 || heads > 65535 || window < 0)
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return launch_t<float>(a, hd, batch, st);
  if (kind == 1) return launch_t<__nv_bfloat16>(a, hd, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
