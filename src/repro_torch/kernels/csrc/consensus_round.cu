// Fused consensus-ADMM round over the flat [J, total] buffers, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/consensus_update.py, both
// reached from `consensus_round` at :380:
//   * `_round_kernel` (:141), the ungated round -> consensus_round_kernel;
//   * `_round_kernel_masked` (:221), the edge-gated round of the dynamic
//     topology with the optional zero-kick -> consensus_round_masked_kernel;
// each with per-leaf scales (native and int8 wires) or per-block scales
// (`scales_per_block`, the fp8 wires: `li = b if per_block` at :147, :231).
// The whole-row `_row_kernel` (:175) and `_row_kernel_masked` (:269) are
// the same functions under another TPU tiling and need no kernel of their
// own.
//
// For node i, layout block b and graph offsets d = 0..deg-1:
//   x_d    = float(wire[d, i, :]) * scales[d, i, s(b)]
//            s(b) = b with per-block scales, block_leaf[b] otherwise
//   nbr_w  = sum_d e_sym[d, i] * x_d        nbr_p = sum_d x_d  (increasing d)
//   bar    = nbr_p * (1 / deg)              nbr   = nbr_w / max(eta_sum, 1e-12)
//   theta' = theta - alpha (2 lam + eta_sum (theta - nbr))
//   lam'   = lam + (0.5 eta_sum) (theta' - nbr)
//   rsq[i, b] = sum (theta' - bar)^2               (f32 theta', before rounding)
//   ssq[i, b] = eta_node^2 * sum (bar - bar_prev)^2
// The edge-gated round (MASKED) takes per-(d, i) gates bar_w and a per-node
// inv_deg (1 / active degree, 0 for an isolated or ghost node):
//   nbr_p  = sum_d bar_w[d, i] * x_d        bar = nbr_p * inv_deg[i]
// and with KICK the per-(d, i) zero-kick weights kick_w:
//   kick_x = sum_d kick_w[d, i] * x_d       ksum = sum_d kick_w[d, i]
//   lam'   = lam' + 0.5 (ksum * theta - kick_x)      (round-start theta)
// The kick term is compiled only when kick_w is passed: adding 0.0 would
// turn a -0.0 dual into +0.0.
// theta' is stored in theta's dtype over theta, lam' over lam and bar (f32)
// over bar_prev: each element is read and then written by the same thread,
// so the update is safe in place. The wires must not alias any of them.
// block_leaf holds ids in [0, scale_width): the flat layout's table does by
// construction, and its owner checks it once where it builds the table.
// Every wire type upcasts to f32 exactly: bf16 and int8 trivially, fp8
// (e4m3fn, e5m2) through the hardware's fp8x2 -> f16x2 conversion, whose
// results are all exact in f16 and so in f32.
//
// Bound. Every element is touched once: read theta (2 B bf16), lam (4 B),
// bar_prev (4 B) and deg wire rows (2 B bf16 or 1 B int8 each); write
// theta' (2 B), lam' (4 B) and bar (4 B). The gated round moves the same
// bytes (its gates are [deg, J] scalars); an fp8 wire row is 1 B. At the
// trainer's full-width
// qwen3-4b shape (J = 2, deg = 1, bf16 theta and wire, 1,181,941,760
// elements per row) that is 22 B/element, about 52.0 GB per round, or about
// 15.5 ms at the H100's 3.35 TB/s. The arithmetic (about 20 f32 operations
// per element) is far below the card's rate, so the kernel is bound by the
// bytes it moves and nothing else.
//
// Design. A first, simple, memory-bound version: grid (nblocks, J), one CUDA
// block of 256 threads per (layout block, node). Each thread walks its block
// with 16-byte vector loads (8 elements per step), keeps nothing but the
// running residual partials, and the block reduces them with warp shuffles
// and shared memory into the [J, nblocks] partials; the wrapper sums those
// per node. The TPU kept the per-node scalars and the block->leaf table in
// SMEM via scalar prefetch; here each block reads its leaf id and scalars
// once from device memory. Tens of thousands of blocks of 64k elements give
// every SM plenty of independent loads in flight, which is what a streaming
// kernel needs; TMA pipelines or persistent blocks are later work.
//
// The gated kernel is the same body with two compile-time flags, MASKED and
// KICK; with both off it is the ungated kernel, instruction for
// instruction. Each block reads its node's gates as it reads e_sym.
// Per-block scales are a run-time flag, uniform over the launch: each block
// picks its scale column once (b or block_leaf[b]), as the TPU kernel reads
// one SMEM scalar, so the fp8 wires add wire types and no template axis.
//
// The file is compiled with -fmad=false so that the kernel rounds after
// every multiply and add exactly as the plain PyTorch version does; the cost
// is nil for a kernel bound by memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements per thread per step: 16 B of bf16

struct RoundArgs {
  const void* wires;       // [deg, J, total], theta's dtype, int8 or fp8
  const float* scales;     // [deg, J, scale_width]
  const int* block_leaf;   // [nblocks] (per-leaf scales only)
  const float* e_sym;      // [deg, J]
  const float* alpha;      // [J]
  const float* eta_sum;    // [J]
  const float* eta_node;   // [J]
  const float* bar_w;      // [deg, J] edge gates (MASKED only)
  const float* inv_deg;    // [J] 1 / active degree (MASKED only)
  const float* kick_w;     // [deg, J] zero-kick weights (KICK only)
  void* theta;             // [J, total] in/out
  float* lam;              // [J, total] in/out
  float* bar;              // [J, total] in: bar_prev, out: bar
  float* rsq;              // [J, nblocks] out
  float* ssq;              // [J, nblocks] out
  long long total;
  int J;
  int deg;
  int block_size;
  int scale_width;         // nleaves, or nblocks with per-block scales
  int scales_per_block;    // 1: block b reads scale column b
};

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = static_cast<float>(c[k]);
}

// fp8: one 8-byte load, then four hardware fp8x2 -> f16x2 conversions (the
// low byte of each pair is the first element)
template <__nv_fp8_interpretation_t KIND>
__device__ __forceinline__ void load8_fp8(const void* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const unsigned int w[2] = {u.x, u.y};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_fp8x2_storage_t pair =
        static_cast<__nv_fp8x2_storage_t>(w[k >> 1] >> (16 * (k & 1)));
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(pair, KIND));
    const float2 f = __half22float2(h);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* out) {
  load8_fp8<__NV_E4M3>(p, out);
}

__device__ __forceinline__ void load8(const __nv_fp8_e5m2* p, float* out) {
  load8_fp8<__NV_E5M2>(p, out);
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// TT: theta's type (float or bf16); WT: the wire's (TT, int8 or fp8).
// DEG > 0 unrolls the offset loop at compile time; DEG == 0 loops over
// a.deg at run time. MASKED: the edge-gated round; KICK (MASKED only): the
// zero-kick dual term.
template <typename TT, typename WT, int DEG, bool MASKED, bool KICK>
__device__ __forceinline__ void round_body(const RoundArgs& a) {
  static_assert(MASKED || !KICK, "the kick needs the gated round");
  const int deg = DEG > 0 ? DEG : a.deg;
  const int b = blockIdx.x;
  const int i = blockIdx.y;
  const int nblocks = gridDim.x;
  const int col = a.scales_per_block ? b : a.block_leaf[b];
  const float alpha = a.alpha[i];
  const float eta_sum = a.eta_sum[i];
  const float eta_node = a.eta_node[i];
  const float eta_div = fmaxf(eta_sum, 1e-12f);
  const float half_eta = 0.5f * eta_sum;
  const float inv_deg = MASKED ? a.inv_deg[i] : 1.0f / static_cast<float>(deg);
  float ksum = 0.0f;
  if constexpr (KICK) {
    for (int d = 0; d < deg; ++d) ksum = ksum + a.kick_w[d * a.J + i];
  }
  const long long row = static_cast<long long>(i) * a.total
                        + static_cast<long long>(b) * a.block_size;
  const long long wire_stride = static_cast<long long>(a.J) * a.total;

  TT* theta = static_cast<TT*>(a.theta) + row;
  float* lam = a.lam + row;
  float* bar = a.bar + row;
  const WT* wires = static_cast<const WT*>(a.wires) + row;

  float r_acc = 0.0f, s_acc = 0.0f;
  for (int e0 = threadIdx.x * kVec; e0 < a.block_size; e0 += kThreads * kVec) {
    float th[kVec], lm[kVec], bp[kVec];
    float nw[kVec], np[kVec], kx[kVec];
    load8(theta + e0, th);
    load8(lam + e0, lm);
    load8(bar + e0, bp);
#pragma unroll
    for (int k = 0; k < kVec; ++k) { nw[k] = 0.0f; np[k] = 0.0f; kx[k] = 0.0f; }
    // deg is a compile-time constant when DEG > 0, and the loop unrolls
#pragma unroll 4
    for (int d = 0; d < deg; ++d) {
      const float sc = a.scales[(static_cast<long long>(d) * a.J + i) * a.scale_width + col];
      const float ew = a.e_sym[d * a.J + i];
      const float bw = MASKED ? a.bar_w[d * a.J + i] : 1.0f;
      const float kw = KICK ? a.kick_w[d * a.J + i] : 0.0f;
      float x[kVec];
      load8(wires + d * wire_stride + e0, x);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float xv = x[k] * sc;
        nw[k] = nw[k] + ew * xv;
        if constexpr (MASKED) np[k] = np[k] + bw * xv;
        else np[k] = np[k] + xv;
        if constexpr (KICK) kx[k] = kx[k] + kw * xv;
      }
    }
    float tn[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float barv = np[k] * inv_deg;
      const float nbr = nw[k] / eta_div;
      tn[k] = th[k] - alpha * (2.0f * lm[k] + eta_sum * (th[k] - nbr));
      lm[k] = lm[k] + half_eta * (tn[k] - nbr);
      if constexpr (KICK) lm[k] = lm[k] + 0.5f * (ksum * th[k] - kx[k]);
      const float dr = tn[k] - barv;
      r_acc = r_acc + dr * dr;
      const float db = barv - bp[k];
      s_acc = s_acc + db * db;
      bp[k] = barv;
    }
    store8(theta + e0, tn);
    store8(lam + e0, lm);
    store8(bar + e0, bp);
  }

  __shared__ float red[2][kThreads / 32];
  r_acc = warp_sum(r_acc);
  s_acc = warp_sum(s_acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = r_acc;
    red[1][warp] = s_acc;
  }
  __syncthreads();
  if (warp == 0) {
    r_acc = lane < kThreads / 32 ? red[0][lane] : 0.0f;
    s_acc = lane < kThreads / 32 ? red[1][lane] : 0.0f;
    r_acc = warp_sum(r_acc);
    s_acc = warp_sum(s_acc);
    if (lane == 0) {
      const long long p = static_cast<long long>(i) * nblocks + b;
      a.rsq[p] = r_acc;
      a.ssq[p] = (eta_node * eta_node) * s_acc;
    }
  }
}

// The ungated round (TPU `_round_kernel`).
template <typename TT, typename WT, int DEG>
__global__ void __launch_bounds__(kThreads) consensus_round_kernel(const RoundArgs a) {
  round_body<TT, WT, DEG, false, false>(a);
}

// The edge-gated round, with or without the zero-kick (TPU
// `_round_kernel_masked`).
template <typename TT, typename WT, int DEG, bool KICK>
__global__ void __launch_bounds__(kThreads) consensus_round_masked_kernel(const RoundArgs a) {
  round_body<TT, WT, DEG, true, KICK>(a);
}

template <typename TT, typename WT>
void launch_typed(const RoundArgs& a, dim3 grid, cudaStream_t stream) {
  switch (a.deg) {
    case 1: consensus_round_kernel<TT, WT, 1><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: consensus_round_kernel<TT, WT, 2><<<grid, kThreads, 0, stream>>>(a); break;
    case 3: consensus_round_kernel<TT, WT, 3><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: consensus_round_kernel<TT, WT, 4><<<grid, kThreads, 0, stream>>>(a); break;
    default: consensus_round_kernel<TT, WT, 0><<<grid, kThreads, 0, stream>>>(a); break;
  }
}

template <typename TT, typename WT, bool KICK>
void launch_masked(const RoundArgs& a, dim3 grid, cudaStream_t stream) {
  switch (a.deg) {
    case 1: consensus_round_masked_kernel<TT, WT, 1, KICK><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: consensus_round_masked_kernel<TT, WT, 2, KICK><<<grid, kThreads, 0, stream>>>(a); break;
    case 3: consensus_round_masked_kernel<TT, WT, 3, KICK><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: consensus_round_masked_kernel<TT, WT, 4, KICK><<<grid, kThreads, 0, stream>>>(a); break;
    default: consensus_round_masked_kernel<TT, WT, 0, KICK><<<grid, kThreads, 0, stream>>>(a); break;
  }
}

template <typename TT, typename WT>
void launch_any(const RoundArgs& a, dim3 grid, cudaStream_t stream) {
  if (a.bar_w == nullptr) launch_typed<TT, WT>(a, grid, stream);
  else if (a.kick_w == nullptr) launch_masked<TT, WT, false>(a, grid, stream);
  else launch_masked<TT, WT, true>(a, grid, stream);
}

}  // namespace

// theta_kind: 0 = float32, 1 = bfloat16.  wire_kind: 0 = theta's dtype,
// 1 = int8, 2 = float8_e4m3fn, 3 = float8_e5m2. scales_per_block: 1 = the
// scale rows are [deg, J, nblocks] and block b reads column b (scale_width
// must be nblocks; block_leaf is not read), 0 = per-leaf rows through
// block_leaf. bar_w and inv_deg (both or neither) select the gated round;
// kick_w (gated round only) adds the zero-kick; null pointers leave them
// out. Returns a cudaError_t: the launch's own (cudaGetLastError) or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int consensus_round_launch(
    int theta_kind, int wire_kind, int J, int deg, long long total,
    int block_size, int scale_width, int scales_per_block,
    const void* wires, const float* scales,
    const int* block_leaf, const float* e_sym, const float* alpha,
    const float* eta_sum, const float* eta_node, const float* bar_w,
    const float* inv_deg, const float* kick_w, void* theta, float* lam,
    float* bar, float* rsq, float* ssq, void* stream) {
  if (J < 1 || J > 65535 || deg < 1 || block_size < kVec
      || block_size % kVec != 0 || total % block_size != 0 || scale_width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((bar_w == nullptr) != (inv_deg == nullptr)
      || (kick_w != nullptr && bar_w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks = total / block_size;
  if (nblocks < 1 || nblocks > 0x7fffffffLL
      || (scales_per_block != 0 && scale_width != nblocks))
    return static_cast<int>(cudaErrorInvalidValue);
  RoundArgs a{wires, scales, block_leaf, e_sym, alpha, eta_sum, eta_node,
              bar_w, inv_deg, kick_w,
              theta, lam, bar, rsq, ssq, total, J, deg, block_size,
              scale_width, scales_per_block != 0 ? 1 : 0};
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(J));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (theta_kind == 0 && wire_kind == 0) launch_any<float, float>(a, grid, st);
  else if (theta_kind == 0 && wire_kind == 1) launch_any<float, int8_t>(a, grid, st);
  else if (theta_kind == 0 && wire_kind == 2) launch_any<float, __nv_fp8_e4m3>(a, grid, st);
  else if (theta_kind == 0 && wire_kind == 3) launch_any<float, __nv_fp8_e5m2>(a, grid, st);
  else if (theta_kind == 1 && wire_kind == 0) launch_any<__nv_bfloat16, __nv_bfloat16>(a, grid, st);
  else if (theta_kind == 1 && wire_kind == 1) launch_any<__nv_bfloat16, int8_t>(a, grid, st);
  else if (theta_kind == 1 && wire_kind == 2) launch_any<__nv_bfloat16, __nv_fp8_e4m3>(a, grid, st);
  else if (theta_kind == 1 && wire_kind == 3) launch_any<__nv_bfloat16, __nv_fp8_e5m2>(a, grid, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
