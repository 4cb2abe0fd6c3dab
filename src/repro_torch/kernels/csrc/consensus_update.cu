// Flat consensus-ADMM update over [N] vectors with a precomputed neighbor
// mean, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` (:74) of
// src/repro/kernels/consensus_update.py, reached from `consensus_update`
// (:96): the round's prox pull, dual update and residual partials without
// the exchange, on flat vectors.
//
// For element e of layout block b (blocks of block_size elements; the last
// one is short when N is not a multiple):
//   theta' = theta - step (2 lam + eta_sum (theta - nbr))
//   lam'   = lam + (0.5 eta_sum) (theta' - nbr)
//   rsq[b] = sum (theta' - bar)^2                  (f32 theta', before rounding)
//   ssq[b] = eta_node^2 * sum (bar - bar_prev)^2
// The wrapper sums the [nblocks] partials, the reference's order (block
// partials first). The TPU kernel zero-padded N to a block multiple, which
// adds exactly 0 to both sums; here the short block stops at N instead, so
// no padded copy is made. theta' is stored in theta's dtype over theta and
// lam' in lam's dtype over lam: each element is read and then written by the
// same thread, so the update is safe in place.
//
// Bound. Every element is read once from five vectors and written once to
// two: at f32 that is 28 B per element, about 33.1 GB for one full-width
// 4-layer qwen3-4b row of 1,181,941,760 elements, or about 9.9 ms at the
// H100's 3.35 TB/s. About 14 f32 operations per element are far below the
// card's rate: the kernel is bound by the bytes it moves.
//
// Design. The round kernel's (consensus_round.cu): a grid over blocks, 256
// threads per block, 16-byte vector loads of 8 elements; a thread finishes
// the tail of the short block element by element. Each block reduces its
// partials with warp shuffles and shared memory and writes its own pair, so
// there are no atomics. The scalars (eta_sum, eta_node, step) are read once
// per block from a [3] f32 vector on the card, as the TPU read them from
// SMEM, so the caller needs no host sync. Compiled with -fmad=false, so
// that theta' and lam' round after every multiply and add exactly as the
// plain PyTorch version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements per thread per step: 16 B of bf16

struct UpdateArgs {
  const float* nbr;        // [N]
  const float* bar;        // [N]
  const float* bar_prev;   // [N]
  const float* scalars;    // [3]: eta_sum, eta_node, step
  void* theta;             // [N] in/out
  void* lam;               // [N] in/out
  float* rsq;              // [nblocks] out
  float* ssq;              // [nblocks] out
  long long n;
  int block_size;
};

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

struct Step {
  float eta_sum, half_eta, step;

  // one element: theta, lam in; theta', lam' out; the partials accumulate
  __device__ __forceinline__ void apply(float& th, float& lm, float nb,
                                        float br, float bp, float& r_acc,
                                        float& s_acc) const {
    const float tn = th - step * (2.0f * lm + eta_sum * (th - nb));
    lm = lm + half_eta * (tn - nb);
    th = tn;
    const float dr = tn - br;
    r_acc = r_acc + dr * dr;
    const float db = br - bp;
    s_acc = s_acc + db * db;
  }
};

// TT: theta's type, LT: lam's (float or bf16).
template <typename TT, typename LT>
__global__ void __launch_bounds__(kThreads) consensus_update_kernel(const UpdateArgs a) {
  const int b = blockIdx.x;
  const long long start = static_cast<long long>(b) * a.block_size;
  const long long left = a.n - start;
  const int len = left < a.block_size ? static_cast<int>(left) : a.block_size;
  const float eta_sum = a.scalars[0];
  const float eta_node = a.scalars[1];
  const Step st{eta_sum, 0.5f * eta_sum, a.scalars[2]};

  TT* theta = static_cast<TT*>(a.theta) + start;
  LT* lam = static_cast<LT*>(a.lam) + start;
  const float* nbr = a.nbr + start;
  const float* bar = a.bar + start;
  const float* bar_prev = a.bar_prev + start;

  float r_acc = 0.0f, s_acc = 0.0f;
  for (int e0 = threadIdx.x * kVec; e0 < len; e0 += kThreads * kVec) {
    if (e0 + kVec <= len) {
      float th[kVec], lm[kVec], nb[kVec], br[kVec], bp[kVec];
      load8(theta + e0, th);
      load8(lam + e0, lm);
      load8(nbr + e0, nb);
      load8(bar + e0, br);
      load8(bar_prev + e0, bp);
#pragma unroll
      for (int k = 0; k < kVec; ++k) st.apply(th[k], lm[k], nb[k], br[k], bp[k], r_acc, s_acc);
      store8(theta + e0, th);
      store8(lam + e0, lm);
    } else {                 // the short block's last few elements
      for (int e = e0; e < len; ++e) {
        float th = load1(theta + e), lm = load1(lam + e);
        st.apply(th, lm, nbr[e], bar[e], bar_prev[e], r_acc, s_acc);
        store1(theta + e, th);
        store1(lam + e, lm);
      }
    }
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
      a.rsq[b] = r_acc;
      a.ssq[b] = (eta_node * eta_node) * s_acc;
    }
  }
}

}  // namespace

// theta_kind, lam_kind: 0 = float32, 1 = bfloat16. block_size must be a
// multiple of 8 unless it covers all of n (one block); the vectors must be
// 16-byte aligned. Returns a cudaError_t: the launch's own
// (cudaGetLastError) or cudaErrorInvalidValue for arguments the kernel does
// not take.
extern "C" int consensus_update_launch(
    int theta_kind, int lam_kind, long long n, int block_size,
    const float* scalars, const float* nbr, const float* bar,
    const float* bar_prev, void* theta, void* lam, float* rsq, float* ssq,
    void* stream) {
  if (n < 1 || block_size < 1 || (block_size % kVec != 0 && block_size < n))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks = (n + block_size - 1) / block_size;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  UpdateArgs a{nbr, bar, bar_prev, scalars, theta, lam, rsq, ssq, n, block_size};
  const dim3 grid(static_cast<unsigned>(nblocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (theta_kind == 0 && lam_kind == 0)
    consensus_update_kernel<float, float><<<grid, kThreads, 0, st>>>(a);
  else if (theta_kind == 0 && lam_kind == 1)
    consensus_update_kernel<float, __nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else if (theta_kind == 1 && lam_kind == 0)
    consensus_update_kernel<__nv_bfloat16, float><<<grid, kThreads, 0, st>>>(a);
  else if (theta_kind == 1 && lam_kind == 1)
    consensus_update_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
