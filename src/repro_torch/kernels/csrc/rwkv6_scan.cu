// Chunked WKV6 scan (the RWKV6 time-mix recurrence) for Hopper (sm_90a),
// in f32 on the CUDA cores.
//
// Replaces the TPU kernel `_kernel` (:30) of src/repro/kernels/rwkv6_scan.py,
// reached from `rwkv6_scan` (:81, `pallas_call` at :96). Per (batch, head),
// with the f32 state S [hd, hd] (key x value) carried from chunk to chunk
// and, inside a chunk of C steps, the log decays lw (<= 0), their exclusive
// cumulative sum ls (computed as cumsum(lw) - lw, as the TPU kernel does)
// and the chunk's total ls_C:
//   y_i  = (r_i e^{ls_i}) S                                  inter-chunk
//        + sum_{l<i} (sum_d r_id e^{ls_id - c_d} k_ld e^{c_d - ls_(l+1)d}) v_l
//        + (sum_d r_id u_d k_id) v_i                         diagonal bonus
//   S'   = diag(e^{ls_C}) S + sum_l (k_l e^{ls_C - ls_(l+1)})^T v_l
// with c = ls_C / 2: the TPU kernel re-centres both factors of the intra-
// chunk decay at half the chunk's decay, so that each stays within f32 range
// at strong decay (|ls - c| <= |ls_C| / 2); the strictly lower part and the
// diagonal bonus are kept apart, as there. u arrives as f32 (the wrapper
// widens the model's bf16 bonus).
//
// Bound. At one rwkv6-7b layer of the serve path (B 4, T 512, 64 heads of
// 64, chunk 32, bf16 r/k/v/y, f32 log decay and state) the scan does
// 2 (2 hd^2 + (C + 1) hd) f32 operations per token and head (the inter-
// chunk term and the state update, hd^2 multiply-adds each; the strictly
// lower scores, the diagonal bonus and their product with v, (C + 1) hd),
// 2.70 GFLOP, 0.040 ms at the card's 67 TFLOP/s f32 rate, and moves
// 0.109 GB (0.033 ms at 3.35 TB/s): operations bound it.
//
// Design. One block of 256 threads per (head, batch); the chunk loop runs
// in order inside the block, as the TPU's sequential grid axis did, and the
// state stays in shared memory for the whole sequence. Each chunk: load r,
// k, v (widened to f32) and lw into shared memory; one thread per channel
// takes the cumulative sum over the chunk; every (step, channel) element
// then gets its four decayed factors (r e^{ls}, r e^{ls-c}, k e^{c-ls'},
// k e^{ls_C-ls'}); the lower triangle of the C x C intra-chunk matrix (its
// diagonal the bonus, zeros above), the C x hd outputs and the
// hd x hd state update are each spread over the block's threads, one output
// element per thread and step of a strided loop. Rows of the [C, hd] arrays
// are padded by one word, so that threads reading a column of one (the
// intra-chunk matrix reads k by rows l) hit distinct banks. At hd 64 and
// C 32 a block holds 94 KB of shared memory (dynamic, opted in).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
  int heads, steps, hd, chunk;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

long long smem_floats(int hd, int chunk) {
  const long long rows = static_cast<long long>(chunk) * (hd + 1);
  return 9 * rows + static_cast<long long>(chunk) * (chunk + 1) +
         static_cast<long long>(hd) * hd + 2LL * hd + chunk;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rwkv6_scan_kernel(const ScanArgs a) {
  extern __shared__ float sm[];
  const int hd = a.hd, C = a.chunk, P = hd + 1;
  float* R = sm;               // [C][P] each
  float* K = R + C * P;
  float* V = K + C * P;
  float* LW = V + C * P;
  float* LS = LW + C * P;
  float* RS = LS + C * P;      // r e^{ls}
  float* RD = RS + C * P;      // r e^{ls - c}
  float* KD = RD + C * P;      // k e^{c - ls'}
  float* KC = KD + C * P;      // k e^{ls_C - ls'}
  float* A = KC + C * P;       // [C][C + 1]
  float* S = A + C * (C + 1);  // [hd][hd]
  float* U = S + hd * hd;      // [hd]
  float* LT = U + hd;          // [hd] ls_C
  float* DG = LT + hd;         // [C] diagonal bonus

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* r = static_cast<const T*>(a.r) + b * a.rs[0] + h * a.rs[1];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1];
  const float* lw = a.lw + b * a.ws[0] + h * a.ws[1];
  T* y = static_cast<T*>(a.y) + b * a.ys[0] + h * a.ys[1];
  const long long sbase = (static_cast<long long>(b) * a.heads + h) * hd * hd;

  for (int idx = tid; idx < hd * hd; idx += kThreads) S[idx] = a.s0[sbase + idx];
  for (int d = tid; d < hd; d += kThreads) U[d] = a.u[h * hd + d];

  for (int c0 = 0; c0 < a.steps; c0 += C) {
    __syncthreads();             // the last chunk is done with every array
    for (int idx = tid; idx < C * hd; idx += kThreads) {
      const int t = idx / hd, d = idx % hd, e = t * P + d;
      const long long tt = c0 + t;
      R[e] = to_f32(r[tt * a.rs[2] + d]);
      K[e] = to_f32(k[tt * a.ks[2] + d]);
      V[e] = to_f32(v[tt * a.vs[2] + d]);
      LW[e] = lw[tt * a.ws[2] + d];
    }
    __syncthreads();
    for (int d = tid; d < hd; d += kThreads) {
      float run = 0.0f;
      for (int t = 0; t < C; ++t) {
        run += LW[t * P + d];
        LS[t * P + d] = run - LW[t * P + d];
      }
      LT[d] = LS[(C - 1) * P + d] + LW[(C - 1) * P + d];
    }
    __syncthreads();
    for (int idx = tid; idx < C * hd; idx += kThreads) {
      const int t = idx / hd, d = idx % hd, e = t * P + d;
      const float ls = LS[e], ls1 = ls + LW[e], lt = LT[d];
      const float c = 0.5f * lt;
      RS[e] = R[e] * expf(ls);
      RD[e] = R[e] * expf(ls - c);
      KD[e] = K[e] * expf(c - ls1);
      KC[e] = K[e] * expf(lt - ls1);
    }
    for (int i = tid; i < C; i += kThreads) {
      float s = 0.0f;
      for (int d = 0; d < hd; ++d) s += R[i * P + d] * U[d] * K[i * P + d];
      DG[i] = s;
    }
    __syncthreads();
    for (int idx = tid; idx < C * C; idx += kThreads) {
      const int i = idx / C, l = idx % C;
      float s = 0.0f;
      if (l < i) {
        for (int d = 0; d < hd; ++d) s += RD[i * P + d] * KD[l * P + d];
      } else if (l == i) {
        s = DG[i];
      }
      A[i * (C + 1) + l] = s;
    }
    __syncthreads();
    for (int idx = tid; idx < C * hd; idx += kThreads) {
      const int i = idx / hd, vc = idx % hd;
      float inter = 0.0f, intra = 0.0f;
      for (int d = 0; d < hd; ++d) inter += RS[i * P + d] * S[d * hd + vc];
      for (int l = 0; l <= i; ++l) intra += A[i * (C + 1) + l] * V[l * P + vc];
      store(y + (c0 + i) * a.ys[2] + vc, inter + intra);
    }
    __syncthreads();             // every read of the chunk's input state
    for (int idx = tid; idx < hd * hd; idx += kThreads) {
      const int d = idx / hd, vc = idx % hd;
      float s = 0.0f;
      for (int l = 0; l < C; ++l) s += KC[l * P + d] * V[l * P + vc];
      S[idx] = expf(LT[d]) * S[idx] + s;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < hd * hd; idx += kThreads) a.s_out[sbase + idx] = S[idx];
}

}  // namespace

// kind: 0 = float32, 1 = bfloat16 (r, k, v and y alike). strides: 15 element
// strides, (batch, head, time) for r, k, v, log_w and y in that order; the
// head dim is contiguous. steps must be a multiple of chunk. Returns a
// cudaError_t: the launch's own (cudaGetLastError) or cudaErrorInvalidValue
// for arguments the kernel does not take (a chunk and head dim whose arrays
// exceed the block's shared memory among them).
extern "C" int rwkv6_scan_launch(
    int kind, int batch, int heads, int steps, int hd, int chunk,
    const void* r, const void* k, const void* v, const float* lw,
    const float* u, const float* s0, void* y, float* s_out,
    const long long* strides, void* stream) {
  if (batch < 1 || heads < 1 || steps < 1 || hd < 1 || chunk < 1 ||
      steps % chunk != 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bytes = smem_floats(hd, chunk) * 4;
  if (bytes > max_smem) return static_cast<int>(cudaErrorInvalidValue);
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
  a.hd = hd;
  a.chunk = chunk;
  const dim3 grid(heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    err = cudaFuncSetAttribute(rwkv6_scan_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    rwkv6_scan_kernel<float><<<grid, kThreads, bytes, st>>>(a);
  } else if (kind == 1) {
    err = cudaFuncSetAttribute(rwkv6_scan_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    rwkv6_scan_kernel<__nv_bfloat16><<<grid, kThreads, bytes, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
