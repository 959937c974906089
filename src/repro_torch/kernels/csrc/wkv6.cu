// Chunked WKV6 scan (the RWKV6 time-mix recurrence), f32 state per head.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py
// (wkv6_chunked, body _wkv6_kernel). Per (batch, head), with
// w_t = exp(wlog_t) and the state S [hd, hd]:
//
//     o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// r/k/v are [B, S, H, hd] in bf16 or f32, wlog [B, S, H, hd] f32, u
// [H, hd] f32; the output is f32 [B, S, H, hd].
//
// Chunked form, C = 32 tokens per chunk, cum = inclusive cumulative sum
// of wlog inside the chunk, cum_ex = cum - wlog, total = cum[C-1]:
//
//     a[t, s] = sum_d r[t,d] k[s,d] exp(cum_ex[t,d] - cum[s,d])   s < t
//     a[t, t] = sum_d r[t,d] u[d] k[t,d]
//     o[t, :] = sum_{s<=t} a[t, s] v[s, :]
//             + sum_d r[t,d] exp(cum_ex[t,d]) S[d, :]
//     S[d, :] = exp(total[d]) S[d, :] + sum_s k[s,d] exp(total[d] - cum[s,d]) v[s, :]
//
// Overflow. The TPU kernel factors the intra-chunk decay as
// (r exp(cum_ex)) . (k exp(-cum)); over a 128-token chunk the model's
// log decay (about -0.7 per step) sums past -88.7, exp(-cum) overflows
// f32 and the product gives inf * 0 = NaN. This kernel uses the pairwise
// form exp(cum_ex[t] - cum[s]) = exp(sum of wlog over s < tau < t) for
// s < t, whose exponent is never positive, at the cost of one exp per
// (t, s, d) instead of one per (t, d): 528 * hd exps per chunk, cheap
// next to the products. The inter-chunk and state-update exponents
// (cum_ex, total - cum, total) are <= 0 already. So no exponent in the
// kernel is positive and the result is finite wherever the recurrence is.
//
// Design. One block of 256 threads per (head, batch); a loop over chunks
// takes the place of the TPU's sequential grid axis. The [hd, hd] f32
// state stays in shared memory across chunks; each chunk is staged in
// shared memory as f32 (rows padded to hd + 1 so that reads strided by a
// row hit distinct banks). Per chunk: prefix sums (one thread per
// column), the weights a (one thread per (t, s)), r and k turned into
// their decayed forms in place, the outputs (one thread per (t, j)), then
// the state update (one thread per (d, j)). Shared memory at hd = 64:
// 62,336 bytes; at hd = 128: 152,704 bytes (set per launch).
//
// Bound on an H100: at the rwkv6-3b prefill shape ([4,1024,40,64], r/k/v
// bf16, wlog and out f32) the call moves ~147 MB and needs ~2.7 GFLOP,
// so bytes bound it (~44 us at 3.35 TB/s). The kernel runs B * H = 160
// blocks, about one per SM, and each walks 32 chunks in order, so it is
// bound by the chunk loop's latency, not by bandwidth. Splitting the
// sequence across blocks (a state pass, then independent chunks) is the
// later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 32;          // tokens per chunk
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kAStride = kC + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t smem_floats(int hd) {
  const size_t hs = hd + 1;
  return 4 * kC * hs + (size_t)kC * hd + (size_t)kC * kAStride + hd +
         (size_t)hd * hd;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ wlog,
                const float* __restrict__ u, float* __restrict__ out, int S,
                int H, int hd) {
  extern __shared__ float smem[];
  const int hs = hd + 1;
  float* sr = smem;              // [kC][hs]  r, then r * exp(cum_ex)
  float* sk = sr + kC * hs;      // [kC][hs]  k, then k * exp(total - cum)
  float* sw = sk + kC * hs;      // [kC][hs]  wlog
  float* sc = sw + kC * hs;      // [kC][hs]  cum (inclusive)
  float* sv = sc + kC * hs;      // [kC][hd]
  float* sa = sv + kC * hd;      // [kC][kAStride] intra-chunk weights
  float* su = sa + kC * kAStride;  // [hd]
  float* st = su + hd;           // [hd][hd] state S[d][j]

  const int tid = threadIdx.x;
  const int hh = blockIdx.x;
  const int b = blockIdx.y;

  for (int i = tid; i < hd * hd; i += kThreads) st[i] = 0.f;
  for (int i = tid; i < hd; i += kThreads) su[i] = u[hh * hd + i];

  for (int t0 = 0; t0 < S; t0 += kC) {
    __syncthreads();  // the previous chunk's state update is done
    for (int i = tid; i < kC * hd; i += kThreads) {
      const int t = i / hd, d = i % hd, tt = t0 + t;
      const bool in = tt < S;  // past S: zero k and wlog add nothing
      const size_t g = ((size_t)(b * (size_t)S + tt) * H + hh) * hd + d;
      sr[t * hs + d] = in ? to_f32(r[g]) : 0.f;
      sk[t * hs + d] = in ? to_f32(k[g]) : 0.f;
      sv[t * hd + d] = in ? to_f32(v[g]) : 0.f;
      sw[t * hs + d] = in ? wlog[g] : 0.f;
    }
    __syncthreads();
    for (int d = tid; d < hd; d += kThreads) {
      float c = 0.f;
      for (int t = 0; t < kC; ++t) {
        c += sw[t * hs + d];
        sc[t * hs + d] = c;
      }
    }
    __syncthreads();
    for (int i = tid; i < kC * kC; i += kThreads) {
      const int t = i / kC, s = i % kC;
      float a = 0.f;
      if (s < t) {
        for (int d = 0; d < hd; ++d) {
          const float e = sc[t * hs + d] - sw[t * hs + d] - sc[s * hs + d];
          a = fmaf(sr[t * hs + d] * sk[s * hs + d], expf(e), a);
        }
      } else if (s == t) {
        for (int d = 0; d < hd; ++d)
          a = fmaf(sr[t * hs + d], su[d] * sk[t * hs + d], a);
      }
      sa[t * kAStride + s] = a;
    }
    __syncthreads();
    for (int i = tid; i < kC * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      const float c = sc[t * hs + d];
      sr[t * hs + d] *= expf(c - sw[t * hs + d]);
      sk[t * hs + d] *= expf(sc[(kC - 1) * hs + d] - c);
    }
    __syncthreads();
    for (int i = tid; i < kC * hd; i += kThreads) {
      const int t = i / hd, j = i % hd;
      if (t0 + t >= S) continue;
      float o = 0.f;
      for (int s = 0; s <= t; ++s) o = fmaf(sa[t * kAStride + s], sv[s * hd + j], o);
      for (int d = 0; d < hd; ++d) o = fmaf(sr[t * hs + d], st[d * hd + j], o);
      out[((size_t)(b * (size_t)S + t0 + t) * H + hh) * hd + j] = o;
    }
    __syncthreads();  // every output has read the old state
    for (int i = tid; i < hd * hd; i += kThreads) {
      const int d = i / hd, j = i % hd;
      float s_new = expf(sc[(kC - 1) * hs + d]) * st[i];
      for (int s = 0; s < kC; ++s) s_new = fmaf(sk[s * hs + d], sv[s * hd + j], s_new);
      st[i] = s_new;
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* wlog,
           const float* u, float* out, int B, int S, int H, int hd,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(hd);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  wkv6_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), wlog, u, out, S, H, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of r, k and v: 0 = float32, 1 = bfloat16. wlog, u and out are
// float32. Returns a cudaError_t; 1001 for an unsupported argument.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* wlog, const void* u, void* out, int B,
                           int S, int H, int hd, int dtype, void* stream) {
  if (hd < 1 || hd > kMaxHd) return 1001;
  if (B == 0 || S == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(wlog);
  const float* uu = static_cast<const float*>(u);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(r, k, v, w, uu, o, B, S, H, hd, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, uu, o, B, S, H, hd, s);
  return 1001;
}
