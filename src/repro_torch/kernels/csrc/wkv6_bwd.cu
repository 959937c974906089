// The gradient of the chunked WKV6 scan (csrc/wkv6.cu), f32 arithmetic,
// split over the sequence into four passes.
//
// Replaces no Pallas kernel: the JAX package trains RWKV6 by jax.grad
// through its jnp chunked form (src/repro/models/ssm.py, rwkv6_chunked),
// whose gradient overflows f32 where its forward does. Per (batch, head),
// with w_t = exp(wlog_t), the state S [hd, hd] and
//
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,
//     o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t),
//
// given do = dL/do (f32 [B, S, H, hd]) it writes dr, dk, dv in the dtype
// of r/k/v (f32 or bf16), dwlog f32 [B, S, H, hd] and du f32 [H, hd]
// (summed over batch and sequence).
//
// Chunked form, C = 32 tokens a chunk c, cum / cum_ex / total as in the
// forward, S_c the state entering chunk c (the forward's workspace holds
// it), G_c the gradient of the state leaving chunk c (G_last = 0),
// A[t, s] = do_t . v_s, att[t, s] the forward's intra-chunk weights:
//
//     G_{c-1}  = diag(2^total_c) G_c + sum_t (r_t 2^cum_ex_t)^T do_t
//     dr_t     = sum_{s<t} k_s 2^(cum_ex_t - cum_s) A[t,s]
//                + 2^cum_ex_t (S_c do_t) + u k_t A[t,t]
//     dk_s     = sum_{t>s} r_t 2^(cum_ex_t - cum_s) A[t,s]
//                + 2^(total - cum_s) (G_c v_s) + u r_s A[s,s]
//     dv_s     = sum_{t>=s} att[t,s] do_t + (k_s 2^(total - cum_s)) G_c
//     du       = sum r_t k_t A[t,t]
//     dwlog_i  = sum_{t>i in c} f_t - h_i + sum_j G_c[., j] S_{c+1}[., j]
//
// with h_t = k_t (dk_t - u r_t A[t,t]) and f_t = r_t (dr_t - u k_t A[t,t])
// - h_t (products by column). dwlog_i is the sum over the (t, s) pairs
// with s < i < t, the pairs whose decay passes through token i; the
// identity keeps each sum inside one chunk (the pairs that straddle the
// chunk's end come in through S_{c+1}), so no sum cancels terms from the
// rest of the sequence. kernels/ref.py::wkv6_chunked_bwd_plain is the same
// arithmetic in plain PyTorch.
//
// Passes, all launched by one wkv6_bwd_launch call on the caller's stream:
//
// 1. wkv6bwd_adjoint_kernel: one block per (chunk, head, batch) for every
//    chunk but the first writes the chunk's term of G_{c-1} and the
//    chunk's decay 2^total into workspace slot c - 1;
// 2. wkv6bwd_scan_kernel: one thread per (batch, head, d, j) state element
//    scans the slots from the last to the first, G_{c-1} = 2^total_c G_c +
//    term, in place;
// 3. wkv6bwd_grad_kernel: one block per (chunk, head, batch) computes the
//    chunk's dr, dk, dv and dwlog from its inputs, S_c, G_c and S_{c+1},
//    and its partial of du into the workspace;
// 4. wkv6bwd_du_kernel: one thread per (head, d) sums the partials of du
//    over batch, then chunk.
//
// Deterministic: no atomics, every sum in a fixed order, so two calls on
// the same inputs write the same bytes (replicas that train on one log
// stay bitwise equal). Every exponent is <= 0 (a later cum minus an
// earlier one; cum falls monotonically through a chunk, being a rounded
// running sum of non-positive terms): the result is finite wherever the
// recurrence's gradient is. f32 FFMA on the CUDA cores; 2^x is
// ex2.approx on log2(e)-scaled sums.
//
// Bound on an H100: at the rwkv6-3b train microbatch [1, 4096, 40, 64],
// r/k/v bf16, the function reads r, k, v, wlog, do, u and the forward's
// states (83.2 MB) once and writes dr, dk, dv, dwlog and du once, ~335 MB:
// ~100 us at 3.35 TB/s. It needs ~8 GFLOP (12 hd^2 flops a token and
// head), so bytes bound it. This first kernel is simple: pass 3 takes one
// exp per (t, s, d) pair, three times (the weights, dr, dk), and holds
// S_c, G_c and S_{c+1} in shared memory one after another, so its blocks
// re-read ~48 KB of states each beside ~29 KB of inputs; the workspace
// (written by pass 1, read and written by pass 2) adds ~250 MB more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 32;           // tokens per chunk (the forward's kC)
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kScanUnroll = 8;   // slot loads in flight per scan thread
constexpr float kLog2e = 1.4426950408889634f;

// the padded head width a head dim runs at: 32, 64 or 128
int width(int hd) { return hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

__device__ __forceinline__ size_t offset(int b, int t, int h, int d, int S,
                                         int H, int hd) {
  return ((static_cast<size_t>(b) * S + t) * H + h) * hd + d;
}

// 2^x on the special-function unit (ex2.approx.ftz.f32, about 2 ulp);
// every x here is <= 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// The log2-scaled inclusive cumulative decay of column x of chunk t0, token
// by token (tokens past S and columns past hd add 0), into cum[t * stride].
__device__ __forceinline__ void cumsum_column(const float* __restrict__ wlog,
                                              int b, int t0, int h, int x,
                                              int S, int H, int hd,
                                              float* cum, int stride) {
  float sum = 0.f;
  for (int t = 0; t < kC; ++t) {
    if (t0 + t < S && x < hd)
      sum += wlog[offset(b, t0 + t, h, x, S, H, hd)] * kLog2e;
    cum[t * stride] = sum;
  }
}

// Pass 1. Chunk c = blockIdx.x + 1 of head h, batch b: adj[d, j] = sum_t
// r[t,d] 2^cum_ex[t,d] do[t,j] and decay[d] = 2^total[d], in slot c - 1.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    wkv6bwd_adjoint_kernel(const T* __restrict__ r,
                           const float* __restrict__ wlog,
                           const float* __restrict__ dout,
                           float* __restrict__ adj, float* __restrict__ decay,
                           int S, int H, int hd, int slots) {
  extern __shared__ float smem[];
  float* sq = smem;          // [kC][W] r, then r 2^cum_ex
  float* sd = sq + kC * W;   // [kC][W] do
  float* sc = sd + kC * W;   // [kC][W] cumsum of the log2 decay
  const int c = blockIdx.x + 1, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, t0 = c * kC;
  const size_t slot = (static_cast<size_t>(b) * H + h) * slots + c - 1;
  for (int i = tid; i < kC * W; i += kThreads) {
    const int t = i / W, d = i % W;
    const bool in = t0 + t < S && d < hd;
    const size_t o = in ? offset(b, t0 + t, h, d, S, H, hd) : 0;
    sq[i] = in ? to_f32(r[o]) : 0.f;
    sd[i] = in ? dout[o] : 0.f;
  }
  for (int d = tid; d < W; d += kThreads)
    cumsum_column(wlog, b, t0, h, d, S, H, hd, sc + d, W);
  __syncthreads();
  for (int i = tid; i < kC * W; i += kThreads) {
    const int t = i / W, d = i % W;
    sq[i] *= ex2(t > 0 ? sc[i - W] : 0.f);
    if (t == kC - 1) decay[slot * W + d] = ex2(sc[i]);
  }
  __syncthreads();
  // element (d, j): a warp reads one row of sq (a broadcast) and 32
  // consecutive columns of sd
  float* dst = adj + slot * W * W;
  for (int e = tid; e < W * W; e += kThreads) {
    const int d = e / W, j = e % W;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < kC; ++t) acc = fmaf(sq[t * W + d], sd[t * W + j], acc);
    dst[e] = acc;
  }
}

// Pass 2. Element i of the [W, W] state gradient of one (batch, head):
// from the last slot to the first, g = decay[c] g + adj[c], written over
// adj[c] (slot c then holds G_c, the gradient of the state leaving chunk c).
__global__ void __launch_bounds__(kThreads)
    wkv6bwd_scan_kernel(float* __restrict__ adj,
                        const float* __restrict__ decay, int BH, int W,
                        int slots) {
  const size_t ww = static_cast<size_t>(W) * W;
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= BH * ww) return;
  const size_t bh = e / ww, i = e % ww;
  float* g = adj + bh * slots * ww + i;
  const float* dec = decay + bh * slots * W + i / W;
  float acc = 0.f;
  for (int c1 = slots - 1; c1 >= 0; c1 -= kScanUnroll) {
    float x[kScanUnroll], w[kScanUnroll];
#pragma unroll
    for (int q = 0; q < kScanUnroll; ++q) {
      const int c = c1 - q;
      x[q] = c >= 0 ? g[c * ww] : 0.f;
      w[q] = c >= 0 ? dec[c * W] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kScanUnroll; ++q) {
      if (c1 - q >= 0) {
        acc = fmaf(w[q], acc, x[q]);
        g[(c1 - q) * ww] = acc;
      }
    }
  }
}

// Pass 3's shared memory, in floats: five [kC][W] tiles (r, k, v, do, the
// cumsum), the [kC][kC] A and att, two [W][W] state tiles, u and the
// chunk-end term of dwlog. Rows are padded by one float, so that 32 lanes
// reading 32 rows at one column hit 32 banks.
template <int W>
struct GradSmem {
  static constexpr int kP = W + 1;
  static constexpr int kA = kC + 1;
  static constexpr int kTile = kC * kP;
  static constexpr int kState = W * kP;
  static constexpr int kFloats = 5 * kTile + 2 * kC * kA + 2 * kState + 2 * W;
};

// Pass 3. The gradients of chunk c of head h, batch b (the last chunk may
// be short: tokens past S are zero and are not written). Each thread owns
// kItems items (t, x), token t and column x, the same ones in every step.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, W <= 64 ? 2 : 1)
    wkv6bwd_grad_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ wlog,
                        const float* __restrict__ u,
                        const float* __restrict__ dout,
                        const float* __restrict__ states,
                        const float* __restrict__ gout, T* __restrict__ dr,
                        T* __restrict__ dk, T* __restrict__ dv,
                        float* __restrict__ dwlog,
                        float* __restrict__ dupart, int S, int H, int hd,
                        int slots) {
  using L = GradSmem<W>;
  constexpr int kP = L::kP, kA = L::kA;
  constexpr int kItems = kC * W / kThreads;
  static_assert(kC * W % kThreads == 0, "whole items a thread");
  extern __shared__ float smem[];
  float* sr = smem;              // [kC][kP] r
  float* sk = sr + L::kTile;     // [kC][kP] k
  float* sv = sk + L::kTile;     // [kC][kP] v
  float* sdo = sv + L::kTile;    // [kC][kP] do
  float* sc = sdo + L::kTile;    // [kC][kP] cumsum of the log2 decay
  float* sA = sc + L::kTile;     // [kC][kA] A[t][s] = do_t . v_s
  float* sT = sA + kC * kA;      // [kC][kA] att[t][s]
  float* s1 = sT + kC * kA;      // [W][kP] S_c; then [kC][kP] k 2^(total
  //                                - cum); then S_{c+1}; then f
  float* s2 = s1 + L::kState;    // [W][kP] G_c; then h
  float* su = s2 + L::kState;    // [W] u
  float* sy = su + W;            // [W] sum_j G_c[x, j] S_{c+1}[x, j]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, t0 = c * kC;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t ww = static_cast<size_t>(W) * W;

  // the chunk's inputs (zero past S and hd), S_c (0 entering chunk 0), G_c
  // (0 leaving the last chunk), u and the cumsums
  for (int i = tid; i < kC * W; i += kThreads) {
    const int t = i / W, x = i % W;
    const bool in = t0 + t < S && x < hd;
    const size_t o = in ? offset(b, t0 + t, h, x, S, H, hd) : 0;
    sr[t * kP + x] = in ? to_f32(r[o]) : 0.f;
    sk[t * kP + x] = in ? to_f32(k[o]) : 0.f;
    sv[t * kP + x] = in ? to_f32(v[o]) : 0.f;
    sdo[t * kP + x] = in ? dout[o] : 0.f;
  }
  const float* s_in = c > 0 ? states + (bh * slots + c - 1) * ww : nullptr;
  const float* g_in = c < slots ? gout + (bh * slots + c) * ww : nullptr;
  for (int e = tid; e < W * W; e += kThreads) {
    const int d = e / W, j = e % W;
    s1[d * kP + j] = s_in ? s_in[e] : 0.f;
    s2[d * kP + j] = g_in ? g_in[e] : 0.f;
  }
  for (int x = tid; x < W; x += kThreads) {
    su[x] = x < hd ? u[h * hd + x] : 0.f;
    cumsum_column(wlog, b, t0, h, x, S, H, hd, sc + x, kP);
  }
  __syncthreads();

  // A and att over the pairs s <= t: a warp takes one row t
  for (int p = tid; p < kC * kC; p += kThreads) {
    const int t = p / kC, s = p % kC;
    float a = 0.f, w = 0.f;
    if (s <= t) {
      for (int j = 0; j < W; ++j) a = fmaf(sdo[t * kP + j], sv[s * kP + j], a);
      if (s < t) {
        for (int d = 0; d < W; ++d)
          w = fmaf(sr[t * kP + d] * sk[s * kP + d],
                   ex2(sc[(t - 1) * kP + d] - sc[s * kP + d]), w);
      } else {
        for (int d = 0; d < W; ++d)
          w = fmaf(sr[t * kP + d] * su[d], sk[t * kP + d], w);
      }
    }
    sA[t * kA + s] = a;
    sT[t * kA + s] = w;
  }
  // the state terms of each item: 2^cum_ex (S_c do_t) for dr, then
  // 2^(total - cum) (G_c v_t) for dk and (k 2^(total - cum)) G_c for dv
  float p_in[kItems], p_out[kItems], p_v[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads, t = i / W, x = i % W;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < W; ++j)
      acc = fmaf(s1[x * kP + j], sdo[t * kP + j], acc);
    p_in[it] = acc * ex2(t > 0 ? sc[(t - 1) * kP + x] : 0.f);
  }
  __syncthreads();   // S_c is dead: k 2^(total - cum) goes over it
  for (int i = tid; i < kC * W; i += kThreads) {
    const int t = i / W, x = i % W;
    s1[t * kP + x] = sk[t * kP + x] *
                     ex2(sc[(kC - 1) * kP + x] - sc[t * kP + x]);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads, t = i / W, x = i % W;
    float acc = 0.f, accv = 0.f;
#pragma unroll 8
    for (int j = 0; j < W; ++j)
      acc = fmaf(s2[x * kP + j], sv[t * kP + j], acc);
#pragma unroll 8
    for (int d = 0; d < W; ++d)
      accv = fmaf(s1[t * kP + d], s2[d * kP + x], accv);
    p_out[it] = acc * ex2(sc[(kC - 1) * kP + x] - sc[t * kP + x]);
    p_v[it] = accv;
  }
  __syncthreads();   // the decayed k is dead: S_{c+1} goes there
  if (c < slots) {
    const float* s_out = states + (bh * slots + c) * ww;
    for (int e = tid; e < W * W; e += kThreads)
      s1[(e / W) * kP + e % W] = s_out[e];
  }
  __syncthreads();
  for (int x = tid; x < W; x += kThreads) {
    float y = 0.f;
    if (c < slots)
      for (int j = 0; j < W; ++j) y = fmaf(s2[x * kP + j], s1[x * kP + j], y);
    sy[x] = y;
  }
  __syncthreads();   // G_c and S_{c+1} are dead: f and h go there

  // dr, dk, dv of each item, and its f and h for dwlog
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads, t = i / W, x = i % W;
    const float rt = sr[t * kP + x], kt = sk[t * kP + x];
    const float ad = sA[t * kA + t], ct = sc[t * kP + x];
    const float cx = t > 0 ? sc[(t - 1) * kP + x] : 0.f;
    float dri = 0.f, dki = 0.f, dvt = p_v[it];
    for (int s = 0; s < t; ++s)
      dri = fmaf(sk[s * kP + x] * ex2(cx - sc[s * kP + x]), sA[t * kA + s],
                 dri);
    for (int q = t + 1; q < kC; ++q)
      dki = fmaf(sr[q * kP + x] * ex2(sc[(q - 1) * kP + x] - ct),
                 sA[q * kA + t], dki);
    for (int q = t; q < kC; ++q)
      dvt = fmaf(sT[q * kA + t], sdo[q * kP + x], dvt);
    const float drs = dri + p_in[it], dks = dki + p_out[it];
    if (t0 + t < S && x < hd) {
      const size_t o = offset(b, t0 + t, h, x, S, H, hd);
      store(dr + o, drs + su[x] * kt * ad);
      store(dk + o, dks + su[x] * rt * ad);
      store(dv + o, dvt);
    }
    s1[t * kP + x] = rt * drs - kt * dks;
    s2[t * kP + x] = kt * dks;
  }
  __syncthreads();
  // one thread a column: du's partial, and dwlog from the chunk's last
  // token back
  for (int x = tid; x < W; x += kThreads) {
    float du = 0.f;
    for (int t = 0; t < kC; ++t)
      du = fmaf(sr[t * kP + x] * sk[t * kP + x], sA[t * kA + t], du);
    dupart[((static_cast<size_t>(b) * gridDim.x + c) * H + h) * W + x] = du;
    float after = 0.f;
    const float y = sy[x];
    for (int t = kC - 1; t >= 0; --t) {
      if (t0 + t < S && x < hd)
        dwlog[offset(b, t0 + t, h, x, S, H, hd)] = after - s2[t * kP + x] + y;
      after += s1[t * kP + x];
    }
  }
}

// Pass 4. du[h, x] = the partials of (batch, chunk) summed in that order.
__global__ void __launch_bounds__(kThreads)
    wkv6bwd_du_kernel(const float* __restrict__ dupart, float* __restrict__ du,
                      int B, int chunks, int H, int hd, int W) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= H * hd) return;
  const int h = i / hd, x = i % hd;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < chunks; ++c)
      acc += dupart[((static_cast<size_t>(b) * chunks + c) * H + h) * W + x];
  du[i] = acc;
}

template <int W>
constexpr int adjoint_smem_bytes() {
  return static_cast<int>(sizeof(float)) * 3 * kC * W;
}

template <int W>
constexpr int grad_smem_bytes() {
  return static_cast<int>(sizeof(float)) * GradSmem<W>::kFloats;
}

template <typename T, int W>
int launch_width(const T* r, const T* k, const T* v, const float* wlog,
                 const float* u, const float* dout, const float* states,
                 T* dr, T* dk, T* dv, float* dwlog, float* du, float* ws,
                 int B, int S, int H, int hd, cudaStream_t stream) {
  const int chunks = (S + kC - 1) / kC, slots = chunks - 1;
  float* adj = ws;
  float* decay = adj + static_cast<size_t>(B) * H * slots * W * W;
  float* dupart = decay + static_cast<size_t>(B) * H * slots * W;
  cudaError_t err;
  if (slots > 0) {
    err = cudaFuncSetAttribute(wkv6bwd_adjoint_kernel<T, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               adjoint_smem_bytes<W>());
    if (err != cudaSuccess) return static_cast<int>(err);
    wkv6bwd_adjoint_kernel<T, W>
        <<<dim3(slots, H, B), kThreads, adjoint_smem_bytes<W>(), stream>>>(
            r, wlog, dout, adj, decay, S, H, hd, slots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t elems = static_cast<size_t>(B) * H * W * W;
    wkv6bwd_scan_kernel<<<static_cast<unsigned>(
                              (elems + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(adj, decay, B * H, W, slots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(wkv6bwd_grad_kernel<T, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             grad_smem_bytes<W>());
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6bwd_grad_kernel<T, W>
      <<<dim3(chunks, H, B), kThreads, grad_smem_bytes<W>(), stream>>>(
          r, k, v, wlog, u, dout, states, adj, dr, dk, dv, dwlog, dupart, S,
          H, hd, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6bwd_du_kernel<<<(H * hd + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(dupart, du, B, chunks, H, hd, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* wlog,
           const float* u, const float* dout, const float* states, void* dr,
           void* dk, void* dv, float* dwlog, float* du, float* ws, int B,
           int S, int H, int hd, cudaStream_t stream) {
  const T *rr = static_cast<const T*>(r), *kk = static_cast<const T*>(k),
          *vv = static_cast<const T*>(v);
  T *gr = static_cast<T*>(dr), *gk = static_cast<T*>(dk),
    *gv = static_cast<T*>(dv);
  switch (width(hd)) {
    case 32:
      return launch_width<T, 32>(rr, kk, vv, wlog, u, dout, states, gr, gk,
                                 gv, dwlog, du, ws, B, S, H, hd, stream);
    case 64:
      return launch_width<T, 64>(rr, kk, vv, wlog, u, dout, states, gr, gk,
                                 gv, dwlog, du, ws, B, S, H, hd, stream);
    default:
      return launch_width<T, 128>(rr, kk, vv, wlog, u, dout, states, gr, gk,
                                  gv, dwlog, du, ws, B, S, H, hd, stream);
  }
}

template <typename F>
int info_of(F* fn, int bytes, int* regs, int* spill, int* smem, int* blocks) {
  if (bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *spill = static_cast<int>(attr.localSizeBytes);
  *smem = bytes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, kThreads, bytes));
}

template <int W>
int info(int phase, int* regs, int* spill, int* smem, int* blocks) {
  switch (phase) {
    case 1:
      return info_of(wkv6bwd_adjoint_kernel<__nv_bfloat16, W>,
                     adjoint_smem_bytes<W>(), regs, spill, smem, blocks);
    case 2:
      return info_of(wkv6bwd_scan_kernel, 0, regs, spill, smem, blocks);
    case 3:
      return info_of(wkv6bwd_grad_kernel<__nv_bfloat16, W>,
                     grad_smem_bytes<W>(), regs, spill, smem, blocks);
    case 4:
      return info_of(wkv6bwd_du_kernel, 0, regs, spill, smem, blocks);
    default:
      return 1001;
  }
}

}  // namespace

// dtype of r, k, v, dr, dk and dv: 0 = float32, 1 = bfloat16. wlog, u,
// dout, dwlog and du are float32. states is the forward's workspace after
// its wkv6_launch on the same inputs (the state entering every chunk but
// the first; not touched, may be null, when S <= 32); workspace is float32
// of wkv6_bwd_workspace_floats(B, S, H, hd) elements. Returns a
// cudaError_t; 1001 for an unsupported argument.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* wlog, const void* u,
                               const void* dout, const void* states,
                               void* dr, void* dk, void* dv, void* dwlog,
                               void* du, void* workspace, int B, int S, int H,
                               int hd, int dtype, void* stream) {
  if (hd < 1 || hd > kMaxHd || B > 65535 || H > 65535 || B < 0 || S < 0 ||
      H < 0 || (dtype != 0 && dtype != 1))
    return 1001;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 0) return 0;
  if (B == 0 || S == 0) {   // nothing to sum: du = 0
    wkv6bwd_du_kernel<<<(H * hd + kThreads - 1) / kThreads, kThreads, 0,
                        st>>>(nullptr, static_cast<float*>(du), 0, 0, H, hd,
                              width(hd));
    return static_cast<int>(cudaGetLastError());
  }
  if (workspace == nullptr || (S > kC && states == nullptr)) return 1001;
  const float* w = static_cast<const float*>(wlog);
  const float* uu = static_cast<const float*>(u);
  const float* g = static_cast<const float*>(dout);
  const float* s = static_cast<const float*>(states);
  float* dw = static_cast<float*>(dwlog);
  float* dd = static_cast<float*>(du);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0)
    return launch<float>(r, k, v, w, uu, g, s, dr, dk, dv, dw, dd, ws, B, S,
                         H, hd, st);
  return launch<__nv_bfloat16>(r, k, v, w, uu, g, s, dr, dk, dv, dw, dd, ws,
                               B, S, H, hd, st);
}

// The f32 values of the workspace that wkv6_bwd_launch takes for these
// shapes (the wrapper sizes it by the same rule).
extern "C" long long wkv6_bwd_workspace_floats(int B, int S, int H, int hd) {
  const long long w = width(hd), chunks = (S + kC - 1) / kC;
  const long long slots = chunks > 0 ? chunks - 1 : 0;
  return static_cast<long long>(B) * H * (slots * w * (w + 1) + chunks * w);
}

// For pass `phase` (1-4) at head dim hd, the bf16 instantiation: registers
// a thread, local (spill) bytes a thread, dynamic shared bytes a block and
// the blocks one SM holds at once. Returns a cudaError_t; 1001 for a bad
// argument.
extern "C" int wkv6_bwd_info(int phase, int hd, int* regs, int* spill,
                             int* smem, int* blocks) {
  if (hd < 1 || hd > kMaxHd) return 1001;
  switch (width(hd)) {
    case 32:
      return info<32>(phase, regs, spill, smem, blocks);
    case 64:
      return info<64>(phase, regs, spill, smem, blocks);
    default:
      return info<128>(phase, regs, spill, smem, blocks);
  }
}
