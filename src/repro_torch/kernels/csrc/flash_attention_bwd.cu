// The gradient of blockwise causal / sliding-window GQA attention, in f32
// arithmetic on the CUDA cores, for f32 inputs: the f32 check path. bf16
// inputs go to csrc/flash_attention_bwd_bf16.cu (the tensor cores, the
// forward's LSE).
//
// The JAX package has no backward kernel: it differentiates the jnp
// flash_attend (src/repro/models/layers.py, under jax.checkpoint) with
// jax.vjp. This kernel computes the gradient of the function the f32
// forward kernel (csrc/flash_attention.cu) computes:
//
//     q [B, Sq, H, h], k [B, Skv, K, h], v [B, Skv, K, hv], H = K * G
//     s[i, j] = (q_i . k_j) / sqrt(h), or -1e30 where masked
//               (causal: j <= i; window w > 0: j > i - w)
//     P       = softmax_j(s),   o = P v
//
// Given o and do = dL/do:
//
//     D_i   = sum_c do[i, c] o[i, c]
//     dv_j  = sum_i P[i, j] do_i
//     dP    = do v^T,   dS = P o (dP - D)
//     dq_i  = sum_j dS[i, j] k_j / sqrt(h)
//     dk_j  = sum_i dS[i, j] q_i / sqrt(h)       (dk, dv summed over G)
//
// One C call, flash_attention_bwd_launch, runs three kernels:
//
// 1. flash_bwd_rowstats_kernel, grid (H, B, query tiles of 64): the log2
//    log-sum-exp of each query row over the keys it can reach (online max
//    and sum, as the forward) and D_i, into an f32 workspace of 2 B H Sq
//    values that the wrapper allocates. The f32 forward emits no LSE.
// 2. flash_bwd_dkdv_kernel, grid (K, B, key tiles of 32), the key tile
//    slowest and ascending, so that the causal tiles with the most work
//    start first: a block keeps its K and V tile in shared memory, loops
//    over the G query heads of its group and the 32-row query tiles that
//    reach it, recomputes P = exp2(s log2(e)/sqrt(h) - lse2) and dP, and
//    accumulates dk and dv in registers. Each element is written once.
// 3. flash_bwd_dq_kernel, grid (H, B, query tiles of 64, heaviest first):
//    a block keeps its Q and dO tile, loops over the key tiles its rows
//    reach, recomputes P and dP and accumulates dq in registers.
//
// No float atomics anywhere, and every sum runs in a fixed order (head,
// then tile, then row or key, then the feature dimension): two launches on
// the same inputs give the same bytes. The pods of the replicated trainer
// (repro_torch.runtime.statemachine) rely on that to end bitwise equal.
//
// Bound on an H100: the work is five matrix products over the visible
// (query, key) pairs, 10 h flops a pair at h = hv (2.5 times the forward).
// At the serving shape (q [4, 1024, 32, 128], causal) that is 86 GFLOP
// against ~302 MB in and out, so operations bound it: the f32 rate of the
// CUDA cores (TF32 tensor cores would not keep the check path's
// tolerance). This kernel recomputes S three times and dP twice (8
// products, not 5) as FFMA. The layouts follow csrc/flash_attention.cu:
// row-major f32 tiles of stride D + 4 floats read as float4, a 4 x 4
// (rows x keys) register tile a thread for S and dP (lane = 8 * ry + kx;
// rows ry + 4 i, keys kx + 8 j), and for the dk/dv accumulation a thread
// tile of 2 or 4 keys by 4 or 8 columns, so that a few shared loads feed
// each run of FMAs.
//
// Shapes: h, hv <= 128, any values; instantiated at a padded head width D
// of 32, 64 or 128 (zero-filled past h and hv). Rows past Sq and keys past
// Skv are masked; neither length has to divide a tile. A query row that
// sees no key has no defined gradient (its P is set to 0 here).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kBQ = 64;            // query rows a block, kernels 1 and 3
constexpr int kBQ2 = 32;           // query rows a step, kernel 2
constexpr int kBK = 32;            // keys a tile
constexpr int kPStride = kBQ + 4;  // floats a key row of dS^T (kernel 3)
constexpr int kSStride = kBK + 8;  // floats a query row of P, dS (kernel 2)
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Rows row0 .. row0 + R - 1 of a [n_rows, row_stride] matrix, columns
// below `width`, into shared rows of D + 4 floats (columns 0 .. D - 1);
// zero where the row or column does not exist.
// Consecutive threads take consecutive columns.
template <int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0,
                                          int n_rows, int width,
                                          size_t row_stride, int tid) {
  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (c < width && row0 + r < n_rows)
      x = src[(size_t)(row0 + r) * row_stride + c];
    dst[r * (D + 4) + c] = x;
  }
}

// s[i][j] = sum_d a[row ry + 4 i][d] * b[key kx + 8 j][d] over d < D, for
// shared row-major tiles of stride D + 4; `a` points at row ry. The FMA
// order is fixed, so every kernel recomputes the same scores bit for bit.
template <int D, int NR>
__device__ __forceinline__ void dot_tile(float (&s)[NR][4], const float* a,
                                         const float* b, int kx) {
  constexpr int S = D + 4;
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 av[NR], bv[4];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + 4 * i * S + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (kx + 8 * j) * S + d);
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

__device__ __forceinline__ bool visible(int row, int key, int Sq, int Skv,
                                        int causal, int window) {
  return row < Sq && key < Skv && (!causal || key <= row) &&
         (window <= 0 || key > row - window);
}

// The key tiles that some row of the query tile [q0, q_last] reaches, as
// the forward kernels skip the others.
__device__ __forceinline__ void key_tiles(int q0, int q_last, int Skv,
                                          int causal, int window, int* begin,
                                          int* end) {
  *end = (Skv + kBK - 1) / kBK - 1;
  if (causal) *end = min(*end, q_last / kBK);
  *begin = 0;
  if (window > 0 && q0 - window + 1 > 0) *begin = (q0 - window + 1) / kBK;
}

// ---------------------------------------------------------------------------
// 1. log2-domain log-sum-exp and D per query row

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_rowstats_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ o,
                              const float* __restrict__ dout,
                              float* __restrict__ lse2,
                              float* __restrict__ dvec, int Sq, int Skv,
                              int H, int KH, int h, int hv, int causal,
                              int window, float scale_log2) {
  constexpr int S = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;            // [kBQ][S]
  float* sk = sq + kBQ * S;    // [kBK][S]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ry = lane / 8, kx = lane % 8;
  const int wrow = warp * 16;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = head / (H / KH);
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_begin, kt_end;
  key_tiles(q0, q_last, Skv, causal, window, &kt_begin, &kt_end);

  const size_t q_rs = (size_t)H * h, k_rs = (size_t)KH * h,
               o_rs = (size_t)H * hv;
  const float* qg = q + ((size_t)b * Sq * H + head) * h;
  const float* kg = k + ((size_t)b * Skv * KH + kvh) * h;
  const size_t stat0 = ((size_t)b * H + head) * Sq;

  load_tile<D, kBQ>(sq, qg, q0, Sq, h, q_rs, tid);

  // D_i: a warp a row, lanes over the columns, then a fixed shuffle tree
  {
    const float* og = o + ((size_t)b * Sq * H + head) * hv;
    const float* dg = dout + ((size_t)b * Sq * H + head) * hv;
    for (int r = wrow; r < wrow + 16; ++r) {
      const int row = q0 + r;
      if (row >= Sq) break;  // the same for every lane of the warp
      float acc = 0.f;
      for (int c = lane; c < hv; c += 32)
        acc = fmaf(dg[row * o_rs + c], og[row * o_rs + c], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) dvec[stat0 + row] = acc;
    }
  }

  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kMasked;
    l_run[i] = 0.f;
  }
  const float* sq_t = sq + (wrow + ry) * S;
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    __syncthreads();  // every warp is past the previous tile
    load_tile<D, kBK>(sk, kg, kt * kBK, Skv, h, k_rs, tid);
    __syncthreads();
    float s[4][4];
    dot_tile<D, 4>(s, sq_t, sk, kx);
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + wrow + ry + 4 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + kx + 8 * j;
        // a masked key scores -1e30, as in the forward; a key past Skv
        // does not exist
        float x = s[i][j] * scale_log2;
        if (key >= Skv)
          x = -INFINITY;
        else if (!visible(row, key, Sq, Skv, causal, window))
          x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += exp2f(s[i][j] - m_new);
      l_run[i] = l_run[i] * exp2f(m_run[i] - m_new) + sum;
      m_run[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = q0 + wrow + ry + 4 * i;
    if (row < Sq && kx == 0) lse2[stat0 + row] = m_run[i] + log2f(l);
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv, one key tile of one kv head a block

template <int D>
struct KvMap {
  static constexpr int kChunks = D / 4;                     // float4 a row
  static constexpr int kCG = kChunks < 16 ? kChunks : 16;   // column groups
  static constexpr int kKG = kThreads / kCG;                // key groups
  static constexpr int kKeys = kBK / kKG;                   // keys a thread
  static constexpr int kCPT = kChunks / kCG;                // float4 a thread
  static_assert(kKeys * kKG == kBK && kCPT * kCG == kChunks, "whole map");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse2,
                          const float* __restrict__ dvec,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Sq,
                          int Skv, int H, int KH, int h, int hv, int causal,
                          int window, float scale_log2, float scale) {
  constexpr int S = D + 4;
  using M = KvMap<D>;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;                  // [kBK][S]
  float* sv = sk + kBK * S;          // [kBK][S]
  float* sq = sv + kBK * S;          // [kBQ2][S]
  float* sdo = sq + kBQ2 * S;        // [kBQ2][S]
  float* sp = sdo + kBQ2 * S;        // [kBQ2][kSStride], P
  float* sds = sp + kBQ2 * kSStride; // [kBQ2][kSStride], dS
  float* slse = sds + kBQ2 * kSStride;
  float* sd = slse + kBQ2;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ry = lane / 8, kx = lane % 8;
  const int cg = tid % M::kCG, kg = tid / M::kCG;
  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kBK;
  const int G = H / KH;
  const size_t q_rs = (size_t)H * h, o_rs = (size_t)H * hv,
               k_rs = (size_t)KH * h, v_rs = (size_t)KH * hv;

  load_tile<D, kBK>(sk, k + ((size_t)b * Skv * KH + kvh) * h, k0, Skv, h,
                       k_rs, tid);
  load_tile<D, kBK>(sv, v + ((size_t)b * Skv * KH + kvh) * hv, k0, Skv,
                       hv, v_rs, tid);

  // the query tiles some row of which reaches a key of this tile
  const int k_last = min(k0 + kBK, Skv) - 1;
  const int nq = (Sq + kBQ2 - 1) / kBQ2;
  const int qt_begin = causal ? k0 / kBQ2 : 0;
  int qt_end = nq - 1;
  if (window > 0) qt_end = min(qt_end, (k_last + window - 1) / kBQ2);

  float dk_acc[M::kKeys][4 * M::kCPT], dv_acc[M::kKeys][4 * M::kCPT];
#pragma unroll
  for (int e = 0; e < M::kKeys; ++e)
#pragma unroll
    for (int c = 0; c < 4 * M::kCPT; ++c) {
      dk_acc[e][c] = 0.f;
      dv_acc[e][c] = 0.f;
    }

  const int srow = 8 * warp + ry;  // the thread's first S row in the tile
  for (int g = 0; g < G; ++g) {
    const int head = kvh * G + g;
    const float* qg = q + ((size_t)b * Sq * H + head) * h;
    const float* dg = dout + ((size_t)b * Sq * H + head) * hv;
    const size_t stat0 = ((size_t)b * H + head) * Sq;
    for (int qt = qt_begin; qt <= qt_end; ++qt) {
      const int q0 = qt * kBQ2;
      __syncthreads();  // every warp is done with the previous step's tiles
      load_tile<D, kBQ2>(sq, qg, q0, Sq, h, q_rs, tid);
      load_tile<D, kBQ2>(sdo, dg, q0, Sq, hv, o_rs, tid);
      if (tid < kBQ2) {
        const int row = q0 + tid;
        slse[tid] = row < Sq ? lse2[stat0 + row] : 0.f;
        sd[tid] = row < Sq ? dvec[stat0 + row] : 0.f;
      }
      __syncthreads();

      float s[2][4], dp[2][4];
      dot_tile<D, 2>(s, sq + srow * S, sk, kx);
      dot_tile<D, 2>(dp, sdo + srow * S, sv, kx);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = srow + 4 * i;
        const float lse = slse[r], dd = sd[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = kx + 8 * j;
          const float p =
              visible(q0 + r, k0 + key, Sq, Skv, causal, window)
                  ? exp2f(s[i][j] * scale_log2 - lse)
                  : 0.f;
          sp[r * kSStride + key] = p;
          sds[r * kSStride + key] = p * (dp[i][j] - dd);
        }
      }
      __syncthreads();

      // dv += P^T dO, dk += dS^T Q over the tile's rows, in row order
#pragma unroll 4
      for (int r = 0; r < kBQ2; ++r) {
        float pv[M::kKeys], dsv[M::kKeys];
#pragma unroll
        for (int e = 0; e < M::kKeys; ++e) {
          pv[e] = sp[r * kSStride + kg * M::kKeys + e];
          dsv[e] = sds[r * kSStride + kg * M::kKeys + e];
        }
#pragma unroll
        for (int jj = 0; jj < M::kCPT; ++jj) {
          const int col = 4 * (cg + M::kCG * jj);
          const float4 o4 = *reinterpret_cast<const float4*>(sdo + r * S + col);
          const float4 q4 = *reinterpret_cast<const float4*>(sq + r * S + col);
#pragma unroll
          for (int e = 0; e < M::kKeys; ++e) {
            dv_acc[e][4 * jj + 0] = fmaf(pv[e], o4.x, dv_acc[e][4 * jj + 0]);
            dv_acc[e][4 * jj + 1] = fmaf(pv[e], o4.y, dv_acc[e][4 * jj + 1]);
            dv_acc[e][4 * jj + 2] = fmaf(pv[e], o4.z, dv_acc[e][4 * jj + 2]);
            dv_acc[e][4 * jj + 3] = fmaf(pv[e], o4.w, dv_acc[e][4 * jj + 3]);
            dk_acc[e][4 * jj + 0] = fmaf(dsv[e], q4.x, dk_acc[e][4 * jj + 0]);
            dk_acc[e][4 * jj + 1] = fmaf(dsv[e], q4.y, dk_acc[e][4 * jj + 1]);
            dk_acc[e][4 * jj + 2] = fmaf(dsv[e], q4.z, dk_acc[e][4 * jj + 2]);
            dk_acc[e][4 * jj + 3] = fmaf(dsv[e], q4.w, dk_acc[e][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int e = 0; e < M::kKeys; ++e) {
    const int key = k0 + kg * M::kKeys + e;
    if (key >= Skv) continue;
    float* dkr = dk + ((size_t)b * Skv + key) * k_rs + (size_t)kvh * h;
    float* dvr = dv + ((size_t)b * Skv + key) * v_rs + (size_t)kvh * hv;
#pragma unroll
    for (int jj = 0; jj < M::kCPT; ++jj)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = 4 * (cg + M::kCG * jj) + x;
        if (col < h) dkr[col] = dk_acc[e][4 * jj + x] * scale;
        if (col < hv) dvr[col] = dv_acc[e][4 * jj + x];
      }
  }
}

// ---------------------------------------------------------------------------
// 3. dq, one query tile of one head a block

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse2,
                        const float* __restrict__ dvec, float* __restrict__ dq,
                        int Sq, int Skv, int H, int KH, int h, int hv,
                        int causal, int window, float scale_log2,
                        float scale) {
  constexpr int S = D + 4;
  constexpr int kChunks = D / 32;  // float4 output chunks a row a thread
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;              // [kBQ][S]
  float* sdo = sq + kBQ * S;     // [kBQ][S]
  float* sk = sdo + kBQ * S;     // [kBK][S]
  float* sv = sk + kBK * S;      // [kBK][S]
  float* sds = sv + kBK * S;     // [kBK][kPStride], dS^T

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ry = lane / 8, kx = lane % 8;
  const int wrow = warp * 16;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int kvh = head / (H / KH);
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_begin, kt_end;
  key_tiles(q0, q_last, Skv, causal, window, &kt_begin, &kt_end);

  const size_t q_rs = (size_t)H * h, o_rs = (size_t)H * hv,
               k_rs = (size_t)KH * h, v_rs = (size_t)KH * hv;
  const float* kg = k + ((size_t)b * Skv * KH + kvh) * h;
  const float* vg = v + ((size_t)b * Skv * KH + kvh) * hv;
  const size_t stat0 = ((size_t)b * H + head) * Sq;

  load_tile<D, kBQ>(sq, q + ((size_t)b * Sq * H + head) * h, q0, Sq, h,
                       q_rs, tid);
  load_tile<D, kBQ>(sdo, dout + ((size_t)b * Sq * H + head) * hv, q0, Sq,
                       hv, o_rs, tid);
  float lse_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + wrow + ry + 4 * i;
    lse_r[i] = row < Sq ? lse2[stat0 + row] : 0.f;
    d_r[i] = row < Sq ? dvec[stat0 + row] : 0.f;
  }

  float acc[4][4 * kChunks];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kChunks; ++c) acc[i][c] = 0.f;
  const float* sq_t = sq + (wrow + ry) * S;
  const float* sdo_t = sdo + (wrow + ry) * S;
  float* sds_t = sds + wrow + 4 * ry;  // dS^T column of the thread's row 0

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K, V tile
    load_tile<D, kBK>(sk, kg, k0, Skv, h, k_rs, tid);
    load_tile<D, kBK>(sv, vg, k0, Skv, hv, v_rs, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D, 4>(s, sq_t, sk, kx);
    dot_tile<D, 4>(dp, sdo_t, sv, kx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + wrow + ry + 4 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + kx + 8 * j;
        const float p = visible(row, key, Sq, Skv, causal, window)
                            ? exp2f(s[i][j] * scale_log2 - lse_r[i])
                            : 0.f;
        s[i][j] = p * (dp[i][j] - d_r[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sds_t + (kx + 8 * j) * kPStride) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();  // the warp reads back only its own rows of dS^T

    // dq += dS K: per key, the thread's 4 values of dS and 4 * kChunks
    // columns of K
#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(sds_t + c * kPStride);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jj = 0; jj < kChunks; ++jj) {
        const float4 kk = *reinterpret_cast<const float4*>(
            sk + c * S + 4 * (kx + 8 * jj));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj + 0] = fmaf(pr[i], kk.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(pr[i], kk.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pr[i], kk.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pr[i], kk.w, acc[i][4 * jj + 3]);
        }
      }
    }
    __syncwarp();  // done reading dS^T before the next tile writes it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + wrow + ry + 4 * i;
    if (row >= Sq) continue;
    float* o = dq + ((size_t)b * Sq + row) * q_rs + (size_t)head * h;
#pragma unroll
    for (int jj = 0; jj < kChunks; ++jj)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = 4 * (kx + 8 * jj) + x;
        if (col < h) o[col] = acc[i][4 * jj + x] * scale;
      }
  }
}

// ---------------------------------------------------------------------------

template <int D>
constexpr int smem_rowstats() {
  return sizeof(float) * (kBQ + kBK) * (D + 4);
}
template <int D>
constexpr int smem_dkdv() {
  return sizeof(float) * ((2 * kBK + 2 * kBQ2) * (D + 4) +
                          2 * kBQ2 * kSStride + 2 * kBQ2);
}
template <int D>
constexpr int smem_dq() {
  return sizeof(float) * ((2 * kBQ + 2 * kBK) * (D + 4) + kBK * kPStride);
}

// The three kernels of one (type, width) instantiation, with their shared
// memory; `which` is 1 (row stats), 2 (dk/dv) or 3 (dq).
template <int D>
cudaError_t kernel_of(int which, const void** fn, int* smem) {
  switch (which) {
    case 1:
      *fn = reinterpret_cast<const void*>(flash_bwd_rowstats_kernel<D>);
      *smem = smem_rowstats<D>();
      break;
    case 2:
      *fn = reinterpret_cast<const void*>(flash_bwd_dkdv_kernel<D>);
      *smem = smem_dkdv<D>();
      break;
    case 3:
      *fn = reinterpret_cast<const void*>(flash_bwd_dq_kernel<D>);
      *smem = smem_dq<D>();
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* ws, int B,
           int Sq, int Skv, int H, int KH, int h, int hv, int causal,
           int window, float scale, cudaStream_t stream) {
  const void* fn;
  int smem[4];
  for (int which = 1; which <= 3; ++which) {
    cudaError_t err = kernel_of<D>(which, &fn, &smem[which]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* lse2 = ws;
  float* dvec = ws + (size_t)B * H * Sq;
  const float sl2 = scale * kLog2e;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const dim3 rows(H, B, (Sq + kBQ - 1) / kBQ);
  flash_bwd_rowstats_kernel<D><<<rows, kThreads, smem[1], stream>>>(
      tq, tk, static_cast<const float*>(o), tdo, lse2, dvec, Sq, Skv, H, KH, h,
      hv,
      causal, window, sl2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 keys(KH, B, (Skv + kBK - 1) / kBK);
  flash_bwd_dkdv_kernel<D><<<keys, kThreads, smem[2], stream>>>(
      tq, tk, tv, tdo, lse2, dvec, static_cast<float*>(dk),
      static_cast<float*>(dv),
      Sq, Skv, H, KH, h, hv, causal, window, sl2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<rows, kThreads, smem[3], stream>>>(
      tq, tk, tv, tdo, lse2, dvec, static_cast<float*>(dq), Sq, Skv, H, KH, h,
      hv,
      causal, window, sl2, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_width(int width, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, void* dq, void* dk,
                 void* dv, float* ws, int B, int Sq, int Skv, int H, int KH,
                 int h, int hv, int causal, int window, float scale,
                 cudaStream_t s) {
  switch (width) {
    case 32:
      return launch<32>(q, k, v, o, dout, dq, dk, dv, ws, B, Sq, Skv, H,
                           KH, h, hv, causal, window, scale, s);
    case 64:
      return launch<64>(q, k, v, o, dout, dq, dk, dv, ws, B, Sq, Skv, H,
                           KH, h, hv, causal, window, scale, s);
    case 128:
      return launch<128>(q, k, v, o, dout, dq, dk, dv, ws, B, Sq, Skv, H,
                            KH, h, hv, causal, window, scale, s);
    default:
      return 1001;
  }
}

int info_width(int which, int width, const void** fn, int* smem) {
  switch (width) {
    case 32:
      return static_cast<int>(kernel_of<32>(which, fn, smem));
    case 64:
      return static_cast<int>(kernel_of<64>(which, fn, smem));
    case 128:
      return static_cast<int>(kernel_of<128>(which, fn, smem));
    default:
      return 1001;
  }
}

}  // namespace

// q, k, v, o, dout are the forward's f32 inputs, its output and the
// output's gradient, contiguous; dq, dk, dv are written in f32. ws holds
// 2 * B * H * Sq floats (row log-sum-exps, then D). width is the padded
// head width (32, 64 or 128) that holds h and hv; scale is 1 / sqrt(h).
// Returns a cudaError_t; 1001 for an unsupported argument.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* ws, int B, int Sq,
    int Skv, int H, int KH, int h, int hv, int causal, int window,
    float scale, int width, void* stream) {
  if (h < 1 || hv < 1 || h > width || hv > width || KH < 1 || H % KH != 0 ||
      B > 65535 || (Sq + kBQ - 1) / kBQ > 65535 ||
      (Skv + kBK - 1) / kBK > 65535)
    return 1001;
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  return launch_width(width, q, k, v, o, dout, dq, dk, dv, w, B, Sq,
                             Skv, H, KH, h, hv, causal, window, scale, s);
}

// Registers a thread, local (spill) bytes a thread, dynamic shared bytes a
// block and blocks an SM holds of kernel `which` (1 row stats, 2 dk/dv,
// 3 dq) at padded width `width`. Returns a cudaError_t; 1001 for an
// unsupported argument.
extern "C" int flash_attention_bwd_info(int which, int width, int* regs,
                                        int* local_bytes, int* smem,
                                        int* blocks) {
  const void* fn = nullptr;
  int err = info_width(which, width, &fn, smem);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, kThreads, *smem));
}
