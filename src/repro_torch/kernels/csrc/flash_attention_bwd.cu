// The gradient of blockwise causal / sliding-window GQA attention, in f32
// arithmetic on the CUDA cores, for f32 inputs: the f32 check path. bf16
// inputs go to csrc/flash_attention_bwd_bf16.cu (the tensor cores).
//
// The JAX package has no backward kernel: it differentiates the jnp
// flash_attend (src/repro/models/layers.py:111, under jax.checkpoint) with
// jax.vjp. This kernel computes the gradient of the function the f32
// forward kernel (csrc/flash_attention.cu) computes:
//
//     q [B, Sq, H, h], k [B, Skv, K, h], v [B, Skv, K, hv], H = K * G
//     s[i, j] = (q_i . k_j) / sqrt(h), masked where not visible
//               (causal: j <= i; window w > 0: j > i - w)
//     P       = softmax_j(s),   o = P v
//
// Given o, do = dL/do and the forward's log2-domain log-sum-exp of each
// query row, lse[b, head, i] = m_i + log2(l_i) (the f32 forward writes it
// through its optional lse pointer when a gradient is wanted):
//
//     P[i, j] = exp2(s[i, j] log2(e) - lse_i), 0 where masked
//     D_i     = sum_c do[i, c] o[i, c]
//     dv_j    = sum_i P[i, j] do_i
//     dP      = do v^T,   dS = P o (dP - D)
//     dq_i    = sum_j dS[i, j] k_j / sqrt(h)
//     dk_j    = sum_i dS[i, j] q_i / sqrt(h)      (dk, dv summed over G)
//
// Bound on an H100: five matrix products over the visible (query, key)
// pairs, 10 h flops a pair at h = hv. At the serving shape (q
// [4, 1024, 32, 128], kv 4, causal) that is 86 GFLOP against ~302 MB in
// and out, so the f32 rate of the CUDA cores bounds it (1,283 us at 67
// TFLOP/s). It stays FFMA: TF32 tensor cores would break the check path's
// 2e-5 tolerance. This design runs seven products (S and dP in both
// passes, no row-stats pass), 120 GFLOP at that shape. As in the forward,
// an FMA takes its operands from shared memory, which serves one 128-byte
// wavefront a clock against four warp FMAs, so the design is about FMAs
// per shared load; and no copy waits in the open.
//
// One C call, flash_attention_bwd_launch, runs three kernels:
//
// 1. flash_bwd_f32_dot_kernel: D_i into a workspace of B H Sq floats, one
//    warp a row (float4 loads where the plan allows), a fixed shuffle
//    tree. Memory-bound: o and do are read once.
// 2. flash_bwd_f32_dkdv_kernel, grid (K, B, key-tile slots), 8 warps, one
//    64-key tile of one kv head at a time; each warp owns 8 keys. A step is
//    one (head of the group, 64-row query tile); the steps run over the G
//    heads, then the query tiles that reach the key tile, ascending. Q, dO
//    and the step's 64 lse and D values come through a 2-stage cp.async
//    ring (16-byte copies where the plan allows, 4-byte copies otherwise;
//    4-byte copies for the statistics, whose rows need not be aligned):
//    one block barrier a step, the next step in flight while this one is
//    multiplied. In a step a warp computes S^T = K Q^T and dP^T = V dO^T
//    for its 8 keys x 64 rows on a 4 x 4 register tile a thread (lane =
//    16 ry + kx: keys 4 ry + i, rows kx + 16 j), read along d as float4
//    from row-major tiles of stride D + 4 (2 rows of K or V a load, a
//    broadcast; 16 rows of Q or dO, two wavefronts). P^T goes to the
//    warp's own [64 rows][8 keys] shared slice, is read back after
//    __syncwarp into dV += P^T dO; then dS^T = P^T o (dP^T - D) takes the
//    same slice for dK += dS^T Q. A thread accumulates 4 keys x 8 columns
//    of dV and of dK at D = 128 (2 x 16 lanes over keys x 16-byte column
//    chunks): per query row one float4 of the slice and two of dO or Q
//    feed 32 FMAs.
// 3. flash_bwd_f32_dq_kernel, grid (H, B, 128-row query tiles, heaviest
//    first), 8 warps, each owning 16 rows as the forward's warps do. Q and
//    dO stay resident; K and V come in 32-key tiles through a 2-stage
//    cp.async ring. S and dP on a 4 x 4 register tile a thread (rows
//    ry + 4 i, keys kx + 8 j), dS in registers, then dQ += dS K through a
//    dS^T slice that only the warp reads back (after __syncwarp), as the
//    forward's P^T: 5 shared loads feed 64 FMAs on a 4 x 16 tile.
//
// Why 8 warps a block and one block an SM at D = 128 (not 4 warps and
// two blocks): a 4 x 4 tile a thread over 128 threads covers 2,048
// (key, row) pairs a step. Resident K and V tiles plus a 2-stage Q and dO
// ring for them need (2 BK + 4 BQ)(D + 4) floats with BK BQ = 2,048, at
// least 135 KB (BK = 64, BQ = 32), and dq's resident Q and dO plus its
// K/V ring 144 KB: neither fits twice in the SM's 228 KB. Eight warps
// sharing one block's K, V and ring need 220,160 bytes (dk/dv) and
// 219,648 (dq): the same 8 warps an SM and the same register file (255 a
// thread at most). At D = 64 a block takes ~120 KB, at D = 32 ~72 KB.
//
// The dk/dv grid's balance. Under a causal mask key tile t of n reaches
// n - t query tiles, so one block a tile gives key tile 0 twice the mean
// work. A causal launch gives each block two key tiles, t and n - 1 - t,
// in that order (the middle tile alone when n is odd): each block then
// takes n + 1 query tiles x G heads. At the serving shape (n = 16 tiles
// of 64 keys, K B = 16) that is 128 equal blocks of 17 x 8 steps, one a
// SM: the busiest SM carries 17 tile-steps against a mean of 16 x 136 /
// 132 = 16.5, 3 % above. One block a tile would be 256 blocks of 16 down
// to 1 tile-steps at one block an SM, two waves. Without the causal mask
// every key tile carries the same work and each block takes one.
//
// Tiles a block's rows or keys cannot reach are never loaded, and a warp
// skips a step or tile in which none of its pairs is visible; masks are
// applied only where a warp's pairs cross the causal diagonal, the
// window's edge or the end of a sequence. Rows past Sq and keys past Skv
// are zero-filled and masked; neither length has to divide a tile. A
// query row that sees no key has no defined gradient (its P is 0 here).
//
// Determinism: no float atomics, and every sum runs in a fixed order (for
// dk and dv: key tile, head, query tile, then the step's rows; for dq: key
// tile, then the tile's keys; each dot product over d ascending), and
// every output element is written by exactly one thread, so two launches
// on the same inputs give the same bytes. The pods of the replicated
// trainer (repro_torch.runtime.statemachine) rely on that to end bitwise
// equal. dq is its own pass for that reason.
//
// Shapes: h <= 192 and hv <= 128, any values; instantiated at a padded
// q/k width DQ and v width DV (zero-filled past h and hv): DQ = DV = D of
// 32, 64 or 128, or DQ = 192 with DV = 128 (deepseek-v3's MLA prefill,
// h = 128 + 64, hv = 128); with 16-byte copies and stores (vec = 1: h and
// hv multiples of 4, every tensor 16-byte aligned) or 4-byte ones of the
// same elements (vec = 0). flash_attention_bwd_info reports each kernel's
// registers, spill bytes, shared memory and blocks an SM.
//
// At (192, 128) the D = 128 tiles would not fit: dk/dv's K and V tiles,
// its 64-row Q/dO ring, statistics and slices would take 269,312 bytes
// and dq's resident Q and dO with its 32-key K/V ring 268,800, against
// 232,448 a block. So the wide
// instantiation halves the dk/dv step to 32 query rows (a thread's S^T
// tile is 4 keys x 2 rows: keys 4 ry + i, rows kx + 16 j, j < 2) and the
// dq K/V tile to 16 keys (4 rows x 2 keys: rows ry + 4 i, keys kx + 8 j,
// j < 2): dk/dv 176,640 bytes, dq 218,368, one block of 8 warps an SM as
// at D = 128. The key tile stays 64 and the causal pairing of key tiles t
// and n - 1 - t stays. A dk/dv thread then holds 4 keys x 12 columns of
// dK (a 192-float row is 48 float4 over 16 column groups, 3 a thread) and
// 4 x 8 of dV; a dq thread 4 rows x 24 columns of dQ. Each product still
// reads float4 along d from rows of stride DQ + 4 or DV + 4 floats (49 and
// 33 16-byte chunks: 8 consecutive rows fall in 8 distinct bank groups).
// Rows of 192 floats are copied as a 128-float and a 64-float part.
// Bound at the f32 check shape (q [1, 256, 128, 192], v width 128,
// causal): 6 h + 4 hv flops a pair, 7.0 GFLOP, 104.6 us at 67 TFLOP/s.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;       // the cp.async rings
constexpr int kKT = 64;          // keys a dk/dv tile, 8 a warp
constexpr int kSlice = 8;        // floats a row of a dk/dv warp's P^T slice
constexpr int kQT = 128;         // query rows a dq block, 16 a warp
constexpr int kPStride = kQT + 4;  // floats a key row of dq's dS^T

// query rows a dk/dv step and keys a dq K/V tile at padded q/k width DQ
template <int DQ>
constexpr int kStepQ = DQ > 128 ? 32 : 64;
template <int DQ>
constexpr int kTileK = DQ > 128 ? 16 : 32;
constexpr int kDotThreads = 256;   // 8 rows a block in the D pass
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes = 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte asynchronous copy; src_bytes = 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy kR rows of `width` floats from rows row0.. of a [n_rows,
// row_stride] global matrix into columns kC0 .. kC0 + kW - 1 of shared
// rows of D + 4 floats; rows past n_rows and columns past width are
// zero-filled. kVec: 16-byte copies, else 4-byte copies of the same
// elements. A thread keeps one column and steps down the rows, as the
// forward's load_cols.
template <int D, int kR, bool kVec, int kC0, int kW>
__device__ __forceinline__ void load_cols(float* dst, const float* src,
                                          int row0, int n_rows, int width,
                                          size_t row_stride, int tid) {
  constexpr int kS = D + 4;
  constexpr int kPer = kVec ? 4 : 1;          // floats a copy
  constexpr int kCols = kW / kPer;            // copies a row
  constexpr int kStep = kThreads / kCols;     // rows a round
  static_assert(kThreads % kCols == 0 && kR % kStep == 0,
                "whole rounds of copies");
  const int c = kC0 + kPer * (tid % kCols), r = tid / kCols;
  const bool col_in = c < width;
  size_t off = (size_t)(row0 + r) * row_stride + c;
  uint32_t to = smem_addr(dst + r * kS + c);
#pragma unroll
  for (int it = 0; it < kR / kStep; ++it) {
    const bool in = col_in && row0 + r + it * kStep < n_rows;
    if constexpr (kVec)
      cp_async16(to, in ? src + off : src, in ? 16 : 0);
    else
      cp_async4(to, in ? src + off : src, in ? 4 : 0);
    off += kStep * row_stride;
    to += kStep * kS * sizeof(float);
  }
}

// All D columns of kR rows: in one part, or at D = 192 as columns 0 .. 127
// and 128 .. 191.
template <int D, int kR, bool kVec>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n_rows, int width,
                                          size_t row_stride, int tid) {
  if constexpr (D == 192) {
    load_cols<D, kR, kVec, 0, 128>(dst, src, row0, n_rows, width,
                                   row_stride, tid);
    load_cols<D, kR, kVec, 128, 64>(dst, src, row0, n_rows, width,
                                    row_stride, tid);
  } else {
    load_cols<D, kR, kVec, 0, D>(dst, src, row0, n_rows, width, row_stride,
                                 tid);
  }
}

// c[i][j] = sum_d a[row kA i][d] * b[row kB j][d] over d < D, i < 4,
// j < kJ, for shared row-major tiles of stride D + 4, d ascending: a
// fixed FMA order, so both passes compute the same S (and the same dP)
// bit for bit.
template <int D, int kJ, int kA, int kB>
__device__ __forceinline__ void dot4(float (&c)[4][kJ], const float* a,
                                     const float* b) {
  constexpr int kS = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) c[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + kA * i * kS + d);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + kB * j * kS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        c[i][j] = fmaf(av[i].x, bv[j].x, c[i][j]);
        c[i][j] = fmaf(av[i].y, bv[j].y, c[i][j]);
        c[i][j] = fmaf(av[i].z, bv[j].z, c[i][j]);
        c[i][j] = fmaf(av[i].w, bv[j].w, c[i][j]);
      }
  }
}

__device__ __forceinline__ bool visible(int row, int key, int Sq, int Skv,
                                        int causal, int window) {
  return row < Sq && key < Skv && (!causal || key <= row) &&
         (window <= 0 || key > row - window);
}

// Store 4 floats at a row of width `width` (dst points at column col):
// one 16-byte store on the vec path, else the columns below width.
template <bool kVec>
__device__ __forceinline__ void store4(float* dst, int col, int width,
                                       float x0, float x1, float x2,
                                       float x3) {
  if constexpr (kVec) {
    if (col < width)
      *reinterpret_cast<float4*>(dst + col) = make_float4(x0, x1, x2, x3);
  } else {
    const float x[4] = {x0, x1, x2, x3};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < width) dst[col + e] = x[e];
  }
}

// ---------------------------------------------------------------------------
// 1. D_i = do_i . o_i

template <bool kVec>
__global__ void __launch_bounds__(kDotThreads)
    flash_bwd_f32_dot_kernel(const float* __restrict__ o,
                             const float* __restrict__ dout,
                             float* __restrict__ delta, int rows, int Sq,
                             int H, int hv) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kDotThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // the same for every lane of the warp
  const float* po = o + (size_t)row * hv;
  const float* pd = dout + (size_t)row * hv;
  float acc = 0.f;
  if constexpr (kVec) {
    for (int c = 4 * lane; c < hv; c += 128) {
      const float4 a = *reinterpret_cast<const float4*>(po + c);
      const float4 d = *reinterpret_cast<const float4*>(pd + c);
      acc = fmaf(d.x, a.x, acc);
      acc = fmaf(d.y, a.y, acc);
      acc = fmaf(d.z, a.z, acc);
      acc = fmaf(d.w, a.w, acc);
    }
  } else {
    for (int c = lane; c < hv; c += 32) acc = fmaf(pd[c], po[c], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // row = (b Sq + i) H + head; D is laid out [B, H, Sq] as the lse
    const int head = row % H, bi = row / H;
    const int b = bi / Sq, i = bi % Sq;
    delta[((size_t)b * H + head) * Sq + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv, one or two 64-key tiles of one kv head a block

// A warp's dK / dV accumulation map: 32 lanes over kKG key groups and kCG
// column groups; a thread holds kKeys keys x kCPT 16-byte column chunks.
template <int D>
struct KvMap {
  static constexpr int kChunks = D / 4;                     // float4 a row
  static constexpr int kCG = kChunks < 16 ? kChunks : 16;   // column groups
  static constexpr int kKG = 32 / kCG;                      // key groups
  static constexpr int kKeys = kSlice / kKG;                // keys a thread
  static constexpr int kCPT = kChunks / kCG;                // chunks a thread
  static_assert(kKeys * kKG == kSlice && kCPT * kCG == kChunks, "whole map");
  static_assert(kKeys == 2 || kKeys == 4, "a float2 or float4 of the slice");
};

// acc[e][4 jj + x] += slice[r][kg kKeys + e] * rows[r][4 (cg + kCG jj) + x]
// over the step's kQS rows, in row order.
template <int D, int kQS>
__device__ __forceinline__ void accumulate(
    float (&acc)[KvMap<D>::kKeys][4 * KvMap<D>::kCPT], const float* slice,
    const float* rows, int kg, int cg) {
  using M = KvMap<D>;
  constexpr int kS = D + 4;
#pragma unroll 4
  for (int r = 0; r < kQS; ++r) {
    float pv[M::kKeys];
    if constexpr (M::kKeys == 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(
          slice + r * kSlice + 4 * kg);
      pv[0] = p4.x;
      pv[1] = p4.y;
      pv[2] = p4.z;
      pv[3] = p4.w;
    } else {
      const float2 p2 = *reinterpret_cast<const float2*>(
          slice + r * kSlice + 2 * kg);
      pv[0] = p2.x;
      pv[1] = p2.y;
    }
#pragma unroll
    for (int jj = 0; jj < M::kCPT; ++jj) {
      const float4 x = *reinterpret_cast<const float4*>(
          rows + r * kS + 4 * (cg + M::kCG * jj));
#pragma unroll
      for (int e = 0; e < M::kKeys; ++e) {
        acc[e][4 * jj + 0] = fmaf(pv[e], x.x, acc[e][4 * jj + 0]);
        acc[e][4 * jj + 1] = fmaf(pv[e], x.y, acc[e][4 * jj + 1]);
        acc[e][4 * jj + 2] = fmaf(pv[e], x.z, acc[e][4 * jj + 2]);
        acc[e][4 * jj + 3] = fmaf(pv[e], x.w, acc[e][4 * jj + 3]);
      }
    }
  }
}

template <int DQ, int DV, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_f32_dkdv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int Sq, int Skv, int H, int KH, int h, int hv,
                              int causal, int window, float scale_log2,
                              float scale, int paired) {
  constexpr int kQS = kStepQ<DQ>;  // query rows a step
  constexpr int kJ = kQS / 16;       // S^T rows a thread: kx + 16 j
  constexpr int kS = DQ + 4;         // floats a Q or K shared row
  constexpr int kSV = DV + 4;        // floats a dO or V shared row
  constexpr int kStep = kQS * (kS + kSV);  // floats a ring stage (Q, dO)
  using M = KvMap<DQ>;
  using MV = KvMap<DV>;
  static_assert(M::kCG == MV::kCG, "dK and dV share the lane map");
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;                             // [kKT][kS]
  float* sv = sk + kKT * kS;                    // [kKT][kSV]
  float* ring = sv + kKT * kSV;                 // kStages x (Q, dO)
  float* stats = ring + kStages * kStep;        // kStages x (lse, D)[kQS]
  float* slices = stats + kStages * 2 * kQS;    // kWarps x [kQS][kSlice]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ry = lane / 16, kx = lane % 16;     // S^T: keys 4 ry + i,
                                                // rows kx + 16 j
  const int kg = lane / M::kCG, cg = lane % M::kCG;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH;
  const int n_kt = (Skv + kKT - 1) / kKT;
  const size_t q_rs = (size_t)H * h, o_rs = (size_t)H * hv,
               k_rs = (size_t)KH * h, v_rs = (size_t)KH * hv;
  const int wk = warp * kSlice;                 // the warp's first key
  float* slice = slices + warp * kQS * kSlice;
  const float* wsk = sk + (wk + 4 * ry) * kS;   // the thread's S^T keys
  const float* wsv = sv + (wk + 4 * ry) * kSV;

  for (int pass = 0; pass < (paired ? 2 : 1); ++pass) {
    const int kt = pass == 0 ? (int)blockIdx.z : n_kt - 1 - (int)blockIdx.z;
    if (pass == 1 && kt == (int)blockIdx.z) break;  // the middle tile
    const int k0 = kt * kKT;
    const int wk0 = k0 + wk;
    // the query tiles some row of which reaches a key of this tile
    const int k_last = min(k0 + kKT, Skv) - 1;
    const int qt_begin = causal ? k0 / kQS : 0;
    int qt_end = (Sq + kQS - 1) / kQS - 1;
    if (window > 0) qt_end = min(qt_end, (k_last + window - 1) / kQS);
    const int n_qt = max(qt_end - qt_begin + 1, 0);
    const int n_steps = G * n_qt;  // (head, query tile), heads outermost

    // step s into ring stage `st`: Q, dO, lse and D of its head and tile
    auto load_step = [&](int s, int st) {
      const int head = kvh * G + s / n_qt;
      const int q0 = (qt_begin + s % n_qt) * kQS;
      float* dst = ring + st * kStep;
      load_rows<DQ, kQS, kVec>(dst, q + ((size_t)b * Sq * H + head) * h, q0,
                               Sq, h, q_rs, tid);
      load_rows<DV, kQS, kVec>(dst + kQS * kS,
                               dout + ((size_t)b * Sq * H + head) * hv, q0,
                               Sq, hv, o_rs, tid);
      // one 4-byte copy a thread: threads 0..kQS-1 the lse, then D
      if (tid < 2 * kQS) {
        const float* src =
            (tid < kQS ? lse : delta) + ((size_t)b * H + head) * Sq;
        const int row = q0 + tid % kQS;
        cp_async4(smem_addr(stats + st * 2 * kQS + tid),
                  row < Sq ? src + row : src, row < Sq ? 4 : 0);
      }
    };

    if (pass == 1) __syncthreads();  // every warp is done with tile 1's
                                     // K, V and ring
    load_rows<DQ, kKT, kVec>(sk, k + ((size_t)b * Skv * KH + kvh) * h, k0,
                             Skv, h, k_rs, tid);
    load_rows<DV, kKT, kVec>(sv, v + ((size_t)b * Skv * KH + kvh) * hv, k0,
                             Skv, hv, v_rs, tid);
    if (n_steps > 0) load_step(0, 0);
    cp_async_commit();

    float dk_acc[M::kKeys][4 * M::kCPT], dv_acc[MV::kKeys][4 * MV::kCPT];
#pragma unroll
    for (int e = 0; e < M::kKeys; ++e)
#pragma unroll
      for (int c = 0; c < 4 * M::kCPT; ++c) dk_acc[e][c] = 0.f;
#pragma unroll
    for (int e = 0; e < MV::kKeys; ++e)
#pragma unroll
      for (int c = 0; c < 4 * MV::kCPT; ++c) dv_acc[e][c] = 0.f;

    int stage = 0;
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait_all();  // this step (and K, V) has landed for this
      __syncthreads();      // thread, for every thread, and no warp still
                            // reads the other stage or its slice
      if (s + 1 < n_steps) load_step(s + 1, stage ^ 1);
      cp_async_commit();
      const int q0 = (qt_begin + s % n_qt) * kQS;
      const float* sq = ring + stage * kStep;
      const float* sdo = sq + kQS * kS;
      const float* slse = stats + stage * 2 * kQS;
      const float* sdel = slse + kQS;
      stage ^= 1;
      // no visible pair between the warp's 8 keys and the step's rows
      if (q0 >= Sq || wk0 >= Skv || (causal && q0 + kQS - 1 < wk0) ||
          (window > 0 && wk0 + kSlice - 1 <= q0 - window))
        continue;
      const bool edge = (causal && wk0 + kSlice - 1 > q0) ||
                        (window > 0 && wk0 <= q0 + kQS - 1 - window) ||
                        wk0 + kSlice > Skv || q0 + kQS > Sq;

      // S^T = K Q^T, then P^T into the slice
      float pt[4][kJ];
      dot4<DQ, kJ, 1, 16>(pt, wsk, sq + kx * kS);
      float lse_j[kJ], del_j[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        lse_j[j] = slse[kx + 16 * j];
        del_j[j] = sdel[kx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          float p = exp2f(pt[i][j] * scale_log2 - lse_j[j]);
          if (edge && !visible(q0 + kx + 16 * j, wk0 + 4 * ry + i, Sq, Skv,
                               causal, window))
            p = 0.f;
          pt[i][j] = p;
        }
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        *reinterpret_cast<float4*>(slice + (kx + 16 * j) * kSlice + 4 * ry) =
            make_float4(pt[0][j], pt[1][j], pt[2][j], pt[3][j]);

      // dP^T = V dO^T, then dS^T in its place
      float dst[4][kJ];
      dot4<DV, kJ, 1, 16>(dst, wsv, sdo + kx * kSV);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          dst[i][j] = pt[i][j] * (dst[i][j] - del_j[j]);

      __syncwarp();  // the warp's P^T is in its slice
      accumulate<DV, kQS>(dv_acc, slice, sdo, kg, cg);
      __syncwarp();  // every lane has read P^T
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        *reinterpret_cast<float4*>(slice + (kx + 16 * j) * kSlice + 4 * ry) =
            make_float4(dst[0][j], dst[1][j], dst[2][j], dst[3][j]);
      __syncwarp();  // the warp's dS^T is in its slice
      accumulate<DQ, kQS>(dk_acc, slice, sq, kg, cg);
    }
    cp_async_wait_all();  // no copy outlives the tile

    // dk (scaled) and dv: each element of the tile's keys once
    constexpr int kCPT = M::kCPT > MV::kCPT ? M::kCPT : MV::kCPT;
#pragma unroll
    for (int e = 0; e < M::kKeys; ++e) {
      const int key = wk0 + kg * M::kKeys + e;
      if (key >= Skv) continue;
      float* dkr = dk + ((size_t)b * Skv + key) * k_rs + (size_t)kvh * h;
      float* dvr = dv + ((size_t)b * Skv + key) * v_rs + (size_t)kvh * hv;
#pragma unroll
      for (int jj = 0; jj < kCPT; ++jj) {
        if (jj < M::kCPT)
          store4<kVec>(dkr, 4 * (cg + M::kCG * jj), h,
                       dk_acc[e][4 * jj] * scale,
                       dk_acc[e][4 * jj + 1] * scale,
                       dk_acc[e][4 * jj + 2] * scale,
                       dk_acc[e][4 * jj + 3] * scale);
        if (jj < MV::kCPT)
          store4<kVec>(dvr, 4 * (cg + MV::kCG * jj), hv, dv_acc[e][4 * jj],
                       dv_acc[e][4 * jj + 1], dv_acc[e][4 * jj + 2],
                       dv_acc[e][4 * jj + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq, one 128-row query tile of one head a block

template <int DQ, int DV, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_f32_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int Sq, int Skv, int H,
                            int KH, int h, int hv, int causal, int window,
                            float scale_log2, float scale) {
  constexpr int kKS = kTileK<DQ>;   // keys a K/V tile
  constexpr int kJ = kKS / 8;         // S keys a thread: kx + 8 j
  constexpr int kS = DQ + 4;          // floats a Q or K shared row
  constexpr int kSV = DV + 4;         // floats a dO or V shared row
  constexpr int kTile = kKS * kS;     // floats a K tile
  constexpr int kStage = kTile + kKS * kSV;  // a K tile and a V tile
  constexpr int kChunks = DQ / 32;    // float4 output chunks a row a thread
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                        // [kQT][kS]
  float* sdo = sq + kQT * kS;              // [kQT][kSV]
  float* skv = sdo + kQT * kSV;            // kStages x (K tile, V tile)
  float* sds = skv + kStages * kStage;     // [kKS][kPStride], dS^T

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ry = lane / 8, kx = lane % 8;  // rows ry + 4 i, keys kx + 8 j
  const int wrow = warp * 16;              // the warp's first row
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kQT;  // heaviest first
  const int wq0 = q0 + wrow;
  const int kvh = head / (H / KH);
  const int q_last = min(q0 + kQT, Sq) - 1;

  // key tiles some query of this block can reach, as the forward
  int kt_end = (Skv + kKS - 1) / kKS - 1;
  if (causal) kt_end = min(kt_end, q_last / kKS);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kKS;

  const size_t q_rs = (size_t)H * h, o_rs = (size_t)H * hv,
               k_rs = (size_t)KH * h, v_rs = (size_t)KH * hv;
  const float* kg = k + ((size_t)b * Skv * KH + kvh) * h;
  const float* vg = v + ((size_t)b * Skv * KH + kvh) * hv;

  load_rows<DQ, kQT, kVec>(sq, q + ((size_t)b * Sq * H + head) * h, q0, Sq,
                           h, q_rs, tid);
  load_rows<DV, kQT, kVec>(sdo, dout + ((size_t)b * Sq * H + head) * hv, q0,
                           Sq, hv, o_rs, tid);
  if (kt_begin <= kt_end) {
    load_rows<DQ, kKS, kVec>(skv, kg, kt_begin * kKS, Skv, h, k_rs, tid);
    load_rows<DV, kKS, kVec>(skv + kTile, vg, kt_begin * kKS, Skv, hv, v_rs,
                             tid);
  }
  cp_async_commit();

  const size_t stat0 = ((size_t)b * H + head) * Sq;
  float lse_r[4], del_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = wq0 + ry + 4 * i;
    lse_r[i] = row < Sq ? lse[stat0 + row] : 0.f;
    del_r[i] = row < Sq ? delta[stat0 + row] : 0.f;
  }

  float acc[4][4 * kChunks];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kChunks; ++c) acc[i][c] = 0.f;
  const float* sq_t = sq + (wrow + ry) * kS;   // row ry; + 4 i rows
  const float* sdo_t = sdo + (wrow + ry) * kSV;
  float* sds_t = sds + wrow + 4 * ry;          // dS^T column of row 0

  int stage = 0;
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    cp_async_wait_all();  // this tile (and Q, dO) has landed for this
    __syncthreads();      // thread, for every thread, and no warp still
                          // reads the other stage
    if (kt < kt_end) {    // the next tile into the other stage
      float* nk = skv + (stage ^ 1) * kStage;
      load_rows<DQ, kKS, kVec>(nk, kg, (kt + 1) * kKS, Skv, h, k_rs, tid);
      load_rows<DV, kKS, kVec>(nk + kTile, vg, (kt + 1) * kKS, Skv, hv, v_rs,
                               tid);
    }
    cp_async_commit();
    const float* sk = skv + stage * kStage;
    const float* sv = sk + kTile;
    const int k0 = kt * kKS;
    stage ^= 1;
    // no visible pair between the warp's 16 rows and this tile's keys
    if (wq0 >= Sq || (causal && k0 > wq0 + 15) ||
        (window > 0 && k0 + kKS - 1 <= wq0 - window))
      continue;
    const bool edge = (causal && k0 + kKS - 1 > wq0) ||
                      (window > 0 && k0 <= wq0 + 15 - window) ||
                      k0 + kKS > Skv || wq0 + 16 > Sq;

    // S = Q K^T, P, dP = dO V^T and dS = P o (dP - D) in registers
    float ds[4][kJ], dp[4][kJ];
    dot4<DQ, kJ, 4, 8>(ds, sq_t, sk + kx * kS);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        float p = exp2f(ds[i][j] * scale_log2 - lse_r[i]);
        if (edge && !visible(wq0 + ry + 4 * i, k0 + kx + 8 * j, Sq, Skv,
                             causal, window))
          p = 0.f;
        ds[i][j] = p;
      }
    dot4<DV, kJ, 4, 8>(dp, sdo_t, sv + kx * kSV);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        ds[i][j] = ds[i][j] * (dp[i][j] - del_r[i]);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      *reinterpret_cast<float4*>(sds_t + (kx + 8 * j) * kPStride) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncwarp();  // the warp reads back only its own rows of dS^T

    // dq += dS K: per key, the thread's 4 values of dS and 4 kChunks
    // columns of K
#pragma unroll 8
    for (int c = 0; c < kKS; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(sds_t + c * kPStride);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jj = 0; jj < kChunks; ++jj) {
        const float4 kk = *reinterpret_cast<const float4*>(
            sk + c * kS + 4 * (kx + 8 * jj));
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
  cp_async_wait_all();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = wq0 + ry + 4 * i;
    if (row >= Sq) continue;
    float* o = dq + ((size_t)b * Sq + row) * q_rs + (size_t)head * h;
#pragma unroll
    for (int jj = 0; jj < kChunks; ++jj)
      store4<kVec>(o, 4 * (kx + 8 * jj), h, acc[i][4 * jj] * scale,
                   acc[i][4 * jj + 1] * scale, acc[i][4 * jj + 2] * scale,
                   acc[i][4 * jj + 3] * scale);
  }
}

// ---------------------------------------------------------------------------

template <int DQ, int DV>
constexpr int smem_dkdv() {
  constexpr int kQS = kStepQ<DQ>;
  return sizeof(float) * (kKT * ((DQ + 4) + (DV + 4)) +
                          kStages * kQS * ((DQ + 4) + (DV + 4)) +
                          kStages * 2 * kQS + kWarps * kQS * kSlice);
}
template <int DQ, int DV>
constexpr int smem_dq() {
  constexpr int kKS = kTileK<DQ>;
  return sizeof(float) * (kQT * ((DQ + 4) + (DV + 4)) +
                          kStages * kKS * ((DQ + 4) + (DV + 4)) +
                          kKS * kPStride);
}

// Kernel `which` (1 D, 2 dk/dv, 3 dq) of one width pair and copy path,
// with its dynamic shared memory (set as the kernel's limit) and threads a
// block.
template <int DQ, int DV, bool kVec>
cudaError_t kernel_of(int which, const void** fn, int* smem, int* threads) {
  switch (which) {
    case 1:
      *fn = reinterpret_cast<const void*>(flash_bwd_f32_dot_kernel<kVec>);
      *smem = 0;
      *threads = kDotThreads;
      return cudaSuccess;
    case 2:
      *fn = reinterpret_cast<const void*>(
          flash_bwd_f32_dkdv_kernel<DQ, DV, kVec>);
      *smem = smem_dkdv<DQ, DV>();
      break;
    case 3:
      *fn = reinterpret_cast<const void*>(
          flash_bwd_f32_dq_kernel<DQ, DV, kVec>);
      *smem = smem_dq<DQ, DV>();
      break;
    default:
      return cudaErrorInvalidValue;
  }
  *threads = kThreads;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

template <int DQ, int DV, bool kVec>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dq, float* dk,
           float* dv, float* delta, int B, int Sq, int Skv, int H, int KH,
           int h, int hv, int causal, int window, float scale,
           cudaStream_t stream) {
  const void* fn;
  int smem[4], threads;
  for (int which = 2; which <= 3; ++which) {
    cudaError_t err =
        kernel_of<DQ, DV, kVec>(which, &fn, &smem[which], &threads);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sl2 = scale * kLog2e;
  const int rows = B * Sq * H;
  const int per_block = kDotThreads / 32;
  flash_bwd_f32_dot_kernel<kVec><<<(rows + per_block - 1) / per_block,
                                   kDotThreads, 0, stream>>>(
      o, dout, delta, rows, Sq, H, hv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = (Skv + kKT - 1) / kKT;
  const int paired = causal && n_kt > 1;
  const dim3 keys(KH, B, paired ? (n_kt + 1) / 2 : n_kt);
  flash_bwd_f32_dkdv_kernel<DQ, DV, kVec>
      <<<keys, kThreads, smem[2], stream>>>(
          q, k, v, dout, lse, delta, dk, dv, Sq, Skv, H, KH, h, hv, causal,
          window, sl2, scale, paired);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 queries(H, B, (Sq + kQT - 1) / kQT);
  flash_bwd_f32_dq_kernel<DQ, DV, kVec>
      <<<queries, kThreads, smem[3], stream>>>(
          q, k, v, dout, lse, delta, dq, Sq, Skv, H, KH, h, hv, causal,
          window, sl2, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation index of padded widths (width, vwidth): 0..3 for
// (32, 32), (64, 64), (128, 128), (192, 128); -1 for any other pair.
int instantiation(int width, int vwidth) {
  if (width == vwidth && (width == 32 || width == 64 || width == 128))
    return width == 32 ? 0 : width == 64 ? 1 : 2;
  return width == 192 && vwidth == 128 ? 3 : -1;
}

template <bool kVec>
int launch_width(int which, const float* q, const float* k, const float* v,
                 const float* o, const float* dout, const float* lse,
                 float* dq, float* dk, float* dv, float* ws, int B, int Sq,
                 int Skv, int H, int KH, int h, int hv, int causal,
                 int window, float scale, cudaStream_t s) {
  switch (which) {
    case 0:
      return launch<32, 32, kVec>(q, k, v, o, dout, lse, dq, dk, dv, ws, B,
                                  Sq, Skv, H, KH, h, hv, causal, window,
                                  scale, s);
    case 1:
      return launch<64, 64, kVec>(q, k, v, o, dout, lse, dq, dk, dv, ws, B,
                                  Sq, Skv, H, KH, h, hv, causal, window,
                                  scale, s);
    case 2:
      return launch<128, 128, kVec>(q, k, v, o, dout, lse, dq, dk, dv, ws, B,
                                    Sq, Skv, H, KH, h, hv, causal, window,
                                    scale, s);
    case 3:
      return launch<192, 128, kVec>(q, k, v, o, dout, lse, dq, dk, dv, ws, B,
                                    Sq, Skv, H, KH, h, hv, causal, window,
                                    scale, s);
    default:
      return 1001;
  }
}

template <bool kVec>
int info_width(int which, int pair, const void** fn, int* smem,
               int* threads) {
  switch (pair) {
    case 0:
      return static_cast<int>(
          kernel_of<32, 32, kVec>(which, fn, smem, threads));
    case 1:
      return static_cast<int>(
          kernel_of<64, 64, kVec>(which, fn, smem, threads));
    case 2:
      return static_cast<int>(
          kernel_of<128, 128, kVec>(which, fn, smem, threads));
    case 3:
      return static_cast<int>(
          kernel_of<192, 128, kVec>(which, fn, smem, threads));
    default:
      return 1001;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// q, k, v, o, dout are the forward's f32 inputs, its output and the
// output's gradient, contiguous; lse is the f32 forward's [B, H, Sq]
// log2-domain log-sum-exp; dq, dk, dv are written in f32. ws holds
// B * H * Sq floats (D). width and vwidth are the padded q/k and v widths
// that hold h and hv: (32, 32), (64, 64), (128, 128) or (192, 128); vec =
// 1 takes 16-byte copies and stores and needs h and hv multiples of 4 and
// the eight tensors 16-byte aligned, vec = 0 takes 4-byte ones of any
// shape; scale is 1 / sqrt(h). Returns a cudaError_t; 1001 for an
// unsupported argument.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* ws, int B, int Sq, int Skv, int H, int KH, int h, int hv,
    int causal, int window, float scale, int width, int vwidth, int vec,
    void* stream) {
  if (h < 1 || hv < 1 || h > width || hv > vwidth || KH < 1 ||
      H % KH != 0 || B > 65535 || (Sq + kQT - 1) / kQT > 65535 ||
      (Skv + kKT - 1) / kKT > 65535 ||
      (long long)B * Sq * H > 0x7fffffffLL - kDotThreads ||
      (vec != 0 && vec != 1))
    return 1001;
  if (vec && (h % 4 || hv % 4 || !aligned16(q) || !aligned16(k) ||
              !aligned16(v) || !aligned16(o) || !aligned16(dout) ||
              !aligned16(dq) || !aligned16(dk) || !aligned16(dv)))
    return 1001;
  const int which = instantiation(width, vwidth);
  if (which < 0) return 1001;
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *tq = static_cast<const float*>(q),
              *tk = static_cast<const float*>(k),
              *tv = static_cast<const float*>(v),
              *to = static_cast<const float*>(o),
              *tdo = static_cast<const float*>(dout),
              *tl = static_cast<const float*>(lse);
  float *gq = static_cast<float*>(dq), *gk = static_cast<float*>(dk),
        *gv = static_cast<float*>(dv), *w = static_cast<float*>(ws);
  return vec ? launch_width<true>(which, tq, tk, tv, to, tdo, tl, gq, gk, gv,
                                  w, B, Sq, Skv, H, KH, h, hv, causal, window,
                                  scale, s)
             : launch_width<false>(which, tq, tk, tv, to, tdo, tl, gq, gk,
                                   gv, w, B, Sq, Skv, H, KH, h, hv, causal,
                                   window, scale, s);
}

// Registers a thread, local (spill) bytes a thread, dynamic shared bytes a
// block and blocks an SM holds of kernel `which` (1 D, 2 dk/dv, 3 dq) at
// padded widths (width, vwidth) on copy path `vec` (1: 16-byte, 0:
// 4-byte). Returns a cudaError_t; 1001 for an unsupported argument.
extern "C" int flash_attention_bwd_info(int which, int width, int vwidth,
                                        int vec, int* regs,
                                        int* local_bytes, int* smem,
                                        int* blocks) {
  const void* fn = nullptr;
  int threads = 0;
  const int pair = instantiation(width, vwidth);
  const int err =
      vec ? info_width<true>(which, pair, &fn, smem, &threads)
          : info_width<false>(which, pair, &fn, smem, &threads);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, threads, *smem));
}
