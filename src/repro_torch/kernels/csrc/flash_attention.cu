// Blockwise causal / sliding-window GQA attention with an online softmax,
// in f32 on the CUDA cores: the port's f32 check path.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel) for f32 inputs:
//
//     q [B, Sq, H, h], k [B, Skv, K, h], v [B, Skv, K, hv], H = K * G
//     s[i, j]   = (q_i . k_j) / sqrt(h), or -1e30 where masked
//                 (causal: j <= i; window w > 0: j > i - w)
//     out[i, :] = sum_j softmax_j(s[i, :]) v_j           in f32
//
// The running max m, the running sum l and the accumulator are f32; the
// output is acc / max(l, 1e-30), as in the TPU kernel. bf16 inputs go to
// csrc/flash_attention_bf16.cu, on the tensor cores. f32 stays here, on
// the CUDA cores, because the tensor cores would compute it as TF32 (a
// 10-bit mantissa): that breaks the 2e-5 f32 tolerance against the plain
// version and the full-depth f32 prefill-vs-decode check (1e-3) by which
// the port proves its model arithmetic. f32 is a check path, not the
// serving type.
//
// Bound on an H100: at the yi-6b prefill shape in f32 (q [4,1024,32,128],
// causal) the visible pairs need 34.4 GFLOP against 151 MB of input and
// output, so the bound is the f32 rate of the CUDA cores (513 us at 67
// TFLOP/s). An FMA needs its operands from shared memory, which serves
// one wavefront (128 bytes) a clock against four warp FMAs, so the design
// is about FMAs per shared-memory load:
//
// - Grid (H, B, query tiles of 64 rows), 4 warps; each warp owns 16 whole
//   query rows. Lane = 8 * ry + kx: a thread owns rows ry + 4 i (i < 4)
//   of its warp's 16. The query tile is the slowest grid axis and runs in
//   reverse, so the heaviest causal tiles start first. The block reads k
//   and v of kv head `head / G` in place, with no repeat over the group.
// - S = Q K^T on a 4 x 4 register tile a thread: rows ry + 4 i, keys
//   kx + 8 j of a 32-key tile, read along d as float4 (LDS.128) from
//   row-major tiles of stride D + 4 floats: 8 loads feed 64 FMAs. The 8
//   lanes of a quarter-warp read 8 consecutive rows of K (their 16-byte
//   chunks fall in 8 distinct bank groups) and one row of Q (a
//   broadcast).
// - P goes to shared memory transposed, [key][row] with the warp's rows
//   ordered ry * 4 + i, so P.V reads a thread's 4 probabilities of a key
//   as one float4 beside 4 float4 of V (columns 4 (kx + 8 j) .. + 3): 5
//   loads feed 64 FMAs on a 4 x 16 output tile. A warp reads back only its
//   own rows of P: __syncwarp, no block barrier.
// - K and V come in 32-key tiles through a ring of 2 stages, filled with
//   16-byte cp.async.cg copies: tile j + 1 is in flight while tile j is
//   multiplied. One block barrier a tile: once tile j has landed and
//   every warp is past tile j - 1, tile j + 1 is issued into the stage
//   that j - 1 left. Q is copied once. A thread keeps one column of a
//   tile and steps down its rows, so a copy costs an add and a compare.
//   Where h or hv is not a multiple of 4 or a pointer is not 16-byte
//   aligned, the same elements go into the same layout by 4-byte
//   cp.async.ca copies (the kVec = false path, chosen by the wrapper's
//   plan).
// - Softmax in the log2 domain: the scale is log2(e)/sqrt(h) and the
//   exponentials are exp2f. Row max by shuffles over the 8 lanes of a
//   row; each lane keeps its part of l, summed once at the end.
// - Tiles no query of the block can reach are never loaded, as
//   pl.when(reachable) skips them; masks are applied only on tiles that
//   cross the causal diagonal, the window's edge or the end of the keys.
//   A masked key scores -1e30 (a row's first visible key resets m, and
//   exp2(-1e30 - m) = 0), a key past Skv scores -inf so its probability
//   is exactly 0, query rows past Sq are not written, and neither length
//   has to divide a tile.
// - The log-sum-exp for the backward: where the optional `lse` pointer
//   (f32 [B, H, Sq]) is not null, the lane that holds a row's finished sum
//   writes m + log2 max(l, 1e-30) in the log2 domain, the value
//   csrc/flash_attention_bwd.cu takes instead of recomputing it. The
//   output's arithmetic does not depend on it, so its bytes are the same
//   with and without it; serving passes null.
//
// Shapes: h <= 192 and hv <= 128, any values. The kernel is instantiated
// at a padded q/k width DQ and v width DV (zero-filled past h and hv):
// DQ = DV = D of 32, 64 or 128, or DQ = 192 with DV = 128 (deepseek-v3's
// MLA prefill, h = 128 + 64, hv = 128). Q and K rows are DQ + 4 floats in
// shared memory, V rows DV + 4; the score tile (64 x 32) and the 4 x 16
// output register tile (DV = 128) are the same at every width, and S
// walks DQ along d. Shared memory: (64 (DQ + 4) + 2 * 32 (DQ + 4 + DV +
// 4)) * 4 + 32 * 68 * 4 bytes, above the 48 KB default and set per
// launch: 110,080 at D = 128 (2 blocks per SM) and 142,848 at (192, 128),
// one block (4 warps) per SM: the 50 KB Q tile and the 192-float K rows
// do not fit twice in the SM's 228 KB. A row of 192 floats is copied as
// a 128-float and a 64-float part, so that each part's copies are whole
// rounds of the block's threads (16- or 4-byte copies alike). Bound at
// the f32 check shape (q [1, 256, 128, 192], v width 128, causal): 2.7
// GFLOP on the CUDA cores, 40.2 us at 67 TFLOP/s.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block, 16 per warp
constexpr int kBK = 32;        // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;     // K/V ring
constexpr int kRows = 4;       // query rows per thread
constexpr int kKeys = 4;       // keys per thread in S
constexpr int kPStride = kBQ + 4;  // floats per key row of the P tile
constexpr float kMasked = -1e30f;
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
// zero-filled. kVec: 16-byte copies (width % 4 == 0, 16-byte aligned
// rows), else 4-byte copies of the same elements. A thread keeps one
// column and steps down the rows.
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

// All D columns of the rows: in one part, or at D = 192 as columns
// 0 .. 127 and 128 .. 191.
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

template <int DQ, int DV, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int H, int KH,
                     int h, int hv, int causal, int window,
                     float scale_log2) {
  constexpr int kS = DQ + 4;          // floats per Q or K shared row
  constexpr int kSV = DV + 4;         // floats per V shared row
  constexpr int kTile = kBK * kS;     // floats per K tile
  constexpr int kStage = kTile + kBK * kSV;  // a K tile and a V tile
  constexpr int kChunksO = DV / 32;   // float4 output chunks per row
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                          // [kBQ][kS]
  float* skv = sq + kBQ * kS;                // kStages x (K tile, V tile)
  float* sp = skv + kStages * kStage;        // [kBK][kPStride], P^T

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ry = lane / 8, kx = lane % 8;
  const int wrow = warp * 16;        // the warp's first row in the tile
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int kvh = head / (H / KH);
  const int q_last = min(q0 + kBQ, Sq) - 1;

  // kv tiles some query of this block can reach, as pl.when(reachable)
  const int n_kv = (Skv + kBK - 1) / kBK;
  int kt_end = n_kv - 1;
  if (causal) kt_end = min(kt_end, q_last / kBK);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  const size_t q_rs = (size_t)H * h, k_rs = (size_t)KH * h,
               v_rs = (size_t)KH * hv;
  const float* qg = q + ((size_t)b * Sq * H + head) * h;
  const float* kg = k + ((size_t)b * Skv * KH + kvh) * h;
  const float* vg = v + ((size_t)b * Skv * KH + kvh) * hv;

  load_rows<DQ, kBQ, kVec>(sq, qg, q0, Sq, h, q_rs, tid);
  if (kt_begin <= kt_end) {
    load_rows<DQ, kBK, kVec>(skv, kg, kt_begin * kBK, Skv, h, k_rs, tid);
    load_rows<DV, kBK, kVec>(skv + kTile, vg, kt_begin * kBK, Skv, hv, v_rs,
                             tid);
  }
  cp_async_commit();

  float acc[kRows][4 * kChunksO];
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = kMasked;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kChunksO; ++c) acc[i][c] = 0.f;
  }
  const float* sq_t = sq + (wrow + ry) * kS;         // row ry; + 4 i rows
  float* sp_t = sp + wrow + 4 * ry;                  // P^T column of row 0

  int stage = 0;
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    cp_async_wait_all();  // this tile (and Q) has landed for this thread,
    __syncthreads();      // for every thread, and no warp still reads the
                          // other stage
    if (kt < kt_end) {    // the next tile into the other stage
      float* nk = skv + (stage ^ 1) * kStage;
      load_rows<DQ, kBK, kVec>(nk, kg, (kt + 1) * kBK, Skv, h, k_rs, tid);
      load_rows<DV, kBK, kVec>(nk + kTile, vg, (kt + 1) * kBK, Skv, hv, v_rs,
                               tid);
    }
    cp_async_commit();
    const float* sk = skv + stage * kStage;
    const float* sv = sk + kTile;
    const int k0 = kt * kBK;

    // S = Q K^T: rows ry + 4 i, keys kx + 8 j
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQ; d += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sq_t + 4 * i * kS + d);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sk + (kx + 8 * j) * kS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    const bool edge = (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window) ||
                      k0 + kBK > Skv;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + wrow + ry + 4 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float x = s[i][j] * scale_log2;
        if (edge) {
          const int key = k0 + kx + 8 * j;
          const bool visible = (!causal || key <= row) &&
                               (window <= 0 || key > row - window);
          // a masked key scores -1e30 as in the TPU kernel; a key past
          // Skv does not exist and gets -inf, so its probability is 0
          x = key >= Skv ? -INFINITY : (visible ? x : kMasked);
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float corr = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
      l_run[i] = l_run[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < 4 * kChunksO; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      *reinterpret_cast<float4*>(sp_t + (kx + 8 * j) * kPStride) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();  // this warp's probabilities are in sp; it alone reads
                   // them, before it writes the next tile's

    // O += P V: per key, 4 probabilities and 4 * kChunksO columns
#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(sp_t + c * kPStride);
#pragma unroll
      for (int jj = 0; jj < kChunksO; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(
            sv + c * kSV + 4 * (kx + 8 * jj));
        const float pr[kRows] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][4 * jj + 0] = fmaf(pr[i], vv.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(pr[i], vv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pr[i], vv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pr[i], vv.w, acc[i][4 * jj + 3]);
        }
      }
    }
    stage ^= 1;
  }
  cp_async_wait_all();  // no copy outlives the block

  // whole-row sums, then acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const float denom = fmaxf(l, 1e-30f);
    const int row = q0 + wrow + ry + 4 * i;
    if (row >= Sq) continue;
    if (lse != nullptr && kx == 0)  // one lane of the row's 8
      lse[((size_t)b * H + head) * Sq + row] = m_run[i] + log2f(denom);
    float* o = out + ((size_t)b * Sq + row) * H * hv + (size_t)head * hv;
#pragma unroll
    for (int jj = 0; jj < kChunksO; ++jj) {
      const int col = 4 * (kx + 8 * jj);
      const float4 r = make_float4(
          acc[i][4 * jj] / denom, acc[i][4 * jj + 1] / denom,
          acc[i][4 * jj + 2] / denom, acc[i][4 * jj + 3] / denom);
      if (kVec) {
        if (col < hv) *reinterpret_cast<float4*>(o + col) = r;
      } else {
        const float rr[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < hv) o[col + e] = rr[e];
      }
    }
  }
}

// Dynamic shared memory of one block: the Q tile, the K/V ring and P^T.
template <int DQ, int DV>
constexpr int smem_bytes() {
  return sizeof(float) * (kBQ * (DQ + 4) +
                          kStages * kBK * ((DQ + 4) + (DV + 4)) +
                          kBK * kPStride);
}

template <int DQ, int DV, bool kVec>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_f32_kernel<DQ, DV, kVec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<DQ, DV>());
}

template <int DQ, int DV, bool kVec>
int occupancy(int* blocks, int* smem) {
  cudaError_t err = allow_smem<DQ, DV, kVec>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = smem_bytes<DQ, DV>();
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_f32_kernel<DQ, DV, kVec>, kThreads,
      smem_bytes<DQ, DV>()));
}

template <int DQ, int DV, bool kVec>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int H, int KH, int h, int hv,
           int causal, int window, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem<DQ, DV, kVec>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_f32_kernel<DQ, DV, kVec>
      <<<grid, kThreads, smem_bytes<DQ, DV>(), stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), lse, Sq,
          Skv, H, KH, h, hv, causal, window, scale * kLog2e);
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
int launch_width(int which, const void* q, const void* k, const void* v,
                 void* out, float* lse, int B, int Sq, int Skv, int H, int KH,
                 int h, int hv, int causal, int window, float scale,
                 cudaStream_t s) {
  switch (which) {
    case 0:
      return launch<32, 32, kVec>(q, k, v, out, lse, B, Sq, Skv, H, KH, h,
                                  hv, causal, window, scale, s);
    case 1:
      return launch<64, 64, kVec>(q, k, v, out, lse, B, Sq, Skv, H, KH, h,
                                  hv, causal, window, scale, s);
    case 2:
      return launch<128, 128, kVec>(q, k, v, out, lse, B, Sq, Skv, H, KH, h,
                                    hv, causal, window, scale, s);
    case 3:
      return launch<192, 128, kVec>(q, k, v, out, lse, B, Sq, Skv, H, KH, h,
                                    hv, causal, window, scale, s);
    default:
      return 1001;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// q, k, v and out are f32; width and vwidth are the padded q/k and v
// widths that hold h and hv: (32, 32), (64, 64), (128, 128) or (192,
// 128); vec = 1 takes 16-byte copies and needs h and hv multiples of 4 and
// all four pointers 16-byte aligned, vec = 0 takes 4-byte copies of any
// shape. lse is null or an f32 [B, H, Sq] array that receives each row's
// log2-domain log-sum-exp. Returns a cudaError_t; 1001 for an unsupported
// argument.
extern "C" int flash_attention_lse_launch(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int Sq, int Skv, int H, int KH,
                                          int h, int hv, int causal,
                                          int window, float scale, int width,
                                          int vwidth, int vec, void* lse,
                                          void* stream) {
  if (h < 1 || hv < 1 || h > width || hv > vwidth || KH < 1 ||
      H % KH != 0 || B > 65535 || (Sq + kBQ - 1) / kBQ > 65535 ||
      (vec != 0 && vec != 1))
    return 1001;
  if (vec && (h % 4 || hv % 4 || !aligned16(q) || !aligned16(k) ||
              !aligned16(v) || !aligned16(out)))
    return 1001;
  const int which = instantiation(width, vwidth);
  if (which < 0) return 1001;
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return vec ? launch_width<true>(which, q, k, v, out, l, B, Sq, Skv, H, KH,
                                  h, hv, causal, window, scale, s)
             : launch_width<false>(which, q, k, v, out, l, B, Sq, Skv, H, KH,
                                   h, hv, causal, window, scale, s);
}

// The same without the log-sum-exp (lse = null).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int KH, int h, int hv,
                                      int causal, int window, float scale,
                                      int width, int vwidth, int vec,
                                      void* stream) {
  return flash_attention_lse_launch(q, k, v, out, B, Sq, Skv, H, KH, h, hv,
                                    causal, window, scale, width, vwidth, vec,
                                    nullptr, stream);
}

// The blocks of the kernel at padded widths (width, vwidth) (16-byte
// copies) that one SM holds at once, and its dynamic shared memory per
// block. Returns a cudaError_t; 1001 for an unsupported pair.
extern "C" int flash_attention_occupancy(int width, int vwidth, int* blocks,
                                         int* smem) {
  switch (instantiation(width, vwidth)) {
    case 0:
      return occupancy<32, 32, true>(blocks, smem);
    case 1:
      return occupancy<64, 64, true>(blocks, smem);
    case 2:
      return occupancy<128, 128, true>(blocks, smem);
    case 3:
      return occupancy<192, 128, true>(blocks, smem);
    default:
      return 1001;
  }
}
