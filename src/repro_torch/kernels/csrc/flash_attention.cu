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
// Design. One block per (query tile of 64 rows, head, batch). The block
// reads k/v of kv head `head / G` in place (the TPU wrapper's jnp.repeat
// of k/v over the group is its layout, not the function). It walks the kv
// tiles of 64 rows that the query tile can reach and skips the others,
// as pl.when(reachable) does: a tile is skipped only if every (query,
// key) pair in it is masked, so the -1e30 fill never decides a row's
// result (a row's first visible key resets m, and exp(-1e30 - m) = 0).
// Keys past Skv (a ragged last tile) get probability exactly 0 and query
// rows past Sq are not written, so neither length has to divide 64, and
// hv may differ from h (both <= 128).
//
// 256 threads: thread t owns query rows 4 * (t / 16) .. + 3, score
// columns (t % 16) + 16 j (j < 4) and output columns (t % 16) + 16 j
// (j < 8). The 16 lanes that share rows are one half-warp, so row max
// and row sum are shuffle reductions and the probabilities they write to
// shared memory are read back by the same half-warp (__syncwarp, no
// block barrier). Tiles are staged in shared memory with a padded row
// stride (h + 1), so the column-strided reads hit distinct banks.
// Shared memory: (64 (h+1) * 2 + 64 hv + 64 * 65) * 4 bytes, 115,456 at
// h = hv = 128, above the 48 KB default and set per launch.
//
// Bound on an H100: at the yi-6b prefill shape in f32 (q [4,1024,32,128],
// causal) the work is ~34 GFLOP against ~151 MB of input and output, so
// the bound is the f32 rate of the CUDA cores (~513 us at 67 TFLOP/s).
// The kernel is limited by shared-memory reads and sits above that.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;
constexpr int kMaxHead = 128;  // largest h and hv
constexpr int kRows = 4;       // query rows per thread
constexpr int kColsS = kBK / 16;       // score columns per thread
constexpr int kColsO = kMaxHead / 16;  // output columns per thread
constexpr int kPStride = kBK + 1;
constexpr float kMasked = -1e30f;

__global__ void __launch_bounds__(kThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Sq, int Skv, int H, int KH, int h, int hv,
                     int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int hs = h + 1;
  float* sq = smem;              // [kBQ][hs]
  float* sk = sq + kBQ * hs;     // [kBK][hs]
  float* sv = sk + kBK * hs;     // [kBK][hv]
  float* sp = sv + kBK * hv;     // [kBQ][kPStride] probabilities

  const int tid = threadIdx.x;
  const int rg = tid / 16;       // rows rg * 4 .. rg * 4 + 3
  const int cl = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (H / KH);
  const int q_last = min(q0 + kBQ, Sq) - 1;

  for (int i = tid; i < kBQ * h; i += kThreads) {
    const int r = i / h, d = i % h, qi = q0 + r;
    sq[r * hs + d] =
        qi < Sq ? q[((size_t)(b * (size_t)Sq + qi) * H + head) * h + d]
                : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kColsO];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kColsO; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = (Skv + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    // tile-level reachability, uniform over the block
    if (causal && k0 > q_last) break;
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;

    __syncthreads();  // the previous tile's reads of sk / sv are done
    for (int i = tid; i < kBK * h; i += kThreads) {
      const int r = i / h, d = i % h, kj = k0 + r;
      sk[r * hs + d] =
          kj < Skv
              ? k[((size_t)(b * (size_t)Skv + kj) * KH + kvh) * h + d]
              : 0.f;
    }
    for (int i = tid; i < kBK * hv; i += kThreads) {
      const int r = i / hv, d = i % hv, kj = k0 + r;
      sv[r * hv + d] =
          kj < Skv
              ? v[((size_t)(b * (size_t)Skv + kj) * KH + kvh) * hv + d]
              : 0.f;
    }
    __syncthreads();

    float s[kRows][kColsS];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kColsS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < h; ++d) {
      float qv[kRows], kv[kColsS];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sq[(rg * kRows + i) * hs + d];
#pragma unroll
      for (int j = 0; j < kColsS; ++j) kv[j] = sk[(cl + 16 * j) * hs + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kColsS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + rg * kRows + i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsS; ++j) {
        const int kj = k0 + cl + 16 * j;
        const bool visible = (!causal || kj <= qi) &&
                             (window <= 0 || kj > qi - window);
        // a masked key scores -1e30 as in the TPU kernel; a key past Skv
        // does not exist and gets -inf, so its probability is exactly 0
        const float x = kj >= Skv ? -INFINITY
                                  : (visible ? s[i][j] * scale : kMasked);
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsS; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        sp[(rg * kRows + i) * kPStride + cl + 16 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kColsO; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // this half-warp's probabilities are in sp

#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = sp[(rg * kRows + i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kColsO; ++j) {
        const int col = cl + 16 * j;
        if (col < hv) {
          const float vv = sv[c * hv + col];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
    __syncwarp();  // sp is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + rg * kRows + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + ((size_t)(b * (size_t)Sq + qi) * H + head) * hv;
#pragma unroll
    for (int j = 0; j < kColsO; ++j) {
      const int col = cl + 16 * j;
      if (col < hv) o[col] = acc[i][j] / denom;
    }
  }
}

}  // namespace

// q, k, v and out are f32. Returns a cudaError_t; 1001 for an unsupported
// argument.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int KH, int h, int hv,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (h < 1 || hv < 1 || h > kMaxHead || hv > kMaxHead || KH < 1 ||
      H % KH != 0)
    return 1001;
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * (h + 1) + (size_t)kBK * (h + 1) +
                       (size_t)kBK * hv + (size_t)kBQ * kPStride);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_f32_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, KH,
      h, hv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}
