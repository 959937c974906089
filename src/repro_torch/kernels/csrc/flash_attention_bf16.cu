// Blockwise causal / sliding-window GQA attention in bf16 on the tensor
// cores, with an online softmax in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel) for bf16 inputs:
//
//     q [B, Sq, H, h], k [B, Skv, K, h], v [B, Skv, K, hv], H = K * G
//     s[i, j]   = (q_i . k_j) / sqrt(h), or -1e30 where masked
//                 (causal: j <= i; window w > 0: j > i - w)
//     out[i, :] = sum_j softmax_j(s[i, :]) v_j           in bf16
//
// As in the TPU kernel, the running max m, the running sum l and the
// accumulator are f32, and the output is acc / max(l, 1e-30). The
// unnormalised probabilities enter the P.V product rounded to bf16 (the
// tensor cores take bf16 operands); l sums them unrounded.
//
// Bound on an H100: at the yi-6b prefill shape (q [4,1024,32,128],
// k/v [4,1024,4,128], causal) the visible pairs need 34.4 GFLOP against
// 75.5 MB of input and output, so the bound is the bf16 tensor-core rate
// (34.8 us at 989 TFLOP/s). The design keeps both products on the tensor
// cores and every intermediate in registers:
//
// - Grid (H, B, query tiles of 64 rows), 4 warps. Each warp owns 16 whole
//   query rows, so a row's max and sum are shuffles within a quad of
//   lanes (xor 1, 2), never shared memory. The query tile is the slowest
//   grid axis and runs in reverse, so the heaviest causal tiles of every
//   head start first and the tail on 132 SMs is short. The block reads k
//   and v of kv head `head / G` in place, with no repeat over the group.
// - Q is copied once with cp.async to shared memory and moved with
//   ldmatrix.x4 into registers (the A fragments of m16n8k16), where it
//   stays for the block's life; at q/k width 192 it stays in shared
//   memory instead and each key tile reads its fragments again by
//   ldmatrix (below).
// - K and V come in 64-row tiles through a ring of 2 stages, filled with
//   16-byte cp.async.cg copies: the next tile loads while this one is
//   multiplied. Shared-memory rows are padded by 16 bytes, so the 8 rows
//   that one ldmatrix phase reads fall in 8 distinct bank groups.
// - S = Q.K^T by mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with K
//   fragments from ldmatrix (K rows are the B operand's columns: no
//   transpose). The scale is folded into log2(e)/sqrt(h) and the
//   exponentials are exp2f.
// - Masks are applied only on tiles that cross the causal diagonal, the
//   window's edge or the end of the keys; tiles no query of the block can
//   reach are never loaded. A masked key scores -1e30 (a row's first
//   visible key resets m, and exp(-1e30 - m) = 0), a key past Skv scores
//   -inf so its probability is exactly 0, query rows past Sq are not
//   written, and neither length has to divide 64.
// - P.V: the f32 accumulator layout of m16n8 is the A-operand layout of
//   m16n8k16, so P is rounded to bf16 in registers and used directly;
//   V fragments come by ldmatrix.trans. O stays in f32 registers and
//   leaves through shared memory as 16-byte rows.
// - Optionally, each query row's log2-domain log-sum-exp m + log2(l) (the
//   scaled scores' running max and sum) goes to an f32 [B, H, Sq] output
//   for the backward kernel (csrc/flash_attention_bwd_bf16.cu). With a
//   null pointer nothing is written; the output's arithmetic is the same
//   either way, so its bytes do not depend on it.
//
// Shapes: h up to 192 and hv up to 128, multiples of 16. The kernel is
// instantiated at a padded q/k width DQ and v width DV, zero-filled past
// h and hv: DQ = DV = D of 32, 64 or 128, or DQ = 192 with DV = 128
// (deepseek-v3's MLA prefill: h = 128 + 64 with the rope key folded into
// each head, hv = 128). Shared memory: (64 (DQ + 8) + 2 * 64 (DQ + 8 +
// DV + 8)) * 2 bytes, above the 48 KB default and set per launch: 87,040
// at D = 128 and 111,616 at (192, 128), 2 blocks per SM either way.
//
// At (192, 128) the 48 registers a lane of Q's fragments would not fit
// beside S (32), the 128-wide O accumulator (64) and the addressing under
// 255 (the D = 128 kernel already holds 254), so the wide instantiation
// reads Q's A fragments from its shared tile by ldmatrix at each key tile
// (12 ldmatrix.x4 a warp against the tile's 48 for K and 32 for V). Its
// bound at the MLA serving shape (q [4, 1024, 128, 192], v width 128,
// causal, G = 1) is bytes: 671.1 MB in and out take 200.3 us at 3.35
// TB/s against 172.0 GFLOP's 173.9 us; K and V are as wide as Q there,
// so each block reads a whole head's K and V for 64 query rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;      // query rows per block, 16 per warp
constexpr int kBK = 64;      // kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;   // K/V ring
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

// d += a . b on one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy `kRows` rows of `width` bf16 (a multiple of 8) from rows row0.. of
// a [n_rows, row_stride] global matrix into shared rows of D + 8 bf16,
// columns 0 .. D - 1; rows past n_rows and columns past width are
// zero-filled.
template <int D, int kRows>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int row0, int n_rows, int width,
                                          size_t row_stride, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(kRows * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n_rows && c * 8 < width;
    const bf16* p = in ? src + (size_t)(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + (r * (D + 8) + c * 8) * 2, p, in ? 16 : 0);
  }
}

template <int DQ, int DV>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Skv, int H,
                      int KH, int h, int hv, int causal, int window,
                      float scale_log2) {
  static_assert(DV <= DQ, "the output is staged in Q's rows");
  constexpr int kStride = DQ + 8;        // bf16 per Q or K shared row
  constexpr int kStrideV = DV + 8;       // bf16 per V shared row
  constexpr int kTile = kBK * kStride;   // bf16 per K tile
  constexpr int kStage = kTile + kBK * kStrideV;  // a K tile and a V tile
  constexpr bool kHoldQ = DQ <= 128;     // Q's fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][kStride]
  bf16* skv = sq + kBQ * kStride;  // kStages x ([kBK][kStride] K, then V)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;  // quad and lane in quad
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
  const bf16* qg = q + ((size_t)b * Sq * H + head) * h;
  const bf16* kg = k + ((size_t)b * Skv * KH + kvh) * h;
  const bf16* vg = v + ((size_t)b * Skv * KH + kvh) * hv;

  load_rows<DQ, kBQ>(smem_addr(sq), qg, q0, Sq, h, q_rs, tid);
  if (kt_begin <= kt_end) {
    load_rows<DQ, kBK>(smem_addr(skv), kg, kt_begin * kBK, Skv, h, k_rs, tid);
    load_rows<DV, kBK>(smem_addr(skv + kTile), vg, kt_begin * kBK, Skv, hv,
                       v_rs, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16 columns (held
  // only where they fit; else read from sq at each key tile)
  const bf16* wq = sq + (warp * 16 + lane % 16) * kStride + (lane / 16) * 8;
  uint32_t qf[kHoldQ ? DQ / 16 : 1][4];
  if constexpr (kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk)
      ldmatrix_x4(smem_addr(wq + kk * 16), qf[kk][0], qf[kk][1], qf[kk][2],
                  qf[kk][3]);
  }

  float o[DV / 8][4];
#pragma unroll
  for (int t = 0; t < DV / 8; ++t)
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  // rows row0 (accumulator elements 0, 1) and row0 + 8 (elements 2, 3)
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;

  int stage = 0;
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    if (kt < kt_end) {  // the next tile into the other stage
      bf16* nk = skv + (stage ^ 1) * kStage;
      load_rows<DQ, kBK>(smem_addr(nk), kg, (kt + 1) * kBK, Skv, h, k_rs,
                         tid);
      load_rows<DV, kBK>(smem_addr(nk + kTile), vg, (kt + 1) * kBK, Skv, hv,
                         v_rs, tid);
    }
    cp_async_commit();
    const bf16* sk = skv + stage * kStage;
    const bf16* sv = sk + kTile;
    const int k0 = kt * kBK;

    // S = Q K^T: 8 column tiles of 8 keys, each 16 rows x 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (kHoldQ) {
        qa[0] = qf[kk][0];
        qa[1] = qf[kk][1];
        qa[2] = qf[kk][2];
        qa[3] = qf[kk][3];
      } else {
        ldmatrix_x4(smem_addr(wq + kk * 16), qa[0], qa[1], qa[2], qa[3]);
      }
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(smem_addr(sk + (np * 16 + lane % 8 + (lane / 16) * 8) *
                                       kStride +
                              kk * 16 + ((lane / 8) % 2) * 8),
                    b0, b1, b2, b3);
        mma_bf16(s[2 * np], qa, b0, b1);
        mma_bf16(s[2 * np + 1], qa, b2, b3);
      }
    }

    const bool edge = (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window) ||
                      k0 + kBK > Skv;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * tg + e % 2;
          const int row = row0 + (e / 2) * 8;
          const bool visible = (!causal || key <= row) &&
                               (window <= 0 || key > row - window);
          x = key >= Skv ? -INFINITY : (visible ? x : kMasked);
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_run[e / 2]);
        sum[e / 2] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + sum[r];
#pragma unroll
    for (int t = 0; t < DV / 8; ++t) {
      o[t][0] *= corr[0];
      o[t][1] *= corr[0];
      o[t][2] *= corr[1];
      o[t][3] *= corr[1];
    }

    // O += P V: P from the S accumulators, 16 keys per step
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(
            smem_addr(sv + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                               kStrideV +
                      dp * 16 + (lane / 16) * 8),
            b0, b1, b2, b3);
        mma_bf16(o[2 * dp], a, b0, b1);
        mma_bf16(o[2 * dp + 1], a, b2, b3);
      }
    }

    cp_async_wait_all();  // the next tile has landed
    __syncthreads();      // and every warp is done with this one
    stage ^= 1;
  }

  // whole-row sums, then O / max(l, 1e-30) through this warp's Q rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-30f);
  }
  if (lse != nullptr && tg == 0) {  // one lane of each quad, both its rows
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < Sq)
        lse[((size_t)b * H + head) * Sq + row0 + 8 * r] =
            m_run[r] + log2f(l_run[r]);
  }
  bf16* so = sq + warp * 16 * kStride;
#pragma unroll
  for (int t = 0; t < DV / 8; ++t) {
    *reinterpret_cast<uint32_t*>(so + g * kStride + 8 * t + 2 * tg) =
        pack_bf16(o[t][0] / l_run[0], o[t][1] / l_run[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kStride + 8 * t + 2 * tg) =
        pack_bf16(o[t][2] / l_run[1], o[t][3] / l_run[1]);
  }
  __syncwarp();
  const int chunks = hv / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = i % chunks;
    const int qi = q0 + warp * 16 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + qi) * H + head) * hv +
                                c * 8) =
          *reinterpret_cast<const uint4*>(so + r * kStride + c * 8);
  }
}

// Dynamic shared memory of one block: the Q tile and the K/V ring.
template <int DQ, int DV>
constexpr int smem_bytes() {
  return sizeof(bf16) *
         (kBQ * (DQ + 8) + kStages * kBK * ((DQ + 8) + (DV + 8)));
}

template <int DQ, int DV>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_bf16_kernel<DQ, DV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<DQ, DV>());
}

template <int DQ, int DV>
int occupancy(int* blocks, int* smem) {
  cudaError_t err = allow_smem<DQ, DV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = smem_bytes<DQ, DV>();
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_bf16_kernel<DQ, DV>, kThreads, smem_bytes<DQ, DV>()));
}

template <int DQ, int DV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int H, int KH, int h, int hv,
           int causal, int window, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem<DQ, DV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_bf16_kernel<DQ, DV><<<grid, kThreads, smem_bytes<DQ, DV>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Skv, H,
      KH, h, hv, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation index of padded widths (width, vwidth): 0..3 for
// (32, 32), (64, 64), (128, 128), (192, 128); -1 for any other pair.
int instantiation(int width, int vwidth) {
  if (width == vwidth && (width == 32 || width == 64 || width == 128))
    return width == 32 ? 0 : width == 64 ? 1 : 2;
  return width == 192 && vwidth == 128 ? 3 : -1;
}

}  // namespace

// q, k, v and out are bf16; width and vwidth are the padded q/k and v
// widths that hold h and hv, both multiples of 16: (32, 32), (64, 64),
// (128, 128) or (192, 128). lse is null or an f32 [B, H, Sq] output for
// each row's log2-domain log-sum-exp. Pointers must be 16-byte aligned.
// Returns a cudaError_t; 1001 for an unsupported argument.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int Sq, int Skv, int H, int KH,
                                           int h, int hv, int causal,
                                           int window, float scale, int width,
                                           int vwidth, void* lse,
                                           void* stream) {
  if (h < 16 || hv < 16 || h % 16 || hv % 16 || h > width || hv > vwidth ||
      KH < 1 || H % KH != 0 || B > 65535 || (Sq + kBQ - 1) / kBQ > 65535)
    return 1001;
  const int which = instantiation(width, vwidth);
  if (which < 0) return 1001;
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (which) {
    case 0:
      return launch<32, 32>(q, k, v, out, l, B, Sq, Skv, H, KH, h, hv, causal,
                            window, scale, s);
    case 1:
      return launch<64, 64>(q, k, v, out, l, B, Sq, Skv, H, KH, h, hv, causal,
                            window, scale, s);
    case 2:
      return launch<128, 128>(q, k, v, out, l, B, Sq, Skv, H, KH, h, hv,
                              causal, window, scale, s);
    default:
      return launch<192, 128>(q, k, v, out, l, B, Sq, Skv, H, KH, h, hv,
                              causal, window, scale, s);
  }
}

// The blocks of the kernel at padded widths (width, vwidth) that one SM
// holds at once, and its dynamic shared memory per block. Returns a
// cudaError_t; 1001 for an unsupported pair.
extern "C" int flash_attention_bf16_occupancy(int width, int vwidth,
                                              int* blocks, int* smem) {
  switch (instantiation(width, vwidth)) {
    case 0:
      return occupancy<32, 32>(blocks, smem);
    case 1:
      return occupancy<64, 64>(blocks, smem);
    case 2:
      return occupancy<128, 128>(blocks, smem);
    case 3:
      return occupancy<192, 128>(blocks, smem);
    default:
      return 1001;
  }
}
