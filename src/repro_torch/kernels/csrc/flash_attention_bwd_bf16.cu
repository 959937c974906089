// The gradient of blockwise causal / sliding-window GQA attention for
// bf16 inputs, with every matrix product on the tensor cores.
//
// The JAX package has no backward kernel: it differentiates the jnp
// flash_attend (src/repro/models/layers.py:111) with jax.vjp. This kernel
// computes the gradient of the function the bf16 forward kernel
// (csrc/flash_attention_bf16.cu) computes:
//
//     q [B, Sq, H, h], k [B, Skv, K, h], v [B, Skv, K, hv], H = K * G
//     s[i, j] = (q_i . k_j) / sqrt(h), masked where not visible
//               (causal: j <= i; window w > 0: j > i - w)
//     P       = softmax_j(s),   o = P v
//
// Given o, do = dL/do and the forward's log2-domain log-sum-exp of each
// query row, lse[b, head, i] = m_i + log2(l_i) (an f32 [B, H, Sq] output
// of the forward kernel):
//
//     P[i, j] = exp2(s[i, j] log2(e) - lse_i), 0 where masked
//     D_i     = sum_c do[i, c] o[i, c]
//     dv_j    = sum_i P[i, j] do_i
//     dP      = do v^T,   dS = P o (dP - D)
//     dq_i    = sum_j dS[i, j] k_j / sqrt(h)
//     dk_j    = sum_i dS[i, j] q_i / sqrt(h)      (dk, dv summed over G)
//
// One C call, flash_attention_bwd_bf16_launch, runs three kernels (four
// at q/k width 192, below):
//
// 1. flash_bwd_bf16_dot_kernel: D_i in f32 into a workspace of B H Sq
//    floats, 16 lanes a row with 16-byte loads (memory-bound: o and do
//    read once).
// 2. flash_bwd_bf16_dkdv_kernel, grid (K, B, key tiles of 64), the key
//    tile slowest and ascending, so that the causal tiles with the most
//    work start first. Each of the 4 warps owns 16 keys. A step is one
//    (head of the group, 64-row query tile); the steps run over the G
//    heads, then the query tiles that reach the key tile, in ascending
//    order. Q, dO and the tile's 64 lse and D values come through a
//    2-stage cp.async ring (16-byte copies for Q and dO, 4-byte copies
//    for the statistics, whose rows need not be 16-byte aligned): the
//    next step loads while this one is multiplied. Per 32-query half of
//    the tile a warp computes S^T = K Q^T and dP^T = V dO^T
//    (mma.sync.m16n8k16, K and V rows as the A operand by ldmatrix, Q and
//    dO rows as the B operand by ldmatrix). The f32 accumulator layout of
//    m16n8 is the A-operand layout of m16n8k16, so P^T and
//    dS^T = P^T o (dP^T - D) are rounded to bf16 in registers and used
//    directly in dV += P^T dO and dK += dS^T Q (dO and Q by
//    ldmatrix.trans): no shared-memory round trip for P or dS. dK and dV
//    stay in f32 registers for the block's life and leave through shared
//    memory as 16-byte rows.
// 3. flash_bwd_bf16_dq_kernel, grid (H, B, query tiles of 64, heaviest
//    first). Each warp owns 16 query rows; their Q stays in registers as
//    A fragments, as the forward keeps Q, and their dO stays in shared
//    memory and is read as A fragments for each half tile (held in
//    registers too, it made ptxas spill 68 bytes at D = 128). K and V
//    come in 64-row tiles through a 2-stage cp.async ring. Per 32-key
//    half of a tile: S = Q K^T, dP = dO V^T, dS = P o (dP - D) in
//    registers, and dQ += dS K with K by ldmatrix.trans.
//
// P and dS enter the products rounded to bf16 (the tensor cores take bf16
// operands), as the forward's P does; every accumulator is f32. Tiles a
// block's rows cannot reach are never loaded, and a warp skips a half
// tile in which none of its pairs is visible; masks are applied only on
// half tiles that cross the causal diagonal, the window's edge or the end
// of a sequence.
//
// Determinism: no float atomics, and every sum runs in a fixed order (for
// dk and dv: head, query tile, half tile, then the mma's 16-query steps;
// for dq: key tile, half tile, 16-key steps), so two launches on the same
// inputs give the same bytes. The pods of the replicated trainer
// (repro_torch.runtime.statemachine) rely on that to end bitwise equal.
// dq is its own pass for that reason: it is not accumulated atomically
// by the dk/dv blocks.
//
// Bound on an H100: the work is five matrix products over the visible
// (query, key) pairs, 10 h flops a pair at h = hv. At the yi-6b train
// shape (q [1, 4096, 32, 128] per microbatch, causal) that is 344 GFLOP
// against ~151 MB in and out, so the bf16 tensor-core rate bounds it
// (348 us at 989 TFLOP/s). This design runs seven products (S and dP in
// both passes), ~481 GFLOP, on mma.sync; wgmma and TMA are later work.
//
// Register use at D = 128: the dk/dv warp holds 128 f32 accumulators
// (dK and dV, 16 keys by 128 columns each) plus S^T and dP^T of a
// 32-query half (32), so K and V fragments are read from shared memory
// for each half rather than held; the dq warp holds Q fragments (32), dQ
// (64) and S and dP of a 32-key half (32), and reads dO's fragments from
// shared memory.
// flash_attention_bwd_bf16_info reports each kernel's registers and spill
// bytes.
//
// Shapes: h up to 192 and hv up to 128, multiples of 16 (the forward
// bf16 kernel's rule); instantiated at a padded q/k width DQ and v width
// DV, zero-filled past h and hv: DQ = DV = D of 32, 64 or 128, or DQ =
// 192 with DV = 128 (deepseek-v3's MLA prefill, h = 128 + 64, hv = 128).
// Rows past Sq and keys past Skv are masked; neither length has to divide
// a tile. A query row that sees no key has no defined gradient (its P is
// 0 here). Pointers must be 16-byte aligned.
//
// At (192, 128) a dk/dv warp would hold dK (16 keys x 192 columns, 96 f32
// registers a lane) and dV (64) beside S^T and dP^T (32): 192 before any
// fragment or address, where the D = 128 kernel already uses 255. So the
// wide instantiation runs dk and dv as two passes over the same grid and
// schedule (flash_bwd_bf16_dkdv_kernel<192, 128, pass>): pass 1 computes
// S^T = K Q^T and P^T and accumulates only dV (64 registers; no V tile,
// 112,640 shared bytes, 2 blocks an SM); pass 2 computes S^T and dP^T
// again and accumulates only dK (96 registers; 130,048 bytes, 1 block an
// SM). Each stays deterministic; the cost is one more S^T product per
// visible pair (8 in all instead of 7). The dq pass holds dQ (96
// registers) and reads Q's A fragments from shared memory, as it reads
// dO's (129,024 bytes, 1 block an SM). Its first build spilled 64 bytes:
// ptxas had hoisted the addresses of the loop's 20 cp.async copies and
// of every unrolled fragment load out of the loops and held them in
// registers. So at this width the copies' thread index passes through
// an empty asm (pin) in the loop, the loop over d in S and dP is not
// unrolled, and a 192-wide row is copied as a 128- and a 64-wide part
// (power-of-two chunk counts): 216 registers, no spill.
//
// Bound at the MLA train shape (q [1, 4096, 128, 192], v width 128,
// causal, G = 1): 6 h + 4 hv flops a pair, 1,787.1 GFLOP, 1,807 us at 989
// TFLOP/s (bytes: 1.34 GB, 401 us).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;       // keys a dk/dv block (16 a warp), a dq K/V tile
constexpr int kBQ = 64;       // rows a dq block (16 a warp), a dk/dv Q/dO tile
constexpr int kHalf = 32;     // queries (dk/dv) or keys (dq) an inner step
constexpr int kStages = 2;    // the cp.async ring
constexpr int kDotThreads = 256;
constexpr int kDotLanes = 16;  // lanes a row in the D pass
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

// 4-byte asynchronous copy; src_bytes = 0 writes 4 zero bytes.
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

// An empty asm that the compiler must take to change x: what is derived
// from x afterwards is computed there, not hoisted out of the loop and
// held in registers across it.
__device__ __forceinline__ void pin(int& x) { asm volatile("" : "+r"(x)); }

// Two floats as one bf16x2 register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy `kRows` rows of `width` bf16 (a multiple of 8) from rows row0.. of
// a [n_rows, row_stride] global matrix into columns kC0 .. kC0 + kW - 1 of
// shared rows of D + 8 bf16; rows past n_rows and columns past width are
// zero-filled.
template <int D, int kRows, int kC0, int kW>
__device__ __forceinline__ void load_cols(uint32_t dst, const bf16* src,
                                          int row0, int n_rows, int width,
                                          size_t row_stride, int tid) {
  constexpr int kChunks = kW / 8;  // 16-byte chunks per row
  static_assert(kRows * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = kC0 / 8 + i % kChunks;
    const bool in = row0 + r < n_rows && c * 8 < width;
    const bf16* p = in ? src + (size_t)(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + (r * (D + 8) + c * 8) * 2, p, in ? 16 : 0);
  }
}

// All D columns of the rows: in one part, or at D = 192 as columns
// 0 .. 127 and 128 .. 191 (chunk counts that are powers of two).
template <int D, int kRows>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int row0, int n_rows, int width,
                                          size_t row_stride, int tid) {
  if constexpr (D == 192) {
    load_cols<D, kRows, 0, 128>(dst, src, row0, n_rows, width, row_stride,
                                tid);
    load_cols<D, kRows, 128, 64>(dst, src, row0, n_rows, width, row_stride,
                                 tid);
  } else {
    load_cols<D, kRows, 0, D>(dst, src, row0, n_rows, width, row_stride,
                              tid);
  }
}

// The A fragments of the 16 shared rows at `rows` (stride D + 8), columns
// kk * 16 .. kk * 16 + 15.
template <int D>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* rows,
                                       int kk, int lane) {
  ldmatrix_x4(smem_addr(rows + (lane % 16) * (D + 8) + kk * 16 +
                        (lane / 16) * 8),
              a[0], a[1], a[2], a[3]);
}

// The B fragments of two 8-column tiles whose columns are the shared rows
// r0 .. r0 + 15 (the operand is the rows' transpose), depth kk * 16 ..
// kk * 16 + 15: (b0, b1) for rows r0 .., (b2, b3) for rows r0 + 8 ...
template <int D>
__device__ __forceinline__ void b_frag_rows(uint32_t (&b)[4], const bf16* s,
                                            int r0, int kk, int lane) {
  ldmatrix_x4(smem_addr(s + (r0 + lane % 8 + (lane / 16) * 8) * (D + 8) +
                        kk * 16 + ((lane / 8) % 2) * 8),
              b[0], b[1], b[2], b[3]);
}

// The B fragments of two 8-column tiles of the shared rows r0 .. r0 + 15
// themselves (depth = the rows), columns dp * 16 .. dp * 16 + 15: (b0, b1)
// for columns dp * 16 .., (b2, b3) for columns dp * 16 + 8 ...
template <int D>
__device__ __forceinline__ void b_frag_cols(uint32_t (&b)[4], const bf16* s,
                                            int r0, int dp, int lane) {
  ldmatrix_x4_trans(smem_addr(s + (r0 + lane % 8 + ((lane / 8) % 2) * 8) *
                                      (D + 8) +
                              dp * 16 + (lane / 16) * 8),
                    b[0], b[1], b[2], b[3]);
}

// Rows 16 k .. 16 k + 15 of an m16n8 accumulator pair as the A fragment of
// the next product, rounded to bf16: acc[2 k] holds depth 0..7, acc[2 k + 1]
// depth 8..15.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ bool visible(int row, int key, int Sq, int Skv,
                                        int causal, int window) {
  return row < Sq && key < Skv && (!causal || key <= row) &&
         (window <= 0 || key > row - window);
}

// A warp's 16 accumulator rows (m16n8 layout, `acc[t]` = columns 8 t ..)
// times `mul`, in bf16 through its 16 shared rows at `rows` (stride DS +
// 8, DS >= DA), then to `n_rows` valid global rows of `width` bf16 at
// `dst` (row r at dst + r * row_stride), 16 bytes a lane.
template <int DA, int DS>
__device__ __forceinline__ void store_rows(const float (&acc)[DA / 8][4],
                                           float mul, bf16* rows, bf16* dst,
                                           size_t row_stride, int n_rows,
                                           int width, int lane) {
  static_assert(DA <= DS, "the accumulator fits the staging rows");
  constexpr int kStride = DS + 8;
  const int g = lane / 4, tg = lane % 4;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < DA / 8; ++t) {
    *reinterpret_cast<uint32_t*>(rows + g * kStride + 8 * t + 2 * tg) =
        pack_bf16(acc[t][0] * mul, acc[t][1] * mul);
    *reinterpret_cast<uint32_t*>(rows + (g + 8) * kStride + 8 * t + 2 * tg) =
        pack_bf16(acc[t][2] * mul, acc[t][3] * mul);
  }
  __syncwarp();
  const int chunks = width / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = i % chunks;
    if (r < n_rows)
      *reinterpret_cast<uint4*>(dst + r * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(rows + r * kStride + c * 8);
  }
}

// ---------------------------------------------------------------------------
// 1. D_i = do_i . o_i

__global__ void __launch_bounds__(kDotThreads)
    flash_bwd_bf16_dot_kernel(const bf16* __restrict__ o,
                              const bf16* __restrict__ dout,
                              float* __restrict__ delta, int rows, int Sq,
                              int H, int hv) {
  const int lane = threadIdx.x % kDotLanes;
  const int row = blockIdx.x * (kDotThreads / kDotLanes) +
                  threadIdx.x / kDotLanes;
  float acc = 0.f;
  if (row < rows) {
    const bf16* po = o + (size_t)row * hv;
    const bf16* pd = dout + (size_t)row * hv;
    for (int c = lane * 8; c < hv; c += kDotLanes * 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(po + c);
      const uint4 d = *reinterpret_cast<const uint4*>(pd + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 fa = __bfloat1622float2(a2[x]);
        const float2 fd = __bfloat1622float2(d2[x]);
        acc = fmaf(fd.x, fa.x, acc);
        acc = fmaf(fd.y, fa.y, acc);
      }
    }
  }
  // a fixed tree over the row's 16 lanes (xor stays inside a half warp)
#pragma unroll
  for (int off = kDotLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) {
    // row = (b Sq + i) H + head; D is laid out [B, H, Sq] as the lse
    const int head = row % H, bi = row / H;
    const int b = bi / Sq, i = bi % Sq;
    delta[((size_t)b * H + head) * Sq + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv, one 64-key tile of one kv head a block

// What a dk/dv launch accumulates: both (DQ = DV), or at q/k width 192
// dV alone (pass 1) or dK alone (pass 2).
constexpr int kBoth = 0, kOnlyDV = 1, kOnlyDK = 2;

template <int DQ, int DV, int kPass>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_bf16_dkdv_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int H,
        int KH, int h, int hv, int causal, int window, float scale_log2,
        float scale) {
  static_assert(DV <= DQ, "dV is staged in K's rows in pass 1");
  constexpr bool kDoDV = kPass != kOnlyDK, kDoDK = kPass != kOnlyDV;
  constexpr int kStride = DQ + 8;       // bf16 a Q or K shared row
  constexpr int kStrideV = DV + 8;      // bf16 a dO or V shared row
  constexpr int kQTile = kBQ * kStride;    // bf16 a Q tile
  constexpr int kStage = kQTile + kBQ * kStrideV;  // a Q and a dO tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [kBK][kStride]
  bf16* sv = sk + kBK * kStride;  // [kBK][kStrideV], where dP is computed
  bf16* ring = sv + (kDoDK ? kBK * kStrideV : 0);  // kStages x (Q, dO)
  // kStages x (lse[kBQ], D[kBQ])
  float* stats = reinterpret_cast<float*>(ring + kStages * kStage);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kBK;
  const int G = H / KH;
  const size_t q_rs = (size_t)H * h, o_rs = (size_t)H * hv,
               k_rs = (size_t)KH * h, v_rs = (size_t)KH * hv;

  // the query tiles some row of which reaches a key of this tile
  const int k_last = min(k0 + kBK, Skv) - 1;
  const int qt_begin = causal ? k0 / kBQ : 0;
  int qt_end = (Sq + kBQ - 1) / kBQ - 1;
  if (window > 0) qt_end = min(qt_end, (k_last + window - 1) / kBQ);
  const int n_qt = max(qt_end - qt_begin + 1, 0);
  const int n_steps = G * n_qt;  // (head, query tile), heads outermost

  // step s into ring stage `st`: Q, dO, lse and D of its head and tile
  auto load_step = [&](int s, int st) {
    const int head = kvh * G + s / n_qt;
    const int q0 = (qt_begin + s % n_qt) * kBQ;
    bf16* dst = ring + st * kStage;
    load_rows<DQ, kBQ>(smem_addr(dst), q + ((size_t)b * Sq * H + head) * h,
                       q0, Sq, h, q_rs, tid);
    load_rows<DV, kBQ>(smem_addr(dst + kQTile),
                       dout + ((size_t)b * Sq * H + head) * hv, q0, Sq, hv,
                       o_rs, tid);
    // one 4-byte copy a thread: threads 0..63 the lse, 64..127 D
    static_assert(kThreads == 2 * kBQ, "one statistic a thread");
    const float* src =
        (tid < kBQ ? lse : delta) + ((size_t)b * H + head) * Sq;
    const int row = q0 + tid % kBQ;
    cp_async4(smem_addr(stats + st * 2 * kBQ + tid),
              row < Sq ? src + row : src, row < Sq ? 4 : 0);
  };

  load_rows<DQ, kBK>(smem_addr(sk), k + ((size_t)b * Skv * KH + kvh) * h,
                     k0, Skv, h, k_rs, tid);
  if constexpr (kDoDK)
    load_rows<DV, kBK>(smem_addr(sv), v + ((size_t)b * Skv * KH + kvh) * hv,
                       k0, Skv, hv, v_rs, tid);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float dk_acc[kDoDK ? DQ / 8 : 1][4], dv_acc[kDoDV ? DV / 8 : 1][4];
  if constexpr (kDoDK) {
#pragma unroll
    for (int t = 0; t < DQ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[t][e] = 0.f;
  }
  if constexpr (kDoDV) {
#pragma unroll
    for (int t = 0; t < DV / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[t][e] = 0.f;
  }

  const int wk0 = k0 + warp * 16;  // the warp's first key
  const bf16* wk = sk + warp * 16 * kStride;
  const bf16* wv = sv + warp * 16 * kStrideV;

  int stage = 0;
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) load_step(s + 1, stage ^ 1);
    cp_async_commit();
    const int q0 = (qt_begin + s % n_qt) * kBQ;
    const bf16* sq = ring + stage * kStage;
    const bf16* sdo = sq + kQTile;
    const float* slse = stats + stage * 2 * kBQ;
    const float* sdelta = slse + kBQ;

#pragma unroll 1
    for (int half = 0; half < kBQ / kHalf; ++half) {
      const int r0 = half * kHalf;  // the half's first row in the tile
      const int qs = q0 + r0;       // and its query
      // no visible pair between the warp's keys and these queries
      if (qs >= Sq || wk0 >= Skv || (causal && qs + kHalf - 1 < wk0) ||
          (window > 0 && wk0 + 15 <= qs - window))
        continue;

      // S^T = K Q^T and (for dK) dP^T = V dO^T: 16 keys x 32 queries
      float st[kHalf / 8][4], dpt[kHalf / 8][4];
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DQ / 16; ++kk) {
        const bool with_dp = kDoDK && kk < DV / 16;
        uint32_t ka[4], va[4];
        a_frag<DQ>(ka, wk, kk, lane);
        if (with_dp) a_frag<DV>(va, wv, kk, lane);
#pragma unroll
        for (int np = 0; np < kHalf / 16; ++np) {
          uint32_t bq[4], bo[4];
          b_frag_rows<DQ>(bq, sq, r0 + np * 16, kk, lane);
          mma_bf16(st[2 * np], ka, bq[0], bq[1]);
          mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
          if (with_dp) {
            b_frag_rows<DV>(bo, sdo, r0 + np * 16, kk, lane);
            mma_bf16(dpt[2 * np], va, bo[0], bo[1]);
            mma_bf16(dpt[2 * np + 1], va, bo[2], bo[3]);
          }
        }
      }

      // P^T and dS^T in place; element (n, e) is key wk0 + g + 8 (e / 2),
      // query row r0 + 8 n + 2 tg + e % 2 of the tile
      const bool edge = (causal && wk0 + 15 > qs) ||
                        (window > 0 && wk0 <= qs + kHalf - 1 - window) ||
                        wk0 + 16 > Skv || qs + kHalf > Sq;
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n) {
        const int c = r0 + 8 * n + 2 * tg;
        const float2 l2 = *reinterpret_cast<const float2*>(slse + c);
        float2 d2 = make_float2(0.f, 0.f);
        if constexpr (kDoDK)
          d2 = *reinterpret_cast<const float2*>(sdelta + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(st[n][e] * scale_log2 - (e % 2 ? l2.y : l2.x));
          if (edge && !visible(q0 + c + e % 2, wk0 + g + 8 * (e / 2), Sq,
                               Skv, causal, window))
            p = 0.f;
          st[n][e] = p;
          if constexpr (kDoDK)
            dpt[n][e] = p * (dpt[n][e] - (e % 2 ? d2.y : d2.x));
        }
      }

      // dV += P^T dO, dK += dS^T Q, 16 queries a step
#pragma unroll
      for (int kc = 0; kc < kHalf / 16; ++kc) {
        uint32_t pa[4], da[4];
        if constexpr (kDoDV) acc_to_a(pa, st[2 * kc], st[2 * kc + 1]);
        if constexpr (kDoDK) acc_to_a(da, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < DQ / 16; ++dp) {
          uint32_t bo[4], bq[4];
          if (kDoDV && dp < DV / 16) {
            b_frag_cols<DV>(bo, sdo, r0 + kc * 16, dp, lane);
            mma_bf16(dv_acc[2 * dp], pa, bo[0], bo[1]);
            mma_bf16(dv_acc[2 * dp + 1], pa, bo[2], bo[3]);
          }
          if (kDoDK) {
            b_frag_cols<DQ>(bq, sq, r0 + kc * 16, dp, lane);
            mma_bf16(dk_acc[2 * dp], da, bq[0], bq[1]);
            mma_bf16(dk_acc[2 * dp + 1], da, bq[2], bq[3]);
          }
        }
      }
    }

    cp_async_wait_all();  // the next step has landed
    __syncthreads();      // and every warp is done with this one
    stage ^= 1;
  }

  // dk (scaled) and dv through the warp's own K and V rows (pass 1 has no
  // V tile: dv goes through its K rows)
  const int n_keys = min(16, Skv - wk0);
  const size_t key0 = (size_t)b * Skv + wk0;
  if constexpr (kDoDK)
    store_rows<DQ, DQ>(dk_acc, scale, sk + warp * 16 * kStride,
                       dk + key0 * k_rs + (size_t)kvh * h, k_rs, n_keys, h,
                       lane);
  if constexpr (kDoDV && kDoDK)
    store_rows<DV, DV>(dv_acc, 1.f, sv + warp * 16 * kStrideV,
                       dv + key0 * v_rs + (size_t)kvh * hv, v_rs, n_keys, hv,
                       lane);
  if constexpr (kDoDV && !kDoDK)
    store_rows<DV, DQ>(dv_acc, 1.f, sk + warp * 16 * kStride,
                       dv + key0 * v_rs + (size_t)kvh * hv, v_rs, n_keys, hv,
                       lane);
}

// ---------------------------------------------------------------------------
// 3. dq, one 64-row query tile of one head a block

template <int DQ, int DV>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_bf16_dq_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dq, int Sq, int Skv, int H, int KH, int h, int hv,
        int causal, int window, float scale_log2, float scale) {
  constexpr int kStride = DQ + 8;       // bf16 a Q or K shared row
  constexpr int kStrideV = DV + 8;      // bf16 a dO or V shared row
  constexpr int kTile = kBK * kStride;  // bf16 a K tile
  constexpr int kStage = kTile + kBK * kStrideV;  // a K and a V tile
  constexpr bool kHoldQ = DQ <= 128;    // Q's fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][kStride]
  bf16* sdo = sq + kBQ * kStride;                 // [kBQ][kStrideV]
  bf16* skv = sdo + kBQ * kStrideV;  // kStages x (K tile, then V tile)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int kvh = head / (H / KH);
  const int q_last = min(q0 + kBQ, Sq) - 1;

  // key tiles some query of this block can reach, as the forward
  int kt_end = (Skv + kBK - 1) / kBK - 1;
  if (causal) kt_end = min(kt_end, q_last / kBK);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  const size_t q_rs = (size_t)H * h, o_rs = (size_t)H * hv,
               k_rs = (size_t)KH * h, v_rs = (size_t)KH * hv;
  const bf16* kg = k + ((size_t)b * Skv * KH + kvh) * h;
  const bf16* vg = v + ((size_t)b * Skv * KH + kvh) * hv;

  load_rows<DQ, kBQ>(smem_addr(sq), q + ((size_t)b * Sq * H + head) * h, q0,
                     Sq, h, q_rs, tid);
  load_rows<DV, kBQ>(smem_addr(sdo), dout + ((size_t)b * Sq * H + head) * hv,
                     q0, Sq, hv, o_rs, tid);
  if (kt_begin <= kt_end) {
    load_rows<DQ, kBK>(smem_addr(skv), kg, kt_begin * kBK, Skv, h, k_rs,
                       tid);
    load_rows<DV, kBK>(smem_addr(skv + kTile), vg, kt_begin * kBK, Skv, hv,
                       v_rs, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 rows of Q as A fragments, for the block's life where
  // they fit (else read from sq at each half tile); its rows of dO stay
  // in shared memory
  const bf16* wq = sq + warp * 16 * kStride;
  uint32_t qf[kHoldQ ? DQ / 16 : 1][4];
  if constexpr (kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk) a_frag<DQ>(qf[kk], wq, kk, lane);
  }
  const bf16* wdo = sdo + warp * 16 * kStrideV;
  // rows wq0 + g (accumulator elements 0, 1) and wq0 + g + 8 (2, 3)
  const int wq0 = q0 + warp * 16;
  const size_t stat0 = ((size_t)b * H + head) * Sq;
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    lse_r[r] = row < Sq ? lse[stat0 + row] : 0.f;
    d_r[r] = row < Sq ? delta[stat0 + row] : 0.f;
  }

  float acc[DQ / 8][4];
#pragma unroll
  for (int t = 0; t < DQ / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  int stage = 0;
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    if (kt < kt_end) {  // the next tile into the other stage
      bf16* nk = skv + (stage ^ 1) * kStage;
      // at q/k width 192 the copies' addresses are computed here: hoisted
      // out of the loop, the 20 of them took the registers dQ needs
      int t = tid;
      if constexpr (!kHoldQ) pin(t);
      load_rows<DQ, kBK>(smem_addr(nk), kg, (kt + 1) * kBK, Skv, h, k_rs, t);
      load_rows<DV, kBK>(smem_addr(nk + kTile), vg, (kt + 1) * kBK, Skv, hv,
                         v_rs, t);
    }
    cp_async_commit();
    const bf16* sk = skv + stage * kStage;
    const bf16* sv = sk + kTile;

#pragma unroll 1
    for (int half = 0; half < kBK / kHalf; ++half) {
      const int r0 = half * kHalf;      // the half's first row in the tile
      const int ks = kt * kBK + r0;     // and its key
      if (ks >= Skv || wq0 >= Sq || (causal && ks > wq0 + 15) ||
          (window > 0 && ks + kHalf - 1 <= wq0 - window))
        continue;

      // S = Q K^T and dP = dO V^T: 16 rows x 32 keys (a loop over d at
      // q/k width 192: unrolled, its fragments took dQ's registers)
      float s[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll(kHoldQ ? DQ / 16 : 1)
      for (int kk = 0; kk < DQ / 16; ++kk) {
        const bool with_dp = kk < DV / 16;
        uint32_t qa[4], da[4];
        if constexpr (kHoldQ) {
          qa[0] = qf[kk][0];
          qa[1] = qf[kk][1];
          qa[2] = qf[kk][2];
          qa[3] = qf[kk][3];
        } else {
          a_frag<DQ>(qa, wq, kk, lane);
        }
        if (with_dp) a_frag<DV>(da, wdo, kk, lane);
#pragma unroll
        for (int np = 0; np < kHalf / 16; ++np) {
          uint32_t bk[4], bv[4];
          b_frag_rows<DQ>(bk, sk, r0 + np * 16, kk, lane);
          mma_bf16(s[2 * np], qa, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
          if (with_dp) {
            b_frag_rows<DV>(bv, sv, r0 + np * 16, kk, lane);
            mma_bf16(dp[2 * np], da, bv[0], bv[1]);
            mma_bf16(dp[2 * np + 1], da, bv[2], bv[3]);
          }
        }
      }

      // dS in place of S; element (n, e) is row wq0 + g + 8 (e / 2), key
      // ks + 8 n + 2 tg + e % 2
      const bool edge = (causal && ks + kHalf - 1 > wq0) ||
                        (window > 0 && ks <= wq0 + 15 - window) ||
                        ks + kHalf > Skv || wq0 + 16 > Sq;
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[n][e] * scale_log2 - lse_r[e / 2]);
          if (edge && !visible(wq0 + g + 8 * (e / 2), ks + 8 * n + 2 * tg +
                                                          e % 2,
                               Sq, Skv, causal, window))
            p = 0.f;
          s[n][e] = p * (dp[n][e] - d_r[e / 2]);
        }

      // dQ += dS K, 16 keys a step
#pragma unroll
      for (int kc = 0; kc < kHalf / 16; ++kc) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int dd = 0; dd < DQ / 16; ++dd) {
          uint32_t bk[4];
          b_frag_cols<DQ>(bk, sk, r0 + kc * 16, dd, lane);
          mma_bf16(acc[2 * dd], a, bk[0], bk[1]);
          mma_bf16(acc[2 * dd + 1], a, bk[2], bk[3]);
        }
      }
    }

    cp_async_wait_all();  // the next tile has landed
    __syncthreads();      // and every warp is done with this one
    stage ^= 1;
  }

  // dq (scaled) through the warp's own Q rows
  store_rows<DQ, DQ>(acc, scale, sq + warp * 16 * kStride,
                     dq + ((size_t)b * Sq + wq0) * q_rs + (size_t)head * h,
                     q_rs, min(16, Sq - wq0), h, lane);
}

// ---------------------------------------------------------------------------

template <int DQ, int DV, int kPass>
constexpr int smem_dkdv() {
  return sizeof(bf16) * (kBK * (DQ + 8) +
                         (kPass == kOnlyDV ? 0 : kBK * (DV + 8)) +
                         kStages * kBQ * ((DQ + 8) + (DV + 8))) +
         sizeof(float) * kStages * 2 * kBQ;
}
template <int DQ, int DV>
constexpr int smem_dq() {
  return sizeof(bf16) * (kBQ * ((DQ + 8) + (DV + 8)) +
                         kStages * kBK * ((DQ + 8) + (DV + 8)));
}

// Kernel `which` of one width pair, with its dynamic shared memory (set as
// the kernel's limit) and threads a block: 1 D, 2 dk/dv (at q/k width 192
// its dK pass), 3 dq, 4 the dV pass (q/k width 192 only).
template <int DQ, int DV>
cudaError_t kernel_of(int which, const void** fn, int* smem, int* threads) {
  constexpr bool kSplit = DQ != DV;
  constexpr int kPass = kSplit ? kOnlyDK : kBoth;
  switch (which) {
    case 1:
      *fn = reinterpret_cast<const void*>(flash_bwd_bf16_dot_kernel);
      *smem = 0;
      *threads = kDotThreads;
      return cudaSuccess;
    case 2:
      *fn = reinterpret_cast<const void*>(
          flash_bwd_bf16_dkdv_kernel<DQ, DV, kPass>);
      *smem = smem_dkdv<DQ, DV, kPass>();
      break;
    case 3:
      *fn = reinterpret_cast<const void*>(flash_bwd_bf16_dq_kernel<DQ, DV>);
      *smem = smem_dq<DQ, DV>();
      break;
    case 4:
      if constexpr (kSplit) {
        *fn = reinterpret_cast<const void*>(
            flash_bwd_bf16_dkdv_kernel<DQ, DV, kOnlyDV>);
        *smem = smem_dkdv<DQ, DV, kOnlyDV>();
        break;
      } else {
        return cudaErrorInvalidValue;
      }
    default:
      return cudaErrorInvalidValue;
  }
  *threads = kThreads;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

template <int DQ, int DV>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, bf16* dq, bf16* dk, bf16* dv,
           float* delta, int B, int Sq, int Skv, int H, int KH, int h, int hv,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr bool kSplit = DQ != DV;
  const void* fn;
  int smem[5], threads;
  for (int which = 2; which <= (kSplit ? 4 : 3); ++which) {
    cudaError_t err = kernel_of<DQ, DV>(which, &fn, &smem[which], &threads);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sl2 = scale * kLog2e;
  const int rows = B * Sq * H;
  const int per_block = kDotThreads / kDotLanes;
  flash_bwd_bf16_dot_kernel<<<(rows + per_block - 1) / per_block,
                              kDotThreads, 0, stream>>>(o, dout, delta, rows,
                                                        Sq, H, hv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 keys(KH, B, (Skv + kBK - 1) / kBK);
  if constexpr (kSplit) {
    flash_bwd_bf16_dkdv_kernel<DQ, DV, kOnlyDV>
        <<<keys, kThreads, smem[4], stream>>>(
            q, k, v, dout, lse, delta, dk, dv, Sq, Skv, H, KH, h, hv, causal,
            window, sl2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_bf16_dkdv_kernel<DQ, DV, kOnlyDK>
        <<<keys, kThreads, smem[2], stream>>>(
            q, k, v, dout, lse, delta, dk, dv, Sq, Skv, H, KH, h, hv, causal,
            window, sl2, scale);
  } else {
    flash_bwd_bf16_dkdv_kernel<DQ, DV, kBoth>
        <<<keys, kThreads, smem[2], stream>>>(
            q, k, v, dout, lse, delta, dk, dv, Sq, Skv, H, KH, h, hv, causal,
            window, sl2, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 queries(H, B, (Sq + kBQ - 1) / kBQ);
  flash_bwd_bf16_dq_kernel<DQ, DV><<<queries, kThreads, smem[3], stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Skv, H, KH, h, hv, causal, window,
      sl2, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation index of padded widths (width, vwidth): 0..3 for
// (32, 32), (64, 64), (128, 128), (192, 128); -1 for any other pair.
int instantiation(int width, int vwidth) {
  if (width == vwidth && (width == 32 || width == 64 || width == 128))
    return width == 32 ? 0 : width == 64 ? 1 : 2;
  return width == 192 && vwidth == 128 ? 3 : -1;
}

int info_width(int which, int pair, const void** fn, int* smem,
               int* threads) {
  switch (pair) {
    case 0:
      return static_cast<int>(kernel_of<32, 32>(which, fn, smem, threads));
    case 1:
      return static_cast<int>(kernel_of<64, 64>(which, fn, smem, threads));
    case 2:
      return static_cast<int>(kernel_of<128, 128>(which, fn, smem, threads));
    case 3:
      return static_cast<int>(kernel_of<192, 128>(which, fn, smem, threads));
    default:
      return 1001;
  }
}

}  // namespace

// q, k, v, o, dout are the forward's bf16 inputs, its output and the
// output's gradient, contiguous and 16-byte aligned; lse is the forward's
// f32 [B, H, Sq] log2-domain log-sum-exp; dq, dk, dv are written in bf16.
// ws holds B * H * Sq floats (D). width and vwidth are the padded q/k and
// v widths that hold h and hv, both multiples of 16: (32, 32), (64, 64),
// (128, 128) or (192, 128); scale is 1 / sqrt(h). Returns a cudaError_t;
// 1001 for an unsupported argument.
extern "C" int flash_attention_bwd_bf16_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* ws, int B, int Sq, int Skv, int H, int KH, int h, int hv,
    int causal, int window, float scale, int width, int vwidth,
    void* stream) {
  if (h < 16 || hv < 16 || h % 16 || hv % 16 || h > width || hv > vwidth ||
      KH < 1 || H % KH != 0 || B > 65535 || (Sq + kBQ - 1) / kBQ > 65535 ||
      (Skv + kBK - 1) / kBK > 65535 ||
      (long long)B * Sq * H > 0x7fffffffLL - kDotThreads)
    return 1001;
  const int which = instantiation(width, vwidth);
  if (which < 0) return 1001;
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *tq = static_cast<const bf16*>(q),
             *tk = static_cast<const bf16*>(k),
             *tv = static_cast<const bf16*>(v),
             *to = static_cast<const bf16*>(o),
             *tdo = static_cast<const bf16*>(dout);
  const float* tl = static_cast<const float*>(lse);
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk),
       *gv = static_cast<bf16*>(dv);
  float* w = static_cast<float*>(ws);
  switch (which) {
    case 0:
      return launch<32, 32>(tq, tk, tv, to, tdo, tl, gq, gk, gv, w, B, Sq,
                            Skv, H, KH, h, hv, causal, window, scale, s);
    case 1:
      return launch<64, 64>(tq, tk, tv, to, tdo, tl, gq, gk, gv, w, B, Sq,
                            Skv, H, KH, h, hv, causal, window, scale, s);
    case 2:
      return launch<128, 128>(tq, tk, tv, to, tdo, tl, gq, gk, gv, w, B, Sq,
                              Skv, H, KH, h, hv, causal, window, scale, s);
    default:
      return launch<192, 128>(tq, tk, tv, to, tdo, tl, gq, gk, gv, w, B, Sq,
                              Skv, H, KH, h, hv, causal, window, scale, s);
  }
}

// Registers a thread, local (spill) bytes a thread, dynamic shared bytes a
// block and blocks an SM holds of kernel `which` (1 D, 2 dk/dv or at q/k
// width 192 its dK pass, 3 dq, 4 the dV pass at q/k width 192) at padded
// widths (width, vwidth). Returns a cudaError_t; 1001 for an unsupported
// argument.
extern "C" int flash_attention_bwd_bf16_info(int which, int width,
                                             int vwidth, int* regs,
                                             int* local_bytes, int* smem,
                                             int* blocks) {
  const void* fn = nullptr;
  int threads = 0;
  const int err =
      info_width(which, instantiation(width, vwidth), &fn, smem, &threads);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, threads, *smem));
}
