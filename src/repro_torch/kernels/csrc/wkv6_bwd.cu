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
//                + p_out_s + u r_s A[s,s]
//     p_out_s  = 2^(total - cum_s) (G_c v_s)
//     dv_s     = sum_{t>=s} att[t,s] do_t + (k_s 2^(total - cum_s)) G_c
//     du       = sum r_t k_t A[t,t]
//     dwlog_i  = sum_{t>i in c} f_t - h_i + y
//
// with h_t = k_t (dk_t - u r_t A[t,t]) and f_t = r_t (dr_t - u k_t A[t,t])
// - h_t (products by column). dwlog_i is the sum over the (t, s) pairs
// with s < i < t, the pairs whose decay passes through token i; each sum
// stays inside one chunk, and the pairs that straddle the chunk's end come
// in through y[x] = sum_j G_c[x, j] S_{c+1}[x, j]. Since S_{c+1} =
// diag(2^total) S_c + sum_s (k_s 2^(total - cum_s))^T v_s,
//
//     y[x] = 2^total_x <G_c[x, :], S_c[x, :]> + sum_s k[s, x] p_out[s, x]:
//
// S_c, G_c and dk's state term p_out give it, and the state leaving the
// chunk is never read. kernels/ref.py::wkv6_chunked_bwd_plain is the
// function in plain PyTorch; tests/test_torch_wkv6_bwd.py emulates this
// kernel's arithmetic.
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
//    chunk's dr, dk, dv and dwlog from its inputs, S_c and G_c, and its
//    partial of du into the workspace;
// 4. wkv6bwd_du_kernel: one thread per (head, d) sums the partials of du
//    over batch, then chunk.
//
// Deterministic: no atomics, every sum in a fixed order, so two calls on
// the same inputs write the same bytes (replicas that train on one log
// stay bitwise equal). Every exponent is <= 0: the cumsums are formed by
// groups of 8 tokens (group_bounds, as the forward forms them), so they
// fall monotonically through a chunk and every bound between groups is
// one of their values, and each exponent is a later cum minus an earlier
// one. The result is finite wherever the recurrence's gradient is. 2^x is
// ex2.approx on log2(e)-scaled sums. Arithmetic is f32: FFMA on the CUDA
// cores, except the three state products (S_c do, G_c v, kout G_c), which
// run on the tensor cores in split TF32 (each operand as hi + lo TF32
// parts, hi.hi + hi.lo + lo.hi summed in f32: ~2^-21 of a product, where
// TF32 alone, ~1e-3, would break the tolerance against the plain version).
//
// Bound on an H100: at the rwkv6-3b train microbatch [1, 4096, 40, 64],
// r/k/v bf16, the function reads r, k, v, wlog, do and u once and writes
// dr, dk, dv, dwlog and du once, 251.7 MB: 75.1 us at 3.35 TB/s. It needs
// ~8 GFLOP (12 hd^2 flops a token and head), so bytes bound it. This
// design adds the forward's saved states (83.2 MB, read once by the grad
// pass) and the workspace round trip (written by pass 1, read and written
// by pass 2, read by pass 3: ~250 MB); its own byte floor is ~0.23 ms.
//
// The design, for what held this kernel's first version at ~20x its
// bound:
// - Shared-memory operands. Every FFMA product has a register tile and
//   reads its operands as float4 rows, one of them a warp-wide broadcast:
//   the adjoint's (r 2^cum_ex)^T do in 4 x 4 tiles of (d, j); A, att's
//   level blocks and the bonus in 4 x 4 tiles over a quarter of the head
//   dim each; the level products and dv's att^T do as 8 tokens x 1 column
//   a thread ("items": group g of 8 tokens, column x), whose 8 rows come as
//   two broadcast float4 for each conflict-free read of the other operand.
//   No FMA of a product loop reads both operands from shared memory. The
//   state products, two thirds of the FMAs, go to mma.sync (m16n8k8).
// - Exponentials. The intra-chunk decay is factored on two levels, as the
//   forward's output pass factors it: pairs across the chunk's halves and
//   across each half's quarters become products of decayed rows (a
//   [16x16].[16xW] and two [8x8].[8xW] tiles for each of att, dr and dk),
//   and only pairs inside an 8-token leaf take an exp per (t, s, d), one
//   shared by att, dr and dk (and none for adjacent tokens, whose exponent
//   is 0). About 80 ex2 an item, ~5x fewer than one per pair three times.
// - The state leaving the chunk. y comes from the identity above, so the
//   grad pass reads S_c and G_c only: a third less state traffic, no
//   reload step and no barrier for it.
// - Loads and occupancy. r/k/v (16-byte bf16 vectors, widened in shared
//   memory), wlog, do and the two states come in with cp.async, the states
//   in flight while the chunk's own work runs; the states are stored with
//   their 16-byte chunks XOR-swizzled by row, so that the mma fragments'
//   row reads are free of bank conflicts. Cumsums are 4 groups a column in
//   parallel. The grad pass holds 112,512 B at hd 64 (2 blocks an SM, 128
//   registers, no spills); at hd 128 S_c lands over the chunk's dead tiles
//   after the intra-chunk work, while the G_c products run (224,896 B, 1
//   block).
// What still holds it (measured on the card, by taking parts out of the
// pass): the grad pass's phases follow one another behind barriers at 16
// warps an SM, so device memory and the arithmetic overlap little.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kC = 32;           // tokens per chunk (the forward's kC)
constexpr int kTok = 8;          // tokens of a group: a leaf of the factoring
constexpr int kGroups = kC / kTok;
constexpr int kSub = kC / 2;     // tokens in half a chunk
constexpr int kPairs = kTok * (kTok - 1) / 2;   // pairs s < t in a leaf
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kScanUnroll = 8;   // slot loads in flight per scan thread
constexpr int kA = kC + 4;       // row stride of [.][kC] tiles (16-byte rows)
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kC == 32 && kTok == 8 && kPairs <= 32,
              "the grad pass is laid out for 4 groups of 8 tokens");

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

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// acc + a . b, summed x, y, z, w
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[i] += (a, b)[i] * s for the 8 values of a and b
__device__ __forceinline__ void axpy8(float (&acc)[kTok], float4 a, float4 b,
                                      float s) {
  acc[0] = fmaf(a.x, s, acc[0]);
  acc[1] = fmaf(a.y, s, acc[1]);
  acc[2] = fmaf(a.z, s, acc[2]);
  acc[3] = fmaf(a.w, s, acc[3]);
  acc[4] = fmaf(b.x, s, acc[4]);
  acc[5] = fmaf(b.y, s, acc[5]);
  acc[6] = fmaf(b.z, s, acc[6]);
  acc[7] = fmaf(b.w, s, acc[7]);
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as bits
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x as hi + lo, both TF32: hi carries x's first 11 bits, lo the next 11
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a b for a 16 x 8 (row) and b 8 x 8 (col) TF32 tile, f32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows t0 .. t0 + kC - 1 of head h, batch b of a [B, S, H, hd] tensor,
// columns 0 .. W - 1 (zero past S and hd), into shared memory. vec (hd a
// multiple of 8, every tensor 16-byte aligned): 16-byte cp.async copies,
// of floats into dst [kC][ld], of bf16 raw into raw [kC][W] (widen() turns
// them into floats once they have landed); else plain loads into dst.
template <int W, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ p, int b,
                                           int t0, int h, int S, int H,
                                           int hd, bool vec, float* dst,
                                           int ld, __nv_bfloat16* raw) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int kCols = W / kPer;
  if (vec) {
    for (int i = threadIdx.x; i < kC * kCols; i += kThreads) {
      const int t = i / kCols, d = (i % kCols) * kPer;
      const bool in = t0 + t < S && d < hd;
      const T* src = in ? p + offset(b, t0 + t, h, d, S, H, hd) : p;
      const void* to;
      if constexpr (std::is_same<T, float>::value)
        to = dst + t * ld + d;
      else
        to = raw + t * W + d;
      cp_async16(smem_addr(to), src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kC * W; i += kThreads) {
      const int t = i / W, d = i % W;
      const bool in = t0 + t < S && d < hd;
      dst[t * ld + d] = in ? to_f32(p[offset(b, t0 + t, h, d, S, H, hd)])
                           : 0.f;
    }
  }
}

// the [kC][W] bf16 rows that stage_rows copied raw, as floats in dst
// [kC][ld]
template <int W>
__device__ __forceinline__ void widen(const __nv_bfloat16* raw, float* dst,
                                      int ld) {
  for (int i = threadIdx.x; i < kC * W / 8; i += kThreads) {
    const int t = i / (W / 8), d = (i % (W / 8)) * 8;
    const uint4 q = *reinterpret_cast<const uint4*>(raw + t * W + d);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q);
    const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
    const float2 c = __bfloat1622float2(h2[2]), e = __bfloat1622float2(h2[3]);
    st4(dst + t * ld + d, a.x, a.y, b.x, b.y);
    st4(dst + t * ld + d + 4, c.x, c.y, e.x, e.y);
  }
}

// Where element (x, j) of a [W][W] state lies in shared memory: row x,
// its 16-byte chunk j / 4 XOR-swizzled by x % 8, so that lanes reading
// the same columns of 8 rows (an mma fragment, or a float4 each) hit
// distinct banks.
template <int W>
__device__ __forceinline__ int swz(int x, int j) {
  return x * W + ((((j >> 2) ^ (x & 7))) << 2) + (j & 3);
}

// A [W][W] f32 state from device memory into shared memory, swizzled
template <int W>
__device__ __forceinline__ void stage_state(const float* __restrict__ src,
                                            float* dst) {
  for (int i = threadIdx.x; i < W * W / 4; i += kThreads) {
    const int x = i / (W / 4), j = (i % (W / 4)) * 4;
    cp_async16(smem_addr(dst + swz<W>(x, j)), src + 4 * i, 16);
  }
}

// out[t][n] = sum_k a[t][k] b(k, n) for the chunk's [kC][W + 4] rows a
// and a swizzled [W][W] state read as b(k, n) = state[n][k] (kNK) or
// state[k][n], handed to put(t, n, out[t][n], out[t][n + 1]). Split TF32
// on the tensor cores: each operand as hi + lo, and lo.hi, hi.lo and
// hi.hi summed in f32 in three accumulators (the lo.lo term, ~2^-22 of the
// product, is left out), m16n8k8 tiles. Warp w takes rows 16 (w % 2) ..
// + 15 and the 8-column tiles w / 2 + 4 i. The A fragments' loads hit
// distinct banks (rows of W + 4 floats), and so do the state's for kNK
// (its swizzle); state[k][n] has 2-way conflicts.
template <int W, bool kNK, typename F>
__device__ __forceinline__ void state_product(const float* a, const float* b,
                                              F&& put) {
  constexpr int kP = W + 4, kN = W / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4, m0 = (warp % 2) * 16;
  float c[3][kN][4] = {};
#pragma unroll 4
  for (int k0 = 0; k0 < W; k0 += 8) {
    uint32_t ah[4], al[4];
    split(a[(m0 + g) * kP + k0 + q], ah[0], al[0]);
    split(a[(m0 + g + 8) * kP + k0 + q], ah[1], al[1]);
    split(a[(m0 + g) * kP + k0 + q + 4], ah[2], al[2]);
    split(a[(m0 + g + 8) * kP + k0 + q + 4], ah[3], al[3]);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int n = (i * 4 + warp / 2) * 8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      split(b[kNK ? swz<W>(n, k0 + q) : swz<W>(k0 + q, n)], bh0, bl0);
      split(b[kNK ? swz<W>(n, k0 + q + 4) : swz<W>(k0 + q + 4, n)], bh1,
            bl1);
      mma_tf32(c[0][i], al, bh0, bh1);
      mma_tf32(c[1][i], ah, bl0, bl1);
      mma_tf32(c[2][i], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (c[0][i][e] + c[1][i][e]) + c[2][i][e];
    const int n = (i * 4 + warp / 2) * 8 + 2 * q;
    put(m0 + g, n, v[0], v[1]);
    put(m0 + g + 8, n, v[2], v[3]);
  }
}

// The log2 decay of column x over the kTok tokens of group g of the
// staged [kC][W] rows sw, summed token by token: cs[i] the first i + 1;
// sg[g W + x] all kTok.
template <int W>
__device__ __forceinline__ void sum_group(const float* sw, int g, int x,
                                          float (&cs)[kTok], float* sg) {
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kTok; ++i) {
    sum += __fmul_rn(sw[(g * kTok + i) * W + x], kLog2e);
    cs[i] = sum;
  }
  sg[g * W + x] = sum;
}

// bound[q] = the chained sum of the group sums 0 .. q-1 of column x
// (bound[0] = 0, bound[kGroups] = total). The cumsum at token g kTok + i
// is bound[g] + cs[i], so at the last token of group g it is bound[g + 1]
// exactly, the sequence falls monotonically (every term <= 0), and each
// bound is a value of it.
template <int W>
__device__ __forceinline__ void group_bounds(const float* sg, int x,
                                             float (&bound)[kGroups + 1]) {
  bound[0] = 0.f;
#pragma unroll
  for (int q = 0; q < kGroups; ++q) bound[q + 1] = bound[q] + sg[q * W + x];
}

// bound[g] for a g known only at run time, without indexing the array
__device__ __forceinline__ float pick(const float (&bound)[kGroups + 1],
                                      int g) {
  float x = 0.f;
#pragma unroll
  for (int q = 0; q <= kGroups; ++q) x = q == g ? bound[q] : x;
  return x;
}

// One halving exchange of warp_sum_transposed: lanes with bit M set keep
// the upper M of their values and send the lower, the others the reverse,
// and each adds its partner's to what it kept.
template <int M>
__device__ __forceinline__ void halve(float (&part)[32], int lane) {
  const bool up = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float send = up ? part[i] : part[i + M];
    const float keep = up ? part[i + M] : part[i];
    part[i] = keep + __shfl_xor_sync(kFull, send, M);
  }
}

// The 32 values of each lane summed over the warp: afterwards part[0] of
// lane l is the sum of every lane's part[l]. Five halving exchanges, 31
// shuffles; a fixed order.
__device__ __forceinline__ void warp_sum_transposed(float (&part)[32],
                                                    int lane) {
  halve<16>(part, lane);
  halve<8>(part, lane);
  halve<4>(part, lane);
  halve<2>(part, lane);
  halve<1>(part, lane);
}

// Pass 1's shared memory, in floats: r (then r 2^cum_ex) and do as
// [kC][W + 4] tiles, the staged log decay [kC][W], r's raw bf16 [kC][W]
// and the group sums [kGroups][W].
template <int W>
struct AdjointSmem {
  static constexpr int kP = W + 4;
  static constexpr int kFloats = 2 * kC * kP + kC * W + kC * W / 2 +
                                 kGroups * W;
};

// Pass 1. Chunk c = blockIdx.x + 1 of head h, batch b: adj[d, j] = sum_t
// r[t,d] 2^cum_ex[t,d] do[t,j] and decay[d] = 2^total[d], in slot c - 1.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    wkv6bwd_adjoint_kernel(const T* __restrict__ r,
                           const float* __restrict__ wlog,
                           const float* __restrict__ dout,
                           float* __restrict__ adj, float* __restrict__ decay,
                           int S, int H, int hd, int slots) {
  using L = AdjointSmem<W>;
  constexpr int kP = L::kP;
  constexpr int kItems = (kGroups * W + kThreads - 1) / kThreads;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // [kC][kP] r 2^cum_ex
  float* sd = sq + kC * kP;                      // [kC][kP] do
  float* sw = sd + kC * kP;                      // [kC][W] log decay
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(sw + kC * W);
  float* sg = sw + kC * W + kC * W / 2;          // [kGroups][W] group sums
  const int c = blockIdx.x + 1, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, t0 = c * kC;
  const size_t slot = (static_cast<size_t>(b) * H + h) * slots + c - 1;
  const bool vec = hd % 8 == 0 && aligned16(r) && aligned16(wlog) &&
                   aligned16(dout);
  stage_rows<W>(r, b, t0, h, S, H, hd, vec, sq, kP, raw);
  stage_rows<W>(wlog, b, t0, h, S, H, hd, vec, sw, W, nullptr);
  stage_rows<W>(dout, b, t0, h, S, H, hd, vec, sd, kP, nullptr);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (vec) widen<W>(raw, sq, kP);
  }
  float cs[kItems][kTok];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads;
    if (i < kGroups * W) sum_group<W>(sw, i / W, i % W, cs[it], sg);
  }
  __syncthreads();
  // item (g, x) scales its 8 tokens of column x by 2^cum_ex
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads, x = i % W, g = i / W;
    if (i >= kGroups * W) break;
    float bound[kGroups + 1];
    group_bounds<W>(sg, x, bound);
    const float off = pick(bound, g);
    float ex = off;   // cum_ex of the group's first token
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      sq[(g * kTok + j) * kP + x] *= ex2(ex);
      ex = off + cs[it][j];
    }
    if (g == 0) decay[slot * W + x] = ex2(bound[kGroups]);
  }
  __syncthreads();
  // 4 x 4 tiles of (d, j): per token one float4 of each operand, 16 FMAs;
  // the lanes of a warp share d and read consecutive j
  float* dst = adj + slot * W * W;
  for (int e = tid; e < (W / 4) * (W / 4); e += kThreads) {
    const int j0 = (e % (W / 4)) * 4, d0 = (e / (W / 4)) * 4;
    float acc[4][4] = {};
#pragma unroll 8
    for (int t = 0; t < kC; ++t) {
      const float4 a = ld4(sq + t * kP + d0), q = ld4(sd + t * kP + j0);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], q.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], q.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], q.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], q.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(dst + (d0 + i) * W + j0, acc[i][0], acc[i][1], acc[i][2],
          acc[i][3]);
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

// Pass 3's shared memory, in floats:
// - r, k, v, do: [kC][kP] tiles (rows of W + 4 floats: 16-byte rows whose
//   float4 reads by 8 lanes of 8 rows hit distinct banks);
// - G_c: a swizzled [W][W] state;
// - the work region: the level-1 and level-2 rows sx, sy [kC][kP], kout
//   [kC][kP] (in W kA floats), A, A transposed and att [kC][kA]. Before
//   them, the raw bf16 inputs are staged over sx and sy, the log decay over
//   kout; after them, the state products' results land over sx, sy and A;
// - S_c: a swizzled [W][W] state of its own where it fits (W <= 64, landing
//   while the chunk's own work runs), else over the dead work region after
//   it (W = 128);
// - u [W], A's diagonal [kC], and misc [16 W]: the group sums, then the
//   leaf weights' warp partials, then the column partials of dwlog and du;
//   at W = 128 one more [kC][kP] tile for the state products' results.
template <int W>
struct GradSmem {
  static constexpr int kP = W + 4;
  static constexpr int kTile = kC * kP;
  static constexpr int kState = W * W;
  static constexpr int kWork = 2 * kTile + W * kA + 3 * kC * kA;
  static constexpr bool kFit = W <= 64;
  static_assert(kFit || kWork >= kState, "S_c must fit the work region");
  static_assert(2 * kTile >= 3 * kC * W / 2 && W * kA >= kTile,
                "the staged inputs and kout must fit the work region");
  static_assert(!kFit || 3 * kC * kA >= kTile, "a product over A, A^T, att");
  static constexpr int kFloats = 4 * kTile + kState + kWork +
                                 (kFit ? kState : kTile) + W + kC + 16 * W;
};

// Pass 3. The gradients of chunk c of head h, batch b (the last chunk may
// be short: tokens past S are zero and are not written).
//
// Item (g, x) of a thread: the 8 tokens of group g in column x. It owns
// their cumsums, their leaf pairs, and their dr, dk, dv and dwlog; at
// W = 128 a thread has two items, (g, x) and (g + 2, x), sharing x.
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
  constexpr int kP = L::kP;
  constexpr int kItems = (kGroups * W + kThreads - 1) / kThreads;
  static_assert(kThreads % W == 0, "the items of a thread share a column");
  extern __shared__ float4 smem4[];
  float* sr = reinterpret_cast<float*>(smem4);
  float* sk = sr + L::kTile;
  float* sv = sk + L::kTile;
  float* sdo = sv + L::kTile;
  float* sG = sdo + L::kTile;
  float* sx = sG + L::kState;     // [kC][kP] level-1 rows
  float* sy = sx + L::kTile;      // [kC][kP] level-2 rows
  float* sko = sy + L::kTile;     // [kC][kP] kout = k 2^(total - cum)
  float* sA = sko + W * kA;       // [kC][kA] A[t][s]
  float* sAT = sA + kC * kA;      // [kC][kA] A[t][s] at [s][t]
  float* sT = sAT + kC * kA;      // [kC][kA] att[t][s]
  float* sS = L::kFit ? sT + kC * kA : sx;
  float* su = L::kFit ? sS + L::kState : sT + kC * kA;
  float* sdg = su + W;            // [kC] A[t][t]
  float* misc = sdg + kC;         // [16 W]
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(sx);
  float* sw = sko;                // [kC][W] the staged log decay
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, t0 = c * kC, x = tid % W;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t ww = static_cast<size_t>(W) * W;
  const bool has_s = c > 0, has_g = c < slots;
  const bool vec = hd % 8 == 0 && aligned16(r) && aligned16(k) &&
                   aligned16(v) && aligned16(wlog) && aligned16(dout);

  // 1. the chunk's inputs (zero past S and hd), then G_c (0 leaving the
  // last chunk) and, where it fits, S_c (0 entering the first): the
  // states stay in flight through the chunk's own work
  stage_rows<W>(r, b, t0, h, S, H, hd, vec, sr, kP, raw);
  stage_rows<W>(k, b, t0, h, S, H, hd, vec, sk, kP, raw + kC * W);
  stage_rows<W>(v, b, t0, h, S, H, hd, vec, sv, kP, raw + 2 * kC * W);
  stage_rows<W>(wlog, b, t0, h, S, H, hd, vec, sw, W, nullptr);
  stage_rows<W>(dout, b, t0, h, S, H, hd, vec, sdo, kP, nullptr);
  cp_async_commit();
  if (has_g) stage_state<W>(gout + (bh * slots + c) * ww, sG);
  if (L::kFit && has_s) stage_state<W>(states + (bh * slots + c - 1) * ww, sS);
  cp_async_commit();
  for (int i = tid; i < W; i += kThreads) su[i] = i < hd ? u[h * hd + i] : 0.f;
  for (int i = tid; i < kC * kC; i += kThreads) {   // att above the diagonal
    const int t = i / kC, s = i % kC;
    if (s > t) sT[t * kA + s] = 0.f;
  }
  cp_async_wait<1>();   // the inputs have landed; the states may not have
  __syncthreads();
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (vec) {
      widen<W>(raw, sr, kP);
      widen<W>(raw + kC * W, sk, kP);
      widen<W>(raw + 2 * kC * W, sv, kP);
    }
  }
  float cs[kItems][kTok];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads;
    if (i < kGroups * W) sum_group<W>(sw, i / W, x, cs[it], misc);
  }
  __syncthreads();

  // 2. each item's cumsums and bounds, and its entries of the level rows
  // and of kout. Group g of 8 tokens is the left half of its level-2
  // block when g is even (pivot m2: its own last token) and the right half
  // when odd (pivot: the last token before it); groups 0-1 are the left
  // half of the level-1 block (pivot m1: token 15).
  float cum[kItems][kTok], off[kItems], m1[kItems], m2[kItems], tot[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads, g = i / W;
    if (i >= kGroups * W) break;
    float bound[kGroups + 1];
    group_bounds<W>(misc, x, bound);
    off[it] = pick(bound, g);
    m1[it] = bound[kSub / kTok];
    m2[it] = g % 2 == 0 ? pick(bound, g + 1) : off[it];
    tot[it] = bound[kGroups];
    float ex = off[it];   // cum_ex of the group's first token
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      const int t = g * kTok + j;
      cum[it][j] = off[it] + cs[it][j];
      const float rv = sr[t * kP + x], kv = sk[t * kP + x];
      sx[t * kP + x] = t < kSub ? kv * ex2(m1[it] - cum[it][j])
                                : rv * ex2(ex - m1[it]);
      sy[t * kP + x] = g % 2 == 0 ? kv * ex2(m2[it] - cum[it][j])
                                  : rv * ex2(ex - m2[it]);
      sko[t * kP + x] = kv * ex2(tot[it] - cum[it][j]);
      ex = cum[it][j];
    }
  }
  __syncthreads();

  // 3. A over s <= t, att's level-1 and level-2 blocks, and the bonus
  // att[t][t] = r_t . (u k_t): 60 tiles of 4 x 4, each taken by 4 lanes
  // that split the head dim by 16-byte chunks (lane q: chunks q, q + 4,
  // ...) and sum by shuffles; lane q writes the tile's row q.
  // Tiles 0-35: A's lower triangle of 4 x 4 blocks (those on the diagonal
  // also the bonus of their 4 tokens); 36-51: level 1 (t in 16..31, s in
  // 0..15); 52-59: level 2 (t in a half's second 8, s in its first 8).
  {
    // lanes past the 60 tiles (half of the last warp) compute nothing but
    // join the shuffles
    const int tile = tid / 4, q = tid % 4;
    const bool live = tile < 60;
    int kind = 0, ta = 0, sb = 0;
    if (!live) {
    } else if (tile < 36) {
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
      ta = 4 * ti, sb = 4 * (tile - ti * (ti + 1) / 2);
    } else if (tile < 52) {
      const int e = tile - 36;
      kind = 1, ta = kSub + 4 * (e / 4), sb = 4 * (e % 4);
    } else {
      const int e = tile - 52, base = (e / 4) * kSub;
      kind = 2, ta = base + kTok + 4 * ((e % 4) / 2), sb = base + 4 * (e % 2);
    }
    const bool diag = kind == 0 && ta == sb;
    const float* pa = kind == 0 ? sdo : kind == 1 ? sx : sy;
    const float* pb = kind == 0 ? sv : kind == 1 ? sx : sy;
    float acc[4][4] = {}, bonus[4] = {};
    for (int cc = q; live && cc < W / 4; cc += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(pa + (ta + i) * kP + 4 * cc);
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ld4(pb + (sb + j) * kP + 4 * cc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dot4(a[i], bb[j], acc[i][j]);
      if (diag) {
        const float4 w = ld4(su + 4 * cc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bonus[i] = dot4(mul4(ld4(sr + (ta + i) * kP + 4 * cc), w),
                          ld4(sk + (ta + i) * kP + 4 * cc), bonus[i]);
      }
    }
#pragma unroll
    for (int m = 1; m <= 2; m *= 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bonus[i] += __shfl_xor_sync(kFull, bonus[i], m);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += __shfl_xor_sync(kFull, acc[i][j], m);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i != q || !live) continue;
      const int t = ta + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = sb + j;
        if (kind == 0) {
          sA[t * kA + s] = acc[i][j];
          sAT[s * kA + t] = acc[i][j];
        } else {
          sT[t * kA + s] = acc[i][j];
        }
      }
      if (diag) {
        sdg[t] = acc[i][i];
        sT[t * kA + t] = bonus[i];
      }
    }
  }
  __syncthreads();

  // 4. the leaf pairs (s < t inside the item's group): one exp per pair
  // and column (none for adjacent tokens), shared by the weight's partial,
  // dr's and dk's intra-chunk sums. Each lane's 28 weight partials are
  // summed over the warp's 32 columns; the warps of one group then in
  // order (step 5).
  float dri[kItems][kTok], dki[kItems][kTok];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads, g = i / W;
#pragma unroll
    for (int j = 0; j < kTok; ++j) dri[it][j] = dki[it][j] = 0.f;
    if (i >= kGroups * W) break;
    float rr[kTok], kk[kTok], part[32];
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      rr[j] = sr[(g * kTok + j) * kP + x];
      kk[j] = sk[(g * kTok + j) * kP + x];
    }
    const float* arow = sA + g * kTok * kA + g * kTok;
    int n = 0;
#pragma unroll
    for (int t = 1; t < kTok; ++t) {
#pragma unroll
      for (int s = 0; s < t; ++s) {
        const float e = s == t - 1 ? 1.f : ex2(cum[it][t - 1] - cum[it][s]);
        const float ea = e * arow[t * kA + s];
        dri[it][t] = fmaf(kk[s], ea, dri[it][t]);
        dki[it][s] = fmaf(rr[t], ea, dki[it][s]);
        part[n++] = rr[t] * kk[s] * e;
      }
    }
#pragma unroll
    for (int j = kPairs; j < 32; ++j) part[j] = 0.f;
    warp_sum_transposed(part, lane);
    misc[(g * (W / 32) + x / 32) * 32 + lane] = part[0];
  }
  __syncthreads();

  // 5. the leaf weights into att; then each item's level products: dr's
  // (its tokens on the right of a level block) and dk's (on the left),
  // scaled by the decay from the token to the block's pivot
  for (int i = tid; i < kGroups * kPairs; i += kThreads) {
    const int g = i / kPairs, n = i % kPairs;
    int t = 1;
    while ((t + 1) * t / 2 <= n) ++t;
    const int s = n - t * (t - 1) / 2;
    float sum = 0.f;
    for (int w = 0; w < W / 32; ++w) sum += misc[(g * (W / 32) + w) * 32 + n];
    sT[(g * kTok + t) * kA + g * kTok + s] = sum;
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads, g = i / W;
    if (i >= kGroups * W) break;
    float cex[kTok];
#pragma unroll
    for (int j = 0; j < kTok; ++j) cex[j] = j == 0 ? off[it] : cum[it][j - 1];
    float p[kTok] = {};
    if (g * kTok >= kSub) {       // dr: s in 0..15
#pragma unroll 4
      for (int s = 0; s < kSub; ++s)
        axpy8(p, ld4(sAT + s * kA + g * kTok), ld4(sAT + s * kA + g * kTok + 4),
              sx[s * kP + x]);
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        dri[it][j] = fmaf(ex2(cex[j] - m1[it]), p[j], dri[it][j]);
    } else {                      // dk: t in 16..31
#pragma unroll 4
      for (int t = kSub; t < kC; ++t)
        axpy8(p, ld4(sA + t * kA + g * kTok), ld4(sA + t * kA + g * kTok + 4),
              sx[t * kP + x]);
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        dki[it][j] = fmaf(ex2(m1[it] - cum[it][j]), p[j], dki[it][j]);
    }
#pragma unroll
    for (int j = 0; j < kTok; ++j) p[j] = 0.f;
    if (g % 2 == 1) {             // dr: s in group g - 1
#pragma unroll
      for (int s = (g - 1) * kTok; s < g * kTok; ++s)
        axpy8(p, ld4(sAT + s * kA + g * kTok), ld4(sAT + s * kA + g * kTok + 4),
              sy[s * kP + x]);
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        dri[it][j] = fmaf(ex2(cex[j] - m2[it]), p[j], dri[it][j]);
    } else {                      // dk: t in group g + 1
#pragma unroll
      for (int t = (g + 1) * kTok; t < (g + 2) * kTok; ++t)
        axpy8(p, ld4(sA + t * kA + g * kTok), ld4(sA + t * kA + g * kTok + 4),
              sy[t * kP + x]);
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        dki[it][j] = fmaf(ex2(m2[it] - cum[it][j]), p[j], dki[it][j]);
    }
  }
  __syncthreads();

  // 6. dv's intra-chunk part: att^T do over t >= the group's first token
  // (att is zero above the diagonal); into sQdv for the kout G_c product's
  // epilogue to add, or stored as it is when G_c = 0
  float* sQdv = L::kFit ? sx : misc + 16 * W;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads, g = i / W;
    if (i >= kGroups * W) break;
    float dvs[kTok] = {};
    for (int t = g * kTok; t < kC; ++t)
      axpy8(dvs, ld4(sT + t * kA + g * kTok), ld4(sT + t * kA + g * kTok + 4),
            sdo[t * kP + x]);
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      const int t = g * kTok + j;
      if (has_g)
        sQdv[t * kP + x] = dvs[j];
      else if (t0 + t < S && x < hd)
        store(dv + offset(b, t0 + t, h, x, S, H, hd), dvs[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // G_c (and S_c where it fits) have landed

  // 7. the three state products on the tensor cores (state_product): dv's
  // kout G_c, added to the intra-chunk part and stored from the product's
  // fragments; dk's state term p_out = 2^(total - cum) (G_c v) and each
  // item's part of y's sum_s k p_out; dr's 2^cum_ex (S_c do); and each
  // item's quarter of the columns of <G_c[x, :], S_c[x, :]>. The items
  // read the last two back from sQ2 and sQ1: two dead tiles, behind one
  // barrier, where S_c has a region of its own; else one tile in turn,
  // S_c landing over the dead work region meanwhile.
  float* sQ2 = L::kFit ? sy : sQdv;
  float* sQ1 = L::kFit ? sA : sQdv;
  float kp[kItems], gs[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) kp[it] = gs[it] = 0.f;
  auto put_dv = [&](int t, int n, float v0, float v1) {
    if (t0 + t >= S) return;
    const size_t o = offset(b, t0 + t, h, n, S, H, hd);
    if (n < hd) store(dv + o, sQdv[t * kP + n] + v0);
    if (n + 1 < hd) store(dv + o + 1, sQdv[t * kP + n + 1] + v1);
  };
  auto put_q2 = [&](int t, int n, float v0, float v1) {
    *reinterpret_cast<float2*>(sQ2 + t * kP + n) = make_float2(v0, v1);
  };
  auto put_q1 = [&](int t, int n, float v0, float v1) {
    *reinterpret_cast<float2*>(sQ1 + t * kP + n) = make_float2(v0, v1);
  };
  auto read_q2 = [&]() {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int g = (tid + it * kThreads) / W;
      if (g >= kGroups || !has_g) break;
#pragma unroll
      for (int j = 0; j < kTok; ++j) {
        const int t = g * kTok + j;
        const float po = ex2(tot[it] - cum[it][j]) * sQ2[t * kP + x];
        dki[it][j] += po;
        kp[it] = fmaf(sk[t * kP + x], po, kp[it]);
      }
    }
  };
  if (has_g) state_product<W, false>(sko, sG, put_dv);
  if constexpr (!L::kFit) {
    __syncthreads();   // kout, A, att, the level rows and sQdv are free
    if (has_s) stage_state<W>(states + (bh * slots + c - 1) * ww, sS);
    cp_async_commit();
  }
  if (has_g) state_product<W, true>(sv, sG, put_q2);
  if constexpr (!L::kFit) {
    __syncthreads();
    read_q2();
    cp_async_wait<0>();
    __syncthreads();   // the tile is free and S_c has landed
  }
  if (has_s) state_product<W, true>(sdo, sS, put_q1);
  __syncthreads();
  if constexpr (L::kFit) read_q2();
  if (has_s) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int g = (tid + it * kThreads) / W;
      if (g >= kGroups) break;
#pragma unroll
      for (int j = 0; j < kTok; ++j) {
        const float ce = j == 0 ? off[it] : cum[it][j - 1];
        dri[it][j] = fmaf(ex2(ce), sQ1[(g * kTok + j) * kP + x], dri[it][j]);
      }
      if (has_g)
        for (int cc = g * W / 16; cc < (g + 1) * W / 16; ++cc)
          gs[it] = dot4(ld4(sG + swz<W>(x, 4 * cc)),
                        ld4(sS + swz<W>(x, 4 * cc)), gs[it]);
    }
  }

  // 8. dr, dk; f and h for dwlog (z = the sum of f after the token in its
  // group, less h); the items' column partials: sum f, k p_out, <G, S>'s
  // quarter and du's r k A[t][t]
  float z[kItems][kTok];
  float* fsum = misc;
  float* kpart = misc + 4 * W;
  float* gspart = misc + 8 * W;
  float* dpart = misc + 12 * W;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int g = (tid + it * kThreads) / W;
    if (g >= kGroups) break;
    const float uu = su[x];
    float fs = 0.f, dus = 0.f;
#pragma unroll
    for (int j = kTok - 1; j >= 0; --j) {
      const int t = g * kTok + j;
      const float rv = sr[t * kP + x], kv = sk[t * kP + x], ad = sdg[t];
      const float drs = dri[it][j], dks = dki[it][j];
      if (t0 + t < S && x < hd) {
        const size_t o = offset(b, t0 + t, h, x, S, H, hd);
        store(dr + o, drs + uu * kv * ad);
        store(dk + o, dks + uu * rv * ad);
      }
      z[it][j] = fs - kv * dks;
      fs += rv * drs - kv * dks;
      dus = fmaf(rv * kv, ad, dus);
    }
    fsum[g * W + x] = fs;
    kpart[g * W + x] = kp[it];
    gspart[g * W + x] = gs[it];
    dpart[g * W + x] = dus;
  }
  __syncthreads();
  // dwlog: the later groups' f, the item's z, and y
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int g = (tid + it * kThreads) / W;
    if (g >= kGroups) break;
    float gsum = 0.f, ksum = 0.f, after = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      gsum += gspart[q * W + x];
      ksum += kpart[q * W + x];
    }
    const float y = fmaf(ex2(tot[it]), gsum, ksum);
    for (int q = kGroups - 1; q > g; --q) after += fsum[q * W + x];
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      const int t = g * kTok + j;
      if (t0 + t < S && x < hd)
        dwlog[offset(b, t0 + t, h, x, S, H, hd)] = (after + z[it][j]) + y;
    }
  }
  for (int i = tid; i < W; i += kThreads) {
    float du = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) du += dpart[q * W + i];
    dupart[((static_cast<size_t>(b) * gridDim.x + c) * H + h) * W + i] = du;
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
  return static_cast<int>(sizeof(float)) * AdjointSmem<W>::kFloats;
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
