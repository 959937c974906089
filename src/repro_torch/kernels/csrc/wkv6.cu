// Chunked WKV6 scan (the RWKV6 time-mix recurrence), f32 state per head,
// split over the sequence into three passes.
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
// Chunked form, C = 32 tokens per chunk c, cum = inclusive cumulative sum
// of wlog inside the chunk, cum_ex = cum - wlog (cum of the token before),
// total = cum[C-1], S_c = the state entering chunk c (S_0 = 0):
//
//     a[t, s] = sum_d r[t,d] k[s,d] exp(cum_ex[t,d] - cum[s,d])   s < t
//     a[t, t] = sum_d r[t,d] u[d] k[t,d]
//     o[t, :] = sum_{s<=t} a[t, s] v[s, :]
//             + sum_d r[t,d] exp(cum_ex[t,d]) S_c[d, :]
//     dS_c[d, :] = sum_s k[s,d] exp(total[d] - cum[s,d]) v[s, :]
//     S_{c+1} = diag(exp(total)) S_c + dS_c
//
// Passes, all launched by one wkv6_launch call on the caller's stream:
//
// 1. wkv6_chunk_state_kernel: one block per (chunk, head, batch) for every
//    chunk but the last (whose state no output reads) computes the chunk's
//    own contribution dS_c and its decay exp(total_c) into the workspace.
//    4,960 blocks at the rwkv6-3b prefill shape [4,1024,40,64].
// 2. wkv6_state_scan_kernel: one thread per (batch, head, d, j) state
//    element scans over the chunks, S_{c+1} = exp(total_c) S_c + dS_c,
//    writing S_{c+1} over dS_c in place. No barrier: the scans are
//    independent, and each thread issues the loads of kScanUnroll chunks
//    before it uses the first. 655,360 scans of 31 steps at that shape.
// 3. wkv6_output_kernel: one block per (chunk, head, batch), 5,120 blocks,
//    computes the chunk's outputs from its inputs and S_c.
//
// The workspace is allocated by the caller (the Python wrapper, with
// torch.empty, so the caching allocator owns it): (ceil(S/C) - 1) slots
// per (batch, head), each an f32 [W, W] state (W = hd padded to 32, 64 or
// 128), then the [W] decays of every slot: B * H * (ceil(S/C) - 1) * W *
// (W + 1) floats, 82,534,400 bytes at the prefill shape. Nothing here
// allocates.
//
// No exponent is positive, so the result is finite wherever the
// recurrence is. The TPU kernel factors the intra-chunk decay as
// (r exp(cum_ex)) . (k exp(-cum)); over a 128-token chunk the model's log
// decay (about -0.7 per step) sums past -88.7, exp(-cum) overflows f32
// and the product gives inf * 0 = NaN. Here, with wlog <= 0, cum falls
// monotonically through a chunk (a rounded sum of non-positive terms never
// rises; group_bounds keeps that true of the sums as computed), and every
// exponent is a later cum minus an earlier one:
// - a[t, s] is factorised on two levels (the chunk's halves, and each
//   half's halves): for t in a block's right half and s in its left half,
//   with m the left half's last token,
//   exp(cum_ex[t] - cum[s]) = exp(cum_ex[t] - cum[m]) * exp(cum[m] - cum[s]),
//   both factors <= 1, so those entries are plain products of decayed r and
//   decayed k rows. Only pairs inside the same 8-token leaf take one exp
//   per (t, s, d), and adjacent tokens none (their exponent is 0);
// - dS_c takes exp(total - cum[s]), the state term exp(cum_ex[t]) and the
//   scan exp(total): all <= 1. A decay that underflows gives 0, as the
//   recurrence's own product of factors would.
// The exponentials are ex2.approx on log2(e)-scaled sums (about 2 ulp).
//
// Arithmetic is f32 FFMA on the CUDA cores: the tensor cores would round
// f32 operands to TF32 (about 1e-3 relative), far outside the 1e-5
// tolerance against the plain version. Head dims are compiled at the
// padded widths 32, 64 and 128, with columns past hd zero.
//
// Bound on an H100: at [4,1024,40,64], r/k/v bf16, the function moves
// ~147 MB (inputs once, output once) and needs ~2.7 GFLOP, so bytes bound
// it (~44 us at 3.35 TB/s). The split adds the workspace round trip
// (written by pass 1, read and written by pass 2, read by pass 3: ~330 MB)
// and reads k, v and wlog twice; the passes' own floors at HBM rate are
// about 48, 50 and 67 us. In exchange, passes 1 and 3 run thousands of
// independent blocks where one block per (head, batch) gave 160 serial
// chunk loops. Passes 1 and 3 spend their compute in shared-memory reads,
// which share the load/store pipe with their global loads, so within a
// block the two do not overlap; each pass issues the loads that only its
// last step needs (v, and S_c in pass 3) after the loads its first steps
// wait on, so that they overlap the work between.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 32;           // tokens per chunk
constexpr int kTok = 8;          // tokens of one column that a thread sums
constexpr int kGroups = kC / kTok;
constexpr int kSub = kC / 2;     // tokens in half a chunk
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kRows = 8;         // rows of a thread's register tile
constexpr int kTS = kC + 4;      // row stride of [.][kC] tiles (16-byte rows)
constexpr int kScanUnroll = 8;   // chunk loads in flight per scan thread
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kC == 32 && kTok == 8 && kRows == 8,
              "the weights pass is laid out for 4 groups of 8 tokens");

// the padded head width a head dim runs at: 32, 64 or 128
int width(int hd) { return hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

template <int HD>
constexpr int state_smem_floats() {
  return 2 * kC * HD + kGroups * HD;
}

__device__ __forceinline__ size_t offset(int b, int t, int h, int d, int S,
                                         int H, int hd) {
  return ((static_cast<size_t>(b) * S + t) * H + h) * hd + d;
}

// 2^x on the special-function unit (ex2.approx.ftz.f32, about 2 ulp). A
// result below 2^-126 flushes to 0; every x here is <= 0, and a term that
// small is below the f32 rounding of the sums it enters.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x[0..7] = p[o .. o+7] as f32, the first n of them (the rest 0); one or
// two 16-byte loads when vec (o a multiple of 8, p 16-byte aligned)
__device__ __forceinline__ void load8(const float* __restrict__ p, size_t o,
                                      int n, bool vec, float (&x)[8]) {
  if (vec && n == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p + o);
    const float4 b = *reinterpret_cast<const float4*>(p + o + 4);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = q < n ? p[o + q] : 0.f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      size_t o, int n, bool vec,
                                      float (&x)[8]) {
  if (vec && n == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + o);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h2[q]);
      x[2 * q] = f.x, x[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = q < n ? __bfloat162float(p[o + q]) : 0.f;
  }
}

// true when every row of the [.., hd] inputs starts on 16 bytes
template <typename T>
__device__ __forceinline__ bool rows_aligned(int hd, const T* a, const T* b,
                                             const T* c) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return hd % 8 == 0 && (bits & 15) == 0;
}

// dst[0..7] = x, as two 16-byte stores (dst 16-byte aligned)
__device__ __forceinline__ void store8(float* dst, const float (&x)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// load8, then store8 into shared memory
template <typename T>
__device__ __forceinline__ void stage8(const T* __restrict__ p, size_t o,
                                       int n, bool vec, float* dst) {
  float x[8];
  load8(p, o, n, vec, x);
  store8(dst, x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i] += row[i] * x for the 8 values of row (two aligned float4 loads)
__device__ __forceinline__ void fma8(float (&acc)[kRows], const float* row,
                                     float x) {
  const float4 a = ld4(row), b = ld4(row + 4);
  acc[0] = fmaf(a.x, x, acc[0]);
  acc[1] = fmaf(a.y, x, acc[1]);
  acc[2] = fmaf(a.z, x, acc[2]);
  acc[3] = fmaf(a.w, x, acc[3]);
  acc[4] = fmaf(b.x, x, acc[4]);
  acc[5] = fmaf(b.y, x, acc[5]);
  acc[6] = fmaf(b.z, x, acc[6]);
  acc[7] = fmaf(b.w, x, acc[7]);
}

// The prefix sums of one column d of a chunk. A thread owns kTok tokens
// (group g) of column d and has summed them, cs[i] = w2[g kTok] + ... +
// w2[g kTok + i]; sg holds every group's sum. bound[q] is the chained sum
// of groups 0 .. q-1 (bound[0] = 0, bound[kGroups] = total), and the
// chunk's cumsum at token g kTok + i is bound[g] + cs[i]. So the cumsum at
// the last token of group g is bound[g + 1] exactly, the sequence falls
// monotonically (every term <= 0), and each bound is a value of it.
__device__ __forceinline__ void group_bounds(const float* sg, int d, int HD,
                                             float (&bound)[kGroups + 1]) {
  bound[0] = 0.f;
#pragma unroll
  for (int q = 0; q < kGroups; ++q) bound[q + 1] = bound[q] + sg[q * HD + d];
}

// bound[g] for a g known only at run time, without indexing the array
__device__ __forceinline__ float pick(const float (&bound)[kGroups + 1],
                                      int g) {
  float x = 0.f;
#pragma unroll
  for (int q = 0; q <= kGroups; ++q) x = q == g ? bound[q] : x;
  return x;
}

// The log2-scaled decay of chunk t0 of head h, batch b, summed by groups.
// Item it of the thread is column d = item % HD, group g = item / HD:
// cs[it][i] sums its first i + 1 tokens, sg[g][d] all kTok. Tokens past S
// and columns past hd add 0.
template <int HD, int kItems>
__device__ __forceinline__ void sum_groups(const float* __restrict__ wlog,
                                           int b, int t0, int h, int S, int H,
                                           int hd, float (&cs)[kItems][kTok],
                                           float* sg) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = threadIdx.x + it * kThreads, d = item % HD, g = item / HD;
    if (item >= HD * kGroups) break;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      const int t = t0 + g * kTok + i;
      if (t < S && d < hd) sum += wlog[offset(b, t, h, d, S, H, hd)] * kLog2e;
      cs[it][i] = sum;
    }
    sg[g * HD + d] = sum;
  }
}

// Pass 1. Chunk c (full: every chunk but the last is) of head h, batch b:
// state[d, j] = sum_s k[s,d] 2^(total2[d] - cum2[s,d]) v[s,j] and
// decay[d] = 2^total2[d], cum2 the log2-scaled inclusive cumsum; HD is the
// padded width, columns past hd are zero.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    wkv6_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                            const float* __restrict__ wlog,
                            float* __restrict__ state,
                            float* __restrict__ decay, int S, int H, int hd,
                            int slots) {
  constexpr int kItems = (HD * kGroups + kThreads - 1) / kThreads;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);  // [kC][HD] k 2^(total-cum)
  float* sv = sk + kC * HD;                     // [kC][HD] v
  float* sg = sv + kC * HD;                     // [kGroups][HD] group sums
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, t0 = c * kC;
  const size_t slot = (static_cast<size_t>(b) * H + h) * slots + c;

  // k (8 columns of one token per load), then the decay's group sums
  const bool vec = rows_aligned(hd, k, v, v);
  for (int i = tid; i < kC * HD / 8; i += kThreads) {
    const int t = i / (HD / 8), d0 = (i % (HD / 8)) * 8;
    const int n = min(max(hd - d0, 0), 8);
    stage8(k, n > 0 ? offset(b, t0 + t, h, d0, S, H, hd) : 0, n, vec,
           sk + t * HD + d0);
  }
  float cs[kItems][kTok];
  sum_groups<HD>(wlog, b, t0, h, S, H, hd, cs, sg);
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = tid + it * kThreads, d = item % HD, g = item / HD;
    if (item >= HD * kGroups) break;
    float bound[kGroups + 1];
    group_bounds(sg, d, HD, bound);
    const float off = pick(bound, g), total = bound[kGroups];
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      sk[(g * kTok + i) * HD + d] *= ex2(total - (off + cs[it][i]));
    if (g == 0) decay[slot * HD + d] = ex2(total);
  }
  // v, which only the product reads: loaded after the decay's loads
  for (int i = tid; i < kC * HD / 8; i += kThreads) {
    const int t = i / (HD / 8), d0 = (i % (HD / 8)) * 8;
    const int n = min(max(hd - d0, 0), 8);
    stage8(v, n > 0 ? offset(b, t0 + t, h, d0, S, H, hd) : 0, n, vec,
           sv + t * HD + d0);
  }
  __syncthreads();
  // one item = 2 consecutive columns j x kRows consecutive rows d
  float* dst = state + slot * HD * HD;
  for (int item = tid; item < (HD / 2) * (HD / kRows); item += kThreads) {
    const int j = (item % (HD / 2)) * 2, d0 = (item / (HD / 2)) * kRows;
    float acc0[kRows] = {}, acc1[kRows] = {};
#pragma unroll 8
    for (int t = 0; t < kC; ++t) {
      const float2 x = *reinterpret_cast<const float2*>(sv + t * HD + j);
      fma8(acc0, sk + t * HD + d0, x.x);
      fma8(acc1, sk + t * HD + d0, x.y);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      *reinterpret_cast<float2*>(dst + (d0 + i) * HD + j) =
          make_float2(acc0[i], acc1[i]);
  }
}

// Pass 2. Element e of the [HD, HD] state of one (batch, head): turn the
// slots' contributions dS_c into S_{c+1}, in place.
__global__ void __launch_bounds__(kThreads)
    wkv6_state_scan_kernel(float* __restrict__ state,
                           const float* __restrict__ decay, int BH, int HD,
                           int slots) {
  const size_t hh = static_cast<size_t>(HD) * HD;
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= BH * hh) return;
  const size_t bh = e / hh, i = e % hh;
  float* st = state + bh * slots * hh + i;
  const float* dec = decay + bh * slots * HD + i / HD;
  float s = 0.f;
  for (int c0 = 0; c0 < slots; c0 += kScanUnroll) {
    float x[kScanUnroll], w[kScanUnroll];
#pragma unroll
    for (int q = 0; q < kScanUnroll; ++q) {
      const bool in = c0 + q < slots;
      x[q] = in ? st[(c0 + q) * hh] : 0.f;
      w[q] = in ? dec[(c0 + q) * HD] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kScanUnroll; ++q) {
      if (c0 + q < slots) {
        s = fmaf(w[q], s, x[q]);
        st[(c0 + q) * hh] = s;
      }
    }
  }
}

// Pass 3. The outputs of chunk c of head h, batch b (the last chunk may
// be short: tokens past S are zero and are not written).
//
// The intra-chunk weights a[t, s] (s <= t) come in three kinds. With
// pivot m the last token of the left half of the level's block:
// - level 1 (t in tokens 16..31, s in 0..15, m = 15) and level 2 (t in
//   the second 8 tokens of a half, s in its first 8, m = the half's 8th
//   token): a plain product of decayed rows, x_t . y_s with
//   x_t = r_t 2^(cum_ex[t] - cum[m]) and y_s = k_s 2^(cum[m] - cum[s]).
//   A token is the right side of one level-1 block and one level-2 block
//   at most, so one row per level (tiles sx and sy) holds every x and y;
// - leaf pairs inside a block of 8 tokens: one exp per (t, s, d);
// - the bonus a[t, t] = r_t . (u k_t).
// Each thread takes 2 x 2 entries over a quarter of the head dim (four
// 16-byte loads per 4 columns feed 16 FMAs) and the quarters are summed by
// warp shuffles.
template <int HD>
struct OutputSmem {
  static constexpr int kP = HD + 4;   // row stride: 16-byte rows whose
  //                                     float4 reads by 8 lanes of distinct
  //                                     rows hit distinct banks
  static constexpr int kTile = kC * kP;
  // after the weights pass: S_c and v over tiles 2-4 where they fit
  static constexpr bool kFit = HD * HD + kC * HD <= 3 * kTile;
  static constexpr int kFloats =
      5 * kTile + kC * kTS + HD + (kFit ? 0 : HD * HD + kC * HD);
};

// acc += a * b, lane by lane
__device__ __forceinline__ void fma4(float4& acc, float4 a, float4 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float sum4(float4 a) {
  return (a.x + a.y) + (a.z + a.w);
}

// acc[i] += a[i] * x for the 4 tokens i of a and the 2 columns of x
__device__ __forceinline__ void fma4x2(float2 (&acc)[4], float4 a, float2 x) {
  acc[0].x = fmaf(a.x, x.x, acc[0].x), acc[0].y = fmaf(a.x, x.y, acc[0].y);
  acc[1].x = fmaf(a.y, x.x, acc[1].x), acc[1].y = fmaf(a.y, x.y, acc[1].y);
  acc[2].x = fmaf(a.z, x.x, acc[2].x), acc[2].y = fmaf(a.z, x.y, acc[2].y);
  acc[3].x = fmaf(a.w, x.x, acc[3].x), acc[3].y = fmaf(a.w, x.y, acc[3].y);
}

// the 2 x 2 block of x_t . y_s for t in {t0, t1}, s in {s0, s1}, over
// columns [d0, d0 + n): (t0,s0), (t0,s1), (t1,s0), (t1,s1)
template <int kP>
__device__ __forceinline__ float4 dot2x2(const float* x, const float* y,
                                         int t0, int t1, int s0, int s1,
                                         int d0, int n) {
  float4 a00{}, a01{}, a10{}, a11{};
  for (int d = d0; d < d0 + n; d += 4) {
    const float4 p = ld4(x + t0 * kP + d), q = ld4(x + t1 * kP + d);
    const float4 e = ld4(y + s0 * kP + d), f = ld4(y + s1 * kP + d);
    fma4(a00, p, e), fma4(a01, p, f), fma4(a10, q, e), fma4(a11, q, f);
  }
  return make_float4(sum4(a00), sum4(a01), sum4(a10), sum4(a11));
}

// sum_d r[t,d] k[s,d] 2^(cum[t-1,d] - cum[s,d]) for one (t, s), s < t - 1,
// over four columns
__device__ __forceinline__ float pair4(float4 r, float4 k, float4 ct,
                                       float4 cs, float acc) {
  acc = fmaf(r.x * k.x, ex2(ct.x - cs.x), acc);
  acc = fmaf(r.y * k.y, ex2(ct.y - cs.y), acc);
  acc = fmaf(r.z * k.z, ex2(ct.z - cs.z), acc);
  return fmaf(r.w * k.w, ex2(ct.w - cs.w), acc);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : 1)
    wkv6_output_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ wlog,
                       const float* __restrict__ u,
                       const float* __restrict__ state,
                       float* __restrict__ out, int S, int H, int hd,
                       int slots) {
  using L = OutputSmem<HD>;
  constexpr int kP = L::kP;
  constexpr int kItems = (HD * kGroups + kThreads - 1) / kThreads;
  constexpr int kState4 = (HD * HD / 4 + kThreads - 1) / kThreads;
  constexpr int kVec = (kC * HD / 8 + kThreads - 1) / kThreads;
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);  // [kC][kP] level-1 rows
  float* sy = sx + L::kTile;      // [kC][kP] level-2 rows
  float* sk = sy + L::kTile;      // [kC][kP] k
  float* sr = sk + L::kTile;      // [kC][kP] r
  float* sc = sr + L::kTile;      // [kC][kP] cumsum of the log2 decay
  float* sa = sc + L::kTile;      // [kC][kTS] a, transposed: sa[s][t]
  float* sg = sa;                 // [kGroups][HD] group sums, before sa
  float* su = sa + kC * kTS;      // [HD] u
  float* sq = sx;                 // [HD][kTS] r * 2^cum_ex, transposed,
  //                                 after the weights pass
  float* ss = L::kFit ? sk : su + HD;  // [HD][HD] S_c, after sq is made
  float* sv = ss + HD * HD;            // [kC][HD] v, likewise
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, t0 = c * kC;

  // r and k (8 columns of one token per load), then the decay's group
  // sums; tokens past S and columns past hd are zero, and add nothing
  const bool vec = rows_aligned(hd, r, k, v);
  for (int i = tid; i < kC * HD / 8; i += kThreads) {
    const int t = i / (HD / 8), d0 = (i % (HD / 8)) * 8;
    const int n = t0 + t < S ? min(max(hd - d0, 0), 8) : 0;
    const size_t o = n > 0 ? offset(b, t0 + t, h, d0, S, H, hd) : 0;
    stage8(r, o, n, vec, sr + t * kP + d0);
    stage8(k, o, n, vec, sk + t * kP + d0);
  }
  float cs[kItems][kTok];
  sum_groups<HD>(wlog, b, t0, h, S, H, hd, cs, sg);
  for (int i = tid; i < HD; i += kThreads) su[i] = i < hd ? u[h * hd + i] : 0.f;
  __syncthreads();
  // cumsums and the level rows. Group g of 8 tokens is the left half of
  // its level-2 block when g is even (pivot: its own last token) and the
  // right half when odd (pivot: the last token before it); groups 0-1 are
  // the left half of the level-1 block (pivot: token 15).
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = tid + it * kThreads, d = item % HD, g = item / HD;
    if (item >= HD * kGroups) break;
    float bound[kGroups + 1];
    group_bounds(sg, d, HD, bound);
    const float off = pick(bound, g), m1 = bound[kSub / kTok];
    const float m2 = g % 2 == 0 ? pick(bound, g + 1) : off;
    float ex = off;   // cum_ex of the group's first token
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      const int t = g * kTok + i;
      const float cum = off + cs[it][i];
      const float rv = sr[t * kP + d], kv = sk[t * kP + d];
      sc[t * kP + d] = cum;
      sx[t * kP + d] = t < kSub ? kv * ex2(m1 - cum) : rv * ex2(ex - m1);
      sy[t * kP + d] = g % 2 == 0 ? kv * ex2(m2 - cum) : rv * ex2(ex - m2);
      ex = cum;
    }
  }
  __syncthreads();
  // v and S_c, which only the last step reads: fetched now into
  // registers, so that their loads overlap the weights pass
  float vx[kVec][8];
#pragma unroll
  for (int it = 0; it < kVec; ++it) {
    const int i = tid + it * kThreads;
    if (i >= kC * HD / 8) break;
    const int t = i / (HD / 8), d0 = (i % (HD / 8)) * 8;
    const int n = t0 + t < S ? min(max(hd - d0, 0), 8) : 0;
    load8(v, n > 0 ? offset(b, t0 + t, h, d0, S, H, hd) : 0, n, vec, vx[it]);
  }
  float4 st[kState4];
  if (c > 0) {
    const float4* src = reinterpret_cast<const float4*>(
        state + ((static_cast<size_t>(b) * H + h) * slots + c - 1) * HD * HD);
#pragma unroll
    for (int q = 0; q < kState4; ++q)
      if (tid + q * kThreads < HD * HD / 4) st[q] = src[tid + q * kThreads];
  }
  // the weights: zero above the diagonal, then units of 2 x 2 entries
  // over a quarter of the columns. The 32 units of a warp share a kind;
  // lane l takes column quarter l / 8 of the kind's 2 x 2 block 8 w + l % 8,
  // w the warp's index among the kind's warp-groups.
  for (int i = tid; i < kC * kC; i += kThreads) {
    const int s = i / kC, t = i % kC;
    if (s > t) sa[s * kTS + t] = 0.f;
  }
  // warp-groups of each kind end at: level 1, level 2, leaf pairs, then
  // the 2 x 2 diagonal blocks
  constexpr int kL1 = 8, kL2 = kL1 + 4, kLeaf = kL2 + 3;
  constexpr int kUnits = 32 * (kLeaf + 2);
  for (int p = tid; p < kUnits; p += kThreads) {
    const int grp = p / 32, q = lane / 8, e = lane % 8;
    const int n = HD / 4, d0 = q * n;
    int ta, tb, sa0, sb;
    float4 acc;
    if (grp < kL1) {              // level 1: t in 16..31, s in 0..15
      const int tile = grp * 8 + e;
      ta = kSub + tile / 8, tb = ta + 8, sa0 = tile % 8, sb = sa0 + 8;
      acc = dot2x2<kP>(sx, sx, ta, tb, sa0, sb, d0, n);
    } else if (grp < kL2) {       // level 2, in each half of 16
      const int tile = (grp - kL1) * 8 + e, base = (tile / 16) * kSub;
      ta = base + 8 + (tile % 16) / 4, tb = ta + 4;
      sa0 = base + tile % 4, sb = sa0 + 4;
      acc = dot2x2<kP>(sy, sy, ta, tb, sa0, sb, d0, n);
    } else if (grp < kLeaf) {     // leaf pairs below the 2 x 2 diagonal
      const int tile = (grp - kL2) * 8 + e, base = (tile / 6) * 8;
      const int k6 = tile % 6, i2 = k6 < 1 ? 1 : k6 < 3 ? 2 : 3;
      ta = base + 2 * i2, tb = ta + 1;
      sa0 = base + 2 * (k6 - i2 * (i2 - 1) / 2), sb = sa0 + 1;
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
      for (int d = d0; d < d0 + n; d += 4) {
        const float4 ra = ld4(sr + ta * kP + d), rb = ld4(sr + tb * kP + d);
        const float4 ca = ld4(sc + (ta - 1) * kP + d);
        const float4 cb = ld4(sc + (tb - 1) * kP + d);
        const float4 ka = ld4(sk + sa0 * kP + d), kb = ld4(sk + sb * kP + d);
        const float4 c0 = ld4(sc + sa0 * kP + d), c1 = ld4(sc + sb * kP + d);
        a00 = pair4(ra, ka, ca, c0, a00), a01 = pair4(ra, kb, ca, c1, a01);
        a10 = pair4(rb, ka, cb, c0, a10), a11 = pair4(rb, kb, cb, c1, a11);
      }
      acc = make_float4(a00, a01, a10, a11);
    } else {                      // the 2 x 2 diagonal blocks: the bonus,
      //                             and the adjacent pair (decay 2^0 = 1)
      ta = sa0 = 2 * ((grp - kLeaf) * 8 + e), tb = sb = ta + 1;
      float4 a00{}, a10{}, a11{};
      for (int d = d0; d < d0 + n; d += 4) {
        const float4 ra = ld4(sr + ta * kP + d), rb = ld4(sr + tb * kP + d);
        const float4 ka = ld4(sk + ta * kP + d), kb = ld4(sk + tb * kP + d);
        const float4 w = ld4(su + d);
        fma4(a00, mul4(ra, w), ka), fma4(a10, rb, ka);
        fma4(a11, mul4(rb, w), kb);
      }
      acc = make_float4(sum4(a00), 0.f, sum4(a10), sum4(a11));
    }
#pragma unroll
    for (int m = 8; m <= 16; m *= 2) {   // sum the four quarters
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, m);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, m);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, m);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, m);
    }
    if (q == 0) {
      sa[sa0 * kTS + ta] = acc.x;
      if (sb <= ta) sa[sb * kTS + ta] = acc.y;
      sa[sa0 * kTS + tb] = acc.z;
      sa[sb * kTS + tb] = acc.w;
    }
  }
  __syncthreads();   // the level rows are dead: sq goes there
  for (int i = tid; i < kC * HD; i += kThreads) {
    const int d = i / kC, t = i % kC;
    sq[d * kTS + t] = sr[t * kP + d] * ex2(t > 0 ? sc[(t - 1) * kP + d] : 0.f);
  }
  __syncthreads();   // r, k and the cumsums are dead: S_c and v go there
  if (c > 0) {
#pragma unroll
    for (int q = 0; q < kState4; ++q)
      if (tid + q * kThreads < HD * HD / 4)
        reinterpret_cast<float4*>(ss)[tid + q * kThreads] = st[q];
  }
#pragma unroll
  for (int it = 0; it < kVec; ++it) {
    const int i = tid + it * kThreads;
    if (i >= kC * HD / 8) break;
    store8(sv + i * 8, vx[it]);   // token i / (HD / 8)
  }
  __syncthreads();
  // one item = 4 consecutive tokens t x 2 consecutive columns j
  for (int item = tid; item < (HD / 2) * (kC / 4); item += kThreads) {
    const int j = (item % (HD / 2)) * 2, tq = (item / (HD / 2)) * 4;
    float2 acc[4] = {};
    for (int s = 0; s < tq + 4; ++s) {
      const float4 a = ld4(sa + s * kTS + tq);
      fma4x2(acc, a, *reinterpret_cast<const float2*>(sv + s * HD + j));
    }
    if (c > 0) {
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float4 a = ld4(sq + d * kTS + tq);
        fma4x2(acc, a, *reinterpret_cast<const float2*>(ss + d * HD + j));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (t0 + tq + i >= S) break;
      float* o = out + offset(b, t0 + tq + i, h, j, S, H, hd);
      if (j < hd) o[0] = acc[i].x;
      if (j + 1 < hd) o[1] = acc[i].y;
    }
  }
}

template <typename T, int HD>
int launch_width(const T* r, const T* k, const T* v, const float* wlog,
           const float* u, float* out, float* ws, int B, int S, int H,
           int hd, cudaStream_t stream) {
  const int chunks = (S + kC - 1) / kC, slots = chunks - 1;
  float* state = ws;
  float* decay = ws + static_cast<size_t>(B) * H * slots * HD * HD;
  cudaError_t err;
  if (slots > 0) {
    const int smem1 = sizeof(float) * state_smem_floats<HD>();
    err = cudaFuncSetAttribute(wkv6_chunk_state_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem1);
    if (err != cudaSuccess) return static_cast<int>(err);
    wkv6_chunk_state_kernel<T, HD>
        <<<dim3(slots, H, B), kThreads, smem1, stream>>>(
            k, v, wlog, state, decay, S, H, hd, slots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t elems = static_cast<size_t>(B) * H * HD * HD;
    wkv6_state_scan_kernel<<<static_cast<unsigned>(
                                 (elems + kThreads - 1) / kThreads),
                             kThreads, 0, stream>>>(state, decay, B * H, HD,
                                                    slots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int smem3 = sizeof(float) * OutputSmem<HD>::kFloats;
  err = cudaFuncSetAttribute(wkv6_output_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_output_kernel<T, HD><<<dim3(chunks, H, B), kThreads, smem3, stream>>>(
      r, k, v, wlog, u, state, out, S, H, hd, slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* wlog,
           const float* u, float* out, float* ws, int B, int S, int H,
           int hd, cudaStream_t stream) {
  const T *rr = static_cast<const T*>(r), *kk = static_cast<const T*>(k),
          *vv = static_cast<const T*>(v);
  switch (width(hd)) {
    case 32:
      return launch_width<T, 32>(rr, kk, vv, wlog, u, out, ws, B, S, H, hd,
                                 stream);
    case 64:
      return launch_width<T, 64>(rr, kk, vv, wlog, u, out, ws, B, S, H, hd,
                                 stream);
    default:
      return launch_width<T, 128>(rr, kk, vv, wlog, u, out, ws, B, S, H, hd,
                                  stream);
  }
}

template <typename F>
int occupancy_of(F* fn, int bytes, int* blocks, int* smem) {
  if (bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *smem = bytes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, kThreads, bytes));
}

template <int HD>
int occupancy(int phase, int* blocks, int* smem) {
  switch (phase) {
    case 1:
      return occupancy_of(wkv6_chunk_state_kernel<__nv_bfloat16, HD>,
                          static_cast<int>(sizeof(float)) *
                              state_smem_floats<HD>(),
                          blocks, smem);
    case 2:
      return occupancy_of(wkv6_state_scan_kernel, 0, blocks, smem);
    case 3:
      return occupancy_of(wkv6_output_kernel<__nv_bfloat16, HD>,
                          static_cast<int>(sizeof(float)) *
                              OutputSmem<HD>::kFloats,
                          blocks, smem);
    default:
      return 1001;
  }
}

}  // namespace

// dtype of r, k and v: 0 = float32, 1 = bfloat16. wlog, u and out are
// float32; workspace is float32 of B * H * (ceil(S / 32) - 1) * W * (W + 1)
// elements, W the padded head width (32, 64 or 128: the least >= hd), and
// is not touched (may be null) when S <= 32. Returns a cudaError_t; 1001
// for an unsupported argument.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* wlog, const void* u, void* out,
                           void* workspace, int B, int S, int H, int hd,
                           int dtype, void* stream) {
  if (hd < 1 || hd > kMaxHd || B > 65535 || H > 65535) return 1001;
  if (B == 0 || S == 0 || H == 0) return 0;
  if (S > kC && workspace == nullptr) return 1001;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(wlog);
  const float* uu = static_cast<const float*>(u);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0)
    return launch<float>(r, k, v, w, uu, o, ws, B, S, H, hd, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, uu, o, ws, B, S, H, hd, s);
  return 1001;
}

// The f32 values of the workspace that wkv6_launch takes for these
// shapes (the wrapper sizes it by the same rule).
extern "C" long long wkv6_workspace_floats(int B, int S, int H, int hd) {
  const long long w = width(hd), slots = (S + kC - 1) / kC - 1;
  return slots > 0 ? static_cast<long long>(B) * H * slots * w * (w + 1) : 0;
}

// For pass `phase` (1, 2, 3) at head dim hd: the blocks one SM holds at
// once and the dynamic shared memory per block. Returns a cudaError_t;
// 1001 for a bad argument.
extern "C" int wkv6_occupancy(int phase, int hd, int* blocks, int* smem) {
  if (hd < 1 || hd > kMaxHd) return 1001;
  switch (width(hd)) {
    case 32:
      return occupancy<32>(phase, blocks, smem);
    case 64:
      return occupancy<64>(phase, blocks, smem);
    default:
      return occupancy<128>(phase, blocks, smem);
  }
}
