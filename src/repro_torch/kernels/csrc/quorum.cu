// Fused quorum pass over packed bitsets: OR, popcount, majority threshold.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quorum.py
// (quorum_update_grouped, and quorum_update, its single-group form, which
// the Python wrapper launches as G = 1):
//
//     bits_out[r, :] = bits[r, :] | update[r, :]      uint32[G*W, WORDS]
//     counts[r]      = sum_w popcount(bits_out[r, w]) int32[G*W]
//     stable_out[r]  = stable_in[r] | (counts[r] >= majority)
//
// Design: lanes map to the row's width. A row is read in vectors of V
// words: V = 4 (one 16-byte uint4 load a lane) when WORDS % 4 == 0 and
// bits, update and bits_out are 16-byte aligned, else V = 1. A segment
// of L lanes (the smallest power of two >= ceil(WORDS / V), at most 32)
// takes one row, so a warp holds 32 / L rows: the ack row (32 words) is 8
// lanes of uint4, the hold row (8 words) 2, the vote row (1 word) 1, and
// a vote warp covers 32 rows with loads coalesced across them. Wider rows
// loop inside the segment. The segment sums its count with
// __shfl_xor_sync over offsets L/2 ... 1 and its first lane writes counts
// and stable. A warp may straddle the last row, so no lane returns before
// the shuffles: lanes past the end add 0 and store nothing. The wrapper
// picks V and L (kernels/quorum.py, launch_plan). Bool tensors travel as
// uint8 (torch.bool is one byte holding 0 or 1). Every element of
// bits_out is read (from bits) and written by the same thread, so the
// wrapper may pass the bits buffer as bits_out (in-place update); neither
// pointer is __restrict__.
//
// Bound on an H100: the launch. At the engine's shapes (G=4, W=2048;
// WORDS=32 for 1000 disseminators, WORDS=1 for 16 sequencers) a call moves
// 3.2 MB (ack) or 0.15 MB (vote): 0.95 us and 0.04 us at 3.35 TB/s,
// against the floor of a launch, the same kernel on a one-row tile
// (chip_smoke.py, floor_ms). The mapping keeps every lane busy and every
// load as wide as the row allows, so what is left above that floor is the
// row pass's own latency and, for the ack tile, its bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// One row segment's share of the row pass: OR, store, popcount.
template <int V>
__device__ __forceinline__ unsigned row_pass(const uint32_t* bits,
                                             const uint32_t* update,
                                             uint32_t* bits_out, size_t base,
                                             int words, int seg_lane,
                                             int lanes) {
  unsigned count = 0;
  if (V == 4) {
    const uint4* b = reinterpret_cast<const uint4*>(bits + base);
    const uint4* u = reinterpret_cast<const uint4*>(update + base);
    uint4* o = reinterpret_cast<uint4*>(bits_out + base);
    for (int v = seg_lane; v < (words >> 2); v += lanes) {
      uint4 x = b[v];
      const uint4 y = u[v];
      x.x |= y.x;
      x.y |= y.y;
      x.z |= y.z;
      x.w |= y.w;
      o[v] = x;
      count += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
    }
  } else {
    for (int w = seg_lane; w < words; w += lanes) {
      const uint32_t x = bits[base + w] | update[base + w];
      bits_out[base + w] = x;
      count += __popc(x);
    }
  }
  return count;
}

template <int V>
__global__ void quorum_kernel(const uint32_t* bits, const uint32_t* update,
                              const uint8_t* stable_in, uint32_t* bits_out,
                              int32_t* counts, uint8_t* stable_out,
                              int rows, int words, int lanes_log2,
                              int majority) {
  const int lanes = 1 << lanes_log2;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = tid >> lanes_log2;
  const int seg_lane = static_cast<int>(tid) & (lanes - 1);
  const bool live = row < rows;
  unsigned count = 0;
  if (live) {
    count = row_pass<V>(bits, update, bits_out,
                        static_cast<size_t>(row) * words, words, seg_lane,
                        lanes);
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  if (live && seg_lane == 0) {
    counts[row] = static_cast<int32_t>(count);
    stable_out[row] =
        (stable_in[row] != 0 || static_cast<int>(count) >= majority) ? 1 : 0;
  }
}

}  // namespace

// vec is V (1 or 4), lanes_log2 is log2 L, blocks the grid the wrapper
// planned. A plan the kernel cannot run (V = 4 on a misaligned pointer or
// a width that 4 does not divide, L above 32) is refused before launch.
extern "C" int quorum_update_launch(const void* bits, const void* update,
                                    const void* stable_in, void* bits_out,
                                    void* counts, void* stable_out, int rows,
                                    int words, int majority, int vec,
                                    int lanes_log2, int blocks,
                                    void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(bits) |
                         reinterpret_cast<uintptr_t>(update) |
                         reinterpret_cast<uintptr_t>(bits_out);
  if ((vec != 1 && vec != 4) || lanes_log2 < 0 || lanes_log2 > 5 ||
      (vec == 4 && ((ptrs & 15) != 0 || (words & 3) != 0)) ||
      static_cast<long long>(blocks) * (kThreads >> lanes_log2) < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    auto kernel = vec == 4 ? quorum_kernel<4> : quorum_kernel<1>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bits),
        static_cast<const uint32_t*>(update),
        static_cast<const uint8_t*>(stable_in),
        static_cast<uint32_t*>(bits_out), static_cast<int32_t*>(counts),
        static_cast<uint8_t*>(stable_out), rows, words, lanes_log2,
        majority);
  }
  return static_cast<int>(cudaGetLastError());
}
