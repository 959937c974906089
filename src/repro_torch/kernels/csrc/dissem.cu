// Fused dissemination-stability pass with the per-group newly-stable count.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dissem.py
// (stability_update_grouped):
//
//     bits_out[g, w, :] = bits[g, w, :] | update[g, w, :]  uint32[G, W, WORDS]
//     counts[g, w]      = sum popcount(bits_out[g, w, :])   int32[G, W]
//     stable_out[g, w]  = stable_in[g, w] | (counts >= majority)
//     newly[g]          = sum_w (stable_out & ~stable_in)   int32[G]
//
// Design: the row pass of quorum.cu (one warp per window row, coalesced
// word loads, __popc, __reduce_add_sync), plus newly[g] by atomicAdd from
// lane 0 of each row that crosses the threshold. The TPU kernel zeroes
// newly on the first block of its sequential grid (pl.when); blocks here
// run in no order, so the wrapper zeroes newly before the launch instead.
// Integer atomics give the exact count in any order. As in quorum.cu, the
// wrapper may pass the bits buffer as bits_out.
//
// Bound on an H100: bytes. At the engine's hold shape (G=4, W=2048,
// WORDS=8 for a 250-disseminator partition) one call moves ~0.8 MB, well
// under 1 us at 3.35 TB/s, so the launch dominates and the kernel is
// launch-bound. Making it fast (a fused tick, CUDA graphs) is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void stability_kernel(const uint32_t* bits, const uint32_t* update,
                                 const uint8_t* stable_in, uint32_t* bits_out,
                                 int32_t* counts, uint8_t* stable_out,
                                 int32_t* newly, int rows, int window,
                                 int words, int majority) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform: the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * words;
  unsigned count = 0;
  for (int w = lane; w < words; w += 32) {
    const uint32_t v = bits[base + w] | update[base + w];
    bits_out[base + w] = v;
    count += __popc(v);
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) {
    const bool prev = stable_in[row] != 0;
    const bool now = prev || static_cast<int>(count) >= majority;
    counts[row] = static_cast<int32_t>(count);
    stable_out[row] = now ? 1 : 0;
    if (now && !prev) atomicAdd(&newly[row / window], 1);
  }
}

}  // namespace

extern "C" int stability_update_launch(const void* bits, const void* update,
                                       const void* stable_in, void* bits_out,
                                       void* counts, void* stable_out,
                                       void* newly, int groups, int window,
                                       int words, int majority,
                                       void* stream) {
  const int rows = groups * window;
  if (rows > 0) {
    const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    stability_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bits),
        static_cast<const uint32_t*>(update),
        static_cast<const uint8_t*>(stable_in),
        static_cast<uint32_t*>(bits_out), static_cast<int32_t*>(counts),
        static_cast<uint8_t*>(stable_out), static_cast<int32_t*>(newly),
        rows, window, words, majority);
  }
  return static_cast<int>(cudaGetLastError());
}
