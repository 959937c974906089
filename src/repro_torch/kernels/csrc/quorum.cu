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
// Design: one warp per window row r. Lanes stride over the row's words
// with coalesced 32-bit loads, __popc each word, and the warp reduces the
// row count with __reduce_add_sync; lane 0 writes counts and stable. Bool
// tensors travel as uint8 (torch.bool is one byte holding 0 or 1). Every
// element of bits_out is read (from bits) and written by the same thread,
// so the wrapper may pass the bits buffer as bits_out (in-place update).
//
// Bound on an H100: bytes. At the engine's shapes (G=4, W=2048, WORDS=32
// for 1000 disseminators, WORDS=1 for 16 sequencers) one call moves at
// most ~3.2 MB, under 1 us at 3.35 TB/s, so a launch costs more than the
// work and the kernel is launch-bound. Making it fast (a fused tick, CUDA
// graphs around the tick) is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void quorum_kernel(const uint32_t* bits, const uint32_t* update,
                              const uint8_t* stable_in, uint32_t* bits_out,
                              int32_t* counts, uint8_t* stable_out,
                              int rows, int words, int majority) {
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
    counts[row] = static_cast<int32_t>(count);
    stable_out[row] =
        (stable_in[row] != 0 || static_cast<int>(count) >= majority) ? 1 : 0;
  }
}

}  // namespace

extern "C" int quorum_update_launch(const void* bits, const void* update,
                                    const void* stable_in, void* bits_out,
                                    void* counts, void* stable_out, int rows,
                                    int words, int majority, void* stream) {
  if (rows > 0) {
    const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    quorum_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bits),
        static_cast<const uint32_t*>(update),
        static_cast<const uint8_t*>(stable_in),
        static_cast<uint32_t*>(bits_out), static_cast<int32_t*>(counts),
        static_cast<uint8_t*>(stable_out), rows, words, majority);
  }
  return static_cast<int>(cudaGetLastError());
}
