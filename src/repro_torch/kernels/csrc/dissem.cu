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
// Design: the row pass of quorum.cu (V words a load, 16-byte uint4 loads
// where the row and pointers allow; L lanes a row from the row's width;
// the segment count by __shfl_xor_sync; no lane returns before the
// shuffles), and newly reduced inside a thread block cluster:
//
// - Each group g is one cluster of C blocks (grid G*C along x, cluster
//   (C, 1, 1), C <= 8, portable), launched by cudaLaunchKernelEx.
// - Block `rank` strides over its group's rows, 256 / L rows a chunk, two
//   chunks a pass with both chunks' loads issued before either's stores.
//   It sums its rows' stable_out & ~stable_in in registers, then across
//   its warps in shared memory.
// - Thread 0 of each block sends the block's sum into slot `rank` of the
//   cluster's rank 0 through distributed shared memory: an st.async to the
//   address mapa gives, which counts its 4 bytes on an mbarrier in rank 0
//   (complete_tx). Rank 0 waits until the barrier has seen 4*C bytes, sums
//   the slots and writes newly[g].
// - Rank 0 initialises that barrier before it arrives on the cluster
//   barrier (relaxed) at entry; every block waits on the cluster barrier
//   after its row pass and before it sends, so no send finds the barrier
//   uninitialised and the cluster barrier's latency hides behind the row
//   pass. Blocks other than rank 0 leave once they have sent.
//
// So newly is written once, not accumulated: no atomics, no zeroed buffer
// and no fill launch, and a call is exactly one device op. Nothing waits
// on a release of global stores: the remote store is asynchronous, where a
// cluster.sync() in its place would hold every thread until its stores of
// bits_out, counts and stable had landed. The TPU kernel zeroes newly on
// the first block of its sequential grid (pl.when); the cluster takes the
// place of that order. The wrapper picks V, L and C (kernels/quorum.py,
// launch_plan). As in quorum.cu, the wrapper may pass the bits buffer as
// bits_out, so no pointer is __restrict__.
//
// Bound on an H100: the launch and the handoff. At the engine's hold shape
// (G=4, W=2048, WORDS=8 for a 250-disseminator partition) one call moves
// 0.83 MB, 0.25 us at 3.35 TB/s. Its floor, the same kernel on a one-row
// tile (chip_smoke.py, floor_ms), is above quorum.cu's by what the cluster
// barrier, the mbarrier and the block reduction cost; the two chunks a
// block passes over are what the hold shape adds to that floor.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ unsigned or_popc(uint32_t& x, uint32_t y) {
  x |= y;
  return __popc(x);
}
__device__ __forceinline__ unsigned or_popc(uint4& x, const uint4& y) {
  x.x |= y.x;
  x.y |= y.y;
  x.z |= y.z;
  x.w |= y.w;
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

// The row pass of quorum.cu (OR, store, popcount) over two rows at once: a
// lane loads its vectors of both rows before it stores either, so the two
// loads are in flight together. (No pointer is __restrict__, so the
// compiler may not hoist the second row's loads above the first row's
// stores itself.) T is uint32_t (V = 1) or uint4 (V = 4).
template <typename T>
__device__ __forceinline__ void row_pass2(const uint32_t* bits,
                                          const uint32_t* update,
                                          uint32_t* bits_out, size_t base0,
                                          bool live0, size_t base1,
                                          bool live1, int vecs, int seg_lane,
                                          int lanes, unsigned& count0,
                                          unsigned& count1) {
  const T* b0 = reinterpret_cast<const T*>(bits + base0);
  const T* u0 = reinterpret_cast<const T*>(update + base0);
  const T* b1 = reinterpret_cast<const T*>(bits + base1);
  const T* u1 = reinterpret_cast<const T*>(update + base1);
  for (int v = seg_lane; v < vecs; v += lanes) {
    T x0{}, y0{}, x1{}, y1{};
    if (live0) {
      x0 = b0[v];
      y0 = u0[v];
    }
    if (live1) {
      x1 = b1[v];
      y1 = u1[v];
    }
    if (live0) {
      count0 += or_popc(x0, y0);
      reinterpret_cast<T*>(bits_out + base0)[v] = x0;
    }
    if (live1) {
      count1 += or_popc(x1, y1);
      reinterpret_cast<T*>(bits_out + base1)[v] = x1;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Sum the segment counts over offsets L/2 ... 1 (every lane takes part).
__device__ __forceinline__ unsigned segment_sum(unsigned count, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  return count;
}

template <typename T>
__global__ void stability_kernel(const uint32_t* bits, const uint32_t* update,
                                 const uint8_t* stable_in, uint32_t* bits_out,
                                 int32_t* counts, uint8_t* stable_out,
                                 int32_t* newly, int window, int words,
                                 int lanes_log2, int majority) {
  __shared__ unsigned warp_sums[kWarps];
  __shared__ unsigned slots[kMaxCluster];   // rank 0's: each block's sum
  __shared__ uint64_t filled;               // rank 0's: the slots' bytes
  cg::cluster_group cluster = cg::this_cluster();
  const int lanes = 1 << lanes_log2;
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (rank == 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&filled))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // "this block has started": the matching wait comes after the row pass,
  // so the cluster barrier's latency hides behind it
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int g = blockIdx.x / c;
  const int rows_per_block = kThreads >> lanes_log2;
  const int seg_row = threadIdx.x >> lanes_log2;
  const int seg_lane = threadIdx.x & (lanes - 1);
  const int vecs = sizeof(T) == 16 ? words >> 2 : words;
  const size_t group_base = static_cast<size_t>(g) * window;
  const long long stride = static_cast<long long>(c) * rows_per_block;
  unsigned mine = 0;  // rows this thread turned stable (as segment lead)
  // two of the block's row chunks per pass (at the engine's hold shape,
  // W = 2048 and C = 8, that is all of them)
  for (long long first = static_cast<long long>(rank) * rows_per_block;
       first < window; first += 2 * stride) {
    const long long w0 = first + seg_row, w1 = w0 + stride;
    const bool live0 = w0 < window, live1 = w1 < window;
    const size_t row0 = group_base + static_cast<size_t>(live0 ? w0 : 0);
    const size_t row1 = group_base + static_cast<size_t>(live1 ? w1 : 0);
    unsigned count0 = 0, count1 = 0;
    row_pass2<T>(bits, update, bits_out, row0 * words, live0, row1 * words,
                 live1, vecs, seg_lane, lanes, count0, count1);
    count0 = segment_sum(count0, lanes);
    count1 = segment_sum(count1, lanes);
    if (seg_lane == 0) {
      if (live0) {
        const bool prev = stable_in[row0] != 0;
        const bool now = prev || static_cast<int>(count0) >= majority;
        counts[row0] = static_cast<int32_t>(count0);
        stable_out[row0] = now ? 1 : 0;
        mine += (now && !prev) ? 1u : 0u;
      }
      if (live1) {
        const bool prev = stable_in[row1] != 0;
        const bool now = prev || static_cast<int>(count1) >= majority;
        counts[row1] = static_cast<int32_t>(count1);
        stable_out[row1] = now ? 1 : 0;
        mine += (now && !prev) ? 1u : 0u;
      }
    }
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = mine;
  __syncthreads();
  // every block has started, so rank 0's barrier is initialised and its
  // shared memory may be written
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) {
    unsigned sum = 0;
    for (int i = 0; i < kWarps; ++i) sum += warp_sums[i];
    // the block's sum into rank 0's slot: an asynchronous remote store
    // that counts its 4 bytes on rank 0's barrier when they land, so no
    // block waits for its own global stores (as a release would)
    uint32_t slot, bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(slot)
                 : "r"(smem_addr(&slots[rank])), "r"(0));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(bar)
                 : "r"(smem_addr(&filled)), "r"(0));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 "
        "[%0], %1, [%2];\n" ::"r"(slot),
        "r"(sum), "r"(bar)
        : "memory");
    if (rank == 0) {  // wait for the C sums, then write newly[g] once
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(&filled)),
          "r"(4 * c)
          : "memory");
      uint32_t done = 0;
      while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(&filled))
            : "memory");
      }
      unsigned total = 0;
      for (int i = 0; i < c; ++i) total += slots[i];
      newly[g] = static_cast<int32_t>(total);
    }
  }
}

}  // namespace

// vec is V (1 or 4), lanes_log2 is log2 L, cluster is C; the grid is
// groups * C blocks. A plan the kernel cannot run (V = 4 on a misaligned
// pointer or a width that 4 does not divide, L above 32, C above 8) is
// refused before launch. A group with no rows still gets newly[g] = 0.
extern "C" int stability_update_launch(const void* bits, const void* update,
                                       const void* stable_in, void* bits_out,
                                       void* counts, void* stable_out,
                                       void* newly, int groups, int window,
                                       int words, int majority, int vec,
                                       int lanes_log2, int cluster,
                                       void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(bits) |
                         reinterpret_cast<uintptr_t>(update) |
                         reinterpret_cast<uintptr_t>(bits_out);
  if ((vec != 1 && vec != 4) || lanes_log2 < 0 || lanes_log2 > 5 ||
      (vec == 4 && ((ptrs & 15) != 0 || (words & 3) != 0)) || cluster < 1 ||
      cluster > kMaxCluster ||
      static_cast<long long>(groups) * cluster > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (groups > 0) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(groups * cluster), 1, 1);
    config.blockDim = dim3(kThreads, 1, 1);
    config.dynamicSmemBytes = 0;
    config.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    auto kernel =
        vec == 4 ? stability_kernel<uint4> : stability_kernel<uint32_t>;
    const cudaError_t err = cudaLaunchKernelEx(
        &config, kernel, static_cast<const uint32_t*>(bits),
        static_cast<const uint32_t*>(update),
        static_cast<const uint8_t*>(stable_in),
        static_cast<uint32_t*>(bits_out), static_cast<int32_t*>(counts),
        static_cast<uint8_t*>(stable_out), static_cast<int32_t*>(newly),
        window, words, lanes_log2, majority);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
