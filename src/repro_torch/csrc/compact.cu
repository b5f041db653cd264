// Stable front-pack of a device bool lane, for Hopper (sm_90a), in one
// launch.
//
// Replaces the TPU kernel exclusive_scan_pallas
// (src/repro/kernels/compact/compact.py:47) together with the scatter of its
// wrapper compact_mask (src/repro/kernels/compact/ops.py). The TPU kernel
// walks [8, 128] row blocks in grid order and threads the running count
// through an SMEM cell from one block to the next; that carry relies on a
// sequential grid, and its VMEM tile capped one launch at 2^21 rows.
//
// A stable permutation needs the total before any clear row can be placed
// (a clear row goes to count + i - excl), so one pass over the lane needs
// one wait across the whole grid, whatever the scan. The kernel is launched
// cooperatively (cudaLaunchCooperativeKernel), with no more blocks than can
// be resident on the card at once, so that every block can pass
// cooperative_groups' grid barrier. Each block owns a contiguous range of
// rows_per_block rows (the wrapper picks it: whole 1024-row tiles over at
// most half the resident grid), which keeps the pack stable:
//   1. each block counts the set rows of its range and publishes the count
//      in sums[block];
//   2. grid barrier;
//   3. each block sums the counts of the blocks before it and of all blocks
//      (block 0 writes that total to ``count``), then rereads its range,
//      which is still in L2, and rebuilds the exclusive position of every
//      row from its running offset, the warp counts and the ballot, writing
//      perm[dest] = i with dest = excl for a set row and count + i - excl
//      for a clear one. dest is a permutation of [0, n), so the scatter has
//      no collisions.
// Any length below 2^31 packs this way (the wrapper raises above it); a long
// lane gives each block more tiles.
//
// What bounds it on the H100: the function moves about 5 bytes a row (a
// bool read, an int32 written), 3.7 MB at the join's 742,279 rows, about
// 1.1 us at 3.35 TB/s. At that size the launch and the grid barrier cost
// more than the bytes. On an H100 80GB HBM3 at 700 W the kernel runs about
// 8 us at that size, 11.4 us a call on the device with its launch; the
// design before this one (three launches: tile counts, a one-block scan of
// them, the scatter, and a fill of count) 8.3 us and 15.3 us. One tile a
// block (725 blocks) was slower than two; PERF.md records the times.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Sum of v over the block; every thread gets it. ``red`` holds kWarps
// partial sums and is free again on return.
__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int32_t s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads) compact_mask_kernel(
    const uint8_t* __restrict__ mask, int64_t n, int64_t rows_per_block,
    int32_t* sums, int32_t* __restrict__ perm, int32_t* __restrict__ count) {
  __shared__ int32_t red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t lo = first < n ? first : n;
  const int64_t hi = n - lo > rows_per_block ? lo + rows_per_block : n;

  // 1. this block's set rows
  int32_t c = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) c += mask[i] != 0;
  c = block_sum(c, red);
  if (threadIdx.x == 0) sums[blockIdx.x] = c;

  // 2. every block has published its count
  cg::this_grid().sync();

  // 3. set rows before this block and in all, then the scatter
  int32_t before = 0, total = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
    const int32_t v = __ldcg(sums + b);   // written in this launch: not .nc
    total += v;
    before += b < blockIdx.x ? v : 0;
  }
  before = block_sum(before, red);
  total = block_sum(total, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = total;
  const unsigned below = (1u << lane) - 1u;
  int32_t run = before;                 // set rows before the current sweep
  for (int64_t base = lo; base < hi; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    const bool set = i < hi && mask[i] != 0;
    const unsigned bal = __ballot_sync(kFull, set);
    if (lane == 0) red[warp] = __popc(bal);
    __syncthreads();
    int32_t warps_before = 0, swept = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      warps_before += w < warp ? red[w] : 0;
      swept += red[w];
    }
    if (i < hi) {
      const int32_t row = static_cast<int32_t>(i);
      const int32_t excl = run + warps_before + __popc(bal & below);
      perm[set ? excl : total + (row - excl)] = row;
    }
    run += swept;
    __syncthreads();                    // red is rewritten next sweep
  }
}

}  // namespace

// The most blocks of the kernel that are resident on ``device`` at once:
// the largest grid a cooperative launch takes. Negative on a CUDA error.
extern "C" int compact_mask_max_blocks(int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
      != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, compact_mask_kernel, kThreads, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

// One cooperative launch of ``grid`` blocks over n > 0 rows; ``sums`` holds
// grid int32 slots of scratch. Returns the launch's cudaError.
extern "C" int compact_mask_launch(const uint8_t* mask, int64_t n,
                                   int64_t rows_per_block, int grid,
                                   int32_t* sums, int32_t* perm,
                                   int32_t* count, void* stream) {
  void* args[] = {&mask, &n, &rows_per_block, &sums, &perm, &count};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(compact_mask_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream)));
}
