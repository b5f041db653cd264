// Stable front-pack of a device bool lane, for Hopper (sm_90a).
//
// Replaces the TPU kernel exclusive_scan_pallas
// (src/repro/kernels/compact/compact.py) together with the scatter of its
// wrapper compact_mask (src/repro/kernels/compact/ops.py). The TPU kernel
// walks [8, 128] row blocks in grid order and threads the running count
// through an SMEM cell from one block to the next; that carry relies on a
// sequential grid, and its VMEM tile capped one launch at 2^21 rows.
//
// CUDA blocks run in no fixed order, so the scan here is three launches on
// the caller's stream, with no host read in between:
//   1. tile_counts: each block counts the set bits of its 1024-row tile
//      (__ballot_sync + __popc per warp);
//   2. scan_sums: one block turns the per-tile counts into exclusive tile
//      offsets in place and writes the total, ``count``, to device memory;
//   3. scatter: each block rebuilds the exclusive position of every row of
//      its tile from its tile offset, the warp counts and the ballot, and
//      writes perm[dest] = i with dest = excl for a set row and
//      count + i - excl for a clear one. dest is a permutation of [0, n),
//      so the scatter has no collisions.
// Any length below 2^31 scans this way (the wrapper raises above it).
//
// What bounds it on the H100: the function moves about 5 bytes a row (a
// bool read, an int32 written), 3.7 MB at the join's 742,279 rows, which
// is about 1 us at 3.35 TB/s. At that size the three launches and the
// single-block middle pass cost more than the bytes, so it is launch-bound;
// a single-pass decoupled look-back scan is the later fix.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                    // sub-tiles of kThreads rows
constexpr int kTile = kThreads * kItems;     // rows per block
constexpr int kScanThreads = 1024;           // 32 warps
constexpr unsigned kFull = 0xffffffffu;

__global__ void tile_counts_kernel(const uint8_t* __restrict__ mask, int64_t n,
                                   int32_t* __restrict__ sums) {
  __shared__ int32_t warp_sums[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t c = 0;
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    const bool set = i < n && mask[i] != 0;
    c += __popc(__ballot_sync(kFull, set));   // the same in every lane
  }
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    sums[blockIdx.x] = s;
  }
}

// Inclusive scan of x across the 32 lanes of a warp.
__device__ __forceinline__ int32_t warp_inclusive(int32_t x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void scan_sums_kernel(int32_t* __restrict__ sums, int64_t nb,
                                 int32_t* __restrict__ count) {
  __shared__ int32_t warp_tot[32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t b0 = 0; b0 < nb; b0 += kScanThreads) {
    const int64_t b = b0 + threadIdx.x;
    const int32_t v = b < nb ? sums[b] : 0;
    const int32_t x = warp_inclusive(v, lane);
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) warp_tot[lane] = warp_inclusive(warp_tot[lane], lane);
    __syncthreads();
    const int32_t before = carry + (warp > 0 ? warp_tot[warp - 1] : 0);
    if (b < nb) sums[b] = before + x - v;      // exclusive tile offset
    __syncthreads();                            // every thread has read carry
    if (threadIdx.x == kScanThreads - 1) carry = before + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = carry;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ mask, int64_t n,
                               const int32_t* __restrict__ offs,
                               const int32_t* __restrict__ count,
                               int32_t* __restrict__ perm) {
  __shared__ int32_t warp_cnt[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int32_t k = *count;
  int32_t run = offs[blockIdx.x];   // set rows before the current sub-tile
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = base + it * kThreads + threadIdx.x;
    const bool set = i < n && mask[i] != 0;
    const unsigned bal = __ballot_sync(kFull, set);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int32_t before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = warp_cnt[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (i < n) {
      const int32_t row = static_cast<int32_t>(i);
      const int32_t excl = run + before + __popc(bal & below);
      perm[set ? excl : k + (row - excl)] = row;
    }
    run += total;
    __syncthreads();                 // warp_cnt is rewritten next sub-tile
  }
}

}  // namespace

// Number of tiles (and of int32 scratch slots) for a lane of n rows.
extern "C" int64_t compact_mask_blocks(int64_t n) {
  return (n + kTile - 1) / kTile;
}

extern "C" int compact_mask_launch(const uint8_t* mask, int64_t n,
                                   int32_t* block_sums, int32_t* perm,
                                   int32_t* count, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nb = compact_mask_blocks(n);
  const unsigned grid = static_cast<unsigned>(nb);
  tile_counts_kernel<<<grid, kThreads, 0, s>>>(mask, n, block_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_sums_kernel<<<1, kScanThreads, 0, s>>>(block_sums, nb, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<grid, kThreads, 0, s>>>(mask, n, block_sums, count, perm);
  return static_cast<int>(cudaGetLastError());
}
