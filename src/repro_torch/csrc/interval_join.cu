// Interval-list joins of the APRIL intermediate filter, for Hopper (sm_90a).
//
// Replaces the TPU kernels april_trichotomy_pallas and
// interval_overlap_pallas (src/repro/kernels/interval_join/interval_join.py).
// Those evaluate the overlap predicate of every (i, j) interval pair of a
// padded [8, I, J] tile in VMEM, which caps the list width and needs the
// lists packed and padded on the host.
//
// Here one thread owns one candidate pair row and runs the paper's linear
// two-pointer merge (Algorithm 2) straight on the device-resident CSR
// arrays, addressed by the rows' offsets: no host packing, no padding, no
// width cap. Endpoints are biased int32 with inclusive lasts, so every
// comparison is a signed 32-bit compare.
//
// What bounds it on the H100: memory latency, not bandwidth or arithmetic.
// Each row reads at most (nx + ny) intervals per join from lists scattered
// through a ~10 MB store, so the bytes the function must move are tiny
// (the store fits in the 50 MB L2) and the merge does a few integer
// compares per interval. The time goes to dependent loads along each
// thread's merge and to divergence between rows of different widths in a
// warp. The design keeps the store read-only and L2-resident and launches
// enough rows (hundreds of thousands) to hide the latency; a later version
// can sort rows by width or merge cooperatively within a warp.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Any overlap between the sorted disjoint inclusive-last lists X and Y.
__device__ __forceinline__ bool any_overlap(
    const int32_t* __restrict__ xs, const int32_t* __restrict__ xl, int64_t nx,
    const int32_t* __restrict__ ys, const int32_t* __restrict__ yl, int64_t ny) {
  int64_t i = 0, j = 0;
  while (i < nx && j < ny) {
    const int32_t a_last = xl[i];
    const int32_t b_last = yl[j];
    if (ys[j] <= a_last && xs[i] <= b_last) return true;
    if (a_last <= b_last) {
      ++i;
    } else {
      ++j;
    }
  }
  return false;
}

struct Lists {
  const int64_t* off;
  const int32_t* starts;
  const int32_t* lasts;
};

__device__ __forceinline__ bool join_rows(const Lists& x, int64_t r,
                                          const Lists& y, int64_t s) {
  const int64_t x0 = x.off[r], nx = x.off[r + 1] - x0;
  const int64_t y0 = y.off[s], ny = y.off[s + 1] - y0;
  return any_overlap(x.starts + x0, x.lasts + x0, nx,
                     y.starts + y0, y.lasts + y0, ny);
}

__global__ void april_trichotomy_kernel(Lists xa, Lists xf, Lists ya, Lists yf,
                                        const int64_t* __restrict__ ri,
                                        const int64_t* __restrict__ si,
                                        int64_t n, int8_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t r = ri[row];
  const int64_t s = si[row];
  int8_t verdict = 0;                                   // TRUE_NEG
  if (join_rows(xa, r, ya, s)) {
    verdict = (join_rows(xa, r, yf, s) || join_rows(xf, r, ya, s))
                  ? 1                                   // TRUE_HIT
                  : 2;                                  // INDECISIVE
  }
  out[row] = verdict;
}

__global__ void interval_overlap_kernel(Lists x, Lists y,
                                        const int64_t* __restrict__ xi,
                                        const int64_t* __restrict__ yi,
                                        int64_t n, uint8_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  out[row] = join_rows(x, xi[row], y, yi[row]) ? 1 : 0;
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int april_trichotomy_launch(
    const int64_t* xa_off, const int32_t* xa_s, const int32_t* xa_l,
    const int64_t* xf_off, const int32_t* xf_s, const int32_t* xf_l,
    const int64_t* ya_off, const int32_t* ya_s, const int32_t* ya_l,
    const int64_t* yf_off, const int32_t* yf_s, const int32_t* yf_l,
    const int64_t* ri, const int64_t* si, int64_t n, int8_t* out,
    void* stream) {
  if (n > 0) {
    april_trichotomy_kernel<<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        Lists{xa_off, xa_s, xa_l}, Lists{xf_off, xf_s, xf_l},
        Lists{ya_off, ya_s, ya_l}, Lists{yf_off, yf_s, yf_l}, ri, si, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int interval_overlap_launch(
    const int64_t* x_off, const int32_t* x_s, const int32_t* x_l,
    const int64_t* y_off, const int32_t* y_s, const int32_t* y_l,
    const int64_t* xi, const int64_t* yi, int64_t n, uint8_t* out,
    void* stream) {
  if (n > 0) {
    interval_overlap_kernel<<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        Lists{x_off, x_s, x_l}, Lists{y_off, y_s, y_l}, xi, yi, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
