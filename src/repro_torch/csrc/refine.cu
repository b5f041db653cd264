// Edge x edge orientation sweep of exact refinement, for Hopper (sm_90a).
//
// Replaces the TPU kernel edges_intersect_pallas
// (src/repro/kernels/refine/refine.py:85). That one tiles each batch as
// [8, Ea, 128] slabs of x/y planes of padded, masked edges and
// OR-accumulates over a sequential grid axis across Eb blocks; the host
// calls it once per vertex-count bucket.
//
// Here one launch takes every row of a refine call, and a row brings only
// the edges its masks keep, as ragged CSR: row n's a edges are
// a0/a1[a_off[n], a_off[n + 1]), its b edges b0/b1[b_off[n], b_off[n +
// 1]), float32 (x, y) pairs read as float2. There is no padding and no mask
// byte, so no couple is walked only to be skipped. A block of four warps
// takes four rows: a warp sweeps a small row (up to kWarpCouples couples)
// on its own, then the whole block sweeps each large one, so tens of
// thousands of short rows fill the card and a long row does not hold one
// warp for long. A row's edges are staged in shared memory where they fit,
// as float4 (p0.x, p0.y, p1.x, p1.y); couple k of a row is (a edge k / nb,
// b edge k % nb), and the lanes stride over k. A row stops once both of its
// lanes are set (a warp vote, or a block-wide OR per step of the block).
// A row with no kept edge on either side gives False/False.
//
// Arithmetic is the TPU kernel's, operation for operation: d1..d4,
// proper, scale, mag, tol = eps * scale * (scale + mag), near0 and the
// band-inflated boxes, all in float32. Every product and sum is an
// explicitly rounded intrinsic and the unit builds with -fmad=false, so no
// multiply-add is contracted and the lanes equal the plain eager PyTorch
// version bit for bit. The guard band and the host float64 re-check of
// the uncertain rows stay as they are.
//
// What bounds it on the H100: bytes, 16 per kept edge, 16 per row of
// offsets and 2 per row of lanes, against about 77 float32 operations per
// couple; the couples a row needs before it stops are few, so both bounds
// are microseconds and the launch and the row loads set the time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStage = 128;              // edges of a side a warp stages
constexpr int64_t kWarpCouples = 4096;   // larger rows take the block

__device__ __forceinline__ float orient(float px, float py, float qx, float qy,
                                        float rx, float ry) {
  return __fsub_rn(__fmul_rn(__fsub_rn(qx, px), __fsub_rn(ry, py)),
                   __fmul_rn(__fsub_rn(qy, py), __fsub_rn(rx, px)));
}

// The two lanes of one couple: a edge (A.x, A.y) -> (A.z, A.w), b edge
// likewise.
__device__ __forceinline__ void couple(float4 A, float4 B, float eps,
                                       bool& h, bool& u) {
  const float d1 = orient(B.x, B.y, B.z, B.w, A.x, A.y);
  const float d2 = orient(B.x, B.y, B.z, B.w, A.z, A.w);
  const float d3 = orient(A.x, A.y, A.z, A.w, B.x, B.y);
  const float d4 = orient(A.x, A.y, A.z, A.w, B.z, B.w);
  const bool proper = ((d1 > 0.f) != (d2 > 0.f)) && ((d3 > 0.f) != (d4 > 0.f));

  const float scale = __fadd_rn(
      __fadd_rn(__fadd_rn(fabsf(__fsub_rn(A.z, A.x)),
                          fabsf(__fsub_rn(A.w, A.y))),
                fabsf(__fsub_rn(B.z, B.x))),
      fabsf(__fsub_rn(B.w, B.y)));
  const float mag = __fadd_rn(fmaxf(fabsf(A.x), fabsf(A.y)),
                              fmaxf(fabsf(B.x), fabsf(B.y)));
  const float tol = __fmul_rn(__fmul_rn(eps, scale), __fadd_rn(scale, mag));
  const bool near0 = fabsf(d1) <= tol || fabsf(d2) <= tol ||
                     fabsf(d3) <= tol || fabsf(d4) <= tol;
  const bool boxes =
      fminf(A.x, A.z) <= __fadd_rn(fmaxf(B.x, B.z), tol) &&
      fminf(B.x, B.z) <= __fadd_rn(fmaxf(A.x, A.z), tol) &&
      fminf(A.y, A.w) <= __fadd_rn(fmaxf(B.y, B.w), tol) &&
      fminf(B.y, B.w) <= __fadd_rn(fmaxf(A.y, A.w), tol);
  h = h || (proper && !near0);
  u = u || (near0 && boxes);
}

// The a edge of couple k < total of a row with nb b edges: k / nb, in 32
// bits where the row's couples fit them.
__device__ __forceinline__ int64_t split(int64_t k, int64_t nb,
                                         int64_t total) {
  if (total <= 0xffffffffll)
    return static_cast<uint32_t>(k) / static_cast<uint32_t>(nb);
  return k / nb;
}

// A row's edges of one side: staged in shared memory, or read from the
// global arrays.
struct Side {
  const float4* staged;                  // null: read p0/p1
  const float2* __restrict__ p0;
  const float2* __restrict__ p1;
  __device__ __forceinline__ float4 operator[](int64_t i) const {
    if (staged) return staged[i];
    const float2 s = p0[i], e = p1[i];
    return make_float4(s.x, s.y, e.x, e.y);
  }
};

// Thread t of nt stages its share of the n edges of p0/p1 into dst when
// they fit its cap; returns the side to read.
__device__ __forceinline__ Side stage(float4* dst, int cap,
                                      const float2* p0, const float2* p1,
                                      int64_t n, int t, int nt) {
  if (n > cap) return Side{nullptr, p0, p1};
  for (int64_t i = t; i < n; i += nt) {
    const float2 s = p0[i], e = p1[i];
    dst[i] = make_float4(s.x, s.y, e.x, e.y);
  }
  return Side{dst, p0, p1};
}

__global__ void __launch_bounds__(kThreads)
edges_intersect_kernel(const float2* __restrict__ a0,
                       const float2* __restrict__ a1,
                       const int64_t* __restrict__ a_off,
                       const float2* __restrict__ b0,
                       const float2* __restrict__ b1,
                       const int64_t* __restrict__ b_off, float eps,
                       int64_t n_rows, uint8_t* __restrict__ hit,
                       uint8_t* __restrict__ unc) {
  __shared__ float4 smem[kWarps][2][kStage];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kWarps;

  // a warp a small row
  const int64_t row = row0 + warp;
  if (row < n_rows) {
    const int64_t ai = a_off[row], na = a_off[row + 1] - ai;
    const int64_t bi = b_off[row], nb = b_off[row + 1] - bi;
    const int64_t total = na * nb;
    if (total <= kWarpCouples) {
      const Side A = stage(smem[warp][0], kStage, a0 + ai, a1 + ai, na, lane,
                           32);
      const Side B = stage(smem[warp][1], kStage, b0 + bi, b1 + bi, nb, lane,
                           32);
      __syncwarp();
      bool h = false, u = false;
      for (int64_t base = 0; base < total; base += 32) {
        const int64_t k = base + lane;
        if (k < total) {
          const int64_t i = split(k, nb, total);
          couple(A[i], B[k - i * nb], eps, h, u);
        }
        if (__any_sync(kFull, h) && __any_sync(kFull, u)) break;
      }
      h = __any_sync(kFull, h);
      u = __any_sync(kFull, u);
      if (lane == 0) {
        hit[row] = h;
        unc[row] = u;
      }
    }
  }

  // the block each large row
  float4* const flat = &smem[0][0][0];
  constexpr int kCap = kWarps * kStage;
  for (int w = 0; w < kWarps; ++w) {
    const int64_t r = row0 + w;
    if (r >= n_rows) break;
    const int64_t ai = a_off[r], na = a_off[r + 1] - ai;
    const int64_t bi = b_off[r], nb = b_off[r + 1] - bi;
    const int64_t total = na * nb;
    if (total <= kWarpCouples) continue;
    __syncthreads();                     // the shared stage is free
    const Side A = stage(flat, kCap, a0 + ai, a1 + ai, na, threadIdx.x,
                         kThreads);
    const Side B = stage(flat + kCap, kCap, b0 + bi, b1 + bi, nb,
                         threadIdx.x, kThreads);
    __syncthreads();
    bool h = false, u = false;
    for (int64_t base = 0; base < total; base += kThreads) {
      const int64_t k = base + threadIdx.x;
      if (k < total) {
        const int64_t i = split(k, nb, total);
        couple(A[i], B[k - i * nb], eps, h, u);
      }
      if (__syncthreads_or(h) && __syncthreads_or(u)) break;
    }
    h = __syncthreads_or(h);
    u = __syncthreads_or(u);
    if (threadIdx.x == 0) {
      hit[r] = h;
      unc[r] = u;
    }
  }
}

}  // namespace

// a0/a1 [Ka, 2] and b0/b1 [Kb, 2] float32 edge endpoints, a_off/b_off
// [n_rows + 1] int64 row offsets into them (non-decreasing, from 0 to Ka
// and Kb); hit/unc [n_rows] bool. Returns the launch's cudaError_t.
extern "C" int edges_intersect_launch(const float* a0, const float* a1,
                                      const int64_t* a_off, const float* b0,
                                      const float* b1, const int64_t* b_off,
                                      float eps, int64_t n_rows, uint8_t* hit,
                                      uint8_t* unc, void* stream) {
  const int64_t blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    edges_intersect_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float2*>(a0),
        reinterpret_cast<const float2*>(a1), a_off,
        reinterpret_cast<const float2*>(b0),
        reinterpret_cast<const float2*>(b1), b_off, eps, n_rows, hit, unc);
  }
  return static_cast<int>(cudaGetLastError());
}
