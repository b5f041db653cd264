// Edge x edge orientation sweep of exact refinement, for Hopper (sm_90a).
//
// Replaces the TPU kernel edges_intersect_pallas
// (src/repro/kernels/refine/refine.py). That one tiles each batch as
// [8, Ea, 128] slabs of x/y planes and OR-accumulates over a sequential
// grid axis across Eb blocks.
//
// Here one block owns one pair row; its threads stride over the Ea x Eb
// edge couples and the block ORs the two lanes with __syncthreads_or. Any
// Ea and Eb work (rings of hundreds of vertices included), and nothing
// carries between blocks. Endpoints arrive as the caller's [B, E, 2]
// float32 (x, y) pairs, read as float2, so the wrapper needs no plane
// split.
//
// Arithmetic is the TPU kernel's, operation for operation: d1..d4,
// proper, scale, mag, tol = eps * scale * (scale + mag), near0 and the
// band-inflated boxes, all in float32. Every product and sum is an
// explicitly rounded intrinsic and the unit builds with -fmad=false, so no
// multiply-add is contracted and the lanes equal the plain eager PyTorch
// version bit for bit. The guard band and the host float64 re-check of
// the uncertain rows stay as they are.
//
// What bounds it on the H100: float32 issue rate. Each couple costs about
// 42 adds, subtracts and multiplies plus about 40 compares, abs, min and
// max on 8 floats and 2 mask bytes, all of which stay in L1 after the
// first touch of a row, so bytes from device memory are (Ea + Eb) * 17 per
// row. The design keeps every thread on independent couples (no shared
// state until the one block-wide OR at the end) and keeps the couple index
// in 32 bits, which is enough to keep the FP32 pipes busy; a later version
// can stage the row in shared memory and skip couples once both lanes are
// set.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float orient(float px, float py, float qx, float qy,
                                        float rx, float ry) {
  return __fsub_rn(__fmul_rn(__fsub_rn(qx, px), __fsub_rn(ry, py)),
                   __fmul_rn(__fsub_rn(qy, py), __fsub_rn(rx, px)));
}

__global__ void edges_intersect_kernel(
    const float2* __restrict__ a0, const float2* __restrict__ a1,
    const uint8_t* __restrict__ am, int32_t ea,
    const float2* __restrict__ b0, const float2* __restrict__ b1,
    const uint8_t* __restrict__ bm, int32_t eb, float eps,
    uint8_t* __restrict__ hit, uint8_t* __restrict__ unc) {
  const int64_t row = blockIdx.x;
  a0 += row * ea;
  a1 += row * ea;
  am += row * ea;
  b0 += row * eb;
  b1 += row * eb;
  bm += row * eb;
  const int32_t total = ea * eb;          // the wrapper keeps it < 2^31
  bool h = false;
  bool u = false;
  for (int32_t k = threadIdx.x; k < total; k += blockDim.x) {
    const int32_t i = k / eb;
    const int32_t j = k - i * eb;
    if (!am[i] || !bm[j]) continue;
    const float2 A0 = a0[i], A1 = a1[i], B0 = b0[j], B1 = b1[j];

    const float d1 = orient(B0.x, B0.y, B1.x, B1.y, A0.x, A0.y);
    const float d2 = orient(B0.x, B0.y, B1.x, B1.y, A1.x, A1.y);
    const float d3 = orient(A0.x, A0.y, A1.x, A1.y, B0.x, B0.y);
    const float d4 = orient(A0.x, A0.y, A1.x, A1.y, B1.x, B1.y);
    const bool proper = ((d1 > 0.f) != (d2 > 0.f)) && ((d3 > 0.f) != (d4 > 0.f));

    const float scale = __fadd_rn(
        __fadd_rn(__fadd_rn(fabsf(__fsub_rn(A1.x, A0.x)),
                            fabsf(__fsub_rn(A1.y, A0.y))),
                  fabsf(__fsub_rn(B1.x, B0.x))),
        fabsf(__fsub_rn(B1.y, B0.y)));
    const float mag = __fadd_rn(fmaxf(fabsf(A0.x), fabsf(A0.y)),
                                fmaxf(fabsf(B0.x), fabsf(B0.y)));
    const float tol = __fmul_rn(__fmul_rn(eps, scale), __fadd_rn(scale, mag));
    const bool near0 = fabsf(d1) <= tol || fabsf(d2) <= tol ||
                       fabsf(d3) <= tol || fabsf(d4) <= tol;
    const bool boxes =
        fminf(A0.x, A1.x) <= __fadd_rn(fmaxf(B0.x, B1.x), tol) &&
        fminf(B0.x, B1.x) <= __fadd_rn(fmaxf(A0.x, A1.x), tol) &&
        fminf(A0.y, A1.y) <= __fadd_rn(fmaxf(B0.y, B1.y), tol) &&
        fminf(B0.y, B1.y) <= __fadd_rn(fmaxf(A0.y, A1.y), tol);
    h = h || (proper && !near0);
    u = u || (near0 && boxes);
  }
  const int any_h = __syncthreads_or(h);
  const int any_u = __syncthreads_or(u);
  if (threadIdx.x == 0) {
    hit[row] = any_h ? 1 : 0;
    unc[row] = any_u ? 1 : 0;
  }
}

}  // namespace

extern "C" int edges_intersect_launch(
    const float* a0, const float* a1, const uint8_t* am, int32_t ea,
    const float* b0, const float* b1, const uint8_t* bm, int32_t eb,
    float eps, int64_t b, uint8_t* hit, uint8_t* unc, void* stream) {
  if (b > 0) {
    edges_intersect_kernel<<<static_cast<unsigned int>(b), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float2*>(a0), reinterpret_cast<const float2*>(a1),
        am, ea, reinterpret_cast<const float2*>(b0),
        reinterpret_cast<const float2*>(b1), bm, eb, eps, hit, unc);
  }
  return static_cast<int>(cudaGetLastError());
}
