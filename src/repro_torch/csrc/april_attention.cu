// APRIL block-sparse flash attention in f32, on the CUDA cores (sm_90a).
//
// Replaces the TPU kernel april_attention_pallas
// (src/repro/kernels/april_attention/april_attention.py:102) for f32
// inputs; bf16 inputs run on the tensor cores in csrc/april_attention_tc.cu.
// The CUDA cores are the only place the f32 products run in full f32: the
// tensor cores' TF32 keeps about three decimal digits and would break the
// f32 contract of 2e-5. The mask's (q block x kv block) raster is
// classified as APRIL classifies raster cells: per q block one A-interval
// [a_lo, a_hi) of kv blocks to visit and one F-interval [f_lo, f_hi) of
// Full blocks that need no mask; the blocks of A outside F are Partial and
// get the causal or local(window) mask. The TPU kernel walks the whole
// (BH, nq, nk) grid in order, skips blocks with pl.when and keeps the
// online-softmax state in VMEM scratch across the kv axis.
//
// Here one block of 16 warps owns one (bh, q block). It reads its own
// interval row and loops ki over [a_lo, a_hi) only, so Empty blocks are
// never loaded. The q block is staged once in shared memory; each kv
// block is staged in chunks of 32 rows of K and V, which inherit the
// block's Full/Partial class, so one chunk serves every q row of the block
// and D up to 256 fits (at D = 256, q block 128: 213,504 bytes of dynamic
// shared memory). A warp owns q block / 16 rows. For the scores lane j
// takes key j of the chunk and runs the dot product over D against each of
// the warp's rows (float4 reads; the K rows are padded by 4 floats so the
// lanes' reads fall on distinct banks); then per row: scale, softcap
// (softcap * tanhf(s / softcap)), the mask on Partial blocks only, and the
// online softmax with the finite NEG_INF = -1e30, whose first fully masked
// chunk carries exp(0) until a later one rescales it away with
// alpha = exp(-1e30 - m) = 0 (with -inf that step gives NaN). For PV the
// accumulator of a row is spread across the warp's lanes (D / 32 values a
// lane), and the chunk's p values are broadcast from shared memory. The
// last step divides by l, read as 1 where l == 0. Row m and l live one row
// per lane and travel by shuffle, to keep the accumulator's registers
// free.
//
// What bounds it on the H100: operations, 4 D an allowed (q, k) position,
// here at the CUDA cores' f32 rate of 67 TFLOP/s; the score loop also
// waits on shared memory (a float4 of K per lane and a broadcast float4 of
// q per row for every four multiply-adds). Every product and sum is f32
// without TF32, expf and tanhf without fast math.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;            // kv rows staged at a time, one a lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// The butterfly leaves the same sum in every lane (a + b == b + a).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int DT, int ROWS>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kWarps * ROWS) * (32 * DT)   // q block
          + kChunk * (32 * DT + 4)                          // K chunk
          + kChunk * (32 * DT)                              // V chunk
          + kWarps * kChunk * ROWS);                        // p, per warp
}

// One block per (bh, q block): blockIdx.x = bh * nq + qi. D = 32 DT, q block
// = 16 ROWS rows (ROWS a multiple of 4).
template <int DT, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
april_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int32_t* __restrict__ iv,
                       float* __restrict__ out, int nq, int64_t Sq,
                       int64_t Skv, int block_kv, float scale,
                       bool has_softcap, float softcap, int mask_kind,
                       int window) {
  constexpr int D = 32 * DT;
  constexpr int BQ = kWarps * ROWS;
  constexpr int KS = D + 4;             // K row stride in shared memory
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // [BQ][D]
  float* ks = qs + BQ * D;                          // [kChunk][KS]
  float* vs = ks + kChunk * KS;                     // [kChunk][D]
  float* ps = vs + kChunk * D;                      // [kWarps][kChunk][ROWS]

  const int64_t bh = blockIdx.x / nq;
  const int qi = blockIdx.x % nq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t nk = Skv / block_kv;
  // the A-interval clipped to the kv blocks that exist, as the TPU grid is
  const int64_t a_lo = iv[4 * qi] > 0 ? iv[4 * qi] : 0;
  const int64_t f_lo = iv[4 * qi + 1];
  const int64_t f_hi = iv[4 * qi + 2];
  const int64_t a_hi = iv[4 * qi + 3] < nk ? iv[4 * qi + 3] : nk;

  const float* kb = k + bh * Skv * D;
  const float* vb = v + bh * Skv * D;
  {
    const float* qb = q + (bh * Sq + static_cast<int64_t>(qi) * BQ) * D;
    for (int i = threadIdx.x; i < BQ * D / 4; i += kThreads)
      reinterpret_cast<float4*>(qs)[i] = load4(qb + 4 * i);
  }

  const int row0 = warp * ROWS;                     // first row of the warp
  const int64_t qpos0 = static_cast<int64_t>(qi) * BQ + row0;
  float acc[ROWS][DT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[r][t] = 0.f;
  // lane r < ROWS holds row r's running max and sum
  float m_lane = kNegInf;
  float l_lane = 0.f;
  float* pw = ps + warp * kChunk * ROWS;

  for (int64_t ki = a_lo; ki < a_hi; ++ki) {
    const bool partial = ki < f_lo || ki >= f_hi;
    for (int c0 = 0; c0 < block_kv; c0 += kChunk) {
      const int64_t key0 = ki * block_kv + c0;
      __syncthreads();                  // every warp is done with the chunk
      for (int i = threadIdx.x; i < kChunk * D / 4; i += kThreads) {
        const int j = i / (D / 4);
        const int d = 4 * (i % (D / 4));
        *reinterpret_cast<float4*>(ks + j * KS + d) =
            load4(kb + (key0 + j) * D + d);
        *reinterpret_cast<float4*>(vs + j * D + d) =
            load4(vb + (key0 + j) * D + d);
      }
      __syncthreads();

      // scores of key key0 + lane against the warp's rows
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
      const float* kr = ks + lane * KS;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 qq =
              *reinterpret_cast<const float4*>(qs + (row0 + r) * D + d);
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
        }
      }

      const int64_t kpos = key0 + lane;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float x = s[r] * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        if (partial) {
          const int64_t qpos = qpos0 + r;
          const bool allowed =
              mask_kind == 0 ? kpos <= qpos
              : mask_kind == 1 ? (kpos <= qpos && kpos > qpos - window)
                               : true;
          if (!allowed) x = kNegInf;
        }
        const float m_prev = __shfl_sync(kFull, m_lane, r);
        const float m_new = fmaxf(m_prev, warp_max(x));
        const float alpha = expf(m_prev - m_new);
        const float p = expf(x - m_new);
        const float l_new =
            __shfl_sync(kFull, l_lane, r) * alpha + warp_sum(p);
        if (lane == r) {
          m_lane = m_new;
          l_lane = l_new;
        }
#pragma unroll
        for (int t = 0; t < DT; ++t) acc[r][t] *= alpha;
        s[r] = p;
      }
#pragma unroll
      for (int r = 0; r < ROWS; r += 4)
        *reinterpret_cast<float4*>(pw + lane * ROWS + r) =
            make_float4(s[r], s[r + 1], s[r + 2], s[r + 3]);
      __syncwarp();

      // acc[r][:] += p[r][j] * v[j][:], the lane's D / 32 columns
#pragma unroll 4
      for (int j = 0; j < kChunk; ++j) {
        float vv[DT];
#pragma unroll
        for (int t = 0; t < DT; ++t) vv[t] = vs[j * D + lane + 32 * t];
#pragma unroll
        for (int r = 0; r < ROWS; r += 4) {
          const float4 pp = *reinterpret_cast<const float4*>(pw + j * ROWS + r);
#pragma unroll
          for (int t = 0; t < DT; ++t) {
            acc[r][t] = fmaf(pp.x, vv[t], acc[r][t]);
            acc[r + 1][t] = fmaf(pp.y, vv[t], acc[r + 1][t]);
            acc[r + 2][t] = fmaf(pp.z, vv[t], acc[r + 2][t]);
            acc[r + 3][t] = fmaf(pp.w, vv[t], acc[r + 3][t]);
          }
        }
      }
    }
  }

  float* ob = out + (bh * Sq + qpos0) * D;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float l = __shfl_sync(kFull, l_lane, r);
    const float denom = l == 0.f ? 1.f : l;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      ob[r * D + lane + 32 * t] = acc[r][t] / denom;
  }
}

template <int DT, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* iv, void* out, int64_t BH, int64_t Sq,
                   int64_t Skv, int block_kv, float scale, bool has_softcap,
                   float softcap, int mask_kind, int window,
                   cudaStream_t stream) {
  constexpr int BQ = kWarps * ROWS;
  constexpr size_t smem = smem_bytes<DT, ROWS>();
  auto kernel = april_attention_kernel<DT, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t nq = Sq / BQ;
  const int64_t blocks = BH * nq;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), iv, static_cast<float*>(out),
      static_cast<int>(nq), Sq, Skv, block_kv, scale, has_softcap, softcap,
      mask_kind, window);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_d(int64_t D, const void* q, const void* k, const void* v,
                     const int32_t* iv, void* out, int64_t BH, int64_t Sq,
                     int64_t Skv, int block_kv, float scale, bool has_softcap,
                     float softcap, int mask_kind, int window,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<1, ROWS>(q, k, v, iv, out, BH, Sq, Skv, block_kv, scale,
                             has_softcap, softcap, mask_kind, window, stream);
    case 64:
      return launch<2, ROWS>(q, k, v, iv, out, BH, Sq, Skv, block_kv, scale,
                             has_softcap, softcap, mask_kind, window, stream);
    case 128:
      return launch<4, ROWS>(q, k, v, iv, out, BH, Sq, Skv, block_kv, scale,
                             has_softcap, softcap, mask_kind, window, stream);
    case 256:
      return launch<8, ROWS>(q, k, v, iv, out, BH, Sq, Skv, block_kv, scale,
                             has_softcap, softcap, mask_kind, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [BH, Sq, D], k/v [BH, Skv, D] float32, iv [Sq / block_q, 4] int32
// (a_lo, f_lo, f_hi, a_hi), out like q. mask_kind 0: causal, 1:
// local(window), 2: full. Returns the launch's cudaError_t; a shape the
// kernel is not built for returns cudaErrorInvalidValue.
extern "C" int april_attention_launch(
    const void* q, const void* k, const void* v, const int32_t* iv, void* out,
    int64_t BH, int64_t Sq, int64_t Skv, int64_t D, int block_q, int block_kv,
    float scale, int has_softcap, float softcap, int mask_kind, int window,
    void* stream) {
  if (block_q <= 0 || block_kv <= 0 || block_kv % kChunk != 0 ||
      Sq % block_q != 0 || Skv % block_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (block_q == 64)
    err = launch_d<4>(D, q, k, v, iv, out, BH, Sq, Skv, block_kv, scale,
                      has_softcap != 0, softcap, mask_kind, window, st);
  else if (block_q == 128)
    err = launch_d<8>(D, q, k, v, iv, out, BH, Sq, Skv, block_kv, scale,
                      has_softcap != 0, softcap, mask_kind, window, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
