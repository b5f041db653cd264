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
// What bounds it on the H100: operations, 4 D an allowed (q, k) position
// at the CUDA cores' f32 rate of 67 TFLOP/s. The design is an SGEMM's:
//
// - One CTA per (bh, q block), launched longest q block first. It reads
//   its interval row and walks the keys of [a_lo, a_hi) only, in tiles of
//   64 keys (32 at D 256); a key's class is that of its kv block, so a tile
//   may straddle kv blocks of any size, and only keys of Partial blocks
//   are masked (a tile wholly inside F takes no mask test).
// - Register tiles. A thread owns 4 q rows: it holds their 4 x 8 (4 x 2 at
//   D 256) scores of a tile and their 4 x D/8 (4 x D/16) outputs. The
//   scores are outer products of float4 fragments of Q and K from shared
//   memory (per 4 columns of D: 4 + 8 vector loads for 128 multiply-adds),
//   the PV product too (per key: one float4 of P and D/32 float4 of V for
//   D/2 multiply-adds). The next step's fragments load under the current
//   step's multiply-adds (not at D 256, where 512 threads have 128
//   registers each). Rows are padded by 4 floats and threads are laid out
//   so that no vector load of the loops meets a bank conflict.
// - Row statistics among the 8 (16 at D 256) lanes that share a row: one
//   3-step (4-step) shuffle maximum per row per tile. Each lane sums its
//   own keys' p; the sums meet once, at the end. p and the rescale are
//   2^((x - m) log2(e)) on the special function unit (ex2.approx.ftz):
//   log2(e) multiplies the difference, not the score, so a large logit's
//   rounding does not reach p. A row whose maximum did not move skips the
//   rescale of its outputs.
// - K and V tiles arrive by cp.async, each under the other's product: V of
//   tile t loads under the scores of t, K of tile t + 1 under the PV of t.
//   Q stays in shared memory for the whole walk. Two barriers a tile.
//
// Numerics kept from the reference: scale, then softcap (softcap *
// tanhf(s / softcap)), then the mask on Partial keys, then the online
// softmax with the finite NEG_INF = -1e30, whose first fully masked tile
// carries exp(0) until a later one rescales it away with alpha = 0 (with
// -inf that step gives NaN); l == 0 reads as 1. Every product and sum is
// f32 without TF32; tanhf and the divisions without fast math.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;     // dynamic shared memory a CTA may use

// The CTA's layout for head width D and q block BQ. Thread t owns row
// group g = t / KL, the 4 rows g + (BQ / 4) r, and lane t % KL of it: keys
// lane + KL i of each tile, and the float4 columns 4 lane + 4 KL c of the
// output.
template <int D, int BQ>
struct Geometry {
  static constexpr int kRT = 4;                      // rows a thread
  static constexpr int kKL = D == 256 ? 16 : 8;      // lanes a row group
  static constexpr int kTile = D == 256 ? 32 : 64;   // keys a tile
  static constexpr int kGroups = BQ / kRT;
  static constexpr int kThreads = kGroups * kKL;
  static constexpr int kKT = kTile / kKL;            // keys a thread
  static constexpr int kCT = D / (4 * kKL);          // float4 columns
  static constexpr int kQS = D + 4;                  // Q and K row stride
  static constexpr int kPS = BQ + 4;                 // P row stride
  // steps of the two products' loops unrolled: at D 256 the 512 threads
  // have 128 registers each, and deeper unrolling spills
  static constexpr int kUnrollS = D == 256 ? 1 : 4;
  static constexpr int kUnrollPV = D == 256 ? 1 : 4;
  // the next step's fragments load under this step's multiply-adds, but
  // for the score loop at D 256, where they would not fit the registers
  static constexpr bool kPrefetchS = D != 256;
  static constexpr int kQ = 0;                       // [BQ][kQS]
  static constexpr int kK = kQ + BQ * kQS;           // [kTile][kQS]
  static constexpr int kV = kK + kTile * kQS;        // [kTile][D]
  static constexpr int kP = kV + kTile * D;          // [kTile][kPS]
  static constexpr size_t kSmem = sizeof(float) * (kP + kTile * kPS);
  static_assert(kCT >= 1 && kKT * kKL == kTile, "layout");
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(kThreads <= 1024 && kThreads % 32 == 0, "threads");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // a source size of 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ROWS rows of D floats, row r from src + (row0 + r) D, into shared rows of
// STRIDE floats; rows at or past row_end are filled with zeros. A thread
// copies one 16-byte column of every (THREADS / (D / 4))-th row.
template <int D, int ROWS, int STRIDE, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int row_end, int tid) {
  constexpr int kPerRow = D / 4;
  constexpr int kStep = THREADS / kPerRow;
  static_assert(THREADS % kPerRow == 0 && ROWS % kStep == 0, "chunks");
  const int r0 = tid / kPerRow;
  const int c = 4 * (tid % kPerRow);
  const float* const from = src + static_cast<int64_t>(row0 + r0) * D + c;
  float* const to = dst + r0 * STRIDE + c;
  const int left = row_end - row0 - r0;
#pragma unroll
  for (int n = 0; n < ROWS / kStep; ++n) {
    const bool ok = n * kStep < left;
    cp_async16(to + n * kStep * STRIDE, ok ? from + n * kStep * D : src, ok);
  }
}

// 2^x on the special function unit, flushing results under 2^-126 to 0
// (p that small is below f32's resolution of l, which is at least 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool allowed(int mask_kind, int kpos, int qpos,
                                        int window) {
  return mask_kind == 0   ? kpos <= qpos
         : mask_kind == 1 ? (kpos <= qpos && kpos > qpos - window)
                          : true;
}

// The first key of kv block ``blk``, clipped to [0, Skv].
__device__ __forceinline__ int key_clip(int blk, int block_kv, int Skv) {
  const int64_t key = static_cast<int64_t>(blk) * block_kv;
  return key < 0 ? 0 : key > Skv ? Skv : static_cast<int>(key);
}

// One CTA per (bh, q block), the longest q blocks first: blockIdx.x = (nq
// - 1 - qi) BH + bh.
template <int D, int BQ>
__global__ void __launch_bounds__(Geometry<D, BQ>::kThreads, 1)
april_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int32_t* __restrict__ iv,
                       float* __restrict__ out, int BH, int nq, int Sq,
                       int Skv, int block_kv, float scale,
                       int has_softcap, float softcap, int mask_kind,
                       int window) {
  using G = Geometry<D, BQ>;
  constexpr int KL = G::kKL, RT = G::kRT, KT = G::kKT, CT = G::kCT;
  constexpr int QS = G::kQS, PS = G::kPS, TILE = G::kTile;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const qs = smem + G::kQ;
  float* const ks = smem + G::kK;
  float* const vs = smem + G::kV;
  float* const ps = smem + G::kP;

  const int qi = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int64_t bh = static_cast<int>(blockIdx.x) % BH;
  const int tid = threadIdx.x;
  const int lane = tid % KL;
  const int grp = tid / KL;
  const int nk = Skv / block_kv;
  // the A-interval clipped to the kv blocks that exist, as the TPU grid is;
  // keys of [full_lo, full_hi) lie in Full blocks (clipped to the keys)
  const int a_lo = max(iv[4 * qi], 0);
  const int a_hi = min(iv[4 * qi + 3], nk);
  const int key_lo = a_lo * block_kv;
  const int key_hi = a_hi * block_kv;
  const int full_lo = key_clip(iv[4 * qi + 1], block_kv, Skv);
  const int full_hi = key_clip(iv[4 * qi + 2], block_kv, Skv);
  const int n_tiles = key_hi > key_lo ? (key_hi - key_lo + TILE - 1) / TILE
                                      : 0;

  const float* const kb = k + bh * Skv * D;
  const float* const vb = v + bh * Skv * D;
  const int q0 = qi * BQ;

  float o[RT][CT][4];
  float m[RT], l[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][c][e] = 0.f;
  }

  if (n_tiles > 0) {
    load_rows<D, BQ, QS, G::kThreads>(qs, q + (bh * Sq + q0) * D, 0, BQ,
                                      tid);
    load_rows<D, TILE, QS, G::kThreads>(ks, kb, key_lo, key_hi, tid);
    cp_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = key_lo + t * TILE;
    cp_wait_all();
    __syncthreads();  // K of tile t is in; every PV of tile t - 1 is done
    load_rows<D, TILE, D, G::kThreads>(vs, vb, key0, key_hi, tid);
    cp_commit();

    // scores: s[r][i] = q row (grp + kGroups r) . key (lane + KL i)
    float s[RT][KT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int i = 0; i < KT; ++i) s[r][i] = 0.f;
    // the next step's fragments load under this step's multiply-adds
    const float* const qrow = qs + grp * QS;
    const float* const krow = ks + lane * QS;
    float4 qf[RT], kf[KT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      qf[r] = *reinterpret_cast<const float4*>(qrow + r * G::kGroups * QS);
#pragma unroll
    for (int i = 0; i < KT; ++i)
      kf[i] = *reinterpret_cast<const float4*>(krow + i * KL * QS);
#pragma unroll(G::kUnrollS)
    for (int d = 0; d < D; d += 4) {
      if constexpr (!G::kPrefetchS) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
          qf[r] = *reinterpret_cast<const float4*>(qrow +
                                                   r * G::kGroups * QS + d);
#pragma unroll
        for (int i = 0; i < KT; ++i)
          kf[i] = *reinterpret_cast<const float4*>(krow + i * KL * QS + d);
      }
      const int dn = G::kPrefetchS && d + 4 < D ? d + 4 : d;
      float4 qn[RT], kn[KT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        qn[r] = G::kPrefetchS ? *reinterpret_cast<const float4*>(
                                    qrow + r * G::kGroups * QS + dn)
                              : qf[r];
#pragma unroll
      for (int i = 0; i < KT; ++i)
        kn[i] = G::kPrefetchS
                    ? *reinterpret_cast<const float4*>(krow + i * KL * QS + dn)
                    : kf[i];
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          s[r][i] = fmaf(qf[r].x, kf[i].x, s[r][i]);
          s[r][i] = fmaf(qf[r].y, kf[i].y, s[r][i]);
          s[r][i] = fmaf(qf[r].z, kf[i].z, s[r][i]);
          s[r][i] = fmaf(qf[r].w, kf[i].w, s[r][i]);
        }
#pragma unroll
      for (int r = 0; r < RT; ++r) qf[r] = qn[r];
#pragma unroll
      for (int i = 0; i < KT; ++i) kf[i] = kn[i];
    }

    // scale, softcap, mask, online softmax; p into shared memory
    const bool unmasked =
        key0 >= full_lo && key0 + TILE <= full_hi && key0 + TILE <= key_hi;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int qpos = q0 + grp + r * G::kGroups;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        float x = s[r][i] * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        if (!unmasked) {
          const int key = key0 + lane + i * KL;
          if (key >= key_hi)
            x = -INFINITY;  // past the A-interval: no key at all
          else if ((key < full_lo || key >= full_hi) &&
                   !allowed(mask_kind, key, qpos, window))
            x = kNegInf;
        }
        s[r][i] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = KL / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const float p = exp2_ftz((s[r][i] - m_new) * kLog2e);
        s[r][i] = p;
        sum += p;
      }
      if (m_new != m[r]) {  // else alpha is 1
        const float alpha = exp2_ftz((m[r] - m_new) * kLog2e);
        l[r] *= alpha;
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[r][c][e] *= alpha;
        m[r] = m_new;
      }
      l[r] += sum;
    }
    // P transposed, the thread's 4 rows side by side: ps[key][4 grp + r]
#pragma unroll
    for (int i = 0; i < KT; ++i)
      *reinterpret_cast<float4*>(ps + (lane + i * KL) * PS + RT * grp) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);

    cp_wait_all();
    __syncthreads();  // P and V of tile t are in; every score read of K done
    if (t + 1 < n_tiles) {
      load_rows<D, TILE, QS, G::kThreads>(ks, kb, key0 + TILE, key_hi, tid);
      cp_commit();
    }

    // o[r][c] += p[r][j] v[j][c]; key j + 1's fragments load under key j's
    const float* const prow = ps + RT * grp;
    const float* const vcol = vs + 4 * lane;
    float4 pf = *reinterpret_cast<const float4*>(prow);
    float4 vf[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c)
      vf[c] = *reinterpret_cast<const float4*>(vcol + c * 4 * KL);
#pragma unroll(G::kUnrollPV)
    for (int j = 0; j < TILE; ++j) {
      const int jn = j + 1 < TILE ? j + 1 : j;
      const float4 pn = *reinterpret_cast<const float4*>(prow + jn * PS);
      float4 vn[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c)
        vn[c] = *reinterpret_cast<const float4*>(vcol + jn * D + c * 4 * KL);
      const float pr[RT] = {pf.x, pf.y, pf.z, pf.w};
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          o[r][c][0] = fmaf(pr[r], vf[c].x, o[r][c][0]);
          o[r][c][1] = fmaf(pr[r], vf[c].y, o[r][c][1]);
          o[r][c][2] = fmaf(pr[r], vf[c].z, o[r][c][2]);
          o[r][c][3] = fmaf(pr[r], vf[c].w, o[r][c][3]);
        }
      pf = pn;
#pragma unroll
      for (int c = 0; c < CT; ++c) vf[c] = vn[c];
    }
  }

  // the row sums meet; the butterfly leaves the same sum in every lane
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = KL / 2; off > 0; off >>= 1)
      lt += __shfl_xor_sync(kFull, lt, off);
    const float denom = lt == 0.f ? 1.f : lt;
    float* const orow = out + (bh * Sq + q0 + grp + r * G::kGroups) * D;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      *reinterpret_cast<float4*>(orow + 4 * lane + c * 4 * KL) =
          make_float4(o[r][c][0] / denom, o[r][c][1] / denom,
                      o[r][c][2] / denom, o[r][c][3] / denom);
  }
}

template <int D, int BQ>
cudaError_t attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, april_attention_kernel<D, BQ>);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(Geometry<D, BQ>::kSmem);
  return cudaSuccess;
}

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* iv;
  void* out;
  int64_t BH, Sq, Skv;
  int block_kv;
  float scale;
  int has_softcap;
  float softcap;
  int mask_kind, window;
  cudaStream_t stream;
  template <int D, int BQ>
  cudaError_t run() const {
    using G = Geometry<D, BQ>;
    auto kernel = april_attention_kernel<D, BQ>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::kSmem));
    if (err != cudaSuccess) return err;
    const int64_t nq = Sq / BQ;
    const int64_t blocks = BH * nq;
    if (blocks <= 0) return cudaSuccess;
    if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
    kernel<<<static_cast<unsigned int>(blocks), G::kThreads, G::kSmem,
             stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), iv, static_cast<float*>(out),
        static_cast<int>(BH), static_cast<int>(nq), static_cast<int>(Sq),
        static_cast<int>(Skv), block_kv, scale,
        has_softcap, softcap, mask_kind, window);
    return cudaGetLastError();
  }
};

struct Attrs {
  int* out;
  template <int D, int BQ>
  cudaError_t run() const {
    return attrs<D, BQ>(out);
  }
};

template <typename F>
cudaError_t dispatch(int64_t D, int block_q, const F& f) {
  if (block_q != 64 && block_q != 128) return cudaErrorInvalidValue;
  const bool bq64 = block_q == 64;
  switch (D) {
    case 32:
      return bq64 ? f.template run<32, 64>() : f.template run<32, 128>();
    case 64:
      return bq64 ? f.template run<64, 64>() : f.template run<64, 128>();
    case 128:
      return bq64 ? f.template run<128, 64>() : f.template run<128, 128>();
    case 256:
      return bq64 ? f.template run<256, 64>() : f.template run<256, 128>();
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [BH, Sq, D], k/v [BH, Skv, D] float32, 16-byte aligned, iv [Sq /
// block_q, 4] int32 (a_lo, f_lo, f_hi, a_hi), out like q. mask_kind 0:
// causal, 1: local(window), 2: full. Returns the launch's cudaError_t; a
// shape the kernel is not built for returns cudaErrorInvalidValue.
extern "C" int april_attention_launch(
    const void* q, const void* k, const void* v, const int32_t* iv, void* out,
    int64_t BH, int64_t Sq, int64_t Skv, int64_t D, int block_q, int block_kv,
    float scale, int has_softcap, float softcap, int mask_kind, int window,
    void* stream) {
  if (block_q <= 0 || block_kv <= 0 || Sq % block_q != 0 ||
      Skv % block_kv != 0 || BH > 0x7fffffff || Sq > 0x7fffffff ||
      Skv > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch f{q,     k,         v,       iv,          out,
                 BH,    Sq,        Skv,     block_kv,    scale,
                 has_softcap,      softcap, mask_kind,   window,
                 static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(D, block_q, f));
}

// out[3]: registers a thread, local (spill) bytes a thread and dynamic
// shared memory bytes of the instance (D, block_q); an instance that is
// not built returns cudaErrorInvalidValue.
extern "C" int april_attention_attrs(int64_t D, int block_q, int* out) {
  return static_cast<int>(dispatch(D, block_q, Attrs{out}));
}
