// Fused float64 refine of the INDECISIVE prefix (B7), for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's fused refine is jnp
// (_intersects_impl_jnp, _within_impl_jnp, _line_impl_jnp in
// src/repro/spatial/refine.py), and the port ran its float64 PyTorch twins
// (spatial/refine.py _intersects_impl, _within_impl, _line_impl) in chunks
// of the whole pair frame, every row padded to the layer's widest ring,
// some 344 elementwise launches a chunk. This kernel computes the same
// (res, unc) lanes in one launch over the front-packed prefix.
//
// Inputs: perm [N] int32 and count [] int32 from the compaction of the
// INDECISIVE lane (count is read here, on the card: the host never sees
// it), the frame's ri/si [N] int64, and the cached device geometry of each
// layer: verts [P, V, 2] float64, nverts [P] int64, and for rings reps
// [P, 2] float64. Packed row n < count refines the pair (ri[perm[n]],
// si[perm[n]]) straight from the geometry; rows n >= count are written
// False/False. No copy of a ring is made in device memory. ``refined``
// [1] int64 (zero on entry) gets the number of rows the kernel refined,
// counted where each row's lanes are written, so that a grid that walked
// rows past the count would show it.
//
// Design. A persistent grid (the resident blocks of the card) strides over
// groups of kWarps packed rows. A warp takes a row whose rings make at most
// kWarpCouples vertex couples, stages both rings in shared memory (up to
// kStage vertices a side, float64 (x, y) pairs; wider rings are read where
// they lie), and its lanes stride over the row's own edges: couple k is
// (a edge k / nb, b edge k % nb), with one warp vote a step; a point-in-
// polygon test strides over the ring's edges and reduces the crossing
// parity by ballot. The whole block then takes each larger row of the group
// in turn, with block-wide votes. No row is padded: a row walks
// na x nb couples of its own rings.
//
// A row stops only where the rest of its work cannot change either lane:
// intersects and line test the representative points (the chain's first
// vertex) first and skip the sweep when one is definitely inside, and stop
// the sweep at the first crossing whose four orientations are all clear of
// the guard band (definite_true). Within tests every vertex of r first and
// sweeps only when all read inside (the sweep cannot change a row with a
// vertex outside), stopping once a proper crossing is found and the row is
// already uncertain; the vertex loop stops once a vertex reads outside and
// the row is uncertain.
//
// Arithmetic is the eager cores', operation for operation: _orient_unc,
// _segments_intersect (proper, touch), _pip_batch (the crossing's step,
// near, the orientation band on the edge's box) with the guard 2^-44.
// Every product, sum, difference and quotient is an explicitly rounded
// float64 intrinsic, and the unit builds with -fmad=false, so nothing is
// contracted into a multiply-add and (res, unc) equal the eager lanes bit
// for bit. The host float64 re-check of the unc rows stays as it is.
//
// What bounds it on the H100: float64 operations, about 44 a couple (four
// guarded orientations) and about 15 a point-edge test, against 34 TFLOP/s
// of non-tensor FP64; the bytes (each row reads its two rings once, some
// tens of MB a join, mostly from L2) come lower.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStage = 160;              // vertices of a side a warp stages
constexpr int kCap = kWarps * kStage;    // ... and the block, for a large row
constexpr int64_t kWarpCouples = 4096;   // larger rows take the block
constexpr double kEps = 0x1p-44;         // refine._EPS_GUARD

enum Kind : int { kIntersects = 0, kWithin = 1, kLine = 2 };

__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}

// _orient_unc(a, b, c): the orientation of c against a -> b; sets unc where
// it lies within the guard band of zero and neither product is zero.
__device__ __forceinline__ double orient(double2 a, double2 b, double2 c,
                                         bool& unc) {
  const double p1 = mul(sub(b.x, a.x), sub(c.y, a.y));
  const double p2 = mul(sub(b.y, a.y), sub(c.x, a.x));
  const double d = sub(p1, p2);
  unc = unc || (fabs(d) <= mul(kEps, add(fabs(p1), fabs(p2))) &&
                p1 != 0.0 && p2 != 0.0);
  return d;
}

__device__ __forceinline__ bool on_seg(double2 p0, double2 p1, double2 r) {
  return fmin(p0.x, p1.x) <= r.x && r.x <= fmax(p0.x, p1.x) &&
         fmin(p0.y, p1.y) <= r.y && r.y <= fmax(p0.y, p1.y);
}

// One couple of _segments_intersect: (hit) and its borderline flag, or,
// with kProperOnly, the proper crossing of _within_impl.
template <bool kProperOnly>
__device__ __forceinline__ bool couple(double2 a0, double2 a1, double2 b0,
                                       double2 b1, bool& unc) {
  const double d1 = orient(b0, b1, a0, unc);
  const double d2 = orient(b0, b1, a1, unc);
  const double d3 = orient(a0, a1, b0, unc);
  const double d4 = orient(a0, a1, b1, unc);
  const bool proper = ((d1 > 0.0) != (d2 > 0.0)) &&
                      ((d3 > 0.0) != (d4 > 0.0)) && d1 != 0.0 &&
                      d2 != 0.0 && d3 != 0.0 && d4 != 0.0;
  if (kProperOnly) return proper;
  return proper || (d1 == 0.0 && on_seg(b0, b1, a0)) ||
         (d2 == 0.0 && on_seg(b0, b1, a1)) ||
         (d3 == 0.0 && on_seg(a0, a1, b0)) ||
         (d4 == 0.0 && on_seg(a0, a1, b1));
}

// One (point, edge) term of _pip_batch: toggles the crossing parity, sets
// on-boundary and the borderline flag.
__device__ __forceinline__ void pip_edge(double2 p, double2 e0, double2 e1,
                                         bool& par, bool& onb, bool& unc) {
  if ((e0.y <= p.y) != (e1.y <= p.y)) {
    const double step = mul(__ddiv_rn(sub(p.y, e0.y), sub(e1.y, e0.y)),
                            sub(e1.x, e0.x));
    const double xint = add(e0.x, step);
    par = par != (xint > p.x);
    unc = unc || (fabs(sub(xint, p.x)) <=
                      mul(kEps, add(add(fabs(e0.x), fabs(step)), fabs(p.x))) &&
                  step != 0.0);
  }
  if (on_seg(e0, e1, p)) {
    const double d = orient(e0, e1, p, unc);
    onb = onb || d == 0.0;
  }
}

// A ring (closed) or an open chain: n vertices at v, in shared or global
// memory.
struct Ring {
  const double2* v;
  int n;
  bool closed;
  __device__ __forceinline__ int edges() const {
    return closed ? n : (n > 0 ? n - 1 : 0);
  }
  __device__ __forceinline__ double2 end(int e) const {
    return v[(closed && e + 1 == n) ? 0 : e + 1];
  }
};

// The threads that share a row, with their votes: a warp, or the block.
struct WarpTeam {
  static constexpr int kSize = 32;
  int t;
  __device__ __forceinline__ bool any(bool p) const {
    return __any_sync(kFull, p);
  }
  __device__ __forceinline__ bool parity(bool p) const {
    return __popc(__ballot_sync(kFull, p)) & 1;
  }
};

struct BlockTeam {
  static constexpr int kSize = kThreads;
  int t;
  __device__ __forceinline__ bool any(bool p) const {
    return __syncthreads_or(p);
  }
  __device__ __forceinline__ bool parity(bool p) const {
    return __syncthreads_count(p) & 1;
  }
};

// The a edge of couple k < total of a row with nb b edges: k / nb, in 32
// bits where the row's couples fit them.
__device__ __forceinline__ int split(int64_t k, int nb, int64_t total) {
  if (total <= 0xffffffffll)
    return static_cast<int>(static_cast<uint32_t>(k) /
                            static_cast<uint32_t>(nb));
  return static_cast<int>(k / nb);
}

// Closed-region point in polygon of p against ring B, with its borderline
// flag; every thread of the team gets both.
template <class Team>
__device__ __forceinline__ void point_in(const Team& tm, double2 p,
                                         const Ring& B, bool& in, bool& unc) {
  bool par = false, onb = false, u = false;
  for (int e = tm.t; e < B.n; e += Team::kSize)
    pip_edge(p, B.v[e], B.end(e), par, onb, u);
  in = tm.parity(par) | tm.any(onb);
  unc = tm.any(u);
}

// The edge x edge sweep of A against B. Without kProperOnly: hit (a
// crossing or touch), unc, and sure (a hit clear of the band), stopping at
// the first sure hit. With kProperOnly: hit is a proper crossing, and the
// sweep stops once a proper crossing is found and the row is uncertain
// (unc, or the caller's known_unc).
template <bool kProperOnly, class Team>
__device__ void sweep(const Team& tm, const Ring& A, const Ring& B,
                      bool known_unc, bool& hit, bool& unc, bool& sure) {
  const int nb = B.edges();
  const int64_t total = static_cast<int64_t>(A.edges()) * nb;
  bool h = false, u = false, s = false;
  for (int64_t base = 0; base < total; base += Team::kSize) {
    const int64_t k = base + tm.t;
    if (k < total) {
      const int i = split(k, nb, total);
      const int j = static_cast<int>(k - static_cast<int64_t>(i) * nb);
      bool cu = false;
      const bool ch = couple<kProperOnly>(A.v[i], A.end(i), B.v[j], B.end(j),
                                          cu);
      h = h || ch;
      u = u || cu;
      s = s || (ch && !cu);
    }
    if (kProperOnly ? (tm.any(h) && (known_unc || tm.any(u))) : tm.any(s))
      break;
  }
  hit = tm.any(h);
  unc = tm.any(u);
  sure = tm.any(s);
}

// One packed row: its rings and, for intersects, the representative points.
struct Pair {
  const double2* a;   // R's ring (or chain) in the geometry
  const double2* b;   // S's ring
  int na, nb;
  double2 pa, pb;     // rep_r and rep_s; for a line, pa is the first vertex
};

struct Geometry {
  const double2* verts;    // [P, width] vertices
  const int64_t* nverts;   // [P]
  const double2* reps;     // [P] or null
  int64_t width;
};

template <int kKind>
__device__ __forceinline__ Pair pair_of(const Geometry& gr,
                                        const Geometry& gs,
                                        const int64_t* __restrict__ ri,
                                        const int64_t* __restrict__ si,
                                        const int32_t* __restrict__ perm,
                                        int64_t n) {
  const int64_t row = perm[n];
  const int64_t r = ri[row], s = si[row];
  Pair p;
  p.a = gr.verts + r * gr.width;
  p.b = gs.verts + s * gs.width;
  p.na = static_cast<int>(gr.nverts[r]);
  p.nb = static_cast<int>(gs.nverts[s]);
  if (kKind == kIntersects) {
    p.pa = gr.reps[r];
    p.pb = gs.reps[s];
  } else if (kKind == kLine) {
    p.pa = p.a[0];
  }
  return p;
}

// (res, unc) of one row by the core of kKind over rings A and B.
template <int kKind, class Team>
__device__ void refine_row(const Team& tm, const Ring& A, const Ring& B,
                           const Pair& p, bool& res, bool& unc) {
  bool hit = false, hunc = false, hsure = false;
  if (kKind == kWithin) {
    bool all_in = true, pip_unc = false;
    for (int q = 0; q < A.n; ++q) {
      bool in, u;
      point_in(tm, A.v[q], B, in, u);
      all_in = all_in && in;
      pip_unc = pip_unc || u;
      if (!all_in && pip_unc) break;
    }
    if (all_in) sweep<true>(tm, A, B, pip_unc, hit, hunc, hsure);
    res = all_in && !hit;
    unc = pip_unc || (all_in && hunc);
    return;
  }
  // intersects: rep_r in S, rep_s in R; line: the chain's first vertex in S
  bool in_b, ub, in_a = false, ua = false;
  point_in(tm, p.pa, B, in_b, ub);
  if (kKind == kIntersects) point_in(tm, p.pb, A, in_a, ua);
  const bool sure = (in_b && !ub) || (in_a && !ua);
  if (!sure) sweep<false>(tm, A, B, false, hit, hunc, hsure);
  res = hit || in_b || in_a;
  unc = (hunc || ub || ua) && !(sure || hsure);
}

// Thread t of nt copies the n vertices at src into dst when they fit cap;
// returns where the ring is to be read.
__device__ __forceinline__ const double2* stage(double2* dst, int cap,
                                                const double2* src, int n,
                                                int t, int nt) {
  if (n > cap) return src;
  for (int i = t; i < n; i += nt) dst[i] = src[i];
  return dst;
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
fused_refine_kernel(Geometry gr, Geometry gs, const int64_t* __restrict__ ri,
                    const int64_t* __restrict__ si,
                    const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ count, int64_t n_rows,
                    uint8_t* __restrict__ res, uint8_t* __restrict__ unc,
                    unsigned long long* __restrict__ refined) {
  __shared__ double2 smem[kWarps][2][kStage];
  unsigned long long mine = 0;           // rows this thread wrote
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool closed_a = kKind != kLine;
  const int64_t c = *count > 0 ? static_cast<int64_t>(*count) : 0;
  const int64_t live = c < n_rows ? c : n_rows;

  // rows past the count
  for (int64_t n = live + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       n < n_rows; n += static_cast<int64_t>(gridDim.x) * kThreads) {
    res[n] = 0;
    unc[n] = 0;
  }

  double2* const flat = &smem[0][0][0];
  for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * kWarps; row0 < live;
       row0 += static_cast<int64_t>(gridDim.x) * kWarps) {
    // a warp a small row
    const int64_t n = row0 + warp;
    if (n < live) {
      const Pair p = pair_of<kKind>(gr, gs, ri, si, perm, n);
      if (static_cast<int64_t>(p.na) * p.nb <= kWarpCouples) {
        const Ring A{stage(smem[warp][0], kStage, p.a, p.na, lane, 32), p.na,
                     closed_a};
        const Ring B{stage(smem[warp][1], kStage, p.b, p.nb, lane, 32), p.nb,
                     true};
        __syncwarp();
        bool r, u;
        refine_row<kKind>(WarpTeam{lane}, A, B, p, r, u);
        if (lane == 0) {
          res[n] = r;
          unc[n] = u;
          ++mine;
        }
        __syncwarp();                    // the warp's stage is free
      }
    }

    // the block each large row
    bool large = false;
    for (int w = 0; w < kWarps; ++w) {
      const int64_t m = row0 + w;
      if (m >= live) break;
      const Pair p = pair_of<kKind>(gr, gs, ri, si, perm, m);
      if (static_cast<int64_t>(p.na) * p.nb <= kWarpCouples) continue;
      large = true;
      __syncthreads();                   // the shared stage is free
      const Ring A{stage(flat, kCap, p.a, p.na, threadIdx.x, kThreads), p.na,
                   closed_a};
      const Ring B{stage(flat + kCap, kCap, p.b, p.nb, threadIdx.x, kThreads),
                   p.nb, true};
      __syncthreads();
      bool r, u;
      refine_row<kKind>(BlockTeam{static_cast<int>(threadIdx.x)}, A, B, p, r,
                        u);
      if (threadIdx.x == 0) {
        res[m] = r;
        unc[m] = u;
        ++mine;
      }
    }
    if (large) __syncthreads();          // before the warps restage
  }
  if (mine) atomicAdd(refined, mine);
}

template <int kKind>
cudaError_t launch(int grid, const Geometry& gr, const Geometry& gs,
                   const int64_t* ri, const int64_t* si, const int32_t* perm,
                   const int32_t* count, int64_t n_rows, uint8_t* res,
                   uint8_t* unc, unsigned long long* refined,
                   cudaStream_t stream) {
  fused_refine_kernel<kKind><<<grid, kThreads, 0, stream>>>(
      gr, gs, ri, si, perm, count, n_rows, res, unc, refined);
  return cudaGetLastError();
}

}  // namespace

// The most blocks of the kernel resident on ``device`` at once (the
// persistent grid), the largest over the three cores. Negative on a CUDA
// error.
extern "C" int fused_refine_max_blocks(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
      != cudaSuccess)
    return -1;
  const void* kernels[] = {
      reinterpret_cast<const void*>(fused_refine_kernel<kIntersects>),
      reinterpret_cast<const void*>(fused_refine_kernel<kWithin>),
      reinterpret_cast<const void*>(fused_refine_kernel<kLine>)};
  int most = 0;
  for (const void* k : kernels) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0)
        != cudaSuccess)
      return -1;
    most = per_sm > most ? per_sm : most;
  }
  return sms * most;
}

// kind 0 intersects, 1 within, 2 line. r_verts [P_r, r_width, 2] and
// s_verts float64, r_nverts/s_nverts int64, r_reps/s_reps [P, 2] float64
// (read for intersects only); ri/si [n_rows] int64; perm [n_rows] int32;
// count [] int32; res/unc [n_rows] bool; refined [1] int64, zeroed, gets
// the rows refined. ``grid`` blocks of 128 threads. Returns the launch's
// cudaError_t.
extern "C" int fused_refine_launch(int kind, const double* r_verts,
                                   const int64_t* r_nverts,
                                   const double* r_reps, int64_t r_width,
                                   const double* s_verts,
                                   const int64_t* s_nverts,
                                   const double* s_reps, int64_t s_width,
                                   const int64_t* ri, const int64_t* si,
                                   const int32_t* perm, const int32_t* count,
                                   int64_t n_rows, int grid, uint8_t* res,
                                   uint8_t* unc, int64_t* refined,
                                   void* stream) {
  if (grid <= 0 || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry gr{reinterpret_cast<const double2*>(r_verts), r_nverts,
                    reinterpret_cast<const double2*>(r_reps), r_width};
  const Geometry gs{reinterpret_cast<const double2*>(s_verts), s_nverts,
                    reinterpret_cast<const double2*>(s_reps), s_width};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* const rows =
      reinterpret_cast<unsigned long long*>(refined);
  cudaError_t err;
  switch (kind) {
    case kIntersects:
      err = launch<kIntersects>(grid, gr, gs, ri, si, perm, count, n_rows,
                                res, unc, rows, st);
      break;
    case kWithin:
      err = launch<kWithin>(grid, gr, gs, ri, si, perm, count, n_rows, res,
                            unc, rows, st);
      break;
    case kLine:
      err = launch<kLine>(grid, gr, gs, ri, si, perm, count, n_rows, res,
                          unc, rows, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
