// Interval-list joins of the APRIL intermediate filter, for Hopper (sm_90a).
//
// Replaces the TPU kernels april_trichotomy_pallas (B1) and
// interval_overlap_pallas (B4) in src/repro/kernels/interval_join/
// interval_join.py. Those evaluate the overlap predicate of every (i, j)
// interval pair of a padded [8, I, J] tile in VMEM, which caps the list
// width and needs the lists packed and padded on the host. Here the joins
// run straight on the device-resident CSR arrays, addressed by the rows'
// offsets: no host packing, no padding, no width cap. Endpoints are biased
// int32 with inclusive lasts, so every comparison is a signed 32-bit
// compare.
//
// What bounds it on the H100: the load transactions of gathered lists and
// the chain of dependent steps in each row's merge, not bandwidth. The
// bytes the function must move are tiny (0.0068 ms at 3.35 TB/s for the
// 742,279 rows of the T1 x T2 frame; the four stores hold about 10 MB and
// sit in the 50 MB L2), and the merge does a few integer compares an
// interval. The earlier design ran one two-pointer merge a thread: 86.5
// merge steps a row on average, 250 for the slowest row of a warp (2.9x
// divergence), each step up to four 4-byte loads from 32 different lists,
// so one load instruction was as many L1 wavefronts as it had live lanes:
// about 255 M wavefronts for the frame, 1.1 ms at 1.7 GHz over 132 SMs.
// On an H100 80GB HBM3 at 700 W it took 1.54 ms of device time for that
// frame, this design 0.34 ms; PERF.md records both, and the designs that
// were timed and dropped (G = 4, 16 and 32, no start skip, a wide-row
// split, a dual advance, a search form).
//
// The design: a group of G = 8 lanes owns one pair row. It keeps a window of G
// consecutive X intervals and G consecutive Y intervals in registers, lane k
// holding interval i0 + k of X and j0 + k of Y, so a window is G x 4 contiguous
// bytes an array, not G scattered loads. A step tests every pair of the two
// windows at once: each lane finds, by a binary search over the Y window
// through __shfl_sync, the first y whose last is >= its x's start; its x
// overlaps some y of the window if and only if that y's start is <= its last
// (the plain version's searchsorted rule, within the window). A ballot ends the
// join at the first hit. Then the window that ends first retires (X on a tie:
// xmax <= ymax, the lasts of the windows' last valid intervals) and the group
// loads that list's next G intervals: Algorithm 2's linear merge, made coarse.
// A join of nx and ny intervals takes at most ceil(nx / G) + ceil(ny / G) steps
// where a thread took up to nx + ny.
//
// Before its first window each join skips, on both lists, the stretch that
// ends before the other list starts (the sampled skip): lane k reads the
// last of interval k * ceil(n / G), and the group drops every sampled
// stretch whose last is below the other list's first start, so the window
// starts at most ceil(n / G) - 1 intervals early. The lists of two objects
// whose boxes meet often begin far apart along the Hilbert curve.
//
// Why no overlapping pair is missed (the block-merge argument). Invariant:
// no retired or skipped interval overlaps an interval of the other list
// that is still to come. The skip keeps it: every y starts at or above Y's
// first start, and a skipped x ends below it. A step tests every pair of
// the current windows. If xmax <= ymax, each x of the window has been
// tested against the Y window; the Y intervals before the window are
// retired and, by the invariant, miss it; those after the window start
// above ymax >= its last (the lists are sorted and disjoint). So it
// overlaps nothing still to come, and retiring the X window keeps the
// invariant; the same holds for the Y window when ymax < xmax. A join ends
// without a hit only when one side is wholly retired, and then, by the
// invariant, no pair overlaps.
//
// Lanes past a list's end are masked by a lane-valid flag (k < the
// intervals left), never by sentinel endpoints: biased ends reach both
// INT32_MIN (cell 0) and INT32_MAX (cell 2^32 - 1 at order 16), and an
// empty store's sentinel slot is never read (an empty list loads nothing).
//
// The groups of a warp run in lockstep: every lane loops until the last
// group of its warp is done, each group keeping its own state (a done
// group's lanes take part in the shuffles and ballots and load nothing), so
// every __shfl_sync and __ballot_sync runs converged with the full mask.
// B1 runs its three joins as a small state machine, AA, then AF, then FA,
// with the short cuts of the plain version (AA first: with F not inside A,
// an AF-first short cut would change the verdict).
//
// Why no host sort by width: the fused chain reads nothing back to the
// host before its one gather, so rows are taken in the frame's order, and
// the small groups bound the divergence instead (a warp waits on the
// slowest of 32 / G rows, not of 32).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// lanes a pair row, and intervals a window
constexpr int kGroup = 8;

constexpr int kTrueNeg = 0, kTrueHit = 1, kIndecisive = 2;
enum Phase : int { kAA = 0, kAF = 1, kFA = 2, kDone = 3 };

struct Lists {
  const int64_t* off;
  const int32_t* starts;
  const int32_t* lasts;
};

// The next phase of B1's state machine after a join, and the verdict once
// it is kDone: AA empty -> TRUE_NEG; else AF or FA hit -> TRUE_HIT; else
// INDECISIVE. B4 (kTri false) is done after AA.
template <bool kTri>
__device__ __forceinline__ int next_phase(int phase, bool hit, int& verdict) {
  if constexpr (!kTri) {
    verdict = hit ? 1 : 0;
    return kDone;
  }
  if (phase == kAA) {
    verdict = kTrueNeg;
    return hit ? kAF : kDone;
  }
  if (hit || phase == kFA) {
    verdict = hit ? kTrueHit : kIndecisive;
    return kDone;
  }
  return kFA;
}

// Row state of group_verdict: the row's lists (first interval and count of
// A(r), F(r), A(s), F(s)), this lane's interval of the X window and the
// intervals of X left from the window's first (none once the group is
// done), the same for Y, and the windows.
struct Merge {
  int64_t xa0, xf0, ya0, yf0;
  int nxa, nxf, nya, nyf;
  const int32_t *pxs, *pxl, *pys, *pyl;
  int xr, yr;
  int32_t wxs, wxl, wys, wyl;
};

// Starts the join of ``phase`` for the groups whose ``fresh`` is set (every
// lane of the warp calls it): X is F(r) in FA, else A(r); Y is F(s) in AF,
// else A(s). Each list first drops its stretch that ends before the other
// list starts, found to within ceil(n / G) intervals by one sample a lane;
// then the windows load.
__device__ __forceinline__ void begin_join(Merge& m, int phase, bool fresh,
                                           int k, unsigned gmask,
                                           const Lists& xa, const Lists& xf,
                                           const Lists& ya, const Lists& yf) {
  const bool fx = phase == kFA, fy = phase == kAF;
  const int32_t* xs = (fx ? xf.starts : xa.starts) + (fx ? m.xf0 : m.xa0);
  const int32_t* xl = (fx ? xf.lasts : xa.lasts) + (fx ? m.xf0 : m.xa0);
  const int32_t* ys = (fy ? yf.starts : ya.starts) + (fy ? m.yf0 : m.ya0);
  const int32_t* yl = (fy ? yf.lasts : ya.lasts) + (fy ? m.yf0 : m.ya0);
  const int nx = fresh && phase != kDone ? (fx ? m.nxf : m.nxa) : 0;
  const int ny = fresh && phase != kDone ? (fy ? m.nyf : m.nya) : 0;
  const int sx = (nx + kGroup - 1) / kGroup, sy = (ny + kGroup - 1) / kGroup;
  bool bx = false, by = false;
  if (nx > 0 && ny > 0) {
    const int32_t x_first = __ldg(xs), y_first = __ldg(ys);
    bx = k * sx < nx && __ldg(xl + k * sx) < y_first;
    by = k * sy < ny && __ldg(yl + k * sy) < x_first;
  }
  const int cx = __popc(__ballot_sync(kFull, bx) & gmask);
  const int cy = __popc(__ballot_sync(kFull, by) & gmask);
  const int dx = cx ? (cx - 1) * sx + 1 : 0;
  const int dy = cy ? (cy - 1) * sy + 1 : 0;
  if (fresh) {
    m.pxs = xs + dx + k;
    m.pxl = xl + dx + k;
    m.pys = ys + dy + k;
    m.pyl = yl + dy + k;
    m.xr = nx - dx;
    m.yr = ny - dy;
    if (k < m.xr) {
      m.wxs = __ldg(m.pxs);
      m.wxl = __ldg(m.pxl);
    }
    if (k < m.yr) {
      m.wys = __ldg(m.pys);
      m.wyl = __ldg(m.pyl);
    }
  }
}

// One step of the window merge: whether any pair of the two windows
// overlaps (for this lane's group); then the window that ends first is
// retired (X on a tie) and the next one loaded. Every lane of the warp
// calls it; a done group has xr = yr = 0 and loads nothing.
__device__ __forceinline__ bool merge_step(Merge& m, int k, unsigned gmask) {
  const int vx = m.xr < kGroup ? m.xr : kGroup;
  const int vy = m.yr < kGroup ? m.yr : kGroup;
  const int32_t xmax = __shfl_sync(kFull, m.wxl, vx - 1, kGroup);
  const int32_t ymax = __shfl_sync(kFull, m.wyl, vy - 1, kGroup);
  // p: the first y of the window whose last is >= this lane's x start
  int p = 0;
#pragma unroll
  for (int step = kGroup / 2; step >= 1; step >>= 1) {
    const int q = p + step - 1;
    const int32_t lq = __shfl_sync(kFull, m.wyl, q, kGroup);
    if (q < vy && lq < m.wxs) p += step;
  }
  const int32_t lp = __shfl_sync(kFull, m.wyl, p, kGroup);
  const int32_t sp = __shfl_sync(kFull, m.wys, p, kGroup);
  const bool lane_hit = k < vx && p < vy && lp >= m.wxs && sp <= m.wxl;
  const bool hit = (__ballot_sync(kFull, lane_hit) & gmask) != 0;
  if (xmax <= ymax) {
    m.xr -= kGroup;
    m.pxs += kGroup;
    m.pxl += kGroup;
    if (k < m.xr) {
      m.wxs = __ldg(m.pxs);
      m.wxl = __ldg(m.pxl);
    }
  } else {
    m.yr -= kGroup;
    m.pys += kGroup;
    m.pyl += kGroup;
    if (k < m.yr) {
      m.wys = __ldg(m.pys);
      m.wyl = __ldg(m.pyl);
    }
  }
  return hit;
}

// The verdict of pair row ``row`` < n (B1: TRUE_NEG / TRUE_HIT /
// INDECISIVE; B4, kTri false: 1 if A(x) meets A(y), else 0) by the group of
// G lanes of this thread, which writes it from the group's first lane.
// Every lane of the warp runs the loop until the warp's last group is done.
template <bool kTri, typename Out>
__device__ __forceinline__ void join_rows(
    const Lists& xa, const Lists& xf, const Lists& ya, const Lists& yf,
    const int64_t* __restrict__ ri, const int64_t* __restrict__ si, int64_t n,
    Out* __restrict__ out) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int k = lane & (kGroup - 1);
  const unsigned gmask = ((1u << kGroup) - 1u) << (lane & ~(kGroup - 1));
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kGroup;
  const bool live = row < n;
  Merge m{};
  if (live) {
    const int64_t r = ri[row], s = si[row];
    m.xa0 = xa.off[r];
    m.nxa = static_cast<int>(xa.off[r + 1] - m.xa0);
    m.ya0 = ya.off[s];
    m.nya = static_cast<int>(ya.off[s + 1] - m.ya0);
    if constexpr (kTri) {
      m.xf0 = xf.off[r];
      m.nxf = static_cast<int>(xf.off[r + 1] - m.xf0);
      m.yf0 = yf.off[s];
      m.nyf = static_cast<int>(yf.off[s + 1] - m.yf0);
    }
  }
  int phase = live ? kAA : kDone;
  int verdict = 0;
  bool fresh = live;
  while (__any_sync(kFull, phase != kDone)) {
    if (__any_sync(kFull, fresh)) {
      begin_join(m, phase, fresh, k, gmask, xa, xf, ya, yf);
      fresh = false;
    }
    const bool hit = merge_step(m, k, gmask);
    if (phase != kDone && (hit || m.xr <= 0 || m.yr <= 0)) {
      phase = next_phase<kTri>(phase, hit, verdict);
      fresh = phase != kDone;
      if (!fresh) {
        m.xr = 0;
        m.yr = 0;
      }
    }
  }
  if (live && k == 0) out[row] = static_cast<Out>(verdict);
}

__global__ void __launch_bounds__(kThreads) april_trichotomy_kernel(
    Lists xa, Lists xf, Lists ya, Lists yf, const int64_t* __restrict__ ri,
    const int64_t* __restrict__ si, int64_t n, int8_t* __restrict__ out) {
  join_rows<true>(xa, xf, ya, yf, ri, si, n, out);
}

__global__ void __launch_bounds__(kThreads) interval_overlap_kernel(
    Lists x, Lists y, const int64_t* __restrict__ xi,
    const int64_t* __restrict__ yi, int64_t n, uint8_t* __restrict__ out) {
  join_rows<false>(x, x, y, y, xi, yi, n, out);
}

unsigned int blocks_for(int64_t n) {
  constexpr int64_t kRows = kThreads / kGroup;
  return static_cast<unsigned int>((n + kRows - 1) / kRows);
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
