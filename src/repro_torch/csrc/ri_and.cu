// The RI filter (paper Algorithm 1) with its ALIGNEDAND (§3.3), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel aligned_and_pallas
// (src/repro/kernels/ri_and/ri_and.py:69). That kernel takes one fragment
// (one overlapping interval pair of one candidate) per sequential grid step,
// over words that the host expands and packs per fragment, each as wide as
// the longest whole interval of its bucket: at the T1 x T2 smoke size
// (742,279 candidates) that is 10.9 million fragments and seconds of host
// expansion and packing for every batch. Here the kernel runs the whole of
// Algorithm 1 for every candidate pair row, straight on the device-resident
// stores: the interval lists (biased int32 starts and inclusive lasts, as
// APRIL's device lists hold them), each interval's bit offset and the packed
// code streams. It writes the row's verdict: TRUE_HIT if some shared cell
// run ("fragment") ANDs non-zero, INDECISIVE if intervals overlap without
// such a hit, TRUE_NEG if none overlap. The host expands and packs nothing;
// there is no width cap and no bucket loop.
//
// ALIGNEDAND of one fragment: word m of the shared run is a funnel shift of
// stream words i and i + 1 at the run's bit offset on each side; Y's word is
// XORed with word m % 3 of the period-3-word re-encoding mask when both
// stores share an encoding (runs start on cell boundaries, so the mask's
// phase is 0); the last word is tail-masked; the first non-zero word
// decides TRUE_HIT.
//
// What bounds it on the H100: the chain of dependent loads in each row's
// merge, not bandwidth or arithmetic. The stores are small (673,500
// intervals and 4.3 MB of code words at the smoke size, inside the 50 MB
// L2), a fragment reads a few words (median 9 bits, one word; the longest
// 5,268 bits, 165 words), and each merge step waits for the interval the
// last step chose. Two thirds of the frame's rows are TRUE_HIT and end at
// their first hit, so what counts is rows in flight and steps a row.
//
// The design: one thread a pair row, the two-pointer merge with a strided
// skip. Where the current X interval ends before the current Y interval
// starts, the merge reads, beside them, the last of the kStride-th X
// interval from here; if that one ends before Y's start too, the kStride X
// intervals from here overlap nothing still to come (the later Y intervals
// start later still, and every Y interval already passed ended before some
// X interval at or before the current one did), and the merge drops them
// at once; the same for Y. The stretches of two lists that lie apart along
// the curve, before the first overlap and between overlaps, go kStride
// intervals a step; only the side that advanced is reloaded. Overlapping
// intervals are ANDed at once, and the row ends at its first hit.
//
// On an H100 80GB HBM3 at 700 W the kernel takes 0.150 ms of device time
// over the 742,279 rows of the RI T1 x T2 frame, the plain two-pointer merge
// a thread (the design before this one) 0.25 ms. The window merge of
// csrc/interval_join.cu with the ANDs folded in (G lanes a row, fragments
// split across the group) took 0.35 ms at G = 8 and more at G = 4, 16 and
// 32: it needs several times the instructions a merge step takes here and
// keeps one row in flight a group of lanes, not a thread, while two thirds
// of the rows end at an early hit. Strides of 4 and 16 took 0.154 and 0.177
// ms. PERF.md records every design's times.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// intervals the strided skip drops at once
constexpr int kStride = 8;

constexpr int kTrueNeg = 0, kTrueHit = 1, kIndecisive = 2;

// One RI store side. Interval ends are biased int32 (the uint32 Hilbert id
// minus 2^31) with inclusive lasts; biased ids compare as the ids do, and a
// difference taken in int64 is the ids' difference.
struct Store {
  const int64_t* off;       // [P+1] row offsets into the interval arrays
  const int32_t* starts;    // [I] biased interval starts
  const int32_t* lasts;     // [I] biased inclusive interval lasts
  const int64_t* bit_off;   // [I+1] stream bit of each interval's codes
  const uint32_t* words;    // packed LSB-first code stream + a zero pad word
};

// The 32 stream bits starting at ``bit``; reads words i and i + 1 (the pad
// word keeps i + 1 in bounds for the stream's last word).
__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ w,
                                            int64_t bit) {
  const int64_t i = bit >> 5;
  return __funnelshift_r(__ldg(w + i), __ldg(w + i + 1),
                         static_cast<unsigned>(bit & 31));
}

// Word m (mod 3) of the re-encoding mask (1, 1, 0) repeated from phase 0.
__device__ __forceinline__ uint32_t xor_mask(int m) {
  return m == 0 ? 0xDB6DB6DBu : (m == 1 ? 0xB6DB6DB6u : 0x6DB6DB6Du);
}

// ALIGNEDAND: does the nbits-bit run of X at xbit AND the run of Y at ybit
// (re-encoded when xor_y) have a bit set? Exits on the first non-zero word.
__device__ bool aligned_and(const uint32_t* __restrict__ xw, int64_t xbit,
                            const uint32_t* __restrict__ yw, int64_t ybit,
                            int64_t nbits, bool xor_y) {
  int m = 0;
  for (int64_t done = 0; done < nbits; done += 32) {
    uint32_t x = word_at(xw, xbit + done);
    uint32_t y = word_at(yw, ybit + done);
    if (xor_y) y ^= xor_mask(m);
    m = (m == 2) ? 0 : m + 1;
    const int64_t rem = nbits - done;
    if (rem < 32) x &= (1u << rem) - 1u;
    if (x & y) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads) ri_trichotomy_kernel(
    Store x, Store y, bool xor_y, const int64_t* __restrict__ ri,
    const int64_t* __restrict__ si, int64_t n, int8_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const int64_t r = ri[row], s = si[row];
  int64_t a = x.off[r];
  const int64_t a_end = x.off[r + 1];
  int64_t b = y.off[s];
  const int64_t b_end = y.off[s + 1];
  bool overlap = false;
  if (a < a_end && b < b_end) {
    int32_t xs = __ldg(x.starts + a), xl = __ldg(x.lasts + a);
    int32_t ys = __ldg(y.starts + b), yl = __ldg(y.lasts + b);
    while (true) {
      // the last of the kStride-th interval from here, where one exists
      // past it
      const int32_t xk = a + kStride < a_end ? __ldg(x.lasts + a + kStride - 1) : 0;
      const int32_t yk = b + kStride < b_end ? __ldg(y.lasts + b + kStride - 1) : 0;
      bool adv_x;
      if (xl < ys) {
        a += a + kStride < a_end && xk < ys ? kStride : 1;
        adv_x = true;
      } else if (yl < xs) {
        b += b + kStride < b_end && yk < xs ? kStride : 1;
        adv_x = false;
      } else {
        const int32_t lo = xs > ys ? xs : ys;
        const int32_t hi = xl < yl ? xl : yl;
        if (aligned_and(x.words,
                        __ldg(x.bit_off + a) + 3 * (static_cast<int64_t>(lo) - xs),
                        y.words,
                        __ldg(y.bit_off + b) + 3 * (static_cast<int64_t>(lo) - ys),
                        3 * (static_cast<int64_t>(hi) - lo + 1), xor_y)) {
          out[row] = kTrueHit;
          return;
        }
        overlap = true;
        adv_x = xl <= yl;         // retire the one that ends first (X on a tie)
        if (adv_x) {
          ++a;
        } else {
          ++b;
        }
      }
      if (adv_x) {
        if (a >= a_end) break;
        xs = __ldg(x.starts + a);
        xl = __ldg(x.lasts + a);
      } else {
        if (b >= b_end) break;
        ys = __ldg(y.starts + b);
        yl = __ldg(y.lasts + b);
      }
    }
  }
  out[row] = overlap ? kIndecisive : kTrueNeg;
}

}  // namespace

extern "C" int ri_trichotomy_launch(
    const int64_t* x_off, const int32_t* x_starts, const int32_t* x_lasts,
    const int64_t* x_bit_off, const uint32_t* x_words,
    const int64_t* y_off, const int32_t* y_starts, const int32_t* y_lasts,
    const int64_t* y_bit_off, const uint32_t* y_words, int xor_y,
    const int64_t* ri, const int64_t* si, int64_t n, int8_t* out,
    void* stream) {
  if (n > 0) {
    const unsigned int blocks =
        static_cast<unsigned int>((n + kThreads - 1) / kThreads);
    ri_trichotomy_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        Store{x_off, x_starts, x_lasts, x_bit_off, x_words},
        Store{y_off, y_starts, y_lasts, y_bit_off, y_words}, xor_y != 0, ri, si,
        n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
