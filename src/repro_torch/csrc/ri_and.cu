// The RI filter (paper Algorithm 1) with its ALIGNEDAND (§3.3), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel aligned_and_pallas
// (src/repro/kernels/ri_and/ri_and.py:69). That kernel takes one fragment
// (one overlapping interval pair of one candidate) per sequential grid step,
// over words that the host expands and packs per fragment, each as wide as
// the longest whole interval of its bucket: at the T1 x T2 smoke size
// (742,279 candidates) that is 10.9 million fragments and seconds of host
// expansion and packing for every batch.
//
// Here one thread owns one candidate pair row. It runs Algorithm 1's
// two-pointer merge over the device-resident interval lists of both stores
// and, for each overlapping interval pair, ANDs the shared cell run's 3-bit
// codes straight out of the two resident code streams: word k of a run is a
// funnel shift of stream words i and i + 1 at the run's bit offset, Y's word
// is XORed with the period-3-word re-encoding mask when both stores share an
// encoding (runs start on cell boundaries, so the mask's phase is 0), the
// last word is tail-masked, and the first non-zero word decides TRUE_HIT. A
// row with overlapping intervals and no hit is INDECISIVE, one with none
// TRUE_NEG. The host expands nothing and packs nothing per batch; there is no
// width cap and no bucket loop. Verdicts equal the per-pair reference
// ri_verdict_pair row for row, by construction.
//
// What bounds it on the H100: memory latency and divergence, not bandwidth
// or arithmetic. The stores are small (at the smoke size 673,500 intervals
// of 16 bytes and 4.3 MB of code words, inside the 50 MB L2), a fragment
// reads a few words (median 9 bits, one word), and each step of a row's
// merge is a dependent load. The longest fragments run to 5,268 bits (165
// words), so threads of one warp diverge on them. The design keeps the
// stores read-only and L2-resident, exits on the first hit word and launches
// one thread per row (hundreds of thousands) to hide the latency; a later
// version can give a long row a whole warp, splitting its words across
// lanes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Interval ends are biased int32 (the uint32 Hilbert id minus 2^31) with
// inclusive lasts, as APRIL's device lists hold them, so ids of every order
// up to 16 fit; biased ids compare as the ids do, and a difference taken in
// int64 is the ids' difference.
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

__global__ void ri_trichotomy_kernel(Store x, Store y, bool xor_y,
                                     const int64_t* __restrict__ ri,
                                     const int64_t* __restrict__ si,
                                     int64_t n, int8_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t r = ri[row];
  const int64_t s = si[row];
  int64_t a = x.off[r];
  const int64_t a_end = x.off[r + 1];
  int64_t b = y.off[s];
  const int64_t b_end = y.off[s + 1];
  bool overlap = false;
  while (a < a_end && b < b_end) {
    const int64_t xs = x.starts[a], xl = x.lasts[a];
    const int64_t ys = y.starts[b], yl = y.lasts[b];
    if (xs <= yl && ys <= xl) {
      const int64_t lo = xs > ys ? xs : ys;
      const int64_t hi = (xl < yl ? xl : yl) + 1;
      if (aligned_and(x.words, x.bit_off[a] + 3 * (lo - xs), y.words,
                      y.bit_off[b] + 3 * (lo - ys), 3 * (hi - lo), xor_y)) {
        out[row] = 1;                                   // TRUE_HIT
        return;
      }
      overlap = true;
    }
    if (xl <= yl) {
      ++a;
    } else {
      ++b;
    }
  }
  out[row] = overlap ? 2 : 0;                           // INDECISIVE : TRUE_NEG
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
