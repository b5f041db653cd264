// APRIL block-sparse flash attention in bf16 on Hopper's tensor cores
// (sm_90a: wgmma fed by TMA).
//
// Replaces the TPU kernel april_attention_pallas
// (src/repro/kernels/april_attention/april_attention.py:102) for bf16
// inputs; csrc/april_attention.cu keeps the f32 inputs on the CUDA cores.
// The mask's (q block x kv block) raster is classified as APRIL classifies
// raster cells: per q block one A-interval [a_lo, a_hi) of kv blocks to
// visit and one F-interval [f_lo, f_hi) of Full blocks that need no mask;
// the blocks of A outside F are Partial and get the causal or
// local(window) mask.
//
// What bounds it on the H100: operations. Attention over the allowed
// (q, k) positions costs 4 D operations each (QK^T and PV, a multiply and
// an add each), at the bf16 tensor-core peak of 989 TFLOP/s: 1.04 ms at
// gemma2-2b's local layer (S 32768, D 256, window 4096) against 0.16 ms to
// move q, k, v and the output once. Beside the products every score pays
// a dozen instructions on the CUDA cores (scale, softcap, mask, max, exp2,
// sum, rounding), about as much issue time at D 128 as its share of the
// products; the design keeps the tensor cores fed while they run.
//
// The design. One CTA per (bh, q block), launched longest q block first
// (the causal rows visit the most kv blocks last in q), reads its own
// interval row and visits only the kv blocks in [a_lo, a_hi), clipped to
// the blocks that exist; Empty blocks are never loaded. Its last warpgroup
// is the producer: one thread issues the TMA loads of the q block once and
// of K and V in tiles of KT keys (128 where D <= 128 and block_kv allows,
// else 64, else 32) into two rings of two stages in shared memory, K's and
// V's apart (a K tile is done with long before its V tile), each stage
// with a "full" mbarrier (TMA bytes arrive) and an "empty" one (every
// consumer warp is done with it). One consumer warpgroup per 64 q rows (1
// for block_q 64, 2 for 128) does the math; with two, setmaxnreg moves
// registers from the producer to the consumers (40 and 232 a thread): at
// D 256 the output accumulator alone is 128 f32 registers a thread.
//
// Per tile a consumer warpgroup takes S = Q K^T with wgmma.m64nKTk16, Q and
// K read from shared memory (K-major), then per score in registers: the
// scale, the softcap (softcap * tanh(s / softcap), tanh.approx.f32), the
// causal or local mask on tiles of Partial blocks only (a tile inherits
// its kv block's class), and the online softmax in f32 in base 2 (log2(e)
// folded into the scale after the softcap; exp2 as ex2.approx.ftz, one
// special-function instruction), with the finite NEG_INF = -1e30: a fully
// masked first tile carries exp(0) until a later one rescales it away with
// alpha = exp2(-1e30 - m) = 0, where -inf would give NaN. p is rounded to
// bf16, as p.astype(v.dtype) does, and the S accumulator's registers are
// exactly wgmma's A fragment, so O += P V runs as wgmma.m64nDk16 with P
// from registers and V from shared memory, MN-major (transpose bit set). The two products overlap the softmax: S of
// tile t is issued with PV of tile t - 1, and the softmax of tile t runs
// while PV of t - 1 is still on the tensor cores; the two consumer
// warpgroups take turns at issuing, so that one's softmax runs under the
// other's products (FlashAttention-3's ping-pong). The row sums l stay per
// thread and meet across the quad at the end, where O is divided by l
// (l == 0 read as 1) and written as bf16.
//
// Shared memory: TMA writes every tile with the 128-byte swizzle (64-byte
// at D 32) in boxes of 64 columns (four at D 256), the layout the wgmma
// descriptors name (1024-byte aligned atoms of 8 rows). At D 256 and q
// block 128: Q 64 KB, each stage's K and V tiles 32 KB each, 192 KB in
// all.
#include <cstdint>
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// with two consumer warpgroups, setmaxnreg moves registers from the
// producer warpgroup (40 a thread) to them (232): the CTA starts at 168 a
// thread, and 128 x 40 + 256 x 232 = 384 x 168
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of the given parity has completed. There is no
// timeout that traps: with a __trap() reachable here ptxas kept the
// consumers within the 168 registers the CTA starts with, and at D 256 they
// spilled and their products ran one at a time.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one 2-D box of a tensor map into shared memory; its bytes complete on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFF) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFF) << 32) | (layout << 62);
}

// descriptor d moved on by BYTES (a multiple of 16). The add is opaque and
// its operand an immediate, so the compiler redoes it at each product
// instead of holding every k step's descriptor in registers across the kv
// loop.
template <uint32_t BYTES>
__device__ __forceinline__ uint64_t desc_at(uint64_t d) {
  uint64_t r;
  asm volatile("add.s64 %0, %1, %2;\n" : "=l"(r) : "l"(d), "n"(BYTES >> 4));
  return r;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving an accumulator across the asynchronous
// products
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 32] (+)= A[64 x 16] B[32 x 16]^T, A and B K-major in shared
// memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared
// memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, A and B K-major in shared
// memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], A in registers, B MN-major in
// shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in
// shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major in
// shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 256] += A[64 x 16] B[16 x 256], A in registers, B MN-major in
// shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Shared-memory geometry of one instance: D head width, BQ q rows, KT keys
// a kv tile.
template <int D, int BQ, int KT>
struct Geometry {
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;   // swizzle span
  static constexpr int kBoxCols = kRowBytes / 2;          // bf16 a box row
  static constexpr uint64_t kLayout = D >= 64 ? 1 : 2;    // 128 B : 64 B
  // K-major atoms: 8 rows of kRowBytes (16-byte units)
  static constexpr uint32_t kAtom = 8 * kRowBytes / 16;
  static constexpr int kConsumers = BQ / 64;              // warpgroups
  // the consumer warpgroups, then the producer warpgroup
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr uint32_t kQBytes = BQ * D * 2;
  static constexpr uint32_t kTileBytes = KT * D * 2;      // K or V tile
  static constexpr size_t kBarOffset =
      kQBytes + 2 * static_cast<size_t>(kStages) * kTileBytes;
  // q_full, then full and empty of each K and V stage
  static constexpr int kBars = 1 + 4 * kStages;
  // the barriers, and room to align the base to 1024 bytes
  static constexpr size_t kSmem = kBarOffset + 8 * kBars + 1024;
  // byte offset of k step kk (16 columns) in a K-major tile of `rows` rows
  __host__ __device__ static constexpr uint32_t k_step(int kk, int rows) {
    return (kk * 16 / kBoxCols) * rows * kRowBytes +
           (kk * 16 % kBoxCols) * 2;
  }
};

// the softcap's tanh on the special function unit (relative error about
// 2^-11); tanhf's two dozen instructions a score cost 22 % at gemma2-2b's
// local layer
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x on the special function unit, one instruction; results under 2^-126
// flush to 0 (exp2f's handling of them costs three more instructions a
// score). Here x <= 0 (a score less the running max), so what flushes is
// a p under 1.2e-38 beside the row's largest p of 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The scores of one tile in base 2, in place: scale, softcap, the mask on
// Partial tiles; then the online softmax of the thread's two rows (max
// across the quad): sc becomes p in f32, m and l move on, and alpha0 /
// alpha1 are the factors the rows' accumulators must be rescaled by.
template <int KT>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[KT / 2], bool partial, int key0, int qpos0, int col,
    float qk_scale, float out_scale, int has_softcap, int mask_kind,
    int window, float& m0, float& m1, float& l0, float& l1, float& alpha0,
    float& alpha1) {
  const int qpos1 = qpos0 + 8;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    float x = sc[i] * qk_scale;
    if (has_softcap) x = out_scale * tanh_approx(x);
    if (partial) {
      const int kpos = key0 + 8 * (i / 4) + col + (i & 1);
      const int qpos = (i & 2) ? qpos1 : qpos0;
      const bool allowed =
          mask_kind == 0 ? kpos <= qpos
          : mask_kind == 1 ? (kpos <= qpos && kpos > qpos - window)
                           : true;
      if (!allowed) x = kNegInf;
    }
    sc[i] = x;
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < KT / 2; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  alpha0 = exp2_ftz(m0 - mn0);
  alpha1 = exp2_ftz(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < KT / 2; i += 4) {
    sc[i] = exp2_ftz(sc[i] - mn0);
    sc[i + 1] = exp2_ftz(sc[i + 1] - mn0);
    sc[i + 2] = exp2_ftz(sc[i + 2] - mn1);
    sc[i + 3] = exp2_ftz(sc[i + 3] - mn1);
    sum0 += sc[i] + sc[i + 1];
    sum1 += sc[i + 2] + sc[i + 3];
  }
  l0 = l0 * alpha0 + sum0;
  l1 = l1 * alpha1 + sum1;
}

// p rounded to bf16 as wgmma's A fragment: accumulator registers 4 j ..
// 4 j + 3 of n8 block j are the fragment's registers 2 (j % 2) and
// 2 (j % 2) + 1 of k step j / 2
template <int KT>
__device__ __forceinline__ void pack_p(const float (&p)[KT / 2],
                                       uint32_t (&pa)[KT / 16][4]) {
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    const __nv_bfloat162 r0 = __floats2bfloat162_rn(p[4 * j], p[4 * j + 1]);
    const __nv_bfloat162 r1 =
        __floats2bfloat162_rn(p[4 * j + 2], p[4 * j + 3]);
    pa[j / 2][2 * (j % 2)] = *reinterpret_cast<const uint32_t*>(&r0);
    pa[j / 2][2 * (j % 2) + 1] = *reinterpret_cast<const uint32_t*>(&r1);
  }
}

// the k steps of S = Q K^T over D, 16 columns each
template <int D, int BQ, int KT, int K = 0>
__device__ __forceinline__ void s_steps(float (&sc)[KT / 2], uint64_t qd,
                                        uint64_t kd) {
  if constexpr (K < D / 16) {
    using G = Geometry<D, BQ, KT>;
    wgmma_ss(sc, desc_at<G::k_step(K, BQ)>(qd),
             desc_at<G::k_step(K, KT)>(kd), K > 0);
    s_steps<D, BQ, KT, K + 1>(sc, qd, kd);
  }
}

// the k steps of O += P V over the tile's keys, 16 each: V is MN-major,
// atoms of 8 keys x kRowBytes, so a step is 16 rows on
template <int D, int BQ, int KT, int K = 0>
__device__ __forceinline__ void pv_steps(float (&o)[D / 2],
                                         const uint32_t (&pa)[KT / 16][4],
                                         uint64_t vd) {
  if constexpr (K < KT / 16) {
    using G = Geometry<D, BQ, KT>;
    wgmma_rs(o, pa[K], desc_at<K * 16 * G::kRowBytes>(vd));
    pv_steps<D, BQ, KT, K + 1>(o, pa, vd);
  }
}

// The products of tile t, issued and committed once its stage is full:
// S = Q K^T (K-major operands), and O += P V (V MN-major: boxes of
// kBoxCols columns KT rows apart).
template <int D, int BQ, int KT>
__device__ __forceinline__ void issue_s(float (&sc)[KT / 2], uint64_t qd,
                                        uint8_t* sk, uint64_t* full, int t) {
  using G = Geometry<D, BQ, KT>;
  const int s = t % kStages;
  mbar_wait(&full[s], (t / kStages) & 1);
  const uint64_t kd =
      smem_desc(sk + s * G::kTileBytes, 1, G::kAtom, G::kLayout);
  wgmma_fence();
  s_steps<D, BQ, KT>(sc, qd, kd);
  wgmma_commit();
}

template <int D, int BQ, int KT>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[KT / 16][4],
                                         uint8_t* sv, uint64_t* full, int t) {
  using G = Geometry<D, BQ, KT>;
  const int s = t % kStages;
  mbar_wait(&full[s], (t / kStages) & 1);
  const uint64_t vd = smem_desc(sv + s * G::kTileBytes,
                                KT * G::kRowBytes / 16, G::kAtom,
                                G::kLayout);
  pin(o);
  wgmma_fence();
  pv_steps<D, BQ, KT>(o, pa, vd);
  wgmma_commit();
}

// the warp is done with stage t % kStages of a ring
__device__ __forceinline__ void release(uint64_t* empty, int t, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[t % kStages]);
}

// With two consumer warpgroups they take turns at issuing their products
// (named barriers 1 and 2, 256 threads each), so that one's softmax runs
// while the other's products are on the tensor cores.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}

__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}

// One CTA per (bh, q block). iv [nq, 4] int32 rows (a_lo, f_lo, f_hi,
// a_hi) in kv-block units. Scores: qk_scale * (q . k) without a softcap,
// out_scale * tanhf(qk_scale * (q . k)) with one, in base-2 units (the
// caller folds log2(e) into out_scale, or into qk_scale without a
// softcap).
template <int D, int BQ, int KT>
__global__ void __launch_bounds__(Geometry<D, BQ, KT>::kThreads, 1)
april_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const int32_t* __restrict__ iv,
                          __nv_bfloat16* __restrict__ out, int BH, int nq,
                          int Sq, int Skv, int block_kv, float qk_scale,
                          float out_scale, int has_softcap, int mask_kind,
                          int window) {
  using G = Geometry<D, BQ, KT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                                  // [boxes][BQ][row]
  uint8_t* sk = sq + G::kQBytes;                       // [stage][boxes][KT]
  uint8_t* sv = sk + kStages * G::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + G::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  // longest first: the last q blocks of a causal mask visit the most
  const int qi = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int nk = Skv / block_kv;
  const int a_lo = max(iv[4 * qi], 0);
  const int f_lo = iv[4 * qi + 1];
  const int f_hi = iv[4 * qi + 2];
  const int a_hi = min(iv[4 * qi + 3], nk);
  const int tiles_per_block = block_kv / KT;
  const int n_tiles = a_hi > a_lo ? (a_hi - a_lo) * tiles_per_block : 0;
  const int key_lo = a_lo * block_kv;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * G::kConsumers);   // one arrival a warp
      mbar_init(&v_empty[s], 4 * G::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler can prove it
  // uniform across the warp: only then does it give each branch the
  // registers its setmaxnreg sets
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (c == G::kConsumers) {
    // producer: one thread issues every load; K and V have rings of their
    // own, since a K tile is done with long before its V tile
    if constexpr (G::kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    if (threadIdx.x == 128 * G::kConsumers) {
      mbar_expect_tx(q_full, G::kQBytes);
      for (int b = 0; b < D / G::kBoxCols; ++b)
        tma_load(sq + b * BQ * G::kRowBytes, &qmap, q_full,
                 b * G::kBoxCols, bh * Sq + qi * BQ);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        const int row = bh * Skv + key_lo + t * KT;
        uint8_t* kt = sk + s * G::kTileBytes;
        uint8_t* vt = sv + s * G::kTileBytes;
        mbar_wait(&k_empty[s], parity);
        mbar_expect_tx(&k_full[s], G::kTileBytes);
        for (int b = 0; b < D / G::kBoxCols; ++b)
          tma_load(kt + b * KT * G::kRowBytes, &kmap, &k_full[s],
                   b * G::kBoxCols, row);
        mbar_wait(&v_empty[s], parity);
        mbar_expect_tx(&v_full[s], G::kTileBytes);
        for (int b = 0; b < D / G::kBoxCols; ++b)
          tma_load(vt + b * KT * G::kRowBytes, &vmap, &v_full[s],
                   b * G::kBoxCols, row);
      }
    }
    return;
  }

  // consumer warpgroup c owns q rows [64 c, 64 c + 64) of the block
  if constexpr (G::kConsumers == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  // this thread's two rows of the accumulators (row0 and row0 + 8), and
  // its column pair in each n8 block
  const int row0 = 64 * c + 16 * (tid / 32) + lane / 4;
  const int qpos0 = qi * BQ + row0;
  const int col = 2 * (lane % 4);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float sc[KT / 2];
  uint32_t pa[KT / 16][4];
  const uint64_t qd =
      smem_desc(sq + 64 * c * G::kRowBytes, 1, G::kAtom, G::kLayout);

  // The pipeline within the warpgroup: while the tensor cores run the PV
  // product of tile t - 1, the CUDA cores take the softmax of tile t. Each
  // turn issues one tile's products; both warpgroups take n_tiles + 1.
  constexpr bool kTurns = G::kConsumers == 2;
  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    float alpha0, alpha1;
    if (kTurns && c == 1) turn_pass(c);  // warpgroup 0 goes first
    if (kTurns) turn_wait(c);
    issue_s<D, BQ, KT>(sc, qd, sk, k_full, 0);
    if (kTurns) turn_pass(c);
    wgmma_wait<0>();
    pin(sc);
    release(k_empty, 0, lane);
    softmax_tile<KT>(sc, a_lo < f_lo || a_lo >= f_hi, key_lo, qpos0, col,
                     qk_scale, out_scale, has_softcap, mask_kind, window,
                     m0, m1, l0, l1, alpha0, alpha1);   // o is 0
    pack_p<KT>(sc, pa);
    for (int t = 1; t < n_tiles; ++t) {
      if (kTurns) turn_wait(c);
      issue_s<D, BQ, KT>(sc, qd, sk, k_full, t);
      issue_pv<D, BQ, KT>(o, pa, sv, v_full, t - 1);
      if (kTurns) turn_pass(c);
      wgmma_wait<1>();                   // S of tile t
      pin(sc);
      release(k_empty, t, lane);
      const int key0 = key_lo + t * KT;
      const int ki = key0 / block_kv;
      softmax_tile<KT>(sc, ki < f_lo || ki >= f_hi, key0, qpos0, col,
                       qk_scale, out_scale, has_softcap, mask_kind, window,
                       m0, m1, l0, l1, alpha0, alpha1);
      wgmma_wait<0>();                   // PV of tile t - 1
      pin(o);
      release(v_empty, t - 1, lane);
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        o[i] *= alpha0;
        o[i + 1] *= alpha0;
        o[i + 2] *= alpha1;
        o[i + 3] *= alpha1;
      }
      pack_p<KT>(sc, pa);
    }
    if (kTurns) turn_wait(c);
    issue_pv<D, BQ, KT>(o, pa, sv, v_full, n_tiles - 1);
    if (kTurns && c == 0) turn_pass(c);  // warpgroup 1's last turn ends it
    wgmma_wait<0>();
    pin(o);
    release(v_empty, n_tiles - 1, lane);
  }

  // the row sums meet across the quad; O / l, l == 0 read as 1
#pragma unroll
  for (int i = 1; i <= 2; i <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, i);
    l1 += __shfl_xor_sync(0xffffffffu, l1, i);
  }
  const float d0 = l0 == 0.f ? 1.f : l0;
  const float d1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* ob0 =
      out + (static_cast<int64_t>(bh) * Sq + qpos0) * D + col;
  __nv_bfloat16* ob1 = ob0 + 8 * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 4) {
    const int n = 8 * (i / 4);
    *reinterpret_cast<__nv_bfloat162*>(ob0 + n) =
        __floats2bfloat162_rn(o[i] / d0, o[i + 1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(ob1 + n) =
        __floats2bfloat162_rn(o[i + 2] / d1, o[i + 3] / d1);
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime so
// that the library links no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, D] bf16 row-major, read in boxes of box_rows x (64 columns, or 32
// at D 32) with the swizzle the wgmma descriptors name
cudaError_t make_map(CUtensorMap* map, const void* base, int64_t rows,
                     int D, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(D >= 64 ? 64 : D),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
         dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
         D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int BQ, int KT>
cudaError_t attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, april_attention_tc_kernel<D, BQ, KT>);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(Geometry<D, BQ, KT>::kSmem);
  return cudaSuccess;
}

template <int D, int BQ, int KT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* iv, void* out, int64_t BH, int64_t Sq,
                   int64_t Skv, int block_kv, float qk_scale,
                   float out_scale, int has_softcap, int mask_kind,
                   int window, cudaStream_t stream) {
  using G = Geometry<D, BQ, KT>;
  auto kernel = april_attention_tc_kernel<D, BQ, KT>;
  if constexpr (G::kConsumers == 2) {
    // the consumers' setmaxnreg.inc waits for the registers the producer
    // gives up; there are enough only if the CTA starts with 168 a thread
    static int regs = 0;
    if (regs == 0) {
      int a[3];
      const cudaError_t err = attrs<D, BQ, KT>(a);
      if (err != cudaSuccess) return err;
      regs = a[0];
    }
    if (regs * G::kThreads < 128 * (kProducerRegs + 2 * kConsumerRegs))
      return cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return err;
  const int64_t nq = Sq / BQ;
  const int64_t blocks = BH * nq;
  if (blocks <= 0) return cudaSuccess;
  CUtensorMap qmap, kmap, vmap;
  if ((err = make_map(&qmap, q, BH * Sq, D, BQ)) != cudaSuccess ||
      (err = make_map(&kmap, k, BH * Skv, D, KT)) != cudaSuccess ||
      (err = make_map(&vmap, v, BH * Skv, D, KT)) != cudaSuccess)
    return err;
  kernel<<<static_cast<unsigned int>(blocks), G::kThreads, G::kSmem,
           stream>>>(qmap, kmap, vmap, iv,
                     static_cast<__nv_bfloat16*>(out),
                     static_cast<int>(BH), static_cast<int>(nq),
                     static_cast<int>(Sq), static_cast<int>(Skv), block_kv,
                     qk_scale, out_scale, has_softcap, mask_kind, window);
  return cudaGetLastError();
}

// the instance's kernel called through f.run<D, BQ, KT>(); kv tiles of
// 128 keys are built for D up to 128 only (at D 256 two stages of them
// would not fit in shared memory)
template <int D, int BQ, typename F>
cudaError_t by_tile(int kt, const F& f) {
  if constexpr (D <= 128) {
    if (kt == 128) return f.template run<D, BQ, 128>();
  }
  if (kt == 64) return f.template run<D, BQ, 64>();
  if (kt == 32) return f.template run<D, BQ, 32>();
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t dispatch(int64_t D, int block_q, int kt, const F& f) {
  if (block_q != 64 && block_q != 128) return cudaErrorInvalidValue;
  const bool bq64 = block_q == 64;
  switch (D) {
    case 32:
      return bq64 ? by_tile<32, 64>(kt, f) : by_tile<32, 128>(kt, f);
    case 64:
      return bq64 ? by_tile<64, 64>(kt, f) : by_tile<64, 128>(kt, f);
    case 128:
      return bq64 ? by_tile<128, 64>(kt, f) : by_tile<128, 128>(kt, f);
    case 256:
      return bq64 ? by_tile<256, 64>(kt, f) : by_tile<256, 128>(kt, f);
    default:
      return cudaErrorInvalidValue;
  }
}

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* iv;
  void* out;
  int64_t BH, Sq, Skv;
  int block_kv;
  float qk_scale, out_scale;
  int has_softcap, mask_kind, window;
  cudaStream_t stream;
  template <int D, int BQ, int KT>
  cudaError_t run() const {
    return launch<D, BQ, KT>(q, k, v, iv, out, BH, Sq, Skv, block_kv,
                             qk_scale, out_scale, has_softcap, mask_kind,
                             window, stream);
  }
};

struct Attrs {
  int* out;
  template <int D, int BQ, int KT>
  cudaError_t run() const {
    return attrs<D, BQ, KT>(out);
  }
};

}  // namespace

// q [BH, Sq, D], k/v [BH, Skv, D] bf16, 16-byte aligned, iv [Sq / block_q,
// 4] int32 (a_lo, f_lo, f_hi, a_hi), out like q. mask_kind 0: causal, 1:
// local(window), 2: full. Kv tiles of 128 keys where D <= 128 and block_kv
// is a multiple of 128, else of 64 where it is a multiple of 64, else of
// 32. Returns the launch's cudaError_t; a shape the kernel is not built
// for returns cudaErrorInvalidValue.
extern "C" int april_attention_tc_launch(
    const void* q, const void* k, const void* v, const int32_t* iv, void* out,
    int64_t BH, int64_t Sq, int64_t Skv, int64_t D, int block_q, int block_kv,
    float scale, int has_softcap, float softcap, int mask_kind, int window,
    void* stream) {
  if (block_q <= 0 || block_kv <= 0 || block_kv % 32 != 0 ||
      Sq % block_q != 0 || Skv % block_kv != 0 || BH * Sq > 0x7fffffff ||
      BH * Skv > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kt = D <= 128 && block_kv % 128 == 0 ? 128
                 : block_kv % 64 == 0            ? 64
                                                 : 32;
  // scores in base 2: log2(e) after the softcap
  const Launch f{q, k, v, iv, out, BH, Sq, Skv, block_kv,
                 has_softcap ? scale / softcap : scale * kLog2e,
                 has_softcap ? softcap * kLog2e : 1.f, has_softcap,
                 mask_kind, window, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(D, block_q, kt, f));
}

// out[3]: registers a thread, local (spill) bytes a thread and dynamic
// shared memory bytes of the instance (D, block_q, kv tile keys); an
// instance that is not built returns cudaErrorInvalidValue.
extern "C" int april_attention_tc_attrs(int64_t D, int block_q, int kv_tile,
                                        int* out) {
  return static_cast<int>(dispatch(D, block_q, kv_tile, Attrs{out}));
}
