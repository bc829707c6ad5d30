// SAME 3x3 convolution at any channel counts, NHWC input x HWIO weights,
// float32 on the H100's tensor cores: conv3x3_any_mma.cu's implicit GEMM with
// every product taken as three TF32 products (3xTF32), about as exact as an
// f32 product.
//
// Replaces, for float32 at every (C, Cout) and image size, the Pallas TPU
// kernels
//   sarssl_tpu/kernels/conv3x3.py::_pallas_conv3x3
//   sarssl_tpu/kernels/conv_s2d.py::_conv_s2d  (the s2d form is the conv of x
//       itself with w: kernels/conv_s2d.py launches this conv on x's C
//       channels)
// which compute jnp.dot(..., preferred_element_type=f32) on f32 operands.
//
//   y[n, h, w, co] = sum_{dh, dw, ci} x[n, h+dh-1, w+dw-1, ci] * wt[dh, dw, ci, co]
//
// with zeros outside the image, y in f32. Any N, H, W, C, Cout. (conv3x3.cu's
// f32 FMA kernels stay only as the yardstick this kernel is timed against.)
//
// What bounds it on an H100: a TF32 product runs at 494.7 TFLOP/s and an f32
// product here takes three, so the work counts 3 x 2 x 9 C Cout operations a
// pixel. At (128, 256, 256, 64) 64 -> 64 that is 1855.6 GFLOP, 3.751 ms,
// against 1.282 ms for the bytes: operations. At 3 -> 64 it is bytes (the
// output's 64 channels are 21 times the input's). The f32 FMAs of the first
// version peak at 67 TFLOP/s, 9.2 ms at the front end's shape. The design,
// conv3x3_any_mma.cu's where it carries over:
//  * 3xTF32 as the f32 attention takes it (mma_common.cuh's split_tf32 and
//    mma1688_3x): x = hi + lo, hi = rna(x), lo = rna(x - hi) (rna: cvt.rna's
//    rounding, here by two integer operations, which measured faster), and
//    each product the sum lo_a hi_b + hi_a lo_b + hi_a hi_b, in that order;
//    lo lo (about 2^-22 of the product) is left out.
//  * wgmma.mma_async.m64nNk8.f32.tf32.tf32 with A from registers and B in
//    shared memory. TF32 wgmma takes both operands K-major: NHWC pixels are
//    (their channels contiguous), and the weight is packed [co][ci]. A K
//    chunk is 32 f32 channels, so a chunk row is 128 bytes, as in the bf16
//    kernel: the same 128-byte swizzle, the same descriptors, and a k8 step
//    is the descriptor's start advanced by 32 bytes. ldmatrix moves 16-bit
//    elements, but read as 32-bit words its four 8 x 8 matrices are four 8 x
//    4 f32 ones, and with the bf16 kernel's lane addresses they land as the
//    TF32 A fragment wants them (a0 row g col t, a1 row g + 8, a2 col t + 4,
//    a3 both), so the bf16 fragment code carries over; each fragment is split
//    into hi and lo in registers after the load.
//  * The weight's split is done once a call, in the same launch as the
//    conv: the kernel's blocks first write each (pass, chunk) block as nine
//    taps' hi then nine taps' lo, NB x 32 each, zero past C and Cout, a share
//    each (kernels/conv3x3.py::pack_weights_tf32 is its plain version; for dx
//    it reads the weight rotated, rot180_io), then meet at a grid barrier (a
//    cooperative launch, every block resident: a pass's blocks slots /
//    passes of the card's) and run the conv; a packing kernel of its own
//    would cost a small call a second launch (PERF.md section 5). The weight
//    changes every training step: packed every call.
//  * Shared memory is the constraint: f32 doubles the bytes of a chunk of
//    channels and hi / lo double the weight's again. A stage of (input tile of
//    18 x 18 chunk rows, 41.5 KB; nine taps' hi and lo blocks at NB = 32, 72
//    KB) fits twice in 227 KB (230.4 KB), so the copy of the next (tile,
//    chunk) runs under the products of this one, as in the bf16 kernel. So a
//    pass takes NB <= 32 output channels (wgmma's N, a multiple of 8):
//    ceil(Cout / 32) passes of NB = 8 ceil(Cout / passes / 8)
//    (kernels/conv3x3.py::tf32_passes); 3 channels run N = 8. With one K
//    chunk (C <= 32) a block copies its weights once, so one weight stage is
//    enough and a pass takes up to 64 channels: 3 -> 64 runs one pass where
//    it ran two (the input copied and split once), 2.1x faster (PERF.md).
//  * The last K chunk runs the KT = ceil(tail / 8) k8 steps it needs (an
//    instance a tail: a branch around a wgmma would serialise the pipeline);
//    where C % 4 != 0 a pixel row is not 16-byte aligned, so the tile is
//    copied value by value with 4-byte cp.async (off the critical path like
//    the 16-byte copies), only the 16-byte pieces the k8 steps read.
//  * The sums. The tensor core's adder cuts each sum toward zero, so a
//    running f32 sum over many terms in its accumulator drifts, as in the f32
//    attention (attention_f32_mma_psum.cu; scripts/emulate_tf32_sums.py). So
//    each K chunk's products (288 terms) go into a zeroed accumulator
//    (scale-d = 0 on the chunk's first product) that is added to the sum in
//    f32 registers after the chunk: within 3.2e-6 of float64 at K = 18432,
//    where the accumulator's running sum read 5.2e-6 already at K = 576, at
//    no cost measured (PERF.md).
//  * Epilogue: straight from the accumulators, each group of four lanes
//    writing a whole 32-byte sector of a pixel (float2 each where Cout is
//    even, else value by value, masked to Cout): no staging in shared memory
//    and no barrier. No atomics: results are bit-identical from run to run.
//
// Image groups (conv3x3_tf32_groups_kernel), where the images are smaller
// than a row tile (kernels/conv3x3.py::conv_tiling): a tile is G consecutive
// whole images, G = floor(256 / (H W)), staged as their pixels' chunk rows in
// order after one zero row, no halo; each lane's ldmatrix row is its pixel's
// row shifted by the tap, or the zero row where the tap falls outside the
// image (conv3x3_any_mma.cu's design, with the fragment loads of one m16 tile
// a group so that the hi / lo fragments of two groups fit in registers).
// With one K chunk (C <= 32) a block's weights never change and are copied
// once.
//
// Two libraries: this file builds the row-tile kernels and
// conv3x3_tf32_groups.cu, which includes it with CONV_TF32_GROUPS = 1, the
// image-group kernels, so that the two halves compile in parallel. Both export
// the same C entries; each takes its own mode (G == 0 here, G > 0 there).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

#ifndef CONV_TF32_GROUPS
#define CONV_TF32_GROUPS 0
#endif

namespace {

constexpr bool LIB_GROUPS = CONV_TF32_GROUPS != 0;  // this library's tile mode

typedef long long i64;

constexpr int NT = 256, NWARP = NT / 32;
constexpr int TH = 16, TW = 16;          // output rows, columns of a tile
constexpr int MT = 2;                    // m16 tiles (tile rows) a warp
constexpr int XR = TH + 2, XC = TW + 2;  // input tile rows, columns (halo included)
constexpr int BLK = 32;                  // f32 channels of a K chunk
constexpr int ROWB = BLK * 4;            // bytes of a chunk row
constexpr int KS_FULL = BLK / 8;         // k8 steps of a whole chunk
constexpr int XS = XR * XC * ROWB;       // bytes of an input stage
constexpr int GM = NWARP * MT * 16;      // output pixels (rows of A) of a group tile
static_assert(NWARP * MT == TH, "the warps' m16 tiles cover the tile's rows");
static_assert(XS % 128 == 0, "input stages start 128-byte aligned");
static_assert(ROWB == 128, "chunk rows in the 128-byte swizzle (swz128, desc_kmajor)");

// NB past 32 only with one K chunk (C <= 32): then the weights are copied
// once, so one weight stage is enough and its hi and lo blocks fit at NB = 64
template <int NB>
struct Geo {
  static_assert(NB % 8 == 0 && NB >= 8 && NB <= 64, "wgmma's N: a multiple of 8 up to 64");
  static constexpr bool ONE_CHUNK = NB > 32;  // the instance takes C <= 32 only
  static constexpr int TAP = NB * ROWB;  // bytes of a tap's hi or lo block (1024-byte multiple)
  static constexpr int WS = 2 * 9 * TAP; // bytes of a weight stage: nine hi blocks, nine lo
  // the weight stages (two, or one), then the two input stages
  static constexpr int X_OFF = (ONE_CHUNK ? 1 : 2) * WS;
  static constexpr int BYTES = X_OFF + 2 * XS;
  static_assert(BYTES <= 232448, "over the shared memory a block may use");
};

template <int NB>
struct GeoG {
  static constexpr int TAP = Geo<NB>::TAP;
  static constexpr int WS = Geo<NB>::WS;
  static constexpr int XG = ROWB + GM * ROWB;  // an input stage: the zero chunk row, GM rows
  static constexpr int X_OFF = Geo<NB>::X_OFF;
  static constexpr int BYTES = X_OFF + 2 * XG;
  static_assert(XG % 128 == 0, "input stages start 128-byte aligned");
  static_assert(BYTES <= 232448, "over the shared memory a block may use");
};

// d (64 x NB, f32: this warp's 16 rows as NB / 8 m16n8 tiles) (+)= a (64 x 8
// tf32, this warp's 16 rows as an m16k8 fragment) * b (8 x NB in shared
// memory, K-major); sd 0 drops d's old value (scale-d), 1 adds to it
template <int NB>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NB / 8][4], const uint32_t (&a)[4],
                                           uint64_t desc, int sd);
template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[1][4], const uint32_t (&a)[4],
                                              uint64_t desc, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, {%4, %5, %6, "
      "%7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(sd));
}
template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[2][4], const uint32_t (&a)[4],
                                               uint64_t desc, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(sd));
}
template <>
__device__ __forceinline__ void wgmma_tf32<24>(float (&d)[3][4], const uint32_t (&a)[4],
                                               uint64_t desc, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(sd));
}
template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[4][4], const uint32_t (&a)[4],
                                               uint64_t desc, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(sd));
}

template <>
__device__ __forceinline__ void wgmma_tf32<40>(float (&d)[5][4], const uint32_t (&a)[4],
                                               uint64_t desc, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, "
      "%24, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(sd));
}
template <>
__device__ __forceinline__ void wgmma_tf32<48>(float (&d)[6][4], const uint32_t (&a)[4],
                                               uint64_t desc, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(sd));
}
template <>
__device__ __forceinline__ void wgmma_tf32<56>(float (&d)[7][4], const uint32_t (&a)[4],
                                               uint64_t desc, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(sd));
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t desc, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(sd));
}

// d (+)= a b from split operands: lo_a hi_b, hi_a lo_b, hi_a hi_b
// (mma1688_3x's order); sd applies to the first of the three
template <int NB>
__device__ __forceinline__ void wgmma_3x(float (&d)[NB / 8][4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], uint64_t dhi, uint64_t dlo,
                                         int sd) {
  wgmma_tf32<NB>(d, al, dhi, sd);
  wgmma_tf32<NB>(d, ah, dlo, 1);
  wgmma_tf32<NB>(d, ah, dhi, 1);
}

// mma_common.cuh's split_tf32 on an f32 word by integer operations: the
// nearest tf32 value, ties away from zero, is the word plus half the unit of
// its 13 dropped bits (added to the magnitude: the sign is the top bit), those
// bits then cleared. The same values as cvt.rna.tf32.f32 (kernels/conv3x3.py::
// tf32_rna is the plain version of both), at the integer units' full rate:
// with cvt.rna the fragments' split cost 10-19% of the kernel's time
// (scripts/conv_tf32_parts.py, variant cvt; PERF.md section 5)
__device__ __forceinline__ uint32_t tf32_rna_bits(uint32_t x) {
  return (x + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32_bits(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna_bits(x);
  lo = tf32_rna_bits(__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)));
}

// the four f32 words of a fragment loaded by ldmatrix, split into tf32 hi, lo
__device__ __forceinline__ void load_split(uint32_t (&ah)[4], uint32_t (&al)[4], uint32_t addr) {
  uint32_t r[4];
  ldsm_x4(r, addr);
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_bits(r[e], ah[e], al[e]);
}

// the 16-byte pieces of a chunk row that the chunk's k8 steps read: all 8 but
// in a last chunk of cc < 32 channels
__device__ __forceinline__ int pieces_read(int cc) { return 2 * ((cc + 7) / 8); }

// what a launch packs: the weight w (3, 3, C, CO), or with rot (3, 3, CO, C),
// and passes p0 .. p0 + gridDim.y - 1 of its blocks, into the scratch wp
struct Pack {
  const float* w;
  float* wp;
  int rot, p0;
};

// the block's share of the launch's passes of the packed weight, before the
// grid barrier: wp[p][k][0][tap][n][c] = tf32 hi of wt[tap][k * 32 + c][p * NB
// + n], [1] its lo, zero past C and CO, with wt = w (3, 3, C, CO) or, with
// rot, rot180_io of w (3, 3, CO, C): wt[dh][dw][ci][co] = w[2 - dh][2 - dw][co][ci]
// (kernels/conv3x3.py::pack_weights_tf32 is its plain version)
template <int NB>
__device__ __forceinline__ void pack_share(const Pack& pk, int C, int CO, int KC) {
  const int per_pass = KC * 9 * NB * BLK, total = gridDim.y * per_pass;
  const int step = gridDim.x * gridDim.y * NT;
  float* wp = pk.wp + (i64)pk.p0 * 2 * per_pass;
  for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * NT + threadIdx.x; i < total; i += step) {
    const int c = i % BLK, n = i / BLK % NB, tap = i / (BLK * NB) % 9;
    const int k = i / (BLK * NB * 9) % KC, pl = i / per_pass, p = pk.p0 + pl;
    const int ci = k * BLK + c, co = p * NB + n;
    float v = 0.f;
    if (ci < C && co < CO)
      v = pk.rot ? pk.w[((i64)(8 - tap) * CO + co) * C + ci] : pk.w[((i64)tap * C + ci) * CO + co];
    uint32_t hi, lo;
    split_tf32_bits(__float_as_uint(v), hi, lo);
    const i64 at = ((i64)(pl * KC + k) * 2 * 9 + tap) * NB * BLK + n * BLK + c;
    wp[at] = __uint_as_float(hi);
    wp[at + 9 * NB * BLK] = __uint_as_float(lo);
  }
}

// the (pass, chunk)'s hi and lo weight blocks, 2 x 9 x NB rows of 32 values
template <int NB>
__device__ __forceinline__ void load_weights(uint32_t ws, const float* wp, int KC, int kc,
                                             int pass) {
  const float* wsrc = wp + ((i64)pass * KC + kc) * 2 * 9 * NB * BLK;
  for (int idx = threadIdx.x; idx < 2 * 9 * NB * 8; idx += NT) {
    const int row = idx >> 3, piece = idx & 7;
    cp_async16(ws + swz128(row, piece), wsrc + (i64)row * BLK + piece * 4);
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&d)[MT][NB / 8][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n8 = 0; n8 < NB / 8; ++n8) d[m][n8][0] = d[m][n8][1] = d[m][n8][2] = d[m][n8][3] = 0.f;
}

// after a chunk: its products (part) go to the sum in f32
template <int NB>
__device__ __forceinline__ void add_chunk(float (&acc)[MT][NB / 8][4],
                                          const float (&part)[MT][NB / 8][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n8 = 0; n8 < NB / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n8][e] += part[m][n8][e];
}

// the epilogue, straight from the sums in registers:
// row r of the warp's m16 tile m is output pixel pix(m, r) (< 0: masked), and
// the thread's values are channels cb + 8 n8 + 2 q and + 1 of rows g and g + 8;
// a float2 where CO is even (each group of four lanes writes a whole 32-byte
// sector), else value by value; masked to nvalid channels
template <int NB, class Pix>
__device__ __forceinline__ void store_out(float* __restrict__ y,
                                          const float (&acc)[MT][NB / 8][4], int CO, int cb,
                                          int nvalid, Pix pix) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const i64 p = pix(m, g + 8 * h8);
      if (p < 0) continue;
      float* row = y + p * CO + cb;
#pragma unroll
      for (int n8 = 0; n8 < NB / 8; ++n8) {
        const int c = 8 * n8 + 2 * q;
        const float v0 = acc[m][n8][2 * h8], v1 = acc[m][n8][2 * h8 + 1];
        if (c >= nvalid) continue;
        if (CO % 2 == 0) {
          *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
        } else {
          row[c] = v0;
          if (c + 1 < nvalid) row[c + 1] = v1;
        }
      }
    }
}

// ---- row tiles ----

struct Shape {
  int N, H, W, C, CO, KC, tiles_x, tiles_y, ntiles;
};

// stage of (tile t, K chunk kc): the input tile's chunk rows, halo included,
// zeros outside the image and past C, and, with `weights`, the nine taps' hi
// and lo blocks of pass `pass`
template <int NB>
__device__ __forceinline__ void load_stage(uint32_t ws, uint32_t xs, const float* x,
                                           const float* wp, const Shape& s, int t, int kc,
                                           bool weights, int pass) {
  if (weights) load_weights<NB>(ws, wp, s.KC, kc, pass);
  const int tx = t % s.tiles_x, ty = (t / s.tiles_x) % s.tiles_y, n = t / (s.tiles_x * s.tiles_y);
  const int h0 = ty * TH - 1, w0 = tx * TW - 1;
  const float* xn = x + (i64)n * s.H * s.W * s.C;
  if (s.C % 4 == 0) {  // every 16-byte piece is aligned: inside C whole, or past it
    for (int idx = threadIdx.x; idx < XR * XC * 8; idx += NT) {
      const int rc = idx >> 3, piece = idx & 7, h = h0 + rc / XC, w = w0 + rc % XC;
      const int ch = kc * BLK + piece * 4;
      const bool ok = h >= 0 && h < s.H && w >= 0 && w < s.W && ch < s.C;
      cp_async16_zfill(xs + swz128(rc, piece), ok ? xn + ((i64)h * s.W + w) * s.C + ch : x,
                       ok ? 16 : 0);
    }
  } else {  // value by value (4-byte copies), zeros past C, only the pieces read
    const int np4 = 4 * pieces_read(min(BLK, s.C - kc * BLK));
    for (int idx = threadIdx.x; idx < XR * XC * np4; idx += NT) {
      const int rc = idx / np4, c = idx % np4, h = h0 + rc / XC, w = w0 + rc % XC;
      const int ch = kc * BLK + c;
      const bool ok = h >= 0 && h < s.H && w >= 0 && w < s.W && ch < s.C;
      cp_async4_zfill(xs + swz128(rc, c >> 2) + (c & 3) * 4,
                      ok ? xn + ((i64)h * s.W + w) * s.C + ch : x, ok ? 4 : 0);
    }
  }
}

// part = the stage's products over KS k8 steps of its K chunk (scale-d 0 on
// each output row's first product): for input row rr of the warp's MT + 2 and
// tap column dw the fragments are loaded and split once and multiplied into
// output rows rr - dh with tap (dh, dw)'s blocks
template <int NB, int KS>
__device__ __forceinline__ void stage_products(float (&part)[MT][NB / 8][4], uint32_t ws,
                                               uint32_t xs, int a_row, int hi) {
  typedef Geo<NB> G;
  uint32_t ah[2][KS][4], al[2][KS][4];
#pragma unroll
  for (int rr = 0; rr < MT + 2; ++rr) {
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int set = (rr * 3 + dw) & 1;
      const uint32_t a_addr = xs + swz128(a_row + rr * XC + dw, hi);
      // the group that read set `set` two groups ago has completed
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) load_split(ah[set][ks], al[set][ks], a_addr ^ (ks << 5));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const int m = rr - dh;  // known when unrolled: no branch is left
          if (m >= 0 && m < MT)
            wgmma_3x<NB>(part[m], ah[set][ks], al[set][ks],
                         desc_kmajor(ws + (dh * 3 + dw) * G::TAP) + 2 * ks,
                         desc_kmajor(ws + (9 + dh * 3 + dw) * G::TAP) + 2 * ks,
                         dh == 0 && dw == 0 && ks == 0 ? 0 : 1);
        }
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
}

// grid (blocks, passes of this launch), every block resident (a cooperative
// launch). x (N, H, W, C), y (N, H, W, CO); the blocks first pack the
// weight's passes into pk.wp, (passes, KC, 2, 9, NB, 32) zero-padded, and
// meet at a grid barrier; KT: the k8 steps of the last K chunk
template <int NB, int KT>
__global__ void __launch_bounds__(NT, 1)
conv3x3_tf32_kernel(const float* __restrict__ x, Pack pk, float* __restrict__ y, Shape s) {
  typedef Geo<NB> G;
  extern __shared__ __align__(1024) unsigned char smem[];
  pack_share<NB>(pk, s.C, s.CO, s.KC);
  cooperative_groups::this_grid().sync();
  const float* wp = pk.wp;
  const int pass = pk.p0 + blockIdx.y;
  const uint32_t sb = smem_u32(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * MT;
  // the lane's A row at tap offset 0 in the warp's first m16 tile
  const int a_row = row0 * XC + (lane & 15), hi = lane >> 4;
  const bool stream_w = s.KC > 1;  // else the block's weights are copied once
  int t = blockIdx.x;
  if (t >= s.ntiles) return;
  load_stage<NB>(sb, sb + G::X_OFF, x, wp, s, t, 0, true, pass);
  cp_async_commit();

  int it = 0;  // the block's step (tile, chunk) count: stage it & 1
  // wait for step it's stage, then start the copy of the step after it
  auto begin_step = [&](int kc) {
    cp_async_wait_all();
    __syncthreads();  // stage it has landed; stage it + 1's last reader is done
    int nt = t, nkc = kc + 1;
    if (nkc == s.KC) {
      nkc = 0;
      nt += gridDim.x;
    }
    if (nt < s.ntiles) {
      const int nx = (it + 1) & 1;
      load_stage<NB>(sb + nx * G::WS, sb + G::X_OFF + nx * XS, x, wp, s, nt, nkc, stream_w,
                     pass);
      cp_async_commit();
    }
  };

  for (; t < s.ntiles; t += gridDim.x) {
    float acc[MT][NB / 8][4], part[MT][NB / 8][4];
    zero<NB>(acc);
    zero<NB>(part);
    if constexpr (!G::ONE_CHUNK) {
      for (int kc = 0; kc + 1 < s.KC; ++kc, ++it) {
        begin_step(kc);
        stage_products<NB, KS_FULL>(part, sb + (it & 1) * G::WS, sb + G::X_OFF + (it & 1) * XS,
                                    a_row, hi);
        add_chunk<NB>(acc, part);
      }
    }
    begin_step(s.KC - 1);
    stage_products<NB, KT>(part, sb + (stream_w ? (it & 1) * G::WS : 0),
                           sb + G::X_OFF + (it & 1) * XS, a_row, hi);
    add_chunk<NB>(acc, part);
    ++it;

    // the epilogue, from the registers: the warp's m16 tile m is tile row row0 + m
    const int tx = t % s.tiles_x, ty = (t / s.tiles_x) % s.tiles_y, n = t / (s.tiles_x * s.tiles_y);
    const int cb = pass * NB;
    store_out<NB>(y, acc, s.CO, cb, min(NB, s.CO - cb), [&](int m, int r) -> i64 {
      const int h = ty * TH + row0 + m, w = tx * TW + r;
      return h < s.H && w < s.W ? ((i64)n * s.H + h) * s.W + w : -1;
    });
  }
}

// ---- image groups ----

struct GShape {
  int N, H, W, C, CO, KC, G, HW, ntiles;
};

// stage of (group t, K chunk kc): the chunk rows of the group's pixels in
// order (row p + 1 for pixel p; zeros past C and past the last image), and,
// with `weights`, the nine taps' hi and lo blocks of pass `pass`
template <int NB>
__device__ __forceinline__ void load_group(uint32_t ws, uint32_t xs, const float* x,
                                           const float* wp, const GShape& s, int t, int kc,
                                           bool weights, int pass) {
  if (weights) load_weights<NB>(ws, wp, s.KC, kc, pass);
  const i64 n0 = (i64)t * s.G;
  const int npix = (int)(s.N - n0 < s.G ? s.N - n0 : s.G) * s.HW;
  const float* xg = x + n0 * s.HW * s.C + kc * BLK;
  if (s.C % 4 == 0) {  // every 16-byte piece is aligned: inside C whole, or past it
    for (int idx = threadIdx.x; idx < GM * 8; idx += NT) {
      const int p = idx >> 3, piece = idx & 7;
      const bool ok = p < npix && kc * BLK + piece * 4 < s.C;
      cp_async16_zfill(xs + swz128(p + 1, piece), ok ? xg + (i64)p * s.C + piece * 4 : x,
                       ok ? 16 : 0);
    }
  } else {
    // the chunk's cc channels of each pixel, value by value (4-byte copies) in
    // the order they lie in device memory, zeros past them; only the pieces read
    const int cc = min(BLK, s.C - kc * BLK), np4 = 4 * pieces_read(cc);
    for (int idx = threadIdx.x; idx < GM * np4; idx += NT) {
      const int p = idx / np4, c = idx % np4;
      const bool ok = p < npix && c < cc;
      cp_async4_zfill(xs + swz128(p + 1, c >> 2) + (c & 3) * 4, ok ? xg + (i64)p * s.C + c : x,
                      ok ? 4 : 0);
    }
  }
}

// part = the stage's products over KS k8 steps of its K chunk (scale-d 0 on
// each tile's first product): for each tap and m16 tile the fragments (each
// lane's row at a_off[m][tap] of the stage), split, then the tap's blocks
// times them; one wgmma group a (tap, m16 tile)
template <int NB, int KS>
__device__ __forceinline__ void group_products(float (&part)[MT][NB / 8][4], uint32_t ws,
                                               uint32_t xs, const uint32_t (&a_off)[MT][9]) {
  typedef GeoG<NB> G;
  uint32_t ah[2][KS][4], al[2][KS][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int set = (tap * MT + m) & 1;
      // the group that read set `set` two groups ago has completed
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        load_split(ah[set][ks], al[set][ks], (xs + a_off[m][tap]) ^ (ks << 5));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_3x<NB>(part[m], ah[set][ks], al[set][ks],
                     desc_kmajor(ws + tap * G::TAP) + 2 * ks,
                     desc_kmajor(ws + (9 + tap) * G::TAP) + 2 * ks,
                     tap == 0 && ks == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
}

// grid (blocks, passes of this launch), every block resident, the weight
// packed first as in conv3x3_tf32_kernel. x (N, H, W, C), y (N, H, W, CO); a
// tile is images t G .. t G + G - 1; KT: the k8 steps of the last K chunk
template <int NB, int KT>
__global__ void __launch_bounds__(NT, 1)
conv3x3_tf32_groups_kernel(const float* __restrict__ x, Pack pk, float* __restrict__ y,
                           GShape s) {
  typedef GeoG<NB> G;
  extern __shared__ __align__(1024) unsigned char smem[];
  pack_share<NB>(pk, s.C, s.CO, s.KC);
  cooperative_groups::this_grid().sync();
  const float* wp = pk.wp;
  const int pass = pk.p0 + blockIdx.y;
  const uint32_t sb = smem_u32(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool stream_w = s.KC > 1;  // else the block's weights are copied once
  int t = blockIdx.x;
  if (t >= s.ntiles) return;
  // the lane's A row of each m16 tile and tap: its pixel's row shifted by the
  // tap where the shifted pixel is in the same image, else the zero row
  uint32_t a_off[MT][9];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int p = (warp * MT + m) * 16 + (lane & 15), q = p % s.HW;
    const int h = q / s.W, w = q % s.W;
    const bool in = p < s.G * s.HW;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int hh = h + tap / 3 - 1, ww = w + tap % 3 - 1;
      const bool ok = in && hh >= 0 && hh < s.H && ww >= 0 && ww < s.W;
      a_off[m][tap] = swz128(ok ? 1 + p + (tap / 3 - 1) * s.W + (tap % 3 - 1) : 0, lane >> 4);
    }
  }
  if (threadIdx.x < 16)  // the two stages' zero rows, which nothing overwrites
    st_shared_zero16(sb + G::X_OFF + (threadIdx.x >> 3) * G::XG + (threadIdx.x & 7) * 16);
  load_group<NB>(sb, sb + G::X_OFF, x, wp, s, t, 0, true, pass);
  cp_async_commit();

  int it = 0;  // the block's step (group, chunk) count: stage it & 1
  // wait for step it's stage, then start the copy of the step after it
  auto begin_step = [&](int kc) {
    cp_async_wait_all();
    __syncthreads();  // stage it has landed; stage it + 1's last reader is done
    int nt = t, nkc = kc + 1;
    if (nkc == s.KC) {
      nkc = 0;
      nt += gridDim.x;
    }
    if (nt < s.ntiles) {
      const int nx = (it + 1) & 1;
      load_group<NB>(sb + nx * G::WS, sb + G::X_OFF + nx * G::XG, x, wp, s, nt, nkc, stream_w,
                     pass);
      cp_async_commit();
    }
  };

  for (; t < s.ntiles; t += gridDim.x) {
    float acc[MT][NB / 8][4], part[MT][NB / 8][4];
    zero<NB>(acc);
    zero<NB>(part);
    if constexpr (!Geo<NB>::ONE_CHUNK) {
      for (int kc = 0; kc + 1 < s.KC; ++kc, ++it) {
        begin_step(kc);
        group_products<NB, KS_FULL>(part, sb + (it & 1) * G::WS,
                                    sb + G::X_OFF + (it & 1) * G::XG, a_off);
        add_chunk<NB>(acc, part);
      }
    }
    begin_step(s.KC - 1);
    group_products<NB, KT>(part, sb + (stream_w ? (it & 1) * G::WS : 0),
                           sb + G::X_OFF + (it & 1) * G::XG, a_off);
    add_chunk<NB>(acc, part);
    ++it;

    // the epilogue, from the registers: row r of the warp's m16 tile m is the
    // group's pixel (warp MT + m) 16 + r
    const i64 n0 = (i64)t * s.G;
    const int npix = (int)(s.N - n0 < s.G ? s.N - n0 : s.G) * s.HW;
    const int cb = pass * NB;
    store_out<NB>(y, acc, s.CO, cb, min(NB, s.CO - cb), [&](int m, int r) -> i64 {
      const int p = (warp * MT + m) * 16 + r;
      return p < npix ? n0 * s.HW + p : -1;
    });
  }
}

// one cooperative launch of `kernel` (every block resident: the grid barrier
// after the weight's packing needs them all) for each run of passes the card
// holds at once: one launch unless the passes outnumber its slots. A pass's
// slots / passes blocks walk its tiles; where the tiles are fewer, the blocks
// past them pack their share of the weight and end at the barrier (a small
// image's few tiles would pack a large weight slowly alone).
template <class K, class S>
cudaError_t launch_coop(K kernel, int bytes, int (&slots_of)[16], const float* x, Pack pk,
                        float* y, const S& s, int passes, cudaStream_t stream) {
  int slots = 0;
  cudaError_t err = card_slots(kernel, NT, bytes, slots_of, slots);
  for (int p0 = 0; err == cudaSuccess && p0 < passes; p0 += slots) {
    const int py = min(passes - p0, slots), bx = max(1, slots / py);
    pk.p0 = p0;
    void* args[] = {(void*)&x, (void*)&pk, (void*)&y, (void*)const_cast<S*>(&s)};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(bx, py), dim3(NT), args,
                                      (size_t)bytes, stream);
  }
  return err;
}

template <int NB, int KT>
cudaError_t launch(const float* x, const Pack& pk, float* y, const Shape& s, int passes,
                   cudaStream_t stream) {
  static int slots_of[16] = {};
  return launch_coop(conv3x3_tf32_kernel<NB, KT>, Geo<NB>::BYTES, slots_of, x, pk, y, s,
                     passes, stream);
}

template <int NB, int KT>
cudaError_t launch_groups(const float* x, const Pack& pk, float* y, const GShape& s, int passes,
                          cudaStream_t stream) {
  static int slots_of[16] = {};
  return launch_coop(conv3x3_tf32_groups_kernel<NB, KT>, GeoG<NB>::BYTES, slots_of, x, pk, y,
                     s, passes, stream);
}

// the instance of KT in this library's mode: row tiles (shape s) or image
// groups (shape g)
template <int NB>
cudaError_t launch_kt(int KT, const float* x, const Pack& pk, float* y, const Shape& s,
                      const GShape& g, int passes, cudaStream_t stream) {
#define TF32_LAUNCH(kt)                                          \
  case kt:                                                       \
    if constexpr (LIB_GROUPS)                                    \
      return launch_groups<NB, kt>(x, pk, y, g, passes, stream); \
    else                                                         \
      return launch<NB, kt>(x, pk, y, s, passes, stream);
  switch (KT) {
    TF32_LAUNCH(1)
    TF32_LAUNCH(2)
    TF32_LAUNCH(3)
    TF32_LAUNCH(4)
  }
#undef TF32_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (N, H, W, C) and y (N, H, W, CO) contiguous f32 (x 16-byte aligned where
// C % 4 == 0, y 16-byte aligned); w the contiguous f32 weight, (3, 3, C, CO),
// or with rot (3, 3, CO, C), taken rotated (rot180_io); wp an f32 scratch of
// passes * ceil(C / 32) * 2 * 9 * NB * 32 elements, 16-byte aligned, which the
// kernel's blocks fill as kernels/conv3x3.py::pack_weights_tf32 lays it out
// before the conv. call = {N, H, W, C, CO, NB, rot, G}: NB the output channels
// of a pass (a multiple of 8 up to 32, up to 64 where C <= 32;
// kernels/conv3x3.py::tf32_passes), ceil(CO / NB) passes; G 0 for tiles of 16
// x 16 pixels (this file's library), else the images of a tile (the image
// groups, conv3x3_tf32_groups.cu's library: G H W <= 256). One kernel launch
// (more only where the passes outnumber the blocks the card holds at once).
// Returns the launch's CUDA error (0 on success).
int conv3x3_tf32(const void* x, const void* w, void* wp, void* y, const int* call, void* stream) {
  const int N = call[0], H = call[1], W = call[2], C = call[3], CO = call[4], NB = call[5];
  const int rot = call[6], G = call[7];
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || CO <= 0 || NB % 8 != 0 || NB < 8 || NB > 64 ||
      (NB > 32 && C > BLK) || G < 0 || (G > 0) != LIB_GROUPS || (i64)G * H * W > GM)
    return (int)cudaErrorInvalidValue;
  Shape s = {};
  GShape g = {};
  s.N = g.N = N, s.H = g.H = H, s.W = g.W = W, s.C = g.C = C, s.CO = g.CO = CO;
  s.KC = g.KC = (C + BLK - 1) / BLK;
  if (G > 0) {
    g.G = G, g.HW = H * W;
    g.ntiles = (N + G - 1) / G;
  } else {
    s.tiles_x = (W + TW - 1) / TW;
    s.tiles_y = (H + TH - 1) / TH;
    const i64 ntiles = (i64)N * s.tiles_y * s.tiles_x;
    if (ntiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
    s.ntiles = (int)ntiles;
  }
  const int passes = (CO + NB - 1) / NB;
  const int KT = (C - (s.KC - 1) * BLK + 7) / 8;
  if ((i64)passes * s.KC * 2 * 9 * NB * BLK > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Pack pk = {(const float*)w, (float*)wp, rot, 0};
  const float* xf = (const float*)x;
  float* yf = (float*)y;
  cudaStream_t st = (cudaStream_t)stream;
  switch (NB) {
    case 8: return (int)launch_kt<8>(KT, xf, pk, yf, s, g, passes, st);
    case 16: return (int)launch_kt<16>(KT, xf, pk, yf, s, g, passes, st);
    case 24: return (int)launch_kt<24>(KT, xf, pk, yf, s, g, passes, st);
    case 32: return (int)launch_kt<32>(KT, xf, pk, yf, s, g, passes, st);
    case 40: return (int)launch_kt<40>(KT, xf, pk, yf, s, g, passes, st);
    case 48: return (int)launch_kt<48>(KT, xf, pk, yf, s, g, passes, st);
    case 56: return (int)launch_kt<56>(KT, xf, pk, yf, s, g, passes, st);
    case 64: return (int)launch_kt<64>(KT, xf, pk, yf, s, g, passes, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory a block of an NB instance takes (groups 0: row tiles,
// 1: image groups), 0 if none
int conv3x3_tf32_smem_bytes(int NB, int groups) {
  switch (NB) {
#define TF32_BYTES(nb) \
  case nb: return groups ? GeoG<nb>::BYTES : Geo<nb>::BYTES;
    TF32_BYTES(8)
    TF32_BYTES(16)
    TF32_BYTES(24)
    TF32_BYTES(32)
    TF32_BYTES(40)
    TF32_BYTES(48)
    TF32_BYTES(56)
    TF32_BYTES(64)
#undef TF32_BYTES
  }
  return 0;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
