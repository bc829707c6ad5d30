// SAME 3x3 convolution at any channel counts, NHWC input x HWIO weights,
// bfloat16 on the H100's tensor cores: conv3x3_mma.cu's implicit GEMM with C
// and Cout as runtime arguments.
//
// Replaces, for bfloat16 at every (C, Cout) outside {64, 128}^2 (which
// conv3x3_mma.cu's instances take), the Pallas TPU kernels
//   sarssl_tpu/kernels/conv3x3.py::_pallas_conv3x3
//   sarssl_tpu/kernels/conv_s2d.py::_conv_s2d  (the s2d form is the conv of x
//       itself with w: kernels/conv_s2d.py launches this conv on x's C
//       channels, so no block of the expanded weight is multiplied)
// and, at every (C, Cout) in bfloat16, both where the images are smaller than
// a row tile (below: the image groups).
//
//   y[n, h, w, co] = sum_{dh, dw, ci} x[n, h+dh-1, w+dw-1, ci] * wt[dh, dw, ci, co]
//
// with zeros outside the image, f32 sums, y in bf16. Any N, H, W, C, Cout.
// (float32 runs conv3x3.cu, whose conv3x3_any_kernel, f32 FMAs, stays as the
// yardstick this kernel is timed against.)
//
// What bounds it on an H100: at (16, 64, 64) 256 -> 256 the conv moves 67 MB
// (0.020 ms at 3.35 TB/s) and does 77.3 GFLOP (0.078 ms at 989 TFLOP/s):
// operations. At 3 -> 64 it is bytes (the 3 input channels are 1/22 of the
// output's). The design, conv3x3_mma.cu's where it carries over:
//  * Implicit GEMM, no im2col copy. One persistent block of 8 warps (two
//    warpgroups) an SM walks output tiles of 16 x 16 pixels; a warp owns two
//    rows of 16 pixels (two m16 tiles). The input tile with its halo, 18 x 18
//    pixels, sits in shared memory as 128-byte chunk rows of 64 channels,
//    zero-filled outside the image (the SAME padding), its 16-byte pieces
//    XOR-swizzled with the pixel index so ldmatrix and cp.async are free of
//    bank conflicts. A tap (dh, dw) is a shift of the chunk-row index:
//    ldmatrix reads the shifted A fragment straight from the tile, and the
//    fragment of input row r serves output rows r, r - 1, r - 2.
//  * C at run time: the block walks C in K chunks of 64 channels, each chunk
//    a stage of (input tile, the nine taps' weights), double-buffered: the
//    copy of the next (tile, chunk) runs under the products of this one.
//    The last chunk's channels past C are zero in shared memory, and it runs
//    only the KT = ceil(tail / 16) k16 steps it needs: KT is a template
//    argument (an instance a tail), since a branch around a wgmma would
//    serialise the pipeline. Where C % 8 != 0 a pixel row is not 16-byte
//    aligned in device memory, so the tile is copied value by value.
//  * Cout at run time: a block computes one pass of NB output channels
//    (blockIdx.y), NB a multiple of 8 up to 64: wgmma's N. The wrapper takes
//    ceil(Cout / 64) passes of NB = 8 ceil(Cout / passes / 8)
//    (kernels/conv3x3.py::any_mma_passes), so 3 channels run N = 8 and 160
//    run three passes of 56: the products past Cout are at most 7 columns a
//    pass.
//  * wgmma.mma_async.m64nNk16 (bf16 -> f32) with A from registers and B, the
//    tap's NB x 64 weight block ([co][ci], ci contiguous: K-major), in shared
//    memory in the 128-byte swizzle; a k16 step is the descriptor's start
//    advanced by 32 bytes. The loop over rows, taps and k is straight-line
//    code; two sets of A fragments alternate so that the ldmatrix of one step
//    runs under the products of the one before.
//  * The epilogue rounds the accumulators to bf16 into the input buffer just
//    consumed and writes whole 16-byte pieces of each pixel's NB channels;
//    where Cout % 8 != 0 (a pixel's output row is not 16-byte aligned) value
//    by value, masked to Cout.
//  * A first kernel packs the HWIO weight into (passes, chunks, 9, NB, 64)
//    blocks, zero-padded, into a scratch the wrapper allocates
//    (kernels/conv3x3.py::pack_weights_any is its plain version); for dx it
//    reads the weight rotated 180 degrees with its channels swapped
//    (rot180_io) in the same pass. One entry call launches both, so a small
//    conv costs one host call. No atomics: results are bit-identical from run
//    to run.
//
// Image groups (conv3x3_any_mma_groups_kernel). A row tile of 16 x 16 output
// pixels holds one image of 4 x 8 with 1/8 of its products, copies and
// epilogue inside the image. Where images are that small (the wrapper's rule,
// kernels/conv3x3.py::conv_tiling) a tile is instead G consecutive whole
// images, G = floor(256 / (H W)), so that its 256 output rows (two
// warpgroups x m64, MT = 2 m16 tiles a warp) are nearly all inside an image:
//  * Staging: the group's pixels are G H W consecutive rows of x, so a stage
//    is their chunk rows in order, one linear read (16-byte cp.async where C
//    % 8 == 0; else one value a thread, consecutive threads on consecutive
//    values of the span, zeros written past C), swizzled as above, and no
//    halo: row 0 of a stage is a chunk row of zeros that every tap outside an
//    image reads.
//  * Products: ldmatrix takes one row address per lane, so each lane points
//    at its own pixel's row shifted by the tap, dh (W) + dw, or at the zero
//    row; the 18 addresses (MT tiles x 9 taps) are fixed for the kernel's
//    life and computed once. A fragment serves one tap of one m16 tile (no
//    reuse across rows as above: 2 x 9 x KS ldmatrix a warp a K chunk, 4 x 3
//    x KS in the row tile), and each tap's two m16 tiles are one wgmma group.
//  * Weights: with one K chunk (C <= 64) a block's weights never change, so
//    they are copied once and the stages carry the pixels alone; with more,
//    every stage carries its chunk's nine blocks, as above.
//  * Epilogue: staged past the zero row of the input buffer just consumed,
//    then each real pixel's NB channels written; the missing images of a
//    ragged last group are zeros in shared memory and masked here.
//
// Two libraries: this file builds the row-tile kernels and
// conv3x3_any_mma_groups.cu, which includes it with CONV_ANY_MMA_GROUPS = 1,
// the image-group kernels, so that the two halves compile in parallel. Both
// export the same C entries; each takes its own mode (G == 0 here, G > 0 there).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_common.cuh"

#ifndef CONV_ANY_MMA_GROUPS
#define CONV_ANY_MMA_GROUPS 0
#endif

namespace {

constexpr bool LIB_GROUPS = CONV_ANY_MMA_GROUPS != 0;  // this library's tile mode

typedef __nv_bfloat16 bf16;
typedef long long i64;

constexpr int NT = 256, NWARP = NT / 32;
constexpr int TH = 16, TW = 16;     // output rows, columns of a tile
constexpr int MT = 2;               // m16 tiles (tile rows) a warp
constexpr int XR = TH + 2, XC = TW + 2;  // input tile rows, columns (halo included)
constexpr int BLK = 64;             // channels of a K chunk
constexpr int ROWB = BLK * 2;       // bytes of a chunk row
constexpr int XS = XR * XC * ROWB;  // bytes of an input stage
static_assert(NWARP * MT == TH, "the warps' m16 tiles cover the tile's rows");
static_assert(XS % 128 == 0, "input stages start 128-byte aligned");

template <int NB>
struct Geo {
  static_assert(NB % 8 == 0 && NB >= 8 && NB <= 64, "wgmma's N: a multiple of 8 up to 64");
  static constexpr int TAP = NB * ROWB;  // bytes of a tap's weight block (1024-byte multiple)
  static constexpr int WS = 9 * TAP;     // bytes of a weight stage
  static constexpr int X_OFF = 2 * WS;   // the two weight stages, then the two input stages
  static constexpr int BYTES = X_OFF + 2 * XS;
  static constexpr int PS = NB + 8;      // staged output pitch (bf16): conflict-free writes
  static_assert(TH * TW * PS * 2 <= XS, "the staged output fits an input stage");
  static_assert(BYTES <= 232448, "over the shared memory a block may use");
};

// d (64 x NB, f32: this warp's 16 rows as NB / 8 m16n8 tiles) += a (64 x 16
// bf16, this warp's 16 rows as an m16k16 fragment) * b (16 x NB in shared
// memory, K-major)
template <int NB>
__device__ __forceinline__ void wgmma_bk(float (&d)[NB / 8][4], const uint32_t (&a)[4],
                                         uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_bk<8>(float (&d)[1][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, "
      "%6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bk<16>(float (&d)[2][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bk<24>(float (&d)[3][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bk<32>(float (&d)[4][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, "
      "1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bk<40>(float (&d)[5][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, "
      "%22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bk<48>(float (&d)[6][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bk<56>(float (&d)[7][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bk<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "
      "p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Descriptor of an NB x 64 weight block: rows of 128 bytes (64 k values,
// K-major) in the 128-byte swizzle, eight rows a 1024-byte period (the
// stride field); `addr` a multiple of 1024. A k16 step adds 32 bytes to the
// start address (2 in the field's 16-byte units).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of 16-byte piece `piece` of row `idx` (a pixel's chunk, or a
// weight block's output channel) in the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int idx, int piece) {
  return (uint32_t)(idx * ROWB + ((piece ^ (idx & 7)) << 4));
}

struct Shape {
  int N, H, W, C, CO, KC, tiles_x, tiles_y, ntiles;
};

// stage of (tile t, K chunk kc): the input tile's chunk rows, halo included,
// zeros outside the image and past C, and the nine taps' NB x 64 blocks of
// pass blockIdx.y
template <int NB>
__device__ __forceinline__ void load_stage(uint32_t ws, uint32_t xs, const bf16* x,
                                           const bf16* wp, const Shape& s, int t, int kc) {
  const bf16* wsrc = wp + ((i64)blockIdx.y * s.KC + kc) * 9 * NB * BLK;
  for (int idx = threadIdx.x; idx < 9 * NB * 8; idx += NT) {
    const int row = idx >> 3, piece = idx & 7;
    cp_async16(ws + swz(row, piece), wsrc + (i64)row * BLK + piece * 8);
  }
  const int tx = t % s.tiles_x, ty = (t / s.tiles_x) % s.tiles_y, n = t / (s.tiles_x * s.tiles_y);
  const int h0 = ty * TH - 1, w0 = tx * TW - 1;
  const bf16* xn = x + (i64)n * s.H * s.W * s.C;
  if (s.C % 8 == 0) {  // every 16-byte piece is aligned: inside C whole, or past it
    for (int idx = threadIdx.x; idx < XR * XC * 8; idx += NT) {
      const int rc = idx >> 3, piece = idx & 7, h = h0 + rc / XC, w = w0 + rc % XC;
      const int ch = kc * BLK + piece * 8;
      const bool ok = h >= 0 && h < s.H && w >= 0 && w < s.W && ch < s.C;
      cp_async16_zfill(xs + swz(rc, piece), ok ? xn + ((i64)h * s.W + w) * s.C + ch : x,
                       ok ? 16 : 0);
    }
  } else {  // value by value, zeros past C
    for (int idx = threadIdx.x; idx < XR * XC * 8; idx += NT) {
      const int rc = idx >> 3, piece = idx & 7, h = h0 + rc / XC, w = w0 + rc % XC;
      const int ch = kc * BLK + piece * 8;
      const bool in = h >= 0 && h < s.H && w >= 0 && w < s.W;
      const bf16* src = xn + ((i64)h * s.W + w) * s.C + ch;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned short lo =
            in && ch + 2 * e < s.C ? __bfloat16_as_ushort(src[2 * e]) : (unsigned short)0;
        const unsigned short hi =
            in && ch + 2 * e + 1 < s.C ? __bfloat16_as_ushort(src[2 * e + 1]) : (unsigned short)0;
        v[e] = (uint32_t)lo | ((uint32_t)hi << 16);
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(xs + swz(rc, piece)),
                   "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
    }
  }
}

// acc += the stage's products over KS k16 steps of its K chunk: for input
// row rr of the warp's MT + 2 and tap column dw the fragments are loaded once
// and multiplied into output rows rr - dh with tap (dh, dw)'s block
template <int NB, int KS>
__device__ __forceinline__ void stage_products(float (&acc)[MT][NB / 8][4], uint32_t ws,
                                               uint32_t xs, int a_row, int hi) {
  typedef Geo<NB> G;
  uint32_t a[2][KS][4];
#pragma unroll
  for (int rr = 0; rr < MT + 2; ++rr) {
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int set = (rr * 3 + dw) & 1;
      const uint32_t a_addr = xs + swz(a_row + rr * XC + dw, hi);
      // the group that read a[set] two groups ago has completed
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(a[set][ks], a_addr ^ (ks << 5));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const int m = rr - dh;  // known when unrolled: no branch is left
          if (m >= 0 && m < MT)
            wgmma_bk<NB>(acc[m], a[set][ks], desc_kmajor(ws + (dh * 3 + dw) * G::TAP) + 2 * ks);
        }
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
}

// grid (blocks, passes). x (N, H, W, C), y (N, H, W, CO), wp (passes, KC, 9,
// NB, 64) zero-padded; KT: the k16 steps of the last K chunk
template <int NB, int KT>
__global__ void __launch_bounds__(NT, 1)
conv3x3_any_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                       bf16* __restrict__ y, Shape s) {
  typedef Geo<NB> G;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * MT;
  // the lane's A row at tap offset 0 in the warp's first m16 tile
  const int a_row = row0 * XC + (lane & 15), hi = lane >> 4;
  int t = blockIdx.x;
  if (t >= s.ntiles) return;
  load_stage<NB>(sb, sb + G::X_OFF, x, wp, s, t, 0);
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
      load_stage<NB>(sb + nx * G::WS, sb + G::X_OFF + nx * XS, x, wp, s, nt, nkc);
      cp_async_commit();
    }
  };

  for (; t < s.ntiles; t += gridDim.x) {
    float acc[MT][NB / 8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n8 = 0; n8 < NB / 8; ++n8)
        acc[m][n8][0] = acc[m][n8][1] = acc[m][n8][2] = acc[m][n8][3] = 0.f;
    for (int kc = 0; kc + 1 < s.KC; ++kc, ++it) {
      begin_step(kc);
      stage_products<NB, 4>(acc, sb + (it & 1) * G::WS, sb + G::X_OFF + (it & 1) * XS, a_row,
                            hi);
    }
    begin_step(s.KC - 1);
    stage_products<NB, KT>(acc, sb + (it & 1) * G::WS, sb + G::X_OFF + (it & 1) * XS, a_row,
                           hi);

    // the epilogue, staged in the input buffer just consumed
    __syncthreads();  // every warp has read it
    unsigned char* stg = smem + G::X_OFF + (it & 1) * XS;
    ++it;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int p0 = (row0 + m) * TW;
#pragma unroll
      for (int n8 = 0; n8 < NB / 8; ++n8) {
        *reinterpret_cast<uint32_t*>(stg + ((p0 + g) * G::PS + 8 * n8 + 2 * q) * 2) =
            pack2(acc[m][n8][0], acc[m][n8][1]);
        *reinterpret_cast<uint32_t*>(stg + ((p0 + g + 8) * G::PS + 8 * n8 + 2 * q) * 2) =
            pack2(acc[m][n8][2], acc[m][n8][3]);
      }
    }
    __syncthreads();
    const int tx = t % s.tiles_x, ty = (t / s.tiles_x) % s.tiles_y, n = t / (s.tiles_x * s.tiles_y);
    const int cb = blockIdx.y * NB, nvalid = min(NB, s.CO - cb);
    for (int idx = threadIdx.x; idx < TH * TW * (NB / 8); idx += NT) {
      const int pix = idx / (NB / 8), piece = idx % (NB / 8);
      const int h = ty * TH + pix / TW, w = tx * TW + pix % TW, c0 = piece * 8;
      if (h >= s.H || w >= s.W || c0 >= nvalid) continue;
      const unsigned char* src = stg + (pix * G::PS + c0) * 2;
      bf16* dst = y + (((i64)n * s.H + h) * s.W + w) * s.CO + cb + c0;
      if (s.CO % 8 == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && c0 + e < nvalid; ++e)
          dst[e] = reinterpret_cast<const bf16*>(src)[e];
      }
    }
  }
}

// ---- image groups ----

constexpr int GM = NWARP * MT * 16;  // output pixels (rows of A) of a group tile

template <int NB>
struct GeoG {
  static constexpr int TAP = Geo<NB>::TAP;
  static constexpr int WS = Geo<NB>::WS;
  static constexpr int PS = Geo<NB>::PS;
  // an input stage: the zero chunk row, then GM chunk rows, or the staged
  // output (GM rows of PS values) that the epilogue writes past the zero row
  static constexpr int XG = ROWB + (GM * ROWB > GM * PS * 2 ? GM * ROWB : GM * PS * 2);
  static constexpr int X_OFF = 2 * WS;
  static constexpr int BYTES = X_OFF + 2 * XG;
  static_assert(XG % 128 == 0, "input stages start 128-byte aligned");
  static_assert(BYTES <= 232448, "over the shared memory a block may use");
};

// 16 zero bytes at shared address `addr`
__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(0), "r"(0), "r"(0),
               "r"(0));
}

struct GShape {
  int N, H, W, C, CO, KC, G, HW, ntiles;
};

// stage of (group t, K chunk kc): the chunk rows of the group's pixels in
// order (row p + 1 for pixel p; zeros past C and past the last image), and,
// with `weights`, the nine taps' NB x 64 blocks of pass blockIdx.y
template <int NB>
__device__ __forceinline__ void load_group(uint32_t ws, uint32_t xs, const bf16* x,
                                           const bf16* wp, const GShape& s, int t, int kc,
                                           bool weights) {
  if (weights) {
    const bf16* wsrc = wp + ((i64)blockIdx.y * s.KC + kc) * 9 * NB * BLK;
    for (int idx = threadIdx.x; idx < 9 * NB * 8; idx += NT) {
      const int row = idx >> 3, piece = idx & 7;
      cp_async16(ws + swz(row, piece), wsrc + (i64)row * BLK + piece * 8);
    }
  }
  const i64 n0 = (i64)t * s.G;
  const int npix = (int)(s.N - n0 < s.G ? s.N - n0 : s.G) * s.HW;
  const bf16* xg = x + n0 * s.HW * s.C + kc * BLK;
  if (s.C % 8 == 0) {  // every 16-byte piece is aligned: inside C whole, or past it
    for (int idx = threadIdx.x; idx < GM * 8; idx += NT) {
      const int p = idx >> 3, piece = idx & 7;
      const bool ok = p < npix && kc * BLK + piece * 8 < s.C;
      cp_async16_zfill(xs + swz(p + 1, piece), ok ? xg + (i64)p * s.C + piece * 8 : x,
                       ok ? 16 : 0);
    }
  } else {
    // the chunk's cc channels of each pixel, value by value in the order they
    // lie in device memory (one span where C < 64); zeros past them
    const int cc = min(BLK, s.C - kc * BLK), cc8 = (cc + 7) & ~7;
    for (int idx = threadIdx.x; idx < GM * 8; idx += NT) {
      const int p = idx >> 3, piece = idx & 7;
      if (p >= npix || piece * 8 >= cc8) st_shared_zero16(xs + swz(p + 1, piece));
    }
    if (cc8 > cc)
      for (int idx = threadIdx.x; idx < npix * (cc8 - cc); idx += NT) {
        const int p = idx / (cc8 - cc), c = cc + idx % (cc8 - cc);
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(xs + swz(p + 1, c >> 3) + (c & 7) * 2),
                     "h"((unsigned short)0));
      }
    for (int e = threadIdx.x; e < npix * cc; e += NT) {
      const int p = e / cc, c = e % cc;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(xs + swz(p + 1, c >> 3) + (c & 7) * 2),
                   "h"(__bfloat16_as_ushort(xg[(i64)p * s.C + c])));
    }
  }
}

// acc += the stage's products over KS k16 steps of its K chunk: for each tap
// the fragments of the warp's MT m16 tiles, each lane's row at a_off[m][tap]
// of the stage, then the tap's block times each
template <int NB, int KS>
__device__ __forceinline__ void group_products(float (&acc)[MT][NB / 8][4], uint32_t ws,
                                               uint32_t xs, const uint32_t (&a_off)[MT][9]) {
  typedef GeoG<NB> G;
  uint32_t a[2][MT][KS][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int set = tap & 1;
    // the group that read a[set] two groups ago has completed
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(a[set][m][ks], (xs + a_off[m][tap]) ^ (ks << 5));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        wgmma_bk<NB>(acc[m], a[set][m][ks], desc_kmajor(ws + tap * G::TAP) + 2 * ks);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
}

// grid (blocks, passes). x (N, H, W, C), y (N, H, W, CO), wp (passes, KC, 9,
// NB, 64) zero-padded; a tile is images t G .. t G + G - 1; KT: the k16 steps
// of the last K chunk
template <int NB, int KT>
__global__ void __launch_bounds__(NT, 1)
conv3x3_any_mma_groups_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                              bf16* __restrict__ y, GShape s) {
  typedef GeoG<NB> G;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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
      a_off[m][tap] = swz(ok ? 1 + p + (tap / 3 - 1) * s.W + (tap % 3 - 1) : 0, lane >> 4);
    }
  }
  if (threadIdx.x < 16)  // the two stages' zero rows, which nothing overwrites
    st_shared_zero16(sb + G::X_OFF + (threadIdx.x >> 3) * G::XG + (threadIdx.x & 7) * 16);
  const bool stream_w = s.KC > 1;  // else the weights are copied once, into stage 0
  load_group<NB>(sb, sb + G::X_OFF, x, wp, s, t, 0, true);
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
      load_group<NB>(sb + nx * G::WS, sb + G::X_OFF + nx * G::XG, x, wp, s, nt, nkc, stream_w);
      cp_async_commit();
    }
  };

  for (; t < s.ntiles; t += gridDim.x) {
    float acc[MT][NB / 8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n8 = 0; n8 < NB / 8; ++n8)
        acc[m][n8][0] = acc[m][n8][1] = acc[m][n8][2] = acc[m][n8][3] = 0.f;
    for (int kc = 0; kc + 1 < s.KC; ++kc, ++it) {
      begin_step(kc);
      group_products<NB, 4>(acc, sb + (it & 1) * G::WS, sb + G::X_OFF + (it & 1) * G::XG, a_off);
    }
    begin_step(s.KC - 1);
    group_products<NB, KT>(acc, sb + (stream_w ? (it & 1) * G::WS : 0),
                           sb + G::X_OFF + (it & 1) * G::XG, a_off);

    // the epilogue, staged past the zero row of the input buffer just consumed
    __syncthreads();  // every warp has read it
    unsigned char* stg = smem + G::X_OFF + (it & 1) * G::XG + ROWB;
    ++it;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int p0 = (warp * MT + m) * 16;
#pragma unroll
      for (int n8 = 0; n8 < NB / 8; ++n8) {
        *reinterpret_cast<uint32_t*>(stg + ((p0 + g) * G::PS + 8 * n8 + 2 * q) * 2) =
            pack2(acc[m][n8][0], acc[m][n8][1]);
        *reinterpret_cast<uint32_t*>(stg + ((p0 + g + 8) * G::PS + 8 * n8 + 2 * q) * 2) =
            pack2(acc[m][n8][2], acc[m][n8][3]);
      }
    }
    __syncthreads();
    const i64 n0 = (i64)t * s.G;
    const int npix = (int)(s.N - n0 < s.G ? s.N - n0 : s.G) * s.HW;
    const int cb = blockIdx.y * NB, nvalid = min(NB, s.CO - cb);
    bf16* yg = y + n0 * s.HW * s.CO + cb;
    for (int idx = threadIdx.x; idx < npix * (NB / 8); idx += NT) {
      const int pix = idx / (NB / 8), c0 = idx % (NB / 8) * 8;
      if (c0 >= nvalid) continue;
      const unsigned char* src = stg + (pix * G::PS + c0) * 2;
      bf16* dst = yg + (i64)pix * s.CO + c0;
      if (s.CO % 8 == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && c0 + e < nvalid; ++e)
          dst[e] = reinterpret_cast<const bf16*>(src)[e];
      }
    }
  }
}

// wp[p][k][tap][n][c] = wt[tap][k * 64 + c][p * NB + n], zero past C and CO,
// with wt = w (3, 3, C, CO) or, with rot, rot180_io of w (3, 3, CO, C):
// wt[dh][dw][ci][co] = w[2 - dh][2 - dw][co][ci]
__global__ void __launch_bounds__(256)
pack_weights_kernel(const bf16* __restrict__ w, bf16* __restrict__ wp, int C, int CO, int KC,
                    int NB, int rot, int total) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const int c = i % BLK, n = i / BLK % NB, tap = i / (BLK * NB) % 9;
  const int k = i / (BLK * NB * 9) % KC, p = i / (BLK * NB * 9 * KC);
  const int ci = k * BLK + c, co = p * NB + n;
  bf16 v = __float2bfloat16(0.f);
  if (ci < C && co < CO)
    v = rot ? w[((i64)(8 - tap) * CO + co) * C + ci] : w[((i64)tap * C + ci) * CO + co];
  wp[i] = v;
}

// the blocks the card holds at once of `kernel` with `bytes` of shared memory,
// found on the first call for each device (the shared-memory attribute is set
// there too); `slots_of` is the kernel's own table
template <class K>
cudaError_t card_slots(K kernel, int bytes, int (&slots_of)[16], int& slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 16) return cudaErrorInvalidDevice;
  if (slots_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    bytes)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, bytes)) !=
            cudaSuccess)
      return err;
    slots_of[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  slots = slots_of[dev];
  return cudaSuccess;
}

template <int NB, int KT>
cudaError_t launch(const bf16* x, const bf16* wp, bf16* y, const Shape& s, int passes,
                   cudaStream_t stream) {
  typedef Geo<NB> G;
  auto kernel = conv3x3_any_mma_kernel<NB, KT>;
  static int slots_of[16] = {};
  int slots = 0;
  const cudaError_t err = card_slots(kernel, G::BYTES, slots_of, slots);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(s.ntiles < slots ? s.ntiles : slots), passes);
  kernel<<<grid, NT, G::BYTES, stream>>>(x, wp, y, s);
  return cudaGetLastError();
}

template <int NB, int KT>
cudaError_t launch_groups(const bf16* x, const bf16* wp, bf16* y, const GShape& s, int passes,
                          cudaStream_t stream) {
  typedef GeoG<NB> G;
  auto kernel = conv3x3_any_mma_groups_kernel<NB, KT>;
  static int slots_of[16] = {};
  int slots = 0;
  const cudaError_t err = card_slots(kernel, G::BYTES, slots_of, slots);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(s.ntiles < slots ? s.ntiles : slots), passes);
  kernel<<<grid, NT, G::BYTES, stream>>>(x, wp, y, s);
  return cudaGetLastError();
}

// the instance of KT in this library's mode: row tiles (shape s) or image
// groups (shape g)
template <int NB>
cudaError_t launch_kt(int KT, const bf16* x, const bf16* wp, bf16* y, const Shape& s,
                      const GShape& g, int passes, cudaStream_t stream) {
#define ANY_MMA_LAUNCH(kt)                                       \
  case kt:                                                       \
    if constexpr (LIB_GROUPS)                                    \
      return launch_groups<NB, kt>(x, wp, y, g, passes, stream); \
    else                                                         \
      return launch<NB, kt>(x, wp, y, s, passes, stream);
  switch (KT) {
    ANY_MMA_LAUNCH(1)
    ANY_MMA_LAUNCH(2)
    ANY_MMA_LAUNCH(3)
    ANY_MMA_LAUNCH(4)
  }
#undef ANY_MMA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (N, H, W, C) and y (N, H, W, CO) contiguous bf16 (x 16-byte aligned where
// C % 8 == 0, y 16-byte aligned); w the contiguous bf16 weight, (3, 3, C, CO),
// or with rot (3, 3, CO, C), taken rotated (rot180_io); NB the output channels
// of a pass (a multiple of 8 up to 64; kernels/conv3x3.py::any_mma_passes),
// ceil(CO / NB) passes; G 0 for tiles of 16 x 16 pixels (this file's library),
// else the images of a tile (the image groups, conv3x3_any_mma_groups.cu's
// library: G H W <= 256); wp a bf16 scratch of passes * ceil(C /
// 64) * 9 * NB * 64 elements, 16-byte aligned, which the first kernel fills as
// kernels/conv3x3.py::pack_weights_any lays it out. Returns
// cudaGetLastError() after the launches (0 on success).
int conv3x3_any_mma(const void* x, const void* w, void* wp, void* y, int N, int H, int W, int C,
                    int CO, int NB, int rot, int G, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || CO <= 0 || NB % 8 != 0 || NB < 8 || NB > 64 ||
      G < 0 || (G > 0) != LIB_GROUPS || (i64)G * H * W > GM)
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
  const int KT = (C - (s.KC - 1) * BLK + 15) / 16;
  const bf16 *xb = (const bf16*)x, *wb = (const bf16*)wp;
  bf16* yb = (bf16*)y;
  cudaStream_t st = (cudaStream_t)stream;
  const i64 total64 = (i64)passes * s.KC * 9 * NB * BLK;
  if (total64 > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int total = (int)total64;
  pack_weights_kernel<<<(total + 255) / 256, 256, 0, st>>>((const bf16*)w, (bf16*)wp, C, CO,
                                                           s.KC, NB, rot, total);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (NB) {
    case 8: return (int)launch_kt<8>(KT, xb, wb, yb, s, g, passes, st);
    case 16: return (int)launch_kt<16>(KT, xb, wb, yb, s, g, passes, st);
    case 24: return (int)launch_kt<24>(KT, xb, wb, yb, s, g, passes, st);
    case 32: return (int)launch_kt<32>(KT, xb, wb, yb, s, g, passes, st);
    case 40: return (int)launch_kt<40>(KT, xb, wb, yb, s, g, passes, st);
    case 48: return (int)launch_kt<48>(KT, xb, wb, yb, s, g, passes, st);
    case 56: return (int)launch_kt<56>(KT, xb, wb, yb, s, g, passes, st);
    case 64: return (int)launch_kt<64>(KT, xb, wb, yb, s, g, passes, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory a block of an NB instance takes (groups 0: row tiles,
// 1: image groups), 0 if none
int conv3x3_any_mma_smem_bytes(int NB, int groups) {
  switch (NB) {
#define ANY_MMA_BYTES(nb) \
  case nb: return groups ? GeoG<nb>::BYTES : Geo<nb>::BYTES;
    ANY_MMA_BYTES(8)
    ANY_MMA_BYTES(16)
    ANY_MMA_BYTES(24)
    ANY_MMA_BYTES(32)
    ANY_MMA_BYTES(40)
    ANY_MMA_BYTES(48)
    ANY_MMA_BYTES(56)
    ANY_MMA_BYTES(64)
#undef ANY_MMA_BYTES
  }
  return 0;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
