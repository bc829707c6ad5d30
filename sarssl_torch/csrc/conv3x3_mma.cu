// SAME 3x3 convolution, NHWC input x HWIO weights, bfloat16 on the H100's
// tensor cores: an implicit GEMM that never builds an im2col copy.
//
// Replaces both Pallas TPU conv kernels for bfloat16 (float32 stays on the FMA
// kernel of conv3x3.cu: f32 on the tensor cores would be TF32):
//   sarssl_tpu/kernels/conv3x3.py::_pallas_conv3x3  (C = Cout = 64)
//   sarssl_tpu/kernels/conv_s2d.py::_conv_s2d       (the same conv over the free
//       W-space-to-depth view (B, H, W/2, 2C), whose expanded (3, 3, 2C, 2C)
//       weight is half zeros. With the zero blocks left out, output block q of
//       view pixel p takes w[dh, 0..2] on the C-channel blocks 2p + q - 1 ..
//       2p + q + 1 of the row: block for block the C-channel conv of x, in the
//       same memory. So the s2d launch is this conv of x itself, the C = 64
//       instance below at C = 64; kernels/conv_s2d.py derives that from its
//       table of existing blocks.)
//
//   y[n, h, w, co] = sum_{dh, dw, ci} x[n, h+dh-1, w+dw-1, ci] * wt[dh, dw, ci, co]
//
// with zeros outside the image, f32 sums, y in bf16. Any N, H, W; C and Cout
// in {64, 128}.
//
// What bounds it on an H100: at (128, 256, 256, 64) the conv moves 2.15 GB
// (0.64 ms at 3.35 TB/s) and does 618.5 GFLOP (0.63 ms at 989 TFLOP/s): the
// two bounds are equal, so copies and products have to run at the same time.
// With 64 output channels a product reads as many bytes of B from shared
// memory as of A (64 + 64 of the SM's 128 bytes a clock at the tensor cores'
// peak), so every A fragment that is loaded has to be used more than once.
//
// Design. Everything is counted in chunks of 64 channels, 128 bytes: a pixel
// is KH = C / 64 chunks, an image row W * KH chunks, the weight 9 * KH * NH
// blocks of 64 x 64 (NH = Cout / 64).
//  * One persistent block of 8 warps per SM walks over output tiles of 16
//    rows. The 9 * KH weight blocks of one output chunk are copied into shared
//    memory once (Cout = 128 is two passes over x, blockIdx.y); the input
//    tile, halo included, is a matrix of 128-byte chunk rows, copied with
//    cp.async (zero-filled outside the image: that is the SAME padding) and,
//    where it fits, double-buffered: the copy of the next tile runs under the
//    products of this one.
//  * A tap (dh, j) and K-chunk kh are nothing but a shift of the chunk-row
//    index: ldmatrix takes a row address per lane, so the A fragment of a
//    shifted tap is read straight from the tile. The 16-byte pieces of a chunk
//    row are XOR-swizzled with the index of its pixel, so eight consecutive
//    pixels fall into eight different bank groups and every ldmatrix and every
//    cp.async is conflict-free.
//  * The products are wgmma.mma_async.m64n64k16 (bf16 -> f32) with A FROM
//    REGISTERS and B from shared memory. Each warp of a warpgroup loads its
//    16 x 16 fragment of A with the shifted ldmatrix above, so no
//    shared-memory descriptor ever points into the middle of a swizzle
//    pattern; B, a 16 x 64 slab of a weight block ([ci][co], co contiguous:
//    the transposed form), sits at a multiple of 1024 bytes in the 128-byte
//    swizzle and is described by its address alone.
//  * A warp's MT m16 tiles (MT = 4: 128 f32 accumulators a thread) are 16
//    pixels of MT consecutive tile rows. The fragment of input row r and tap
//    column j is loaded once and multiplied into output rows r, r - 1, r - 2
//    with the blocks dh = 0, 1, 2: half the ldmatrix traffic of loading it per
//    tap. The loop over rows, columns and k is straight-line code (a branch
//    around a product serialises the wgmma pipeline); two sets of fragments
//    alternate, so the ldmatrix of one step runs under the products of the
//    one before.
//  * The epilogue rounds the accumulators to bf16 into the tile buffer that
//    was just consumed and writes whole 128-byte rows, 16 bytes a thread.
//  * No atomics: results are bit-identical from run to run.
//
// Two instances <KH, MT, STAGES> (232,448 bytes of shared memory a block may
// use; both take 230,400):
//   <1, 4, 2>  C = 64 and the s2d form: tile 16 x 32 pixels, 9 blocks, two tile
//              buffers.
//   <2, 2, 1>  C = 128: 18 blocks (the 36 of Cout = 128 would be 295 KB), tile
//              16 x 16 pixels, one tile buffer.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef long long i64;

constexpr int NT = 256, NWARP = NT / 32;
constexpr int TH = 16;            // output rows per tile
constexpr int BLK = 64;           // channels per chunk
constexpr int ROWB = BLK * 2;     // bytes per chunk row
constexpr int WBLK = BLK * ROWB;  // bytes per weight block
constexpr int MTB = 16 * ROWB;    // bytes of one staged m16 tile

template <int KH, int MT, int STAGES>
struct Geo {
  static constexpr int TPR = NWARP * MT / TH;   // m16 tiles per tile row
  static constexpr int TWP = 16 * TPR;          // pixels per tile row
  static constexpr int RS = (TWP + 2) * KH;     // chunk rows per tile row, halo included
  static constexpr int SH = KH == 2 ? 1 : 0;    // log2 of chunks per pixel
  static constexpr int TILE = (TH + 2) * RS * ROWB;
  static constexpr int NSLOT = 9 * KH;          // weight blocks of one output chunk
  static constexpr int X_OFF = NSLOT * WBLK;
  static constexpr int BYTES = X_OFF + STAGES * TILE;
  static_assert(NWARP * MT == TH * TPR, "the warps' m16 tiles cover the tile");
  static_assert(NWARP * MT * MTB <= TILE, "the staged output fits a tile buffer");
  static_assert(BYTES <= 232448, "over the shared memory a block may use");
};

// Descriptor of a 16 (k) x 64 (n) slab of a weight block: rows of 128 bytes
// with n contiguous (the transposed, "MN-major" form), eight rows a 1024-byte
// period of the 128-byte swizzle, which is chunk_off<0>'s XOR; the next eight
// k rows follow 1024 bytes on (the stride field). `addr` is a multiple of 1024.
__device__ __forceinline__ uint64_t wgmma_desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// d (64 x 64, f32: this warp's 16 rows, laid out as eight m16n8 tiles) +=
// a (64 x 16 bf16, this warp's 16 rows as an m16k16 fragment) * b (16 x 64 in
// shared memory, transposed form)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// byte offset of 16-byte piece `piece` of chunk row `idx` in a tile
template <int SH>
__device__ __forceinline__ uint32_t chunk_off(int idx, int piece) {
  return (uint32_t)(idx * ROWB + ((piece ^ ((idx >> SH) & 7)) << 4));
}

// tile t's chunk rows, halo included, from device memory; zeros outside the image
template <class G, int KH>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* x, int t, int tiles_x,
                                          int tiles_y, int H, int W) {
  const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y, n = t / (tiles_x * tiles_y);
  const int h0 = ty * TH - 1, g0 = (tx * G::TWP - 1) * KH, rowc = W * KH;
  const bf16* xn = x + (i64)n * H * rowc * BLK;
  for (int idx = threadIdx.x; idx < (TH + 2) * G::RS * 8; idx += NT) {
    const int rc = idx >> 3, piece = idx & 7, r = rc / G::RS, c = rc - r * G::RS;
    const int h = h0 + r, g = g0 + c;
    const bool ok = h >= 0 && h < H && g >= 0 && g < rowc;
    const bf16* src = ok ? xn + ((i64)h * rowc + g) * BLK + piece * 8 : x;
    cp_async16_zfill(dst + chunk_off<G::SH>(rc, piece), src, ok ? 16 : 0);
  }
}

// grid (blocks, passes). x (N, H, W, 64 KH), y (N, H, W, 64 NH), wp the packed
// weight blocks: NSLOT blocks of 64 (ci) x 64 (co) per pass.
template <int KH, int MT, int STAGES>
__global__ void __launch_bounds__(NT, 1)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                   bf16* __restrict__ y, int N, int H, int W, int NH) {
  typedef Geo<KH, MT, STAGES> G;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // A warp's MT m16 tiles are 16 pixels of MT consecutive tile rows, so that
  // one fragment of an input row serves the taps dh = 0..2 of three of them.
  // (The four warps of a warpgroup issue each product together; their tiles
  // need no relation to each other.)
  const int row0 = warp / G::TPR * MT, px0 = warp % G::TPR * 16;
  const int nh = blockIdx.y;  // this pass's output chunk
  const int tiles_x = (W + G::TWP - 1) / G::TWP, tiles_y = (H + TH - 1) / TH;
  const int ntiles = N * tiles_y * tiles_x;

  {
    const bf16* src = wp + (i64)blockIdx.y * G::NSLOT * BLK * BLK;
    for (int idx = threadIdx.x; idx < G::NSLOT * BLK * 8; idx += NT) {
      const int k = idx >> 3, piece = idx & 7;  // k: row of block k / 64
      cp_async16(sb + chunk_off<0>(k, piece), src + (i64)k * BLK + piece * 8);
    }
  }
  int t = blockIdx.x;
  if (t < ntiles) load_tile<G, KH>(sb + G::X_OFF, x, t, tiles_x, tiles_y, H, W);
  cp_async_commit();

  // the lane's chunk row, at tap offset 0, in the warp's first m16 tile
  const int a_row = row0 * G::RS + (px0 + (lane & 15)) * KH;
  const int hi = lane >> 4;

  for (int it = 0; t < ntiles; t += gridDim.x, ++it) {
    const int st = STAGES == 2 ? (it & 1) : 0;
    const uint32_t xs = sb + G::X_OFF + st * G::TILE;
    const int tn = t + gridDim.x;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; the other buffer's staged output is written out
    if (STAGES == 2 && tn < ntiles) {
      load_tile<G, KH>(sb + G::X_OFF + (st ^ 1) * G::TILE, x, tn, tiles_x, tiles_y, H, W);
      cp_async_commit();
    }

    float acc[MT][8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
        acc[m][n8][0] = acc[m][n8][1] = acc[m][n8][2] = acc[m][n8][3] = 0.f;

    // Input row rr of the warp's MT + 2 and tap column jk: its fragments are
    // loaded once and multiplied into output row rr - dh with block (dh, jk)
    // for each dh. Two k-steps of fragments at a time, in two sets: one is
    // read by the products in flight while the other is loaded.
    uint32_t a[2][2][4];
#pragma unroll
    for (int rr = 0; rr < MT + 2; ++rr) {
#pragma unroll
      for (int jk = 0; jk < 3 * KH; ++jk) {  // tap column j * KH + kh
        const uint32_t a_addr = xs + chunk_off<G::SH>(a_row + rr * G::RS + jk, hi);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // the group that read a[half] two half-steps ago has completed
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2) ldsm_x4(a[half][k2], a_addr ^ ((2 * half + k2) << 5));
          wgmma_fence();
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
            for (int dh = 0; dh < 3; ++dh) {
              const int m = rr - dh;  // known when unrolled: no branch is left
              if (m >= 0 && m < MT)
                wgmma_m64n64k16(acc[m], a[half][k2],
                                wgmma_desc_b(sb + (dh * 3 * KH + jk) * WBLK) +
                                    ((2 * half + k2) * 16 * ROWB >> 4));
            }
          wgmma_commit();
          wgmma_wait<1>();
        }
      }
    }
    wgmma_wait<0>();

    __syncthreads();  // every warp has read its rows: the tile becomes the staging buffer
    unsigned char* stg = smem + G::X_OFF + st * G::TILE + warp * (MT * MTB);
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int o = ((n8 ^ g) << 4) + 4 * q;
        *reinterpret_cast<uint32_t*>(stg + m * MTB + g * ROWB + o) =
            pack2(acc[m][n8][0], acc[m][n8][1]);
        *reinterpret_cast<uint32_t*>(stg + m * MTB + (g + 8) * ROWB + o) =
            pack2(acc[m][n8][2], acc[m][n8][3]);
      }
    }
    __syncwarp();
    const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y, n = t / (tiles_x * tiles_y);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int h = ty * TH + row0 + m, w0 = tx * G::TWP + px0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = lane + 32 * i, r = idx >> 3, piece = idx & 7, w = w0 + r;
        if (h < H && w < W) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(stg + m * MTB + chunk_off<0>(r, piece));
          bf16* dst = y + ((((i64)n * H + h) * W + w) * NH + nh) * BLK + piece * 8;
          *reinterpret_cast<uint4*>(dst) = v;
        }
      }
    }
    if (STAGES == 1) {
      __syncthreads();  // the staged output is written out: the one buffer is free
      if (tn < ntiles) load_tile<G, KH>(sb + G::X_OFF, x, tn, tiles_x, tiles_y, H, W);
      cp_async_commit();
    }
  }
}

template <int KH, int MT, int STAGES>
cudaError_t launch(const void* x, const void* wp, void* y, int N, int H, int W, int NH,
                   cudaStream_t stream) {
  typedef Geo<KH, MT, STAGES> G;
  auto kernel = conv3x3_mma_kernel<KH, MT, STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const i64 ntiles = (i64)N * ((H + TH - 1) / TH) * ((W + G::TWP - 1) / G::TWP);
  if (ntiles <= 0 || ntiles > 0x3fffffff) return cudaErrorInvalidValue;
  dim3 grid((unsigned)(ntiles < sms ? ntiles : sms), NH);
  kernel<<<grid, NT, G::BYTES, stream>>>((const bf16*)x, (const bf16*)wp, (bf16*)y, N, H, W,
                                         NH);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N, H, W, C) and y (N, H, W, CO) contiguous bf16, C and CO in {64, 128}.
// wp holds CO / 64 groups of 9 C / 64 blocks (dh, j, kh), each 64 (ci) x 64
// (co). Returns cudaGetLastError() after the launch (0 on success).
int conv3x3_mma(const void* x, const void* wp, void* y, int N, int H, int W, int C, int CO,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (CO != 64 && CO != 128) return (int)cudaErrorInvalidValue;
  if (C == 64) return (int)launch<1, 4, 2>(x, wp, y, N, H, W, CO / 64, s);
  if (C == 128) return (int)launch<2, 2, 1>(x, wp, y, N, H, W, CO / 64, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory a block of instance <KH, MT, STAGES> takes, 0 if none
int conv3x3_mma_smem_bytes(int KH, int MT, int STAGES) {
  if (KH == 1 && MT == 4 && STAGES == 2) return Geo<1, 4, 2>::BYTES;
  if (KH == 2 && MT == 2 && STAGES == 1) return Geo<2, 2, 1>::BYTES;
  return 0;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
