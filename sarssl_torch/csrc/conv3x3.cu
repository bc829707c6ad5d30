// SAME 3x3 convolution, NHWC input x HWIO weights, f32 accumulation.
//
// Replaces both Pallas TPU conv kernels, which compute this one function:
//   sarssl_tpu/kernels/conv3x3.py::_pallas_conv3x3  (C = Cout = 64)
//   sarssl_tpu/kernels/conv_s2d.py::_conv_s2d       (the same conv over the
//       free W-space-to-depth view (B, H, W/2, 2C) with expand_weights_s2d2's
//       (3, 3, 2C, 2C) weights; the wrapper passes that view, so here it is
//       C = Cout = 128)
//
//   y[n, h, w, co] = sum_{dh, dw, ci} x[n, h+dh-1, w+dw-1, ci] * wt[dh, dw, ci, co]
//
// with zeros outside the image. x and y are contiguous (N, H, W, C) and
// (N, H, W, Cout); wt is contiguous (3, 3, C, Cout) in x's dtype (float32 or
// bfloat16). Sums run in f32; y is written in x's dtype.
//
// What bounds it on an H100: at the front end's shape (128, 256, 256, 64)
// bf16 the conv reads x and writes y, 2.15 GB, 0.64 ms at 3.35 TB/s, and does
// 618.5 GFLOP, 0.63 ms at the 989 TFLOP/s bf16 tensor rate: the two bounds
// are nearly equal. The TPU kernels' mechanics (a halo side array, taps
// paired along lanes, f32 rolls of the result) are not carried over:
//   * one block per tile of TH x 32 output pixels and all Cout channels
//     loads its own (TH+2) x 34 x C input tile, halo included, into shared
//     memory as f32, zero-filled at the image edge (the SAME padding);
//   * the weights stream through shared memory one tap (C x Cout) at a time:
//     the whole (3, 3, 128, 128) weight is 576 KB in f32, far over the 227 KB
//     a block may use;
//   * each thread keeps a 4-row x 16-channel f32 accumulator in registers;
//     a warp's 32 lanes are 32 neighbouring output columns, so its input
//     reads hit 32 banks (pixel stride C+1 words) and its weight reads are
//     one broadcast float4 each.
// This first version multiplies with f32 FMAs on the CUDA cores (67 TFLOP/s
// at most), so it runs well above its bound; the tensor cores (mma/wgmma)
// and TMA are left for a later version.
//
// Every other channel count (the Pallas kernel takes any C and Cout) runs
// conv3x3_any_kernel, the same design with C and Cout as runtime arguments:
// a block takes TH x 32 output pixels and a chunk of 64 output channels
// (channels past Cout are computed on zero weights and never stored), and
// walks C in chunks of 16 input channels: each chunk's input tile (halo
// included) and its nine taps' 16 x 64 weights go through shared memory as
// f32, the last chunk's loops running only to C. Both kernels put the pixel
// tiles on the grid's x dimension (any H and W) and the images on its y.
// Any N: y holds 65535 images, so the wrapper launches runs of at most that
// many (kernels/conv3x3.py::conv_batch_chunks), each entry call given its
// images' pointers; the kernels index within an image in size_t.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block: 8 warps
constexpr int TW = 32;   // output columns per block, one per lane
constexpr int RPT = 4;   // output rows per thread
constexpr int CPT = 16;  // output channels per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Warps split into CO / CPT channel groups and the rest into row groups.
template <int CO>
struct Tile {
  static_assert(CO % CPT == 0 && (NT / 32) % (CO / CPT) == 0, "unsupported Cout");
  static constexpr int NCG = CO / CPT;         // channel groups
  static constexpr int NRG = (NT / 32) / NCG;  // row groups
  static constexpr int TH = NRG * RPT;         // output rows per block
};

template <int C, int CO>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)C * CO + (size_t)(Tile<CO>::TH + 2) * (TW + 2) * (C + 1));
}

// grid (tiles of W * tiles of H, N), blockIdx.x = th * tiles_w + tw (x
// holds 2**31 - 1 blocks, so any H); smem: one tap's weights (C x CO) then
// the input tile ((TH+2) x (TW+2) pixels of C+1 words)
template <typename T, int C, int CO>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wt, T* __restrict__ y, int H,
               int W) {
  constexpr int TH = Tile<CO>::TH, NCG = Tile<CO>::NCG;
  constexpr int XW = TW + 2, XS = C + 1;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + C * CO;
  const int n = blockIdx.y, tiles_w = (W + TW - 1) / TW;
  const int h0 = blockIdx.x / tiles_w * TH, w0 = blockIdx.x % tiles_w * TW;
  const T* xn = x + (size_t)n * H * W * C;

  for (int idx = threadIdx.x; idx < (TH + 2) * XW * C; idx += NT) {
    const int ci = idx % C, p = idx / C;
    const int h = h0 + p / XW - 1, w = w0 + p % XW - 1;
    float v = 0.f;
    if (h >= 0 && h < H && w >= 0 && w < W) v = to_f(xn[((size_t)h * W + w) * C + ci]);
    xs[p * XS + ci] = v;
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cg = warp % NCG, r0 = (warp / NCG) * RPT;
  float acc[RPT][CPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[j][c] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the previous tap's weights are read; the tile is stored
    const T* wtap = wt + (size_t)tap * C * CO;
    for (int idx = threadIdx.x; idx < C * CO; idx += NT) ws[idx] = to_f(wtap[idx]);
    __syncthreads();
    const int dh = tap / 3, dw = tap % 3;
    const float* xp = xs + ((r0 + dh) * XW + lane + dw) * XS;
    const float4* wp = reinterpret_cast<const float4*>(ws + cg * CPT);
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      float a[RPT], b[CPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) a[j] = xp[j * XW * XS + ci];
#pragma unroll
      for (int q = 0; q < CPT / 4; ++q) {
        const float4 v = wp[ci * (CO / 4) + q];
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[j][c] = fmaf(a[j], b[c], acc[j][c]);
    }
  }

  const int w = w0 + lane;
  if (w >= W) return;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int h = h0 + r0 + j;
    if (h >= H) continue;
    T* out = y + (((size_t)n * H + h) * W + w) * CO + cg * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[c] = from_f<T>(acc[j][c]);
  }
}

template <typename T, int C, int CO>
cudaError_t launch(const void* x, const void* wt, void* y, int N, int H, int W,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C, CO>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<T, C, CO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int TH = Tile<CO>::TH;
  const long long tiles = (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH);
  if (tiles > 0x7fffffff || N > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, N);
  conv3x3_kernel<T, C, CO><<<grid, NT, smem, stream>>>((const T*)x, (const T*)wt, (T*)y, H, W);
  return cudaGetLastError();
}

// The kernel at runtime channel counts: grid (tiles of W * tiles of H *
// ceil(CO / ACO), N); blockIdx.x = (th * tiles_w + tw) * nco + co chunk, so
// the channel chunks of one pixel tile run side by side and share its input
// in L2. smem: one input-channel chunk's nine taps' weights (9 x ACK x ACO)
// then its input tile ((TH+2) x (TW+2) pixels of ACK+1 words).
constexpr int ACK = 16;  // input channels a chunk
constexpr int ACO = 64;  // output channels a block
constexpr int ATH = 2 * RPT;  // output rows a block: 4 channel groups x 2 row groups
constexpr size_t any_smem_bytes() {
  return sizeof(float) * ((size_t)9 * ACK * ACO + (size_t)(ATH + 2) * (TW + 2) * (ACK + 1));
}

template <typename T>
__global__ void __launch_bounds__(NT)
conv3x3_any_kernel(const T* __restrict__ x, const T* __restrict__ wt, T* __restrict__ y, int H,
                   int W, int C, int CO) {
  constexpr int XW = TW + 2, XS = ACK + 1, NCG = ACO / CPT;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + 9 * ACK * ACO;
  const int nco = (CO + ACO - 1) / ACO, tiles_w = (W + TW - 1) / TW;
  const int co0 = blockIdx.x % nco * ACO, tile = blockIdx.x / nco;
  const int h0 = tile / tiles_w * ATH, w0 = tile % tiles_w * TW;
  const T* xn = x + (size_t)blockIdx.y * H * W * C;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cg = warp % NCG, r0 = (warp / NCG) * RPT;
  float acc[RPT][CPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[j][c] = 0.f;

  for (int c0 = 0; c0 < C; c0 += ACK) {
    const int ck = min(ACK, C - c0);
    __syncthreads();  // the previous chunk's tiles are read
    for (int idx = threadIdx.x; idx < (ATH + 2) * XW * ACK; idx += NT) {
      const int ci = idx % ACK, p = idx / ACK;
      const int h = h0 + p / XW - 1, w = w0 + p % XW - 1;
      float v = 0.f;
      if (ci < ck && h >= 0 && h < H && w >= 0 && w < W)
        v = to_f(xn[((size_t)h * W + w) * C + c0 + ci]);
      xs[p * XS + ci] = v;
    }
    // ws[(tap * ACK + ci) * ACO + co] = wt[tap][c0 + ci][co0 + co], zero past Cout
    for (int idx = threadIdx.x; idx < 9 * ACK * ACO; idx += NT) {
      const int co = idx % ACO, ci = idx / ACO % ACK, tap = idx / (ACK * ACO);
      float v = 0.f;
      if (ci < ck && co0 + co < CO) v = to_f(wt[((size_t)tap * C + c0 + ci) * CO + co0 + co]);
      ws[idx] = v;
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3, dw = tap % 3;
      const float* xp = xs + ((r0 + dh) * XW + lane + dw) * XS;
      const float4* wp = reinterpret_cast<const float4*>(ws + tap * ACK * ACO + cg * CPT);
#pragma unroll 4
      for (int ci = 0; ci < ck; ++ci) {
        float a[RPT], b[CPT];
#pragma unroll
        for (int j = 0; j < RPT; ++j) a[j] = xp[j * XW * XS + ci];
#pragma unroll
        for (int q = 0; q < CPT / 4; ++q) {
          const float4 v = wp[ci * (ACO / 4) + q];
          b[4 * q] = v.x;
          b[4 * q + 1] = v.y;
          b[4 * q + 2] = v.z;
          b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[j][c] = fmaf(a[j], b[c], acc[j][c]);
      }
    }
  }

  const int w = w0 + lane;
  if (w >= W) return;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int h = h0 + r0 + j;
    if (h >= H) continue;
    T* out = y + (((size_t)blockIdx.y * H + h) * W + w) * CO;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int co = co0 + cg * CPT + c;
      if (co < CO) out[co] = from_f<T>(acc[j][c]);
    }
  }
}

template <typename T>
cudaError_t launch_any(const void* x, const void* wt, void* y, int N, int H, int W, int C,
                       int CO, cudaStream_t stream) {
  constexpr size_t smem = any_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_any_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((W + TW - 1) / TW) * ((H + ATH - 1) / ATH) *
                           ((CO + ACO - 1) / ACO);
  if (blocks > 0x7fffffff || N > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, N);
  conv3x3_any_kernel<T><<<grid, NT, smem, stream>>>((const T*)x, (const T*)wt, (T*)y, H, W, C,
                                                    CO);
  return cudaGetLastError();
}

}  // namespace

// (C, Cout) pairs with an instance; kernels/conv3x3.py::CHANNELS lists the same
#define CHANNEL_PAIRS(T)                                                   \
  if (C == 64 && CO == 64) return (int)launch<T, 64, 64>(x, wt, y, N, H, W, s);    \
  if (C == 128 && CO == 128) return (int)launch<T, 128, 128>(x, wt, y, N, H, W, s); \
  if (C == 64 && CO == 128) return (int)launch<T, 64, 128>(x, wt, y, N, H, W, s);  \
  if (C == 128 && CO == 64) return (int)launch<T, 128, 64>(x, wt, y, N, H, W, s);

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), cudaErrorInvalidValue for a pair without an instance.
int conv3x3(int dtype, const void* x, const void* wt, void* y, int N, int H, int W, int C,
            int CO, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    CHANNEL_PAIRS(float)
  } else if (dtype == 1) {
    CHANNEL_PAIRS(__nv_bfloat16)
  }
  return (int)cudaErrorInvalidValue;
}

// The kernel at runtime channel counts: any C, CO >= 1, N <= 65535 (the
// wrapper launches runs of images), as conv3x3 otherwise.
int conv3x3_any(int dtype, const void* x, const void* wt, void* y, int N, int H, int W, int C,
                int CO, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C < 1 || CO < 1 || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_any<float>(x, wt, y, N, H, W, C, CO, s);
  if (dtype == 1) return (int)launch_any<__nv_bfloat16>(x, wt, y, N, H, W, C, CO, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
