// Fused rel-pos attention on the H100's tensor cores, forward and backward,
// for bfloat16 at head dims 64 and 128 and a sequence length that is a
// multiple of 64. (float32, head dims 16 and 32 and ragged lengths stay on the
// FMA kernels of attention.cu: the wrapper routes them there.)
//
// Replaces the Pallas TPU kernels of sarssl_tpu/kernels/attention.py:
//   forward  _call_fwd (_fwd_kernel, _attend) -> attn_fwd_mma
//   backward _fa_bwd   (_bwd_kernel)          -> attn_delta + attn_bwd_mma + attn_dqu_mma
//
//   s = (qu k^T + bias) * scale ; p = softmax(s) ; pd = dropout(p) ; out = T(pd) v
//   dv = T(pd)^T g ; dp = dropout'(g v^T) ; ds = p (dp - sum_j dp p)
//   dbias = T(ds * scale) ; dqu = dbias k ; dk = dbias^T qu
//
// qu, k, v, dqu, dk, dv are (B, H, L, D) and bias, dbias (B, H, L, L),
// contiguous bf16. out and g are (B, H, L, D) with any strides over (b, h, l)
// and a contiguous last dim: the wrapper hands the kernel a (B, L, H, D)
// buffer for out, so the model's transpose back to (B, L, H*D) is a view.
//
// What bounds it on an H100: bytes. At B=128, H=4, L=256, D=128 the forward
// must move 201 MB (60 us at 3.35 TB/s) for 17 GFLOP (17 us at the 989 TFLOP/s
// tensor rate); the (B,H,L,L) bias is a third of the bytes. The design:
//
//  * All five products run on the tensor cores as mma.sync.m16n8k16 (bf16
//    operands, f32 accumulation) with ldmatrix from shared memory. wgmma is
//    the card's full rate, but these shapes are bound by bytes, not by
//    operations, and mma.sync at roughly 60% of that rate still stays below
//    the time the bytes need; its register-resident accumulator layout also
//    lets P, P^T and ds^T be re-used as the A operand of the next product
//    without a trip through shared memory. So mma.sync was taken.
//  * Operands stay bf16 in shared memory, copied 16 bytes a thread with
//    cp.async into rows whose 16-byte chunks are XOR-swizzled with the row
//    index (chunk ^ (row & 7)), which makes every ldmatrix conflict-free.
//    Tiles are double-buffered: the copy of tile t+1 is started before the
//    products of tile t.
//  * The bias is read once per kernel through the same cp.async pipeline
//    (16-byte loads) into a padded tile, and added in f32 to the accumulator
//    before the scale.
//  * Forward: a block of 4 warps owns 64 query rows, each warp 16 of them. It
//    walks the keys in tiles of 64 with a running row max and sum (the output
//    accumulator is rescaled when the max moves). exp(s - m) is scaled by
//    1/(1-rate), rounded to bf16 and multiplied into V; the division by the
//    row sum comes last, in f32. The reference rounds the normalised p
//    instead: one bf16 rounding apart, inside the 2e-2 tolerance. The forward
//    also writes lse = m + log(sum) per row, (B,H,L) f32, so the backward
//    never repeats a softmax reduction.
//  * Backward: every score, p and mask is computed once and dbias is written
//    once. attn_delta computes delta_i = sum_d g_id out_id, which equals
//    sum_j dp_ij p_ij (out is bf16, so it differs from the reference's f32 sum
//    by out's rounding; inside the tolerance). attn_bwd_mma runs per (b, h,
//    tile of 64 keys), each warp owning 16 keys, and loops over the queries in
//    tiles of 32: it computes the scores TRANSPOSED (s^T = k qu^T, dp^T = v
//    g^T), so that p^T and ds^T sit in the accumulator layout that the A
//    operand of dv += T(pd)^T g and dk += dbias^T qu wants, and dv and dk are
//    summed in registers over the loop. The dbias tile goes through shared
//    memory to be written in 16-byte rows. attn_dqu_mma then takes dqu =
//    dbias k per (b, h, 64 query rows) over the dbias just written (one extra
//    read of it). No atomics anywhere: results are bit-identical from run to
//    run.
//  * Dropout is the counter hash of the flat (b, h, i, j) index (murmur3
//    finalizer of index + seed, keep where hash >= thresh), computed from each
//    accumulator element's own (i, j), so the dropped positions equal the
//    plain version's and forward and backward agree.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef long long i64;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 128;    // threads per block: 4 warps, 16 tile rows each
constexpr int BK = 64;     // keys per tile
constexpr int BQ = 32;     // queries per step of the backward's loop
constexpr int BSTR = 72;   // row stride (elements) of a padded 64-key bias tile

struct Dropout {
  uint32_t seed;
  uint32_t thresh;   // keep where hash >= thresh
  float inv_keep;    // 1 / (1 - rate)
  int active;
};

struct Strides {  // element strides of a (B, H, L, D) view, last dim contiguous
  i64 b, h, l;
};

__device__ __forceinline__ bool keep(const Dropout& d, uint32_t flat) {
  uint32_t x = flat + d.seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x >= d.thresh;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile whose
// rows hold W bf16 values.
template <int W>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * (W * 2) + ((chunk ^ (row & 7)) << 4));
}

// ROWS x W values from device memory (row stride ld elements) -> swizzled tile
template <int ROWS, int W>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, i64 ld) {
  constexpr int CH = W / 8;
  static_assert(ROWS * CH % NT == 0, "the tile's chunks divide among the threads");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx / CH, c = idx % CH;
    cp_async16(dst + swz<W>(r, c), src + (i64)r * ld + c * 8);
  }
}

// ROWS x 64 values of the bias (row stride L) -> padded tile of stride BSTR
template <int ROWS>
__device__ __forceinline__ void load_bias_tile(uint32_t dst, const bf16* src, int L) {
  static_assert(ROWS * 8 % NT == 0, "the tile's chunks divide among the threads");
#pragma unroll
  for (int it = 0; it < ROWS * 8 / NT; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx >> 3, c = idx & 7;
    cp_async16(dst + (uint32_t)((r * BSTR + c * 8) * 2), src + (i64)r * L + c * 8);
  }
}

// ldmatrix addressing. A lane's address of chunk (2 * kk + hi) of its row is
// (tile + lane_off(row, hi)) ^ (kk << 5): the swizzle's XOR splits into a
// per-lane part and a compile-time part because tiles start at multiples of
// their row pitch times 8, so one address register serves a whole tile.
template <int W>
__device__ __forceinline__ uint32_t lane_off(int row, int hi) {
  return (uint32_t)(row * (W * 2) + ((hi ^ (row & 7)) << 4));
}
// lane's base for x4 loads of A fragments (16 rows x 16 k) or, transposed, of
// B fragments from rows that run along the product's n (16 k x 16 n)
template <int W>
__device__ __forceinline__ uint32_t lane_base_a(uint32_t tile, int row0, int lane) {
  return tile + lane_off<W>(row0 + (lane & 15), lane >> 4);
}
// lane's base for x4 loads of B fragments from rows that run along k (16 n x 16 k)
template <int W>
__device__ __forceinline__ uint32_t lane_base_b(uint32_t tile, int lane) {
  return tile + lane_off<W>((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc (16 x 8*NTILES) += A (16 x 16*KSTEPS, fragments in registers)
//                        * B (16*KSTEPS x 8*NTILES: rows of a swizzled tile of width W,
//                             the product's n runs along a row); b_base = lane_base_a
//                             of the tile's first row
template <int W, int KSTEPS, int NTILES>
__device__ __forceinline__ void mma_a_regs_b_rows(float (&acc)[NTILES][4],
                                                  const uint32_t (&a)[KSTEPS][4],
                                                  uint32_t b_base) {
#pragma unroll
  for (int kc = 0; kc < KSTEPS; ++kc) {
#pragma unroll
    for (int np = 0; np < NTILES / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, (b_base ^ (np << 5)) + kc * 16 * W * 2);
      mma16816(acc[2 * np], a[kc], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[kc], b[2], b[3]);
    }
  }
}

// acc (16 x 8*NTILES) = sum over D of A (16 rows of a tile, a_base = lane_base_a)
//                       * B^T (rows 0..8*NTILES of a tile, b_base = lane_base_b)
template <int D, int NTILES>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[NTILES][4], uint32_t a_base,
                                              uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_base ^ (kk << 5));
#pragma unroll
    for (int np = 0; np < NTILES / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, (b_base ^ (kk << 5)) + np * 16 * D * 2);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The warp's 16 x D accumulator -> its own 16 rows (row0..) of a swizzled tile
// as bf16, then out to device memory in 16-byte stores (row stride ld).
template <int D>
__device__ __forceinline__ void store_rows(unsigned char* smem, uint32_t tile_off,
                                           const float (&acc)[D / 8][4], int row0, bf16* dst,
                                           i64 ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(smem + tile_off + swz<D>(row0 + g, n) + 4 * t) =
        pack2(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(smem + tile_off + swz<D>(row0 + g + 8, n) + 4 * t) =
        pack2(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  constexpr int CH = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * CH / 32; ++it) {
    const int idx = lane + it * 32, r = idx / CH, c = idx % CH;
    const uint4 val = *reinterpret_cast<const uint4*>(smem + tile_off + swz<D>(row0 + r, c));
    *reinterpret_cast<uint4*>(dst + (i64)r * ld + c * 8) = val;
  }
}

// ---------------------------------------------------------------------------
// forward: grid (L/64, B*H); blockIdx.x is the query tile, so the tiles of one
// (b, h) run together and k, v come from L2 after the first.
// smem: Q tile, 2 x (K tile, V tile, bias tile)
// ---------------------------------------------------------------------------
template <int D>
struct FwdSmem {
  static constexpr int TILE = 64 * D * 2;
  static constexpr int BIAS = 64 * BSTR * 2;
  static constexpr int Q = 0;
  static constexpr int K = TILE;                  // 2 stages
  static constexpr int V = 3 * TILE;              // 2 stages
  static constexpr int B = 5 * TILE;              // 2 stages
  static constexpr int BYTES = 5 * TILE + 2 * BIAS;
  static_assert(TILE % 256 == 0 && BIAS % 256 == 0, "tiles start at multiples of 256 bytes");
};

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 3 : 2)
attn_fwd_mma(const bf16* __restrict__ qu, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ bias,
             bf16* __restrict__ out, float* __restrict__ lse, int H, int L, float scale,
             Dropout drop, Strides os) {
  typedef FwdSmem<D> S;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int bh = blockIdx.y, i0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const bf16* kp = k + (i64)bh * L * D;
  const bf16* vp = v + (i64)bh * L * D;
  const bf16* bp = bias + ((i64)bh * L + i0) * L;
  const int ntiles = L / BK;

  load_tile<64, D>(sb + S::Q, qu + ((i64)bh * L + i0) * D, D);
  load_tile<64, D>(sb + S::K, kp, D);
  load_tile<64, D>(sb + S::V, vp, D);
  load_bias_tile<64>(sb + S::B, bp, L);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // rows g and g + 8
  const uint32_t row_a = ((uint32_t)bh * L + i0 + r0 + g) * L, row_b = row_a + 8u * L;

  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait_all();
    __syncthreads();
    const int st = tt & 1;
    if (tt + 1 < ntiles) {
      const int nx = st ^ 1, j1 = (tt + 1) * BK;
      load_tile<64, D>(sb + S::K + nx * S::TILE, kp + (i64)j1 * D, D);
      load_tile<64, D>(sb + S::V + nx * S::TILE, vp + (i64)j1 * D, D);
      load_bias_tile<64>(sb + S::B + nx * S::BIAS, bp + j1, L);
      cp_async_commit();
    }
    if (tt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], lane_base_a<D>(sb + S::Q, r0, lane) ^ (kk << 5));
    }

    // s = qu k^T for the warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const uint32_t kb = lane_base_b<D>(sb + S::K + st * S::TILE, lane);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, (kb ^ (kk << 5)) + np * 16 * D * 2);
        mma16816(s[2 * np], qf[kk], b[0], b[1]);
        mma16816(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // (s + bias) * scale, in log2 units for exp2f; running max
    const bf16* bt = reinterpret_cast<const bf16*>(smem + S::B + st * S::BIAS);
    const float sl2 = scale * LOG2E;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 ba = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bt + (r0 + g) * BSTR + col));
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bt + (r0 + g + 8) * BSTR + col));
      s[n][0] = (s[n][0] + ba.x) * sl2;
      s[n][1] = (s[n][1] + ba.y) * sl2;
      s[n][2] = (s[n][2] + bb.x) * sl2;
      s[n][3] = (s[n][3] + bb.y) * sl2;
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    const float corr_a = fast_exp2(m_a - mn_a), corr_b = fast_exp2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // e = exp(s - m): summed in f32; dropped or scaled by 1/(1-rate), then
    // rounded to bf16 as the A operand of the PV product
    float sum_a = 0.f, sum_b = 0.f;
    const uint32_t j0 = (uint32_t)(tt * BK);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[n][e] - (e < 2 ? m_a : m_b));
        if (e < 2) sum_a += p; else sum_b += p;
        float pd = p;
        if (drop.active) {
          const uint32_t flat = (e < 2 ? row_a : row_b) + j0 + 8 * n + 2 * t + (e & 1);
          pd = keep(drop, flat) ? p * drop.inv_keep : 0.f;
        }
        s[n][e] = pd;
      }
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr_a;
      o[n][1] *= corr_a;
      o[n][2] *= corr_b;
      o[n][3] *= corr_b;
    }
    uint32_t pf[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      pf[kc][0] = pack2(s[2 * kc][0], s[2 * kc][1]);
      pf[kc][1] = pack2(s[2 * kc][2], s[2 * kc][3]);
      pf[kc][2] = pack2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pf[kc][3] = pack2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
    mma_a_regs_b_rows<D, 4, D / 8>(o, pf, lane_base_a<D>(sb + S::V + st * S::TILE, 0, lane));
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] *= inv_a;
    o[n][1] *= inv_a;
    o[n][2] *= inv_b;
    o[n][3] *= inv_b;
  }
  if (t == 0) {
    // m is in log2 units of the scaled score; lse in natural units
    float* lp = lse + (i64)bh * L + i0 + r0;
    lp[g] = (m_a + log2f(l_a)) / LOG2E;
    lp[g + 8] = (m_b + log2f(l_b)) / LOG2E;
  }
  // the query tile's rows r0.. were read by this warp alone: reuse them
  bf16* op = out + (bh / H) * os.b + (bh % H) * os.h + (i64)(i0 + r0) * os.l;
  store_rows<D>(smem, S::Q, o, r0, op, os.l, lane);
}

// ---------------------------------------------------------------------------
// delta[b, h, i] = sum_d g[b, h, i, d] * out[b, h, i, d]; D/8 lanes per row
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256)
attn_delta(const bf16* __restrict__ g, const bf16* __restrict__ out,
           float* __restrict__ delta, int H, int L, Strides gs, Strides os) {
  constexpr int LPR = D / 8;
  const int row = blockIdx.x * (256 / LPR) + threadIdx.x / LPR, c = threadIdx.x % LPR;
  const int bh = row / L, i = row % L;
  const i64 b = bh / H, h = bh % H;
  const uint4 gv = *reinterpret_cast<const uint4*>(g + b * gs.b + h * gs.h + i * gs.l + c * 8);
  const uint4 ov = *reinterpret_cast<const uint4*>(out + b * os.b + h * os.h + i * os.l + c * 8);
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 a = __bfloat1622float2(g2[e]), bb = __bfloat1622float2(o2[e]);
    sum = fmaf(a.x, bb.x, sum);
    sum = fmaf(a.y, bb.y, sum);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (c == 0) delta[row] = sum;
}

// ---------------------------------------------------------------------------
// backward, main pass: grid (L/64, B*H); blockIdx.x is the key tile. Each warp
// owns 16 keys and keeps their dv and dk in registers over the query loop.
// smem: K tile, V tile, 2 x (Q, G, bias tiles of BQ queries, lse, delta),
// dbias staging tile
// ---------------------------------------------------------------------------
template <int D>
struct BwdSmem {
  static constexpr int KV = 64 * D * 2;
  static constexpr int QG = BQ * D * 2;
  static constexpr int BIAS = BQ * BSTR * 2;
  static constexpr int STAT = 2 * BQ * 4;                 // lse then delta
  static constexpr int STAGE = 2 * QG + BIAS + STAT;
  static constexpr int K = 0;
  static constexpr int V = KV;
  static constexpr int ST = 2 * KV;                       // 2 stages: Q, G, bias, stats
  static constexpr int DS = 2 * KV + 2 * STAGE;
  static constexpr int BYTES = DS + BIAS;
  static_assert(QG % 256 == 0 && STAGE % 256 == 0, "tiles start at multiples of 256 bytes");
};

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 3 : 2)
attn_bwd_mma(const bf16* __restrict__ qu, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ bias,
             const bf16* __restrict__ gr, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
             bf16* __restrict__ dbias, int H, int L, float scale, Dropout drop, Strides gs) {
  typedef BwdSmem<D> S;
  constexpr int QT = BQ / 8;  // 8-query accumulator tiles per step
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int bh = blockIdx.y, j0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // the warp's keys within the tile
  const bf16* qp = qu + (i64)bh * L * D;
  const bf16* gp = gr + (bh / H) * gs.b + (bh % H) * gs.h;
  const bf16* bp = bias + (i64)bh * L * L + j0;
  const float* lp = lse + (i64)bh * L;
  const float* dp = delta + (i64)bh * L;
  const int nsteps = L / BQ;

  auto load_stage = [&](int stage, int q0) {
    const uint32_t base = sb + S::ST + stage * S::STAGE;
    load_tile<BQ, D>(base, qp + (i64)q0 * D, D);
    load_tile<BQ, D>(base + S::QG, gp + (i64)q0 * gs.l, gs.l);
    load_bias_tile<BQ>(base + 2 * S::QG, bp + (i64)q0 * L, L);
    constexpr int SC = BQ / 4;  // 16-byte chunks of BQ floats
    if (threadIdx.x < 2 * SC) {
      const int c = threadIdx.x;
      const float* src = c < SC ? lp + q0 + 4 * c : dp + q0 + 4 * (c - SC);
      cp_async16(base + 2 * S::QG + S::BIAS + 16 * c, src);
    }
  };

  load_tile<64, D>(sb + S::K, k + ((i64)bh * L + j0) * D, D);
  load_tile<64, D>(sb + S::V, v + ((i64)bh * L + j0) * D, D);
  load_stage(0, 0);
  cp_async_commit();

  float dva[D / 8][4], dka[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
  }
  const uint32_t key_a = (uint32_t)(j0 + r0 + g), key_b = key_a + 8u;
  const float sl2 = scale * LOG2E;

  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait_all();
    __syncthreads();
    const int st = it & 1, q0 = it * BQ;
    if (it + 1 < nsteps) {
      load_stage(st ^ 1, q0 + BQ);
      cp_async_commit();
    }
    const int stage_off = S::ST + st * S::STAGE;
    const uint32_t qt = sb + stage_off, gt = qt + S::QG;
    const bf16* bt = reinterpret_cast<const bf16*>(smem + stage_off + 2 * S::QG);
    const float* stat = reinterpret_cast<const float*>(smem + stage_off + 2 * S::QG + S::BIAS);

    // p^T[key][query] = exp((k qu^T + bias^T) * scale - lse[query])
    float p[QT][4];
#pragma unroll
    for (int n = 0; n < QT; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    mma_rows_rows<D, QT>(p, lane_base_a<D>(sb + S::K, r0, lane), lane_base_b<D>(qt, lane));
    // p is never negative, so its sign bit carries the dropout mask to the
    // second half of the step: set where the position is dropped
    uint32_t af[BQ / 16][4];
    {
      float pd[QT][4];
#pragma unroll
      for (int n = 0; n < QT; ++n) {
        const int q = 8 * n + 2 * t;  // this thread's queries: q, q + 1
        const float2 ls = *reinterpret_cast<const float2*>(stat + q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = q + (e & 1), kk = r0 + g + (e < 2 ? 0 : 8);
          const float b = __bfloat162float(bt[qq * BSTR + kk]);
          const float pe = fast_exp2((p[n][e] + b) * sl2 - ((e & 1) ? ls.y : ls.x) * LOG2E);
          bool kp = true;
          if (drop.active)
            kp = keep(drop, ((uint32_t)bh * L + q0 + qq) * L + (e < 2 ? key_a : key_b));
          p[n][e] = kp ? pe : -pe;
          pd[n][e] = kp ? pe * drop.inv_keep : 0.f;
        }
      }
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        af[kc][0] = pack2(pd[2 * kc][0], pd[2 * kc][1]);
        af[kc][1] = pack2(pd[2 * kc][2], pd[2 * kc][3]);
        af[kc][2] = pack2(pd[2 * kc + 1][0], pd[2 * kc + 1][1]);
        af[kc][3] = pack2(pd[2 * kc + 1][2], pd[2 * kc + 1][3]);
      }
    }
    // dv[key] += T(pd)^T g
    mma_a_regs_b_rows<D, BQ / 16, D / 8>(dva, af, lane_base_a<D>(gt, 0, lane));

    // dp^T = v g^T through the same mask; ds = p (dp - delta); dbias = T(ds * scale)
    float dpt[QT][4];
#pragma unroll
    for (int n = 0; n < QT; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    mma_rows_rows<D, QT>(dpt, lane_base_a<D>(sb + S::V, r0, lane), lane_base_b<D>(gt, lane));
    bf16* dst = reinterpret_cast<bf16*>(smem + S::DS);
#pragma unroll
    for (int n = 0; n < QT; ++n) {
      const int q = 8 * n + 2 * t;
      const float2 dl = *reinterpret_cast<const float2*>(stat + BQ + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool kp = !signbit(p[n][e]);
        const float dpm = kp ? dpt[n][e] * drop.inv_keep : 0.f;
        const float ds = fabsf(p[n][e]) * (dpm - ((e & 1) ? dl.y : dl.x)) * scale;
        const bf16 dsx = __float2bfloat16(ds);
        dst[(q + (e & 1)) * BSTR + r0 + g + (e < 2 ? 0 : 8)] = dsx;
        dpt[n][e] = __bfloat162float(dsx);
      }
    }
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      af[kc][0] = pack2(dpt[2 * kc][0], dpt[2 * kc][1]);
      af[kc][1] = pack2(dpt[2 * kc][2], dpt[2 * kc][3]);
      af[kc][2] = pack2(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]);
      af[kc][3] = pack2(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3]);
    }
    // dk[key] += dbias^T qu
    mma_a_regs_b_rows<D, BQ / 16, D / 8>(dka, af, lane_base_a<D>(qt, 0, lane));

    // the dbias tile, BQ rows of 64 keys, out in 16-byte stores
    __syncthreads();
    bf16* db = dbias + ((i64)bh * L + q0) * L + j0;
#pragma unroll
    for (int i2 = 0; i2 < BQ * 8 / NT; ++i2) {
      const int idx = threadIdx.x + i2 * NT, r = idx >> 3, c = idx & 7;
      *reinterpret_cast<uint4*>(db + (i64)r * L + c * 8) =
          *reinterpret_cast<const uint4*>(smem + S::DS + (r * BSTR + c * 8) * 2);
    }
  }

  // K and V rows r0.. were read by this warp alone: reuse them as staging
  const i64 orow = ((i64)bh * L + j0 + r0) * D;
  store_rows<D>(smem, S::K, dka, r0, dk + orow, D, lane);
  store_rows<D>(smem, S::V, dva, r0, dv + orow, D, lane);
}

// ---------------------------------------------------------------------------
// backward, dqu = dbias k: grid (L/64, B*H); blockIdx.x is the query tile.
// smem: 2 x (dbias tile 64 x 64, K tile 64 x D)
// ---------------------------------------------------------------------------
template <int D>
struct DquSmem {
  static constexpr int A = 64 * 64 * 2;
  static constexpr int KT = 64 * D * 2;
  static constexpr int STAGE = A + KT;
  static constexpr int BYTES = 2 * STAGE;
  static_assert(A % 256 == 0 && STAGE % 256 == 0, "tiles start at multiples of 256 bytes");
};

template <int D>
__global__ void __launch_bounds__(NT)
attn_dqu_mma(const bf16* __restrict__ dbias, const bf16* __restrict__ k,
             bf16* __restrict__ dqu, int L) {
  typedef DquSmem<D> S;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int bh = blockIdx.y, i0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp;
  const bf16* ap = dbias + ((i64)bh * L + i0) * L;
  const bf16* kp = k + (i64)bh * L * D;
  const int ntiles = L / BK;

  load_tile<64, 64>(sb, ap, L);
  load_tile<64, D>(sb + S::A, kp, D);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait_all();
    __syncthreads();
    const int st = tt & 1;
    if (tt + 1 < ntiles) {
      const uint32_t nx = sb + (st ^ 1) * S::STAGE;
      load_tile<64, 64>(nx, ap + (tt + 1) * BK, L);
      load_tile<64, D>(nx + S::A, kp + (i64)(tt + 1) * BK * D, D);
      cp_async_commit();
    }
    const uint32_t at = sb + st * S::STAGE;
    uint32_t af[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      ldsm_x4(af[kc], lane_base_a<64>(at, r0, lane) ^ (kc << 5));
    mma_a_regs_b_rows<D, 4, D / 8>(acc, af, lane_base_a<D>(at + S::A, 0, lane));
  }
  __syncthreads();  // every warp is done with the stages: reuse stage 0's K tile
  store_rows<D>(smem, S::A, acc, r0, dqu + ((i64)bh * L + i0 + r0) * D, D, lane);
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t fwd(const void* qu, const void* k, const void* v, const void* bias, void* out,
                float* lse, int BH, int H, int L, float scale, Dropout drop, Strides os,
                cudaStream_t stream) {
  cudaError_t err = set_smem(attn_fwd_mma<D>, FwdSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  attn_fwd_mma<D><<<dim3(L / 64, BH), NT, FwdSmem<D>::BYTES, stream>>>(
      (const bf16*)qu, (const bf16*)k, (const bf16*)v, (const bf16*)bias, (bf16*)out, lse, H, L,
      scale, drop, os);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* qu, const void* k, const void* v, const void* bias, const void* g,
                const void* out, const float* lse, float* delta, void* dqu, void* dk, void* dv,
                void* dbias, int BH, int H, int L, float scale, Dropout drop, Strides gs,
                Strides os, cudaStream_t stream) {
  cudaError_t err = set_smem(attn_bwd_mma<D>, BwdSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  err = set_smem(attn_dqu_mma<D>, DquSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(L / 64, BH);
  attn_delta<D><<<BH * L / (256 / (D / 8)), 256, 0, stream>>>(
      (const bf16*)g, (const bf16*)out, delta, H, L, gs, os);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_mma<D><<<grid, NT, BwdSmem<D>::BYTES, stream>>>(
      (const bf16*)qu, (const bf16*)k, (const bf16*)v, (const bf16*)bias, (const bf16*)g, lse,
      delta, (bf16*)dk, (bf16*)dv, (bf16*)dbias, H, L, scale, drop, gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dqu_mma<D><<<grid, NT, DquSmem<D>::BYTES, stream>>>((const bf16*)dbias, (const bf16*)k,
                                                           (bf16*)dqu, L);
  return cudaGetLastError();
}

Dropout make_dropout(float rate, unsigned int seed, unsigned int thresh, float inv_keep) {
  Dropout d;
  d.seed = seed;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  d.active = rate > 0.f;
  return d;
}

Strides make_strides(const i64* s) {
  Strides r;
  r.b = s[0];
  r.h = s[1];
  r.l = s[2];
  return r;
}

}  // namespace

extern "C" {

// bf16 only; head_dim in {64, 128}; L a multiple of 64. out_strides: element
// strides of out over (b, h, l). lse: (B, H, L) float32, written.
// Returns cudaGetLastError() after the launch (0 on success).
int attn_mma_fwd(const void* qu, const void* k, const void* v, const void* bias, void* out,
                 void* lse, const long long* out_strides, int B, int H, int L, int head_dim,
                 float scale, float rate, unsigned int seed, unsigned int thresh, float inv_keep,
                 void* stream) {
  if (L % 64 != 0) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep);
  const Strides os = make_strides(out_strides);
  switch (head_dim) {
    case 64:
      return (int)fwd<64>(qu, k, v, bias, out, (float*)lse, B * H, H, L, scale, drop, os,
                          (cudaStream_t)stream);
    case 128:
      return (int)fwd<128>(qu, k, v, bias, out, (float*)lse, B * H, H, L, scale, drop, os,
                           (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

// g_strides, out_strides: element strides of g and out over (b, h, l).
// lse: the forward's; delta: (B, H, L) float32 scratch, written then read.
int attn_mma_bwd(const void* qu, const void* k, const void* v, const void* bias, const void* g,
                 const void* out, const void* lse, void* delta, void* dqu, void* dk, void* dv,
                 void* dbias, const long long* g_strides, const long long* out_strides, int B,
                 int H, int L, int head_dim, float scale, float rate, unsigned int seed,
                 unsigned int thresh, float inv_keep, void* stream) {
  if (L % 64 != 0) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep);
  const Strides gs = make_strides(g_strides), os = make_strides(out_strides);
  switch (head_dim) {
    case 64:
      return (int)bwd<64>(qu, k, v, bias, g, out, (const float*)lse, (float*)delta, dqu, dk, dv,
                          dbias, B * H, H, L, scale, drop, gs, os, (cudaStream_t)stream);
    case 128:
      return (int)bwd<128>(qu, k, v, bias, g, out, (const float*)lse, (float*)delta, dqu, dk, dv,
                           dbias, B * H, H, L, scale, drop, gs, os, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per block: which = 0 forward, 1 backward main pass,
// 2 backward dqu pass.
int attn_mma_smem_bytes(int head_dim, int which) {
  if (head_dim == 64)
    return which == 0 ? FwdSmem<64>::BYTES : which == 1 ? BwdSmem<64>::BYTES : DquSmem<64>::BYTES;
  return which == 0 ? FwdSmem<128>::BYTES : which == 1 ? BwdSmem<128>::BYTES : DquSmem<128>::BYTES;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
