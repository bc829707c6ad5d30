// Fused rel-pos attention on the H100's tensor cores in float32, forward and
// backward, at head dims 32, 64 and 128 and any sequence length L >= 1, as
// split-precision TF32 products (3xTF32). (bfloat16 at those head dims runs
// attention_mma.cu; head dim 16 runs the FMA kernels of attention.cu.)
//
// Replaces the Pallas TPU kernels of sarssl_tpu/kernels/attention.py:
//   forward  _call_fwd (_fwd_kernel, _attend) -> attn_fwd_tf32
//   backward _fa_bwd   (_bwd_kernel)          -> attn_delta_f32 + attn_bwd_tf32 + attn_dqu_tf32
//
//   s = (qu k^T + bias) * scale ; p = softmax(s) ; pd = dropout(p) ; out = pd v
//   dv = pd^T g ; dp = dropout'(g v^T) ; ds = p (dp - sum_j dp p)
//   dbias = ds * scale ; dqu = dbias k ; dk = dbias^T qu
//
// qu, k, v, dqu, dk, dv are (B, H, L, D) and bias, dbias (B, H, L, L),
// contiguous f32. out and g are (B, H, L, D) with any strides over (b, h, l)
// and a contiguous last dim (the wrapper hands the forward a (B, L, H, D)
// buffer for out, so the model's transpose back is a view).
//
// What bounds it on an H100: operations. f32 attention that keeps f32
// accuracy needs three TF32 products per product; at B=128, H=4, L=256,
// D=128 the forward's 17.2 GFLOP are 51.5 GFLOP of TF32 products (104 us at
// the 494.7 TFLOP/s dense rate) against 403 MB of bytes (120 us at 3.35
// TB/s), and the backward's 43 GFLOP make 129 GFLOP (260 us) against 805 MB
// (240 us). A plain TF32 product keeps 11 significant bits and misses the
// port's 1e-4 tolerance; the CUDA cores' f32 FMAs (attention.cu) run at 67
// TFLOP/s. The design:
//
//  * Every product is mma.sync.m16n8k8 on TF32 operands split as x = hi + lo
//    (hi = tf32(x), lo = tf32(x - hi), cvt.rna), taking lo*hi + hi*lo first
//    and then hi*hi into the f32 accumulator (mma_common.cuh): each product
//    exact to about 2^-22 of itself. A fragment is split once, where it is
//    loaded, for every product it feeds.
//  * Tiles of qu, k, v and g sit in shared memory as f32 rows padded to D + 4
//    floats (a row pitch of 4 banks mod 32), copied 16 bytes a thread with
//    cp.async and double-buffered. Operands whose rows run along the
//    product's k (q and k in q k^T; k, v, qu and g in the backward's k qu^T
//    and v g^T) are read with ldmatrix: an 8x8 b16 matrix is an 8x4 f32 one,
//    which is a TF32 fragment. Operands whose rows run along the product's n
//    (v in p v, g and qu in the backward's pd^T g and ds^T qu, k in dbias k)
//    are read as 32-bit words.
//  * The accumulator of a TF32 product holds columns (2t, 2t + 1) of its 8,
//    where the A operand of the next product wants (t, t + 4). So the keys
//    (queries in the backward) of each 8-wide step of p v, pd^T g and ds^T qu
//    are taken in the order 0, 2, 4, 6, 1, 3, 5, 7: the accumulator becomes
//    the next A fragment with no shuffle, and the B operand reads rows 2t and
//    2t + 1, which the 4-float pad keeps free of bank conflicts. The sum over
//    keys does not depend on their order.
//  * Forward: a block of 4 warps owns 64 query rows, each warp 16. It walks
//    the keys in tiles of 64 (32 at D = 128, where that lets two blocks share
//    an SM) with a running row max and sum (online softmax).
//    exp(s - m) is scaled by 1/(1-rate) where kept and multiplied into v; the
//    division by the row sum comes last. The reference divides first, then
//    drops and multiplies in f32: with no rounding to a narrower type in
//    between, only the order of the sums differs. lse = m + log(sum) per row
//    is written, (B,H,L) f32. At D <= 64 each warp keeps its qu fragments, hi
//    and lo, in registers (the qu tile shares its shared memory with the
//    second bias stage); at D = 128 that would be 128 registers, so the
//    fragments are loaded and split again from shared memory every tile.
//  * Backward: attn_delta_f32 writes delta_i = sum_d g_id out_id (equal to
//    sum_j dp_ij p_ij up to rounding). attn_bwd_tf32 runs per (b, h, tile of
//    64 keys), each warp owning 16 keys, and loops over the queries in steps
//    of 32 (16 at D = 128, where that lets two blocks share an SM): the
//    scores transposed (s^T = k qu^T, dp^T = v g^T), so p^T and
//    ds^T are A operands of dv += pd^T g and dk += ds^T qu, summed in
//    registers; the dbias tile goes through shared memory to 16-byte stores.
//    attn_dqu_tf32 then takes dqu = dbias k per (b, h, 64 query rows). No
//    atomics: results are bit-identical from run to run.
//  * Dropout, the tensor-parallel head map (h_total, h_offset) and the launch
//    grids are attention_mma.cu's: the counter hash of the flat (b, h, i, j)
//    index of the whole (B, h_total, L, L) tensor, from each element's own
//    (i, j), so the dropped positions equal the plain version's.
//  * Any L: each kernel has two instances, chosen at launch. EXACT (L a
//    multiple of 64, bias 16-byte aligned) has no predicate. The other takes
//    ceil(L / 64) tiles, zero-fills the qu, k, v and g rows past L (cp.async
//    with a source size of 0), sets the scores of keys >= L to -inf before
//    the running max, and stores no row >= L. An f32 bias row (4L bytes)
//    always starts 4-byte aligned, so this instance copies bias and dbias
//    tiles value by value (4-byte cp.async and stores) and reads lse and
//    delta the same way. Tiles do not depend on L: every L runs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

typedef long long i64;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 128;  // threads per block: 4 warps, 16 tile rows each
constexpr int BK = 64;   // keys per tile
constexpr int SBF = 72;  // row pitch (floats) of a 64-wide score tile read as float2 pairs
constexpr int SBT = 68;  // row pitch (floats) of a score tile read transposed

struct Dropout {
  uint32_t seed;
  uint32_t thresh;  // keep where hash >= thresh
  float inv_keep;   // 1 / (1 - rate)
  int active;
  int h_local, h_total, h_offset;  // this launch's heads among the whole tensor's
};

// (b, h) of a block's flat bh = b * h_local + h, as the dropout index reads
// it: b * h_total + h_offset + h
__device__ __forceinline__ uint32_t drop_bh(const Dropout& d, int bh) {
  return (uint32_t)((bh / d.h_local) * d.h_total + d.h_offset + bh % d.h_local);
}

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

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// copies `bytes` (0 or 4) from src and fills the rest of the 4 with zeros
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

// ROWS x D floats from device memory (row stride ld) -> tile of row pitch
// D + 4; with TAIL, rows >= nrows are zero-filled
template <int ROWS, int D, bool TAIL>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src, i64 ld, int nrows) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
  static_assert(ROWS * CH % NT == 0, "the tile's chunks divide among the threads");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx / CH, c = idx % CH;
    const uint32_t to = dst + (uint32_t)((r * (D + 4) + 4 * c) * 4);
    if constexpr (TAIL) {
      const bool ok = r < nrows;
      cp_async16_zfill(to, ok ? src + (i64)r * ld + 4 * c : src, ok ? 16 : 0);
    } else {
      cp_async16(to, src + (i64)r * ld + 4 * c);
    }
  }
}

// ROWS x W values of a (.., L, L) f32 matrix (row stride L) -> tile of row
// pitch P. EXACT: 16-byte copies. Else value by value (a row starts 4-byte
// aligned only), zeros at rows >= nrows and columns >= ncols.
template <int ROWS, int P, bool EXACT, int W = 64>
__device__ __forceinline__ void load_scores(uint32_t dst, const float* src, int L, int nrows,
                                            int ncols) {
  if constexpr (EXACT) {
    constexpr int CH = W / 4;
    static_assert(ROWS * CH % NT == 0, "the tile's chunks divide among the threads");
#pragma unroll
    for (int it = 0; it < ROWS * CH / NT; ++it) {
      const unsigned idx = threadIdx.x + it * NT;
      const int r = idx / CH, c = idx % CH;
      cp_async16(dst + (uint32_t)((r * P + 4 * c) * 4), src + (i64)r * L + 4 * c);
    }
  } else {
#pragma unroll 8
    for (int it = 0; it < ROWS * W / NT; ++it) {
      const unsigned idx = threadIdx.x + it * NT;
      const int r = idx / W, c = idx % W;
      const bool ok = r < nrows && c < ncols;
      cp_async4_zfill(dst + (uint32_t)((r * P + c) * 4), ok ? src + (i64)r * L + c : src,
                      ok ? 4 : 0);
    }
  }
}

// A fragment (16 rows x 8 k) of a tile of row pitch P whose rows run along
// k, by ldmatrix: a_base = tile + lane_a<P>(row0, lane), then + 32 bytes a k-step
template <int P>
__device__ __forceinline__ uint32_t lane_a(int row0, int lane) {
  return (uint32_t)(((row0 + (lane & 15)) * P + (lane >> 4) * 4) * 4);
}
// B fragments of two 8-wide n-tiles (rows n0..n0+15 of a tile of pitch P whose
// rows run along k) by one ldmatrix: regs {b0, b1} of n0, then of n0 + 8
template <int P>
__device__ __forceinline__ uint32_t lane_b(int lane) {
  return (uint32_t)((((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 4) * 4);
}

__device__ __forceinline__ void split4(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(x[e]), hi[e], lo[e]);
}

// acc (16 x 8*NTILES) += A (16 rows of a tile from a_addr) * B^T (rows
// 0..8*NTILES of a tile from b_addr), both of pitch D + 4 with rows along k
template <int D, int NTILES>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[NTILES][4], uint32_t a_addr,
                                              uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t a[4], ah[4], al[4];
    ldsm_x4(a, a_addr + 32 * kk);
    split4(a, ah, al);
#pragma unroll
    for (int np = 0; np < NTILES / 2; ++np) {
      uint32_t b[4], bh[4], bl[4];
      ldsm_x4(b, b_addr + (uint32_t)((np * 16 * (D + 4) + 8 * kk) * 4));
      split4(b, bh, bl);
      mma1688_3x(acc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma1688_3x(acc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// acc (16 x D) += P (16 x 8*KSTEPS, in the accumulator layout of a product:
// p[n] holds columns 8n + 2t, 8n + 2t + 1 of rows g, g + 8) * X (8*KSTEPS rows
// of a tile of pitch D + 4, the product's n along a row). Each 8-wide k-step
// takes its columns in the order 0, 2, 4, 6, 1, 3, 5, 7 (module note). With
// KEPT, P is max(p, 0) * scale: the backward's p^T carries a dropped
// position as -p, so this is the dropped and rescaled pd^T without a copy.
template <int D, int KSTEPS, bool KEPT = false>
__device__ __forceinline__ void mma_acc_rows(float (&acc)[D / 8][4], const float (&p)[KSTEPS][4],
                                             const float* x, float scale = 1.f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto a_of = [&](float e) { return KEPT ? fmaxf(e, 0.f) * scale : e; };
#pragma unroll
  for (int kc = 0; kc < KSTEPS; ++kc) {
    uint32_t ah[4], al[4];
    split_tf32(a_of(p[kc][0]), ah[0], al[0]);
    split_tf32(a_of(p[kc][2]), ah[1], al[1]);
    split_tf32(a_of(p[kc][1]), ah[2], al[2]);
    split_tf32(a_of(p[kc][3]), ah[3], al[3]);
    const float* r0 = x + (8 * kc + 2 * t) * (D + 4) + g;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(r0[8 * nd], bh0, bl0);
      split_tf32(r0[D + 4 + 8 * nd], bh1, bl1);
      mma1688_3x(acc[nd], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// The warp's 16 x D accumulator (rows row0 + g, row0 + g + 8) -> dst rows of
// stride ld in 8-byte stores; with TAIL only rows < nrows (relative to row0)
template <int D, bool TAIL>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4], float* dst, i64 ld,
                                          int nrows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool a = !TAIL || g < nrows, b = !TAIL || g + 8 < nrows;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (a) *reinterpret_cast<float2*>(dst + (i64)g * ld + 8 * n + 2 * t) =
        make_float2(acc[n][0], acc[n][1]);
    if (b) *reinterpret_cast<float2*>(dst + (i64)(g + 8) * ld + 8 * n + 2 * t) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(L/64), B*H); blockIdx.x is the query tile.
// smem: 2 x K tile, 2 x V tile, the bias tiles and the Q tile. At D <= 64:
// tiles of 64 keys, 2 bias stages, the Q tile in the second one (it is read
// into registers before that is filled). At D = 128: tiles of 32 keys and one
// bias stage (refilled once every warp has read it), which bring a block to
// 111,616 bytes, so two blocks share an SM.
// ---------------------------------------------------------------------------
template <int D>
struct FwdSmem {
  static constexpr bool QREG = D <= 64;  // qu fragments kept in registers
  static constexpr int BKF = QREG ? 64 : 32;  // keys a tile
  static constexpr int PB = BKF + 8;  // bias tile pitch: float2 reads free of conflicts
  static constexpr int BSTAGES = QREG ? 2 : 1;
  static constexpr int TILE = BKF * (D + 4) * 4;  // a K or V tile
  static constexpr int QTILE = 64 * (D + 4) * 4;
  static constexpr int BIAS = 64 * PB * 4;
  static constexpr int K = 0;         // 2 stages
  static constexpr int V = 2 * TILE;  // 2 stages
  static constexpr int B = 4 * TILE;  // BSTAGES stages
  static constexpr int Q = QREG ? B + BIAS : B + BSTAGES * BIAS;
  static constexpr int BYTES = B + BSTAGES * BIAS + (QREG ? 0 : QTILE);
  static_assert(!QREG || QTILE <= BIAS, "the qu tile fits in a bias stage");
  static_assert(TILE % 128 == 0 && BIAS % 128 == 0 && QTILE % 128 == 0,
                "tiles start 128-byte aligned");
};

template <int D, bool EXACT>
__global__ void __launch_bounds__(NT, D == 32 ? 3 : 2)
attn_fwd_tf32(const float* __restrict__ qu, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ out, float* __restrict__ lse, int H, int L, float scale,
              Dropout drop, Strides os) {
  typedef FwdSmem<D> S;
  constexpr int P = D + 4, BKF = S::BKF, PB = S::PB;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int bh = blockIdx.y, i0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const float* kp = k + (i64)bh * L * D;
  const float* vp = v + (i64)bh * L * D;
  const float* bp = bias + ((i64)bh * L + i0) * L;
  const int ntiles = (L + BKF - 1) / BKF;
  const int qrows = L - i0;  // the query tile's rows inside L

  load_rows<64, D, !EXACT>(sb + S::Q, qu + ((i64)bh * L + i0) * D, D, qrows);
  load_rows<BKF, D, !EXACT>(sb + S::K, kp, D, L);
  load_rows<BKF, D, !EXACT>(sb + S::V, vp, D, L);
  load_scores<64, PB, EXACT, BKF>(sb + S::B, bp, L, qrows, min(L, BKF));
  cp_async_commit();

  uint32_t qh[S::QREG ? D / 8 : 1][4], ql[S::QREG ? D / 8 : 1][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // rows g and g + 8
  const uint32_t row_a = (drop_bh(drop, bh) * L + i0 + r0 + g) * L, row_b = row_a + 8u * L;
  const uint32_t qa = sb + S::Q + lane_a<P>(r0, lane);
  const float sl2 = scale * LOG2E;

  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait_all();
    __syncthreads();
    const int st = tt & 1;
    if constexpr (S::QREG) {
      if (tt == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, qa + 32 * kk);
          split4(a, qh[kk], ql[kk]);
        }
        __syncthreads();  // the qu tile is the second bias stage, filled next
      }
    }
    const int j1 = (tt + 1) * BKF;
    if (tt + 1 < ntiles) {
      const int nx = st ^ 1;
      load_rows<BKF, D, !EXACT>(sb + S::K + nx * S::TILE, kp + (i64)j1 * D, D, L - j1);
      load_rows<BKF, D, !EXACT>(sb + S::V + nx * S::TILE, vp + (i64)j1 * D, D, L - j1);
      if constexpr (S::BSTAGES == 2)
        load_scores<64, PB, EXACT, BKF>(sb + S::B + nx * S::BIAS, bp + j1, L, qrows,
                                        min(L - j1, BKF));
      cp_async_commit();
    }

    // s = qu k^T for the warp's 16 rows and the tile's keys
    float s[BKF / 8][4];
#pragma unroll
    for (int n = 0; n < BKF / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const uint32_t kb = sb + S::K + st * S::TILE + lane_b<P>(lane);
    if constexpr (S::QREG) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
        for (int np = 0; np < BKF / 16; ++np) {
          uint32_t b[4], bh[4], bl[4];
          ldsm_x4(b, kb + (uint32_t)((np * 16 * P + 8 * kk) * 4));
          split4(b, bh, bl);
          mma1688_3x(s[2 * np], qh[kk], ql[kk], bh[0], bh[1], bl[0], bl[1]);
          mma1688_3x(s[2 * np + 1], qh[kk], ql[kk], bh[2], bh[3], bl[2], bl[3]);
        }
      }
    } else {
      mma_rows_rows<D, BKF / 8>(s, qa, kb);
    }

    // (s + bias) * scale in log2 units; keys >= L (zero rows of k) at -inf
    const float* bt =
        reinterpret_cast<const float*>(smem + S::B + (S::BSTAGES == 2 ? st : 0) * S::BIAS);
    const int kleft = L - tt * BKF;  // keys of this tile inside L
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < BKF / 8; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 ba = *reinterpret_cast<const float2*>(bt + (r0 + g) * PB + col);
      const float2 bb = *reinterpret_cast<const float2*>(bt + (r0 + g + 8) * PB + col);
      s[n][0] = (s[n][0] + ba.x) * sl2;
      s[n][1] = (s[n][1] + ba.y) * sl2;
      s[n][2] = (s[n][2] + bb.x) * sl2;
      s[n][3] = (s[n][3] + bb.y) * sl2;
      if constexpr (!EXACT) {
        if (col >= kleft) s[n][0] = s[n][2] = -INFINITY;
        if (col + 1 >= kleft) s[n][1] = s[n][3] = -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    if constexpr (S::BSTAGES == 1) {
      if (tt + 1 < ntiles) {  // every warp has read this tile's bias: refill it
        __syncthreads();
        load_scores<64, PB, EXACT, BKF>(sb + S::B, bp + j1, L, qrows, min(L - j1, BKF));
        cp_async_commit();
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    const float corr_a = fast_exp2(m_a - mn_a), corr_b = fast_exp2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // e = exp(s - m), summed; dropped or scaled by 1/(1-rate) into the A
    // operand of the product with v
    float sum_a = 0.f, sum_b = 0.f;
    const uint32_t j0 = (uint32_t)(tt * BKF);
#pragma unroll
    for (int n = 0; n < BKF / 8; ++n) {
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
    mma_acc_rows<D, BKF / 8>(o, s, reinterpret_cast<const float*>(smem + S::V + st * S::TILE));
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
    if (EXACT || r0 + g < qrows) lp[g] = (m_a + log2f(l_a)) / LOG2E;
    if (EXACT || r0 + g + 8 < qrows) lp[g + 8] = (m_b + log2f(l_b)) / LOG2E;
  }
  float* op = out + (bh / H) * os.b + (bh % H) * os.h + (i64)(i0 + r0) * os.l;
  store_acc<D, !EXACT>(o, op, os.l, qrows - r0);
}

// ---------------------------------------------------------------------------
// delta[b, h, i] = sum_d g[b, h, i, d] * out[b, h, i, d]; D/4 lanes per row
// ---------------------------------------------------------------------------
template <int D, bool EXACT>
__global__ void __launch_bounds__(256)
attn_delta_f32(const float* __restrict__ g, const float* __restrict__ out,
               float* __restrict__ delta, int H, int L, int rows, Strides gs, Strides os) {
  constexpr int LPR = D / 4;
  const int row = blockIdx.x * (256 / LPR) + threadIdx.x / LPR, c = threadIdx.x % LPR;
  // TAIL: the last block's rows past B*H*L read row 0 and write nothing (they
  // stay in the warp's shuffles)
  const bool live = EXACT || row < rows;
  const int rr = live ? row : 0;
  const int bh = rr / L, i = rr % L;
  const i64 b = bh / H, h = bh % H;
  const float4 gv = *reinterpret_cast<const float4*>(g + b * gs.b + h * gs.h + i * gs.l + 4 * c);
  const float4 ov =
      *reinterpret_cast<const float4*>(out + b * os.b + h * os.h + i * os.l + 4 * c);
  float sum = gv.x * ov.x;
  sum = fmaf(gv.y, ov.y, sum);
  sum = fmaf(gv.z, ov.z, sum);
  sum = fmaf(gv.w, ov.w, sum);
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (c == 0 && live) delta[row] = sum;
}

// ---------------------------------------------------------------------------
// backward, main pass: grid (ceil(L/64), B*H); blockIdx.x is the key tile.
// Each warp owns 16 keys and keeps their dv and dk in registers over the
// query loop.
// smem: K tile, V tile, 2 x (Q, G, bias tiles of BQ queries, lse, delta),
// dbias staging tile. BQ is 32, and 16 at D = 128, where that brings a block
// to 114,688 bytes, so two blocks share an SM.
// ---------------------------------------------------------------------------
template <int D>
struct BwdSmem {
  static constexpr int BQ = D == 128 ? 16 : 32;  // queries a step of the loop
  static constexpr int KV = 64 * (D + 4) * 4;
  static constexpr int QG = BQ * (D + 4) * 4;
  static constexpr int BIAS = BQ * SBT * 4;
  static constexpr int STAT = 2 * BQ * 4;  // lse then delta
  static constexpr int STAGE = 2 * QG + BIAS + STAT;
  static constexpr int K = 0;
  static constexpr int V = KV;
  static constexpr int ST = 2 * KV;  // 2 stages: Q, G, bias, stats
  static constexpr int DS = 2 * KV + 2 * STAGE;
  static constexpr int BYTES = DS + BIAS;
  static_assert(QG % 128 == 0 && STAGE % 128 == 0, "tiles start 128-byte aligned");
};

template <int D, bool EXACT>
__global__ void __launch_bounds__(NT, D == 32 ? 3 : 2)
attn_bwd_tf32(const float* __restrict__ qu, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ gr, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
              float* __restrict__ dbias, int H, int L, float scale, Dropout drop, Strides gs) {
  typedef BwdSmem<D> S;
  constexpr int P = D + 4, BQ = S::BQ;
  constexpr int QT = BQ / 8;  // 8-query accumulator tiles per step
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int bh = blockIdx.y, j0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // the warp's keys within the tile
  const float* qp = qu + (i64)bh * L * D;
  const float* gp = gr + (bh / H) * gs.b + (bh % H) * gs.h;
  const float* bp = bias + (i64)bh * L * L + j0;
  float* dbp = dbias + (i64)bh * L * L + j0;
  const float* lp = lse + (i64)bh * L;
  const float* dlp = delta + (i64)bh * L;
  const uint32_t dbh = drop_bh(drop, bh);
  const int nsteps = (L + BQ - 1) / BQ;
  const int kcols = min(L - j0, BK);  // the key tile's keys inside L

  auto load_stage = [&](int stage, int q0) {
    const uint32_t base = sb + S::ST + stage * S::STAGE;
    const uint32_t stat = base + 2 * S::QG + S::BIAS;
    const int nq = L - q0;
    load_rows<BQ, D, !EXACT>(base, qp + (i64)q0 * D, D, nq);
    load_rows<BQ, D, !EXACT>(base + S::QG, gp + (i64)q0 * gs.l, gs.l, nq);
    load_scores<BQ, SBT, EXACT>(base + 2 * S::QG, bp + (i64)q0 * L, L, nq, kcols);
    if constexpr (EXACT) {
      constexpr int SC = BQ / 4;  // 16-byte chunks of BQ floats
      if (threadIdx.x < 2 * SC) {
        const int c = threadIdx.x;
        cp_async16(stat + 16 * c, c < SC ? lp + q0 + 4 * c : dlp + q0 + 4 * (c - SC));
      }
    } else if (threadIdx.x < 2 * BQ) {
      const int c = threadIdx.x % BQ;
      const float* row = threadIdx.x < BQ ? lp : dlp;
      const bool ok = c < nq;
      cp_async4_zfill(stat + 4 * threadIdx.x, ok ? row + q0 + c : row, ok ? 4 : 0);
    }
  };

  load_rows<64, D, !EXACT>(sb + S::K, k + ((i64)bh * L + j0) * D, D, kcols);
  load_rows<64, D, !EXACT>(sb + S::V, v + ((i64)bh * L + j0) * D, D, kcols);
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
  const uint32_t ka = sb + S::K + lane_a<P>(r0, lane), va = sb + S::V + lane_a<P>(r0, lane);

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
    const float* qf = reinterpret_cast<const float*>(smem + stage_off);
    const float* gf = reinterpret_cast<const float*>(smem + stage_off + S::QG);
    const float* bt = reinterpret_cast<const float*>(smem + stage_off + 2 * S::QG);
    const float* stat = reinterpret_cast<const float*>(smem + stage_off + 2 * S::QG + S::BIAS);

    // p^T[key][query] = exp((k qu^T + bias^T) * scale - lse[query])
    float p[QT][4];
#pragma unroll
    for (int n = 0; n < QT; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    mma_rows_rows<D, QT>(p, ka, qt + lane_b<P>(lane));
    // p is never negative, so its sign bit carries the dropout mask to the
    // rest of the step: set where the position is dropped
#pragma unroll
    for (int n = 0; n < QT; ++n) {
      const int q = 8 * n + 2 * t;  // this thread's queries: q, q + 1
      const float2 ls = *reinterpret_cast<const float2*>(stat + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qq = q + (e & 1), kk = r0 + g + (e < 2 ? 0 : 8);
        const float b = bt[qq * SBT + kk];
        const float pe = fast_exp2((p[n][e] + b) * sl2 - ((e & 1) ? ls.y : ls.x) * LOG2E);
        bool kp = true;
        if (drop.active) kp = keep(drop, (dbh * L + q0 + qq) * L + (e < 2 ? key_a : key_b));
        p[n][e] = kp ? pe : -pe;
      }
    }
    // dv[key] += pd^T g, pd = p / (1 - rate) where kept, else 0
    mma_acc_rows<D, QT, true>(dva, p, gf, drop.inv_keep);

    // dp^T = v g^T through the same mask; ds = p (dp - delta); dbias = ds * scale
    float dpt[QT][4];
#pragma unroll
    for (int n = 0; n < QT; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    mma_rows_rows<D, QT>(dpt, va, gt + lane_b<P>(lane));
    float* dst = reinterpret_cast<float*>(smem + S::DS);
#pragma unroll
    for (int n = 0; n < QT; ++n) {
      const int q = 8 * n + 2 * t;
      const float2 dl = *reinterpret_cast<const float2*>(stat + BQ + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool kp = !signbit(p[n][e]);
        const float dpm = kp ? dpt[n][e] * drop.inv_keep : 0.f;
        const float ds = fabsf(p[n][e]) * (dpm - ((e & 1) ? dl.y : dl.x)) * scale;
        const int qq = q + (e & 1), kk = r0 + g + (e < 2 ? 0 : 8);
        dst[qq * SBT + kk] = ds;
        dpt[n][e] = ds;
      }
    }
    // dk[key] += dbias^T qu
    mma_acc_rows<D, QT>(dka, dpt, qf);

    // the dbias tile, BQ rows of 64 keys (rows and keys inside L)
    __syncthreads();
    float* db = dbp + (i64)q0 * L;
    if constexpr (EXACT) {
#pragma unroll
      for (int i2 = 0; i2 < BQ * 16 / NT; ++i2) {
        const int idx = threadIdx.x + i2 * NT, r = idx >> 4, c = idx & 15;
        *reinterpret_cast<float4*>(db + (i64)r * L + 4 * c) =
            *reinterpret_cast<const float4*>(dst + r * SBT + 4 * c);
      }
    } else {
      const int nq = L - q0;
#pragma unroll 4
      for (int i2 = 0; i2 < BQ * 64 / NT; ++i2) {
        const int idx = threadIdx.x + i2 * NT, r = idx >> 6, c = idx & 63;
        if (r < nq && c < kcols) db[(i64)r * L + c] = dst[r * SBT + c];
      }
    }
  }

  const i64 orow = ((i64)bh * L + j0 + r0) * D;
  store_acc<D, !EXACT>(dka, dk + orow, D, kcols - r0);
  store_acc<D, !EXACT>(dva, dv + orow, D, kcols - r0);
}

// ---------------------------------------------------------------------------
// backward, dqu = dbias k: grid (ceil(L/64), B*H); blockIdx.x is the query
// tile. smem: 2 x (dbias tile 64 x 64 at pitch SBF, K tile 64 x D)
// ---------------------------------------------------------------------------
template <int D>
struct DquSmem {
  static constexpr int A = 64 * SBF * 4;
  static constexpr int KT = 64 * (D + 4) * 4;
  static constexpr int STAGE = A + KT;
  static constexpr int BYTES = 2 * STAGE;
  static_assert(A % 128 == 0 && STAGE % 128 == 0, "tiles start 128-byte aligned");
};

template <int D, bool EXACT>
__global__ void __launch_bounds__(NT)
attn_dqu_tf32(const float* __restrict__ dbias, const float* __restrict__ k,
              float* __restrict__ dqu, int L) {
  typedef DquSmem<D> S;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int bh = blockIdx.y, i0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const float* ap = dbias + ((i64)bh * L + i0) * L;
  const float* kp = k + (i64)bh * L * D;
  const int ntiles = (L + BK - 1) / BK;
  const int qrows = L - i0;

  load_scores<64, SBF, EXACT>(sb, ap, L, qrows, min(L, BK));
  load_rows<64, D, !EXACT>(sb + S::A, kp, D, L);
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
      const int j1 = (tt + 1) * BK;
      load_scores<64, SBF, EXACT>(nx, ap + j1, L, qrows, min(L - j1, BK));
      load_rows<64, D, !EXACT>(nx + S::A, kp + (i64)j1 * D, D, L - j1);
      cp_async_commit();
    }
    // the warp's 16 dbias rows as accumulator-layout pairs: columns 8kc + 2t,
    // 8kc + 2t + 1 of rows g and g + 8, read as float2
    const float* a = reinterpret_cast<const float*>(smem + st * S::STAGE);
    float af[8][4];
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      const float2 x = *reinterpret_cast<const float2*>(a + (r0 + g) * SBF + 8 * kc + 2 * t);
      const float2 y = *reinterpret_cast<const float2*>(a + (r0 + g + 8) * SBF + 8 * kc + 2 * t);
      af[kc][0] = x.x;
      af[kc][1] = x.y;
      af[kc][2] = y.x;
      af[kc][3] = y.y;
    }
    mma_acc_rows<D, 8>(acc, af, reinterpret_cast<const float*>(smem + st * S::STAGE + S::A));
  }
  store_acc<D, !EXACT>(acc, dqu + ((i64)bh * L + i0 + r0) * D, D, qrows - r0);
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int D, bool EXACT>
cudaError_t fwd(const float* qu, const float* k, const float* v, const float* bias, float* out,
                float* lse, int BH, int H, int L, float scale, Dropout drop, Strides os,
                cudaStream_t stream) {
  cudaError_t err = set_smem(attn_fwd_tf32<D, EXACT>, FwdSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  attn_fwd_tf32<D, EXACT><<<dim3(ceil_div(L, 64), BH), NT, FwdSmem<D>::BYTES, stream>>>(
      qu, k, v, bias, out, lse, H, L, scale, drop, os);
  return cudaGetLastError();
}

template <int D, bool EXACT>
cudaError_t bwd(const float* qu, const float* k, const float* v, const float* bias,
                const float* g, const float* out, const float* lse, float* delta, float* dqu,
                float* dk, float* dv, float* dbias, int BH, int H, int L, float scale,
                Dropout drop, Strides gs, Strides os, cudaStream_t stream) {
  cudaError_t err = set_smem(attn_bwd_tf32<D, EXACT>, BwdSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  err = set_smem(attn_dqu_tf32<D, EXACT>, DquSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(L, 64), BH);
  attn_delta_f32<D, EXACT><<<ceil_div(BH * L, 256 / (D / 4)), 256, 0, stream>>>(
      g, out, delta, H, L, BH * L, gs, os);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_tf32<D, EXACT><<<grid, NT, BwdSmem<D>::BYTES, stream>>>(
      qu, k, v, bias, g, lse, delta, dk, dv, dbias, H, L, scale, drop, gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dqu_tf32<D, EXACT><<<grid, NT, DquSmem<D>::BYTES, stream>>>(dbias, k, dqu, L);
  return cudaGetLastError();
}

Dropout make_dropout(float rate, unsigned int seed, unsigned int thresh, float inv_keep,
                     int h_local, int h_total, int h_offset) {
  Dropout d;
  d.seed = seed;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  d.active = rate > 0.f;
  d.h_local = h_local;
  d.h_total = h_total;
  d.h_offset = h_offset;
  return d;
}

Strides make_strides(const i64* s) {
  Strides r;
  r.b = s[0];
  r.h = s[1];
  r.l = s[2];
  return r;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The instance a launch takes: EXACT where every tile is whole and the bias
// rows are 16-byte aligned, the general one elsewhere.
bool exact_tiles(int L, const void* bias) { return L % 64 == 0 && aligned16(bias); }

// qu, k, v (and dqu, dk, dv, dbias, which the wrapper allocates) are read in
// 16-byte chunks of their rows: their bases must be 16-byte aligned
bool valid(int L, int H, int h_total, int h_offset, const void* qu, const void* k,
           const void* v) {
  return L >= 1 && h_offset >= 0 && h_offset + H <= h_total && aligned16(qu) && aligned16(k) &&
         aligned16(v);
}

}  // namespace

extern "C" {

// float32 only; head_dim in {32, 64, 128}; any L >= 1. out_strides: element
// strides of out over (b, h, l) (multiples of 4: rows 16-byte aligned). lse:
// (B, H, L) float32, written. The H heads are h_offset .. h_offset + H of
// h_total for the dropout index (H, 0 for all). Returns cudaGetLastError()
// after the launch (0 on success).
int attn_tf32_fwd(const void* qu, const void* k, const void* v, const void* bias, void* out,
                  void* lse, const long long* out_strides, int B, int H, int L, int head_dim,
                  float scale, float rate, unsigned int seed, unsigned int thresh, float inv_keep,
                  int h_total, int h_offset, void* stream) {
  if (!valid(L, H, h_total, h_offset, qu, k, v)) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
  const Strides os = make_strides(out_strides);
  const bool exact = exact_tiles(L, bias);
#define ATTN_FWD(D, E)                                                                      \
  fwd<D, E>((const float*)qu, (const float*)k, (const float*)v, (const float*)bias,          \
            (float*)out, (float*)lse, B * H, H, L, scale, drop, os, (cudaStream_t)stream)
  switch (head_dim) {
    case 32:
      return (int)(exact ? ATTN_FWD(32, true) : ATTN_FWD(32, false));
    case 64:
      return (int)(exact ? ATTN_FWD(64, true) : ATTN_FWD(64, false));
    case 128:
      return (int)(exact ? ATTN_FWD(128, true) : ATTN_FWD(128, false));
  }
#undef ATTN_FWD
  return (int)cudaErrorInvalidValue;
}

// g_strides, out_strides: element strides of g and out over (b, h, l).
// lse: the forward's; delta: (B, H, L) float32 scratch, written then read.
// h_total, h_offset as in attn_tf32_fwd.
int attn_tf32_bwd(const void* qu, const void* k, const void* v, const void* bias, const void* g,
                  const void* out, const void* lse, void* delta, void* dqu, void* dk, void* dv,
                  void* dbias, const long long* g_strides, const long long* out_strides, int B,
                  int H, int L, int head_dim, float scale, float rate, unsigned int seed,
                  unsigned int thresh, float inv_keep, int h_total, int h_offset, void* stream) {
  if (!valid(L, H, h_total, h_offset, qu, k, v) || !aligned16(dbias))
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
  const Strides gs = make_strides(g_strides), os = make_strides(out_strides);
  const bool exact = exact_tiles(L, bias);
#define ATTN_BWD(D, E)                                                                      \
  bwd<D, E>((const float*)qu, (const float*)k, (const float*)v, (const float*)bias,          \
            (const float*)g, (const float*)out, (const float*)lse, (float*)delta, (float*)dqu, \
            (float*)dk, (float*)dv, (float*)dbias, B * H, H, L, scale, drop, gs, os,          \
            (cudaStream_t)stream)
  switch (head_dim) {
    case 32:
      return (int)(exact ? ATTN_BWD(32, true) : ATTN_BWD(32, false));
    case 64:
      return (int)(exact ? ATTN_BWD(64, true) : ATTN_BWD(64, false));
    case 128:
      return (int)(exact ? ATTN_BWD(128, true) : ATTN_BWD(128, false));
  }
#undef ATTN_BWD
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per block: which = 0 forward, 1 backward main pass,
// 2 backward dqu pass (the same in both instances).
int attn_tf32_smem_bytes(int head_dim, int which) {
  switch (head_dim) {
    case 32:
      return which == 0 ? FwdSmem<32>::BYTES : which == 1 ? BwdSmem<32>::BYTES
                                                          : DquSmem<32>::BYTES;
    case 64:
      return which == 0 ? FwdSmem<64>::BYTES : which == 1 ? BwdSmem<64>::BYTES
                                                          : DquSmem<64>::BYTES;
    case 128:
      return which == 0 ? FwdSmem<128>::BYTES : which == 1 ? BwdSmem<128>::BYTES
                                                           : DquSmem<128>::BYTES;
  }
  return -1;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
