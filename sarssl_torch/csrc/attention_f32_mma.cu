// Fused rel-pos attention on the H100's tensor cores in float32, forward and
// backward, at head dims 16, 32, 64 and 128, and past 128 on the wide
// instance (a multiple of WDC = 64 as it is, any other head dim unpadded
// through its column tail, attn_*_cols), at any sequence length L >= 1, as
// split-precision TF32 products (3xTF32). (bfloat16 runs attention_mma.cu; the
// wrapper runs every other head dim up to 128 on the next of these instances,
// on zero-padded inputs.)
//
// Replaces the Pallas TPU kernels of sarssl_tpu/kernels/attention.py:
//   forward  _call_fwd (_fwd_kernel, _attend) -> attn_fwd_tf32
//                                                (wide: attn_fwd_scores_wide_tf32 +
//                                                 attn_fwd_pv_wide_tf32)
//   backward _fa_bwd   (_bwd_kernel)          -> attn_delta_f32 + attn_bwd_tf32 + attn_dqu_tf32
//                                                (wide: attn_delta_wide_f32 +
//                                                 attn_bwd_ds_wide_tf32 + 3 x attn_prod_wide_tf32)
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
// Any B and H: a grid's y / z dimension holds 65535 blocks, so the wrapper
// (kernels/attention.py::attention_chunks) covers B * H (b, h) pairs in
// launches of at most that many, each entry call given its pairs' pointers,
// its heads' place (h_offset) and a seed shifted past the batches before it;
// the kernels are the same. Offsets into bias, dbias, pd and the score
// scratch are 64-bit (i64), so B * H * L * L may pass 2^32 at rate 0; at a
// rate above 0 the wrapper keeps the uint32 dropout index below it.
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
//  * Past L = 1024 every sum over L (out = p v, dv, dk, dqu; the wide p v and
//    products) takes each tile's products into a zeroed fragment and adds
//    that to the running sum in f32 (mma_acc_rows' PSUM instances): the
//    tensor core's adder cuts its sum toward zero, so a running sum held in
//    its C operand drifts with the number of products (5.2e-4 from float64
//    at L = 65600 without; PERF.md §5). This file built as it is holds the
//    instances without PSUM; attention_f32_mma_psum.cu builds it with
//    ATTN_F32_PSUM = 1, the instances with PSUM, as a library of its own
//    (the two compile in parallel), and kernels/attention.py takes that
//    library past F32_PSUM_MIN_L = 1024.
//  * Tiles of qu, k, v and g sit in shared memory as f32 rows padded to D + 4
//    floats (a row pitch of 4 banks mod 32; 20 floats, 80 bytes, at D = 16,
//    which keeps every row 16-byte aligned), copied 16 bytes a thread with
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
//  * Head dim 16: q k^T is two k-steps of m16n8k8, p v (and the backward's
//    products into dv, dk and dqu) two n8 output tiles. The bias and dbias are
//    then 128 of the forward's 160 MiB at B=128, H=4, L=256 and the TF32
//    products a fifth of the time the bytes need, so the work a score takes
//    outside the products (exp, the split of p, the dropout hash, ds) weighs
//    most. Four blocks share an SM in both passes (the launch bounds below,
//    measured, PERF.md: at five or six the forward spills, and both
//    passes run slower).
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
//  * Head dims past 128, the wide instance: attention_mma.cu's design (the
//    scores once to an f32 scratch, the key tiles of a query tile split over
//    blocks where the batch is small, then out = p v in DC-column blocks; the
//    backward's dbias and pd once, then three products), with every product
//    3xTF32 as above. The streamed chunks are WKC = 32 columns (rows of 36
//    floats), so the backward's four chunk tiles, double-buffered, leave room
//    for two blocks an SM; pd is f32, and dbias and pd are stored straight
//    from the accumulators. At D = 256 it runs in place of an instance of its
//    own, which it beat by 27-29% forward and backward on an H100 80GB HBM3
//    at 700 W (PERF.md §5).
#include <initializer_list>

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
// 0..8*NTILES of a tile from b_addr), both of pitch D + 4 with rows along k;
// UNROLL k-steps unrolled together
template <int D, int NTILES, int UNROLL = D / 8>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[NTILES][4], uint32_t a_addr,
                                              uint32_t b_addr) {
#pragma unroll (UNROLL)
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

// f32 -> tf32 as tf32_rna, as an instruction the compiler neither merges with
// an equal one nor hoists: mma_acc_rows with PSUM splits P again for each
// chunk of output tiles rather than keeping every chunk's split live
__device__ __forceinline__ uint32_t tf32_rna_again(float x) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Whether this library's instances take partial sums over L (mma_acc_rows'
// PSUM; module note): they cost registers and time (PERF.md §5), so the
// wrapper takes them only past L = 1024, below which the running sums drift
// less than at L = 4096, where they read 4.3e-5 from float64.
#ifndef ATTN_F32_PSUM
#define ATTN_F32_PSUM 0
#endif
constexpr bool LIB_PSUM = ATTN_F32_PSUM != 0;

// acc (16 x D) += P (16 x 8*KSTEPS, in the accumulator layout of a product:
// p[n] holds columns 8n + 2t, 8n + 2t + 1 of rows g, g + 8) * X (8*KSTEPS rows
// of a tile of pitch D + 4, the product's n along a row). Each 8-wide k-step
// takes its columns in the order 0, 2, 4, 6, 1, 3, 5, 7 (module note). With
// KEPT, P is max(p, 0) * scale: the backward's p^T carries a dropped
// position as -p, so this is the dropped and rescaled pd^T without a copy.
//
// Every caller sums over L, one tile a call (keys in the forward's p v and
// dqu = dbias k, queries in dv and dk). The tensor core's adder cuts the sum
// of an mma's products and its C operand toward zero, so a product added
// straight into a running sum shortens it by up to an ulp of that whole sum:
// over L = 65600 keys the forward's out drifted 5.2e-4 from float64
// (scripts/emulate_tf32_sums.py, PERF.md §5). With PSUM the call's products
// go into a zeroed fragment, CT = 4 n8 output tiles at a time (2 at D = 16),
// which joins acc by f32 adds (rounded to nearest), so a partial sum covers
// one tile: P is split again for each chunk, 4 CT more registers a thread and
// no second accumulator. (The wide p v and products take 64 output columns a
// block with PSUM: at 128 the products spill.)
template <int D, int KSTEPS, bool PSUM, bool KEPT = false>
__device__ __forceinline__ void mma_acc_rows(float (&acc)[D / 8][4], const float (&p)[KSTEPS][4],
                                             const float* x, float scale = 1.f) {
  constexpr int CT = !PSUM ? D / 8 : D / 8 < 4 ? D / 8 : 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto a_of = [&](float e) { return KEPT ? fmaxf(e, 0.f) * scale : e; };
  auto split_a = [&](float e, uint32_t& hi, uint32_t& lo) {
    const float v = a_of(e);
    hi = CT == D / 8 ? tf32_rna(v) : tf32_rna_again(v);
    lo = CT == D / 8 ? tf32_rna(v - __uint_as_float(hi))
                     : tf32_rna_again(v - __uint_as_float(hi));
  };
#pragma unroll
  for (int c0 = 0; c0 < D / 8; c0 += CT) {
    float part[PSUM ? CT : 1][4];
    if constexpr (PSUM) {
#pragma unroll
      for (int nd = 0; nd < CT; ++nd) part[nd][0] = part[nd][1] = part[nd][2] = part[nd][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < KSTEPS; ++kc) {
      uint32_t ah[4], al[4];
      split_a(p[kc][0], ah[0], al[0]);
      split_a(p[kc][2], ah[1], al[1]);
      split_a(p[kc][1], ah[2], al[2]);
      split_a(p[kc][3], ah[3], al[3]);
      const float* r0 = x + (8 * kc + 2 * t) * (D + 4) + g + 8 * c0;
#pragma unroll
      for (int nd = 0; nd < CT; ++nd) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(r0[8 * nd], bh0, bl0);
        split_tf32(r0[D + 4 + 8 * nd], bh1, bl1);
        mma1688_3x(PSUM ? part[nd] : acc[c0 + nd], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    if constexpr (PSUM) {
#pragma unroll
      for (int nd = 0; nd < CT; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c0 + nd][e] += part[nd][e];
    }
  }
}

// The warp's 16 x N accumulator (rows row0 + g, row0 + g + 8) -> the first N
// columns of dst's rows of stride ld in 8-byte stores; with TAIL only rows <
// nrows (relative to row0)
template <int N, bool TAIL>
__device__ __forceinline__ void store_acc(const float (&acc)[N / 8][4], float* dst, i64 ld,
                                          int nrows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool a = !TAIL || g < nrows, b = !TAIL || g + 8 < nrows;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (a) *reinterpret_cast<float2*>(dst + (i64)g * ld + 8 * n + 2 * t) =
        make_float2(acc[n][0], acc[n][1]);
    if (b) *reinterpret_cast<float2*>(dst + (i64)(g + 8) * ld + 8 * n + 2 * t) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// The wide instance's column tail (a head dim D no multiple of its chunks,
// read unpadded): load_rows with zeros at the columns >= ncols as well. The
// rows are AL-byte aligned (16, 8 or 4: the launch's least, of the bases and
// the strides), so each is copied in pieces of AL bytes, each whole inside
// ncols or past it (D is a multiple of AL / 4). A whole chunk of 16-byte
// aligned rows takes load_rows' copies.
template <int ROWS, int W, bool TAIL, int AL>
__device__ __forceinline__ void load_rows_cols(uint32_t dst, const float* src, i64 ld, int nrows,
                                               int ncols) {
  constexpr int CH = W / 4;  // 16-byte chunks a row
  static_assert(ROWS * CH % NT == 0, "the tile's chunks divide among the threads");
  if (AL == 16 && ncols >= W) {  // a whole chunk of 16-byte aligned rows: load_rows' copies
    load_rows<ROWS, W, TAIL>(dst, src, ld, nrows);
    return;
  }
  // the tail: a rolled loop, so its addresses hold no registers across the caller's
#pragma unroll 1
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx / CH, c = idx % CH;
    const uint32_t to = dst + (uint32_t)((r * (W + 4) + 4 * c) * 4);
    const bool row_ok = !TAIL || r < nrows;
    const float* from = src + (i64)r * ld + 4 * c;
    if constexpr (AL == 16) {
      const bool ok = row_ok && 4 * c < ncols;
      cp_async16_zfill(to, ok ? from : src, ok ? 16 : 0);
    } else if constexpr (AL == 8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = row_ok && 4 * c + 2 * e < ncols;
        cp_async8_zfill(to + 8 * e, ok ? from + 2 * e : src, ok ? 8 : 0);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && 4 * c + e < ncols;
        cp_async4_zfill(to + 4 * e, ok ? from + e : src, ok ? 4 : 0);
      }
    }
  }
}

// store_acc with the column tail: only the first ncols columns, a float2 a
// lane where the rows are 8-byte aligned (D even), else value by value
template <int N, bool TAIL, int AL>
__device__ __forceinline__ void store_acc_cols(const float (&acc)[N / 8][4], float* dst, i64 ld,
                                               int nrows, int ncols) {
  if (AL >= 8 && ncols >= N) {  // every column, rows 8-byte aligned: store_acc
    store_acc<N, TAIL>(acc, dst, ld, nrows);
    return;
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool a = !TAIL || g < nrows, b = !TAIL || g + 8 < nrows;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= ncols) continue;
    float* ra = dst + (i64)g * ld + col;
    float* rb = dst + (i64)(g + 8) * ld + col;
    if constexpr (AL >= 8) {
      if (a) *reinterpret_cast<float2*>(ra) = make_float2(acc[n][0], acc[n][1]);
      if (b) *reinterpret_cast<float2*>(rb) = make_float2(acc[n][2], acc[n][3]);
    } else {
      const bool two = col + 1 < ncols;
      if (a) {
        ra[0] = acc[n][0];
        if (two) ra[1] = acc[n][1];
      }
      if (b) {
        rb[0] = acc[n][2];
        if (two) rb[1] = acc[n][3];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward (D <= 128): grid (ceil(L/64), B*H); blockIdx.x is the query tile.
// smem: 2 x K tile, 2 x V tile, the bias tiles and the Q tile. At D <= 64:
// tiles of 64 keys, 2 bias stages, the Q tile in the second one (it is read
// into registers before that is filled). At D = 128: tiles of 32 keys and
// one bias stage (refilled once every warp has read it), which bring a block
// to 111,616 bytes, so two blocks share an SM.
// ---------------------------------------------------------------------------
template <int D>
struct FwdSmem {
  static_assert(D <= 128, "the wide instance takes head dims past 128");
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

// Blocks an SM that each pass's launch bounds ask for, from the registers its
// accumulators leave room for. At D = 16 (57,344 B of shared memory forward,
// 47,104 B backward: four blocks an SM) 3 to 6 were measured (PERF.md): at
// five or six the forward spills, and both passes run slower.
template <int D>
__host__ __device__ constexpr int fwd_blocks() {
  return D == 16 ? 4 : D == 32 ? 3 : 2;
}
template <int D>
__host__ __device__ constexpr int bwd_blocks() {
  return D == 16 ? 4 : D == 32 ? 3 : 2;
}

template <int D, bool EXACT, bool PSUM>
__global__ void __launch_bounds__(NT, fwd_blocks<D>())
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
    mma_acc_rows<D, BKF / 8, PSUM>(o, s,
                                   reinterpret_cast<const float*>(smem + S::V + st * S::TILE));
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
// delta[b, h, i] = sum_d g[b, h, i, d] * out[b, h, i, d]; delta_lanes(D)
// lanes per row (a warp's 32 at most), 16 bytes of each row a lane a step
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int delta_lanes() {
  return D / 4 < 32 ? D / 4 : 32;
}

template <int D, bool EXACT>
__global__ void __launch_bounds__(256)
attn_delta_f32(const float* __restrict__ g, const float* __restrict__ out,
               float* __restrict__ delta, int H, int L, int rows, Strides gs, Strides os) {
  constexpr int LPR = delta_lanes<D>();
  const int row = blockIdx.x * (256 / LPR) + threadIdx.x / LPR, c = threadIdx.x % LPR;
  // TAIL: the last block's rows past B*H*L read row 0 and write nothing (they
  // stay in the warp's shuffles)
  const bool live = EXACT || row < rows;
  const int rr = live ? row : 0;
  const int bh = rr / L, i = rr % L;
  const i64 b = bh / H, h = bh % H;
  const float* gr = g + b * gs.b + h * gs.h + i * gs.l;
  const float* orow = out + b * os.b + h * os.h + i * os.l;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < D / 4 / LPR; ++j) {
    const float4 gv = *reinterpret_cast<const float4*>(gr + 4 * (c + j * LPR));
    const float4 ov = *reinterpret_cast<const float4*>(orow + 4 * (c + j * LPR));
    sum = fmaf(gv.x, ov.x, sum);
    sum = fmaf(gv.y, ov.y, sum);
    sum = fmaf(gv.z, ov.z, sum);
    sum = fmaf(gv.w, ov.w, sum);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (c == 0 && live) delta[row] = sum;
}

// ---------------------------------------------------------------------------
// backward, main pass (D <= 128): grid (ceil(L/64), B*H); blockIdx.x is the
// key tile. Each warp owns 16 keys and keeps their dv and dk in registers
// over the query loop.
// smem: K tile, V tile, 2 x (Q, G, bias tiles of BQ queries, lse, delta),
// dbias staging tile. BQ is 32, and 16 at D = 128 (where that brings a block
// to 114,688 bytes, so two blocks share an SM).
// ---------------------------------------------------------------------------
template <int D>
struct BwdSmem {
  static_assert(D <= 128, "the wide instance takes head dims past 128");
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

template <int D, bool EXACT, bool PSUM>
__global__ void __launch_bounds__(NT, bwd_blocks<D>())
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
    mma_acc_rows<D, QT, PSUM, true>(dva, p, gf, drop.inv_keep);

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
    mma_acc_rows<D, QT, PSUM>(dka, dpt, qf);

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
// backward, dqu = dbias k (D <= 128): grid (ceil(L/64), B*H); blockIdx.x is
// the tile of 64 query rows, which walks its 64 rows of dbias in tiles of 64.
// smem: 2 x (dbias tile 64 x 64 at pitch SBF, k tile 64 x D)
// ---------------------------------------------------------------------------
template <int D>
struct DquSmem {
  static constexpr int A = 64 * SBF * 4;
  static constexpr int KT = 64 * (D + 4) * 4;
  static constexpr int STAGE = A + KT;
  static constexpr int BYTES = 2 * STAGE;
  static_assert(A % 128 == 0 && STAGE % 128 == 0, "tiles start 128-byte aligned");
};

template <int D, bool EXACT, bool PSUM>
__global__ void __launch_bounds__(NT)
attn_dqu_tf32(const float* __restrict__ dbias, const float* __restrict__ k,
              float* __restrict__ dqu, int L) {
  typedef DquSmem<D> S;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int bh = blockIdx.y, o0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const float* kp = k + (i64)bh * L * D;
  const float* ap = dbias + ((i64)bh * L + o0) * L;
  const int ntiles = (L + BK - 1) / BK;
  const int orows = L - o0;  // the output tile's rows inside L

  load_scores<64, SBF, EXACT>(sb, ap, L, orows, min(L, BK));
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
      load_scores<64, SBF, EXACT>(nx, ap + j1, L, orows, min(L - j1, BK));
      load_rows<64, D, !EXACT>(nx + S::A, kp + (i64)j1 * D, D, L - j1);
      cp_async_commit();
    }
    // the warp's 16 rows of dbias as accumulator-layout pairs: columns 8kc +
    // 2t, 8kc + 2t + 1 of rows g and g + 8, by float2 reads along a row
    const float* a = reinterpret_cast<const float*>(smem + st * S::STAGE);
    float af[8][4];
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      const float2 u = *reinterpret_cast<const float2*>(a + (r0 + g) * SBF + 8 * kc + 2 * t);
      const float2 w = *reinterpret_cast<const float2*>(a + (r0 + g + 8) * SBF + 8 * kc + 2 * t);
      af[kc][0] = u.x;
      af[kc][1] = u.y;
      af[kc][2] = w.x;
      af[kc][3] = w.y;
    }
    mma_acc_rows<D, 8, PSUM>(acc, af,
                             reinterpret_cast<const float*>(smem + st * S::STAGE + S::A));
  }
  store_acc<D, !EXACT>(acc, dqu + ((i64)bh * L + o0 + r0) * D, D, orows - r0);
}

// ===========================================================================
// The wide instance: every head dim above 128 (module note). Dp, the head
// dim, is a runtime argument; no tile and no register array depends on it.
// ===========================================================================
// The wide instance takes a multiple of WDC (WIDE_CHUNK in kernels/attention.py)
// as it is and any other head dim D through the column tail of the _cols
// kernels (the same code, instances of their own): ceil(D / WKC) chunks, the
// last one read with zeros past D and stored only up to it, each row copied
// in pieces of its alignment (16, 8 or 4 bytes: D % 4, D even, D odd), so the
// results are the padded ones' with no padding copy in device memory. The p
// v and product passes take 2 WDC output columns a
// block where ceil(Dp / WDC) is even, else WDC (measured, PERF.md §5); with
// PSUM always WDC (their partial sums spill at 2 WDC).
constexpr int WDC = 64;
constexpr int WKC = 32;   // columns of a streamed qu / k / g / v chunk (pitch WKC + 4)
static_assert(WDC % WKC == 0 && WDC % 64 == 0, "Dp is whole chunks and whole delta steps");

// ---------------------------------------------------------------------------
// wide forward, pass 1: grid (ceil(L/64), B*H, S). The block's 64 query rows
// against its split's key tiles (attention_mma.cu's partition): s = sum over
// the Dp / KC chunks of qu_c k_c^T (chunks streamed through a cp.async double
// buffer in (key tile, chunk) order), (s + bias) * scale in log2 units, keys
// >= L at -inf, written to the f32 score scratch (B*H, Lp, Lp), Lp = 64
// ceil(L / 64), with the running row max and sum; at S = 1 lse per row at the
// end, else the rows' partial max and sum (log2 units) to part (2, B*H, S,
// Lp), which the p v pass merges.
// smem: 2 x (qu chunk, k chunk), 2 x bias tile
// ---------------------------------------------------------------------------
template <int KC>
struct WideScoresSmem {
  static constexpr int CH = 64 * (KC + 4) * 4;  // a 64-row chunk tile
  static constexpr int STAGE = 2 * CH;
  static constexpr int BIAS = 64 * SBF * 4;
  static constexpr int B = 2 * STAGE;           // 2 bias stages
  static constexpr int BYTES = B + 2 * BIAS;
  static_assert(CH % 128 == 0 && BIAS % 128 == 0, "tiles start 128-byte aligned");
};

template <int KC, bool EXACT, int AL>
__device__ __forceinline__ void wide_scores(const float* qu, const float* k, const float* bias,
                                            float* scores, float* lse, float* part, int L, int Dp,
                                            float scale) {
  constexpr bool CT = AL != 0;  // the column tail, rows in pieces of AL bytes
  typedef WideScoresSmem<KC> S;
  constexpr int P = KC + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int bh = blockIdx.y, i0 = blockIdx.x * 64, nsplit = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int nkc = (CT ? Dp + KC - 1 : Dp) / KC, ntiles = (L + BK - 1) / BK, Lp = ntiles * BK;
  const int per = (ntiles + nsplit - 1) / nsplit, tt0 = blockIdx.z * per;
  const int nsteps = max(min(per, ntiles - tt0), 0) * nkc;
  const int qrows = L - i0;
  const float* qp = qu + ((i64)bh * L + i0) * Dp;
  const float* kp = k + (i64)bh * L * Dp;
  const float* bp = bias + ((i64)bh * L + i0) * L;

  // step s: chunk s % nkc of key tile tt0 + s / nkc; a tile's first chunk
  // also brings its bias, into the stage the tile before last has left
  auto load_step = [&](int s) {
    const int tt = tt0 + s / nkc, c = s % nkc, j = tt * BK;
    const uint32_t st = sb + (s & 1) * S::STAGE;
    if constexpr (CT) {
      load_rows_cols<64, KC, !EXACT, AL>(st, qp + c * KC, Dp, qrows, Dp - c * KC);
      load_rows_cols<64, KC, !EXACT, AL>(st + S::CH, kp + (i64)j * Dp + c * KC, Dp, L - j,
                                     Dp - c * KC);
    } else {
      load_rows<64, KC, !EXACT>(st, qp + c * KC, Dp, qrows);
      load_rows<64, KC, !EXACT>(st + S::CH, kp + (i64)j * Dp + c * KC, Dp, L - j);
    }
    if (c == 0)
      load_scores<64, SBF, EXACT>(sb + S::B + (tt & 1) * S::BIAS, bp + j, L, qrows,
                                  min(L - j, BK));
  };
  if (nsteps > 0) load_step(0);
  cp_async_commit();

  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // rows g and g + 8
  const float sl2 = scale * LOG2E;
  float* sa = scores + ((i64)bh * Lp + i0 + r0 + g) * Lp;
  float* sbr = sa + 8 * (i64)Lp;

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < nsteps) {
      load_step(step + 1);
      cp_async_commit();
    }
    const uint32_t st = sb + (step & 1) * S::STAGE;
    mma_rows_rows<KC, 8>(s, st + lane_a<P>(r0, lane), st + S::CH + lane_b<P>(lane));
    if (step % nkc != nkc - 1) continue;

    // the key tile's scores are whole: bias, scale, running max and sum, out
    const int tt = tt0 + step / nkc, kleft = L - tt * BK;
    const float* bt = reinterpret_cast<const float*>(smem + S::B + (tt & 1) * S::BIAS);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 ba = *reinterpret_cast<const float2*>(bt + (r0 + g) * SBF + col);
      const float2 bb = *reinterpret_cast<const float2*>(bt + (r0 + g + 8) * SBF + col);
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
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sum_a += fast_exp2(s[n][0] - mn_a) + fast_exp2(s[n][1] - mn_a);
      sum_b += fast_exp2(s[n][2] - mn_b) + fast_exp2(s[n][3] - mn_b);
      const int col = tt * BK + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(sa + col) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(sbr + col) = make_float2(s[n][2], s[n][3]);
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
    l_a = l_a * fast_exp2(m_a - mn_a) + sum_a;
    l_b = l_b * fast_exp2(m_b - mn_b) + sum_b;
    m_a = mn_a;
    m_b = mn_b;
  }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (t == 0) {
    if (nsplit == 1) {
      float* lp = lse + (i64)bh * L + i0 + r0;
      if (EXACT || r0 + g < qrows) lp[g] = (m_a + log2f(l_a)) / LOG2E;
      if (EXACT || r0 + g + 8 < qrows) lp[g + 8] = (m_b + log2f(l_b)) / LOG2E;
    } else {  // every row of the tile: part holds Lp rows
      float* pm = part + ((i64)bh * nsplit + blockIdx.z) * Lp + i0 + r0 + g;
      float* pl = pm + (i64)gridDim.y * nsplit * Lp;
      pm[0] = m_a;
      pm[8] = m_b;
      pl[0] = l_a;
      pl[8] = l_b;
    }
  }
}

template <int KC, bool EXACT>
__global__ void __launch_bounds__(NT, 2)
attn_fwd_scores_wide_tf32(const float* __restrict__ qu, const float* __restrict__ k,
                          const float* __restrict__ bias, float* __restrict__ scores,
                          float* __restrict__ lse, float* __restrict__ part, int L, int Dp,
                          float scale) {
  wide_scores<KC, EXACT, 0>(qu, k, bias, scores, lse, part, L, Dp, scale);
}

// The same pass at a head dim D no multiple of its chunks, unpadded: D in place of
// Dp (the rows' stride; ceil(D / chunk) chunks), the columns past D read as
// zeros and not stored, the rows read in pieces of AL bytes
template <int KC, bool EXACT, int AL>
__global__ void __launch_bounds__(NT, 2)
attn_fwd_scores_wide_tf32_cols(const float* __restrict__ qu, const float* __restrict__ k,
                               const float* __restrict__ bias, float* __restrict__ scores,
                               float* __restrict__ lse, float* __restrict__ part, int L, int Dp,
                               float scale) {
  wide_scores<KC, EXACT, AL>(qu, k, bias, scores, lse, part, L, Dp, scale);
}

// lse (log2 units) of rows r and r + 8 from the S partials of part (2, B*H,
// S, Lp) at row_off = bh * S * Lp + r: m + log2(sum_z l_z 2^(m_z - m)), m =
// max_z m_z, folded split by split. Split 0 always holds a key tile, so the
// running max is finite from it on and a split with no key, (-inf, 0), adds
// 0. The loop is unrolled so that the loads of several splits are in flight
// together (a block merges while its first tile is on the way). Merged here,
// in the p v pass's prologue, the forward ran 0-9% faster than with a merge
// kernel of its own ahead of the pass, on an H100 80GB HBM3 at 700 W (PERF.md
// §5).
__device__ __forceinline__ void merge_lse2(const float* part, i64 plane, i64 row_off, int nsplit,
                                           int Lp, float& l2a, float& l2b) {
  float ma = -INFINITY, mb = -INFINITY, sa = 0.f, sb = 0.f;
#pragma unroll 4
  for (int z = 0; z < nsplit; ++z) {
    const float* p = part + row_off + (i64)z * Lp;
    const float mza = p[0], mzb = p[8], lza = p[plane], lzb = p[plane + 8];
    const float na = fmaxf(ma, mza), nb = fmaxf(mb, mzb);
    sa = sa * fast_exp2(ma - na) + lza * fast_exp2(mza - na);
    sb = sb * fast_exp2(mb - nb) + lzb * fast_exp2(mzb - nb);
    ma = na;
    mb = nb;
  }
  l2a = ma + log2f(sa);
  l2b = mb + log2f(sb);
}

// ---------------------------------------------------------------------------
// wide forward, pass 2: grid (ceil(L/64) * Dp/DC, B*H); blockIdx.x is query
// tile * (Dp / DC) + the block's DC output columns, so the blocks of one query
// tile run side by side and share its score tiles in L2. With S > 1 key
// splits in pass 1, each block first merges its rows' partials into lse (the
// block of columns 0 writes it, for the backward). Walks the key tiles:
// p = exp2(s - lse) (the scratch's scores, exact softmax), dropped or scaled
// by 1/(1-rate), into out += p v.
// smem: 2 x (score tile, v chunk)
// ---------------------------------------------------------------------------
template <int DC>
struct WidePvSmem {
  static constexpr int SC = 64 * SBF * 4;
  static constexpr int VT = 64 * (DC + 4) * 4;
  static constexpr int STAGE = SC + VT;
  static constexpr int BYTES = 2 * STAGE;
  static_assert(SC % 128 == 0 && STAGE % 128 == 0, "tiles start 128-byte aligned");
};

template <int DC, bool EXACT, bool PSUM, int AL>
__device__ __forceinline__ void wide_pv(const float* scores, float* lse, const float* part,
                                        int nsplit, const float* v, float* out, int H, int L,
                                        int Dp, Dropout drop, Strides os) {
  constexpr bool CT = AL != 0;  // the column tail, rows in pieces of AL bytes
  typedef WidePvSmem<DC> S;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int nch = (CT ? Dp + DC - 1 : Dp) / DC, bh = blockIdx.y;
  const int i0 = blockIdx.x / nch * 64, c0 = blockIdx.x % nch * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int ntiles = (L + BK - 1) / BK, Lp = ntiles * BK, qrows = L - i0;
  const float* sp = scores + ((i64)bh * Lp + i0) * Lp;
  const float* vp = v + (i64)bh * L * Dp + c0;

  auto load = [&](int tt) {
    const uint32_t st = sb + (tt & 1) * S::STAGE;
    const int j = tt * BK;
    load_scores<64, SBF, true>(st, sp + j, Lp, 64, 64);
    if constexpr (CT)
      load_rows_cols<64, DC, !EXACT, AL>(st + S::SC, vp + (i64)j * Dp, Dp, L - j, Dp - c0);
    else
      load_rows<64, DC, !EXACT>(st + S::SC, vp + (i64)j * Dp, Dp, L - j);
  };
  load(0);
  cp_async_commit();

  float* lr = lse + (i64)bh * L + i0 + r0 + g;
  const bool in_a = EXACT || r0 + g < qrows, in_b = EXACT || r0 + g + 8 < qrows;
  float l2a, l2b;
  if (nsplit == 1) {
    l2a = in_a ? lr[0] * LOG2E : 0.f;
    l2b = in_b ? lr[8] * LOG2E : 0.f;
  } else {
    merge_lse2(part, (i64)gridDim.y * nsplit * Lp, (i64)bh * nsplit * Lp + i0 + r0 + g, nsplit,
               Lp, l2a, l2b);
    if (c0 == 0 && t == 0) {
      if (in_a) lr[0] = l2a / LOG2E;
      if (in_b) lr[8] = l2b / LOG2E;
    }
  }
  const uint32_t row_a = (drop_bh(drop, bh) * L + i0 + r0 + g) * L, row_b = row_a + 8u * L;
  float o[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait_all();
    __syncthreads();
    if (tt + 1 < ntiles) {
      load(tt + 1);
      cp_async_commit();
    }
    const int stage = (tt & 1) * S::STAGE;
    const float* sc = reinterpret_cast<const float*>(smem + stage);
    const uint32_t j0 = (uint32_t)(tt * BK);
    float p[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 a = *reinterpret_cast<const float2*>(sc + (r0 + g) * SBF + 8 * n + 2 * t);
      const float2 b = *reinterpret_cast<const float2*>(sc + (r0 + g + 8) * SBF + 8 * n + 2 * t);
      p[n][0] = a.x;
      p[n][1] = a.y;
      p[n][2] = b.x;
      p[n][3] = b.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = fast_exp2(p[n][e] - (e < 2 ? l2a : l2b));
        float pd = pe * drop.inv_keep;
        if (drop.active && !keep(drop, (e < 2 ? row_a : row_b) + j0 + 8 * n + 2 * t + (e & 1)))
          pd = 0.f;
        p[n][e] = pd;
      }
    }
    mma_acc_rows<DC, 8, PSUM>(o, p, reinterpret_cast<const float*>(smem + stage + S::SC));
  }
  float* op = out + (bh / H) * os.b + (bh % H) * os.h + (i64)(i0 + r0) * os.l + c0;
  if constexpr (CT)
    store_acc_cols<DC, !EXACT, AL>(o, op, os.l, qrows - r0, Dp - c0);
  else
    store_acc<DC, !EXACT>(o, op, os.l, qrows - r0);
}

template <int DC, bool EXACT, bool PSUM>
__global__ void __launch_bounds__(NT, 2)
attn_fwd_pv_wide_tf32(const float* __restrict__ scores, float* __restrict__ lse,
                      const float* __restrict__ part, int nsplit, const float* __restrict__ v,
                      float* __restrict__ out, int H, int L, int Dp, Dropout drop, Strides os) {
  wide_pv<DC, EXACT, PSUM, 0>(scores, lse, part, nsplit, v, out, H, L, Dp, drop, os);
}

// The same pass at a head dim D no multiple of its chunks, unpadded: D in place of
// Dp (the rows' stride; ceil(D / chunk) chunks), the columns past D read as
// zeros and not stored, the rows read in pieces of AL bytes
template <int DC, bool EXACT, bool PSUM, int AL>
__global__ void __launch_bounds__(NT, 2)
attn_fwd_pv_wide_tf32_cols(const float* __restrict__ scores, float* __restrict__ lse,
                           const float* __restrict__ part, int nsplit, const float* __restrict__ v,
                           float* __restrict__ out, int H, int L, int Dp, Dropout drop,
                           Strides os) {
  wide_pv<DC, EXACT, PSUM, AL>(scores, lse, part, nsplit, v, out, H, L, Dp, drop, os);
}

// ---------------------------------------------------------------------------
// wide backward, delta = rowsum(g * out): 16 lanes a row, W = 64 columns a
// step of the loop over Dp
// ---------------------------------------------------------------------------
template <int W, bool EXACT, int AL>
__device__ __forceinline__ void wide_delta(const float* g, const float* out, float* delta, int H,
                                           int L, int rows, int Dp, Strides gs, Strides os) {
  constexpr bool CT = AL != 0;  // the column tail, rows in pieces of AL bytes
  constexpr int LPR = W / 4;
  const int row = blockIdx.x * (256 / LPR) + threadIdx.x / LPR, c = threadIdx.x % LPR;
  const bool live = EXACT || row < rows;
  const int rr = live ? row : 0;
  const int bh = rr / L, i = rr % L;
  const i64 b = bh / H, h = bh % H;
  const float* gr = g + b * gs.b + h * gs.h + i * gs.l + 4 * c;
  const float* orow = out + b * os.b + h * os.h + i * os.l + 4 * c;
  float sum = 0.f;
  for (int d = 0; d < Dp; d += W) {
    if constexpr (CT) {  // value by value at the tail, or where rows are not 16-byte aligned
      if (AL != 16 || d + 4 * c + 4 > Dp) {
        for (int e = 0; e < 4 && d + 4 * c + e < Dp; ++e) sum = fmaf(gr[d + e], orow[d + e], sum);
        continue;
      }
    }
    const float4 gv = *reinterpret_cast<const float4*>(gr + d);
    const float4 ov = *reinterpret_cast<const float4*>(orow + d);
    sum = fmaf(gv.x, ov.x, sum);
    sum = fmaf(gv.y, ov.y, sum);
    sum = fmaf(gv.z, ov.z, sum);
    sum = fmaf(gv.w, ov.w, sum);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (c == 0 && live) delta[row] = sum;
}

template <int W, bool EXACT>
__global__ void __launch_bounds__(256)
attn_delta_wide_f32(const float* __restrict__ g, const float* __restrict__ out,
                    float* __restrict__ delta, int H, int L, int rows, int Dp, Strides gs,
                    Strides os) {
  wide_delta<W, EXACT, 0>(g, out, delta, H, L, rows, Dp, gs, os);
}

// The same pass at a head dim D no multiple of its chunks, unpadded: D in place of
// Dp (the rows' stride; ceil(D / chunk) chunks), the columns past D read as
// zeros and not stored, the rows read in pieces of AL bytes
template <int W, bool EXACT, int AL>
__global__ void __launch_bounds__(256)
attn_delta_wide_f32_cols(const float* __restrict__ g, const float* __restrict__ out,
                         float* __restrict__ delta, int H, int L, int rows, int Dp, Strides gs,
                         Strides os) {
  wide_delta<W, EXACT, AL>(g, out, delta, H, L, rows, Dp, gs, os);
}

// ---------------------------------------------------------------------------
// wide backward, scores: grid (ceil(L/64) key tiles, ceil(L/64) query tiles,
// B*H). A block holds no D-sized accumulator: it streams the chunks of qu, k,
// g and v for its (64 queries, 64 keys) and sums s = qu k^T and dp = g v^T,
// then writes dbias = p (dropout'(dp) - delta) * scale and the dropped,
// rescaled probabilities pd = dropout(p) (B, H, L, L), which the product
// passes turn into dv = pd^T g, dk = dbias^T qu and dqu = dbias k.
// smem: 2 x (qu, k, g, v chunks), bias tile, lse and delta
// ---------------------------------------------------------------------------
template <int KC>
struct WideDsSmem {
  static constexpr int CH = 64 * (KC + 4) * 4;
  static constexpr int STAGE = 4 * CH;
  static constexpr int BIAS = 64 * SBF * 4;
  static constexpr int B = 2 * STAGE;
  static constexpr int STAT = B + BIAS;  // lse, then delta, 64 rows each
  static constexpr int BYTES = STAT + 2 * 64 * 4;
  static_assert(CH % 128 == 0 && STAT % 128 == 0, "tiles start 128-byte aligned");
};

template <int KC, bool EXACT, int AL>
__device__ __forceinline__ void wide_ds(const float* qu, const float* k, const float* v,
                                        const float* bias, const float* gr, const float* lse,
                                        const float* delta, float* dbias, float* pd, int H, int L,
                                        int Dp, float scale, Dropout drop, Strides gs) {
  constexpr bool CT = AL != 0;  // the column tail, rows in pieces of AL bytes
  typedef WideDsSmem<KC> S;
  constexpr int P = KC + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int j0 = blockIdx.x * BK, i0 = blockIdx.y * 64, bh = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // the warp's queries within the tile
  const int nkc = (CT ? Dp + KC - 1 : Dp) / KC, qrows = L - i0, kcols = min(L - j0, BK);
  const float* qp = qu + ((i64)bh * L + i0) * Dp;
  const float* kp = k + ((i64)bh * L + j0) * Dp;
  const float* vp = v + ((i64)bh * L + j0) * Dp;
  const float* gp = gr + (bh / H) * gs.b + (bh % H) * gs.h + (i64)i0 * gs.l;
  const i64 tile0 = ((i64)bh * L + i0) * L + j0;  // element (i0, j0) of the (L, L) matrices

  auto load_chunk = [&](int c) {
    const uint32_t st = sb + (c & 1) * S::STAGE;
    if constexpr (CT) {
      const int nc = Dp - c * KC;
      load_rows_cols<64, KC, !EXACT, AL>(st, qp + c * KC, Dp, qrows, nc);
      load_rows_cols<64, KC, !EXACT, AL>(st + S::CH, kp + c * KC, Dp, kcols, nc);
      load_rows_cols<64, KC, !EXACT, AL>(st + 2 * S::CH, gp + c * KC, gs.l, qrows, nc);
      load_rows_cols<64, KC, !EXACT, AL>(st + 3 * S::CH, vp + c * KC, Dp, kcols, nc);
    } else {
      load_rows<64, KC, !EXACT>(st, qp + c * KC, Dp, qrows);
      load_rows<64, KC, !EXACT>(st + S::CH, kp + c * KC, Dp, kcols);
      load_rows<64, KC, !EXACT>(st + 2 * S::CH, gp + c * KC, gs.l, qrows);
      load_rows<64, KC, !EXACT>(st + 3 * S::CH, vp + c * KC, Dp, kcols);
    }
  };
  load_chunk(0);
  load_scores<64, SBF, EXACT>(sb + S::B, bias + tile0, L, qrows, kcols);
  const float* lp = lse + (i64)bh * L + i0;
  const float* dlp = delta + (i64)bh * L + i0;
  if constexpr (EXACT) {
    if (threadIdx.x < 32) {
      const int c = threadIdx.x;
      cp_async16(sb + S::STAT + 16 * c, c < 16 ? lp + 4 * c : dlp + 4 * (c - 16));
    }
  } else {
    const int c = threadIdx.x & 63;
    const float* row = threadIdx.x < 64 ? lp : dlp;
    const bool ok = c < qrows;
    cp_async4_zfill(sb + S::STAT + 4 * threadIdx.x, ok ? row + c : row, ok ? 4 : 0);
  }
  cp_async_commit();

  float s[8][4], dp[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
  }
  for (int c = 0; c < nkc; ++c) {
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < nkc) {
      load_chunk(c + 1);
      cp_async_commit();
    }
    const uint32_t st = sb + (c & 1) * S::STAGE;
    // the instance for any L holds more addresses: with the chunk's k-steps
    // unrolled whole its two products' fragments spill
    constexpr int U = EXACT ? KC / 8 : 1;
    mma_rows_rows<KC, 8, U>(s, st + lane_a<P>(r0, lane), st + S::CH + lane_b<P>(lane));
    mma_rows_rows<KC, 8, U>(dp, st + 2 * S::CH + lane_a<P>(r0, lane),
                            st + 3 * S::CH + lane_b<P>(lane));
  }

  // p, pd and ds of the warp's 16 queries x 64 keys, straight to dbias and pd
  const float* bt = reinterpret_cast<const float*>(smem + S::B);
  const float* stat = reinterpret_cast<const float*>(smem + S::STAT);
  const float sl2 = scale * LOG2E;
  const uint32_t dbh = drop_bh(drop, bh);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const float l2 = stat[r] * LOG2E, dl = stat[64 + r];
    const uint32_t flat = (dbh * L + i0 + r) * L + j0;
    float* dbr = dbias + tile0 + (i64)r * L;
    float* pdr = pd + tile0 + (i64)r * L;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(bt + r * SBF + col);
      float dsv[2], pdv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 2 * half + e;
        const float p = fast_exp2((s[n][x] + (e ? b.y : b.x)) * sl2 - l2);
        const bool kept = !drop.active || keep(drop, flat + col + e);
        const float dpm = kept ? dp[n][x] * drop.inv_keep : 0.f;
        dsv[e] = p * (dpm - dl) * scale;
        pdv[e] = kept ? p * drop.inv_keep : 0.f;
      }
      if constexpr (EXACT) {
        *reinterpret_cast<float2*>(dbr + col) = make_float2(dsv[0], dsv[1]);
        *reinterpret_cast<float2*>(pdr + col) = make_float2(pdv[0], pdv[1]);
      } else if (r < qrows) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e < kcols) {
            dbr[col + e] = dsv[e];
            pdr[col + e] = pdv[e];
          }
        }
      }
    }
  }
}

template <int KC, bool EXACT>
__global__ void __launch_bounds__(NT, 2)
attn_bwd_ds_wide_tf32(const float* __restrict__ qu, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ gr, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dbias,
                      float* __restrict__ pd, int H, int L, int Dp, float scale, Dropout drop,
                      Strides gs) {
  wide_ds<KC, EXACT, 0>(qu, k, v, bias, gr, lse, delta, dbias, pd, H, L, Dp, scale, drop, gs);
}

// The same pass at a head dim D no multiple of its chunks, unpadded: D in place of
// Dp (the rows' stride; ceil(D / chunk) chunks), the columns past D read as
// zeros and not stored, the rows read in pieces of AL bytes
template <int KC, bool EXACT, int AL>
__global__ void __launch_bounds__(NT, 2)
attn_bwd_ds_wide_tf32_cols(const float* __restrict__ qu, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ gr, const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dbias,
                           float* __restrict__ pd, int H, int L, int Dp, float scale, Dropout drop,
                           Strides gs) {
  wide_ds<KC, EXACT, AL>(qu, k, v, bias, gr, lse, delta, dbias, pd, H, L, Dp, scale, drop, gs);
}

// ---------------------------------------------------------------------------
// wide backward, products: out (B, H, L, Dp) = A x, or with TRANS A^T x, for
// A (B, H, L, L) (dbias or pd) and x (B, H, L, Dp) of strides xs: dqu = dbias
// k, dk = dbias^T qu, dv = pd^T g. Grid (ceil(L/64) * Dp/DC, B*H) as pass 2 of
// the forward; the block walks the other side of A in tiles of 64 and reads
// its A fragments along A's rows (A x, as attn_dqu_tf32 does) or down its
// columns (A^T x).
// smem: 2 x (A tile 64 x 64 at pitch SBF, x chunk 64 x DC)
// ---------------------------------------------------------------------------
template <int DC>
struct WideProdSmem {
  static constexpr int A = 64 * SBF * 4;
  static constexpr int XT = 64 * (DC + 4) * 4;
  static constexpr int STAGE = A + XT;
  static constexpr int BYTES = 2 * STAGE;
  static_assert(A % 128 == 0 && STAGE % 128 == 0, "tiles start 128-byte aligned");
};

template <int DC, bool EXACT, bool TRANS, bool PSUM, int AL>
__device__ __forceinline__ void wide_prod(const float* a, const float* x, float* out, int H, int L,
                                          int Dp, Strides xs) {
  constexpr bool CT = AL != 0;  // the column tail, rows in pieces of AL bytes
  typedef WideProdSmem<DC> S;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int nch = (CT ? Dp + DC - 1 : Dp) / DC, bh = blockIdx.y;
  const int o0 = blockIdx.x / nch * 64, c0 = blockIdx.x % nch * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int ntiles = (L + BK - 1) / BK, orows = L - o0;
  const float* am = a + (i64)bh * L * L;
  const float* xp = x + (bh / H) * xs.b + (bh % H) * xs.h + c0;

  auto load = [&](int tt) {
    const uint32_t st = sb + (tt & 1) * S::STAGE;
    const int j1 = tt * BK;
    if constexpr (TRANS)
      load_scores<64, SBF, EXACT>(st, am + (i64)j1 * L + o0, L, L - j1, min(orows, BK));
    else
      load_scores<64, SBF, EXACT>(st, am + (i64)o0 * L + j1, L, orows, min(L - j1, BK));
    if constexpr (CT)
      load_rows_cols<64, DC, !EXACT, AL>(st + S::A, xp + (i64)j1 * xs.l, xs.l, L - j1, Dp - c0);
    else
      load_rows<64, DC, !EXACT>(st + S::A, xp + (i64)j1 * xs.l, xs.l, L - j1);
  };
  load(0);
  cp_async_commit();

  float acc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait_all();
    __syncthreads();
    if (tt + 1 < ntiles) {
      load(tt + 1);
      cp_async_commit();
    }
    const int stage = (tt & 1) * S::STAGE;
    const float* at = reinterpret_cast<const float*>(smem + stage);
    float af[8][4];
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      if constexpr (TRANS) {
        const float* col = at + (8 * kc + 2 * t) * SBF + r0 + g;
        af[kc][0] = col[0];
        af[kc][1] = col[SBF];
        af[kc][2] = col[8];
        af[kc][3] = col[SBF + 8];
      } else {
        const float2 u = *reinterpret_cast<const float2*>(at + (r0 + g) * SBF + 8 * kc + 2 * t);
        const float2 w =
            *reinterpret_cast<const float2*>(at + (r0 + g + 8) * SBF + 8 * kc + 2 * t);
        af[kc][0] = u.x;
        af[kc][1] = u.y;
        af[kc][2] = w.x;
        af[kc][3] = w.y;
      }
    }
    mma_acc_rows<DC, 8, PSUM>(acc, af, reinterpret_cast<const float*>(smem + stage + S::A));
  }
  float* op = out + ((i64)bh * L + o0 + r0) * Dp + c0;
  if constexpr (CT)
    store_acc_cols<DC, !EXACT, AL>(acc, op, Dp, orows - r0, Dp - c0);
  else
    store_acc<DC, !EXACT>(acc, op, Dp, orows - r0);
}

template <int DC, bool EXACT, bool TRANS, bool PSUM>
__global__ void __launch_bounds__(NT, 2)
attn_prod_wide_tf32(const float* __restrict__ a, const float* __restrict__ x,
                    float* __restrict__ out, int H, int L, int Dp, Strides xs) {
  wide_prod<DC, EXACT, TRANS, PSUM, 0>(a, x, out, H, L, Dp, xs);
}

// The same pass at a head dim D no multiple of its chunks, unpadded: D in place of
// Dp (the rows' stride; ceil(D / chunk) chunks), the columns past D read as
// zeros and not stored, the rows read in pieces of AL bytes
template <int DC, bool EXACT, bool TRANS, bool PSUM, int AL>
__global__ void __launch_bounds__(NT, 2)
attn_prod_wide_tf32_cols(const float* __restrict__ a, const float* __restrict__ x,
                         float* __restrict__ out, int H, int L, int Dp, Strides xs) {
  wide_prod<DC, EXACT, TRANS, PSUM, AL>(a, x, out, H, L, Dp, xs);
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int D, bool EXACT, bool PSUM>
cudaError_t fwd(const float* qu, const float* k, const float* v, const float* bias, float* out,
                float* lse, int BH, int H, int L, float scale, Dropout drop, Strides os,
                cudaStream_t stream) {
  cudaError_t err = set_smem(attn_fwd_tf32<D, EXACT, PSUM>, FwdSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  attn_fwd_tf32<D, EXACT, PSUM><<<dim3(ceil_div(L, 64), BH), NT, FwdSmem<D>::BYTES,
                                  stream>>>(qu, k, v, bias, out, lse, H, L, scale, drop, os);
  return cudaGetLastError();
}

template <int D, bool EXACT, bool PSUM>
cudaError_t bwd(const float* qu, const float* k, const float* v, const float* bias,
                const float* g, const float* out, const float* lse, float* delta, float* dqu,
                float* dk, float* dv, float* dbias, int BH, int H, int L, float scale,
                Dropout drop, Strides gs, Strides os, cudaStream_t stream) {
  cudaError_t err = set_smem(attn_bwd_tf32<D, EXACT, PSUM>, BwdSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  err = set_smem(attn_dqu_tf32<D, EXACT, PSUM>, DquSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(L, 64), BH);
  attn_delta_f32<D, EXACT><<<ceil_div(BH * L, 256 / delta_lanes<D>()), 256, 0, stream>>>(
      g, out, delta, H, L, BH * L, gs, os);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_tf32<D, EXACT, PSUM><<<grid, NT, BwdSmem<D>::BYTES, stream>>>(
      qu, k, v, bias, g, lse, delta, dk, dv, dbias, H, L, scale, drop, gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dqu_tf32<D, EXACT, PSUM><<<grid, NT, DquSmem<D>::BYTES, stream>>>(dbias, k, dqu, L);
  return cudaGetLastError();
}

// the wide forward; with AL > 0 (the column tail) Dp is the head dim D
// itself, any D, its rows read in pieces of AL bytes
template <int DC, bool EXACT, bool PSUM, int AL>
cudaError_t fwd_wide(const float* qu, const float* k, const float* v, const float* bias,
                     float* out, float* lse, float* scores, float* part, int nsplit, int BH, int H,
                     int L, int Dp, float scale, Dropout drop, Strides os, cudaStream_t stream) {
  const int nt = ceil_div(L, 64), nch = ceil_div(Dp, DC);
  const dim3 grid_scores(nt, BH, nsplit), grid_pv(nt * nch, BH);
  constexpr int SS = WideScoresSmem<WKC>::BYTES, PS = WidePvSmem<DC>::BYTES;
  cudaError_t err;
  if constexpr (AL != 0) {
    if ((err = set_smem(attn_fwd_scores_wide_tf32_cols<WKC, EXACT, AL>, SS)) != cudaSuccess ||
        (err = set_smem(attn_fwd_pv_wide_tf32_cols<DC, EXACT, PSUM, AL>, PS)) != cudaSuccess)
      return err;
    attn_fwd_scores_wide_tf32_cols<WKC, EXACT, AL><<<grid_scores, NT, SS, stream>>>(
        qu, k, bias, scores, lse, part, L, Dp, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attn_fwd_pv_wide_tf32_cols<DC, EXACT, PSUM, AL><<<grid_pv, NT, PS, stream>>>(
        scores, lse, part, nsplit, v, out, H, L, Dp, drop, os);
  } else {
    if ((err = set_smem(attn_fwd_scores_wide_tf32<WKC, EXACT>, SS)) != cudaSuccess ||
        (err = set_smem(attn_fwd_pv_wide_tf32<DC, EXACT, PSUM>, PS)) != cudaSuccess)
      return err;
    attn_fwd_scores_wide_tf32<WKC, EXACT><<<grid_scores, NT, SS, stream>>>(
        qu, k, bias, scores, lse, part, L, Dp, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attn_fwd_pv_wide_tf32<DC, EXACT, PSUM><<<grid_pv, NT, PS, stream>>>(
        scores, lse, part, nsplit, v, out, H, L, Dp, drop, os);
  }
  return cudaGetLastError();
}

// blocks of the wide scores pass an SM holds (the occupancy calculator's)
template <bool EXACT>
cudaError_t wide_scores_blocks(int* n) {
  cudaError_t err = set_smem(attn_fwd_scores_wide_tf32<WKC, EXACT>, WideScoresSmem<WKC>::BYTES);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, attn_fwd_scores_wide_tf32<WKC, EXACT>,
                                                       NT, WideScoresSmem<WKC>::BYTES);
}

template <int DC, bool EXACT, bool TRANS, bool PSUM, int AL>
cudaError_t prod_wide(const float* a, const float* x, Strides xs, float* out, int BH, int H,
                      int L, int Dp, cudaStream_t stream) {
  typedef WideProdSmem<DC> S;
  const dim3 grid(ceil_div(L, 64) * ceil_div(Dp, DC), BH);
  cudaError_t err;
  if constexpr (AL != 0) {
    if ((err = set_smem(attn_prod_wide_tf32_cols<DC, EXACT, TRANS, PSUM, AL>, S::BYTES)) !=
        cudaSuccess)
      return err;
    attn_prod_wide_tf32_cols<DC, EXACT, TRANS, PSUM, AL><<<grid, NT, S::BYTES, stream>>>(
        a, x, out, H, L, Dp, xs);
  } else {
    if ((err = set_smem(attn_prod_wide_tf32<DC, EXACT, TRANS, PSUM>, S::BYTES)) != cudaSuccess)
      return err;
    attn_prod_wide_tf32<DC, EXACT, TRANS, PSUM><<<grid, NT, S::BYTES, stream>>>(a, x, out, H, L,
                                                                                Dp, xs);
  }
  return cudaGetLastError();
}

// the wide backward; with AL as fwd_wide
template <int DC, bool EXACT, bool PSUM, int AL>
cudaError_t bwd_wide(const float* qu, const float* k, const float* v, const float* bias,
                     const float* g, const float* out, const float* lse, float* delta, float* dqu,
                     float* dk, float* dv, float* dbias, float* pd, int BH, int H, int L, int Dp,
                     float scale, Dropout drop, Strides gs, Strides os, cudaStream_t stream) {
  const int nt = ceil_div(L, 64);
  const dim3 grid_delta(ceil_div(BH * L, 16)), grid_ds(nt, nt, BH);
  constexpr int DS = WideDsSmem<WKC>::BYTES;
  cudaError_t err;
  if constexpr (AL != 0) {
    if ((err = set_smem(attn_bwd_ds_wide_tf32_cols<WKC, EXACT, AL>, DS)) != cudaSuccess) return err;
    attn_delta_wide_f32_cols<64, EXACT, AL><<<grid_delta, 256, 0, stream>>>(g, out, delta, H, L,
                                                                        BH * L, Dp, gs, os);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attn_bwd_ds_wide_tf32_cols<WKC, EXACT, AL><<<grid_ds, NT, DS, stream>>>(
        qu, k, v, bias, g, lse, delta, dbias, pd, H, L, Dp, scale, drop, gs);
  } else {
    if ((err = set_smem(attn_bwd_ds_wide_tf32<WKC, EXACT>, DS)) != cudaSuccess) return err;
    attn_delta_wide_f32<64, EXACT><<<grid_delta, 256, 0, stream>>>(g, out, delta, H, L, BH * L,
                                                                   Dp, gs, os);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attn_bwd_ds_wide_tf32<WKC, EXACT><<<grid_ds, NT, DS, stream>>>(
        qu, k, v, bias, g, lse, delta, dbias, pd, H, L, Dp, scale, drop, gs);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  Strides cs;  // qu and k: contiguous (B, H, L, Dp)
  cs.b = (i64)H * L * Dp;
  cs.h = (i64)L * Dp;
  cs.l = Dp;
  err = prod_wide<DC, EXACT, true, PSUM, AL>(pd, g, gs, dv, BH, H, L, Dp, stream);
  if (err != cudaSuccess) return err;
  err = prod_wide<DC, EXACT, true, PSUM, AL>(dbias, qu, cs, dk, BH, H, L, Dp, stream);
  if (err != cudaSuccess) return err;
  return prod_wide<DC, EXACT, false, PSUM, AL>(dbias, k, cs, dqu, BH, H, L, Dp, stream);
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

// The bytes (16, 8 or 4) to which every base address and byte stride of a
// wide launch at an unpadded head dim is aligned: its column tail copies its
// rows in pieces of that many
int row_align(std::initializer_list<long long> bytes) {
  int al = 16;
  for (const long long b : bytes)
    while (al > 1 && b % al) al >>= 1;
  return al;
}

long long addr(const void* p) { return (long long)reinterpret_cast<uintptr_t>(p); }

// The instance a launch takes: EXACT where every tile is whole and the bias
// rows are 16-byte aligned, the general one elsewhere.
bool exact_tiles(int L, const void* bias) { return L % 64 == 0 && aligned16(bias); }

// The instance of a launch: EXACT as exact_tiles says, PSUM this library's.
// F is a host template's call with its template arguments left to the macro.
#define BY_INSTANCE(F, exact) ((exact) ? F(true, LIB_PSUM) : F(false, LIB_PSUM))

// qu, k, v (and dqu, dk, dv, which the wrapper allocates) are read in
// 16-byte chunks of their rows: their bases must be 16-byte aligned. So must
// dbias and pd in the EXACT instance; the other stores them value by value
// or as windows, at any alignment (the wrapper's launches over a run of
// (b, h) pairs start them at any (b, h))
bool valid(int L, int H, int h_total, int h_offset, const void* qu, const void* k,
           const void* v) {
  return L >= 1 && h_offset >= 0 && h_offset + H <= h_total && aligned16(qu) && aligned16(k) &&
         aligned16(v);
}

}  // namespace

extern "C" {

// float32 only; head_dim in {16, 32, 64, 128} (256 and past it run the wide
// instance); any L >= 1. out_strides: element
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
#define ATTN_FWD(D, E, P)                                                                   \
  fwd<D, E, P>((const float*)qu, (const float*)k, (const float*)v, (const float*)bias,       \
               (float*)out, (float*)lse, B * H, H, L, scale, drop, os, (cudaStream_t)stream)
#define F16(E, P) ATTN_FWD(16, E, P)
#define F32(E, P) ATTN_FWD(32, E, P)
#define F64(E, P) ATTN_FWD(64, E, P)
#define F128(E, P) ATTN_FWD(128, E, P)
  switch (head_dim) {
    case 16:
      return (int)BY_INSTANCE(F16, exact);
    case 32:
      return (int)BY_INSTANCE(F32, exact);
    case 64:
      return (int)BY_INSTANCE(F64, exact);
    case 128:
      return (int)BY_INSTANCE(F128, exact);
  }
#undef F16
#undef F32
#undef F64
#undef F128
#undef ATTN_FWD
  return (int)cudaErrorInvalidValue;
}

// head_dim as in attn_tf32_fwd. g_strides, out_strides: element strides of
// g and out over (b, h, l). lse: the forward's; delta: (B, H, L) float32
// scratch, written then read. h_total, h_offset as in attn_tf32_fwd.
int attn_tf32_bwd(const void* qu, const void* k, const void* v, const void* bias, const void* g,
                  const void* out, const void* lse, void* delta, void* dqu, void* dk, void* dv,
                  void* dbias, const long long* g_strides, const long long* out_strides, int B,
                  int H, int L, int head_dim, float scale, float rate, unsigned int seed,
                  unsigned int thresh, float inv_keep, int h_total, int h_offset, void* stream) {
  const bool exact = exact_tiles(L, bias);
  if (!valid(L, H, h_total, h_offset, qu, k, v) || (exact && !aligned16(dbias)))
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
  const Strides gs = make_strides(g_strides), os = make_strides(out_strides);
#define ATTN_BWD(D, E, P)                                                                   \
  bwd<D, E, P>((const float*)qu, (const float*)k, (const float*)v, (const float*)bias,       \
               (const float*)g, (const float*)out, (const float*)lse, (float*)delta,         \
               (float*)dqu, (float*)dk, (float*)dv, (float*)dbias, B * H, H, L, scale, drop, \
               gs, os, (cudaStream_t)stream)
#define B16(E, P) ATTN_BWD(16, E, P)
#define B32(E, P) ATTN_BWD(32, E, P)
#define B64(E, P) ATTN_BWD(64, E, P)
#define B128(E, P) ATTN_BWD(128, E, P)
  switch (head_dim) {
    case 16:
      return (int)BY_INSTANCE(B16, exact);
    case 32:
      return (int)BY_INSTANCE(B32, exact);
    case 64:
      return (int)BY_INSTANCE(B64, exact);
    case 128:
      return (int)BY_INSTANCE(B128, exact);
  }
#undef B16
#undef B32
#undef B64
#undef B128
#undef ATTN_BWD
  return (int)cudaErrorInvalidValue;
}

// The wide instance, as attn_tf32_fwd, at any head dim: a multiple of WDC as
// it is, any other unpadded with its column tail. scores: (B, H, Lp, Lp)
// float32 scratch, Lp = 64 ceil(L / 64), written then read. splits: the
// scores pass's key splits S, 1 .. ceil(L / 64); part: (2, B*H, S, Lp)
// float32 scratch (unused at S = 1).
int attn_tf32_fwd_wide(const void* qu, const void* k, const void* v, const void* bias, void* out,
                       void* lse, void* scores, void* part, const long long* out_strides, int B,
                       int H, int L, int head_dim, int splits, float scale, float rate,
                       unsigned int seed, unsigned int thresh, float inv_keep, int h_total,
                       int h_offset, void* stream) {
  const bool ct = head_dim % WDC != 0;
  const Strides os = make_strides(out_strides);
  const int al = ct ? row_align({addr(qu), addr(k), addr(v), addr(out), 4LL * head_dim,
                                 4 * os.b, 4 * os.h, 4 * os.l})
                    : 0;  // 0: no column tail
  const bool ok = ct ? L >= 1 && h_offset >= 0 && h_offset + H <= h_total && al >= 4
                     : valid(L, H, h_total, h_offset, qu, k, v);
  if (!ok || head_dim < 1 || !aligned16(scores) || splits < 1 || splits > ceil_div(L, 64) ||
      (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
#define ATTN_FWD_WIDE(DC, E, P, C)                                                              \
  fwd_wide<DC, E, P, C>((const float*)qu, (const float*)k, (const float*)v, (const float*)bias, \
                        (float*)out, (float*)lse, (float*)scores, (float*)part, splits, B * H,  \
                        H, L, head_dim, scale, drop, os, (cudaStream_t)stream)
#define FW_AL(DC, E, P)                                                                  \
  (al == 16 ? ATTN_FWD_WIDE(DC, E, P, 16)                                                \
            : al == 8 ? ATTN_FWD_WIDE(DC, E, P, 8)                                       \
                      : al == 4 ? ATTN_FWD_WIDE(DC, E, P, 4) : ATTN_FWD_WIDE(DC, E, P, 0))
#define FW2(E, P) FW_AL(2 * WDC, E, P)
#define FW1(E, P) FW_AL(WDC, E, P)
  const bool exact = exact_tiles(L, bias);
  if constexpr (!LIB_PSUM) {
    if (ceil_div(head_dim, WDC) % 2 == 0) return (int)BY_INSTANCE(FW2, exact);
  }
  return (int)BY_INSTANCE(FW1, exact);
#undef FW2
#undef FW1
#undef FW_AL
#undef ATTN_FWD_WIDE
}

// The wide instance, as attn_tf32_bwd, at any head dim as attn_tf32_fwd_wide
// takes it. pd: (B, H, L, L) float32 scratch (the dropped probabilities),
// written then read; 16-byte aligned like dbias.
int attn_tf32_bwd_wide(const void* qu, const void* k, const void* v, const void* bias,
                       const void* g, const void* out, const void* lse, void* delta, void* dqu,
                       void* dk, void* dv, void* dbias, void* pd, const long long* g_strides,
                       const long long* out_strides, int B, int H, int L, int head_dim,
                       float scale, float rate, unsigned int seed, unsigned int thresh,
                       float inv_keep, int h_total, int h_offset, void* stream) {
  const bool exact = exact_tiles(L, bias);
  const bool ct = head_dim % WDC != 0;
  const Strides gs = make_strides(g_strides), os = make_strides(out_strides);
  const int al = ct ? row_align({addr(qu), addr(k), addr(v), addr(g), addr(out), addr(dqu),
                                 addr(dk), addr(dv), 4LL * head_dim, 4 * gs.b, 4 * gs.h,
                                 4 * gs.l, 4 * os.b, 4 * os.h, 4 * os.l})
                    : 0;  // 0: no column tail
  const bool ok = ct ? L >= 1 && h_offset >= 0 && h_offset + H <= h_total && al >= 4
                     : valid(L, H, h_total, h_offset, qu, k, v);
  if (!ok || (exact && !(aligned16(dbias) && aligned16(pd))) || head_dim < 1)
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
#define ATTN_BWD_WIDE(DC, E, P, C)                                                              \
  bwd_wide<DC, E, P, C>((const float*)qu, (const float*)k, (const float*)v, (const float*)bias, \
                        (const float*)g, (const float*)out, (const float*)lse, (float*)delta,   \
                        (float*)dqu, (float*)dk, (float*)dv, (float*)dbias, (float*)pd, B * H,  \
                        H, L, head_dim, scale, drop, gs, os, (cudaStream_t)stream)
#define BW_AL(DC, E, P)                                                                  \
  (al == 16 ? ATTN_BWD_WIDE(DC, E, P, 16)                                                \
            : al == 8 ? ATTN_BWD_WIDE(DC, E, P, 8)                                       \
                      : al == 4 ? ATTN_BWD_WIDE(DC, E, P, 4) : ATTN_BWD_WIDE(DC, E, P, 0))
#define BW2(E, P) BW_AL(2 * WDC, E, P)
#define BW1(E, P) BW_AL(WDC, E, P)
  if constexpr (!LIB_PSUM) {
    if (ceil_div(head_dim, WDC) % 2 == 0) return (int)BY_INSTANCE(BW2, exact);
  }
  return (int)BY_INSTANCE(BW1, exact);
#undef BW2
#undef BW1
#undef BW_AL
#undef ATTN_BWD_WIDE
}

// Dynamic shared memory per block: which = 0 forward, 1 backward main pass,
// 2 backward dqu pass (the same in both instances). The wide instance's
// kernels: which = 3 forward scores, 4 forward p v, 5 backward scores, 6
// backward products (at any head dim, or the column width of 4 / 6: the
// columns a block of those takes follow ceil(head_dim / WDC)).
int attn_tf32_smem_bytes(int head_dim, int which) {
  const bool one_chunk = ceil_div(head_dim, WDC) % 2 != 0;  // p v and product blocks of WDC
  switch (which) {
    case 3:
      return WideScoresSmem<WKC>::BYTES;
    case 4:
      return one_chunk ? WidePvSmem<WDC>::BYTES : WidePvSmem<2 * WDC>::BYTES;
    case 5:
      return WideDsSmem<WKC>::BYTES;
    case 6:
      return one_chunk ? WideProdSmem<WDC>::BYTES : WideProdSmem<2 * WDC>::BYTES;
  }
  switch (head_dim) {
    case 16:
      return which == 0 ? FwdSmem<16>::BYTES : which == 1 ? BwdSmem<16>::BYTES
                                                          : DquSmem<16>::BYTES;
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

// Blocks an SM holds of the wide forward's scores pass, in its instance for
// whole tiles (exact = 1) or for any L: the wrapper chooses the key splits
// from it. A CUDA error comes back negated.
int attn_tf32_fwd_wide_blocks(int exact) {
  int n = 0;
  const cudaError_t err = exact ? wide_scores_blocks<true>(&n) : wide_scores_blocks<false>(&n);
  return err == cudaSuccess ? n : -(int)err;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
