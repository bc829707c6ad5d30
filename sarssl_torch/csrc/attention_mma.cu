// Fused rel-pos attention on the H100's tensor cores, forward and backward,
// for bfloat16 at head dims 16, 32, 64 and 128 (the forward also at 256), and
// every multiple of WDC = 64 from 256 on (the wide instance), at any sequence
// length L >= 1. (float32 runs attention_f32_mma.cu; the wrapper runs every
// other head dim on the next of these instances, on zero-padded inputs: 129 ..
// 256 forward on the D = 256 instance, backward on the wide one at 256.)
//
// Replaces the Pallas TPU kernels of sarssl_tpu/kernels/attention.py:
//   forward  _call_fwd (_fwd_kernel, _attend) -> attn_fwd_mma
//                                                (wide: attn_fwd_scores_wide + attn_fwd_pv_wide)
//   backward _fa_bwd   (_bwd_kernel)          -> attn_delta + attn_bwd_mma + attn_dqu_mma
//                                                (wide: attn_delta_wide + attn_bwd_ds_wide +
//                                                 3 x attn_prod_wide)
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
// Any B and H: a grid's y / z dimension holds 65535 blocks, so the wrapper
// (kernels/attention.py::attention_chunks) covers B * H (b, h) pairs in
// launches of at most that many, each entry call given its pairs' pointers,
// its heads' place (h_offset) and a seed shifted past the batches before it;
// the kernels are the same. Offsets into bias, dbias, pd and the score
// scratch are 64-bit (i64), so B * H * L * L may pass 2^32 at rate 0; at a
// rate above 0 the wrapper keeps the uint32 dropout index below it.
//
// What bounds it on an H100: bytes. At B=128, H=4, L=256, D=128 the forward
// must move 201 MB (60 us at 3.35 TB/s) for 17 GFLOP (17 us at the 989 TFLOP/s
// tensor rate); the (B,H,L,L) bias is a third of the bytes (at L=512, D=32
// nearly all of them). The design:
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
//    index (chunk ^ (row & 7) for rows of 8 or more chunks, chunk ^ ((row >> 1)
//    & 3) for the 4-chunk rows of D = 32), which makes every ldmatrix
//    conflict-free (the 2-chunk rows of D = 16 take chunk ^ ((row >> 2) & 1)).
//    Tiles are double-buffered: the copy of tile t+1 is started before the
//    products of tile t.
//  * Head dim 16: q k^T is a single k-step of m16n8k16, and p v and the
//    backward's dv, dk and dqu products two n8 output tiles. The (B,H,L,L) bias
//    and dbias are then nearly all of the bytes (64 of the forward's 80 MiB at
//    B=128, H=4, L=256), and the work a score takes outside the products
//    (exp, the dropout hash, ds) does not shrink with D: that work on the
//    CUDA cores, not the bias stream, sets the time (at rate 0 the forward
//    takes a fifth less). Measured at B=128, H=4, L=256 (PERF.md): the
//    forward runs fastest at 4 blocks an SM, the backward at 6 (3% faster
//    than at 4), and a third or fourth cp.async stage moves neither by more
//    than 2%, so both keep the double buffer (fwd_blocks, bwd_blocks below).
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
//    plain version's and forward and backward agree. A tensor-parallel shard
//    of heads (h_offset .. h_offset + H of h_total) hashes the index of the
//    whole (B, h_total, L, L) tensor: each block maps its (b, h) once.
//  * Head dim 256, forward only: a warp's 16 x 256 f32 output accumulator is
//    128 registers a thread, so the forward keeps no qu fragments beside it
//    (another 64), reads them from shared memory again for every key tile,
//    and takes a tile's 64 keys in steps of 32 (16 in the instance for any L,
//    which holds more addresses): with all 64 the scores' registers spill.
//    Shared memory (182,272 B) and registers leave one block of 4 warps an
//    SM. The backward at 256 runs the wide instance, which beat an instance
//    of its own by 25% on an H100 80GB HBM3 at 700 W (PERF.md §5); this
//    forward beat the wide one by 12-14% there.
//  * Any L: each kernel has two instances, chosen at launch. EXACT (L a
//    multiple of 64, bias 16-byte aligned: the flagship) is the code above
//    with no predicate. The other takes ceil(L / 64) tiles and
//      - zero-fills the rows of the last tile past L (cp.async with a source
//        size of 0), sets the scores of keys >= L to -inf before the running
//        max (they add exactly 0 to the sum and to P V), and never stores a
//        row >= L (out, lse, dqu, dk, dv, dbias);
//      - reads the bias and dbias rows, which start at any 2-byte boundary (a
//        row is 2L bytes: at L = 257 most rows are not 16-byte aligned, and
//        neither TMA nor a 16-byte cp.async takes them), as WINDOWS: each
//        row's 16-byte chunks from the one holding its first value on (9 for
//        64 values) go, still 16 bytes a thread and coalesced across the warp,
//        to a tile row of 9 chunks, where value j sits at column shift + j,
//        shift = (the row's address / 2) & 7. Readers add the row's shift. The
//        dqu pass builds its A fragments from such rows with 2-byte loads
//        (ldmatrix needs 16-byte aligned rows). dbias goes out in 16-byte
//        stores where a chunk lies inside the row and 2-byte stores at its
//        two ends; lse and delta come in by 4-byte cp.async.
//  * Head dims past 256 (and the backward at 256), the wide instance: a
//    warp's 16-row output at full width would need more than the 255
//    registers a thread has (16 x 512 f32 is 256), and no whole-D tile of qu,
//    k, v or g fits beside the others in shared memory. So the head dim Dp (a multiple of WDC, 256 or more) is a
//    runtime argument, and
//      - every score product is streamed: sum over the Dp / WKC column chunks
//        of qu_c k_c^T (g_c v_c^T), the chunks through a cp.async double
//        buffer, with mma_rows_rows and the swizzle at W = WKC = 64;
//      - the forward computes each score once: attn_fwd_scores_wide writes
//        (s + bias) * scale (log2 units, keys >= L at -inf) to an f32 scratch
//        (B, H, Lp, Lp), Lp = L rounded up to whole 64-row tiles, and lse
//        from the running row max and sum; attn_fwd_pv_wide then takes out =
//        T(dropout(exp2(s - lse))) v for DC output columns a block (the exact
//        softmax: no rescaling), the blocks of one query tile side by side in
//        the grid so they share its score tiles in L2;
//      - a small batch leaves the scores pass's ceil(L / 64) * B * H blocks
//        too few for the card (128 at B = 8, H = 4, L = 256, each walking
//        every key tile in series), so the wrapper splits each query tile's
//        key tiles over S blocks (grid z; S from the SM count and the pass's
//        blocks an SM, 1 where the blocks already fill the card): each
//        writes its tiles' scores as before and its rows' partial max and
//        sum, and the p v pass merges the S partials into lse, lse = m +
//        log2 sum_z l_z 2^(m_z - m), before it walks the keys. The scores,
//        their chunk order and the dropout index do not depend on S;
//      - the backward computes each score once too: attn_bwd_ds_wide, one
//        block a (64 queries, 64 keys) tile with no D-sized accumulator,
//        writes dbias and the dropped, rescaled probabilities pd (B, H, L, L,
//        bf16, scratch); then attn_prod_wide takes dv = pd^T g, dk = dbias^T
//        qu and dqu = dbias k, DC output columns a block, reading pd / dbias
//        by rows (A x) or, through ldmatrix.trans, by columns (A^T x). The
//        pd and dbias roundings to bf16 are the other instances'.
//    That moves the f32 scores (forward) and pd (backward) through device
//    memory twice, in place of repeating the score products once for every
//    block of output columns. DC is 128 where Dp is a multiple of 128, else
//    64: at D = 512, 64 took 22% longer in the forward; at D = 320, padding
//    to 384 for 128 took twice as long (PERF.md §5).
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
constexpr int BCH = BSTR / 8;  // 16-byte chunks in a padded bias tile row

struct Dropout {
  uint32_t seed;
  uint32_t thresh;   // keep where hash >= thresh
  float inv_keep;    // 1 / (1 - rate)
  int active;
  int h_local, h_total, h_offset;  // this launch's heads among the whole tensor's
};

// (b, h) of a block's flat bh = b * h_local + h, as the dropout index reads
// it: b * h_total + h_offset + h (bh itself when the launch holds every head)
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

// copies `bytes` (0 or 4) from src and fills the rest of the 4 with zeros
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

// The XOR that a row of a swizzled tile of width W applies to its chunk
// index: 8 rows of 16-byte chunks at one chunk index land in 8 bank groups.
// Rows of 64 bytes (W = 32, two rows a 128-byte line) take bits 1-2 of the row,
// rows of 32 bytes (W = 16, four rows a line) bit 2 (measured against
// unswizzled rows, PERF.md: the backward 1-3% faster).
template <int W>
__device__ __forceinline__ int swz_key(int row) {
  static_assert(W == 16 || W == 32 || W % 64 == 0,
                "swizzled rows of 2, 4 or a multiple of 8 chunks");
  return W == 16 ? (row >> 2) & 1 : W == 32 ? (row >> 1) & 3 : row & 7;
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile whose
// rows hold W bf16 values.
template <int W>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * (W * 2) + ((chunk ^ swz_key<W>(row)) << 4));
}

// ROWS x W values from device memory (row stride ld elements) -> swizzled
// tile; with TAIL, rows >= nrows are zero-filled (the tile at the end of L).
// A tile of fewer chunks than threads (the backward's 32-row tiles at D = 16)
// leaves the last threads idle.
template <int ROWS, int W, bool TAIL = false>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, i64 ld, int nrows = ROWS) {
  constexpr int CH = W / 8, N = ROWS * CH;
  static_assert(N % NT == 0 || NT % N == 0, "the tile's chunks divide among the threads");
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx / CH, c = idx % CH;
    if (N < NT && idx >= N) break;
    if constexpr (TAIL) {
      const bool ok = r < nrows;
      cp_async16_zfill(dst + swz<W>(r, c), ok ? src + (i64)r * ld + c * 8 : src, ok ? 16 : 0);
    } else {
      cp_async16(dst + swz<W>(r, c), src + (i64)r * ld + c * 8);
    }
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

// Where value 0 of a window row lies in its tile row: (address / 2) & 7.
__device__ __forceinline__ int window_shift(const bf16* row) {
  return (int)((reinterpret_cast<uintptr_t>(row) >> 1) & 7);
}

// ROWS x ncols (<= 64) values of a bf16 matrix of row stride ld whose rows
// start at any 2-byte boundary -> padded tile of stride BSTR, as windows:
// row r's 16-byte chunks from the one holding its first value on fill tile
// row r, so value j lands at column window_shift(row) + j. Bytes past a row's
// ncols values and rows >= nrows are zero-filled. The bytes ahead of a row's
// first value in its chunk lie in the same storage (a 16-byte aligned address
// at or above the storage's start) and are ignored.
template <int ROWS>
__device__ __forceinline__ void load_window_tile(uint32_t dst, const bf16* src, i64 ld, int nrows,
                                                 int ncols) {
  constexpr int N = ROWS * BCH;
  const uintptr_t any = reinterpret_cast<uintptr_t>(src) & ~(uintptr_t)15;  // for 0-byte copies
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx / BCH, c = idx % BCH;
    if (N % NT != 0 && idx >= N) break;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src + (i64)r * ld);
    const int lead = (int)(a & 15);  // bytes ahead of the first value in its chunk
    const int bytes = r < nrows ? min(max(lead + 2 * ncols - 16 * c, 0), 16) : 0;
    const uintptr_t from = bytes > 0 ? (a & ~(uintptr_t)15) + 16 * c : any;
    cp_async16_zfill(dst + (uint32_t)((r * BSTR + c * 8) * 2), reinterpret_cast<const void*>(from),
                     bytes);
  }
}

// The padded tile's ROWS rows (value j of row r at column window_shift(dst
// row r) + j, as load_window_tile places them) -> the first ncols values of
// rows 0..nrows of dst (row stride ld): 16-byte stores for the chunks that lie
// inside a row, 2-byte stores for the values of the chunks at its two ends.
template <int ROWS>
__device__ __forceinline__ void store_window_tile(bf16* dst, i64 ld, const unsigned char* tile,
                                                  int nrows, int ncols) {
  constexpr int N = ROWS * BCH;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx / BCH, c = idx % BCH;
    if ((N % NT != 0 && idx >= N) || r >= nrows) continue;
    const uintptr_t a = reinterpret_cast<uintptr_t>(dst + (i64)r * ld);
    const int lead = (int)(a & 15), end = lead + 2 * ncols;  // the row's bytes in its window
    const int lo = 16 * c;
    if (end <= lo || lead >= lo + 16) continue;
    const unsigned char* from = tile + (r * BSTR + c * 8) * 2;
    bf16* to = reinterpret_cast<bf16*>((a & ~(uintptr_t)15) + lo);
    if (lead <= lo && end >= lo + 16) {
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (lo + 2 * e >= lead && lo + 2 * e < end)
          to[e] = reinterpret_cast<const bf16*>(from)[e];
    }
  }
}

// two consecutive bf16 values of a tile at any element index, packed
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) | ((uint32_t)__bfloat16_as_ushort(p[1]) << 16);
}

// ldmatrix addressing. A lane's address of chunk (2 * kk + hi) of its row is
// (tile + lane_off(row, hi)) ^ (kk << 5): the swizzle's XOR splits into a
// per-lane part and a compile-time part because tiles start at multiples of
// their row pitch, so one address register serves a whole tile.
template <int W>
__device__ __forceinline__ uint32_t lane_off(int row, int hi) {
  return (uint32_t)(row * (W * 2) + ((hi ^ swz_key<W>(row)) << 4));
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

// The warp's 16 x N accumulator -> the first N columns of its own 16 rows
// (row0..) of a swizzled tile of width W as bf16, then out to device memory
// in 16-byte stores (row stride ld); with TAIL only the first nrows of the 16.
template <int W, bool TAIL = false, int N = W>
__device__ __forceinline__ void store_rows(unsigned char* smem, uint32_t tile_off,
                                           const float (&acc)[N / 8][4], int row0, bf16* dst,
                                           i64 ld, int lane, int nrows = 16) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    *reinterpret_cast<uint32_t*>(smem + tile_off + swz<W>(row0 + g, n) + 4 * t) =
        pack2(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(smem + tile_off + swz<W>(row0 + g + 8, n) + 4 * t) =
        pack2(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  constexpr int CH = N / 8;
#pragma unroll
  for (int it = 0; it < 16 * CH / 32; ++it) {
    const int idx = lane + it * 32, r = idx / CH, c = idx % CH;
    if (TAIL && r >= nrows) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(smem + tile_off + swz<W>(row0 + r, c));
    *reinterpret_cast<uint4*>(dst + (i64)r * ld + c * 8) = val;
  }
}

// ---------------------------------------------------------------------------
// The blocks an SM that each pass's launch bounds ask for (the registers its
// accumulators leave room for). At D = 16 registers alone bound the blocks
// (28,672 B of shared memory forward, 22,528 B backward): 3 to 6 were
// measured (PERF.md), and these were the fastest.
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int fwd_blocks() {
  return D <= 32 ? 4 : D == 64 ? 3 : D == 128 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int bwd_blocks() {
  return D == 16 ? 6 : D == 32 ? 4 : D == 64 ? 3 : 2;
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(L/64), B*H); blockIdx.x is the query tile, so the tiles
// of one (b, h) run together and k, v come from L2 after the first.
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

template <int D, bool EXACT>
__global__ void __launch_bounds__(NT, fwd_blocks<D>())
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
  const int ntiles = EXACT ? L / BK : (L + BK - 1) / BK;
  const int qrows = L - i0;  // the query tile's rows inside L (TAIL instances)

  if constexpr (EXACT) {
    load_tile<64, D>(sb + S::Q, qu + ((i64)bh * L + i0) * D, D);
    load_tile<64, D>(sb + S::K, kp, D);
    load_tile<64, D>(sb + S::V, vp, D);
    load_bias_tile<64>(sb + S::B, bp, L);
  } else {
    load_tile<64, D, true>(sb + S::Q, qu + ((i64)bh * L + i0) * D, D, qrows);
    load_tile<64, D, true>(sb + S::K, kp, D, L);
    load_tile<64, D, true>(sb + S::V, vp, D, L);
    load_window_tile<64>(sb + S::B, bp, L, qrows, min(L, BK));
  }
  cp_async_commit();

  // the warp's qu fragments stay in registers up to D = 128; at D = 256 they
  // are read from the Q tile again for every key tile (module note)
  constexpr bool QREG = D <= 128;
  // keys of a tile taken at once: all 64 up to D = 128; at D = 256 32 (16 in
  // the instance for any L, which holds more addresses), so the scores and P
  // fragments of a step take a half (a quarter) of the registers beside the
  // 16 x 256 accumulator
  constexpr int KS = D <= 128 ? BK : EXACT ? 32 : 16;
  uint32_t qf[QREG ? D / 16 : 1][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // rows g and g + 8
  const uint32_t row_a = (drop_bh(drop, bh) * L + i0 + r0 + g) * L, row_b = row_a + 8u * L;
  // the bias tile's rows r0 + g and r0 + g + 8: their first elements (TAIL:
  // each row's window shift, the same in every key tile)
  const int ba_off = (r0 + g) * BSTR + (EXACT ? 0 : window_shift(bp + (i64)(r0 + g) * L));
  const int bb_off = (r0 + g + 8) * BSTR + (EXACT ? 0 : window_shift(bp + (i64)(r0 + g + 8) * L));

  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait_all();
    __syncthreads();
    const int st = tt & 1;
    if (tt + 1 < ntiles) {
      const int nx = st ^ 1, j1 = (tt + 1) * BK;
      if constexpr (EXACT) {
        load_tile<64, D>(sb + S::K + nx * S::TILE, kp + (i64)j1 * D, D);
        load_tile<64, D>(sb + S::V + nx * S::TILE, vp + (i64)j1 * D, D);
        load_bias_tile<64>(sb + S::B + nx * S::BIAS, bp + j1, L);
      } else {
        load_tile<64, D, true>(sb + S::K + nx * S::TILE, kp + (i64)j1 * D, D, L - j1);
        load_tile<64, D, true>(sb + S::V + nx * S::TILE, vp + (i64)j1 * D, D, L - j1);
        load_window_tile<64>(sb + S::B + nx * S::BIAS, bp + j1, L, qrows, min(L - j1, BK));
      }
      cp_async_commit();
    }
    if constexpr (QREG) {
      if (tt == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[kk], lane_base_a<D>(sb + S::Q, r0, lane) ^ (kk << 5));
      }
    }

    // the tile's keys KS at a time
    const bf16* bt = reinterpret_cast<const bf16*>(smem + S::B + st * S::BIAS);
    const float sl2 = scale * LOG2E;
    const int kleft = L - tt * BK;  // keys of this tile inside L
    // at D = 256 one step at a time, so the compiler does not interleave
    // the two steps' score registers
#pragma unroll 1
    for (int h = 0; h < BK / KS; ++h) {
      // s = qu k^T for the warp's 16 rows and the KS keys from h * KS
      float s[KS / 8][4];
#pragma unroll
      for (int n = 0; n < KS / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const uint32_t kb = lane_base_b<D>(sb + S::K + st * S::TILE, lane) + h * KS * D * 2;
      if constexpr (QREG) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
          for (int np = 0; np < KS / 16; ++np) {
            uint32_t b[4];
            ldsm_x4(b, (kb ^ (kk << 5)) + np * 16 * D * 2);
            mma16816(s[2 * np], qf[kk], b[0], b[1]);
            mma16816(s[2 * np + 1], qf[kk], b[2], b[3]);
          }
        }
      } else {
        mma_rows_rows<D, KS / 8>(s, lane_base_a<D>(sb + S::Q, r0, lane), kb);
      }

      // (s + bias) * scale, in log2 units for exp2f; running max. TAIL: keys
      // >= L (zero rows of K) get -inf, so they weigh exactly 0
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < KS / 8; ++n) {
        const int col = h * KS + 8 * n + 2 * t;
        float2 ba, bb;
        if constexpr (EXACT) {
          ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bt + ba_off + col));
          bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bt + bb_off + col));
        } else {
          ba = make_float2(__bfloat162float(bt[ba_off + col]),
                           __bfloat162float(bt[ba_off + col + 1]));
          bb = make_float2(__bfloat162float(bt[bb_off + col]),
                           __bfloat162float(bt[bb_off + col + 1]));
        }
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
      const float corr_a = fast_exp2(m_a - mn_a), corr_b = fast_exp2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;

      // e = exp(s - m): summed in f32; dropped or scaled by 1/(1-rate), then
      // rounded to bf16 as the A operand of the PV product
      float sum_a = 0.f, sum_b = 0.f;
      const uint32_t j0 = (uint32_t)(tt * BK + h * KS);
#pragma unroll
      for (int n = 0; n < KS / 8; ++n) {
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
      uint32_t pf[KS / 16][4];
#pragma unroll
      for (int kc = 0; kc < KS / 16; ++kc) {
        pf[kc][0] = pack2(s[2 * kc][0], s[2 * kc][1]);
        pf[kc][1] = pack2(s[2 * kc][2], s[2 * kc][3]);
        pf[kc][2] = pack2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pf[kc][3] = pack2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      }
      mma_a_regs_b_rows<D, KS / 16, D / 8>(
          o, pf, lane_base_a<D>(sb + S::V + st * S::TILE, h * KS, lane));
    }
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
  // the query tile's rows r0.. were read by this warp alone (its last read
  // of them is behind it): reuse them
  bf16* op = out + (bh / H) * os.b + (bh % H) * os.h + (i64)(i0 + r0) * os.l;
  store_rows<D, !EXACT>(smem, S::Q, o, r0, op, os.l, lane, qrows - r0);
}

// ---------------------------------------------------------------------------
// delta[b, h, i] = sum_d g[b, h, i, d] * out[b, h, i, d]; D/8 lanes per row
// ---------------------------------------------------------------------------
template <int D, bool EXACT>
__global__ void __launch_bounds__(256)
attn_delta(const bf16* __restrict__ g, const bf16* __restrict__ out,
           float* __restrict__ delta, int H, int L, int rows, Strides gs, Strides os) {
  constexpr int LPR = D / 8;
  const int row = blockIdx.x * (256 / LPR) + threadIdx.x / LPR, c = threadIdx.x % LPR;
  // TAIL: the last block's rows past B*H*L read row 0 and write nothing (they
  // stay in the warp's shuffles)
  const bool live = EXACT || row < rows;
  const int rr = live ? row : 0;
  const int bh = rr / L, i = rr % L;
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
  if (c == 0 && live) delta[row] = sum;
}

// ---------------------------------------------------------------------------
// backward, main pass (D <= 128): grid (ceil(L/64), B*H); blockIdx.x is the
// key tile. Each warp owns 16 keys and keeps their dv and dk in registers
// over the query loop.
// smem: K tile, V tile, 2 x (Q, G, bias tiles of BQ queries, lse, delta),
// dbias staging tile
// ---------------------------------------------------------------------------
template <int D>
struct BwdSmem {
  static_assert(D <= 128, "the wide instance takes the backward past 128");
  static constexpr int KV = 64 * D * 2;
  static constexpr int QG = BQ * D * 2;
  static constexpr int BIAS = BQ * BSTR * 2;
  static constexpr int STAT = 2 * BQ * 4;                 // lse then delta
  // a stage's Q and G tiles start at multiples of 256 bytes, as the ldmatrix
  // addressing's XOR of chunk offsets needs
  static constexpr int PITCH = 256;
  static constexpr int STAGE = (2 * QG + BIAS + STAT + PITCH - 1) / PITCH * PITCH;
  static constexpr int K = 0;
  static constexpr int V = KV;
  static constexpr int ST = 2 * KV;                       // 2 stages: Q, G, bias, stats
  static constexpr int DS = 2 * KV + 2 * STAGE;
  static constexpr int BYTES = DS + BIAS;
  static_assert(QG % PITCH == 0 && STAGE % PITCH == 0, "tiles start at multiples of their pitch");
};

template <int D, bool EXACT>
__global__ void __launch_bounds__(NT, bwd_blocks<D>())
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
  bf16* dbp = dbias + (i64)bh * L * L + j0;
  const float* lp = lse + (i64)bh * L;
  const float* dp = delta + (i64)bh * L;
  const uint32_t dbh = drop_bh(drop, bh);
  const int nsteps = EXACT ? L / BQ : (L + BQ - 1) / BQ;
  const int kcols = min(L - j0, BK);  // the key tile's keys inside L (TAIL instances)
  // TAIL: the window shift of bias / dbias row i of this key tile is
  // (*_sh + i * L) & 7 (addresses / 2, taken mod 8)
  const uint32_t b_sh = (uint32_t)(reinterpret_cast<uintptr_t>(bp) >> 1);
  const uint32_t db_sh = (uint32_t)(reinterpret_cast<uintptr_t>(dbp) >> 1);

  auto load_stage = [&](int stage, int q0) {
    const uint32_t base = sb + S::ST + stage * S::STAGE;
    const uint32_t stat = base + 2 * S::QG + S::BIAS;
    if constexpr (EXACT) {
      load_tile<BQ, D>(base, qp + (i64)q0 * D, D);
      load_tile<BQ, D>(base + S::QG, gp + (i64)q0 * gs.l, gs.l);
      load_bias_tile<BQ>(base + 2 * S::QG, bp + (i64)q0 * L, L);
      constexpr int SC = BQ / 4;  // 16-byte chunks of BQ floats
      if (threadIdx.x < 2 * SC) {
        const int c = threadIdx.x;
        const float* src = c < SC ? lp + q0 + 4 * c : dp + q0 + 4 * (c - SC);
        cp_async16(stat + 16 * c, src);
      }
    } else {
      const int nq = L - q0;
      load_tile<BQ, D, true>(base, qp + (i64)q0 * D, D, nq);
      load_tile<BQ, D, true>(base + S::QG, gp + (i64)q0 * gs.l, gs.l, nq);
      load_window_tile<BQ>(base + 2 * S::QG, bp + (i64)q0 * L, L, nq, kcols);
      // a (B, H, L) f32 row starts 4-byte aligned only: one value a thread,
      // zeros past L
      if (threadIdx.x < 2 * BQ) {
        const int c = threadIdx.x % BQ;
        const float* row = threadIdx.x < BQ ? lp : dp;
        const bool ok = c < nq;
        cp_async4_zfill(stat + 4 * threadIdx.x, ok ? row + q0 + c : row, ok ? 4 : 0);
      }
    }
  };

  if constexpr (EXACT) {
    load_tile<64, D>(sb + S::K, k + ((i64)bh * L + j0) * D, D);
    load_tile<64, D>(sb + S::V, v + ((i64)bh * L + j0) * D, D);
  } else {
    load_tile<64, D, true>(sb + S::K, k + ((i64)bh * L + j0) * D, D, kcols);
    load_tile<64, D, true>(sb + S::V, v + ((i64)bh * L + j0) * D, D, kcols);
  }
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
          const int bcol =
              EXACT ? kk : kk + (int)((b_sh + (uint32_t)(q0 + qq) * (uint32_t)L) & 7);
          const float b = __bfloat162float(bt[qq * BSTR + bcol]);
          const float pe = fast_exp2((p[n][e] + b) * sl2 - ((e & 1) ? ls.y : ls.x) * LOG2E);
          bool kp = true;
          if (drop.active)
            kp = keep(drop, (dbh * L + q0 + qq) * L + (e < 2 ? key_a : key_b));
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
        const int qq = q + (e & 1), kk = r0 + g + (e < 2 ? 0 : 8);
        const int dcol = EXACT ? kk : kk + (int)((db_sh + (uint32_t)(q0 + qq) * (uint32_t)L) & 7);
        dst[qq * BSTR + dcol] = dsx;
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

    // the dbias tile, BQ rows of 64 keys, out in 16-byte stores (TAIL: as
    // windows, rows and keys inside L only)
    __syncthreads();
    bf16* db = dbp + (i64)q0 * L;
    if constexpr (EXACT) {
#pragma unroll
      for (int i2 = 0; i2 < BQ * 8 / NT; ++i2) {
        const int idx = threadIdx.x + i2 * NT, r = idx >> 3, c = idx & 7;
        *reinterpret_cast<uint4*>(db + (i64)r * L + c * 8) =
            *reinterpret_cast<const uint4*>(smem + S::DS + (r * BSTR + c * 8) * 2);
      }
    } else {
      store_window_tile<BQ>(db, L, smem + S::DS, L - q0, kcols);
    }
  }

  // K and V rows r0.. were read by this warp alone: reuse them as staging
  const i64 orow = ((i64)bh * L + j0 + r0) * D;
  store_rows<D, !EXACT>(smem, S::K, dka, r0, dk + orow, D, lane, kcols - r0);
  store_rows<D, !EXACT>(smem, S::V, dva, r0, dv + orow, D, lane, kcols - r0);
}

// ---------------------------------------------------------------------------
// backward, dqu = dbias k (D <= 128): grid (ceil(L/64), B*H); blockIdx.x is
// the query tile. smem: 2 x (dbias tile 64 x 64, K tile 64 x D); TAIL: the
// dbias tile is a padded window tile (64 x BSTR)
// ---------------------------------------------------------------------------
template <int D, bool EXACT>
struct DquSmem {
  static constexpr int A = EXACT ? 64 * 64 * 2 : 64 * BSTR * 2;
  static constexpr int KT = 64 * D * 2;
  static constexpr int STAGE = A + KT;
  static constexpr int BYTES = 2 * STAGE;
  static_assert(A % 256 == 0 && STAGE % 256 == 0, "tiles start at multiples of 256 bytes");
};

template <int D, bool EXACT>
__global__ void __launch_bounds__(NT)
attn_dqu_mma(const bf16* __restrict__ dbias, const bf16* __restrict__ k,
             bf16* __restrict__ dqu, int L) {
  typedef DquSmem<D, EXACT> S;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int bh = blockIdx.y, i0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp;
  const bf16* ap = dbias + ((i64)bh * L + i0) * L;
  const bf16* kp = k + (i64)bh * L * D;
  const int ntiles = EXACT ? L / BK : (L + BK - 1) / BK;
  const int qrows = L - i0;

  if constexpr (EXACT) {
    load_tile<64, 64>(sb, ap, L);
    load_tile<64, D>(sb + S::A, kp, D);
  } else {
    load_window_tile<64>(sb, ap, L, qrows, min(L, BK));
    load_tile<64, D, true>(sb + S::A, kp, D, L);
  }
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // TAIL: the thread's A rows r0 + g and r0 + g + 8 in the window tiles
  const int g = lane >> 2, t = lane & 3;
  const int a_off = (r0 + g) * BSTR + 2 * t + (EXACT ? 0 : window_shift(ap + (i64)(r0 + g) * L));
  const int b_off =
      (r0 + g + 8) * BSTR + 2 * t + (EXACT ? 0 : window_shift(ap + (i64)(r0 + g + 8) * L));

  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait_all();
    __syncthreads();
    const int st = tt & 1;
    if (tt + 1 < ntiles) {
      const uint32_t nx = sb + (st ^ 1) * S::STAGE;
      const int j1 = (tt + 1) * BK;
      if constexpr (EXACT) {
        load_tile<64, 64>(nx, ap + j1, L);
        load_tile<64, D>(nx + S::A, kp + (i64)j1 * D, D);
      } else {
        load_window_tile<64>(nx, ap + j1, L, qrows, min(L - j1, BK));
        load_tile<64, D, true>(nx + S::A, kp + (i64)j1 * D, D, L - j1);
      }
      cp_async_commit();
    }
    const uint32_t at = sb + st * S::STAGE;
    uint32_t af[4][4];
    if constexpr (EXACT) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        ldsm_x4(af[kc], lane_base_a<64>(at, r0, lane) ^ (kc << 5));
    } else {
      const bf16* a = reinterpret_cast<const bf16*>(smem + st * S::STAGE);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        af[kc][0] = ld_pair(a + a_off + 16 * kc);
        af[kc][1] = ld_pair(a + b_off + 16 * kc);
        af[kc][2] = ld_pair(a + a_off + 16 * kc + 8);
        af[kc][3] = ld_pair(a + b_off + 16 * kc + 8);
      }
    }
    mma_a_regs_b_rows<D, 4, D / 8>(acc, af, lane_base_a<D>(at + S::A, 0, lane));
  }
  __syncthreads();  // every warp is done with the stages: reuse stage 0's K tile
  store_rows<D, !EXACT>(smem, S::A, acc, r0, dqu + ((i64)bh * L + i0 + r0) * D, D, lane,
                         qrows - r0);
}

// ===========================================================================
// The wide instance: every head dim above 256 (module note). Dp, the padded
// head dim, is a runtime multiple of WDC; no tile and no register array
// depends on it.
// ===========================================================================
// The wide head dims are the multiples of WDC (WIDE_CHUNK in kernels/attention.py,
// which pads to them). The p v and product passes take 2 WDC output columns a
// block where Dp is a multiple of 2 WDC, else WDC (measured, PERF.md §5).
constexpr int WDC = 64;
constexpr int WKC = 64;   // columns of a streamed qu / k / g / v chunk
static_assert(WDC % WKC == 0, "a wide head dim is a whole number of streamed chunks");
constexpr int SBF = 72;   // pitch (floats) of a 64 x 64 f32 score tile read as float2 pairs

// 64 x 64 floats of a matrix of row stride ld (rows 16-byte aligned) -> tile
// of pitch SBF
__device__ __forceinline__ void load_f32_tile(uint32_t dst, const float* src, i64 ld) {
#pragma unroll
  for (int it = 0; it < 64 * 16 / NT; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx >> 4, c = idx & 15;
    cp_async16(dst + (uint32_t)((r * SBF + 4 * c) * 4), src + (i64)r * ld + 4 * c);
  }
}

// two bf16 values of a tile at any element indices, packed (lo first)
__device__ __forceinline__ uint32_t ld_two(const bf16* lo, const bf16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo) | ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

// ---------------------------------------------------------------------------
// wide forward, pass 1: grid (ceil(L/64), B*H, S). The block's 64 query rows
// against its split's key tiles (split z of S takes the tiles from z *
// ceil(nt / S) on, ceil(nt / S) of them or the rest, none past the last):
// s = sum over the Dp / KC chunks of qu_c k_c^T (chunks streamed through a
// cp.async double buffer in (key tile, chunk) order), then (s + bias) * scale
// in log2 units, keys >= L at -inf, written to the f32 score scratch (B*H, Lp,
// Lp), Lp = 64 ceil(L / 64), with the running row max and sum. At S = 1 the
// block writes lse per row at the end; else its rows' partial max m_z and sum
// l_z (log2 units) to part (2, B*H, S, Lp), which the p v pass merges. A split
// with no key tile writes (-inf, 0), which adds nothing to the merge.
// smem: 2 x (qu chunk, k chunk), 2 x bias tile
// ---------------------------------------------------------------------------
template <int KC>
struct WideScoresSmem {
  static constexpr int CH = 64 * KC * 2;  // a 64-row chunk tile
  static constexpr int STAGE = 2 * CH;    // qu chunk, k chunk
  static constexpr int BIAS = 64 * BSTR * 2;
  static constexpr int B = 2 * STAGE;     // 2 bias stages
  static constexpr int BYTES = B + 2 * BIAS;
  static_assert(CH % 1024 == 0 && BIAS % 256 == 0, "tiles start at multiples of 256 bytes");
};

template <int KC, bool EXACT>
__global__ void __launch_bounds__(NT, 3)
attn_fwd_scores_wide(const bf16* __restrict__ qu, const bf16* __restrict__ k,
                     const bf16* __restrict__ bias, float* __restrict__ scores,
                     float* __restrict__ lse, float* __restrict__ part, int L, int Dp,
                     float scale) {
  typedef WideScoresSmem<KC> S;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int bh = blockIdx.y, i0 = blockIdx.x * 64, nsplit = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int nkc = Dp / KC, ntiles = (L + BK - 1) / BK, Lp = ntiles * BK;
  const int per = (ntiles + nsplit - 1) / nsplit, tt0 = blockIdx.z * per;
  const int nsteps = max(min(per, ntiles - tt0), 0) * nkc;
  const int qrows = L - i0;
  const bf16* qp = qu + ((i64)bh * L + i0) * Dp;
  const bf16* kp = k + (i64)bh * L * Dp;
  const bf16* bp = bias + ((i64)bh * L + i0) * L;

  // step s: chunk s % nkc of key tile tt0 + s / nkc; a tile's first chunk
  // also brings its bias, into the stage the tile before last has left
  auto load_step = [&](int s) {
    const int tt = tt0 + s / nkc, c = s % nkc, j = tt * BK;
    const uint32_t st = sb + (s & 1) * S::STAGE;
    if constexpr (EXACT) {
      load_tile<64, KC>(st, qp + c * KC, Dp);
      load_tile<64, KC>(st + S::CH, kp + (i64)j * Dp + c * KC, Dp);
    } else {
      load_tile<64, KC, true>(st, qp + c * KC, Dp, qrows);
      load_tile<64, KC, true>(st + S::CH, kp + (i64)j * Dp + c * KC, Dp, L - j);
    }
    if (c == 0) {
      const uint32_t bt = sb + S::B + (tt & 1) * S::BIAS;
      if constexpr (EXACT) load_bias_tile<64>(bt, bp + j, L);
      else load_window_tile<64>(bt, bp + j, L, qrows, min(L - j, BK));
    }
  };
  if (nsteps > 0) load_step(0);
  cp_async_commit();

  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // rows g and g + 8
  const float sl2 = scale * LOG2E;
  const int ba_off = (r0 + g) * BSTR + (EXACT ? 0 : window_shift(bp + (i64)(r0 + g) * L));
  const int bb_off = (r0 + g + 8) * BSTR + (EXACT ? 0 : window_shift(bp + (i64)(r0 + g + 8) * L));
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
    mma_rows_rows<KC, 8>(s, lane_base_a<KC>(st, r0, lane), lane_base_b<KC>(st + S::CH, lane));
    if (step % nkc != nkc - 1) continue;

    // the key tile's scores are whole: bias, scale, running max and sum, out
    const int tt = tt0 + step / nkc, kleft = L - tt * BK;
    const bf16* bt = reinterpret_cast<const bf16*>(smem + S::B + (tt & 1) * S::BIAS);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t;
      float2 ba, bb;
      if constexpr (EXACT) {
        ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bt + ba_off + col));
        bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bt + bb_off + col));
      } else {
        ba = make_float2(__bfloat162float(bt[ba_off + col]),
                         __bfloat162float(bt[ba_off + col + 1]));
        bb = make_float2(__bfloat162float(bt[bb_off + col]),
                         __bfloat162float(bt[bb_off + col + 1]));
      }
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
// by 1/(1-rate), rounded to bf16 as the A operand of out += p v.
// smem: 2 x (score tile, v chunk)
// ---------------------------------------------------------------------------
template <int DC>
struct WidePvSmem {
  static constexpr int SC = 64 * SBF * 4;
  static constexpr int VT = 64 * DC * 2;
  static constexpr int STAGE = SC + VT;
  static constexpr int BYTES = 2 * STAGE;
  static_assert(SC % 256 == 0 && STAGE % 256 == 0, "tiles start at multiples of 256 bytes");
};

template <int DC, bool EXACT>
__global__ void __launch_bounds__(NT, 3)
attn_fwd_pv_wide(const float* __restrict__ scores, float* __restrict__ lse,
                 const float* __restrict__ part, int nsplit, const bf16* __restrict__ v,
                 bf16* __restrict__ out, int H, int L, int Dp, Dropout drop, Strides os) {
  typedef WidePvSmem<DC> S;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int nch = Dp / DC, bh = blockIdx.y;
  const int i0 = blockIdx.x / nch * 64, c0 = blockIdx.x % nch * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int ntiles = (L + BK - 1) / BK, Lp = ntiles * BK, qrows = L - i0;
  const float* sp = scores + ((i64)bh * Lp + i0) * Lp;
  const bf16* vp = v + (i64)bh * L * Dp + c0;

  auto load = [&](int tt) {
    const uint32_t st = sb + (tt & 1) * S::STAGE;
    const int j = tt * BK;
    load_f32_tile(st, sp + j, Lp);
    if constexpr (EXACT) load_tile<64, DC>(st + S::SC, vp + (i64)j * Dp, Dp);
    else load_tile<64, DC, true>(st + S::SC, vp + (i64)j * Dp, Dp, L - j);
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
    uint32_t pf[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      pf[kc][0] = pack2(p[2 * kc][0], p[2 * kc][1]);
      pf[kc][1] = pack2(p[2 * kc][2], p[2 * kc][3]);
      pf[kc][2] = pack2(p[2 * kc + 1][0], p[2 * kc + 1][1]);
      pf[kc][3] = pack2(p[2 * kc + 1][2], p[2 * kc + 1][3]);
    }
    mma_a_regs_b_rows<DC, 4, DC / 8>(o, pf, lane_base_a<DC>(sb + stage + S::SC, 0, lane));
  }
  __syncthreads();  // every warp is done with the tiles: stage 0's v tile stages the rows
  bf16* op = out + (bh / H) * os.b + (bh % H) * os.h + (i64)(i0 + r0) * os.l + c0;
  store_rows<DC, !EXACT>(smem, S::SC, o, r0, op, os.l, lane, qrows - r0);
}

// ---------------------------------------------------------------------------
// wide backward, delta = rowsum(g * out): W / 8 lanes a row, W = DC columns
// a step of the loop over Dp
// ---------------------------------------------------------------------------
template <int W, bool EXACT>
__global__ void __launch_bounds__(256)
attn_delta_wide(const bf16* __restrict__ g, const bf16* __restrict__ out,
                float* __restrict__ delta, int H, int L, int rows, int Dp, Strides gs, Strides os) {
  constexpr int LPR = W / 8;
  const int row = blockIdx.x * (256 / LPR) + threadIdx.x / LPR, c = threadIdx.x % LPR;
  const bool live = EXACT || row < rows;
  const int rr = live ? row : 0;
  const int bh = rr / L, i = rr % L;
  const i64 b = bh / H, h = bh % H;
  const bf16* gr = g + b * gs.b + h * gs.h + i * gs.l + c * 8;
  const bf16* orow = out + b * os.b + h * os.h + i * os.l + c * 8;
  float sum = 0.f;
  for (int d = 0; d < Dp; d += W) {
    const uint4 gv = *reinterpret_cast<const uint4*>(gr + d);
    const uint4 ov = *reinterpret_cast<const uint4*>(orow + d);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(g2[e]), bb = __bfloat1622float2(o2[e]);
      sum = fmaf(a.x, bb.x, sum);
      sum = fmaf(a.y, bb.y, sum);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (c == 0 && live) delta[row] = sum;
}

// ---------------------------------------------------------------------------
// wide backward, scores: grid (ceil(L/64) key tiles, ceil(L/64) query tiles,
// B*H). A block holds no D-sized accumulator: it streams the chunks of qu, k,
// g and v for its (64 queries, 64 keys) and sums s = qu k^T and dp = g v^T,
// then writes dbias = T(p (dropout'(dp) - delta) * scale) and the dropped,
// rescaled probabilities pd = T(dropout(p)) (B, H, L, L), which the product
// passes turn into dv = pd^T g, dk = dbias^T qu and dqu = dbias k.
// smem: 2 x (qu, k, g, v chunks), bias tile, lse and delta, dbias and pd
// staging tiles
// ---------------------------------------------------------------------------
template <int KC>
struct WideDsSmem {
  static constexpr int CH = 64 * KC * 2;
  static constexpr int STAGE = 4 * CH;
  static constexpr int BIAS = 64 * BSTR * 2;
  static constexpr int B = 2 * STAGE;
  static constexpr int STAT = B + BIAS;   // lse, then delta, 64 rows each
  static constexpr int DS = STAT + 2 * 64 * 4;
  static constexpr int PD = DS + BIAS;
  static constexpr int BYTES = PD + BIAS;
  static_assert(CH % 1024 == 0 && DS % 16 == 0, "tiles start 16-byte aligned, chunks swizzled");
};

template <int KC, bool EXACT>
__global__ void __launch_bounds__(NT, 2)
attn_bwd_ds_wide(const bf16* __restrict__ qu, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ bias,
                 const bf16* __restrict__ gr, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dbias, bf16* __restrict__ pd,
                 int H, int L, int Dp, float scale, Dropout drop, Strides gs) {
  typedef WideDsSmem<KC> S;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int j0 = blockIdx.x * BK, i0 = blockIdx.y * 64, bh = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // the warp's queries within the tile
  const int nkc = Dp / KC, qrows = L - i0, kcols = min(L - j0, BK);
  const bf16* qp = qu + ((i64)bh * L + i0) * Dp;
  const bf16* kp = k + ((i64)bh * L + j0) * Dp;
  const bf16* vp = v + ((i64)bh * L + j0) * Dp;
  const bf16* gp = gr + (bh / H) * gs.b + (bh % H) * gs.h + (i64)i0 * gs.l;
  const i64 tile0 = ((i64)bh * L + i0) * L + j0;  // element (i0, j0) of the (L, L) matrices

  auto load_chunk = [&](int c) {
    const uint32_t st = sb + (c & 1) * S::STAGE;
    if constexpr (EXACT) {
      load_tile<64, KC>(st, qp + c * KC, Dp);
      load_tile<64, KC>(st + S::CH, kp + c * KC, Dp);
      load_tile<64, KC>(st + 2 * S::CH, gp + c * KC, gs.l);
      load_tile<64, KC>(st + 3 * S::CH, vp + c * KC, Dp);
    } else {
      load_tile<64, KC, true>(st, qp + c * KC, Dp, qrows);
      load_tile<64, KC, true>(st + S::CH, kp + c * KC, Dp, kcols);
      load_tile<64, KC, true>(st + 2 * S::CH, gp + c * KC, gs.l, qrows);
      load_tile<64, KC, true>(st + 3 * S::CH, vp + c * KC, Dp, kcols);
    }
  };
  load_chunk(0);
  const float* lp = lse + (i64)bh * L + i0;
  const float* dlp = delta + (i64)bh * L + i0;
  if constexpr (EXACT) {
    load_bias_tile<64>(sb + S::B, bias + tile0, L);
    if (threadIdx.x < 32) {
      const int c = threadIdx.x;
      cp_async16(sb + S::STAT + 16 * c, c < 16 ? lp + 4 * c : dlp + 4 * (c - 16));
    }
  } else {
    load_window_tile<64>(sb + S::B, bias + tile0, L, qrows, kcols);
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
    mma_rows_rows<KC, 8>(s, lane_base_a<KC>(st, r0, lane), lane_base_b<KC>(st + S::CH, lane));
    mma_rows_rows<KC, 8>(dp, lane_base_a<KC>(st + 2 * S::CH, r0, lane),
                         lane_base_b<KC>(st + 3 * S::CH, lane));
  }

  // p, pd and ds of the warp's 16 queries x 64 keys, staged as bf16 rows
  // (TAIL: each row at its window shift in dbias / pd)
  const bf16* bt = reinterpret_cast<const bf16*>(smem + S::B);
  const float* stat = reinterpret_cast<const float*>(smem + S::STAT);
  bf16* dst = reinterpret_cast<bf16*>(smem + S::DS);
  bf16* pdt = reinterpret_cast<bf16*>(smem + S::PD);
  const float sl2 = scale * LOG2E;
  const uint32_t dbh = drop_bh(drop, bh);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const i64 at = tile0 + (i64)r * L;
    const int boff = r * BSTR + (EXACT ? 0 : window_shift(bias + at));
    const int doff = r * BSTR + (EXACT ? 0 : window_shift(dbias + at));
    const int poff = r * BSTR + (EXACT ? 0 : window_shift(pd + at));
    const float l2 = stat[r] * LOG2E, dl = stat[64 + r];
    const uint32_t flat = (dbh * L + i0 + r) * L + j0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e, x = 2 * half + e;
        const float b = __bfloat162float(bt[boff + col]);
        const float p = fast_exp2((s[n][x] + b) * sl2 - l2);
        const bool kept = !drop.active || keep(drop, flat + col);
        const float dpm = kept ? dp[n][x] * drop.inv_keep : 0.f;
        dst[doff + col] = __float2bfloat16(p * (dpm - dl) * scale);
        pdt[poff + col] = __float2bfloat16(kept ? p * drop.inv_keep : 0.f);
      }
    }
  }
  __syncthreads();
  if constexpr (EXACT) {
#pragma unroll
    for (int it = 0; it < 64 * 8 / NT; ++it) {
      const int idx = threadIdx.x + it * NT, r = idx >> 3, c = idx & 7;
      const int off = (r * BSTR + c * 8) * 2;
      *reinterpret_cast<uint4*>(dbias + tile0 + (i64)r * L + c * 8) =
          *reinterpret_cast<const uint4*>(smem + S::DS + off);
      *reinterpret_cast<uint4*>(pd + tile0 + (i64)r * L + c * 8) =
          *reinterpret_cast<const uint4*>(smem + S::PD + off);
    }
  } else {
    store_window_tile<64>(dbias + tile0, L, smem + S::DS, qrows, kcols);
    store_window_tile<64>(pd + tile0, L, smem + S::PD, qrows, kcols);
  }
}

// ---------------------------------------------------------------------------
// wide backward, products: out (B, H, L, Dp) = A x, or with TRANS A^T x, for
// A (B, H, L, L) (dbias or pd) and x (B, H, L, Dp) of strides xs: dqu = dbias
// k, dk = dbias^T qu, dv = pd^T g. Grid (ceil(L/64) * Dp/DC, B*H) as pass 2 of
// the forward; the block walks the other side of A in tiles of 64 (TRANS: A's
// rows, whose A^T fragments come by ldmatrix.trans).
// smem: 2 x (A tile 64 x 64 (TAIL: a padded window tile), x chunk 64 x DC)
// ---------------------------------------------------------------------------
template <int DC, bool EXACT>
struct WideProdSmem {
  static constexpr int A = EXACT ? 64 * 64 * 2 : 64 * BSTR * 2;
  static constexpr int XT = 64 * DC * 2;
  static constexpr int STAGE = A + XT;
  static constexpr int BYTES = 2 * STAGE;
  static_assert(A % 256 == 0 && STAGE % 256 == 0, "tiles start at multiples of 256 bytes");
};

template <int DC, bool EXACT, bool TRANS>
__global__ void __launch_bounds__(NT)
attn_prod_wide(const bf16* __restrict__ a, const bf16* __restrict__ x, bf16* __restrict__ out,
               int H, int L, int Dp, Strides xs) {
  typedef WideProdSmem<DC, EXACT> S;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const int nch = Dp / DC, bh = blockIdx.y;
  const int o0 = blockIdx.x / nch * 64, c0 = blockIdx.x % nch * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int ntiles = (L + BK - 1) / BK, orows = L - o0;
  const bf16* am = a + (i64)bh * L * L;
  const bf16* xp = x + (bh / H) * xs.b + (bh % H) * xs.h + c0;

  auto load = [&](int tt) {
    const uint32_t st = sb + (tt & 1) * S::STAGE;
    const int j1 = tt * BK;
    const bf16* src = TRANS ? am + (i64)j1 * L + o0 : am + (i64)o0 * L + j1;
    if constexpr (EXACT) {
      load_tile<64, 64>(st, src, L);
      load_tile<64, DC>(st + S::A, xp + (i64)j1 * xs.l, xs.l);
    } else {
      load_window_tile<64>(st, src, L, TRANS ? L - j1 : orows,
                           TRANS ? min(orows, BK) : min(L - j1, BK));
      load_tile<64, DC, true>(st + S::A, xp + (i64)j1 * xs.l, xs.l, L - j1);
    }
  };
  load(0);
  cp_async_commit();

  float acc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // TAIL, A x: the thread's A rows r0 + g and r0 + g + 8, whose window shifts
  // are the same in every tile (tiles step by 64 values)
  const int a_off =
      (r0 + g) * BSTR + 2 * t + (EXACT ? 0 : window_shift(am + (i64)(o0 + r0 + g) * L));
  const int b_off =
      (r0 + g + 8) * BSTR + 2 * t + (EXACT ? 0 : window_shift(am + (i64)(o0 + r0 + g + 8) * L));
  // TAIL, A^T x: the shift of A's row j is (a_sh + j * L) & 7
  const uint32_t a_sh = (uint32_t)(reinterpret_cast<uintptr_t>(am + o0) >> 1);

  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait_all();
    __syncthreads();
    if (tt + 1 < ntiles) {
      load(tt + 1);
      cp_async_commit();
    }
    const int stage = (tt & 1) * S::STAGE;
    const uint32_t at = sb + stage;
    uint32_t af[4][4];
    if constexpr (EXACT) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if constexpr (TRANS)
          ldsm_x4_t(af[kc], (lane_base_b<64>(at, lane) ^ (warp << 5)) + kc * 16 * 64 * 2);
        else
          ldsm_x4(af[kc], lane_base_a<64>(at, r0, lane) ^ (kc << 5));
      }
    } else {
      const bf16* ap = reinterpret_cast<const bf16*>(smem + stage);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if constexpr (TRANS) {
          // A^T[m][k] = A[k][m]: rows k of the tile, column m = r0 + g (+ 8)
          const int k0 = 16 * kc + 2 * t, j1 = tt * BK;
          const bf16* rk[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int kk = k0 + (q & 1) + 8 * (q >> 1);
            rk[q] = ap + kk * BSTR + (int)((a_sh + (uint32_t)(j1 + kk) * (uint32_t)L) & 7) + r0 + g;
          }
          af[kc][0] = ld_two(rk[0], rk[1]);
          af[kc][1] = ld_two(rk[0] + 8, rk[1] + 8);
          af[kc][2] = ld_two(rk[2], rk[3]);
          af[kc][3] = ld_two(rk[2] + 8, rk[3] + 8);
        } else {
          af[kc][0] = ld_pair(ap + a_off + 16 * kc);
          af[kc][1] = ld_pair(ap + b_off + 16 * kc);
          af[kc][2] = ld_pair(ap + a_off + 16 * kc + 8);
          af[kc][3] = ld_pair(ap + b_off + 16 * kc + 8);
        }
      }
    }
    mma_a_regs_b_rows<DC, 4, DC / 8>(acc, af, lane_base_a<DC>(at + S::A, 0, lane));
  }
  __syncthreads();  // every warp is done with the stages: stage 0's x tile stages the rows
  store_rows<DC, !EXACT>(smem, S::A, acc, r0, out + ((i64)bh * L + o0 + r0) * Dp + c0, Dp, lane,
                         orows - r0);
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int D, bool EXACT>
cudaError_t fwd(const void* qu, const void* k, const void* v, const void* bias, void* out,
                float* lse, int BH, int H, int L, float scale, Dropout drop, Strides os,
                cudaStream_t stream) {
  cudaError_t err = set_smem(attn_fwd_mma<D, EXACT>, FwdSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  attn_fwd_mma<D, EXACT><<<dim3(ceil_div(L, 64), BH), NT, FwdSmem<D>::BYTES, stream>>>(
      (const bf16*)qu, (const bf16*)k, (const bf16*)v, (const bf16*)bias, (bf16*)out, lse, H, L,
      scale, drop, os);
  return cudaGetLastError();
}

template <int D, bool EXACT>
cudaError_t bwd(const void* qu, const void* k, const void* v, const void* bias, const void* g,
                const void* out, const float* lse, float* delta, void* dqu, void* dk, void* dv,
                void* dbias, int BH, int H, int L, float scale, Dropout drop, Strides gs,
                Strides os, cudaStream_t stream) {
  cudaError_t err = set_smem(attn_bwd_mma<D, EXACT>, BwdSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  err = set_smem(attn_dqu_mma<D, EXACT>, DquSmem<D, EXACT>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(L, 64), BH);
  attn_delta<D, EXACT><<<ceil_div(BH * L, 256 / (D / 8)), 256, 0, stream>>>(
      (const bf16*)g, (const bf16*)out, delta, H, L, BH * L, gs, os);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_mma<D, EXACT><<<grid, NT, BwdSmem<D>::BYTES, stream>>>(
      (const bf16*)qu, (const bf16*)k, (const bf16*)v, (const bf16*)bias, (const bf16*)g, lse,
      delta, (bf16*)dk, (bf16*)dv, (bf16*)dbias, H, L, scale, drop, gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dqu_mma<D, EXACT><<<grid, NT, DquSmem<D, EXACT>::BYTES, stream>>>(
      (const bf16*)dbias, (const bf16*)k, (bf16*)dqu, L);
  return cudaGetLastError();
}

template <int DC, bool EXACT>
cudaError_t fwd_wide(const void* qu, const void* k, const void* v, const void* bias, void* out,
                     float* lse, float* scores, float* part, int nsplit, int BH, int H, int L,
                     int Dp, float scale, Dropout drop, Strides os, cudaStream_t stream) {
  cudaError_t err = set_smem(attn_fwd_scores_wide<WKC, EXACT>, WideScoresSmem<WKC>::BYTES);
  if (err != cudaSuccess) return err;
  err = set_smem(attn_fwd_pv_wide<DC, EXACT>, WidePvSmem<DC>::BYTES);
  if (err != cudaSuccess) return err;
  const int nt = ceil_div(L, 64);
  attn_fwd_scores_wide<WKC, EXACT><<<dim3(nt, BH, nsplit), NT, WideScoresSmem<WKC>::BYTES,
                                     stream>>>((const bf16*)qu, (const bf16*)k, (const bf16*)bias,
                                               scores, lse, part, L, Dp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_fwd_pv_wide<DC, EXACT><<<dim3(nt * (Dp / DC), BH), NT, WidePvSmem<DC>::BYTES, stream>>>(
      scores, lse, part, nsplit, (const bf16*)v, (bf16*)out, H, L, Dp, drop, os);
  return cudaGetLastError();
}

// blocks of the wide scores pass an SM holds (the occupancy calculator's)
template <bool EXACT>
cudaError_t wide_scores_blocks(int* n) {
  cudaError_t err = set_smem(attn_fwd_scores_wide<WKC, EXACT>, WideScoresSmem<WKC>::BYTES);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, attn_fwd_scores_wide<WKC, EXACT>, NT,
                                                       WideScoresSmem<WKC>::BYTES);
}

template <int DC, bool EXACT, bool TRANS>
cudaError_t prod_wide(const void* a, const void* x, Strides xs, void* out, int BH, int H, int L,
                      int Dp, cudaStream_t stream) {
  typedef WideProdSmem<DC, EXACT> S;
  cudaError_t err = set_smem(attn_prod_wide<DC, EXACT, TRANS>, S::BYTES);
  if (err != cudaSuccess) return err;
  attn_prod_wide<DC, EXACT, TRANS><<<dim3(ceil_div(L, 64) * (Dp / DC), BH), NT, S::BYTES,
                                      stream>>>((const bf16*)a, (const bf16*)x, (bf16*)out, H, L,
                                                Dp, xs);
  return cudaGetLastError();
}

template <int DC, bool EXACT>
cudaError_t bwd_wide(const void* qu, const void* k, const void* v, const void* bias, const void* g,
                     const void* out, const float* lse, float* delta, void* dqu, void* dk,
                     void* dv, void* dbias, void* pd, int BH, int H, int L, int Dp, float scale,
                     Dropout drop, Strides gs, Strides os, cudaStream_t stream) {
  cudaError_t err = set_smem(attn_bwd_ds_wide<WKC, EXACT>, WideDsSmem<WKC>::BYTES);
  if (err != cudaSuccess) return err;
  const int nt = ceil_div(L, 64);
  attn_delta_wide<DC, EXACT><<<ceil_div(BH * L, 256 / (DC / 8)), 256, 0, stream>>>(
      (const bf16*)g, (const bf16*)out, delta, H, L, BH * L, Dp, gs, os);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_ds_wide<WKC, EXACT><<<dim3(nt, nt, BH), NT, WideDsSmem<WKC>::BYTES, stream>>>(
      (const bf16*)qu, (const bf16*)k, (const bf16*)v, (const bf16*)bias, (const bf16*)g, lse,
      delta, (bf16*)dbias, (bf16*)pd, H, L, Dp, scale, drop, gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Strides cs;  // qu and k: contiguous (B, H, L, Dp)
  cs.b = (i64)H * L * Dp;
  cs.h = (i64)L * Dp;
  cs.l = Dp;
  err = prod_wide<DC, EXACT, true>(pd, g, gs, dv, BH, H, L, Dp, stream);
  if (err != cudaSuccess) return err;
  err = prod_wide<DC, EXACT, true>(dbias, qu, cs, dk, BH, H, L, Dp, stream);
  if (err != cudaSuccess) return err;
  return prod_wide<DC, EXACT, false>(dbias, k, cs, dqu, BH, H, L, Dp, stream);
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
// rows are 16-byte aligned (the flagship shapes), the general one elsewhere.
bool exact_tiles(int L, const void* bias) { return L % 64 == 0 && aligned16(bias); }

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

// bf16 only; head_dim in {16, 32, 64, 128, 256}; any L >= 1. out_strides: element
// strides of out over (b, h, l). lse: (B, H, L) float32, written. The H heads
// are h_offset .. h_offset + H of h_total for the dropout index (H, 0 for all).
// Returns cudaGetLastError() after the launch (0 on success).
int attn_mma_fwd(const void* qu, const void* k, const void* v, const void* bias, void* out,
                 void* lse, const long long* out_strides, int B, int H, int L, int head_dim,
                 float scale, float rate, unsigned int seed, unsigned int thresh, float inv_keep,
                 int h_total, int h_offset, void* stream) {
  if (!valid(L, H, h_total, h_offset, qu, k, v)) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
  const Strides os = make_strides(out_strides);
  const bool exact = exact_tiles(L, bias);
#define ATTN_FWD(D, E)                                                                         \
  fwd<D, E>(qu, k, v, bias, out, (float*)lse, B * H, H, L, scale, drop, os, (cudaStream_t)stream)
  switch (head_dim) {
    case 16:
      return (int)(exact ? ATTN_FWD(16, true) : ATTN_FWD(16, false));
    case 32:
      return (int)(exact ? ATTN_FWD(32, true) : ATTN_FWD(32, false));
    case 64:
      return (int)(exact ? ATTN_FWD(64, true) : ATTN_FWD(64, false));
    case 128:
      return (int)(exact ? ATTN_FWD(128, true) : ATTN_FWD(128, false));
    case 256:
      return (int)(exact ? ATTN_FWD(256, true) : ATTN_FWD(256, false));
  }
#undef ATTN_FWD
  return (int)cudaErrorInvalidValue;
}

// head_dim in {16, 32, 64, 128} (256 runs the wide instance's backward).
// g_strides, out_strides: element strides of g and out over (b, h, l).
// lse: the forward's; delta: (B, H, L) float32 scratch, written then read.
// h_total, h_offset as in attn_mma_fwd.
int attn_mma_bwd(const void* qu, const void* k, const void* v, const void* bias, const void* g,
                 const void* out, const void* lse, void* delta, void* dqu, void* dk, void* dv,
                 void* dbias, const long long* g_strides, const long long* out_strides, int B,
                 int H, int L, int head_dim, float scale, float rate, unsigned int seed,
                 unsigned int thresh, float inv_keep, int h_total, int h_offset, void* stream) {
  const bool exact = exact_tiles(L, bias);
  if (!valid(L, H, h_total, h_offset, qu, k, v) || (exact && !aligned16(dbias)))
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
  const Strides gs = make_strides(g_strides), os = make_strides(out_strides);
#define ATTN_BWD(D, E)                                                                        \
  bwd<D, E>(qu, k, v, bias, g, out, (const float*)lse, (float*)delta, dqu, dk, dv, dbias, B * H, \
            H, L, scale, drop, gs, os, (cudaStream_t)stream)
  switch (head_dim) {
    case 16:
      return (int)(exact ? ATTN_BWD(16, true) : ATTN_BWD(16, false));
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

// The wide instance, as attn_mma_fwd, at a padded head dim Dp (a multiple of
// WDC, 256 or more). scores: (B, H, Lp, Lp) float32 scratch, Lp = 64 ceil(L /
// 64), written then read. splits: the scores pass's key splits S, 1 ..
// ceil(L / 64); part: (2, B*H, S, Lp) float32 scratch (unused at S = 1).
int attn_mma_fwd_wide(const void* qu, const void* k, const void* v, const void* bias, void* out,
                      void* lse, void* scores, void* part, const long long* out_strides, int B,
                      int H, int L, int head_dim, int splits, float scale, float rate,
                      unsigned int seed, unsigned int thresh, float inv_keep, int h_total,
                      int h_offset, void* stream) {
  if (!valid(L, H, h_total, h_offset, qu, k, v) || head_dim < 256 || head_dim % WDC != 0 ||
      !aligned16(scores) || splits < 1 || splits > ceil_div(L, 64) || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
  const Strides os = make_strides(out_strides);
#define ATTN_FWD_WIDE(DC, E)                                                                   \
  fwd_wide<DC, E>(qu, k, v, bias, out, (float*)lse, (float*)scores, (float*)part, splits, B * H, \
                  H, L, head_dim, scale, drop, os, (cudaStream_t)stream)
  const bool exact = exact_tiles(L, bias);
  if (head_dim % (2 * WDC) == 0)
    return (int)(exact ? ATTN_FWD_WIDE(2 * WDC, true) : ATTN_FWD_WIDE(2 * WDC, false));
  return (int)(exact ? ATTN_FWD_WIDE(WDC, true) : ATTN_FWD_WIDE(WDC, false));
#undef ATTN_FWD_WIDE
}

// The wide instance, as attn_mma_bwd. pd: (B, H, L, L) bf16 scratch (the
// dropped probabilities), written then read; 16-byte aligned like dbias.
int attn_mma_bwd_wide(const void* qu, const void* k, const void* v, const void* bias,
                      const void* g, const void* out, const void* lse, void* delta, void* dqu,
                      void* dk, void* dv, void* dbias, void* pd, const long long* g_strides,
                      const long long* out_strides, int B, int H, int L, int head_dim,
                      float scale, float rate, unsigned int seed, unsigned int thresh,
                      float inv_keep, int h_total, int h_offset, void* stream) {
  const bool exact = exact_tiles(L, bias);
  if (!valid(L, H, h_total, h_offset, qu, k, v) ||
      (exact && !(aligned16(dbias) && aligned16(pd))) || head_dim < 256 || head_dim % WDC != 0)
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
  const Strides gs = make_strides(g_strides), os = make_strides(out_strides);
#define ATTN_BWD_WIDE(DC, E)                                                                    \
  bwd_wide<DC, E>(qu, k, v, bias, g, out, (const float*)lse, (float*)delta, dqu, dk, dv, dbias,   \
                  pd, B * H, H, L, head_dim, scale, drop, gs, os, (cudaStream_t)stream)
  if (head_dim % (2 * WDC) == 0)
    return (int)(exact ? ATTN_BWD_WIDE(2 * WDC, true) : ATTN_BWD_WIDE(2 * WDC, false));
  return (int)(exact ? ATTN_BWD_WIDE(WDC, true) : ATTN_BWD_WIDE(WDC, false));
#undef ATTN_BWD_WIDE
}

// Dynamic shared memory per block: which = 0 forward, 1 backward main pass,
// 2 backward dqu pass; exact = 1 for the instance of whole tiles (L a
// multiple of 64), 0 for the general one. The wide instance's kernels: which
// = 3 forward scores, 4 forward p v, 5 backward scores, 6 backward products
// (head_dim the padded one, or the column width of 4 / 6).
int attn_mma_smem_bytes(int head_dim, int which, int exact) {
  switch (which) {
    case 3:
      return WideScoresSmem<WKC>::BYTES;
    case 4:
      return head_dim % (2 * WDC) ? WidePvSmem<WDC>::BYTES : WidePvSmem<2 * WDC>::BYTES;
    case 5:
      return WideDsSmem<WKC>::BYTES;
    case 6:
      if (head_dim % (2 * WDC))
        return exact ? WideProdSmem<WDC, true>::BYTES : WideProdSmem<WDC, false>::BYTES;
      return exact ? WideProdSmem<2 * WDC, true>::BYTES : WideProdSmem<2 * WDC, false>::BYTES;
  }
  switch (head_dim) {
    case 16:
      return which == 0 ? FwdSmem<16>::BYTES : which == 1 ? BwdSmem<16>::BYTES
             : exact    ? DquSmem<16, true>::BYTES : DquSmem<16, false>::BYTES;
    case 32:
      return which == 0 ? FwdSmem<32>::BYTES : which == 1 ? BwdSmem<32>::BYTES
             : exact    ? DquSmem<32, true>::BYTES : DquSmem<32, false>::BYTES;
    case 64:
      return which == 0 ? FwdSmem<64>::BYTES : which == 1 ? BwdSmem<64>::BYTES
             : exact    ? DquSmem<64, true>::BYTES : DquSmem<64, false>::BYTES;
    case 128:
      return which == 0 ? FwdSmem<128>::BYTES : which == 1 ? BwdSmem<128>::BYTES
             : exact    ? DquSmem<128, true>::BYTES : DquSmem<128, false>::BYTES;
    case 256:
      return which == 0 ? FwdSmem<256>::BYTES : -1;  // the backward: the wide instance
  }
  return -1;
}

// Blocks an SM holds of the wide forward's scores pass, in its instance for
// whole tiles (exact = 1) or for any L: the wrapper chooses the key splits
// from it. A CUDA error comes back negated.
int attn_mma_fwd_wide_blocks(int exact) {
  int n = 0;
  const cudaError_t err = exact ? wide_scores_blocks<true>(&n) : wide_scores_blocks<false>(&n);
  return err == cudaSuccess ? n : -(int)err;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
