// Fused rel-pos attention for the conformer's MHSA, forward and backward.
//
// Replaces the Pallas TPU kernels of sarssl_tpu/kernels/attention.py:
//   forward  _call_fwd (_fwd_kernel, _attend)  -> attn_fwd_kernel
//   backward _fa_bwd   (_bwd_kernel)           -> attn_bwd_rows_kernel + attn_bwd_cols_kernel
//
//   s = (qu k^T + bias) * scale ; p = softmax(s) ; pd = dropout(p) ; out = pd v
//
// qu, k, v, g, out, dqu, dk, dv are (B, H, L, D) and bias, dbias (B, H, L, L),
// all contiguous, in float32 or bfloat16; every product accumulates in f32.
//
// What bounds it on an H100: at the model's shapes (B=128, H=4, L=256,
// D=128 or 64) the forward reads qu/k/v and the (B,H,L,L) bias and writes
// out: ~200 MB in bf16 at D=128, about 60 us at 3.35 TB/s, against ~17 GFLOP,
// about 17 us at the 989 TFLOP/s bf16 tensor rate. So bytes bound it, and the
// bias is a third of them. The TPU kernel kept a whole 256x256 f32 score tile
// (256 KB) in VMEM per (batch, head); a Hopper block has at most 227 KB of
// shared memory. The design re-cuts the work:
//   * one block per (b, h, tile of RB query rows) keeps that tile's full
//     score rows (RB x L f32, 64 KB at RB=64 and L=256) in shared memory, so
//     the softmax is the exact two-pass one of the reference (max, exp, sum,
//     divide) and scores never reach device memory; k and v stream through
//     shared memory in tiles of BN=64 rows. RB is 64 where the launch's rows
//     fit in a block's shared memory and 32 where they do not (the backward
//     row pass holds two such row sets: at L=512, D=32 it needs 279,552 bytes
//     at RB=64 and 144,000 at RB=32), which carries both passes to every L up
//     to 704 at any head dim; the wrapper checks the launch's own size;
//   * the backward runs as two kernels with no atomics, so results do not
//     depend on block order: a row pass per (b, h, query tile) recomputes p,
//     writes dbias and dqu and the per-row softmax max/sum; a column pass per
//     (b, h, key tile) recomputes p from those stats and sums dk and dv over
//     all query rows inside the block;
//   * attention dropout hashes the flat (b, h, i, j) index of the (B,H,L,L)
//     probability tensor with the counter hash of kernels/dropout.py (murmur3
//     finalizer of index + seed, keep where hash >= thresh), so forward and
//     backward regenerate the same mask and it equals the plain version's; a
//     tensor-parallel shard of heads (h_offset .. h_offset + H of h_total)
//     hashes the index of the whole (B, h_total, L, L) tensor;
// These kernels multiply with scalar f32 FMAs from shared memory, so they run
// well above their bound. fused_attention no longer launches them: every head
// dim up to 128 runs on the tensor cores at any L, bfloat16 in
// attention_mma.cu, float32 in attention_f32_mma.cu (three TF32 products a
// product, which hold the 1e-4 tolerance that one misses). They stay as the
// yardstick those kernels are timed and held against, launched directly.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // query rows per tile of the column pass
constexpr int BN = 64;   // key rows per streamed tile
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one H100 block may use
constexpr int NT = 256;  // threads per block: a 16 x 16 grid of 4 x (D/16) micro-tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: the reference's p.astype(T) before a product
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

struct Dropout {
  uint32_t seed;
  uint32_t thresh;   // keep where hash >= thresh
  float inv_keep;    // 1 / (1 - rate)
  int active;
  int h_local, h_total, h_offset;  // this launch's heads among the whole tensor's
};

// (b, h) of a block's flat bh = b * h_local + h, as the dropout index reads
// it: b * h_total + h_offset + h (bh itself when the launch holds every head)
__device__ __forceinline__ size_t drop_bh(const Dropout& d, size_t bh) {
  return (bh / d.h_local) * d.h_total + d.h_offset + bh % d.h_local;
}

__device__ __forceinline__ bool keep(const Dropout& d, uint32_t flat) {
  uint32_t x = flat + d.seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x >= d.thresh;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0+NR) of a (L, D) matrix -> shared (NR, D+1) f32, zero past L
template <typename T, int D, int NR = 64>
__device__ void load_rows(float* dst, const T* src, int row0, int L) {
  for (int idx = threadIdx.x; idx < NR * D; idx += NT) {
    int r = idx / D, c = idx % D, gr = row0 + r;
    dst[r * (D + 1) + c] = gr < L ? to_f(src[(size_t)gr * D + c]) : 0.f;
  }
}

// acc[r][c] = sum_d A[ty+16r][d] * B[tx+16c][d] over shared tiles with stride
// D+1: A has 16R rows, B 64. Every kernel computes a score through this one
// loop, the same fmaf chain for each element whatever R is, so the forward
// and both backward passes see bit-identical scores.
template <int D, int R>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, float acc[R][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[R], b[4];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = A[(ty + 16 * r) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__device__ __forceinline__ float score(float dot, float bias, float scale) {
  return (dot + bias) * scale;
}

// S[RB][SP] <- scores of query rows row0.. against all keys (-inf past L).
// Qs holds the query tile; KVs is scratch for streamed key tiles.
template <typename T, int D, int RB>
__device__ void score_rows(float* S, int SP, const float* Qs, float* KVs, const T* k,
                           const T* bias, int row0, int L, float scale) {
  constexpr int R = RB / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int j0 = 0; j0 < L; j0 += BN) {
    __syncthreads();
    load_rows<T, D>(KVs, k, j0, L);
    __syncthreads();
    float acc[R][4];
    dot_tile<D, R>(Qs, KVs, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        float s = -INFINITY;
        if (i < L && j < L) s = score(acc[r][c], to_f(bias[(size_t)i * L + j]), scale);
        S[(ty + 16 * r) * SP + j0 + tx + 16 * c] = s;
      }
    }
  }
  __syncthreads();
}

// Row softmax in place, one warp per row: S <- exp(s - m) / l. Writes the
// row max m and sum l to stats[2*i] when stats is given.
template <int RB>
__device__ void softmax_rows(float* S, int SP, int row0, int L, float* stats) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = warp; rr < RB; rr += NT / 32) {
    const int i = row0 + rr;
    if (i >= L) continue;
    float* row = S + rr * SP;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < L; j += 32) {
      float e = expf(row[j] - m);
      row[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < L; j += 32) row[j] = row[j] / l;
    if (stats != nullptr && lane == 0) {
      stats[2 * i] = m;
      stats[2 * i + 1] = l;
    }
  }
  __syncthreads();
}

// out[i][c] = sum_j P[i][j] * M[j][c] for the block's RB rows: P is shared
// (RB, SP) f32, M a (L, D) matrix in device memory streamed through KVs.
template <typename T, int D, int RB>
__device__ void rows_times(const float* P, int SP, float* KVs, const T* M, T* out,
                           int row0, int L) {
  constexpr int CPT = D / 16, R = RB / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float o[R][CPT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[r][c] = 0.f;
  for (int j0 = 0; j0 < L; j0 += BN) {
    __syncthreads();
    load_rows<T, D>(KVs, M, j0, L);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < BN; ++jj) {
      float a[R], b[CPT];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = P[(ty + 16 * r) * SP + j0 + jj];
#pragma unroll
      for (int c = 0; c < CPT; ++c) b[c] = KVs[jj * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) o[r][c] = fmaf(a[r], b[c], o[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + ty + 16 * r;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[(size_t)i * D + tx + 16 * c] = from_f<T>(o[r][c]);
  }
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int score_stride(int L) { return round_up(L, BN) + 1; }

// ---------------------------------------------------------------------------
// forward: grid (ceil(L/RB), B*H), smem S (RB x SP) + Qs (RB rows) + KVs (64 rows)
// ---------------------------------------------------------------------------
template <typename T, int D, int RB>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const T* __restrict__ qu, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ bias, T* __restrict__ out, int L, float scale,
                Dropout drop) {
  extern __shared__ float smem[];
  const int SP = score_stride(L);
  float* S = smem;
  float* Qs = S + RB * SP;
  float* KVs = Qs + RB * (D + 1);
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * RB;
  const size_t off = bh * L * D, offs = bh * L * L, dbh = drop_bh(drop, bh);

  load_rows<T, D, RB>(Qs, qu + off, row0, L);
  score_rows<T, D, RB>(S, SP, Qs, KVs, k + off, bias + offs, row0, L, scale);
  softmax_rows<RB>(S, SP, row0, L, nullptr);
  // dropout, then p.astype(T) as the reference does before the PV product;
  // zero the padding columns and rows the PV loop reads
  const int LP = SP - 1;
  for (int idx = threadIdx.x; idx < RB * LP; idx += NT) {
    const int rr = idx / LP, j = idx % LP, i = row0 + rr;
    float p = 0.f;
    if (i < L && j < L) {
      p = S[rr * SP + j];
      if (drop.active)
        p = keep(drop, (uint32_t)((dbh * L + i) * L + j)) ? p * drop.inv_keep : 0.f;
    }
    S[rr * SP + j] = round_t<T>(p);
  }
  rows_times<T, D, RB>(S, SP, KVs, v + off, out + off, row0, L);
}

// ---------------------------------------------------------------------------
// backward, row pass: grid (ceil(L/RB), B*H), smem S + dP (RB x SP each) + Qs
// (RB rows) + KVs (64 rows)
//   p recomputed; dp = dropout'(g v^T); ds = p * (dp - rowsum(dp * p));
//   dbias = T(ds * scale); dqu = dbias @ k; stats[i] = (row max, row sum)
// ---------------------------------------------------------------------------
template <typename T, int D, int RB>
__global__ void __launch_bounds__(NT)
attn_bwd_rows_kernel(const T* __restrict__ qu, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ bias,
                     const T* __restrict__ g, T* __restrict__ dqu, T* __restrict__ dbias,
                     float* __restrict__ stats, int L, float scale, Dropout drop) {
  constexpr int R = RB / 16;
  extern __shared__ float smem[];
  const int SP = score_stride(L);
  float* S = smem;
  float* dP = S + RB * SP;
  float* Qs = dP + RB * SP;
  float* KVs = Qs + RB * (D + 1);
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * RB;
  const size_t off = bh * L * D, offs = bh * L * L, dbh = drop_bh(drop, bh);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<T, D, RB>(Qs, qu + off, row0, L);
  score_rows<T, D, RB>(S, SP, Qs, KVs, k + off, bias + offs, row0, L, scale);
  softmax_rows<RB>(S, SP, row0, L, stats + 2 * bh * L);

  // dP = g v^T (the g tile replaces the query tile)
  load_rows<T, D, RB>(Qs, g + off, row0, L);
  for (int j0 = 0; j0 < L; j0 += BN) {
    __syncthreads();
    load_rows<T, D>(KVs, v + off, j0, L);
    __syncthreads();
    float acc[R][4];
    dot_tile<D, R>(Qs, KVs, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dP[(ty + 16 * r) * SP + j0 + tx + 16 * c] = acc[r][c];
  }
  __syncthreads();

  // ds per row, one warp per row; dP <- T(ds * scale) as f32, 0 past L
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int LP = SP - 1;
  for (int rr = warp; rr < RB; rr += NT / 32) {
    const int i = row0 + rr;
    float* prow = S + rr * SP;
    float* drow = dP + rr * SP;
    if (i >= L) {
      for (int j = lane; j < LP; j += 32) drow[j] = 0.f;
      continue;
    }
    const size_t flat0 = (dbh * L + i) * L;
    float dot = 0.f;
    for (int j = lane; j < L; j += 32) {
      float dp = drow[j];
      if (drop.active) dp = keep(drop, (uint32_t)(flat0 + j)) ? dp * drop.inv_keep : 0.f;
      drow[j] = dp;
      dot += dp * prow[j];
    }
    dot = warp_sum(dot);
    T* db = dbias + offs + (size_t)i * L;
    for (int j = lane; j < LP; j += 32) {
      if (j < L) {
        const T dsx = from_f<T>(prow[j] * (drow[j] - dot) * scale);
        db[j] = dsx;
        drow[j] = to_f(dsx);
      } else {
        drow[j] = 0.f;
      }
    }
  }
  rows_times<T, D, RB>(dP, SP, KVs, k + off, dqu + off, row0, L);
}

// ---------------------------------------------------------------------------
// backward, column pass: grid (ceil(L/BN), B*H), one block per key tile sums
// over every query tile: dv = T(pd)^T g, dk = dbias^T qu. No atomics.
// smem Ks, Qs, Gs (64 x (D+1) each) + Pt, DBt (64 x 65 each)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_bwd_cols_kernel(const T* __restrict__ qu, const T* __restrict__ k,
                     const T* __restrict__ bias, const T* __restrict__ g,
                     const T* __restrict__ dbias, const float* __restrict__ stats,
                     T* __restrict__ dk, T* __restrict__ dv, int L, float scale,
                     Dropout drop) {
  constexpr int CPT = D / 16;
  constexpr int TP = BN + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Qs = Ks + BN * (D + 1);
  float* Gs = Qs + BM * (D + 1);
  float* Pt = Gs + BM * (D + 1);
  float* DBt = Pt + BM * TP;
  const size_t bh = blockIdx.y;
  const int col0 = blockIdx.x * BN;
  const size_t off = bh * L * D, offs = bh * L * L;
  const float* st = stats + 2 * bh * L;
  const size_t dbh = drop_bh(drop, bh);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float ov[4][CPT], ok[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) ov[r][c] = ok[r][c] = 0.f;

  load_rows<T, D>(Ks, k + off, col0, L);
  for (int i0 = 0; i0 < L; i0 += BM) {
    __syncthreads();
    load_rows<T, D>(Qs, qu + off, i0, L);
    load_rows<T, D>(Gs, g + off, i0, L);
    for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
      const int ii = idx / BN, jj = idx % BN, i = i0 + ii, j = col0 + jj;
      DBt[ii * TP + jj] = (i < L && j < L) ? to_f(dbias[offs + (size_t)i * L + j]) : 0.f;
    }
    __syncthreads();
    float acc[4][4];
    dot_tile<D, 4>(Qs, Ks, acc);  // acc[r][c]: query ty+16r, key tx+16c
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = col0 + tx + 16 * c;
        float pd = 0.f;
        if (i < L && j < L) {
          const float s = score(acc[r][c], to_f(bias[offs + (size_t)i * L + j]), scale);
          pd = expf(s - st[2 * i]) / st[2 * i + 1];
          if (drop.active)
            pd = keep(drop, (uint32_t)((dbh * L + i) * L + j)) ? pd * drop.inv_keep : 0.f;
        }
        Pt[(ty + 16 * r) * TP + tx + 16 * c] = round_t<T>(pd);
      }
    }
    __syncthreads();
    // micro-tile rows are keys ty+16r, columns are head dims tx+16c
#pragma unroll 4
    for (int ii = 0; ii < BM; ++ii) {
      float pk[4], dbk[4], gc[CPT], qc[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pk[r] = Pt[ii * TP + ty + 16 * r];
        dbk[r] = DBt[ii * TP + ty + 16 * r];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        gc[c] = Gs[ii * (D + 1) + tx + 16 * c];
        qc[c] = Qs[ii * (D + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          ov[r][c] = fmaf(pk[r], gc[c], ov[r][c]);
          ok[r][c] = fmaf(dbk[r], qc[c], ok[r][c]);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = col0 + ty + 16 * r;
    if (j >= L) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dv[off + (size_t)j * D + tx + 16 * c] = from_f<T>(ov[r][c]);
      dk[off + (size_t)j * D + tx + 16 * c] = from_f<T>(ok[r][c]);
    }
  }
}

size_t fwd_smem(int L, int D, int rb) {
  return sizeof(float) * (rb * score_stride(L) + (rb + 64) * (D + 1));
}
size_t bwd_rows_smem(int L, int D, int rb) {
  return sizeof(float) * (2 * rb * score_stride(L) + (rb + 64) * (D + 1));
}
size_t bwd_cols_smem(int D) { return sizeof(float) * (3 * 64 * (D + 1) + 2 * BM * (BN + 1)); }

// Row block of a launch (which: 0 forward, 1 backward row pass): 64 where its
// score rows fit in a block's shared memory, else 32.
int row_block(int L, int D, int which) {
  const size_t s64 = which == 0 ? fwd_smem(L, D, 64) : bwd_rows_smem(L, D, 64);
  return s64 <= (size_t)SMEM_LIMIT ? 64 : 32;
}

// Dynamic shared memory of the launch (which: 0 forward, 1 backward: the
// larger of its two kernels), at the row block row_block() picks.
size_t launch_smem(int L, int D, int which) {
  const int rb = row_block(L, D, which);
  if (which == 0) return fwd_smem(L, D, rb);
  const size_t r = bwd_rows_smem(L, D, rb), c = bwd_cols_smem(D);
  return r > c ? r : c;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D, int RB>
cudaError_t fwd_rb(const void* qu, const void* k, const void* v, const void* bias, void* out,
                   int BH, int L, float scale, Dropout drop, cudaStream_t stream) {
  const size_t smem = fwd_smem(L, D, RB);
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidConfiguration;
  cudaError_t err = set_smem(attn_fwd_kernel<T, D, RB>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + RB - 1) / RB, BH);
  attn_fwd_kernel<T, D, RB><<<grid, NT, smem, stream>>>(
      (const T*)qu, (const T*)k, (const T*)v, (const T*)bias, (T*)out, L, scale, drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* qu, const void* k, const void* v, const void* bias, void* out,
                int BH, int L, float scale, Dropout drop, cudaStream_t stream) {
  if (row_block(L, D, 0) == 64)
    return fwd_rb<T, D, 64>(qu, k, v, bias, out, BH, L, scale, drop, stream);
  return fwd_rb<T, D, 32>(qu, k, v, bias, out, BH, L, scale, drop, stream);
}

template <typename T, int D, int RB>
cudaError_t bwd_rb(const void* qu, const void* k, const void* v, const void* bias,
                   const void* g, void* dqu, void* dk, void* dv, void* dbias, float* stats,
                   int BH, int L, float scale, Dropout drop, cudaStream_t stream) {
  const size_t smem_r = bwd_rows_smem(L, D, RB), smem_c = bwd_cols_smem(D);
  if (smem_r > (size_t)SMEM_LIMIT || smem_c > (size_t)SMEM_LIMIT)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = set_smem(attn_bwd_rows_kernel<T, D, RB>, smem_r);
  if (err != cudaSuccess) return err;
  err = set_smem(attn_bwd_cols_kernel<T, D>, smem_c);
  if (err != cudaSuccess) return err;
  dim3 grid_r((L + RB - 1) / RB, BH), grid_c((L + BN - 1) / BN, BH);
  attn_bwd_rows_kernel<T, D, RB><<<grid_r, NT, smem_r, stream>>>(
      (const T*)qu, (const T*)k, (const T*)v, (const T*)bias, (const T*)g, (T*)dqu,
      (T*)dbias, stats, L, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_cols_kernel<T, D><<<grid_c, NT, smem_c, stream>>>(
      (const T*)qu, (const T*)k, (const T*)bias, (const T*)g, (const T*)dbias, stats,
      (T*)dk, (T*)dv, L, scale, drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* qu, const void* k, const void* v, const void* bias, const void* g,
                void* dqu, void* dk, void* dv, void* dbias, float* stats, int BH, int L,
                float scale, Dropout drop, cudaStream_t stream) {
  if (row_block(L, D, 1) == 64)
    return bwd_rb<T, D, 64>(qu, k, v, bias, g, dqu, dk, dv, dbias, stats, BH, L, scale, drop,
                            stream);
  return bwd_rb<T, D, 32>(qu, k, v, bias, g, dqu, dk, dv, dbias, stats, BH, L, scale, drop,
                          stream);
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

}  // namespace

#define DISPATCH(DTYPE, HD, CALL)                                              \
  do {                                                                         \
    if (DTYPE == 0) {                                                          \
      using T = float;                                                         \
      switch (HD) {                                                            \
        case 16: { constexpr int D = 16; return CALL; }                        \
        case 32: { constexpr int D = 32; return CALL; }                        \
        case 64: { constexpr int D = 64; return CALL; }                        \
        case 128: { constexpr int D = 128; return CALL; }                      \
      }                                                                        \
    } else if (DTYPE == 1) {                                                   \
      using T = __nv_bfloat16;                                                 \
      switch (HD) {                                                            \
        case 16: { constexpr int D = 16; return CALL; }                        \
        case 32: { constexpr int D = 32; return CALL; }                        \
        case 64: { constexpr int D = 64; return CALL; }                        \
        case 128: { constexpr int D = 128; return CALL; }                      \
      }                                                                        \
    }                                                                          \
    return cudaErrorInvalidValue;                                              \
  } while (0)

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim in {16, 32, 64, 128}. The H heads
// are h_offset .. h_offset + H of h_total for the dropout index (H, 0 for all).
// Returns cudaGetLastError() after the launches (0 on success).
int attn_fwd(int dtype, const void* qu, const void* k, const void* v, const void* bias,
             void* out, int B, int H, int L, int head_dim, float scale, float rate,
             unsigned int seed, unsigned int thresh, float inv_keep, int h_total, int h_offset,
             void* stream) {
  if (h_offset < 0 || h_offset + H > h_total) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
  DISPATCH(dtype, head_dim,
           (int)(fwd<T, D>(qu, k, v, bias, out, B * H, L, scale, drop, (cudaStream_t)stream)));
}

// stats: float32 scratch of 2*B*H*L values (row max and sum), written then read.
// h_total, h_offset as in attn_fwd.
int attn_bwd(int dtype, const void* qu, const void* k, const void* v, const void* bias,
             const void* g, void* dqu, void* dk, void* dv, void* dbias, void* stats, int B,
             int H, int L, int head_dim, float scale, float rate, unsigned int seed,
             unsigned int thresh, float inv_keep, int h_total, int h_offset, void* stream) {
  if (h_offset < 0 || h_offset + H > h_total) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(rate, seed, thresh, inv_keep, H, h_total, h_offset);
  DISPATCH(dtype, head_dim,
           (int)(bwd<T, D>(qu, k, v, bias, g, dqu, dk, dv, dbias, (float*)stats, B * H, L,
                           scale, drop, (cudaStream_t)stream)));
}

// Dynamic shared memory a block of attn_fwd (which = 0) or attn_bwd (which = 1)
// needs at (L, head_dim); the launch refuses more than a block has.
int attn_smem_bytes(int L, int head_dim, int which) {
  return (int)launch_smem(L, head_dim, which);
}

// Query rows a block of the forward (which = 0) or the backward row pass
// (which = 1) takes at (L, head_dim): 64, or 32 where 64 do not fit.
int attn_row_block(int L, int head_dim, int which) { return row_block(L, head_dim, which); }

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
