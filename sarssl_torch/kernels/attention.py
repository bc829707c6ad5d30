"""Fused rel-pos attention: the CUDA kernels, their plain PyTorch version and
the ``autograd.Function`` that joins them.

Replaces ``sarssl_tpu/kernels/attention.py::fused_attention`` (forward
``_call_fwd``, backward ``_fa_bwd``):

    out = dropout(softmax((qu @ k^T + bias) * scale)) @ v

``qu = q + u_bias`` and ``bias`` (the relative-shifted ``(q + v_bias) P^T``)
are built outside the kernel, so their own gradients flow through autograd.
Attention dropout hashes the flat ``(b, h, i, j)`` index of the probability
tensor with ``kernels/dropout.py``'s counter hash, so the plain version is
exactly the JAX unfused path (``models/conformer.py:110-119``: softmax, then
``fused_dropout``, then PV) and the kernel's mask equals it bit for bit. A
tensor-parallel rank holds heads ``head_offset .. head_offset + H`` of
``heads_total``: it hashes the index its probabilities have in the whole
``(B, heads_total, L, L)`` tensor, ``((b * heads_total + head_offset + h) * L
+ i) * L + j``, so its mask is the head slice of the unsharded one.

Two sets of kernels, chosen by dtype (:func:`attention_route`), each with
instances at head dims 16, 32, 64 and 128 (the bf16 forward also at 256) and
a wide instance at every head dim past 128, at any sequence length;
:func:`attention_instance` names the instance each pass runs:

* ``"tc"``, ``csrc/attention_mma.cu``: bfloat16. Tensor cores (``mma.sync``),
  ``cp.async`` pipelines; the forward also returns the rows' log-sum-exp,
  which the ``autograd.Function`` saves with ``out`` for the backward. Each
  kernel has an instance for whole 64-row tiles (L a multiple of 64: the
  flagship's shapes) and one that masks the last tile and reads the bias rows
  at any alignment (the CLS token's L = 257 takes it; ``single_ch_each_patch``'s
  L = 512 at D = 32 the first).
* ``"tf32x3"``, ``csrc/attention_f32_mma.cu``: float32, with the same
  structure, on the tensor cores as three TF32 products per product (each
  operand split into a TF32 high and low part), which hold the float32
  tolerance of 1e-4 that one TF32 product misses.

The wide instance (``attn_*_wide`` in both sources) takes its head dim as
a runtime argument, any multiple of :data:`WIDE_CHUNK` (64) and, with its
column tail (``attn_*_wide_cols``, the same code with the last chunk's
columns past D zero), any other D: it streams qu, k, g and v through shared
memory in column chunks, so neither its tiles nor its registers depend on
D. Its forward writes the scaled scores of every (query, key) once to an f32
scratch (with the rows' log-sum-exp), then takes out = p v in blocks of DC
output columns; its
backward writes dbias and the dropped probabilities pd once, then takes dv =
pd^T g, dk = dbias^T qu and dqu = dbias k in blocks of DC output columns
(128 where Dp is a multiple of 128, else 64). Where ceil(L/64) * B * H blocks
do not fill the card, the forward's scores pass splits each query tile's key
tiles over S blocks (:func:`wide_key_splits`), each writing its rows' partial
max and sum, which the p v pass merges into the log-sum-exp
(:func:`attention_split_plain` is the same algorithm on plain tensors).
At D = 256 the bf16 forward runs its D = 256 instance and the other three
passes the wide one, the faster in each (PERF.md §5).

Every head dim that is no instance's (the JAX kernel takes any) runs as
:func:`attention_pass_head_dim` says, pass by pass. Past 128 the wide
instance takes it as it is: its last column chunk is read with zeros past D
(the column tail, as the last row tile is read with zeros past L) and
stored only up to D, so qu, k, v and g are read and out, dqu, dk and dv
written at their own head dim, in pieces of the rows' alignment (16, 8 or 4
bytes); at 129-255 the bf16 forward so too, which beat its D = 256 instance
on padded inputs at batch 8 and 128 (PERF.md §5). An odd bf16 D (rows of no
whole 4-byte pieces) takes the padding below; there, and at every D up to
128 that is no instance's, the pass runs the next instance up
(:func:`padded_head_dim`: the next of 16 .. 256, past 256 the next multiple
of 64 on the wide instance): qu, k, v and, in the backward, g are
zero-padded on their last dim, and out, dqu, dk and dv sliced back
(:func:`attention_fwd_padded`, :func:`attention_bwd_padded`). Zero columns add
exactly 0 to qu k^T and give exactly 0 in the padded columns of every product,
so either way this is the same function, and the wide instance's results at
D are the padded ones bit for bit; the bias, the scale and the dropout index
(b, h, i, j) do not depend on D. The two passes pad at the same head dims,
so the forward saves for the backward the padded tensors where they pad,
else qu, k, v and out at D.

``csrc/attention.cu`` holds the first design, scalar f32 FMAs with whole score
rows in shared memory (:func:`fma_row_block`: 64 query rows a block, 32 where
64 do not fit, so L up to 704), at head dims 16, 32, 64 and 128 in either
dtype (:data:`FMA_HEAD_DIMS`; no D = 256 instance). ``fused_attention`` never
launches it: :func:`launch_attention_fwd_fma` and
:func:`launch_attention_bwd_fma` are called directly, as the yardstick the
tensor-core kernels are timed against.

Every shape the Pallas kernel takes runs (its grid is (B, H), any B and H;
it hashes no index at rate 0). A grid's y and z dimensions hold at most
65535 blocks, and B * H is one of them, so the wrapper covers the (b, h)
pairs in launches of at most that many (:func:`attention_chunks`: whole
batches of all heads, or where H alone passes it, one batch's heads in
runs), each with its pointers offset on the host. The kernels need nothing
else: a run of batches from ``b0`` on hashes the index its probabilities
have in the whole tensor when its seed is ``seed + b0 * heads_total * L * L``
(mod 2**32, :func:`_chunk_drop`; the hash reads ``index + seed``), and a run
of heads from ``h0`` is the index map of a tensor-parallel rank's heads,
``head_offset + h0``. Offsets into the (B, H, L, L) bias, dbias and pd, and
into the wide forward's score scratch, are 64-bit in the kernels; in-tile
offsets stay 32-bit. At a dropout rate above 0 the flat (b, h, i, j) index
of (B, heads_total, L, L) must fit in uint32, as the JAX unfused path's
hash takes it from a uint32 iota (``sarssl_tpu/kernels/dropout.py:117``),
whose mask the kernels reproduce: :func:`attention_refusal` says so.

For a CUDA tensor the wrapper launches the set it names here or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import GRID_YZ, check_cuda_status, launches, load_library
from .dropout import dropout_plain, keep_threshold

HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims up to 256 that others pad to
WIDE_CHUNK = 64  # the wide instance's head dims: the multiples of this from 256 on (WDC in csrc)
# the head-dim instances of each set's forward and backward; every other
# padded head dim runs the set's wide instance (at 256 the faster of the two
# in each pass, PERF.md §5)
INSTANCE_HEAD_DIMS = {("tc", "fwd"): (16, 32, 64, 128, 256), ("tc", "bwd"): (16, 32, 64, 128),
                      ("tf32x3", "fwd"): (16, 32, 64, 128), ("tf32x3", "bwd"): (16, 32, 64, 128)}
FMA_HEAD_DIMS = (16, 32, 64, 128)  # the FMA kernels' instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # dynamic shared memory one H100 block may use
# (b, h, i) rows a launch: the delta kernels index them with int (well under 2**31)
_ROWS_MAX = 2 ** 30

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32


def _heads(H: int, heads_total, head_offset: int):
    """``(heads_total, head_offset)`` of a launch over H heads (None: H)."""
    heads_total = H if heads_total is None else heads_total
    if not 0 <= head_offset <= heads_total - H:
        raise ValueError(f"heads {head_offset}..{head_offset + H} do not lie in "
                         f"{heads_total} heads")
    return heads_total, head_offset


def attention_chunks(B: int, H: int, L: int) -> list:
    """The launches that cover the B * H (batch, head) pairs of a (B, H, L, D)
    attention, as ``(b0, nb, h0, nh)``: batches ``b0 .. b0 + nb``, heads ``h0
    .. h0 + nh``. Each holds at most :data:`GRID_YZ` pairs and, so that the
    delta kernels' int row index holds, at most ``_ROWS_MAX`` rows of L:
    whole batches of every head where H fits, else one batch's heads in runs.
    One launch, ``(0, B, 0, H)``, wherever B * H fits (every model path)."""
    most = max(1, min(GRID_YZ, _ROWS_MAX // max(L, 1)))
    if H <= most:
        per = most // H
        return [(b0, min(per, B - b0), 0, H) for b0 in range(0, B, per)]
    return [(b, 1, h0, min(most, H - h0)) for b in range(B) for h0 in range(0, H, most)]


def attention_refusal(B: int, heads_total: int, L: int, rate: float):
    """Why the kernels refuse a (B, heads_total, L, L) attention at this
    dropout rate, or None where they take it: at a rate above 0 the flat (b,
    h, i, j) index must fit in uint32 (module note); at rate 0 nothing is
    hashed and every shape runs."""
    if rate > 0 and B * heads_total * L * L >= 2 ** 32:
        return (f"at dropout rate {rate} the flat (b, h, i, j) index of (B, heads_total, L, L) "
                f"= {(B, heads_total, L, L)} must fit in uint32: the mask reproduces JAX's "
                f"hash over a uint32 iota (sarssl_tpu/kernels/dropout.py:117); rate 0 takes "
                f"any shape")
    return None


def attention_plain(qu, k, v, bias, seed: int, scale: float, rate: float,
                    heads_total=None, head_offset: int = 0):
    """Plain version: f32 scores and softmax, ``p.astype(T)``, hash dropout on
    p (at the heads' place in ``heads_total``), f32-accumulated PV, output in
    ``qu``'s dtype."""
    B, H, L, _ = qu.shape
    heads_total, head_offset = _heads(H, heads_total, head_offset)
    s = (torch.matmul(qu.float(), k.float().transpose(-1, -2)) + bias.float()) * scale
    p = torch.softmax(s, dim=-1).to(qu.dtype)
    p = dropout_plain(p, seed, rate, (H * L * L, heads_total * L * L, head_offset * L * L))
    return torch.matmul(p.float(), v.float()).to(qu.dtype)


_LOG2E = 1.4426950408889634


def attention_split_plain(qu, k, v, bias, seed: int, scale: float, rate: float, splits: int,
                          heads_total=None, head_offset: int = 0):
    """The wide forward with its keys split ``splits`` ways, as plain tensor
    operations (no path on the card calls it): the scaled scores in log2
    units, keys past L at -inf, by tiles of 64 keys; split z of S takes the
    tiles from z * ceil(nt / S) on, ceil(nt / S) of them or the rest (none
    past the last tile: such a split's partial is (-inf, 0)), and folds its
    tiles' max and sum into a running (m_z, l_z); the merge lse2 = m + log2
    sum_z l_z 2^(m_z - m), m = max_z m_z; then p = 2^(s - lse2) rounded to
    the inputs' dtype, hash dropout, f32-accumulated p v. Returns ``(out,
    lse)``, lse in natural units as the kernels write it."""
    B, H, L, _ = qu.shape
    heads_total, head_offset = _heads(H, heads_total, head_offset)
    nt = -(-L // 64)
    s2 = (torch.matmul(qu.float(), k.float().transpose(-1, -2)) + bias.float()) * scale * _LOG2E
    s2 = torch.nn.functional.pad(s2, (0, 64 * nt - L), value=-torch.inf)
    tiles = s2.unflatten(-1, (nt, 64))
    tile_m = tiles.amax(-1)                                           # (B, H, L, nt)
    tile_l = torch.exp2(tiles - tile_m[..., None]).sum(-1)
    per = -(-nt // splits)
    parts_m, parts_l = [], []
    for z in range(splits):
        m = torch.full_like(tile_m[..., 0], -torch.inf)
        l = torch.zeros_like(m)
        for t in range(z * per, min((z + 1) * per, nt)):              # the running max and sum
            mn = torch.maximum(m, tile_m[..., t])
            l = l * torch.exp2(m - mn) + tile_l[..., t] * torch.exp2(tile_m[..., t] - mn)
            m = mn
        parts_m.append(m)
        parts_l.append(l)
    part_m, part_l = torch.stack(parts_m), torch.stack(parts_l)       # (S, B, H, L)
    m = part_m.amax(0)
    lse2 = m + torch.log2((part_l * torch.exp2(part_m - m)).sum(0))
    p = torch.exp2(s2[..., :L] - lse2[..., None]).to(qu.dtype)
    p = dropout_plain(p, seed, rate, (H * L * L, heads_total * L * L, head_offset * L * L))
    return torch.matmul(p.float(), v.float()).to(qu.dtype), lse2 / _LOG2E


def attention_wide_plain(qu, k, v, bias, g, seed: int, scale: float, rate: float,
                         heads_total=None, head_offset: int = 0):
    """The wide instance's passes at an unpadded head dim D, as plain tensor
    operations (no path on the card calls it): qu, k, v and g in column
    chunks of :data:`WIDE_CHUNK`, the last one read with zeros past D (the
    column tail); the scores qu k^T and dp = g v^T summed chunk by chunk in
    f32; p = softmax((s + bias) * scale) rounded to the inputs' dtype, hash
    dropout; out = p v, dv = pd^T g, dk = ds^T qu and dqu = ds k by blocks of
    the chunk's columns, each cut back to D; delta = rowsum(g out). Returns
    ``(out, lse, dqu, dk, dv, dbias)``, out and the gradients in qu's dtype,
    lse in natural units."""
    B, H, L, D = qu.shape
    heads_total, head_offset = _heads(H, heads_total, head_offset)
    nc = -(-D // WIDE_CHUNK)

    def chunks(t):  # (B, H, L, nc, 64) f32, zeros past D
        return torch.nn.functional.pad(t.float(), (0, nc * WIDE_CHUNK - D)).unflatten(
            -1, (nc, WIDE_CHUNK))

    def by_chunk(a, x):  # a (.., L, L) times x's chunks, then cut back to D
        return torch.cat([a @ x[..., c, :] for c in range(nc)], -1)[..., :D]

    qc, kc, vc, gc = (chunks(t) for t in (qu, k, v, g))
    s = sum(qc[..., c, :] @ kc[..., c, :].transpose(-1, -2) for c in range(nc))
    dp = sum(gc[..., c, :] @ vc[..., c, :].transpose(-1, -2) for c in range(nc))
    z = (s + bias.float()) * scale
    lse = torch.logsumexp(z, -1)
    p = torch.exp(z - lse[..., None]).to(qu.dtype)
    drop_map = (H * L * L, heads_total * L * L, head_offset * L * L)
    pd = dropout_plain(p, seed, rate, drop_map).float()
    out = by_chunk(pd, vc).to(qu.dtype)
    delta = (g.float() * out.float()).sum(-1)
    kept = dropout_plain(torch.ones_like(p), seed, rate, drop_map).float()  # 1/(1-rate) or 0
    ds = p.float() * (dp * kept - delta[..., None]) * scale
    dv = by_chunk(pd.transpose(-1, -2), gc)
    dk = by_chunk(ds.to(qu.dtype).float().transpose(-1, -2), qc)
    dqu = by_chunk(ds.to(qu.dtype).float(), kc)
    return (out, lse, dqu.to(qu.dtype), dk.to(qu.dtype), dv.to(qu.dtype),
            ds.to(bias.dtype))


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("attention")
    lib.attn_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _U, _U,
                             _F, _I, _I, _P]
    lib.attn_fwd.restype = _I
    lib.attn_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_bwd.restype = _I
    lib.attn_smem_bytes.argtypes = [_I, _I, _I]
    lib.attn_smem_bytes.restype = _I
    lib.attn_row_block.argtypes = [_I, _I, _I]
    lib.attn_row_block.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


_FMA_PASSES = {"fwd": 0, "bwd": 1}


def fma_smem_bytes(kind: str, L: int, D: int) -> int:
    """Dynamic shared memory a block of the FMA forward (``kind="fwd"``) or
    backward (``"bwd"``, the larger of its two kernels) takes at (L, D)."""
    return _library().attn_smem_bytes(L, D, _FMA_PASSES[kind])


def fma_row_block(kind: str, L: int, D: int) -> int:
    """Query rows a block of the FMA forward or backward row pass takes at
    (L, D): 64, or 32 where 64 rows of scores do not fit."""
    return _library().attn_row_block(L, D, _FMA_PASSES[kind])


def _check_fma_smem(kind: str, L: int, D: int) -> None:
    need = fma_smem_bytes(kind, L, D)
    if need > _SMEM_LIMIT:
        raise ValueError(f"the FMA attention {kind} at L={L}, D={D} needs {need} bytes "
                         f"of shared memory, more than a block has ({_SMEM_LIMIT})")


@functools.lru_cache(maxsize=None)
def _library_mma():
    lib = load_library("attention_mma")
    lib.attn_mma_fwd.argtypes = [_P] * 7 + [_I] * 4 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_mma_fwd.restype = _I
    lib.attn_mma_bwd.argtypes = [_P] * 14 + [_I] * 4 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_mma_bwd.restype = _I
    lib.attn_mma_fwd_wide.argtypes = [_P] * 9 + [_I] * 5 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_mma_fwd_wide.restype = _I
    lib.attn_mma_fwd_wide_blocks.argtypes = [_I]
    lib.attn_mma_fwd_wide_blocks.restype = _I
    lib.attn_mma_bwd_wide.argtypes = [_P] * 15 + [_I] * 4 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_mma_bwd_wide.restype = _I
    lib.attn_mma_smem_bytes.argtypes = [_I, _I, _I]
    lib.attn_mma_smem_bytes.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


# the wide instance's kernels, as the C entries' shared-memory query numbers them
_WIDE_SMEM = {"fwd_scores": 3, "fwd_pv": 4, "bwd_ds": 5, "prod": 6, "delta": None}


def mma_smem_bytes(kernel: str, D: int, exact: bool = True) -> int:
    """Dynamic shared memory a block of a tensor-core kernel takes, in its
    instance for whole tiles (``exact``) or for any L (the wide instance's
    kernels, ``attn_*_wide``, at every D)."""
    which = ({"attn_fwd_mma": 0, "attn_bwd_mma": 1, "attn_dqu_mma": 2, "attn_delta": None}
             | {f"attn_{k}_wide": w for k, w in _WIDE_SMEM.items()})[kernel]
    return 0 if which is None else _library_mma().attn_mma_smem_bytes(D, which, int(exact))


# Past this L the f32 route takes the kernels' instances that sum each tile's
# products apart from the running sums over L (csrc/attention_f32_mma_psum.cu):
# the tensor core's adder cuts its sums toward zero, so a sum held in its
# accumulator drifts with L (5.2e-4 from float64 at L = 65600, PERF.md §5).
# They cost up to 8% (PERF.md §5), and up to this L the drift stays below
# L = 4096's 4.3e-5.
F32_PSUM_MIN_L = 1024


@functools.lru_cache(maxsize=None)
def _library_tf32(psum: bool = False):
    lib = load_library("attention_f32_mma_psum" if psum else "attention_f32_mma")
    lib.attn_tf32_fwd.argtypes = [_P] * 7 + [_I] * 4 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_tf32_fwd.restype = _I
    lib.attn_tf32_bwd.argtypes = [_P] * 14 + [_I] * 4 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_tf32_bwd.restype = _I
    lib.attn_tf32_fwd_wide.argtypes = [_P] * 9 + [_I] * 5 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_tf32_fwd_wide.restype = _I
    lib.attn_tf32_fwd_wide_blocks.argtypes = [_I]
    lib.attn_tf32_fwd_wide_blocks.restype = _I
    lib.attn_tf32_bwd_wide.argtypes = [_P] * 15 + [_I] * 4 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_tf32_bwd_wide.restype = _I
    lib.attn_tf32_smem_bytes.argtypes = [_I, _I]
    lib.attn_tf32_smem_bytes.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def tf32_smem_bytes(kernel: str, D: int) -> int:
    """Dynamic shared memory a block of a 3xTF32 kernel takes (either
    instance; the wide instance's kernels at every D)."""
    which = ({"attn_fwd_tf32": 0, "attn_bwd_tf32": 1, "attn_dqu_tf32": 2,
              "attn_delta_f32": None, "attn_delta_wide_f32": None}
             | {f"attn_{k}_wide_tf32": w for k, w in _WIDE_SMEM.items() if w})[kernel]
    return 0 if which is None else _library_tf32().attn_tf32_smem_bytes(D, which)


def attention_route(dtype: torch.dtype, L: int, D: int) -> str:
    """The set of kernels ``fused_attention`` runs for CUDA tensors of this
    dtype, sequence length and head dim (module note): ``"tc"``
    (``attention_mma.cu``, bfloat16) or ``"tf32x3"`` (``attention_f32_mma.cu``,
    float32), at every head dim D >= 1 (those that are no instance's through
    the padding, from 256 on the wide instance) and every L."""
    padded_head_dim(D)
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


def attention_instance(dtype: torch.dtype, kind: str, Dp: int) -> str:
    """The instance that pass ``kind`` (``"fwd"`` or ``"bwd"``) of the set
    for ``dtype`` runs at the padded head dim ``Dp`` (:func:`padded_head_dim`):
    ``f"d{Dp}"``, the instance at that head dim, or ``"wide"``. At 256 the
    bf16 forward keeps its instance and the bf16 backward and both f32 passes
    take the wide one (module note). :func:`attention_instance_at` names the
    instance at the head dim a pass launches at, padded or not."""
    if padded_head_dim(Dp) != Dp:
        raise ValueError(f"{Dp} is no padded head dim (padded_head_dim gives "
                         f"{padded_head_dim(Dp)})")
    return attention_instance_at(dtype, kind, Dp)


def attention_instance_at(dtype: torch.dtype, kind: str, D: int) -> str:
    """The instance pass ``kind`` runs at head dim D as it launches
    (:func:`attention_pass_head_dim`): ``f"d{D}"`` where D is an instance's,
    else ``"wide"``."""
    dims = INSTANCE_HEAD_DIMS[(attention_route(dtype, 1, D), kind)]
    return f"d{D}" if D in dims else "wide"


def wide_key_splits(L: int, bh: int, sms: int, blocks_per_sm: int) -> int:
    """Key splits S of the wide forward's scores pass at sequence length L
    over ``bh`` = B * H (batch, head) pairs, on a card of ``sms`` SMs that
    each hold ``blocks_per_sm`` of its blocks: 1 where the nt * bh blocks of
    one split (nt = ceil(L/64) query tiles) fill those slots, else the fewest
    splits whose nt * bh * S blocks fill them, at most nt, and then as few as
    give each split the same ceil(nt / S) key tiles (4 tiles: 1, 2 or 4)."""
    nt = -(-L // 64)
    slots = sms * blocks_per_sm
    if nt * bh >= slots:
        return 1
    per = -(-nt // min(nt, -(-slots // (nt * bh))))  # key tiles a split
    return -(-nt // per)


def padded_head_dim(D: int) -> int:
    """The head dim of the instance that runs D on zero-padded inputs where a
    pass pads (:func:`attention_pass_head_dim`): the smallest of
    ``HEAD_DIMS`` at or above it, past 256 the next multiple of
    :data:`WIDE_CHUNK` (the wide instance)."""
    if D < 1:
        raise ValueError(f"fused attention takes head dims of 1 or more, got {D}")
    for Dp in HEAD_DIMS:
        if D <= Dp:
            return Dp
    return -(-D // WIDE_CHUNK) * WIDE_CHUNK


def attention_pass_head_dim(dtype: torch.dtype, kind: str, D: int) -> int:
    """The head dim pass ``kind`` (``"fwd"`` or ``"bwd"``) of the set for
    ``dtype`` launches at for inputs of head dim D: D itself where an
    instance takes it, and past 128 on the wide instance (its column tail
    reads the last chunk's columns past D as zeros; the bf16 forward at
    129-255 too, faster there than its D = 256 instance on padded inputs,
    PERF.md §5), but for an odd bf16 D (its rows are no whole 4-byte
    pieces); else :func:`padded_head_dim` (D), on inputs zero-padded to
    it."""
    route = attention_route(dtype, 1, D)
    if D in INSTANCE_HEAD_DIMS[(route, kind)]:
        return D
    if D <= HEAD_DIMS[-2] or (route == "tc" and D % 2):
        return padded_head_dim(D)
    return D


def _pad_last(t, Dp: int):
    D = t.shape[-1]
    return t if D == Dp else torch.nn.functional.pad(t, (0, Dp - D))


def attention_fwd_padded(launch, qu, k, v, bias, *args):
    """``launch`` (a forward launcher, ``(qu, k, v, bias, *args) -> (out,
    lse)``) at ``padded_head_dim(D)``: qu, k, v zero-padded on their last dim
    (untouched where D is an instance's), bias and ``args`` (seed, scale, ...)
    as they are. Returns ``(out, lse, padded)``: ``out`` sliced back to D,
    ``padded`` the launch's (qu, k, v, out) for :func:`attention_bwd_padded`.
    ``fused_attention`` takes it where :func:`attention_pass_head_dim` pads
    (D up to 128 off an instance, an odd bf16 D past 128); past 128 the other
    head dims run the wide instance at D."""
    Dp = padded_head_dim(qu.shape[-1])
    qu_p, k_p, v_p = (_pad_last(t, Dp) for t in (qu, k, v))
    out_p, lse = launch(qu_p, k_p, v_p, bias, *args)
    out = out_p if Dp == qu.shape[-1] else out_p[..., :qu.shape[-1]]
    return out, lse, (qu_p, k_p, v_p, out_p)


def attention_bwd_padded(launch, padded, bias, g, lse, *args):
    """``launch`` (a backward launcher, ``(qu, k, v, bias, g, out, lse, *args)
    -> (dqu, dk, dv, dbias)``) on :func:`attention_fwd_padded`'s ``padded``
    tensors, with g zero-padded alike; dqu, dk and dv sliced back to g's D."""
    qu_p, k_p, v_p, out_p = padded
    D, Dp = g.shape[-1], qu_p.shape[-1]
    dqu, dk, dv, dbias = launch(qu_p, k_p, v_p, bias, _pad_last(g, Dp), out_p, lse, *args)
    if Dp != D:
        dqu, dk, dv = (t[..., :D] for t in (dqu, dk, dv))
    return dqu, dk, dv, dbias


def _check(qu, k, v, bias, heads_total=None, rate=0.0):
    """Shapes first (on any device: the refusals are a shape's), then the
    devices, dtypes and layout the kernels take."""
    if qu.ndim != 4 or k.shape != qu.shape or v.shape != qu.shape:
        raise ValueError("qu, k, v must be (B, H, L, D) of one shape")
    B, H, L, D = qu.shape
    if bias.shape != (B, H, L, L):
        raise ValueError(f"bias must be {(B, H, L, L)}, got {tuple(bias.shape)}")
    padded_head_dim(D)
    heads_total, _ = _heads(H, heads_total, 0)
    refusal = attention_refusal(B, heads_total, L, rate)
    if refusal:
        raise ValueError(refusal)
    ts = (qu, k, v, bias)
    if not all(t.is_cuda and t.device == qu.device for t in ts):
        raise ValueError("fused attention takes CUDA tensors on one device")
    if qu.dtype not in _DTYPES or any(t.dtype != qu.dtype for t in ts):
        raise ValueError(f"fused attention takes float32 or bfloat16 tensors of one "
                         f"dtype, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused attention takes contiguous tensors")


def _check_fma_grid(qu, heads_total) -> None:
    """The FMA kernels' own limits: one launch over B * H (a grid dimension)
    and 32-bit indices of (B, heads_total, L, L) at every rate."""
    B, H, L, _ = qu.shape
    heads_total, _ = _heads(H, heads_total, 0)
    if B * H > GRID_YZ:
        raise ValueError(f"the FMA attention kernels take B * H up to {GRID_YZ}, got {B * H}")
    if B * heads_total * L * L >= 2 ** 32:
        raise ValueError("the FMA attention kernels index (B, heads_total, L, L) in uint32")


def _check_instance(D: int, what: str, dims, wide=False, dtype=None) -> None:
    if wide:
        if D <= HEAD_DIMS[-2] or (dtype == torch.bfloat16 and D % 2):
            raise ValueError(f"the {what} kernels' wide instance takes the head dims past "
                             f"{HEAD_DIMS[-2]} (bfloat16: the even ones), got {D} "
                             f"(fused_attention pads other head dims)")
    elif D not in dims:
        raise ValueError(f"the {what} kernels have instances at head dims {dims}, got "
                         f"{D} (fused_attention pads other head dims)")


def _check_like_qu(t, qu, name):
    if t.shape != qu.shape or t.dtype != qu.dtype or t.device != qu.device:
        raise ValueError(f"{name} must be a tensor like qu")


def _drop_args(seed, rate, H, heads_total, head_offset):
    """(rate, seed, threshold, 1/(1-rate), heads_total, head_offset); the
    kernel scales the f32 probabilities before rounding them to the input
    type."""
    heads_total, head_offset = _heads(H, heads_total, head_offset)
    if rate == 0.0:
        return 0.0, 0, 0, 1.0, heads_total, head_offset
    return float(rate), seed, keep_threshold(rate), 1.0 / (1.0 - rate), heads_total, head_offset


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _at(t, elems: int) -> int:
    """The address of element ``elems`` (flat, in t's storage order) of t."""
    return t.data_ptr() + elems * t.element_size()


def _chunk_drop(drop, b0: int, h0: int, L: int):
    """:func:`_drop_args` of the launch over batches ``b0 ..`` and heads
    ``h0 ..`` (module note): the heads placed ``h0`` further in
    ``heads_total``, and the seed shifted past the batches before it, whose
    indices the hash's ``index + seed`` (mod 2**32) no longer counts."""
    rate, seed, thresh, inv_keep, heads_total, head_offset = drop
    return (rate, (seed + b0 * heads_total * L * L) % 2 ** 32, thresh, inv_keep, heads_total,
            head_offset + h0)


def _rows_addressable(t, align: int = 16) -> bool:
    """Whether the tensor-core kernels can address a (B, H, L, D) tensor's
    rows through its strides: contiguous rows, ``align``-byte aligned (16;
    4 for the wide instance's column tail, which reads and writes the rows
    in pieces of their alignment)."""
    return (t.stride(3) == 1 and t.data_ptr() % align == 0
            and not any(s * t.element_size() % align for s in t.stride()[:3]))


def _row_strides(t, align: int = 16):
    """Element strides over (b, h, l), as the C entries take them."""
    if not _rows_addressable(t, align):
        raise ValueError(f"rows must be contiguous and {align}-byte aligned")
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def _row_align(wide: bool, D: int) -> int:
    """The alignment a launch needs of its rows: 4 bytes on the wide
    instance at a head dim no multiple of its chunk (the column tail), else
    16."""
    return 4 if wide and D % WIDE_CHUNK else 16


# ---------------------------------------------------------------------------
# scalar-FMA kernels (csrc/attention.cu)
# ---------------------------------------------------------------------------
def launch_attention_fwd_fma(qu, k, v, bias, seed: int, scale: float, rate: float,
                             heads_total=None, head_offset: int = 0):
    _check(qu, k, v, bias, heads_total, rate)
    _check_fma_grid(qu, heads_total)
    lib = _library()
    B, H, L, D = qu.shape
    _check_instance(D, "FMA", FMA_HEAD_DIMS)
    _check_fma_smem("fwd", L, D)
    out = torch.empty_like(qu)
    code = lib.attn_fwd(_DTYPES[qu.dtype], qu.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), B, H, L, D, scale,
                        *_drop_args(seed, rate, H, heads_total, head_offset), _stream(qu))
    check_cuda_status(lib, code, "attn_fwd")
    launches[f"attention_fwd_d{D}"] += 1
    launches[f"attention_fwd_fma_d{D}"] += 1
    return out


def launch_attention_bwd_fma(qu, k, v, bias, g, seed: int, scale: float, rate: float,
                             heads_total=None, head_offset: int = 0):
    _check(qu, k, v, bias, heads_total, rate)
    _check_fma_grid(qu, heads_total)
    _check_like_qu(g, qu, "g")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    lib = _library()
    B, H, L, D = qu.shape
    _check_instance(D, "FMA", FMA_HEAD_DIMS)
    _check_fma_smem("bwd", L, D)
    dqu, dk, dv = (torch.empty_like(qu) for _ in range(3))
    dbias = torch.empty_like(bias)
    stats = torch.empty((B, H, L, 2), dtype=torch.float32, device=qu.device)
    code = lib.attn_bwd(_DTYPES[qu.dtype], qu.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), g.data_ptr(), dqu.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), dbias.data_ptr(), stats.data_ptr(), B, H, L, D,
                        scale, *_drop_args(seed, rate, H, heads_total, head_offset),
                        _stream(qu))
    check_cuda_status(lib, code, "attn_bwd")
    launches[f"attention_bwd_d{D}"] += 1
    launches[f"attention_bwd_fma_d{D}"] += 1
    return dqu, dk, dv, dbias


# ---------------------------------------------------------------------------
# tensor-core kernels (csrc/attention_mma.cu: bf16; csrc/attention_f32_mma.cu:
# f32 as 3xTF32), one calling convention
# ---------------------------------------------------------------------------
def _check_mma(qu, k, v, bias, heads_total, rate, route, kind, wide):
    """Checks a launch of pass ``kind`` of ``route``'s kernels; returns
    ``(wide, routed)``: whether the wide instance runs (``wide``, or where
    None the instance :func:`attention_instance` names) and whether the route
    takes the wide instance at this head dim."""
    _check(qu, k, v, bias, heads_total, rate)
    B, H, L, D = qu.shape
    if attention_route(qu.dtype, L, D) != route:
        want = "bfloat16" if route == "tc" else "float32"
        raise ValueError(f"the {route} kernels take {want}, got {qu.dtype}")
    dims = INSTANCE_HEAD_DIMS[(route, kind)]
    routed = D not in dims
    wide = routed if wide is None else wide
    _check_instance(D, f"{route} {kind}", dims, wide, qu.dtype)
    if any(t.data_ptr() % 16 for t in (qu, k, v)):
        raise ValueError("the tensor-core kernels read qu, k and v in 16-byte chunks: their "
                         "data must start 16-byte aligned")
    return wide, routed


def _count(kind, route, D, wide, routed):
    """One launch: ``attention_{kind}_d{D}`` and its route's count the
    instance that ``fused_attention`` runs at D (the wide one past 256 and in
    three of the four passes at 256), and ``attention_{kind}_{route}_wide_d{D}``
    the wide instance alone, so the wide instance launched where the route
    takes the D = 256 instance raises no D = 256 count."""
    if wide == routed:
        launches[f"attention_{kind}_d{D}"] += 1
        launches[f"attention_{kind}_{route}_d{D}"] += 1
    if wide:
        launches[f"attention_{kind}_{route}_wide_d{D}"] += 1


# each set's C entries (``{prefix}_fwd``, ``{prefix}_bwd``, ``_wide`` after
# either for the wide instance) and its library at a sequence length L
_ENTRIES = {"tc": ("attn_mma", lambda L: _library_mma()),
            "tf32x3": ("attn_tf32", lambda L: _library_tf32(L > F32_PSUM_MIN_L))}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _wide_blocks(route: str, exact: bool) -> int:
    prefix, lib = _ENTRIES[route]
    lib = lib(0)  # the scores pass: the same kernel in either f32 library
    n = getattr(lib, f"{prefix}_fwd_wide_blocks")(int(exact))
    if n < 0:
        raise RuntimeError(f"{prefix}_fwd_wide_blocks: CUDA error {-n} "
                           f"({lib.error_string(-n).decode()})")
    return n


def _run_fwd(route, wide, qu, k, v, bias, out, lse, scale, drop, splits):
    """The C entry of ``route``'s forward (``wide``: its wide instance, with
    ``splits`` key splits, None: :func:`wide_key_splits` on this card) on
    these tensors, once for each launch of :func:`attention_chunks`; ``drop``
    is :func:`_drop_args`. A pass over more than one launch counts as
    ``attention_fwd_{route}_chunked_d{D}``. Returns the key splits (1 off the
    wide instance)."""
    prefix, lib = _ENTRIES[route]
    B, H, L, D = qu.shape
    lib = lib(L)
    entry, Lp = f"{prefix}_fwd", 0
    if wide:
        nt = -(-L // 64)
        Lp = 64 * nt
        if splits is None:
            exact = L % 64 == 0 and bias.data_ptr() % 16 == 0  # the C entry's instance
            splits = wide_key_splits(L, B * H, _sm_count(qu.device.index or 0),
                                     _wide_blocks(route, exact))
        if not 1 <= splits <= nt:
            raise ValueError(f"the wide forward splits its {nt} key tiles 1 .. {nt} ways, "
                             f"got {splits}")
        # the scaled scores, (B, H, Lp, Lp) f32, Lp = L padded to whole 64-row
        # tiles; at S > 1 a launch's splits' partial row max and sum, (2,
        # B*H, S, Lp) over the launch's pairs
        scores = torch.empty((B, H, Lp, Lp), dtype=torch.float32, device=qu.device)
        entry += "_wide"
    chunks = attention_chunks(B, H, L)
    for b0, nb, h0, nh in chunks:
        bh0 = b0 * H + h0
        scratch = ()
        if wide:
            part = (torch.empty((2, nb * nh, splits, Lp), dtype=torch.float32,
                                device=qu.device) if splits > 1 else None)
            scratch = (_at(scores, bh0 * Lp * Lp), None if part is None else part.data_ptr())
        code = getattr(lib, entry)(
            _at(qu, bh0 * L * D), _at(k, bh0 * L * D), _at(v, bh0 * L * D),
            _at(bias, bh0 * L * L), _at(out, b0 * out.stride(0) + h0 * out.stride(1)),
            _at(lse, bh0 * L), *scratch, _row_strides(out, _row_align(wide, D)), nb, nh, L, D,
            *((splits,) if wide else ()), scale, *_chunk_drop(drop, b0, h0, L), _stream(qu))
        check_cuda_status(lib, code, entry)
    if len(chunks) > 1:
        launches[f"attention_fwd_{route}_chunked_d{D}"] += 1
    return splits if wide else 1


def _run_bwd(route, wide, qu, k, v, bias, g, out, lse, dqu, dk, dv, dbias, scale, drop):
    """The C entry of ``route``'s backward (``wide``: its wide instance) on
    these tensors, once for each launch of :func:`attention_chunks` (counted
    as in :func:`_run_fwd`)."""
    prefix, lib = _ENTRIES[route]
    B, H, L, D = qu.shape
    lib = lib(L)
    delta = torch.empty_like(lse)
    entry = f"{prefix}_bwd"
    if wide:  # the dropped probabilities, (B, H, L, L) in the inputs' dtype
        pd = torch.empty_like(bias)
        entry += "_wide"
    chunks = attention_chunks(B, H, L)
    for b0, nb, h0, nh in chunks:
        bh0 = b0 * H + h0
        rows, sq = bh0 * L * D, bh0 * L * L
        code = getattr(lib, entry)(
            _at(qu, rows), _at(k, rows), _at(v, rows), _at(bias, sq),
            _at(g, b0 * g.stride(0) + h0 * g.stride(1)),
            _at(out, b0 * out.stride(0) + h0 * out.stride(1)), _at(lse, bh0 * L),
            _at(delta, bh0 * L), _at(dqu, rows), _at(dk, rows), _at(dv, rows), _at(dbias, sq),
            *((_at(pd, sq),) if wide else ()), _row_strides(g, _row_align(wide, D)),
            _row_strides(out, _row_align(wide, D)), nb, nh, L, D,
            scale, *_chunk_drop(drop, b0, h0, L), _stream(qu))
        check_cuda_status(lib, code, entry)
    if len(chunks) > 1:
        launches[f"attention_bwd_{route}_chunked_d{D}"] += 1


def _launch_fwd(route, qu, k, v, bias, seed, scale, rate, heads_total=None, head_offset=0,
                wide=None, splits=None):
    """``route``'s forward on the instance :func:`attention_instance` names
    (``wide`` forces the wide instance where it is not the route's, the bf16
    forward at 256; ``splits`` the wide forward's key splits). A wide launch
    with more than one split also counts as
    ``attention_fwd_{route}_wide_split_d{D}``."""
    B, H, L, D = qu.shape
    wide, routed = _check_mma(qu, k, v, bias, heads_total, rate, route, "fwd", wide)
    out = torch.empty((B, L, H, D), dtype=qu.dtype, device=qu.device).permute(0, 2, 1, 3)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=qu.device)
    splits = _run_fwd(route, wide, qu, k, v, bias, out, lse, scale,
                      _drop_args(seed, rate, H, heads_total, head_offset), splits)
    _count("fwd", route, D, wide, routed)
    if splits > 1:
        launches[f"attention_fwd_{route}_wide_split_d{D}"] += 1
    return out, lse


def _launch_bwd(route, qu, k, v, bias, g, out, lse, seed, scale, rate, heads_total=None,
                head_offset=0):
    B, H, L, D = qu.shape
    wide, routed = _check_mma(qu, k, v, bias, heads_total, rate, route, "bwd", None)
    _check_like_qu(g, qu, "g")
    _check_like_qu(out, qu, "out")
    if lse.shape != (B, H, L) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be the forward's contiguous (B, H, L) float32")
    dqu, dk, dv = (torch.empty_like(qu) for _ in range(3))
    dbias = torch.empty_like(bias)
    _run_bwd(route, wide, qu, k, v, bias, g, out, lse, dqu, dk, dv, dbias, scale,
             _drop_args(seed, rate, H, heads_total, head_offset))
    _count("bwd", route, D, wide, routed)
    return dqu, dk, dv, dbias


def launch_attention_fwd_mma(qu, k, v, bias, seed: int, scale: float, rate: float,
                             heads_total=None, head_offset: int = 0):
    """bf16 (``attention_mma.cu``). Returns ``(out, lse)``: ``out`` is a (B, H,
    L, D) view of a (B, L, H, D) buffer, so that ``out.transpose(1,
    2).reshape(B, L, H * D)`` copies nothing; ``lse`` is the rows'
    log-sum-exp, (B, H, L) float32. D is an instance's head dim: 16 .. 256,
    or past 256 a multiple of :data:`WIDE_CHUNK` on the wide instance."""
    return _launch_fwd("tc", qu, k, v, bias, seed, scale, rate, heads_total, head_offset)


def launch_attention_bwd_mma(qu, k, v, bias, g, out, lse, seed: int, scale: float,
                             rate: float, heads_total=None, head_offset: int = 0):
    """bf16 (``attention_mma.cu``). ``g`` and ``out`` may be strided over (b,
    h, l); their rows must be contiguous and 16-byte aligned. D as in
    :func:`launch_attention_fwd_mma` (from 256 on the wide instance)."""
    return _launch_bwd("tc", qu, k, v, bias, g, out, lse, seed, scale, rate, heads_total,
                       head_offset)


def launch_attention_fwd_tf32(qu, k, v, bias, seed: int, scale: float, rate: float,
                              heads_total=None, head_offset: int = 0):
    """f32 as 3xTF32 (``attention_f32_mma.cu``); returns ``(out, lse)`` as
    :func:`launch_attention_fwd_mma` does (from 256 on the wide instance)."""
    return _launch_fwd("tf32x3", qu, k, v, bias, seed, scale, rate, heads_total, head_offset)


def launch_attention_bwd_tf32(qu, k, v, bias, g, out, lse, seed: int, scale: float,
                              rate: float, heads_total=None, head_offset: int = 0):
    """f32 as 3xTF32 (``attention_f32_mma.cu``); ``g`` and ``out`` as in
    :func:`launch_attention_bwd_mma`."""
    return _launch_bwd("tf32x3", qu, k, v, bias, g, out, lse, seed, scale, rate, heads_total,
                       head_offset)


_TC_LAUNCHES = {"tc": (launch_attention_fwd_mma, launch_attention_bwd_mma),
                "tf32x3": (launch_attention_fwd_tf32, launch_attention_bwd_tf32)}


def _wide_launches(route):
    """The forward launcher of ``route``'s wide instance at every multiple of
    :data:`WIDE_CHUNK` from 256 on, 256 included, where the bf16 route runs
    the D = 256 instance: no model path takes it there, it is launched so to
    hold the two forwards against each other (the other passes at 256 have
    the wide instance alone)."""
    return functools.partial(_launch_fwd, route, wide=True)


def _count_padding(kind: str, route: str, Dp: int) -> None:
    """A pass run on inputs zero-padded to ``Dp`` (``F.pad`` copies) also
    counts ``attention_{kind}_{route}_padded_d{Dp}``: a run shows where
    ``fused_attention`` pads."""
    launches[f"attention_{kind}_{route}_padded_d{Dp}"] += 1


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qu, k, v, bias, seed, scale, rate, heads_total, head_offset):
        ctx.args = (seed, scale, rate, heads_total, head_offset)
        _check(qu, k, v, bias, heads_total, rate)
        B, H, L, D = qu.shape
        ctx.route = attention_route(qu.dtype, L, D)
        ctx.launch = _TC_LAUNCHES[ctx.route]
        # the two passes pad at the same head dims (attention_pass_head_dim)
        ctx.padded = attention_pass_head_dim(qu.dtype, "fwd", D) != D
        if ctx.padded:
            out, lse, saved = attention_fwd_padded(ctx.launch[0], qu, k, v, bias, *ctx.args)
            _count_padding("fwd", ctx.route, saved[0].shape[-1])
        else:
            out, lse = ctx.launch[0](qu, k, v, bias, *ctx.args)
            saved = (qu, k, v, out)
        ctx.save_for_backward(*saved, bias, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qu, k, v, out, bias, lse = ctx.saved_tensors
        if ctx.padded:
            if not _rows_addressable(g):
                g = g.contiguous()
            grads = attention_bwd_padded(ctx.launch[1], (qu, k, v, out), bias, g, lse,
                                         *ctx.args)
            _count_padding("bwd", ctx.route, qu.shape[-1])
        else:
            align = _row_align(attention_instance_at(qu.dtype, "bwd", qu.shape[-1]) == "wide",
                               qu.shape[-1])
            if not _rows_addressable(g, align):
                g = g.contiguous()
            grads = ctx.launch[1](qu, k, v, bias, g, out, lse, *ctx.args)
        return (*grads, None, None, None, None, None)


def fused_attention(qu, k, v, bias, seed: int, scale: float, rate: float = 0.0,
                    heads_total=None, head_offset: int = 0):
    """``dropout(softmax((qu k^T + bias) * scale)) v`` for (B, H, L, D) inputs.

    CUDA tensors run the hand-written tensor-core kernels, forward and
    backward, on the set :func:`attention_route` names: bfloat16 on
    ``attention_mma.cu``, float32 on ``attention_f32_mma.cu``, at any L and
    any head dim, each pass at :func:`attention_pass_head_dim` (16, 32, 64 and
    128 are instances, and the bf16 forward's 256; past 128 the wide
    instance takes D unpadded, but for an odd bf16 D, which, like every D up
    to 128 off an instance, runs the next instance up on zero-padded inputs,
    counted as ``attention_{kind}_{route}_padded_d{Dp}``; module note). The
    output is a (B, H, L, D) view of a (B, L, H, D') buffer, D' the head dim
    the forward ran at.
    CPU tensors run :func:`attention_plain`. ``seed`` is a uint32, ignored at
    rate 0. A tensor-parallel rank's H heads are ``head_offset ..`` of
    ``heads_total`` (None: H), which places its dropout mask (module note).
    """
    if qu.device.type == "cpu":
        return attention_plain(qu, k, v, bias, seed, scale, rate, heads_total, head_offset)
    return _FusedAttention.apply(qu, k, v, bias, seed, scale, rate, heads_total, head_offset)
