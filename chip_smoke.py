#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``sarssl_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. card   : name and power limit (nvidia-smi), torch and CUDA versions;
              TF32 is switched off for matmuls and cuDNN throughout.
  2. build  : compiles ``sarssl_torch/csrc/*.cu`` with nvcc (one process per
              source, started together), prints ptxas' register report, and
              fails if a tensor-core kernel (attention bf16 and f32, conv)
              spills or its library holds no tensor-core instruction.
  3. kernels: each hand-written kernel against its plain PyTorch version at
              the shapes the pretext step gives it, with the tolerance stated,
              and timed with CUDA events beside its bound and a library call
              (attention also beside the FMA kernels it replaced at these
              shapes), and the attention at the shapes the model's options
              bring (L = 257 with the CLS token, L = 512 with one channel a
              patch), each on the route the wrapper takes (bf16 on the tensor
              cores at every L and D = 32 / 64 / 128, beside the FMA kernels
              launched directly with a 4x floor at L = 257 and at D = 32).
              f32 at D = 32 / 64 / 128 runs the 3xTF32 tensor-core kernels:
              held against the plain version at L = 64, 257 and 768 (past
              the FMA kernels' 704), and at L = 512 D = 64, L = 256 D = 128
              and L = 256 D = 64 timed beside the FMA kernels launched
              directly (2x floor), SDPA and the bound (bytes, or three TF32
              products a product at the TF32 rate). Head dim 16 in both
              dtypes on the tensor cores (bf16 and 3xTF32): held against the
              plain version at L = 1, 33, 257, 768 and 1000, and at the
              flagship's (128, 4, 256) at rates 0 and 0.1, timed there beside
              the FMA kernels launched directly (1.5x floor), SDPA and the
              bound. Head dim 256 in both dtypes on the tensor cores (the
              bf16 forward on its D = 256 instance, the other three passes
              on the wide instance): held against the plain version at L = 1,
              33, 256, 257 and 768, and at (128, 4, 256) at rates 0 and 0.1,
              timed there beside SDPA and the bound (the FMA kernels have no
              D = 256 instance). Head
              dims 8, 48 and 200, which run the next instance on zero-padded
              inputs, held against the plain version, and D = 8 timed
              through the padding beside the bare launch. The wide instance
              (every head dim past 256) in both dtypes: D = 512 at (128, 4,
              256) at rates 0 and 0.1 and at L = 257, timed at 256 beside
              SDPA and the bound; D = 300 (padded to 320: blocks of 64
              columns) and 1000 (to 1024: of 128) at batch 8, L = 1, 33, 257
              and 256, timed at 256, where the forward's scores pass splits
              its key tiles over blocks: that forward also launched at the
              padded head dim at the chosen splits and at one (chosen, 1, 1,
              chosen); the bf16 wide forward launched at D = 256 held
              against the plain version and timed beside the D = 256
              instance (instance, wide, wide, instance); a torch.profiler
              split of the D = 512 launches by kernel. Then the attention module of the conformer in bf16 at
              both flagship widths, at d_model 64 (D = 16), 32 (D = 8,
              padded) and 2048 (D = 512, wide), fused against unfused, on the
              card.
              The conv part holds the four 3x3 conv launches (conv3x3 and
              its s2d form, forward and dx) at the CNN front end's shape
              (128, 256, 256, 64) bf16 on the tensor-core kernel, timed beside
              the FMA kernel it replaced there (5x floor) and cuDNN, and in
              f32 on the 3xTF32 tensor-core kernel (conv3x3_tf32.cu), timed
              beside the f32 FMA kernel launched directly, cuDNN in f32 and
              the plain version, plus a ragged bf16 and f32 case and the
              dense 128-channel instance, then drives ``conv3x3`` /
              ``conv3x3_s2d`` forward and backward once in each dtype with
              the launch counts zeroed before and read after: the convs are
              on no model path, so that is their path. The lane-seeded
              dropout (one seed a lane, under ``torch.func.vmap``) against
              vmapped ``dropout_plain``, output,
              mask and gradient exactly, at the grid's largest dropout shape
              (8 lanes, f32; timed, queued behind a sleeping kernel, beside
              its bound and ``F.dropout``) and on 8 bf16 lanes past 2**31
              elements.
  3b. edges: the inputs the hand-written kernels take past one launch's
              grid or 32-bit offsets, as the Pallas kernels take any: each
              driven once through its public entry point with the launch
              counts read around it and asserted exactly, held against its
              plain version, then timed beside its bound and its library
              call. Attention (fused_attention forward and backward) at
              B * H = 65792, two launches a pass, at D = 16 and 320 (wide),
              rates 0 and 0.1, in bf16 and f32 (the batches at both ends and
              at the launch boundary against the plain version); at B * H *
              L * L past 2**32, rate 0, in bf16 at (1, 1, 65600, 16), (2, 4,
              23200, 64) and (1, 1, 65600, 320) (wide), in f32 at (1, 256,
              4100, 16), (2, 128, 4100, 64) and (1, 256, 4100, 320) (every
              row against the plain version in blocks of 2048 query rows);
              the f32 route's out, dqu, dk and dv against float64 at (1,
              1, L, 16), L = 4096, 16384 and 65600, each held to TOL_F32
              (past L = 1024 the kernels take partial sums over L); the
              refusal at rate 0.1 past 2**32. hash_dropout at 2**31 + 2**24
              elements in both dtypes, forward and gradient, and the
              lane-seeded launch under vmap at (2, 2**31 + 4096) bf16 and
              (65600, 64) f32 (lanes shorter than a block: the short-lane
              kernel over the flat tensor), every element against the plain
              version, bit for bit. conv3x3 forward and backward at (C,
              Cout) = (3, 64), (64, 48), (96, 160) and (256, 256) (the
              kernels that take the channel counts at run time: bf16 on the
              tensor cores, conv3x3_any_mma.cu, f32 on the 3xTF32 tensor-core
              kernel, conv3x3_tf32.cu, each timed beside the f32-FMA
              runtime-channel kernel launched directly) and conv3x3_s2d at C
              = 256 (the conv of x itself on 256 channels), in both dtypes at
              (16, 64, 64), bf16 also at (2, 19, 38), and at N = 65600 with
              (H, W) = (4, 8), C = 64 and 3 (in image groups in both dtypes,
              timed beside the row-tile kernel of the same source launched
              directly on the same inputs), and (4099, 3, 5) 13 -> 24 in both
              dtypes (ragged image groups); the f32 conv against float64 at
              K = 9 C up to 18432 (C = Cout = 256, 1024, 2048), forward and
              dx, in row tiles and image groups.
  4. ref    : small pretext models on the card (kernels) against the same
              models on the CPU (plain versions), f32, dropout on, same seeds:
              one at head dims 32 and 16, SARSSLConfig.tiny(
              fused_attention=True) (head dims 8 and 4, through the padding)
              and SARSSLConfig.tiny(spec_dembed=1024, fused_attention=True)
              (head dim 256 at L = 16) and SARSSLConfig.tiny(spec_dembed=1280,
              fused_attention=True) (head dim 320 on the wide instance).
  5. train  : the flagship pretext pre-training step (bf16, batch 128,
              65792-sample 2-mic waves, fused attention, dropout 0.1): one
              warm-up and 5 timed steps through ``make_pretrain_step``, with
              the kernels' launch counts read around them, then one eval step.
  6. pretrain_cli: the pre-training run through its CLI,
              ``sarssl_torch.cli.run_pretrain.main``, at the flagship width
              (bf16, batch 128, ``--synthetic --fused-attention``, 2 train +
              1 val batches an epoch): 2 epochs, then ``--resume`` to a
              third, with the launch counts zeroed before and read after,
              the files and metrics it writes checked, and the host's
              synthetic-data and checkpoint-write seconds timed. Then the
              committed trained checkpoint (epoch 27) loaded through the
              port's checkpoint reader into the flagship model at 64 frames,
              batch 2: the eval step on one replayed mask, f32 and bf16 on
              the card against f32 on the CPU.
  7. pretrain_options: the pre-training CLI's other options at the flagship
              width, each call with the launch counts zeroed before and read
              after: (a) ``--test`` on the committed trained checkpoint
              (metrics.json, PESQ in range, wav / .mat dumps, config_test.json;
              the synthetic batches, the forward, the ISTFT, PESQ and the dumps
              timed by wrapping); (b) ``--pretrain-frozen-encoder --init-ckpt``
              from it (encoders bit-identical with zero Adam moments, decoder
              and BatchNorm stats moved, no attention backward); (c)
              ``--mel-bins 30`` (the model's 30 bands, mel features card
              against CPU). Then phase ``trained`` also holds
              ``pretext_metrics`` (MSEs, ISTFT waveforms, PESQ) of the trained
              model's prediction, card f32 against CPU f32.
  8. downstream: the trunk that ``train`` just stepped, ``partial_load``ed
              into the flagship downstream model (f32, batch 8, 16640-sample
              waves, TDOA, dropout 0.1): finetune and lineareval (frozen
              encoder) steps, one warm-up and 5 timed each, with the launch
              counts read around them, and eval steps; then a small
              downstream model on the card against the CPU.
  9. downstream_cli: the downstream grid through its CLI,
              ``sarssl_torch.cli.run_downstream.main``, at the flagship width
              from the committed trained checkpoint, each call with the
              launch counts zeroed before and read after: (a) finetune, TDOA,
              batch 8, lr {1e-3, 1e-4}, 3 epochs a cell (results, ensembles,
              pruned epoch files and hash_dropout launches checked); (b) a
              lineareval cell (the ensemble's encoders bit-identical to the
              checkpoint's); (c) ``--ds-test`` on a cell of (a) (its test MAE
              again) and the no-train baseline; (d) the multi-pair model, 4
              mics, all 6 pairs (per-pair MAEs logged); (e) ``--ds-test-mode
              vis_embed`` on a cell of (a) (the t-SNE's inputs caught). The
              host's synthetic batches and checkpoint writes are timed, every
              call caught.
 10. grid_vmap: the vmapped downstream grid through ``run_downstream
              --grid-vmap`` at the flagship width (f32, TDOA, batch 8) from the
              committed trained checkpoint, each call with the launch counts
              zeroed before and asserted exactly after: (a) the reference's
              simulated grid, 4 lr x 4 trials = 16 cells in two chunks of 8
              lanes, 2 epochs of 64 / 32 / 32 rows, --scan-block 4: seconds
              per grid epoch, each chunk's first pass, the peak GiB of a chunk;
              (b) the same grid without --grid-vmap (per-cell val and test MAE
              of the two held together, TOL_GRID; seconds per grid epoch and
              the ratio); (c) a lineareval chunk of 8 lanes (every ensemble's
              encoders bit-identical to the checkpoint's); (d) a resident
              packed run from a small gen_simu tree; (e) one vmapped step of 8
              lanes timed beside a sequential step, then profiled (device ms,
              busy share, the longest kernels). hash_dropout_lanes 56 a
              finetune and 28 a lineareval vmapped step, no unbatched dropout.
 11. data_path: the simulated-data path at the flagship widths, each CLI call
              with the launch counts zeroed before and asserted exactly after:
              (a) ``gen_simu`` writes a 256-item 4.112 s pre-training tree on a
              worker per host core, small val / test trees and a 2-room
              certain-room tree in process (s/item logged); ``pack_data``
              packs the 256 items (GB/s logged) and three of them are held
              against their wav and ``_info.npz``; (b) ``run_pretrain`` at the
              flagship width (bf16, batch 128, fused attention, 2 train + 1 val
              batches, 1 epoch) from the wav tree, the packed dir, and the
              packed dir staged on the card (``--resident``, f32 and int16),
              the resident runs drawing the packed run's rows; epoch utt/s and
              the host's share of the wall inside the loader's ``next``; (c)
              ``synth_batch_device`` alone at batch 128 (ms by CUDA events,
              peak GiB), its deterministic part card against CPU on the same
              draws at batch 4 (tolerance 1e-4 of the peak), a seed giving the
              same batch bit for bit, then ``run_pretrain --device-synth`` for
              2 epochs beside phase pretrain_cli's ``--synthetic`` rate; (d)
              ``run_downstream`` from the committed trained checkpoint (f32,
              batch 8, 1 epoch a cell): T60 and DRR on the 4.112 s tree each
              with ``--ds-test`` (its MAE against the cell's), ``--room-trials
              --ds-nsimroom 2`` on the certain-room tree and
              ``--fixed-train-subset`` on the packed dir (hash_dropout 56 a
              finetune step).
 12. real_data: the real-data path at the flagship widths on synthetic trees
              in each corpus's on-disk layout, each CLI call with the launch
              counts zeroed before and asserted exactly after: (a) on the host,
              ``gen_real_rir --corpus ACE`` on a 3-room ACE tree (s a pair RIR),
              ``gen_sig_from_real_rir`` (4.112 s items, s/item), ``gen_simu
              --mode rir`` and ``gen_locata`` train / val / test; (b)
              ``run_downstream --real-exp`` T60 finetune from the committed
              trained checkpoint (f32, batch 16, 1 epoch a cell) on the real and
              simulated RIR arms at ``--real-sim-ratio 1 1`` with ``--rir-cv``
              (a cell a held-out room), s per cell epoch and the host's share
              inside ``next``; the same call with ``--mp-loader --workers 8``
              (its batches the threads' bit for bit); ``--ds-test`` on a cell;
              (c) TDOA from the LOCATA tree mixed 1:1 with a simulated tree; (d)
              ``run_pretrain`` at the flagship width (bf16, batch 128, fused
              attention, 2 train + 1 val batches) from ``--real-corpora``
              AISHELL4 (``--remove-spkoverlap``) and AMI, ``--real-data-dirs``
              and ``--real-data-probs``: epoch utt/s, the host's share, and the
              rows drawn against the mixture's draws.
 13. model_options: the model's options, first each on a small model card
              against CPU (dropout on, same seeds), then at the flagship
              pretext width (bf16, batch 128, fused attention, dropout 0.1),
              each variant one warm-up and 3 timed steps through
              ``make_pretrain_step`` with its launch counts zeroed before and
              asserted exactly after, and its peak memory: (a) the mask modes
              (every drawn mask's count checked), (b) ``in_ver="same"``, (c)
              ``in_ver="single_ch_each_patch"`` (L = 512: D = 64 and D = 32
              on the tensor cores), (d) ``use_cls`` (L = 257 on the tensor
              cores) and the downstream model with the token (f32, no fused
              attention), (e) ``remat_cnn`` (its first step against the
              plain one's), (f) the ``fc`` front end, (g)
              f-first (16, 16) patches with 'TF' masks, (h) transformer
              encoders, (i) the decoder's stages and CNN head, (j)
              ``MCConformer``'s forward in f32 and bf16, (k)
              ``ConformerEncoder(remat=True)`` against plain, (l) the flagship
              step in f32 with fused attention (the 3xTF32 kernels: 1 / 3
              launches a step, forward and backward, at D = 128 / 64; none on
              the FMA kernels) beside the same f32 step unfused, (m)
              ``spec_dembed=1024`` (the spec encoder at head dim 256: the bf16
              forward on the D = 256 instance, the bf16 backward and both f32
              passes on the wide instance, counted) in bf16 and f32, each
              beside the same step unfused, their losses held together (bf16
              2e-2, f32 1e-3), (n)
              ``spec_dembed=2048`` (head dim 512 on the wide instance) the
              same way.
 14. ablations: the CRNN ablation encoders, ``EmbedEncoder(model=(m,))`` for
              m in crnn, crnn-sim, tcrnn in mode spec (dembed 512) and spat
              (dembed 256) and ``CauCRNN()`` at its defaults, at the flagship
              pretext encoder's input ((256, 256) TF map, 2 x 2 channels,
              (256, 1) patches; CauCRNN the (256, 256, 4) map), f32: (a) each
              trains at batch 128 on an MSE to seeded targets with
              ``make_adam(1e-3, weight_decay=1e-2, grad_clip=1.0)``, one
              warm-up and 3 timed steps (step ms, utt/s, peak GiB) and one
              profiled step (device ms, busy share, the longest kernel), every
              launch count zeroed before and asserted 0 after; (b) each at
              batch 2 card against CPU, the same weights and inputs: the eval
              forward, then one AdamW + clip step (loss, parameters, BatchNorm
              stats); (c) ``dpipd_template`` at the (37, 73) grid, nf 257,
              and ``forgetting_norm`` on (128, 2, 257, 256), card against CPU;
              ``estimate_flops`` of the flagship pretext forward; ``StepTimer``
              and ``trace`` around two flagship pretext train steps.
 15. mesh: the multi-device path (``sarssl_torch/parallel``) on one card,
              every call's launch counts zeroed before and asserted after:
              (a) the flagship pretext step (bf16, batch 128, fused attention)
              through ``make_sharded_pretrain_step`` on a 1x1 mesh (an NCCL
              group of one rank in this process): 6 steps equal to the plain
              step's from the same state and generator bit for bit (cuDNN
              deterministic for both), then 1 warm-up and 5 timed steps (step
              ms beside phase train's, peak GiB), one profiled step (the NCCL
              kernels' device ms: none, one data rank syncs no gradients) and
              the all-reduce of a bucket of every parameter alone by CUDA
              events; (b) ``run_pretrain --mesh 1x1
              --fused-attention`` (1 epoch: 2 train and 1 val batches of 128)
              and ``run_downstream --mesh 1x1`` (a finetune cell epoch from the
              committed trained checkpoint), each beside the same call
              unmeshed (epoch utt/s, s a cell epoch); (c) the index maps of a
              tensor-parallel rank: attention forward and backward on half the
              heads with ``(heads_total, head_offset)`` on the tensor-core
              route (bf16, D = 128 / 64, L = 256; D = 64, L = 257) and the
              3xTF32 route (f32 D = 64), and the dropout kernel on half the columns
              with ``(row_local, row_total, col_offset)``: each equal to the
              slice of the full launch bit for bit and held against its plain
              version, timed beside the same launch unsharded.
Then the FMA attention kernels' launch counts are asserted 0 in every model
phase (``fused_attention`` never reaches them; only phase kernels' yardsticks
launch them, directly), the ``kernels`` JSON line (each row with
``launches_ablations`` and ``launches_mesh``; rows 1-3 with their index-mapped
times) and, last, the ``ok`` JSON line.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 128
NSAMPLE = 65792  # 4.112 s at 16 kHz -> 256 STFT frames
STEPS = 5
SEQ, HEADS = 256, 4
HEAD_DIMS = (128, 64)  # spec encoder d=512, spat encoder d=256, 4 heads
LAYERS = {128: 1, 64: 3}  # attention layers per step at each head dim
RATE = 0.1

# H100 SXM data-sheet peaks (dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # CUDA-core rate, used for the dropout hash's 32-bit ops
TF32_FLOPS = 494.7e12
# f32-accurate products on the tensor cores take three TF32 products each
# (3xTF32), so the least time for f32 attention's operations is 3 x ops at
# the TF32 rate; at 201.3 TFLOP/s of f32 work that beats the CUDA cores' 67
TF32_SPLIT = 3

# Tolerances, relative to the largest magnitude of the plain f32 result:
# bf16 inputs carry 8 mantissa bits; the kernel rounds p to bf16 before the
# PV product as the reference does, and sums 256 terms in another order.
TOL_BF16 = 2e-2
# f32 kernel against f32 plain: only the summation order differs.
TOL_F32 = 1e-4

# small model on the card against the CPU, f32, TF32 off
TOL_REF = 1e-3
# conv kernels in bf16 against the f32 plain version: the f32 sums over
# K = 576 are rounded once to bf16 (half an ulp is 2e-3 of the value)
TOL_CONV_BF16 = 1e-2
# the floor under the conv redesign: each tensor-core launch against the FMA
# kernel on the same inputs in the same run
CONV_FMA_FLOOR = 5.0
# the s2d form skips the blocks that are zero by construction, so it may take
# at most this much longer than conv3x3
CONV_S2D_OVER = 1.15

CONV_SHAPE = (128, 256, 256, 64)  # the CNN front end's 3x3 convs, (B, H, W, C)
CONV_SMALL = (2, 37, 50, 64)  # f32 and bf16 cases: H and W not multiples of the tile
CONV_DENSE = (2, 37, 50, 128)  # bf16, the dense 128 -> 128 instance
CONV_LAUNCHES = ("conv3x3_fwd", "conv3x3_dx", "conv3x3_s2d_fwd", "conv3x3_s2d_dx")
CONV_REPLACES = {"conv3x3": "sarssl_tpu/kernels/conv3x3.py:51",
                 "conv3x3_s2d": "sarssl_tpu/kernels/conv_s2d.py:88"}

# pretrain_cli: 2 train batches and 1 val batch of 128 an epoch
CLI_TRAIN_NUM, CLI_VAL_NUM = 256, 128
CLI_LR = 1e-3  # run_pretrain's default --lr
TRAINED_CKPT = "exp/pretrain_r5_ctf_s101/best_model_f16.msgpack"  # epoch 27
# the trained model in bf16 on the card against f32 on the CPU: bf16 rounding
# raises the loss (each element's error adds its square); bf16 against f32,
# both on the CPU, on these weights and waves read 1.1e-2 and 2.0e-2 on two
# masks
TOL_TRAINED_BF16 = 5e-2
# ... and its prediction, element by element, relative to max |f32|: bf16
# keeps 8 bits, and through the flagship's depth the trained model's
# prediction moves by about a tenth of its largest value (max) and 6% (mean)
# (the JAX package's bf16 against its f32 on these weights reads 0.099 and
# 0.059, the port's on the CPU 0.113 and 0.066). The card's bf16 must stay
# within this factor of the CPU's bf16 reading, taken in the same run.
TRAINED_BF16_FACTOR = 1.5

# pretrain_options: --test reads 2 val batches of 128; the frozen-encoder and
# mel runs take 1 epoch of 4 train and 1 val batches (the first step of each
# builds its new shapes' cuDNN plans: the step time is the median of the rest)
OPT_TEST_VAL_NUM = 256
OPT_TRAIN_NUM, OPT_VAL_NUM = 512, 128
MEL_BINS = 30  # the reference's n_mels (sarssl_tpu/ops/features.py:30-31)
# hash_dropout launches per pretext train step with fused attention: the
# encoders' 4 conformer blocks hold 6 dropout sites each outside the attention
# kernel, which drops its probabilities itself, each launched in the forward
# and again in the backward. With both encoders frozen no gradient flows
# through them, so only the forward launches.
PRETRAIN_DROPOUT_PER_STEP = {"train": 48, "frozen": 24}
# the trained model's pretext metrics, card f32 against CPU f32: PESQ, host
# numpy on the two reconstructions, absolute
TOL_PESQ = 1e-3

DS_BATCH = 8  # SIM_BS_SET's batch size (sarssl_tpu/config.py:49)
DS_NSAMPLE = 16640  # 1.04 s at 16 kHz -> 64 STFT frames
DS_FRAMES = 64
DS_LR = 1e-3

# downstream_cli: a cell epoch is 8 train and 4 val batches of 8, a cell's
# test and final val 4 batches each; the multi-pair run 8 train batches of 2
# examples (x 6 mic pairs = 12 pair rows) and 4 val / test batches
DSCLI_NUMS = ("--train-num", "64", "--val-num", "32", "--test-num", "32")
DSCLI_EPOCHS = 3
DSCLI_LIN_EPOCHS = 2
DSCLI_MC_NUMS = ("--train-num", "16", "--val-num", "8", "--test-num", "8")
DSCLI_MC_EPOCHS = 2
DSCLI_SEED = 100  # run_downstream's default --seed: the init weights
# hash_dropout launches per train step at the flagship depth: the two
# encoders' 4 conformer blocks hold 7 dropout sites each (2 in each feed-
# forward module, the attention probabilities, after attention, the conv
# module), each launched in the forward and again in the backward. Lineareval
# freezes both encoders, so no gradient flows through them and only the
# forward launches; the multi-pair trunk embeds with the spat encoder alone,
# so the spec encoder's block (7 sites) has no backward.
DS_DROPOUT_PER_STEP = {"finetune": 56, "lineareval": 28, "multipair": 49}

# data_path: a 256-item 4.112 s pre-training tree (2 train + 1 val batches of
# 128 an epoch, as pretrain_cli), 16-item val and test trees and a 2-room
# certain-room tree of 4 RIRs x 2 signals a room, generated on every core
DATA_T = "4.112"
DATA_NUM, DATA_EVAL_NUM = 256, 16
DATA_ROOMS, DATA_RIRS, DATA_SIGS = 2, 4, 2
DATA_SYNTH_EPOCHS = 2
SYNTH_TIMED = 5  # synth_batch_device calls timed by CUDA events at batch 128
SYNTH_CHECK_B = 4  # the synthesizer's deterministic part, card against CPU
# ... relative to the CPU wave's peak: the tolerance of the port against JAX
# on the CPU (tests/test_torch_device_synth.py); FFTs and sums in another order
TOL_SYNTH = 1e-4
# the data path's downstream cells: f32, batch 8, 1 epoch of 32 train rows
# (4 finetune steps), 16 val and 16 test rows
DS_DATA_NUMS = ("--train-num", "32", "--val-num", "16", "--test-num", "16")
# --ds-test's printed test MAE (5 decimals) against the grid's test_mae of
# the same cell: the same weights and batches on the same card
TOL_DS_TEST = 1e-4

# grid_vmap: the reference's simulated grid, SIM_LR_SET x 4 trials = 16 cells in
# two chunks of --grid-chunk 8 lanes, 2 epochs of 64 / 32 / 32 rows (8 train
# steps a cell epoch) in blocks of --scan-block 4, from the committed trained
# checkpoint; then the same grid without --grid-vmap in the same call
GRID_LRS = ("1e-3", "5e-4", "1e-4", "5e-5")
GRID_TRIALS = 4
GRID_CHUNK = 8
GRID_EPOCHS = 2
GRID_SCAN = 4
# a lineareval chunk (2 trials x the 4 lr, 1 epoch) and a resident packed run
# from a small gen_simu tree (1.04 s items; 2 trials x 2 lr, 1 epoch)
GRID_LIN_TRIALS = 2
GRID_RES_NUM, GRID_RES_EVAL_NUM = 64, 16
# per-cell val and test MAE, the vmapped grid against the sequential one on
# the same data, generators and masks, relative: the grouped convolutions and
# the lanes' batched products round otherwise than one cell's, and 2 epochs of
# 8 Adam steps at lr up to 1e-3 carry that into the weights (worst read 1.2e-3
# on an H100, 2.3e-4 on a CPU; tests/test_torch_grid_cli.py states the same)
TOL_GRID = 1e-2
# the lane-seeded dropout kernel: the grid's largest dropout shape (the spec
# encoder's feed-forward hidden, batch 8 x 64 frames x 2048) on 8 lanes, f32;
# and 8 bf16 lanes of 2**28 + 4096 elements, whose flat index passes 2**31
GRID_DROP_SHAPE = (GRID_CHUNK, DS_BATCH, DS_FRAMES, 4 * 512)
GRID_DROP_BIG = (GRID_CHUNK, 2 ** 28 + 4096)

# real_data: an ACE-layout corpus (3 rooms x Chromebook (2 mics) and Mobile
# (3 mics) x 2 array positions, 48 kHz, its T60 / DRR CSV), a WSJ0-style
# speaker tree, a LOCATA layout (dicit and benchmark2 in 'eval', dicit in
# 'dev', 48 kHz) and pre-training corpora in the AISHELL4 (TextGrids), AMI
# (a file a channel) and plain 4-channel layouts, all int16 but the RIRs
RD_ROOMS = ("Office_1", "Office_2", "Meeting_Room_1")
RD_ARRAYS = {"Chromebook": 2, "Mobile": 3}  # 1 + 3 pairs in [3, 20] cm
RD_SIG_NUM = 32  # gen_sig_from_real_rir items of 4.112 s
RD_SIM_RIRS = 16  # gen_simu --mode rir, the sim arm
RD_LOCATA_NUM = {"train": 64, "val": 16, "test": 16}  # gen_locata items of 1.04 s
RD_SIM_SIG_NUM = 32  # gen_simu 1.04 s items, the sim arm of --real-sig-dir
RD_SIM_T60 = ("0.2", "0.8")  # gen_simu --t60-range of both sim trees (default 0.2-1.3)
# the downstream cells: --real-exp's batch 16, one lr, 1 epoch of 4 finetune
# steps, 16 val and 16 test rows
RD_DS_NUMS = ("--train-num", "64", "--val-num", "16", "--test-num", "16")
RD_DS_BATCH = 16
RD_PROBS = ("0.4", "0.3", "0.3")  # AISHELL4, AMI, the 4-channel tree

# ablations: the CRNN arms (EmbedEncoder(model=(m,)) in both modes, CauCRNN at
# its defaults) at the flagship pretext encoder's input, a (256, 256) TF map of
# 2 x 2 channels in (256, 1) patches (256 patches of 1024 values), f32 (the JAX
# modules' default dtype), batch 128; each trains on an MSE to seeded targets
# with make_adam's AdamW and clipping: one warm-up and ABL_STEPS timed steps
ABL_ARMS = (("crnn", "spec"), ("crnn", "spat"), ("crnn-sim", "spec"), ("crnn-sim", "spat"),
            ("tcrnn", "spec"), ("tcrnn", "spat"), ("caucrnn", None))
ABL_DEMBED = {"spec": 512, "spat": 256}  # SARSSLConfig's spec / spat widths
ABL_SIG, ABL_PATCH = (256, 256, 2, 2), (256, 1)
ABL_STEPS = 3
ABL_LR, ABL_WD, ABL_CLIP = 1e-3, 1e-2, 1.0
ABL_CHECK_B = 2  # card against CPU at this batch of the same shapes
# ... after one AdamW + clip step, f32, TF32 off: Adam's first step moves an
# element by at most lr (1 + wd |p|), so two readings of a gradient that is
# mostly rounding may land up to 2 lr apart; all but ABL_FAR_SHARE of the
# elements within ABL_STEP_FAR (gradients clipped to norm 1 fall near Adam's
# eps 1e-8, where the step follows the gradient's size: rounding in the
# smallest shows, as tests/test_torch_utils_optim.py finds on the CPU)
ABL_STEP_FAR, ABL_FAR_SHARE = 2e-5, 1e-2
# dpipd_template at the reference's DOA grid with nf 257 on a 4-mic array (all
# 6 pairs), card against CPU: complex64 of modulus 1 whose phases reach ~30 rad,
# each rounded in f32 on both sides
ABL_DOA_GRID, ABL_NF, TOL_DPIPD = (37, 73), 257, 1e-4
ABL_FN_SHAPE = (BATCH, 2, 257, 256)  # forgetting_norm over a flagship STFT map


def log(*a):
    print(*a, flush=True)


# mesh (c): the index-mapped launches of a tensor-parallel rank. Attention at
# (L, D, dtype): the bf16 tensor-core kernels at both flagship head dims and
# at a ragged L, the 3xTF32 kernels in f32; the rank holds half the heads. The dropout at the spec encoder's feed-forward hidden (B, L, 2048)
# bf16 with half its units.
MESH_ATTENTION_SHAPES = ((SEQ, 128, torch.bfloat16), (SEQ, 64, torch.bfloat16),
                         (SEQ, 64, torch.float32), (SEQ + 1, 64, torch.bfloat16))
MESH_DROP_SHAPE = (BATCH, SEQ, 4 * 512)


def _sharded_attention(D, dtype, L, gen):
    """Attention forward and backward on each half of the heads with (H, h0),
    against the head slice of the full launch bit for bit and against the
    plain version; returns the errors, launch counts and times."""
    from sarssl_torch.kernels import attention_plain, fused_attention, launches
    from sarssl_torch.kernels.attention import _TC_LAUNCHES, attention_route

    scale = 1.0 / np.sqrt(HEADS * D)
    seed = 0x9E3779B9
    qu, k, v, bias, g = _attention_inputs(D, dtype, gen, L)
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    full = fused_attention(*xs, seed, scale, RATE)
    full_grads = torch.autograd.grad(full, xs, g)
    hl = HEADS // 2
    route = attention_route(dtype, L, D)
    names = (f"attention_fwd_d{D}", f"attention_bwd_d{D}")
    err, plain_err = 0.0, 0.0
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    for h0 in (0, hl):
        hs = slice(h0, h0 + hl)
        part = [t[:, hs].contiguous().requires_grad_() for t in (qu, k, v, bias)]
        before = [launches[n] for n in names]
        out = fused_attention(*part, seed, scale, RATE, HEADS, h0)
        grads = torch.autograd.grad(out, part, g[:, hs].contiguous())
        rose = [launches[n] - b for n, b in zip(names, before)]
        assert rose == [1, 1], f"sharded attention D={D}: launches {rose}"
        for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads),
                              (full, *full_grads)):
            assert torch.equal(a, b[:, hs]), (
                f"attention L={L} D={D} {dtype} heads {h0}+{hl} of {HEADS}: {name} differs "
                f"from the full launch's head slice")
            err = max(err, max_abs(a, b[:, hs]))
        ys = [t[:, hs].float().requires_grad_() for t in (qu, k, v, bias)]
        ref = attention_plain(*ys, seed, scale, RATE, HEADS, h0)
        ref_grads = torch.autograd.grad(ref, ys, g[:, hs].float())
        for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads),
                              (ref, *ref_grads)):
            rel = rel_err(a, b)
            assert rel <= tol, (f"sharded attention L={L} D={D} {dtype}: {name} rel err "
                                f"{rel} against the plain version > {tol}")
            plain_err = max(plain_err, max_abs(a, b))
    # times: the half-heads launch with (H, h0) beside the same launch
    # unsharded (H/2, 0); back to back on one card
    hs = slice(hl, HEADS)
    part = [t[:, hs].contiguous() for t in (qu, k, v, bias, g)]
    res = {"route": route, "max_abs_err": err, "plain_err": plain_err}
    times = {}
    launch_fwd, launch_bwd = _TC_LAUNCHES[route]
    # mapped, unmapped, unmapped, mapped: each time the mean of its two
    for tag, heads in (("mapped", (HEADS, hl)), ("unmapped", (None, 0)),
                       ("unmapped", (None, 0)), ("mapped", (HEADS, hl))):
        a = (seed, scale, RATE, *heads)
        out, lse = launch_fwd(*part[:4], *a)
        fwd = cuda_ms(lambda: launch_fwd(*part[:4], *a), iters=50)
        bwd = cuda_ms(lambda: launch_bwd(*part, out, lse, *a), iters=50)
        del out, lse
        times.setdefault(f"{tag}_fwd_ms", []).append(fwd)
        times.setdefault(f"{tag}_bwd_ms", []).append(bwd)
    res.update({k: sum(v) / len(v) for k, v in times.items()})
    log(f"[mesh] (c) attention L={L} D={D} {str(dtype)[6:]} rate={RATE} "
        f"({ROUTE_WORDS[route]} kernels), heads h0..h0+{hl} of {HEADS} for h0 in "
        f"(0, {hl}): out, dqu, dk, dv, dbias identical to the full launch's head slice; "
        f"against the plain version max abs {plain_err:.2e} (tol rel {tol}); fwd "
        f"{res['mapped_fwd_ms']:.4f} ms with (H, h0), {res['unmapped_fwd_ms']:.4f} ms "
        f"unsharded; bwd {res['mapped_bwd_ms']:.4f} / {res['unmapped_bwd_ms']:.4f} ms")
    return res


def _sharded_dropout(gen):
    """The dropout kernel on each half of the columns with (row_local,
    row_total, col_offset), forward and gradient, against the full launch's
    column slice and the plain version bit for bit; timed beside the
    unsharded launch of the same half."""
    from sarssl_torch.kernels import dropout_plain, hash_dropout, launches
    from sarssl_torch.kernels.dropout import launch_dropout

    seed = 0x9E3779B9
    x = torch.randn(MESH_DROP_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn_like(x)
    full = hash_dropout(x, seed, RATE)
    full_g = hash_dropout(g, seed, RATE)
    cols = x.shape[-1]
    w = cols // 2
    err = 0.0
    for c0 in (0, w):
        xs = x[..., c0:c0 + w].contiguous()
        imap = (w, cols, c0)
        xr = xs.clone().requires_grad_()
        before = launches["hash_dropout"]
        out = hash_dropout(xr, seed, RATE, imap)
        (grad,) = torch.autograd.grad(out, xr, g[..., c0:c0 + w].contiguous())
        assert launches["hash_dropout"] - before == 2, "sharded dropout: launches"
        ref = dropout_plain(xs, seed, RATE, imap)
        for name, a, b in (("out", out, full[..., c0:c0 + w]), ("grad", grad,
                                                                 full_g[..., c0:c0 + w]),
                           ("plain", out, ref)):
            assert torch.equal(a, b), f"sharded dropout cols {c0}+{w}: {name} differs"
            err = max(err, max_abs(a, b))
    xs = x[..., w:].contiguous()
    n = xs.numel()
    mapped = lambda: launch_dropout(xs, seed, RATE, (w, cols, w))  # noqa: E731
    unmapped = lambda: launch_dropout(xs, seed, RATE)  # noqa: E731
    # mapped, unmapped, unmapped, mapped: each time the mean of its two
    t = [cuda_ms(fn, iters=50) for fn in (mapped, unmapped, unmapped, mapped)]
    res = {"max_abs_err": err, "mapped_ms": (t[0] + t[3]) / 2, "unmapped_ms": (t[1] + t[2]) / 2,
           "plain_ms": cuda_ms(lambda: dropout_plain(xs, seed, RATE, (w, cols, w))),
           "library_ms": cuda_ms(lambda: torch.nn.functional.dropout(xs, RATE, True)),
           "bound": bound_ms(2 * n * 2, 14 * n, F32_FLOPS)}
    log(f"[mesh] (c) hash_dropout {tuple(xs.shape)} bf16 rate={RATE}, columns c0..c0+{w} of "
        f"{cols} for c0 in (0, {w}): output, gradient and the plain version identical to the "
        f"full launch's column slice; {res['mapped_ms']:.4f} ms with the index map, "
        f"{res['unmapped_ms']:.4f} ms unsharded (plain {res['plain_ms']:.4f}, F.dropout "
        f"{res['library_ms']:.4f}, bound {res['bound'][0]:.4f})")
    return res


def check_index_maps():
    """mesh (c): every index-mapped launch against its full launch's slice
    and its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    att = {shape: _sharded_attention(shape[1], shape[2], shape[0], gen)
           for shape in MESH_ATTENTION_SHAPES}
    torch.cuda.empty_cache()
    return att, _sharded_dropout(gen)


def phase_card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN (torch.backends.*.allow_tf32 = False)")
    return smi.splitlines()[0]


TENSOR_CORE_SOURCES = ("attention_mma", "attention_f32_mma", "attention_f32_mma_psum",
                       "conv3x3_mma", "conv3x3_any_mma", "conv3x3_any_mma_groups",
                       "conv3x3_tf32", "conv3x3_tf32_groups")


def phase_build():
    from sarssl_torch.kernels._build import CSRC_DIR, build_all, built_library, cuda_tool

    t0 = time.perf_counter()
    logs = build_all()
    log(f"[build] {len(logs)} CUDA source(s) from {CSRC_DIR.name}/ in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                if name not in TENSOR_CORE_SOURCES:  # reported per kernel below
                    log(f"  {name}: {line.strip()}")
    for name in TENSOR_CORE_SOURCES:
        report_tensor_core_kernels(name, logs[name])
    cuobjdump = cuda_tool("cuobjdump")
    assert cuobjdump is not None, "no cuobjdump in the CUDA toolkit: SASS not inspected"
    for name in TENSOR_CORE_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(built_library(name))],
                              capture_output=True, text=True, check=True).stdout
        lines = sass.splitlines()
        n_mma = sum("HMMA." in line or "HGMMA." in line for line in lines)
        n_ldsm, n_cp = sass.count("LDSM"), sass.count("LDGSTS")
        log(f"[build] {name} SASS: {n_mma} HMMA/HGMMA (tensor-core), {n_ldsm} LDSM "
            f"(ldmatrix), {n_cp} LDGSTS (cp.async) instructions")
        assert n_mma > 0, f"no tensor-core instruction in the built {name} library"


def _tensor_core_kernel(source, line):
    """(label, threads a block, dynamic shared memory) of the kernel that a
    ptxas 'Compiling entry function' line names, or None."""
    if source in ("attention_mma", "attention_f32_mma", "attention_f32_mma_psum"):
        from sarssl_torch.kernels.attention import mma_smem_bytes, tf32_smem_bytes

        threads = {"attn_fwd_mma": 128, "attn_bwd_mma": 128, "attn_dqu_mma": 128,
                   "attn_delta": 256, "attn_fwd_tf32": 128, "attn_bwd_tf32": 128,
                   "attn_dqu_tf32": 128, "attn_delta_f32": 256,
                   "attn_delta_wide": 256, "attn_delta_wide_f32": 256}
        # each kernel's instance for whole tiles (exact = 1) and for any L; the
        # wide instance's kernels are templated on their column width (the
        # streamed chunk's or the output's) and the products on A x / A^T x;
        # the f32 ones that sum over L also on partial sums past a length;
        # their column tails (_cols) on the bytes a row's piece takes
        entry = re.search(r"Compiling entry function '.*?(attn_[a-z0-9_]+?)ILi(\d+)E"
                          r"((?:Lb[01]E)+)(?:Li(\d+)E)?", line)
        if entry:
            name, D = entry.group(1), int(entry.group(2))
            base = name.replace("_cols", "")  # the tail's instances share their kernel's tiles
            flags = [f == "1" for f in re.findall(r"Lb([01])E", entry.group(3))]
            exact = flags[0]
            smem = (mma_smem_bytes(base, D, exact) if source == "attention_mma"
                    else tf32_smem_bytes(base, D))
            trans = (", A^T x" if flags[1] else ", A x") if "prod" in name else ""
            psum = ", partial sums" if source.startswith("attention_f32") and flags[-1] and len(
                flags) == (3 if "prod" in name else 2) else ""
            tail = f", column tail in {entry.group(4)}-byte pieces" if entry.group(4) else ""
            return (f"{name}<{D}, {'exact' if exact else 'any L'}{trans}{psum}{tail}>",
                    threads.get(base, 128), smem)
    elif source in ("conv3x3_any_mma", "conv3x3_any_mma_groups"):
        from sarssl_torch.kernels.conv3x3 import any_mma_smem_bytes

        entry = re.search(r"Compiling entry function '.*?conv3x3_any_mma_(groups_)?kernel"
                          r"ILi(\d+)ELi(\d+)E", line)
        if entry:
            groups, nb, kt = bool(entry.group(1)), int(entry.group(2)), int(entry.group(3))
            return (f"conv3x3_any_mma_{'groups_' if groups else ''}kernel<{nb}, {kt}>", 256,
                    any_mma_smem_bytes(nb, groups))
    elif source in ("conv3x3_tf32", "conv3x3_tf32_groups"):
        from sarssl_torch.kernels.conv3x3 import tf32_smem_bytes

        entry = re.search(r"Compiling entry function '.*?conv3x3_tf32_(groups_)?kernel"
                          r"ILi(\d+)ELi(\d+)E", line)
        if entry:
            groups, nb, kt = bool(entry.group(1)), int(entry.group(2)), int(entry.group(3))
            return (f"conv3x3_tf32_{'groups_' if groups else ''}kernel<{nb}, {kt}>", 256,
                    tf32_smem_bytes(nb, groups))
    else:
        from sarssl_torch.kernels.conv3x3 import mma_smem_bytes

        entry = re.search(r"Compiling entry function '.*?conv3x3_mma_kernel"
                          r"ILi(\d+)ELi(\d+)ELi(\d+)E", line)
        if entry:
            args = [int(g) for g in entry.groups()]
            return (f"conv3x3_mma_kernel<{', '.join(map(str, args))}>", 256,
                    mma_smem_bytes(*args))
    return None


def report_tensor_core_kernels(source, ptxas_log):
    """Per kernel of a tensor-core source, from ptxas' report: registers a
    thread, spills, dynamic shared memory a block and the blocks per SM these
    allow. Fails if a kernel spills."""
    kernel, stack = None, 0
    if not ptxas_log:
        log(f"  {source}: built before this run, no ptxas report")
    for line in ptxas_log.splitlines():
        kernel = _tensor_core_kernel(source, line) or kernel
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if spill and kernel:
            assert spill.groups()[1:] == ("0", "0"), f"{kernel[0]} spills: {line.strip()}"
            stack = int(spill.group(1))
        used = re.search(r"Used (\d+) registers", line)
        if used and kernel:
            label, threads, smem = kernel
            regs = int(used.group(1))
            # an SM has 65536 registers and 233472 bytes of shared memory, of
            # which each resident block reserves 1024 beside its own
            blocks = min(65536 // (regs * threads), 233472 // (smem + 1024))
            log(f"  {source} {label}: {regs} registers, no spills, {stack} B stack, {smem} B "
                f"shared memory, {threads} threads -> {blocks} blocks/SM")
            kernel = None


def cuda_ms_queued(fn, iters=20, warmup=3, tries=4):
    """Device ms a call of ``fn`` with the launches queued behind a sleeping
    kernel, so the host's launch time (tens of microseconds for a Triton
    launch) does not gap a kernel shorter than it. A window in which the card
    passed the sleeping kernel before the host had queued the last launch (a
    pause of the host longer than the sleep) may hold the host's gaps: it is
    logged with its reading and taken again, up to ``tries`` windows, and the
    last one's reading is kept if every window drained (``tries=1``: a call
    that outlasts the sleep, kept without a word)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clock
        start.record()
        for _ in range(iters):
            fn()
        drained = start.query()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        if not drained or tries == 1:
            return ms
        log(f"  queued window {attempt} of {tries} drained before its last launch was "
            f"queued: {ms:.4f} ms a call, {'taken again' if attempt < tries else 'kept'}")
    return ms


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_readings(fn, iters=20, windows=5):
    """A short call's three readings: ``ms``, the median of ``windows``
    back-to-back windows of ``iters`` calls (:func:`cuda_ms`, the host's
    issue time in it); ``queued_ms``, the device ms a call with the calls
    queued behind a sleeping kernel (:func:`cuda_ms_queued`); ``host_us``,
    the host's microseconds to issue a call, the median of ``windows``
    windows timed while the card sleeps (so no call waits for the card)."""
    fn()
    ms = statistics.median(cuda_ms(fn, iters=iters, warmup=0) for _ in range(windows))
    host = []
    for _ in range(windows):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            fn()
        host.append((time.perf_counter_ns() - t0) / iters / 1e3)
        torch.cuda.synchronize()
    return {"ms": ms, "queued_ms": cuda_ms_queued(fn, iters=iters),
            "host_us": statistics.median(host)}


def host_split(fn, lib, entry, iters=20, windows=5):
    """Where the host's time of a conv wrapper call ``fn`` goes:
    ``c_entry_us``, the ctypes call of ``lib``'s C entry ``entry`` (argument
    conversion, the entry's checks and its launches), timed inside the call;
    ``ctypes_us``, the same call made to return at its first check (N = 0:
    conversion and return alone), so ``launch_us``, their difference, is the
    entry's launches and set-up; each the median of ``windows`` windows of
    ``iters`` calls; and ``launches``, the kernel launches a call makes
    (:func:`launches_a_call`). The entry takes either (x, w, wp, y, N, H, W,
    C, Cout, NB, rot, G, stream) or (x, w, wp, y, call, stream) with call
    pointing at those eight ints."""
    import ctypes

    real = getattr(lib, entry)
    zero_call = (ctypes.c_int * 8)()
    spent, dry = [], []

    def timed(*a):
        t0 = time.perf_counter_ns()
        code = real(*a)
        t1 = time.perf_counter_ns()
        a = list(a)
        a[3 if len(a) == 9 else 4] = 0 if len(a) > 6 else ctypes.addressof(zero_call)
        t2 = time.perf_counter_ns()
        assert real(*a) != 0, "the entry took N = 0"
        dry.append(time.perf_counter_ns() - t2)
        spent.append(t1 - t0)
        return code

    setattr(lib, entry, timed)
    try:
        fn()
        per_window = []
        for _ in range(windows):
            spent.clear()
            dry.clear()
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)
            for _ in range(iters):
                fn()
            per_window.append((sum(spent) / len(spent) / 1e3, sum(dry) / len(dry) / 1e3))
            torch.cuda.synchronize()
    finally:
        setattr(lib, entry, real)
    c_entry = statistics.median(w[0] for w in per_window)
    ctypes_us = statistics.median(w[1] for w in per_window)
    return {"c_entry_us": c_entry, "ctypes_us": ctypes_us, "launch_us": c_entry - ctypes_us,
            "launches": launches_a_call(fn)}


def launches_a_call(fn, calls=3):
    """The kernel launches one call of ``fn`` makes, by torch.profiler: the
    launch calls of the CUDA APIs (``cudaLaunch*``, ``cuLaunch*``) among its
    CPU events, the most any of ``calls`` calls, each profiled
    alone."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.name.startswith(("cudaLaunch", "cuLaunch")) for e in prof.events()))
    return most


def rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def max_abs(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def bound_ms(nbytes, ops, rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _attention_inputs(D, dtype, gen, L=SEQ, B=BATCH):
    shape = (B, HEADS, L, D)
    qu, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    bias = torch.randn((B, HEADS, L, L), generator=gen, device="cuda").to(dtype)
    return qu, k, v, bias, g


# the attention routes (kernels/attention.py::attention_route): their
# launch-count tags and the words the log gives them; "fma" tags the FMA
# kernels' launches, which no route takes (they are launched directly)
ROUTE_TAGS = {"tc": "tc_", "tf32x3": "tf32x3_", "fma": "fma_"}
ROUTE_WORDS = {"tc": "bf16 tensor-core", "tf32x3": "3xTF32 tensor-core"}
ROUTE_SOURCES = {"tc": "attention_mma.cu", "tf32x3": "attention_f32_mma.cu"}
ROUTE_DTYPES = {"tc": torch.bfloat16, "tf32x3": torch.float32}


def _runs_wide(route, kind, Dp):
    """Whether pass ``kind`` of ``route`` runs the wide instance at the
    padded head dim Dp (``attention_instance``: from 256 on, but for the
    bf16 forward's D = 256 instance)."""
    if Dp < 256:  # (FLAGSHIP_ATTENTION asks at import, before the package is needed)
        return False
    from sarssl_torch.kernels.attention import attention_instance

    return attention_instance(ROUTE_DTYPES[route], kind, Dp) == "wide"


def _route_launches(D, route):
    """(names, want): the attention launch counts one forward and backward on
    ``route`` raises by one (each pass at the head dim it runs at,
    ``attention_pass_head_dim``: D itself, or where the pass pads D padded to
    the next of 16 / 32 / 64 / 128 / 256, past 256 to the next multiple of
    64, which also counts as ``..._padded_d{Dp}``; a pass on the wide
    instance also counts as ``..._wide_d{D}``), and the other routes' counts,
    which stay (the FMA kernels' among them: ``fused_attention`` never
    launches those)."""
    from sarssl_torch.kernels.attention import (attention_instance_at, attention_pass_head_dim,
                                                padded_head_dim)

    names, want = [], []
    for kind in ("fwd", "bwd"):
        for r, tag in (("", ""), *ROUTE_TAGS.items()):
            dtype = ROUTE_DTYPES.get(r, ROUTE_DTYPES[route])
            Dk = attention_pass_head_dim(dtype, kind, D)
            names.append(f"attention_{kind}_{tag}d{Dk}")
            want.append(int(r in ("", route)))
            if r in ("tc", "tf32x3"):
                names += [f"attention_{kind}_{tag}wide_d{Dk}",
                          f"attention_{kind}_{tag}padded_d{padded_head_dim(D)}"]
                want += [int(r == route and attention_instance_at(dtype, kind, Dk) == "wide"),
                         int(r == route and Dk != D)]
    return names, want


def _fma_launches(counts):
    """The FMA kernels' launches among ``counts``: a model phase has none."""
    return {k: v for k, v in counts.items() if re.fullmatch(r"attention_(fwd|bwd)_fma_d\d+", k)
            and v}


def _vanishing_errors(qu, k, v, g, args, grads, ref_grads):
    """At L = 1 the softmax of one score is constant: dqu, dk and dbias of
    the plain version vanish up to f32 rounding, and the kernel's are the
    rounding of out (delta = g . out) left in ds = p (dp - delta). Each
    is measured against the terms that cancel there, ``scale * max |g . v| /
    (1 - rate)`` (times max |k| for dqu, max |qu| for dk); dv against its own
    max."""
    _, scale, rate = args
    qu, k, v, g = (t.detach().float() for t in (qu, k, v, g))
    cancel = scale * float((g * v).sum(-1).abs().max()) / (1.0 - rate)
    dqu, dk, dv, dbias = grads
    rdqu, rdk, rdv, rdbias = ref_grads
    return [max_abs(dqu, rdqu) / (cancel * float(k.abs().max())),
            max_abs(dk, rdk) / (cancel * float(qu.abs().max())),
            rel_err(dv, rdv), max_abs(dbias, rdbias) / cancel]


def check_attention(D, dtype, rate, seed, gen, L=SEQ, B=BATCH):
    """Kernel (fwd + bwd) against the plain version in f32; returns errors."""
    from sarssl_torch.kernels import (attention_plain, fused_attention, hash_keep_mask,
                                      launches)
    from sarssl_torch.kernels.attention import attention_route

    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, g = _attention_inputs(D, dtype, gen, L, B)
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    route = attention_route(dtype, L, D)
    names, want = _route_launches(D, route)
    before = [launches[n] for n in names]
    out = fused_attention(*xs, seed, scale, rate)
    grads = torch.autograd.grad(out, xs, g)
    rose = [launches[n] - b for n, b in zip(names, before)]
    assert rose == want, f"attention L={L} D={D} {dtype}: launches {rose}, want {want}"
    ys = [t.float().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, seed, scale, rate)
    ref_grads = torch.autograd.grad(ref, ys, g.float())
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    errs = {"out": (rel_err(out, ref), max_abs(out, ref))}
    rels = ([rel_err(a, b) for a, b in zip(grads, ref_grads)] if L > 1 else
            _vanishing_errors(qu, k, v, g, (seed, scale, rate), grads, ref_grads))
    for name, a, b, rel in zip(("dqu", "dk", "dv", "dbias"), grads, ref_grads, rels):
        errs[name] = (rel, max_abs(a, b))
    assert out.shape == qu.shape, f"attention L={L} D={D}: out {tuple(out.shape)}"
    torch.cuda.synchronize()
    for name, (rel, _) in errs.items():
        assert rel <= tol, (f"attention L={L} D={D} {dtype} rate={rate}: {name} rel err "
                            f"{rel} > {tol}")
    if rate > 0:
        # the kernel's dropped positions: with v = identity columns, out = pd
        keep = hash_keep_mask(B * HEADS * L * L, seed, rate, "cuda").reshape(B, HEADS, L, L)
        eye = torch.eye(L, device="cuda", dtype=dtype)
        # w = min(D, L) columns at a time (the rest of v zero), the last block
        # ending at column L (it overlaps the one before where w does not
        # divide L)
        w = min(D, L)
        for c0 in sorted(set(range(0, L - w + 1, w)) | {L - w}):
            basis = torch.zeros((L, D), device="cuda", dtype=dtype)
            basis[:, :w] = eye[:, c0:c0 + w]
            basis = basis.expand(B, HEADS, L, D).contiguous()
            pd = fused_attention(qu, k, basis, bias, seed, scale, rate)[..., :w]
            same = torch.equal(pd != 0, keep[..., c0:c0 + w])
            assert same, (f"attention L={L} D={D} {dtype}: dropped positions differ from "
                          f"the plain mask")
    log(f"[kernels] attention L={L} D={D} {str(dtype)[6:]} rate={rate}"
        + (f" B={B}" if B != BATCH else "") + ": " + ", ".join(
        f"{n} rel {r:.2e} abs {a:.2e}" for n, (r, a) in errs.items())
        + (" ; dropped positions identical" if rate > 0 else "")
        + f" (tol {tol}; {ROUTE_WORDS[route]} kernels)")
    return max(a for _, a in errs.values()), max(a for n, (_, a) in errs.items() if n == "out")


def time_attention(D, seed, gen):
    """Times of fwd and bwd at the step's shape (bf16, rate 0.1): the
    tensor-core kernels, and the FMA kernels they replaced there."""
    from sarssl_torch.kernels.attention import (launch_attention_bwd_fma,
                                                launch_attention_bwd_mma,
                                                launch_attention_fwd_fma,
                                                launch_attention_fwd_mma)

    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, g = _attention_inputs(D, torch.bfloat16, gen)
    args = (seed, scale, RATE)
    out, lse = launch_attention_fwd_mma(qu, k, v, bias, *args)
    res = {}
    # new, old, old, new: both sets on the same card in the same run
    res["fwd_ms"] = cuda_ms_queued(lambda: launch_attention_fwd_mma(qu, k, v, bias, *args))
    res["fma_fwd_ms"] = cuda_ms_queued(lambda: launch_attention_fwd_fma(qu, k, v, bias, *args))
    res["fma_bwd_ms"] = cuda_ms_queued(lambda: launch_attention_bwd_fma(qu, k, v, bias, g, *args))
    res["bwd_ms"] = cuda_ms_queued(lambda: launch_attention_bwd_mma(qu, k, v, bias, g, out, lse, *args))
    del out, lse
    res.update(_attention_yardsticks(qu, k, v, bias, g, seed, scale))
    return res


def _attention_yardsticks(qu, k, v, bias, g, seed, scale):
    """Times of the plain version and of SDPA (fwd, bwd) on these inputs, and
    the bounds of the fused function at their shape and dtype."""
    from sarssl_torch.kernels import attention_plain

    res = {}
    with torch.no_grad():
        # its 20 calls (~6 ms each) outlast the sleep, so the card passes the
        # sleeping kernel before the host has queued them all: one window, kept
        res["plain_fwd_ms"] = cuda_ms_queued(
            lambda: attention_plain(qu, k, v, bias, seed, scale, RATE), tries=1)
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    out = attention_plain(*xs, seed, scale, RATE)
    res["plain_bwd_ms"] = cuda_ms_queued(lambda: torch.autograd.grad(out, xs, g, retain_graph=True))
    del out
    # library yardstick (never called by the port): SDPA with the bias as a
    # float mask, rate 0
    mask = bias * scale
    with torch.no_grad():
        res["lib_fwd_ms"] = cuda_ms_queued(lambda: torch.nn.functional.scaled_dot_product_attention(
            qu, k, v, attn_mask=mask, scale=scale))
    ys = [t.clone().requires_grad_() for t in (qu, k, v, mask)]
    out = torch.nn.functional.scaled_dot_product_attention(*ys[:3], attn_mask=ys[3], scale=scale)
    res["lib_bwd_ms"] = cuda_ms_queued(lambda: torch.autograd.grad(out, ys, g, retain_graph=True))
    del out
    B, H, L, D = qu.shape
    es = qu.element_size()
    # bf16: the tensor rate; f32: three TF32 products a product at the TF32
    # rate, the least time f32-accurate products take on this card
    rate, split = (BF16_FLOPS, 1) if qu.dtype == torch.bfloat16 else (TF32_FLOPS, TF32_SPLIT)
    n_qkv, n_s = B * H * L * D, B * H * L * L
    res["fwd_bound"] = bound_ms((4 * n_qkv + n_s) * es, split * 4 * n_s * D, rate)
    # reads qu k v g bias, writes dqu dk dv dbias; 5 products of 2*L*L*D each
    # (the saved out and row statistics that the kernels also read are left
    # out: the function needs no more than the nine tensors above)
    res["bwd_bound"] = bound_ms((8 * n_qkv + 2 * n_s) * es, split * 10 * n_s * D, rate)
    return res


# attention shapes the model's options bring (phase model_options), at the
# flagship batch and heads: (L, D, dtype). L = 257: the CLS token at both
# widths; L = 512: in_ver="single_ch_each_patch" (the spec encoder at d = 256,
# D = 64, the spat encoder at d = 128, D = 32); all bf16, on the tensor cores.
# Then the f32 route (3xTF32 tensor cores): at L = 512 and at the flagship's
# L = 256 (phase model_options' variant (l) runs the last two). Last, head
# dim 16 (a d_model of 64; the small models of phase ref, and through the
# padding the tiny one's 8 and 4) at the flagship batch and L in both dtypes.
# Then head dim 256 (spec_dembed=1024: phase model_options' variant (m)) in
# both dtypes, which the FMA kernels have no instance of, and head dim 512 on
# the wide instance (spec_dembed=2048: variant (n)).
OPTION_ATTENTION_SHAPES = ((257, 128, torch.bfloat16), (257, 64, torch.bfloat16),
                           (512, 64, torch.bfloat16), (512, 32, torch.bfloat16),
                           (512, 64, torch.float32), (256, 128, torch.float32),
                           (256, 64, torch.float32), (256, 16, torch.bfloat16),
                           (256, 16, torch.float32), (256, 256, torch.bfloat16),
                           (256, 256, torch.float32), (256, 512, torch.bfloat16),
                           (256, 512, torch.float32))
# (L, D) of the bf16 shapes whose tensor-core launches took over from the FMA
# kernels: each launch, forward and backward, at least this many times faster
# than the FMA kernel at its shape in the same run
FMA_FLOOR_SHAPES = ((257, 128), (257, 64), (512, 32))
ATTENTION_FMA_FLOOR = 4.0
# the f32 shapes' 3xTF32 launches against the FMA kernels they replaced
F32_FMA_FLOOR = 2.0
# f32 shapes held against the plain version (not timed): a ragged tail, the
# CLS token's L and one past the FMA kernels' 704, at every tensor-core D
F32_CHECK_LENGTHS = (64, 257, 768)
# head dim 16's launches, forward and backward in both dtypes, against the
# FMA kernels at its shape in the same run (the FMA kernels' row blocks hold
# little at D = 16, so the floor is lower than the other shapes')
D16_FMA_FLOOR = 1.5
# head dim 16 held against the plain version (not timed) at tails of 1 and
# 33 rows, the CLS token's L and two past the FMA kernels' 704, both dtypes
D16_CHECK_LENGTHS = (1, 33, 257, 768, 1000)
# head dims that are no instance's, held against the plain version through
# the padding (at L = 256, both dtypes); the first also timed padded. 200
# runs the D = 256 instances.
PADDED_HEAD_DIMS = (8, 48, 200)
# head dim 256 held against the plain version (not timed) at tails of 1 and
# 33 rows, whole tiles, the CLS token's L and a long 768, both dtypes
D256_CHECK_LENGTHS = (1, 33, 256, 257, 768)
# the wide instance (every head dim past 256): D = 512 at the flagship batch
# also at the CLS token's tail L = 257 (not timed); at a batch of WIDE_B a head
# dim that is no multiple of its chunk (300, padded to 320, which runs blocks of
# 64 columns) and one past 1000 (padded to 1024, blocks of 128), held at L =
# 1, 33, 257 and 256 and timed at 256, both dtypes; at that batch the forward's
# scores pass splits its key tiles over blocks, timed also at one split
WIDE_B = 8
WIDE_SMALL_HEAD_DIMS = (300, 1000)
WIDE_CHECK_LENGTHS = (1, 33, 257, SEQ)


def time_attention_route(L, D, dtype, seed, gen, B=BATCH):
    """Times of fwd and bwd on the tensor-core route ``fused_attention`` takes
    at this shape (rate 0.1), beside the FMA kernels launched directly (new,
    old, old, new; None at D >= 256, which they have no instance of), the
    plain version, SDPA and the bound. Each pass runs as the model's calls
    do: at ``attention_pass_head_dim``, through ``attention_fwd_padded`` /
    ``attention_bwd_padded`` where it pads; where a pass runs unpadded on the
    wide instance (its column tail) it is also timed through the padding
    (``padded_fwd_ms`` / ``padded_bwd_ms``, the route before the column
    tail)."""
    from sarssl_torch.kernels.attention import (_TC_LAUNCHES, FMA_HEAD_DIMS, attention_bwd_padded,
                                                attention_fwd_padded, attention_pass_head_dim,
                                                attention_route, launch_attention_bwd_fma,
                                                launch_attention_fwd_fma)

    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, g = _attention_inputs(D, dtype, gen, L, B)
    args = (seed, scale, RATE)
    route = attention_route(dtype, L, D)
    res = {"route": route, "fma_fwd_ms": None, "fma_bwd_ms": None, "padded_fwd_ms": None,
           "padded_bwd_ms": None}
    fwd, bwd = _TC_LAUNCHES[route]
    Df, Db = (attention_pass_head_dim(dtype, kind, D) for kind in ("fwd", "bwd"))
    res["Dp"], res["Db"] = Df, Db
    _, lse, padded = attention_fwd_padded(fwd, qu, k, v, bias, *args)
    out = fwd(qu, k, v, bias, *args)[0] if Df == D else padded[3][..., :D]
    fwd_call = ((lambda: fwd(qu, k, v, bias, *args)) if Df == D else
                (lambda: attention_fwd_padded(fwd, qu, k, v, bias, *args)))
    bwd_call = ((lambda: bwd(qu, k, v, bias, g, out, lse, *args)) if Db == D else
                (lambda: attention_bwd_padded(bwd, padded, bias, g, lse, *args)))
    res["fwd_ms"] = cuda_ms_queued(fwd_call)
    if D in FMA_HEAD_DIMS:
        res["fma_fwd_ms"] = cuda_ms_queued(
            lambda: launch_attention_fwd_fma(qu, k, v, bias, *args))
        res["fma_bwd_ms"] = cuda_ms_queued(
            lambda: launch_attention_bwd_fma(qu, k, v, bias, g, *args))
    res["bwd_ms"] = cuda_ms_queued(bwd_call)
    if Df == D != padded[0].shape[-1]:
        res["padded_fwd_ms"] = cuda_ms_queued(
            lambda: attention_fwd_padded(fwd, qu, k, v, bias, *args))
    if Db == D != padded[0].shape[-1]:
        res["padded_bwd_ms"] = cuda_ms_queued(
            lambda: attention_bwd_padded(bwd, padded, bias, g, lse, *args))
    del padded, lse, out
    res.update(_attention_yardsticks(qu, k, v, bias, g, seed, scale))
    return res


def time_padded_attention(D, dtype, seed, gen):
    """What the padding costs at head dim D (not an instance's): fwd and bwd
    through ``attention_fwd_padded`` / ``attention_bwd_padded`` (pad, launch
    at the next instance's head dim, slice) beside the same launches on
    inputs padded beforehand, queued, at the flagship batch, L = 256, rate
    0.1."""
    from sarssl_torch.kernels.attention import (_TC_LAUNCHES, attention_bwd_padded,
                                                attention_fwd_padded, attention_route)

    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, g = _attention_inputs(D, dtype, gen)
    args = (seed, scale, RATE)
    fwd, bwd = _TC_LAUNCHES[attention_route(dtype, SEQ, D)]
    _, lse, padded = attention_fwd_padded(fwd, qu, k, v, bias, *args)
    qu_p, k_p, v_p, out_p = padded
    g_p = torch.nn.functional.pad(g, (0, qu_p.shape[-1] - D))
    res = {"Dp": qu_p.shape[-1]}
    res["fwd_ms"] = cuda_ms_queued(lambda: attention_fwd_padded(fwd, qu, k, v, bias, *args))
    res["launch_fwd_ms"] = cuda_ms_queued(lambda: fwd(qu_p, k_p, v_p, bias, *args))
    res["launch_bwd_ms"] = cuda_ms_queued(lambda: bwd(qu_p, k_p, v_p, bias, g_p, out_p, lse,
                                                      *args))
    res["bwd_ms"] = cuda_ms_queued(lambda: attention_bwd_padded(bwd, padded, bias, g, lse, *args))
    return res


def check_wide_at_256(seed, gen):
    """The bf16 wide forward launched at D = 256 (``_wide_launches``; the
    route runs the D = 256 instance there, the one pass at 256 with two
    instances) on the flagship batch and L, rate 0.1, held against the plain
    version (errors against the largest value, dropped positions those of the
    plain mask with v = the identity), then timed beside the D = 256 instance
    on the same inputs: instance, wide, wide, instance. Returns the errors and
    the four readings."""
    from sarssl_torch.kernels import attention_plain, hash_keep_mask, launches
    from sarssl_torch.kernels.attention import _wide_launches, launch_attention_fwd_mma

    D, dtype = 256, torch.bfloat16
    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, _ = _attention_inputs(D, dtype, gen)
    wide_fwd, args = _wide_launches("tc"), (seed, scale, RATE)
    # the wide count rises, the D = 256 instance's stay
    names = [f"attention_fwd_{t}d256" for t in ("tc_wide_", "tc_", "")]
    before = [launches[n] for n in names]
    out, _ = wide_fwd(qu, k, v, bias, *args)
    rose = [launches[n] - b for n, b in zip(names, before)]
    assert rose == [1, 0, 0], f"the wide forward at D=256: {names} rose {rose}"
    ref = attention_plain(*(t.float() for t in (qu, k, v, bias)), *args)
    err = (rel_err(out, ref), max_abs(out, ref))
    assert err[0] <= TOL_BF16, f"the wide forward at D=256: out rel err {err[0]} > {TOL_BF16}"
    eye = torch.eye(SEQ, device="cuda", dtype=dtype).expand(BATCH, HEADS, SEQ, D).contiguous()
    pd = wide_fwd(qu, k, eye, bias, *args)[0]
    keep = hash_keep_mask(BATCH * HEADS * SEQ * SEQ, seed, RATE, "cuda").reshape(pd.shape)
    assert torch.equal(pd != 0, keep), "the wide forward at D=256: dropped positions"
    del ref, pd, eye, keep, out
    inst1 = cuda_ms_queued(lambda: launch_attention_fwd_mma(qu, k, v, bias, *args))
    wide1 = cuda_ms_queued(lambda: wide_fwd(qu, k, v, bias, *args))
    wide2 = cuda_ms_queued(lambda: wide_fwd(qu, k, v, bias, *args))
    inst2 = cuda_ms_queued(lambda: launch_attention_fwd_mma(qu, k, v, bias, *args))
    res = {"max_abs_err": err[1], "out_err": err[1], "fwd_ms": (wide1 + wide2) / 2,
           "fwd_readings": (wide1, wide2), "inst_fwd_readings": (inst1, inst2)}
    log(f"[kernels] attention L={SEQ} D=256 bfloat16 rate={RATE}, the forward on the wide "
        f"instance (_wide_launches): out rel {err[0]:.2e} abs {err[1]:.2e} (tol {TOL_BF16}); "
        f"dropped positions identical; {wide1:.4f} / {wide2:.4f} ms beside the D=256 "
        f"instance's {inst1:.4f} / {inst2:.4f} (instance, wide, wide, instance)")
    return res


def profile_wide(dtype, seed, gen, D=512, launches=3):
    """Device ms a launch of each kernel of the wide instance's forward and
    backward at (B, H, L, D) = (128, 4, 256, D), rate 0.1, from a
    torch.profiler trace of ``launches`` launches of each; logged."""
    from sarssl_torch.kernels.attention import _TC_LAUNCHES, attention_route

    qu, k, v, bias, g = _attention_inputs(D, dtype, gen)
    fwd, bwd = _TC_LAUNCHES[attention_route(dtype, SEQ, D)]
    args = (seed, 1.0 / np.sqrt(HEADS * D), RATE)
    out, lse = fwd(qu, k, v, bias, *args)
    bwd(qu, k, v, bias, g, out, lse, *args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(launches):
            fwd(qu, k, v, bias, *args)
            bwd(qu, k, v, bias, g, out, lse, *args)
        torch.cuda.synchronize()
    per = {}
    for evt in prof.events():
        name = re.search(r"attn_\w+(<[^>]*>)?", evt.name)  # the products: A x or A^T x
        if evt.device_type == torch.autograd.DeviceType.CUDA and name:
            per[name.group(0)] = per.get(name.group(0), 0.0) + evt.device_time_total / 1e3
    if not per:
        log(f"[kernels] the wide instance at D={D} {str(dtype)[6:]}: the profiler recorded no "
            f"device time")
        return
    log(f"[kernels] the wide instance at (128, 4, {SEQ}, {D}) {str(dtype)[6:]} rate={RATE}, "
        f"device ms a launch by kernel (torch.profiler, {launches} launches): " + ", ".join(
            f"{n} {ms / launches:.4f}" for n, ms in per.items()))


def time_wide_splits(D, dtype, seed, gen):
    """The wide forward at a batch of WIDE_B, L = 256, rate 0.1, launched at
    D's padded head dim on inputs padded beforehand: at the key splits S the
    launcher chooses (its split launch counted) and at S = 1, each held
    against the plain version, then timed queued: chosen, 1, 1, chosen.
    Returns S and the readings."""
    from sarssl_torch.kernels import attention_plain, launches
    from sarssl_torch.kernels.attention import (_launch_fwd, _sm_count, _wide_blocks,
                                                attention_route, padded_head_dim,
                                                wide_key_splits)

    Dp = padded_head_dim(D)
    qu, k, v, bias, _ = _attention_inputs(Dp, dtype, gen, SEQ, WIDE_B)
    route = attention_route(dtype, SEQ, Dp)
    args = (seed, 1.0 / np.sqrt(HEADS * D), RATE)
    S = wide_key_splits(SEQ, WIDE_B * HEADS, _sm_count(torch.cuda.current_device()),
                        _wide_blocks(route, True))
    ref = attention_plain(*(t.float() for t in (qu, k, v, bias)), *args)
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    name = f"attention_fwd_{ROUTE_TAGS[route]}wide_split_d{Dp}"
    for splits in (None, 1):
        before = launches[name]
        out = _launch_fwd(route, qu, k, v, bias, *args, splits=splits)[0]
        err = rel_err(out, ref)
        assert err <= tol, f"wide forward B={WIDE_B} D={D} {dtype} splits {splits}: rel {err}"
        assert launches[name] - before == int(splits is None and S > 1), (name, splits, S)
    del out, ref
    call = {c: (lambda c=c: _launch_fwd(route, qu, k, v, bias, *args, splits=c))
            for c in (None, 1)}
    readings = [cuda_ms_queued(call[c]) for c in (None, 1, 1, None)]
    return {"splits": S, "launch_ms": (readings[0] + readings[3]) / 2,
            "launch_splits_1_ms": (readings[1] + readings[2]) / 2,
            "launch_readings_ms": readings}


def check_wide(seed, gen):
    """The wide instance at the shapes phase kernels' option loop does not
    give it (module note): D = 512 at L = 257, D = 300 and 1000 at a batch of
    WIDE_B (held, timed at L = 256; the forward also at one key split), and
    the bf16 forward at D = 256 beside the D = 256 instance. Returns the rows
    for the kernels line."""
    from sarssl_torch.kernels.attention import padded_head_dim

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        check_attention(512, dtype, RATE, seed, gen, 257)
        torch.cuda.empty_cache()
        for D in WIDE_SMALL_HEAD_DIMS:
            for L in WIDE_CHECK_LENGTHS:
                err, out_err = check_attention(D, dtype, RATE, seed, gen, L, WIDE_B)
            t = time_attention_route(SEQ, D, dtype, seed, gen, WIDE_B)
            t.update(max_abs_err=err, out_err=out_err, **time_wide_splits(D, dtype, seed, gen))
            rows[(D, dtype)] = t
            log(f"[kernels] attention L={SEQ} D={D} (fwd at {t['Dp']}, bwd at {t['Db']}) "
                f"B={WIDE_B} {str(dtype)[6:]} rate={RATE} ({ROUTE_WORDS[t['route']]}, wide "
                f"instance, unpadded): fwd {t['fwd_ms']:.4f} ms (through the padding "
                f"{t['padded_fwd_ms']:.4f}; plain {t['plain_fwd_ms']:.3f}, sdpa "
                f"{t['lib_fwd_ms']:.4f}, bound {t['fwd_bound'][0]:.4f} by {t['fwd_bound'][1]}), "
                f"bwd {t['bwd_ms']:.4f} ms (through the padding {t['padded_bwd_ms']:.4f}; plain "
                f"{t['plain_bwd_ms']:.3f}, sdpa {t['lib_bwd_ms']:.4f}, bound "
                f"{t['bwd_bound'][0]:.4f} by {t['bwd_bound'][1]}); the kernels alone, the "
                f"forward launched at {padded_head_dim(D)} on inputs padded beforehand: "
                f"{t['splits']} key splits (chosen) {t['launch_ms']:.4f} ms, 1 split "
                f"{t['launch_splits_1_ms']:.4f} ms (queued readings chosen, 1, 1, chosen: "
                + ", ".join(f"{x:.4f}" for x in t["launch_readings_ms"]) + ")")
        if dtype == torch.bfloat16:
            rows[(256, dtype)] = check_wide_at_256(seed, gen)
        profile_wide(dtype, seed, gen)
        torch.cuda.empty_cache()
    return rows


def check_dropout(seed, gen):
    """The kernel, forward and gradient, against the plain version bit for
    bit at the pretext step's shape (bf16) and at the downstream step's
    largest (f32: Triton builds another kernel for f32 pointers); timed at
    the pretext shape."""
    from sarssl_torch.kernels import dropout_plain, hash_dropout
    from sarssl_torch.kernels.dropout import launch_dropout

    err = 0.0
    for shape, dtype in (((BATCH, SEQ, 2048), torch.bfloat16),
                         ((DS_BATCH, DS_FRAMES, 4 * 512), torch.float32)):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn_like(x)
        xr = x.clone().requires_grad_()
        out = hash_dropout(xr, seed, RATE)
        (grad,) = torch.autograd.grad(out, xr, g)
        ref, ref_grad = dropout_plain(x, seed, RATE), dropout_plain(g, seed, RATE)
        what = f"dropout {shape} {str(dtype)[6:]}"
        assert torch.equal(out, ref), f"{what}: kernel output differs from the plain version"
        assert torch.equal(out != 0, ref != 0), f"{what}: masks differ"
        assert torch.equal(grad, ref_grad), f"{what}: gradient differs from mask * 1/(1-rate)"
        log(f"[kernels] hash_dropout {shape} {str(dtype)[6:]} rate={RATE}: output, mask "
            f"and gradient identical to the plain version (tol: exact)")
        err = max(err, max_abs(out, ref), max_abs(grad, ref_grad))
    x = torch.randn((BATCH, SEQ, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    n = x.numel()
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: launch_dropout(x, seed, RATE)),
        "plain_ms": cuda_ms(lambda: dropout_plain(x, seed, RATE)),
        "library_ms": cuda_ms(lambda: torch.nn.functional.dropout(x, RATE, True)),
        "bound": bound_ms(2 * n * 2, 10 * n, F32_FLOPS),
    }


def check_dropout_lanes(gen):
    """The lane-seeded kernel (one seed a lane, as ``jax.vmap`` of
    ``fused_dropout``): ``hash_dropout`` under ``torch.func.vmap`` (its vmap
    rule, forward and gradient) and the bare launch, against ``dropout_plain``
    vmapped over the same lanes and seeds, bit for bit: at the grid's largest
    dropout shape (8 lanes, f32), timed there; and on 8 bf16 lanes whose flat
    index passes 2**31 (held against the plain version two lanes at a time)."""
    from torch.func import vmap

    from sarssl_torch.kernels import dropout_plain, hash_dropout
    from sarssl_torch.kernels.dropout import launch_dropout_lanes

    plain = vmap(dropout_plain, in_dims=(0, 0, None))
    err = 0.0
    for shape, dtype, step in ((GRID_DROP_SHAPE, torch.float32, GRID_CHUNK),
                               (GRID_DROP_BIG, torch.bfloat16, 2)):
        seeds = torch.randint(0, 2 ** 32, (shape[0],), dtype=torch.int64, device="cuda",
                              generator=gen)
        seeds[0] = 0x9E3779B9  # above 2**31: the unsigned paths
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn_like(x)
        xr = x.clone().requires_grad_()
        out = vmap(hash_dropout, in_dims=(0, 0, None))(xr, seeds, RATE)
        (grad,) = torch.autograd.grad(out, xr, g)
        del xr
        bare = launch_dropout_lanes(x, seeds, RATE)
        what = f"dropout lanes {shape} {str(dtype)[6:]}"
        for i in range(0, shape[0], step):
            sl = slice(i, i + step)
            ref, ref_grad = plain(x[sl], seeds[sl], RATE), plain(g[sl], seeds[sl], RATE)
            assert torch.equal(out[sl], ref), f"{what}: lanes {i}+: output differs from plain"
            assert torch.equal(bare[sl], ref), f"{what}: lanes {i}+: the bare launch differs"
            assert torch.equal(out[sl] != 0, ref != 0), f"{what}: lanes {i}+: masks differ"
            assert torch.equal(grad[sl], ref_grad), f"{what}: lanes {i}+: gradient differs"
            err = max(err, max_abs(out[sl], ref), max_abs(grad[sl], ref_grad))
            del ref, ref_grad
        # the lanes differ from one another: each hashed its own seed
        assert not torch.equal(out[0] != 0, out[1] != 0), f"{what}: two lanes share a mask"
        log(f"[kernels] hash_dropout_lanes {shape} {str(dtype)[6:]} rate={RATE} "
            f"({x.numel()} elements{', past 2**31' if x.numel() > 2 ** 31 else ''}): output, "
            f"mask and gradient under vmap and the bare launch identical to vmapped "
            f"dropout_plain (tol: exact)")
        del x, g, out, grad, bare
        torch.cuda.empty_cache()
    x = torch.randn(GRID_DROP_SHAPE, generator=gen, device="cuda")
    seeds = torch.randint(0, 2 ** 32, (GRID_CHUNK,), dtype=torch.int64, device="cuda",
                          generator=gen)
    n = x.numel()
    # the kernel lasts about as long as the host takes to launch it: time it
    # (and its yardsticks) queued, and also back to back as the other rows
    return {
        "max_abs_err": err,
        "ms": cuda_ms_queued(lambda: launch_dropout_lanes(x, seeds, RATE)),
        "launch_ms": cuda_ms(lambda: launch_dropout_lanes(x, seeds, RATE)),
        "plain_ms": cuda_ms_queued(lambda: plain(x, seeds, RATE)),
        "library_ms": cuda_ms_queued(lambda: torch.nn.functional.dropout(x, RATE, True)),
        # one read and one write of each f32 element (and the 8 seeds)
        "bound": bound_ms(2 * n * 4 + 8 * GRID_CHUNK, 10 * n, F32_FLOPS),
    }


def _conv_cases():
    """launch name -> (public launch function, plain version, the bare
    tensor-core launch on a packed weight, that packing, the FMA kernel as it
    ran these shapes before the redesign); all but the packing of (x, w)."""
    from sarssl_torch.kernels import conv3x3_plain, conv3x3_s2d_plain, expand_weights_s2d2
    from sarssl_torch.kernels.conv3x3 import (conv3x3_dx, conv3x3_fwd, launch_conv3x3_fma,
                                              launch_conv3x3_mma, pack_weights, rot180_io)
    from sarssl_torch.kernels.conv_s2d import conv3x3_s2d_dx, conv3x3_s2d_fwd

    def view(x):
        B, H, W, C = x.shape
        return x.view(B, H, W // 2, 2 * C)

    def bare(x, packed):
        return launch_conv3x3_mma(x, packed, "bare")

    def fma(x, w):
        return launch_conv3x3_fma(x, w, "fma")

    def fma_s2d(x, w):
        return launch_conv3x3_fma(view(x), expand_weights_s2d2(w), "fma")

    def flipped(f):
        return lambda dy, w: f(dy, rot180_io(w))

    return {
        "conv3x3_fwd": (conv3x3_fwd, conv3x3_plain, bare, pack_weights, fma),
        "conv3x3_dx": (conv3x3_dx, flipped(conv3x3_plain), bare,
                       lambda w: pack_weights(rot180_io(w)), flipped(fma)),
        # the s2d form's bare launch is conv3x3's: the same instance walks the
        # view's chunks (kernels/conv_s2d.py)
        "conv3x3_s2d_fwd": (conv3x3_s2d_fwd, conv3x3_s2d_plain, bare, pack_weights, fma_s2d),
        "conv3x3_s2d_dx": (conv3x3_s2d_dx, flipped(conv3x3_s2d_plain), bare,
                           lambda w: pack_weights(rot180_io(w)), flipped(fma_s2d)),
    }


def _conv_small_case(name, kernel, plain, shape, cout, dtype, gen, tag):
    """One launch at a small shape against the plain version in f32; asserts
    from the launch counts which kernel ran (``name + tag``: ``"_tc"``, the
    bf16 tensor-core kernel, or ``"_tf32"``, the 3xTF32 one)."""
    from sarssl_torch.kernels import launches

    tol = TOL_CONV_BF16 if dtype == torch.bfloat16 else TOL_F32
    C = shape[-1]
    x = torch.randn(shape[:3] + (cout if name.endswith("_dx") else C,), generator=gen,
                    device="cuda").to(dtype)
    w = (torch.randn((3, 3, C, cout), generator=gen, device="cuda") / np.sqrt(9 * C)).to(dtype)
    before = launches[name], launches[name + tag]
    out = kernel(x, w)
    rose = launches[name] - before[0], launches[name + tag] - before[1]
    assert rose == (1, 1), f"{name} {shape} {dtype}: launches {rose} of {name}, {name}{tag}"
    rel = rel_err(out, plain(x.float(), w.float()))
    assert rel <= tol, f"{name} {str(dtype)[6:]} {shape}: rel err {rel} > {tol}"
    log(f"[kernels] {name} {shape} -> {cout} {str(dtype)[6:]}: rel err {rel:.2e} (tol {tol}; "
        f"counted as {name}{tag})")


def check_conv(gen):
    """The four conv launches against their plain versions: f32 at a small
    ragged shape (3xTF32 kernel), bf16 at the same shape, at the dense 128 ->
    128 instance and at the front end's shape (tensor-core kernel), there
    timed beside their bound, cuDNN and the FMA kernel; then the public
    functions' forward and backward once, counted; then the same in f32 at
    the front end's shape (``_conv_f32_rows``). Returns the kernels line's
    conv rows by launch name, the f32 ones as ``<name>_float32``."""
    from sarssl_torch.kernels import conv3x3, conv3x3_s2d, launches, reset_launches

    cases = _conv_cases()
    C = CONV_SHAPE[-1]
    for name, (kernel, plain, *_) in cases.items():
        _conv_small_case(name, kernel, plain, CONV_SMALL, C, torch.float32, gen, "_tf32")
        _conv_small_case(name, kernel, plain, CONV_SMALL, C, torch.bfloat16, gen, "_tc")
    for name in ("conv3x3_fwd", "conv3x3_dx"):
        kernel, plain, *_ = cases[name]
        _conv_small_case(name, kernel, plain, CONV_DENSE, CONV_DENSE[-1], torch.bfloat16, gen,
                         "_tc")

    x, dy = (torch.randn(CONV_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    w = (torch.randn((3, 3, C, C), generator=gen, device="cuda") / np.sqrt(9 * C)
         ).to(torch.bfloat16)
    # library yardstick (never called by the port): cuDNN on the NCHW
    # (channels-last) views of the same NHWC tensors
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    lib = {
        "fwd": cuda_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1),
                       iters=5, warmup=2),
        "dx": cuda_ms(lambda: torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, dy_nchw,
                                                         padding=1), iters=5, warmup=2),
    }
    B, H, W, _ = CONV_SHAPE
    # the work of the SAME 3x3 conv, which is also what the s2d form executes:
    # the blocks of its expanded weight that are zero by construction are skipped
    nbytes, flops = 2 * x.numel() * 2 + w.numel() * 2, 2 * B * H * W * C * C * 9
    bound = bound_ms(nbytes, flops, BF16_FLOPS)
    rows = {}
    for name, (kernel, plain, bare, pack, fma) in cases.items():
        inp = dy if name.endswith("_dx") else x
        before = launches[name + "_tc"]
        out = kernel(inp, w)
        assert launches[name + "_tc"] == before + 1, f"{name}: not the tensor-core kernel"
        ref = plain(inp.float(), w.float())
        rel, err = rel_err(out, ref), max_abs(out, ref)
        del ref
        assert rel <= TOL_CONV_BF16, f"{name} bf16: rel err {rel} > {TOL_CONV_BF16}"
        packed = pack(w)
        assert torch.equal(bare(inp, packed), out), f"{name}: the bare launch differs"
        del out
        # new, old, new: the FMA kernel between two readings of the new one
        r = rows[name] = {
            "max_abs_err": err, "ms": cuda_ms(lambda: kernel(inp, w), iters=10, warmup=2),
            "fma_ms": cuda_ms(lambda: fma(inp, w), iters=3, warmup=1),
            "launch_ms": cuda_ms(lambda: bare(inp, packed), iters=10, warmup=2),
            "plain_ms": cuda_ms(lambda: plain(inp, w), iters=2, warmup=1),
            "library_ms": lib["dx" if name.endswith("_dx") else "fwd"], "bound": bound}
        r["tflops"], r["tbytes"] = flops / r["ms"] * 1e-9, nbytes / r["ms"] * 1e-9
        met = r["ms"] <= lib["fwd"] and r["ms"] <= 2 * bound[0]
        log(f"[kernels] {name} {CONV_SHAPE} bf16: rel err {rel:.2e} abs {err:.2e} "
            f"(tol {TOL_CONV_BF16}); {r['ms']:.3f} ms, the launch alone {r['launch_ms']:.3f} "
            f"(FMA kernel {r['fma_ms']:.3f}, plain {r['plain_ms']:.3f}, cuDNN "
            f"{r['library_ms']:.3f}, bound {bound[0]:.4f} by {bound[1]}); "
            f"{r['tflops']:.1f} TFLOP/s, {r['tbytes']:.3f} TB/s; target (<= cuDNN's forward "
            f"{lib['fwd']:.3f} and <= 2x the bound) {'met' if met else 'missed'}")
        assert CONV_FMA_FLOOR * r["ms"] <= r["fma_ms"], (
            f"{name}: under {CONV_FMA_FLOOR}x the FMA kernel")
    for kind in ("fwd", "dx"):
        s2d, dense = rows[f"conv3x3_s2d_{kind}"]["ms"], rows[f"conv3x3_{kind}"]["ms"]
        assert s2d <= CONV_S2D_OVER * dense, (
            f"conv3x3_s2d_{kind} {s2d} ms over {CONV_S2D_OVER}x conv3x3_{kind} {dense} ms")

    # the convs' own path: the public functions, forward and backward
    reset_launches()
    for fn in (conv3x3, conv3x3_s2d):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        torch.autograd.grad(fn(xr, wr), (xr, wr), dy)
    torch.cuda.synchronize()
    counts = {n: launches.get(n, 0) for n in CONV_LAUNCHES}
    counts_tc = {n: launches.get(n + "_tc", 0) for n in CONV_LAUNCHES}
    log(f"[kernels] conv path (conv3x3 and conv3x3_s2d, forward + backward): launches "
        f"{counts}, of the tensor-core kernel {counts_tc}")
    for n in CONV_LAUNCHES:
        assert counts[n] == counts_tc[n] == 1, (
            f"{n}: {counts[n]} launches, {counts_tc[n]} tensor-core, on the conv path, want 1")
        rows[n]["launches"], rows[n]["launches_tc"] = counts[n], counts_tc[n]
    del x, dy, w, w_oihw, x_nchw, dy_nchw
    torch.cuda.empty_cache()
    rows.update({f"{n}_float32": r for n, r in _conv_f32_rows(gen, cases).items()})
    return rows


def _conv_f32_rows(gen, cases):
    """The four conv launches in float32 at the front end's shape on the
    3xTF32 tensor-core kernel (conv3x3_tf32.cu): each against the plain
    version (TOL_F32), timed (new, FMA, new) beside the f32 FMA kernel it
    replaced, launched directly, cuDNN in f32 (TF32 off) and the plain
    version; the bound the larger of the bytes and three TF32 products a
    product at the TF32 rate. Then the public functions' forward and
    backward once in f32, counted."""
    from sarssl_torch.kernels import conv3x3, conv3x3_s2d, launches, reset_launches

    C = CONV_SHAPE[-1]
    x, dy = (torch.randn(CONV_SHAPE, generator=gen, device="cuda") for _ in range(2))
    w = torch.randn((3, 3, C, C), generator=gen, device="cuda") / np.sqrt(9 * C)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    lib = {
        "fwd": cuda_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1),
                       iters=3, warmup=1),
        "dx": cuda_ms(lambda: torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, dy_nchw,
                                                         padding=1), iters=3, warmup=1),
    }
    B, H, W, _ = CONV_SHAPE
    nbytes, flops = 2 * x.numel() * 4 + w.numel() * 4, 2 * B * H * W * C * C * 9
    bound = bound_ms(nbytes, TF32_SPLIT * flops, TF32_FLOPS)
    rows = {}
    for name, (kernel, plain, _, _, fma) in cases.items():
        inp = dy if name.endswith("_dx") else x
        before = launches[name + "_tf32"]
        out = kernel(inp, w)
        assert launches[name + "_tf32"] == before + 1, f"{name} f32: not the 3xTF32 kernel"
        ref = plain(inp, w)
        rel, err = rel_err(out, ref), max_abs(out, ref)
        del out, ref
        assert rel <= TOL_F32, f"{name} f32: rel err {rel} > {TOL_F32}"
        r = rows[name] = {"max_abs_err": err,
                          "ms": cuda_ms(lambda: kernel(inp, w), iters=5, warmup=1),
                          "fma_ms": cuda_ms(lambda: fma(inp, w), iters=2, warmup=1)}
        r["ms_again"] = cuda_ms(lambda: kernel(inp, w), iters=5, warmup=1)
        r.update(plain_ms=cuda_ms(lambda: plain(inp, w), iters=2, warmup=1),
                 library_ms=lib["dx" if name.endswith("_dx") else "fwd"], bound=bound)
        r["tflops"] = TF32_SPLIT * flops / r["ms"] * 1e-9
        log(f"[kernels] {name} {CONV_SHAPE} f32: rel err {rel:.2e} abs {err:.2e} (tol {TOL_F32}); "
            f"{r['ms']:.3f} / {r['ms_again']:.3f} ms (3xTF32 kernel; FMA kernel "
            f"{r['fma_ms']:.3f}, plain {r['plain_ms']:.3f}, cuDNN f32 {r['library_ms']:.3f}, bound "
            f"{bound[0]:.4f} by {bound[1]}); {r['tflops']:.1f} TFLOP/s of TF32 products, "
            f"{bound[0] / r['ms']:.0%} of the bound")
    reset_launches()
    for fn in (conv3x3, conv3x3_s2d):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        torch.autograd.grad(fn(xr, wr), (xr, wr), dy)
        del xr, wr
    torch.cuda.synchronize()
    counts = {n: launches.get(n, 0) for n in CONV_LAUNCHES}
    counts_tf32 = {n: launches.get(n + "_tf32", 0) for n in CONV_LAUNCHES}
    log(f"[kernels] conv path in f32 (conv3x3 and conv3x3_s2d, forward + backward): launches "
        f"{counts}, of the 3xTF32 kernel {counts_tf32}")
    for n in CONV_LAUNCHES:
        assert counts[n] == counts_tf32[n] == 1, (
            f"{n} f32: {counts[n]} launches, {counts_tf32[n]} 3xTF32, on the conv path, want 1")
        rows[n]["launches"], rows[n]["launches_tf32"] = counts[n], counts_tf32[n]
    del x, dy, w, w_oihw, x_nchw, dy_nchw
    torch.cuda.empty_cache()
    return rows


def check_attention_module(gen):
    """The conformer's attention module in bf16 at both flagship widths, at
    d_model 64 (head dim 16), at 32 (head dim 8, through the padding) and at
    2048 (head dim 512, the wide instance), B=8, L=256, rate 0: fused
    (tensor-core kernels) against unfused (plain PyTorch) on the card with the
    same weights; output and the gradients of the input, u_bias and v_bias."""
    from sarssl_torch.kernels import launches
    from sarssl_torch.kernels.attention import padded_head_dim
    from sarssl_torch.models.conformer import RelPosSelfAttention

    for d_model in (512, 256, 64, 32, 2048):
        D = padded_head_dim(d_model // HEADS)
        mods = {}
        for fused in (True, False):
            m = RelPosSelfAttention(d_model, HEADS, dropout=0.0, fused=fused,
                                    dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(7)).cuda()
            mods[fused] = m
        mods[False].load_state_dict(mods[True].state_dict())
        x = torch.randn((8, SEQ, d_model), generator=gen, device="cuda")
        g = torch.randn((8, SEQ, d_model), generator=gen, device="cuda").to(torch.bfloat16)
        res = {}
        before = launches[f"attention_fwd_tc_d{D}"], launches[f"attention_bwd_tc_d{D}"]
        for fused, m in mods.items():
            xr = x.clone().requires_grad_()
            y = m(xr, train=True)
            res[fused] = (y, *torch.autograd.grad(y, (xr, m.u_bias, m.v_bias), g))
        torch.cuda.synchronize()
        rose = (launches[f"attention_fwd_tc_d{D}"] - before[0],
                launches[f"attention_bwd_tc_d{D}"] - before[1])
        assert rose == (1, 1), f"attention module d={d_model}: tensor-core launches {rose}"
        errs = {n: rel_err(a, b) for n, a, b in
                zip(("out", "dx", "du_bias", "dv_bias"), res[True], res[False])}
        log(f"[kernels] RelPosSelfAttention d={d_model} heads={HEADS} bf16 B=8 L={SEQ}, fused "
            f"against unfused on the card: " + ", ".join(f"{n} rel {e:.2e}" for n, e in
                                                          errs.items()) + f" (tol {TOL_BF16})")
        for n, e in errs.items():
            assert e <= TOL_BF16, f"attention module d={d_model}: {n} rel err {e} > {TOL_BF16}"


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed = 0x9E3779B9  # a uint32 above 2**31 exercises the unsigned paths
    rows = {}
    for D in HEAD_DIMS:
        for rate in (0.0, RATE):
            err, out_err = check_attention(D, torch.bfloat16, rate, seed, gen)
            if rate == RATE:
                rows[D] = {"max_abs_err": err, "out_err": out_err}
    for D in (32, 64, 128):
        for L in F32_CHECK_LENGTHS:
            check_attention(D, torch.float32, RATE, seed, gen, L)
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        for L in D16_CHECK_LENGTHS:
            check_attention(16, dtype, RATE, seed, gen, L)
        for L in D256_CHECK_LENGTHS:
            check_attention(256, dtype, RATE, seed, gen, L)
            torch.cuda.empty_cache()
        for D in PADDED_HEAD_DIMS:
            check_attention(D, dtype, RATE, seed, gen)
        torch.cuda.empty_cache()
    opt_rows = {}
    for L, D, dtype in OPTION_ATTENTION_SHAPES:
        if D in (16, 256, 512):
            check_attention(D, dtype, 0.0, seed, gen, L)
        err, out_err = check_attention(D, dtype, RATE, seed, gen, L)
        t = time_attention_route(L, D, dtype, seed, gen)
        t.update(max_abs_err=err, out_err=out_err)
        opt_rows[(L, D, dtype)] = t
        fma = {kind: f"none at D={D}" if t[f"fma_{kind}_ms"] is None else
               f"{t[f'fma_{kind}_ms']:.4f}" for kind in ("fwd", "bwd")}
        log(f"[kernels] attention L={L} D={D} {str(dtype)[6:]} rate={RATE} "
            f"({ROUTE_WORDS[t['route']]}): fwd {t['fwd_ms']:.4f} ms (FMA kernel "
            f"{fma['fwd']}, plain {t['plain_fwd_ms']:.3f}, sdpa {t['lib_fwd_ms']:.4f}, "
            f"bound {t['fwd_bound'][0]:.4f} by {t['fwd_bound'][1]}), bwd {t['bwd_ms']:.4f} ms "
            f"(FMA kernel {fma['bwd']}, plain {t['plain_bwd_ms']:.3f}, sdpa "
            f"{t['lib_bwd_ms']:.4f}, bound {t['bwd_bound'][0]:.4f} by {t['bwd_bound'][1]})")
        floor = (None if t["fma_fwd_ms"] is None else D16_FMA_FLOOR if D == 16 else
                 ATTENTION_FMA_FLOOR if (L, D) in FMA_FLOOR_SHAPES and dtype == torch.bfloat16
                 else F32_FMA_FLOOR if dtype == torch.float32 else None)
        if floor:
            for kind in ("fwd", "bwd"):
                assert floor * t[f"{kind}_ms"] <= t[f"fma_{kind}_ms"], (
                    f"attention {kind} L={L} D={D} {dtype}: under {floor}x the FMA kernel")
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        D = PADDED_HEAD_DIMS[0]
        t = opt_rows[(SEQ, 16, dtype)]["padded"] = time_padded_attention(D, dtype, seed, gen)
        log(f"[kernels] attention L={SEQ} D={D} {str(dtype)[6:]} rate={RATE} through the "
            f"padding to D={t['Dp']}: fwd {t['fwd_ms']:.4f} ms (the launch on inputs padded "
            f"beforehand {t['launch_fwd_ms']:.4f}), bwd {t['bwd_ms']:.4f} ms (the launch "
            f"{t['launch_bwd_ms']:.4f})")
    for D in HEAD_DIMS:
        t = time_attention(D, seed, gen)
        rows[D].update(t)
        log(f"[kernels] attention D={D} bf16 rate={RATE}: fwd {t['fwd_ms']:.3f} ms "
            f"(FMA kernel {t['fma_fwd_ms']:.3f}, plain {t['plain_fwd_ms']:.3f}, sdpa "
            f"{t['lib_fwd_ms']:.3f}, bound {t['fwd_bound'][0]:.4f}), bwd {t['bwd_ms']:.3f} ms "
            f"(FMA kernels {t['fma_bwd_ms']:.3f}, plain {t['plain_bwd_ms']:.3f}, sdpa "
            f"{t['lib_bwd_ms']:.3f}, bound {t['bwd_bound'][0]:.4f})")
        # the floor under the redesign: the tensor-core kernels against the
        # FMA kernels in this same run
        assert 4 * t["fwd_ms"] <= t["fma_fwd_ms"], f"attention fwd D={D}: under 4x the FMA kernel"
        assert 3 * t["bwd_ms"] <= t["fma_bwd_ms"], f"attention bwd D={D}: under 3x the FMA kernels"
    wide = check_wide(seed, gen)
    check_attention_module(gen)
    drop = check_dropout(seed, gen)
    log(f"[kernels] hash_dropout: {drop['ms']:.4f} ms (plain {drop['plain_ms']:.4f}, "
        f"F.dropout {drop['library_ms']:.4f}, bound {drop['bound'][0]:.4f})")
    lanes = check_dropout_lanes(gen)
    log(f"[kernels] hash_dropout_lanes {GRID_DROP_SHAPE} f32: {lanes['ms']:.4f} ms queued, "
        f"{lanes['launch_ms']:.4f} ms back to back (vmapped "
        f"plain {lanes['plain_ms']:.4f}, F.dropout {lanes['library_ms']:.4f}, bound "
        f"{lanes['bound'][0]:.4f})")
    conv = check_conv(gen)
    return rows, opt_rows, wide, drop, lanes, conv


# ---------------------------------------------------------------------------
# phase edges: the inputs the kernels take past one launch's grid or 32-bit
# offsets (the Pallas kernels take them all). Each edge is driven once
# through its public entry point with the launch counts read around it
# (asserted exactly), held against its plain version (selected batches, or
# the whole in blocks of rows or slices where the plain version at that size
# does not fit in one piece), then timed beside its bound and its library
# call. Memory: at most ~64 GiB at once (the f32 wide backward at B * H * L *
# L = 4.3e9).
# ---------------------------------------------------------------------------
EDGE_SEED = 0x9E3779B9
# attention with B * H = 65792 (two launches a pass), at rates 0 and 0.1
EDGE_BH_SHAPES = ((16448, 4, 64, 16), (16448, 4, 64, 320))
# attention with B * H * L * L past 2**32, rate 0 (forward and backward). bf16
# at long rows: L = 65600 is 1025 whole tiles, 23200 leaves a tail. f32 at L =
# 4100 (a tail), where its 3xTF32 sums hold TOL_F32; past L ~ 10**4 they do
# not (_f32_sums_by_length, ROADMAP.md §3)
EDGE_BIG_SHAPES = {torch.bfloat16: ((1, 1, 65600, 16), (2, 4, 23200, 64), (1, 1, 65600, 320)),
                   torch.float32: ((1, 256, 4100, 16), (2, 128, 4100, 64), (1, 256, 4100, 320))}
EDGE_ROWS = 2048  # query rows a block of the blocked plain version
EDGE_DROP_N = 2 ** 31 + 2 ** 24
EDGE_DROP_SLICE = 2 ** 27  # elements a slice of the sliced plain version
EDGE_LANES = (((2, 2 ** 31 + 4096), torch.bfloat16), ((65600, 64), torch.float32))
EDGE_CONV_CHANNELS = ((3, 64), (64, 48), (96, 160), (256, 256))
EDGE_CONV_SHAPE = (16, 64, 64)  # (N, H, W) of the channel edges
EDGE_CONV_SMALL = (2, 19, 38)  # the GPU tests' shape, bf16 at the same channels
EDGE_CONV_BATCH = ((65600, 4, 8, 64, 64), (65600, 4, 8, 3, 64))  # N past the grid
EDGE_CONV_RAGGED = (4099, 3, 5, 13, 24)  # image groups of 17, the last one ragged
# the f32 conv against float64 at K = 9 C (C = Cout): (N, H, W) in row tiles
# and in image groups, on data of either sign and on positive data
EDGE_CONV_F64_C = (256, 1024, 2048)
EDGE_CONV_F64_SHAPES = ((1, 17, 19), (6, 4, 8))
EDGE_ITERS = 3
EDGE_CONV_ITERS = 20  # the convs at (16, 64, 64) and smaller


def _maybe_ms(what, fn, iters=EDGE_ITERS):
    """cuda_ms of a library yardstick, or None (logged) where the library
    refuses the shape or runs out of memory."""
    try:
        return cuda_ms(fn, iters=iters, warmup=1)
    except (RuntimeError, ValueError) as e:
        log(f"  [edges] {what}: not timed ({str(e).splitlines()[0][:160]})")
        torch.cuda.empty_cache()
        return None


def _counted(fn):
    """Runs fn; returns (its result, the launch counts that rose, by name)."""
    from sarssl_torch.kernels import launches

    before = dict(launches)
    res = fn()
    torch.cuda.synchronize()
    return res, {n: c - before.get(n, 0) for n, c in launches.items() if c != before.get(n, 0)}


def _attention_edge_drive(qu, k, v, bias, g, scale, rate):
    """fused_attention forward and backward (the public path); returns (out,
    grads) detached."""
    from sarssl_torch.kernels import fused_attention

    xs = [t.detach().requires_grad_() for t in (qu, k, v, bias)]
    out = fused_attention(*xs, EDGE_SEED, scale, rate)
    grads = torch.autograd.grad(out, xs, g)
    return out.detach(), grads


def _edge_attention_want(route, D, chunked):
    from sarssl_torch.kernels.attention import attention_instance, padded_head_dim

    Dp = padded_head_dim(D)
    tag = ROUTE_TAGS[route]
    want = {}
    for kind in ("fwd", "bwd"):
        want[f"attention_{kind}_d{Dp}"] = 1
        want[f"attention_{kind}_{tag}d{Dp}"] = 1
        if attention_instance(ROUTE_DTYPES[route], kind, Dp) == "wide":
            want[f"attention_{kind}_{tag}wide_d{Dp}"] = 1
        if chunked:
            want[f"attention_{kind}_{tag}chunked_d{Dp}"] = 1
    return want


def _plain_batches(qu, k, v, bias, g, b0, b1, scale, rate):
    """The plain version's function (attention_plain's, in f32) on batches
    b0 .. b1 of a larger attention, its dropout index placed at batch b0 of
    the whole tensor by dropout_plain's index map; (out, dqu, dk, dv,
    dbias)."""
    from sarssl_torch.kernels import dropout_plain

    ys = [t[b0:b1].float().requires_grad_() for t in (qu, k, v, bias)]
    p = torch.softmax((ys[0] @ ys[1].transpose(-1, -2) + ys[3]) * scale, dim=-1)
    n, off = p.numel(), b0 * p[0].numel()
    out = dropout_plain(p, EDGE_SEED, rate, (n, off + n, off)) @ ys[2]
    return (out.detach(), *torch.autograd.grad(out, ys, g[b0:b1].float()))


class _Err:
    """max |a - b| and max |b| of each named result, over the pieces it is
    compared in; rel = max |a - b| / max |b| of the whole."""

    def __init__(self):
        self.diff, self.peak = {}, {}

    def add(self, name, a, b):
        a, b = a.detach().float(), b.detach().float()
        self.diff[name] = max(self.diff.get(name, 0.0), float((a - b).abs().max()))
        self.peak[name] = max(self.peak.get(name, 0.0), float(b.abs().max()))

    def rel(self, name):
        return self.diff[name] / max(self.peak[name], 1e-30)


def _plain_blocked(qu, k, v, bias, g, out, grads, scale, err):
    """Holds a rate-0 attention too large for the plain version in one piece
    against it per (b, h) and blocks of EDGE_ROWS query rows (a row's softmax
    is its own, so the blocks are the same function: attention_plain's at
    rate 0, f32); dk and dv sum over the blocks. Returns the plain version's
    forward and backward ms over the blocks."""
    B, H, L, D = qu.shape
    dqu, dk, dv, dbias = grads
    spent = [0.0, 0.0]
    for b in range(B):
        for h in range(H):
            kf, vf = (t[b, h].float().requires_grad_() for t in (k, v))
            dk_sum, dv_sum = torch.zeros_like(kf), torch.zeros_like(vf)
            for r0 in range(0, L, EDGE_ROWS):
                r1 = min(L, r0 + EDGE_ROWS)
                qb, bb = (t[b, h, r0:r1].float().requires_grad_() for t in (qu, bias))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ob = torch.softmax((qb @ kf.T + bb) * scale, dim=-1) @ vf
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                gq, gk, gv, gb = torch.autograd.grad(ob, (qb, kf, vf, bb), g[b, h, r0:r1].float())
                torch.cuda.synchronize()
                spent[0] += 1e3 * (t1 - t0)
                spent[1] += 1e3 * (time.perf_counter() - t1)
                err.add("out", out[b, h, r0:r1], ob)
                err.add("dqu", dqu[b, h, r0:r1], gq)
                err.add("dbias", dbias[b, h, r0:r1], gb)
                dk_sum += gk
                dv_sum += gv
                del ob, gq, gk, gv, gb
            err.add("dk", dk[b, h], dk_sum)
            err.add("dv", dv[b, h], dv_sum)
    return tuple(spent)


def _attention_edge_times(qu, k, v, bias, g, scale, rate, plain_ms):
    """Forward and backward launches (queued back to back, EDGE_ITERS each),
    SDPA with the bias as a float mask at rate 0 (None where it refuses or
    runs out of memory), and the bounds, as _attention_yardsticks counts
    them."""
    from sarssl_torch.kernels.attention import (_TC_LAUNCHES, attention_bwd_padded,
                                                attention_fwd_padded, attention_route)

    B, H, L, D = qu.shape
    fwd, bwd = _TC_LAUNCHES[attention_route(qu.dtype, L, D)]
    args = (EDGE_SEED, scale, rate)
    res = {"plain_fwd_ms": plain_ms[0], "plain_bwd_ms": plain_ms[1]}
    _, lse, padded = attention_fwd_padded(fwd, qu, k, v, bias, *args)
    res["fwd_ms"] = cuda_ms(lambda: attention_fwd_padded(fwd, qu, k, v, bias, *args),
                            iters=EDGE_ITERS, warmup=1)
    res["bwd_ms"] = cuda_ms(lambda: attention_bwd_padded(bwd, padded, bias, g, lse, *args),
                            iters=EDGE_ITERS, warmup=1)
    del padded, lse
    torch.cuda.empty_cache()
    mask = bias * scale
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        res["lib_fwd_ms"] = _maybe_ms(f"SDPA fwd {tuple(qu.shape)}",
                                      lambda: sdpa(qu, k, v, attn_mask=mask, scale=scale))
    res["lib_bwd_ms"] = None
    try:
        ys = [t.detach().requires_grad_() for t in (qu, k, v, mask)]
        out = sdpa(*ys[:3], attn_mask=ys[3], scale=scale)
        res["lib_bwd_ms"] = _maybe_ms(f"SDPA bwd {tuple(qu.shape)}", lambda: torch.autograd.grad(
            out, ys, g, retain_graph=True))
        del out, ys
    except (RuntimeError, ValueError) as e:
        log(f"  [edges] SDPA bwd {tuple(qu.shape)}: not timed ({str(e).splitlines()[0][:160]})")
    del mask
    torch.cuda.empty_cache()
    es = qu.element_size()
    rate_ops, split = (BF16_FLOPS, 1) if qu.dtype == torch.bfloat16 else (TF32_FLOPS, TF32_SPLIT)
    n_qkv, n_s = B * H * L * D, B * H * L * L
    res["fwd_bound"] = bound_ms((4 * n_qkv + n_s) * es, split * 4 * n_s * D, rate_ops)
    res["bwd_bound"] = bound_ms((8 * n_qkv + 2 * n_s) * es, split * 10 * n_s * D, rate_ops)
    return res


def _attention_edge(shape, dtype, rates, gen, what):
    """One attention edge in one dtype: driven at each rate (counted), held
    against the plain version, timed at the last rate. Returns its rows."""
    from sarssl_torch.kernels.attention import attention_chunks, attention_route

    B, H, L, D = shape
    scale = D ** -0.5
    route = attention_route(dtype, L, D)
    chunked = len(attention_chunks(B, H, L)) > 1
    name = str(dtype)[6:]
    qu, k, v, bias, g = (torch.randn(s, generator=gen, device="cuda", dtype=dtype)
                         for s in (shape, shape, shape, (B, H, L, L), shape))
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    for rate in rates:
        (out, grads), counts = _counted(lambda: _attention_edge_drive(qu, k, v, bias, g, scale,
                                                                      rate))
        want = _edge_attention_want(route, D, chunked)
        assert {n: counts.get(n, 0) for n in want} == want and not _fma_launches(counts), (
            f"attention {what} {shape} {name} rate={rate}: launches {counts}, want {want}")
        err = _Err()
        if chunked:
            # the batches at both ends and on both sides of each launch
            # boundary, whole (plain version in one piece)
            starts = [b0 for b0, *_ in attention_chunks(B, H, L)][1:]
            picks = sorted({0, B - 1} | set(starts) | {s - 1 for s in starts})
            for b in picks:
                ref = _plain_batches(qu, k, v, bias, g, b, b + 1, scale, rate)
                for n, a, r in zip(("out", "dqu", "dk", "dv", "dbias"),
                                   (out, *grads), ref):
                    err.add(n, a[b:b + 1], r)
                del ref
            compared = f"batches {picks} against the plain version"
        else:
            plain_ms = _plain_blocked(qu, k, v, bias, g, out, grads, scale, err)
            compared = (f"every row against the plain version in blocks of {EDGE_ROWS} rows "
                        f"a (b, h)")
        del out, grads
        torch.cuda.empty_cache()
        rels = {n: err.rel(n) for n in err.diff}
        log(f"[edges] attention {what} {shape} {name} rate={rate} ({ROUTE_WORDS[route]}"
            f"{', ' + str(len(attention_chunks(B, H, L))) + ' launches a pass' if chunked else ''}"
            f"): launches {dict(sorted((n, counts[n]) for n in want))}; {compared}: "
            + ", ".join(f"{n} rel {e:.2e}" for n, e in rels.items()) + f" (tol {tol})")
        for n, e in rels.items():
            assert e <= tol, f"attention {what} {shape} {name} rate={rate}: {n} rel {e} > {tol}"
    if chunked:  # the plain version whole, once each way (None where it does not fit)
        from sarssl_torch.kernels import attention_plain

        with torch.no_grad():
            plain_fwd = _maybe_ms(f"plain fwd {shape}", lambda: attention_plain(
                qu, k, v, bias, EDGE_SEED, scale, rate), iters=1)
        plain_bwd = None
        try:
            xs = [t.detach().requires_grad_() for t in (qu, k, v, bias)]
            ref = attention_plain(*xs, EDGE_SEED, scale, rate)
            plain_bwd = _maybe_ms(f"plain bwd {shape}", lambda: torch.autograd.grad(
                ref, xs, g, retain_graph=True), iters=1)
            del ref, xs
        except RuntimeError as e:  # out of memory building the graph
            log(f"  [edges] plain bwd {shape}: not timed ({str(e).splitlines()[0][:160]})")
        torch.cuda.empty_cache()
        plain_ms = (plain_fwd, plain_bwd)
    t = _attention_edge_times(qu, k, v, bias, g, scale, rate, plain_ms)
    del qu, k, v, bias, g
    torch.cuda.empty_cache()
    log(f"[edges] attention {what} {shape} {name} rate={rate}: fwd {t['fwd_ms']:.4f} ms (plain "
        f"{t['plain_fwd_ms']}, SDPA {t['lib_fwd_ms']}, bound {t['fwd_bound'][0]:.4f} by "
        f"{t['fwd_bound'][1]}), bwd {t['bwd_ms']:.4f} ms (plain {t['plain_bwd_ms']}, SDPA "
        f"{t['lib_bwd_ms']}, bound {t['bwd_bound'][0]:.4f} by {t['bwd_bound'][1]})")
    rows = []
    for kind, line in (("fwd", 100), ("bwd", 128)):
        tagged = {n: c for n, c in counts.items() if n.startswith(f"attention_{kind}_")}
        rows.append({
            "name": f"attention_{kind}_d{D}_B{B}H{H}L{L}_{name}", "route": "cuda",
            "source": "sarssl_torch/csrc/" + ROUTE_SOURCES[route],
            "replaces": f"sarssl_tpu/kernels/attention.py:{line}",
            "launches": tagged.get(f"attention_{kind}_{ROUTE_TAGS[route]}d{D}", 0),
            "counters": tagged, "edge": what, "rate": rate,
            "max_abs_err": (max(err.diff[n] for n in ("dqu", "dk", "dv", "dbias"))
                            if kind == "bwd" else err.diff["out"]),
            "ms": t[f"{kind}_ms"],
            "plain_ms": t[f"plain_{kind}_ms"],
            "bound_ms": t[f"{kind}_bound"][0], "bound_by": t[f"{kind}_bound"][1],
            "library_ms": t[f"lib_{kind}_ms"],
            "path": "phase edges: fused_attention forward and backward once (launches)"})
    return rows


EDGE_F32_LENGTHS = (4096, 16384, 65600)


def _f64_blocked(qu, k, v, bias, g, rows, scale):
    """Float64 out of the first ``rows`` query rows and dqu, dk, dv of a (1,
    1, L, D) attention at rate 0, in blocks of EDGE_ROWS query rows."""
    q, kk, vv, gg = (t[0, 0].double() for t in (qu, k, v, g))
    L = q.shape[0]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(kk), torch.zeros_like(vv)
    out = None
    for r0 in range(0, L, EDGE_ROWS):
        r1 = min(L, r0 + EDGE_ROWS)
        p = torch.softmax((q[r0:r1] @ kk.T + bias[0, 0, r0:r1].double()) * scale, -1)
        if r0 == 0:
            out = (p @ vv)[:rows]
        dp = gg[r0:r1] @ vv.T
        ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
        dq[r0:r1] = ds @ kk
        dk += ds.T @ q[r0:r1]
        dv += p.T @ gg[r0:r1]
        del p, dp, ds
    return out, dq, dk, dv


def _f32_sums_by_length(gen):
    """How far the 3xTF32 route's sums over L lie from float64, beside the
    plain version's (f32, TF32 off): (1, 1, L, 16) at rate 0, the first
    EDGE_ROWS query rows' out and every row of dqu, dk and dv, each error
    relative to its max |float64|. Asserts the kernel and the plain out
    within TOL_F32 at every L (past L = 1024 the kernels sum each tile's
    products apart from the running sums: attention_f32_mma.cu's
    mma_acc_rows)."""
    from sarssl_torch.kernels import fused_attention

    res = {}
    for L in EDGE_F32_LENGTHS:
        qu, k, v, g = (torch.randn((1, 1, L, 16), generator=gen, device="cuda")
                       for _ in range(4))
        bias = torch.randn((1, 1, L, L), generator=gen, device="cuda")
        xs = [t.requires_grad_() for t in (qu, k, v)]
        out = fused_attention(*xs, bias, 0, 0.25, 0.0)
        grads = torch.autograd.grad(out, xs, g)
        out, qu, k, v = (t.detach() for t in (out, qu, k, v))
        ref = _f64_blocked(qu, k, v, bias, g, EDGE_ROWS, 0.25)
        plain = torch.softmax((qu[0, 0, :EDGE_ROWS] @ k[0, 0].T + bias[0, 0, :EDGE_ROWS]) * 0.25,
                              -1) @ v[0, 0]
        errs = {n: float((a.double() - r).abs().max() / r.abs().max())
                for n, a, r in zip(("out", "dqu", "dk", "dv"),
                                   (out[0, 0, :EDGE_ROWS], *(t[0, 0] for t in grads)), ref)}
        errs["plain_out"] = float((plain.double() - ref[0]).abs().max() / ref[0].abs().max())
        res[L] = errs
        del qu, k, v, g, bias, out, grads, ref, plain, xs
        torch.cuda.empty_cache()
        log(f"[edges] f32 attention (1, 1, {L}, 16) rate=0 against float64 (out: the first "
            f"{EDGE_ROWS} rows): 3xTF32 kernel " + ", ".join(
                f"{n} rel {e:.2e}" for n, e in errs.items() if n != "plain_out")
            + f"; plain f32 out rel {errs['plain_out']:.2e} (tol {TOL_F32})")
        assert all(e <= TOL_F32 for e in errs.values()), (L, errs)
    return res


def _refuses_past_uint32():
    """At a rate above 0 the uint32 dropout index still bounds the shape (the
    shape is refused before anything is read: the bias need not exist)."""
    from sarssl_torch.kernels import fused_attention

    qu = torch.zeros((1, 1, 65536, 16), device="cuda", dtype=torch.bfloat16)
    bias = torch.empty((1, 1, 65536, 65536), device="meta", dtype=torch.bfloat16)
    try:
        fused_attention(qu, qu, qu, bias, EDGE_SEED, 0.25, 0.1)
    except ValueError as e:
        assert "uint32" in str(e), e
        log(f"[edges] attention (1, 1, 65536, 16) rate=0.1 refused: {str(e)[:120]}...")
        return
    raise AssertionError("attention past 2**32 at rate 0.1 was not refused")


def _dropout_slices(x, out, seed, rate, lane=None):
    """Holds a dropout launch past 2**31 elements against the plain version
    in slices of EDGE_DROP_SLICE elements, each with its place in the whole
    (lane) tensor given by dropout_plain's index map; returns (max |diff|,
    the plain version's seconds)."""
    from sarssl_torch.kernels import dropout_plain

    x, out = x.reshape(-1), out.reshape(-1)
    diff, spent = 0.0, 0.0
    for a in range(0, x.numel(), EDGE_DROP_SLICE):
        b = min(x.numel(), a + EDGE_DROP_SLICE)
        m = b - a
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = dropout_plain(x[a:b], seed, rate, (m, a + m, a))
        torch.cuda.synchronize()
        spent += time.perf_counter() - t0
        assert torch.equal(out[a:b], ref), (
            f"dropout{'' if lane is None else f' lane {lane}'}: elements {a}..{b} differ from "
            f"the plain version")
        diff = max(diff, max_abs(out[a:b], ref))
        del ref
    return diff, spent


def _dropout_edge(dtype, gen):
    """hash_dropout past 2**31 elements: forward and gradient
    through the public path (counted), every element against the plain
    version in slices, bit for bit; then timed beside F.dropout."""
    from sarssl_torch.kernels import hash_dropout
    from sarssl_torch.kernels.dropout import launch_dropout

    n, name = EDGE_DROP_N, str(dtype)[6:]
    x = torch.randn((n,), generator=gen, device="cuda", dtype=dtype)
    g = torch.randn((n,), generator=gen, device="cuda", dtype=dtype)

    def drive():
        xr = x.detach().requires_grad_()
        out = hash_dropout(xr, EDGE_SEED, RATE)
        return out.detach(), torch.autograd.grad(out, xr, g)[0]

    (out, grad), counts = _counted(drive)
    assert counts == {"hash_dropout": 2}, f"dropout {n}: {counts}"
    err, plain_s = _dropout_slices(x, out, EDGE_SEED, RATE)
    gerr, _ = _dropout_slices(g, grad, EDGE_SEED, RATE)
    del out, grad
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: launch_dropout(x, EDGE_SEED, RATE), iters=EDGE_ITERS, warmup=1)
    lib = _maybe_ms(f"F.dropout {n}", lambda: torch.nn.functional.dropout(x, RATE, True))
    bound = bound_ms(2 * n * x.element_size(), 10 * n, F32_FLOPS)
    log(f"[edges] hash_dropout ({n},) {name} rate={RATE}: launches {counts}; "
        f"output, mask and gradient identical to the plain version in slices of "
        f"{EDGE_DROP_SLICE} (tol: exact); {ms:.4f} ms (plain in slices {1e3 * plain_s:.3f}, "
        f"F.dropout {lib}, bound {bound[0]:.4f} by {bound[1]})")
    del x, g
    torch.cuda.empty_cache()
    return {"name": f"hash_dropout_n{n}_{name}", "route": "triton",
            "source": "sarssl_torch/kernels/dropout.py",
            "replaces": "sarssl_tpu/kernels/dropout.py:40", "launches": counts["hash_dropout"],
            "counters": counts, "edge": "n past 2**31",
            "max_abs_err": max(err, gerr), "ms": ms, "plain_ms": 1e3 * plain_s,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib,
            "path": "phase edges: hash_dropout forward and backward once (launches)"}


def _lanes_edge(shape, dtype, gen):
    """The lane-seeded launch past 2**31 elements a lane or past 65535
    lanes: hash_dropout under torch.func.vmap, forward and gradient
    (counted), and the bare launch, against the plain version (vmapped where
    it fits, else a lane at a time in slices), bit for bit; timed beside
    F.dropout."""
    from torch.func import vmap

    from sarssl_torch.kernels import dropout_plain, hash_dropout
    from sarssl_torch.kernels.dropout import BLOCK as DROP_BLOCK
    from sarssl_torch.kernels.dropout import launch_dropout_lanes

    nl, m = shape
    sliced = m >= 2 ** 31  # the vmapped plain version whole does not fit
    name = str(dtype)[6:]
    x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    g = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    seeds = torch.randint(0, 2 ** 32, (nl,), dtype=torch.int64, device="cuda", generator=gen)
    seeds[0] = EDGE_SEED

    def drive():
        xr = x.detach().requires_grad_()
        out = vmap(hash_dropout, in_dims=(0, 0, None))(xr, seeds, RATE)
        return out.detach(), torch.autograd.grad(out, xr, g)[0]

    (out, grad), counts = _counted(drive)
    want = {"hash_dropout_lanes": 2}
    if m < DROP_BLOCK:  # a lane shorter than a block: the short-lane kernel
        want["hash_dropout_lanes_short"] = 2
    assert counts == want, f"dropout lanes {shape}: launches {counts}, want {want}"
    bare = launch_dropout_lanes(x, seeds, RATE)
    assert torch.equal(bare, out), f"dropout lanes {shape}: the bare launch differs"
    del bare
    plain_s, err = 0.0, 0.0
    if sliced:
        for lane in range(nl):
            s = int(seeds[lane])
            e1, t1 = _dropout_slices(x[lane], out[lane], s, RATE, lane)
            e2, _ = _dropout_slices(g[lane], grad[lane], s, RATE, lane)
            err, plain_s = max(err, e1, e2), plain_s + t1
        compared = f"each lane in slices of {EDGE_DROP_SLICE}"
    else:
        plain = vmap(dropout_plain, in_dims=(0, 0, None))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain(x, seeds, RATE)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        assert torch.equal(out, ref) and torch.equal(grad, plain(g, seeds, RATE)), (
            f"dropout lanes {shape}: differs from vmapped dropout_plain")
        err = max_abs(out, ref)
        compared = "vmapped dropout_plain whole"
    assert not torch.equal(out[0] != 0, out[1] != 0), f"dropout lanes {shape}: lanes share a mask"
    del out, grad
    torch.cuda.empty_cache()
    # queued behind a sleeping kernel (the short lanes' launch lasts about as
    # long as the host takes to issue it), and back to back
    ms = cuda_ms_queued(lambda: launch_dropout_lanes(x, seeds, RATE))
    launch_ms = cuda_ms(lambda: launch_dropout_lanes(x, seeds, RATE), iters=EDGE_ITERS, warmup=1)
    lib = cuda_ms_queued(lambda: torch.nn.functional.dropout(x, RATE, True))
    n = x.numel()
    bound = bound_ms(2 * n * x.element_size() + 8 * nl, 10 * n, F32_FLOPS)
    log(f"[edges] hash_dropout_lanes {shape} {name} rate={RATE}: launches {counts}; output, "
        f"mask and gradient under vmap and the bare launch identical to {compared} (tol: "
        f"exact); {ms:.4f} ms queued, {launch_ms:.4f} back to back (plain {1e3 * plain_s:.3f}, "
        f"F.dropout {lib:.4f} queued, bound {bound[0]:.4f} by {bound[1]})")
    del x, g
    torch.cuda.empty_cache()
    return {"name": f"hash_dropout_lanes_{nl}x{m}_{name}", "route": "triton",
            "source": "sarssl_torch/kernels/dropout.py",
            "replaces": "sarssl_tpu/kernels/dropout.py:40",
            "launches": counts["hash_dropout_lanes"], "counters": counts,
            "edge": ("a lane past 2**31 elements" if sliced else
                     "lanes past 65535 of fewer elements than a block (the short-lane "
                     "kernel, one launch over the flat tensor)"),
            "max_abs_err": err, "ms": ms, "launch_ms": launch_ms, "plain_ms": 1e3 * plain_s,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib,
            "path": "phase edges: hash_dropout under torch.func.vmap, forward and backward "
                    "once (launches)"}


def _conv_edge(N, H, W, C, Cout, dtype, gen, s2d=False):
    """conv3x3 (or conv3x3_s2d, C == Cout) forward and backward through the
    public path (counted: dx on the kernel, dW the library's), output and dx
    against the plain version; the forward and dx launches timed beside
    cuDNN at the same channels and the bound, the runtime-channel
    tensor-core kernels' (bf16 row tiles, f32 row tiles and groups) also
    beside the f32-FMA runtime-channel kernel launched directly on the same
    inputs (``fma_ms``), and the image groups' beside the row-tile kernel of
    the same source and pair launched directly (``rows_ms``)."""
    from sarssl_torch.kernels import conv3x3, conv3x3_plain, conv3x3_s2d, conv3x3_s2d_plain
    from sarssl_torch.kernels.conv3x3 import (conv3x3_dx, conv3x3_fwd, conv_kernel,
                                              launch_conv3x3_any, launch_conv3x3_any_mma,
                                              launch_conv3x3_mma, launch_conv3x3_tf32,
                                              pack_weights, rot180_io)
    from sarssl_torch.kernels.conv_s2d import conv3x3_s2d_dx, conv3x3_s2d_fwd, expand_weights_s2d2

    name = str(dtype)[6:]
    prefix = "conv3x3_s2d" if s2d else "conv3x3"
    fn, plain = (conv3x3_s2d, conv3x3_s2d_plain) if s2d else (conv3x3, conv3x3_plain)
    fwd, dx = (conv3x3_s2d_fwd, conv3x3_s2d_dx) if s2d else (conv3x3_fwd, conv3x3_dx)
    # the s2d form is the conv of x itself (kernels/conv_s2d.py): conv3x3's
    # route; dx is the conv of dy, Cout -> C, by its own route
    kernels = {"fwd": conv_kernel(dtype, C, Cout, H, W), "dx": conv_kernel(dtype, Cout, C, H, W)}
    x = torch.randn((N, H, W, C), generator=gen, device="cuda", dtype=dtype)
    dy = torch.randn((N, H, W, Cout), generator=gen, device="cuda", dtype=dtype)
    w = (torch.randn((3, 3, C, Cout), generator=gen, device="cuda") / np.sqrt(9 * C)).to(dtype)

    def drive():
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        y = fn(xr, wr)
        return y.detach(), torch.autograd.grad(y, (xr, wr), dy)[0]

    (y, gx), counts = _counted(drive)
    want = {}
    for kind, kernel in kernels.items():
        want[f"{prefix}_{kind}"] = want[f"{prefix}_{kind}_{kernel}"] = 1
    assert {n: c for n, c in counts.items() if n.startswith(prefix)} == want, (
        f"{prefix} {(N, H, W, C, Cout)} {name}: launches {counts}, want {want}")
    tol = TOL_CONV_BF16 if dtype == torch.bfloat16 else TOL_F32
    ref = plain(x.float(), w.float())
    rel, err = rel_err(y, ref), max_abs(y, ref)
    del ref
    ref = plain(dy.float(), rot180_io(w).float())
    rel_dx, err_dx = rel_err(gx, ref), max_abs(gx, ref)
    del ref, y, gx
    assert rel <= tol and rel_dx <= tol, (
        f"{prefix} {(N, H, W, C, Cout)} {name}: rel err {rel}, dx {rel_dx} > {tol}")
    nbytes = (N * H * W * (C + Cout) + 9 * C * Cout) * x.element_size()
    flops = 2 * N * H * W * C * Cout * 9
    rate_ops, split = (BF16_FLOPS, 1) if dtype == torch.bfloat16 else (TF32_FLOPS, TF32_SPLIT)
    bound = bound_ms(nbytes, split * flops, rate_ops)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    rows = []
    def yardstick(inp, wk):  # the f32-FMA runtime-channel kernel, launched directly
        if s2d:
            B_, H_, W_, C_ = inp.shape
            return launch_conv3x3_any(inp.view(B_, H_, W_ // 2, 2 * C_), expand_weights_s2d2(wk),
                                      "fma_any")
        return launch_conv3x3_any(inp, wk, "fma_any")

    def row_tiles(inp, kind):  # the row-tile kernel of the pass's pair, launched directly
        if dtype == torch.float32:
            return launch_conv3x3_tf32(inp, w, "rows", rot=kind == "dx")
        if conv_kernel(dtype, *((C, Cout) if kind == "fwd" else (Cout, C))) == "tc":
            return launch_conv3x3_mma(inp, pack_weights(rot180_io(w) if kind == "dx" else w),
                                      "rows")
        return launch_conv3x3_any_mma(inp, w, "rows", rot=kind == "dx")

    # the small shapes last tens of microseconds, their host calls included:
    # more launches a reading, the median of 5 windows, and beside it the
    # device time queued behind a sleeping kernel and the host's microseconds
    # a call (the port's split into the C entry, its ctypes share and its
    # launches), the port's and cuDNN's (PERF.md section 5)
    small = N * H * W <= 2 ** 18
    iters = EDGE_CONV_ITERS if small else EDGE_ITERS
    for kind, launch, inp, lib in (
            ("fwd", fwd, x, lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1)),
            ("dx", dx, dy, lambda: torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, dy_nchw,
                                                              padding=1))):
        kernel = kernels[kind]
        call = (lambda: launch(inp, w))  # noqa: E731
        calls = {}
        if small:
            port = call_readings(call)
            ms = port.pop("ms")
            libname, entry = ((_conv_library(kernel), "conv3x3_tf32" if dtype == torch.float32
                               else "conv3x3_any_mma") if kernel != "tc" else (None, None))
            if libname is not None:
                port.update(host_split(call, libname, entry))
            calls = {**port, **{f"library_{k}": v for k, v in call_readings(lib).items()},
                     "library_launches": launches_a_call(lib)}
            if "launches" in calls:
                calls["launches_a_call"] = calls.pop("launches")
        else:
            ms = cuda_ms(call, iters=iters, warmup=1)
        wk = rot180_io(w) if kind == "dx" else w
        fma_ms = (cuda_ms(lambda: yardstick(inp, wk), iters=iters, warmup=1)
                  if kernel in ("tc_any", "tf32", "tf32_groups") else None)
        rows_ms = (cuda_ms(lambda: row_tiles(inp, kind), iters=iters, warmup=1)
                   if kernel.endswith("_groups") else None)
        plain_ms = cuda_ms(lambda: plain(inp.float(), (rot180_io(w) if kind == "dx" else w)
                                         .float()), iters=1, warmup=1)
        lib_ms = (calls.pop("library_ms") if small else
                  _maybe_ms(f"cuDNN {kind} {(N, H, W, C, Cout)}", lib, iters=iters))
        rows.append({
            "name": f"{prefix}_{kind}_N{N}H{H}W{W}_C{C}_Cout{Cout}_{name}", "route": "cuda",
            "source": {"tc": "sarssl_torch/csrc/conv3x3_mma.cu",
                       "tc_any": "sarssl_torch/csrc/conv3x3_any_mma.cu",
                       "tc_groups": "sarssl_torch/csrc/conv3x3_any_mma.cu",
                       "tf32": "sarssl_torch/csrc/conv3x3_tf32.cu",
                       "tf32_groups": "sarssl_torch/csrc/conv3x3_tf32.cu"}[kernel],
            "variant": {"tc": "wgmma", "tc_any": "wgmma_any_channels",
                        "tc_groups": "wgmma_image_groups", "tf32": "wgmma_tf32x3",
                        "tf32_groups": "wgmma_tf32x3_image_groups"}[kernel],
            "fma_ms": fma_ms, "rows_ms": rows_ms,
            "replaces": CONV_REPLACES[prefix],
            "launches": counts[f"{prefix}_{kind}"],
            "counters": {n: c for n, c in counts.items() if n.startswith(f"{prefix}_{kind}")},
            "edge": (f"N = {N} past the grid" if N > 65535 else
                     f"(C, Cout) = {(C, Cout)}" + (", image groups" if kernel.endswith("_groups")
                                                   else "")),
            "max_abs_err": err if kind == "fwd" else err_dx, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
            "path": f"phase edges: {prefix} forward and backward once (launches)",
            **({"ms_is": "median of 5 back-to-back windows of 20 calls", **calls}
               if small else {})})
    log(f"[edges] {prefix} {(N, H, W, C)} -> {Cout} {name} ({kernels['fwd']} / "
        f"{kernels['dx']} kernel): launches "
        f"{dict(sorted(counts.items()))}; rel err fwd {rel:.2e}, dx {rel_dx:.2e} (tol {tol}); "
        + ", ".join(f"{r['name'].split('_N')[0]} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, "
                    f"cuDNN {r['library_ms']}, bound {r['bound_ms']:.4f} by {r['bound_by']}"
                    + (f"; queued {r['queued_ms']:.4f} / cuDNN {r['library_queued_ms']:.4f}, "
                       f"host us a call {r['host_us']:.1f} / cuDNN {r['library_host_us']:.1f}"
                       + (f" (C entry {r['c_entry_us']:.1f}, its launches {r['launch_us']:.1f}, "
                          f"{r['launches_a_call']} launch a call)" if "c_entry_us" in r else "")
                       if "queued_ms" in r else "")
                    + (f", f32-FMA any-channel kernel {r['fma_ms']:.4f}" if r["fma_ms"] else "")
                    + (f", row tiles {r['rows_ms']:.4f}" if r["rows_ms"] else "")
                    + ")" for r in rows))
    del x, dy, w, w_oihw
    torch.cuda.empty_cache()
    return rows


def _conv_library(kernel):
    """The library of a runtime-channel conv kernel's C entry."""
    from sarssl_torch.kernels.conv3x3 import _library_any_mma, _library_tf32

    groups = kernel.endswith("_groups")
    return _library_tf32(groups) if kernel.startswith("tf32") else _library_any_mma(groups)


def _conv_f32_against_float64(gen):
    """conv3x3 forward and dx in f32 (the 3xTF32 kernel, each K chunk summed
    apart) against the float64 conv (cuDNN) at K = 9 C up to 18432,
    which the Pallas kernel takes, in row tiles and image groups, on normal
    and on positive data (where the tensor core's cut toward zero drifts the
    most): each within TOL_F32 of the largest value."""
    from sarssl_torch.kernels.conv3x3 import conv3x3_dx, conv3x3_fwd, conv_kernel, rot180_io

    def conv64(a, k):
        return torch.nn.functional.conv2d(a.double().permute(0, 3, 1, 2),
                                          k.double().permute(3, 2, 0, 1), padding=1
                                          ).permute(0, 2, 3, 1)

    for C in EDGE_CONV_F64_C:
        for N, H, W in EDGE_CONV_F64_SHAPES:
            for positive in (False, True):
                if positive:
                    x, dy = (torch.rand((N, H, W, C), generator=gen, device="cuda")
                             for _ in range(2))
                    w = torch.rand((3, 3, C, C), generator=gen, device="cuda") / (9 * C)
                else:
                    x, dy = (torch.randn((N, H, W, C), generator=gen, device="cuda")
                             for _ in range(2))
                    w = torch.randn((3, 3, C, C), generator=gen, device="cuda") / np.sqrt(9 * C)
                (y, gx), counts = _counted(lambda: (conv3x3_fwd(x, w), conv3x3_dx(dy, w)))
                kernel = conv_kernel(torch.float32, C, C, H, W)
                assert counts == {"conv3x3_fwd": 1, f"conv3x3_fwd_{kernel}": 1, "conv3x3_dx": 1,
                                  f"conv3x3_dx_{kernel}": 1}, counts
                rel, rel_dx = rel_err(y, conv64(x, w)), rel_err(gx, conv64(dy, rot180_io(w)))
                assert rel <= TOL_F32 and rel_dx <= TOL_F32, (
                    f"conv3x3 f32 {(N, H, W)} C = {C} against float64: {rel}, dx {rel_dx}")
                log(f"[edges] conv3x3 f32 {(N, H, W, C)} -> {C} ({kernel}, K = {9 * C}, "
                    f"{'positive' if positive else 'normal'} data) against float64: rel err fwd "
                    f"{rel:.2e}, dx {rel_dx:.2e} (tol {TOL_F32})")
    torch.cuda.empty_cache()


def phase_edges():
    """The inputs past one launch's grid or 32-bit offsets (module note,
    phase 3b); returns the kernels line's rows of the edges."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = []
    _f32_sums_by_length(gen)
    for shape in EDGE_BH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            rows += _attention_edge(shape, dtype, (0.0, RATE), gen, "B * H past 65535")
    for dtype, shapes in EDGE_BIG_SHAPES.items():
        for shape in shapes:
            rows += _attention_edge(shape, dtype, (0.0,), gen, "B * H * L * L past 2**32")
    _refuses_past_uint32()
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(_dropout_edge(dtype, gen))
    for shape, dtype in EDGE_LANES:
        rows.append(_lanes_edge(shape, dtype, gen))
    N, H, W = EDGE_CONV_SHAPE
    for C, Cout in EDGE_CONV_CHANNELS:
        for dtype in (torch.bfloat16, torch.float32):
            rows += _conv_edge(N, H, W, C, Cout, dtype, gen)
        rows += _conv_edge(*EDGE_CONV_SMALL, C, Cout, torch.bfloat16, gen)
    for dtype in (torch.bfloat16, torch.float32):
        rows += _conv_edge(N, H, W, 256, 256, dtype, gen, s2d=True)
    for N, H, W, C, Cout in EDGE_CONV_BATCH:
        for dtype in (torch.bfloat16, torch.float32):
            rows += _conv_edge(N, H, W, C, Cout, dtype, gen)
    for dtype in (torch.bfloat16, torch.float32):
        rows += _conv_edge(*EDGE_CONV_RAGGED, dtype, gen)
    _conv_f32_against_float64(gen)
    torch.cuda.empty_cache()
    log(f"[edges] {len(rows)} rows in {time.perf_counter() - t0:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return rows


def kernels_line(rows, opt_rows, wide, drop, lanes, conv, counts, ds_counts, cli_counts,
                 opt_counts, dscli_counts, data_counts, real_counts, mo_counts, mo_shapes,
                 grid_counts, abl_counts, mesh_counts, mesh, tiny_counts, d256_counts,
                 d320_counts, edges):
    out = []
    for D in HEAD_DIMS:
        r = rows[D]
        for kind, line in (("fwd", 100), ("bwd", 128)):
            out.append({
                "name": f"attention_{kind}_d{D}", "route": "cuda",
                "source": "sarssl_torch/csrc/attention_mma.cu", "variant": "mma",
                "replaces": f"sarssl_tpu/kernels/attention.py:{line}",
                "launches": counts.get(f"attention_{kind}_d{D}", 0),
                "launches_tc": counts.get(f"attention_{kind}_tc_d{D}", 0),
                "fma_ms": r[f"fma_{kind}_ms"],
                "max_abs_err": r["out_err"] if kind == "fwd" else r["max_abs_err"],
                "ms": r[f"{kind}_ms"], "plain_ms": r[f"plain_{kind}_ms"],
                "bound_ms": r[f"{kind}_bound"][0], "bound_by": r[f"{kind}_bound"][1],
                "library_ms": r[f"lib_{kind}_ms"],
                "path": "pretext train step (launches), the pre-training CLI run "
                        "(launches_pretrain_cli) and its --test, frozen-encoder and mel runs "
                        "(launches_pretrain_options), the pre-training runs from files, "
                        "resident splits and --device-synth (launches_data_path), the "
                        "pre-training run from real corpora (launches_real_data); not on the "
                        "downstream CLI's path",
                "launches_pretrain_cli": cli_counts.get(f"attention_{kind}_d{D}", 0),
                "launches_pretrain_options": opt_counts.get(f"attention_{kind}_d{D}", 0),
                "launches_data_path": data_counts.get(f"attention_{kind}_d{D}", 0),
                "launches_real_data": real_counts.get(f"attention_{kind}_d{D}", 0),
                "launches_downstream_cli": dscli_counts.get(f"attention_{kind}_d{D}", 0),
                "launches_model_options": mo_counts.get(f"attention_{kind}_tc_d{D}", 0),
                "launches_grid_vmap": grid_counts.get(f"attention_{kind}_d{D}", 0),
            })
    for (L, D, dtype), r in opt_rows.items():
        for kind, line in (("fwd", 100), ("bwd", 128)):
            n = mo_shapes.get((L, D, str(dtype)[6:], kind), 0)
            if D == 16:  # the tiny model of phase ref (head dims 8 and 4, padded)
                n = tiny_counts.get(f"attention_{kind}_{ROUTE_TAGS[r['route']]}d16", 0)
            out.append({
                "name": f"attention_{kind}_d{D}_L{L}_{str(dtype)[6:]}", "route": "cuda",
                "source": "sarssl_torch/csrc/" + ROUTE_SOURCES[r["route"]],
                "variant": {"tc": "mma", "tf32x3": "mma_tf32x3"}[r["route"]]
                + ("_wide" if _runs_wide(r["route"], kind, r["Dp"]) else ""),
                "replaces": f"sarssl_tpu/kernels/attention.py:{line}",
                # the model_options phase's launches at this shape: those of
                # variant (d) (L=257), (c) (L=512, bf16), (l) (L=256, f32) and
                # (m) (D=256), (n) (D=512); no variant runs L=512 in f32. D=16:
                # phase ref's tiny model
                "launches": n,
                "max_abs_err": r["out_err"] if kind == "fwd" else r["max_abs_err"],
                "ms": r[f"{kind}_ms"], "plain_ms": r[f"plain_{kind}_ms"],
                "bound_ms": r[f"{kind}_bound"][0], "bound_by": r[f"{kind}_bound"][1],
                "library_ms": r[f"lib_{kind}_ms"],
                "path": ("no CLI configuration has head dim 16: launches of phase ref's "
                         "SARSSLConfig.tiny(fused_attention=True), whose head dims 8 and 4 run "
                         "this instance through the padding (launches_tiny_model); 0 on every "
                         "CLI path" if D == 16 else
                         "no CLI configuration has head dim 256: phase model_options' variant "
                         "(m), the flagship step with spec_dembed=1024 "
                         "(launches_model_options; launches_wide_model_options on the wide "
                         "instance), and phase ref's SARSSLConfig.tiny(spec_dembed=1024) in f32 "
                         "(launches_tiny_model)" if D == 256 else
                         "no CLI configuration has head dim 512: phase model_options' variant "
                         "(n), the flagship step with spec_dembed=2048 on the wide instance "
                         "(launches_model_options)" if D == 512 else
                         "phase model_options (launches_model_options): use_cls (L=257) and "
                         "in_ver=single_ch_each_patch (L=512)" if dtype == torch.bfloat16 else
                         "phase model_options (launches_model_options): the flagship step in "
                         "f32 with fused attention, variant (l)" if L == SEQ else
                         "no model path runs f32 attention fused at this length; timed beside "
                         "the FMA kernels and SDPA"),
                "launches_model_options": mo_shapes.get((L, D, str(dtype)[6:], kind), 0),
                "fma_ms": r[f"fma_{kind}_ms"],
                **({"launches_tiny_model": n,
                    "padded_d8_ms": r["padded"][f"{kind}_ms"],
                    "padded_d8_launch_ms": r["padded"][f"launch_{kind}_ms"]}
                   if D == 16 else {}),
                **({"launches_tiny_model": d256_counts.get(
                    f"attention_{kind}_{ROUTE_TAGS[r['route']]}d256", 0),
                    "launches_wide_model_options": mo_shapes.get(
                        (L, D, str(dtype)[6:], kind, "wide"), 0)} if D == 256 else {}),
            })
    # the wide instance beside the option shapes: D = 300 and 1000 at a batch
    # of WIDE_B, unpadded (its column tail; beside them the route through the
    # padding to 320 and 1024, and the forward launched there at its key
    # splits and at one: the kernels alone), and the bf16 forward at D = 256
    # (plain, SDPA and the bound: the D = 256 row's, the same shape in this
    # run). Launches: the sum over every model phase's counts of that head dim
    # on the wide instance (the forward's split launches beside)
    model_phases = (tiny_counts, d256_counts, d320_counts, counts, cli_counts, opt_counts,
                    ds_counts, dscli_counts, grid_counts, data_counts, real_counts, mo_counts,
                    abl_counts, mesh_counts)
    for (D, dtype), r in wide.items():
        at256 = D == 256
        yard = opt_rows[(SEQ, 256, dtype)] if at256 else r
        route = "tc" if dtype == torch.bfloat16 else "tf32x3"
        Dp = 256 if at256 else r["Dp"]
        for kind, line in (("fwd", 100),) if at256 else (("fwd", 100), ("bwd", 128)):
            name = f"attention_{kind}_{ROUTE_TAGS[route]}wide_d{Dp}"
            n = sum(c.get(name, 0) for c in model_phases)
            split = f"attention_fwd_{ROUTE_TAGS[route]}wide_split_d{Dp}"
            out.append({
                "name": (f"attention_fwd_d256_wide_L{SEQ}_{str(dtype)[6:]}" if at256 else
                         f"attention_{kind}_d{D}_L{SEQ}_B{WIDE_B}_{str(dtype)[6:]}"),
                "route": "cuda", "source": "sarssl_torch/csrc/" + ROUTE_SOURCES[route],
                "variant": {"tc": "mma", "tf32x3": "mma_tf32x3"}[route] + "_wide"
                + ("" if at256 else "_cols"),
                "replaces": f"sarssl_tpu/kernels/attention.py:{line}",
                "launches": n,
                "max_abs_err": r["out_err"] if kind == "fwd" else r["max_abs_err"],
                "ms": r[f"{kind}_ms"], "plain_ms": yard[f"plain_{kind}_ms"],
                "bound_ms": yard[f"{kind}_bound"][0], "bound_by": yard[f"{kind}_bound"][1],
                "library_ms": yard[f"lib_{kind}_ms"], "fma_ms": None,
                "path": ("no model path runs the bf16 wide forward at D = 256 (the D = 256 "
                         "instance takes it; the backward runs the wide one, the D = 256 rows); "
                         "launched through _wide_launches beside that instance "
                         "(instance_readings_ms), the same kernels as the D = 512 rows"
                         if at256 else
                         "no model path has head dim 300 or 1000: the wide instance's column "
                         "tail (attn_*_wide_cols), unpadded, driven in phase kernels alone; "
                         "padded_fwd_ms / padded_bwd_ms: the route through the padding to "
                         "320 / 1024 it replaced, whose kernels phase ref's "
                         "SARSSLConfig.tiny(spec_dembed=1280) runs at head dim 320"),
                **({"readings_ms": r["fwd_readings"],
                    "instance_readings_ms": r["inst_fwd_readings"]} if at256 else
                   {"runs_at": [r["Dp"], r["Db"]], "batch": WIDE_B,
                    "padded_ms": r[f"padded_{kind}_ms"]}),
                # the forward at the key splits chosen at this batch and at one,
                # launched at the padded head dim (queued readings: chosen, 1,
                # 1, chosen); its split launches over the model phases
                **({"splits": r["splits"], "launch_ms": r["launch_ms"],
                    "launch_splits_1_ms": r["launch_splits_1_ms"],
                    "launch_readings_ms": r["launch_readings_ms"],
                    "launches_split": sum(c.get(split, 0) for c in model_phases)}
                   if kind == "fwd" and not at256 else {}),
            })
    out.append({
        "name": "hash_dropout", "route": "triton",
        "source": "sarssl_torch/kernels/dropout.py",
        "replaces": "sarssl_tpu/kernels/dropout.py:40",
        "launches": counts.get("hash_dropout", 0), "max_abs_err": drop["max_abs_err"],
        "ms": drop["ms"], "plain_ms": drop["plain_ms"], "bound_ms": drop["bound"][0],
        "bound_by": drop["bound"][1], "library_ms": drop["library_ms"],
        "path": "pretext train step (launches), the pre-training CLI run "
                "(launches_pretrain_cli), its frozen-encoder and mel runs "
                "(launches_pretrain_options), the downstream finetune step "
                "(launches_downstream), the downstream CLI's runs a, b and d "
                "(launches_downstream_cli), the data path's pre-training and downstream "
                "runs (launches_data_path) and the real-data path's (launches_real_data)",
        "launches_pretrain_cli": cli_counts.get("hash_dropout", 0),
        "launches_pretrain_options": opt_counts.get("hash_dropout", 0),
        "launches_downstream": ds_counts.get("hash_dropout", 0),
        "launches_downstream_cli": dscli_counts.get("hash_dropout", 0),
        "launches_data_path": data_counts.get("hash_dropout", 0),
        "launches_real_data": real_counts.get("hash_dropout", 0),
        "launches_model_options": mo_counts.get("hash_dropout", 0),
        "launches_grid_vmap": grid_counts.get("hash_dropout", 0),
    })
    out.append({
        "name": "hash_dropout_lanes", "route": "triton",
        "source": "sarssl_torch/kernels/dropout.py",
        "replaces": "sarssl_tpu/kernels/dropout.py:40",
        "launches": grid_counts.get("hash_dropout_lanes", 0),
        "max_abs_err": lanes["max_abs_err"], "ms": lanes["ms"], "launch_ms": lanes["launch_ms"],
        "plain_ms": lanes["plain_ms"],
        "bound_ms": lanes["bound"][0], "bound_by": lanes["bound"][1],
        "library_ms": lanes["library_ms"],
        "path": "every dropout site of the vmapped downstream grid (run_downstream "
                "--grid-vmap: finetune, lineareval, resident packed data; launches), one seed a "
                "lane; timed at (8, 8, 64, 2048) f32",
        "launches_grid_vmap": grid_counts.get("hash_dropout_lanes", 0),
    })
    for name in CONV_LAUNCHES:
        r = conv[name]
        out.append({
            "name": name, "route": "cuda", "source": "sarssl_torch/csrc/conv3x3_mma.cu",
            "variant": "wgmma", "replaces": CONV_REPLACES[name.rsplit("_", 1)[0]],
            "launches": r["launches"], "launches_tc": r["launches_tc"],
            "fma_ms": r["fma_ms"], "launch_ms": r["launch_ms"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
            "path": "no model path launches it; launches counted over the conv path run "
                    "of the kernels phase",
            "launches_pretrain_options": opt_counts.get(name, 0),
            "launches_downstream_cli": dscli_counts.get(name, 0),
            "launches_data_path": data_counts.get(name, 0),
            "launches_real_data": real_counts.get(name, 0),
            "launches_model_options": mo_counts.get(name, 0),
            "launches_grid_vmap": grid_counts.get(name, 0),
        })
    for name in CONV_LAUNCHES:  # the same launches in f32, on the 3xTF32 kernel
        r, tf32 = conv[f"{name}_float32"], f"{name}_tf32"
        out.append({
            "name": f"{name}_float32", "route": "cuda",
            "source": "sarssl_torch/csrc/conv3x3_tf32.cu", "variant": "wgmma_tf32x3",
            "replaces": CONV_REPLACES[name.rsplit("_", 1)[0]],
            "launches": r["launches"], "launches_tf32": r["launches_tf32"],
            "fma_ms": r["fma_ms"], "ms_again": r["ms_again"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
            "path": "no model path launches it; launches counted over the f32 conv path run "
                    "of the kernels phase",
            "launches_pretrain_options": opt_counts.get(tf32, 0),
            "launches_downstream_cli": dscli_counts.get(tf32, 0),
            "launches_data_path": data_counts.get(tf32, 0),
            "launches_real_data": real_counts.get(tf32, 0),
            "launches_model_options": mo_counts.get(tf32, 0),
            "launches_grid_vmap": grid_counts.get(tf32, 0),
        })
    # phase edges: each input past one launch's grid or 32-bit offsets
    out += edges
    for row in out:  # phase ablations asserts that every count read 0
        row["launches_ablations"] = abl_counts.get(row["name"], 0)
    # phase mesh: the launches of its sharded step and meshed CLI runs, and
    # each kernel's index-mapped launch (a tensor-parallel rank's half of the
    # heads or units) beside the same launch unsharded
    att = {(f"attention_{kind}_d{D}" if L == SEQ and dtype == torch.bfloat16 else
            f"attention_{kind}_d{D}_L{L}_{str(dtype)[6:]}"): (r, kind)
           for (L, D, dtype), r in mesh["attention"].items() for kind in ("fwd", "bwd")}
    for row in out:
        row["launches_mesh"] = mesh_counts.get(row["name"], 0)
        if row["name"] in att:
            r, kind = att[row["name"]]
            row.update(index_args="(heads_total, head_offset)",
                       index_map_ms=r[f"mapped_{kind}_ms"],
                       index_map_unsharded_ms=r[f"unmapped_{kind}_ms"])
        elif row["name"] == "hash_dropout":
            row.update(index_args="(row_local, row_total, col_offset)",
                       index_map_ms=mesh["dropout"]["mapped_ms"],
                       index_map_unsharded_ms=mesh["dropout"]["unmapped_ms"])
    return {"kernels": out}


REF_STEPS = 2


def _card_against_cpu(what, cfg, feat, wave, want_attention):
    """REF_STEPS pretext train steps of ``cfg`` on the card (kernels) and on
    the CPU (plain versions), dropout on and the same seeds, so both draw
    identical masks; the card's attention launches asserted exactly
    (``want_attention`` a step), none of the FMA kernels. Returns the card's
    launch counts."""
    from sarssl_torch.kernels import launches, reset_launches
    from sarssl_torch.models import SARSSL
    from sarssl_torch.train import create_train_state, make_pretrain_step

    losses = {}
    for dev in ("cuda", "cpu"):
        model = SARSSL(cfg, device=dev, seed=3)
        state = create_train_state(model)
        step = make_pretrain_step(model, feat, device=dev)
        gen = torch.Generator().manual_seed(5)
        reset_launches()
        losses[dev] = [float(step(state, torch.from_numpy(wave), 1e-3, gen)["loss"])
                       for _ in range(REF_STEPS)]
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = _kernel_counts()
    att = {k: v for k, v in counts.items() if k.startswith("attention_")}
    want = {k: v * REF_STEPS for k, v in want_attention.items()}
    assert att == want, f"{what}: attention launches {att}, want {want}"
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"[ref] {what}, {REF_STEPS} steps, dropout {RATE}: card {losses['cuda']} cpu "
        f"{losses['cpu']} max rel err {err:.2e} (tol {TOL_REF}); launches {counts}")
    assert err <= TOL_REF, f"{what}: card and CPU losses differ by {err}"
    return counts


def phase_reference():
    """Small models: card (kernels) against CPU (plain versions), f32: one at
    head dims 32 and 16, then ``SARSSLConfig.tiny(fused_attention=True)``,
    whose 4 heads over d = 32 and 16 give head dims 8 and 4, which run the D =
    16 instances through the padding, then the same with ``spec_dembed=1024``
    (head dim 256 at L = 16) and with ``spec_dembed=1280`` (head dim 320 on
    the wide instance, blocks of 64 columns). Returns the three tiny models'
    counts."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSLConfig
    from sarssl_torch.ops import FeatureConfig

    cfg = SARSSLConfig().tiny(sig_shape=(64, 64, 2, 2), patch_shape=(64, 1),
                              spec_dembed=128, spat_dembed=64, spat_layers=2,
                              dropout=RATE, fused_attention=True)
    wave, _ = synth_batch(np.random.default_rng(1), 8, 63 * 64 + 128)
    _card_against_cpu("small pretext model (D = 32, 16)", cfg,
                      FeatureConfig(win_len=128, nfft=128), wave,
                      _attention_want((32, 1, "tf32x3"), (16, 2, "tf32x3")))
    tiny = SARSSLConfig().tiny(dropout=RATE, fused_attention=True)
    nf, nt = tiny.sig_shape[:2]
    wave, _ = synth_batch(np.random.default_rng(2), 8, (nt - 1) * nf + 2 * nf)
    feat = FeatureConfig(win_len=2 * nf, nfft=2 * nf)
    tiny_counts = _card_against_cpu("SARSSLConfig.tiny(fused_attention=True) (D = 8, 4)", tiny,
                                    feat, wave,
                                    _attention_want((16, 1, "tf32x3", True),
                                                    (16, 1, "tf32x3", True)))
    d256_counts = _card_against_cpu(
        "SARSSLConfig.tiny(spec_dembed=1024, fused_attention=True) (D = 256, 4)",
        SARSSLConfig().tiny(spec_dembed=1024, dropout=RATE, fused_attention=True), feat, wave,
        _attention_want((256, 1, "tf32x3"), (16, 1, "tf32x3", True)))
    d320_counts = _card_against_cpu(
        "SARSSLConfig.tiny(spec_dembed=1280, fused_attention=True) (D = 320 wide, 4)",
        SARSSLConfig().tiny(spec_dembed=1280, dropout=RATE, fused_attention=True), feat, wave,
        _attention_want((320, 1, "tf32x3"), (16, 1, "tf32x3", True)))
    return tiny_counts, d256_counts, d320_counts


def _assert_no_conv_launch(counts, step):
    """The conv kernels are on no model path: a step that launched one moved."""
    conv = {k: v for k, v in counts.items() if k.startswith("conv3x3")}
    assert not conv, f"the {step} step launched conv kernels: {conv}"


def phase_train(card):
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.kernels import launches, reset_launches
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import (create_train_state, make_pretrain_eval_step,
                                    make_pretrain_step)

    cfg = SARSSLConfig(dtype="bfloat16", fused_attention=True)
    model = SARSSL(cfg, device="cuda", seed=0)
    state = create_train_state(model)
    step = make_pretrain_step(model, FeatureConfig(), device="cuda")
    wave, _ = synth_batch(np.random.default_rng(0), BATCH, NSAMPLE)
    wave = torch.from_numpy(wave).cuda()
    gen = torch.Generator().manual_seed(0)

    t0 = time.perf_counter()
    warm = float(step(state, wave, 1e-3, gen)["loss"])
    log(f"[train] warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms, loss {warm:.5f}")
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_launches()
    for _ in range(STEPS):
        t0 = time.perf_counter()
        metrics = step(state, wave, 1e-3, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = dict(launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    assert all(np.isfinite(losses)), f"non-finite loss {losses}"
    for D in HEAD_DIMS:
        want = LAYERS[D] * STEPS
        for kind in ("fwd", "bwd", "fwd_tc", "bwd_tc"):
            got = counts.get(f"attention_{kind}_d{D}", 0)
            assert got == want, f"attention_{kind}_d{D}: {got} launches, want {want}"
    assert counts.get("hash_dropout", 0) > 0, "hash_dropout never launched"
    _assert_no_conv_launch(counts, "pretext")
    med = statistics.median(times)
    log(f"[train] launches over {STEPS} steps: {counts}")
    log(f"[train] losses {losses} ({card})")
    log(f"[train] median step {1e3 * med:.1f} ms, {BATCH / med:.1f} utt/s, peak memory "
        f"{peak_gib:.2f} GiB ({card})")

    ev = make_pretrain_eval_step(model, FeatureConfig(), device="cuda")(state, wave, gen)
    ev = {k: float(v) for k, v in ev.items()}
    assert all(np.isfinite(list(ev.values()))), f"non-finite eval metrics {ev}"
    log(f"[train] eval step {ev}")
    return counts, model, BATCH / med


class _Tee:
    """Standard output that also keeps what was written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _cli(argv, cli="run_pretrain"):
    """``sarssl_torch.cli.<cli>.main(argv)``; returns its printed output."""
    import contextlib
    import importlib

    main = importlib.import_module(f"sarssl_torch.cli.{cli}").main
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = main(argv)
    assert rc == 0, f"{cli} {argv}: exit {rc}"
    return "".join(tee.text)


class _Timed:
    """Wraps functions that a run looks up by module (or class) attribute, so
    each call is timed, with the card synchronised before and after when
    ``sync``; ``undo`` puts the originals back."""

    def __init__(self):
        self.spent, self.saved = {}, []

    def _timed(self, fn, key, sync):
        def run(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            self.spent[key].append(time.perf_counter() - t0)
            return out
        return run

    def wrap(self, owner, name, key=None, sync=False):
        fn, key = getattr(owner, name), key or name
        self.spent.setdefault(key, [])
        self.saved.append((owner, name, fn))
        setattr(owner, name, self._timed(fn, key, sync))

    def wrap_made(self, owner, name, key):
        """Wraps a factory: each call of the function it returns is timed,
        synchronised (the steps that ``make_pretrain_step`` makes)."""
        make = getattr(owner, name)
        self.spent.setdefault(key, [])
        self.saved.append((owner, name, make))
        setattr(owner, name, lambda *a, **k: self._timed(make(*a, **k), key, True))

    def undo(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


def phase_pretrain_cli(card, step_utt_s):
    """The flagship pre-training run through its CLI: 2 epochs, then resumed
    to a third. The host's synthetic batches and checkpoint writes are timed
    by wrapping the two functions the run calls."""
    import tempfile

    from sarssl_torch.data import synthetic
    from sarssl_torch.kernels import launches, reset_launches
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.train.schedules import cosine_schedule

    timer = _Timed()
    timer.wrap(synthetic, "synth_batch", "synth")
    timer.wrap(ckpt, "save_checkpoint", "ckpt")
    spent = timer.spent
    try:
        with tempfile.TemporaryDirectory(prefix="pretrain_cli_") as exp:
            common = ["--pretrain", "--synthetic", "--fused-attention", "--bs", str(BATCH),
                      "--train-num", str(CLI_TRAIN_NUM), "--val-num", str(CLI_VAL_NUM),
                      "--exp-dir", exp]
            reset_launches()
            t0 = time.perf_counter()
            first = _cli(common + ["--epochs", "2"])
            t1 = time.perf_counter()
            second = _cli(common + ["--epochs", "3", "--resume"])
            wall = (t1 - t0, time.perf_counter() - t1)
            torch.cuda.synchronize()
            counts = dict(launches)
            files = {f: os.path.getsize(os.path.join(exp, "checkpoints", f))
                     for f in sorted(os.listdir(os.path.join(exp, "checkpoints")))}
            with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
    finally:
        timer.undo()

    # the shares below are only as good as the wrappers: both must have
    # caught every call the run made (train and val batches, one file each epoch)
    n_batches = 3 * (CLI_TRAIN_NUM + CLI_VAL_NUM) // BATCH
    assert len(spent["synth"]) == n_batches, f"{len(spent['synth'])} synthetic batches timed"
    assert len(spent["ckpt"]) == 3, f"{len(spent['ckpt'])} checkpoint writes timed"
    assert "device cuda" in first and "TF32 off" in first, "the CLI did not report its device"
    assert "epoch 0:" in first and "epoch 1:" in first and "epoch 2:" not in first
    assert "resumed from epoch 1 (latest_model.msgpack)" in second, second
    assert "epoch 2:" in second and "epoch 1:" not in second, "the resumed run ran another epoch"
    want = {f"model{e}.msgpack" for e in range(3)} | {"latest_model.msgpack",
                                                       "best_model.msgpack"}
    assert want <= set(files), f"checkpoint files {sorted(files)}"
    train = [r for r in recs if r["split"] == "train"]
    val = [r for r in recs if r["split"] == "val"]
    lrs = [cosine_schedule(2, CLI_LR)(0), cosine_schedule(2, CLI_LR)(1),
           cosine_schedule(3, CLI_LR)(2)]
    assert [r["step"] for r in train] == [0, 1, 2], train
    assert [r["lr"] for r in train] == lrs, (train, lrs)
    assert [r["step"] for r in val] == [0, 1, 2], val
    assert all(np.isfinite([r["loss"] for r in recs])), recs

    batches = CLI_TRAIN_NUM // BATCH
    train_steps, val_steps = 3 * batches, 3 * (CLI_VAL_NUM // BATCH)
    for D in HEAD_DIMS:
        for kind, n in (("fwd", train_steps + val_steps), ("bwd", train_steps)):
            for name in (f"attention_{kind}_d{D}", f"attention_{kind}_tc_d{D}"):
                got = counts.get(name, 0)
                assert got == LAYERS[D] * n, f"{name}: {got} launches, want {LAYERS[D] * n}"
    assert counts.get("hash_dropout", 0) > 0, "hash_dropout never launched on the CLI run"
    _assert_no_conv_launch(counts, "pre-training CLI")
    log(f"[pretrain_cli] launches over {train_steps} train and {val_steps} val steps: {counts}")
    log(f"[pretrain_cli] losses: train {[round(r['loss'], 5) for r in train]}, val "
        f"{[round(r['loss'], 5) for r in val]}, val diff {[round(r['diff'], 5) for r in val]}, "
        f"lr {lrs}")
    log(f"[pretrain_cli] epoch utt/s {[r['utt_per_sec'] for r in train]} beside the "
        f"train phase's step {step_utt_s:.1f} utt/s ({card})")
    log(f"[pretrain_cli] wall {wall[0]:.2f} s (2 epochs) + {wall[1]:.2f} s (resumed epoch); "
        f"synthetic batches on the host: {len(spent['synth'])} in {sum(spent['synth']):.2f} s "
        f"({sum(spent['synth']) / sum(wall):.1%} of the wall time); checkpoint writes: "
        f"{len(spent['ckpt'])} in {sum(spent['ckpt']):.2f} s "
        f"({sum(spent['ckpt']) / sum(wall):.1%}), {spent['ckpt']} ({card})")
    log(f"[pretrain_cli] checkpoint files (bytes): {files}")
    return counts, [r["utt_per_sec"] for r in train]


def _opt_run(what, argv, card, tag="pretrain_options"):
    """One ``run_pretrain`` call with the launch counts zeroed before and
    read after; returns (printed output, counts, wall seconds)."""
    from sarssl_torch.kernels import launches, reset_launches

    reset_launches()
    t0 = time.perf_counter()
    out = _cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    assert "device cuda" in out and "TF32 off" in out, f"{what}: the CLI did not report its device"
    log(f"[{tag}] {what}: wall {wall:.2f} s, launches {counts} ({card})")
    return out, counts, wall


def _check_opt_attention(what, counts, fwd_steps, bwd_steps):
    for D in HEAD_DIMS:
        for kind, n in (("fwd", fwd_steps), ("bwd", bwd_steps)):
            for name in (f"attention_{kind}_d{D}", f"attention_{kind}_tc_d{D}"):
                got = counts.get(name, 0)
                assert got == LAYERS[D] * n, f"{what}: {name} {got} launches, want {LAYERS[D] * n}"
    _assert_no_conv_launch(counts, what)


def _flat(tree, path=()):
    """{'a/b/c': leaf} of a nested checkpoint dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = np.asarray(v)
    return out


def _pretext_test_run(tmp, card):
    """(a) ``--test`` on the committed trained checkpoint: 2 val batches."""
    import shutil

    from sarssl_torch import models
    from sarssl_torch.cli import run_pretrain
    from sarssl_torch.data import read_wav, synthetic
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.train import pretext_eval
    from sarssl_torch.utils import pesq, vis

    exp = os.path.join(tmp, "a")
    os.makedirs(os.path.join(exp, "checkpoints"))
    shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT,
                    ckpt.best_path(os.path.join(exp, "checkpoints")))
    timer = _Timed()
    timer.wrap(synthetic, "synth_batch", "synth")
    timer.wrap(models.SARSSL, "pretext", "forward", sync=True)
    timer.wrap(pretext_eval, "reconstruct_waveforms", "istft", sync=True)
    timer.wrap(pesq, "pesq_wb", "pesq")
    timer.wrap(run_pretrain, "_write_dumps", "dumps")
    try:
        out, counts, wall = _opt_run("(a) --test", [
            "--test", "--synthetic", "--fused-attention", "--bs", str(BATCH),
            "--val-num", str(OPT_TEST_VAL_NUM), "--exp-dir", exp], card)
    finally:
        timer.undo()
    spent = timer.spent
    nbatch = OPT_TEST_VAL_NUM // BATCH
    # the shares below are only as good as the wrappers: each caught every call
    want = {"synth": nbatch, "forward": nbatch, "istft": 2 * nbatch,
            "pesq": nbatch * BATCH * 2, "dumps": 1}
    got = {k: len(v) for k, v in spent.items()}
    assert got == want, (got, want)
    assert "loaded best checkpoint (epoch 27)" in out, out
    dumps = os.path.join(exp, "test_dumps")
    with open(os.path.join(dumps, "metrics.json")) as f:
        metrics = json.load(f)
    assert set(metrics) == {"mse", "mse_mask", "pesq", "pesq_mask_ch"}, metrics
    assert np.isfinite(list(metrics.values())).all(), metrics
    for k in ("pesq", "pesq_mask_ch"):  # the P.862.2 mapping's open range
        assert 0.999 < metrics[k] < 4.999, metrics
    files = set(os.listdir(dumps))
    assert {f for f in files if f.startswith("ins_")} == {f"ins_{i}.mat" for i in range(32)}
    for f in ("pred0.wav", "tar0.wav"):
        wav, fs = read_wav(os.path.join(dumps, f))
        assert fs == 16000 and wav.shape == (NSAMPLE, 2) and np.isfinite(wav).all(), f
        assert np.abs(wav).max() <= 1.0, f  # peak-normalised over the batch
    assert os.path.exists(os.path.join(exp, "config_test.json"))
    assert not os.path.exists(os.path.join(exp, "config.json")), "--test wrote config.json"
    if vis._plt() is None:
        assert "recon_tf.png" not in files
        assert "recon_tf.png not written: matplotlib is not installed" in out, out
        plot = "not written (no matplotlib)"
    else:
        assert "recon_tf.png" in files
        plot = "written"
    _check_opt_attention("(a) --test", counts, nbatch, 0)
    assert not counts.get("hash_dropout", 0), f"(a) --test launched dropout: {counts}"
    shares = ", ".join(f"{k} {len(v)} calls {sum(v):.2f} s ({sum(v) / wall:.1%})"
                       for k, v in spent.items())
    log(f"[pretrain_options] (a) --test, epoch-27 checkpoint, {nbatch} batches of {BATCH}: "
        f"{metrics}; 32 ins_*.mat, pred0.wav, tar0.wav, config_test.json; recon_tf.png {plot}")
    log(f"[pretrain_options] (a) wall {wall:.2f} s: {shares}; forward "
        f"{[round(1e3 * t, 1) for t in spent['forward']]} ms ({card})")
    return counts


def _frozen_encoder_run(tmp, card, train_ms):
    """(b) the decoder retrained over the trained checkpoint's frozen
    encoders: 1 epoch of 4 train and 1 val batches."""
    import shutil

    import sarssl_torch.train as train_pkg
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.utils import from_jax_params

    init = os.path.join(tmp, "init")
    os.makedirs(init)
    shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT, ckpt.best_path(init))
    exp = os.path.join(tmp, "b")
    timer = _Timed()
    timer.wrap_made(train_pkg, "make_pretrain_step", "step")
    try:
        out, counts, wall = _opt_run("(b) --pretrain-frozen-encoder", [
            "--pretrain", "--synthetic", "--fused-attention", "--bs", str(BATCH), "--epochs", "1",
            "--train-num", str(OPT_TRAIN_NUM), "--val-num", str(OPT_VAL_NUM),
            "--pretrain-frozen-encoder", "--init-ckpt", init, "--exp-dir", exp], card)
    finally:
        timer.undo()
    steps = timer.spent["step"]
    nsteps = OPT_TRAIN_NUM // BATCH
    assert len(steps) == nsteps, steps
    src = ckpt.load_checkpoint(ckpt.best_path(init))
    n = len(from_jax_params({"params": src["params"]})[0])
    assert f"partial_load: {n}/{n} keys loaded" in out, out
    saved = ckpt.load_checkpoint(ckpt.latest_path(os.path.join(exp, "checkpoints")))
    got, want = _flat(saved["params"]), _flat(src["params"])
    adam = saved["opt_state"]["inner_state"]["0"]["0"]
    mu, nu = _flat(adam["mu"]), _flat(adam["nu"])
    assert set(got) == set(want) == set(mu) and len(got) == n
    enc = [k for k in got if not k.startswith("decoder")]
    dec = [k for k in got if k.startswith("decoder")]
    assert enc and dec
    for k in enc:  # f16 in the file, read as f32
        assert np.array_equal(got[k], want[k].astype(np.float32)), f"(b): encoder {k} moved"
        assert not mu[k].any() and not nu[k].any(), f"(b): frozen {k} has Adam moments"
    for k in dec:
        assert not np.array_equal(got[k], want[k].astype(np.float32)), f"(b): {k} did not move"
    stats = _flat(saved["batch_stats"])
    for k, v in stats.items():  # from the init (mean 0, var 1): partial_load copies no stats
        assert not np.array_equal(v, np.zeros_like(v) if k.endswith("mean") else np.ones_like(v)), (
            f"(b): BatchNorm stat {k} did not move")
    _check_opt_attention("(b) frozen encoder", counts, nsteps + OPT_VAL_NUM // BATCH, 0)
    want_drop = PRETRAIN_DROPOUT_PER_STEP["frozen"] * nsteps
    assert counts.get("hash_dropout", 0) == want_drop, (
        f"(b): hash_dropout {counts.get('hash_dropout', 0)} launches, want {want_drop}")
    log(f"[pretrain_options] (b) frozen encoders: partial_load {n}/{n}; {len(enc)} encoder "
        f"parameters bit-identical to the checkpoint's (f16 read as f32) with zero Adam moments, "
        f"{len(dec)} decoder parameters moved, all {len(stats)} BatchNorm stats moved; attention "
        f"backward 0 launches (no encoder backward), hash_dropout {want_drop} = "
        f"{PRETRAIN_DROPOUT_PER_STEP['frozen']} x {nsteps} train steps")
    log(f"[pretrain_options] (b) train steps {[round(1e3 * t, 1) for t in steps]} ms, median "
        f"after the first {1e3 * statistics.median(steps[1:]):.1f} beside phase train's "
        f"{train_ms:.1f} ms ({card})")
    return counts


def _mel_run(tmp, card, train_ms):
    """(c) pre-training on 30 mel bands: 1 epoch of 4 train and 1 val batches."""
    import sarssl_torch.train as train_pkg
    from sarssl_torch import models
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.ops import FeatureConfig, stft_features

    exp = os.path.join(tmp, "c")
    timer = _Timed()
    timer.wrap_made(train_pkg, "make_pretrain_step", "step")
    shapes, pretext = set(), models.SARSSL.pretext

    def seen(self, *a, **k):
        shapes.add(self.cfg.sig_shape)
        return pretext(self, *a, **k)
    models.SARSSL.pretext = seen
    try:
        _, counts, wall = _opt_run(f"(c) --mel-bins {MEL_BINS}", [
            "--pretrain", "--synthetic", "--fused-attention", "--bs", str(BATCH), "--epochs", "1",
            "--train-num", str(OPT_TRAIN_NUM), "--val-num", str(OPT_VAL_NUM),
            "--mel-bins", str(MEL_BINS), "--exp-dir", exp], card)
    finally:
        models.SARSSL.pretext = pretext
        timer.undo()
    steps = timer.spent["step"]
    nsteps = OPT_TRAIN_NUM // BATCH
    assert len(steps) == nsteps, steps
    assert shapes == {(MEL_BINS, SEQ, 2, 2)}, shapes
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["split"] for r in recs] == ["train", "val"], recs
    assert np.isfinite([r[k] for r in recs for k in ("loss", "diff")]).all(), recs
    _check_opt_attention("(c) mel", counts, nsteps + OPT_VAL_NUM // BATCH, nsteps)
    want_drop = PRETRAIN_DROPOUT_PER_STEP["train"] * nsteps
    assert counts.get("hash_dropout", 0) == want_drop, (
        f"(c): hash_dropout {counts.get('hash_dropout', 0)} launches, want {want_drop}")
    wave, _ = synth_batch(np.random.default_rng(13), BATCH, NSAMPLE)
    cfg = FeatureConfig(mel_bins=MEL_BINS)
    feats = {dev: stft_features(torch.from_numpy(wave).to(dev), cfg).cpu() for dev in ("cuda", "cpu")}
    err = rel_err(feats["cuda"], feats["cpu"])
    assert feats["cpu"].shape == (BATCH, 2, MEL_BINS, SEQ, 2), feats["cpu"].shape
    assert err <= TOL_REF, f"(c): mel features on the card against the CPU: rel err {err}"
    log(f"[pretrain_options] (c) mel {MEL_BINS}: model sig_shape {shapes.pop()}; losses train "
        f"{recs[0]['loss']:.5f} val {recs[1]['loss']:.5f} diff {recs[1]['diff']:.5f}; one batch's "
        f"mel features card against CPU rel err {err:.2e} (tol {TOL_REF}); hash_dropout "
        f"{want_drop} = {PRETRAIN_DROPOUT_PER_STEP['train']} x {nsteps}")
    log(f"[pretrain_options] (c) train steps {[round(1e3 * t, 1) for t in steps]} ms, median "
        f"after the first {1e3 * statistics.median(steps[1:]):.1f} beside phase train's "
        f"{train_ms:.1f} ms ({card})")
    return counts


def phase_pretrain_options(card, train_ms):
    """The pre-training CLI's remaining options at the flagship width, three
    calls each with the launch counts zeroed before and read after: (a)
    ``--test`` on the committed trained checkpoint (ISTFT, PESQ, dumps);
    (b) ``--pretrain-frozen-encoder`` from it; (c) ``--mel-bins 30``."""
    import tempfile

    total = {}
    with tempfile.TemporaryDirectory(prefix="pretrain_options_") as tmp:
        for counts in (_pretext_test_run(tmp, card), _frozen_encoder_run(tmp, card, train_ms),
                       _mel_run(tmp, card, train_ms)):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    return total


def _ds_cli_run(what, argv, spent, card):
    """One ``run_downstream`` call with the launch counts zeroed before and
    read after, and the learners it built caught; returns (printed output,
    counts, learners, wall seconds)."""
    from sarssl_torch.kernels import launches, reset_launches
    from sarssl_torch.train import learner as learner_mod

    cls = learner_mod.DownstreamLearner
    learners, started = [], {}
    train_epoch, end_epoch = cls.train_epoch, cls.end_epoch

    def timed_train(self, *a, **k):
        if self not in learners:
            learners.append(self)
        started[id(self)] = time.perf_counter()
        return train_epoch(self, *a, **k)

    def timed_end(self, *a, **k):
        out = end_epoch(self, *a, **k)
        spent["cell_epoch"].append(time.perf_counter() - started.pop(id(self)))
        return out

    cls.train_epoch, cls.end_epoch = timed_train, timed_end
    try:
        reset_launches()
        t0 = time.perf_counter()
        out = _cli(argv, "run_downstream")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        cls.train_epoch, cls.end_epoch = train_epoch, end_epoch
    assert "device cuda" in out and "TF32 off" in out, f"{what}: the CLI did not report its device"
    log(f"[downstream_cli] {what}: wall {wall:.2f} s, launches {counts} ({card})")
    return out, counts, learners, wall


def _ds_train_steps(learners, nbatch):
    return sum(lr.epoch for lr in learners) * nbatch


def _check_ds_launches(what, counts, steps, kind):
    want = DS_DROPOUT_PER_STEP[kind] * steps
    assert counts.get("hash_dropout", 0) == want, (
        f"{what}: hash_dropout {counts.get('hash_dropout', 0)} launches, want {want} "
        f"({DS_DROPOUT_PER_STEP[kind]} x {steps} train steps)")
    other = {k: v for k, v in counts.items() if k.startswith(("attention", "conv3x3"))}
    assert not other, f"{what}: attention or conv kernels launched: {other}"


def _read_results(exp):
    from sarssl_torch.utils.results import read_results
    res = read_results(exp)
    assert set(res) == {"task", "mode", "cells", "summary", "best", "best_test_mae"}, set(res)
    for cell, r in res["cells"].items():
        assert set(r) == {"val_mae", "test_mae", "lr", "bs", "trial", "epochs_run"}, r
        assert np.isfinite([r["val_mae"], r["test_mae"]]).all(), (cell, r)
    return res


def _records(exp, cell):
    with open(os.path.join(exp, cell, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_downstream_cli(card):
    """The downstream grid through its CLI, ``run_downstream.main``, at the
    flagship width (f32, TDOA, 1.04 s clips, batch 8) from the committed
    trained checkpoint: (a) finetune over lr {1e-3, 1e-4}, 3 epochs a cell;
    (b) one lineareval cell; (c) ``--ds-test`` on a cell of (a), and the
    no-train baseline; (d) the multi-pair model, 4 mics, all 6 pairs; (e)
    ``--ds-test-mode vis_embed`` on that cell. The host's synthetic batches
    and checkpoint writes are timed by wrapping the functions the runs
    call."""
    import importlib.util
    import shutil
    import tempfile

    from sarssl_torch import models
    from sarssl_torch.data import synthetic
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.train import create_train_state
    from sarssl_torch.utils import vis
    from sarssl_torch.utils.weights import from_jax_params, to_jax_params

    timer = _Timed()
    timer.spent["cell_epoch"] = []
    timer.wrap(synthetic, "synth_batch")
    timer.wrap(synthetic, "synth_batch_multich")
    timer.wrap(ckpt, "save_checkpoint")
    timer.wrap(ckpt, "save_named")
    spent = timer.spent
    total = {}
    try:
        with tempfile.TemporaryDirectory(prefix="downstream_cli_") as tmp:
            pre = os.path.join(tmp, "pretrained")
            os.makedirs(pre)
            shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT,
                            ckpt.best_path(pre))
            common = ["--ds-train", "--synthetic", "--ds-task", "TDOA", "--bs-set", str(DS_BATCH),
                      "--ntrial", "1", "--pretrain-ckpt", pre, *DSCLI_NUMS]
            nbatch = int(DSCLI_NUMS[1]) // DS_BATCH
            marks = {}

            def mark(run):  # the calls caught so far, to split them by run
                marks[run] = {k: len(v) for k, v in spent.items()}

            # (a) finetune, 2 lr cells
            exp_a = os.path.join(tmp, "a")
            out, counts, learners, wall_a = _ds_cli_run(
                "(a) finetune", common + ["--lr-set", "1e-3", "1e-4", "--epochs",
                                          str(DSCLI_EPOCHS), "--exp-dir", exp_a], spent, card)
            mark("a")
            res = _read_results(exp_a)
            cells = ["trial0_bs8_lr0.001", "trial0_bs8_lr0.0001"]  # the grid's order
            assert sorted(res["cells"]) == sorted(cells) and len(learners) == 2, res["cells"]
            n_enc = len([n for n in from_jax_params(ckpt.load_checkpoint(
                ckpt.best_path(pre)))[0] if n.startswith(("spec_encoder.", "spat_encoder."))])
            assert out.count(f"partial_load: {n_enc}/{n_enc + 4} parameters loaded") == 2, out
            sizes = {}
            for cell, lrn in zip(cells, learners):
                assert res["cells"][cell]["epochs_run"] == lrn.epoch == DSCLI_EPOCHS
                files = set(os.listdir(os.path.join(exp_a, cell, "ckpt")))
                kept = {f for f in files if re.fullmatch(r"model\d+\.msgpack", f)}
                assert "ensemble_model.msgpack" in files, (cell, files)
                assert kept == {f"model{e}.msgpack" for e in lrn.best_epochs[-5:]}, (
                    cell, kept, lrn.best_epochs)
                sizes.update({f: os.path.getsize(os.path.join(exp_a, cell, "ckpt", f))
                              for f in files})
            steps_a = _ds_train_steps(learners, nbatch)
            _check_ds_launches("(a)", counts, steps_a, "finetune")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            log("[downstream_cli] (a) results: " + ", ".join(
                f"{c}: val MAE {res['cells'][c]['val_mae']:.5f} test MAE "
                f"{res['cells'][c]['test_mae']:.5f} best epochs {lrn.best_epochs}"
                for c, lrn in zip(cells, learners))
                + f"; best {res['best']}; hash_dropout {counts.get('hash_dropout', 0)} = "
                f"{DS_DROPOUT_PER_STEP['finetune']} x {steps_a} train steps; files (bytes) {sizes}")

            # (b) lineareval, 1 cell
            exp_b = os.path.join(tmp, "b")
            _, counts, learners, wall_b = _ds_cli_run(
                "(b) lineareval", common + ["--ds-trainmode", "lineareval", "--lr-set", "1e-3",
                                            "--epochs", str(DSCLI_LIN_EPOCHS), "--exp-dir",
                                            exp_b], spent, card)
            mark("b")
            _read_results(exp_b)
            ens = ckpt.load_checkpoint(ckpt.ensemble_path(os.path.join(
                exp_b, "trial0_bs8_lr0.001", "ckpt")))
            ens_p, ens_b = from_jax_params(ens)
            src = from_jax_params(ckpt.load_checkpoint(ckpt.best_path(pre)))[0]  # f16 -> f32
            cfg = models.SARSSLConfig(sig_shape=(256, DS_FRAMES, 2, 2), pretrain=False,
                                      dtype="float32")
            init = models.SARSSL(cfg, device="cpu", seed=DSCLI_SEED)
            enc = [n for n in ens_p if n.startswith(("spec_encoder.", "spat_encoder."))]
            assert len(enc) == n_enc
            assert all(torch.equal(ens_p[n], src[n].float()) for n in enc), (
                "lineareval: an encoder parameter of the ensemble differs from the checkpoint's")
            heads = [n for n in ens_p if n.startswith("head_")]
            init_sd = init.state_dict()
            assert heads and all(not torch.equal(ens_p[n], init_sd[n]) for n in heads), (
                "lineareval: a head parameter did not move")
            assert all(not torch.equal(v, init_sd[n]) for n, v in ens_b.items()), (
                "lineareval: a BatchNorm running stat did not move")
            steps_b = _ds_train_steps(learners, nbatch)
            _check_ds_launches("(b)", counts, steps_b, "lineareval")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            log(f"[downstream_cli] (b) lineareval: {len(enc)} encoder parameters of the "
                f"ensemble bit-identical to the checkpoint's (f16 read as f32), {len(heads)} head "
                f"parameters and all {len(ens_b)} BatchNorm stats moved; hash_dropout "
                f"{counts.get('hash_dropout', 0)} = {DS_DROPOUT_PER_STEP['lineareval']} x "
                f"{steps_b} train steps")

            # (c) --ds-test on run (a)'s first cell, then the no-train baseline
            cell = cells[0]
            cell_ckpt = os.path.join(exp_a, cell, "ckpt")
            test_args = ["--ds-test", "--synthetic", "--bs-set", str(DS_BATCH), *DSCLI_NUMS,
                         "--exp-dir", os.path.join(tmp, "c")]
            t0 = time.perf_counter()
            out = _cli(test_args + ["--ckpt", cell_ckpt], "run_downstream")
            assert f"loaded {ckpt.ensemble_path(cell_ckpt)}" in out, out
            got = float(re.search(r"test \[TDOA\]: loss \S+ MAE (\S+)", out).group(1))
            want = res["cells"][cell]["test_mae"]
            assert abs(got - want) <= TOL_DS_TEST * max(1.0, abs(want)), (got, want)
            file = ckpt.load_checkpoint(ckpt.ensemble_path(cell_ckpt))
            state = ckpt.restore_state(create_train_state(models.SARSSL(cfg, device="cuda")),
                                       file, restore_opt=False)
            back = to_jax_params(state.model)
            same = all(np.array_equal(a, b) for part in ("params", "batch_stats")
                       for a, b in zip(_leaves(back[part]), _leaves(file[part])))
            assert same, "the ensemble file does not round-trip through the model"
            out = _cli(test_args + ["--ds-test-mode", "cal_metric_wo_info"], "run_downstream")
            wall_c = time.perf_counter() - t0
            mark("c")
            base = re.search(r"no-train baseline \[TDOA\]: train MAE (\S+) test MAE (\S+)", out)
            assert base and np.isfinite([float(base.group(1)), float(base.group(2))]).all(), out
            log(f"[downstream_cli] (c) --ds-test: test MAE {got:.5f} against the grid's "
                f"{want:.5f} (tol {TOL_DS_TEST} relative), the ensemble file round-trips; "
                f"no-train baseline train / test MAE {base.group(1)} / {base.group(2)} against "
                f"the finetuned cell's {want:.5f}; wall of both calls {wall_c:.2f} s ({card})")

            # (d) multi-pair: 4 mics, all 6 pairs
            exp_d = os.path.join(tmp, "d")
            mc = ["--ds-train", "--synthetic", "--nmic", "4", "--ch-mode", "MM", "--bs-set", "2",
                  "--lr-set", "1e-3", "--ntrial", "1", "--epochs", str(DSCLI_MC_EPOCHS),
                  "--pretrain-ckpt", pre, "--exp-dir", exp_d, *DSCLI_MC_NUMS]
            out, counts, learners, wall_d = _ds_cli_run("(d) multi-pair", mc, spent, card)
            mark("d")
            res_d = _read_results(exp_d)
            assert out.count(f"partial_load: {n_enc}/{n_enc + 6} parameters loaded") == 1, out
            recs = _records(exp_d, "trial0_bs2_lr0.001")
            pairs = {f"mae_pair{k}" for k in range(6)}
            evals = [r for r in recs if r["split"] != "train"]
            assert evals and all(pairs <= set(r) and "mae_pair6" not in r for r in evals), evals
            steps_d = _ds_train_steps(learners, int(DSCLI_MC_NUMS[1]) // 2)
            _check_ds_launches("(d)", counts, steps_d, "multipair")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            log(f"[downstream_cli] (d) multi-pair MM, 6 pairs: test MAE "
                f"{res_d['best_test_mae']:.5f}, per pair "
                f"{[round(evals[-2][k], 4) for k in sorted(pairs)]}; hash_dropout "
                f"{counts.get('hash_dropout', 0)} = {DS_DROPOUT_PER_STEP['multipair']} x "
                f"{steps_d} train steps ({card})")

            # (e) --ds-test-mode vis_embed on run (a)'s first cell
            seen, plot = [], vis.plot_tsne_embeddings

            def caught(embeds, labels, save_path, perplexity=30.0):
                seen.append((np.asarray(embeds), np.asarray(labels)))
                return plot(embeds, labels, save_path, perplexity)
            vis.plot_tsne_embeddings = caught
            try:
                out, counts, _, wall_e = _ds_cli_run(
                    "(e) vis_embed", test_args[:-1] + [os.path.join(tmp, "e"), "--ds-test-mode",
                                                       "vis_embed", "--ckpt", cell_ckpt],
                    spent, card)
            finally:
                vis.plot_tsne_embeddings = plot
            mark("e")
            n_test = int(DSCLI_NUMS[5])
            assert len(seen) == 1, len(seen)
            embeds, labels = seen[0]
            assert embeds.shape == (n_test, cfg.spec_dembed + cfg.spat_dembed), embeds.shape
            assert labels.shape == (n_test,) and np.isfinite(embeds).all() and \
                np.isfinite(labels).all()
            plots = vis._plt() is not None and importlib.util.find_spec("sklearn") is not None
            want_path = os.path.join(tmp, "e", "tsne.png") if plots else None
            assert f"t-SNE saved to {want_path}" in out, out
            assert not counts, f"(e) vis_embed launched kernels: {counts}"
            log(f"[downstream_cli] (e) vis_embed: plot_tsne_embeddings got {embeds.shape} finite "
                f"embeddings and {labels.shape[0]} labels; t-SNE saved to {want_path}; wall "
                f"{wall_e:.2f} s ({card})")
    finally:
        timer.undo()

    # the shares below are only as good as the wrappers: they must have caught
    # every call the runs made
    # a cell epoch draws nbatch train and 4 val batches; a cell's end 4 test
    # and 4 final val batches
    cell_batches = lambda epochs: epochs * (nbatch + 4) + 4 + 4  # noqa: E731
    want = {"a": 2 * cell_batches(DSCLI_EPOCHS), "b": cell_batches(DSCLI_LIN_EPOCHS),
            "c": 4 + nbatch + 4, "d": 0, "e": 4}  # (c): the test batches, then the baseline's
    mc_batches = DSCLI_MC_EPOCHS * (8 + 4) + 4 + 4
    runs, before = ("a", "b", "c", "d", "e"), {k: 0 for k in spent}
    split = {}
    for run in runs:
        split[run] = {k: spent[k][before[k]:marks[run][k]] for k in spent}
        before = marks[run]
    got = {run: len(split[run]["synth_batch"]) for run in runs}
    assert got == want, (got, want)
    assert len(split["d"]["synth_batch_multich"]) == len(spent["synth_batch_multich"]) == \
        mc_batches, len(spent["synth_batch_multich"])
    assert len(spent["save_checkpoint"]) == len(spent["cell_epoch"]) == (
        2 * DSCLI_EPOCHS + DSCLI_LIN_EPOCHS + DSCLI_MC_EPOCHS), spent
    assert [len(split[run]["save_named"]) for run in runs] == [2, 1, 0, 1, 0], spent
    walls = {"a": wall_a, "b": wall_b, "c": wall_c, "d": wall_d, "e": wall_e}
    for run in runs:
        part = split[run]
        synth = sum(part["synth_batch"]) + sum(part["synth_batch_multich"])
        saves = sum(part["save_checkpoint"]) + sum(part["save_named"])
        log(f"[downstream_cli] ({run}) wall {walls[run]:.2f} s; cell epochs (s) "
            f"{[round(t, 3) for t in part['cell_epoch']]}; synthetic batches on the host: "
            f"{len(part['synth_batch']) + len(part['synth_batch_multich'])} in {synth:.2f} s "
            f"({synth / walls[run]:.1%}); checkpoint writes: {len(part['save_checkpoint'])} "
            f"epoch saves {[round(t, 3) for t in part['save_checkpoint']]} s + "
            f"{len(part['save_named'])} ensemble {[round(t, 3) for t in part['save_named']]} s "
            f"({saves / walls[run]:.1%}) ({card})")
        if part["cell_epoch"]:  # the epoch saves run inside the cell epochs
            epochs = sum(part["cell_epoch"])
            log(f"[downstream_cli] ({run}) cell epochs {epochs:.2f} s in all, "
                f"{epochs / len(part['cell_epoch']):.3f} s each; the epoch saves "
                f"{sum(part['save_checkpoint']) / epochs:.1%} of it ({card})")
    return total


def _leaves(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield np.asarray(v)


def phase_trained(card):
    """The committed trained checkpoint, read by the port, in the flagship
    model at 64 frames: the eval step on one replayed mask, and the
    prediction element by element, f32 and bf16 on the card against f32 on
    the CPU (bf16 held to the CPU's own bf16 reading)."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig, PatchMask, gen_patch_mask, stft_features
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.train import create_train_state, make_pretrain_eval_step
    from sarssl_torch.train.pretext_eval import pretext_metrics

    payload = ckpt.load_checkpoint(str(Path(__file__).resolve().parent / TRAINED_CKPT))
    assert payload["meta"]["epoch"] == 27, payload["meta"]
    wave, _ = synth_batch(np.random.default_rng(11), 2, DS_NSAMPLE)
    res, preds, metrics = {}, {}, {}
    runs = (("cpu", "float32"), ("cpu", "bfloat16"), ("cuda", "float32"), ("cuda", "bfloat16"))
    for dev, dtype in runs:
        cfg = SARSSLConfig(sig_shape=(256, DS_FRAMES, 2, 2), dtype=dtype, fused_attention=True)
        model = SARSSL(cfg, device=dev, seed=0)
        state = ckpt.restore_state(create_train_state(model), payload, restore_opt=False)
        mask = gen_patch_mask(torch.Generator().manual_seed(7), 2, cfg.npatch,
                              cfg.effective_nmasked(), nmic=2, device="cpu")
        mask = PatchMask(*(t.to(dev) for t in mask))
        out = make_pretrain_eval_step(model, FeatureConfig(), device=dev)(
            state, wave, torch.Generator(), mask=mask)
        res[dev, dtype] = {k: float(v) for k, v in out.items()}
        with torch.no_grad():  # the eval step's forward, for its prediction
            feats = stft_features(torch.from_numpy(wave).to(dev, torch.float32), FeatureConfig())
            _, _, aux = model.pretext(feats, mask, False)
        preds[dev, dtype] = aux["pred"].float().cpu()
        if (dev, dtype) != ("cpu", "bfloat16"):
            t0 = time.perf_counter()
            metrics[dev, dtype] = pretext_metrics(aux, cfg.sig_shape, cfg.patch_shape,
                                                  compute_pesq=True)
            metrics[dev, dtype]["seconds"] = time.perf_counter() - t0
    ref, pref = res["cpu", "float32"], preds["cpu", "float32"]

    def pred_err(key):
        err = (preds[key] - pref).abs()
        return float(err.max() / pref.abs().max()), float(err.mean() / pref.abs().mean())

    reading = pred_err(("cpu", "bfloat16"))
    log(f"[trained] epoch-27 checkpoint, cpu bfloat16 prediction against cpu float32: max rel "
        f"{reading[0]:.3e}, mean rel {reading[1]:.3e} (the bf16 reading)")
    for dev, dtype in runs[2:]:
        r = res[dev, dtype]
        errs = {k: abs(r[k] - ref[k]) / abs(ref[k]) for k in ("loss", "diff")}
        perr = pred_err((dev, dtype))
        if dtype == "bfloat16":
            tol = {"loss": TOL_TRAINED_BF16,
                   "pred": tuple(TRAINED_BF16_FACTOR * e for e in reading)}
        else:
            tol = {"loss": TOL_REF, "pred": (TOL_REF, TOL_REF)}
        log(f"[trained] epoch-27 checkpoint, {dev} {dtype}: loss {r['loss']:.6f} diff "
            f"{r['diff']:.6f}; against f32 on the CPU: prediction {tuple(preds[dev, dtype].shape)} "
            f"max rel {perr[0]:.3e} (tol {tol['pred'][0]:.3e}), mean rel {perr[1]:.3e} (tol "
            f"{tol['pred'][1]:.3e}); loss rel {errs['loss']:.2e} (tol {tol['loss']}); features "
            f"(diff reads only them) rel {errs['diff']:.2e} (tol {TOL_REF}) ({card})")
        assert np.isfinite(preds[dev, dtype].numpy()).all(), f"{dev} {dtype}: non-finite prediction"
        for e, t, what in zip(perr, tol["pred"], ("max", "mean")):
            assert e <= t, f"trained weights {dev} {dtype}: prediction {what} rel err {e} > {t}"
        assert errs["loss"] <= tol["loss"], f"trained weights {dev} {dtype}: loss rel err"
        assert errs["diff"] <= TOL_REF, f"trained weights {dev} {dtype}: features differ"
    assert ref["loss"] < ref["diff"], "the trained model predicts no better than a channel copy"
    check_trained_metrics(metrics, card)


def check_trained_metrics(metrics, card):
    """``pretext_metrics`` (MSEs, ISTFT, PESQ) of the trained model's
    prediction: card f32 against CPU f32, the MSEs and the waveforms within
    TOL_REF of the largest value, PESQ within TOL_PESQ; the bf16 readings
    logged."""
    ref = metrics["cpu", "float32"]
    for key in (("cuda", "float32"), ("cuda", "bfloat16")):
        m = metrics[key]
        errs = {k: abs(m[k] - ref[k]) / abs(ref[k]) for k in ("mse", "mse_mask", "mse_mask_ch")}
        errs.update({k: rel_err(torch.from_numpy(m[k]), torch.from_numpy(ref[k]))
                     for k in ("sig_pred", "sig_tar")})
        pesq_err = float(np.abs(m["pesq"] - ref["pesq"]).max())
        assert np.isfinite(m["pesq"]).all() and m["sig_pred"].shape == (2, DS_NSAMPLE, 2), key
        log(f"[trained] pretext_metrics {key[0]} {key[1]}: mse {m['mse']:.6f} mse_mask "
            f"{m['mse_mask']:.6f} mse_mask_ch {m['mse_mask_ch']:.6f} pesq "
            f"{np.round(m['pesq'], 4).tolist()} pesq_mask_ch {np.round(m['pesq_mask_ch'], 4).tolist()}"
            f"; against cpu float32: " + ", ".join(f"{k} rel {e:.2e}" for k, e in errs.items())
            + f", pesq abs {pesq_err:.2e}; {m['seconds']:.2f} s ({card})")
        if key[1] == "float32":
            for k, e in errs.items():
                assert e <= TOL_REF, f"trained pretext_metrics {key}: {k} rel err {e} > {TOL_REF}"
            assert pesq_err <= TOL_PESQ, f"trained pretext_metrics {key}: pesq err {pesq_err}"


def _timed_steps(fn, n=STEPS):
    """One warm-up call of ``fn``, then ``n`` timed ones, each ending in a
    synchronise; the launch counts and peak memory are read around the timed
    calls. Returns (seconds per call, outputs, launch counts, peak GiB)."""
    from sarssl_torch.kernels import launches, reset_launches

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, outs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    _assert_no_conv_launch(launches, "downstream")
    return times, outs, dict(launches), torch.cuda.max_memory_allocated() / 2 ** 30


def _log_steps(what, times, peak, card):
    med = statistics.median(times)
    log(f"[downstream] {what}: median step {1e3 * med:.2f} ms, {DS_BATCH / med:.1f} utt/s, "
        f"peak memory {peak:.3f} GiB ({card})")


def phase_downstream(card, pretrained):
    """The flagship downstream model (run_downstream.py's default task, TDOA)
    from the pretext trunk ``pretrained``: finetune, lineareval, eval."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import (create_train_state, make_downstream_eval_step,
                                    make_downstream_step, partial_load,
                                    trainable_mask_from_loaded)

    cfg = SARSSLConfig(sig_shape=(256, 64, 2, 2), pretrain=False, downstream_embed="spec_spat",
                       dtype="float32")
    src = pretrained.state_dict()
    wave, tdoa = synth_batch(np.random.default_rng(2), DS_BATCH, DS_NSAMPLE)
    wave = torch.from_numpy(wave).cuda()
    gt = torch.from_numpy(tdoa / 16000.0).cuda()  # seconds, as the JAX synthetic path

    def fresh(seed):
        model = SARSSL(cfg, device="cuda", seed=seed)
        loaded = partial_load(model, src)
        encoders = sorted(n for n, _ in model.named_parameters()
                          if n.startswith(("spec_encoder.", "spat_encoder.")))
        assert sorted(loaded) == encoders, "partial_load did not load exactly the encoders"
        return model, loaded

    model, loaded = fresh(1)
    log(f"[downstream] partial_load: {len(loaded)} encoder parameters loaded, no head "
        f"parameter, no buffer")
    state = create_train_state(model)
    step = make_downstream_step(model, FeatureConfig(), "TDOA", device="cuda")
    gen = torch.Generator().manual_seed(1)
    times, outs, counts, peak = _timed_steps(lambda: step(state, wave, gt, DS_LR, gen))
    losses = [float(o["loss"]) for o in outs]
    assert all(np.isfinite(losses)), f"non-finite finetune loss {losses}"
    assert counts.get("hash_dropout", 0) > 0, "hash_dropout never launched on the downstream step"
    attn = {k: v for k, v in counts.items() if k.startswith("attention")}
    assert not attn, f"the downstream step launched attention kernels: {attn}"
    log(f"[downstream] finetune launches over {STEPS} steps: {counts}; losses {losses}")
    _log_steps("finetune", times, peak, card)

    ev_step = make_downstream_eval_step(model, FeatureConfig(), "TDOA", device="cuda")
    times, outs, _, peak = _timed_steps(lambda: ev_step(state, wave, gt))
    ev = outs[-1]
    assert ev["pred"].shape == (DS_BATCH, 1), ev["pred"].shape
    assert ev["embed"].shape == (DS_BATCH, cfg.spec_dembed + cfg.spat_dembed), ev["embed"].shape
    metrics = {k: float(ev[k]) for k in ("loss", "mae")}
    assert all(np.isfinite(list(metrics.values()))), f"non-finite eval metrics {metrics}"
    log(f"[downstream] eval: {metrics}, pred {tuple(ev['pred'].shape)}, embed "
        f"{tuple(ev['embed'].shape)}")
    _log_steps("eval", times, peak, card)

    model, loaded = fresh(2)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    state = create_train_state(model)
    step = make_downstream_step(model, FeatureConfig(), "TDOA",
                                trainable_mask_from_loaded(model, loaded), device="cuda")
    times, outs, _, peak = _timed_steps(lambda: step(state, wave, gt, DS_LR, gen))
    losses = [float(o["loss"]) for o in outs]
    assert all(np.isfinite(losses)), f"non-finite lineareval loss {losses}"
    params = dict(model.named_parameters())
    frozen_same = all(torch.equal(params[n].detach(), start[n]) for n in loaded)
    heads = [n for n in params if n.startswith("head_")]
    heads_moved = all(not torch.equal(params[n].detach(), start[n]) for n in heads)
    stats_moved = all(not torch.equal(b, stats0[n]) for n, b in model.named_buffers())
    assert frozen_same, "lineareval moved a frozen encoder parameter"
    assert heads_moved, "lineareval left a head parameter where it was"
    assert stats_moved, "lineareval left an encoder BatchNorm running stat where it was"
    log(f"[downstream] lineareval, {STEPS + 1} steps: {len(loaded)} frozen encoder parameters "
        f"bit-identical, {len(heads)} head parameters moved, all "
        f"{len(stats0)} BatchNorm running stats moved; losses {losses}")
    _log_steps("lineareval", times, peak, card)
    return counts


def phase_downstream_reference():
    """Small downstream model: card (kernels) against CPU (plain versions),
    2 finetune steps with dropout 0.1 and the same seeds."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import create_train_state, make_downstream_step

    feat = FeatureConfig(win_len=128, nfft=128)
    cfg = SARSSLConfig().tiny(sig_shape=(64, 64, 2, 2), patch_shape=(64, 1),
                              spec_dembed=128, spat_dembed=64, spat_layers=2,
                              dropout=RATE, pretrain=False)
    wave, tdoa = synth_batch(np.random.default_rng(3), 8, 63 * 64 + 128)
    gt = tdoa / 16000.0
    losses = {}
    for dev in ("cuda", "cpu"):
        model = SARSSL(cfg, device=dev, seed=4)
        state = create_train_state(model)
        step = make_downstream_step(model, feat, "TDOA", device=dev)
        gen = torch.Generator().manual_seed(6)
        losses[dev] = [float(step(state, wave, gt, DS_LR, gen)["loss"]) for _ in range(2)]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"[downstream] small model, 2 finetune steps, dropout {RATE}: card {losses['cuda']} "
        f"cpu {losses['cpu']} max rel err {err:.2e} (tol {TOL_REF})")
    assert err <= TOL_REF, f"card and CPU downstream losses differ by {err}"


# model_options: each variant of the flagship pretext model takes one warm-up
# and this many timed steps, the launch counts zeroed before the warm-up
OPTION_STEPS = 3
# hash_dropout launches per step (forward, and backward where a gradient
# flows): a conformer block holds 6 sites outside the attention kernel (7 with
# the unfused attention, whose probabilities go through the module); a
# transformer layer 3 sites and its attention-weight mask (forward only: the
# mask of ones takes no gradient), the transformer encoder 1 more site at its
# input. So the flagship's 4 encoder blocks give 48, 56 with the unfused
# attention; transformer encoders instead (1 + 3 layers) 2 * 1 + 7 * 1 + 2 * 1
# + 7 * 3 = 32; a decoder conformer stage adds 14, a decoder transformer stage
# 9; MCConformer's unfused forward without autograd 7 * 4 = 28.
OPTION_DROPOUT = {"encoders": 48, "encoders_unfused": 56, "transformer_encoders": 32,
                  "dec_conformer": 14, "dec_transformer": 9, "mc_forward": 28}
# remat against the plain path on the card: the forward is the same
# computation, so the loss, the running stats and the generator's state must
# be equal bit for bit; the gradients too unless a library kernel of the
# backward (cuDNN's convolution gradients) sums in an order that changes from
# call to call, so they are held to a bf16 rounding of their largest value
TOL_REMAT_GRAD = 2 ** -8


def _attention_want(spec, spat):
    """Attention launches of one pretext train step: ``spec`` / ``spat`` are
    (instance head dim, layers, route) of each encoder's conformer
    (``ROUTE_TAGS``), with a fourth item True where the head dim is padded to
    it (``..._padded_d{D}`` too); a pass on the wide instance (past 256, and
    at 256 but for the bf16 forward) also counts as ``..._wide_d{D}``."""
    want = {}
    for D, layers, route, *padded in (spec, spat):
        for kind in ("fwd", "bwd"):
            tag = ROUTE_TAGS[route]
            names = [f"attention_{kind}_d{D}", f"attention_{kind}_{tag}d{D}"]
            if padded and padded[0]:
                names.append(f"attention_{kind}_{tag}padded_d{D}")
            for name in names + ([f"attention_{kind}_{tag}wide_d{D}"]
                                 if _runs_wide(route, kind, D) else []):
                want[name] = want.get(name, 0) + layers
    return want


FLAGSHIP_ATTENTION = _attention_want((128, 1, "tc"), (64, 3, "tc"))


def _kernel_counts():
    from sarssl_torch.kernels import launches

    return {k: v for k, v in launches.items() if v}


class _CapturedMasks:
    """Catches the masks the pretrain step draws (``train.steps.gen_patch_mask``)."""

    def __init__(self):
        from sarssl_torch.train import steps

        self.steps, self.orig, self.masks = steps, steps.gen_patch_mask, []

        def capture(*a, **k):
            self.masks.append(self.orig(*a, **k))
            return self.masks[-1]

        steps.gen_patch_mask = capture

    def undo(self):
        self.steps.gen_patch_mask = self.orig


def _check_mask(what, m, count):
    assert bool((m.patch.sum(1) == count).all()), f"{what}: a row does not mask {count}"
    assert m.idx.shape[1] == count and bool((m.idx[:, 1:] > m.idx[:, :-1]).all()), what
    assert bool(torch.gather(m.patch, 1, m.idx).all()), f"{what}: idx and patch disagree"


def _pretext_variant(what, card, wave, want_per_step, mask_mode="T", masks=None, **kw):
    """One warm-up and OPTION_STEPS timed pretrain steps of the flagship model
    with the options ``kw``; launches asserted exactly (``want_per_step`` per
    step). Returns the variant's numbers."""
    from sarssl_torch.kernels import reset_launches
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import create_train_state, make_pretrain_step

    cfg = SARSSLConfig(**{"dtype": "bfloat16", "fused_attention": True, "dropout": RATE, **kw})
    model = SARSSL(cfg, device="cuda", seed=0)
    state = create_train_state(model)
    step = make_pretrain_step(model, FeatureConfig(), device="cuda", mask_mode=mask_mode)
    gen = torch.Generator().manual_seed(0)
    nsteps = 1 + OPTION_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for i in range(nsteps):
        t0 = time.perf_counter()
        metrics = step(state, wave, 1e-3, gen, mask=None if masks is None else masks[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert all(np.isfinite(losses)), f"{what}: non-finite loss {losses}"
    assert len(set(losses)) == nsteps, f"{what}: the loss did not move {losses}"
    want = {k: v * nsteps for k, v in want_per_step.items() if v}
    assert counts == want, f"{what}: launches {counts}, want {want}"
    med = statistics.median(times[1:])
    log(f"[model_options] {what}: median step {1e3 * med:.1f} ms, {BATCH / med:.1f} utt/s, "
        f"peak {peak:.2f} GiB, losses {[round(x, 5) for x in losses]}, launches over "
        f"{nsteps} steps {counts} (exact) ({card})")
    del state, step, model
    torch.cuda.empty_cache()
    return {"ms": 1e3 * med, "utt_s": BATCH / med, "peak_gib": peak, "counts": counts,
            "losses": losses}


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _remat_cnn_matches_plain(wave, card):
    """(e): the first step's loss, gradients, running stats and generator
    state with ``remat_cnn`` against the plain model's, same weights, mask and
    seed, on the card."""
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig, gen_patch_mask, stft_features

    feats = stft_features(wave, FeatureConfig())
    runs = {}
    for remat in (False, True):
        cfg = SARSSLConfig(dtype="bfloat16", fused_attention=True, dropout=RATE,
                           remat_cnn=remat)
        model = SARSSL(cfg, device="cuda", seed=0)
        model.train()
        mask = gen_patch_mask(torch.Generator().manual_seed(1), feats.shape[0], cfg.npatch,
                              cfg.effective_nmasked(), device="cuda")
        gen = torch.Generator().manual_seed(2)
        loss, _, _ = model.pretext(feats, mask, True, gen)
        loss.backward()
        runs[remat] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                       {n: b.clone() for n, b in model.named_buffers()}, gen.get_state())
        del model, loss
    (pl, pg, pb, ps), (rl, rg, rb, rs) = runs[False], runs[True]
    assert torch.equal(pl, rl), f"remat_cnn: loss {float(rl)} against {float(pl)}"
    assert torch.equal(ps, rs), "remat_cnn: the generator moved another way"
    assert all(torch.equal(pb[n], rb[n]) for n in pb), "remat_cnn: running stats differ"
    same = sum(torch.equal(pg[n], rg[n]) for n in pg)
    worst = max(rel_err(rg[n], pg[n]) for n in pg)
    assert worst <= TOL_REMAT_GRAD, f"remat_cnn: gradient rel err {worst}"
    log(f"[model_options] (e) remat_cnn first step against plain: loss {float(pl):.6f} "
        f"identical, all {len(pb)} running stats identical, generator state identical, "
        f"{same} of {len(pg)} gradients bit-identical, worst rel err {worst:.2e} (tol "
        f"{TOL_REMAT_GRAD:.2e}) ({card})")
    del runs, feats
    torch.cuda.empty_cache()


def _downstream_cls(card, total):
    """(d), downstream: the flagship downstream model (f32, batch 8) with the
    CLS token, one finetune step for each ``downstream_token``."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.kernels import reset_launches
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import create_train_state, make_downstream_step

    wave, tdoa = synth_batch(np.random.default_rng(2), DS_BATCH, DS_NSAMPLE)
    wave = torch.from_numpy(wave).cuda()
    gt = torch.from_numpy(tdoa / 16000.0).cuda()
    for token in ("cls", "all"):
        cfg = SARSSLConfig(sig_shape=(256, DS_FRAMES, 2, 2), pretrain=False,
                           downstream_embed="spec_spat", dtype="float32", use_cls=True,
                           downstream_token=token)
        model = SARSSL(cfg, device="cuda", seed=1)
        state = create_train_state(model)
        step = make_downstream_step(model, FeatureConfig(), "TDOA", device="cuda")
        reset_launches()
        t0 = time.perf_counter()
        metrics = step(state, wave, gt, DS_LR, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = _kernel_counts()
        loss = float(metrics["loss"])
        assert np.isfinite(loss), f"downstream use_cls {token}: loss {loss}"
        want = {"hash_dropout": DS_DROPOUT_PER_STEP["finetune"]}
        assert counts == want, f"downstream use_cls {token}: launches {counts}, want {want}"
        _add_counts(total, counts)
        log(f"[model_options] (d) downstream use_cls, downstream_token={token!r}: one finetune "
            f"step (the first, cuDNN plans included) {ms:.1f} ms, loss {loss:.5f}, launches "
            f"{counts} (exact) ({card})")
        del state, step, model


def _mc_conformer(card, wave, total):
    """(j): MCConformer's forward at the flagship width, f32 and bf16, train
    mode with dropout, without autograd."""
    from sarssl_torch.kernels import reset_launches
    from sarssl_torch.models import MCConformer, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig, stft_features

    feats = stft_features(wave, FeatureConfig())
    for dtype in ("float32", "bfloat16"):
        model = MCConformer(SARSSLConfig(dtype=dtype, dropout=RATE), device="cuda", seed=0)
        gen = torch.Generator().manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = []
        with torch.no_grad():
            for _ in range(1 + OPTION_STEPS):
                t0 = time.perf_counter()
                out = model(feats, True, gen)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        counts = _kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        assert out.shape == (BATCH, 256, 256, 2, 2), out.shape
        assert bool(torch.isfinite(out).all()), f"MCConformer {dtype}: non-finite output"
        want = {"hash_dropout": OPTION_DROPOUT["mc_forward"] * (1 + OPTION_STEPS)}
        assert counts == want, f"MCConformer {dtype}: launches {counts}, want {want}"
        _add_counts(total, counts)
        med = statistics.median(times[1:])
        log(f"[model_options] (j) MCConformer {dtype} forward (train mode, no autograd): "
            f"median {1e3 * med:.1f} ms, {BATCH / med:.1f} utt/s, peak {peak:.2f} GiB, output "
            f"{tuple(out.shape)} finite, launches {counts} (exact) ({card})")
        del model, out
        torch.cuda.empty_cache()


def _conformer_remat(card, total):
    """(k): ConformerEncoder(remat=True) at the spat width (d = 256, 3 layers,
    bf16, fused attention, dropout 0.1, batch 128, L = 256) against
    remat=False from the same weights and generator state: output, input and
    parameter gradients, running stats, generator state."""
    from sarssl_torch.kernels import reset_launches
    from sarssl_torch.models import ConformerEncoder

    x = torch.randn((BATCH, SEQ, 256), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda").to(torch.bfloat16)
    g = torch.randn_like(x)
    runs = {}
    for remat in (False, True):
        enc = ConformerEncoder(256, 3, num_heads=HEADS, dropout=RATE, fused_attention=True,
                               dtype=torch.bfloat16, generator=torch.Generator().manual_seed(4),
                               remat=remat).cuda()
        gen = torch.Generator().manual_seed(5)
        xr = x.clone().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        y = enc(xr, True, gen)
        y.backward(g)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = _kernel_counts()
        _add_counts(total, counts)
        runs[remat] = (y.detach(), xr.grad, {n: p.grad for n, p in enc.named_parameters()},
                       {n: b.clone() for n, b in enc.named_buffers()}, gen.get_state(), counts,
                       ms, torch.cuda.max_memory_allocated() / 2 ** 30)
        del enc, y, xr
    plain, rem = runs[False], runs[True]
    fwd = {"attention_fwd_d64": 3, "attention_fwd_tc_d64": 3, "attention_bwd_d64": 3,
           "attention_bwd_tc_d64": 3, "hash_dropout": 36}
    # the recomputation runs each block's forward again: 3 more attention
    # forwards and 18 more dropout launches
    fwd_remat = {**fwd, "attention_fwd_d64": 6, "attention_fwd_tc_d64": 6, "hash_dropout": 54}
    assert plain[5] == fwd, f"conformer plain: launches {plain[5]}, want {fwd}"
    assert rem[5] == fwd_remat, f"conformer remat: launches {rem[5]}, want {fwd_remat}"
    assert torch.equal(plain[0], rem[0]), "conformer remat: the output differs"
    assert torch.equal(plain[4], rem[4]), "conformer remat: the generator moved another way"
    assert all(torch.equal(plain[3][n], rem[3][n]) for n in plain[3]), "running stats differ"
    grads = [(plain[1], rem[1])] + [(plain[2][n], rem[2][n]) for n in plain[2]]
    same = sum(torch.equal(a, b) for a, b in grads)
    worst = max(rel_err(b, a) for a, b in grads)
    assert worst <= TOL_REMAT_GRAD, f"conformer remat: gradient rel err {worst}"
    log(f"[model_options] (k) ConformerEncoder d=256 x 3 remat against plain, bf16 B={BATCH} "
        f"L={SEQ}: output, running stats and generator state identical; {same} of "
        f"{len(grads)} gradients (input and parameters) bit-identical, worst rel err "
        f"{worst:.2e} (tol {TOL_REMAT_GRAD:.2e}); fwd+bwd {plain[6]:.1f} ms / peak "
        f"{plain[7]:.2f} GiB plain, {rem[6]:.1f} ms / {rem[7]:.2f} GiB remat (first calls); "
        f"launches plain {plain[5]}, remat {rem[5]} (exact) ({card})")


def phase_model_options(card):
    """The model's options at the flagship pretext width, variants (a)-(n);
    each with its launch counts zeroed before and read after. Returns the
    phase's summed counts and, for the kernels line, the launches at each of
    the new attention shapes."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.ops import gen_patch_mask

    wave, _ = synth_batch(np.random.default_rng(0), BATCH, NSAMPLE)
    wave = torch.from_numpy(wave).cuda()
    total, shapes, res = {}, {}, {}
    base = {**FLAGSHIP_ATTENTION, "hash_dropout": OPTION_DROPOUT["encoders"]}

    def run(what, want, **kw):
        r = _pretext_variant(what, card, wave, want, **kw)
        _add_counts(total, r["counts"])
        res[what] = r
        return r

    run("plain", base)
    cap = _CapturedMasks()
    try:
        for mode in ("T_1s", "T_cluster", "T_cluster_inverse", "T_cluster2"):
            cap.masks.clear()
            run(f"(a) mask_mode={mode}", base, mask_mode=mode)
            count = 256 // 4 if mode == "T_1s" else 128
            assert len(cap.masks) == 1 + OPTION_STEPS, f"{mode}: {len(cap.masks)} masks drawn"
            for m in cap.masks:
                _check_mask(mode, m, count)
            log(f"[model_options] (a) {mode}: every row of the {len(cap.masks)} drawn masks "
                f"masks exactly {count} of 256 patches, idx ascending")
    finally:
        cap.undo()
    run("(b) in_ver=same", base, in_ver="same")
    r = run("(c) in_ver=single_ch_each_patch",
            {**_attention_want((64, 1, "tc"), (32, 3, "tc")),
             "hash_dropout": OPTION_DROPOUT["encoders"]}, in_ver="single_ch_each_patch")
    for kind in ("fwd", "bwd"):
        shapes[(512, 64, "bfloat16", kind)] = r["counts"].get(f"attention_{kind}_tc_d64", 0)
        shapes[(512, 32, "bfloat16", kind)] = r["counts"].get(f"attention_{kind}_tc_d32", 0)
    r = run("(d) use_cls", {**_attention_want((128, 1, "tc"), (64, 3, "tc")),
                            "hash_dropout": OPTION_DROPOUT["encoders"]}, use_cls=True)
    for kind in ("fwd", "bwd"):
        shapes[(257, 128, "bfloat16", kind)] = r["counts"].get(f"attention_{kind}_tc_d128", 0)
        shapes[(257, 64, "bfloat16", kind)] = r["counts"].get(f"attention_{kind}_tc_d64", 0)
    _downstream_cls(card, total)
    _remat_cnn_matches_plain(wave, card)
    r = run("(e) remat_cnn", base, remat_cnn=True)
    log(f"[model_options] (e) remat_cnn peak {r['peak_gib']:.2f} GiB against the plain step's "
        f"{res['plain']['peak_gib']:.2f} GiB; step {r['ms']:.1f} against {res['plain']['ms']:.1f}"
        f" ms ({card})")
    run("(f) local_model=fc", base, local_model="fc")
    masks = [gen_patch_mask(torch.Generator().manual_seed(10 + i), BATCH, 256, 128, mode="TF",
                            grid_shape=(16, 16), device="cuda") for i in range(1 + OPTION_STEPS)]
    for m in masks:
        _check_mask("TF", m, 128)
    run("(g) f-first patch_shape=(16, 16), TF masks on the (16, 16) grid", base,
        patch_shape=(16, 16), masks=masks)
    run("(h) global_model=transformer", {"hash_dropout": OPTION_DROPOUT["transformer_encoders"]},
        global_model="transformer")
    run("(i) dec_model=(conformer, fc)",
        {**base, "hash_dropout": OPTION_DROPOUT["encoders"] + OPTION_DROPOUT["dec_conformer"]},
        dec_model=("conformer", "fc"))
    run("(i) dec_model=(transformer, fc)",
        {**base, "hash_dropout": OPTION_DROPOUT["encoders"] + OPTION_DROPOUT["dec_transformer"]},
        dec_model=("transformer", "fc"))
    run("(i) dec_model=('', cnn)", base, dec_model=("", "cnn"))
    _mc_conformer(card, wave, total)
    _conformer_remat(card, total)
    # (l) the flagship step in f32, the reference's precision: fused attention
    # on the 3xTF32 kernels, beside the same f32 step unfused
    r = run("(l) dtype=float32, fused attention (3xTF32)",
            {**_attention_want((128, 1, "tf32x3"), (64, 3, "tf32x3")),
             "hash_dropout": OPTION_DROPOUT["encoders"]}, dtype="float32")
    for kind in ("fwd", "bwd"):
        shapes[(256, 128, "float32", kind)] = r["counts"].get(f"attention_{kind}_tf32x3_d128", 0)
        shapes[(256, 64, "float32", kind)] = r["counts"].get(f"attention_{kind}_tf32x3_d64", 0)
    u = run("(l) dtype=float32, unfused attention",
            {"hash_dropout": OPTION_DROPOUT["encoders_unfused"]}, dtype="float32",
            fused_attention=False)
    log(f"[model_options] (l) f32 step, fused (3xTF32) against unfused: {r['ms']:.1f} / "
        f"{u['ms']:.1f} ms, {r['utt_s']:.1f} / {u['utt_s']:.1f} utt/s, peak {r['peak_gib']:.2f} / "
        f"{u['peak_gib']:.2f} GiB (bf16 plain step {res['plain']['ms']:.1f} ms) ({card})")
    # (m) spec_dembed=1024: the spec encoder's 4 heads run head dim 256 (L =
    # 256): the bf16 forward on the D = 256 instance, the bf16 backward and
    # both f32 passes on the wide instance (the counts assert it); (n)
    # spec_dembed=2048: head dim 512 on the wide instance. Each in bf16 and
    # f32, beside the same step unfused from the same weights, masks and
    # dropout seeds (the unfused attention drops the same positions), so
    # their losses agree to the dtype's tolerance
    for tag, dembed in (("m", 1024), ("n", 2048)):
        D = dembed // HEADS
        for dtype, route, tol in (("bfloat16", "tc", TOL_BF16), ("float32", "tf32x3", TOL_REF)):
            r = run(f"({tag}) spec_dembed={dembed} {dtype}, fused attention",
                    {**_attention_want((D, 1, route), (64, 3, route)),
                     "hash_dropout": OPTION_DROPOUT["encoders"]}, dtype=dtype, spec_dembed=dembed)
            for kind in ("fwd", "bwd"):
                shapes[(256, D, dtype, kind)] = r["counts"].get(
                    f"attention_{kind}_{ROUTE_TAGS[route]}d{D}", 0)
                shapes[(256, D, dtype, kind, "wide")] = r["counts"].get(
                    f"attention_{kind}_{ROUTE_TAGS[route]}wide_d{D}", 0)
            u = run(f"({tag}) spec_dembed={dembed} {dtype}, unfused attention",
                    {"hash_dropout": OPTION_DROPOUT["encoders_unfused"]}, dtype=dtype,
                    spec_dembed=dembed, fused_attention=False)
            err = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], u["losses"]))
            on = " / ".join(f"{kind} on the " + ("wide instance" if _runs_wide(route, kind, D)
                                                 else f"D = {D} instance")
                            for kind in ("fwd", "bwd"))
            log(f"[model_options] ({tag}) spec_dembed={dembed} {dtype} step, fused "
                f"({ROUTE_WORDS[route]}, D = {D}: {on}) against "
                f"unfused: {r['ms']:.1f} / {u['ms']:.1f} ms, {r['utt_s']:.1f} / {u['utt_s']:.1f} "
                f"utt/s, peak {r['peak_gib']:.2f} / {u['peak_gib']:.2f} GiB, losses max rel err "
                f"{err:.2e} (tol {tol}) ({card})")
            assert err <= tol, (f"({tag}) spec_dembed={dembed} {dtype}: fused and unfused losses "
                                f"differ by {err}")
    log(f"[model_options] launches over the phase: {total}")
    return total, shapes


def phase_model_options_reference():
    """Each variant of phase model_options on a small model: card (kernels)
    against CPU (plain versions), f32, dropout 0.1, the same seeds (so both
    draw the same masks and dropout seeds)."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import MCConformer, SARSSL, ConformerEncoder, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig, gen_patch_mask
    from sarssl_torch.train import (create_train_state, make_downstream_step,
                                    make_pretrain_step)

    feat = FeatureConfig(win_len=128, nfft=128)
    # spec and spat at d = 128: head dim 32, 16 with one channel a patch
    base = SARSSLConfig().tiny(sig_shape=(64, 64, 2, 2), patch_shape=(64, 1),
                               spec_dembed=128, spat_dembed=128, dropout=RATE,
                               fused_attention=True)
    wave, tdoa = synth_batch(np.random.default_rng(1), 2, 63 * 64 + 128)
    tf_masks = [gen_patch_mask(torch.Generator().manual_seed(20 + i), 2, 64, 32, mode="TF",
                               grid_shape=(8, 8)) for i in range(2)]
    cases = [("mask modes", {}, ("T_1s", "T_cluster", "T_cluster_inverse", "T_cluster2"), None),
             ("in_ver=same", dict(in_ver="same"), ("T", "T"), None),
             ("in_ver=single_ch_each_patch", dict(in_ver="single_ch_each_patch"), ("T", "T"),
              None),
             ("use_cls", dict(use_cls=True), ("T", "T"), None),
             ("remat_cnn", dict(remat_cnn=True), ("T", "T"), None),
             ("local_model=fc", dict(local_model="fc"), ("T", "T"), None),
             ("f-first (8, 8), TF", dict(patch_shape=(8, 8)), ("T", "T"), tf_masks),
             ("global_model=transformer", dict(global_model="transformer"), ("T", "T"), None),
             ("dec (conformer, fc)", dict(dec_model=("conformer", "fc")), ("T", "T"), None),
             ("dec (transformer, fc)", dict(dec_model=("transformer", "fc")), ("T", "T"), None),
             ("dec ('', cnn)", dict(dec_model=("", "cnn")), ("T", "T"), None)]
    worst = 0.0
    for what, kw, modes, masks in cases:
        cfg = SARSSLConfig(**{**base.__dict__, **kw})
        losses = {}
        for dev in ("cuda", "cpu"):
            model = SARSSL(cfg, device=dev, seed=3)
            state = create_train_state(model)
            gen = torch.Generator().manual_seed(5)
            losses[dev] = []
            for i, mode in enumerate(modes):
                step = make_pretrain_step(model, feat, device=dev, mask_mode=mode)
                mask = None if masks is None else masks[i].to(dev)
                losses[dev].append(float(step(state, wave, 1e-3, gen, mask=mask)["loss"]))
        err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
        worst = max(worst, err)
        assert err <= TOL_REF, f"model_options ref {what}: card and CPU differ by {err}"
        log(f"[model_options] ref {what}: card {losses['cuda']} cpu {losses['cpu']} "
            f"max rel err {err:.2e}")
    gt = tdoa / 16000.0
    for token in ("cls", "all"):
        cfg = SARSSLConfig(**{**base.__dict__, "pretrain": False, "fused_attention": False,
                              "use_cls": True, "downstream_token": token})
        losses = {}
        for dev in ("cuda", "cpu"):
            model = SARSSL(cfg, device=dev, seed=4)
            state = create_train_state(model)
            step = make_downstream_step(model, feat, "TDOA", device=dev)
            gen = torch.Generator().manual_seed(6)
            losses[dev] = [float(step(state, wave, gt, DS_LR, gen)["loss"]) for _ in range(2)]
        err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
        worst = max(worst, err)
        assert err <= TOL_REF, f"model_options ref downstream {token}: differ by {err}"
        log(f"[model_options] ref downstream use_cls {token}: card {losses['cuda']} cpu "
            f"{losses['cpu']} max rel err {err:.2e}")
    outs = {}
    x = torch.randn((2, 2, 64, 64, 2), generator=torch.Generator().manual_seed(7))
    for dev in ("cuda", "cpu"):
        mc = MCConformer(base, device=dev, seed=5)
        with torch.no_grad():
            outs[dev] = mc(x.to(dev), True, torch.Generator().manual_seed(8)).cpu()
    err = rel_err(outs["cuda"], outs["cpu"])
    worst = max(worst, err)
    assert err <= TOL_REF, f"model_options ref MCConformer: differ by {err}"
    log(f"[model_options] ref MCConformer train-mode forward: max rel err {err:.2e}")
    res = {}
    xc, gc = torch.randn((2, 2, 64, 64), generator=torch.Generator().manual_seed(9))
    for dev in ("cuda", "cpu"):
        enc = ConformerEncoder(64, 2, num_heads=HEADS, dropout=RATE, fused_attention=True,
                               generator=torch.Generator().manual_seed(10), remat=True).to(dev)
        xr = xc.to(dev).detach().clone().requires_grad_()
        y = enc(xr, True, torch.Generator().manual_seed(11))
        # a random cotangent: the closing LayerNorm's outputs sum to a
        # constant, so a cotangent of ones has a zero exact gradient
        y.backward(gc.to(dev))
        res[dev] = (y.detach().cpu(), xr.grad.cpu())
    err = max(rel_err(a, b) for a, b in zip(res["cuda"], res["cpu"]))
    worst = max(worst, err)
    assert err <= TOL_REF, f"model_options ref ConformerEncoder remat: differ by {err}"
    log(f"[model_options] ref ConformerEncoder(remat=True) output and input gradient: max rel "
        f"err {err:.2e}; every case within {worst:.2e} (tol {TOL_REF})")


class _DataWait:
    """Wraps a learner class's epoch loops (the pre-training learner's by
    default): the host seconds each loop spends inside ``next`` on its batch
    iterable (waiting on data) are summed, and the first rows of every train
    batch's waves kept (a device copy, no synchronisation) to compare what two
    runs drew."""

    def __init__(self, keep=4096, cls=None):
        from sarssl_torch.train import learner as learner_mod
        self.cls, self.keep = cls or learner_mod.PretrainLearner, keep
        self.wait, self.batches = 0.0, []
        self.saved = (self.cls.train_epoch, self.cls.eval_epoch)
        train_epoch, eval_epoch = self.saved
        me = self

        def train(learner, batches, *a, **k):
            return train_epoch(learner, me._timed(batches, True), *a, **k)

        def evaluate(learner, batches, *a, **k):
            return eval_epoch(learner, me._timed(batches, False), *a, **k)
        self.cls.train_epoch, self.cls.eval_epoch = train, evaluate

    def _timed(self, batches, keep):
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            self.wait += time.perf_counter() - t0
            if b is None:
                return
            if keep:
                wave = b[0] if isinstance(b, (tuple, list)) else b
                self.batches.append(wave[:, :self.keep].clone())
            yield b

    def undo(self):
        self.cls.train_epoch, self.cls.eval_epoch = self.saved


def _data_pretrain_run(what, argv, card, train_steps, val_steps, tag="data_path"):
    """One ``run_pretrain`` call on the data path, launch counts exact, its
    epoch utt/s and the share of its wall spent waiting on data; returns
    (counts, kept train rows, epoch utt/s, wait share)."""
    waiter = _DataWait()
    try:
        _, counts, wall = _opt_run(what, argv, card, tag=tag)
    finally:
        waiter.undo()
    _check_opt_attention(what, counts, train_steps + val_steps, train_steps)
    want = PRETRAIN_DROPOUT_PER_STEP["train"] * train_steps
    assert counts.get("hash_dropout", 0) == want, (
        f"{what}: hash_dropout {counts.get('hash_dropout', 0)} launches, want {want}")
    exp = argv[argv.index("--exp-dir") + 1]
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert all(np.isfinite([r["loss"] for r in recs])), recs
    utt = [r["utt_per_sec"] for r in recs if r["split"] == "train"]
    log(f"[{tag}] {what}: epoch utt/s {utt}, waiting on data {waiter.wait:.2f} s "
        f"({waiter.wait / wall:.1%} of the wall {wall:.2f} s); launches exact ({card})")
    return counts, waiter.batches, utt, waiter.wait / wall


def _gen_tree(what, cli, argv, n, card, tag="data_path"):
    t0 = time.perf_counter()
    _cli(argv, cli)
    wall = time.perf_counter() - t0
    log(f"[{tag}] (a) {what}: {n} items in {wall:.2f} s, {wall / n:.4f} s/item on a host "
        f"of {os.cpu_count()} cores ({card})")


def phase_data_path(card, synthetic_utt_s):
    """The simulated-data path at the flagship widths: (a) generation and
    packing; (b) pre-training from the wav tree, the packed dir and the packed
    dir staged on the card in f32 and in int16; (c) the on-card synthesizer
    alone, card against CPU, and through ``run_pretrain --device-synth``; (d)
    downstream cells from the annotated trees. Each CLI call with the launch
    counts zeroed before and asserted exactly after."""
    import shutil
    import tempfile

    from sarssl_torch import data as data_mod
    from sarssl_torch.data import FixMicSigDataset, PackedDataset
    from sarssl_torch.data import device_synth as ds
    from sarssl_torch.data.wavio import read_wav
    from sarssl_torch.train import checkpoint as ckpt

    total = {}
    cores = str(os.cpu_count())
    with tempfile.TemporaryDirectory(prefix="data_path_") as tmp:
        tree, packed = os.path.join(tmp, "pretrain"), os.path.join(tmp, "pretrain_packed")
        val, test, rooms = (os.path.join(tmp, d) for d in ("val", "test", "rooms"))
        # (a) generation and packing: the pre-training tree on a worker per
        # core; the small trees in this process (spawning workers would cost
        # more than their 16 items)
        _gen_tree(f"gen_simu --stage pretrain, {cores} workers", "gen_simu", [
            "--stage", "pretrain", "--data-num", str(DATA_NUM), "--save-dir", tree, "--T",
            DATA_T, "--workers", cores], DATA_NUM, card)
        small = ["--T", DATA_T, "--workers", "1"]
        for stage, d in (("val", val), ("test", test)):
            _gen_tree(f"gen_simu --stage {stage}, in process", "gen_simu", [
                "--stage", stage, "--data-num", str(DATA_EVAL_NUM), "--save-dir", d, *small],
                DATA_EVAL_NUM, card)
        _gen_tree(f"gen_simu_certain_room {DATA_ROOMS} rooms, in process",
                  "gen_simu_certain_room", [
                      "--room-num", str(DATA_ROOMS), "--rir-per-room", str(DATA_RIRS),
                      "--sig-per-rir", str(DATA_SIGS), "--save-dir", rooms, *small],
                  DATA_ROOMS * DATA_RIRS * DATA_SIGS, card)
        t0 = time.perf_counter()
        _cli(["--data-dir", tree, "--out", packed], "pack_data")
        pack_s = time.perf_counter() - t0
        pds = PackedDataset(packed)
        gb = pds.n * pds.meta["nsample"] * pds.meta["nch"] * 4 / 1e9
        assert pds.n == DATA_NUM and pds.meta["nsample"] == NSAMPLE, pds.meta
        paths = FixMicSigDataset(tree).data_paths
        for i in (0, DATA_NUM // 2 + 9, DATA_NUM - 1):
            wave, annos = pds[i]
            sig, fs = read_wav(str(paths[i]))
            info = np.load(str(paths[i]).replace(".wav", "_info.npz"))
            assert fs == 16000 and np.array_equal(wave, sig), i
            for key, col in (("T60", "T60_edc"), ("DRR", "DRR"), ("TDOA", "TDOA"),
                             ("SNR", "SNR")):
                assert annos[key] == np.float32(info[col]), (i, key)
        log(f"[data_path] (a) pack_data: {pds.n} items, {gb:.3f} GB in {pack_s:.2f} s, "
            f"{gb / pack_s:.3f} GB/s; items 0, {DATA_NUM // 2 + 9}, {DATA_NUM - 1} of the tree "
            f"(wav and _info.npz) equal PackedDataset's rows ({card})")

        # (b) pre-training from files at the flagship width, 1 epoch a run
        base = ["--pretrain", "--fused-attention", "--bs", str(BATCH), "--train-num",
                str(CLI_TRAIN_NUM), "--val-num", str(CLI_VAL_NUM), "--epochs", "1"]
        nb_train, nb_val = CLI_TRAIN_NUM // BATCH, CLI_VAL_NUM // BATCH
        runs = {}
        for what, src in (("wav tree", ["--data-dir", tree]),
                          ("packed", ["--data-dir", packed]),
                          ("resident f32", ["--data-dir", packed, "--resident"]),
                          ("resident int16", ["--data-dir", packed, "--resident",
                                              "--resident-dtype", "int16"])):
            exp = os.path.join(tmp, "exp_" + what.replace(" ", "_"))
            counts, rows, utt, share = _data_pretrain_run(
                f"(b) {what}", base + src + ["--exp-dir", exp], card, nb_train, nb_val)
            _add_counts(total, counts)
            runs[what] = rows
            shutil.rmtree(exp)
        _, scale = pds.all_waves_i16(NSAMPLE)
        for a, b, q in zip(runs["packed"], runs["resident f32"], runs["resident int16"]):
            assert torch.equal(a, b), "--resident drew other rows than the packed stream"
            assert float((q - a).abs().max()) <= scale / 2 + 1e-6, "int16 staging off its step"
        log(f"[data_path] (b) the resident runs drew the packed run's rows: f32 equal, int16 "
            f"within half its step ({scale / 2:.3e})")

        # (c) the on-card synthesizer: alone at the flagship batch, then card
        # against CPU on the same draws, then through the CLI
        cfg = ds.DeviceSynthConfig(nsample=NSAMPLE)
        gen = torch.Generator(device="cuda").manual_seed(0)
        ds.synth_batch_device(gen, BATCH, cfg)  # warm-up
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: ds.synth_batch_device(gen, BATCH, cfg), iters=SYNTH_TIMED, warmup=1)
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        log(f"[data_path] (c) synth_batch_device B={BATCH}, nsample={NSAMPLE}: {ms:.2f} ms a "
            f"batch (CUDA events, {SYNTH_TIMED} calls), peak {peak:.2f} GiB over the "
            f"{base_mem / 2 ** 30:.2f} GiB held before ({card})")
        draws = ds.draw_inputs(torch.Generator().manual_seed(1), SYNTH_CHECK_B, cfg)
        want, wl = ds.synth_pair(draws, cfg)
        got, gl = ds.synth_pair({k: v.cuda() for k, v in draws.items()}, cfg)
        err = rel_err(got.cpu(), want)
        assert err <= TOL_SYNTH, f"synth_pair card against CPU: {err}"
        assert all(rel_err(gl[k].cpu(), wl[k]) <= 1e-6 for k in wl), (gl, wl)
        again = [ds.synth_batch_device(torch.Generator(device="cuda").manual_seed(5), 16, cfg)[0]
                 for _ in range(2)]
        assert torch.equal(*again), "synth_batch_device is not deterministic on the card"
        log(f"[data_path] (c) synth_pair's deterministic part at B={SYNTH_CHECK_B} f32, card "
            f"against CPU on the same draws: max err {err:.2e} of the peak (tol {TOL_SYNTH}); "
            "labels within 1e-6; a seed gives the same batch bit for bit")
        timer = _Timed()
        timer.wrap(data_mod, "synth_batch_device", "synth", sync=True)
        exp = os.path.join(tmp, "exp_device_synth")
        try:
            counts, _, utt, _ = _data_pretrain_run(
                "(c) --device-synth", ["--pretrain", "--device-synth", "--fused-attention",
                                       "--bs", str(BATCH), "--train-num", str(CLI_TRAIN_NUM),
                                       "--val-num", str(CLI_VAL_NUM), "--epochs",
                                       str(DATA_SYNTH_EPOCHS), "--exp-dir", exp],
                card, DATA_SYNTH_EPOCHS * nb_train, DATA_SYNTH_EPOCHS * nb_val)
        finally:
            timer.undo()
        _add_counts(total, counts)
        synth = timer.spent["synth"]
        assert len(synth) == DATA_SYNTH_EPOCHS * (nb_train + nb_val), len(synth)
        with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
            nrec = sum(1 for _ in f)  # one train and one val record an epoch
        assert nrec == 2 * DATA_SYNTH_EPOCHS, nrec
        log(f"[data_path] (c) --device-synth epoch utt/s {utt} beside phase pretrain_cli's "
            f"--synthetic {synthetic_utt_s} in this run; synthesis {len(synth)} batches in "
            f"{sum(synth):.2f} s ({1e3 * statistics.median(synth):.1f} ms median, synchronised) "
            f"({card})")
        shutil.rmtree(exp)

        # (d) downstream from the annotated trees, flagship width, f32
        pre = os.path.join(tmp, "pretrained")
        os.makedirs(pre)
        shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT, ckpt.best_path(pre))
        spent = {"cell_epoch": []}
        dbase = ["--ds-train", "--bs-set", str(DS_BATCH), "--lr-set", str(DS_LR), "--ntrial",
                 "1", "--epochs", "1", "--pretrain-ckpt", pre, *DS_DATA_NUMS]
        held = ["--val-data-dir", val, "--test-data-dir", test]
        nbatch = int(DS_DATA_NUMS[1]) // DS_BATCH
        for task in ("T60", "DRR"):
            exp = os.path.join(tmp, "ds_" + task)
            out, counts, learners, wall = _ds_cli_run(
                f"(d) --ds-task {task}", dbase + ["--ds-task", task, "--data-dir", tree, *held,
                                                  "--exp-dir", exp], spent, card)
            _check_ds_launches(f"(d) {task}", counts, _ds_train_steps(learners, nbatch),
                               "finetune")
            _add_counts(total, counts)
            res = _read_results(exp)
            cell = next(iter(res["cells"]))
            out_t, counts_t, _, wall_t = _ds_cli_run(
                f"(d) --ds-test {task}", ["--ds-test", "--ds-task", task, "--bs-set",
                                          str(DS_BATCH), "--data-dir", tree, *held,
                                          *DS_DATA_NUMS, "--ckpt",
                                          os.path.join(exp, cell, "ckpt"), "--exp-dir",
                                          os.path.join(tmp, "ds_test_" + task)], spent, card)
            _check_ds_launches(f"(d) --ds-test {task}", counts_t, 0, "finetune")
            m = re.search(rf"test \[{task}\]: loss \S+ MAE (\S+)", out_t)
            want = res["cells"][cell]["test_mae"]
            assert m and abs(float(m.group(1)) - want) <= TOL_DS_TEST * max(1.0, abs(want)), (
                out_t, res)
            log(f"[data_path] (d) {task}: cell {cell} val MAE {res['cells'][cell]['val_mae']:.5f} "
                f"test MAE {res['cells'][cell]['test_mae']:.5f}; the cell {wall:.2f} s, its "
                f"--ds-test {wall_t:.2f} s ({card})")
        for what, argv, rows in (
                ("--room-trials", ["--data-dir", rooms, "--room-trials", "--ds-nsimroom",
                                   str(DATA_ROOMS)], DATA_ROOMS * DATA_RIRS * DATA_SIGS),
                ("--fixed-train-subset", ["--data-dir", packed, "--fixed-train-subset"],
                 int(DS_DATA_NUMS[1]))):
            exp = os.path.join(tmp, "ds_" + what.strip("-"))
            out, counts, learners, wall = _ds_cli_run(
                f"(d) {what}", dbase + argv + held + ["--exp-dir", exp], spent, card)
            _check_ds_launches(f"(d) {what}", counts,
                               _ds_train_steps(learners, min(rows, int(DS_DATA_NUMS[1]))
                                               // DS_BATCH), "finetune")
            _add_counts(total, counts)
            res = _read_results(exp)
            log(f"[data_path] (d) {what} (TDOA): {res['cells']}, {wall:.2f} s ({card})")
    return total


def _int16_wav(path, sig, fs):
    from scipy.io import wavfile
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wavfile.write(path, fs, np.clip(sig * 32767, -32768, 32767).astype(np.int16))


def _decaying_rir(rng, n, nmic, t60, fs, peak_at=200):
    """A multichannel RIR: a direct path at ``peak_at`` (+3 samples a mic)
    over an exponential tail decaying 60 dB in ``t60`` seconds."""
    rir = rng.standard_normal((n, nmic)) * 0.05
    rir *= np.exp(-6.91 * np.arange(n) / (t60 * fs))[:, None]
    for m in range(nmic):
        rir[peak_at + 3 * m, m] = 1.0
    return rir.astype(np.float32)


def _real_data_trees(tmp, rng):
    """The corpus trees of phase real_data, in each corpus's on-disk layout;
    returns {name: dir}."""
    from sarssl_torch.data.extractors import ACEExtractor
    from sarssl_torch.data.wavio import write_wav

    d = {k: os.path.join(tmp, k) for k in ("ace", "src", "locata", "aishell4", "ami", "four")}
    rows = ["Mic config:, Room decode:, Room config:, Chan:, FB T60:, FB DRR:"]
    for r, room in enumerate(RD_ROOMS):
        for array, nmic in RD_ARRAYS.items():
            for pos in ("1", "2"):
                base = os.path.join(d["ace"], "RIRN", array, room, pos)
                os.makedirs(base)
                t60 = 0.35 + 0.2 * r
                write_wav(os.path.join(base, f"{room}_{pos}_RIR.wav"),
                          _decaying_rir(rng, int(1.5 * t60 * 48000), nmic, t60, 48000), 48000)
                write_wav(os.path.join(base, f"{room}_{pos}_Noise_Ambient.wav"),
                          (rng.standard_normal((6 * 48000, nmic)) * 0.01).astype(np.float32),
                          48000)
                rows += [f"{array}, {room}, {pos}, {ch}, {t60:.3f}, {5.0 - 2 * r:.2f}"
                         for ch in range(1, nmic + 1)]
    os.makedirs(os.path.join(d["ace"], "Data"))
    with open(os.path.join(d["ace"], "Data", ACEExtractor.ANNO_CSV), "w") as f:
        f.write("\n".join(rows) + "\n")
    for spk in range(6):  # WSJ0-style: <dir>/<speaker>/<utterance>.wav
        for u in range(3):
            _int16_wav(os.path.join(d["src"], f"spk{spk}", f"utt{u}.wav"),
                       rng.standard_normal(int((2.5 + u) * 16000)) * 0.1, 16000)
    for subset, rec, array, nch in (("eval", 1, "dicit", 15), ("eval", 2, "benchmark2", 12),
                                    ("dev", 1, "dicit", 15)):
        adir = os.path.join(d["locata"], subset, "task1", f"recording{rec}", array)
        sig = rng.standard_normal((8 * 48000, nch)) * 0.1
        sig[:24000] *= 1e-3  # 0.5 s of silence first
        _int16_wav(os.path.join(adir, f"audio_array_{array}.wav"), sig, 48000)
        npt, t = 40, np.linspace(0, 8, 40)
        tables = {"required_time.txt": {"hour": np.zeros(npt, int), "minute": np.zeros(npt, int),
                                        "second": t},
                  f"position_array_{array}.txt": {
                      "x": np.full(npt, 1.0), "y": np.full(npt, 1.5), "z": np.full(npt, 1.2),
                      **{f"rotation_{i + 1}{j + 1}": np.full(npt, float(i == j))
                         for i in range(3) for j in range(3)}},
                  "position_source_talker1.txt": {"x": 3.0 + 0.1 * t, "y": np.full(npt, 4.0),
                                                  "z": np.full(npt, 1.6)}}
        for name, cols in tables.items():
            with open(os.path.join(adir, name), "w") as f:
                f.write("\t".join(cols) + "\n")
                f.writelines("\t".join(str(cols[c][i]) for c in cols) + "\n"
                             for i in range(npt))
    # AISHELL4: two 60 s 8-channel sessions, one speaker's 2 s sentences every
    # 7 s and another's between them, so windows of >= 4.112 s hold one speaker
    tg = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
          "xmax = 60", "tiers? <exists>", "size = 1", "item []:", "    item [1]:",
          '        class = "IntervalTier"', '        name = "SPK01"', "        xmin = 0",
          "        xmax = 60", "        intervals: size = 8"]
    for k in range(8):
        tg += [f"        intervals [{k + 1}]:", f"            xmin = {7 * k}",
               f"            xmax = {7 * k + 2}", '            text = "speech"']
    for ds, room in (("train_M", "M_R001"), ("train_L", "L_R001")):
        name = f"20200707_{room}S01C01"
        _int16_wav(os.path.join(d["aishell4"], ds, "wav", f"{name}.wav"),
                   rng.standard_normal((60 * 16000, 8)) * 0.1, 16000)
        os.makedirs(os.path.join(d["aishell4"], ds, "TextGrid"))
        with open(os.path.join(d["aishell4"], ds, "TextGrid", f"{name}.TextGrid"), "w") as f:
            f.write("\n".join(tg) + "\n")
    for k in range(1, 9):
        _int16_wav(os.path.join(d["ami"], "ScenarioMeetings", "ES2002", "audio",
                                f"ES2002a.Array1-0{k}.wav"),
                   rng.standard_normal(60 * 16000) * 0.1, 16000)
    for i in range(4):
        _int16_wav(os.path.join(d["four"], f"rec{i}.wav"),
                   rng.standard_normal((30 * 16000, 4)) * 0.1, 16000)
    return d


def phase_real_data(card, step_utt_s):
    """The real-data path at the flagship widths, each CLI call with the
    launch counts zeroed before and asserted exactly after: (a) on the host,
    ``gen_real_rir --corpus ACE`` on an ACE-layout tree, ``gen_sig_from_real_rir``,
    ``gen_simu --mode rir`` and ``gen_locata``; (b) ``run_downstream --real-exp``
    T60 finetune cells from real and simulated RIRs with ``--rir-cv`` (one trial
    a room), then the same call with ``--mp-loader`` (the same batches), and
    ``--ds-test`` on a cell; (c) TDOA from the LOCATA tree mixed with a
    simulated one; (d) ``run_pretrain`` at the flagship width from
    ``--real-corpora`` (AISHELL4 with ``--remove-spkoverlap``, AMI),
    ``--real-data-dirs`` and ``--real-data-probs``."""
    import shutil
    import tempfile

    from sarssl_torch.cli.run_pretrain import _real_mixture
    from sarssl_torch.cli.run_pretrain import build_parser as pretrain_parser
    from sarssl_torch.data import FixMicSigDataset, FixMicSigDatasetLOCATA
    from sarssl_torch.data.wavio import read_wav
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.train import learner as learner_mod

    total = {}
    cores = str(os.cpu_count())
    rng = np.random.default_rng(11)
    with tempfile.TemporaryDirectory(prefix="real_data_") as tmp:
        t0 = time.perf_counter()
        d = _real_data_trees(tmp, rng)
        log(f"[real_data] (a) corpus trees written in {time.perf_counter() - t0:.2f} s")
        rirs, sig, simr, simsig = (os.path.join(tmp, k) for k in ("rirs", "sig", "sim_rirs",
                                                                  "sim_sig"))
        # (a) generation on the host
        t0 = time.perf_counter()
        out = _cli(["--corpus", "ACE", "--data-dir", d["ace"], "--save-dir", rirs],
                   "gen_real_rir")
        wall = time.perf_counter() - t0
        m = re.search(r"ACE: wrote (\d+) pair RIRs, (\d+) noise wavs", out)
        npair = 3 * len(RD_ROOMS) * 2 + len(RD_ROOMS) * 2  # Mobile 3 pairs, Chromebook 1
        assert m and int(m.group(1)) == int(m.group(2)) == npair, out
        assert sorted(os.listdir(rirs)) == sorted(RD_ROOMS), os.listdir(rirs)
        info = np.load(os.path.join(rirs, "Office_2", "Mobile", "SP1_MP1-1-2_info.npz"))
        assert abs(float(info["T60fromDataset"]) - 0.55) < 1e-9 and np.isfinite(info["DRR"])
        log(f"[real_data] (a) gen_real_rir --corpus ACE: {npair} pair RIRs and noise wavs in "
            f"{wall:.2f} s, {wall / npair:.4f} s a pair RIR ({card})")
        t0 = time.perf_counter()
        _cli(["--rir-dir", rirs, "--src-dir", d["src"], "--save-dir", sig, "--num",
              str(RD_SIG_NUM), "--corpus", "ACE"], "gen_sig_from_real_rir")
        wall = time.perf_counter() - t0
        for i in (0, RD_SIG_NUM - 1):
            w, fs = read_wav(os.path.join(sig, f"{i}.wav"))
            lab = np.load(os.path.join(sig, f"{i}_info.npz"))
            assert fs == 16000 and w.shape == (NSAMPLE, 2) and abs(np.abs(w).max() - 0.9) < 1e-6
            assert all(np.isfinite(lab[k]) for k in ("T60", "DRR", "C50", "SNR", "ABS")), i
        log(f"[real_data] (a) gen_sig_from_real_rir: {RD_SIG_NUM} items of {DATA_T} s in "
            f"{wall:.2f} s, {wall / RD_SIG_NUM:.4f} s/item, one process ({card})")
        sim_t60 = ["--t60-range", *RD_SIM_T60, "--workers", cores]
        _gen_tree(f"gen_simu --mode rir, T60 {RD_SIM_T60}, {cores} workers", "gen_simu", [
            "--mode", "rir", "--stage", "train", "--data-num", str(RD_SIM_RIRS), "--save-dir",
            simr, *sim_t60], RD_SIM_RIRS, card, tag="real_data")
        _gen_tree(f"gen_simu --T 1.04, T60 {RD_SIM_T60}, {cores} workers", "gen_simu", [
            "--stage", "train", "--data-num", str(RD_SIM_SIG_NUM), "--save-dir", simsig, "--T",
            "1.04", *sim_t60], RD_SIM_SIG_NUM, card, tag="real_data")
        loc = os.path.join(tmp, "locata_sig")
        for stage, n in RD_LOCATA_NUM.items():
            t0 = time.perf_counter()
            _cli(["--data-dir", d["locata"], "--save-dir", os.path.join(loc, stage), "--stage",
                  stage, "--num", str(n)], "gen_locata")
            wall = time.perf_counter() - t0
            ds = FixMicSigDatasetLOCATA(os.path.join(loc, stage), load_anno=True)
            w, lab = ds[n - 1]
            assert len(ds) == n and w.shape == (DS_NSAMPLE, 2), (stage, len(ds), w.shape)
            assert abs(lab["TDOA"]) <= 0.2 / 343 + 1e-6, lab
            log(f"[real_data] (a) gen_locata --stage {stage}: {n} items in {wall:.2f} s, "
                f"{wall / n:.4f} s/item ({card})")

        # (b) downstream from RIRs: T60 finetune cells, one a held-out room
        pre = os.path.join(tmp, "pretrained")
        os.makedirs(pre)
        shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT, ckpt.best_path(pre))
        spent = {"cell_epoch": []}
        nbatch = int(RD_DS_NUMS[1]) // RD_DS_BATCH
        rir_flags = ["--rir-dir", rirs, "--sim-rir-dir", simr, "--src-dir", d["src"],
                     "--real-sim-ratio", "1", "1", "--rir-cv", "--real-exp", "--ds-task", "T60",
                     "--T", DATA_T, *RD_DS_NUMS]
        dbase = ["--ds-train", "--ds-trainmode", "finetune", "--lr-set", "1e-3", "--epochs", "1",
                 "--pretrain-ckpt", pre, *rir_flags]
        drawn = {}
        for what, more in (("threads", ["--workers", "4"]),
                           ("--mp-loader", ["--mp-loader", "--workers", cores])):
            exp = os.path.join(tmp, "ds_rir_" + what.strip("-"))
            waiter = _DataWait(cls=learner_mod.DownstreamLearner)
            first = len(spent["cell_epoch"])
            try:
                out, counts, learners, wall = _ds_cli_run(
                    f"(b) T60 from RIRs, {what}", dbase + more + ["--exp-dir", exp], spent, card)
            finally:
                waiter.undo()
            n_rooms = len(RD_ROOMS)
            assert f"cross-validation over {n_rooms} rooms -> {n_rooms} trials" in out
            res = _read_results(exp)
            assert sorted(res["cells"]) == [f"trial{t}_bs{RD_DS_BATCH}_lr0.001"
                                            for t in range(len(RD_ROOMS))], res["cells"]
            _check_ds_launches(f"(b) {what}", counts, _ds_train_steps(learners, nbatch),
                               "finetune")
            _add_counts(total, counts)
            drawn[what] = waiter.batches
            cells = spent["cell_epoch"][first:]
            log(f"[real_data] (b) {what} ({more[-1]} workers): {len(cells)} cells, s per cell "
                f"epoch {[round(c, 3) for c in cells]}, waiting on data {waiter.wait:.2f} s "
                f"({waiter.wait / wall:.1%} of the wall {wall:.2f} s); test MAE "
                f"{[round(r['test_mae'], 5) for r in res['cells'].values()]} ({card})")
            if what == "threads":
                cell = f"trial0_bs{RD_DS_BATCH}_lr0.001"
                want = res["cells"][cell]["test_mae"]
                keep_exp = exp
            else:
                shutil.rmtree(exp)
        assert len(drawn["threads"]) == len(drawn["--mp-loader"]) == len(RD_ROOMS) * nbatch
        assert all(torch.equal(a, b) for a, b in zip(drawn["threads"], drawn["--mp-loader"])), \
            "--mp-loader drew other batches than the threads"
        out_t, counts_t, _, wall_t = _ds_cli_run(
            "(b) --ds-test", ["--ds-test", *rir_flags,
                              "--ckpt", os.path.join(keep_exp, cell, "ckpt"),
                              "--exp-dir", os.path.join(tmp, "ds_rir_test")], spent, card)
        _check_ds_launches("(b) --ds-test", counts_t, 0, "finetune")
        m = re.search(r"test \[T60\]: loss \S+ MAE (\S+)", out_t)
        assert m and abs(float(m.group(1)) - want) <= TOL_DS_TEST * max(1.0, abs(want)), (
            out_t, want)
        shutil.rmtree(keep_exp)
        log(f"[real_data] (b) --mp-loader drew the threads' batches bit for bit; --ds-test on "
            f"{cell}: MAE {m.group(1)} against the grid's {want:.5f}, {wall_t:.2f} s ({card})")

        # (c) downstream from real signals: TDOA, the LOCATA tree mixed 1:1
        # with a simulated one
        exp = os.path.join(tmp, "ds_sig")
        waiter = _DataWait(cls=learner_mod.DownstreamLearner)
        first = len(spent["cell_epoch"])
        try:
            out, counts, learners, wall = _ds_cli_run(
                "(c) TDOA from real signals", [
                    "--ds-train", "--real-exp", "--ds-task", "TDOA", "--real-sig-dir", loc,
                    "--sim-sig-dir", simsig, "--real-sim-ratio", "1", "1", "--lr-set", "1e-3",
                    "--epochs", "1", "--pretrain-ckpt", pre, "--workers", cores, *RD_DS_NUMS,
                    "--exp-dir", exp], spent, card)
        finally:
            waiter.undo()
        res = _read_results(exp)
        _check_ds_launches("(c)", counts, _ds_train_steps(learners, nbatch), "finetune")
        _add_counts(total, counts)
        log(f"[real_data] (c) TDOA --real-sig-dir + --sim-sig-dir: cell epoch "
            f"{[round(c, 3) for c in spent['cell_epoch'][first:]]} s, waiting on data "
            f"{waiter.wait:.2f} s ({waiter.wait / wall:.1%} of the wall {wall:.2f} s); "
            f"{res['cells']} ({card})")
        assert len(FixMicSigDataset(simsig)) == RD_SIM_SIG_NUM
        shutil.rmtree(exp)

        # (d) pre-training from real corpora at the flagship width
        exp = os.path.join(tmp, "pre_real")
        argv = ["--pretrain", "--fused-attention", "--bs", str(BATCH), "--train-num",
                str(CLI_TRAIN_NUM), "--val-num", str(CLI_VAL_NUM), "--epochs", "1",
                "--real-corpora", f"AISHELL4={d['aishell4']}", f"AMI={d['ami']}",
                "--remove-spkoverlap", "--real-data-dirs", d["four"], "--real-data-probs",
                *RD_PROBS, "--workers", cores, "--exp-dir", exp]
        nb_train, nb_val = CLI_TRAIN_NUM // BATCH, CLI_VAL_NUM // BATCH
        counts, rows, utt, share = _data_pretrain_run(
            "(d) --real-corpora AISHELL4 AMI --remove-spkoverlap --real-data-dirs", argv, card,
            nb_train, nb_val, tag="real_data")
        _add_counts(total, counts)
        # the first rows drawn are the mixture's items 0.. of epoch 0
        mix = _real_mixture(pretrain_parser().parse_args(argv), NSAMPLE)
        for i in (0, 1, BATCH + 5):
            item = mix.sample(np.random.default_rng((100, 0, 0, 0, i)))
            got = rows[i // BATCH][i % BATCH].float().cpu().numpy()
            assert np.array_equal(got, item[:got.shape[0]]), f"item {i} of the epoch differs"
        log(f"[real_data] (d) epoch utt/s {utt} beside phase train's step alone "
            f"{step_utt_s:.1f}; the host waited {share:.1%} of the wall inside next; items 0, "
            f"1, {BATCH + 5} of the epoch equal the mixture's draws ({card})")
        shutil.rmtree(exp)
    return total


def _grid_cli_run(what, argv, card):
    """One ``run_downstream --grid-vmap`` call with the launch counts zeroed
    before and read after, its runners caught and each chunk's epochs timed
    (``train_epoch`` to ``end_epoch``, the card synchronised), the peak device
    memory taken; returns (output, counts, runners, [(chunk, epoch, s)], wall,
    peak GiB)."""
    from sarssl_torch.kernels import launches, reset_launches
    from sarssl_torch.train import grid

    cls = grid.VmappedGridRunner
    runners, started, epochs = [], {}, []
    saved = {k: getattr(cls, k) for k in ("train_epoch", "train_epoch_resident", "end_epoch")}

    def start(name):
        def run(self, *a, **k):
            if self not in runners:
                runners.append(self)
            torch.cuda.synchronize()
            started[id(self)] = time.perf_counter()
            return saved[name](self, *a, **k)
        return run

    def end(self, *a, **k):
        out = saved["end_epoch"](self, *a, **k)
        torch.cuda.synchronize()
        epochs.append((runners.index(self), self.epoch - 1,
                       time.perf_counter() - started.pop(id(self))))
        return out

    cls.train_epoch, cls.train_epoch_resident = start("train_epoch"), start("train_epoch_resident")
    cls.end_epoch = end
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = _cli(argv, "run_downstream")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        for k, v in saved.items():
            setattr(cls, k, v)
    assert "device cuda" in out, f"{what}: the CLI did not report its device"
    log(f"[grid_vmap] {what}: wall {wall:.2f} s, peak {peak:.2f} GiB, launches {counts} ({card})")
    return out, counts, runners, epochs, wall, peak


def _check_grid_launches(what, counts, runners, nbatch, kind):
    """hash_dropout_lanes exactly DS_DROPOUT_PER_STEP[kind] a vmapped step
    (each site once for all lanes, forward and backward), no unbatched
    dropout and no other kernel inside the vmapped run."""
    steps = sum(r.epoch for r in runners) * nbatch
    want = DS_DROPOUT_PER_STEP[kind] * steps
    assert counts.get("hash_dropout_lanes", 0) == want, (
        f"{what}: hash_dropout_lanes {counts.get('hash_dropout_lanes', 0)} launches, want {want} "
        f"({DS_DROPOUT_PER_STEP[kind]} x {steps} vmapped steps)")
    assert set(counts) == {"hash_dropout_lanes"}, f"{what}: other launches {counts}"
    return steps


def _grid_results(exp, cells, truncated=False):
    from sarssl_torch.utils.results import read_results
    res = read_results(exp)
    assert set(res) == {"task", "mode", "cells", "summary", "best", "best_test_mae"}, set(res)
    assert sorted(res["cells"]) == sorted(cells), sorted(res["cells"])
    for cell, r in res["cells"].items():
        assert set(r) == {"val_mae", "test_mae", "lr", "bs", "trial", "epochs_run",
                          "truncated"}, r
        assert np.isfinite([r["val_mae"], r["test_mae"]]).all() and r["truncated"] == truncated
        assert os.listdir(os.path.join(exp, cell, "ckpt")) == ["ensemble_model.msgpack"], cell
    return res


def _grid_step_profile(card, steps=3):
    """One vmapped finetune step of GRID_CHUNK lanes at the flagship width
    (f32, batch 8, 1.04 s, dropout 0.1, random weights), timed (median of
    ``steps`` after 2 warm-ups, each synchronised) beside one sequential step
    of the same model, then profiled: device ms a step, the busy share and
    the kernels that take the most device time."""
    from collections import defaultdict

    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import VmappedGridRunner, create_train_state, make_downstream_step

    model = SARSSL(SARSSLConfig(sig_shape=(256, DS_FRAMES, 2, 2), pretrain=False),
                   device="cuda", seed=DSCLI_SEED)
    wave, tdoa = synth_batch(np.random.default_rng(0), DS_BATCH, DS_NSAMPLE)
    wave, gt = torch.from_numpy(wave).cuda(), torch.from_numpy(tdoa / 16000.0).cuda()
    step = make_downstream_step(model, FeatureConfig(), "TDOA", device="cuda")
    state = create_train_state(model)
    gen = torch.Generator().manual_seed(0)
    runner = VmappedGridRunner(model, FeatureConfig(), [create_train_state(model)] * GRID_CHUNK,
                               [(0, float(lr)) for lr in GRID_LRS * 2], scan_block=1,
                               lane_slots=[0] * GRID_CHUNK, device="cuda")
    gens = [torch.Generator().manual_seed(1) for _ in range(GRID_CHUNK)]
    lrs = runner._lrs()

    def vstep():
        runner.train_block(runner.states, gens, wave[None, None], gt[None, None], lrs)

    out = {}
    for what, fn in (("sequential", lambda: step(state, wave, gt, DS_LR, gen)),
                     ("vmapped", vstep)):
        for _ in range(2):
            fn()
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[what] = statistics.median(times) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            vstep()
        torch.cuda.synchronize()
    per_kernel, counts = defaultdict(float), defaultdict(int)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] += evt.device_time_total / steps / 1e3
            counts[evt.name] += 1
    dev_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"[grid_vmap] (e) one vmapped finetune step of {GRID_CHUNK} lanes: {out['vmapped']:.2f} "
        f"ms (median of {steps}), one sequential step {out['sequential']:.2f} ms "
        f"({GRID_CHUNK} of them {GRID_CHUNK * out['sequential']:.2f} ms, "
        f"{GRID_CHUNK * out['sequential'] / out['vmapped']:.2f}x); profiled: device time "
        f"{dev_ms:.2f} ms a step, busy share {dev_ms / out['vmapped']:.3f}, "
        f"{sum(counts.values()) / steps:.0f} launches a step ({card})")
    if dev_ms == 0:
        log("[grid_vmap] (e) the profiler recorded no device time")
    for name, ms in top:
        log(f"[grid_vmap] (e)   {ms:8.3f} ms {100 * ms / max(dev_ms, 1e-9):5.1f}% "
            f"{counts[name] / steps:5.1f}/step  {name[:100]}")
    del runner, model, state
    torch.cuda.empty_cache()


def phase_grid_vmap(card):
    """The vmapped downstream grid through ``run_downstream --grid-vmap`` at
    the flagship width (f32, TDOA, 1.04 s clips, batch 8) from the committed
    trained checkpoint: (a) the reference's simulated grid, 16 cells (4 lr x
    4 trials) in two chunks of 8 lanes, 2 epochs, then (b) the same grid
    without --grid-vmap: seconds per grid epoch of each, per-cell MAE of the
    two against each other, launch counts exact; (c) a lineareval chunk (the
    encoders of every ensemble bit-identical to the checkpoint's); (d) a
    resident packed run from a small gen_simu tree; (e) one vmapped step timed
    beside a sequential one and profiled. Returns the launches of (a), (c)
    and (d)."""
    import shutil
    import tempfile

    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.utils.weights import from_jax_params

    total = {}
    nbatch = int(DSCLI_NUMS[1]) // DS_BATCH
    cells = [f"trial{t}_bs{DS_BATCH}_lr{float(lr):g}" for t in range(GRID_TRIALS)
             for lr in GRID_LRS]
    with tempfile.TemporaryDirectory(prefix="grid_vmap_") as tmp:
        pre = os.path.join(tmp, "pretrained")
        os.makedirs(pre)
        shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT, ckpt.best_path(pre))
        common = ["--ds-train", "--synthetic", "--ds-task", "TDOA", "--bs-set", str(DS_BATCH),
                  "--lr-set", *GRID_LRS, "--pretrain-ckpt", pre, *DSCLI_NUMS]
        grid = ["--grid-vmap", "--grid-chunk", str(GRID_CHUNK), "--scan-block", str(GRID_SCAN)]

        # (a) the vmapped grid
        exp_a = os.path.join(tmp, "a")
        out, counts, runners, epochs, wall_a, peak = _grid_cli_run(
            "(a) --grid-vmap 16 cells", common + grid + [
                "--ntrial", str(GRID_TRIALS), "--epochs", str(GRID_EPOCHS), "--exp-dir", exp_a],
            card)
        res_a = _grid_results(exp_a, cells)
        assert len(runners) == 2 and out.count("--- grid chunk") == 2, out
        steps = _check_grid_launches("(a)", counts, runners, nbatch, "finetune")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        vm_epoch = [sum(t for _, e, t in epochs if e == ep) for ep in range(GRID_EPOCHS)]
        for ci, ep, t in epochs:
            log(f"[grid_vmap] (a) chunk {ci + 1} epoch {ep}: {t:.3f} s"
                + (" (its first pass, with its warm-up)" if ep == 0 else ""))
        ens = ckpt.load_checkpoint(ckpt.ensemble_path(os.path.join(exp_a, cells[0], "ckpt")))
        assert set(ens) == {"meta", "params", "batch_stats"}, set(ens)

        # (b) the same grid, one cell after another; a finished cell's files
        # go at once (16 cells x ~0.7 GB)
        from sarssl_torch.train import checkpoint as ckpt_mod
        prune = ckpt_mod.remove_checkpoint_epochs
        ckpt_mod.remove_checkpoint_epochs = lambda d, _e: shutil.rmtree(d)
        spent = {"cell_epoch": []}
        try:
            exp_b = os.path.join(tmp, "b")
            _, counts_b, learners, wall_b = _ds_cli_run(
                "(b) sequential 16 cells", common + [
                    "--ntrial", str(GRID_TRIALS), "--epochs", str(GRID_EPOCHS), "--exp-dir",
                    exp_b], spent, card)
        finally:
            ckpt_mod.remove_checkpoint_epochs = prune
        res_b = _read_results(exp_b)
        _check_ds_launches("(b)", counts_b, _ds_train_steps(learners, nbatch), "finetune")
        assert not counts_b.get("hash_dropout_lanes"), counts_b
        seq_epoch = [sum(spent["cell_epoch"][i] for i in range(ep, len(spent["cell_epoch"]),
                                                               GRID_EPOCHS))
                     for ep in range(GRID_EPOCHS)]
        worst = 0.0
        for cell in cells:
            a, b = res_a["cells"][cell], res_b["cells"][cell]
            for k in ("val_mae", "test_mae"):
                worst = max(worst, abs(a[k] - b[k]) / abs(b[k]))
            log(f"[grid_vmap] {cell}: val MAE {a['val_mae']:.5f} / {b['val_mae']:.5f}, test MAE "
                f"{a['test_mae']:.5f} / {b['test_mae']:.5f} (vmapped / sequential)")
        log(f"[grid_vmap] seconds per grid epoch (16 cells): vmapped {vm_epoch[0]:.3f} / "
            f"{vm_epoch[1]:.3f}, sequential {seq_epoch[0]:.3f} / {seq_epoch[1]:.3f} (epochs 0 / "
            f"1); epoch 1 ratio {seq_epoch[1] / vm_epoch[1]:.2f}x; wall {wall_a:.2f} s vmapped, "
            f"{wall_b:.2f} s sequential ({wall_b / wall_a:.2f}x); peak {peak:.2f} GiB a chunk "
            f"of {GRID_CHUNK} lanes; hash_dropout_lanes {counts['hash_dropout_lanes']} = "
            f"{DS_DROPOUT_PER_STEP['finetune']} x {steps} vmapped steps, hash_dropout 0 ({card})")
        log(f"[grid_vmap] per-cell MAE, vmapped against sequential: worst relative difference "
            f"{worst:.3e} (tol {TOL_GRID:g})")
        assert worst <= TOL_GRID, f"vmapped and sequential cells differ by {worst:.3e}"

        # (c) a lineareval chunk
        exp_c = os.path.join(tmp, "c")
        lin_cells = [f"trial{t}_bs{DS_BATCH}_lr{float(lr):g}" for t in range(GRID_LIN_TRIALS)
                     for lr in GRID_LRS]
        _, counts, runners, _, wall_c, _ = _grid_cli_run(
            "(c) --grid-vmap lineareval chunk", common + grid + [
                "--ds-trainmode", "lineareval", "--ntrial", str(GRID_LIN_TRIALS), "--epochs", "1",
                "--exp-dir", exp_c], card)
        _grid_results(exp_c, lin_cells)
        steps_c = _check_grid_launches("(c)", counts, runners, nbatch, "lineareval")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        src = from_jax_params(ckpt.load_checkpoint(ckpt.best_path(pre)))[0]  # f16 -> f32
        for cell in lin_cells:
            ens_p, _ = from_jax_params(ckpt.load_checkpoint(ckpt.ensemble_path(
                os.path.join(exp_c, cell, "ckpt"))))
            enc = [n for n in ens_p if n.startswith(("spec_encoder.", "spat_encoder."))]
            assert enc and all(torch.equal(ens_p[n], src[n].float()) for n in enc), (
                f"lineareval {cell}: an encoder parameter moved")
        log(f"[grid_vmap] (c) lineareval chunk of {len(lin_cells)} lanes: every cell's "
            f"{len(enc)} encoder parameters bit-identical to the checkpoint's; "
            f"hash_dropout_lanes {counts['hash_dropout_lanes']} = "
            f"{DS_DROPOUT_PER_STEP['lineareval']} x {steps_c} vmapped steps; wall {wall_c:.2f} s")

        # (d) resident packed data from a small gen_simu tree
        tree, packed = os.path.join(tmp, "tree"), os.path.join(tmp, "packed")
        val, test = os.path.join(tmp, "val"), os.path.join(tmp, "test")
        small = ["--T", "1.04", "--workers", "1"]
        for stage, d, n in (("train", tree, GRID_RES_NUM), ("val", val, GRID_RES_EVAL_NUM),
                            ("test", test, GRID_RES_EVAL_NUM)):
            _gen_tree(f"gen_simu --stage {stage}, in process", "gen_simu", [
                "--stage", stage, "--data-num", str(n), "--save-dir", d, *small], n, card,
                tag="grid_vmap")
        _cli(["--data-dir", tree, "--out", packed], "pack_data")
        exp_d = os.path.join(tmp, "d")
        res_cells = [f"trial{t}_bs{DS_BATCH}_lr{float(lr):g}" for t in range(2)
                     for lr in GRID_LRS[:2]]
        out, counts, runners, _, wall_d, _ = _grid_cli_run(
            "(d) --grid-vmap resident packed", [
                "--ds-train", "--ds-task", "TDOA", "--bs-set", str(DS_BATCH), "--lr-set",
                *GRID_LRS[:2], "--ntrial", "2", "--pretrain-ckpt", pre, "--data-dir", packed,
                "--val-data-dir", val, "--test-data-dir", test, "--train-num",
                str(GRID_RES_NUM), "--val-num", str(GRID_RES_EVAL_NUM), "--test-num",
                str(GRID_RES_EVAL_NUM), "--epochs", "1", "--exp-dir", exp_d, *grid], card)
        assert f"staged {GRID_RES_NUM} train utts" in out, out
        assert all(r.resident_waves is not None for r in runners)
        _grid_results(exp_d, res_cells)
        steps_d = _check_grid_launches("(d)", counts, runners, GRID_RES_NUM // DS_BATCH,
                                       "finetune")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        log(f"[grid_vmap] (d) resident packed run: {GRID_RES_NUM} train utts on the card, "
            f"{len(res_cells)} cells, {steps_d} vmapped steps, wall {wall_d:.2f} s")
    # (e) where a vmapped step's time goes (its launches are not the runs')
    _grid_step_profile(card)
    return total


def _ablation_model(local, mode, seed=0):
    from sarssl_torch.models import CauCRNN, EmbedEncoder

    gen = torch.Generator().manual_seed(seed)
    if local == "caucrnn":
        return CauCRNN(generator=gen)
    return EmbedEncoder(ABL_SIG, ABL_PATCH, ABL_DEMBED[mode], model=(local,), mode=mode,
                        generator=gen)


def _ablation_data(local, mode, nb, seed):
    """Seeded (input, target): the patches (or CauCRNN's TF map) and an MSE
    target of the arm's output shape."""
    rng = np.random.default_rng(seed)
    nf, nt, nreim, nmic = ABL_SIG
    if local == "caucrnn":  # its pools stride time 1 * 1 * 2 * 2 * 3
        x, y = (nb, nf, nt, nreim * nmic), (nb, nt // 12, 512)
    else:
        x, y = (nb, nt, ABL_PATCH[0] * ABL_PATCH[1] * nreim * nmic), (nb, nt, ABL_DEMBED[mode])
    return (torch.from_numpy(rng.standard_normal(x, dtype=np.float32)),
            torch.from_numpy(rng.standard_normal(y, dtype=np.float32)))


def _ablation_step(state, x, target):
    """One train step: forward in train mode, MSE, backward, AdamW + clip."""
    state.model.train()
    loss = torch.nn.functional.mse_loss(state.model(x, True), target)
    loss.backward()
    state.apply_gradients(ABL_LR)
    return loss.detach()


def _ablation_tx():
    from sarssl_torch.train import make_adam

    return make_adam(ABL_LR, weight_decay=ABL_WD, grad_clip=ABL_CLIP)


def _device_ms(prof, steps):
    """From a profile of ``steps`` steps: device ms a step (the kernels' summed
    times), busy ms a step (the union of their intervals: the GRU's two
    directions overlap) and the 3 kernels that take the most device time."""
    per_kernel, spans = {}, []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] = per_kernel.get(evt.name, 0.0) + evt.device_time_total / 1e3
            spans.append((evt.time_range.start, evt.time_range.end))
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:3]
    return (sum(per_kernel.values()) / steps, busy_us / 1e3 / steps,
            [(name[:60], ms / steps) for name, ms in top])


def _ablation_train(card):
    """(a) Every arm at batch 128: one warm-up and ABL_STEPS timed steps, then
    one profiled step (device ms, busy share, the longest kernel)."""
    from sarssl_torch.train import create_train_state

    rows = {}
    for local, mode in ABL_ARMS:
        name = local if mode is None else f"{local}/{mode}"
        model = _ablation_model(local, mode).cuda()
        state = create_train_state(model, tx=_ablation_tx())
        x, target = (t.cuda() for t in _ablation_data(local, mode, BATCH, 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [float(_ablation_step(state, x, target))]
        warm = time.perf_counter() - t0
        times = []
        for _ in range(ABL_STEPS):
            t0 = time.perf_counter()
            losses.append(float(_ablation_step(state, x, target)))
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        assert all(np.isfinite(losses)), f"{name}: non-finite loss {losses}"
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _ablation_step(state, x, target)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        dev_ms, busy_ms, top = _device_ms(prof, 1)
        med = statistics.median(times)
        nparam = sum(p.numel() for p in model.parameters()) / 1e6
        rows[name] = {"ms": 1e3 * med, "utt_s": BATCH / med, "peak_gib": peak}
        log(f"[ablations] (a) {name}: {nparam:.3f} M params, warm-up {1e3 * warm:.1f} ms, median "
            f"step {1e3 * med:.2f} ms ({ABL_STEPS} steps), {BATCH / med:.1f} utt/s, peak "
            f"{peak:.2f} GiB, losses {[round(v, 5) for v in losses]}; profiled step "
            f"{1e3 * prof_s:.2f} ms: kernels {dev_ms:.2f} ms, busy {busy_ms:.2f} ms (share "
            f"{busy_ms / (1e3 * prof_s):.3f}), longest {[(n, round(t, 2)) for n, t in top]} "
            f"({card})")
        del model, state, x, target, prof
        torch.cuda.empty_cache()
    return rows


def _ablation_card_vs_cpu():
    """(b) Every arm at batch ABL_CHECK_B: the same weights and inputs on the
    card and on the CPU, the eval forward, then one AdamW + clip step (its
    loss, parameters and BatchNorm stats)."""
    import copy

    from sarssl_torch.train import create_train_state

    for local, mode in ABL_ARMS:
        name = local if mode is None else f"{local}/{mode}"
        x, target = _ablation_data(local, mode, ABL_CHECK_B, 2)
        models = {"cpu": _ablation_model(local, mode, seed=3)}
        models["cuda"] = copy.deepcopy(models["cpu"]).cuda()
        out, loss = {}, {}
        for dev, m in models.items():
            m.eval()
            with torch.no_grad():
                out[dev] = m(x.to(dev), False).cpu()
            loss[dev] = float(_ablation_step(create_train_state(m, tx=_ablation_tx()),
                                             x.to(dev), target.to(dev)))
        fwd_err = rel_err(out["cuda"], out["cpu"])
        loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        cpu_p = dict(models["cpu"].named_parameters())
        worst, far, total = 0.0, 0, 0
        for n, p in models["cuda"].named_parameters():
            d = (p.detach().cpu() - cpu_p[n].detach()).abs()
            worst, far, total = max(worst, float(d.max())), far + int((d > ABL_STEP_FAR).sum()), \
                total + d.numel()
        cpu_b = dict(models["cpu"].named_buffers())
        stats_err = max(rel_err(b.cpu(), cpu_b[n]) for n, b in models["cuda"].named_buffers())
        log(f"[ablations] (b) {name} at batch {ABL_CHECK_B}, card against CPU: eval forward "
            f"{fwd_err:.2e}, train loss {loss_err:.2e}, BatchNorm stats {stats_err:.2e} (of the "
            f"max, tol {TOL_REF}); after one AdamW + clip step the parameters differ by at most "
            f"{worst:.3e} (bound {2 * ABL_LR * 1.05:.2e}), {far} of {total} elements "
            f"({far / total:.2e}) past {ABL_STEP_FAR} (at most {ABL_FAR_SHARE})")
        assert fwd_err <= TOL_REF and loss_err <= TOL_REF and stats_err <= TOL_REF, name
        assert worst <= 2 * ABL_LR * 1.05 and far <= ABL_FAR_SHARE * total, name


def _ablation_utils(card):
    """(c) dpipd_template and forgetting_norm, card against CPU;
    estimate_flops of the flagship pretext forward; StepTimer and trace
    around two flagship pretext train steps."""
    import tempfile

    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig, gen_patch_mask, stft_features
    from sarssl_torch.ops.dpipd import dpipd_template
    from sarssl_torch.train import create_train_state, make_pretrain_step
    from sarssl_torch.utils.metrics import estimate_flops, forgetting_norm
    from sarssl_torch.utils.profiling import StepTimer, trace

    rng = np.random.default_rng(4)
    mic = rng.uniform(-0.05, 0.05, (4, 3))
    tpl = {dev: dpipd_template(mic, ABL_DOA_GRID, ABL_NF, ch_mode="MM", device=dev)[0]
           for dev in ("cpu", "cuda")}
    ms = cuda_ms(lambda: dpipd_template(mic, ABL_DOA_GRID, ABL_NF, ch_mode="MM", device="cuda"),
                 iters=5, warmup=1)
    err = float((tpl["cuda"].cpu() - tpl["cpu"]).abs().max())
    log(f"[ablations] (c) dpipd_template {tuple(tpl['cuda'].shape)} MM: card against CPU max abs "
        f"err {err:.2e} (tol {TOL_DPIPD}), {ms:.3f} ms on the card ({card})")
    assert err <= TOL_DPIPD, err
    x = torch.from_numpy(np.abs(rng.standard_normal(ABL_FN_SHAPE, dtype=np.float32)))
    xc = x.cuda()
    fn = {"cpu": forgetting_norm(x), "cuda": forgetting_norm(xc).cpu()}
    ms = cuda_ms(lambda: forgetting_norm(xc), iters=3, warmup=1)
    err = rel_err(fn["cuda"], fn["cpu"])
    log(f"[ablations] (c) forgetting_norm {ABL_FN_SHAPE}: card against CPU {err:.2e} of the max "
        f"(tol {TOL_F32}), {ms:.2f} ms on the card ({card})")
    assert err <= TOL_F32, err

    wave, _ = synth_batch(np.random.default_rng(0), BATCH, NSAMPLE)
    wave = torch.from_numpy(wave).cuda()
    # the flagship pretext forward, unfused, so the attention's products are
    # aten calls that FlopCounterMode sees (it does not see a hand-written kernel)
    model = SARSSL(SARSSLConfig(), device="cuda", seed=0).eval()
    feats = stft_features(wave, FeatureConfig())
    mask = gen_patch_mask(torch.Generator().manual_seed(0), feats.shape[0], model.cfg.npatch,
                          model.cfg.effective_nmasked(), nmic=2, device="cuda")
    gflops = estimate_flops(lambda: model.pretext(feats, mask, False))
    log(f"[ablations] (c) estimate_flops of the flagship pretext forward (f32, batch "
        f"{feats.shape[0]} pair rows): {gflops:.1f} GFLOPs, {gflops / BATCH:.3f} a 2-mic "
        f"utterance (FlopCounterMode: matmuls, convolutions, attention)")
    assert gflops > 0
    del model, feats
    model = SARSSL(SARSSLConfig(dtype="bfloat16", fused_attention=True), device="cuda", seed=0)
    state = create_train_state(model)
    step = make_pretrain_step(model, FeatureConfig(), device="cuda")
    gen = torch.Generator().manual_seed(0)
    step(state, wave, 1e-3, gen)  # cuDNN plans, outside the timer
    timer = StepTimer(warmup=0)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            for _ in range(2):
                timer.start()
                timer.stop(step(state, wave, 1e-3, gen))
        size = os.path.getsize(os.path.join(tmp, "trace.json"))
    summary = timer.summary(items_per_step=BATCH)
    dev_ms, busy_ms, top = _device_ms(prof, 2)
    log(f"[ablations] (c) StepTimer over 2 traced flagship pretext steps: {summary}; trace.json "
        f"{size / 2 ** 20:.1f} MiB, kernels {dev_ms:.1f} ms a step, busy {busy_ms:.1f} ms, "
        f"longest {[(n, round(t, 1)) for n, t in top[:1]]} ({card})")
    assert len(timer.times) == 2 and size > 0 and dev_ms > 0
    del model, state, prof
    torch.cuda.empty_cache()


def phase_ablations(card):
    """The CRNN ablation encoders at the flagship input, with make_adam's
    AdamW and clipping: (a) training at batch 128, every kernel's launch
    count zeroed before and read after (no hand-written kernel is on this
    path: each must read 0); (b) card against CPU; (c) the ported utils.
    Returns (a)'s launch counts."""
    from sarssl_torch.kernels import reset_launches

    reset_launches()
    _ablation_train(card)
    counts = _kernel_counts()
    assert not counts, f"the CRNN arms launched hand-written kernels: {counts}"
    log("[ablations] (a) launches over the phase's training: none, as none of the CRNN arms "
        "runs a hand-written kernel")
    _ablation_card_vs_cpu()
    _ablation_utils(card)
    return counts


# mesh: the pretext step at the flagship width through the sharded step on a
# world of one rank (an NCCL group in this process), against the plain step
# from the same state and generator; then both CLIs with --mesh 1x1 beside
# their unmeshed runs: the pre-training run 1 epoch of 2 train and 1 val
# batches of 128, the downstream run one finetune cell epoch of 8 steps of 8
# (with 4 val batches) from the committed trained checkpoint
MESH_CLI_TRAIN_NUM, MESH_CLI_VAL_NUM = 256, 128
# each CLI call unmeshed, meshed, meshed, unmeshed: the first call of a shape
# also builds its cuDNN plans
MESH_CLI_ORDER = (("unmeshed", []), ("mesh 1x1", ["--mesh", "1x1"]),
                  ("mesh 1x1", ["--mesh", "1x1"]), ("unmeshed", []))


def _pretext_runs(state_of, steps, wave):
    """``steps`` pretext steps of the step ``state_of()`` builds from a fresh
    flagship state (seed 0) on one generator (seed 0): their losses and the
    parameters after."""
    model, state, step = state_of()
    gen = torch.Generator().manual_seed(0)
    losses = [step(state, wave, 1e-3, gen)["loss"].float().item() for _ in range(steps)]
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, params


def _mesh_step(card, train_ms):
    """(a) The flagship pretext step through ``make_sharded_pretrain_step``
    on a 1x1 mesh: equal to the plain step bit for bit (cuDNN deterministic
    for both); then 1 warm-up and 5 timed steps (launches exact, peak GiB),
    one profiled step (its NCCL kernels' device ms) and the all-reduce of a
    bucket of every parameter alone, timed by CUDA events. Returns the timed
    steps' counts."""
    import torch.distributed as dist

    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.kernels import launches, reset_launches
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.parallel import make_mesh, make_sharded_pretrain_step
    from sarssl_torch.train import create_train_state, make_pretrain_step

    assert not dist.is_initialized(), "a process group is already up"
    mesh = make_mesh(1, 1, device_type="cuda")
    cfg = SARSSLConfig(dtype="bfloat16", fused_attention=True)
    wave = torch.from_numpy(synth_batch(np.random.default_rng(0), BATCH, NSAMPLE)[0]).cuda()

    def plain():
        model = SARSSL(cfg, device="cuda", seed=0)
        return model, create_train_state(model), make_pretrain_step(model, FeatureConfig(),
                                                                    device="cuda")

    def sharded():
        model = SARSSL(cfg, device="cuda", seed=0)
        state = create_train_state(model)
        step, _, _ = make_sharded_pretrain_step(model, FeatureConfig(), mesh, state)
        return model, state, step

    n = 1 + STEPS
    torch.backends.cudnn.deterministic = True
    try:
        ref = _pretext_runs(plain, n, wave)
        got = _pretext_runs(sharded, n, wave)
    finally:
        torch.backends.cudnn.deterministic = False
    diff = max(float((got[1][k].float() - v.float()).abs().max()) for k, v in ref[1].items())
    same = got[0] == ref[0] and diff == 0.0
    if not same:  # the plain step against itself: what run-to-run order gives
        again = _pretext_runs(plain, n, wave)
        diff_plain = max(float((again[1][k].float() - v.float()).abs().max())
                         for k, v in ref[1].items())
        log(f"[mesh] (a) the sharded step differs from the plain step (max param diff "
            f"{diff:.3e}, losses {got[0]} / {ref[0]}); the plain step against itself: max "
            f"param diff {diff_plain:.3e}, losses {again[0]}")
        assert diff_plain > 0 and diff <= 2 * diff_plain, "the 1x1 sharded step is not the plain step"
    log(f"[mesh] (a) flagship pretext step (bf16, batch {BATCH}, fused attention) on a 1x1 "
        f"mesh (NCCL, world size {dist.get_world_size()}): {n} steps' losses and the "
        f"parameters after {'identical to the plain step bit for bit' if same else 'as above'}"
        f" (cuDNN deterministic for both runs); losses {got[0]}")
    del got, ref
    torch.cuda.empty_cache()

    model, state, step = sharded()
    gen = torch.Generator().manual_seed(0)
    step(state, wave, 1e-3, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step(state, wave, 1e-3, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = dict(launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for D in HEAD_DIMS:
        for kind in ("fwd", "bwd", "fwd_tc", "bwd_tc"):
            got = counts.get(f"attention_{kind}_d{D}", 0)
            assert got == LAYERS[D] * STEPS, f"mesh attention_{kind}_d{D}: {got} launches"
    want = PRETRAIN_DROPOUT_PER_STEP["train"] * STEPS
    assert counts.get("hash_dropout", 0) == want, (
        f"mesh: hash_dropout {counts.get('hash_dropout', 0)} launches, want {want}")
    _assert_no_conv_launch(counts, "sharded pretext")
    med = statistics.median(times)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(state, wave, 1e-3, gen)
        torch.cuda.synchronize()
    nccl = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and "nccl" in e.name.lower()]
    nccl_ms = sum(e.device_time_total for e in nccl) / 1e3
    dev_ms, busy_ms, _ = _device_ms(prof, 1)
    # one data rank sums no gradients: the 1x1 step is the plain step's body
    # with no gradient sync; the all-reduce that D > 1 adds, on a bucket of
    # every parameter, timed alone
    from sarssl_torch.parallel.steps import _prepare

    assert _prepare(model, mesh, state, sync=True)[2] is None, "a 1x1 step syncs gradients"
    numel = sum(p.numel() for p in model.parameters())
    bucket = torch.ones(numel, device="cuda")
    ar_ms = cuda_ms(lambda: dist.all_reduce(bucket, group=mesh.data_group))
    log(f"[mesh] (a) launches over {STEPS} sharded steps: {counts}")
    log(f"[mesh] (a) sharded step: median {1e3 * med:.1f} ms ({BATCH / med:.1f} utt/s) beside "
        f"phase train's plain step {train_ms:.1f} ms, peak {peak:.2f} GiB; one profiled step: "
        f"device {dev_ms:.1f} ms, busy {busy_ms:.1f} ms, NCCL kernels {len(nccl)} taking "
        f"{nccl_ms:.4f} ms ({', '.join(sorted({e.name[:40] for e in nccl})) or 'none seen'}); "
        f"no gradient bucket at one data rank; the all-reduce of a {numel}-f32 bucket "
        f"{ar_ms:.4f} ms by CUDA events ({card})")
    del model, state, step, bucket
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return counts, {"step_ms": 1e3 * med, "nccl_ms": nccl_ms, "allreduce_ms": ar_ms,
                    "peak_gib": peak}


def _mesh_clis(card):
    """(b) ``run_pretrain --mesh 1x1 --fused-attention`` (1 epoch: 2 train and
    1 val batches) and ``run_downstream --mesh 1x1`` (one finetune cell epoch
    from the committed trained checkpoint), each beside the same call
    unmeshed; every call's launches zeroed before and asserted after. Each
    meshed call joins and leaves its own group of one rank. Returns the
    meshed calls' summed counts."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from sarssl_torch.kernels import launches, reset_launches
    from sarssl_torch.train import checkpoint as ckpt

    total, rates = {}, {}
    with tempfile.TemporaryDirectory(prefix="mesh_cli_") as tmp:
        common = ["--pretrain", "--synthetic", "--fused-attention", "--bs", str(BATCH),
                  "--train-num", str(MESH_CLI_TRAIN_NUM), "--val-num", str(MESH_CLI_VAL_NUM),
                  "--epochs", "1"]
        train_steps = MESH_CLI_TRAIN_NUM // BATCH
        val_steps = MESH_CLI_VAL_NUM // BATCH
        for i, (tag, extra) in enumerate(MESH_CLI_ORDER):
            exp = os.path.join(tmp, f"pre{i}")
            reset_launches()
            out = _cli(common + extra + ["--exp-dir", exp])
            torch.cuda.synchronize()
            counts = dict(launches)
            assert not dist.is_initialized(), "the CLI left its process group up"
            assert "epoch 0:" in out, out
            for D in HEAD_DIMS:
                for kind, steps in (("fwd", train_steps + val_steps), ("bwd", train_steps)):
                    for name in (f"attention_{kind}_d{D}", f"attention_{kind}_tc_d{D}"):
                        assert counts.get(name, 0) == LAYERS[D] * steps, (tag, name, counts)
            want = PRETRAIN_DROPOUT_PER_STEP["train"] * train_steps
            assert counts.get("hash_dropout", 0) == want, (tag, counts)
            _assert_no_conv_launch(counts, "pre-training CLI " + tag)
            with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            train = [r for r in recs if r["split"] == "train"]
            rates.setdefault("pretrain " + tag, []).append(train[0]["utt_per_sec"])
            log(f"[mesh] (b) run_pretrain {tag}: train loss {train[0]['loss']:.5f}, epoch "
                f"{train[0]['utt_per_sec']:.1f} utt/s, launches {counts} ({card})")
            if extra:
                _add_counts(total, counts)

        pre = os.path.join(tmp, "pretrained")
        os.makedirs(pre)
        shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT, ckpt.best_path(pre))
        common = ["--ds-train", "--synthetic", "--ds-task", "TDOA", "--bs-set", str(DS_BATCH),
                  "--lr-set", "1e-3", "--ntrial", "1", "--epochs", "1", "--pretrain-ckpt", pre,
                  *DSCLI_NUMS]
        nbatch = int(DSCLI_NUMS[1]) // DS_BATCH
        for i, (tag, extra) in enumerate(MESH_CLI_ORDER):
            exp = os.path.join(tmp, f"ds{i}")
            spent = {"cell_epoch": []}
            out, counts, learners, wall = _ds_cli_run(f"mesh (b) run_downstream {tag}",
                                                      common + extra + ["--exp-dir", exp],
                                                      spent, card)
            assert not dist.is_initialized(), "the CLI left its process group up"
            _check_ds_launches(tag, counts, _ds_train_steps(learners, nbatch), "finetune")
            res = _read_results(exp)
            rates.setdefault("downstream " + tag, []).append(spent["cell_epoch"][0])
            log(f"[mesh] (b) run_downstream {tag}: {spent['cell_epoch'][0]:.3f} s a cell epoch "
                f"({nbatch} steps of {DS_BATCH}, then {int(DSCLI_NUMS[3]) // DS_BATCH} val "
                f"batches and the checkpoint), test MAE {res['best_test_mae']:.5f}, wall "
                f"{wall:.2f} s ({card})")
            if extra:
                _add_counts(total, counts)
    log(f"[mesh] (b) meshed against unmeshed, in the order unmeshed, meshed, meshed, "
        f"unmeshed: pre-training epoch utt/s {rates['pretrain mesh 1x1']} / "
        f"{rates['pretrain unmeshed']}, downstream s a cell epoch "
        f"{rates['downstream mesh 1x1']} / {rates['downstream unmeshed']} ({card})")
    return total, rates


def phase_mesh(card, train_ms):
    """The multi-device path on one card: (a) the sharded pretext step at
    world size 1, (b) both CLIs with ``--mesh 1x1``, (c) the index-mapped
    kernels of a tensor-parallel rank. Returns the launch counts of (a) and
    (b) and the times of (a) and (c)."""
    counts, step = _mesh_step(card, train_ms)
    cli_counts, rates = _mesh_clis(card)
    _add_counts(counts, cli_counts)
    att, drop = check_index_maps()
    return counts, {"step": step, "rates": rates, "attention": att, "dropout": drop}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    import sarssl_torch  # noqa: F401  (fails outside a checkout of the repo)

    spent = {}

    def timed(name, fn, *args):
        """fn(*args), its wall seconds kept under the phase's name."""
        t0 = time.perf_counter()
        res = fn(*args)
        spent[name] = time.perf_counter() - t0
        return res

    card = timed("card", phase_card)
    timed("build", phase_build)
    rows, opt_rows, wide, drop, lanes, conv = timed("kernels", phase_kernels)
    edges = timed("edges", phase_edges)
    tiny_counts, d256_counts, d320_counts = timed("ref", phase_reference)
    counts, pretrained, step_utt_s = timed("train", phase_train, card)
    cli_counts, synthetic_utt_s = timed("pretrain_cli", phase_pretrain_cli, card, step_utt_s)
    opt_counts = timed("pretrain_options", phase_pretrain_options, card,
                       1e3 * BATCH / step_utt_s)
    timed("trained", phase_trained, card)
    ds_counts = timed("downstream", phase_downstream, card, pretrained)
    timed("downstream_ref", phase_downstream_reference)
    dscli_counts = timed("downstream_cli", phase_downstream_cli, card)
    grid_counts = timed("grid_vmap", phase_grid_vmap, card)
    data_counts = timed("data_path", phase_data_path, card, synthetic_utt_s)
    real_counts = timed("real_data", phase_real_data, card, step_utt_s)
    timed("model_options_ref", phase_model_options_reference)
    mo_counts, mo_shapes = timed("model_options", phase_model_options, card)
    abl_counts = timed("ablations", phase_ablations, card)
    mesh_counts, mesh = timed("mesh", phase_mesh, card, 1e3 * BATCH / step_utt_s)
    # where the run's wall time went, for cutting a phase's depth as the
    # script grows inside its time limit
    log("[timing] wall s by phase: " + ", ".join(f"{n} {t:.1f}" for n, t in spent.items())
        + f"; total {sum(spent.values()):.1f}")
    # fused_attention never reaches the FMA kernels: only phase kernels'
    # yardsticks launch them, directly
    for phase, c in (("ref", tiny_counts), ("ref", d256_counts), ("ref", d320_counts),
                     ("train", counts),
                     ("pretrain_cli", cli_counts),
                     ("pretrain_options", opt_counts), ("downstream", ds_counts),
                     ("downstream_cli", dscli_counts), ("grid_vmap", grid_counts),
                     ("data_path", data_counts), ("real_data", real_counts),
                     ("model_options", mo_counts), ("ablations", abl_counts),
                     ("mesh", mesh_counts)):
        assert not _fma_launches(c), f"phase {phase} launched the FMA kernels: {_fma_launches(c)}"
    log("[kernels] the FMA attention kernels' launches in every model phase: 0")
    print(json.dumps(kernels_line(rows, opt_rows, wide, drop, lanes, conv, counts, ds_counts,
                                  cli_counts, opt_counts, dscli_counts, data_counts, real_counts,
                                  mo_counts, mo_shapes, grid_counts, abl_counts, mesh_counts,
                                  mesh, tiny_counts, d256_counts, d320_counts, edges)),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
