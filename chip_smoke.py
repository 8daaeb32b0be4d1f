#!/usr/bin/env python3
"""Drive the PyTorch port of the OD-VAE detector and its train step on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure raises and exits non-zero, before the result line):

1. device: the card's name, the device count, nvidia-smi's name and power limit;
2. build: nvcc builds every kernel under generative_detection_tpu_torch/csrc
   (one process per source, all started together); the bf16 attention
   kernels (B1 and the flash variant B5, and the backward B2 at every width),
   the fp32 split-precision attention
   forward (B1 and B5 in fp32 at C <= 256 and at C = 512), the fused
   GroupNorm+SiLU+conv (B6), the row-Winograd forward (B7) and the weight
   gradient (B8), each in bf16 and in fp32 on split precision, and the fp32
   split-precision attention backward (B2 in fp32 at C <= 256 and at C =
   512) must hold wgmma (HGMMA) and TMA (UTMALDG) instructions in their
   SASS (cuobjdump), B6-B8, the split-precision kernels and every kernel of
   attention_bwd.cu no mma.sync (HMMA), none of the wgmma kernels may
   spill, ptxas may not serialize the wgmma of the split-precision kernels
   and of the bf16 C = 512 backward, and no built library may hold an FMA
   fp32 kernel that split precision replaced (attn_fwd_f32_kernel,
   wgrad_f32_kernel, conv3x3_f32_kernel);
3. sites: forward hooks count the GroupNorm, attention and fused-conv sites
   of the train step (default and GDT_WINOGRAD=fused) and of the detector
   (default and GDT_FUSE_INFERENCE=1);
4. kernels, each against its plain PyTorch version on the card, with its
   time, the plain version's, one library call's (a yardstick the port never
   calls) and the card's bound (for B7 and B8 the products the Winograd
   form does, half the direct conv's at F(4,3); the fp32 B6, B7 and B8
   count the split route's six bf16 piece products, beside the CUDA cores'
   bound): the forward kernels at the flagship
   detector's shapes (batch 8), the backward kernels at every shape of the
   flagship train step (batch 16; the GroupNorm backward with a bit-equal
   repeat and its share of the bound), the fused GroupNorm+SiLU+conv (B6) at
   every fused detector site and at W = 96 (batch 8, with a bit-equal
   repeat), the row-Winograd forward, dgrad and
   weight gradient (B7, B8) at every fused train site (batch 16, each with a
   bit-equal repeat, and their sums over a fused step's sites), the
   forward-only flash attention (B5) at the detector's attention shapes, and
   the attention forward and backward at L = 16384 (B9's length) and at
   (2, 256, 64) and the backward at (2, 256, 128) (the tiny configs' width and
   the width C = 65..128 pads to), and the
   forward, flash forward and backward at shapes off the kernels' grid
   ((1, 576, 512), (2, 400, 512), (2, 256, 96): padded, masked, sliced), in
   bf16 and fp32; the attention bounds count the products each route runs
   (fp32: six bf16 piece products for each of S and P V and for each of the
   backward's five products). The kernel phase sets
   TF32 off for its library calls and restores PyTorch's defaults after it;
   then long_attention: B1 and B2 at (1, 65536, 256) (a 1024^2 input's
   level-2 attention), fp32 on the split-precision kernels and bf16, held
   against a float64 reference formed on the card 2048 query rows at a time
   (O, dQ, dK, dV within 1e-3 x RMS in fp32, 0.1 in bf16), timed beside
   SDPA;
5. detector: the flagship config (configs/autoencoder/pose/
   autoencoder_kl_16x16x16.yaml) at full width with seeded random weights
   serves requests at batch 1, 8 and 32 in bf16, first as it is, then with
   GDT_FUSE_INFERENCE=1; the launch counters must show the hook-counted
   sites per request (28 GroupNorm and 3 attention launches, or 4 GroupNorm,
   24 fused convs and their 24 affines). Then the same weights and inputs at
   batch 2 in fp32 on the card and on the CPU (which runs the plain
   versions) must agree, in both settings. Then the flagship as its config
   ships it, in fp32: the detector at batch 8 and 32 (p50, peak memory, the
   split-precision attention launches per request). Every fp32 phase runs
   with PyTorch's default TF32 flags (cuDNN's on), so the port's own
   ops.precision.ieee_fp32() is what keeps it fp32; no flagship phase may
   pad an attention call (pad_copies 0);
6. train: the flagship train step at full width and depth, batch 16, bf16
   compute with fp32 master weights, past the whole curriculum (pixel,
   LPIPS, KL, pose and GAN terms and d_weight live): 3 warm-up and 10 timed
   steps, as it is and with GDT_WINOGRAD=fused; the launch counters must
   show one forward and one backward per site per step (with fused, one
   Winograd forward, dgrad and weight gradient per in-band site), every
   network parameter a finite nonzero gradient, LPIPS and logvar unchanged
   and the discriminator moved; then the config's own fp32 step (3 warm-up
   and 5 timed steps), whose seven attention sites all run the
   split-precision forward and backward (two at C = 512), as it is and with
   GDT_WINOGRAD=fused (the fp32 B7 forward at every fused site, its dgrad
   and B8 where the tile rules take them at 4-byte items);
7. train, card against CPU: one step of tiny_cpu.yaml at ch 128 in fp32 with
   the same weights and draws on both, as it is and with GDT_WINOGRAD=fused,
   then at the config's own ch 32 (attention at (2, 256, 64), GroupNorm at
   C = 32 and 64) with GDT_WINOGRAD unset; losses, d_weight and both
   optimizers' Adam first moments must agree. The fp32 fused detector
   (B6) and the fused fp32 step (B7, B8) give the fp32 kernels' launches
   in the kernels line;
8. fit_synthetic_smoke: the port's training entry point,
   generative_detection_tpu_torch.train_cli, driven in-process with
   configs/autoencoder/pose/synthetic_smoke.yaml as shipped (the flagship at
   full width on synthetic 256x256 patches, batch 4, the config's own fp32,
   a -l logdir in a temporary directory): run 1 is -t with the config's 12
   steps over two epochs (past encoder_pretrain_steps 4 and disc_start 4,
   counted in optimizer steps; two validations of 2 batches, the image
   logger, last and best checkpoints; no test split), run 2 is -r LOGDIR
   -t --max_steps 16 and must resume at step 12 and end at 16. Over run 1 the
   GroupNorm forward and backward and the split-precision attention forward
   and backward (narrow and C = 512) must each have launched, with no pad
   copy; every logged value is finite, the loss JSONL has one line per step,
   the checkpoint directories hold the layout's files, the resumed state's
   first parameter and its Adam first moment equal the saved ones bit for
   bit, and no loader thread outlives either fit. The phase prints the
   Trainer's step p50 over steps 5-12 beside the bare make_train_step's p50
   on one prepared batch of the same size and dtype, the fit's wall time by
   part (steps, validation, image logging, checkpoint saves), the
   checkpoint bytes and save seconds, and the peak memory; it deletes its
   directory at the end;
9. device_preprocess_and_eval, the nuScenes slice's entry points: (a) a
   seeded raw-crop batch at the flagship's shape (batch 16, the nuScenes
   reader's 400x400 uint8 buffers, crops of 50-400 px and one shrunk
   close-up, mask rectangles past the crop on either side, output 256)
   through prepare_batch on the card and on the CPU: masks bit-equal,
   rgb_gt within 1e-5; the p50 over 20 batches of a batch's pinned
   host-to-card copy plus crop-resize, mask and rescale (and of the float
   contract's copy and rescale), the bytes each contract moves, beside the
   bf16 and fp32 step p50s of phase 6 and the fit's of phase 8; (b) train_cli
   with synthetic_smoke.yaml and device_preprocess true for 8 steps: every
   batch takes the raw branch, the fp32 fit's kernels launch, every logged
   value is finite, its step p50 over steps 5-8; (c) eval_cli -r <that run>
   --limit 2 --out <json> in each image contract: finite metrics whose keys
   are eval.py's, the forward's kernels launched, patches/s and wall time;
   (d) where PIL is installed, a fixture nuScenes tree of 1600x900 JPEGs and
   3 steps of train_cli on it through the port's NuScenesTrain and
   NuScenesValidation in each contract (the reader's frame route is
   printed: the native libjpeg region decoder where libjpeg's header is
   installed, else PIL's whole-frame decode); the phase deletes its
   directories;
10. export_and_interop, the serving export and reference checkpoints: (a)
   three batch-polymorphic artifacts of the flagship detector
   (export_detector with batch=None: bf16, bf16 with GDT_FUSE_INFERENCE=1,
   fp32), each exported, loaded (load_detector) and run at batch 1, 8 and
   32 beside the live make_detector_fn, a request of each in turn: outputs
   held against the live ones (fp32: boxes 1e-3, equal classes, scores
   1e-5; bf16: equal classes, box sizes, yaw and scores within 3e-2 / 5e-2,
   centres finite), the launches a request equal to the live path's (28
   GroupNorm and 3 attention; fused 4 GroupNorm, 24 B6 and their affines;
   fp32 also the split-precision attention), export and load seconds, blob
   bytes, p50s side by side, and the detector phase's bf16 p50s beside
   them; the fp32 artifact also against the CPU's plain detector under
   PyTorch's default TF32 flags (it must run IEEE); (b) the flagship's
   weights written as a reference .ckpt (export_pose_autoencoder,
   save_torch_checkpoint) and a second model built through ckpt_path with
   ignore_keys ["pose_encoder"]: every tensor bit-equal, the ignored ones
   its own init. The gdt operators' dispatch cost alone is measured by
   tools/op_dispatch_cost.py;
11. plain_autoencoder, the plain KL autoencoder family (Autoencoder,
   LPIPSWithDiscriminator, the plain steps) built from
   configs/autoencoder/plain_kl_tiny.yaml with the flagship's ddconfig and
   embed_dim (disc_start 0, bf16 compute), 256x256 inputs, batch 16: 2
   warm-up + 10 timed bf16 steps, 1 + 5 fp32 steps, one GDT_WINOGRAD=fused
   bf16 step, each step's launches equal to the hook-counted sites (B7 and
   B8 where the tile rules take them), the eval step, and predict through
   the Trainer under GDT_FUSE_INFERENCE=1 (B6 at every fused site); then
   plain_kl_tiny.yaml as shipped for 3 steps on the card and on the CPU
   from one seed, batches and posterior draws (losses, d_weight, Adam first
   moments as in phase 7), and train_cli with it on the card (--device cuda
   over the config's accelerator: cpu), a resume, export_torch_ckpt and
   ckpt_path (bit-equal to the run); then plain_fused_fp32_512: one fp32
   GDT_WINOGRAD=fused step at 512x512, batch 2: its peak memory and the
   largest B8 split-K partial buffer;
12. parallel, data parallelism on the one card (parallel/, the Trainer's
   devices and zero1_optimizer_sharding, shard_detector): (a) train_cli over
   synthetic_smoke.yaml at the flagship width, batch 16, bf16, 3 steps (the
   curriculum off, so d_weight is live from step 2), once joined to a
   process group of one rank over NCCL (RANK=0 WORLD_SIZE=1 MASTER_ADDR and
   a free port) and once with no group, cuDNN deterministic in both: losses
   within 1e-3 relative, and whether losses and weights are bit-equal; (b)
   two ranks on the card over gloo (NCCL refuses two ranks on one device;
   each rank is this script with --parallel-rank), each at batch 8 of the
   same model's bf16 step, 3 steps with ZeRO-1 off and on: both ranks' losses
   equal, the first step's losses within 1e-3 and d_weight within 3e-2
   relative of one process at batch 16 with the same batch and draws (the
   later steps, rec_loss, g_loss and one process with the ranks' batch-norm
   arithmetic printed beside them: Adam's first update, bf16 rounding),
   ZeRO-1 against unsharded within 1e-6 relative in weights and Adam
   moments, each rank's peak memory, the step
   times (not a multi-GPU figure: gloo stages through the host and both
   ranks share one card), a collective save restored into the one process
   (step, weights, each rank's shard of the moments), then one
   GDT_WINOGRAD=fused step (B7, B8); then FSDP (fsdp_parameter_sharding:
   the parameters of the net, LPIPS and the discriminator sharded) from the
   same weights, draws and batch: 3 steps whose first losses are the
   unsharded ranks' within 1e-6, weights after step 1 within 2.05 lr, and
   each optimizer's step-1 gradient before the clip (from its consolidated
   moments) within 1e-5 of its largest (the discriminator's 5e-2: its two
   forwards sum in bf16 unsharded, in float32 under FSDP) and its norm
   within 1e-3, the
   same launches, each rank's bytes at rest of parameters, gradients and
   moments (unsharded, ZeRO-1, FSDP) beside its peak, a collective FSDP save
   restored exactly into the one process, and one GDT_WINOGRAD=fused FSDP
   step (B7, B8 at their sites); (a) also runs the CLI with FSDP in the
   world of one, bit-equal to no group; (c) shard_detector: the bf16
   artifacts of phase 10 (plain and GDT_FUSE_INFERENCE=1) as two replicas on cuda:0 at
   batch 32: bit-equal to load_detector on each replica's half, within the
   bf16 limits of the whole batch (and whether bit-equal), twice one
   replica's launches a request, p50s beside load_detector's;
13. one {"kernels": [...]} line, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Every phase that sets a switch restores the environment after it.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import json
import math
import os
import pickle
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.models.autoencoder import cast_compute_dtype
from generative_detection_tpu_torch.models.blocks import (
    AttnBlock, Conv3x3, GroupNormSiLU, flax_like_init_,
)
from generative_detection_tpu_torch.models.discriminator import BatchStatsNorm
from generative_detection_tpu_torch.ops import _build, attention, conv3x3, fused_conv, norm
from generative_detection_tpu_torch.ops import winograd_rows as wr
from generative_detection_tpu_torch import eval_cli, export_torch_ckpt, train_cli
from generative_detection_tpu_torch.data.synthetic import raw_crop_batch
from generative_detection_tpu_torch.models import autoencoder as port_autoencoder
from generative_detection_tpu_torch.data.datamodule import THREAD_NAME, collate
from generative_detection_tpu_torch.parallel import fsdp, mesh, multihost
from generative_detection_tpu_torch.serving import (
    export_detector, load_detector, make_detector_fn, shard_detector,
)
from generative_detection_tpu_torch.utils.torch_compat import (
    export_pose_autoencoder, save_torch_checkpoint,
)
from generative_detection_tpu_torch.train import (
    CheckpointManager, Trainer, create_train_state, make_optimizers, make_plain_eval_step,
    make_plain_train_step, make_train_step,
)
from generative_detection_tpu_torch.train.callbacks import Callback
from generative_detection_tpu_torch.train.state import TrainState, shard_for_fsdp

REPO = Path(__file__).resolve().parent
# The weight-gradient kernel's flop count and design bytes, from its A/B tool
_spec = importlib.util.spec_from_file_location("ab_wgrad", REPO / "tools/ab_wgrad_kernel.py")
ab_wgrad = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ab_wgrad)
FLAGSHIP = REPO / "configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml"
TINY = REPO / "configs/autoencoder/pose/tiny_cpu.yaml"
SMOKE = REPO / "configs/autoencoder/pose/synthetic_smoke.yaml"
PLAIN = REPO / "configs/autoencoder/plain_kl_tiny.yaml"
# synthetic_smoke.yaml's run: 12 steps of batch 4 over two epochs of 8
# batches; the resume takes it to 16. Step p50 over steps 5-12 (all 'full').
FIT_STEPS, FIT_RESUME_STEPS, FIT_TIMED = 12, 16, slice(4, 12)
BARE_WARMUP, BARE_STEPS = 2, 8
# the kernels an fp32 fit of the flagship runs (synthetic_smoke.yaml's dtype)
FIT_KERNELS = ("group_norm", "group_norm_bwd", "attention_split", "attention_split_512",
               "attention_split_bwd", "attention_split_bwd_512")
# device_preprocess_and_eval: the raw-crop batch at the flagship's shape (the
# nuScenes reader's 400x400 uint8 buffers, batch 16, output 256), timed over
# RAW_REPEATS batches; the card's rgb_gt within RAW_RGB_TOL of the CPU's; the
# device_preprocess fit of synthetic_smoke.yaml to FIT_RAW_STEPS (step p50
# over steps 5-8, all 'full'); the eval CLI's batches; the fixture nuScenes
# fits' steps
RAW_BATCH, RAW_BUFFER, RAW_OUT, RAW_WARMUP, RAW_REPEATS = 16, 400, 256, 2, 20
RAW_RGB_TOL = 1e-5
FIT_RAW_STEPS, FIT_RAW_TIMED = 8, slice(4, 8)
EVAL_LIMIT = 2
NUSC_STEPS, NUSC_SAMPLES = 3, 4
DEVICE_PREPROCESS = ("data.params.train.params.device_preprocess=true",
                     "data.params.validation.params.device_preprocess=true")
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: CUDA cores
BATCH = 8
# The encoder's 28 GroupNorm sites of the flagship forward, by (h=w, C, act).
GN_SITES = {
    (256, 128, "silu"): 4, (128, 128, "silu"): 4, (64, 128, "silu"): 1,
    (64, 256, "silu"): 3, (64, 256, None): 2, (32, 256, "silu"): 4,
    (16, 256, "silu"): 1, (16, 512, "silu"): 8, (16, 512, None): 1,
}
# Its 3 attention sites, by (L, C): level 2 twice, the mid block once.
ATTN_SITES = {(4096, 256): 2, (256, 512): 1}
GN_PER_FORWARD, ATTN_PER_FORWARD = sum(GN_SITES.values()), sum(ATTN_SITES.values())

# Tolerances, kernel against plain version on the same inputs.
# GroupNorm, |err| <= atol + rtol * |plain| on outputs of size ~1:
# - fp32: the same fp32 arithmetic in another summation order;
# - bf16: both round an fp32 result to bf16 (one ulp is 2^-8 relative) from
#   values that differ in the last bits.
GN_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 8e-3)}
# Attention, max |err| <= tol * RMS(plain): with N(0, 1) inputs a row's
# softmax spreads over about L/e keys, so the output's RMS is about
# sqrt(e / L) (0.026 at L=4096, 0.10 at L=256) and an absolute limit would
# hide a dropped or mis-weighted K/V tile. bf16 also rounds P to bf16 against
# a running rather than the final row max; fp32 differs in summation order.
ATTN_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}
LSE_TOL = 1e-3  # fp32 row statistics from the same logits
# Card against CPU, fp32 detector: fp32 on both sides with TF32 off; the box
# centre amplifies pose differences by up to 1 / (1 - fill factor).
BOX_TOL = dict(rtol=1e-3, atol=1e-3)
# Backward kernels against their plain versions. GroupNorm dx:
# |err| <= tol * RMS(plain) + rtol * |plain| (bf16: two roundings of fp32
# values that differ in the last bits sit up to one bf16 ulp, 2^-7 relative,
# apart); dgamma/dbeta: fp32 sums in another order, 1e-4 of their largest
# magnitude. Attention dq, dk, dv: the forward's RMS rule, per output.
GN_BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 8e-3)}
# The train step, batch 16 (bench.py's default for the JAX step), past the
# flagship curriculum: 30000 pretrain + 45000 pose-conditioned + 45000
# dropout warm-up global steps; optimizer step counting sees 2 * batch.
TRAIN_BATCH = 16
CURRICULUM_END = 30000 + 45000 + 45000
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
TRAIN_STEPS_FP32 = 5  # the config's own fp32 step: slower, fewer timed steps
# Card against CPU, tiny fp32 train step (TF32 off): losses and d_weight
# relative; Adam first moments (the clipped gradients) within 1e-3 of each
# optimizer's largest, since the composite loss is ~1e6 and summation noise
# scales with the global gradient, not with each parameter's.
TRAIN_LOSS_RTOL, MOMENT_REL = 1e-3, 1e-3
# Conv kernels (B6-B8) and the flash variant (B5) against their plain
# versions: max |err| <= tol * RMS(plain). fp32 differs in summation order;
# bf16 rounds the same fp32 values to bf16, and the prologue's activation
# (v / (1 + e^-v) in the kernels, v * sigmoid(v) in the plain versions) can
# round one bf16 ulp apart.
CONV_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}
TINY_GN_ROWS = ((16, 32), (32, 32), (16, 64))  # tiny_cpu.yaml's GroupNorm rows (h=w, C)
# Attention off the kernels' grid (padded, masked, sliced back): a 384^2
# pose config's mid block, a 320^2 plain autoencoder's lowest level, C = 96
OFF_GRID_ATTN = ((1, 576, 512), (2, 400, 512), (2, 256, 96))
LONG_L = 16384  # B9: L * C * 4 = 16 MiB > 8 MiB at C = 256 (attention.py:394)
# long_attention: a 1024^2 input's level-2 attention, L * C * 4 = 64 MiB (B9's
# route in the JAX package), against a float64 reference formed on the card
# LONG_ROWS query rows at a time (the whole L x L float64 matrix is 34 GB)
LONG_ATTN = (1, 65536, 256)
LONG_ROWS = 2048
# ... and the peak memory of one fp32 GDT_WINOGRAD=fused step of the plain
# family at the flagship backbone's width, 512^2 input, batch 2
BIG_PLAIN_SIZE, BIG_PLAIN_BATCH = 512, 2
# The kernels on wgmma and TMA (their names carry WGMMA_TAG): attention (B1
# and the flash variant B5 in bf16, B1 and B5 in fp32 on split precision, B2
# in bf16 at every width (dK/dV and dQ at C = 64, 128, 256, the role kernel
# at C = 512) and in fp32 on split precision; the split kernels at
# C <= 256 and at C = 512), the fused GroupNorm+SiLU+conv (B6: four accumulators of 1, 2
# or 4 image rows, with and without emit_z), the row-Winograd forward (B7)
# and weight gradient (B8), each at M = 2, 4 x GN off, on; in fp32 B6, B7 and
# B8 on split precision (B6: 1, 2 or 4 image rows an accumulator, with and
# without emit_z; B7, B8: M = 2, 4 x GN off, on). B6-B8, the split-precision
# kernels and attention_bwd.cu have no mma.sync (HMMA).
WGMMA_TAG = "_wgmma_kernel"
SPLIT_KERNEL = "attn_fwd_split_wgmma_kernel"
SPLIT_512_KERNEL = "attn_fwd_split512_wgmma_kernel"
SPLIT_BWD_KERNEL = "attn_bwd_split_wgmma_kernel"
SPLIT_BWD_512_KERNEL = "attn_bwd_split512_wgmma_kernel"
BWD_512_KERNEL = "attn_bwd_c512_wgmma_kernel"  # bf16 at C = 512: dK, dQ and dV in one launch
BWD_NARROW = (64, 128, 256)  # the widths of the bf16 dK/dV and dQ kernels' C template
_BWD = tuple(f"attn_bwd_{k}_wgmma_kernelILi{c}E" for k in ("dkdv", "dq")
             for c in BWD_NARROW) + (BWD_512_KERNEL,)
_WINO = tuple(f"{k}ILi{m}ELb{gn}" for k in ("wino_rows_wgmma_kernel", "wgrad_wgmma_kernel")
              for m in (2, 4) for gn in (0, 1))
_B6 = tuple(f"fused_conv_wgmma_kernelILi4ELi{pk}ELb{z}" for pk in (1, 2, 4) for z in (0, 1))
B6_SPLIT_KERNEL = "fused_conv_split_wgmma_kernel"
B7_SPLIT_KERNEL = "wino_rows_split_wgmma_kernel"
B8_SPLIT_KERNEL = "wgrad_split_wgmma_kernel"
_CONV_SPLIT = tuple(f"{B6_SPLIT_KERNEL}ILi{pk}ELb{z}" for pk in (1, 2, 4) for z in (0, 1)) + tuple(
    f"{k}ILi{m}ELb{gn}" for k in (B7_SPLIT_KERNEL, B8_SPLIT_KERNEL) for m in (2, 4)
    for gn in (0, 1))
_ATTN_FWD = tuple(f"attn_fwd_wgmma_kernelILi{c}ELb{flash}" for c in (64, 128, 256, 512)
                  for flash in (0, 1))
SPLIT_NARROW = (64, 128, 256)  # the widths of the split kernels' C template
_SPLIT = tuple(f"{SPLIT_KERNEL}ILi{c}ELb{lse}" for c in SPLIT_NARROW for lse in (0, 1)) + tuple(
    f"{SPLIT_512_KERNEL}ILb{lse}" for lse in (0, 1))
_SPLIT_BWD = tuple(f"{SPLIT_BWD_KERNEL}ILi{c}E" for c in SPLIT_NARROW) + (SPLIT_BWD_512_KERNEL,)
SPLIT_KERNELS = (SPLIT_KERNEL, SPLIT_512_KERNEL, SPLIT_BWD_KERNEL, SPLIT_BWD_512_KERNEL,
                 B6_SPLIT_KERNEL, B7_SPLIT_KERNEL, B8_SPLIT_KERNEL)
WGMMA_KERNELS = _ATTN_FWD + _SPLIT + _BWD + _SPLIT_BWD + _B6 + _WINO + _CONV_SPLIT
# the FMA fp32 kernels that the split-precision ones replaced: no built
# library may hold one
FMA_GONE = ("attn_fwd_f32_kernel", "wgrad_f32_kernel", "conv3x3_f32_kernel")
# kernels whose wgmma chains ptxas may not serialize (C7520, C7512)
NO_SERIAL = SPLIT_KERNELS + (BWD_512_KERNEL,)
NO_HMMA = ("fused_conv", "wino", "wgrad", "split")  # wgmma kernels with no mma.sync
# The device kernel behind each conv entry of the kernels line, by dtype
CONV_KERNELS = {
    "fused_conv": {torch.bfloat16: "fused_conv_wgmma_kernel",
                   torch.float32: f"split_weights_kernel + {B6_SPLIT_KERNEL}"},
    "wino_rows": {torch.bfloat16: "wino_rows_wgmma_kernel",
                  torch.float32: f"split_weights_kernel + {B7_SPLIT_KERNEL}"},
    "wino_rows_dgrad": {torch.bfloat16: "wino_rows_wgmma_kernel",
                        torch.float32: f"split_weights_kernel + {B7_SPLIT_KERNEL}"},
    "wino_wgrad": {torch.bfloat16: "wgrad_wgmma_kernel + fold_kernel",
                   torch.float32: f"{B8_SPLIT_KERNEL} + fold_kernel"},
}
SPLIT_CONV_PRODUCTS = 6  # bf16 piece products of an fp32 conv product on split precision


# Every launch counter of the port, by the name the kernels line uses.
COUNTED = {
    "group_norm": norm.group_norm, "group_norm_bwd": norm.group_norm_backward,
    "group_norm_affine": norm.group_norm_affine,
    "attention": attention.single_head_attention, "attention_bwd": attention.attention_backward,
    "flash_attention": attention.flash_attention_forward, "fused_conv": fused_conv.gn_silu_conv,
    "attention_split": attention.split_precision,
    "attention_split_512": attention.split_precision_512,
    "attention_split_bwd": attention.split_backward,
    "attention_split_bwd_512": attention.split_backward_512,
    "attention_bwd_512": attention.backward_512,
    "wino_rows": wr.wino_rows_forward, "wino_rows_dgrad": wr.wino_rows_dgrad,
    "wino_wgrad": wr.wino_wgrad,
}


@contextlib.contextmanager
def switches(**env):
    """Set (or, with None, unset) the JAX package's switches (GDT_*) for one
    phase, then restore."""
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():  # None: unset
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    require(not bool(bad.any()), f"{name}: {int(bad.sum())} elements outside tolerance, "
            f"max err {err.max().item()}")
    return err.max().item()


def phase_device() -> tuple[str, str]:
    require(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def _sass_counts(name: str) -> dict:
    """Per kernel of the built ``csrc/<name>.cu``: the wgmma (HGMMA), TMA
    load (UTMALDG) and mma.sync (HMMA) instructions in its SASS, from
    ``cuobjdump -sass``."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target(name))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, kernel = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            kernel = ln.split("Function :")[-1].strip()
            counts[kernel] = {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0}
        elif kernel is not None:
            for op in counts[kernel]:
                counts[kernel][op] += f" {op}." in ln or f" {op} " in ln
    return counts


def phase_build() -> None:
    t0 = time.perf_counter()
    times = _build.build()
    wall = time.perf_counter() - t0
    spills = []  # (kernel, ptxas line) for every kernel that spills
    ptxas = {}  # the wgmma kernels' ptxas register and spill lines
    warnings = []
    for n in _build.SOURCES:
        kernel = None
        for ln in _build.build_log(n).splitlines():
            if "Function properties for" in ln:
                kernel = ln.split("Function properties for")[-1].strip()
            elif "spill" in ln and not ln.strip().startswith("0 bytes"):
                spills.append([n, kernel, ln.strip()])
            if kernel and WGMMA_TAG in kernel and ("spill" in ln or "Used" in ln):
                ptxas.setdefault(kernel, []).append(ln.strip())
            elif "(C7" in ln:  # ptxas performance warnings (serialized wgmma, setmaxnreg)
                warnings.append(ln.strip())
    # the bf16 attention kernels (B1 at C = 64, 128, 256, 512; B2 at C = 64,
    # 128, 256 and 512), the fp32 split-precision attention forward and backward
    # (C = 64, 128, 256 and 512), B6, B7 and B8 (in bf16 and in fp32) must run
    # on wgmma and TMA, and must not spill; B6-B8 and every kernel of
    # attention_bwd.cu have no mma.sync left; no library holds a replaced
    # FMA kernel
    sass, fma, bwd_hmma = {}, [], {}
    for n in _build.SOURCES:
        counts = _sass_counts(n)
        sass.update({k: v for k, v in counts.items() if WGMMA_TAG in k})
        fma += [f"{n}: {k}" for k in counts if any(f in k for f in FMA_GONE)]
        if n == "attention_bwd":
            bwd_hmma = {k: v["HMMA"] for k, v in counts.items()}
    emit({"phase": "build", "wall_s": wall, "per_source_s": times, "spills": spills,
          "wgmma_kernels_sass": sass, "wgmma_kernels_ptxas": ptxas, "ptxas_warnings": warnings,
          "attention_bwd_hmma": sum(bwd_hmma.values())})
    require(len(sass) == len(WGMMA_KERNELS) and all(
        any(name in k for k in sass) for name in WGMMA_KERNELS),
        f"wgmma kernels in the SASS: {sorted(sass)}")
    for k, ops in sass.items():
        require(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0, f"{k}: no HGMMA or UTMALDG ({ops})")
        require(not any(w in k for w in NO_HMMA) or ops["HMMA"] == 0,
                f"{k}: mma.sync left ({ops})")
    require(bwd_hmma and not any(bwd_hmma.values()), f"attention_bwd.cu holds mma.sync: {bwd_hmma}")
    require(not [sp for sp in spills if WGMMA_TAG in (sp[1] or "")],
            f"wgmma kernels spill: {spills}")
    require(not [sp for sp in spills if "gn_" in (sp[1] or "") and "gn_bwd" not in sp[1]],
            f"the GroupNorm forward kernels spill: {spills}")
    require(not [w for w in warnings if ("C7520" in w or "C7512" in w)
                 and any(k in w for k in NO_SERIAL)],
            f"ptxas serializes the wgmma of {NO_SERIAL}: {warnings}")
    require(not fma, f"FMA fp32 kernels that split precision replaced are still built: {fma}")


def _gn_route(x) -> dict:
    """The forward's route for ``x`` (``norm.forward_route``) as the kernels
    line names it: the resident kernel (one launch) or the two passes."""
    r = norm._route_of(x, 32)
    if r.kind == "resident":
        return {"route": "resident", "kernel": "gn_fwd_resident_kernel", "kernels_per_call": 1,
                "tiles": r.tiles, "grid": r.grid}
    return {"route": "two_pass", "kernel": "gn_stats_kernel + gn_apply_kernel",
            "kernels_per_call": 2}


def gn_case(g, hw, c, act, dtype, b=BATCH):
    x = (torch.randn(b, hw, hw, c, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    beta = 0.1 * torch.randn(c, device="cuda", generator=g)
    got = norm.group_norm(x, gamma, beta, 32, 1e-6, act)
    again = norm.group_norm(x, gamma, beta, 32, 1e-6, act)
    want = norm._gn_reference(x, gamma, beta, 32, 1e-6, act)
    torch.cuda.synchronize()
    name = f"group_norm {tuple(x.shape)} {act} {dtype}"
    err = check_close(name, got, want, *GN_TOL[dtype])
    require(torch.equal(got, again), f"{name}: a repeat is not bit-equal")
    del want, again
    x_nchw = x.permute(0, 3, 1, 2)
    g_lib, b_lib = gamma.to(dtype), beta.to(dtype)

    def library():
        y = F.group_norm(x_nchw, 32, g_lib, b_lib, 1e-6)
        return F.silu(y) if act == "silu" else y

    nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
    kernel_ms = time_ms(lambda: norm.group_norm(x, gamma, beta, 32, 1e-6, act))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": "group_norm", "shape": list(x.shape), "dtype": str(dtype).split(".")[1],
        "act": act, "max_err": err, "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: norm._gn_reference(x, gamma, beta, 32, 1e-6, act), 5),
        "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": "bytes",
        "bound_share": bound_ms / kernel_ms, "repeat_equal": True, **_gn_route(x),
    }


def _achieved(flops: float, kernel_ms: float, bound_ms: float) -> dict:
    """The bound, the achieved TFLOP/s and the share of the bound reached."""
    return {"bound_ms": bound_ms, "tflops": flops / kernel_ms / 1e9,
            "bound_share": bound_ms / kernel_ms}


def attn_bound(b, l, c, dtype, nbytes, products=2, flash=False) -> dict:
    """The attention bound from the products its route runs, each over the
    peak of its unit: ``products`` L x L x C products (2 b l^2 c flops each;
    2 forward, 5 backward; of the true shape, not the padded one), bf16 on
    the tensor cores (the flash variant's P V twice: P in two pieces); fp32
    on the split-precision route (every width, forward and backward) six
    bf16 piece products each."""
    one = 2 * b * l * l * c
    if dtype == torch.bfloat16:
        t_ops = (products + flash) * one / PEAK_FLOPS[torch.bfloat16]
    else:
        t_ops = 6 * products * one / PEAK_FLOPS[torch.bfloat16]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def _attn_bwd_kernel(dtype, c) -> str:
    """The device kernels behind an attention backward call."""
    c = attention.kernel_shape(1, c)[1]
    if dtype == torch.float32:
        return SPLIT_BWD_KERNEL if c in SPLIT_NARROW else SPLIT_BWD_512_KERNEL
    if c == 512:
        return BWD_512_KERNEL
    return f"attn_bwd_dkdv_wgmma_kernel<{c}> + attn_bwd_dq_wgmma_kernel<{c}>"


def _attn_kernel(dtype, c, flash=False) -> str:
    """The device kernel behind an attention forward call."""
    c = attention.kernel_shape(1, c)[1]
    if dtype == torch.float32:
        return SPLIT_KERNEL if c in SPLIT_NARROW else SPLIT_512_KERNEL
    return f"attn_fwd_wgmma_kernel<{c}, {str(flash).lower()}>"


def attn_case(g, l, c, dtype, batch=BATCH):
    q, k, v = (torch.randn(batch, l, c, device="cuda", generator=g).to(dtype) for _ in range(3))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    again = attention.single_head_attention(q, k, v, return_lse=True)
    want_o, want_lse = attention._attention_reference(q, k, v)
    torch.cuda.synchronize()
    limit = ATTN_REL_TOL[dtype] * want_o.float().pow(2).mean().sqrt().item()
    err = check_close(f"attention {q.shape} {dtype}", o, want_o, limit, 0.0)
    check_close(f"attention lse {q.shape} {dtype}", lse, want_lse, LSE_TOL, 0.0)
    require(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
            f"attention {q.shape} {dtype}: a repeat differs")
    flops = 4 * batch * l * l * c
    nbytes = 4 * q.numel() * q.element_size() + batch * l * 4
    bound = attn_bound(batch, l, c, dtype, nbytes)
    q4, k4, v4 = q[:, None], k[:, None], v[:, None]
    kernel_ms = time_ms(lambda: attention.single_head_attention(q, k, v, return_lse=True))
    return {
        "name": "attention", "shape": [batch, l, c], "dtype": str(dtype).split(".")[1],
        "kernel": _attn_kernel(dtype, c), "max_err": err, "tol": limit,
        "lse_err": (lse - want_lse).abs().max().item(), "repeat_equal": True,
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: attention._attention_reference(q, k, v), 5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
        **_achieved(flops, kernel_ms, bound["bound_ms"]), "bound_by": bound["bound_by"],
    }


def train_sites() -> tuple[Counter, Counter]:
    """The flagship train step's GroupNorm sites by (h=w, C, act) and its
    attention sites by (L, C), one forward pass (encoder and decoder) each,
    read with forward hooks from a batch-1 forward on the card."""
    model = instantiate_from_config(merge_configs([str(FLAGSHIP)])["model"])
    net = model.init_net(torch.Generator().manual_seed(0), device="cuda")
    gn, attn = Counter(), Counter()

    def on_gn(m, inp, _out):
        gn[(inp[0].shape[2], inp[0].shape[1], m.act)] += 1

    def on_attn(_m, inp, _out):
        attn[(inp[0].shape[2] * inp[0].shape[3], inp[0].shape[1])] += 1

    for m in net.modules():
        if isinstance(m, GroupNormSiLU):
            m.register_forward_hook(on_gn)
        elif isinstance(m, AttnBlock):
            m.register_forward_hook(on_attn)
    size = model.input_size
    with torch.no_grad():
        net(torch.zeros(1, size, size, 3, device="cuda"), CURRICULUM_END + 2, phase="full")
    return gn, attn


def rms_close(name, got, want, tol, rtol=0.0) -> float:
    want = want.float()
    err = (got.float() - want).abs()
    bad = err > tol * want.pow(2).mean().sqrt() + rtol * want.abs()
    require(not bool(bad.any()), f"{name}: {int(bad.sum())} elements outside tolerance, "
            f"max err {err.max().item()}")
    return err.max().item()


def gn_bwd_case(g, hw, c, act, dtype):
    x = (torch.randn(TRAIN_BATCH, hw, hw, c, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(x.shape, device="cuda", generator=g).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    beta = 0.1 * torch.randn(c, device="cuda", generator=g)
    _, partial = norm._gn_cuda(x, gamma, beta, 32, 1e-6, act)
    _, mean, rstd = norm._gn_forward_reference(x, gamma, beta, 32, 1e-6, act)
    args = (x, dy, partial, gamma, beta, 32, 1e-6, act)
    dx, dgamma, dbeta = norm.group_norm_backward(*args)
    again = norm.group_norm_backward(*args)
    want = norm._gn_backward_reference(x, dy, mean, rstd, gamma, beta, act)
    torch.cuda.synchronize()
    name = f"group_norm backward {tuple(x.shape)} {act} {dtype}"
    err = rms_close(f"{name} dx", dx, want[0], *GN_BWD_TOL[dtype])
    for what, got, w in (("dgamma", dgamma, want[1]), ("dbeta", dbeta, want[2])):
        check_close(f"{name} {what}", got, w, 1e-4 * w.abs().max().item(), 0.0)
    require(all(torch.equal(a, b) for a, b in zip((dx, dgamma, dbeta), again)),
            f"{name}: a repeat differs")
    del again

    x_lib = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    g_lib = gamma.to(dtype).requires_grad_(True)
    b_lib = beta.to(dtype).requires_grad_(True)
    dy_lib = dy.permute(0, 3, 1, 2)

    def lib_fwd():
        y = F.group_norm(x_lib, 32, g_lib, b_lib, 1e-6)
        return F.silu(y) if act == "silu" else y

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (x_lib, g_lib, b_lib), dy_lib)

    # the function moves x and dy in, dx out (and (C,) params and grads)
    nbytes = 3 * x.numel() * x.element_size() + 6 * c * 4
    kernel_ms = time_ms(lambda: norm.group_norm_backward(*args))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": "group_norm_bwd", "shape": list(x.shape), "dtype": str(dtype).split(".")[1],
        "act": act, "max_err": err, "repeat_equal": True, "kernel_ms": kernel_ms,
        "plain_ms": time_ms(
            lambda: norm._gn_backward_reference(x, dy, mean, rstd, gamma, beta, act), 3),
        "library_ms": time_ms(lib_fwd_bwd) - time_ms(lib_fwd),
        "bound_ms": bound_ms, "bound_by": "bytes", "bound_share": bound_ms / kernel_ms,
    }


def attn_bwd_case(g, l, c, dtype, b=TRAIN_BATCH):
    q, k, v, do = (torch.randn(b, l, c, device="cuda", generator=g).to(dtype) for _ in range(4))
    o, lse = attention.single_head_attention(q, k, v, return_lse=True)
    di = (do.float() * o.float()).sum(-1)
    got = attention.attention_backward(q, k, v, o, lse, do)
    want = attention._attention_backward_reference(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    err = max(rms_close(f"attention backward {q.shape} {dtype} {n}", gt, w, ATTN_REL_TOL[dtype])
              for n, gt, w in zip(("dq", "dk", "dv"), got, want))
    q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in (q, k, v))
    do4 = do[:, None]

    def lib_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (q4, k4, v4), do4)

    flops = 10 * b * l * l * c  # five L x L x C products
    nbytes = 7 * q.numel() * q.element_size() + 2 * b * l * 4  # q k v dO in, dq dk dv out
    bound = attn_bound(b, l, c, dtype, nbytes, products=5)
    kernel_ms = time_ms(lambda: attention._attention_backward_cuda(q, k, v, do, lse, di))
    return {
        "name": "attention_bwd", "shape": [b, l, c], "dtype": str(dtype).split(".")[1],
        "kernel": _attn_bwd_kernel(dtype, c),
        "max_err": err, "kernel_ms": kernel_ms,
        "plain_ms": time_ms(
            lambda: attention._attention_backward_reference(q, k, v, do, lse, di), 3),
        "library_ms": time_ms(lib_fwd_bwd) - time_ms(lib_fwd),
        **_achieved(flops, kernel_ms, bound["bound_ms"]), "bound_by": bound["bound_by"],
    }


def conv_sites() -> dict:
    """The fused-conv sites by (h=w, C, CO), read with forward hooks on the
    ResnetBlock convs that got the norm's affine: the detector's encoder with
    GDT_FUSE_INFERENCE=1 (bf16 weights) and the train forward with
    GDT_WINOGRAD=fused (fp32 weights under bf16 autocast), batch 1 on the
    card; and the GroupNorm sites the fused detector still runs."""
    model = instantiate_from_config(merge_configs([str(FLAGSHIP)])["model"])
    g = torch.Generator().manual_seed(0)
    found = {"detector": Counter(), "train": Counter(), "detector_gn": Counter()}
    where = ["detector"]

    def on_conv(m, args, kwargs, _out):
        if kwargs.get("gn_affine") is not None:
            x = args[0]
            found[where[0]][(x.shape[2], x.shape[1], m.out_channels)] += 1

    def on_gn(m, inp, _out):
        if where[0] == "detector":
            found["detector_gn"][(inp[0].shape[2], inp[0].shape[1], m.act)] += 1

    def hooked(net):
        for m in net.modules():
            if isinstance(m, Conv3x3):
                m.register_forward_hook(on_conv, with_kwargs=True)
            elif isinstance(m, GroupNormSiLU):
                m.register_forward_hook(on_gn)
        return net

    size = model.input_size
    with switches(GDT_FUSE_INFERENCE="1"):
        net = flax_like_init_(model.inference_net(), g)
    net = hooked(cast_compute_dtype(net, torch.bfloat16).to(
        device="cuda", memory_format=torch.channels_last))
    with torch.no_grad():
        net.encode(torch.zeros(1, size, size, 3, device="cuda"))
    where[0] = "train"
    net = hooked(model.init_net(g, device="cuda"))
    with switches(GDT_WINOGRAD="fused"), torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
        net(torch.zeros(1, size, size, 3, device="cuda"), CURRICULUM_END + 2, phase="full")
    return found


def _bound(flops, nbytes, dtype) -> dict:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def _conv_bound(flops, nbytes, dtype, split) -> dict:
    """``_bound``; with ``split`` (the fp32 split-precision route) the six
    bf16 piece products of every product at the bf16 peak, with the bound on
    the CUDA cores beside it."""
    if not split:
        return _bound(flops, nbytes, dtype)
    return {**_bound(SPLIT_CONV_PRODUCTS * flops, nbytes, torch.bfloat16),
            "cuda_cores_bound_ms": _bound(flops, nbytes, dtype)["bound_ms"]}


def _conv_inputs(g, b, hw, c, co, dtype, w=None):
    x = (torch.randn(b, hw, w or hw, c, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    beta = 0.1 * torch.randn(c, device="cuda", generator=g)
    k = torch.randn(3, 3, c, co, device="cuda", generator=g) / (9 * c) ** 0.5
    bias = 0.1 * torch.randn(co, device="cuda", generator=g)
    return x, gamma, beta, k, bias


def _vs_fp32_direct(got, x, a, shift, k, bias) -> float:
    """max |got - fp32 direct conv of the fp32 activation| / RMS of the
    latter: what the kernel's rounding (bf16, Winograd) costs."""
    z = x.float() * a[:, None, None, :] + shift[:, None, None, :]
    z = z * torch.sigmoid(z)
    ref = F.conv2d(z.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), bias, padding=1)
    ref = ref.permute(0, 2, 3, 1)
    return ((got.float() - ref).abs().max() / ref.pow(2).mean().sqrt()).item()


def _dname(dtype) -> str:
    return str(dtype).split(".")[1]


def gn_affine_case(g, hw, c, dtype, b=BATCH):
    x, gamma, beta, _, _ = _conv_inputs(g, b, hw, c, 128, dtype)
    a, shift, partial = norm.group_norm_affine(x, gamma, beta)
    a2, shift2, partial2 = norm.group_norm_affine(x, gamma, beta)
    wa, wb, _, _ = norm._gn_affine_reference(x, gamma, beta, 32, 1e-6)
    torch.cuda.synchronize()
    name = f"group_norm_affine {tuple(x.shape)} {dtype}"
    err = max(rms_close(f"{name} {n}", got, want, 1e-4)
              for n, got, want in (("a", a, wa), ("b", shift, wb)))
    require(torch.equal(a, a2) and torch.equal(shift, shift2) and torch.equal(partial, partial2),
            f"{name}: a repeat is not bit-equal")
    nbytes = x.numel() * x.element_size() + 2 * b * c * 4 + 2 * c * 4
    kernel_ms = time_ms(lambda: norm.group_norm_affine(x, gamma, beta))
    bound = _bound(0, nbytes, dtype)
    return {
        "name": "group_norm_affine", "shape": list(x.shape), "dtype": _dname(dtype),
        "max_err": err, "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: norm._gn_affine_reference(x, gamma, beta, 32, 1e-6), 5),
        "library_ms": None, **bound, "bound_share": bound["bound_ms"] / kernel_ms,
        "repeat_equal": True, "kernel": "gn_stats_kernel + gn_affine_kernel",
        "kernels_per_call": 2,
    }


def fused_conv_case(g, hw, c, co, dtype, w=None):
    """B6 at batch 8 (csrc/conv3x3_wino.cu: bf16 fused_conv_wgmma_kernel,
    fp32 fused_conv_split_wgmma_kernel after its weight pre-pass) with the
    GroupNorm prologue, from the stats kernel's affine; also with emit_z, and
    a repeat that must give the same bits. ``w``: a width other than
    ``hw``."""
    b, w = BATCH, w or hw
    x, gamma, beta, k, bias = _conv_inputs(g, b, hw, c, co, dtype, w)
    a, shift, _ = norm.group_norm_affine(x, gamma, beta)
    got, _ = fused_conv._fused_forward(x, a, shift, k, bias, False)
    got_z, z = fused_conv._fused_forward(x, a, shift, k, bias, True)
    again_z, again = fused_conv._fused_forward(x, a, shift, k, bias, True)
    want_z = fused_conv._silu_affine(x, a, shift)
    want = fused_conv._conv_bias(want_z, k, bias)
    torch.cuda.synchronize()
    name = f"fused_conv {tuple(x.shape)}->{co} {dtype}"
    err = rms_close(name, got, want, CONV_REL_TOL[dtype])
    require(torch.equal(got, got_z), f"{name}: emit_z changed the output")
    require(torch.equal(got_z, again_z) and torch.equal(z, again), f"{name}: a repeat differs")
    rms_close(f"{name} z", z, want_z, CONV_REL_TOL[dtype])
    w9 = k.to(dtype).reshape(9, c, co).contiguous()
    w_lib = k.to(dtype).permute(3, 2, 0, 1).contiguous()
    b_lib = bias.to(dtype)

    def library():
        y = norm.group_norm(x, gamma, beta, 32, 1e-6, "silu")
        return F.conv2d(y.permute(0, 3, 1, 2), w_lib, b_lib, padding=1)

    isz = x.element_size()
    nbytes = (x.numel() + b * hw * w * co + 9 * c * co) * isz + (2 * b * c + co) * 4
    r = {
        "name": "fused_conv", "shape": [b, hw, w, c, co], "dtype": _dname(dtype),
        "max_err": err, "repeat_equal": True,
        "err_vs_fp32_direct_rel": _vs_fp32_direct(got, x, a, shift, k, bias),
        "kernel_ms": time_ms(lambda: conv3x3.conv3x3_forward(x, w9, bias, 1, gn_ab=(a, shift))),
        "plain_ms": time_ms(lambda: fused_conv._conv_bias(
            fused_conv._silu_affine(x, a, shift), k, bias), 5),
        "library_ms": time_ms(library), "kernel": CONV_KERNELS["fused_conv"][dtype],
        **_conv_bound(2 * 9 * b * hw * w * c * co, nbytes, dtype, dtype == torch.float32),
    }
    r["bound_share"] = r["bound_ms"] / r["kernel_ms"]
    return r


def _cudnn_grads(dy, z, k, dtype, mask):
    return torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), z.permute(0, 3, 1, 2), k.to(dtype).permute(3, 2, 0, 1),
        None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)


def wino_cases(g, hw, c, co, dtype) -> list:
    """B7 forward (GroupNorm prologue, F(4,3)), B7 dgrad and B8 (GroupNorm
    recompute) at batch 16, as GDT_WINOGRAD=fused runs them (fp32: each on
    split precision, its bound the six piece products with the CUDA cores'
    beside it)."""
    b, m = TRAIN_BATCH, 4
    x, gamma, beta, k, bias = _conv_inputs(g, b, hw, c, co, dtype)
    dy = torch.randn(b, hw, hw, co, device="cuda", generator=g).to(dtype)
    a, shift, _ = norm.group_norm_affine(x, gamma, beta)
    ab = (a, shift)
    u = wr._u3n(k, dtype, m)
    k_rot = k.flip(0, 1).transpose(2, 3)
    u_rot = wr._u3n(k_rot, dtype, m)
    zero = torch.zeros(c, device="cuda")
    out = wr.wino_rows_forward(x, u, bias, m, ab)
    dz = wr.wino_rows_dgrad(dy, u_rot, m)
    out_again = conv3x3.conv3x3_forward(x, u, bias, m, gn_ab=ab)
    dz_again = conv3x3.conv3x3_forward(dy, u_rot, zero, m)
    du = conv3x3.conv3x3_wgrad(x, dy, m, ab)
    du_again = conv3x3.conv3x3_wgrad(x, dy, m, ab)
    want_out = wr._wino_rows_reference(x, u, bias, a, shift, m)
    want_dz = wr._wino_rows_reference(dy, u_rot, zero, None, None, m)
    want_du = wr._wino_wgrad_reference(x, dy, a, shift, m)
    torch.cuda.synchronize()
    tag = f"{(b, hw, hw, c)}->{co} {dtype}"
    errs = [rms_close(f"wino_rows {tag}", out, want_out, CONV_REL_TOL[dtype]),
            rms_close(f"wino_rows_dgrad {tag}", dz, want_dz, CONV_REL_TOL[dtype]),
            rms_close(f"wino_wgrad {tag}", du, want_du, CONV_REL_TOL[dtype])]
    for name, got, again in (("wino_rows", out, out_again), ("wino_rows_dgrad", dz, dz_again),
                             ("wino_wgrad", du, du_again)):
        require(torch.equal(got, again), f"{name} {tag}: a repeat differs")
    z = fused_conv._silu_affine(x, a, shift)
    w_lib = k.to(dtype).permute(3, 2, 0, 1).contiguous()
    b_lib = bias.to(dtype)
    isz, flops = x.element_size(), ab_wgrad.winograd_flops(b, hw, hw, c, co, m)
    act_in, act_out = x.numel() * isz, b * hw * hw * co * isz
    common = {"shape": [b, hw, hw, c, co], "dtype": _dname(dtype)}
    splits = conv3x3._wgrad_splits(b, hw, hw, c, co, m, dtype)
    wgrad = {"name": "wino_wgrad", **common, "max_err": errs[2], "repeat_equal": True,
             "kernel": CONV_KERNELS["wino_wgrad"][dtype], "splits": splits,
             "kernel_ms": time_ms(lambda: conv3x3.conv3x3_wgrad(x, dy, m, ab)),
             "plain_ms": time_ms(lambda: wr._wino_wgrad_reference(x, dy, a, shift, m), 3),
             "library_ms": time_ms(lambda: _cudnn_grads(dy, z, k, dtype, [False, True, False])),
             **_conv_bound(flops, act_in + act_out + du.numel() * 4 + 2 * b * c * 4, dtype,
                           dtype == torch.float32),
             # the bytes the wgmma kernel's design moves
             **ab_wgrad.wgrad_traffic(b, hw, hw, c, co, m, _dname(dtype), splits)}
    cases = [
        {"name": "wino_rows", **common, "max_err": errs[0], "repeat_equal": True,
         "kernel": CONV_KERNELS["wino_rows"][dtype],
         "err_vs_fp32_direct_rel": _vs_fp32_direct(out, x, a, shift, k, bias),
         "kernel_ms": time_ms(lambda: conv3x3.conv3x3_forward(x, u, bias, m, gn_ab=ab)),
         "plain_ms": time_ms(lambda: wr._wino_rows_reference(x, u, bias, a, shift, m), 3),
         "library_ms": time_ms(lambda: F.conv2d(z.permute(0, 3, 1, 2), w_lib, b_lib, padding=1)),
         **_conv_bound(flops, act_in + act_out + u.numel() * isz + (2 * b * c + co) * 4, dtype,
                       dtype == torch.float32)},
        {"name": "wino_rows_dgrad", **common, "max_err": errs[1], "repeat_equal": True,
         "kernel": CONV_KERNELS["wino_rows_dgrad"][dtype],
         "kernel_ms": time_ms(lambda: conv3x3.conv3x3_forward(dy, u_rot, zero, m)),
         "plain_ms": time_ms(
             lambda: wr._wino_rows_reference(dy, u_rot, zero, None, None, m), 3),
         "library_ms": time_ms(lambda: _cudnn_grads(dy, z, k, dtype, [True, False, False])),
         **_conv_bound(flops, act_in + act_out + u_rot.numel() * isz, dtype,
                       dtype == torch.float32)},
        wgrad,
    ]
    for r in cases:
        r["bound_share"] = r["bound_ms"] / r["kernel_ms"]
    return cases


def flash_case(g, l, c, dtype, batch=BATCH):
    """B5, the forward-only flash variant (products and P to fp32 accuracy
    whatever the input dtype, no lse), at the detector's attention shapes,
    with a bit-equal repeat. Its yardstick is SDPA on fp32 copies of q, k, v
    (TF32 off, as the kernel phase sets it): the like-for-like library call
    for fp32 products."""
    q, k, v = (torch.randn(batch, l, c, device="cuda", generator=g).to(dtype) for _ in range(3))
    o = attention.flash_attention_forward(q, k, v)
    again = attention.flash_attention_forward(q, k, v)
    want = attention._flash_reference(q, k, v)
    torch.cuda.synchronize()
    err = rms_close(f"flash attention {tuple(q.shape)} {dtype}", o, want, ATTN_REL_TOL[dtype])
    require(torch.equal(o, again), f"flash attention {tuple(q.shape)} {dtype}: a repeat differs")
    q4, k4, v4 = (t.float()[:, None] for t in (q, k, v))
    nbytes = 4 * q.numel() * q.element_size()
    r = {
        "name": "flash_attention", "shape": [batch, l, c], "dtype": _dname(dtype),
        "kernel": _attn_kernel(dtype, c, flash=True), "max_err": err, "repeat_equal": True,
        "kernel_ms": time_ms(lambda: attention.flash_attention_forward(q, k, v)),
        "plain_ms": time_ms(lambda: attention._flash_reference(q, k, v), 5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
        **attn_bound(batch, l, c, dtype, nbytes, flash=True),
    }
    r["bound_share"] = r["bound_ms"] / r["kernel_ms"]
    return r


def off_grid_cases(g, b, l, c, dtype) -> list:
    """The forward, the flash forward and the backward at a shape off the
    kernels' grid: padded to it, the padded keys masked, sliced back; each
    call one pad copy."""
    copies = attention.single_head_attention.pad_copies
    cases = [attn_case(g, l, c, dtype, b), flash_case(g, l, c, dtype, b),
             attn_bwd_case(g, l, c, dtype, b)]
    require(attention.single_head_attention.pad_copies > copies,
            f"attention at {(b, l, c)} {dtype} padded nothing")
    for r in cases:
        r["grid"] = list(attention.kernel_shape(l, c))
    return cases


def phase_kernels(gn_train: Counter, attn_train: Counter, sites: dict) -> dict:
    """Every kernel against its plain version (TF32 off for the library
    calls beside them, PyTorch's defaults restored after)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _kernel_cases(gn_train, attn_train, sites)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _kernel_cases(gn_train: Counter, attn_train: Counter, sites: dict) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        for hw, c in sorted({(hw, c) for hw, c, _ in GN_SITES}, reverse=True):
            for act in ("silu", None):
                r = gn_case(g, hw, c, act, dtype)
                cases[("group_norm", hw, c, act, dtype)] = r
                emit(r)
        for l, c in ATTN_SITES:
            r = attn_case(g, l, c, dtype)
            cases[("attention", l, c, dtype)] = r
            emit(r)
        # the forward and its affine at the train step's sites (batch 16), the
        # affine at the detector's too (batch 8)
        for hw, c, act in sorted(gn_train, key=lambda k: (k[0], k[1], k[2] or ""),
                                 reverse=True):
            r = gn_case(g, hw, c, act, dtype, TRAIN_BATCH)
            cases[("group_norm_train", hw, c, act, dtype)] = r
            emit(r)
            torch.cuda.empty_cache()
        for hw, c in sorted({(hw, c) for hw, c, _ in gn_train}, reverse=True):
            r = gn_affine_case(g, hw, c, dtype, TRAIN_BATCH)
            cases[("group_norm_affine_train", hw, c, dtype)] = r
            emit(r)
        for hw, c in sorted({(hw, c) for hw, c, _ in GN_SITES}, reverse=True):
            r = gn_affine_case(g, hw, c, dtype)
            cases[("group_norm_affine", hw, c, dtype)] = r
            emit(r)
        for hw, c in sorted({(hw, c) for hw, c, _ in gn_train}, reverse=True):
            for act in ("silu", None):
                r = gn_bwd_case(g, hw, c, act, dtype)
                cases[("group_norm_bwd", hw, c, act, dtype)] = r
                emit(r)
                torch.cuda.empty_cache()
        for l, c in sorted(attn_train, reverse=True):
            r = attn_bwd_case(g, l, c, dtype)
            cases[("attention_bwd", l, c, dtype)] = r
            emit(r)
            torch.cuda.empty_cache()
        for l, c in ATTN_SITES:
            r = flash_case(g, l, c, dtype)
            cases[("flash_attention", l, c, dtype)] = r
            emit(r)
        # B9's length: B1 and B2 where the JAX package takes jax's library kernel
        for fn, key in ((attn_case, "attention"), (attn_bwd_case, "attention_bwd")):
            r = fn(g, LONG_L, 256, dtype, 1)
            cases[(key, LONG_L, 256, dtype)] = r
            emit(r)
            torch.cuda.empty_cache()
        # the tiny configs' width: attention at (2, 256, 64), GroupNorm at C = 32, 64
        for fn, key in ((attn_case, "attention"), (attn_bwd_case, "attention_bwd")):
            r = fn(g, 256, 64, dtype, 2)
            cases[(key, 256, 64, dtype)] = r
            emit(r)
        # the backward's C = 128 kernels (every width from 65 to 128 pads to them)
        r = attn_bwd_case(g, 256, 128, dtype, 2)
        cases[("attention_bwd", 256, 128, dtype)] = r
        emit(r)
        for hw, c in TINY_GN_ROWS:
            for fn, key in ((gn_case, "group_norm"), (gn_bwd_case, "group_norm_bwd")):
                r = fn(g, hw, c, "silu", dtype)
                cases[(key, hw, c, "silu", dtype)] = r
                emit(r)
            r = gn_affine_case(g, hw, c, dtype)
            cases[("group_norm_affine", hw, c, dtype)] = r
            emit(r)
        for b, l, c in OFF_GRID_ATTN:
            for r in off_grid_cases(g, b, l, c, dtype):
                cases[(r["name"], l, c, dtype)] = r
                emit(r)
        for hw, c, co in sorted(sites["detector"], reverse=True):
            r = fused_conv_case(g, hw, c, co, dtype)
            cases[("fused_conv", hw, c, co, dtype)] = r
            emit(r)
        # a width the JAX package's gate admits past a 64-column tile (C2)
        emit(fused_conv_case(g, 64, 128, 128, dtype, w=96))
        for hw, c, co in sorted(sites["train"], reverse=True):
            for r in wino_cases(g, hw, c, co, dtype):
                cases[(r["name"], hw, c, co, dtype)] = r
                emit(r)
            torch.cuda.empty_cache()
    return cases


def _attention_f64(q, k, v, do):
    """softmax(q k^T / sqrt(C)) v and its (dq, dk, dv) for the output
    gradient ``do``, in float64 on the card, ``LONG_ROWS`` query rows at a
    time (batch 1)."""
    q, k, v, do = (t[0].double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    o, dq = torch.empty_like(q), torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(0, q.shape[0], LONG_ROWS):
        rows = slice(r, r + LONG_ROWS)
        p = torch.softmax((q[rows] @ k.T) * scale, dim=-1)
        o[rows] = p @ v
        dv += p.T @ do[rows]
        di = (do[rows] * o[rows]).sum(-1, keepdim=True)
        ds = p * (do[rows] @ v.T - di) * scale
        del p
        dq[rows] = ds @ k
        dk += ds.T @ q[rows]
        del ds
    return o[None], dq[None], dk[None], dv[None]


def phase_long_attention() -> dict:
    """Attention at ``LONG_ATTN`` = (1, 65536, 256), forward (B1) and
    backward (B2), fp32 on the split-precision kernels and bf16, against a
    float64 reference on the card: max |err| <= tol x RMS(reference) for O,
    dQ, dK and dV (fp32 1e-3, the split kernels' gate; bf16 0.1). Each
    route's time beside SDPA's on the same inputs (a yardstick)."""
    b, l, c = LONG_ATTN
    g = torch.Generator(device="cuda").manual_seed(65536)
    q, k, v, do = (torch.randn(b, l, c, device="cuda", generator=g) for _ in range(4))
    t0 = time.perf_counter()
    want = _attention_f64(q, k, v, do)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    out = {"phase": "long_attention", "shape": list(LONG_ATTN), "reference": "float64",
           "reference_s": ref_s}
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        qd, kd, vd, dod = (t.to(dtype) for t in (q, k, v, do))
        reset_counts()
        o, lse = attention.single_head_attention(qd, kd, vd, return_lse=True)
        grads = attention.attention_backward(qd, kd, vd, o, lse, dod)
        torch.cuda.synchronize()
        counts = read_counts()
        if dtype == torch.float32:
            require(counts["attention_split"] == 1 and counts["attention_split_bwd"] == 1,
                    f"long attention fp32 did not take the split kernels: {counts}")
        require(counts["pad_copies"] == 0, "long attention was padded")
        errs = {}
        for what, got, w in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
            rms = w.pow(2).mean().sqrt().item()
            err = (got.double() - w).abs().max().item()
            errs[what] = {"max_abs_err": err, "rms": rms, "err_over_rms": err / rms}
        emit({"phase": "long_attention_errors", "dtype": name, "errors": errs})
        for what, e in errs.items():
            require(e["err_over_rms"] <= ATTN_REL_TOL[dtype],
                    f"long attention {name} {what}: max err {e['max_abs_err']} > "
                    f"{ATTN_REL_TOL[dtype]} x RMS {e['rms']}")
        di = (dod.float() * o.float()).sum(-1)
        q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in (qd, kd, vd))

        def lib_fwd():
            return F.scaled_dot_product_attention(q4, k4, v4)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), (q4, k4, v4), dod[:, None])

        fwd_ms = time_ms(lambda: attention.single_head_attention(qd, kd, vd, return_lse=True), 5)
        bwd_ms = time_ms(lambda: attention._attention_backward_cuda(qd, kd, vd, dod, lse, di), 5)
        lib_ms = time_ms(lib_fwd, 5)
        out[name] = {
            "errors": errs, "tol_over_rms": ATTN_REL_TOL[dtype],
            "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "forward_kernel": _attn_kernel(dtype, c), "backward_kernel": _attn_bwd_kernel(dtype, c),
            "sdpa_forward_ms": lib_ms, "sdpa_backward_ms": time_ms(lib_fwd_bwd, 5) - lib_ms,
            "forward_bound_ms": attn_bound(b, l, c, dtype, 4 * q.numel() * dtype.itemsize)["bound_ms"],
            "backward_bound_ms": attn_bound(b, l, c, dtype, 7 * q.numel() * dtype.itemsize,
                                            products=5)["bound_ms"],
        }
        del o, lse, grads, q4, k4, v4
    del want
    torch.cuda.empty_cache()
    emit(out)
    return out


def flagship_detector(device: str = "cuda"):
    """The flagship PoseAutoencoder with seeded random weights on ``device``,
    and synthetic hmin/hmax tables (as tests/test_serving.py makes them)."""
    model = instantiate_from_config(merge_configs([str(FLAGSHIP)])["model"])
    net = model.init_net(torch.Generator().manual_seed(0), device=device)
    return model, net, np.full(11, 0.5, np.float32), np.full(11, 4.0, np.float32)


def detector_inputs(b: int, seed: int):
    """The arguments of one detector request of ``b`` patches, seeded numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(-1, 1, size=(b, 256, 256, 3)).astype(np.float32),
        np.full((b,), 1266.0, np.float32),
        np.tile(np.float32([800.0, 450.0]), (b, 1)),
        rng.uniform(60, 200, size=(b,)).astype(np.float32),
        np.tile(np.float32([820.0, 460.0]), (b, 1)),
        rng.uniform(1.5, 3.0, size=(b,)).astype(np.float32),
    )


def reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
    norm.group_norm_backward.grad_copies = attention.attention_backward.grad_copies = 0
    attention.single_head_attention.pad_copies = 0
    norm.group_norm.two_pass = 0


def read_counts() -> dict:
    """The launch counters, the gradients that arrived non-contiguous and
    the attention calls padded to the kernels' grid (both 0 on the flagship
    paths: ``require_no_copies``)."""
    counts = {name: fn.launches for name, fn in COUNTED.items()}
    counts["grad_copies"] = (norm.group_norm_backward.grad_copies
                             + attention.attention_backward.grad_copies)
    counts["pad_copies"] = attention.single_head_attention.pad_copies
    counts["gn_two_pass"] = norm.group_norm.two_pass
    return counts


def require_no_copies(label: str, counts: dict) -> None:
    require(counts["pad_copies"] == 0, f"{label}: {counts['pad_copies']} attention calls padded")
    require(counts["gn_two_pass"] == 0,
            f"{label}: {counts['gn_two_pass']} GroupNorm calls took the two-pass kernels")


def require_default_tf32(label: str) -> None:
    """The fp32 phases run under PyTorch's default TF32 flags (cuDNN's on),
    so that the port's own setting is what makes them fp32."""
    require(torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
            f"{label}: the TF32 flags are not PyTorch's defaults")


def phase_detector(expect: dict, fuse: bool, fp32_fused: int = 0) -> dict:
    """Serve bf16 requests at batch 1, 8 and 32 (GDT_FUSE_INFERENCE=1 when
    ``fuse``): p50s, and the launches per request against ``expect``. Then
    the fp32 detector on the card against the CPU in the same setting, whose
    one request launches B6 at ``fp32_fused`` sites."""
    label = "detector_fused" if fuse else "detector"
    with switches(GDT_FUSE_INFERENCE="1" if fuse else "0"):
        model, net, hmin, hmax = flagship_detector()
        detect = make_detector_fn(model, net, hmin, hmax, 256)  # the bf16 default
        requests = {1: 20, 8: 20, 32: 10}
        inputs = {b: [torch.as_tensor(a, device="cuda") for a in detector_inputs(b, b)]
                  for b in requests}
        torch.cuda.synchronize()
        gc.collect()
        held = torch.cuda.memory_allocated()  # weights, inputs, leftovers
        torch.cuda.reset_peak_memory_stats()

        reset_counts()
        calls, results = 0, {}
        for b, n in requests.items():
            lat = []
            for i in range(n + 3):  # the first 3 requests warm up
                t0 = time.perf_counter()
                boxes, cls, score = detect(*inputs[b])
                torch.cuda.synchronize()
                if i >= 3:
                    lat.append(time.perf_counter() - t0)
                calls += 1
            require(boxes.shape == (b, 7) and cls.shape == (b,) and score.shape == (b,),
                    f"detector output shapes {boxes.shape} {cls.shape} {score.shape}")
            require(bool(torch.isfinite(boxes).all() and torch.isfinite(score).all()),
                    "detector output not finite")
            p50 = statistics.median(lat)
            results[b] = {"phase": label, "batch": b, "dtype": "bfloat16", "requests": n,
                          "p50_ms": p50 * 1e3, "patches_per_s": b / p50,
                          "min_ms": min(lat) * 1e3, "max_ms": max(lat) * 1e3}
            emit(results[b])
        launches = read_counts()
        require_no_copies(label, launches)
        emit({"phase": label, "calls": calls, "launches": launches,
              "launches_per_request": {k: v / calls for k, v in launches.items()},
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "memory_allocated_before_bytes": held})
        for name in COUNTED:
            n = expect.get(name, 0)
            require(launches[name] == n * calls,
                    f"{label} {name} launches {launches[name]} != {n} x {calls}")

        # fp32 on the card (kernels) against fp32 on the CPU (plain versions);
        # fused, every site the fp32 routing rule admits runs the fp32 B6
        # kernel once
        require_default_tf32(f"{label}_fp32_card_vs_cpu")
        args = detector_inputs(2, 99)
        outs = {}
        for device in ("cuda", "cpu"):
            det = make_detector_fn(model, net, hmin, hmax, 256, dtype="float32", device=device)
            reset_counts()
            outs[device] = [t.cpu().numpy() for t in det(*args)]
            if device == "cuda":
                fp32_launches = read_counts()
    require(fp32_launches["fused_conv"] == fp32_fused,
            f"{label}_fp32_card_vs_cpu fused_conv launches {fp32_launches['fused_conv']} "
            f"!= {fp32_fused}")
    (boxes, cls, score), (wboxes, wcls, wscore) = outs["cuda"], outs["cpu"]
    np.testing.assert_allclose(boxes, wboxes, **BOX_TOL)
    np.testing.assert_array_equal(cls, wcls)
    np.testing.assert_allclose(score, wscore, rtol=0, atol=1e-5)
    emit({"phase": f"{label}_fp32_card_vs_cpu", "batch": 2,
          "boxes_max_abs_err": float(np.abs(boxes - wboxes).max()),
          "score_max_abs_err": float(np.abs(score - wscore).max()),
          "classes_equal": True, "boxes": boxes.tolist(), "card_launches": fp32_launches})
    return {"launches": launches, "results": results, "fp32_launches": fp32_launches}


def phase_detector_fp32(expect: dict) -> None:
    """The flagship detector in fp32, as its config ships it (under
    PyTorch's default TF32 flags: the detector turns TF32 off itself): p50
    and peak memory at batch 8 and 32, and the launches per request against
    ``expect`` (all three attention sites run a split-precision kernel)."""
    require_default_tf32("detector_fp32")
    model, net, hmin, hmax = flagship_detector()
    detect = make_detector_fn(model, net, hmin, hmax, 256, dtype="float32")
    for b, n in ((8, 20), (32, 10)):
        inputs = [torch.as_tensor(a, device="cuda") for a in detector_inputs(b, b)]
        detect(*inputs)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        lat = []
        for i in range(n + 3):  # the first 3 requests warm up
            t0 = time.perf_counter()
            boxes, cls, score = detect(*inputs)
            torch.cuda.synchronize()
            if i >= 3:
                lat.append(time.perf_counter() - t0)
        launches = read_counts()
        require_no_copies("detector_fp32", launches)
        require(boxes.shape == (b, 7) and bool(torch.isfinite(boxes).all()
                                                and torch.isfinite(score).all()),
                f"fp32 detector output {boxes.shape} not finite or misshapen")
        for name in COUNTED:
            want = expect.get(name, 0) * (n + 3)
            require(launches[name] == want,
                    f"detector_fp32 {name} launches {launches[name]} != {want}")
        p50 = statistics.median(lat)
        emit({"phase": "detector_fp32", "batch": b, "dtype": "float32", "requests": n,
              "p50_ms": p50 * 1e3, "patches_per_s": b / p50, "min_ms": min(lat) * 1e3,
              "max_ms": max(lat) * 1e3,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "launches_per_request": {k: v / (n + 3) for k, v in launches.items()}})
    del net, detect
    torch.cuda.empty_cache()


def train_batch(b: int, size: int, device, seed: int) -> dict:
    """A synthetic prepared batch (the contract of ``prepare_batch``), made on
    ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    mask = torch.zeros(b, size, size, 1, device=device)
    mask[:, size // 16 : -size // 16, size // 8 : -size // 8] = 1.0
    cls = torch.randint(0, 11, (b,), generator=g, device=device)
    return {
        "rgb_gt": rand(b, size, size, 3) * 2 - 1, "pose_gt": rand(b, 4) * 2 - 1,
        "class_gt": cls, "class_orig_id": cls, "bbox_gt": rand(b, 3) * 3 + 1,
        "fill_factor_gt": rand(b), "mask_2d_bbox": mask,
    }


def flagship_train(compute_dtype=torch.bfloat16):
    """The flagship model, a seeded fp32 train state on the card past the
    curriculum, and its train step (shared discriminator forward, optimizer
    step counting) in ``compute_dtype``; None: the config's own dtype
    (float32)."""
    model = instantiate_from_config(merge_configs([str(FLAGSHIP)])["model"])
    lr = TRAIN_BATCH * 4.5e-6  # base_learning_rate scaled by batch, as ldm does
    state = create_train_state(model, lr, grad_clip=1.0, seed=0, device="cuda")
    state.step = CURRICULUM_END // 2 + 1
    step = make_train_step(model, phase="full", disc_forward="shared",
                           step_counting="optimizer", compute_dtype=compute_dtype)
    return model, state, step


def phase_train(expect: dict, winograd: str, fp32: bool = False) -> dict:
    """The flagship bf16 step at batch 16 with GDT_WINOGRAD=``winograd``:
    3 warm-up and 10 timed steps, the launches per step against ``expect``.
    ``fp32``: the config's own fp32 step instead, 5 timed steps."""
    label = "train" if winograd == "0" else f"train_winograd_{winograd}"
    label += "_fp32" if fp32 else ""
    n_steps = TRAIN_STEPS_FP32 if fp32 else TRAIN_STEPS
    if fp32:
        require_default_tf32(label)
    with switches(GDT_WINOGRAD=winograd):
        model, state, step = flagship_train(None if fp32 else torch.bfloat16)
        batch = train_batch(TRAIN_BATCH, model.input_size, "cuda", 1)
        lpips0 = [p.detach().clone() for p in state.loss.perceptual_loss.parameters()]
        disc0 = [p.detach().clone() for p in state.loss.discriminator.parameters()]
        logvar0 = state.loss.logvar.item()
        for _ in range(TRAIN_WARMUP):
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        lat = []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
    require_no_copies(label, counts)

    for name in COUNTED:
        n = expect.get(name, 0)
        require(counts[name] == n * n_steps,
                f"{label} {name} launches {counts[name]} != {n} x {n_steps}")
    values = {k: float(metrics[k]) for k in ("aeloss", "discloss", "train/d_weight",
                                             "train/disc_factor", "train/rec_loss",
                                             "train/g_loss", "train/kl_loss_obj")}
    require(all(np.isfinite(v) for v in values.values()), f"train losses not finite: {values}")
    require(values["train/d_weight"] > 0.0, f"train/d_weight is {values['train/d_weight']}")
    # the last step's (clipped) gradients: every network parameter has one,
    # finite and nonzero; none is legitimately zero in the 'full' phase
    params = list(state.net.named_parameters())
    zero = [n for n, p in params if p.grad is None or not bool(p.grad.abs().sum() > 0)]
    bad = [n for n, p in params if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    require(not zero and not bad, f"parameters without a finite nonzero gradient: {zero + bad}")
    require(all(torch.equal(a, b) for a, b in zip(lpips0, state.loss.perceptual_loss.parameters())),
            "LPIPS weights changed")
    require(state.loss.logvar.item() == logvar0, "logvar changed")
    require(any(not torch.equal(a, b) for a, b in zip(disc0, state.loss.discriminator.parameters())),
            "discriminator weights did not change")
    p50 = statistics.median(lat)
    result = {
        "phase": label, "config": FLAGSHIP.name, "batch": TRAIN_BATCH,
        "dtype": "float32" if fp32 else "bfloat16", "master_weights": "float32",
        "global_step_g": 2 * (state.step - 1), "steps": n_steps,
        "p50_ms": p50 * 1e3, "min_ms": min(lat) * 1e3, "max_ms": max(lat) * 1e3,
        "train_patches_per_s": TRAIN_BATCH / p50, "max_memory_allocated_bytes": peak,
        "launches_per_step": {k: v / n_steps for k, v in counts.items()},
        "sites_per_step": expect, "params_with_grad": len(params), "losses": values,
    }
    emit(result)
    del state, step
    torch.cuda.empty_cache()
    return {**counts, "result": result}


def phase_train_card_vs_cpu(winograd, ch=128) -> dict:
    """One fp32 step of tiny_cpu.yaml from the same weights and draws on the
    card and the CPU, with GDT_WINOGRAD=``winograd`` (None: unset). At ch 128
    attention runs at C = 256 and 32x32 sites sit in the Winograd band; at
    the config's own ch 32 (``ch`` None) attention runs at (2, 256, 64) and
    GroupNorm at C = 32 and 64."""
    cfg = merge_configs([str(TINY)], [] if ch is None else [f"model.params.ddconfig.ch={ch}"])
    model = instantiate_from_config(cfg["model"])
    rng = np.random.default_rng(5)
    host = model.example_batch(2)
    host[model.image_rgb_key] = rng.uniform(0, 1, size=(2, 32, 32, 3)).astype(np.float32)
    host[model.pose_key] = rng.normal(size=(2, 4)).astype(np.float32)
    host[model.class_key] = host["original_class_id"] = np.array([0, 3], np.int32)
    host[model.bbox_key] = rng.uniform(1, 4, size=(2, 3)).astype(np.float32)
    host[model.fill_factor_key] = rng.uniform(0.2, 0.8, size=2).astype(np.float32)
    draws = {k: rng.standard_normal(size=s).astype(np.float32) for k, s in
             (("posterior", (2, 16, 16, 16)), ("noise", (2, 16, 16, 16)), ("bbox", (2, 8)))}
    draws["dropout"] = rng.uniform(size=(2, 16, 16, 16)).astype(np.float32)
    step = make_train_step(model, phase="full", compute_dtype=torch.float32)
    require_default_tf32("train_fp32_card_vs_cpu")
    out = {}
    with switches(GDT_WINOGRAD=winograd):
        for device in ("cuda", "cpu"):
            state = create_train_state(model, 1e-4, grad_clip=1.0, seed=0, device=device)
            state.step = 6  # generator step 12, past this config's 10-step curriculum
            reset_counts()
            state, metrics = step(state, model.prepare_batch(host, device=device),
                                  {k: torch.as_tensor(v, device=device) for k, v in draws.items()})
            if device == "cuda":
                launches = read_counts()
            moments = [torch.cat([opt.moments(p)[0].flatten().cpu() for p in opt.params])
                       for opt in (state.opt_ae, state.opt_disc)]
            out[device] = ({k: float(metrics[k]) for k in ("aeloss", "discloss", "train/d_weight")},
                           moments)
    if winograd == "fused":
        require(launches["wino_rows"] > 0 and launches["wino_rows_dgrad"] > 0
                and launches["wino_wgrad"] > 0,
                f"tiny fused step ran no Winograd kernel: {launches}")
    for name in ("attention", "attention_bwd", "group_norm", "group_norm_bwd"):
        require(launches[name] > 0, f"tiny step ran no {name} kernel: {launches}")
    (got, got_m), (want, want_m) = out["cuda"], out["cpu"]
    for k, w in want.items():
        require(abs(got[k] - w) <= TRAIN_LOSS_RTOL * abs(w), f"card vs CPU {k}: {got[k]} vs {w}")
    errs = []
    for name, g_m, w_m in zip(("opt_ae", "opt_disc"), got_m, want_m):
        err = (g_m - w_m).abs().max().item()
        require(err <= MOMENT_REL * w_m.abs().max().item(),
                f"card vs CPU {name} Adam mu: max err {err}, scale {w_m.abs().max().item()}")
        errs.append(err)
    emit({"phase": "train_fp32_card_vs_cpu", "winograd": winograd,
          "config": f"tiny_cpu.yaml ch={ch or cfg['model']['params']['ddconfig']['ch']}",
          "batch": 2, "card": got, "cpu": want,
          "card_launches": launches,
          "mu_max_abs_err": dict(zip(("opt_ae", "opt_disc"), errs))})
    return launches


class _ResumeProbe(Callback):
    """The state as the fit starts (after any restore): its step, its first
    network parameter and that parameter's Adam first moment, on the host."""

    def on_fit_start(self, trainer) -> None:
        st = trainer.state
        self.name, p = next(st.net.named_parameters())
        self.step = st.step
        self.param = p.detach().cpu().clone()
        self.moment = st.opt_ae.moments(p)[0].detach().cpu().clone()


def _loader_threads() -> list:
    return [t.name for t in threading.enumerate() if t.name.startswith(THREAD_NAME)]


def _check_fit_run(label: str, run: Path, steps: int) -> dict:
    """The run directory of a fit that ended at ``steps``: every logged value
    finite, one loss line per step, the checkpoint layout."""
    with open(run / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    bad = [(r["step"], k) for r in rows for k, v in r.items() if not math.isfinite(v)]
    require(not bad, f"{label}: non-finite logged values {bad[:5]}")
    loss_steps = [r["step"] for r in rows if "aeloss" in r]
    require(loss_steps == list(range(loss_steps[0], steps + 1)),
            f"{label}: loss lines at steps {loss_steps}")
    ckpt = run / "checkpoints"
    files = {"net.pt", "loss.pt", "optim.pt", "meta.json"}
    last = sorted(os.listdir(ckpt / "last"))
    require(last == [str(steps)], f"{label}: last/ holds {last}")
    best = sorted(int(d) for d in os.listdir(ckpt / "best"))
    require(best and all(files | {"metrics.json"} <= set(os.listdir(ckpt / "best" / str(b)))
                         for b in best), f"{label}: best/ holds {best}")
    require(files <= set(os.listdir(ckpt / "last" / str(steps))), f"{label}: last/ files")
    images = sorted(os.listdir(run / "images" / "train"))
    require(len(images) >= 3, f"{label}: image logger wrote {images}")
    return {"loss_lines": len(loss_steps), "best_steps": best,
            "images": len(images) + len(os.listdir(run / "images" / "val"))}


def phase_fit_synthetic_smoke() -> dict:
    """The training entry point on the card: train_cli with synthetic_smoke.yaml,
    12 steps, then a resume to 16 (see the module docstring); returns the
    launch counts of run 1 and the Trainer's step p50 in ms."""
    require_default_tf32("fit_synthetic_smoke")
    tmp = Path(tempfile.mkdtemp(prefix="gdt_fit_smoke_"))
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        tr1 = train_cli.main(["-b", str(SMOKE), "-t", "-l", str(tmp), "-n", "smoke"])
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        counts = read_counts()
        peak1 = torch.cuda.max_memory_allocated()
        threads1 = _loader_threads()
        require(tr1.state.step == FIT_STEPS, f"run 1 ended at step {tr1.state.step}")
        require_no_copies("fit_synthetic_smoke", counts)
        for name in FIT_KERNELS:
            require(counts[name] > 0, f"fit_synthetic_smoke: no {name} launch: {counts}")
        require(not threads1, f"loader threads alive after run 1: {threads1}")
        run = Path(tr1.logdir)
        run1 = _check_fit_run("run 1", run, FIT_STEPS)
        saved = run / "checkpoints" / "last" / str(FIT_STEPS)
        net_sd = torch.load(saved / "net.pt", map_location="cpu", weights_only=True)
        optim = torch.load(saved / "optim.pt", map_location="cpu", weights_only=True)
        t1 = tr1.timings
        ckpt1 = {"bytes": tr1._ckpt_mgr.bytes_written, "save_s": tr1._ckpt_mgr.save_seconds}

        # the bare step on one prepared batch of the fit's size and dtype
        model = tr1.model
        dm = instantiate_from_config(merge_configs([str(SMOKE)])["data"])
        dm.setup()
        host = next(iter(dm.train_dataloader()))
        dm.teardown()
        batch = model.prepare_batch(host, device=tr1.device)
        step_fn = tr1._train_fns["full"]
        state = tr1.state
        for _ in range(BARE_WARMUP):
            state, _ = step_fn(state, batch)
        bare = []
        for _ in range(BARE_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            bare.append(time.perf_counter() - t)
        del tr1, state, step_fn, batch
        gc.collect()
        torch.cuda.empty_cache()

        probe = _ResumeProbe()
        t0 = time.perf_counter()
        tr2 = train_cli.main(["-r", str(run), "-t", "--max_steps", str(FIT_RESUME_STEPS)],
                             extra_callbacks=[probe])
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        threads2 = _loader_threads()
        require(probe.step == FIT_STEPS, f"run 2 resumed at step {probe.step}")
        require(tr2.state.step == FIT_RESUME_STEPS, f"run 2 ended at step {tr2.state.step}")
        require(not threads2, f"loader threads alive after run 2: {threads2}")
        require(torch.equal(probe.param, net_sd[probe.name]),
                "the resumed first parameter differs from the saved one")
        require(torch.equal(probe.moment, optim["opt_ae"]["adam"]["state"][0]["exp_avg"]),
                "the resumed Adam first moment differs from the saved one")
        run2 = _check_fit_run("run 2", run, FIT_RESUME_STEPS)
        peak = max(peak1, torch.cuda.max_memory_allocated())
        del tr2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    step_p50 = statistics.median(t1["step_s"][FIT_TIMED])
    bare_p50 = statistics.median(bare)
    emit({
        "phase": "fit_synthetic_smoke", "config": SMOKE.name, "batch": 4, "dtype": "float32",
        "steps": FIT_STEPS, "resumed_to": FIT_RESUME_STEPS,
        "trainer_step_p50_ms": step_p50 * 1e3, "bare_step_p50_ms": bare_p50 * 1e3,
        "trainer_over_bare": step_p50 / bare_p50,
        "fit_wall_s": wall1, "fit_steps_s": sum(t1["step_s"]),
        "fit_validation_s": t1["validation_s"], "fit_image_log_s": t1["image_log_s"],
        "fit_checkpoint_s": t1["checkpoint_s"],
        "fit_other_s": wall1 - sum(t1["step_s"]) - t1["validation_s"] - t1["image_log_s"]
        - t1["checkpoint_s"],
        "checkpoint_bytes": ckpt1["bytes"], "checkpoint_save_s": ckpt1["save_s"],
        "resume_wall_s": wall2, "max_memory_allocated_bytes": peak,
        "launches_by_kind": {k: v for k, v in counts.items() if v},
        "run1": run1, "run2": run2,
    })
    return counts, step_p50 * 1e3


def eval_py_keys(gt_classes, num_eval: int) -> set:
    """The keys of ``eval.py``'s JSON (its results, ``eval/metrics.py``
    ``detection_metrics`` and ``eval/detection.py`` ``evaluate_detections``
    under ``set/``) for an evaluation whose foreground ground truths have the
    classes ``gt_classes``."""
    keys = {"split", "psnr", "kl", "step", "num_eval", "class_accuracy"}
    if num_eval:
        keys |= {"mATE", "mASE", "mAOE", "class_accuracy_fg"}
        keys |= {f"match@{t}m" for t in (0.5, 1.0, 2.0, 4.0)}
    keys |= {f"set/{k}" for k in ("mAP", "nds3", "mATE", "mASE", "mAOE")}
    return keys | {f"set/{m}/{c}" for c in gt_classes for m in ("AP", "ATE", "ASE", "AOE")}


def _nuscenes_fixture(root: Path) -> None:
    """A small nuScenes tree in the mmdet3d >= 1.1 layout: 1600x900 JPEG
    frames for CAM_FRONT (two instances, one past the left edge) and CAM_BACK
    (background only), the train and val info pickles."""
    from PIL import Image

    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:900, 0:1600].astype(np.float32)
    cam2img = [[1266.0, 0.0, 800.0], [0.0, 1266.0, 450.0], [0.0, 0.0, 1.0]]
    front = [{"bbox": [700.0, 380.0, 900.0, 520.0], "bbox_label": 0, "center_2d": [800.0, 450.0],
              "bbox_3d": [1.2, 0.8, 20.0, 4.0, 1.6, 1.9, 0.4]},
             {"bbox": [-40.0, 300.0, 120.0, 420.0], "bbox_label": 7, "center_2d": [40.0, 360.0],
              "bbox_3d": [-9.0, 0.5, 12.0, 0.7, 1.8, 0.6, -1.1]}]
    data_list = []
    for s in range(NUSC_SAMPLES):
        for cam in ("CAM_FRONT", "CAM_BACK"):
            (root / "samples" / cam).mkdir(parents=True, exist_ok=True)
            img = np.stack([127 + 100 * np.sin(xx / 97.0 + s) * np.cos(yy / 83.0),
                            127 + 100 * np.cos(xx / 61.0) * np.sin(yy / 127.0 + s),
                            (xx + yy) % 256], axis=-1) + rng.uniform(-20, 20, (900, 1600, 1))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                root / "samples" / cam / f"img_{s}.jpg", quality=90)
        cams = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK", "CAM_BACK_LEFT",
                "CAM_BACK_RIGHT")
        data_list.append({
            "sample_idx": s,
            "images": {c: {"img_path": f"samples/{c}/img_{s}.jpg", "cam2img": cam2img}
                       for c in cams},
            "cam_instances": {c: (front if c == "CAM_FRONT" else []) for c in cams}})
    for name in ("nuscenes_infos_train.pkl", "nuscenes_infos_val.pkl"):
        with open(root / name, "wb") as f:
            pickle.dump({"metainfo": {}, "data_list": data_list}, f)


def _nuscenes_fits(tmp: Path) -> dict:
    """Part (d): ``NUSC_STEPS`` steps of synthetic_smoke.yaml's model on a
    fixture nuScenes tree through the port's NuScenesTrain and
    NuScenesValidation, in both image contracts."""
    from generative_detection_tpu_torch.data.nuscenes import NuScenesTrain

    root = tmp / "nuscenes"
    t0 = time.perf_counter()
    _nuscenes_fixture(root)
    out = {"fixture_s": time.perf_counter() - t0}
    data = []
    for split, cls in (("train", "NuScenesTrain"), ("validation", "NuScenesValidation")):
        p = f"data.params.{split}"
        data += [f"{p}.target=src.data.datasets.nuscenes.{cls}", f"{p}.params.data_root={root}",
                 f"{p}.params.label_names=[car,pedestrian,background]",
                 f"{p}.params.h_minmax_dir={root}", f"{p}.params.perturb_center=true",
                 f"{p}.params.perturb_scale=true", f"{p}.params.patch_height=256"]
    for contract in ("float", "raw"):
        port_autoencoder.batch_contracts.clear()
        t0 = time.perf_counter()
        tr = train_cli.main(["-b", str(SMOKE), "-t", "-l", str(tmp), "-n", f"nusc_{contract}",
                             "--max_steps", str(NUSC_STEPS), "--no-test", "true", *data,
                             *(DEVICE_PREPROCESS if contract == "raw" else ())])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seen = dict(port_autoencoder.batch_contracts)
        other = "float" if contract == "raw" else "raw"
        require(tr.state.step == NUSC_STEPS and seen.get(contract, 0) >= NUSC_STEPS
                and not seen.get(other), f"nuScenes fit ({contract}): step {tr.state.step}, "
                f"batches by contract {seen}")
        with open(Path(tr.logdir) / "metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        bad = [(r["step"], k) for r in rows for k, v in r.items() if not math.isfinite(v)]
        require(not bad and any("aeloss" in r for r in rows),
                f"nuScenes fit ({contract}): non-finite or no loss lines {bad[:5]}")
        out[contract] = {"wall_s": wall, "steps_s": sum(tr.timings["step_s"]),
                         "batches": seen}
        del tr
    ds = NuScenesTrain(data_root=str(root), label_names=["car", "background"],
                       h_minmax_dir=str(root), seed=0)
    out["frame_route"] = ds.frame_route
    return out


def _raw_batch_check() -> dict:
    """Part (a): the raw-crop batch at the flagship's shape, prepared on the
    card and on the CPU (masks bit-equal, rgb_gt within RAW_RGB_TOL), and the
    p50 of a batch's host-to-card copy and device half in both contracts."""
    model = instantiate_from_config(merge_configs([str(FLAGSHIP)])["model"])
    batch = raw_crop_batch(RAW_BATCH, RAW_OUT, seed=4, buffer=RAW_BUFFER)
    got = model.prepare_batch(batch, device="cuda")
    want = model.prepare_batch(batch, device="cpu")
    require(torch.equal(got["mask_2d_bbox"].cpu(), want["mask_2d_bbox"]),
            "raw-crop masks differ between the card and the CPU")
    rgb_err = (got["rgb_gt"].cpu() - want["rgb_gt"]).abs().max().item()
    require(rgb_err <= RAW_RGB_TOL, f"raw-crop rgb_gt: card vs CPU max err {rgb_err}")

    def p50_prepare(host_batch) -> float:
        """p50 ms of one batch's host-to-card copy (pinned, non_blocking, as
        the Trainer's prefetch makes it) and device half."""
        pinned = {k: torch.from_numpy(v).pin_memory()
                  for k, v in model.prepare_batch_host(host_batch).items()}
        lat = []
        for i in range(RAW_WARMUP + RAW_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prepare_batch_device(pinned, device="cuda", non_blocking=True)
            torch.cuda.synchronize()
            if i >= RAW_WARMUP:
                lat.append(time.perf_counter() - t0)
        return statistics.median(lat) * 1e3

    # the same images in the float contract, for the copy's comparison
    float_batch = {k: v for k, v in batch.items()
                   if k not in ("patch_raw", "patch_src_size", "bbox_in_crop", "patch_out_size")}
    float_batch["patch"] = want["rgb_gt"].numpy() * 0.5 + 0.5
    float_batch["mask_2d_bbox"] = want["mask_2d_bbox"].numpy()
    return {
        "batch": RAW_BATCH, "buffer": RAW_BUFFER, "out": RAW_OUT,
        "src_sizes": sorted(set(batch["patch_src_size"].tolist())),
        "rgb_max_abs_err": rgb_err, "masks_bit_equal": True,
        "prepare_p50_ms": {"raw": p50_prepare(batch), "float": p50_prepare(float_batch)},
        "prepare_bytes": {c: sum(np.asarray(v).nbytes for v in model.prepare_batch_host(b).values())
                          for c, b in (("raw", batch), ("float", float_batch))},
    }


def _fit_and_eval(tmp: Path) -> dict:
    """Parts (b) and (c): the training entry point with device_preprocess
    (every batch raw, the fp32 fit's kernels launched, every logged value
    finite), then the eval CLI on that run in both image contracts (finite
    metrics with eval.py's keys, the forward's kernels launched)."""
    port_autoencoder.batch_contracts.clear()
    reset_counts()
    t0 = time.perf_counter()
    tr = train_cli.main(["-b", str(SMOKE), "-t", "-l", str(tmp), "-n", "smoke_raw", "--max_steps",
                         str(FIT_RAW_STEPS), "--no-test", "true", *DEVICE_PREPROCESS])
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_counts = read_counts()
    contracts = dict(port_autoencoder.batch_contracts)
    require_no_copies("device_preprocess fit", fit_counts)
    for name in FIT_KERNELS:
        require(fit_counts[name] > 0, f"device_preprocess fit: no {name} launch: {fit_counts}")
    require(tr.state.step == FIT_RAW_STEPS, f"device_preprocess fit ended at {tr.state.step}")
    require(contracts.get("raw", 0) >= FIT_RAW_STEPS and not contracts.get("float"),
            f"device_preprocess fit: batches by contract {contracts}")
    run = Path(tr.logdir)
    fit = {"steps": FIT_RAW_STEPS, "wall_s": fit_wall, "batches_by_contract": contracts,
           "step_p50_ms": statistics.median(tr.timings["step_s"][FIT_RAW_TIMED]) * 1e3,
           **_check_fit_run("device_preprocess fit", run, FIT_RAW_STEPS),
           "launches": {k: v for k, v in fit_counts.items() if v}}
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    val_cfg = merge_configs([str(SMOKE)])["data"]["params"]
    val = instantiate_from_config(val_cfg["validation"])
    n_eval = min(EVAL_LIMIT * val_cfg["batch_size"], len(val))
    n_batches = -(-n_eval // val_cfg["batch_size"])
    gt = {val[i]["class_name"] for i in range(n_eval) if val[i]["original_class_id"] != 10}
    evals = {"limit": EVAL_LIMIT, "patches": n_eval}
    for contract in ("float", "raw"):
        out = tmp / f"eval_{contract}.json"
        port_autoencoder.batch_contracts.clear()
        reset_counts()
        t0 = time.perf_counter()
        res = eval_cli.main(["-b", str(SMOKE), "-r", str(run), "--limit", str(EVAL_LIMIT),
                             "--out", str(out), *(DEVICE_PREPROCESS if contract == "raw" else ())])
        wall = time.perf_counter() - t0
        counts = read_counts()
        label = f"eval ({contract})"
        require_no_copies(label, counts)
        for name in ("group_norm", "attention_split", "attention_split_512"):
            require(counts[name] > 0, f"{label}: no {name} launch")
        require(json.loads(out.read_text()) == res, f"{label}: --out differs")
        seen = dict(port_autoencoder.batch_contracts)
        require(seen == {contract: n_batches}, f"{label}: batches by contract {seen}")
        bad = [k for k, v in res.items() if k != "split" and not math.isfinite(v)]
        require(not bad, f"{label}: non-finite {bad}")
        keys = eval_py_keys(gt, res["num_eval"])
        require(set(res) == keys, f"{label}: keys {sorted(set(res) ^ keys)} differ from eval.py's")
        require(res["step"] == FIT_RAW_STEPS, f"{label}: step {res['step']}")
        evals[contract] = {"wall_s": wall, "patches_per_s": n_eval / wall, "psnr": res["psnr"],
                           "kl": res["kl"], "keys": len(res),
                           "launches": {k: v for k, v in counts.items() if v}}
    return {"fit_device_preprocess": fit, "eval_cli": evals}


def phase_device_preprocess_and_eval(train_p50_ms: dict, fit_p50_ms: float) -> None:
    """The nuScenes slice's entry points on the card (see the module
    docstring): (a) the raw-crop batch, (b) the device_preprocess fit, (c) the
    eval CLI, (d) fits on a fixture nuScenes tree where PIL is installed."""
    t0 = time.perf_counter()
    raw = _raw_batch_check()
    tmp = Path(tempfile.mkdtemp(prefix="gdt_raw_eval_"))
    try:
        fit_eval = _fit_and_eval(tmp)
        has_pil = importlib.util.find_spec("PIL") is not None
        nusc = _nuscenes_fits(tmp) if has_pil else "not run: PIL is not installed"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    raw_p50 = raw["prepare_p50_ms"]["raw"]
    emit({
        "phase": "device_preprocess_and_eval", "raw_batch": raw,
        "step_p50_ms": {**train_p50_ms, "fit_synthetic_smoke": fit_p50_ms,
                        "fit_device_preprocess": fit_eval["fit_device_preprocess"]["step_p50_ms"]},
        "raw_prepare_share": {k: raw_p50 / v for k, v in train_p50_ms.items()},
        **fit_eval, "nuscenes_fixture": nusc, "phase_wall_s": time.perf_counter() - t0,
    })

EXPORT_REQUESTS = {1: 20, 8: 20, 32: 10}  # timed requests by batch (after 3 warm-ups)
BLOBS = {}  # the bf16 artifacts by label, kept for the parallel phase
# the bf16 detector's agreement of tests/test_torch_port_detector.py: box
# sizes, yaw and scores; centres (ill-conditioned under bf16 rounding) finite
BF16_TOL = dict(rtol=3e-2, atol=5e-2)


def _hold_loaded(label: str, dtype: str, got, want) -> dict:
    """The loaded artifact's outputs against the live detector's: fp32 at
    the detector phase's limits, bf16 at BF16_TOL; classes equal in both."""
    got, want = [t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want]
    require(got[0].shape == want[0].shape and np.isfinite(got[0]).all()
            and np.isfinite(got[2]).all(), f"{label}: loaded output misshapen or not finite")
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"{label} classes")
    if dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], err_msg=f"{label} boxes", **BOX_TOL)
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5, err_msg=f"{label} scores")
    else:
        np.testing.assert_allclose(got[0][:, 3:], want[0][:, 3:], err_msg=f"{label} boxes",
                                   **BF16_TOL)
        np.testing.assert_allclose(got[2], want[2], err_msg=f"{label} scores", **BF16_TOL)
    return {"boxes_max_abs_diff": float(np.abs(got[0] - want[0]).max()),
            "score_max_abs_diff": float(np.abs(got[2] - want[2]).max()),
            "bit_equal": all(np.array_equal(g, w) for g, w in zip(got, want))}


def _export_case(label: str, dtype: str, fuse: bool, expect: dict) -> dict:
    """Export the flagship detector (batch-polymorphic, ``dtype``, the fused
    convs when ``fuse``), load it, and serve batch 1, 8 and 32 from the one
    artifact beside the live ``make_detector_fn``: agreement, launches a
    request equal to the live path's and to ``expect``, p50s side by side."""
    with switches(GDT_FUSE_INFERENCE="1" if fuse else "0"):
        model, net, hmin, hmax = flagship_detector()
        t0 = time.perf_counter()
        blob = export_detector(model, net, hmin, hmax, batch=None, dtype=dtype)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        detect = load_detector(blob)
        load_s = time.perf_counter() - t0
        live = make_detector_fn(model, net, hmin, hmax, 256, dtype=dtype)
        if dtype == "bfloat16":  # served again as two replicas by the parallel phase
            BLOBS[label] = blob
        out = {"phase": "export_and_interop", "artifact": label, "export_s": export_s,
               "blob_bytes": len(blob), "load_s": load_s, "metadata": detect.metadata}
        if dtype == "float32":  # IEEE under the default flags: the CPU's plain detector
            require_default_tf32(f"export_{label}")
            args = detector_inputs(2, 99)
            cpu = make_detector_fn(model, net, hmin, hmax, 256, dtype=dtype, device="cpu")
            out["vs_cpu_batch_2"] = _hold_loaded(f"{label} vs cpu", dtype, detect(*args),
                                                 cpu(*args))
            require_default_tf32(f"export_{label}")
        for b, n in EXPORT_REQUESTS.items():
            inputs = [torch.as_tensor(a, device="cuda") for a in detector_inputs(b, b)]
            counts, lat = {}, {"live": [], "loaded": []}
            for i in range(n + 3):  # the first 3 requests of each warm up
                for name, fn in (("live", live), ("loaded", detect)):
                    reset_counts()
                    t0 = time.perf_counter()
                    res = fn(*inputs)
                    torch.cuda.synchronize()
                    if i >= 3:
                        lat[name].append(time.perf_counter() - t0)
                    counts[name] = read_counts()
                    if name == "live":
                        want = res
            require(counts["loaded"] == counts["live"],
                    f"{label} batch {b}: loaded launches {counts['loaded']} != live "
                    f"{counts['live']}")
            for name in COUNTED:
                require(counts["loaded"][name] == expect.get(name, 0),
                        f"{label} batch {b} {name} launches {counts['loaded'][name]} != "
                        f"{expect.get(name, 0)}")
            require_no_copies(label, counts["loaded"])
            out[f"batch_{b}"] = {
                "requests": n, **_hold_loaded(f"{label} batch {b}", dtype, res, want),
                "p50_ms": {k: statistics.median(v) * 1e3 for k, v in lat.items()},
                "launches_per_request": {k: v for k, v in counts["loaded"].items() if v},
            }
        del detect, live, blob, net
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


def _ckpt_round_trip(tmp: Path) -> dict:
    """The flagship's seeded weights and loss written as a reference .ckpt,
    then a second model built through ``ckpt_path`` with ``ignore_keys``
    ["pose_encoder"]: every tensor bit-equal to the first's, the ignored
    ones its own init."""
    model, net, _, _ = flagship_detector()
    loss = model.build_loss()
    t0 = time.perf_counter()
    path = tmp / "flagship.ckpt"
    save_torch_checkpoint(str(path), export_pose_autoencoder(net, loss), global_step=0)
    write_s = time.perf_counter() - t0
    cfg = merge_configs([str(FLAGSHIP)])
    cfg["model"]["params"].update(ckpt_path=str(path), ignore_keys=["pose_encoder"])
    model2 = instantiate_from_config(cfg["model"])
    net2 = model2.init_net(torch.Generator().manual_seed(1), device="cuda")
    init = {k: v.clone() for k, v in net2.state_dict().items()}
    loss2 = model2.build_loss()
    t0 = time.perf_counter()
    model2.maybe_init_from_ckpt(net2, loss2)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want = net.state_dict()
    ignored = 0
    for k, v in net2.state_dict().items():
        kept = k.startswith("pose_encoder")
        ignored += kept
        require(torch.equal(v, init[k] if kept else want[k]),
                f"ckpt round trip: {k} is not {'its init' if kept else 'the file'}'s")
    require(ignored > 0 and torch.equal(loss2.logvar, loss.logvar)
            and torch.equal(loss2.discriminator.main[0].weight, loss.discriminator.main[0].weight),
            "ckpt round trip: the loss did not load")
    return {"ckpt_bytes": path.stat().st_size, "write_s": write_s, "load_s": load_s,
            "tensors": len(want), "ignored": ignored, "bit_equal": True}


def phase_export_and_interop(det_p50_ms: dict, expect: dict) -> dict:
    """Serving export and reference checkpoints (see the module docstring):
    three flagship artifacts against the live detector, and the .ckpt
    round trip. ``det_p50_ms``: the detector phase's
    bf16 p50 by batch, printed beside the live p50s here; ``expect``: the
    launches a request of each artifact."""
    t0 = time.perf_counter()
    cases = {label: _export_case(label, dtype, fuse, expect[label])
             for label, dtype, fuse in (("bf16", "bfloat16", False),
                                        ("bf16_fused", "bfloat16", True),
                                        ("fp32", "float32", False))}
    tmp = Path(tempfile.mkdtemp(prefix="gdt_ckpt_"))
    try:
        ckpt = _ckpt_round_trip(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {
        "phase": "export_and_interop", "ckpt_round_trip": ckpt,
        "p50_ms_live_vs_loaded": {label: {b: c[f"batch_{b}"]["p50_ms"] for b in EXPORT_REQUESTS}
                                  for label, c in cases.items()},
        "detector_phase_bf16_p50_ms": det_p50_ms, "phase_wall_s": time.perf_counter() - t0,
    }
    emit(summary)
    return summary


# plain_autoencoder: the plain family at the flagship backbone's width (its
# ddconfig and embed_dim over plain_kl_tiny.yaml, disc_start 0, bf16 compute),
# 256^2 input, batch 16: 2 warm-up + 10 timed bf16 steps, 1 + 5 fp32, one
# GDT_WINOGRAD=fused bf16 step after a warm-up, the eval step, predict under
# GDT_FUSE_INFERENCE=1; the card against the CPU at plain_kl_tiny.yaml's own
# width (batch 2) for 3 steps; its CLI fit (the config's 4 steps), a resume to
# 6, the .ckpt export and ckpt_path
PLAIN_SIZE, PLAIN_BATCH = 256, 16
PLAIN_WARMUP, PLAIN_STEPS, PLAIN_WARMUP_FP32, PLAIN_STEPS_FP32 = 2, 10, 1, 5
PLAIN_CPU_STEPS, PLAIN_CPU_BATCH = 3, 2
PLAIN_RESUME_STEPS = 6


def plain_model(dtype="bfloat16", size=PLAIN_SIZE):
    """plain_kl_tiny.yaml with the flagship's ddconfig and embed_dim, the GAN
    term and d_weight live from step 0, in ``dtype``."""
    flagship = merge_configs([str(FLAGSHIP)])["model"]["params"]
    dotlist = [f"model.params.ddconfig.{k}={json.dumps(v)}"
               for k, v in flagship["ddconfig"].items()]
    dotlist += [f"model.params.embed_dim={flagship['embed_dim']}",
                "model.params.lossconfig.params.disc_start=0", f"model.params.dtype={dtype}"]
    return instantiate_from_config(merge_configs([str(PLAIN)], dotlist)["model"])


def plain_sites(model, size=PLAIN_SIZE) -> dict:
    """Forwards of the plain net at ``size``^2, batch 1, on the card, read
    with forward hooks: its GroupNorm and attention sites (and those at
    C = 512) as it is, the convs that take the norm's affine with
    GDT_WINOGRAD=fused (B7 sites, (h, C, CO)) and in the fused inference net
    (B6 sites)."""
    found = {"gn": 0, "attn": 0, "attn_512": 0, "wino": Counter(), "b6": 0}
    where = ["plain"]

    def on_gn(*_):
        found["gn"] += where[0] == "plain"

    def on_attn(_m, inp, _out):
        if where[0] == "plain":
            found["attn"] += 1
            found["attn_512"] += inp[0].shape[1] == 512

    def on_conv(m, args, kwargs, _out):
        if kwargs.get("gn_affine") is not None:
            x = args[0]
            if where[0] == "wino":
                found["wino"][(x.shape[2], x.shape[1], m.out_channels)] += 1
            elif where[0] == "b6":
                found["b6"] += 1

    def hooked(net):
        for m in net.modules():
            if isinstance(m, GroupNormSiLU):
                m.register_forward_hook(on_gn)
            elif isinstance(m, AttnBlock):
                m.register_forward_hook(on_attn)
            elif isinstance(m, Conv3x3):
                m.register_forward_hook(on_conv, with_kwargs=True)
        return net

    x = torch.zeros(1, size, size, 3, device="cuda")
    net = hooked(model.init_net(torch.Generator().manual_seed(0), device="cuda"))
    with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
        net(x, sample_posterior=False)
        where[0] = "wino"
        with switches(GDT_WINOGRAD="fused"):
            net(x, sample_posterior=False)
        where[0] = "b6"
        with switches(GDT_FUSE_INFERENCE="1"):
            hooked(model.inference_net(net))(x, sample_posterior=False)
    return found


def _plain_batch(b, size, device, seed) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    return {"image": torch.rand(b, size, size, 3, generator=g, device=device) * 2 - 1}


def _plain_steps(label, state, step, batch, warmup, n, expect) -> dict:
    """``warmup`` then ``n`` timed steps; the launches of the timed ones
    against ``expect`` per step; finite losses, d_weight live, LPIPS and
    logvar unchanged, the discriminator moved."""
    lpips0 = [p.detach().clone() for p in state.loss.perceptual_loss.parameters()]
    disc0 = [p.detach().clone() for p in state.loss.discriminator.parameters()]
    logvar0 = state.loss.logvar.item()
    for _ in range(warmup):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    counts = read_counts()
    require_no_copies(label, counts)
    for name in COUNTED:
        want = expect.get(name, 0) * n
        require(counts[name] == want, f"{label} {name} launches {counts[name]} != {want}")
    values = {k: float(v) for k, v in metrics.items()}
    require(all(math.isfinite(v) for v in values.values()), f"{label}: losses {values}")
    require(values["train/d_weight"] > 0 and values["train/disc_factor"] == 1.0,
            f"{label}: d_weight {values['train/d_weight']}, "
            f"disc_factor {values['train/disc_factor']}")
    require(all(torch.equal(a, b) for a, b in zip(lpips0, state.loss.perceptual_loss.parameters()))
            and state.loss.logvar.item() == logvar0, f"{label}: LPIPS or logvar changed")
    require(any(not torch.equal(a, b) for a, b in zip(disc0, state.loss.discriminator.parameters())),
            f"{label}: the discriminator did not move")
    p50 = statistics.median(lat)
    return {"phase": label, "steps": n, "p50_ms": p50 * 1e3, "min_ms": min(lat) * 1e3,
            "max_ms": max(lat) * 1e3, "train_images_per_s": batch["image"].shape[0] / p50,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches_per_step": {k: v / n for k, v in counts.items() if v},
            "counts": counts, "losses": values}


def _plain_card_vs_cpu() -> dict:
    """plain_kl_tiny.yaml as shipped (ch 32, fp32, disc_start 2), batch 2, 3
    steps from seed 0 on the card and on the CPU with the same batches and
    posterior draws, crossing disc_start: each step's aeloss, discloss and
    d_weight within 1e-3 relative and both optimizers' Adam first moments
    after it within 1e-3 of each one's largest (``phase_train_card_vs_cpu``'s
    limits); the card's steps ran the kernels. Steps 2 and 3 start the card
    from the CPU's state (weights, Adam moments): Adam's first update moves
    every weight whose gradient lies below fp32 rounding by up to 2 lr, in a
    direction of its own on each device, and the next step's d_weight (a
    ratio of two gradient norms) then differs by up to 2.6e-3."""
    model = instantiate_from_config(merge_configs([str(PLAIN)])["model"])
    rng = np.random.default_rng(20)
    size = model.ddconfig["resolution"]
    latent = size // 2 ** (len(model.ddconfig["ch_mult"]) - 1)
    hosts = [rng.uniform(-1, 1, size=(PLAIN_CPU_BATCH, size, size, 3)).astype(np.float32)
             for _ in range(PLAIN_CPU_STEPS)]
    draws = [rng.standard_normal((PLAIN_CPU_BATCH, latent, latent, model.embed_dim)
                                 ).astype(np.float32) for _ in range(PLAIN_CPU_STEPS)]
    step = make_plain_train_step(model)
    require_default_tf32("plain_card_vs_cpu")
    states = {d: create_train_state(model, 1e-4, grad_clip=1.0, seed=0, device=d)
              for d in ("cuda", "cpu")}
    reset_counts()
    rows, errs = [], []
    for i, (host, eps) in enumerate(zip(hosts, draws)):
        card, cpu = states["cuda"], states["cpu"]
        if i:
            card.net.load_state_dict(cpu.net.state_dict())
            card.loss.load_state_dict(cpu.loss.state_dict())
            with torch.no_grad():
                for mine, theirs in ((card.opt_ae, cpu.opt_ae), (card.opt_disc, cpu.opt_disc)):
                    for p_card, p_cpu in zip(mine.params, theirs.params):
                        for k, v in theirs.adam.state[p_cpu].items():
                            mine.adam.state[p_card][k].copy_(v)
        losses, moments = {}, {}
        for device, state in states.items():
            state, m = step(state, model.prepare_batch({"image": host}, device=device),
                            {"posterior": torch.as_tensor(eps, device=device)})
            losses[device] = {k: float(m[k]) for k in ("aeloss", "discloss", "train/d_weight",
                                                        "train/disc_factor")}
            moments[device] = [torch.cat([opt.moments(p)[0].flatten().cpu() for p in opt.params])
                               for opt in (state.opt_ae, state.opt_disc)]
        got, want = losses["cuda"], losses["cpu"]
        for k, w in want.items():
            require(abs(got[k] - w) <= TRAIN_LOSS_RTOL * abs(w),
                    f"plain card vs CPU step {i} {k}: {got[k]} vs {w}")
        step_errs = {}
        for name, g_m, w_m in zip(("opt_ae", "opt_disc"), moments["cuda"], moments["cpu"]):
            err = (g_m - w_m).abs().max().item()
            require(err <= MOMENT_REL * w_m.abs().max().item(),
                    f"plain card vs CPU step {i} {name} Adam mu: max err {err}, "
                    f"scale {w_m.abs().max().item()}")
            step_errs[name] = err
        rows.append({"card": got, "cpu": want})
        errs.append(step_errs)
    launches = read_counts()
    for name in ("attention", "attention_bwd", "attention_split", "attention_split_bwd",
                 "group_norm", "group_norm_bwd"):
        require(launches[name] > 0, f"plain_card_vs_cpu ran no {name} kernel: {launches}")
    require([r["cpu"]["train/disc_factor"] for r in rows] == [0.0, 1.0, 1.0],
            f"plain card vs CPU: disc_factor by step {rows}")
    return {"config": PLAIN.name, "batch": PLAIN_CPU_BATCH, "steps": rows,
            "mu_max_abs_err": errs, "card_launches": {k: v for k, v in launches.items() if v}}


def _plain_cli(tmp: Path) -> dict:
    """train_cli with plain_kl_tiny.yaml on the card (``--device cuda`` over
    the config's ``accelerator: cpu``), a resume to ``PLAIN_RESUME_STEPS``,
    export_torch_ckpt of the run, and that .ckpt through ``ckpt_path`` into a
    network of another seed: every tensor equal to the run's last one."""
    reset_counts()
    t0 = time.perf_counter()
    tr = train_cli.main(["-b", str(PLAIN), "-t", "-l", str(tmp), "-n", "plain",
                         "--device", "cuda"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    require(tr.device.type == "cuda", f"plain fit ran on {tr.device}")
    fit_steps = tr.state.step
    for name in ("group_norm", "group_norm_bwd", "attention_split", "attention_split_bwd"):
        require(counts[name] > 0, f"plain fit: no {name} launch: {counts}")
    run = Path(tr.logdir)
    del tr
    tr2 = train_cli.main(["-r", str(run), "-t", "--max_steps", str(PLAIN_RESUME_STEPS),
                          "--device", "cuda"])
    require(tr2.state.step == PLAIN_RESUME_STEPS, f"plain resume ended at {tr2.state.step}")
    del tr2
    run_info = _check_fit_run("plain fit", run, PLAIN_RESUME_STEPS)
    ckpt = tmp / "plain.ckpt"
    exported = export_torch_ckpt.main(["-b", str(PLAIN), "-r", str(run), "--out", str(ckpt)])
    require(exported["step"] == PLAIN_RESUME_STEPS, f"export at step {exported['step']}")
    cfg = merge_configs([str(PLAIN)])
    cfg["model"]["params"]["ckpt_path"] = str(ckpt)
    model = instantiate_from_config(cfg["model"])
    net = model.init_net(torch.Generator().manual_seed(1), device="cuda")
    loss = model.init_loss(torch.Generator().manual_seed(1), device="cuda")
    model.maybe_init_from_ckpt(net, loss)
    saved = torch.load(run / "checkpoints" / "last" / str(PLAIN_RESUME_STEPS) / "net.pt",
                       map_location="cpu", weights_only=True)
    for k, v in net.state_dict().items():
        require(torch.equal(v.cpu(), saved[k]), f"plain ckpt_path: {k} is not the run's")
    return {"fit_steps": fit_steps, "resumed_to": PLAIN_RESUME_STEPS, "fit_s": fit_s,
            "fit_launches": {k: v for k, v in counts.items() if v}, **run_info,
            "export": exported["tensors"], "ckpt_path_bit_equal": True}


def phase_plain_autoencoder() -> dict:
    """The plain KL autoencoder family on the card (see ``PLAIN_SIZE``'s
    comment); returns the launch counts of its bf16, fp32 and fused steps
    and of its predict."""
    t_phase = time.perf_counter()
    model = plain_model()
    sites = plain_sites(model)
    n_gn, n_attn, n_512, wino = sites["gn"], sites["attn"], sites["attn_512"], sites["wino"]
    n_wino = sum(wino.values())
    require(n_gn > 0 and n_attn > 0 and n_512 > 0 and n_wino > 0 and sites["b6"] > 0,
            f"plain sites {sites}")
    per_step = {"group_norm": n_gn, "group_norm_bwd": n_gn, "attention": n_attn,
                "attention_bwd": n_attn}
    split = {"attention_split": n_attn - n_512, "attention_split_512": n_512,
             "attention_split_bwd": n_attn - n_512, "attention_split_bwd_512": n_512}
    lr = PLAIN_BATCH * 4.5e-6
    state = create_train_state(model, lr, grad_clip=1.0, seed=0, device="cuda")
    batch = _plain_batch(PLAIN_BATCH, PLAIN_SIZE, "cuda", 3)
    out = {"phase": "plain_autoencoder", "config": f"{PLAIN.name} + {FLAGSHIP.name} ddconfig",
           "batch": PLAIN_BATCH, "input": PLAIN_SIZE,
           "sites": {"group_norm": n_gn, "attention": n_attn, "attention_c512": n_512,
                     "winograd_fused": n_wino, "fused_conv_inference": sites["b6"]}}
    bf16 = _plain_steps("plain_bf16", state, make_plain_train_step(model), batch,
                        PLAIN_WARMUP, PLAIN_STEPS, {**per_step, "attention_bwd_512": n_512})
    require_default_tf32("plain_fp32")
    fp32 = _plain_steps("plain_fp32", state, make_plain_train_step(model, compute_dtype=torch.float32),
                        batch, PLAIN_WARMUP_FP32, PLAIN_STEPS_FP32, {**per_step, **split})
    routed = wino_routed(wino)
    with switches(GDT_WINOGRAD="fused"):
        fused = _plain_steps(
            "plain_bf16_winograd_fused", state, make_plain_train_step(model), batch, 1, 1,
            {**per_step, "attention_bwd_512": n_512, "group_norm": n_gn - n_wino,
             "group_norm_affine": n_wino, "wino_rows": n_wino,
             "wino_rows_dgrad": sum(routed["wino_rows_dgrad"].values()),
             "wino_wgrad": sum(routed["wino_wgrad"].values())})
    for r in (bf16, fp32, fused):
        out[r["phase"]] = {k: v for k, v in r.items() if k != "counts"}

    # the eval step, then predict under GDT_FUSE_INFERENCE=1 through the Trainer
    reset_counts()
    metrics = make_plain_eval_step(model)(state, batch, generator=state.generator)
    torch.cuda.synchronize()
    eval_counts = read_counts()
    require(all(math.isfinite(float(v)) for v in metrics.values())
            and all(k.startswith("val/") for k in metrics) and float(metrics["val/d_weight"]) == 0,
            f"plain eval metrics {metrics}")
    for name in COUNTED:
        want = {"group_norm": n_gn, "attention": n_attn}.get(name, 0)
        require(eval_counts[name] == want, f"plain eval {name} launches {eval_counts[name]} != {want}")
    split_cfg = {"target": "generative_detection_tpu.data.synthetic.SyntheticImageValidation",
                 "params": {"length": PLAIN_BATCH, "patch_height": PLAIN_SIZE}}
    dm = instantiate_from_config({"target": "generative_detection_tpu.data.datamodule.DataModuleFromConfig",
                                  "params": {"batch_size": PLAIN_BATCH, "num_workers": 0,
                                             "predict": split_cfg}})
    tmp = Path(tempfile.mkdtemp(prefix="gdt_plain_"))
    try:
        trainer = Trainer(model, logdir=str(tmp / "predict"), device="cuda")
        trainer.state = state
        with switches(GDT_FUSE_INFERENCE="1"):
            reset_counts()
            preds = trainer.predict(dm)
            torch.cuda.synchronize()
            predict_counts = read_counts()
        dm.teardown()
        require(len(preds) == 1 and set(preds[0]) == {"dec_obj"}
                and preds[0]["dec_obj"].shape == (PLAIN_BATCH, PLAIN_SIZE, PLAIN_SIZE, 3)
                and bool(np.isfinite(preds[0]["dec_obj"]).all()), "plain predict output")
        b6 = sites["b6"]
        for name in COUNTED:
            want = {"fused_conv": b6, "group_norm_affine": b6, "group_norm": n_gn - b6,
                    "attention": n_attn}.get(name, 0)
            require(predict_counts[name] == want,
                    f"plain predict {name} launches {predict_counts[name]} != {want}")
        del trainer
        out["eval"] = {"launches": {k: v for k, v in eval_counts.items() if v},
                       "rec_loss": float(metrics["val/rec_loss"])}
        out["predict_fused"] = {"launches": {k: v for k, v in predict_counts.items() if v}}
        del state
        gc.collect()
        torch.cuda.empty_cache()
        out["card_vs_cpu"] = _plain_card_vs_cpu()
        out["cli"] = _plain_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return {"bf16": bf16["counts"], "fp32": fp32["counts"], "fused": fused["counts"],
            "predict": predict_counts}


def phase_plain_fused_fp32_memory() -> dict:
    """One fp32 GDT_WINOGRAD=fused step of the plain family at the flagship
    backbone's width at ``BIG_PLAIN_SIZE``^2 input, batch ``BIG_PLAIN_BATCH``
    (attention at L = 16384 on the split kernels): its peak memory and the
    largest weight-gradient (B8) split-K partial buffer, whose split count
    grows with the input (``ops/conv3x3.py`` ``_wgrad_splits``)."""
    require_default_tf32("plain_fused_fp32_512")
    model = plain_model("float32")
    partials = []
    splits_fn = conv3x3._wgrad_splits

    def recording(b, h, w, c, co, m, dtype):
        n = splits_fn(b, h, w, c, co, m, dtype)
        partials.append(((b, h, w, c, co), n, n * (m + 2) * 3 * c * co * 4))
        return n

    with switches(GDT_WINOGRAD="fused"):
        state = create_train_state(model, 1e-4, grad_clip=1.0, seed=0, device="cuda")
        step = make_plain_train_step(model)
        batch = _plain_batch(BIG_PLAIN_BATCH, BIG_PLAIN_SIZE, "cuda", 4)
        state, _ = step(state, batch)  # warm-up
        torch.cuda.synchronize()
        gc.collect()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        conv3x3._wgrad_splits = recording
        try:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        finally:
            conv3x3._wgrad_splits = splits_fn
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(float(v)) for v in metrics.values()), "plain 512 fp32 losses")
    for name in ("wino_rows", "wino_wgrad", "attention_split", "attention_split_bwd"):
        require(counts[name] > 0, f"plain 512 fp32 fused step: no {name} launch: {counts}")
    largest = max(partials, key=lambda p: p[2])
    out = {"phase": "plain_fused_fp32_512", "input": BIG_PLAIN_SIZE, "batch": BIG_PLAIN_BATCH,
           "step_ms": step_s * 1e3, "max_memory_allocated_bytes": peak,
           "memory_allocated_before_bytes": held,
           "largest_wgrad_partial": {"site": list(largest[0]), "splits": largest[1],
                                     "bytes": largest[2]},
           "wgrad_partial_bytes_per_step": sum(p[2] for p in partials),
           "launches": {k: v for k, v in counts.items() if v}}
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return counts


# parallel: data parallelism on the one card. (a) train_cli in a process
# group of one rank over NCCL against the same CLI with no group: the
# flagship over synthetic_smoke.yaml at batch 16 in bf16, 3 steps, the
# curriculum off (d_weight live from step 2), no validation; (b) two ranks
# sharing the card over gloo (NCCL refuses two ranks on one device), each at
# batch 8 of the same model's bf16 step, 3 steps with ZeRO-1 off and on, against one process at batch 16 with the same batch and
# draws, a collective save restored into one process, then one
# GDT_WINOGRAD=fused step, then the same with FSDP (the parameters sharded);
# (c) shard_detector: the bf16 artifacts (plain and GDT_FUSE_INFERENCE=1) as
# two replicas on cuda:0 at batch 32. (b) runs the model, curriculum and
# synthetic patches of (a)
PAR_STEPS, PAR_BATCH, PAR_RANKS = 3, 16, 2
PAR_KEYS = ("aeloss", "discloss", "train/d_weight", "train/rec_loss", "train/g_loss")
# the first step against one process, relative: the losses at the card-vs-CPU
# step's 1e-3; d_weight, a ratio of two norms of sums over B * H * W positions
# that cancel, at the bf16 limit of BF16_TOL (it moved 6.8e-3 between the two
# summation orders in bf16). The later steps are printed, not held: Adam's
# first update turns rounding-level gradient elements into +-lr moves of
# their weights (ROADMAP.md section C), and d_weight then drifts further
# (0.175 at step 3). One process with the ranks' batch-norm arithmetic (its
# statistics summed in fp32, where F.batch_norm takes the bf16 activations)
# is printed beside them: how much of the gap that arithmetic explains.
PAR_GATED = {"aeloss": TRAIN_LOSS_RTOL, "discloss": TRAIN_LOSS_RTOL,
             "train/d_weight": BF16_TOL["rtol"]}
ZERO1_REL = 1e-6
# FSDP against the unsharded ranks: the first step's losses (the gathers are
# exact and a sum of two is order-free), and the weights after it in units of
# the learning rate (tests/test_fsdp.py's bound: Adam's first update is
# sign-like, and the global norm sums in another order)
FSDP_REL, FSDP_LR_BOUND = 1e-6, 2.05
# FSDP's first step against the unsharded ranks': each optimizer's gradient
# before the clip (from its consolidated moments, ``_step1``), of its
# largest, and its global norm, relative (the norm sums in another order).
# The discriminator's within bf16 rounding only: autocast casts a leaf weight
# once an autocast region, so the unsharded discriminator's two forwards
# (real, fake) sum their weight gradients in bf16, where FSDP's gathered
# weights, no leaves, are cast at each forward and their gradients sum in
# float32; the ranks' sum of the two can cancel, so the difference reached
# 1.2e-2 of the largest squared gradient on the H100. A wrong slice or scale
# of the reduce-scatter, or a stale gather, moves either by O(1).
FSDP_GRAD_REL, FSDP_NORM_REL = {"opt_ae": 1e-5, "opt_disc": 5e-2}, 1e-3
PAR_REQUESTS = 10
PAR_PATH = ("group_norm", "group_norm_bwd", "attention", "attention_bwd", "attention_bwd_512")
PAR_FUSED_PATH = ("wino_rows", "wino_rows_dgrad", "wino_wgrad", "group_norm_affine")


# synthetic_smoke.yaml (the flagship's width) in bf16 with the curriculum off:
# d_weight live from generator step 1, unclamped (the pixel term starts at 8)
PAR_DOTLIST = ("model.params.dtype=bfloat16",
               "model.params.lossconfig.params.encoder_pretrain_steps=0",
               "model.params.lossconfig.params.disc_start=0", "model.params.monitor=null")


def _par_train():
    """PAR_DOTLIST's model, a seeded state on the card at batch index 1
    (generator step 2), its bf16 'full' step, and the batch: the first
    PAR_BATCH patches of the config's synthetic dataset, prepared on the
    card, in a process group this rank's share (rescaled alone, as each rank
    of the fit rescales its own), else all of them rescaled per half."""
    cfg = merge_configs([str(SMOKE)], list(PAR_DOTLIST))
    model = instantiate_from_config(cfg["model"])
    state = create_train_state(model, PAR_BATCH * 4.5e-6, grad_clip=1.0, seed=0, device="cuda")
    state.step = 1
    ds = instantiate_from_config(cfg["data"]["params"]["train"])
    host = collate([ds[i] for i in range(PAR_BATCH)])
    if mesh.world().size > 1:
        batch = model.prepare_batch(mesh.shard_batch(host), device="cuda")
    else:
        batch = model.prepare_batch(host, num_shards=PAR_RANKS, device="cuda")
    return model, state, make_train_step(model, phase="full", compute_dtype=torch.bfloat16), batch


def _par_cli(tmp: Path, name: str, env: dict, extra=()) -> tuple:
    """train_cli over synthetic_smoke.yaml at batch 16 with PAR_DOTLIST, 3
    steps, with ``env`` set and the ``extra`` dotlist: its logged (step,
    losses) and its trained weights (one flat tensor on the card)."""
    args = ["-b", str(SMOKE), "-t", "-l", str(tmp), "-n", name, "--logging_level", "WARNING",
            f"data.params.batch_size={PAR_BATCH}", *PAR_DOTLIST,
            f"lightning.trainer.max_steps={PAR_STEPS}", "lightning.trainer.limit_val_batches=0",
            *extra]
    with switches(**env):
        tr = train_cli.main(args)
    require(tr.state.step == PAR_STEPS, f"parallel {name}: ended at step {tr.state.step}")
    with open(Path(tr.logdir) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    rows = [(r["step"], [r[k] for k in PAR_KEYS]) for r in rows if "aeloss" in r]
    require([r[0] for r in rows] == list(range(1, PAR_STEPS + 1)), f"parallel {name}: {rows}")
    flat = torch.cat([p.detach().reshape(-1) for p in tr.state.net.parameters()])
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return rows, flat


def _world1_nccl(tmp: Path) -> dict:
    """(a): the CLI joined to a world of one rank over NCCL against the CLI
    alone, cuDNN deterministic in both."""
    import torch.distributed as dist

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        alone = _par_cli(tmp, "alone", {})
        env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(multihost.free_port()), GDT_DIST_BACKEND=None)
        world1 = _par_cli(tmp, "world1", env)
        # FSDP in a world of one shards nothing: bit-equal to no group
        env["MASTER_PORT"] = str(multihost.free_port())
        t0 = time.perf_counter()
        rows_f, w_f = _par_cli(tmp, "world1_fsdp", env,
                               ["lightning.trainer.fsdp_parameter_sharding=true"])
        fsdp_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    require(not dist.is_initialized(), "train_cli left its process group")
    (rows_a, w_a), (rows_1, w_1) = alone, world1
    require(rows_f == rows_a and torch.equal(w_f, w_a),
            f"FSDP in a world of one over NCCL is not bit-equal to no group: {rows_f} vs {rows_a}")
    for (step, a), (_, b) in zip(rows_a, rows_1):
        for k, x, y in zip(PAR_KEYS, a, b):
            require(np.isfinite(y) and abs(x - y) <= TRAIN_LOSS_RTOL * abs(x) + 1e-6,
                    f"world 1 over NCCL step {step} {k}: {y} vs {x} alone")
    require(all(r[1][2] > 0 for r in rows_1[1:]), f"d_weight not live: {rows_1}")
    loss_bit_equal = rows_a == rows_1
    out = {"losses_bit_equal": loss_bit_equal, "weights_bit_equal": torch.equal(w_a, w_1),
           "weights_max_rel_diff": float((w_a - w_1).abs().max() / w_a.abs().max()),
           "losses_max_rel_diff": max(abs(x - y) / max(abs(x), 1e-30) for (_, a), (_, b)
                                      in zip(rows_a, rows_1) for x, y in zip(a, b)),
           "losses": {"alone": rows_a, "world1_nccl": rows_1}, "keys": PAR_KEYS,
           "fsdp_world1_nccl_bit_equal_to_alone": True, "fsdp_world1_cli_s": fsdp_s}
    return out


def _rest_bytes(state) -> dict:
    """What this rank holds between steps, in bytes: the parameters of the
    net and the loss (LPIPS, the discriminator, logvar), their gradients and
    both optimizers' Adam moments."""
    params = list(state.net.parameters()) + list(state.loss.parameters())
    moments = [t for opt in (state.opt_ae, state.opt_disc) for st in opt.adam.state.values()
               for k, t in st.items() if k in ("exp_avg", "exp_avg_sq")]
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    return {"params": size(params), "grads": size(p.grad for p in params if p.grad is not None),
            "moments": size(moments)}


def _flat_weights(state, disc: bool = True) -> torch.Tensor:
    """The net's (and the discriminator's) weights end to end, each in its
    logical order (under FSDP gathered: a collective)."""
    out = []
    for m in (state.net, state.loss.discriminator)[: 2 if disc else 1]:
        if fsdp.is_sharded(m):
            buffers = {k for k, _ in m.named_buffers()}
            out += [v.reshape(-1) for k, v in m.state_dict().items() if k not in buffers]
        else:
            out += [p.detach().reshape(-1) for p in m.parameters()]
    return torch.cat(out)


def _step1(state) -> dict:
    """After each optimizer's first step, on the host: the net's and the
    discriminator's weights, and per optimizer its global gradient norm
    before the clip and the averaged gradient it stepped on, before the
    clip, as its consolidated Adam moments give it (mu / (1 - b1) and
    nu / (1 - b2) times the clip's inverse scale, once and squared), each
    parameter in its logical order (under ZeRO-1 or FSDP a collective).
    Undoing the clip keeps a wrong scale of the gradient visible."""
    out = {"weights": _flat_weights(state).cpu()}
    for name in ("opt_ae", "opt_disc"):
        opt = getattr(state, name)
        norm = float(opt.grad_norm)
        scale = max(norm / opt.grad_clip, 1.0)
        b1, b2 = opt.adam.param_groups[0]["betas"]
        sd = opt.state_dict()["adam"]["state"]
        for key, kind, factor in (("exp_avg", "grad", scale / (1 - b1)),
                                  ("exp_avg_sq", "grad_sq", scale * scale / (1 - b2))):
            out[f"{name}.{kind}"] = torch.cat([sd[i][key].reshape(-1).cpu()
                                               for i in sorted(sd)]).double().mul_(factor)
        out[f"{name}.grad_norm"] = norm
    return out


def _par_steps(state, step, batch, after_first=None) -> dict:
    """PAR_STEPS steps from ``state``: each step's PAR_KEYS, seconds, the
    launches, the peak memory of the steps and what the rank then holds;
    ``after_first`` is called with the state after step 1 (its gathers
    launch no counted kernel and stay out of the peak)."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rows, times, peak = [], [], 0
    for i in range(PAR_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append([float(metrics[k]) for k in PAR_KEYS])
        if i == 0 and after_first is not None:
            peak = torch.cuda.max_memory_allocated()
            after_first(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    return {"rows": rows, "step_s": times, "counts": read_counts(),
            "max_memory_allocated_bytes": max(peak, torch.cuda.max_memory_allocated()),
            "at_rest_bytes": _rest_bytes(state)}


def _parallel_rank(tmp: str) -> int:
    """(b), one rank (``python3 chip_smoke.py --parallel-rank DIR``, spawned
    with torch's launch environment): writes ``DIR/rank<r>.json``."""
    w = multihost.maybe_initialize()
    require(w.size == PAR_RANKS, f"world {w}")
    # ZeRO-1 and FSDP against unsharded: the same gradients
    torch.backends.cudnn.deterministic = True
    model, state, step, batch = _par_train()
    start, lr = state.step, state.opt_ae.adam.param_groups[0]["lr"]
    init = [{k: v.clone() for k, v in m.state_dict().items()} for m in (state.net, state.loss)]
    runs, first = {}, {}
    for zero1 in (False, True):
        if zero1:  # the same weights, draws and step, the moments sharded
            state.net.load_state_dict(init[0])
            state.loss.load_state_dict(init[1])
            state.opt_ae, state.opt_disc = make_optimizers(state.net, state.loss, lr, 1.0,
                                                           zero1=True)
            state.generator.manual_seed(1)
            state.step = start
        # the weights and gradients of step 1, kept on the host (off the
        # later runs' peaks)
        keep = None if zero1 else (lambda st: first.update(off=_step1(st)))
        run = _par_steps(state, step, batch, keep)
        flat = {"weights": torch.cat([p.detach().reshape(-1) for p in
                                      list(state.net.parameters())
                                      + list(state.loss.discriminator.parameters())])}
        for name in ("opt_ae", "opt_disc"):
            sd = getattr(state, name).state_dict()["adam"]["state"]
            for key in ("exp_avg", "exp_avg_sq"):
                flat[f"{name}.{key}"] = torch.cat([sd[i][key].to("cuda").reshape(-1)
                                                   for i in sorted(sd)])
        runs[zero1] = (run, flat)
    (off, f_off), (on, f_on) = runs[False], runs[True]
    diffs = {k: float((f_on[k] - v).abs().max() / v.abs().max()) for k, v in f_off.items()}
    digest = hashlib.sha256(torch.cat([p.detach().reshape(-1) for p in state.net.parameters()])
                            .cpu().numpy().tobytes()).hexdigest()
    held = {n: [list(getattr(state, n).shard_range)]
            + [float(m.double().sum()) for m in getattr(state, n).held_moments()]
            for n in ("opt_ae", "opt_disc")}
    del runs, f_off, f_on
    mgr = CheckpointManager(str(Path(tmp) / "ckpt"))
    t0 = time.perf_counter()
    saved_step = state.step
    mgr.save_last(state.step, state)
    mgr.close()
    save_s = time.perf_counter() - t0
    with switches(GDT_WINOGRAD="fused"):
        reset_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        fused = read_counts()
    require(np.isfinite(float(metrics["aeloss"])), "the fused step's loss is not finite")
    del state, metrics
    # FSDP: the same weights, draws and step, the parameters of the net,
    # LPIPS and the discriminator sharded with their gradients and moments
    net, loss = model.build_net(), model.build_loss()
    net.load_state_dict(init[0])
    loss.load_state_dict(init[1])
    net = net.to("cuda", memory_format=torch.channels_last)
    loss = loss.to("cuda", memory_format=torch.channels_last)
    del init
    shard_for_fsdp(net, loss)
    fstate = TrainState(start, net, loss, *make_optimizers(net, loss, lr, 1.0),
                        torch.Generator(device="cuda").manual_seed(1))
    fsdp_run = _par_steps(fstate, step, batch, lambda st: first.update(fsdp=_step1(st)))
    got, want = first.pop("fsdp"), first.pop("off")
    fsdp_run["step1_weights_max_abs_diff_over_lr"] = float(
        (got.pop("weights") - want.pop("weights")).abs().max()) / lr
    fsdp_run["step1_grad_norm"] = {k: want[k] for k in want if k.endswith(".grad_norm")}
    fsdp_run["step1_grad_norm_rel_diff"] = {
        k: abs(got[k] - v) / v for k, v in fsdp_run["step1_grad_norm"].items()}
    fsdp_run["step1_grad_max_rel_diff"] = {
        k: float((got[k] - v).abs().max() / v.abs().max())
        for k, v in want.items() if not k.endswith(".grad_norm")}
    del first, got, want
    fsdp_digest = hashlib.sha256(_flat_weights(fstate, disc=False).cpu().numpy().tobytes()
                                 ).hexdigest()
    mgr = CheckpointManager(str(Path(tmp) / "ckpt_fsdp"))
    t0 = time.perf_counter()
    fsdp_step = fstate.step
    mgr.save_last(fstate.step, fstate)
    mgr.close()
    fsdp_run["save_s"] = time.perf_counter() - t0
    with switches(GDT_WINOGRAD="fused"):
        reset_counts()
        fstate, metrics = step(fstate, batch)
        torch.cuda.synchronize()
        fsdp_run["fused_counts"] = read_counts()
    require(np.isfinite(float(metrics["aeloss"])), "the FSDP fused step's loss is not finite")
    fsdp_run["units"] = {name: [sum(u.numels()) for u in fsdp.units_of(m)] for name, m in (
        ("net", fstate.net), ("lpips", fstate.loss.perceptual_loss),
        ("disc", fstate.loss.discriminator))}
    fsdp_run["held_after_steps"] = any(u.held() for m in (fstate.net, fstate.loss.perceptual_loss,
                                                          fstate.loss.discriminator)
                                       for u in fsdp.units_of(m))
    with open(Path(tmp) / f"rank{w.rank}.json", "w") as f:
        json.dump({"rank": w.rank, "off": off, "on": on, "zero1_max_rel_diff": diffs,
                   "digest": digest, "step": saved_step, "held": held,
                   "save_s": save_s, "fused_counts": fused,
                   "fsdp": fsdp_run, "fsdp_digest": fsdp_digest, "fsdp_step": fsdp_step,
                   "lr": lr,
                   "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in
                                         ("jax", "jaxlib", "flax", "optax", "orbax",
                                          "generative_detection_tpu"))}, f)
    multihost.shutdown()
    return 0


def _two_ranks(tmp: Path) -> dict:
    """(b): one process at batch 16 first, then the two ranks, then their
    ZeRO-1 and FSDP checkpoints restored into that process's state."""
    runs = {}
    deterministic, bn = torch.backends.cudnn.deterministic, BatchStatsNorm.forward
    torch.backends.cudnn.deterministic = True  # as the ranks run
    try:  # F.batch_norm, then the ranks' batch-norm arithmetic (fp32 sums) in one process
        for rank_bn in (False, True):
            if rank_bn:
                BatchStatsNorm.forward = BatchStatsNorm._global_batch_norm
            model, ref, step, batch = _par_train()
            rows = []
            for _ in range(PAR_STEPS):
                ref, metrics = step(ref, batch)
                rows.append([float(metrics[k]) for k in PAR_KEYS])
            runs[rank_bn] = (rows, ref)
            del batch, metrics
    finally:
        torch.backends.cudnn.deterministic, BatchStatsNorm.forward = deterministic, bn
    (want, ref), (rank_bn_rows, _) = runs[False], runs.pop(True)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    multihost.spawn_ranks([str(REPO / "chip_smoke.py"), "--parallel-rank", str(tmp)], PAR_RANKS,
                          timeout=900, env=dict(os.environ, GDT_DIST_BACKEND="gloo"))
    ranks_wall = time.perf_counter() - t0
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(PAR_RANKS)]
    r0 = ranks[0]
    for r in ranks[1:]:
        require(r["off"]["rows"] == r0["off"]["rows"] and r["on"]["rows"] == r0["on"]["rows"]
                and r["digest"] == r0["digest"], "the two ranks logged different losses")
    require(r0["jax_modules"] == [], f"a rank imported {r0['jax_modules']}")
    def rel(rows):
        return [{k: abs(x - y) / max(abs(x), 1e-30) for k, x, y in zip(PAR_KEYS, w, g)}
                for g, w in zip(rows, want)]

    rel_ranks, rel_bn = rel(r0["off"]["rows"]), rel(rank_bn_rows)
    for k, rtol in PAR_GATED.items():
        require(rel_ranks[0][k] <= rtol,
                f"two ranks step 1 {k}: {rel_ranks[0][k]} relative from one process")
    require(want[0][2] > 0, "d_weight not live")
    for k, d in r0["zero1_max_rel_diff"].items():
        require(d <= ZERO1_REL, f"ZeRO-1 against unsharded: {k} differs by {d} relative")
    for run in ("off", "on"):
        for name in PAR_PATH:
            require(r0[run]["counts"][name] > 0, f"rank step ran no {name} kernel")
    for name in PAR_FUSED_PATH:
        require(r0["fused_counts"][name] > 0, f"rank fused step ran no {name} kernel")
    # FSDP against the unsharded run of the same ranks: the first step's
    # losses within FSDP_REL, the weights after it within FSDP_LR_BOUND lr,
    # its gradients within FSDP_GRAD_REL and FSDP_NORM_REL (printed first,
    # so that a failing run shows them all), the same launches, a shard at
    # rest
    f0 = r0["fsdp"]
    emit({"phase": "parallel_fsdp_step1", **{k: [r["fsdp"][k] for r in ranks] for k in (
        "step1_weights_max_abs_diff_over_lr", "step1_grad_max_rel_diff",
        "step1_grad_norm_rel_diff", "step1_grad_norm")}})
    for r in ranks[1:]:
        require(r["fsdp"]["rows"] == f0["rows"] and r["fsdp_digest"] == r0["fsdp_digest"],
                "the two FSDP ranks logged different losses")
    fsdp_rel = [{k: abs(x - y) / max(abs(x), 1e-30) for k, x, y in zip(PAR_KEYS, w, g)}
                for g, w in zip(f0["rows"], r0["off"]["rows"])]
    for k, d in fsdp_rel[0].items():
        require(d <= FSDP_REL, f"FSDP step 1 {k}: {d} relative from the unsharded ranks")
    for r in ranks:
        d = r["fsdp"]["step1_weights_max_abs_diff_over_lr"]
        require(d <= FSDP_LR_BOUND, f"FSDP weights after step 1: {d} lr from unsharded")
        for k, d in r["fsdp"]["step1_grad_max_rel_diff"].items():
            require(d <= FSDP_GRAD_REL[k.split(".")[0]],
                    f"FSDP step 1 {k}: {d} of its largest from unsharded")
        for k, d in r["fsdp"]["step1_grad_norm_rel_diff"].items():
            require(d <= FSDP_NORM_REL, f"FSDP step 1 {k}: {d} relative from unsharded")
        require(not r["fsdp"]["held_after_steps"], "an FSDP unit holds its full parameters")
        for kind, full in r["off"]["at_rest_bytes"].items():
            got = r["fsdp"]["at_rest_bytes"][kind]
            require(got <= full / PAR_RANKS * 1.01, f"FSDP holds {got} B of {kind}, of {full}")
    for name in COUNTED:
        require(f0["counts"][name] == r0["off"]["counts"][name],
                f"FSDP {name}: {f0['counts'][name]} launches, unsharded {r0['off']['counts'][name]}")
    for name in PAR_FUSED_PATH:
        require(f0["fused_counts"][name] == r0["fused_counts"][name] > 0,
                f"FSDP fused step {name}: {f0['fused_counts'][name]} launches")
    # the collective ZeRO-1 checkpoint into one process
    CheckpointManager(str(tmp / "ckpt")).restore(ref)
    digest = hashlib.sha256(torch.cat([p.detach().reshape(-1) for p in ref.net.parameters()])
                            .cpu().numpy().tobytes()).hexdigest()
    require(ref.step == r0["step"] and digest == r0["digest"],
            "the restored step or weights differ from the ranks'")
    for name in ("opt_ae", "opt_disc"):
        mu, nu = getattr(ref, name).held_moments()
        for r in ranks:
            (lo, hi), m_sum, n_sum = r["held"][name]
            got = [float(mu[lo:hi].double().sum()), float(nu[lo:hi].double().sum())]
            require(np.allclose(got, [m_sum, n_sum], rtol=1e-12, atol=0),
                    f"restored {name} moments over [{lo}, {hi}) differ from rank {r['rank']}'s")
    # the collective FSDP checkpoint into the same process
    CheckpointManager(str(tmp / "ckpt_fsdp")).restore(ref)
    digest = hashlib.sha256(torch.cat([p.detach().reshape(-1) for p in ref.net.parameters()])
                            .cpu().numpy().tobytes()).hexdigest()
    require(ref.step == r0["fsdp_step"] and digest == r0["fsdp_digest"],
            "the FSDP checkpoint restored other weights or another step than the ranks'")
    del ref, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"one_process_batch_16": want, "rel_diff_by_step": rel_ranks,
            "one_process_with_the_ranks_batch_norm_rel_diff_by_step": rel_bn,
            "ranks_wall_s": ranks_wall,
            **{k: r0[k] for k in ("off", "on", "zero1_max_rel_diff", "save_s", "fused_counts")},
            "per_rank_max_memory_allocated_bytes": {
                "zero1_off": [r["off"]["max_memory_allocated_bytes"] for r in ranks],
                "zero1_on": [r["on"]["max_memory_allocated_bytes"] for r in ranks],
                "fsdp": [r["fsdp"]["max_memory_allocated_bytes"] for r in ranks]},
            "per_rank_at_rest_bytes": {
                mode: [r[key]["at_rest_bytes"] for r in ranks]
                for mode, key in (("unsharded", "off"), ("zero1", "on"), ("fsdp", "fsdp"))},
            "fsdp": {"rows": f0["rows"], "rel_diff_by_step_from_unsharded_ranks": fsdp_rel,
                     "step_s": [r["fsdp"]["step_s"] for r in ranks],
                     **{k: [r["fsdp"][k] for r in ranks] for k in (
                         "step1_weights_max_abs_diff_over_lr", "step1_grad_max_rel_diff",
                         "step1_grad_norm_rel_diff")},
                     "step1_grad_norm_unsharded": f0["step1_grad_norm"],
                     "counts": f0["counts"], "fused_counts": f0["fused_counts"],
                     "save_s": f0["save_s"], "unit_elements": f0["units"],
                     "lr": r0["lr"]},
            "restored_into_one_process": True}


def _shard_detector() -> dict:
    """(c): each stored bf16 artifact as two replicas on cuda:0 against
    ``load_detector`` at batch 32."""
    out = {}
    inputs = [torch.as_tensor(a, device="cuda") for a in detector_inputs(32, 32)]
    for label in ("bf16", "bf16_fused"):
        blob = BLOBS.pop(label)
        one = load_detector(blob)
        two = shard_detector(blob, ["cuda:0", "cuda:0"])
        reset_counts()
        want = one(*inputs)
        torch.cuda.synchronize()
        once = read_counts()
        reset_counts()
        got = two(*inputs)
        torch.cuda.synchronize()
        twice = read_counts()
        halves = [one(*[a[i * 16:(i + 1) * 16] for a in inputs]) for i in range(2)]
        for k in range(3):
            require(torch.equal(got[k], torch.cat([h[k] for h in halves])),
                    f"shard_detector {label}: output {k} is not the replicas' slices")
        held = _hold_loaded(f"shard_detector {label}", "bfloat16", got, want)
        for name in COUNTED:
            require(twice[name] == 2 * once[name],
                    f"shard_detector {label} {name}: {twice[name]} launches, one replica "
                    f"{once[name]} at batch 32")
        lat = {"load_detector": [], "shard_detector": []}
        for i in range(PAR_REQUESTS + 3):
            for name, fn in (("load_detector", one), ("shard_detector", two)):
                t0 = time.perf_counter()
                fn(*inputs)
                torch.cuda.synchronize()
                if i >= 3:
                    lat[name].append(time.perf_counter() - t0)
        out[label] = {"batch": 32, "replicas": 2, "bit_equal_to_one_replica": held["bit_equal"],
                      "boxes_max_abs_diff": held["boxes_max_abs_diff"],
                      "launches_per_request": {k: v for k, v in twice.items() if v},
                      "p50_ms": {k: statistics.median(v) * 1e3 for k, v in lat.items()}}
        del one, two, blob
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_parallel() -> dict:
    """Data parallelism on the one card (see the comment above PAR_STEPS);
    returns the ranks' launch counts by run ("bf16", "fused",
    "shard_fused") for the kernels line."""
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="gdt_parallel_"))
    try:
        world1 = _world1_nccl(tmp)
        two = _two_ranks(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    shard = _shard_detector()
    emit({"phase": "parallel", "world1_nccl": world1,
          "note": "two ranks share one card over gloo (staged through the host): the step "
                  "times below are not a multi-GPU figure",
          "two_ranks_gloo_one_card": two, "shard_detector_two_replicas_one_card": shard,
          "phase_wall_s": time.perf_counter() - t0})
    return {"bf16": two["off"]["counts"], "fused": two["fused_counts"],
            "shard_fused": shard["bf16_fused"]["launches_per_request"],
            "fsdp": two["fsdp"]["counts"], "fsdp_fused": two["fsdp"]["fused_counts"]}


def _largest(cases, name, dtype=torch.bfloat16):
    """The ``dtype`` case of ``name`` with the most work (shape product)."""
    keys = [k for k in cases if k[0] == name and k[-1] == dtype]
    return cases[max(keys, key=lambda k: math.prod(cases[k]["shape"]))]


def wino_routed(wino: Counter, dtype=torch.bfloat16) -> dict:
    """The fused step's sites (h=w, C, CO) -> count per step that take each
    row-Winograd kernel in ``dtype``: every fused site the forward; the dgrad
    and the weight gradient where the JAX package's tile rules (by the
    dtype's item size) take the kernel, else cuDNN (XLA there)."""
    isz = dtype.itemsize
    return {
        "wino_rows": dict(wino),
        "wino_rows_dgrad": {k: n for k, n in wino.items()
                            if wr._pick_tile(k[0], k[0], k[2], k[1], isz, 4) is not None},
        "wino_wgrad": {k: n for k, n in wino.items()
                       if wr._wgrad_tile(k[0], k[0], k[1], k[2], isz, 4) is not None},
    }


def fused_routed(sites: Counter, dtype) -> dict:
    """The fused detector's B6 sites (h=w, C, CO) -> count per request that
    ``fused_conv.fused_eligible`` sends to the kernel in ``dtype`` (in fp32
    the 16x16x512->512 sites exceed the TPU kernel's VMEM budget and take
    the plain composite, as in the JAX package)."""
    return {k: n for k, n in sites.items()
            if fused_conv.fused_eligible((BATCH, k[0], k[0], k[1]), k[2], dtype)}


def site_sums(cases: dict, name: str, routed: dict, per: str,
              dtype=torch.bfloat16) -> dict:
    """Kernel ``name``'s ``dtype`` ms, the library call's and the bound
    summed over the sites of one ``per`` (each site's time times its count),
    and each site's numbers."""
    rows = [(n, cases[(name, *k, dtype)]) for k, n in sorted(routed.items())]
    return {
        f"{per}_ms": sum(n * r["kernel_ms"] for n, r in rows),
        f"{per}_library_ms": sum(n * r["library_ms"] for n, r in rows),
        f"{per}_bound_ms": sum(n * r["bound_ms"] for n, r in rows),
        "sites": [{"shape": r["shape"], "count": n, "ms": r["kernel_ms"],
                   "library_ms": r["library_ms"], "bound_share": r["bound_share"],
                   "max_err": r["max_err"]} for n, r in rows],
    }


def wino_step_sums(cases: dict, wino: Counter, dtype=torch.bfloat16) -> dict:
    """``site_sums`` of each row-Winograd kernel over one fused step."""
    return {name: site_sums(cases, name, routed, "fused_step", dtype)
            for name, routed in wino_routed(wino, dtype).items()}


def kernels_line(cases: dict, det: dict, det_fused: dict, train: dict, train_fused: dict,
                 train_fp32: dict, train_fused_fp32: dict, step_sums: dict, fit: dict,
                 plain: dict, par: dict):
    """One entry per kernel, with the numbers of its largest bf16 site (the
    forward kernels at batch 8, the backward kernels and B7/B8 at batch 16)
    and its launches on the main path that runs it: the detector (B1, B3),
    the fused detector (B6 and its affine), the train step (B2, B4c/d), the
    train step with GDT_WINOGRAD=fused (B7, B8); the fp32 split-precision
    forward (B1 in fp32 at (8, 4096, 256), and at (8, 256, 512) its C = 512
    kernel) and backward (B2 in fp32 at (16, 4096, 256), and at (16, 256,
    512) its C = 512 kernel) with their launches in the config's own fp32
    step; the bf16 backward's C = 512 kernel at (16, 256, 512) with its
    launches in the bf16 step (B2's bf16 entry counts every width); last the
    fp32 split-precision B6 (at 8x256x256x128->128, launches in the fused
    detector's fp32 request on the card), B8, and B7's forward and dgrad
    (at 16x128x128x256->128 and its dgrad, launches in the config's own
    fp32 step with GDT_WINOGRAD=fused, ``train_fused_fp32``). B5 is on
    no path of the port (the JAX package reaches it only from its
    availability probe, whose role the kernel check here plays): its bf16
    and fp32 entries. ``kernels_per_call`` device kernels
    run per counted call. B6-B8 also give their share of the bound and
    their times summed over a fused detector request's or a fused step's
    sites (``step_sums``, by (name, dtype)). ``fit_launches`` gives each
    kernel's launches in the training entry point's fit (run 1 of
    ``phase_fit_synthetic_smoke``, fp32), 0 for kernels it does not run.
    ``plain_launches`` gives them on the plain family's paths
    (``phase_plain_autoencoder``): a bf16 row over the 10 timed bf16 steps
    (B7, B8: the one GDT_WINOGRAD=fused step; B6 and its affine: predict
    under GDT_FUSE_INFERENCE=1), an fp32 row over the 5 timed fp32 steps
    (fp32 B7, B8: the fused fp32 step at 512^2), 0 where none runs it.
    ``parallel_launches`` gives them on the parallel phase's paths, counted in
    rank 0 of the two ranks sharing the card: its 3 bf16 steps at batch 8
    with ZeRO-1 off (B1-B4), its one GDT_WINOGRAD=fused step (B7, B8), and one
    batch-32 request of shard_detector's two replicas of the
    GDT_FUSE_INFERENCE=1 artifact (B6 and its affine). ``fsdp_launches``
    gives them in the same rank's 3 FSDP steps (B1-B4) and its one FSDP
    GDT_WINOGRAD=fused step (B7, B8)."""
    bf16, fp32 = torch.bfloat16, torch.float32
    src = "generative_detection_tpu_torch/csrc/"
    tpu = "generative_detection_tpu/ops/"
    det_n, fdet_n = det["launches"], det_fused["launches"]
    rows = (
        (cases[("group_norm", 256, 128, "silu", bf16)], "group_norm.cu", "norm.py:109,361,388",
         cases[("group_norm", 256, 128, "silu", bf16)]["kernels_per_call"],
         det_n["group_norm"]),
        (cases[("attention", 4096, 256, bf16)], "attention.cu", "attention.py:226", 1,
         det_n["attention"]),
        (_largest({k: v for k, v in cases.items() if k[1] != LONG_L}, "group_norm_bwd"),
         "group_norm_bwd.cu", "norm.py:448,473", 2, train["group_norm_bwd"]),
        (cases[max((k for k in cases if k[0] == "attention_bwd" and k[-1] == bf16
                    and k[1] != LONG_L), key=lambda k: k[1] * k[1] * k[2])],
         "attention_bwd.cu", "attention.py:251", 2, train["attention_bwd"]),
        (cases[("flash_attention", 4096, 256, bf16)], "attention.cu", "attention.py:92", 1, 0),
        (cases[("attention", 4096, 256, fp32)], "attention.cu", "attention.py:226", 2,
         train_fp32["attention_split"]),
        (cases[("flash_attention", 4096, 256, fp32)], "attention.cu", "attention.py:92", 2, 0),
        (cases[("attention_bwd", 4096, 256, fp32)], "attention_bwd.cu", "attention.py:251", 2,
         train_fp32["attention_split_bwd"]),
        (cases[("attention_bwd", 256, 512, fp32)], "attention_bwd.cu", "attention.py:251", 2,
         train_fp32["attention_split_bwd_512"]),
        (cases[("attention", 256, 512, fp32)], "attention.cu", "attention.py:226", 2,
         train_fp32["attention_split_512"]),
        (_largest(cases, "group_norm_affine"), "group_norm.cu", "norm.py:361",
         _largest(cases, "group_norm_affine")["kernels_per_call"], fdet_n["group_norm_affine"]),
        (_largest(cases, "fused_conv"), "conv3x3_wino.cu", "fused_conv.py:196", 1,
         fdet_n["fused_conv"]),
        (_largest(cases, "wino_rows"), "conv3x3_wino.cu", "winograd_pallas.py:252", 1,
         train_fused["wino_rows"]),
        (_largest(cases, "wino_rows_dgrad"), "conv3x3_wino.cu", "winograd_pallas.py:252", 1,
         train_fused["wino_rows_dgrad"]),
        (_largest(cases, "wino_wgrad"), "conv3x3_wgrad.cu", "winograd_pallas.py:430", 2,
         train_fused["wino_wgrad"]),
        (cases[("attention_bwd", 256, 512, bf16)], "attention_bwd.cu", "attention.py:251", 1,
         train["attention_bwd_512"]),
        (_largest(cases, "fused_conv", fp32), "conv3x3_wino.cu", "fused_conv.py:196", 2,
         det_fused["fp32_launches"]["fused_conv"]),
        (_largest(cases, "wino_wgrad", fp32), "conv3x3_wgrad.cu", "winograd_pallas.py:430", 2,
         train_fused_fp32["wino_wgrad"]),
        (_largest(cases, "wino_rows", fp32), "conv3x3_wino.cu", "winograd_pallas.py:252", 2,
         train_fused_fp32["wino_rows"]),
        (_largest(cases, "wino_rows_dgrad", fp32), "conv3x3_wino.cu", "winograd_pallas.py:252", 2,
         train_fused_fp32["wino_rows_dgrad"]),
    )
    entries = []
    for r, source, replaces, per_call, n in rows:
        entries.append({
            "name": r["name"], "route": "cuda", "source": src + source,
            "replaces": tpu + replaces, "launches": n, "max_abs_err": r["max_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": r["dtype"], "kernels_per_call": per_call,
        })
    entries[4]["on_main_path"] = entries[6]["on_main_path"] = False
    # the fit's counters, by row: the GroupNorm kernels serve both dtypes
    fit_rows = {0: "group_norm", 2: "group_norm_bwd", 5: "attention_split",
                7: "attention_split_bwd", 8: "attention_split_bwd_512", 9: "attention_split_512"}
    for i, e in enumerate(entries):
        e["fit_launches"] = fit[fit_rows[i]] if i in fit_rows else 0
    # the plain family's counters, by row: (run, counter)
    plain_rows = {0: ("bf16", "group_norm"), 1: ("bf16", "attention"),
                  2: ("bf16", "group_norm_bwd"), 3: ("bf16", "attention_bwd"),
                  5: ("fp32", "attention_split"), 7: ("fp32", "attention_split_bwd"),
                  8: ("fp32", "attention_split_bwd_512"), 9: ("fp32", "attention_split_512"),
                  10: ("predict", "group_norm_affine"), 11: ("predict", "fused_conv"),
                  12: ("fused", "wino_rows"), 13: ("fused", "wino_rows_dgrad"),
                  14: ("fused", "wino_wgrad"), 15: ("bf16", "attention_bwd_512"),
                  17: ("fused_fp32_512", "wino_wgrad"), 18: ("fused_fp32_512", "wino_rows"),
                  19: ("fused_fp32_512", "wino_rows_dgrad")}
    for i, e in enumerate(entries):
        run, counter = plain_rows.get(i, (None, None))
        e["plain_launches"] = plain[run][counter] if run else 0
    # the parallel phase's counters a rank, by row: (run, counter)
    par_rows = {0: ("bf16", "group_norm"), 1: ("bf16", "attention"),
                2: ("bf16", "group_norm_bwd"), 3: ("bf16", "attention_bwd"),
                10: ("shard_fused", "group_norm_affine"), 11: ("shard_fused", "fused_conv"),
                12: ("fused", "wino_rows"), 13: ("fused", "wino_rows_dgrad"),
                14: ("fused", "wino_wgrad"), 15: ("bf16", "attention_bwd_512")}
    for i, e in enumerate(entries):
        run, counter = par_rows.get(i, (None, None))
        e["parallel_launches"] = par[run].get(counter, 0) if run else 0
        # the same rank's 3 FSDP steps and its one FSDP fused step
        fsdp_run = {"bf16": "fsdp", "fused": "fsdp_fused"}.get(run)
        e["fsdp_launches"] = par[fsdp_run].get(counter, 0) if fsdp_run else 0
    for e, r in zip(entries, (row[0] for row in rows)):
        if "kernel" in r:  # the attention, GroupNorm forward and conv kernels
            e["kernel"], e["bound_share"] = r["kernel"], r["bound_share"]
        if "cuda_cores_bound_ms" in r:  # the fp32 split-precision conv kernels
            e["cuda_cores_bound_ms"] = r["cuda_cores_bound_ms"]
        if e["name"] == "group_norm_bwd":
            e["kernel"] = "gn_bwd_reduce_kernel + gn_bwd_dx_kernel"
            e["bound_share"] = r["bound_share"]
        sums = step_sums.get((e["name"], e["dtype"]))
        if sums:
            e.update({k: v for k, v in sums.items() if k != "sites"})
    return {"kernels": entries}


def main() -> int:
    name, smi = phase_device()
    phase_build()
    gn_train, attn_train = train_sites()
    sites = conv_sites()
    n_gn, n_attn = sum(gn_train.values()), sum(attn_train.values())
    n_b6, n_det_gn = sum(sites["detector"].values()), sum(sites["detector_gn"].values())
    wino = sites["train"]
    n_wino = sum(wino.values())
    # the backward takes the dgrad and weight-gradient kernels where the
    # JAX package's tile rules do, else cuDNN (XLA there)
    routed = wino_routed(wino)
    n_dgrad = sum(routed["wino_rows_dgrad"].values())
    n_wgrad = sum(routed["wino_wgrad"].values())
    emit({"phase": "sites", "train_group_norm": n_gn, "train_attention": n_attn,
          "group_norm_shapes": sorted([list(k) + [n] for k, n in gn_train.items()], key=str),
          "attention_shapes": sorted([list(k) + [n] for k, n in attn_train.items()]),
          "detector_fused_conv": n_b6, "detector_fused_group_norm": n_det_gn,
          "fused_conv_shapes": sorted([list(k) + [n] for k, n in sites["detector"].items()]),
          "train_winograd_fused": n_wino, "train_winograd_dgrad": n_dgrad,
          "train_winograd_wgrad": n_wgrad,
          "winograd_shapes": sorted([list(k) + [n] for k, n in wino.items()])})
    require(n_b6 > 0 and n_wino > 0, "no fused-conv site found")
    cases = phase_kernels(gn_train, attn_train, sites)
    phase_long_attention()
    step_sums = {}  # by (kernel name, dtype name)
    for dtype in (torch.bfloat16, torch.float32):
        wino_sums = wino_step_sums(cases, wino, dtype)
        emit({"phase": "winograd_fused_step_sums", "dtype": _dname(dtype), **wino_sums})
        # B6 over one fused detector request's sites at batch 8
        request = site_sums(cases, "fused_conv", fused_routed(sites["detector"], dtype),
                            "fused_request", dtype)
        emit({"phase": "fused_detector_request_sums", "dtype": _dname(dtype), **request})
        step_sums.update({(name, _dname(dtype)): v for name, v in wino_sums.items()})
        step_sums[("fused_conv", _dname(dtype))] = request
    det = phase_detector({"group_norm": GN_PER_FORWARD, "attention": ATTN_PER_FORWARD},
                         fuse=False)
    det_fused = phase_detector({"group_norm": n_det_gn, "attention": ATTN_PER_FORWARD,
                                "fused_conv": n_b6, "group_norm_affine": n_b6}, fuse=True,
                               fp32_fused=sum(fused_routed(sites["detector"],
                                                           torch.float32).values()))
    per_step = {"group_norm": n_gn, "group_norm_bwd": n_gn, "attention": n_attn,
                "attention_bwd": n_attn}
    # the bf16 backward's C = 512 kernel at the mid-block sites (fp32 there
    # takes the split-precision kernel)
    bf16_bwd_512 = {"attention_bwd_512": sum(n for (_, c), n in attn_train.items() if c == 512)}
    require(bf16_bwd_512["attention_bwd_512"] > 0, "no attention site at C = 512")
    train = phase_train({**per_step, **bf16_bwd_512}, "0")
    train_fused = phase_train(
        {**per_step, **bf16_bwd_512, "group_norm": n_gn - n_wino, "group_norm_affine": n_wino,
         "wino_rows": n_wino, "wino_rows_dgrad": n_dgrad, "wino_wgrad": n_wgrad}, "fused")
    # the config's own fp32 path: the detector, then the step; every
    # attention site runs split precision, forward and backward, at C <= 256
    # the narrow kernels and at C = 512 the wide ones
    n_split_det = sum(n for (_, c), n in ATTN_SITES.items() if c in SPLIT_NARROW)
    n_split_det_512 = sum(n for (_, c), n in ATTN_SITES.items() if c == 512)
    n_split = sum(n for (_, c), n in attn_train.items() if c in SPLIT_NARROW)
    n_split_512 = sum(n for (_, c), n in attn_train.items() if c == 512)
    require(n_split_det > 0 and n_split_det_512 > 0 and n_split > 0 and n_split_512 > 0,
            "no attention site takes one of the split-precision kernels")
    phase_detector_fp32({"group_norm": GN_PER_FORWARD, "attention": ATTN_PER_FORWARD,
                         "attention_split": n_split_det, "attention_split_512": n_split_det_512})
    train_fp32 = phase_train(
        {**per_step, "attention_split": n_split, "attention_split_512": n_split_512,
         "attention_split_bwd": n_split, "attention_split_bwd_512": n_split_512}, "0",
        fp32=True)
    # the same fp32 step with GDT_WINOGRAD=fused: fp32 B7 forward at every
    # fused site, its dgrad and B8 where the tile rules take them at 4-byte items
    routed_fp32 = wino_routed(wino, torch.float32)
    train_fused_fp32 = phase_train(
        {**per_step, "attention_split": n_split, "attention_split_512": n_split_512,
         "attention_split_bwd": n_split, "attention_split_bwd_512": n_split_512,
         "group_norm": n_gn - n_wino, "group_norm_affine": n_wino, "wino_rows": n_wino,
         "wino_rows_dgrad": sum(routed_fp32["wino_rows_dgrad"].values()),
         "wino_wgrad": sum(routed_fp32["wino_wgrad"].values())}, "fused", fp32=True)
    require(all(train_fused_fp32[k] > 0 for k in ("wino_rows", "wino_rows_dgrad", "wino_wgrad")),
            "the fused fp32 step launched no fp32 B7 or B8 kernel")
    phase_train_card_vs_cpu("0")
    phase_train_card_vs_cpu("fused")
    phase_train_card_vs_cpu(None, ch=None)  # the config's own width: attention at C = 64
    fit, fit_p50 = phase_fit_synthetic_smoke()
    phase_device_preprocess_and_eval({"train_bf16": train["result"]["p50_ms"],
                                      "train_fp32": train_fp32["result"]["p50_ms"]}, fit_p50)
    phase_export_and_interop(
        {b: r["p50_ms"] for b, r in det["results"].items()},
        {"bf16": {"group_norm": GN_PER_FORWARD, "attention": ATTN_PER_FORWARD},
         "bf16_fused": {"group_norm": n_det_gn, "attention": ATTN_PER_FORWARD,
                        "fused_conv": n_b6, "group_norm_affine": n_b6},
         "fp32": {"group_norm": GN_PER_FORWARD, "attention": ATTN_PER_FORWARD,
                  "attention_split": n_split_det, "attention_split_512": n_split_det_512}})
    plain = phase_plain_autoencoder()
    plain["fused_fp32_512"] = phase_plain_fused_fp32_memory()
    par = phase_parallel()
    emit(kernels_line(cases, det, det_fused, train, train_fused, train_fp32,
                      train_fused_fp32, step_sums, fit, plain, par))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(_parallel_rank(sys.argv[2]))
    sys.exit(main())
