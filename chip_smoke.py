"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
1. card, versions, and the build of the CUDA kernels from cris_tpu_torch/csrc;
2. K1 against its plain PyTorch version at B = 16 on the main path's
   shapes and at head dims 16, 48, 128 and 12, and at the train.py
   path's B 64 in bf16 (the decoder's self- and cross-attention of a val
   batch, each row's words drawn as phase 6 draws them, and attnpool's
   of a train step), f32 (rtol = atol = 1e-4)
   and bf16 (rtol = atol = 2e-2, mean |err| < 2e-3), each call on the
   route its dtype and head dim must take (bf16 at a head dim that is a
   multiple of 8: the tensor-core body; f32, and bf16 at head dim 12: the
   scalar one; its bf16 error is also printed against P rounded where
   the JAX kernel rounds it, before normalising, where the plain version
   rounds after), with CUDA-event times of kernel, plain version and SDPA,
   back to back and on the device alone;
3. CRIS-R50 at 416 px (word_len 17, 3 decoder layers, seeded random
   weights): one f32 batch of 2 on the card against the same model on the
   CPU (relative L2 of the logits <= 1e-4, mask agreement at 0.35 >= 0.999);
4. three requests through PredictService.predict in bf16 autocast (1, 5
   and 16 sentences: buckets 1, 8 and 16); each mask has its image's
   shape, the probabilities are finite, and K1 launched exactly 7 times
   per device batch (3 decoder layers x 2 sites + attnpool), every time
   on the tensor-core route.
5. K1's gradient (kernel forward, plain recompute backward) against
   autograd through its plain version at the R50 sites, B 16, and at
   attnpool at the train.py path's B 64 in bf16, at the phase-2
   tolerances (in units of a tensor's RMS where that exceeds 1;
   for bf16 inputs the reference runs in f32 on them), with forward +
   backward times;
6. K2 (attention dropout, forward and backward kernels) against its plain
   version with the same seed, at the decoder's self- and
   cross-attention, rate 0.1, at B 16, at the train path's B 32 (its
   cross-attention with each row's words drawn as the train batches draw
   them, 3 to 17 valid), at the train.py path's B 64 in bf16 (the same
   two sites), and at head dim 12: output and dq/dk/dv as in
   phase 5, each call on the route its dtype and head dim must take (bf16
   at a head dim that is a multiple of 8: the tensor-core kernels; f32,
   and bf16 at head dim 12: the scalar ones; the counts per route equal
   the calls per route); rate 0 equals K1; one seed gives the same bits,
   another seed other bits; the backward kernels alone give the autograd
   path's bits; the tensor-core forward's packed keep mask equals
   keep_bits_packed; the bf16 gradients' error against the JAX backward's
   rounding points (attention_dropout_backward_plain) is printed; the
   keep fraction within 6 sigma of 0.9, of the scalar forward and of the
   packed mask; the
   forward's row counts and the backward's column counts of the mask equal
   the plain mask's (uniform attention, V = 1, dO = 1); times of forward,
   backward alone and both (forward and backward also on the device
   alone), and of SDPA with dropout (forward and backward, also on the
   device alone, and both; its backend printed) at every site;
7. the R50 f32 train step at dropout 0, batch 8: card against CPU (loss
   relative error <= 1e-4; the gradients' global relative L2, over all
   tensors and over the head, within 1e-3 plus 1.6 times the CPU's own
   spread with oneDNN off, which these random weights make about 3.5%,
   and each tensor within 1e-3 of its norm plus twice that spread on it,
   factors set from cris_tpu_torch/grad_spread.py's readings); three
   planted faults must fail those bars;
8. R50 training in bf16 autocast at dropout 0.1, batch 32, 8 steps on
   seeded batches: finite losses and gradients, BN running statistics
   move, group learning rates 1e-5 / 1e-4, and per step K2 forward and
   backward 6 launches each (3 layers x 2 sites) and K1 one (attnpool),
   every one on the tensor-core route;
   the median step time of steps 3-8 and the peak memory.
9. K5 (fused bottleneck) and K7 (fused stem + pool) against their plain
   versions at B 16, f32 (TF32 off) and bf16, at the phase-2 bars in
   units of the reference's RMS: K5 at each R50 tail shape (104^2 x
   256/64, 52^2 x 512/128, 26^2 x 1024/256, 13^2 x 2048/512) on the whole
   image, so the bands at both image edges and a short last band (13 and
   26 rows) are covered, once more on a contiguous NHWC input (the same
   bits); each K5 call on the route bottleneck_route gives and counted
   on it (bf16: the tensor-core body, with its plan of tiles and band;
   f32: the staged body); K7 on 416^2 images (once more contiguous
   NHWC: the same bits), each call on the route
   stem_route gives and counted on it (bf16: the tensor-core body, with
   its plan of tile and grid, and every candidate tile giving the plan's
   bits, each timed; f32: the staged body), on a 100 x 76 one (partial
   tiles) on both routes in bf16, and at bf16 widths 24/24/40 (the
   staged body) and 16/48/32 (the tensor-core body's generic form). The
   card's L2 rate on a copy that stays in L2, and K5's tensor-core body's
   L2 weight traffic at its plan over that rate.
   CUDA-event times of kernel, plain version, and the cuDNN chain that
   the folded model runs with the switch off (library_ms), kernel and
   cuDNN chain also on the device alone, and the sum of a b16 bf16
   forward's 12 K5 launches;
10. the BN-folded serving path, with BN statistics and affines made
   non-trivial from a seed: (a) the R50 f32 folded forward with K5 and K7
   on the card against the unfolded eval forward on the CPU (relative L2
   <= 1e-4), 12 K5 (f32 takes every tail) and 1 K7 launches; (b) three
   requests through PredictService(fold_bn, fused_bottleneck, fused_stem)
   in bf16, with as many K5 launches per device batch as K5's tail gate
   takes tails at its default rule (5: the 104^2 and 52^2 tails), 1 K7
   (every one on its tensor-core body) and 7 K1; (c) the b16 bf16 forward
   on CUDA events, unfolded / folded / folded + K5 / folded + K5 + K7, in
   turns.
11. the JAX package's public kernel API, K3 (fused_attention on (B, H, S,
   D)), K4 (fused_matmul, conv1x1_fused) and K6 (layer_norm forward and
   backward), at B 16, f32 (TF32 off) and bf16, against their plain
   versions at the phase-2 bars in units of the reference's RMS (K6's
   dscale and dbias also within their f32 sums' own rounding): K3 at the
   decoder's self- and cross-attention, attnpool and an odd shape, its
   gradient at the self-attention, and on head views of K1's (B, S, E)
   rows with K1's bits; K4 at four folded R50 1x1 convs, the decoder
   FFN's fc1 and fc2 and the JAX test's ragged (300, 70) -> 130; K6 at the
   decoder's, the FFN's and the text encoder's LN widths; then K6 on the
   inputs of every decoder LayerNormF32 and K4 on every FFN fc1's, as one
   b16 bf16 folded R50 forward ran them (forward hooks), against the
   modules' outputs. Each count equals the calls made. Each K3 and K4
   call's route is asserted and printed: bf16 takes the tensor-core body
   (K3) and the TMA-fed wgmma GEMM (K4: every bf16 site, the model's
   fc1s with w as the K-major weight.t()), f32 and the ragged (300, 70)
   the scalar body and the staged GEMM; the counts per route equal the
   calls per route. CUDA-event times of kernel, plain version and library
   call (SDPA, the cuBLAS chain, F.layer_norm and its backward), back to
   back and on the device alone (device_ms: the host enqueues while the
   card sleeps).
12. the bench (cris_tpu_torch.bench): its host metric
   (host_input_pipeline_640x480; a failure fails the phase), then its
   three device metrics at short lengths
   (n1 2, n2 4, 2 trials), each value finite and positive, with K1's
   launches per eval batch (7, R50 and R101) and K2's forward and
   backward (6 each) and K1's (1) per train step, every one on the
   tensor cores; its K5/K7 A/B at one round, each arm's K5 and K7
   launches per batch as K5's tail gate gives them (K7 on arm d only),
   all on the tensor cores; and R101's first check on the card, its f32
   folded forward at B 1 against the unfolded CPU forward (relative L2
   <= 1e-4, mask agreement >= 0.999).
13. the test.py path (python3 -m cris_tpu_torch.test): the host data
   library built here from csrc/image_codec.cc and csrc/batch_preprocess.cc
   decodes an embedded 4:2:0
   JPEG to the sha256 of cv2.imdecode's output; seed-0 random CRIS-R50
   weights saved as best_model.pth in a temporary output directory; the
   first device batch of 64 (image, sentence) pairs through the folded
   f32 model on the card against the same on the CPU (relative L2 of the
   probabilities <= 1e-4); then the entry's main over
   synthetic://64?seed=0 at 416 px, batch_size_val 64, bf16, BN folded:
   IoU, Pr@50..90 and oIoU finite in [0, 1], every pair scored, K1 7
   times a device batch, every launch on the tensor cores, and pairs per
   second on the host clock with the card's busy share.
14. the train.py path (python3 -m cris_tpu_torch.train) at CRIS-R50, 416
   px, bf16, dropout 0.1, b64: (a) a seeded RN50 CLIP traced into a
   TorchScript archive with a released archive's scalar entries, passed
   as clip_pretrain: the inferred config is the RN50 preset and the built
   backbone the traced weights bit for bit; (b) main over
   synthetic://128?seed=1 (2 steps an epoch) and synthetic://64?seed=2,
   no mask_root, 2 epochs, milestone 1, each of its 6 batches of 64
   (train and val) preprocessed by one call of the native data plane
   (RefDataset.get_batch -> data/native.py): finite losses, the logged and
   the groups' learning rates on the schedule, per step K2 6 + 6 and K1
   1 launches and K1 7 per val batch, all on the tensor cores,
   last_model.pth and best_model.pth written, best_model.pth through
   cris_tpu_torch.test.load_model gives finite probabilities, and its
   "=> run:" line; (c) a resume to 3 epochs: logged at epoch 2, the
   scheduler at step 4 and the optimizer state equal to the saved one
   before the first step, the best IoU carried forward; (d) an f32 b8
   step with remat on and off from one set of weights and one seed: the
   gradients within phase 7's bars of each other, the BN statistics
   equal; a bf16 b64 step's peak memory with and without remat.
15. the native data plane on the card's host (data/native.py,
   csrc/batch_preprocess.cc): (a) the data library built from
   cris_tpu_torch/csrc; (b) 1280 records of the bench's 640 x 480 JPEG
   images and PNG masks (data/host_bench.make_test_jpegs, 20 seeds on a
   pool of processes) written with write_refpack; RefDataset.get_batch
   (one plane call) against the per-sample __getitem__ on the first 64,
   train and val: every array np.array_equal; (c)
   host_input_pipeline_640x480 (measure_host_pipeline's defaults: 64
   images, the plane on all threads and on one, 24 per sample) with the
   host's cores and CPU model; (d) python3 -m cris_tpu_torch.train at R50
   b64 bf16 over the 1280 records (20 steps, 1 epoch, the first 64 as the
   val set, the profiler window on), the plane, then CRIS_NATIVE=0, one
   run each: each run's img/s, the
   profiler window's busy share (traced), K1 27 and K2 120 + 120
   launches all on the tensor cores, and 21 plane calls (none under
   CRIS_NATIVE=0).
16. data parallel (cris_tpu_torch/parallel): (a) K2 at the train.py
   batch's self-attention as a rank of 2 runs it, local batch 32 at batch
   offsets 0 and 32, f32 (scalar kernels) and bf16 (tensor-core kernels):
   output and gradients against the plain version with the same offset at
   phase 6's bars, the packed keep mask equal to keep_bits_packed at the
   offset and to rows 32:64 of the B 64 mask bit for bit, times on the
   device alone; (b) 2 ranks on the one card over gloo (NCCL refuses two
   ranks on one device; torch multiprocessing, init_distributed(backend=
   "gloo")), R50 f32, dropout 0, global batch 8: one
   DistributedDataParallel + synced-BN step against one process, held to
   bars around the one process's own rounding spread (its step with
   cuDNN off), as phase 7 holds the card to the CPU: loss within 1e-4
   relative, gradients within phase 7's bars, each BN running statistic
   within 1e-5 plus 2 own spreads, statistics and gradients equal on the
   ranks; the gaps printed beside 2e-5, 1e-4 and 1e-5; each rank's half
   stepped alone (BN without the sync) must fail the bars; then
   Evaluator.validate over the 2 ranks against one process (IoU,
   Pr@50..90, oIoU within 1e-6); (c) torchrun
   --nproc_per_node=<cards> -m cris_tpu_torch.train over NCCL at R50 b64
   bf16, 1 epoch of 4 steps over the bench's JPEG records: its run line's
   world_size and images, and per rank K1 11 and K2 24 + 24 launches, all
   on the tensor cores (on one card it says that no multi-card rate was
   measured).
17. the HTTP front and the predict entry (cris_tpu_torch.serving,
   python3 -m cris_tpu_torch.predict): (a) the committed fixtures of
   tests/torch_codec_fixtures (a 640 x 480 progressive 4:2:0 JPEG and its
   baseline twin, RGBA, 4-bit palette, 16-bit gray and Adam7 PNGs) decode
   to the sha256 digests OpenCV gave (digests.json) under both flags, and
   the progressive fixture's host decode time beside its twin's; (b)
   make_server over an R50 PredictService (416 px, bf16, BN folded,
   seed-0 weights read from best_model.pth) on a thread: /healthz, the
   progressive JPEG with 3 sentences (rle), the RGBA PNG with 1 (png_b64),
   an image_path request, {} and undecodable bytes (400 each), then 20
   requests of 1 and 20 of 4 sentences (median and p90 on the host clock);
   K1 7 times a device batch, all on the tensor cores; every mask equal to
   PredictService.predict on the decoded image; predict alone on this
   thread and from a fresh thread a call, and a b1 device batch on one
   thread against a fresh thread a call; (c) python3 -m
   cris_tpu_torch.predict at R50 on the card with the same weights: two
   masks (0 / 255, the image's size) and two overlays, each the JPEG of
   its mask's blend.
18. int8 serving (precision int8: bf16 with the three graph rewrites and
   the int8 sites on K8, cris_tpu_torch/csrc/int8_conv.cu: a quantise
   pass once a site, then the wgmma GEMM): (b) python3 -m
   cris_tpu_torch.quantize over synthetic://32 at R50 seed-0 weights (2
   batches of 16, the default gates: plain-conv sites at 64 channels,
   pooled and upfold ones at 256) writes quant_scales.npz; PredictService
   at precision int8 loads it (every site of the file engaged) and
   answers 3 requests (1, 5, 16 sentences): one int8_quantize at every
   engaged site of each device batch and one K8 GEMM (a phase site four
   on the one quantised input), K1 7 a batch on the tensor cores, no
   plain version called, the request times, and the masks' IoU against
   the bf16 service's on the same weights; (a) at every int8 site shape
   of those device batches, B 16, B 8 and B 1 (the input's dtype and
   memory layout as the model hands it over): the quantise pass
   bit-equal to its plain version and the GEMM's output bit-equal to the
   plain conv's, a flipped bit of the packed weights and the levels of a
   quantise pass at the scale x 1.0001 caught; the site's plan (tile,
   loader, split, grid) against the other tile height and splits, each
   bit-equal and timed, and split-K against no split summed per batch;
   CUDA-event times on the device alone of the quantise pass, the
   GEMM and their sum, back to back of the pair, of the plain versions,
   cuDNN's bf16 conv of the shape and torch._int_mm on the GEMM's own
   int8 operands at the 1x1 sites, beside the bounds (bytes over 3.35
   TB/s or operations over 1,979 int8 TOPS); the sums over the B 16
   forward;
   (c) the R50 int8 forward at f32 compute (no autocast) on the card
   against the CPU's, whose quantise passes and int8 convs are the plain
   versions, on the same scales: the share of int8 levels that differ at
   the sites and the logits' relative L2 under bars set from the measured
   flip rates; then teacher-forced on the CPU's values: each card
   quantise pass on the CPU's input to it, and each GEMM on the CPU's
   levels, bit-equal to the CPU's result, and, with every call returning
   the CPU's result, the card's input to each quantise pass within 1e-5
   relative L2 of the CPU's (the card's code between two sites: the
   stem, the pools, the folds' borders, the attention, the casts); two
   planted faults (one site's scale x 1.05, one fold's top border row x
   1.001) caught by the two checks; (d) the bench at short lengths (n1 2,
   n2 4, 2 trials): the R50 bf16 eval metric, the int8 pair
   (cris_r50_eval_int8_throughput_416px_b32, _b16) with K8's GEMMs and
   quantise passes per batch, --ab rewrites at one round, and each
   rewrite against the reference order at its b16 shapes (the stem,
   layer2_0, the four upsample folds): outputs at the bf16 bars, times.
19. dataset preparation on the card's machine, without OpenCV: (a) a
   root in the released REFER layout from a seed (128 JPEGs at 640 x 480,
   256 refs in train 192, val 32, testA 16 and testB 16 with 1 to 3
   sentences, COCO-like polygons of 8 to 60 vertices in 1 to 3 parts, a
   tenth uncompressed and a tenth compressed RLE; refs(unc).p and
   instances.json); (b) python3 -m cris_tpu_torch.data_process with
   masks, .folder2pack for each split and .prewarp of train and val (val
   --keep-ori) in subprocesses: the record counts, every mask PNG equal
   to REFER.getMask's mask, the committed polygons of
   tests/torch_prep_fixtures rasterised to cv2.fillPoly's sha256
   digests, refs/s a stage; (c) the first b16 train batch of the
   prewarped pack equal to the raw pack's through the native data plane,
   bit for bit; (d) python3 -m cris_tpu_torch.train at R50 416 px bf16,
   seeded weights, b16, from the prewarped train pack, 1 epoch of 12
   steps, validating on the prewarped val pack with its masks (finite
   losses, K2 6 + 6 and K1 1 a step and 7 a val batch, all on the tensor
   cores), then python3 -m cris_tpu_torch.test on the val pack (an IoU
   line, pairs/s, K1 7 a batch).
The last lines are a JSON summary of the kernels (with each one's bound:
the larger of its bytes over 3.35 TB/s and its operations over the peak
of their type, 989 TFLOP/s bf16 or 67 TFLOP/s f32, and for K2 also its
Philox work, 40 integer multiplies a call over 16.7 Tops/s; K5 with its
L2 weight-traffic term beside; K1-K7 timed on the device alone, with
their back-to-back times beside; K1-K5 and K7 with their launches per
route, K7 with its plan, K2 with its phase 16 offset cases),
the card's name and power limit, and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --phases 1,9    # a subset; prints no summary
    python3 chip_smoke.py --phases 2,11   # the routes of K1, K3 and K4
    python3 chip_smoke.py --phases 6,8    # K2 on both routes, the train step
    python3 chip_smoke.py --phases 9      # K5 and K7: routes, plans, times
    python3 chip_smoke.py --phases 12     # the bench at short lengths, R101
    python3 chip_smoke.py --phases 13     # the test.py path, the codec
    python3 chip_smoke.py --phases 14     # the train.py path through the
                                          # native data plane, resume, remat
    python3 chip_smoke.py --phases 15     # the plane on the card's host,
                                          # the host metric, the train A/B
    python3 chip_smoke.py --phases 16     # data parallel: K2's offset, 2
                                          # gloo ranks, torchrun over NCCL
    python3 chip_smoke.py --phases 17     # the decoder fixtures, the HTTP
                                          # front, the predict entry
    python3 chip_smoke.py --phases 18     # int8 serving: quantize, K8 at
                                          # every site, f32 card vs CPU
    python3 chip_smoke.py --phases 19     # dataset preparation, then train
                                          # and test from its packs
"""

import argparse
import base64
import contextlib
import copy
import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NVSMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
B = 16
# (site, S, T, H, D, masked keys at the end of each row)
SHAPES = [
    ("decoder self-attn", 676, 676, 8, 64, 0),
    ("decoder cross-attn, 17 words", 676, 17, 8, 64, 5),
    ("decoder cross-attn, 22 words", 676, 22, 8, 64, 0),
    ("attnpool", 169, 169, 32, 64, 0),
    ("odd", 100, 37, 4, 32, 6),
    # head dims off the R50 path: cris_tiny's decoder (64 / 4 heads), one
    # padded to the next tile width, and the widest the gate admits
    ("head dim 16 (cris_tiny decoder)", 16, 17, 4, 16, 5),
    ("head dim 48", 100, 37, 4, 48, 6),
    ("head dim 128", 676, 676, 4, 128, 0),
    # a head dim the tensor-core gate refuses: bf16 on the scalar body
    ("head dim 12 (scalar body)", 100, 37, 4, 12, 6),
]
BOTH = (torch.float32, torch.bfloat16)
BF16 = (torch.bfloat16,)
# the train.py path's batch: cris_r50_refcoco().batch_size and
# batch_size_val (phase 14 asserts it), where the model runs bf16
TRAIN_PY_B = 64
# K1's sites, (site, B, S, T, H, D, masked keys, dtypes): SHAPES at B 16,
# and the train.py path's at its batch, where "rows" draws each row's
# valid words as the train batches do (3 to 17): the decoder's in each
# val batch, attnpool's in each train step
K1_SITES = [(site, B, s, t, h, d, m, BOTH) for site, s, t, h, d, m in SHAPES] + [
    ("decoder self-attn, train.py val", TRAIN_PY_B, 676, 676, 8, 64, 0, BF16),
    ("decoder cross-attn, train.py val", TRAIN_PY_B, 676, 17, 8, 64, "rows",
     BF16),
    ("attnpool, train.py batch", TRAIN_PY_B, 169, 169, 32, 64, 0, BF16),
]
# K1's gradient at the R50 sites, and at attnpool in the train.py step
K1_GRAD_SITES = [(site, B, s, t, h, d, m, BOTH)
                 for site, s, t, h, d, m in SHAPES[:4]] + K1_SITES[-1:]
# K2's sites, in K1_SITES' form: the decoder's at B 16 with the same mask
# in every row, at the bench's train step's B 32 and at the train.py
# path's batch
K2_SITES = [(site, B, s, t, h, d, m, BOTH)
            for site, s, t, h, d, m in SHAPES[:3]] + [
    ("decoder self-attn, train batch", 32, 676, 676, 8, 64, 0, BOTH),
    ("decoder cross-attn, train batch", 32, 676, 17, 8, 64, "rows", BOTH),
    # a head dim the tensor-core gate refuses: bf16 on the scalar kernels
    ("head dim 12 (scalar body)", B, 100, 37, 4, 12, 6, BOTH),
    ("decoder self-attn, train.py batch", TRAIN_PY_B, 676, 676, 8, 64, 0,
     BF16),
    ("decoder cross-attn, train.py batch", TRAIN_PY_B, 676, 17, 8, 64, "rows",
     BF16),
]


# K5's sites on R50 at 416 px: (site, H, W, C, mid, launches per forward)
K5_SHAPES = [
    ("layer1 tail", 104, 104, 256, 64, 2),
    ("layer2 tail", 52, 52, 512, 128, 3),
    ("layer3 tail", 26, 26, 1024, 256, 5),
    ("layer4 tail", 13, 13, 2048, 512, 2),
]
# A 61 x 47 JPEG made with cv2.imencode (quality 90, 4:2:0, restart
# interval 2), and the sha256 of cv2.imdecode's BGR output for it
# (OpenCV 5.0.0, libjpeg-turbo 3.1.2): the codec built on the card must
# reproduce it. tests/test_torch_data.py holds both against cv2.
CODEC_JPEG_SHAPE = (47, 61, 3)
CODEC_JPEG_SHA256 = ("631d8935ae55513c9b5fd9e9f5d1292b"
                     "ac651f0073eaab81a5eead919dc52e56")
CODEC_JPEG_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoM"
    "DAsKCwsNDhIQDQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUEBQkFBQkUDQsN"
    "FBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBT/wAAR"
    "CAAvAD0DASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAA"
    "AgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkK"
    "FhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWG"
    "h4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl"
    "5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
    "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYk"
    "NOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOE"
    "hYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
    "5ebn6Onq8vP09fb3+Pn6/90ABAAC/9oADAMBAAIRAxEAPwD0r4cMvhnUluJU+ZiCrqAoUk9D"
    "j2PB9M13vjnUYfGGjyQWygy+X8m0YK5OODj65/H61k+K/DYsrRmt1dnOAQp5PX256Dk5/MCt"
    "r4S2EcZd9Qj8pVG8liMHGTnk/UdOvY1+VrPctzfLZZZl7bpyep+Y53RoYvO6eCknzvY+K/H3"
    "7L2qzeJJdTXPk792ShweSTg+vUEYr2b4J30OlC30dgI5lXy2yuCuF5AGOowc/wBa9F+PXxPg"
    "8O2E1rZ2wnJ4woHXn/7E8+g4r5g8PeM3tPFK6hcOI13lvL3bQOnsDnnHPp71/Q2T18dmGS0s"
    "BhVdUV/Vz9SwOSZvhsVSwtePuN6d/n1P/9DqP2iY/sViJcq5IyQp5zkAE5xj1/I/Xl/hv4Gu"
    "tf8ACk93CMEIXYhecnODnHHXP881teKZoviVp1vBAPMCgDgjLdCCR+Ofw9q9L+HcUHgnw0+n"
    "zp5RdQo3HCs3OP5fh9a9POKlOhg19a+NuzR0ZvxLieGc7llkVol8z46+zvaePJrBYnklllwZ"
    "GIJB6cjn0znvjrX1voXw+e+0a0lCsgKY4wM/5/rXkvjvwI2ka+/iBIXaItvA4PJ5/Hkc/T3p"
    "W/aW/sCNLAvjyPk2kdOB2PSvKzbhThKvGjVjVfM1rbv8tj8azLHZ5xNiZ1Mqgmk9bo//0fo7"
    "4YfFPwr491Y2IkSQMwXOQcHooA75Hcf41z/7TB1DwraCTw3v8tmAJTP3sdD7D/PSvkD4YfD/"
    "AMU/B/UYtTuppUt4m3lQSAG4yR6nB6c9vavsLwh8V9K8Y6N5F6iSSCPbtc5zxggDv/8AqNfK"
    "5PUyrhak85yzDqtSjpbofd0MkyrCYqOYNqdRfeeaeDrGDxT4buJdf/4+24MkgIJbA9OmT7f/"
    "AFvCfix4Gvba6mk0q3yquzNtHGQFAYnpnkCvRPil4zFh4jaz08tHDJIcrGoA64HQe31yDgdq"
    "7DSNU0uw0JdQvollAQFw7DBbv3wecd/yr9ey3MqeQ4Grm6l72MXuw7X7HvVMXgskUswzHEWb"
    "1in/AFof/9KP9km3v7G8L62nkIc4M+CGHcYyOcY6V1vxp+IcOl+KImspmNuhGQx4GOCMnp25"
    "GOnbiuW1r4p6brTyWeiLHDOQwz0I47Y79DXlXjWC9SwupJ2Ziq4+YAHoSBjnjAH+RX2XAlHH"
    "Y7H1KOe4X91JOzfnexGEy18TZ7Vz/MvdoWaUu/8AWh9X3nj3wx4u8CCzilT7eY8YBGMYwAQO"
    "Tx29u9fLOvfAjX9V1KW4tIJwrE7ioyc5PHb+teU/B3UNdtviFELiaZbMuR5ZJ2jpkgfl71+p"
    "XgfUfDsnh21e98tJ2QFt4Gd2Bnnn2/ya0p0cB4fYurFxWJU22r68vkfKUJZNg8RVU8Z7BX08"
    "13P/0y9+Ix+JEf2NginfknIHBz19eMD9cVh32m6j4HmMun+Y5m2nCfPhjnkZ57Ac+/1rB+Dm"
    "x9TQxyAAksHUHPTGDn3H+e/17pPgfT/E2lyebCDtUrk4yenGcfSujj2nluQ4OWGymlyUHuhZ"
    "r4oZHmGZwybAYbknLZ22PIfh58OLHx7NHf6nIFkXa2HyOenY56kivU/Fnwt0C60E2SXUUcJj"
    "8pQWwcge34fn6V89/FjxpqPw11U2elkwSM+0opAHH3sEdPXr1B/Hx/xv+0F4kg0ZJ4pWUynA"
    "56EZ6c+oJ/HFeNw2nxXg4yi7ewV0fN0MqxHE+PlTzGpzQpbfp/wD/9TmNe+HVl4I1KVrGYzk"
    "ng7shyB94cYzz/nNR6CIPFl9Fb37FQcYWQDGcdcjjuv+eK81+A/je/8AiLezLqWXjAbG9s45"
    "GT17Guj8e6jdeEfGqWlmSg3biucr9f1Azj0r2sf4iVVg1lUV++WnN5HkrjDDLNP9VXT/AHa2"
    "Pe9R+AVnofhsa5FDEZiOsYz79QP88njivA9Y+MGu6Nd/ZDFOwjGAN23Hb7uBjoK+tfhxrN54"
    "p8DJb3D+ZDhWI3HhcZIB646ce1co/wAHtEu7iaRrVJmdt5J+XBPGMfhj8K9jBcSZRh6CeaUe"
    "eXVn0cuDsgwr583oe1k/h8kf/9k="
)
HBM_BYTES_PER_S = 3.35e12
SM_HZ = 1.98e9  # the H100 SXM's top SM clock: a sleep's cycles at the least
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the card could take."""
    mem, ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(mem, ops) * 1e3, "bytes" if mem >= ops else "operations"


def card_line() -> str:
    out = subprocess.run(NVSMI, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of fn: the card sleeps while the host enqueues
    all the calls, then runs them back to back, so the host's time per
    call (a Python wrapper's checks and launch, tens of us) adds no gaps.
    The sleep is twice the host's enqueue time of the warm-up calls at the
    card's top clock, and must outlast the enqueue: if it does not, the
    run is repeated with a sleep four times as long."""
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    sleep_s = 2 * (time.perf_counter() - t0) / 3 * iters + 1e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(sleep_s * SM_HZ))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        if time.perf_counter() - t0 < sleep_s:
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters
        sleep_s *= 4
    raise RuntimeError("device_ms: the host's enqueue outlasted the sleep")


def reset_counts(*fns):
    """Set each wrapper's launch count, and its count per route where it
    has routes, to 0."""
    for fn in fns:
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def route_taken(fn, call):
    """(call's result, the one route whose count it raised)."""
    before = dict(fn.launches_by_route)
    result = call()
    taken = [r for r, n in fn.launches_by_route.items() if n != before[r]]
    assert len(taken) == 1, (fn.__name__, taken)
    return result, taken[0]


def expected_route(dtype, head_dim: int) -> str:
    """K1's, K2's and K3's route at every site of SHAPES, K2_SITES and
    K3_SHAPES (contiguous tensors): the tensor cores for bf16 at a head dim
    that is a multiple of 8, else the scalar body."""
    return ("tensor_cores" if dtype == torch.bfloat16 and head_dim % 8 == 0
            else "scalar")


def phase_kernel(fused, plain):
    """K1 vs its plain version, on the route its dtype must take; CUDA-event
    times back to back and on the device alone. Returns (rows,
    max_abs_err, the decoder self-attention's bf16 row)."""
    rows, worst = [], 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for site, b, s, t, h, d, masked, dtypes in K1_SITES:
        e = h * d
        q = torch.randn(b, s, e, device="cuda", generator=gen)
        k = torch.randn(b, t, e, device="cuda", generator=gen)
        v = torch.randn(b, t, e, device="cuda", generator=gen)
        valid = None
        if masked == "rows":
            valid = _word_valid(b, t)
        elif masked:
            valid = torch.ones(b, t, dtype=torch.bool, device="cuda")
            valid[:, t - masked:] = False
        for dtype in dtypes:
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            got, route = route_taken(fused, lambda: fused(qd, kd, vd, h, valid))
            assert route == expected_route(dtype, d), (site, dtype, route)
            ref = plain(qd, kd, vd, h, valid)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            if dtype == torch.float32:
                torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
            else:
                torch.testing.assert_close(got.float(), ref.float(),
                                           rtol=2e-2, atol=2e-2)
                assert err.mean().item() < 2e-3, (site, err.mean().item())
            # plain, kernel, kernel, plain: both see the same conditions
            p1 = cuda_ms(lambda: plain(qd, kd, vd, h, valid))
            k1 = cuda_ms(lambda: fused(qd, kd, vd, h, valid))
            k2 = cuda_ms(lambda: fused(qd, kd, vd, h, valid))
            p2 = cuda_ms(lambda: plain(qd, kd, vd, h, valid))
            lib = _sdpa(qd, kd, vd, h, valid)
            torch.testing.assert_close(lib().transpose(1, 2).reshape(ref.shape)
                                       .float(), ref.float(), rtol=2e-2,
                                       atol=2e-2)
            l1, l2 = cuda_ms(lib), cuda_ms(lib)
            # the same turns on the device alone: the tensor-core body runs
            # shorter than the wrapper's host time
            dp1 = device_ms(lambda: plain(qd, kd, vd, h, valid), 10)
            dk1 = device_ms(lambda: fused(qd, kd, vd, h, valid), 10)
            dk2 = device_ms(lambda: fused(qd, kd, vd, h, valid), 10)
            dp2 = device_ms(lambda: plain(qd, kd, vd, h, valid), 10)
            dl1, dl2 = device_ms(lib, 10), device_ms(lib, 10)
            es = qd.element_size()
            b_ms, b_by = bound(es * b * (2 * s + 2 * t) * e,
                               4.0 * b * h * s * t * d, dtype)
            row = dict(site=site, B=b, S=s, T=t, H=h, D=d, masked=masked,
                       dtype=str(dtype).replace("torch.", ""), route=route,
                       max_abs_err=err.max().item(),
                       mean_abs_err=err.mean().item(),
                       ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                       library_ms=(l1 + l2) / 2, device_ms=(dk1 + dk2) / 2,
                       plain_device_ms=(dp1 + dp2) / 2,
                       library_device_ms=(dl1 + dl2) / 2, bound_ms=b_ms,
                       bound_by=b_by)
            pallas_point = ""
            if route == "scalar" and dtype == torch.bfloat16:
                e2 = (got.float() - _pallas_rounding_reference(
                    qd, kd, vd, h, valid).float()).abs()
                row["vs_pallas_rounding"] = [e2.max().item(), e2.mean().item()]
                pallas_point = (f" (against P rounded where the JAX kernel "
                                f"rounds it: max {e2.max().item():.3e} mean "
                                f"{e2.mean().item():.3e})")
            worst = max(worst, row["max_abs_err"])
            rows.append(row)
            print(f"K1 {site:32s} {row['dtype']:8s} B={b} S={s} T={t} H={h} "
                  f"D={d} "
                  f"route {route} max|err|={row['max_abs_err']:.3e} "
                  f"mean|err|={row['mean_abs_err']:.3e}{pallas_point} "
                  f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms "
                  f"sdpa {row['library_ms']:.4f} ms; on the device alone "
                  f"kernel {row['device_ms']:.4f} ms plain "
                  f"{row['plain_device_ms']:.4f} ms sdpa "
                  f"{row['library_device_ms']:.4f} ms; bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
    main = next(r for r in rows if r["site"] == "decoder self-attn"
                and r["dtype"] == "bfloat16")
    return rows, worst, main


def _pallas_rounding_reference(q, k, v, h, valid):
    """K1's math with P rounded where the JAX kernel rounds it
    (`_attn_bse_kernel`, cris_tpu/ops/pallas/attention.py:148-157): the
    unnormalised p = exp(logits - row max) to v's dtype before P V, the
    row sum from the f32 p, out = (P V) / l. The plain version (the XLA
    path) rounds the normalised weights instead."""
    b, s, e = q.shape
    heads = [x.float().view(b, x.shape[1], h, e // h).transpose(1, 2)
             for x in (q, k, v)]
    logits = heads[0] @ heads[1].transpose(-1, -2) * (e // h) ** -0.5
    if valid is not None:
        logits = logits.masked_fill(~valid.bool()[:, None, None, :], -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = (p.to(v.dtype).float() @ heads[2]) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2).reshape(b, s, e).to(q.dtype)


def _sdpa(q, k, v, h, valid):
    """One call of F.scaled_dot_product_attention on K1's inputs (head
    views of the (B, S, E) rows; the output stays (B, H, S, D)), timed
    beside K1 as its library yardstick and used nowhere in the port."""
    b, s, e = q.shape
    heads = [x.view(b, x.shape[1], h, e // h).transpose(1, 2) for x in (q, k, v)]
    mask = None if valid is None else valid[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        *heads, attn_mask=mask)


def phase_model(cfg, build_segmenter, tokenize):
    """f32 R50 on the card against the same weights on the CPU."""
    model = build_segmenter(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 3, cfg.input_size, cfg.input_size, generator=gen)
    word = torch.from_numpy(tokenize(
        ["the man in the red shirt on the left", "a dog"], cfg.word_len,
        True)).long()
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = model(img, word)
        cpu_s = time.perf_counter() - t0
        model.cuda()
        got = model(img.cuda(), word.cuda())
        torch.cuda.synchronize()
    got = got.cpu()
    assert got.shape == (2, 1, cfg.input_size // 4, cfg.input_size // 4), got.shape
    assert torch.isfinite(got).all()
    rel = ((got - ref).norm() / ref.norm()).item()
    agree = ((torch.sigmoid(got) > 0.35) == (torch.sigmoid(ref) > 0.35)
             ).float().mean().item()
    print(f"R50 f32 card vs CPU: logits {tuple(got.shape)} rel L2 {rel:.3e} "
          f"mask agreement {agree:.6f} (CPU forward {cpu_s:.1f} s)", flush=True)
    assert rel <= 1e-4, rel
    assert agree >= 0.999, agree
    del model


def phase_serving(cfg, PredictService, counters, **service_args):
    """Three requests; ``counters`` maps a kernel's name to (its wrapper,
    launches per device batch). Returns ({name: launches}, latencies,
    {name: launches per route} for the wrappers that have routes)."""
    service = PredictService(cfg, device="cuda", max_batch=16, **service_args)
    batches = []
    inner = service.evaluator.predict_probs

    def checked(image, word):
        probs = inner(image, word)
        batches.append(image.shape[0])
        assert np.isfinite(probs).all(), "non-finite probabilities"
        return probs

    service.evaluator.predict_probs = checked
    rng = np.random.RandomState(0)
    requests = [((480, 640), 1), ((427, 640), 5), ((640, 480), 16)]
    words = ["the", "man", "left", "red", "shirt", "dog", "on", "a", "chair"]
    latencies = []
    reset_counts(*(fn for fn, _ in counters.values()))
    for (h, w), n in requests:
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        sents = [" ".join(rng.choice(words, 1 + i % 6)) for i in range(n)]
        t0 = time.perf_counter()
        results = service.predict(image, sents)
        latencies.append((time.perf_counter() - t0) * 1e3)
        assert len(results) == n
        for r in results:
            assert r["mask"].shape == (h, w) and r["mask"].dtype == bool
    launches = {name: fn.launches for name, (fn, _) in counters.items()}
    routes = {name: dict(fn.launches_by_route)
              for name, (fn, _) in counters.items()
              if hasattr(fn, "launches_by_route")}
    for ((h, w), n), b, ms in zip(requests, batches, latencies):
        print(f"request {h}x{w} with {n} sentences: bucket {b}, "
              f"latency {ms:.2f} ms", flush=True)
    assert batches == [1, 8, 16], batches
    for name, (_, per_batch) in counters.items():
        assert launches[name] == per_batch * len(batches), (name, launches)
        switches = sorted(k for k, v in service_args.items() if v is True)
        by_route = f", by route {routes[name]}" if name in routes else ""
        print(f"{name} launches on the serving path {switches}: "
              f"{launches[name]} ({len(batches)} device batches x "
              f"{per_batch}){by_route}", flush=True)
    # bf16 autocast: every K1, K5 and K7 site of the model takes the
    # tensor cores
    for name, by_route in routes.items():
        assert by_route["tensor_cores"] == launches[name], (name, by_route)
        assert sum(by_route.values()) == launches[name], (name, by_route)
    return launches, latencies, routes


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _check(got, ref, dtype, what):
    """Phase-2 tolerances, in units of the reference's RMS where that
    exceeds 1 (a key's gradient sums over 676 queries and is several units
    large; bf16 rounds it in proportion). Returns the max abs error."""
    scale = max(1.0, ref.float().square().mean().sqrt().item())
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * scale,
                                   msg=what)
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2 * scale, msg=what)
        assert err.mean().item() < 2e-3 * scale, (what, err.mean().item(), scale)
    return err.max().item()


def _reference(fn, q, k, v, g):
    """Output and gradients of the plain version, in f32 on the same
    inputs. In bf16 the plain version's autograd rounds dW to bf16 through
    the weights' cast; neither kernel path nor the JAX backward does, so
    the bf16 reference is the f32 computation on the bf16 inputs."""
    return _fwd_bwd(fn, *(x.float() for x in (q, k, v, g)))


def _fwd_bwd(fn, q, k, v, g):
    """Output and (dq, dk, dv) of fn(q, k, v) for the output gradient g."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(g)
    return out.detach(), q.grad, k.grad, v.grad


def _word_valid(b, t):
    """(b, t) key mask with each row's valid words drawn as the train
    path's batches draw them (make_batches: 3 to t valid, the rest
    padding)."""
    from cris_tpu_torch.profile_train import make_batches

    return make_batches(1, b, 8, t, "cuda", seed=9)[0]["word"] != 0


def _site_inputs(gen, b, s, t, h, d, masked, dtype, device="cuda"):
    e = h * d
    q, k, v = (torch.randn(b, n, e, device=device, generator=gen).to(dtype)
               for n in (s, t, t))
    g = torch.randn(b, s, e, device=device, generator=gen).to(dtype)
    valid = None
    if masked == "rows":
        valid = _word_valid(b, t)
    elif masked:
        valid = torch.ones(b, t, dtype=torch.bool, device=device)
        valid[:, t - masked:] = False
    return q, k, v, g, valid


def phase_k1_backward(fused, plain):
    """K1's autograd.Function against autograd through attention_plain."""
    rows, worst = [], 0.0
    gen = torch.Generator(device="cuda").manual_seed(5)
    for site, b, s, t, h, d, masked, dtypes in K1_GRAD_SITES:
        for dtype in dtypes:
            q, k, v, g, valid = _site_inputs(gen, b, s, t, h, d, masked, dtype)
            kern = lambda q, k, v: fused(q, k, v, h, valid)  # noqa: E731
            ref_fn = lambda q, k, v: plain(q, k, v, h, valid)  # noqa: E731
            got = _fwd_bwd(kern, q, k, v, g)
            ref = _reference(ref_fn, q, k, v, g)
            torch.cuda.synchronize()
            errs = [_check(a, b, dtype, f"K1 grad {site} {dtype} {n}")
                    for n, a, b in zip(("out", "dq", "dk", "dv"), got, ref)]
            p1 = cuda_ms(lambda: _fwd_bwd(ref_fn, q, k, v, g), 5)
            k1 = cuda_ms(lambda: _fwd_bwd(kern, q, k, v, g), 5)
            k2 = cuda_ms(lambda: _fwd_bwd(kern, q, k, v, g), 5)
            p2 = cuda_ms(lambda: _fwd_bwd(ref_fn, q, k, v, g), 5)
            row = dict(site=site, B=b, dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=max(errs), fwd_bwd_ms=(k1 + k2) / 2,
                       plain_fwd_bwd_ms=(p1 + p2) / 2)
            worst = max(worst, row["max_abs_err"])
            rows.append(row)
            print(f"K1 fwd+bwd {site:30s} B={b} {row['dtype']:8s} max|err| "
                  f"{row['max_abs_err']:.3e} (out, dq, dk, dv) kernel "
                  f"{row['fwd_bwd_ms']:.4f} ms  plain "
                  f"{row['plain_fwd_bwd_ms']:.4f} ms", flush=True)
    return rows, worst


def _sdpa_dropout(q, k, v, g, h, valid, rate):
    """F.scaled_dot_product_attention with dropout on K2's inputs: head
    views of the (B, S, E) rows, the key mask as a boolean (B, 1, 1, T)
    attn_mask, dropout_p = rate. The same work as K2, with PyTorch's own
    Philox stream (other bits). Returns (forward, backward alone, forward
    + backward, the backend PyTorch picks), timed beside K2 as its library
    yardstick and used nowhere in the port."""
    b, s, e = q.shape
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    heads = [x.view(b, x.shape[1], h, e // h).transpose(1, 2) for x in leaves]
    gh = g.view(b, s, h, e // h).transpose(1, 2)
    mask = None if valid is None else valid.bool()[:, None, None, :]
    F = torch.nn.functional

    def fwd():
        return F.scaled_dot_product_attention(*heads, attn_mask=mask,
                                              dropout_p=rate)

    out = fwd()

    def bwd():
        return torch.autograd.grad(out, leaves, gh, retain_graph=True)

    def both():
        return torch.autograd.grad(fwd(), leaves, gh)

    try:
        from torch.nn.attention import SDPBackend

        backend = SDPBackend(torch._fused_sdp_choice(
            *heads, attn_mask=mask, dropout_p=rate)).name
    except (AttributeError, TypeError, ValueError, RuntimeError) as err:
        backend = f"unknown ({type(err).__name__})"
    return fwd, bwd, both, backend


def _by_route_delta(fn, before):
    return {r: n - before[r] for r, n in fn.launches_by_route.items()}


def phase_k2(k2, k2_fwd, k2_bwd, plain_k2, plain_k2_bwd, k1, keep_mask,
             keep_bits_packed, rate=0.1):
    """K2 against its plain version with the same seed, each call on the
    route its dtype must take (bf16: the tensor-core kernels, f32: the
    scalar ones), the counts per route equal to the calls per route. The
    tensor-core forward's packed keep mask equals keep_bits_packed; its
    bf16 gradients are also held against attention_dropout_backward_plain
    (the JAX backward's rounding points), printed. The backward kernels
    are timed alone, on the output, log-sum-exp and bits of one forward,
    against torch.autograd.grad through the plain graph built by one
    forward; forward and backward also on the device alone; SDPA with
    dropout beside them."""
    rows, worst_fwd, worst_bwd = [], 0.0, 0.0
    gen = torch.Generator(device="cuda").manual_seed(6)
    frac_tc = None
    for site, b, s, t, h, d, masked, dtypes in K2_SITES:
        for dtype in dtypes:
            q, k, v, g, valid = _site_inputs(gen, b, s, t, h, d, masked, dtype)
            seed = 1234567 + b + s + t
            route = expected_route(dtype, d)
            kern = lambda q, k, v: k2(q, k, v, h, valid, rate, seed)  # noqa: E731
            ref_fn = lambda q, k, v: plain_k2(q, k, v, h, valid, rate, seed)  # noqa: E731
            before = (dict(k2.launches_by_route), dict(k2_bwd.launches_by_route))
            got = _fwd_bwd(kern, q, k, v, g)
            ref = _reference(ref_fn, q, k, v, g)
            torch.cuda.synchronize()
            what = f"K2 {site} {dtype}"
            e_fwd = _check(got[0], ref[0], dtype, what + " out")
            e_bwd = max(_check(a, b_, dtype, f"{what} {n}")
                        for n, a, b_ in zip(("dq", "dk", "dv"), got[1:], ref[1:]))
            with torch.no_grad():
                again = kern(q, k, v)
                other = k2(q, k, v, h, valid, rate, seed + 1)
                assert torch.equal(again, got[0]), what + ": not deterministic"
                assert not torch.equal(other, got[0]), what + ": seed ignored"
                _check(k2(q, k, v, h, valid, 0.0, seed), k1(q, k, v, h, valid),
                       dtype, what + ": rate 0 vs K1")
                out, lse, valid_u8, bits = k2_fwd(q, k, v, h, valid, rate, seed)
                bwd = lambda: k2_bwd(q, k, v, h, valid_u8, rate, seed,  # noqa: E731
                                     out, lse, bits, g)
                assert all(torch.equal(a, b_) for a, b_ in zip(bwd(), got[1:])), \
                    what + ": backward alone differs"
            # 5 forward calls (autograd, again, other seed, rate 0, alone)
            # and 2 backward calls (autograd, alone), all on one route
            fwd_routes = _by_route_delta(k2, before[0])
            bwd_routes = _by_route_delta(k2_bwd, before[1])
            assert fwd_routes == {r: 5 * (r == route) for r in fwd_routes}, \
                (what, fwd_routes)
            assert bwd_routes == {r: 2 * (r == route) for r in bwd_routes}, \
                (what, bwd_routes)
            extra = {}
            if route == "tensor_cores":
                want = keep_bits_packed(seed, b, h, s, t, rate, "cuda")
                assert torch.equal(bits, want), what + ": packed mask differs"
                del want
            else:
                assert bits is None, what
            if dtype == torch.bfloat16:
                # bf16 rows against the JAX backward's rounding points
                pb = plain_k2_bwd(q, k, v, h, valid, rate, seed, g)
                extra["bwd_max_abs_err_vs_bf16_plain"] = max(
                    (a.float() - b_.float()).abs().max().item()
                    for a, b_ in zip(got[1:], pb))
                del pb
            with torch.no_grad():
                pf1 = cuda_ms(lambda: ref_fn(q, k, v))
                kf1 = cuda_ms(lambda: kern(q, k, v))
                kf2 = cuda_ms(lambda: kern(q, k, v))
                pf2 = cuda_ms(lambda: ref_fn(q, k, v))
                mask_ms = cuda_ms(lambda: keep_mask(seed, b, h, s, t, rate, "cuda"))
                dkf1 = device_ms(lambda: kern(q, k, v), 10)
                dkf2 = device_ms(lambda: kern(q, k, v), 10)
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            out_p = ref_fn(qg, kg, vg)
            plain_bwd = lambda: torch.autograd.grad(  # noqa: E731
                out_p, (qg, kg, vg), g, retain_graph=True)
            pbo1 = cuda_ms(plain_bwd, 5)
            kbo1 = cuda_ms(bwd, 5)
            kbo2 = cuda_ms(bwd, 5)
            pbo2 = cuda_ms(plain_bwd, 5)
            dkb1, dkb2 = device_ms(bwd, 10), device_ms(bwd, 10)
            del out_p
            pb1 = cuda_ms(lambda: _fwd_bwd(ref_fn, q, k, v, g), 5)
            kb1 = cuda_ms(lambda: _fwd_bwd(kern, q, k, v, g), 5)
            kb2 = cuda_ms(lambda: _fwd_bwd(kern, q, k, v, g), 5)
            pb2 = cuda_ms(lambda: _fwd_bwd(ref_fn, q, k, v, g), 5)
            lf, lb, lboth, backend = _sdpa_dropout(q, k, v, g, h, valid, rate)
            with torch.no_grad():
                lf1, lf2 = cuda_ms(lf), cuda_ms(lf)
                dlf1, dlf2 = device_ms(lf, 10), device_ms(lf, 10)
            lb1, lb2 = cuda_ms(lb, 5), cuda_ms(lb, 5)
            dlb1, dlb2 = device_ms(lb, 10), device_ms(lb, 10)
            lbb1, lbb2 = cuda_ms(lboth, 5), cuda_ms(lboth, 5)
            del lf, lb, lboth
            lens = valid.sum(1).tolist() if valid is not None else [t]
            row = dict(site=site, B=b, S=s, T=t, H=h, D=d,
                       valid_keys=[min(lens), max(lens)],
                       dtype=str(dtype).replace("torch.", ""), rate=rate,
                       route=route, fwd_max_abs_err=e_fwd,
                       bwd_max_abs_err=e_bwd, **extra,
                       fwd_ms=(kf1 + kf2) / 2, plain_fwd_ms=(pf1 + pf2) / 2,
                       fwd_device_ms=(dkf1 + dkf2) / 2,
                       plain_mask_ms=mask_ms,
                       bwd_ms=(kbo1 + kbo2) / 2,
                       plain_bwd_ms=(pbo1 + pbo2) / 2,
                       bwd_device_ms=(dkb1 + dkb2) / 2,
                       fwd_bwd_ms=(kb1 + kb2) / 2,
                       plain_fwd_bwd_ms=(pb1 + pb2) / 2,
                       sdpa_backend=backend, sdpa_fwd_ms=(lf1 + lf2) / 2,
                       sdpa_fwd_device_ms=(dlf1 + dlf2) / 2,
                       sdpa_bwd_ms=(lb1 + lb2) / 2,
                       sdpa_bwd_device_ms=(dlb1 + dlb2) / 2,
                       sdpa_fwd_bwd_ms=(lbb1 + lbb2) / 2)
            for part in ("fwd", "bwd"):
                row[f"{part}_bound_ms"], row[f"{part}_bound_by"], \
                    row[f"{part}_bound_term"] = _k2_bound(
                        b, s, t, h, d, dtype, route, part == "bwd",
                        valid_keys=sum(lens) * (b // len(lens)))
            worst_fwd, worst_bwd = max(worst_fwd, e_fwd), max(worst_bwd, e_bwd)
            rows.append(row)
            vs_plain = ("" if "bwd_max_abs_err_vs_bf16_plain" not in row else
                        f" (vs the bf16 plain backward "
                        f"{row['bwd_max_abs_err_vs_bf16_plain']:.3e})")
            print(f"K2 {site:34s} B={b} T={t} valid keys {min(lens)}-"
                  f"{max(lens)} {row['dtype']:8s} route {route} max|err| out "
                  f"{e_fwd:.3e} grads {e_bwd:.3e}{vs_plain}; fwd kernel "
                  f"{row['fwd_ms']:.4f} ms (device alone "
                  f"{row['fwd_device_ms']:.4f}) plain "
                  f"{row['plain_fwd_ms']:.4f} ms (its keep mask alone "
                  f"{mask_ms:.4f} ms); bwd kernel {row['bwd_ms']:.4f} ms "
                  f"(device alone {row['bwd_device_ms']:.4f}) plain "
                  f"{row['plain_bwd_ms']:.4f} ms; fwd+bwd kernel "
                  f"{row['fwd_bwd_ms']:.4f} ms plain "
                  f"{row['plain_fwd_bwd_ms']:.4f} ms; SDPA with dropout "
                  f"({backend}) fwd {row['sdpa_fwd_ms']:.4f} (device alone "
                  f"{row['sdpa_fwd_device_ms']:.4f}) bwd "
                  f"{row['sdpa_bwd_ms']:.4f} (device alone "
                  f"{row['sdpa_bwd_device_ms']:.4f}) both "
                  f"{row['sdpa_fwd_bwd_ms']:.4f} ms; bound fwd "
                  f"{row['fwd_bound_ms']:.4f} ({row['fwd_bound_term']}) bwd "
                  f"{row['bwd_bound_ms']:.4f} ({row['bwd_bound_term']})",
                  flush=True)
            if masked == "rows":
                assert min(lens) <= 5 and len(set(lens)) >= 8, lens
            if route == "tensor_cores" and s == t and b == 32:
                # the keep fraction of the packed mask (its bits past T are 0)
                frac_tc = _popcount(bits) / (b * h * s * t)

    # uniform attention (q = k = 0), V = 1, dO = 1: out = row keep count
    # and dV = column keep count, each / (T (1 - rate)), per head
    _, s, t, h, d, _ = SHAPES[0]  # the decoder's self-attention at B 16
    zeros = torch.zeros(B, s, h * d, device="cuda")
    ones = torch.ones(B, t, h * d, device="cuda")
    out, _, _, dv = _fwd_bwd(
        lambda q, k, v: k2(q, k, v, h, None, rate, 77), zeros, zeros, ones,
        torch.ones_like(zeros))
    scale = t * (1.0 - rate)
    rows_k = (out[:, :, ::d] * scale).round().permute(0, 2, 1)  # (B, H, S)
    cols_k = (dv[:, :, ::d] * scale).round().permute(0, 2, 1)   # (B, H, T)
    mask = keep_mask(77, B, h, s, t, rate, "cuda")
    assert torch.equal(rows_k, mask.sum(-1).float()), "forward mask differs"
    assert torch.equal(cols_k, mask.sum(-2).float()), "backward mask differs"
    n = mask.numel()
    frac = rows_k.sum().item() / n
    sigma = ((1 - rate) * rate / n) ** 0.5
    print(f"K2 keep fraction {frac:.6f} (expected {1 - rate}, sigma "
          f"{sigma:.2e}, {abs(frac - (1 - rate)) / sigma:.2f} sigma); forward "
          f"row counts and backward column counts equal the plain mask's",
          flush=True)
    assert abs(frac - (1 - rate)) < 6 * sigma, frac
    n_tc = 32 * 8 * 676 * 676
    sigma_tc = ((1 - rate) * rate / n_tc) ** 0.5
    print(f"K2 keep fraction of the tensor-core forward's packed mask at the "
          f"B 32 self-attention: {frac_tc:.6f} "
          f"({abs(frac_tc - (1 - rate)) / sigma_tc:.2f} sigma)", flush=True)
    assert abs(frac_tc - (1 - rate)) < 6 * sigma_tc, frac_tc
    return rows, worst_fwd, worst_bwd, frac


def _popcount(words: torch.Tensor) -> int:
    """Set bits in an int32 tensor, by bytes through a 256-entry table."""
    table = torch.tensor([bin(i).count("1") for i in range(256)],
                         device=words.device)
    by = words.contiguous().view(torch.uint8).long()
    return int(table[by].sum().item())


def phase_train_card_vs_cpu(cfg, build_segmenter):
    """One f32 R50 train step at dropout 0 on the card and on the CPU.

    At these random weights the gradients are ill-conditioned: the CPU
    differs from itself by about 3.5% in global relative L2 when only
    oneDNN is switched off (about 0.8% in the head: neck, decoder,
    projector), far over a fixed 1e-3 (cris_tpu_torch/grad_spread.py says
    why and takes the readings). Batch 8, not 2: BN over 2 values (the
    neck's txt_proj) leaves channels whose batch variance is below the
    rounding of E[x^2] - E[x]^2, and at one seed in three the CPU then
    differs from itself by 185% on the text encoder's gradient when only
    its thread count changes. So the loss is held to 1e-4, and the
    gradients to grad_spread's bars around the CPU's own spread (oneDNN
    off against on, measured here). Three planted faults must fail those
    bars: one decoder gradient short by the dropout scale (x 0.9),
    txt_proj's gradient dropped, and every head gradient 1% small."""
    import copy

    from cris_tpu_torch.grad_spread import (GLOBAL_SPREADS, TENSOR_SPREADS,
                                            grad_faults, grad_rel,
                                            step_grads, tensor_need)
    from cris_tpu_torch.profile_train import make_batches

    cfg = copy.deepcopy(cfg)
    cfg.dropout = 0.0
    base = build_segmenter(cfg, device="cpu", seed=0, train=True)
    batch = make_batches(1, 8, cfg.input_size, cfg.word_len, "cpu", seed=7)[0]
    ref_loss, ref, cpu_s, _ = step_grads(base, cfg, batch, "cpu")
    loss, got, _, _ = step_grads(base, cfg, batch, "cuda")
    _, alt, _, _ = step_grads(base, cfg, batch, "cpu", onednn=False)
    assert np.isfinite(loss), loss
    rel_loss = abs(loss - ref_loss) / abs(ref_loss)
    names = list(ref)
    head = [n for n in names if not n.startswith("backbone.")]
    rel_grad, rel_head = grad_rel(got, ref, names), grad_rel(got, ref, head)
    spread, spread_head = grad_rel(alt, ref, names), grad_rel(alt, ref, head)
    need = tensor_need(got, ref, alt, names)
    faults = grad_faults(got, ref, alt, names, head)
    print(f"R50 f32 train step b8 card vs CPU: loss {loss:.6f} vs "
          f"{ref_loss:.6f} (rel {rel_loss:.3e}); gradients' global rel L2 "
          f"{rel_grad:.3e}, head {rel_head:.3e} ({len(head)} of {len(names)} "
          f"tensors); the CPU against itself with oneDNN off: {spread:.3e}, "
          f"head {spread_head:.3e} (ratios {rel_grad / spread:.3f}, "
          f"{rel_head / spread_head:.3f}; bar {GLOBAL_SPREADS}); largest "
          f"tensor need {need:.3f} own spreads (bar {TENSOR_SPREADS}); "
          f"{len(faults)} out of bounds; CPU step {cpu_s:.1f} s", flush=True)
    assert rel_loss <= 1e-4, rel_loss
    assert not faults, faults[:5]
    planted = {
        "decoder.layers.2.self_attn.in_proj_weight x 0.9": {
            "decoder.layers.2.self_attn.in_proj_weight": 0.9},
        "neck.txt_proj gradients dropped": {
            n: 0.0 for n in names if n.startswith("neck.txt_proj.")},
        "every head gradient x 0.99": {n: 0.99 for n in head},
    }
    for label, scales in planted.items():
        assert scales and set(scales) <= set(names), label
        bad = dict(got, **{n: got[n] * f for n, f in scales.items()})
        caught = grad_faults(bad, ref, alt, names, head)
        print(f"planted fault '{label}': {len(caught)} bars fail", flush=True)
        assert caught, f"phase 7's bars let a planted fault pass: {label}"
    return rel_loss, rel_grad, rel_head, spread


def phase_train_bf16(cfg, build_segmenter, engine, counters, steps=8, b=32):
    """bf16-autocast R50 training at dropout 0.1 with K2 on the decoder."""
    assert cfg.dropout == 0.1 and cfg.precision == "bf16"
    model = build_segmenter(cfg, device="cuda", seed=0, train=True)
    opt, sched = engine.make_optimizer(model, cfg, steps_per_epoch=100)
    lrs = [g["lr"] for g in opt.param_groups]
    assert np.allclose(lrs, [1e-5, 1e-4], rtol=1e-12), lrs
    bns = {n: buf.clone() for n, buf in model.named_buffers()
           if n.endswith("running_mean")}
    from cris_tpu_torch.profile_train import make_batches

    batches = make_batches(steps, b, cfg.input_size, cfg.word_len, "cuda", seed=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, per_step = [], [], []
    reset_counts(*counters)
    for i, batch in enumerate(batches):
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        metrics = engine.train_step(model, opt, sched, batch,
                                    engine.step_seed(0, i), torch.bfloat16)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append([c.launches - n for c, n in zip(counters, before)])
        losses.append(metrics["loss"].item())
        assert np.isfinite(losses[-1]), (i, losses[-1])
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated() / 2**30
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
    moved = sum(not torch.equal(buf, bns[n]) for n, buf in model.named_buffers()
                if n in bns)
    assert moved == len(bns), (moved, len(bns))
    sites = 2 * cfg.num_layers  # self- and cross-attention per layer
    assert all(s == [sites, sites, 1] for s in per_step), per_step
    # every K2 launch (both decoder sites of every layer, forward and
    # backward) and K1 at attnpool on the tensor cores
    routes = [dict(c.launches_by_route) for c in counters]
    for n, by_route in zip((sites, sites, 1), routes):
        assert by_route == {"tensor_cores": n * steps, "scalar": 0}, routes
    median = float(np.median(times[2:]))
    print(f"R50 bf16 train b{b}: losses {['%.4f' % x for x in losses]}; "
          f"launches per step (K2 fwd, K2 bwd, K1) {per_step[0]} in every "
          f"step, by route (K2 fwd, K2 bwd, K1) {routes}; {moved} BN "
          f"running means moved; group lrs {lrs}", flush=True)
    print(f"R50 bf16 train b{b} dropout 0.1: median step {median:.2f} ms "
          f"(steps 3-{steps}: {['%.2f' % x for x in times[2:]]}), peak memory "
          f"{peak:.2f} GiB, on {card_line()}", flush=True)
    return launches, median, peak, times, routes


def _cudnn_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """The chain the folded model runs for a tail block with K5 off:
    three cuDNN convs with their biases, ReLUs and the residual add, in
    the dtype, on the NCHW map; the weights are cast beforehand."""
    dt = x.dtype
    mid = w1.shape[1]
    xc = x.permute(0, 3, 1, 2)
    k1 = w1.t()[:, :, None, None].contiguous()
    k2 = w2.reshape(3, 3, mid, mid).permute(3, 2, 0, 1).contiguous()
    k3 = w3.t()[:, :, None, None].contiguous()
    c1, c2, c3 = b1.to(dt), b2.to(dt), b3.to(dt)
    F = torch.nn.functional

    def run():
        out = F.relu(F.conv2d(xc, k1, c1))
        out = F.relu(F.conv2d(out, k2, c2, padding=1))
        return F.relu(F.conv2d(out, k3, c3) + xc)
    return run


def _timed_rows(fused, plain, library, args):
    """plain, kernel, kernel, plain, library, library on CUDA events."""
    p1 = cuda_ms(lambda: plain(*args), 10)
    k1 = cuda_ms(lambda: fused(*args), 10)
    k2 = cuda_ms(lambda: fused(*args), 10)
    p2 = cuda_ms(lambda: plain(*args), 10)
    l1, l2 = cuda_ms(library, 10), cuda_ms(library, 10)
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                library_ms=(l1 + l2) / 2)


def l2_bytes_per_s() -> float:
    """The card's L2 rate on a plain copy that stays in L2: 8 MiB to 8 MiB
    (16 MiB of the 50 MB L2), on the device alone; bytes read + written
    per second."""
    src = torch.ones(2 ** 22, dtype=torch.float16, device="cuda")
    dst = torch.empty_like(src)
    ms = device_ms(lambda: dst.copy_(src), 50)
    return 2 * src.numel() * src.element_size() / (ms * 1e-3)


def _k5_l2_weight_ms(plan, b, h, c, mid, l2_rate) -> float:
    """The tensor-core body's L2 weight traffic at its plan, over the
    measured L2 rate: every block reads each weight once per M tile."""
    blocks = b * -(-h // plan["R"])
    per_block = 2 * (-(-plan["M1"] // plan["BM1"]) * c * mid + plan["M2"]
                     // plan["BM23"] * (9 * mid * mid + mid * c))
    return blocks * per_block / l2_rate * 1e3


def phase_k5(fused, plain, route_of, plan_of):
    """K5 at every R50 tail shape, B 16, f32 and bf16, against its plain
    version; x is an NHWC view of NCHW memory, as the model hands it. Each
    call's route is bottleneck_route's and counted on it: bf16 on the
    tensor cores, f32 on the staged body. Times back to back and on the
    device alone, beside the bound and, for the tensor-core body, its
    plan's L2 weight traffic over the card's measured L2 rate."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(9)
    l2_rate = l2_bytes_per_s()
    print(f"L2 copy (8 MiB -> 8 MiB, device alone): {l2_rate / 1e12:.3f} "
          f"TB/s read + written, on {card_line()}", flush=True)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    for site, h, w, c, mid, per_forward in K5_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(B, c, h, w).to(dtype).permute(0, 2, 3, 1)
            args = (x, (randn(c, mid) * c ** -0.5).to(dtype), randn(mid) * 0.1,
                    (randn(9, mid, mid) * (9 * mid) ** -0.5).to(dtype),
                    randn(mid) * 0.1, (randn(mid, c) * mid ** -0.5).to(dtype),
                    randn(c) * 0.1)
            route = route_of(x, args[1], args[3], args[5])
            want = "tensor_cores" if dtype == torch.bfloat16 else "staged"
            assert route == want, (site, dtype, route)
            before = fused.launches
            got, taken = route_taken(fused, lambda: fused(*args))
            assert fused.launches == before + 1 and taken == route, taken
            ref = plain(*args)
            library = _cudnn_bottleneck(*args)
            torch.cuda.synchronize()
            what = f"K5 {site} {dtype}"
            err = _check(got, ref, dtype, what)
            assert got.stride() == x.stride(), (got.stride(), x.stride())
            if dtype == torch.float32:
                _check(library().permute(0, 2, 3, 1), ref, dtype,
                       what + ": the cuDNN chain")
            # strides only address: a contiguous NHWC input, the same bits
            xc = x.contiguous()
            same, taken = route_taken(fused, lambda: fused(xc, *args[1:]))
            assert taken == route and torch.equal(same, got), what
            times = _timed_rows(fused, plain, library, args)
            times["device_ms"] = device_ms(lambda: fused(*args))
            times["library_device_ms"] = device_ms(library)
            es = x.element_size()
            nbytes = (2 * x.numel() + 2 * c * mid + 9 * mid * mid) * es \
                + 4 * (2 * mid + c)
            flops = 2.0 * B * h * w * (2 * c * mid + 9 * mid * mid)
            b_ms, b_by = bound(nbytes, flops, dtype)
            row = dict(site=site, B=B, H=h, W=w, C=c, mid=mid,
                       launches_per_forward=per_forward, route=route,
                       dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                       gflop=flops / 1e9, mbytes=nbytes / 1e6, **times)
            plan = ""
            if route == "tensor_cores":
                row["plan"] = plan_of(x, mid)
                row["l2_weight_ms"] = _k5_l2_weight_ms(row["plan"], B, h, c,
                                                       mid, l2_rate)
                pl = row["plan"]
                plan = (f"; plan BM {pl['BM1']}/{pl['BM23']} R {pl['R']}, "
                        f"L2 weight traffic {row['l2_weight_ms']:.4f} ms")
            rows.append(row)
            print(f"K5 {site} {h}x{w}x{c}/{mid} {row['dtype']:8s} {route} "
                  f"max|err| {err:.3e}; kernel {row['device_ms']:.4f} ms "
                  f"device alone ({row['ms']:.4f} back to back), plain "
                  f"{row['plain_ms']:.4f} ms, cuDNN chain "
                  f"{row['library_device_ms']:.4f} ms device alone "
                  f"({row['library_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}, "
                  f"{row['gflop']:.1f} GFLOP, {row['mbytes']:.1f} MB){plan}",
                  flush=True)
    k5_sum = sum(r["device_ms"] * r["launches_per_forward"] for r in rows
                 if r["dtype"] == "bfloat16")
    print(f"K5: one b16 bf16 forward's 12 launches {k5_sum:.4f} ms on the "
          f"device alone, on {card_line()}", flush=True)
    return rows


def _cudnn_stem(img, k1, b1, k2, b2, k3, b3):
    """The folded model's stem with K7 off: three cuDNN convs with their
    biases and ReLUs and the 2x2 pool, in the kernels' dtype, NCHW."""
    F = torch.nn.functional
    dt = k1.dtype
    xc = img.permute(0, 3, 1, 2)
    ks = [k.permute(3, 2, 0, 1).contiguous() for k in (k1, k2, k3)]
    bs = [b.to(dt) for b in (b1, b2, b3)]

    def run():
        x = F.relu(F.conv2d(xc.to(dt), ks[0], bs[0], 2, 1))
        x = F.relu(F.conv2d(x, ks[1], bs[1], 1, 1))
        x = F.relu(F.conv2d(x, ks[2], bs[2], 1, 1))
        return F.avg_pool2d(x, 2)
    return run


def phase_k7(fused, plain, route_of, plan_of, size=416, widths=(32, 32, 64)):
    """K7 on B 16 images at 416^2, f32 and bf16, against its plain version
    (the image an NHWC view of f32 NCHW memory, as the model hands it, and
    once more contiguous NHWC: the same bits), on the route stem_route
    gives and counted on it (bf16: the tensor-core body with its plan; f32:
    the staged body). At the bf16 416^2 site every
    candidate tile that fits gives the chosen plan's bits, each timed on
    the device alone beside its modelled cost. A 100 x 76 image, whose 25 x
    19 pooled map ends in partial tiles, runs on both routes in bf16; bf16
    widths 24/24/40 keep the staged body's bf16 path under test, and
    16/48/32 the tensor-core body's generic instantiation (R50's widths
    take the one whose k steps are unrolled). Times back to back and on
    the device alone, beside the cuDNN chain's and the bound."""
    from cris_tpu_torch.ops.kernels.stem import (TC_TILES, _launch,
                                                 _tc_smem_bytes)

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(10)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def kernels(dtype, c1, c2, c3):
        return ((randn(3, 3, 3, c1) * 27 ** -0.5).to(dtype), randn(c1) * 0.1,
                (randn(3, 3, c1, c2) * (9 * c1) ** -0.5).to(dtype),
                randn(c2) * 0.1,
                (randn(3, 3, c2, c3) * (9 * c2) ** -0.5).to(dtype),
                randn(c3) * 0.1)

    def on_route(args, route, tile=None):
        got, taken = route_taken(fused, lambda: _launch(*args, route=route,
                                                        tile=tile))
        assert taken == route, (route, taken)
        return got

    small = randn(2, 3, 100, 76).permute(0, 2, 3, 1)
    for c in ((24, 24, 40), (16, 48, 32)):
        other = (small, *kernels(torch.bfloat16, *c))
        route = route_of(other[0], other[1], other[3], other[5])
        assert route == ("staged" if c[0] % 16 else "tensor_cores"), route
        _check(on_route(other, route), plain(*other), torch.bfloat16,
               f"K7 100 x 76 bf16 {c} ({route})")
    c1, c2, c3 = widths
    for dtype in (torch.float32, torch.bfloat16):
        ks = kernels(dtype, c1, c2, c3)
        want = "tensor_cores" if dtype == torch.bfloat16 else "staged"
        assert route_of(small, ks[0], ks[2], ks[4]) == want
        for route in dict.fromkeys((want, "staged")):
            _check(on_route((small, *ks), route), plain(small, *ks), dtype,
                   f"K7 100 x 76 {dtype} ({route})")
        img = randn(B, 3, size, size).permute(0, 2, 3, 1)
        args = (img, *ks)
        route = route_of(img, ks[0], ks[2], ks[4])
        assert route == want, (dtype, route)
        before = fused.launches
        got, taken = route_taken(fused, lambda: fused(*args))
        assert fused.launches == before + 1 and taken == route, taken
        ref = plain(*args)
        library = _cudnn_stem(*args)
        torch.cuda.synchronize()
        what = f"K7 {size}^2 {dtype}"
        err = _check(got, ref, dtype, what)
        if dtype == torch.float32:
            _check(library().permute(0, 2, 3, 1), ref, dtype,
                   what + ": the cuDNN chain")
        # strides only address: a contiguous NHWC image (one value a copy
        # on the tensor cores), the same bits
        same = on_route((img.contiguous(), *ks), route)
        assert torch.equal(same, got), what + ": contiguous NHWC image"
        times = _timed_rows(fused, plain, library, args)
        times["device_ms"] = device_ms(lambda: fused(*args))
        times["library_device_ms"] = device_ms(library)
        es = torch.tensor([], dtype=dtype).element_size()
        h2 = size // 2
        nbytes = img.numel() * 4 + got.numel() * es + 4 * (c1 + c2 + c3) \
            + es * 9 * (3 * c1 + c1 * c2 + c2 * c3)
        flops = 2.0 * B * h2 * h2 * 9 * (3 * c1 + c1 * c2 + c2 * c3)
        b_ms, b_by = bound(nbytes, flops, dtype)
        row = dict(site=f"stem {size}^2", B=B, route=route, dtype=str(
            dtype).replace("torch.", ""), max_abs_err=err, bound_ms=b_ms,
            bound_by=b_by, gflop=flops / 1e9, mbytes=nbytes / 1e6, **times)
        plan = ""
        if route == "tensor_cores":
            row["plan"] = plan_of(img, ks[0], ks[2], ks[4])
            pl = row["plan"]
            assert (pl["Th"], pl["Tw"]) in TC_TILES, pl
            tiles = []
            for tile in TC_TILES:
                if _tc_smem_bytes(*tile, *widths) > 232448:
                    continue
                same = on_route(args, route, tile)
                assert torch.equal(same, got), (what, tile)
                tiles.append(dict(
                    tile=list(tile), cost=plan_of(img, ks[0], ks[2], ks[4],
                                                  tile)["cost"],
                    device_ms=device_ms(lambda: _launch(*args, route=route,
                                                        tile=tile))))
            row["tiles"] = tiles
            print("K7 tiles, device alone: " + ", ".join(
                f"{t['tile'][0]}x{t['tile'][1]} {t['device_ms']:.4f} ms"
                for t in sorted(tiles, key=lambda t: t["device_ms"])),
                flush=True)
            best = min(tiles, key=lambda t: t["device_ms"])
            plan = (f"; plan Th {pl['Th']} x Tw {pl['Tw']}, {pl['tiles']} "
                    f"tiles on {pl['blocks']} blocks, {pl['smem_bytes']} B "
                    f"shared; {len(tiles)} tiles bit-equal, fastest "
                    f"{best['tile']} {best['device_ms']:.4f} ms")
        rows.append(row)
        print(f"K7 {size}^2 -> {size // 4}^2 x {c3} {row['dtype']:8s} {route} "
              f"max|err| {err:.3e}; kernel {row['device_ms']:.4f} ms device "
              f"alone ({row['ms']:.4f} back to back), plain "
              f"{row['plain_ms']:.4f} ms, cuDNN chain "
              f"{row['library_device_ms']:.4f} ms device alone "
              f"({row['library_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}, "
              f"{row['gflop']:.1f} GFLOP, {row['mbytes']:.1f} MB){plan}",
              flush=True)
    return rows


def randomize_bn(model, seed):
    """BN statistics and affines made non-trivial from a seed, so that the
    fold does real work: running mean N(0, 0.1), running var U(0.5, 1.5),
    weight U(0.5, 1.5), bias N(0, 0.1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if hasattr(mod, "running_mean"):
                n = mod.running_mean.shape
                mod.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
                mod.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                mod.bias.copy_(torch.randn(n, generator=gen) * 0.1)
    return model


def _folded(cfg, build_segmenter, folded_sd, **switches):
    model = build_segmenter(cfg, device="meta", fold_bn=True,
                            pos_grid=cfg.input_size // 32, **switches)
    model.load_state_dict(folded_sd, assign=True)
    return model.cuda()


def folded_card_vs_cpu(cfg, build_segmenter, fold_batchnorm, tokenize,
                       sentences, counters=(), **switches):
    """The f32 folded forward (with K5/K7 ``switches``) on the card
    against the unfolded eval forward on the CPU, with BN made
    non-trivial, on one seeded image per sentence. Returns the unfolded
    state dict, the logits' relative L2, the mask agreement at 0.35, the
    ``counters``' launches in the card's forward, the logits' shape and
    the CPU forward's seconds."""
    base = randomize_bn(build_segmenter(cfg, device="cpu", seed=0), 3)
    sd = base.state_dict()
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(len(sentences), 3, cfg.input_size, cfg.input_size,
                      generator=gen)
    word = torch.from_numpy(tokenize(sentences, cfg.word_len, True)).long()
    model = _folded(cfg, build_segmenter, fold_batchnorm(sd, cfg.input_size),
                    **switches)
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = base(img, word)
        cpu_s = time.perf_counter() - t0
        for fn in counters:
            fn.launches = 0
        got = model(img.cuda(), word.cuda())
        torch.cuda.synchronize()
        launches = tuple(fn.launches for fn in counters)
    got = got.cpu()
    assert torch.isfinite(got).all() and got.shape == ref.shape
    rel = ((got - ref).norm() / ref.norm()).item()
    agree = ((torch.sigmoid(got) > 0.35) == (torch.sigmoid(ref) > 0.35)
             ).float().mean().item()
    return sd, rel, agree, launches, tuple(got.shape), cpu_s


def phase_folded_model(cfg, build_segmenter, fold_batchnorm, k5, k7, tokenize):
    """10(a): the R50 f32 folded forward with K5 and K7 on the card
    against the unfolded eval forward on the CPU. Returns the unfolded
    state dict with its non-trivial BN."""
    sd, rel, agree, launches, shape, cpu_s = folded_card_vs_cpu(
        cfg, build_segmenter, fold_batchnorm, tokenize,
        ["the man in the red shirt on the left", "a dog"], (k5, k7),
        fused_bottleneck=True, fused_stem=True)
    print(f"R50 f32 folded + K5 + K7 on the card vs unfolded on the CPU: "
          f"logits {shape} rel L2 {rel:.3e} mask agreement "
          f"{agree:.6f}; K5, K7 launches {launches} (CPU forward "
          f"{cpu_s:.1f} s)", flush=True)
    assert launches == (12, 1), launches
    assert rel <= 1e-4, rel
    assert agree >= 0.999, agree
    return sd, rel


def phase_ab(cfg, build_segmenter, fold_batchnorm, sd):
    """10(c): the b16 bf16 forward, unfolded / folded / folded + K5 /
    folded + K5 + K7, on CUDA events in turns (u, f, 5, k, k, 5, f, u)."""
    unfolded = build_segmenter(cfg, device="meta")
    unfolded.load_state_dict(sd, assign=True)
    unfolded.cuda()
    folded_sd = fold_batchnorm(sd, cfg.input_size)
    folded = _folded(cfg, build_segmenter, folded_sd)
    k5_only = _folded(cfg, build_segmenter, folded_sd, fused_bottleneck=True)
    kernels = _folded(cfg, build_segmenter, folded_sd, fused_bottleneck=True,
                      fused_stem=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    size = cfg.input_size
    img = torch.randn(B, 3, size, size, device="cuda", generator=gen)
    word = torch.randint(1, 49407, (B, cfg.word_len), device="cuda",
                         generator=gen)

    def forward(model):
        @torch.no_grad()
        def run():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return model(img, word)
        return run

    models = (unfolded, folded, k5_only, kernels)
    outs = [forward(m)().float() for m in models]
    rel = [_rel(o, outs[0]) for o in outs[1:]]
    order = (0, 1, 2, 3, 3, 2, 1, 0)
    times = [cuda_ms(forward(models[i]), 10) for i in order]
    mean = [(times[j] + times[7 - j]) / 2 for j in range(4)]
    ab = {"unfolded_ms": mean[0], "folded_ms": mean[1],
          "folded_k5_ms": mean[2], "folded_k5_k7_ms": mean[3],
          "rel_l2_vs_unfolded": {"folded": rel[0], "folded_k5": rel[1],
                                 "folded_k5_k7": rel[2]}}
    pairs = ", ".join(f"{name} {times[j]:.3f}/{times[7 - j]:.3f} ms"
                      for j, name in enumerate(
                          ("unfolded", "folded", "folded + K5",
                           "folded + K5 + K7")))
    print(f"R50 b16 bf16 forward (CUDA events, mean of 10, u f 5 k k 5 f u): "
          f"{pairs}; logits rel L2 against the unfolded bf16 forward: folded "
          f"{rel[0]:.3e}, + K5 {rel[1]:.3e}, + K5 + K7 {rel[2]:.3e}; on "
          f"{card_line()}", flush=True)
    assert all(np.isfinite(r) for r in rel), rel
    return ab


def k5_tails_taken(cfg, preset_from_name, takes, rule) -> int:
    """The stage tails of cfg's visual encoder at its input size that
    K5's gate takes in bf16 under ``rule``: K5's launches per batch."""
    clip = preset_from_name(cfg.clip_pretrain)
    n = 0
    for i, blocks in enumerate(clip.vision_layers):
        hw, mid = cfg.input_size // 4 // 2 ** i, clip.vision_width * 2 ** i
        n += (blocks - 1) * takes(hw, hw, 4 * mid, mid, torch.bfloat16, rule)
    return n


def phase_bench(bench, build_segmenter, fold_batchnorm, tokenize,
                preset_from_name, takes, k1, k2, k2_bwd, k5, k7):
    """12: the bench's host metric, then its three device metrics at short
    lengths (n1 2, n2 4, 2 trials) with their launches per batch and route, its A/B at one
    round with each arm's K5 and K7 launches per batch as the gate gives
    them, and R101's folded f32 forward on the card against the CPU."""
    device = torch.device("cuda")
    n1, n2, trials = 2, 4, 2
    out, launches = {"metrics": []}, {}
    # the host metric first, as the bench runs it; a failure raises
    out["host"] = bench.run_host_metric(device)
    for name, step, path in bench.METRICS:
        cfg = bench.config_for(path)
        # (wrapper, label, launches per batch)
        counts = ([(k2, "K2 fwd", 2 * cfg.num_layers),
                   (k2_bwd, "K2 bwd", 2 * cfg.num_layers), (k1, "K1", 1)]
                  if step == "train" else [(k1, "K1", 2 * cfg.num_layers + 1)])
        reset_counts(*(fn for fn, _, _ in counts))
        t0 = time.perf_counter()
        r = bench.run_metric(name, step, cfg, device, bench.BATCH, n1, n2,
                             trials)
        seconds = time.perf_counter() - t0
        bench.free(device)
        assert np.isfinite(r["value"]) and r["value"] > 0, (name, r)
        got = {label: dict(fn.launches_by_route) for fn, label, _ in counts}
        for fn, label, per_batch in counts:
            want = per_batch * r["batches"]
            assert fn.launches == want, (name, label, fn.launches, want)
            assert got[label] == {"tensor_cores": want, "scalar": 0}, got
            launches[label] = launches.get(label, 0) + want
        print(f"bench {name}: {r['value']:.2f} img/s (trials "
              f"{['%.2f' % x for x in r['trials']]}, spread "
              f"{r['spread']:.4f}), {r['batches']} batches of "
              f"{bench.BATCH}, launches by route {got} "
              f"({', '.join(f'{l} {p} a batch' for _, l, p in counts)}); "
              f"{seconds:.1f} s", flush=True)
        out["metrics"].append({"metric": name, **r, "by_route": got})
        if name == bench.METRICS[0][0]:
            bench.print_cores_to_feed(out["host"], r["value"])

    cfg = bench.config_for(bench.R50)
    reset_counts(k5, k7)
    ab = bench.ab(cfg, device, bench.BATCH, n1, n2, rounds=1)
    bench.free(device)
    rules = {arm: sw.get("fused_bottleneck") for arm, sw in bench.ARMS.items()}
    rules["d"] = rules[ab["ab"]["d_k5_arm"]]
    for t in ab["turns"]:
        rule = rules[t["arm"]]
        want = (k5_tails_taken(cfg, preset_from_name, takes, rule)
                if rule else 0, int(t["arm"] == "d"))
        assert (t["k5_per_batch"], t["k7_per_batch"]) == want, (t, want)
    for fn, label in ((k5, "K5"), (k7, "K7")):
        assert fn.launches_by_route["tensor_cores"] == fn.launches > 0, (
            label, fn.launches_by_route)
        launches[label] = fn.launches
    print(f"bench --ab at one round: K5 per batch by arm "
          f"{ {a: t['k5_per_batch'] for a, t in zip('abcd', ab['turns'])} }, "
          f"K7 on arm d only; K5, K7 launches {k5.launches}, {k7.launches}, "
          f"all on tensor_cores", flush=True)
    out["ab"] = ab

    r101 = bench.config_for(bench.R101)
    _, rel, agree, _, shape, cpu_s = folded_card_vs_cpu(
        r101, build_segmenter, fold_batchnorm, tokenize, ["the dog on the left"])
    print(f"R101 f32 folded on the card vs unfolded on the CPU: logits "
          f"{shape} rel L2 {rel:.3e} mask agreement {agree:.6f} (CPU "
          f"forward {cpu_s:.1f} s)", flush=True)
    assert rel <= 1e-4, rel
    assert agree >= 0.999, agree
    out["r101_rel_l2"], out["launches"] = rel, launches
    return out


# Philox4x32-10's integer work per call (4 keep bits), by the pipe it
# issues to: 10 rounds of two 32 x 32 -> 64-bit multiplies, a low and a
# high word each (40 multiply results: IMAD, on the FMA pipe), and of two
# three-input XORs (20 LOP3, on the ALU pipe), plus 4 threshold compares
# (ALU). The round keys depend on the seed alone and are not counted.
PHILOX_OPS_BY_PIPE = {"multiply": 40, "logic": 24}
# 32-bit integer multiply, and 32-bit bitwise and compare operations: 64
# results per clock per SM each on compute capability 9.0 (CUDA C++
# Programming Guide, "Arithmetic Instructions", throughput table); the
# two pipes issue side by side, so the busier one binds. 132 SMs at the
# top SM clock.
PEAK_INT_OPS = 64 * 132 * SM_HZ


def _k2_bound(b, s, t, h, d, dtype, route, backward, valid_keys):
    """K2's bound at a site: (ms, 'bytes' or 'operations', the binding
    term), the largest of three terms. Bytes: the forward reads q, k, v
    and writes the output and the f32 log-sum-exp; the backward reads q,
    k, v, the output, dO and the log-sum-exp and writes dq, dk, dv; on the
    tensor-core route the forward also writes the packed keep mask
    (ceil(T / 32) words a row) and the backward reads it. Tensor
    operations: two products (S, P V) in the forward and five (S, dV, dP,
    dQ, dK) in the backward, over the (query, valid key) pairs of this
    run's mask (``valid_keys``: the valid keys summed over the batch).
    Philox: one call per (row, 4-key group) in the forward, its 40
    multiplies on the FMA pipe beside its 24 logic operations on the ALU
    pipe (PHILOX_OPS_BY_PIPE); the scalar backward draws them again (at
    least once), the tensor-core backward reads the bits instead."""
    es = torch.tensor([], dtype=dtype).element_size()
    e = h * d
    words = 4 * b * h * s * ((t + 31) // 32) if route == "tensor_cores" else 0
    pairs = float(valid_keys) * s * h
    philox = float(b * h * s * ((t + 3) // 4)) * max(
        PHILOX_OPS_BY_PIPE.values())
    if backward:
        nbytes = es * b * (4 * s + 4 * t) * e + 4 * b * h * s + words
        flops = 10.0 * pairs * d
        philox *= route != "tensor_cores"
    else:
        nbytes = es * b * (2 * s + 2 * t) * e + 4 * b * h * s + words
        flops = 4.0 * pairs * d
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "tensor-core operations": flops / PEAK_FLOPS[dtype],
             "Philox integer operations": philox / PEAK_INT_OPS}
    if dtype == torch.float32:  # f32 products run on the CUDA cores
        terms["f32 operations"] = terms.pop("tensor-core operations")
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


# Phase 11: the JAX package's public kernel API (K3, K4, K6) at R50 widths
K3_SHAPES = SHAPES[:2] + SHAPES[3:5]  # self, cross (5 masked), attnpool, odd
# K4's sites: (site, H = W of a 1x1 conv's map or None for a matmul, M of
# a matmul, K, N, residual, relu)
K4_SITES = [
    ("layer1 conv1 104^2 256->64", 104, None, 256, 64, False, True),
    ("layer1 conv3 104^2 64->256", 104, None, 64, 256, True, True),
    ("layer3 conv3 26^2 256->1024", 26, None, 256, 1024, True, True),
    ("layer4 conv1 13^2 2048->512", 13, None, 2048, 512, False, True),
    ("decoder FFN fc1", None, B * 676, 512, 2048, False, True),
    ("decoder FFN fc2", None, B * 676, 2048, 512, True, False),
    ("ragged (300, 70) -> 130", None, 300, 70, 130, True, True),
]
# K6's sites: (site, rows, C)
K6_SITES = [
    ("decoder LN", B * 676, 512),
    ("FFN LN", B * 676, 2048),
    ("text LN", B * 17, 512),
]


def _sum_bar(terms: torch.Tensor) -> torch.Tensor:
    """Per column, twice the worst-case rounding of an f32 sum over the n
    rows of terms in any order plus the terms' own few roundings, (n + 4)
    2^-24 sum |terms|: the most two sums of the same f32 terms in two
    orders can differ by."""
    return 2 * (terms.shape[0] + 4) * 2.0 ** -24 * terms.abs().sum(0)


def _cublas_chain(x, w, bias, residual, relu):
    """torch.addmm with the bias in x's dtype, then the residual add and
    the ReLU: what the port would run without K4 (TF32 off)."""
    bias = bias.to(x.dtype)

    def run():
        y = torch.addmm(bias, x, w)
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu else y
    return run


def _decoder_activations(cfg, build_segmenter):
    """One b16 bf16 forward of the folded R50 (seeded random weights) with
    forward hooks on every decoder LayerNormF32 and FFN fc1: [(module,
    input, output)] for each, as the model ran them."""
    from cris_tpu_torch.models import LayerNormF32

    model = build_segmenter(cfg, device="cuda", seed=0, fold_bn=True,
                            pos_grid=cfg.input_size // 32)
    lns, fc1s, hooks = [], [], []
    for mod in model.decoder.modules():
        if isinstance(mod, LayerNormF32):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o: lns.append((m, i[0], o))))
    for layer in model.decoder.layers:
        hooks.append(layer.ffn[0].register_forward_hook(
            lambda m, i, o: fc1s.append((m, i[0], o))))
    gen = torch.Generator(device="cuda").manual_seed(11)
    img = torch.randn(B, 3, cfg.input_size, cfg.input_size, device="cuda",
                      generator=gen)
    word = torch.randint(1, 49407, (B, cfg.word_len), device="cuda",
                         generator=gen)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        model(img, word)
    for h in hooks:
        h.remove()
    del model
    n_ln = 6 * cfg.num_layers + 1  # 5 + the FFN's per layer, and the last
    assert len(lns) == n_ln and len(fc1s) == cfg.num_layers, (len(lns),
                                                              len(fc1s))
    return lns, fc1s


def phase_kernel_api(api, cfg, build_segmenter):
    """11: K3, K4 and K6 through their public functions at R50 widths, B
    16, f32 (TF32 off) and bf16, and on the model's own decoder
    activations. Every count is set to 0, the API is driven once (each
    output kept), and the counts are read: each must equal the calls made.
    Then each output is held against its plain version at the phase-2
    bars (in units of the reference's RMS where that exceeds 1; K6's
    dscale and dbias against their sums' own rounding, _sum_bar), and
    kernel, plain version and library call are timed in turns."""
    from cris_tpu_torch.ops.kernels.attention import merge_heads, split_heads

    t0 = time.perf_counter()
    k3, k4, k6, k6_bwd = (api["fused_attention"], api["fused_matmul"],
                          api["layer_norm"], api["layer_norm_backward"])
    gen = torch.Generator(device="cuda").manual_seed(12)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    dtypes = (torch.float32, torch.bfloat16)
    lns, fc1s = _decoder_activations(cfg, build_segmenter)
    inputs = {"K3": {}, "K4": {}, "K6": {}}
    for site, s, t, h, d, masked in K3_SHAPES:
        for dt in dtypes:
            q, k, v, g, valid = _site_inputs(gen, B, s, t, h, d, masked, dt)
            inputs["K3"][("K3", site, dt)] = (q, k, v, g, valid, h)
    for site, hw, m, kk, n, res, relu in K4_SITES:
        for dt in dtypes:
            shape = (B, hw, hw) if hw else (m,)
            x = randn(*shape, kk).to(dt)
            w = (randn(kk, n) * kk ** -0.5).to(dt)
            r = randn(*shape, n).to(dt) if res else None
            inputs["K4"][("K4", site, dt)] = (x, w, randn(n) * 0.1, r, relu)
    for site, rows, c in K6_SITES:
        for dt in dtypes:
            inputs["K6"][("K6", site, dt)] = (randn(rows, c).mul(2).add(1).to(dt),
                                      1 + 0.1 * randn(c), 0.1 * randn(c),
                                      randn(rows, c).to(dt))
    torch.cuda.synchronize()

    # the drive: each public function once per site and dtype, then on the
    # model's activations; the counts are read right after
    reset_counts(k3, k4, k6, k6_bwd)
    calls = {"K3": 0, "K4": 0, "K6 fwd": 0, "K6 bwd": 0}
    routes = {"K3": {r: 0 for r in k3.launches_by_route},
              "K4": {r: 0 for r in k4.launches_by_route}}
    got, route_of = {}, {}
    for key, (q, k, v, g, valid, h) in inputs["K3"].items():
        heads = [split_heads(x, h).contiguous() for x in (q, k, v)]
        got[key], route_of[key] = route_taken(k3, lambda: k3(*heads, valid))
        d = q.shape[-1] // h
        assert route_of[key] == expected_route(key[2], d), (key, route_of[key])
        calls["K3"] += 1
        routes["K3"][route_of[key]] += 1
        if key[1] == "decoder self-attn":  # kernel forward, plain backward
            got[key + ("grad",)], r = route_taken(k3, lambda: _fwd_bwd(
                lambda q, k, v: merge_heads(k3(*(split_heads(x, h) for x in (
                    q, k, v)), valid)), q, k, v, g))
            assert r == expected_route(key[2], d), (key, r)
            calls["K3"] += 1
            routes["K3"][r] += 1
    for key, (x, w, b, r, relu) in inputs["K4"].items():
        if x.dim() == 4:
            call = lambda: api["conv1x1_fused"](x, w[None, None], b, r, relu)  # noqa: E731
        else:
            call = lambda: k4(x, w, b, r, relu)  # noqa: E731
        got[key], route_of[key] = route_taken(k4, call)
        # TMA takes every bf16 site but the ragged one (140-byte rows)
        want = ("wgmma" if key[2] == torch.bfloat16 and not
                key[1].startswith("ragged") else "staged")
        assert route_of[key] == want, (key, route_of[key])
        calls["K4"] += 1
        routes["K4"][route_of[key]] += 1
    for key, (x, sc, bi, g) in inputs["K6"].items():
        xg, sg, bg = (t.detach().requires_grad_() for t in (x, sc, bi))
        out = k6(xg, sg, bg)
        out.backward(g)
        got[key] = (out.detach(), xg.grad, sg.grad, bg.grad)
        calls["K6 fwd"] += 1
        calls["K6 bwd"] += 1
    model_got = []
    with torch.no_grad():
        for mod, x, y in lns:
            model_got.append(("K6", k6(x, mod.weight, mod.bias, mod.eps), y))
            calls["K6 fwd"] += 1
        for mod, x, y in fc1s:
            xb = x.to(torch.bfloat16)
            # w is the K-major weight.t(), as a model caller would pass it
            a, r = route_taken(k4, lambda: k4(
                xb.reshape(-1, xb.shape[-1]),
                mod.weight.t().to(torch.bfloat16), mod.bias, None, True))
            assert r == "wgmma", r
            model_got.append(("K4", a, torch.relu(y).reshape(-1, y.shape[-1])))
            calls["K4"] += 1
            routes["K4"][r] += 1
    torch.cuda.synchronize()
    launches = {"K3": k3.launches, "K4": k4.launches, "K6 fwd": k6.launches,
                "K6 bwd": k6_bwd.launches}
    by_route = {"K3": dict(k3.launches_by_route),
                "K4": dict(k4.launches_by_route)}
    print(f"kernel API launches {launches} for calls {calls}; by route "
          f"{by_route} for {routes}", flush=True)
    assert launches == calls and all(launches.values()), (launches, calls)
    assert by_route == routes, (by_route, routes)

    rows, worst = [], {name: 0.0 for name in calls}

    def _timed_api(fused, plain, library, args):
        """_timed_rows' back-to-back times, and each one's device time
        (device_ms) in the same turns."""
        times = _timed_rows(fused, plain, library, args)
        dp1 = device_ms(lambda: plain(*args), 10)
        dk1 = device_ms(lambda: fused(*args), 10)
        dk2 = device_ms(lambda: fused(*args), 10)
        dp2 = device_ms(lambda: plain(*args), 10)
        dl1, dl2 = device_ms(library, 10), device_ms(library, 10)
        return dict(times, device_ms=(dk1 + dk2) / 2,
                    plain_device_ms=(dp1 + dp2) / 2,
                    library_device_ms=(dl1 + dl2) / 2)

    def record(name, key, err, times, nbytes, flops, peak_dtype, **extra):
        b_ms, b_by = bound(nbytes, flops, peak_dtype)
        row = dict(kernel=name, site=key[1],
                   dtype=str(key[2]).replace("torch.", ""),
                   max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times,
                   **extra)
        if key in route_of:
            row["route"] = route_of[key]
        worst[name] = max(worst[name], err)
        rows.append(row)
        print(f"{name} {key[1]:30s} {row['dtype']:8s} "
              f"{'route ' + row['route'] + ' ' if 'route' in row else ''}"
              f"max|err| {err:.3e}; "
              f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
              f"library {row['library_ms']:.4f} ms; on the device alone "
              f"kernel {row['device_ms']:.4f} ms plain "
              f"{row['plain_device_ms']:.4f} ms library "
              f"{row['library_device_ms']:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)

    plain3 = api["fused_attention_plain"]
    for key, (q, k, v, g, valid, h) in inputs["K3"].items():
        dt = key[2]
        qh, kh, vh = (split_heads(x, h).contiguous() for x in (q, k, v))
        err = _check(got[key], plain3(qh, kh, vh, valid), dt,
                     f"K3 {key[1]} {dt}")
        with torch.no_grad():
            # one CUDA body: K3 on head views of K1's rows, K1's bits
            views = [split_heads(x, h) for x in (q, k, v)]
            k1 = api["fused_attention_bse"]
            a3, r3 = route_taken(k3, lambda: merge_heads(k3(*views, valid)))
            a1, r1 = route_taken(k1, lambda: k1(q, k, v, h, valid))
            assert r3 == r1 == route_of[key], (key, r3, r1)
            assert torch.equal(a3, a1), \
                f"K3 on head views differs from K1 at {key[1]} {dt}"
            lib = _sdpa(q, k, v, h, valid)
            torch.testing.assert_close(lib().float(), got[key].float(),
                                       rtol=2e-2, atol=2e-2)
            times = _timed_api(k3, plain3, lib, (qh, kh, vh, valid))
        extra = {}
        if key + ("grad",) in got:
            ref = _reference(lambda q, k, v: merge_heads(plain3(*(
                split_heads(x, h) for x in (q, k, v)), valid)), q, k, v, g)
            errs = [_check(a, b_, dt, f"K3 grad {key[1]} {dt} {n}") for n, a, b_
                    in zip(("out", "dq", "dk", "dv"), got[key + ("grad",)], ref)]
            err = max(err, *errs)
            extra["grad_max_abs_err"] = max(errs)
        s, t, d = q.shape[1], k.shape[1], qh.shape[-1]
        record("K3", key, err, times, q.element_size() * B * h * (2 * s + 2 * t)
               * d, 4.0 * B * h * s * t * d, dt, H=h, S=s, T=t, D=d, **extra)

    plain4 = api["fused_matmul_plain"]
    for key, (x, w, b, r, relu) in inputs["K4"].items():
        dt = key[2]
        x2 = x.reshape(-1, x.shape[-1])
        r2 = None if r is None else r.reshape(x2.shape[0], -1)
        ref = plain4(x2, w, b, r2, relu)
        err = _check(got[key].reshape(ref.shape), ref, dt, f"K4 {key[1]} {dt}")
        lib = _cublas_chain(x2, w, b, r2, relu)
        _check(lib(), ref, dt, f"cuBLAS chain {key[1]} {dt}")
        times = _timed_api(k4, plain4, lib, (x2, w, b, r2, relu))
        (m, kk), n = x2.shape, w.shape[1]
        es = x.element_size()
        nbytes = es * (m * kk + kk * n + m * n * (2 if r is not None else 1)) \
            + 4 * n
        record("K4", key, err, times, nbytes, 2.0 * m * n * kk, dt, M=m, K=kk,
               N=n, residual=r is not None, relu=relu)

    plain6, plain6_bwd = api["layer_norm_plain"], api["layer_norm_backward_plain"]
    F = torch.nn.functional
    for key, (x, sc, bi, g) in inputs["K6"].items():
        dt = key[2]
        out, dx, ds, db = got[key]
        what = f"K6 {key[1]} {dt}"
        err_f = _check(out, plain6(x, sc, bi), dt, what + " out")
        rdx, rds, rdb = plain6_bwd(x, sc, g)
        err_b = _check(dx, rdx, dt, what + " dx")
        xf, gf = x.float(), g.float()
        xc = xf - xf.mean(-1, keepdim=True)
        xhat = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + 1e-5)
        for name, a, b_, terms in (("dscale", ds, rds.sum(0), gf * xhat),
                                   ("dbias", db, rdb.sum(0), gf)):
            # f32 sums over every row: the f32 bars, and each column within
            # the rounding its sum can have
            err_b = max(err_b, _check(a, b_, torch.float32, f"{what} {name}"))
            e, bar = (a - b_).abs(), _sum_bar(terms)
            assert (e <= bar).all(), (what, name, e.max().item(),
                                      bar.min().item())
        w_dt, b_dt = sc.to(dt), bi.to(dt)
        with torch.no_grad():
            lib_f = lambda: F.layer_norm(x, x.shape[-1:], w_dt, b_dt)  # noqa: E731
            _check(lib_f(), out, dt, what + ": F.layer_norm")
            t_f = _timed_api(k6, plain6, lib_f, (x, sc, bi))
        xg, wg, bg = (t.detach().requires_grad_() for t in (x, w_dt, b_dt))
        y_lib = F.layer_norm(xg, x.shape[-1:], wg, bg)
        lib_b = lambda: torch.autograd.grad(y_lib, (xg, wg, bg), g,  # noqa: E731
                                            retain_graph=True)
        plain_b = lambda x, sc, g: [  # noqa: E731
            t.sum(0) if i else t for i, t in enumerate(plain6_bwd(x, sc, g))]
        t_b = _timed_api(k6_bwd, plain_b, lib_b, (x, sc, g))
        del y_lib
        rows_n, c = x.shape
        es = x.element_size()
        record("K6 fwd", key, err_f, t_f, es * 2 * rows_n * c + 8 * c,
               10.0 * rows_n * c, torch.float32, rows=rows_n, C=c)
        record("K6 bwd", key, err_b, t_b, es * 3 * rows_n * c + 12 * c,
               20.0 * rows_n * c, torch.float32, rows=rows_n, C=c)

    # the model's own activations, against the modules' outputs
    model_err = {"K4": 0.0, "K6": 0.0}
    for name, a, ref in model_got:
        e = _check(a, ref, ref.dtype, f"{name} on the model's activations")
        model_err[name] = max(model_err[name], e)
    print(f"on the b16 bf16 folded R50 forward's activations: K6 on "
          f"{len(lns)} decoder LNs max|err| {model_err['K6']:.3e}, K4 on "
          f"{len(fc1s)} FFN fc1s (ReLU) max|err| {model_err['K4']:.3e}",
          flush=True)
    for name in model_err:
        key = "K6 fwd" if name == "K6" else name
        worst[key] = max(worst[key], model_err[name])
    seconds = time.perf_counter() - t0
    print(f"phase 11: {seconds:.1f} s", flush=True)
    return dict(rows=rows, worst=worst, launches=launches, by_route=by_route,
                model_max_abs_err=model_err, seconds=seconds)


def _run_line(path: str) -> dict:
    with open(path) as f:
        return json.loads(f.read().rsplit("=> run: ", 1)[1].splitlines()[0])


def _close_log():
    from cris_tpu_torch.utils.logging import logger

    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()


def phase_test_path(k1):
    """13: the codec's bits on the card, the first batch's f32
    probabilities card vs CPU, and python3 -m cris_tpu_torch.test's main
    over 64 synthetic refs at R50 416 px, b64, bf16, folded. Returns the
    run's numbers, with K1's launches by route during main alone."""
    from cris_tpu_torch import test as entry
    from cris_tpu_torch.data import RefDataset, SyntheticBackend, codec
    from cris_tpu_torch.engine import Evaluator
    from cris_tpu_torch.models import build_segmenter
    from cris_tpu_torch.utils import cris_r50_refcoco, tokenize

    t0 = time.perf_counter()
    path = codec.build()
    build_s = time.perf_counter() - t0
    img = codec.decode_image(base64.b64decode(CODEC_JPEG_B64))
    digest = hashlib.sha256(img.tobytes()).hexdigest()
    print(f"codec: {path.name} built in {build_s:.1f} s; the embedded JPEG "
          f"decodes to {img.shape}, sha256 {digest}", flush=True)
    assert img.shape == CODEC_JPEG_SHAPE, img.shape
    assert digest == CODEC_JPEG_SHA256, digest

    cfg = cris_r50_refcoco()
    uri, b = "synthetic://64?seed=0", cfg.batch_size_val
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, cfg.exp_name)
        os.makedirs(out_dir)
        weights = os.path.join(out_dir, "best_model.pth")
        torch.save({"state_dict": build_segmenter(cfg, device="cpu",
                                                  seed=0).state_dict()},
                   weights)
        masks = SyntheticBackend(64, seed=0).materialize_masks(
            os.path.join(tmp, "masks"))

        # the first device batch, as inference packs it, f32 card vs CPU
        data = RefDataset(uri, masks, cfg.dataset, cfg.test_split, "test",
                          cfg.input_size, cfg.word_len)
        pairs = sum(data.backend[i]["num_sents"] for i in range(len(data)))
        images, words = [], []
        for i in range(len(data)):
            sample = data[i]
            for sent in sample["sents"][: b - len(images)]:
                images.append(sample["image"])
                words.append(tokenize(sent, cfg.word_len, True)[0])
            if len(images) == b:
                break
        images, words = np.stack(images), np.stack(words)
        probs = {}
        for device in ("cuda", "cpu"):
            model = entry.load_model(cfg, weights, torch.device(device))
            ev = Evaluator(model, cfg.input_size, None, batch_size=b)
            t0 = time.perf_counter()
            probs[device] = torch.from_numpy(ev._fetch(
                ev._dispatch(images, words), b))
            print(f"first batch f32 on {device}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            del model, ev
        rel = _rel(probs["cuda"], probs["cpu"])
        print(f"test.py path, first batch of {b} pairs, f32 folded "
              f"probabilities card vs CPU: rel L2 {rel:.3e}", flush=True)
        assert torch.isfinite(probs["cuda"]).all()
        assert rel <= 1e-4, rel
        torch.cuda.empty_cache()

        argv = ["--config", os.path.join("config", "refcoco", "cris_r50.yaml"),
                "--opts", "TRAIN.output_folder", tmp, "TEST.test_lmdb", uri,
                "DATA.mask_root", masks, "TRAIN.batch_size_val", str(b)]
        reset_counts(k1)
        t0 = time.perf_counter()
        iou, prec = entry.main(argv)
        seconds = time.perf_counter() - t0
        by_route = dict(k1.launches_by_route)
        launches = k1.launches
        _close_log()
        run = _run_line(os.path.join(out_dir, "test.log"))
    batches = -(-pairs // b)
    busy = run["device_seconds"] / run["seconds"]
    print(f"python3 -m cris_tpu_torch.test ({uri}, R50 416 px, b{b}, bf16, "
          f"folded): IoU {100 * iou:.2f}, "
          + ", ".join(f"{k} {100 * v:.2f}" for k, v in prec.items())
          + f"; {run['pairs']} pairs in {run['batches']} batches, "
          f"{run['pairs_per_s']:.2f} pairs/s on the host clock "
          f"({run['seconds']:.2f} s in inference, {seconds:.2f} s in main), "
          f"the card busy {run['device_seconds']:.3f} s ({busy:.4f}, the host "
          f"{1 - busy:.4f}); K1 {launches} launches, "
          f"{launches / run['batches']:.1f} a batch, by route {by_route}; "
          f"on {run['card']}", flush=True)
    assert run["pairs"] == pairs and run["batches"] == batches, (run, pairs)
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0
               for v in [iou, *prec.values()]), (iou, prec)
    assert sorted(prec) == ["Pr@50", "Pr@60", "Pr@70", "Pr@80", "Pr@90",
                            "oIoU"], prec
    want = 7 * batches  # 3 decoder layers x 2 sites + attnpool
    assert launches == want, (launches, want)
    assert by_route == {"tensor_cores": want, "scalar": 0}, by_route
    return {"iou": iou, "prec": prec, "run": run, "main_seconds": seconds,
            "busy_share": busy, "first_batch_rel_l2": rel,
            "codec_build_seconds": build_s, "K1": launches,
            "K1_by_route": by_route}


def phase_train_entry(k1, k2, k2_bwd):
    """14: python3 -m cris_tpu_torch.train at CRIS-R50, 416 px, bf16,
    dropout 0.1, b64: (a) a seeded RN50 CLIP traced into a TorchScript
    archive and built from it; (b) main over 128 synthetic refs (2 steps
    an epoch) and 64 val refs, 2 epochs, milestone 1, every batch through
    the native data plane; (c) a resume to epoch 3; (d) remat against no
    remat. Returns (b)'s numbers."""
    import copy
    import re

    from cris_tpu_torch import cli
    from cris_tpu_torch import test as test_entry
    from cris_tpu_torch import train as entry
    from cris_tpu_torch.checkpoint import (BEST_NAME, LAST_NAME,
                                           load_clip_torchscript)
    from cris_tpu_torch.checkpoint.torch_convert import save_clip_torchscript
    from cris_tpu_torch.engine import (Evaluator, make_optimizer, step_seed,
                                       train_step)
    from cris_tpu_torch.grad_spread import grad_faults, grad_rel
    from cris_tpu_torch.models import (CLIP, CLIP_PRESETS, build_segmenter,
                                       init_weights)
    from cris_tpu_torch.profile_train import make_batches
    from cris_tpu_torch.utils import cris_r50_refcoco

    t_phase = time.perf_counter()
    cfg = cris_r50_refcoco()
    assert cfg.precision == "bf16" and cfg.dropout == 0.1
    # phases 2, 5 and 6 hold K1 and K2 at this batch
    assert cfg.batch_size == cfg.batch_size_val == TRAIN_PY_B
    b, steps, val_batches = cfg.batch_size, 2 * 2, 2 * 1
    sites = 2 * cfg.num_layers
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) a released-format archive in, the RN50 preset and its bits out
        clip = init_weights(CLIP(CLIP_PRESETS["RN50"]), 5)
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():  # BN statistics other than the init's 0 and 1
            for buf in clip.buffers():
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
        archive = save_clip_torchscript(clip, os.path.join(tmp, "RN50.pt"))
        sd, inferred = load_clip_torchscript(archive)
        assert inferred == CLIP_PRESETS["RN50"], inferred
        built_cfg = copy.deepcopy(cfg)
        built_cfg.clip_pretrain = archive
        built = cli.build_model(built_cfg, "cuda").state_dict()
        want = clip.state_dict()
        assert set(sd) == set(want)
        for k, v in want.items():
            assert torch.equal(built["backbone." + k].cpu(), v), k
        print(f"(a) archive {os.path.getsize(archive) / 2**20:.1f} MiB, "
              f"{len(sd)} tensors: inferred config == RN50 preset, the built "
              f"backbone equals the traced weights bit for bit", flush=True)
        del built, clip, sd
        torch.cuda.empty_cache()

        # (b) train, validate, save
        argv = ["--config", os.path.join("config", "refcoco", "cris_r50.yaml"),
                "--opts", "TRAIN.clip_pretrain", archive,
                "DATA.train_lmdb", "synthetic://128?seed=1",
                "DATA.val_lmdb", "synthetic://64?seed=2", "DATA.mask_root", "",
                "TRAIN.epochs", "2", "TRAIN.milestones", "[1]",
                "TRAIN.print_freq", "1", "TRAIN.output_folder", tmp]
        out_dir = os.path.join(tmp, cfg.exp_name)
        reset_counts(k1, k2, k2_bwd)
        t0 = time.perf_counter()
        with plane_calls() as calls:
            best, last = entry.main(argv)
        main_s = time.perf_counter() - t0
        # each epoch's 2 train batches and 1 val batch, one plane call each
        assert calls == [b] * 3 * 2, calls
        counts = {"K1": k1.launches, "K2 fwd": k2.launches,
                  "K2 bwd": k2_bwd.launches}
        routes = {"K1": dict(k1.launches_by_route),
                  "K2 fwd": dict(k2.launches_by_route),
                  "K2 bwd": dict(k2_bwd.launches_by_route)}
        _close_log()
        log_path = os.path.join(out_dir, "train.log")
        with open(log_path) as f:
            log = f.read()
        run = _run_line(log_path)
        lines = re.findall(r"Epoch=\[(\d)/2\] \[(\d)/2\].*Lr=(\S+)\s+"
                           r"Loss=(\S+)", log)
        losses = [float(x[3]) for x in lines]
        ckpt = torch.load(os.path.join(out_dir, LAST_NAME), map_location="cpu",
                          weights_only=False)
        lrs = [g["lr"] for g in ckpt["optimizer"]["param_groups"]]
        print(f"(b) python3 -m cris_tpu_torch.train (R50 416 px, b{b}, bf16, "
              f"dropout 0.1, 2 epochs of 2 steps, milestone 1): losses "
              f"{losses}, logged lr {[float(x[2]) for x in lines]}, group lrs "
              f"after 4 steps {lrs}, best IoU {best:.6f} (epoch {last}); "
              f"launches {counts}, by route {routes}; {len(calls)} batches "
              f"of {b} through the native data plane; main {main_s:.1f} s",
              flush=True)
        print(f"(b) => run: {json.dumps(run)}", flush=True)
        assert last == 2 and len(losses) == steps, (last, lines)
        assert all(np.isfinite(losses)), losses
        decayed = cfg.base_lr * cfg.lr_decay  # after the milestone epoch
        assert np.allclose([float(x[2]) for x in lines],
                           [cfg.base_lr] * 2 + [decayed] * 2), lines
        assert np.allclose(lrs, [decayed * cfg.lr_multi, decayed],
                           rtol=1e-12), lrs
        assert ckpt["scheduler"]["last_epoch"] == steps
        assert ckpt["epoch"] == 2 and ckpt["best_iou"] == best
        want = {"K1": steps + 7 * val_batches, "K2 fwd": sites * steps,
                "K2 bwd": sites * steps}
        assert counts == want, (counts, want)
        for name, n in want.items():
            assert routes[name] == {"tensor_cores": n, "scalar": 0}, routes
        assert run["steps"] == steps and run["images"] == steps * b, run
        assert os.path.isfile(os.path.join(out_dir, BEST_NAME))
        model = test_entry.load_model(cfg, os.path.join(out_dir, BEST_NAME),
                                      torch.device("cuda"))
        gen = torch.Generator().manual_seed(3)
        probs = Evaluator(model, cfg.input_size, torch.bfloat16).predict_probs(
            torch.randn(2, 3, cfg.input_size, cfg.input_size,
                        generator=gen).numpy(),
            torch.randint(1, 400, (2, cfg.word_len), generator=gen).numpy())
        assert probs.shape == (2, cfg.input_size, cfg.input_size)
        assert np.isfinite(probs).all()
        del model
        out.update(best_iou=best, losses=losses, run=run, main_seconds=main_s,
                   launches=counts, by_route=routes)

        # (c) resume: 1 more epoch from last_model.pth
        seen = []
        real_epoch = entry.train_epoch

        def first_epoch(model, optimizer, scheduler, *args, **kwargs):
            if not seen:
                state = optimizer.state_dict()
                seen.append(scheduler.last_epoch)
                for i, group in ckpt["optimizer"]["state"].items():
                    for key, value in group.items():
                        assert torch.equal(state["state"][i][key].cpu(),
                                           value), (i, key)
                assert state["param_groups"] == ckpt["optimizer"][
                    "param_groups"]
            return real_epoch(model, optimizer, scheduler, *args, **kwargs)

        entry.train_epoch = first_epoch
        try:
            best3, last3 = entry.main(argv + [
                "TRAIN.epochs", "3", "TRAIN.resume",
                os.path.join(out_dir, LAST_NAME)])
        finally:
            entry.train_epoch = real_epoch
        _close_log()
        with open(log_path) as f:
            log = f.read()
        ckpt3 = torch.load(os.path.join(out_dir, LAST_NAME),
                           map_location="cpu", weights_only=False)
        resumed = f"=> loaded checkpoint '{os.path.join(out_dir, LAST_NAME)}'" \
                  " (epoch 2)"
        print(f"(c) resume: '{resumed}' logged {resumed in log}, "
              f"scheduler.last_epoch {seen}, optimizer state equal to the "
              f"saved one before the first step; epoch 3 IoU "
              f"{ckpt3['cur_iou']:.6f}, best IoU {best:.6f} -> {best3:.6f}",
              flush=True)
        assert resumed in log and seen == [steps] and last3 == 3
        assert ckpt3["epoch"] == 3 and ckpt3["scheduler"]["last_epoch"] == 6
        assert best3 == ckpt3["best_iou"] == max(best, ckpt3["cur_iou"])
        del ckpt, ckpt3

    # (d) remat: the same f32 b8 step, and a bf16 b64 step's peak memory
    bases = {}
    for remat in (False, True):
        c = copy.deepcopy(cfg)
        c.remat = remat
        bases[remat] = (c, build_segmenter(c, device="cpu", seed=0,
                                           train=True))

    def remat_step(remat, batch, dtype):
        c, base = bases[remat]
        model = copy.deepcopy(base).cuda()
        opt, sched = make_optimizer(model, c, steps_per_epoch=100)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = train_step(model, opt, sched, batch, step_seed(0, 0),
                          dtype)["loss"].item()
        peak = torch.cuda.max_memory_allocated() / 2**30
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        stats = {n: t.detach().cpu() for n, t in model.named_buffers()}
        del model, opt, sched
        torch.cuda.empty_cache()
        return loss, grads, stats, peak

    batch = make_batches(1, 8, cfg.input_size, cfg.word_len, "cuda", seed=7)[0]
    off, on, off2 = (remat_step(r, batch, None) for r in (False, True, False))
    names = list(off[1])
    head = [n for n in names if not n.startswith("backbone.")]
    faults = grad_faults(on[1], off[1], off2[1], names, head)
    rel, spread = grad_rel(on[1], off[1], names), grad_rel(off2[1], off[1],
                                                          names)
    same_stats = all(torch.equal(on[2][n], off[2][n]) for n in off[2])
    print(f"(d) remat, f32 b8 dropout 0.1: loss {on[0]:.6f} vs {off[0]:.6f}; "
          f"gradients' global rel L2 {rel:.3e} (no remat against itself "
          f"{spread:.3e}); {len(faults)} outside phase 7's bars; BN "
          f"statistics equal: {same_stats}", flush=True)
    assert abs(on[0] - off[0]) <= 1e-4 * abs(off[0]), (on[0], off[0])
    assert not faults, faults[:5]
    assert same_stats
    batch = make_batches(1, b, cfg.input_size, cfg.word_len, "cuda", seed=8)[0]
    peaks = {r: remat_step(r, batch, torch.bfloat16)[3] for r in (False, True)}
    print(f"(d) bf16 b{b} train step peak memory: no remat {peaks[False]:.2f} "
          f"GiB, remat {peaks[True]:.2f} GiB; on {card_line()}", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 14: {seconds:.1f} s", flush=True)
    out.update(remat_rel_l2=rel, remat_spread=spread,
               peak_gib={"no remat": peaks[False], "remat": peaks[True]},
               seconds=seconds)
    return out


@contextlib.contextmanager
def plane_calls():
    """Counts the native data plane's calls (the batch size of each) while
    open: RefDataset.get_batch reaches it as native.batch_preprocess."""
    from cris_tpu_torch.data import native

    real, calls = native.batch_preprocess, []

    def counted(img_bytes, *args, **kwargs):
        calls.append(len(img_bytes))
        return real(img_bytes, *args, **kwargs)

    native.batch_preprocess = counted
    try:
        yield calls
    finally:
        native.batch_preprocess = real


# phase 15's train.py A/B: a refpack of 1280 bench images (20 steps of 64)
HOST_AB_RECORDS, HOST_AB_STEPS, HOST_AB_CHUNK = 1280, 20, 64


def _bench_records(n: int) -> list:
    """n records of the bench's 640 x 480 JPEG images and PNG masks,
    made in chunks of 64 (chunk k from seed k) on a pool of processes."""
    import multiprocessing

    from cris_tpu_torch.data.host_bench import make_test_jpegs

    chunks = [(HOST_AB_CHUNK, (640, 480), k) for k in range(n // HOST_AB_CHUNK)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(len(chunks), os.cpu_count() or 1)) as pool:
        made = pool.starmap(make_test_jpegs, chunks)
    records = []
    for imgs, masks in made:
        for img, mask in zip(imgs, masks):
            i = len(records)
            records.append({"img": img, "mask": mask, "cat": 0, "seg_id": i,
                            "img_name": f"bench_{i}.jpg", "num_sents": 2,
                            "sents": [f"the disc number {i % 7}",
                                      "the round thing on the left"]})
    return records


def phase_host_plane(k1, k2, k2_bwd):
    """15: the native data plane on the card's host: (a) the library built
    from csrc/; (b) RefDataset.get_batch through the plane against the
    per-sample path on 64 640 x 480 JPEG records, train and val,
    np.array_equal on every array; (c) host_input_pipeline_640x480 at its
    module's default size; (d) python3 -m cris_tpu_torch.train at R50 b64
    bf16 over a refpack of 1280 such records, 20 steps an arm, the plane,
    then CRIS_NATIVE=0, one run each: img/s, the profiler window's busy
    share and K1/K2's launches by route per run. Returns the numbers."""
    from cris_tpu_torch import train as entry
    from cris_tpu_torch.bench import card as bench_card
    from cris_tpu_torch.data import RefDataset, codec, write_refpack
    from cris_tpu_torch.data.host_bench import measure_host_pipeline
    from cris_tpu_torch.utils import cris_r50_refcoco

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    path = codec.build()
    print(f"(a) data library {path.name} ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = cris_r50_refcoco()
    b = cfg.batch_size
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        records = _bench_records(HOST_AB_RECORDS)
        train_pack = os.path.join(tmp, "train.refpack")
        val_pack = os.path.join(tmp, "val.refpack")
        write_refpack(train_pack, records)
        write_refpack(val_pack, records[:b])
        masks = os.path.join(tmp, "masks")
        os.makedirs(masks)
        for rec in records[:b]:
            with open(os.path.join(masks, f"{rec['seg_id']}.png"), "wb") as f:
                f.write(rec["mask"])
        made_s = time.perf_counter() - t0

        # (b) the plane against the per-sample path, bit for bit
        for mode in ("train", "val"):
            ds = RefDataset(val_pack, masks, cfg.dataset, "val", mode,
                            cfg.input_size, cfg.word_len)
            idx = list(range(b))
            rngs = [np.random.RandomState(i) for i in idx]
            t0 = time.perf_counter()
            with plane_calls() as calls:
                got = ds.get_batch(idx, rngs)
            plane_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = [ds.__getitem__(i, rng=np.random.RandomState(i))
                    for i in idx]
            sample_s = time.perf_counter() - t0
            assert calls == [b], calls
            arrays = 0
            for x, y in zip(got, want):
                assert set(x) == set(y)
                for key, value in y.items():
                    if isinstance(value, np.ndarray):
                        assert x[key].dtype == value.dtype, key
                        assert np.array_equal(x[key], value), (mode, key)
                        arrays += 1
                    else:
                        assert x[key] == value, (mode, key)
            print(f"(b) {mode}: {b} records ({HOST_AB_RECORDS} made in "
                  f"{made_s:.1f} s): the plane's batch equals the per-sample "
                  f"path's, {arrays} arrays np.array_equal; plane "
                  f"{plane_s:.3f} s, per sample {sample_s:.3f} s", flush=True)

        # (c) the host metric
        host = measure_host_pipeline()
        print(f"(c) {json.dumps({'metric': 'host_input_pipeline_640x480', **host, 'card': card_line()})}",
              flush=True)
        assert host["native_img_s"] > 0 and host["python_img_s"] > 0, host
        out["host"] = host

        # (d) the train entry, the plane, then CRIS_NATIVE=0
        argv = ["--config", os.path.join("config", "refcoco", "cris_r50.yaml"),
                "--opts", "DATA.train_lmdb", train_pack, "DATA.val_lmdb",
                val_pack, "DATA.mask_root", masks, "TRAIN.epochs", "1",
                "TRAIN.print_freq", "5"]
        sites = 2 * cfg.num_layers
        want = {"K1": HOST_AB_STEPS + 7, "K2 fwd": sites * HOST_AB_STEPS,
                "K2 bwd": sites * HOST_AB_STEPS}
        runs = []
        before = os.environ.get("CRIS_NATIVE")
        try:
            for k, (rnd, arm) in enumerate([(0, "plane"), (0, "per-sample")]):
                if arm == "plane":
                    os.environ.pop("CRIS_NATIVE", None)
                else:
                    os.environ["CRIS_NATIVE"] = "0"
                run_dir = os.path.join(tmp, f"run{k}")
                reset_counts(k1, k2, k2_bwd)
                t0 = time.perf_counter()
                with plane_calls() as calls:
                    entry.main(argv + ["TRAIN.output_folder", run_dir,
                                       "TRAIN.profile_dir",
                                       os.path.join(tmp, f"prof{k}")])
                main_s = time.perf_counter() - t0
                _close_log()
                run = _run_line(os.path.join(run_dir, cfg.exp_name,
                                             "train.log"))
                counts = {"K1": k1.launches, "K2 fwd": k2.launches,
                          "K2 bwd": k2_bwd.launches}
                routes = {"K1": dict(k1.launches_by_route),
                          "K2 fwd": dict(k2.launches_by_route),
                          "K2 bwd": dict(k2_bwd.launches_by_route)}
                row = {"round": rnd, "arm": arm,
                       "img_s": run["images_per_s"],
                       "traced_busy_share": run["traced"]["device_busy_share"],
                       "traced": run["traced"], "steps": run["steps"],
                       "step_event_share": run["step_event_share"],
                       "profiler_seconds": run["profiler_seconds"],
                       "plane_calls": len(calls), "launches": counts,
                       "by_route": routes, "main_seconds": main_s,
                       "card": bench_card(torch.device("cuda"))}
                print(f"(d) {json.dumps(row)}", flush=True)
                assert run["steps"] == HOST_AB_STEPS, run
                assert counts == want, (counts, want)
                for name, n in want.items():
                    assert routes[name] == {"tensor_cores": n, "scalar": 0}
                # 20 train batches and 1 val batch through the plane, or none
                assert len(calls) == (HOST_AB_STEPS + 1 if arm == "plane"
                                      else 0), calls
                runs.append(row)
                shutil.rmtree(run_dir)
        finally:
            if before is None:
                os.environ.pop("CRIS_NATIVE", None)
            else:
                os.environ["CRIS_NATIVE"] = before
    for arm in ("plane", "per-sample"):
        rates = [r["img_s"] for r in runs if r["arm"] == arm]
        busy = [r["traced_busy_share"] for r in runs if r["arm"] == arm]
        print(f"(d) {arm}: img/s {rates}, traced busy share {busy}",
              flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 15: {seconds:.1f} s", flush=True)
    out.update(runs=runs, seconds=seconds,
               launches={name: sum(r["launches"][name] for r in runs)
                         for name in want})
    return out


# phase 16: data parallel. (a) K2 at the train.py batch split over DP_WORLD
# ranks; (b) DP_WORLD ranks on the one card over gloo (NCCL refuses two
# ranks on one device) at a global batch of DP_B; (c) the train entry under
# torchrun over NCCL on every card, DP_ENTRY_STEPS steps of the global batch
DP_WORLD, DP_B, DP_ENTRY_STEPS = 2, 8, 4
DP_TIMEOUT = 900  # seconds for (b)'s ranks and (c)'s torchrun


def phase_k2_offset(k2, k2_fwd, plain_k2, keep_bits_packed, rate=0.1):
    """16(a): K2 at the train.py batch's self-attention (676 x 676, 8 x
    64) as rank r of DP_WORLD runs it: local batch TRAIN_PY_B / DP_WORLD
    at batch offsets 0 and that batch, f32 (the scalar kernels) and bf16
    (the tensor-core kernels), each call on its route. Output and dq, dk,
    dv against the plain version with the same seed and offset at phase
    6's bars; on the tensor-core route the forward's packed keep mask
    equals keep_bits_packed at the offset and rows offset .. of the
    global batch's mask, bit for bit; the two offsets give other outputs.
    Forward and backward on the device alone, beside their bound."""
    b = TRAIN_PY_B // DP_WORLD
    s, t, h, d = 676, 676, 8, 64
    seed = 1234567
    gen = torch.Generator(device="cuda").manual_seed(16)
    full = keep_bits_packed(seed, TRAIN_PY_B, h, s, t, rate, "cuda")
    rows = []
    for dtype in BOTH:
        q, k, v, g, _ = _site_inputs(gen, b, s, t, h, d, 0, dtype)
        route = expected_route(dtype, d)
        outs = []
        for offset in (0, b):
            kern = lambda q, k, v: k2(  # noqa: E731
                q, k, v, h, None, rate, seed, offset)
            ref_fn = lambda q, k, v: plain_k2(  # noqa: E731
                q, k, v, h, None, rate, seed, batch_offset=offset)
            before = dict(k2.launches_by_route)
            got = _fwd_bwd(kern, q, k, v, g)
            ref = _reference(ref_fn, q, k, v, g)
            torch.cuda.synchronize()
            what = f"K2 offset {offset} {dtype}"
            e_fwd = _check(got[0], ref[0], dtype, what + " out")
            e_bwd = max(_check(a, b_, dtype, f"{what} {n}")
                        for n, a, b_ in zip(("dq", "dk", "dv"), got[1:],
                                            ref[1:]))
            del ref
            with torch.no_grad():
                _, _, _, bits = k2_fwd(q, k, v, h, None, rate, seed, offset)
            assert _by_route_delta(k2, before) == {
                r: 2 * (r == route) for r in before}, (what, before)
            if route == "tensor_cores":
                assert torch.equal(bits, keep_bits_packed(
                    seed, b, h, s, t, rate, "cuda", offset)), what
                assert torch.equal(bits, full[offset:offset + b]), what
            else:
                assert bits is None, what
            outs.append(got[0])
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            out_k = kern(qg, kg, vg)
            with torch.no_grad():
                fwd_ms = device_ms(lambda: kern(q, k, v), 10)
            bwd_ms = device_ms(lambda: torch.autograd.grad(
                out_k, (qg, kg, vg), g, retain_graph=True), 10)
            del out_k
            row = dict(site="decoder self-attn, a train.py rank's batch",
                       B=b, batch_offset=offset, S=s, T=t, H=h, D=d,
                       dtype=str(dtype).replace("torch.", ""), rate=rate,
                       route=route, fwd_max_abs_err=e_fwd,
                       bwd_max_abs_err=e_bwd, fwd_device_ms=fwd_ms,
                       bwd_device_ms=bwd_ms)
            for part in ("fwd", "bwd"):
                row[f"{part}_bound_ms"], row[f"{part}_bound_by"], _ = \
                    _k2_bound(b, s, t, h, d, dtype, route, part == "bwd",
                              valid_keys=b * t)
            bits_note = ("; packed mask == keep_bits_packed at the offset =="
                         " rows of the B 64 mask"
                         if route == "tensor_cores" else "")
            print(f"16(a) K2 B={b} batch offset {offset} {row['dtype']:8s} "
                  f"route {route}: max|err| out {e_fwd:.3e} grads "
                  f"{e_bwd:.3e}{bits_note}; "
                  f"device alone fwd {fwd_ms:.4f} ms (bound "
                  f"{row['fwd_bound_ms']:.4f}) bwd {bwd_ms:.4f} ms (bound "
                  f"{row['bwd_bound_ms']:.4f})", flush=True)
            rows.append(row)
        assert not torch.equal(outs[0], outs[1]), "the offset is ignored"
    return rows


def _dp_rank(rank, port, tmp):
    """16(b)'s rank ``rank`` of DP_WORLD: joins a gloo group on cuda:0,
    takes one f32 train step of R50 at dropout 0 on its rows of the global
    batch under DistributedDataParallel, then validates the seed-0 eval
    model on its shard of the val refs. Writes what it got to tmp."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD),
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(DP_WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cris_tpu_torch import engine
    from cris_tpu_torch.parallel import (close_distributed, data_parallel,
                                         init_distributed, process_index)

    device = init_distributed("cuda:0", backend="gloo")
    assert process_index() == rank
    base, batch, cfg = _dp_inputs()
    per = DP_B // DP_WORLD
    model = base.to(device)
    opt, sched = engine.make_optimizer(model, cfg, steps_per_epoch=100)
    wrapped = data_parallel(model)
    metrics = engine.train_step(wrapped, opt, sched, {
        k: x[rank * per:(rank + 1) * per] for k, x in batch.items()},
        step_seed=0)
    out = {"wrapped": type(wrapped).__name__,
           "loss": metrics["loss"].item(),
           "grads": {n: p.grad.detach().cpu()
                     for n, p in model.named_parameters()},
           "stats": {n: x.detach().cpu() for n, x in model.named_buffers()}}
    del wrapped, model, opt
    out["validate"] = _dp_validate(device, rank)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    close_distributed()


def _dp_inputs():
    """(the seed-0 R50 f32 train model at dropout 0 on the CPU, the global
    batch of DP_B on the CPU, its config)."""
    from cris_tpu_torch.models import build_segmenter
    from cris_tpu_torch.profile_train import make_batches
    from cris_tpu_torch.utils import cris_r50_refcoco

    cfg = cris_r50_refcoco()
    cfg.dropout = 0.0
    base = build_segmenter(cfg, device="cpu", seed=0, train=True)
    batch = make_batches(1, DP_B, cfg.input_size, cfg.word_len, "cpu",
                         seed=7)[0]
    return base, batch, cfg


def _dp_validate(device, rank=0):
    """Evaluator.validate of the seed-0 R50 f32 eval model over 16
    synthetic refs, in device batches of DP_B / DP_WORLD: with a process
    group, rank ``rank``'s shard of them."""
    from cris_tpu_torch.data import RefDataLoader, RefDataset
    from cris_tpu_torch.engine import Evaluator
    from cris_tpu_torch.models import build_segmenter
    from cris_tpu_torch.parallel import process_count
    from cris_tpu_torch.utils import cris_r50_refcoco

    cfg = cris_r50_refcoco()
    world = process_count()
    model = build_segmenter(cfg, device=device, seed=0)
    per = DP_B // DP_WORLD
    val = RefDataset("synthetic://16?seed=2", None, cfg.dataset, "val",
                     "val", cfg.input_size, cfg.word_len)
    loader = RefDataLoader(val, batch_size=per, num_workers=2,
                           process_index=rank if world > 1 else 0,
                           process_count=world)
    ev = Evaluator(model, cfg.input_size, None, batch_size=per)
    iou, prec = ev.validate(loader)
    return {"iou": iou, "prec": prec, "pairs": ev.last_run["pairs"]}


def _one_step(base, cfg, batch, cudnn=True):
    """One f32 train step of a copy of ``base`` on the card, one process:
    (loss, {name: gradient}, {name: BN running statistic}) on the CPU."""
    from cris_tpu_torch import engine

    model = copy.deepcopy(base).cuda()
    opt, sched = engine.make_optimizer(model, cfg, steps_per_epoch=100)
    with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
        loss = engine.train_step(model, opt, sched, batch,
                                 step_seed=0)["loss"].item()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    stats = {n: x.detach().cpu() for n, x in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return loss, grads, stats


def _stat_faults(got, ref, alt):
    """BN running statistics whose relative L2 from ``ref`` exceeds 1e-5
    plus TENSOR_SPREADS times the one process's own spread ``alt``."""
    from cris_tpu_torch.grad_spread import TENSOR_SPREADS, grad_rel

    return [(n, grad_rel(got, ref, [n]), grad_rel(alt, ref, [n]))
            for n in ref if grad_rel(got, ref, [n])
            > 1e-5 + TENSOR_SPREADS * grad_rel(alt, ref, [n])]


def phase_dp_ranks():
    """16(b): DP_WORLD ranks on the one card over gloo against one process
    on the card: the f32 R50 train step at dropout 0 and global batch
    DP_B, then Evaluator.validate over the ranks against one process in
    device batches of the ranks' size (IoU and every Pr and oIoU within
    1e-6).

    These random weights amplify rounding (phase 7): the one process
    differs from itself, with cuDNN off, by a few percent in its
    gradients. So the ranks are held to bars around that spread, as phase
    7 holds the card to the CPU: the loss within 1e-4 relative, the
    gradients within phase 7's bars (grad_faults), each BN running
    statistic within 1e-5 plus TENSOR_SPREADS own spreads in relative L2,
    the statistics equal on the ranks; the gaps are printed beside 2e-5
    (loss), 1e-4 (gradients) and 1e-5 (statistics). A planted fault must
    fail the bars: each rank's half stepped alone, its BN normalising
    with its own half's statistics (DDP without the sync)."""
    import multiprocessing
    import socket

    from cris_tpu_torch.grad_spread import grad_faults, grad_rel

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    per = DP_B // DP_WORLD
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_dp_rank, args=(r, port, tmp))
                 for r in range(DP_WORLD)]
        for p in procs:
            p.start()
        try:
            # one process on the card beside the ranks; its own spread;
            # the halves without the sync
            base, batch, cfg = _dp_inputs()
            loss, ref, stats = _one_step(base, cfg, batch)
            alt_loss, alt, alt_stats = _one_step(base, cfg, batch,
                                                 cudnn=False)
            halves = [_one_step(base, cfg, {k: x[r * per:(r + 1) * per]
                                            for k, x in batch.items()})
                      for r in range(DP_WORLD)]
            # what the batch size alone does to the card's kernels: the
            # eval forward (no batch statistics) of rows 0:per as a batch
            # of per against the same rows inside the batch of DP_B
            with torch.no_grad():
                ev = copy.deepcopy(base).cuda().eval()
                img, word = batch["image"].cuda(), batch["word"].cuda()
                batch_rel = _rel(ev(img[:per], word[:per]),
                                 ev(img, word)[:per])
                del ev
            single_val = _dp_validate(torch.device("cuda"))
        finally:
            for p in procs:
                p.join(DP_TIMEOUT)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        assert codes == [0] * DP_WORLD, f"16(b) ranks exited {codes}"
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]
    assert all(r["wrapped"] == "DistributedDataParallel" for r in ranks)
    got = ranks[0]["grads"]
    got_stats = {n: ranks[0]["stats"][n] for n in stats}
    for r in ranks[1:]:
        for n, g in r["grads"].items():
            assert torch.equal(g, got[n]), n
        for n, x in r["stats"].items():
            assert torch.equal(x, ranks[0]["stats"][n]), n
    names = list(ref)
    head = [n for n in names if not n.startswith("backbone.")]

    def rel_loss_of(x):
        return abs(x - loss) / abs(loss)

    def worst_stat(x):
        return max(grad_rel(x, stats, [n]) for n in stats)

    dp_loss = float(np.mean([r["loss"] for r in ranks]))
    unsynced = {"loss": float(np.mean([h[0] for h in halves])),
                "grads": {n: sum(h[1][n] for h in halves) / DP_WORLD
                          for n in names},
                "stats": halves[0][2]}
    readings = {}
    for label, (l_, g_, s_) in (("ranks", (dp_loss, got, got_stats)),
                                ("cuDNN off", (alt_loss, alt, alt_stats)),
                                ("halves unsynced",
                                 tuple(unsynced.values()))):
        readings[label] = dict(
            rel_loss=rel_loss_of(l_), rel_grad=grad_rel(g_, ref, names),
            rel_grad_head=grad_rel(g_, ref, head),
            worst_stat_rel=worst_stat(s_),
            grad_faults=len(grad_faults(g_, ref, alt, names, head)),
            stat_faults=len(_stat_faults(s_, stats, alt_stats)))
        print(f"16(b) R50 f32 train step b{DP_B}, {label} vs one process: "
              f"{json.dumps(readings[label])}", flush=True)
    mine, off = readings["ranks"], readings["cuDNN off"]
    print(f"16(b) {DP_WORLD} gloo ranks on one card: loss {dp_loss:.7f} vs "
          f"{loss:.7f}; against 2e-5 (loss), 1e-4 (gradients) and 1e-5 "
          f"(statistics): {mine['rel_loss']:.3e}, {mine['rel_grad']:.3e}, "
          f"{mine['worst_stat_rel']:.3e}, where the one process against "
          f"itself with cuDNN off reads {off['rel_loss']:.3e}, "
          f"{off['rel_grad']:.3e}, {off['worst_stat_rel']:.3e}; the eval "
          f"logits of "
          f"{per} rows as a batch of {per} against inside the batch of "
          f"{DP_B}: rel L2 {batch_rel:.3e}; statistics and gradients equal "
          f"on the ranks; logit_scale's gradient zero", flush=True)
    assert mine["rel_loss"] <= 1e-4, mine
    assert mine["grad_faults"] == 0 and mine["stat_faults"] == 0, mine
    assert not got["backbone.logit_scale"].any()
    bad = readings["halves unsynced"]
    assert (bad["rel_loss"] > 1e-4 or bad["grad_faults"]
            or bad["stat_faults"]), ("phase 16(b)'s bars let BN without "
                                     "the sync pass", bad)
    val = [r["validate"] for r in ranks]
    print(f"16(b) validate over {DP_WORLD} ranks: IoU {val[0]['iou']!r} "
          f"(pairs {[v['pairs'] for v in val]}) vs one process "
          f"{single_val['iou']!r} ({single_val['pairs']} pairs); oIoU "
          f"{val[0]['prec']['oIoU']!r} vs {single_val['prec']['oIoU']!r}",
          flush=True)
    assert sum(v["pairs"] for v in val) == single_val["pairs"] == 16
    for v in val:
        assert abs(v["iou"] - single_val["iou"]) <= 1e-6, (v, single_val)
        for key, x in single_val["prec"].items():
            assert abs(v["prec"][key] - x) <= 1e-6, (key, v, single_val)
    seconds = time.perf_counter() - t0
    return dict(loss=dp_loss, single_loss=loss, readings=readings,
                batch_size_logits_rel=batch_rel, validate=val[0],
                single_validate=single_val, seconds=seconds)


def _run_group(cmd, timeout, **kwargs):
    """Run cmd in a session of its own; on a timeout kill the whole
    session (torchrun's workers with their agent) and raise."""
    import signal

    proc = subprocess.Popen(cmd, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, **kwargs)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, log


def phase_dp_entry():
    """16(c): torchrun --nproc_per_node=<cards> -m cris_tpu_torch.train at
    R50 b64 bf16 over NCCL, 1 epoch of DP_ENTRY_STEPS steps over JPEG
    records of the bench (phase 15's), the first 64 as the val set: the
    run line's world_size, images and per-rank K1 and K2 launches, every
    one on the tensor cores."""
    from cris_tpu_torch.data import write_refpack
    from cris_tpu_torch.utils import cris_r50_refcoco

    n = torch.cuda.device_count()
    cfg = cris_r50_refcoco()
    b = cfg.batch_size
    if n == 1:
        print(f"16(c) one card: torchrun runs 1 rank over NCCL; no "
              f"multi-card rate was measured", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        records = _bench_records(DP_ENTRY_STEPS * b)
        train_pack = os.path.join(tmp, "train.refpack")
        val_pack = os.path.join(tmp, "val.refpack")
        write_refpack(train_pack, records)
        write_refpack(val_pack, records[:b])
        masks = os.path.join(tmp, "masks")
        os.makedirs(masks)
        for rec in records[:b]:
            with open(os.path.join(masks, f"{rec['seg_id']}.png"), "wb") as f:
                f.write(rec["mask"])
        out = os.path.join(tmp, "out")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={n}", "-m", "cris_tpu_torch.train",
               "--config", os.path.join("config", "refcoco", "cris_r50.yaml"),
               "--opts", "DATA.train_lmdb", train_pack, "DATA.val_lmdb",
               val_pack, "DATA.mask_root", masks, "TRAIN.epochs", "1",
               "TRAIN.print_freq", "1", "TRAIN.output_folder", out]
        env = dict(os.environ, PYTHONPATH=here)
        t0 = time.perf_counter()
        code, log = _run_group(cmd, DP_TIMEOUT, cwd=here, env=env)
        seconds = time.perf_counter() - t0
        assert code == 0, f"16(c) torchrun exited {code}:\n{log[-6000:]}"
        run = _run_line(os.path.join(out, cfg.exp_name, "train.log"))
    print(f"16(c) torchrun --nproc_per_node={n} -m cris_tpu_torch.train (R50 "
          f"416 px, b{b}, bf16, NCCL, {DP_ENTRY_STEPS} steps): {seconds:.1f} "
          f"s; => run: {json.dumps(run)}", flush=True)
    assert log.count("=> run: ") == 1, "more than rank 0 logged"
    assert run["world_size"] == n and run["steps"] == DP_ENTRY_STEPS, run
    assert run["images"] == DP_ENTRY_STEPS * b, run
    sites = 2 * cfg.num_layers
    want = {"K1": DP_ENTRY_STEPS + 7, "K2 fwd": sites * DP_ENTRY_STEPS,
            "K2 bwd": sites * DP_ENTRY_STEPS}
    for name, per_rank in want.items():
        by_route = run["launches"][name]
        assert by_route == {"tensor_cores": [per_rank] * n,
                            "scalar": [0] * n}, (name, by_route)
    return dict(run=run, seconds=seconds, cards=n,
                launches={name: sum(run["launches"][name]["tensor_cores"])
                          for name in want})


def phase_data_parallel(k2, k2_fwd, plain_k2, keep_bits_packed):
    """16: K2 with a batch offset, two gloo ranks on the one card, and the
    train entry under torchrun over NCCL."""
    t0 = time.perf_counter()
    out = {"k2_offset": phase_k2_offset(k2, k2_fwd, plain_k2,
                                        keep_bits_packed)}
    torch.cuda.empty_cache()
    out["ranks"] = phase_dp_ranks()
    torch.cuda.empty_cache()
    out["entry"] = phase_dp_entry()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 16: {out['seconds']:.1f} s on {card_line()}", flush=True)
    return out


FIXTURES = os.path.join("tests", "torch_codec_fixtures")


def _http(url, payload=None, path="/predict"):
    """(status, reply JSON) of a GET (payload None) or a POST (a dict or
    raw bytes) to the front."""
    import urllib.error
    import urllib.request

    data = payload
    if isinstance(payload, dict):
        data = json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 method="GET" if payload is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _rle_mask(rle) -> np.ndarray:
    """COCO uncompressed RLE (column-major runs from zeros) -> bool mask."""
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos, value = 0, False
    for n in rle["counts"]:
        flat[pos:pos + n] = value
        pos, value = pos + n, not value
    return flat.reshape(w, h).T


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def _times_ms(call, n: int) -> list:
    """Host-clock ms of n calls (each ends with its results on the
    host)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _on_fresh_thread(fn, *args):
    """fn(*args) on a new thread, as ThreadingHTTPServer runs a request."""
    import threading

    out = []
    thread = threading.Thread(target=lambda: out.append(fn(*args)))
    thread.start()
    thread.join()
    assert out, "the call on the fresh thread failed"
    return out[0]


def phase_front(k1):
    """17: (a) the committed decoder fixtures to OpenCV's digests, and the
    progressive fixture's host decode time against its baseline twin; (b)
    the HTTP front (serving.make_server) over an R50 PredictService at 416
    px, bf16, BN folded, seed-0 weights from best_model.pth: /healthz, a
    progressive JPEG with 3 sentences (rle), an RGBA PNG with 1 (png_b64),
    an image_path request, {} and undecodable bytes (400 each), then 20
    requests of 1 and 20 of 4 sentences timed on the host clock; K1 7 times
    a device batch, all on the tensor cores; every mask equal to
    PredictService.predict on the decoded pixels; (c) python3 -m
    cris_tpu_torch.predict on the card with the same weights: its masks
    and overlays."""
    import threading

    from cris_tpu_torch.data import codec
    from cris_tpu_torch.models import build_segmenter
    from cris_tpu_torch.predict import overlay
    from cris_tpu_torch.serving import PredictService, make_server
    from cris_tpu_torch.utils import cris_r50_refcoco

    card = card_line()
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        table = json.load(f)
    data = {}
    for name, want in sorted(table["files"].items()):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data[name] = f.read()
        for key, decode in (("color", codec.decode_image),
                            ("gray", codec.decode_mask)):
            img = decode(data[name])
            digest = hashlib.sha256(img.tobytes()).hexdigest()
            assert list(img.shape) == want[key]["shape"], (name, img.shape)
            assert digest == want[key]["sha256"], (name, key, digest)
    print(f"17(a) {len(data)} fixtures decode to OpenCV {table['opencv']}'s "
          f"digests under both flags: {sorted(data)}", flush=True)
    prog, base = (data[f"{k}_420_640x480.jpg"]
                  for k in ("progressive", "baseline"))
    decode_ms = {"progressive": [], "baseline": []}
    for _ in range(20):
        for kind, buf in (("progressive", prog), ("baseline", base)):
            t0 = time.perf_counter()
            codec.decode_image(buf)
            decode_ms[kind].append((time.perf_counter() - t0) * 1e3)
    decode = {k: {"median_ms": _pct(v, 50), "p90_ms": _pct(v, 90)}
              for k, v in decode_ms.items()}
    print(f"17(a) host decode of the 640x480 4:2:0 fixture, 20 each in "
          f"turns: progressive median {decode['progressive']['median_ms']:.3f}"
          f" ms (p90 {decode['progressive']['p90_ms']:.3f}), baseline "
          f"{decode['baseline']['median_ms']:.3f} ms (p90 "
          f"{decode['baseline']['p90_ms']:.3f}); {os.cpu_count()} host cores;"
          f" card {card}", flush=True)

    cfg = cris_r50_refcoco()
    assert (cfg.input_size, cfg.precision) == (416, "bf16")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        os.makedirs(ckpt)
        torch.save({"state_dict": build_segmenter(cfg, device="cpu",
                                                  seed=0).state_dict()},
                   os.path.join(ckpt, "best_model.pth"))
        t0 = time.perf_counter()
        service = PredictService(cfg, model_dir=ckpt, device="cuda",
                                 max_batch=16)
        build_s = time.perf_counter() - t0
        batches = []
        inner = service.evaluator.predict_probs

        def counted(image, word):
            batches.append(image.shape[0])
            return inner(image, word)

        service.evaluator.predict_probs = counted
        server = make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        path = os.path.abspath(os.path.join(FIXTURES, "adam7_rgb_160x120.png"))
        b64 = {n: base64.b64encode(b).decode() for n, b in data.items()}
        requests = [
            ("progressive", {"image_b64": b64["progressive_420_640x480.jpg"],
                             "sentences": ["the man on the left",
                                           "a red car", "the sky"],
                             "format": "rle"}),
            ("rgba", {"image_b64": b64["rgba_160x120.png"],
                      "sentence": "the bright patch", "format": "png_b64"}),
            ("path", {"image_path": path, "sentences": ["a", "the b"],
                      "format": "rle"}),
        ]
        try:
            reset_counts(k1)
            status, health = _http(url, path="/healthz")
            assert status == 200 and health == {"status": "ok",
                                                "input_size": 416}, health
            replies = {}
            for name, req in requests:
                status, replies[name] = _http(url, req)
                assert status == 200, (name, replies[name])
            for bad in ({}, {"image_b64": base64.b64encode(
                    b"GIF89a, not a JPEG or PNG").decode(), "sentence": "x"}):
                status, reply = _http(url, bad)
                assert status == 400, (bad, status, reply)
            print(f"17(b) the front: /healthz, 3 requests answered 200, {{}} "
                  f"and undecodable bytes 400 ({reply['error']!r})",
                  flush=True)
            latency = {}
            for n in (1, 4):
                req = {"image_b64": b64["progressive_420_640x480.jpg"],
                       "sentences": [f"the person number {i}"
                                     for i in range(n)], "format": "rle"}
                times = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    status, _ = _http(url, req)
                    times.append((time.perf_counter() - t0) * 1e3)
                    assert status == 200
                latency[n] = {"median_ms": _pct(times, 50),
                              "p90_ms": _pct(times, 90)}
                print(f"17(b) 20 /predict requests of {n} sentence(s), 640x480"
                      f" progressive JPEG, R50 416 px bf16 folded: median "
                      f"{latency[n]['median_ms']:.2f} ms, p90 "
                      f"{latency[n]['p90_ms']:.2f} ms (host clock, client to "
                      f"reply); card {card}", flush=True)
            launches, by_route = k1.launches, dict(k1.launches_by_route)
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        # 3 + 40 requests: buckets 4, 1, 2, then 20 x 1 and 20 x 4
        assert batches == [4, 1, 2] + [1] * 20 + [4] * 20, batches
        want = 7 * len(batches)  # 3 decoder layers x 2 sites + attnpool
        assert launches == want, (launches, want)
        assert by_route == {"tensor_cores": want, "scalar": 0}, by_route
        print(f"17(b) K1 on the front: {launches} launches in "
              f"{len(batches)} device batches ({launches / len(batches):.0f} "
              f"a batch), by route {by_route}", flush=True)

        # every mask equals PredictService.predict on the decoded pixels
        service.evaluator.predict_probs = inner
        with open(path, "rb") as f:
            on_disk = f.read()
        for name, req in requests:
            buf = (base64.b64decode(req["image_b64"]) if "image_b64" in req
                   else on_disk)
            sents = req.get("sentences") or [req["sentence"]]
            direct = service.predict(codec.decode_image(buf), sents)
            reply = replies[name]
            assert [r["sentence"] for r in reply["results"]] == sents
            for got, ref in zip(reply["results"], direct):
                if req["format"] == "rle":
                    mask = _rle_mask(got["rle"])
                else:
                    png = codec.decode_mask(base64.b64decode(
                        got["mask_png_b64"]))
                    assert set(np.unique(png)) <= {0, 255}
                    mask = png == 255
                assert mask.shape == (reply["height"], reply["width"])
                assert np.array_equal(mask, ref["mask"]), name
                assert got["foreground_px"] == ref["foreground_px"]
        print("17(b) every mask of the front equals PredictService.predict "
              f"on the decoded image; the service built and warmed in "
              f"{build_s:.1f} s", flush=True)
        # the same requests' predict alone, on this thread and on a fresh
        # thread a call as the front's handlers run it, to split a
        # request's time between the front (transfer, JSON, base64,
        # decode, RLE) and the service
        image = codec.decode_image(prog)
        for n in (1, 4):
            sents = [f"the person number {i}" for i in range(n)]
            for key, call in (
                    ("predict", lambda: service.predict(image, sents)),
                    ("predict_fresh_thread", lambda: _on_fresh_thread(
                        service.predict, image, sents))):
                times = _times_ms(call, 20)
                latency[n][f"{key}_median_ms"] = _pct(times, 50)
                latency[n][f"{key}_p90_ms"] = _pct(times, 90)
            print(f"17(b) PredictService.predict alone, {n} sentence(s), 20 "
                  f"calls: median {latency[n]['predict_median_ms']:.2f} ms "
                  f"(p90 {latency[n]['predict_p90_ms']:.2f}) on this thread, "
                  f"{latency[n]['predict_fresh_thread_median_ms']:.2f} ms "
                  f"(p90 {latency[n]['predict_fresh_thread_p90_ms']:.2f}) "
                  f"from a fresh thread a call; the front adds "
                  f"{latency[n]['median_ms'] - latency[n]['predict_median_ms']:.2f}"
                  f" ms at the median; card {card}", flush=True)
        # why the service keeps one device thread: a b1 device batch on
        # this thread against one on a fresh thread a call
        word = np.ones((1, cfg.word_len), np.int64)
        zeros = np.zeros((1, 3, 416, 416), np.float32)
        batch = {key: _times_ms(call, 10) for key, call in (
            ("this_thread", lambda: inner(zeros, word)),
            ("fresh_thread", lambda: _on_fresh_thread(inner, zeros, word)))}
        batch = {k: {"median_ms": _pct(v, 50), "p90_ms": _pct(v, 90)}
                 for k, v in batch.items()}
        print(f"17(b) Evaluator.predict_probs at b1, 10 calls: median "
              f"{batch['this_thread']['median_ms']:.2f} ms on one thread, "
              f"{batch['fresh_thread']['median_ms']:.2f} ms on a fresh "
              f"thread a call; card {card}", flush=True)
        del service
        torch.cuda.empty_cache()

        # (c) the predict entry, on the card
        image = os.path.abspath(os.path.join(FIXTURES,
                                             "progressive_420_640x480.jpg"))
        out = os.path.join(tmp, "out")
        os.makedirs(out)
        cmd = [sys.executable, "-m", "cris_tpu_torch.predict", "--config",
               os.path.join("config", "refcoco", "cris_r50.yaml"), "--image",
               image, "--sent", "the man on the left", "--sent", "a red car",
               "--out", os.path.join(out, "mask.png"), "--overlay",
               os.path.join(out, "overlay.jpg"), "--checkpoint", ckpt]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        predict_s = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stderr[-4000:]
        bgr = codec.decode_image(data["progressive_420_640x480.jpg"])
        assert sorted(os.listdir(out)) == ["mask_0.png", "mask_1.png",
                                           "overlay_0.jpg", "overlay_1.jpg"]
        foreground = []
        for i in range(2):
            with open(os.path.join(out, f"mask_{i}.png"), "rb") as f:
                mask = codec.decode_mask(f.read())
            assert mask.shape == bgr.shape[:2]
            assert set(np.unique(mask)) <= {0, 255}
            foreground.append(int((mask > 0).sum()))
            with open(os.path.join(out, f"overlay_{i}.jpg"), "rb") as f:
                written = f.read()
            assert written == codec.encode_jpeg(overlay(bgr, mask), 95)
        print(f"17(c) python3 -m cris_tpu_torch.predict at R50 on the card: "
              f"2 masks of {bgr.shape[:2]} ({foreground} px foreground) and "
              f"2 overlays (each the JPEG of the blend of its mask) in "
              f"{predict_s:.1f} s with the process start", flush=True)
    return {"K1": launches, "K1_by_route": by_route,
            "device_batches": len(batches), "latency": latency,
            "b1_batch_by_thread": batch,
            "decode": decode, "service_build_s": build_s,
            "predict_entry_s": predict_s, "card": card}


# phase 18: int8 serving. K8's bound: the card's dense int8 tensor-core
# rate (NVIDIA's data sheet, H100 SXM), and HBM_BYTES_PER_S
INT8_OPS_PER_S = 1979e12
# (c)'s free-running bars, set from the flip rates measured on the card
# (PERF.md §6: 6.3e-2 of the levels and 0.13 rel L2 at seed 0, from
# f32 rounding at the first flip cascading through 78 int8 sites), about
# twice the measurement: the share of int8 levels that differ between
# the card's f32 forward and the CPU's, and the logits' relative L2. The
# teacher-forced replay is exact; the teacher-forced segments are held
# at f32 rounding.
INT8_FLIP_BAR = 0.15
INT8_LOGIT_BAR = 0.3
# (c)'s teacher-forced segments: the relative L2 between the card's and
# the CPU's input to each K8 call when every call returns the CPU's
# output (f32 rounding of one stretch of code between two sites)
INT8_SEGMENT_BAR = 1e-5
# and the teacher-forced logits (after the last site: the text-made
# dynamic conv, whose sums cancel) at phase 2's f32 logits bar
INT8_SEGMENT_LOGIT_BAR = 1e-4
# (c)'s planted faults on the card: one site's scale off by 5%, caught by
# the replay; one fold's top output row off by 1e-3, caught by the
# segment bar at the next site
INT8_FAULT_SITE = "backbone.visual.layer3.0.conv2"
INT8_FAULT_SCALE = 1.05
INT8_BORDER_FAULT = 1.001
PHASE_SITES = ("f2_cat.0", "aggr.0", "vis.1.0", "vis.3.0")


@contextlib.contextmanager
def _k8_calls(quant_mod, around, around_quantize=None):
    """ops.quant's K8 wrappers (the ones every int8 site calls) patched so
    that each GEMM is ``around(real, x, wq, k_scale, act_scale, bias,
    stride, padding, relu, out_dtype, out)`` and, when given, each
    quantise pass ``around_quantize(real, x, act_scale)``."""
    real, real_quantize = quant_mod.int8_conv, quant_mod.int8_quantize

    def patched(x, wq, k_scale, act_scale, bias=None, stride=1,
                padding=((0, 0), (0, 0)), relu=False, out_dtype=None,
                out=None):
        return around(real, x, wq, k_scale, act_scale, bias, stride,
                      padding, relu, out_dtype, out)

    def patched_quantize(x, act_scale):
        return around_quantize(real_quantize, x, act_scale)

    quant_mod.int8_conv = patched
    if around_quantize is not None:
        quant_mod.int8_quantize = patched_quantize
    try:
        yield
    finally:
        quant_mod.int8_conv = real
        quant_mod.int8_quantize = real_quantize


def _quantize_signature(x):
    return (tuple(x.shape), str(x.dtype).replace("torch.", ""),
            "nhwc" if x.stride(3) == 1 else "nchw")


def _site_signature(qsig, wq, stride, padding, relu, bias, out_dtype, out):
    """A GEMM call's shape: its input's quantise signature, the packed
    kernel's (kh, kw, C, Co) and the call's other arguments."""
    return (qsig, (wq.kh, wq.kw, wq.c, wq.co), stride,
            tuple(map(tuple, padding)), bool(relu), bias is not None,
            str(out_dtype).replace("torch.", ""), out is not None)


def _int8_site_row(sig, n, quantize_rows):
    """K8 at one GEMM site shape: the quantise pass and the GEMM each
    against its plain version (bit-equal), a flipped bit of the packed
    weights and a quantise pass at the scale x 1.0001 caught, the plan,
    and CUDA-event times of the quantise pass (once per input signature,
    kept in ``quantize_rows``), the GEMM, the plain versions, cuDNN's
    bf16 conv and, at the 1x1 sites, torch._int_mm on the GEMM's own
    int8 operands."""
    k8 = importlib.import_module("cris_tpu_torch.ops.kernels.int8_conv")

    qsig, (kh, kw, c, co), stride, pads, relu, has_bias, odt, strided = sig
    shape, dtype, layout = qsig
    b, h, w, _ = shape
    seed = int(hashlib.sha256(repr(sig).encode()).hexdigest()[:8], 16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt, out_dt = getattr(torch, dtype), getattr(torch, odt)
    x = torch.randn(b, c, h, w, device="cuda", generator=gen).to(dt)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    xn = x.permute(0, 2, 3, 1)
    wq = torch.randint(-127, 128, (kh, kw, c, co), device="cuda",
                       generator=gen, dtype=torch.int8)
    ks = torch.rand(co, device="cuda", generator=gen) * 1e-2 + 1e-3
    bias = (torch.randn(co, device="cuda", generator=gen) if has_bias
            else None)
    s = torch.tensor([0.05], device="cuda")
    (pt, pb), (pl, pr) = pads
    ho, wo = (h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1
    out = (torch.empty(b, 2 * ho, 2 * wo, co, device="cuda", dtype=out_dt)
           [:, 1::2, ::2] if strided else None)
    args = (ks, s, bias, stride, pads, relu, out_dt)
    plan = k8.int8_plan(xn.shape, wq.shape, stride, pads,
                        k8._sms(xn.device))
    xq, packed = k8.int8_quantize(xn, s), k8.pack_int8_weights(wq)

    def gemm(a=xq, p=packed):
        return k8.int8_conv(a, p, *args, out=out)
    got = gemm().clone()
    ref = k8.int8_conv_plain(xn, wq, *args)
    qref = k8.int8_quantize_plain(xn, s)
    torch.cuda.synchronize()
    q_equal, equal = torch.equal(xq.q, qref.q), torch.equal(got, ref)
    err = (got.float() - ref.float()).abs().max().item()
    q_err = (xq.q.int() - qref.q.int()).abs().max().item()
    bad = packed.w.clone()
    bad.view(-1)[:1] ^= 1
    weight_caught = not torch.equal(
        gemm(p=k8.PackedInt8(bad, kh, kw, c)), ref)
    moved = k8.int8_quantize(xn, s * 1.0001)
    levels_moved = int((moved.q != xq.q).sum())
    level_caught = levels_moved > 0 and not torch.equal(gemm(a=moved), ref)
    assert q_equal and equal, (sig, q_err, err)
    assert weight_caught and level_caught, (sig, levels_moved)
    m, k = b * ho * wo, kh * kw * c
    out_bytes = m * co * torch.empty((), dtype=out_dt).element_size()
    x_bytes = x.numel() * x.element_size()
    ops = 2.0 * m * k * co / INT8_OPS_PER_S
    # the pair: the float input in, the kernel, the factors, the output
    pair_mem = (x_bytes + wq.numel() + 4 * co * 2 + out_bytes) / HBM_BYTES_PER_S
    # the GEMM alone, on its own operands
    gemm_mem = (xq.q.numel() + packed.w.numel() + 4 * co * 2
                + out_bytes) / HBM_BYTES_PER_S
    if qsig not in quantize_rows:
        q_mem = (x_bytes + xq.q.numel()) / HBM_BYTES_PER_S
        quantize_rows[qsig] = {
            "device_ms": device_ms(lambda: k8.int8_quantize(xn, s)),
            "plain_ms": cuda_ms(lambda: k8.int8_quantize_plain(xn, s),
                                iters=5),
            "bound_ms": q_mem * 1e3, "bound_by": "bytes",
            "max_abs_err": q_err, "cp": xq.q.shape[3]}
    qrow = quantize_rows[qsig]
    xp = torch.nn.functional.pad(x, (pl, pr, pt, pb))
    wb = wq.permute(3, 2, 0, 1).to(torch.bfloat16)
    bb = None if bias is None else bias.to(torch.bfloat16)
    row = {
        "site": f"{b}x{h}x{w}x{c} -> {co}, k{kh}x{kw} s{stride} pads {pads}"
                f" {dtype} {layout}" + (" relu" if relu else "")
                + (" strided out" if strided else ""),
        "quantize_input": list(map(str, qsig)),
        "per_forward": n, "equal": equal, "quantize_equal": q_equal,
        "max_abs_err": err, "planted_weight_bit_caught": weight_caught,
        "planted_level_caught": level_caught, "levels_moved": levels_moved,
        "plan": {key: plan[key] for key in ("cp", "bm", "stages", "loader",
                                            "split", "grid", "units")},
        "quantize_device_ms": qrow["device_ms"],
        "gemm_device_ms": device_ms(gemm),
        "ms": cuda_ms(lambda: k8.int8_conv(xn, packed, *args, out=out)),
        "plain_ms": cuda_ms(lambda: k8.int8_conv_plain(xn, wq, *args),
                            iters=2),
        "gemm_plain_ms": cuda_ms(lambda: k8.int8_conv_packed_plain(
            xq, packed, *args), iters=2),
        "cudnn_bf16_ms": device_ms(lambda: torch.nn.functional.conv2d(
            xp.to(torch.bfloat16), wb, bb, stride)),
        "bound_ms": max(pair_mem, ops) * 1e3,
        "bound_by": "bytes" if pair_mem >= ops else "operations",
        "gemm_bound_ms": max(gemm_mem, ops) * 1e3,
        "gemm_bound_by": "bytes" if gemm_mem >= ops else "operations",
        "quantize_bound_ms": qrow["bound_ms"],
        "int_mm_ms": None}
    row["device_ms"] = row["quantize_device_ms"] + row["gemm_device_ms"]
    # the plan against the other tile height and splits: the model's
    # (cost_us) and the card's times, each output bit-equal
    row["model_us"], alternatives = plan["cost_us"], {}
    for bm in k8.TILE_ROWS:
        best = k8.int8_plan(xn.shape, wq.shape, stride, pads,
                            k8._sms(xn.device), bm=bm)["split"]
        for split in sorted({1, 2, 4, 8, best, plan["split"]}):
            if (bm, split) == (plan["bm"], plan["split"]) or \
                    split > plan["kblocks"]:
                continue
            forced = k8.int8_plan(xn.shape, wq.shape, stride, pads,
                                  k8._sms(xn.device), split=split, bm=bm)
            real_plan = k8._plan
            k8._plan = lambda *a, _p=forced: _p
            try:
                alt_equal = torch.equal(gemm().clone(), ref)
                alternatives[f"bm {bm} split {split}"] = {
                    "bm": bm, "split": split,
                    "gemm_device_ms": device_ms(gemm), "equal": alt_equal,
                    "model_us": forced["cost_us"]}
            finally:
                k8._plan = real_plan
            assert alt_equal, (sig, bm, split)
    row["alternatives"] = alternatives
    # split-K against no split: the fastest timed plan of each kind
    timed = [(plan["split"], row["gemm_device_ms"])] + [
        (v["split"], v["gemm_device_ms"]) for v in alternatives.values()]
    row["no_split_ms"] = min(t for sp, t in timed if sp == 1)
    row["split_ms"] = min((t for sp, t in timed if sp > 1), default=None)
    row["best_timed_ms"] = min(t for _, t in timed)
    if kh == kw == 1 and stride == 1 and pads == ((0, 0), (0, 0)):
        a = xq.q.reshape(m, -1)
        bm = packed.w.t()  # (Cp, Co), column-major
        try:
            acc = torch._int_mm(a, bm)
            assert torch.equal(acc.double(), a.double() @ bm.double())
            row["int_mm_ms"] = device_ms(lambda: torch._int_mm(a, bm))
        except RuntimeError as e:  # the library refuses the shape
            row["int_mm_error"] = str(e)[:120]
    pl_ = row["plan"]
    others = "; ".join(f"{k} {v['gemm_device_ms']:.4f} (model "
                       f"{v['model_us']:.1f} us)"
                       for k, v in alternatives.items())
    print(f"18(a) K8 {row['site']} x{n} a forward: plan Cp {pl_['cp']} "
          f"bm {pl_['bm']} {pl_['stages']} stages {pl_['loader']} split "
          f"{pl_['split']} grid {pl_['grid']} (model {row['model_us']:.1f} "
          f"us; other plans, GEMM ms, all bit-equal: {others}); quantise "
          f"and GEMM equal {q_equal} {equal}, "
          f"faults caught {weight_caught} {level_caught} ({levels_moved} "
          f"levels moved); on the device quantise "
          f"{row['quantize_device_ms']:.4f} + GEMM "
          f"{row['gemm_device_ms']:.4f} = {row['device_ms']:.4f} ms "
          f"({row['ms']:.4f} back to back), plain {row['plain_ms']:.2f} "
          f"(GEMM {row['gemm_plain_ms']:.2f}), cuDNN bf16 "
          f"{row['cudnn_bf16_ms']:.4f}, _int_mm {row['int_mm_ms']}, bounds "
          f"quantise {row['quantize_bound_ms']:.4f}, GEMM "
          f"{row['gemm_bound_ms']:.4f} ({row['gemm_bound_by']}), pair "
          f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    return row


def _split_report(b, rows):
    """One device batch's GEMMs summed over its forward, beside the
    fastest timed plan at each shape, and split-K against no split (each
    the fastest timed plan of its kind) where int8_plan splits and where
    a timed split beat its unsplit plan; printed and returned."""
    def total(rs, key):
        return sum(r[key] * r["per_forward"] for r in rs)
    split = [r for r in rows if r["plan"]["split"] > 1]
    missed = [r for r in rows if r["plan"]["split"] == 1
              and r["split_ms"] is not None
              and r["split_ms"] < r["no_split_ms"]]
    rep = {"batch": b, "shapes": len(rows),
           "gemms": sum(r["per_forward"] for r in rows),
           "gemm_device_ms": total(rows, "gemm_device_ms"),
           "best_timed_ms": total(rows, "best_timed_ms"),
           "split_shapes": len(split),
           "split_gemms": sum(r["per_forward"] for r in split),
           "split_ms": total(split, "split_ms"),
           "no_split_ms": total(split, "no_split_ms"),
           "split_faster": sum(r["split_ms"] < r["no_split_ms"]
                               for r in split),
           "missed_shapes": len(missed),
           "missed_split_ms": total(missed, "split_ms"),
           "missed_no_split_ms": total(missed, "no_split_ms")}
    print(f"18(a) K8 at B {b}: {rep['shapes']} GEMM site shapes, "
          f"{rep['gemms']} GEMMs a forward, every plan bit-equal to the "
          f"plain version; GEMMs {rep['gemm_device_ms']:.4f} ms a forward "
          f"on the device (the fastest timed plan at each shape: "
          f"{rep['best_timed_ms']:.4f}); int8_plan splits K at "
          f"{rep['split_shapes']} shapes ({rep['split_gemms']} GEMMs a "
          f"forward): split {rep['split_ms']:.4f} ms against no split "
          f"{rep['no_split_ms']:.4f}, faster at {rep['split_faster']} of "
          f"{rep['split_shapes']}; unsplit plans where a timed split was "
          f"faster: {rep['missed_shapes']} ({rep['missed_split_ms']:.4f} "
          f"against {rep['missed_no_split_ms']:.4f} ms)", flush=True)
    return rep


def _rewrite_parts(bench, cfg, b=16):
    """Each bf16 graph rewrite against the reference order at the R50
    shapes of a b16 forward, under bf16 autocast on the folded seed-0
    model: the outputs held together at the kernels' bf16 bars
    (``_check``), and CUDA-event ms back to back (host launches
    included: several parts enqueue more slowly than the card runs
    them). The stem (s2d against the three convs and the pool; its s2d
    output taken back to the pooled map), layer2_0 (fused pools against
    the standalone ones) and the four upsample folds against upsample2x
    + the conv."""
    from cris_tpu_torch.ops.s2d import depth_to_space

    model = bench.eval_model(cfg, torch.device("cuda"),
                             bench.folded_state(cfg), rewrites=True)
    vis, neck, proj = model.backbone.visual, model.neck, model.proj
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(b, *shape, device="cuda", generator=gen)

    def pooled_stem(out):
        y, entry = out
        if entry == "s2d":  # (B, 4C, H/2, W/2) -> the pooled (B, C, ...)
            y = depth_to_space(y.float().permute(0, 2, 3, 1))
            y = torch.nn.functional.avg_pool2d(y.permute(0, 3, 1, 2), 2)
        return y

    img, x104 = randn(3, 416, 416), randn(256, 104, 104)
    x26, x52 = randn(512, 26, 26), randn(512, 52, 52)
    f5, f4, fq = randn(1024, 13, 13), randn(512, 26, 26), randn(512, 13, 13)
    parts = {
        "stem": (lambda: vis.stem(img), vis, "rewrites", pooled_stem),
        "layer2_0": (lambda: vis.layer2[0](x104), vis.layer2[0],
                     "fuse_pool", None),
        "proj vis_conv1 26->52": (lambda: proj.vis[1](x26), proj.vis[1],
                                  "fuse", None),
        "proj vis_conv2 52->104": (lambda: proj.vis[3](x52), proj.vis[3],
                                   "fuse", None),
        "neck f2_cat 13->26": (lambda: neck.f2_cat([f4], f5), neck.f2_cat,
                               "fuse", None),
        "neck aggr 13->26": (lambda: neck.aggr([f4, f4], fq), neck.aggr,
                             "fuse", None),
    }
    rows, pairs = [], []
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        for name, (fn, mod, flag, view) in parts.items():
            outs = {}
            for form in ("off", "on"):
                setattr(mod, flag, form == "on")
                out = fn()
                outs[form] = (view(out) if view else out).float()
                rows.append({"part": name, "form": form,
                             "ms": cuda_ms(fn, iters=10)})
            setattr(mod, flag, True)
            got, ref = outs["on"], outs["off"]
            pairs.append((name, got, ref))
            rms = ref.square().mean().sqrt().item()
            rows[-1].update(rel_l2=_rel(got, ref),
                            max_abs_err=(got - ref).abs().max().item(),
                            mean_abs_err=(got - ref).abs().mean().item(),
                            ref_rms=rms)
    for r in rows:
        extra = ("" if r["form"] == "off" else
                 f"; against off: rel L2 {r['rel_l2']:.3e}, max |err| "
                 f"{r['max_abs_err']:.3e}, mean {r['mean_abs_err']:.3e} "
                 f"(RMS {r['ref_rms']:.3e})")
        print(f"18(d) rewrite part {r['part']}, {r['form']}: "
              f"{r['ms']:.4f} ms back to back (b{b} bf16){extra}", flush=True)
    for name, got, ref in pairs:
        _check(got, ref, torch.bfloat16, f"18(d) rewrite {name}")
    del model, pairs
    torch.cuda.empty_cache()
    return rows


def phase_int8(k1, k8, k8q):
    """18: int8 serving. (b) python3 -m cris_tpu_torch.quantize over
    synthetic:// at R50 seed-0 weights, then PredictService at precision
    int8 answering 3 requests (K8 at every engaged site a device batch,
    K1 7, never the plain version), its masks against the bf16
    service's; (a) K8 against its plain version at every int8 site shape
    of its B 16, B 8 and B 1 device batches, each plan against the
    others; (c) the R50 int8 forward at f32 on the card
    against the CPU's plain int8 forward on the same scales, free-running
    and teacher-forced, with planted faults; (d) the bench's int8 pair,
    its bf16 eval metric, the rewrites' A/B at short lengths and each
    rewrite against its reference order."""
    from cris_tpu_torch import bench, quantize
    from cris_tpu_torch.checkpoint import (attach_act_scales,
                                           fold_batchnorm, load_act_scales,
                                           load_cris_checkpoint)
    from cris_tpu_torch.models import build_segmenter, int8_sites
    from cris_tpu_torch.ops import quant as quant_mod
    from cris_tpu_torch.ops import upsample_conv
    from cris_tpu_torch.serving import PredictService
    from cris_tpu_torch.utils import cris_r50_refcoco, tokenize

    k8mod = importlib.import_module("cris_tpu_torch.ops.kernels.int8_conv")
    plains = {name: getattr(k8mod, name) for name in (
        "int8_conv_plain", "int8_conv_packed_plain", "int8_quantize_plain")}
    plain_calls = []

    def counted(fn):
        def call(*args, **kwargs):
            plain_calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return call

    for name, fn in plains.items():
        setattr(k8mod, name, counted(fn))
    out, t_phase = {}, time.perf_counter()
    cfg = cris_r50_refcoco()
    cfg8 = copy.deepcopy(cfg)
    cfg8.precision = "int8"
    tmp = tempfile.mkdtemp()
    try:
        out_dir = os.path.join(tmp, cfg.exp_name)
        os.makedirs(out_dir)
        weights = os.path.join(out_dir, "best_model.pth")
        torch.save({"state_dict": build_segmenter(cfg, device="cpu",
                                                  seed=0).state_dict()},
                   weights)
        t0 = time.perf_counter()
        path = quantize.main([
            "--config", os.path.join("config", "refcoco", "cris_r50.yaml"),
            "--batches", "2", "--batch-size", "16", "--opts",
            "TRAIN.output_folder", tmp, "DATA.val_lmdb",
            "synthetic://32?seed=0", "DATA.mask_root", ""])
        _close_log()
        quantize_s = time.perf_counter() - t0
        scales, gates = load_act_scales(path)
        per_batch = sum(4 if n.endswith(PHASE_SITES) else 1 for n in scales)
        print(f"18(b) python3 -m cris_tpu_torch.quantize (synthetic://32, "
              f"R50 seed 0, 2 x 16, bf16) wrote {len(scales)} scales, gates "
              f"{gates}, in {quantize_s:.1f} s; {per_batch} K8 launches a "
              f"device batch expected", flush=True)
        svc8 = PredictService(cfg8, device="cuda", max_batch=16,
                              model_dir=out_dir)
        assert svc8.act_scales == len(scales), (svc8.act_scales, len(scales))
        engaged = {n for n, m in int8_sites(svc8.model).items()
                   if m.act_scale is not None}
        assert engaged == set(scales), engaged ^ set(scales)
        rng = np.random.RandomState(0)
        words = ["the", "man", "left", "red", "shirt", "dog", "on", "a"]
        requests = []
        for (h, w), n in [((480, 640), 1), ((427, 640), 5), ((640, 480), 16)]:
            requests.append((rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                             [" ".join(rng.choice(words, 1 + i % 6))
                              for i in range(n)]))
        sigs, qsigs, latency, masks8 = {}, {}, [], []
        last_q = []
        reset_counts(k1, k8, k8q)
        del plain_calls[:]

        # each device batch's shapes, by its size (1, 8 and 16: the
        # requests of 1, 5 and 16 sentences)
        def record_quantize(real, x, s):
            qsig = _quantize_signature(x)
            by_b = qsigs.setdefault(x.shape[0], {})
            by_b[qsig] = by_b.get(qsig, 0) + 1
            last_q[:] = [qsig]
            return real(x, s)

        def record(real, x, wq, k_scale, s, bias, stride, padding, relu,
                   out_dtype, o):
            # x: the site's quantised input
            sig = _site_signature(last_q[0], wq, stride, padding, relu,
                                  bias, out_dtype, o)
            by_b = sigs.setdefault(x.q.shape[0], {})
            by_b[sig] = by_b.get(sig, 0) + 1
            return real(x, wq, k_scale, s, bias, stride, padding, relu,
                        out_dtype, o)

        with _k8_calls(quant_mod, record, record_quantize):
            for image, sents in requests:
                t0 = time.perf_counter()
                res = svc8.predict(image, sents)
                latency.append((time.perf_counter() - t0) * 1e3)
                masks8.append([r["mask"] for r in res])
        launches = {"K8": k8.launches, "int8_quantize": k8q.launches,
                    "K1": k1.launches}
        k1_routes = dict(k1.launches_by_route)
        assert launches == {"K8": 3 * per_batch,
                            "int8_quantize": 3 * len(scales),
                            "K1": 21}, launches
        assert k1_routes["tensor_cores"] == 21, k1_routes
        assert not plain_calls, f"plain versions on the card path: " \
            f"{sorted(set(plain_calls))}"
        assert sorted(sigs) == sorted(qsigs) == [1, 8, 16], sorted(sigs)
        for b, by_b in sigs.items():
            assert sum(by_b.values()) == per_batch, (b, by_b)
            assert sum(qsigs[b].values()) == len(scales), (b, qsigs[b])
        svc16 = PredictService(cfg, device="cuda", max_batch=16,
                               model_dir=out_dir)
        ious = []
        for (image, sents), m8 in zip(requests, masks8):
            for a, r in zip(m8, svc16.predict(image, sents)):
                union = (a | r["mask"]).sum()
                ious.append(float((a & r["mask"]).sum() / union)
                            if union else 1.0)
        print(f"18(b) PredictService precision int8 ({len(scales)} sites "
              f"with scales): requests of 1, 5, 16 sentences in "
              f"{', '.join(f'{v:.2f}' for v in latency)} ms; K8 "
              f"{launches['K8']} GEMM launches (3 device batches x "
              f"{per_batch}) and {launches['int8_quantize']} quantise passes "
              f"(3 x {len(scales)}), K1 {launches['K1']} by route "
              f"{k1_routes}, no plain call; "
              f"masks against the bf16 service's: IoU mean "
              f"{np.mean(ious):.4f}, min {min(ious):.4f} over {len(ious)}",
              flush=True)
        out["serving"] = {"latency_ms": latency, "K8": launches["K8"],
                          "int8_quantize": launches["int8_quantize"],
                          "K1": launches["K1"], "K8_per_batch": per_batch,
                          "int8_quantize_per_batch": len(scales),
                          "sites": len(scales), "gates": gates,
                          "iou_vs_bf16_mean": float(np.mean(ious)),
                          "iou_vs_bf16_min": min(ious),
                          "quantize_s": quantize_s}
        del svc16

        # (a) every site shape of the three device batches: B 16's, then
        # B 8's and B 1's (the requests of 5 and 1 sentences), where
        # int8_plan may split K
        quantize_rows, by_batch, out["split_k"] = {}, {}, []
        for b in (16, 8, 1):
            by_batch[b] = [_int8_site_row(sig, n, quantize_rows)
                           for sig, n in sigs[b].items()]
            out["split_k"].append(_split_report(b, by_batch[b]))
        rows, q16 = by_batch[16], qsigs[16]
        fwd = {key: sum(r[key] * r["per_forward"] for r in rows)
               for key in ("gemm_device_ms", "ms", "plain_ms",
                           "cudnn_bf16_ms", "bound_ms", "gemm_bound_ms")}
        fwd["quantize_device_ms"] = sum(
            quantize_rows[q]["device_ms"] * n for q, n in q16.items())
        fwd["quantize_bound_ms"] = sum(
            quantize_rows[q]["bound_ms"] * n for q, n in q16.items())
        fwd["device_ms"] = fwd["gemm_device_ms"] + fwd["quantize_device_ms"]
        ones = [r for r in rows if r["int_mm_ms"] is not None]
        fwd["one_by_one_gemm_device_ms"] = sum(
            r["gemm_device_ms"] * r["per_forward"] for r in ones)
        fwd["one_by_one_int_mm_ms"] = sum(
            r["int_mm_ms"] * r["per_forward"] for r in ones)
        fwd["gemm_launches"] = sum(r["per_forward"] for r in rows)
        fwd["quantize_launches"] = sum(q16.values())
        print(f"18(a) K8 at {len(rows)} GEMM site shapes ({len(q16)} "
              f"quantise shapes), {per_batch} GEMMs and {len(scales)} "
              f"quantise passes a B 16 forward, all bit-equal to the plain "
              f"versions, every planted fault caught; summed over the "
              f"forward on the device: GEMM {fwd['gemm_device_ms']:.3f} + "
              f"quantise {fwd['quantize_device_ms']:.3f} = "
              f"{fwd['device_ms']:.3f} ms (back to back {fwd['ms']:.3f}), "
              f"plain {fwd['plain_ms']:.1f}, cuDNN bf16 "
              f"{fwd['cudnn_bf16_ms']:.3f}, bound {fwd['bound_ms']:.3f} "
              f"(GEMM {fwd['gemm_bound_ms']:.3f}, quantise "
              f"{fwd['quantize_bound_ms']:.3f}); the 1x1 sites' GEMMs "
              f"{fwd['one_by_one_gemm_device_ms']:.3f} against _int_mm's "
              f"{fwd['one_by_one_int_mm_ms']:.3f}", flush=True)
        out["sites"], out["forward"] = rows, fwd
        out["sites_b8"], out["sites_b1"] = by_batch[8], by_batch[1]
        out["quantize_sites"] = [{"input": list(map(str, q)), "per_forward":
                                  qsigs[q[0][0]][q], **r}
                                 for q, r in quantize_rows.items()]
        del svc8
        torch.cuda.empty_cache()

        # (c) f32 on the card against the CPU's plain int8 forward
        sd = fold_batchnorm(load_cris_checkpoint(weights), cfg.input_size)
        gen = torch.Generator().manual_seed(2)
        img = torch.randn(1, 3, cfg.input_size, cfg.input_size, generator=gen)
        word = torch.from_numpy(tokenize(["the man in the red shirt"],
                                         cfg.word_len, True)).long()

        def int8_model(device, scale_fault=1.0):
            model = build_segmenter(cfg8, device="meta", fold_bn=True,
                                    pos_grid=cfg.input_size // 32)
            model.load_state_dict(sd, assign=True)
            model = model.to(device)
            attach_act_scales(model, path)
            if scale_fault != 1.0:
                site = int8_sites(model)[INT8_FAULT_SITE]
                site.act_scale = site.act_scale * scale_fault
            return model

        def forward(model, device, around=None):
            """Logits, and every K8 call in order: ["q", input, scale,
            levels] for a quantise pass (the levels of the real channels)
            and ["g", other arguments, output] for a GEMM (copies on the
            CPU: the model writes some in place afterwards)."""
            calls = []

            def keep_quantize(real, x, s):
                xq = real(x, s)
                calls.append(["q", x.to("cpu", copy=True), s,
                              xq.q[..., :xq.c].to("cpu", copy=True)])
                return xq

            def keep(real, x, *args):
                y = real(x, *args)
                calls.append(["g", args, y.to("cpu", copy=True)])
                return y
            gemm, quantise = around or (keep, keep_quantize)
            with torch.no_grad(), _k8_calls(quant_mod, gemm, quantise):
                t0 = time.perf_counter()
                logits = model(img.to(device), word.to(device)).cpu()
                seconds = time.perf_counter() - t0
            return logits, calls, seconds

        def forced(model, calls):
            """Teacher forcing on the card against the CPU forward's
            ``calls``: each quantise pass i on the CPU's input to it, and
            each GEMM on the CPU's levels, must give the CPU's result bit
            for bit; then each call returns the CPU's result, so that the
            card's code between two sites (the stem, the pools, the folds'
            borders, the attention, the casts) runs on the CPU's values,
            and the input the card hands the next quantise pass is held to
            the CPU's at f32 rounding. Returns the calls whose result
            differs, each quantise pass's input relative L2, and the
            logits'."""
            differ, seg, it = [], [], iter(enumerate(calls))

            def around_quantize(real, x, s):
                i, (kind, xc, _, qc) = next(it)
                assert kind == "q", (i, kind)
                seg.append(_rel(x, xc.to(x.device)))
                xr = xc.cuda()
                if xc.stride(3) == 1:  # channels-last, as the model hands it
                    xr = xr.permute(0, 3, 1, 2).contiguous(
                        memory_format=torch.channels_last).permute(0, 2, 3, 1)
                got_q = real(xr, s)
                if not torch.equal(got_q.q[..., :got_q.c].cpu(), qc):
                    differ.append(i)
                q = torch.zeros_like(got_q.q)
                q[..., :got_q.c] = qc.to(x.device)
                return k8mod.Int8Act(q, got_q.c)

            def around(real, x, wq, ks, s, bias, stride, pads, relu, odt, o):
                i, (kind, _, yc) = next(it)
                assert kind == "g", (i, kind)
                # x holds the CPU's levels (around_quantize returned them)
                if not torch.equal(real(x, wq, ks, s, bias, stride, pads,
                                        relu, odt).cpu(), yc):
                    differ.append(i)
                if o is not None:
                    return o.copy_(yc)
                return torch.empty(yc.shape, dtype=yc.dtype,
                                   device=x.q.device).copy_(yc)
            logits, _, _ = forward(model, "cuda", (around, around_quantize))
            assert next(it, None) is None, "the card made fewer K8 calls"
            return differ, seg, _rel(logits, ref)

        @contextlib.contextmanager
        def border_fault():
            """The first 3x3 fold's (the projector's vis_conv1) top output
            row off by INT8_BORDER_FAULT on the card, once."""
            real = upsample_conv.apply_border_correction3x3
            hits = []

            def faulty(y, x, kernel):
                y = real(y, x, kernel)
                if not hits:
                    y[:, 0] *= INT8_BORDER_FAULT
                hits.append(1)
                return y
            upsample_conv.apply_border_correction3x3 = faulty
            try:
                yield hits
            finally:
                upsample_conv.apply_border_correction3x3 = real

        del plain_calls[:]
        card = int8_model("cuda")
        got, lv_card, _ = forward(card, "cuda")
        assert not plain_calls
        ref, lv_cpu, cpu_s = forward(int8_model("cpu"), "cpu")
        assert [c[0] for c in lv_card] == [c[0] for c in lv_cpu]
        q_card = [c for c in lv_card if c[0] == "q"]
        q_cpu = [c for c in lv_cpu if c[0] == "q"]
        n_gemm = len(lv_cpu) - len(q_cpu)
        shares = [float((a[3] != b[3]).float().mean())
                  for a, b in zip(q_card, q_cpu)]
        total = sum(v[3].numel() for v in q_cpu)
        flip = sum(s * v[3].numel() for s, v in zip(shares, q_cpu)) / total
        rel = _rel(got, ref)
        agree = ((got > 0) == (ref > 0)).float().mean().item()
        first = next((i for i, s in enumerate(shares) if s > 0), None)
        del plain_calls[:], lv_card, q_card
        differ, seg, seg_logits = forced(card, lv_cpu)
        del card
        with border_fault() as hits:
            bad, bad_seg, _ = forced(int8_model("cuda", INT8_FAULT_SCALE),
                                     lv_cpu)
        bad_border = [i for i, v in enumerate(bad_seg)
                      if v > INT8_SEGMENT_BAR]
        worst = int(np.argmax(seg))
        print(f"18(c) R50 int8 at f32, B 1, card against the CPU's plain "
              f"versions (same weights and scales): free-running, "
              f"{flip * total:.0f} of {total} int8 levels differ "
              f"({flip:.3e}; bar {INT8_FLIP_BAR}), the first at quantise "
              f"pass {first} of {len(shares)}; per pass "
              f"{['%.1e' % s for s in shares]}; logits rel L2 {rel:.3e} "
              f"(bar {INT8_LOGIT_BAR}), sign agreement {agree:.4f}; "
              f"teacher-forced (each card quantise pass on the CPU's input "
              f"to it and each GEMM on the CPU's levels, each returning the "
              f"CPU's result): {len(differ)} of {len(lv_cpu)} calls "
              f"({len(shares)} quantise passes, {n_gemm} GEMMs) differ from "
              f"the plain result; the card's inputs to the quantise passes "
              f"within rel L2 {max(seg):.3e} of the CPU's (the worst at pass "
              f"{worst}; bar {INT8_SEGMENT_BAR}; per pass "
              f"{['%.1e' % v for v in seg]}), its logits {seg_logits:.3e} "
              f"(bar {INT8_SEGMENT_LOGIT_BAR}); with {INT8_FAULT_SITE}'s "
              f"scale x {INT8_FAULT_SCALE} and vis_conv1's top row x "
              f"{INT8_BORDER_FAULT} ({len(hits)} border calls): K8 calls "
              f"{bad} differ, the inputs of passes {bad_border} break the "
              f"bar ({['%.1e' % bad_seg[i] for i in bad_border]}), caught; "
              f"CPU forward {cpu_s:.1f} s", flush=True)
        assert torch.isfinite(got).all()
        assert flip <= INT8_FLIP_BAR and rel <= INT8_LOGIT_BAR, (flip, rel)
        assert not differ, differ
        assert max(seg) <= INT8_SEGMENT_BAR, (worst, max(seg))
        assert seg_logits <= INT8_SEGMENT_LOGIT_BAR, seg_logits
        assert bad, "the planted scale fault was not caught"
        assert bad_border, "the planted border fault was not caught"
        out["f32_card_vs_cpu"] = {
            "flip_share": flip, "levels": total, "first_flip_pass": first,
            "quantize_passes": len(shares), "gemms": n_gemm,
            "flip_share_per_call": shares, "rel_l2": rel,
            "sign_agreement": agree, "teacher_forced_differ": differ,
            "segment_rel_l2": seg, "segment_logits_rel_l2": seg_logits,
            "fault_calls_differ": bad, "fault_segments_over_bar": bad_border}
        del lv_cpu
        torch.cuda.empty_cache()

        # (d) the bench at short lengths
        device = torch.device("cuda")
        n1, n2, trials = 2, 4, 2
        r50 = bench.config_for(bench.R50)
        metrics = [("cris_r50_eval_throughput_416px_b32", "eval", r50, 32)] + [
            (name, "int8", bench.config_for(p), b)
            for name, p, b in bench.INT8_METRICS]
        out["bench"], bench_k8, bench_k8q = [], 0, 0
        for name, step, mcfg, b in metrics:
            reset_counts(k1, k8, k8q)
            del plain_calls[:]
            r = bench.run_metric(name, step, mcfg, device, b, n1, n2, trials)
            bench.free(device)
            want = per_batch * r["batches"] if step == "int8" else 0
            assert k8.launches == r["k8_launches"] == want, (
                name, k8.launches, want)
            want = len(scales) * r["batches"] if step == "int8" else 0
            assert k8q.launches == want, (name, k8q.launches, want)
            # the int8 model's calibration forwards run K1 too
            calib = bench.CALIB_BATCHES if step == "int8" else 0
            assert k1.launches == 7 * (r["batches"] + calib), (
                name, k1.launches)
            assert not plain_calls
            bench_k8 += k8.launches
            bench_k8q += k8q.launches
            print(f"18(d) bench {name}: {r['value']:.2f} img/s (trials "
                  f"{['%.2f' % v for v in r['trials']]}, spread "
                  f"{r['spread']:.4f}), {r['batches']} batches of {b}, K8 "
                  f"{k8.launches // max(r['batches'], 1)} GEMMs, "
                  f"{k8q.launches // max(r['batches'], 1)} quantise passes "
                  f"and K1 7 a batch", flush=True)
            out["bench"].append({"metric": name, "batch": b, **r})
        ab = bench.ab_rewrites(r50, device, 32, n1, n2, rounds=1)
        bench.free(device)
        out["ab_rewrites"] = ab
        out["rewrite_parts"] = _rewrite_parts(bench, r50)
        out["bench_K8"], out["bench_int8_quantize"] = bench_k8, bench_k8q
        print(f"18(d) bench --ab rewrites at one round: median img/s "
              f"{ab['ab']['median_img_s']}, rewrites on by default: "
              f"{ab['ab']['rewrites_on']}", flush=True)
    finally:
        for name, fn in plains.items():
            setattr(k8mod, name, fn)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 18: {out['seconds']:.1f} s", flush=True)
    return out


# phase 19: a root in the released REFER layout (refs pickle, COCO
# instances JSON, train2014 JPEGs) made from a seed
PREP_SPLITS = {"train": 192, "val": 32, "testA": 16, "testB": 16}
PREP_IMAGES, PREP_SIZE, PREP_SEED = 128, (640, 480), 19
PREP_FIXTURES = os.path.join("tests", "torch_prep_fixtures")
_PREP_WORDS = ("the", "man", "woman", "dog", "left", "right", "red", "blue",
               "shirt", "car", "small", "big", "chair", "near", "top", "on")


def coco_polygon(rng, h: int, w: int, vertices=(8, 60), parts=(1, 3)):
    """A COCO-like polygon annotation: 1 to 3 parts of 8 to 60 float
    vertices (two decimals) around a random centre, some crossing the
    image's border and about one part in ten self-intersecting."""
    out = []
    for _ in range(rng.randint(parts[0], parts[1] + 1)):
        n = rng.randint(vertices[0], vertices[1] + 1)
        cx, cy = rng.uniform(-0.05, 1.05) * w, rng.uniform(-0.05, 1.05) * h
        r = rng.uniform(0.03, 0.4) * min(h, w)
        angle = rng.rand(n) * 2 * np.pi
        if rng.rand() >= 0.1:
            angle = np.sort(angle)
        radius = r * rng.uniform(0.5, 1.2, n)
        pts = np.stack([cx + radius * np.cos(angle),
                        cy + radius * np.sin(angle)], 1)
        out.append(np.round(pts, 2).ravel().tolist())
    return out


def rle_counts(mask: np.ndarray) -> list:
    """COCO's uncompressed RLE of a 0/1 mask: column-major runs, zeros
    first."""
    flat = mask.T.ravel().astype(np.int8)
    change = np.flatnonzero(np.diff(flat)) + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return [0] + counts if flat[0] else counts


def rle_string(counts: list) -> str:
    """pycocotools' rleToString: the compressed form of RLE counts."""
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def write_refer_root(root: str, seed: int = PREP_SEED,
                     splits=PREP_SPLITS, n_images: int = PREP_IMAGES,
                     size=PREP_SIZE, dataset: str = "refcoco",
                     split_by: str = "unc", image_ids=None) -> dict:
    """A REFER root under ``root`` in the released layout: ``n_images``
    JPEGs (``codec.encode_jpeg`` of drawn images at ``size``, w x h) and one ref a {split: count} entry of ``splits``, each with 1 to
    3 sentences and its own annotation (a COCO-like polygon list; every
    tenth an uncompressed RLE and every tenth a compressed RLE), plus
    unreferenced annotations, in ``{dataset}/refs({split_by}).p`` and
    ``{dataset}/instances.json``. Returns the counts."""
    import pickle

    from cris_tpu_torch.data.codec import encode_jpeg

    rng = np.random.RandomState(seed)
    w, h = size
    refclef = dataset == "refclef"
    img_dir = os.path.join(root, "images", "saiapr_tc-12" if refclef else
                           os.path.join("mscoco", "images", "train2014"))
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, dataset), exist_ok=True)
    ids = list(image_ids) if image_ids else [
        int(i) for i in rng.choice(10**6, n_images, replace=False)]
    images = []
    for image_id in ids:  # smooth colour waves and mild noise
        f = rng.uniform(8, 40, (2, 3))
        wave_x = 60 * np.sin(np.arange(w)[:, None] / f[0] + rng.rand(3) * 6)
        wave_y = 50 * np.cos(np.arange(h)[:, None] / f[1] + rng.rand(3) * 6)
        noise = np.frombuffer(rng.bytes(h * w * 3), np.uint8).reshape(h, w, 3)
        img = np.clip((120 + wave_x[None] + wave_y[:, None]).astype(np.float32)
                      + (noise & 15), 0, 255).astype(np.uint8)
        name = (f"{image_id}.jpg" if refclef
                else f"COCO_train2014_{image_id:012d}.jpg")
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(encode_jpeg(img))
        images.append({"id": image_id, "file_name": name, "height": h,
                       "width": w})
    cat_ids = [c for c in range(1, 91) if c not in (12, 26, 29, 30, 45, 66,
                                                      68, 69, 71, 83)]
    labels = [s for s, n in splits.items() for _ in range(n)]
    rng.shuffle(labels)
    annotations, refs, sent_id = [], [], 0
    for k, split in enumerate(labels + [None] * (len(labels) // 8)):
        image = images[rng.randint(len(images))]
        cat = int(rng.choice(cat_ids))
        kind = k % 10  # 8: uncompressed RLE, 9: compressed RLE
        if kind < 8:
            seg = coco_polygon(rng, h, w)
            pts = np.concatenate([np.reshape(p, (-1, 2)) for p in seg])
            x0, y0 = np.clip(pts.min(0), 0, [w, h])
            x1, y1 = np.clip(pts.max(0), 0, [w, h])
        else:
            yy, xx = np.mgrid[0:h, 0:w]
            cx, cy = rng.rand() * w, rng.rand() * h
            rx, ry = rng.uniform(0.05, 0.3, 2) * [w, h]
            mask = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
            counts = rle_counts(mask)
            seg = {"size": [h, w],
                   "counts": counts if kind == 8 else rle_string(counts)}
            x0, y0 = max(cx - rx, 0), max(cy - ry, 0)
            x1, y1 = min(cx + rx, w), min(cy + ry, h)
        ann_id = 10**6 + k
        annotations.append({
            "id": ann_id, "image_id": image["id"], "category_id": cat,
            "segmentation": seg, "iscrowd": 0, "area": float(rng.rand() * h * w),
            "bbox": [round(float(v), 2) for v in (x0, y0, x1 - x0, y1 - y0)]})
        if split is None:  # an annotation no ref points at
            continue
        sentences = []
        for _ in range(rng.randint(1, 4)):
            words = [str(x) for x in rng.choice(_PREP_WORDS,
                                                rng.randint(1, 7))]
            sent = " ".join(words) + (" " if rng.rand() < 0.2 else "")
            sentences.append({"tokens": words, "raw": sent, "sent": sent,
                              "sent_id": sent_id})
            sent_id += 1
        refs.append({"ref_id": len(refs) + 1, "ann_id": ann_id,
                     "image_id": image["id"], "category_id": cat,
                     "split": split, "file_name": image["file_name"],
                     "sent_ids": [s["sent_id"] for s in sentences],
                     "sentences": sentences})
    with open(os.path.join(root, dataset, f"refs({split_by}).p"), "wb") as f:
        pickle.dump(refs, f)
    with open(os.path.join(root, dataset, "instances.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": f"category {c}",
                                   "supercategory": "thing"}
                                  for c in cat_ids]}, f)
    return {"images": len(images), "refs": len(refs),
            "annotations": len(annotations), "sentences": sent_id}


_RATE_LINE = r"^(\S+): (\d+)/\d+ in ([0-9.]+) s, [0-9.]+/s$"


def _run_entries(cmds, timeout=300) -> list:
    """Run the commands at once, each in its own process (the repository
    root on PYTHONPATH); fail if one fails. Returns (stdout, wall seconds)
    each, and stops every process it started."""
    import re

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for cmd in cmds]
    outs = []
    try:
        for cmd, proc in zip(cmds, procs):
            stdout, stderr = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, (cmd, proc.returncode, stdout[-2000:],
                                          stderr[-4000:])
            outs.append((stdout, time.perf_counter() - t0))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for stdout, _ in outs:
        assert re.search(_RATE_LINE, stdout, re.M), stdout[-2000:]
    return outs


def _stage_rate(outs) -> dict:
    """The entries' progress lines summed: refs, seconds in their loops
    (refs/s on one process), and the stage's wall seconds."""
    import re

    refs = seconds = 0.0
    for stdout, _ in outs:
        for _, n, s in re.findall(_RATE_LINE, stdout, re.M):
            refs, seconds = refs + int(n), seconds + float(s)
    return {"refs": int(refs), "loop_seconds": seconds,
            "refs_per_s": refs / seconds,
            "wall_seconds": max(wall for _, wall in outs)}


def check_rasterizer_fixture() -> int:
    """The committed polygon annotations of tests/torch_prep_fixtures
    rasterise to the sha256 digests cv2.fillPoly gave (digests.json)."""
    from cris_tpu_torch.data.refer import rasterize_polygons

    with open(os.path.join(PREP_FIXTURES, "polygons.json")) as f:
        cases = json.load(f)
    with open(os.path.join(PREP_FIXTURES, "digests.json")) as f:
        want = json.load(f)["masks"]
    assert len(cases) == len(want) >= 20, (len(cases), len(want))
    for case, digest in zip(cases, want):
        mask = rasterize_polygons(case["segmentation"], case["height"],
                                  case["width"])
        got = hashlib.sha256(mask.tobytes()).hexdigest()
        assert got == digest, (case["name"], got, digest)
    return len(cases)


def phase_prep(k1, k2, k2_bwd):
    """19: dataset preparation on the card's machine, then train and test
    from its packs: (a) a REFER root from a seed; (b) python3 -m
    cris_tpu_torch.data_process (masks), .folder2pack for each split and
    .prewarp of train and val (val --keep-ori), in subprocesses: record
    counts, every mask PNG decodes to REFER.getMask's mask, the
    rasterizer fixture's digests, refs/s a stage; (c) the first b16 train
    batch of the prewarped pack equals the raw pack's through the native
    data plane; (d) python3 -m cris_tpu_torch.train at R50 bf16 b16 from
    the prewarped pack, 1 epoch of 12 steps, validating on the val pack,
    then python3 -m cris_tpu_torch.test on it."""
    import re

    from cris_tpu_torch import test as test_entry
    from cris_tpu_torch import train as entry
    from cris_tpu_torch.data import RefDataLoader, RefDataset, RefPackReader
    from cris_tpu_torch.data.codec import decode_mask
    from cris_tpu_torch.data.refer import REFER
    from cris_tpu_torch.utils import cris_r50_refcoco

    t_phase = time.perf_counter()
    cfg = cris_r50_refcoco()
    b, size = 16, cfg.input_size
    py = sys.executable
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, prep = os.path.join(tmp, "refer"), os.path.join(tmp, "prep")
        t0 = time.perf_counter()
        made = write_refer_root(root)
        print(f"19(a) REFER root from seed {PREP_SEED}: {made} "
              f"({PREP_SIZE[0]} x {PREP_SIZE[1]} JPEGs, splits "
              f"{PREP_SPLITS}) in {time.perf_counter() - t0:.1f} s",
              flush=True)
        assert made["refs"] == sum(PREP_SPLITS.values())

        # (b) the three entries
        packs, warped = os.path.join(prep, "pack"), os.path.join(prep, "warped")
        masks = os.path.join(prep, "masks", "refcoco")
        stages = {"data_process": _run_entries([[
            py, "-m", "cris_tpu_torch.data_process", "--data_root", root,
            "--output_dir", prep, "--dataset", "refcoco", "--split", "unc",
            "--generate_mask"]])}
        stages["folder2pack"] = _run_entries([[
            py, "-m", "cris_tpu_torch.folder2pack", "-j",
            os.path.join(prep, "anns", "refcoco", f"{s}.json"), "-i",
            os.path.join(root, "images", "mscoco", "images", "train2014"),
            "-m", masks, "-o", packs] for s in PREP_SPLITS])
        stages["prewarp"] = _run_entries([
            [py, "-m", "cris_tpu_torch.prewarp", "-i",
             os.path.join(packs, f"{s}.refpack"), "-o",
             os.path.join(warped, f"{s}.refpack"), "--input-size", str(size)]
            + (["--keep-ori"] if s == "val" else []) for s in ("train", "val")])
        rates = {k: _stage_rate(v) for k, v in stages.items()}
        counts = {}
        for folder, names in ((packs, PREP_SPLITS), (warped, ("train", "val"))):
            for s in names:
                reader = RefPackReader(os.path.join(folder, f"{s}.refpack"))
                counts[f"{os.path.basename(folder)}/{s}"] = len(reader)
                assert len(reader) == PREP_SPLITS[s], (folder, s, len(reader))
                reader.close()
        refer = REFER(root, "refcoco", "unc")
        for ref_id, ref in refer.Refs.items():
            with open(os.path.join(masks, f"{ref_id}.png"), "rb") as f:
                got = decode_mask(f.read())
            assert np.array_equal(got, refer.getMask(ref)["mask"] * 255), ref_id
        n_fixture = check_rasterizer_fixture()
        print(f"19(b) data_process, folder2pack ({len(PREP_SPLITS)} splits "
              f"at once), prewarp (train, val --keep-ori, at once) in "
              f"subprocesses: records {counts}; {len(refer.Refs)} mask PNGs "
              f"decode to REFER.getMask's masks; the {n_fixture} fixture "
              f"annotations rasterise to cv2.fillPoly's digests; refs/s a "
              f"stage on the card's host (in the entries' loops, one "
              f"process each; wall s with the processes' start): "
              + ", ".join(f"{k} {r['refs_per_s']:.2f} ({r['refs']} refs, "
                          f"{r['wall_seconds']:.1f} s)"
                          for k, r in rates.items()), flush=True)
        out.update(records=counts, stages=rates, fixture=n_fixture)

        # (c) the first train batch, prewarped against raw through the plane
        first = {}
        with plane_calls() as calls:
            for name, folder in (("warped", warped), ("raw", packs)):
                data = RefDataset(os.path.join(folder, "train.refpack"), masks,
                                  cfg.dataset, "train", "train", size,
                                  cfg.word_len)
                loader = RefDataLoader(data, batch_size=b, shuffle=True,
                                       seed=cfg.manual_seed, drop_last=True,
                                       num_workers=1)
                loader.set_epoch(1)
                first[name] = next(iter(loader))
        assert calls == [b], calls  # the raw pack's batch alone
        assert set(first["warped"]) == set(first["raw"])
        for key, value in first["raw"].items():
            assert np.array_equal(first["warped"][key], value), key
        print(f"19(c) the first b{b} train batch of the prewarped pack equals "
              f"the raw pack's through the native data plane bit for bit "
              f"({sorted(first['raw'])}); plane calls {calls}", flush=True)

        # (d) train from the prewarped pack, then test on the val pack
        steps = PREP_SPLITS["train"] // b
        val_batches = -(-PREP_SPLITS["val"] // cfg.batch_size_val)
        sites = 2 * cfg.num_layers
        argv = ["--config", os.path.join("config", "refcoco", "cris_r50.yaml"),
                "--opts", "DATA.train_lmdb",
                os.path.join(warped, "train.refpack"),
                "DATA.val_lmdb", os.path.join(warped, "val.refpack"),
                "DATA.mask_root", masks, "TRAIN.batch_size", str(b),
                "TRAIN.epochs", "1", "TRAIN.print_freq", "4",
                "TRAIN.output_folder", tmp]
        reset_counts(k1, k2, k2_bwd)
        t0 = time.perf_counter()
        best, last = entry.main(argv)
        train_s = time.perf_counter() - t0
        counts = {"K1": k1.launches, "K2 fwd": k2.launches,
                  "K2 bwd": k2_bwd.launches}
        routes = {"K1": dict(k1.launches_by_route),
                  "K2 fwd": dict(k2.launches_by_route),
                  "K2 bwd": dict(k2_bwd.launches_by_route)}
        _close_log()
        out_dir = os.path.join(tmp, cfg.exp_name)
        log_path = os.path.join(out_dir, "train.log")
        with open(log_path) as f:
            log = f.read()
        run = _run_line(log_path)
        losses = [float(x) for x in re.findall(r"Loss=(\S+)", log)]
        print(f"19(d) python3 -m cris_tpu_torch.train (R50 {size} px, b{b}, "
              f"bf16, seeded weights, the prewarped pack, 1 epoch of {steps} "
              f"steps, val on the prewarped val pack): losses {losses}, best "
              f"IoU {best:.6f}; launches {counts}, by route {routes}; main "
              f"{train_s:.1f} s", flush=True)
        print(f"19(d) => run: {json.dumps(run)}", flush=True)
        assert last == 1 and losses and all(np.isfinite(losses)), losses
        want = {"K1": steps + 7 * val_batches, "K2 fwd": sites * steps,
                "K2 bwd": sites * steps}
        assert counts == want, (counts, want)
        for name, n in want.items():
            assert routes[name] == {"tensor_cores": n, "scalar": 0}, routes
        assert run["steps"] == steps and run["images"] == steps * b, run

        targv = ["--config", os.path.join("config", "refcoco", "cris_r50.yaml"),
                 "--opts", "TRAIN.output_folder", tmp, "TEST.test_lmdb",
                 os.path.join(warped, "val.refpack"), "DATA.mask_root", masks]
        reader = RefPackReader(os.path.join(warped, "val.refpack"))
        pairs = sum(reader[i]["num_sents"] for i in range(len(reader)))
        reader.close()
        reset_counts(k1)
        t0 = time.perf_counter()
        iou, prec = test_entry.main(targv)
        test_s = time.perf_counter() - t0
        test_k1, test_routes = k1.launches, dict(k1.launches_by_route)
        _close_log()
        with open(os.path.join(out_dir, "test.log")) as f:
            test_log = f.read()
        test_run = _run_line(os.path.join(out_dir, "test.log"))
        batches = -(-pairs // cfg.batch_size_val)
        print(f"19(d) python3 -m cris_tpu_torch.test on the prewarped val pack: "
              f"IoU {100 * iou:.2f}, "
              + ", ".join(f"{k} {100 * v:.2f}" for k, v in prec.items())
              + f"; {test_run['pairs']} pairs in {test_run['batches']} "
              f"batches, {test_run['pairs_per_s']:.2f} pairs/s; K1 {test_k1} "
              f"({test_routes}); main {test_s:.1f} s", flush=True)
        print(f"19(d) test => run: {json.dumps(test_run)}", flush=True)
        assert "IoU=" in test_log, test_log[-2000:]
        assert test_run["pairs"] == pairs and test_run["batches"] == batches
        assert test_run["pairs_per_s"] > 0, test_run
        assert test_k1 == 7 * batches, (test_k1, batches)
        assert test_routes == {"tensor_cores": test_k1, "scalar": 0}
        assert all(np.isfinite(v) and 0.0 <= v <= 1.0
                   for v in [iou, *prec.values()]), (iou, prec)
        out.update(losses=losses, best_iou=best, run=run, launches=counts,
                   by_route=routes, train_seconds=train_s, test_iou=iou,
                   test_run=test_run, test_K1=test_k1, test_seconds=test_s)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 19: {out['seconds']:.1f} s", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="all",
                        help="comma-separated phase numbers to run (the "
                             "build, phase 1, always runs); a subset prints "
                             "no summary")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    run_all = args.phases == "all"
    wanted = set(range(2, 20)) if run_all else {
        int(x) for x in args.phases.split(",")}

    from cris_tpu_torch import bench, engine
    from cris_tpu_torch.checkpoint import fold_batchnorm
    from cris_tpu_torch.models import build_segmenter, preset_from_name
    from cris_tpu_torch.ops import kernels
    from cris_tpu_torch.ops.kernels import build
    from cris_tpu_torch.ops.kernels.bottleneck import K5_TAILS
    from cris_tpu_torch.serving import PredictService
    from cris_tpu_torch.utils import cris_r50_refcoco, tokenize

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build.load_library()
    log = build.library_path().with_suffix(".log")
    print(f"kernel build: {build.last_build_seconds:.1f} s -> "
          f"{build.library_path()}", flush=True)
    if log.is_file():
        print(log.read_text(), flush=True)

    cfg = cris_r50_refcoco()
    k1 = kernels.fused_attention_bse
    k2 = kernels.fused_attention_bse_dropout
    k5, k7 = kernels.fused_bottleneck, kernels.fused_stem_pool
    out = {}
    # each phase reads from `kernels` only what it drives
    if 2 in wanted:
        out["k1_rows"], out["k1_worst"], out["k1_main"] = phase_kernel(
            k1, kernels.attention_plain)
    if 3 in wanted:
        phase_model(cfg, build_segmenter, tokenize)
    if 4 in wanted:
        out["serving"], _, out["serving_routes"] = phase_serving(
            cfg, PredictService, {"K1": (k1, 7)})
    if 5 in wanted:
        out["k1_grad_rows"], out["k1_grad_worst"] = phase_k1_backward(
            k1, kernels.attention_plain)
    if 6 in wanted:
        (out["k2_rows"], out["k2_fwd_worst"], out["k2_bwd_worst"],
         _) = phase_k2(k2, kernels.attention_dropout_forward,
                       kernels.attention_dropout_backward,
                       kernels.attention_dropout_plain,
                       kernels.attention_dropout_backward_plain, k1,
                       kernels.keep_mask, kernels.keep_bits_packed)
    if 7 in wanted:
        phase_train_card_vs_cpu(cfg, build_segmenter)
    if 8 in wanted:
        counters = [k2, kernels.attention_dropout_backward, k1]
        out["train"] = phase_train_bf16(cfg, build_segmenter, engine,
                                        counters)
    if 9 in wanted:
        out["k5_rows"] = phase_k5(k5, kernels.bottleneck_plain,
                                  kernels.bottleneck_route,
                                  kernels.bottleneck_plan)
        out["k7_rows"] = phase_k7(k7, kernels.stem_pool_plain,
                                  kernels.stem_route, kernels.stem_plan)
    if 10 in wanted:
        sd, _ = phase_folded_model(cfg, build_segmenter, fold_batchnorm, k5,
                                   k7, tokenize)
        out["folded_serving"], _, out["folded_routes"] = phase_serving(
            cfg, PredictService,
            {"K1": (k1, 7), "K7": (k7, 1),
             "K5": (k5, k5_tails_taken(cfg, preset_from_name,
                                       kernels.bottleneck_takes, K5_TAILS))},
            state_dict=sd, fused_bottleneck=True, fused_stem=True)
        out["ab"] = phase_ab(cfg, build_segmenter, fold_batchnorm, sd)
    if 11 in wanted:
        out["api"] = phase_kernel_api(
            {n: getattr(kernels, n) for n in kernels.__all__}, cfg,
            build_segmenter)
    if 12 in wanted:
        out["bench"] = phase_bench(
            bench, build_segmenter, fold_batchnorm, tokenize,
            preset_from_name, kernels.bottleneck_takes, k1, k2,
            kernels.attention_dropout_backward, k5, k7)
    if 13 in wanted:
        out["test_path"] = phase_test_path(k1)
    if 14 in wanted:
        out["train_entry"] = phase_train_entry(
            k1, k2, kernels.attention_dropout_backward)
    if 15 in wanted:
        out["host_plane"] = phase_host_plane(
            k1, k2, kernels.attention_dropout_backward)
    if 16 in wanted:
        out["dp"] = phase_data_parallel(
            k2, kernels.attention_dropout_forward,
            kernels.attention_dropout_plain, kernels.keep_bits_packed)
    if 17 in wanted:
        out["front"] = phase_front(k1)
    if 18 in wanted:
        out["int8"] = phase_int8(k1, kernels.int8_conv, kernels.int8_quantize)
    if 19 in wanted:
        out["prep"] = phase_prep(k1, k2, kernels.attention_dropout_backward)
    if not run_all:
        print(f"chip_smoke: phases 1, {sorted(wanted)} passed; a subset "
              "prints no summary", flush=True)
        return 0
    print(json.dumps(summary(out)), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def summary(out) -> dict:
    """The kernels line, after printing the detail rows as one JSON line."""
    (k2_fwd_n, k2_bwd_n, k1_train_n), step_ms, peak, _, train_routes = \
        out["train"]
    bench = out["bench"]["launches"]  # phase 12, all on tensor_cores
    test_path = out["test_path"]  # phase 13
    train_py = out["train_entry"]  # phase 14 (b), all on tensor_cores
    ab_py = out["host_plane"]["launches"]  # phase 15 (d), all tensor_cores
    dp_py = out["dp"]["entry"]["launches"]  # phase 16 (c), all tensor_cores
    front = out["front"]  # phase 17 (b)
    k2_fwd_routes, k2_bwd_routes, k1_train_routes = train_routes
    # K2 at the train path's busiest site: self-attention, B 32, bf16
    main_k2 = next(r for r in out["k2_rows"] if r["site"].startswith(
        "decoder self-attn") and r["B"] == 32 and r["dtype"] == "bfloat16")
    k2_src = "cris_tpu_torch/csrc/attention_bse_dropout.cu"

    def k2_entry(part, replaces, train_n, bench_n, by_route, worst):
        """K2's forward or backward at its main site, on the device alone
        (the tensor-core kernels run shorter than the wrapper's host time),
        with SDPA with dropout as the library call."""
        key = {"forward": "fwd", "backward": "bwd"}[part]
        entry_n = (train_py["launches"][f"K2 {key}"]
                   + ab_py[f"K2 {key}"] + dp_py[f"K2 {key}"])
        return {
            "name": f"fused_attention_bse_dropout ({part})",
            "route": "cuda",
            "source": k2_src,
            "replaces": f"cris_tpu/ops/pallas/attention_train.py:{replaces}",
            "launches": train_n + bench_n + entry_n,
            "launches_by_path": {"train": train_n, "bench": bench_n,
                                 "train.py": train_py["launches"][f"K2 {key}"],
                                 "train.py A/B": ab_py[f"K2 {key}"],
                                 "train.py torchrun": dp_py[f"K2 {key}"]},
            "launches_by_route": {r: n + (bench_n + entry_n
                                          if r == "tensor_cores" else 0)
                                  for r, n in by_route.items()},
            "max_abs_err": worst,
            "ms": main_k2[f"{key}_device_ms"],
            "plain_ms": main_k2[f"plain_{key}_ms"],
            "bound_ms": main_k2[f"{key}_bound_ms"],
            "bound_by": main_k2[f"{key}_bound_by"],
            "bound_term": main_k2[f"{key}_bound_term"],
            "library_ms": main_k2[f"sdpa_{key}_device_ms"],
            "back_to_back_ms": main_k2[f"{key}_ms"],
            "library_back_to_back_ms": main_k2[f"sdpa_{key}_ms"],
            "library": "scaled_dot_product_attention with dropout_p (its "
                       "own Philox stream: the same work, other bits), "
                       "backend " + main_k2["sdpa_backend"],
            "site": "decoder self-attn, B 32 bf16, route " + main_k2["route"],
            # phase 16 (a): a data-parallel rank's batch at its offsets
            "offset_cases": [
                {k: r[k] for k in ("site", "B", "batch_offset", "dtype",
                                   "route", f"{key}_max_abs_err",
                                   f"{key}_device_ms", f"{key}_bound_ms",
                                   f"{key}_bound_by")}
                for r in out["dp"]["k2_offset"]],
        }
    folded = out["folded_serving"]
    k1_main = out["k1_main"]

    def per_forward(rows, key):
        """bf16 K5 summed over one forward's 12 launches."""
        return sum(r[key] * r["launches_per_forward"] for r in rows
                   if r["dtype"] == "bfloat16")

    # the term that holds more of the 12 launches' summed bound
    by_kind = {"bytes": 0.0, "operations": 0.0}
    for r in out["k5_rows"]:
        if r["dtype"] == "bfloat16":
            by_kind[r["bound_by"]] += r["bound_ms"] * r["launches_per_forward"]
    k5_bound_by = max(by_kind, key=by_kind.get)
    k7_main = next(r for r in out["k7_rows"] if r["dtype"] == "bfloat16")
    kernels = [{
        "name": "fused_attention_bse",
        "route": "cuda",
        "source": "cris_tpu_torch/csrc/attention_bse.cu",
        "replaces": "cris_tpu/ops/pallas/attention.py:165",
        "launches": (out["serving"]["K1"] + k1_train_n + folded["K1"]
                     + bench["K1"] + test_path["K1"]
                     + train_py["launches"]["K1"] + ab_py["K1"]
                     + dp_py["K1"] + front["K1"]),
        "launches_by_path": {"serving": out["serving"]["K1"],
                             "train": k1_train_n,
                             "folded serving": folded["K1"],
                             "bench": bench["K1"],
                             "test.py": test_path["K1"],
                             "train.py": train_py["launches"]["K1"],
                             "train.py A/B": ab_py["K1"],
                             "train.py torchrun": dp_py["K1"],
                             "HTTP front": front["K1"]},
        "launches_by_route": {
            r: out["serving_routes"]["K1"][r] + k1_train_routes[r]
            + out["folded_routes"]["K1"][r]
            + (bench["K1"] + ab_py["K1"] + dp_py["K1"]
               if r == "tensor_cores" else 0)
            + test_path["K1_by_route"][r] + train_py["by_route"]["K1"][r]
            + front["K1_by_route"][r]
            for r in k1_train_routes},
        "max_abs_err": max(out["k1_worst"], out["k1_grad_worst"]),
        # on the device alone: the tensor-core body runs shorter than the
        # wrapper's host time, which back-to-back calls would time
        "ms": k1_main["device_ms"],
        "plain_ms": k1_main["plain_device_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": k1_main["library_device_ms"],
        "back_to_back_ms": k1_main["ms"],
        "plain_back_to_back_ms": k1_main["plain_ms"],
        "library_back_to_back_ms": k1_main["library_ms"],
        "library": "scaled_dot_product_attention",
        "site": "decoder self-attn, B 16 bf16, route " + k1_main["route"],
    }, k2_entry("forward", 218, k2_fwd_n, bench["K2 fwd"], k2_fwd_routes,
                out["k2_fwd_worst"]),
        k2_entry("backward", 248, k2_bwd_n, bench["K2 bwd"], k2_bwd_routes,
                 out["k2_bwd_worst"]), {
        "name": "fused_bottleneck (12 launches of one b16 bf16 forward)",
        "route": "cuda",
        "source": "cris_tpu_torch/csrc/bottleneck.cu",
        "replaces": "cris_tpu/ops/pallas/bottleneck.py:208",
        "launches": folded["K5"] + bench["K5"],
        "launches_by_path": {"folded serving": folded["K5"],
                             "bench --ab": bench["K5"]},
        "launches_by_route": {
            r: n + (bench["K5"] if r == "tensor_cores" else 0)
            for r, n in out["folded_routes"]["K5"].items()},
        "max_abs_err": max(r["max_abs_err"] for r in out["k5_rows"]),
        # on the device alone, as K1-K4 and K6
        "ms": per_forward(out["k5_rows"], "device_ms"),
        "plain_ms": per_forward(out["k5_rows"], "plain_ms"),
        "bound_ms": per_forward(out["k5_rows"], "bound_ms"),
        "bound_by": k5_bound_by,
        "library_ms": per_forward(out["k5_rows"], "library_device_ms"),
        "back_to_back_ms": per_forward(out["k5_rows"], "ms"),
        "library_back_to_back_ms": per_forward(out["k5_rows"], "library_ms"),
        "l2_weight_ms": per_forward(out["k5_rows"], "l2_weight_ms"),
        "library": "cuDNN chain: 3 convs + biases, ReLUs, residual add",
        "site": "the four R50 tails at B 16 bf16, route tensor_cores",
        "shapes": [{k: r[k] for k in ("site", "route", "device_ms", "ms",
                                      "library_device_ms", "bound_ms",
                                      "bound_by", "l2_weight_ms",
                                      "launches_per_forward")}
                   for r in out["k5_rows"] if r["dtype"] == "bfloat16"],
    }, {
        "name": "fused_stem_pool",
        "route": "cuda",
        "source": "cris_tpu_torch/csrc/stem.cu",
        "replaces": "cris_tpu/ops/pallas/stem.py:177",
        "launches": folded["K7"] + bench["K7"],
        "launches_by_path": {"folded serving": folded["K7"],
                             "bench --ab": bench["K7"]},
        "launches_by_route": {
            r: n + (bench["K7"] if r == "tensor_cores" else 0)
            for r, n in out["folded_routes"]["K7"].items()},
        "max_abs_err": max(r["max_abs_err"] for r in out["k7_rows"]),
        # on the device alone, as K1-K6
        "ms": k7_main["device_ms"],
        "plain_ms": k7_main["plain_ms"],
        "bound_ms": k7_main["bound_ms"],
        "bound_by": k7_main["bound_by"],
        "library_ms": k7_main["library_device_ms"],
        "back_to_back_ms": k7_main["ms"],
        "library_back_to_back_ms": k7_main["library_ms"],
        "plan": k7_main.get("plan"),
        "site": f"R50 stem 416^2, B 16 bf16, route {k7_main['route']}",
        "library": "cuDNN chain: 3 convs + biases, ReLUs, 2x2 avg pool",
    }]
    i8 = out["int8"]
    # K8's headline site: the 1x1 site of most work, where torch._int_mm
    # computes the same int8 product; the GEMM alone against it
    site = max((r for r in i8["sites"] if r["int_mm_ms"] is not None),
               key=lambda r: r["gemm_bound_ms"])
    kernels.append({
        "name": "int8_conv",
        "route": "cuda",
        "source": "cris_tpu_torch/csrc/int8_conv.cu",
        "replaces": "cris_tpu/ops/quant.py:64",
        "launches": i8["serving"]["K8"] + i8["bench_K8"],
        "launches_by_path": {"int8 serving": i8["serving"]["K8"],
                             "bench int8 pair": i8["bench_K8"]},
        "max_abs_err": max(r["max_abs_err"] for r in i8["sites"]),
        "ms": site["gemm_device_ms"],
        "plain_ms": site["gemm_plain_ms"],
        "bound_ms": site["gemm_bound_ms"],
        "bound_by": site["gemm_bound_by"],
        "library_ms": site["int_mm_ms"],
        "library": "torch._int_mm on the GEMM's own int8 operands (the "
                   "product without the epilogue, int32 out)",
        "cudnn_bf16_ms": site["cudnn_bf16_ms"],
        "plan": site["plan"],
        "site": site["site"],
        "forward_b16": i8["forward"],
        "replaces_note": "no Pallas kernel: the XLA int8 conv of "
                         "int8_conv2d_static",
    })
    qrow = next(r for r in i8["quantize_sites"]
                if r["input"] == site["quantize_input"])
    kernels.append({
        "name": "int8_quantize",
        "route": "cuda",
        "source": "cris_tpu_torch/csrc/int8_conv.cu",
        "replaces": "cris_tpu/ops/quant.py:87",
        "launches": i8["serving"]["int8_quantize"] + i8["bench_int8_quantize"],
        "launches_by_path": {"int8 serving": i8["serving"]["int8_quantize"],
                             "bench int8 pair": i8["bench_int8_quantize"]},
        "max_abs_err": max(r["max_abs_err"] for r in i8["quantize_sites"]),
        "ms": qrow["device_ms"],
        "plain_ms": qrow["plain_ms"],
        "bound_ms": qrow["bound_ms"],
        "bound_by": qrow["bound_by"],
        "library_ms": None,
        "site": f"the input of {site['site']}",
        "forward_b16_ms": i8["forward"]["quantize_device_ms"],
        "replaces_note": "no Pallas kernel: XLA's elementwise quantise "
                         "of int8_conv2d_static",
    })
    api = out["api"]
    # K3, K4 and K6 at their main sites, B 16 bf16
    for name, kernel, site, src, replaces, library in (
            ("fused_attention", "K3", "decoder self-attn", "attention_bse.cu",
             "attention.py:101", "scaled_dot_product_attention"),
            ("fused_matmul", "K4", "decoder FFN fc1", "fused_matmul.cu",
             "fused_matmul.py:90", "cuBLAS chain: addmm, residual add, ReLU"),
            ("layer_norm (forward)", "K6 fwd", "decoder LN", "layernorm.cu",
             "layernorm.py:92", "F.layer_norm"),
            ("layer_norm (backward)", "K6 bwd", "decoder LN", "layernorm.cu",
             "layernorm.py:123", "F.layer_norm's autograd backward")):
        row = next(r for r in api["rows"] if r["kernel"] == kernel and
                   r["site"] == site and r["dtype"] == "bfloat16")
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"cris_tpu_torch/csrc/{src}",
            "replaces": f"cris_tpu/ops/pallas/{replaces}",
            "launches": api["launches"][kernel],
            "launches_by_path": {"kernel api": api["launches"][kernel]},
            "max_abs_err": api["worst"][kernel],
            # on the device alone: at the small sites the back-to-back
            # times are the Python wrapper's enqueue rate
            "ms": row["device_ms"],
            "plain_ms": row["plain_device_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_device_ms"],
            "back_to_back_ms": row["ms"],
            "plain_back_to_back_ms": row["plain_ms"],
            "library_back_to_back_ms": row["library_ms"],
            "library": library,
            "site": f"{site}, B 16 bf16",
        }
        if kernel in api["by_route"]:
            entry["launches_by_route"] = api["by_route"][kernel]
            entry["site"] += ", route " + row["route"]
        kernels.append(entry)
    print(json.dumps({"k1_shapes": out["k1_rows"],
                      "k1_grad": out["k1_grad_rows"],
                      "k2_shapes": out["k2_rows"],
                      "k5_shapes": out["k5_rows"], "k7": out["k7_rows"],
                      "folded_forward_ab_b16_bf16": out["ab"],
                      "kernel_api": api["rows"],
                      "kernel_api_on_model_activations":
                          api["model_max_abs_err"],
                      "kernel_api_seconds": api["seconds"],
                      "train_bf16_b32": {"median_step_ms": step_ms,
                                         "peak_gib": peak},
                      "bench_short": out["bench"],
                      "test_path": {k: v for k, v in test_path.items()
                                    if k != "K1_by_route"},
                      "train_entry": {k: v for k, v in train_py.items()
                                      if k != "by_route"},
                      "host_plane": out["host_plane"],
                      "data_parallel": {k: v for k, v in out["dp"].items()
                                        if k != "k2_offset"},
                      "front": {k: v for k, v in front.items()
                                if k != "K1_by_route"},
                      "int8": {k: v for k, v in i8.items()
                               if k != "ab_rewrites"},
                      "int8_ab_rewrites": i8["ab_rewrites"]}), flush=True)
    return {"kernels": kernels}


if __name__ == "__main__":
    sys.exit(main())
