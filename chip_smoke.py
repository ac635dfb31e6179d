#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, all of them on every run, each printing its lines; any failure
raises and exits non-zero:

1. device: CUDA present; the card's name and power limit from nvidia-smi;
   torch's TF32 flags as this torch sets them by default (left in force: the
   fp32 reference scorer pins IEEE fp32 itself);
2. build: compile every kernel of the serving paths from csrc/ with nvcc,
   one process per source, all at once: K1 (middle_block.cu, both tap
   orders), K2 (middle_block_w8.cu), the int8 depthwise (dw_w8a8.cu), K3
   (entry_block.cu), K4 (entry_pair.cu) and K5 (sepconv_unit.cu);
3. kernels, TF32 off for this phase only: each kernel against its plain
   PyTorch version at the shapes serving gives it, at edge shapes, and at
   N = 1 at widths past the first design's staged band (W > 512; > 1024 for
   the int8 depthwise); K1 in both tap orders, K4 with each JAX entry
   point's switches; then the device launches of one K4 pair (2) and one K3
   block (4) at each stride-2 block's shape, counted in a captured CUDA
   graph;
4. slice: a seeded full-width XceptionLSTMV + ArcFace bundle in the JAX
   format and a few uint8 clips at 256^2, scored through the port's CLI
   (``cli/serve.py --engine visual``, bf16 on CUDA), on the fp path, with
   ``--quantize w8a8-pallas``, with ``--fuse_entry true`` and with
   ``--middle_taps bf16 --entry_pair true --fuse_exit true``, each with the
   launch counters set to 0 just before and read just after: 8 K1 launches
   per backbone call on the fp path; 8 K2 and 10 int8-depthwise launches,
   and no K1, on the w8a8 path; 8 K1 and 4 K3 on the fused-entry path; 8
   bf16-tap K1, 4 K4 and 2 K5 on the routes' path. Then every mode and
   route through ``VisualScorer``, counted the same way (w8a8-hybrid: 8 K1
   and 10 int8-depthwise launches per backbone call; w8a8: 34
   int8-depthwise; each route alone), against the plain path on the same
   calibrated tree and against the plain fp32 path; per quant mode two
   controls, wrong trees put in the program's place, and on each kernel
   route one, a wrong operand, each of which must fail its bars; then
   ``w8a8-pallas`` calibrated without and with one refinement pass, the
   refined no further from plain fp32;
5. times on the card (CUDA events after warmup): each kernel against its
   plain version and against PyTorch's own calls for the same function (K3
   per stride-2 block, K4 per stride-2 pair beside the first design's
   four-launch pair (two K5 units), K5 per exit conv, of 256 frames, with
   its depthwise and GEMM halves, one call being 2 device launches; the two
   halves of K1 and of K2 per launch by ``torch.profiler`` beside their
   bounds and cuDNN's depthwise and cuBLAS's ``addmm`` (K2:
   ``torch._int_mm``) alone, one block being 6 device launches, 3 of each
   half; launches counted in a captured CUDA graph), and the slice's
   frames/s, fp (plain, K1, each route) and w8a8, in turns; then the device
   busy share and the top kernels of one scored batch per kernel path
   (``torch.profiler``); then the same at the audio path's shapes: each
   kernel, the MFCC frontend alone, clips/s of 64 one-second clips (plain,
   K1, all routes, ``w8a8-pallas``) and profiles;
6. audio and AV: each kernel against its plain version at the audio path's
   shapes (64 one-second clips: 6,464 MFCC images of 64^2) runs in phase 3;
   here the MFCC frontend on the card against the CPU, a seeded full-width
   XceptionLSTMA bundle (hidden 512) and waveforms of 0.5, 1.0 and 2.3 s
   scored through ``cli/serve.py --engine audio`` on the same four paths,
   counted; every path, route and quant mode through ``AudioScorer``,
   counted, against the plain paths, each with its control at the audio
   bars; both engines' refined calibration; ``--engine av`` against the two
   engines' own fusion;
7. the AU engines, which run no kernel of the port's own (the JAX package
   runs none of its Pallas kernels there either): seeded full-width
   AU-face (lstm_hidden 256) and AU-patch (hidden 128, lstm_hidden 128)
   bundles in the JAX format; ``.npy`` inputs of T 16, 9 and 5 (17 AUs,
   faces of 224^2, patches of 128^2; one float input, one ``_weights.npy``
   sibling) scored through ``cli/serve.py --engine au_patch`` and ``--engine
   au_face``, bf16 and ``--quantize w8a8``, counted (no launch of any kernel);
   each against ``AUFaceScorer`` / ``AUPatchScorer`` on the CLI's batch, and
   those against the plain fp32 scorer on the card (per-image ResNet-18
   features and pooled embeddings, cosine; scores), w8a8 with its bars and a
   clipping-calibration control that must fail them; the refined
   calibration no further from plain fp32 than the unrefined; the card's
   fp32 scorer against the CPU's on a small input; then ``score()`` of 8
   clips x 16 frames, bf16 and w8a8 in turns (clips/s, frames/s), the
   batch's pageable H2D copy alone, and one profile per engine and mode;
8. visual training (``cli/train_visual.py``), which runs no kernel of the
   port's own (the JAX trainer runs its live-BN Xception on XLA convs): one
   SGD step at full width (B=2, T=2, 64^2) on the card (TF32 off) and on the
   CPU from the same weights, in fp32 and in fp64, loss, running statistics
   and post-step deltas held, each with a control (``torch.var``'s two-pass
   unbiased variance in the BN) that must fail; bf16 against fp32 gradients per top-level
   subtree at 224^2, with a control (the backbone's BN on running
   statistics); the CLI's step at its defaults (B=4 x T=50 at 224^2, bf16),
   frozen and unfrozen: ms a step, frames/s, peak memory, idle share and a
   profile; 25 Adam steps on one batch, whose loss must fall, and the lr = 0
   control, whose loss must not; then the CLI trains a synthetic tree for 2
   epochs, plain and from the feature cache, and each best bundle is scored
   through ``cli/serve.py --engine visual`` (BN-folded, bf16, K1 counted)
   against the trainer's eval probabilities of the best epoch;
9. the audio, AU-patch and AU-face trainers (``cli/train_audio.py``,
   ``train_au_patch.py``, ``train_au_face.py``), which run no kernel of the
   port's own but K1 where the trained audio bundle is served: (a) one SGD
   step of each at full width (small inputs, dropout off) on the card and
   on the CPU from the same weights, fp64 and fp32 (TF32 off), each with the
   ``torch.var`` BN control that must fail; (b) each CLI's step at its
   defaults (bf16; au_patch 2 x 60 x 17 patches, au_face 2 x 75 faces and
   their patches, all at 128^2, a micro-step and an optimizer step of 4;
   audio 8 x 120 MFCC images of 64^2 with the frozen live-BN backbone, and
   the head-only step on cached features): ms a step, images/s, the share
   of 989 TFLOP/s, peak memory, idle share and a profile; (c) 25 Adam steps
   on one batch each, whose loss must fall, and the lr = 0 control; (d) each
   CLI trains a synthetic tree for 2 epochs on the card, and its best
   bundle is served (``AudioScorer``, bf16 on K1, counted;
   ``AUPatchScorer``, ``AUFaceScorer``) and held against the bundle's model
   in fp32 eval on the same inputs;
10. serving deployment: the visual bundle's scoring program (T = 8,
   symbolic batch, bf16) exported by ``cli/export_serving.py`` on the fp
   path and from the live scorer on every other kernel path (``w8a8-pallas``,
   ``fuse_entry`` + ``fuse_exit``, ``entry_pair`` + ``middle_taps bf16``;
   ``w8a8-hybrid`` and ``w8a8`` at a static batch of 32; the int8 ones
   calibrated on the CLI's first batch), and the audio bundle's at 16,000
   samples: each graph must hold as
   many ``torch.ops.mdfd`` nodes as its live call launches kernels, and each
   program, replayed through ``ArtifactScorer`` at B = 32 (64 clips for
   audio), is counted and held against its live scorer (bit-equal expected);
   the fp program also through ``cli/serve.py --artifact`` over phase 4's
   clips (counted) and through ``cli/serve_daemon.py --artifact`` (max_batch
   16, max_wait 5 ms, warm-up 8 x 256^2): 64 single-clip npz requests from
   16 threads over HTTP to 127.0.0.1, each score held against the clip scored
   alone (with the rotated-pairing control), requests/s and p50/p99; then ms
   per ``score()`` of the program against the live scorer, in turns;
11. evaluation (``cli/test_visual.py``, ``test_audio.py``,
   ``test_av_fused.py``, ``test_au_patch.py``, ``test_au_face.py``), which
   launch no kernel (the JAX test CLIs run the unfolded eval-BN models on
   XLA convs): phase 4's visual bundle, phase 6's audio bundle and phase
   7's AU bundles, over seeded npy trees (8 face clips of 224^2 in lengths
   across the buckets 25/50/75, 8 MFCC clips of 50-120 steps of the same
   stems, 6 AU-patch stacks and 6 face + AU pairs of 5-16 steps, 17 AUs,
   128^2); each CLI at its defaults on the card in bf16 and fp32, counted
   (0 launches of every kernel), its report printed; bf16 against fp32
   scores; the scoring loop timed (clips/s, bundle load excluded, peak
   memory) beside the forward alone on one batch on the card, and the
   unfolded visual forward against the serving engine's BN-folded plain
   path; the card's fp32 scores against the CPU's at a frame cut (the CPU
   at the defaults would score 600 frames of 224^2 a CLI); the saliency
   maps of test_visual, test_au_patch and test_au_face through
   ``input_saliency`` (peak memory of one default batch; the card's bf16
   and fp32 maps at the cut against the CPU's, each with a control, the
   next clip's maps); the CLIs' ``--saliency_dir`` and ``--tsne`` only
   where matplotlib and scikit-learn are installed. Beside the fp32 saliency
   reading, the diagnostics of ROADMAP Queue 3 F5: 1 - p on both sides, the
   maps of the score before its sigmoid, cuDNN deterministic and cuDNN off
   in the backward, both sides against the CPU's fp64 maps, and for the AU
   CLIs the ReLU gates and stem max-pool argmaxes the two forwards set
   differently, with the maps of the images where all agree held at 1e-4;
12. ingestion (``data/native_video.py``, ``native_loader.py`` and
   ``native_build.py`` over ``native/*.cc``, ``video_enhanced.py``,
   ``preprocess.py``, ``cli/preprocess_*.py``, ``cli/import_torch.py``), no
   TPU kernel on the host code: g++, the libjpeg and libav headers, cv2,
   ffmpeg and each native library's build and ``ldd``; 8 seeded mp4 clips
   of 20-75 frames at 640x360 and an MJPEG avi (H.264 and MJPEG by the libav
   engine where it built, else MPEG-4 part 2 and MJPEG by cv2), each decode
   engine's frames/s to 256^2, then the clips through ``cli/serve.py
   --engine visual --frame_size 256 --max_frames 75`` on phase 4's bundle
   (K1 counted, 8 per backbone call; the clips each engine served asserted:
   none on cv2 where a native engine handles the file) against the same
   decoded frames as ``.npy`` (<= 1e-6), and the scoring loop's clips/s on
   both; ``train_visual --mode lavdf_raw`` for 2 epochs over a LAV-DF
   metadata.json of the clips at 224^2 (``--num_workers 2``), its bundle
   served (K1 counted), ``test_visual --mode lavdf_raw`` on the test split;
   the C++ collate's batches bit-equal to the Python loader's on phase 9's
   audio tree, batches/s of both, ``train_audio --native_loader true``
   against ``false`` (fp32 epoch losses within 1e-5); ``preprocess_audio``
   on the card against the CPU (MFCC bar), ``preprocess_faces`` where cv2
   imports; ``import_torch`` on phase 4's bundle written as a reference
   ``.pth``: the bundle equal to the original array for array, served to
   the original's scores (K1 counted), its fp32 scores card against CPU
   within 1e-4. What the host lacks is named, and what it stops is skipped
   with a line, not failed.

The line before the last is the card's ``name, power.limit``; the one before
that the ``{"kernels": [...]}`` record (each kernel's ``audio`` entry holds
the same readings at the audio path's shapes, its ``artifact`` entry the
launches per backbone call of the exported program that runs it); the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

BF16_TOL = 1.6e-2  # two bf16 ulps at unit scale
MEAN_TOL = 1e-3
BIT_EQUAL_MIN = 0.999  # int8 kernels: the integer path is exact, 1.0 expected
FEATURE_COS_MIN = 0.999  # fp kernel path against the plain fp32 path
SCORE_TOL = 2e-2
# w8a8 bars (min per-frame feature cos, max score |d|), each between the
# largest sound reading on an H100 and the reading of its control (PERF.md,
# "w8a8 on the card"). Kernel path against the plain path on the same tree:
# sound 1 - cos <= 2.8e-7 and |d| <= 2.9e-4 (the hybrid's bf16 K1; the int8
# modes are bit-exact), the bf16-fold control 1 - cos >= 4.7e-6.
QUANT_KERNEL_BARS = (1 - 2e-6, 5e-4)
# against the plain fp32 path: sound 1 - cos <= 1.47e-6 and |d| <= 1.46e-3,
# the clipping-calibration control 1 - cos >= 3.3e-5 and |d| >= 2.1e-3
QUANT_FP32_BARS = (1 - 1e-5, 2e-3)
# The audio path's w8a8 bars, on the same footing (PERF.md §2): MFCC images
# are in dB-scaled units in the hundreds, and they set the activation scales.
# Against the plain path on the same tree: sound 1 - cos <= 8.4e-6 (the
# hybrid's bf16 K1; the int8 modes bit-exact), against plain fp32: sound
# 1 - cos <= 6.8e-5 and score |d| <= 1.6e-5 (the random head gives every
# clip nearly one score); the clipping calibration's control 1 - cos >= 2.1e-2
# against either (NVIDIA H100 80GB HBM3, 700 W)
AUDIO_QUANT_KERNEL_BARS = (1 - 5e-5, 5e-4)
AUDIO_QUANT_FP32_BARS = (1 - 1e-3, 2e-3)
PEAK_BF16 = 989e12  # H100 SXM, dense, FLOP/s
PEAK_INT8 = 1979e12  # OP/s
PEAK_BYTES = 3.35e12  # B/s
K1_SHAPES = (  # (N, H=W, C, dtype name, row length of the packed pointwise weight)
    (256, 16, 728, "bfloat16", 736),
    (15, 4, 728, "bfloat16", 736),
    (15, 4, 728, "bfloat16", 728),
    (3, 2, 728, "bfloat16", 736),
    (1, 1, 728, "bfloat16", 736),
    (15, 4, 728, "float32", 736),
    (4, 8, 40, "bfloat16", 64),
    # the persistent GEMM: a ragged last M tile over many waves, with 1,456-byte
    # rows in every tensor map too
    (257, 16, 728, "bfloat16", 736),
    (257, 16, 728, "bfloat16", 728),
)
# K1's bit-equal share against its plain version at 256 frames (seed 0),
# per tap order, which the persistent GEMM must not lower: the one-tile GEMM
# with a register epilogue read 0.986964 and 0.987722 on the same operands
# (NVIDIA H100 80GB HBM3, 700 W; ``chip_variants.py --against`` finds the
# two designs' outputs identical); the floors sit one millionth below for
# the printed rounding
K1_BIT_EQUAL_256 = {"fp32": 0.986963, "bf16": 0.987721}
K2_SHAPES = (  # (N, H=W, C, dtype name); pw_q rows padded to 64 bytes
    (256, 16, 728, "bfloat16"),
    (15, 4, 728, "bfloat16"),
    (3, 2, 728, "bfloat16"),
    (1, 1, 728, "bfloat16"),
    (15, 4, 728, "float32"),
    (4, 8, 40, "bfloat16"),
    (257, 16, 728, "bfloat16"),  # the persistent GEMM: a ragged last M tile over many waves
)
DW_SHAPES = (  # (N, H=W, C): the 10 int8 depthwise sites of 256 frames at 256^2, and a 1x1
    (256, 125, 64), (256, 125, 128),  # block 1
    (256, 63, 128), (256, 63, 256),  # block 2
    (256, 32, 256), (256, 32, 728),  # block 3
    (256, 16, 728), (256, 16, 728),  # block 12
    (256, 8, 1024), (256, 8, 1536),  # conv3, conv4
    (15, 1, 1536),  # the exit flow of a 32^2 input
)
# N = 1 at widths the first design's staged band refused: (H, W, C); the
# int8 depthwise's at W > 1024, the others' at W > 512 (256 for K4's fp32 mid)
WIDE_DW = (3, 2100, 128)
WIDE = (3, 1100, 64)
# K3: (N, H, W, Cin, Cmid, Cout, leading ReLU, dtype name). First the four
# stride-2 blocks of 256 frames at 256^2 (blocks 1, 2, 3, 12); then odd N at
# the 64^2 blocks, 1x1, 2x2 and 3x3 images, a non-square one with C = 40
# (rows padded 40 -> 64), and fp32 I/O. Packed rows hold NaN past Cin / Cmid.
K3_BLOCKS = (
    (256, 125, 125, 64, 128, 128, False, "bfloat16"),
    (256, 63, 63, 128, 256, 256, True, "bfloat16"),
    (256, 32, 32, 256, 728, 728, True, "bfloat16"),
    (256, 16, 16, 728, 728, 1024, True, "bfloat16"),
)
K3_SHAPES = K3_BLOCKS + (
    (15, 29, 29, 64, 128, 128, False, "bfloat16"),
    (15, 15, 15, 128, 256, 256, True, "bfloat16"),
    (15, 8, 8, 256, 728, 728, True, "bfloat16"),
    (15, 4, 4, 728, 728, 1024, True, "bfloat16"),
    (3, 1, 1, 728, 728, 1024, True, "bfloat16"),
    (3, 2, 2, 728, 728, 1024, True, "bfloat16"),
    (3, 3, 3, 256, 728, 728, True, "bfloat16"),
    (4, 13, 21, 40, 16, 24, False, "bfloat16"),
    (5, 15, 15, 128, 256, 256, True, "float32"),
    (1, 3, 1101, 64, 128, 128, False, "bfloat16"),
)
# K4: the pairs of the four stride-2 blocks of 256 frames at 256^2 (K3's
# blocks), then K3's edge shapes with a 3x3 one, each with the switches of
# every JAX entry point (col_sums, mid_fp32): entry_pair_pallas and stream2
# with dx_roll (True, False), the stream kernel (False, True), stream2
# without dx_roll (False, False).
K4_SHAPES = K3_BLOCKS + (
    (15, 29, 29, 64, 128, 128, False, "bfloat16"),
    (3, 1, 1, 728, 728, 1024, True, "bfloat16"),
    (3, 2, 2, 728, 728, 1024, True, "bfloat16"),
    (5, 3, 3, 256, 728, 728, True, "bfloat16"),
    (4, 13, 21, 40, 16, 24, False, "bfloat16"),
    (5, 15, 15, 128, 256, 256, True, "float32"),
    (1, 3, 1100, 64, 128, 128, False, "bfloat16"),
    (1, 2, 700, 64, 40, 24, True, "float32"),
)
K4_SWITCHES = ((True, False), (False, True), (False, False))
# K5: (N, H=W, Cin, Cout, leading ReLU, trailing ReLU, dtype name). conv3 and
# conv4 of 256 frames at 256^2 (the route's switches), then the exit of 32^2
# and 64^2 inputs, every ReLU combination at C = 40 (rows padded to 64), and
# fp32 I/O.
K5_CONVS = (
    (256, 8, 1024, 1536, False, True, "bfloat16"),
    (256, 8, 1536, 2048, False, True, "bfloat16"),
)
K5_SHAPES = K5_CONVS + (
    (15, 1, 1536, 2048, False, True, "bfloat16"),
    (15, 2, 1024, 1536, False, True, "bfloat16"),
    (4, 9, 40, 16, False, False, "bfloat16"),
    (4, 9, 40, 16, True, False, "bfloat16"),
    (4, 9, 40, 16, True, True, "bfloat16"),
    (3, 2, 1024, 1536, False, True, "float32"),
    (7, 8, 1024, 1536, False, True, "bfloat16"),  # M = 448: a ragged last M tile
)
CLIP_LENGTHS = (8, 5, 3, 8, 5)  # odd count, odd lengths; batch_size 4 -> 2 backbone calls
BATCH_SIZE = 4
SOURCES_BUILT = ("middle_block", "middle_block_w8", "dw_w8a8", "entry_block", "entry_pair",
                 "sepconv_unit")
KERNELS = ("middle_block", "middle_block_bf16taps", "middle_block_w8", "dw_w8a8", "entry_block",
           "entry_pair", "sepconv_unit")
ROUTES = {  # VisualScorer keyword, CLI flags, launches per backbone call, the stage it ends
    "middle_taps": ({"middle_taps": "bf16"}, ["--middle_taps", "bf16"], dict(k1b=8), "block11"),
    "entry_pair": ({"entry_pair": True}, ["--entry_pair", "true"], dict(k1=8, k4=4), "block12"),
    "fuse_exit": ({"fuse_exit": True}, ["--fuse_exit", "true"], dict(k1=8, k5=2), "exit"),
}
# The audio path (phases 3, 5 and 6): 64 one-second clips are 64 x 101 MFCC
# images of 64^2; the kernels at its shapes (N = 6,464): the 4 x 4 middle
# trunk (K1, K2), the stride-2 blocks at 29^2, 15^2, 8^2 and 4^2 (K3, K4),
# the 2 x 2 exit (K5), and block 1's second depthwise at 29^2 (the int8
# depthwise's largest audio site).
AUDIO_N = 64 * 101
AUDIO_K3_BLOCKS = (
    (AUDIO_N, 29, 29, 64, 128, 128, False, "bfloat16"),
    (AUDIO_N, 15, 15, 128, 256, 256, True, "bfloat16"),
    (AUDIO_N, 8, 8, 256, 728, 728, True, "bfloat16"),
    (AUDIO_N, 4, 4, 728, 728, 1024, True, "bfloat16"),
)
AUDIO_K5_CONVS = (
    (AUDIO_N, 2, 1024, 1536, False, True, "bfloat16"),
    (AUDIO_N, 2, 1536, 2048, False, True, "bfloat16"),
)
AUDIO_DW = (AUDIO_N, 29, 128)
SR, HOP = 16000, 160
# the waveforms scored through the CLI: 0.5, 1.0 and 2.3 s, batch_size 2 ->
# 2 backbone calls (the sample buckets 16,000 and 48,000)
WAVE_SAMPLES = (8000, 16000, 36800)
AUDIO_BATCH = 2
MFCC_TOL = 2e-3  # max |d| of the MFCC on the card against the CPU's
AV_ALPHA = 0.3
# A random model's features wash out faults in the middle of the network
# (PERF.md §6), so each route is also held at the output of its last kernel's
# stage (``upto=``), per frame, against the plain fp32 path: 1 - cos <= 1e-3.
# CPU rehearsal at fp32 (plain versions): sound <= 1.9e-8; the controls'
# wrong operands 6.3e-3 (middle taps) and 7.4e-3 (pair), and conv4's bias
# dropped fails the feature bars too (1 - cos 0.65).
STAGE_COS_MIN = 1 - 1e-3
# The audio stage bar: MFCC images carry a large common component, so a
# route's stage output moves less under a fault. On the card: sound 1 - cos
# <= 4.6e-5; the controls 8.2e-4 (pair's pw1 x4), 0.59 (conv4's bias
# dropped), and for the middle flow, whose last-rep taps x4 read 4.9e-5, the
# last rep's bias x4 (a CPU rehearsal: 2.8e-3)
AUDIO_STAGE_COS_MIN = 1 - 2e-4


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    conv = getattr(torch.backends.cudnn, "conv", None)
    say(f"torch defaults: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cudnn.conv.fp32_precision={getattr(conv, 'fp32_precision', 'n/a')} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


class NoTF32:
    """TF32 off for the ``with`` block (the plain versions' fp32 matmuls
    exact on bf16 operands), torch's flags restored after."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        b = self.torch.backends
        self.before = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.before


def phase_build():
    from multimodal_deepfake_detection_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build(*SOURCES_BUILT)
    for name in SOURCES_BUILT:
        _build.load_library(name)
    say(f"build: {', '.join(n + '.cu' for n in SOURCES_BUILT)} ready in "
        f"{time.perf_counter() - t0:.2f} s ({_build.BUILD_DIR.name}/, nvcc "
        f"{' '.join(_build.NVCC_FLAGS[:2])})")


def compare(torch, label, got, ref, *, int8=False, equal_min=0.0) -> float:
    """Bounds: finite; for the int8 kernels >= 99.9 % bit-equal; the rest
    within two bf16 ulps (relative and absolute); mean |d| <= 1e-3; at
    least ``equal_min`` of the outputs bit-equal."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    max_d, mean_d = d.max().item(), d.mean().item()
    equal = (got == ref).float().mean().item()
    bound_ok = bool((d <= BF16_TOL + BF16_TOL * ref.abs()).all().item())
    say(f"{label}: max|d|={max_d:.3e} mean|d|={mean_d:.3e} bit-equal={equal:.6f}")
    if not (bound_ok and mean_d <= MEAN_TOL and torch.isfinite(got).all()
            and (equal >= BIT_EQUAL_MIN or not int8) and equal >= equal_min):
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    return max_d


def k1_operands(torch, N, H, C, dtype, ldk, seed, W=None):
    """Random K1 operands on (N, H, W or H, C); the pointwise rows' padding
    past C holds NaN, which the kernel must never read."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, H, W or H, C), generator=g).to("cuda", getattr(torch, dtype))
    dw = (torch.randn((3, 9, C), generator=g) * 0.2).cuda()
    pw = torch.full((3, C, ldk), float("nan"))
    pw[..., :C] = torch.randn((3, C, C), generator=g) / C ** 0.5
    b = (torch.randn((3, C), generator=g) * 0.1).cuda()
    return x, dw, pw.to("cuda", torch.bfloat16), b


def k2_operands(torch, N, H, C, dtype, seed, W=None):
    """Random K2 operands with per-channel ``s_in`` (the act_scales="channel"
    form); the int8 pointwise rows' padding past C holds garbage, which the
    kernel must never read."""
    g = torch.Generator().manual_seed(seed)
    reps, ldk = 3, -(-C // 64) * 64
    x = torch.randn((N, H, W or H, C), generator=g).to("cuda", getattr(torch, dtype))
    dw = torch.randn((reps, 9, C), generator=g) * 0.2
    pw = torch.randn((reps, C, C), generator=g) / C ** 0.5
    s_w = pw.abs().amax(dim=2) / 127.0
    pw_q = torch.randint(-128, 128, (reps, C, ldk), generator=g, dtype=torch.int8)
    pw_q[..., :C] = torch.clamp(torch.round(pw / s_w[..., None]), -127, 127).to(torch.int8)
    s_dq = torch.full((reps,), 2.5 / 127.0)
    s_in = s_dq[:, None] * (0.5 + 1.5 * torch.rand((reps, C), generator=g))
    b = torch.randn((reps, C), generator=g) * 0.1
    return (x,) + tuple(t.cuda().contiguous() for t in (dw, pw_q, s_w, s_in, s_dq, b))


def dw_operands(torch, N, H, C, dtype, seed, W=None):
    """Random int8 depthwise operands: per-channel ``s_in``, ``sc = s_dq * s_w``."""
    g = torch.Generator().manual_seed(seed)
    gx = torch.Generator("cuda").manual_seed(seed)  # the largest inputs are made on the card
    x = torch.randn((N, H, W or H, C), generator=gx, device="cuda").to(getattr(torch, dtype))
    w_q = torch.randint(-127, 128, (C, 1, 3, 3), generator=g, dtype=torch.int8)
    s_in = (2.5 / 127.0) * (0.5 + 1.5 * torch.rand(C, generator=g))
    sc = 1e-3 * (0.5 + torch.rand(C, generator=g))
    return x, w_q.cuda(), s_in.cuda(), sc.cuda()


def k3_operands(torch, N, H, W, Cin, Cmid, Cout, dtype, seed):
    """Random K3 operands, the packed rows padded to 32 elements with NaN,
    which the kernel must never read."""
    g = torch.Generator().manual_seed(seed)

    def rows(out, k):
        w = torch.full((out, -(-k // 32) * 32), float("nan"))
        w[:, :k] = torch.randn((out, k), generator=g) / k ** 0.5
        return w.to("cuda", torch.bfloat16)

    vec = lambda *shape, s: (torch.randn(shape, generator=g) * s).cuda()
    gx = torch.Generator("cuda").manual_seed(seed)  # the largest inputs are made on the card
    x = torch.randn((N, H, W, Cin), generator=gx, device="cuda").to(getattr(torch, dtype))
    return (x, vec(9, Cin, s=0.3), rows(Cmid, Cin), vec(Cmid, s=0.1), vec(9, Cmid, s=0.3),
            rows(Cout, Cmid), vec(Cout, s=0.1), rows(Cout, Cin), vec(Cout, s=0.1))


def k5_operands(torch, N, H, Cin, Cout, dtype, seed, W=None):
    """Random K5 operands, the packed rows padded to 32 elements with NaN."""
    g = torch.Generator().manual_seed(seed)
    w = torch.full((Cout, -(-Cin // 32) * 32), float("nan"))
    w[:, :Cin] = torch.randn((Cout, Cin), generator=g) / Cin ** 0.5
    gx = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((N, H, W or H, Cin), generator=gx, device="cuda").to(getattr(torch, dtype))
    return (x, (torch.randn((9, Cin), generator=g) * 0.3).cuda(), w.to("cuda", torch.bfloat16),
            (torch.randn(Cout, generator=g) * 0.1).cuda())


def phase_kernels(torch) -> dict:
    """Every kernel against its plain version; returns the worst max |d| of each."""
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.dw_w8a8 import dw_w8a8, dw_w8a8_ref
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_block import (
        entry_block,
        entry_block_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import (
        middle_block,
        middle_block_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_pair import (
        entry_pair,
        entry_pair_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block_w8 import (
        middle_block_w8,
        middle_block_w8_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.sepconv_unit import (
        sepconv_unit,
        sepconv_unit_ref,
    )

    worst = dict.fromkeys(KERNELS, 0.0)
    for i, (N, H, C, dtype, ldk) in enumerate(K1_SHAPES):
        ops = k1_operands(torch, N, H, C, dtype, ldk, seed=i)
        for taps, name in (("fp32", "middle_block"), ("bf16", "middle_block_bf16taps")):
            got = middle_block(*ops, taps=taps)
            torch.cuda.synchronize()
            worst[name] = max(worst[name], compare(
                torch, f"K1 {taps} taps ({N},{H},{H},{C}) {dtype} ldk={ldk}", got,
                middle_block_ref(*ops, taps=taps),
                equal_min=K1_BIT_EQUAL_256[taps] if N == 256 else 0.0))
    for i, (N, H, C, dtype) in enumerate(K2_SHAPES):
        ops = k2_operands(torch, N, H, C, dtype, seed=100 + i)
        got = middle_block_w8(*ops)
        torch.cuda.synchronize()
        worst["middle_block_w8"] = max(worst["middle_block_w8"], compare(
            torch, f"K2 ({N},{H},{H},{C}) {dtype}", got, middle_block_w8_ref(*ops), int8=True,
            equal_min=1.0))
    for i, (N, H, C) in enumerate(DW_SHAPES):
        dtype = "float32" if i == len(DW_SHAPES) - 1 else "bfloat16"
        ops = dw_operands(torch, N, H, C, dtype, seed=200 + i)
        out_dtype = getattr(torch, dtype)
        got = dw_w8a8(*ops, out_dtype)
        torch.cuda.synchronize()
        worst["dw_w8a8"] = max(worst["dw_w8a8"], compare(
            torch, f"dw_w8a8 ({N},{H},{H},{C}) {dtype}", got, dw_w8a8_ref(*ops, out_dtype),
            int8=True))
    # the scalar s_in of act_scales="tensor" trees
    x, w_q, s_in, sc = dw_operands(torch, 15, 4, 1536, "bfloat16", seed=300)
    s_in = s_in[:1].reshape(())
    worst["dw_w8a8"] = max(worst["dw_w8a8"], compare(
        torch, "dw_w8a8 (15,4,4,1536) bfloat16, scalar s_in", dw_w8a8(x, w_q, s_in, sc, x.dtype),
        dw_w8a8_ref(x, w_q, s_in, sc, x.dtype), int8=True))
    for i, (N, H, W, Cin, Cmid, Cout, lead, dtype) in enumerate(K3_SHAPES):
        ops = k3_operands(torch, N, H, W, Cin, Cmid, Cout, dtype, seed=400 + i)
        got = entry_block(*ops, leading_relu0=lead)
        torch.cuda.synchronize()
        worst["entry_block"] = max(worst["entry_block"], compare(
            torch, f"K3 ({N},{H},{W},{Cin}) {Cin}->{Cmid}->{Cout} {dtype} relu={lead}", got,
            entry_block_ref(*ops, leading_relu0=lead)))
        del ops, got
    for i, (N, H, W, Cin, Cmid, Cout, lead, dtype) in enumerate(K4_SHAPES):
        ops = k3_operands(torch, N, H, W, Cin, Cmid, Cout, dtype, seed=600 + i)[:7]
        for col_sums, mid_fp32 in K4_SWITCHES:
            kw = dict(leading_relu0=lead, col_sums=col_sums, mid_fp32=mid_fp32)
            got = entry_pair(*ops, **kw)
            torch.cuda.synchronize()
            worst["entry_pair"] = max(worst["entry_pair"], compare(
                torch, f"K4 ({N},{H},{W},{Cin}) {Cin}->{Cmid}->{Cout} {dtype} relu={lead} "
                f"col_sums={col_sums} mid_fp32={mid_fp32}", got, entry_pair_ref(*ops, **kw)))
            del got
        del ops
    for i, (N, H, Cin, Cout, lead, trail, dtype) in enumerate(K5_SHAPES):
        ops = k5_operands(torch, N, H, Cin, Cout, dtype, seed=700 + i)
        kw = dict(leading_relu=lead, trailing_relu=trail)
        got = sepconv_unit(*ops, **kw)
        torch.cuda.synchronize()
        worst["sepconv_unit"] = max(worst["sepconv_unit"], compare(
            torch, f"K5 ({N},{H},{H},{Cin})->{Cout} {dtype} relu in/out={lead}/{trail}", got,
            sepconv_unit_ref(*ops, **kw)))
    # the widths the first design refused, N = 1 (K3 and K4: in their shape lists)
    H, W, C = WIDE
    ops = k1_operands(torch, 1, H, C, "bfloat16", C, seed=750, W=W)
    for taps, name in (("fp32", "middle_block"), ("bf16", "middle_block_bf16taps")):
        worst[name] = max(worst[name], compare(
            torch, f"K1 {taps} taps (1,{H},{W},{C}) bfloat16", middle_block(*ops, taps=taps),
            middle_block_ref(*ops, taps=taps)))
    ops = k2_operands(torch, 1, H, C, "bfloat16", seed=751, W=W)
    worst["middle_block_w8"] = max(worst["middle_block_w8"], compare(
        torch, f"K2 (1,{H},{W},{C}) bfloat16", middle_block_w8(*ops), middle_block_w8_ref(*ops),
        int8=True, equal_min=1.0))
    ops = k5_operands(torch, 1, H, C, 48, "bfloat16", seed=752, W=W)
    kw = dict(leading_relu=True, trailing_relu=True)
    worst["sepconv_unit"] = max(worst["sepconv_unit"], compare(
        torch, f"K5 (1,{H},{W},{C})->48 bfloat16", sepconv_unit(*ops, **kw),
        sepconv_unit_ref(*ops, **kw)))
    H, W, C = WIDE_DW
    ops = dw_operands(torch, 1, H, C, "bfloat16", seed=753, W=W)
    worst["dw_w8a8"] = max(worst["dw_w8a8"], compare(
        torch, f"dw_w8a8 (1,{H},{W},{C}) bfloat16", dw_w8a8(*ops, torch.bfloat16),
        dw_w8a8_ref(*ops, torch.bfloat16), int8=True))
    torch.cuda.synchronize()
    # device launches per call of the redesigned K4 and K3
    for i, (N, H, W, Cin, Cmid, Cout, lead, dtype) in enumerate(K3_BLOCKS):
        ops = k3_operands(torch, N, H, W, Cin, Cmid, Cout, dtype, seed=760 + i)
        n4 = graph_kernels(torch, lambda: entry_pair(*ops[:7], leading_relu0=lead))
        n3 = graph_kernels(torch, lambda: entry_block(*ops, leading_relu0=lead))
        say(f"device launches at ({N},{H},{W},{Cin}) {Cin}->{Cmid}->{Cout}: K4 pair {n4}, "
            f"K3 block {n3}")
        if (n4, n3) != (2, 4):
            raise AssertionError(f"K4 launched {n4} kernels (2 expected), K3 {n3} (4 expected)")
        del ops
    return worst


PROFILED_CALLS = 4


def device_kernels(torch, fn, attempts: int = 3) -> dict:
    """``{kernel name: (device us summed, launches)}`` of ``PROFILED_CALLS``
    calls of ``fn()`` in one ``torch.profiler`` window, after a warm-up
    call. On the card the profiler loses kernel records at random (it never
    adds any; one in a short window often enough that every attempt of a
    two-kernel call missed one): of ``attempts`` windows the one that saw the
    most launches is kept, and a count per call is its launches over
    ``PROFILED_CALLS``, rounded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_CALLS):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
        if sum(n for _, n in seen.values()) > sum(n for _, n in best.values()):
            best = seen
    return best


def graph_kernels(torch, fn) -> int:
    """The kernels one ``fn()`` launches: the kernel nodes of a CUDA graph
    captured around it. ``torch.profiler`` on the card drops kernel records
    (in some runs every window lost one kernel's launches); a capture keeps
    every launch made on the stream."""
    import ctypes

    fn()  # builds, and allocates outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)

    def check(err):
        if err:
            raise RuntimeError(f"CUDA driver error {err} reading a captured graph")

    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    kernels, kind = 0, ctypes.c_int()
    for node in nodes:
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels


def write_bundle(torch, path: str, hidden_dim: int = 128, seed: int = 0,
                 arcface: bool = True) -> None:
    """Seeded full-width XceptionLSTMV + ArcFace (``arcface=False``: an
    XceptionLSTMA, whose MLP head serves without ArcFace), random BN
    statistics, JAX format."""
    from multimodal_deepfake_detection_tpu_torch.core.checkpoint import save_bundle
    from multimodal_deepfake_detection_tpu_torch.models.heads import ArcFace, XceptionLSTM
    from multimodal_deepfake_detection_tpu_torch.ops.conv import BatchNorm
    from multimodal_deepfake_detection_tpu_torch.utils.jax_weights import (
        arcface_to_jax,
        xception_lstm_to_jax,
    )

    g = torch.Generator().manual_seed(seed)
    model = XceptionLSTM(hidden_dim, generator=g)
    with torch.no_grad():
        for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
            n = bn.mean.shape[0]
            bn.scale.copy_(0.8 + 0.4 * torch.rand(n, generator=g))
            bn.bias.copy_(0.05 * torch.randn(n, generator=g))
            bn.mean.copy_(0.1 * torch.randn(n, generator=g))
            bn.var.copy_(0.5 + torch.rand(n, generator=g))
    params, state = xception_lstm_to_jax(model)
    trees = {"model": params, "state": state}
    if arcface:
        trees["arcface"] = arcface_to_jax(ArcFace(hidden_dim, 2, generator=g))
    save_bundle(path, trees)


def counters():
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.dw_w8a8 import dw_w8a8
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_block import entry_block
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_pair import entry_pair
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import (
        middle_block,
        middle_block_bf16taps,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block_w8 import (
        middle_block_w8,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.sepconv_unit import sepconv_unit

    return {"middle_block": middle_block, "middle_block_bf16taps": middle_block_bf16taps,
            "middle_block_w8": middle_block_w8, "dw_w8a8": dw_w8a8, "entry_block": entry_block,
            "entry_pair": entry_pair, "sepconv_unit": sepconv_unit}


def counted(torch, label, run, expected: dict):
    """``run()`` with every launch counter set to 0 just before and read just
    after; fails unless the counts are ``expected``. Returns ``run()``'s value."""
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in fns.items()}
    say(f"{label}: launches {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{label}: launch counts {counts}, expected {expected}")
    return out


def per_call(calls: int, k1=0, k1b=0, k2=0, dw=0, k3=0, k4=0, k5=0) -> dict:
    return {"middle_block": k1 * calls, "middle_block_bf16taps": k1b * calls,
            "middle_block_w8": k2 * calls, "dw_w8a8": dw * calls, "entry_block": k3 * calls,
            "entry_pair": k4 * calls, "sepconv_unit": k5 * calls}


def visual_argv(bundle: str, clip_dir: str) -> list:
    return ["--engine", "visual", "--ckpt_path", bundle, "--input", clip_dir,
            "--batch_size", str(BATCH_SIZE)]


def run_cli(torch, workdir, argv, label, flags, expected, n_inputs: int = len(CLIP_LENGTHS)):
    """Score through the port's CLI (``argv``: engine, bundle, inputs) with
    the extra ``flags``, bf16 on CUDA, counting launches; checks the JSONL;
    returns the scores."""
    from multimodal_deepfake_detection_tpu_torch.cli import serve as cli_serve

    out = os.path.join(workdir, f"scores_{label.replace(' ', '_')}.jsonl")
    argv = argv + ["--output", out, "--compute_dtype", "bfloat16", "--device", "cuda"] + flags
    emitted = counted(torch, label, lambda: cli_serve.main(argv, log=say), expected)
    recs = [json.loads(line) for line in open(out)]
    scores = np.array([r["score"] for r in recs], np.float64)
    if len(recs) != n_inputs or not (np.isfinite(scores).all() and (0 <= scores).all()
                                     and (scores <= 1).all()):
        raise AssertionError(f"bad JSONL output ({emitted} inputs): {recs}")
    return scores


def outputs(torch, scorer, batches):
    """``scorer``'s scores and its per-frame features (fp64, valid frames only)."""
    scores, feats = [], []
    for batch, lengths in batches:
        scores.append(scorer.score(batch, lengths))
        f = scorer.frame_features(batch).double()
        feats += [f[j, :n] for j, n in enumerate(lengths)]
    return np.concatenate(scores), torch.cat(feats)


def held(torch, label, a, b, bars, *, control: bool = False) -> None:
    """Min per-frame feature cosine and max score |d| of ``outputs`` ``a``
    and ``b`` against ``bars = (cos_min, score_tol)``. A control is a wrong
    tree or operand put in the program's place: it must fail the bars."""
    cos = torch.nn.functional.cosine_similarity(a[1], b[1], dim=-1).min().item()
    score_d = float(np.abs(a[0] - b[0]).max())
    ok = cos >= bars[0] and score_d <= bars[1]
    verdict = ("; control: fails, as it must" if not ok else "; control: PASSES") if control else ""
    say(f"{label}: per-frame feature 1 - cos max {1 - cos:.3e} (<= {1 - bars[0]:.1e}), "
        f"score max|d| {score_d:.3e} (<= {bars[1]:.1e}); scores "
        f"{np.round(a[0], 4).tolist()}{verdict}")
    if ok == control:
        raise AssertionError(f"{label}: " + ("the control passes the bars" if control
                                             else "disagreement"))


def visual_inputs(torch, workdir: str):
    """The seeded visual bundle and phase 4's clips (``CLIP_LENGTHS`` at
    256^2, saved as ``.npy``), written once: ``(bundle, clip_dir, clips)``."""
    bundle = os.path.join(workdir, "visual.npz")
    clip_dir = os.path.join(workdir, "clips")
    if not os.path.exists(bundle):
        write_bundle(torch, bundle)
        os.makedirs(clip_dir)
    rng = np.random.default_rng(0)
    clips = []
    for i, t in enumerate(CLIP_LENGTHS):
        clip = rng.integers(0, 256, (t, 256, 256, 3), dtype=np.uint8)
        path = os.path.join(clip_dir, f"clip{i}.npy")
        if not os.path.exists(path):
            np.save(path, clip)
        clips.append(clip)
    return bundle, clip_dir, clips


def phase_slice(torch, workdir: str) -> dict:
    from multimodal_deepfake_detection_tpu_torch.cli.serve import _pad_stack
    from multimodal_deepfake_detection_tpu_torch.models.fold import fold_xception_bn
    from multimodal_deepfake_detection_tpu_torch.models.quant import (
        QuantizedXception,
        calibrate_amax,
        quantize_folded_xception,
    )
    from multimodal_deepfake_detection_tpu_torch.models.serve import (
        VisualScorer,
        load_visual_bundle,
    )

    bundle, clip_dir, clips = visual_inputs(torch, workdir)
    calls = -(-len(clips) // BATCH_SIZE)
    batches = [_pad_stack(clips[i : i + BATCH_SIZE]) for i in range(0, len(clips), BATCH_SIZE)]
    kw = dict(device="cuda", buckets=(25, 50, 75))

    # the main paths: the CLI, fp, --quantize w8a8-pallas and --fuse_entry true
    launches = per_call(calls, k1=8)
    argv = visual_argv(bundle, clip_dir)
    fp_scores = run_cli(torch, workdir, argv, "slice CLI fp", [], launches)
    expected = per_call(calls, k2=8, dw=10)
    q_scores = run_cli(torch, workdir, argv, "slice CLI w8a8-pallas",
                       ["--quantize", "w8a8-pallas"], expected)
    launches.update(middle_block_w8=expected["middle_block_w8"], dw_w8a8=expected["dw_w8a8"])
    expected = per_call(calls, k1=8, k3=4)
    fused_scores = run_cli(torch, workdir, argv, "slice CLI fuse_entry",
                           ["--fuse_entry", "true"], expected)
    launches.update(entry_block=expected["entry_block"])

    # each mode through VisualScorer (score + frame_features: 2 backbone
    # calls per batch), counted, against the plain fp32 path (no kernel) and
    # the plain quantized path on the kernel path's calibrated tree
    check_fp32(torch, bundle, batches[0][0][:1])
    plain32 = VisualScorer.from_bundle(bundle, compute_dtype=torch.float32, use_kernels=False,
                                       **kw)
    ref = outputs(torch, plain32, batches)
    got = counted(torch, "slice fp (VisualScorer)",
                  lambda: outputs(torch, VisualScorer.from_bundle(bundle, **kw), batches),
                  per_call(2 * calls, k1=8))
    held(torch, "slice fp vs plain fp32", got, ref, (FEATURE_COS_MIN, SCORE_TOL))
    if np.abs(got[0] - fp_scores).max() > 1e-4:
        raise AssertionError("the CLI's fp scores differ from VisualScorer's")
    fused = VisualScorer.from_bundle(bundle, fuse_entry=True, **kw)
    got = counted(torch, "slice fuse_entry (VisualScorer)", lambda: outputs(torch, fused, batches),
                  per_call(2 * calls, k1=8, k3=4))
    held(torch, "slice fuse_entry vs plain fp32", got, ref, (FEATURE_COS_MIN, SCORE_TOL))
    if np.abs(got[0] - fused_scores).max() > 1e-4:
        raise AssertionError("the CLI's fuse_entry scores differ from VisualScorer's")
    # control: every K3 block's skip weight 4x too large, as a skip that sums
    # each 2x2 window instead of taking its even pixel gives on smooth input.
    # On a random model the features wash out faults that keep the scale
    # (transposed taps, zeroed biases, permuted channels): PERF.md §6.
    k3_blocks = [b for b in fused.folded_backbone.blocks if b.is_entry]
    sound_skw = [b.k3_skw for b in k3_blocks]
    for b in k3_blocks:
        b.k3_skw = 4 * b.k3_skw
    held(torch, "control fuse_entry, K3 skip weight x4, vs plain fp32",
         outputs(torch, fused, batches), ref, (FEATURE_COS_MIN, SCORE_TOL), control=True)
    for b, skw in zip(k3_blocks, sound_skw):
        b.k3_skw = skw
    launches.update(slice_routes(torch, workdir, bundle, clip_dir, batches, plain32, ref, kw))
    bf16_fold = QuantizedXception.from_folded(
        fold_xception_bn(load_visual_bundle(bundle)[0].backbone, torch.bfloat16)).to("cuda")
    for mode, per_backbone in (("w8a8-pallas", dict(k2=8, dw=10)),
                               ("w8a8-hybrid", dict(k1=8, dw=10)),
                               ("w8a8", dict(dw=34))):
        kern = VisualScorer.from_bundle(bundle, quantize=mode, **kw)
        kern.calibrate(batches[0][0])  # the CLI calibrates on its first batch
        plain = VisualScorer.from_bundle(bundle, quantize=mode, use_kernels=False, **kw)
        plain.qbackbone = sound = kern.qbackbone
        got = counted(torch, f"slice {mode} (VisualScorer)", lambda: outputs(torch, kern, batches),
                      per_call(2 * calls, **per_backbone))
        plain_out = outputs(torch, plain, batches)
        held(torch, f"slice {mode} vs plain {mode}", got, plain_out, QUANT_KERNEL_BARS)
        held(torch, f"slice {mode} vs plain fp32", got, ref, QUANT_FP32_BARS)
        if mode == "w8a8-pallas" and np.abs(got[0] - q_scores).max() > 1e-4:
            raise AssertionError("the CLI's w8a8-pallas scores differ from VisualScorer's")
        # controls on the kernel path: the tree quantized from the bf16 fold
        # (each weight rounded twice), against the plain path on the sound
        # tree; and a calibration that clips (every activation scale halved)
        amaxes = calibrate_amax(kern.fp_tree, kern._frames_to_x(batches[0][0]),
                                compute_dtype=kern.compute_dtype)
        quant = dict(quant_depthwise=True, skip_middle=mode == "w8a8-hybrid")
        kern.qbackbone = quantize_folded_xception(bf16_fold, amaxes, **quant)
        held(torch, f"control {mode}, bf16 fold, vs plain {mode}", outputs(torch, kern, batches),
             plain_out, QUANT_KERNEL_BARS, control=True)
        kern.qbackbone = quantize_folded_xception(kern.fp_tree, amaxes, headroom=0.5, **quant)
        held(torch, f"control {mode}, clipping calibration, vs plain fp32",
             outputs(torch, kern, batches), ref, QUANT_FP32_BARS, control=True)
        kern.qbackbone = sound
    refined_held(torch, "slice", lambda: VisualScorer.from_bundle(bundle, quantize="w8a8-pallas",
                                                                  **kw),
                 batches[0][0], lambda sc: outputs(torch, sc, batches), ref)
    return launches


def check_fp32(torch, bundle, frames) -> None:
    """The plain fp32 scorer on the card, with torch's default TF32 flags in
    force, against the same scorer on the CPU (IEEE fp32) at the CPU parity
    bars (PERF.md §2): features rtol 1e-3 / atol 2e-4, scores atol 1e-4. The
    scorer pins IEEE fp32 itself; the same forward with the pin bypassed
    (cuDNN in TF32) is read beside it."""
    from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer

    kw = dict(compute_dtype=torch.float32, use_kernels=False)
    card = VisualScorer.from_bundle(bundle, device="cuda", **kw)
    cpu = VisualScorer.from_bundle(bundle, device="cpu", **kw)
    flags = torch.backends.cudnn.allow_tf32
    got = card.score(frames), card.frame_features(frames).double().cpu()
    ref = cpu.score(frames), cpu.frame_features(frames).double()
    tf32 = VisualScorer.frame_features.__wrapped__(card, frames).double().cpu()
    feat_err = lambda f: ((f - ref[1]).abs() - 1e-3 * ref[1].abs()).max().item()
    say(f"fp32 on the card (cudnn.allow_tf32={flags} in force) vs the CPU: features max "
        f"(|d| - 1e-3 |ref|) {feat_err(got[1]):.3e} (<= 2e-4), scores max|d| "
        f"{np.abs(got[0] - ref[0]).max():.3e} (<= 1e-4); the pin bypassed (TF32): "
        f"{feat_err(tf32):.3e}")
    if torch.backends.cudnn.allow_tf32 != flags:
        raise AssertionError("the fp32 scorer left cuDNN's TF32 flag changed")
    torch.testing.assert_close(got[1], ref[1], rtol=1e-3, atol=2e-4)
    if np.abs(got[0] - ref[0]).max() > 1e-4:
        raise AssertionError("fp32 scores on the card differ from the CPU's")


class WrongOperand:
    """Puts a wrong operand of a route's kernel into ``scorer``'s folded
    backbone for the ``with`` block, then the sound one back:
    - middle_taps: the last rep's taps of every middle block 4x too large;
    - entry_pair: unit 1's pointwise weight of every stride-2 block 4x too
      large (the pair's output, and so its share of the block, 4x);
    - fuse_exit: conv4's bias dropped (an epilogue that skips it).
    On the audio path (``audio=True``) the middle flow's last-rep bias goes
    4x instead: its stage barely moves with the taps (AUDIO_STAGE_COS_MIN)."""

    WHAT = {"middle_taps": "last-rep taps x4", "entry_pair": "pw1 x4",
            "fuse_exit": "conv4 bias dropped"}

    def __init__(self, torch, scorer, route: str, audio: bool = False):
        fb = scorer.folded_backbone
        self.what = self.WHAT[route]
        if route == "middle_taps":
            operand = "k1_b" if audio else "k1_dw"
            self.what = "last-rep bias x4" if audio else self.what
            sites = [(b, operand) for b in fb.blocks if b.is_middle]
            wrong = lambda t: torch.cat([t[:2], 4 * t[2:]])
        elif route == "entry_pair":
            sites = [(b, "k3_pw1") for b in fb.blocks if b.is_entry]
            wrong = lambda t: 4 * t
        else:
            sites = [(fb.conv4, "k5_b")]
            wrong = torch.zeros_like
        self.sites, self.wrong = sites, wrong

    def __enter__(self):
        self.sound = [getattr(m, name) for m, name in self.sites]
        for (m, name), t in zip(self.sites, self.sound):
            setattr(m, name, self.wrong(t).contiguous())
        return self.what

    def __exit__(self, *exc):
        for (m, name), t in zip(self.sites, self.sound):
            setattr(m, name, t)


def stage_held(torch, label, scorer, plain, x, upto, *, control: bool = False,
               cos_min: float = STAGE_COS_MIN) -> None:
    """``scorer``'s backbone up to ``upto`` against ``plain``'s (the plain
    fp32 path) on the images ``x``: min per-image cosine against ``cos_min``.
    A control must fail it."""
    def stage(sc):
        with torch.inference_mode():
            h = sc.folded_backbone(x, use_kernels=sc.use_kernels, upto=upto, **sc.routes)
        return h.flatten(1).double()

    cos = torch.nn.functional.cosine_similarity(stage(scorer), stage(plain), dim=-1).min().item()
    ok = cos >= cos_min
    verdict = ("; control: fails, as it must" if not ok else "; control: PASSES") if control else ""
    say(f"{label}: {upto} output per image 1 - cos max {1 - cos:.3e} "
        f"(<= {1 - cos_min:.1e}){verdict}")
    if ok == control:
        raise AssertionError(f"{label}: " + ("the control passes the bar" if control
                                             else "disagreement"))


def slice_routes(torch, workdir, bundle, clip_dir, batches, plain, ref, kw) -> dict:
    """The routes' path: the CLI with every route at once, counted; the same
    through ``VisualScorer``; then each route alone, counted, held against
    the plain fp32 scorer ``plain`` (``ref``: its outputs) end to end and at
    its stage, with its control. Returns the CLI's counts of the routes'
    kernels."""
    from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer

    calls = len(batches)
    per_backbone = dict(k1b=8, k4=4, k5=2)
    flags = [f for _, cli_flags, _, _ in ROUTES.values() for f in cli_flags]
    expected = per_call(calls, **per_backbone)
    cli_scores = run_cli(torch, workdir, visual_argv(bundle, clip_dir), "slice CLI routes",
                         flags, expected)
    every = {k: v for route, _, _, _ in ROUTES.values() for k, v in route.items()}
    scorer = VisualScorer.from_bundle(bundle, **every, **kw)
    got = counted(torch, "slice routes (VisualScorer)", lambda: outputs(torch, scorer, batches),
                  per_call(2 * calls, **per_backbone))
    held(torch, "slice routes vs plain fp32", got, ref, (FEATURE_COS_MIN, SCORE_TOL))
    if np.abs(got[0] - cli_scores).max() > 1e-4:
        raise AssertionError("the CLI's routes scores differ from VisualScorer's")
    x = plain._frames_to_x(batches[0][0])
    for name, (route, _, per_backbone, upto) in ROUTES.items():
        scorer = VisualScorer.from_bundle(bundle, **route, **kw)
        got = counted(torch, f"slice {name} (VisualScorer)",
                      lambda: outputs(torch, scorer, batches), per_call(2 * calls, **per_backbone))
        held(torch, f"slice {name} vs plain fp32", got, ref, (FEATURE_COS_MIN, SCORE_TOL))
        stage_held(torch, f"slice {name} vs plain fp32", scorer, plain, x, upto)
        with WrongOperand(torch, scorer, name) as what:
            stage_held(torch, f"control {name}, {what}, vs plain fp32", scorer, plain, x,
                       upto, control=True)
            if name == "fuse_exit":  # the exit's fault reaches the features
                held(torch, f"control {name}, {what}, vs plain fp32",
                     outputs(torch, scorer, batches), ref, (FEATURE_COS_MIN, SCORE_TOL),
                     control=True)
    return {k: expected[k] for k in ("middle_block_bf16taps", "entry_pair", "sepconv_unit")}


def phase_audio_kernels(torch) -> dict:
    """Each kernel against its plain version at the audio path's shapes, on
    random inputs (MFCC images are constant along W and would hide a column
    fault); returns the worst max |d| of each."""
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.dw_w8a8 import dw_w8a8, dw_w8a8_ref
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_block import (
        entry_block,
        entry_block_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_pair import (
        entry_pair,
        entry_pair_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import (
        middle_block,
        middle_block_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block_w8 import (
        middle_block_w8,
        middle_block_w8_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.sepconv_unit import (
        sepconv_unit,
        sepconv_unit_ref,
    )

    worst = dict.fromkeys(KERNELS, 0.0)

    def hold(name, label, got, ref, **kw):
        torch.cuda.synchronize()
        worst[name] = max(worst[name], compare(torch, f"audio {label}", got, ref, **kw))

    N = AUDIO_N
    ops = k1_operands(torch, N, 4, 728, "bfloat16", 736, seed=1000)
    for taps, name in (("fp32", "middle_block"), ("bf16", "middle_block_bf16taps")):
        hold(name, f"K1 {taps} taps ({N},4,4,728)", middle_block(*ops, taps=taps),
             middle_block_ref(*ops, taps=taps))
    ops = k2_operands(torch, N, 4, 728, "bfloat16", seed=1001)
    hold("middle_block_w8", f"K2 ({N},4,4,728)", middle_block_w8(*ops), middle_block_w8_ref(*ops),
         int8=True, equal_min=1.0)
    Nd, Hd, Cd = AUDIO_DW
    ops = dw_operands(torch, Nd, Hd, Cd, "bfloat16", seed=1002)
    hold("dw_w8a8", f"dw_w8a8 ({Nd},{Hd},{Hd},{Cd})", dw_w8a8(*ops, torch.bfloat16),
         dw_w8a8_ref(*ops, torch.bfloat16), int8=True, equal_min=1.0)
    del ops
    for i, (N, H, W, Cin, Cmid, Cout, lead, dtype) in enumerate(AUDIO_K3_BLOCKS):
        ops = k3_operands(torch, N, H, W, Cin, Cmid, Cout, dtype, seed=1010 + i)
        shape = f"({N},{H},{W},{Cin}) {Cin}->{Cmid}->{Cout}"
        hold("entry_block", f"K3 {shape}", entry_block(*ops, leading_relu0=lead),
             entry_block_ref(*ops, leading_relu0=lead))
        hold("entry_pair", f"K4 {shape}", entry_pair(*ops[:7], leading_relu0=lead),
             entry_pair_ref(*ops[:7], leading_relu0=lead))
        del ops
    for i, (N, H, Cin, Cout, lead, trail, dtype) in enumerate(AUDIO_K5_CONVS):
        ops = k5_operands(torch, N, H, Cin, Cout, dtype, seed=1020 + i)
        kw = dict(leading_relu=lead, trailing_relu=trail)
        hold("sepconv_unit", f"K5 ({N},{H},{H},{Cin})->{Cout}", sepconv_unit(*ops, **kw),
             sepconv_unit_ref(*ops, **kw))
        del ops
    torch.cuda.empty_cache()
    return worst


def check_mfcc(torch) -> None:
    """The MFCC frontend on the card against the same on the CPU, for seeded
    waveforms of several lengths (one not a multiple of the hop), centred and
    not: max |d| <= MFCC_TOL on values in the hundreds."""
    from multimodal_deepfake_detection_tpu_torch.ops.mfcc import mfcc

    rng = np.random.default_rng(40)
    worst = 0.0
    for L in (8000, 16000, 36833):
        y = torch.from_numpy(rng.normal(0, 0.1, (3, L)).astype(np.float32))
        for center in (True, False):
            ref = mfcc(y, center=center)
            got = mfcc(y.cuda(), center=center).cpu()
            d = (got - ref).abs().max().item()
            worst = max(worst, d)
            say(f"MFCC on the card vs the CPU, (3,{L}) center={center}: max|d| {d:.3e} "
                f"(<= {MFCC_TOL:.0e}; max|ref| {ref.abs().max().item():.1f})")
            if not (torch.isfinite(got).all() and d <= MFCC_TOL):
                raise AssertionError("the MFCC on the card disagrees with the CPU's")


def audio_outputs(torch, scorer, batches):
    """``scorer``'s scores and its per-frame features (fp64) of each batch's
    frames of the true signal, ``1 + L // hop`` for waveforms padded to L."""
    scores, feats = [], []
    for waves in batches:
        scores.append(scorer.score(waves))
        n = 1 + waves.shape[1] // HOP
        feats.append(scorer.frame_features(waves)[:, :n].reshape(-1, 2048).double())
    return np.concatenate(scores), torch.cat(feats)


def audio_bundle(torch, workdir: str) -> str:
    """The seeded full-width XceptionLSTMA bundle (hidden 512), written once."""
    bundle = os.path.join(workdir, "audio.npz")
    if not os.path.exists(bundle):
        write_bundle(torch, bundle, hidden_dim=512, seed=1, arcface=False)
    return bundle


def phase_audio(torch, workdir: str, smi: str) -> dict:
    """The audio and AV serving paths (phase 6); returns the audio CLI's
    launch counts."""
    from multimodal_deepfake_detection_tpu_torch.cli.serve import _pad_stack
    from multimodal_deepfake_detection_tpu_torch.models.serve import AudioScorer

    check_mfcc(torch)
    bundle = audio_bundle(torch, workdir)
    wave_dir = os.path.join(workdir, "waves")
    os.makedirs(wave_dir)
    rng = np.random.default_rng(41)
    waves = [rng.normal(0, 0.1, L).astype(np.float32) for L in WAVE_SAMPLES]
    for i, w in enumerate(waves):
        np.save(os.path.join(wave_dir, f"wave{i}.npy"), w)
    calls = -(-len(waves) // AUDIO_BATCH)
    batches = [_pad_stack(waves[i : i + AUDIO_BATCH])[0]
               for i in range(0, len(waves), AUDIO_BATCH)]
    argv = ["--engine", "audio", "--ckpt_path", bundle, "--input", wave_dir,
            "--batch_size", str(AUDIO_BATCH)]
    kw = dict(device="cuda", sample_buckets=(16000, 48000, 160000))

    # the CLI on the four paths, each counted
    cli = {}
    for label, flags, per_backbone in (
            ("fp", [], dict(k1=8)),
            ("w8a8-pallas", ["--quantize", "w8a8-pallas"], dict(k2=8, dw=10)),
            ("fuse_entry", ["--fuse_entry", "true"], dict(k1=8, k3=4)),
            ("routes", [f for _, fl, _, _ in ROUTES.values() for f in fl],
             dict(k1b=8, k4=4, k5=2))):
        expected = per_call(calls, **per_backbone)
        cli[label] = (run_cli(torch, workdir, argv, f"audio CLI {label}", flags, expected,
                              len(waves)), expected)
    launches = dict(cli["fp"][1])  # each kernel's count on the path that runs it
    for label, names in (("w8a8-pallas", ("middle_block_w8", "dw_w8a8")),
                         ("fuse_entry", ("entry_block",)),
                         ("routes", ("middle_block_bf16taps", "entry_pair", "sepconv_unit"))):
        launches.update({k: cli[label][1][k] for k in names})

    # every path through AudioScorer (score + frame_features: 2 backbone
    # calls per batch), counted, against the plain fp32 path on the card
    plain = AudioScorer.from_bundle(bundle, compute_dtype=torch.float32, use_kernels=False, **kw)
    ref = audio_outputs(torch, plain, batches)
    paths = {"fp": ({}, dict(k1=8)), "fuse_entry": ({"fuse_entry": True}, dict(k1=8, k3=4))}
    paths.update({name: (route, per) for name, (route, _, per, _) in ROUTES.items()})
    paths["routes"] = ({k: v for r, _, _, _ in ROUTES.values() for k, v in r.items()},
                      dict(k1b=8, k4=4, k5=2))
    x = plain._wave_to_imgs(batches[0], True)[0]
    for name, (route, per_backbone) in paths.items():
        scorer = AudioScorer.from_bundle(bundle, **route, **kw)
        got = counted(torch, f"audio {name} (AudioScorer)",
                      lambda: audio_outputs(torch, scorer, batches),
                      per_call(2 * calls, **per_backbone))
        held(torch, f"audio {name} vs plain fp32", got, ref, (FEATURE_COS_MIN, SCORE_TOL))
        if name in cli and np.abs(got[0] - cli[name][0]).max() > 1e-4:
            raise AssertionError(f"the audio CLI's {name} scores differ from AudioScorer's")
        if name in ROUTES:
            upto = ROUTES[name][3]
            stage_held(torch, f"audio {name} vs plain fp32", scorer, plain, x, upto,
                       cos_min=AUDIO_STAGE_COS_MIN)
            with WrongOperand(torch, scorer, name, audio=True) as what:
                stage_held(torch, f"control audio {name}, {what}, vs plain fp32", scorer, plain,
                           x, upto, control=True, cos_min=AUDIO_STAGE_COS_MIN)
        if name == "fuse_entry":
            blocks = [b for b in scorer.folded_backbone.blocks if b.is_entry]
            sound = [b.k3_skw for b in blocks]
            for b in blocks:
                b.k3_skw = 4 * b.k3_skw
            held(torch, "control audio fuse_entry, K3 skip weight x4, vs plain fp32",
                 audio_outputs(torch, scorer, batches), ref, (FEATURE_COS_MIN, SCORE_TOL),
                 control=True)
            for b, skw in zip(blocks, sound):
                b.k3_skw = skw

    # every quant mode, counted, against the plain path on its calibrated
    # tree and against plain fp32; control: a calibration that clips
    for mode, per_backbone in (("w8a8-pallas", dict(k2=8, dw=10)),
                               ("w8a8-hybrid", dict(k1=8, dw=10)), ("w8a8", dict(dw=34))):
        kern = AudioScorer.from_bundle(bundle, quantize=mode, **kw)
        kern.calibrate(batches[0])  # the CLI calibrates on its first batch
        qplain = AudioScorer.from_bundle(bundle, quantize=mode, use_kernels=False, **kw)
        qplain.qbackbone = sound = kern.qbackbone
        got = counted(torch, f"audio {mode} (AudioScorer)",
                      lambda: audio_outputs(torch, kern, batches),
                      per_call(2 * calls, **per_backbone))
        plain_out = audio_outputs(torch, qplain, batches)
        held(torch, f"audio {mode} vs plain {mode}", got, plain_out, AUDIO_QUANT_KERNEL_BARS)
        held(torch, f"audio {mode} vs plain fp32", got, ref, AUDIO_QUANT_FP32_BARS)
        if mode == "w8a8-pallas" and np.abs(got[0] - cli[mode][0]).max() > 1e-4:
            raise AssertionError("the audio CLI's w8a8-pallas scores differ from AudioScorer's")
        # control: a calibration that clips, against the plain path on the
        # sound tree and against plain fp32
        kern.qbackbone = quantize_clipped(kern, calibrate_audio_amax(torch, kern, batches[0]),
                                          mode)
        clipped = audio_outputs(torch, kern, batches)
        held(torch, f"control audio {mode}, clipping calibration, vs plain {mode}", clipped,
             plain_out, AUDIO_QUANT_KERNEL_BARS, control=True)
        held(torch, f"control audio {mode}, clipping calibration, vs plain fp32", clipped, ref,
             AUDIO_QUANT_FP32_BARS, control=True)
        kern.qbackbone = sound
    refined_held(torch, "audio", lambda: AudioScorer.from_bundle(bundle, quantize="w8a8-pallas",
                                                                 **kw),
                 batches[0], lambda sc: audio_outputs(torch, sc, batches), ref)
    check_av(torch, workdir, bundle)
    return launches


def calibrate_audio_amax(torch, scorer, waves):
    from multimodal_deepfake_detection_tpu_torch.models.quant import calibrate_amax

    with torch.inference_mode():
        x = scorer._wave_to_imgs(waves, True)[0]
    return calibrate_amax(scorer.fp_tree, x, compute_dtype=scorer.compute_dtype)


def quantize_clipped(scorer, amaxes, mode):
    """The tree of a calibration that clips: every activation scale halved."""
    from multimodal_deepfake_detection_tpu_torch.models.quant import quantize_folded_xception

    return quantize_folded_xception(scorer.fp_tree, amaxes, headroom=0.5, quant_depthwise=True,
                                    skip_middle=mode == "w8a8-hybrid")


def refined_held(torch, label, make, calib, outputs_of, ref) -> None:
    """A ``w8a8-pallas`` scorer calibrated on ``calib`` without and with one
    refinement pass (``calibrate(refine_passes=1)``), each against the plain
    fp32 outputs ``ref``: the refined scorer must be no further from them,
    by the relative error of all its per-frame features."""
    readings = []
    for passes in (0, 1):
        scorer = make()
        scorer.calibrate(calib, refine_passes=passes)
        got = outputs_of(scorer)
        rel = ((got[1] - ref[1]).norm() / ref[1].norm()).item()
        cos = torch.nn.functional.cosine_similarity(got[1], ref[1], dim=-1).min().item()
        readings.append(rel)
        say(f"{label} w8a8-pallas refine_passes={passes} vs plain fp32: features relative error "
            f"{rel:.4e}, per-frame 1 - cos max {1 - cos:.3e}, score max|d| "
            f"{np.abs(got[0] - ref[0]).max():.3e}")
    if readings[1] > readings[0]:
        raise AssertionError(f"{label}: the refined calibration is further from plain fp32")


def check_av(torch, workdir, audio_bundle) -> None:
    """``cli/serve.py --engine av``: each clip of phase 4 paired by stem
    with a waveform; the fused scores against ``alpha p_v + (1 - alpha) p_a``
    of the two engines scored alone in this process, <= 1e-6 (the JSONL
    keeps 6 places)."""
    from multimodal_deepfake_detection_tpu_torch.cli.serve import _pad_stack
    from multimodal_deepfake_detection_tpu_torch.models.serve import AudioScorer, VisualScorer

    clip_dir = os.path.join(workdir, "clips")
    clips = [np.load(os.path.join(clip_dir, f"clip{i}.npy")) for i in range(len(CLIP_LENGTHS))]

    wave_dir = os.path.join(workdir, "av_waves")
    os.makedirs(wave_dir)
    rng = np.random.default_rng(42)
    waves = [rng.normal(0, 0.1, WAVE_SAMPLES[i % len(WAVE_SAMPLES)]).astype(np.float32)
             for i in range(len(clips))]
    for i, w in enumerate(waves):
        np.save(os.path.join(wave_dir, f"clip{i}.npy"), w)
    bundle = os.path.join(workdir, "visual.npz")
    argv = ["--engine", "av", "--ckpt_path", bundle, "--audio_ckpt_path", audio_bundle,
            "--input", clip_dir, "--audio_input", wave_dir, "--batch_size", str(BATCH_SIZE),
            "--av_alpha", str(AV_ALPHA)]
    calls = -(-len(clips) // BATCH_SIZE)
    fused = run_cli(torch, workdir, argv, "AV CLI", [], per_call(2 * calls, k1=8), len(clips))
    visual = VisualScorer.from_bundle(bundle, device="cuda", buckets=(25, 50, 75))
    audio = AudioScorer.from_bundle(audio_bundle, device="cuda",
                                    sample_buckets=(16000, 48000, 160000))
    alone = []
    for i in range(0, len(clips), BATCH_SIZE):
        p_v = visual.score(*_pad_stack(clips[i : i + BATCH_SIZE]))
        p_a = audio.score(_pad_stack(waves[i : i + BATCH_SIZE])[0])
        alone.append(AV_ALPHA * p_v + (1 - AV_ALPHA) * p_a)
    d = np.abs(fused - np.concatenate(alone)).max()
    say(f"AV CLI vs {AV_ALPHA} p_visual + {1 - AV_ALPHA:.1f} p_audio of the engines alone: "
        f"max|d| {d:.3e} (<= 1e-6); fused {np.round(fused, 4).tolist()}")
    if d > 1e-6:
        raise AssertionError("the AV CLI's fused scores differ from the engines' fusion")


def cuda_ms(torch, fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, fns: dict, iters: int) -> dict:
    """Mean ms of each callable over passes in turns (a b ... b a)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    order = list(fns) + list(fns)[::-1]
    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(cuda_ms(torch, fns[name], iters))
    return {name: float(np.mean(r)) for name, r in runs.items()}, runs


def library_block(torch, x, dw, pw_t, b, *, int8_sc=None):
    """The middle block through PyTorch's own calls: cuDNN depthwise and
    cuBLAS 1x1 in the compute dtype (K1's function); with ``int8_sc``, the
    fp32 cuDNN depthwise on the scaled taps, quantize, and ``torch._int_mm``
    (K2's function). ``pw_t``: per rep the ``(in, out)`` pointwise matrix."""
    import torch.nn.functional as F

    N, H, W, C = x.shape
    h = x
    for r in range(dw.shape[0]):
        a = torch.relu(h).permute(0, 3, 1, 2)
        if int8_sc is None:  # in the compute dtype throughout, as the fold path runs
            taps = dw[r].t().reshape(C, 1, 3, 3).to(x.dtype)
            y = F.conv2d(a, taps, padding=1, groups=C).permute(0, 2, 3, 1).reshape(-1, C)
            o = torch.addmm(b[r].to(x.dtype), y, pw_t[r]).reshape(N, H, W, C)
        else:
            taps = dw[r].t().reshape(C, 1, 3, 3)
            y = F.conv2d(a.to(torch.bfloat16).float(), taps, padding=1, groups=C)
            q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
            q = q.permute(0, 2, 3, 1).reshape(-1, C)
            o = (torch._int_mm(q, pw_t[r]).float() * int8_sc[r] + b[r]).reshape(N, H, W, C)
        if r + 1 == dw.shape[0]:
            o = o + x
        h = o.to(x.dtype)
    return h


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_middle(torch, smi: str, N: int, H: int, dw_shape, where: str) -> dict:
    """K1 (both tap orders), K2 and the int8 depthwise at a path's shapes:
    the middle trunk ``(N, H, H, 728)``, the depthwise's largest site
    ``dw_shape = (N, H, C)``; each against its plain version and PyTorch's
    own calls, in turns, and K1's and K2's halves per launch."""
    import torch.nn.functional as F

    from multimodal_deepfake_detection_tpu_torch.ops.kernels.dw_w8a8 import dw_w8a8, dw_w8a8_ref
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import (
        middle_block,
        middle_block_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block_w8 import (
        _scaled,
        middle_block_w8,
        middle_block_w8_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.quant import quantize

    times = {}
    C = 728
    M = N * H * H
    x, dw, pw, b = k1_operands(torch, N, H, C, "bfloat16", 736, seed=99)
    pw_t = [pw[r, :, :C].contiguous().t() for r in range(3)]
    ms, runs = in_turns(torch, {
        "plain": lambda: middle_block_ref(x, dw, pw, b),
        "kernel": lambda: middle_block(x, dw, pw, b),
        "library": lambda: library_block(torch, x, dw, pw_t, b),
    }, 10)
    ops = 3 * 2 * M * C * C
    times["middle_block"] = (ms, bound_ms(2 * x.numel() * 2 + pw.numel() * 2, ops, PEAK_BF16))
    say(f"time K1 ({N},{H},{H},{C}) bf16{where}: kernel {ms['kernel']:.4f} ms "
        f"({ops / ms['kernel'] / 1e9:.1f} TFLOP/s on the pointwise), plain {ms['plain']:.4f} ms, "
        f"cuDNN + cuBLAS {ms['library']:.4f} ms, bound {times['middle_block'][1][0]:.4f} ms "
        f"({times['middle_block'][1][1]}); runs {runs} [{smi}]")
    k1_halves(torch, x, dw, pw, b, smi)
    # the bf16-tap K1 per middle block, beside the fp32-tap K1 in the same turns
    ms, runs = in_turns(torch, {
        "plain": lambda: middle_block_ref(x, dw, pw, b, taps="bf16"),
        "kernel": lambda: middle_block(x, dw, pw, b, taps="bf16"),
        "fp32 taps": lambda: middle_block(x, dw, pw, b),
        "library": lambda: library_block(torch, x, dw, pw_t, b),
    }, 10)
    times["middle_block_bf16taps"] = (ms, times["middle_block"][1])
    say(f"time K1 bf16 taps ({N},{H},{H},{C}) bf16{where}: kernel {ms['kernel']:.4f} ms (fp32 "
        f"taps {ms['fp32 taps']:.4f} ms), plain {ms['plain']:.4f} ms, cuDNN + cuBLAS "
        f"{ms['library']:.4f} ms; runs {runs} [{smi}]")
    del x, dw, pw, b, pw_t

    ops_k2 = k2_operands(torch, N, H, C, "bfloat16", seed=98)
    x2, dw2, pw_q, s_w, s_in, s_dq, b2 = ops_k2
    taps, sc = _scaled(dw2, s_w, s_in, s_dq)
    pw_t = [pw_q[r, :, :C].contiguous().t() for r in range(3)]
    ms, runs = in_turns(torch, {
        "plain": lambda: middle_block_w8_ref(*ops_k2),
        "kernel": lambda: middle_block_w8(*ops_k2),
        "library": lambda: library_block(torch, x2, taps, pw_t, b2, int8_sc=sc),
    }, 10)
    times["middle_block_w8"] = (ms, bound_ms(2 * x2.numel() * 2 + 3 * C * C, ops, PEAK_INT8))
    say(f"time K2 ({N},{H},{H},{C}) bf16{where}: kernel {ms['kernel']:.4f} ms "
        f"({ops / ms['kernel'] / 1e9:.1f} TOP/s on the pointwise), plain {ms['plain']:.4f} ms, "
        f"cuDNN + torch._int_mm {ms['library']:.4f} ms, bound {times['middle_block_w8'][1][0]:.4f} "
        f"ms ({times['middle_block_w8'][1][1]}); runs {runs} [{smi}]")
    k2_halves(torch, ops_k2, smi)
    del ops_k2, x2, pw_t

    Nd, Hd, Cd = dw_shape
    xd, w_q, s_ind, scd = dw_operands(torch, Nd, Hd, Cd, "bfloat16", seed=97)
    w_f = w_q.float()

    def library_dw():
        q = quantize(xd, s_ind).float().permute(0, 3, 1, 2)
        y = F.conv2d(q, w_f, padding=1, groups=Cd).permute(0, 2, 3, 1)
        return (y * scd).to(torch.bfloat16)

    ms, runs = in_turns(torch, {
        "plain": lambda: dw_w8a8_ref(xd, w_q, s_ind, scd, torch.bfloat16),
        "kernel": lambda: dw_w8a8(xd, w_q, s_ind, scd, torch.bfloat16),
        "library": library_dw,
    }, 10)
    nbytes = 2 * xd.numel() * 2 + w_q.numel() + 2 * 4 * Cd
    times["dw_w8a8"] = (ms, bound_ms(nbytes, 2 * 9 * xd.numel(), PEAK_INT8))
    say(f"time dw_w8a8 ({Nd},{Hd},{Hd},{Cd}) bf16{where}: kernel {ms['kernel']:.4f} ms "
        f"({nbytes / ms['kernel'] / 1e6:.1f} GB/s), plain {ms['plain']:.4f} ms, quantize + "
        f"fp32 cuDNN depthwise {ms['library']:.4f} ms, bound {times['dw_w8a8'][1][0]:.4f} ms "
        f"({times['dw_w8a8'][1][1]}); runs {runs} [{smi}]")
    return times


def phase_times(torch, smi: str, workdir: str):
    from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer

    # the middle trunk of 256 frames at 256^2; block 1's second depthwise,
    # the int8 depthwise's largest site
    times = time_middle(torch, smi, 256, 16, (256, 125, 128), "")

    bundle = os.path.join(workdir, "visual.npz")
    fused = VisualScorer.from_bundle(bundle, device="cuda", fuse_entry=True)
    times["entry_block"] = time_k3(torch, fused, smi)
    routes = VisualScorer.from_bundle(bundle, device="cuda", middle_taps="bf16", entry_pair=True,
                                      fuse_exit=True)
    times["entry_pair"] = time_k4(torch, routes, smi)
    times["sepconv_unit"] = time_k5(torch, routes, smi)

    B, T, S = 32, 8, 256
    frames = np.random.default_rng(1).integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    scorers = {
        "fp plain": VisualScorer.from_bundle(bundle, device="cuda", use_kernels=False),
        "fp K1": VisualScorer.from_bundle(bundle, device="cuda"),
        "fp K1+K3": fused,
        "fp K1 bf16 taps": VisualScorer.from_bundle(bundle, device="cuda", middle_taps="bf16"),
        "fp K1+K4": VisualScorer.from_bundle(bundle, device="cuda", entry_pair=True),
        "fp K1+K5": VisualScorer.from_bundle(bundle, device="cuda", fuse_exit=True),
        "fp routes (K1 bf16 taps+K4+K5)": routes,
        "w8a8-pallas": VisualScorer.from_bundle(bundle, device="cuda", quantize="w8a8-pallas"),
    }
    for sc_ in scorers.values():
        sc_.score(frames)  # warm-up; calibrates the w8a8 scorer
    call_ms = {name: [] for name in scorers}
    for name in list(scorers) + list(scorers)[::-1]:  # in turns
        t0 = time.perf_counter()
        for _ in range(5):
            scorers[name].score(frames)  # returns host scores: synchronised
        call_ms[name].append((time.perf_counter() - t0) / 5 * 1e3)
    for name, runs in call_ms.items():
        ms = float(np.mean(runs))
        say(f"time slice B={B} T={T} {S}^2 bf16 {name}: {ms:.2f} ms/call, "
            f"{B * T / ms * 1e3:.1f} frames/s; runs {runs} [{smi}]")
    profiled = ("fp K1", "fp K1+K3", "fp routes (K1 bf16 taps+K4+K5)", "w8a8-pallas")
    profile_calls(torch, {k: scorers[k] for k in profiled}, frames, smi)
    return times


def phase_audio_times(torch, smi: str, workdir: str) -> dict:
    """The audio path on the card: each kernel at its audio shape (as
    ``phase_times``), the MFCC frontend alone, ``AudioScorer.score`` of 64
    one-second clips in turns (clips/s), and a profile of one scored batch."""
    from multimodal_deepfake_detection_tpu_torch.models.serve import AudioScorer, mfcc_images
    from multimodal_deepfake_detection_tpu_torch.ops.mfcc import mfcc

    times = time_middle(torch, smi, AUDIO_N, 4, AUDIO_DW, " (audio)")
    bundle = audio_bundle(torch, workdir)
    kw = dict(device="cuda", sample_buckets=(16000, 48000, 160000))
    of = f"the audio batch ({AUDIO_N} images)"
    fused = AudioScorer.from_bundle(bundle, fuse_entry=True, **kw)
    times["entry_block"] = time_k3(torch, fused, smi, AUDIO_K3_BLOCKS, of)
    routes = AudioScorer.from_bundle(bundle, middle_taps="bf16", entry_pair=True, fuse_exit=True,
                                     **kw)
    times["entry_pair"] = time_k4(torch, routes, smi, AUDIO_K3_BLOCKS, of)
    times["sepconv_unit"] = time_k5(torch, routes, smi, AUDIO_K5_CONVS, of)
    torch.cuda.empty_cache()

    B = AUDIO_N // 101
    waves = np.random.default_rng(43).normal(0, 0.1, (B, SR)).astype(np.float32)
    w = torch.from_numpy(waves).cuda()
    ms, runs = in_turns(torch, {"frontend": lambda: mfcc_images(mfcc(w))}, 10)
    say(f"time MFCC frontend ({B},{SR}) -> ({AUDIO_N},64,64,3) fp32, waveforms on the card: "
        f"{ms['frontend']:.4f} ms; runs {runs} [{smi}]")
    scorers = {
        "plain bf16": AudioScorer.from_bundle(bundle, use_kernels=False, **kw),
        "K1": AudioScorer.from_bundle(bundle, **kw),
        "routes (K1 bf16 taps+K4+K5)": routes,
        "w8a8-pallas": AudioScorer.from_bundle(bundle, quantize="w8a8-pallas", **kw),
    }
    for sc_ in scorers.values():
        sc_.score(waves)  # warm-up; calibrates the w8a8 scorer
    call_ms = {name: [] for name in scorers}
    for name in list(scorers) + list(scorers)[::-1]:  # in turns
        t0 = time.perf_counter()
        for _ in range(3):
            scorers[name].score(waves)  # returns host scores: synchronised
        call_ms[name].append((time.perf_counter() - t0) / 3 * 1e3)
    for name, runs in call_ms.items():
        ms = float(np.mean(runs))
        say(f"time audio B={B} one-second clips ({AUDIO_N} images of 64^2) bf16 {name}: "
            f"{ms:.2f} ms/call, {B / ms * 1e3:.1f} clips/s; runs {runs} [{smi}]")
    profile_calls(torch, {f"audio {k}": scorers[k] for k in ("K1", "w8a8-pallas")}, waves, smi)
    return times


def half_of(key: str) -> str:
    """The half of a two-launch kernel that a device kernel's name belongs
    to: the depthwise, or ``persistent_kernel<E, T, RELU_OUT, RESID>``
    without or with the residual; anything else is a PyTorch op."""
    if "dw3x3" in key:
        return "depthwise"
    m = re.search(r"persistent_kernel<([^<>]*)>", key)
    if m:
        return "GEMM with residual" if m.group(1).split(",")[-1].strip() == "true" else "GEMM"
    return "PyTorch op"


def device_halves(torch, label: str, fn, expected: dict, torch_ops: int = 0) -> dict:
    """``{half: (device us per launch, launches per call)}`` of ``fn()`` by
    ``torch.profiler``. Fails unless one call launches the kernels of
    ``expected`` (per half) and ``torch_ops`` of the wrapper's own PyTorch
    ops, counted in a captured CUDA graph (:func:`graph_kernels`), and, in a
    window where the profiler saw every launch, unless its halves split as
    ``expected``; the profiler drops records, so a split it saw short is
    printed, not held."""
    launches = graph_kernels(torch, fn)
    want = sum(expected.values()) + torch_ops
    for _ in range(3):
        sums = {}
        for key, (us, n) in device_kernels(torch, fn).items():
            half = half_of(key)
            us0, n0 = sums.get(half, (0.0, 0))
            sums[half] = (us0 + us, n0 + n)
        halves = {half: (us / n, round(n / PROFILED_CALLS)) for half, (us, n) in sums.items()}
        counts = {half: n for half, (_, n) in halves.items()}
        if sum(counts.values()) == launches:
            break
    seen_all = sum(counts.values()) == launches
    say(f"device launches of one {label}: {launches} in a captured graph ({want} expected); "
        f"profiled per half {counts}" + ("" if seen_all else
                                         " (the profiler dropped records: split not held)"))
    if launches != want or (seen_all and {k: n for k, n in counts.items()
                                          if k != "PyTorch op"} != expected):
        raise AssertionError(f"one {label} launched {launches} kernels, {counts} by half: "
                             f"{expected} and {torch_ops} PyTorch ops expected")
    return halves


def per_launch(halves: dict) -> str:
    return ", ".join(f"{k} {us:.2f} (x{n})" for k, (us, n) in halves.items())


BLOCK_LAUNCHES = {"depthwise": 3, "GEMM": 2, "GEMM with residual": 1}


def k1_halves(torch, x, dw, pw, b, smi: str) -> None:
    """One K1 block's two halves: device time per launch by ``torch.profiler``
    beside each half's bound and, as yardsticks the port never calls,
    cuDNN's depthwise and cuBLAS's ``addmm`` alone at the same shapes; the
    two-launch floor (the A operand through device memory). Fails unless
    the block is 6 device launches, 3 of each half."""
    import torch.nn.functional as F

    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import middle_block

    N, H, W, C = x.shape
    M, ldk = N * H * W, pw.shape[-1]
    halves = device_halves(torch, "K1 block", lambda: middle_block(x, dw, pw, b), BLOCK_LAUNCHES)
    a = torch.relu(x).permute(0, 3, 1, 2)
    taps = dw[0].t().reshape(C, 1, 3, 3).to(x.dtype)
    y = torch.randn((M, C), device=x.device).to(x.dtype)
    pw_t = pw[0, :, :C].t()
    bias = b[0].to(x.dtype)
    lib, _ = in_turns(torch, {
        "cuDNN depthwise": lambda: F.conv2d(a, taps, padding=1, groups=C),
        "cuBLAS addmm": lambda: torch.addmm(bias, y, pw_t),
    }, 20)
    bytes_mm = (M * ldk + M * C + C * ldk) * 2  # A, out, the weight
    bound_dw = (M * C + M * ldk) * 2 / PEAK_BYTES * 1e6
    bound_mm = max(bytes_mm / PEAK_BYTES, 2 * M * C * C / PEAK_BF16) * 1e6
    bound_res = max((bytes_mm + M * C * 2) / PEAK_BYTES, 2 * M * C * C / PEAK_BF16) * 1e6
    floor = (3 * bound_dw + 2 * bound_mm + bound_res) / 1e3
    say(f"time K1 halves ({N},{H},{W},{C}) bf16, device us per launch: {per_launch(halves)}"
        f"; bounds: depthwise {bound_dw:.1f} (bytes), GEMM {bound_mm:.1f} (operations), with "
        f"the residual {bound_res:.1f} (bytes); yardsticks: cuDNN depthwise "
        f"{lib['cuDNN depthwise'] * 1e3:.2f}, cuBLAS addmm {lib['cuBLAS addmm'] * 1e3:.2f}; "
        f"two-launch floor {floor:.4f} ms per block [{smi}]")


def k2_halves(torch, ops_k2, smi: str) -> None:
    """One K2 block's two halves, as ``k1_halves``: the int8-out depthwise
    and the s8 GEMM (with the residual on the last rep), device us per
    launch, beside each half's bound and, as yardsticks the port never
    calls, cuDNN's fp32 depthwise and ``torch._int_mm`` alone at the same
    shapes; the two-launch floor. Fails unless the block is 6 device
    launches, 3 of each half (beside them run the wrapper's two fp32 ops,
    ``_scaled``)."""
    import torch.nn.functional as F

    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block_w8 import (
        _scaled,
        middle_block_w8,
    )

    x, dw, pw_q, s_w, s_in, s_dq, b = ops_k2
    N, H, W, C = x.shape
    M, ldk = N * H * W, pw_q.shape[-1]
    halves = device_halves(torch, "K2 block", lambda: middle_block_w8(*ops_k2), BLOCK_LAUNCHES,
                           torch_ops=2)
    taps, _ = _scaled(dw, s_w, s_in, s_dq)
    a = torch.relu(x).float().permute(0, 3, 1, 2)
    taps = taps[0].t().reshape(C, 1, 3, 3)
    q = torch.randint(-127, 128, (M, C), dtype=torch.int8, device=x.device)
    pw_t = pw_q[0, :, :C].contiguous().t()
    lib, _ = in_turns(torch, {
        "cuDNN depthwise": lambda: F.conv2d(a, taps, padding=1, groups=C),
        "torch._int_mm": lambda: torch._int_mm(q, pw_t),
    }, 20)
    io = M * C * x.element_size()  # an activation in the I/O dtype
    bytes_mm = M * ldk + io + C * ldk  # A, out, the weight
    ops = 2 * M * C * C
    bound_dw = bound_ms(io + M * ldk, 0, PEAK_INT8)
    bound_mm = bound_ms(bytes_mm, ops, PEAK_INT8)
    bound_res = bound_ms(bytes_mm + io, ops, PEAK_INT8)
    floor = 3 * bound_dw[0] + 2 * bound_mm[0] + bound_res[0]
    say(f"time K2 halves ({N},{H},{W},{C}) {str(x.dtype)[6:]}, device us per launch: "
        f"{per_launch(halves)}; bounds: depthwise {bound_dw[0] * 1e3:.1f} ({bound_dw[1]}), GEMM "
        f"{bound_mm[0] * 1e3:.1f} ({bound_mm[1]}; operations {ops / PEAK_INT8 * 1e6:.1f}), with "
        f"the residual {bound_res[0] * 1e3:.1f} ({bound_res[1]}); yardsticks: cuDNN fp32 "
        f"depthwise {lib['cuDNN depthwise'] * 1e3:.2f}, torch._int_mm "
        f"{lib['torch._int_mm'] * 1e3:.2f}; two-launch floor {floor:.4f} ms per block [{smi}]")


def time_k3(torch, scorer, smi: str, shapes=K3_BLOCKS, of: str = "256 frames"):
    """K3 per stride-2 block of the scorer's bf16 backbone, on random input
    at ``shapes`` (by default 256 frames at 256^2): the kernel, its plain
    version, and the library yardstick, the same folded block through cuDNN
    depthwise, cuBLAS 1x1,
    ``max_pool2d`` and the strided skip conv (``FoldedBlock.forward(
    use_kernels=False)``, which the fused path never calls). Returns the
    times and the bound, each summed over the four blocks."""
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_block import entry_block_ref

    blocks = [b for b in scorer.folded_backbone.blocks if b.is_entry]
    total = dict.fromkeys(("kernel", "plain", "library"), 0.0)
    bound = {"bytes": 0.0, "operations": 0.0}
    for k, (block, (N, H, W, Cin, Cmid, Cout, lead, _)) in enumerate(zip(blocks, shapes)):
        assert block.start_with_relu == lead and block.k3_pw0.shape[0] == Cmid
        gx = torch.Generator("cuda").manual_seed(500 + k)
        x = torch.randn((N, H, W, Cin), generator=gx, device="cuda").to(torch.bfloat16)
        ops3 = block.k3_operands()
        ms, runs = in_turns(torch, {
            "plain": lambda: entry_block_ref(x, *ops3, leading_relu0=lead),
            "kernel": lambda: block(x, True, True),
            "library": lambda: block(x),
        }, 5)
        for name in total:
            total[name] += ms[name]
        M, Mp = N * H * W, N * ((H + 1) // 2) * ((W + 1) // 2)
        ops = 2 * M * (Cin * Cmid + Cmid * Cout) + 2 * Mp * Cin * Cout
        nbytes = 2 * (x.numel() + Mp * Cout + Cmid * Cin + Cout * Cmid + Cout * Cin)
        b_ms, by = bound_ms(nbytes, ops, PEAK_BF16)
        bound[by] += b_ms
        say(f"time K3 block {(1, 2, 3, 12)[k]} ({N},{H},{W},{Cin}) {Cin}->{Cmid}->{Cout} bf16: "
            f"kernel {ms['kernel']:.4f} ms ({ops / ms['kernel'] / 1e9:.1f} TFLOP/s on the "
            f"pointwise), plain {ms['plain']:.4f} ms, cuDNN + cuBLAS block {ms['library']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({by}); runs {runs} [{smi}]")
        del x
    by = max(bound, key=bound.get)
    say(f"time K3, 4 blocks of {of}: kernel {total['kernel']:.4f} ms, plain "
        f"{total['plain']:.4f} ms, cuDNN + cuBLAS {total['library']:.4f} ms, bound "
        f"{sum(bound.values()):.4f} ms (mostly {by}) [{smi}]")
    return total, (sum(bound.values()), by)


def time_k4(torch, scorer, smi: str, shapes=K3_BLOCKS, of: str = "256 frames"):
    """K4 per stride-2 pair of the scorer's bf16 backbone, on random input at
    ``shapes`` (by default 256 frames at 256^2): the kernel with the route's
    switches (those of ``entry_pair_pallas``) and with the stream kernels' (dy-major with an fp32
    mid; dy-major), the first design's four launches (two K5 units: the
    tiled depthwise into device memory, then the GEMM, dy-major), its plain
    version, and the library yardstick, the same folded pair through cuDNN
    depthwise and cuBLAS 1x1 (the plain path's units, ReLUs between).
    Returns the times and the bound, each summed over the four pairs."""
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_pair import (
        entry_pair,
        entry_pair_ref,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.sepconv_unit import sepconv_unit

    blocks = [b for b in scorer.folded_backbone.blocks if b.is_entry]
    total = dict.fromkeys(("kernel", "stream", "stream2", "units", "plain", "library"), 0.0)
    bound = {"bytes": 0.0, "operations": 0.0}
    for k, (block, (N, H, W, Cin, Cmid, Cout, lead, _)) in enumerate(zip(blocks, shapes)):
        assert block.start_with_relu == lead and block.k3_pw0.shape[0] == Cmid
        gx = torch.Generator("cuda").manual_seed(800 + k)
        x = torch.randn((N, H, W, Cin), generator=gx, device="cuda").to(torch.bfloat16)
        ops4 = block.k3_operands()[:6]
        u0, u1 = block.units
        ms, runs = in_turns(torch, {
            "plain": lambda: entry_pair_ref(x, *ops4, leading_relu0=lead),
            "kernel": lambda: entry_pair(x, *ops4, leading_relu0=lead),
            "stream": lambda: entry_pair(x, *ops4, leading_relu0=lead, col_sums=False,
                                         mid_fp32=True),
            "stream2": lambda: entry_pair(x, *ops4, leading_relu0=lead, col_sums=False),
            # the first design: per unit the tiled depthwise into a0 / a1, then the GEMM
            "units": lambda: sepconv_unit(
                sepconv_unit(x, *ops4[:3], leading_relu=lead, trailing_relu=True), *ops4[3:],
                leading_relu=False, trailing_relu=False),
            "library": lambda: u1(torch.relu(u0(torch.relu(x) if lead else x))),
        }, 5)
        for name in total:
            total[name] += ms[name]
        M = N * H * W
        ops = 2 * M * (Cin * Cmid + Cmid * Cout)
        nbytes = 2 * (x.numel() + M * Cout + Cmid * Cin + Cout * Cmid)
        b_ms, by = bound_ms(nbytes, ops, PEAK_BF16)
        bound[by] += b_ms
        say(f"time K4 pair of block {(1, 2, 3, 12)[k]} ({N},{H},{W},{Cin}) {Cin}->{Cmid}->{Cout} "
            f"bf16: kernel {ms['kernel']:.4f} ms ({ops / ms['kernel'] / 1e9:.1f} TFLOP/s on the "
            f"pointwise; stream switches {ms['stream']:.4f} ms, stream2 without dx_roll "
            f"{ms['stream2']:.4f} ms), four-launch pair (two K5 units) {ms['units']:.4f} ms, "
            f"plain {ms['plain']:.4f} ms, cuDNN + cuBLAS pair "
            f"{ms['library']:.4f} ms, bound {b_ms:.4f} ms ({by}); runs {runs} [{smi}]")
        del x
    by = max(bound, key=bound.get)
    say(f"time K4, 4 pairs of {of}: kernel {total['kernel']:.4f} ms (stream switches "
        f"{total['stream']:.4f} ms, stream2 without dx_roll {total['stream2']:.4f} ms), "
        f"four-launch pair {total['units']:.4f} ms, plain "
        f"{total['plain']:.4f} ms, cuDNN + cuBLAS {total['library']:.4f} ms, bound "
        f"{sum(bound.values()):.4f} ms (mostly {by}) [{smi}]")
    return total, (sum(bound.values()), by)


def time_k5(torch, scorer, smi: str, shapes=K5_CONVS, of: str = "256 frames"):
    """K5 per exit conv (conv3, conv4) of the scorer's bf16 backbone with the
    route's switches, on random input at ``shapes`` (by default 256 frames at
    8^2): the kernel, its
    plain version, and the library yardstick, the folded unit through cuDNN
    depthwise and cuBLAS 1x1 and a ReLU. Returns the times and the bound,
    each summed over the two convs."""
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.sepconv_unit import (
        sepconv_unit,
        sepconv_unit_ref,
    )

    fb = scorer.folded_backbone
    total = dict.fromkeys(("kernel", "plain", "library"), 0.0)
    bound = {"bytes": 0.0, "operations": 0.0}
    for k, (conv, (N, H, Cin, Cout, lead, trail, _)) in enumerate(zip((fb.conv3, fb.conv4),
                                                                       shapes)):
        assert conv.k5_pw.shape[0] == Cout and conv.k5_dw.shape[1] == Cin
        gx = torch.Generator("cuda").manual_seed(900 + k)
        x = torch.randn((N, H, H, Cin), generator=gx, device="cuda").to(torch.bfloat16)
        ops5 = (conv.k5_dw, conv.k5_pw, conv.k5_b)
        kw = dict(leading_relu=lead, trailing_relu=trail)
        ms, runs = in_turns(torch, {
            "plain": lambda: sepconv_unit_ref(x, *ops5, **kw),
            "kernel": lambda: sepconv_unit(x, *ops5, **kw),
            "library": lambda: torch.relu(conv(x)),
        }, 20)
        halves = device_halves(torch, f"K5 call (conv{3 + k})",
                               lambda: sepconv_unit(x, *ops5, **kw), {"depthwise": 1, "GEMM": 1})
        for name in total:
            total[name] += ms[name]
        M = N * H * H
        ops = 2 * M * Cin * Cout
        b_ms, by = bound_ms(2 * (x.numel() + M * Cout + Cout * Cin), ops, PEAK_BF16)
        bound[by] += b_ms
        say(f"time K5 conv{3 + k} ({N},{H},{H},{Cin})->{Cout} bf16: kernel {ms['kernel']:.4f} ms "
            f"({ops / ms['kernel'] / 1e9:.1f} TFLOP/s on the pointwise), plain "
            f"{ms['plain']:.4f} ms, cuDNN + cuBLAS unit {ms['library']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({by}); device us per launch: {per_launch(halves)}; runs {runs} "
            f"[{smi}]")
    by = max(bound, key=bound.get)
    say(f"time K5, conv3 + conv4 of {of}: kernel {total['kernel']:.4f} ms, plain "
        f"{total['plain']:.4f} ms, cuDNN + cuBLAS {total['library']:.4f} ms, bound "
        f"{sum(bound.values()):.4f} ms (mostly {by}) [{smi}]")
    return total, (sum(bound.values()), by)


def profile_calls(torch, scorers: dict, frames, smi: str, top: int = 15) -> None:
    """One ``score()`` call of each scorer under ``torch.profiler``: device
    busy time against the host clock, and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    for name, scorer in scorers.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            scorer.score(frames)
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        kernels.sort(key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        say(f"profile {name}: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms on the host clock "
            f"(idle share {1 - busy_ms / wall_ms:.3f}) [{smi}]")
        for e in kernels[:top]:
            say(f"profile {name}:   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
                f"{e.key[:240]}")


# Phase 7, the AU engines: full width (AU-face lstm_hidden 256, tokens of
# 512; AU-patch hidden 128, lstm_hidden 128), 17 AUs, faces of 224^2 and
# patches of 128^2. The CLI scores clips of these lengths; the timed batch
# is 8 clips of 16 frames, the reference's train_au_face defaults.
AU_T = (16, 9, 5)
AU_CLIPS, AU_FRAMES, NUM_AUS, FACE, PATCH = 8, 16, 17, 224, 128
AU_CPU_FRAMES = 2  # the card's fp32 scorer against the CPU's: 1 clip of 2 frames
# w8a8 against plain fp32: (min cosine of per-image features and pooled
# embeddings, max score |d|), between the sound readings, 1 - cos <= 2.07e-4
# and |d| <= 6.21e-4, and the clipping calibration's, 1 - cos >= 4.38e-3 and
# |d| >= 6.07e-3, of either engine (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
AU_QUANT_FP32_BARS = (1 - 1e-3, 2e-3)


def write_au_bundles(torch, workdir: str) -> dict:
    """Seeded full-width AU-face and AU-patch models with random BN
    statistics, in the JAX bundle format -> {engine: path}."""
    from multimodal_deepfake_detection_tpu_torch.core.checkpoint import save_bundle
    from multimodal_deepfake_detection_tpu_torch.models.au_face import AUFaceDetector
    from multimodal_deepfake_detection_tpu_torch.models.resnet_lstm import AUPatchClassifier
    from multimodal_deepfake_detection_tpu_torch.ops.conv import BatchNorm
    from multimodal_deepfake_detection_tpu_torch.utils.jax_weights import (
        au_face_to_jax,
        au_patch_to_jax,
    )

    paths = {}
    for engine, seed, make, to_jax in (
            ("au_face", 7, lambda g: AUFaceDetector(256, generator=g), au_face_to_jax),
            ("au_patch", 8, lambda g: AUPatchClassifier(128, 128, generator=g), au_patch_to_jax)):
        g = torch.Generator().manual_seed(seed)
        model = make(g)
        with torch.no_grad():
            for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
                n = bn.mean.shape[0]
                bn.scale.copy_(0.8 + 0.4 * torch.rand(n, generator=g))
                bn.bias.copy_(0.05 * torch.randn(n, generator=g))
                bn.mean.copy_(0.1 * torch.randn(n, generator=g))
                bn.var.copy_(0.5 + torch.rand(n, generator=g))
        params, state = to_jax(model)
        paths[engine] = os.path.join(workdir, f"{engine}.npz")
        save_bundle(paths[engine], {"model": params, "state": state})
    return paths


def write_au_inputs(workdir: str) -> dict:
    """``.npy`` inputs of T in AU_T: AU-patch stacks (the second as float in
    [0, 1], the third with a ``_weights.npy`` sibling), and faces with AU
    stacks paired by stem (the third face stack as float)."""
    rng = np.random.default_rng(71)
    dirs = {k: os.path.join(workdir, k) for k in ("au_patches", "faces", "aus")}
    for d in dirs.values():
        os.makedirs(d)
    for i, t in enumerate(AU_T):
        patches = rng.integers(0, 256, (t, NUM_AUS, PATCH, PATCH, 3), dtype=np.uint8)
        np.save(os.path.join(dirs["au_patches"], f"p{i}.npy"),
                patches.astype(np.float32) / 255.0 if i == 1 else patches)
        if i == 2:
            np.save(os.path.join(dirs["au_patches"], f"p{i}_weights.npy"),
                    rng.uniform(0.1, 1.0, (t, NUM_AUS)).astype(np.float32))
        face = rng.integers(0, 256, (t, FACE, FACE, 3), dtype=np.uint8)
        np.save(os.path.join(dirs["faces"], f"c{i}.npy"),
                face.astype(np.float32) / 255.0 if i == 2 else face)
        np.save(os.path.join(dirs["aus"], f"c{i}.npy"),
                rng.integers(0, 256, (t, NUM_AUS, PATCH, PATCH, 3), dtype=np.uint8))
    return dirs


def au_outputs(torch, scorer, args, streams: dict):
    """Scores, the per-image ResNet-18 features of every stream (fp64, on the
    host) and the pooled embeddings of ``scorer`` on ``score(*args)`` (which
    calibrates a quantized scorer not yet calibrated)."""
    scores = scorer.score(*args)
    feats = torch.cat([scorer.features(k, u8).double().cpu() for k, u8 in streams.items()])
    return scores, feats, scorer.embed(*args).double().cpu()


def au_held(torch, label, a, b, bars, *, control: bool = False) -> float:
    """Min cosine of the per-image features and of the pooled embeddings,
    max score |d| of ``au_outputs`` ``a`` and ``b`` against ``bars =
    (cos_min, score_tol)``; a control must fail them. Returns 1 - cos min."""
    cos_f = torch.nn.functional.cosine_similarity(a[1], b[1], dim=-1).min().item()
    cos_e = torch.nn.functional.cosine_similarity(a[2], b[2], dim=-1).min().item()
    score_d = float(np.abs(a[0] - b[0]).max())
    ok = min(cos_f, cos_e) >= bars[0] and score_d <= bars[1]
    verdict = ("; control: fails, as it must" if not ok else "; control: PASSES") if control else ""
    say(f"{label}: per-image feature 1 - cos max {1 - cos_f:.3e}, pooled embedding 1 - cos max "
        f"{1 - cos_e:.3e} (<= {1 - bars[0]:.1e}), score max|d| {score_d:.3e} (<= {bars[1]:.1e}); "
        f"scores {np.round(a[0], 4).tolist()}{verdict}")
    if ok == control:
        raise AssertionError(f"{label}: " + ("the control passes the bars" if control
                                             else "disagreement"))
    return 1 - min(cos_f, cos_e)


def au_engine_inputs(engine: str, dirs: dict):
    """The CLI's argv, its Config, the paths it scores as one chunk, the
    chunk's ``score`` arguments and each stream's real (unpadded) images."""
    from multimodal_deepfake_detection_tpu_torch.cli import serve as cli_serve

    if engine == "au_patch":
        argv = ["--engine", "au_patch", "--input", dirs["au_patches"]]
    else:
        argv = ["--engine", "au_face", "--input", dirs["faces"], "--au_input", dirs["aus"]]
    cfg = cli_serve.parse_config(argv)
    paths = cli_serve._list_inputs(cfg.input, (".npy",))
    if engine == "au_patch":
        args = cli_serve.au_patch_args(cfg, paths)
        streams = {"backbone": np.concatenate([args[0][i, :n] for i, n in enumerate(args[2])])}
    else:
        args = cli_serve.au_face_args(cfg, paths)
        streams = {
            "face_backbone": np.concatenate([args[0][i, :t] for i, t in enumerate(AU_T)]),
            "au_backbone": np.concatenate([args[1][i, :t] for i, t in enumerate(AU_T)])}
    return argv + ["--batch_size", "8"], cfg, paths, args, streams


def au_clipped(scorer, args_flat: dict) -> dict:
    """Each stream's int8 tree from a calibration that clips: every
    activation scale halved."""
    from multimodal_deepfake_detection_tpu_torch.models.quant import (
        calibrate_resnet18_amax,
        quantize_folded_resnet18,
    )

    out = {}
    for key, fp in scorer.fp_trees.items():
        amaxes = calibrate_resnet18_amax(fp, scorer._flat(key, args_flat[key]),
                                         compute_dtype=scorer.compute_dtype)
        out[key] = quantize_folded_resnet18(fp, amaxes, headroom=0.5)
    return out


def phase_au(torch, workdir: str, smi: str) -> None:
    """The AU-face and AU-patch serving paths (phase 7)."""
    from multimodal_deepfake_detection_tpu_torch.models.serve import AUFaceScorer, AUPatchScorer

    t_phase = time.perf_counter()
    bundles = write_au_bundles(torch, workdir)
    dirs = write_au_inputs(workdir)
    classes = {"au_face": AUFaceScorer, "au_patch": AUPatchScorer}
    cli_buckets = (25, 50, 75)  # the CLI's default buckets, as the scorers below take them
    no_kernels = per_call(0)
    for engine, cls in classes.items():
        argv, cfg, paths, args, streams = au_engine_inputs(engine, dirs)
        argv += ["--ckpt_path", bundles[engine]]
        make = lambda **kw: cls.from_bundle(bundles[engine], device="cuda", buckets=cli_buckets,
                                            **kw)
        plain = make(compute_dtype=torch.float32)
        ref = au_outputs(torch, plain, args, streams)
        # the CLI, bf16 and w8a8: no kernel of the port's own on this path
        for mode, flags in (("bf16", []), ("w8a8", ["--quantize", "w8a8"])):
            cli = run_cli(torch, workdir, argv, f"{engine} CLI {mode}", flags, no_kernels,
                          len(AU_T))
            scorer = make(quantize="w8a8" if mode == "w8a8" else None)
            got = counted(torch, f"{engine} {mode} ({cls.__name__})",
                          lambda: au_outputs(torch, scorer, args, streams), no_kernels)
            d = np.abs(got[0] - cli).max()
            say(f"{engine} CLI {mode} vs {cls.__name__} on the CLI's batch: score max|d| "
                f"{d:.3e} (<= 1e-5; the JSONL keeps 6 places)")
            if d > 1e-5:
                raise AssertionError(f"the {engine} CLI's {mode} scores differ from the scorer's")
            if mode == "bf16":
                au_held(torch, f"{engine} bf16 vs plain fp32", got, ref,
                        (FEATURE_COS_MIN, SCORE_TOL))
                continue
            au_held(torch, f"{engine} w8a8 vs plain fp32", got, ref, AU_QUANT_FP32_BARS)
            sound = scorer.qbackbones
            flat = ({"backbone": args[0]} if engine == "au_patch"
                    else {"face_backbone": args[0], "au_backbone": args[1]})
            scorer.qbackbones = au_clipped(scorer, flat)
            au_held(torch, f"control {engine} w8a8, clipping calibration, vs plain fp32",
                    au_outputs(torch, scorer, args, streams), ref, AU_QUANT_FP32_BARS,
                    control=True)
            scorer.qbackbones = sound
        # refinement: no further from plain fp32 than the unrefined calibration
        calib = args[:1] if engine == "au_patch" else args[:2]
        rel = []
        for passes in (0, 1):
            scorer = make(quantize="w8a8")
            scorer.calibrate(*calib, refine_passes=passes)
            got = au_outputs(torch, scorer, args, streams)
            rel.append(((got[1] - ref[1]).norm() / ref[1].norm()).item())
            say(f"{engine} w8a8 refine_passes={passes} vs plain fp32: per-image features "
                f"relative error {rel[-1]:.4e}, score max|d| {np.abs(got[0] - ref[0]).max():.3e}")
        if rel[1] > rel[0]:
            raise AssertionError(f"{engine}: the refined calibration is further from plain fp32")
        # the card's fp32 scorer against the CPU's, torch's default TF32 flags in force
        small = tuple(a[:1, :AU_CPU_FRAMES] for a in args[:2]) + (
            (np.minimum(args[2][:1], AU_CPU_FRAMES),) if engine == "au_patch"
            else (args[2][:1, :AU_CPU_FRAMES],))
        small_streams = {k: v[:AU_CPU_FRAMES] for k, v in streams.items()}
        got = au_outputs(torch, plain, small, small_streams)
        cpu = au_outputs(torch, cls.from_bundle(bundles[engine], device="cpu",
                                                compute_dtype=torch.float32), small, small_streams)
        df = max((got[i] - cpu[i]).abs().max().item() for i in (1, 2))
        ds = float(np.abs(got[0] - cpu[0]).max())
        say(f"{engine} fp32 on the card (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"outside the call) vs the CPU: features and embedding max|d| {df:.3e}, score "
            f"max|d| {ds:.3e}")
        for i in (1, 2):
            torch.testing.assert_close(got[i], cpu[i], rtol=1e-3, atol=2e-4)
        if ds > 1e-4:
            raise AssertionError(f"{engine}: the card's fp32 scores differ from the CPU's")
        del plain
        torch.cuda.empty_cache()
    au_times(torch, bundles, smi)
    say(f"phase 7 (AU engines) took {time.perf_counter() - t_phase:.1f} s")


def au_batch(engine: str):
    """The timed batch: 8 clips of 16 frames, 17 AUs, faces of 224^2 and
    patches of 128^2, uint8 -> ``score`` arguments."""
    rng = np.random.default_rng(72)
    patches = rng.integers(0, 256, (AU_CLIPS, AU_FRAMES, NUM_AUS, PATCH, PATCH, 3),
                           dtype=np.uint8)
    if engine == "au_patch":
        return (patches,)
    return rng.integers(0, 256, (AU_CLIPS, AU_FRAMES, FACE, FACE, 3), dtype=np.uint8), patches


def au_times(torch, bundles: dict, smi: str) -> None:
    """``score()`` of the timed batch, bf16 and w8a8 in turns (host clock,
    around calls that return host scores); the pageable H2D copy of the
    batch alone; one profile per engine and mode."""
    from multimodal_deepfake_detection_tpu_torch.models.serve import AUFaceScorer, AUPatchScorer

    for engine, cls in (("au_face", AUFaceScorer), ("au_patch", AUPatchScorer)):
        args = au_batch(engine)
        scorers = {"bf16": cls.from_bundle(bundles[engine], device="cuda"),
                   "w8a8": cls.from_bundle(bundles[engine], device="cuda", quantize="w8a8")}
        nbytes = sum(a.nbytes for a in args)
        copy_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a in args:
                torch.from_numpy(a).to(scorers["bf16"].device)
            torch.cuda.synchronize()
            copy_ms.append((time.perf_counter() - t0) * 1e3)
        say(f"time {engine} H2D copy of the batch's uint8 inputs ({nbytes / 1e6:.1f} MB, "
            f"pageable): {min(copy_ms):.2f} ms ({nbytes / min(copy_ms) / 1e6:.1f} GB/s); runs "
            f"{copy_ms} [{smi}]")
        for sc_ in scorers.values():
            sc_.score(*args)  # warm-up; calibrates the w8a8 scorer on this batch
        call_ms = {name: [] for name in scorers}
        for name in list(scorers) + list(scorers)[::-1]:  # in turns
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                scorers[name].score(*args)  # returns host scores: synchronised
            call_ms[name].append((time.perf_counter() - t0) / 3 * 1e3)
        for name, runs in call_ms.items():
            ms = float(np.mean(runs))
            say(f"time {engine} B={AU_CLIPS} T={AU_FRAMES} A={NUM_AUS} {name}: {ms:.2f} ms/call, "
                f"{AU_CLIPS / ms * 1e3:.1f} clips/s, {AU_CLIPS * AU_FRAMES / ms * 1e3:.1f} "
                f"frames/s; runs {runs} [{smi}]")
        au_profile(torch, engine, scorers, args, min(copy_ms), smi)
        del scorers
        torch.cuda.empty_cache()


def au_profile(torch, engine: str, scorers: dict, args, copy_ms: float, smi: str,
               top: int = 12) -> None:
    """One ``score()`` per scorer under ``torch.profiler``: device busy time
    against the host clock, the H2D copies' device time (beside
    ``copy_ms``, the copy timed alone), the top device ops."""
    from torch.profiler import ProfilerActivity, profile

    for name, scorer in scorers.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            scorer.score(*args)
            wall_ms = (time.perf_counter() - t0) * 1e3
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        ops.sort(key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
        h2d_ms = sum(e.self_device_time_total for e in ops if "HtoD" in e.key) / 1e3
        h2d = f"H2D copy records {h2d_ms:.2f} ms of the busy time"
        if h2d_ms < copy_ms / 2:  # the profiler on the card drops records (PERF.md §6)
            h2d += (f", against {copy_ms:.2f} ms for the copy alone: the idle share counts the "
                    f"copies the profiler dropped")
        say(f"profile {engine} {name}: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms on the "
            f"host clock (idle share {1 - busy_ms / wall_ms:.3f}); {h2d} [{smi}]")
        for e in ops[:top]:
            say(f"profile {engine} {name}:   {e.self_device_time_total / 1e3:8.3f} ms  "
                f"x{e.count:<5d} {e.key[:200]}")


# ---------------------------------------------------------------------------
# Phase 8: visual training (cli/train_visual.py). No TPU kernel lies on it:
# the JAX trainer runs the live-BN Xception on XLA convs; here cuDNN, cuBLAS
# and autograd.
# ---------------------------------------------------------------------------

TRAIN_HIDDEN = 128
TRAIN_CPU = (2, 2, 64)  # B, T, H = W of the one SGD step on the card and on the CPU
TRAIN_SGD_LR = 0.05
TRAIN_CLIP = 1.0  # the CLI's clip
# card against CPU, fp32 (IEEE on both): the loss's relative |d|, each running
# statistic's max |d| over its tensor's largest, every parameter's post-step
# delta's max |d| over the largest delta of all (the global delta). Sound
# 1.71e-6, 3.44e-6, 8.35e-5 here; at tests/test_torch_train_gpu.py's weights
# the deltas read 3.63e-2 (fp32 roundoff of the card's weight gradients: its
# fp64 step there passes the fp64 bars). The control (torch.var's two-pass
# unbiased variance in the BN) 2.87e-3, 3.16e-2, 0.377 (H100 80GB HBM3, 700 W)
TRAIN_CPU_BARS = {"loss": 1e-5, "stats": 1e-4, "deltas": 1e-1}
# the same step in fp64 on both: the port's train step is the same function
# on the card, to roundoff
TRAIN_CPU_BARS_FP64 = {"loss": 1e-12, "stats": 1e-10, "deltas": 1e-9}
TRAIN_STEP = (4, 50, 224)  # the CLI defaults: batch 4, the 50-frame bucket, 224^2
TRAIN_TIMED_STEPS = 5
TRAIN_GRAD = (2, 8, 224)  # bf16 against fp32 gradients
# min cosine over the top-level subtrees: sound 1 - cos <= 0.2265 (the backbone;
# the JAX package's bf16 backbone gradient is as far from its fp32 one), the
# control (the backbone's BN on running statistics) >= 0.9898 (H100, 700 W)
TRAIN_GRAD_COS_MIN = 0.5
OVERFIT = dict(batch=(4, 4, 112), steps=25, lr=1e-4, fall=0.3)
TRAIN_TREE = dict(n_per_class=4, frames=8, size=224)


class _Patched:
    """``setattr(obj, name, value)`` for the ``with`` block: a control's
    wrong piece put in the program's place."""

    def __init__(self, obj, name, value):
        self.obj, self.name, self.value = obj, name, value

    def __enter__(self):
        self.before = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.before)


def bn_two_pass_unbiased(torch):
    """The control's BN: ``torch.var``'s two-pass, unbiased variance (its
    default) in the normalisation, in place of the single-pass biased one."""
    from multimodal_deepfake_detection_tpu_torch.core.precision import at_least_f32

    def batch_norm_train(x, scale, bias, eps: float = 1e-5):
        xf = at_least_f32(x)
        dims = tuple(range(x.ndim - 1))
        mean, var = xf.mean(dim=dims), xf.var(dim=dims)
        out = (xf - mean) * (torch.rsqrt(var + eps) * scale) + bias
        return out.to(x.dtype), mean.detach(), var.detach()
    return batch_norm_train


def train_batch(B, T, H, seed, lengths=None):
    rng = np.random.default_rng(seed)
    video = rng.random((B, T, H, H, 3), dtype=np.float32)
    labels = (np.arange(B) % 2).astype(np.float32)
    lengths = np.full((B,), T, np.int32) if lengths is None else np.asarray(lengths, np.int32)
    return video, labels, lengths


def train_model(torch, seed: int):
    from multimodal_deepfake_detection_tpu_torch.models.heads import XceptionLSTMArcFace

    return XceptionLSTMArcFace(TRAIN_HIDDEN, generator=torch.Generator().manual_seed(seed))


def loss_forward_of(torch, cdtype, bb_eval: bool = False):
    from multimodal_deepfake_detection_tpu_torch.cli import train_visual as tv

    forward = tv.make_forward(tv.Config(), cdtype)

    def loss_forward(model, rng_seed, batch):
        loss, bn_stats, probs = forward(model, batch, True, bb_eval)
        return loss, (bn_stats, probs)
    return loss_forward


def sgd_step(torch, state_dict, batch, device, dtype=None):
    """One SGD step (the CLI's forward and clip, make_train_step) in IEEE
    fp32, or in ``dtype``, from ``state_dict``: the loss, post-step
    parameters and buffers."""
    from multimodal_deepfake_detection_tpu_torch.cli.train_visual import to_device
    from multimodal_deepfake_detection_tpu_torch.core.precision import ieee_fp32
    from multimodal_deepfake_detection_tpu_torch.train import TrainState
    from multimodal_deepfake_detection_tpu_torch.train.optim import Optimizer
    from multimodal_deepfake_detection_tpu_torch.train.steps import make_train_step

    dtype = dtype or torch.float32
    model = train_model(torch, 0)
    model.load_state_dict(state_dict)
    model.to(device, dtype)
    opt = Optimizer(torch.optim.SGD(model.parameters(), lr=TRAIN_SGD_LR), grad_clip=TRAIN_CLIP)
    video, labels, lengths = to_device(batch, torch.device(device))
    with ieee_fp32():
        _, loss, _ = make_train_step(loss_forward_of(torch, dtype))(
            TrainState(0, model, opt), (video.to(dtype), labels, lengths), 0)
    snap = lambda named: {n: t.detach().double().cpu() for n, t in named}
    return float(loss), snap(model.named_parameters()), snap(model.named_buffers())


def step_errors(ref, got, p0) -> dict:
    """Loss relative |d|; running statistics max |d| over each tensor's
    largest; post-step deltas max |d| over the largest delta of all."""
    d_ref = {n: ref[1][n] - p0[n] for n in p0}
    d_got = {n: got[1][n] - p0[n] for n in p0}
    global_delta = max(d.abs().max().item() for d in d_ref.values())
    return {
        "loss": abs(got[0] - ref[0]) / abs(ref[0]),
        "stats": max(((got[2][n] - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                     for n, b in ref[2].items()),
        "deltas": max((d_got[n] - d_ref[n]).abs().max().item() for n in p0) / global_delta,
        "clipped_norm": float(np.sqrt(sum((d ** 2).sum().item() for d in d_ref.values()))
                              / TRAIN_SGD_LR),
    }


def train_card_vs_cpu(torch, smi: str) -> None:
    """Phase 8a: one SGD step at full width on the card and on the CPU from
    the same weights, in fp32 (TF32 off on the card) and in fp64, each with
    its control."""
    from multimodal_deepfake_detection_tpu_torch.ops import conv as conv_mod
    from multimodal_deepfake_detection_tpu_torch.train import optim as optim_mod

    B, T, H = TRAIN_CPU
    batch = train_batch(B, T, H, 80, lengths=(T,) + (1,) * (B - 1))
    model = train_model(torch, 80)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    p0 = {n: p.detach().double() for n, p in model.named_parameters()}
    runs = {}
    for dtype, bars in ((torch.float32, TRAIN_CPU_BARS), (torch.float64, TRAIN_CPU_BARS_FP64)):
        name = str(dtype).split(".")[-1]
        cpu = sgd_step(torch, sd, batch, "cpu", dtype)
        card = sgd_step(torch, sd, batch, "cuda", dtype)
        runs[name] = cpu, card
        err = step_errors(cpu, card, p0)
        say(f"train step {name}, card vs CPU (B={B} T={T} {H}^2, hidden {TRAIN_HIDDEN}, SGD "
            f"{TRAIN_SGD_LR}, clip {TRAIN_CLIP}: clipped grad norm {err['clipped_norm']:.4f}): "
            f"loss rel |d| {err['loss']:.3e} (<= {bars['loss']:.0e}); running stats "
            f"{err['stats']:.3e} (<= {bars['stats']:.0e}); deltas over the global delta "
            f"{err['deltas']:.3e} (<= {bars['deltas']:.0e}) [{smi}]")
        with _Patched(conv_mod, "batch_norm_train", bn_two_pass_unbiased(torch)):
            ctl = step_errors(cpu, sgd_step(torch, sd, batch, "cuda", dtype), p0)
        failed = any(ctl[k] > bars[k] for k in bars)
        say(f"control {name}, BN with torch.var's two-pass unbiased variance, card vs CPU: "
            f"loss {ctl['loss']:.3e}, running stats {ctl['stats']:.3e}, deltas "
            f"{ctl['deltas']:.3e}" + ("; control: fails, as it must" if failed
                                      else "; control: PASSES"))
        if any(err[k] > bars[k] for k in bars):
            raise AssertionError(f"the card's {name} train step differs from the CPU's: {err}")
        if not failed:
            raise AssertionError(f"the BN-variance control passes the {name} bars")
        if dtype == torch.float32:
            cpu32, err32 = cpu, err
    say(f"reading, fp32 against the CPU's fp64 step, deltas over the global delta: the CPU's "
        f"{step_errors(runs['float64'][0], runs['float32'][0], p0)['deltas']:.3e}, the "
        f"card's {step_errors(runs['float64'][0], runs['float32'][1], p0)['deltas']:.3e}")

    def torch_clip(grads, max_norm):  # clip_grad_norm_'s arithmetic
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, (max_norm / (norm + 1e-6)).clamp(max=1.0))

    with _Patched(optim_mod, "clip_by_global_norm_", torch_clip):
        rd = step_errors(cpu32, sgd_step(torch, sd, batch, "cuda"), p0)
    say(f"reading, torch's clip_grad_norm_ arithmetic (norm + 1e-6) on the card vs the optax "
        f"clip on the CPU, fp32: deltas {rd['deltas']:.3e} (a relative change of 1e-6 / "
        f"{err32['clipped_norm']:.4f} in every delta when the clip binds)")


def grads_by_subtree(torch, model, batch, cdtype, bb_eval: bool = False) -> dict:
    from multimodal_deepfake_detection_tpu_torch.cli.train_visual import to_device
    from multimodal_deepfake_detection_tpu_torch.core.precision import ieee_fp32

    model.zero_grad(set_to_none=True)
    with ieee_fp32():
        loss, _ = loss_forward_of(torch, cdtype, bb_eval)(model, 0,
                                                          to_device(batch, torch.device("cuda")))
        loss.backward()
    out = {}
    for name, child in model.named_children():
        gs = [p.grad.double().flatten() for p in child.parameters() if p.grad is not None]
        if gs:
            out[name] = torch.cat(gs)
    return float(loss.detach()), out


def train_grad_cos(torch, smi: str) -> None:
    """bf16 gradients against fp32 on the same batch, per top-level subtree;
    the control runs the backbone's BN on its running statistics (the
    ``backbone_bn_eval`` mode) where training uses batch statistics."""
    B, T, H = TRAIN_GRAD
    batch = train_batch(B, T, H, 82)
    model = train_model(torch, 82).cuda()
    _, ref = grads_by_subtree(torch, model, batch, torch.float32)

    def cos_of(got):
        return {k: torch.nn.functional.cosine_similarity(got[k], ref[k], dim=0).item()
                for k in ref}
    _, g = grads_by_subtree(torch, model, batch, torch.bfloat16)
    sound = cos_of(g)
    _, g = grads_by_subtree(torch, model, batch, torch.bfloat16, bb_eval=True)
    ctl = cos_of(g)
    fmt = lambda c: ", ".join(f"{k} 1 - cos {1 - v:.3e}" for k, v in c.items())
    say(f"train grads bf16 vs fp32 (B={B} T={T} {H}^2): {fmt(sound)} (<= "
        f"{1 - TRAIN_GRAD_COS_MIN}) [{smi}]")
    say(f"control, bf16 with the backbone's BN on its running statistics: {fmt(ctl)}"
        + ("; control: fails, as it must" if min(ctl.values()) < TRAIN_GRAD_COS_MIN
           else "; control: PASSES"))
    if min(sound.values()) < TRAIN_GRAD_COS_MIN:
        raise AssertionError(f"bf16 gradients far from fp32: {sound}")
    if min(ctl.values()) >= TRAIN_GRAD_COS_MIN:
        raise AssertionError("the bf16-statistics control passes the gradient bar")
    del model
    torch.cuda.empty_cache()


class _Clips:
    """A dataset of ``n`` zero clips, for ``train_visual.build`` (the timed
    batches are made apart)."""

    def __init__(self, n, shape):
        self.n, self.shape, self.all_labels = n, shape, [i % 2 for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.zeros(self.shape, np.float32), self.all_labels[i]


def train_times(torch, smi: str) -> None:
    """Phase 8b: the CLI's train step at its defaults (bf16, Adam 1e-5, the
    50-frame bucket), frozen and unfrozen, as the loop calls it (a host
    batch, copied through pinned memory): ms a step and frames/s from CUDA
    events, FLOPs counted by ``torch.utils.flop_counter``, peak memory, the
    device idle share and the top device ops of one step."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from multimodal_deepfake_detection_tpu_torch.cli import train_visual as tv

    B, T, H = TRAIN_STEP
    cfg = tv.Config(device="cuda")
    clips = _Clips(B, (T, H, H, 3))
    _, _, state, train_step, _ = tv.build(cfg, train_ds=clips, eval_ds=clips)
    batch = train_batch(B, T, H, 81)
    # FlopCounterMode counts a grouped conv's backward as a dense one, so only
    # the forward is counted; a step is taken as 3 forwards unfrozen (data and
    # weight gradients each about one), 1 frozen (no backbone backward)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        tv.make_forward(cfg, torch.bfloat16)(state.model, tv.to_device(batch, torch.device(
            "cuda")), True)
    fwd_flops = fc.get_total_flops()
    say(f"train step at the CLI defaults: B={B} x T={T} at {H}^2, {cfg.compute_dtype}, "
        f"hidden {cfg.hidden_dim}, Adam {cfg.lr} wd {cfg.weight_decay} clip {cfg.grad_clip}; "
        f"the host batch {sum(a.nbytes for a in batch) / 1e6:.1f} MB float32; forward "
        f"{fwd_flops / 1e12:.4f} TFLOP (FlopCounterMode)")
    for phase, epoch in (("frozen", 0), ("unfrozen", cfg.freeze_epochs)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = lambda: train_step(state, batch, 0, epoch)
        for _ in range(2):
            _, loss, _ = run()
        flops = fwd_flops * (1 if phase == "frozen" else 3)
        ms = cuda_ms(torch, run, TRAIN_TIMED_STEPS)
        _, loss, _ = run()
        loss = float(loss)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
        say(f"train step {phase}: {ms:.2f} ms a step ({B * T / ms * 1e3:.1f} frames/s), "
            f"{flops / 1e12:.3f} TFLOP ({flops / (ms / 1e3) / PEAK_BF16:.4f} of "
            f"989 TFLOP/s bf16), loss {loss:.4f}, peak memory {peak:.2f} GiB; profile: device "
            f"busy {busy_ms:.2f} ms of {wall_ms:.2f} ms (idle share "
            f"{1 - busy_ms / wall_ms:.3f}) [{smi}]")
        for e in ops[:12]:
            say(f"profile train {phase}:   {e.self_device_time_total / 1e3:8.3f} ms  "
                f"x{e.count:<5d} {e.key[:160]}")
        if not np.isfinite(loss):
            raise AssertionError(f"train step {phase}: loss {loss}")
    del state, train_step
    torch.cuda.empty_cache()


def train_overfit(torch, smi: str) -> None:
    """Phase 8c: Adam on one fixed batch, unfrozen, bf16: the loss falls;
    the control at lr = 0 does not."""
    from multimodal_deepfake_detection_tpu_torch.cli.train_visual import to_device
    from multimodal_deepfake_detection_tpu_torch.train import TrainState, make_optimizer
    from multimodal_deepfake_detection_tpu_torch.train.steps import make_train_step

    B, T, H = OVERFIT["batch"]
    batch = to_device(train_batch(B, T, H, 83), torch.device("cuda"))
    step = make_train_step(loss_forward_of(torch, torch.bfloat16))
    falls = {}
    for lr in (OVERFIT["lr"], 0.0):
        model = train_model(torch, 83).cuda()
        state = TrainState(0, model, make_optimizer(model.parameters(), "adam", lr,
                                                    weight_decay=1e-4, grad_clip=1.0))
        losses = [step(state, batch, i)[1] for i in range(OVERFIT["steps"])]
        losses = [float(v) for v in losses]
        falls[lr] = 1 - losses[-1] / losses[0]
        say(f"overfit B={B} T={T} {H}^2, Adam lr {lr}, {OVERFIT['steps']} steps: loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f} (falls {falls[lr]:.3f}; bar >= "
            f"{OVERFIT['fall']}) [{smi}]")
    if falls[OVERFIT["lr"]] < OVERFIT["fall"]:
        raise AssertionError("the loss did not fall on a fixed batch")
    if falls[0.0] >= OVERFIT["fall"]:
        raise AssertionError("control at lr = 0: the loss falls")
    say("control, lr = 0: fails the bar, as it must")


def train_then_serve(torch, workdir: str, smi: str) -> None:
    """Phase 8d: the CLI trains a synthetic tree for 2 epochs (fp32, one
    frozen), plain and from the feature cache; each best bundle is scored
    through ``cli/serve.py --engine visual`` (BN-folded, bf16, K1 counted)
    and held against the trainer's eval probabilities of the best epoch."""
    from multimodal_deepfake_detection_tpu_torch.cli import train_visual as tv
    from multimodal_deepfake_detection_tpu_torch.data.synthetic import make_face_npy_tree

    tree = make_face_npy_tree(os.path.join(workdir, "train_faces"), seed=84, **TRAIN_TREE)
    n_eval = 2 * TRAIN_TREE["n_per_class"]
    calls = -(-n_eval // BATCH_SIZE)
    for label, extra in (("plain", []), ("cache_features", ["--cache_features", "true",
                                                            "--shuffle", "false"])):
        ck = os.path.join(workdir, f"train_{label}")
        logs = []
        t0 = time.perf_counter()
        history = tv.main(["--train_folder", f"{tree}/train", "--eval_folder", f"{tree}/eval",
                           "--checkpoint_dir", ck, "--epochs", "2", "--freeze_epochs", "1",
                           "--eval_with_margin", "false", "--compute_dtype", "float32",
                           "--device", "cuda", *extra], log=logs.append)
        secs = time.perf_counter() - t0
        for line in logs:
            say(f"train_visual {label}: {line}")
        bundle = os.path.join(ck, tv.Config.bundle_name)
        if not os.path.exists(bundle) or len(history) != 2:
            raise AssertionError(f"train_visual {label}: no best bundle after 2 epochs")
        saves = [i for i, line in enumerate(logs) if line.startswith("new best model saved")]
        epochs = [i for i, line in enumerate(logs) if line.startswith("epoch ")]
        best = next(k for k, i in enumerate(epochs) if i > saves[-1])
        labels, probs = history[best].eval_scores
        scores = run_cli(torch, workdir, visual_argv(bundle, f"{tree}/eval"),
                         f"serve the {label} bundle", [], per_call(calls, k1=8), n_eval)
        d = float(np.abs(scores - probs).max())
        say(f"train_visual {label} ({secs:.1f} s, 2 epochs of {n_eval} clips x "
            f"{TRAIN_TREE['frames']} frames at {TRAIN_TREE['size']}^2): the served bundle "
            f"(folded, bf16, K1) vs the trainer's epoch-{best + 1} eval probs (unfolded, "
            f"fp32): max|d| {d:.3e} (<= {SCORE_TOL:.0e}); probs {np.round(probs, 4).tolist()} "
            f"[{smi}]")
        if d > SCORE_TOL or len(probs) != n_eval:
            raise AssertionError(f"the served {label} bundle disagrees with the trainer")


def phase_train(torch, workdir: str, smi: str) -> None:
    t_phase = time.perf_counter()
    with NoTF32(torch):
        train_card_vs_cpu(torch, smi)
    train_grad_cos(torch, smi)
    train_times(torch, smi)
    train_overfit(torch, smi)
    train_then_serve(torch, workdir, smi)
    say(f"phase 8 (visual training) took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 9: the audio, AU-patch and AU-face trainers (cli/train_audio.py,
# train_au_patch.py, train_au_face.py). No TPU kernel lies on them: the JAX
# trainers run the live-BN Xception and ResNet-18s on XLA convs; here cuDNN,
# cuBLAS and autograd. K1 runs where the trained audio bundle is served.
# ---------------------------------------------------------------------------

AU_KINDS = ("au_patch", "au_face", "audio")
# 9a, card against CPU: B, T, A (AUs), image side; the audio side is the
# MFCC step count (its images are 64^2)
AU_TRAIN_CPU = {"au_patch": (2, 2, 3, 32), "au_face": (2, 2, 3, 32), "audio": (2, 2, 0, 0)}
# 9b, each CLI's defaults: B x T x A patches (and B x T faces) at 128^2; audio
# B x T MFCC images of 64^2
AU_TRAIN_STEP = {"au_patch": (2, 60, 17, 128), "au_face": (2, 75, 17, 128),
                 "audio": (8, 120, 0, 64)}
AU_OVERFIT = {"au_patch": (2, 8, 17, 128), "au_face": (2, 8, 17, 128), "audio": (8, 20, 0, 0)}
AU_OVERFIT_STEPS, AU_OVERFIT_LR, AU_OVERFIT_FALL = 25, 1e-4, 0.3
# 9d: 2 real + 2 fake clips a split, 8 frames x 17 AUs at 128^2 (audio: 4 +
# 4 clips of 120 MFCC steps); the served logits within 2e-2 of the trained
# model's fp32 eval logits (audio: the head's probabilities)
AU_TREE = dict(frames=8, n_aus=17, size=128)
SERVE_TRAINED_TOL = 2e-2


def au_train_model(torch, kind: str, seed: int):
    """The trained tree of ``kind`` at the CLI's full width."""
    g = torch.Generator().manual_seed(seed)
    if kind == "au_patch":
        from multimodal_deepfake_detection_tpu_torch.models.resnet_lstm import AUPatchClassifier
        return AUPatchClassifier(128, 128, generator=g)
    if kind == "au_face":
        from multimodal_deepfake_detection_tpu_torch.cli.train_au_face import (
            AUFaceTrainModel,
            Config,
        )
        return AUFaceTrainModel(Config(), g)
    from multimodal_deepfake_detection_tpu_torch.models.heads import XceptionLSTM
    return XceptionLSTM(512, generator=g)


def au_train_batch(kind: str, shape, seed: int):
    """A host batch of ``kind`` in its CLI's layout (float32 as the loaders
    give it), the last clip one step short."""
    B, T, A, S = shape
    rng = np.random.default_rng(seed)
    labels = (np.arange(B) % 2).astype(np.float32)
    lengths = np.full((B,), T, np.int32)
    lengths[-1] = T - 1
    if kind == "audio":
        return rng.normal(0, 20, (B, T, 3, 13)).astype(np.float32), labels, lengths
    patches = rng.random((B, T, A, S, S, 3), dtype=np.float32)
    weights = rng.random((B, T, A), dtype=np.float32)
    patches[-1, -1], weights[-1, -1] = 0, 0  # the short clip's padding
    if kind == "au_patch":
        return (patches, weights), labels, lengths
    videos = rng.random((B, T, S, S, 3), dtype=np.float32)
    videos[-1, -1] = 0
    return (videos, patches, (weights > 0).astype(np.float32), weights), labels, lengths


def au_forward_of(torch, kind: str, cdtype, generator_of=None):
    """``loss_forward(model, rng_seed, batch)`` of ``kind``'s CLI at its
    default config in ``cdtype``; ``generator_of(rng_seed)`` draws the
    dropout (None: dropout off)."""
    gen = generator_of or (lambda seed: None)
    if kind == "au_patch":
        from multimodal_deepfake_detection_tpu_torch.cli import train_au_patch as cli
        fwd = cli.make_forward(cli.Config(), cdtype)
        run = lambda m, seed, b: fwd(m, b, True)
    elif kind == "au_face":
        from multimodal_deepfake_detection_tpu_torch.cli import train_au_face as cli
        from multimodal_deepfake_detection_tpu_torch.models.losses import cb_focal_class_weights
        fwd, _ = cli.make_forwards(cli.Config(), cdtype, cb_focal_class_weights([3, 1]))
        run = lambda m, seed, b: fwd(m, b, gen(seed))
    else:
        from multimodal_deepfake_detection_tpu_torch.cli import train_audio as cli
        fwd = cli.make_forward(cli.Config(), cdtype, False)
        run = lambda m, seed, b: fwd(m, b, True, gen(seed))

    def loss_forward(model, rng_seed, batch):
        loss, bn_stats, probs = run(model, rng_seed, batch)
        return loss, (bn_stats, probs)
    return loss_forward


def cast_batch(torch, batch, dtype):
    """Every floating tensor of a (nested) device batch to ``dtype``."""
    if isinstance(batch, tuple):
        return tuple(cast_batch(torch, b, dtype) for b in batch)
    return batch.to(dtype) if batch.is_floating_point() else batch


def au_sgd_step(torch, kind, state_dict, batch, device, dtype):
    """One SGD step of ``kind`` (the CLI's forward, dropout off, the optax
    clip; audio's backbone frozen) in ``dtype`` (IEEE fp32 on the card) from
    ``state_dict``: the loss, post-step parameters and buffers."""
    from multimodal_deepfake_detection_tpu_torch.cli.common import to_device
    from multimodal_deepfake_detection_tpu_torch.core.precision import ieee_fp32
    from multimodal_deepfake_detection_tpu_torch.train import TrainState
    from multimodal_deepfake_detection_tpu_torch.train.optim import Optimizer
    from multimodal_deepfake_detection_tpu_torch.train.steps import make_train_step

    model = au_train_model(torch, kind, 0)
    model.load_state_dict(state_dict)
    model.to(device, dtype)
    opt = Optimizer(torch.optim.SGD(model.parameters(), lr=TRAIN_SGD_LR), grad_clip=TRAIN_CLIP)
    b = cast_batch(torch, to_device(batch, torch.device(device)), dtype)
    frozen = ("backbone",) if kind == "audio" else ()
    with ieee_fp32():
        _, loss, _ = make_train_step(au_forward_of(torch, kind, dtype))(
            TrainState(0, model, opt), b, 0, frozen)
    snap = lambda named: {n: t.detach().double().cpu() for n, t in named}
    return float(loss), snap(model.named_parameters()), snap(model.named_buffers())


def au_train_card_vs_cpu(torch, smi: str) -> None:
    """Phase 9a: one SGD step of each trainer on the card and on the CPU from
    the same weights, fp64 and fp32, each with the BN-variance control."""
    from multimodal_deepfake_detection_tpu_torch.ops import conv as conv_mod

    for seed, kind in enumerate(AU_KINDS, start=90):
        batch = au_train_batch(kind, AU_TRAIN_CPU[kind], seed)
        model = au_train_model(torch, kind, seed)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        p0 = {n: p.detach().double() for n, p in model.named_parameters()}
        for dtype, bars in ((torch.float64, TRAIN_CPU_BARS_FP64), (torch.float32, TRAIN_CPU_BARS)):
            name = str(dtype).split(".")[-1]
            cpu = au_sgd_step(torch, kind, sd, batch, "cpu", dtype)
            card = au_sgd_step(torch, kind, sd, batch, "cuda", dtype)
            err = step_errors(cpu, card, p0)
            with _Patched(conv_mod, "batch_norm_train", bn_two_pass_unbiased(torch)):
                ctl = step_errors(cpu, au_sgd_step(torch, kind, sd, batch, "cuda", dtype), p0)
            failed = any(ctl[k] > bars[k] for k in bars)
            say(f"{kind} train step {name}, card vs CPU (B, T, A, side {AU_TRAIN_CPU[kind]}, "
                f"SGD {TRAIN_SGD_LR}, clip {TRAIN_CLIP}: clipped grad norm "
                f"{err['clipped_norm']:.4f}): loss rel |d| {err['loss']:.3e} (<= "
                f"{bars['loss']:.0e}); running stats {err['stats']:.3e} (<= {bars['stats']:.0e}); "
                f"deltas over the global delta {err['deltas']:.3e} (<= {bars['deltas']:.0e}) "
                f"[{smi}]")
            say(f"control {kind} {name}, BN with torch.var's two-pass unbiased variance: loss "
                f"{ctl['loss']:.3e}, running stats {ctl['stats']:.3e}, deltas "
                f"{ctl['deltas']:.3e}" + ("; control: fails, as it must" if failed
                                          else "; control: PASSES"))
            if any(err[k] > bars[k] for k in bars):
                raise AssertionError(f"the card's {kind} {name} step differs from the CPU's: {err}")
            if not failed:
                raise AssertionError(f"the BN-variance control passes the {kind} {name} bars")


def au_train_build(torch, kind: str, trees: dict, **overrides):
    """``kind``'s CLI ``build()`` at its defaults on the card (``trees``: the
    synthetic data roots the loaders need) -> ``(config, state, train_step)``."""
    from multimodal_deepfake_detection_tpu_torch.cli import train_au_face as tf
    from multimodal_deepfake_detection_tpu_torch.cli import train_au_patch as tp
    from multimodal_deepfake_detection_tpu_torch.cli import train_audio as ta

    if kind == "au_patch":
        cfg = tp.Config(data_root=trees["au_patch"], device="cuda", **overrides)
        _, _, _, state, train_step, _ = tp.build(cfg)
    elif kind == "au_face":
        cfg = tf.Config(video_root=trees["video"], au_root=trees["au_face"], device="cuda",
                        **overrides)
        _, _, _, state, train_step, _ = tf.build(cfg)
    else:
        cfg = ta.Config(train_folder=trees["audio"] + "/train",
                        eval_folder=trees["audio"] + "/eval", device="cuda", **overrides)
        _, _, state, train_step, _ = ta.build(cfg)
    return cfg, state, train_step


def n_images(kind: str, shape) -> int:
    B, T, A, _ = shape
    return B * T * (A + (kind == "au_face")) if kind != "audio" else B * T


def step_profile(torch, run) -> tuple:
    """One ``run()`` under ``torch.profiler``: (device ops by time, busy ms,
    wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    return ops, sum(e.self_device_time_total for e in ops) / 1e3, wall_ms


def au_train_times(torch, smi: str, trees: dict) -> None:
    """Phase 9b: each CLI's train step at its defaults (bf16), as the loop
    calls it (a float32 host batch, pinned and copied in the step): ms a
    step and images/s from CUDA events, forward FLOPs by
    ``torch.utils.flop_counter`` (a step counted as 3 forwards, audio's
    frozen backbone as 1), peak memory, the idle share and the top device
    ops of one profiled step. au_face: a micro-step and an optimizer step of
    4; audio: also the head-only step on cached features."""
    from torch.utils.flop_counter import FlopCounterMode

    from multimodal_deepfake_detection_tpu_torch.cli.common import to_device

    for seed, kind in enumerate(AU_KINDS, start=100):
        shape = AU_TRAIN_STEP[kind]
        cfg, state, train_step = au_train_build(torch, kind, trees)
        batch = au_train_batch(kind, shape, seed)
        def forward_flops(model, host_batch):
            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                au_forward_of(torch, kind, torch.bfloat16)(
                    model, 0, to_device(host_batch, torch.device("cuda")))
            return fc.get_total_flops()

        fwd = forward_flops(state.model, batch)
        flops = fwd * (1 if kind == "audio" else 3)
        imgs = n_images(kind, shape)
        runs = [("", lambda: train_step(state, batch, 0, 0), flops)]
        if kind == "audio":  # the frozen backbone's features cached: the head alone, x 3
            feats = (np.random.default_rng(seed).normal(0, 1, (shape[0], shape[1], 2048))
                     .astype(np.float32), batch[1], batch[2])
            _, cstate, cstep = au_train_build(torch, kind, trees, cache_features=True)
            runs.append((" head-only (cached features)", lambda: cstep(cstate, feats, 0, 0),
                         3 * forward_flops(cstate.model, feats)))
        say(f"{kind} train step at the CLI defaults: B, T, A, side {shape}, {imgs} images, "
            f"{cfg.compute_dtype}; host batch "
            f"{sum(a.nbytes for a in host_arrays(batch)) / 1e6:.1f} MB float32; forward "
            f"{fwd / 1e12:.4f} TFLOP (FlopCounterMode)")
        for label, run, flops in runs:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if kind == "au_face":  # start on an optimizer step's first micro-batch
                while state.optimizer.mini_step:
                    run()
            for _ in range(4 if kind == "au_face" else 2):
                run()
            if kind == "au_face":
                micro = []
                for _ in range(2):  # two optimizer steps, each call timed
                    for _ in range(cfg.accum_steps):
                        micro.append(cuda_ms(torch, run, 1))
                micro = np.array(micro).reshape(2, -1)
                ms = float(micro.sum(axis=1).mean())
                say(f"{kind} train calls: accumulating micro-steps "
                    f"{np.round(micro[:, :-1].mean(), 2)} ms, the optimizer step's call "
                    f"{np.round(micro[:, -1].mean(), 2)} ms; an optimizer step of "
                    f"{cfg.accum_steps}: {ms:.2f} ms")
                step_imgs, step_flops = imgs * cfg.accum_steps, flops * cfg.accum_steps
                prof_run = lambda: [run() for _ in range(cfg.accum_steps)]
            else:
                ms = cuda_ms(torch, run, TRAIN_TIMED_STEPS)
                step_imgs, step_flops, prof_run = imgs, flops, run
            loss = float(run()[1])
            peak = torch.cuda.max_memory_allocated() / 2**30
            ops, busy_ms, wall_ms = step_profile(torch, prof_run)
            share = step_flops / (ms / 1e3) / PEAK_BF16
            say(f"{kind} train step{label}: {ms:.2f} ms a step ({step_imgs / ms * 1e3:.1f} "
                f"images/s), {step_flops / 1e12:.3f} TFLOP ({share:.4f} of 989 TFLOP/s bf16), "
                f"loss {loss:.4f}, peak memory {peak:.2f} GiB; profile: "
                f"device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms (idle share "
                f"{1 - busy_ms / wall_ms:.3f}) [{smi}]")
            for e in ops[:12]:
                say(f"profile {kind} train{label}:   {e.self_device_time_total / 1e3:8.3f} ms  "
                    f"x{e.count:<5d} {e.key[:160]}")
            if not np.isfinite(loss):
                raise AssertionError(f"{kind} train step{label}: loss {loss}")
        del state, train_step, runs
        torch.cuda.empty_cache()


def no_grad(torch, fn, *args):
    with torch.inference_mode():
        return fn(*args)


def host_arrays(batch):
    """The arrays of a nested host batch."""
    if isinstance(batch, tuple):
        return [a for b in batch for a in host_arrays(b)]
    return [batch]


def au_train_overfit(torch, smi: str) -> None:
    """Phase 9c: 25 Adam steps (bf16, each trainer's forward, one fixed
    dropout draw) on one batch: the loss falls; the lr = 0 control's does
    not."""
    from multimodal_deepfake_detection_tpu_torch.cli.common import step_generator, to_device
    from multimodal_deepfake_detection_tpu_torch.train import TrainState, make_optimizer
    from multimodal_deepfake_detection_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda")
    for seed, kind in enumerate(AU_KINDS, start=110):
        batch = to_device(au_train_batch(kind, AU_OVERFIT[kind], seed), dev)
        step = make_train_step(au_forward_of(torch, kind, torch.bfloat16,
                                             lambda s: step_generator(dev, s)))
        frozen = ("backbone",) if kind == "audio" else ()
        falls = {}
        for lr in (AU_OVERFIT_LR, 0.0):
            model = au_train_model(torch, kind, seed).cuda()
            state = TrainState(0, model, make_optimizer(model.parameters(), "adam", lr,
                                                        grad_clip=1.0))
            losses = [float(step(state, batch, 0, frozen)[1]) for _ in range(AU_OVERFIT_STEPS)]
            falls[lr] = 1 - losses[-1] / losses[0]
            say(f"{kind} overfit {AU_OVERFIT[kind]}, Adam lr {lr}, {AU_OVERFIT_STEPS} steps: "
                f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (falls {falls[lr]:.3f}; bar >= "
                f"{AU_OVERFIT_FALL}) [{smi}]")
            del model, state
        if falls[AU_OVERFIT_LR] < AU_OVERFIT_FALL:
            raise AssertionError(f"{kind}: the loss did not fall on a fixed batch")
        if falls[0.0] >= AU_OVERFIT_FALL:
            raise AssertionError(f"{kind}: control at lr = 0: the loss falls")
        say(f"{kind} control, lr = 0: fails the bar, as it must")
        torch.cuda.empty_cache()


def au_train_trees(workdir: str) -> dict:
    """The synthetic trees the trainers read (9b builds on them, 9d trains)."""
    from multimodal_deepfake_detection_tpu_torch.data import synthetic

    root = os.path.join(workdir, "train_au")
    video, au = synthetic.make_joint_tree(
        root + "/video", root + "/au_face", n_per_class=2, frames=AU_TREE["frames"],
        n_aus=AU_TREE["n_aus"], face_size=AU_TREE["size"], patch_size=AU_TREE["size"], seed=120)
    return {"video": video, "au_face": au,
            "au_patch": synthetic.make_au_patch_tree(
                root + "/au_patch", n_per_class=2, frames=AU_TREE["frames"],
                n_aus=AU_TREE["n_aus"], size=AU_TREE["size"], seed=121),
            "audio": synthetic.make_audio_npy_tree(root + "/audio", n_per_class=4, frames=120,
                                                   seed=122)}


def au_train_then_serve(torch, workdir: str, smi: str, trees: dict) -> None:
    """Phase 9d: each CLI trains its tree for 2 epochs on the card (fp32); its
    best bundle is served (bf16; audio on the default K1 route, counted) and
    held against the bundle's model in fp32 eval on the same inputs: the
    logits through the head the scorer serves (AU-face: the detector's own
    ``head_fc``, AU-patch: the classifier, before the sigmoid; audio: the
    head's probabilities)."""
    from multimodal_deepfake_detection_tpu_torch.cli import train_au_face as tf
    from multimodal_deepfake_detection_tpu_torch.cli import train_au_patch as tp
    from multimodal_deepfake_detection_tpu_torch.cli import train_audio as ta
    from multimodal_deepfake_detection_tpu_torch.core.precision import ieee_fp32
    from multimodal_deepfake_detection_tpu_torch.models.au_face import au_face_detector_apply
    from multimodal_deepfake_detection_tpu_torch.models.heads import (
        xception_lstm_features,
        xception_lstm_head_apply,
    )
    from multimodal_deepfake_detection_tpu_torch.models.resnet_lstm import (
        au_patch_classifier_apply,
    )
    from multimodal_deepfake_detection_tpu_torch.models.serve import (
        AudioScorer,
        AUFaceScorer,
        AUPatchScorer,
        load_audio_bundle,
        load_au_face_bundle,
        load_au_patch_bundle,
    )
    from multimodal_deepfake_detection_tpu_torch.ops.mfcc import mfcc

    dev = torch.device("cuda")
    side, A, T = AU_TREE["size"], AU_TREE["n_aus"], AU_TREE["frames"]
    common = ["--epochs", "2", "--compute_dtype", "float32", "--device", "cuda"]
    runs = {
        "au_patch": (tp, ["--data_root", trees["au_patch"], "--max_frames", str(T)]),
        "au_face": (tf, ["--video_root", trees["video"], "--au_root", trees["au_face"],
                         "--max_frames", str(T)]),
        "audio": (ta, ["--train_folder", trees["audio"] + "/train", "--eval_folder",
                       trees["audio"] + "/eval", "--eval_every", "1"]),
    }
    rng = np.random.default_rng(123)
    for kind, (cli, argv) in runs.items():
        ck = os.path.join(workdir, f"train_{kind}")
        logs = []
        t0 = time.perf_counter()
        history = cli.main(argv + ["--checkpoint_dir", ck] + common, log=logs.append)
        secs = time.perf_counter() - t0
        for line in logs:
            say(f"train_{kind}: {line}")
        bundle = os.path.join(ck, ta.BUNDLE_NAME if kind == "audio" else cli.Config.bundle_name)
        if len(history) != 2 or not os.path.exists(bundle):
            raise AssertionError(f"train_{kind}: no best bundle after 2 epochs")
        expected = per_call(0)
        if kind == "au_patch":
            x = rng.integers(0, 256, (2, T, A, side, side, 3), np.uint8)
            w = rng.random((2, T, A)).astype(np.float32)
            scorer = AUPatchScorer.from_bundle(bundle, device="cuda")
            served = counted(torch, f"serve the trained {kind} bundle", lambda: no_grad(
                torch, lambda: scorer._apply(*scorer._inputs(x, w, None), False)),
                expected)[:, 0]
            model = load_au_patch_bundle(bundle).to(dev)
            with torch.no_grad(), ieee_fp32():
                xt = torch.from_numpy(x).to(dev).float() / 255.0
                ref = au_patch_classifier_apply(
                    model, xt, torch.from_numpy(w).to(dev),
                    lengths=torch.full((2,), T, dtype=torch.long, device=dev))[:, 0]
        elif kind == "au_face":
            v = rng.integers(0, 256, (2, T, side, side, 3), np.uint8)
            x = rng.integers(0, 256, (2, T, A, side, side, 3), np.uint8)
            scorer = AUFaceScorer.from_bundle(bundle, device="cuda")
            served = counted(torch, f"serve the trained {kind} bundle", lambda: no_grad(
                torch, lambda: scorer._apply(*scorer._inputs(v, x, None, None))[0]),
                expected)[:, 0]
            model = load_au_face_bundle(bundle).to(dev)
            ones = torch.ones((2, T, A), device=dev)
            with torch.no_grad(), ieee_fp32():
                ref = au_face_detector_apply(
                    model, torch.from_numpy(v).to(dev).float() / 255.0,
                    torch.from_numpy(x).to(dev).float() / 255.0, ones, ones,
                    v_valid=T, au_valid=T)[0][:, 0]
        else:
            waves = rng.normal(0, 0.1, (4, 16000)).astype(np.float32)
            scorer = AudioScorer.from_bundle(bundle, device="cuda")
            served = torch.from_numpy(counted(torch, f"serve the trained {kind} bundle",
                                              lambda: scorer.score(waves),
                                              per_call(1, k1=8)))
            model = load_audio_bundle(bundle).to(dev)
            with torch.no_grad(), ieee_fp32():
                steps = mfcc(torch.from_numpy(waves).to(dev))  # the scorer's frontend
                x = steps[:, :, None, :].expand(-1, -1, 3, -1)  # the trainer's MFCC layout
                feats, _ = xception_lstm_features(model, x, mode="audio")
                ref = xception_lstm_head_apply(model, feats)[:, 0]
        served = served.float().cpu()
        d = float((served - ref.float().cpu()).abs().max())
        _, probs = history[-1].eval_scores
        say(f"train_{kind} ({secs:.1f} s, 2 epochs): served bundle (bf16) vs the bundle's "
            f"model in fp32 eval, {'probabilities' if kind == 'audio' else 'logits'}: max|d| "
            f"{d:.3e} (<= {SERVE_TRAINED_TOL:.0e}); served {np.round(served.numpy(), 4)}; "
            f"the trainer's last eval probabilities {np.round(probs, 4).tolist()} [{smi}]")
        if not (d <= SERVE_TRAINED_TOL and torch.isfinite(served).all()):
            raise AssertionError(f"the served {kind} bundle disagrees with its model")
        del scorer, model
        torch.cuda.empty_cache()


def phase_au_train(torch, workdir: str, smi: str) -> None:
    t_phase = time.perf_counter()
    with NoTF32(torch):
        au_train_card_vs_cpu(torch, smi)
    trees = au_train_trees(workdir)
    au_train_times(torch, smi, trees)
    au_train_overfit(torch, smi)
    au_train_then_serve(torch, workdir, smi, trees)
    say(f"phase 9 (audio, AU-patch and AU-face training) took "
        f"{time.perf_counter() - t_phase:.1f} s")


# Phase 10, serving deployment: programs of the visual bundle (T = 8,
# bf16), one per kernel path: the live scorer's options, launches per
# backbone call, and the batch axis: symbolic, or static at ARTIFACT_B (a
# symbolic batch makes tracing the int8 walks' ~1,500 nodes 4x slower on the
# host). The fp program is written by cli/export_serving.py and replayed by
# cli/serve.py --artifact and the daemon; the others are exported from
# their live scorers (models/export.py::export_visual), so they hold the
# very calibrated tree the live scorer serves.
ARTIFACT_T, ARTIFACT_B = 8, 32
ARTIFACTS = {
    "fp": ({}, dict(k1=8), "b"),
    "w8a8-pallas": ({"quantize": "w8a8-pallas"}, dict(k2=8, dw=10), "b"),
    "fuse_entry+fuse_exit": ({"fuse_entry": True, "fuse_exit": True}, dict(k1=8, k3=4, k5=2),
                             "b"),
    "entry_pair+middle_taps_bf16": ({"entry_pair": True, "middle_taps": "bf16"},
                                    dict(k1b=8, k4=4), "b"),
    "w8a8-hybrid": ({"quantize": "w8a8-hybrid"}, dict(k1=8, dw=10), ARTIFACT_B),
    "w8a8": ({"quantize": "w8a8"}, dict(dw=34), ARTIFACT_B),
}
# an artifact against its live scorer: the same ops in the same order, so
# bit-equal is expected; the bar is one bf16 ulp of the probability
ARTIFACT_REL_TOL = 2.0 ** -8
DAEMON_REQUESTS, DAEMON_THREADS, DAEMON_T = 64, 16, (8, 5, 3)
# the daemon's scores against each clip scored alone by the live scorer,
# max |d| / |solo|: sound 1.639e-6 (batches of up to 16 clips against B = 1
# in bf16), the control (each score against the next clip's) 1.310e-1
# (NVIDIA H100 80GB HBM3, 700.00 W)
DAEMON_REL_TOL = 1e-3


def graph_nodes(art) -> dict:
    """The ``mdfd`` nodes of an ArtifactScorer's one program, per counter."""
    from multimodal_deepfake_detection_tpu_torch.models.export import kernel_nodes

    (program,) = art.programs.values()
    nodes = kernel_nodes(program)
    return {name: nodes.get(name, 0) for name in KERNELS}


def rel_max(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - b) / np.abs(b)))


def held_rel(label: str, got, ref, tol: float, *, control: bool = False) -> float:
    d = rel_max(got, ref)
    ok = d <= tol
    verdict = ("; control: fails, as it must" if not ok else "; control: PASSES") if control else ""
    say(f"{label}: score max |d| / |ref| {d:.3e} (<= {tol:.3e}){verdict}")
    if ok == control:
        raise AssertionError(f"{label}: " + ("the control passes the bar" if control
                                             else "disagreement"))
    return d


def artifact_held(torch, label, blob, live, batch, per_backbone) -> dict:
    """``blob`` loaded by ``ArtifactScorer``: its graph must hold as many
    ``mdfd`` nodes as ``live`` launches; both score ``batch`` (one backbone
    call), counted, and the scores are held to ``ARTIFACT_REL_TOL``. Returns
    the artifact's launches."""
    from multimodal_deepfake_detection_tpu_torch.models.artifact import ArtifactScorer

    t0 = time.perf_counter()
    art = ArtifactScorer(blob)
    expected = per_call(1, **per_backbone)
    nodes = graph_nodes(art)
    say(f"artifact {label}: {len(blob) / 1e6:.1f} MB, loaded in {time.perf_counter() - t0:.2f} "
        f"s; mdfd nodes {nodes}")
    if nodes != expected:
        raise AssertionError(f"artifact {label}: graph nodes {nodes}, live launches {expected}")
    got = counted(torch, f"artifact {label} (ArtifactScorer)", lambda: art.score(*batch), expected)
    want = counted(torch, f"live {label}", lambda: live.score(*batch), expected)
    held_rel(f"artifact {label} vs live", got, want, ARTIFACT_REL_TOL)
    return expected


def exported(label: str, export):
    """``export()`` timed; returns its blob."""
    t0 = time.perf_counter()
    blob = export()
    say(f"export {label}: {time.perf_counter() - t0:.2f} s")
    return blob


def post_npz(url: str, body: bytes):
    import urllib.request

    req = urllib.request.Request(url, body, {"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def daemon_traffic(torch, fp_path: str, solo, smi: str) -> None:
    """``cli/serve_daemon.py --artifact`` through its ``started`` hook; 64
    single-clip npz requests from 16 threads; each score held against the
    live scorer's solo score of that clip, the pairing rotated by one as
    the control."""
    import io
    import threading

    from multimodal_deepfake_detection_tpu_torch.cli import serve_daemon

    rng = np.random.default_rng(100)
    clips = [rng.integers(0, 256, (DAEMON_T[i % len(DAEMON_T)], 256, 256, 3), dtype=np.uint8)
             for i in range(DAEMON_REQUESTS)]
    bodies = []
    for clip in clips:
        buf = io.BytesIO()
        np.savez(buf, frames=clip)
        bodies.append(buf.getvalue())
    started = []
    t0 = time.perf_counter()
    serve_daemon.main(["--engine", "visual", "--artifact", fp_path, "--device", "cuda", "--port",
                       "0", "--max_batch", "16", "--max_wait_ms", "5", "--warmup", "8,256,256"],
                      log=say, started=started)
    (daemon,) = started
    warm = daemon.stats()["engines"]["visual"]
    say(f"daemon up and warm in {time.perf_counter() - t0:.2f} s")
    scores, lat = [None] * DAEMON_REQUESTS, [None] * DAEMON_REQUESTS
    url = daemon.url + "/v1/score/visual"

    def client(k):
        for i in range(k, DAEMON_REQUESTS, DAEMON_THREADS):
            t = time.perf_counter()
            scores[i] = post_npz(url, bodies[i])["score"]
            lat[i] = time.perf_counter() - t

    try:
        t = time.perf_counter()  # one request first: the client's and server's HTTP cold
        cold = post_npz(url, bodies[0])["score"]
        say(f"daemon: a first, lone request in {(time.perf_counter() - t) * 1e3:.2f} ms")
        threads = [threading.Thread(target=client, args=(k,)) for k in range(DAEMON_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("a daemon client did not finish in 600 s")
        stats = daemon.stats()["engines"]["visual"]
    finally:
        daemon.stop()
    if any(s is None for s in scores):
        raise AssertionError("a daemon request got no score")
    lat_ms = np.array(lat) * 1e3
    batches = stats["batches"] - warm["batches"]
    say(f"daemon: {DAEMON_REQUESTS} requests from {DAEMON_THREADS} threads in {wall:.3f} s: "
        f"{DAEMON_REQUESTS / wall:.1f} requests/s, latency p50 {np.percentile(lat_ms, 50):.2f} "
        f"ms, p99 {np.percentile(lat_ms, 99):.2f} ms, max {lat_ms.max():.2f} ms (request 0's "
        f"{lat_ms[0]:.2f}); {batches - 1} batches, "
        f"{(stats['scored'] - warm['scored'] - 1) / (batches - 1):.2f} clips a batch, "
        f"{stats['pad_rows'] - warm['pad_rows']} pad rows; the batcher's own enqueue-to-score "
        f"latency (last 1,000, warm-up included) p50 {stats['latency_ms_p50']} ms, p90 "
        f"{stats['latency_ms_p90']} ms ({smi})")
    want = np.array([solo.score(c[None])[0] for c in clips])
    held_rel("daemon vs solo", [cold] + scores, np.concatenate([want[:1], want]), DAEMON_REL_TOL)
    held_rel("control daemon vs solo of the next clip", scores, np.roll(want, 1), DAEMON_REL_TOL,
             control=True)


def phase_artifacts(torch, workdir: str, smi: str) -> dict:
    """Phase 10, serving deployment; returns each kernel's launches per
    backbone call on the first exported program that runs it."""
    from multimodal_deepfake_detection_tpu_torch.cli import export_serving
    from multimodal_deepfake_detection_tpu_torch.cli.serve import _pad_stack
    from multimodal_deepfake_detection_tpu_torch.models.export import export_audio, export_visual
    from multimodal_deepfake_detection_tpu_torch.models.serve import (
        AudioScorer,
        VisualScorer,
        load_visual_bundle,
    )

    t_phase = time.perf_counter()
    bundle, clip_dir, clips = visual_inputs(torch, workdir)
    calls = -(-len(clips) // BATCH_SIZE)
    calib = _pad_stack(clips[:BATCH_SIZE])[0]  # the CLI's first batch
    rng = np.random.default_rng(10)
    batch = (rng.integers(0, 256, (ARTIFACT_B, ARTIFACT_T, 256, 256, 3), dtype=np.uint8),
             np.full((ARTIFACT_B,), ARTIFACT_T, np.int32))
    model = load_visual_bundle(bundle)
    launches = {}
    for label, (live_kw, per_backbone, batch_axis) in ARTIFACTS.items():
        live = VisualScorer(*model, device="cuda", buckets=(ARTIFACT_T,), **live_kw)
        if label == "fp":  # the CLI, as a deployment runs it
            fp_path = os.path.join(workdir, "fp.ptprog")
            argv = ["--engine", "visual", "--ckpt_path", bundle, "--frames", str(ARTIFACT_T),
                    "--size", "256", "--out", fp_path, "--device", "cuda"]
            blob = exported(label, lambda: open(export_serving.main(argv, log=say), "rb").read())
            fp_live = live
        else:
            live.calibrate(calib)
            blob = exported(label, lambda: export_visual(live, ARTIFACT_T, 256, 256,
                                                         batch=batch_axis))
        counts = artifact_held(torch, label, blob, live, batch, per_backbone)
        for name, n in counts.items():  # each kernel's count on the first path that runs it
            if n:
                launches.setdefault(name, n)
    launches = {name: launches.get(name, 0) for name in KERNELS}

    # the slice's entry point: cli/serve.py --artifact over phase 4's clips
    argv = ["--engine", "visual", "--artifact", fp_path, "--input", clip_dir,
            "--batch_size", str(BATCH_SIZE)]
    scores = run_cli(torch, workdir, argv, "artifact CLI fp", [], per_call(calls, k1=8))
    want = np.concatenate([fp_live.score(*_pad_stack(clips[i : i + BATCH_SIZE]))
                           for i in range(0, len(clips), BATCH_SIZE)])
    if not np.array_equal(scores, [round(float(w), 6) for w in want]):  # the JSONL's rounding
        raise AssertionError(f"artifact CLI fp: scores {scores}, live {want}")
    say("artifact CLI fp: the JSONL scores are the live scorer's, to its 6 places")

    # audio: one program at 16,000 samples against AudioScorer on 64 clips
    live = AudioScorer.from_bundle(audio_bundle(torch, workdir), device="cuda")
    blob = exported("audio", lambda: export_audio(live, 16000))
    waves = (np.random.default_rng(11).normal(0, 0.1, (64, 16000)).astype(np.float32),)
    artifact_held(torch, "audio", blob, live, waves, dict(k1=8))

    # the daemon over the fp program, and ms per score() against live
    daemon_traffic(torch, fp_path, fp_live, smi)
    from multimodal_deepfake_detection_tpu_torch.models.artifact import ArtifactScorer

    art = ArtifactScorer(fp_path)
    ms, runs = in_turns(torch, {"artifact": lambda: art.score(*batch),
                                "live": lambda: fp_live.score(*batch)}, 5)
    frames = ARTIFACT_B * ARTIFACT_T
    say(f"score() of {ARTIFACT_B} x {ARTIFACT_T} frames at 256^2, bf16, K1 path, two turns of 5: "
        f"artifact {ms['artifact']:.2f} ms ({frames / ms['artifact'] * 1e3:.1f} frames/s), "
        f"live {ms['live']:.2f} ms ({frames / ms['live'] * 1e3:.1f} frames/s); turns "
        f"{ {k: [round(v, 2) for v in r] for k, r in runs.items()} } ({smi})")
    say(f"phase 10 done in {time.perf_counter() - t_phase:.1f} s")
    return launches


SOURCES = {
    "middle_block": ("multimodal_deepfake_detection_tpu_torch/csrc/middle_block.cu",
                     "multimodal_deepfake_detection_tpu/ops/pallas/sepconv_pos.py:80; with fp32 "
                     "taps also sepconv_block.py:78 (v1) and sepconv_block.py:196 (v2, "
                     "precise=True)"),
    "middle_block_bf16taps": ("multimodal_deepfake_detection_tpu_torch/csrc/middle_block.cu",
                              "multimodal_deepfake_detection_tpu/ops/pallas/sepconv_block.py:196 "
                              "(v2, precise=False)"),
    "middle_block_w8": ("multimodal_deepfake_detection_tpu_torch/csrc/middle_block_w8.cu",
                        "multimodal_deepfake_detection_tpu/ops/pallas/sepconv_pos.py:190"),
    # no TPU kernel: the JAX package's XLA op
    "dw_w8a8": ("multimodal_deepfake_detection_tpu_torch/csrc/dw_w8a8.cu",
                "multimodal_deepfake_detection_tpu/ops/quant.py:103"),
    "entry_block": ("multimodal_deepfake_detection_tpu_torch/csrc/entry_block.cu",
                    "multimodal_deepfake_detection_tpu/ops/pallas/sepconv_entry.py:291 and "
                    "multimodal_deepfake_detection_tpu/ops/pallas/sepconv_entry_striped.py:180"),
    "entry_pair": ("multimodal_deepfake_detection_tpu_torch/csrc/entry_pair.cu",
                   "multimodal_deepfake_detection_tpu/ops/pallas/sepconv_entry.py:123, "
                   "multimodal_deepfake_detection_tpu/ops/pallas/sepconv_stream.py:117 and "
                   "multimodal_deepfake_detection_tpu/ops/pallas/sepconv_stream2.py:177"),
    "sepconv_unit": ("multimodal_deepfake_detection_tpu_torch/csrc/sepconv_unit.cu",
                     "multimodal_deepfake_detection_tpu/ops/pallas/sepconv_unit.py:91"),
}


# ---------------------------------------------------------------------------
# Phase 11: evaluation (cli/test_visual, test_audio, test_av_fused,
# test_au_patch, test_au_face). No TPU kernel lies on it: the JAX test CLIs
# score through the unfolded eval-BN Xception and ResNet-18s on XLA convs;
# here cuDNN and cuBLAS, and no mdfd op.
# ---------------------------------------------------------------------------

EVAL_VISUAL_T = (20, 40, 60, 75, 10, 30, 50, 70)  # 224^2 faces across the buckets 25/50/75
EVAL_MFCC_T = (120, 100, 80, 60, 110, 90, 70, 50)  # MFCC steps, bucket 120
EVAL_AU_T = (16, 9, 5, 12, 7, 14)  # face and AU-patch stacks of 17 AUs at 128^2 (t-SNE needs 6)
# the card's fp32 scores against the CPU's run at a frame cut (the CLIs'
# own flags, the same on both): at the defaults the CPU would score 600
# frames of 224^2 and 4,080 AU patches of 128^2 per CLI
EVAL_CPU_CUT = {
    "test_visual": ["--max_frames", "4", "--buckets", "4"],
    "test_audio": ["--buckets", "16"],
    "test_av_fused": ["--max_frames", "4", "--video_buckets", "4", "--audio_buckets", "16"],
    "test_au_patch": ["--max_frames", "4"],
    "test_au_face": ["--max_frames", "4"],
}
EVAL_CPU_TOL = 1e-4  # card fp32 (IEEE) against CPU fp32 scores
# saliency: ||card - CPU fp32|| / ||CPU fp32|| over the cut's first batch,
# per CLI (fp32 bar, bf16 bar); each control (the CPU maps of the batch's
# next clip) must fail its bar
EVAL_SAL_BARS = {"test_visual": (5e-5, 0.1), "test_au_patch": (3e-3, 0.25),
                 "test_au_face": (1e-2, 0.25)}
# the AU CLIs' fp32 maps over the images where every ReLU gate and stem
# max-pool argmax of the card's forward agrees with the CPU's
EVAL_SAL_AGREED = 1e-4


def write_eval_trees(workdir: str) -> dict:
    """Seeded npy trees of the test CLIs: face clips (``EVAL_VISUAL_T`` at
    224^2) and MFCC clips (``EVAL_MFCC_T``) of the same stems (also the AV
    pairs); AU-patch stacks and face + AU pairs (``EVAL_AU_T``, 17 AUs,
    128^2) under their splits."""
    rng = np.random.default_rng(111)
    names = [f"{c}_{i}" for i in range(4) for c in ("real", "fake")]
    dirs = {k: os.path.join(workdir, "eval", k) for k in ("faces", "mfcc", "patches", "jv", "ja")}
    for k in ("faces", "mfcc"):
        os.makedirs(dirs[k])
    for k in ("patches", "jv", "ja"):
        for split in ("train", "eval", "test"):
            os.makedirs(os.path.join(dirs[k], split))
    for name, tv, ta in zip(names, EVAL_VISUAL_T, EVAL_MFCC_T):
        np.save(os.path.join(dirs["faces"], f"{name}.npy"),
                rng.integers(0, 256, (tv, 224, 224, 3), dtype=np.uint8))
        np.save(os.path.join(dirs["mfcc"], f"{name}.npy"),
                rng.normal(0, 20, (ta, 13)).astype(np.float32))
    for name, t in zip(names, EVAL_AU_T):
        for root, split in ((dirs["patches"], "test"), (dirs["ja"], "eval")):
            np.save(os.path.join(root, split, f"{name}.npy"),
                    rng.integers(0, 256, (t, NUM_AUS, PATCH, PATCH, 3), dtype=np.uint8))
            np.save(os.path.join(root, split, f"{name}_weights.npy"),
                    rng.dirichlet(np.ones(NUM_AUS), size=t).astype(np.float32))
        np.save(os.path.join(dirs["jv"], "eval", f"{name}.npy"),
                rng.integers(0, 256, (t, PATCH, PATCH, 3), dtype=np.uint8))
    return dirs


def eval_argv(workdir: str, dirs: dict, bundles: dict) -> dict:
    """Each CLI's inputs; every other flag at its default."""
    return {
        "test_visual": ["--test_folder", dirs["faces"], "--ckpt_path", bundles["visual"]],
        "test_audio": ["--test_folder", dirs["mfcc"], "--ckpt_path", bundles["audio"]],
        "test_av_fused": ["--video_folder", dirs["faces"], "--audio_folder", dirs["mfcc"],
                          "--visual_ckpt", bundles["visual"], "--audio_ckpt", bundles["audio"]],
        "test_au_patch": ["--data_root", dirs["patches"], "--ckpt_path", bundles["au_patch"]],
        "test_au_face": ["--video_root", dirs["jv"], "--au_root", dirs["ja"], "--ckpt_path",
                         bundles["au_face"], "--output_dir", os.path.join(workdir, "eval", "out")],
    }


def eval_setup(name: str, mod, argv: list):
    """The CLI's config, scorer and loader from ``argv`` (bundle load and
    model build here), and ``run() -> (labels, {stream: scores})``: its
    scoring loop, with au_face's scores before any sign flip."""
    config = mod.parse_config(mod.Config, argv, prog=name)
    quiet = lambda s: None  # noqa: E731
    if name == "test_visual":
        scorer, loader = mod.build_scorer(config), mod.make_loader(config)

        def run():
            _results, y, s = mod.evaluate(scorer, loader)
            return y, {"score": s}
    elif name == "test_audio":
        scorer, loader = mod.build_scorer(config, log=quiet), mod.make_loader(config)

        def run():
            y, s = mod.evaluate(scorer, loader)
            return y, {"score": s}
    elif name == "test_av_fused":
        scorer, loader = mod.build_scorer(config), mod.make_loader(config, quiet)

        def run():
            y, p_v, p_a = mod.evaluate(scorer, loader)
            return y, {"visual": p_v, "audio": p_a,
                       "fused": config.alpha * p_v + (1 - config.alpha) * p_a}
    elif name == "test_au_patch":
        scorer, loader = mod.load_model(config, log=quiet), mod.make_loader(config)

        def run():
            y, s, _ = mod.evaluate(scorer, loader)
            return y, {"score": s}
    else:
        scorer, loader = mod.load_detector_flexible(config, quiet), mod.make_loader(config)

        def run():
            face, au, y, s = mod.collect_features(loader, scorer)
            return y, {"score": s, "face_token": face, "au_token": au}
    return config, scorer, loader, run


def saliency_inputs(name: str, scorer, batch):
    """The device inputs of the CLI's saliency (the frames first) for one
    host batch of its loader."""
    from multimodal_deepfake_detection_tpu_torch.cli.common import to_device

    if name == "test_visual":
        video, _labels, lengths = batch
        return to_device((video, lengths), scorer.device)
    if name == "test_au_patch":
        patches, weights, _labels, lengths = batch
        return to_device((patches, weights, lengths), scorer.device)
    videos, patches, _labels, au_mask, au_weight, _lengths = batch
    return to_device((videos, patches, au_mask, au_weight), scorer.device)


def saliency_maps(torch, name: str, scorer, batch, fn=None):
    """``input_saliency`` of the CLI's scorer on one batch, as the CLI's
    ``--saliency_dir`` computes it -> fp64 host maps (``fn``: another score
    function of the same inputs)."""
    from multimodal_deepfake_detection_tpu_torch.cli.common import precision
    from multimodal_deepfake_detection_tpu_torch.utils.saliency import input_saliency

    with precision(scorer.cdtype):
        maps = input_saliency(fn or scorer.probs, *saliency_inputs(name, scorer, batch))
    return maps.double().cpu().numpy()


def logit_fn(name: str, scorer):
    """The CLI's score before its last step, the sigmoid (AU) or the
    two-class softmax (visual: the logit difference): the saliency's function
    without the factor p (1 - p) that saturates."""
    if name == "test_au_patch":
        return lambda p, w, n: scorer._apply(p, w, n)[:, 0].float()
    if name == "test_au_face":
        from multimodal_deepfake_detection_tpu_torch.models.au_face import au_face_detector_apply

        return lambda v, p, m, w: au_face_detector_apply(
            scorer.model, v, p, m, w, compute_dtype=scorer.cdtype)[0][:, 0].float()
    from multimodal_deepfake_detection_tpu_torch.models.heads import (
        arcface_apply,
        xception_lstm_embed,
        xception_lstm_features,
    )

    def fn(video, lengths):
        feats, _ = xception_lstm_features(scorer.model, video, mode="video",
                                          compute_dtype=scorer.cdtype)
        emb = xception_lstm_embed(scorer.model, feats, lengths=lengths,
                                  mask_padding=scorer.config.mask_padding,
                                  compute_dtype=scorer.cdtype)
        logits = arcface_apply(scorer.arcface.w, emb, None, s=scorer.config.arcface_s).float()
        return logits[:, 1] - logits[:, 0]
    return fn


def gate_masks(torch, name: str, scorer, batch) -> list:
    """One forward of the AU CLI's scorer with every ``torch.relu`` gate
    and ResNet-18's stem max-pool argmax read: ``[(kind, gate or argmax,
    on CPU)]`` in call order (pool argmaxes only where the window's maximum
    is positive)."""
    from multimodal_deepfake_detection_tpu_torch.cli.common import precision
    from multimodal_deepfake_detection_tpu_torch.models import resnet

    calls = []
    relu, pool = torch.relu, resnet.max_pool2d

    def gated(x):
        calls.append(("relu", (x > 0).cpu()))
        return relu(x)

    def pooled(x, kernel_size=3, stride=2, padding=1):
        mx, idx = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), kernel_size, stride,
                                                 padding, return_indices=True)
        calls.append(("pool", torch.where(mx > 0, idx, -1).cpu()))
        return pool(x, kernel_size, stride, padding)

    torch.relu, resnet.max_pool2d = gated, pooled
    try:
        with torch.no_grad(), precision(scorer.cdtype):
            scorer.probs(*saliency_inputs(name, scorer, batch))
    finally:
        torch.relu, resnet.max_pool2d = relu, pool
    return calls


def fp64_maps(torch, name: str, cpu, batch):
    """The saliency maps of the CPU scorer's model in fp64 (a copy)."""
    import copy

    from multimodal_deepfake_detection_tpu_torch.utils.saliency import input_saliency

    scorer = copy.deepcopy(cpu)
    scorer.model.double()
    if hasattr(scorer, "arcface"):
        scorer.arcface.double()
    scorer.cdtype = torch.float64
    inputs = [t.double() if t.is_floating_point() else t
              for t in saliency_inputs(name, scorer, batch)]
    return input_saliency(scorer.probs, *inputs).double().numpy()


def saliency_diagnostics(torch, name: str, card, cpu, batch, got, ref, err: float) -> None:
    """Why the card's fp32 saliency is off the CPU's (ROADMAP Queue 3, F5):
    1 - p on both sides (the maps scale with p (1 - p)); the maps of the
    score before its sigmoid / softmax, card against CPU; the card's maps
    again with cuDNN deterministic, and with cuDNN off for the backward only;
    both sides against the CPU's fp64 maps; for the AU CLIs the ReLU gates
    and stem max-pool argmaxes that the card's and the CPU's forwards set
    differently, and the maps of the images where they all agree, held at
    ``EVAL_SAL_AGREED``."""
    from multimodal_deepfake_detection_tpu_torch.cli.common import precision

    with torch.no_grad(), precision(card.cdtype):
        p_card = card.probs(*saliency_inputs(name, card, batch)).double().cpu().numpy()
    with torch.no_grad(), precision(cpu.cdtype):
        p_cpu = cpu.probs(*saliency_inputs(name, cpu, batch)).double().cpu().numpy()
    q_card, q_cpu = np.minimum(p_card, 1 - p_card), np.minimum(p_cpu, 1 - p_cpu)
    say(f"F5 {name}: min(p, 1 - p) card {np.array2string(q_card, precision=3)}, CPU "
        f"{np.array2string(q_cpu, precision=3)}; max|dp| {np.abs(p_card - p_cpu).max():.3e}, "
        f"max relative d(p (1 - p)) "
        f"{np.abs(p_card * (1 - p_card) / (p_cpu * (1 - p_cpu)) - 1).max():.3e}")
    lg_card = saliency_maps(torch, name, card, batch, logit_fn(name, card))
    lg_cpu = saliency_maps(torch, name, cpu, batch, logit_fn(name, cpu))
    say(f"F5 {name}: maps of the score before its sigmoid/softmax, card fp32 against CPU "
        f"fp32: relative L2 {rel_l2(lg_card, lg_cpu):.3e} (the probability's: {err:.3e})")
    b = torch.backends.cudnn
    before = b.deterministic
    b.deterministic = True
    try:
        det = saliency_maps(torch, name, card, batch)
    finally:
        b.deterministic = before
    inputs = saliency_inputs(name, card, batch)
    x = inputs[0].detach().clone().requires_grad_(True)
    with precision(card.cdtype):
        with torch.enable_grad():
            total = card.probs(x, *inputs[1:]).sum()
        with b.flags(enabled=False):
            (g,) = torch.autograd.grad(total, x)
    no_cudnn = g.float().abs().amax(dim=-1).double().cpu().numpy()
    say(f"F5 {name}: card fp32 maps against CPU fp32, relative L2: cudnn.deterministic "
        f"{rel_l2(det, ref):.3e}, cuDNN off in the backward {rel_l2(no_cudnn, ref):.3e}")
    m64 = fp64_maps(torch, name, cpu, batch)
    say(f"F5 {name}: against the CPU's fp64 maps, relative L2: card fp32 {rel_l2(got, m64):.3e}, "
        f"CPU fp32 {rel_l2(ref, m64):.3e}")
    if name == "test_visual":
        return
    # ResNet-18 runs per image: a ReLU gate or a stem max-pool argmax that
    # the two fp32 forwards set differently moves the input gradient of that
    # image alone
    images = int(np.prod(ref.shape[:-2]))  # the maps' images: faces or patches
    flipped = set()
    for (kind, a), (_, b) in zip(gate_masks(torch, name, card, batch),
                                 gate_masks(torch, name, cpu, batch)):
        diff = a != b
        if not diff.any():
            continue
        stream = "" if a.shape[0] == images else " (another stream)"
        if not stream:
            hit = torch.nonzero(diff.flatten(1).any(1)).flatten().tolist()
            flipped.update(hit)
            stream = f", in images {hit}"
        say(f"F5 {name}: {kind} {tuple(a.shape)}: {int(diff.sum())} of {a.numel()} set "
            f"differently on the card and the CPU{stream}")
    keep = np.array([i not in flipped for i in range(images)])
    flat = lambda m: m.reshape(images, -1)  # noqa: E731
    rest = rel_l2(flat(got)[keep], flat(ref)[keep])
    only = rel_l2(flat(got)[~keep], flat(ref)[~keep]) if flipped else 0.0
    say(f"F5 {name}: card fp32 maps against CPU fp32 over the {int(keep.sum())} images where "
        f"every gate agrees: relative L2 {rest:.3e} (<= {EVAL_SAL_AGREED:g}); over the "
        f"{len(flipped)} others: {only:.3e}")
    if not rest <= EVAL_SAL_AGREED:
        raise AssertionError(f"{name}: maps off the CPU's by {rest} where every gate agrees")


def device_forward(torch, name: str, scorer, batch):
    """The CLI's forward on one batch already on the card, without gradients
    (what its scoring loop runs per batch, less the host's loading, collation
    and copies)."""
    from multimodal_deepfake_detection_tpu_torch.cli.common import precision, to_device

    if name == "test_av_fused":
        (videos, audios, a_len), _labels, v_len = batch
        args = to_device((videos, v_len, audios, a_len), scorer.device)
        fn = scorer.probs
    elif name == "test_audio":
        mfcc, _labels, lengths = batch
        args, fn = to_device((mfcc, lengths), scorer.device), scorer.probs
    elif name == "test_au_face":
        args, fn = saliency_inputs(name, scorer, batch), scorer.run
    else:
        args, fn = saliency_inputs(name, scorer, batch), scorer.probs

    def run():
        with torch.no_grad(), precision(scorer.cdtype):
            return fn(*args)
    return run


def folded_against_unfolded(torch, scorer, batch, smi: str) -> None:
    """test_visual's unfolded eval-BN forward against the serving engine's
    BN-folded plain path (cuDNN and cuBLAS, no kernel) on the same batch, on
    the card, in turns."""
    from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer

    video, _labels, lengths = batch
    folded = VisualScorer(scorer.model, scorer.arcface, device=scorer.device, use_kernels=False,
                          compute_dtype=scorer.cdtype)
    u8 = torch.from_numpy(np.rint(video * 255.0).astype(np.uint8)).to(scorer.device)
    n = torch.from_numpy(lengths).to(scorer.device)

    def run_folded():
        with torch.inference_mode():
            return folded._score_impl(u8, n)
    unfolded = device_forward(torch, "test_visual", scorer, batch)
    means, _ = in_turns(torch, {"unfolded": unfolded, "folded": run_folded}, 3)
    d = float((unfolded().float() - run_folded().float()).abs().max())
    frames = video.shape[0] * video.shape[1]
    say(f"test_visual bf16, one batch of {video.shape[0]} x {video.shape[1]} frames at "
        f"{video.shape[2]}^2 on the card: unfolded eval BN {means['unfolded']:.2f} ms "
        f"({frames / means['unfolded'] * 1e3:.1f} frames/s), the BN-folded plain path "
        f"{means['folded']:.2f} ms ({frames / means['folded'] * 1e3:.1f} frames/s): "
        f"{means['unfolded'] / means['folded']:.2f}x; scores max|d| {d:.3e} ({smi})")


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def eval_cli(torch, name: str, mod, argv: list, smi: str, extras: dict) -> None:
    """One CLI: its report at the defaults on the card in bf16 and fp32
    (``extras``: each run's output flags), counted; bf16 against fp32
    scores; the scoring loop timed; the card's fp32 scores against the
    CPU's at the cut; the saliency maps on the card against the CPU's."""
    mib = 1024.0 ** 2
    runs = {}
    for dtype in ("bfloat16", "float32"):
        report = []
        flags = ["--compute_dtype", dtype] + extras[dtype]
        counted(torch, f"{name} {dtype}", lambda: mod.main(argv + flags, log=report.append),
                per_call(0))
        say(f"{name} {dtype} report: " + " | ".join(
            line.strip() for line in report if line.strip() and "->" not in line))
        _, scorer, loader, run = eval_setup(name, mod, argv + ["--compute_dtype", dtype])
        run()  # warm-up: cuDNN's algorithm picks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        labels, scores = run()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / mib
        runs[dtype] = (labels, scores)
        batch = next(iter(loader))
        forward = device_forward(torch, name, scorer, batch)
        dev_ms = in_turns(torch, {"forward": forward}, 3)[0]["forward"]
        say(f"{name} {dtype} at the defaults: scoring loop {dt * 1e3:.2f} ms for {len(labels)} "
            f"clips in {len(loader)} batches, {len(labels) / dt:.2f} clips/s, peak memory "
            f"{peak:.1f} MiB (bundle load excluded); the forward alone on one batch already on "
            f"the card {dev_ms:.2f} ms ({smi})")
        if name == "test_visual" and dtype == "bfloat16":
            folded_against_unfolded(torch, scorer, batch, smi)
        if name in ("test_visual", "test_au_patch", "test_au_face") and dtype == "bfloat16":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            maps = saliency_maps(torch, name, scorer, batch)
            dt = time.perf_counter() - t0
            say(f"{name} saliency of the first batch at the defaults (shape {maps.shape}, "
                f"batch not cut): {dt * 1e3:.2f} ms, peak memory "
                f"{torch.cuda.max_memory_allocated() / mib:.1f} MiB ({smi})")
            if not np.isfinite(maps).all() or maps.max() <= 0:
                raise AssertionError(f"{name}: saliency maps not finite and positive")
        del scorer, loader, run, forward
    (yb, sb), (yf, sf) = runs["bfloat16"], runs["float32"]
    if yb.tolist() != yf.tolist():
        raise AssertionError(f"{name}: bf16 and fp32 labels differ")
    for k in sb:  # the scores held, au_face's mean tokens read
        d = float(np.abs(sb[k] - sf[k]).max())
        held_k = not k.endswith("_token")
        say(f"{name} bf16 against fp32 {k}: max|d| {d:.3e}"
            + (f" (<= {SCORE_TOL:.0e})" if held_k else ""))
        if held_k and not d <= SCORE_TOL:
            raise AssertionError(f"{name}: bf16 {k} off fp32 by {d}")
    if name == "test_au_face":
        say("test_au_face sign flip: bf16 " + str(mod.sign_flip(yb, sb["score"], log=say))
            + ", fp32 " + str(mod.sign_flip(yf, sf["score"], log=say)))

    card_against_cpu(torch, name, mod, argv)


def card_against_cpu(torch, name: str, mod, argv: list) -> None:
    """The card's fp32 scores against the CPU's at the cut; the saliency maps
    (card fp32 and bf16 against CPU fp32, each with its control), with the
    F5 diagnostics beside the fp32 reading."""
    cut = argv + EVAL_CPU_CUT[name] + ["--compute_dtype", "float32"]
    setups = {dev: eval_setup(name, mod, cut + ["--device", dev]) for dev in ("cuda", "cpu")}
    t0 = time.perf_counter()
    (yc, sc), (yg, sg) = setups["cpu"][3](), setups["cuda"][3]()
    if yc.tolist() != yg.tolist():
        raise AssertionError(f"{name}: card and CPU labels differ")
    for k in sc:
        d = float(np.abs(sg[k] - sc[k]).max())
        say(f"{name} card fp32 against CPU fp32 {k} ({len(yc)} clips, cut "
            f"{' '.join(EVAL_CPU_CUT[name])}): max|d| {d:.3e} (<= {EVAL_CPU_TOL:.0e})")
        if not d <= EVAL_CPU_TOL:
            raise AssertionError(f"{name}: card fp32 {k} off the CPU's by {d}")
    if name == "test_au_face":
        say(f"test_au_face sign flip at the cut: card {mod.sign_flip(yg, sg['score'], log=say)}"
            f", CPU {mod.sign_flip(yc, sc['score'], log=say)}")
    if name in ("test_visual", "test_au_patch", "test_au_face"):
        _, cpu_scorer, cpu_loader, _ = setups["cpu"]
        batch = next(iter(cpu_loader))
        ref = saliency_maps(torch, name, cpu_scorer, batch)
        for dtype, bar in zip(("float32", "bfloat16"), EVAL_SAL_BARS[name]):
            _, scorer, _, _ = (setups["cuda"] if dtype == "float32" else
                               eval_setup(name, mod, argv + EVAL_CPU_CUT[name]))
            got = saliency_maps(torch, name, scorer, batch)
            err, ctl = rel_l2(got, ref), rel_l2(got, np.roll(ref, 1, axis=0))
            say(f"{name} saliency, card {dtype} against CPU fp32 (shape {ref.shape}): relative "
                f"L2 {err:.3e} (<= {bar:g}); control (the CPU maps of the batch's next clip) "
                f"{ctl:.3e}")
            if dtype == "float32":
                saliency_diagnostics(torch, name, scorer, cpu_scorer, batch, got, ref, err)
            if not err <= bar:
                raise AssertionError(f"{name}: card {dtype} saliency off the CPU's by {err}")
            if ctl <= bar:
                raise AssertionError(f"{name}: the saliency control passes its bar ({ctl})")
    say(f"{name}: card against CPU in {time.perf_counter() - t0:.1f} s")


def phase_eval(torch, workdir: str, smi: str) -> None:
    """The test CLIs at full width (phase 11)."""
    import importlib.util

    from multimodal_deepfake_detection_tpu_torch.cli import (
        test_au_face,
        test_au_patch,
        test_audio,
        test_av_fused,
        test_visual,
    )

    t_phase = time.perf_counter()
    bundles = {"visual": visual_inputs(torch, workdir)[0], "audio": audio_bundle(torch, workdir)}
    au = {e: os.path.join(workdir, f"{e}.npz") for e in ("au_face", "au_patch")}
    if not all(os.path.exists(p) for p in au.values()):
        au = write_au_bundles(torch, workdir)
    bundles.update(au)
    dirs = write_eval_trees(workdir)
    argvs = eval_argv(workdir, dirs, bundles)
    plots = importlib.util.find_spec("matplotlib") is not None
    tsne = plots and importlib.util.find_spec("sklearn") is not None
    say(f"evaluation: matplotlib {'found' if plots else 'absent'}, scikit-learn "
        f"{'found' if tsne else 'absent'}: the CLIs' --saliency_dir "
        f"{'runs' if plots else 'is skipped'}, test_au_face's --tsne "
        f"{'runs' if tsne else 'is off'}")
    sal_dir = lambda n: ["--saliency_dir", os.path.join(workdir, "eval", f"sal_{n}")]  # noqa
    extras = {  # the bf16 run writes every output the packages allow, the fp32 run none
        "test_visual": (sal_dir("visual") if plots else [], []),
        "test_audio": ([], []),
        "test_av_fused": (["--save_scores", os.path.join(workdir, "eval", "av.npz")], []),
        "test_au_patch": ((sal_dir("au_patch") if plots else []) + [
            "--save_embeddings", os.path.join(workdir, "eval", "emb.npz")], []),
        "test_au_face": ((sal_dir("au_face") if plots else []) + ["--tsne", str(tsne).lower()],
                         ["--tsne", "false"]),
    }
    for name, mod in (("test_visual", test_visual), ("test_audio", test_audio),
                      ("test_av_fused", test_av_fused), ("test_au_patch", test_au_patch),
                      ("test_au_face", test_au_face)):
        t0 = time.perf_counter()
        eval_cli(torch, name, mod, argvs[name], smi,
                 dict(zip(("bfloat16", "float32"), extras[name])))
        say(f"{name} took {time.perf_counter() - t0:.1f} s")
    if plots:
        pngs = sorted(os.path.relpath(os.path.join(d, f), workdir)
                      for d, _, fs in os.walk(os.path.join(workdir, "eval")) for f in fs
                      if f.endswith(".png"))
        say(f"evaluation PNGs: {pngs}")
        if len(pngs) != 3 + 3 * tsne:
            raise AssertionError(f"expected 3 saliency PNGs and the t-SNE plots, got {pngs}")
    say(f"phase 11 (evaluation) took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 12: ingestion (data/native_video.py and native_loader.py over
# native/*.cc, data/video_enhanced.py, data/preprocess.py, cli/import_torch.py).
# No TPU kernel lies on the host code: the JAX package decodes, collates and
# imports on the host too. The video files are scored through K1.
# ---------------------------------------------------------------------------

INGEST_T = (20, 75, 33, 50, 61, 27, 44, 70)  # frames of the 8 seeded clips
INGEST_HW = (360, 640)  # the clips' height and width: the CLI resizes them
INGEST_SIZE = 256  # --frame_size of the serve CLI
INGEST_NPY_TOL = 1e-6  # decoded videos against the same frames as .npy
INGEST_TRAIN_SIZE, INGEST_TRAIN_T = 224, 50
# the LAV-DF splits of the 8 clips (train 4, dev 2, test 2) and their fake periods
INGEST_SPLITS = ("train", "train", "train", "train", "dev", "dev", "test", "test")
INGEST_WAV_S = (1.8, 2.4)  # seconds of the two seeded .wav files a class
COLLATE_EPOCHS = 20  # passes over phase 9's audio tree, native against Python


def host_report(built: dict) -> dict:
    """What the host offers the ingestion path, on lines of its own: g++,
    the libjpeg and libav headers, cv2, ffmpeg, each native library's build
    and ``ldd``. Returns ``{"cv2": module or None, ...}``."""
    import importlib
    import shutil

    from multimodal_deepfake_detection_tpu_torch.data import native_build

    gxx = shutil.which("g++")
    version = (subprocess.run([gxx, "--version"], capture_output=True, text=True)
               .stdout.splitlines()[0] if gxx else "absent")
    say(f"ingest host: g++ {version}")
    for header in ("jpeglib.h", "libavcodec/avcodec.h"):
        found = [d for d in ("/usr/include", "/usr/include/x86_64-linux-gnu",
                             "/usr/local/include") if os.path.exists(os.path.join(d, header))]
        say(f"ingest host: {header} {'in ' + ', '.join(found) if found else 'absent'}")
    try:
        cv2 = importlib.import_module("cv2")
        say(f"ingest host: cv2 {cv2.__version__} imports")
    except ImportError as e:
        cv2 = None
        say(f"ingest host: cv2 absent ({e})")
    say(f"ingest host: ffmpeg binary {shutil.which('ffmpeg') or 'absent'}")
    for name, err in built.items():
        if err is None:
            lib = native_build.library_path(name)
            ldd = subprocess.run(["ldd", str(lib)], capture_output=True, text=True).stdout
            say(f"ingest build: native/{name}.cc -> build/{lib.name}; ldd: "
                + "; ".join(line.strip() for line in ldd.splitlines()))
        else:
            say(f"ingest build: native/{name}.cc did not build: "
                + " | ".join(err.splitlines()[:3]))
    return {"cv2": cv2}


def ingest_frames(rng, t: int):
    """``t`` frames of 640x360 uint8 RGB: a smooth random field drifting a
    few pixels a frame, plus noise."""
    H, W = INGEST_HW
    base = rng.integers(0, 256, (H // 8 + 1, W // 8 + 1, 3)).astype(np.float32)
    base = np.repeat(np.repeat(base, 8, axis=0), 8, axis=1)
    frames = np.empty((t, H, W, 3), np.uint8)
    for i in range(t):
        shifted = np.roll(base, (2 * i, 3 * i), axis=(0, 1))[:H, :W]
        frames[i] = np.clip(shifted + rng.normal(0, 6, (H, W, 3)), 0, 255).astype(np.uint8)
    return frames


def write_ingest_clips(vid_dir: str, cv2, libav: bool) -> str:
    """The 8 seeded ``.mp4`` clips (``INGEST_T`` frames at 640x360), H.264
    through the libav engine's encoder where it built, else MPEG-4 part 2
    (``mp4v``) through cv2; and one MJPEG ``.avi`` of 16 frames, by libav
    where it can write one, else by cv2, else none. Returns what wrote
    them."""
    from multimodal_deepfake_detection_tpu_torch.data.native_video import encode_test_video

    os.makedirs(vid_dir)
    rng = np.random.default_rng(160)

    def with_cv2(path, frames, fourcc):
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25, INGEST_HW[::-1])
        if not w.isOpened():
            raise AssertionError(f"cv2 could not write {path}")
        for f in frames:
            w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        w.release()

    for i, t in enumerate(INGEST_T):
        path = os.path.join(vid_dir, f"clip{i}.mp4")
        frames = ingest_frames(rng, t)
        if libav:
            if encode_test_video(path, frames) <= 0:
                raise AssertionError(f"libav could not write {path} (libx264)")
        else:
            with_cv2(path, frames, "mp4v")
    path, frames = os.path.join(vid_dir, f"clip{len(INGEST_T)}.avi"), ingest_frames(rng, 16)
    if libav and encode_test_video(path, frames, codec="mjpeg") > 0:
        avi = "libav"
    elif cv2 is not None:
        with_cv2(path, frames, "MJPG")
        avi = "cv2"
    else:
        avi = None
        if os.path.exists(path):
            os.remove(path)
    mp4 = "libav (H.264)" if libav else "cv2 (MPEG-4 part 2)"
    return f"mp4: {mp4}; MJPEG avi: " + (avi or "none, neither libav nor cv2 writes one")


def engine_counts() -> dict:
    from multimodal_deepfake_detection_tpu_torch.data.native_video import ENGINE_COUNTS

    return dict(ENGINE_COUNTS)


def expected_engines(built: dict, n_mp4: int, n_avi: int) -> dict:
    """Which engine serves each clip: the MJPEG engine the ``.avi`` where it
    built, libav what is left where it built, cv2 the rest."""
    mjpeg = n_avi if built["video_decode"] is None else 0
    libav = (n_mp4 + n_avi - mjpeg) if built["video_decode_av"] is None else 0
    return {"mjpeg": mjpeg, "libav": libav, "cv2": n_mp4 + n_avi - mjpeg - libav}


def decode_rates(vid_dir: str, built: dict, cv2, smi: str) -> None:
    """Frames/s of each engine that can run here, 640x360 -> 256^2, over the
    clips it handles (host clock, one pass after a warm-up clip)."""
    from multimodal_deepfake_detection_tpu_torch.data import native_video

    size = (INGEST_SIZE, INGEST_SIZE)
    paths = sorted(os.path.join(vid_dir, f) for f in os.listdir(vid_dir))

    def cv2_decode(path):
        cap, frames = cv2.VideoCapture(path), []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(cv2.resize(cv2.cvtColor(f, cv2.COLOR_BGR2RGB), size))
        cap.release()
        return np.stack(frames)

    engines = {}
    avis = [p for p in paths if p.endswith(".avi")]
    if built["video_decode"] is None and avis:
        engines["mjpeg"] = (lambda p: native_video.decode_video(p, size=size), avis)
    if built["video_decode_av"] is None:
        engines["libav"] = (lambda p: native_video.decode_video_av(p, size=size), paths)
    if cv2 is not None:
        engines["cv2"] = (cv2_decode, paths)
    for name, (fn, ps) in engines.items():
        fn(ps[0])
        t0, frames = time.perf_counter(), 0
        for p in ps:
            frames += fn(p).shape[0]
        dt = time.perf_counter() - t0
        say(f"ingest decode {name}: {frames} frames of {INGEST_HW[1]}x{INGEST_HW[0]} -> "
            f"{INGEST_SIZE}^2 in {dt * 1e3:.2f} ms, {frames / dt:.1f} frames/s (host clock; {smi})")
    for name in ("mjpeg", "libav", "cv2"):
        if name not in engines:
            say(f"ingest decode {name}: not timed, the engine is absent on this host")


def ingest_serve(torch, workdir: str, vid_dir: str, built: dict, smi: str) -> None:
    """The video files through ``cli/serve.py --engine visual`` on phase 4's
    bundle (K1 counted, engine counts asserted), against the same decoded
    frames as ``.npy`` through the same CLI; the CLI's clips/s on both."""
    from multimodal_deepfake_detection_tpu_torch.cli import serve as cli_serve
    from multimodal_deepfake_detection_tpu_torch.data.native_video import reset_engine_counts

    bundle = visual_inputs(torch, workdir)[0]
    n_avi = sum(f.endswith(".avi") for f in os.listdir(vid_dir))
    n = len(INGEST_T) + n_avi
    calls = -(-n // BATCH_SIZE)
    flags = ["--frame_size", str(INGEST_SIZE), "--max_frames", "75"]
    reset_engine_counts()
    scores = run_cli(torch, workdir, visual_argv(bundle, vid_dir), "ingest videos", flags,
                     per_call(calls, k1=8), n_inputs=n)
    counts, want = engine_counts(), expected_engines(built, len(INGEST_T), n_avi)
    say(f"ingest videos: clips served per engine {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"decode engines served {counts}, expected {want}")
    npy_dir = os.path.join(workdir, "ingest_npy")
    os.makedirs(npy_dir)
    cfg = cli_serve.parse_config(flags)
    for f in sorted(os.listdir(vid_dir)):
        np.save(os.path.join(npy_dir, os.path.splitext(f)[0] + ".npy"),
                cli_serve._load_visual_item(os.path.join(vid_dir, f), cfg))
    ref = run_cli(torch, workdir, visual_argv(bundle, npy_dir), "ingest npy of the frames",
                  flags, per_call(calls, k1=8), n_inputs=n)
    d = float(np.abs(scores - ref).max())
    say(f"ingest videos against the same frames as .npy: scores max|d| {d:.3e} "
        f"(<= {INGEST_NPY_TOL:.0e}); scores {np.round(scores, 4).tolist()}")
    if not d <= INGEST_NPY_TOL:
        raise AssertionError(f"decoded videos score off their .npy frames by {d}")
    # the CLI's scoring loop alone (bundle loaded once), videos and .npy in turns
    cfg = cli_serve.parse_config(visual_argv(bundle, vid_dir) + flags)
    engine = cli_serve.build_engine(cfg)
    lists = {k: cli_serve._list_inputs(d, (".npy",) + cli_serve.VIDEO_EXTS)
             for k, d in (("videos", vid_dir), ("npy", npy_dir))}
    runs = {k: [] for k in lists}
    for _ in range(2):
        for k, paths in lists.items():
            t0 = time.perf_counter()
            for i in range(0, n, BATCH_SIZE):
                cli_serve._score_chunk(engine, cfg, paths[i:i + BATCH_SIZE])
            runs[k].append(time.perf_counter() - t0)
    say("ingest cli/serve.py scoring loop clips/s (load, decode, pad, score; bundle loaded "
        "once), 2 runs each in turns: " + "; ".join(
            f"{k} {[round(n / t, 2) for t in ts]}" for k, ts in runs.items())
        + f" ({n} clips of up to 75 frames, {INGEST_SIZE}^2, bf16, batch {BATCH_SIZE}; {smi})")


def ingest_train(torch, workdir: str, vid_dir: str, smi: str) -> None:
    """``train_visual --mode lavdf_raw`` for 2 epochs over a LAV-DF
    metadata.json of the clips; its bundle served on the videos (K1
    counted); ``test_visual --mode lavdf_raw`` on the test split."""
    from multimodal_deepfake_detection_tpu_torch.cli import test_visual, train_visual

    meta = [{"file": f"clip{i}.mp4", "split": split,
             "fake_periods": [[0.1, 0.5]] if i % 2 else [], "n_fakes": i % 2}
            for i, split in enumerate(INGEST_SPLITS)]
    meta_path = os.path.join(workdir, "lavdf_metadata.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    ck = os.path.join(workdir, "ingest_train")
    size = f"{INGEST_TRAIN_SIZE},{INGEST_TRAIN_SIZE}"
    logs = []
    t0 = time.perf_counter()
    history = counted(torch, "train_visual --mode lavdf_raw", lambda: train_visual.main(
        ["--mode", "lavdf_raw", "--train_folder", vid_dir, "--eval_folder", vid_dir,
         "--lavdf_json", meta_path, "--checkpoint_dir", ck, "--epochs", "2", "--frame_size",
         size, "--max_frames", str(INGEST_TRAIN_T), "--num_workers", "2", "--device", "cuda"],
        log=logs.append), per_call(0))
    secs = time.perf_counter() - t0
    for line in logs:
        say(f"train_visual lavdf_raw: {line}")
    bundle = os.path.join(ck, train_visual.Config.bundle_name)
    if len(history) != 2 or not os.path.exists(bundle):
        raise AssertionError("train_visual --mode lavdf_raw: no best bundle after 2 epochs")
    say(f"train_visual --mode lavdf_raw: 2 epochs in {secs:.1f} s (4 train, 2 dev clips of "
        f"<= {INGEST_TRAIN_T} frames at {INGEST_TRAIN_SIZE}^2, decoded each epoch; {smi})")
    n = len(os.listdir(vid_dir))
    run_cli(torch, workdir, visual_argv(bundle, vid_dir), "serve the lavdf_raw bundle",
            ["--frame_size", str(INGEST_TRAIN_SIZE), "--max_frames", "75"],
            per_call(-(-n // BATCH_SIZE), k1=8), n_inputs=n)
    report = []
    results = counted(torch, "test_visual --mode lavdf_raw", lambda: test_visual.main(
        ["--mode", "lavdf_raw", "--subset", "test", "--test_folder", vid_dir, "--lavdf_json",
         meta_path, "--ckpt_path", bundle, "--frame_size", size, "--device", "cuda"],
        log=report.append), per_call(0))
    say("test_visual --mode lavdf_raw report: " + " | ".join(
        line.strip() for line in report if line.strip()))
    if not np.isfinite(results["Accuracy"]):
        raise AssertionError("test_visual --mode lavdf_raw: no accuracy")


def ingest_collate(torch, workdir: str, smi: str) -> None:
    """The C++ npy collate on phase 9's audio tree: batches bit-equal to the
    Python loader's, ``train_audio --native_loader true`` for 2 epochs with
    its epoch losses within phase 9's loss bar of the ``false`` run (fp32),
    and batches/s of both loaders."""
    from multimodal_deepfake_detection_tpu_torch.cli import train_audio
    from multimodal_deepfake_detection_tpu_torch.data import synthetic
    from multimodal_deepfake_detection_tpu_torch.data.datasets import NpyFolderDataset
    from multimodal_deepfake_detection_tpu_torch.data.loader import DataLoader
    from multimodal_deepfake_detection_tpu_torch.data.native_loader import make_native_loader

    tree = synthetic.make_audio_npy_tree(os.path.join(workdir, "ingest_audio"), n_per_class=4,
                                         frames=120, seed=122)
    cfg = train_audio.Config()
    ds = NpyFolderDataset(tree + "/train", kind="audio")
    loaders = {"python": lambda: DataLoader(ds, cfg.batch_size, seed=cfg.seed,
                                            buckets=cfg.buckets),
               "native": lambda: make_native_loader(ds, cfg.batch_size, buckets=cfg.buckets,
                                                    seed=cfg.seed)}
    py, nat = list(loaders["python"]()), list(loaders["native"]())
    same = len(py) == len(nat) and all(
        a.dtype == b.dtype and np.array_equal(a, b) for p, q in zip(py, nat) for a, b in zip(p, q))
    say(f"ingest native collate: {len(nat)} batches of {tuple(nat[0][0].shape)} bit-equal to "
        f"the Python loader's: {same}")
    if not same:
        raise AssertionError("the native collate's batches differ from the Python loader's")
    rates = {}
    for name, make in loaders.items():
        loader = make()
        t0, n = time.perf_counter(), 0
        for _ in range(COLLATE_EPOCHS):
            n += sum(1 for _ in loader)
        rates[name] = n / (time.perf_counter() - t0)
    say(f"ingest loaders on phase 9's audio tree ({len(ds)} clips of 120 MFCC steps, batch "
        f"{cfg.batch_size}): native {rates['native']:.1f} batches/s, Python "
        f"{rates['python']:.1f} batches/s (host clock; {smi})")
    losses = {}
    for native in ("false", "true"):
        history = train_audio.main(
            ["--train_folder", tree + "/train", "--eval_folder", tree + "/eval",
             "--checkpoint_dir", os.path.join(workdir, f"ingest_audio_{native}"), "--epochs", "2",
             "--eval_every", "1", "--compute_dtype", "float32", "--native_loader", native,
             "--device", "cuda"], log=lambda s: None)
        losses[native] = np.array([[r.train_loss, r.eval_loss] for r in history])
    d = float(np.abs(losses["true"] - losses["false"]).max())
    bar = TRAIN_CPU_BARS["loss"]
    say(f"train_audio --native_loader true against false, 2 epochs fp32: epoch train/eval "
        f"losses {np.round(losses['true'], 6).tolist()}, max|d| {d:.3e} (<= {bar:.0e})")
    if not d <= bar:
        raise AssertionError(f"train_audio --native_loader: losses off the Python loader's by {d}")


def ingest_preprocess(torch, workdir: str, vid_dir: str, cv2) -> None:
    """``preprocess_audio`` on seeded .wav files, the card's MFCC .npy files
    against the CPU's (MFCC bar); ``preprocess_faces --mode fakeavceleb`` on
    the clips where cv2 imports."""
    import shutil

    from scipy.io import wavfile

    from multimodal_deepfake_detection_tpu_torch.cli import preprocess_audio, preprocess_faces

    root = os.path.join(workdir, "ingest_wav")
    rng = np.random.default_rng(161)
    for label in ("real", "fake"):
        os.makedirs(os.path.join(root, label))
        for i, secs in enumerate(INGEST_WAV_S):
            wav = (rng.normal(0, 0.1, int(secs * 16000)) * 32767).astype(np.int16)
            wavfile.write(os.path.join(root, label, f"clip{i}.wav"), 16000, wav)
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(workdir, f"ingest_mfcc_{dev}")
        written = preprocess_audio.main(["--dataset_root", root, "--out_root", outs[dev],
                                         "--device", dev], log=lambda s: None)
    files = sorted(os.path.join(s, f) for s in ("train", "eval", "test")
                   for f in os.listdir(os.path.join(outs["cpu"], s)))
    d = max(float(np.abs(np.load(os.path.join(outs["cuda"], f)) -
                         np.load(os.path.join(outs["cpu"], f))).max()) for f in files)
    say(f"preprocess_audio: {len(written)} clips, {len(files)} .npy files, the card's MFCC "
        f"against the CPU's max|d| {d:.3e} (<= {MFCC_TOL:.0e})")
    if len(files) != 3 * len(written) or not d <= MFCC_TOL:
        raise AssertionError(f"preprocess_audio on the card: {len(files)} files, max|d| {d}")
    if cv2 is None:
        say("preprocess_faces: not run, cv2 is absent on this host (it decodes the videos)")
        return
    src = os.path.join(workdir, "ingest_favc")
    for i in range(4):
        d_ = os.path.join(src, "real" if i % 2 == 0 else "fake", "id0")
        os.makedirs(d_, exist_ok=True)
        shutil.copy(os.path.join(vid_dir, f"clip{i}.mp4"), d_)
    out = os.path.join(workdir, "ingest_frames")
    written = preprocess_faces.main(["--dataset_root", src, "--out_root", out, "--mode",
                                     "fakeavceleb"], log=lambda s: None)
    shapes = sorted({np.load(os.path.join(out, s, f)).shape[1:] for s in os.listdir(out)
                     for f in os.listdir(os.path.join(out, s))})
    say(f"preprocess_faces --mode fakeavceleb: {len(written)} clips -> frame stacks of "
        f"{shapes} uint8")
    if len(written) != 4 or shapes != [(256, 256, 3)]:
        raise AssertionError(f"preprocess_faces wrote {written}, {shapes}")


def reference_state_dict(torch, trees: dict) -> dict:
    """A JAX-layout ``{model, arcface, state}`` XceptionLSTMV bundle in the
    reference's ``.pth`` layout, ``{"model": state_dict, "arcface":
    {"weight"}}``: ``feature_extractor.`` Xception keys (conv OIHW, depthwise
    ``(C, 1, 3, 3)``, ``blockN.rep.i`` with the ReLU slots of
    ``start_with_relu``, ``skip``/``skipbn``, BN running statistics), the
    LSTM's ``weight_ih_l0``, ``fc_layers.{0,3,6,9}``, ``fc_out``."""
    from multimodal_deepfake_detection_tpu_torch.models.xception import XCEPTION_BLOCK_SPECS

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    params, state = trees["model"], trees["state"]["backbone"]
    bb = params["backbone"]
    sd = {}

    def conv(key, w):
        sd[key + ".weight"] = t(np.transpose(w, (3, 2, 0, 1)))

    def bn(key, p, s):
        sd.update({key + ".weight": t(p["scale"]), key + ".bias": t(p["bias"]),
                   key + ".running_mean": t(s["mean"]), key + ".running_var": t(s["var"]),
                   key + ".num_batches_tracked": torch.tensor(0)})

    def sep(key, p):
        conv(key + ".conv1", p["depthwise"]["w"])
        conv(key + ".pointwise", p["pointwise"]["w"])

    fe = "feature_extractor."
    for name in ("conv1", "conv2"):
        conv(fe + name, bb[name]["w"])
    for name in ("bn1", "bn2", "bn3", "bn4"):
        bn(fe + name, bb[name], state[name])
    for b, (spec, bp, bs) in enumerate(zip(XCEPTION_BLOCK_SPECS, bb["blocks"], state["blocks"])):
        idx = 0
        for j, (up, us) in enumerate(zip(bp["units"], bs["units"])):
            idx += 1 if (j > 0 or spec[4]) else 0  # the ReLU slot
            sep(f"{fe}block{b + 1}.rep.{idx}", up["sep"])
            bn(f"{fe}block{b + 1}.rep.{idx + 1}", up["bn"], us["bn"])
            idx += 2
        if "skip" in bp:
            conv(f"{fe}block{b + 1}.skip", bp["skip"]["conv"]["w"])
            bn(f"{fe}block{b + 1}.skipbn", bp["skip"]["bn"], bs["skip"]["bn"])
    sep(fe + "conv3", bb["conv3"])
    sep(fe + "conv4", bb["conv4"])
    for k in ("w_ih", "w_hh"):
        sd[f"lstm.weight_{k[2:]}_l0"] = t(params["lstm"][k].T)
    for k in ("b_ih", "b_hh"):
        sd[f"lstm.bias_{k[2:]}_l0"] = t(params["lstm"][k])
    for slot, layer in zip((0, 3, 6, 9), params["fc_layers"]):
        sd[f"fc_layers.{slot}.weight"], sd[f"fc_layers.{slot}.bias"] = t(layer["w"].T), t(layer["b"])
    sd["fc_out.weight"], sd["fc_out.bias"] = t(params["fc_out"]["w"].T), t(params["fc_out"]["b"])
    return {"model": sd, "arcface": {"weight": t(trees["arcface"]["w"])}}


def ingest_import(torch, workdir: str, bundle: str, smi: str) -> None:
    """``import_torch`` on phase 4's bundle written as a reference ``.pth``:
    the imported bundle equal to the original array for array, served
    through ``cli/serve.py --engine visual`` (K1 counted) to the original's
    scores, and its fp32 scores on the card (the plain path: K1's GEMM takes
    bf16 operands) within 1e-4 of the CPU's."""
    from multimodal_deepfake_detection_tpu_torch.cli import import_torch
    from multimodal_deepfake_detection_tpu_torch.core.checkpoint import (
        _flatten_with_paths,
        load_bundle,
    )
    from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer

    trees = load_bundle(bundle)
    pth, out = os.path.join(workdir, "reference.pth"), os.path.join(workdir, "imported.npz")
    torch.save(reference_state_dict(torch, trees), pth)
    import_torch.main(["--src", pth, "--dst", out], log=say)
    a, b = _flatten_with_paths(trees), _flatten_with_paths(load_bundle(out))
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    say(f"import_torch: {len(b)} arrays, equal to the original bundle's: {same}")
    if not same:
        raise AssertionError("import_torch's bundle differs from the original")
    clip_dir = visual_inputs(torch, workdir)[1]
    calls = -(-len(CLIP_LENGTHS) // BATCH_SIZE)
    got = run_cli(torch, workdir, visual_argv(out, clip_dir), "serve the imported bundle", [],
                  per_call(calls, k1=8))
    ref = run_cli(torch, workdir, visual_argv(bundle, clip_dir), "serve the original bundle",
                  [], per_call(calls, k1=8))
    d = float(np.abs(got - ref).max())
    say(f"import_torch: the imported bundle served against the original, max|d| {d:.3e}")
    if d != 0:
        raise AssertionError(f"the imported bundle scores off the original by {d}")
    frames = np.stack([c[:2] for c in visual_inputs(torch, workdir)[2][:2]])
    kw = dict(compute_dtype=torch.float32, use_kernels=False)
    card = VisualScorer.from_bundle(out, device="cuda", **kw).score(frames)
    cpu = VisualScorer.from_bundle(out, device="cpu", **kw).score(frames)
    d = float(np.abs(card - cpu).max())
    say(f"import_torch: the imported bundle's fp32 scores, card against CPU (2 clips x 2 "
        f"frames of 256^2): max|d| {d:.3e} (<= {EVAL_CPU_TOL:.0e}; {smi})")
    if not d <= EVAL_CPU_TOL:
        raise AssertionError(f"imported bundle: card fp32 off the CPU's by {d}")


def phase_ingest(torch, workdir: str, smi: str) -> None:
    """Phase 12: video and data ingestion."""
    from multimodal_deepfake_detection_tpu_torch.data import native_build

    t_phase = time.perf_counter()
    built = native_build.build()
    host = host_report(built)
    cv2, libav = host["cv2"], built["video_decode_av"] is None
    vid_dir = os.path.join(workdir, "ingest_videos")
    steps = []
    if cv2 is None and not libav:
        say("ingest: no decode engine built and cv2 is absent: the video serve path, "
            "train_visual --mode lavdf_raw and preprocess_faces cannot run on this host")
    else:
        say(f"ingest clips written by {write_ingest_clips(vid_dir, cv2, libav)}")
        if not libav:
            say("ingest: the libav engine did not build, so the clips are not H.264 and no "
                "clip is decoded natively as mp4")
        if built["video_decode"] is not None:
            say("ingest: the MJPEG engine did not build: the .avi goes to "
                + ("libav" if libav else "cv2"))
        steps += [("decode rates", lambda: decode_rates(vid_dir, built, cv2, smi)),
                  ("serve videos", lambda: ingest_serve(torch, workdir, vid_dir, built, smi)),
                  ("lavdf_raw train and test", lambda: ingest_train(torch, workdir, vid_dir,
                                                                     smi))]
    if built["npy_collate"] is None:
        steps.append(("native collate", lambda: ingest_collate(torch, workdir, smi)))
    else:
        say("ingest: the native npy collate did not build: train_audio --native_loader "
            "cannot run on this host")
    steps += [("preprocess", lambda: ingest_preprocess(torch, workdir, vid_dir, cv2)),
              ("import_torch", lambda: ingest_import(
                  torch, workdir, visual_inputs(torch, workdir)[0], smi))]
    for label, step in steps:
        t0 = time.perf_counter()
        step()
        say(f"ingest {label} took {time.perf_counter() - t0:.1f} s")
    say(f"phase 12 (ingestion) took {time.perf_counter() - t_phase:.1f} s")

def main() -> int:
    t_start = time.perf_counter()
    import torch

    import multimodal_deepfake_detection_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device(torch)
    phase_build()
    with NoTF32(torch):
        max_err = phase_kernels(torch)
        audio_err = phase_audio_kernels(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches = phase_slice(torch, workdir)
        # the times before the audio phase: in two of three runs of the other
        # order, torch.profiler on the card lost one of K1's three depthwise
        # launches per call in every window after the audio phase
        times = phase_times(torch, smi, workdir)
        audio_times = phase_audio_times(torch, smi, workdir)
        audio_launches = phase_audio(torch, workdir, smi)
        phase_au(torch, workdir, smi)
        phase_train(torch, workdir, smi)
        phase_au_train(torch, workdir, smi)
        artifact_launches = phase_artifacts(torch, workdir, smi)
        phase_eval(torch, workdir, smi)
        phase_ingest(torch, workdir, smi)
    say(f"all phases done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCES[name][0],
        "replaces": SOURCES[name][1],
        "launches": launches[name],
        "max_abs_err": max_err[name],
        "ms": times[name][0]["kernel"],
        "plain_ms": times[name][0]["plain"],
        "bound_ms": times[name][1][0],
        "bound_by": times[name][1][1],
        "library_ms": times[name][0]["library"],
        "audio": {  # the same readings on the audio path, at its shapes
            "launches": audio_launches[name],
            "max_abs_err": audio_err[name],
            "ms": audio_times[name][0]["kernel"],
            "plain_ms": audio_times[name][0]["plain"],
            "bound_ms": audio_times[name][1][0],
            "bound_by": audio_times[name][1][1],
            "library_ms": audio_times[name][0]["library"],
        },
        # launches per backbone call on the exported program that runs it
        "artifact": {"launches": artifact_launches[name]},
    } for name in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
