"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without a CUDA card, or
without the rest of the repository beside this file, it exits non-zero and
prints no result):

0. the card's name and power limit; build every CUDA kernel from csrc/
   (one nvcc per source, all started together), with each source's build
   time, the most registers a kernel instance uses, the instances that
   spill registers and those whose wgmma ptxas serialises.
1. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, in float32 and bfloat16, with its time (CUDA events
   around back-to-back calls, and on the device alone by torch.profiler; a
   case whose first exceeds its second 1.5x is marked host-bound), the
   plain version's time, a PyTorch library yardstick's times and the card's
   bound:
   B1 in bfloat16 on the tensor cores (flash_attention_tc) and in float32
   as three TF32 products on the tensor cores (flash_attention), B2 likewise
   (flash_attention_rotary_tc, flash_attention_rotary; beside SDPA it is
   also timed against the default dispatcher's host rotary + B1), B3 in
   bfloat16 on the tensor cores (swiglu_tc) and in float32 as three TF32
   products on the tensor cores (swiglu; also within F32_TOL's allowance of
   the function in float64). Also B1 at SD v1.4's 1024 px
   shapes: (2, 16384, 8, 40), (2, 4096, 8, 80) and (2, 1024, 8, 160), head
   dim 160 in both dtypes; B1 at (2, 1024, 8, D) for D in 20, 100, 136, 152,
   168, 200 and 256, a ragged GQA call at D = 200 with kv_len and an sp
   query block at D = 256, and B2 at (2, 1025, 8, 256) with rot 64, in
   both dtypes.
2. one full-width AudioLDM-s UNet forward (random seeded weights, batch 2
   on the (8, 256, 16) latent of a 10 s clip) on the card, through the
   kernel, against the same forward on the CPU, through the plain version;
   and the same UNet in bfloat16 on the card (B1-tc) against the float32
   CPU forward, within 1.25x the error of the bf16 forward through the
   plain version on the card.
2b. a full-width Stable Audio DiT forward cut to 2 of its 24 layers (batch
   2 on the (64, 1024) latent), card against CPU, through B1 + B3 and,
   with AEC_ROTARY_IN_KERNEL=1, through B2 + B3; the same DiT in bfloat16
   on the card (B1-tc + B3-tc, then B2-tc + B3-tc) against the float32 CPU
   forward, within 1.25x the error of the bf16 forward through the plain
   versions on the CPU; and the full-width Oobleck encode and decode on 16
   latent frames, card against CPU.
2c. the finite-difference probe of PC extraction, ab = x0(xt + c v) -
   x0(xt) at c = 1e-3 for one PC (batch 2), on the full-width AudioLDM-s
   UNet and on phase 2b's 2-layer DiT, in float32 on the card (3xTF32
   kernels) against the card's plain versions, each against a float64
   probe on the card; and the card against the CPU's float32 probe. It runs
   after phase 8a, as does 2d: their float32 CPU forwards (the UNet probe,
   the three family forwards) run in a background thread beside phase 8a,
   on all cores but two, so that no main-path loop shares the host with
   them.
3. the AudioLDM-s main path: the port CLI's ``--mode ours`` edit of a
   synthetic 10 s clip at 200 inversion + 100 edit steps, once as an edit
   and once with ``--selfcheck`` in float32, and once as a ``--dtype
   bfloat16`` edit; B1 must launch 20 times per UNet forward, on the
   3xTF32 route in float32 and on the tensor-core route in bfloat16.
4. the Stable Audio Open main path: the CLI's ``--mode ours`` edit of a
   synthetic 10 s, 44.1 kHz stereo clip at 100 inversion + 50 edit steps,
   in float32 with ``--selfcheck`` (>= 40 dB) and as an edit with
   AEC_ROTARY_IN_KERNEL=1, and in bfloat16 with ``--selfcheck`` (>= 40 dB),
   also with AEC_ROTARY_IN_KERNEL=1; B1 (B2 in the rotary runs) and B3 must
   each launch 24 times per DiT forward, on the 3xTF32 routes in float32
   and on the tensor-core routes in bfloat16.
5. AudioLDM-s PC editing through the port's CLIs on phase 3's clip: PC
   extraction in float32 (200 steps, 2 PCs, 50 power iterations at the one
   window step 100), then its application in bfloat16 along
   both PCs at amount 0 and at amount 2 (each amount-2 wav must differ from
   the amount-0 wav of its PC, and the two PCs' wavs from each other), and
   in float32 along PC 1 at amount 0, which must give back the extraction's
   drift-free wav.
6. Stable Audio PC editing likewise on phase 4's clip (100 steps, one
   window step, 50); the float32 amount-0 application also shows that the
   application conditions on the duration the extraction recorded.
2d. one full-width UNet forward of each other mel family, AudioLDM2-music
   (two transformers per attention position, one per text stream),
   AudioLDM-l and TANGO (B1 at head dims 40 and 80), batch 1 on the (8,
   256, 16) latent: float32 card against CPU; bfloat16 on the card against
   the float32 CPU forward, within 1.25x the error of the same bf16 forward
   on the card through the plain versions.
7. the baselines through the port's CLIs on phases 3 and 4's clips:
   AudioLDM-s ``--mode ddim`` (200 steps, tstart 100) in float32, bfloat16
   and with ``--selfcheck`` (SNR reported, not gated); SDEdit
   (``cli/sdedit.py``) on AudioLDM-s (200 steps, tstart 100) and on Stable
   Audio (100 steps, tstart 50, Brownian noise) in float32 and bfloat16;
   each wav must differ from its orig.wav.
8a. a full-width AudioLDM2-music checkpoint from seeded random modules in
   the diffusers/transformers layout a user downloads (unet/, vae/,
   vocoder/, language_model/, projection_model/ with the key sets of the
   vendored manifests data/key_manifests/cvssp__audioldm2-music;
   text_encoder/ a full CLAP model at transformers' default geometry,
   text_encoder_2/ T5 at FLAN-T5-large's config; tokenizer/ as vocab.json
   + merges.txt, tokenizer_2/ as tokenizer.json), converted into a
   ``weights_dir`` by the port's converter (``cli/convert_checkpoint.py``:
   seconds, bytes read and written), loaded back on the card bit-equal
   to the seeded modules (each file's bytes and load seconds); the
   tokenizer built from vocab.json + merges.txt against the tokenizer.json
   it was made from (ids and masks equal); the full-width text chain card
   vs CPU (<= 1e-3 max relative error).
8. ``--mode ours`` on the other families on phase 3's clip: AudioLDM2-music
   from phase 8a's converted checkpoint at 50 + 25 steps as a float32
   selfcheck and a bfloat16 edit; AudioLDM-l and TANGO as selfchecks at
   20 + 10 steps in float32 and bfloat16; every selfcheck >= 40 dB.
9. the generation, long-form, batch and sweep CLIs through their main(argv)
   at full width: AudioLDM-s generation (25 steps), style transfer at
   strength 0.5 and at 0 (which must give back the VAE round trip of the
   input), inpainting of seconds 3-6 and super-resolution in float32, and
   generation and inpainting in bfloat16; Stable Audio generation and
   inpainting in bfloat16 (50 steps, Brownian noise); long-form edits
   (50 + 25 steps) of a 25 s clip in three AudioLDM-s windows (float32
   and bfloat16: B1 at batch 6) and of a 15 s stereo clip in two Stable
   Audio windows (bfloat16: B1 at batch 4, B3 at M = 4100); a float32 batch
   of three AudioLDM-s clips of 10, 7.5 and 5 s; a float32 2 x 2 tstart x
   cfg_tar sweep. Checks: window 0 of the float32 long-form edit against
   its single-window edit (<= 1e-3 max relative error), inpainting's kept
   region bit-exact (run_args.json), each sweep point bit-equal to
   ``cli/run.py --mode ours`` at its tstart and cfg_tar, both with cuDNN's
   deterministic algorithms.
8b. the real-weight runbook (``cli/validate_real_weights.py``,
   ``aetorch-validate``) through its main(argv) on phase 8a's
   AudioLDM2-music source tree (kept until here, then deleted): the steps
   manifest, convert, selfcheck, edit and page, the ours, ddim and sdedit
   lanes, 20 + 10 steps in float32 on phase 3's clip. Checks: every step
   PASS, the manifest step counts the vendored manifests' tensors, the
   selfcheck >= 40 dB, each CLI run at 20 B1 launches per UNet forward
   (counted from 0 around each run), ``supp.html`` with the three lanes and
   its copied audio; each step's seconds.
10a. a full-width Stable Diffusion v1.4 checkpoint from seeded random
   modules, written by the port (UNet, VAE, the CLIP text tower at CLIP
   ViT-L/14's text config with a small CLIP-shaped tokenizer; phase 8a's
   checkpoint is deleted first), loaded back on the card bit-equal; the
   CLIP tower card vs CPU (<= 1e-3); one SD UNet CFG forward at 256 px
   (B1 at (2, 1024, 8, 40)) card vs CPU in float32 (<= 1e-3) and in
   bfloat16 (within 1.25x the error of the bf16 plain versions on the
   card); the full-width CelebA-HQ VQ autoencoder card vs CPU (codes equal
   off near-ties, the unquantized decode <= 1e-4).
10. the image CLIs through their main(argv): SDEdit on SD from phase 10a's
   checkpoint at 512 px (100 steps, tstart 50) in float32 and bfloat16;
   PC extraction at 256 px (float32, one PC, 50 iterations at two window
   steps) and its applications in bfloat16 at amounts 0 and 2 and in
   float32 at amount 0 (within 1 uint8 step of the drift-free image); SDEdit
   on the seeded CelebA-HQ LDM at 256 px (no kernel launch); SDEdit on SD at
   1024 px (``-r 1024 1024``, 4 forwards) in float32 and bfloat16, with its
   launches at head dim 160 counted (5 per forward). Every output
   PNG decodes through the port's reader at the expected size and differs
   from orig.png. Then image input: the committed inputs of
   tests/data/images (a 512 x 384 4:2:0 baseline JPEG with restart
   markers, a 16-bit Adam7 RGB PNG, a 333 x 251 4:2:2 progressive JPEG
   with restart markers, a 512 x 384 lossy WebP with alpha, a lossless
   WebP, a tiled LZW + predictor-2 TIFF, an interlaced GIF with a local
   table, a progressive CMYK JPEG, an RLE8 BMP, a 512 x 384
   JPEG-in-TIFF, CMYK, YCbCr, CIELab, float32 and signed 16-bit TIFFs, a
   BigTIFF, an animated WebP, a 10-bit PPM, an RLE TGA, an ICO, a lossless
   and an arithmetic-coded progressive JPEG, a 512 x 384 PackBits PSD, a
   16-bit RLE SGI, an 8-bit RLE PCX with its palette, a two-page DCX, a
   QOI, an RLE Sun raster with a colour map, an MSP version 2, an XBM, an
   XPM, a palette IM, an FLC with a BRUN first frame, a turned Photo CD
   base image, an IPTC record holding a JPEG, an ICNS with an it32 entry,
   a 512 x 384 DXT1 DDS, a BC7 DDS, a BLP1 JPEG, a DXT1 FTEX, a 512 x 384
   9/7 JPEG 2000 photo, a tiled RPCL 5/3 raw codestream, a hand-built
   sYCC 4:2:0 JPEG 2000 with an odd origin, 1728 x 2200 fax pages in
   CCITT Group 4 and 2-D Group 3, 512 x 384 Zstandard (predictor 2) and
   LZMA TIFF photos, a GZIP_1 tile-compressed FITS, a planar JPEG-in-TIFF,
   a 12-bit greyscale JPEG-in-TIFF, an old-style JPEG-in-TIFF over strips,
   cut-short LZW and JPEG YCbCr TIFFs, a JPEG 2000 codestream with Part 2
   MCT/MCC/MCO markers, a simple-filter lossy WebP, and damaged JPEG data:
   the restart JPEG with RST3 renumbered RST4 and with a restart marker
   deleted, and a byte XOR-ed in the progressive, the arithmetic-coded,
   the lossless JPEG and a JPEG-in-TIFF tile) decoded
   by the port's readers to the sha256 of PIL's decode
   (tests/data/images/sha256.json), each decode's seconds printed, and
   bfloat16 SD SDEdits at 512 px from the JPEG with RST3 renumbered, from
   the WebP, from the JPEG-in-TIFF, from the PSD, from the DXT1 DDS and
   from the 9/7 JPEG 2000.
11. the edit server (serve.py) on 127.0.0.1 over HTTP at 50 steps in
   bfloat16: AudioLDM-s (/healthz, three edits, two concurrent requests
   each bit-equal to the same request alone, a response bit-equal to
   EditService.edit in process, 400 for a malformed body and for tstart
   out of range), then Stable Audio with a 5 s and a 10 s clip, each
   response cropped to its clip; each request's wall and loop seconds.
12a. the kernels on the parallel paths' shapes, in one process: B1 over
   each sp block (sp 2 and 4) of the DiT's padded 1025 tokens against the
   whole padded K/V with kv_len 1025; B3 over the tp column shards (tp 2
   and 4: matching value and gate row blocks of the SwiGLU weight) and over
   the sp row blocks of the CFG pair's padded tokens; float32 and bfloat16,
   each against the unsharded kernel (bit-equal expected) and its plain
   version.
12. the --sp 1 rehearsal of sequence parallelism: phase 4's float32 Stable
   Audio selfcheck and edit at 20 + 10 steps (100 + 50 until PR 24) through
   ``cli/run.py --sp 1``, in a real NCCL process group of one: B1 launched
   24 times per forward at (2, 1032, 24, 64) against (2, 1032, 12, 64) with
   kv_len 1025, B3 24 times, the selfcheck within 1 dB of the one without
   --sp, the edited latent within 1e-3 of the edit without --sp. (NCCL
   takes one rank per card: groups of several ranks run on the CPU tests'
   gloo ranks and on machines with as many cards.)
13. the eval tower: a seeded CLAP checkpoint at transformers' default
   audio and text geometry (HTSAT-base, RoBERTa-base, projection 512) in
   the layout ClapModel.from_pretrained reads, written by the port's
   safetensors writer and loaded back on the card bit-equal; the towers'
   stages, pooled output and embeddings card vs CPU (<= 1e-3 max relative
   error); ``cli/evals_run.py`` on phase 9's sweep tree and phase 7's SDEdit
   trees (one row per wav, every score finite, the keys those of the wavs)
   and FAD between phase 3's clip with its windows and the sweep's edits
   (FAD of a set with itself <= 1e-6 of it); LPAPS of a clip with itself
   0; a short float32 ``cli/run.py --profile_dir`` edit, whose trace must
   be written and whose wav must be bit-equal to the same edit without it.
From phase 3 on, each CLI run's seeded weights and checkpoint reads are
reused from an earlier run that built the same ones (``reuse_setup``).
Every kernel launch count is set to 0 just before each main-path run and
read just after it; each run is held to its launches per denoiser forward
(its run_args.json counts the forwards of each stage). Each phase's
seconds are printed, and the script's in all (``script_s``).

The line before the last holds ``nvidia-smi``'s name and power limit, the
one before it the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` adds a torch.profiler breakdown of one
CFG denoiser step of each main path, in float32 and in bfloat16, of the
bfloat16 Stable Audio step with AEC_ROTARY_IN_KERNEL=1, of each model's
float32 power-iteration step at two PCs (a batch-4 forward), and of the
AudioLDM2-music step in float32 and bfloat16 (device time by kernel class,
the device's idle share) before the final lines.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

MODEL_ID = "cvssp/audioldm-s-full-v2"
STEPS, TSTART = 200, 100  # the bench.py edit config: 300 CFG UNet forwards
LATENT = (8, 256, 16)  # a 10 s clip: 1024 mel frames
ATTN_CALLS_PER_FORWARD = 20  # 10 at (16, 4096, 16) + 10 at (16, 1024, 32)

SA_MODEL_ID = "stabilityai/stable-audio-open-1.0"
SA_STEPS, SA_TSTART = 100, 50  # bench.py's Stable Audio config: 150 CFG DiT forwards
SA_LATENT = (64, 1024)  # every clip is padded to 1024 x 2048 samples
SA_CALLS_PER_FORWARD = 24  # one B1 (or B2) and one B3 launch per DiT layer
SA_PARITY_LAYERS = 2  # phase 2b's cut of the 24 layers
# phase 2b's bf16 bound, as a multiple of the plain bf16 forward's own error
BF16_FORWARD_RATIO = 1.25
# each main path's edit: steps, tstart, target prompt, the clip's rate and channels
EDITS = {MODEL_ID: (STEPS, TSTART, "a dog barking", {"sr": 16000, "channels": 1}),
         SA_MODEL_ID: (SA_STEPS, SA_TSTART, "a cello", {"sr": 44100, "channels": 2})}

# the other mel UNet families (phases 2d and 8), each with the B1 launches
# of one forward on the (8, 256, 16) latent: a launch per self-attention at
# S >= 1024 (the two finest levels, 5 attention positions each). AudioLDM-l:
# attn1 and attn2 (self-attention without context) of one transformer per
# position, D = 32 at S = 4096 and 64 at 1024. AudioLDM2: two transformers
# per position (one per conditioning stream), each with its attn1; attn2 is
# cross-attention and takes the plain path; D = 16 and 32 (-music). TANGO:
# one transformer per position, attn1 only; D = 40 and 80.
REPO = os.path.dirname(os.path.abspath(__file__))
A2_MODEL_ID = "cvssp/audioldm2-music"
AL_MODEL_ID = "cvssp/audioldm-l-full"
TANGO_MODEL_ID = "declare-lab/tango-full-ft-audiocaps"
FAMILY_CALLS_PER_FORWARD = {A2_MODEL_ID: 20, AL_MODEL_ID: 20, TANGO_MODEL_ID: 10}
# phase 8's edits of phase 3's clip: AudioLDM2-music at 50 inversion + 25
# edit steps, AudioLDM-l and TANGO at 20 + 10 (cut from the bench.py config
# and 50 + 25 to keep the script's time)
A2_STEPS, A2_TSTART = 50, 25
SHORT_STEPS, SHORT_TSTART = 20, 10
EDITS.update({A2_MODEL_ID: (A2_STEPS, A2_TSTART) + EDITS[MODEL_ID][2:],
              AL_MODEL_ID: (SHORT_STEPS, SHORT_TSTART) + EDITS[MODEL_ID][2:],
              TANGO_MODEL_ID: (SHORT_STEPS, SHORT_TSTART) + EDITS[MODEL_ID][2:]})

# H100 SXM data-sheet peaks (dense rates at the 700 W limit). Exponentials
# run on the SFU: 16 results per clock per SM (NVIDIA's CUDA documentation,
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# the 1.98 GHz boost clock that the 67 TFLOP/s float32 figure assumes.
# float32 attention and SwiGLU run each product as three TF32 products on
# the tensor cores (495 TFLOP/s), the least time at float32 accuracy.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TF32X3_FLOPS_PER_S = 495e12 / 3
EXP_PER_S = 16 * 132 * 1.98e9
# a phase-1 case is host-bound where its back-to-back time by CUDA events
# exceeds its device-only time by more than this factor
HOST_BOUND = 1.5

# (B, S, H, H_kv, D): the two AudioLDM-s UNet levels, then the Stable Audio
# DiT's attn1 (ragged S = 1025 with the global token, 24 q / 12 kv heads),
# at the edit's CFG batch 2; then each at batch 4 (the PC paths' two PCs
# times the CFG pair, and the Stable Audio long-form edit's two windows)
ATTN_CASES = [
    ((2, 4096, 8, 8, 16), torch.float32),
    ((2, 1024, 8, 8, 32), torch.float32),
    ((2, 4096, 8, 8, 16), torch.bfloat16),
    ((2, 1024, 8, 8, 32), torch.bfloat16),
    ((2, 1025, 24, 12, 64), torch.float32),
    ((2, 1025, 24, 12, 64), torch.bfloat16),
    ((4, 4096, 8, 8, 16), torch.float32),
    ((4, 1024, 8, 8, 32), torch.float32),
    ((4, 4096, 8, 8, 16), torch.bfloat16),
    ((4, 1024, 8, 8, 32), torch.bfloat16),
    ((4, 1025, 24, 12, 64), torch.float32),
    ((4, 1025, 24, 12, 64), torch.bfloat16),
    # the AudioLDM-s long-form edit's batch 6: three windows times the CFG
    # pair (phase 9)
    ((6, 4096, 8, 8, 16), torch.float32),
    ((6, 1024, 8, 8, 32), torch.float32),
    ((6, 4096, 8, 8, 16), torch.bfloat16),
    ((6, 1024, 8, 8, 32), torch.bfloat16),
    # the other UNet families' shapes at the CFG batch: AudioLDM-l (D = 32
    # at S = 4096, 64 at 1024), TANGO (40 and 80), AudioLDM2-large (48 at
    # 1024); the tensor-core kernel pads D = 40, 48 and 80 to 64 and 128
    # by the TMA's zero fill
    ((2, 4096, 8, 8, 32), torch.float32),
    ((2, 4096, 8, 8, 32), torch.bfloat16),
    ((2, 1024, 8, 8, 64), torch.float32),
    ((2, 1024, 8, 8, 64), torch.bfloat16),
    ((2, 4096, 8, 8, 40), torch.float32),
    ((2, 4096, 8, 8, 40), torch.bfloat16),
    ((2, 1024, 8, 8, 80), torch.float32),
    ((2, 1024, 8, 8, 80), torch.bfloat16),
    ((2, 1024, 8, 8, 48), torch.float32),
    ((2, 1024, 8, 8, 48), torch.bfloat16),
    # SD v1.4 at 256 px (phases 10a and 10: the finest level, D = 40; the
    # PC extraction's unconditional inversion at batch 1); at 512 px SD runs
    # TANGO's two shapes above
    ((2, 1024, 8, 8, 40), torch.float32),
    ((2, 1024, 8, 8, 40), torch.bfloat16),
    ((1, 1024, 8, 8, 40), torch.float32),
    # SD v1.4 at 1024 px (phase 10): levels 0 (S = 16384, D = 40), 1 (4096,
    # 80) and 2 (1024, 160: f32 in 32-key tiles, bf16 padded to DP 192)
    ((2, 16384, 8, 8, 40), torch.float32),
    ((2, 16384, 8, 8, 40), torch.bfloat16),
    ((2, 4096, 8, 8, 80), torch.float32),
    ((2, 4096, 8, 8, 80), torch.bfloat16),
    ((2, 1024, 8, 8, 160), torch.float32),
    ((2, 1024, 8, 8, 160), torch.bfloat16),
    # every kind of head dim the JAX kernel takes, which no model sends yet
    # off a multiple of 8 (20, 100: f32 zero-fills in the kernel,
    # bf16 pads a copy), 136-160 (f32 160, bf16 DP 192), 168 (f32 192 in
    # two 96-column blocks, bf16 DP 192) and 200-256 (f32 256 and bf16 DP
    # 256, each in two 128-column blocks)
    *[((2, 1024, 8, 8, D), dtype) for D in (20, 100, 136, 152, 168, 200, 256)
      for dtype in (torch.float32, torch.bfloat16)],
]
# ((B, Sq, H, H_kv, D), dtype, keys, kv_len): a ragged GQA call at D = 200
# with its last keys masked, and an sp query block at D = 256 (264 rows of
# the 1056 padded keys of sp 4, kv_len 1025)
ATTN_KV_LEN_CASES = [((1, 777, 4, 2, 200), dtype, 777, 700) for dtype in
                     (torch.float32, torch.bfloat16)] + [
                    ((2, 264, 8, 8, 256), dtype, 1056, 1025) for dtype in
                     (torch.float32, torch.bfloat16)]
# float32 attention (B1, B2) is held to flash_attention.F32_TOL, 1e-5 +
# 1e-5 |ref|, which a single TF32 product fails; bf16 to
# flash_attention.BF16_TOL: two bf16 ulps, 4e-3 near zero, which a kernel
# that dropped its kv_len mask fails
# ((B, S, H, H_kv, D), rot, dtype, strided heads): the Stable Audio DiT's
# attn1 with the rotary inside the kernel (B2) first, then a ragged
# sequence at the widest head dim, and the DiT shape with q, k and v as
# transposes of (B, H, S, D)
ROTARY_CASES = [((2, 1025, 24, 12, 64), 32, torch.float32, False),
                ((2, 1025, 24, 12, 64), 32, torch.bfloat16, False),
                ((1, 777, 4, 2, 128), 64, torch.float32, False),
                ((1, 777, 4, 2, 128), 64, torch.bfloat16, False),
                ((2, 1025, 24, 12, 64), 32, torch.bfloat16, True),
                # B2 at the widest head dim
                ((2, 1025, 8, 8, 256), 64, torch.float32, False),
                ((2, 1025, 8, 8, 256), 64, torch.bfloat16, False)]
# (M, E, N) of the DiT feed-forward (B3): the CFG batch of 2 x 1025 tokens,
# and 1025 rows (an empty source prompt runs the unconditional stream
# alone); in each dtype also a ragged case (M and E not multiples of the
# kernels' 128-row tile and their 32- or 64-feature stage, N not of 128: in
# bfloat16 the 128-column half tile crosses N); last, the PC paths' batch
# of 4 x 1025 tokens
SWIGLU_CASES = [((2050, 1536, 6144), torch.float32), ((1025, 1536, 6144), torch.float32),
                ((77, 80, 192), torch.float32),
                ((2050, 1536, 6144), torch.bfloat16), ((1025, 1536, 6144), torch.bfloat16),
                ((77, 80, 192), torch.bfloat16),
                ((4100, 1536, 6144), torch.float32), ((4100, 1536, 6144), torch.bfloat16)]
# float32 B3 is held to swiglu.F32_TOL, bf16 B3 to swiglu.BF16_TOL (the
# bounds and what fails them: ops/swiglu.py)


# phase 2c: the PC extraction's finite-difference probe ab = x0(xt + c v) -
# x0(xt) at the CLI's c and two PCs, each variant against the same probe in
# float64 on the card (float64 weights and activations; attention and SwiGLU
# in float64 too; on the CPU it took 55 of the phase's 85 s): on the card
# through the kernels; on the card with each
# kernel call replaced by its plain version (the CPU's code path, run on
# the card); on the CPU in float32. The difference divides float32 roundoff
# of x0 by c, so float32 probes lie about a percent from the float64 one,
# and how far depends on the summation orders of every op, not only the
# kernels'. Bound: the probe through the kernels lies at most PROBE_RATIO
# times as far from the float64 probe as the same probe on the card
# through the plain versions (relative Frobenius error): the kernels keep
# the probe at float32 accuracy. One PC (a batch-2 forward; two ran in
# PRs 9-12, the cut that made room for phases 10 and 11: the CPU's float32
# and float64 UNet probes took 90 of the phase's 104 s at two PCs).
PROBE_CONST, PROBE_N_EV, PROBE_CFG = 1e-3, 1, 3.0
PROBE_RATIO = 1.25
# The card's probe against the CPU's float32 one (relative Frobenius
# error), by model: 1.5x what the first runs on an H100 read (UNet 0.0144,
# DiT 0.0517, the same in three runs from the same seeds). The gap is the
# card's other float32 ops (cuDNN's convolutions, cuBLAS) summing in other
# orders than the CPU's; half again leaves room for another library's
# orders, and a probe past it has changed by more than an order of sums.
PROBE_CARD_CPU_MAX = {"unet": 0.0215, "dit": 0.0775}
# phases 5 and 6: each model's PC extraction (steps, --drift_start,
# --drift_end: the window) and its applications
PC_N_EVS, PC_ITERS = 2, 50
# (Stable Audio at 50 steps and one window step, 25: the cut that made
# room for phases 10 and 11; in PRs 9-12, 100 steps and two window steps)
# (AudioLDM-s at one window step, 100: the cut that made room for phase
# 10's JPEG 2000 SDEdit; two window steps, 100 and 99, before)
PCS = {MODEL_ID: (STEPS, 100, 99), SA_MODEL_ID: (SA_STEPS // 2, 25, 24)}
# (name, flags): the same on both models, in this order
PC_APPLICATIONS = [
    ("apply_bf16_amount0", ["--evs", "1", "2", "--amount", "0", "--dtype", "bfloat16"]),
    ("apply_bf16", ["--evs", "1", "2", "--amount", "2", "--dtype", "bfloat16"]),
    ("apply_amount0", ["--evs", "1", "--amount", "0"]),
]
# The float32 amount-0 application against the extraction's drift-free wav,
# bound fixed before the first run: 33 LSB of the int16 wav (1e-3 of full
# scale). Amount 0 redoes the window steps from their own x0 prediction,
# which changes the latent by float32 roundoff only (~1e-7 relative; the
# CPU test measures <= 1e-5 after the tiny model's remaining steps); every
# other step runs the same kernels on the same inputs. Only an application
# that leaves the extraction's trajectory (other weights, conditioning,
# noise maps or steps) reaches 1e-3 of full scale. The drift is held to the
# same bound the other way: each bf16 amount-2 wav must differ by more than
# it from the bf16 amount-0 wav of its PC (the same batch and kernels, so a
# drift that moves nothing gives the same wav), and from the other PC's.
AMOUNT0_MAX_LSB = 33
# phase 9: the generation, long-form, batch and sweep CLIs at full width.
# Depths (cut to keep the script's time): AudioLDM-s generation at 25 steps
# (the CLI's default is 200), Stable Audio's at 50, the edits at 50
# inversion + 25 edit steps on both models (a quarter and a half of their
# edit configs).
GEN_STEPS = 25
P9_STEPS, P9_TSTART = 50, 25
P9_SA_STEPS = 50
# a 25 s clip in 10 s windows overlapping by 1 s: 3 mel windows of 1024
# frames (starts 0, 920, 1536), a UNet forward of 6 rows; a 15 s stereo clip
# in 10 s windows: 2 Stable Audio windows, a DiT forward of 4 rows (B3 at
# M = 4 x 1025 = 4100)
LONG_SECONDS, SA_LONG_SECONDS, CHUNK_S, OVERLAP_S = 25.0, 15.0, 10.0, 1.0
LONG_WINDOWS = {"mel": 3, "stable_audio": 2}
GEN_SECONDS = 10.0  # the generation CLI's --duration
INPAINT_WINDOW = ["3", "6"]  # seconds of the clip that inpainting regenerates
BATCH_SECONDS = (10.0, 7.5, 5.0)  # run_batch's three clips of different lengths
SWEEP_TSTARTS, SWEEP_CFGS = (25, 12), (12.0, 6.0)  # a 2 x 2 grid off 50 steps
# the fold check: window 0 of the folded float32 long-form edit against its
# single-window edit with window 0's noise (max relative error); the same
# ops on 6 rows or on 2, which cuDNN and cuBLAS may sum in other orders
FOLD_MAX_REL = 1e-3
# a sweep grid point against cli/run.py at its tstart and cfg_tar (the same
# weights, draws and kernels), both with cuDNN's deterministic algorithms:
# int16 LSB (with cuDNN's default algorithms they lie 1 LSB apart)
SWEEP_MAX_LSB = 0
# phase 10: the image CLIs. Stable Diffusion v1.4 from a seeded full-width
# checkpoint (UNet, VAE and the CLIP text tower at CLIP ViT-L/14's text
# config, SD v1.4's text_encoder/config.json, with a small CLIP-shaped
# tokenizer written here); the CelebA-HQ LDM with seeded weights
SD_MODEL_ID = "CompVis/stable-diffusion-v1-4"
CELEBA_MODEL_ID = "CompVis/ldm-celebahq-256"
CLIP_TEXT = {"model_type": "clip_text_model", "vocab_size": 49408, "hidden_size": 768,
             "intermediate_size": 3072, "num_hidden_layers": 12, "num_attention_heads": 12,
             "max_position_embeddings": 77, "hidden_act": "quick_gelu",
             "layer_norm_eps": 1e-5, "bos_token_id": 49406, "eos_token_id": 49407}
# the image SDEdit CLI's defaults: 100 steps, tstart 50 (50 forwards); SD at
# its default 512 px, CelebA-HQ at its 256
IMG_STEPS, IMG_TSTART = 100, 50
# B1 launches per SD UNet forward: attn1 of the five transformers of each
# level with S >= 1024 (attn2 is cross-attention to the 77 text tokens and
# takes the plain path). 512 px: a 64 x 64 latent, levels 0 (S = 4096, D =
# 40) and 1 (1024, D = 80); 256 px: level 0 only (1024, D = 40); 1024 px:
# levels 0 (16384, 40), 1 (4096, 80) and 2 (1024, 160). The CelebA-HQ UNet
# has no attention.
SD_CALLS_PER_FORWARD = {512: 10, 256: 5, 1024: 15}
# phase 10's SDEdit at 1024 px: 100 steps, tstart 4 (4 forwards; each
# launches B1 five times at head dim 160)
SD_1024_TSTART = 4
SD_1024_D160_PER_FORWARD = 5
# phase 10c: PC extraction on SD at 256 px (the CLI's default -r), float32,
# one PC, PC_ITERS iterations at the two window steps 50 and 49
IMG_PC = (IMG_STEPS, 50, 48)
# the float32 amount-0 image against the extraction's drift-free image, in
# uint8 steps (bound fixed before the first run: amount 0 changes the latent
# by float32 roundoff, phases 5 and 6)
IMG_AMOUNT0_MAX = 1
# VQ codes card vs CPU: equal wherever the two nearest codes are not
# within this relative distance of each other (a tie float32 may break
# either way)
VQ_TIE_REL = 1e-5
VQ_DECODE_TOL = 1e-4  # decode(force_not_quantize=True), card vs CPU, max rel err
IMG_PROMPTS = ["a photo of a cat", ""]
# phase 11: the edit server at the JAX server's defaults (50 steps,
# bfloat16), on AudioLDM-s with phase 3's clip and on Stable Audio with a
# 5 s and phase 4's 10 s clip
SERVE_STEPS = 50
SERVE_EDITS = [  # (name, request fields beside the clip and prompts)
    ("default", {}), ("cfg_tar_6", {"cfg_tar": 6.0}), ("tstart_40", {"tstart": 40})]
# phase 12: the parallel paths on one card. Under --sp the DiT's 1025 tokens
# are padded to a multiple of 8 sp (1032 at sp = 1, 1040 at 2, 1056 at 4)
# and split in row blocks; B1 takes each block's query rows against the
# padded K/V with kv_len 1025. Under --tp the SwiGLU weight (2N, E) is split
# in matching value and gate row blocks: B3 runs on (2N/tp, E). Each shard
# is held to the unsharded kernel's output (bit-equal expected) and to the
# plain version within its tolerance.
SP_WAYS = (1, 2, 4)
TP_WAYS = (2, 4)
DIT_TOKENS = 1025
# the --sp 1 rehearsal's selfcheck against the same float32 selfcheck
# without --sp
SP1_SNR_MAX_DB = 1.0
# the --sp 1 float32 edit against the same edit without --sp: max relative
# error of the edited latent (bound fixed before the first run). B1 and B3
# give the unpadded rows bit for bit (phase 12a); the DiT's other matmuls
# run at 2 x 1032 rows instead of 2 x 1025, which cuBLAS may sum in other
# orders: the fold check's bound (FOLD_MAX_REL, the same ops on other row
# counts). A route that drops kv_len, misplaces the rotary rows or gathers
# in the wrong order moves the latent by O(1). The wavs are reported, not
# compared: the seeded Oobleck decoder lifts float32 differences of the
# latent to full scale (as the tiny one does, tests/test_torch_helpers.py).
SP1_LATENT_MAX_REL = 1e-3
# the seeded weights and checkpoint reads of the CLI runs, kept for reuse
# (bytes of host memory)
SETUP_CACHE_BYTES = 24e9


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _times(kernel, plain, library, reps: int) -> dict:
    """The kernel's and the library call's times by CUDA events around reps
    back-to-back calls (``ms``, which is the host's time where the host is
    slower to issue a call than the device to run it) and on the device
    alone (``device_ms``, torch.profiler); the plain version's by CUDA
    events. A case is host-bound where ms > HOST_BOUND x device_ms."""
    from audioeditingcode_tpu_torch.utils.timing import cuda_ms, device_ms

    t = {"ms": cuda_ms(kernel, reps), "device_ms": device_ms(kernel, reps),
         "plain_ms": cuda_ms(plain, reps=5, warmup=1),
         "library_ms": cuda_ms(library, reps), "library_device_ms": device_ms(library, reps)}
    return t | {"host_bound": t["ms"] > HOST_BOUND * t["device_ms"]}


def _bound(t_bytes, t_products, t_exps):
    """(ms, bound_by, the term that set it) of the largest of three times."""
    terms = {"bytes": t_bytes, "products": t_products, "exponentials": t_exps}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def attention_bound_ms(B, S, H, Hkv, D, dtype, rot=0, Sq=None):
    """Least time for the function of Sq (default S) query rows over S
    keys: the largest of its bytes (q, k, v read once, o written once, and
    with a rotary of width ``rot`` its two (S, rot) float32 tables) over HBM
    bandwidth, its two matmuls at the type's tensor-core peak (float32:
    three TF32 products each) and its exponentials at the SFU rate."""
    Sq = S if Sq is None else Sq
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * Sq * H * D + 2 * B * S * Hkv * D) * itemsize + 2 * S * rot * 4
    rate = TF32X3_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    return _bound(nbytes / HBM_BYTES_PER_S, 4.0 * B * H * Sq * S * D / rate,
                  1.0 * B * H * Sq * S / EXP_PER_S)


def swiglu_bound_ms(M, E, N, dtype):
    """Least time for the fused SwiGLU: the larger of its bytes (x, the
    (2N, E) weight and the f32 bias read once, the (M, N) output written
    once) over HBM bandwidth and its operations (4 M E N at the bf16
    tensor-core peak, or in float32 as three TF32 products; the M N
    exponentials at the SFU rate)."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = (M * E + 2 * N * E + M * N) * itemsize + 2 * N * 4
    rate = TF32X3_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    return _bound(nbytes / HBM_BYTES_PER_S, 4.0 * M * E * N / rate, 1.0 * M * N / EXP_PER_S)


def _over_allowed(got: torch.Tensor, ref: torch.Tensor, tol: dict) -> float:
    """The largest error of got over what tol allows it against ref (atol +
    rtol |ref|): at most 1 where the check passes."""
    ref = ref.double()
    return ((got.double() - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())).max().item()


def _check(out: torch.Tensor, ref: torch.Tensor, tol: dict):
    """The max abs error and _over_allowed; raises if the case fails."""
    errors = ((out.float() - ref.float()).abs().max().item(), _over_allowed(out, ref, tol))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    return errors


def _record_case(kernel, shape, dtype, errors, tol, times, library, bound):
    err, over = errors
    case = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "err_over_allowed": over, "tol": tol, **times, "library": library,
            "bound_ms": bound[0], "bound_by": bound[1], "bound_term": bound[2]}
    log(f"[phase1] {kernel} {case['shape']} {case['dtype']}: max_abs_err {err:.3g} "
        f"({over:.3g} of the allowed {tol['atol']} + {tol['rtol']:.4g} |ref|), "
        f"kernel {times['ms']:.4f} ms (device {times['device_ms']:.4f}"
        f"{', host-bound' if times['host_bound'] else ''}), plain {times['plain_ms']:.4f} ms, "
        f"library {times['library_ms']:.4f} ms (device {times['library_device_ms']:.4f}; "
        f"{library}), bound {bound[0]:.4f} ms ({bound[2]})")
    return case


def _launch_on_route(wrapper, call):
    """call() once; returns its result and the route whose count it raised."""
    before = dict(wrapper.launches_by_route)
    out = call()
    torch.cuda.synchronize()
    routes = [r for r, n in wrapper.launches_by_route.items() if n != before[r]]
    if len(routes) != 1:
        raise AssertionError(f"one launch raised the route counts {routes}")
    return out, routes[0]


def phase1_rotary(fa):
    """B2 against its plain version (host rotary, then B1's plain version),
    timed beside two yardsticks: host rotary + SDPA, and host rotary + B1,
    the default dispatcher's path (AEC_ROTARY_IN_KERNEL unset)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from audioeditingcode_tpu_torch.models.dit1d import rotary_tables
    from audioeditingcode_tpu_torch.utils.timing import cuda_ms, device_ms

    cases = []
    g = torch.Generator(device="cuda").manual_seed(4)
    for (B, S, H, Hkv, D), rot, dtype, strided in ROTARY_CASES:
        q, k, v = (torch.randn(B, h, S, D, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   if strided else
                   torch.randn(B, S, h, D, device="cuda", generator=g).to(dtype)
                   for h in (H, Hkv, Hkv))
        cos, sin = rotary_tables(rot, S, device="cuda")
        out, route = _launch_on_route(fa.flash_attention_rotary_cuda,
                                      lambda: fa.flash_attention_rotary_cuda(q, k, v, cos, sin))
        if route != fa.attention_route(dtype, rotary=True):
            raise AssertionError(f"flash_attention_rotary {dtype} took the {route} route")
        ref = fa.rotary_attention_reference(q, k, v, cos, sin)
        tol = fa.BF16_TOL if dtype == torch.bfloat16 else fa.F32_TOL
        errors = _check(out, ref, tol)
        kr, vr = (x.repeat_interleave(H // Hkv, dim=2) for x in (k, v))
        vt = vr.transpose(1, 2)

        def library():
            return sdpa(fa._host_rotary(q, cos, sin).transpose(1, 2),
                        fa._host_rotary(kr, cos, sin).transpose(1, 2), vt)

        def dispatcher():
            return fa.flash_attention_cuda(fa._host_rotary(q, cos, sin),
                                           fa._host_rotary(k, cos, sin), v)

        kname = "flash_attention_rotary" + ("_tc" if route == fa.TENSOR_CORE else "")
        case = _record_case(
            kname, (B, S, H, D), dtype, errors, tol,
            _times(lambda: fa.flash_attention_rotary_cuda(q, k, v, cos, sin),
                   lambda: fa.rotary_attention_reference(q, k, v, cos, sin), library, reps=20),
            "host rotary of q and k + scaled_dot_product_attention (three PyTorch calls)",
            attention_bound_ms(B, S, H, Hkv, D, dtype, rot))
        case |= {"kv_heads": Hkv, "rot": rot, "strided_heads": strided, "route": route,
                 "host_rotary_b1_ms": cuda_ms(dispatcher, reps=20),
                 "host_rotary_b1_device_ms": device_ms(dispatcher, reps=20),
                 "bit_equal_to_host_rotary_b1": torch.equal(out, dispatcher())}
        log(f"[phase1] {kname} {case['shape']} {case['dtype']} rot {rot}"
            f"{' strided heads' if strided else ''}: host rotary + B1 (the default "
            f"dispatcher) {case['host_rotary_b1_ms']:.4f} ms (device "
            f"{case['host_rotary_b1_device_ms']:.4f}), bit-equal to it: "
            f"{case['bit_equal_to_host_rotary_b1']}")
        cases.append(case)
        del q, k, v, out, ref, kr, vr, vt
        torch.cuda.empty_cache()
    return cases


def phase1_swiglu(sw):
    """B3 against its plain version; in float32 both are also measured
    against the function in float64, which shows how much of the error
    against the plain version is the plain version's own, and the kernel
    must lie within F32_TOL's allowance of float64 too."""
    from torch.nn import functional as F

    cases = []
    g = torch.Generator(device="cuda").manual_seed(5)
    for (M, E, N), dtype in SWIGLU_CASES:
        x = torch.randn(M, E, device="cuda", generator=g).to(dtype)
        w = (torch.randn(2 * N, E, device="cuda", generator=g) / E ** 0.5).to(dtype)
        b = torch.randn(2 * N, device="cuda", generator=g) * 0.1
        out, route = _launch_on_route(sw.swiglu_cuda, lambda: sw.swiglu_cuda(x, w, b))
        if route != sw.swiglu_route(dtype):
            raise AssertionError(f"swiglu {dtype} took the {route} route")
        ref = sw.swiglu_reference(x, w, b)
        tol = sw.BF16_TOL if dtype == torch.bfloat16 else sw.F32_TOL
        errors = _check(out, ref, tol)
        bl = b.to(dtype)

        def library():
            h, gate = F.linear(x, w, bl).chunk(2, dim=-1)
            return h * F.silu(gate)

        case = _record_case(
            "swiglu", (M, E, N), dtype, errors, tol,
            _times(lambda: sw.swiglu_cuda(x, w, b), lambda: sw.swiglu_reference(x, w, b),
                   library, reps=10),
            "F.linear + chunk + silu * mul (three PyTorch calls)",
            swiglu_bound_ms(M, E, N, dtype)) | {"route": route}
        if dtype == torch.float32:
            h = x.double() @ w.double().t() + b.double()
            exact = h[:, :N] * F.silu(h[:, N:])
            case |= {"kernel_over_allowed_vs_f64": _over_allowed(out, exact, tol),
                     "plain_over_allowed_vs_f64": _over_allowed(ref, exact, tol)}
            log(f"[phase1] swiglu {case['shape']} float32 against float64: kernel "
                f"{case['kernel_over_allowed_vs_f64']:.3g}, plain version "
                f"{case['plain_over_allowed_vs_f64']:.3g} of the allowed")
            if not case["kernel_over_allowed_vs_f64"] <= 1:
                raise AssertionError(f"swiglu {case['shape']} float32: the kernel lies "
                                     f"{case['kernel_over_allowed_vs_f64']:.3g} of F32_TOL's "
                                     f"allowance from float64")
            del h, exact
        cases.append(case)
        del x, w, b, bl, out, ref
        torch.cuda.empty_cache()
    return cases


def phase1_attention(fa):
    """B1 at ATTN_CASES (square self-attention), then at ATTN_KV_LEN_CASES
    (Sq query rows over more keys, those at or past kv_len masked; the
    library yardstick runs on the kv_len real keys)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    cases = []
    g = torch.Generator(device="cuda").manual_seed(0)
    all_cases = ([(shape, dtype, shape[1], None) for shape, dtype in ATTN_CASES]
                 + ATTN_KV_LEN_CASES)
    for (B, S, H, Hkv, D), dtype, keys, kv_len in all_cases:
        q = torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
        k = torch.randn(B, keys, Hkv, D, device="cuda", generator=g).to(dtype)
        v = torch.randn(B, keys, Hkv, D, device="cuda", generator=g).to(dtype)
        pads = fa.flash_attention_cuda.pad_copies
        out, route = _launch_on_route(fa.flash_attention_cuda,
                                      lambda: fa.flash_attention_cuda(q, k, v, kv_len))
        if route != fa.attention_route(dtype):
            raise AssertionError(f"flash_attention {dtype} took the {route} route")
        ref = fa.attention_reference(q, k, v, kv_len)
        tol = fa.BF16_TOL if dtype == torch.bfloat16 else fa.F32_TOL
        errors = _check(out, ref, tol)
        # the library yardstick, one call; GQA's kv heads repeated beforehand
        n = keys if kv_len is None else kv_len
        kr, vr = (x[:, :n].repeat_interleave(H // Hkv, dim=2).transpose(1, 2) for x in (k, v))
        qt = q.transpose(1, 2)
        case = _record_case(
            "flash_attention", (B, S, H, D), dtype, errors, tol,
            _times(lambda: fa.flash_attention_cuda(q, k, v, kv_len),
                   lambda: fa.attention_reference(q, k, v, kv_len), lambda: sdpa(qt, kr, vr),
                   reps=20),
            "scaled_dot_product_attention (one PyTorch call)",
            attention_bound_ms(B, n, H, Hkv, D, dtype, Sq=S))
        case |= {"kv_heads": Hkv, "route": route,
                 # a bf16 head dim off a multiple of 8 runs on a zero-padded copy
                 "padded_copy": fa.flash_attention_cuda.pad_copies != pads}
        if kv_len is not None:
            case |= {"keys": keys, "kv_len": kv_len}
        cases.append(case)
        del q, k, v, out, ref, kr, vr, qt
        torch.cuda.empty_cache()
    return cases


def phase2_unet_parity(fa):
    """The full-width UNet, card vs CPU, in float32 and in bfloat16; returns
    the record and the CPU UNet (float32), which phase 2c reuses."""
    from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS
    from audioeditingcode_tpu_torch.models.registry import random_init_, to_model_dtype_
    from audioeditingcode_tpu_torch.models.text_encoders import NullTextEncoder
    from audioeditingcode_tpu_torch.models.unet2d import UNet2DConditionModel

    spec = MODEL_SPECS[MODEL_ID]
    unet = random_init_(UNet2DConditionModel(spec.unet), torch.Generator().manual_seed(1))
    unet.eval().requires_grad_(False)
    x = torch.randn((2,) + LATENT, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([501, 501])
    labels = NullTextEncoder(class_dim=512)(["", "a dog barking"]).class_labels
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_out = unet(x, t, class_labels=labels)
    cpu_s = time.perf_counter() - t0
    gpu_unet = copy.deepcopy(unet).cuda()
    before = fa.flash_attention_cuda.launches
    with torch.no_grad():
        gpu_out = gpu_unet(x.cuda(), t.cuda(), class_labels=labels.cuda()).cpu()
    launched = fa.flash_attention_cuda.launches - before
    rel = ((gpu_out - cpu_out).abs().max() / cpu_out.abs().max()).item()
    log(f"[phase2] AudioLDM-s UNet forward {list(x.shape)}: card vs CPU max rel err "
        f"{rel:.3g} (limit 1e-3, TF32 off), {launched} kernel launches, CPU {cpu_s:.1f} s")
    if not np.isfinite(rel) or rel > 1e-3:
        raise AssertionError(f"UNet card/CPU parity {rel} > 1e-3")
    if launched != ATTN_CALLS_PER_FORWARD:
        raise AssertionError(f"{launched} kernel launches in one UNet forward")
    del gpu_unet
    out = {"unet_rel_err": rel}
    # bfloat16 on the card through B1-tc, against the float32 CPU forward:
    # the card may lie at most BF16_FORWARD_RATIO times as far from it as the
    # same bf16 forward through the plain version on the card (as phase 2d)
    unet_bf16 = to_model_dtype_(copy.deepcopy(unet), "cuda", torch.bfloat16)
    args = (x.to(torch.bfloat16).cuda(), t.cuda())
    before = dict(fa.flash_attention_cuda.launches_by_route)
    with torch.no_grad():
        gpu_bf16 = unet_bf16(*args, class_labels=labels.cuda()).cpu()
    launched_tc = fa.flash_attention_cuda.launches_by_route[fa.TENSOR_CORE] - before[fa.TENSOR_CORE]
    t0 = time.perf_counter()
    with torch.no_grad(), _plain_ops():
        plain_bf16_err = _rel_fro(unet_bf16(*args, class_labels=labels.cuda()).cpu(), cpu_out)
    plain_bf16_s = time.perf_counter() - t0
    plain_launched = (fa.flash_attention_cuda.launches_by_route[fa.TENSOR_CORE]
                      - before[fa.TENSOR_CORE] - launched_tc)
    err = _rel_fro(gpu_bf16, cpu_out)
    limit = BF16_FORWARD_RATIO * plain_bf16_err
    log(f"[phase2] AudioLDM-s UNet bf16: card vs float32 CPU relative Frobenius error "
        f"{err:.4g}, the bf16 plain version on the card {plain_bf16_err:.4g} (limit "
        f"{BF16_FORWARD_RATIO} x that = {limit:.4g}; {plain_bf16_s:.1f} s), "
        f"{launched_tc} tensor-core launches")
    if not np.isfinite(err) or err > limit:
        raise AssertionError(f"UNet bf16 card error {err} > {limit}")
    if launched_tc != ATTN_CALLS_PER_FORWARD or plain_launched:
        raise AssertionError(f"{launched_tc} tensor-core launches in one bf16 UNet forward, "
                             f"{plain_launched} through the plain versions")
    out |= {"unet_bf16_rel_fro_err": err, "unet_bf16_plain_rel_fro_err": plain_bf16_err,
            "unet_bf16_plain_card_s": plain_bf16_s}
    return out, unet


def _probe(solver, pipe, xt, z, v, k, prompt, state=None):
    """The first power iteration's finite difference, ab = x0(xt + c v) -
    x0(xt), at step k for the rows of v (one per PC), on the device of xt
    and returned on the CPU: x0(xt) at batch 1, as the extraction's
    trajectory takes it, the shifted inputs at the PCs' batch."""
    from audioeditingcode_tpu_torch.editing.pc_drift import forward_directional
    from audioeditingcode_tpu_torch.models.text_encoders import repeat_cond

    n = v.shape[0]
    uncond, cond = pipe.encode_text([""], negative=True), pipe.encode_text([prompt])
    _, x0 = forward_directional(solver, pipe.make_eps_pair(uncond, cond), xt, k, z, PROBE_CFG,
                                state=state)
    pair = pipe.make_eps_pair(repeat_cond(uncond, n), repeat_cond(cond, n))
    xe, ze = xt.repeat_interleave(n, dim=0), z.repeat_interleave(n, dim=0)
    _, x0s = forward_directional(solver, pair, xe, k, ze, PROBE_CFG, eigvecs=PROBE_CONST * v,
                                 amount=1.0, state=state)
    return (x0s - x0).cpu()


def _attention_f64(q, k, v, bias=None, rotary=None, kv_len=None):
    """Attention wholly in float64, rotary included (the plain versions
    compute in float32), for phase 2c's float64 probes (no sp route:
    kv_len is None)."""
    if kv_len is not None:
        raise ValueError("phase 2c's probes run no sp route")
    def rotate(x, cos, sin):
        rot, half = cos.shape[-1], cos.shape[-1] // 2
        xr = x[..., :rot]
        rh = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
        out = xr * cos[:, None].double() + rh * sin[:, None].double()
        return torch.cat([out, x[..., rot:]], dim=-1)

    if rotary is not None:
        q, k = rotate(q, *rotary), rotate(k, *rotary)
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(rep, dim=2).transpose(1, 2) for t in (k, v))
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias.double()
    return torch.matmul(torch.softmax(logits, dim=-1), vt).transpose(1, 2)


def _swiglu_f64(x, weight, bias):
    h, gate = torch.nn.functional.linear(x, weight, bias).chunk(2, dim=-1)
    return h * torch.nn.functional.silu(gate)


@contextlib.contextmanager
def _swap_ops(attention_fn, swiglu_fn):
    """The UNet's and the DiT's attention, and the DiT's SwiGLU, through
    other functions."""
    from audioeditingcode_tpu_torch.models import attention, dit1d

    saved = attention.fused_attention, dit1d.fused_attention, dit1d.fused_swiglu
    attention.fused_attention = dit1d.fused_attention = attention_fn
    dit1d.fused_swiglu = swiglu_fn
    try:
        yield
    finally:
        attention.fused_attention, dit1d.fused_attention, dit1d.fused_swiglu = saved


def _plain_ops():
    """The dispatchers with each kernel call replaced by its plain version:
    on any device, the path a CPU tensor takes."""
    from audioeditingcode_tpu_torch.ops import flash_attention as fa
    from audioeditingcode_tpu_torch.ops import swiglu as sw

    def attention_fn(q, k, v, bias=None, rotary=None, kv_len=None):
        if kv_len is not None:
            raise ValueError("the plain-version swap takes no sp route")
        if not fa.kernel_eligible(q, k, bias):
            return fa.fused_attention(q, k, v, bias, rotary)
        if rotary is not None:
            q, k = fa._host_rotary(q, *rotary), fa._host_rotary(k, *rotary)
        return fa.attention_reference(q, k, v)

    def swiglu_fn(x, weight, bias):
        if not sw.kernel_eligible(x, weight):
            return sw.fused_swiglu(x, weight, bias)
        out = sw.swiglu_reference(x.reshape(-1, x.shape[-1]), weight, bias)
        return out.reshape(x.shape[:-1] + (weight.shape[0] // 2,))

    return _swap_ops(attention_fn, swiglu_fn)


def _probe_check(name, probes, launched, want_launches):
    """Every float32 probe against the float64 one; the card's through the
    kernels may lie at most PROBE_RATIO times as far from it as the card's
    through the plain versions, and at most PROBE_CARD_CPU_MAX[name] from
    the CPU's float32 probe. Also reports each PC's cosine, card against
    CPU."""
    ref = probes["float64"]
    err = {v: _rel_fro(p, ref) for v, p in probes.items() if v != "float64"}
    a, b = probes["card"].double().flatten(1), probes["cpu"].double().flatten(1)
    cos = ((a * b).sum(1) / a.norm(dim=1) / b.norm(dim=1)).tolist()
    card_cpu = _rel_fro(probes["card"], probes["cpu"])
    limit = PROBE_RATIO * err["card_plain"]
    log(f"[phase2c] {name} probe ab = x0(xt + {PROBE_CONST} v) - x0(xt), {PROBE_N_EV} PCs: "
        f"relative Frobenius error against float64: "
        f"{ {v: round(e, 6) for v, e in err.items()} } (card limit {PROBE_RATIO} x card_plain "
        f"= {limit:.4g}); card vs CPU {card_cpu:.4g} (limit {PROBE_CARD_CPU_MAX[name]}), "
        f"cosines {[round(c, 8) for c in cos]}; |ab| {ref.norm().item():.4g}; "
        f"launches through the kernels {launched['card']}")
    if not np.isfinite(err["card"]) or err["card"] > limit:
        raise AssertionError(f"{name} probe: card {err['card']} from float64, limit {limit}")
    if not card_cpu <= PROBE_CARD_CPU_MAX[name]:
        raise AssertionError(f"{name} probe: card {card_cpu} from the CPU's, "
                             f"limit {PROBE_CARD_CPU_MAX[name]}")
    if launched["card"] != want_launches or launched["card_plain"] != expected_launches({}, 0):
        raise AssertionError(f"{name} probe launches {launched}, expected {want_launches}")
    return {f"{name}_probe_err": err, f"{name}_probe_card_vs_cpu": card_cpu,
            f"{name}_probe_cos": cos}


def _unet_probe_inputs():
    """Phase 2c's UNet probe inputs (xt, z, v) and the generator, which then
    draws the DiT's."""
    g = torch.Generator().manual_seed(9)
    xt, z = torch.randn((1,) + LATENT, generator=g), torch.randn((1,) + LATENT, generator=g)
    return xt, z, torch.randn((PROBE_N_EV,) + LATENT, generator=g), g


def _unet_probe(dev, dtype, model, xt, z, v):
    """The probe on the AudioLDM-s UNet at step 100 of 200 (CFG pair)."""
    from audioeditingcode_tpu_torch.editing.solvers import DDIMSolver
    from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS
    from audioeditingcode_tpu_torch.models.pipeline import LatentAudioPipeline
    from audioeditingcode_tpu_torch.models.text_encoders import NullTextEncoder
    from audioeditingcode_tpu_torch.schedulers.ddim import make_schedule

    spec = MODEL_SPECS[MODEL_ID]
    pipe = LatentAudioPipeline(MODEL_ID, make_schedule(spec.scheduler, STEPS, device=dev),
                               model, None, None, NullTextEncoder(class_dim=512, device=dev),
                               spec.mel)
    return _probe(DDIMSolver(pipe.sched), pipe, *(t.to(dev, dtype) for t in (xt, z, v)),
                  k=STEPS // 2, prompt="a dog barking")


def _family_case(model_id: str, g: torch.Generator):
    """Phase 2d's seeded full-width UNet of ``model_id`` (float32, CPU) and
    its inputs: the next latent of ``g``, t = 501, the target prompt's
    weight-free conditioning. Built once, in ``CpuReferences``' thread."""
    from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS
    from audioeditingcode_tpu_torch.models.registry import (
        _make_text_encoder,
        random_init_,
        to_model_dtype_,
    )
    from audioeditingcode_tpu_torch.models.unet2d import UNet2DConditionModel

    spec = MODEL_SPECS[model_id]
    unet = to_model_dtype_(random_init_(UNet2DConditionModel(spec.unet),
                                        torch.Generator().manual_seed(1)), "cpu", torch.float32)
    x = torch.randn((1,) + LATENT, generator=g)
    return unet, x, torch.tensor([501]), _make_text_encoder(spec, "cpu")(["a dog barking"])


def _family_forward(model, dev, dtype, x, t, cond):
    args = [None if a is None else a.to(dev) for a in
            (cond.hidden_states, cond.class_labels, cond.attention_mask,
             cond.hidden_states_1, cond.attention_mask_1)]
    with torch.no_grad():
        return model(x.to(dev, dtype), t.to(dev), *args).cpu()


FAMILY_IDS = (A2_MODEL_ID, AL_MODEL_ID, TANGO_MODEL_ID)


class CpuReferences:
    """Phase 2c's float32 CPU UNet probe and phase 2d's float32 CPU family
    forwards (the ones that took most of those phases' time), computed in a
    background thread beside phase 8a, whose checkpoint writing and
    conversion time no main-path loop; the thread takes all cores but two.
    A family's result also holds the seeded UNet and the inputs it ran on,
    for phase 2d to move to the card. ``result`` waits for the thread and
    hands each result over once."""

    def __init__(self, unet):
        self.results, self.error, self.waited_s = {}, None, 0.0
        self.thread = threading.Thread(target=self._work, args=(copy.deepcopy(unet),),
                                       daemon=True)
        self.thread.start()

    def _work(self, unet):
        try:
            torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
            xt, z, v, _ = _unet_probe_inputs()
            t0 = time.perf_counter()
            with torch.no_grad():
                probe = _unet_probe("cpu", torch.float32, unet, xt, z, v)
            self.results["unet_probe"] = (probe, time.perf_counter() - t0)
            del unet
            g = torch.Generator().manual_seed(10)
            for model_id in FAMILY_IDS:
                model, x, t, cond = _family_case(model_id, g)
                t0 = time.perf_counter()
                cpu_out = _family_forward(model, "cpu", torch.float32, x, t, cond)
                self.results[model_id] = (model, x, t, cond, cpu_out, time.perf_counter() - t0)
        except Exception as e:  # re-raised by result() in the main thread
            self.error = e

    def result(self, key):
        t0 = time.perf_counter()
        self.thread.join()
        self.waited_s += time.perf_counter() - t0
        if self.error is not None:
            raise self.error
        return self.results.pop(key)


def phase2c_probe(fa, sw, unet, cpu_refs):
    """The finite-difference probe of PC extraction in float32, through the
    kernels on the card and in the other variants of PROBE_RATIO's comment,
    against the card in float64: on the full-width AudioLDM-s UNet at step 100
    of 200 through the pipeline's CFG pair, and on phase 2b's 2-layer
    full-width DiT at step 50 of 100 with a warm solver history. The UNet's
    CPU probe comes from ``cpu_refs``."""
    from audioeditingcode_tpu_torch.editing.solvers import CosineDPMSolver
    from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS
    from audioeditingcode_tpu_torch.models.dit1d import StableAudioDiT, rotary_tables
    from audioeditingcode_tpu_torch.models.pipeline1d import StableAudioPipeline
    from audioeditingcode_tpu_torch.models.registry import random_init_, to_model_dtype_
    from audioeditingcode_tpu_torch.models.text_encoders import NullTextEncoder
    from audioeditingcode_tpu_torch.schedulers.cosine_dpm import make_cosine_dpm_schedule

    n = PROBE_N_EV
    # the float64 reference runs on the card: float64 there is as far below
    # the float32 probes' errors as on the CPU, in a second, not a minute
    variants = (("cpu", "cpu", torch.float32, contextlib.nullcontext),
                ("card", "cuda", torch.float32, contextlib.nullcontext),
                ("card_plain", "cuda", torch.float32, _plain_ops),
                ("float64", "cuda", torch.float64,
                 lambda: _swap_ops(_attention_f64, _swiglu_f64)))

    def run(name, dev, dtype, ops, model, probe):
        if (tag, name) == ("unet", "cpu"):  # computed in cpu_refs' thread
            probes[name], out[f"{tag}_probe_{name}_s"] = cpu_refs.result("unet_probe")
            return expected_launches({}, 0)
        reset_launches(fa, sw)
        t0 = time.perf_counter()
        with torch.no_grad(), ops():
            probes[name] = probe(dev, dtype, copy.deepcopy(model).to(device=dev, dtype=dtype))
        out[f"{tag}_probe_{name}_s"] = time.perf_counter() - t0
        return read_launches(fa, sw)

    xt, z, v, g = _unet_probe_inputs()

    def unet_probe(dev, dtype, model):
        return _unet_probe(dev, dtype, model, xt, z, v)

    out, probes, tag = {}, {}, "unet"
    launched = {name: run(name, dev, dtype, ops, unet, unet_probe)
                for name, dev, dtype, ops in variants}
    out |= _probe_check("unet", probes, launched,
                        expected_launches({"flash_attention": ATTN_CALLS_PER_FORWARD}, 2))

    sa = MODEL_SPECS[SA_MODEL_ID]
    cfg = dataclasses.replace(sa.dit, num_layers=SA_PARITY_LAYERS)
    dit = to_model_dtype_(random_init_(StableAudioDiT(cfg), torch.Generator().manual_seed(6)),
                          "cpu", torch.float32)
    C, L = SA_LATENT
    k = SA_STEPS // 2
    sigma = float(make_cosine_dpm_schedule(sa.cosine_scheduler, SA_STEPS).sigmas_host[k])
    xt = torch.randn(1, C, L, generator=g) * sigma
    z, hist = torch.randn(1, C, L, generator=g), torch.randn(1, C, L, generator=g)
    v = torch.randn(n, C, L, generator=g)
    dur = torch.randn(1, 2, cfg.cross_attention_input_dim, generator=g)
    glob = torch.randn(1, 1, cfg.global_states_input_dim, generator=g)

    def dit_probe(dev, dtype, model):
        pipe = StableAudioPipeline(
            SA_MODEL_ID, CosineDPMSolver(make_cosine_dpm_schedule(sa.cosine_scheduler, SA_STEPS,
                                                                  device=dev)),
            model, None, None,
            NullTextEncoder(hidden_dim=sa.projection.conditioning_dim, seq_len=sa.text_seq_len,
                            device=dev), sample_size=L,
            _duration_embeds=dur.to(dev), _global_states=glob.to(dev),
            _rotary=rotary_tables(cfg.rotary_embed_dim, L + 1, device=dev))
        x, zz, vv, h = (t.to(dev, dtype) for t in (xt, z, v, hist))
        return _probe(pipe.sched, pipe, x, zz, vv, k, "a cello",
                      state=pipe.sched.init_state(x, h))

    probes, tag = {}, "dit"
    launched = {name: run(name, dev, dtype, ops, dit, dit_probe)
                for name, dev, dtype, ops in variants}
    out |= _probe_check("dit", probes, launched,
                        expected_launches({"flash_attention": 1, "swiglu": 1},
                                          2 * SA_PARITY_LAYERS))
    return out

def _wrappers(fa, sw) -> dict:
    """Each kernel wrapper and its float32 route, by the name of its float32
    kernel (the bfloat16 one's name adds _tc)."""
    return {"flash_attention": (fa.flash_attention_cuda, fa.TF32X3),
            "flash_attention_rotary": (fa.flash_attention_rotary_cuda, fa.TF32X3),
            "swiglu": (sw.swiglu_cuda, sw.TF32X3)}


def reset_launches(fa, sw) -> None:
    for wrapper, _ in _wrappers(fa, sw).values():
        wrapper.launches = 0
        wrapper.launches_by_route = dict.fromkeys(wrapper.launches_by_route, 0)


def read_launches(fa, sw) -> dict:
    """Launches per kernel: B1, B2 and B3, each on both routes (the
    tensor-core kernel's name ends in _tc)."""
    counts = {}
    for name, (wrapper, f32_route) in _wrappers(fa, sw).items():
        if wrapper.launches != sum(wrapper.launches_by_route.values()):
            raise AssertionError(f"{name} launches {wrapper.launches} != the sum of "
                                 f"{wrapper.launches_by_route}")
        counts[name] = wrapper.launches_by_route[f32_route]
        counts[name + "_tc"] = wrapper.launches_by_route[fa.TENSOR_CORE]
    return counts


def expected_launches(per_forward: dict, forwards: int) -> dict:
    """Every kernel's launches in a run of ``forwards`` forwards that
    launch the kernels of ``per_forward`` that many times each."""
    out = dict.fromkeys(["flash_attention", "flash_attention_tc", "flash_attention_rotary",
                         "flash_attention_rotary_tc", "swiglu", "swiglu_tc"], 0)
    out.update({k: n * forwards for k, n in per_forward.items()})
    return out


def _max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _rel_fro(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative Frobenius error of got against ref."""
    ref = ref.double()
    return ((got.double() - ref).norm() / ref.norm()).item()


def phase2b_stable_audio_parity(fa, sw):
    """A full-width DiT cut to SA_PARITY_LAYERS layers, card vs CPU, through
    B1 + B3 and (AEC_ROTARY_IN_KERNEL=1) through B2 + B3; and the full-width
    Oobleck encode and decode on 16 latent frames, card vs CPU."""
    from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS
    from audioeditingcode_tpu_torch.models.dit1d import StableAudioDiT, rotary_tables
    from audioeditingcode_tpu_torch.models.oobleck import AutoencoderOobleck
    from audioeditingcode_tpu_torch.models.registry import random_init_, to_model_dtype_

    spec = MODEL_SPECS[SA_MODEL_ID]
    cfg = dataclasses.replace(spec.dit, num_layers=SA_PARITY_LAYERS)
    dit = to_model_dtype_(random_init_(StableAudioDiT(cfg), torch.Generator().manual_seed(6)),
                          "cpu", torch.float32)
    g = torch.Generator().manual_seed(7)
    C, L = SA_LATENT
    x = torch.randn(2, L, C, generator=g)
    t = torch.tensor([0.8, 0.8])
    ctx = torch.randn(2, spec.text_seq_len + 2, cfg.cross_attention_input_dim, generator=g)
    ctx[0] = 0  # the unconditional stream is all zero
    glob = torch.randn(2, 1, cfg.global_states_input_dim, generator=g)
    rot = rotary_tables(cfg.rotary_embed_dim, L + 1)
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_out = dit(x, t, ctx, glob, rot)
    cpu_s = time.perf_counter() - t0
    # the same forward in bfloat16 on the CPU, through the kernels' plain
    # versions (B2's is host rotary + B1's, so it serves both bf16 passes)
    dit_bf16 = to_model_dtype_(copy.deepcopy(dit), "cpu", torch.bfloat16)
    t0 = time.perf_counter()
    with torch.no_grad():
        plain_bf16_err = _rel_fro(dit_bf16(x, t, ctx, glob, rot), cpu_out)
    plain_bf16_s = time.perf_counter() - t0
    dit = dit.cuda()
    args = [a.cuda() for a in (x, t, ctx, glob)] + [tuple(r.cuda() for r in rot)]
    out = {"dit_layers": SA_PARITY_LAYERS, "dit_cpu_s": cpu_s,
           "dit_bf16_plain_rel_fro_err": plain_bf16_err, "dit_bf16_plain_cpu_s": plain_bf16_s}
    for name, env in (("host_rotary", "0"), ("rotary_in_kernel", "1")):
        os.environ["AEC_ROTARY_IN_KERNEL"] = env
        reset_launches(fa, sw)
        with torch.no_grad():
            gpu_out = dit(*args).cpu()
        launched = read_launches(fa, sw)
        rel = _max_rel(gpu_out, cpu_out)
        log(f"[phase2b] Stable Audio DiT ({SA_PARITY_LAYERS} layers, batch 2, {L}+1 tokens, "
            f"{name}): card vs CPU max rel err {rel:.3g} (limit 1e-3, TF32 off), "
            f"launches {launched}, CPU {cpu_s:.1f} s")
        attn = "flash_attention_rotary" if env == "1" else "flash_attention"
        want = expected_launches({"swiglu": 1, attn: 1}, SA_PARITY_LAYERS)
        if not np.isfinite(rel) or rel > 1e-3:
            raise AssertionError(f"DiT card/CPU parity ({name}) {rel} > 1e-3")
        if launched != want:
            raise AssertionError(f"DiT ({name}) launches {launched}, expected {want}")
        out[f"dit_rel_err_{name}"] = rel
    # bfloat16 on the card, through B1-tc + B3-tc and B2-tc + B3-tc, against
    # the float32 CPU forward. The bound: the card's bf16 forward may lie at
    # most BF16_FORWARD_RATIO times as far from the float32 forward as the
    # same bf16 forward through the plain versions on the CPU (both round
    # every activation to bf16; the kernels' sums run in another order)
    dit_bf16 = to_model_dtype_(dit_bf16, "cuda", torch.bfloat16)
    for name, env in (("host_rotary", "0"), ("rotary_in_kernel", "1")):
        os.environ["AEC_ROTARY_IN_KERNEL"] = env
        reset_launches(fa, sw)
        with torch.no_grad():
            gpu_out = dit_bf16(*args).cpu()
        launched = read_launches(fa, sw)
        err = _rel_fro(gpu_out, cpu_out)
        limit = BF16_FORWARD_RATIO * plain_bf16_err
        log(f"[phase2b] Stable Audio DiT bf16 ({name}): card vs float32 CPU relative "
            f"Frobenius error {err:.4g}, the bf16 plain versions on the CPU {plain_bf16_err:.4g} "
            f"(limit {BF16_FORWARD_RATIO} x that = {limit:.4g}; CPU {plain_bf16_s:.1f} s), "
            f"launches {launched}")
        attn = ("flash_attention_rotary" if env == "1" else "flash_attention") + "_tc"
        want = expected_launches({"swiglu_tc": 1, attn: 1}, SA_PARITY_LAYERS)
        if not np.isfinite(err) or err > limit:
            raise AssertionError(f"DiT bf16 card ({name}) error {err} > {limit}")
        if launched != want:
            raise AssertionError(f"DiT bf16 ({name}) launches {launched}, expected {want}")
        out[f"dit_bf16_rel_fro_err_{name}"] = err
    os.environ.pop("AEC_ROTARY_IN_KERNEL")
    del dit, dit_bf16, args

    vae = to_model_dtype_(random_init_(AutoencoderOobleck(spec.oobleck),
                                       torch.Generator().manual_seed(8)), "cpu", torch.float32)
    frames = 16
    audio = 0.3 * torch.randn(1, 2, frames * spec.oobleck.hop_length, generator=g)
    z = torch.randn(1, spec.oobleck.decoder_input_channels, frames, generator=g)
    with torch.no_grad():
        cpu_mean, _ = vae.encode(audio)
        cpu_dec = vae.decode(z)
        vae = vae.cuda()
        gpu_mean, _ = vae.encode(audio.cuda())
        gpu_dec = vae.decode(z.cuda())
    out["oobleck_encode_rel_err"] = _max_rel(gpu_mean.cpu(), cpu_mean)
    out["oobleck_decode_rel_err"] = _max_rel(gpu_dec.cpu(), cpu_dec)
    log(f"[phase2b] Oobleck full width, {frames} latent frames: card vs CPU max rel err "
        f"encode {out['oobleck_encode_rel_err']:.3g}, decode "
        f"{out['oobleck_decode_rel_err']:.3g} (limit 1e-3, TF32 off)")
    if not max(out["oobleck_encode_rel_err"], out["oobleck_decode_rel_err"]) <= 1e-3:
        raise AssertionError(f"Oobleck card/CPU parity > 1e-3: {out}")
    return out


def phase2d_unet_families(fa, sw, cpu_refs):
    """One full-width UNet forward of each other mel family (AudioLDM2-music,
    AudioLDM-l, TANGO; seeded random weights, batch 1 on the (8, 256, 16)
    latent, the target prompt's weight-free conditioning): float32 on the
    card through B1 against the CPU through the plain version; bfloat16 on
    the card through B1-tc against the float32 CPU forward, within
    BF16_FORWARD_RATIO times the error of the same bf16 forward on the card
    through the plain versions (every other op the same, so the ratio is
    the kernel's alone). The seeded UNets, their inputs and their CPU
    forwards come from ``cpu_refs``."""
    from audioeditingcode_tpu_torch.models.registry import to_model_dtype_

    out = {}
    for model_id in FAMILY_IDS:
        tag = model_id.split("/")[1]
        calls = FAMILY_CALLS_PER_FORWARD[model_id]
        unet, x, t, cond, cpu_out, cpu_s = cpu_refs.result(model_id)

        def forward(model, dev, dtype, x=x, t=t, cond=cond):
            return _family_forward(model, dev, dtype, x, t, cond)

        unet = unet.cuda()
        reset_launches(fa, sw)
        gpu_out = forward(unet, "cuda", torch.float32)
        launched = read_launches(fa, sw)
        rel = _max_rel(gpu_out, cpu_out)
        unet = to_model_dtype_(unet, "cuda", torch.bfloat16)
        reset_launches(fa, sw)
        bf16_out = forward(unet, "cuda", torch.bfloat16)
        launched_tc = read_launches(fa, sw)
        with _plain_ops():
            plain_out = forward(unet, "cuda", torch.bfloat16)
        plain_launched = read_launches(fa, sw)
        err, plain_err = _rel_fro(bf16_out, cpu_out), _rel_fro(plain_out, cpu_out)
        limit = BF16_FORWARD_RATIO * plain_err
        log(f"[phase2d] {tag} UNet forward {[1, *LATENT]}: card vs CPU max rel err {rel:.3g} "
            f"(limit 1e-3, TF32 off), launches {launched}, CPU {cpu_s:.1f} s; bf16 card vs "
            f"float32 CPU relative Frobenius error {err:.4g}, the bf16 plain versions on the "
            f"card {plain_err:.4g} (limit {BF16_FORWARD_RATIO} x that = {limit:.4g}), "
            f"launches {launched_tc}")
        if not np.isfinite(rel) or rel > 1e-3:
            raise AssertionError(f"{tag} UNet card/CPU parity {rel} > 1e-3")
        if not np.isfinite(err) or err > limit:
            raise AssertionError(f"{tag} UNet bf16 card error {err} > {limit}")
        if (launched != expected_launches({"flash_attention": calls}, 1)
                or launched_tc != expected_launches({"flash_attention_tc": calls}, 1)
                or plain_launched != launched_tc):
            raise AssertionError(f"{tag} UNet launches {launched}, {launched_tc}, "
                                 f"{plain_launched}; expected {calls} per forward")
        out[tag] = {"rel_err": rel, "bf16_rel_fro_err": err, "bf16_plain_rel_fro_err": plain_err,
                    "cpu_s": cpu_s}
        del unet
        torch.cuda.empty_cache()
    return {"unet_families": out, "cpu_refs_waited_s": cpu_refs.waited_s}


def write_clip(path: str, seconds: float = 10.0, sr: int = 16000, channels: int = 1) -> None:
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds)) / sr
    wave = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.sin(2 * np.pi * 1250 * t)
    wave += 0.02 * np.random.default_rng(0).standard_normal(t.shape)
    if channels == 2:  # a second tone, louder in the right channel
        wave = np.stack([wave, wave + 0.2 * np.sin(2 * np.pi * 523 * t)], axis=1) / 1.2
    wavfile.write(path, sr, (wave * 32767).astype(np.int16))


def edit_argv(model_id: str, clip: str, results_path: str, depth=None) -> list:
    """The port CLI's arguments for the main-path edit of ``clip`` with
    ``model_id``; ``depth`` (steps, tstart) in place of the model's."""
    steps, tstart, target, _ = EDITS[model_id]
    steps, tstart = depth or (steps, tstart)
    return ["--model_id", model_id, "--init_aud", clip,
            "--source_prompt", "a sine tone", "--target_prompt", target,
            "--cfg_src", "3", "--cfg_tar", "12",
            "--num_diffusion_steps", str(steps), "--tstart", str(tstart),
            "--seed", "0", "--results_path", results_path]


# reuse_setup's hits and misses; a run whose set-up hit it gets
# "setup_cached": true, and its wall_s then holds no real weight building or
# checkpoint read
SETUP_STATS = {"hits": 0, "misses": 0}


@contextlib.contextmanager
def reuse_setup():
    """Reuse each CLI run's set-up: the seeded weights of a module (keyed by
    its parameters' names and shapes and the generator's state before the
    draws; a hit copies the weights and sets the generator to its state
    after them, so every run gets the weights and draws it would have made)
    and a checkpoint file's state dict (keyed by path, size and mtime; a
    hit clones it). Least recently used entries go beyond
    SETUP_CACHE_BYTES. Every check is unchanged: the modules are equal to
    the ones the runs would have built. This is a cache of this script's
    alone: the CLIs' own set-up is unchanged, so a run's set-up seconds are
    real only where it is not ``setup_cached``. A hit reads no file, so it
    drops the file's entry of ``flax_msgpack.LOAD_SECONDS``."""
    from collections import OrderedDict

    from audioeditingcode_tpu_torch.models import flax_msgpack, registry

    real_init, real_load = registry.random_init_, registry.load_params_
    cache, stats = OrderedDict(), SETUP_STATS
    stats.update(hits=0, misses=0)

    def put(key, value, nbytes):
        cache[key] = (value, nbytes)
        while sum(n for _, n in cache.values()) > SETUP_CACHE_BYTES and len(cache) > 1:
            cache.popitem(last=False)

    def get(key):
        if key in cache:
            cache.move_to_end(key)
            stats["hits"] += 1
            return cache[key][0]
        stats["misses"] += 1
        return None

    @torch.no_grad()
    def random_init(module, g):
        key = ("seeded", tuple((n, tuple(p.shape)) for n, p in module.named_parameters()),
               bytes(g.get_state().numpy()))
        hit = get(key)
        if hit is None:
            real_init(module, g)
            weights = {n: p.detach().clone() for n, p in module.named_parameters()}
            put(key, (weights, g.get_state()), sum(t.nbytes for t in weights.values()))
            return module
        weights, state = hit
        for n, p in module.named_parameters():
            p.copy_(weights[n])
        g.set_state(state)
        return module

    def load_params(module, path):
        st = os.stat(path)
        key = ("file", path, st.st_size, st.st_mtime_ns)
        hit = get(key)
        if hit is None:
            real_load(module, path)
            sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
            put(key, sd, sum(t.nbytes for t in sd.values()))
            return module
        module.load_state_dict({k: v.clone() for k, v in hit.items()}, assign=True)
        flax_msgpack.LOAD_SECONDS.pop(path, None)
        return module

    registry.random_init_, registry.load_params_ = random_init, load_params
    try:
        yield stats
    finally:
        registry.random_init_, registry.load_params_ = real_init, real_load


def phase3_main_path(fa, sw, tmp: str):
    from scipy.io import wavfile

    from audioeditingcode_tpu_torch.cli.run import main as run_edit

    clip = os.path.join(tmp, "clip.wav")
    write_clip(clip, **EDITS[MODEL_ID][3])
    runs = {}
    for name, extra in (("edit", []), ("selfcheck", ["--selfcheck"]),
                        ("edit_bf16", ["--dtype", "bfloat16"])):
        reset_launches(fa, sw)
        hits, t0 = SETUP_STATS["hits"], time.perf_counter()
        out = run_edit(edit_argv(MODEL_ID, clip, os.path.join(tmp, name)) + extra)
        wall = time.perf_counter() - t0
        counts = read_launches(fa, sw)
        with open(os.path.join(os.path.dirname(out), "run_args.json")) as f:
            rec = json.load(f)
        sr, wav = wavfile.read(out)
        forwards = rec["unet_steps"]
        attn = "flash_attention_tc" if name.endswith("bf16") else "flash_attention"
        want = expected_launches({attn: ATTN_CALLS_PER_FORWARD}, forwards)
        run = {"launches": counts, "unet_forwards": forwards, "dtype": rec["dtype"],
               "wall_s": wall, "edit_s": rec["edit_seconds"],
               "steps_per_s": forwards / rec["edit_seconds"],
               "wav_samples": int(wav.shape[-1]), "selfcheck_snr_db": rec["selfcheck_snr_db"],
               "setup_cached": SETUP_STATS["hits"] > hits}
        log(f"[phase3] {name}: {run}")
        if forwards != STEPS + TSTART or counts != want:
            raise AssertionError(f"{name}: launches {counts} for {forwards} UNet forwards, "
                                 f"expected {want}")
        if sr != 16000 or wav.shape[-1] < 10 * 16000 or not np.any(wav):
            raise AssertionError(f"{name}: bad output wav {out}: sr {sr}, shape {wav.shape}")
        runs[name] = run
    if not runs["selfcheck"]["selfcheck_snr_db"] >= 40.0:
        raise AssertionError(f"selfcheck SNR {runs['selfcheck']['selfcheck_snr_db']} < 40 dB")
    return runs


def phase4_stable_audio(fa, sw, tmp: str):
    """The Stable Audio Open edit through the CLI: in float32 a selfcheck and
    an edit with the rotary inside the attention kernel (B2); in bfloat16 a
    selfcheck with host rotary + B1 and one with B2. A selfcheck runs the
    edit's 150 forwards through the same kernels (its reverse pass takes the
    source conditioning), so its seconds are the edit's. An edit with the
    target prompt runs here in float32 (B2) and in bfloat16 in phase 9's
    long-form edit (host rotary + B1)."""
    from scipy.io import wavfile

    from audioeditingcode_tpu_torch.cli.run import main as run_edit

    clip = os.path.join(tmp, "clip44k.wav")
    write_clip(clip, **EDITS[SA_MODEL_ID][3])
    runs = {}
    bf16 = ["--dtype", "bfloat16"]
    for name, extra, env in (("selfcheck", ["--selfcheck"], "0"),
                             ("edit_rotary_in_kernel", [], "1"),
                             ("selfcheck_bf16", bf16 + ["--selfcheck"], "0"),
                             ("selfcheck_rotary_in_kernel_bf16", bf16 + ["--selfcheck"], "1")):
        os.environ["AEC_ROTARY_IN_KERNEL"] = env
        reset_launches(fa, sw)
        hits, t0 = SETUP_STATS["hits"], time.perf_counter()
        out = run_edit(edit_argv(SA_MODEL_ID, clip, os.path.join(tmp, "sa_" + name)) + extra)
        wall = time.perf_counter() - t0
        counts = read_launches(fa, sw)
        with open(os.path.join(os.path.dirname(out), "run_args.json")) as f:
            rec = json.load(f)
        sr, wav = wavfile.read(out)
        forwards = rec["unet_steps"]
        tc = "_tc" if name.endswith("bf16") else ""
        attn = ("flash_attention_rotary" if env == "1" else "flash_attention") + tc
        want = expected_launches({attn: SA_CALLS_PER_FORWARD,
                                  "swiglu" + tc: SA_CALLS_PER_FORWARD}, forwards)
        run = {"launches": counts, "dit_forwards": forwards, "dtype": rec["dtype"],
               "wall_s": wall, "edit_s": rec["edit_seconds"],
               "steps_per_s": forwards / rec["edit_seconds"], "wav_shape": list(wav.shape),
               "sr": sr, "selfcheck_snr_db": rec["selfcheck_snr_db"],
               "setup_cached": SETUP_STATS["hits"] > hits}
        log(f"[phase4] {name}: {run}")
        if forwards != SA_STEPS + SA_TSTART or counts != want:
            raise AssertionError(f"{name}: launches {counts} for {forwards} DiT forwards, "
                                 f"expected {want}")
        if sr != 44100 or wav.shape != (10 * 44100, 2) or not np.any(wav):
            raise AssertionError(f"{name}: bad output wav {out}: sr {sr}, shape {wav.shape}")
        runs[name] = run
    os.environ.pop("AEC_ROTARY_IN_KERNEL")
    for name in ("selfcheck", "selfcheck_bf16", "selfcheck_rotary_in_kernel_bf16"):
        if not runs[name]["selfcheck_snr_db"] >= 40.0:
            raise AssertionError(f"{name} SNR {runs[name]['selfcheck_snr_db']} < 40 dB")
    return runs


def _pc_run(fa, sw, name: str, call, per_forward: dict, forwards_expected: int):
    """One PC CLI run from launch counts of 0: returns (its output, the run's
    record). Every kernel must have launched per_forward times for each
    denoiser forward its run_args.json counts."""
    reset_launches(fa, sw)
    hits = SETUP_STATS["hits"]
    t0 = time.perf_counter()
    out = call()
    wall = time.perf_counter() - t0
    counts = read_launches(fa, sw)
    first = out if isinstance(out, str) else out[0]
    with open(os.path.join(os.path.dirname(first), "run_args.json")) as f:
        rec = json.load(f)
    forwards = sum(rec["stage_forwards"].values())
    want = expected_launches(per_forward, forwards)
    run = {"launches": counts, "forwards": forwards, "dtype": rec["dtype"], "wall_s": wall,
           "setup_cached": SETUP_STATS["hits"] > hits, "stage_seconds": rec["stage_seconds"],
           "stage_forwards": rec["stage_forwards"],
           "forwards_per_s": forwards / sum(rec["stage_seconds"].values())}
    if "power_iteration_seconds_per_window_step" in rec:
        run["power_iteration_s_per_window_step"] = rec["power_iteration_seconds_per_window_step"]
    log(f"[{name}] {run}")
    if forwards != forwards_expected or counts != want:
        raise AssertionError(f"{name}: launches {counts} for {forwards} denoiser forwards "
                             f"(expected {forwards_expected}), expected {want}")
    return out, run


def _check_wav(name: str, path: str, sr_want: int, channels: int):
    from scipy.io import wavfile

    sr, wav = wavfile.read(path)
    ok_shape = (wav.shape == (10 * sr_want, 2) if channels == 2
                else wav.ndim == 1 and wav.shape[0] >= 10 * sr_want)
    if sr != sr_want or not ok_shape or not np.any(wav):
        raise AssertionError(f"{name}: bad output wav {path}: sr {sr}, shape {wav.shape}")
    return wav.astype(np.int64)


def phase_pcs(fa, sw, tmp: str, model_id: str, clip: str, tag: str) -> dict:
    """Phases 5 and 6: PC extraction in float32 through the port's CLI, then
    each of PC_APPLICATIONS, each run held to its launches per
    forward and its outputs checked."""
    from audioeditingcode_tpu_torch.cli.pc_apply import main as pc_apply
    from audioeditingcode_tpu_torch.cli.pc_extract import main as pc_extract

    steps, start, end = PCS[model_id]
    sr, channels = EDITS[model_id][3]["sr"], EDITS[model_id][3]["channels"]
    if model_id == SA_MODEL_ID:
        per = {"f32": {"flash_attention": SA_CALLS_PER_FORWARD, "swiglu": SA_CALLS_PER_FORWARD},
               "bf16": {"flash_attention_tc": SA_CALLS_PER_FORWARD,
                        "swiglu_tc": SA_CALLS_PER_FORWARD}}
    else:
        per = {"f32": {"flash_attention": ATTN_CALLS_PER_FORWARD},
               "bf16": {"flash_attention_tc": ATTN_CALLS_PER_FORWARD}}
    argv = ["--model_id", model_id, "--init_aud", clip, "--num_diffusion_steps", str(steps),
            "--n_evs", str(PC_N_EVS), "--iters", str(PC_ITERS), "--drift_start", str(start),
            "--drift_end", str(end), "--seed", "0", "--wandb_disable",
            "--results_path", os.path.join(tmp, f"pc_{tag}")]
    window = start - end
    ckpt, runs = None, {}
    ckpt, runs["extract"] = _pc_run(fa, sw, f"{tag} extract", lambda: pc_extract(argv),
                                    per["f32"], 2 * steps + window * PC_ITERS)
    z = np.load(ckpt)
    vals, vecs = z["eig_vals"], z["eig_vecs"].reshape(window, PC_N_EVS, -1).astype(np.float64)
    norms = np.linalg.norm(vecs, axis=-1)
    dots = np.abs(np.einsum("wd,wd->w", vecs[:, 0], vecs[:, 1]))
    runs["extract"] |= {"eig_vals": vals.tolist(), "eigvec_norm_err": float(np.abs(norms - 1).max()),
                        "pc_dot_max": float(dots.max()), "eig_its": z["eig_its"].tolist()}
    log(f"[{tag}] eigenvalues {vals.tolist()}, |norm - 1| <= {runs['extract']['eigvec_norm_err']:.3g}"
        f", |PC1 . PC2| <= {runs['extract']['pc_dot_max']:.3g}")
    if vals.shape != (window, PC_N_EVS) or not (np.all(np.isfinite(vals)) and np.all(vals > 0)):
        raise AssertionError(f"{tag}: eigenvalues {vals}")
    if runs["extract"]["eigvec_norm_err"] > 1e-4 or runs["extract"]["pc_dot_max"] > 1e-3:
        raise AssertionError(f"{tag}: eigenvectors not orthonormal: {runs['extract']}")
    free = _check_wav(f"{tag} extract", ckpt[: -len(".npz")] + ".wav", sr, channels)
    base = ["--extraction_path", ckpt, "--drift_start", str(start), "--drift_end", str(end),
            "--seed", "0", "--wandb_disable"]
    wavs = {}
    for name, extra in PC_APPLICATIONS:
        dt = "bf16" if "bfloat16" in extra else "f32"
        outs, runs[name] = _pc_run(fa, sw, f"{tag} {name}", lambda: pc_apply(base + extra),
                                   per[dt], steps)
        wavs[name] = [_check_wav(f"{tag} {name}", o, sr, channels) for o in outs]
        diffs = [int(np.abs(w - free).max()) for w in wavs[name]]
        runs[name] |= {"outputs": len(outs), "max_lsb_from_drift_free": diffs}
        log(f"[{tag}] {name}: {len(outs)} wavs, max difference from the drift-free wav "
            f"{diffs} LSB")
    if max(runs["apply_amount0"]["max_lsb_from_drift_free"]) > AMOUNT0_MAX_LSB:
        raise AssertionError(f"{tag}: float32 amount 0 is {runs['apply_amount0']} "
                             f"(limit {AMOUNT0_MAX_LSB} LSB from the drift-free wav)")
    moved = [int(np.abs(w - w0).max())
             for w, w0 in zip(wavs["apply_bf16"], wavs["apply_bf16_amount0"])]
    apart = int(np.abs(wavs["apply_bf16"][0] - wavs["apply_bf16"][1]).max())
    runs["apply_bf16"] |= {"max_lsb_from_amount0": moved, "max_lsb_between_pcs": apart}
    log(f"[{tag}] bf16 amount 2: max difference from amount 0 of the same PC {moved} LSB, "
        f"between the PCs {apart} LSB (each must exceed {AMOUNT0_MAX_LSB})")
    if min(moved + [apart]) <= AMOUNT0_MAX_LSB:
        raise AssertionError(f"{tag}: the drift did not move the wav: {moved} LSB from amount "
                             f"0, {apart} LSB between the PCs")
    return runs


def _counted_run(fa, sw, name: str, call, per_forward: dict, forwards: int, seconds_key: str):
    """One CLI run from launch counts of 0: (its outputs, its run_args.json,
    its record), held to the denoiser forwards its run_args.json counts
    (unet_steps) and to per_forward launches of each kernel per forward."""
    reset_launches(fa, sw)
    hits = SETUP_STATS["hits"]
    t0 = time.perf_counter()
    out = call()
    wall = time.perf_counter() - t0
    counts = read_launches(fa, sw)
    first = out if isinstance(out, str) else out[0]
    with open(os.path.join(os.path.dirname(first), "run_args.json")) as f:
        rec = json.load(f)
    n = rec["unet_steps"]
    run = {"launches": counts, "forwards": n, "dtype": rec["dtype"], "wall_s": wall,
           "setup_cached": SETUP_STATS["hits"] > hits, "loop_s": rec[seconds_key],
           "steps_per_s": n / rec[seconds_key] if n else None}
    want = expected_launches(per_forward, n)
    if n != forwards or counts != want:
        raise AssertionError(f"{name}: launches {counts} for {n} denoiser forwards "
                             f"(expected {forwards}), expected {want}")
    return out, rec, run


def _cli_run(fa, sw, name: str, call, per_forward: dict, forwards: int, seconds_key: str,
             sr: int, channels: int, snr_min=None):
    """One edit-CLI run (``_counted_run``), its wav of the model's rate and
    at least 10 s differing from its orig.wav and, with snr_min, its
    selfcheck SNR."""
    out, rec, run = _counted_run(fa, sw, name, call, per_forward, forwards, seconds_key)
    run["selfcheck_snr_db"] = rec.get("selfcheck_snr_db")
    if rec.get("noise_seconds"):
        run["noise_s"] = rec["noise_seconds"]
    wav = _check_wav(name, out, sr, channels)
    orig = _check_wav(name + " orig", os.path.join(os.path.dirname(out), "orig.wav"), sr,
                      channels)
    n = min(len(wav), len(orig))
    run["max_lsb_from_orig"] = int(np.abs(wav[:n] - orig[:n]).max())
    log(f"[{name}] {run}")
    if run["max_lsb_from_orig"] == 0:
        raise AssertionError(f"{name}: the wav is orig.wav")
    if snr_min is not None and not run["selfcheck_snr_db"] >= snr_min:
        raise AssertionError(f"{name}: selfcheck SNR {run['selfcheck_snr_db']} < {snr_min} dB")
    return run


def _per_forward(model_id: str, bf16: bool) -> dict:
    """Each kernel's launches in one denoiser forward of model_id."""
    tc = "_tc" if bf16 else ""
    if model_id == SA_MODEL_ID:
        return {"flash_attention" + tc: SA_CALLS_PER_FORWARD, "swiglu" + tc: SA_CALLS_PER_FORWARD}
    return {"flash_attention" + tc: FAMILY_CALLS_PER_FORWARD.get(model_id,
                                                                 ATTN_CALLS_PER_FORWARD)}


def phase7_baselines(fa, sw, tmp: str) -> dict:
    """The baselines through the port's CLIs, at each model's edit config:
    AudioLDM-s --mode ddim (200 steps and the CLI's default tstart 100: a
    partial inversion of 100 steps, then 100 generation steps) in float32,
    bfloat16 and with --selfcheck (SNR reported, not gated: DDIM inversion
    is approximate); SDEdit on AudioLDM-s (200 steps, tstart 100) and on
    Stable Audio (100 steps, tstart 50, Brownian noise) in float32 and
    bfloat16."""
    from audioeditingcode_tpu_torch.cli.run import main as run_edit
    from audioeditingcode_tpu_torch.cli.sdedit import main as sdedit

    runs = {}
    bf16 = ["--dtype", "bfloat16"]
    clip = os.path.join(tmp, "clip.wav")
    for name, extra in (("ddim", []), ("ddim_bf16", bf16), ("ddim_selfcheck", ["--selfcheck"])):
        argv = edit_argv(MODEL_ID, clip, os.path.join(tmp, name)) + ["--mode", "ddim"] + extra
        runs[name] = _cli_run(fa, sw, f"phase7 {name}", lambda: run_edit(argv),
                              _per_forward(MODEL_ID, "bfloat16" in extra), 2 * TSTART,
                              "edit_seconds", 16000, 1)
    for model_id, tag, clip_name in ((MODEL_ID, "sdedit", "clip.wav"),
                                     (SA_MODEL_ID, "sdedit_stable_audio", "clip44k.wav")):
        steps, tstart, target, wav = EDITS[model_id]  # the edit's config
        for name, extra in ((tag, []), (tag + "_bf16", bf16)):
            argv = ["--model_id", model_id, "--init_aud", os.path.join(tmp, clip_name),
                    "--target_prompt", target, "--num_diffusion_steps", str(steps),
                    "--tstart", str(tstart), "--seed", "0", "--wandb_disable",
                    "--results_path", os.path.join(tmp, name)] + extra
            runs[name] = _cli_run(fa, sw, f"phase7 {name}", lambda: sdedit(argv),
                                  _per_forward(model_id, bool(extra)), tstart,
                                  "sdedit_seconds", wav["sr"], wav["channels"])
    return runs


# phase 8's checkpoint: FLAN-T5-large's public config; the CLAP model of
# phase 13 (CLAP_TEXT_FULL, CLAP_AUDIO) as its text encoder; GPT-2 and the
# projection model at the spec's defaults
T5_LARGE = {"model_type": "t5", "d_model": 1024, "d_kv": 64, "d_ff": 2816, "num_layers": 24,
            "num_heads": 16, "relative_attention_num_buckets": 32,
            "relative_attention_max_distance": 128, "feed_forward_proj": "gated-gelu",
            "vocab_size": 32128, "layer_norm_epsilon": 1e-6}
TEXT_CHAIN_TOL = 1e-3  # the text chain card vs CPU, max relative error in float32
CHECKPOINT_SEED = 11
_WORDS = ("a", "sine", "tone", "dog", "barking", "cello", "the", "of", "and", "music")


def _added(tokens) -> list:
    return [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True} for i, t in tokens]


def t5_tokenizer_json() -> dict:
    """A small FLAN-T5-shaped tokenizer (Unigram, Metaspace, ``$A </s>``)
    with ids inside T5's vocabulary."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = ([["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0], ["\u2581", -3.0]]
              + [["\u2581" + w, -2.0 - 0.01 * i] for i, w in enumerate(_WORDS + tuple(letters))]
              + [[c, -4.0 - 0.01 * i] for i, c in enumerate(letters)])
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": _added([(0, "<pad>"), (1, "</s>"), (2, "<unk>")]),
            "normalizer": {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "},
            "pre_tokenizer": {"type": "Metaspace", "replacement": "\u2581",
                              "prepend_scheme": "always", "split": True},
            "post_processor": {"type": "TemplateProcessing",
                               "single": [{"Sequence": {"id": "A", "type_id": 0}},
                                          {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                               "pair": [], "special_tokens": {"</s>": {
                                   "id": "</s>", "ids": [1], "tokens": ["</s>"]}}},
            "decoder": None,
            "model": {"type": "Unigram", "unk_id": 2, "vocab": pieces, "byte_fallback": False}}


def roberta_tokenizer_json() -> dict:
    """A small RoBERTa-shaped tokenizer (byte-level BPE with merges for a
    few words, ``<s> $A </s>``) with ids inside RoBERTa's vocabulary."""
    from audioeditingcode_tpu_torch.models.tokenizers import _BYTE_CHARS

    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>", "<mask>"])}
    for c in _BYTE_CHARS.values():
        vocab.setdefault(c, len(vocab))
    merges = []
    for w in _WORDS:
        tok = "\u0120" + w
        for i in range(2, len(tok) + 1):
            merges.append([tok[:i - 1], tok[i - 1]])
            vocab.setdefault(tok[:i], len(vocab))
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": _added([(0, "<s>"), (1, "<pad>"), (2, "</s>"), (3, "<unk>")]),
            "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                              "trim_offsets": True, "use_regex": True},
            "post_processor": {"type": "RobertaProcessing", "sep": ["</s>", 2],
                               "cls": ["<s>", 0], "trim_offsets": True,
                               "add_prefix_space": False},
            "decoder": None,
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": "", "end_of_word_suffix": "",
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}


def _manifest_shapes(model_id: str, part: str) -> dict:
    from audioeditingcode_tpu_torch.cli.validate_real_weights import read_manifest

    return read_manifest(os.path.join(REPO, "data", "key_manifests",
                                      model_id.replace("/", "__"), part + ".txt"))


def write_source_checkpoint(src: str):
    """A complete AudioLDM2-music checkpoint in the diffusers/transformers
    layout, from seeded random full-width modules, written by the port's
    safetensors writer (``hf_checkpoint.write_checkpoint``). Returns the
    state dict each weights_dir part must load to (on the CPU), the CLAP
    text projection, and each folder's bytes."""
    from audioeditingcode_tpu_torch.models import hf_checkpoint
    from audioeditingcode_tpu_torch.models import registry as treg
    from audioeditingcode_tpu_torch.models.audioldm2_cond import (
        AudioLDM2ProjectionModel,
        GPT2Model,
    )
    from audioeditingcode_tpu_torch.models.configs import (
        MODEL_SPECS,
        AudioLDM2ProjectionConfig,
        GPT2Config,
    )
    from audioeditingcode_tpu_torch.models.text_encoders import T5EncoderModel, t5_config

    spec = MODEL_SPECS[A2_MODEL_ID]
    pipe = treg.load_model(A2_MODEL_ID, 4, device="cpu", seed=CHECKPOINT_SEED)
    g = torch.Generator().manual_seed(CHECKPOINT_SEED + 1)
    mods = {"unet": pipe.unet, "vae": pipe.vae, "vocoder": pipe.vocoder,
            "gpt2": treg.seeded(lambda: GPT2Model(spec.gpt2 or GPT2Config()), g),
            "projection_lm": treg.seeded(lambda: AudioLDM2ProjectionModel(
                spec.projection_lm or AudioLDM2ProjectionConfig()), g),
            "t5": treg.seeded(lambda: T5EncoderModel(t5_config(T5_LARGE)), g)}
    want = {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for name, m in mods.items()}
    # the diffusers / transformers names of each part (models/convert.py)
    folders = {"unet": ("unet", dict(want["unet"])), "vae": ("vae", dict(want["vae"])),
               "vocoder": ("vocoder", {re.sub(r"^ups\.", "upsampler.", k): v
                                       for k, v in want["vocoder"].items()}),
               "gpt2": ("language_model", dict(want["gpt2"])),
               "projection_lm": ("projection_model", dict(want["projection_lm"]))}
    n_mel = spec.vocoder.model_in_dim
    folders["vocoder"][1].update(mean=torch.zeros(n_mel), scale=torch.ones(n_mel))
    vocab = _manifest_shapes(A2_MODEL_ID, "language_model")["wte.weight"]
    folders["gpt2"][1]["wte.weight"] = torch.randn(vocab, generator=g) * 0.02
    written = {}
    for name, (sub, sd) in folders.items():
        shapes = {k: tuple(v.shape) for k, v in sd.items()}
        if shapes != _manifest_shapes(A2_MODEL_ID, sub):
            raise AssertionError(f"phase8a: the {sub}/ keys are not the manifest's")
        diffusers = name in ("unet", "vae", "projection_lm")
        written[sub] = hf_checkpoint.write_checkpoint(
            os.path.join(src, sub), {"_class_name": type(mods[name]).__name__},
            sd, "diffusion_pytorch_model.safetensors" if diffusers else "model.safetensors")
    written["text_encoder_2"] = hf_checkpoint.write_checkpoint(
        os.path.join(src, "text_encoder_2"), T5_LARGE, want["t5"])
    t0 = time.perf_counter()
    clap = write_clap_checkpoint(os.path.join(src, "text_encoder"))
    written["text_encoder"] = os.path.getsize(os.path.join(src, "text_encoder",
                                                           "model.safetensors"))
    want["clap_text"] = {k[len("text_model."):]: v for k, v in clap.items()
                         if k.startswith("text_model.")
                         and not k.endswith(("position_ids", "token_type_ids"))}
    projection = {name: clap[f"text_projection.{key}"] for name, key in (
        ("w1", "linear1.weight"), ("b1", "linear1.bias"), ("w2", "linear2.weight"),
        ("b2", "linear2.bias"))}
    tok = roberta_tokenizer_json()
    d = os.path.join(src, "tokenizer")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(tok["model"]["vocab"], f, ensure_ascii=False)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in tok["model"]["merges"]))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "RobertaTokenizer", "model_max_length": 512}, f)
    d = os.path.join(src, "tokenizer_2")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(t5_tokenizer_json(), f)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "T5Tokenizer", "model_max_length": 512,
                   "pad_token": "<pad>"}, f)
    return want, projection, written


def _assert_bit_equal(name: str, got: dict, want: dict) -> None:
    if set(got) != set(want):
        raise AssertionError(f"{name}: loaded keys differ from the written module's")
    for k, v in want.items():
        if not torch.equal(got[k].cpu(), v):
            raise AssertionError(f"{name}: {k} was not loaded bit-equal")


def phase8a_checkpoint(tmp: str) -> dict:
    """Write the full-width AudioLDM2-music source checkpoint, convert it
    with the port's converter, load the weights_dir back on the card
    (state dicts bit-equal to the seeded modules; each file's bytes and
    load seconds), hold the tokenizer built from vocab.json + merges.txt
    to the tokenizer.json it came from, and the full-width text chain
    (T5-large, RoBERTa + CLAP projection, GPT-2 generating 8 tokens) card
    against CPU."""
    from audioeditingcode_tpu_torch.cli.convert_checkpoint import convert
    from audioeditingcode_tpu_torch.models import flax_msgpack
    from audioeditingcode_tpu_torch.models import registry as treg
    from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS
    from audioeditingcode_tpu_torch.models.text_encoders import (
        load_clap_projection,
        load_text_tower,
    )
    from audioeditingcode_tpu_torch.models.tokenizers import Tokenizer

    src = os.path.join(tmp, "audioldm2_music_src")
    ckpt = os.path.join(tmp, "audioldm2_music_ckpt")
    t0 = time.perf_counter()
    want, projection, written = write_source_checkpoint(src)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    conv = convert(A2_MODEL_ID, src, ckpt)
    convert_s = time.perf_counter() - t0
    read_bytes = sum(c["read_bytes"] for c in conv.values())
    written_bytes = sum(c["written_bytes"] for c in conv.values())
    log(f"[phase8a] wrote the source checkpoint in {write_s:.1f} s: {written}")
    log(f"[phase8a] converted it with the port's converter in {convert_s:.1f} s: read "
        f"{read_bytes} bytes, wrote {written_bytes} bytes; per part {conv}")
    prompts = ["a sine tone", "a dog barking in the rain, then music"]
    built = Tokenizer.from_dir(os.path.join(ckpt, "clap_text"))
    ref = Tokenizer(roberta_tokenizer_json(), {"model_max_length": 512, "pad_token": "<pad>"})
    for padding in ("max_length", True):
        (ids, mask), (rids, rmask) = built(prompts, padding=padding), ref(prompts,
                                                                          padding=padding)
        if not (np.array_equal(ids, rids) and np.array_equal(mask, rmask)):
            raise AssertionError("phase8a: the tokenizer built from vocab.json + merges.txt "
                                 "differs from its tokenizer.json")
    flax_msgpack.LOAD_SECONDS.clear()
    t0 = time.perf_counter()
    pipe = treg.load_model(A2_MODEL_ID, 4, device="cuda", weights_dir=ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    enc = pipe.text_encoder
    loaded = {"unet": pipe.unet, "vae": pipe.vae, "vocoder": pipe.vocoder, "gpt2": enc.gpt2,
              "projection_lm": enc.projection}
    for name, mod in loaded.items():
        _assert_bit_equal(name, mod.state_dict(), want[name])
    for name in ("t5", "clap_text"):
        _assert_bit_equal(name, load_text_tower(os.path.join(ckpt, name)).state_dict(),
                          want[name])
    _assert_bit_equal("text_projection", load_clap_projection(
        os.path.join(ckpt, "clap_text"), "cpu"), projection)
    files = {os.path.relpath(path, ckpt): {"bytes": b, "load_s": s}
             for path, (b, s) in flax_msgpack.LOAD_SECONDS.items()}
    log(f"[phase8a] load_model on the card in {load_s:.1f} s, every module bit-equal; "
        f"per file: {files}")
    cpu_enc = treg._try_audioldm2_chain(MODEL_SPECS[A2_MODEL_ID], ckpt, "cpu")
    errs = {}
    t0 = time.perf_counter()
    card = enc(prompts)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = cpu_enc(prompts)
    for f in ("hidden_states", "hidden_states_1"):
        errs[f] = _max_rel(getattr(card, f).cpu(), getattr(cpu, f))
    if not torch.equal(card.attention_mask_1.cpu(), cpu.attention_mask_1):
        raise AssertionError("phase8a: the T5 masks differ between card and CPU")
    log(f"[phase8a] text chain card vs CPU max rel err {errs} (bound {TEXT_CHAIN_TOL}); "
        f"{card_s:.2f} s on the card for {len(prompts)} prompts")
    if not max(errs.values()) <= TEXT_CHAIN_TOL:
        raise AssertionError(f"phase8a: text chain card vs CPU {errs} > {TEXT_CHAIN_TOL}")
    del pipe, enc, cpu_enc
    torch.cuda.empty_cache()
    return {"dir": ckpt, "src": src, "checkpoint_files": files, "checkpoint_load_s": load_s,
            "source_write_s": write_s, "source_bytes": written, "convert_s": convert_s,
            "convert_read_bytes": read_bytes, "convert_written_bytes": written_bytes,
            "convert_parts": conv, "text_chain_max_rel_err": errs,
            "text_chain_card_s": card_s}


def phase8_families(fa, sw, tmp: str, ckpt: str) -> dict:
    """--mode ours on the other mel families through the port's CLI, on
    phase 3's clip: AudioLDM2-music from phase 8a's checkpoint
    (``--weights_dir``, the full text chain) at 50 + 25 steps as a float32
    selfcheck and a bfloat16 edit (the selfcheck runs the edit's float32
    forwards through the same kernels, so there is no float32 edit run);
    AudioLDM-l and TANGO (v-prediction) as selfchecks at 20 + 10 steps in
    float32 and bfloat16. Every selfcheck must reach 40 dB."""
    from audioeditingcode_tpu_torch.cli.run import main as run_edit

    runs = {}
    clip = os.path.join(tmp, "clip.wav")
    plan = [(A2_MODEL_ID, "audioldm2", ("selfcheck", "edit_bf16")),
            (AL_MODEL_ID, "audioldm_l", ("selfcheck", "selfcheck_bf16")),
            (TANGO_MODEL_ID, "tango", ("selfcheck", "selfcheck_bf16"))]
    for model_id, tag, names in plan:
        steps, tstart = EDITS[model_id][:2]
        for name in names:
            selfcheck, bf16 = name.startswith("selfcheck"), name.endswith("bf16")
            argv = (edit_argv(model_id, clip, os.path.join(tmp, f"{tag}_{name}"))
                    + (["--weights_dir", ckpt] if model_id == A2_MODEL_ID else [])
                    + (["--selfcheck"] if selfcheck else [])
                    + (["--dtype", "bfloat16"] if bf16 else []))
            runs[f"{tag}_{name}"] = _cli_run(
                fa, sw, f"phase8 {tag} {name}", lambda: run_edit(argv),
                _per_forward(model_id, bf16), steps + tstart, "edit_seconds", 16000, 1,
                snr_min=40.0 if selfcheck else None)
    return runs


RUNBOOK_STEPS = "manifest,convert,selfcheck,edit,page"
# the runbook's CLI runs at 20 + 10 steps (cut from 50 + 25 to keep the
# script's time): run name -> (denoiser forwards, the run_args.json key of
# its loop seconds)
RUNBOOK_N, RUNBOOK_TSTART = 20, 10
RUNBOOK_RUNS = {"selfcheck": (RUNBOOK_N + RUNBOOK_TSTART, "edit_seconds"),
                "ours": (RUNBOOK_N + RUNBOOK_TSTART, "edit_seconds"),
                "ddim": (2 * RUNBOOK_TSTART, "edit_seconds"),
                "sdedit": (RUNBOOK_TSTART, "sdedit_seconds")}


def phase8b_runbook(fa, sw, tmp: str, src: str, model_id: str = A2_MODEL_ID,
                    device: str = "cuda"):
    """``aetorch-validate`` on phase 8a's AudioLDM2-music source tree, then
    the tree deleted. Each CLI run it makes is counted from 0 (B1 at 20
    launches per forward) and checked as phase 8's are (a wav differing
    from orig.wav; the selfcheck >= 40 dB). Returns (runs, checks).
    ``model_id`` and ``device`` let a tiny model rehearse it on the CPU."""
    from audioeditingcode_tpu_torch.cli import run as trun
    from audioeditingcode_tpu_torch.cli import sdedit as tsdedit
    from audioeditingcode_tpu_torch.cli import validate_real_weights as tv

    work = os.path.join(tmp, "runbook")
    runs = {}
    real = {"run": trun.main, "sdedit": tsdedit.main}

    def counted(kind):
        def call(argv):
            name = ("sdedit" if kind == "sdedit" else "selfcheck" if "--selfcheck" in argv
                    else argv[argv.index("--mode") + 1])
            forwards, seconds_key = RUNBOOK_RUNS[name]
            out = {}
            runs[name] = _cli_run(
                fa, sw, f"phase8b {name}", lambda: out.setdefault("wav", real[kind](argv)),
                _per_forward(model_id, False), forwards, seconds_key, 16000, 1,
                snr_min=40.0 if name == "selfcheck" else None)
            return out["wav"]
        return call

    argv = ["--model_id", model_id, "--src", src, "--work_dir", work,
            "--audio", os.path.join(tmp, "clip.wav"), "--steps", RUNBOOK_STEPS,
            "--methods", "ours,ddim,sdedit", "--num_diffusion_steps", str(RUNBOOK_N),
            "--tstart", str(RUNBOOK_TSTART), "--banner", "SYNTHETIC WEIGHTS",
            "--target_prompt", EDITS[A2_MODEL_ID][2], "--device", device]
    step_s, said = {}, {}  # each step's seconds, and its message or error

    def timed_step(name, fn):
        def step(ctx):
            t0 = time.perf_counter()
            try:
                said[name] = fn(ctx)
            except (Exception, SystemExit) as e:
                said[name] = f"FAIL: {e}"
                raise
            finally:
                step_s[name] = time.perf_counter() - t0
            return said[name]
        return step

    steps = RUNBOOK_STEPS.split(",")
    real_steps = {name: getattr(tv, f"step_{name}") for name in steps}
    trun.main, tsdedit.main = counted("run"), counted("sdedit")
    for name, fn in real_steps.items():
        setattr(tv, f"step_{name}", timed_step(name, fn))
    try:
        rc = tv.main(argv)
    finally:
        trun.main, tsdedit.main = real["run"], real["sdedit"]
        for name, fn in real_steps.items():
            setattr(tv, f"step_{name}", fn)
    # a step passes where it returns a message that is not a SKIP (tv.main)
    if rc != 0 or list(said) != steps or any(m.startswith(("SKIP", "FAIL"))
                                             for m in said.values()):
        raise AssertionError(f"phase8b: the runbook's steps did not all pass (rc {rc}): {said}")
    manifests = os.path.join(REPO, "data", "key_manifests", model_id.replace("/", "__"))
    tensors = sum(len(_manifest_shapes(model_id, f[:-4])) for f in os.listdir(manifests)
                  if f.endswith(".txt"))
    if said["manifest"] != f"{tensors} tensors match the vendored manifests":
        raise AssertionError(f"phase8b: the manifest step did not count {tensors}: "
                             f"{said['manifest']}")
    with open(os.path.join(work, "supp.html")) as f:
        page = f.read()
    audio = re.findall(r'<audio controls preload="none" src="([^"]+)"', page)
    lanes = [lane for lane in ("ours", "sdedit", "ddim") if f"<th>{lane}</th>" in page]
    if (lanes != ["ours", "sdedit", "ddim"] or "SYNTHETIC WEIGHTS" not in page
            or len(audio) < 4 or not all(os.path.isfile(os.path.join(work, a)) for a in audio)):
        raise AssertionError(f"phase8b: supp.html has lanes {lanes} and audio {audio}")
    checks = {"step_s": step_s, "manifest_tensors": tensors,
              "page_audio": len(audio), "page_bytes": len(page),
              "selfcheck_snr_db": runs["selfcheck"]["selfcheck_snr_db"]}
    log(f"[phase8b] runbook steps {checks['step_s']}; {tensors} manifest tensors; "
        f"selfcheck {checks['selfcheck_snr_db']} dB; supp.html {len(audio)} audio tags")
    shutil.rmtree(src)
    shutil.rmtree(work)
    return runs, checks


def _wav_samples(name: str, path: str, sr_want: int, shape=None, min_len=None):
    """The wav of a phase-9 run: its rate, its exact shape (or mono of at
    least min_len samples), not silent; as int64 samples."""
    from scipy.io import wavfile

    sr, wav = wavfile.read(path)
    ok = (tuple(wav.shape) == tuple(shape) if shape is not None
          else wav.ndim == 1 and wav.shape[0] >= min_len)
    if sr != sr_want or not ok or not np.any(wav):
        raise AssertionError(f"{name}: bad output wav {path}: sr {sr}, shape {wav.shape}")
    return wav.astype(np.int64)


def _vae_round_trip_wav(clip: str) -> np.ndarray:
    """The AudioLDM-s VAE round trip of ``clip``, vocoded and written as
    the generation CLI writes its wav (seed 0 weights, float32)."""
    from audioeditingcode_tpu_torch.models.registry import load_model
    from audioeditingcode_tpu_torch.utils.audio_io import load_audio

    pipe = load_model(MODEL_ID, GEN_STEPS, device="cuda", seed=0)
    x0, _, _ = load_audio(clip, pipe.mel_config, model_sr=pipe.get_sr(), device="cuda")
    audio = pipe.decode_latent_to_waveform(pipe.vae_encode(torch.as_tensor(x0, device="cuda")))
    audio = np.clip(audio[0].float().cpu().numpy(), -1.0, 1.0)
    return (audio * 32767.0).astype(np.int16).astype(np.int64)


def phase9_new_clis(fa, sw, tmp: str) -> dict:
    """The generation, long-form, batch and sweep CLIs through their
    main(argv) at full width with seeded weights: AudioLDM-s generation,
    style transfer (strength 0.5, and 0: the VAE round trip), inpainting
    and super-resolution in float32, generation and inpainting in
    bfloat16; Stable Audio generation and inpainting in bfloat16 (Brownian
    noise); long-form edits of a 25 s clip (3 AudioLDM-s windows, float32
    and bfloat16; the fold check) and of a 15 s stereo clip (2 Stable Audio
    windows, bfloat16); a batch of three AudioLDM-s clips (float32); a 2 x 2
    tstart x cfg_tar sweep on AudioLDM-s (float32), each grid point held to
    cli/run.py's edit, both with cuDNN's deterministic algorithms."""
    from audioeditingcode_tpu_torch.cli import run_long
    from audioeditingcode_tpu_torch.cli.generate import main as generate
    from audioeditingcode_tpu_torch.cli.run import main as run_edit
    from audioeditingcode_tpu_torch.cli.run_batch import main as run_batch
    from audioeditingcode_tpu_torch.cli.sweep import main as sweep

    runs, checks = {}, {}
    bf16 = ["--dtype", "bfloat16"]
    clip, clip44 = os.path.join(tmp, "clip.wav"), os.path.join(tmp, "clip44k.wav")
    mel_per, sa_per = (lambda b: _per_forward(MODEL_ID, b)), (lambda b: _per_forward(SA_MODEL_ID, b))

    def record(name, run, extra=""):
        runs[name] = run
        log(f"[phase9] {name}: {run}{extra}")

    # --- cli/generate.py
    gen_base = ["--model_id", MODEL_ID, "-t", "a dog barking", "--ddim_steps", str(GEN_STEPS),
                "-dur", str(GEN_SECONDS), "--seed", "0"]
    plan = [("generate", ["--mode", "generation"], GEN_STEPS),
            ("transfer", ["-f", clip, "--transfer_strength", "0.5"], GEN_STEPS // 2),
            ("inpaint", ["-f", clip, "--mode", "inpaint", "--inpaint_window", *INPAINT_WINDOW],
             GEN_STEPS),
            ("sr", ["-f", clip, "--mode", "sr"], GEN_STEPS),
            ("generate_bf16", ["--mode", "generation"] + bf16, GEN_STEPS),
            ("inpaint_bf16", ["-f", clip, "--mode", "inpaint", "--inpaint_window", *INPAINT_WINDOW]
             + bf16, GEN_STEPS),
            ("transfer_strength0", ["-f", clip, "--transfer_strength", "0"], 0)]
    for name, extra, forwards in plan:
        argv = gen_base + extra + ["--save_path", os.path.join(tmp, "gen_" + name)]
        outs, rec, run = _counted_run(fa, sw, f"phase9 {name}", lambda: generate(argv),
                                 mel_per("bfloat16" in extra), forwards, "generate_seconds")
        wav = _wav_samples(name, outs[0], 16000, min_len=10 * 16000)
        if "inpaint" in name or name == "sr":
            run["kept_region_bit_exact"] = rec["kept_region_bit_exact"]
            if rec["kept_region_bit_exact"] is not True:
                raise AssertionError(f"{name}: the kept region is not the source latent")
        if name == "transfer_strength0":
            want = _vae_round_trip_wav(clip)
            run["max_lsb_from_vae_round_trip"] = int(np.abs(wav - want).max()) \
                if wav.shape == want.shape else None
            if run["max_lsb_from_vae_round_trip"] is None or \
                    run["max_lsb_from_vae_round_trip"] > 1:
                raise AssertionError(f"{name}: not the VAE round trip of the input: {run}")
        record("generate_" + name if not name.startswith("generate") else name, run)
    sa_gen = ["--model_id", SA_MODEL_ID, "-t", "a cello", "--ddim_steps", str(P9_SA_STEPS),
              "-dur", str(GEN_SECONDS), "--seed", "0"] + bf16
    for name, extra in (("sa_generate_bf16", ["--mode", "generation"]),
                        ("sa_inpaint_bf16", ["-f", clip44, "--mode", "inpaint",
                                             "--inpaint_window", *INPAINT_WINDOW])):
        argv = sa_gen + extra + ["--save_path", os.path.join(tmp, name)]
        outs, rec, run = _counted_run(fa, sw, f"phase9 {name}", lambda: generate(argv), sa_per(True),
                                 P9_SA_STEPS, "generate_seconds")
        _wav_samples(name, outs[0], 44100, shape=(10 * 44100, 2))
        if "inpaint" in name:
            run["kept_region_bit_exact"] = rec["kept_region_bit_exact"]
            if rec["kept_region_bit_exact"] is not True:
                raise AssertionError(f"{name}: the kept region is not the source latent")
        record(name, run)

    # --- cli/run_long.py, with the fold check on the float32 AudioLDM-s run
    long_clip, long44 = os.path.join(tmp, "long.wav"), os.path.join(tmp, "long44k.wav")
    write_clip(long_clip, seconds=LONG_SECONDS)
    write_clip(long44, seconds=SA_LONG_SECONDS, sr=44100, channels=2)
    edit_flags = ["--source_prompt", "a sine tone", "--cfg_src", "3", "--cfg_tar", "12",
                  "--tstart", str(P9_TSTART), "--seed", "0"]
    captured = {}
    real_edit_batch = run_long.edit_batch

    def capture(pipe, w0, noise, args, tstart, mesh=None):
        out = real_edit_batch(pipe, w0, noise, args, tstart, mesh)
        captured.update(pipe=pipe, w0=w0, noise=noise, args=args, tstart=tstart, w=out[0])
        return out

    for name, model_id, clip_path, extra in (
            ("long", MODEL_ID, long_clip, []), ("long_bf16", MODEL_ID, long_clip, bf16),
            ("sa_long_bf16", SA_MODEL_ID, long44, bf16)):
        sa = model_id == SA_MODEL_ID
        steps = P9_SA_STEPS if sa else P9_STEPS
        argv = (["--model_id", model_id, "--init_aud", clip_path, "--target_prompt",
                 EDITS[model_id][2], "--num_diffusion_steps", str(steps),
                 "--chunk_seconds", str(CHUNK_S), "--overlap_seconds", str(OVERLAP_S),
                 "--results_path", os.path.join(tmp, name)] + edit_flags + extra)
        run_long.edit_batch = capture if name == "long" else real_edit_batch
        try:
            out, rec, run = _counted_run(fa, sw, f"phase9 {name}", lambda: run_long.main(argv),
                                    sa_per(True) if sa else mel_per(bool(extra)),
                                    steps + P9_TSTART, "edit_seconds")
        finally:
            run_long.edit_batch = real_edit_batch
        n_win = LONG_WINDOWS["stable_audio" if sa else "mel"]
        shape = ((int(SA_LONG_SECONDS * 44100), 2) if sa
                 else (int(LONG_SECONDS * 102.4) * 160,))
        _wav_samples(name, out, 44100 if sa else 16000, shape=shape)
        run["n_windows"] = rec["n_windows"]
        if rec["n_windows"] != n_win:
            raise AssertionError(f"{name}: {rec['n_windows']} windows, expected {n_win}")
        if name == "long":
            c = captured
            single, _, _ = real_edit_batch(c["pipe"], c["w0"][:1], c["noise"][:, :1], c["args"],
                                           c["tstart"])
            run["fold_max_rel_err"] = checks["fold_max_rel_err"] = _max_rel(c["w"][:1], single)
            captured.clear()
            log(f"[phase9] fold check: window 0 of the 3-window float32 edit against its "
                f"single-window edit: max rel err {run['fold_max_rel_err']:.3g} "
                f"(limit {FOLD_MAX_REL})")
            if not run["fold_max_rel_err"] <= FOLD_MAX_REL:
                raise AssertionError(f"fold check: {run['fold_max_rel_err']} > {FOLD_MAX_REL}")
        record(name, run)

    # --- cli/run_batch.py: three clips of different lengths, float32
    bdir = os.path.join(tmp, "batch_clips")
    os.makedirs(bdir)
    for i, s in enumerate(BATCH_SECONDS):
        write_clip(os.path.join(bdir, f"clip{i}.wav"), seconds=s)
    argv = (["--model_id", MODEL_ID, "--init_aud", bdir, "--target_prompt", "a dog barking",
             "--num_diffusion_steps", str(P9_STEPS), "--results_path",
             os.path.join(tmp, "batch")] + edit_flags)
    outs, _, run = _counted_run(fa, sw, "phase9 batch", lambda: run_batch(argv), mel_per(False),
                           P9_STEPS + P9_TSTART, "edit_seconds")
    for o, s in zip(outs, BATCH_SECONDS):
        _wav_samples("batch", o, 16000, shape=(int(s * 102.4) * 160,))
    run["clips"] = len(outs)
    record("batch", run)

    # --- cli/sweep.py: a 2 x 2 grid, each point held to cli/run.py, both
    # with cuDNN's deterministic algorithms (restored after)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        lsb = _sweep_against_run(fa, sw, tmp, clip, mel_per, record, run_edit, sweep)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    checks["sweep_max_lsb_from_run"] = lsb
    checks["sweep_cudnn_deterministic"] = True
    log(f"[phase9] sweep check (cuDNN deterministic): each grid point against cli/run.py: "
        f"{lsb} LSB (limit {SWEEP_MAX_LSB})")
    if any(x is None or x > SWEEP_MAX_LSB for x in lsb):
        raise AssertionError(f"sweep check: {lsb} LSB from cli/run.py")
    checks["kept_region_bit_exact"] = all(r.get("kept_region_bit_exact", True)
                                          for r in runs.values())
    return runs, checks


def _sweep_against_run(fa, sw, tmp, clip, mel_per, record, run_edit, sweep) -> list:
    """Phase 9's sweep (a 2 x 2 grid) and cli/run.py at each grid point:
    the int16 LSB between each pair."""
    argv = (["--model_id", MODEL_ID, "--init_aud", clip, "--target_prompt", "a dog barking",
             "--source_prompt", "a sine tone", "--cfg_src", "3", "--num_diffusion_steps",
             str(P9_STEPS), "--tstarts", *map(str, SWEEP_TSTARTS), "--cfg_tars",
             *map(str, SWEEP_CFGS), "--seed", "0", "--results_path", os.path.join(tmp, "sweep")])
    grid = [(t, c) for t in SWEEP_TSTARTS for c in SWEEP_CFGS]
    outs, _, run = _counted_run(fa, sw, "phase9 sweep", lambda: sweep(argv), mel_per(False),
                           P9_STEPS + sum(t for t, _ in grid), "edit_seconds")
    record("sweep", run)
    lsb = []
    for out, (t, c) in zip(outs, grid):
        name = f"sweep_check_t{t}_cfg{c:g}"
        argv = ["--model_id", MODEL_ID, "--init_aud", clip, "--source_prompt", "a sine tone",
                "--target_prompt", "a dog barking", "--cfg_src", "3", "--cfg_tar", str(c),
                "--num_diffusion_steps", str(P9_STEPS), "--tstart", str(t), "--seed", "0",
                "--results_path", os.path.join(tmp, name)]
        edit, _, erun = _counted_run(fa, sw, f"phase9 {name}", lambda: run_edit(argv),
                                mel_per(False), P9_STEPS + t, "edit_seconds")
        a = _wav_samples(name, out, 16000, min_len=10 * 16000)
        b = _wav_samples(name, edit, 16000, min_len=10 * 16000)
        erun["max_lsb_from_sweep"] = int(np.abs(a - b).max()) if a.shape == b.shape else None
        lsb.append(erun["max_lsb_from_sweep"])
        record(name, erun)
    return lsb


def clip_tokenizer_json() -> dict:
    """A small CLIP-shaped tokenizer (NFC, whitespace runs to one space and
    lowercase; CLIP's split, then byte level; BPE with the ``</w>`` suffix
    and merges for a few words; ``<|startoftext|> $A <|endoftext|>``) with
    ids inside CLIP's vocabulary."""
    from audioeditingcode_tpu_torch.models.tokenizers import _BYTE_CHARS, CLIP_SPLIT

    vocab = {}
    for c in _BYTE_CHARS.values():
        vocab.setdefault(c, len(vocab))
    for c in list(_BYTE_CHARS.values()):
        vocab.setdefault(c + "</w>", len(vocab))
    merges = []
    for w in _WORDS + ("photo", "cat"):  # ASCII words: their bytes are their letters
        syms = list(w[:-1]) + [w[-1] + "</w>"]
        while len(syms) > 1:
            if [syms[0], syms[1]] not in merges:
                merges.append([syms[0], syms[1]])
            vocab.setdefault(syms[0] + syms[1], len(vocab))
            syms = [syms[0] + syms[1]] + syms[2:]
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    added = [dict(t, normalized=True) for t in _added([(49406, "<|startoftext|>"),
                                                        (49407, "<|endoftext|>")])]
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "NFC"}, {"type": "Replace", "pattern": {"Regex": "\\s+"}, "content": " "},
                {"type": "Lowercase"}]},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": CLIP_SPLIT}, "behavior": "Removed",
                 "invert": True},
                {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                 "use_regex": True}]},
            "post_processor": {"type": "RobertaProcessing", "sep": ["<|endoftext|>", 49407],
                               "cls": ["<|startoftext|>", 49406], "trim_offsets": False,
                               "add_prefix_space": False},
            "decoder": None,
            "model": {"type": "BPE", "dropout": None, "unk_token": "<|endoftext|>",
                      "continuing_subword_prefix": "", "end_of_word_suffix": "</w>",
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}


def write_sd_checkpoint(ckpt: str):
    """A Stable Diffusion v1.4 weights_dir (unet.msgpack, vae.msgpack and
    clip/) from seeded random full-width modules, written by the port;
    returns each module's state dict on the CPU and each file's bytes and
    write seconds."""
    from audioeditingcode_tpu_torch.models import registry as treg
    from audioeditingcode_tpu_torch.models.text_encoders import (
        CLIPTextModel,
        clip_config,
        save_text_tower,
    )

    pipe = treg.load_model(SD_MODEL_ID, 4, device="cpu", seed=CHECKPOINT_SEED)
    clip = treg.seeded(lambda: CLIPTextModel(clip_config(CLIP_TEXT)),
                       torch.Generator().manual_seed(CHECKPOINT_SEED + 1))
    mods = {"unet": pipe.unet, "vae": pipe.vae, "clip": clip}
    written = {}
    os.makedirs(ckpt, exist_ok=True)
    for name, mod in mods.items():
        t0 = time.perf_counter()
        if name == "clip":
            d = os.path.join(ckpt, "clip")
            save_text_tower(mod, d, CLIP_TEXT)
            path = os.path.join(d, "flax_model.msgpack")
            with open(os.path.join(d, "tokenizer.json"), "w") as f:
                json.dump(clip_tokenizer_json(), f)
            with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
                json.dump({"model_max_length": 77, "pad_token": "<|endoftext|>"}, f)
        else:
            path = os.path.join(ckpt, f"{name}.msgpack")
            treg.save_params(mod, path)
        written[name] = {"bytes": os.path.getsize(path), "write_s": time.perf_counter() - t0}
    return {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for name, m in mods.items()}, written


def _vq_check(fa, sw) -> dict:
    """The full-width CelebA-HQ VQ autoencoder (seeded) on a 256 px image,
    card vs CPU: the encode, the codes (equal wherever the two nearest
    codes are not within VQ_TIE_REL of each other) and the decode without
    quantization of the same latent."""
    from audioeditingcode_tpu_torch.models import registry as treg
    from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS
    from audioeditingcode_tpu_torch.models.vae import VQModel

    vq = treg.seeded(lambda: VQModel(MODEL_SPECS[CELEBA_MODEL_ID].vae),
                     torch.Generator().manual_seed(12)).eval().requires_grad_(False)
    img = torch.rand((1, 3, 256, 256), generator=torch.Generator().manual_seed(13)) * 2 - 1
    gpu = copy.deepcopy(vq).cuda()
    reset_launches(fa, sw)
    with torch.no_grad():
        t0 = time.perf_counter()
        z = vq.encode(img)
        q = vq.quantize(z)
        dec = vq.decode(z, force_not_quantize=True)
        cpu_s = time.perf_counter() - t0
        gz = gpu.encode(img.cuda())
        gq = gpu.quantize(gz).cpu()
        gdec = gpu.decode(z.cuda(), force_not_quantize=True).cpu()
    launched = read_launches(fa, sw)
    flat = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]).double()
    cb = vq.codebook.double()
    d = (flat.square().sum(1, keepdim=True) - 2 * flat @ cb.T + cb.square().sum(1)[None]
         ).topk(2, dim=1, largest=False).values
    tie = (d[:, 1] - d[:, 0]) <= VQ_TIE_REL * d[:, 0].abs()
    same = (q == gq).all(dim=1).reshape(-1)
    out = {"vq_encode_max_rel_err": _max_rel(gz.cpu(), z),
           "vq_decode_max_rel_err": _max_rel(gdec, dec),
           "vq_codes": int(same.numel()), "vq_codes_equal": int(same.sum()),
           "vq_code_ties": int(tie.sum()), "vq_codes_differing_off_ties": int((~same & ~tie).sum()),
           "vq_cpu_s": cpu_s}
    log(f"[phase10a] CelebA-HQ VQ at 256 px, card vs CPU: {out} (decode limit {VQ_DECODE_TOL})")
    if out["vq_codes_differing_off_ties"] or not out["vq_decode_max_rel_err"] <= VQ_DECODE_TOL:
        raise AssertionError(f"phase10a: VQ card vs CPU {out}")
    if any(launched.values()):
        raise AssertionError(f"phase10a: the VQ autoencoder launched kernels: {launched}")
    return out


def phase10a_checkpoint(fa, sw, tmp: str) -> dict:
    """Write the full-width SD v1.4 checkpoint (phase 8's is deleted first:
    nothing after phase 8 reads it), load it back on the card bit-equal,
    hold the full-width CLIP tower card vs CPU, one SD UNet CFG forward at
    256 px card vs CPU in float32 and in bfloat16 (against the float32 CPU
    forward, within BF16_FORWARD_RATIO times the bf16 plain versions' error
    on the card), and the CelebA-HQ VQ autoencoder."""
    import shutil

    from audioeditingcode_tpu_torch.models import flax_msgpack
    from audioeditingcode_tpu_torch.models import registry as treg
    from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS
    from audioeditingcode_tpu_torch.models.unet2d import UNet2DConditionModel

    shutil.rmtree(os.path.join(tmp, "audioldm2_music_ckpt"), ignore_errors=True)
    ckpt = os.path.join(tmp, "sd_ckpt")
    t0 = time.perf_counter()
    want, written = write_sd_checkpoint(ckpt)
    write_s = time.perf_counter() - t0
    flax_msgpack.LOAD_SECONDS.clear()
    t0 = time.perf_counter()
    pipe = treg.load_model(SD_MODEL_ID, 4, device="cuda", weights_dir=ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for name, mod in (("unet", pipe.unet), ("vae", pipe.vae), ("clip", pipe.text_encoder.clip)):
        _assert_bit_equal(name, mod.state_dict(), want[name])
    files = {os.path.relpath(path, ckpt): {"bytes": b, "load_s": s}
             for path, (b, s) in flax_msgpack.LOAD_SECONDS.items()}
    log(f"[phase10a] wrote the SD checkpoint in {write_s:.1f} s: {written}")
    log(f"[phase10a] load_model on the card in {load_s:.1f} s, every module bit-equal; "
        f"per file: {files}")
    spec = MODEL_SPECS[SD_MODEL_ID]
    prompts = ["", "a photo of a cat"]  # the CFG pair: unconditional, then the prompt
    card = pipe.encode_text(prompts).hidden_states.cpu()
    cpu = treg._try_clip_encoder(spec, ckpt, "cpu")(prompts).hidden_states
    clip_err = _max_rel(card, cpu)
    log(f"[phase10a] CLIP text tower {list(card.shape)} card vs CPU max rel err "
        f"{clip_err:.3g} (limit {TEXT_CHAIN_TOL})")
    if not clip_err <= TEXT_CHAIN_TOL:
        raise AssertionError(f"phase10a: CLIP card vs CPU {clip_err} > {TEXT_CHAIN_TOL}")

    unet_cpu = treg._meta(lambda: UNet2DConditionModel(spec.unet))
    unet_cpu.load_state_dict(want["unet"], assign=True)
    unet_cpu.eval().requires_grad_(False)
    x = torch.randn((1, 4, 32, 32), generator=torch.Generator().manual_seed(14)).repeat(2, 1, 1, 1)
    t = torch.tensor([501, 501])

    def forward(model, dev, dtype):
        with torch.no_grad():
            return model(x.to(dev, dtype), t.to(dev), cpu.to(dev)).cpu()

    t0 = time.perf_counter()
    cpu_out = forward(unet_cpu, "cpu", torch.float32)
    cpu_s = time.perf_counter() - t0
    del unet_cpu
    reset_launches(fa, sw)
    gpu_out = forward(pipe.unet, "cuda", torch.float32)
    launched = read_launches(fa, sw)
    rel = _max_rel(gpu_out, cpu_out)
    unet = treg.to_model_dtype_(pipe.unet, "cuda", torch.bfloat16)
    reset_launches(fa, sw)
    bf16_out = forward(unet, "cuda", torch.bfloat16)
    launched_tc = read_launches(fa, sw)
    with _plain_ops():
        plain_out = forward(unet, "cuda", torch.bfloat16)
    err, plain_err = _rel_fro(bf16_out, cpu_out), _rel_fro(plain_out, cpu_out)
    limit = BF16_FORWARD_RATIO * plain_err
    calls = SD_CALLS_PER_FORWARD[256]
    log(f"[phase10a] SD UNet CFG forward {list(x.shape)} (256 px), 77 CLIP tokens: card vs CPU "
        f"max rel err {rel:.3g} (limit 1e-3, TF32 off), launches {launched}, CPU {cpu_s:.1f} s; "
        f"bf16 card vs float32 CPU relative Frobenius error {err:.4g}, the bf16 plain versions "
        f"on the card {plain_err:.4g} (limit {limit:.4g}), launches {launched_tc}")
    if not np.isfinite(rel) or rel > 1e-3:
        raise AssertionError(f"phase10a: SD UNet card/CPU parity {rel} > 1e-3")
    if not np.isfinite(err) or err > limit:
        raise AssertionError(f"phase10a: SD UNet bf16 card error {err} > {limit}")
    if (launched != expected_launches({"flash_attention": calls}, 1)
            or launched_tc != expected_launches({"flash_attention_tc": calls}, 1)):
        raise AssertionError(f"phase10a: SD UNet launches {launched}, {launched_tc}; expected "
                             f"{calls} per forward")
    del pipe, unet
    torch.cuda.empty_cache()
    out = {"dir": ckpt, "sd_checkpoint_files": files, "sd_checkpoint_load_s": load_s,
           "sd_checkpoint_write_s": write_s, "clip_max_rel_err": clip_err,
           "sd_unet_rel_err": rel, "sd_unet_bf16_rel_fro_err": err,
           "sd_unet_bf16_plain_rel_fro_err": plain_err, "sd_unet_cpu_s": cpu_s}
    return out | _vq_check(fa, sw)


def write_image(path: str, size: int = 512) -> None:
    """A synthetic RGB image: smooth colour waves over seeded noise."""
    from audioeditingcode_tpu_torch.utils.image_io import save_image

    y, x = np.mgrid[0:size, 0:size] / size
    img = np.stack([np.sin(2 * np.pi * (3 * x + k / 3)) * np.cos(2 * np.pi * (2 * y - k / 5))
                    for k in range(3)])[None] * 0.7
    img += 0.1 * np.random.default_rng(0).standard_normal(img.shape)
    save_image(path, img.astype(np.float32))


def _check_png(name: str, path: str, size: int, orig: np.ndarray) -> np.ndarray:
    """An output image: size x size RGB through the port's PNG reader, not
    the input image."""
    from audioeditingcode_tpu_torch.utils.image_io import read_png_rgb

    img = read_png_rgb(path)
    if img.shape != (size, size, 3) or (orig.shape == img.shape and np.array_equal(img, orig)):
        raise AssertionError(f"{name}: bad output image {path}: shape {img.shape}, or orig.png")
    return img.astype(np.int64)


def phase10_sd_1024(fa, sw, tmp: str, ckpt: str, im: str) -> dict:
    """SDEdit on SD v1.4 at -r 1024 1024 (4 forwards) in float32 and
    bfloat16: B1 at (2, 16384, 8, 40), (2, 4096, 8, 80) and (2, 1024, 8,
    160); the head-dim-160 launches are counted by a spy on B1's wrapper."""
    from audioeditingcode_tpu_torch.cli.images import sdedit_main
    from audioeditingcode_tpu_torch.utils.image_io import read_png_rgb

    runs = {}
    for name, extra in (("sd_sdedit_1024", []), ("sd_sdedit_1024_bf16", ["--dtype", "bfloat16"])):
        argv = ["--model_id", SD_MODEL_ID, "--init_im", im, "--target_prompt", "a photo of a cat",
                "--num_diffusion_steps", str(IMG_STEPS), "--tstart", str(SD_1024_TSTART),
                "-r", "1024", "1024", "--seed", "0", "--weights_dir", ckpt, "--wandb_disable",
                "--results_path", os.path.join(tmp, name)] + extra
        per = {"flash_attention" + ("_tc" if extra else ""): SD_CALLS_PER_FORWARD[1024]}
        with _b1_shapes(fa) as shapes:
            out, _, run = _counted_run(fa, sw, f"phase10 {name}", lambda: sdedit_main(argv),
                                       per, SD_1024_TSTART, "sdedit_seconds")
        run["b1_shapes"] = {str(k): n for k, n in sorted(shapes.items())}
        run["d160_launches"] = sum(n for (q, _, _), n in shapes.items() if q[3] == 160)
        want = SD_1024_D160_PER_FORWARD * SD_1024_TSTART
        if run["d160_launches"] != want:
            raise AssertionError(f"phase10 {name}: {run['d160_launches']} launches at head "
                                 f"dim 160, expected {want}: {run['b1_shapes']}")
        orig = read_png_rgb(os.path.join(os.path.dirname(out), "orig.png"))
        _check_png(name, out, 1024, orig)
        runs[name] = run
        log(f"[phase10] {name}: {run}")
    return runs


def phase10_images(fa, sw, tmp: str, ckpt: str):
    """The image CLIs through their main(argv): SDEdit on SD v1.4 from
    phase 10a's checkpoint at 512 px (100 steps, tstart 50) in float32 and
    bfloat16; PC extraction on it at 256 px (float32, one PC, PC_ITERS
    iterations at two window steps), then applications in bfloat16 at
    amounts 0 and 2 and in float32 at amount 0 (within IMG_AMOUNT0_MAX of the
    drift-free image); SDEdit on the CelebA-HQ LDM (seeded, VQ, 256 px,
    float32; no attention, so no kernel launch). Returns (runs, checks)."""
    from audioeditingcode_tpu_torch.cli.images import pc_apply_main, pc_extract_main, sdedit_main
    from audioeditingcode_tpu_torch.utils.image_io import read_png_rgb

    runs, checks = {}, {}
    im = os.path.join(tmp, "face.png")
    write_image(im)
    bf16 = ["--dtype", "bfloat16"]

    def per(px, bf):
        return {"flash_attention" + ("_tc" if bf else ""): SD_CALLS_PER_FORWARD[px]}

    for name, extra in (("sd_sdedit", []), ("sd_sdedit_bf16", bf16)):
        argv = ["--model_id", SD_MODEL_ID, "--init_im", im, "--target_prompt", "a photo of a cat",
                "--num_diffusion_steps", str(IMG_STEPS), "--tstart", str(IMG_TSTART), "--seed",
                "0", "--weights_dir", ckpt, "--wandb_disable",
                "--results_path", os.path.join(tmp, name)] + extra
        out, _, run = _counted_run(fa, sw, f"phase10 {name}", lambda: sdedit_main(argv),
                                   per(512, bool(extra)), IMG_TSTART, "sdedit_seconds")
        orig = read_png_rgb(os.path.join(os.path.dirname(out), "orig.png"))
        _check_png(name, out, 512, orig)
        runs[name] = run
        log(f"[phase10] {name}: {run}")

    runs.update(phase10_sd_1024(fa, sw, tmp, ckpt, im))

    steps, start, end = IMG_PC
    argv = ["--model_id", SD_MODEL_ID, "--init_im", im, "--num_diffusion_steps", str(steps),
            "--n_evs", "1", "--iters", str(PC_ITERS), "--drift_start", str(start),
            "--drift_end", str(end), "--seed", "0", "--weights_dir", ckpt, "--wandb_disable",
            "--results_path", os.path.join(tmp, "img_pc")]
    window = start - end
    pc_ckpt, runs["sd_pc_extract"] = _pc_run(fa, sw, "phase10 sd pc extract",
                                             lambda: pc_extract_main(argv), per(256, False),
                                             2 * steps + window * PC_ITERS)
    orig = read_png_rgb(os.path.join(os.path.dirname(pc_ckpt), "orig.png"))
    free = _check_png("sd pc extract", pc_ckpt[: -len(".npz")] + ".png", 256, orig)
    base = ["--extraction_path", pc_ckpt, "--drift_start", str(start), "--drift_end", str(end),
            "--seed", "0", "--wandb_disable"]
    imgs = {}
    for name, extra in (("sd_pc_apply_bf16_amount0", ["--amount", "0"] + bf16),
                        ("sd_pc_apply_bf16", ["--amount", "2"] + bf16),
                        ("sd_pc_apply_amount0", ["--amount", "0"])):
        outs, runs[name] = _pc_run(fa, sw, f"phase10 {name}", lambda: pc_apply_main(base + extra),
                                   per(256, "bfloat16" in extra), steps)
        imgs[name] = _check_png(name, outs[0], 256, orig)
        runs[name]["max_from_drift_free"] = int(np.abs(imgs[name] - free).max())
    checks["sd_pc_amount0_max_from_drift_free"] = runs["sd_pc_apply_amount0"]["max_from_drift_free"]
    checks["sd_pc_bf16_amount2_max_from_amount0"] = int(
        np.abs(imgs["sd_pc_apply_bf16"] - imgs["sd_pc_apply_bf16_amount0"]).max())
    log(f"[phase10] PC applications: float32 amount 0 {checks['sd_pc_amount0_max_from_drift_free']}"
        f" uint8 steps from the drift-free image (limit {IMG_AMOUNT0_MAX}); bf16 amount 2 "
        f"{checks['sd_pc_bf16_amount2_max_from_amount0']} from bf16 amount 0 (must exceed it)")
    if checks["sd_pc_amount0_max_from_drift_free"] > IMG_AMOUNT0_MAX:
        raise AssertionError(f"phase10: float32 amount 0 is {checks} from the drift-free image")
    if checks["sd_pc_bf16_amount2_max_from_amount0"] <= IMG_AMOUNT0_MAX:
        raise AssertionError(f"phase10: the drift did not move the image: {checks}")

    input_runs, checks["image_inputs"] = _image_inputs(fa, sw, tmp, ckpt)
    runs.update(input_runs)

    argv = ["--model_id", CELEBA_MODEL_ID, "--init_im", im, "--num_diffusion_steps",
            str(IMG_STEPS), "--tstart", str(IMG_TSTART), "--seed", "0", "--wandb_disable",
            "--results_path", os.path.join(tmp, "celebahq")]
    out, _, run = _counted_run(fa, sw, "phase10 celebahq_sdedit", lambda: sdedit_main(argv), {},
                               IMG_TSTART, "sdedit_seconds")
    _check_png("celebahq_sdedit", out, 256,
               read_png_rgb(os.path.join(os.path.dirname(out), "orig.png")))
    runs["celebahq_sdedit"] = run
    log(f"[phase10] celebahq_sdedit: {run}")
    return runs, checks


def _image_inputs(fa, sw, tmp: str, ckpt: str):
    """The committed inputs of tests/data/images decoded by the port's
    readers, each to the sha256 of PIL's decode, with its seconds; then a
    bfloat16 SD SDEdit at 512 px from the JPEG whose RST3 is renumbered
    RST4 (damaged data, read as libjpeg reads it), one from the lossy WebP with
    alpha, one from the JPEG-in-TIFF, one from the PackBits PSD, one from
    the DXT1 DDS (a 512 x 384 photo as a texture tool saves it) and one from
    the 9/7 JPEG 2000 photo. Returns (runs, checks)."""
    import hashlib

    from audioeditingcode_tpu_torch.cli.images import sdedit_main
    from audioeditingcode_tpu_torch.utils.image_io import read_image, read_png_rgb

    d = os.path.join(REPO, "tests", "data", "images")
    with open(os.path.join(d, "sha256.json")) as f:
        want = json.load(f)
    checks = {}
    for name, rec in want.items():
        t0 = time.perf_counter()
        px = read_image(os.path.join(d, name))
        decode_s = time.perf_counter() - t0
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        checks[name] = {"shape": list(px.shape), "decode_s": decode_s,
                        "sha256_equal": digest == rec["sha256"]}
        log(f"[phase10] {name} ({rec['what']}): {checks[name]}")
        if digest != rec["sha256"] or list(px.shape) != rec["shape"]:
            raise AssertionError(f"phase10: {name} decodes to {digest} {px.shape}, PIL's "
                                 f"decode is {rec['sha256']} {rec['shape']}")
    runs = {}
    checks["decode_s_all"] = sum(c["decode_s"] for c in checks.values())
    for name, image in (("sd_sdedit_jpeg_bf16", "photo_420_restart_rst4.jpg"),
                        ("sd_sdedit_webp_bf16", "photo_alpha.webp"),
                        ("sd_sdedit_jpeg_tiff_bf16", "photo_jpeg_ycbcr.tif"),
                        ("sd_sdedit_psd_bf16", "photo_packbits.psd"),
                        ("sd_sdedit_dds_bf16", "photo_dxt1.dds"),
                        ("sd_sdedit_jpeg2000_bf16", "photo_97.jp2")):
        argv = ["--model_id", SD_MODEL_ID, "--init_im", os.path.join(d, image),
                "--target_prompt", "a photo of a cat", "--num_diffusion_steps", str(IMG_STEPS),
                "--tstart", str(IMG_TSTART), "--seed", "0", "--weights_dir", ckpt,
                "--wandb_disable", "--dtype", "bfloat16", "--results_path",
                os.path.join(tmp, name)]
        out, _, run = _counted_run(fa, sw, f"phase10 {name}", lambda: sdedit_main(argv),
                                   {"flash_attention_tc": SD_CALLS_PER_FORWARD[512]},
                                   IMG_TSTART, "sdedit_seconds")
        _check_png(name, out, 512, read_png_rgb(os.path.join(os.path.dirname(out), "orig.png")))
        log(f"[phase10] {name}: {run}")
        runs[name] = run
    return runs, checks


@contextlib.contextmanager
def _b1_shapes(fa):
    """Count B1's launches by (q shape, k shape, kv_len) while inside: a spy
    takes the wrapper's place, with counters of its own that the wrapper's
    body raises (it names itself through the module), so the run's counts
    read as always; the wrapper and its counters are put back after, with
    the run's counts added."""
    real = fa.flash_attention_cuda
    shapes = {}

    def spy(q, k, v, kv_len=None):
        key = (tuple(q.shape), tuple(k.shape), k.shape[1] if kv_len is None else int(kv_len))
        shapes[key] = shapes.get(key, 0) + 1
        return real(q, k, v, kv_len)

    spy.launches = real.launches
    spy.launches_by_route = dict(real.launches_by_route)
    fa.flash_attention_cuda = spy
    try:
        yield shapes
    finally:
        real.launches = spy.launches
        real.launches_by_route = spy.launches_by_route
        fa.flash_attention_cuda = real


def _post(url: str, payload=None, raw: bytes = None):
    """(status, body, wall seconds) of a POST /edit."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/edit", data=raw if raw is not None
                                 else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def _serve_request(model_id: str, clip: str, **fields) -> dict:
    import base64

    with open(clip, "rb") as f:
        audio = base64.b64encode(f.read()).decode()
    return {"audio_b64": audio, "source_prompt": "a sine tone",
            "target_prompt": EDITS[model_id][2], "seed": 0, **fields}


@contextlib.contextmanager
def _serving(service):
    """The service's HTTP server on 127.0.0.1 (a free port) in a thread."""
    import threading

    from audioeditingcode_tpu_torch.serve import make_server

    server = make_server(service, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        th.join()


def _served(fa, sw, name, url, service, payload, per_forward, sr, shape):
    """One request from launch counts of 0, held to its forwards (the
    service's record) and launches per forward; its wav's rate and shape."""
    import io

    from scipy.io import wavfile

    reset_launches(fa, sw)
    code, body, wall = _post(url, payload)
    counts = read_launches(fa, sw)
    if code != 200:
        raise AssertionError(f"{name}: HTTP {code}: {body[:300]}")
    timing = service.timings[-1]
    n = timing["unet_steps"]
    want_n = SERVE_STEPS + payload.get("tstart", SERVE_STEPS // 2)
    rate, wav = wavfile.read(io.BytesIO(body))
    run = {"launches": counts, "forwards": n, "dtype": "bfloat16", "wall_s": wall,
           "loop_s": timing["edit_seconds"], "steps_per_s": n / timing["edit_seconds"],
           "wav_shape": list(wav.shape)}
    log(f"[phase11] {name}: {run}")
    if n != want_n or counts != expected_launches(per_forward, n):
        raise AssertionError(f"{name}: launches {counts} for {n} forwards (expected {want_n}), "
                             f"expected {expected_launches(per_forward, n)}")
    if rate != sr or not (wav.shape == shape if isinstance(shape, tuple) else
                          wav.ndim == 1 and wav.shape[0] >= shape) or not np.any(wav):
        raise AssertionError(f"{name}: bad wav: rate {rate}, shape {wav.shape}")
    return body, run


def phase11_serve(fa, sw, tmp: str):
    """The edit server (serve.py) on 127.0.0.1 at the JAX server's defaults
    (50 steps, bfloat16), driven over HTTP: AudioLDM-s with phase 3's clip
    (/healthz, three edits, two concurrent requests each bit-equal to the
    same request alone, a response bit-equal to EditService.edit in
    process, a malformed body and an out-of-range tstart answered 400);
    then Stable Audio with a 5 s and a 10 s stereo clip, each response
    cropped to its clip. Returns (runs, checks)."""
    import threading
    import urllib.request

    from audioeditingcode_tpu_torch.serve import EditService, _wav_bytes

    runs, checks = {}, {}
    clip = os.path.join(tmp, "clip.wav")
    t0, hits = time.perf_counter(), SETUP_STATS["hits"]
    service = EditService(MODEL_ID, SERVE_STEPS, dtype="bfloat16")
    checks["setup_s"] = {"audioldm": time.perf_counter() - t0}
    checks["setup_cached"] = {"audioldm": SETUP_STATS["hits"] > hits}
    per = {"flash_attention_tc": ATTN_CALLS_PER_FORWARD}
    with _serving(service) as url:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok" or health.get("backend") != "cuda":
            raise AssertionError(f"phase11: /healthz {health}")
        bodies, reqs = {}, {}
        for name, fields in SERVE_EDITS:
            reqs[name] = _serve_request(MODEL_ID, clip, **fields)
            bodies[name], runs[f"serve_{name}"] = _served(
                fa, sw, f"serve_{name}", url, service, reqs[name], per, 16000, 10 * 16000)
        # two requests at once, from two threads: each the same bytes as alone
        pair = ["default", "cfg_tar_6"]
        got = {}
        reset_launches(fa, sw)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda n=n: got.__setitem__(n, _post(url, reqs[n])))
                   for n in pair]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        counts = read_launches(fa, sw)
        n = sum(t["unet_steps"] for t in list(service.timings)[-2:])
        checks["concurrent_bit_equal"] = all(got[k][0] == 200 and got[k][1] == bodies[k]
                                             for k in pair)
        runs["serve_concurrent"] = {"launches": counts, "forwards": n, "wall_s": wall,
                                    "request_wall_s": [got[k][2] for k in pair]}
        log(f"[phase11] two concurrent requests: {runs['serve_concurrent']}; each bit-equal to "
            f"the same request alone: {checks['concurrent_bit_equal']}")
        if not checks["concurrent_bit_equal"] or counts != expected_launches(per, n):
            raise AssertionError(f"phase11: concurrent requests {checks}, launches {counts}")
        audio, sr = service.edit(open(clip, "rb").read(), EDITS[MODEL_ID][2],
                                 source_prompt="a sine tone", tstart=40, seed=0)
        checks["in_process_bit_equal"] = _wav_bytes(audio, sr) == bodies["tstart_40"]
        checks["bad_body_status"] = _post(url, raw=b"{not json")[0]
        checks["bad_tstart_status"] = _post(url, dict(reqs["default"],
                                                      tstart=SERVE_STEPS + 1))[0]
        log(f"[phase11] in-process edit bit-equal to the HTTP response: "
            f"{checks['in_process_bit_equal']}; a malformed body -> "
            f"{checks['bad_body_status']}, tstart {SERVE_STEPS + 1} -> "
            f"{checks['bad_tstart_status']}")
        if not checks["in_process_bit_equal"] or (checks["bad_body_status"],
                                                  checks["bad_tstart_status"]) != (400, 400):
            raise AssertionError(f"phase11: {checks}")
    del service
    torch.cuda.empty_cache()

    clip5 = os.path.join(tmp, "clip44k_5s.wav")
    write_clip(clip5, seconds=5.0, sr=44100, channels=2)
    t0, hits = time.perf_counter(), SETUP_STATS["hits"]
    service = EditService(SA_MODEL_ID, SERVE_STEPS, dtype="bfloat16")
    checks["setup_s"]["stable_audio"] = time.perf_counter() - t0
    checks["setup_cached"]["stable_audio"] = SETUP_STATS["hits"] > hits
    per = {"flash_attention_tc": SA_CALLS_PER_FORWARD, "swiglu_tc": SA_CALLS_PER_FORWARD}
    with _serving(service) as url:
        for name, path, secs in (("serve_sa_5s", clip5, 5),
                                 ("serve_sa_10s", os.path.join(tmp, "clip44k.wav"), 10)):
            _, runs[name] = _served(fa, sw, name, url, service,
                                    _serve_request(SA_MODEL_ID, path), per, 44100,
                                    (secs * 44100, 2))
    del service
    torch.cuda.empty_cache()
    return runs, checks


def _shard_case(kernel, dtype, shard, got, whole, plain, tol, times, bound):
    """One phase-12 shard check: its output against the unsharded kernel's
    rows or columns (bit-equal expected; otherwise the difference is
    reported) and against the plain version within ``tol``; ``times``: the
    kernel's, the plain version's and the library call's ms."""
    errors = _check(got, plain, tol)
    case = {"shard": shard, "dtype": str(dtype).split(".")[-1],
            "bit_equal_to_unsharded": torch.equal(got, whole),
            "max_abs_from_unsharded": (got.float() - whole.float()).abs().max().item(),
            "max_abs_err": errors[0], "err_over_allowed": errors[1], **times,
            "bound_ms": bound[0], "bound_by": bound[1]}
    log(f"[phase12] {kernel} {shard} {case['dtype']}: {case}")
    return case


def phase12_shards(fa, sw) -> dict:
    """The kernels on the shapes the parallel paths give them, in one
    process: B1 over each sp block of the DiT's padded sequence (its query
    rows against the whole padded K/V, kv_len 1025) at sp 1, 2 and 4; B3 over
    the tp column shards of the SwiGLU weight (matching value and gate row
    blocks) at tp 2 and 4 and over the sp row blocks of the CFG batch's
    tokens; float32 and bfloat16; each timed by CUDA events, the plain
    version and the library call (SDPA with the padded keys masked;
    F.linear + silu * mul) beside it. Comparison launches: no main-path
    count."""
    from torch.nn import functional as F

    from audioeditingcode_tpu_torch.utils.timing import cuda_ms

    def times_by_events(kernel, plain, library):
        """``_times`` without its torch.profiler half: this late in one
        process a run of profiles may all come back empty (CUPTI)."""
        return {"ms": cuda_ms(kernel, 10), "plain_ms": cuda_ms(plain, reps=5, warmup=1),
                "library_ms": cuda_ms(library, 10)}

    def swiglu_library(x, w, b):
        h, gate = F.linear(x, w, b.to(x.dtype)).chunk(2, dim=-1)
        return h * F.silu(gate)

    g = torch.Generator(device="cuda").manual_seed(12)
    B, H, Hkv, D = 2, 24, 12, 64
    out = {"flash_attention": [], "swiglu": []}
    for dtype in (torch.float32, torch.bfloat16):
        tol = fa.BF16_TOL if dtype == torch.bfloat16 else fa.F32_TOL
        for sp in SP_WAYS:
            S = -(-DIT_TOKENS // (8 * sp)) * 8 * sp
            q, k, v = (torch.randn(B, S, h, D, device="cuda", generator=g).to(dtype)
                       for h in (H, Hkv, Hkv))
            whole = fa.flash_attention_cuda(q[:, :DIT_TOKENS], k[:, :DIT_TOKENS],
                                            v[:, :DIT_TOKENS])
            n = S // sp
            # the library yardstick: SDPA with the padded keys masked, GQA's
            # kv heads repeated beforehand
            kr, vr = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) for t in (k, v))
            keep = (torch.arange(S, device="cuda") < DIT_TOKENS)[None, None, None, :]
            for r in range(sp):
                rows = slice(r * n, (r + 1) * n)
                got = fa.flash_attention_cuda(q[:, rows], k, v, kv_len=DIT_TOKENS)
                real = min(n, DIT_TOKENS - r * n)
                plain = fa.attention_reference(q[:, rows], k, v, kv_len=DIT_TOKENS)
                qt = q[:, rows].transpose(1, 2)
                times = times_by_events(
                    lambda: fa.flash_attention_cuda(q[:, rows], k, v, kv_len=DIT_TOKENS),
                    lambda: fa.attention_reference(q[:, rows], k, v, kv_len=DIT_TOKENS),
                    lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=keep))
                # the work of n query rows against 1025 keys
                bytes_ = (2 * B * n * H * D + 2 * B * S * Hkv * D) * (torch.finfo(dtype).bits // 8)
                rate = TF32X3_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
                bound = _bound(bytes_ / HBM_BYTES_PER_S,
                               4.0 * B * H * n * DIT_TOKENS * D / rate,
                               1.0 * B * H * n * DIT_TOKENS / EXP_PER_S)
                out["flash_attention"].append(_shard_case(
                    "flash_attention", dtype, f"sp {sp} block {r} ({list(q[:, rows].shape)} "
                    f"against {list(k.shape)}, kv_len {DIT_TOKENS})", got[:, :real],
                    whole[:, r * n: r * n + real], plain[:, :real], tol, times, bound))
            del q, k, v, whole, kr, vr
        stol = sw.BF16_TOL if dtype == torch.bfloat16 else sw.F32_TOL
        M, E, N = 2 * DIT_TOKENS, 1536, 6144
        x = torch.randn(M, E, device="cuda", generator=g).to(dtype)
        w = (torch.randn(2 * N, E, device="cuda", generator=g) / E ** 0.5).to(dtype)
        b = torch.randn(2 * N, device="cuda", generator=g) * 0.1
        whole = sw.swiglu_cuda(x, w, b)
        for tp in TP_WAYS:
            n = N // tp
            for r in range(tp):
                rows = torch.cat([torch.arange(r * n, (r + 1) * n),
                                  torch.arange(N + r * n, N + (r + 1) * n)]).cuda()
                ws, bs = w[rows].contiguous(), b[rows].contiguous()
                got = sw.swiglu_cuda(x, ws, bs)
                out["swiglu"].append(_shard_case(
                    "swiglu", dtype, f"tp {tp} shard {r} (W {list(ws.shape)})", got,
                    whole[:, r * n: (r + 1) * n], sw.swiglu_reference(x, ws, bs), stol,
                    times_by_events(lambda: sw.swiglu_cuda(x, ws, bs),
                                    lambda: sw.swiglu_reference(x, ws, bs),
                                    lambda: swiglu_library(x, ws, bs)),
                    swiglu_bound_ms(M, E, n, dtype)))
        for sp in SP_WAYS:
            # the CFG pair's padded tokens, each rank's row block of both,
            # against the unsharded kernel on the unpadded 2 x 1025 rows
            S = -(-DIT_TOKENS // (8 * sp)) * 8 * sp
            n = S // sp
            x3 = torch.randn(2, S, E, device="cuda", generator=g).to(dtype)
            whole3 = sw.swiglu_cuda(x3[:, :DIT_TOKENS].reshape(-1, E), w, b).reshape(
                2, DIT_TOKENS, N)
            for r in range(sp):
                xs = x3[:, r * n: (r + 1) * n].reshape(-1, E).contiguous()
                got = sw.swiglu_cuda(xs, w, b)
                real = min(n, DIT_TOKENS - r * n)
                out["swiglu"].append(_shard_case(
                    "swiglu", dtype, f"sp {sp} rows {r} (x {list(xs.shape)})",
                    got.reshape(2, n, N)[:, :real],
                    whole3[:, r * n: r * n + real],
                    sw.swiglu_reference(xs, w, b).reshape(2, n, N)[:, :real], stol,
                    times_by_events(lambda: sw.swiglu_cuda(xs, w, b),
                                    lambda: sw.swiglu_reference(xs, w, b),
                                    lambda: swiglu_library(xs, w, b)),
                    swiglu_bound_ms(xs.shape[0], E, N, dtype)))
            del x3, whole3
        del x, w, b, whole
        torch.cuda.empty_cache()
    return out


def phase12_sp1(fa, sw, tmp: str) -> dict:
    """The --sp 1 rehearsal through cli/run.py, inside a real NCCL process
    group of one: the DiT's 1025 tokens padded to 1032, B1 on the sp route
    (K/V all-gathered, kv_len 1025) and B3 on 2 x 1032 rows, 24 launches each
    per forward. Phase 4's float32 selfcheck and edit with the target prompt
    (host rotary + B1), at 20 + 10 steps (100 + 50 until PR 24): the
    selfcheck with --sp 1 within SP1_SNR_MAX_DB of the one without; the edit
    without --sp and with --sp 1, the edited latents (the decoder's input,
    by a spy) within SP1_LATENT_MAX_REL of each other: a selfcheck
    reconstructs its start for any deterministic denoiser, so only the edit
    can tell a wrong sp route."""
    from audioeditingcode_tpu_torch.cli.run import main as run_edit
    from audioeditingcode_tpu_torch.models.pipeline1d import StableAudioPipeline

    clip = os.path.join(tmp, "clip44k.wav")
    padded = -(-DIT_TOKENS // 8) * 8
    forwards = SHORT_STEPS + SHORT_TSTART
    sp_shapes = {((2, padded, 24, 64), (2, padded, 12, 64), DIT_TOKENS):
                 SA_CALLS_PER_FORWARD * forwards}
    latents, runs, wavs = {}, {}, {}
    real_decode = StableAudioPipeline.vae_decode
    for name, extra in (("selfcheck", ["--selfcheck"]),
                        ("sp1_selfcheck", ["--selfcheck", "--sp", "1"]), ("edit", []),
                        ("sp1_edit", ["--sp", "1"])):
        argv = edit_argv(SA_MODEL_ID, clip, os.path.join(tmp, "sa_" + name),
                         (SHORT_STEPS, SHORT_TSTART)) + extra

        def spy(pipe, z, name=name):
            latents[name] = z.detach().clone()
            return real_decode(pipe, z)

        StableAudioPipeline.vae_decode = spy
        try:
            with _b1_shapes(fa) as shapes:
                out, rec, run = _counted_run(fa, sw, f"phase12 {name}", lambda: run_edit(argv),
                                             _per_forward(SA_MODEL_ID, False), forwards,
                                             "edit_seconds")
        finally:
            StableAudioPipeline.vae_decode = real_decode
        run["b1_shapes"] = {str(k): n for k, n in shapes.items()}
        run["selfcheck_snr_db"] = rec["selfcheck_snr_db"]
        run["mesh"] = rec["mesh"]
        wavs[name] = _check_wav(name, out, 44100, 2)
        log(f"[phase12] {name}: {run}")
        sp = name.startswith("sp1")
        if sp and (shapes != sp_shapes or rec["mesh"] != {"dp": 1, "tp": 1, "sp": 1}):
            raise AssertionError(f"phase12 {name}: B1 shapes {shapes}, mesh {rec['mesh']}; "
                                 f"expected {sp_shapes}")
        runs[name] = run
    snr, plain = (runs[n]["selfcheck_snr_db"] for n in ("sp1_selfcheck", "selfcheck"))
    if not abs(snr - plain) <= SP1_SNR_MAX_DB:
        raise AssertionError(f"phase12 sp1: selfcheck {snr} dB, {plain} dB without --sp")
    err = _max_rel(latents["sp1_edit"], latents["edit"])
    lsb = int(np.abs(wavs["sp1_edit"] - wavs["edit"]).max())
    runs["sp1_edit"].update(latent_max_rel_err=err, wav_max_lsb_from_edit=lsb)
    log(f"[phase12] --sp 1 edit against the edit without --sp: edited latent max rel err "
        f"{err:.3g} (limit {SP1_LATENT_MAX_REL}); wav {lsb} LSB apart (not compared: the "
        f"seeded decoder lifts latent roundoff to full scale)")
    if not err <= SP1_LATENT_MAX_REL:
        raise AssertionError(f"phase12: the --sp 1 edit is {err} from the edit without --sp "
                             f"(limit {SP1_LATENT_MAX_REL})")
    return runs


# phase 13: the eval tower. A seeded CLAP checkpoint at transformers'
# default ClapAudioConfig and ClapTextConfig (HTSAT-base: depths 2, 2, 6,
# 2, 64 mel bins; RoBERTa-base) with projection 512, the geometry of the
# laion checkpoints the protocol names
CLAP_AUDIO = {"model_type": "clap_audio_model", "window_size": 8, "num_mel_bins": 64,
              "spec_size": 256, "patch_size": 4, "patch_stride": [4, 4], "hidden_size": 768,
              "depths": [2, 2, 6, 2], "num_attention_heads": [4, 8, 16, 32],
              "enable_fusion": False, "hidden_act": "gelu", "projection_dim": 512,
              "flatten_patch_embeds": True, "patch_embeds_hidden_size": 96,
              "enable_patch_layer_norm": True, "qkv_bias": True, "mlp_ratio": 4.0,
              "patch_embed_input_channels": 1, "layer_norm_eps": 1e-5,
              "projection_hidden_act": "relu"}
CLAP_TEXT_FULL = {"model_type": "clap_text_model", "vocab_size": 50265, "hidden_size": 768,
                  "num_hidden_layers": 12, "num_attention_heads": 12,
                  "intermediate_size": 3072, "hidden_act": "gelu",
                  "max_position_embeddings": 514, "type_vocab_size": 1,
                  "layer_norm_eps": 1e-12, "pad_token_id": 1, "bos_token_id": 0,
                  "eos_token_id": 2, "projection_dim": 512, "projection_hidden_act": "relu",
                  "position_embedding_type": "absolute"}
# transformers' ClapFeatureExtractor() as save_pretrained writes it
CLAP_PREPROCESSOR = {"feature_extractor_type": "ClapFeatureExtractor", "feature_size": 64,
                     "sampling_rate": 48000, "hop_length": 480, "max_length_s": 10,
                     "fft_window_size": 1024, "padding_value": 0.0,
                     "return_attention_mask": False, "frequency_min": 0,
                     "frequency_max": 14000, "top_db": None, "truncation": "fusion",
                     "padding": "repeatpad", "nb_frequency_bins": 513,
                     "nb_max_samples": 480000, "processor_class": "ClapProcessor"}
# the towers on the card against the same towers on the CPU in float32 (TF32
# off), max relative error of each stage, the pooled output and the
# embeddings; bound fixed before the first run: the towers' float32 sums in
# other orders, lifted by the depth (the JAX full-geometry tests hold the
# JAX tower to transformers' at 5e-4), with room to spare
CLAP_CARD_CPU_MAX_REL = 1e-3
# FAD of a set with itself, as a share of FAD between two sets that differ
FAD_SELF_MAX_SHARE = 1e-6
PROFILE_EDIT = (20, 10)  # the --profile_dir edit's steps and tstart


def write_clap_checkpoint(d: str) -> dict:
    """A seeded CLAP checkpoint in the layout ClapModel.from_pretrained
    reads: config.json, model.safetensors (the port's writer),
    preprocessor_config.json and tokenizer.json. Returns the written
    tensors."""
    from audioeditingcode_tpu_torch.models.clap_audio import ClapModel
    from audioeditingcode_tpu_torch.models.hf_checkpoint import write_checkpoint as write_hf

    config = {"model_type": "clap", "projection_dim": 512, "logit_scale_init_value": 1 / 0.07,
              "text_config": CLAP_TEXT_FULL, "audio_config": CLAP_AUDIO}
    torch.manual_seed(CHECKPOINT_SEED)
    model = ClapModel(config)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table") or "embeddings" in name:
                p.normal_(0.0, 0.02)
        bn = model.audio_model.audio_encoder.batch_norm
        bn.running_mean.normal_(0.0, 0.5)
        bn.running_var.uniform_(0.5, 2.0)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    write_hf(d, config, sd)
    with open(os.path.join(d, "preprocessor_config.json"), "w") as f:
        json.dump(CLAP_PREPROCESSOR, f, indent=2)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(roberta_tokenizer_json(), f)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": 512, "pad_token": "<pad>"}, f)
    return sd


def _wavs_under(*roots) -> list:
    return sorted(os.path.join(d, f) for root in roots for d, _, fs in os.walk(root)
                  for f in fs if f.endswith(".wav") and not f.startswith("orig"))


def phase13_evals(tmp: str, device: str = "cuda") -> dict:
    """The eval tower on the card: the seeded CLAP checkpoint loaded back
    bit-equal; the towers card vs CPU; cli/evals_run.py on phase 9's sweep
    tree (ours) and phase 7's SDEdit trees, and FAD between two wav
    directories; a --profile_dir edit against the same edit without it.
    (``device="cpu"`` rehearses the phase where there is no card.)"""
    from audioeditingcode_tpu_torch.cli.evals_run import main as evals_main
    from audioeditingcode_tpu_torch.cli.run import main as run_edit
    from audioeditingcode_tpu_torch.evals.features import ClapExtractor
    from audioeditingcode_tpu_torch.evals.lpaps import LPAPS
    from audioeditingcode_tpu_torch.evals.scores import read_csv
    from audioeditingcode_tpu_torch.models.clap_audio import load_clap
    from audioeditingcode_tpu_torch.models.clap_processor import ClapProcessor
    from audioeditingcode_tpu_torch.utils.audio_io import read_wav, write_wav

    rec = {}
    d = os.path.join(tmp, "clap_ckpt")
    t0 = time.perf_counter()
    written = write_clap_checkpoint(d)
    rec["checkpoint_bytes"] = os.path.getsize(os.path.join(d, "model.safetensors"))
    rec["checkpoint_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = load_clap(d)
    card = copy.deepcopy(cpu).to(device)
    if device == "cuda":
        torch.cuda.synchronize()
    rec["checkpoint_load_s"] = time.perf_counter() - t0
    got = card.state_dict()
    if sorted(got) != sorted(written) or not all(
            torch.equal(got[k].cpu(), v) for k, v in written.items()):
        raise AssertionError("phase13: the CLAP checkpoint did not load back bit-equal")
    log(f"[phase13] CLAP checkpoint: {rec['checkpoint_bytes'] / 1e6:.0f} MB written in "
        f"{rec['checkpoint_write_s']:.1f} s, loaded on the card bit-equal in "
        f"{rec['checkpoint_load_s']:.1f} s")

    # the towers, card vs CPU, on phase 3's clip and two prompts
    processor = ClapProcessor.from_dir(d)
    on_card = ClapExtractor.from_components(card, processor, device)
    on_cpu = ClapExtractor.from_components(cpu, processor, "cpu")
    aud, sr = read_wav(os.path.join(tmp, "clip.wav"))
    feats = on_card.features(aud, sr)
    with torch.no_grad():
        stages_g, pooled_g = card.audio_forward(feats)
        stages_c, pooled_c = cpu.audio_forward(feats.cpu())
    errs = {f"stage{i}": _max_rel(g.cpu(), c) for i, (g, c) in enumerate(zip(stages_g, stages_c))}
    errs["pooled"] = _max_rel(pooled_g.cpu(), pooled_c)
    errs["audio_embedding"] = _max_rel(torch.from_numpy(on_card.embed_audio(aud, sr)),
                                       torch.from_numpy(on_cpu.embed_audio(aud, sr)))
    prompts = ["a dog barking", "a sine tone and a cello"]
    errs["text_embedding"] = _max_rel(torch.from_numpy(on_card.embed_text(prompts)),
                                      torch.from_numpy(on_cpu.embed_text(prompts)))
    rec["card_vs_cpu_max_rel"] = errs
    log(f"[phase13] CLAP towers card vs CPU, max relative error: {errs} "
        f"(limit {CLAP_CARD_CPU_MAX_REL})")
    if not all(e <= CLAP_CARD_CPU_MAX_REL for e in errs.values()):
        raise AssertionError(f"phase13: CLAP card vs CPU {errs}")
    rec["lpaps_self"] = LPAPS(on_card).windowed(aud, aud, sr, sr)
    if rec["lpaps_self"] != 0.0:
        raise AssertionError(f"phase13: LPAPS of a clip with itself {rec['lpaps_self']}")
    del cpu, on_cpu, stages_c, pooled_c

    # FAD sets: phase 3's clip with its 5 s windows, and phase 9's sweep edits
    sweep_root = os.path.join(tmp, "sweep", MODEL_ID.split("/")[1])
    sdedit_roots = [os.path.join(tmp, "sdedit", MODEL_ID.split("/")[1]),
                    os.path.join(tmp, "sdedit_stable_audio", SA_MODEL_ID.split("/")[1])]
    fad_a, fad_b = os.path.join(tmp, "fad_clip"), os.path.join(tmp, "fad_edits")
    os.makedirs(fad_a)
    os.makedirs(fad_b)
    write_wav(os.path.join(fad_a, "clip.wav"), aud, sr)
    for i, start in enumerate(range(0, aud.shape[-1] - 5 * sr + 1, sr)):
        write_wav(os.path.join(fad_a, f"clip_{i}.wav"), aud[..., start: start + 5 * sr], sr)
    for i, path in enumerate(_wavs_under(sweep_root)):
        wav, wsr = read_wav(path)
        write_wav(os.path.join(fad_b, f"edit_{i}.wav"), wav, wsr)
    out = os.path.join(tmp, "eval_scores")
    t0 = time.perf_counter()
    outputs = evals_main(["--ours_dirs", sweep_root, "--sdedit_dirs", *sdedit_roots,
                          "--clap_model", d, "--fad_gen_dir", fad_b,
                          "--fad_ref_dirs", fad_a, fad_b, "--out_dir", out,
                          "--device", device])
    rec["evals_cli_s"] = time.perf_counter() - t0
    rec["outputs"] = sorted(os.path.basename(o) for o in outputs)
    checks = {}
    for method, roots in (("ours", [sweep_root]), ("sdedit", sdedit_roots)):
        table = read_csv(os.path.join(out, f"scores_{method}.csv"))
        wavs = _wavs_under(*roots)
        scores = [float(x) for col in ("clap", "lpaps") for x in table.column(col)]
        checks[method] = {"rows": len(table), "wavs": len(wavs),
                          "finite": bool(np.all(np.isfinite(scores)))}
        if sorted(table.column("path")) != wavs or not checks[method]["finite"]:
            raise AssertionError(f"phase13: scores_{method}.csv {checks[method]}: paths "
                                 f"{table.column('path')} against {wavs}")
        if method == "ours":
            want = sorted((str(P9_STEPS - t), repr(float(c)), "3.0")
                          for t in SWEEP_TSTARTS for c in SWEEP_CFGS)
            keys = sorted(zip(table.column("skip"), table.column("tarcfg"),
                              table.column("srccfg")))
            prompts_ok = (set(table.column("source_prompt")) == {"a sine tone"}
                          and set(table.column("target_prompt")) == {"a dog barking"}
                          and set(table.column("audio_input")) == {"clip"})
            if keys != want or not prompts_ok:
                raise AssertionError(f"phase13: sweep keys {keys}, expected {want}")
    cmp_rows = read_csv(os.path.join(out, "method_comparison.csv"))
    checks["method_comparison_rows"] = len(cmp_rows)
    with open(os.path.join(out, "fad.json")) as f:
        fads = json.load(f)
    rec["fad"] = fads
    share = fads[fad_b] / fads[fad_a]
    checks["fad_self_share"] = share
    log(f"[phase13] evals CLI in {rec['evals_cli_s']:.1f} s: {rec['outputs']}; {checks}; "
        f"FAD {fads} (self share limit {FAD_SELF_MAX_SHARE})")
    if not (np.isfinite(fads[fad_a]) and fads[fad_a] > 0 and abs(share) <= FAD_SELF_MAX_SHARE):
        raise AssertionError(f"phase13: FAD {fads}")
    rec["checks"] = checks

    # --profile_dir: a short float32 edit with and without the flag, with
    # cuDNN's deterministic algorithms (its default ones let two runs of one
    # edit lie 1 LSB apart on the card: the VAE's and vocoder's convolutions)
    steps, tstart = PROFILE_EDIT
    argv = ["--model_id", MODEL_ID, "--init_aud", os.path.join(tmp, "clip.wav"),
            "--target_prompt", "a dog barking", "--num_diffusion_steps", str(steps),
            "--tstart", str(tstart), "--seed", "0", "--device", device]
    prof = os.path.join(tmp, "profile")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = run_edit(argv + ["--results_path", os.path.join(tmp, "prof_plain")])
        t0 = time.perf_counter()
        traced = run_edit(argv + ["--results_path", os.path.join(tmp, "prof_traced"),
                                  "--profile_dir", prof])
        rec["profiled_edit_wall_s"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    traces = os.listdir(prof)
    rec["trace_bytes"] = sum(os.path.getsize(os.path.join(prof, t)) for t in traces)
    with open(plain, "rb") as a, open(traced, "rb") as b:
        rec["profiled_wav_bit_equal"] = a.read() == b.read()
    log(f"[phase13] --profile_dir edit: {traces} ({rec['trace_bytes']} bytes), wav bit-equal "
        f"to the edit without it: {rec['profiled_wav_bit_equal']}")
    if not traces or not rec["trace_bytes"] or not rec["profiled_wav_bit_equal"]:
        raise AssertionError(f"phase13: --profile_dir {rec}")
    shutil.rmtree(d)
    return rec


def _kernel_class(name: str) -> str:
    n = name.lower()
    for key, b1, b2 in (("attn_fwd_kernel", "attention kernel B1 (3xTF32)",
                         "attention kernel B2 (rotary, 3xTF32)"),
                        ("attn_tc_kernel", "attention kernel B1 (tensor cores)",
                         "attention kernel B2 (rotary, tensor cores)")):
        if key in n:  # the template's last argument is ROT
            return b2 if "true>" in n else b1
    for cls, keys in (("SwiGLU kernel B3 (tensor cores)", ("swiglu_tc_kernel",)),
                      ("SwiGLU kernel B3 (3xTF32)", ("swiglu_tf32x3_kernel",)),
                      ("convolution", ("fprop", "conv", "implicit_gemm", "winograd", "fft")),
                      ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
                      ("norm", ("norm", "welford")),
                      ("softmax", ("softmax",))):
        if any(k in n for k in keys):
            return cls
    return "elementwise/other"


def profile_main_path_step(model_id: str, steps: int, latent, dtype: torch.dtype,
                           n_steps: int = 6, rows: int = 1) -> dict:
    """torch.profiler over n CFG denoiser steps of a main path's config, on
    ``rows`` latents at once (a forward of batch 2 rows: rows = 2 is a power
    iteration's step at two PCs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audioeditingcode_tpu_torch.editing.cfg import build_cfg_tensors
    from audioeditingcode_tpu_torch.models.registry import load_model

    pipe = load_model(model_id, steps, device="cuda", dtype=dtype, seed=0)
    x = torch.randn((rows,) + tuple(latent), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3)).to(dtype)
    cfg, _ = build_cfg_tensors(x.shape, ["a dog barking"], [12.0], device="cuda")
    den = pipe.make_denoiser(pipe.encode_text([""], negative=True),
                             pipe.encode_text(["a dog barking"]), cfg)
    for k in range(2):
        den(x, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n_steps):
        den(x, k)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(n_steps):
            den(x, k)
        torch.cuda.synchronize()
    by_class, kernels = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3 / n_steps
        by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + ms
        kernels.append((ms, e.count // n_steps, e.key[:90]))
    busy = sum(by_class.values())
    out = {"model_id": model_id, "dtype": str(dtype).split(".")[-1], "forward_batch": 2 * rows,
           "rotary_in_kernel": os.environ.get("AEC_ROTARY_IN_KERNEL", "0") == "1",
           "step_wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall_ms),
           "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1]))}
    log(f"[profile] {json.dumps(out)}")
    for ms, count, key in sorted(kernels, reverse=True)[:15]:
        log(f"[profile]   {ms:8.3f} ms/step  x{count:<4d} {key}")
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    from audioeditingcode_tpu_torch.ops import build
    from audioeditingcode_tpu_torch.ops import flash_attention as fa
    from audioeditingcode_tpu_torch.ops import swiglu as sw
    from audioeditingcode_tpu_torch.utils.device import resolve_device

    resolve_device("cuda", 0)  # also turns TF32 off for float32
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[phase0] device {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    builds = {}
    for src, (nvcc_log, seconds) in sorted(built.items()):
        lines = nvcc_log.splitlines()
        builds[src] = {
            "seconds": seconds,
            "max_registers": max((int(m) for line in lines
                                  for m in re.findall(r"Used (\d+) registers", line)), default=0),
            "instances_spilling": sum(" 0 bytes spill stores" not in line
                                      for line in lines if "spill stores" in line),
            # ptxas C7518: wgmma under a branch it deems divergent, serialised
            "instances_wgmma_serialized": sum("wgmma.mma_async instructions are serialized"
                                              in line for line in lines)}
        log(f"[phase0] built csrc/{src}.cu in {seconds:.1f} s: {builds[src]}")
    log(f"[phase0] build of {sorted(built) or 'nothing (up to date)'}: {build_s:.1f} s in all")

    def by_route(kcases, names):
        """The cases of each route, by the name of its kernel."""
        return {name: [c for c in kcases if c["route"] == route] for route, name in names}

    phase_s = {}

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[phase] = time.perf_counter() - t0
        log(f"[{phase}] {phase_s[phase]:.1f} s")
        return out

    cases = {**by_route(timed("phase1", phase1_attention, fa),
                        ((fa.TENSOR_CORE, "flash_attention_tc"), (fa.TF32X3, "flash_attention"))),
             **by_route(phase1_rotary(fa), ((fa.TENSOR_CORE, "flash_attention_rotary_tc"),
                                            (fa.TF32X3, "flash_attention_rotary"))),
             **by_route(phase1_swiglu(sw), ((sw.TENSOR_CORE, "swiglu_tc"),
                                            (sw.TF32X3, "swiglu")))}

    parity, unet = timed("phase2", phase2_unet_parity, fa)
    parity.update(timed("phase2b", phase2b_stable_audio_parity, fa, sw))
    with tempfile.TemporaryDirectory() as tmp, reuse_setup() as setup_cache:
        runs = {"audioldm": timed("phase3", phase3_main_path, fa, sw, tmp),
                "stable_audio": timed("phase4", phase4_stable_audio, fa, sw, tmp)}
        runs["audioldm_pc"] = timed("phase5", phase_pcs, fa, sw, tmp, MODEL_ID,
                                    os.path.join(tmp, "clip.wav"), "phase5")
        runs["stable_audio_pc"] = timed("phase6", phase_pcs, fa, sw, tmp, SA_MODEL_ID,
                                        os.path.join(tmp, "clip44k.wav"), "phase6")
        runs["baselines"] = timed("phase7", phase7_baselines, fa, sw, tmp)
        cpu_refs = CpuReferences(unet)  # 2c's and 2d's CPU forwards, beside phase 8a
        ckpt = timed("phase8a", phase8a_checkpoint, tmp)
        parity.update(timed("phase2c", phase2c_probe, fa, sw, unet, cpu_refs))
        del unet
        parity.update(timed("phase2d", phase2d_unet_families, fa, sw, cpu_refs))
        parity["checkpoint"] = {k: v for k, v in ckpt.items() if k not in ("dir", "src")}
        runs["families"] = timed("phase8", phase8_families, fa, sw, tmp, ckpt["dir"])
        shutil.rmtree(ckpt["dir"])  # read by phase 8 alone; phase 8b converts its own
        runs["runbook"], runbook = timed("phase8b", phase8b_runbook, fa, sw, tmp, ckpt["src"])
        runs["phase9"], p9_checks = timed("phase9", phase9_new_clis, fa, sw, tmp)
        sd = timed("phase10a", phase10a_checkpoint, fa, sw, tmp)
        parity["images"] = {k: v for k, v in sd.items() if k != "dir"}
        runs["phase10"], p10_checks = timed("phase10", phase10_images, fa, sw, tmp, sd["dir"])
        runs["phase11"], p11_checks = timed("phase11", phase11_serve, fa, sw, tmp)
        shards = timed("phase12a", phase12_shards, fa, sw)
        runs["parallel"] = timed("phase12", phase12_sp1, fa, sw, tmp)
        evals = timed("phase13", phase13_evals, tmp)
    log(f"[setup] seeded weights and checkpoint reads reused: {setup_cache}")
    if "--profile" in sys.argv[1:]:
        for dtype in (torch.float32, torch.bfloat16):
            profile_main_path_step(MODEL_ID, STEPS, LATENT, dtype)
            profile_main_path_step(SA_MODEL_ID, SA_STEPS, SA_LATENT, dtype)
        os.environ["AEC_ROTARY_IN_KERNEL"] = "1"
        profile_main_path_step(SA_MODEL_ID, SA_STEPS, SA_LATENT, torch.bfloat16)
        os.environ.pop("AEC_ROTARY_IN_KERNEL")
        # a power iteration's step: float32, two PCs, a batch-4 forward
        profile_main_path_step(MODEL_ID, STEPS, LATENT, torch.float32, rows=PC_N_EVS)
        profile_main_path_step(SA_MODEL_ID, SA_STEPS, SA_LATENT, torch.float32, rows=PC_N_EVS)
        for dtype in (torch.float32, torch.bfloat16):
            profile_main_path_step(A2_MODEL_ID, STEPS, LATENT, dtype)

    sources = {"flash_attention": "flash_attention.cu",
               "flash_attention_tc": "flash_attention_tc.cu",
               "flash_attention_rotary": "flash_attention.cu",
               "flash_attention_rotary_tc": "flash_attention_tc.cu",
               "swiglu": "swiglu.cu", "swiglu_tc": "swiglu_tc.cu"}
    replaces = {"flash_attention": ("ops/flash_attention.py:72", "_attn_kernel"),
                "flash_attention_tc": ("ops/flash_attention.py:72", "_attn_kernel"),
                "flash_attention_rotary": ("ops/flash_attention.py:59", "_attn_rotary_kernel"),
                "flash_attention_rotary_tc": ("ops/flash_attention.py:59",
                                              "_attn_rotary_kernel"),
                "swiglu": ("ops/swiglu.py:47", "swiglu._kernel"),
                "swiglu_tc": ("ops/swiglu.py:47", "swiglu._kernel")}
    kernels = []
    for kname, kcases in cases.items():
        # the runs that launched it (the others launched it no time)
        by_run = {f"{model}_{run}": r["launches"][kname]
                  for model, model_runs in runs.items() for run, r in model_runs.items()
                  if r["launches"][kname]}
        main_case = kcases[0]  # the main path's first shape on this route
        kernels.append({
            "name": kname, "route": "cuda", "cores": main_case["route"],
            "source": "audioeditingcode_tpu_torch/csrc/" + sources[kname],
            "replaces": "audioeditingcode_tpu/" + replaces[kname][0],
            "tpu_kernel": replaces[kname][1],
            # counted over every main-path run of this script (each started
            # from 0 and read after it), and per run
            "launches": sum(by_run.values()), "launches_by_run": by_run,
            "shape": main_case["shape"], "dtype": main_case["dtype"],
            "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
            "device_ms": main_case["device_ms"], "host_bound": main_case["host_bound"],
            "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "bound_term": main_case["bound_term"],
            "library_ms": main_case["library_ms"],
            "library_device_ms": main_case["library_device_ms"],
            "cases": kcases,
            # phase 12: the shards the parallel paths give it (comparison
            # launches, not counted)
            "shard_cases": [c for c in shards.get(kname.replace("_tc", ""), [])
                            if (c["dtype"] == "bfloat16") == kname.endswith("_tc")],
        })
        if not sum(by_run.values()):
            raise AssertionError(f"{kname} was launched no time on the main paths")
    ald, sa = runs["audioldm"], runs["stable_audio"]
    ald_pc, sa_pc = runs["audioldm_pc"], runs["stable_audio_pc"]
    base, fam = runs["baselines"], runs["families"]
    record = {"kernels": kernels, "build_s": build_s, "builds": builds, **parity,
              "phase_s": phase_s, "pc_phases_s": phase_s["phase5"] + phase_s["phase6"],
              "pc_extract_s_per_window_step":
                  ald_pc["extract"]["power_iteration_s_per_window_step"],
              "stable_audio_pc_extract_s_per_window_step":
                  sa_pc["extract"]["power_iteration_s_per_window_step"],
              "pc_apply_bf16_s": sum(ald_pc["apply_bf16"]["stage_seconds"].values()),
              "stable_audio_pc_apply_bf16_s": sum(sa_pc["apply_bf16"]["stage_seconds"].values()),
              "edit_s": ald["edit"]["edit_s"], "steps_per_s": ald["edit"]["steps_per_s"],
              "selfcheck_snr_db": ald["selfcheck"]["selfcheck_snr_db"],
              "bf16_edit_s": ald["edit_bf16"]["edit_s"],
              "bf16_steps_per_s": ald["edit_bf16"]["steps_per_s"],
              # phase 4's edit seconds: its selfchecks run the edit's loops
              "stable_audio_edit_s": sa["selfcheck"]["edit_s"],
              "stable_audio_steps_per_s": sa["selfcheck"]["steps_per_s"],
              "stable_audio_selfcheck_snr_db": sa["selfcheck"]["selfcheck_snr_db"],
              "stable_audio_rotary_in_kernel_edit_s": sa["edit_rotary_in_kernel"]["edit_s"],
              "stable_audio_bf16_edit_s": sa["selfcheck_bf16"]["edit_s"],
              "stable_audio_bf16_steps_per_s": sa["selfcheck_bf16"]["steps_per_s"],
              "stable_audio_bf16_selfcheck_snr_db": sa["selfcheck_bf16"]["selfcheck_snr_db"],
              "stable_audio_rotary_in_kernel_bf16_edit_s":
                  sa["selfcheck_rotary_in_kernel_bf16"]["edit_s"],
              "stable_audio_rotary_in_kernel_bf16_selfcheck_snr_db":
                  sa["selfcheck_rotary_in_kernel_bf16"]["selfcheck_snr_db"],
              "loop_s": {name: r["loop_s"] for name, r in {**base, **fam}.items()},
              "selfcheck_snr_db_by_run": {name: r["selfcheck_snr_db"]
                                          for name, r in {**base, **fam}.items()
                                          if r["selfcheck_snr_db"] is not None},
              "sdedit_stable_audio_noise_s": base["sdedit_stable_audio"]["noise_s"],
              "phase9": {**p9_checks, "runs": {
                  name: {k: r[k] for k in ("forwards", "dtype", "loop_s", "steps_per_s",
                                           "wall_s", "setup_cached")}
                  for name, r in runs["phase9"].items()}},
              "phase10": {**p10_checks, "runs": {
                  name: {k: r.get(k) for k in ("forwards", "dtype", "loop_s", "steps_per_s",
                                               "wall_s", "setup_cached", "stage_seconds",
                                               "forwards_per_s",
                                               "d160_launches", "b1_shapes")}
                  for name, r in runs["phase10"].items()}},
              "phase11": {**p11_checks, "runs": {
                  name: {k: r.get(k) for k in ("forwards", "loop_s", "steps_per_s", "wall_s",
                                               "request_wall_s")}
                  for name, r in runs["phase11"].items()}},
              "phase8b": {**runbook, "runs": {
                  name: {k: r[k] for k in ("forwards", "loop_s", "steps_per_s", "wall_s",
                                           "setup_cached", "selfcheck_snr_db")}
                  for name, r in runs["runbook"].items()}},
              "phase12": runs["parallel"],
              "phase13": evals,
              "setup_cache": setup_cache,
              # wall minus loop (set-up, text towers, decode, writes) of each
              # run whose set-up reuse_setup did not serve: a CLI's own
              "outside_loop_s_uncached": {
                  f"{group}_{name}": r["wall_s"] - (r.get("loop_s") or r.get("edit_s") or
                                                    sum(r["stage_seconds"].values()))
                  for group, group_runs in runs.items() for name, r in group_runs.items()
                  if r.get("setup_cached") is False and r.get("wall_s") is not None}}
    record["script_s"] = time.perf_counter() - t_start
    log(f"[total] {record['script_s']:.1f} s; by phase "
        f"{ {k: round(v, 1) for k, v in phase_s.items()} }")
    print(json.dumps(record), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
