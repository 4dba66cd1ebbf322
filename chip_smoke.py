#!/usr/bin/env python3
"""
On-card smoke test of the PyTorch + CUDA port (riffusion_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. card: the card's name and power limit, and its maximum SM clock (the
   clock of the exp2 bound; nvidia-smi); no CUDA device fails.
2. build: nvcc builds csrc/attention.cu (K1), csrc/row_attention.cu (K2),
   csrc/attention_dkv.cu and csrc/attention_dq.cu (K1's backward) from this
   checkout, all at once; prints each build's seconds and each instance's
   ptxas registers and spills, and fails if a bf16 instance spills.
3. kernel: each forward kernel against its plain PyTorch version on the
   card, held to ops.attention.TOLERANCE: max abs error (bf16 2e-2, fp32
   with TF32 off 1e-4) and error RMS over output RMS (bf16 6e-3, fp32
   1e-5). K1 at the single path's two shapes, the batched path's
   (32, 1024, 8*80), (16, 1024, 8*80) and (8, 4096, 8*40), ragged lengths,
   other head dims and large logits; K2 at the batched path's
   (32, 4096, 8*40), (9, 2048, 8*40), a ragged (10, 1000, 2*16), large
   logits and fp32 (10, 2048, 2*16); K1 also at the sharded fine-tuning
   step's sites (tp 2: (4, 4096, 4*40), (4, 1024, 4*80); seq 2: queries
   (4, 2048 | 512, 8*d) against keys (4, 4096 | 1024, 8*d)); both at the tile edges of the bf16
   body they share (s_q 129, s_kv 191; K1 also s_q 65), one K/V tile
   (s = 64) and d = 24. Times (CUDA events, median of 20) K1, plain and
   torch's scaled_dot_product_attention (the library yardstick, never
   called by the port) at the two single-path shapes and at K1's batched
   site (32, 1024, 8*80), and K2, plain and the library at
   (32, 4096, 8*40) bf16, before any model is loaded (the plain version
   there needs about 45 GB). Each kernel's bound
   is the largest of its FLOPs over 989 TFLOP/s, its bytes over 3.35 TB/s
   and its exp2 calls (one per logit) over 132 SMs x 16 per clock at the
   maximum SM clock; the SM clock just after each timing is printed.
4. kernel-grad: K1's backward kernels (dK/dV, dQ) through `attention`'s
   autograd against the plain backward (ops.attention.
   attention_backward_reference), each of dQ, dK and dV held to
   GRAD_TOLERANCE (bf16 max abs 1.25e-1 and rel RMS 1e-2; fp32 1e-3 and
   2e-5), and the forward with LSE against the plain forward (TOLERANCE),
   at the fine-tuning path's (4, 4096, 8*40) and (4, 1024, 8*80) bf16, the
   sharded step's tp and seq sites (as in 3), ragged lengths, the bf16
   kernels' tile edges (s_q 129, s_kv 191), one streamed tile (s = 64),
   large logits and the fp32 instances; the forward's log-sum-exp against
   torch.logsumexp; times of the forward with LSE, the plain and the
   library's forward, each backward kernel, the plain backward and the
   library's backward at each of those six shapes, with each bound;
   `row_attention`'s backward (the plain recompute) at (9, 2048, 8*40).
5. dsp: audio -> mel -> Griffin-Lim audio on the card keeps a 220 Hz tone
   far above the noise floor (bench.py's gate).
6. tiny: the tiny model end to end on the card (fp32) against the same model
   on the CPU, with the same injected noise, at a 256 px seed (K1 sites
   reached, K2 not); images agree within one uint8 level on >= 99% of pixels.
   Then the same request with ddim, lms, euler and euler_a (its per-step
   noise injected too), a txt2img (euler_a), an img2img (lms) and
   img2img_magic_mix with pndm and euler (its VAE eps and q-sample noise
   injected), each held to the same image bound with K1 alone reached.
7. tiny batch: 5 requests through riffuse_audio_batch, the tiny model in fp32
   at a 512 px seed (UNet batch 10, the 64x64 level is lq 4096 at d=16, so K2
   is reached), on the card against the CPU with the same noise per request,
   with unipc_k:rho=2, ddim, lms, euler and euler_a; the same image bound, K2
   launched in each (euler_a's batch among them), no plain-version call.
   Then txt2img_audio_batch of 5 prompts at 512 px (pndm-10, UNet batch 10,
   fused through the audio tail) with the same noise per prompt: the same
   image bound, K2 launched, no plain call.
8. tiny train: three trainer steps of the tiny UNet in fp32 (32x32
   latents, so K1 and its backward are reached) on the card against the
   same steps on the CPU with the same t and noise: the losses, and the
   parameters' movement.
9. slice: random:full (SD v1 width) in bf16 behind the port's HTTP server;
   three POST /run_inference/ requests (og_beat seed, 50 steps, default
   strength) each return 200, a 512x512 image and 5.11 s of non-silent
   audio, and go through K1 exactly 380 times (38 UNet evaluations x 10
   self-attention sites) and K2 never, with no plain-version call.
10. batch: the same model behind the threading server with a DynamicBatcher
   (max_batch 16, the strength-gated FAST preset). 16 concurrent
   /run_inference/ requests coalesce into one launch of 16 (unipc_k:rho=2,
   12 UNet evaluations at UNet batch 32): K2 5*E and K1 5*E times. One
   request at strength 0.65 runs dpmpp-24 alone (K1 10*E), timed with the
   batching window closed so that it does not wait 3 s for company. One
   /run_inference_batch/ of 16 at 50-step PNDM: K2 and K1 190 times each.
   E comes from the port's plans. Every response passes the checks of 9.
modes: the same model's other generating modes, each twice.
   txt2img_audio_batch of 16 prompts, 512x512, pndm-30 (E = 31 at UNet
   batch 32), fused through the audio tail: K2 5*E and K1 5*E times, and
   every item a non-flat 512x512 image with 5.11 s of non-silent audio.
   img2img_magic_mix on og_beat, pndm-50, kmin 0.3, kmax 0.5 (E = 25 at
   UNet batch 2): K1 10*E times, K2 never, a non-flat image. Each one's
   seconds; E comes from the plans.
checkpoint: a diffusers-layout directory (under .chipwork/, deleted at the
   end) written from random:full's fp32 weights by this script's own writer
   and its own inverse of the loader's key renames, checked to round-trip on
   every key first: SD v1 config.json files, a scheduler config naming
   DDIMScheduler, the UNet and CLIP as safetensors, the VAE as a torch .bin
   under the old attention names (query/key/value/proj_attn). The server
   started with --checkpoint DIR loads it (UNet and CLIP bf16, VAE fp32):
   every parameter bit-equal to random:full's, the sampler ddim; prints the
   bytes on disk, the load seconds and the peak device memory. Two 50-step
   /run_inference/ requests at strength 0.75 through K1 exactly 10 x E times
   each (E, the DDIM plan's evaluations); then on the same pipeline one
   50-step riffuse_audio each with pndm, ddim, lms, euler and euler_a (two
   turns) and one 512x512 txt2img (euler_a, 50 steps), each with exact K1
   counts and a non-flat image; each request's seconds.
11. train: fine-tuning at full width from the checkpoint directory. 8
   synthesized clips of 5.12 s go through build_latent_dataset with the
   checkpoint's pipeline, then run_finetune(checkpoint=DIR, steps=4,
   batch_size=4) (fp32 masters, bf16 compute, AdamW,
   EMA, the final checkpoint and the export) in a directory under .chipwork/
   that is deleted at the end. Every step takes exactly 10 K1 forwards,
   10 dK/dV and 10 dQ launches and no plain call, with a finite loss.
   Prints the step time (median of steps 2-4), the peak device memory, the
   checkpoint's bytes and seconds and the free disk before the run. One
   full-width step's gradients with the kernels against the same step with
   the plain attention (the smoke swaps models.layers._ATTENTION_OPS in
   its own process) within TRAIN_GRAD_BOUND; the export reloaded with
   RiffusionPipeline.load_checkpoint and one request riffused with the
   sampler it carries from the checkpoint (ddim, 10 x E K1 launches).
cli: the command line on the checkpoint directory, in this process, with
   the text-embedding disk cache in a fresh directory under .chipwork/.
   text-to-audio (pndm-30, K1 10*E) writes 5.11 s of non-silent audio and a
   512x512 PNG; stream --num-clips 16 --batch 8 --fast runs 3 launches (one
   warm-up, two timed) of E = 12 at UNet batch 16, K2 and K1 each 3*5*E
   times, and writes 16 clips less 15 crossfades; its realtime factor is
   printed. Then warmstart_report on two fresh loads of the directory, each
   stage's seconds printed: the second load reads every embedding from the
   disk cache (hits > 0, no miss) and its kernels from csrc/build/
   (kernel_source "cached").
frontends: the playground's host layer and pages (riffusion_tpu_torch/
   streamlit/) on the checkpoint directory, loaded through
   streamlit/util.load_riffusion_checkpoint, at the UI defaults (50 steps,
   denoising 0.45, guidance 7, PNDM). The C++ audio engine is built with
   g++ into a fresh directory (its seconds), and each of its functions is
   held to its numpy version (ENGINE_BOUND) and to the JAX package's engine
   output on the same seeded buffers (ENGINE_DIGESTS), with both times. A
   seeded 30 s stereo file at 48 kHz goes to 44.1 kHz on the engine; the
   four stems of AudioSplitter(device="cuda") sum back to it (SPLIT_BOUND)
   and compute_fft finds the bass stem's 110 Hz tone above its 2 kHz one.
   restyle_audio on it: mode "interpolation" is one batched program of 7
   clips at UNet batch 14 (K1 at the seq-960 sites, 5 a UNet evaluation;
   the seq-3840 sites are no multiple of 512, so they take the plain
   composition as the JAX gate sends them: K2 never), mode "img2img" 7
   serial clips at UNet batch 2 (K1 10 a UNet evaluation), and
   restyle_segment in "magic_mix" on the first clip. Then the
   interpolation page's batch of 4 frames on og_beat (K1 only, UNet batch
   8), the batch page's 6 entries at 512 px (pndm-50, UNet batch 12: K2 and
   K1 5 a UNet evaluation each), one text-to-audio clip through
   run_txt2img, and og_beat to audio as the image-to-audio page does it.
   Each run's seconds, launches (exact, from the plans) and peak device
   memory; every clip checked.

parallel: multi-device serving (riffusion_tpu_torch/parallel/) in worlds of
   processes on the one card (parallel.mesh.spawn_world; NCCL takes one
   rank per card, so two ranks share cuda:0 over gloo, which moves the CUDA
   tensors through the host). Two gloo ranks: the tiny model in fp32 against
   the single-device runs on the card with the same injected noise, each
   held to phase 6's image bound with each rank's (K1, K2, plain) launches
   equal to the single-device run's: riffuse_audio_tp at tp 2 (256 px, K1
   at 1 of the 2 heads), riffuse_audio_batch(mesh) of 6 requests at d = 2
   at 512 px (a rank's UNet batch 6, the whole batch's 12: its seq-4096
   sites take K2 by the global-batch route), a FrameSweep of 4 alphas at
   d = 2 (K1 only); then random:full in bf16: one 50-step riffuse_audio_tp
   request at tp 2 (K1 exactly 380 per rank at (2, 4096, 4*40) and (2, 1024,
   4*80), a non-flat 512x512 image with 5.11 s of audio, its rel L2 to the
   single-device output under 2e-2) and one FAST batch of 16 at d = 2 (K2
   and K1 5*E per rank, every clip checked as in 10, each image's rel L2 to
   the unsharded batch's under 2e-2). A world of one on NCCL
   runs the tiny checks. `python -m riffusion_tpu_torch.parallel.dryrun --n
   2` runs as a command and exits 0. Two ranks on one card give no scaling
   number.

parallel-train: the sharded fine-tuning step (parallel/train.py
   DiffusionTrainer(mesh=)) in worlds of processes on the one card. Two
   gloo ranks sharing cuda:0, random:full with fp32 masters and bf16
   compute at batch 4 on 64x64x4 latents: the unsharded step once, then at
   each of the meshes (2,1,1), (1,2,1) and (1,1,2) two steps from the same
   weights on the same batch, t and noise: the first step's loss and each
   rank's gradients (its cut) against the unsharded step's within
   TRAIN_GRAD_BOUND, exactly 10 K1, 10 dK/dV and 10 dQ launches per rank
   per step and no plain call, finite parameters after AdamW with the
   replicated ones equal on both ranks (a checksum of their bits); the
   second step's seconds and each rank's peak memory. Then
   run_finetune(mesh_shape=(2,1,1)) of 2 steps at batch 4 from the
   checkpoint directory on the train phase's dataset (10 / 10 / 10 per
   step), its export reloaded here and one 50-step request served through
   K1. A world of one on NCCL runs the tiny step at (1,1,1) against the
   unsharded step (NCCL_TINY_BOUND). Two ranks on one card give no
   scaling number.

`--mutants` instead builds each planted fault of MUTANTS into a copy of
the kernel sources and shows that the checks of every kernel it touches
reject it (tests/test_torch_kernel_sources.py holds each fault's text to
its source on the CPU).

Each phase's seconds are printed ("[time]"). The pipelines' text-embedding
disk cache lives under .chipwork/ and is deleted at the end. The last two
lines are the kernel table and {"ok": true, "device": {"platform": "gpu",
...}}.
"""

from __future__ import annotations

import base64
import copy
import gc
import io
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from pathlib import Path

REPO = Path(__file__).resolve().parent
SLICE_SHAPES = ((2, 4096, 8, 40), (2, 1024, 8, 80))  # (batch, seq, heads, head_dim)
BATCH_SHAPE = (32, 4096, 8, 40)  # K2's site at serving batch 16
K1_BATCH_SHAPE = (32, 1024, 8, 80)  # K1's site at serving batch 16
TRAIN_SHAPES = ((4, 4096, 8, 40), (4, 1024, 8, 80))  # K1's sites at fine-tuning batch 4
# K1's sites in the sharded step at batch 4 (b, s_q, s_kv, h, d): tp 2 holds
# half the heads; seq 2 holds half the queries against the gathered K and V
SHARDED_TRAIN_SHAPES = ((4, 4096, 4096, 4, 40), (4, 1024, 1024, 4, 80),
                        (4, 2048, 4096, 8, 40), (4, 512, 1024, 8, 80))
LAUNCHES_PER_REQUEST = 38 * 10
LAUNCHES_PER_STEP = 10  # self-attention sites on K1 at UNet batch 4
SAMPLERS = ("ddim", "lms", "euler", "euler_a")  # the samplers a diffusers checkpoint names

# The card's published peaks (H100 SXM, dense) for the bound of each kernel:
# the largest of its FLOPs over the bf16 tensor-core rate, its bytes (each
# input read once, each output written once) over the memory rate, and its
# exp2 calls (one per logit) over the SFUs' rate, 16 per clock on each of
# the 132 SMs at the card's maximum SM clock (nvidia-smi clocks.max.sm).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SMS, EXP2_PER_SM_CLOCK = 132, 16

# One full-width step's gradients with the kernels against the plain
# attention's (PERF.md "Fine-tuning", written before the first run): the
# relative L2 of the difference over all parameters, and of the loss.
TRAIN_GRAD_BOUND = {"grad_rel_l2": 5e-2, "loss_rel": 1e-2}

# The audio engine's check (frontends phase): seeded int16 buffers made from
# integer arithmetic, cumulative sums and np.sin (_engine_pcm), held to the
# engine's numpy versions within ENGINE_BOUND and to the sha256 of the JAX
# package's engine output on the same buffers, taken on x86-64 where both
# packages run (native/audio_engine.cpp is built with -ffp-contract=off, so
# hosts with fused multiply-add give the same bits). Each case's input
# digest comes first, so that a host whose numpy makes other buffers is
# told apart from an engine that computes other samples. The two resamplers'
# filters differ in their transition band (the engine's Kaiser beta 8.555,
# scipy's 5.0), so the buffers' noise is band-limited below it: the bound
# measures the passband.
ENGINE_BOUND = {"resample_max_lsb": 64, "resample_rel_rms": 2e-3, "crossfade_max_lsb": 1}
ENGINE_RESAMPLES = ((44100, 48000), (48000, 44100), (44100, 22050))
ENGINE_DIGESTS = {  # case: (sha256 of the inputs, sha256 of the JAX engine's output)
    "resample 44100->48000": (
        "c2daad8b9bf8cd17616d60176a287ded72320e627eb3eb96499c5e2255ce0f38",
        "cbc87986258be4245b2bde1adee8be8997d0cec4bbf6e0ea5a38da4b763a20d2"),
    "resample 48000->44100": (
        "49e8415ab7c5fc832b41db836a344a0eab94eb66a83b78d86218099e49dd29f8",
        "f7295f4c0811c0f6d8ddca3bb47190a9c0099c5b2c95241e62788a3fc8325094"),
    "resample 44100->22050": (
        "c2daad8b9bf8cd17616d60176a287ded72320e627eb3eb96499c5e2255ce0f38",
        "860bf0ecbef9674fd5e4dac9a1e879a764c99b090e1d743bfbecacbb11a111a5"),
    "crossfade 8820": (
        "75f5b3f238defdedc824256bcfb64ba3618d86247663703ba33b5040358c6fdf",
        "9ed24a7680da199a9bb93a46cace4a9202df262fcaa79789bd098fd8b9b66cdb"),
    "compressor": (
        "fed789d2c18d3fff9e948bbcdbd420c2e5c664f842dbf37176ddb8d2327aae79",
        "d266c8a84fe5826a6f3b69261aeea8c569bf3c44ef4a7cb617e0bbe855c731ac"),
}
# The frontends phase's 30 s stereo file at 48 kHz (tones at 110 Hz and
# 2 kHz plus noise): the four stems of AudioSplitter must sum back to the
# input (relative L2 over the input's samples).
SPLIT_BOUND = 1e-3

# Each kernel's cases against its plain version: name, b, s_q, s_kv, h, d,
# dtype, logit scale on q and k. "path" cases are the main path's shapes;
# their worst errors go to the kernels line.
K1_CASES = (
    ("path d40", 2, 4096, 4096, 8, 40, "bf16", 1.0),
    ("path d80", 2, 1024, 1024, 8, 80, "bf16", 1.0),
    # the batched path's K1 sites: UNet batch 32 (buckets 8/16) at seq 1024,
    # batch 16 (bucket 8's d80 sites) and 8 (bucket 4) at seq 4096
    ("path batch-16 d80", 32, 1024, 1024, 8, 80, "bf16", 1.0),
    ("path batch-8 d80", 16, 1024, 1024, 8, 80, "bf16", 1.0),
    ("path batch-4 d40", 8, 4096, 4096, 8, 40, "bf16", 1.0),
    ("ragged d16", 1, 1000, 1000, 2, 16, "bf16", 1.0),
    ("ragged d32", 1, 1000, 1000, 2, 32, "bf16", 1.0),
    ("ragged d128 s_kv 777", 1, 1000, 777, 2, 128, "bf16", 1.0),
    ("large logits d40", 1, 1024, 1024, 2, 40, "bf16", 8.0),
    # tile edges of the bf16 body (attention_fwd.cuh, K2's too: 128 query
    # rows a block, 64-row K/V tiles), one K/V tile, d = 24 (pads to 32)
    ("tile edges d40 s_q 129 s_kv 191", 2, 129, 191, 2, 40, "bf16", 1.0),
    ("tile edges d40 s_q 65 s_kv 191", 2, 65, 191, 2, 40, "bf16", 1.0),
    ("one tile d40 s 64", 16, 64, 64, 8, 40, "bf16", 1.0),
    ("d24 s_q 300 s_kv 257", 3, 300, 257, 2, 24, "bf16", 1.0),
    ("fp32 slice d40", 2, 4096, 4096, 8, 40, "fp32", 1.0),
    ("fp32 ragged d128 s_kv 777", 1, 1000, 777, 2, 128, "fp32", 1.0),
    # the sharded step's sites: tp 2 (half the heads), seq 2 (half the queries)
    ("path tp d40", 4, 4096, 4096, 4, 40, "bf16", 1.0),
    ("path tp d80", 4, 1024, 1024, 4, 80, "bf16", 1.0),
    ("path seq d40", 4, 2048, 4096, 8, 40, "bf16", 1.0),
    ("path seq d80", 4, 512, 1024, 8, 80, "bf16", 1.0),
)
K2_CASES = (
    ("path batch-16 site", 32, 4096, 4096, 8, 40, "bf16", 1.0),
    ("b9 s2048 d40", 9, 2048, 2048, 8, 40, "bf16", 1.0),
    ("ragged d16", 10, 1000, 1000, 2, 16, "bf16", 1.0),
    ("large logits d40", 9, 1024, 1024, 2, 40, "bf16", 8.0),
    # tile edges of the bf16 body (128 query rows a block, 64-row K/V tiles)
    ("tile edges d40 s_q 129 s_kv 191", 2, 129, 191, 2, 40, "bf16", 1.0),
    # one K/V tile: its products follow its copies at once (a ring that does
    # not wait for them reads shared memory before they land)
    ("one tile d40 s 64", 16, 64, 64, 8, 40, "bf16", 1.0),
    # d = 24 pads to 32 for both products; the output's pad is not written
    ("d24 s_q 300 s_kv 257", 3, 300, 257, 2, 24, "bf16", 1.0),
    ("fp32 d16", 10, 2048, 2048, 2, 16, "fp32", 1.0),
)

K1_GRAD_CASES = (
    ("path d40", 4, 4096, 4096, 8, 40, "bf16", 1.0),
    ("path d80", 4, 1024, 1024, 8, 80, "bf16", 1.0),
    ("ragged d128 s_kv 777", 1, 1000, 777, 2, 128, "bf16", 1.0),
    ("ragged d16 s_q 333", 2, 333, 1000, 2, 16, "bf16", 1.0),
    ("large logits d40", 1, 1024, 1024, 2, 40, "bf16", 4.0),
    # tile edges of the bf16 kernels (128 owned rows, 64-row streamed tiles)
    ("tile edges d40 s_q 129 s_kv 191", 2, 129, 191, 2, 40, "bf16", 1.0),
    # one streamed tile: its products follow its copies at once (a ring that
    # does not wait for them reads shared memory before they land)
    ("one tile d40 s 64", 16, 64, 64, 8, 40, "bf16", 1.0),
    ("fp32 d32", 2, 300, 300, 3, 32, "fp32", 1.0),
    ("fp32 ragged d128 s_kv 777", 1, 1000, 777, 2, 128, "fp32", 1.0),
) + tuple((f"path {'tp' if h == 4 else 'seq'} d{d}", b, s_q, s_kv, h, d, "bf16", 1.0)
          for b, s_q, s_kv, h, d in SHARDED_TRAIN_SHAPES)

# --mutants: faults planted in a copy of the kernel sources: (what, file,
# text, replacement, the kernels whose checks must reject it). The text
# occurs once in its file (tests/test_torch_kernel_sources.py holds it so).
# Each named kernel must reject the fault by its own checks: a forward
# kernel's bf16 cases (K1 and K2 share attention_fwd.cuh's body), or a
# backward kernel's bf16 gradient cases (attention_bwd.cuh, fed by K1's
# log-sum-exp). hopper.cuh's tile copies serve every bf16 kernel.
BACKWARD = ("attention_dkv", "attention_dq")
FORWARD = ("attention", "row_attention")
MUTANTS = (
    ("dS without its -delta term", "attention_bwd.cuh",
     "  return prob * (dp - delta);", "  return prob * dp;", BACKWARD),
    ("the LSE of the next head", "attention_bwd.cuh",
     "  return p.lse + ((long long)blockIdx.z * gridDim.y + blockIdx.y) * p.s_q;",
     "  return p.lse + ((long long)blockIdx.z * gridDim.y + (blockIdx.y + 1) % gridDim.y) *\n"
     "                     p.s_q;", BACKWARD),
    # d = 40 pads to 48: the pad chunk copied (the next head's first 8
    # columns, except at the last head, whose next columns are another row's)
    ("the d-pad chunk copied from global memory instead of zero-filled", "hopper.cuh",
     "col[k] = c * 8 < head_dim ? c * 8 : -1;",
     "col[k] = c * 8 < head_dim || blockIdx.y + 1 < gridDim.y ? c * 8 : -1;",
     FORWARD + BACKWARD),
    ("the transpose bit of the MN-major B dropped in dV += P^T dO", "attention_bwd.cuh",
     "Wgmma<DN>::template rs<kMnMajor>(&acc1[0][0], pa,  // dV += P^T dO",
     "Wgmma<DN>::template rs<0>(&acc1[0][0], pa,  // dV += P^T dO", ("attention_dkv",)),
    ("the ring waiting one stage short (a tile read before its copy lands)", "attention_bwd.cuh",
     "cp_async_wait<kBwdAhead - 1>();", "cp_async_wait<kBwdAhead>();", BACKWARD),
    # the forward body: each fault below is one both forward kernels' bf16
    # cases must reject (the first five were planted when K2 alone ran it)
    ("K2: the transpose bit of V dropped in O += P V", "attention_fwd.cuh",
     "Wgmma<DN>::template rs<kMnMajor>(&acc[0][0], pa[kk],",
     "Wgmma<DN>::template rs<0>(&acc[0][0], pa[kk],", FORWARD),
    ("K2: the ring waiting one stage short (a tile read before its copy lands)",
     "attention_fwd.cuh", "cp_async_wait<kFwdAhead - 1>();", "cp_async_wait<kFwdAhead>();",
     FORWARD),
    # d = 40 pads to 48 and d = 24 to 32: Q's and K's pad chunks copied (the
    # next head's first columns, except at the last head)
    ("K2: the d-pad chunks of Q and K copied instead of zero-filled", "attention_fwd.cuh",
     "  const TileCopies<DP, kFwdTileN, kThreads> kv_copies(p.head_dim);\n"
     "  const TileCopies<DP, kRows, kThreads> q_copies(p.head_dim);\n",
     "  const int copied = p.head_dim + (blockIdx.y + 1 < gridDim.y ? 8 : 0);\n"
     "  const TileCopies<DP, kFwdTileN, kThreads> kv_copies(copied);\n"
     "  const TileCopies<DP, kRows, kThreads> q_copies(copied);\n", FORWARD),
    ("K2: O not rescaled when the running max moves", "attention_fwd.cuh",
     "for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];",
     "for (int e = 0; e < 4; ++e) (void)alpha[e >> 1];", FORWARD),
    ("K2: the ragged K/V tail unmasked (the zero-filled keys get logit 0)", "attention_fwd.cuh",
     "if (n0 + j * 8 + t * 2 + (e & 1) >= p.s_kv) s[j][e] = -INFINITY;",
     "(void)n0;", FORWARD),
    ("the second warpgroup's S taken from the first warpgroup's Q rows", "attention_fwd.cuh",
     "smem_desc(s_q + group * 64 * 8, kRows * 16, 128)", "smem_desc(s_q, kRows * 16, 128)",
     FORWARD),
    # each row's sum is over half its columns: the output and K1's LSE wrong
    ("the row sums left partial (one of two cross-thread reductions dropped)",
     "attention_fwd.cuh", "    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);\n",
     "    row_sum[r] += 0.f;\n", FORWARD + BACKWARD),
    # the log-sum-exp K1 writes for the backward kernels: wrong values reach
    # them only through the probabilities they recompute
    ("the forward's LSE in log2 units", "attention_fwd.cuh",
     "lse[row + 8 * r] = fmaf(row_max[r], p.scale, logf(row_sum[r]));",
     "lse[row + 8 * r] = fmaf(row_max[r], p.scale_log2, log2f(row_sum[r]));", BACKWARD),
    ("the forward's LSE written to the next head's rows", "attention_fwd.cuh",
     "float* lse = p.lse + ((long long)batch * gridDim.y + blockIdx.y) * p.s_q;",
     "float* lse = p.lse + ((long long)batch * gridDim.y + (blockIdx.y + 1) % gridDim.y) *\n"
     "                   p.s_q;", BACKWARD),
    ("the forward's LSE of a thread's two rows swapped", "attention_fwd.cuh",
     "lse[row + 8 * r] = fmaf(row_max[r], p.scale, logf(row_sum[r]));",
     "lse[row + 8 * r] = fmaf(row_max[1 - r], p.scale, logf(row_sum[1 - r]));", BACKWARD),
)
FORWARD_CASES = {"attention": K1_CASES, "row_attention": K2_CASES}


def log(msg: str) -> None:
    print(msg, flush=True)


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_card(torch) -> tuple:
    """The card's name and power limit, and its maximum SM clock in Hz (the
    clock of the SFU bound)."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this check runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    clock_hz = float(_smi("clocks.max.sm")) * 1e6
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; devices {torch.cuda.device_count()}; maximum SM clock "
        f"{clock_hz / 1e6:.0f} MHz (the exp2 bound's: {SMS * EXP2_PER_SM_CLOCK * clock_hz:.3e} "
        "per second)")
    log(smi)
    return smi, clock_hz


def phase_build(attn) -> None:
    start = time.perf_counter()
    built = attn.build_kernels(rebuild=True)
    log(f"[build] {len(built)} sources in {time.perf_counter() - start:.1f} s (one nvcc each, "
        "in parallel)")
    for name, kernel in built.items():
        log(f"[build] nvcc built {kernel.path.name} in {kernel.build_seconds:.1f} s")
        for instance, registers, spills in attn.ptxas_instances(kernel.compiler_log):
            log(f"[build]   {instance}: {registers}; {spills}")
            # the paths run the bf16 instances; the fp32 check instances keep
            # a row of q and of the output in registers and spill at d = 128
            if "bf16" in instance and re.search(r"[1-9]\d* bytes spill", spills):
                raise AssertionError(f"{instance} spills: {spills}")


def _time_ms(torch, fn, reps: int = 20) -> float:
    """Median of `reps` single-call times on the card (CUDA events)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _check_cases(torch, attn, fn, cases, gen) -> dict:
    """Run `fn` (a kernel wrapper) against the plain version on each case;
    returns the worst (max abs, rel RMS) over the bf16 cases at the path's
    shapes (names starting with "path")."""
    dev = torch.device("cuda")
    worst = [0.0, 0.0]
    for name, b, s_q, s_kv, h, d, dtype_name, mult in cases:
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
        q = (mult * torch.randn(b, s_q, h * d, generator=gen, device=dev)).to(dtype)
        k = (mult * torch.randn(b, s_kv, h * d, generator=gen, device=dev)).to(dtype)
        v = (2 * torch.rand(b, s_kv, h * d, generator=gen, device=dev) - 1).to(dtype)
        out = fn(q, k, v, num_heads=h, scale=d**-0.5)
        torch.cuda.synchronize()
        ref = attn.attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
        err, rel_rms, ok = attn.compare_to_plain(out, ref)
        log(f"[kernel] {fn.__name__} {name}: (b={b}, s_q={s_q}, s_kv={s_kv}, h={h}, d={d}, "
            f"{dtype}) max_abs_err {err:.3e}, rel_rms_err {rel_rms:.3e} "
            f"(tol {attn.TOLERANCE[dtype]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{fn.__name__} disagrees with its plain version: {name}")
        if name.startswith("path"):
            worst = [max(worst[0], err), max(worst[1], rel_rms)]
        del q, k, v, out, ref
    return {"max_abs_err": worst[0], "rel_rms_err": worst[1]}


def _bound(flop: float, nbytes: float, exps: float, clock_hz: float) -> tuple:
    """(least time in ms the card could take, what bounds it: "bytes" or
    "operations", and which: "bytes", "tensor FLOPs" or "exp2")."""
    times = {"tensor FLOPs": flop / PEAK_BF16_FLOPS * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3,
             "exp2": exps / (SMS * EXP2_PER_SM_CLOCK * clock_hz) * 1e3}
    which = max(times, key=times.get)
    return times[which], "bytes" if which == "bytes" else "operations", which


def _sm_clock_note() -> str:
    """The SM clock right after a timed run (the card holds it for a while)."""
    return f"SM clock just after: {_smi('clocks.sm')} MHz"


def _heads_first(torch, x, h):
    """(b, s, h*d) -> a contiguous (b, h, s, d) copy, the library's layout."""
    b, s, inner = x.shape
    return x.view(b, s, h, inner // h).transpose(1, 2).contiguous()


def phase_kernel(torch, attn, clock_hz: float) -> dict:
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"attention": _check_cases(torch, attn, attn.attention, K1_CASES, gen),
              "row_attention": _check_cases(torch, attn, attn.row_attention, K2_CASES, gen)}

    times = {}
    for b, s, h, d in SLICE_SHAPES + (K1_BATCH_SHAPE, BATCH_SHAPE):
        q, k, v = (torch.randn(b, s, h * d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        kernel = "row_attention" if (b, s, h, d) == BATCH_SHAPE else "attention"
        fns = {kernel: getattr(attn, kernel), "plain": attn.attention_reference}
        flop = 4 * b * h * s * s * d
        for name, fn in fns.items():
            ms = _time_ms(torch, lambda: fn(q, k, v, num_heads=h, scale=d**-0.5))
            times[(name, b, s, d)] = ms
            log(f"[kernel] time (b={b}, s={s}, h={h}, d={d}, bf16): {name} {ms:.4f} ms "
                f"({flop / ms / 1e9:.1f} TFLOP/s)")
        qh, kh, vh = (_heads_first(torch, x, h) for x in (q, k, v))
        ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=d**-0.5))
        times[("library", b, s, d)] = ms
        bound = times[("bound", b, s, d)] = _bound(flop, 4 * b * s * h * d * 2, b * h * s * s,
                                                   clock_hz)
        log(f"[kernel] time (b={b}, s={s}, h={h}, d={d}, bf16): library "
            f"scaled_dot_product_attention {ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[2]}); "
            f"{_sm_clock_note()}")
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    result["times"] = times
    return result


def _grad_case(torch, dev, gen, b, s_q, s_kv, h, d, dtype, mult):
    """q, k ~ N(0, 1) (times `mult`), v ~ N(1, 1) (a mean away from 0, so that
    delta is not small next to dP), dO ~ N(0, 1)."""
    q = (mult * torch.randn(b, s_q, h * d, generator=gen, device=dev)).to(dtype)
    k = (mult * torch.randn(b, s_kv, h * d, generator=gen, device=dev)).to(dtype)
    v = (torch.randn(b, s_kv, h * d, generator=gen, device=dev) + 1).to(dtype)
    dout = torch.randn(b, s_q, h * d, generator=gen, device=dev).to(dtype)
    return q, k, v, dout


def _check_grad_cases(torch, attn, cases, gen) -> dict:
    """`attention`'s gradient (K1 with LSE, then the dK/dV and dQ kernels)
    against the plain backward on each case, and at the path's shapes the
    forward with LSE against the plain forward (TOLERANCE, whose max-abs
    bound is set for outputs of magnitude 1 or less, as phase 3's v in
    [-1, 1] gives them: here v ~ N(1, 1), whose outputs reach 5, where one
    bf16 rounding is 3.1e-2 at large logits; the path's outputs stay under
    2). Returns, per kernel, the worst (max abs, rel RMS) over the bf16
    path cases and the cases its outputs (the forward's, dK and dV, or dQ)
    failed."""
    dev = torch.device("cuda")
    result = {name: {"max_abs_err": 0.0, "rel_rms_err": 0.0, "failed": []}
              for name in ("attention", "attention_dkv", "attention_dq")}
    owner = {"dk": "attention_dkv", "dv": "attention_dkv", "dq": "attention_dq",
             "out": "attention"}
    for name, b, s_q, s_kv, h, d, dtype_name, mult in cases:
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
        q, k, v, dout = _grad_case(torch, dev, gen, b, s_q, s_kv, h, d, dtype, mult)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        attn.COUNTS.reset()
        out = attn.attention(*leaves, num_heads=h, scale=d**-0.5)
        out.backward(dout)
        torch.cuda.synchronize()
        counts = (attn.COUNTS.launches, attn.COUNTS.bwd_dkv_launches,
                  attn.COUNTS.bwd_dq_launches, attn.COUNTS.plain_calls)
        if counts != (1, 1, 1, 0):
            raise AssertionError(f"{name}: (K1, dK/dV, dQ, plain) launches {counts}")
        refs = attn.attention_backward_reference(q, k, v, out.detach(), dout, num_heads=h,
                                                 scale=d**-0.5)
        checks = attn.compare_grads_to_plain([x.grad for x in leaves], refs)
        if name.startswith("path"):
            checks["out"] = attn.compare_to_plain(
                out.detach(), attn.attention_reference(q, k, v, num_heads=h, scale=d**-0.5))
        log(f"[kernel-grad] {name}: (b={b}, s_q={s_q}, s_kv={s_kv}, h={h}, d={d}, {dtype}) "
            + ", ".join(f"{g} max_abs_err {e:.3e} rel_rms_err {r:.3e} {'ok' if ok else 'FAIL'}"
                        for g, (e, r, ok) in checks.items())
            + f" (tol {attn.GRAD_TOLERANCE[dtype]}; out {attn.TOLERANCE[dtype]})")
        for g, (err, rel, ok) in checks.items():
            entry = result[owner[g]]
            if not ok and name not in entry["failed"]:
                entry["failed"].append(name)
            if name.startswith("path"):
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                entry["rel_rms_err"] = max(entry["rel_rms_err"], rel)
        del q, k, v, dout, leaves, out, refs
    return result


def phase_kernel_grad(torch, attn, clock_hz: float) -> dict:
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    result = _check_grad_cases(torch, attn, K1_GRAD_CASES, gen)
    failed = {k: v["failed"] for k, v in result.items() if v["failed"]}
    if failed:
        raise AssertionError(f"K1 with LSE or its backward kernels disagree with the plain "
                             f"versions: {failed}")

    times = {}
    shapes = tuple((b, s, s, h, d) for b, s, h, d in TRAIN_SHAPES) + SHARDED_TRAIN_SHAPES
    for b, s_q, s_kv, h, d in shapes:
        scale = d**-0.5
        q, _, _, dout = _grad_case(torch, dev, gen, b, s_q, s_q, h, d, torch.bfloat16, 1.0)
        _, k, v, _ = _grad_case(torch, dev, gen, b, s_kv, s_kv, h, d, torch.bfloat16, 1.0)
        lse = torch.empty(b, h, s_q, device=dev)
        out = attn._launch("attention", q, k, v, h, scale, lse=lse)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float().view(b, s_q, h, d),
                              k.float().view(b, s_kv, h, d)) * scale
        lse_err = float((lse - torch.logsumexp(logits, dim=-1)).abs().max())
        del logits
        shape = f"(b={b}, s_q={s_q}, s_kv={s_kv}, h={h}, d={d})"
        log(f"[kernel-grad] forward LSE {shape}: max abs error {lse_err:.3e} against logsumexp "
            "of the fp32 logits (tol 1e-3)")
        if not lse_err <= 1e-3:
            raise AssertionError("the forward's log-sum-exp is wrong")
        delta = attn.backward_delta(out, dout, h)
        one_q, one_kv = (b * n * h * d * 2 for n in (s_q, s_kv))  # bytes of a bf16 operand
        stats = b * h * s_q * 4  # bytes of one (b, h, s_q) fp32 row statistic
        qh, kh, vh, doh = (_heads_first(torch, x, h).requires_grad_() for x in (q, k, v, dout))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        products = b * h * s_q * s_kv * d  # one product's multiply-adds
        fns = {
            "forward with LSE": (lambda: attn._launch("attention", q, k, v, h, scale, lse=lse),
                                 4 * products, 2 * one_q + 2 * one_kv + stats),
            "plain forward": (lambda: attn.attention_reference(q, k, v, num_heads=h, scale=scale),
                              4 * products, 2 * one_q + 2 * one_kv),
            "library forward": (lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
                                4 * products, 2 * one_q + 2 * one_kv),
            "attention_dkv": (lambda: attn._launch_backward("attention_dkv", q, k, v, dout, lse,
                                                            delta, h, scale),
                              8 * products, 2 * one_q + 4 * one_kv + 2 * stats),
            "attention_dq": (lambda: attn._launch_backward("attention_dq", q, k, v, dout, lse,
                                                           delta, h, scale),
                             6 * products, 3 * one_q + 2 * one_kv + 2 * stats),
            "plain backward": (lambda: attn.attention_backward_reference(
                q, k, v, out, dout, num_heads=h, scale=scale), 10 * products,
                4 * one_q + 4 * one_kv),
            "library backward": (lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                             retain_graph=True),
                                 10 * products, 4 * one_q + 4 * one_kv),
        }
        for name, (fn, flop, nbytes) in fns.items():
            ms = _time_ms(torch, fn)
            # every one of these recomputes or forms P: one exp2 per logit
            bound = _bound(flop, nbytes, b * h * s_q * s_kv, clock_hz)
            times[(name, b, s_q, s_kv, h, d)] = ms
            times[("bound " + name, b, s_q, s_kv, h, d)] = bound
            log(f"[kernel-grad] time {shape}, bf16: {name} {ms:.4f} ms "
                f"({flop / ms / 1e9:.1f} TFLOP/s); bound {bound[0]:.4f} ms ({bound[2]}); "
                f"{_sm_clock_note()}")
        del fns, q, k, v, dout, lse, out, delta, qh, kh, vh, doh, lib_out
        torch.cuda.empty_cache()
    result["times"] = times

    # K2's backward is the plain recompute: against autograd of the plain version
    b, s, h, d = 9, 2048, 8, 40
    q, k, v, dout = _grad_case(torch, dev, gen, b, s, s, h, d, torch.bfloat16, 1.0)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    attn.COUNTS.reset()
    attn.row_attention(*leaves, num_heads=h, scale=d**-0.5).backward(dout)
    rows = (attn.COUNTS.row_launches, attn.COUNTS.bwd_dkv_launches, attn.COUNTS.plain_calls)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    attn.attention_reference(*plain, num_heads=h, scale=d**-0.5).backward(dout)
    checks = attn.compare_grads_to_plain([x.grad for x in leaves], [x.grad for x in plain])
    log(f"[kernel-grad] row_attention backward (b={b}, s={s}, h={h}, d={d}, bf16) against "
        "autograd of the plain version: "
        + ", ".join(f"{g} max_abs_err {e:.3e}" for g, (e, _, _) in checks.items())
        + f"; (K2, dK/dV, plain) launches {rows}")
    if rows != (1, 0, 0) or not all(ok for _, _, ok in checks.values()):
        raise AssertionError("row_attention's backward is not the plain recompute")
    return result


def phase_mutants(torch, attn) -> None:
    """Build each MUTANTS copy of the kernel sources (in csrc/build/, which
    git ignores) and show that every kernel its fault touches rejects it:
    a forward kernel's bf16 cases, or the bf16 gradient cases of the
    backward kernels it names. The real sources are loaded again at the end."""
    original = dict(attn.KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    passed = []
    try:
        for i, (what, file, old, new, kernels) in enumerate(MUTANTS):
            src = attn.BUILD_DIR / "mutants" / str(i)
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(attn._CSRC, src, ignore=shutil.ignore_patterns("build"))
            header = src / file
            text = header.read_text()
            if text.count(old) != 1:
                raise AssertionError(f"mutant {what!r}: its text is not in {file} once")
            header.write_text(text.replace(old, new))
            attn.KERNELS.update({n: (src / path.name, entry) for n, (path, entry) in original.items()})
            attn._built.clear()
            attn.build_kernels()
            for name in (n for n in kernels if n in FORWARD_CASES):
                cases = [c for c in FORWARD_CASES[name] if c[6] == "bf16"]
                try:
                    _check_cases(torch, attn, getattr(attn, name), cases, gen)
                    passed.append(f"{what} ({name})")
                    log(f"[mutants] {what}: {name} PASSED the check")
                except AssertionError as e:
                    log(f"[mutants] {what}: {name} rejected ({e})")
            if set(kernels) & set(BACKWARD):
                result = _check_grad_cases(
                    torch, attn, [c for c in K1_GRAD_CASES if c[6] == "bf16"], gen)
                for name in (n for n in kernels if n in BACKWARD):
                    if result[name]["failed"]:
                        log(f"[mutants] {what}: {name} rejected (cases {result[name]['failed']})")
                    else:
                        passed.append(f"{what} ({name})")
                        log(f"[mutants] {what}: {name} PASSED the check")
    finally:
        attn.KERNELS.update(original)
        attn._built.clear()
    attn.build_kernels()
    if passed:
        raise AssertionError(f"the kernel checks let mutants through: {passed}")


def phase_dsp(torch) -> None:
    import numpy as np

    from riffusion_tpu_torch.audio.segment import AudioSegment
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.spectrogram_converter import SpectrogramConverter

    sr = 44100
    t = np.arange(int(5.11 * sr)) / sr
    tone = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t)).astype(
        np.float32
    )
    conv = SpectrogramConverter(SpectrogramParams(), device="cuda")
    start = time.perf_counter()
    mel = conv.spectrogram_from_audio(AudioSegment.from_float(tone[None] * 32767, sr))
    audio = conv.audio_from_spectrogram(mel, apply_filters=False)
    seconds = time.perf_counter() - start
    x = audio.raw_data[:, 0].astype(np.float64)
    spec = np.abs(np.fft.rfft(x))
    freqs = np.fft.rfftfreq(x.size, 1 / sr)
    ratio = spec[(freqs > 212) & (freqs < 228)].max() / np.median(spec)
    log(f"[dsp] 220 Hz tone at {ratio:.0f}x the noise floor after mel + 32 Griffin-Lim "
        f"iterations on the card ({seconds:.2f} s incl. first-call setup)")
    if not ratio > 1000:
        raise AssertionError(f"DSP reconstruction on the card is broken (tone/noise {ratio:.1f})")


def phase_tiny(torch, attn) -> None:
    import numpy as np
    from PIL import Image

    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.riffusion_pipeline import FixedNoise, RiffusionPipeline

    size = 256
    rng = np.random.default_rng(0)
    image = Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8), mode="RGB")
    params = SpectrogramParams(num_frequencies=size)
    cpu_bundle = random_bundle("tiny", seed=0, device="cpu", dtype=torch.float32)
    gpu_pipe = RiffusionPipeline(copy.deepcopy(cpu_bundle), device="cuda")
    cpu_pipe = RiffusionPipeline(cpu_bundle, device="cpu")
    n_active = cpu_pipe.converter(params).n_active
    latent = (1, 4, size // 8, size // 8)
    draws = {
        "vae_eps": rng.standard_normal(latent),
        "noise_a": rng.standard_normal(latent),
        "noise_b": rng.standard_normal(latent),
        "gl_real": rng.random((1, n_active, size)),
        "gl_imag": rng.random((1, n_active, size)),
    }
    noise = FixedNoise(draws)
    inputs = InferenceInput(start=PromptInput(prompt="church bells", seed=1),
                            end=PromptInput(prompt="techno", seed=2), alpha=0.5,
                            num_inference_steps=10)
    attn.COUNTS.reset()
    img_g, audio_g = gpu_pipe.riffuse_audio(inputs, image, params=params, noise=noise)
    torch.cuda.synchronize()
    launches, rows, plain = attn.COUNTS.launches, attn.COUNTS.row_launches, attn.COUNTS.plain_calls
    img_c, audio_c = cpu_pipe.riffuse_audio(inputs, image, params=params, noise=noise)
    equal, max_diff = _image_agreement(img_g, img_c)
    wg, wc = audio_g.raw_data.astype(np.float64), audio_c.raw_data.astype(np.float64)
    wave_err = float(np.linalg.norm(wg - wc) / np.linalg.norm(wc))
    log(f"[tiny] {size}px, cuda fp32 vs cpu fp32: pixels equal {equal:.4%}, max diff "
        f"{max_diff}; waveform rel L2 {wave_err:.3e}; K1 launches {launches}, K2 launches "
        f"{rows}, plain calls {plain}")
    if launches == 0 or rows != 0 or plain != 0:
        raise AssertionError("the tiny run on the card did not go through K1 alone")
    if max_diff > 1 or equal < 0.99 or not wave_err < 0.35:
        raise AssertionError("the card's tiny run disagrees with the CPU run")

    def both(what: str, fn) -> None:
        attn.COUNTS.reset()
        img_g = fn(gpu_pipe)
        torch.cuda.synchronize()
        counts = (attn.COUNTS.launches, attn.COUNTS.row_launches, attn.COUNTS.plain_calls)
        equal, max_diff = _image_agreement(img_g, fn(cpu_pipe))
        log(f"[tiny] {what}, cuda fp32 vs cpu fp32: pixels equal {equal:.4%}, max diff "
            f"{max_diff}; (K1, K2, plain) launches {counts}")
        if counts[0] == 0 or counts[1:] != (0, 0):
            raise AssertionError(f"tiny {what} on the card did not go through K1 alone")
        if max_diff > 1 or equal < 0.99:
            raise AssertionError(f"the card's tiny {what} disagrees with the CPU's")

    def with_ancestral(draws: dict, steps: int) -> dict:
        return {**draws, "ancestral": rng.standard_normal((steps,) + latent)}

    # guidance 1.75 for the other samplers (phase 7's docstring)
    low = InferenceInput(start=PromptInput(prompt="church bells", seed=1, guidance=1.75),
                         end=PromptInput(prompt="techno", seed=2, guidance=1.75), alpha=0.5,
                         num_inference_steps=10)
    for name in SAMPLERS:
        steps = cpu_pipe._plan(name, 10, 0.75)[0].num_steps
        nz = FixedNoise(with_ancestral(draws, steps) if name == "euler_a" else draws)
        both(f"riffuse_audio {name}-10",
             lambda p: p.riffuse_audio(low, image, params=params, scheduler=name, noise=nz)[0])
    t2i = FixedNoise(with_ancestral({"latents": rng.standard_normal(latent)}, 10))
    both("txt2img euler_a-10", lambda p: p.txt2img(
        "church bells", negative_prompt="noise", num_inference_steps=10, guidance=1.75,
        width=size, height=size, scheduler="euler_a", noise=t2i))
    both("img2img lms-10", lambda p: p.img2img(
        "techno", image, denoising_strength=0.6, num_inference_steps=10, guidance=1.75,
        scheduler="lms", noise=noise))
    mix = FixedNoise({"vae_eps": draws["vae_eps"], "noise": rng.standard_normal(latent)})
    for name in ("pndm", "euler"):
        both(f"img2img_magic_mix {name}-10", lambda p: p.img2img_magic_mix(
            "techno", image, num_inference_steps=10, guidance_scale=1.75, kmin=0.3, kmax=0.7,
            scheduler=name, noise=mix))


def _image_agreement(a_img, b_img):
    """(share of equal pixels, max difference in uint8 levels)."""
    import numpy as np

    a, b = np.asarray(a_img, np.int16), np.asarray(b_img, np.int16)
    return float((a == b).mean()), int(np.abs(a - b).max())


def phase_tiny_batch(torch, attn) -> None:
    """5 requests in one batch on the card and on the CPU. Guidance 1.5-1.9:
    the random tiny UNet amplifies float32 rounding from step to step, and
    guidance multiplies it by up to 1 + 2g (tests/test_torch_pipeline.py)."""
    import numpy as np
    from PIL import Image

    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.riffusion_pipeline import FixedNoise, RiffusionPipeline

    size, n = 512, 5
    rng = np.random.default_rng(1)
    image = Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8), mode="RGB")
    params = SpectrogramParams(num_frequencies=size)
    cpu_bundle = random_bundle("tiny", seed=0, device="cpu", dtype=torch.float32)
    gpu_pipe = RiffusionPipeline(copy.deepcopy(cpu_bundle), device="cuda")
    cpu_pipe = RiffusionPipeline(cpu_bundle, device="cpu")
    n_active = cpu_pipe.converter(params).n_active
    latent = (1, 4, size // 8, size // 8)
    draws = [{
        "vae_eps": rng.standard_normal(latent),
        "noise_a": rng.standard_normal(latent),
        "noise_b": rng.standard_normal(latent),
        "gl_real": rng.random((1, n_active, size)),
        "gl_imag": rng.random((1, n_active, size)),
    } for _ in range(n)]
    noises = [FixedNoise(d) for d in draws]
    inputs_list = [
        InferenceInput(start=PromptInput(prompt=f"church bells {i}", seed=i, guidance=1.5 + 0.1 * i),
                       end=PromptInput(prompt="techno", seed=10 + i, guidance=1.5),
                       alpha=0.2 * i, num_inference_steps=10)
        for i in range(n)
    ]
    for scheduler in ("unipc_k:rho=2",) + SAMPLERS:
        if scheduler == "euler_a":
            steps = cpu_pipe._plan(scheduler, 10, 0.75)[0].num_steps
            noises = [FixedNoise({**d, "ancestral": rng.standard_normal((steps,) + latent)})
                      for d in draws]
        attn.COUNTS.reset()
        out_g = gpu_pipe.riffuse_audio_batch(inputs_list, image, params=params, noises=noises,
                                             scheduler=scheduler)
        torch.cuda.synchronize()
        launches, rows = attn.COUNTS.launches, attn.COUNTS.row_launches
        plain = attn.COUNTS.plain_calls
        out_c = cpu_pipe.riffuse_audio_batch(inputs_list, image, params=params, noises=noises,
                                             scheduler=scheduler)
        agreement = [_image_agreement(g[0], c[0]) for g, c in zip(out_g, out_c)]
        log(f"[tiny batch] {n} requests at {size}px ({scheduler}, UNet batch {2 * n}), cuda "
            f"fp32 vs cpu fp32, (pixels equal, max diff) per request: "
            f"{[(f'{e:.4%}', m) for e, m in agreement]}; K1 launches {launches}, K2 launches "
            f"{rows}, plain calls {plain}")
        if rows == 0 or launches == 0 or plain != 0:
            raise AssertionError(f"the tiny batch ({scheduler}) on the card did not go through "
                                 "both kernels")
        if any(m > 1 or e < 0.99 for e, m in agreement):
            raise AssertionError(f"the card's tiny batch ({scheduler}) disagrees with the CPU's")

    # txt2img_audio_batch of 5 prompts (UNet batch 10), fused through the audio
    t2i = [FixedNoise({"latents": rng.standard_normal(latent), "gl_real": d["gl_real"],
                       "gl_imag": d["gl_imag"]}) for d in draws]
    kw = dict(negative_prompts=["noise"] * n, seeds=list(range(n)), num_inference_steps=10,
              guidances=[1.5 + 0.1 * i for i in range(n)], width=size, height=size,
              scheduler="pndm", params=params, apply_filters=False, noises=t2i)
    prompts = [f"church bells {i}" for i in range(n)]
    attn.COUNTS.reset()
    out_g = gpu_pipe.txt2img_audio_batch(prompts, **kw)
    torch.cuda.synchronize()
    launches, rows, plain = attn.COUNTS.launches, attn.COUNTS.row_launches, attn.COUNTS.plain_calls
    out_c = cpu_pipe.txt2img_audio_batch(prompts, **kw)
    agreement = [_image_agreement(g[0], c[0]) for g, c in zip(out_g, out_c)]
    log(f"[tiny batch] txt2img_audio_batch of {n} prompts at {size}px (pndm-10, UNet batch "
        f"{2 * n}), cuda fp32 vs cpu fp32, (pixels equal, max diff) per prompt: "
        f"{[(f'{e:.4%}', m) for e, m in agreement]}; K1 launches {launches}, K2 launches "
        f"{rows}, plain calls {plain}")
    if rows == 0 or plain != 0:
        raise AssertionError("the tiny txt2img batch on the card did not go through K2")
    if any(m > 1 or e < 0.99 for e, m in agreement):
        raise AssertionError("the card's tiny txt2img batch disagrees with the CPU's")
    if any(a is None or a.raw_data.shape != b.raw_data.shape for (_, a), (_, b) in
           zip(out_g, out_c)):
        raise AssertionError("the card's tiny txt2img batch lost its audio")


# ------------------------------------------------------------- the checkpoint


def _diffusers_key(kind: str, key: str, old_vae_names: bool = False) -> str:
    """The inverse of the loader's renames (models/weights.py): a port
    state-dict key -> its key in a diffusers checkpoint."""
    if kind == "unet":
        k = re.sub(r"(down_blocks|up_blocks|attentions|resnets|downsamplers|upsamplers)_(\d+)",
                   r"\1.\2", key)
        k = re.sub(r"(^|\.)blocks_(\d+)", r"\1transformer_blocks.\2", k)
        return (k.replace(".to_out.", ".to_out.0.").replace("ff.proj_in", "ff.net.0.proj")
                .replace("ff.proj_out", "ff.net.2"))
    if kind == "vae":
        k = re.sub(r"(down_blocks|up_blocks)_(\d+)_(resnets|downsamplers|upsamplers)_(\d+)",
                   r"\1.\2.\3.\4", key)
        k = re.sub(r"(resnets|attentions)_(\d+)", r"\1.\2", k)
        k = re.sub(r"^(?:encoder\.(quant_conv)|decoder\.(post_quant_conv))",
                   lambda m: m.group(1) or m.group(2), k)
        if old_vae_names:  # the diffusers <= 0.9 names
            for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                             ("to_out", "proj_attn")):
                k = k.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
            return k
        return k.replace(".to_out.", ".to_out.0.")
    k = re.sub(r"^layers_(\d+)\.", r"encoder.layers.\1.", key)
    k = re.sub(r"\.(fc\d)\.", r".mlp.\1.", k)
    return "text_model." + re.sub(r"^(token|position)_embedding", r"embeddings.\1_embedding", k)


def _check_renames(torch, weights, states: dict) -> int:
    """Every port key -> its diffusers key -> back through the loader's
    renames: the same key and shape (meta tensors). Returns the keys checked."""
    checked = 0
    for kind, state in states.items():
        for old in (False, True) if kind == "vae" else (False,):
            names = {_diffusers_key(kind, k, old): k for k in state}
            if len(names) != len(state):
                raise AssertionError(f"{kind}: the inverse renames are not one-to-one")
            meta = {d: torch.empty(state[k].shape, device="meta") for d, k in names.items()}
            back, _ = weights.convert_diffusers_state_dict(meta, kind)
            bad = sorted(set(back) ^ set(state)) + [
                k for k in state if k in back and tuple(back[k].shape) != tuple(state[k].shape)]
            if bad:
                raise AssertionError(f"{kind}: the renames do not round-trip: {bad[:5]}")
            checked += len(state)
    return checked


def _write_safetensors(torch, path: Path, tensors: dict) -> None:
    """The safetensors layout: an 8-byte little-endian header length, the
    JSON header (padded to 8 bytes), the raw bytes in header order."""
    names = {torch.float32: "F32", torch.int64: "I64"}
    header, offset = {}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            fh.write(t.detach().contiguous().cpu().numpy().data)


def _write_checkpoint(torch, weights, root: Path) -> int:
    """random:full's fp32 weights as a diffusers-layout directory; returns
    the keys whose renames were checked."""
    bundle = weights.random_bundle("full", seed=0, device="cuda", dtype=torch.float32)
    states = {"unet": bundle.unet.state_dict(), "vae": bundle.vae.state_dict(),
              "clip": bundle.text_encoder.state_dict()}
    checked = _check_renames(torch, weights, states)
    configs = {
        "unet": {"_class_name": "UNet2DConditionModel", "sample_size": 64, "in_channels": 4,
                 "out_channels": 4, "block_out_channels": [320, 640, 1280, 1280],
                 "layers_per_block": 2, "cross_attention_dim": 768, "attention_head_dim": 8,
                 "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
                 "norm_num_groups": 32, "freq_shift": 0, "flip_sin_to_cos": True},
        "vae": {"_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3,
                "latent_channels": 4, "block_out_channels": [128, 256, 512, 512],
                "layers_per_block": 2, "norm_num_groups": 32, "scaling_factor": 0.18215},
        "text_encoder": {"architectures": ["CLIPTextModel"], "vocab_size": 49408,
                         "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
                         "max_position_embeddings": 77, "intermediate_size": 3072,
                         "hidden_act": "quick_gelu"},
        "scheduler": None,
    }
    for folder, cfg in configs.items():
        (root / folder).mkdir(parents=True)
        if cfg is not None:
            (root / folder / "config.json").write_text(json.dumps(cfg, indent=2))
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "DDIMScheduler", "num_train_timesteps": 1000, "beta_start": 0.00085,
         "beta_end": 0.012, "beta_schedule": "scaled_linear", "steps_offset": 1}))
    (root / "model_index.json").write_text(json.dumps({"_class_name": "StableDiffusionPipeline"}))
    _write_safetensors(torch, root / "unet" / "diffusion_pytorch_model.safetensors",
                       {_diffusers_key("unet", k): v for k, v in states["unet"].items()})
    torch.save({_diffusers_key("vae", k, old_vae_names=True): v.cpu()
                for k, v in states["vae"].items()}, root / "vae" / "diffusion_pytorch_model.bin")
    clip = {_diffusers_key("clip", k): v for k, v in states["clip"].items()}
    clip["text_model.embeddings.position_ids"] = torch.arange(77)[None]  # skipped on load
    _write_safetensors(torch, root / "text_encoder" / "model.safetensors", clip)
    del bundle, states, clip
    torch.cuda.empty_cache()
    return checked


def _modules(pipe) -> dict:
    return {"unet": pipe.unet, "vae": pipe.vae, "clip": pipe.text_encoder}


def phase_checkpoint(torch, attn, pipe, root: Path) -> dict:
    """The diffusers directory written, loaded by the server's --checkpoint
    and checked against random:full (`pipe`), then served: two DDIM-50
    requests over HTTP, then pndm, lms, euler and euler_a riffuse_audio and
    an euler_a txt2img on the loaded pipeline."""
    import numpy as np

    from riffusion_tpu_torch import server as server_mod
    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.models import weights
    from riffusion_tpu_torch.serving import load_seed_image

    start = time.perf_counter()
    checked = _write_checkpoint(torch, weights, root)
    files = sorted(p for p in root.rglob("*") if p.is_file())
    nbytes = sum(p.stat().st_size for p in files)
    log(f"[checkpoint] wrote {root.name}: {nbytes} bytes on disk in {len(files)} files, "
        f"{time.perf_counter() - start:.1f} s; the renames round-trip on {checked} keys "
        "(the VAE's under both namings)")

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    srv = server_mod.create_app(**server_mod.parse_args(
        ["--checkpoint", str(root), "--device", "cuda", "--port", "0",
         "--seed-images-dir", str(REPO / "seed_images")]))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - start
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    ck = server_mod.PIPELINE
    mismatched = [f"{name}.{k}" for name, m in _modules(ck).items()
                  for (k, a), b in zip(m.state_dict().items(),
                                       _modules(pipe)[name].state_dict().values())
                  if a.dtype != b.dtype or not torch.equal(a, b)]
    count = sum(v.numel() for m in _modules(ck).values() for v in m.state_dict().values())
    dtypes = {name: next(m.parameters()).dtype for name, m in _modules(ck).items()}
    log(f"[checkpoint] the server's --checkpoint loaded it in {load_s:.2f} s ({dtypes}); "
        f"peak device memory of the load {peak:.2f} GiB above the {before / 2**30:.2f} GiB "
        f"already held; {count} parameters, {len(mismatched)} not bit-equal to random:full's; "
        f"sampler {ck.bundle.scheduler_name}")
    if mismatched or ck.bundle.scheduler_name != "ddim":
        raise AssertionError(f"the checkpoint did not load as random:full: {mismatched[:5]}")

    def evals(scheduler: str, steps: int = 50, strength: float = 0.75) -> int:
        return ck._plan(scheduler, steps, strength)[0].num_steps

    thread, url = _serve(srv)
    k1 = 0
    seconds = {}
    try:
        for i in range(2):
            attn.COUNTS.reset()
            status, out, wall = _post(url + "/run_inference/", _request(i))
            log(f"[checkpoint] /run_inference/ {i} (ddim-50, strength 0.75): HTTP {status}, "
                f"{wall:.3f} s wall, K1 launches {attn.COUNTS.launches}")
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status}")
            _check_response(out)
            _expect_counts(attn, f"checkpoint request {i}", 10 * evals("ddim"), 0)
            k1 += attn.COUNTS.launches
            seconds[f"ddim-50 HTTP {i}"] = wall
    finally:
        _stop(srv, thread)

    seed = load_seed_image(REPO / "seed_images", "og_beat")
    inputs = InferenceInput(start=PromptInput(prompt="funky synth solo", seed=42),
                            end=PromptInput(prompt="jazzy saxophone", seed=123), alpha=0.5,
                            num_inference_steps=50)

    def run(what: str, k1_expected: int, fn) -> None:
        nonlocal k1
        attn.COUNTS.reset()
        t0 = time.perf_counter()
        image, std = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pixels = np.asarray(image, np.float64)
        log(f"[checkpoint] {what}: {wall:.3f} s, image {image.size}, pixel std "
            f"{pixels.std():.2f}, audio std {std}, K1 launches {attn.COUNTS.launches}")
        _expect_counts(attn, what, k1_expected, 0)
        if image.size != (512, 512) or not (np.isfinite(pixels).all() and pixels.std() > 0) \
                or not (std is None or std > 100):
            raise AssertionError(f"{what}: a flat image or silent audio")
        k1 += attn.COUNTS.launches
        seconds[what] = wall

    def audio(name: str):
        image, segment = ck.riffuse_audio(inputs, seed, scheduler=name)
        return image, float(segment.raw_data.astype(np.float64).std())

    for turn in (1, 2):  # each sampler twice, in turns: a host-bound request spreads
        for name in ("pndm",) + SAMPLERS:
            run(f"riffuse_audio {name}-50 ({turn})", 10 * evals(name), lambda: audio(name))
    run("txt2img euler_a-50, 512x512", 10 * 50, lambda: (ck.txt2img(
        "funky synth solo", seed=7, num_inference_steps=50, scheduler="euler_a"), None))
    return {"pipe": ck, "launches": k1, "seconds": seconds, "bytes": nbytes, "load_s": load_s}


def _movement_agreement(torch, ours: dict, ref: dict, start: dict) -> tuple:
    """(relative L2, max abs) of the difference between two runs' parameter
    movement from the same start."""
    a = torch.cat([(ours[k].cpu() - start[k].cpu()).flatten() for k in ref])
    b = torch.cat([(ref[k].cpu() - start[k].cpu()).flatten() for k in ref])
    return float((a - b).norm() / b.norm()), float((a - b).abs().max())


def phase_tiny_train(torch, attn) -> None:
    """Three fp32 trainer steps of the tiny UNet on the card and on the CPU,
    with the same weights, batch, t and noise: losses within 1e-4 relative,
    the parameters' movement within 1e-2 relative L2 (another sum order,
    which Adam amplifies on single elements whose gradient is near 0: their
    update is the gradient over its own magnitude, so the largest elementwise
    difference, printed, can reach a step's size and is not held)."""
    import numpy as np

    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer

    unet = random_bundle("tiny", seed=0, device="cpu").unet
    start = {k: v.clone() for k, v in unet.state_dict().items()}
    rng = np.random.default_rng(3)
    b, hw = 2, 32  # 32x32 latents: the 1024- and 256-query levels take K1
    latents = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    context = rng.standard_normal((b, 77, unet.cfg.cross_attention_dim)).astype(np.float32)
    draws = [(rng.integers(0, 1000, b), rng.standard_normal((b, hw, hw, 4)).astype(np.float32))
             for _ in range(3)]
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = DiffusionTrainer(device=device, learning_rate=1e-3, dtype=torch.float32)
        trainer.init_from(unet)
        attn.COUNTS.reset()
        losses = [float(trainer.step(latents, context, t=t, noise=n)) for t, n in draws]
        counts = (attn.COUNTS.launches, attn.COUNTS.bwd_dkv_launches,
                  attn.COUNTS.bwd_dq_launches, attn.COUNTS.plain_calls)
        runs[device] = (losses, {k: v.cpu() for k, v in trainer.master.state_dict().items()},
                        counts)
    (loss_g, params_g, counts), (loss_c, params_c, _) = runs["cuda"], runs["cpu"]
    rel, worst = _movement_agreement(torch, params_g, params_c, start)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_g, loss_c))
    log(f"[tiny train] 3 fp32 steps, cuda vs cpu: losses {[f'{x:.6f}' for x in loss_g]} vs "
        f"{[f'{x:.6f}' for x in loss_c]} (rel {loss_err:.2e}); movement rel L2 {rel:.3e}, "
        f"max abs {worst:.3e}; (K1, dK/dV, dQ, plain) launches on the card {counts}")
    if not (counts[0] > 0 and counts[0] == counts[1] == counts[2] and counts[3] == 0):
        raise AssertionError("the tiny train on the card did not go through K1 and its backward")
    if not (loss_err < 1e-4 and rel < 1e-2):
        raise AssertionError("the card's tiny train disagrees with the CPU's")


def _synth_clips(root: Path, files: int, clips_per_file: int, sr: int = 44100) -> None:
    """Deterministic music-like wav files (decaying partials, a beat, light
    noise), long enough for `clips_per_file` clips of 5.12 s each."""
    import numpy as np

    from riffusion_tpu_torch.audio.segment import AudioSegment

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    t = np.arange(int((clips_per_file * 5.12 + 0.05) * sr)) / sr
    for i in range(files):
        sig = sum(0.5 ** j * np.sin(2 * np.pi * f * (1 + 0.01 * i) * t + rng.uniform(0, 6.3))
                  for j, f in enumerate((110.0, 220.0, 330.0, 554.37, 880.0)))
        sig *= 0.55 + 0.45 * np.square(np.sin(2 * np.pi * (2.0 + i) * t))
        sig += 0.01 * rng.standard_normal(t.size)
        AudioSegment((sig / np.abs(sig).max() * 0.8 * 32767).astype(np.int16), sr).export(
            str(root / f"clip_{i}.wav"))


def _full_width_gradients(torch, attn, layers, ds_dir: Path) -> dict:
    """One step's loss and gradients at full width with the kernels, then
    the same step (weights, batch, t, noise) with the plain attention at
    the kernel sites (layers._ATTENTION_OPS swapped in this process only)."""
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer
    from riffusion_tpu_torch.training import LatentDataset

    dev = torch.device("cuda")
    unet = random_bundle("full", seed=0, device=dev, dtype=torch.float32).unet
    trainer = DiffusionTrainer(device=dev, learning_rate=0.0, dtype=torch.bfloat16)
    trainer.init_from(unet)
    del unet
    latents, context = next(LatentDataset(ds_dir).batches(4, seed=0))
    gen = torch.Generator(device=dev).manual_seed(5)
    t = torch.randint(0, 1000, (4,), generator=gen, device=dev)
    noise = torch.randn(latents.shape, generator=gen, device=dev)

    attn.COUNTS.reset()
    loss_k = float(trainer.loss_and_grads(latents, context, t=t, noise=noise))
    counts = (attn.COUNTS.launches, attn.COUNTS.bwd_dkv_launches, attn.COUNTS.bwd_dq_launches,
              attn.COUNTS.plain_calls)
    grads_k = [p.grad.clone() for p in trainer.master.parameters()]
    kernel_op = layers._ATTENTION_OPS["flash"]
    layers._ATTENTION_OPS["flash"] = attn.attention_reference
    try:
        loss_p = float(trainer.loss_and_grads(latents, context, t=t, noise=noise))
    finally:
        layers._ATTENTION_OPS["flash"] = kernel_op
    grads_p = [p.grad for p in trainer.master.parameters()]
    diff = torch.sqrt(sum(torch.sum(torch.square(a - b)) for a, b in zip(grads_k, grads_p)))
    norm = torch.sqrt(sum(torch.sum(torch.square(b)) for b in grads_p))
    result = {"loss_kernel": loss_k, "loss_plain": loss_p,
              "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
              "grad_rel_l2": float(diff / norm), "counts": counts}
    del trainer, grads_k, grads_p
    torch.cuda.empty_cache()
    return result


def phase_train(torch, attn, pipe, checkpoint: Path, dataset: Path) -> dict:
    """Fine-tuning at full width from the checkpoint directory: the latent
    dataset from its pipeline (into `dataset`, which the parallel-train
    phase reads too), run_finetune of 4 steps at batch 4, the kernels'
    gradients against the plain attention's, and the export reloaded and
    served."""
    import numpy as np

    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.models import layers
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.serving import load_seed_image
    from riffusion_tpu_torch.training import FinetuneConfig, build_latent_dataset, run_finetune

    work = REPO / ".chipwork"
    work.mkdir(exist_ok=True)
    free_gb = shutil.disk_usage(work).free / 1e9
    tmp = Path(tempfile.mkdtemp(prefix="train-", dir=work))
    log(f"[train] free disk before the run: {free_gb:.1f} GB ({work})")
    try:
        _synth_clips(tmp / "audio", files=2, clips_per_file=4)
        start = time.perf_counter()
        meta = build_latent_dataset(pipe, tmp / "audio", dataset)
        log(f"[train] dataset: {meta.num_clips} clips, latents {meta.latent_shape}, contexts "
            f"{meta.context_shape}, in {time.perf_counter() - start:.1f} s")
        if meta.num_clips != 8 or tuple(meta.latent_shape) != (64, 64, 4):
            raise AssertionError(f"unexpected dataset: {meta}")

        marks = []

        def on_log(msg: str) -> None:
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), (
                attn.COUNTS.launches, attn.COUNTS.bwd_dkv_launches, attn.COUNTS.bwd_dq_launches,
                attn.COUNTS.plain_calls), msg))
            log(f"[train] {msg}")

        torch.cuda.reset_peak_memory_stats()
        attn.COUNTS.reset()
        start = time.perf_counter()
        stats = run_finetune(FinetuneConfig(
            checkpoint=str(checkpoint), dataset_dir=str(dataset),
            output_dir=str(tmp / "run"), steps=4, batch_size=4, log_every=1, device="cuda",
        ), log=on_log)
        wall = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_marks = [m for m in marks if m[2].startswith("step ")]
        per_step = [tuple(b - a for a, b in zip(prev[1], cur[1]))
                    for prev, cur in zip([(0, (0, 0, 0, 0), "")] + step_marks, step_marks)]
        step_s = [b[0] - a[0] for a, b in zip(step_marks, step_marks[1:])]
        ckpt = stats["checkpoint"]
        log(f"[train] run_finetune: 4 steps at batch 4 in {wall:.2f} s wall (dataset load, "
            f"weights, steps, checkpoint, export); step time {statistics.median(step_s):.4f} s "
            f"(median of steps 2-4: {[f'{x:.4f}' for x in step_s]}); final loss "
            f"{stats['final_loss']:.5f}; peak device memory {peak:.2f} GiB; checkpoint "
            f"{ckpt['bytes'] / 1e9:.3f} GB in {ckpt['seconds']:.2f} s; (K1, dK/dV, dQ, plain) "
            f"launches per step {per_step}")
        if per_step != [(LAUNCHES_PER_STEP,) * 3 + (0,)] * 4:
            raise AssertionError(f"the training steps' launches {per_step} are not "
                                 f"{LAUNCHES_PER_STEP} K1, dK/dV and dQ each and no plain call")
        if not np.isfinite(stats["final_loss"]):
            raise AssertionError("non-finite training loss")
        launches = {"attention": sum(c[0] for c in per_step),
                    "attention_dkv": sum(c[1] for c in per_step),
                    "attention_dq": sum(c[2] for c in per_step)}

        grads = _full_width_gradients(torch, attn, layers, dataset)
        log(f"[train] one full-width step, kernels against the plain attention: loss "
            f"{grads['loss_kernel']:.6f} vs {grads['loss_plain']:.6f} (rel {grads['loss_rel']:.3e}), "
            f"gradient rel L2 {grads['grad_rel_l2']:.3e} (bound {TRAIN_GRAD_BOUND}); "
            f"(K1, dK/dV, dQ, plain) launches with the kernels {grads['counts']}")
        if grads["counts"] != (LAUNCHES_PER_STEP,) * 3 + (0,):
            raise AssertionError("the gradient comparison's kernel step missed a kernel")
        if not (grads["grad_rel_l2"] <= TRAIN_GRAD_BOUND["grad_rel_l2"]
                and grads["loss_rel"] <= TRAIN_GRAD_BOUND["loss_rel"]):
            raise AssertionError("the kernels' gradients disagree with the plain attention's")

        start = time.perf_counter()
        tuned = RiffusionPipeline.load_checkpoint(stats["export_dir"], device="cuda")
        attn.COUNTS.reset()
        image, segment = tuned.riffuse_audio(
            InferenceInput(start=PromptInput(prompt="funky synth solo", seed=42),
                           end=PromptInput(prompt="jazzy saxophone", seed=123), alpha=0.5),
            load_seed_image(REPO / "seed_images", "og_beat"))
        torch.cuda.synchronize()
        samples = segment.raw_data.astype(np.float64)
        # the export keeps the checkpoint's sampler (ddim): 10 K1 launches per evaluation
        sampler = tuned.bundle.scheduler_name
        expected = 10 * tuned._plan(sampler, 50, 0.75)[0].num_steps
        log(f"[train] export reloaded and one 50-step request riffused ({sampler}) in "
            f"{time.perf_counter() - start:.2f} s: image {image.size}, pixel std "
            f"{np.asarray(image, np.float64).std():.2f}, audio {segment.duration_seconds:.2f} s "
            f"(std {samples.std():.0f}); K1 launches {attn.COUNTS.launches} ({expected} expected)")
        if image.size != (512, 512) or not np.asarray(image).std() > 0 \
                or not samples.std() > 100 or attn.COUNTS.launches != expected \
                or sampler != "ddim":
            raise AssertionError("the reloaded export did not serve a request")
        del tuned
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"launches": launches, "step_s": statistics.median(step_s), "peak_gib": peak,
            "grads": grads}


def _check_response(out: dict) -> None:
    """One InferenceOutput: a non-flat 512x512 image and 5.11 s of audio that
    is not silent (a readback before the copy finished gives zeros)."""
    import numpy as np
    from PIL import Image

    image = Image.open(io.BytesIO(base64.b64decode(out["image"].split(",", 1)[1])))
    pixels = np.asarray(image.convert("RGB"), np.float64)
    if image.size != (512, 512) or not pixels.std() > 0:
        raise AssertionError(f"bad image: {image.size}, std {pixels.std()}")
    if abs(out["duration_s"] - 5.11) > 0.02:
        raise AssertionError(f"audio is {out['duration_s']} s, expected 5.11 s")
    if out["audio"].startswith("data:audio/wav;base64,"):
        with wave.open(io.BytesIO(base64.b64decode(out["audio"].split(",", 1)[1]))) as w:
            samples = np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float64)
        if not (samples.size > 0 and samples.std() > 100):
            raise AssertionError(f"silent audio: std {samples.std()}")


def _post(url: str, payload) -> tuple:
    """(HTTP status, parsed JSON body, wall seconds) of one POST."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as resp:
        status, body = resp.status, resp.read()
    return status, json.loads(body), time.perf_counter() - t0


def _request(i: int, steps: int = 50, denoising: float = 0.75) -> dict:
    return {
        "start": {"prompt": "funky synth solo", "seed": 42 + i, "denoising": denoising},
        "end": {"prompt": "jazzy saxophone", "seed": 123 + i, "denoising": denoising},
        "alpha": 0.5,
        "num_inference_steps": steps,
        "seed_image_id": "og_beat",
    }


def _expect_counts(attn, what: str, launches: int, rows: int) -> None:
    got = (attn.COUNTS.launches, attn.COUNTS.row_launches, attn.COUNTS.plain_calls)
    if got != (launches, rows, 0):
        raise AssertionError(f"{what}: (K1, K2, plain) launches {got}, expected "
                             f"{(launches, rows, 0)}")


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    if server.batcher is not None:
        server.batcher.shutdown()


def phase_slice(torch, attn, pipe) -> dict:
    from riffusion_tpu_torch import server as server_mod

    server_mod.PIPELINE = pipe
    srv = server_mod.RiffusionServer(("127.0.0.1", 0), seed_images_dir=REPO / "seed_images")
    thread, url = _serve(srv)
    counts = {"attention": 0, "row_attention": 0}
    try:
        for i in range(3):
            attn.COUNTS.reset()
            torch.cuda.reset_peak_memory_stats()
            status, out, wall = _post(url + "/run_inference/", _request(i))
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"[slice] request {i}: HTTP {status}, {wall:.3f} s wall, peak device memory "
                f"{peak:.2f} GiB, K1 launches {attn.COUNTS.launches}, K2 launches "
                f"{attn.COUNTS.row_launches}, plain calls {attn.COUNTS.plain_calls}")
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status}")
            _check_response(out)
            _expect_counts(attn, f"request {i}", LAUNCHES_PER_REQUEST, 0)
            counts["attention"] += attn.COUNTS.launches
    finally:
        _stop(srv, thread)
    return counts


def phase_batch(torch, attn, pipe) -> dict:
    """The batched path behind the threading server and the DynamicBatcher."""
    from riffusion_tpu_torch import server as server_mod
    from riffusion_tpu_torch.serving import FAST_PRESET, FAST_PRESET_OFFGATE, DynamicBatcher

    def evals(scheduler: str, steps: int, strength: float) -> int:
        return pipe._plan(scheduler, steps, strength)[0].num_steps

    e_fast = evals(FAST_PRESET["scheduler"], FAST_PRESET["steps"], 0.75)
    e_off = evals(FAST_PRESET_OFFGATE["scheduler"], FAST_PRESET_OFFGATE["steps"], 0.65)
    e_pndm = evals("pndm", 50, 0.75)
    log(f"[batch] UNet evaluations: FAST preset {e_fast}, off-gate {e_off}, PNDM-50 {e_pndm}")

    server_mod.PIPELINE = pipe
    srv = server_mod.RiffusionThreadingServer(("127.0.0.1", 0),
                                              seed_images_dir=REPO / "seed_images")
    srv.batcher = DynamicBatcher(pipe, max_batch=16, window_ms=3000,
                                 scheduler=FAST_PRESET["scheduler"],
                                 steps_override=FAST_PRESET["steps"], strength_gated=True)
    thread, url = _serve(srv)
    counts = {"attention": 0, "row_attention": 0}
    results = {}

    def run(what: str, k1: int, k2: int, fn):
        attn.COUNTS.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        clips = fn()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[batch] {what}: {clips} clips in {wall:.3f} s wall ({clips / wall:.4f} clips/s), "
            f"peak device memory {peak:.2f} GiB, K1 launches {attn.COUNTS.launches}, K2 launches "
            f"{attn.COUNTS.row_launches}, plain calls {attn.COUNTS.plain_calls}")
        _expect_counts(attn, what, k1, k2)
        counts["attention"] += attn.COUNTS.launches
        counts["row_attention"] += attn.COUNTS.row_launches
        results[what] = {"clips": clips, "seconds": wall, "peak_gib": peak}

    def burst() -> int:
        before = dict(srv.batcher.stats)
        statuses = [None] * 16

        def post(i):
            try:
                status, out, _ = _post(url + "/run_inference/", _request(i))
                _check_response(out)
                statuses[i] = status
            except Exception as e:  # reported through `statuses`
                statuses[i] = repr(e)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        after = srv.batcher.stats
        launches = after["launches"] - before["launches"]
        batched = after["batched_requests"] - before["batched_requests"]
        log(f"[batch] statuses {statuses}; batcher launches {launches}, batched requests {batched}")
        if statuses != [200] * 16 or (launches, batched) != (1, 16):
            raise AssertionError("the burst did not come back as one batch of 16")
        return 16

    def lone_offgate() -> int:
        # a lone request waits the whole batching window before it runs:
        # close the window so that the wall time is the request's work
        srv.batcher.window_s, window_s = 0.0, srv.batcher.window_s
        try:
            status, out, _ = _post(url + "/run_inference/", _request(16, denoising=0.65))
        finally:
            srv.batcher.window_s = window_s
        if status != 200:
            raise AssertionError(f"off-gate request: HTTP {status}")
        _check_response(out)
        return 1

    def batch_route() -> int:
        status, out, _ = _post(url + "/run_inference_batch/",
                               {"requests": [_request(i) for i in range(16)]})
        if status != 200 or len(out["outputs"]) != 16:
            raise AssertionError(f"/run_inference_batch/: HTTP {status}")
        for item in out["outputs"]:
            _check_response(item)
        return 16

    try:
        run("burst of 16, FAST preset (first)", 5 * e_fast, 5 * e_fast, burst)
        run("burst of 16, FAST preset (second)", 5 * e_fast, 5 * e_fast, burst)
        run("one request at strength 0.65 (dpmpp-24, batching window 0 ms)", 10 * e_off, 0,
            lone_offgate)
        run("/run_inference_batch/ of 16, PNDM-50", 5 * e_pndm, 5 * e_pndm, batch_route)
    finally:
        _stop(srv, thread)
    return {"counts": counts, "results": results}


def _check_clip(what: str, image, segment, size=(512, 512), seconds: float = 5.11) -> None:
    """A generated clip: a non-flat image of `size` (512x512 by default) and
    `seconds` of audio (5.11) that is not silent."""
    import numpy as np

    pixels = np.asarray(image, np.float64)
    if image.size != size or not (np.isfinite(pixels).all() and pixels.std() > 0):
        raise AssertionError(f"{what}: bad image {image.size}, std {pixels.std()}")
    if segment is not None:
        samples = segment.raw_data.astype(np.float64)
        if abs(segment.duration_seconds - seconds) > 0.02 or not samples.std() > 100:
            raise AssertionError(f"{what}: {segment.duration_seconds} s of audio, std "
                                 f"{samples.std()}")


def phase_modes(torch, attn, pipe) -> dict:
    """The other generating modes at full width: txt2img_audio_batch of 16
    prompts (pndm-30, UNet batch 32, fused through the audio tail) and
    img2img_magic_mix on og_beat (pndm-50, kmin 0.3, kmax 0.5, UNet batch
    2), with exact launch counts from the plans."""
    from riffusion_tpu_torch.diffusion import schedulers as sched
    from riffusion_tpu_torch.serving import load_seed_image
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

    counts = {"attention": 0, "row_attention": 0}
    seconds = {}

    def run(what: str, k1: int, k2: int, fn):
        attn.COUNTS.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[what] = time.perf_counter() - t0
        log(f"[modes] {what}: {seconds[what]:.3f} s, K1 launches {attn.COUNTS.launches}, K2 "
            f"launches {attn.COUNTS.row_launches}, plain calls {attn.COUNTS.plain_calls}")
        _expect_counts(attn, what, k1, k2)
        counts["attention"] += attn.COUNTS.launches
        counts["row_attention"] += attn.COUNTS.row_launches
        return out

    e_t2i = sched.make_plan("pndm", 30).num_steps
    prompts = [f"funky synth solo {i}" for i in range(16)]
    for turn in (1, 2):  # the first call of a batch size sets up cuDNN's plans
        results = run(f"txt2img_audio_batch of 16, pndm-30, 512x512 ({turn})", 5 * e_t2i,
                      5 * e_t2i, lambda: pipe.txt2img_audio_batch(
                          prompts, seeds=list(range(16)), num_inference_steps=30,
                          scheduler="pndm", params=SpectrogramParams()))
        for i, (image, segment) in enumerate(results):
            _check_clip(f"txt2img_audio_batch item {i}", image, segment)

    seed = load_seed_image(REPO / "seed_images", "og_beat")
    t_start = pipe._magic_mix_start("pndm", 50, 0.3, 0.5)[0]
    e_mix = sched.make_plan("pndm", 50, t_start).num_steps
    log(f"[modes] UNet evaluations: txt2img pndm-30 {e_t2i}, magic mix pndm-50 from position "
        f"{t_start}: {e_mix}")
    for turn in (1, 2):
        image = run(f"img2img_magic_mix on og_beat, pndm-50 ({turn})", 10 * e_mix, 0,
                    lambda: pipe.img2img_magic_mix("jazzy saxophone", seed,
                                                   num_inference_steps=50, scheduler="pndm"))
        _check_clip("img2img_magic_mix", image, None)
    return {"counts": counts, "seconds": seconds}


def phase_cli(torch, attn, checkpoint: Path) -> dict:
    """The command line on the checkpoint directory, in this process, with
    the embedding disk cache in a directory of its own: text-to-audio, then
    stream --fast (16 clips in batches of 8), then warmstart_report on two
    fresh loads of the directory."""
    import contextlib
    import os

    import numpy as np

    from riffusion_tpu_torch import cli
    from riffusion_tpu_torch.audio.segment import AudioSegment
    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.diffusion import schedulers as sched
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline, img2img_plan
    from riffusion_tpu_torch.serving import FAST_PRESET, load_seed_image
    from PIL import Image

    out_dir = Path(tempfile.mkdtemp(prefix="cli-", dir=REPO / ".chipwork"))
    cache_before = os.environ.get("RIFFUSION_TPU_EMBED_CACHE_DIR")
    os.environ["RIFFUSION_TPU_EMBED_CACHE_DIR"] = str(out_dir / "embeds")
    counts = {"attention": 0, "row_attention": 0}
    seconds = {}

    def run(what: str, k1: int, k2: int, argv) -> str:
        attn.COUNTS.reset()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cli.main(argv)
        torch.cuda.synchronize()
        seconds[what] = time.perf_counter() - t0
        log(f"[cli] {what}: {seconds[what]:.3f} s with the load, K1 launches "
            f"{attn.COUNTS.launches}, K2 launches {attn.COUNTS.row_launches}, plain calls "
            f"{attn.COUNTS.plain_calls}; it printed: {printed.getvalue().strip()!r}")
        _expect_counts(attn, what, k1, k2)
        counts["attention"] += attn.COUNTS.launches
        counts["row_attention"] += attn.COUNTS.row_launches
        return printed.getvalue()

    try:
        wav, png = out_dir / "text.wav", out_dir / "text.png"
        e_t2i = sched.make_plan("pndm", 30).num_steps
        run("text-to-audio (pndm-30)", 10 * e_t2i, 0,
            ["text-to-audio", "--prompt", "funky synth solo", "--audio", str(wav), "--image",
             str(png), "--checkpoint", str(checkpoint)])
        _check_clip("text-to-audio", Image.open(png), AudioSegment.from_file(str(wav)))

        e_fast = img2img_plan(FAST_PRESET["scheduler"], FAST_PRESET["steps"], 0.75)[0].num_steps
        stream_wav = out_dir / "stream.wav"
        printed = run(f"stream --num-clips 16 --batch 8 --fast (3 launches of {e_fast} "
                      "evaluations at UNet batch 16)", 3 * 5 * e_fast, 3 * 5 * e_fast,
                      ["stream", "--prompt-start", "funky synth solo", "--prompt-end",
                       "jazzy saxophone", "--audio", str(stream_wav), "--num-clips", "16",
                       "--batch", "8", "--fast", "--checkpoint", str(checkpoint)])
        track = AudioSegment.from_file(str(stream_wav))
        expect_s = 16 * 5.11 - 15 * 0.2
        samples = track.raw_data.astype(np.float64)
        rate = re.search(r"\(([0-9.]+)x realtime", printed)
        log(f"[cli] stream: {track.duration_seconds:.3f} s of audio (16 clips less 15 "
            f"crossfades: {expect_s:.2f} s), realtime factor {rate and rate.group(1)}")
        if abs(track.duration_seconds - expect_s) > 0.05 or not samples.std() > 100 or not rate:
            raise AssertionError("stream: wrong length, silent, or no realtime factor")

        seed = load_seed_image(REPO / "seed_images", "og_beat")
        inputs = InferenceInput(start=PromptInput(prompt="organ chords", seed=3),
                                end=PromptInput(prompt="church bells", seed=4), alpha=0.5,
                                num_inference_steps=50)
        reports = []
        for load in (1, 2):
            t0 = time.perf_counter()
            warm = RiffusionPipeline.load_checkpoint(str(checkpoint), device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            evals = warm._plan(warm.bundle.scheduler_name, 50, 0.75)[0].num_steps
            attn.COUNTS.reset()
            report = warm.warmstart_report(inputs, seed)
            log(f"[cli] warmstart_report, load {load} of the directory ({load_s:.2f} s to "
                f"load): {json.dumps(report)}; K1 launches {attn.COUNTS.launches}")
            _expect_counts(attn, f"warmstart_report {load}", 10 * evals, 0)
            counts["attention"] += attn.COUNTS.launches
            reports.append(dict(report, load_s=load_s))
            del warm
            gc.collect()
        second = reports[1]
        if not (second["embed_cache_hits"] > 0 and second["embed_cache_misses"] == 0
                and second["kernel_source"] == "cached"):
            raise AssertionError(f"the second warm start did not read its embeddings and "
                                 f"kernels from disk: {second}")
    finally:
        os.environ["RIFFUSION_TPU_EMBED_CACHE_DIR"] = cache_before
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"counts": counts, "seconds": seconds, "warmstart": reports}


def _engine_pcm(rate: int, seconds: float, channels: int, seed: int):
    """(n, channels) int16: tones at 110 Hz and 2 kHz and noise from a
    splitmix64 hash, low-passed by three 8-sample moving averages."""
    import numpy as np

    n = int(rate * seconds)
    z = (np.arange((n + 21) * channels, dtype=np.uint64) + np.uint64(seed)) * \
        np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    noise = ((z >> np.uint64(11)).astype(np.float64) * 2.0 ** -52 - 1.0).reshape(-1, channels)
    for _ in range(3):
        c = np.concatenate([np.zeros((1, channels)), np.cumsum(noise, axis=0)])
        noise = (c[8:] - c[:-8]) / 8
    t = np.arange(n) / rate
    tones = 0.35 * np.sin(2 * np.pi * 110 * t) + 0.2 * np.sin(2 * np.pi * 2000 * t)
    return np.round((tones[:, None] + 0.3 * noise) * 32767).astype(np.int16)


def _engine_cases() -> list:
    """(case, the engine function's name, its arguments) of the engine check;
    the JAX package's riffusion_tpu/audio/native.py has the same functions."""
    cases = [(f"resample {a}->{b}", "resample_poly_int16", (_engine_pcm(a, 5.0, 2, 1), a, b))
             for a, b in ENGINE_RESAMPLES]
    cases.append(("crossfade 8820", "crossfade_concat_int16",
                  (_engine_pcm(44100, 5.0, 2, 2), _engine_pcm(44100, 5.0, 2, 3), 8820)))
    cases.append(("compressor", "compress_dynamic_range_int16",
                  (_engine_pcm(44100, 5.0, 2, 4), 44100)))
    return cases


def _digest(arrays) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def _check_engine() -> dict:
    """Build the engine into a fresh directory (its seconds), then each case
    against its numpy version and the JAX engine's digest, with both times."""
    import numpy as np

    from riffusion_tpu_torch.audio import native

    build_dir = Path(tempfile.mkdtemp(prefix="engine-", dir=REPO / ".chipwork"))
    try:
        t0 = time.perf_counter()
        native.build(build_dir)
        build_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)
    native.load()
    log(f"[frontends] audio engine built with g++ {' '.join(native.CXX_FLAGS)} in {build_s:.3f} s")
    results = {"build_s": build_s}
    for case, fn, args in _engine_cases():
        expect_in, expect_out = ENGINE_DIGESTS[case]
        arrays = [a for a in args if isinstance(a, np.ndarray)]
        if _digest(arrays) != expect_in:
            raise AssertionError(f"engine {case}: this host's numpy made other input buffers "
                                 f"({_digest(arrays)}); the digests cannot be compared")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = getattr(native, fn)(*args)
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = getattr(native, fn + "_numpy")(*args)
        numpy_s = time.perf_counter() - t0
        if out.shape != ref.shape:
            raise AssertionError(f"engine {case}: shape {out.shape}, numpy {ref.shape}")
        diff = out.astype(np.float64) - ref
        max_lsb = float(np.abs(diff).max())
        rel_rms = float(np.sqrt(np.mean(diff ** 2) / np.mean(ref.astype(np.float64) ** 2)))
        digest_ok = _digest([out]) == expect_out
        log(f"[frontends] engine {case}: {statistics.median(times) * 1e3:.3f} ms (median of 5), "
            f"numpy {numpy_s * 1e3:.3f} ms; against numpy max {max_lsb:.0f} LSB, error RMS / "
            f"RMS {rel_rms:.3e}; the JAX engine's digest {'matched' if digest_ok else 'DIFFERS'}")
        if fn == "resample_poly_int16":
            ok = (max_lsb <= ENGINE_BOUND["resample_max_lsb"]
                  and rel_rms <= ENGINE_BOUND["resample_rel_rms"])
        elif fn == "crossfade_concat_int16":
            ok = max_lsb <= ENGINE_BOUND["crossfade_max_lsb"]
        else:
            ok = max_lsb == 0
        if not (ok and digest_ok):
            raise AssertionError(f"engine {case}: outside ENGINE_BOUND {ENGINE_BOUND} or not the "
                                 "JAX engine's samples")
        results[case] = {"ms": statistics.median(times) * 1e3, "numpy_ms": numpy_s * 1e3,
                         "max_lsb": max_lsb, "rel_rms": rel_rms}
    return results


def _split_input(seconds: float = 30.0, rate: int = 48000, seed: int = 0):
    """The frontends phase's stereo file: tones at 110 Hz and 2 kHz (the
    right channel's a quarter turn later) plus noise, (n, 2) int16."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    phase = np.array([0.0, np.pi / 2])
    x = (0.4 * np.sin(2 * np.pi * 110 * t[:, None] + phase)
         + 0.2 * np.sin(2 * np.pi * 2000 * t[:, None]) + 0.02 * rng.standard_normal((t.size, 2)))
    return np.round(x * 32767).astype(np.int16)


def phase_frontends(torch, attn, checkpoint: Path) -> dict:
    """The playground's host layer and pages on the checkpoint directory,
    loaded through streamlit/util.load_riffusion_checkpoint (UI defaults:
    50 steps, denoising 0.45, guidance 7, PNDM): the audio engine, the stem
    splitter and compute_fft on a 48 kHz file resampled by the engine, the
    restyle of that file (batched interpolation, serial img2img, MagicMix
    on its first clip), the interpolation page's batch of 4, the batch
    page's 6 entries, one text-to-audio clip and og_beat to audio, each with
    its wall time, exact launch counts and peak device memory."""
    import numpy as np
    from PIL import Image

    from riffusion_tpu_torch.audio.segment import AudioSegment
    from riffusion_tpu_torch.audio_splitter import AudioSplitter
    from riffusion_tpu_torch.diffusion import schedulers as sched
    from riffusion_tpu_torch.riffusion_pipeline import img2img_plan
    from riffusion_tpu_torch.streamlit import util as st_util
    from riffusion_tpu_torch.streamlit.tasks import audio_to_audio as a2a
    from riffusion_tpu_torch.streamlit.tasks import image_to_audio, interpolation
    from riffusion_tpu_torch.streamlit.tasks import text_to_audio, text_to_audio_batch
    from riffusion_tpu_torch.util import fft_util

    counts = {"attention": 0, "row_attention": 0}
    runs = {"engine": _check_engine()}
    out_dir = Path(tempfile.mkdtemp(prefix="frontends-", dir=REPO / ".chipwork"))

    def run(what: str, k1: int, k2: int, fn):
        attn.COUNTS.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[frontends] {what}: {wall:.3f} s, peak device memory {peak:.2f} GiB, K1 launches "
            f"{attn.COUNTS.launches}, K2 launches {attn.COUNTS.row_launches}, plain calls "
            f"{attn.COUNTS.plain_calls}")
        _expect_counts(attn, what, k1, k2)
        counts["attention"] += attn.COUNTS.launches
        counts["row_attention"] += attn.COUNTS.row_launches
        runs[what] = {"seconds": wall, "peak_gib": peak, "k1": k1, "k2": k2}
        return out

    def check_track(what: str, track, clips: int, clip_s: float) -> None:
        """The stitched restyle: clips less their 0.2 s crossfades, and every
        clip's span of it not silent."""
        expect = clips * clip_s - (clips - 1) * a2a.OVERLAP_S
        if abs(track.duration_seconds - expect) > 0.02:
            raise AssertionError(f"{what}: {track.duration_seconds} s, expected {expect:.2f}")
        step = clip_s - a2a.OVERLAP_S
        for i in range(clips):
            span = track[i * step * 1000:(i * step + clip_s) * 1000].raw_data.astype(np.float64)
            if not span.std() > 100:
                raise AssertionError(f"{what}: clip {i} is silent (std {span.std()})")

    try:
        wav = out_dir / "input-48k.wav"
        AudioSegment(_split_input(), 48000).export(str(wav)).close()
        source = AudioSegment.from_file(str(wav))
        t0 = time.perf_counter()
        segment = source.set_frame_rate(44100)
        log(f"[frontends] {source.duration_seconds:.1f} s stereo at 48 kHz to 44.1 kHz on the "
            f"engine in {time.perf_counter() - t0:.3f} s")

        stems = run(f"AudioSplitter(device='cuda') on {segment.duration_seconds:.1f} s", 0, 0,
                    lambda: AudioSplitter(device="cuda").split(segment))
        n = min(min(s.frame_count for s in stems.values()), segment.frame_count)
        total = sum(s.raw_data[:n].astype(np.float64) for s in stems.values())
        orig = segment.raw_data[:n].astype(np.float64)
        rel = float(np.sqrt(np.sum((total - orig) ** 2) / np.sum(orig ** 2)))
        freqs, mag = fft_util.compute_fft(stems["bass"])
        low, high = (float(mag[np.argmin(np.abs(freqs - f))]) for f in (110.0, 2000.0))
        log(f"[frontends] stems {sorted(stems)} sum back to the input at relative L2 {rel:.3e} "
            f"(bound {SPLIT_BOUND}); the bass stem's spectrum: {low:.2f} at 110 Hz, {high:.4f} "
            f"at 2 kHz")
        if not (rel <= SPLIT_BOUND and low > high):
            raise AssertionError("the stems do not sum back to the input, or the bass stem "
                                 "does not hold the 110 Hz tone over the 2 kHz one")

        t0 = time.perf_counter()
        pipe = st_util.load_riffusion_checkpoint(checkpoint=str(checkpoint), device="cuda")
        log(f"[frontends] load_riffusion_checkpoint({checkpoint.name}): "
            f"{time.perf_counter() - t0:.2f} s, sampler {pipe.bundle.scheduler_name}")
        params = a2a.ClipParams(prompt="jazzy saxophone")
        starts = a2a.clip_start_times(segment.duration_seconds)
        clips = len(starts)
        e_batched = img2img_plan(pipe.bundle.scheduler_name, 50, params.denoising)[0].num_steps
        e_serial = img2img_plan("pndm", 50, params.denoising)[0].num_steps
        t_start = pipe._magic_mix_start("pndm", 50, 0.3, 0.5)[0]
        e_mix = sched.make_plan("pndm", 50, t_start).num_steps
        e_interp = img2img_plan(pipe.bundle.scheduler_name, 50, 0.75)[0].num_steps
        e_txt = sched.make_plan("pndm", 50).num_steps
        log(f"[frontends] {clips} clips; UNet evaluations: batched restyle {e_batched} at UNet "
            f"batch {2 * clips}, serial img2img {e_serial}, MagicMix {e_mix}, interpolation "
            f"{e_interp} at batch 8, txt2img {e_txt}")

        # the seq-3840 sites of a 512x480 clip are not a multiple of 512: at
        # UNet batch 14 they take the plain composition (the JAX gate), the
        # seq-960 sites K1
        track, images = run(f"restyle_audio, interpolation, {clips} clips batched", 5 * e_batched,
                            0, lambda: a2a.restyle_audio(segment, params, mode="interpolation",
                                                         device="cuda",
                                                         checkpoint=str(checkpoint)))
        for i, image in enumerate(images):
            _check_clip(f"batched restyle clip {i}", image, None, size=(480, 512))
        check_track("batched restyle", track, clips, 4.79)

        track, images = run(f"restyle_audio, img2img, {clips} clips serial", 10 * clips * e_serial,
                            0, lambda: a2a.restyle_audio(segment, params, mode="img2img",
                                                         device="cuda",
                                                         checkpoint=str(checkpoint)))
        for i, image in enumerate(images):
            _check_clip(f"serial restyle clip {i}", image, None, size=(501, 512))
        check_track("serial restyle", track, clips, 5.0)

        first = a2a.slice_audio_into_clips(segment, starts[:1])[0]
        audio, _, image = run("restyle_segment, magic_mix, first clip", 10 * e_mix, 0,
                              lambda: a2a.restyle_segment(first, params, mode="magic_mix",
                                                          device="cuda",
                                                          checkpoint=str(checkpoint)))
        _check_clip("magic_mix clip", image, audio, size=(501, 512), seconds=5.0)

        og_beat = Image.open(REPO / "seed_images" / "og_beat.png").convert("RGB")
        spec = interpolation.InterpolationSpec(prompt_start="funky synth solo",
                                               prompt_end="jazzy saxophone", seed_start=42,
                                               seed_end=123)
        images, segments = run("run_interpolation_batch, 4 frames", 10 * e_interp, 0,
                               lambda: interpolation.run_interpolation_batch(
                                   spec, og_beat, device="cuda", checkpoint=str(checkpoint)))
        for i, (image, clip) in enumerate(zip(images, segments)):
            _check_clip(f"interpolation frame {i}", image, clip)
        interpolation.concat_segments(segments)

        batch_dir = out_dir / "batch"
        data = {"params": {"checkpoint": str(checkpoint)},
                "entries": [{"prompt": p, "seed": i} for i, p in enumerate(
                    ["church bells", "electronic beats", "violin concerto", "lofi hip hop",
                     "acoustic folk", "techno"])]}
        manifest = run("text_to_audio_batch.run_batch, 6 entries", 5 * e_txt, 5 * e_txt,
                       lambda: text_to_audio_batch.run_batch(data, device="cuda",
                                                             output_dir=batch_dir))
        for record in manifest:
            _check_clip(f"batch entry {record['index']}", record["_image_obj"],
                        record["_segment_obj"])
        if len(json.loads((batch_dir / "index.json").read_text())) != 6:
            raise AssertionError("the batch page's index.json does not list 6 entries")

        clip = run("text_to_audio.generate_clips (run_txt2img), 1 clip", 10 * e_txt, 0,
                   lambda: list(text_to_audio.generate_clips(
                       "funky synth solo", checkpoint=str(checkpoint), device="cuda")))
        _check_clip("text-to-audio clip", clip[0][1], clip[0][2])

        params_og = image_to_audio.params_from_image(og_beat)
        audio = run("og_beat to audio (the image-to-audio page)", 0, 0,
                    lambda: st_util.audio_segment_from_spectrogram_image(
                        image=og_beat, params=params_og, device="cuda"))
        _check_clip("image-to-audio", og_beat, audio)
    finally:
        for cached in (st_util.load_riffusion_checkpoint, st_util.spectrogram_image_converter):
            # an lru_cache without streamlit, st.cache_resource with it
            (getattr(cached, "cache_clear", None) or cached.clear)()
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"counts": counts, "runs": runs}


# ------------------------------------------------------------------ parallel


PARALLEL_RANKS = 2  # ranks that share cuda:0 over gloo (NCCL takes one rank per card)
PARALLEL_TIMEOUT_S = 400.0  # a world, or a collective in it, that takes longer fails
# random:full in bf16: the bound on a decoded image's rel L2 (as float) against the same request
# run on one device, unsharded (bf16 GEMMs of other shapes round otherwise, and the 50 steps
# carry it; the tp request measured 7.76e-3 on the H100)
PARALLEL_FULL_REL_L2 = 2e-2


def _tiny_cuda_pipe(torch):
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    return RiffusionPipeline(random_bundle("tiny", seed=0, device="cuda", dtype=torch.float32),
                             device="cuda")


def _tiny_requests(n: int):
    """phase 7's requests: guidance 1.5-1.9, 10 steps at strength 0.75."""
    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput

    return [InferenceInput(start=PromptInput(prompt=f"church bells {i}", seed=i,
                                             guidance=1.5 + 0.1 * i),
                           end=PromptInput(prompt="techno", seed=10 + i, guidance=1.5),
                           alpha=0.2 * i, num_inference_steps=10) for i in range(n)]


def _tiny_setup(size: int, n: int, seed: int):
    """(seed image, params, one FixedNoise per request, their draws) at
    `size` px."""
    import numpy as np
    from PIL import Image

    from riffusion_tpu_torch.riffusion_pipeline import FixedNoise
    from riffusion_tpu_torch.spectrogram_converter import SpectrogramConverter
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

    rng = np.random.default_rng(seed)
    image = Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8), mode="RGB")
    params = SpectrogramParams(num_frequencies=size)
    n_active = SpectrogramConverter(params, device="cpu").n_active
    latent = (1, 4, size // 8, size // 8)
    draws = [{"vae_eps": rng.standard_normal(latent), "noise_a": rng.standard_normal(latent),
              "noise_b": rng.standard_normal(latent), "gl_real": rng.random((1, n_active, size)),
              "gl_imag": rng.random((1, n_active, size))} for _ in range(n)]
    return image, params, [FixedNoise(d) for d in draws], draws


def _counted(torch, attn, fn):
    """(fn(), (K1, K2, plain) launches of its run): the counts are set to 0
    just before and read just after."""
    attn.COUNTS.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, (attn.COUNTS.launches, attn.COUNTS.row_launches, attn.COUNTS.plain_calls)


def _agree(what: str, ours, refs) -> list:
    """Phase 6's image bound for each pair: within one uint8 level on at
    least 99% of pixels."""
    agreement = [_image_agreement(a, b) for a, b in zip(ours, refs)]
    if len(agreement) != len(refs) or any(m > 1 or e < 0.99 for e, m in agreement):
        raise AssertionError(f"{what} disagrees with the single-device run: {agreement}")
    return [(round(e, 6), m) for e, m in agreement]


def _parallel_tiny(torch, attn, world: int) -> dict:
    """The tiny model in fp32 in this world against the single-device runs
    on the card, with the same noise: riffuse_audio_tp over every rank at a
    256 px seed, riffuse_audio_batch(mesh) of 6 requests at 512 px (UNet
    batch 12 in all, so the seq-4096 sites take K2 where a rank's share is
    at or below 8), a FrameSweep of 2 * world alphas at 256 px (K1 only).
    Each one's (K1, K2, plain) launches equal the single-device run's,
    which routes at the same batch."""
    from riffusion_tpu_torch.parallel.mesh import make_mesh
    from riffusion_tpu_torch.parallel.sweep import FrameSweep
    from riffusion_tpu_torch.parallel.tp_serving import riffuse_audio_tp
    from riffusion_tpu_torch.riffusion_pipeline import FixedNoise

    pipe = _tiny_cuda_pipe(torch)
    model = make_mesh((world,), ("model",))
    data = make_mesh((world,), ("data",))
    out, counts = {}, {"attention": 0, "row_attention": 0}

    def check(what, run, reference, images):
        ref, ref_counts = _counted(torch, attn, reference)
        got, got_counts = _counted(torch, attn, run)
        if got_counts != ref_counts or got_counts[2] != 0 or got_counts[0] == 0:
            raise AssertionError(f"{what}: (K1, K2, plain) launches {got_counts}, the "
                                 f"single-device run's {ref_counts}")
        out[what] = {"launches": got_counts, "agreement": _agree(what, images(got), images(ref))}
        counts["attention"] += got_counts[0]
        counts["row_attention"] += got_counts[1]
        return got_counts

    image, params, noises, _ = _tiny_setup(256, 1, 2)
    request = _tiny_requests(1)[0]
    check(f"riffuse_audio_tp, tp {world}, 256 px",
          lambda: riffuse_audio_tp(pipe, request, image, model, params=params, noise=noises[0]),
          lambda: pipe.riffuse_audio(request, image, params=params, noise=noises[0]),
          lambda r: [r[0]])

    n = 6
    image, params, noises, _ = _tiny_setup(512, n, 3)
    requests = _tiny_requests(n)
    got = check(f"riffuse_audio_batch of {n}, data {world}, 512 px",
                lambda: pipe.riffuse_audio_batch(requests, image, params=params, mesh=data,
                                                 noises=noises),
                lambda: pipe.riffuse_audio_batch(requests, image, params=params, noises=noises),
                lambda r: [im for im, _ in r])
    if got[1] == 0:
        raise AssertionError("the sharded batch did not route its seq-4096 sites to K2")

    image, _, _, draws = _tiny_setup(256, 1, 4)
    sweep = dict(prompt_start="church bells", prompt_end="techno", seed_start=1, seed_end=2,
                 init_image=image, alphas=[i / (2 * world - 1) for i in range(2 * world)],
                 num_inference_steps=10, guidance_start=1.5, guidance_end=1.9)
    sweep_noise = FixedNoise({k: draws[0][k] for k in ("vae_eps", "noise_a", "noise_b")})
    got = check(f"FrameSweep of {2 * world} alphas, data {world}, 256 px",
                lambda: FrameSweep(pipe, data).interpolate(**sweep, noise=sweep_noise),
                lambda: FrameSweep(pipe).interpolate(**sweep, noise=sweep_noise),
                lambda frames: list(frames))
    if got[1] != 0:
        raise AssertionError("the frame sweep reached K2")
    return {"checks": out, "counts": counts}


def _rel_l2(ours, ref) -> float:
    import numpy as np

    a, b = (np.asarray(x, np.float64) for x in (ours, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _parallel_full(torch, attn, world: int) -> dict:
    """random:full (bf16) in this world: one 50-step riffuse_audio_tp
    request (K1 exactly 10 per UNet evaluation, at the rank's 8 / world
    heads) and one FAST batch of 16 split over the ranks (K2 and K1 5*E
    each, routed at the global UNet batch of 32). Each decoded image is
    held to PARALLEL_FULL_REL_L2 against the same request on one device,
    unsharded (the tp request against riffuse_audio, the batch's 16
    against the unsharded batch)."""
    from PIL import Image

    from riffusion_tpu_torch.datatypes import InferenceInput
    from riffusion_tpu_torch.parallel.mesh import make_mesh
    from riffusion_tpu_torch.parallel.tp_serving import riffuse_audio_tp
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.serving import FAST_PRESET
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.util.dataclass_util import from_dict

    t0 = time.perf_counter()
    pipe = RiffusionPipeline.load_checkpoint("random:full", device="cuda")
    load_s = time.perf_counter() - t0
    model = make_mesh((world,), ("model",))
    data = make_mesh((world,), ("data",))
    seed = Image.open(REPO / "seed_images" / "og_beat.png").convert("RGB")
    params = SpectrogramParams(min_frequency=0, max_frequency=10000, num_frequencies=512)
    request = from_dict(InferenceInput, _request(0))

    # the single-device output of the same request, the same draws (its seeds)
    ref, _ = _counted(torch, attn, lambda: pipe.riffuse_audio(request, seed, params=params))
    t0 = time.perf_counter()
    (image, segment), tp_counts = _counted(
        torch, attn, lambda: riffuse_audio_tp(pipe, request, seed, model, params=params))
    tp_s = time.perf_counter() - t0
    if tp_counts != (LAUNCHES_PER_REQUEST, 0, 0):
        raise AssertionError(f"riffuse_audio_tp: (K1, K2, plain) launches {tp_counts}, expected "
                             f"{(LAUNCHES_PER_REQUEST, 0, 0)}")
    _check_clip("riffuse_audio_tp", image, segment)
    rel_l2 = _rel_l2(image, ref[0])
    if not rel_l2 < PARALLEL_FULL_REL_L2:
        raise AssertionError(f"riffuse_audio_tp: decoded image rel L2 {rel_l2:.4e} against the "
                             f"single-device output, bound {PARALLEL_FULL_REL_L2}")

    e_fast = pipe._plan(FAST_PRESET["scheduler"], FAST_PRESET["steps"], 0.75)[0].num_steps
    batch = [from_dict(InferenceInput, {**_request(i), "num_inference_steps": FAST_PRESET["steps"]})
             for i in range(16)]
    unsharded = pipe.riffuse_audio_batch(batch, seed, params=params,
                                         scheduler=FAST_PRESET["scheduler"])
    t0 = time.perf_counter()
    results, dp_counts = _counted(torch, attn, lambda: pipe.riffuse_audio_batch(
        batch, seed, params=params, mesh=data, scheduler=FAST_PRESET["scheduler"]))
    dp_s = time.perf_counter() - t0
    if dp_counts != (5 * e_fast, 5 * e_fast, 0):
        raise AssertionError(f"sharded FAST batch: (K1, K2, plain) launches {dp_counts}, "
                             f"expected {(5 * e_fast, 5 * e_fast, 0)}")
    if len(results) != 16:
        raise AssertionError(f"the sharded batch returned {len(results)} clips")
    for i, (im, seg) in enumerate(results):
        _check_clip(f"sharded FAST batch item {i}", im, seg)
    dp_rel_l2 = [_rel_l2(im, ref_im) for (im, _), (ref_im, _) in zip(results, unsharded)]
    if not max(dp_rel_l2) < PARALLEL_FULL_REL_L2:
        raise AssertionError(f"sharded FAST batch: decoded images' rel L2 against the unsharded "
                             f"batch {dp_rel_l2}, bound {PARALLEL_FULL_REL_L2}")
    return {"load_s": load_s, "tp_s": tp_s, "tp_launches": tp_counts, "tp_rel_l2": rel_l2,
            "dp_s": dp_s, "dp_launches": dp_counts, "e_fast": e_fast,
            "dp_rel_l2_max": max(dp_rel_l2),
            "counts": {"attention": tp_counts[0] + dp_counts[0],
                       "row_attention": tp_counts[1] + dp_counts[1]}}


def _parallel_rank(rank: int, world: int, job: str) -> dict:
    """One rank of the parallel phase's worlds (parallel.mesh.spawn_world)."""
    import torch

    from riffusion_tpu_torch.ops import attention as attn

    if job == "gloo":
        return {"tiny": _parallel_tiny(torch, attn, world),
                "full": _parallel_full(torch, attn, world)}
    return {"tiny": _parallel_tiny(torch, attn, world)}  # the NCCL world of one


def phase_parallel(torch, attn) -> dict:
    """Multi-device serving in worlds of processes on the one card: two
    gloo ranks sharing cuda:0 (the tiny checks, then random:full), a world
    of one on NCCL (the tiny checks), and the CPU dryrun as a command."""
    from riffusion_tpu_torch.parallel.mesh import spawn_world

    torch.cuda.empty_cache()
    counts = {"attention": 0, "row_attention": 0}
    worlds = {}
    for backend, world in (("gloo", PARALLEL_RANKS), ("nccl", 1)):
        t0 = time.perf_counter()
        ranks = spawn_world(_parallel_rank, world, (backend,), backend=backend,
                            timeout_s=PARALLEL_TIMEOUT_S)
        worlds[backend] = ranks
        log(f"[parallel] {backend} world of {world} on cuda:0: "
            f"{time.perf_counter() - t0:.1f} s with its start")
        for rank, out in enumerate(ranks):
            for what, check in out["tiny"]["checks"].items():
                log(f"[parallel] {backend} rank {rank}: tiny {what}: (K1, K2, plain) launches "
                    f"{check['launches']}, against the single-device run (pixels equal, max "
                    f"diff) {check['agreement']}")
            parts = [out["tiny"]]
            if "full" in out:
                full = out["full"]
                parts.append(full)
                log(f"[parallel] {backend} rank {rank}: random:full loaded in "
                    f"{full['load_s']:.2f} s; riffuse_audio_tp (pndm-50, tp {world}) "
                    f"{full['tp_s']:.3f} s, (K1, K2, plain) launches {full['tp_launches']}, "
                    f"decoded image rel L2 {full['tp_rel_l2']:.4e} against the single-device "
                    f"output; FAST batch of 16 over data {world} (E = {full['e_fast']}) "
                    f"{full['dp_s']:.3f} s, launches {full['dp_launches']}, decoded images' "
                    f"largest rel L2 {full['dp_rel_l2_max']:.4e} against the unsharded batch "
                    f"(bound {PARALLEL_FULL_REL_L2}); every clip checked (ranks share one "
                    "card: not a scaling number)")
            for part in parts:
                for name in counts:
                    counts[name] += part["counts"][name]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "riffusion_tpu_torch.parallel.dryrun", "--n",
                           str(PARALLEL_RANKS)], cwd=REPO, capture_output=True, text=True,
                          timeout=PARALLEL_TIMEOUT_S)
    log(f"[parallel] python -m riffusion_tpu_torch.parallel.dryrun --n {PARALLEL_RANKS}: exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.1f} s: "
        + " | ".join(proc.stdout.strip().splitlines()))
    if proc.returncode != 0:
        raise AssertionError(f"the dryrun failed:\n{proc.stderr[-3000:]}")
    return {"counts": counts}


# ------------------------------------------------------------- parallel-train


PARALLEL_TRAIN_MESHES = ((2, 1, 1), (1, 2, 1), (1, 1, 2))  # (data, model, seq) on two ranks
MESH_AXES = ("data", "model", "seq")
# The tiny step at (1, 1, 1) on NCCL against the unsharded step, fp32 with
# TF32 off: the same modules, the loss a sum over the count instead of a
# mean, whose backward rounds the scale otherwise. On the H100 the two
# differ by 6.0e-7 to 6.2e-7 and the unsharded step by as much from itself
# (cuDNN's fp32 backward need not repeat its sums), so the phase prints that
# floor (the unsharded step run twice) and bounds the gradients at 1e-5.
NCCL_TINY_BOUND = {"grad_rel_l2": 1e-5, "loss_rel": 1e-6}


def _step_counts(attn) -> tuple:
    return (attn.COUNTS.launches, attn.COUNTS.bwd_dkv_launches, attn.COUNTS.bwd_dq_launches,
            attn.COUNTS.plain_calls)


def _replicated_checksum(torch, trainer) -> list:
    """Two int64 sums of the replicated parameters' bit patterns (plain and
    weighted by position), equal on every rank exactly when the bits are."""
    from riffusion_tpu_torch.parallel.train import param_spec

    plain = weighted = 0
    for name, p in trainer.master.named_parameters():
        if param_spec(name, p) is None or trainer._axis("model") is None:
            bits = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
            plain += int(bits.sum())
            weighted += int((bits * torch.arange(1, bits.numel() + 1, device=bits.device)).sum())
    return [plain, weighted]


def _grad_rel_l2(torch, trainer, want: dict) -> float:
    """Relative L2 of the masters' gradients (this rank's cut) against
    `want` (the same cut of the unsharded step's)."""
    diff = norm = 0.0
    for name, p in trainer.master.named_parameters():
        diff += float(torch.sum(torch.square(p.grad - want[name])))
        norm += float(torch.sum(torch.square(want[name])))
    return (diff / norm) ** 0.5


def _parallel_train_meshes(torch, attn) -> dict:
    """random:full with fp32 masters and bf16 compute at batch 4 on 64x64x4
    latents: the unsharded step's loss and gradients, then for each mesh of
    PARALLEL_TRAIN_MESHES two steps (AdamW at lr 1e-5) from the same weights
    on the same batch, t and noise. The first step's loss and this rank's
    gradients against the unsharded step's (TRAIN_GRAD_BOUND), its launches
    (exactly 10 K1, 10 dK/dV, 10 dQ, no plain call, on every step), finite
    parameters after it and a checksum of the replicated ones; the second
    step's seconds; the peak memory."""
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.parallel.mesh import make_mesh
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer, shard_state

    dev = torch.device("cuda")
    unet = random_bundle("full", seed=0, device=dev, dtype=torch.float32).unet
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = dict(latents=torch.randn(4, 64, 64, 4, generator=gen, device=dev),
                 context=torch.randn(4, 77, 768, generator=gen, device=dev),
                 t=torch.randint(0, 1000, (4,), generator=gen, device=dev),
                 noise=torch.randn(4, 64, 64, 4, generator=gen, device=dev))
    ref = DiffusionTrainer(device=dev, learning_rate=0.0, dtype=torch.bfloat16)
    ref.init_from(unet)
    attn.COUNTS.reset()
    ref_loss = float(ref.loss_and_grads(**batch))
    ref_counts = _step_counts(attn)
    ref_grads = {n: p.grad for n, p in ref.master.named_parameters()}
    del ref
    torch.cuda.empty_cache()
    out = {"ref_loss": ref_loss, "ref_counts": ref_counts, "meshes": {},
           "counts": {"attention": 0, "attention_dkv": 0, "attention_dq": 0}}
    for shape in PARALLEL_TRAIN_MESHES:
        trainer = DiffusionTrainer(device=dev, learning_rate=1e-5, dtype=torch.bfloat16,
                                   mesh=make_mesh(shape, MESH_AXES))
        trainer.init_from(unet)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts, seconds = [], []
        for step in range(2):
            attn.COUNTS.reset()
            start = time.perf_counter()
            loss = float(trainer.step(**batch))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
            counts.append(_step_counts(attn))
            if step == 0:
                rel_l2 = _grad_rel_l2(torch, trainer, shard_state(ref_grads, trainer.mesh))
                first_loss = loss
                finite = all(bool(torch.isfinite(p).all()) for p in trainer.master.parameters())
                checksum = _replicated_checksum(torch, trainer)
        out["meshes"][shape] = {
            "loss": first_loss, "loss_rel": abs(first_loss - ref_loss) / abs(ref_loss),
            "grad_rel_l2": rel_l2, "counts": counts, "finite": finite, "checksum": checksum,
            "seconds": seconds, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        for c in counts:
            for i, name in enumerate(out["counts"]):
                out["counts"][name] += c[i]
        del trainer
        torch.cuda.empty_cache()
    del ref_grads, unet
    torch.cuda.empty_cache()
    return out


def _parallel_finetune(torch, attn, checkpoint: str, dataset: str, output: str) -> dict:
    """run_finetune(mesh_shape=(2, 1, 1)) of 2 steps at batch 4 from the
    checkpoint directory on this rank: each step's launches and seconds."""
    from riffusion_tpu_torch.training import FinetuneConfig, run_finetune

    marks = []

    def on_log(msg: str) -> None:
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), _step_counts(attn), msg))

    torch.cuda.reset_peak_memory_stats()
    attn.COUNTS.reset()
    start = time.perf_counter()
    stats = run_finetune(FinetuneConfig(
        checkpoint=checkpoint, dataset_dir=dataset, output_dir=output, steps=2, batch_size=4,
        log_every=1, mesh_shape=(2, 1, 1), device="cuda"), log=on_log)
    steps = [m for m in marks if m[2].startswith("step ")]
    return {"wall": time.perf_counter() - start, "final_loss": stats["final_loss"],
            "per_step": [tuple(b - a for a, b in zip(prev[1], cur[1]))
                         for prev, cur in zip([(0, (0, 0, 0, 0), "")] + steps, steps)],
            "step_s": [b[0] - a[0] for a, b in zip(steps, steps[1:])],
            "checkpoint": stats["checkpoint"], "export_dir": stats["export_dir"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _parallel_train_tiny(torch, attn) -> dict:
    """The tiny UNet in fp32 on 32x32 latents at batch 2 (K1 and its
    backward reached): the sharded step at (1, 1, 1) against the unsharded
    step on the same batch and draws."""
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.parallel.mesh import make_mesh
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer

    dev = torch.device("cuda")
    unet = random_bundle("tiny", seed=0, device=dev).unet
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = dict(latents=torch.randn(2, 32, 32, 4, generator=gen, device=dev),
                 context=torch.randn(2, 77, 64, generator=gen, device=dev),
                 t=torch.randint(0, 1000, (2,), generator=gen, device=dev),
                 noise=torch.randn(2, 32, 32, 4, generator=gen, device=dev))
    runs = []
    for mesh in (None, None, make_mesh((1, 1, 1), MESH_AXES)):
        trainer = DiffusionTrainer(device=dev, dtype=torch.float32, mesh=mesh)
        trainer.init_from(unet)
        attn.COUNTS.reset()
        loss = float(trainer.loss_and_grads(**batch))
        torch.cuda.synchronize()
        runs.append((loss, {n: p.grad for n, p in trainer.master.named_parameters()},
                     _step_counts(attn)))
    (ref_loss, ref_grads, ref_counts), again, (loss, grads, counts) = runs

    def rel_l2(other: dict) -> float:
        diff = sum(float(torch.sum(torch.square(other[n] - g))) for n, g in ref_grads.items())
        return (diff / sum(float(torch.sum(torch.square(g))) for g in ref_grads.values())) ** 0.5

    return {"loss_rel": abs(loss - ref_loss) / abs(ref_loss), "grad_rel_l2": rel_l2(grads),
            "floor": rel_l2(again[1]), "counts": counts, "ref_counts": ref_counts}


def _parallel_train_rank(rank: int, world: int, job: str, checkpoint: str, dataset: str,
                         output: str) -> dict:
    """One rank of the parallel-train phase's worlds (parallel.mesh.spawn_world)."""
    import torch

    from riffusion_tpu_torch.ops import attention as attn

    if job == "nccl":
        return {"tiny": _parallel_train_tiny(torch, attn)}
    return {"meshes": _parallel_train_meshes(torch, attn),
            "finetune": _parallel_finetune(torch, attn, checkpoint, dataset, output)}


def phase_parallel_train(torch, attn, checkpoint: Path, dataset: Path) -> dict:
    """The sharded fine-tuning step in worlds of processes on the one card:
    two gloo ranks sharing cuda:0 (random:full at each mesh against the
    unsharded step, then run_finetune at mesh_shape (2, 1, 1) from the
    checkpoint directory, its export reloaded here and served), and a world
    of one on NCCL (the tiny step at (1, 1, 1)). Two ranks on one card give
    no scaling number."""
    import numpy as np

    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.parallel.mesh import spawn_world
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.serving import load_seed_image

    gc.collect()
    torch.cuda.empty_cache()
    output = Path(tempfile.mkdtemp(prefix="parallel-train-", dir=REPO / ".chipwork"))
    counts = {"attention": 0, "attention_dkv": 0, "attention_dq": 0}
    try:
        start = time.perf_counter()
        ranks = spawn_world(_parallel_train_rank, PARALLEL_RANKS,
                            ("gloo", str(checkpoint), str(dataset), str(output)),
                            backend="gloo", timeout_s=PARALLEL_TIMEOUT_S)
        log(f"[parallel-train] gloo world of {PARALLEL_RANKS} on cuda:0: "
            f"{time.perf_counter() - start:.1f} s with its start")
        checksums = {}
        for rank, out in enumerate(ranks):
            meshes = out["meshes"]
            log(f"[parallel-train] rank {rank}: random:full unsharded step: loss "
                f"{meshes['ref_loss']:.6f}, (K1, dK/dV, dQ, plain) launches {meshes['ref_counts']}")
            for shape, m in meshes["meshes"].items():
                log(f"[parallel-train] rank {rank}: mesh {shape}: loss {m['loss']:.6f} (rel "
                    f"{m['loss_rel']:.3e}), this rank's gradients rel L2 {m['grad_rel_l2']:.3e} "
                    f"against the unsharded step's (bound {TRAIN_GRAD_BOUND}); (K1, dK/dV, dQ, "
                    f"plain) launches per step {m['counts']}; step seconds "
                    f"{[f'{x:.4f}' for x in m['seconds']]} (the second is the step time); peak "
                    f"device memory {m['peak_gib']:.2f} GiB")
                if m["counts"] != [(LAUNCHES_PER_STEP,) * 3 + (0,)] * 2:
                    raise AssertionError(f"mesh {shape}: launches {m['counts']} are not "
                                         f"{LAUNCHES_PER_STEP} K1, dK/dV and dQ and no plain call")
                if not (m["grad_rel_l2"] <= TRAIN_GRAD_BOUND["grad_rel_l2"]
                        and m["loss_rel"] <= TRAIN_GRAD_BOUND["loss_rel"]):
                    raise AssertionError(f"mesh {shape}: the sharded step disagrees with the "
                                         "unsharded one")
                if not m["finite"]:
                    raise AssertionError(f"mesh {shape}: non-finite parameters after AdamW")
                checksums.setdefault(shape, set()).add(tuple(m["checksum"]))
            for name in counts:
                counts[name] += meshes["counts"][name]
            ft = out["finetune"]
            log(f"[parallel-train] rank {rank}: run_finetune(mesh_shape=(2, 1, 1)), 2 steps at "
                f"batch 4 from the checkpoint directory, in {ft['wall']:.2f} s wall; step "
                f"seconds {[f'{x:.4f}' for x in ft['step_s']]}; final loss "
                f"{ft['final_loss']:.5f}; (K1, dK/dV, dQ, plain) launches per step "
                f"{ft['per_step']}; peak device memory {ft['peak_gib']:.2f} GiB; checkpoint "
                f"{ft['checkpoint']['bytes'] / 1e9:.3f} GB in {ft['checkpoint']['seconds']:.2f} s")
            if ft["per_step"] != [(LAUNCHES_PER_STEP,) * 3 + (0,)] * 2:
                raise AssertionError(f"run_finetune's steps launched {ft['per_step']}")
            if not np.isfinite(ft["final_loss"]):
                raise AssertionError("run_finetune's loss is not finite")
            for i, name in enumerate(counts):
                counts[name] += sum(c[i] for c in ft["per_step"])
        for shape, sums in checksums.items():
            log(f"[parallel-train] mesh {shape}: replicated parameters after AdamW "
                f"{'equal' if len(sums) == 1 else 'DIFFERENT'} on both ranks (checksums {sums})")
            if len(sums) != 1:
                raise AssertionError(f"mesh {shape}: the replicated parameters differ by rank")

        export = ranks[0]["finetune"]["export_dir"]
        start = time.perf_counter()
        tuned = RiffusionPipeline.load_checkpoint(export, device="cuda")
        attn.COUNTS.reset()
        image, segment = tuned.riffuse_audio(
            InferenceInput(start=PromptInput(prompt="funky synth solo", seed=42),
                           end=PromptInput(prompt="jazzy saxophone", seed=123), alpha=0.5),
            load_seed_image(REPO / "seed_images", "og_beat"))
        torch.cuda.synchronize()
        sampler = tuned.bundle.scheduler_name
        expected = 10 * tuned._plan(sampler, 50, 0.75)[0].num_steps
        log(f"[parallel-train] the sharded run's export reloaded and one 50-step request "
            f"riffused ({sampler}) in {time.perf_counter() - start:.2f} s; K1 launches "
            f"{attn.COUNTS.launches} ({expected} expected)")
        _check_clip("the sharded fine-tune's export", image, segment)
        if attn.COUNTS.launches != expected:
            raise AssertionError("the sharded fine-tune's export did not serve through K1")
        del tuned
    finally:
        shutil.rmtree(output, ignore_errors=True)
        torch.cuda.empty_cache()

    start = time.perf_counter()
    tiny = spawn_world(_parallel_train_rank, 1, ("nccl", "", "", ""), backend="nccl",
                       timeout_s=PARALLEL_TIMEOUT_S)[0]["tiny"]
    log(f"[parallel-train] nccl world of 1: the tiny step at (1, 1, 1) against the unsharded "
        f"step: loss rel {tiny['loss_rel']:.3e}, gradients rel L2 {tiny['grad_rel_l2']:.3e} "
        f"(bound {NCCL_TINY_BOUND}; the unsharded step against itself {tiny['floor']:.3e}); "
        f"(K1, dK/dV, dQ, plain) launches {tiny['counts']} "
        f"(unsharded {tiny['ref_counts']}); {time.perf_counter() - start:.1f} s with its start")
    if tiny["counts"] != tiny["ref_counts"] or tiny["counts"][0] == 0 or tiny["counts"][3]:
        raise AssertionError("the tiny sharded step's launches differ from the unsharded one's")
    if not (tiny["grad_rel_l2"] <= NCCL_TINY_BOUND["grad_rel_l2"]
            and tiny["loss_rel"] <= NCCL_TINY_BOUND["loss_rel"]):
        raise AssertionError("the tiny sharded step on NCCL disagrees with the unsharded one")
    return {"counts": counts}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="On-card smoke test of the PyTorch port.")
    parser.add_argument("--mutants", action="store_true",
                        help="instead of the smoke: build each planted fault of the kernel "
                             "body (MUTANTS) and show that the kernel check rejects it")
    args = parser.parse_args(argv)

    import torch

    smi, clock_hz = phase_card(torch)
    sys.path.insert(0, str(REPO))
    from riffusion_tpu_torch.ops import attention as attn
    from riffusion_tpu_torch.util import torch_util

    torch_util.configure_numerics()
    phase_build(attn)
    if args.mutants:
        phase_mutants(torch, attn)
        log(f"[mutants] every one of {len(MUTANTS)} mutants was rejected by the checks of every "
            "kernel it touches")
        return 0

    # the text-embedding disk cache of every pipeline below stays in the
    # checkout and goes at the end
    work = REPO / ".chipwork"
    work.mkdir(exist_ok=True)
    embeds = Path(tempfile.mkdtemp(prefix="embeds-", dir=work))
    os.environ["RIFFUSION_TPU_EMBED_CACHE_DIR"] = str(embeds)
    try:
        return _smoke(torch, attn, smi, clock_hz, work)
    finally:
        shutil.rmtree(embeds, ignore_errors=True)


def phase(name: str, fn, *args):
    """fn(*args), with its seconds printed."""
    start = time.perf_counter()
    result = fn(*args)
    log(f"[time] {name}: {time.perf_counter() - start:.1f} s")
    return result


def _smoke(torch, attn, smi: str, clock_hz: float, work: Path) -> int:
    """Every phase after the build, then the kernels line and the result."""
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    kernel = phase("kernel", phase_kernel, torch, attn, clock_hz)
    grad = phase("kernel-grad", phase_kernel_grad, torch, attn, clock_hz)
    phase("dsp", phase_dsp, torch)
    phase("tiny", phase_tiny, torch, attn)
    phase("tiny batch", phase_tiny_batch, torch, attn)
    phase("tiny train", phase_tiny_train, torch, attn)

    start = time.perf_counter()
    pipe = RiffusionPipeline.load_checkpoint("random:full", device="cuda")
    torch.cuda.synchronize()
    log(f"[slice] random:full (UNet/CLIP bf16, VAE fp32) built on the card in "
        f"{time.perf_counter() - start:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    single = phase("slice", phase_slice, torch, attn, pipe)
    batch = phase("batch", phase_batch, torch, attn, pipe)
    modes = phase("modes", phase_modes, torch, attn, pipe)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="checkpoint-", dir=work))
    data_dir = Path(tempfile.mkdtemp(prefix="dataset-", dir=work))
    try:
        ckpt = phase("checkpoint", phase_checkpoint, torch, attn, pipe, ckpt_dir)
        # random:full's weights are freed before the fine-tune (the batch
        # phase's DynamicBatcher and its threads form a cycle, hence collect)
        held = sum(t.numel() * t.element_size()
                   for m in _modules(pipe).values() for t in m.state_dict().values())
        before = torch.cuda.memory_allocated()
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        freed = before - torch.cuda.memory_allocated()
        log(f"[checkpoint] dropping random:full's pipeline freed {freed} bytes of device "
            f"memory; its weights hold {held}")
        if freed < held:
            raise AssertionError("random:full's pipeline was not freed when it was dropped")
        train = phase("train", phase_train, torch, attn, ckpt["pipe"], ckpt_dir, data_dir)
        del ckpt["pipe"]
        gc.collect()
        cli_run = phase("cli", phase_cli, torch, attn, ckpt_dir)
        frontends = phase("frontends", phase_frontends, torch, attn, ckpt_dir)
        parallel_train = phase("parallel-train", phase_parallel_train, torch, attn, ckpt_dir,
                               data_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(data_dir, ignore_errors=True)
    parallel = phase("parallel", phase_parallel, torch, attn)

    times, grad_times = kernel["times"], grad["times"]
    b, s, _, d = BATCH_SHAPE
    tb, ts, th, td = TRAIN_SHAPES[0]
    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    entries = [  # name, source, replaces, ms, plain_ms, (bound ms, by), library_ms, launches
        ("attention", "attention.cu",
         f"{flash}:589 _flash_attention_impl (called from riffusion_tpu/models/layers.py:251)",
         times[("attention", 2, 4096, 40)], times[("plain", 2, 4096, 40)],
         times[("bound", 2, 4096, 40)], times[("library", 2, 4096, 40)],
         single["attention"] + batch["counts"]["attention"] + modes["counts"]["attention"]
         + ckpt["launches"] + train["launches"]["attention"] + cli_run["counts"]["attention"]
         + frontends["counts"]["attention"] + parallel["counts"]["attention"]
         + parallel_train["counts"]["attention"]),
        ("row_attention", "row_attention.cu",
         "riffusion_tpu/ops/attention.py:114 _forward (full_row_attention)",
         times[("row_attention", b, s, d)], times[("plain", b, s, d)],
         times[("bound", b, s, d)], times[("library", b, s, d)],
         single["row_attention"] + batch["counts"]["row_attention"]
         + modes["counts"]["row_attention"] + cli_run["counts"]["row_attention"]
         + frontends["counts"]["row_attention"] + parallel["counts"]["row_attention"]),
    ] + [
        # the plain and library times are of the whole backward (dQ, dK, dV)
        (name, f"{name}.cu", f"{flash}:{line} {fn}", grad_times[(name, tb, ts, ts, th, td)],
         grad_times[("plain backward", tb, ts, ts, th, td)],
         grad_times[("bound " + name, tb, ts, ts, th, td)],
         grad_times[("library backward", tb, ts, ts, th, td)],
         train["launches"][name] + parallel_train["counts"][name])
        for name, line, fn in (("attention_dkv", 941, "_flash_attention_bwd_dkv"),
                               ("attention_dq", 1287, "_flash_attention_bwd_dq"))
    ]
    errors = {**kernel, **grad}  # K1's worst over its forward cases and its LSE cases
    errors["attention"] = {k: max(kernel["attention"][k], grad["attention"][k])
                           for k in ("max_abs_err", "rel_rms_err")}
    log(smi)
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"riffusion_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": errors[name]["max_abs_err"],
        "rel_rms_err": errors[name]["rel_rms_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": library_ms,
    } for name, source, replaces, ms, plain_ms, bound, library_ms, launches in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
