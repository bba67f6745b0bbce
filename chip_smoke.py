#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py                   # what a check of the port runs
    python3 chip_smoke.py --parent DIR      # + an A/B against another tree

``--parent`` takes the root of another checkout (the parent commit unpacked
with ``git archive`` into a git-ignored directory); its package is imported
beside this one as ``ev_parent`` and its K1-K5 and GPT decode are timed in
turns with this tree's on the same inputs (lines "[a/b]"; K1's serving
output, K3 and K4-dx also compared bit for bit, K3 and K4-dx by SASS, K4-dW
per Generator stage, K5 over the two s1 shapes, its fp32 gradients bit for
bit and its bf16 instance held to the twin beside the parent's; the bf16
K1 over the two s1 shapes, held to the twin and to the parent's, also as
CUDA graphs; the bf16 K4-dW per stage held to the parent's; the fp32
dropout K1 and K5 over the two s1 shapes, K1's o and lse and K5's
gradients bit for bit, and the fp32 s1 window with dropout); then
``bench/sass_diff.py`` must find every kernel body of the parent's library
in this tree's, but the fp32 dropout bodies this tree replaces.

Phases, one summary line each; any failure exits non-zero:

1. device: card name, ``nvidia-smi`` name and power limit, TF32 off for
   matmul and cuDNN (every comparison below is full fp32);
2. build: compile the hand-written kernels (``csrc/*.cu``, one nvcc per
   source, sm_90a);
3. kernels: each kernel against its plain PyTorch twin on the same seeded
   inputs at the main paths' shapes (K1-K3 at serving's, K4 at the s2
   step's), max |diff| against the stated tolerance; the device time of the
   kernel, of its twin and of the one PyTorch call that computes the same
   function (SDPA, cuDNN conv / dgrad / wgrad, SDPA's backward), which the
   port never calls,
   each the mean over 20 calls of the CUDA kernel time torch.profiler
   records; and the least time the card could take for the same work (the
   bound, from the bytes moved and the fp32 operations done).  K2 is timed
   cold, over the 24 layers' caches of a decode with the layer rotated on
   every call (the loop reads each layer's cache once a step, far more than
   the 50 MB L2 holds), at steps 0, 500 and the last slot, and warm on one
   layer beside it.  K3 and both K4 entry points are summed per Generator
   stage beside cuDNN, K4-dW with the split of its B*T sum for each shape
   (and the clusters the occupancy query promises beside those a
   cooperative launch accepts) and the count of tensor-core instructions in
   its SASS.  K1 writing its row logsumexp and K5, its gradient, at the two
   s1 micro-batch shapes (B=8, 416 phonemes, 300 and 1360 tokens), with
   the count of HMMA instructions in each K5 kernel's SASS; K5 must not be
   slower than SDPA's backward.  K1's head-width-64 instance
   (``encoder_attention``) at the encoders' shapes (BERT, G2PW's BERT,
   HuBERT, Whisper's encoder at T=1500) and its dk-32 instance on the same
   route at CT-punc's shapes, each valid row also run alone, unpadded;
   the dk-64 instance at the Roformers' four axial shapes (H=8, no
   padding: BS-Roformer's 62 band rows of 801 frames and 801 frame rows of
   62 bands, Mel-Band's with 60 bands), each batch row also run alone;
   SDPA alone at Paraformer's dk-128 encoder shapes, which no hand-written
   kernel covers.  Then the bf16 instances of the fine-tunes under
   is_half (``check_bf16``): K1 with its lse and K5 at the two s1 shapes,
   K3, K4-dx and K4-dW at the 45 s2 shapes, each against its bf16 twin
   and at the card tests' tile edges, with its device time beside the fp32
   instance's, the bf16 library call's and the twin's, and its bound in
   bf16 (989 TFLOP/s dense); K1 and K5 bf16 also as CUDA graphs in turns
   with SDPA's bf16 forward and backward captured the same way, and the
   HMMA opcodes of their kernels' SASS (bf16 m16n8k16 alone; no ptxas
   spill in K1's); K4-dW bf16 with its plan per stage
   and the tensor-core opcodes of its wgmma route's SASS (bf16 HGMMA
   alone).  Then the dropout instances of K1 and K5 (``check_dropout``,
   the s1 fine-tune with dropout 0.1), fp32 and bf16, at the two s1 shapes
   against their twins given the same Philox keep mask, the keep rate,
   the keep bits K1 writes equal to ``keep_bits_reference`` bit for bit
   (K5 reads them), the mask read back bit for bit from K1, K5's dkdv and
   K5's dq at T = 1776, each timed beside the instance without dropout,
   the twin and
   SDPA with dropout_p = 0.1 under the same boolean mask, with its bound
   and the RNG's own floor from the Philox instructions in its SASS;
4. serving: ``VoiceCloneService.clone`` at full model width (random weights
   from a seeded ``torch.Generator``, written to .pth files and loaded the way
   a user's trained models are), a synthetic 5 s reference and six English
   sentences; the wav must be finite and non-silent, every weight on the
   card, and K1, K2 and K3 launched during this phase.  Then one prefill
   and 16 decode steps of the same GPT under torch.profiler: K1's and K2's
   device time a launch and the kernels a decode step launches;
5. reference: the same models on the card and on the CPU (where the plain
   twins run) agree on a small input;
6. Chinese serving: a full-width BERT (chinese-roberta-wwm-ext-large's
   widths, a synthesized 21,128-entry vocabulary, seeded random weights
   written as pytorch_model.bin and as model.safetensors, which must load
   equal) and a G2PWModel at bert-base-chinese widths, then
   ``VoiceCloneService.clone`` of five Chinese sentences ("zh") and one
   mixed zh/en sentence ("auto"): finite non-silent wavs, non-zero BERT
   features fed to the GPT, K1 at dk 64 launched 24 times a BERT call and
   12 times a G2PW batch, ``text_preproc`` split into its BERT and G2PW
   parts, BERT's hidden state -3 and G2PW's probabilities on the card
   against the CPU.  Where ``jieba`` does not import, the Chinese runs'
   G2P results come from the table ZH_PINNED (the line "[chinese] route"
   says which);
7. data prep: three seeded 24 s speech-like sources through
   ``AudioService.slicer`` (default parameters), the denoise cmd
   (``python -m easevoice_trainer_tpu_torch.cmd.audio_denoise``) as a
   subprocess with an FRCRN at ``FRCRNConfig()`` (seeded random weights in
   modelscope's key layout, BatchNorm statistics calibrated on one clip),
   the ASR chain over the denoised clips: fsmn-VAD, Paraformer-large and
   CT-punc (FunASR's ``model.pt`` / ``config.yaml`` / ``am.mvn`` /
   ``tokens.json`` layouts) and whisper-small (``model.safetensors``,
   ``config.json``, a synthesized ``tokenizer.json``), seeded random
   weights at the published widths; ``python -m
   easevoice_trainer_tpu_torch.cmd.audio_asr`` as a subprocess (zh, every
   clip, every trace SUCCESS, one ``asr.list`` row a clip), then the cmd's
   ``main`` in-process for zh and for en (two clips) with the launch
   counts (K1 dk 32: 4 a punctuation call; K1 dk 64: 12 a Whisper chunk)
   and the seconds a minute of audio by stage; the card against the CPU on
   the shortest clip (VAD segments, Paraformer encoder output and alphas,
   ids, CT-punc marks; Whisper at 2 + 2 layers, ids and teacher-forced
   logits); then
   a refinement list of mostly zh rows (ZH_PINNED's sentences: random
   weights transcribe nothing meaningful) and two en
   rows, then ``NormalizeService.run()`` at full width (BERT-large,
   HuBERT-base from a ``model.safetensors``-only directory, the s2G of
   configs/s2.json), each stage timed: one 3-bert file a zh row, one
   4-cnhubert and 5-wav32k file a clip, T // 2 codes a row, K1 at dk 64
   launched 24 times a zh row and 12 times a clip.  The folder then trains
   2 s2 steps and 2 s1 micro-batches (finite losses, the s1 batches
   carrying the 3-bert features; is_half at its default, so on the bf16
   instances); on the shortest clip the FRCRN output
   and the SSL features on the card agree with the CPU within 1e-4
   relative and the semantic codes are identical (or each differing
   code's two nearest distances within 1e-4 relative); FRCRN's device
   time by group; K1 at dk 64 against SDPA at these clips' HuBERT shapes
   and at phase 3's, by torch.profiler and by CUDA events, three times
   each.  Where ``jieba`` does not import, each zh row's G2P result comes
   from ZH_PINNED (the line "[data prep] route" says which);
8. uvr5: seeded random weights of the five UVR5 families in their
   released layouts (the VR net at HP5's ch 32 / 16 / 32, DeEcho at nout
   48, MDX-Net at ``MDXConfig()``, ``BSRoformerConfig()``,
   ``MelBandRoformerConfig()``; VR and DeEcho BatchNorms calibrated on
   one clip) under a temporary ``models/uvr5_weights``; ``python -m
   easevoice_trainer_tpu_torch.cmd.audio_uvr5`` as a subprocess with the
   default HP5 over a 10 s and a 4 s stereo 44.1 kHz song-like source
   (every file SUCCESS, stems stereo 44.1 kHz, finite, non-silent, as
   long as the source); ``AudioService.uvr5`` in-process for each family
   on the 10 s source, twice (the first request, then the same again),
   clocked by stage (host analysis, the net's device work, host
   synthesis) with its peak memory, K1 dk-64 launched exactly 24 times a
   BS-Roformer chunk and 12 times a Mel-Band chunk (and nowhere else),
   vocal + instrument = mix for MDX-Net and the Roformers; each net's
   device time on one window or chunk by kernel (K1's share for the
   Roformers), and each net on the card against the CPU on it (the
   Roformers at depth 1), within 1e-4 relative;
9. training: ``SovitsTrain.train()`` at full width (SovitsConfig() and the
   full MPD from seeded random pretrained .pth files, 8 synthetic clips of
   256 frames, batch 8, 12 steps), twice: with is_half at its default (bf16
   compute, K3 and K4's bf16 instances, no fp32 instance launched) and
   with is_half=False (fp32, the other way round); s/step, the first step,
   peak memory and the losses of each; finite losses, every tensor on the
   card and every parameter fp32, every ResBlock ``weight_v`` and upsample
   tensor changed, and the export loads ``strict=True`` into the inference
   build and decodes a finite, non-silent wav; one more bf16 step under
   torch.profiler;
10. reference train step: one step at a small width on the card and on the
   CPU agrees (losses and the ResBlock gradients), in fp32 and in bf16;
11. s1 training: ``GPTTrain.train()`` at full width (T2SConfig from the
   repo's configs/gpt.yaml through the port's YAML reader, a seeded random
   pretrained .ckpt in the export format, 8 synthetic utterances of 250 and
   1300 tokens replicated to 96 items: 12 micro-batches of B=8 at T = 716
   and 1776, 3 ScaledAdam updates), with is_half at its default (bf16, K1
   and K5's bf16 instances) and with is_half=False (fp32): finite losses,
   every tensor and optimizer state on the card, 24 K1 launches and 24 K5
   calls (72 launches) a micro-batch of the run's instances and none of
   the other's, every layer's ``in_proj_weight`` changed, the export loads
   ``strict=True`` into the inference build and decodes; s/micro-batch by
   bucket, first micro-batch, peak memory of each run; one bf16 DPO
   micro-batch (``if_dpo``, B=4 at T = 1776: finite, 2 x 24 K1 and K5 bf16
   calls); and one bf16 accumulation window under torch.profiler by group
   (K1, K5, GEMMs, optimizer, other).  Then one accumulation window (4
   micro-batches of B=24) with ``model.dropout: 0.1`` in bf16 and in
   fp32: finite losses, 24 K1 and 24 K5 dropout calls a micro-batch and no
   launch of an instance without dropout.  Then data parallel
   (``data_parallel``): both fine-tunes in bf16 through ``parallel/``
   (``launch``, the ranks' rows of the global batch, ``reduce_gradients``),
   the s1 window (global B = 8 at T = 716, dropout 0 and 0.1, the GPT at
   full width and DP_LAYERS layers) and 2 s2 steps (global B = 8), in this
   process as the world of one, on two ranks
   sharing the card over gloo (metrics equal across the ranks, weights
   bit-identical, losses and grad norms within 2^-6 of the world of one,
   rank 1's K1 keep bits equal to the world of one's mask at its global
   row) and on an NCCL world of one rank (bit-identical to this process);
   s a micro-batch / step, all-reduce ms (CUDA events) and bytes a step;
   and the bf16 drop rate of ``nn.layers.dropout`` on the card (4.2e6
   draws at p = 0.1, within 6 sigma).  Then tensor parallel
   (``tensor_parallel``): the s1 window through ``parallel/gpt_sharding``
   on two ranks of one model group sharing the card over gloo, at
   configs/gpt.yaml's full width (8 heads and 1024 FFN columns a rank) and
   TP_LAYERS layers, in bf16, fp32 and bf16 with dropout 0.1, and on a
   data 2 x model 2 grid of four ranks at 4 layers in fp32 with dropout
   0.1: metrics
   equal across the ranks, replicated weights bit-identical across each
   model group, metrics and gathered weights against the world of one
   (1e-3 relative in fp32, 2^-6 in bf16; in fp32 at most 1 % of a
   tensor's elements with a window update 25 % off), each rank's K1 / K5
   launches, model index 1's K1 keep bits equal to the world of one's at
   heads 8-15; s a micro-batch, the bytes and ms of the model and data
   groups' all-reduces; K1 and K5 at the local shape H = 8 beside H = 16,
   SDPA and the bound;
12. reference s1 step: one micro-batch at a small width on the card and on
   the CPU agrees (loss and every qkv gradient), in fp32 and in bf16,
   without and with dropout 0.1 (the same masks at all four sites);
13. rest: the port's REST server as a user drives it, every process of it
   under an import hook that refuses the JAX package, jax, flax, yaml,
   transformers, safetensors, aiohttp and psutil: ``python -m
   easevoice_trainer_tpu_torch.main --dry-run`` exits 0, then the server
   on a free port, its models those the earlier phases wrote (linked
   under a base path of its own, whose configs/s2.json logs every step's
   loss); /session names the card; a namespace and the uploaded 5 s
   reference; /normalize/start over phase 7's denoised clips with an en
   row each; one epoch of s2 and of s1 training on the result at B = 8 (a
   second start 409, losses in the session, the request's device "cuda"
   whatever the body said); /voiceclone/models lists both; two greedy
   clones of the two trained models (K1, K2 and K3 counted in the first
   one's device records under /profiler; the card's used memory after
   each); a long s2
   run stopped after its first loss (its processes gone from /proc and
   from nvidia-smi within 15 s, the session Completed); easy mode over a
   10 s song (Completed where jieba imports; else Failed at step 5 with
   jieba named, steps 1-4 done; the line "[rest] easy mode route" says
   which) and the TensorBoard proxy (502 without a tensorboard binary);
   each request's wall on a "[rest]" line.

After the REST phase it checks that no module of the JAX package, jax,
flax, yaml, transformers, safetensors, aiohttp or psutil was loaded in the
whole run, UVR5's included (the ASR chain's config.yaml files go through
the port's reader, Whisper's tokenizer is the port's own).  Two lines before the last hold one JSON
object with each kernel's launches (in all, per serving clone, per s2 step
and per s1 micro-batch; a bf16 instance is an entry of its own, its
``fp32_ms`` the fp32 instance's time on the same inputs),
error, device times and bound (``launches_per_path`` holds the REST clone's
trace counts as ``rest_clone_trace``); the line before the last is the card's name
and power limit as ``nvidia-smi`` gives them, and the last line is the
run's verdict ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the repository beside this file, it exits non-zero and prints no
verdict.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import wave
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))

SENTENCES = [
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "A journey of a thousand miles begins with a single careful step.",
    "Voice cloning turns a short reference clip into a full synthetic "
    "narrator.",
    "Benchmarks must include every stage, not only the hot inner loops.",
    "Segment bucketing groups sentences of similar length into one batch.",
    "The final splice stitches fragments back in their original order.",
]

KERNEL_INFO = {
    "prefill_attention": (
        "easevoice_trainer_tpu_torch/csrc/prefill_attention.cu",
        "easevoice_trainer_tpu/ops/pallas/flash_prefill.py:35 "
        "(_kernel, git 0ec4461)"),
    "decode_attention": (
        "easevoice_trainer_tpu_torch/csrc/decode_attention.cu",
        "easevoice_trainer_tpu/models/gpt/t2s.py:338 "
        "(decode_step: cache write + attention, no Pallas ancestor)"),
    "mrf_conv": (
        "easevoice_trainer_tpu_torch/csrc/mrf_conv.cu",
        "easevoice_trainer_tpu/ops/fused_mrf.py:125 "
        "(_fwd_kernel, git 42ecfe8)"),
    "mrf_conv_bwd_data": (
        "easevoice_trainer_tpu_torch/csrc/mrf_conv_bwd.cu",
        "easevoice_trainer_tpu/ops/fused_mrf.py:168 "
        "(_bwd_kernel, dx, git 42ecfe8)"),
    "mrf_conv_bwd_weight": (
        "easevoice_trainer_tpu_torch/csrc/mrf_conv_wgrad.cu",
        "easevoice_trainer_tpu/ops/fused_mrf.py:168 "
        "(_bwd_kernel, dW and db, git 42ecfe8)"),
    "prefill_attention_bwd": (
        "easevoice_trainer_tpu_torch/csrc/prefill_attention_bwd.cu",
        "easevoice_trainer_tpu/models/gpt/t2s.py:118 "
        "(TransformerLayer.attention under jax.value_and_grad, "
        "train/gpt_step.py:143; no Pallas ancestor)"),
    "encoder_attention": (
        "easevoice_trainer_tpu_torch/csrc/prefill_attention.cu",
        "easevoice_trainer_tpu/models/bert.py:49-56 (BertLayer attention "
        "with its key-padding bias, :88-91; also G2PW's BERT, "
        "text/g2pw.py:57, HuBERT's attention and Whisper's encoder "
        "self-attention, audiokit/asr_whisper.py:184; no Pallas ancestor)"),
    "encoder_attention_dk32": (
        "easevoice_trainer_tpu_torch/csrc/prefill_attention.cu",
        "easevoice_trainer_tpu/audiokit/punc_ct.py:94-116 (CT-punc's "
        "SANMAttention with its word mask; no Pallas ancestor: K1's dk-32 "
        "instance, the port of ops/pallas/flash_prefill.py:35, git "
        "0ec4461, with no audio part)"),
    # the bf16 instances of the fine-tunes under is_half
    "prefill_attention_bf16": (
        "easevoice_trainer_tpu_torch/csrc/prefill_attention_bf16.cu",
        "easevoice_trainer_tpu/ops/pallas/flash_prefill.py:35 "
        "(_kernel, git 0ec4461), as TransformerLayer.attention computes it "
        "with dtype bfloat16 (models/gpt/t2s.py:118-131)"),
    "prefill_attention_bwd_bf16": (
        "easevoice_trainer_tpu_torch/csrc/prefill_attention_bwd_bf16.cu",
        "easevoice_trainer_tpu/models/gpt/t2s.py:118 (TransformerLayer."
        "attention with dtype bfloat16 under jax.value_and_grad, "
        "train/gpt_step.py:143; no Pallas ancestor)"),
    "mrf_conv_bf16": (
        "easevoice_trainer_tpu_torch/csrc/mrf_conv_bf16.cu",
        "easevoice_trainer_tpu/ops/fused_mrf.py:125 (_fwd_kernel, git "
        "42ecfe8), as the bf16 Generator computes it "
        "(models/sovits/generator.py:31-44)"),
    "mrf_conv_bwd_data_bf16": (
        "easevoice_trainer_tpu_torch/csrc/mrf_conv_bwd_bf16.cu",
        "easevoice_trainer_tpu/ops/fused_mrf.py:168 (_bwd_kernel, dx, git "
        "42ecfe8), in bf16"),
    "mrf_conv_bwd_weight_bf16": (
        "easevoice_trainer_tpu_torch/csrc/mrf_conv_wgrad.cu",
        "easevoice_trainer_tpu/ops/fused_mrf.py:168 (_bwd_kernel, dW and "
        "db, git 42ecfe8), in bf16"),
    # the dropout instances of the s1 fine-tune (T2SConfig.dropout > 0)
    "prefill_attention_dropout": (
        "easevoice_trainer_tpu_torch/csrc/prefill_attention.cu",
        "easevoice_trainer_tpu/models/gpt/t2s.py:128 (nn.Dropout on the "
        "attention probabilities inside K1, the port of "
        "ops/pallas/flash_prefill.py:35, git 0ec4461, which takes no "
        "dropout)"),
    "prefill_attention_dropout_bf16": (
        "easevoice_trainer_tpu_torch/csrc/prefill_attention_bf16.cu",
        "easevoice_trainer_tpu/models/gpt/t2s.py:128 (nn.Dropout on the "
        "attention probabilities, dtype bfloat16, inside K1's bf16 "
        "instance)"),
    "prefill_attention_bwd_dropout": (
        "easevoice_trainer_tpu_torch/csrc/prefill_attention_bwd.cu",
        "easevoice_trainer_tpu/models/gpt/t2s.py:128 (nn.Dropout on the "
        "attention probabilities under jax.value_and_grad, "
        "train/gpt_step.py:143; no Pallas ancestor)"),
    "prefill_attention_bwd_dropout_bf16": (
        "easevoice_trainer_tpu_torch/csrc/prefill_attention_bwd_bf16.cu",
        "easevoice_trainer_tpu/models/gpt/t2s.py:128 (nn.Dropout on the "
        "attention probabilities, dtype bfloat16, under jax.value_and_grad, "
        "train/gpt_step.py:143; no Pallas ancestor)"),
}

# the s1 micro-batches of the "s1 training" phase: B=8, 416 phonemes
# (52 s at 8 phonemes a second, padded to 16) and the two token buckets
# of GPT_BOUNDARIES its data fills (250 -> 300 and 1300 -> 1360 tokens)
S1_B, S1_X_LEN, S1_Y_LENS = 8, 416, (300, 1360)

# the s2 step's Generator stages for one 32-frame segment: (C, T)
S2_STAGES = ((256, 320), (128, 2560), (64, 5120), (32, 10240), (16, 20480))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# the card's rates for a bound (NVIDIA's H100 SXM data sheet, dense): HBM3
# bytes, and fp32-accurate products as 3xTF32 on the tensor cores (495
# TFLOP/s TF32 / 3, above the CUDA cores' 67 TFLOP/s fp32)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 495e12 / 3


class NoDeviceActivity(RuntimeError):
    """torch.profiler recorded no CUDA activity in any session."""


def device_events(torch, fn, attempts: int = 3, expect=None):
    """The CUDA kernels and copies torch.profiler records over one call of
    ``fn`` (synchronised at its end).  Now and then a profiler session comes
    back with no device activity at all (seen once in ~150 sessions on an
    H100, and three sessions in a row once), or, with ``expect`` (the
    count of kernels the call launches), short of some of them (about one
    in 18 or 90, session after session, on the bf16 K3 / K4-dx timings);
    ``fn`` is then profiled again, up to ``attempts`` sessions in all.
    Short sessions give the longest of them; with none recorded it raises
    NoDeviceActivity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = []
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        if device and (expect is None or len(device) >= expect):
            return device
        best = max(best, device, key=len)
        log(f"[timer] torch.profiler session {attempt} of {attempts} "
            f"recorded {len(device)} CUDA events"
            + (f" of the call's {expect}" if expect is not None else ""))
    if best:
        return best
    raise NoDeviceActivity("torch.profiler recorded no CUDA activity")


def device_ms(torch, fn, name=None, reps: int = 20, launches=None) -> float:
    """Mean device time of one call of ``fn``: the CUDA kernels and copies
    torch.profiler records over ``reps`` calls after a warm-up, divided by
    ``reps``; with ``name``, only the kernels whose name holds it.  With
    ``launches``, the kernels one call launches, a session short of some
    is taken again, and the longest of three short sessions is scaled up
    to the count, its missing kernels taken as long as its mean (a
    "[timer]" line says so).  Where the profiler records nothing in any of
    its sessions, the ``reps`` calls are timed between two CUDA events
    instead (all their device work, and the gaps between launches), and a
    "[timer]" line says so."""
    fn()
    torch.cuda.synchronize()
    try:
        device = device_events(
            torch, lambda: [fn() for _ in range(reps)],
            expect=None if launches is None else launches * reps)
    except NoDeviceActivity:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        log(f"[timer] timed with CUDA events instead ({name or 'the call'}"
            f", every kernel of the call and the gaps between them)")
        return start.elapsed_time(end) / reps
    if name is not None:
        device = [e for e in device if name in e.name]
        if not device:
            raise RuntimeError(f"torch.profiler recorded no kernel named "
                               f"*{name}*")
    scale = 1.0
    if launches is not None and len(device) < launches * reps:
        scale = launches * reps / len(device)
        log(f"[timer] scaled {len(device)} recorded kernels to the call's "
            f"{launches * reps} ({name or 'the call'})")
    return scale * sum(e.time_range.elapsed_us()
                       for e in device) / 1000.0 / reps


def graph_timer(torch, fn, stream, reps: int = 20):
    """``reps`` calls of ``fn`` captured as one CUDA graph on ``stream``
    (after a warm-up call there); returns a function that replays the graph
    between two CUDA events and gives the device ms of one call (every
    kernel of it and the gaps between them, with no host launch cost).  An
    autograd backward is captured on the stream its forward ran on."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def ms() -> float:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    return ms


def event_ms(torch, fn, reps: int = 20) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls after a warm-up
    between two CUDA events (every kernel of a call and the gaps between
    them), for a call whose kernel count torch.profiler cannot be held to
    (a library call that may lose records in a session)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(torch, fn, old, name=None, launches=None):
    """Device ms of ``fn`` and of ``old``, the same call on the parent
    commit's package, timed in turns (old, new, new, old), each the mean of
    its two sessions; (ms, None) without ``old``.  ``launches``: as for
    device_ms."""
    def ms(f):
        return device_ms(torch, f, name, launches=launches)

    if old is None:
        return ms(fn), None
    first = ms(old)
    new = ms(fn) + ms(fn)
    return new / 2, (first + ms(old)) / 2


class Bound:
    """Least device time of a set of calls: per call, the larger of the
    bytes it must move (each input read once, each output written once)
    over HBM_BYTES_PER_S and its operations over ``ops_per_s``
    (FP32_OPS_PER_S: fp32-accurate products; BF16_OPS_PER_S for the bf16
    instances)."""

    def __init__(self, ops_per_s: float = FP32_OPS_PER_S):
        self.ms = self.bytes_ms = self.ops_ms = 0.0
        self.ops_per_s = ops_per_s

    def add(self, nbytes: float, flops: float) -> None:
        b = nbytes / HBM_BYTES_PER_S * 1e3
        o = flops / self.ops_per_s * 1e3
        self.ms += max(b, o)
        self.bytes_ms += b
        self.ops_ms += o

    @property
    def by(self) -> str:
        return "operations" if self.ops_ms >= self.bytes_ms else "bytes"

    def result(self) -> dict:
        return dict(bound_ms=self.ms, bound_by=self.by)


def max_err(torch, got, want) -> float:
    return float((got - want).abs().max())


# ---------------------------------------------------------------------------
# phase 3: each kernel against its twin
# ---------------------------------------------------------------------------

def check_kernels(torch, results, parent=None):
    """K1-K3 against their twins at the serving shapes.  ``parent``: the
    parent commit's ``ops.attention`` module, whose K1 and K2 are then timed
    in turns beside this tree's on the same inputs (lines "[a/b]")."""
    import torch.nn.functional as F

    from easevoice_trainer_tpu_torch.nn.layers import LRELU_SLOPE
    from easevoice_trainer_tpu_torch.ops import attention as att
    from easevoice_trainer_tpu_torch.ops import mrf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    b, h, dk, x_len, prompt = 4, 16, 32, 64, 250
    x_lens = torch.tensor([64, 41, 17, 58], dtype=torch.int32, device=dev)

    # K1: q/k/v are strided views of one fused qkv projection, as in t2s.py
    tol = 1e-4
    t = x_len + prompt
    qkv = torch.randn((b, t, 3 * h * dk), generator=gen, device=dev)
    q, k, v = (z.view(b, t, h, dk) for z in qkv.split(h * dk, dim=-1))
    y_lens = torch.full((b,), prompt, dtype=torch.int32, device=dev)
    got = att.prefill_attention(q, k, v, x_len, x_lens, y_lens)
    want = att.prefill_attention_reference(q, k, v, x_len, x_lens, y_lens)
    err = max_err(torch, got, want)
    assert torch.equal(got, att.prefill_attention(
        q, k, v, x_len, x_lens, y_lens)), "prefill_attention does not repeat"
    # the library yardstick: SDPA with the hybrid mask as a boolean
    # attn_mask, heads-first copies made outside the timed calls
    allowed = att.build_hybrid_mask_bias(x_len, prompt, x_lens, y_lens) == 0
    qh, kh, vh = (z.transpose(1, 2).contiguous() for z in (q, k, v))
    sdpa = functools.partial(F.scaled_dot_product_attention, qh, kh, vh,
                             attn_mask=allowed)
    lib_err = max_err(torch, sdpa().transpose(1, 2), want)

    def k1(mod):
        return lambda: mod.prefill_attention(q, k, v, x_len, x_lens, y_lens)

    ms, parent_ms = in_turns(torch, k1(att), parent and k1(parent),
                             "prefill_attention")
    plain = device_ms(torch, lambda: att.prefill_attention_reference(
        q, k, v, x_len, x_lens, y_lens))
    library = device_ms(torch, sdpa)
    bound = Bound()
    pairs = int(allowed.sum()) * h
    bound.add(4 * 4 * b * t * h * dk, 4 * dk * pairs)  # q, k, v, o; QK, PV
    log(f"[kernels] K1 prefill_attention B={b} H={h} dk={dk} x_len={x_len} "
        f"x_lens={x_lens.tolist()} prompt={prompt}: max|d|={err:.3g} "
        f"(tol {tol}), repeats bit for bit; device ms: kernel {ms:.4f}, "
        f"plain {plain:.4f}, SDPA {library:.4f} (max|d| {lib_err:.3g}), "
        f"bound {bound.ms:.5f} ({bound.by}); kernel / SDPA "
        f"{ms / library:.3f}")
    if parent is not None:
        old_o = k1(parent)()
        perr = max_err(torch, old_o, want)
        same = torch.equal(old_o, got)
        log(f"[a/b] K1 prefill_attention, same inputs, in turns: parent "
            f"{parent_ms:.4f} ms -> this tree {ms:.4f} ms "
            f"({parent_ms / ms:.2f}x); parent max|d|={perr:.3g}; outputs "
            f"bit-identical: {same}")
        assert same, "K1's serving output differs from the parent's"
        from easevoice_trainer_tpu_torch.ops import build

        new, old = (sass_functions(path, ("prefill_attention_kernel",))
                    for path in (build.build().path,
                                 parent.build.build().path))
        for width in ("Li32E", "Li64E"):
            # the fp32 instances of the two trees
            # (not the bf16 one, nor this tree's dropout instance)
            mine, theirs = ([b for n, bs in lib.items()
                             if width in n and "bfloat16" not in n
                             and "Lb1E" not in n
                             for b in bs] for lib in (new, old))
            log(f"[a/b] K1's dk-{width[2:4]} fp32 SASS: {len(mine)} copy in "
                f"this tree's library ({len(mine[0])} instructions), "
                f"{len(theirs)} in the parent's; identical: "
                f"{mine == theirs}")
            assert mine == theirs, \
                f"K1's dk-{width[2:4]} SASS differs from the parent's"
    assert err <= tol, f"prefill_attention disagrees: {err}"
    results["prefill_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                        library_ms=library, **bound.result())
    del qkv, q, k, v, qh, kh, vh, sdpa

    # K2: the 24 layers' caches of the serving decode, x_len + prompt + 1120
    # slots each.  The decode loop reads every layer's cache once a step,
    # 24 x 23.5 MB, far beyond the 50 MB L2, so each launch finds its cache
    # cold: "cold" rotates the layer on every timed call; "warm" repeats one
    # layer, whose valid slots then sit in L2.
    n_layers = 24
    cache_len = x_len + prompt + 1120
    last = cache_len - x_len - prompt - 1
    kcs = torch.randn((n_layers, b, cache_len, h, dk), generator=gen,
                      device=dev)
    vcs = torch.randn((n_layers, b, cache_len, h, dk), generator=gen,
                      device=dev)
    qkv = torch.randn((b, 1, 3 * h * dk), generator=gen, device=dev)
    qn, kn, vn = (z.view(b, 1, h, dk) for z in qkv.split(h * dk, dim=-1))
    worst = 0.0
    for step in (0, 1, 500, last):
        pos = x_len + prompt + step
        kc, vc = kcs[0].clone(), vcs[0].clone()
        got = att.decode_attention(qn, kn, vn, kc, vc, x_len, x_lens, prompt,
                                   step)
        kw, vw = kcs[0].clone(), vcs[0].clone()
        kw[:, pos] = kn[:, 0]
        vw[:, pos] = vn[:, 0]
        want = att.decode_attention_reference(qn, kw, vw, x_len, x_lens,
                                              prompt, step)
        err = max_err(torch, got, want)
        worst = max(worst, err)
        same = torch.equal(kc, kw) and torch.equal(vc, vw)
        again = torch.equal(got, att.decode_attention(
            qn, kn, vn, kc, vc, x_len, x_lens, prompt, step))
        log(f"[kernels] K2 decode_attention cache_len={cache_len} "
            f"step={step}: max|d|={err:.3g} (tol {tol}); cache after the "
            f"kernel equals the twin's: {same}; repeats bit for bit: {again}")
        assert same, "decode_attention left another cache than its twin"
        assert again, "decode_attention does not repeat"
    del kc, vc, kw, vw
    assert worst <= tol, f"decode_attention disagrees: {worst}"

    for step in (0, 500, last):
        kv_end = x_len + prompt + step + 1
        kcs[:, :, kv_end - 1] = kn[:, 0]  # the new token's row, as written
        vcs[:, :, kv_end - 1] = vn[:, 0]
        slot = torch.arange(kv_end, device=dev)
        ok = (slot[None, :] < x_lens[:, None]) | (slot[None, :] >= x_len)
        layer = itertools.count()

        def rotate(fn):
            return lambda: fn(next(layer) % n_layers)

        def k2(mod):
            return lambda i: mod.decode_attention(
                qn, kn, vn, kcs[i], vcs[i], x_len, x_lens, prompt, step)

        cold, parent_cold = in_turns(
            torch, rotate(k2(att)), parent and rotate(k2(parent)),
            "decode_attention")
        warm, parent_warm = in_turns(
            torch, lambda: k2(att)(0), parent and (lambda: k2(parent)(0)),
            "decode_attention")
        plain = device_ms(torch, rotate(
            lambda i: att.decode_attention_reference(
                qn, kcs[i], vcs[i], x_len, x_lens, prompt, step)))
        # SDPA over the first kv_end slots with the text pads masked,
        # heads-first copies of every layer made outside the timed calls
        qh = qn.transpose(1, 2).contiguous()
        heads = [tuple(z[i, :, :kv_end].transpose(1, 2).contiguous()
                       for z in (kcs, vcs)) for i in range(n_layers)]
        mask = ok[:, None, None, :]

        def sdpa(i):
            return F.scaled_dot_product_attention(qh, *heads[i],
                                                  attn_mask=mask)

        want = att.decode_attention_reference(qn, kcs[0], vcs[0], x_len,
                                              x_lens, prompt, step)
        lib_err = max_err(torch, sdpa(0).transpose(1, 2), want)
        library = device_ms(torch, rotate(sdpa))
        del heads
        bound = Bound()
        valid = int(ok.sum())  # slots over the batch, the new one included
        # q, k, v in and o out, the new row written, the older valid rows
        # read; QK and PV over every valid slot
        bound.add(4 * (6 * b * h * dk + 2 * (valid - b) * h * dk),
                  4 * dk * h * valid)
        log(f"[kernels] K2 step {step} ({valid} valid slots over the "
            f"batch): device ms cold ({n_layers} "
            f"rotating layers): kernel {cold:.5f}, plain {plain:.4f}, SDPA "
            f"{library:.4f} (max|d| {lib_err:.3g}); warm (one layer): kernel "
            f"{warm:.5f}; bound {bound.ms:.5f} ({bound.by}): cold kernel at "
            f"{100 * bound.ms / cold:.1f} % of its bound")
        if parent is not None:
            log(f"[a/b] K2 decode_attention step {step}, same inputs, in "
                f"turns: cold parent {parent_cold:.5f} ms -> this tree "
                f"{cold:.5f} ms ({parent_cold / cold:.2f}x); warm parent "
                f"{parent_warm:.5f} -> {warm:.5f} ms")
        if step == 500:
            results["decode_attention"] = dict(
                max_abs_err=worst, ms=cold, warm_ms=warm, plain_ms=plain,
                library_ms=library, **bound.result())
    if parent is not None:
        # the wrappers' whole device work at step 500, cold: the parent
        # also writes the cache and copies q outside its kernel
        step = 500
        wrap = [device_ms(torch, rotate(k2(mod))) for mod in (att, parent)]
        log(f"[a/b] K2 wrapper at step 500, cold, every kernel and copy it "
            f"launches: parent {wrap[1]:.5f} ms -> this tree {wrap[0]:.5f} "
            f"ms")
    del kcs, vcs
    torch.cuda.empty_cache()

    # K3: every Generator stage's (C, k, d) at its length for 250 codes
    # (padded to 256 codes -> 512 frames), batch of 4 rows.  The library
    # call is cuDNN's conv1d on the leaky-relu'd input plus the residual add
    frames = 512
    rates = (10, 8, 2, 2, 2)
    worst_rel = 0.0
    worst = 0.0
    bound = Bound()
    stages = []
    ch, up = 512, 1
    for i, u in enumerate(rates):
        ch //= 2
        up *= u
        t_len = frames * up
        x = torch.randn((b, ch, t_len), generator=gen, device=dev)
        act = F.leaky_relu(x, LRELU_SLOPE)
        sums = [0.0, 0.0, 0.0]     # kernel, plain, library
        for kk in (3, 7, 11):
            w = torch.randn((ch, ch, kk), generator=gen, device=dev) \
                / math.sqrt(ch * kk)
            bias = torch.randn((ch,), generator=gen, device=dev) * 0.1
            for d in (1, 3, 5):
                res = x if d == 1 else None
                pad = (kk - 1) * d // 2
                got = mrf.mrf_conv(x, w, bias, d, residual=res)
                want = mrf.mrf_conv_reference(x, w, bias, d, residual=res)
                err = max_err(torch, got, want)
                rel = err / max(1.0, float(want.abs().max()))
                worst, worst_rel = max(worst, err), max(worst_rel, rel)

                def cudnn():
                    y = F.conv1d(act, w, bias, padding=pad, dilation=d)
                    return y if res is None else y + res

                times = (
                    device_ms(torch, lambda: mrf.mrf_conv(
                        x, w, bias, d, residual=res)),
                    device_ms(torch, lambda: mrf.mrf_conv_reference(
                        x, w, bias, d, residual=res)),
                    device_ms(torch, cudnn))
                sums = [a + t for a, t in zip(sums, times)]
                bound.add(4 * (b * ch * t_len * (3 if res is not None else 2)
                               + ch * ch * kk + ch),
                          2 * b * t_len * ch * ch * kk)
                log(f"[kernels] K3 stage {i} B={b} C={ch} T={t_len} k={kk} "
                    f"d={d} residual={res is not None}: max|d|={err:.3g}; "
                    f"device ms: kernel {times[0]:.4f}, plain {times[1]:.4f}, "
                    f"cuDNN {times[2]:.4f}")
        stages.append((ch, t_len, sums))
    for i, (ch, t_len, (kern, plain, lib)) in enumerate(stages):
        log(f"[kernels] K3 stage {i} (C={ch}, T={t_len}), 9 shapes: kernel "
            f"{kern:.3f} ms, cuDNN {lib:.3f} ms, plain {plain:.3f} ms")
    total = [sum(st[2][n] for st in stages) for n in range(3)]
    log(f"[kernels] K3 mrf_conv 45 shapes: max|d|={worst:.3g}, relative "
        f"{worst_rel:.3g} (tol {tol} x max(1, max|twin|)); device ms summed "
        f"over shapes: kernel {total[0]:.3f}, cuDNN {total[2]:.3f}, plain "
        f"{total[1]:.3f}; bound {bound.ms:.3f} ({bound.by}; bytes "
        f"{bound.bytes_ms:.3f}, fp32 operations {bound.ops_ms:.3f})")
    # the card against the CPU twin on the largest and the longest shape
    for ch, t_len, kk, d in ((256, 5120, 11, 5), (16, 327680, 3, 1)):
        x = torch.randn((b, ch, t_len), generator=gen, device=dev)
        w = torch.randn((ch, ch, kk), generator=gen, device=dev) \
            / math.sqrt(ch * kk)
        bias = torch.randn((ch,), generator=gen, device=dev) * 0.1
        got = mrf.mrf_conv(x, w, bias, d, residual=x).cpu()
        want = mrf.mrf_conv_reference(x.cpu(), w.cpu(), bias.cpu(), d,
                                       residual=x.cpu())
        err = max_err(torch, got, want)
        rel = err / max(1.0, float(want.abs().max()))
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        log(f"[kernels] K3 C={ch} T={t_len} k={kk} d={d} against the CPU "
            f"twin: max|d|={err:.3g}, relative {rel:.3g}")
    del x, w, bias, got, want, act
    assert worst_rel <= tol, f"mrf_conv disagrees: {worst_rel}"
    assert total[0] <= total[2], \
        f"K3 ({total[0]:.3f} ms) is slower than cuDNN ({total[2]:.3f} ms)"
    results["mrf_conv"] = dict(max_abs_err=worst, ms=total[0],
                               plain_ms=total[1], library_ms=total[2],
                               **bound.result())


def hubert_frames(seconds: float):
    """(padded, valid) HuBERT frame counts of a reference clip of
    ``seconds`` as ``TTS._extract_semantic`` feeds it: 0.3 s of silence
    appended, 16 kHz, padded to the next 0.5 s."""
    from easevoice_trainer_tpu_torch.models.cnhubert import \
        feat_output_lengths

    true_len = int(round((seconds + 0.3) * 16000))
    padded = max(8000, -(-true_len // 8000) * 8000)
    return int(feat_output_lengths(padded)), int(feat_output_lengths(
        true_len))


def check_encoder(torch, results):
    """K1's head-width-64 instance (``encoder_attention``) against its twin
    at the encoders' shapes, 1e-4 absolute as for K1: BERT (B=1, H=16, T=64
    and T=512, the 510-character cap of ``split_big_text`` plus [CLS] and
    [SEP]), G2PW's BERT (B=4, H=12, T=64, ragged valid lengths), HuBERT
    (B=1, H=12, the 5 s reference's padded frames, the valid ones marked).
    Each valid row must not depend on padding: a run of that batch row
    alone, unpadded, gives it again.  Device ms of the kernel, the twin and
    SDPA with the boolean key mask, and the bound: q, k, v, o moved once;
    two dk-long products (QK, PV) per visible (row, key) pair, every query
    row (pads too) seeing its row's valid keys."""
    import torch.nn.functional as F

    from easevoice_trainer_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(4242)
    tol, dk = 1e-4, att.ENCODER_DK
    hub_t, hub_valid = hubert_frames(5.0)
    g2pw_lens = torch.randint(2, 65, (4,), generator=gen, device="cuda")
    g2pw_lens[0] = 64
    shapes = (("BERT", 1, 16, 64, [64]), ("BERT", 1, 16, 512, [512]),
              ("G2PW", 4, 12, 64, g2pw_lens.tolist()),
              ("HuBERT", 1, 12, hub_t, [hub_valid]))
    sums, worst, bound = [0.0, 0.0, 0.0], 0.0, Bound()
    for label, b, h, t, lens in shapes:
        valid = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q, k, v = (torch.randn((b, t, h, dk), generator=gen, device="cuda")
                   for _ in range(3))
        got = att.encoder_attention(q, k, v, valid)
        want = att.prefill_attention_reference(q, k, v, t, valid,
                                               torch.zeros_like(valid))
        err = max_err(torch, got, want)
        pad_err, pad_same = 0.0, True
        for i, n in enumerate(lens):
            alone = att.encoder_attention(
                *(z[i:i + 1, :n].contiguous() for z in (q, k, v)),
                valid[i:i + 1])[0]
            pad_err = max(pad_err, max_err(torch, alone, got[i, :n]))
            pad_same &= torch.equal(alone, got[i, :n])
        allowed = (torch.arange(t, device="cuda")[None]
                   < valid[:, None])[:, None, None, :]
        qh, kh, vh = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        sdpa = functools.partial(F.scaled_dot_product_attention, qh, kh, vh,
                                 attn_mask=allowed)
        lib_err = max_err(torch, sdpa().transpose(1, 2), want)
        times = (
            device_ms(torch, lambda: att.encoder_attention(q, k, v, valid),
                      "prefill_attention"),
            device_ms(torch, lambda: att.prefill_attention_reference(
                q, k, v, t, valid, torch.zeros_like(valid))),
            device_ms(torch, sdpa))
        one = Bound()
        one.add(4 * 4 * b * t * h * dk, 4 * dk * h * t * sum(lens))
        bound.add(4 * 4 * b * t * h * dk, 4 * dk * h * t * sum(lens))
        sums = [a + x for a, x in zip(sums, times)]
        worst = max(worst, err, pad_err)
        log(f"[kernels] encoder_attention (K1 dk={dk}) {label} B={b} H={h} "
            f"T={t} valid={lens}: max|d|={err:.3g} (tol {tol}); valid rows "
            f"alone, unpadded: max|d|={pad_err:.3g}, bit-identical "
            f"{pad_same}; device ms: kernel {times[0]:.5f}, plain "
            f"{times[1]:.4f}, SDPA {times[2]:.5f} (max|d| {lib_err:.3g}); "
            f"bound {one.ms:.5f} ({one.by}), kernel at "
            f"{100 * one.ms / times[0]:.1f} % of it")
        del q, k, v, qh, kh, vh, sdpa, got, want
    assert worst <= tol, f"encoder_attention disagrees: {worst}"
    log(f"[kernels] encoder_attention, 4 shapes: device ms summed: kernel "
        f"{sums[0]:.5f}, plain {sums[1]:.4f}, SDPA {sums[2]:.5f}; bound "
        f"{bound.ms:.5f} ({bound.by})")
    results["encoder_attention"] = dict(
        max_abs_err=worst, ms=sums[0], plain_ms=sums[1], library_ms=sums[2],
        **bound.result())


def check_encoder_asr(torch, results):
    """K1 on the ASR chain's attention, against its twin (1e-4 absolute):
    the dk-32 instance at CT-punc's shapes (B=1, H=8, the JAX bucket of a
    20-word chunk, of a chunk with a carried tail, and of the 200-word
    cache limit plus a chunk), each valid row also run alone, unpadded;
    the dk-64 instance at Whisper's encoder shape (B=1, H=12, T=1500, every
    frame valid).  Device ms of the kernel, the twin and SDPA (boolean key
    mask where there are pads), and the bound (q, k, v, o once; two
    dk-long products per visible pair).  Then SDPA alone at Paraformer's
    dk-128 encoder shapes (B=1, H=4, the buckets of 3.8, 7.7 and 15.4 s
    clips), which no hand-written kernel covers, beside the plain twin and
    the bound."""
    import torch.nn.functional as F

    from easevoice_trainer_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(1117)
    tol = 1e-4

    def one_shape(b, h, t, dk, lens, pads_alone):
        valid = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q, k, v = (torch.randn((b, t, h, dk), generator=gen, device="cuda")
                   for _ in range(3))
        want = att.prefill_attention_reference(q, k, v, t, valid,
                                               torch.zeros_like(valid))
        got = att.encoder_attention(q, k, v, valid)
        err = max_err(torch, got, want)
        same = True
        if pads_alone:
            for i, n in enumerate(lens):
                alone = att.encoder_attention(
                    *(z[i:i + 1, :n].contiguous() for z in (q, k, v)),
                    valid[i:i + 1])[0]
                err = max(err, max_err(torch, alone, got[i, :n]))
                same &= torch.equal(alone, got[i, :n])
        mask = None
        if min(lens) < t:
            mask = (torch.arange(t, device="cuda")[None]
                    < valid[:, None])[:, None, None, :]
        qh, kh, vh = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        sdpa = functools.partial(F.scaled_dot_product_attention, qh, kh, vh,
                                 attn_mask=mask)
        lib_err = max_err(torch, sdpa().transpose(1, 2), want)
        times = (
            device_ms(torch, lambda: att.encoder_attention(q, k, v, valid),
                      "prefill_attention"),
            device_ms(torch, lambda: att.prefill_attention_reference(
                q, k, v, t, valid, torch.zeros_like(valid))),
            device_ms(torch, sdpa))
        work = (4 * 4 * b * t * h * dk, 4 * dk * h * t * sum(lens))
        one = Bound()
        one.add(*work)
        return err, same, lib_err, times, one, work

    sums, worst, bound = [0.0, 0.0, 0.0], 0.0, Bound()
    for t, n in ((32, 20), (64, 37), (256, 220)):
        err, same, lib_err, times, one, work = one_shape(1, 8, t, 32, [n],
                                                         True)
        bound.add(*work)
        sums = [a + x for a, x in zip(sums, times)]
        worst = max(worst, err)
        log(f"[kernels] encoder_attention (K1 dk=32) CT-punc B=1 H=8 T={t} "
            f"valid={n}: max|d|={err:.3g} (tol {tol}), the valid row alone "
            f"bit-identical {same}; device ms: kernel {times[0]:.5f}, plain "
            f"{times[1]:.4f}, SDPA {times[2]:.5f} (max|d| {lib_err:.3g}); "
            f"bound {one.ms:.6f} ({one.by}), kernel at "
            f"{100 * one.ms / times[0]:.1f} % of it")
    assert worst <= tol, f"encoder_attention dk 32 disagrees: {worst}"
    log(f"[kernels] encoder_attention dk 32, 3 CT-punc shapes: device ms "
        f"summed: kernel {sums[0]:.5f}, plain {sums[1]:.4f}, SDPA "
        f"{sums[2]:.5f}; bound {bound.ms:.6f} ({bound.by})")
    results["encoder_attention_dk32"] = dict(
        max_abs_err=worst, ms=sums[0], plain_ms=sums[1], library_ms=sums[2],
        **bound.result())

    err, _, lib_err, times, one, _ = one_shape(1, 12, 1500, 64, [1500],
                                               False)
    log(f"[kernels] encoder_attention (K1 dk=64) Whisper encoder B=1 H=12 "
        f"T=1500 all valid: max|d|={err:.3g} (tol {tol}); device ms: kernel "
        f"{times[0]:.5f}, plain {times[1]:.4f}, SDPA (no mask) "
        f"{times[2]:.5f} (max|d| {lib_err:.3g}); bound {one.ms:.5f} "
        f"({one.by}), kernel at {100 * one.ms / times[0]:.1f} % of it")
    assert err <= tol, f"encoder_attention at Whisper's shape: {err}"
    results["encoder_attention"]["whisper_T1500"] = dict(
        max_abs_err=err, ms=times[0], plain_ms=times[1], library_ms=times[2],
        **one.result())

    for t, n in ((64, 63), (128, 128), (256, 256)):
        q, k, v = (torch.randn((1, 4, t, 128), generator=gen,
                               device="cuda") for _ in range(3))
        valid = torch.tensor([n], device="cuda")
        mask = (torch.arange(t, device="cuda")[None] < valid[:, None]
                )[:, None, None, :]
        sdpa = functools.partial(F.scaled_dot_product_attention, q, k, v,
                                 attn_mask=mask)
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        plain = functools.partial(att.prefill_attention_reference, qt, kt,
                                  vt, t, valid, torch.zeros_like(valid))
        err = max_err(torch, sdpa().transpose(1, 2), plain())
        one = Bound()
        one.add(4 * 4 * t * 4 * 128, 4 * 128 * 4 * t * n)
        ms = device_ms(torch, sdpa), device_ms(torch, plain)
        log(f"[kernels] Paraformer encoder attention (dk 128, no hand-"
            f"written kernel) B=1 H=4 T={t} valid={n}: SDPA with the "
            f"boolean key mask {ms[0]:.5f} ms, plain twin {ms[1]:.4f} ms "
            f"(max|d| {err:.3g}); bound {one.ms:.6f} ms ({one.by})")
        assert err <= tol, err


# the Roformers' axial attention, (label, B, T) at H=8, dk 64: BS-Roformer's
# time axis (the 62 bands' rows over the 801 frames of an 8 s chunk) and
# frequency axis (801 frame rows over 62 bands), Mel-Band Roformer's (60)
ROFORMER_SHAPES = (("BS time", 62, 801), ("BS freq", 801, 62),
                   ("Mel time", 60, 801), ("Mel freq", 801, 60))


def check_encoder_roformer(torch, results):
    """K1's dk-64 instance at the Roformers' four axial shapes, as
    ``RoformerAttention`` calls it (q and k rotated, so contiguous; v a view
    of the fused qkv projection; every key valid), against its twin (1e-4
    absolute), and each batch row against a run of that row alone.  Device
    ms of the kernel, the twin and SDPA with no mask, and the bound (q, k,
    v, o moved once; 4 * B * H * T^2 * dk operations)."""
    import torch.nn.functional as F

    from easevoice_trainer_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(1212)
    tol, h, dk = 1e-4, 8, 64
    out = {}
    for label, b, t in ROFORMER_SHAPES:
        qkv = torch.randn((b, t, 3, h, dk), generator=gen, device="cuda")
        q, k = (qkv[:, :, i].contiguous() for i in (0, 1))
        v = qkv[:, :, 2]
        full = torch.full((b,), t, dtype=torch.int32, device="cuda")
        zeros = torch.zeros_like(full)
        got = att.encoder_attention(q, k, v, full)
        want = att.prefill_attention_reference(q, k, v, t, full, zeros)
        err = max_err(torch, got, want)
        row_err, same = 0.0, True
        for i in range(b):
            alone = att.encoder_attention(q[i:i + 1], k[i:i + 1],
                                          v[i:i + 1], full[i:i + 1])[0]
            row_err = max(row_err, max_err(torch, alone, got[i]))
            same &= torch.equal(alone, got[i])
        qh, kh, vh = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        sdpa = functools.partial(F.scaled_dot_product_attention, qh, kh, vh)
        lib_err = max_err(torch, sdpa().transpose(1, 2), want)
        times = (
            device_ms(torch, lambda: att.encoder_attention(q, k, v, full),
                      "prefill_attention"),
            device_ms(torch, lambda: att.prefill_attention_reference(
                q, k, v, t, full, zeros)),
            device_ms(torch, sdpa))
        one = Bound()
        one.add(4 * 4 * b * t * h * dk, 4 * b * h * t * t * dk)
        log(f"[kernels] encoder_attention (K1 dk=64) {label} axis B={b} "
            f"H={h} T={t} no padding: max|d|={err:.3g} (tol {tol}); each row "
            f"alone: max|d|={row_err:.3g}, bit-identical {same}; device ms: "
            f"kernel {times[0]:.5f}, plain {times[1]:.4f}, SDPA (no mask) "
            f"{times[2]:.5f} (max|d| {lib_err:.3g}); bound {one.ms:.5f} "
            f"({one.by}), kernel at {100 * one.ms / times[0]:.1f} % of it")
        assert err <= tol and row_err <= tol, (label, err, row_err)
        out[label] = dict(B=b, H=h, T=t, max_abs_err=err,
                          row_alone_max_abs_err=row_err,
                          rows_bit_identical=same, ms=times[0],
                          plain_ms=times[1], library_ms=times[2],
                          **one.result())
        del qkv, q, k, v, qh, kh, vh, sdpa, got, want
    results["encoder_attention"]["roformer"] = out


def check_k4(torch, results):
    """K4's two entry points against their twins at the s2 step's shapes:
    B=8, every Generator stage of one 32-frame segment, k in {3, 7, 11},
    d in {1, 3, 5}.  dx is a sum of Cout*k products, like K3's output, and
    takes K3's tolerance, 1e-4 x max(1, max|twin|).  dW and db are sums of
    B*T (up to 163,840) products, split per shape into ranges of samples
    whose partial sums are added in a fixed order (ops/mrf.py wgrad_plan),
    in another order than cuDNN's: 1e-3 x max(1, max|twin|).  A wrong tap or
    index gives errors of order 1.  The library calls are cuDNN's dgrad
    (conv_transpose1d) and wgrad (conv1d_weight on the leaky-relu'd input).
    Both kernels must not be slower than their library call over the 45
    shapes; the tensor-core instructions in dW's SASS are counted."""
    import torch.nn.functional as F

    from easevoice_trainer_tpu_torch.nn.layers import LRELU_SLOPE
    from easevoice_trainer_tpu_torch.ops import mrf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    b = 8
    tol_dx, tol_dw = 1e-4, 1e-3
    names = ("mrf_conv_bwd_data", "mrf_conv_bwd_weight")
    worst = {name: 0.0 for name in names}
    worst_rel = dict(worst)
    times = {name: [0.0, 0.0, 0.0] for name in names}  # kernel/plain/library
    bounds = {name: Bound() for name in names}
    stage_sums = []
    for ch, t_len in S2_STAGES:
        x = torch.randn((b, ch, t_len), generator=gen, device=dev)
        dy = torch.randn((b, ch, t_len), generator=gen, device=dev)
        act = F.leaky_relu(x, LRELU_SLOPE)
        sums = [0.0] * 4  # dx kernel, cuDNN dgrad, dW kernel, cuDNN wgrad
        for kk in (3, 7, 11):
            w = torch.randn((ch, ch, kk), generator=gen, device=dev) \
                / math.sqrt(ch * kk)
            for d in (1, 3, 5):
                pad = (kk - 1) * d // 2
                got = mrf.mrf_conv_bwd_data(dy, x, w, d)
                want = mrf.mrf_conv_bwd_data_reference(dy, x, w, d)
                err_x = max_err(torch, got, want)
                rel_x = err_x / max(1.0, float(want.abs().max()))
                gw, gb = mrf.mrf_conv_bwd_weight(dy, x, w.shape, d)
                ww, wb = mrf.mrf_conv_bwd_weight_reference(dy, x, w.shape, d)
                err_w = max(max_err(torch, gw, ww), max_err(torch, gb, wb))
                rel_w = err_w / max(1.0, float(ww.abs().max()),
                                    float(wb.abs().max()))
                # a second launch must repeat the first bit for bit
                gw2, gb2 = mrf.mrf_conv_bwd_weight(dy, x, w.shape, d)
                assert torch.equal(gw, gw2) and torch.equal(gb, gb2), \
                    "mrf_conv_bwd_weight does not repeat"
                fns = {
                    "mrf_conv_bwd_data": (
                        lambda: mrf.mrf_conv_bwd_data(dy, x, w, d),
                        lambda: mrf.mrf_conv_bwd_data_reference(dy, x, w, d),
                        lambda: F.conv_transpose1d(dy, w, padding=pad,
                                                   dilation=d)),
                    "mrf_conv_bwd_weight": (
                        lambda: mrf.mrf_conv_bwd_weight(dy, x, w.shape, d),
                        lambda: mrf.mrf_conv_bwd_weight_reference(
                            dy, x, w.shape, d),
                        lambda: torch.nn.grad.conv1d_weight(
                            act, w.shape, dy, padding=pad, dilation=d)),
                }
                flops = 2 * b * t_len * ch * ch * kk
                line = []
                for name, e, r in zip(names, (err_x, err_w), (rel_x, rel_w)):
                    kern, plain, lib = fns[name]
                    ts = (device_ms(torch, kern), device_ms(torch, plain),
                          device_ms(torch, lib))
                    worst[name] = max(worst[name], e)
                    worst_rel[name] = max(worst_rel[name], r)
                    times[name] = [a + t for a, t in zip(times[name], ts)]
                    # dx: dy, x, w in, dx out; dW: dy, x in, dw, db out
                    bounds[name].add(4 * (3 * b * ch * t_len + ch * ch * kk)
                                     if name == names[0] else
                                     4 * (2 * b * ch * t_len + ch * ch * kk
                                          + ch), flops)
                    line.append(f"max|d|={e:.3g} rel {r:.3g}, device ms "
                                f"kernel {ts[0]:.4f}, plain {ts[1]:.4f}, "
                                f"cuDNN {ts[2]:.4f}")
                    at = 0 if name == names[0] else 2
                    sums[at] += ts[0]
                    sums[at + 1] += ts[2]
                plan = mrf.wgrad_card_plan(b, ch, ch, t_len, kk, d, dev)
                limits = [mrf.card_clusters(
                    torch.cuda.current_device(), plan.bn, plan.bi,
                    plan.taps, kk, d, plan.cluster, probe) for probe in
                    (False, True)]
                log(f"[kernels] K4 B={b} C={ch} T={t_len} k={kk} d={d}: dx "
                    f"{line[0]}; dW/db {line[1]}; dW plan: tile {plan.bn} x "
                    f"{plan.bi} x {plan.taps} taps, {plan.tiles} tiles x "
                    f"{plan.cluster} x {plan.clusters} clusters = "
                    f"{plan.blocks} blocks, scratch "
                    f"{plan.scratch_floats * 4 / 1e6:.2f} MB; clusters of "
                    f"{plan.cluster} resident: occupancy query {limits[0]}, "
                    f"accepted by a cooperative launch {limits[1]}")
        stage_sums.append((ch, t_len, sums))
    for i, (ch, t_len, (dx, dgrad, dw, wgrad)) in enumerate(stage_sums):
        log(f"[kernels] K4 stage {i} (C={ch}, T={t_len}), 9 shapes: dx "
            f"kernel {dx:.3f} ms, cuDNN dgrad {dgrad:.3f} ms; dW/db kernel "
            f"{dw:.3f} ms, cuDNN wgrad {wgrad:.3f} ms")
    # the card against the CPU twin on two shapes
    for ch, t_len, kk, d in ((256, 320, 11, 5), (16, 20480, 3, 1)):
        x = torch.randn((b, ch, t_len), generator=gen, device=dev)
        dy = torch.randn((b, ch, t_len), generator=gen, device=dev)
        w = torch.randn((ch, ch, kk), generator=gen, device=dev) \
            / math.sqrt(ch * kk)
        got = mrf.mrf_conv_bwd_data(dy, x, w, d).cpu()
        want = mrf.mrf_conv_bwd_data_reference(dy.cpu(), x.cpu(), w.cpu(), d)
        rel_x = max_err(torch, got, want) / max(1.0, float(want.abs().max()))
        gw, gb = mrf.mrf_conv_bwd_weight(dy, x, w.shape, d)
        ww, wb = mrf.mrf_conv_bwd_weight_reference(dy.cpu(), x.cpu(),
                                                   w.shape, d)
        rel_w = max(max_err(torch, gw.cpu(), ww), max_err(
            torch, gb.cpu(), wb)) / max(1.0, float(ww.abs().max()))
        worst_rel["mrf_conv_bwd_data"] = max(worst_rel["mrf_conv_bwd_data"],
                                             rel_x)
        worst_rel["mrf_conv_bwd_weight"] = max(
            worst_rel["mrf_conv_bwd_weight"], rel_w)
        log(f"[kernels] K4 C={ch} T={t_len} k={kk} d={d} against the CPU "
            f"twin: dx relative {rel_x:.3g}, dW/db relative {rel_w:.3g}")
    for name, tol in (("mrf_conv_bwd_data", tol_dx),
                      ("mrf_conv_bwd_weight", tol_dw)):
        kern, plain, lib = times[name]
        bd = bounds[name]
        log(f"[kernels] K4 {name} 45 shapes: max|d|={worst[name]:.3g}, "
            f"relative {worst_rel[name]:.3g} (tol {tol} x max(1, "
            f"max|twin|)); device ms summed over shapes: kernel {kern:.3f}, "
            f"cuDNN {lib:.3f}, plain {plain:.3f}; bound {bd.ms:.3f} "
            f"({bd.by}; bytes {bd.bytes_ms:.3f}, fp32 operations "
            f"{bd.ops_ms:.3f})")
        assert worst_rel[name] <= tol, f"{name} disagrees: {worst_rel[name]}"
        results[name] = dict(max_abs_err=worst[name], ms=kern,
                             plain_ms=plain, library_ms=lib, **bd.result())
    for name, label, call in (("mrf_conv_bwd_data", "dx", "dgrad"),
                              ("mrf_conv_bwd_weight", "dW", "wgrad")):
        kern, lib = times[name][0], times[name][2]
        assert kern <= lib, (f"K4 {label} ({kern:.3f} ms) is slower than "
                             f"cuDNN {call} ({lib:.3f} ms)")
    from easevoice_trainer_tpu_torch.ops import build

    tensor = {name: sum(opcode(ln).split(".")[0] in ("HGMMA", "HMMA")
                        for body in bodies for ln in body)
              for name, bodies in sass_functions(
                  build.build().path,
                  ("wgrad_wgmma_kernel", "wgrad_mma_kernel")).items()}
    log("[kernels] K4 dW tensor-core instructions (HGMMA / HMMA) in the "
        "SASS: " + ", ".join(f"{short_name(n)} {c}"
                             for n, c in sorted(tensor.items())))
    assert tensor and all(tensor.values()), tensor


def s1_lens(torch, gen, b: int, x_len: int, y_len: int):
    """Ragged (x_lens, y_lens) of one s1 micro-batch on the card: one row
    at each full length, the others drawn from ``gen``."""
    x_lens = torch.randint(1, x_len + 1, (b,), generator=gen, device="cuda")
    y_lens = torch.randint(1, y_len + 1, (b,), generator=gen, device="cuda")
    x_lens[0], y_lens[-1] = x_len, y_len
    return x_lens.to(torch.int32), y_lens.to(torch.int32)


def check_k5(torch, results, parent=None):
    """K1 writing its row logsumexp, and K5 (its gradient), at the s1
    micro-batch shapes: B=8, H=16, dk=32, 416 phonemes and 300 or 1360
    tokens, ragged lengths.  K1's o and lse against the twins (1e-4
    absolute); K5's dq, dk and dv against its plain twin on K1's own o and
    lse, 1e-4 x max(1, max|twin|) each (sums of up to T products in
    another order); a second K5 launch bit-identical.  Device ms of K1 (with
    lse) and of K5, of their twins, and of the library calls: SDPA forward,
    and SDPA's backward through torch.autograd.grad with the same float
    mask; K5 must not be slower than SDPA's backward.  K5's bound counts
    only the visible (row, key) pairs: five dk-long products each (S, dP,
    dV, dK, dQ), in 3xTF32; its bytes are q, k, v, o, dO, lse read and dq,
    dk, dv written once.  The count of HMMA (mma.sync) instructions in each
    K5 kernel's SASS; its dq and dkdv kernels must have some.  ``parent``:
    the parent commit's ``ops.attention``, whose K5 is then timed in turns
    with this tree's on the same inputs; the two trees' gradients must be
    bit-identical."""
    import torch.nn.functional as F

    from easevoice_trainer_tpu_torch.ops import attention as att
    from easevoice_trainer_tpu_torch.ops import build

    tensor = {short_name(n): sum(opcode(ln).split(".")[0] == "HMMA"
                                 for body in bodies for ln in body)
              for n, bodies in sass_functions(
                  build.build().path,
                  ("dsum_kernel", "dkdv_kernel", "dq_kernel")).items()}
    log("[kernels] K5 tensor-core instructions (HMMA) in the SASS: "
        + ", ".join(f"{n} {c}" for n, c in sorted(tensor.items())))
    assert all(tensor.get(f"{k}<{drop}>") for k in ("dq_kernel",
                                                    "dkdv_kernel")
               for drop in ("false", "true")), tensor

    gen = torch.Generator(device="cuda").manual_seed(6006)
    b, h, dk, x_len = S1_B, 16, 32, S1_X_LEN
    tol = 1e-4
    sums = {"k1": [0.0, 0.0, 0.0], "k5": [0.0, 0.0, 0.0]}
    bounds = {"k1": Bound(), "k5": Bound()}
    worst = {"k1": 0.0, "k5": 0.0}
    worst_rel = 0.0
    ab = [0.0, 0.0]   # K5 in turns: this tree, the parent
    ab_rel, ab_same = 0.0, True
    for y_len in S1_Y_LENS:
        t = x_len + y_len
        x_lens, y_lens = s1_lens(torch, gen, b, x_len, y_len)
        qkv = torch.randn((b, t, 3 * h * dk), generator=gen, device="cuda")
        q, k, v = att._split_heads(qkv, h)
        do = torch.randn((b, t, h, dk), generator=gen, device="cuda")
        o, lse = att.prefill_attention_lse(q, k, v, x_len, x_lens, y_lens)
        want_o = att.prefill_attention_reference(q, k, v, x_len, x_lens,
                                                 y_lens)
        want_lse = att.prefill_attention_lse_reference(q, k, x_len, x_lens,
                                                       y_lens)
        err_k1 = max(max_err(torch, o, want_o), max_err(torch, lse, want_lse))
        got = att.prefill_attention_bwd(q, k, v, o, lse, do, x_len, x_lens,
                                        y_lens)
        want = att.prefill_attention_bwd_reference(q, k, v, o, lse, do,
                                                   x_len, x_lens, y_lens)
        rel = max(max_err(torch, g, w) / max(1.0, float(w.abs().max()))
                  for g, w in zip(got, want))
        abs_err = max(max_err(torch, g, w) for g, w in zip(got, want))
        again = att.prefill_attention_bwd(q, k, v, o, lse, do, x_len, x_lens,
                                          y_lens)
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        del want, again
        # the library: SDPA with the hybrid mask as a float bias, heads
        # first; its backward alone, through autograd
        bias = att.build_hybrid_mask_bias(x_len, y_len, x_lens, y_lens)
        qh, kh, vh = (z.transpose(1, 2).contiguous().requires_grad_()
                      for z in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
        lib_err = max_err(torch, out.detach().transpose(1, 2), want_o)
        doh = do.transpose(1, 2).contiguous()
        lib_bwd = functools.partial(torch.autograd.grad, out, (qh, kh, vh),
                                    doh, retain_graph=True)
        lib_grads = lib_bwd()
        lib_bwd_err = max(
            max_err(torch, g.transpose(1, 2), w) / max(1.0, float(
                w.abs().max())) for g, w in zip(lib_grads, got))
        times = {
            "k1": (device_ms(torch, lambda: att.prefill_attention_lse(
                       q, k, v, x_len, x_lens, y_lens)),
                   device_ms(torch, lambda: (
                       att.prefill_attention_reference(
                           q, k, v, x_len, x_lens, y_lens),
                       att.prefill_attention_lse_reference(
                           q, k, x_len, x_lens, y_lens)), reps=5),
                   device_ms(torch, lambda: F.scaled_dot_product_attention(
                       qh.detach(), kh.detach(), vh.detach(),
                       attn_mask=bias))),
            "k5": (device_ms(torch, lambda: att.prefill_attention_bwd(
                       q, k, v, o, lse, do, x_len, x_lens, y_lens)),
                   device_ms(torch, lambda: (
                       att.prefill_attention_bwd_reference(
                           q, k, v, o, lse, do, x_len, x_lens, y_lens)),
                       reps=5),
                   device_ms(torch, lib_bwd, reps=5)),
        }
        if parent is not None:
            def k5(mod):
                return lambda: mod.prefill_attention_bwd(
                    q, k, v, o, lse, do, x_len, x_lens, y_lens)

            ms, parent_ms = in_turns(torch, k5(att), k5(parent))
            ab = [ab[0] + ms, ab[1] + parent_ms]
            old_g = k5(parent)()
            ab_rel = max(ab_rel, max(
                max_err(torch, g, w) / max(1.0, float(w.abs().max()))
                for g, w in zip(got, old_g)))
            ab_same = ab_same and all(
                torch.equal(g, w) for g, w in zip(got, old_g))
            del old_g
        pairs = int((bias == 0).sum()) * h
        elems = b * t * h * dk
        bounds["k1"].add(4 * (4 * elems + b * h * t), 4 * dk * pairs)
        bounds["k5"].add(4 * (8 * elems + b * h * t), 10 * dk * pairs)
        for key in sums:
            sums[key] = [a + c for a, c in zip(sums[key], times[key])]
        worst["k1"] = max(worst["k1"], err_k1)
        worst["k5"] = max(worst["k5"], abs_err)
        worst_rel = max(worst_rel, rel)
        log(f"[kernels] K1 + lse B={b} H={h} x_len={x_len} y_len={y_len} "
            f"(T={t}): o / lse max|d|={err_k1:.3g} (tol {tol}); device ms: "
            f"kernel {times['k1'][0]:.4f}, plain {times['k1'][1]:.4f}, SDPA "
            f"{times['k1'][2]:.4f} (max|d| {lib_err:.3g})")
        log(f"[kernels] K5 prefill_attention_bwd B={b} H={h} x_len={x_len} "
            f"x_lens={x_lens.tolist()} y_len={y_len} "
            f"y_lens={y_lens.tolist()}: dq/dk/dv max|d|={abs_err:.3g}, "
            f"relative {rel:.3g} (tol {tol} x max(1, max|twin|)), finite "
            f"{finite}, repeats bit for bit {same}; "
            f"{pairs} visible (row, key, head) triples; device ms: kernel "
            f"{times['k5'][0]:.4f}, plain {times['k5'][1]:.4f}, SDPA "
            f"backward {times['k5'][2]:.4f} (relative max|d| against K5 "
            f"{lib_bwd_err:.3g})")
        assert err_k1 <= tol, f"K1 with lse disagrees: {err_k1}"
        assert rel <= tol and finite and same, \
            f"K5 disagrees ({rel}), is not finite or does not repeat"
        del qkv, q, k, v, do, o, lse, got, qh, kh, vh, out, lib_grads, bias
        torch.cuda.empty_cache()
    log(f"[kernels] K5 worst relative error over the s1 shapes "
        f"{worst_rel:.3g}")
    for key, name in (("k1", "K1 + lse"), ("k5", "K5")):
        kern, plain, lib = sums[key]
        bd = bounds[key]
        log(f"[kernels] {name} over the two s1 shapes: kernel {kern:.4f} ms, "
            f"plain {plain:.4f} ms, library {lib:.4f} ms; bound "
            f"{bd.ms:.4f} ms ({bd.by}; bytes {bd.bytes_ms:.4f}, operations "
            f"{bd.ops_ms:.4f}): kernel at {100 * bd.ms / kern:.1f} % of its "
            f"bound")
    if parent is not None:
        log(f"[a/b] K5 prefill_attention_bwd, the two s1 shapes, same "
            f"inputs, in turns: parent {ab[1]:.4f} ms -> this tree "
            f"{ab[0]:.4f} ms ({ab[1] / ab[0]:.2f}x); largest |this - parent| "
            f"/ max(1, max|parent|) {ab_rel:.3g}; gradients bit-identical "
            f"{ab_same}")
        assert ab_same, "the fp32 K5's gradients differ from the parent's"
    kern, lib = sums["k5"][0], sums["k5"][2]
    assert kern <= lib, (f"K5 ({kern:.4f} ms) is slower than SDPA's "
                         f"backward ({lib:.4f} ms)")
    results["prefill_attention"]["s1"] = dict(
        ms=sums["k1"][0], plain_ms=sums["k1"][1], library_ms=sums["k1"][2],
        max_abs_err=worst["k1"], **bounds["k1"].result())
    results["prefill_attention_bwd"] = dict(
        max_abs_err=worst["k5"], ms=sums["k5"][0], plain_ms=sums["k5"][1],
        library_ms=sums["k5"][2], **bounds["k5"].result())


# ---------------------------------------------------------------------------
# phase 3, bf16: the fine-tunes' bf16 instances against their bf16 twins
# ---------------------------------------------------------------------------

# the card's dense bf16 tensor-core rate (NVIDIA's H100 SXM data sheet)
BF16_OPS_PER_S = 989e12
# a bf16 instance against its bf16 twin: both round an fp32 result that
# differs in summation order only, so they differ by one bf16 step where
# they round apart (or by a step of a larger intermediate in K3's chain of
# roundings): every element within BF16_TOL x max(1, max|twin|), and at most
# BF16_SHARE of the elements off by more than one step of their own value
BF16_TOL = 2.0 ** -6
BF16_SHARE = 0.02


def bf16_err(torch, got, want):
    """(max |got - want|, that / max(1, max|want|), the share of elements
    off by more than one bf16 step of their own value)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    top = float(err.max()) if err.numel() else 0.0
    share = float((err > 2.0 ** -7 * w.abs() + 1e-6).float().mean())
    return top, top / max(1.0, float(w.abs().max())), share


class _Worst:
    """The worst (max|d|, relative, share) over a kernel's comparisons."""

    def __init__(self):
        self.abs = self.rel = self.share = 0.0

    def add(self, e) -> None:
        self.abs = max(self.abs, e[0])
        self.rel = max(self.rel, e[1])
        self.share = max(self.share, e[2])

    def ok(self) -> bool:
        return self.rel <= BF16_TOL and self.share <= BF16_SHARE

    def __str__(self) -> str:
        return (f"max|d|={self.abs:.3g}, relative {self.rel:.3g} (tol "
                f"{BF16_TOL:.3g}), share off by more than a step "
                f"{self.share:.3g} (tol {BF16_SHARE})")


# K1 / K5 tile edges, as the card tests take them (x_len, x_lens, y_len,
# y_lens): x_len 15 / 16 / 17, T < 16, a batch row that is all pads
BF16_ATTN_EDGES = ((15, [15, 1, 14], 17, [17, 8, 9]),
                   (16, [16, 7, 16], 15, [15, 1, 7]),
                   (17, [17, 16, 9], 40, [40, 17, 15]),
                   (5, [5, 2], 9, [9, 1]),
                   (8, [0, 8, 3], 24, [0, 0, 24]),
                   # K5 bf16's own tiles (the card tests' K5_BF16_EDGES):
                   # 64-key / 64-row / 32-key tiles one off, T < 16, rows
                   # that see no key
                   (63, [63, 31, 33], 66, [66, 1, 65]),
                   (64, [64, 48, 16], 65, [65, 64, 0]),
                   (65, [65, 33, 32], 127, [127, 16, 17]),
                   (1, [1, 0], 14, [14, 0]),
                   (31, [0, 31], 33, [33, 32]),
                   (33, [32, 1], 95, [64, 95]),
                   # K1 bf16's own (the card tests' K1_BF16_EDGES): its
                   # 128-row query tiles and 64-key staged tiles one off, a
                   # one-row T, rows that see no key
                   (64, [64, 63, 1], 63, [63, 62, 1]),
                   (63, [63, 0, 17], 65, [65, 64, 0]),
                   (65, [65, 64, 63], 64, [64, 1, 0]),
                   (128, [0, 128], 1, [0, 1]),
                   (0, [0, 0], 1, [1, 0]),
                   (1, [1, 0], 0, [0, 0]))
# K3 / K4 tile edges (Cin, Cout, B, T, k, d): T below a tile and its halo, a
# single sample, T % 4 != 0, channels off the tiles, k = 5, k = 15, a
# channel split with uneven shares; then the bf16 loop's own: reductions
# shorter than one 16-channel chunk (Cin 8 and 12, K4-dx's Cout 12), T % 8
# of 6 and 2 with the halo across both tile edges, Cout off the 64-row tile
BF16_CONV_EDGES = ((24, 24, 3, 5, 11, 5), (16, 72, 3, 1, 3, 1),
                   (24, 40, 3, 37, 3, 1), (72, 24, 3, 301, 7, 3),
                   (40, 24, 3, 260, 5, 5), (32, 32, 1, 1, 15, 5),
                   (200, 128, 2, 300, 7, 1), (8, 24, 3, 40, 3, 1),
                   (12, 40, 3, 96, 7, 3), (40, 12, 3, 64, 5, 1),
                   (24, 40, 3, 262, 11, 5), (40, 24, 3, 250, 3, 3),
                   (96, 80, 3, 512, 7, 1))


def check_bf16(torch, results, parent=None):
    """The bf16 instances of the s1 and s2 fine-tunes under is_half, each
    against its bf16 twin on the same inputs (BF16_TOL, BF16_SHARE): K1 with
    its lse and K5 at the two s1 micro-batch shapes and at their tile edges
    (BF16_ATTN_EDGES), K5 repeated bit for bit; K3, K4-dx and K4-dW at the
    45 s2 shapes (B=8, every Generator stage, k in {3, 7, 11}, d in
    {1, 3, 5}, K3 with the residual at d = 1 as a ResBlock's second conv)
    and at the tile edges (BF16_CONV_EDGES), K4-dW repeated bit for bit.
    Device ms of each bf16 instance beside the fp32 instance's (the same
    inputs in fp32), the bf16 library call's (SDPA forward and backward;
    cuDNN conv, dgrad, wgrad) and the bf16 twin's; the bound in bf16 (the
    bytes of bf16 operands over 3.35 TB/s against the operations over 989
    TFLOP/s dense bf16), and per Generator stage for K3, K4-dx and K4-dW
    beside cuDNN's bf16 call.  K1 and K5 are timed with their kernel count
    (1 and 3 a call) and, at the s1 shapes, also as CUDA graphs in turns
    with SDPA's bf16 forward and backward captured the same way (their
    library times); repeated launches of each are bit-identical; the SASS
    of K1's bf16 kernel and K5's dkdv and dq must hold bf16 m16n8k16 HMMAs
    and no other tensor-core instruction, and ptxas must report no spill
    for K1's.  ``parent``: the parent commit's ``ops.attention``, whose
    bf16 K1 and K5 are then held to the twin beside this tree's, compared
    with them (K1's lse within 1e-4), and timed in turns with them (by
    kernel count and as graphs).  The K3, K4-dx and K4-dW instances are
    timed with their kernel count (one a shape); K4-dW's plan is logged per
    stage, and its bf16 wgmma route's SASS must hold bf16 HGMMAs and no
    other tensor-core instruction.  No instance is held to be faster than
    its library call: the bf16 K3, K4-dx and K4-dW are timed against the
    parent's in ab_mrf."""
    from easevoice_trainer_tpu_torch.ops import build
    import torch.nn.functional as F

    from easevoice_trainer_tpu_torch.ops import attention as att
    from easevoice_trainer_tpu_torch.ops import mrf

    bf = torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1414)
    names = {"k1": "prefill_attention_bf16", "k5": "prefill_attention_bwd_bf16",
             "k3": "mrf_conv_bf16", "dx": "mrf_conv_bwd_data_bf16",
             "dw": "mrf_conv_bwd_weight_bf16"}
    # kernel bf16, kernel fp32, library bf16, twin bf16
    sums = {key: [0.0, 0.0, 0.0, 0.0] for key in names}
    bounds = {key: Bound(BF16_OPS_PER_S) for key in names}
    worst = {key: _Worst() for key in names}
    lse_err = 0.0
    hmma = {}
    for name, bodies in sass_functions(
            build.build().path, ("prefill_attention_bf16_kernel",
                                 "dkdv_bf16_kernel",
                                 "dq_bf16_kernel")).items():
        counts = hmma.setdefault(short_name(name), {})
        for ln in (ln for body in bodies for ln in body):
            if opcode(ln).startswith(("HMMA", "HGMMA")):
                counts[opcode(ln)] = counts.get(opcode(ln), 0) + 1
    log(f"[kernels] K1 and K5 bf16 tensor-core instructions in the SASS: "
        f"{hmma}")
    # each with and without dropout
    assert len(hmma) == 6 and all(
        c and set(c) == {"HMMA.16816.F32.BF16"} for c in hmma.values()), \
        f"K1 / K5's bf16 kernels are not on bf16 m16n8k16 alone: {hmma}"
    spills = ptxas_spills(build.build().build_log,
                          "prefill_attention_bf16_kernelILb0E")
    log(f"[kernels] K1 bf16, ptxas: {spills or 'library reused, no report'}")
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in spills.values()), f"K1 bf16 spills: {spills}"
    # K4-dW's bf16 wgmma route: bf16 HGMMAs, no TF32 HGMMA, no HMMA
    hgmma = {}
    for name, bodies in sass_functions(
            build.build().path, ("wgrad_wgmma_bf16_kernel",)).items():
        counts = hgmma.setdefault(short_name(name), {})
        for ln in (ln for body in bodies for ln in body):
            if opcode(ln).startswith(("HGMMA", "HMMA")):
                counts[opcode(ln)] = counts.get(opcode(ln), 0) + 1
    log(f"[kernels] K4-dW bf16 wgmma route, tensor-core instructions in the "
        f"SASS: {hgmma}")
    assert len(hgmma) == 2 and all(
        c and all(op.startswith("HGMMA") and ".BF16" in op for op in c)
        for c in hgmma.values()), \
        f"K4-dW's bf16 wgmma route is not on bf16 HGMMA alone: {hgmma}"
    # K1 and K5 bf16 over the s1 shapes as CUDA graphs in turns: this
    # tree's, the parent's, SDPA's bf16 forward and backward
    graph_sums = dict.fromkeys(("k1", "k1_parent", "sdpa_fwd", "k5",
                                "parent", "sdpa"), 0.0)
    # by kernel count, in turns: this tree, the parent
    ab = {"k1": [0.0, 0.0], "k5": [0.0, 0.0]}
    parent_worst, vs_parent = _Worst(), _Worst()   # K5
    k1_parent_worst, k1_vs_parent = _Worst(), _Worst()
    lse_parent = [0.0, 0.0]   # the parent's lse against the twin, this one's

    def k1_call(mod, *args):
        return lambda: mod.prefill_attention_lse(*args)

    def k5_call(mod, *args):
        return lambda: mod.prefill_attention_bwd(*args)

    def attention_case(x_len, x_lens, y_len, y_lens, timed):
        nonlocal lse_err
        b, h, dk, t = len(x_lens), 16, 32, x_len + y_len
        xl = torch.tensor(x_lens, dtype=torch.int32, device=dev)
        yl = torch.tensor(y_lens, dtype=torch.int32, device=dev)
        qkv32 = torch.randn((b, t, 3 * h * dk), generator=gen, device=dev)
        do32 = torch.randn((b, t, h, dk), generator=gen, device=dev)
        qkv, do = qkv32.to(bf), do32.to(bf)
        q, k, v = att._split_heads(qkv, h)
        k1_args = (q, k, v, x_len, xl, yl)
        o, lse = att.prefill_attention_lse(*k1_args)
        want_o = torch.nan_to_num(att.prefill_attention_reference(
            q, k, v, x_len, xl, yl), nan=0.0)
        worst["k1"].add(bf16_err(torch, o, want_o))
        want_lse = att.prefill_attention_lse_reference(q, k, x_len, xl, yl)
        seen = torch.isfinite(want_lse)
        assert torch.equal(torch.isfinite(lse), seen)
        assert not o[~seen.transpose(1, 2)].any(), \
            "K1 bf16: a row that sees no key is not 0"
        lse_err = max(lse_err, max_err(torch, lse[seen], want_lse[seen]))
        for _ in range(2):
            again = att.prefill_attention_lse(*k1_args)
            assert torch.equal(o, again[0]) and torch.equal(lse, again[1]), \
                "K1's bf16 instance does not repeat"
        if parent is not None:
            old_o, old_lse = parent.prefill_attention_lse(*k1_args)
            k1_parent_worst.add(bf16_err(torch, old_o, want_o))
            k1_vs_parent.add(bf16_err(torch, o, old_o))
            assert torch.equal(torch.isfinite(old_lse), seen)
            lse_parent[0] = max(lse_parent[0], max_err(
                torch, old_lse[seen], want_lse[seen]))
            lse_parent[1] = max(lse_parent[1], max_err(
                torch, lse[seen], old_lse[seen]))
            del old_o, old_lse
        got = att.prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl)
        want = att.prefill_attention_bwd_reference(q, k, v, o, lse, do,
                                                   x_len, xl, yl)
        for g, w in zip(got, want):
            assert g.dtype == bf and torch.isfinite(g.float()).all()
            worst["k5"].add(bf16_err(torch, g, w))
        for _ in range(2):
            again = att.prefill_attention_bwd(q, k, v, o, lse, do, x_len,
                                              xl, yl)
            assert all(torch.equal(a, c) for a, c in zip(got, again)), \
                "K5's bf16 instance does not repeat"
        k5_args = (q, k, v, o, lse, do, x_len, xl, yl)
        if parent is not None:
            old = parent.prefill_attention_bwd(*k5_args)
            for g, w, c in zip(old, want, got):
                parent_worst.add(bf16_err(torch, g, w))
                vs_parent.add(bf16_err(torch, c, g))
            del old
        del want, again
        if not timed:
            return
        q32, k32, v32 = att._split_heads(qkv32, h)
        o32, lse32 = att.prefill_attention_lse(q32, k32, v32, x_len, xl, yl)
        bias = att.build_hybrid_mask_bias(x_len, y_len, xl, yl)
        mask = bias.to(bf)
        qh, kh, vh = (z.transpose(1, 2).contiguous().requires_grad_()
                      for z in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        # the forward on the graphs' stream, so that its backward runs there
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        torch.cuda.current_stream().wait_stream(stream)
        lib_bwd = functools.partial(torch.autograd.grad, out, (qh, kh, vh),
                                    doh, retain_graph=True)
        lib_fwd = functools.partial(F.scaled_dot_product_attention,
                                    qh.detach(), kh.detach(), vh.detach(),
                                    attn_mask=mask)
        graphs = {"sdpa": graph_timer(torch, lib_bwd, stream),
                  "sdpa_fwd": graph_timer(torch, lib_fwd, stream),
                  "k5": graph_timer(torch, k5_call(att, *k5_args), stream),
                  "k1": graph_timer(torch, k1_call(att, *k1_args), stream)}
        ends, middle = ["sdpa", "sdpa_fwd"], ["k5", "k1"]
        if parent is not None:
            graphs["parent"] = graph_timer(
                torch, k5_call(parent, *k5_args), stream)
            graphs["k1_parent"] = graph_timer(
                torch, k1_call(parent, *k1_args), stream)
            ends += ["parent", "k1_parent"]
        order = ends + middle + middle[::-1] + ends[::-1]
        gms = {}
        for key in order:
            gms.setdefault(key, []).append(graphs[key]())
        gms = {key: sum(ms) / len(ms) for key, ms in gms.items()}
        for key, ms in gms.items():
            graph_sums[key] += ms
        del graphs
        times = {
            "k1": (device_ms(torch, k1_call(att, *k1_args), launches=1),
                   device_ms(torch, lambda: att.prefill_attention_lse(
                       q32, k32, v32, x_len, xl, yl)),
                   gms["sdpa_fwd"],
                   device_ms(torch, lambda: (
                       att.prefill_attention_reference(
                           q, k, v, x_len, xl, yl),
                       att.prefill_attention_lse_reference(
                           q, k, x_len, xl, yl)), reps=5)),
            "k5": (device_ms(torch, k5_call(att, *k5_args),
                             launches=3),
                   device_ms(torch, lambda: att.prefill_attention_bwd(
                       q32, k32, v32, o32, lse32, do32, x_len, xl, yl),
                       launches=3),
                   gms["sdpa"],
                   device_ms(torch, lambda: att.prefill_attention_bwd_reference(
                       q, k, v, o, lse, do, x_len, xl, yl), reps=5)),
        }
        if parent is not None:
            for key, call, args, n in (("k1", k1_call, k1_args, 1),
                                       ("k5", k5_call, k5_args, 3)):
                ms, parent_ms = in_turns(torch, call(att, *args),
                                         call(parent, *args), launches=n)
                ab[key] = [ab[key][0] + ms, ab[key][1] + parent_ms]
        pairs = int((bias == 0).sum()) * h
        elems = b * t * h * dk
        # K1: q, k, v read, o written (bf16), lse written (fp32); QK, PV.
        # K5: q, k, v, o, dO read and dq, dk, dv written (bf16), lse read
        # (fp32); S, dP, dV, dK, dQ
        bounds["k1"].add(2 * 4 * elems + 4 * b * h * t, 4 * dk * pairs)
        bounds["k5"].add(2 * 8 * elems + 4 * b * h * t, 10 * dk * pairs)
        for key in ("k1", "k5"):
            sums[key] = [a + c for a, c in zip(sums[key], times[key])]
        log(f"[kernels] bf16 K1 + lse / K5 B={b} H={h} x_len={x_len} "
            f"y_len={y_len} (T={t}): device ms K1 bf16 {times['k1'][0]:.4f}, "
            f"fp32 {times['k1'][1]:.4f}, twin "
            f"{times['k1'][3]:.4f}; K5 bf16 {times['k5'][0]:.4f}, fp32 "
            f"{times['k5'][1]:.4f}, twin {times['k5'][3]:.4f}; as CUDA "
            f"graphs in turns: " + ", ".join(
                f"{label} {gms[key]:.4f}" for key, label in (
                    ("k1", "K1 bf16"), ("k1_parent", "the parent's K1 bf16"),
                    ("sdpa_fwd", "SDPA forward bf16"), ("k5", "K5 bf16"),
                    ("parent", "the parent's K5 bf16"),
                    ("sdpa", "SDPA backward bf16")) if key in gms))
        del qh, kh, vh, out, lib_bwd, lib_fwd, bias, mask, o32, lse32, doh

    for y_len in S1_Y_LENS:
        xl, yl = s1_lens(torch, gen, S1_B, S1_X_LEN, y_len)
        attention_case(S1_X_LEN, xl.tolist(), y_len, yl.tolist(), True)
        torch.cuda.empty_cache()
    for case in BF16_ATTN_EDGES:
        attention_case(*case, False)

    def conv_inputs(b, cin, cout, t_len, k):
        x32 = torch.randn((b, cin, t_len), generator=gen, device=dev)
        x32[0, :, : max(1, t_len // 3)] = 0.0   # lrelu(0) = 0, lrelu'(0) = 1
        dy32 = torch.randn((b, cout, t_len), generator=gen, device=dev)
        w32 = torch.randn((cout, cin, k), generator=gen, device=dev) \
            / math.sqrt(cin * k)
        bias32 = torch.randn((cout,), generator=gen, device=dev) * 0.1
        return x32, dy32, w32, bias32

    def conv_case(x, dy, w, bias, d, res):
        y = mrf.mrf_conv(x, w, bias, d, residual=res)
        worst["k3"].add(bf16_err(torch, y, mrf.mrf_conv_reference(
            x, w, bias, d, residual=res)))
        dx = mrf.mrf_conv_bwd_data(dy, x, w, d)
        worst["dx"].add(bf16_err(torch, dx, mrf.mrf_conv_bwd_data_reference(
            dy, x, w, d)))
        gw, gb = mrf.mrf_conv_bwd_weight(dy, x, w.shape, d)
        ww, wb = mrf.mrf_conv_bwd_weight_reference(dy, x, w.shape, d)
        worst["dw"].add(bf16_err(torch, gw, ww))
        worst["dw"].add(bf16_err(torch, gb, wb))
        gw2, gb2 = mrf.mrf_conv_bwd_weight(dy, x, w.shape, d)
        assert torch.equal(gw, gw2) and torch.equal(gb, gb2), \
            "K4-dW's bf16 instance does not repeat"

    b = 8
    for i, (ch, t_len) in enumerate(S2_STAGES):
        x32, dy32, _, _ = conv_inputs(b, ch, ch, t_len, 3)
        x, dy = x32.to(bf), dy32.to(bf)
        act = mrf.leaky_relu(x)   # bf16, as JAX rounds it
        shapes = []
        for kk in (3, 7, 11):
            _, _, w32, bias32 = conv_inputs(1, ch, ch, 1, kk)
            w, bias = w32.to(bf), bias32.to(bf)
            for d in (1, 3, 5):
                res, res32 = (x, x32) if d == 1 else (None, None)
                conv_case(x, dy, w, bias, d, res)
                shapes.append((w, w32, bias, bias32, d, res, res32, kk))
                pad = (kk - 1) * d // 2
                flops = 2 * b * t_len * ch * ch * kk
                bounds["k3"].add(2 * (b * ch * t_len * (
                    3 if res is not None else 2) + ch * ch * kk + ch), flops)
                bounds["dx"].add(2 * (3 * b * ch * t_len + ch * ch * kk),
                                 flops)
                bounds["dw"].add(2 * (2 * b * ch * t_len + ch * ch * kk + ch),
                                 flops)

        def each(fn):
            return lambda: [fn(*s) for s in shapes]

        def cudnn_conv(w, w32, bias, bias32, d, res, res32, kk):
            y = F.conv1d(act, w, bias, padding=(kk - 1) * d // 2,
                         dilation=d)
            return y if res is None else y + res

        runs = {
            "k3": (each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        mrf.mrf_conv(x, w, bias, d, residual=res)),
                   each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        mrf.mrf_conv(x32, w32, bias32, d, residual=res32)),
                   each(cudnn_conv),
                   each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        mrf.mrf_conv_reference(x, w, bias, d, residual=res))),
            "dx": (each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        mrf.mrf_conv_bwd_data(dy, x, w, d)),
                   each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        mrf.mrf_conv_bwd_data(dy32, x32, w32, d)),
                   each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        F.conv_transpose1d(dy, w, padding=(kk - 1) * d // 2,
                                           dilation=d)),
                   each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        mrf.mrf_conv_bwd_data_reference(dy, x, w, d))),
            "dw": (each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        mrf.mrf_conv_bwd_weight(dy, x, w.shape, d)),
                   each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        mrf.mrf_conv_bwd_weight(dy32, x32, w32.shape, d)),
                   each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        torch.nn.grad.conv1d_weight(
                            act, w.shape, dy, padding=(kk - 1) * d // 2,
                            dilation=d)),
                   each(lambda w, w32, bias, bias32, d, res, res32, kk:
                        mrf.mrf_conv_bwd_weight_reference(dy, x, w.shape,
                                                          d))),
        }
        stage = {}
        for key, fns in runs.items():
            # the bf16 and fp32 instances of K3, K4-dx, K4-dW: one kernel a
            # shape
            stage[key] = [device_ms(torch, fn, reps=reps, launches=(
                              len(shapes) if j < 2 else None))
                          for j, (fn, reps) in enumerate(
                              zip(fns, (10, 10, 10, 3)))]
            sums[key] = [a + c for a, c in zip(sums[key], stage[key])]
        plans = [mrf.wgrad_card_plan(b, ch, ch, t_len, s[-1], s[4], dev, bf)
                 for s in shapes]
        log(f"[kernels] bf16 K4-dW stage {i} plans (k, d: tile bn x bi x "
            f"taps, stage samples, clusters of cluster = blocks, scratch "
            f"MB): " + "; ".join(
                f"{s[-1]}, {s[4]}: {p.bn} x {p.bi} x {p.taps}, {p.ts}, "
                f"{p.clusters} of {p.cluster} = {p.blocks}, "
                f"{p.scratch_floats * 4 / 1e6:.2f}"
                for s, p in zip(shapes, plans)))
        log(f"[kernels] bf16 stage {i} (C={ch}, T={t_len}), 9 shapes, device "
            f"ms (bf16 instance / fp32 instance / cuDNN bf16 / bf16 twin; "
            f"cuDNN bf16 over the instance): "
            + "; ".join(f"{label} " + " / ".join(f"{t:.3f}" for t in stage[k])
                        + f" ({stage[k][2] / stage[k][0]:.2f}x)"
                        for k, label in (("k3", "K3"), ("dx", "K4-dx"),
                                         ("dw", "K4-dW"))))
        del x, dy, x32, dy32, act, shapes, runs
        torch.cuda.empty_cache()
    for cin, cout, bb, t_len, kk, d in BF16_CONV_EDGES:
        x32, dy32, w32, bias32 = conv_inputs(bb, cin, cout, t_len, kk)
        r = torch.randn((bb, cout, t_len), generator=gen, device=dev).to(bf)
        for res in (None, r):
            conv_case(x32.to(bf), dy32.to(bf), w32.to(bf), bias32.to(bf), d,
                      res)
    for key, name in names.items():
        kern, fp32, lib, plain = sums[key]
        bd = bounds[key]
        log(f"[kernels] {name} against its bf16 twin: {worst[key]}"
            + (f"; lse max|d|={lse_err:.3g} (tol 1e-4)" if key == "k1"
               else "")
            + f"; device ms summed over "
            + ("the two s1 shapes" if key in ("k1", "k5") else "45 shapes")
            + f": bf16 instance {kern:.4f}, fp32 instance {fp32:.4f}, "
            f"library bf16 {lib:.4f}, twin {plain:.4f}; bound in bf16 "
            f"{bd.ms:.4f} ({bd.by}; bytes {bd.bytes_ms:.4f}, operations "
            f"{bd.ops_ms:.4f}): {100 * bd.ms / kern:.1f} % of the bound")
        assert worst[key].ok(), f"{name} disagrees with its twin: {worst[key]}"
        results[name] = dict(max_abs_err=worst[key].abs, ms=kern,
                             plain_ms=plain, library_ms=lib, fp32_ms=fp32,
                             max_rel_err=worst[key].rel, **bd.result())
    assert lse_err <= 1e-4, f"K1's bf16 lse disagrees: {lse_err}"
    results["prefill_attention_bf16"]["graph_ms"] = graph_sums["k1"]
    results["prefill_attention_bwd_bf16"]["graph_ms"] = graph_sums["k5"]
    k1_bound = bounds["k1"].ms
    log(f"[kernels] K1 bf16 over the two s1 shapes as CUDA graphs, in turns "
        f"with SDPA's bf16 forward captured the same way: K1 "
        f"{graph_sums['k1']:.4f} ms ({100 * k1_bound / graph_sums['k1']:.1f} "
        f"% of its {k1_bound:.4f} ms bound), SDPA forward "
        f"{graph_sums['sdpa_fwd']:.4f} ms (SDPA / K1 "
        f"{graph_sums['sdpa_fwd'] / graph_sums['k1']:.2f}x)")
    log(f"[kernels] K5 bf16 over the two s1 shapes as CUDA graphs, in turns "
        f"with SDPA's bf16 backward captured the same way: K5 "
        f"{graph_sums['k5']:.4f} ms, SDPA backward {graph_sums['sdpa']:.4f} "
        f"ms (SDPA / K5 {graph_sums['sdpa'] / graph_sums['k5']:.2f}x)")
    if parent is not None:
        k1_ab = ab["k1"]
        log(f"[a/b] K1 prefill_attention bf16 with lse, the two s1 shapes, "
            f"same inputs, in turns: by kernel count parent {k1_ab[1]:.4f} "
            f"ms -> this tree {k1_ab[0]:.4f} ms "
            f"({k1_ab[1] / k1_ab[0]:.2f}x); as CUDA graphs parent "
            f"{graph_sums['k1_parent']:.4f} -> this tree "
            f"{graph_sums['k1']:.4f} ms "
            f"({graph_sums['k1_parent'] / graph_sums['k1']:.2f}x); against "
            f"the bf16 twin at the s1 shapes and BF16_ATTN_EDGES: this tree "
            f"{worst['k1']}, lse max|d|={lse_err:.3g}; the parent's "
            f"{k1_parent_worst}, lse max|d|={lse_parent[0]:.3g}; this tree "
            f"against the parent's: {k1_vs_parent}, lse max|d|="
            f"{lse_parent[1]:.3g} (tol 1e-4)")
        assert k1_parent_worst.ok() and k1_vs_parent.ok() and \
            max(lse_parent) <= 1e-4, \
            (f"the parent's bf16 K1 against the twin {k1_parent_worst}, "
             f"this tree's against it {k1_vs_parent}, lse {lse_parent}")
        k5_ab = ab["k5"]
        log(f"[a/b] K5 prefill_attention_bwd bf16, the two s1 shapes, same "
            f"inputs, in turns: by kernel count parent {k5_ab[1]:.4f} ms -> "
            f"this tree {k5_ab[0]:.4f} ms ({k5_ab[1] / k5_ab[0]:.2f}x); as "
            f"CUDA graphs "
            f"parent {graph_sums['parent']:.4f} -> this tree "
            f"{graph_sums['k5']:.4f} ms "
            f"({graph_sums['parent'] / graph_sums['k5']:.2f}x); against the "
            f"bf16 twin at the s1 shapes and BF16_ATTN_EDGES: this tree "
            f"{worst['k5']}; the parent's {parent_worst}; this tree against "
            f"the parent's: {vs_parent}")
        assert parent_worst.ok() and vs_parent.ok(), \
            (f"the parent's bf16 K5 against the twin {parent_worst}, this "
             f"tree's against it {vs_parent}")


# ---------------------------------------------------------------------------
# phase 3, dropout: K1 and K5's dropout instances (the s1 fine-tune with
# T2SConfig.dropout > 0)
# ---------------------------------------------------------------------------

DROPOUT_P = 0.1
# H100 SXM: 132 SMs, 64 INT32 lanes an SM (16 a partition; NVIDIA's H100
# Tensor Core GPU Architecture white paper)
SMS, INT32_LANES = 132, 64
# the integer pipe's opcodes, for the instructions a Philox call costs
INT_OPS = ("IMAD", "IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT",
           "IMNMX", "IABS", "BMSK", "SGXT", "PLOP3", "P2R", "R2P", "IMUL")
# Philox's round multipliers 0xD2511F53 and 0xCD9E8D57, as SASS prints an
# immediate (unsigned or signed)
PHILOX_M = ("0xd2511f53", "-0x2daee0ad", "0xcd9e8d57", "-0x326172a9")
# the Philox calls in one pass of each dropout body's unrolled tile loop,
# from the sources: K1 fp32 4 n8 key tiles (one call a lane each), K1 bf16
# DROP_MT x NS = 1 x 8 (a call a lane, row tile and n8 key tile); K5 reads
# K1's bits in both dtypes and makes none
PHILOX_CALLS = {"prefill_attention": 4, "prefill_attention_bf16": 8,
                "dkdv": 0, "dq": 0, "dkdv_bf16": 0, "dq_bf16": 0}
# a K5 fp32 that draws the mask again (a --parent tree from before K1's
# fp32 instance wrote the bits): BQ / 16 x 2 query tiles a pass of dkdv, 4
# key tiles of dq
PHILOX_CALLS_DRAWING = {**PHILOX_CALLS, "dkdv": 8, "dq": 4}


def philox_cost(lib_path: str, calls_by_body=PHILOX_CALLS) -> dict:
    """Per dropout kernel (K1's two instances, K5's dkdv and dq in each
    dtype): the integer-pipe instructions its SASS body adds over its
    instance without dropout, per Philox call of the body (PHILOX_CALLS):
    "instructions a call", the lane exchanges, the threshold tests and
    K1's words of the mask included; beside it the multiplies by the
    round constants found in the body (20 a call where each is an IMAD
    with an immediate).  A body with no call (K5, which reads K1's bits)
    must hold no such multiply; its instructions a call read 0."""
    pairs = (("prefill_attention_kernelILi32ELb", "prefill_attention"),
             ("prefill_attention_bf16_kernelILb", "prefill_attention_bf16"),
             ("dkdv_kernelILb", "dkdv"), ("dq_kernelILb", "dq"),
             ("dkdv_bf16_kernelILb", "dkdv_bf16"),
             ("dq_bf16_kernelILb", "dq_bf16"))
    funcs = sass_functions(lib_path, tuple(k for k, _ in pairs))
    out = {}
    for key, name in pairs:
        bodies = {}
        for mangled, copies in funcs.items():
            if key + "0E" in mangled:
                bodies[False] = copies[0]
            elif key + "1E" in mangled:
                bodies[True] = copies[0]

        def ints(body):
            return sum(opcode(ln).split(".")[0] in INT_OPS for ln in body)

        muls = sum(1 for ln in bodies[True]
                   if opcode(ln).startswith("IMAD")
                   and any(m in ln.lower() for m in PHILOX_M))
        extra = ints(bodies[True]) - ints(bodies[False])
        calls = calls_by_body[name]
        assert calls or not muls, f"{name} with dropout holds Philox ({muls})"
        out[name] = dict(calls=calls, round_muls=muls, int_added=extra,
                         per_call=extra / calls if calls else 0.0)
    return out


def max_sm_clock_hz() -> float:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(proc.stdout.strip().splitlines()[0]) * 1e6


def dropout_readout(torch, att, dtype, dropout, x_len, xl, yl, t, h=16,
                    block=32):
    """The keep bits K1, K5's dkdv kernel and K5's dq kernel draw, read
    through their outputs and compared with ``attention_keep_mask`` on every
    visible pair.  With q = 0 every visible pair of a row has P =
    1 / n_visible, so:
      K1: v one-hot on a block of 32 keys (v[key k0 + j, :, j] = 1) gives
          o[row, :, j] = M(row, k0 + j) / (keep n_visible);
      dkdv: dO one-hot on a block of 32 query rows gives dV[key, :, j] =
          P~(r0 + j, key) = M(r0 + j, key) / (keep n_visible);
      dq: o = 0 (so D = 0), dO[:, :, 0] = v[:, :, 0] = 1 (so dP~ = 1) and k
          one-hot on a block of keys give dQ[row, :, j] = P M(row, k0 + j) /
          (keep sqrt(dk)).
    Each is positive exactly where the pair is kept.  K5 reads the bits K1
    wrote (``mask_bits``), which are read too: "K1 bits", unpacked
    (``ops/philox.py unpack_keep_mask``).  Returns
    {kernel: (pairs read that disagree, visible pairs read)}; hidden pairs
    must read 0 too (counted as disagreeing otherwise)."""
    from easevoice_trainer_tpu_torch.ops import philox

    b, dk = len(xl), 32
    dev = torch.device("cuda")
    mask = dropout.keep_mask(b, h, t, x_len, dev)
    vis = (att.build_hybrid_mask_bias(x_len, t - x_len, xl, yl) == 0
           ).expand(b, h, t, t)
    zeros = functools.partial(torch.zeros, (b, t, h, dk), dtype=dtype,
                              device=dev)
    eye = torch.eye(block, dk, dtype=dtype, device=dev)
    q = zeros()
    found = {"K1": [0, 0], "K5 dkdv": [0, 0], "K5 dq": [0, 0]}

    def k1(k, v):
        bits = att.new_mask_bits(q, x_len)
        o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl, dropout,
                                           mask_bits=bits)
        return o, lse, bits

    def tally(key, got, k0, rows_first):
        # got: bits (b, h, t, n) over keys k0.. (or (b, h, n, t) over rows)
        n = got.shape[-1] if not rows_first else got.shape[2]
        if rows_first:
            want, seen = mask[:, :, k0:k0 + n], vis[:, :, k0:k0 + n]
        else:
            want, seen = mask[..., k0:k0 + n], vis[..., k0:k0 + n]
        found[key][0] += int(((got != want) & seen).sum() +
                             (got & ~seen).sum())
        found[key][1] += int(seen.sum())

    for k0 in range(0, t, block):
        n = min(block, t - k0)
        v = zeros()
        v[:, k0:k0 + n] = eye[:n, None, :]
        o, lse, bits = k1(q, v)
        tally("K1", (o.float() > 0).permute(0, 2, 1, 3)[..., :n], k0, False)
        if k0 == 0:
            found["K1 bits"] = [0, 0]
            tally("K1 bits", philox.unpack_keep_mask(bits, t, x_len), 0,
                  False)
        # dq: k one-hot on the same block; o = 0, dO = v = e_0
        kk = zeros()
        kk[:, k0:k0 + n] = eye[:n, None, :]
        ones0 = zeros()
        ones0[..., 0] = 1
        dq = att.prefill_attention_bwd(q, kk, ones0, zeros(), lse, ones0,
                                       x_len, xl, yl, dropout=dropout,
                                       mask_bits=bits)[0]
        tally("K5 dq", (dq.float() > 0).permute(0, 2, 1, 3)[..., :n], k0,
              False)
    for r0 in range(0, t, block):
        n = min(block, t - r0)
        k = torch.randn((b, t, h, dk), device=dev).to(dtype)
        v = torch.randn((b, t, h, dk), device=dev).to(dtype)
        o, lse, bits = k1(k, v)
        do = zeros()
        do[:, r0:r0 + n] = eye[:n, None, :]
        dv = att.prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl,
                                       dropout=dropout, mask_bits=bits)[2]
        # dv (b, key, h, j) -> (b, h, j, key): rows r0 + j
        tally("K5 dkdv", (dv.float() > 0).permute(0, 2, 3, 1)[:, :, :n], r0,
              True)
    return {key: tuple(v) for key, v in found.items()}


def check_dropout(torch, results, parent=None):
    """K1 (with its lse) and K5 with dropout at p = 0.1 (DROPOUT_P), fp32
    and bf16, at the two s1 micro-batch shapes (B=8, H=16, 416 phonemes,
    300 and 1360 tokens, ragged lengths): each against its twin given the
    same keep mask (``attention_keep_mask``; fp32: K1's o 1e-4 absolute and
    K5 1e-4 x max(1, max|twin|); bf16: BF16_TOL / BF16_SHARE), K1's lse
    bit-equal to the instance without dropout's (the undropped softmax),
    repeated launches bit-identical, the keep rate over the visible pairs
    within 6 sigma of 1 - p; the keep bits K1 writes equal
    ``keep_bits_reference`` (``pack_keep_mask`` of the mask AND-ed with the
    visible pairs) bit for bit, and K5 reads them; the mask read back from
    K1, K5's dkdv and K5's dq at T = 1776 (``dropout_readout``), bit for
    bit.  The second shape and the readout draw as a data-parallel rank
    would (``row0`` 5 and 3: the mask of the global batch rows row0 ..).
    Device ms of each dropout instance beside the instance without dropout
    on the same inputs, the twin and SDPA with dropout_p = 0.1 under the
    same boolean mask (forward; its backward through autograd; between CUDA
    events, ``event_ms``: a profiler session may lose a library call's
    records unnoticed), which the port never calls; the bound as for the
    instances without dropout plus the bits' bytes (written once by K1,
    read once by K5), and beside it the RNG's own floor: the Philox calls
    these inputs need (one a four visible pairs; K1 draws, K5 never) x the
    integer instructions a call costs in the SASS (``philox_cost``) / (132
    SMs x 64 INT32 lanes x the card's maximum SM clock).  With ``parent``
    (the parent's ops.attention, whose fp32 K5 draws the mask again), the
    fp32 instances are timed in turns with the parent's on the same inputs
    and K1's o and lse and K5's gradients compared with the parent's bit
    for bit."""
    import torch.nn.functional as F

    from easevoice_trainer_tpu_torch.ops import attention as att
    from easevoice_trainer_tpu_torch.ops import build

    cost = philox_cost(build.build().path)
    log("[dropout] Philox in the SASS: " + ", ".join(
        f"{n} {c['int_added']} integer instructions added for {c['calls']} "
        f"calls, {c['per_call']:.1f} a call ({c['round_muls']} round-constant "
        f"multiplies)" for n, c in cost.items()))
    if parent is not None:
        old_cost = philox_cost(parent.build.build().path,
                               PHILOX_CALLS_DRAWING)
        log("[a/b] Philox in the parent's SASS: " + ", ".join(
            f"{n} {c['int_added']} integer instructions added for "
            f"{c['calls']} calls, {c['per_call']:.1f} a call"
            for n, c in old_cost.items() if not n.endswith("bf16")))
    for key in ("prefill_attention_kernelILi32ELb1E",
                "prefill_attention_bf16_kernelILb1E", "dkdv_kernelILb1E",
                "dq_kernelILb1E", "dkdv_bf16_kernelILb1E",
                "dq_bf16_kernelILb1E"):
        for name, line in ptxas_spills(build.build().build_log, key).items():
            log(f"[dropout] ptxas {short_name(name)}: {line}")
    int_rate = SMS * INT32_LANES * max_sm_clock_hz()
    gen = torch.Generator(device="cuda").manual_seed(1919)
    b, h, dk, x_len = S1_B, 16, 32, S1_X_LEN
    p = DROPOUT_P
    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        sfx = "_bf16" if bf else ""
        ops_rate = BF16_OPS_PER_S if bf else FP32_OPS_PER_S
        sums = {key: [0.0] * 4 for key in ("k1", "k5")}  # drop, off, twin, lib
        olds = {"k1": 0.0, "k5": 0.0}   # the parent's, in turns (fp32)
        bounds = {key: Bound(ops_rate) for key in ("k1", "k5")}
        floors = {"k1": 0.0, "k5": 0.0}
        worst = {"k1": _Worst(), "k5": _Worst()} if bf else \
            {"k1": 0.0, "k5": 0.0}
        rates = []
        for i, y_len in enumerate(S1_Y_LENS):
            t = x_len + y_len
            xl, yl = s1_lens(torch, gen, b, x_len, y_len)
            qkv = torch.randn((b, t, 3 * h * dk), generator=gen,
                              device="cuda").to(dtype)
            do = torch.randn((b, t, h, dk), generator=gen,
                             device="cuda").to(dtype)
            q, k, v = att._split_heads(qkv, h)
            # the second shape as a data-parallel rank whose rows start at
            # global row 5 (row0 keys the mask by the global batch row)
            drop = att.AttentionDropout(p, 0x5EED0000 + 7 * i, 11, 5 * i)
            mask = drop.keep_mask(b, h, t, x_len, "cuda")
            bias = att.build_hybrid_mask_bias(x_len, y_len, xl, yl)
            vis = (bias == 0).expand(b, h, t, t)
            n_vis = int(vis.sum())
            rate = float((mask & vis).sum()) / n_vis
            sigma = math.sqrt(p * (1 - p) / n_vis)
            rates.append((rate, sigma))
            assert abs(rate - (1 - p)) <= 6 * sigma, (rate, sigma)
            k1_args = (q, k, v, x_len, xl, yl)
            bits = att.new_mask_bits(q, x_len)
            o, lse = att.prefill_attention_lse(*k1_args, drop,
                                               mask_bits=bits)
            _, lse_off = att.prefill_attention_lse(*k1_args)
            assert torch.equal(lse, lse_off), \
                "K1's lse with dropout is not the undropped softmax's"
            for _ in range(2):
                again = att.prefill_attention_lse(*k1_args, drop)
                assert torch.equal(o, again[0]), "K1 dropout does not repeat"
            bits_off = int((bits != att.keep_bits_reference(
                mask, x_len, xl, yl)).sum())
            assert bits_off == 0, f"K1's bits: {bits_off} words off"
            want_o = torch.nan_to_num(att.prefill_attention_reference(
                *k1_args, mask, p), nan=0.0)
            k5_args = (q, k, v, o, lse, do, x_len, xl, yl)
            k5_kw = dict(dropout=drop, mask_bits=bits)
            got = att.prefill_attention_bwd(*k5_args, **k5_kw)
            want = att.prefill_attention_bwd_reference(*k5_args, mask, p)
            for _ in range(2):
                again = att.prefill_attention_bwd(*k5_args, **k5_kw)
                assert all(torch.equal(a, c) for a, c in zip(got, again)), \
                    "K5 dropout does not repeat"
            old = {}
            if not bf and parent is not None:   # the parent's, same inputs
                old_o, old_lse = parent.prefill_attention_lse(*k1_args, drop)
                old_g = parent.prefill_attention_bwd(*k5_args, dropout=drop)
                same = (torch.equal(old_o, o) and torch.equal(old_lse, lse),
                        all(torch.equal(a, c) for a, c in zip(old_g, got)))
                log(f"[a/b] dropout fp32 T={t}: this tree's K1 o / lse "
                    f"bit-identical to the parent's: {same[0]}; K5's "
                    f"gradients from K1's bits bit-identical to the "
                    f"parent's, which draws the mask again: {same[1]}")
                assert all(same), same
                old = {"k1": lambda: parent.prefill_attention_lse(
                           *k1_args, drop),
                       "k5": lambda: parent.prefill_attention_bwd(
                           *k5_args, dropout=drop)}
                del old_o, old_lse, old_g
            assert all(bool(torch.isfinite(g.float()).all()) for g in got)
            if bf:
                worst["k1"].add(bf16_err(torch, o, want_o))
                for g, w in zip(got, want):
                    worst["k5"].add(bf16_err(torch, g, w))
            else:
                worst["k1"] = max(worst["k1"], max_err(torch, o, want_o))
                worst["k5"] = max(worst["k5"], max(
                    max_err(torch, g, w) / max(1.0, float(w.abs().max()))
                    for g, w in zip(got, want)))
            del want, again, want_o
            # SDPA with dropout under the same boolean mask, heads first
            ok = bias == 0
            qh, kh, vh = (z.transpose(1, 2).contiguous().requires_grad_()
                          for z in (q, k, v))
            out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=ok,
                                                 dropout_p=p)
            lib_bwd = functools.partial(
                torch.autograd.grad, out, (qh, kh, vh),
                do.transpose(1, 2).contiguous(), retain_graph=True)
            k1_ms, k1_old = in_turns(
                torch, lambda: att.prefill_attention_lse(
                    *k1_args, drop, mask_bits=bits), old.get("k1"),
                launches=1)
            k5_ms, k5_old = in_turns(
                torch, lambda: att.prefill_attention_bwd(*k5_args, **k5_kw),
                old.get("k5"), launches=3)
            if old:
                olds["k1"] += k1_old
                olds["k5"] += k5_old
            times = {
                "k1": (k1_ms,
                       device_ms(torch, lambda: att.prefill_attention_lse(
                           *k1_args), launches=1),
                       device_ms(torch, lambda: (
                           att.prefill_attention_reference(*k1_args, mask,
                                                           p),
                           att.prefill_attention_lse_reference(
                               q, k, x_len, xl, yl)), reps=3),
                       event_ms(torch, lambda: F.scaled_dot_product_attention(
                           qh.detach(), kh.detach(), vh.detach(),
                           attn_mask=ok, dropout_p=p))),
                "k5": (k5_ms,
                       device_ms(torch, lambda: att.prefill_attention_bwd(
                           *k5_args), launches=3),
                       device_ms(torch, lambda: (
                           att.prefill_attention_bwd_reference(
                               *k5_args, mask, p)), reps=3),
                       event_ms(torch, lib_bwd, reps=5)),
            }
            pairs = n_vis
            elems = b * t * h * dk
            size = 2 if bf else 4
            # the bits, written by K1 and read by K5
            nbits = bits.numel() * 4
            bounds["k1"].add(size * 4 * elems + 4 * b * h * t + nbits,
                             4 * dk * pairs)
            bounds["k5"].add(size * 8 * elems + 4 * b * h * t + nbits,
                             10 * dk * pairs)
            # one Philox call a four visible pairs: K1 draws once, K5
            # never
            calls = math.ceil(pairs / 4)
            floors["k1"] += calls * cost["prefill_attention" + sfx][
                "per_call"] / int_rate * 1e3
            floors["k5"] += calls * (cost["dkdv" + sfx]["per_call"] + cost[
                "dq" + sfx]["per_call"]) / int_rate * 1e3
            for key in sums:
                sums[key] = [a + c for a, c in zip(sums[key], times[key])]
            log(f"[dropout] {'bf16' if bf else 'fp32'} K1 + lse / K5, p={p}, "
                f"B={b} H={h} x_len={x_len} y_len={y_len} (T={t}): "
                f"{n_vis} visible (row, key, head) triples, keep rate "
                f"{rate:.6f} (1 - p = {1 - p}, sigma {sigma:.2g})"
                + f"; K1's keep bits {tuple(bits.shape)} ({nbits / 1e6:.2f} "
                f"MB) equal keep_bits_reference bit for bit"
                + (f"; in turns with the parent's: K1 {k1_old:.4f} -> "
                   f"{k1_ms:.4f}, K5 {k5_old:.4f} -> {k5_ms:.4f}"
                   if old else "") + "; device ms "
                f"K1 dropout {times['k1'][0]:.4f} (without {times['k1'][1]:.4f}"
                f", twin {times['k1'][2]:.4f}, SDPA dropout "
                f"{times['k1'][3]:.4f}); K5 dropout {times['k5'][0]:.4f} "
                f"(without {times['k5'][1]:.4f}, twin {times['k5'][2]:.4f}, "
                f"SDPA dropout backward {times['k5'][3]:.4f})")
            del qkv, q, k, v, do, o, lse, got, mask, vis, qh, kh, vh, out, \
                lib_bwd, bias, ok, bits, old
            torch.cuda.empty_cache()
        # the mask read back at the longer shape, bit for bit
        t = x_len + S1_Y_LENS[-1]
        xl, yl = s1_lens(torch, gen, b, x_len, S1_Y_LENS[-1])
        readout = dropout_readout(torch, att, dtype,
                                  att.AttentionDropout(p, 0x5EED, 3, 3),
                                  x_len, xl, yl, t)
        log(f"[dropout] {'bf16' if bf else 'fp32'} mask readout at T={t} "
            f"(x_lens={xl.tolist()}, y_lens={yl.tolist()}): " + ", ".join(
                f"{key} {bad} of {n} visible pairs off attention_keep_mask"
                for key, (bad, n) in readout.items()))
        assert all(bad == 0 and n > 0 for bad, n in readout.values()), \
            readout
        if bf:
            ok_k1, ok_k5 = worst["k1"].ok(), worst["k5"].ok()
            errs = (worst["k1"].abs, worst["k5"].abs)
        else:
            ok_k1, ok_k5 = worst["k1"] <= 1e-4, worst["k5"] <= 1e-4
            errs = (worst["k1"], worst["k5"])
        for key, base, name in (("k1", "prefill_attention", "K1 + lse"),
                                ("k5", "prefill_attention_bwd", "K5")):
            drop_ms, off, twin, lib = sums[key]
            bd = bounds[key]
            log(f"[dropout] {name} {'bf16' if bf else 'fp32'} over the two "
                f"s1 shapes: dropout {drop_ms:.4f} ms"
                + (f" (the parent's in turns {olds[key]:.4f} ms, "
                   f"{olds[key] / drop_ms:.2f}x)" if olds[key] else "")
                + f", without dropout "
                f"{off:.4f} ms ({drop_ms / off:.2f}x), twin {twin:.4f} ms, "
                f"SDPA dropout {lib:.4f} ms; bound {bd.ms:.4f} ms ({bd.by}); "
                f"RNG floor {floors[key]:.4f} ms (Philox calls x "
                f"instructions a call / {int_rate:.4g} integer lanes a "
                f"second); against the twin "
                f"{worst[key] if bf else f'{worst[key]:.3g} (tol 1e-4)'}")
            results[base + "_dropout" + sfx] = dict(
                max_abs_err=errs[0] if key == "k1" else errs[1],
                ms=drop_ms, plain_ms=twin, library_ms=lib,
                without_dropout_ms=off, rng_floor_ms=floors[key],
                keep_rate=[r for r, _ in rates], mask_readout=readout,
                **bd.result())
            if olds[key]:
                results[base + "_dropout" + sfx]["parent_ms"] = olds[key]
        assert ok_k1, f"K1 dropout disagrees with its twin: {worst['k1']}"
        assert ok_k5, f"K5 dropout disagrees with its twin: {worst['k5']}"


def sass_functions(path: str, keys) -> dict:
    """The SASS of the kernel library at ``path``: for every function whose
    name holds one of ``keys``, the instruction lines of each copy of it in
    the library, by name, with the hash of an anonymous namespace taken out
    of the name."""
    import re

    from easevoice_trainer_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+\w*?_cu_[0-9a-f]{8}",
                      "_GLOBAL__N_", name.strip())
        if any(k in name for k in keys):
            funcs.setdefault(name, []).append(
                [ln.strip() for ln in body.splitlines()
                 if re.search(r"/\*[0-9a-f]{4}\*/", ln)])
    return funcs


def ptxas_spills(build_log: str, key: str) -> dict:
    """The ptxas spill line ("0 bytes stack frame, 0 bytes spill stores, 0
    bytes spill loads") of each kernel whose mangled name holds ``key``, by
    name, from a build log (none from a library reused, not built)."""
    out, name = {}, None
    for line in build_log.splitlines():
        if "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1]
        elif name is not None and "spill stores" in line:
            if key in name:
                out[name] = line.strip()
            name = None
    return out


def opcode(line: str) -> str:
    """The opcode of a SASS line ("/*0040*/ @P0 HGMMA.64x256x8... ;")."""
    words = line.split("*/", 1)[-1].split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def short_name(mangled: str) -> str:
    """The kernel's name out of its mangled one, with its template
    arguments (e.g. wgrad_wgmma_kernel<256>)."""
    import re

    m = re.search(r"(wgrad_\w+?_kernel|conv_mma_kernel|"
                  r"prefill_attention_bf16_kernel|"
                  r"(?:dsum|dkdv|dq)(?:_bf16)?_kernel)((?:I?L[ib]-?\d+E)*)",
                  mangled)
    if not m:
        return mangled
    args = [v if t == "i" else ("false", "true")[int(v)] for t, v in
            re.findall(r"L([ib])(-?\d+)E", m.group(2))]
    if "bfloat16" in mangled[m.end():m.end() + 40]:
        args.append("bf16")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def same_sass(new: dict, old: dict):
    """(the count of old's function bodies that new holds instruction for
    instruction, the count of old's bodies): the parent's fp32 kernels
    against this tree's library, whose template names differ."""
    have = [b for bs in new.values() for b in bs]
    bodies = [b for bs in old.values() for b in bs]
    return sum(b in have for b in bodies), len(bodies)


def ab_mrf(torch, parent):
    """K3 and K4 of this tree against the parent's (``--parent``).  The fp32
    K3 and K4-dx run one loop (conv_mma_kernel): every fp32 body of it in
    the parent's library must be in this tree's instruction for
    instruction, its outputs on the same inputs are compared bit for bit,
    and its device time summed over check_kernels' 45 K3 shapes (B=4) and
    check_k4's 45 K4 shapes (B=8), timed in turns.  The bf16 K3 and K4-dx
    (conv_bf16_kernel here): their SASS must hold bf16 m16n8k16 HMMAs and
    no TF32 HMMA; at the 45 s2 shapes in bf16 their outputs are held to the
    parent's within BF16_TOL / BF16_SHARE (the summation order changed) and
    their device time is taken in turns with the parent's.  K4-dW in fp32:
    dW / db bit for bit, and the device time of each Generator stage's 9
    shapes, timed in turns; in bf16 at the 45 s2 shapes: held to the
    parent's within BF16_TOL / BF16_SHARE, and each stage timed in turns
    with the parent's by kernel count."""
    from easevoice_trainer_tpu_torch.ops import build, mrf

    new, old = (sass_functions(lib.path, ("conv_mma_kernel",))
                for lib in (build.build(), parent.ops.build.build()))
    old = {n: b for n, b in old.items() if "bfloat16" not in n}
    same, total = same_sass(new, old)
    log(f"[a/b] SASS of the fp32 K3/K4-dx loop (conv_mma_kernel): "
        f"{len(new)} functions in this tree's library, {len(old)} fp32 ones "
        f"in the parent's; {same} of the parent's {total} fp32 bodies found "
        f"here instruction for instruction")
    assert total and same == total, f"fp32 conv_mma_kernel: {same} / {total}"
    hmma = {}
    for name, bodies in sass_functions(build.build().path,
                                       ("conv_bf16_kernel",)).items():
        for body in bodies:
            for ln in body:
                op = opcode(ln)
                if op.startswith("HMMA"):
                    hmma[op] = hmma.get(op, 0) + 1
    log(f"[a/b] SASS of the bf16 K3/K4-dx loop (conv_bf16_kernel): HMMA "
        f"opcodes {hmma}")
    assert hmma and all(op.startswith("HMMA.16816.F32.BF16") for op in hmma), \
        f"the bf16 loop is not on bf16 m16n8k16: {hmma}"

    gen = torch.Generator(device="cuda").manual_seed(2468)
    k3, k4 = [], []
    ch, up = 512, 1
    for u in (10, 8, 2, 2, 2):
        ch //= 2
        up *= u
        x = torch.randn((4, ch, 512 * up), generator=gen, device="cuda")
        for kk in (3, 7, 11):
            w = torch.randn((ch, ch, kk), generator=gen, device="cuda") \
                / math.sqrt(ch * kk)
            bias = torch.randn((ch,), generator=gen, device="cuda") * 0.1
            k3 += [(x, w, bias, d, x if d == 1 else None) for d in (1, 3, 5)]
    bf = torch.bfloat16
    k3_bf, k4_bf = [], []
    for ch, t_len in S2_STAGES:
        x, dy = (torch.randn((8, ch, t_len), generator=gen, device="cuda")
                 for _ in range(2))
        xb, dyb = x.to(bf), dy.to(bf)
        for kk in (3, 7, 11):
            w = torch.randn((ch, ch, kk), generator=gen, device="cuda") \
                / math.sqrt(ch * kk)
            wb = w.to(bf)
            bias = (torch.randn((ch,), generator=gen, device="cuda")
                    * 0.1).to(bf)
            k4 += [(dy, x, w, d) for d in (1, 3, 5)]
            k4_bf += [(dyb, xb, wb, d) for d in (1, 3, 5)]
            k3_bf += [(xb, wb, bias, d, xb if d == 1 else None)
                      for d in (1, 3, 5)]
    runs = {
        "K3 mrf_conv": lambda m: [m.mrf_conv(x, w, bias, d, residual=r)
                                  for x, w, bias, d, r in k3],
        "K4 mrf_conv_bwd_data": lambda m: [m.mrf_conv_bwd_data(dy, x, w, d)
                                           for dy, x, w, d in k4],
    }
    for label, run in runs.items():
        equal = all(torch.equal(a, b) for a, b in zip(
            run(mrf), run(parent.ops.mrf)))
        ms, parent_ms = in_turns(torch, lambda: run(mrf),
                                 lambda: run(parent.ops.mrf))
        log(f"[a/b] {label}, 45 shapes, same inputs: outputs bit-identical: "
            f"{equal}; device ms summed over the shapes, in turns: parent "
            f"{parent_ms:.3f} -> this tree {ms:.3f}")
        assert equal, f"{label}: the fp32 outputs changed"
    bf16_runs = {
        "K3 mrf_conv bf16": lambda m: [m.mrf_conv(x, w, bias, d, residual=r)
                                       for x, w, bias, d, r in k3_bf],
        "K4 mrf_conv_bwd_data bf16": lambda m: [
            m.mrf_conv_bwd_data(dy, x, w, d) for dy, x, w, d in k4_bf],
    }
    for label, run in bf16_runs.items():
        worst = _Worst()
        for a, b in zip(run(mrf), run(parent.ops.mrf)):
            worst.add(bf16_err(torch, a, b))
        ms, parent_ms = in_turns(torch, lambda: run(mrf),
                                 lambda: run(parent.ops.mrf),
                                 launches=len(k4_bf))
        log(f"[a/b] {label}, the 45 s2 shapes (B=8), same inputs: against "
            f"the parent's {worst}; device ms summed over the shapes, in "
            f"turns: parent {parent_ms:.3f} -> this tree {ms:.3f} "
            f"({parent_ms / ms:.2f}x)")
        assert worst.ok(), f"{label} disagrees with the parent's: {worst}"

    def dw_run(m, shapes):
        return lambda: [g for dy, x, w, d in shapes
                        for g in m.mrf_conv_bwd_weight(dy, x, w.shape, d)]

    equal = all(torch.equal(a, b) for a, b in zip(
        dw_run(mrf, k4)(), dw_run(parent.ops.mrf, k4)()))
    totals = [0.0, 0.0]
    for i, (ch, t_len) in enumerate(S2_STAGES):
        shapes = k4[9 * i:9 * i + 9]
        ms, parent_ms = in_turns(torch, dw_run(mrf, shapes),
                                 dw_run(parent.ops.mrf, shapes))
        totals = [totals[0] + ms, totals[1] + parent_ms]
        log(f"[a/b] K4 mrf_conv_bwd_weight stage {i} (C={ch}, T={t_len}), 9 "
            f"shapes, same inputs, in turns: parent {parent_ms:.3f} -> this "
            f"tree {ms:.3f} ms ({parent_ms / ms:.2f}x)")
    log(f"[a/b] K4 mrf_conv_bwd_weight, 45 shapes: parent {totals[1]:.3f} -> "
        f"this tree {totals[0]:.3f} ms ({totals[1] / totals[0]:.2f}x); dW / "
        f"db bit-identical: {equal}")
    assert equal, "K4 mrf_conv_bwd_weight: the fp32 dW / db changed"
    # the bf16 instance, by kernel count (one a shape), in turns with the
    # parent's on the same inputs, and held to it: the summation order may
    # change, so within the bf16 tolerance
    worst, totals = _Worst(), [0.0, 0.0]
    for i, (ch, t_len) in enumerate(S2_STAGES):
        shapes = k4_bf[9 * i:9 * i + 9]
        stage = _Worst()
        for a, b in zip(dw_run(mrf, shapes)(),
                        dw_run(parent.ops.mrf, shapes)()):
            stage.add(bf16_err(torch, a, b))
        worst.add((stage.abs, stage.rel, stage.share))
        ms, parent_ms = in_turns(torch, dw_run(mrf, shapes),
                                 dw_run(parent.ops.mrf, shapes),
                                 launches=len(shapes))
        totals = [totals[0] + ms, totals[1] + parent_ms]
        log(f"[a/b] K4 mrf_conv_bwd_weight bf16 stage {i} (C={ch}, "
            f"T={t_len}), 9 shapes, same inputs, in turns: parent "
            f"{parent_ms:.3f} -> this tree {ms:.3f} ms "
            f"({parent_ms / ms:.2f}x); against the parent's {stage}")
    log(f"[a/b] K4 mrf_conv_bwd_weight bf16, 45 shapes: parent "
        f"{totals[1]:.3f} -> this tree {totals[0]:.3f} ms "
        f"({totals[1] / totals[0]:.2f}x); against the parent's {worst}")
    assert worst.ok(), f"K4-dW bf16 disagrees with the parent's: {worst}"


# the parent's kernel bodies this tree replaces by design: K1 fp32's and
# K5 fp32's dropout instances (K1 writes the keep bits, K5 reads them)
AB_SASS_REPLACED = r"(prefill_attention_kernelILi32E|(dkdv|dq)_kernelI)Lb1E"


def ab_sass(parent_root: str) -> None:
    """``bench/sass_diff.py`` against the parent's library: every kernel
    body of the parent but AB_SASS_REPLACED must be in this tree's library
    instruction for instruction."""
    from easevoice_trainer_tpu_torch.bench import sass_diff

    rc = sass_diff.main([parent_root, "--replaced", AB_SASS_REPLACED])
    assert rc == 0, "a kernel body of the parent changed (bench/sass_diff.py)"


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------

def write_reference_wav(path: str, seconds: float, seed: int) -> None:
    import numpy as np

    sr = 32000
    data = np.random.default_rng(seed).uniform(
        -0.3, 0.3, int(sr * seconds)).astype(np.float32)
    pcm = np.round(data * 32768.0).clip(-32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_wav(path: str):
    import numpy as np

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        data = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    return data.astype(np.float32) / 32768.0, sr


def random_weights(torch, module, gen, path: str, wrap: bool = True):
    """Seeded random weights saved as a checkpoint file: wrapped like an
    exported .pth/.ckpt, or a raw state dict like HF's pytorch_model.bin.
    Returns the state dict (on the CPU)."""
    from easevoice_trainer_tpu_torch import convert

    state = {k: v.cpu() for k, v in
             convert.random_state_dict(module, gen).items()}
    torch.save({"weight": state, "config": {}, "info": "random"}
               if wrap else state, path)
    return state


class _Sessions:
    """The session-manager surface VoiceCloneService calls."""

    def __init__(self):
        self.info = []
        self.responses = []

    def update_session_info(self, uuid, info):
        self.info.append((uuid, info))

    def end_session_with_response(self, uuid, response):
        self.responses.append((uuid, response))


def serve(torch, tmp: str, results):
    from easevoice_trainer_tpu_torch import ops
    from easevoice_trainer_tpu_torch.inference.tts import TTS, TTSConfig
    from easevoice_trainer_tpu_torch.models.cnhubert import CNHubert
    from easevoice_trainer_tpu_torch.models.gpt import Text2SemanticDecoder
    from easevoice_trainer_tpu_torch.models.sovits import SynthesizerTrn
    from easevoice_trainer_tpu_torch.service.voice import VoiceCloneService

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    sovits_path = os.path.join(tmp, "sovits_random.pth")
    gpt_path = os.path.join(tmp, "gpt_random.ckpt")
    hubert_dir = os.path.join(tmp, "chinese-hubert-base")
    os.makedirs(hubert_dir)
    random_weights(torch, SynthesizerTrn(), gen, sovits_path)
    random_weights(torch, Text2SemanticDecoder(), gen, gpt_path)
    random_weights(torch, CNHubert(), gen,
                   os.path.join(hubert_dir, "pytorch_model.bin"), wrap=False)
    ref_path = os.path.join(tmp, "ref.wav")
    write_reference_wav(ref_path, 5.0, 0)

    cfg = TTSConfig(os.path.join(tmp, "tts_infer.json"))
    cfg.device = "cuda"
    cfg.cnhubert_base_path = hubert_dir
    cfg.vits_weights_path = cfg.t2s_weights_path = ""
    tts = TTS(cfg)
    service = VoiceCloneService(_Sessions(), tts)
    setup_s = time.perf_counter() - t0
    log(f"[serving] full-width random weights written and hubert loaded in "
        f"{setup_s:.1f} s")

    params = dict(
        text=" ".join(SENTENCES), text_lang="en", ref_audio_path=ref_path,
        prompt_text="", text_split_method="by_english_period", batch_size=4,
        parallel_infer=True, split_bucket=True, top_k=15,
        repetition_penalty=1.35, seed=1234, keep_random=False,
        sovits_path=sovits_path, gpt_path=gpt_path,
        output_dir=os.path.join(tmp, "out"))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    result = service.clone("chip-smoke", params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = ops.launch_counts()

    assert result.ok, result
    wav, sr = read_wav(result.data["output_path"])
    import numpy as np

    assert sr == 32000 and wav.ndim == 1 and wav.size > 0
    assert np.isfinite(wav).all(), "non-finite samples"
    assert np.abs(wav).max() > 0, "silent output"
    for name, model in (("sovits", tts.vits), ("gpt", tts.t2s),
                        ("hubert", tts.cnhubert)):
        for pname, p in list(model.named_parameters()) + list(
                model.named_buffers()):
            assert p.device.type == "cuda", f"{name}.{pname} on {p.device}"
    for name in ("prefill_attention", "decode_attention", "mrf_conv",
                 "encoder_attention"):
        assert launches[name] > 0, \
            f"{name} was never launched on the serving path"
        results[name]["launches"] = launches[name]
        results[name]["per_path"] = {"serving_clone": launches[name],
                                     "s2_step": 0}
    bf16 = {n: c for n, c in launches.items() if n.endswith("_bf16") and c}
    assert not bf16, f"serving launched bf16 instances: {bf16}"

    phases = tts.last_phases
    audio_s = wav.size / sr
    tokens = tts.last_generated_tokens
    log(f"[serving] clone wall {wall:.3f} s (weights loaded from .pth "
        f"inside), audio {audio_s:.3f} s, RTF {wall / audio_s:.4f}; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
        + f"; {tokens} tokens generated, {tokens / phases['ar_decode']:.1f} "
        f"tokens/s in ar_decode; launches {launches}")
    return tts


def profile_gpt(torch, model, parent=None):
    """K1 and K2 inside the serving path: one prefill and 16 decode steps of
    the full-width GPT under torch.profiler, as ``decode_ar`` runs them (B=4,
    x_len 64 with the phase-3 lengths, a 250-token prompt, a 1434-slot
    cache, greedy tokens), at steps 500-515 straight after the prefill (the
    slots in between hold zeros): K1's and K2's mean device time a launch
    and the kernels and copies a decode step launches.  With ``parent`` (the
    parent commit's package) its GPT, given the same weights, is profiled
    the same way, in turns."""
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(99)
    b, x_len, prompt, cache_len, first, n_steps = 4, 64, 250, 1434, 500, 16
    x = torch.randint(1, 700, (b, x_len), generator=gen, device="cuda")
    x_lens = torch.tensor([64, 41, 17, 58], dtype=torch.int32, device="cuda")
    prompts = torch.randint(0, 1024, (b, prompt), generator=gen,
                            device="cuda")
    bert = torch.zeros((b, x_len, 1024), device="cuda")
    n_layers = model.cfg.n_layers

    def measure(m):
        state = {}

        def prefill():
            state["out"] = m.prefill(x, x_lens, prompts, bert, cache_len)

        def decode():
            logits, kc, vc = state["out"]
            token = logits.argmax(-1)
            for step in range(first, first + n_steps):
                token = m.decode_step(token, step, kc, vc, x_len, x_lens,
                                      prompt).argmax(-1)

        prefill()
        decode()  # warm-up
        pre = device_events(torch, prefill)
        dec = device_events(torch, decode)
        k1 = [e.time_range.elapsed_us() for e in pre
              if "prefill_attention" in e.name]
        k2 = [e.time_range.elapsed_us() for e in dec
              if "decode_attention" in e.name]
        # the trace now and then misses an event (one H100 run traced 383 of
        # 384 K2 launches), so the counts are printed, not asserted
        assert k1 and k2, "no K1 or K2 launch in the profiled GPT"
        return dict(k1_us=float(np.mean(k1)), k2_us=float(np.mean(k2)),
                    k1_n=len(k1), k2_n=len(k2), per_step=len(dec) / n_steps,
                    step_ms=sum(e.time_range.elapsed_us() for e in dec)
                    / 1000.0 / n_steps)

    if parent is None:
        runs = {"new": [measure(model)]}
    else:
        old = parent.models.gpt.Text2SemanticDecoder(model.cfg)
        old.load_state_dict(model.state_dict())
        old = old.to("cuda").eval()
        runs = {"old": [measure(old)], "new": [measure(model)]}
        runs["new"].append(measure(model))
        runs["old"].append(measure(old))
        del old
    mean = {key: {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}
            for key, rs in runs.items()}
    new = mean["new"]
    log(f"[serving profile] GPT prefill B={b} T={x_len + prompt} + decode "
        f"steps {first}-{first + n_steps - 1} of a {cache_len}-slot cache: "
        f"K1 {new['k1_us']:.2f} us a launch ({new['k1_n']:.0f} traced of "
        f"{n_layers}), K2 {new['k2_us']:.2f} us a launch ({new['k2_n']:.0f} "
        f"traced of {n_layers * n_steps}); "
        f"{new['per_step']:.1f} kernels and copies a decode step (greedy "
        f"argmax included), {new['step_ms']:.3f} ms of device time a step")
    if parent is not None:
        old = mean["old"]
        log(f"[a/b] serving GPT, same weights and inputs, in turns: kernels "
            f"and copies a decode step parent {old['per_step']:.1f} -> this "
            f"tree {new['per_step']:.1f} ({old['per_step'] - new['per_step']:.1f}"
            f" fewer; 3 x {n_layers} layers = {3 * n_layers} expected); K1 "
            f"us a launch {old['k1_us']:.2f} -> {new['k1_us']:.2f}; K2 us a "
            f"launch {old['k2_us']:.2f} -> {new['k2_us']:.2f}; device ms a "
            f"step {old['step_ms']:.3f} -> {new['step_ms']:.3f}")


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU on a small input
# ---------------------------------------------------------------------------

def reference_check(torch, tts):
    from easevoice_trainer_tpu_torch.models.gpt import DecodeParams, \
        decode_ar

    gen = torch.Generator().manual_seed(5)
    t2s_cpu = copy.deepcopy(tts.t2s).cpu()
    x = torch.randint(1, 700, (2, 16), generator=gen)
    x_lens = torch.tensor([16, 11], dtype=torch.int32)
    prompts = torch.randint(0, 1024, (2, 24), generator=gen)
    bert = torch.zeros((2, 16, 1024))
    params = DecodeParams(top_k=1, max_new_tokens=16, min_tokens=16)

    def run(model, dev):
        tokens, _ = decode_ar(model, x.to(dev), x_lens.to(dev),
                              prompts.to(dev), bert.to(dev), params,
                              torch.Generator(device=dev).manual_seed(0))
        logits, kc, _ = model.prefill(x.to(dev), x_lens.to(dev),
                                      prompts.to(dev), bert.to(dev), 48)
        return tokens.cpu(), logits.cpu()

    tok_gpu, lg_gpu = run(tts.t2s, "cuda")
    tok_cpu, lg_cpu = run(t2s_cpu, "cpu")
    err = max_err(torch, lg_gpu, lg_cpu) / max(1.0, float(lg_cpu.abs().max()))
    same = int((tok_gpu == tok_cpu).all(dim=1).sum())
    log(f"[reference] GPT card vs CPU: prefill logits relative max|d|="
        f"{err:.3g} (tol 1e-3); greedy 16-token rows identical: {same}/2")
    assert err <= 1e-3 and same == 2

    vits_cpu = copy.deepcopy(tts.vits).cpu()
    codes = torch.randint(0, 1024, (2, 32), generator=gen)
    codes_lens = torch.tensor([32, 21])
    text = torch.randint(1, 700, (2, 16), generator=gen)
    text_lens = torch.tensor([16, 9])
    spec = torch.rand((1, 120, 1025), generator=gen)
    spec_lens = torch.tensor([120])
    with torch.no_grad():
        args = (codes, text, text_lens, spec, spec_lens)
        wav_gpu = tts.vits.decode(*(a.cuda() for a in args),
                                  codes_lengths=codes_lens.cuda()).cpu()
        wav_cpu = vits_cpu.decode(*args, codes_lengths=codes_lens)
    assert wav_gpu.shape == (2, 32 * 2 * 640, 1)
    assert torch.isfinite(wav_gpu).all()
    err = max_err(torch, wav_gpu, wav_cpu)
    peak = float(wav_cpu.abs().max())
    log(f"[reference] SynthesizerTrn.decode card vs CPU (32 codes x 2): "
        f"max|d|={err:.3g} (tol 1e-3), |wav| max {peak:.3f}")
    assert err <= 1e-3


# ---------------------------------------------------------------------------
# phase 6: Chinese serving (BERT features and G2PW polyphones on the card)
# ---------------------------------------------------------------------------

# five Chinese sentences (one clone, text_lang "zh") and one mixed zh/en
# sentence (another, "auto"); 24 of the characters are polyphonic in the
# G2PW tables below
ZH_TEXT = ("银行的行长今天还在重新调整数据。我觉得这种音乐很好听，大家都乐了。"
           "他长大以后成为了一名教师，教大家数学。朝阳升起的时候，少年背着行李"
           "出发了。这个问题还差一点，我们重新看一看。")
ZH_MIXED = "我们用Python写了一个voice cloning的小程序。"

# the G2PW model's polyphonic characters and their readings (labels are
# TONE3 pinyin; the bopomofo-to-pinyin table maps each body to itself)
G2PW_POLYPHONES = {
    "行": ("xing2", "hang2"), "长": ("chang2", "zhang3"),
    "的": ("de5", "di2"), "还": ("hai2", "huan2"),
    "重": ("zhong4", "chong2"), "调": ("diao4", "tiao2"),
    "数": ("shu4", "shu3"), "觉": ("jue2", "jiao4"),
    "得": ("de2", "de5"), "种": ("zhong3", "zhong4"),
    "乐": ("le4", "yue4"), "好": ("hao3", "hao4"),
    "都": ("dou1", "du1"), "了": ("le5", "liao3"),
    "为": ("wei2", "wei4"), "教": ("jiao1", "jiao4"),
    "朝": ("chao2", "zhao1"), "少": ("shao3", "shao4"),
    "背": ("bei4", "bei1"), "着": ("zhe5", "zhao2"),
    "发": ("fa1", "fa4"), "看": ("kan4", "kan1"),
    "大": ("da4", "dai4"), "相": ("xiang1", "xiang4"),
    "中": ("zhong1", "zhong4"), "只": ("zhi3", "zhi1"),
}
G2PW_MONOPHONES = {"我": "wo3", "们": "men5", "今": "jin1", "天": "tian1"}

# Where ``jieba`` does not import (the Chinese G2P of both packages needs
# it), the phase takes the phone ids, word2ph and normalized text of each
# Chinese run the preprocessor cleans from this table: ``clean_text(run,
# "zh")`` of the port on the dictionary path, computed where jieba runs and
# held equal to it by tests/test_torch_host.py.  BERT, G2PW and everything
# after them still run on the card.
ZH_PINNED = {
    '银行的行长今天还在重新调整数据。': (
        [318, 197, 158, 113, 127, 134, 317, 202, 125, 113, 221, 196, 252, 176, 158, 103, 319, 105, 125, 236, 317, 196, 252, 187, 320, 147, 251, 258, 221, 299, 3],
        [2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1],
        '银行的行长今天还在重新调整数据.'),
    '我觉得这种音乐很好听，大家都乐了。': (
        [316, 232, 221, 307, 127, 134, 320, 133, 320, 237, 318, 196, 318, 309, 158, 141, 158, 119, 252, 201, 1, 127, 100, 221, 171, 127, 240, 224, 133, 224, 134, 3],
        [2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2, 1],
        '我觉得这种音乐很好听,大家都乐了.'),
    '他长大以后成为了一名教师，教大家数学。': (
        [252, 97, 320, 114, 127, 100, 318, 168, 158, 243, 125, 146, 316, 136, 224, 134, 318, 169, 225, 202, 221, 189, 251, 211, 1, 221, 189, 127, 100, 221, 171, 251, 258, 317, 307, 3],
        [2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2, 1],
        '他长大以后成为了一名教师,教大家数学.'),
    '朝阳升起的时候，少年背着行李出发了。': (
        [320, 117, 318, 113, 251, 145, 247, 168, 127, 134, 251, 212, 158, 244, 1, 251, 120, 227, 177, 122, 138, 320, 134, 317, 202, 224, 170, 125, 255, 155, 97, 224, 134, 3],
        [2, 2, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1],
        '朝阳升起的时候,少年背着行李出发了.'),
    '这个问题还差一点，我们重新看一看。': (
        [320, 133, 156, 134, 316, 143, 252, 167, 158, 103, 125, 100, 318, 169, 127, 178, 1, 316, 232, 225, 144, 125, 236, 317, 196, 222, 110, 318, 170, 222, 110, 3],
        [2, 2, 2, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2, 2, 2, 1],
        '这个问题还差一点,我们重新看一看.'),
    '我们用': (
        [316, 232, 225, 144, 318, 238],
        [2, 2, 2],
        '我们用'),
    '写了一个': (
        [317, 193, 224, 134, 318, 167, 156, 134],
        [2, 2, 2, 2],
        '写了一个'),
    '的小程序。': (
        [127, 134, 317, 188, 125, 146, 317, 299, 3],
        [2, 2, 2, 2, 1],
        '的小程序.'),
}


def bert_vocab(size: int = 21128, chars: str = ""):
    """A BERT vocabulary of ``size`` entries in the layout of
    chinese-roberta-wwm-ext-large's: [PAD], [unused1-99], [UNK], [CLS],
    [SEP], [MASK], ASCII (lower case), CJK punctuation, ``##`` pieces of
    letters and digits, then ``chars`` and the CJK block from U+4E00 to
    fill it."""
    import string

    head = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    ascii_ = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    punct = list("，。！？、：；“”‘’（）《》【】…—·")
    pieces = ["##" + c for c in string.ascii_lowercase + string.digits]
    fixed = head + ascii_ + punct + pieces
    cjk = list(dict.fromkeys(ch for ch in chars if ch not in fixed))
    cjk += [chr(c) for c in range(0x4E00, 0x9FA6) if chr(c) not in cjk]
    return fixed + cjk[:size - len(fixed)]


def write_bert_dir(torch, root: str, cfg, gen, vocab,
                   weights: str = "pytorch_model.bin"):
    """A BERT directory as HF lays one out: config.json, vocab.txt and
    seeded random weights (``bert.``-prefixed HF names and a pooler, as a
    released checkpoint holds them) in ``weights`` (``pytorch_model.bin``
    or ``model.safetensors``).  Returns the encoder's state dict."""
    from easevoice_trainer_tpu_torch import convert
    from easevoice_trainer_tpu_torch.models.bert import BertModel
    from easevoice_trainer_tpu_torch.utils import safetensors_io

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"model_type": "bert",
                   "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "intermediate_size": cfg.intermediate_size,
                   "max_position_embeddings": cfg.max_position,
                   "type_vocab_size": cfg.type_vocab_size,
                   "layer_norm_eps": cfg.layer_norm_eps}, f)
    with open(os.path.join(root, "vocab.txt"), "w", encoding="utf8") as f:
        f.write("\n".join(vocab) + "\n")
    state = {k: v.cpu() for k, v in convert.random_state_dict(
        BertModel(cfg), gen).items()}
    saved = {"bert." + k: v for k, v in state.items()}
    d = cfg.hidden_size
    saved["bert.pooler.dense.weight"] = torch.zeros(d, d)
    saved["bert.pooler.dense.bias"] = torch.zeros(d)
    path = os.path.join(root, weights)
    if weights.endswith(".safetensors"):
        safetensors_io.save_file(saved, path, {"format": "pt"})
    else:
        torch.save(saved, path)
    return state


def write_g2pw_dir(torch, root: str, bert_cfg, gen, vocab,
                   polyphones=None, monophones=None):
    """A G2PWModel directory: the character tables, the bopomofo-to-pinyin
    table, a BERT tokenizer under ``tokenizer/``, and seeded random
    weights of a G2PWModel of ``bert_cfg``'s widths in ``g2pW.pth``."""
    from easevoice_trainer_tpu_torch import convert
    from easevoice_trainer_tpu_torch.text.g2pw import G2PWConfig, \
        G2PWModel, get_phoneme_labels

    polyphones = polyphones or G2PW_POLYPHONES
    monophones = monophones or G2PW_MONOPHONES
    os.makedirs(os.path.join(root, "tokenizer"), exist_ok=True)
    rows = [(ch, r) for ch, rs in polyphones.items() for r in rs]
    with open(os.path.join(root, "POLYPHONIC_CHARS.txt"), "w",
              encoding="utf8") as f:
        f.write("".join(f"{ch}\t{r}\n" for ch, r in rows))
    with open(os.path.join(root, "MONOPHONIC_CHARS.txt"), "w",
              encoding="utf8") as f:
        f.write("".join(f"{ch}\t{r}\n" for ch, r in monophones.items()))
    bodies = {r[:-1] for _, r in rows} | {r[:-1] for r in monophones.values()}
    with open(os.path.join(root, "bopomofo_to_pinyin_wo_tune_dict.json"),
              "w", encoding="utf8") as f:
        json.dump({b: b for b in sorted(bodies)}, f, ensure_ascii=False)
    with open(os.path.join(root, "tokenizer", "vocab.txt"), "w",
              encoding="utf8") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(root, "tokenizer", "tokenizer_config.json"),
              "w") as f:
        json.dump({"tokenizer_class": "BertTokenizer",
                   "do_lower_case": True}, f)
    labels, char2phonemes = get_phoneme_labels(rows)
    model = G2PWModel(bert_cfg, G2PWConfig(n_labels=len(labels),
                                           n_chars=len(char2phonemes)))
    state = {k: v.cpu() for k, v in
             convert.random_state_dict(model, gen).items()}
    torch.save(state, os.path.join(root, "g2pW.pth"))
    return state


def serve_chinese(torch, tmp: str, results):
    """Chinese synthesis through ``VoiceCloneService.clone`` with a
    full-width BERT (chinese-roberta-wwm-ext-large's widths) and a G2PW
    model at bert-base-chinese widths on the card, weights from
    seeded generators.  Two clones: ZH_TEXT with text_lang "zh" and
    ZH_MIXED with "auto".  Where jieba imports, the whole frontend runs
    live; elsewhere each Chinese run's G2P result comes from ZH_PINNED,
    while G2PW reads the polyphones of the same runs and BERT, the GPT
    and the vocoder run as ever.  Checks: finite non-silent wavs; every
    BERT phone feature handed to the GPT non-zero; K1 at dk 64 launched 24
    times a BERT call, 12 times a G2PW batch and 12 times for the
    reference's HuBERT; the .safetensors load equal to the .bin load;
    BERT's hidden state -3 on the card within 1e-4 relative of the CPU at
    full width; G2PW's probabilities on the card against the CPU; no
    transformers or safetensors module loaded."""
    import re

    import numpy as np

    from easevoice_trainer_tpu_torch import ops
    from easevoice_trainer_tpu_torch.inference import tts as tts_mod
    from easevoice_trainer_tpu_torch.inference.preprocessor import \
        TextPreprocessor
    from easevoice_trainer_tpu_torch.models.bert import BertConfig, \
        BertFeatureExtractor
    from easevoice_trainer_tpu_torch.service.voice import VoiceCloneService
    from easevoice_trainer_tpu_torch.text import chinese
    from easevoice_trainer_tpu_torch.text.symbols import PUNCTUATION
    from easevoice_trainer_tpu_torch.utils import safetensors_io

    try:
        import jieba  # noqa: F401
        route = "jieba"
    except ImportError:
        route = "pinned"
    log(f"[chinese] route: {route} ("
        + ("jieba imports: the whole Chinese frontend runs live"
           if route == "jieba" else
           "jieba does not import here: each Chinese run's phones, word2ph "
           "and normalized text come from ZH_PINNED; G2PW, BERT, the GPT "
           "and the vocoder run live") + ")")

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(20261017)
    vocab = bert_vocab()
    bert_cfg = BertConfig()
    bert_dir = os.path.join(tmp, "chinese-roberta-wwm-ext-large")
    write_bert_dir(torch, bert_dir, bert_cfg, gen, vocab)
    st_dir = os.path.join(tmp, "bert-safetensors")
    os.makedirs(st_dir)
    for name in ("config.json", "vocab.txt"):
        shutil.copy(os.path.join(bert_dir, name), st_dir)
    saved = torch.load(os.path.join(bert_dir, "pytorch_model.bin"),
                       weights_only=True)
    safetensors_io.save_file(saved, os.path.join(st_dir, "model.safetensors"),
                             {"format": "pt"})
    del saved
    g2pw_dir = os.path.join(tmp, "G2PWModel")
    g2pw_cfg = BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                          intermediate_size=3072)
    write_g2pw_dir(torch, g2pw_dir, g2pw_cfg, gen, vocab)
    log(f"[chinese] full-width BERT ({bert_cfg.num_layers} layers x "
        f"{bert_cfg.hidden_size}, vocab {len(vocab)}) as pytorch_model.bin "
        f"and model.safetensors, and a G2PWModel at bert-base widths "
        f"({len(G2PW_POLYPHONES)} polyphonic characters) written in "
        f"{time.perf_counter() - t0:.1f} s")

    # the same weights through both files
    bert = BertFeatureExtractor(bert_dir, "cuda")
    other = BertFeatureExtractor(st_dir, "cuda")
    assert bert.available and other.available
    sa, sb = bert.model.state_dict(), other.model.state_dict()
    same = sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)
    log(f"[chinese] model.safetensors (the port's reader) loads equal to "
        f"pytorch_model.bin: {same} ({len(sa)} tensors)")
    assert same
    del other, sa, sb

    # BERT hidden state -3: the card against the CPU, full width
    sentence = ZH_TEXT.split("。")[0]
    ops.reset_launch_counts()
    card = bert.hidden_states(sentence)[-3].cpu()
    per_call = ops.launch_counts()["encoder_attention"]
    cpu = copy.deepcopy(bert.model).cpu()
    enc = bert.tokenizer(sentence)
    want = cpu(torch.tensor([enc["input_ids"]]),
               torch.tensor([enc["attention_mask"]]))[-3]
    rel = max_err(torch, card, want) / max(1.0, float(want.abs().max()))
    log(f"[chinese] BERT hidden state -3, card vs CPU, {len(enc['input_ids'])}"
        f" tokens: relative max|d|={rel:.3g} (tol 1e-4); K1 dk-64 launches "
        f"a BERT call: {per_call}")
    assert rel <= 1e-4 and per_call == bert_cfg.num_layers
    del bert, cpu

    env = {"EASEVOICE_G2PW_DIR": g2pw_dir}
    old_env = {k: os.environ.get(k) for k in
               ("EASEVOICE_G2PW_DIR", "EASEVOICE_DISABLE_G2PW")}
    os.environ.update(env)
    os.environ.pop("EASEVOICE_DISABLE_G2PW", None)
    try:
        cfg = tts_mod.TTSConfig(os.path.join(tmp, "tts_zh.json"))
        cfg.device = "cuda"
        cfg.bert_base_path = bert_dir
        cfg.cnhubert_base_path = os.path.join(tmp, "chinese-hubert-base")
        cfg.vits_weights_path = cfg.t2s_weights_path = ""
        tts = tts_mod.TTS(cfg)
        assert tts.preprocessor.bert is tts.bert and tts.bert.available
        predictor = chinese._g2pw_predictor()
        assert predictor is not None and \
            predictor.model.classifier.weight.device.type == "cuda"
        clock = {"bert": [0, 0.0, 0], "g2pw": [0, 0.0, 0]}

        def timed(key, fn):
            def run(*args):
                n0 = ops.launch_counts()["encoder_attention"]
                t = time.perf_counter()
                out = fn(*args)
                clock[key][0] += 1
                clock[key][1] += time.perf_counter() - t
                clock[key][2] += ops.launch_counts()["encoder_attention"] - n0
                return out
            return run

        tts.bert.phone_features = timed("bert", tts.bert.phone_features)
        predictor.predict = timed("g2pw", predictor.predict)
        if route == "pinned":
            punct = "".join(PUNCTUATION)

            class Pinned(TextPreprocessor):
                def _clean(self, text, language):
                    if language != "zh":
                        return super()._clean(text, language)
                    phones, word2ph, norm = ZH_PINNED[text]
                    # G2PW reads each punctuation-split segment, as g2p()
                    for seg in re.split(f"(?<=[{punct}])\\s*", norm):
                        seg = re.sub("[a-zA-Z]+", "", seg)
                        if seg.strip():
                            readings = predictor.lazy_pinyin(
                                seg, chinese._char_fallback)
                            assert len(readings) == len(seg)
                    return list(phones), list(word2ph), norm

            tts.preprocessor = Pinned(tts.bert)

        fed = []
        ar_decode = tts._ar_decode

        def checked(batch, *args):
            fed.extend(float(np.abs(seg["bert_features"]).max())
                       for seg in batch)
            return ar_decode(batch, *args)

        tts._ar_decode = checked
        service = VoiceCloneService(_Sessions(), tts)
        for label, text, lang in (("zh", ZH_TEXT, "zh"),
                                  ("mixed", ZH_MIXED, "auto")):
            for v in clock.values():
                v[:] = [0, 0.0, 0]
            fed.clear()
            params = dict(
                text=text, text_lang=lang,
                ref_audio_path=os.path.join(tmp, "ref.wav"), prompt_text="",
                text_split_method="by_chinese_period", batch_size=4,
                parallel_infer=True, split_bucket=True, top_k=15,
                repetition_penalty=1.35, seed=1234, keep_random=False,
                sovits_path=os.path.join(tmp, "sovits_random.pth"),
                gpt_path=os.path.join(tmp, "gpt_random.ckpt"),
                output_dir=os.path.join(tmp, f"out_{label}"))
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            result = service.clone(f"chip-smoke-{label}", params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = ops.launch_counts()
            assert result.ok, result
            wav, sr = read_wav(result.data["output_path"])
            assert sr == 32000 and wav.size > 0
            assert np.isfinite(wav).all(), "non-finite samples"
            assert np.abs(wav).max() > 0, "silent output"
            assert fed and min(fed) > 0, f"zero BERT features fed: {fed}"
            hubert = launches["encoder_attention"] - clock["bert"][2] \
                - clock["g2pw"][2]
            assert clock["bert"][2] == bert_cfg.num_layers \
                * clock["bert"][0], clock
            assert clock["g2pw"][2] == predictor.model.bert.cfg.num_layers \
                * clock["g2pw"][0], clock
            assert clock["bert"][0] > 0 and clock["g2pw"][0] > 0, clock
            assert hubert == (tts.cnhubert.cfg.num_layers if label == "zh"
                              else 0), hubert
            phases = tts.last_phases
            log(f"[chinese] clone {label} ({lang}, {route} route): wall "
                f"{wall:.3f} s, audio {wav.size / sr:.3f} s; phases "
                + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
                + f"; text_preproc: BERT {clock['bert'][1]:.3f} s in "
                f"{clock['bert'][0]} calls ({clock['bert'][2]} K1 dk-64 "
                f"launches), G2PW {clock['g2pw'][1]:.3f} s in "
                f"{clock['g2pw'][0]} batches ({clock['g2pw'][2]} launches), "
                f"the rest {phases['text_preproc'] - clock['bert'][1] - clock['g2pw'][1]:.3f}"
                f" s; segments fed to the GPT {len(fed)}, smallest max|BERT "
                f"feature| {min(fed):.3f}; launches {launches}")
            for name in ("prefill_attention", "decode_attention", "mrf_conv",
                         "encoder_attention"):
                assert launches[name] > 0, f"{name} not launched ({label})"
                r = results[name]
                r["launches"] = r.get("launches", 0) + launches[name]
                per_path = r.setdefault("per_path", {})
                per_path[f"chinese_clone_{label}"] = launches[name]

        # G2PW on the card against the CPU, on one segment's batch
        seg = ZH_TEXT.split("。")[0]
        queries = [i for i, ch in enumerate(seg) if ch in predictor.poly_set]
        texts = [seg] * len(queries)
        p_card = predictor.probabilities(texts, queries)
        predictor.model = predictor.model.cpu()
        predictor.device = torch.device("cpu")
        p_cpu = predictor.probabilities(texts, queries)
        err = float(np.abs(p_card - p_cpu).max())
        same = bool((p_card.argmax(1) == p_cpu.argmax(1)).all())
        log(f"[chinese] G2PW probabilities card vs CPU, {len(queries)} "
            f"polyphonic characters of one segment: max|d|={err:.3g} (tol "
            f"1e-4); labels identical: {same}")
        assert err <= 1e-4 and same
        chinese.set_g2pw_device("cuda")
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("transformers", "safetensors"))
    log(f"[chinese] modules of transformers or safetensors loaded: {foreign}")
    assert not foreign, foreign


# ---------------------------------------------------------------------------
# phase 7: data prep (slicer, FRCRN denoise, the three normalization stages)
# ---------------------------------------------------------------------------

PREP_SOURCES, PREP_SECONDS = 3, 24.0


class _Enough(Exception):
    """Raised from a trainer's on_step to end its run after a few steps."""


def write_speech_source(path: str, seed: int, seconds: float = PREP_SECONDS,
                        sr: int = 32000) -> None:
    """A mono 32 kHz speech-like file: harmonic bursts of 1-6 s (8
    harmonics of an f0 of 100-250 Hz with a 5 % vibrato, a syllable-rate
    envelope, RMS 0.12, white noise at about 20 dB SNR) between
    near-silences of 0.4-1.2 s (RMS 0.001)."""
    import numpy as np

    pcm = np.round(speech_like(seed, seconds, sr) * 32768.0).clip(
        -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def speech_like(seed: int, seconds: float, sr: int):
    """The samples of ``write_speech_source`` (float64, mono)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    parts, total, n_total = [], 0, int(seconds * sr)
    while total < n_total:
        n = int(sr * rng.uniform(1.0, 6.0))
        t = np.arange(n) / sr
        f0 = rng.uniform(100, 250) * (
            1 + 0.05 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        voiced = sum(np.sin(h * phase) / h for h in range(1, 9))
        env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.05) * (
            0.6 + 0.4 * np.abs(np.sin(2 * np.pi * rng.uniform(2, 4) * t)))
        burst = voiced * env
        burst *= 0.12 / np.sqrt(np.mean(burst ** 2))
        burst += rng.normal(0, 0.012, n)
        gap = rng.normal(0, 0.001, int(sr * rng.uniform(0.4, 1.2)))
        parts += [burst, gap]
        total += n + len(gap)
    return np.concatenate(parts)[:n_total]


def write_song_source(path: str, seed: int, seconds: float,
                      sr: int = 44100) -> None:
    """A stereo 44.1 kHz song-like file, UVR5's input: the speech-like
    signal of ``write_speech_source`` panned a little left of center over a
    tonal accompaniment (a three-note chord of 6-harmonic tones, a new root
    every second, panned wide), peak 0.9."""
    import numpy as np

    voice = speech_like(seed, seconds, sr)
    rng = np.random.default_rng(seed + 1000)
    n = len(voice)
    t = np.arange(n) / sr
    acc = np.zeros((2, n))
    for start in range(0, n, sr):
        seg = slice(start, min(n, start + sr))
        root = rng.choice([110.0, 130.8, 146.8, 164.8])
        for i, ratio in enumerate((1.0, 1.26, 1.5)):
            tone = sum(np.sin(2 * np.pi * root * ratio * h * t[seg]) / h
                       for h in range(1, 7))
            pan = (0.8, 0.3, 0.55)[i]
            acc[0, seg] += pan * tone
            acc[1, seg] += (1 - pan) * tone
    acc *= 0.1 / np.sqrt(np.mean(acc ** 2))
    data = np.stack([0.6 * voice, 0.4 * voice]) + acc
    data *= 0.9 / np.abs(data).max()
    pcm = np.round(data.T * 32768.0).clip(-32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.ascontiguousarray(pcm).tobytes())


def modelscope_names(torch, state: dict) -> dict:
    """A replica-scheme FRCRN state dict in the key layout of modelscope's
    released ``speech_frcrn_ans_cirm_16k/pytorch_model.bin`` (the families
    ``audiokit/frcrn.py adapt_modelscope_state`` maps back), with the fixed
    STFT kernels and BatchNorm counters a torch checkpoint holds."""
    out = {}
    for k, v in state.items():
        net, rest = k.split(".", 1)
        m = re.match(r"(enc|dec)(\d+)_(conv|bn)\.(.+)$", rest)
        if m:
            side = "encoder" if m.group(1) == "enc" else "decoder"
            out[f"{net}.{side}{m.group(2)}.{m.group(3)}.{m.group(4)}"] = v
            if m.group(3) == "bn" and m.group(4).endswith("running_var"):
                part = m.group(4).split(".")[0]
                out[f"{net}.{side}{m.group(2)}.bn.{part}."
                    f"num_batches_tracked"] = torch.tensor(0)
            continue
        m = re.match(r"(enc|dec)(\d+)_fr\.fsmn\.(re|im)\.(.+)$", rest)
        if m:
            side = "encoder" if m.group(1) == "enc" else "decoder"
            out[f"{net}.{side}{m.group(2)}.fsmn.fsmn_{m.group(3)}_L1."
                f"{m.group(4)}"] = v
            continue
        m = re.match(r"bottleneck([01])\.(re|im)\.(.+)$", rest)
        if m:
            out[f"{net}.cfsmn.fsmn_{m.group(2)}_L{int(m.group(1)) + 1}."
                f"{m.group(3)}"] = v
            continue
        m = re.match(r"mask_conv\.(.+)$", rest)
        assert m, f"unmapped FRCRN key {k}"
        out[f"{net}.linear.{m.group(1)}"] = v
    out["stft.weight"] = torch.zeros(642, 1, 640)
    out["istft.weight"] = torch.zeros(642, 1, 640)
    return out


def write_frcrn_checkpoint(torch, path: str, cfg, gen, calib) -> None:
    """Seeded random FRCRN weights at ``cfg`` saved as modelscope's
    ``pytorch_model.bin``.  Each BatchNorm's running mean and variance are
    the statistics of its own input on the spectrogram of ``calib`` (a 16
    kHz waveform on the card), as a trained net's would be: every block's
    output stays near unit scale, so the 12 blocks of each U-Net neither
    blow up nor drive the masks' tanh into saturation."""
    from easevoice_trainer_tpu_torch import convert
    from easevoice_trainer_tpu_torch.audiokit import frcrn

    model = frcrn.FRCRN(cfg).cuda().eval()
    model.load_state_dict(convert.random_state_dict(model, gen))

    def calibrate(module, args):
        x = args[0]
        module.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        module.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False)
                                 + 1e-3)

    norms = [m for m in model.modules() if isinstance(m, frcrn._BatchNorm)]
    hooks = [m.register_forward_pre_hook(calibrate) for m in norms]
    with torch.no_grad():
        spec = frcrn.stft(calib, cfg.win_len, cfg.hop, cfg.fft_len)
        model(torch.cat([spec.real, spec.imag])[:, None])
    for h in hooks:
        h.remove()
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    torch.save(modelscope_names(torch, state), path)


def frcrn_groups(torch, den, wav):
    """Device ms of one ``FRCRNDenoiser.run`` on ``wav`` (1, S) under
    torch.profiler, by group: complex convs (encoder and mask), transposed
    convs, FSMN (frequency and bottleneck), BatchNorm + leaky ReLU + the
    masks (the rest of the U-Nets), STFT + inverse STFT.  Each group is a
    ``record_function`` range entered by module hooks; its device time is
    the kernels launched inside it."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from easevoice_trainer_tpu_torch.audiokit import frcrn

    labels = {frcrn.ComplexConv: "complex convs",
              frcrn.ComplexConvTranspose: "transposed convs",
              frcrn.FreqFsmn: "FSMN", frcrn.ComplexFsmn: "FSMN"}
    hooks, stack = [], []

    def enter(label):
        def pre(module, args):
            ctx = record_function(label)
            ctx.__enter__()
            stack.append(ctx)
        return pre

    def leave(module, args, out):
        stack.pop().__exit__(None, None, None)

    for unet in (den.model.unet, den.model.unet2):
        for name, child in unet.named_children():
            label = labels.get(type(child))
            if label is not None:
                hooks.append(child.register_forward_pre_hook(enter(label)))
                hooks.append(child.register_forward_hook(leave))
    stft, istft = frcrn.stft, frcrn.istft

    def ranged(fn):
        def run(*args, **kw):
            with record_function("STFT"):
                return fn(*args, **kw)
        return run

    frcrn.stft, frcrn.istft = ranged(stft), ranged(istft)
    try:
        den.run(wav)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            den.run(wav)
            torch.cuda.synchronize()
    finally:
        frcrn.stft, frcrn.istft = stft, istft
        for h in hooks:
            h.remove()
    events = prof.events()
    total = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)) / 1000
    groups = {}
    for label in ("complex convs", "transposed convs", "FSMN", "STFT"):
        groups[label] = sum(
            getattr(e, "device_time_total", None)
            or getattr(e, "cuda_time_total", 0) for e in events
            if e.name == label and e.device_type == DeviceType.CPU) / 1000
    groups["BatchNorm, leaky ReLU, masks"] = total - sum(groups.values())
    return total, groups


def k1_vs_sdpa_hubert(torch, frames):
    """K1 at dk 64 (``encoder_attention``) against SDPA at HuBERT's shapes:
    B=1, H=12, one T per clip with every frame valid (SDPA with no mask, as
    the unpadded clips need) and the serving shape of phase 3 (T=274, 264
    valid, SDPA with the boolean key mask), each timed three times by
    torch.profiler (mean of 20 calls) and three times by CUDA events
    around 20 calls.  Returns the per-shape times and the SDPA kernels the
    profiler saw."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType

    from easevoice_trainer_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(77)
    hub_t, hub_valid = hubert_frames(5.0)
    shapes = [(t, t) for t in sorted(set(frames))] + [(hub_t, hub_valid)]

    def events_ms(fn, reps=20):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    rows = []
    for t, valid_n in shapes:
        q, k, v = (torch.randn((1, t, 12, 64), generator=gen, device="cuda")
                   for _ in range(3))
        valid = torch.tensor([valid_n], dtype=torch.int32, device="cuda")
        qh, kh, vh = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        mask = None
        if valid_n < t:
            mask = (torch.arange(t, device="cuda")[None] < valid[:, None]
                    )[:, None, None, :]
        k1 = functools.partial(att.encoder_attention, q, k, v, valid)
        sdpa = functools.partial(F.scaled_dot_product_attention, qh, kh, vh,
                                 attn_mask=mask)
        want = att.prefill_attention_reference(q, k, v, t, valid,
                                               torch.zeros_like(valid))
        err = max(max_err(torch, k1(), want),
                  max_err(torch, sdpa().transpose(1, 2)[:, :valid_n],
                          want[:, :valid_n]))
        assert err <= 1e-4, err
        row = {"T": t, "valid": valid_n, "mask": mask is not None}
        for name, fn in (("K1", k1), ("SDPA", sdpa)):
            row[f"{name} profiler"] = [device_ms(torch, fn) for _ in "abc"]
            row[f"{name} events"] = [events_ms(fn) for _ in "abc"]
        try:
            row["SDPA kernels"] = sorted({e.name[:60] for e in device_events(
                torch, lambda: [sdpa() for _ in range(20)])
                if e.device_type == DeviceType.CUDA})
        except NoDeviceActivity:
            row["SDPA kernels"] = "not recorded"
        rows.append(row)
        del q, k, v, qh, kh, vh
    return rows


def data_prep(torch, tmp: str, results):
    """Dataset preparation at full width, through the entry points a user
    calls: three synthetic 24 s sources -> ``AudioService.slicer`` ->
    ``python -m easevoice_trainer_tpu_torch.cmd.audio_denoise`` in a
    subprocess (FRCRN at ``FRCRNConfig()``, seeded random weights in
    modelscope's key layout) -> a refinement list (mostly zh rows with the
    sentences of ZH_PINNED, two en rows) -> ``NormalizeService.run()``
    (BERT-large, HuBERT-base from a ``model.safetensors``-only directory,
    the s2G at ``SovitsConfig()``), each stage timed; then 2 s2 steps and 2
    s1 micro-batches on the normalized folder, the card against the CPU on
    one clip, and K1 at dk 64 against SDPA at these clips' HuBERT
    shapes."""
    import numpy as np

    from easevoice_trainer_tpu_torch import convert, ops
    from easevoice_trainer_tpu_torch.audiokit import frcrn
    from easevoice_trainer_tpu_torch.models.bert import BertConfig, \
        BertFeatureExtractor
    from easevoice_trainer_tpu_torch.models.cnhubert import CNHubert, \
        config_from_hf
    from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
        Text2SemanticDecoder
    from easevoice_trainer_tpu_torch.models.sovits import \
        MultiPeriodDiscriminator, SovitsConfig, SynthesizerTrn
    from easevoice_trainer_tpu_torch.normalization import Normalize
    from easevoice_trainer_tpu_torch.service.audio import AudioService
    from easevoice_trainer_tpu_torch.service.normalize import \
        NormalizeService
    from easevoice_trainer_tpu_torch.text import cleaner
    from easevoice_trainer_tpu_torch.text.symbols import sequence_to_symbols
    from easevoice_trainer_tpu_torch.train import ckpt
    from easevoice_trainer_tpu_torch.train import data as data_mod
    from easevoice_trainer_tpu_torch.train.gpt import GPTTrain, \
        GPTTrainParams, gpt_export_tree
    from easevoice_trainer_tpu_torch.train.sovits import SovitsTrain, \
        SovitsTrainParams
    from easevoice_trainer_tpu_torch.utils import audio_io, paths, \
        safetensors_io, simple_yaml
    from easevoice_trainer_tpu_torch.utils.connector import RESP_PREFIX

    try:
        import jieba  # noqa: F401
        route = "jieba"
    except ImportError:
        route = "pinned"
    log(f"[data prep] route: {route} ("
        + ("jieba imports: the zh rows are cleaned live"
           if route == "jieba" else
           "jieba does not import here: each zh row's phones, word2ph and "
           "normalized text come from ZH_PINNED, the phone ids mapped back "
           "to symbols; BERT, HuBERT and the s2G run live") + ")")
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "prep")
    src, work = os.path.join(root, "src"), os.path.join(root, "work")
    os.makedirs(src)

    # 1. sources and the slicer
    for i in range(PREP_SOURCES):
        write_speech_source(os.path.join(src, f"speaker{i}.wav"), 100 + i)
    audio = AudioService(src, work, "cuda")
    t0 = time.perf_counter()
    resp = audio.slicer()
    slice_s = time.perf_counter() - t0
    assert resp.ok and all(v == "success" for v in resp.data.values()), resp
    slices = sorted(os.listdir(os.path.join(work, paths.SLICES_OUTPUT)))
    lengths = [os.path.getsize(os.path.join(work, paths.SLICES_OUTPUT, n))
               / 2 / 32000 for n in slices]   # 44-byte header aside
    log(f"[data prep] AudioService.slicer (default parameters) on "
        f"{PREP_SOURCES} sources of {PREP_SECONDS:.0f} s: {len(slices)} "
        f"clips of " + ", ".join(f"{s:.2f}" for s in lengths)
        + f" s in {slice_s:.2f} s")
    assert 8 <= len(slices) <= 15, len(slices)

    # 2. denoise: seeded random FRCRN weights, modelscope layout, then the
    #    denoise cmd as a subprocess (as the session manager runs it)
    cfg = frcrn.FRCRNConfig()
    frcrn_dir = os.path.join(root, "speech_frcrn_ans_cirm_16k")
    os.makedirs(frcrn_dir)
    frcrn_path = os.path.join(frcrn_dir, "pytorch_model.bin")
    first = os.path.join(work, paths.SLICES_OUTPUT, slices[0])
    calib = audio_io.load_audio(first, 16000)[:2 * 16000]
    gen = torch.Generator(device="cuda").manual_seed(20261019)
    write_frcrn_checkpoint(torch, frcrn_path, cfg, gen,
                           torch.from_numpy(calib)[None].cuda())
    den = frcrn.FRCRNDenoiser(frcrn_path, "cuda")
    assert den.cfg == cfg
    n_params = sum(p.numel() for p in den.model.parameters())
    wav16 = torch.from_numpy(np.pad(calib, (0, 32000 - len(calib))))[None]
    with torch.no_grad():
        spec = frcrn.stft(wav16.cuda())
        spec = torch.cat([spec.real, spec.imag])[:, None]
        _, mask = den.model(spec)
        re, im = mask[:, 0].chunk(2)
        mask_abs = float(torch.sqrt(re ** 2 + im ** 2).mean())
    out = den.run(wav16.cuda()).cpu()
    ratio = float(out.square().mean().sqrt() / wav16.square().mean().sqrt())
    log(f"[data prep] FRCRN at FRCRNConfig() ({n_params / 1e6:.2f} M "
        f"parameters; BatchNorm statistics calibrated on 2 s of the first "
        f"clip) written as modelscope's pytorch_model.bin and read back "
        f"through adapt_modelscope_state: mean |mask| {mask_abs:.3f}, "
        f"output RMS / input RMS {ratio:.3f} on that 2 s")
    assert math.isfinite(mask_abs) and 0.05 < mask_abs < 1.95, mask_abs
    assert math.isfinite(ratio) and ratio > 0

    params_path = os.path.join(root, "denoise.json")
    with open(params_path, "w") as f:
        json.dump({"source_dir": src, "output_dir": work,
                   "device": "cuda"}, f)
    env = dict(os.environ, PYTHONPATH=HERE, EASEVOICE_FRCRN_PATH=frcrn_path,
               NVIDIA_TF32_OVERRIDE="0")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "easevoice_trainer_tpu_torch.cmd."
         "audio_denoise", "-c", params_path], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=600)
    denoise_s = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(RESP_PREFIX + " ")]
    assert proc.returncode == 0 and len(lines) == 1, \
        (proc.returncode, proc.stdout[-2000:], proc.stderr[-3000:])
    resp = json.loads(lines[0][len(RESP_PREFIX) + 1:])
    denoised = sorted(os.listdir(os.path.join(work, paths.DENOISES_OUTPUT)))
    log(f"[data prep] cmd.audio_denoise subprocess: {resp['status']}, "
        f"'{resp['message']}', {len(denoised)} files in {denoise_s:.2f} s "
        f"wall ({denoise_s / len(slices):.3f} s a clip, the interpreter's "
        f"start and the model load included)")
    assert resp["status"] == "success", resp
    assert "backend: frcrn-torch" in resp["message"], resp
    assert all(v == "success" for v in resp["data"].values()), resp
    assert denoised == slices
    for name in denoised:
        wav, sr = read_wav(os.path.join(work, paths.DENOISES_OUTPUT, name))
        assert sr == 16000 and np.isfinite(wav).all() and \
            np.abs(wav).max() > 0, name

    # 2b. the ASR chain over the denoised clips, in its own output dirs
    asr_chain(torch, tmp, work, denoised, results)
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the refinement list: zh rows with ZH_PINNED's sentences, two en
    zh_sentences = [s + "。" for s in ZH_TEXT.split("。") if s]
    langs = {}
    for i, name in enumerate(denoised):
        lang = "en" if i in (1, len(denoised) - 2) else "zh"
        text = (SENTENCES[i % len(SENTENCES)] if lang == "en"
                else zh_sentences[i % len(zh_sentences)])
        audio.refinement_submit_text(
            os.path.join(work, paths.DENOISES_OUTPUT, name), lang, text)
        langs[name] = lang
    zh_rows = sum(1 for v in langs.values() if v == "zh")

    # 4. the three normalization stages at full width
    bert_dir = os.path.join(tmp, "chinese-roberta-wwm-ext-large")
    if not os.path.isdir(bert_dir):   # the phase run alone
        write_bert_dir(torch, bert_dir, BertConfig(), gen, bert_vocab())
    # phase 4's HuBERT-base, rewritten as a model.safetensors-only
    # directory: the SSL stage reads it through load_cnhubert
    hub_src = os.path.join(tmp, "chinese-hubert-base")
    hub_bin = os.path.join(hub_src, "pytorch_model.bin")
    hub_state = (torch.load(hub_bin, weights_only=True)
                 if os.path.exists(hub_bin) else
                 convert.random_state_dict(CNHubert(), gen))
    hub_dir = os.path.join(root, "chinese-hubert-base")
    os.makedirs(hub_dir)
    if os.path.exists(os.path.join(hub_src, "config.json")):
        shutil.copy(os.path.join(hub_src, "config.json"), hub_dir)
    safetensors_io.save_file({k: v.cpu().contiguous() for k, v in
                              hub_state.items()},
                             os.path.join(hub_dir, "model.safetensors"))
    del hub_state
    hub_cfg = config_from_hf(hub_dir)
    s2g = os.path.join(root, "s2G_random.pth")
    s2d = os.path.join(root, "s2D_random.pth")
    with open(paths.s2_config_path(), encoding="utf8") as f:
        s2_cfg = SovitsConfig.from_json_dict(json.load(f))
    random_weights(torch, SynthesizerTrn(s2_cfg, with_enc_q=True), gen, s2g)
    random_weights(torch, MultiPeriodDiscriminator(), gen, s2d)
    old_env = {k: os.environ.get(k) for k in
               ("bert_path", "cnhubert_path", "sovits_path")}
    os.environ.update(bert_path=bert_dir, cnhubert_path=hub_dir,
                      sovits_path=s2g)
    clean_text = cleaner.clean_text
    if route == "pinned":
        def pinned(text, language):
            if language != "zh":
                return clean_text(text, language)
            ids, word2ph, norm = ZH_PINNED[text]
            return sequence_to_symbols(ids), list(word2ph), norm
        cleaner.clean_text = pinned
    bert_call, hubert_call = BertFeatureExtractor.phone_features, \
        CNHubert.forward
    clock = {"bert": [0, 0.0], "hubert": [0, 0.0]}

    def timed(key, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            clock[key][0] += 1
            clock[key][1] += time.perf_counter() - t
            return out
        return run

    BertFeatureExtractor.phone_features = timed("bert", bert_call)
    CNHubert.forward = timed("hubert", hubert_call)
    stages = {}
    try:
        service = NormalizeService(work, "normalized", "cuda")
        norm = service.normalize
        for name in ("text", "ssl", "token"):
            fn = getattr(norm, name)

            def stage(fn=fn, name=name):
                n0 = ops.launch_counts()
                t = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                n1 = ops.launch_counts()
                stages[name] = (time.perf_counter() - t,
                                {k: n1[k] - n0[k] for k in n1})
                return out
            setattr(norm, name, stage)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = service.run()
        torch.cuda.synchronize()
        norm_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        norm_peak = torch.cuda.max_memory_allocated()
    finally:
        cleaner.clean_text = clean_text
        BertFeatureExtractor.phone_features = bert_call
        CNHubert.forward = hubert_call
    assert resp.ok, resp
    out_dir = resp.data["output_path"]
    assert out_dir == os.path.join(work, "normalized")
    clips = len(denoised)
    bert_files = sorted(os.listdir(norm.bert_dir))
    assert bert_files == sorted(n + ".pt" for n, v in langs.items()
                                if v == "zh"), bert_files
    assert sorted(os.listdir(norm.hubert_dir)) == [n + ".pt"
                                                   for n in denoised]
    assert sorted(os.listdir(norm.wav_dir)) == denoised
    with open(norm.semantic_output_path, encoding="utf8") as f:
        rows = f.read().strip("\n").split("\n")
    assert rows[0] == "item_name\tsemantic_audio" and len(rows) == clips + 1
    frames = {}
    for row in rows[1:]:
        name, codes = row.split("\t")
        ssl = torch.load(os.path.join(norm.hubert_dir, name + ".pt"),
                         weights_only=True)
        assert ssl.dtype == torch.float32 and ssl.is_contiguous()
        assert ssl.shape[:2] == (1, hub_cfg.hidden_size)
        assert torch.isfinite(ssl).all()
        frames[name] = ssl.shape[2]
        assert len(codes.split()) == ssl.shape[2] // 2, name
    for name in bert_files:
        feat = torch.load(os.path.join(norm.bert_dir, name), weights_only=True)
        assert feat.shape[0] == 1024 and feat.dtype == torch.float32
        assert feat.is_contiguous() and float(feat.abs().max()) > 0
    bert_layers, hub_layers = BertConfig().num_layers, hub_cfg.num_layers
    k1 = {k: v[1]["encoder_attention"] for k, v in stages.items()}
    log(f"[data prep] NormalizeService.run(): {norm_s:.2f} s for {clips} "
        f"clips ({zh_rows} zh rows, {clips - zh_rows} en rows): "
        + ", ".join(f"{k} {v[0]:.3f} s ({v[0] / clips:.4f} s a clip, K1 "
                    f"dk-64 launches {k1[k]})" for k, v in stages.items())
        + f"; BERT {1000 * clock['bert'][1] / max(1, clock['bert'][0]):.2f} "
        f"ms a call over {clock['bert'][0]} calls, HuBERT "
        f"{1000 * clock['hubert'][1] / max(1, clock['hubert'][0]):.2f} ms "
        f"a clip over {clock['hubert'][0]} clips (host clock, synchronized); "
        f"peak memory {norm_peak / 2 ** 30:.2f} GiB; launches {launches}")
    assert k1 == {"text": bert_layers * zh_rows, "ssl": hub_layers * clips,
                  "token": 0}, k1
    assert clock["bert"][0] == zh_rows and clock["hubert"][0] == clips
    assert launches["encoder_attention"] > 0
    r = results["encoder_attention"]
    r["launches"] = r.get("launches", 0) + launches["encoder_attention"]
    r.setdefault("per_path", {})["data_prep_normalize"] = \
        launches["encoder_attention"]

    # 5. the normalized folder trains: 2 s2 steps, 2 s1 micro-batches
    cfg_yaml = simple_yaml.load(paths.gpt_config_path())
    t2s_cfg = T2SConfig.from_yaml_dict(cfg_yaml)
    init = Text2SemanticDecoder(t2s_cfg)
    init.load_state_dict({k: v.cpu() for k, v in convert.random_state_dict(
        init, gen).items()})
    gpt_ckpt = os.path.join(root, "s1_random.ckpt")
    ckpt.export_gpt_weights(gpt_export_tree(init.state_dict()), gpt_ckpt,
                            config=cfg_yaml, info="random")
    del init
    fed = []
    collate = data_mod.collate_gpt

    def recording(items, *args):
        fed.append([(it["name"], float(np.abs(it["bert"]).max()))
                    for it in items])
        return collate(items, *args)

    losses = {"s2": [], "s1": []}

    def stop_after(key, n):
        def on_step(step, metrics):
            losses[key].append({k: float(v) for k, v in metrics.items()})
            if len(losses[key]) == n:
                raise _Enough
        return on_step

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s2 = SovitsTrain(SovitsTrainParams(
        batch_size=4, total_epochs=1, save_every_epoch=1,
        pretrained_s2G=s2g, pretrained_s2D=s2d, train_input_dir=out_dir,
        output_model_name="prep_s2", project_dir=os.path.join(root, "proj"),
        device="cuda"))
    try:
        s2.train(on_step=stop_after("s2", 2))
    except _Enough:
        pass
    s2_s = time.perf_counter() - t0
    data_mod.collate_gpt = recording
    t0 = time.perf_counter()
    try:
        s1 = GPTTrain(GPTTrainParams(
            batch_size=4, total_epochs=1, save_every_epoch=1,
            model_path=gpt_ckpt, train_input_dir=out_dir,
            output_model_name="prep_s1",
            project_dir=os.path.join(root, "proj"), device="cuda"))
        try:
            s1.train(on_step=stop_after("s1", 2))
        except _Enough:
            pass
    finally:
        data_mod.collate_gpt = collate
    s1_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    train_launches = ops.launch_counts()
    for key in ("s2", "s1"):
        assert len(losses[key]) == 2, losses
        for m in losses[key]:
            bad = {k: v for k, v in m.items() if not math.isfinite(v)}
            assert not bad, f"{key}: non-finite {bad}"
    fed = fed[:2]
    zh_fed = [a for batch in fed for n, a in batch if langs[n] == "zh"]
    en_fed = [a for batch in fed for n, a in batch if langs[n] == "en"]
    assert zh_fed and min(zh_fed) > 0 and not any(en_fed), fed
    # is_half at its default: both fine-tunes on the bf16 instances
    for name in ("mrf_conv", "mrf_conv_bwd_data", "mrf_conv_bwd_weight",
                 "prefill_attention", "prefill_attention_bwd"):
        assert train_launches[name + "_bf16"] > 0, (name, train_launches)
    for name, n in train_launches.items():
        if n:
            r = results[name]
            r["launches"] = r.get("launches", 0) + n
            r.setdefault("per_path", {})["data_prep_training"] = n
    log(f"[data prep] the normalized folder trains: SovitsTrain 2 steps of "
        f"B=4 in {s2_s:.2f} s (loss/g/total "
        + ", ".join(f"{m['loss/g/total']:.3f}" for m in losses["s2"])
        + f"), GPTTrain 2 micro-batches of B=4 in {s1_s:.2f} s (loss "
        + ", ".join(f"{m['loss']:.1f}" for m in losses["s1"])
        + f"), model loads included; the s1 batches carried "
        f"{len(zh_fed)} zh rows with their 3-bert features (smallest max|f| "
        f"{min(zh_fed):.3f}) and {len(en_fed)} en rows of zeros; launches "
        f"{train_launches}")
    del s2, s1
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the card against the CPU on one clip (the shortest)
    name = min(denoised, key=lambda n: frames[n])
    clip32 = audio_io.load_audio(os.path.join(work, paths.SLICES_OUTPUT,
                                              name), 32000)
    t0 = time.perf_counter()
    on_card = den.process(clip32, 32000)
    card_s = time.perf_counter() - t0
    on_cpu = frcrn.FRCRNDenoiser(frcrn_path, "cpu").process(clip32, 32000)
    frcrn_rel = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    one = os.path.join(root, "one")
    os.makedirs(os.path.join(one, paths.REFINEMENTS_OUTPUT))
    os.makedirs(os.path.join(one, paths.DENOISES_OUTPUT))
    shutil.copy(os.path.join(work, paths.DENOISES_OUTPUT, name),
                os.path.join(one, paths.DENOISES_OUTPUT, name))
    with open(os.path.join(one, paths.REFINEMENTS_OUTPUT,
                           paths.REFINEMENT_FILE), "w") as f:
        f.write(f"{name}|{langs[name]}|-\n")
    os.environ["cnhubert_path"] = hub_dir
    cpu_ssl = Normalize(one, "cpu_ssl", "cpu")
    assert cpu_ssl.ssl().ok
    want = torch.load(os.path.join(cpu_ssl.hubert_dir, name + ".pt"),
                      weights_only=True)
    got = torch.load(os.path.join(norm.hubert_dir, name + ".pt"),
                     weights_only=True)
    ssl_rel = max_err(torch, got, want) / float(want.abs().max())
    cpu_tok = Normalize(one, "cpu_token", "cpu")
    shutil.copy(os.path.join(norm.hubert_dir, name + ".pt"),
                cpu_tok.hubert_dir)
    assert cpu_tok.token().ok
    with open(cpu_tok.semantic_output_path, encoding="utf8") as f:
        cpu_codes = [int(c) for c in f.read().split("\n")[1].split("\t")[1]
                     .split()]
    card_codes = [int(c) for row in rows[1:] if row.startswith(name + "\t")
                  for c in row.split("\t")[1].split()]
    differ = [i for i, (a, b) in enumerate(zip(card_codes, cpu_codes))
              if a != b]
    assert len(card_codes) == len(cpu_codes)
    ties = ""
    if differ:
        vits = SynthesizerTrn(s2_cfg)
        vits.load_state_dict(convert.load_torch_state_dict(
            s2g, drop_prefix="enc_q."), strict=True)
        with torch.no_grad():
            h = vits.ssl_proj(got).transpose(1, 2)[0]     # (T25, D)
            d = torch.cdist(h, vits.quantizer.codebook(0)) ** 2
        worst = 0.0
        for i in differ:
            d1, d2 = torch.topk(d[i], 2, largest=False).values.tolist()
            worst = max(worst, (d2 - d1) / max(d2, 1e-12))
        ties = (f"; the two nearest distances of each differing code within "
                f"{worst:.3g} relative (tol 1e-4)")
        assert worst <= 1e-4, worst
    log(f"[data prep] card vs CPU on {name} ({len(clip32) / 32000:.2f} s): "
        f"FRCRN output relative max|d|={frcrn_rel:.3g} (tol 1e-4; "
        f"card {card_s:.3f} s for the clip); 4-cnhubert relative "
        f"max|d|={ssl_rel:.3g} (tol 1e-4); semantic codes identical "
        f"{len(card_codes) - len(differ)}/{len(card_codes)}{ties}")
    assert frcrn_rel <= 1e-4 and ssl_rel <= 1e-4
    for k, v in old_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v

    # FRCRN device time by group, one clip, per second of audio
    padded = -(-len(on_card) // 32000) * 32000
    wav = torch.zeros((1, padded), device="cuda")
    wav[0, :len(on_card)] = torch.from_numpy(
        audio_io.resample(clip32, 32000, 16000)).cuda()
    total, groups = frcrn_groups(torch, den, wav)
    secs = padded / 16000
    log(f"[data prep] FRCRN under torch.profiler, one clip padded to "
        f"{secs:.0f} s: device {total:.3f} ms ({total / secs:.3f} ms a "
        f"second of audio): " + ", ".join(
            f"{k} {v:.3f} ms ({v / secs:.3f} ms/s)"
            for k, v in groups.items()))

    # 7. K1 at dk 64 against SDPA at these clips' HuBERT shapes
    for row in k1_vs_sdpa_hubert(torch, list(frames.values())):
        log(f"[data prep] HuBERT attention B=1 H=12 T={row['T']} valid "
            f"{row['valid']} (SDPA {'with' if row['mask'] else 'without'} "
            f"the boolean key mask), ms a call, three reps each: K1 "
            f"profiler {row['K1 profiler']}, events {row['K1 events']}; "
            f"SDPA profiler {row['SDPA profiler']}, events "
            f"{row['SDPA events']}; SDPA kernels {row['SDPA kernels']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[data prep] phase wall {time.perf_counter() - t_phase:.1f} s "
        f"(slicer {slice_s:.2f}, denoise subprocess {denoise_s:.2f}, "
        f"normalize {norm_s:.2f}, s2 {s2_s:.2f}, s1 {s1_s:.2f}); peak "
        f"memory from the normalize run on, training included, {peak:.2f} "
        f"GiB (torch.cuda.max_memory_allocated)")


# ---------------------------------------------------------------------------
# phase 7, ASR: fsmn-VAD -> Paraformer-large -> CT-punc (zh), Whisper (en)
# ---------------------------------------------------------------------------

# whisper-small's 99 language tokens, in its tokenizer's order
WHISPER_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el "
    "ms cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az "
    "sl kn et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af "
    "oc ka be tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as "
    "tt haw ln ha ba jw su").split()
WHISPER_TASKS = ("<|translate|>", "<|transcribe|>", "<|startoflm|>",
                 "<|startofprev|>", "<|nocaptions|>", "<|notimestamps|>")


def funasr_yaml(kind: str, cfg) -> str:
    """A FunASR ``config.yaml`` in the layout of the released one of
    ``kind`` ("paraformer", "vad", "punc") with ``cfg``'s widths: nested
    mappings, block sequences (the specaug ranges, CT-punc's ``punc_list``,
    a sequence of sequences in ``train_conf``), flow sequences
    (``sil_pdf_ids``) and comments."""
    if kind == "paraformer":
        n_mels = cfg.input_size // cfg.lfr_m
        return f"""# network architecture
model: Paraformer
model_conf:
    ctc_weight: 0.0
    lsm_weight: 0.1
    length_normalized_loss: true
    predictor_weight: 1.0
    predictor_bias: 1
    sampling_ratio: 0.75

# encoder
encoder: SANMEncoder
encoder_conf:
    output_size: {cfg.d_model}
    attention_heads: {cfg.n_heads}
    linear_units: {cfg.ffn_dim}
    num_blocks: {cfg.encoder_layers}
    dropout_rate: 0.1
    positional_dropout_rate: 0.1
    attention_dropout_rate: 0.1
    input_layer: pe
    pos_enc_class: SinusoidalPositionEncoder
    normalize_before: true
    kernel_size: {cfg.fsmn_kernel}
    sanm_shfit: 0
    selfattention_layer_type: sanm

# decoder
decoder: ParaformerSANMDecoder
decoder_conf:
    attention_heads: {cfg.n_heads}
    linear_units: {cfg.ffn_dim}
    num_blocks: {cfg.decoder_layers}
    dropout_rate: 0.1
    positional_dropout_rate: 0.1
    self_attention_dropout_rate: 0.1
    src_attention_dropout_rate: 0.1
    att_layer_num: {cfg.decoder_layers}
    kernel_size: {cfg.fsmn_kernel}
    sanm_shfit: 0

predictor: CifPredictorV2
predictor_conf:
    idim: {cfg.d_model}
    threshold: {cfg.cif_threshold}
    l_order: {(cfg.predictor_kernel - 1) // 2}
    r_order: {(cfg.predictor_kernel - 1) // 2}
    tail_threshold: {cfg.tail_threshold}

# frontend related
frontend: WavFrontend
frontend_conf:
    fs: 16000
    window: hamming
    n_mels: {n_mels}
    frame_length: 25
    frame_shift: 10
    lfr_m: {cfg.lfr_m}
    lfr_n: {cfg.lfr_n}

specaug: SpecAugLFR
specaug_conf:
    apply_time_warp: false
    time_warp_window: 5
    time_warp_mode: bicubic
    apply_freq_mask: true
    freq_mask_width_range:
    - 0
    - 30
    lfr_rate: {cfg.lfr_n}
    num_freq_mask: 1
    apply_time_mask: true
    time_mask_width_range:
    - 0
    - 12
    num_time_mask: 1

train_conf:
  accum_grad: 1
  grad_clip: 5
  max_epoch: 150
  val_scheduler_criterion:
      - valid
      - acc
  best_model_criterion:
  -   - valid
      - acc
      - max
  keep_nbest_models: 10
  log_interval: 50

optim: adam
optim_conf:
   lr: 0.0005
scheduler: warmuplr
scheduler_conf:
   warmup_steps: 30000

tokenizer: CharTokenizer
tokenizer_conf:
  unk_symbol: <unk>
  split_with_space: true

normalize: null
vocab_size: {cfg.vocab_size}
"""
    if kind == "vad":
        n_mels = cfg.input_dim // cfg.lfr_m
        return f"""frontend: WavFrontendOnline
frontend_conf:
    fs: 16000
    window: hamming
    n_mels: {n_mels}
    frame_length: 25
    frame_shift: 10
    dither: 0.0
    lfr_m: {cfg.lfr_m}
    lfr_n: {cfg.lfr_n}

model: FsmnVADStreaming
model_conf:
    sample_rate: 16000
    detect_mode: 1
    snr_mode: 0
    max_end_silence_time: {cfg.max_end_silence_time}
    max_start_silence_time: 3000
    do_start_point_detection: True
    do_end_point_detection: True
    window_size_ms: {cfg.window_size_ms}
    sil_to_speech_time_thres: {cfg.sil_to_speech_time_thres}
    speech_to_sil_time_thres: {cfg.speech_to_sil_time_thres}
    speech_2_noise_ratio: 1.0
    do_extend: 1
    lookback_time_start_point: {cfg.lookback_time_start_point}
    lookahead_time_end_point: {cfg.lookahead_time_end_point}
    max_single_segment_time: {cfg.max_single_segment_time}
    snr_thres: -100.0
    noise_frame_num_used_for_snr: 100
    decibel_thres: -100.0
    speech_noise_thres: {cfg.speech_noise_thres}
    fe_prior_thres: 0.0001
    silence_pdf_num: 1
    sil_pdf_ids: [{", ".join(str(i) for i in cfg.sil_pdf_ids)}]
    speech_noise_thresh_low: -0.1
    speech_noise_thresh_high: 0.3
    output_frame_probs: False
    frame_in_ms: 10
    frame_length_ms: 25

encoder: FSMN
encoder_conf:
    input_dim: {cfg.input_dim}
    input_affine_dim: {cfg.input_affine_dim}
    fsmn_layers: {cfg.fsmn_layers}
    linear_dim: {cfg.linear_dim}
    proj_dim: {cfg.proj_dim}
    lorder: {cfg.lorder}
    rorder: {cfg.rorder}
    lstride: 1
    rstride: 0
    output_affine_dim: {cfg.output_affine_dim}
    output_dim: {cfg.output_dim}
"""
    marks = "".join(f"    - {p}\n" for p in cfg.punc_list)
    weights = "".join("    - 1.0\n" for _ in cfg.punc_list)
    return f"""model: CTTransformer
model_conf:
    ignore_id: 0
    embed_unit: {cfg.embed_unit}
    att_unit: {cfg.d_model}
    dropout_rate: 0.1
    punc_list:
{marks}    punc_weight:
{weights}    sentence_end_id: 3

encoder: SANMEncoder
encoder_conf:
    input_size: {cfg.embed_unit}
    output_size: {cfg.d_model}
    attention_heads: {cfg.n_heads}
    linear_units: {cfg.ffn_dim}
    num_blocks: {cfg.num_blocks}
    dropout_rate: 0.1
    positional_dropout_rate: 0.1
    attention_dropout_rate: 0.0
    input_layer: pe
    pos_enc_class: SinusoidalPositionEncoder
    normalize_before: true
    kernel_size: {cfg.fsmn_kernel}
    sanm_shfit: 0
    selfattention_layer_type: sanm
    padding_idx: 0

tokenizer: CharTokenizer
tokenizer_conf:
  unk_symbol: <unk>
vocab_size: {cfg.vocab_size}
"""


def write_am_mvn(path: str, dim: int, seed: int) -> None:
    """A kaldi-nnet ``am.mvn`` of ``dim`` entries: shifts near minus a
    log-mel's mean, scales near one over its deviation."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shift = " ".join(f"{v:.6f}" for v in rng.uniform(-14.0, -8.0, dim))
    scale = " ".join(f"{v:.6f}" for v in rng.uniform(0.2, 0.4, dim))
    with open(path, "w") as f:
        f.write(f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n<AddShift> {dim} "
                f"{dim}\n<LearnRateCoef> 0 [ {shift} ]\n<Rescale> {dim} "
                f"{dim}\n<LearnRateCoef> 0 [ {scale} ]\n</Nnet>\n")


def asr_tokens(size: int, chars: str, head=("<blank>", "<s>", "</s>")):
    """A FunASR token list of ``size`` entries: ``head``, ``chars``, the
    CJK block from U+4E00, English pieces (``xy@@`` continuations and
    whole words), ``<unk>`` last."""
    import itertools
    import string

    out = list(dict.fromkeys(list(head) + list(chars)))[:size - 1]
    seen = set(out)
    out += [chr(c) for c in range(0x4E00, 0x9FA6)
            if chr(c) not in seen][:max(0, (size - 1 - len(out)) // 2)]
    letters = string.ascii_lowercase
    for n in itertools.count(1):
        for word in itertools.product(letters, repeat=n):
            if len(out) >= size - 1:
                return out + ["<unk>"]
            out.append("".join(word) + ("@@" if len(out) % 2 else ""))


def write_funasr_dir(torch, root: str, kind: str, cfg, module, gen,
                     tokens=None, mvn_dim=None, extra=None):
    """A FunASR model directory: ``config.yaml``, seeded random weights of
    ``module`` in ``model.pt`` (with ``extra`` tensors, a released file's
    training-only ones), ``tokens.json`` and ``am.mvn`` where given.
    Returns the weights written (on the CPU)."""
    from easevoice_trainer_tpu_torch import convert

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.yaml"), "w",
              encoding="utf8") as f:
        f.write(funasr_yaml(kind, cfg))
    state = {k: v.cpu() for k, v in
             convert.random_state_dict(module, gen).items()}
    state.update(extra or {})
    torch.save(state, os.path.join(root, "model.pt"))
    if tokens is not None:
        with open(os.path.join(root, "tokens.json"), "w",
                  encoding="utf8") as f:
            json.dump(tokens, f, ensure_ascii=False)
    if mvn_dim:
        # seeded by the model kind: the directory's path differs from run
        # to run (a test's temp dir), and the statistics must not
        write_am_mvn(os.path.join(root, "am.mvn"), mvn_dim,
                     zlib.crc32(kind.encode()))
    return state


def write_asr_dirs(torch, root: str, gen, para_cfg, vad_cfg, punc_cfg,
                   chars: str):
    """The three zh ASR directories under ``root`` (``paraformer-zh``,
    ``fsmn-vad``, ``ct-punc``), as ``tools/fetch_pretrained.py`` lays
    them out, with seeded random weights: the Paraformer's ``model.pt``
    also holds the decoder's training-only token embedding, the VAD's
    carries FunASR's ``encoder.`` prefix.  Returns the three paths."""
    from easevoice_trainer_tpu_torch.audiokit import asr_paraformer, \
        punc_ct, vad_fsmn

    paths_ = [os.path.join(root, n)
              for n in ("paraformer-zh", "fsmn-vad", "ct-punc")]
    embed = (torch.rand((para_cfg.vocab_size, para_cfg.d_model),
                        generator=gen, device=gen.device) - 0.5).cpu()
    write_funasr_dir(torch, paths_[0], "paraformer", para_cfg,
                     asr_paraformer.Paraformer(para_cfg), gen,
                     asr_tokens(para_cfg.vocab_size, chars),
                     para_cfg.input_size, {"decoder.embed.0.weight": embed})
    vad = vad_fsmn.FSMN(vad_cfg)
    state = write_funasr_dir(torch, paths_[1], "vad", vad_cfg, vad, gen,
                             mvn_dim=vad_cfg.input_dim)
    torch.save({"encoder." + k: v for k, v in state.items()},
               os.path.join(paths_[1], "model.pt"))
    write_funasr_dir(torch, paths_[2], "punc", punc_cfg,
                     punc_ct.CTTransformer(punc_cfg), gen,
                     asr_tokens(punc_cfg.vocab_size, chars,
                                ("<blank>", "<s>", "</s>")))
    return paths_


def whisper_tokenizer_json(n_base: int, languages=WHISPER_LANGUAGES,
                           n_timestamps: int = 1501) -> dict:
    """A ``tokenizer.json`` in whisper's layout: a byte-level BPE of
    ``n_base`` pieces (the 256 byte characters, then two-character merges,
    so multi-byte UTF-8 sequences span pieces), then the added tokens in
    whisper's order: ``<|endoftext|>``, ``<|startoftranscript|>``, one
    token a language, the task tokens, ``<|notimestamps|>``, and
    ``n_timestamps`` timestamps ``<|0.00|>`` ... (not special)."""
    from easevoice_trainer_tpu_torch.text.whisper_tokenizer import \
        bytes_to_unicode

    byte_chars = [bytes_to_unicode()[b] for b in range(256)]
    vocab = {c: i for i, c in enumerate(byte_chars)}
    merges = []
    for a in byte_chars:
        for b in byte_chars:
            if len(vocab) >= n_base:
                break
            vocab[a + b] = len(vocab)
            merges.append(f"{a} {b}")
    specials = (["<|endoftext|>", "<|startoftranscript|>"]
                + [f"<|{lang}|>" for lang in languages] + list(WHISPER_TASKS))
    added = [{"id": n_base + i, "content": tok, "special": True}
             for i, tok in enumerate(specials)]
    added += [{"id": n_base + len(specials) + i,
               "content": "<|%.2f|>" % (0.02 * i), "special": False}
              for i in range(n_timestamps)]
    for entry in added:
        entry.update(single_word=False, lstrip=False, rstrip=False,
                     normalized=False)
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": added, "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                              "trim_offsets": True, "use_regex": True},
            "post_processor": None,
            "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                        "trim_offsets": True, "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": "",
                      "end_of_word_suffix": "", "fuse_unk": False,
                      "byte_fallback": False, "vocab": vocab,
                      "merges": merges}}


def write_whisper_dir(torch, root: str, cfg, gen, tokenizer: dict,
                      weights: str = "model.safetensors"):
    """A Whisper directory as HF lays one out: ``config.json``, the
    tokenizer (``tokenizer.json``, ``tokenizer_config.json``) and seeded
    random weights under HF's ``model.``-prefixed names with the encoder's
    stored sinusoids (the LM head is tied, so not stored); the decoder's
    positions are 20 times larger than the other weights, so that greedy
    ids change from one position to the next.  Returns the port's state
    dict (on the CPU)."""
    from easevoice_trainer_tpu_torch import convert
    from easevoice_trainer_tpu_torch.audiokit import asr_whisper
    from easevoice_trainer_tpu_torch.utils import safetensors_io

    os.makedirs(root, exist_ok=True)
    eot = tokenizer["added_tokens"][0]["id"]
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"model_type": "whisper", "vocab_size": cfg.vocab_size,
                   "num_mel_bins": cfg.n_mels, "d_model": cfg.d_model,
                   "encoder_layers": cfg.encoder_layers,
                   "decoder_layers": cfg.decoder_layers,
                   "encoder_attention_heads": cfg.n_heads,
                   "decoder_attention_heads": cfg.n_heads,
                   "encoder_ffn_dim": cfg.ffn_dim,
                   "decoder_ffn_dim": cfg.ffn_dim,
                   "max_source_positions": cfg.max_source_positions,
                   "max_target_positions": cfg.max_target_positions,
                   "pad_token_id": eot, "bos_token_id": eot,
                   "eos_token_id": eot, "decoder_start_token_id": eot + 1},
                  f)
    with open(os.path.join(root, "tokenizer.json"), "w",
              encoding="utf8") as f:
        json.dump(tokenizer, f, ensure_ascii=False)
    with open(os.path.join(root, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "WhisperTokenizer",
                   "unk_token": "<|endoftext|>",
                   "bos_token": "<|endoftext|>",
                   "eos_token": "<|endoftext|>",
                   "clean_up_tokenization_spaces": False}, f)
    state = {k: v.cpu() for k, v in convert.random_state_dict(
        asr_whisper.Whisper(cfg), gen).items()}
    state["decoder.embed_positions.weight"] *= 20
    saved = {"model." + k: v for k, v in state.items()}
    saved["model.encoder.embed_positions.weight"] = torch.from_numpy(
        asr_whisper._sinusoids(cfg.max_source_positions, cfg.d_model))
    path = os.path.join(root, weights)
    if weights.endswith(".safetensors"):
        safetensors_io.save_file(saved, path, {"format": "pt"})
    else:
        torch.save(saved, path)
    return state


class _StageClock:
    """Host-clock seconds and calls of the ASR stages, by wrapping the
    functions that compute them (synchronized after each device stage)."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds, self.calls, self.restore = {}, {}, []

    def wrap(self, owner, attr: str, label: str, sync: bool = True,
             count=None):
        fn = getattr(owner, attr)
        self.seconds.setdefault(label, 0.0)
        self.calls.setdefault(label, 0)

        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                self.torch.cuda.synchronize()
            self.seconds[label] += time.perf_counter() - t
            self.calls[label] += count(out) if count else 1
            return out
        setattr(owner, attr, run)
        self.restore.append((owner, attr, fn))

    def undo(self):
        for owner, attr, fn in reversed(self.restore):
            setattr(owner, attr, fn)
        self.restore = []


def run_asr_cmd(params: dict, root: str, env: dict, name: str,
                module: str = "audio_asr"):
    """``python -m easevoice_trainer_tpu_torch.cmd.<module>`` (by default
    the ASR cmd) in a subprocess, as the session manager runs it:
    (response, wall s)."""
    from easevoice_trainer_tpu_torch.utils.connector import RESP_PREFIX

    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(params, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"easevoice_trainer_tpu_torch.cmd.{module}",
         "-c", path], cwd=HERE, env=env, capture_output=True, text=True,
        timeout=900)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(RESP_PREFIX + " ")]
    assert proc.returncode == 0 and len(lines) == 1, \
        (proc.returncode, proc.stdout[-2000:], proc.stderr[-3000:])
    return json.loads(lines[0][len(RESP_PREFIX) + 1:]), wall


def asr_text(out_dir: str) -> str:
    """``asrs/asr.list`` of ``out_dir`` as written: one ``path|lang|text``
    line a clip (Whisper's text from random weights may hold newlines)."""
    from easevoice_trainer_tpu_torch.utils import paths

    with open(os.path.join(out_dir, paths.ASRS_OUTPUT, paths.ASR_FILE),
              encoding="utf8") as f:
        return f.read()


def asr_chain(torch, tmp: str, work: str, denoised, results):
    """The ASR chain at full width over the denoised clips of ``work``:
    fsmn-VAD, Paraformer-large and CT-punc (zh) and whisper-small (en) with
    seeded random weights in the released layouts; the ASR cmd in a
    subprocess (zh, every clip), then in-process through the cmd's
    ``main`` with the launch counts and the stages' clocks (zh, every
    clip; en, two clips); the card against the CPU on the shortest clip."""
    import numpy as np

    from easevoice_trainer_tpu_torch import convert, ops
    from easevoice_trainer_tpu_torch.audiokit import asr_paraformer, \
        asr_whisper, punc_ct, vad_fsmn
    from easevoice_trainer_tpu_torch.cmd import audio_asr
    from easevoice_trainer_tpu_torch.utils import audio_io, paths

    root = os.path.join(tmp, "asr")
    gen = torch.Generator(device="cuda").manual_seed(20261117)
    para_cfg = asr_paraformer.ParaformerConfig()
    vad_cfg = vad_fsmn.FsmnVadConfig()
    punc_cfg = punc_ct.CTPuncConfig()
    t0 = time.perf_counter()
    chars = "".join(ZH_PINNED) + ZH_TEXT
    para_dir, vad_dir, punc_dir = write_asr_dirs(
        torch, os.path.join(root, "models"), gen, para_cfg, vad_cfg,
        punc_cfg, chars)
    whisper_cfg = asr_whisper.WhisperConfig(
        n_mels=80, d_model=768, encoder_layers=12, decoder_layers=12,
        n_heads=12, ffn_dim=3072, vocab_size=51865)
    tok = whisper_tokenizer_json(50257)
    assert len(tok["model"]["vocab"]) + len(tok["added_tokens"]) == \
        whisper_cfg.vocab_size
    whisper_dir = os.path.join(root, "models", "whisper-small")
    write_whisper_dir(torch, whisper_dir, whisper_cfg, gen, tok)
    write_s = time.perf_counter() - t0
    sizes = {os.path.basename(d): sum(
        os.path.getsize(os.path.join(d, n)) for n in os.listdir(d)) / 2 ** 20
        for d in (para_dir, vad_dir, punc_dir, whisper_dir)}
    log(f"[asr] model directories with seeded random weights at the "
        f"published widths (Paraformer-large {para_cfg.encoder_layers} + "
        f"{para_cfg.decoder_layers} layers at d {para_cfg.d_model}, vocab "
        f"{para_cfg.vocab_size}; fsmn-VAD {vad_cfg.input_dim} -> "
        f"{vad_cfg.output_dim}; CT-punc {punc_cfg.vocab_size} x "
        f"{punc_cfg.embed_unit}, {punc_cfg.num_blocks} layers, "
        f"{punc_cfg.n_heads} heads; whisper-small {whisper_cfg.encoder_layers}"
        f" + {whisper_cfg.decoder_layers} layers at d {whisper_cfg.d_model}, "
        f"vocab {whisper_cfg.vocab_size}), written in {write_s:.1f} s: "
        + ", ".join(f"{k} {v:.0f} MiB" for k, v in sizes.items()))

    # the zh chain: the cmd in a subprocess over every denoised clip
    zh_dir = os.path.join(root, "zh")
    os.makedirs(os.path.join(zh_dir, paths.DENOISES_OUTPUT))
    for name in denoised:
        shutil.copy(os.path.join(work, paths.DENOISES_OUTPUT, name),
                    os.path.join(zh_dir, paths.DENOISES_OUTPUT, name))
    seconds = {name: len(audio_io.load_audio(os.path.join(
        zh_dir, paths.DENOISES_OUTPUT, name), 16000)) / 16000
        for name in denoised}
    asr_env = {"EASEVOICE_PARAFORMER_DIR": para_dir,
               "EASEVOICE_VAD_DIR": vad_dir, "EASEVOICE_PUNC_DIR": punc_dir,
               "EASEVOICE_WHISPER_DIR": whisper_dir}
    env = dict(os.environ, PYTHONPATH=HERE, NVIDIA_TF32_OVERRIDE="0",
               **asr_env)
    params = {"source_dir": zh_dir, "output_dir": zh_dir, "language": "zh",
              "device": "cuda"}
    resp, sub_s = run_asr_cmd(params, root, env, "asr_zh")
    rows = asr_text(zh_dir).split("\n")
    log(f"[asr] cmd.audio_asr subprocess (zh: fsmn-VAD -> Paraformer -> "
        f"CT-punc): {resp['status']}, '{resp['message']}', {len(rows)} rows "
        f"for {len(denoised)} clips ({sum(seconds.values()):.1f} s of audio)"
        f" in {sub_s:.2f} s wall (the interpreter's start and three model "
        f"loads included); first row: {rows[0][-60:]!r}")
    assert resp["status"] == "success" and resp["message"] == "asr success"
    assert all(v == "success" for v in resp["data"].values()), resp
    assert len(resp["data"]) == len(denoised) == len(rows)
    with open(os.path.join(zh_dir, paths.REFINEMENTS_OUTPUT,
                           paths.REFINEMENT_FILE), encoding="utf8") as f:
        assert f.read().split("\n") == rows
    for row, name in zip(rows, denoised):
        path, lang, text = row.split("|", 2)
        assert path.endswith(name) and lang == "zh" and text, row

    # the same cmd in-process, counted and clocked by stage
    old_env = {k: os.environ.get(k) for k in asr_env}
    os.environ.update(asr_env)
    clock = _StageClock(torch)
    clock.wrap(asr_paraformer.ParaformerASR, "features", "fbank/LFR (host)",
               sync=False)
    clock.wrap(vad_fsmn.FsmnVAD, "speech_probs", "VAD")
    clock.wrap(asr_paraformer.Paraformer, "encode", "Paraformer encode")
    clock.wrap(asr_paraformer, "cif_fire", "CIF (host)", sync=False)
    clock.wrap(asr_paraformer.Paraformer, "decode", "Paraformer decode")
    clock.wrap(punc_ct.CTPunc, "restore", "punc")
    clock.wrap(punc_ct.CTPunc, "_logits", "punc calls")
    clock.wrap(asr_whisper.WhisperASR, "chunk_mels", "log-mel (host)",
               sync=False)
    clock.wrap(asr_whisper.WhisperEncoder, "forward", "Whisper encode")
    clock.wrap(asr_whisper.Whisper, "greedy", "Whisper greedy",
               count=len)
    runs = {}
    try:
        for lang, names in (("zh", denoised),
                            ("en", sorted(denoised, key=seconds.get)[:2])):
            out = os.path.join(root, f"{lang}_in_process")
            os.makedirs(os.path.join(out, paths.DENOISES_OUTPUT))
            for name in names:
                shutil.copy(os.path.join(work, paths.DENOISES_OUTPUT, name),
                            os.path.join(out, paths.DENOISES_OUTPUT, name))
            before = dict(clock.seconds), dict(clock.calls)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t = time.perf_counter()
            resp = audio_asr.main(dict(params, source_dir=out,
                                       output_dir=out, language=lang))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = ops.launch_counts()
            assert resp.ok and resp.message == "asr success", resp
            assert all(v == "success" for v in resp.data.values()), resp
            runs[lang] = dict(
                wall=wall, launches=launches, text=asr_text(out),
                paths=[os.path.join(out, paths.DENOISES_OUTPUT, n)
                       for n in names],
                audio=sum(seconds[n] for n in names), clips=len(names),
                seconds={k: v - before[0][k]
                         for k, v in clock.seconds.items()},
                calls={k: v - before[1][k] for k, v in clock.calls.items()})
    finally:
        clock.undo()
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    zh, en = runs["zh"], runs["en"]
    assert [r.split("|", 2)[2] for r in zh["text"].split("\n")] == \
        [r.split("|", 2)[2] for r in rows], "in-process zh text differs"
    punc_calls = zh["calls"]["punc calls"]
    chunks = en["calls"]["Whisper encode"]
    k32, k64 = (zh["launches"]["encoder_attention_dk32"],
                en["launches"]["encoder_attention"])
    log(f"[asr] in-process cmd.audio_asr.main: zh {zh['clips']} clips in "
        f"{zh['wall']:.2f} s ({punc_calls} punctuation calls, K1 dk-32 "
        f"launches {k32}, dk-64 {zh['launches']['encoder_attention']}); en "
        f"{en['clips']} clips ({en['audio']:.2f} s) in {en['wall']:.2f} s "
        f"({chunks} Whisper chunks, {en['calls']['Whisper greedy']} tokens "
        f"generated, K1 dk-64 launches {k64}, dk-32 "
        f"{en['launches']['encoder_attention_dk32']}); each wall includes "
        f"the model loads; en asr.list ends {en['text'][-60:]!r}")
    assert k32 == punc_cfg.num_blocks * punc_calls and punc_calls > 0
    assert zh["launches"]["encoder_attention"] == 0
    assert k64 == whisper_cfg.encoder_layers * chunks and chunks == 2
    assert en["launches"]["encoder_attention_dk32"] == 0
    assert en["text"].startswith(en["paths"][0] + "|en|")
    assert "\n" + en["paths"][1] + "|en|" in en["text"]
    for key, n, label in (("encoder_attention_dk32", k32, "asr_zh"),
                          ("encoder_attention", k64, "asr_whisper")):
        r = results.setdefault(key, {})
        r["launches"] = r.get("launches", 0) + n
        r.setdefault("per_path", {})[label] = n
    for lang, run in runs.items():
        minutes = run["audio"] / 60
        stages = {k: v for k, v in run["seconds"].items()
                  if run["calls"][k] and k not in ("punc calls",
                                                   "Whisper greedy")}
        if lang == "en":
            tokens = run["calls"]["Whisper greedy"]
            decode = run["seconds"]["Whisper greedy"] - \
                run["seconds"]["Whisper encode"]
            stages["Whisper decode"] = decode
            per_token = f"; Whisper decode {1000 * decode / tokens:.2f} " \
                f"ms a token over {tokens} tokens"
        else:
            per_token = ""
        log(f"[asr] {lang} stages, seconds a minute of audio (host clock, "
            f"synchronized; {run['audio']:.2f} s of audio): "
            + ", ".join(f"{k} {v / minutes:.4f} ({v:.3f} s, "
                        f"{run['calls'][k] if k in run['calls'] else '-'} "
                        f"calls)" for k, v in stages.items()) + per_token)

    # the card against the CPU on the shortest clip
    name = min(denoised, key=seconds.get)
    wav = audio_io.load_audio(os.path.join(work, paths.DENOISES_OUTPUT,
                                           name), 16000)
    out = {}
    for dev in ("cuda", "cpu"):
        vad = vad_fsmn.FsmnVAD(vad_dir, dev)
        asr = asr_paraformer.ParaformerASR(para_dir, dev)
        segs = vad.segments(wav)
        s, e = segs[0]
        res = asr._infer(asr.features(wav[s:e]))
        text = asr_paraformer.tokens_to_text(res.ids, asr.tokens)
        punc = punc_ct.CTPunc(punc_dir, dev)
        words = punc_ct.code_mix_split_words(text)
        marks = punc._predict_puncs(words)
        out[dev] = dict(segs=segs, enc=res.enc.cpu(), alphas=res.alphas.cpu(),
                        logits=res.logits.cpu(), ids=res.ids, marks=marks)
        del vad, asr, punc
    card, cpu = out["cuda"], out["cpu"]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa
    enc_rel, alpha_rel = rel(card["enc"], cpu["enc"]), \
        rel(card["alphas"], cpu["alphas"])
    assert card["segs"] == cpu["segs"], (card["segs"], cpu["segs"])
    assert len(card["ids"]) == len(cpu["ids"])
    gaps = []
    for i, (a, b) in enumerate(zip(card["ids"], cpu["ids"])):
        if a != b:
            top = torch.topk(cpu["logits"][0, i], 2).values
            gaps.append(float((top[0] - top[1]) / top[0].abs()))
    log(f"[asr] card vs CPU on {name} ({len(wav) / 16000:.2f} s): VAD "
        f"segments identical {card['segs']}; Paraformer encoder output "
        f"relative max|d|={enc_rel:.3g}, alphas {alpha_rel:.3g} (tol 1e-4); "
        f"token ids identical {len(card['ids']) - len(gaps)}/"
        f"{len(card['ids'])}" + (f" (top-2 gaps of the rest {gaps})" if gaps
                                 else "")
        + f"; CT-punc marks identical {card['marks'] == cpu['marks']} over "
        f"{len(card['marks'])} words")
    assert enc_rel <= 1e-4 and alpha_rel <= 1e-4
    assert all(g < 1e-4 for g in gaps), gaps
    assert card["marks"] == cpu["marks"]

    # Whisper at full width and 2 + 2 layers, the card against the CPU
    small = dataclasses.replace(whisper_cfg, encoder_layers=2,
                                decoder_layers=2)
    model = asr_whisper.Whisper(small)
    model.load_state_dict(convert.random_state_dict(model, gen))
    mel = asr_whisper.log_mel_spectrogram(np.pad(
        wav, (0, asr_whisper.CHUNK_SAMPLES - len(wav))), 80)[None]
    forced = [tok["added_tokens"][1]["id"],
              tok["added_tokens"][2]["id"]]        # <|startoftranscript|>, en
    eot = tok["added_tokens"][0]["id"]
    got = []                                # the card's, then the CPU's
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        x = torch.from_numpy(mel).to(dev)
        ids = m.greedy(x, forced, eot, 16)
        with torch.no_grad():
            state = m.decoder.start(m.encoder(x))
            seq = torch.tensor([forced + ids[:-1]], device=dev)
            got.append((ids, m.decoder(seq, 0, state).cpu()))
    wrel = rel(got[0][1], got[1][1])
    log(f"[asr] whisper-small widths at {small.encoder_layers} + "
        f"{small.decoder_layers} layers, card vs CPU on the same clip: "
        f"greedy ids identical {got[0][0] == got[1][0]} ({len(got[0][0])} "
        f"tokens), teacher-forced logits relative max|d|={wrel:.3g} (tol "
        f"1e-4)")
    assert got[0][0] == got[1][0] and wrel <= 1e-4
    del model
    log("[asr] the refinement list that normalize reads below keeps its "
        "ZH_PINNED rows: with random weights the ASR text means nothing")


# ---------------------------------------------------------------------------
# phase 8: the s2 fine-tune at full width
# ---------------------------------------------------------------------------

PHONES = "HH AH0 L OW1 W ER1 L D SP K AE1 T S .".split()


def write_normalize_dir(root: str, clips: int, frames: int, seed: int):
    """A synthetic normalize output: 2-name2text.txt, 4-cnhubert/*.npy
    (frames x 768) and 5-wav32k/*.wav (frames x 640 samples)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "4-cnhubert"))
    os.makedirs(os.path.join(root, "5-wav32k"))
    lines = []
    for i in range(clips):
        name = f"clip{i}.wav"
        write_reference_wav(os.path.join(root, "5-wav32k", name),
                            frames * 640 / 32000, seed + i)
        np.save(os.path.join(root, "4-cnhubert", name + ".npy"),
                rng.normal(size=(frames, 768)).astype(np.float32))
        lines.append(f"{name}\t{' '.join(PHONES * 3)}\t1\ttext")
    with open(os.path.join(root, "2-name2text.txt"), "w",
              encoding="utf8") as f:
        f.write("\n".join(lines))


def _is_half(value):
    """Context: the env var ``is_half`` set to ``value`` (None: unset, the
    default True) while a trainer is built."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        old = os.environ.get("is_half")
        if value is None:
            os.environ.pop("is_half", None)
        else:
            os.environ["is_half"] = value
        try:
            yield
        finally:
            if old is None:
                os.environ.pop("is_half", None)
            else:
                os.environ["is_half"] = old
    return ctx()


# the fine-tune runs of phases 9 and 11: the default (is_half, bf16) and
# is_half=False (fp32, the port before bf16)
TRAIN_RUNS = (("bf16", None), ("fp32", "False"))
MRF_KERNELS = ("mrf_conv", "mrf_conv_bwd_data", "mrf_conv_bwd_weight")
S1_KERNELS = ("prefill_attention", "prefill_attention_bwd")


def train(torch, tmp: str, results):
    """SovitsTrain.train() at full width: SovitsConfig() and the full MPD
    from seeded random pretrained .pth files, 8 clips of 256 frames
    replicated to 96 items, batch 8, one epoch = 12 steps; run with is_half
    at its default (bf16 compute, the ResBlocks on the bf16 instances of K3
    and K4) and with is_half=False (fp32, the fp32 instances), each from the
    same pretrained files.  The bf16 run's trainer is then profiled."""
    import numpy as np

    from easevoice_trainer_tpu_torch import ops
    from easevoice_trainer_tpu_torch.models.sovits import \
        MultiPeriodDiscriminator, SovitsConfig, SynthesizerTrn
    from easevoice_trainer_tpu_torch.train.sovits import SovitsTrain, \
        SovitsTrainParams

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(20261017)
    s2g = os.path.join(tmp, "s2G_random.pth")
    s2d = os.path.join(tmp, "s2D_random.pth")
    pre_g = random_weights(torch, SynthesizerTrn(with_enc_q=True), gen, s2g)
    random_weights(torch, MultiPeriodDiscriminator(), gen, s2d)
    norm = os.path.join(tmp, "norm")
    write_normalize_dir(norm, clips=8, frames=256, seed=3)
    log(f"[training] random s2G/s2D .pth and a normalize dir of 8 clips "
        f"written in {time.perf_counter() - t0:.1f} s")

    runs = {}
    for tag, is_half in TRAIN_RUNS:
        with _is_half(is_half):
            trainer = SovitsTrain(SovitsTrainParams(
                batch_size=8, total_epochs=1, save_every_epoch=1,
                pretrained_s2G=s2g, pretrained_s2D=s2d, train_input_dir=norm,
                output_model_name=f"chip_smoke_{tag}",
                project_dir=os.path.join(tmp, f"project_{tag}")))
        assert trainer.device.type == "cuda"
        want_dtype = torch.bfloat16 if tag == "bf16" else None
        assert trainer.compute_dtype == want_dtype, trainer.compute_dtype
        history = []
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        resp = trainer.train(on_step=lambda step, m: history.append(
            {k: float(v) for k, v in m.items()}))
        wall = time.perf_counter() - t1
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        assert resp.ok, resp.message
        secs = trainer.step_seconds
        assert len(history) == len(secs) == 12, (len(history), len(secs))
        for i, m in enumerate(history):
            bad = {k: v for k, v in m.items() if not math.isfinite(v)}
            assert not bad, f"{tag} step {i + 1}: non-finite {bad}"
        # the run went through its instances and the other precision's not
        for name in MRF_KERNELS:
            mine, other = (f"{name}_bf16", name) if tag == "bf16" \
                else (name, f"{name}_bf16")
            assert launches[mine] > 0, f"{mine} never launched ({tag})"
            assert launches[other] == 0, f"{other} launched ({tag})"
            r = results[mine]
            r["launches"] = r.get("launches", 0) + launches[mine]
            r.setdefault("per_path", {"serving_clone": 0})["s2_step"] = \
                launches[mine] / len(secs)
        steady = float(np.median(secs[2:12]))
        runs[tag] = dict(trainer=trainer, history=history, secs=secs,
                         peak=peak, steady=steady, resp=resp)
        log(f"[training] {tag} (is_half={is_half or 'default'}): "
            f"SovitsTrain.train(): 12 steps of B=8 x 20480 samples in "
            f"{wall:.2f} s wall (data, models and pretrained load "
            f"included); first step {secs[0]:.3f} s, median s/step over "
            f"steps 3-12 {steady:.4f} s (min {min(secs[2:]):.4f}, max "
            f"{max(secs[2:]):.4f}); peak memory {peak / 2 ** 30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated); launches {launches}")
        log(f"[training] {tag} losses, steps 1-12 (loss/g/total; "
            f"loss/d/total): " + ", ".join(
                f"{m['loss/g/total']:.3f}; {m['loss/d/total']:.3f}"
                for m in history))
        if tag != "bf16":
            del trainer
            runs[tag].pop("trainer")
            gc.collect()
            torch.cuda.empty_cache()
    bf, fp = runs["bf16"], runs["fp32"]
    log(f"[training] bf16 against fp32: median s/step {bf['steady']:.4f} vs "
        f"{fp['steady']:.4f} ({fp['steady'] / bf['steady']:.2f}x), first "
        f"step {bf['secs'][0]:.3f} vs {fp['secs'][0]:.3f} s, peak "
        f"{bf['peak'] / 2 ** 30:.2f} vs {fp['peak'] / 2 ** 30:.2f} GiB; "
        f"loss/g/total at step 12 {bf['history'][-1]['loss/g/total']:.3f} "
        f"vs {fp['history'][-1]['loss/g/total']:.3f}; largest |bf16 - fp32| "
        f"/ |fp32| of loss/g/total and loss/d/total over the "
        f"{len(fp['history'])} steps "
        + "{:.3%}".format(max(abs(a[key] - c[key]) / abs(c[key])
                              for a, c in zip(bf['history'], fp['history'])
                              for key in ("loss/g/total", "loss/d/total"))))

    trainer, resp = bf["trainer"], bf["resp"]
    step_fn = trainer.step_fn
    for name, net in (("G", step_fn.net_g), ("D", step_fn.net_d)):
        for pname, p in list(net.named_parameters()) + list(
                net.named_buffers()):
            assert p.device.type == "cuda", f"{name}.{pname} on {p.device}"
            # parameters stay fp32 under bf16 compute
            assert not p.is_floating_point() or p.dtype == torch.float32, \
                f"{name}.{pname} is {p.dtype}"
    for opt in (step_fn.optim_g, step_fn.optim_d):
        for st in opt.state.values():
            assert all(t.device.type == "cuda" for t in st.values())

    # the Generator's ResBlocks and upsamples moved (gradients reached them
    # through K4's bf16 instances)
    trained = torch.load(os.path.join(trainer.train_logs_dir,
                                      "G_latest.pth"), map_location="cpu",
                         weights_only=False)["model"]
    checked = [k for k in pre_g if (k.startswith("dec.resblocks.")
                                    and k.endswith("weight_v"))
               or k.startswith("dec.ups.")]
    same = [k for k in checked if torch.equal(trained[k], pre_g[k])]
    assert checked and not same, f"unchanged after training: {same[:5]}"

    # the export loads strictly into the inference build and decodes
    obj = torch.load(resp.data["model_path"], map_location="cpu",
                     weights_only=False)
    assert set(obj) >= {"weight", "config", "info"}
    assert not any(k.startswith("enc_q.") for k in obj["weight"])
    model = SynthesizerTrn(SovitsConfig())
    model.load_state_dict({k: v.float() for k, v in obj["weight"].items()},
                          strict=True)
    model = model.cuda().eval()
    g2 = torch.Generator(device="cuda").manual_seed(9)
    with torch.no_grad():
        wav = model.decode(
            torch.randint(0, 1024, (1, 40), generator=g2, device="cuda"),
            torch.randint(1, 700, (1, 12), generator=g2, device="cuda"),
            torch.tensor([12], device="cuda"),
            torch.rand((1, 150, 1025), generator=g2, device="cuda"),
            torch.tensor([150], device="cuda"))
    assert wav.shape == (1, 40 * 2 * 640, 1)
    assert torch.isfinite(wav).all() and float(wav.abs().max()) > 0
    log(f"[training] bf16 run: {len(checked)} dec.resblocks.*.weight_v / "
        f"dec.ups.* tensors all changed, every parameter fp32; export "
        f"{os.path.basename(resp.data['model_path'])} loads strict=True and "
        f"decodes a finite wav (|wav| max {float(wav.abs().max()):.3f})")
    profile_train_step(torch, trainer, norm)


def profile_train_step(torch, trainer, norm: str) -> None:
    """One more step of the trained S2TrainStep on a batch of the run's data,
    under torch.profiler: the step's device time and the MRF kernels' part
    of it (K3 and K4-dx share conv_mma_kernel, and in bf16
    conv_bf16_kernel, told apart by the BWD template argument; K4-dW is
    wgrad_wgmma_kernel / wgrad_mma_kernel, in bf16 wgrad_wgmma_bf16_kernel
    / wgrad_mma_kernel), with the K4-dW group's ms a step on a line of its
    own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from easevoice_trainer_tpu_torch.train import data as data_mod

    cfg = trainer.mel_cfg
    dataset = data_mod.S2Dataset(norm, hop_length=cfg.hop_length,
                                 sampling_rate=cfg.sampling_rate,
                                 n_fft=cfg.n_fft, win_length=cfg.win_length)
    batcher = data_mod.BucketBatcher(dataset.lengths, trainer.batch_size,
                                     seed=trainer.seed)
    bucket, idxs = batcher.epoch_batches(1)[0]
    text_cap = -(-max(len(e.phoneme_ids) for e in dataset.examples) // 16) \
        * 16  # as SovitsTrain.train pads it
    batch = trainer._to_device(data_mod.collate_s2(
        [dataset.load_item(i) for i in idxs], batcher.padded_frames(bucket),
        text_cap, hop=cfg.hop_length))
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer.step_fn(batch, gen)  # warm-up on this batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.step_fn(batch, gen)
        torch.cuda.synchronize()
    groups = {"K3": 0.0, "K4-dx": 0.0, "K4-dW": 0.0, "other": 0.0}
    others = {}
    launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        launches += 1
        us = e.time_range.elapsed_us()
        if "conv_mma_kernel" in e.name or "conv_bf16_kernel" in e.name:
            groups["K4-dx" if "true" in e.name else "K3"] += us
        elif re.search(r"wgrad_(wgmma|wgmma_bf16|mma)_kernel", e.name):
            groups["K4-dW"] += us  # not cuDNN's own *wgrad_* kernels
        else:
            groups["other"] += us
            n_us = others.setdefault(e.name[:70], [0, 0.0])
            n_us[0] += 1
            n_us[1] += us
    if not launches:
        log("[training] torch.profiler recorded no CUDA activity for the "
            "profiled step: no breakdown this run")
        return
    total = sum(groups.values())
    log(f"[training] one more step under torch.profiler: device time "
        f"{total / 1000:.2f} ms in {launches} kernels and copies; "
        + ", ".join(f"{k} {v / 1000:.2f} ms" for k, v in groups.items()))
    log(f"[training] the profiled step's K4-dW group: "
        f"{groups['K4-dW'] / 1000:.3f} ms a step")
    top = sorted(others.items(), key=lambda kv: -kv[1][1])[:6]
    log("[training] the step's largest other kernels (launches, ms): "
        + "; ".join(f"{n} ({c}, {us / 1000:.2f})" for n, (c, us) in top))


# ---------------------------------------------------------------------------
# phase 9: one train step on the card against the CPU
# ---------------------------------------------------------------------------

TINY_SOVITS = dict(
    spec_channels=1025, segment_size=2560, inter_channels=32,
    hidden_channels=32, filter_channels=64, n_heads=2, n_layers=2,
    upsample_initial_channel=32, gin_channels=32, ssl_dim=64,
    n_symbols=732, p_dropout=0.0)


def reference_train_step(torch):
    """One S2TrainStep at a small Generator width (the full MPD) on the card
    and on the CPU (plain twins) from the same weights and batch, with the
    slice starts and posterior noise given and dropout off, in fp32 and in
    bf16 (both models with dtype bfloat16: the card's bf16 instances
    against the CPU's bf16 twins).  fp32: losses within 1e-4 x max(1,
    |CPU|), every dec.resblocks.* gradient within 1e-3 x its largest CPU
    magnitude + 1e-6 x the largest Generator gradient (the rounding floor of
    gradients that are zero in exact arithmetic).  bf16: cuDNN and the CPU
    sum in other orders, so bf16 roundings flip (one step is 2^-8 of a
    value) and the flips travel through the step.  A tensor's own maximum
    is no bf16 measure there: a bias's or weight_g's gradient is a sum that
    cancels, and the flips move it by its own size (bf16 against fp32 on
    the CPU: up to 2.1x per tensor, 2.0 % over all of them).  So: losses
    within 1e-2 x max(1, |CPU|), and the dec.resblocks.* gradients, taken
    together, within 5e-2 of the CPU's in L2 norm."""
    from easevoice_trainer_tpu_torch import convert
    from easevoice_trainer_tpu_torch.models.sovits import \
        MultiPeriodDiscriminator, SovitsConfig, SynthesizerTrn
    from easevoice_trainer_tpu_torch.ops.stft import MelConfig, spectrogram
    from easevoice_trainer_tpu_torch.train.sovits_step import S2TrainHP, \
        S2TrainStep

    cfg = SovitsConfig(**TINY_SOVITS)
    gen = torch.Generator().manual_seed(11)
    b, frames = 2, 16
    wav = torch.rand((b, frames * 640), generator=gen) - 0.5
    batch = {"ssl": torch.randn((b, frames, 64), generator=gen),
             "spec": spectrogram(wav), "spec_lengths": torch.tensor([16, 13]),
             "wav": wav,
             "text": torch.randint(1, 700, (b, 8), generator=gen),
             "text_lengths": torch.tensor([8, 5])}
    ids = torch.tensor([5, 2])
    eps = torch.randn((b, frames, 32), generator=gen)
    for dtype, tol_loss, tol_grad in ((None, 1e-4, 1e-3),
                                      (torch.bfloat16, 1e-2, 5e-2)):
        runs = {}
        for dev in ("cuda", "cpu"):
            net_g = SynthesizerTrn(cfg, with_enc_q=True, dtype=dtype)
            net_d = MultiPeriodDiscriminator(dtype=dtype)
            for net, seed in ((net_g, 1), (net_d, 2)):
                net.load_state_dict(convert.random_state_dict(
                    net, torch.Generator().manual_seed(seed)))
                net.to(dev)
            step = S2TrainStep(net_g, net_d, S2TrainHP(
                segment_size=2560, learning_rate=2e-4), MelConfig(),
                steps_per_epoch=1)
            metrics = step({k: v.to(dev) for k, v in batch.items()},
                           ids_slice=ids.to(dev), eps=eps.to(dev))
            grads = {k: p.grad.cpu() for k, p in net_g.named_parameters()
                     if p.grad is not None}
            runs[dev] = ({k: float(v) for k, v in metrics.items()}, grads)
        (m_gpu, g_gpu), (m_cpu, g_cpu) = runs["cuda"], runs["cpu"]
        worst_loss = max(abs(m_gpu[k] - v) / max(1.0, abs(v))
                         for k, v in m_cpu.items() if k.startswith("loss/"))
        floor = 1e-6 * max(float(g.abs().max()) for g in g_cpu.values())
        keys = [k for k in g_cpu if k.startswith("dec.resblocks.")]
        names = len(keys)
        if dtype is None:   # each tensor against its own largest magnitude
            worst_grad = max(float((g_gpu[k] - g_cpu[k]).abs().max())
                             / (float(g_cpu[k].abs().max()) + floor)
                             for k in keys)
            measure = "max|d| / (max|CPU| + floor), worst tensor"
        else:               # all of them together, in L2 norm
            got = torch.cat([g_gpu[k].flatten() for k in keys])
            want = torch.cat([g_cpu[k].flatten() for k in keys])
            worst_grad = float((got - want).norm() / want.norm())
            measure = "|d| / |CPU| over all of them (L2)"
        label = "bf16" if dtype is not None else "fp32"
        log(f"[reference] S2TrainStep {label} card vs CPU (G at width 32, "
            f"full MPD, B=2, 2560 samples): losses relative "
            f"max|d|={worst_loss:.3g} (tol {tol_loss}); {names} "
            f"dec.resblocks.* gradients {measure} = {worst_grad:.3g} (tol "
            f"{tol_grad}); loss/g/total {m_gpu['loss/g/total']:.4f} vs "
            f"{m_cpu['loss/g/total']:.4f}")
        assert worst_loss <= tol_loss and worst_grad <= tol_grad \
            and names == 15 * 6 * 3, label


# ---------------------------------------------------------------------------
# phase 10: the s1 fine-tune at full width
# ---------------------------------------------------------------------------


def write_s1_dir(root: str, seed: int) -> None:
    """A synthetic s1 normalize output at 8 phonemes a second (25 semantic
    tokens a second): 2-name2text.txt and 6-name2semantic.tsv, no 3-bert;
    4 utterances of 250 tokens (10 s, 80 phonemes) and 4 of 1300 (52 s,
    416 phonemes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(root)
    text, sem = [], ["item_name\tsemantic_audio"]
    for i, n_sem in enumerate((250, 1300) * 4):
        name = f"utt{i}.wav"
        phones = (PHONES * 40)[:n_sem * 8 // 25]
        text.append(f"{name}\t{' '.join(phones)}\t1\ttext")
        sem.append(f"{name}\t"
                   + " ".join(map(str, rng.integers(0, 1024, n_sem))))
    for name, lines in (("2-name2text.txt", text),
                        ("6-name2semantic.tsv", sem)):
        with open(os.path.join(root, name), "w", encoding="utf8") as f:
            f.write("\n".join(lines))


def train_s1(torch, tmp: str, results):
    """GPTTrain.train() at full width: T2SConfig from the repo's
    configs/gpt.yaml (through the port's own YAML reader), a seeded random
    pretrained .ckpt in the export format, 8 utterances replicated to 96
    items: 12 micro-batches of B=8 at T = 716 and 1776, 3 ScaledAdam
    updates; run with is_half at its default (bf16 compute, K1 / K5's bf16
    instances) and with is_half=False (fp32).  Returns the bf16 run's
    trainer."""
    import numpy as np

    from easevoice_trainer_tpu_torch import convert, ops
    from easevoice_trainer_tpu_torch.models.gpt import DecodeParams, \
        T2SConfig, Text2SemanticDecoder, decode_ar
    from easevoice_trainer_tpu_torch.train import ckpt
    from easevoice_trainer_tpu_torch.train.gpt import GPTTrain, \
        GPTTrainParams, gpt_export_tree
    from easevoice_trainer_tpu_torch.utils import paths, simple_yaml

    t0 = time.perf_counter()
    cfg_yaml = simple_yaml.load(paths.gpt_config_path())
    cfg = T2SConfig.from_yaml_dict(cfg_yaml)
    gen = torch.Generator(device="cuda").manual_seed(20261018)
    init = Text2SemanticDecoder(cfg)
    init.load_state_dict({k: v.cpu() for k, v in convert.random_state_dict(
        init, gen).items()})
    pretrained = os.path.join(tmp, "s1_random.ckpt")
    ckpt.export_gpt_weights(gpt_export_tree(init.state_dict()), pretrained,
                            config=cfg_yaml, info="random")
    pre = convert.load_torch_state_dict(pretrained)   # fp16, as saved
    del init
    data = os.path.join(tmp, "s1_data")
    write_s1_dir(data, seed=7)
    assert (cfg.n_layers, cfg.hidden_dim, cfg.n_heads) == (24, 512, 16)
    log(f"[s1 training] configs/gpt.yaml read: {cfg}; random pretrained "
        f".ckpt and 8 utterances written in "
        f"{time.perf_counter() - t0:.1f} s")

    layers = cfg.n_layers
    k5_per_call = ops.prefill_attention_bwd.launches_per_call
    runs = {}
    for tag, is_half in TRAIN_RUNS:
        with _is_half(is_half):
            trainer = GPTTrain(GPTTrainParams(
                batch_size=S1_B, total_epochs=1, save_every_epoch=1,
                model_path=pretrained, train_input_dir=data,
                output_model_name=f"chip_smoke_s1_{tag}",
                project_dir=os.path.join(tmp, f"s1_project_{tag}")))
        assert trainer.device.type == "cuda"
        want_dtype = torch.bfloat16 if tag == "bf16" else None
        assert trainer.compute_dtype == want_dtype, trainer.compute_dtype
        history = []
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        resp = trainer.train(on_step=lambda step, m: history.append(
            {k: float(v) for k, v in m.items()}))
        wall = time.perf_counter() - t1
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        assert resp.ok, resp.message
        secs, tokens = trainer.step_seconds, trainer.step_tokens
        n = len(secs)
        assert n == len(history) == 12, (n, len(history))
        assert sorted(set(tokens)) == list(S1_Y_LENS), tokens
        for i, m in enumerate(history):
            bad = {k: v for k, v in m.items() if not math.isfinite(v)}
            assert not bad, f"{tag} micro-batch {i + 1}: non-finite {bad}"
        sfx, other = ("_bf16", "") if tag == "bf16" else ("", "_bf16")
        assert launches["prefill_attention" + sfx] == layers * n, launches
        assert launches["prefill_attention_bwd" + sfx] == \
            k5_per_call * layers * n, launches
        for name in S1_KERNELS:
            assert launches[name + other] == 0, (name + other, launches)
        for name in results:
            if name.endswith("_bf16") != (tag == "bf16"):
                continue
            per_path = results[name].setdefault("per_path", {})
            for path in ("serving_clone", "s2_step"):
                per_path.setdefault(path, 0)
            per_path["s1_micro_batch"] = launches[name] / n
            results[name]["launches"] = results[name].get("launches", 0) \
                + launches[name]
        by_bucket = {}
        for i in range(2, n):
            by_bucket.setdefault(tokens[i], []).append(secs[i])
        medians = {t: float(np.median(v)) for t, v in by_bucket.items()}
        runs[tag] = dict(trainer=trainer, history=history, secs=secs,
                         peak=peak, medians=medians, resp=resp,
                         tokens=tokens)
        log(f"[s1 training] {tag} (is_half={is_half or 'default'}): "
            f"GPTTrain.train(): {n} micro-batches of B={S1_B} "
            f"({n // 4} ScaledAdam updates) in {wall:.2f} s wall (data, "
            f"model and pretrained load included); first micro-batch "
            f"{secs[0]:.3f} s (T={S1_X_LEN + tokens[0]}); median "
            f"s/micro-batch over micro-batches 3-{n} by bucket: " + ", ".join(
                f"T={S1_X_LEN + t} {medians[t]:.4f} s ({len(v)})"
                for t, v in sorted(by_bucket.items()))
            + f"; peak memory {peak / 2 ** 30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated); launches {launches}")
        log(f"[s1 training] {tag} micro-batch losses " + ", ".join(
            f"{m['loss']:.1f}" for m in history) + "; grad norms "
            + ", ".join(f"{m['grad_norm']:.3g}" for m in history))
        if tag != "bf16":
            del trainer
            runs[tag].pop("trainer")
            gc.collect()
            torch.cuda.empty_cache()
    k5 = results["prefill_attention_bwd"]
    k5["launches_per_call"] = k5_per_call
    k5["calls"] = k5["launches"] // k5_per_call
    bf, fp = runs["bf16"], runs["fp32"]
    log("[s1 training] bf16 against fp32: median s/micro-batch " + ", ".join(
        f"T={S1_X_LEN + t} {bf['medians'][t]:.4f} vs {fp['medians'][t]:.4f} "
        f"({fp['medians'][t] / bf['medians'][t]:.2f}x)"
        for t in sorted(bf["medians"]))
        + f"; first micro-batch {bf['secs'][0]:.3f} vs {fp['secs'][0]:.3f} "
        f"s; peak {bf['peak'] / 2 ** 30:.2f} vs {fp['peak'] / 2 ** 30:.2f} "
        f"GiB; loss at micro-batch 12 {bf['history'][-1]['loss']:.1f} vs "
        f"{fp['history'][-1]['loss']:.1f}; largest |bf16 - fp32| / |fp32| of "
        f"the losses over the {len(fp['history'])} micro-batches "
        + "{:.3%}".format(max(abs(a['loss'] - c['loss']) / abs(c['loss'])
                              for a, c in zip(bf['history'], fp['history']))))

    trainer, resp = bf["trainer"], bf["resp"]
    step_fn = trainer.step_fn
    model = step_fn.model
    for pname, p in list(model.named_parameters()) + list(
            model.named_buffers()):
        assert p.device.type == "cuda", f"{pname} on {p.device}"
        assert p.dtype == torch.float32, f"{pname} is {p.dtype}"
    for st in step_fn.optimizer.state.values():
        assert all(t.device.type == "cuda" for t in st.values())
    group = step_fn.optimizer.param_groups[0]
    n = len(bf["secs"])
    assert group["step"] == n // 4 and group["norm_buffer"].is_cuda
    # fault 1: every layer's qkv projection moved, so attention passed a
    # gradient back to it
    trained = model.state_dict()
    names = [f"h.layers.{i}.self_attn.in_proj_weight" for i in range(layers)]
    same = [k for k in names
            if torch.equal(trained[k].cpu(), pre[k].float())]
    assert not same, f"unchanged after training: {same}"

    # the export loads strictly into the inference build and decodes
    obj = torch.load(resp.data["model_path"], map_location="cpu",
                     weights_only=False)
    assert set(obj) >= {"weight", "config", "info"}
    served = Text2SemanticDecoder(cfg)
    served.load_state_dict(convert.load_torch_state_dict(
        resp.data["model_path"]), strict=True)
    served = served.cuda().eval()
    g2 = torch.Generator(device="cuda").manual_seed(3)
    tok, lens = decode_ar(
        served, torch.randint(1, 700, (2, 32), generator=g2, device="cuda"),
        torch.tensor([32, 20], dtype=torch.int32, device="cuda"),
        torch.randint(0, 1024, (2, 50), generator=g2, device="cuda"),
        torch.zeros((2, 32, 1024), device="cuda"),
        DecodeParams(top_k=1, max_new_tokens=8, min_tokens=8),
        torch.Generator(device="cuda").manual_seed(0))
    assert tok.shape[0] == 2 and int(lens.min()) > 0
    log(f"[s1 training] bf16 run: all {layers} in_proj_weight tensors "
        f"changed, every parameter fp32; export "
        f"{os.path.basename(resp.data['model_path'])} loads strict=True and "
        f"greedy-decodes 8 tokens a row")
    return trainer


def train_s1_dropout(torch, tmp: str, results, parent=None) -> None:
    """GPTTrain.train() at full width with ``model.dropout: 0.1`` (the
    repo's configs/gpt.yaml with that key changed, under a base path of its
    own) for one accumulation window: train_s1's pretrained .ckpt and data
    at B=24 (4 micro-batches at T = 716 and 1776, one ScaledAdam update),
    with is_half at its default (bf16) and with is_half=False (fp32).
    Finite losses; a micro-batch launches K1's dropout instance 24 times
    and K5's 24 times (72 launches), of the run's dtype, and no instance
    without dropout; the counts go to the dropout instances' entries.  s a
    micro-batch and the run's torch.cuda.max_memory_allocated are logged;
    with ``parent`` (the parent's package) its fp32 window runs first on
    the same data, its s a micro-batch and peak beside this tree's."""
    from easevoice_trainer_tpu_torch import ops
    from easevoice_trainer_tpu_torch.train import gpt as gpt_train
    from easevoice_trainer_tpu_torch.utils import paths

    base = os.path.join(tmp, "s1_dropout_base")
    os.makedirs(os.path.join(base, "configs"))
    with open(paths.gpt_config_path(), encoding="utf8") as f:
        text = f.read()
    cfg_text = re.sub(r"(?m)^(\s*dropout:)\s*0\s*$", r"\1 0.1", text)
    assert cfg_text != text, "configs/gpt.yaml holds no 'dropout: 0' line"
    with open(paths.gpt_config_path(base), "w", encoding="utf8") as f:
        f.write(cfg_text)
    k5_per_call = ops.prefill_attention_bwd.launches_per_call
    old_base = os.environ.get("EASEVOICE_BASE_PATH")
    os.environ["EASEVOICE_BASE_PATH"] = base
    runs = [(tag, is_half, gpt_train, ops) for tag, is_half in TRAIN_RUNS]
    if parent is not None:
        import importlib

        runs.insert(0, ("parent fp32", "False",
                        importlib.import_module("ev_parent.train.gpt"),
                        parent.ops))
    try:
        for tag, is_half, mod, run_ops in runs:
            with _is_half(is_half):
                trainer = mod.GPTTrain(mod.GPTTrainParams(
                    batch_size=3 * S1_B, total_epochs=1, save_every_epoch=1,
                    model_path=os.path.join(tmp, "s1_random.ckpt"),
                    train_input_dir=os.path.join(tmp, "s1_data"),
                    output_model_name="chip_smoke_s1_dropout_"
                    + tag.replace(" ", "_"),
                    project_dir=os.path.join(tmp, "s1_dropout_"
                                             + tag.replace(" ", "_"))))
            cfg = trainer.model_cfg
            assert cfg.dropout == 0.1 and (cfg.n_layers, cfg.hidden_dim,
                                           cfg.n_heads) == (24, 512, 16)
            history = []
            run_ops.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            resp = trainer.train(on_step=lambda step, m: history.append(
                {k: float(v) for k, v in m.items()}))
            wall = time.perf_counter() - t1
            peak = torch.cuda.max_memory_allocated()
            launches = run_ops.launch_counts()
            assert resp.ok, resp.message
            n, layers = len(history), cfg.n_layers
            assert n == 4 and trainer.step_fn.optimizer.param_groups[0][
                "step"] == 1, n
            assert all(math.isfinite(v) for m in history
                       for v in m.values()), history
            sfx = "_bf16" if tag.endswith("bf16") else ""
            want = {"prefill_attention_dropout" + sfx: layers * n,
                    "prefill_attention_bwd_dropout" + sfx:
                        k5_per_call * layers * n}
            got = {k: c for k, c in launches.items() if c}
            assert got == want, (got, want)
            if run_ops is ops:
                for name, count in want.items():
                    r = results[name]
                    r["launches"] = r.get("launches", 0) + count
                    r.setdefault("per_path", {})[
                        "s1_dropout_micro_batch"] = count / n
            log(f"[s1 dropout] {tag} (is_half={is_half or 'default'}): "
                f"GPTTrain.train() with dropout {cfg.dropout}: {n} "
                f"micro-batches of B={3 * S1_B} (one ScaledAdam update) in "
                f"{wall:.2f} s wall, T = "
                f"{sorted(set(S1_X_LEN + t for t in trainer.step_tokens))}; "
                f"s a micro-batch " + ", ".join(
                    f"{t:.4f}" for t in trainer.step_seconds)
                + "; losses " + ", ".join(f"{m['loss']:.1f}" for m in history)
                + "; grad norms " + ", ".join(
                    f"{m['grad_norm']:.3g}" for m in history)
                + f"; launches {got}; peak {peak / 2 ** 30:.3f} GiB "
                f"(torch.cuda.max_memory_allocated)")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if old_base is None:
            os.environ.pop("EASEVOICE_BASE_PATH", None)
        else:
            os.environ["EASEVOICE_BASE_PATH"] = old_base


def s1_dpo_micro_batch(torch, trainer) -> None:
    """One micro-batch of the DPO objective (``GPTTrainHP(if_dpo=True)``)
    on the bf16 model the s1 run trained: B = 4 (GPTTrain halves the batch
    under DPO) at T = 1776, the rejected sequences from ``make_reject_y``;
    its chosen and rejected forwards and their backward run K1 and K5's
    bf16 instances, 2 x 24 calls each.  Finite loss and gradient norm, no
    fp32 instance launched."""
    import numpy as np

    from easevoice_trainer_tpu_torch import ops
    from easevoice_trainer_tpu_torch.models.gpt.dpo import make_reject_y
    from easevoice_trainer_tpu_torch.train import data as data_mod
    from easevoice_trainer_tpu_torch.train.gpt import GPT_BOUNDARIES
    from easevoice_trainer_tpu_torch.train.gpt_step import GPTTrainHP, \
        GPTTrainStep

    dataset = data_mod.GPTDataset(trainer.params.train_input_dir,
                                  max_sec=trainer.max_sec)
    long_items = [i for i, n in enumerate(dataset.lengths) if n > 1100]
    batch = data_mod.collate_gpt(
        [dataset.load_item(i) for i in long_items[:S1_B // 2]], S1_X_LEN,
        GPT_BOUNDARIES[-1])
    rej, rej_lens = make_reject_y(
        batch["semantic_ids"], batch["semantic_ids_len"],
        np.random.default_rng(16), max_len=batch["semantic_ids"].shape[1])
    batch["reject_semantic_ids"] = rej
    batch["reject_semantic_ids_len"] = rej_lens
    model = trainer.step_fn.model
    step = GPTTrainStep(model, GPTTrainHP(if_dpo=True))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = {k: float(v) for k, v in step(trainer._to_device(batch)).items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    per_call = ops.prefill_attention_bwd.launches_per_call
    layers = model.cfg.n_layers
    log(f"[s1 training] one bf16 DPO micro-batch (B={S1_B // 2}, "
        f"T={S1_X_LEN + batch['semantic_ids'].shape[1]}, chosen and "
        f"rejected): {wall:.3f} s, metrics {metrics}; launches {launches}")
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    assert launches["prefill_attention_bf16"] == 2 * layers, launches
    assert launches["prefill_attention_bwd_bf16"] == \
        2 * layers * per_call, launches
    assert launches["prefill_attention"] == 0 == \
        launches["prefill_attention_bwd"], launches


# K1's and K5's kernels by name in a trace, either instance
K1_KERNEL = re.compile(r"\bprefill_attention(_bf16)?_kernel\b")
K5_KERNEL = re.compile(r"\b(dsum|dkdv|dq)(_bf16)?_kernel\b")


def profile_s1_window(torch, trainer, attempts: int = 3) -> None:
    """One accumulation window (4 micro-batches at T = 1776, the fourth
    ending with the ScaledAdam step) of the trained GPTTrainStep under
    torch.profiler: device time by group, K1 (K1_KERNEL: either instance's
    kernel), K5 (K5_KERNEL: its dsum / dkdv / dq kernels), GEMMs (cuBLAS /
    CUTLASS kernels), the optimizer (the kernels inside the step's
    ScaledAdam.step range on the device timeline) and the rest.  The window
    launches 4 x n_layers K1 kernels and 4 x n_layers x 3 K5 kernels (the
    wrappers' counts must say so), and its K1 and K5 groups must hold them
    all.  Each session first traces a window it discards (the profiler's
    warm-up: late in a long run, the first records of a session went
    missing, the window's first K1 among them), then the window it keeps;
    a session still short of some kernel records is taken again, up to
    ``attempts``, each logged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from easevoice_trainer_tpu_torch import ops
    from easevoice_trainer_tpu_torch.train import data as data_mod
    from easevoice_trainer_tpu_torch.train.gpt import GPT_BOUNDARIES
    from easevoice_trainer_tpu_torch.train.gpt_step import OPTIMIZER_RANGE

    dataset = data_mod.GPTDataset(trainer.params.train_input_dir,
                                  max_sec=trainer.max_sec)
    long_items = [i for i, n in enumerate(dataset.lengths) if n > 1100]
    batch = trainer._to_device(data_mod.collate_gpt(
        [dataset.load_item(i) for i in long_items[:S1_B]], S1_X_LEN,
        GPT_BOUNDARIES[-1]))
    step_fn = trainer.step_fn
    assert step_fn.mini_step == 0
    for _ in range(4):   # warm-up window
        step_fn(batch)
    torch.cuda.synchronize()
    layers = 4 * step_fn.model.cfg.n_layers
    want = {"K1": layers,
            "K5": layers * ops.prefill_attention_bwd.launches_per_call}
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):   # warm-up, then the window kept
                ops.reset_launch_counts()
                for _ in range(4):
                    step_fn(batch)
                torch.cuda.synchronize()
                prof.step()
        launches = ops.launch_counts()
        launched = {"K1": launches["prefill_attention"]
                    + launches["prefill_attention_bf16"],
                    "K5": launches["prefill_attention_bwd"]
                    + launches["prefill_attention_bwd_bf16"]}
        assert launched == want, (launched, want)
        events = prof.events()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        # the optimizer: the device time of the kernels launched inside the
        # step's ScaledAdam.step range on the host (the profiler links each
        # kernel to the host op that launched it)
        opt_ranges = [e for e in events if e.name == OPTIMIZER_RANGE
                      and e.device_type == DeviceType.CPU]
        opt_us = sum(e.device_time_total for e in opt_ranges)
        if not kernels:
            log("[s1 training] torch.profiler recorded no CUDA activity for "
                "the profiled window: no breakdown this run")
            return
        groups = {"K1": 0.0, "K5": 0.0, "GEMMs": 0.0, "optimizer": 0.0,
                  "other": 0.0}
        seen = {"K1": 0, "K5": 0}
        for e in kernels:
            us = e.time_range.elapsed_us()
            name = e.name.lower()
            if K1_KERNEL.search(name):
                key = "K1"
                seen[key] += 1
            elif K5_KERNEL.search(name):
                key = "K5"
                seen[key] += 1
            elif any(k in name for k in ("gemm", "xmma", "cutlass",
                                         "nvjet")):
                key = "GEMMs"
            else:
                key = "other"
            groups[key] += us
        if seen == want:
            break
        log(f"[timer] torch.profiler session {attempt} of {attempts} of the "
            f"s1 window recorded {seen['K1']} K1 and {seen['K5']} K5 "
            f"kernels of the window's {want['K1']} and {want['K5']} "
            f"({len(kernels)} kernels and copies in all)")
    # the optimizer's kernels are elementwise work and reductions
    groups["optimizer"] = min(opt_us, groups["other"])
    groups["other"] -= groups["optimizer"]
    total = sum(groups.values())
    note = "" if opt_ranges else (" (no ScaledAdam.step range in this "
                                  "trace: the optimizer is counted in other)")
    log(f"[s1 training] one accumulation window under torch.profiler (4 "
        f"micro-batches of B={S1_B} at T={S1_X_LEN + GPT_BOUNDARIES[-1]}, "
        f"the 4th with the ScaledAdam step): device time {total / 1000:.2f} "
        f"ms in {len(kernels)} kernels and copies, "
        f"{total / 4000:.2f} ms a micro-batch; "
        + ", ".join(f"{k} {v / 1000:.2f} ms" for k, v in groups.items())
        + f"; {seen['K1']} K1 and {seen['K5']} K5 kernels in their groups"
        + note)
    assert seen == want, (f"the window's K1 and K5 groups hold {seen} "
                          f"kernels, not {want}")


# ---------------------------------------------------------------------------
# phase 11: one s1 micro-batch on the card against the CPU
# ---------------------------------------------------------------------------


def cpu_site_masks(torch, seed: int):
    """Context: the GPT's three dropout sites outside the attention
    (``models/gpt/t2s.py`` ``dropout``) draw from one CPU generator seeded
    with ``seed``, their masks moved to the tensor's device, so that a run
    on the card and one on the CPU drop the same elements there; the
    attention's masks are the same on both by construction (Philox)."""
    import contextlib

    from easevoice_trainer_tpu_torch.models.gpt import t2s

    @contextlib.contextmanager
    def ctx():
        real = t2s.dropout
        gen = torch.Generator().manual_seed(seed)

        def on_the_cpu(x, p, training, generator):
            return real(x.cpu(), p, training, gen).to(x.device)

        t2s.dropout = on_the_cpu
        try:
            yield
        finally:
            t2s.dropout = real
    return ctx()


def reference_s1_step(torch):
    """The training forward and backward of a GPT at a small width (2
    layers, width 64, 2 heads of dk 32) on the card (K1, K5) and on the CPU
    (the twins) from the same weights and batch, in fp32 and in bf16 (the
    model with dtype bfloat16: K1 / K5's bf16 instances against the bf16
    twins), each without dropout and with dropout 0.1 (K1 / K5's dropout
    instances against the twins with ``attention_keep_mask``; the other
    three sites' masks drawn on the CPU for both, ``cpu_site_masks``).
    fp32: loss within 1e-5 x max(1, |CPU|), every layer's qkv gradient
    (in_proj weight and bias) within 1e-4 of its largest CPU magnitude.
    bf16: cuBLAS and the CPU sum in other orders and K5 takes the softmax's
    D from the bf16 o, so bf16 roundings flip (2^-8 of a value) and travel
    through two layers: loss within 1e-2, gradients within 5e-2."""
    from easevoice_trainer_tpu_torch import convert, ops
    from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
        Text2SemanticDecoder

    cfg = T2SConfig(embedding_dim=64, hidden_dim=64, n_heads=2, n_layers=2,
                    ffn_dim=128)
    gen = torch.Generator().manual_seed(17)
    b, x_len, y_len = 3, 40, 90
    batch = (torch.randint(1, 700, (b, x_len), generator=gen),
             torch.tensor([40, 23, 1]),
             torch.randint(0, 1024, (b, y_len), generator=gen),
             torch.tensor([90, 64, 5]),
             torch.randn((b, x_len, 1024), generator=gen))
    state = convert.random_state_dict(Text2SemanticDecoder(cfg),
                                      torch.Generator().manual_seed(18))
    for (dtype, tol_loss, tol_grad), p in itertools.product(
            ((None, 1e-5, 1e-4), (torch.bfloat16, 1e-2, 5e-2)),
            (0.0, DROPOUT_P)):
        runs = {}
        for dev in ("cuda", "cpu"):
            model = Text2SemanticDecoder(dataclasses.replace(cfg, dropout=p),
                                         dtype=dtype)
            model.load_state_dict(state)
            model.to(dev)
            ops.reset_launch_counts()
            with cpu_site_masks(torch, 23):
                out = model(*(t.to(dev) for t in batch), seed=20261019)
                out["loss"].backward()
            launches = {k: c for k, c in ops.launch_counts().items() if c}
            grads = {k: w.grad.cpu() for k, w in model.named_parameters()
                     if "self_attn.in_proj" in k}
            runs[dev] = (float(out["loss"].detach()), grads, launches)
        label = ("bf16" if dtype is not None else "fp32") + (
            f" dropout {p}" if p else "")
        # the card ran the instances of its dtype and dropout alone (2
        # layers), the CPU none
        name = "_dropout" if p else ""
        name += "_bf16" if dtype is not None else ""
        assert runs["cuda"][2] == {
            "prefill_attention" + name: 2,
            "prefill_attention_bwd" + name: 6} and not runs["cpu"][2], \
            (runs["cuda"][2], runs["cpu"][2])
        (l_gpu, g_gpu, _), (l_cpu, g_cpu, _) = runs["cuda"], runs["cpu"]
        loss_err = abs(l_gpu - l_cpu) / max(1.0, abs(l_cpu))
        grad_err = max(float((g_gpu[k] - w).abs().max())
                       / max(float(w.abs().max()), 1e-30)
                       for k, w in g_cpu.items())
        log(f"[reference] s1 micro-batch {label} card vs CPU (GPT width 64, "
            f"2 layers, B={b}, T={x_len + y_len}): loss {l_gpu:.4f} vs "
            f"{l_cpu:.4f}, relative {loss_err:.3g} (tol {tol_loss}); "
            f"{len(g_cpu)} qkv gradients max|d| / max|CPU| = {grad_err:.3g} "
            f"(tol {tol_grad})")
        assert loss_err <= tol_loss and grad_err <= tol_grad \
            and len(g_cpu) == 4, label


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# data parallel: both fine-tunes through parallel/, on ranks sharing the card
# ---------------------------------------------------------------------------

DP_SEED = 20_020
DP_B = 8                    # global batch rows: 4 a rank in a world of two
DP_WINDOW = 4               # s1 micro-batches: one accumulation window
DP_S2_STEPS = 2
# the s1 window's GPT: configs/gpt.yaml's widths at this depth (the phase
# checks the row split and the reductions; 24 layers only lengthened it)
DP_LAYERS = 6
# the T = 716 bucket: rows 0-3 long, rows 4-7 short, so the two ranks hold
# other numbers of targets and valid frames
DP_X_LENS = (416, 380, 350, 300, 200, 150, 120, 64)
DP_Y_LENS = (300, 290, 260, 240, 120, 90, 60, 30)
DP_S2_FRAMES = 160          # 3.2 s at 50 spectrogram frames a second
DP_SPEC_LENS = (160, 150, 140, 130, 90, 70, 50, 40)
DP_TEXT_LENS = (96, 90, 80, 70, 50, 40, 30, 20)
# bf16 ranks against the world of one: per-rank GEMMs and the bf16
# weight gradients rounded per rank before the fp32 sum, max(1, |ref|)
DP_BF16_TOL = 2.0 ** -6
DP_DRAWS = 4_200_000        # the drop rate's draws


def dp_s1_batches(np):
    """One accumulation window of global s1 micro-batches at the T = 716
    bucket (416 phonemes, 300 tokens), as numpy (``collate_gpt``'s keys)."""
    rng = np.random.default_rng(DP_SEED)
    x_len, y_len = S1_X_LEN, S1_Y_LENS[0]
    out = []
    for _ in range(DP_WINDOW):
        x = rng.integers(1, 732, (DP_B, x_len)).astype(np.int32)
        y = rng.integers(0, 1024, (DP_B, y_len)).astype(np.int32)
        for i, (xl, yl) in enumerate(zip(DP_X_LENS, DP_Y_LENS)):
            x[i, xl:] = 0
            y[i, yl:] = 0
        out.append({"phoneme_ids": x,
                    "phoneme_ids_len": np.asarray(DP_X_LENS, np.int32),
                    "semantic_ids": y,
                    "semantic_ids_len": np.asarray(DP_Y_LENS, np.int32),
                    "bert_feature": rng.normal(
                        size=(DP_B, x_len, 1024)).astype(np.float32)})
    return out


def dp_s2_setup(torch, np, dev):
    """configs/s2.json's SovitsConfig, S2TrainHP and MelConfig (as
    ``SovitsTrain`` reads them) and DP_S2_STEPS global batches of
    DP_S2_FRAMES frames with ragged lengths, as tensors on ``dev``."""
    from easevoice_trainer_tpu_torch.models.sovits import SovitsConfig
    from easevoice_trainer_tpu_torch.ops.stft import MelConfig, spectrogram
    from easevoice_trainer_tpu_torch.train.sovits_step import S2TrainHP
    from easevoice_trainer_tpu_torch.utils import paths

    with open(paths.s2_config_path(), encoding="utf8") as f:
        raw = json.load(f)
    t, d = raw["train"], raw["data"]
    cfg = SovitsConfig.from_json_dict(raw)
    hp = S2TrainHP(learning_rate=t["learning_rate"], betas=tuple(t["betas"]),
                   eps=t["eps"], lr_decay=t["lr_decay"],
                   segment_size=t["segment_size"], c_mel=t["c_mel"],
                   c_kl=t["c_kl"])
    mel = MelConfig(sampling_rate=d["sampling_rate"], n_fft=d["filter_length"],
                    hop_length=d["hop_length"], win_length=d["win_length"],
                    n_mels=d["n_mel_channels"], fmin=d["mel_fmin"],
                    fmax=d["mel_fmax"])
    rng = np.random.default_rng(DP_SEED + 1)
    batches = []
    for _ in range(DP_S2_STEPS):
        wav = torch.from_numpy(rng.uniform(
            -0.5, 0.5, (DP_B, DP_S2_FRAMES * mel.hop_length)).astype(
                np.float32)).to(dev)
        spec = spectrogram(wav, mel.n_fft, mel.hop_length, mel.win_length)
        batches.append({
            "ssl": torch.from_numpy(rng.normal(size=(
                DP_B, DP_S2_FRAMES, cfg.ssl_dim)).astype(np.float32)).to(dev),
            "spec": spec[:, :DP_S2_FRAMES].contiguous(), "wav": wav,
            "spec_lengths": torch.tensor(DP_SPEC_LENS, device=dev),
            "text": torch.from_numpy(rng.integers(
                1, cfg.n_symbols, (DP_B, max(DP_TEXT_LENS)))).to(dev),
            "text_lengths": torch.tensor(DP_TEXT_LENS, device=dev)})
    return cfg, hp, mel, batches


def dp_digest(modules) -> str:
    """sha256 of the modules' weights, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for m in modules:
        for k, v in m.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def k1_keep_bits(torch, att, dropout, x_len, xl, yl, t, h=16, block=32):
    """The keep bits K1's bf16 dropout instance draws for a batch of one
    row, read through its output as ``dropout_readout`` reads them (q = 0,
    v one-hot on a block of 32 keys): (h, t, t) bool, True where a visible
    pair is kept."""
    dev, dk = torch.device("cuda"), 32
    zeros = functools.partial(torch.zeros, (1, t, h, dk),
                              dtype=torch.bfloat16, device=dev)
    eye = torch.eye(block, dk, dtype=torch.bfloat16, device=dev)
    q = zeros()
    bits = torch.zeros((h, t, t), dtype=torch.bool, device=dev)
    for k0 in range(0, t, block):
        n = min(block, t - k0)
        v = zeros()
        v[:, k0:k0 + n] = eye[:n, None, :]
        o, _ = att.prefill_attention_lse(q, q, v, x_len, xl, yl, dropout)
        bits[:, :, k0:k0 + n] = (o[0].float() > 0).permute(1, 0, 2)[..., :n]
    return bits.cpu()


def dp_jobs(torch, dev, rows, only_first: bool = False):
    """The phase's work on one rank (``rows``: its ``BatchRows``) or in the
    world of one (``rows`` None): the s1 window in bf16 at dropout 0 and
    0.1, then DP_S2_STEPS s2 steps in bf16, every model built from
    DP_SEED.  Per job: the metrics, the weights' digest, s a micro-batch /
    step (host clock to the end of its device work), each
    ``reduce_gradients`` call's bytes and its time between CUDA events and
    on the host clock, the kernels launched; on the rank whose rows start
    past 0, the K1 keep bits of its first row (the window's first seed,
    layer 0).  ``only_first``: the s1 window at dropout 0 alone."""
    import numpy as np

    from easevoice_trainer_tpu_torch import ops
    from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
        Text2SemanticDecoder
    from easevoice_trainer_tpu_torch.models.gpt.t2s import ATTENTION_KEY
    from easevoice_trainer_tpu_torch.models.sovits import \
        MultiPeriodDiscriminator, SynthesizerTrn
    from easevoice_trainer_tpu_torch.ops import attention as att
    from easevoice_trainer_tpu_torch.parallel import distributed
    from easevoice_trainer_tpu_torch.train.gpt_step import GPTTrainHP, \
        GPTTrainStep
    from easevoice_trainer_tpu_torch.train.sovits_step import S2TrainStep
    from easevoice_trainer_tpu_torch.utils import paths, simple_yaml

    local = list(range(DP_B)) if rows is None else \
        distributed.process_local_rows(DP_B)
    calls = []
    real_reduce = distributed.reduce_gradients

    def timed_reduce(params):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        nbytes = real_reduce(params)
        end.record()
        torch.cuda.synchronize()
        calls.append((nbytes, start, end, time.perf_counter() - t0))
        return nbytes

    def job(run):
        calls.clear()
        ops.reset_launch_counts()
        metrics, seconds = [], []
        for i in range(len(run["batches"])):
            t0 = time.perf_counter()
            got = run["step"](i)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in got.items()})
        return {"metrics": metrics, "seconds": seconds,
                "digest": dp_digest(run["nets"]),
                "reduce": [(n, s.elapsed_time(e), host * 1e3)
                           for n, s, e, host in calls],
                "launches": {k: c for k, c in ops.launch_counts().items()
                             if c}}

    out = {}
    distributed.reduce_gradients = timed_reduce
    try:
        s1 = dp_s1_batches(np)
        cfg = T2SConfig.from_yaml_dict(simple_yaml.load(
            paths.gpt_config_path()))
        for p in (0.0,) if only_first else (0.0, DROPOUT_P):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(DP_SEED)
                model = Text2SemanticDecoder(
                    dataclasses.replace(cfg, dropout=p, n_layers=DP_LAYERS),
                    dtype=torch.bfloat16).to(dev).train()
            step = GPTTrainStep(model, GPTTrainHP())
            batches = [{k: torch.from_numpy(v[local]).to(dev).to(
                torch.int64 if v.dtype == np.int32 else torch.float32)
                for k, v in b.items()} for b in s1]
            out[f"s1 dropout {p}"] = job({
                "batches": batches, "nets": (model,),
                "step": lambda i: step(batches[i], seed=DP_SEED + i,
                                       rows=rows)})
            if p and rows is not None and rows.row0:
                seed = (DP_SEED % 2 ** 64) ^ ATTENTION_KEY
                t = S1_X_LEN + S1_Y_LENS[0]
                first = local[0]
                lens = [torch.tensor([v[first]], dtype=torch.int32,
                                     device=dev)
                        for v in (DP_X_LENS, DP_Y_LENS)]
                out["keep_bits"] = k1_keep_bits(
                    torch, att, att.AttentionDropout(p, seed, 0, rows.row0),
                    S1_X_LEN, *lens, t, cfg.n_heads)
            del model, step, batches
            torch.cuda.empty_cache()
        if only_first:
            return out
        s2_cfg, hp, mel, s2 = dp_s2_setup(torch, np, dev)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(DP_SEED)
            net_g = SynthesizerTrn(s2_cfg, with_enc_q=True,
                                   dtype=torch.bfloat16)
            net_d = MultiPeriodDiscriminator(dtype=torch.bfloat16)
        net_g.to(dev)
        net_d.to(dev)
        s2_step = S2TrainStep(net_g, net_d, hp, mel, steps_per_epoch=100)
        gen = torch.Generator(device=dev)
        s2_local = [{k: v[local] for k, v in b.items()} for b in s2]

        def s2_call(i):
            gen.manual_seed(DP_SEED + i)
            return s2_step(s2_local[i], gen, rows=rows)

        out["s2"] = job({"batches": s2_local, "nets": (net_g, net_d),
                         "step": s2_call})
    finally:
        distributed.reduce_gradients = real_reduce
    return out


def dp_rank(only_first: bool = False):
    """One rank of the data-parallel phase (``distributed.launch``'s
    target): the rank's jobs on its card (cuda:0 when the ranks share it
    over gloo), TF32 off as in the parent; ``only_first`` as for
    ``dp_jobs``."""
    import torch

    from easevoice_trainer_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    return dp_jobs(torch, dev, distributed.batch_rows(DP_B), only_first)


def dp_rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


def data_parallel(torch, results) -> None:
    """Both fine-tunes in bf16 through ``parallel/``: ``launch`` starts the
    ranks, each loads its rows of the global batch (``process_local_rows``)
    and the steps sum the gradients (``reduce_gradients``).  The s1 window
    (configs/gpt.yaml's GPT at DP_LAYERS layers, 512 wide, 16 heads,
    global B = 8 at T = 716,
    4 micro-batches, once at dropout 0 and once at 0.1) and 2 s2 steps
    (``SovitsConfig()``, global B = 8, 160 frames) run

    * in this process, the world of one on the global batch;
    * (a) on two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on
      one device), asked for by ``backend="gloo"``: every rank's metrics
      equal, the weights bit-identical across the ranks, each loss and
      grad norm within DP_BF16_TOL of the world of one's, and rank 1's K1
      keep bits for its first row (global row 4) read back equal to the
      world of one's mask at row 4, bit for bit;
    * (b) on an NCCL world of one rank, the s1 window at dropout 0 alone:
      bit-identical to this process (an all-reduce over one rank is a
      copy): NCCL initializes and reduces on the card.

    Printed beside the card's name and power limit: s a micro-batch / step
    of each world, each all-reduce's ms (CUDA events) and bytes a step.
    Then the drop rate of ``nn.layers.dropout`` in bf16 on the card,
    DP_DRAWS draws at p = 0.1, within 6 sigma, beside the same draw made
    in bf16 as before the repair.  Outside a world no process group
    exists."""
    from easevoice_trainer_tpu_torch.nn import layers
    from easevoice_trainer_tpu_torch.ops import attention as att
    from easevoice_trainer_tpu_torch.models.gpt.t2s import ATTENTION_KEY
    from easevoice_trainer_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    assert not distributed.initialized()
    one = dp_jobs(torch, torch.device("cuda"), None)
    gc.collect()
    torch.cuda.empty_cache()
    worlds = {"gloo x2": distributed.launch(dp_rank, (), 2, "cuda", "gloo"),
              "nccl x1": distributed.launch(dp_rank, (True,), 1, "cuda",
                                            "nccl")}
    assert not distributed.initialized()
    for name, ranks in worlds.items():
        for job, ref in one.items():
            if job not in ranks[0]:
                continue
            got = [r[job] for r in ranks]
            for r in got[1:]:
                assert r["metrics"] == got[0]["metrics"], (name, job)
                assert r["digest"] == got[0]["digest"], (name, job)
            if name == "nccl x1":
                assert got[0]["metrics"] == ref["metrics"], (
                    name, job, got[0]["metrics"], ref["metrics"])
                assert got[0]["digest"] == ref["digest"], (name, job)
                worst = 0.0
            else:
                worst = max(dp_rel(m[k], w[k]) for m, w in zip(
                    got[0]["metrics"], ref["metrics"]) for k in w
                    if k.startswith(("loss", "grad_norm")))
                assert worst <= DP_BF16_TOL, (name, job, worst)
            reduce = [c for r in got for c in r["reduce"]]
            steps = len(ref["metrics"])
            per_rank = sum(n for n, _, _ in got[0]["reduce"]) / steps
            log(f"[data parallel] {name} {job}: {len(got)} rank(s) of "
                f"{DP_B // len(got)} rows; metrics equal across ranks, "
                f"weights bit-identical across ranks"
                + (" and to the world of one" if name == "nccl x1" else
                   f"; worst loss / grad norm against the world of one "
                   f"{worst:.3g} (tol {DP_BF16_TOL:.3g})")
                + f"; s a micro-batch / step " + ", ".join(
                    f"{s:.4f}" for s in got[0]["seconds"])
                + " (world of one " + ", ".join(
                    f"{s:.4f}" for s in ref["seconds"]) + ")"
                + f"; all-reduce {len(reduce) // len(got) // steps} a "
                f"step, {per_rank / 1e6:.2f} MB a step a rank, ms a call "
                f"(CUDA events) " + ", ".join(
                    f"{ms:.3f}" for _, ms, _ in got[0]["reduce"])
                + ", host " + ", ".join(
                    f"{ms:.3f}" for _, _, ms in got[0]["reduce"])
                + f"; launches {got[0]['launches']}; {smi}")
            if job.startswith("s1"):
                sfx = "_dropout_bf16" if "0.1" in job else "_bf16"
                n = DP_LAYERS * DP_WINDOW
                assert got[0]["launches"] == {
                    "prefill_attention" + sfx: n,
                    "prefill_attention_bwd" + sfx: 3 * n}, got[0]["launches"]
    # (a)'s rank 1: K1's keep bits of its first row against the world of
    # one's mask at that global row
    bits = worlds["gloo x2"][1]["keep_bits"]
    t = S1_X_LEN + S1_Y_LENS[0]
    row = DP_B // 2
    xl = torch.tensor(DP_X_LENS, dtype=torch.int32, device="cuda")
    yl = torch.tensor(DP_Y_LENS, dtype=torch.int32, device="cuda")
    vis = (att.build_hybrid_mask_bias(S1_X_LEN, t - S1_X_LEN, xl, yl)[row, 0]
           == 0).cpu()
    mask = att.AttentionDropout(DROPOUT_P, (DP_SEED % 2 ** 64) ^
                                ATTENTION_KEY, 0).keep_mask(
        DP_B, bits.shape[0], t, S1_X_LEN, "cuda")[row].cpu()
    off = int(((bits != mask) & vis).sum() + (bits & ~vis).sum())
    n_vis = int(vis.sum()) * bits.shape[0]
    log(f"[data parallel] gloo x2 rank 1, K1 bf16 dropout keep bits of its "
        f"row 0 (global row {row}, layer 0, T={t}) read back: {off} of "
        f"{n_vis} visible pairs off the world of one's mask at row {row}")
    assert off == 0 and n_vis > 0
    # the three generator sites' draw in bf16 on the card
    gen = torch.Generator(device="cuda")
    ones = torch.ones(DP_DRAWS, dtype=torch.bfloat16, device="cuda")
    rate = float((layers.dropout(ones, DROPOUT_P, True, gen.manual_seed(
        DP_SEED)) == 0).float().mean())
    old = float((torch.rand(DP_DRAWS, generator=gen.manual_seed(DP_SEED),
                            dtype=torch.bfloat16, device="cuda")
                 < DROPOUT_P).float().mean())
    sigma = math.sqrt(DROPOUT_P * (1 - DROPOUT_P) / DP_DRAWS)
    log(f"[data parallel] nn.layers.dropout bf16 on the card, {DP_DRAWS} "
        f"draws at p = {DROPOUT_P}: drop rate {rate:.6f} "
        f"({(rate - DROPOUT_P) / sigma:+.2f} sigma, sigma {sigma:.3g}); "
        f"uniforms drawn in bf16 as before the repair: {old:.6f} "
        f"({(old - DROPOUT_P) / sigma:+.2f} sigma); {smi}")
    assert abs(rate - DROPOUT_P) <= 6 * sigma, rate
    results["data_parallel"] = {"drop_rate_bf16": rate}
    log(f"[data parallel] phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# tensor parallel: the s1 fine-tune on a (data, model) grid of ranks
# ---------------------------------------------------------------------------

TP_N_MODEL = 2
TP_GRID = (2, 2)            # data x model, at reduced depth
TP_GRID_LAYERS = 4
# the model 2 world's depth at configs/gpt.yaml's widths (24 layers only
# lengthened the phase: each layer does the same f, g and sums)
TP_LAYERS = 6
TP_FP32_TOL = 1e-3          # fp32 ranks against the world of one, relative
# fp32 weight updates: the share of a tensor's elements whose window
# update is more than 25 % off the world of one's.  ScaledAdam's first step
# moves each element by about lr x RMS x sign(g), so an element whose
# gradient is within rounding of 0 may take the other sign, and one such
# element of a 2048-element bias is 4.4 % of its update's norm; a wrong
# scale (an RMS over the shard alone) puts every element of the tensor
# off
TP_UPDATE_OFF = 1e-2
# the jobs: (name, dropout, layers or None for configs/gpt.yaml's)
TP_JOBS = (("bf16", 0.0, TP_LAYERS), ("fp32", 0.0, TP_LAYERS),
           ("bf16 dropout", DROPOUT_P, TP_LAYERS))
TP_GRID_JOBS = (("fp32 dropout", DROPOUT_P, TP_GRID_LAYERS),)


def tp_jobs(torch, dev, jobs, ref_dir):
    """The tensor-parallel phase's work on one rank of a grid, or in the
    world of one (no process group): per job of ``jobs``, one s1 window
    (DP_WINDOW micro-batches of the global B = DP_B at T = 716, the GPT of
    configs/gpt.yaml in the job's dtype and dropout, built on the CPU from
    DP_SEED and sharded for the rank's model index).  Per job: the metrics,
    s a micro-batch (host clock to the end of its device work), the
    kernels launched, the model group's all-reduces (``all_reduce_model``)
    and the data group's (``reduce_gradients``) each with its bytes, ms
    between CUDA events and host ms, and a digest of the replicated
    weights.  The world of one writes its weights after the window to
    ``ref_dir``; rank 0 of a grid gathers the whole weights and holds them
    to those (the worst error relative to max(1, |ref|), and the worst
    norm of the difference of the window's updates over the update's);
    the rank at model index 1 of a dropout job reads K1's keep bits of its
    heads (``h0``) for batch row 0."""
    import hashlib

    import numpy as np

    from easevoice_trainer_tpu_torch import ops
    from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
        Text2SemanticDecoder
    from easevoice_trainer_tpu_torch.models.gpt.t2s import ATTENTION_KEY
    from easevoice_trainer_tpu_torch.ops import attention as att
    from easevoice_trainer_tpu_torch.parallel import distributed, \
        gpt_sharding
    from easevoice_trainer_tpu_torch.train.gpt_step import GPTTrainHP, \
        GPTTrainStep
    from easevoice_trainer_tpu_torch.utils import paths, simple_yaml

    world = distributed.initialized()
    rows = distributed.batch_rows(DP_B)
    local = distributed.process_local_rows(DP_B)
    tp = (distributed.model_rank(), distributed.model_size()) \
        if distributed.model_size() > 1 else None
    cfg = T2SConfig.from_yaml_dict(simple_yaml.load(paths.gpt_config_path()))
    s1 = dp_s1_batches(np)
    calls = {"model": [], "data": []}
    real = {"model": distributed.all_reduce_model,
            "data": distributed.reduce_gradients}

    def timed(kind):
        def call(arg):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            got = real[kind](arg)
            end.record()
            torch.cuda.synchronize()
            nbytes = got if kind == "data" else arg.numel() * \
                arg.element_size()
            if nbytes:    # reduce_gradients without a data group moves none
                calls[kind].append((nbytes, start, end,
                                    time.perf_counter() - t0))
            return got
        return call

    out = {}
    distributed.all_reduce_model = timed("model")
    distributed.reduce_gradients = timed("data")
    try:
        inits = {}    # the initial weights by depth (dtype and dropout
        #               leave them as they are)
        for name, p, layers in jobs:
            dtype = torch.bfloat16 if name.startswith("bf16") else None
            c = dataclasses.replace(cfg, dropout=p,
                                    n_layers=layers or cfg.n_layers)
            if c.n_layers not in inits:
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(DP_SEED)
                    inits[c.n_layers] = Text2SemanticDecoder(c).state_dict()
            init = inits[c.n_layers]
            model = Text2SemanticDecoder(c, dtype=dtype, tp=tp)
            model.load_state_dict(init if tp is None else
                                  gpt_sharding.shard_state_dict(init, *tp))
            model.to(dev).train()
            step = GPTTrainStep(model, GPTTrainHP())
            batches = [{k: torch.from_numpy(v[local]).to(dev).to(
                torch.int64 if v.dtype == np.int32 else torch.float32)
                for k, v in b.items()} for b in s1]
            for kind in calls:
                calls[kind].clear()
            ops.reset_launch_counts()
            metrics, seconds = [], []
            for i, batch in enumerate(batches):
                t0 = time.perf_counter()
                got = step(batch, seed=DP_SEED + i, rows=rows)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                metrics.append({k: float(v) for k, v in got.items()})
            res = {"metrics": metrics, "seconds": seconds,
                   "launches": {k: n for k, n in ops.launch_counts().items()
                                if n},
                   "reduce": {kind: [(n, s.elapsed_time(e), host * 1e3)
                                     for n, s, e, host in got_calls]
                              for kind, got_calls in calls.items()}}
            named = [(k, v.detach()) for k, v in model.state_dict().items()]
            h = hashlib.sha256()
            for k, v in named:
                if gpt_sharding.shard_class(k) == "rep":
                    h.update(k.encode())
                    h.update(v.float().cpu().numpy().tobytes())
            res["rep_digest"] = h.hexdigest()
            after = dict(zip([k for k, _ in named],
                             gpt_sharding.gather_whole(named)))
            ref_path = os.path.join(ref_dir, name.replace(" ", "_") + ".pt")
            if not world:
                torch.save({k: v.cpu() for k, v in after.items()}, ref_path)
            elif distributed.rank() == 0:
                ref = torch.load(ref_path, map_location="cpu")
                worst, moved, moved_name = 0.0, 0.0, ""
                for k, want in ref.items():
                    mine, want = after[k], want.to(dev)
                    worst = max(worst, float((mine - want).abs().max()) /
                                max(1.0, float(want.abs().max())))
                    start = init[k].to(dev)
                    d_ref, d_mine = want - start, mine - start
                    if k.endswith("in_proj_bias"):   # not the key biases
                        third = d_ref.shape[0] // 3
                        d_ref, d_mine = (torch.cat([d[:third],
                                                    d[2 * third:]])
                                         for d in (d_ref, d_mine))
                    off = float(((d_mine - d_ref).abs()
                                 > 0.25 * d_ref.abs()).float().mean())
                    if off > moved:
                        moved, moved_name = off, k
                res["weights"] = (worst, moved, moved_name)
            if p and tp is not None and tp[0] == 1:
                seed = (DP_SEED % 2 ** 64) ^ ATTENTION_KEY
                first = local[0]
                lens = [torch.tensor([v[first]], dtype=torch.int32,
                                     device=dev)
                        for v in (DP_X_LENS, DP_Y_LENS)]
                heads = c.n_heads // tp[1]
                res["keep_bits"] = (first, heads, k1_keep_bits(
                    torch, att, att.AttentionDropout(p, seed, 0, first,
                                                     heads),
                    S1_X_LEN, *lens, S1_X_LEN + S1_Y_LENS[0], heads))
            out[name] = res
            del model, step, batches, after, named, init
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        distributed.all_reduce_model = real["model"]
        distributed.reduce_gradients = real["data"]
    return out


def tp_rank(jobs, ref_dir):
    """One rank of the tensor-parallel phase (``distributed.launch``'s
    target): its jobs on the card the ranks share over gloo, TF32 off as
    in the parent."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    return tp_jobs(torch, dev, jobs, ref_dir)


def tp_kernel_times(torch, smi) -> dict:
    """K1 + lse and K5 at a tensor-parallel rank's local shape (H = 8 of
    the 16 heads at TP 2; B = DP_B, T = 716, DP_X_LENS / DP_Y_LENS) beside
    the whole layer's (H = 16) on the same rows, fp32 and bf16: device ms
    (torch.profiler), SDPA's and its backward's at H = 8, and the bound at
    H = 8 (Bound: q, k, v, o, lse moved once; 4 dk flops a visible (row,
    key, head) for K1, 10 for K5)."""
    import torch.nn.functional as F

    from easevoice_trainer_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(DP_SEED)
    b, dk, x_len, y_len = DP_B, 32, S1_X_LEN, S1_Y_LENS[0]
    t = x_len + y_len
    xl = torch.tensor(DP_X_LENS, dtype=torch.int32, device="cuda")
    yl = torch.tensor(DP_Y_LENS, dtype=torch.int32, device="cuda")
    bias = att.build_hybrid_mask_bias(x_len, y_len, xl, yl)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        tag = "bf16" if bf else "fp32"
        times = {}
        for h in (16, 8):
            qkv = torch.randn((b, t, 3 * h * dk), generator=gen,
                              device="cuda").to(dtype)
            do = torch.randn((b, t, h, dk), generator=gen,
                             device="cuda").to(dtype)
            q, k, v = att._split_heads(qkv, h)
            o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl)
            times[h] = (
                device_ms(torch, lambda: att.prefill_attention_lse(
                    q, k, v, x_len, xl, yl), launches=1),
                device_ms(torch, lambda: att.prefill_attention_bwd(
                    q, k, v, o, lse, do, x_len, xl, yl), launches=3))
        qh, kh, vh = (z.transpose(1, 2).contiguous().requires_grad_()
                      for z in (q, k, v))
        lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
        lib_bwd = functools.partial(torch.autograd.grad, lib, (qh, kh, vh),
                                    do.transpose(1, 2).contiguous(),
                                    retain_graph=True)
        lib_ms = (event_ms(torch, lambda: F.scaled_dot_product_attention(
            qh.detach(), kh.detach(), vh.detach(), attn_mask=bias)),
            event_ms(torch, lib_bwd, reps=5))
        pairs = int((bias == 0).sum()) * 8
        elems = b * t * 8 * dk
        size = 2 if bf else 4
        bounds = [Bound(BF16_OPS_PER_S if bf else FP32_OPS_PER_S)
                  for _ in "ab"]
        bounds[0].add(size * 4 * elems + 4 * b * 8 * t, 4 * dk * pairs)
        bounds[1].add(size * 8 * elems + 4 * b * 8 * t, 10 * dk * pairs)
        for i, name in enumerate(("K1 + lse", "K5")):
            log(f"[tensor parallel] {tag} {name} at B={b} T={t} "
                f"(DP_X_LENS / DP_Y_LENS): device ms H=8 "
                f"{times[8][i]:.4f}, H=16 {times[16][i]:.4f} (H=8 / H=16 "
                f"{times[8][i] / times[16][i]:.3f}); SDPA"
                f"{' backward' if i else ''} H=8 {lib_ms[i]:.4f}; bound H=8 "
                f"{bounds[i].ms:.4f} ({bounds[i].by}); {smi}")
        out[tag] = {"h8_ms": [times[8][0], times[8][1]],
                    "h16_ms": [times[16][0], times[16][1]],
                    "library_ms": list(lib_ms),
                    "bound_ms": [bd.ms for bd in bounds]}
        del qkv, do, q, k, v, o, lse, qh, kh, vh, lib, lib_bwd
        torch.cuda.empty_cache()
    return out


def tensor_parallel(torch, results) -> None:
    """The s1 fine-tune under tensor parallelism through ``parallel/``:
    ``launch`` starts the ranks of a (data, model) grid, each holds its
    model index's shard of the GPT (``gpt_sharding``: its heads of each
    layer's attention, 1 / n_model of its FFN) and its data index's rows,
    and the steps join the model group by Megatron's f and g.  The s1
    window (DP_WINDOW micro-batches of the global B = DP_B at T = 716, one
    ScaledAdam update) runs

    * in this process, the world of one on the global batch;
    * (a) TP 2 x DP 1 at configs/gpt.yaml's full width (512, 16 heads, FFN
      2048) and TP_LAYERS layers, two ranks sharing cuda:0 over gloo, in
      bf16, in fp32 and in bf16 with dropout 0.1;
    * (b) a data 2 x model 2 grid of four ranks at TP_GRID_LAYERS layers,
      fp32 with dropout 0.1 (the fp32 dropout instances of K1 and K5 on
      the grid).

    Checked: every rank reports the same metrics; the replicated weights
    are bitwise equal across each model group; losses, acc and grad norms
    against the world of one within TP_FP32_TOL relative in fp32 and
    DP_BF16_TOL of max(1, |ref|) in bf16; the gathered weights within the
    same, and in fp32 at most TP_UPDATE_OFF of each weight's elements with
    a window update more than 25 % off the world of one's (key biases
    aside); every rank launched its K1 and K5 instance
    n_layers x DP_WINDOW times (K5 three kernels a call) and no other; the
    keep bits K1 drew on model index 1 (heads 8-15, through ``h0``) are the
    world of one's at those heads, bit for bit.  Printed beside the card's
    name and power limit: s a micro-batch, each rank's launches, the bytes
    a rank all-reduces a micro-batch over the model group and the data
    group with their ms (CUDA events, host); then K1 / K5 at the local
    shape H = 8 (:func:`tp_kernel_times`)."""
    from easevoice_trainer_tpu_torch.models.gpt import T2SConfig
    from easevoice_trainer_tpu_torch.models.gpt.t2s import ATTENTION_KEY
    from easevoice_trainer_tpu_torch.ops import attention as att
    from easevoice_trainer_tpu_torch.parallel import distributed
    from easevoice_trainer_tpu_torch.utils import paths, simple_yaml

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    cfg = T2SConfig.from_yaml_dict(simple_yaml.load(paths.gpt_config_path()))
    assert not distributed.initialized()
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    walls = {}
    try:
        t0 = time.perf_counter()
        one = tp_jobs(torch, torch.device("cuda"), TP_JOBS + TP_GRID_JOBS,
                      ref_dir)
        gc.collect()
        torch.cuda.empty_cache()
        walls["world of one"] = time.perf_counter() - t0
        worlds = {}
        for world, jobs, n_data, n_model in (
                (f"model {TP_N_MODEL}", TP_JOBS, 1, TP_N_MODEL),
                (f"data {TP_GRID[0]} x model {TP_GRID[1]}", TP_GRID_JOBS,
                 *TP_GRID)):
            t0 = time.perf_counter()
            worlds[world] = (jobs, distributed.launch(
                tp_rank, (jobs, ref_dir), n_data * n_model, "cuda", "gloo",
                n_model=n_model))
            walls[world] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    assert not distributed.initialized()
    for world, (jobs, ranks) in worlds.items():
        n_model = TP_N_MODEL if world.startswith("model") else TP_GRID[1]
        for name, p, layers in jobs:
            ref = one[name]
            got = [r[name] for r in ranks]
            for r in got[1:]:
                assert r["metrics"] == got[0]["metrics"], (world, name)
            for d in range(len(got) // n_model):
                group = got[d * n_model:(d + 1) * n_model]
                assert len({g["rep_digest"] for g in group}) == 1, \
                    (world, name, d)
            tol = DP_BF16_TOL if name.startswith("bf16") else TP_FP32_TOL
            worst = max(dp_rel(m[k], w[k]) for m, w in zip(
                got[0]["metrics"], ref["metrics"]) for k in w)
            w_err, moved, moved_name = got[0]["weights"]
            assert worst <= tol and w_err <= tol, (world, name, worst, w_err)
            if not name.startswith("bf16"):
                assert moved <= TP_UPDATE_OFF, (world, name, moved)
            n = (layers or cfg.n_layers) * DP_WINDOW
            sfx = ("_dropout" if p else "") + \
                ("_bf16" if name.startswith("bf16") else "")
            want = {"prefill_attention" + sfx: n,
                    "prefill_attention_bwd" + sfx: 3 * n}
            for r in got:
                assert r["launches"] == want, (world, name, r["launches"])
            for kernel, count in want.items():
                results.setdefault(kernel, {}).setdefault("per_path", {})[
                    f"tensor_parallel_{world.replace(' ', '_')}_rank_"
                    f"micro_batch"] = count / DP_WINDOW
            steps = len(ref["metrics"])
            model_calls = got[0]["reduce"]["model"]
            data_calls = got[0]["reduce"]["data"]
            log(f"[tensor parallel] {world} {name}: {len(got)} ranks, "
                f"{DP_B // (len(got) // n_model)} rows and "
                f"{cfg.n_heads // n_model} heads a rank, "
                f"{layers or cfg.n_layers} layers; "
                f"metrics equal across ranks, replicated weights "
                f"bit-identical across each model group; worst loss / acc "
                f"/ grad norm against the world of one {worst:.3g}, "
                f"gathered weights {w_err:.3g} (tol {tol:.3g}); window "
                f"updates more than 25 % off: at most {moved:.3g} of a "
                f"tensor's elements ({moved_name}); s a micro-batch "
                + ", ".join(f"{s:.4f}" for s in got[0]["seconds"])
                + " (world of one " + ", ".join(
                    f"{s:.4f}" for s in ref["seconds"]) + ")"
                + f"; launches a rank {got[0]['launches']}; model group "
                f"{len(model_calls) / steps:.1f} all-reduces a micro-batch, "
                f"{sum(c[0] for c in model_calls) / steps / 1e6:.2f} MB a "
                f"micro-batch a rank, "
                f"{sum(c[1] for c in model_calls) / steps:.1f} ms (CUDA "
                f"events) / {sum(c[2] for c in model_calls) / steps:.1f} ms "
                f"(host) a micro-batch; data group "
                + (f"{len(data_calls)} all-reduces, "
                   f"{sum(c[0] for c in data_calls) / steps / 1e6:.2f} MB a "
                   f"micro-batch a rank, ms a call (CUDA events) " + ", ".join(
                       f"{c[1]:.3f}" for c in data_calls) + ", host "
                   + ", ".join(f"{c[2]:.3f}" for c in data_calls)
                   if data_calls else "none (a data axis of 1)")
                + "; " + smi)
            if p and world.startswith("model"):
                first, heads, bits = got[1]["keep_bits"]
                t = S1_X_LEN + S1_Y_LENS[0]
                xl = torch.tensor(DP_X_LENS, dtype=torch.int32,
                                  device="cuda")
                yl = torch.tensor(DP_Y_LENS, dtype=torch.int32,
                                  device="cuda")
                vis = (att.build_hybrid_mask_bias(
                    S1_X_LEN, t - S1_X_LEN, xl, yl)[first, 0] == 0).cpu()
                mask = att.AttentionDropout(
                    p, (DP_SEED % 2 ** 64) ^ ATTENTION_KEY, 0).keep_mask(
                        DP_B, 2 * heads, t, S1_X_LEN, "cuda")[
                            first, heads:].cpu()
                off = int(((bits != mask) & vis).sum() + (bits & ~vis).sum())
                n_vis = int(vis.sum()) * heads
                log(f"[tensor parallel] {world} {name} model index 1, K1 "
                    f"keep bits of heads {heads}-{2 * heads - 1} (h0 "
                    f"{heads}), batch row {first}, layer 0, T={t}, read "
                    f"back: {off} of {n_vis} visible pairs off the world of "
                    f"one's mask at those heads")
                assert off == 0 and n_vis > 0
    t0 = time.perf_counter()
    times = tp_kernel_times(torch, smi)
    walls["K1 / K5 at H = 8"] = time.perf_counter() - t0
    log("[tensor parallel] walls: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()))
    for tag, got in times.items():
        sfx = "_bf16" if tag == "bf16" else ""
        for i, kernel in enumerate(("prefill_attention",
                                    "prefill_attention_bwd")):
            results.setdefault(kernel + sfx, {})["tp_h8"] = {
                key: vals[i] for key, vals in got.items()}
    log(f"[tensor parallel] phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# UVR5 vocal separation
# ---------------------------------------------------------------------------


def uvr5_random_state(torch, module, gen) -> dict:
    """Seeded random weights for a UVR5 net, on the CPU:
    ``convert.random_state_dict``'s, with every one-dimensional norm weight
    (BatchNorm, GroupNorm) and every BatchNorm running variance at
    1 + U(-0.1, 0.1), and no ``num_batches_tracked`` counter (the port's
    loaders do not read it)."""
    from easevoice_trainer_tpu_torch import convert

    state = convert.random_state_dict(module, gen)
    out = {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        if v.dim() == 1 and (k.endswith("running_var")
                             or k.endswith("weight")):
            v = 1.0 + (torch.rand(v.shape, generator=gen,
                                  device=gen.device) * 2 - 1) * 0.1
        out[k] = v.cpu()
    return out


def calibrate_batchnorm(torch, net, run) -> None:
    """Set each BatchNorm of ``net`` to the statistics of its own input in
    the forwards ``run()`` makes (the last one's), as a trained net's are:
    with random weights the stages' activations stay near unit scale."""

    def calibrate(module, args):
        x = args[0]
        dims = [d for d in range(x.dim()) if d != 1]
        module.running_mean.copy_(x.mean(dim=dims))
        module.running_var.copy_(x.var(dim=dims, unbiased=False) + 1e-3)

    hooks = [m.register_forward_pre_hook(calibrate) for m in net.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()


# (label, model name, file) of the five families' weights under
# models/uvr5_weights, in get_separator's dispatch order
UVR5_MODELS = (
    ("VR", "HP5_only_main_vocal", "HP5_only_main_vocal.pth"),
    ("DeEcho", "VR-DeEchoNormal", "VR-DeEchoNormal.pth"),
    ("MDX-Net", "UVR-MDX-NET-Inst_full", "UVR-MDX-NET-Inst_full.pth"),
    ("BS-Roformer", "model_bs_roformer_ep_317_sdr_12.9755",
     "model_bs_roformer_ep_317_sdr_12.9755.ckpt"),
    ("Mel-Band Roformer", "mel_band_roformer_vocals",
     "mel_band_roformer_vocals.ckpt"),
)
UVR5_SECONDS = (10.0, 4.0)


def write_uvr5_weights(torch, root: str, calib) -> dict:
    """Seeded random weights of the five families in their released layouts
    under ``root``: the VR net at HP5's layout (ch 32 / 16 / 32, no
    enlarge, 4band_v2), DeEcho at nout 48 (4band_v3), MDX-Net at
    ``MDXConfig()``, BS-Roformer at ``BSRoformerConfig()`` and Mel-Band at
    ``MelBandRoformerConfig()`` (each Roformer file also holds its
    attentions' ``rotary_embed.freqs``, as a released one does).  The VR and
    DeEcho BatchNorms are calibrated on ``calib`` (stereo 44.1 kHz) through
    their own separators; MDX-Net's config normalizes with GroupNorm.
    Returns {file: MB}."""
    from easevoice_trainer_tpu_torch.audiokit import bs_roformer, mdxnet, \
        uvr5, uvr5_deecho

    os.makedirs(root, exist_ok=True)
    nets = (uvr5.CascadedASPPNet(1344), uvr5_deecho.CascadedNet(1344, 48),
            mdxnet.ConvTDFNet(mdxnet.MDXConfig()),
            bs_roformer.BSRoformer(bs_roformer.BSRoformerConfig()),
            bs_roformer.MelBandRoformer(bs_roformer.MelBandRoformerConfig()))
    sizes = {}
    for i, ((label, _, name), net) in enumerate(zip(UVR5_MODELS, nets)):
        path = os.path.join(root, name)
        gen = torch.Generator(device="cuda").manual_seed(7100 + i)
        state = uvr5_random_state(torch, net, gen)
        if "Roformer" in label:
            for layer in range(net.cfg.depth):
                for axis in (0, 1):
                    state[f"layers.{layer}.{axis}.layers.0.0.rotary_embed."
                          f"freqs"] = torch.ones(net.cfg.dim_head // 2)
        torch.save(state, path)
        if label in ("VR", "DeEcho"):
            sep = (uvr5.VRSeparator(path, device="cuda") if label == "VR"
                   else uvr5.DeEchoSeparator(path, "cuda"))
            calibrate_batchnorm(torch, sep.net,
                                lambda: sep.separate(calib, 44100))
            torch.save({k: v.cpu() for k, v in sep.net.state_dict().items()
                        if not k.endswith("num_batches_tracked")}, path)
            del sep
        sizes[name] = os.path.getsize(path) / 2 ** 20
    return sizes


def check_stems(out: str, names, sources, short: int) -> None:
    """Each source's two stems under ``out``: stereo 44.1 kHz, finite,
    non-silent, as long as the source (up to ``short`` samples shorter: the
    VR synthesis ends at its top band's last whole hop)."""
    import numpy as np

    from easevoice_trainer_tpu_torch.utils import audio_io, paths

    for name in names:
        for sub, prefix in ((paths.VOCALS_OUTPUT, "vocal"),
                            (paths.ACCOMPANIMENTS_OUTPUT, "instrument")):
            data, sr = audio_io.read_wav(
                os.path.join(out, sub, f"{prefix}_{name}.wav"), mono=False)
            n = sources[name].shape[1]
            assert sr == 44100 and data.shape[0] == 2, (name, data.shape)
            assert np.isfinite(data).all() and np.abs(data).max() > 1e-3, \
                (name, prefix, float(np.abs(data).max()))
            assert 0 <= n - data.shape[1] <= short, (name, n, data.shape)


def device_groups(torch, fn, top: int = 4):
    """Device ms of one call of ``fn`` under torch.profiler: in all, in K1
    (kernels named *prefill_attention*), and the ``top`` kernel names that
    take the most, shortened."""
    events = device_events(torch, fn)
    total, by_name = 0.0, {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1000.0
        total += ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    k1 = sum(v for k, v in by_name.items() if "prefill_attention" in k)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return total, k1, [(short_name(k)[:60], v) for k, v in ranked]


def uvr5_phase(torch, tmp: str, results):
    """UVR5 vocal separation at full width through the entry points a user
    calls: seeded random weights of the five families (``write_uvr5_weights``)
    in a temporary ``models/uvr5_weights`` under the port's base path; two
    stereo 44.1 kHz song-like sources (10 s and 4 s); ``python -m
    easevoice_trainer_tpu_torch.cmd.audio_uvr5`` as a subprocess with HP5
    over both (every file SUCCESS, stems stereo 44.1 kHz, finite,
    non-silent, as long as the source); then ``AudioService.uvr5``
    in-process for each family on the 10 s source, clocked by stage (host
    analysis, the net's device work synchronized, host synthesis), with its
    peak memory, K1 launches (24 a BS-Roformer chunk, 12 a Mel-Band chunk,
    none elsewhere) and, for MDX-Net and the Roformers, vocal + instrument
    = mix; each net's device time on one window or chunk by kernel (K1's
    share for the Roformers); and each net on the card against the CPU
    (where the twins run) on that window or chunk, the Roformers at depth
    1 on the CPU side and the card side alike."""
    import numpy as np

    from easevoice_trainer_tpu_torch import ops
    from easevoice_trainer_tpu_torch.audiokit import bs_roformer, mdxnet, \
        uvr5
    from easevoice_trainer_tpu_torch.service.audio import AudioService
    from easevoice_trainer_tpu_torch.utils import audio_io, paths

    root = os.path.join(tmp, "uvr5")
    base = os.path.join(root, "base")
    src, src10 = os.path.join(root, "src"), os.path.join(root, "src10")
    os.makedirs(src)
    os.makedirs(src10)
    names = [f"song{i}.wav" for i in range(len(UVR5_SECONDS))]
    sources = {}
    for i, (name, sec) in enumerate(zip(names, UVR5_SECONDS)):
        write_song_source(os.path.join(src, name), 30 + i, sec)
        sources[name] = audio_io.read_wav(os.path.join(src, name),
                                          mono=False)[0]
    shutil.copy(os.path.join(src, names[0]), os.path.join(src10, names[0]))
    old_base = os.environ.get("EASEVOICE_BASE_PATH")
    os.environ["EASEVOICE_BASE_PATH"] = base
    try:
        t = time.perf_counter()
        sizes = write_uvr5_weights(torch, uvr5.weights_root(),
                                   sources[names[1]])
        log(f"[uvr5] random weights in the released layouts, BatchNorms "
            f"calibrated on the 4 s source, in {time.perf_counter() - t:.1f}"
            f" s: " + ", ".join(f"{k} {v:.1f} MB" for k, v in sizes.items()))

        # HP5 through the cmd, as the session manager runs it
        env = dict(os.environ, PYTHONPATH=HERE, NVIDIA_TF32_OVERRIDE="0")
        out = os.path.join(root, "cmd_out")
        resp, sub_s = run_asr_cmd({"source_dir": src, "output_dir": out,
                                   "device": "cuda"},
                                  root, env, "uvr5_hp5", "audio_uvr5")
        assert resp["status"] == "success" and \
            resp["message"] == "UVR5 Success", resp
        assert resp["data"] == {n: "success" for n in names}, resp
        check_stems(out, names, sources, 480)
        log(f"[uvr5] cmd.audio_uvr5 subprocess (HP5_only_main_vocal, the "
            f"default model): {resp['status']}, '{resp['message']}', trace "
            f"{resp['data']} for {sum(UVR5_SECONDS):.1f} s of audio in "
            f"{sub_s:.2f} s wall (the interpreter's start, the kernels' "
            f"build check and the model load included)")

        # each family in-process on the 10 s source, clocked by stage
        runs = {}
        for label, model, _ in UVR5_MODELS:
            clock = _StageClock(torch)
            first, mix_err, restore = {}, [], []

            def capture(owner, attr, label_):
                fn = getattr(owner, attr)

                def run(self, x, *args):
                    first.setdefault("call", (self, x))
                    return fn(self, x, *args)
                setattr(owner, attr, run)
                restore.append((owner, attr, fn))
                clock.wrap(owner, attr, label_)

            def check_mix(owner):
                fn = owner.separate

                def run(self, wav, sr):
                    vocal, inst = fn(self, wav, sr)
                    mix_err.append(float(np.abs(
                        vocal + inst - wav[:, :vocal.shape[1]]).max()))
                    return vocal, inst
                owner.separate = run
                restore.append((owner, "separate", fn))

            if label in ("VR", "DeEcho"):
                for attr in ("_band_specs", "_combine"):
                    clock.wrap(uvr5.VRSeparator, attr, "analysis", sync=False)
                capture(uvr5.DeEchoSeparator if label == "DeEcho"
                        else uvr5.VRSeparator, "_net_out", "net")
                clock.wrap(uvr5.VRSeparator, "_multiband_to_wave",
                           "synthesis", sync=False)
            elif label == "MDX-Net":
                clock.wrap(mdxnet.MDXSeparator, "_stft", "analysis",
                           sync=False)
                capture(mdxnet.MDXSeparator, "_run_model", "net")
                clock.wrap(mdxnet.MDXSeparator, "_istft", "synthesis",
                           sync=False)
                check_mix(mdxnet.MDXSeparator)
            else:
                cls = bs_roformer.BSRoformerSeparator
                clock.wrap(cls, "_stft", "analysis", sync=False)
                capture(cls, "_mask", "net")
                clock.wrap(cls, "_istft", "synthesis", sync=False)
                check_mix(cls)
            out = os.path.join(root, f"out_{model}")
            passes = {}
            try:
                # the process's first request of the family (weights read,
                # cuDNN plans and allocator growth), then the same again
                for pass_ in ("cold", "warm"):
                    before = dict(clock.seconds), dict(clock.calls)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    ops.reset_launch_counts()
                    t = time.perf_counter()
                    resp = AudioService(src10, out, "cuda").uvr5(model)
                    torch.cuda.synchronize()
                    passes[pass_] = dict(
                        wall=time.perf_counter() - t, resp=resp,
                        launches=ops.launch_counts(),
                        peak=torch.cuda.max_memory_allocated(),
                        seconds={k: v - before[0][k]
                                 for k, v in clock.seconds.items()},
                        calls={k: v - before[1][k]
                               for k, v in clock.calls.items()})
            finally:
                clock.undo()
                for owner, attr, fn in reversed(restore):
                    setattr(owner, attr, fn)
            for run in passes.values():
                resp = run.pop("resp")
                assert resp.ok and resp.message == "UVR5 Success", resp
                assert resp.data == {names[0]: "success"}, resp
                assert "passthrough" not in resp.message
            assert passes["cold"]["launches"] == passes["warm"]["launches"]
            short = 480 if label in ("VR", "DeEcho") else 0
            check_stems(out, names[:1], sources, short)
            runs[label] = dict(passes["warm"], cold=passes["cold"],
                               first=first["call"], mix_err=mix_err)
            if mix_err:
                assert max(mix_err) <= 1e-5, (label, mix_err)

        # launches: K1 dk 64 a Roformer chunk, nothing elsewhere
        r = results.setdefault("encoder_attention", {})
        per_chunk = {}
        for label, run in runs.items():
            k1 = run["launches"]["encoder_attention"]
            others = {k: v for k, v in run["launches"].items()
                      if v and k != "encoder_attention"}
            assert not others, (label, others)
            if "Roformer" in label:
                chunks = run["calls"]["net"]
                want = (24 if label == "BS-Roformer" else 12) * chunks
                assert k1 == want and chunks == 2, (label, k1, chunks)
                per_chunk[label] = k1 / chunks
                r["launches"] = r.get("launches", 0) + k1
                r.setdefault("per_path", {})[
                    "uvr5_" + label.lower().replace(" ", "_").replace(
                        "-", "_")] = k1
            else:
                assert k1 == 0, (label, k1)
        r["roformer"]["launches_per_chunk"] = per_chunk

        minutes = UVR5_SECONDS[0] / 60
        for label, run in runs.items():
            sec = run["seconds"]
            other = run["wall"] - sum(sec.values())
            mix = (f"; max|vocal + instrument - mix| "
                   f"{max(run['mix_err']):.3g}" if run["mix_err"] else "")
            cold = run["cold"]
            log(f"[uvr5] {label} AudioService.uvr5 on the {UVR5_SECONDS[0]:.0f}"
                f" s source, first request {cold['wall']:.3f} s wall (net "
                f"{cold['seconds']['net']:.3f} s, peak "
                f"{cold['peak'] / 2 ** 30:.2f} GiB), the same again "
                f"{run['wall']:.3f} s wall = "
                f"{run['wall'] / minutes:.3f} s a minute of audio; by stage, "
                f"s a minute: host analysis {sec['analysis'] / minutes:.3f}, "
                f"net (device, synchronized; {run['calls']['net']} calls) "
                f"{sec['net'] / minutes:.3f}, host synthesis "
                f"{sec['synthesis'] / minutes:.3f}, other (load, I/O, "
                f"windowing, copies) {other / minutes:.3f}; peak memory "
                f"{run['peak'] / 2 ** 30:.2f} GiB; K1 dk-64 launches "
                f"{run['launches']['encoder_attention']}" + mix)

        # each net's device time on its first call (all the windows of the
        # 10 s source, or one chunk), by kernel, with its peak memory; and
        # the card against the CPU on one window or chunk
        worst = 0.0
        for label, run in runs.items():
            sep, x = run["first"]
            if label in ("VR", "DeEcho"):
                fn = lambda: sep._net_out(x)                  # noqa: E731
                card_net, inp = sep.net, x[:1]
            elif label == "MDX-Net":
                fn = lambda: sep._run_model(x)                # noqa: E731
                card_net, inp = sep.net, torch.from_numpy(x[:1]).cuda()
            else:
                fn = lambda: sep._mask(x)                     # noqa: E731
                cfg = dataclasses.replace(sep.cfg, depth=1)
                card_net = type(sep.net)(cfg)
                full = sep.net.state_dict()
                card_net.load_state_dict(
                    {k: full[k] for k in card_net.state_dict()}, strict=True)
                card_net = card_net.cuda().eval()
                inp = torch.from_numpy(x).cuda()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            total, k1, top = device_groups(torch, fn)
            peak = torch.cuda.max_memory_allocated()
            share = (f", K1 {k1:.3f} ms = {100 * k1 / total:.1f} %"
                     if k1 else "")
            unit = "a chunk" if "Roformer" in label else "its windows"
            neg = ", and its negation" if label == "MDX-Net" else ""
            log(f"[uvr5] {label} net, one call on {unit} (input "
                f"{tuple(x.shape)}{neg}): "
                f"device {total:.3f} ms{share}, peak memory "
                f"{peak / 2 ** 30:.2f} GiB; top kernels: "
                + ", ".join(f"{n} {v:.3f}" for n, v in top))
            if "Roformer" in label:
                r["roformer"].setdefault("chunk_device_ms", {})[label] = \
                    dict(total=total, k1=k1)
            cpu_net = copy.deepcopy(card_net).cpu()
            with torch.no_grad():
                got = card_net(inp).cpu()
                want = cpu_net(inp.cpu())
            rel = float((got - want).abs().max()) / max(
                1.0, float(want.abs().max()))
            worst = max(worst, rel)
            depth = " at depth 1" if "Roformer" in label else ""
            log(f"[uvr5] {label} net{depth} on the card against the CPU, "
                f"input {tuple(inp.shape)}: relative max|d| {rel:.3g} "
                f"(tol 1e-4)")
            assert rel <= 1e-4, (label, rel)
            del cpu_net, card_net, inp, sep
            run.pop("first")
        log(f"[uvr5] every family: card vs CPU within {worst:.3g} relative")
    finally:
        if old_base is None:
            os.environ.pop("EASEVOICE_BASE_PATH", None)
        else:
            os.environ["EASEVOICE_BASE_PATH"] = old_base


# ---------------------------------------------------------------------------
# phase 13, rest: the port's server, driven over HTTP as a user drives it
# ---------------------------------------------------------------------------

# the modules no process of the port may load: the JAX package and the
# libraries the card's machine lacks
FOREIGN = ("easevoice_trainer_tpu", "jax", "jaxlib", "flax", "yaml",
           "transformers", "safetensors", "aiohttp", "psutil")

# put on the server's PYTHONPATH as sitecustomize.py: the server and every
# task process it starts refuse to import a FOREIGN module
REFUSE_HOOK = f'''import importlib.abc, sys
FOREIGN = {FOREIGN!r}
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FOREIGN:
            raise ImportError(f"refused import of {{name}} (chip_smoke)")
        return None
sys.meta_path.insert(0, _Refuse())
'''


class _Rest:
    """A urllib client of the server at ``url``; every request's wall on
    the host clock goes on a "[rest]" line."""

    def __init__(self, url: str):
        self.url = url
        self.walls = []

    def __call__(self, method: str, path: str, body=None, query=None,
                 quiet: bool = False):
        import urllib.error
        import urllib.parse
        import urllib.request

        if query:
            path += "?" + urllib.parse.urlencode(query)
        req = urllib.request.Request(
            self.url + "/apis/v1" + path, method=method,
            data=None if body is None else json.dumps(body).encode())
        t = time.perf_counter()
        try:
            resp = urllib.request.urlopen(req, timeout=120)
        except urllib.error.HTTPError as e:
            resp = e
        with resp:
            payload = resp.read()
            ctype = resp.headers.get("Content-Type", "")
        wall = time.perf_counter() - t
        if not quiet:
            self.walls.append((f"{method} {path.split('?')[0]}", wall))
            log(f"[rest] {method} {path} -> {resp.status} in "
                f"{wall * 1000:.1f} ms")
        if ctype.startswith("application/json"):
            payload = json.loads(payload)
        return resp.status, payload

    def wait(self, uid: str, timeout: float, what: str, poll: float = 0.5,
             on_poll=None):
        """Poll /session/current until the task ``uid`` ends; -> (session,
        wall s from the first poll)."""
        t = time.perf_counter()
        while True:
            _, info = self("GET", "/session/current", quiet=True)
            assert info.get("uuid") == uid, info
            if on_poll is not None:
                on_poll(info)
            if info["status"] != "Running":
                wall = time.perf_counter() - t
                log(f"[rest] {what}: {info['status']} after {wall:.2f} s of "
                    f"polling: '{info.get('message')}'")
                return info, wall
            assert time.perf_counter() - t < timeout, \
                f"{what} still running after {timeout} s: {info}"
            time.sleep(poll)


def _alive(pid: int) -> bool:
    """False once ``pid`` is gone or a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return False
    return stat[stat.rindex(")") + 2] != "Z"


def _symbol(name: str) -> str:
    """A demangled kernel name without its parameter list."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if name.endswith(")") else name
    return name


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode()[:120].strip()
    except OSError:
        return "?"


def _gpu_pids() -> list:
    proc = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return [int(p) for p in proc.stdout.split()]


def card_used_gib(torch) -> float:
    """The whole card's used memory, every process's (mem_get_info)."""
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 2 ** 30


def trace_kernels(path: str) -> dict:
    """name -> count of the device kernel records in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


# the REST path's kernels by the symbol in their device records: K1's
# GPT instance (dk 32), its dk-64 instance (the clone's HuBERT), K2, K3
TRACE_KERNELS = (("prefill_attention", "prefill_attention_kernel<32, false>"),
                 ("encoder_attention", "prefill_attention_kernel<64, false>"),
                 ("decode_attention", "decode_attention_kernel"),
                 ("mrf_conv", "conv_mma_kernel"))


def rest_base(tmp: str, base: str) -> dict:
    """The server's installation: ``base`` with configs/ (the repo's s2.json
    with ``log_interval`` 1, so that each step's loss reaches the session,
    and gpt.yaml) and models/ linking to the weights the earlier phases
    wrote (UVR5, FRCRN, the ASR nets); -> the environment's model paths
    (BERT, HuBERT, the pretrained s2G and GPT)."""
    os.makedirs(os.path.join(base, "configs"))
    with open(os.path.join(HERE, "configs", "s2.json")) as f:
        s2 = json.load(f)
    s2["train"]["log_interval"] = 1
    with open(os.path.join(base, "configs", "s2.json"), "w") as f:
        json.dump(s2, f, indent=2)
    shutil.copy(os.path.join(HERE, "configs", "gpt.yaml"),
                os.path.join(base, "configs"))
    models = os.path.join(base, "models")
    links = {
        "uvr5_weights": os.path.join(tmp, "uvr5", "base", "models",
                                     "uvr5_weights"),
        "denoise/speech_frcrn_ans_cirm_16k": os.path.join(
            tmp, "prep", "speech_frcrn_ans_cirm_16k"),
        "asr/paraformer-zh": os.path.join(tmp, "asr", "models",
                                          "paraformer-zh"),
        "asr/fsmn-vad": os.path.join(tmp, "asr", "models", "fsmn-vad"),
        "asr/ct-punc": os.path.join(tmp, "asr", "models", "ct-punc"),
        "whisper": os.path.join(tmp, "asr", "models", "whisper-small")}
    for name, target in links.items():
        assert os.path.exists(target), target
        os.makedirs(os.path.dirname(os.path.join(models, name)),
                    exist_ok=True)
        os.symlink(target, os.path.join(models, name))
    env = {"bert_path": os.path.join(tmp, "chinese-roberta-wwm-ext-large"),
           "cnhubert_path": os.path.join(tmp, "prep",
                                         "chinese-hubert-base"),
           "sovits_path": os.path.join(tmp, "prep", "s2G_random.pth"),
           "gpt_path": os.path.join(tmp, "prep", "s1_random.ckpt")}
    for path in env.values():
        assert os.path.exists(path), path
    return env


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rest_phase(torch, tmp: str, results):
    """The port's REST server at full width, as a user drives it: ``python
    -m easevoice_trainer_tpu_torch.main --dry-run``, then the server on the
    card (every process of it under an import hook refusing FOREIGN)
    answering: /session, a namespace and an uploaded reference; normalize
    (en rows over phase 7's denoised clips), the s2 and s1 fine-tunes (a
    second start 409), the model list; two greedy voice clones of the two
    trained models, the first under /profiler (K1, K2 and K3 counted in its
    device records); a stopped s2 run whose process tree is gone; easy mode
    over a 10 s song (Completed where jieba imports, else Failed at step 5
    naming jieba); the TensorBoard proxy."""
    from easevoice_trainer_tpu_torch.service.session import descendants

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    root = os.path.join(tmp, "rest")
    base = os.path.join(root, "base")
    hook = os.path.join(root, "hook")
    os.makedirs(hook)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(REFUSE_HOOK)
    env = dict(os.environ, **rest_base(tmp, base))
    for k in ("EASEVOICE_FRCRN_PATH", "EASEVOICE_PARAFORMER_DIR",
              "EASEVOICE_VAD_DIR", "EASEVOICE_PUNC_DIR",
              "EASEVOICE_WHISPER_DIR", "EASEVOICE_ALLOW_PASSTHROUGH"):
        env.pop(k, None)
    port = free_port()
    env.update(PYTHONPATH=hook + os.pathsep + HERE,
               EASEVOICE_BASE_PATH=base, EASEVOICE_PORT=str(port),
               EASEVOICE_TRAINER_NAMESPACES_ROOT=os.path.join(root, "ns"),
               NVIDIA_TF32_OVERRIDE="0")
    main_cmd = [sys.executable, "-m", "easevoice_trainer_tpu_torch.main"]

    t = time.perf_counter()
    proc = subprocess.run(main_cmd + ["--dry-run"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "dry-run: server started OK" in \
        proc.stderr, (proc.returncode, proc.stderr[-3000:])
    log(f"[rest] main.py --dry-run: exit 0 in {time.perf_counter() - t:.2f}"
        f" s (the interpreter's start and the imports included)")

    gc.collect()
    torch.cuda.empty_cache()      # UVR5's cuDNN workspaces need the room
    log(f"[rest] card memory in use before the server (every process): "
        f"{card_used_gib(torch):.2f} GiB")
    server_log = open(os.path.join(root, "server.log"), "w")
    t = time.perf_counter()
    server = subprocess.Popen(main_cmd, cwd=root, env=env, stdout=server_log,
                              stderr=subprocess.STDOUT)
    rest = _Rest(f"http://127.0.0.1:{port}")
    try:
        while True:
            try:
                status, _ = rest("GET", "/session/current", quiet=True)
                break
            except OSError:
                assert server.poll() is None, "the server exited"
                assert time.perf_counter() - t < 300, "no server after 300 s"
                time.sleep(0.2)
        log(f"[rest] server up on :{port} (pid {server.pid}) after "
            f"{time.perf_counter() - t:.2f} s")
        _rest_drive(torch, rest, root, tmp, kind, server.pid, results)
    except Exception:
        server_log.flush()
        with open(os.path.join(root, "server.log")) as f:
            log("[rest] server log, last lines:\n" + "".join(
                f.readlines()[-60:]))
        raise
    finally:
        for pid in descendants(server.pid):
            try:
                os.kill(pid, 15)
            except OSError:
                pass
        server.terminate()
        try:
            server.wait(30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
        server_log.close()
    total = time.perf_counter() - t_phase
    log(f"[rest] phase wall {total:.1f} s; request walls (host clock): "
        + ", ".join(f"{k} {v * 1000:.1f} ms" for k, v in rest.walls))


def _rest_drive(torch, rest, root, tmp, kind, server_pid, results):
    import base64

    import numpy as np

    from easevoice_trainer_tpu_torch.service.session import descendants
    from easevoice_trainer_tpu_torch.utils import paths

    # the session and its monitor metrics
    status, info = rest("GET", "/session")
    metrics = info["monitor_metrics"]
    log(f"[rest] monitor_metrics {metrics}")
    assert status == 200 and metrics["accelerator"] == kind, metrics
    assert metrics["memory_allocated_percentage"].endswith("%"), metrics

    # a namespace and the reference clip uploaded into its voices/
    status, ns = rest("POST", "/namespaces", {"name": "rest"})
    assert status == 200, ns
    home = ns["homePath"]
    voices = os.path.join(home, "voices")
    with open(os.path.join(tmp, "ref.wav"), "rb") as f:
        content = base64.b64encode(f.read()).decode()
    status, body = rest("POST", "/files", {
        "directoryPath": voices, "fileName": "ref.wav",
        "fileContent": content})
    assert status == 200, body
    ref = os.path.join(voices, "ref.wav")
    assert read_wav(ref)[0].size == 5 * 32000

    # normalize: phase 7's denoised clips, an en row each (no jieba needed)
    work = os.path.join(root, "work")
    src = os.path.join(tmp, "prep", "work", paths.DENOISES_OUTPUT)
    clips = sorted(os.listdir(src))
    shutil.copytree(src, os.path.join(work, paths.DENOISES_OUTPUT))
    for i, name in enumerate(clips):
        status, body = rest("POST", "/audio/refinement", {
            "source_dir": work, "output_dir": work,
            "source_file_path": os.path.join(work, paths.DENOISES_OUTPUT,
                                             name),
            "language": "en", "text_content": SENTENCES[i % len(SENTENCES)]},
            quiet=i > 0)
        assert status == 200 and body["status"] == "success", body
    status, body = rest("POST", "/normalize/start",
                        {"processing_path": work, "device": "cpu"})
    assert status == 200, body
    info, wall = rest.wait(body["uuid"], 600, "normalize")
    assert info["status"] == "Completed", info
    assert info["request"]["device"] == "cuda", info["request"]
    norm = body["data"]["normalize_path"]
    assert info["data"]["output_path"] == norm
    for name in (paths.TEXT_OUTPUT_NAME, paths.SSL_OUTPUT, paths.WAV_OUTPUT,
                 paths.SEMANTIC_OUTPUT):
        assert os.path.exists(os.path.join(norm, name)), name
    assert len(os.listdir(os.path.join(norm, paths.SSL_OUTPUT))) == \
        len(clips)
    log(f"[rest] normalize of {len(clips)} clips (en rows): {wall:.2f} s "
        f"from start to Completed; the folder holds 2-name2text, "
        f"4-cnhubert, 5-wav32k and 6-name2semantic")

    # the fine-tunes, each then a second start (409)
    # (one epoch each at B = 8: the loaders replicate a small folder,
    # enough s1 micro-batches for a loss line every 10)
    trained = {}
    for route, name, suffix in (("sovits", "rest_s2", ".pth"),
                                ("gpt", "rest_s1", ".ckpt")):
        body_in = dict(train_input_dir=norm, project_dir=home,
                       output_model_name=name, batch_size=8, total_epochs=1,
                       save_every_epoch=1)
        status, body = rest("POST", f"/train/{route}/start", body_in)
        assert status == 200, body
        status2, again = rest("POST", f"/train/{route}/start", body_in)
        assert status2 == 409, (status2, again)
        info, wall = rest.wait(body["uuid"], 900, f"train {route}")
        assert info["status"] == "Completed", info
        assert info["request"]["device"] == "cuda", info["request"]
        losses = info.get("losses", [])
        assert losses and all(math.isfinite(x["loss"]) for x in losses), \
            info
        path = info["data"]["model_path"]
        assert path.endswith(suffix) and os.path.exists(path), path
        trained[route] = os.path.basename(path)
        log(f"[rest] train {route}: {wall:.2f} s from start to Completed "
            f"({info['data']['global_step']} steps of B=8, one epoch); losses "
            + ", ".join(f"{x['step']}: {x['loss']:.3f}" for x in losses)
            + f"; {os.path.basename(path)}")
    status, models = rest("GET", "/voiceclone/models",
                          query={"project_dir": home})
    assert status == 200 and trained["sovits"] in models["sovits"] and \
        trained["gpt"] in models["gpts"], models

    # two greedy clones of the trained models, the first profiled
    clone = dict(
        text=" ".join(SENTENCES[:2]), text_lang="en", ref_audio_path=ref,
        prompt_text="", text_split_method="by_english_period", batch_size=2,
        top_k=1, seed=1234, keep_random=False,
        sovits_path=trained["sovits"], gpt_path=trained["gpt"],
        project_dir=home, output_dir=os.path.join(home, "outputs"))
    status, body = rest("POST", "/profiler/start")
    assert status == 200, body
    trace_dir = body["trace_dir"]
    walls, used = [], []
    for i in range(2):
        t = time.perf_counter()
        status, body = rest("POST", "/voiceclone/clone", clone)
        assert status == 200, body
        info, _ = rest.wait(body["uuid"], 600, f"clone {i + 1}", poll=0.1)
        walls.append(time.perf_counter() - t)
        assert info["status"] == "Completed", info
        if i == 0:
            t = time.perf_counter()
            status, body = rest("POST", "/profiler/stop")
            assert status == 200, body
            traces = sorted(os.listdir(trace_dir))
            assert len(traces) == 1, traces
            counts = trace_kernels(os.path.join(trace_dir, traces[0]))
            log(f"[rest] profiler stop and the trace read in "
                f"{time.perf_counter() - t:.2f} s; "
                f"{os.path.getsize(os.path.join(trace_dir, traces[0])) / 2 ** 20:.1f}"
                f" MiB; {sum(counts.values())} kernel records")
        used.append(card_used_gib(torch))
        wav, sr = read_wav(info["data"]["output_path"])
        assert sr == 32000 and wav.size > 0 and np.isfinite(wav).all()
        assert np.abs(wav).max() > 0, "silent clone"
        log(f"[rest] clone {i + 1}: {walls[-1]:.2f} s from the request to "
            f"Completed (a fresh TTS built in the server), "
            f"{wav.size / sr:.2f} s of audio; card memory in use after it "
            f"(every process, mem_get_info) {used[-1]:.2f} GiB")
    found = {}
    for key, symbol in TRACE_KERNELS:
        found[key] = sum(n for name, n in counts.items() if symbol in name)
        results[key].setdefault("per_path", {})["rest_clone_trace"] = \
            found[key]
    named = {_symbol(n) for n in counts
             if any(s in n for _, s in TRACE_KERNELS)}
    log(f"[rest] the first clone's device records: " + ", ".join(
        f"{k} {v}" for k, v in found.items()) + "; kernels named: "
        + ", ".join(sorted(named)))
    for key in ("prefill_attention", "decode_attention", "mrf_conv"):
        assert found[key] > 0, f"{key} absent from the clone's trace"

    # a stop: a long s2 run, stopped after its first loss (the server's
    # other children, TensorBoard's for one, are not the run's)
    others = set(descendants(server_pid))
    status, body = rest("POST", "/train/sovits/start", dict(
        train_input_dir=norm, project_dir=home, output_model_name="rest_stop",
        batch_size=4, total_epochs=100, save_every_epoch=100))
    assert status == 200, body
    uid = body["uuid"]
    t = time.perf_counter()
    while True:
        _, info = rest("GET", "/session/current", quiet=True)
        if info.get("losses"):
            break
        assert info["status"] == "Running", info
        assert time.perf_counter() - t < 600, "no loss after 600 s"
        time.sleep(0.2)
    tree = [p for p in descendants(server_pid) if p not in others]
    gpu_before = _gpu_pids()
    log(f"[rest] the s2 run's first loss after {time.perf_counter() - t:.2f}"
        f" s; its processes {[(p, _cmdline(p)) for p in tree]}; nvidia-smi "
        f"compute apps (pids as its namespace sees them) {gpu_before}")
    assert tree
    status, body = rest("DELETE", "/train/sovits/stop", query={"uid": uid})
    assert status == 200 and body["message"] == "Task stopped by user.", \
        body
    t = time.perf_counter()
    while any(_alive(p) for p in tree):
        assert time.perf_counter() - t < 15, \
            [p for p in tree if _alive(p)]
        time.sleep(0.1)
    gone = time.perf_counter() - t
    # nvidia-smi may list pids of another pid namespace: the run's card
    # context is gone when its list is one shorter
    while True:
        gpu_after = _gpu_pids()
        if len(gpu_after) == len(gpu_before) - 1:
            break
        assert time.perf_counter() - t < 15, (gpu_before, gpu_after)
        time.sleep(0.5)
    released = time.perf_counter() - t
    time.sleep(1.0)
    _, info = rest("GET", "/session/current")
    assert info["uuid"] == uid and info["status"] == "Completed" and \
        info["message"] == "Task stopped by user." and \
        info["error"] is None, info
    log(f"[rest] stop: the run's processes {tree} gone from /proc "
        f"{gone:.2f} s and its card context from nvidia-smi's list "
        f"{released:.2f} s after the answer ({gpu_before} -> {gpu_after}); "
        f"the session reads Completed, 'Task stopped by user.'")

    # easy mode over a 10 s song
    try:
        import jieba  # noqa: F401
        route = "jieba"
    except ImportError:
        route = "no jieba"
    song = os.path.join(root, "song")
    os.makedirs(song)
    write_song_source(os.path.join(song, "song.wav"), 50, 10.0)
    gc.collect()
    torch.cuda.empty_cache()
    peak = [card_used_gib(torch)]
    status, body = rest("POST", "/easevoice/start",
                        {"source_dir": song, "project_dir": home})
    assert status == 200, body
    info, wall = rest.wait(
        body["uuid"], 900, "easy mode", poll=0.25,
        on_poll=lambda _: peak.append(card_used_gib(torch)))
    outs = [d for d in os.listdir(song) if d.startswith("easy_mode_")]
    assert len(outs) == 1, outs
    out = os.path.join(song, outs[0])
    made = {d: len(os.listdir(os.path.join(out, d))) for d in (
        paths.VOCALS_OUTPUT, paths.SLICES_OUTPUT, paths.DENOISES_OUTPUT,
        paths.ASRS_OUTPUT) if os.path.isdir(os.path.join(out, d))}
    log(f"[rest] easy mode route: {route} ("
        + ("jieba imports: all seven steps must complete"
           if route == "jieba" else
           "jieba does not import here: the zh normalize step must fail on "
           "it, after steps 1-4") + f"); {info['status']} after {wall:.2f} s"
        f", step {info.get('current_step')} of {info.get('total_steps')}, "
        f"progress {info.get('progress')}, '{info.get('current_step_description')}'"
        f"; artifacts {made}; card memory in use, every process: "
        f"{peak[0]:.2f} GiB before, peak {max(peak):.2f} GiB over "
        f"{len(peak) - 1} samples")
    assert all(made.get(d) for d in (
        paths.VOCALS_OUTPUT, paths.SLICES_OUTPUT, paths.DENOISES_OUTPUT,
        paths.ASRS_OUTPUT)), made
    if route == "jieba":
        assert info["status"] == "Completed", info
        assert set(info["data"]) == {"sovits_output", "gpt_output"}, info
        assert all(os.path.exists(p) for p in info["data"].values()), info
    else:
        assert info["status"] == "Failed", info
        assert info["current_step"] == 5, info
        assert abs(info["progress"] - 4 / 7 * 100) < 1e-9, info
        assert "No module named 'jieba'" in info["error"], info
        assert info["error"].startswith("Normalization failed: "), info

    # the TensorBoard proxy: 502 without the binary; with it, the server
    # started TensorBoard on :6006, which may take seconds to answer
    binary = shutil.which("tensorboard")
    t = time.perf_counter()
    while True:
        status, body = rest("GET", "/tensorboard/")
        if binary is None or status != 502 or \
                time.perf_counter() - t > 60:
            break
        time.sleep(2)
    log(f"[rest] tensorboard binary {binary or 'not on PATH'}: the proxy "
        f"answered {status}" + (f" ({len(body)} bytes proxied)"
                                if status != 502 else f": {body}"))
    if binary is None:
        assert status == 502, (status, body)
    else:
        assert status != 502, (status, body)


def load_parent(root: str):
    """The port package of another checkout at ``root`` (the parent commit
    unpacked with ``git archive``), imported as ``ev_parent`` beside this
    tree's package, with its kernel library built."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "easevoice_trainer_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "ev_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["ev_parent"] = mod
    spec.loader.exec_module(mod)
    for name in ("ops.attention", "ops.build", "models.gpt"):
        importlib.import_module(f"ev_parent.{name}")
    lib = mod.ops.build.build()
    log(f"[parent] {pkg} imported as ev_parent; kernels {lib.path} built in "
        f"{lib.build_seconds:.1f} s")
    return mod


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="root of another checkout (the parent commit "
                         "unpacked with git archive): its K1-K5 and GPT "
                         "are timed beside this tree's, in turns")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "easevoice_trainer_tpu_torch")):
        print("chip_smoke: the easevoice_trainer_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    results = {}
    marks = []

    def enter(name: str) -> str:
        """Logs the wall of the phase that ends here; -> ``name``."""
        now = time.perf_counter()
        if marks:
            log(f"[time] phase '{marks[-1][0]}' {now - marks[-1][1]:.1f} s")
        marks.append((name, now))
        return name

    phase = enter("device")
    t_run = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}; matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32}")

        phase = enter("build")
        from easevoice_trainer_tpu_torch.ops import build

        lib = build.build()
        log(f"[build] {lib.path} in {lib.build_seconds:.1f} s")
        for line in lib.build_log.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma")):
                log(f"[build] {line.strip()}")

        parent = None
        if args.parent:
            phase = enter("parent build")
            parent = load_parent(args.parent)

        phase = enter("kernels")
        check_kernels(torch, results, parent and parent.ops.attention)
        check_encoder(torch, results)
        check_encoder_asr(torch, results)
        check_encoder_roformer(torch, results)
        check_k4(torch, results)
        check_k5(torch, results, parent and parent.ops.attention)
        phase = enter("bf16 kernels")
        check_bf16(torch, results, parent and parent.ops.attention)
        phase = enter("dropout kernels")
        check_dropout(torch, results, parent and parent.ops.attention)
        if parent is not None:
            phase = enter("mrf a/b")
            ab_mrf(torch, parent)
            phase = enter("sass a/b")
            ab_sass(args.parent)
        phase = enter("serving")
        tts = serve(torch, tmp, results)
        phase = enter("serving profile")
        profile_gpt(torch, tts.t2s, parent)
        phase = enter("reference")
        reference_check(torch, tts)
        del tts
        gc.collect()
        torch.cuda.empty_cache()
        phase = enter("chinese serving")
        serve_chinese(torch, tmp, results)
        gc.collect()
        torch.cuda.empty_cache()
        phase = enter("data prep")
        data_prep(torch, tmp, results)
        gc.collect()
        torch.cuda.empty_cache()
        phase = enter("uvr5")
        uvr5_phase(torch, tmp, results)
        gc.collect()
        torch.cuda.empty_cache()
        phase = enter("training")
        train(torch, tmp, results)
        phase = enter("reference train step")
        reference_train_step(torch)
        gc.collect()
        torch.cuda.empty_cache()
        phase = enter("s1 training")
        trainer = train_s1(torch, tmp, results)
        phase = enter("s1 dpo")
        s1_dpo_micro_batch(torch, trainer)
        phase = enter("s1 profile")
        profile_s1_window(torch, trainer)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        phase = enter("s1 dropout")
        train_s1_dropout(torch, tmp, results, parent)
        gc.collect()
        torch.cuda.empty_cache()
        phase = enter("data parallel")
        data_parallel(torch, results)
        gc.collect()
        torch.cuda.empty_cache()
        phase = enter("tensor parallel")
        tensor_parallel(torch, results)
        phase = enter("reference s1 step")
        reference_s1_step(torch)
        gc.collect()
        torch.cuda.empty_cache()
        phase = enter("rest")
        rest_phase(torch, tmp, results)
        phase = enter("isolation")
        from easevoice_trainer_tpu_torch import native

        foreign = sorted(m for m in sys.modules
                         if m.split(".")[0] in FOREIGN)
        log(f"[isolation] after serving English and Chinese text, resampling "
            f"the reference clip (native resampler built: "
            f"{native.available()}), separating vocals with UVR5 (the VR "
            f"and DeEcho nets, MDX-Net, BS- and Mel-Band Roformer), "
            f"preparing a dataset (slicer, FRCRN, "
            f"the ASR chain (fsmn-VAD, Paraformer, CT-punc, Whisper; its "
            f"config.yaml files read by the port's reader, Whisper's "
            f"tokenizer the port's own), the three normalization stages, "
            f"2 + 2 training steps on it), "
            f"12 s2 training steps and 12 s1 micro-batches in bf16 and "
            f"again in fp32, and driving "
            f"the REST server (whose processes ran under a hook refusing "
            f"the same modules), modules of {', '.join(FOREIGN)} loaded "
            f"here: {foreign}")
        assert not foreign, foreign
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    enter("end")
    log(f"[run] every phase passed in {time.perf_counter() - t_run:.1f} s "
        f"(the kernels' build included)")
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": r["launches"],
                        "launches_per_path": r["per_path"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        for extra in ("warm_ms", "s1", "calls", "launches_per_call",
                      "whisper_T1500", "roformer", "fp32_ms",
                      "max_rel_err", "graph_ms", "without_dropout_ms",
                      "rng_floor_ms", "keep_rate", "mask_readout", "tp_h8",
                      "parent_ms"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
