#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py                   # what a check of the port runs
    python3 chip_smoke.py --parent DIR      # + an A/B against another tree

``--parent`` takes the root of another checkout (the parent commit unpacked
with ``git archive`` into a git-ignored directory); its package is imported
beside this one as ``ev_parent`` and its K1-K5 and GPT decode are timed in
turns with this tree's on the same inputs (lines "[a/b]"; K1's serving
output, K3 and K4-dx also compared bit for bit, K3 and K4-dx by SASS, K4-dW
per Generator stage, K5 over the two s1 shapes).

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
   slower than SDPA's backward;
4. serving: ``VoiceCloneService.clone`` at full model width (random weights
   from a seeded ``torch.Generator``, written to .pth files and loaded the way
   a user's trained models are), a synthetic 5 s reference and six English
   sentences; the wav must be finite and non-silent, every weight on the
   card, and K1, K2 and K3 launched during this phase.  Then one prefill
   and 16 decode steps of the same GPT under torch.profiler: K1's and K2's
   device time a launch and the kernels a decode step launches;
5. reference: the same models on the card and on the CPU (where the plain
   twins run) agree on a small input;
6. training: ``SovitsTrain.train()`` at full width (SovitsConfig() and the
   full MPD from seeded random pretrained .pth files, 8 synthetic clips of
   256 frames, batch 8, 12 steps): finite losses, every tensor on the card,
   K3 and both K4 entry points launched, every ResBlock ``weight_v`` and
   upsample tensor changed, and the export loads ``strict=True`` into the
   inference build and decodes a finite, non-silent wav;
7. reference train step: one step at a small width on the card and on the
   CPU agrees (losses and the ResBlock gradients);
8. s1 training: ``GPTTrain.train()`` at full width (T2SConfig from the
   repo's configs/gpt.yaml through the port's YAML reader, a seeded random
   pretrained .ckpt in the export format, 8 synthetic utterances of 250 and
   1300 tokens replicated to 96 items: 12 micro-batches of B=8 at T = 716
   and 1776, 3 ScaledAdam updates): finite losses, every tensor and
   optimizer state on the card, 24 K1 launches and 24 K5 calls (72
   launches) a micro-batch, every layer's ``in_proj_weight`` changed, the export loads
   ``strict=True`` into the inference build and decodes; s/micro-batch by
   bucket, first micro-batch, peak memory, and one accumulation window
   under torch.profiler by group (K1, K5, GEMMs, optimizer, other);
9. reference s1 step: one micro-batch at a small width on the card and on
   the CPU agrees (loss and every qkv gradient).

After training it checks that no module of the JAX package, jax, flax or
yaml was loaded in the whole run.  Two lines before the last hold one JSON
object with each kernel's launches (in all, per serving clone, per s2 step
and per s1 micro-batch),
error, device times and bound; the line before the last is the card's name
and power limit as ``nvidia-smi`` gives them, and the last line is the
run's verdict ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the repository beside this file, it exits non-zero and prints no
verdict.
"""
from __future__ import annotations

import copy
import functools
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import wave

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


def device_events(torch, fn, attempts: int = 3):
    """The CUDA kernels and copies torch.profiler records over one call of
    ``fn`` (synchronised at its end).  Now and then a profiler session comes
    back with no device activity at all (seen once in ~150 sessions on an
    H100); ``fn`` is then profiled again, up to ``attempts`` sessions in all,
    and it raises after that."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        if device:
            return device
        log(f"[timer] torch.profiler session {attempt} of {attempts} "
            f"recorded no CUDA activity")
    raise RuntimeError("torch.profiler recorded no CUDA activity")


def device_ms(torch, fn, name=None, reps: int = 20) -> float:
    """Mean device time of one call of ``fn``: the CUDA kernels and copies
    torch.profiler records over ``reps`` calls after a warm-up, divided by
    ``reps``; with ``name``, only the kernels whose name holds it."""
    fn()
    torch.cuda.synchronize()
    device = device_events(torch, lambda: [fn() for _ in range(reps)])
    if name is not None:
        device = [e for e in device if name in e.name]
        if not device:
            raise RuntimeError(f"torch.profiler recorded no kernel named "
                               f"*{name}*")
    return sum(e.time_range.elapsed_us() for e in device) / 1000.0 / reps


def in_turns(torch, fn, old, name=None):
    """Device ms of ``fn`` and of ``old``, the same call on the parent
    commit's package, timed in turns (old, new, new, old), each the mean of
    its two sessions; (ms, None) without ``old``."""
    if old is None:
        return device_ms(torch, fn, name), None
    first = device_ms(torch, old, name)
    new = device_ms(torch, fn, name) + device_ms(torch, fn, name)
    return new / 2, (first + device_ms(torch, old, name)) / 2


class Bound:
    """Least device time of a set of calls: per call, the larger of the
    bytes it must move (each input read once, each output written once)
    over HBM_BYTES_PER_S and its fp32 operations over FP32_OPS_PER_S."""

    def __init__(self):
        self.ms = self.bytes_ms = self.ops_ms = 0.0

    def add(self, nbytes: float, flops: float) -> None:
        b = nbytes / HBM_BYTES_PER_S * 1e3
        o = flops / FP32_OPS_PER_S * 1e3
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
    with this tree's on the same inputs."""
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
    assert tensor.get("dq_kernel") and tensor.get("dkdv_kernel"), tensor

    gen = torch.Generator(device="cuda").manual_seed(6006)
    b, h, dk, x_len = S1_B, 16, 32, S1_X_LEN
    tol = 1e-4
    sums = {"k1": [0.0, 0.0, 0.0], "k5": [0.0, 0.0, 0.0]}
    bounds = {"k1": Bound(), "k5": Bound()}
    worst = {"k1": 0.0, "k5": 0.0}
    worst_rel = 0.0
    ab = [0.0, 0.0]   # K5 in turns: this tree, the parent
    ab_rel = 0.0
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
            f"/ max(1, max|parent|) {ab_rel:.3g}")
    kern, lib = sums["k5"][0], sums["k5"][2]
    assert kern <= lib, (f"K5 ({kern:.4f} ms) is slower than SDPA's "
                         f"backward ({lib:.4f} ms)")
    results["prefill_attention"]["s1"] = dict(
        ms=sums["k1"][0], plain_ms=sums["k1"][1], library_ms=sums["k1"][2],
        max_abs_err=worst["k1"], **bounds["k1"].result())
    results["prefill_attention_bwd"] = dict(
        max_abs_err=worst["k5"], ms=sums["k5"][0], plain_ms=sums["k5"][1],
        library_ms=sums["k5"][2], **bounds["k5"].result())


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

    m = re.search(r"(wgrad_\w+?_kernel|conv_mma_kernel|dsum_kernel|"
                  r"dkdv_kernel|dq_kernel)((?:I?Li-?\d+E)*)", mangled)
    if not m:
        return mangled
    args = re.findall(r"Li(-?\d+)E", m.group(2))
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def ab_mrf(torch, parent):
    """K3 and K4 of this tree against the parent's (``--parent``).  K3 and
    K4-dx run the same loop (conv_mma_kernel): its SASS in the two kernel
    libraries, its outputs on the same inputs bit for bit, and its device
    time summed over check_kernels' 45 K3 shapes (B=4) and check_k4's 45 K4
    shapes (B=8), timed in turns.  K4-dW: the largest difference between
    the two trees' dW / db relative to the parent's largest magnitude, and
    the device time of each Generator stage's 9 shapes, timed in turns."""
    from easevoice_trainer_tpu_torch.ops import build, mrf

    new, old = (sass_functions(lib.path, ("conv_mma_kernel",))
                for lib in (build.build(), parent.ops.build.build()))
    same = sum(sorted(new[n]) == sorted(old.get(n, [])) for n in new)
    log(f"[a/b] SASS of the K3/K4-dx loop (conv_mma_kernel): {len(new)} "
        f"functions in this tree's library, {len(old)} in the parent's, "
        f"identical: {same}")

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
    for ch, t_len in S2_STAGES:
        x, dy = (torch.randn((8, ch, t_len), generator=gen, device="cuda")
                 for _ in range(2))
        for kk in (3, 7, 11):
            w = torch.randn((ch, ch, kk), generator=gen, device="cuda") \
                / math.sqrt(ch * kk)
            k4 += [(dy, x, w, d) for d in (1, 3, 5)]
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

    def dw_run(m, shapes):
        return lambda: [g for dy, x, w, d in shapes
                        for g in m.mrf_conv_bwd_weight(dy, x, w.shape, d)]

    rel = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
              for a, b in zip(dw_run(mrf, k4)(), dw_run(parent.ops.mrf, k4)()))
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
        f"this tree {totals[0]:.3f} ms ({totals[1] / totals[0]:.2f}x); "
        f"largest |this - parent| / max(1, max|parent|) {rel:.3g}")


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
    for name in ("prefill_attention", "decode_attention", "mrf_conv"):
        assert launches[name] > 0, \
            f"{name} was never launched on the serving path"
        results[name]["launches"] = launches[name]
        results[name]["per_path"] = {"serving_clone": launches[name],
                                     "s2_step": 0}

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
# phase 6: the s2 fine-tune at full width
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


def train(torch, tmp: str, results):
    """SovitsTrain.train() at full width: SovitsConfig() and the full MPD
    from seeded random pretrained .pth files, 8 clips of 256 frames
    replicated to 96 items, batch 8, one epoch = 12 steps."""
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
    project = os.path.join(tmp, "project")
    trainer = SovitsTrain(SovitsTrainParams(
        batch_size=8, total_epochs=1, save_every_epoch=1,
        pretrained_s2G=s2g, pretrained_s2D=s2d, train_input_dir=norm,
        output_model_name="chip_smoke", project_dir=project))
    assert trainer.device.type == "cuda"
    log(f"[training] random s2G/s2D .pth and a normalize dir of 8 clips "
        f"written in {time.perf_counter() - t0:.1f} s")

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
        assert not bad, f"step {i + 1}: non-finite {bad}"
    step_fn = trainer.step_fn
    for name, net in (("G", step_fn.net_g), ("D", step_fn.net_d)):
        for pname, p in list(net.named_parameters()) + list(
                net.named_buffers()):
            assert p.device.type == "cuda", f"{name}.{pname} on {p.device}"
    for opt in (step_fn.optim_g, step_fn.optim_d):
        for st in opt.state.values():
            assert all(t.device.type == "cuda" for t in st.values())
    for name in ("mrf_conv", "mrf_conv_bwd_data", "mrf_conv_bwd_weight"):
        assert launches[name] > 0, f"{name} was never launched in training"
        results[name]["launches"] = results[name].get("launches", 0) \
            + launches[name]
        per_path = results[name].setdefault("per_path",
                                            {"serving_clone": 0})
        per_path["s2_step"] = launches[name] / len(secs)

    # the Generator's ResBlocks and upsamples moved (gradients reached them
    # through K4)
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

    steady = float(np.median(secs[2:12]))
    first, last = history[0], history[-1]
    log(f"[training] SovitsTrain.train(): 12 steps of B=8 x 20480 samples "
        f"in {wall:.2f} s wall (data, models and pretrained load "
        f"included); first step {secs[0]:.3f} s, median s/step over steps "
        f"3-12 {steady:.4f} s (min {min(secs[2:]):.4f}, max "
        f"{max(secs[2:]):.4f}); peak memory "
        f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(f"[training] step 1 losses " + ", ".join(
        f"{k} {v:.4f}" for k, v in first.items()))
    log(f"[training] step 12 losses " + ", ".join(
        f"{k} {v:.4f}" for k, v in last.items()))
    log(f"[training] {len(checked)} dec.resblocks.*.weight_v / dec.ups.* "
        f"tensors all changed; export {os.path.basename(resp.data['model_path'])} "
        f"loads strict=True and decodes a finite wav (|wav| max "
        f"{float(wav.abs().max()):.3f}); launches {launches}")
    profile_train_step(torch, trainer, norm)


def profile_train_step(torch, trainer, norm: str) -> None:
    """One more step of the trained S2TrainStep on a batch of the run's data,
    under torch.profiler: the step's device time and the MRF kernels' part
    of it (K3 and K4-dx share conv_mma_kernel, told apart by its BWD
    template argument; K4-dW is wgrad_wgmma_kernel / wgrad_mma_kernel)."""
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
    launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        launches += 1
        us = e.time_range.elapsed_us()
        if "conv_mma_kernel" in e.name:
            groups["K4-dx" if "true" in e.name else "K3"] += us
        elif "wgrad_wgmma_kernel" in e.name or "wgrad_mma_kernel" in e.name:
            groups["K4-dW"] += us  # not cuDNN's own *wgrad_* kernels
        else:
            groups["other"] += us
    if not launches:
        log("[training] torch.profiler recorded no CUDA activity for the "
            "profiled step: no breakdown this run")
        return
    total = sum(groups.values())
    log(f"[training] one more step under torch.profiler: device time "
        f"{total / 1000:.2f} ms in {launches} kernels and copies; "
        + ", ".join(f"{k} {v / 1000:.2f} ms" for k, v in groups.items()))


# ---------------------------------------------------------------------------
# phase 7: one train step on the card against the CPU
# ---------------------------------------------------------------------------

TINY_SOVITS = dict(
    spec_channels=1025, segment_size=2560, inter_channels=32,
    hidden_channels=32, filter_channels=64, n_heads=2, n_layers=2,
    upsample_initial_channel=32, gin_channels=32, ssl_dim=64,
    n_symbols=732, p_dropout=0.0)


def reference_train_step(torch):
    """One S2TrainStep at a small Generator width (the full MPD) on the card
    and on the CPU (plain twins) from the same weights and batch, with the
    slice starts and posterior noise given and dropout off.  Losses within
    1e-4 x max(1, |CPU|); every dec.resblocks.* gradient within 1e-3 x its
    largest CPU magnitude + 1e-6 x the largest Generator gradient (the
    rounding floor of gradients that are zero in exact arithmetic)."""
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
    runs = {}
    for dev in ("cuda", "cpu"):
        net_g = SynthesizerTrn(cfg, with_enc_q=True)
        net_d = MultiPeriodDiscriminator()
        for net, seed in ((net_g, 1), (net_d, 2)):
            net.load_state_dict(convert.random_state_dict(
                net, torch.Generator().manual_seed(seed)))
            net.to(dev)
        step = S2TrainStep(net_g, net_d, S2TrainHP(segment_size=2560,
                                                   learning_rate=2e-4),
                           MelConfig(), steps_per_epoch=1)
        metrics = step({k: v.to(dev) for k, v in batch.items()},
                       ids_slice=ids.to(dev), eps=eps.to(dev))
        grads = {k: p.grad.cpu() for k, p in net_g.named_parameters()
                 if p.grad is not None}
        runs[dev] = ({k: float(v) for k, v in metrics.items()}, grads)
    (m_gpu, g_gpu), (m_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    worst_loss = max(abs(m_gpu[k] - v) / max(1.0, abs(v))
                     for k, v in m_cpu.items() if k.startswith("loss/"))
    floor = 1e-6 * max(float(g.abs().max()) for g in g_cpu.values())
    worst_grad, names = 0.0, 0
    for k, want in g_cpu.items():
        if not k.startswith("dec.resblocks."):
            continue
        err = float((g_gpu[k] - want).abs().max())
        worst_grad = max(worst_grad, err / (float(want.abs().max()) + floor))
        names += 1
    log(f"[reference] S2TrainStep card vs CPU (G at width 32, full MPD, B=2, "
        f"2560 samples): losses relative max|d|={worst_loss:.3g} (tol "
        f"1e-4); {names} dec.resblocks.* gradients max|d| / (max|CPU| + "
        f"floor)={worst_grad:.3g} (tol 1e-3); loss/g/total "
        f"{m_gpu['loss/g/total']:.4f} vs {m_cpu['loss/g/total']:.4f}")
    assert worst_loss <= 1e-4 and worst_grad <= 1e-3 and names == 15 * 6 * 3


# ---------------------------------------------------------------------------
# phase 8: the s1 fine-tune at full width
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
    updates.  Returns the trainer."""
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
    ckpt.export_gpt_weights(gpt_export_tree(init), pretrained,
                            config=cfg_yaml, info="random")
    pre = convert.load_torch_state_dict(pretrained)   # fp16, as saved
    del init
    data = os.path.join(tmp, "s1_data")
    write_s1_dir(data, seed=7)
    trainer = GPTTrain(GPTTrainParams(
        batch_size=S1_B, total_epochs=1, save_every_epoch=1,
        model_path=pretrained, train_input_dir=data,
        output_model_name="chip_smoke_s1",
        project_dir=os.path.join(tmp, "s1_project")))
    assert trainer.device.type == "cuda"
    assert (cfg.n_layers, cfg.hidden_dim, cfg.n_heads) == (24, 512, 16)
    log(f"[s1 training] configs/gpt.yaml read: {cfg}; random pretrained "
        f".ckpt and 8 utterances written in "
        f"{time.perf_counter() - t0:.1f} s")

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
        assert not bad, f"micro-batch {i + 1}: non-finite {bad}"
    step_fn = trainer.step_fn
    model = step_fn.model
    for pname, p in list(model.named_parameters()) + list(
            model.named_buffers()):
        assert p.device.type == "cuda", f"{pname} on {p.device}"
    for st in step_fn.optimizer.state.values():
        assert all(t.device.type == "cuda" for t in st.values())
    group = step_fn.optimizer.param_groups[0]
    assert group["step"] == n // 4 and group["norm_buffer"].is_cuda
    layers = cfg.n_layers
    assert launches["prefill_attention"] == layers * n, launches
    k5_per_call = ops.prefill_attention_bwd.launches_per_call
    assert launches["prefill_attention_bwd"] == k5_per_call * layers * n, \
        launches
    for name in results:
        per_path = results[name].setdefault("per_path", {})
        for path in ("serving_clone", "s2_step"):
            per_path.setdefault(path, 0)
        per_path["s1_micro_batch"] = launches[name] / n
        results[name]["launches"] = results[name].get("launches", 0) \
            + launches[name]
    k5 = results["prefill_attention_bwd"]
    k5["launches_per_call"] = k5_per_call
    k5["calls"] = k5["launches"] // k5_per_call
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

    by_bucket = {}
    for i in range(2, n):
        by_bucket.setdefault(tokens[i], []).append(secs[i])
    log(f"[s1 training] GPTTrain.train(): {n} micro-batches of B={S1_B} "
        f"({n // 4} ScaledAdam updates) in {wall:.2f} s wall (data, model "
        f"and pretrained load included); first micro-batch {secs[0]:.3f} s "
        f"(T={S1_X_LEN + tokens[0]}); median s/micro-batch over "
        f"micro-batches 3-{n} by bucket: " + ", ".join(
            f"T={S1_X_LEN + t} {float(np.median(v)):.4f} s ({len(v)})"
            for t, v in sorted(by_bucket.items()))
        + f"; peak memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    log("[s1 training] micro-batch losses " + ", ".join(
        f"{m['loss']:.1f}" for m in history) + "; grad norms " + ", ".join(
        f"{m['grad_norm']:.3g}" for m in history))
    log(f"[s1 training] all {layers} in_proj_weight tensors changed; export "
        f"{os.path.basename(resp.data['model_path'])} loads strict=True and "
        f"greedy-decodes 8 tokens a row; launches {launches}")
    return trainer


def profile_s1_window(torch, trainer) -> None:
    """One accumulation window (4 micro-batches at T = 1776, the fourth
    ending with the ScaledAdam step) of the trained GPTTrainStep under
    torch.profiler: device time by group, K1 (prefill_attention_kernel),
    K5 (its dsum / dkdv / dq kernels), GEMMs (cuBLAS / CUTLASS kernels),
    the optimizer (the kernels inside the step's ScaledAdam.step range on
    the device timeline) and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            step_fn(batch)
        torch.cuda.synchronize()
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
        log("[s1 training] torch.profiler recorded no CUDA activity for the "
            "profiled window: no breakdown this run")
        return
    groups = {"K1": 0.0, "K5": 0.0, "GEMMs": 0.0, "optimizer": 0.0,
              "other": 0.0}
    k5_launches = 0
    for e in kernels:
        us = e.time_range.elapsed_us()
        name = e.name.lower()
        if "prefill_attention_kernel" in name:
            groups["K1"] += us
        elif any(k in name for k in ("dkdv_kernel(", "dq_kernel(",
                                     "dsum_kernel(")):
            groups["K5"] += us
            k5_launches += 1
        elif any(k in name for k in ("gemm", "xmma", "cutlass")):
            groups["GEMMs"] += us
        else:
            groups["other"] += us
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
        + f"; {k5_launches} K5 kernels in the K5 group" + note)
    from easevoice_trainer_tpu_torch.ops import prefill_attention_bwd

    want = 4 * step_fn.model.cfg.n_layers \
        * prefill_attention_bwd.launches_per_call
    assert k5_launches == want, (f"{k5_launches} K5 kernels in the window's "
                                 f"K5 group, not {want}")


# ---------------------------------------------------------------------------
# phase 9: one s1 micro-batch on the card against the CPU
# ---------------------------------------------------------------------------


def reference_s1_step(torch):
    """The training forward and backward of a GPT at a small width (2
    layers, width 64, 2 heads of dk 32) on the card (K1, K5) and on the CPU
    (the twins) from the same weights and batch: loss within 1e-5 x
    max(1, |CPU|), every layer's qkv gradient (in_proj weight and bias)
    within 1e-4 of its largest CPU magnitude."""
    from easevoice_trainer_tpu_torch import convert
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
    runs = {}
    for dev in ("cuda", "cpu"):
        model = Text2SemanticDecoder(cfg)
        model.load_state_dict(state)
        model.to(dev)
        out = model(*(t.to(dev) for t in batch))
        out["loss"].backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()
                 if "self_attn.in_proj" in k}
        runs[dev] = (float(out["loss"].detach()), grads)
    (l_gpu, g_gpu), (l_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    loss_err = abs(l_gpu - l_cpu) / max(1.0, abs(l_cpu))
    grad_err = max(float((g_gpu[k] - w).abs().max())
                   / max(float(w.abs().max()), 1e-30)
                   for k, w in g_cpu.items())
    log(f"[reference] s1 micro-batch card vs CPU (GPT width 64, 2 layers, "
        f"B={b}, T={x_len + y_len}): loss {l_gpu:.4f} vs {l_cpu:.4f}, "
        f"relative {loss_err:.3g} (tol 1e-5); {len(g_cpu)} qkv gradients "
        f"max|d| / max|CPU| = {grad_err:.3g} (tol 1e-4)")
    assert loss_err <= 1e-5 and grad_err <= 1e-4 and len(g_cpu) == 4


# ---------------------------------------------------------------------------


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
    phase = "device"
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

        phase = "build"
        from easevoice_trainer_tpu_torch.ops import build

        lib = build.build()
        log(f"[build] {lib.path} in {lib.build_seconds:.1f} s")
        for line in lib.build_log.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma")):
                log(f"[build] {line.strip()}")

        parent = None
        if args.parent:
            phase = "parent build"
            parent = load_parent(args.parent)

        phase = "kernels"
        check_kernels(torch, results, parent and parent.ops.attention)
        check_k4(torch, results)
        check_k5(torch, results, parent and parent.ops.attention)
        if parent is not None:
            phase = "mrf a/b"
            ab_mrf(torch, parent)
        phase = "serving"
        tts = serve(torch, tmp, results)
        phase = "serving profile"
        profile_gpt(torch, tts.t2s, parent)
        phase = "reference"
        reference_check(torch, tts)
        del tts
        gc.collect()
        torch.cuda.empty_cache()
        phase = "training"
        train(torch, tmp, results)
        phase = "reference train step"
        reference_train_step(torch)
        gc.collect()
        torch.cuda.empty_cache()
        phase = "s1 training"
        trainer = train_s1(torch, tmp, results)
        phase = "s1 profile"
        profile_s1_window(torch, trainer)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        phase = "reference s1 step"
        reference_s1_step(torch)
        phase = "isolation"
        from easevoice_trainer_tpu_torch import native

        foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
            "easevoice_trainer_tpu", "jax", "flax", "yaml"))
        log(f"[isolation] after serving English text, resampling the "
            f"reference clip (native resampler built: {native.available()}), "
            f"12 s2 training steps and 12 s1 micro-batches, modules of "
            f"easevoice_trainer_tpu, jax, flax or yaml loaded: {foreign}")
        assert not foreign, foreign
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

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
        for extra in ("warm_ms", "s1", "calls", "launches_per_call"):
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
