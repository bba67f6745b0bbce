#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one summary line each; any failure exits non-zero:

1. device: card name, ``nvidia-smi`` name and power limit, TF32 off for
   matmul and cuDNN (every comparison below is full fp32);
2. build: compile the hand-written kernels (``csrc/*.cu``, one nvcc per
   source, sm_90a);
3. kernels: each kernel against its plain PyTorch twin on the same seeded
   inputs at the main paths' shapes (K1-K3 at serving's, K4 at the s2
   step's), max |diff| against the stated tolerance, and both times (CUDA
   events);
4. serving: ``VoiceCloneService.clone`` at full model width (random weights
   from a seeded ``torch.Generator``, written to .pth files and loaded the way
   a user's trained models are), a synthetic 5 s reference and six English
   sentences; the wav must be finite and non-silent, every weight on the
   card, and K1, K2 and K3 launched during this phase;
5. reference: the same models on the card and on the CPU (where the plain
   twins run) agree on a small input;
6. training: ``SovitsTrain.train()`` at full width (SovitsConfig() and the
   full MPD from seeded random pretrained .pth files, 8 synthetic clips of
   256 frames, batch 8, 12 steps): finite losses, every tensor on the card,
   K3 and both K4 entry points launched, every ResBlock ``weight_v`` and
   upsample tensor changed, and the export loads ``strict=True`` into the
   inference build and decodes a finite, non-silent wav;
7. reference train step: one step at a small width on the card and on the
   CPU agrees (losses and the ResBlock gradients).

The line before the last holds one JSON object with each kernel's launches,
error and times; the last line is the run's verdict
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository beside this file, it exits non-zero and prints no verdict.
"""
from __future__ import annotations

import copy
import gc
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
        "easevoice_trainer_tpu/models/gpt/t2s.py:356 "
        "(decode_step attention, no Pallas ancestor)"),
    "mrf_conv": (
        "easevoice_trainer_tpu_torch/csrc/mrf_conv.cu",
        "easevoice_trainer_tpu/ops/fused_mrf.py:125 "
        "(_fwd_kernel, git 42ecfe8)"),
    "mrf_conv_bwd_data": (
        "easevoice_trainer_tpu_torch/csrc/mrf_conv_bwd.cu",
        "easevoice_trainer_tpu/ops/fused_mrf.py:168 "
        "(_bwd_kernel, dx, git 42ecfe8)"),
    "mrf_conv_bwd_weight": (
        "easevoice_trainer_tpu_torch/csrc/mrf_conv_bwd.cu",
        "easevoice_trainer_tpu/ops/fused_mrf.py:168 "
        "(_bwd_kernel, dW and db, git 42ecfe8)"),
}

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


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, got, want) -> float:
    return float((got - want).abs().max())


# ---------------------------------------------------------------------------
# phase 3: each kernel against its twin
# ---------------------------------------------------------------------------

def check_kernels(torch, results):
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
    ms = cuda_ms(torch, lambda: att.prefill_attention(
        q, k, v, x_len, x_lens, y_lens), 50)
    plain = cuda_ms(torch, lambda: att.prefill_attention_reference(
        q, k, v, x_len, x_lens, y_lens), 50)
    log(f"[kernels] K1 prefill_attention B={b} H={h} dk={dk} x_len={x_len} "
        f"x_lens={x_lens.tolist()} prompt={prompt}: max|d|={err:.3g} "
        f"(tol {tol}) kernel {ms:.4f} ms, plain {plain:.4f} ms")
    assert err <= tol, f"prefill_attention disagrees: {err}"
    results["prefill_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)

    # K2: one layer's cache at x_len + prompt + 1120 slots
    cache_len = x_len + prompt + 1120
    kc = torch.randn((b, cache_len, h, dk), generator=gen, device=dev)
    vc = torch.randn((b, cache_len, h, dk), generator=gen, device=dev)
    worst = 0.0
    for step in (0, 1, 500):
        qn, kn, vn = (torch.randn((b, 1, h, dk), generator=gen, device=dev)
                      for _ in range(3))
        got = att.decode_attention(qn, kn, vn, kc, vc, x_len, x_lens, prompt,
                                   step)
        want = att.decode_attention_reference(qn, kc, vc, x_len, x_lens,
                                              prompt, step)
        err = max_err(torch, got, want)
        worst = max(worst, err)
        log(f"[kernels] K2 decode_attention cache_len={cache_len} "
            f"step={step}: max|d|={err:.3g} (tol {tol})")
    pos = x_len + prompt + 500

    def plain_step():
        kc[:, pos] = kn[:, 0]
        vc[:, pos] = vn[:, 0]
        return att.decode_attention_reference(qn, kc, vc, x_len, x_lens,
                                              prompt, 500)

    ms = cuda_ms(torch, lambda: att.decode_attention(
        qn, kn, vn, kc, vc, x_len, x_lens, prompt, 500), 200)
    plain = cuda_ms(torch, plain_step, 200)
    log(f"[kernels] K2 step 500 with the K/V row write: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms")
    assert worst <= tol, f"decode_attention disagrees: {worst}"
    results["decode_attention"] = dict(max_abs_err=worst, ms=ms,
                                       plain_ms=plain)

    # K3: every Generator stage's (C, k, d) at its length for 250 codes
    # (padded to 256 codes -> 512 frames), batch of 4 rows
    frames = 512
    rates = (10, 8, 2, 2, 2)
    worst_rel = 0.0
    worst = 0.0
    total_ms = total_plain = 0.0
    ch, up = 512, 1
    for i, u in enumerate(rates):
        ch //= 2
        up *= u
        t_len = frames * up
        x = torch.randn((b, ch, t_len), generator=gen, device=dev)
        for kk in (3, 7, 11):
            w = torch.randn((ch, ch, kk), generator=gen, device=dev) \
                / math.sqrt(ch * kk)
            bias = torch.randn((ch,), generator=gen, device=dev) * 0.1
            for d in (1, 3, 5):
                res = x if d == 1 else None
                got = mrf.mrf_conv(x, w, bias, d, residual=res)
                want = mrf.mrf_conv_reference(x, w, bias, d, residual=res)
                err = max_err(torch, got, want)
                rel = err / max(1.0, float(want.abs().max()))
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                ms = cuda_ms(torch, lambda: mrf.mrf_conv(
                    x, w, bias, d, residual=res), 3)
                plain = cuda_ms(torch, lambda: mrf.mrf_conv_reference(
                    x, w, bias, d, residual=res), 3)
                total_ms += ms
                total_plain += plain
                log(f"[kernels] K3 stage {i} B={b} C={ch} T={t_len} k={kk} "
                    f"d={d} residual={res is not None}: max|d|={err:.3g} "
                    f"kernel {ms:.4f} ms, plain {plain:.4f} ms")
    log(f"[kernels] K3 mrf_conv 45 shapes: max|d|={worst:.3g}, relative "
        f"{worst_rel:.3g} (tol {tol} x max(1, max|twin|)); kernel "
        f"{total_ms:.3f} ms, plain {total_plain:.3f} ms summed over shapes")
    # cuDNN's fp32 conv can sum in the kernel's own (channel, tap) order and
    # then agrees bit for bit; the CPU twin sums in another order
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
    del x, w, bias, got, want
    assert worst_rel <= tol, f"mrf_conv disagrees: {worst_rel}"
    results["mrf_conv"] = dict(max_abs_err=worst, ms=total_ms,
                               plain_ms=total_plain)


def check_k4(torch, results):
    """K4's two entry points against their twins at the s2 step's shapes:
    B=8, every Generator stage of one 32-frame segment, k in {3, 7, 11},
    d in {1, 3, 5}.  dx is a sum of Cout*k products, like K3's output, and
    takes K3's tolerance, 1e-4 x max(1, max|twin|).  dW and db are sums of
    B*T (up to 163,840) products, taken in 512-sample chunks and then across
    chunks, in another order than cuDNN's: 1e-3 x max(1, max|twin|).  A
    wrong tap or index gives errors of order 1."""
    from easevoice_trainer_tpu_torch.ops import mrf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    b = 8
    tol_dx, tol_dw = 1e-4, 1e-3
    worst = {"mrf_conv_bwd_data": 0.0, "mrf_conv_bwd_weight": 0.0}
    worst_rel = dict(worst)
    times = {name: [0.0, 0.0] for name in worst}
    for ch, t_len in S2_STAGES:
        x = torch.randn((b, ch, t_len), generator=gen, device=dev)
        dy = torch.randn((b, ch, t_len), generator=gen, device=dev)
        for kk in (3, 7, 11):
            w = torch.randn((ch, ch, kk), generator=gen, device=dev) \
                / math.sqrt(ch * kk)
            for d in (1, 3, 5):
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
                ms_x = cuda_ms(torch, lambda: mrf.mrf_conv_bwd_data(
                    dy, x, w, d), 3)
                pl_x = cuda_ms(torch, lambda: mrf.mrf_conv_bwd_data_reference(
                    dy, x, w, d), 3)
                ms_w = cuda_ms(torch, lambda: mrf.mrf_conv_bwd_weight(
                    dy, x, w.shape, d), 3)
                pl_w = cuda_ms(torch, lambda: mrf.mrf_conv_bwd_weight_reference(
                    dy, x, w.shape, d), 3)
                for name, e, r, ms, pl in (
                        ("mrf_conv_bwd_data", err_x, rel_x, ms_x, pl_x),
                        ("mrf_conv_bwd_weight", err_w, rel_w, ms_w, pl_w)):
                    worst[name] = max(worst[name], e)
                    worst_rel[name] = max(worst_rel[name], r)
                    times[name][0] += ms
                    times[name][1] += pl
                log(f"[kernels] K4 B={b} C={ch} T={t_len} k={kk} d={d}: dx "
                    f"max|d|={err_x:.3g} rel {rel_x:.3g}, kernel "
                    f"{ms_x:.4f} ms, plain {pl_x:.4f} ms; dW/db max|d|="
                    f"{err_w:.3g} rel {rel_w:.3g}, kernel {ms_w:.4f} ms, "
                    f"plain {pl_w:.4f} ms")
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
        log(f"[kernels] K4 {name} 45 shapes: max|d|={worst[name]:.3g}, "
            f"relative {worst_rel[name]:.3g} (tol {tol} x max(1, "
            f"max|twin|)); kernel {times[name][0]:.3f} ms, plain "
            f"{times[name][1]:.3f} ms summed over shapes")
        assert worst_rel[name] <= tol, f"{name} disagrees: {worst_rel[name]}"
        results[name] = dict(max_abs_err=worst[name], ms=times[name][0],
                             plain_ms=times[name][1])


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

    phases = tts.last_phases
    audio_s = wav.size / sr
    tokens = tts.last_generated_tokens
    log(f"[serving] clone wall {wall:.3f} s (weights loaded from .pth "
        f"inside), audio {audio_s:.3f} s, RTF {wall / audio_s:.4f}; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
        + f"; {tokens} tokens generated, {tokens / phases['ar_decode']:.1f} "
        f"tokens/s in ar_decode; launches {launches}")
    return tts


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


def main() -> int:
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
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

        phase = "kernels"
        check_kernels(torch, results)
        check_k4(torch, results)
        phase = "serving"
        tts = serve(torch, tmp, results)
        phase = "reference"
        reference_check(torch, tts)
        del tts
        gc.collect()
        torch.cuda.empty_cache()
        phase = "training"
        train(torch, tmp, results)
        phase = "reference train step"
        reference_train_step(torch)
        assert "jax" not in sys.modules and "flax" not in sys.modules
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
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
