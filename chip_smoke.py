#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one summary line each; any failure exits non-zero:

1. device: card name, ``nvidia-smi`` name and power limit, TF32 off for
   matmul and cuDNN (every comparison below is full fp32);
2. build: compile the hand-written kernels (``csrc/*.cu``, nvcc, sm_90a);
3. kernels: each kernel against its plain PyTorch twin on the same seeded
   inputs at the main path's shapes, max |diff| against the stated
   tolerance, and both times (CUDA events);
4. serving: ``VoiceCloneService.clone`` at full model width (random weights
   from a seeded ``torch.Generator``, written to .pth files and loaded the way
   a user's trained models are), a synthetic 5 s reference and six English
   sentences; the wav must be finite and non-silent, every weight on the
   card, and each kernel launched during this phase;
5. reference: the same models on the card and on the CPU (where the plain
   twins run) agree on a small input.

The line before the last holds one JSON object with each kernel's launches,
error and times; the last line is the run's verdict
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository beside this file, it exits non-zero and prints no verdict.
"""
from __future__ import annotations

import copy
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
}


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


def random_weights(torch, module, gen, path: str, wrap: bool = True) -> None:
    """Seeded random weights saved as a checkpoint file: wrapped like an
    exported .pth/.ckpt, or a raw state dict like HF's pytorch_model.bin."""
    from easevoice_trainer_tpu_torch import convert

    state = {k: v.cpu() for k, v in
             convert.random_state_dict(module, gen).items()}
    torch.save({"weight": state, "config": {}, "info": "random"}
               if wrap else state, path)


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
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}

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
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the serving path"
        results[name]["launches"] = n

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
        phase = "serving"
        tts = serve(torch, tmp, results)
        phase = "reference"
        reference_check(torch, tts)
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
