"""The bf16 K3 / K4-dx loop's design choices, each taken back in turn, timed
on the card.

    python3 -m easevoice_trainer_tpu_torch.bench.mrf_bf16_variants

Writes variants of ``csrc/mrf_conv_tile_bf16.cuh`` under
``build/mrf_bf16_variants/`` (git-ignored), each with one choice undone,
builds them with nvcc (one process a variant) into one library beside the
tree's, and times K3 and K4-dx of every build on the 45 s2 shapes of
``chip_smoke.py`` (B = 8, every Generator stage, k in {3, 7, 11}, d in
{1, 3, 5}, K3 with the residual at d = 1), beside cuDNN's bf16 conv and
transposed conv (K3's residual added by a second kernel).  A time is the
least of three replays of a CUDA graph of 20 launches of one shape between
two CUDA events, over 20: the kernels and the gaps between them in the
graph.  Every build's outputs are held against the bf16 twins (within
2^-6 x max(1, max|twin|)).  Variants:

- ``scalar_w``: the weight convert by two 16-bit reads a word at every tap
  count (the loop's path for a tap count not fixed at compile time), not
  one 32-bit read a word and a byte permute;
- ``stages2``: two raw stages always, not three where two blocks an SM
  keep them;
- ``split4``: a channel split into up to four blocks a cluster, not two;
- ``tile64x128``: 64 x 128 blocks (2 x 4 warps of 32 x 32) where Cout >= 64
  and 64 x 256 gives fewer blocks than SMs, not 32 x 256.

Prints the card's name and power limit first, then one line a stage and
build, and the sums over the 45 shapes.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

HEADER = "mrf_conv_tile_bf16.cuh"


def variants() -> dict:
    """name -> [(old, new), ...] patches of the header."""
    return {
        "scalar_w": [("    if constexpr (KT > 0) {\n      for (int it = tid; "
                      "it < BM * 8;",
                      "    if constexpr (false) {\n      for (int it = tid; "
                      "it < BM * 8;")],
        "stages2": [("constexpr int MAX_STAGES = 3;",
                     "constexpr int MAX_STAGES = 2;")],
        "split4": [("  while (split < 2 && blocks",
                    "  while (split < 4 && blocks")],
        "tile64x128": [("  if (Cout >= 32)\n",
                        "  if (Cout >= 64)\n    return dispatch_k<2, 2, 4, "
                        "BWD>(xp, wp, bp, rp, yp, B, Cin, Cout, T, k, dil, "
                        "slope, s);\n  if (Cout >= 32)\n")],
    }


def _write(csrc: str, out: str) -> list:
    """The variants' headers and entry points under ``out``; returns the
    (name, source) pairs."""
    src = open(os.path.join(csrc, HEADER)).read()
    made = []
    for name, patches in variants().items():
        text = src.replace("namespace mrf_bf16", f"namespace mrf_bf16_{name}")
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: the header changed")
            text = text.replace(old, new)
        vdir = os.path.join(out, name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, HEADER), "w") as f:
            f.write(text)
        cu = os.path.join(vdir, "entry.cu")
        with open(cu, "w") as f:
            f.write(f'''#include "{HEADER}"
extern "C" int k3_{name}(const void* x, const void* w, const void* b,
    const void* r, void* y, int B, int Cin, int Cout, int T, int k, int d,
    float s, void* st) {{
  return mrf_bf16_{name}::conv_tile<false>(x, w, b, r, y, B, Cin, Cout, T,
      k, d, s, (cudaStream_t)st); }}
extern "C" int k4_{name}(const void* dy, const void* x, const void* w,
    void* dx, int B, int Cin, int Cout, int T, int k, int d, float s,
    void* st) {{
  return mrf_bf16_{name}::conv_tile<true>(dy, w, nullptr, x, dx, B, Cout,
      Cin, T, k, d, s, (cudaStream_t)st); }}
''')
        made.append((name, cu))
    return made


def _build(made: list, csrc: str, out: str, build) -> ctypes.CDLL:
    nvcc = build._nvcc()
    procs = [subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-I", csrc, "-c", "-o", cu + ".o", cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _, cu in made]
    for (name, _), proc in zip(made, procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    so = os.path.join(out, "libvariants.so")
    subprocess.run([nvcc, "-shared", "-o", so,
                    *[cu + ".o" for _, cu in made]], check=True)
    return ctypes.CDLL(so)


def graph_ms(torch, fn, launches: int = 20) -> float:
    """Least of three replays of a CUDA graph of ``launches`` calls of
    ``fn``, over ``launches``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    return best


def main() -> int:
    import torch
    import torch.nn.functional as F

    from ..ops import build, mrf

    if not torch.cuda.is_available():
        print("mrf_bf16_variants: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(build.CSRC))
    out = os.path.join(root, "build", "mrf_bf16_variants")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[variants] {smi}", flush=True)
    made = _write(build.CSRC, out)
    lib = _build(made, build.CSRC, out, build)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    bf = torch.bfloat16
    slope = mrf.weak_scalar(mrf.LRELU_SLOPE, bf)
    gen = torch.Generator(device="cuda").manual_seed(1414)
    totals = {}
    for ch, t_len in ((256, 320), (128, 2560), (64, 5120), (32, 10240),
                      (16, 20480)):
        x = torch.randn((8, ch, t_len), generator=gen, device="cuda").to(bf)
        dy = torch.randn((8, ch, t_len), generator=gen,
                         device="cuda").to(bf)
        act = mrf.leaky_relu(x)
        y = torch.empty_like(x)
        stage = {}
        for k in (3, 7, 11):
            w = (torch.randn((ch, ch, k), generator=gen, device="cuda")
                 / math.sqrt(ch * k)).to(bf)
            b = (torch.randn((ch,), generator=gen, device="cuda")
                 * 0.1).to(bf)
            for d in (1, 3, 5):
                r = x if d == 1 else None
                pad = (k - 1) * d // 2
                runs = {
                    ("K3", "tree"): lambda: mrf.mrf_conv(x, w, b, d,
                                                         residual=r),
                    ("K4-dx", "tree"): lambda: mrf.mrf_conv_bwd_data(
                        dy, x, w, d),
                    ("K3", "cuDNN"): lambda: (
                        F.conv1d(act, w, b, padding=pad, dilation=d)
                        if r is None else
                        F.conv1d(act, w, b, padding=pad, dilation=d) + r),
                    ("K4-dx", "cuDNN"): lambda: F.conv_transpose1d(
                        dy, w, padding=pad, dilation=d),
                }
                want = {"K3": mrf.mrf_conv_reference(x, w, b, d,
                                                     residual=r),
                        "K4-dx": mrf.mrf_conv_bwd_data_reference(dy, x, w,
                                                                 d)}
                for name, _ in made:
                    f3, f4 = getattr(lib, "k3_" + name), getattr(
                        lib, "k4_" + name)
                    f3.argtypes = [P] * 5 + [I] * 6 + [Fl, P]
                    f4.argtypes = [P] * 4 + [I] * 6 + [Fl, P]

                    def k3(f3=f3):
                        build.check(f3(x.data_ptr(), w.data_ptr(),
                                       b.data_ptr(),
                                       r.data_ptr() if r is not None
                                       else None, y.data_ptr(), 8, ch, ch,
                                       t_len, k, d, slope, stream()), "k3")
                        return y

                    def k4(f4=f4):
                        build.check(f4(dy.data_ptr(), x.data_ptr(),
                                       w.data_ptr(), y.data_ptr(), 8, ch, ch,
                                       t_len, k, d, slope, stream()), "k4")
                        return y

                    runs[("K3", name)], runs[("K4-dx", name)] = k3, k4
                for (kern, name), fn in runs.items():
                    if name != "cuDNN":
                        got, ref = fn().float(), want[kern].float()
                        err = float((got - ref).abs().max())
                        if err > 2.0 ** -6 * max(1.0, float(ref.abs().max())):
                            raise RuntimeError(f"{kern} {name} k={k} d={d}: "
                                               f"max|d| {err}")
                    stage[(kern, name)] = stage.get((kern, name), 0.0) + \
                        graph_ms(torch, fn)
        for (kern, name), ms in sorted(stage.items()):
            totals[(kern, name)] = totals.get((kern, name), 0.0) + ms
            print(f"[variants] C={ch} T={t_len}, 9 shapes: {kern} {name} "
                  f"{ms:.4f} ms", flush=True)
        del x, dy, act, y
        torch.cuda.empty_cache()
    for (kern, name), ms in sorted(totals.items()):
        print(f"[variants] 45 shapes: {kern} {name} {ms:.4f} ms "
              f"({ms / totals[(kern, 'tree')]:.2f}x the tree's)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
