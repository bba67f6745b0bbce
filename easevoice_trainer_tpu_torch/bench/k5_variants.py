"""K5's design choices, each taken back in turn, timed on the card.

    python3 -m easevoice_trainer_tpu_torch.bench.k5_variants [--dtype D] \
        [--dropout]

Writes variants of K5's sources under ``build/k5_variants/`` (git-ignored),
each with one choice undone, builds each with nvcc into its own library
beside the tree's, and times K5's three kernels (dsum, dkdv, dq) of every
build on the s1 micro-batch shapes of ``chip_smoke.py`` (B = 8, H = 16,
416 phonemes, 300 and 1360 tokens, ragged lengths): torch.profiler device
time, mean of 20 calls, the tree's build timed first and last.  Each
build's gradients are held against the plain twin.  ``--dtype`` fp32, bf16
or both (the default).

fp32 (``csrc/prefill_attention_bwd.cu``; gradients within 1e-4 x
max(1, max|twin|) each):

- ``q8``: dkdv through a query tile 8 queries (one accumulator tile per
  product) a step, not 16;
- ``exp2f``: libm's ``exp2f`` in place of ``ex2.approx.ftz``;
- ``no_cap``: launch bounds of 128 threads alone, no blocks-an-SM cap;
- ``cvt``: the TF32 rounding of the split by ``cvt.rna.tf32.f32``.

bf16 (``csrc/prefill_attention_bwd_bf16.cu``, whose choices are the
constants at its top; gradients within chip_smoke's bf16 tolerance of the
bf16 twin: every element within 2^-6 x max(1, max|twin|), at most 2 % off
by more than one bf16 step, both printed):

- ``terms3``: P and dS in three bf16 terms, not hi + lo;
- ``sync``: Q / dO and K / V staged by plain loads and stores, not
  cp.async;
- ``q8``: dkdv 8 queries a step (m16n8k8), not 16 (m16n8k16);
- ``no_cap`` / ``cap<n>``: no blocks-an-SM cap, or one block fewer.

``--dropout`` times the instances with dropout (p = 0.1) instead, reading
the keep bits K1's dropout instance wrote, against the twin with the same
mask: in bf16 with the choices above, in fp32 with those of its dropout
instances (``variants_dropout``):

- ``drop_cap<n>``: one block an SM fewer asked of the dropout instances'
  launch bounds (2: the cap they had while they drew the mask);
- ``no_cap``: as above.

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import sys

_Q8 = '''#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int qc = q0 + 8 * j;
      if (!live || qc >= T || (!text && qc + 7 < kw)) continue;
      const bool full = qc + 8 <= T && (text ? kw + 16 <= xv
                                             : (qc >= kw + 15 &&
                                                kw + 16 <= y_end));
      float st[1][4], dpt[1][4];
      mma_dims<1>(st, kh, kl, &sq[slot][8 * j][0], g, t);
      mma_dims<1>(dpt, vh, vl, &sdo[slot][8 * j][0], g, t);
      const float2 l2 = *reinterpret_cast<const float2*>(
          &slse[slot][8 * j + 2 * t]);
      const float2 d2 =
          *reinterpret_cast<const float2*>(&sd[slot][8 * j + 2 * t]);
      const float m[2] = {l2.x * LOG2E, l2.y * LOG2E};
      const float dd[2] = {d2.x, d2.y};
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool vis = full;
        if (!full) {
          const int query = qc + 2 * t + (e & 1);
          const int key = keys[e >> 1];
          vis = query < T &&
                (text ? key < xv : (query >= key && key < y_end));
        }
        p[e] = vis ? ex2(fmaf(st[0][e], c, -m[e & 1])) : 0.f;
        ds[e] = p[e] * (dpt[0][e] - dd[e & 1]);
      }
      mma_rows(acc_dv, p, &sdo[slot][8 * j][0], g, t);
      mma_rows(acc_dk, ds, &sq[slot][8 * j][0], g, t);
    }
'''

_SPLIT = '''  float h, l;
  split_tf32(v, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
'''

_CVT = '''  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(v));
  lo = __float_as_uint(v - __uint_as_float(hi));
'''


def _swap(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f"variant: {old[:60]!r} found {src.count(old)} "
                         f"times, not {count}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """The tree's fp32 K5 source with each design choice undone, by name."""
    begin = src.index("#pragma unroll\n    for (int j = 0; j < BQ / 16;")
    end = src.index("    __syncthreads();  // every warp is done with this "
                    "slot\n    issue(i + 2, slot);\n  }\n\n  const long long "
                    "out")
    return {
        "q8": src[:begin] + _Q8 + src[end:],
        "exp2f": _swap(src, "? ex2(fmaf(", "? exp2f(fmaf(", 2),
        "no_cap": _no_cap(src),
        "cvt": _swap(src, _SPLIT, _CVT),
    }


def _no_cap(src: str) -> str:
    return _swap(src, "__launch_bounds__(NT, DROP ? DROP_MIN_BLOCKS : "
                 "MIN_BLOCKS)", "__launch_bounds__(NT)", 2)


def variants_dropout(src: str) -> dict:
    """The tree's fp32 K5 source with each design choice of the instances
    with dropout undone, by name."""
    line = _const(src, "DROP_MIN_BLOCKS")
    blocks = int(line.rsplit("=", 1)[1].strip(" ;")) - 1
    return {f"drop_cap{blocks}": _swap(
                src, line, line.rsplit("=", 1)[0] + f"= {blocks};"),
            "no_cap": _no_cap(src)}


def _const(src: str, name: str) -> str:
    m = re.search(rf"constexpr \w+ {name} = (\w+);", src)
    if not m:
        raise ValueError(f"variant: no constant {name}")
    return m.group(0)


def variants_bf16(src: str) -> dict:
    """The tree's bf16 K5 source with each design choice undone, by name."""
    def const(name, value):
        line = _const(src, name)
        return _swap(src, line, line.rsplit("=", 1)[0] + f"= {value};")

    blocks = int(_const(src, "MIN_BLOCKS").rsplit("=", 1)[1].strip(" ;"))
    return {
        "terms3": const("TERMS", 3),
        "sync": const("ASYNC", "false"),
        "q8": const("QSTEP", 8),
        "no_cap": _swap(src, "__launch_bounds__(NT, MIN_BLOCKS)",
                        "__launch_bounds__(NT)", 2),
        f"cap{blocks - 1}": const("MIN_BLOCKS", blocks - 1),
    }


def _build(src_path: str, so_path: str, include: str = None):
    from ..ops import build

    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", include or build.CSRC,
         "-shared", "-o", so_path, src_path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _entry(so_path: str, name: str, argtypes=None):
    from ..ops import build

    fn = getattr(ctypes.CDLL(os.path.abspath(so_path)), name)
    fn.argtypes = argtypes or build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _kernel_ms(torch, run, name: str, reps: int = 20) -> float:
    """Device ms of the one kernel named *name* that a call of ``run``
    launches: the mean over the records of a torch.profiler session of
    ``reps`` calls.  A session now and then loses records, so one short of
    ``reps`` is taken again, up to three in all, and the mean is taken
    over what the fullest one recorded (the sum over ``reps`` would read
    low)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if len(us) > len(best):
            best = us
        if len(best) >= reps:
            break
    if not best:
        raise RuntimeError(f"torch.profiler recorded no kernel named "
                           f"*{name}*")
    if len(best) < reps:
        print(f"[timer] {name}: {len(best)} of {reps} launches recorded; "
              f"the mean of those", flush=True)
    return sum(best) / 1000.0 / len(best)


def bf16_err(got, want):
    """(max |got - want| / max(1, max|want|), the share of elements off by
    more than one bf16 step of their own value): chip_smoke's bf16 rule."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rel = float(err.max()) / max(1.0, float(w.abs().max()))
    return rel, float((err > 2.0 ** -7 * w.abs() + 1e-6).float().mean())


def run_set(torch, dtype, out: str, dropout: bool = False) -> None:
    """Build and time one instance's variants (``dtype`` torch.float32 or
    torch.bfloat16; with ``dropout`` the instance with dropout, on K1's keep
    bits) beside the tree's library."""
    from ..ops import attention as att
    from ..ops import build

    bf16 = dtype == torch.bfloat16
    source = "prefill_attention_bwd_bf16.cu" if bf16 else \
        "prefill_attention_bwd.cu"
    entry = "ev_prefill_attention_bwd_" + ("dropout_" if dropout else "") + (
        "bf16" if bf16 else "f32")
    tag = ("_dropout" if dropout else "") + ("_bf16" if bf16 else "")
    kernels = tuple(f"{k}{'_bf16' if bf16 else ''}_kernel"
                    for k in ("dsum", "dkdv", "dq"))
    with open(os.path.join(build.CSRC, source)) as f:
        srcs = (variants_bf16 if bf16 else variants_dropout if dropout
                else variants)(f.read())
    procs = {}
    for name, src in srcs.items():
        path = os.path.join(out, f"{name}{tag}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = _build(path, os.path.join(out, f"{name}{tag}.so"))
    fns = {"tree": getattr(build.build(), entry)}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        kernel = ""
        for line in log.splitlines():
            if "entry function" in line:
                kernel = next((k for k in kernels if k in line), "")
            elif "registers" in line or "spill" in line:
                print(f"[ptxas {name}{tag} {kernel}] {line.strip()}")
        fns[name] = _entry(os.path.join(out, f"{name}{tag}.so"), entry)
    order = ["tree", *srcs, "tree"]   # the tree first and last

    gen = torch.Generator(device="cuda").manual_seed(6006)
    b, h, dk, x_len = 8, 16, 32, 416
    totals = {name: [0.0] * 3 for name in fns}
    worst = {name: [0.0, 0.0] for name in fns}
    for y_len in (300, 1360):
        t = x_len + y_len
        x_lens = torch.randint(1, x_len + 1, (b,), generator=gen,
                               device="cuda").to(torch.int32)
        y_lens = torch.randint(1, y_len + 1, (b,), generator=gen,
                               device="cuda").to(torch.int32)
        x_lens[0], y_lens[-1] = x_len, y_len
        qkv = torch.randn((b, t, 3 * h * dk), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = att._split_heads(qkv, h)
        do = torch.randn((b, t, h, dk), generator=gen,
                         device="cuda").to(dtype)
        drop = att.AttentionDropout(0.1, 0x6006, 5) if dropout else None
        bits = att.new_mask_bits(q, x_len) if dropout else None
        o, lse = att.prefill_attention_lse(q, k, v, x_len, x_lens, y_lens,
                                           drop, mask_bits=bits)
        mask = drop.keep_mask(b, h, t, x_len, "cuda") if dropout else None
        want = att.prefill_attention_bwd_reference(
            q, k, v, o, lse, do, x_len, x_lens, y_lens, mask,
            0.1 if dropout else 0.0)
        dsum = torch.empty((b, h, t), device="cuda")
        dqkv = torch.empty((b, t, 3 * h * dk), device="cuda", dtype=dtype)
        grads = att._split_heads(dqkv, h)
        stream = torch.cuda.current_stream().cuda_stream
        args = [z.data_ptr() for z in (q, k, v, o, do, lse, dsum, *grads)]
        args += [q.stride(0), q.stride(1), grads[0].stride(0),
                 grads[0].stride(1), x_lens.data_ptr(), y_lens.data_ptr(),
                 b, t, h, x_len, 1 / math.sqrt(dk)]
        args += [0.9, bits.data_ptr(), stream] if dropout else [stream]
        runs = {}
        for name in order:
            def run(fn=fns[name]):
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            run()
            torch.cuda.synchronize()
            if bf16:
                errs = [bf16_err(g, w) for g, w in zip(grads, want)]
                err = [max(e[0] for e in errs), max(e[1] for e in errs)]
                ok = err[0] <= 2.0 ** -6 and err[1] <= 0.02
            else:
                err = [max(float((g - w).abs().max()) / max(1.0, float(
                    w.abs().max())) for g, w in zip(grads, want)), 0.0]
                ok = err[0] <= 1e-4
            assert ok, f"{name}{tag} disagrees with the twin: {err}"
            worst[name] = [max(a, c) for a, c in zip(worst[name], err)]
            runs.setdefault(name, []).append(
                [_kernel_ms(torch, run, kn) for kn in kernels])
        for name, ms in runs.items():
            m = [sum(z) / len(ms) for z in zip(*ms)]
            totals[name] = [a + c for a, c in zip(totals[name], m)]
            print(f"T={t} {name}{tag}: dsum {m[0]:.4f} dkdv {m[1]:.4f} dq "
                  f"{m[2]:.4f}, K5 {sum(m):.4f} ms", flush=True)
    for name, m in totals.items():
        print(f"two s1 shapes, {name}{tag}: dsum {m[0]:.4f} dkdv {m[1]:.4f} "
              f"dq {m[2]:.4f}, K5 {sum(m):.4f} ms "
              f"({sum(m) / sum(totals['tree']):.3f} x the tree); against the "
              f"twin: relative {worst[name][0]:.3g}"
              + (f", share off by more than a step {worst[name][1]:.3g}"
                 if bf16 else ""), flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    from ..ops import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("fp32", "bf16", "both"),
                    default="both")
    ap.add_argument("--dropout", action="store_true",
                    help="the instances with dropout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    out = os.path.join(os.path.dirname(build.BUILD_ROOT), "k5_variants")
    os.makedirs(out, exist_ok=True)
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        if args.dtype in (name, "both"):
            run_set(torch, dtype, out, args.dropout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
