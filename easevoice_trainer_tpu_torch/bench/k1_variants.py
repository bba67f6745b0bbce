"""K1 bf16's design choices, each taken back in turn, timed on the card.

    python3 -m easevoice_trainer_tpu_torch.bench.k1_variants

Writes variants of ``csrc/prefill_attention_bf16.cu`` under
``build/k1_variants/`` (git-ignored), each with one of the constants at its
top undone, builds each with nvcc into its own library beside the tree's,
and times the kernel of every build on the s1 micro-batch shapes of
``chip_smoke.py`` (B = 8, H = 16, 416 phonemes, 300 and 1360 tokens, ragged
lengths), writing the row logsumexp as the fine-tune does: torch.profiler
device time, mean of 20 calls, the tree's build timed first and last.  Each
build's o is held to the bf16 twin within chip_smoke's bf16 tolerance
(every element within 2^-6 x max(1, max|twin|), at most 2 % off by more
than one bf16 step) and its lse within 1e-4:

- ``terms3``: P in three bf16 terms, not hi + lo;
- ``sync``: K and V staged by plain loads and stores, not cp.async;
- ``warps2``: 2 warps a block, not 4;
- ``mt1``: one 16-row tile of queries a warp, not 2;
- ``bkt32`` (or ``bkt64``): 32-key staged tiles (or 64), not the tree's;
- ``ring2``: a ring of 2 staged tiles, not 3;
- ``in_order``: query tiles launched first to last, not longest first.

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys

from .k5_variants import _build, _const, _entry, _kernel_ms, _swap, bf16_err

KERNEL = "prefill_attention_bf16_kernel"
ENTRY = "ev_prefill_attention_bf16"


def variants(src: str) -> dict:
    """The tree's K1 bf16 source with each design choice undone, by name."""
    def value(name):
        return _const(src, name).rsplit("=", 1)[1].strip(" ;")

    def const(name, new):
        line = _const(src, name)
        return _swap(src, line, line.rsplit("=", 1)[0] + f"= {new};")

    bkt = 32 if int(value("BKT")) == 64 else 64
    return {
        "terms3": const("TERMS", 3),
        "sync": const("ASYNC", "false"),
        "warps2": const("WARPS", 2),
        "mt1": const("MT", 1),
        f"bkt{bkt}": const("BKT", bkt),
        "ring2": const("STAGES", 2),
        "in_order": const("LONGEST_FIRST", "false"),
    }


def build_all(srcs: dict, out: str) -> dict:
    """The tree's entry point and one built from each source of ``srcs``
    (name -> CUDA source, written and built under ``out``), by name; the
    ptxas register and spill lines of each are printed."""
    from ..ops import build

    procs = {}
    for name, src in srcs.items():
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = _build(path, os.path.join(out, f"{name}.so"))
    fns = {"tree": getattr(build.build(), ENTRY)}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
        fns[name] = _entry(os.path.join(out, f"{name}.so"), ENTRY)
    return fns


def time_all(torch, fns: dict) -> dict:
    """Device ms of each build over the two s1 shapes, the tree's timed
    first and last, each held to the twin; prints a line a shape and build,
    and the sums."""
    from ..ops import attention as att

    order = ["tree", *(n for n in fns if n != "tree"), "tree"]
    gen = torch.Generator(device="cuda").manual_seed(1801)
    b, h, dk, x_len = 8, 16, 32, 416
    totals = dict.fromkeys(fns, 0.0)
    worst = {name: [0.0, 0.0, 0.0] for name in fns}   # relative, share, lse
    for y_len in (300, 1360):
        t = x_len + y_len
        x_lens = torch.randint(1, x_len + 1, (b,), generator=gen,
                               device="cuda").to(torch.int32)
        y_lens = torch.randint(1, y_len + 1, (b,), generator=gen,
                               device="cuda").to(torch.int32)
        x_lens[0], y_lens[-1] = x_len, y_len
        qkv = torch.randn((b, t, 3 * h * dk), generator=gen,
                          device="cuda").to(torch.bfloat16)
        q, k, v = att._split_heads(qkv, h)
        want = torch.nan_to_num(att.prefill_attention_reference(
            q, k, v, x_len, x_lens, y_lens), nan=0.0)
        want_lse = att.prefill_attention_lse_reference(q, k, x_len, x_lens,
                                                       y_lens)
        seen = torch.isfinite(want_lse)
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse = torch.empty((b, h, t), device="cuda")
        args = [z.data_ptr() for z in (q, k, v, o, lse)]
        args += [q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), x_lens.data_ptr(),
                 y_lens.data_ptr(), b, t, h, x_len, 1 / math.sqrt(dk),
                 torch.cuda.current_stream().cuda_stream]
        runs = {}
        for name in order:
            def run(fn=fns[name]):
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            run()
            torch.cuda.synchronize()
            rel, share = bf16_err(o, want)
            lse_err = float((lse[seen] - want_lse[seen]).abs().max())
            assert torch.equal(torch.isfinite(lse), seen), name
            assert rel <= 2.0 ** -6 and share <= 0.02 and lse_err <= 1e-4, \
                f"{name} disagrees with the twin: {rel}, {share}, {lse_err}"
            worst[name] = [max(a, c) for a, c in
                           zip(worst[name], (rel, share, lse_err))]
            runs.setdefault(name, []).append(_kernel_ms(torch, run, KERNEL))
        for name, ms in runs.items():
            totals[name] += sum(ms) / len(ms)
            print(f"T={t} {name}: K1 bf16 {sum(ms) / len(ms):.4f} ms",
                  flush=True)
    for name, ms in totals.items():
        print(f"two s1 shapes, {name}: K1 bf16 {ms:.4f} ms "
              f"({ms / totals['tree']:.3f} x the tree); against the twin: "
              f"relative {worst[name][0]:.3g}, share off by more than a step "
              f"{worst[name][1]:.3g}, lse max|d| {worst[name][2]:.3g}",
              flush=True)
    return totals


def main() -> int:
    import torch

    from ..ops import build

    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    out = os.path.join(os.path.dirname(build.BUILD_ROOT), "k1_variants")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(build.CSRC, "prefill_attention_bf16.cu")) as f:
        srcs = variants(f.read())
    time_all(torch, build_all(srcs, out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
