"""K1's design choices, each taken back in turn, timed on the card.

    python3 -m easevoice_trainer_tpu_torch.bench.k1_variants [--dropout] \
        [--dtype bf16|fp32] [--parent DIR]

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

``--dropout`` times the instance with dropout instead (p = 0.1, writing
its keep bits as the fine-tune does; o held to the twin with the same
mask, the bits to ``keep_bits_reference`` bit for bit), with the choices of
that instance undone (``variants_dropout``):

- ``drop_mt<n>``: the other count (1 or 2) of 16-row tiles of queries a
  warp;
- ``drop_cap<n>``: one block an SM fewer asked of its launch bounds;

and the tree's instance once more without writing the bits
(``tree_no_bits``: a null pointer, as ``prefill_attention_lse`` without
``mask_bits``), and with ``--parent DIR`` the instance of another tree (an
older commit unpacked with ``git archive``) whose entry point takes no bits
(``parent``).

``--dtype fp32`` (with ``--dropout``) times the fp32 instance with dropout
(``csrc/prefill_attention.cu``; o within 1e-4 of the twin, as chip_smoke
holds it) the same way, beside ``tree_no_bits`` and ``parent``; it has no
constant to undo.

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys

from .k5_variants import _build, _const, _entry, _kernel_ms, _swap, bf16_err

# by dtype: the source, its kernel's name and its entry point without
# dropout (the one with dropout adds "dropout_")
SOURCES = {
    "bf16": ("prefill_attention_bf16.cu", "prefill_attention_bf16_kernel",
             "ev_prefill_attention_bf16"),
    "fp32": ("prefill_attention.cu", "prefill_attention_kernel",
             "ev_prefill_attention_f32"),
}


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


def variants_dropout(src: str) -> dict:
    """The tree's K1 bf16 source with each design choice of the instance
    with dropout undone, by name."""
    def const(name, new):
        line = _const(src, name)
        return _swap(src, line, line.rsplit("=", 1)[0] + f"= {new};")

    def value(name):
        return int(_const(src, name).rsplit("=", 1)[1].strip(" ;"))

    blocks, mt = value("DROP_MIN_BLOCKS") - 1, 3 - value("DROP_MT")
    return {f"drop_mt{mt}": const("DROP_MT", mt),
            f"drop_cap{blocks}": const("DROP_MIN_BLOCKS", blocks)}


def build_all(srcs: dict, out: str, entry: str, parent: str = None,
              source: str = SOURCES["bf16"][0]) -> dict:
    """The tree's entry point and one built from each source of ``srcs``
    (name -> CUDA source, written and built under ``out``), by name; the
    ptxas register and spill lines of each are printed.  ``parent``: the
    root of another tree, whose instance with dropout (an entry point
    without the bits, from its ``source``) is built too, as "parent"."""
    from ..ops import build

    procs = {}
    for name, src in srcs.items():
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = _build(path, os.path.join(out, f"{name}.so"))
    if parent is not None:
        csrc = os.path.join(os.path.abspath(parent),
                            "easevoice_trainer_tpu_torch", "csrc")
        procs["parent"] = _build(os.path.join(csrc, source),
                                 os.path.join(out, "parent.so"), csrc)
    fns = {"tree": getattr(build.build(), entry)}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
        argtypes = None
        if name == "parent":   # no bits before the stream
            argtypes = build.SIGNATURES[entry][:-2] + \
                build.SIGNATURES[entry][-1:]
        fns[name] = _entry(os.path.join(out, f"{name}.so"), entry, argtypes)
    return fns


def time_all(torch, fns: dict, dropout: bool = False,
             dtype: str = "bf16") -> dict:
    """Device ms of each build over the two s1 shapes, the tree's timed
    first and last, each held to the twin; prints a line a shape and build,
    and the sums.  ``dropout``: the builds' dropout entry points (p = 0.1),
    each held to the twin with the same mask and its bits to
    ``keep_bits_reference``.  ``dtype``: bf16 or fp32 (o within 1e-4 of the
    twin)."""
    from ..ops import attention as att
    from ..ops.philox import keep_threshold

    kernel = SOURCES[dtype][1]
    bf = dtype == "bf16"
    label = f"K1 {dtype}{' dropout' if dropout else ''}"
    order = ["tree", *(n for n in fns if n != "tree"), "tree"]
    if dropout:   # the tree's instance writing no bits
        fns = {**fns, "tree_no_bits": fns["tree"]}
        order.insert(-1, "tree_no_bits")
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
                          device="cuda").to(torch.bfloat16 if bf
                                            else torch.float32)
        q, k, v = att._split_heads(qkv, h)
        drop = att.AttentionDropout(0.1, 0x1801, 9) if dropout else None
        mask = drop.keep_mask(b, h, t, x_len, "cuda") if dropout else None
        want = torch.nan_to_num(att.prefill_attention_reference(
            q, k, v, x_len, x_lens, y_lens, mask, 0.1 if dropout else 0.0),
            nan=0.0)
        bits = att.new_mask_bits(q, x_len)
        want_bits = att.keep_bits_reference(mask, x_len, x_lens, y_lens) \
            if dropout else None
        want_lse = att.prefill_attention_lse_reference(q, k, x_len, x_lens,
                                                       y_lens)
        seen = torch.isfinite(want_lse)
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse = torch.empty((b, h, t), device="cuda")
        args = [z.data_ptr() for z in (q, k, v, o, lse)]
        args += [q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), x_lens.data_ptr(),
                 y_lens.data_ptr(), b, t, h, x_len, 1 / math.sqrt(dk)]
        if dropout:
            args += [drop.seed, drop.layer, keep_threshold(0.1), 0.9, 0, 0,
                     bits.data_ptr()]
        args += [torch.cuda.current_stream().cuda_stream]
        runs = {}
        for name in order:
            call = args
            if name == "tree_no_bits":
                call = [*args[:-2], None, args[-1]]
            elif name == "parent":
                call = [*args[:-2], args[-1]]

            def run(fn=fns[name], call=call):
                rc = fn(*call)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            bits.fill_(-1)
            run()
            torch.cuda.synchronize()
            assert not dropout or name in ("tree_no_bits", "parent") or \
                torch.equal(bits, want_bits), \
                f"{name}: the keep bits are not keep_bits_reference's"
            if bf:
                rel, share = bf16_err(o, want)
                ok = rel <= 2.0 ** -6 and share <= 0.02
            else:
                rel, share = float((o - want).abs().max()), 0.0
                ok = rel <= 1e-4
            lse_err = float((lse[seen] - want_lse[seen]).abs().max())
            assert torch.equal(torch.isfinite(lse), seen), name
            assert ok and lse_err <= 1e-4, \
                f"{name} disagrees with the twin: {rel}, {share}, {lse_err}"
            worst[name] = [max(a, c) for a, c in
                           zip(worst[name], (rel, share, lse_err))]
            runs.setdefault(name, []).append(_kernel_ms(torch, run, kernel))
        for name, ms in runs.items():
            totals[name] += sum(ms) / len(ms)
            print(f"T={t} {name}: {label} {sum(ms) / len(ms):.4f} ms",
                  flush=True)
    for name, ms in totals.items():
        print(f"two s1 shapes, {name}: {label} {ms:.4f} ms "
              f"({ms / totals['tree']:.3f} x the tree); against the twin: "
              + (f"relative {worst[name][0]:.3g}, share off by more than a "
                 f"step {worst[name][1]:.3g}" if bf else
                 f"max|d| {worst[name][0]:.3g}")
              + f", lse max|d| {worst[name][2]:.3g}", flush=True)
    return totals


def main(argv=None) -> int:
    import argparse

    import torch

    from ..ops import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dropout", action="store_true",
                    help="the instance with dropout and its own choices")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16",
                    help="the instance's dtype (fp32 with --dropout only)")
    ap.add_argument("--parent", metavar="DIR",
                    help="with --dropout: another tree's instance too")
    args = ap.parse_args(argv)
    if args.dtype == "fp32" and not args.dropout:
        ap.error("--dtype fp32 times the instance with dropout: add "
                 "--dropout")
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # the fp32 twin
    out = os.path.join(os.path.dirname(build.BUILD_ROOT), "k1_variants",
                       args.dtype)
    os.makedirs(out, exist_ok=True)
    source, _, entry = SOURCES[args.dtype]
    with open(os.path.join(build.CSRC, source)) as f:
        src = f.read()
    if args.dropout:
        srcs = variants_dropout(src) if args.dtype == "bf16" else {}
        entry = entry.replace("attention_", "attention_dropout_")
        time_all(torch, build_all(srcs, out, entry, args.parent, source),
                 dropout=True, dtype=args.dtype)
    else:
        time_all(torch, build_all(variants(src), out, entry))
    return 0


if __name__ == "__main__":
    sys.exit(main())
