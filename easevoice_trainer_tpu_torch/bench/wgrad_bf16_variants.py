"""The design choices of K4-dW's bf16 wgmma route, each taken back in turn,
timed on the card.

    python3 -m easevoice_trainer_tpu_torch.bench.wgrad_bf16_variants
    python3 -m easevoice_trainer_tpu_torch.bench.wgrad_bf16_variants --phases

Writes variants of ``csrc/mrf_conv_wgrad.cu`` under
``build/wgrad_bf16_variants/`` (git-ignored), each with one choice undone
and its entry points renamed, builds them with nvcc (one process a
variant) into one library beside the tree's, and times the bf16 instance
of every build on the 45 s2 shapes of ``chip_smoke.py`` (B = 8, every
Generator stage, k in {3, 7, 11}, d in {1, 3, 5}), beside cuDNN's bf16
wgrad.  Each plan is the planner's (``ops/mrf.py wgrad_plan``) with the
clusters that the build's own cooperative-launch probe accepts.  A time
is the device time of one call as torch.profiler records it, the mean over
20 calls of one shape, summed over the shapes (one kernel a call).  Every
build's dW / db are held against the bf16 twin (within 2^-6 x max(1,
max|twin|)).  Builds:

- ``tree``: the route as it is (both operands by descriptor, 128 output
  channels a tile where Cout > 64, 128-sample stages, TMA copies);
- ``operand_b``: design (b), the shifted lrelu(x) as the register operand
  A, read from the same M-major tile by ldmatrix.trans (8 channels x 8
  samples a matrix, the A fragment's sample pairs), one wgmma a k-step and
  the next fragment loaded while it runs;
- ``bn64``: 64 output channels a tile at every width (the tree's library,
  the planner's ``bn`` = 64);
- ``ts64``: 64-sample stages (TSB and the planner's WGRAD_TS_BF16);
- ``cp_async``: dy and x copied by cp.async, 16 bytes a thread, not by
  TMA (each thread waits for its own copies, then a block barrier before
  each transpose);
- ``plain_loads``: dy and x copied by plain loads by every thread (the
  kernel's path for rows that are not 16-byte aligned), not by TMA;
- ``mma_c64``: the mma.sync route of the parent at C = 64 (the tree's
  library, the planner's ``bn`` = 32).  Only stage 2 differs.

Prints the card's name and power limit first, then one line a stage and
build, and the sums over stages 0-2 and the 45 shapes.

``--phases`` instead builds one copy of the route whose thread 0 of each
block stamps %globaltimer (ns) at its start, after the prologue (tiles 0
and 1 copied, tile 0 transposed), after the loop over its time tiles,
after the partial sums are parked and added in the cluster, after the
grid-wide barrier and at its end, and prints, for every shape of stages
0-2, the mean over blocks of each phase in us beside the plan and the
device time of the call.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

SOURCE = "mrf_conv_wgrad.cu"

# design (b): the register-A form of the bf16 wgmma
_REG_A = '''
namespace ev {
template <int N>
struct WgmmaBf16RegA {
  __device__ __forceinline__ static void mma(float (&d)[N / 2],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    if constexpr (N == 64) {
      asm volatile(
        "{\\n.reg .pred p;\\nsetp.ne.b32 p, %37, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\\n}\\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    } else {
      asm volatile(
        "{\\n.reg .pred p;\\nsetp.ne.b32 p, %69, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\\n}\\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
  }
};
}  // namespace ev
'''

_DESC_LOOP = '''      const uint64_t da = interleave_desc(xs + (shift + qrow) * 8, 128,
                                          rx * 16);
      const uint64_t dd = interleave_desc(ys, BN * 16, 128);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TSB / 16; ++ks)
        WgmmaBf16<BN>::mma(acc, da + (uint64_t)(16 * ks),
                           dd + (uint64_t)(2 * BN * ks));
      wgmma_commit();
'''

# warp w of the warpgroup holds input channels 16 w .. 16 w + 15: planes
# 2 w and 2 w + 1; matrix j of ldmatrix.x4.trans is plane 2 w + (j & 1),
# samples 8 (j >> 1) .. + 7 of the k-step, lane l giving its row l % 8
_REG_LOOP = '''      const uint64_t dd = interleave_desc(ys, BN * 16, 128);
      const int wq = (tid >> 5) & 3, mj = lane >> 3;
      const uint32_t a0 = smem_addr(
          xs + ((2 * wq + (mj & 1)) * rx + shift + qrow + 8 * (mj >> 1) +
                (lane & 7)) * 8);
#pragma unroll 2
      for (int ks = 0; ks < TSB / 16; ++ks) {
        uint32_t a[4];
        ldsm4_trans(a, a0 + 256 * ks);
        wgmma_fence();
        WgmmaBf16RegA<BN>::mma(acc, a, dd + (uint64_t)(2 * BN * ks));
        wgmma_commit();
        wgmma_wait<1>();
      }
'''


_TMA_COPY = """    if (tma) {
      if (tid == 0) {
        uint64_t* bar = &bars[i % DY_SLOTS];
        mbar_expect(bar, 2 * (DYS + xsize));
        tma_load_4d(ys, &map_dy, bar, 0, n0, t0 / 8, b);
        tma_load_4d(raw, &map_x, bar, 0, m0, u0 / 8, b);
      }
      return;
    }
"""

# the same pieces of 8 samples a thread by cp.async, then each thread waits
# for its own copies and a block barrier publishes them
_CP_ASYNC_COPY = """    if (tma) {
      const bf16* dyb = dy + (long long)b * Cout * T;
      for (int p = tid; p < BN * (TSB / 8); p += NTHR) {
        const int o = p % BN, c = p / BN, t = t0 + 8 * c;
        const bool ok = n0 + o < Cout && t < T;
        cp_async16(ys + (c * BN + o) * 8,
                   ok ? dyb + (long long)(n0 + o) * T + t : dy, ok);
      }
      const bf16* xb = x + (long long)b * Cin * T;
      for (int p = tid; p < BM * (rx / 8); p += NTHR) {
        const int r = p % BM, c = p / BM, t = u0 + 8 * c;
        const bool ok = m0 + r < Cin && t >= 0 && t < T;
        cp_async16(raw + (c * BM + r) * 8,
                   ok ? xb + (long long)(m0 + r) * T + t : x, ok);
      }
      cp_async_commit();
      return;
    }
"""


def variants() -> dict:
    """name -> [(old, new), ...] patches of the source."""
    return {
        "operand_b": [('#include "wgmma_tf32.cuh"\n',
                       '#include "wgmma_tf32.cuh"\n' + _REG_A),
                      (_DESC_LOOP, _REG_LOOP)],
        "ts64": [("constexpr int TSB = 128;", "constexpr int TSB = 64;")],
        "cp_async": [
            (_TMA_COPY, _CP_ASYNC_COPY),
            ("    if (i >= share.n) return;\n    int b;\n    const int t0 = "
             "tile_t0(i, b);\n    const int u0",
             "    if (i >= share.n) {\n      if (tma) cp_async_commit();\n"
             "      return;\n    }\n    int b;\n    const int t0 = "
             "tile_t0(i, b);\n    const int u0"),
            ("    if (tma)\n      mbar_wait(&bars[i % DY_SLOTS], (i / "
             "DY_SLOTS) & 1);\n",
             "    if (tma) {\n      cp_async_wait<1>();\n      "
             "__syncthreads();\n    }\n")],
        "plain_loads": [
            ("  constexpr int DYS = BN * TSB;  // bf16 of a dy stage\n",
             "  constexpr int DYS = BN * TSB;  // bf16 of a dy stage\n"
             "  tma = 0;\n")],
    }


def _write(csrc: str, out: str) -> list:
    """The variants' sources under ``out``, their entry points renamed
    ``ev_wgv_<name>...``; returns the (name, source) pairs."""
    src = open(os.path.join(csrc, SOURCE)).read()
    made = []
    for name, patches in variants().items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source changed")
            text = text.replace(old, new)
        text = text.replace("ev_mrf_conv_bwd_weight", f"ev_wgv_{name}")
        os.makedirs(out, exist_ok=True)
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        made.append((name, cu))
    return made


def _stamp(n: int) -> str:
    return ("if (threadIdx.x == 0) { unsigned long long t_; asm volatile("
            "\"mov.u64 %0, %globaltimer;\" : \"=l\"(t_)); g_phase[blockIdx.y "
            f"* gridDim.x + blockIdx.x][{n}] = t_; }}")


def _phases_source(csrc: str) -> str:
    """The route with the six stamps of ``--phases``, its entry points
    renamed ``ev_wgv_phases...``, plus ``ev_wgv_phases_read``."""
    src = open(os.path.join(csrc, SOURCE)).read()
    r4 = src.index("__device__ void reduce_partials4(")
    head, tail = src[:r4], src[r4:]
    k0 = tail.index("wgrad_wgmma_bf16_kernel(")
    pre, body = tail[:k0], tail[k0:]
    patches = [
        (pre, "  if (nc > 1) {\n    __threadfence();\n    cg::this_grid()"
              ".sync();\n",
         f"  {_stamp(3)}\n  if (nc > 1) {{\n    __threadfence();\n    "
         f"cg::this_grid().sync();\n    {_stamp(4)}\n"),
        (body, "  if (B == 0) return;  // a probe launch "
               "(ev_mrf_conv_bwd_weight_max_clusters)\n",
         f"  if (B == 0) return;\n  {_stamp(0)}\n"),
        (body, "  fence_proxy_async();\n  __syncthreads();\n  for (int i = 0; "
               "i < share.n; ++i) {",
         f"  fence_proxy_async();\n  __syncthreads();\n  {_stamp(1)}\n  "
         f"for (int i = 0; i < share.n; ++i) {{"),
        (body, "  // the stages are free: park",
         f"  {_stamp(2)}\n  // the stages are free: park"),
        (body, "  reduce_partials4(part, out, dw, db, scratch, Cin, Cout, K, "
               "cs, nc);\n}",
         "  reduce_partials4(part, out, dw, db, scratch, Cin, Cout, K, cs, "
         f"nc);\n  {_stamp(5)}\n}}"),
    ]
    parts = {"pre": pre, "body": body}
    for text, old, new in patches:
        key = "pre" if text is pre else "body"
        if old not in parts[key]:
            raise RuntimeError("--phases: the source changed")
        parts[key] = parts[key].replace(old, new, 1)
    head = head.replace("namespace {\n", "namespace {\n__device__ unsigned "
                        "long long g_phase[8192][8];\n", 1)
    text = head + parts["pre"] + parts["body"] + (
        '\nextern "C" int ev_wgv_phases_read(void* dst) {\n  return '
        '(int)cudaMemcpyFromSymbol(dst, g_phase, sizeof(g_phase));\n}\n')
    return text.replace("ev_mrf_conv_bwd_weight", "ev_wgv_phases")


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
        lines = log.splitlines()
        for i, line in enumerate(lines):  # ptxas on the bf16 wgmma bodies
            if "Compiling entry" in line and "wgrad_wgmma_bf16" in line:
                print(f"[variants] {name} ptxas: " + " | ".join(
                    ln.split("info    :")[-1].strip()
                    for ln in lines[i + 1:i + 4]), flush=True)
    so = os.path.join(out, "libvariants.so")
    subprocess.run([nvcc, "-shared", "-o", so,
                    *[cu + ".o" for _, cu in made]], check=True)
    return ctypes.CDLL(so)


def device_ms(torch, fn, launches=None, reps: int = 20) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls, from
    torch.profiler: every kernel of the call.  With ``launches`` (the
    kernels a call launches) a session short of kernels is taken again, and
    the longest of three is scaled up to the count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = None if launches is None else launches * reps
    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        best = max(best, got, key=len)
        if got and (want is None or len(got) >= want):
            break
    if not best:
        raise RuntimeError("torch.profiler recorded no CUDA activity")
    scale = want / len(best) if want and len(best) < want else 1.0
    return scale * sum(best) / reps / 1000.0


def phases(torch, build, mrf, out: str) -> None:
    """``--phases``: the mean time of each phase of a block, per shape."""
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "phases.cu")
    with open(cu, "w") as f:
        f.write(_phases_source(build.CSRC))
    lib = _build([("phases", cu)], build.CSRC, out, build)
    run = lib.ev_wgv_phases_bf16
    probe = lib.ev_wgv_phases_max_clusters_bf16
    run.argtypes = build.SIGNATURES["ev_mrf_conv_bwd_weight_bf16"]
    probe.argtypes = [ctypes.c_int] * 7
    lib.ev_wgv_phases_read.argtypes = [ctypes.c_void_p]
    bf = torch.bfloat16
    slope = mrf.weak_scalar(mrf.LRELU_SLOPE, bf)
    stamps = torch.zeros((8192, 8), dtype=torch.int64)
    names = ("prologue", "loop", "park + cluster sum", "grid barrier",
             "scratch sum + write")
    gen = torch.Generator(device="cuda").manual_seed(1414)
    for ch, t_len in ((256, 320), (128, 2560), (64, 5120)):
        x = torch.randn((8, ch, t_len), generator=gen, device="cuda").to(bf)
        dy = torch.randn((8, ch, t_len), generator=gen,
                         device="cuda").to(bf)
        total = [0.0] * 6
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                plan = mrf.wgrad_plan(
                    8, ch, ch, t_len, k, d,
                    lambda bn, bi, taps, cl: probe(bn, bi, taps, k, d, cl, 1),
                    dtype=bf)
                dw = torch.empty((ch, ch, k), dtype=bf, device="cuda")
                db = torch.empty((ch,), dtype=bf, device="cuda")
                scratch = torch.empty((max(1, plan.scratch_floats),),
                                      dtype=torch.float32, device="cuda")

                def call(plan=plan, dw=dw, db=db, scratch=scratch):
                    build.check(run(
                        dy.data_ptr(), x.data_ptr(), dw.data_ptr(),
                        db.data_ptr(), scratch.data_ptr(), 8, ch, ch, t_len,
                        k, d, slope, plan.bn, plan.bi, plan.taps,
                        plan.cluster, plan.clusters,
                        torch.cuda.current_stream().cuda_stream), "phases")

                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                build.check(lib.ev_wgv_phases_read(stamps.data_ptr()),
                            "phases")
                t = stamps[:plan.blocks].double() / 1000.0
                if plan.clusters == 1:  # no barrier: one phase after park
                    t[:, 4] = t[:, 3]
                ph = [float((t[:, j + 1] - t[:, j]).mean())
                      for j in range(5)]
                ms = device_ms(torch, call, 1)
                total = [a + b for a, b in zip(total, ph + [ms * 1000])]
                tiles = plan.time_tiles / plan.splits
                print(f"[phases] C={ch} k={k} d={d} (tile {plan.bn}, "
                      f"{plan.tiles} tiles x {plan.cluster} x "
                      f"{plan.clusters} clusters, {tiles:.1f} time tiles a "
                      f"block): " + ", ".join(
                          f"{n} {v:.2f}" for n, v in zip(names, ph))
                      + f" us ({ph[1] / tiles:.2f} a time tile); device "
                      f"{ms * 1000:.2f} us", flush=True)
        print(f"[phases] C={ch}, 9 shapes, sums of the block means: "
              + ", ".join(f"{n} {v:.1f}" for n, v in zip(names, total))
              + f" us; device {total[5]:.1f} us", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    from ..ops import build, mrf

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", action="store_true",
                    help="time the phases of a block instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wgrad_bf16_variants: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(build.CSRC))
    out = os.path.join(root, "build", "wgrad_bf16_variants")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[variants] {smi}", flush=True)
    if args.phases:
        phases(torch, build, mrf, out)
        return 0
    made = _write(build.CSRC, out)
    vlib = _build(made, build.CSRC, out, build)
    tree = build.build()
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    bf = torch.bfloat16
    slope = mrf.weak_scalar(mrf.LRELU_SLOPE, bf)
    dev = torch.device("cuda")

    def entry(lib, prefix):
        run = getattr(lib, f"{prefix}_bf16")
        probe = getattr(lib, f"{prefix}_max_clusters_bf16")
        run.argtypes = build.SIGNATURES["ev_mrf_conv_bwd_weight_bf16"]
        probe.argtypes = [I] * 7
        return run, probe

    # build -> (library entry, probe, planner bn, stage samples)
    builds = {"tree": (*entry(tree, "ev_mrf_conv_bwd_weight"), None,
                       mrf.WGRAD_TS_BF16),
              "bn64": (*entry(tree, "ev_mrf_conv_bwd_weight"), 64,
                       mrf.WGRAD_TS_BF16),
              "mma_c64": (*entry(tree, "ev_mrf_conv_bwd_weight"), "c64",
                          mrf.WGRAD_TS_BF16)}
    for name, _ in made:
        builds[name] = (*entry(vlib, f"ev_wgv_{name}"), None,
                        64 if name == "ts64" else mrf.WGRAD_TS_BF16)

    def plan_of(name, b, ch, t_len, k, d):
        run, probe, bn, ts = builds[name]
        if bn == "c64":
            bn = 32 if ch == 64 else None
        if bn == 64 and ch < 64:
            bn = None

        def clusters(bn_, bi, taps, cluster):
            n = probe(bn_, bi, taps, k, d, cluster, 1)
            if n < 0:
                raise RuntimeError(f"{name}: cluster probe failed ({-n})")
            return n

        saved = mrf.WGRAD_TS_BF16
        mrf.WGRAD_TS_BF16 = ts
        try:
            return mrf.wgrad_plan(b, ch, ch, t_len, k, d, clusters,
                                  dtype=bf, bn=bn)
        finally:
            mrf.WGRAD_TS_BF16 = saved

    gen = torch.Generator(device="cuda").manual_seed(1414)
    totals = {}
    for si, (ch, t_len) in enumerate(((256, 320), (128, 2560), (64, 5120),
                                      (32, 10240), (16, 20480))):
        x = torch.randn((8, ch, t_len), generator=gen, device=dev).to(bf)
        dy = torch.randn((8, ch, t_len), generator=gen, device=dev).to(bf)
        act = mrf.leaky_relu(x)
        stage = {}
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                shape = (ch, ch, k)
                pad = (k - 1) * d // 2
                ww, wb = mrf.mrf_conv_bwd_weight_reference(dy, x, shape, d)
                top = max(1.0, float(ww.float().abs().max()),
                          float(wb.float().abs().max()))
                runs = {"cuDNN": lambda: torch.nn.grad.conv1d_weight(
                    act, shape, dy, padding=pad, dilation=d)}
                for name, (run, _, _, _) in builds.items():
                    plan = plan_of(name, 8, ch, t_len, k, d)
                    dw = torch.empty(shape, dtype=bf, device=dev)
                    db = torch.empty((ch,), dtype=bf, device=dev)
                    scratch = torch.empty((max(1, plan.scratch_floats),),
                                          dtype=torch.float32, device=dev)

                    def call(run=run, plan=plan, dw=dw, db=db,
                             scratch=scratch):
                        build.check(run(
                            dy.data_ptr(), x.data_ptr(), dw.data_ptr(),
                            db.data_ptr(), scratch.data_ptr(), 8, ch, ch,
                            t_len, k, d, slope, plan.bn, plan.bi, plan.taps,
                            plan.cluster, plan.clusters,
                            torch.cuda.current_stream().cuda_stream), "wgv")
                        return dw, db

                    gw, gb = call()
                    err = max(float((gw.float() - ww.float()).abs().max()),
                              float((gb.float() - wb.float()).abs().max()))
                    if err > 2.0 ** -6 * top:
                        raise RuntimeError(f"{name} C={ch} k={k} d={d}: "
                                           f"max|d| {err}")
                    runs[name] = call
                for name, fn in runs.items():
                    stage[name] = stage.get(name, 0.0) + device_ms(
                        torch, fn, None if name == "cuDNN" else 1)
        for name, ms in stage.items():
            totals.setdefault(name, [0.0, 0.0])
            totals[name][1] += ms
            if si < 3:
                totals[name][0] += ms
            print(f"[variants] stage {si} (C={ch}, T={t_len}), 9 shapes: "
                  f"{name} {ms:.4f} ms ({ms / stage['tree']:.3f}x the "
                  f"tree's)", flush=True)
        del x, dy, act
        torch.cuda.empty_cache()
    for name, (c64, all45) in totals.items():
        print(f"[variants] {name}: stages 0-2 {c64:.4f} ms "
              f"({c64 / totals['tree'][0]:.3f}x the tree's), 45 shapes "
              f"{all45:.4f} ms ({all45 / totals['tree'][1]:.3f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
