"""Whether the kernel library of another tree (an older commit unpacked with
``git archive``) survives, instruction for instruction, in this tree's.

    python3 -m easevoice_trainer_tpu_torch.bench.sass_diff build/parent \
        [--replaced REGEX]

Builds both libraries (each tree's ``ops/build.py``, sm_90a), disassembles
them with ``cuobjdump -sass`` and, for each kernel of the other tree, looks
for a function of this tree with the same instructions.  Names are not
compared: a kernel that gained or lost a template parameter (an element
type, while the bf16 instances shared the fp32 loops) keeps its body under
a new name.  A kernel of the other tree whose mangled name matches
``--replaced`` (``'conv_mma_kernel.*bfloat16'``: the first bf16 K3 /
K4-dx, which ``conv_bf16_kernel`` replaced) is counted apart and not
required.  Prints one line a kernel family and a summary, and exits
1 when some other kernel of the other tree has no identical body here.
Needs nvcc and a card's toolkit; not a test.
"""
from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys


def _build_module(root: str):
    """The other tree's ``ops/build.py`` loaded by path (it imports nothing
    of its package)."""
    path = os.path.join(os.path.abspath(root), "easevoice_trainer_tpu_torch",
                        "ops", "build.py")
    spec = importlib.util.spec_from_file_location("_other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass(lib_path: str, cuobjdump: str) -> dict:
    """mangled name -> list of instruction bodies (one per copy)."""
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        lines = tuple(ln.split("*/", 1)[-1].strip()
                      for ln in body.splitlines()
                      if re.search(r"/\*[0-9a-f]{4}\*/", ln))
        funcs.setdefault(name.strip(), []).append(lines)
    return funcs


def family(mangled: str) -> str:
    m = re.search(r"\d+([a-z_]+kernel)", mangled)
    return m.group(1) if m else mangled


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--replaced", metavar="REGEX",
                    help="mangled names of kernels replaced by design")
    args = ap.parse_args(argv)
    from ..ops import build

    mine = build.build()
    theirs = _build_module(args.other).build()
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    new, old = sass(mine.path, cuobjdump), sass(theirs.path, cuobjdump)
    have = {b for bodies in new.values() for b in bodies}
    by_family, replaced = {}, 0
    for name, bodies in old.items():
        if args.replaced and re.search(args.replaced, name):
            replaced += len(bodies)
            continue
        hit = by_family.setdefault(family(name), [0, 0])
        hit[0] += sum(b in have for b in bodies)
        hit[1] += len(bodies)
    for fam, (same, total) in sorted(by_family.items()):
        print(f"[sass] {fam}: {same} of the other tree's {total} bodies "
              f"found here instruction for instruction")
    same = sum(v[0] for v in by_family.values())
    total = sum(v[1] for v in by_family.values())
    print(f"[sass] {same} of {total} kernel bodies of {args.other} are in "
          f"this tree's library unchanged ({replaced} replaced by design not "
          f"counted); this library has {sum(map(len, new.values()))} bodies "
          f"in all")
    return 0 if same == total else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
