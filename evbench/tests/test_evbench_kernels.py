"""The table of the program's kernels (``evbench/kernels/``): each counter
it names is one of ``ops.launch_counts()``, each group's regex names
kernels the program defines, a counter it does not name is left out of the
traced run's count, and a file added beside a group extends it."""
import glob
import json
import os
import re
import shutil

from evbench import common, evtrace

CSRC = os.path.join(common.ROOT, "easevoice_trainer_tpu_torch", "csrc")


def _kernel_names():
    names = set()
    for path in glob.glob(os.path.join(CSRC, "*.cu*")):
        with open(path, encoding="utf8") as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+_kernel)\b", f.read()))
    return names


def test_counters_are_the_programs():
    from easevoice_trainer_tpu_torch import ops

    counts = ops.launch_counts()
    for name, group in evtrace.kernel_groups().items():
        assert group["counters"] <= set(counts), name


def test_each_group_names_kernels_the_program_defines():
    names = _kernel_names()
    assert names
    for group in evtrace.kernel_groups():
        rx = re.compile(evtrace.kernels_of(group))
        assert any(rx.search(f"void {n}<32>(float*)") for n in names), group
    # every kernel of csrc/ is in the table, so the count is whole
    rx = re.compile(evtrace.kernels_of())
    assert all(rx.search(f"void {n}<1>()") for n in names), names


def test_a_counter_the_table_does_not_name_is_left_out():
    counts = {"prefill_attention_bf16": 48, "mrf_conv_bf16": 90,
              "scaled_adam_multi_tensor": 7}
    assert evtrace.counted_launches(counts) == 138


def test_a_file_beside_a_group_extends_it(tmp_path):
    table = tmp_path / "kernels"
    shutil.copytree(evtrace.KERNEL_TABLE, table)
    (table / "k5.renamed.json").write_text(json.dumps(
        {"why": "a renamed K5 kernel", "counters": ["k5_new_counter"],
         "kernels": r"\bdkdv_wgmma_kernel\b"}))
    groups = evtrace.kernel_groups(str(table))
    assert "k5_new_counter" in groups["k5"]["counters"]
    rx = re.compile(evtrace.kernels_of("k5", table=str(table)))
    assert rx.search("void dkdv_wgmma_kernel<true>()")
    assert rx.search("void dq_bf16_kernel<false>()")
    assert not rx.search("void prefill_attention_bf16_kernel<true>()")
    assert evtrace.counted_launches({"k5_new_counter": 3},
                                    str(table)) == 3
