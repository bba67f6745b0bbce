"""A run loads no module whose top-level name, compared whole, is jax,
jaxlib, flax or the JAX package (the port's name begins with the JAX
package's, so a prefix test would be wrong)."""
import subprocess
import sys

from evbench import common

CODE = r"""
import sys, importlib
sys.path.insert(0, sys.argv[1])
from evbench import run, common
import evbench.tests.conftest as c
cfg, traffic = c.tiny_s1.__wrapped__()
bench = common.benchmark()
line, rc = run.run(bench, common.cell(bench, "s1_long_b32"), cfg, traffic,
                   5, 0.2, True, device="cpu",
                   driver_module=importlib.import_module(
                       "evbench.drivers.gpt_s1"))
for name in ("evbench.drivers.sovits_s2", "evbench.calibrate"):
    importlib.import_module(name)
print("LOADED", common.top_level_modules())
print("FORBIDDEN", common.forbidden_loaded())
"""


def test_whole_names_compared():
    assert "easevoice_trainer_tpu_torch".split(".")[0] not in \
        common.FORBIDDEN_MODULES
    assert common.FORBIDDEN_MODULES == ("jax", "jaxlib", "flax",
                                        "easevoice_trainer_tpu")


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", CODE, common.ROOT],
                         capture_output=True, text=True, check=True,
                         cwd=common.ROOT).stdout
    loaded = out.split("LOADED")[1].split("\n")[0]
    assert "'easevoice_trainer_tpu_torch'" in loaded
    assert out.strip().endswith("FORBIDDEN []")
