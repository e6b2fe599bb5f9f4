"""hodor_tpu_torch and every one of its modules import without JAX."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import hodor_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hodor_tpu_torch.__path__, "hodor_tpu_torch.")]
for name in names:
    importlib.import_module(name)
missing = [m for m in ("hodor_tpu_torch.utils.native", "hodor_tpu_torch.models.vdf",
                      "hodor_tpu_torch.checkpoint", "hodor_tpu_torch.config",
                      "hodor_tpu_torch.poly", "hodor_tpu_torch.models.fp2",
                      "hodor_tpu_torch.models.tensor_lde", "hodor_tpu_torch.utils.poly_scalar",
                      "hodor_tpu_torch.utils.hashers", "hodor_tpu_torch.parallel",
                      "hodor_tpu_torch.parallel.multihost", "hodor_tpu_torch.parallel.fri",
                      "hodor_tpu_torch.tools.dryrun",
                      "hodor_tpu_torch.tools.multihost_worker",
                      "hodor_tpu_torch.tools.bench", "hodor_tpu_torch.tools.gen_golden")
           if m not in names]
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "hodor_tpu.")))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 20 else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
