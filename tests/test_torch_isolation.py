"""The port stands apart from JAX and has no CPU fallback for the card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import partitionedhashjoin_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 12, names
for needed in ("ops.hashing", "ops.kernels.bitonic_sort", "ops.kernels.generate"):
    assert pkg.__name__ + "." + needed in names, needed
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "partitionedhashjoin_tpu.")))
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_modules_never_import_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_chip_smoke_fails_without_a_card(tmp_path):
    """On a machine without a CUDA device chip_smoke.py must fail and print
    no result — both in the repository and alone in an empty directory."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for cwd in (REPO, alone):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0, proc.stdout
        assert '"ok": true' not in proc.stdout
