"""Packaging rules of the PyTorch port.

The port and ``chip_smoke.py`` import neither jax nor the JAX package
(the machine with the card has no jax), its entry points refuse to fall
back to the CPU, and the smoke script fails without a card.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cellregmap_tpu_torch as crp

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cellregmap_tpu_torch"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "cellregmap_tpu")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _python(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_leaves_jax_out():
    r = _python(
        "import sys, cellregmap_tpu_torch, cellregmap_tpu_torch.api, "
        "cellregmap_tpu_torch.engine, cellregmap_tpu_torch.kernels, "
        "cellregmap_tpu_torch.models.pvalues, chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cellregmap_tpu')]\n"
        "assert not bad, bad\nprint('clean')")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_no_card_without_explicit_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    y, E = rng.normal(size=20), rng.normal(size=(20, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crp.CellRegMap(y=y, E=E)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crp.run_interaction(y, E, rng.normal(size=(20, 3)))
    assert crp.CellRegMap(y=y, E=E, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    # alone in a directory, without the package beside it
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
