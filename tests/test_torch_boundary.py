"""Package boundary of the PyTorch port: it never loads JAX or the reference
package, and its entry points refuse to run without a card unless the
caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.api as tapi
from repro_torch import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def test_import_loads_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _offenders(files) -> list:
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names if _forbidden(n)]
    return offenders


def test_no_jax_or_reference_import_in_sources():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 15
    assert _offenders(files) == []


def test_no_jax_or_reference_import_in_examples_and_scripts():
    """The port's examples, CI smoke scripts and ``inspect_cell.py``, and
    the chip smoke."""
    files = sorted([*(ROOT / "examples" / "torch").glob("*.py"),
                    *(ROOT / "scripts" / "torch").glob("*.py"), ROOT / "chip_smoke.py"])
    assert len(files) == 11
    assert _offenders(files) == []


def test_partition_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    spec = tapi.PartitionSpec(algo="fennel", k=2, source="rmat:64:4")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.partition(spec)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.partition(spec, device="cuda")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
