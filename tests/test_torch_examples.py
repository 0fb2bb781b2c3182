"""The port's examples (``examples/torch/``) on the CPU, against the
reference's (``examples/``).

The reference's graph examples run as child processes (JAX on the CPU), all
started together when the module's first test asks for them; the port's run
in this process with ``--device cpu``. The graph examples run at their own
sizes and print the reference's lines; the LM examples call the port's
drivers with the reference examples' arguments plus ``--device``. The CI
smoke scripts (``scripts/torch/``) are held in ``test_torch_surface.py``.
"""
import os
import re
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.launch.serve as tserve
import repro_torch.launch.train as ttrain
from repro_torch.configs import get_model_config
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4  # tests/test_torch_train.py's train tolerance
GRAPH_EXAMPLES = ("quickstart", "analytics_pagerank", "moe_placement")


def start_reference(script: Path, args: list, out_dir: Path) -> subprocess.Popen:
    """The reference's ``script`` as a child process, JAX on the CPU."""
    # the reference's serving smoke imports the ``benchmarks`` package
    env = {**os.environ, "PYTHONPATH": os.pathsep.join((str(ROOT / "src"), str(ROOT))),
           "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, str(script), *args], env=env, cwd=out_dir,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def printed_lines(procs: dict):
    """A getter of each child's printed lines and exit code (``name:rc``)."""
    lines = {}

    def get(name: str) -> list[str]:
        if name not in lines:
            stdout, _ = procs[name].communicate(timeout=600)
            lines[name] = stdout.splitlines()
            lines[name + ":rc"] = procs[name].returncode
        return lines[name]

    return get


def stop(procs: dict) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """name -> the reference's printed lines, its children started together."""
    out = tmp_path_factory.mktemp("reference")
    procs = {name: start_reference(ROOT / "examples" / f"{name}.py", [], out)
             for name in GRAPH_EXAMPLES}
    yield printed_lines(procs)
    stop(procs)


def _run_example(name: str, args: list, monkeypatch, capsys) -> list[str]:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    runpy.run_path(str(ROOT / "examples" / "torch" / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out.splitlines()


# ------------------------------------------------------------ graph examples
@pytest.mark.parametrize("name", GRAPH_EXAMPLES)
def test_graph_examples_print_the_reference_lines(name, reference, monkeypatch, capsys):
    got = _run_example(name, ["--device", "cpu"], monkeypatch, capsys)
    want = reference(name)
    assert reference(name + ":rc") == 0, "\n".join(want)
    if name == "analytics_pagerank":
        # the last line is the engine's distance to the float64 oracle: the
        # port sums pagerank in float64, the reference in float32
        pattern = r"engine vs dense reference max\|err\| = (\S+)"
        err = float(re.fullmatch(pattern, got[-1]).group(1))
        assert err < 1e-6 and re.fullmatch(pattern, want[-1])
        got, want = got[:-1], want[:-1]
    assert got == want


def test_examples_need_a_device_flag_for_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    monkeypatch.setattr(sys, "argv", ["moe_placement.py"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        runpy.run_path(str(ROOT / "examples" / "torch" / "moe_placement.py"), run_name="__main__")


# --------------------------------------------------------------- LM examples
def _driver_argv(monkeypatch, module, path: Path, args: list) -> list:
    """The argument list an example hands its driver's ``main``."""
    seen = []
    monkeypatch.setattr(module, "main", lambda argv=None, **_: seen.append(list(argv)))
    monkeypatch.setattr(sys, "argv", [path.name, *args])
    runpy.run_path(str(path), run_name="__main__")
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("arch", [None, "reduced:jamba-v0.1-52b"])
def test_serve_example_is_the_reference_call_on_the_port(arch, monkeypatch, capsys):
    import repro.launch.serve as rserve

    extra = [] if arch is None else ["--arch", arch]
    want = _driver_argv(monkeypatch, rserve, ROOT / "examples" / "serve_lm.py", extra)
    got = _driver_argv(monkeypatch, tserve, ROOT / "examples" / "torch" / "serve_lm.py",
                       [*extra, "--device", "cpu"])
    assert got == want + ["--device", "cpu"]
    out = _run_example("serve_lm", [*extra, "--device", "cpu"], monkeypatch, capsys)
    assert out[0] == "generated token ids:"
    printed = np.array([[int(t) for t in re.findall(r"\d+", row)] for row in out[1:3]])
    assert re.fullmatch(r"prefill 16 tok x2: \S+s; decode: 7 steps in \S+s \(\S+ tok/s\)", out[3])
    # the greedy tokens are the port's serve loop (held to the reference's in
    # tests/test_torch_models.py) on the launcher's seeded weights
    cfg = get_model_config(arch or "reduced:qwen3-8b")
    model = Model(cfg, "cpu")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 16)))
    params = model.init(torch.Generator(device="cpu").manual_seed(0))
    tokens, _ = tserve.serve(model, params, prompts, 8)
    assert printed.shape == (2, 8) and np.array_equal(printed, tokens.numpy())


def test_train_example_is_the_reference_call_on_the_port(tmp_path, monkeypatch, capsys):
    import repro.launch.train as rtrain

    ck = str(tmp_path / "ck")
    want = _driver_argv(monkeypatch, rtrain, ROOT / "examples" / "train_lm.py",
                        ["--steps", "2", "--ckpt-dir", ck])
    got = _driver_argv(monkeypatch, ttrain, ROOT / "examples" / "torch" / "train_lm.py",
                       ["--steps", "2", "--ckpt-dir", ck, "--device", "cpu"])
    assert got == want + ["--device", "cpu"]
    # the example's run, then the driver on the reference example's arguments
    runs = []
    real = ttrain.main

    def recorded(argv=None):
        runs.append([])
        return real(argv, runs[-1])

    monkeypatch.setattr(ttrain, "main", recorded)
    try:
        out = _run_example("train_lm", ["--steps", "2", "--ckpt-dir", ck, "--device", "cpu"],
                           monkeypatch, capsys)
        assert ttrain.latest_step(ck) == 2
    finally:
        shutil.rmtree(ck, ignore_errors=True)  # a repro-100m checkpoint is 0.85 GB
    assert out[-1] == "[done]" and re.match(r"step +2 loss=", out[-2])
    again = []
    real([*[a for a in want if a != "--ckpt-dir" and a != ck], "--device", "cpu"], again)
    assert [h["step"] for h in runs[0]] == [h["step"] for h in again] == [1, 2]
    for a, b in zip(runs[0], again):
        assert np.isfinite(a["loss"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=TOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=TOL)
