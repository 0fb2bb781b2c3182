"""The port's headless CLI (``repro_torch.api.cli``) against
``repro.api.cli``: ``partition`` (generated, file and spec-source graphs,
``--prefetch``, ``--skip-quality``, ``--with-analytics``, ``--with-db``,
``--assignment-out``), ``serve-bench``, ``update`` and ``list`` give the
reference's reports (wall-clock fields aside) and errors. Every command
runs with ``--device cpu`` here; without it, and without a card, a command
exits non-zero."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import cli as rcli
from repro_torch.api import cli as tcli
from repro_torch.graph.churn import rmat_churn
from repro_torch.graph.external import convert_csr
from repro_torch.graph.generators import rmat_graph

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
SPEC = {"algo": "cuttana", "k": 4, "balance_mode": "edge", "order": "random", "seed": 0}
WALL = ("wall_s", "qps_wall")
# keys of the port's report the reference's lacks: where the partition ran
PORT_ONLY = {"device"}


def _spec(tmp_path, fields, name="spec.json") -> str:
    path = tmp_path / name
    path.write_text(json.dumps(fields))
    return str(path)


def _run_both(tmp_path, args, port_extra=CPU):
    """Run ``args`` through both CLIs (``{tag}`` in an argument becomes
    ``ref`` or ``port``) and return the two parsed reports, reference
    first."""
    out = []
    for tag, main, extra in (("ref", rcli.main, []), ("port", tcli.main, port_extra)):
        path = tmp_path / f"{tag}.json"
        argv = [a.replace("{tag}", tag) for a in args] + ["--out", str(path)] + extra
        assert main(argv) == 0
        out.append(json.loads(path.read_text()))
    return out


def _assert_report_keys(got, want):
    assert set(want) <= set(got) and set(got) - set(want) <= PORT_ONLY
    assert got["device"] == "cpu"
    assert set(want["telemetry"]) <= set(got["telemetry"])
    assert set(want["timings"]) <= set(got["timings"])


@pytest.mark.parametrize("algo", ["cuttana", "fennel", "hdrf"])
def test_partition_report_equal(tmp_path, algo):
    fields = dict(SPEC, algo=algo) if algo != "hdrf" else {"algo": "hdrf", "k": 4, "seed": 0}
    spec = _spec(tmp_path, fields)
    want, got = _run_both(tmp_path, [
        "partition", "--spec", spec, "--rmat", "600", "--avg-degree", "8",
        "--with-db", "--with-analytics", "--db-queries", "64",
        "--assignment-out", str(tmp_path / "assign_{tag}"),
    ])
    _assert_report_keys(got, want)
    for key in ("spec", "graph", "quality", "analytics", "db"):
        assert got[key] == want[key], key
    assert got["assignment_path"].endswith("assign_port.npy")
    np.testing.assert_array_equal(np.load(got["assignment_path"]),
                                  np.load(want["assignment_path"]))
    assert got["telemetry"].get("kernel_calls") == want["telemetry"].get("kernel_calls")


def test_partition_defaults_equal(tmp_path):
    """No graph flag and no spec source: the default dataset at the default
    seed, the default 256 DB queries and 30 analytics iterations."""
    spec = _spec(tmp_path, {"algo": "fennel", "k": 8, "seed": 0})
    want, got = _run_both(tmp_path, ["partition", "--spec", spec, "--with-db",
                                     "--with-analytics"])
    assert got["graph"] == want["graph"] and got["graph"]["name"] == "social-s"
    for key in ("spec", "quality", "analytics", "db"):
        assert got[key] == want[key], key
    assert got["db"]["one_hop"]["num_queries"] == 256
    assert got["analytics"]["iters"] == 30


def test_partition_spec_source_uses_spec_seed(tmp_path):
    spec = _spec(tmp_path, dict(SPEC, algo="fennel", seed=3, source="rmat:1500:8"))
    want, got = _run_both(tmp_path, ["partition", "--spec", spec,
                                     "--assignment-out", str(tmp_path / "a_{tag}.npy")])
    assert got["graph"] == want["graph"]
    assert got["quality"] == want["quality"]
    np.testing.assert_array_equal(np.load(got["assignment_path"]),
                                  np.load(want["assignment_path"]))


@pytest.fixture(scope="module")
def v2_bin(tmp_path_factory):
    """A v2 (compressed) graph file written by the port's converter."""
    path = tmp_path_factory.mktemp("graphs") / "g.bin"
    convert_csr(rmat_graph(1200, avg_degree=8, seed=5), str(path))
    return str(path)


@pytest.mark.parametrize("prefetch", ["on", "off"])
def test_partition_graph_file_prefetch_equal(tmp_path, v2_bin, prefetch):
    spec = _spec(tmp_path, dict(SPEC, algo="cuttana-parallel", params={"num_shards": 2}))
    want, got = _run_both(tmp_path, [
        "partition", "--spec", spec, "--graph", v2_bin, "--prefetch", prefetch,
        "--assignment-out", str(tmp_path / "a_{tag}.npy"),
    ])
    assert got["spec"] == want["spec"] and got["spec"]["params"]["prefetch"] == prefetch
    assert got["graph"] == want["graph"] and got["graph"]["name"] == v2_bin
    assert got["quality"] == want["quality"]
    assert got["telemetry"]["graph_backing"] == want["telemetry"]["graph_backing"] == "mapped"
    np.testing.assert_array_equal(np.load(got["assignment_path"]),
                                  np.load(want["assignment_path"]))


def test_partition_skip_quality(tmp_path, v2_bin):
    spec = _spec(tmp_path, dict(SPEC, algo="fennel"))
    want, got = _run_both(tmp_path, ["partition", "--spec", spec, "--graph", v2_bin,
                                     "--skip-quality"])
    assert "quality" not in got and "quality" not in want
    _assert_report_keys(got, want)


@pytest.mark.parametrize("case", ["knobless_prefetch", "graph_not_a_file", "unknown_dataset"])
def test_partition_errors_equal(tmp_path, v2_bin, case):
    if case == "knobless_prefetch":
        args = ["partition", "--spec", _spec(tmp_path, {"algo": "hash", "k": 4}),
                "--graph", v2_bin, "--prefetch", "on"]
        kind = SystemExit
    elif case == "graph_not_a_file":
        args = ["partition", "--spec", _spec(tmp_path, {"algo": "fennel", "k": 2}),
                "--graph", "rmat:5000", "--out", os.devnull]
        kind = ValueError
    else:
        args = ["partition", "--spec", _spec(tmp_path, {"algo": "fennel", "k": 2}),
                "--dataset", "nope", "--out", os.devnull]
        kind = SystemExit
    with pytest.raises(kind) as want:
        rcli.main(args)
    with pytest.raises(kind) as got:
        tcli.main(args + CPU)
    assert str(got.value) == str(want.value)


def test_serve_bench_equal(tmp_path):
    """``tests/test_serving.py::test_cli_serve_bench``'s arguments."""
    spec = _spec(tmp_path, SPEC)
    want, got = _run_both(tmp_path, [
        "serve-bench", "--spec", spec, "--rmat", "800", "--avg-degree", "8",
        "--queries", "80", "--concurrency", "16",
    ])
    assert got["spec"] == want["spec"] and got["graph"] == want["graph"]
    for rep in (got, want):
        for key in WALL:
            rep["serving"].pop(key)
        rep["serving"]["latency_ms"].pop("wall")
    assert got["serving"] == want["serving"]
    assert got["serving"]["num_queries"] == 80 and got["serving"]["rpcs"] > 0


def test_serve_bench_options_equal(tmp_path, v2_bin):
    """A mapped graph file, a mix, replication and one worker thread; the
    reference's default 1,000 queries at concurrency 256."""
    spec = _spec(tmp_path, dict(SPEC, algo="fennel"))
    want, got = _run_both(tmp_path, [
        "serve-bench", "--spec", spec, "--graph", v2_bin,
        "--mix", "point=0.1,one_hop=0.2,two_hop=0.7", "--load-seed", "3",
        "--replication-budget", "0.05", "--max-workers", "1",
    ])
    for rep in (got, want):
        for key in WALL:
            rep["serving"].pop(key)
        rep["serving"]["latency_ms"].pop("wall")
    assert got["serving"] == want["serving"]
    assert got["serving"]["num_queries"] == 1000 and got["serving"]["concurrency"] == 256
    assert got["serving"]["replication"]["num_replicas"] > 0


@pytest.fixture(scope="module")
def churn_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("churn")
    stream = rmat_churn(1500, avg_degree=8, seed=2, ordering="random")
    stream.save(str(d / "stream.npz"))
    prior = rmat_graph(1000, avg_degree=8, seed=2)
    prior.save(str(d / "prior.npz"))
    np.save(str(d / "prior_part.npy"),
            np.random.default_rng(0).integers(0, 4, size=prior.num_vertices).astype(np.int32))
    return d


@pytest.mark.parametrize("warm", [False, True])
def test_update_equal(tmp_path, churn_files, warm):
    spec = _spec(tmp_path, {"algo": "cuttana-incremental", "k": 4, "seed": 0,
                            "balance_mode": "edge", "params": {"num_batches": 4}})
    args = ["update", "--spec", spec, "--churn", str(churn_files / "stream.npz"),
            "--num-batches", "5", "--assignment-out", str(tmp_path / "u_{tag}")]
    if warm:
        args += ["--prior-graph", str(churn_files / "prior.npz"),
                 "--prior-assignment", str(churn_files / "prior_part.npy")]
    want, got = _run_both(tmp_path, args)
    _assert_report_keys(got, want)
    for key in ("spec", "graph", "quality", "churn"):
        assert got[key] == want[key], key
    assert got["churn"]["warm_start"] is warm
    for key in ("batches", "restream_windows", "moved_vertices", "drift_trajectory",
                "kernel_calls"):
        assert got["telemetry"].get(key) == want["telemetry"].get(key), key
    assert got["telemetry"]["batches"] == 5
    np.testing.assert_array_equal(np.load(got["assignment_path"]),
                                  np.load(want["assignment_path"]))


@pytest.mark.parametrize("case", ["not_incremental", "assignment_only", "graph_only"])
def test_update_errors_equal(tmp_path, churn_files, case):
    algo = "fennel" if case == "not_incremental" else "cuttana-incremental"
    args = ["update", "--spec", _spec(tmp_path, {"algo": algo, "k": 4}),
            "--churn", str(churn_files / "stream.npz")]
    if case == "assignment_only":
        args += ["--prior-assignment", str(churn_files / "prior_part.npy")]
    elif case == "graph_only":
        args += ["--prior-graph", str(churn_files / "prior.npz")]
    with pytest.raises(SystemExit) as want:
        rcli.main(args)
    with pytest.raises(SystemExit) as got:
        tcli.main(args + CPU)
    assert str(got.value) == str(want.value)


def test_list_equal(capsys):
    assert rcli.main(["list"]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["list"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "cuttana-incremental" in got
    # the registry listing needs no device: nothing initialises CUDA
    assert not torch.cuda.is_initialized()


def test_list_as_module():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.api.cli", "list"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for name in ("cuttana", "fennel", "hdrf", "cuttana-parallel"):
        assert name in proc.stdout


@pytest.mark.parametrize("cmd", ["partition", "serve-bench", "update"])
def test_without_a_card_cuda_exits_nonzero(tmp_path, cmd):
    """The default ``--device cuda`` without a card ends the command with the
    runner's error; it never carries on with the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "never.json"
    args = [cmd, "--spec", _spec(tmp_path, {"algo": "cuttana-incremental" if cmd == "update"
                                            else "fennel", "k": 2}),
            "--out", str(out)]
    args += ["--churn", "absent.npz"] if cmd == "update" else ["--rmat", "300"]
    with pytest.raises(SystemExit) as err:
        tcli.main(args)
    assert err.value.code not in (0, None)
    assert "no CUDA device is available" in str(err.value)
    assert not out.exists()
    with pytest.raises(SystemExit, match="unsupported device"):
        tcli.main(args + ["--device", "meta"])
