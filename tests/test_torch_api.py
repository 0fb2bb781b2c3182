"""The typed API of the PyTorch port against ``repro.api``: the paper's
pipeline ``PartitionSpec -> partition -> quality()`` gives the same
assignments, quality and kernel-call counts on the benchmark datasets."""
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro_torch.api as tapi
from repro.graph.generators import load_dataset
from repro_torch.convert import graph_from_arrays

CPU = torch.device("cpu")
# chunks of 512: web-s has 20,000 vertices, road-s 25,000
KERNEL_CALLS = {
    ("web-s", "fennel"): 40, ("web-s", "ldg"): 40, ("web-s", "cuttana"): 0,
    ("road-s", "fennel"): 49, ("road-s", "ldg"): 49, ("road-s", "cuttana"): 0,
}


@pytest.fixture(scope="module")
def datasets():
    out = {}
    for name in ("web-s", "road-s"):
        g = load_dataset(name, seed=0)
        out[name] = (g, graph_from_arrays(g.indptr, g.indices, CPU))
    return out


@pytest.mark.parametrize("dataset,algo", list(KERNEL_CALLS))
def test_pipeline_matches_reference(datasets, dataset, algo):
    rg, tg = datasets[dataset]
    fields = dict(algo=algo, k=8, epsilon=0.05, balance_mode="edge", order="random", seed=0)
    want = rapi.partition(rg, rapi.PartitionSpec(**fields))
    got = tapi.partition(tg, tapi.PartitionSpec(**fields), device="cpu")
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.quality() == want.quality()
    assert got.telemetry["kernel_calls"] == want.telemetry["kernel_calls"]
    assert got.telemetry["kernel_calls"] == KERNEL_CALLS[(dataset, algo)]
    assert got.device == CPU


def test_published_edge_cuts_from_source():
    """The spec-only form generates the dataset itself; the cuts are the
    reference's committed quality rows."""
    spec = tapi.PartitionSpec(
        algo="fennel", k=8, balance_mode="edge", order="random", seed=0,
        source="dataset:web-s",
    )
    res = tapi.partition(spec, device="cpu")
    assert res.quality()["edge_cut"] == 0.6510985792934956
    assert res.quality() is res.quality()  # cached
    assert "stream_seconds" in res.timings


@pytest.mark.parametrize("algo", ["fennel", "ldg", "cuttana"])
def test_spec_json_round_trips_with_reference(algo):
    params = {"chunk": 256} if algo != "cuttana" else {"d_max": 64, "max_moves": 9}
    spec = tapi.PartitionSpec(
        algo=algo, k=4, balance_mode="vertex", order="dfs", seed=3,
        params=params, source="rmat:1000:8",
    )
    assert tapi.PartitionSpec.from_json(spec.to_json()) == spec
    ref = rapi.PartitionSpec.from_json(spec.to_json())
    assert ref.to_json() == spec.to_json()
    assert tapi.PartitionSpec.from_json(ref.to_json()) == spec


def test_unported_and_invalid_requests_raise():
    # the zoo's specs are the reference's (they raised before the zoo was ported)
    for fields in (dict(algo="cuttana-incremental", k=4), dict(algo="hdrf", k=4),
                   dict(algo="cuttana", k=4, params={"strategy": "gain"})):
        assert tapi.PartitionSpec(**fields).to_json() == rapi.PartitionSpec(**fields).to_json()
    with pytest.raises(ValueError, match="Did you mean 'fennel'"):
        tapi.PartitionSpec(algo="fenel", k=4)
    # an on-disk source and prefetch="on" are the reference's specs (they
    # raised before the out-of-core slice was ported)
    for fields in (dict(algo="fennel", k=4, source="graphs/web.bin"),
                   dict(algo="fennel", k=4, params={"prefetch": "on"})):
        assert tapi.PartitionSpec(**fields).to_json() == rapi.PartitionSpec(**fields).to_json()
    with pytest.raises(ValueError, match="param 'strategy' must be one of"):
        tapi.PartitionSpec(algo="cuttana", k=4, params={"strategy": "best"})
    with pytest.raises(ValueError, match="must be int"):
        tapi.PartitionSpec(algo="cuttana", k=4, params={"d_max": "big"})
    with pytest.raises(ValueError, match="param 'chunk' must be >= 1"):
        tapi.PartitionSpec(algo="ldg", k=4, params={"chunk": 0})
    with pytest.raises(ValueError, match="unknown dataset"):
        tapi.PartitionSpec(algo="ldg", k=4, source="dataset:nope")
    with pytest.raises(ValueError, match="needs a graph"):
        tapi.partition(None, "fennel", k=2, device="cpu")
    with pytest.raises(ValueError, match="unknown PartitionSpec fields"):
        tapi.PartitionSpec.from_dict({"algo": "fennel", "k": 2, "shards": 4})


@pytest.mark.parametrize("name", sorted(rapi.REGISTRY))
def test_every_reference_algorithm_is_ported_or_names_its_slice(name):
    """Every name the reference registers is ported: it resolves to a
    callable of the port, with the reference's kind and placement."""
    info, ref = tapi.get_info(name), rapi.get_info(name)
    assert info.name == name and name in tapi.list_algorithms(ref.kind)
    assert (info.kind, info.placement, info.engine) == (ref.kind, ref.placement, ref.engine)
    assert info.resolve().__module__.startswith("repro_torch.")
