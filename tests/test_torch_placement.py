"""The port's CUTTANA expert placement (``repro_torch.core.placement``)
against ``repro.core.placement`` on the CPU: the same synthetic routing
traces, co-activation graphs, placements and scores, all with ``==``.

Three traces: ``examples/moe_placement.py``'s (50,000 tokens, E=160, top-6,
16 devices, skew 0.7, seed 0), jamba-v0.1-52b's experts (E=16, top-2) on 4
devices and arctic-480b's (E=128, top-2) on 8.
"""
import numpy as np
import pytest

from repro.core import placement as ref
from repro_torch.core import placement as port

# name: (tokens, experts, top_k, devices, seed)
TRACES = {
    "example_e160_top6_d16": (50_000, 160, 6, 16, 0),
    "jamba_e16_top2_d4": (20_000, 16, 2, 4, 1),
    "arctic_e128_top2_d8": (20_000, 128, 2, 8, 2),
}

# the example's mean fanouts (the reference's, printed to three places by
# examples/moe_placement.py); chip_smoke.py phase 25 holds the port to them
EXAMPLE_FANOUT = {"round_robin": 4.49486, "contiguous": 4.53496, "cuttana": 2.99758}


@pytest.fixture(scope="module", params=list(TRACES))
def case(request):
    n, e, k, d, seed = TRACES[request.param]
    want = ref.synthetic_routing_trace(n, e, k, skew=0.7, seed=seed)
    got = port.synthetic_routing_trace(n, e, k, skew=0.7, seed=seed)
    return request.param, (n, e, k, d, seed), want, got


def test_synthetic_trace_is_the_references(case):
    _, (n, e, k, _, _), want, got = case
    assert got.shape == (n, k) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_coactivation_graph_is_the_references(case):
    _, (_, e, _, _, _), trace, _ = case
    got = port.coactivation_graph(trace, e)
    np.testing.assert_array_equal(got, ref.coactivation_graph(trace, e))
    assert (got == got.T).all() and not np.diag(got).any()


def test_placement_and_scores_are_the_references(case):
    name, (_, e, _, d, seed), trace, _ = case
    want = ref.place_experts(trace, e, d, seed=seed)
    got = port.place_experts(trace, e, d, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (np.bincount(got, minlength=d) == e // d).all()  # the exact-count repair
    layouts = {"round_robin": np.arange(e) % d, "contiguous": np.repeat(np.arange(d), e // d),
               "cuttana": got}
    for layout, pl in layouts.items():
        score = port.evaluate_placement(trace, pl)
        assert score == ref.evaluate_placement(trace, pl), layout
        if name.startswith("example"):
            assert score["mean_fanout"] == EXAMPLE_FANOUT[layout], layout
    # refinement never raises the fanout of the contiguous start
    assert port.evaluate_placement(trace, got)["mean_fanout"] <= \
        port.evaluate_placement(trace, layouts["contiguous"])["mean_fanout"]


def test_placement_with_slack_and_errors():
    trace = ref.synthetic_routing_trace(3_000, 16, 2, seed=5)
    for eps in (0.0, 0.5):
        np.testing.assert_array_equal(port.place_experts(trace, 16, 4, epsilon=eps),
                                      ref.place_experts(trace, 16, 4, epsilon=eps))
    with pytest.raises(AssertionError):
        port.place_experts(trace, 16, 5)  # E must split evenly over the devices
