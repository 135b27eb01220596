"""Gelly in flink_tpu_torch against the reference's.

Every graph case of ``tests/test_libraries.py`` and
``tests/test_library_breadth.py`` runs unchanged against the port on the
CPU (``torch_library_parity``). Then every algorithm on the same random
graphs through both packages: connected components, label propagation,
the degrees, triangles, community detection, the neighbourhood reduces
and the structural operations exactly; PageRank, HITS, SSSP, Jaccard,
Adamic-Adar and the clustering coefficients at rtol 1e-5 (the port sums
each vertex's messages in another order). A Graph carried from the
reference's arrays with ``state_from_numpy`` gives the same answers, and
``examples/page_rank.py`` prints what the reference prints.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.gelly import Graph as RefGraph
from flink_tpu_torch.gelly import Graph
from flink_tpu_torch.gelly.graph import state_from_numpy
from flink_tpu_torch.ops import cuda as kernels
from torch_library_parity import reference_cases, run_example, \
    run_reference_case

GRAPH_CASES = (
    reference_cases("test_libraries.py", names=(
        "test_connected_components", "test_degrees_and_transforms",
        "test_sssp", "test_page_rank_sums_to_one_and_ranks_hub",
        "test_triangle_count"))
    + reference_cases("test_library_breadth.py", names=(
        "test_hits_hubs_and_authorities",
        "test_community_detection_splits_bridge",
        "test_jaccard_index_triangle",
        "test_summarize_condenses_equal_values", "test_union_and_subgraph",
        "test_clustering_coefficients",
        "test_adamic_adar_scores_non_adjacent_pairs",
        "test_reduce_on_edges_and_neighbors", "test_graph_mutations",
        "test_add_vertices_value_alignment",
        "test_remove_edges_on_empty_and_duplicate_add_vertices")))


@pytest.mark.parametrize("test_file,name,params", GRAPH_CASES)
def test_reference_case_on_the_port(test_file, name, params, request,
                                    monkeypatch):
    run_reference_case(test_file, name, params, request, monkeypatch)


def _edges(seed, V=60, E=240):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    return [(f"v{a}", f"v{b}") for a, b in zip(src, dst)], \
        rng.integers(1, 10, E).astype(float).tolist()


def _both(seed, undirected=False, weighted=False):
    edges, w = _edges(seed)
    kw = {"edge_values": w} if weighted else {}
    return (RefGraph.from_edge_list(edges, undirected=undirected, **kw),
            Graph.from_edge_list(edges, undirected=undirected,
                                 device="cpu", **kw))


def _close(a, b, rtol=1e-5, atol=1e-7):
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=str(k))


EXACT = {
    "connected_components": lambda g: g.connected_components(),
    "label_propagation": lambda g: g.label_propagation(),
    "out_degrees": lambda g: g.out_degrees(),
    "in_degrees": lambda g: g.in_degrees(),
    "triangle_count": lambda g: g.triangle_count(),
    "community_detection": lambda g: g.community_detection(),
    "reduce_on_edges_min_all": lambda g: g.reduce_on_edges("min", "all"),
    "reduce_on_edges_sum_out": lambda g: g.reduce_on_edges("sum", "out"),
    "reduce_on_neighbors_max_in": lambda g: g.reduce_on_neighbors("max",
                                                                  "in"),
    "reduce_on_neighbors_sum_all": lambda g: g.reduce_on_neighbors("sum",
                                                                   "all"),
}

CLOSE = {
    "page_rank": lambda g: g.page_rank(num_iterations=40),
    "hits": lambda g: g.hits(num_iterations=25),
    "sssp": lambda g: g.single_source_shortest_paths("v3"),
    "jaccard_index": lambda g: g.jaccard_index(),
    "adamic_adar": lambda g: g.adamic_adar(),
    "local_clustering": lambda g: g.local_clustering_coefficient(),
    "global_clustering": lambda g: {0: g.global_clustering_coefficient()},
}


@pytest.mark.parametrize("undirected", (False, True))
@pytest.mark.parametrize("algo", sorted(EXACT))
def test_exact_algorithms_equal_the_reference(algo, undirected):
    ref, port = _both(4, undirected, weighted=True)
    assert EXACT[algo](port) == EXACT[algo](ref)


@pytest.mark.parametrize("undirected", (False, True))
@pytest.mark.parametrize("algo", sorted(CLOSE))
def test_float_algorithms_within_rtol(algo, undirected):
    ref, port = _both(5, undirected, weighted=True)
    _close(CLOSE[algo](port), CLOSE[algo](ref))


def test_scatter_gather_with_a_neutral_of_its_own():
    """A neutral other than the combine's identity (the sum starts at 2)
    and a user update on torch tensors."""
    ref, port = _both(6, weighted=True)
    out = []
    for g, where in ((ref, jnp.where), (port, torch.where)):
        h = g.scatter_gather(
            message_fn=lambda sv, ev: sv * 0 + ev, combine="sum",
            update_fn=lambda old, agg, has, w=where: w(has, agg, old),
            max_supersteps=5, neutral=2.0)
        out.append(np.asarray(h.vertex_values).tolist())
    assert out[1] == out[0]


def test_structural_operations_equal_the_reference():
    ref, port = _both(7, weighted=True)
    for f in (lambda g: g.summarize(),
              lambda g: g.reverse().union(g),
              lambda g: g.subgraph(lambda v: v % 2 == 0),
              lambda g: g.filter_on_edges(lambda s, d, e: e > 4),
              lambda g: g.add_vertices(["x", "v1"], [1.0, 2.0])
              .add_edges([("x", "v2")], [3.0]).remove_vertices(["v4"])
              .remove_edges([("v2", "v5")])):
        a, b = f(port), f(ref)
        for field in ("vertex_values", "src", "dst", "edge_values"):
            np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                          np.asarray(getattr(b, field)))
        assert (a.ids is None) == (b.ids is None)
        if a.ids is not None:
            assert a.ids.tolist() == b.ids.tolist()


def test_graph_carried_from_the_reference_arrays():
    ref, _ = _both(8, undirected=True, weighted=True)
    port = state_from_numpy({
        "vertex_values": np.asarray(ref.vertex_values),
        "src": np.asarray(ref.src), "dst": np.asarray(ref.dst),
        "edge_values": np.asarray(ref.edge_values), "ids": ref.ids},
        device="cpu")
    assert port.device.type == "cpu" and port.src.dtype.is_signed
    assert port.connected_components() == ref.connected_components()
    assert port.community_detection() == ref.community_detection()
    _close(port.page_rank(), ref.page_rank())
    _close(port.single_source_shortest_paths("v1"),
           ref.single_source_shortest_paths("v1"))


def test_supersteps_run_on_g23_and_g25():
    _, port = _both(9, undirected=True)
    calls = {"scatter_ids": 0, "row_argmax": 0}
    origs = {n: getattr(kernels, f"{n}_plain") for n in calls}

    def spy(name):
        def f(*a, **k):
            calls[name] += 1
            return origs[name](*a, **k)
        return f

    for n in calls:
        setattr(kernels, f"{n}_plain", spy(n))
    try:
        port.community_detection(max_supersteps=3)
        # a superstep: one score mass (G23), one adopt (G25)
        assert calls["row_argmax"] >= 1
        assert calls["scatter_ids"] == calls["row_argmax"]
        before = calls["scatter_ids"]
        port.page_rank(num_iterations=5)
        # the out-degrees, then one contribution sum an iteration
        assert calls["scatter_ids"] - before == 1 + 5
    finally:
        for n, f in origs.items():
            setattr(kernels, f"{n}_plain", f)


def test_entry_point_takes_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Graph.from_edge_list([(0, 1)])
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy({"vertex_values": [0.0], "src": [0], "dst": [0]})
    g = Graph.from_edge_list([(0, 1)], device="cpu")
    assert g.device.type == "cpu" and g.out_degrees() == {0: 1, 1: 0}


def test_page_rank_example_prints_what_the_reference_prints(monkeypatch):
    want = run_example("page_rank")
    assert run_example("page_rank", monkeypatch) == want
    assert "news" in want
