"""The DataSet API of flink_tpu_torch against the reference's.

Every case of ``tests/test_dataset.py`` and the DataSet cases of
``tests/test_library_breadth.py`` (the join cost model) run unchanged
against the port on the CPU (``torch_library_parity``), the broadcast
ship and its plan text included. Then programs through both packages,
rows compared exactly (integer-valued aggregates); the broadcast join
answers from G24 or raises, never from the host; the Avro and JDBC
sources raise citing ROADMAP queue 1, item 15; and
``examples/batch_word_count.py`` prints what the reference prints.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest

from flink_tpu.dataset import ExecutionEnvironment as RefEnv
from flink_tpu_torch.dataset import ExecutionEnvironment
from flink_tpu_torch.ops import cuda as kernels
from torch_library_parity import reference_cases, run_example, \
    run_reference_case

CASES = (reference_cases("test_dataset.py")
         + reference_cases("test_library_breadth.py", names=(
             "test_join_cost_model_builds_small_side_and_explains",
             "test_outer_join_semantics_stable_under_either_build_side")))


@pytest.mark.parametrize("test_file,name,params", CASES)
def test_reference_case_on_the_port(test_file, name, params, request,
                                    monkeypatch):
    run_reference_case(test_file, name, params, request, monkeypatch)


def _both():
    return RefEnv.get_execution_environment(), \
        ExecutionEnvironment.get_execution_environment(device="cpu")


def _words(n, seed=0):
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.3, n) % 500
    return [f"w{r}" for r in ranks.tolist()]


@pytest.mark.parametrize("agg", ("sum", "min", "max", "count", "mean"))
def test_grouped_aggregates_equal_the_reference(agg):
    words = _words(4000)
    rng = np.random.default_rng(1)
    vals = rng.integers(-5, 50, len(words)).tolist()
    out = []
    for env in _both():
        g = env.from_collection(list(zip(words, vals))).group_by(0)
        ds = g.count() if agg == "count" else getattr(g, agg)(1)
        out.append(sorted(ds.collect()))
    if agg == "mean":      # a quotient: the port sums in another order
        assert [k for k, _ in out[0]] == [k for k, _ in out[1]]
        np.testing.assert_allclose([v for _, v in out[1]],
                                   [v for _, v in out[0]], rtol=1e-6)
    else:
        assert out[1] == out[0]


def test_broadcast_join_rows_equal_the_reference():
    rng = np.random.default_rng(2)
    supp = [(int(k), f"s{k}") for k in rng.choice(100_000, 400,
                                                  replace=False)]
    keys = [k for k, _ in supp]
    probe = [(int(rng.choice(keys)) if i % 3 else int(i), i)
             for i in range(5000)]
    out = []
    for env in _both():
        j = (env.from_collection(probe).join(env.from_collection(supp))
             .where(0).equal_to(0).apply(lambda p, s: (p[1], s[1])))
        out.append((sorted(j.collect()), j.strategy))
    assert out[1] == out[0]
    assert out[1][1] == ("ship=broadcast-hash-second (device mesh), "
                         "local=hash build-right")


def _broadcast_join(env):
    big = env.from_collection([(i, f"L{i}") for i in range(1000)])
    small = env.from_collection([(i * 100, f"R{i}") for i in range(5)])
    return (big.join(small).where(lambda e: e[0]).equal_to(lambda e: e[0])
            .apply(lambda l, r: (l[0], r[1])))


def test_broadcast_probe_runs_on_g24():
    calls = []
    orig = kernels.sorted_probe_plain

    def spy(*args):
        calls.append(args[0].shape[0])
        return orig(*args)

    kernels.sorted_probe_plain = spy
    try:
        env = ExecutionEnvironment.get_execution_environment(device="cpu")
        rows = sorted(_broadcast_join(env).collect())
    finally:
        kernels.sorted_probe_plain = orig
    assert calls == [1000]
    assert rows == [(i * 100, f"R{i}") for i in range(5)]


def test_a_failing_probe_raises_and_no_host_path_answers(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("kernel sorted_probe failed to launch: CUDA "
                           "error 2")

    monkeypatch.setattr(kernels, "sorted_probe", boom)
    env = ExecutionEnvironment.get_execution_environment(device="cpu")
    j = _broadcast_join(env)
    with pytest.raises(RuntimeError, match="sorted_probe failed"):
        j.collect()
    assert j.strategy is None


@pytest.mark.parametrize("build,why", (
    ([(1.5, "a"), (2.0, "b")], "float keys"),
    ([(1, "a"), (1, "b")], "duplicate build keys"),
    ([("x", "a"), ("y", "b")], "string keys"),
))
def test_shapes_the_probe_declines_take_the_host_join(build, why,
                                                      monkeypatch):
    """The reference's three reasons to decline stay (a build side of
    2^24 rows is the third, too large to test here); the kernel is never
    reached for them."""
    monkeypatch.setattr(kernels, "sorted_probe",
                        lambda *a: pytest.fail(f"probe reached: {why}"))
    out = []
    for env in _both():
        probe = env.from_collection([(k, i) for i, (k, _) in
                                     enumerate(build * 50)])
        j = (probe.join(env.from_collection(build)).where(0).equal_to(0)
             .apply(lambda p, b: (p[1], b[1])))
        out.append((sorted(j.collect()), j.strategy))
    assert out[1] == out[0]
    assert "device" not in out[1][1]


def test_avro_and_jdbc_raise_item_15():
    env = ExecutionEnvironment.get_execution_environment(device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        env.read_avro_file("x.avro")
    with pytest.raises(NotImplementedError, match="item 15"):
        env.read_jdbc(lambda: None, "SELECT 1")


def test_entry_point_takes_the_card_unless_told(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ExecutionEnvironment.get_execution_environment()
    with pytest.raises(RuntimeError, match="CUDA"):
        ExecutionEnvironment()
    env = ExecutionEnvironment(device="cpu")
    assert env.from_elements(("a", 1), ("a", 2)).group_by(0).sum(1) \
        .collect() == [("a", 3.0)]


def test_batch_word_count_example_prints_what_the_reference_prints(
        monkeypatch):
    want = run_example("batch_word_count")
    assert run_example("batch_word_count", monkeypatch) == want
    assert "('to', 3.0)" in want
