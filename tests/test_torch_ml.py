"""FlinkML in flink_tpu_torch against the reference's.

Every ML case of ``tests/test_libraries.py`` and
``tests/test_library_breadth.py`` runs unchanged against the port on the
CPU (``torch_library_parity``). Then the estimators through both packages
on the same numpy inputs: KMeans seeds the same centers and assigns every
point alike (the blobs are drawn so that no two centers tie within 1e-3
for any point: G25 reads P from torch.matmul, which may differ from
XLA's product in the last bits); KNN predicts the same labels; the
linear models, the scalers, the optimizer and the distances agree within
rtol 1e-4 (float32 products summed in another order, compounded over the
iterations); ALS started from the reference's own initial factors agrees
within rtol 1e-3. ``state_from_numpy`` carries a fitted KMeans, SVM and
ALS across, after which their predictions are equal.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu import ml as ref_ml
from flink_tpu.ml import metrics as ref_metrics
from flink_tpu.ml import optimization as ref_opt
from flink_tpu_torch import ml
from flink_tpu_torch.ml import metrics, optimization
from flink_tpu_torch.ml.pipeline import state_from_numpy
from flink_tpu_torch.ops import cuda as kernels
from torch_library_parity import reference_cases, run_example, \
    run_reference_case

ML_CASES = (
    reference_cases("test_libraries.py", names=(
        "test_linear_regression_recovers_coefficients", "test_svm_separates",
        "test_kmeans_finds_clusters", "test_knn_regression",
        "test_pipeline_chaining", "test_scalers_and_poly"))
    + reference_cases("test_library_breadth.py", names=(
        "test_als_reconstructs_low_rank_ratings",
        "test_gradient_descent_losses_and_penalties",
        "test_distance_metrics", "test_libsvm_round_trip")))


@pytest.mark.parametrize("test_file,name,params", ML_CASES)
def test_reference_case_on_the_port(test_file, name, params, request,
                                    monkeypatch):
    run_reference_case(test_file, name, params, request, monkeypatch)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def blobs(seed, n=3000, d=4, k=6, min_gap=1e-3):
    """Separated blobs; every point's best and second-best squared
    distances to the centers KMeans ends with differ by more than
    ``min_gap`` (checked by the caller on the fitted centers)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-20, 20, (k, d))
    lab = rng.integers(0, k, n)
    return (means[lab] + rng.normal(0, 0.6, (n, d))).astype(np.float32)


def _margin(X, C):
    d = ((X[:, None, :].astype(np.float64) - C[None].astype(np.float64))
         ** 2).sum(-1)
    d.sort(1)
    return float((d[:, 1] - d[:, 0]).min())


@pytest.mark.parametrize("seed", (0, 1))
def test_kmeans_assigns_like_the_reference(seed):
    X = blobs(seed)
    ref = ref_ml.KMeans(k=6, iterations=15, seed=seed).fit(X)
    port = ml.KMeans(k=6, iterations=15, seed=seed, device="cpu")
    np.testing.assert_array_equal(_np(port.seed_centers(X)),
                                  _np(ref_ml.KMeans(k=6, iterations=0,
                                                    seed=seed).fit(X)
                                      .centers))
    port.fit(X)
    assert _margin(X, np.asarray(ref.centers)) > 1e-3
    np.testing.assert_allclose(_np(port.centers), np.asarray(ref.centers),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(port.predict(X)),
                                  np.asarray(ref.predict(X)))


def test_kmeans_runs_its_update_on_g23_and_its_assignment_on_g25():
    calls = {"scatter_ids": 0, "row_argmin": 0}
    origs = {n: getattr(kernels, f"{n}_plain") for n in calls}

    def spy(name):
        def f(*a, **k):
            calls[name] += 1
            return origs[name](*a, **k)
        return f

    for n in calls:
        setattr(kernels, f"{n}_plain", spy(n))
    try:
        ml.KMeans(k=3, iterations=4, device="cpu").fit(blobs(2, n=300,
                                                             k=3))
    finally:
        for n, f in origs.items():
            setattr(kernels, f"{n}_plain", f)
    assert calls == {"scatter_ids": 4, "row_argmin": 4}


def test_knn_predicts_like_the_reference():
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 100, (2000, 3)).astype(np.float32)
    y = rng.integers(0, 5, 2000).astype(np.float32)
    Q = rng.uniform(0, 100, (300, 3)).astype(np.float32)
    ref = ref_ml.KNN(k=4).fit(X, y).predict(Q)
    port = ml.KNN(k=4, device="cpu").fit(X, y).predict(Q)
    np.testing.assert_array_equal(_np(port), np.asarray(ref))


def test_knn_chunks_queries_without_changing_the_answer(monkeypatch):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(500, 2)).astype(np.float32)
    y = rng.normal(size=500).astype(np.float32)
    Q = rng.normal(size=(64, 2)).astype(np.float32)
    whole = ml.KNN(k=3, device="cpu").fit(X, y).predict(Q)
    monkeypatch.setattr("flink_tpu_torch.ml.pipeline.KNN_CHUNK_CELLS",
                        500 * 5)
    np.testing.assert_array_equal(
        _np(ml.KNN(k=3, device="cpu").fit(X, y).predict(Q)), _np(whole))


def _lin_data(seed, n=500, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    return X, (X @ w + 0.7).astype(np.float32), \
        np.where(X @ w > 0, 1.0, -1.0).astype(np.float32)


def test_linear_models_fit_like_the_reference():
    X, y, yc = _lin_data(5)
    for ref, port, target in (
            (ref_ml.MultipleLinearRegression(100, 0.1),
             ml.MultipleLinearRegression(100, 0.1, device="cpu"), y),
            (ref_ml.SVM(150), ml.SVM(150, device="cpu"), yc)):
        ref.fit(X, target)
        port.fit(X, target)
        np.testing.assert_allclose(_np(port.weights),
                                   np.asarray(ref.weights), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(_np(port.predict(X)),
                                  np.asarray(ref.predict(X)))


def test_transformers_and_pipeline_like_the_reference():
    X, y, _ = _lin_data(6)
    X = X * 30 + 7
    for ref, port in (
            (ref_ml.StandardScaler(), ml.StandardScaler(device="cpu")),
            (ref_ml.MinMaxScaler(-1, 2), ml.MinMaxScaler(-1, 2,
                                                         device="cpu")),
            (ref_ml.PolynomialFeatures(3),
             ml.PolynomialFeatures(3, device="cpu"))):
        np.testing.assert_allclose(_np(port.fit_transform(X)),
                                   np.asarray(ref.fit_transform(X)),
                                   rtol=1e-5, atol=1e-5)
    ref = ref_ml.Pipeline([ref_ml.StandardScaler(),
                           ref_ml.MultipleLinearRegression(80, 0.2)])
    port = ml.Pipeline([ml.StandardScaler(device="cpu"),
                        ml.MultipleLinearRegression(80, 0.2,
                                                    device="cpu")],
                       device="cpu")
    np.testing.assert_allclose(_np(port.fit(X, y).predict(X)),
                               np.asarray(ref.fit(X, y).predict(X)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("loss,penalty", (
    ("SquaredLoss", "NoRegularization"),
    ("SquaredLoss", "L2Regularization"),
    ("HingeLoss", "L1Regularization"),
    ("LogisticLoss", "L2Regularization"),
))
def test_gradient_descent_like_the_reference(loss, penalty):
    X, y, yc = _lin_data(7)
    target = y if loss == "SquaredLoss" else yc
    out = []
    for mod, kw in ((ref_opt, {}), (optimization, {"device": "cpu"})):
        gd = mod.GradientDescent(loss=getattr(mod, loss)(),
                                 penalty=getattr(mod, penalty)(),
                                 iterations=60, stepsize=0.3,
                                 regularization=0.01, **kw)
        w, b = gd.optimize(X, target)
        out.append((w, b, gd.empirical_loss(X, target, w, b)))
    (wr, br, lr), (wp, bp, lp) = out
    np.testing.assert_allclose(wp, wr, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([bp, lp], [br, lr], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", (
    "squared_euclidean_distance", "euclidean_distance", "manhattan_distance",
    "chebyshev_distance", "minkowski_distance", "cosine_distance",
    "tanimoto_distance"))
def test_distances_like_the_reference(name):
    rng = np.random.default_rng(8)
    a = rng.normal(size=(7, 4))
    b = rng.normal(size=(5, 4))
    np.testing.assert_allclose(getattr(metrics, name)(a, b, device="cpu"),
                               getattr(ref_metrics, name)(a, b),
                               rtol=1e-5, atol=1e-5)


def _ratings(seed, U=40, I=25, F=3):
    rng = np.random.default_rng(seed)
    full = rng.normal(size=(U, F)) @ rng.normal(size=(I, F)).T
    mask = rng.random((U, I)) < 0.6
    return [(u, i, float(full[u, i])) for u in range(U) for i in range(I)
            if mask[u, i]]


def _reference_initial_factors(seed, U, I, F):
    """The reference's draw (flink_tpu/ml/pipeline.py:326-330)."""
    ku, ki = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.normal(ku, (U, F), jnp.float32) * 0.1),
            np.asarray(jax.random.normal(ki, (I, F), jnp.float32) * 0.1))


def test_als_from_the_reference_initial_factors():
    rows = _ratings(9)
    ref = ref_ml.ALS(num_factors=3, lambda_=0.05, iterations=8,
                     seed=2).fit(rows)
    uf, vf = _reference_initial_factors(2, 40, 25, 3)
    port = ml.ALS(num_factors=3, lambda_=0.05, iterations=8, seed=2,
                  device="cpu").fit_from(rows, uf, vf)
    np.testing.assert_allclose(_np(port.user_factors),
                               np.asarray(ref.user_factors), rtol=1e-3,
                               atol=1e-4)
    pairs = [(u, i) for u, i, _ in rows] + [(999, 0)]
    np.testing.assert_allclose(port.predict(pairs), ref.predict(pairs),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(port.empirical_risk(rows),
                               ref.empirical_risk(rows), rtol=1e-3)


def test_als_draws_its_own_factors_from_the_seed():
    rows = _ratings(10)
    a = ml.ALS(num_factors=3, iterations=2, seed=4, device="cpu")
    uf, vf = a.initial_factors(40, 25)
    assert uf.shape == (40, 3) and vf.shape == (25, 3)
    again = a.initial_factors(40, 25)
    assert torch.equal(uf, again[0]) and torch.equal(vf, again[1])
    fitted = a.fit(rows)
    same = ml.ALS(num_factors=3, iterations=2, seed=4,
                  device="cpu").fit_from(rows, uf, vf)
    assert torch.equal(fitted.user_factors, same.user_factors)
    with pytest.raises(ValueError, match="initial factors"):
        a.fit_from(rows, uf[:3], vf)


def test_fitted_state_carried_from_the_reference():
    X = blobs(11, n=500, k=4)
    km = ref_ml.KMeans(k=4, iterations=5).fit(X)
    port_km = state_from_numpy(ml.KMeans(k=4, device="cpu"),
                               {"centers": np.asarray(km.centers)})
    np.testing.assert_array_equal(_np(port_km.predict(X)),
                                  np.asarray(km.predict(X)))
    _, _, yc = _lin_data(12)
    Xl = _lin_data(12)[0]
    svm = ref_ml.SVM(50).fit(Xl, yc)
    port_svm = state_from_numpy(ml.SVM(device="cpu"),
                                {"weights": np.asarray(svm.weights)})
    np.testing.assert_allclose(_np(port_svm.decision_function(Xl)),
                               np.asarray(svm.decision_function(Xl)),
                               rtol=1e-5, atol=1e-5)
    rows = _ratings(13)
    als = ref_ml.ALS(num_factors=3, iterations=3).fit(rows)
    port_als = state_from_numpy(ml.ALS(num_factors=3, device="cpu"), {
        "user_factors": np.asarray(als.user_factors),
        "item_factors": np.asarray(als.item_factors),
        "_users": als._users, "_items": als._items})
    pairs = [(u, i) for u, i, _ in rows]
    np.testing.assert_array_equal(port_als.predict(pairs),
                                  als.predict(pairs))
    with pytest.raises(KeyError, match="no fitted"):
        state_from_numpy(ml.SVM(device="cpu"), {"centers": [[0.0]]})


def test_entry_points_take_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ml.KMeans(k=2), ml.KNN, ml.ALS, ml.SVM,
                 ml.MultipleLinearRegression, ml.StandardScaler,
                 lambda: ml.Pipeline([]), optimization.GradientDescent,
                 lambda: metrics.cosine_distance([[1.0]], [[1.0]])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert ml.KNN(device="cpu").device.type == "cpu"


def test_movie_recommendation_example_runs_on_the_port(monkeypatch):
    """The port draws ALS's initial factors from torch's generator, so the
    risk it prints differs from the reference's; the recommendations
    agree."""
    def picks(out):
        return [line.split("(cluster")[0] + line.split("recommend")[1]
                .split("(")[0] for line in out.splitlines()
                if "recommend" in line]

    want = run_example("movie_recommendation")
    got = run_example("movie_recommendation", monkeypatch)
    assert got.startswith("trained on") and picks(got) == picks(want)
