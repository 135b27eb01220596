"""ML pipelines — the FlinkML analog: the port of flink_tpu/ml/pipeline.py
(ref flink-ml: Pipeline/Estimator/Predictor/Transformer contracts + SVM
(CoCoA), MultipleLinearRegression (SGD), KNN, ALS, KMeans, StandardScaler/
MinMaxScaler/PolynomialFeatures, SURVEY §2.7) on an explicit device.

Every estimator takes ``device=None`` (the CUDA card; a machine without
one raises) and trains full-batch over [N, D] float32 tensors there. The
reference's jitted ``lax.fori_loop`` training loops are plain loops of
torch ops; products, norms, ``einsum``, ``torch.linalg.solve`` and
``torch.topk`` (for ``lax.top_k``) stay library calls, as the reference
leaves them to XLA. KMeans' assignment is ``torch.matmul`` then G25's
arg-min mode (``ops/cuda.py row_argmin``), and its update's per-center
sums and counts are one G23 launch (``scatter_ids`` with W = D and the
count column). The Pipeline chaining contract (chainTransformer/
chainPredictor) is preserved: transformers fit/transform in sequence, the
trailing predictor fits on the transformed features.

``state_from_numpy(model, fields)`` carries fitted parameters (the
reference's numpy arrays, by its attribute names) into a port estimator.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.ops import cuda as kernels

# a KNN query chunk's [q, N] distance matrix holds at most this many
# floats (1 GiB), so Q = 4,096 queries over 2^20 points never materialise
# 16 GiB at once; rows are independent, so the result is the same
KNN_CHUNK_CELLS = 1 << 28


def _as2d(x, device) -> torch.Tensor:
    a = torch.as_tensor(x if isinstance(x, torch.Tensor)
                        else np.array(x, np.float32),
                        dtype=torch.float32, device=device)
    return a[:, None] if a.dim() == 1 else a


def _vec(y, device) -> torch.Tensor:
    return _as2d(y, device).reshape(-1)


def _with_bias(X: torch.Tensor) -> torch.Tensor:
    ones = torch.ones((X.shape[0], 1), dtype=torch.float32, device=X.device)
    return torch.cat([X, ones], 1)


class Transformer:
    """ref Transformer: fit(X) learns parameters, transform(X) applies."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def fit(self, X, y=None) -> "Transformer":
        return self

    def transform(self, X) -> torch.Tensor:
        raise NotImplementedError

    def fit_transform(self, X, y=None) -> torch.Tensor:
        return self.fit(X, y).transform(X)


class Predictor:
    """ref Predictor: fit(X, y) + predict(X)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def fit(self, X, y) -> "Predictor":
        raise NotImplementedError

    def predict(self, X) -> torch.Tensor:
        raise NotImplementedError


class Pipeline:
    """ref Pipeline chaining: transformers then an optional predictor."""

    def __init__(self, stages: List[Any], device=None):
        self.device = resolve_device(device)
        self.stages = stages

    def fit(self, X, y=None) -> "Pipeline":
        cur = _as2d(X, self.device)
        for i, s in enumerate(self.stages):
            if isinstance(s, Predictor) or (
                i == len(self.stages) - 1 and hasattr(s, "predict")
            ):
                s.fit(cur, y)
            else:
                cur = s.fit_transform(cur, y)
        return self

    def transform(self, X) -> torch.Tensor:
        cur = _as2d(X, self.device)
        for s in self.stages:
            if hasattr(s, "transform"):
                cur = s.transform(cur)
        return cur

    def predict(self, X) -> torch.Tensor:
        cur = _as2d(X, self.device)
        for s in self.stages[:-1]:
            cur = s.transform(cur)
        return self.stages[-1].predict(cur)


# ------------------------------------------------------------ transformers
class StandardScaler(Transformer):
    """ref preprocessing.StandardScaler (mean/std)."""

    _STATE = ("mean", "std")

    def fit(self, X, y=None):
        X = _as2d(X, self.device)
        self.mean = torch.mean(X, 0)
        self.std = torch.clamp_min(torch.std(X, 0, correction=0), 1e-9)
        return self

    def transform(self, X):
        return (_as2d(X, self.device) - self.mean) / self.std


class MinMaxScaler(Transformer):
    """ref preprocessing.MinMaxScaler."""

    _STATE = ("data_min", "data_range")

    def __init__(self, lo: float = 0.0, hi: float = 1.0, device=None):
        super().__init__(device)
        self.lo, self.hi = lo, hi

    def fit(self, X, y=None):
        X = _as2d(X, self.device)
        self.data_min = torch.amin(X, 0)
        self.data_range = torch.clamp_min(
            torch.amax(X, 0) - self.data_min, 1e-9
        )
        return self

    def transform(self, X):
        z = (_as2d(X, self.device) - self.data_min) / self.data_range
        return z * (self.hi - self.lo) + self.lo


class PolynomialFeatures(Transformer):
    """ref preprocessing.PolynomialFeatures: powers up to `degree`."""

    _STATE = ()

    def __init__(self, degree: int = 2, device=None):
        super().__init__(device)
        self.degree = degree

    def transform(self, X):
        X = _as2d(X, self.device)
        return torch.cat([X**d for d in range(1, self.degree + 1)], 1)


# -------------------------------------------------------------- predictors
class MultipleLinearRegression(Predictor):
    """ref regression.MultipleLinearRegression: squared-loss linear model.
    Full-batch gradient descent (the reference uses per-partition SGD);
    one [N,D]@[D] matmul per step."""

    _STATE = ("weights",)

    def __init__(self, iterations: int = 200, stepsize: float = 0.1,
                 device=None):
        super().__init__(device)
        self.iterations = iterations
        self.stepsize = stepsize

    def fit(self, X, y):
        Xb = _with_bias(_as2d(X, self.device))
        y = _vec(y, self.device)
        N = Xb.shape[0]
        w = torch.zeros(Xb.shape[1], dtype=torch.float32, device=self.device)
        for _ in range(self.iterations):
            grad = Xb.T @ (Xb @ w - y) / N
            w = w - self.stepsize * grad
        self.weights = w
        return self

    def predict(self, X):
        return _with_bias(_as2d(X, self.device)) @ self.weights

    def squared_residual_sum(self, X, y) -> float:
        r = self.predict(X) - _vec(y, self.device)
        return float(torch.sum(r * r))


class SVM(Predictor):
    """ref classification.SVM (CoCoA dual solver): linear soft-margin SVM,
    labels in {-1, +1}. Trained with pegasos-style subgradient descent on
    the hinge loss — full-batch, matmul-dominated."""

    _STATE = ("weights",)

    def __init__(self, iterations: int = 300, regularization: float = 1e-3,
                 device=None):
        super().__init__(device)
        self.iterations = iterations
        self.lam = regularization

    def fit(self, X, y):
        Xb = _with_bias(_as2d(X, self.device))
        y = _vec(y, self.device)
        N = Xb.shape[0]
        w = torch.zeros(Xb.shape[1], dtype=torch.float32, device=self.device)
        lam = np.float32(self.lam)
        for t in range(self.iterations):
            margins = y * (Xb @ w)
            active = (margins < 1.0).to(torch.float32)
            grad = self.lam * w - (Xb.T @ (active * y)) / N
            eta = float(np.float32(1.0) / (lam * np.float32(t + 1.0)))
            w = w - eta * grad
        self.weights = w
        return self

    def decision_function(self, X):
        return _with_bias(_as2d(X, self.device)) @ self.weights

    def predict(self, X):
        return torch.sign(self.decision_function(X))


class KMeans(Predictor):
    """ref the KMeans batch example (+ FlinkML pipelines): Lloyd iterations
    with an [N,K] distance matmul per step. The k-means++ seeding stays
    host numpy, as the reference's, so both packages seed the same
    centers."""

    _STATE = ("centers",)

    def __init__(self, k: int, iterations: int = 50, seed: int = 0,
                 device=None):
        super().__init__(device)
        self.k = k
        self.iterations = iterations
        self.seed = seed

    def seed_centers(self, X) -> torch.Tensor:
        """k-means++ seeding (host-side, one pass per center): spreads the
        initial centers so Lloyd doesn't collapse clusters. The reference
        recomputes every chosen center's distances for each new center;
        here each center's distances are computed once and folded into a
        running minimum, the same float32 minimum (a minimum does not
        round), in K passes instead of K^2 / 2."""
        Xh = _as2d(X, self.device).cpu().numpy()
        N = Xh.shape[0]
        rng = np.random.default_rng(self.seed)
        centers = [Xh[rng.integers(N)]]
        d2 = None
        for _ in range(1, self.k):
            dc = ((Xh - centers[-1]) ** 2).sum(axis=1)
            d2 = dc if d2 is None else np.minimum(d2, dc)
            p = d2 / max(d2.sum(), 1e-12)
            centers.append(Xh[rng.choice(N, p=p)])
        return torch.as_tensor(np.stack(centers), dtype=torch.float32,
                               device=self.device)

    @staticmethod
    def _assign(X, xx, centers) -> torch.Tensor:
        # |x-c|^2 = (|x|^2 - 2 x.c) + |c|^2 ; argmin over K (G25)
        return kernels.row_argmin(X @ centers.T, xx,
                                  torch.sum(centers * centers, 1))

    def fit(self, X, y=None):
        X = _as2d(X, self.device)
        centers = self.seed_centers(X)
        xx = torch.sum(X * X, 1)
        for _ in range(self.iterations):
            a = self._assign(X, xx, centers)
            sums, counts, _ = kernels.scatter_ids(a, X, self.k, op="add",
                                                  counts=True)
            counts = counts.to(torch.float32)[:, None]
            new = sums / torch.clamp_min(counts, 1.0)
            # empty cluster keeps its old center
            centers = torch.where(counts > 0, new, centers)
        self.centers = centers
        return self

    def predict(self, X):
        X = _as2d(X, self.device)
        return self._assign(X, torch.sum(X * X, 1), self.centers)


class KNN(Predictor):
    """ref nn.KNN: brute-force k-nearest-neighbors; the [Q,N] distance
    matrix is one matmul a chunk of queries (exact)."""

    _STATE = ("X", "y")

    def __init__(self, k: int = 5, device=None):
        super().__init__(device)
        self.k = k

    def fit(self, X, y):
        self.X = _as2d(X, self.device)
        self.y = _vec(y, self.device)
        return self

    def predict(self, X):
        Q = _as2d(X, self.device)
        xx = torch.sum(self.X * self.X, 1)[None, :]
        step = max(1, KNN_CHUNK_CELLS // max(1, self.X.shape[0]))
        out = []
        for q in torch.split(Q, step):
            d = (torch.sum(q * q, 1, keepdim=True) - 2.0 * (q @ self.X.T)
                 + xx)
            _, idx = torch.topk(-d, self.k, dim=1)
            neigh = self.y[idx]                       # [q, k]
            # regression-style mean of neighbor labels; round for voting
            out.append(torch.mean(neigh, 1))
        return torch.cat(out)


class ALS(Predictor):
    """Alternating Least Squares matrix factorization — the reference
    FlinkML's flagship recommender (org.apache.flink.ml.recommendation.ALS).

    Both half-steps are BATCHED normal-equation solves — one einsum
    builds every user's (F x F) Gram matrix at once and one batched
    torch.linalg.solve updates all factors. Ratings densify to [U, I] with
    a mask. The initial factors are N(0, 0.1^2) draws from a
    ``torch.Generator`` seeded with ``seed`` (the reference draws them
    with jax.random, so the two packages start apart): ``fit`` is
    ``initial_factors`` then ``fit_from``, and a caller may hand
    ``fit_from`` factors of its own.
    """

    _STATE = ("user_factors", "item_factors", "_users", "_items")

    def __init__(self, num_factors: int = 10, lambda_: float = 0.1,
                 iterations: int = 10, seed: int = 0, device=None):
        super().__init__(device)
        self.num_factors = num_factors
        self.lambda_ = lambda_
        self.iterations = iterations
        self.seed = seed
        self.user_factors = None
        self.item_factors = None
        self._users = None
        self._items = None

    @staticmethod
    def _index(rows):
        users = sorted({r[0] for r in rows})
        items = sorted({r[1] for r in rows})
        return ({u: i for i, u in enumerate(users)},
                {it: i for i, it in enumerate(items)})

    def initial_factors(self, U: int, I: int):
        """(user factors [U, F], item factors [I, F]) drawn from the
        seeded generator, on the estimator's device."""
        gen = torch.Generator().manual_seed(self.seed)
        F = self.num_factors
        uf = torch.randn(U, F, generator=gen, dtype=torch.float32) * 0.1
        vf = torch.randn(I, F, generator=gen, dtype=torch.float32) * 0.1
        return uf.to(self.device), vf.to(self.device)

    def fit(self, ratings):
        """ratings: iterable of (user, item, rating)."""
        rows = list(ratings)
        u_ix, i_ix = self._index(rows)
        return self.fit_from(rows, *self.initial_factors(len(u_ix),
                                                         len(i_ix)))

    def fit_from(self, ratings, user_factors, item_factors):
        """The iterations from the given initial factors ([U, F], [I, F]
        for the sorted users and items of ``ratings``)."""
        rows = list(ratings)
        u_ix, i_ix = self._index(rows)
        U, I, F = len(u_ix), len(i_ix), self.num_factors
        R = np.zeros((U, I), np.float32)
        M = np.zeros((U, I), np.float32)
        for u, it, r in rows:
            R[u_ix[u], i_ix[it]] = r
            M[u_ix[u], i_ix[it]] = 1.0
        R = torch.as_tensor(R, device=self.device)
        M = torch.as_tensor(M, device=self.device)
        uf = _as2d(user_factors, self.device)
        vf = _as2d(item_factors, self.device)
        if uf.shape != (U, F) or vf.shape != (I, F):
            raise ValueError(f"initial factors {tuple(uf.shape)}, "
                             f"{tuple(vf.shape)} for {U} users, {I} items "
                             f"and {F} factors")
        lam = self.lambda_
        eye = torch.eye(F, dtype=torch.float32, device=self.device)

        def half_step(fixed, R_, M_):
            # for every row r: solve (X^T diag(m_r) X + λ n_r I) w = X^T y_r
            A = torch.einsum("if,ig,ri->rfg", fixed, fixed, M_)
            n = torch.sum(M_, 1)
            A = A + lam * torch.clamp_min(n, 1.0)[:, None, None] * eye
            b = torch.einsum("if,ri->rf", fixed, R_ * M_)
            return torch.linalg.solve(A, b[:, :, None])[:, :, 0]

        for _ in range(self.iterations):
            uf = half_step(vf, R, M)
            vf = half_step(uf, R.T, M.T)
        self.user_factors = uf
        self.item_factors = vf
        self._users = u_ix
        self._items = i_ix
        return self

    def predict(self, pairs):
        """pairs: iterable of (user, item) -> [n] predicted ratings
        (unseen users/items predict 0)."""
        out = []
        uf = self.user_factors.cpu().numpy()
        vf = self.item_factors.cpu().numpy()
        for u, it in pairs:
            iu = self._users.get(u)
            ii = self._items.get(it)
            out.append(
                float(uf[iu] @ vf[ii]) if iu is not None and ii is not None
                else 0.0
            )
        return np.asarray(out, np.float32)

    def empirical_risk(self, ratings) -> float:
        """Regularized squared loss over known ratings (the reference's
        empiricalRisk evaluation hook)."""
        rows = list(ratings)
        preds = self.predict([(u, i) for u, i, _ in rows])
        errs = preds - np.asarray([r for _, _, r in rows], np.float32)
        reg = self.lambda_ * (
            float(torch.sum(self.user_factors ** 2))
            + float(torch.sum(self.item_factors ** 2))
        )
        return float(np.sum(errs ** 2)) + reg


def state_from_numpy(model, fields: Dict[str, Any]):
    """Carry fitted parameters into a port estimator: ``fields`` maps the
    reference's attribute names (``weights``, ``centers``, ``mean`` /
    ``std``, ``data_min`` / ``data_range``, ``X`` / ``y``,
    ``user_factors`` / ``item_factors`` and the id maps ``_users`` /
    ``_items``) to its numpy arrays or dicts. Arrays land on the model's
    device as float32 tensors; the id maps are kept as given. Returns the
    model."""
    unknown = set(fields) - set(model._STATE)
    if unknown:
        raise KeyError(f"{type(model).__name__} has no fitted "
                       f"{sorted(unknown)}")
    for name, value in fields.items():
        if isinstance(value, dict):
            setattr(model, name, dict(value))
        else:
            setattr(model, name, torch.as_tensor(
                np.array(value, np.float32), device=model.device))
    return model
