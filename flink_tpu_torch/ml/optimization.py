"""Optimization framework — the port of flink_tpu/ml/optimization.py (the
flink-ml optimization package analog, ref flink-libraries/flink-ml/.../
optimization/: GradientDescent.scala, LossFunction.scala,
PartialLossFunction, RegularizationPenalty).

The reference composes a Solver from a pluggable loss and a
regularization penalty and compiles the iterations into one jitted
``lax.fori_loop``. Here the loop is a plain Python loop of torch ops on
the solver's device (``None``: the CUDA card): per step, predictions and
gradients are batched mat-vecs and the penalty applies in closed form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device


# -- partial losses (ref PartialLossFunction: loss + derivative) ----------
@dataclass(frozen=True)
class SquaredLoss:
    """ref SquaredLoss.scala: 1/2 (wx - y)^2."""

    def loss(self, pred, y):
        return 0.5 * (pred - y) ** 2

    def gradient(self, pred, y):
        return pred - y


@dataclass(frozen=True)
class HingeLoss:
    """ref HingeLoss.scala: max(0, 1 - y*wx), labels in {-1, +1}."""

    def loss(self, pred, y):
        return torch.clamp_min(1.0 - y * pred, 0.0)

    def gradient(self, pred, y):
        return torch.where(y * pred < 1.0, -y, 0.0)


@dataclass(frozen=True)
class LogisticLoss:
    """ref LogisticLoss.scala: log(1 + exp(-y*wx)), labels in {-1, +1}."""

    def loss(self, pred, y):
        z = -y * pred
        # numerically stable log1p(exp(z))
        return torch.logaddexp(torch.zeros_like(z), z)

    def gradient(self, pred, y):
        return -y / (1.0 + torch.exp(y * pred))


# -- regularization penalties (ref RegularizationPenalty) -----------------
@dataclass(frozen=True)
class NoRegularization:
    def apply(self, w, lr, reg):
        return w


@dataclass(frozen=True)
class L2Regularization:
    """ref L2Regularization: shrink by the gradient of reg/2 ||w||^2."""

    def apply(self, w, lr, reg):
        return w * (1.0 - lr * reg)


@dataclass(frozen=True)
class L1Regularization:
    """ref L1Regularization: soft-thresholding (proximal step)."""

    def apply(self, w, lr, reg):
        shrink = lr * reg
        return torch.sign(w) * torch.clamp_min(torch.abs(w) - shrink, 0.0)


class GradientDescent:
    """ref GradientDescent.scala (SimpleGradientDescent/GradientDescentL1/
    L2 collapse into the penalty object). Linear model pred = X @ w + b.

    optimize(X, y) -> (weights [D] numpy, intercept): `iterations`
    full-gradient steps with step size lr / sqrt(t) (the reference's
    default decay), the step size a float32 as the reference's traced
    one is.
    """

    def __init__(self, loss=None, penalty=None, iterations: int = 100,
                 stepsize: float = 0.1, regularization: float = 0.0,
                 device=None):
        self.device = resolve_device(device)
        self.loss = loss or SquaredLoss()
        self.penalty = penalty or (
            L2Regularization() if regularization else NoRegularization()
        )
        self.iterations = iterations
        self.stepsize = stepsize
        self.regularization = regularization

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def optimize(self, X, y):
        X = self._t(X)
        y = self._t(y)
        n, d = X.shape
        loss, penalty, reg = self.loss, self.penalty, self.regularization
        w = torch.zeros(d, dtype=torch.float32, device=self.device)
        b = torch.zeros((), dtype=torch.float32, device=self.device)
        for t in range(self.iterations):
            lr = float(np.float32(self.stepsize)
                       / np.sqrt(np.float32(t + 1.0)))
            pred = X @ w + b
            g = loss.gradient(pred, y)          # [n]
            gw = X.T @ g / n
            gb = torch.mean(g)
            w = penalty.apply(w - lr * gw, lr, reg)
            b = b - lr * gb
        return w.cpu().numpy(), float(b)

    def empirical_loss(self, X, y, w, b) -> float:
        pred = self._t(X) @ self._t(w) + b
        return float(torch.mean(self.loss.loss(pred, self._t(y))))
