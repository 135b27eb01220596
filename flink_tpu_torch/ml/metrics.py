"""Distance metrics — the port of flink_tpu/ml/metrics.py (the flink-ml
metrics.distances package analog, ref flink-libraries/flink-ml/.../
metrics/distances/: Euclidean, SquaredEuclidean, Manhattan, Chebyshev,
Minkowski, Cosine, Tanimoto).

Each metric is a vectorized pairwise function: distance(A [n, d],
B [m, d], device=None) -> numpy [n, m], torch ops on the device
(``None``: the CUDA card) — products, norms and sums, as the reference's
are plain jnp."""

from __future__ import annotations

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device


def _ab(a, b, device):
    dev = resolve_device(device)
    A = torch.as_tensor(np.asarray(a, np.float32), device=dev)
    B = torch.as_tensor(np.asarray(b, np.float32), device=dev)
    if A.dim() == 1:
        A = A[None, :]
    if B.dim() == 1:
        B = B[None, :]
    return A, B


def _np(x) -> np.ndarray:
    return x.cpu().numpy()


def squared_euclidean_distance(a, b, device=None) -> np.ndarray:
    A, B = _ab(a, b, device)
    sq = (
        torch.sum(A * A, 1)[:, None]
        + torch.sum(B * B, 1)[None, :]
        - 2.0 * A @ B.T
    )
    return _np(torch.clamp_min(sq, 0.0))


def euclidean_distance(a, b, device=None) -> np.ndarray:
    return np.sqrt(squared_euclidean_distance(a, b, device))


def manhattan_distance(a, b, device=None) -> np.ndarray:
    A, B = _ab(a, b, device)
    return _np(torch.sum(torch.abs(A[:, None, :] - B[None, :, :]), 2))


def chebyshev_distance(a, b, device=None) -> np.ndarray:
    A, B = _ab(a, b, device)
    return _np(torch.amax(torch.abs(A[:, None, :] - B[None, :, :]), 2))


def minkowski_distance(a, b, p: float = 3.0, device=None) -> np.ndarray:
    A, B = _ab(a, b, device)
    return _np(
        torch.sum(torch.abs(A[:, None, :] - B[None, :, :]) ** p, 2)
        ** (1.0 / p)
    )


def cosine_distance(a, b, device=None) -> np.ndarray:
    A, B = _ab(a, b, device)
    na = torch.linalg.vector_norm(A, dim=1)[:, None]
    nb = torch.linalg.vector_norm(B, dim=1)[None, :]
    sim = (A @ B.T) / torch.clamp_min(na * nb, 1e-12)
    return _np(1.0 - sim)


def tanimoto_distance(a, b, device=None) -> np.ndarray:
    A, B = _ab(a, b, device)
    dot = A @ B.T
    na = torch.sum(A * A, 1)[:, None]
    nb = torch.sum(B * B, 1)[None, :]
    sim = dot / torch.clamp_min(na + nb - dot, 1e-12)
    return _np(1.0 - sim)
