"""MLUtils — a copy of flink_tpu/ml/utils.py (numpy only): libSVM/SVMLight
file IO (ref flink-ml MLUtils.scala
readLibSVM/writeLibSVM): `<label> <index>:<value> ...` per line,
1-based indices, densified into numpy arrays."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def read_libsvm(path: str, n_features: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (X [n, d] float32 dense, y [n] float32). d is inferred from
    the max index unless given."""
    labels = []
    rows = []
    max_idx = n_features or 0
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            feats = []
            for tok in parts[1:]:
                idx, _, val = tok.partition(":")
                i = int(idx)
                if i < 1:
                    raise ValueError(
                        f"libSVM indices are 1-based, got {i}"
                    )
                feats.append((i, float(val)))
                max_idx = max(max_idx, i)
            rows.append(feats)
    if n_features is not None and max_idx > n_features:
        raise ValueError(
            f"feature index {max_idx} exceeds n_features={n_features}"
        )
    X = np.zeros((len(rows), max_idx), np.float32)
    for r, feats in enumerate(rows):
        for i, v in feats:
            X[r, i - 1] = v
    return X, np.asarray(labels, np.float32)


def write_libsvm(path: str, X, y):
    X = np.asarray(X)
    y = np.asarray(y)
    with open(path, "w") as f:
        for r in range(len(X)):
            feats = " ".join(
                f"{i + 1}:{X[r, i]:.9g}"
                for i in np.nonzero(X[r])[0]
            )
            f.write(f"{y[r]:.9g} {feats}".rstrip() + "\n")
