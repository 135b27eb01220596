"""Weighted latency sampling shared by JobMetrics and the drain flight
recorder — a copy of flink_tpu/metrics/latency.py (numpy only).

One emission of N windows at latency L contributes the weighted sample
(N, L); percentiles are computed over windows, not over emissions (the
reference's latency histograms are likewise per-element, LatencyMarker /
DescriptiveStatisticsHistogram). The sample list is bounded: past
``max_samples`` it compacts by merging adjacent sorted pairs, which
preserves the weighted distribution to well under bucket resolution while
keeping memory O(1) for perpetual streaming jobs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def weighted_percentile(samples: List[Tuple[float, float]],
                        q: float) -> Optional[float]:
    """Percentile (0..100) over weighted (weight, value) samples."""
    if not samples:
        return None
    val = np.asarray([v for _, v in samples], dtype=np.float64)
    w = np.asarray([n for n, _ in samples], dtype=np.float64)
    order = np.argsort(val)
    val, w = val[order], w[order]
    cdf = np.cumsum(w) / w.sum()
    idx = min(int(np.searchsorted(cdf, q / 100.0)), len(val) - 1)
    return float(val[idx])


class LatencySamples:
    """Bounded weighted (n, ms) sample sink with percentile queries."""

    def __init__(self, max_samples: int = 32768):
        self.max_samples = max_samples
        self._samples: List[Tuple[float, float]] = []

    def record(self, n: int, ms: float):
        if n:
            self._samples.append((float(n), float(ms)))
            if len(self._samples) > self.max_samples:
                self._compact()

    def _compact(self):
        """Halve by merging adjacent sorted pairs (weight-sum, weighted
        mean) — distribution-preserving at this resolution."""
        s = sorted(self._samples, key=lambda t: t[1])
        out = []
        for i in range(0, len(s) - 1, 2):
            (n1, v1), (n2, v2) = s[i], s[i + 1]
            n = n1 + n2
            out.append((n, (n1 * v1 + n2 * v2) / n))
        if len(s) % 2:
            out.append(s[-1])
        self._samples = out

    def percentile(self, q: float) -> Optional[float]:
        return weighted_percentile(self._samples, q)

    def __len__(self):
        return len(self._samples)

    def __bool__(self):
        return bool(self._samples)
