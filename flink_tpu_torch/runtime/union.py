"""The columnar-to-element bridge of flink_tpu/runtime/union.py: a copy of
its ``to_elements``. The rest of that module (``MergedSource`` and the
tagged union behind ``union``, ``connect`` and ``co_group``) comes with
the stateless operators (ROADMAP queue 1, item 9)."""

from __future__ import annotations


def to_elements(polled):
    """Normalize a source's poll() payload to a list of Python elements
    (columnar payloads become tuples / scalars)."""
    if (
        isinstance(polled, tuple)
        and len(polled) == 2
        and isinstance(polled[0], dict)
    ):
        cols, _ts = polled
        if not cols:
            return []
        names = list(cols)
        arrays = [cols[n] for n in names]
        if len(names) == 1:
            return list(arrays[0].tolist())
        return list(zip(*[a.tolist() for a in arrays]))
    return polled
