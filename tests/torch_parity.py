"""Shared inputs for the flink_tpu_torch parity tests (tests/test_torch_*.py).

Every input is made with numpy from a fixed seed and handed to both
packages: the JAX reference (flink_tpu, on the CPU as its own tests run
it) and the port (flink_tpu_torch, with device="cpu", i.e. the plain
PyTorch versions of its kernels). Shapes are small: C = 4096 keys, R = 8
ring panes, B = 1024 lanes, max parallelism 128, slide = 10 ticks.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.ops import window_kernels as wkt

C, R, B, MAXP, F = 4096, 8, 1024, 128, 2
SLIDE = 10
WINDOWS = {"tumbling": 10, "sliding": 20}   # size ticks (k = 1, k = 2)


def specs(window: str):
    size = WINDOWS[window]
    return (wkj.WindowSpec(size, SLIDE, ring=R, fires_per_step=F),
            wkj.ReduceSpec("sum", jnp.float32),
            wkt.WindowSpec(size, SLIDE, ring=R, fires_per_step=F),
            wkt.ReduceSpec("sum"))


def jax_fields(st) -> dict:
    """A JAX WindowShardState's leaves as numpy, under the port's names."""
    out = {"table.keys": np.asarray(st.table.keys)}
    for name in wkt.STATE_FIELDS[1:]:
        out[name] = np.asarray(getattr(st, name))
    return out


def lanes_torch(hi, lo, ts, vals, valid):
    """numpy lanes -> the port's tensors (uint32 halves as int32 bits)."""
    return (torch.from_numpy(hi.view(np.int32).copy()),
            torch.from_numpy(lo.view(np.int32).copy()),
            torch.from_numpy(ts.astype(np.int32)),
            torch.from_numpy(vals.astype(np.float32)),
            torch.from_numpy(valid.copy()))


# (pane range of most lanes, watermark ticks after the batch, extra lanes)
SCHEDULE = (
    ((0, 3), 5, None),
    ((0, 5), 15, None),            # pane 0 late from here on
    ((3, 7), 25, "clear"),         # folds a deferred purge of row 1
    ((5, 13), 28, "too_old"),      # rotates the ring over unfired panes
    ((11, 14), 75, "negative"),    # negative ticks; several windows due
    ((12, 15), 131, None),
)


def batches(seed: int, floats: bool = False):
    """Six batches reaching every branch of the update and the fire: late
    lanes (watermark and purge cursor), invalid lanes, keys past capacity
    or with a nonzero high word, a ring rotation that evicts unfired panes,
    too-old lanes, negative ticks, a deferred purge folded into the sweep,
    and watermark jumps that make more windows due than F lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for (p0, p1), wm, extra in SCHEDULE:
        hi = np.where(rng.random(B) < 0.02, 1, 0).astype(np.uint32)
        lo = rng.integers(0, C + 64, B).astype(np.uint32)
        lo[:64] = rng.integers(0, 32, 64)          # duplicate-heavy keys
        ts = rng.integers(p0 * SLIDE, p1 * SLIDE, B).astype(np.int32)
        if extra == "too_old":
            ts[:40] = rng.integers(3 * SLIDE, 5 * SLIDE, 40)
        if extra == "negative":
            ts[:20] = -rng.integers(1, 30, 20)
        if floats:
            # positive, so a sum never cancels and a relative tolerance
            # bounds the rounding of a different summation order
            vals = rng.uniform(0.5, 8.0, B).astype(np.float32)
        else:
            vals = rng.integers(1, 9, B).astype(np.float32)
        valid = rng.random(B) < 0.9
        clear = np.zeros(R, bool)
        if extra == "clear":
            clear[1] = True
        out.append((hi, lo, ts, vals, valid, np.int32(wm), clear))
    return out


def assert_states_equal(jax_st, port_st, rtol: float = 0.0) -> None:
    """Every field equal; the accumulator plane within ``rtol`` (0 means
    bit for bit)."""
    want, got = jax_fields(jax_st), wkt.state_to_numpy(port_st)
    for name in wkt.STATE_FIELDS:
        w, g = want[name], got[name]
        assert w.shape == g.shape, (name, w.shape, g.shape)
        if name == "acc" and rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def assert_fires_equal(jax_fr, port_fr, rtol: float = 0.0) -> None:
    for name in ("counts", "window_end_ticks", "n_fires", "lane_valid"):
        np.testing.assert_array_equal(
            getattr(port_fr, name).numpy(), np.asarray(getattr(jax_fr, name)),
            err_msg=name)
    np.testing.assert_allclose(port_fr.value_sums.numpy(),
                               np.asarray(jax_fr.value_sums), rtol=rtol,
                               atol=0, err_msg="value_sums")


def jax_set_watermark(jax_st, wm: int):
    return dataclasses.replace(
        jax_st, watermark=jnp.maximum(jax_st.watermark, jnp.int32(wm)))


def set_watermark(jax_st, port_st, wm: int):
    """Advance both watermarks as the mask route does after an update."""
    port_st.watermark.copy_(torch.maximum(
        port_st.watermark, torch.tensor(wm, dtype=torch.int32)))
    return jax_set_watermark(jax_st, wm)


def key_halves(keys: np.ndarray):
    """int64 key identities -> (hi, lo) uint32 halves."""
    w = np.asarray(keys, np.int64).view(np.uint64)
    return ((w >> np.uint64(32)).astype(np.uint32),
            (w & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def sparse_batches(seed: int, floats: bool = False):
    """``batches`` with sparse 64-bit key identities for the hash layout:
    keys from a pool of 1,200 (a load of at most 0.3 at C, below where the
    reference's four claim rounds can leave a key out), duplicate-heavy
    lanes, and in the third batch lanes of the key -1, which equals the
    table's EMPTY word and drops as capacity loss on both sides."""
    rng = np.random.default_rng(seed + 1000)
    pool = rng.integers(-(2**63), 2**63 - 1, 1200, dtype=np.int64)
    out = []
    for i, (_hi, _lo, ts, vals, valid, wm, clear) in enumerate(
            batches(seed, floats)):
        keys = pool[rng.integers(0, len(pool), B)]
        keys[:64] = pool[:8].repeat(8)
        if i == 2:
            keys[64:80] = -1
        hi, lo = key_halves(keys)
        out.append((hi, lo, ts, vals, valid, wm, clear))
    return out


def logical_state(fields: dict, red) -> dict:
    """A state's fields with the slot order taken out, so that two hash
    tables that placed the same keys at other slots compare equal: the
    key words of the used slots sorted, each with its [R, 2] plane column;
    the planes of unused slots must be untouched (all zero)."""
    rows = fields["table.keys"].astype(np.uint64)
    words = (rows[:, 0] << np.uint64(32)) | rows[:, 1]
    used = words != np.uint64(0xFFFFFFFFFFFFFFFF)
    cap = len(words)
    planes = np.asarray(fields["acc"]).reshape(-1, cap, 2)
    assert not planes[:, ~used].any()
    order = np.argsort(words[used], kind="stable")
    out = {k: v for k, v in fields.items()
           if k not in ("table.keys", "acc", "touched", "fresh")}
    out["keys"] = words[used][order]
    out["planes"] = planes[:, used][:, order]
    return out


def fire_rows(fr, f: int):
    """Lane f's rows of a CompactFires (either package) as
    (key word uint64, value) sorted by key, and in emission order."""
    n = int(np.asarray(fr.counts)[f])
    khi = np.asarray(fr.key_hi)[f, :n].view(np.uint32).astype(np.uint64)
    klo = np.asarray(fr.key_lo)[f, :n].view(np.uint32).astype(np.uint64)
    words = (khi << np.uint64(32)) | klo
    vals = np.asarray(fr.values)[f, :n]
    order = np.argsort(words, kind="stable")
    return (words[order], vals[order]), (words, vals)


@functools.lru_cache(maxsize=None)
def jax_kernels(window: str, precombine: bool):
    """Jitted reference update (direct layout, packed or split planes per
    the state) and resident reduced advance, built once per process so
    the tests share their compiles."""
    win, red, _, _ = specs(window)

    def upd(st, hi, lo, ts, vals, valid, clear):
        return wkj.update(st, win, red, hi, lo, ts, vals, valid,
                          direct=True, precombine=precombine,
                          clear_rows=clear)[0]

    def adv(st, wm):
        return wkj.advance_and_fire_resident(st, win, red, wm, reduced=True)

    return jax.jit(upd), jax.jit(adv)


@functools.lru_cache(maxsize=None)
def jax_hash_kernels(window: str):
    """Jitted reference update in the hash layout (insert path, pre-combine
    on) and resident compact advance, returning the activity too."""
    win, red, _, _ = specs(window)

    def upd(st, hi, lo, ts, vals, valid, clear):
        st, act, _ = wkj.update(st, win, red, hi, lo, ts, vals, valid,
                                insert=True, precombine=True,
                                clear_rows=clear)
        return st, act

    def adv(st, wm):
        return wkj.advance_and_fire_resident(st, win, red, wm)

    return jax.jit(upd), jax.jit(adv)


# -- the keyed operators: sessions, count windows, rolling reduces -------

KC, KB = 1024, 256          # their table capacity and batch


def keyed_batches(seed: int, n: int, pool: int = 150, t0: int = 0,
                  ts_step: int = 40, ts_span: int = 60,
                  floats: bool = False):
    """``n`` batches of KB lanes over a pool of sparse 64-bit keys (a load
    of at most 0.15 at KC): a hot key in a quarter of the lanes, duplicate
    runs, invalid lanes, and in the second batch lanes of the key -1
    (== EMPTY, never placed: a counted capacity loss on both sides).
    Batch i's ticks are ``t0 + i * ts_step + [0, ts_span)``, so they
    overlap the batch before (out of order within the span)."""
    rng = np.random.default_rng(seed)
    keys_pool = rng.integers(-(2**63), 2**63 - 1, pool, dtype=np.int64)
    out = []
    for i in range(n):
        keys = keys_pool[rng.integers(0, pool, KB)]
        keys[: KB // 4] = keys_pool[0]
        keys[KB // 4: KB // 4 + 32] = keys_pool[1:5].repeat(8)
        if i == 1:
            keys[-8:] = -1
        hi, lo = key_halves(keys)
        ts = (t0 + i * ts_step + rng.integers(0, ts_span, KB)).astype(
            np.int32)
        if floats:
            vals = rng.uniform(0.5, 8.0, KB).astype(np.float32)
        else:
            vals = rng.integers(1, 9, KB).astype(np.float32)
        valid = rng.random(KB) < 0.9
        out.append((hi, lo, ts, vals, valid))
    return out


def keyed_lanes_torch(hi, lo, vals, valid, ts=None):
    """numpy lanes -> the port's tensors; ts too when given."""
    out = [torch.from_numpy(hi.view(np.int32).copy()),
           torch.from_numpy(lo.view(np.int32).copy())]
    if ts is not None:
        out.append(torch.from_numpy(ts.astype(np.int32)))
    out += [torch.from_numpy(vals.astype(np.float32)),
            torch.from_numpy(valid.copy())]
    return out


def jax_keyed_fields(st, names) -> dict:
    """A JAX session / count / rolling state's leaves as numpy, under the
    port's names (``table.keys`` the uint32 [C, 2] rows)."""
    out = {"table.keys": np.asarray(st.table.keys)}
    for name in names[1:]:
        out[name] = np.asarray(getattr(st, name))
    return out


def keyed_state(fields: dict) -> dict:
    """Per-slot fields with the slot order taken out: the used slots' key
    words sorted, each slot field at those slots; scalars as they are."""
    rows = np.asarray(fields["table.keys"]).astype(np.uint64)
    words = (rows[:, 0] << np.uint64(32)) | rows[:, 1]
    used = np.nonzero(words != np.uint64(0xFFFFFFFFFFFFFFFF))[0]
    order = used[np.argsort(words[used], kind="stable")]
    out = {"keys": words[order]}
    for name, v in fields.items():
        if name == "table.keys":
            continue
        v = np.asarray(v)
        out[name] = v if v.ndim == 0 else v[order]
    return out


def assert_keyed_states_equal(want_fields: dict, got_fields: dict,
                              rtol: float = 0.0) -> None:
    """Tables compared as sets of keys, each key's slot fields equal (the
    accumulators within ``rtol``; 0 means bit for bit)."""
    want, got = keyed_state(want_fields), keyed_state(got_fields)
    assert want.keys() == got.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name == "acc" and rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def sorted_rows(cols) -> np.ndarray:
    """Rows given as equal-length columns -> a float64 [n, k] array sorted
    by all columns (key words as uint64 first), for set comparison."""
    a = np.stack([np.asarray(c, np.float64) for c in cols], 1)
    if not len(a):
        return a
    return a[np.lexsort(a.T[::-1])]


def words_of(hi, lo) -> np.ndarray:
    hi = np.asarray(hi).view(np.uint32).astype(np.uint64)
    lo = np.asarray(lo).view(np.uint32).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


# -- sketch windows (Count-Min, HyperLogLog) ------------------------------

from flink_tpu.ops import sketches as skj  # noqa: E402
from flink_tpu_torch.ops import sketches as skt  # noqa: E402

QUERY = [1, 2, 3]
P = 8                       # HyperLogLog precision: W = 256 registers
DEPTH, WIDTH = 4, 64        # Count-Min: W = 256 registers
KINDS = ("hll", "cms_query", "cms_raw")


def hll_atol(m: int) -> float:
    return 4 * m * float(np.spacing(np.float32(np.log(m))))


def reduce_specs(kind: str):
    """(reference ReduceSpec, port ReduceSpec) as distinct_count and
    count_min build them."""
    out = []
    for sk, wk in ((skj, wkj), (skt, wkt)):
        if kind == "hll":
            s = sk.HyperLogLog(P)
            out.append(wk.ReduceSpec(
                "sketch", s.dtype, s.value_shape, sketch=s,
                finalize=s.finalize, result_shape=s.result_shape,
                result_dtype=s.result_dtype))
        else:
            q = QUERY if kind == "cms_query" else None
            s = sk.CountMinSketch(DEPTH, WIDTH, query=q)
            kw = {} if q is None else dict(
                finalize=s.finalize, result_shape=s.result_shape,
                result_dtype=s.result_dtype)
            out.append(wk.ReduceSpec("sketch", s.dtype, s.value_shape,
                                     sketch=s, **kw))
    return out


def item_hashes(seed: int, n: int) -> np.ndarray:
    """uint32 item hashes of a stream: item 1 in a quarter of the lanes,
    the other query items often, the rest from 5,000 items."""
    rng = np.random.default_rng(seed)
    items = rng.integers(0, 5000, n)
    items[rng.random(n) < 0.25] = 1
    items[rng.random(n) < 0.05] = rng.integers(2, 4)
    return skt.hash32_host(items)


def sketch_batches(seed: int):
    """The six-batch schedule with sparse keys, each batch's values the
    item hashes' int32 bits."""
    out = []
    for i, (hi, lo, ts, _v, valid, wm, clear) in enumerate(
            sparse_batches(seed)):
        h = item_hashes(seed * 10 + i, len(hi))
        out.append((hi, lo, ts, h, valid, wm, clear))
    return out


def port_lanes(hi, lo, ts, h, valid):
    t = lanes_torch(hi, lo, ts, np.zeros(len(hi), np.float32), valid)
    return t[0], t[1], t[2], torch.from_numpy(h.view(np.int32).copy()), t[4]


@functools.lru_cache(maxsize=None)
def jax_sketch_kernels(kind: str):
    win = wkj.WindowSpec(2 * SLIDE, SLIDE, ring=R, fires_per_step=F)
    red = reduce_specs(kind)[0]

    def upd(st, hi, lo, ts, h, valid, clear):
        st, act, _ = wkj.update(st, win, red, hi, lo, ts, h, valid,
                                insert=True, clear_rows=clear)
        return st, act

    def adv(st, wm):
        return wkj.advance_and_fire_resident(st, win, red, wm)

    def adv_reduced(st, wm):
        return wkj.advance_and_fire_resident(st, win, red, wm, reduced=True)

    return jax.jit(upd), jax.jit(adv), jax.jit(adv_reduced)


def sketch_states(kind: str):
    red_j, red_t = reduce_specs(kind)
    win_t = wkt.WindowSpec(2 * SLIDE, SLIDE, ring=R, fires_per_step=F)
    win_j = wkj.WindowSpec(2 * SLIDE, SLIDE, ring=R, fires_per_step=F)
    sj = wkj.init_state(C, 16, win_j, red_j, layout="hash",
                        n_key_groups=MAXP, packed=False)
    st = wkt.init_state(C, win_t, red_t, n_key_groups=MAXP, device="cpu",
                        layout="hash")
    return win_j, red_j, win_t, red_t, sj, st


def logical_sketch_state(fields: dict) -> dict:
    """A split-plane state's fields with the slot order taken out: the used
    slots' key words sorted, each with its [R, W] registers and [R]
    touched bits; unused slots must be untouched (all zero)."""
    rows = fields["table.keys"].astype(np.uint64)
    words = (rows[:, 0] << np.uint64(32)) | rows[:, 1]
    used = words != np.uint64(0xFFFFFFFFFFFFFFFF)
    cap = len(words)
    regs = np.asarray(fields["acc"]).reshape(-1, cap,
                                             fields["acc"].shape[-1])
    touched = np.asarray(fields["touched"]).reshape(-1, cap)
    assert not regs[:, ~used].any() and not touched[:, ~used].any()
    order = np.argsort(words[used], kind="stable")
    out = {k: v for k, v in fields.items()
           if k not in ("table.keys", "acc", "touched")}
    out["keys"] = words[used][order]
    out["registers"] = regs[:, used][:, order]
    out["touched"] = touched[:, used][:, order]
    return out


def assert_sketch_states_equal(sj, st) -> None:
    want = logical_sketch_state(jax_fields(sj))
    got = logical_sketch_state(wkt.state_to_numpy(st))
    assert want.keys() == got.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def sketch_fire_rows(fr, f: int):
    """Lane f's (key words, values) sorted by key, from either package."""
    n = int(np.asarray(fr.counts)[f])
    words = words_of(np.asarray(fr.key_hi)[f, :n],
                     np.asarray(fr.key_lo)[f, :n])
    vals = np.asarray(fr.values)[f, :n]
    order = np.argsort(words, kind="stable")
    return words[order], vals[order]


def assert_values_equal(kind, got, want, n_rows=1, err=""):
    if kind == "hll":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=hll_atol(1 << P) * n_rows,
                                   err_msg=err)
    else:
        np.testing.assert_array_equal(got, want, err_msg=err)


# -- allowed lateness ------------------------------------------------------

LATENESS = 25               # ticks: 2.5 panes of slide 10

# (pane range of most lanes, late pane range of a third of them,
#  watermark ticks after the batch)
LATE_SCHEDULE = (
    ((0, 3), None, 25),
    ((2, 6), (0, 3), 55),          # pane 0-2 late: re-fire or beyond L
    ((4, 8), (1, 5), 62),          # more fresh windows than F lanes
    ((5, 9), (3, 7), 75),
    ((7, 11), (2, 9), 99),         # some beyond lateness, some re-fire
    ((9, 12), (6, 10), 131),       # a jump: the horizon passes them all
)


def late_batches(seed: int, floats: bool = False):
    """Six batches of out-of-order records for allowed lateness L =
    ``LATENESS``: each batch after the first sends a third of its lanes to
    panes the watermark has passed — some within L of their windows' ends
    (they re-fire them; more than F windows at a time), some beyond it
    (late drops) — with duplicate-heavy keys, invalid lanes and keys past
    capacity, as ``batches`` has them."""
    rng = np.random.default_rng(seed + 500)
    out = []
    for (p0, p1), late, wm in LATE_SCHEDULE:
        hi = np.where(rng.random(B) < 0.02, 1, 0).astype(np.uint32)
        lo = rng.integers(0, C + 64, B).astype(np.uint32)
        lo[:64] = rng.integers(0, 32, 64)
        ts = rng.integers(p0 * SLIDE, p1 * SLIDE, B).astype(np.int32)
        if late is not None:
            sel = rng.random(B) < 1 / 3
            ts[sel] = rng.integers(late[0] * SLIDE, late[1] * SLIDE,
                                   int(sel.sum()))
        if floats:
            vals = rng.uniform(0.5, 8.0, B).astype(np.float32)
        else:
            vals = rng.integers(1, 9, B).astype(np.float32)
        valid = rng.random(B) < 0.9
        out.append((hi, lo, ts, vals, valid, np.int32(wm),
                    np.zeros(R, bool)))
    return out


# -- min, max, mean and generic reduces -----------------------------------

# kind -> what the test's values look like: mean is the [v, 1] pair the
# API's extractor builds; gvec a (sum, max) pair of a generic reduce
REDUCE_KINDS = ("min", "max", "mean", "gsum", "gmax", "gvec")
GMAX_NEUTRAL = -1e30


def _gvec_jax(a, b):
    return jnp.stack([a[..., 0] + b[..., 0],
                      jnp.maximum(a[..., 1], b[..., 1])], -1)


def _gvec_torch(a, b):
    return torch.stack([a[..., 0] + b[..., 0],
                        torch.maximum(a[..., 1], b[..., 1])], -1)


def reduce_pair(kind: str):
    """(reference ReduceSpec, port ReduceSpec, packed planes?) for a kind
    of ``REDUCE_KINDS`` and for sum and count; each package gets its own
    combine function (jnp on one side, torch on the other)."""
    if kind == "mean":
        return (wkj.ReduceSpec("sum", jnp.float32, value_shape=(2,)),
                wkt.ReduceSpec("sum", value_shape=(2,)), True)
    if kind == "gsum":
        return (wkj.ReduceSpec("generic", jnp.float32,
                               combine=lambda a, b: a + b, neutral=0.0),
                wkt.ReduceSpec("generic", combine=lambda a, b: a + b,
                               neutral=0.0), False)
    if kind == "gmax":
        return (wkj.ReduceSpec("generic", jnp.float32, combine=jnp.maximum,
                               neutral=GMAX_NEUTRAL),
                wkt.ReduceSpec("generic", combine=torch.maximum,
                               neutral=GMAX_NEUTRAL), False)
    if kind == "gvec":
        neutral = np.array([0.0, GMAX_NEUTRAL], np.float32)
        return (wkj.ReduceSpec("generic", jnp.float32, (2,),
                               combine=_gvec_jax, neutral=neutral),
                wkt.ReduceSpec("generic", torch.float32, (2,),
                               combine=_gvec_torch, neutral=neutral), False)
    return wkj.ReduceSpec(kind, jnp.float32), wkt.ReduceSpec(kind), True


def reduce_values(kind: str, vals: np.ndarray, seed: int) -> np.ndarray:
    """A batch's values for a reduce kind: the batch's scalars shifted to
    both signs for min and max (with +-0.0 and a hot key's ties), a
    [v, 1] pair for mean, a [v, w] pair for gvec."""
    rng = np.random.default_rng(seed)
    if kind == "mean":
        return np.stack([vals, np.ones_like(vals)], -1)
    if kind == "gvec":
        return np.stack([vals, rng.uniform(-9, 9, len(vals)).astype(
            np.float32)], -1)
    out = (vals - 4.5).astype(np.float32)
    if kind in ("min", "max"):
        out[:16] = np.array([0.0, -0.0] * 8, np.float32)
    return out


def logical_planes(fields: dict) -> dict:
    """A window state's fields with the slot order taken out (either
    plane): the used slots' key words sorted, each with its [R, ...] acc
    cells (and touched bits for split planes); unused slots must hold
    their plane's untouched contents."""
    rows = fields["table.keys"].astype(np.uint64)
    words = (rows[:, 0] << np.uint64(32)) | rows[:, 1]
    used = words != np.uint64(0xFFFFFFFFFFFFFFFF)
    cap = len(words)
    acc = np.asarray(fields["acc"])
    cells = acc.reshape((-1, cap) + acc.shape[1:])
    order = np.argsort(words[used], kind="stable")
    out = {k: v for k, v in fields.items()
           if k not in ("table.keys", "acc", "touched", "fresh")}
    out["keys"] = words[used][order]
    out["cells"] = cells[:, used][:, order]
    out["fresh"] = np.asarray(fields["fresh"]).reshape(-1, cap)[:, used][
        :, order]
    assert not np.asarray(fields["fresh"]).reshape(-1, cap)[:, ~used].any()
    if np.asarray(fields["touched"]).size:
        t = np.asarray(fields["touched"]).reshape(-1, cap)
        assert not t[:, ~used].any()
        out["touched"] = t[:, used][:, order]
    return out
