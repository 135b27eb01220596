"""G23 scatter_ids, G24 sorted_probe and G25 row_argmin / row_argmax — the
batch libraries' kernels — through their plain PyTorch versions on the
CPU, against the reference's functions on the same numpy inputs:
``flink_tpu.ops.segment.grouped_reduce``, ``flink_tpu.parallel.broadcast
.broadcast_join`` and the jnp expressions of KMeans' assignment and
community detection's superstep. Integer-valued data must match bit for
bit (NaN by position, signed zeros by sign); float sums, which the port
adds in another order, at rtol 1e-6."""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops.segment import grouped_reduce as ref_grouped_reduce
from flink_tpu.parallel import broadcast as ref_broadcast
from flink_tpu.parallel.broadcast import broadcast_join as ref_broadcast_join
from flink_tpu.parallel.mesh import MeshContext as RefMesh
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops.segment import grouped_reduce
from flink_tpu_torch.parallel import broadcast
from flink_tpu_torch.parallel.mesh import MeshContext

KINDS = ("count", "sum", "min", "max", "avg", "mean")


def same_bits(a, b) -> bool:
    """Equal float32 arrays: NaN at the same places, every other element
    bit for bit (so -0.0 differs from +0.0)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape != b.shape:
        return False
    na, nb = np.isnan(a), np.isnan(b)
    return bool((na == nb).all()
                and (a[~na].view(np.uint32) == b[~nb].view(np.uint32)).all())


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------ grouped_reduce

@pytest.mark.parametrize("kind", KINDS)
def test_grouped_reduce_integer_data_bit_for_bit(kind):
    rng = np.random.default_rng(3)
    n, G = 5000, 37
    gid = rng.integers(0, G - 2, n)           # the last two groups stay empty
    vals = rng.integers(-50, 51, n).astype(np.float32)
    got = grouped_reduce(kind, gid, vals, G, device="cpu")
    want = ref_grouped_reduce(kind, gid, vals, G)
    assert got.dtype == np.float32 and got.shape == (G,)
    assert same_bits(got, want), (got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_grouped_reduce_empty_table(kind):
    """No keys, n = 0: the Table's global aggregate over no row, G = 1."""
    gid = np.zeros(0, np.int64)
    vals = np.zeros(0, np.float32)
    got = grouped_reduce(kind, gid, vals, 1, device="cpu")
    assert same_bits(got, ref_grouped_reduce(kind, gid, vals, 1)), got


@pytest.mark.parametrize("kind", ("sum", "min", "max", "avg"))
def test_grouped_reduce_nan_and_signed_zeros(kind):
    gid = np.array([0, 0, 1, 1, 2, 2, 3, 3, 4])
    vals = np.array([np.nan, 1.0, -0.0, 0.0, 0.0, -0.0, -0.0, -0.0, 2.0],
                    np.float32)
    got = grouped_reduce(kind, gid, vals, 6, device="cpu")
    assert same_bits(got, ref_grouped_reduce(kind, gid, vals, 6)), got


@pytest.mark.parametrize("kind", ("sum", "avg"))
def test_grouped_reduce_float_sums(kind):
    """Sums of non-integer data: another order of float additions than
    XLA's, rtol 1e-6."""
    rng = np.random.default_rng(4)
    gid = rng.integers(0, 12, 20_000)
    vals = rng.uniform(0, 1, 20_000).astype(np.float32)
    got = grouped_reduce(kind, gid, vals, 12, device="cpu")
    np.testing.assert_allclose(got, ref_grouped_reduce(kind, gid, vals, 12),
                               rtol=1e-6)


def test_grouped_reduce_refuses_unknown_kind():
    with pytest.raises(ValueError, match="unknown aggregate"):
        grouped_reduce("median", [0], [1.0], 1, device="cpu")


# ------------------------------------------------------------ G23

@pytest.mark.parametrize("op", ("add", "min", "max"))
@pytest.mark.parametrize("idx_dtype", (np.int32, np.int64))
def test_scatter_ids_against_jnp_scatter(op, idx_dtype):
    """One column, with NaN and +-0 lanes and lanes out of range (dropped,
    as jnp's .at[] does with them)."""
    rng = np.random.default_rng(5)
    n, G = 3000, 64
    idx = rng.integers(0, G + 8, n).astype(idx_dtype)
    vals = rng.integers(-9, 10, n).astype(np.float32)
    vals[::97] = np.nan
    vals[1::31] = -0.0
    vals[2::29] = 0.0
    target, counts, has = kernels.scatter_ids_plain(
        _t(idx), _t(vals), G, op=op, counts=True, has=True)
    neutral = {"add": 0.0, "min": jnp.inf, "max": -jnp.inf}[op]
    at = jnp.full(G, neutral, jnp.float32).at[jnp.asarray(idx)]
    want = getattr(at, {"add": "add"}.get(op, op))(jnp.asarray(vals))
    assert same_bits(target.numpy(), np.asarray(want))
    ok = idx < G
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(idx[ok], minlength=G))
    np.testing.assert_array_equal(
        has.numpy(), np.asarray(jnp.zeros(G, bool).at[idx].set(True)))


def test_scatter_ids_rows_with_counts_is_kmeans_update():
    """W = 16 with the count column: KMeans' per-center sums and counts
    (ml/pipeline.py:241-242), integer-valued."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, 64, 4096)
    X = rng.integers(-20, 21, (4096, 16)).astype(np.float32)
    sums, counts, has = kernels.scatter_ids_plain(_t(a), _t(X), 64,
                                                  counts=True)
    assert has is None
    want_s = jnp.zeros((64, 16), jnp.float32).at[a].add(X)
    want_c = jnp.zeros((64,), jnp.float32).at[a].add(1.0)
    assert same_bits(sums.numpy(), np.asarray(want_s))
    assert same_bits(counts.numpy().astype(np.float32), np.asarray(want_c))


LIMIT = kernels.SCATTER_SHARED_CELLS


@pytest.mark.parametrize("op", ("add", "min", "max"))
@pytest.mark.parametrize("W,G", [(0, LIMIT - 1), (0, LIMIT), (0, LIMIT + 1),
                                 (3, LIMIT // 4), (3, LIMIT // 4 + 1),
                                 (16, 64)])
def test_scatter_ids_at_the_shared_limit(op, W, G):
    """Around G23's shared path limit (G (W + 1) cells a warp's copy: one
    side takes the shared path on the card, the other the global one),
    W = 3 through an offset (not 16-byte aligned) view, KMeans' W = 16,
    and a lane count that fills no whole chunk: the plain version against
    jnp's .at[] scatter and numpy's bincount, NaN and +-0 lanes and lanes
    out of range included."""
    rng = np.random.default_rng(G + W)
    n = 5003
    idx = rng.integers(-2, G + 3, n).astype(np.int64)
    vals = None
    if W:
        buf = rng.integers(-9, 10, n * W + 1).astype(np.float32)
        buf[::97] = np.nan
        buf[1::31] = -0.0
        vals = torch.from_numpy(buf)[1:].view(n, W)     # an offset view
        assert vals.is_contiguous() and vals.data_ptr() % 16 != 0
    target, counts, has = kernels.scatter_ids_plain(
        _t(idx), vals, G, op=op, counts=True, has=True)
    ok = (idx >= 0) & (idx < G)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(idx[ok], minlength=G))
    np.testing.assert_array_equal(has.numpy(), np.bincount(
        idx[ok], minlength=G) > 0)
    if W:
        neutral = {"add": 0.0, "min": jnp.inf, "max": -jnp.inf}[op]
        at = jnp.full((G, W), neutral, jnp.float32).at[
            jnp.asarray(np.where(ok, idx, G))]
        want = getattr(at, op)(jnp.asarray(vals.numpy()), mode="drop")
        assert same_bits(target.numpy(), np.asarray(want))
    else:
        assert target is None


def test_scatter_ids_counts_alone_and_no_lanes():
    _, counts, _ = kernels.scatter_ids_plain(
        _t([3, 3, 0, 9], torch.int32), None, 4, counts=True)
    assert counts.tolist() == [1, 0, 0, 2] and counts.dtype == torch.int32
    t, c, h = kernels.scatter_ids_plain(_t(np.zeros(0, np.int64)),
                                        _t(np.zeros(0, np.float32)), 3,
                                        op="min", counts=True, has=True)
    assert t.tolist() == [np.inf] * 3 and c.tolist() == [0] * 3
    assert h.tolist() == [False] * 3


def test_scatter_ids_refuses_bad_arguments():
    with pytest.raises(ValueError, match="scatter op"):
        kernels.scatter_ids(_t([0]), _t([1.0]), 1, op="mul")
    with pytest.raises(TypeError, match="int32 or int64"):
        kernels.scatter_ids(_t([0.0]), _t([1.0]), 1)
    with pytest.raises(ValueError, match="vals of shape"):
        kernels.scatter_ids(_t([0, 1]), _t([1.0]), 2)


# ------------------------------------------------------------ G24

def test_sorted_probe_hits_misses_and_the_ends():
    tkeys = np.array([-7, 2, 5, 9, 2**40], np.int64)
    tvals = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    keys = np.array([-7, 2**40, 3, -8, 2**41, 5, 9, 9, 0], np.int64)
    pos, hit, joined = kernels.sorted_probe_plain(_t(keys), _t(tkeys),
                                                  _t(tvals))
    assert pos.dtype == torch.int32
    assert pos.tolist() == [0, 4, 2, 0, 4, 2, 3, 3, 1]
    assert hit.tolist() == [True, True, False, False, False, True, True,
                            True, False]
    assert joined.tolist() == [1.0, 5.0, 0, 0, 0, 3.0, 4.0, 4.0, 0]
    pos, hit, joined = kernels.sorted_probe_plain(
        _t(keys), _t(np.zeros(0, np.int64)), _t(np.zeros(0, np.float32)))
    assert not hit.any() and not joined.any() and not pos.any()


def _join_inputs(seed, span):
    rng = np.random.default_rng(seed)
    tkeys = (rng.choice(span, 500, replace=False) - span // 2).astype(
        np.int64)
    tvals = rng.integers(0, 1000, 500).astype(np.float32)
    keys = np.concatenate([rng.choice(tkeys, 3000),
                           rng.integers(-span // 2, span // 2, 1000)])
    rng.shuffle(keys)
    return keys, tkeys, tvals


@pytest.mark.parametrize("seed", (0, 1))
def test_broadcast_join_matches_the_reference(seed):
    """Keys within int32: the reference runs JAX without 64-bit types and
    narrows int64 keys to int32, so wider keys are checked against numpy
    below."""
    keys, tkeys, tvals = _join_inputs(seed, 1 << 31)
    joined, hit = broadcast.broadcast_join(keys, tkeys, tvals, device="cpu")
    ref_joined, ref_hit = ref_broadcast_join(keys, tkeys, tvals)
    np.testing.assert_array_equal(hit, ref_hit)
    assert same_bits(joined, ref_joined)


def test_broadcast_join_compares_int64_keys_whole():
    keys, tkeys, tvals = _join_inputs(2, 1 << 62)
    keys[:5] = tkeys[:5] + (1 << 33)        # equal low 32 bits, no match
    joined, hit = broadcast.broadcast_join(keys, tkeys, tvals, device="cpu")
    table = dict(zip(tkeys.tolist(), tvals.tolist()))
    want = [k in table for k in keys.tolist()]
    np.testing.assert_array_equal(hit, want)
    np.testing.assert_array_equal(
        joined, [table.get(k, 0.0) for k in keys.tolist()])


def test_broadcast_step_over_a_mesh_raises():
    """The sharded step (K21 sharded; it raised until the shard mesh's
    broadcast was ported, hence the name) gives the reference's
    ``(joined, hit)`` at 2, 4 and 8 shards: each shard's G24 probes its
    slice of the lanes, invalid lanes join nothing."""
    keys, tkeys, tvals = _join_inputs(5, 1 << 31)
    B = len(keys) - len(keys) % 8
    keys = keys[:B]
    valid = np.arange(B) % 7 != 3
    order = np.argsort(tkeys, kind="stable")
    tk, tv = tkeys[order], tvals[order].astype(np.float32)
    for n in (2, 4, 8):
        ref_step = ref_broadcast.build_broadcast_join_step(
            RefMesh.create(n, devices=jax.devices()[:n]))
        want_j, want_h = ref_step(keys, valid, tk, tv)
        step = broadcast.build_broadcast_join_step(
            MeshContext.create(n, devices=[torch.device("cpu")] * n))
        joined, hit = step(keys, valid, tk, tv)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(want_h))
        assert same_bits(joined.numpy(), np.asarray(want_j))
        assert hit.numpy().any() and not hit.numpy()[~valid].any()


# ------------------------------------------------------------ G25

def test_row_argmin_matches_kmeans_assignment():
    """Ties (equal distances go to the first center) and NaN (the first
    NaN wins, as jnp.argmin's)."""
    rng = np.random.default_rng(7)
    P = rng.integers(-4, 5, (300, 9)).astype(np.float32)
    xx = rng.integers(0, 20, 300).astype(np.float32)
    cc = rng.integers(0, 3, 9).astype(np.float32)
    P[5, 3] = np.nan
    P[6, [2, 7]] = np.nan
    P[7, :] = 1.0
    got = kernels.row_argmin_plain(_t(P), _t(xx), _t(cc))
    d = (jnp.asarray(xx)[:, None] - 2.0 * jnp.asarray(P)) + jnp.asarray(cc)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmin(d, 1)))


def test_row_argmax_matches_community_superstep():
    rng = np.random.default_rng(8)
    V = 64
    m = rng.integers(0, 4, (V, V)).astype(np.float32)
    m[3, :] = 0.0                      # no mass: keeps label and score
    m[4, [10, 20]] = 5.0               # a tie: the first label
    m[5, 9] = np.nan
    labels = rng.permutation(V).astype(np.float32)
    scores = rng.uniform(0.1, 2, V).astype(np.float32)
    new_l, new_s = kernels.row_argmax_plain(_t(m), _t(labels), _t(scores),
                                            0.5)
    jm = jnp.asarray(m)
    best = jnp.argmax(jm, 1).astype(jnp.float32)
    mass = jnp.max(jm, 1)
    has = mass > 0
    want_l = jnp.where(has, best, jnp.asarray(labels))
    want_s = jnp.where(has, jnp.maximum(mass * 0.5, 1e-6),
                       jnp.asarray(scores))
    assert same_bits(new_l.numpy(), np.asarray(want_l))
    assert same_bits(new_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("K", (1, 3, 31, 33, 4095, 4097))
def test_row_argmax_nan_placements_and_odd_widths(K):
    """Widths that are not a multiple of 4 (the kernel's scalar loads),
    NaN first, last and inside one float4, two NaN, ties whose first
    column comes late in the row, all-zero and negative rows."""
    rng = np.random.default_rng(K)
    m = rng.integers(-3, 4, (12, K)).astype(np.float32)
    m[0, 0] = np.nan
    m[1, K - 1] = np.nan
    m[2, min(K - 1, 4 * 7 + 2)] = np.nan
    m[3, [K // 3, K - 1]] = np.nan
    m[4, :] = 0.0
    m[5, :] = -rng.uniform(0.5, 2.0, K)
    m[6, :] = 1.0
    m[6, [K // 2, K - 1]] = 7.0
    labels = np.arange(12, dtype=np.float32) + 0.5
    scores = rng.uniform(0.1, 2, 12).astype(np.float32)
    new_l, new_s = kernels.row_argmax_plain(_t(m), _t(labels), _t(scores),
                                            0.25)
    jm = jnp.asarray(m)
    mass = jnp.max(jm, 1)
    has = mass > 0
    want_l = jnp.where(has, jnp.argmax(jm, 1).astype(jnp.float32),
                       jnp.asarray(labels))
    want_s = jnp.where(has, jnp.maximum(mass * 0.25, 1e-6),
                       jnp.asarray(scores))
    assert same_bits(new_l.numpy(), np.asarray(want_l))
    assert same_bits(new_s.numpy(), np.asarray(want_s))


def test_plain_versions_count_no_launch():
    before = [fn.launches for fn in (kernels.scatter_ids,
                                     kernels.sorted_probe,
                                     kernels.row_argmin, kernels.row_argmax)]
    kernels.scatter_ids(_t([0]), _t([1.0]), 1)
    kernels.sorted_probe(_t([1]), _t([1]), _t([1.0]))
    kernels.row_argmin(_t([[1.0]]), _t([0.0]), _t([0.0]))
    kernels.row_argmax(_t([[1.0]]), _t([0.0]), _t([1.0]), 0.5)
    assert before == [fn.launches for fn in (
        kernels.scatter_ids, kernels.sorted_probe, kernels.row_argmin,
        kernels.row_argmax)]
    for fn, src in ((kernels.scatter_ids, "scatter_ids.cu"),
                    (kernels.sorted_probe, "sorted_probe.cu"),
                    (kernels.row_argmin, "row_argbest.cu"),
                    (kernels.row_argmax, "row_argbest.cu")):
        assert fn in kernels.KERNELS and kernels.source_of(fn) == src
