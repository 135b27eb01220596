"""G19's block-form tile map (``ops/cuda.py cep_tile_map_plain``) against
the reference's dense ``event_matrices`` (flink_tpu/cep/device.py:109),
and a CPU model of G19's tiled scan (csrc/cep_scan.cu) against
``cep_scan_plain``.

A run of lanes maps every ring bucket by one shared (S-1) x (S-1) matrix,
injects into bucket q_t only and adds a linear form of the buckets' sum to
M: the ordered product of the reference's [D, D] matrices must equal the
block form's dense expansion exactly, for 1, 2, 3 and 15 stages, one
bucket and nine, mixed contiguity, dead lanes. Every count stays below
2^24, where float32 is exact.

The model runs the kernel's algorithm on the CPU with small tiles: a tile
with a segment start walks its pieces from their carry rows (a first piece
that continues the tile before from that tile's end state); a tile with
none publishes its map, looks back to the nearest tile with an end state
and applies the maps in between, then walks sigma and M for the deltas;
row C is reset after its one read. Its deltas and carry must equal
``cep_scan_plain``'s bit for bit where segments end just before, at and
just after a tile boundary, a hot key spans every tile, pieces are one
lane, S = 1, Q = 1, dead lanes cross tiles, B is below one tile or not a
multiple of it, and D = 128."""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.cep import device as dj
from flink_tpu_torch.ops import cuda as kernels

INT_MAX = np.float32(2**31)


def _relaxed(S, rng):
    return (True,) + tuple(bool(x) for x in rng.random(S - 1) < 0.5)


def tile_map_dense(A, b, f, g, *, Q: int, q_t: int):
    """The [D, D] matrix of a block-form map (cep_tile_map_plain) in the
    reference's layout, v = [c_{0,0} .. c_{S-2,Q-1}, M, 1]."""
    ns = A.shape[0]
    D = ns * Q + 2
    T = torch.zeros(D, D, dtype=torch.float32, device=A.device)
    for q in range(Q):
        idx = torch.arange(ns, device=A.device) * Q + q
        T[idx[:, None], idx[None, :]] = A
        T[D - 2, idx] = f
    if ns:
        T[torch.arange(ns, device=A.device) * Q + q_t, D - 1] = b
    T[D - 2, D - 2] = 1.0
    T[D - 2, D - 1] = g
    T[D - 1, D - 1] = 1.0
    return T


@pytest.mark.parametrize("Q", [1, 9])
@pytest.mark.parametrize("S", [1, 2, 3, 15])
def test_tile_map_equals_the_event_matrices_product(S, Q):
    rng = np.random.default_rng(100 * S + Q)
    n = 40
    relaxed = _relaxed(S, rng)
    masks = rng.random((n, S)) < 0.3
    live = rng.random(n) < 0.85
    q_t = int(rng.integers(0, Q))
    spec = dj.DevicePatternSpec(n_stages=S, relaxed=relaxed,
                                within_panes=Q, pane_ms=1 if Q > 1 else 0)
    T = np.asarray(dj.event_matrices(spec, jnp.asarray(masks),
                                     jnp.int32(q_t) if Q > 1 else None))
    D = spec.dim
    T = np.where(live[:, None, None], T, np.eye(D, dtype=np.float32))
    P = np.eye(D, dtype=np.float64)
    for Ti in T:
        P = Ti.astype(np.float64) @ P
    assert np.abs(P).max() < 2**24
    A, b, f, g = kernels.cep_tile_map_plain(torch.from_numpy(masks),
                                            torch.from_numpy(live), relaxed)
    got = tile_map_dense(A, b, f, g, Q=Q, q_t=q_t).numpy()
    np.testing.assert_array_equal(got, P.astype(np.float32))


# ---------------------------------------------- a CPU model of the kernel

def _key_walk(c, M, m, u1, keep, q_t):
    """One live lane on a key's vector: c float32 [S-1, Q] in place."""
    ns = c.shape[0]
    if ns == 0:
        return M + (u1 if m[0] else np.float32(0))
    if m[ns]:
        M = M + c[ns - 1].sum(dtype=np.float32)
    for s in range(ns - 1, 0, -1):
        c[s] = (c[s] if keep[s] else 0) + (c[s - 1] if m[s] else 0)
    c[0] = c[0] if keep[0] else 0
    if m[0]:
        c[0, q_t] += u1
    return M


def _apply(tile_map, c, M, u1, q_t):
    """A block-form map on a key's vector (buckets c [S-1, Q], M)."""
    A, b, f, g = (x.numpy() for x in tile_map)
    sigma = c.sum(axis=1, dtype=np.float32)
    M = M + np.float32(f @ sigma) + g * u1
    c = (A @ c).astype(np.float32)
    if c.shape[0]:
        c[:, q_t] += b * u1
    return c, np.float32(M)


def tiled_scan_model(order, key_s, seg_start, masks, carry, relaxed, Q, q_t,
                     tile):
    """G19's algorithm on numpy with ``tile`` lanes a tile; carry float32
    [C+1, D] in place; returns the deltas in lane order."""
    B = len(order)
    C, D = carry.shape[0] - 1, carry.shape[1]
    S = masks.shape[1]
    ns = S - 1
    keep = [bool(relaxed[s + 1]) for s in range(ns)]
    start = seg_start.copy()
    if B:
        start[0] = True
    live = key_s < C
    bits = masks[order]
    delta = np.zeros(B, np.float32)
    ends, maps = {}, {}   # tile -> end state (c, M, u1) / block-form map

    def row(j):
        v = carry[key_s[j]]
        return v[:ns * Q].reshape(ns, Q).copy(), v[D - 2], v[D - 1]

    def write(j, c, u1):
        if live[j]:
            carry[key_s[j], :ns * Q] = np.minimum(c, INT_MAX).reshape(-1)
            carry[key_s[j], D - 2] = 0
            carry[key_s[j], D - 1] = min(u1, INT_MAX)

    def walk(j0, j1, c, M, u1, first_real):
        prev = M if first_real else min(M, INT_MAX)
        for j in range(j0, j1):
            if live[j]:
                M = _key_walk(c, M, bits[j], u1, keep, q_t)
            mc = min(M, INT_MAX)
            delta[order[j]] = mc - prev
            prev = mc
        return c, M

    def look_back(t):
        k = max(i for i in ends if i < t and i not in maps)
        c, M, u1 = ends[k]
        c = c.copy()
        for i in range(k + 1, t):
            c, M = _apply(maps[i], c, M, u1, q_t)
        return c, M, u1

    for t in range(-(-B // tile)):
        t0, t1 = t * tile, min(B, (t + 1) * tile)
        cont = not start[t0]
        ends_here = t1 == B or start[t1]
        if start[t0:t1].any():
            cuts = [t0] + [j for j in range(t0 + 1, t1) if start[j]] + [t1]
            for p, (j0, j1) in enumerate(zip(cuts[:-1], cuts[1:])):
                last = j1 == t1
                if p == 0 and cont:
                    c, M, u1 = look_back(t)
                else:
                    c, M, u1 = row(j0)
                c, M = walk(j0, j1, c, M, u1, not (p == 0 and cont))
                if not last or ends_here:
                    write(j0, c, u1)
                if last:
                    ends[t] = (c.copy(), M, u1)
        else:
            maps[t] = kernels.cep_tile_map_plain(
                torch.from_numpy(bits[t0:t1]), torch.from_numpy(live[t0:t1]),
                relaxed)
            c, M, u1 = look_back(t)
            walk(t0, t1, c.copy(), M, u1, False)
            c, M = _apply(maps[t], c, M, u1, q_t)
            ends[t] = (c, M, u1)
            if ends_here:
                write(t0, c, u1)
    carry[C] = 0
    carry[C, D - 1] = 1
    return delta


def _lanes(C, slot, live, S, rng, p=0.3):
    """G10's outputs on the slot key (C for a dead lane) and stage bits."""
    key = np.where(live, slot, C).astype(np.int64)
    order = np.argsort(key, kind="stable").astype(np.int32)
    key_s = key[order]
    seg_start = np.ones(len(key), bool)
    seg_start[1:] = key_s[1:] != key_s[:-1]
    masks = rng.random((len(key), S)) < p
    return order, key_s, seg_start, masks


def _case(kind, rng):
    """(slots, live, S, Q, tile) for one edge shape."""
    C, tile = 64, 8
    S, Q, B = 3, 4, 40
    live = np.ones(B, bool)
    if kind in ("end_before", "end_at", "end_after"):
        # key 5 ends one lane before, at, one lane after the boundary 16
        end = {"end_before": 15, "end_at": 16, "end_after": 17}[kind]
        slot = np.r_[np.full(end, 5), rng.integers(6, 20, B - end)]
    elif kind == "hot_key":
        # one key through every tile, a new key starting mid-tile at its end
        slot = np.r_[np.full(B - 3, 7), np.full(3, 9)]
    elif kind == "one_lane_pieces":
        slot = rng.permutation(C)[:B]
    elif kind == "one_stage":
        S, slot = 1, rng.integers(0, 6, B)
    elif kind == "one_bucket":
        Q, slot = 1, rng.integers(0, 4, B)
    elif kind == "dead_crossing":
        slot = rng.integers(0, 3, B)
        live = rng.random(B) < 0.4        # the dead run crosses tiles
    elif kind == "below_one_tile":
        B = 5
        slot, live = rng.integers(0, 3, B), np.ones(B, bool)
    elif kind == "ragged":
        B = 43
        slot, live = rng.integers(0, 4, B), np.ones(B, bool)
    elif kind == "d128":
        S, Q, B = 15, 9, 96
        slot, live = rng.integers(0, 3, B), rng.random(B) < 0.95
    elif kind == "cep_tile":
        tile, B = kernels.CEP_TILE, 3 * kernels.CEP_TILE + 17
        slot, live = np.where(rng.random(B) < 0.7, 3,
                              rng.integers(0, 40, B)), np.ones(B, bool)
    return C, slot, live, S, Q, tile


KINDS = ["end_before", "end_at", "end_after", "hot_key", "one_lane_pieces",
         "one_stage", "one_bucket", "dead_crossing", "below_one_tile",
         "ragged", "d128", "cep_tile"]


@pytest.mark.parametrize("kind", KINDS)
def test_tiled_scan_model_equals_the_plain_scan(kind):
    rng = np.random.default_rng(KINDS.index(kind) + 7)
    C, slot, live, S, Q, tile = _case(kind, rng)
    relaxed = _relaxed(S, rng)
    q_t = int(rng.integers(0, Q))
    D = (S - 1) * Q + 2
    p = 0.05 if kind in ("d128", "cep_tile") else 0.3
    carry = np.zeros((C + 1, D), np.float32)
    carry[:, D - 1] = 1
    carry[:C, :D - 2] = rng.integers(0, 3, (C, D - 2))
    carry[:C, D - 2] = rng.integers(0, 3, C)    # M carried in
    carry[C, D - 2] = 0
    want = torch.from_numpy(carry.copy())
    got = carry.copy()
    for call in range(2):   # a second batch on the carried state
        order, key_s, seg_start, masks = _lanes(C, slot, live, S, rng, p)
        d_want = kernels.cep_scan_plain(
            torch.from_numpy(order), torch.from_numpy(key_s),
            torch.from_numpy(seg_start), torch.from_numpy(masks), want,
            relaxed=relaxed, Q=Q, q_t=q_t)
        d_got = tiled_scan_model(order, key_s, seg_start, masks, got,
                                 relaxed, Q, q_t, tile)
        assert float(want.abs().max()) < 2**24
        np.testing.assert_array_equal(d_got, d_want.numpy(),
                                      err_msg=f"{kind} deltas, call {call}")
        np.testing.assert_array_equal(got, want.numpy(),
                                      err_msg=f"{kind} carry, call {call}")
