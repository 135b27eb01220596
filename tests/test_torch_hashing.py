"""Key hashing and key-group assignment of flink_tpu_torch (the plain
versions behind kernel G1) against flink_tpu's jnp versions and numpy, bit
for bit. torch has no uint32 shifts or remainders on the CPU, so the port
carries each 32-bit word in an int64 masked to 32 bits."""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.core import keygroups as kg_ref
from flink_tpu.ops import hashing as hash_ref
from flink_tpu_torch.core import keygroups as kg_port
from flink_tpu_torch.ops import hashing as hash_port

EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)


def _words(seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([w, EDGES])


def _port(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.astype(np.int64))


def _as_u32(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    assert a.min() >= 0 and a.max() <= 0xFFFFFFFF
    return a.astype(np.uint32)


def test_route_hash_matches_reference():
    hi, lo = _words(1), _words(2)
    want_np = hash_ref.route_hash(hi, lo, np)
    want_jnp = np.asarray(hash_ref.route_hash(jnp.asarray(hi),
                                              jnp.asarray(lo), jnp))
    # the port takes the halves as int32 bits, as its kernels do
    got = _as_u32(hash_port.route_hash(
        torch.from_numpy(hi.view(np.int32)), torch.from_numpy(lo.view(np.int32))))
    np.testing.assert_array_equal(got, want_np)
    np.testing.assert_array_equal(got, want_jnp)
    np.testing.assert_array_equal(hash_port.route_hash(hi, lo), want_np)


def test_murmur3_32_matches_reference():
    w = _words(3)
    want_np = kg_ref.murmur3_32(w, np)
    want_jnp = np.asarray(kg_ref.murmur3_32(jnp.asarray(w), jnp))
    got = _as_u32(kg_port.murmur3_32(_port(w)))
    np.testing.assert_array_equal(got, want_np)
    np.testing.assert_array_equal(got, want_jnp)
    np.testing.assert_array_equal(kg_port.murmur3_32(w), want_np)


@pytest.mark.parametrize("maxp", [1, 7, 128, 32768])
def test_assign_to_key_group_matches_reference(maxp):
    w = _words(4 + maxp)
    want_np = kg_ref.assign_to_key_group(w, maxp, np)
    want_jnp = np.asarray(kg_ref.assign_to_key_group(jnp.asarray(w), maxp,
                                                     jnp))
    got = kg_port.assign_to_key_group(_port(w), maxp).numpy()
    np.testing.assert_array_equal(got, want_np.astype(np.int64))
    np.testing.assert_array_equal(got, want_jnp.astype(np.int64))
    assert got.min() >= 0 and got.max() < maxp


def test_key_identity64_is_the_reference_copy():
    keys = np.array([0, 1, 2**31, 2**40 + 5, -1, -(2**63)], np.int64)
    np.testing.assert_array_equal(hash_port.key_identity64(keys),
                                  hash_ref.key_identity64(keys))
    objs = ["a", "bb", b"c", 3.5]
    np.testing.assert_array_equal(hash_port.hash64_host(objs),
                                  hash_ref.hash64_host(objs))
