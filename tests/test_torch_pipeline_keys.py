"""No silently ignored key under ``pipeline.``, ``controller.`` and
``observability.doctor``: each of the 34 options the port's
``core/config.py`` declares there, and the two ``exchange.`` options of
the shard mesh, falls in one of two classes, and its case names the
class —

* ``read``: a port module other than the config reads it (its key or its
  ``CoreOptions`` name appears there);
* ``guarded``: the reference reads it only on a path the port refuses
  as a whole; the case names and exercises that refusal.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import importlib.util
import pathlib

import pytest

from test_torch_ingest import build_env

from flink_tpu_torch.core.config import ConfigOption, CoreOptions

PORT = pathlib.Path(__file__).resolve().parents[1] / "flink_tpu_torch"
PREFIXES = ("pipeline.", "controller.", "observability.doctor")

# no key of the area is refused: pipeline.data-parallel and
# pipeline.shard-capacity-factor are read (the sharded drain and its
# per-shard rings)
# the shard mesh's exchange knobs, outside the three prefixes, read too
MESH_KEYS = ("exchange.mode", "exchange.capacity-factor")
GUARDED = {
    # the cluster's control-plane RPC (the reference's cli.py and
    # process cluster): the port runs jobs in-process and has no control
    # plane (item 15)
    "controller.rpc.port": "control-plane",
    "controller.bind-host": "control-plane",
}


def _options():
    return {v.key: (name, v) for name, v in vars(CoreOptions).items()
            if isinstance(v, ConfigOption) and v.key.startswith(PREFIXES)}


def _walk():
    """The area's options and the mesh's exchange options."""
    return {v.key: (name, v) for name, v in vars(CoreOptions).items()
            if isinstance(v, ConfigOption)
            and (v.key.startswith(PREFIXES) or v.key in MESH_KEYS)}


def _port_sources() -> str:
    return "\n".join(p.read_text() for p in PORT.rglob("*.py")
                     if p.name != "config.py")


def test_the_area_has_34_options():
    assert len(_options()) == 34
    assert set(GUARDED) <= set(_options())


@pytest.mark.parametrize("key", sorted(_walk()))
def test_no_key_is_silently_ignored(key):
    name, opt = _walk()[key]
    if GUARDED.get(key) == "control-plane":
        assert importlib.util.find_spec("flink_tpu_torch.cli") is None
        assert importlib.util.find_spec(
            "flink_tpu_torch.runtime.process_cluster") is None
        with pytest.raises(NotImplementedError, match="item 15"):
            build_env().query_state("job", "state", 1)
    else:
        src = _port_sources()
        assert f'"{key}"' in src or f"CoreOptions.{name}" in src, \
            f"{key} ({name}) is read by no port module"
