"""No silently ignored key under ``pipeline.``, ``controller.`` and
``observability.doctor``: each of the 34 options the port's
``core/config.py`` declares there falls in one of three classes, and its
case names the class —

* ``read``: a port module other than the config reads it (its key or its
  ``CoreOptions`` name appears there);
* ``refused``: set to a non-default value it raises, naming its ROADMAP
  item (or, first, the reference's own error);
* ``guarded``: the reference reads it only on a path the port refuses
  as a whole; the case names and exercises that refusal.
"""

import importlib.util
import pathlib

import pytest

from test_torch_ingest import build_env, run_job

from flink_tpu_torch.core.config import ConfigOption, CoreOptions

PORT = pathlib.Path(__file__).resolve().parents[1] / "flink_tpu_torch"
PREFIXES = ("pipeline.", "controller.", "observability.doctor")

REFUSED = {"pipeline.data-parallel"}
GUARDED = {
    # the sharded drain's ring-slice rows: behind pipeline.data-parallel
    # on and parallelism above 1, both refused (item 10)
    "pipeline.shard-capacity-factor": "sharded",
    # the cluster's control-plane RPC (the reference's cli.py and
    # process cluster): the port runs jobs in-process and has no control
    # plane (item 15)
    "controller.rpc.port": "control-plane",
    "controller.bind-host": "control-plane",
}


def _options():
    return {v.key: (name, v) for name, v in vars(CoreOptions).items()
            if isinstance(v, ConfigOption) and v.key.startswith(PREFIXES)}


def _port_sources() -> str:
    return "\n".join(p.read_text() for p in PORT.rglob("*.py")
                     if p.name != "config.py")


def test_the_area_has_34_options():
    assert len(_options()) == 34
    assert REFUSED | set(GUARDED) <= set(_options())


@pytest.mark.parametrize("key", sorted(_options()))
def test_no_key_is_silently_ignored(key):
    name, opt = _options()[key]
    if key in REFUSED:
        # pipeline.data-parallel: on — the reference's error without the
        # resident loop, and the sharded drain (item 10) with it
        with pytest.raises(ValueError) as got:
            run_job(build_env(**{key: "on"}), 512)
        with pytest.raises(ValueError) as want:
            run_job(build_env(pkg="jax", **{key: "on"}), 512, pkg="jax")
        assert str(got.value) == str(want.value)
        with pytest.raises(NotImplementedError, match="item 10"):
            run_job(build_env(**{key: "on",
                                 "pipeline.resident-loop": "on"}), 512)
    elif GUARDED.get(key) == "sharded":
        with pytest.raises(NotImplementedError, match="item 10"):
            run_job(build_env(**{"pipeline.data-parallel": "on",
                                 "pipeline.resident-loop": "on"}), 512)
        env = build_env()
        env.set_parallelism(2)
        with pytest.raises(NotImplementedError, match="item 10"):
            run_job(env, 512)
    elif GUARDED.get(key) == "control-plane":
        assert importlib.util.find_spec("flink_tpu_torch.cli") is None
        assert importlib.util.find_spec(
            "flink_tpu_torch.runtime.process_cluster") is None
        with pytest.raises(NotImplementedError, match="item 15"):
            build_env().query_state("job", "state", 1)
    else:
        src = _port_sources()
        assert f'"{key}"' in src or f"CoreOptions.{name}" in src, \
            f"{key} ({name}) is read by no port module"
