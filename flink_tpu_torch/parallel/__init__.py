"""Parallel primitives of the port: the shard mesh (``mesh.py``, within one
process or across several), its collectives (``collectives.py``: device
copies within a process, a Gloo group between processes), the keyed
record exchange (``exchange.py``) and the broadcast join over the mesh's
shards (``broadcast.py``)."""
