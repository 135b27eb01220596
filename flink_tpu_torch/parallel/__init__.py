"""Parallel primitives of the port: the shard mesh (``mesh.py``), its
collectives (``collectives.py``), the keyed record exchange
(``exchange.py``) and the broadcast join's probe on one shard
(``broadcast.py``)."""
