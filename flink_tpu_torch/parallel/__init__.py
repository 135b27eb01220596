"""Parallel primitives of the port: today the broadcast join's probe on
one shard (``broadcast.py``). The mesh, the exchange and the sharded
steps wait for a process group (ROADMAP queue 1, items 10 and 12)."""
