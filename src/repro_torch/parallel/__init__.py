"""Parallel helpers of the port: the reference's sharding rules over a
device mesh and training on them (:mod:`.sharding`), gradient compression
(:mod:`.compression`)."""
