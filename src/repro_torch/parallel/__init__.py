"""Parallel helpers of the port: the reference's sharding rules over a
device mesh and training and serving on them (:mod:`.sharding`), gradient
compression (:mod:`.compression`), the record of the collectives the port
issues (:mod:`.collectives`)."""
