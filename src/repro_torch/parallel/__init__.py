"""Parallel helpers of the port: gradient compression
(:mod:`.compression`).  Sharding over a device mesh waits for a multi-card
cell (ROADMAP queue 1)."""
