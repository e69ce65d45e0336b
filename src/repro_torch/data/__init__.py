"""The port's data pipeline (:mod:`.pipeline`), as the reference's."""
