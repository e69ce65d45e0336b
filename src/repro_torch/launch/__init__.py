"""Launchers of the port: training on one card or across ranks
(:mod:`.train`) and the production meshes (:mod:`.mesh`)."""
