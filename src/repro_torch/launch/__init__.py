"""Launchers of the port: one-card training (:mod:`.train`)."""
