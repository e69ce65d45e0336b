"""The standalone FV3 kernels of the port and their plain versions; the
public entry point is :mod:`.ops`."""
