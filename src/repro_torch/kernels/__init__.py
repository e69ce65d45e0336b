"""The standalone kernels of the port (the FV3 ones and those of the LM
serving path) and their plain versions; the public entry point is
:mod:`.ops`."""
