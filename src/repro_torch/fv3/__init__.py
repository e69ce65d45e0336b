"""The FV3-lite dynamical core on the PyTorch/CUDA port."""
