"""Hand-written Hopper kernels, their plain PyTorch versions and the
build/dispatch policy (``ops.py``)."""
