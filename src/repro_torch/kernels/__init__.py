"""Hand-written Hopper kernels, their plain PyTorch versions, the
build/dispatch policy (``ops.py``) and the fused hop's per-card
launch-shape tuning (``autotune.py``)."""
