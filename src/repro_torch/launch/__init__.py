"""Entry points of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.storage``; and ``roofline.py``, the
fused hop's cost model."""
