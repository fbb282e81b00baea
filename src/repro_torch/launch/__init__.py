"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.storage`` and ``python -m
repro_torch.launch.train`` (the LM substrate's trainer); ``dryrun.py``,
the reference's cells built on a mesh; and ``roofline.py``, the fused
hop's cost model."""
