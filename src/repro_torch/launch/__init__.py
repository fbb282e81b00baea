"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.storage`` and ``python -m
repro_torch.launch.train`` (the LM substrate's trainer); ``python -m
repro_torch.launch.dryrun``, the reference's cells built on a mesh and
counted dry on a fake world (``hlo_analysis.py`` counts a call's ops,
collectives and memory in place of the HLO); and ``python -m
repro_torch.launch.roofline``, the H100 roofline of the dry run's cells
beside the fused hop's cost model."""
