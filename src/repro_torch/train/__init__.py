"""The LM substrate's training pieces: AdamW (``optimizer.py``), the
deterministic data pipeline (``pipeline.py``), checkpoints in the
reference's layout (``checkpoint.py``) and the fault-tolerance helpers
(``fault_tolerance.py``)."""
