"""PyTorch/CUDA port of the JOIN-AGG system for one NVIDIA Hopper card.

Mirrors the module layout of the JAX package ``repro`` (which stays the
reference) but imports nothing from it: every module it needs is a
trimmed copy under the same relative path.  The entry point is
:class:`repro_torch.api.Q`; its ``"torch"`` engine runs every
decomposition-tree hop on hand-written CUDA kernels
(``kernels/segment_sum.py``, ``kernels/coo_spmm.py``,
``kernels/segment_reduce.py``) and runs on the CPU only when the caller
asks for it with ``TorchChannelEngine(device="cpu")``.
"""
