"""PyTorch/CUDA port of the JOIN-AGG system for one NVIDIA Hopper card.

Mirrors the module layout of the JAX package ``repro`` (which stays the
reference) but imports nothing from it: every module it needs is a
trimmed copy under the same relative path.  The entry point is
:class:`repro_torch.api.Q`; its ``"torch"`` engine picks, per run, the
dense einsum program or the sparse walk whose hops run on hand-written
CUDA kernels (``kernels/``), as the JAX package's engine picks them, and
runs on the CPU only when the caller asks for it with
``TorchChannelEngine(device="cpu")``.
"""
