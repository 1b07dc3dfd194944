"""PyTorch + CUDA port of the in-place zero-space memory protection system.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and numpy only, keeps the reference's module and public function
names so each counterpart is easy to find, and runs its hot path through
CUDA kernels written for Hopper (``csrc/``, built at first use).

Every entry point takes ``device=`` and defaults to ``"cuda"``; it raises
when no GPU is present unless the caller asks for ``"cpu"``.
"""
