"""Kernel wrappers of the port, one module per TPU kernel it replaces.

Each wrapper launches its CUDA kernel (``csrc/``) for a tensor on the card
and raises on what the kernel does not take; for a tensor on the CPU it
runs the plain PyTorch version kept in the same module. Nothing falls
back: a CUDA tensor either reaches the kernel or raises.
"""
