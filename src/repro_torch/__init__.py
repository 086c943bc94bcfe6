"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

Mirrors ``repro``'s subpackages (``kernels``, ``models``, ``configs``,
``core``, ``data``, ``serving``, ``launch``). It imports PyTorch, numpy and
the standard library only; the JAX package stays the reference it is tested
against.
"""
