"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the dispatching entry points (``ops``)."""
