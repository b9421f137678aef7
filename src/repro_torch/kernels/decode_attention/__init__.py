"""Paged split-KV decode attention: CUDA kernel (``csrc/``), wrapper
(``ops``) and plain PyTorch version (``ref``)."""
