"""Causal GQA flash attention: CUDA kernel (``csrc/``), wrapper (``ops``)
and plain PyTorch version (``ref``)."""
