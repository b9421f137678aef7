"""Split-KV decode attention over a dense cache and over a paged block
pool: CUDA kernels (``csrc/``), wrappers (``ops``) and plain PyTorch
versions (``ref``)."""
