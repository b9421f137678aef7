"""The RWKV-6 WKV recurrence: CUDA kernel (``csrc/``), wrapper (``ops``)
and plain PyTorch versions (``ref``)."""
