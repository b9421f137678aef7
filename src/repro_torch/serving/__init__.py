"""Serving runtime of the port: the paged ``Engine`` on PyTorch plus copies
of the reference's jax-free cluster, policies and allocator."""
