"""Serving runtime of the port: the paged ``Engine`` on PyTorch, the
analytic-time ``SimEngine``, plus copies of the reference's jax-free
cluster, policies, allocator, streaming metrics and span tracing."""
