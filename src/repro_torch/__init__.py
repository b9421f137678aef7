"""PyTorch/CUDA port of the ``repro`` serving system, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
nothing of it (and never ``jax``). It keeps the reference's module and
public function names so each counterpart is easy to find, and its own
copies of the framework-free modules it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card present and no device named they raise rather than fall
back (``repro_torch.device.resolve_device``).
"""
