"""Engine construction behind one switch: ``make_engine(backend=...)``.

The serving runtime is backend-agnostic — ``Cluster`` and every policy
drive whatever implements the engine surface. The port has one backend so
far, ``"torch"`` (the PyTorch ``Engine``); the analytic-time ``"sim"``
backend comes with a later slice.
"""
from __future__ import annotations

from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("torch",)


def make_engine(backend: str, engine_id: int, cfg, params=None, **kw):
    """Build one engine of the requested backend. ``"torch"`` needs
    ``params`` (from ``init_torch_params`` or ``convert.from_reference``);
    keywords — ``slots``, ``capacity``, ``chip``, ``block_size``,
    ``paged`` (False: the dense layout), ``pool_blocks``, ``chunk_size``
    (non-zero: a ``PrefixCache``), ``device``, ... — go to ``Engine``. The
    device defaults to ``cuda``, and with no card present that raises."""
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    from repro_torch.serving.engine import Engine
    if params is None:
        raise ValueError("backend='torch' requires model params")
    kw.pop("calibration", None)         # sim-only knob
    return Engine(engine_id, cfg, params, **kw)


def init_torch_params(cfg, seed: int = 0, *, device: DeviceLike = None):
    """Random params for the torch backend, on ``device`` (default
    ``cuda``): one copy, shared by every engine of the process."""
    from repro_torch.models import transformer as T
    return T.init_params(cfg, seed, device=resolve_device(device))
