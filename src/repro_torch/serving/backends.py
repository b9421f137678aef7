"""Engine construction behind one switch: ``make_engine(backend=...)``.

The serving runtime is backend-agnostic — ``Cluster`` and every policy
drive whatever implements the engine surface — so the choice between the
PyTorch ``Engine`` (``"torch"``) and the analytic-time ``SimEngine``
(``"sim"``, ``serving/simengine.py``) is a construction-time flag,
threaded through ``launch/serve.py --backend``. Imports are lazy per
backend: asking for ``"sim"`` never imports torch.
"""
from __future__ import annotations

BACKENDS = ("torch", "sim")


def make_engine(backend: str, engine_id: int, cfg, params=None, **kw):
    """Build one engine of the requested backend.

    ``"torch"`` needs ``params`` (from ``init_torch_params`` or
    ``convert.from_reference``); keywords — ``slots``, ``capacity``,
    ``chip``, ``block_size``, ``paged`` (False: the dense layout),
    ``pool_blocks``, ``chunk_size`` (non-zero: a ``PrefixCache``),
    ``device``, ... — go to ``Engine``, whose device defaults to ``cuda``
    and raises with no card present. ``"sim"`` ignores ``params``, drops
    the torch-only knobs (``paged``, ``pool_blocks``, ``device``) and
    additionally accepts ``calibration=`` (a ``simengine.SimCalibration``).
    """
    if backend == "sim":
        from repro_torch.serving.simengine import SimEngine
        for k in ("paged", "pool_blocks", "device"):    # torch-only knobs
            kw.pop(k, None)                             # (block_size is shared)
        return SimEngine(engine_id, cfg, params, **kw)
    if backend == "torch":
        from repro_torch.serving.engine import Engine
        if params is None:
            raise ValueError("backend='torch' requires model params "
                             "(backend='sim' runs without them)")
        kw.pop("calibration", None)     # sim-only knob
        return Engine(engine_id, cfg, params, **kw)
    raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")


def init_torch_params(cfg, seed: int = 0, *, device=None):
    """Random params for the torch backend, on ``device`` (default
    ``cuda``): one copy, shared by every engine of the process. torch is
    imported here, not at the caller's module load, so sim-only
    invocations never pay for it."""
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    return T.init_params(cfg, seed, device=resolve_device(device))
