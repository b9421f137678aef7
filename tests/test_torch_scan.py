"""The selective-scan kernel's wrapper and its dispatch, on the CPU: on CPU
tensors the wrapper is the plain chunked scan (``ssm._scan``) to the bit
and launches nothing; it refuses shapes that break ``_scan``'s contract;
``impl`` reaches every prompt's scan, so that ``impl="plain"`` and the
training forward run the plain scan. The kernel itself runs on the card
only (``tests/test_torch_scan_gpu.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.selective_scan import ops
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, MoEConfig


def _case(B, S, di, ds, shared, seed=0):
    """fp32 inputs as a mixer passes them: delta > 0 (softplus), A < 0, a
    nonzero state."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    delta = torch.nn.functional.softplus(f(B, S) if shared else f(B, S, di))
    return (f(B, S, di), f(B, S, ds), f(B, S, ds), delta,
            -torch.exp(0.5 * f(di, ds)), f(B, di, ds))


@pytest.mark.parametrize("B,S,di,ds,shared", [
    (1, 1, 8, 16, False),
    (2, 300, 12, 16, False),    # ragged: a padded second chunk
    (3, 257, 8, 4, True),       # hymba's shared delta
])
def test_wrapper_on_cpu_is_the_plain_scan(B, S, di, ds, shared):
    args = _case(B, S, di, ds, shared)
    n0 = ops.selective_scan.launches
    y, h = ops.selective_scan(*args)
    y_p, h_p = ssm._scan(*args)
    assert torch.equal(y, y_p) and torch.equal(h, h_p)
    assert ops.selective_scan.launches == n0


@pytest.mark.parametrize("bad", ["x_rank", "empty", "delta", "B", "C", "A",
                                 "h"])
def test_wrapper_refuses_shapes_off_the_contract(bad):
    x, Bm, Cm, delta, A, h = _case(2, 10, 8, 16, False)
    if bad == "x_rank":
        x = x[0]
    elif bad == "empty":
        x, Bm, Cm, delta = x[:, :0], Bm[:, :0], Cm[:, :0], delta[:, :0]
    elif bad == "delta":
        delta = delta[..., :4]
    elif bad == "B":
        Bm = Bm[..., :8]
    elif bad == "C":
        Cm = Cm[:1]
    elif bad == "A":
        A = A[:4]
    else:
        h = h[..., :8]
    with pytest.raises(ValueError, match="selective_scan"):
        ops.selective_scan(x, Bm, Cm, delta, A, h)


def _jamba() -> ModelConfig:
    # one period of Jamba's layers (attention in layer 4), 8 of 16 experts
    return ModelConfig(
        name="jamba-cpu", family="hybrid", num_layers=8, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=128, remat=False,
        dtype="float32", block="jamba", attn_layer_period=8,
        attn_layer_offset=4, expert_layer_period=2, expert_layer_offset=1,
        rope=False, ssm_expand=2, ssm_dt_rank=4, ssm_conv_bias=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=48,
                      capacity_factor=8.0, router_experts=16,
                      renormalize=False))


class _Impls:
    """Every ``impl`` that reaches ``ssm._prompt_scan``, with the wrapper
    watched: a call into it is recorded too."""

    def __init__(self, monkeypatch):
        self.impls, self.wrapper_calls = [], 0
        scan, wrapper = ssm._prompt_scan, ssm.selective_scan

        def watched_scan(*args, **kw):
            self.impls.append(kw.get("impl", args[-1]))
            return scan(*args, **kw)

        def watched_wrapper(*args):
            self.wrapper_calls += 1
            return wrapper(*args)

        monkeypatch.setattr(ssm, "_prompt_scan", watched_scan)
        monkeypatch.setattr(ssm, "selective_scan", watched_wrapper)


@pytest.mark.parametrize("cfg", [_jamba(), get_smoke_config("hymba-1.5b")],
                         ids=["jamba", "hymba"])
def test_impl_reaches_every_prompt_scan(cfg, monkeypatch):
    """``prefill_full`` hands its ``impl`` to each SSM layer's scan, once a
    layer; ``impl="plain"`` never calls the kernel's wrapper. On the CPU
    both give the same logits and states to the bit."""
    params = T.init_params(cfg, 0, device="cpu")
    tokens = {"tokens": torch.arange(40).reshape(2, 20) % cfg.vocab_size}
    n_ssm = sum("ssm" in p for p in params["blocks"])
    out = {}
    for impl in ("plain", "kernel"):
        seen = _Impls(monkeypatch)
        with torch.inference_mode():
            out[impl] = T.prefill_full(params, cfg, tokens, impl=impl)
        assert seen.impls == [impl] * n_ssm
        assert seen.wrapper_calls == 0      # the kernel's only on the card
        monkeypatch.undo()
    (lp, cp), (lk, ck) = out["plain"], out["kernel"]
    assert torch.equal(lp, lk)
    assert torch.equal(cp["ssm_h"], ck["ssm_h"])


def test_training_forward_runs_the_plain_scan(monkeypatch):
    """The training forward (no kernel has a backward) asks every hybrid
    layer's scan for the plain version."""
    cfg = get_smoke_config("hymba-1.5b")
    params = T.init_params(cfg, 0, device="cpu")
    seen = _Impls(monkeypatch)
    tokens = torch.arange(32).reshape(2, 16) % cfg.vocab_size
    T.train_loss(params, cfg, {"tokens": tokens, "labels": tokens})
    assert seen.impls == ["plain"] * cfg.num_layers
    assert seen.wrapper_calls == 0
