"""Card-only checks of the selective-scan kernel against a float64
sequential oracle and its plain version (``ssm._scan``), at Jamba's and
hymba's prompt shapes, its edges and refusals, and its launch count in a
Jamba prefill. Marked ``gpu``: each test asks the ``cuda`` fixture for the
card and skips where there is none. The file imports torch only, so on a
machine with a card and no jax it runs as

  PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_scan_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.selective_scan import ops
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, MoEConfig

pytestmark = pytest.mark.gpu

# The kernel and the plain scan both compute in fp32 and differ from the
# float64 recurrence only by rounding (the kernel composes 16-position
# segments by a scan of 8, the plain version 256-position chunks by
# doubling). The kernel may be no farther from float64 than twice the
# plain version, or than this floor, relative to each row's norm.
RTOL_FLOOR = 1e-5
JAMBA_DI, HYMBA_DI, DS = 8192, 1600, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, B, S, di, shared=False, delta_scale=None, seed=0):
    """fp32 inputs as a mixer passes them: delta = softplus of a dt around
    Mamba's init (~0.1), or ``delta_scale`` everywhere; A = -(1..16) per
    channel, perturbed; B and C of unit scale (RMS-normed); a nonzero
    state."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def f(*shape):
        return torch.randn(shape, generator=g, device=dev)

    dshape = (B, S) if shared else (B, S, di)
    delta = (torch.nn.functional.softplus(f(*dshape) - 2.5)
             if delta_scale is None
             else torch.full(dshape, float(delta_scale), device=dev))
    A = -torch.exp(torch.log(torch.arange(1, DS + 1, device=dev)
                             .float())[None] + 0.1 * f(di, DS))
    return f(B, S, di), f(B, S, DS), f(B, S, DS), delta, A, 0.5 * f(B, di, DS)


def _oracle(x, Bm, Cm, delta, A, h):
    """The recurrence one position at a time, in float64."""
    x, Bm, Cm, delta, A, h = (t.double() for t in (x, Bm, Cm, delta, A, h))
    if delta.dim() == 2:
        delta = delta[..., None].expand_as(x)
    ys = []
    for t in range(x.shape[1]):
        d = delta[:, t, :, None]
        h = torch.exp(d * A) * h + (d * x[:, t, :, None]) * Bm[:, t, None]
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
    return torch.stack(ys, 1), h


def _row_err(out, ref):
    """The largest error relative to its row's norm, over the last dim."""
    diff = (out.double() - ref).norm(dim=-1)
    return (diff / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


def _held(case, what):
    n0 = ops.selective_scan.launches
    y, h = ops.selective_scan(*case)
    torch.cuda.synchronize()
    assert ops.selective_scan.launches == n0 + 1
    y_p, h_p = ssm._scan(*case)
    y_o, h_o = _oracle(*case)
    errs = {"y": (_row_err(y, y_o), _row_err(y_p, y_o)),
            "h": (_row_err(h, h_o), _row_err(h_p, h_o))}
    print(f"{what}: kernel / plain error against float64 {errs}")
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    for name, (ek, ep) in errs.items():
        assert ek <= max(2 * ep, RTOL_FLOOR), (name, ek, ep)


@pytest.mark.parametrize("B,S", [(1, 512), (1, 1000), (1, 2048), (3, 512),
                                 (3, 1000)])
def test_kernel_at_jamba_width(cuda, B, S):
    """Jamba's per-channel delta at di 8,192: prompts of the cell's range,
    one ragged (no multiple of the 128-position tile or the plain scan's
    256-position chunk), one and three sequences."""
    _held(_case(cuda, B, S, JAMBA_DI), f"jamba B={B} S={S}")


@pytest.mark.parametrize("B,S", [(1, 512), (2, 1100)])
def test_kernel_at_hymba_width_with_a_shared_delta(cuda, B, S):
    """hymba's one delta channel [B,S], read with channel stride 0, at di
    1,600 (50 CTAs of 32 channels)."""
    _held(_case(cuda, B, S, HYMBA_DI, shared=True), f"hymba B={B} S={S}")


@pytest.mark.parametrize("B,S,di,shared,delta", [
    (1, 300, JAMBA_DI, False, 30.0),    # near-total decay: a ~ exp(-30)
    (2, 1, JAMBA_DI, False, None),      # one position
    (3, 1, HYMBA_DI, True, None),
    (2, 77, 36, False, None),           # di no multiple of a CTA's 32
])
def test_kernel_edges(cuda, B, S, di, shared, delta):
    _held(_case(cuda, B, S, di, shared, delta_scale=delta),
          f"edge B={B} S={S} di={di} delta={delta}")


def test_kernel_refuses_what_it_does_not_take(cuda):
    case = _case(cuda, 1, 64, 64)
    x, Bm, Cm, delta, A, h = case
    n0 = ops.selective_scan.launches
    with pytest.raises(ValueError, match="float32"):
        ops.selective_scan(x.bfloat16(), Bm, Cm, delta, A, h)
    with pytest.raises(ValueError, match="contiguous"):
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        ops.selective_scan(xt, Bm, Cm, delta, A, h)
    with pytest.raises(ValueError, match="state size 8"):
        ops.selective_scan(x, Bm[..., :8].contiguous(),
                           Cm[..., :8].contiguous(), delta,
                           A[:, :8].contiguous(), h[..., :8].contiguous())
    with pytest.raises(ValueError, match="on cpu"):
        ops.selective_scan(x, Bm, Cm, delta, A.cpu(), h)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.selective_scan(*_case(cuda, 1, 8, 6))
    with pytest.raises(ValueError, match="16 bytes"):
        flat = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x)
        flat.copy_(x)
        ops.selective_scan(flat, Bm, Cm, delta, A, h)
    assert ops.selective_scan.launches == n0


def _jamba() -> ModelConfig:
    # one period of Jamba's layers at head size 64, 8 of 16 experts; bf16
    return ModelConfig(
        name="jamba-card", family="hybrid", num_layers=8, d_model=256,
        num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=160, remat=False,
        dtype="bfloat16", block="jamba", attn_layer_period=8,
        attn_layer_offset=4, expert_layer_period=2, expert_layer_offset=1,
        rope=False, ssm_expand=2, ssm_dt_rank=16, ssm_conv_bias=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128,
                      capacity_factor=8.0, router_experts=16,
                      renormalize=False))


def test_a_jamba_prefill_launches_once_a_mamba_layer(cuda):
    """``prefill_full(impl="kernel")`` runs the kernel exactly once per
    Mamba-1 layer; ``impl="plain"`` not at all, and the two states agree
    within the kernel's rounding."""
    cfg = _jamba()
    params = T.init_params(cfg, 0, device=cuda)
    tokens = {"tokens": torch.arange(600, device=cuda)[None] % 160}
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain"):
            n0 = ops.selective_scan.launches
            out[impl] = T.prefill_full(params, cfg, tokens, impl=impl)
            torch.cuda.synchronize()
            out[impl] += (ops.selective_scan.launches - n0,)
    assert out["kernel"][2] == len(cfg.mamba_layer_ids) == 7
    assert out["plain"][2] == 0
    hk, hp = out["kernel"][1]["ssm_h"][0], out["plain"][1]["ssm_h"][0]
    assert _row_err(hk, hp.double()) < 1e-4
