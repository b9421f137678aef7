"""Card-only checks of the MoE FFN's grouped dispatch (``models/moe.py``,
``_local_moe(grouped=True)``, chosen by ``grouped_pays``) at
AI21-Jamba2-Mini's widths: d 4,096, experts of 14,336, 8 of 16 held,
top-2, gates not renormalised, bf16. Marked ``gpu``: each test asks the
``cuda`` fixture for the card and skips where there is none. The file
imports torch only, so on the card it runs as

  PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_moe_gpu.py

Tolerance of grouped against padded: both paths round h, u and the
expert output to bf16 at the same points, and only the products'
accumulation order differs (``torch.mm`` over an expert's rows against
``torch.bmm`` over its padded slots), so a rounded value may differ by one
bf16 unit (2^-8 relative) in any of them; 2^-7 of the output's scale
holds two such units, as the CPU tests' bf16 tolerance.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.models import moe as M
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.serving.backends import init_torch_params, make_engine

pytestmark = pytest.mark.gpu

D, F = 4096, 14336
JAMBA = MoEConfig(num_experts=8, top_k=2, d_ff_expert=F,
                  capacity_factor=8.0, router_experts=16,
                  renormalize=False)
GRANITE = MoEConfig(num_experts=32, top_k=8, d_ff_expert=512,
                    capacity_factor=4.0)        # the benchmark's granite
TOL = 2 ** -7


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _weights(moe: MoEConfig, d: int, dev, seed: int):
    """One MoE layer at the port's initialiser's scales: the router fp32
    at 0.02, the experts bf16 at 1/sqrt(d) in and 1/sqrt(F) out."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    E, f = moe.num_experts, moe.d_ff_expert

    def draw(shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(dtype)
    return {"router": draw((d, moe.routed), 0.02, torch.float32),
            "wg": draw((E, d, f), d ** -0.5),
            "wu": draw((E, d, f), d ** -0.5),
            "wd": draw((E, f, d), f ** -0.5)}


@pytest.fixture(scope="module")
def jamba(cuda):
    return _weights(JAMBA, D, cuda, 33)


def _tokens(n: int, d: int, dev, seed: int):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)


def _close(got, want, what):
    scale = max(float(want.float().abs().max()), 1.0)
    err = float((got.float() - want.float()).abs().max())
    print(f"{what}: max abs err {err:.3e} of scale {scale:.3e}")
    assert err <= TOL * scale, f"{what}: {err} (scale {scale})"


def _local(x, p, moe, **kw):
    return M._local_moe(x, p["router"], p["wg"], p["wu"], p["wd"], cfg=moe,
                        e_off=moe.first_expert, **kw)


@pytest.mark.parametrize("T", [512, 1024, 2048])
def test_grouped_matches_padded_at_jamba_widths(cuda, jamba, T):
    """A prompt of T tokens: grouped against padded within TOL, the same
    drops and losses; the grouped call relaunched is bit-equal."""
    x = _tokens(T, D, cuda, T)
    with torch.inference_mode():
        assert M.grouped_pays(x, JAMBA)
        want, want_aux = _local(x, jamba, JAMBA)
        got, got_aux = _local(x, jamba, JAMBA, grouped=True)
        again, _ = _local(x, jamba, JAMBA, grouped=True)
    for k in ("moe_dropped", "moe_aux_loss", "moe_z_loss"):
        assert torch.equal(got_aux[k], want_aux[k]), k
    assert float(got_aux["moe_dropped"]) == 0.0      # dropless: C = T
    _close(got, want, f"grouped vs padded, T = {T}")
    assert torch.equal(got, again)


def test_moe_ffn_counts_its_grouped_calls(cuda, jamba):
    """Through ``moe_ffn``: a 1,024-token prompt takes the grouped
    dispatch (one count a call, its output the grouped call's to the
    bit), a decode-shaped call of 64 tokens the padded one (no count)."""
    x = _tokens(1024, D, cuda, 1)
    step = _tokens(64, D, cuda, 2)
    with torch.inference_mode():
        for _ in range(2):
            before = M.grouped_calls
            y, _ = M.moe_ffn(x[None], jamba, JAMBA)
            assert M.grouped_calls == before + 1
        want = _local(x, jamba, JAMBA, grouped=True)[0]
        assert torch.equal(y[0], want.to(y.dtype))
        before = M.grouped_calls
        y, _ = M.moe_ffn(step[:, None], jamba, JAMBA)
        assert M.grouped_calls == before
        assert torch.equal(y[:, 0], _local(step, jamba, JAMBA)[0].to(
            y.dtype))


def test_a_captured_decode_call_stays_padded(cuda, jamba):
    """A CUDA graph captured over a decode-shaped ``moe_ffn`` (64 slots):
    no grouped call is counted, and the replay on new tokens equals the
    eager call on them."""
    static = _tokens(64, D, cuda, 3)[:, None].clone()
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                M.moe_ffn(static, jamba, JAMBA)
        torch.cuda.current_stream().wait_stream(side)
        before = M.grouped_calls
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = M.moe_ffn(static, jamba, JAMBA)
        assert M.grouped_calls == before
        fresh = _tokens(64, D, cuda, 4)[:, None]
        static.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        want, _ = M.moe_ffn(fresh, jamba, JAMBA)
    assert M.grouped_calls == before
    assert torch.equal(out, want)


def test_a_granite_prompt_stays_padded(cuda):
    """The granite cell's longest prompt (128 tokens, C = T at its
    capacity factor of 4): the padded products are bound by the experts'
    weights, so ``moe_ffn`` keeps the padded path, bit for bit."""
    p = _weights(GRANITE, 1024, cuda, 5)
    x = _tokens(128, 1024, cuda, 6)
    with torch.inference_mode():
        assert not M.grouped_pays(x, GRANITE)
        before = M.grouped_calls
        y, _ = M.moe_ffn(x[None], p, GRANITE)
        assert M.grouped_calls == before
        assert torch.equal(y[0], _local(x, p, GRANITE)[0].to(y.dtype))


def test_a_jamba_engine_counts_one_grouped_call_a_moe_layer(cuda):
    """One period of Jamba's layers at its published widths (8 layers, 4
    of them MoE) served by a prefill and a graphed decode engine: a
    1,024-token prompt counts one grouped call a MoE layer, a 40-token
    prompt and every decode step none."""
    cfg = ModelConfig(
        name="jamba-moe-card", family="hybrid", num_layers=8, d_model=D,
        num_heads=32, num_kv_heads=8, d_ff=F, vocab_size=65536, remat=False,
        dtype="bfloat16", block="jamba", attn_layer_period=8,
        attn_layer_offset=4, expert_layer_period=2, expert_layer_offset=1,
        rope=False, ssm_expand=2, ssm_state=16, ssm_conv=4, ssm_dt_rank=256,
        ssm_conv_bias=True, moe=JAMBA)
    moe_layers = sum(map(cfg.has_experts, range(cfg.num_layers)))
    assert moe_layers == 4
    params = init_torch_params(cfg, 0, device="cuda")
    pre, dec = (make_engine("torch", i, cfg, params, slots=4, capacity=1104,
                            device="cuda") for i in range(2))
    counts = []
    for n in (1024, 40):
        before = M.grouped_calls
        tok, payload = pre.prefill(np.arange(n, dtype=np.int32) % 65536)
        counts.append(M.grouped_calls - before)
    slot = dec.insert(types.SimpleNamespace(), payload)
    before = M.grouped_calls
    for _ in range(6):
        tok = dec.decode_step({slot: tok})[slot]
    torch.cuda.synchronize()
    print(f"jamba-moe-card grouped calls: prefills {counts}, decode steps "
          f"{M.grouped_calls - before}")
    assert counts == [moe_layers, 0]
    assert M.grouped_calls == before
    assert dec.graph_replays == 6
