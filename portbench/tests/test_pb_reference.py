"""The decoder's plain fp32 reference (``archs/decoder.py``) against the
port on its smoke configurations on the CPU, and the benchmark's weights
in the port's layout."""
import pytest
import torch

import pb_smoke_root
from pbench import spec, weights
from pbench.cell import model_config
from pbench.reference import fp8_quant
from repro_torch.models import transformer as T

DECODER = spec.arch("decoder")
Reference = DECODER.Reference


def draw(p, seed):
    return weights.draw(p, seed, "cpu", DECODER.layout(p))


def as_fp32(tree):
    if isinstance(tree, torch.Tensor):
        return tree.float()
    if isinstance(tree, dict):
        return {k: as_fp32(v) for k, v in tree.items()}
    return [as_fp32(v) for v in tree]


def shapes(tree):
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return [shapes(v) for v in tree]


@pytest.mark.parametrize("p", [pb_smoke_root.DENSE, pb_smoke_root.MOE],
                         ids=["dense", "moe"])
def test_weights_in_the_port_layout(p):
    params = draw(p, 11)
    assert shapes(params) == shapes(T.abstract_params(model_config(p)))
    again = draw(p, 11)
    other = draw(p, 12)
    assert torch.equal(params["embed"], again["embed"])
    assert not torch.equal(params["embed"], other["embed"])
    wq = params["blocks"][1]["wq"].float()
    assert wq.std().item() == pytest.approx(p["d_model"] ** -0.5, rel=0.1)


@pytest.mark.parametrize("p", [pb_smoke_root.DENSE, pb_smoke_root.MOE],
                         ids=["dense", "moe"])
def test_reference_matches_the_port_in_fp32(p):
    params = draw(p, 5)
    cfg = model_config(dict(p, dtype="float32"))
    port_params = as_fp32(params)
    seq = torch.randint(0, p["vocab_size"], (21,),
                        generator=torch.Generator().manual_seed(0))
    n = 6
    ref = Reference(p, params).logits([seq], [n])[0]
    assert ref.shape == (n, p["vocab_size"])
    for i in range(n):
        S = len(seq) - n + 1 + i
        got, _ = T.prefill_full(port_params, cfg, {"tokens": seq[None, :S]},
                                impl="plain")
        torch.testing.assert_close(ref[i], got[0, :p["vocab_size"]],
                                   rtol=1e-4, atol=1e-4)


def test_control_is_a_lower_precision():
    p = pb_smoke_root.DENSE
    params = draw(p, 5)
    seq = torch.randint(0, p["vocab_size"], (30,),
                        generator=torch.Generator().manual_seed(1))
    ref = Reference(p, params).logits([seq], [10])[0]
    low = Reference(p, params, quant=fp8_quant).logits([seq], [10])[0]
    err = (low - ref).abs().max().item()
    scale = ref.std().item()
    assert 1e-3 * scale < err < scale
