"""Architectures as files: ``archs/<arch>.py``, named by a configuration's
``arch`` and found by ``spec.arch``. The decoder draws and references the
smoke models exactly as the benchmark did before it moved there; a new
architecture is drawn, referenced and counted by the metric readers from
its own file alone; an unknown one is refused."""
import hashlib
import json
import time

import pytest
import torch

import pb_smoke_root
from pbench import cell, counts, spec, weights
from pbench.cell import RunData
from pbench.reference import fp8_quant
from pbench.trace import TraceData

DECODER = spec.arch("decoder")

# recorded from the benchmark as it was before the decoder moved to
# archs/decoder.py (weights.layout, weights.draw, reference.Reference), at
# seed 11 on the CPU: the drawn weights' SHA-256 digests (bit for bit), and
# each of the reference's fp32 logit rows' norm and its product with a
# fixed unit vector (to 1e-6 of the row's norm: another CPU's BLAS may sum
# in another order)
DIGESTS = {
    "dense":
        "253842bf8f6d31e35551408e8fc36182789ebfd223519afe2cda2074d4e17d30",
    "moe":
        "4cdfc709fead7eeb74fb4a057be32bfcf74ce5022d6377284ec1a1a5a947db5a",
}
LOGIT_ROWS = {
    "dense": [(9.27085833, 1.43481391), (9.59976322, -0.790285209),
              (8.04950283, -0.74578924), (9.31585728, -1.45268812),
              (10.6508589, -0.691514882), (9.07835895, 1.49391881),
              (9.2726999, 0.585314114), (9.58057148, 0.390451916),
              (9.21903398, -0.672506351)],
    "moe": [(1.62357023, 0.0918873503), (1.56905213, -0.0669938644),
            (1.43628323, 0.0420751665), (1.49393262, 0.0620395944),
            (1.62162043, 0.0178547214), (1.56179705, 0.14640825),
            (1.49072398, -0.114934466), (1.6194165, 0.300313101),
            (1.42825257, 0.104942167)],
}
MODELS = {"dense": pb_smoke_root.DENSE, "moe": pb_smoke_root.MOE}


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def weights_digest(p, params):
    """Every leaf in draw order: its path, dtype and bytes."""
    h = hashlib.sha256()
    for path, _, _ in DECODER.layout(p):
        t = leaf(params, path)
        h.update(repr(path).encode() + str(t.dtype).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def logit_rows(p, params):
    """The reference's fp32 logits of two sequences (21 and 9 tokens) at
    their last 6 and 3 positions: each row's norm and its product with the
    unit vector along cos(0), cos(1), ..., in float64."""
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, p["vocab_size"], (n,), generator=g)
            for n in (21, 9)]
    x = torch.cat(DECODER.Reference(p, params).logits(seqs, [6, 3]))
    x = x.double()
    w = torch.cos(torch.arange(x.shape[1], dtype=torch.float64))
    return x.norm(dim=1), x @ (w / w.norm())


@pytest.mark.parametrize("what", ["weights", "logits"])
@pytest.mark.parametrize("model", list(MODELS))
def test_decoder_is_what_the_benchmark_drew_and_referenced(what, model):
    p = MODELS[model]
    params = weights.draw(p, 11, "cpu", DECODER.layout(p))
    if what == "weights":
        assert weights_digest(p, params) == DIGESTS[model]
        return
    norm, dot = logit_rows(p, params)
    want = torch.tensor(LOGIT_ROWS[model], dtype=torch.float64)
    tol = 1e-6 * want[:, 0]
    assert ((norm - want[:, 0]).abs() <= tol).all(), norm
    assert ((dot - want[:, 1]).abs() <= tol).all(), dot


def test_configs_without_arch_are_decoders():
    """Each configuration resolves to the module its ``arch`` names, and
    one that names none to the decoder, whose attention runs in every
    layer."""
    b = spec.load()
    for c in b["configs"]:
        config = spec.read_json(spec.ROOT / c["file"])
        a = spec.config_arch(config)
        assert a.__file__ == str(spec.arch_file(config.get("arch",
                                                           "decoder")))
        if "arch" not in config:
            assert a.__file__ == DECODER.__file__
            assert (a.attn_layers(config["port"])
                    == config["port"]["num_layers"])


# A toy architecture: attention (no position encoding) in the even layers
# only, a ReLU MLP in every layer scaled by a per-layer gain of its own
# init, an untied head.
TOY = '''
import math
import torch
from pbench import counts
from pbench.reference import f32, full_fp32


def gain(shape, gen):
    return torch.linspace(0.5, 1.5, shape[0], device=gen.device)


def layout(p):
    D, L, V, Fd = p["d_model"], p["num_layers"], p["vocab_size"], p["d_ff"]
    H, Hkv = p["num_heads"], p["num_kv_heads"]
    dh = D // H
    out = [(("embed",), (V, D), "embed"), (("lm_head",), (D, V), "in")]
    for i in range(L):
        b = ("blocks", i)
        if i % 2 == 0:
            out += [(b + ("wq",), (D, H, dh), "in"),
                    (b + ("wk",), (D, Hkv, dh), "in"),
                    (b + ("wv",), (D, Hkv, dh), "in"),
                    (b + ("wo",), (H, dh, D), "out")]
        out += [(b + ("gain",), (D,), gain), (b + ("w1",), (D, Fd), "in"),
                (b + ("w2",), (Fd, D), "out")]
    return out


class Reference:
    def __init__(self, p, params, quant=None):
        self.p, self.params, self.quant = p, params, quant

    def linear(self, x, w):
        if self.quant is not None:
            x, w = self.quant(x, w)
        return x @ w.to(f32)

    def attention(self, x, w):
        S, D = x.shape
        H, Hkv = self.p["num_heads"], self.p["num_kv_heads"]
        dh = D // H
        q = self.linear(x, w["wq"].reshape(D, -1)).view(S, H, dh)
        k = self.linear(x, w["wk"].reshape(D, -1)).view(S, Hkv, dh)
        v = self.linear(x, w["wv"].reshape(D, -1)).view(S, Hkv, dh)
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
        return self.linear(o.reshape(S, D), w["wo"].reshape(D, D))

    @torch.no_grad()
    def logits(self, seqs, n_last):
        P = self.params
        with full_fp32():
            out = []
            for s, n in zip(seqs, n_last):
                x = P["embed"][s.long()].to(f32)
                for w in P["blocks"]:
                    if "wq" in w:
                        x = x + self.attention(x, w)
                    h = torch.relu(self.linear(x, w["w1"]))
                    x = x + self.linear(h, w["w2"]) * w["gain"].to(f32)
                out.append(self.linear(x[-n:], P["lm_head"]))
            return out


def attn_layers(p):
    return (p["num_layers"] + 1) // 2


def _weights(p):
    d = counts.dims(p)
    attn = 2 * d["D"] * d["dh"] * (d["H"] + d["Hkv"])
    return attn_layers(p) * attn + d["L"] * 2 * d["D"] * p["d_ff"]


def prefill_flops(p, S):
    return (2.0 * S * _weights(p) + 2.0 * p["d_model"] * p["vocab_size"]
            + attn_layers(p) * counts.attn_prefill_flops(p, S))


def decode_flops(p, active, ctx_sum):
    return (2.0 * active * (_weights(p) + p["d_model"] * p["vocab_size"])
            + attn_layers(p) * counts.attn_decode_flops(p, ctx_sum))
'''
TOY_P = dict(pb_smoke_root.DENSE, name="toy-smoke", num_layers=4)


def test_a_new_architecture_is_only_new_files(tmp_path):
    """The toy is drawn, referenced and counted by ``model.mfu`` and
    ``attn_decode_roofline`` from ``archs/toy.py`` and its configuration,
    with nothing of the benchmark's own files touched."""
    before = pb_smoke_root.folder_digest(pb_smoke_root.PORTBENCH)
    root = pb_smoke_root.make(tmp_path)
    pb = root / "portbench"
    (pb / "archs" / "toy.py").write_text(TOY)
    pb_smoke_root.write(pb / "configs" / "toy-smoke.json",
                        {"arch": "toy", "port": TOY_P})
    config = spec.read_json(pb / "configs" / "toy-smoke.json")
    toy = spec.config_arch(config, root)
    p = config["port"]
    assert toy.attn_layers(p) == 2

    params = weights.draw(p, 3, "cpu", toy.layout(p))
    blocks = params["blocks"]
    assert "wq" in blocks[0] and "wq" not in blocks[1]
    assert torch.equal(blocks[3]["gain"],
                       torch.linspace(0.5, 1.5, p["d_model"]))
    assert blocks[0]["w1"].dtype == torch.bfloat16
    seq = torch.randint(0, p["vocab_size"], (12,),
                        generator=torch.Generator().manual_seed(0))
    ref = toy.Reference(p, params).logits([seq], [4])[0]
    low = toy.Reference(p, params, quant=fp8_quant).logits([seq], [4])[0]
    assert ref.shape == (4, p["vocab_size"]) and torch.isfinite(ref).all()
    assert 0 < (low - ref).abs().max() < ref.abs().max()

    # two decode steps in the traced window, 2 attention layers each
    device = [("paged_decode_kernel", 10.0 * i, 10.0 * i + 8.0)
              for i in range(4)] + [("split_merge_kernel", 50.0, 54.0)]
    td = TraceData(device=device, spans=[], host_ops=[], window_s=1.0,
                   t0_us=0.0, t1_us=1e6)
    run = RunData(p=p, arch=toy, w0=0.0, w1=10.0, stamps=[], td=td,
                  t0=0.0, t1=10.0, prefills=[(1.0, 0.1, 16, 0)],
                  decodes=[(2.0, 0.01, 3, 60, 4), (3.0, 0.02, 2, 41, 4)])
    read, variant = spec.reader("model.mfu.tput", root)
    flops = (toy.prefill_flops(p, 16) + toy.decode_flops(p, 3, 60)
             + toy.decode_flops(p, 2, 41))
    assert flops != (DECODER.prefill_flops(p, 16)
                     + DECODER.decode_flops(p, 3, 60)
                     + DECODER.decode_flops(p, 2, 41))
    assert read(run, variant) == pytest.approx(
        100 * flops / (0.13 * counts.PEAK_BF16_FLOPS))
    read, variant = spec.reader("attn_decode_roofline.itl", root)
    bound = 2 * (counts.bound_s(counts.attn_decode_flops(p, 61),
                                counts.attn_decode_bytes(p, 4, 61))
                 + counts.bound_s(counts.attn_decode_flops(p, 43),
                                  counts.attn_decode_bytes(p, 4, 43)))
    assert read(run, variant) == pytest.approx(100 * bound / 36e-6)
    # num_layers (4) launches a step would not be the toy's count
    run.td = TraceData(device=device * 2, spans=[], host_ops=[],
                       window_s=1.0, t0_us=0.0, t1_us=1e6)
    assert read(run, variant) is None
    assert pb_smoke_root.folder_digest(pb_smoke_root.PORTBENCH) == before


def test_an_unknown_arch_is_refused(tmp_path):
    root = pb_smoke_root.make(tmp_path)
    pb = root / "portbench"
    pb_smoke_root.write(pb / "configs" / "dense-smoke.json",
                        {"arch": "nosuch", "port": pb_smoke_root.DENSE})
    looked = str(pb / "archs" / "nosuch.py")
    errors = spec.validate(json.loads((root / "BENCHMARK.json").read_text()),
                           root)
    assert any(looked in e and "dense-smoke" in e for e in errors), errors
    with pytest.raises(FileNotFoundError, match="nosuch.py"):
        cell.run("dense.open", 1, 1.0, False, t_start=time.perf_counter(),
                 device="cpu", root=root, log=lambda s: None)
    for name in ("nosuch", "../metrics/model.mfu", ""):
        with pytest.raises(FileNotFoundError):
            spec.arch(name, root)


def test_own_inits_leave_the_shared_draw_as_it_was():
    """Leaves of an architecture's own inits (a constant, a function of the
    shape and the generator) are made after the shared ones, which come
    out bit for bit as without them; an unknown shared init is refused."""
    p = pb_smoke_root.DENSE
    leaves = DECODER.layout(p)
    base = weights.draw(p, 7, "cpu", leaves)
    own = leaves + [(("d_skip",), (3, 5), 1.0),
                    (("a_log",), (4,), lambda shape, gen: torch.log(
                        torch.arange(1, shape[0] + 1, dtype=torch.float32))),
                    (("noise",), (6,), lambda shape, gen: torch.randn(
                        shape, generator=gen))]
    got = weights.draw(p, 7, "cpu", own)
    assert weights_digest(p, got) == weights_digest(p, base)
    assert torch.equal(got["d_skip"], torch.ones(3, 5, dtype=torch.bfloat16))
    assert got["a_log"].dtype == torch.float32
    assert torch.equal(got["a_log"].exp().round(), torch.arange(1.0, 5.0))
    assert not torch.equal(got["noise"],
                           weights.draw(p, 8, "cpu", own)["noise"])
    with pytest.raises(ValueError, match="init"):
        weights.draw(p, 7, "cpu", leaves + [(("x",), (2,), "zeros")])
