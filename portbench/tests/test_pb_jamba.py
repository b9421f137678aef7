"""The jamba architecture (``archs/jamba.py``) against the port's jamba
block on the CPU, at a smoke size: one whole period of Jamba's 8 layers
(attention in layer 4, the MoE FFN in the odd layers), d 64, 16 experts
routed of which 8 held, dt_rank 4, d_state 16, d_inner 128. The port runs
its serving path: a whole prefill on one engine, the handoff (KV blocks
and SSM state) inserted into a paged decode engine, decode steps; the
reference its plain fp32 forward over the whole sequence. And the reader
``model.ssm_share`` on synthetic traces."""
import types

import numpy as np
import pytest
import torch

from pbench import cell, spec, weights
from pbench.trace import TraceData

from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving.backends import make_engine

JAMBA = spec.arch("jamba")
SMOKE = {"name": "jamba-smoke", "family": "hybrid", "block": "jamba",
         "num_layers": 8, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "d_ff": 96, "vocab_size": 128, "dtype": "bfloat16", "rope": False,
         "attn_layer_period": 8, "attn_layer_offset": 4,
         "expert_layer_period": 2, "expert_layer_offset": 1,
         "ssm_expand": 2, "ssm_state": 16, "ssm_conv": 4, "ssm_dt_rank": 4,
         "ssm_conv_bias": True,
         "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 48,
                 "capacity_factor": 8.0, "router_experts": 16,
                 "renormalize": False}}
# The port's logits against the reference's, max |difference| over the
# prefill's and 8 decode steps' rows (logits of scale ~3):
# - fp32 weights and activations: the two differ only in the order of
#   fp32 sums (the chunked doubling scan against the position-by-position
#   recurrence, fused projections), 2.7e-6 on seed 3; 1e-4 leaves room
#   for other seeds, and a bf16 run (0.14) fails it by three orders;
# - bf16: the same weights, every layer's activations rounded to bf16
#   (the served precision), 0.14 on seed 3; 0.5 leaves room for other
#   seeds and stays under a sixth of the logits' scale.
TOL = {"float32": 1e-4, "bfloat16": 0.5}


def _fp32(tree):
    if isinstance(tree, torch.Tensor):
        return tree.float()
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    return [_fp32(v) for v in tree]


def _model(dtype: str, seed: int = 3, **moe):
    p = dict(SMOKE, dtype=dtype, moe=dict(SMOKE["moe"], **moe))
    params = weights.draw(dict(p, dtype="bfloat16"), seed, "cpu",
                          JAMBA.layout(p))
    return p, (_fp32(params) if dtype == "float32" else params)


class _Rows:
    """Every logits row the engines compute, per call (prefill: [1, V],
    decode step: [slots, V])."""

    def __enter__(self):
        self.rows, self.saved = [], (T.prefill_full, T.decode_step_paged)

        def wrap(fn):
            def run(*a, **kw):
                out = fn(*a, **kw)
                self.rows.append(out[0].detach().clone())
                return out
            return run
        T.prefill_full, T.decode_step_paged = map(wrap, self.saved)
        return self

    def __exit__(self, *exc):
        T.prefill_full, T.decode_step_paged = self.saved


def _reference(p, params, prompt, toks):
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]))
    return JAMBA.Reference(p, _fp32(params)).logits([seq], [len(toks)])[0]


def _engines(p, params, slots=4):
    cfg = cell.model_config(p)
    return (make_engine("torch", 0, cfg, params, slots=1, capacity=96,
                        device="cpu"),
            make_engine("torch", 1, cfg, params, slots=slots, capacity=96,
                        device="cpu"))


def _error(p, params, seed):
    """The port's prefill and 8 decode steps after an insert against the
    reference: (max |logit difference|, the reference's logit scale)."""
    pre, dec = _engines(p, params)
    prompt = np.random.default_rng(seed).integers(0, 128, 21).astype(
        np.int32)
    with _Rows() as rec:
        tok, payload = pre.prefill(prompt)
        slot = dec.insert(types.SimpleNamespace(), payload)
        toks = [tok]
        for _ in range(8):
            toks.append(dec.decode_step({slot: toks[-1]})[slot])
    got = torch.stack([rec.rows[0][0]] + [r[slot] for r in rec.rows[1:]])
    ref = _reference(p, params, prompt, toks)
    return (got[:, :128].float() - ref).abs().max().item(), \
        ref.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_paged_decode_matches_the_reference(dtype):
    for seed in (3, 4):
        p, params = _model(dtype, seed)
        err, scale = _error(p, params, seed)
        assert err < TOL[dtype], (seed, err)
        if dtype == "bfloat16":     # the fp32 tolerance sees bf16
            assert err > TOL["float32"] * 100, (seed, err)
        assert scale > 1.0


def test_slots_keep_their_own_state():
    """Three requests through one fp32 decode engine: a second joins the
    first after 3 steps, the first leaves after 6 and a third takes its
    slot (whose rows still hold the first's state): each request's logits
    are the reference's for its own sequence."""
    p, params = _model("float32")
    pre, dec = _engines(p, params, slots=2)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (21, 9, 14)]
    logits = {0: [], 1: [], 2: []}
    toks = {0: [], 1: [], 2: []}
    slots, first = {}, None
    with _Rows() as rec:
        for step in range(12):
            for r, at in ((0, 0), (1, 3), (2, 6)):
                if step == at:
                    if r == 2:
                        first = slots.pop(0)
                        dec.evict(first)
                    tok, payload = pre.prefill(prompts[r])
                    logits[r].append(rec.rows[-1][0])
                    toks[r].append(tok)
                    slots[r] = dec.insert(types.SimpleNamespace(), payload)
            out = dec.decode_step({s: toks[r][-1] for r, s in slots.items()})
            for r, s in slots.items():
                logits[r].append(rec.rows[-1][s])
                toks[r].append(out[s])
    assert slots[2] == first != slots[1]
    for r in (0, 1, 2):
        got = torch.stack(logits[r])[:, :128]
        ref = _reference(p, params, prompts[r], toks[r])
        assert (got - ref).abs().max().item() < TOL["float32"], r


def _zero_state(keys):
    def make(orig):
        def insert(self, req, payload):
            payload.state = {k: (torch.zeros_like(t) if k in keys else t)
                             for k, t in payload.state.items()}
            return orig(self, req, payload)
        return insert
    return make


def _other_slot(orig):
    def insert(self, req, payload):
        slot = orig(self, req, payload)
        other = (slot + 1) % self.slots
        for k in payload.state:
            self.pool[k][:, slot].copy_(self.pool[k][:, other])
        return slot
    return insert


FAULTS = {"state_zeroed": _zero_state(("ssm_h", "conv")),
          "conv_dropped": _zero_state(("conv",)),
          "other_slot": _other_slot}


@pytest.mark.parametrize("fault", list(FAULTS) + ["experts_offset"])
def test_a_planted_fault_departs_from_the_reference(monkeypatch, fault):
    """The card's planted faults at the smoke size, in bf16 with two
    requests live: the handed-off state zeroed, its convolution state
    dropped, a slot given another slot's state, the held experts taken
    for experts 8-15. Each moves some logit beyond the bf16 tolerance."""
    from repro_torch.serving import engine as E
    p, params = _model("bfloat16")
    if fault == "experts_offset":
        p = dict(p, moe=dict(p["moe"], first_expert=8))
    else:
        monkeypatch.setattr(E.Engine, "insert",
                            FAULTS[fault](E.Engine.insert))
    pre, dec = _engines(p, params)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (21, 13)]
    toks, logits, slots = {}, {}, {}
    with _Rows() as rec:
        for r, prompt in enumerate(prompts):
            tok, payload = pre.prefill(prompt)
            toks[r], logits[r] = [tok], [rec.rows[-1][0]]
            slots[r] = dec.insert(types.SimpleNamespace(), payload)
        for _ in range(6):
            out = dec.decode_step({s: toks[r][-1] for r, s in slots.items()})
            for r, s in slots.items():
                logits[r].append(rec.rows[-1][s])
                toks[r].append(out[s])
    err = max((torch.stack(logits[r])[:, :128].float()
               - _reference(dict(p, moe=SMOKE["moe"]), params, prompts[r],
                            toks[r])).abs().max().item() for r in slots)
    assert err > TOL["bfloat16"], err


def test_the_layer_pattern():
    """Attention iff i % 8 == 4, experts iff i % 2 == 1, in the
    configuration, the port's parameters and the benchmark's layout."""
    p, params = _model("bfloat16")
    cfg = cell.model_config(p)
    port = T.init_params(cfg, 0, device="cpu")
    leaves = {path[1:] for path, _, _ in JAMBA.layout(p)
              if path[0] == "blocks"}
    for i in range(8):
        attn, experts = i % 8 == 4, i % 2 == 1
        assert cfg.attends(i) == attn and cfg.has_experts(i) == experts
        for blk in (params["blocks"][i], port["blocks"][i]):
            assert ("wq" in blk) == attn and ("ssm" in blk) == (not attn)
            assert ("moe" in blk) == experts
            assert ("wi_gate" in blk) == (not experts)
        assert ((i, "wq") in leaves) == attn
    assert cfg.attn_layer_ids == (4,) and JAMBA.attn_layers(p) == 1
    assert cfg.mamba_layer_ids == (0, 1, 2, 3, 5, 6, 7)
    # the port's count and the layout's, leaf by leaf
    assert cfg.param_count() == sum(int(np.prod(s))
                                    for _, s, _ in JAMBA.layout(p))
    assert cfg.kv_bytes_per_token() == 1 * 2 * 2 * 16 * 2


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """One MoE layer in fp32: the port's FFN holding experts 0-7 and then
    8-15 of 16 (a card's share each) adds up to the reference's layer
    holding all 16."""
    gen = torch.Generator().manual_seed(0)
    D, F, E = 64, 48, 16
    x = torch.randn(1, 30, D, generator=gen)
    w = {"router": torch.randn(D, E, generator=gen) * 0.3,
         "wg": torch.randn(E, D, F, generator=gen) / 8,
         "wu": torch.randn(E, D, F, generator=gen) / 8,
         "wd": torch.randn(E, F, D, generator=gen) / 7}
    halves = []
    for first in (0, 8):
        m = cell.model_config(dict(SMOKE, moe=dict(
            SMOKE["moe"], first_expert=first))).moe
        part = dict(w, **{k: w[k][first:first + 8]
                          for k in ("wg", "wu", "wd")})
        halves.append(M.moe_ffn(x, part, m)[0])
    uncut = JAMBA.Reference(dict(SMOKE, moe=dict(SMOKE["moe"],
                                                 num_experts=16)),
                            params=None)
    want = uncut.ffn(x[0], {"moe": w})
    assert (halves[0] - halves[1]).abs().max() > 0.01
    torch.testing.assert_close((halves[0] + halves[1])[0], want,
                               rtol=1e-5, atol=1e-5)


def test_the_gates_are_not_renormalised():
    """Jamba's top-2 gates are the softmax over all 16 experts as it gave
    them; with ``renormalize`` (every other configuration) they sum to
    1."""
    x = torch.randn(20, 64, generator=torch.Generator().manual_seed(1))
    router = torch.randn(64, 16, generator=torch.Generator().manual_seed(2))
    probs = torch.softmax(x @ router, dim=-1)
    for renorm in (False, True):
        m = cell.model_config(dict(SMOKE, moe=dict(
            SMOKE["moe"], renormalize=renorm))).moe
        gates = M._route(x, router, m)[0]
        top = probs.topk(2, dim=-1).values
        sums = gates.sum(dim=-1)
        if renorm:
            torch.testing.assert_close(sums, torch.ones(20))
        else:
            torch.testing.assert_close(sums, top.sum(dim=-1))
            assert (sums < 1).all()


def test_the_handoff_counts_kv_blocks_and_ssm_state():
    """A 21-token prompt's payload: 3 blocks of 8 a layer for the one
    attention layer's K and V, and the 7 Mamba-1 layers' state; ``nbytes``
    counts both, and the engine reports the state a slot."""
    p, params = _model("bfloat16")
    pre, dec = _engines(p, params)
    _, payload = pre.prefill(np.arange(21, dtype=np.int32))
    kv = 2 * 1 * 3 * 8 * 2 * 16 * 2                # K, V; bf16
    state = 7 * (128 * 16 * 4 + 3 * 128 * 2)       # fp32 h, bf16 conv
    assert payload.blocks["k"].shape == (1, 3, 8, 2, 16)
    assert payload.state["ssm_h"].shape == (7, 128, 16)
    assert payload.nbytes == kv + state
    assert dec.describe()["ssm_state_bytes"] == state
    assert pre.describe()["ssm_state_bytes"] == state


def test_chunked_prefill_and_the_prefix_cache_are_refused():
    p, params = _model("bfloat16")
    cfg = cell.model_config(p)
    with pytest.raises(ValueError, match="run whole"):
        make_engine("torch", 0, cfg, params, slots=2, capacity=96,
                    chunk_size=8, device="cpu")
    _, dec = _engines(p, params)
    with pytest.raises(ValueError, match="chunked prefill"):
        dec.prefill_chunked(np.arange(16, dtype=np.int32), 8)
    with pytest.raises(ValueError, match="paged layout only"):
        make_engine("torch", 0, cfg, params, slots=2, capacity=96,
                    paged=False, device="cpu")


# -- the reader ------------------------------------------------------------

def _td(host, device):
    return TraceData(device=device, spans=[], host_ops=host, window_s=1.0,
                     t0_us=0.0, t1_us=1000.0)


def _ssm_share(td):
    read, variant = spec.reader("model.ssm_share.tput")
    return read(types.SimpleNamespace(td=td), variant)


def test_ssm_share_pairs_launches_with_device_activities():
    """Prefill 1: after the prompt's upload (left out, and here not
    recorded), four launches, the first two inside a Mamba layer's span,
    paired back from the first token's copy, which the device's clock puts
    after the span's end: 30 of 36 us. Prefill 2: a set launched where
    the device ran a kernel, skipped; paired once its set is there. A
    prefill past the traced window, or a trace with no closing copy,
    reads nothing."""
    dtoh = "Memcpy DtoH (Device -> Pinned)"
    host = [("repro_torch.engine.prefill", 0.0, 100.0),
            ("repro_torch.model.ssm", 5.0, 30.0),
            ("cudaMemcpyAsync", 2.0, 3.0),
            ("cudaLaunchKernel", 10.0, 11.0),
            ("cuLaunchKernelEx", 20.0, 21.0),
            ("aten::mm", 9.0, 12.0),
            ("cudaLaunchKernel", 40.0, 41.0),
            ("cudaMemcpyAsync_v2", 50.0, 51.0),
            ("repro_torch.engine.prefill", 200.0, 300.0),
            ("repro_torch.model.ssm", 205.0, 260.0),
            ("cudaMemcpyAsync", 201.0, 202.0),
            ("cudaLaunchKernel", 210.0, 211.0),
            ("cudaMemsetAsync", 220.0, 221.0),
            ("cudaMemcpyAsync", 270.0, 271.0),
            ("repro_torch.engine.prefill", 900.0, 1100.0)]
    device = [("before", -50.0, -40.0), ("gemm", 12.0, 22.0),
              ("scan", 25.0, 45.0), ("norm", 55.0, 60.0),
              (dtoh, 101.0, 102.0),
              ("a", 212.0, 300.0), ("b", 230.0, 240.0),
              (dtoh, 301.0, 302.0)]
    assert _ssm_share(_td(host, device)) == pytest.approx(100.0 * 30 / 36)
    device[6] = ("Memset (Device)", 230.0, 240.0)
    assert _ssm_share(_td(host, device)) == pytest.approx(
        100.0 * (30 + 98) / (36 + 99))
    assert _ssm_share(_td(host[8:], device[5:])) == pytest.approx(
        100.0 * 98 / 99)
    assert _ssm_share(_td(host[-1:] + host[1:8], device)) is None
    assert _ssm_share(_td(host, [d for d in device if d[0] != dtoh])) \
        is None
