"""The comparison that decides ``correct``, driven through a whole run at
smoke size on the CPU (everything but the look for a card): a sound run
is correct; the control (the reference in float8) and each fault planted
in the timed path come out not correct."""
import time

import pytest

import pb_smoke_root
from pbench import cell, check
from repro_torch.models import transformer as T
from repro_torch.serving import engine as E


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_smoke_root.make(tmp_path_factory.mktemp("smoke"))


def run(root, name="dense.open", seed=1):
    return cell.run(name, seed, pb_smoke_root.WINDOW_S[name], False,
                    t_start=time.perf_counter(), device="cpu", root=root,
                    log=lambda s: None)


@pytest.mark.parametrize("name", list(pb_smoke_root.CELLS))
def test_sound_run_is_correct(root, name):
    out = run(root, name, seed=2)
    assert out["correct"], out["checks"]
    limits = pb_smoke_root.cell_limits(name)
    assert set(limits) <= set(check.NUMBERS)
    assert set(out["checks"]) == set(limits) | {"served_tokens_min"}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_control_fails(root):
    for seed in (1, 2, 3):
        bench = cell.Bench("dense.open", seed, t_start=time.perf_counter(),
                           device="cpu", root=root, log=lambda s: None)
        out = bench.check(bench.serve(bench.mix, 2.0), control=True)
        assert out["correct"]
        limits = bench.deploy["check"]["limits"]
        assert any(out["control"][k] > limits[k] for k in limits), out


def _unchanged(orig):
    def step(params, cfg, pool, *a, **kw):       # the state comes back as
        logits, _, pos = orig(params, cfg,     # it was: no KV written
                              {k: v.clone() for k, v in pool.items()},
                              *a, **kw)
        return logits, pool, pos
    return step


def _half(orig):
    def step(self, tokens_by_slot):     # half the active rows left out:
        out = orig(self, tokens_by_slot)        # their token is not new
        slots = sorted(tokens_by_slot)
        for s in slots[:(len(slots) + 1) // 2]:
            out[s] = tokens_by_slot[s]
        return out
    return step


FAULTS = {
    "state_unchanged": (T, "decode_step_paged", _unchanged),
    "half_batch": (E.Engine, "decode_step", _half),
    "handoff_left_out": (T, "scatter_blocks",
                         lambda orig: lambda pool, ids, blocks: pool),
    "token_altered": (E.Engine, "_first_token",
                      lambda orig: lambda self, logits: (
                          orig(self, logits) + 1) % self.cfg.vocab_size),
}


def caught_by_a_number(rows):
    """A limited number over its limit (not merely too few tokens)."""
    return any(r["value"] > r["limit"] for k, r in rows.items()
               if k != "served_tokens_min")


@pytest.mark.parametrize("fault,name", [
    pytest.param(f, "dense.open", id=f) for f in FAULTS] + [
    pytest.param(f, "moe.closed", id=f"moe.closed-{f}") for f in FAULTS])
def test_fault_is_caught(root, monkeypatch, fault, name):
    """Each fault, in the dense cell (all four numbers) and in the mixture
    of experts cell (``gap_max`` and ``logit_err_mean``, as the granite
    cell)."""
    owner, attr, make = FAULTS[fault]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = run(root, name, seed=1)
    assert not out["correct"], out["checks"]
    assert caught_by_a_number(out["checks"]), out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["granite-moe.decode-heavy.paced"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_caught_on_the_card(monkeypatch, fault, name):
    """Each fault planted in the granite cell at its own size and load (its
    ramp, then a 5-s window), judged by the cell's own limits; prints
    every number (run it on the card: ``python -m pytest -m gpu -s
    portbench/tests/test_pb_check.py``)."""
    import json

    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    owner, attr, make = FAULTS[fault]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    bench = cell.Bench(name, 4100000001, t_start=time.perf_counter(),
                       device="cuda", log=lambda s: None)
    out = bench.check(bench.serve(bench.mix, 5.0))
    print("fault-reading " + json.dumps({
        "cell": name, "fault": fault, "correct": out["correct"],
        "served": out["served"], "sampled": out["sampled"],
        "values": out["values"]}), flush=True)
    assert not out["correct"], out["checks"]
    assert caught_by_a_number(out["checks"]), out["checks"]


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """One short run of a cell through the benchmark's command (run it on
    the card: ``python -m pytest -m gpu portbench/tests``)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "granite-moe.decode-heavy.paced", "--seed", "2147483651",
         "--seconds", "5", "--trace", "0"], cwd=root, capture_output=True,
        text=True, timeout=600, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
