"""``BENCHMARK.json``'s validation, and a cell, a configuration, a mix
and a per-layer metric added as new files only, found by name."""
import copy
import json
import time
from pathlib import Path

import pytest

import pb_smoke_root
from pbench import cell, spec

PORTBENCH = Path(__file__).resolve().parent.parent


def test_the_benchmark_is_valid():
    b = spec.load()
    assert spec.validate(b) == []
    for w in b["workloads"]:
        assert w["chips"] == 1
        for kind in ("end_to_end", "per_layer"):
            for m in spec.metrics_of(b, w["name"], kind):
                spec.metric_file(m["name"])         # every reader exists


@pytest.mark.parametrize("edit, word", [
    (lambda b: b["configs"][0].update(name="a b"), "name"),
    (lambda b: b["end_to_end"][0].update(unit="tokens per s"), "unit"),
    (lambda b: b["end_to_end"][0].update(unit="x" * 17), "unit"),
    (lambda b: b["per_layer"][0].update(moves="nothing_s"), "report"),
    (lambda b: b["configs"][0]["reduced"].append("hidden_size"), "width"),
    (lambda b: b["configs"][0]["reduced"].append("head_dim"), "width"),
    (lambda b: b["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda b: b["workloads"][0].update(chips=2), "chips"),
    (lambda b: b.update(run_seconds=52), "run_seconds"),
    (lambda b: b["per_layer"][0].update(why="x"), "keys"),
    (lambda b: b["per_layer"].append(dict(b["per_layer"][0])), "twice"),
])
def test_validation_refuses(edit, word):
    b = copy.deepcopy(spec.load())
    edit(b)
    errors = spec.validate(b)
    assert errors and any(word in e for e in errors), errors


def test_new_cell_config_mix_and_metric_as_files(tmp_path):
    before = pb_smoke_root.folder_digest(PORTBENCH)
    root = pb_smoke_root.make(tmp_path)
    pb = root / "portbench"
    # a configuration, a mix, a cell and a per-layer metric: new files
    p = dict(pb_smoke_root.DENSE, name="dense-wide", d_model=128,
             num_heads=8, num_kv_heads=2)
    pb_smoke_root.write(pb / "configs" / "dense-wide.json", {"port": p})
    pb_smoke_root.write(pb / "traffic" / "burst.json", {
        "arrivals": {"process": "poisson", "rate": 30.0},
        "isl": {"dist": "uniform", "lo": 16, "hi": 16},
        "osl": {"dist": "uniform", "lo": 4, "hi": 4}, "ramp_s": 1.0})
    pb_smoke_root.write(pb / "cells" / "wide.burst.json",
                        json.loads((pb / "cells" / "dense.open.json")
                                   .read_text()))
    (pb / "metrics" / "engine.handoff_mb.py").write_text(
        "def read(run, variant):\n"
        "    return run.handoff_bytes / 1e6 or None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "dense-wide", "source": "smoke",
                         "file": "portbench/configs/dense-wide.json",
                         "reduced": [], "why": "a wider smoke model"})
    b["workloads"].append({"name": "wide.burst", "config": "dense-wide",
                           "traffic": "burst", "chips": 1, "why": "bursts"})
    b["per_layer"].append({"name": "engine.handoff_mb.tput", "unit": "MB",
                           "better": "lower", "source": "program_counter",
                           "layer": "engine", "moves": "output_tokens_per_s",
                           "workloads": ["wide.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    assert spec.validate(b, root) == []
    out = cell.run("wide.burst", 3, 2.0, False, t_start=time.perf_counter(),
                   device="cpu", root=root, log=lambda s: None)
    assert out["correct"]
    run = out["_run"]
    read, variant = spec.reader("engine.handoff_mb.tput", root)
    assert variant == "tput"
    # 4 KV bytes/element pairs: 2 layers x 2 heads x 16 x K and V x 2 B
    # a token, 16-token prompts in 8-token blocks
    assert read(run, variant) == pytest.approx(
        run.handoff_bytes / 1e6) and run.handoff_bytes % (2 * 2 * 16 * 2
                                                          * 2 * 16) == 0
    names = [m["name"] for m in spec.metrics_of(b, "wide.burst",
                                                 "per_layer")]
    assert names == ["model.mfu.tput", "engine.handoff_mb.tput"]
    # nothing existing edited
    assert pb_smoke_root.folder_digest(PORTBENCH) == before
