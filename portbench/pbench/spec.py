"""``BENCHMARK.json``: loading, validation, and finding a cell's files by
name.

A cell ``c`` of configuration ``m`` under traffic ``t`` is served from
three data files found by name, and read by the per-layer metrics' files:

- ``configs/<m>.json``: the model as it is run (``port``: the keys of the
  port's ``ModelConfig``), beside the published configuration it states,
  and the architecture it has (``arch``; ``decoder`` where absent);
- ``archs/<arch>.py``: what the benchmark knows of an architecture: the
  weights' layout, the plain reference and the model FLOPs (see
  ``archs/decoder.py``);
- ``traffic/<t>.json``: the mix (arrivals, lengths, ramp);
- ``cells/<c>.json``: the deployment that serves it (pools, slots, block
  size) and the limits of the comparison that decides ``correct``;
- ``metrics/<name>.py`` or, for a metric ``<family>.<variant>``,
  ``metrics/<family>.py``: a reader ``read(run, variant)``.

A later cell, configuration, architecture, mix or metric is a set of new
files and new entries here; no existing file changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent.parent       # portbench/
ROOT = HERE.parent
DEFAULT_ARCH = "decoder"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
END_TO_END_SOURCES = {"host_clock", "device_trace"}
WIDTH_WORDS = ("hidden_size", "intermediate", "latent", "state", "proj",
               "head_dim", "d_model", "d_ff", "experts_per", "expand",
               "expansion", "top_k", "width")


def load(path=None) -> Dict[str, Any]:
    path = Path(path) if path else ROOT / "BENCHMARK.json"
    with open(path) as f:
        return json.load(f)


def _line(s: Any, what: str, errors: List[str]) -> None:
    if (not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s
            or "\t" in s):
        errors.append(f"{what}: 1 to 200 characters on one line, no tab")


def validate(b: Dict[str, Any], root: Path = ROOT) -> List[str]:
    """Every rule of the contract this file can check; [] when sound."""
    e: List[str] = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(b) != keys:
        e.append(f"keys {sorted(set(b) ^ keys)} differ from the contract's")
        return e
    cmd = b["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        e.append("command: a list of 1 to 32 strings")
    else:
        for w in cmd:
            _line(w, f"command word {w!r}", e)
            if isinstance(w, str) and (w.startswith("/") or ".." in w):
                e.append(f"command word {w!r} leaves the repo")
    paths = b["paths"]
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        e.append("paths: 1 to 16 directories")
        paths = []
    for p in paths:
        if not re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) or ".." in p \
                or p.startswith("/"):
            e.append(f"path {p!r}")
    rs = b["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        e.append("run_seconds: a whole number from 1 to 51")
    names = set()

    def named(x, what):
        n = x.get("name")
        if not isinstance(n, str) or not NAME.match(n):
            e.append(f"{what} name {n!r}")
        if n in names:
            e.append(f"name {n!r} used twice")
        names.add(n)

    configs = b["configs"]
    if not 1 <= len(configs) <= 24:
        e.append("configs: 1 to 24")
    for c in configs:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            e.append(f"config {c.get('name')}: keys {sorted(c)}")
            continue
        named(c, "config")
        _line(c["source"], f"config {c['name']} source", e)
        _line(c["why"], f"config {c['name']} why", e)
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            e.append(f"config {c['name']}: file outside paths")
        cfg_path = root / c["file"]
        if cfg_path.exists():
            try:
                arch_file(read_json(cfg_path).get("arch", DEFAULT_ARCH),
                          root)
            except FileNotFoundError as err:
                e.append(f"config {c['name']}: {err}")
        if len(c["reduced"]) > 16:
            e.append(f"config {c['name']}: more than 16 reduced keys")
        for k in c["reduced"]:
            if not NAME.match(k):
                e.append(f"config {c['name']}: reduced key {k!r}")
            if (k.endswith("_dim") or k.endswith("_rank")
                    or any(w in k for w in WIDTH_WORDS)):
                e.append(f"config {c['name']}: reduces a width ({k})")
    if len({c.get("file") for c in configs}) != len(configs):
        e.append("two configurations share a file")
    cfg_names = {c.get("name") for c in configs}
    cells = b["workloads"]
    if not 1 <= len(cells) <= 24:
        e.append("workloads: 1 to 24")
    pairs = set()
    for w in cells:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            e.append(f"workload {w.get('name')}: keys {sorted(w)}")
            continue
        named(w, "workload")
        if w["config"] not in cfg_names:
            e.append(f"workload {w['name']}: unknown config")
        if not NAME.match(str(w["traffic"])):
            e.append(f"workload {w['name']}: traffic name")
        if w["chips"] not in (1, 4):
            e.append(f"workload {w['name']}: chips 1 or 4")
        _line(w["why"], f"workload {w['name']} why", e)
        if (w["config"], w["traffic"]) in pairs:
            e.append(f"workload {w['name']}: config and traffic twice")
        pairs.add((w["config"], w["traffic"]))
    used = {w.get("config") for w in cells}
    for c in cfg_names - used:
        e.append(f"config {c} is used by no cell")
    cell_names = {w.get("name") for w in cells}
    e2e = b["end_to_end"]
    if not 1 <= len(e2e) <= 16:
        e.append("end_to_end: 1 to 16")
    reports: Dict[str, set] = {w: set() for w in cell_names}
    for m in e2e:
        extra = set(m) - {"name", "unit", "better", "bound", "source",
                          "workloads"}
        if extra or not {"name", "unit", "better", "bound",
                         "source"} <= set(m):
            e.append(f"end-to-end {m.get('name')}: keys {sorted(m)}")
            continue
        named(m, "end-to-end")
        _metric_common(m, e)
        if m["source"] not in END_TO_END_SOURCES:
            e.append(f"end-to-end {m['name']}: source {m['source']}")
        bound = m["bound"]
        if not (isinstance(bound, (int, float)) and 0.01 <= bound <= 0.25):
            e.append(f"end-to-end {m['name']}: bound in [0.01, 0.25]")
        for w in m.get("workloads", cell_names):
            if w not in cell_names:
                e.append(f"end-to-end {m['name']}: unknown cell {w}")
            else:
                reports[w].add(m["name"])
    if "setup_s" not in {m.get("name") for m in e2e}:
        e.append("no setup_s")
    for w, ms in reports.items():
        if "setup_s" not in ms or len(ms) < 2:
            e.append(f"cell {w}: setup_s and one more end-to-end metric")
    per = b["per_layer"]
    if not 1 <= len(per) <= 128:
        e.append("per_layer: 1 to 128")
    layered = {w: 0 for w in cell_names}
    for m in per:
        extra = set(m) - {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if extra or not {"name", "unit", "better", "source", "layer",
                         "moves"} <= set(m):
            e.append(f"per-layer {m.get('name')}: keys {sorted(m)}")
            continue
        named(m, "per-layer")
        _metric_common(m, e)
        _line(m["layer"], f"per-layer {m['name']} layer", e)
        if m["source"] not in SOURCES:
            e.append(f"per-layer {m['name']}: source {m['source']}")
        for w in m.get("workloads", cell_names):
            if w not in cell_names:
                e.append(f"per-layer {m['name']}: unknown cell {w}")
                continue
            layered[w] += 1
            if m["moves"] not in reports[w]:
                e.append(f"per-layer {m['name']}: cell {w} does not report "
                         f"{m['moves']}")
        if not (root / "portbench" / "metrics").exists():
            continue
        try:
            metric_file(m["name"], root)
        except FileNotFoundError as err:
            e.append(str(err))
    for w, n in layered.items():
        if not n:
            e.append(f"cell {w}: no per-layer metric")
    if len(json.dumps(b).encode()) > 64 * 1024:
        e.append("over 64 KiB")
    for w in cells:
        for f in (cell_file(w["name"], root), traffic_file(w["traffic"],
                                                           root)):
            if not f.exists():
                e.append(f"workload {w['name']}: {f.relative_to(root)} "
                         "missing")
    return e


def _metric_common(m, e) -> None:
    if not isinstance(m.get("unit"), str) or not UNIT.match(m["unit"]):
        e.append(f"metric {m['name']}: unit {m.get('unit')!r}")
    if m.get("better") not in ("lower", "higher"):
        e.append(f"metric {m['name']}: better")


def config_entry(b, name: str) -> Dict[str, Any]:
    return next(c for c in b["configs"] if c["name"] == name)


def cell_entry(b, name: str) -> Dict[str, Any]:
    for w in b["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_file(name: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "cells" / f"{name}.json"


def traffic_file(name: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "traffic" / f"{name}.json"


def metric_file(name: str, root: Path = ROOT):
    """(path, variant) of metric ``name``'s reader: ``metrics/<name>.py``
    with no variant, else ``metrics/<family>.py`` with the last dotted
    part as the variant."""
    d = root / "portbench" / "metrics"
    whole = d / f"{name}.py"
    if whole.exists():
        return whole, None
    if "." in name:
        family, variant = name.rsplit(".", 1)
        f = d / f"{family}.py"
        if f.exists():
            return f, variant
    raise FileNotFoundError(f"metric {name}: no reader in {d}")


def reader(name: str, root: Path = ROOT):
    """The ``read(run, variant)`` function of metric ``name`` and its
    variant."""
    path, variant = metric_file(name, root)
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read, variant


def arch_file(name: str, root: Path = ROOT) -> Path:
    """``archs/<name>.py``: the module of architecture ``name``."""
    f = root / "portbench" / "archs" / f"{name}.py"
    if not NAME.match(str(name)) or not f.is_file():
        raise FileNotFoundError(f"arch {name!r}: no module {f}")
    return f


def arch(name: str, root: Path = ROOT):
    """The module of architecture ``name``: ``layout(p)``,
    ``Reference(p, params, quant=None)``, ``prefill_flops(p, S)``,
    ``decode_flops(p, active, ctx_sum)`` and ``attn_layers(p)``."""
    path = arch_file(name, root)
    spec = importlib.util.spec_from_file_location(
        f"portbench_arch_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_arch(config: Dict[str, Any], root: Path = ROOT):
    """The module of the architecture that a configuration's file names
    in its top-level ``arch`` (``decoder`` where it names none)."""
    return arch(config.get("arch", DEFAULT_ARCH), root)


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def metrics_of(b, cell: str, kind: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics cell ``cell`` reports."""
    return [m for m in b[kind] if cell in m.get("workloads", [cell])]
