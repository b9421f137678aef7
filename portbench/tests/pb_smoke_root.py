"""A benchmark root at smoke size for the CPU tests: its own
``BENCHMARK.json`` with two cells (a dense model under an open loop, a
mixture of experts under a closed loop, both at the port's smoke widths),
their configuration, traffic and cell files, and the benchmark's metric
readers and architectures' modules beside them, all written into a
temporary folder."""
from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent.parent

DENSE = {"name": "dense-smoke", "family": "dense", "num_layers": 2,
         "d_model": 64, "num_heads": 4, "num_kv_heads": 1, "d_ff": 160,
         "vocab_size": 96, "dtype": "bfloat16"}
MOE = {"name": "moe-smoke", "family": "moe", "num_layers": 2, "d_model": 64,
       "num_heads": 4, "num_kv_heads": 2, "d_ff": 32, "vocab_size": 96,
       "vocab_pad": 4, "tie_embeddings": True, "dtype": "bfloat16",
       "moe": {"num_experts": 8, "top_k": 4, "d_ff_expert": 32,
               "capacity_factor": 2.0}}
# set from the smoke cells' readings on the CPU, seeds 1-8: the program's
# largest gap_max 0.067, gap_mean 0.0026, logit_err_max 0.063,
# logit_err_mean 0.0107; the dense cell's control (fp8) at least 0.26 /
# 0.086 in logit_err_max / logit_err_mean on seeds 1-4; every planted
# fault in the dense cell at least 1.4 in gap_max, 0.27 in gap_mean
LIMITS = {"gap_max": 0.4, "gap_mean": 0.05, "logit_err_max": 0.15,
          "logit_err_mean": 0.03}
# the mixture-of-experts cell holds the granite cell's two numbers (tied
# embeddings: greedy tokens on random weights often repeat their input,
# so a fault that repeats it shows only where it differs). Set from its
# readings on the CPU with a sample of about 120 served tokens (a 4-s
# window), three processes at a time: the program's gap_max at most
# 0.0985 and logit_err_mean at most 0.0031 over seeds 1-12; half the
# batch left out at least 0.174 / 0.0136, the state left unchanged at
# least 0.182 / 0.033 (seeds 1-12), the handoff left out and the first
# token altered at least 0.56 / 0.063 (seeds 1-4)
MOE_LIMITS = {"gap_max": 0.15, "logit_err_mean": 0.007}
CELLS = {"dense.open": ("dense-smoke", "open"),
         "moe.closed": ("moe-smoke", "closed")}
WINDOW_S = {"dense.open": 2.0, "moe.closed": 4.0}


def cell_limits(name: str):
    """The limits the smoke cell ``name`` holds."""
    return MOE_LIMITS if name == "moe.closed" else LIMITS


def folder_digest(folder: Path) -> str:
    """Every file's name and bytes under ``folder``, caches left out."""
    h = hashlib.sha256()
    for f in sorted(folder.rglob("*")):
        if f.is_file() and "__pycache__" not in f.parts:
            h.update(str(f.relative_to(folder)).encode() + f.read_bytes())
    return h.hexdigest()


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make(root: Path) -> Path:
    pb = root / "portbench"
    for d in ("metrics", "archs"):
        shutil.copytree(PORTBENCH / d, pb / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for p in (DENSE, MOE):
        write(pb / "configs" / f"{p['name']}.json", {"port": p})
    write(pb / "traffic" / "open.json",
          {"arrivals": {"process": "poisson", "rate": 40.0},
           "isl": {"dist": "loguniform", "lo": 8, "hi": 24},
           "osl": {"dist": "loguniform", "lo": 3, "hi": 8}, "ramp_s": 1.0})
    write(pb / "traffic" / "closed.json",
          {"arrivals": {"process": "closed", "clients": 6},
           "isl": {"dist": "uniform", "lo": 8, "hi": 24},
           "osl": {"dist": "uniform", "lo": 3, "hi": 8}, "pool": 6,
           "ramp_s": 1.0})
    cell = {"pools": {"prefill": {"engines": 1, "slots": 1},
                      "decode": {"engines": 1, "slots": 4}},
            "block_size": 8, "scheduler": {"class": "FCFSScheduler"},
            "router": {"class": "RoundRobinRouter"},
            "check": {"served_tokens": 24, "max_requests": 6,
                      "min_served_tokens": 3, "limits": LIMITS}}
    write(pb / "cells" / "dense.open.json", cell)
    cell["check"] = {"served_tokens": 120, "max_requests": 24,
                     "min_served_tokens": 3, "limits": MOE_LIMITS}
    write(pb / "cells" / "moe.closed.json", cell)
    e2e = [{"name": "itl_p90_s", "unit": "s", "better": "lower",
            "bound": 0.1, "source": "host_clock"},
           {"name": "output_tokens_per_s", "unit": "tokens/s",
            "better": "higher", "bound": 0.1, "source": "host_clock"},
           {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
            "source": "host_clock"}]
    per = [{"name": "model.mfu.tput", "unit": "%", "better": "higher",
            "source": "program_span", "layer": "model step",
            "moves": "output_tokens_per_s"}]
    write(root / "BENCHMARK.json", {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"],
        "run_seconds": 2,
        "configs": [{"name": n, "source": "smoke",
                     "file": f"portbench/configs/{n}.json", "reduced": [],
                     "why": "smoke"} for n in ("dense-smoke", "moe-smoke")],
        "workloads": [{"name": c, "config": m, "traffic": t, "chips": 1,
                       "why": "smoke"} for c, (m, t) in CELLS.items()],
        "end_to_end": e2e, "per_layer": per})
    return root
