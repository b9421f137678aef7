"""The port's static passes (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU.

Both are stdlib-only AST passes and the port's are copies of the
reference's, so on the same tree under the same policy they give the same
findings, compared with ``==``: rule, module, detail, line and path, and
the whole ``to_json()`` record apart from its wall-clock ``timings``. The
one name that differs by design is the hash-stability pass's target
module (``repro.sweeps.spec`` against ``repro_torch.sweeps.spec``), which
is mapped before the comparison.

Each fixture mini-repo of the reference's ``tests/test_analysis.py`` is
written once and run through both ``run_analysis``; each case also keeps
the reference's own assertion on what it must find. Then come the rules
only the port has (torch is a framework its contracts and layering
guard; nothing of ``repro_torch`` may import jax or ``repro``), the
whole-repo runs under either policy, the CLI, and the import hygiene of
the passes themselves.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

import repro.analysis as JA
from repro.analysis import __main__ as JM
from repro.analysis.units import parse_unit_str as jparse_unit_str
from repro.analysis.units import unit_from_name as junit_from_name
from repro_torch import analysis as PA
from repro_torch.analysis import __main__ as PM
from repro_torch.analysis.contracts import check_contracts
from repro_torch.analysis.hashstab import check_hash_stability
from repro_torch.analysis.hotpath import check_hotpath
from repro_torch.analysis.imports import scan_modules
from repro_torch.analysis.report import Violation, apply_baseline
from repro_torch.analysis.units import (check_units, parse_unit_str,
                                        unit_from_name)

ROOT = pathlib.Path(__file__).resolve().parents[1]
with open(PM.DEFAULT_POLICY) as _f:
    PORT_POLICY = json.load(_f)
with open(JM.DEFAULT_POLICY) as _f:
    REF_POLICY = json.load(_f)


def write_tree(tmp_path, files):
    """Write ``{relpath: source}`` under ``tmp_path``."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src), encoding="utf-8")


def _map_ref(text: str) -> str:
    return text.replace("repro.sweeps.spec", "repro_torch.sweeps.spec")


def _rows(res, mapped=False):
    out = [(v.rule, v.module, v.detail, v.lineno, v.path)
           for v in res.violations + res.baselined]
    return [(r, _map_ref(m), d, n, p) for r, m, d, n, p in out] \
        if mapped else out


def _record(res, mapped=False):
    rec = res.to_json()
    del rec["timings"]
    return json.loads(_map_ref(json.dumps(rec))) if mapped else rec


def run_both(root, policy, baseline=None, files=None):
    """The same call through both packages; asserts they agree and
    returns the port's result."""
    ref = JM.run_analysis(root, policy, baseline, files=files)
    port = PM.run_analysis(root, policy, baseline, files=files)
    assert _rows(port) == _rows(ref, mapped=True)
    assert _record(port) == _record(ref, mapped=True)
    assert set(port.timings) == set(ref.timings)
    return port


# ---------------------------------------------------------------------------
# fixtures of the reference's tests/test_analysis.py, as cases


JAX_FREE_RULE = {"name": "jax-free", "modules": ["app.serve*"],
                 "forbid": ["jax"], "allow": ["type_checking", "lazy"],
                 "transitive": True}


def _imports(*rules):
    return {"roots": ["src"], "import_rules": list(rules)}


def _det(checks, modules=("app.*",)):
    return {"roots": ["src"], "determinism": [
        {"name": "g", "modules": list(modules), "checks": checks}]}


UNITS = {"roots": ["src"], "units": {"modules": ["app.*"], "names": {}}}

_PROTO_SRC = """\
    from typing import Protocol

    class SchedulerPolicy(Protocol):
        def select(self, cluster, engine): ...
        def run_prefill(self, cluster, engine, req): ...

    class Router(Protocol):
        def route(self, cluster, req, src): ...
    """

CONTRACTS = {"roots": ["src"], "contracts": {
    "protocol_modules": ["app.proto"],
    "protocols": ["SchedulerPolicy", "Router"],
    "purity": ["SchedulerPolicy", "Router"],
    "protected_params": ["cluster", "engine", "eng", "src", "req"],
    "mutation_allow": {"*": ["migrate", "requeue_inflight", "retire"],
                       "run_prefill": ["prefill"]},
    "exempt": []}}
CONTRACTS_EXEMPT = json.loads(json.dumps(CONTRACTS))
CONTRACTS_EXEMPT["contracts"]["exempt"] = ["app.fixtures"]

HOTPATH = {"roots": ["src"], "hotpath": {
    "modules": ["app.loop", "app.policy"],
    "roots": ["Cluster.serve"],
    "fleet_calls": ["engines", "decode_capable_healthy"],
    "fleet_attrs": ["pools"]}}


def _hash_policy(tamper):
    cfg = json.loads(json.dumps(PORT_POLICY["hash_stability"]))
    if tamper:
        cfg["spec_hash"] = "0" * 16
        cfg["spec_canonical_keys"].append("new_field")
    return {"roots": ["src"], "hash_stability": cfg}


_WALL = "wallclock|app.engine|time.time()"

# name -> (files, policy, expected (rule, module, lineno[, detail
#          substring]), substrings every finding's detail must hold, extra
#          run_analysis arguments)
CASES = {
    "import-kinds": (
        {"src/app/serve.py": """\
            from typing import TYPE_CHECKING
            import numpy as np
            if TYPE_CHECKING:
                import jax
            def go():
                import jax.numpy as jnp
                return jnp
            """},
        _imports({"name": "every-kind", "modules": ["app.*"],
                  "forbid": ["jax", "numpy"], "allow": []}),
        [("forbidden-import", "app.serve", 2, "'numpy' (eager)"),
         ("forbidden-import", "app.serve", 4, "'jax' (type_checking)"),
         ("forbidden-import", "app.serve", 6, "'jax.numpy' (lazy)")],
        [], {}),
    "eager-jax-in-protected-module": (
        {"src/app/serve_bad.py": "import jax.numpy as jnp\n",
         "src/app/serve_ok.py": """\
            from typing import TYPE_CHECKING
            if TYPE_CHECKING:
                import jax
            def go():
                import jax
                return jax
            """},
        _imports(JAX_FREE_RULE),
        [("forbidden-import", "app.serve_bad", 1)],
        ["'jax.numpy'", "eager"], {}),
    "transitive-chain": (
        {"src/app/serve_a.py": "from app import helper\n",
         "src/app/serve_b.py": "def go():\n    from app import helper\n",
         "src/app/helper.py": "import jax\n"},
        _imports(JAX_FREE_RULE),
        [("forbidden-import-transitive", "app.serve_a", 0)],
        ["app.serve_a -> app.helper -> jax"], {}),
    "one-finding-per-line": (
        {"src/app/serve.py": "from jax.numpy import cos, dot, exp\n"},
        _imports(JAX_FREE_RULE),
        [("forbidden-import", "app.serve", 1)], ["'jax.numpy'"], {}),
    "syntax-error": (
        {"src/app/serve.py": "def broken(:\n"},
        _imports(JAX_FREE_RULE),
        [("syntax-error", "app.serve", 1)], [], {}),
    "relative-imports": (
        {"src/app/__init__.py": "",
         "src/app/serve_x.py": "from . import kern\n",
         "src/app/kern.py": "import jax\n"},
        _imports({"name": "no-kern", "modules": ["app.serve*"],
                  "forbid": ["app.kern"], "allow": ["type_checking"]}),
        [("forbidden-import", "app.serve_x", 1)], [], {}),
    "unseeded-rng": (
        {"src/app/engine.py": """\
            import numpy as np
            bad = np.random.default_rng()
            good = np.random.default_rng(17)
            """},
        _det(["unseeded-rng"]), [("unseeded-rng", "app.engine", 2)], [], {}),
    "global-rng": (
        {"src/app/engine.py": """\
            import random
            import numpy as np
            from random import shuffle
            a = np.random.randint(0, 10)
            b = random.random()
            shuffle([1, 2])
            """},
        _det(["global-rng"]),
        [("global-rng", "app.engine", n) for n in (4, 5, 6)], [], {}),
    "wallclock": (
        {"src/app/engine.py": """\
            import time
            from datetime import datetime
            from time import perf_counter
            t0 = time.time()
            t1 = perf_counter()
            t2 = datetime.now()
            """},
        _det(["wallclock"]),
        [("wallclock", "app.engine", n) for n in (4, 5, 6)], [], {}),
    "json-sort-keys": (
        {"src/app/store.py": """\
            import json
            a = json.dumps({"k": 1})
            b = json.dumps({"k": 1}, sort_keys=True)
            """},
        _det(["json-sort-keys"]), [("json-sort-keys", "app.store", 2)],
        ["sort_keys=True"], {}),
    "set-order": (
        {"src/app/store.py": """\
            items = list(set([3, 1, 2]))
            for x in {"a", "b"}:
                print(x)
            ok = sorted(set([3, 1, 2]))
            """},
        _det(["set-order"]),
        [("set-order", "app.store", 1), ("set-order", "app.store", 2)],
        [], {}),
    "float-sum-only-in-frontier-group": (
        {"src/app/pareto.py": "area = sum([0.1] * 10)\n",
         "src/app/other.py": "n = sum([1, 2])\n"},
        _det(["float-sum"], modules=("app.pareto",)),
        [("float-sum", "app.pareto", 1)], ["math.fsum"], {}),
    "unit-mismatch-add": (
        {"src/app/perf.py": """\
            def f(lat_s, size_bytes, other_s):
                bad = lat_s + size_bytes
                ok1_s = lat_s + other_s
                ok2_s = lat_s + 0.5
                return ok1_s
            """},
        UNITS, [("unit-mismatch-add", "app.perf", 2)], ["'s' + 'bytes'"],
        {}),
    "unit-mismatch-compare-and-minmax": (
        {"src/app/perf.py": """\
            def f(lat_s, size_bytes):
                if lat_s > size_bytes:
                    pass
                worst = max(lat_s, size_bytes)
                fine = max(lat_s, 0.0)
                return worst, fine
            """},
        UNITS, [("unit-mismatch-compare", "app.perf", 2),
                ("unit-mismatch-compare", "app.perf", 4)], [], {}),
    "unit-return-mismatch": (
        {"src/app/perf.py": """\
            def total_s(size_bytes):
                return size_bytes

            def fine_s(lat_s):
                return lat_s * 2
            """},
        UNITS, [("unit-return-mismatch", "app.perf", 2)], ["total_s()"],
        {}),
    "unit-bind-mismatch": (
        {"src/app/perf.py": """\
            def f(size_bytes, xfer_bw):
                lat_s = size_bytes * 2
                ok_s = size_bytes / xfer_bw
                return lat_s, ok_s
            """},
        UNITS, [("unit-bind-mismatch", "app.perf", 2)],
        ["'lat_s' declares 's'"], {}),
    "unit-unsuffixed-bind": (
        {"src/app/perf.py": """\
            def f(a_s, b_s, n_flops):
                exposed = a_s + b_s
                exposed_s = a_s + b_s
                work = n_flops * 2
                return exposed, exposed_s, work
            """},
        UNITS, [("unit-unsuffixed-bind", "app.perf", 2)], ["'exposed'"], {}),
    "unit-unknown-operand-silences": (
        {"src/app/perf.py": """\
            def f(lat_s, mystery):
                out = lat_s + mystery
                return out
            """},
        UNITS, [], [], {}),
    "contract-signature-drift": (
        {"src/app/proto.py": _PROTO_SRC,
         "src/app/impl.py": """\
            class Drifted:
                def select(self, cluster):
                    return None
                def run_prefill(self, cluster, engine, req):
                    return 0, None

            class Extra:
                def select(self, cluster, engine, boost=1.0):
                    return None
                def run_prefill(self, cluster, engine, req):
                    return 0, None
            """},
        CONTRACTS, [("contract-signature", "app.impl", 2)],
        ["Drifted.select"], {}),
    "contract-mutation": (
        {"src/app/proto.py": _PROTO_SRC,
         "src/app/impl.py": """\
            class Evil:
                def select(self, cluster, engine):
                    cluster.now = 0.0
                    cluster.queue.pop()
                    return None
                def run_prefill(self, cluster, engine, req):
                    return engine.prefill(req)

            class Good:
                def select(self, cluster, engine):
                    cluster.requeue_inflight(engine)
                    return None
                def run_prefill(self, cluster, engine, req):
                    return engine.prefill(req)
            """},
        CONTRACTS, [("contract-mutation", "app.impl", 3),
                    ("contract-mutation", "app.impl", 4)],
        ["Evil.select"], {}),
    "contract-mutation-through-pool-alias": (
        {"src/app/proto.py": _PROTO_SRC,
         "src/app/impl.py": """\
            class Sneaky:
                def route(self, cluster, req, src):
                    for pool in (cluster.prefill_pool, cluster.decode_pool):
                        if src in pool:
                            pool.remove(src)
                    return None
            """},
        CONTRACTS, [("contract-mutation", "app.impl", 5)], [".remove()"],
        {}),
    "contract-determinism-scoped-to-hooks": (
        {"src/app/proto.py": _PROTO_SRC,
         "src/app/impl.py": """\
            import time
            import numpy as np

            T0 = time.time()

            class Impatient:
                def select(self, cluster, engine):
                    deadline = time.time()
                    rng = np.random.default_rng()
                    return None
                def run_prefill(self, cluster, engine, req):
                    return engine.prefill(req)
            """},
        CONTRACTS, [("contract-unseeded-rng", "app.impl", 9),
                    ("contract-wallclock", "app.impl", 8)],
        ["Impatient.select"], {}),
    "contract-jax-import": (
        {"src/app/proto.py": _PROTO_SRC,
         "src/app/impl_lazy.py": """\
            class Heavy:
                def route(self, cluster, req, src):
                    import jax
                    return None
            """,
         "src/app/impl_eager.py": """\
            import jax

            class Eager:
                def route(self, cluster, req, src):
                    return None
            """},
        CONTRACTS, [("contract-jax-import", "app.impl_eager", 1),
                    ("contract-jax-import", "app.impl_lazy", 3)],
        ["(the serving runtime is jax-free)"], {}),
    "contract-base-chain": (
        {"src/app/proto.py": _PROTO_SRC,
         "src/app/impl.py": """\
            class Base:
                def select(self, cluster, engine):
                    return None
                def run_prefill(self, cluster, engine, req):
                    return engine.prefill(req)

            class Child(Base):
                def select(self, cluster):
                    return None
            """},
        CONTRACTS, [("contract-signature", "app.impl", 8)], ["Child.select"],
        {}),
    "contract-exempt-modules": (
        {"src/app/proto.py": _PROTO_SRC,
         "src/app/fixtures.py": """\
            class DeliberatelyEvil:
                def route(self, cluster, req, src):
                    cluster.queue.pop()
                    return None
            """},
        CONTRACTS_EXEMPT, [], [], {}),
    "hotpath-scans-and-allocs": (
        {"src/app/loop.py": """\
            class Cluster:
                def serve(self):
                    return self._step()

                def _step(self):
                    for e in self.engines():
                        pass
                    order = sorted(self.engines())
                    return order

                def engines(self):
                    return []

            def cold_report(cluster):
                for e in cluster.engines():
                    pass
                return sorted(cluster.engines())
            """},
        HOTPATH, [("hotpath-alloc", "app.loop", 8),
                  ("hotpath-scan", "app.loop", 6),
                  ("hotpath-scan", "app.loop", 8)], ["Cluster."], {}),
    "hotpath-dispatch-by-name": (
        {"src/app/loop.py": """\
            class Cluster:
                def serve(self):
                    return self.scheduler.select(self, None)
            """,
         "src/app/policy.py": """\
            class Policy:
                def select(self, cluster, engine):
                    return [e for e in cluster.decode_capable_healthy()]
            """},
        HOTPATH, [("hotpath-alloc", "app.policy", 3),
                  ("hotpath-scan", "app.policy", 3)], ["Policy.select"], {}),
    "baseline-budget-fails-on-growth": (
        {"src/app/engine.py": """\
            import time
            t0 = time.time()
            t1 = time.time()
            t2 = time.time()
            """},
        _det(["wallclock"]), [("wallclock", "app.engine", 4)], [],
        {"baseline": {_WALL: 2}}),
    "files-filter": (
        {"src/app/serve_a.py": "import jax\n",
         "src/app/serve_b.py": "import jax\n"},
        _imports(JAX_FREE_RULE), [("forbidden-import", "app.serve_a", 1)],
        [], {"files": ["src/app/serve_a.py"]}),
    "multiple-roots": (
        {"ra/src/app/serve_a.py": "import jax\n",
         "rb/src/app/serve_b.py": "import jax\n"},
        _imports(JAX_FREE_RULE), [("forbidden-import", "app.serve_a", 1),
                                  ("forbidden-import", "app.serve_b", 1)],
        [], {"roots": ["ra", "rb"]}),
    "hash-pins-hold": (
        {"src/app/__init__.py": ""}, _hash_policy(False), [], [], {}),
    "hash-pin-tampered": (
        {"src/app/__init__.py": ""}, _hash_policy(True),
        [("hash-stability", "repro_torch.sweeps.spec", 0)] * 2,
        ["drifted"], {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fixture_findings_equal_reference(tmp_path, name):
    files, policy, expect, substrings, extra = CASES[name]
    write_tree(tmp_path, files)
    roots = [str(tmp_path / r) for r in extra.get("roots", ["."])]
    root = roots[0] if len(roots) == 1 else roots
    wanted = [str(tmp_path / f) for f in extra["files"]] \
        if "files" in extra else None
    res = run_both(root, policy, extra.get("baseline"), files=wanted)
    got = sorted(res.violations, key=lambda v: (v.rule, v.module, v.lineno))
    assert [(v.rule, v.module, v.lineno) for v in got] == \
        sorted(e[:3] for e in expect)
    for v, e in zip(got, sorted(expect)):
        assert e[3:] == () or e[3] in v.detail, v.detail
    for v in res.violations:
        assert all(s in v.detail for s in substrings), v.detail
    if "baseline" in extra:
        assert len(res.baselined) == 2 and not res.ok
    if "files" in extra:            # hash stability skipped, still timed
        assert "hashstab" in res.timings


def test_unit_grammar_equals_reference():
    reg_src = {"latency": "s", "isl": "tokens", "cost": "usd",
               "peak": "flops/s"}
    reg = {k: parse_unit_str(u) for k, u in reg_src.items()}
    jreg = {k: jparse_unit_str(u) for k, u in reg_src.items()}
    names = ["exposed_s", "kv_total_bytes", "tokens_per_s", "hbm_bw",
             "bytes_per_chip", "_prefill_latency", "plain_name",
             "cost_per_hour", "tput_per_dollar", "flops_per_s_per_chip",
             "step_ms", "n_flops", "isl", "ctx_tokens", "x_per_token"]
    assert [unit_from_name(n, reg) for n in names] \
        == [junit_from_name(n, jreg) for n in names]
    assert unit_from_name("tokens_per_s", reg) == {"tokens": 1, "s": -1}
    assert unit_from_name("bytes_per_chip", reg) == {"bytes": 1}
    assert unit_from_name("_prefill_latency", reg) == {"s": 1}
    assert unit_from_name("plain_name", reg) is None
    for s in ("bytes/s", "flops_per_s", "", "s*tokens/usd/hour"):
        assert parse_unit_str(s) == jparse_unit_str(s)
    with pytest.raises(ValueError):
        parse_unit_str("furlongs")


def test_baseline_apply_equals_reference():
    v = Violation("wallclock", "app.engine", "time.time()")
    jv = JA.Violation("wallclock", "app.engine", "time.time()")
    assert v.fingerprint == jv.fingerprint == _WALL
    assert v.format() == jv.format()
    for n in (1, 2, 3):
        new, acc = apply_baseline([v] * n, {_WALL: 2})
        assert (len(new), len(acc)) == (max(0, n - 2), min(n, 2))


# ---------------------------------------------------------------------------
# the CLI


def test_cli_exit_codes_json_and_write_baseline_equal_reference(
        tmp_path, capsys):
    write_tree(tmp_path, {"src/app/serve.py": "import jax\n"})
    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps(_imports(JAX_FREE_RULE)))
    outs = {}
    for tag, main in (("ref", JM.main), ("port", PM.main)):
        base = tmp_path / f"{tag}_baseline.json"
        args = ["--root", str(tmp_path), "--policy", str(policy),
                "--baseline", str(base), "--json"]
        assert main(args) == 1
        first = json.loads(capsys.readouterr().out)
        assert not first["ok"]
        assert [v["rule"] for v in first["violations"]] == \
            ["forbidden-import"]
        assert main(args[:-1] + ["--write-baseline"]) == 0
        wrote = capsys.readouterr().out
        assert main(args) == 0
        second = json.loads(capsys.readouterr().out)
        assert second["ok"] and len(second["baselined"]) == 1
        assert main(args[:-1]) == 0
        summary = capsys.readouterr().out.strip().splitlines()[-1]
        for rec in (first, second):
            del rec["timings"]
        outs[tag] = (first, second, wrote.replace(str(base), "<b>"),
                     base.read_text(), summary)
    assert outs["port"][:4] == outs["ref"][:4]
    assert "TODO" in outs["port"][3]            # new entries need a why
    assert outs["port"][4] == outs["ref"][4].replace("repro.", "repro_torch.")
    assert outs["port"][4].startswith("repro_torch.analysis: 1 modules")


def test_write_baseline_keeps_why_annotations(tmp_path):
    path = tmp_path / "baseline.json"
    v = Violation("wallclock", "app.engine", "time.time()")
    PA.write_baseline(str(path), [v, v])
    data = json.loads(path.read_text())
    data["accepted"][0]["why"] = "report-only telemetry"
    path.write_text(json.dumps(data))
    PA.write_baseline(str(path), [v])
    (entry,) = json.loads(path.read_text())["accepted"]
    assert entry["why"] == "report-only telemetry" and entry["count"] == 1
    assert PA.load_baseline(str(path)) == {_WALL: 1}
    assert PA.load_baseline(str(tmp_path / "absent.json")) == {}


def test_cli_explain_equals_reference(capsys):
    assert set(PM.EXPLAIN) == set(JM.EXPLAIN)
    for rule in sorted(PM.EXPLAIN):
        assert PM.main(["--explain", rule]) == 0
        out = capsys.readouterr().out
        assert out.startswith(rule) and "why:" in out and "fix:" in out
    assert PM.main(["--explain", "no-such-rule"]) == 2
    assert "known rules" in capsys.readouterr().out
    assert "torch" in PM.EXPLAIN["contract-jax-import"][0]


# ---------------------------------------------------------------------------
# rules only the port has


_SPEC = (ROOT / "src/repro_torch/serving/speculative.py").read_text()
_SPEC_EAGER = _SPEC.replace("import numpy as np\n",
                            "import numpy as np\nimport torch\n", 1)
assert _SPEC_EAGER != _SPEC

PORT_IMPORTS = {"roots": ["src"],
                "import_rules": PORT_POLICY["import_rules"]}
TORCH_FREE = "[serving-runtime-torch-free]"
NO_JAX = "[port-imports-neither-jax-nor-reference]"

# name -> (files, policy, expected sorted (rule, module, lineno, detail
#          substring))
PORT_CASES = {
    "eager-torch-in-protected-module": (
        {"src/repro_torch/serving/cluster.py": "import torch\n",
         "src/repro_torch/serving/policies.py": """\
            from typing import TYPE_CHECKING
            if TYPE_CHECKING:
                import torch
            def go():
                import torch
                return torch
            """},
        PORT_IMPORTS,
        [("forbidden-import", "repro_torch.serving.cluster", 1,
          f"{TORCH_FREE} imports 'torch' (eager)")]),
    "jax-or-reference-import-in-port-any-kind": (
        {"src/repro_torch/models/x.py": """\
            from typing import TYPE_CHECKING
            import repro_torch.core
            if TYPE_CHECKING:
                from repro.core import paper_models
            def go():
                import jax.numpy as jnp
                return jnp
            """},
        PORT_IMPORTS,
        [("forbidden-import", "repro_torch.models.x", 4,
          f"{NO_JAX} imports 'repro.core' (type_checking)"),
         ("forbidden-import", "repro_torch.models.x", 6,
          f"{NO_JAX} imports 'jax.numpy' (lazy)")]),
    "transitive-chain-through-the-reference": (
        {"src/repro_torch/serving/cluster.py":
            "from repro.core import helper\n",
         "src/repro/core/helper.py": "import jax\n"},
        PORT_IMPORTS,
        [("forbidden-import", "repro_torch.serving.cluster", 1,
          f"{NO_JAX} imports 'repro.core' (eager)"),
         ("forbidden-import-transitive", "repro_torch.serving.cluster", 0,
          f"{TORCH_FREE} eagerly reaches 'jax' via "
          "repro_torch.serving.cluster -> repro.core.helper -> jax")]),
    "speculative-as-shipped-is-clean": (
        {"src/repro_torch/serving/speculative.py": _SPEC}, PORT_IMPORTS, []),
    "speculative-eager-torch-is-flagged": (
        {"src/repro_torch/serving/speculative.py": _SPEC_EAGER},
        PORT_IMPORTS,
        [("forbidden-import", "repro_torch.serving.speculative",
          _SPEC_EAGER.splitlines().index("import torch") + 1,
          f"{TORCH_FREE} imports 'torch' (eager)")]),
    "torch-import-in-policy-hook": (
        {"src/app/proto.py": _PROTO_SRC,
         "src/app/impl_lazy.py": """\
            class Heavy:
                def route(self, cluster, req, src):
                    import torch
                    return None
            """,
         "src/app/impl_eager.py": """\
            import torch.nn

            class Eager:
                def route(self, cluster, req, src):
                    return None
            """},
        CONTRACTS,
        [("contract-jax-import", "app.impl_eager", 1,
          "eagerly imports 'torch.nn' (the serving runtime is torch-free)"),
         ("contract-jax-import", "app.impl_lazy", 3,
          "Heavy.route imports 'torch' inside a policy hook (the serving "
          "runtime is torch-free)")]),
}


@pytest.mark.parametrize("name", sorted(PORT_CASES))
def test_port_only_rules(tmp_path, name):
    files, policy, expect = PORT_CASES[name]
    write_tree(tmp_path, files)
    res = PM.run_analysis(str(tmp_path), policy)
    got = sorted((v.rule, v.module, v.lineno, v.detail)
                 for v in res.violations)
    assert len(got) == len(expect), got
    for g, (rule, module, lineno, sub) in zip(got, sorted(expect)):
        assert g[:3] == (rule, module, lineno) and sub in g[3], g


def test_import_rules_forbid_on_a_dotted_boundary():
    from repro_torch.analysis.imports import _forbidden
    forbid = PORT_POLICY["import_rules"][1]["forbid"]
    assert _forbidden("repro", forbid) and _forbidden("repro.core", forbid)
    assert _forbidden("jax.numpy", forbid)
    assert not _forbidden("repro_torch", forbid)
    assert not _forbidden("repro_torch.serving.cluster", forbid)


# ---------------------------------------------------------------------------
# the whole repo


def test_repo_under_reference_policy_equals_reference():
    """Both packages' passes over this tree, the reference's policy, no
    baseline: the same findings (the reference's own, the port's
    deliberately impure test doubles among them)."""
    res = run_both(str(ROOT), REF_POLICY)
    assert res.checked_modules > 200 and res.violations


def test_repo_analysis_is_clean_under_port_policy():
    result = PM.run_analysis(PM.default_root(), PORT_POLICY,
                             PA.load_baseline(PM.DEFAULT_BASELINE))
    assert result.ok, [v.format() for v in result.violations]
    n_files = sum(1 for top in ("src", "tests")
                  for _ in (ROOT / top).rglob("*.py"))
    assert result.checked_modules == n_files
    assert len(result.baselined) == \
        sum(PA.load_baseline(PM.DEFAULT_BASELINE).values())


def test_port_findings_name_only_the_port():
    """No finding of the port's analysis names a module of the JAX
    package or a reference test."""
    result = PM.run_analysis(PM.default_root(), PORT_POLICY, None)
    assert result.violations
    for v in result.violations:
        assert v.module.startswith("repro_torch.") or \
            v.module.startswith("tests.test_torch_"), v.format()


def test_baseline_entries_live_and_annotated():
    with open(PM.DEFAULT_BASELINE) as f:
        accepted = json.load(f)["accepted"]
    for e in accepted:
        why = e.get("why", "")
        assert why.strip() and "TODO" not in why, e
    result = PM.run_analysis(PM.default_root(), PORT_POLICY, None)
    live = {}
    for v in result.violations:
        key = (v.rule, v.module, v.detail)
        live[key] = live.get(key, 0) + 1
    assert {(e["rule"], e["module"], e["detail"]): e["count"]
            for e in accepted} == live


def test_repo_clean_per_pass_modulo_baseline():
    root = PM.default_root()
    modules = scan_modules(root, PORT_POLICY["roots"])
    base = PA.load_baseline(PM.DEFAULT_BASELINE)
    for checker in (check_units, check_contracts, check_hotpath):
        vs = sorted(checker(modules, root, PORT_POLICY),
                    key=lambda v: (v.path, v.lineno, v.rule, v.detail))
        new, _ = apply_baseline(vs, dict(base))
        assert not new, [v.format() for v in new]


def test_port_policy_structure():
    rules = {r["name"]: r for r in PORT_POLICY["import_rules"]}
    assert list(rules) == ["serving-runtime-torch-free",
                           "port-imports-neither-jax-nor-reference",
                           "core-independent-of-serving",
                           "kernels-independent-of-serving"]
    free = rules["serving-runtime-torch-free"]
    ref_free = REF_POLICY["import_rules"][0]
    assert free["modules"] == ["repro_torch" + m[len("repro"):]
                               for m in ref_free["modules"]]
    assert {"repro_torch.analysis.*", "repro_torch.serving.speculative"} \
        <= set(free["modules"])
    assert free["forbid"][0] == "torch" and free["transitive"]
    assert rules["port-imports-neither-jax-nor-reference"]["allow"] == []
    assert PORT_POLICY["roots"] == ["src", "tests"]
    assert PORT_POLICY["contracts"]["exempt"] == [
        "repro", "repro.*", "tests.test_analysis",
        "tests.test_torch_analysis", "tests.test_torch_tracing"]
    assert [g["name"] for g in PORT_POLICY["determinism"]] == \
        ["serialized-paths", "frontier-accumulation"]


def test_hash_stability_holds_the_reference_pins():
    assert PORT_POLICY["hash_stability"] == REF_POLICY["hash_stability"]
    assert check_hash_stability(PORT_POLICY) == []


def test_package_exports_equal_reference():
    assert PA.__all__ == JA.__all__
    for name in PA.__all__:
        assert getattr(PA, name).__module__.startswith("repro_torch.")


def test_cli_runs_without_torch_or_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import sys, runpy; sys.argv = ['x', '--json']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "loaded = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'repro'))\n"
            "print(rc, loaded)")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    *report, last = out.stdout.strip().splitlines()
    assert last == "0 []"
    rec = json.loads("\n".join(report))
    assert rec["ok"] and not rec["violations"] and rec["baselined"]
