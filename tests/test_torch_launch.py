"""The port's launcher and its import hygiene.

``repro_torch`` imports torch and never jax, and nothing of the JAX package
``repro`` (its own copies of the framework-free modules stand in); its
launcher serves end to end on the CPU when asked to.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process, as elsewhere)
import pytest
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _forbidden(name: str) -> bool:
    """On a dotted boundary: ``repro`` and ``repro.x`` are forbidden,
    ``repro_torch`` is not."""
    return name.split(".")[0] in FORBIDDEN


def test_forbidden_matches_on_dotted_boundary():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("repro") and _forbidden("repro.serving.cluster")
    assert not _forbidden("repro_torch.serving.cluster")
    assert not _forbidden("jaxtyping_free") and not _forbidden("reprox")


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = [f"{p.relative_to(ROOT)}:{line}: {name}" for p in files
           for line, name in _imports(p) if _forbidden(name)]
    assert not bad, bad
    smoke = [name for _, name in _imports(ROOT / "chip_smoke.py")]
    assert not [n for n in smoke if _forbidden(n)], smoke


def test_launcher_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert; "
            "loaded = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not loaded, loaded; print('clean')")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_speculative_import_leaves_torch_and_jax_unloaded():
    """Speculative decoding sits in the serving runtime's torch-free set:
    torch and the model enter inside ``speculative_decode``."""
    code = ("import sys, repro_torch.serving.speculative; "
            "loaded = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro')); "
            "assert not loaded, loaded; print('clean')")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_launcher_serves_smoke_config_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "4", "--isl", "32", "--osl", "6"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "completed" in out.stdout
    rec = json.loads(out.stdout)
    assert rec["completed"] == 4 and rec["device"] == "cpu"
    assert rec["arch"] == "qwen2.5-3b-smoke" and rec["backend"] == "torch"
    assert rec["prefills"] == 4 and rec["transfers"] == 4
    assert rec["hardware"]["decode"] == {"gpu-h100": 2}


def _serve(*args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", *args],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


def test_launcher_serves_coloc_on_cpu():
    """One mixed pool, chunked prefill with decode piggybacked between
    chunks, kv-locality routing: nothing crosses engines."""
    rec = _serve("--mode", "coloc", "--requests", "4", "--isl", "32",
                 "--osl", "6", "--piggyback-chunk", "8")
    assert rec["completed"] == 4 and rec["mode"] == "coloc"
    assert rec["scheduler"] == "chunked-piggyback:8"
    assert rec["router"] == "kv-locality" and rec["rate_matcher"] == "none"
    assert rec["transfers"] == 0 and rec["prefills"] == 4
    assert rec["hardware"]["mixed"] == {"gpu-h100": 3}
    assert rec["capacity"] == 32 + 6 + 8        # 32 is whole chunks


def test_launcher_serves_prefix_affinity_sessions_on_cpu():
    """Multi-turn sessions with prefix-affine chunked prefill: every turn
    completes, later turns hit the prefix cache, and the capacity holds a
    turn's chunk pad."""
    rec = _serve("--mode", "coloc", "--scheduler", "prefix-affinity",
                 "--workload", "sessions", "--requests", "2", "--turns", "2",
                 "--isl", "32", "--osl", "4", "--piggyback-chunk", "8")
    assert rec["completed"] == 4 and rec["workload"] == "sessions"
    assert rec["scheduler"] == "prefix-affinity" and rec["prefix_hits"] > 0
    assert rec["capacity"] == 16 + 2 * (16 + 4) + 8 + 7


def test_launcher_refuses_prefix_affinity_without_chunks():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--scheduler",
                    "prefix-affinity", "--piggyback-chunk", "0"])


def test_launcher_main_in_process(capsys):
    from repro_torch.launch import serve
    rec = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                      "--isl", "16", "--osl", "4", "--workload", "burst",
                      "--rate-matcher", "static", "--router",
                      "least-loaded", "--scheduler", "priority"])
    assert rec["completed"] == 3 and rec["rate_matcher"] == "static"
    assert json.loads(capsys.readouterr().out)["completed"] == 3


def test_launcher_refuses_zero_decode_engines():
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="decode"):
        serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                    "--decode-engines", "0", "--rate-matcher", "none"])


def test_launcher_serves_rwkv_smoke_on_cpu():
    """``--arch rwkv6-1.6b --smoke``: disaggregated, dense engines, each
    request's whole recurrent state handed over (2 layers x (s: 2 heads x
    32 x 32 fp32 + tm_x, cm_x: 64 bf16 each) = 16,896 bytes)."""
    rec = _serve("--arch", "rwkv6-1.6b", "--requests", "4", "--isl", "32",
                 "--osl", "6", "--rate-matcher", "none")
    assert rec["completed"] == 4 and rec["arch"] == "rwkv6-1.6b-smoke"
    assert rec["mode"] == "disagg" and rec["prefills"] == 4
    assert rec["transfers"] == 4
    assert rec["transferred_MB"] * 2**20 == 4 * 16_896


@pytest.mark.parametrize("flags", [
    ("--mode", "coloc"),
    ("--scheduler", "prefix-affinity"),
])
def test_launcher_refuses_chunked_prefill_for_rwkv(flags, capsys):
    """RWKV prompts are never chunked: co-located piggybacking and the
    prefix cache are refused at start-up, with the reason."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                    *flags])
    assert "never chunked" in capsys.readouterr().err


def test_import_walk_covers_the_simulator_tracing_and_sanitizer():
    """The hygiene walk above reaches every module of the port, the
    analysis package and the simulator path included."""
    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"analysis/__init__.py", "analysis/sanitizer.py",
            "core/perf_model.py", "core/paper_models.py",
            "serving/simengine.py", "serving/metrics.py",
            "serving/tracing.py", "serving/obs.py",
            "workloads/trace.py"} <= walked


def test_sim_engine_construction_leaves_torch_unloaded():
    """``make_engine("sim")`` needs no params and imports no torch."""
    code = ("import sys; "
            "from repro_torch.serving.backends import make_engine; "
            "from repro_torch.core.paper_models import LLAMA31_8B; "
            "e = make_engine('sim', 0, LLAMA31_8B, paged=True, "
            "device='cuda'); "
            "e.prefill(__import__('numpy').arange(8)); "
            "loaded = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro')); "
            "assert not loaded, loaded; print('clean')")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_launcher_sim_backend_needs_no_card(monkeypatch, capsys, tmp_path):
    """``--backend sim`` at full width with no ``--device`` and no card:
    no params, no card asked for, and no field a sim engine cannot give;
    a chip with no fit is announced."""
    import torch
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = serve.main(["--backend", "sim", "--requests", "16", "--isl",
                      "512", "--osl", "64", "--slots", "8",
                      "--calibration-path", str(tmp_path / "none.json")])
    assert rec["completed"] == 16 and rec["backend"] == "sim"
    assert rec["arch"] == "qwen2.5-3b" and rec["capacity"] == 512 + 64 + 8
    for key in ("device", "prefills", "decode_steps", "mean_prefill_step_s",
                "mean_decode_step_s"):
        assert key not in rec
    assert rec["hardware"]["decode"] == {"gpu-h100": 2}
    assert "no calibration for qwen2.5-3b on h100" in capsys.readouterr().err


def test_launcher_sim_calibrate_on_cpu(tmp_path):
    path = tmp_path / "cal.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--backend", "sim", "--calibrate",
         "--calibration-path", str(path), "--requests", "4"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "# calibrated qwen2.5-3b-smoke/h100" in out.stderr
    assert "no calibration" not in out.stderr
    rec = json.loads(out.stdout)
    assert rec["completed"] == 4 and rec["backend"] == "sim"
    fit = json.loads(path.read_text())["qwen2.5-3b-smoke/gpu-h100"]
    assert fit["device"] == "cpu"
    assert fit["prefill_scale"] > 0 and fit["decode_scale"] > 0


def test_launcher_replays_a_trace_on_cpu():
    """``--trace`` overrides ``--workload``: all of burst.jsonl's requests
    are served by the torch engines."""
    rec = _serve("--trace", str(ROOT / "tests/data/traces/burst.jsonl"),
                 "--workload", "sessions")
    assert rec["workload"] == "trace" and rec["completed"] == 10
    assert rec["prefills"] == 10 and rec["device"] == "cpu"


def test_launcher_trace_out_writes_a_loadable_trace(tmp_path):
    from repro_torch.serving.obs import validate_trace
    path = tmp_path / "trace.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "4", "--isl", "32", "--osl", "6",
         "--trace-out", str(path)],
        env={**_env(), "REPRO_SANITIZE": "1"}, capture_output=True,
        text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"# trace: {path}" in out.stderr
    trace = json.loads(path.read_text())
    counts = validate_trace(trace)
    assert counts["b"] == counts["e"] > 0 and counts["X"] > 0
    tracks = {(e["pid"], e["tid"]) for e in trace["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert len(tracks) == 3         # one per engine: 1 prefill + 2 decode
    assert trace["otherData"]["metrics"]["completed"] == 4


def test_launcher_refuses_calibrate_without_sim(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--calibrate"])
    assert "--backend sim" in capsys.readouterr().err


# the port's record adds these to the reference's: its capacity, its prefix
# hits, and the bytes moved in every mode
PORT_ONLY = {"capacity", "prefix_hits", "transferred_MB"}


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
@pytest.mark.parametrize("flags", [
    ("--mode", "coloc"),
    ("--scheduler", "prefix-affinity", "--workload", "sessions", "--turns",
     "2"),
])
def test_launcher_sim_serves_what_the_reference_sim_serves(arch, flags,
                                                           capsys, tmp_path):
    """``--backend sim`` serves the never-chunked families co-located and
    prefix-affine, as the reference's launcher does (it always takes the
    smoke configuration, so the port is given ``--smoke``): the same
    record, the port's additions aside."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    common = ["--backend", "sim", "--arch", arch, "--requests", "4",
              "--prefill-chip", "h100", "--decode-chip", "h100",
              "--calibration-path", str(tmp_path / "none.json"), *flags]
    serve.main(["--smoke", *common])
    mine = json.loads(capsys.readouterr().out)
    jserve.main(common)
    ref = json.loads(capsys.readouterr().out)
    assert mine["completed"] > 0 and mine["arch"].startswith(arch[:5])
    assert set(mine) - set(ref) <= PORT_ONLY and set(ref) <= set(mine)
    assert {k: mine[k] for k in ref} == ref


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "mistral-large-123b"])
def test_launcher_refuses_models_larger_than_one_card(arch, monkeypatch,
                                                      capsys):
    """At full size their bf16 weights exceed one card's 80 GiB: the torch
    backend exits at start-up, before any parameter is allocated, naming
    the dry run that shows their sharding."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    def no_init(*args, **kw):
        raise AssertionError("parameters allocated")

    monkeypatch.setattr(transformer, "init_params", no_init)
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--device", "cpu", "--requests", "2"])
    err = capsys.readouterr().err
    assert f"repro_torch.launch.dryrun --arch {arch}" in err \
        and "80 GiB" in err


def test_launcher_refuses_llava_naming_the_frontends_slice(capsys):
    """Refused no longer: with its vision frontend ported, the start-up
    check passes llava-next-34b at both sizes (the full one's 68.9 GB of
    bf16 weights fit one card's 80 GiB), and its smoke configuration
    serves text prompts on the CPU, as the reference's engine does."""
    import argparse

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve
    args = argparse.Namespace(mode="disagg", scheduler="fcfs")
    for cfg in (get_config("llava-next-34b"),
                get_smoke_config("llava-next-34b")):
        assert serve.torch_refusal(cfg, args) is None
    rec = serve.main(["--arch", "llava-next-34b", "--smoke", "--device",
                      "cpu", "--requests", "2", "--isl", "16", "--osl", "4",
                      "--rate-matcher", "none"])
    assert rec["completed"] == 2 and rec["arch"] == "llava-next-34b-smoke"
    assert "frontends slice" not in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "mistral-large-123b",
                                  "musicgen-large", "llava-next-34b"])
def test_launcher_serves_the_new_smoke_configurations_on_cpu(arch):
    """``--smoke`` serves kimi's (an MoE with a shared expert), mistral's,
    musicgen's and llava's (text prompts) smoke configurations
    disaggregated on the CPU."""
    rec = _serve("--arch", arch, "--requests", "3", "--isl", "16", "--osl",
                 "4", "--rate-matcher", "none")
    from repro_torch.configs import get_smoke_config
    assert rec["completed"] == 3 and rec["transfers"] == 3
    assert rec["arch"] == get_smoke_config(arch).name


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "mistral-large-123b",
                                  "llava-next-34b", "musicgen-large"])
def test_launcher_sim_takes_the_new_ids_at_full_size(arch, tmp_path,
                                                      capsys):
    from repro_torch.launch import serve
    rec = serve.main(["--backend", "sim", "--arch", arch, "--requests", "4",
                      "--isl", "512", "--osl", "16", "--calibration-path",
                      str(tmp_path / "none.json")])
    assert rec["completed"] == 4 and rec["arch"] == arch


def test_the_engine_and_the_launcher_never_name_a_model_family():
    """Which layouts and paths a model takes is the model's
    (``transformer.supports_paged``, ``supports_chunked``): the serving
    engine and the launcher never compare a configuration's ``block`` with
    a family's name."""
    for rel in ("serving/engine.py", "launch/serve.py"):
        for node in ast.walk(ast.parse((PORT / rel).read_text())):
            if not isinstance(node, ast.Compare):
                continue
            sides = [node.left, *node.comparators]
            if not any(isinstance(s, ast.Attribute) and s.attr == "block"
                       for s in sides):
                continue
            names = [c.value for s in sides for c in ast.walk(s)
                     if isinstance(c, ast.Constant)
                     and isinstance(c.value, str)]
            assert not names, f"{rel}:{node.lineno}: block == {names}"
