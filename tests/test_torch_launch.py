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
