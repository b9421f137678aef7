"""Import hygiene: the harness loads neither JAX nor the JAX package, and
the reference, with every architecture's module under ``archs/``, loads
nothing of the program. Each import runs in a fresh
interpreter; top-level module names are compared whole."""
import json
import subprocess
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent.parent
SRC = PORTBENCH.parent / "src"

PROBE = """
import json, runpy, sys
sys.path[:0] = {paths!r}
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str):
    code = PROBE.format(paths=[str(PORTBENCH), str(SRC)], body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded(
        "runpy.run_path(%r, run_name='portbench_run')\n"
        "import pbench.cell, pbench.check, pbench.reference, pbench.spec,"
        " pbench.trace, pbench.wall, pbench.counts\n"
        "from pbench import spec\n"
        "for m in spec.load()['per_layer'] + spec.load()['end_to_end']:\n"
        "    spec.reader(m['name'])\n"
        "import repro_torch.serving.cluster, repro_torch.serving.engine\n"
        % str(PORTBENCH / "run.py"))
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    archs = sorted(f.stem for f in (PORTBENCH / "archs").glob("*.py"))
    assert "decoder" in archs
    mods = loaded("import pbench.reference, pbench.check, pbench.weights,"
                  " pbench.counts\n"
                  "from pbench import spec\n"
                  f"for a in {archs!r}:\n"
                  "    spec.arch(a).Reference\n")
    assert "torch" in mods
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_run_refuses_a_process_that_loaded_jax_package_names():
    sys.path.insert(0, str(PORTBENCH))
    try:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "portbench_run_guard", PORTBENCH / "run.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(PORTBENCH))
    fake = {"repro": object(), "repro.core": object(),
            "repro_torch": object(), "jaxfoo": object()}
    saved = {k: sys.modules.get(k) for k in fake}
    try:
        sys.modules.update(fake)
        found = mod.forbidden_modules()
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    assert "repro" in found
    assert "repro_torch" not in found and "jaxfoo" not in found
