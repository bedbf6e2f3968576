"""Nothing the benchmark runs imports jax or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import spec
from portbench.run import FORBIDDEN

PKG = Path(spec.PKG)


def _top_level_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_under_portbench_imports_jax_or_the_jax_package():
    found = {(str(p), name) for p in PKG.rglob("*.py") for name in _top_level_imports(p)
             if name in FORBIDDEN}
    assert not found


def test_the_names_are_compared_whole():
    names = {"conex_tpu_torch", "conex_tpu_torch.cones", "jaxtyping", "numpy"}
    assert not {n.split(".")[0] for n in names} & set(FORBIDDEN)


def test_importing_what_a_run_imports_loads_neither():
    code = (
        "import sys, importlib\n"
        "import portbench.run, portbench.harness, portbench.calibrate\n"
        "import conex_tpu_torch, conex_tpu_torch.solver.loop, conex_tpu_torch.parallel.sharded\n"
        "from portbench import spec\n"
        "for e in spec.load_benchmark()['end_to_end'] + spec.load_benchmark()['per_layer']:\n"
        "    spec.load_metric(e['name'])\n"
        "from portbench.run import forbidden_modules\n"
        "print(forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
