"""Problem classes, loaded by the name a configuration gives under "class"."""

import hashlib
import subprocess
import sys
import time

import pytest
import torch

from portbench import spec
from portbench.harness import run_cell

BENCH = spec.load_benchmark()
# sha256 over the bytes of A, C and b that make_chunk(0, chunk, 3, 6, 5,
# dtype, "cpu") gave before it moved into problems/dense_sdp.py.
DIGESTS = {
    (torch.float64, 0): "f5f598a54041a38a5879814df1d1d4f6f83ef249992657f3dde3255ca27a2a9b",
    (torch.float64, 1): "bee6ac7eb2a6972851566f01f9ad13a3911cd8bc62d109a25845e75b6c784592",
    (torch.float32, 0): "76c42530e871b10ded1d6d088ea14542f093c9f4ddb38af5abc8b72265220899",
    (torch.float32, 1): "41d944d13bf52256f1b73f15924931e811ec856efbbb87ca98a328abe3d225a6",
}


def _digest(parts):
    h = hashlib.sha256()
    for t in parts:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("dtype,chunk", sorted(DIGESTS, key=str), ids=str)
def test_dense_sdp_makes_the_programs_it_made_before(dtype, chunk):
    problem = spec.load_problem("dense_sdp")
    config = dict(spec.load_config("sdp_n100_m100"), n=6, m=5)
    parts = problem.make(config, 0, chunk, 3, dtype, "cpu")
    assert [tuple(t.shape) for t in parts] == [(3, 5, 6, 6), (3, 6, 6), (3, 5)]
    assert _digest(parts) == DIGESTS[dtype, chunk]
    assert _digest(problem.make_chunk(0, chunk, 3, 6, 5, dtype, "cpu")) == DIGESTS[dtype, chunk]


def test_every_configuration_names_a_class_that_holds_what_the_harness_calls():
    wanted = ("NUMBERS", "make", "scenario_batch", "scenario_start", "scenario_dual",
              "program", "program_dual", "gap", "sample", "judge")
    for c in BENCH["configs"]:
        problem = spec.problem_of(spec.load_config(c["name"]))
        assert all(hasattr(problem, name) for name in wanted), c["name"]


def test_the_limits_of_each_cell_are_its_class_numbers():
    for w in BENCH["workloads"]:
        problem = spec.problem_of(spec.load_config(w["config"]))
        assert set(spec.load_limits(w["name"])) == set(problem.NUMBERS)
    assert spec.load_problem("dense_sdp").NUMBERS == ("unsolved", "infeas", "schur")


def test_a_configuration_without_a_class_fails_loudly():
    cell = spec.workload(BENCH, "sdp_n100_m100.b256")
    config = spec.load_config(cell["config"])
    del config["class"]
    with pytest.raises(ValueError, match="names no problem class"):
        spec.problem_of(config)
    with pytest.raises(ValueError, match="names no problem class"):
        run_cell(BENCH, cell, 1, 0.1, False, "cpu", time.perf_counter(), config=config)


def test_a_class_is_found_by_its_file_name(tmp_path):
    (tmp_path / "made_up-1.py").write_text("NUMBERS = ('x',)\ndef make(*a):\n    return 7\n")
    problem = spec.problem_of({"class": "made_up-1"}, tmp_path)
    assert problem.NUMBERS == ("x",) and problem.make() == 7
    with pytest.raises(ValueError):
        spec.load_problem("../outside", tmp_path)
    with pytest.raises(FileNotFoundError):
        spec.problem_of({"class": "absent"}, tmp_path)


def test_loading_every_class_and_driver_loads_no_jax():
    code = (
        "import json\n"
        "from portbench import spec\n"
        "from portbench.run import forbidden_modules\n"
        "for p in spec.PROBLEMS.glob('*.py'):\n"
        "    spec.load_problem(p.stem)\n"
        "for p in spec.DRIVERS.glob('*.py'):\n"
        "    if p.stem != '__init__':\n"
        "        spec.load_driver(p.stem)\n"
        "import conex_tpu_torch, conex_tpu_torch.cones.lp\n"
        "print(json.dumps(forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
