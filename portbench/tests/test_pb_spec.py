"""BENCHMARK.json against the contract's rules, and the files it names."""

import re
from pathlib import Path

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
TEXT = re.compile(r"[^\t\n\r]{1,200}")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$)")


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w and TEXT.fullmatch(w)
               for w in BENCH["command"])
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(Path(spec.BENCHMARK).read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    names = [e["name"] for e in _metrics()]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert spec.NAME.fullmatch(name), name
    for e in _metrics():
        assert spec.UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]] + [e["layer"] for e in BENCH["per_layer"]]):
        assert TEXT.fullmatch(text), text


def test_metric_entries():
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in BENCH["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert e["moves"] in e2e
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        reported = [e["name"] for e in spec.metrics_of(BENCH, cell, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(BENCH, cell, True)
    for e in _metrics():
        assert set(e.get("workloads", cells)) <= set(cells)


def test_configs_and_cells_name_files_that_exist():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["reduced"] == spec.load_config(c["name"])["reduced"]
        assert not any(WIDTH.search(key) for key in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        traffic = spec.load_traffic(w["traffic"])
        assert (spec.DRIVERS / f"{traffic['driver']}.py").is_file()
        assert spec.load_limits(w["name"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_every_metric_has_a_reader():
    for e in _metrics():
        assert callable(spec.load_metric(e["name"]).read)


def test_a_metric_is_found_by_its_file_name(tmp_path):
    (tmp_path / "made_up.ms-1.py").write_text("def read(ctx):\n    return ctx * 2\n")
    assert spec.load_metric("made_up.ms-1", tmp_path).read(21) == 42
    with pytest.raises(ValueError):
        spec.load_metric("../outside", tmp_path)
