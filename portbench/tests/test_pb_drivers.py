"""Drivers, loaded by the name a traffic mix gives under "driver", and the
cell's chip count that each receives."""

import types

import pytest
import torch

from portbench import drivers, spec

DRIVERS = sorted(p.stem for p in spec.DRIVERS.glob("*.py") if p.stem != "__init__")


def test_every_driver_file_defines_a_driver_and_every_mix_names_one():
    assert {"program", "scenarios"} <= set(DRIVERS)
    assert all(callable(spec.load_driver(name).Driver) for name in DRIVERS)
    used = {spec.load_traffic(w["traffic"])["driver"] for w in spec.load_benchmark()["workloads"]}
    assert used <= set(DRIVERS)


@pytest.mark.parametrize("name", ["scenarios", "program"])
def test_a_one_chip_driver_given_four_chips_raises_before_its_first_call(name):
    # A problem with nothing in it: a driver that touched it before the
    # check would raise AttributeError, not the chip count's ValueError.
    empty = types.SimpleNamespace()
    traffic = dict(spec.load_traffic("b256" if name == "scenarios" else "single"), driver=name)
    config = spec.load_config("sdp_n100_m100")
    with pytest.raises(ValueError, match="one chip; the cell asks for 4"):
        drivers.make(config, traffic, "cpu", torch.float64, 4, empty)


@pytest.mark.parametrize("name", ["scenarios", "program"])
def test_a_one_chip_driver_runs_the_class_it_is_given(name):
    problem = spec.load_problem("dense_sdp")
    config = dict(spec.load_config("sdp_n100_m100"), n=6, m=4)
    config["solver"] = dict(config["solver"], max_iterations=30)
    traffic = (dict(spec.load_traffic("b256"), batch=2, pool=1) if name == "scenarios"
               else dict(spec.load_traffic("single"), pool=2, chunk=2))
    driver = drivers.make(config, traffic, "cpu", torch.float64, 1, problem)
    assert type(driver).__module__ == f"portbench.drivers.{name}"
    recs = [driver.call(i) for i in range(driver.cycle)]
    programs = driver.account(recs)
    assert programs.iterations.size == 2 and driver.iterations(recs[-1]) >= 1
    assert [a.chunk for a in driver.answers(recs)] == [0] * len(recs)


def test_a_driver_is_found_by_its_file_name(tmp_path):
    (tmp_path / "ranks_demo.py").write_text(
        "class Driver:\n"
        "    def __init__(self, problem, config, traffic, device, dtype, chips):\n"
        "        self.chips = chips\n")
    assert spec.load_driver("ranks_demo", tmp_path).Driver(None, {}, {}, "cpu", None, 4).chips == 4
    with pytest.raises(ValueError):
        spec.load_driver("../outside", tmp_path)


def test_a_call_without_chips_or_class_gets_one_chip_and_the_configurations_class():
    # chip_smoke.py's phase 4i calls drivers.make(config, traffic, device, dtype).
    config = dict(spec.load_config("sdp_n100_m100"), n=6, m=4)
    traffic = dict(spec.load_traffic("b256"), batch=2, pool=1)
    driver = drivers.make(config, traffic, "cpu", torch.float64)
    assert driver.problem.__name__ == "portbench.problems.dense_sdp"
    assert driver.cycle == 1 and driver.chunk_size == 2
