"""portbench: the benchmark of conex_tpu_torch on an NVIDIA GPU.

One cell (a configuration under a traffic mix, named in BENCHMARK.json)
runs once with

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, the configuration's problem class (generator,
how the port is handed its programs, the check) in
``problems/<class>.py``, its traffic mix in ``traffic/<mix>.json``, the
mix's driver in ``drivers/<driver>.py``, the limits of its correctness
check in ``limits/<cell>.json`` and each metric's reader in
``metrics/<metric>.py``.  Nothing here imports jax or the JAX package.
"""
