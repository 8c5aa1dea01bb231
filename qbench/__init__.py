"""The benchmark of ``quiver_tpu_torch`` on NVIDIA cards.

    python3 -m qbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells. Everything a
cell needs is found by name: its configuration in ``configs/``, its
traffic mix in ``traffic/``, each per-layer metric's reader in
``layers/``, the corpus family, the system under test and the entry that
drives it in ``families/``, ``systems/`` and ``entries/``. The plain
reference that decides ``correct`` lives in ``reference/`` and imports
nothing of the program.
"""
