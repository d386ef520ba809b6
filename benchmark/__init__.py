"""The benchmark of ``vettore_tpu_torch`` on NVIDIA GPUs.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` at the repository's
root and prints one JSON line. Everything a cell needs is found by the
names in ``BENCHMARK.json``: its configuration in ``configs/<name>.json``,
its traffic in ``traffic/<name>.json``, which names the load loop in
``loops/<loop>.py`` that offers it, the system it drives in
``systems/<configuration's system>.py``, its plain reference in
``reference/<configuration's reference>.py`` and each metric's reader in
``end_to_end/<name>.py`` or ``layer_metrics/<name>.py``; the CPU tests
find each system's faults in ``faults/<system>.py``. So a new cell is new
files and new entries: ``systems/__init__.py`` says what each part gives.

Nothing here imports JAX or the JAX package, and ``reference/`` and
``data/`` import nothing of the program either.
"""
