"""perfbench: the benchmark of the PyTorch/CUDA port (`src/repro_torch`).

One run measures one cell of ``BENCHMARK.json`` once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name (`manifest`): a configuration's sizes in
``configs/<name>.json`` and the code that makes its matrix from the seed in
``cases/<case>.py`` (the JSON names it); a traffic mix's parameters in
``traffic/<name>.json``, read by the loop it names, ``loops/<loop>.py``;
each metric's reader in ``metrics/<name>.py``. The plain references live in
``reference/`` and import nothing of the port.
"""
