"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port of DAWN).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``README.md``.
"""
