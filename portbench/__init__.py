"""The benchmark of ``dsptoolbox_tpu_torch`` on one NVIDIA card.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; see ``portbench/README.md``.
"""
