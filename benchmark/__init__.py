"""The benchmark of ``emqx_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` by name. Everything a cell
needs sits in files of its own, found by name: its configuration
(``configs/<config>.json``, whose ``driver`` names ``drivers/<driver>.py``),
its traffic mix (``traffic/<traffic>.json``) and each per-layer metric
(``metrics/<metric>.py``). The yardstick lives here too: the population
and traffic generators, the reduction of the profiler's trace, the table
of peaks with the kernels' byte and operation counts, and the plain
reference in ``reference/`` that decides ``correct``.
"""
