"""The benchmark of ``deepfm_tpu_torch`` on one NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name (``registry.py``): a configuration in
``configs/<name>.json``, a cell in ``workloads/<name>.json``, a traffic mix
in ``traffic/<name>.json`` read by the generator it names
(``traffic/<generator>.py``), a window loop in ``entries/<entry>.py``, a
per-layer metric's reader in ``metrics/<metric>.py`` and a kernel-to-
operation map in ``opmap/<operation>.json``. The yardstick lives here too:
the operation and byte counts (``counts/``), the plain reference
(``reference/``) and the comparison that decides ``correct``
(``check.py``). From the program the benchmark takes only the system under
test (``port.py`` builds it) and the kernel names of its trace.

Its tests run on the CPU with ``python3 -m pytest portbench/tests``; the
one that needs the card is marked ``cuda`` (``-m cuda`` on the card).
``python3 -m portbench.control`` reads the control and the planted faults
that set the upper ends of a cell's limits.
"""
