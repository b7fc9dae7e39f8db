"""portbench: the end-to-end benchmark of ``gsmvi_tpu_torch`` on an NVIDIA GPU.

One run of one cell: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  Everything a
cell needs is found by name: the cell's traffic in
``workloads/<cell>.json``, its configuration in ``configs/<config>.json``,
the configuration's work counted from shapes in ``work/<config>.py``, each
per-layer metric's reader in ``metrics/<metric>.py`` and the plain
reference of each fitter in ``reference/<name>.py``.  The package reads the
program only through its public entry points and the profiler.
"""
