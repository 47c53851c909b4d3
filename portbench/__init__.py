"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  Everything that belongs to
one configuration, traffic mix, per-layer metric, kernel class or work
count is a file of its own under this folder, found by the name that
``BENCHMARK.json`` gives it.  The plain references under ``reference/``
import nothing of the program (``repro_torch``); nothing here imports JAX
or the JAX package.
"""
