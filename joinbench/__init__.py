"""The port's join benchmark: one run of one cell (``run.py``), the data
that defines its cells (``configs/``, ``traffic/``), one reader a metric
(``metrics/``), and the yardstick (the frozen generator, the plain
reference, the byte counts and the trace reduction)."""
