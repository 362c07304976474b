"""The benchmark of the PyTorch/CUDA port (``rappas_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA cards
of this machine and prints one JSON result line.  Everything that
belongs to one configuration, traffic mix, metric or cell sits in a file
of its own that the harness finds by name:

* ``configs/<config>.json``: the DB's sizes, its recipe and its source;
* ``recipes/<recipe>.py``: draws the DB's raw postings from the seed;
* ``traffic/<mix>.json``: the parameters of one traffic mix;
* ``metrics/<metric>.py``: the reader of one metric;
* ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``.

Nothing here imports JAX or the JAX package ``rappas_tpu``; the plain
reference (:mod:`portbench.reference`) imports nothing of the port.
"""
