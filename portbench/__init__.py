"""The benchmark of ``rabitq_tpu_torch`` on one NVIDIA GPU.

Every cell, configuration, traffic mix and metric is found by its name in
``BENCHMARK.json``: configurations in ``configs/<config>.json`` (their kind
of index in ``programs/<kind>.py``), traffic mixes in ``traffic/<mix>.json``
(read by :mod:`portbench.generator`; their kind of call in
``calls/<call>.py``), metric readers in ``metrics/<metric>.py``. ``run.py``
runs one cell once; :mod:`portbench.spec` finds each by its name.
"""
