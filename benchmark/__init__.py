"""The benchmark of the PyTorch and CUDA port (``vello_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON result line. Everything a cell is made of is found by
name: its configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json`` (which names its scene generator
``scenes/<scene>.py`` and its loop), the limits of its output check in
``limits/<cell>.json``, and each per-layer metric's reader in
``metrics/<metric>.py``. ``reference/`` is the plain reference that
decides ``correct``; ``roofline.py`` and ``trace.py`` are the yardstick
of the per-layer readings."""
