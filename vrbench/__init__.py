"""The benchmark of the PyTorch/CUDA port (``videorenderer_tpu_torch``).

``python3 vrbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one NVIDIA
card and prints one JSON line.  Everything that belongs to one
configuration, traffic mix, chain of stages or metric lives in a file of
its own, found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``frames/<source format>.py`` (the inputs),
``costs/<chain>.py``, ``entries/<entry>.py``, ``metrics/<metric>.py``,
``reference/<chain>.py`` (the plain reference), ``surfaces/<format>.py``
(the output's decoding) and ``limits/<cell>.json`` (the check's limits).
"""
