"""The benchmark of the PyTorch and CUDA port ``dynamic_video_depth_tpu_torch``.

One run trains one cell of ``BENCHMARK.json`` (a depth-net configuration
under a recipe's traffic) on the card for a fixed number of whole rounds of
its gap mix and prints one JSON line: ``python3 benchmark/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name: ``configs/<config>.json`` (the
sizes) beside ``configs/<config>.py`` (the plain reference net),
``traffic/<traffic>.json``, ``limits/<workload>.json`` (the limits of the
correctness check) and ``metrics/<metric>.py`` (a reader). The yardstick
lives here too: the track generator (``track.py``), the seeded weights
(``weights.py``), the work counts and peaks (``workcount.py``), the trace
attribution (``trace.py``), the plain reference step (``reference/``) and
the comparison that decides ``correct`` (``check.py``).

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package; the
reference imports nothing of the port either.
"""
