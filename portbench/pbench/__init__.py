"""The yardstick of the port's benchmark.

``run.py`` beside this package runs one cell of ``BENCHMARK.json`` once.
Everything here is the benchmark's own: the spec's loader and validator
(``spec``), the traffic generator (``traffic``), wall-clock pacing and the
recorder (``pacing``), the weights drawn from the seed (``weights``), the
plain fp32 reference (``reference``), the operation and byte counts and the
table of peaks (``counts``), the profiler's reading (``trace``), the
comparison that decides ``correct`` (``check``) and one run end to end
(``cell``). Only ``cell`` touches the program (``repro_torch``); the
reference imports nothing of it.
"""
