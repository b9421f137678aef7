"""The yardstick of the port's benchmark.

``run.py`` beside this package runs one cell of ``BENCHMARK.json`` once.
Everything here is the benchmark's own and shared by every architecture:
the spec's loader and validator, which also finds an architecture's
module (``spec``), the traffic generator (``traffic``), wall-clock pacing
and the recorder (``pacing``), the weights drawn from the seed in the
layout an architecture gives (``weights``), the reference's precision and
the control's (``reference``), the attention counts and the table of
peaks (``counts``), the profiler's reading (``trace``), the comparison
that decides ``correct`` (``check``) and one run end to end (``cell``).
What is one architecture's (its layout, plain fp32 reference and model
FLOPs) is in ``archs/<arch>.py`` beside this package. Only ``cell``
touches the program (``repro_torch``); the references import nothing of
it.
"""
