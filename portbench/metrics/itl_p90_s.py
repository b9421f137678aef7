"""itl_p90_s: the 90th percentile of every gap between two consecutive
output tokens of one request, both stamped in the window, pooled over all
requests (wall clock): the wait between tokens that one token in ten
exceeds. A prefill run between two decode steps, a stall, a slower step
raise it."""
from pbench import wall


def read(run, variant):
    return wall.percentile(wall.itl(run), 90)
