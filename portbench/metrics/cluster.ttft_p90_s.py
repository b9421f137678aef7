"""cluster.ttft_p90_s.<variant>: the 90th percentile, over every request
whose first token is stamped in the window, of that stamp minus the
request's due time (wall clock): the queue before the prefill pool, the
prefill and the first token. Reported beside the judged inter-token
tail, so that a change that trades one for the other (a scheduler that
holds prefills back to shorten the gaps between tokens) shows in the
ledger. It is not judged: over 40-s windows its runs spread by 11-20%
between sets, more than any bound the benchmark may set."""
from pbench import wall


def read(run, variant):
    return wall.percentile(wall.ttft(run), 90)
