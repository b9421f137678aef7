"""output_tokens_per_s: every output token emitted inside the window (first
tokens included), over the window's wall seconds."""
from pbench import wall


def read(run, variant):
    return wall.tokens_in_window(run) / (run.w1 - run.w0)
