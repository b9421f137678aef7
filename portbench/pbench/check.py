"""The comparison that decides ``correct``.

After the window has closed, a sample of the requests the cluster
finished, drawn from the seed and holding the longest of them (most
output tokens, and longest prompt), is run through the plain reference
once: each prompt with its served tokens, teacher-forced. At each served
position the gap is the reference's best logit minus the logit of the
token the program served there (0 where they agree). Two numbers are
compared, each against its own limit from the cell's file:

- ``gap_max``: the widest gap over the sample's served tokens;
- ``gap_mean``: the mean gap over them (steadier from seed to seed).

Greedy serving gives the same tokens as the reference wherever the two
agree on the best logit; a served token whose logit lies far below the
reference's best is wrong. The served tokens come from the whole timed
path: the first from the prompt's prefill, the rest from paged decode
steps over the KV blocks handed to the decode engine.

The control (``control.py``) reads the same numbers for the token that a
lower precision puts first at each position of the same sequences.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from pbench.traffic import rng_for

NUMBERS = ("gap_max", "gap_mean", "logit_err_max", "logit_err_mean")


def pick_sample(done: Sequence, seed: int, served_tokens: int,
                max_requests: int) -> List:
    """Finished requests (objects with ``isl``, ``output``, ``rid``): the
    one with the most output tokens, the one with the longest prompt, then
    others drawn from the seed until ``served_tokens`` served tokens or
    ``max_requests`` requests are in."""
    done = sorted(done, key=lambda r: r.rid)
    if not done:
        return []
    pick = []
    for key in (lambda r: (len(r.output), r.isl),
                lambda r: (r.isl, len(r.output))):
        r = max(done, key=key)
        if r not in pick:
            pick.append(r)
    order = rng_for(seed, 2).permutation(len(done))
    for i in order:
        if (sum(len(r.output) for r in pick) >= served_tokens
                or len(pick) >= max_requests):
            break
        if done[i] not in pick:
            pick.append(done[i])
    return pick


def sequences(sample, device) -> Tuple[List[torch.Tensor], List[int],
                                       List[torch.Tensor]]:
    """(prompt + served tokens but the last, positions to read, served
    tokens) for each request of the sample."""
    seqs, n_last, served = [], [], []
    for r in sample:
        out = np.asarray(r.output, np.int64)
        seq = np.concatenate([np.asarray(r.prompt, np.int64), out[:-1]])
        seqs.append(torch.as_tensor(seq, device=device))
        n_last.append(len(out))
        served.append(torch.as_tensor(out, device=device))
    return seqs, n_last, served


def gaps(ref_logits: Sequence[torch.Tensor],
         tokens: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per position: the reference's best logit minus the logit of the
    given token, concatenated over the sample."""
    out = []
    for lg, tok in zip(ref_logits, tokens):
        tok = tok.long()
        best = lg.max(dim=-1).values
        ok = (tok >= 0) & (tok < lg.shape[1])      # a token off the vocab
        got = lg.gather(1, tok.clamp(0, lg.shape[1] - 1)[:, None])[:, 0]
        out.append(torch.where(ok, best - got, torch.full_like(best,
                                                               np.inf)))
    return torch.cat(out)


def served_logits(sample, served_logit, device) -> List[torch.Tensor]:
    """The program's logit at each served token of each sampled request,
    as its timed path computed it (``pacing.capture``); a request whose
    record does not hold one logit per served token gets NaNs, which no
    limit passes."""
    out = []
    for r in sample:
        rows = served_logit.get(r.rid, [])
        if len(rows) != len(r.output):
            out.append(torch.full((len(r.output),), float("nan"),
                                  device=device))
            continue
        out.append(torch.stack([m[slot] for m, slot in rows]).to(device))
    return out


def logit_errors(ref_logits, tokens, logits) -> torch.Tensor:
    """Per position: |the program's logit of its token - the reference's
    logit of that token|."""
    out = []
    for lg, tok, got in zip(ref_logits, tokens, logits):
        tok = tok.long().clamp(0, lg.shape[1] - 1)
        want = lg.gather(1, tok[:, None])[:, 0]
        out.append((got.float() - want).abs())
    return torch.cat(out)


def numbers(ref_logits, tokens, logits) -> Dict[str, float]:
    """The compared numbers of a sample: the gaps of ``tokens`` under the
    reference, and the error of ``logits``, the logits taken for them."""
    g = gaps(ref_logits, tokens)
    e = logit_errors(ref_logits, tokens, logits)
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "logit_err_max": float(e.max()),
            "logit_err_mean": float(e.mean())}


def decide(values: Dict[str, float], limits: Dict[str, float],
           served: int, min_served: int) -> Tuple[bool, Dict[str, Dict]]:
    """``correct`` and the numbers beside their limits (a number is
    correct at or under its limit; too few served tokens is not
    correct)."""
    rows = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    rows["served_tokens_min"] = {"value": served, "limit": min_served}
    ok = served >= min_served and all(values[k] <= limits[k]
                                      for k in limits)
    return ok, rows
