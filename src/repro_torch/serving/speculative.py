"""Speculative decoding (the paper's §7 'speculation' future-work item):
the port of ``repro.serving.speculative``.

Greedy speculative sampling: a small draft model proposes k tokens
autoregressively; the target model scores all k in ONE verify pass
(``transformer.verify_chunk``) and accepts the longest prefix matching its
own greedy choices, emitting its correction token at the first mismatch.
Output is therefore the target model's greedy decode, while the target
runs once per ~(accepted+1) tokens — the decode-pool TTL lever the paper
lists as future work. The accept, correct and rewind logic and the
``stats`` keys are the reference's; the draft's cache is rewound by
re-prefilling the accepted history.

Both models run on the device of their weights, through ``impl`` (the
kernels on the card: flash for the prefills and the verify pass, dense
decode for the draft's steps). Exactness is the reference's claim in
float32; in bf16 the verify pass and a decode step round differently, so
a near-tie may go the other way.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def speculative_decode(target_params, target_cfg: ModelConfig,
                       draft_params, draft_cfg: ModelConfig,
                       prompt: np.ndarray, n_tokens: int, k: int = 4, *,
                       impl: str = "kernel") -> Tuple[List[int], dict]:
    """Greedy speculative decode of ``n_tokens``. Returns (tokens, stats)."""
    dev = target_params["embed"].device
    V = target_cfg.vocab_size
    cap = len(prompt) + n_tokens + k + 1

    def tensor(toks):
        return torch.as_tensor(np.asarray(toks, np.int64), device=dev)

    def prefill(params, cfg, toks):
        return T.prefill_full(params, cfg, {"tokens": tensor(toks)[None]},
                              capacity=cap, impl=impl)

    with torch.inference_mode():
        lg_t, cache_t = prefill(target_params, target_cfg, prompt)
        _, cache_d = prefill(draft_params, draft_cfg, prompt)
        out = [int(torch.argmax(lg_t[0, :V]))]
        pos = len(prompt)            # target cache holds [0, pos)
        stats = {"target_calls": 1, "draft_calls": 0, "proposed": 0,
                 "accepted": 0}

        while len(out) < n_tokens:
            # 1) draft proposes k tokens autoregressively from out[-1]
            proposal = []
            tok = out[-1]
            cd = cache_d
            for _ in range(k):
                lg, cd = T.decode_step(draft_params, draft_cfg, cd,
                                       tensor([tok]), impl=impl)
                stats["draft_calls"] += 1
                tok = int(torch.argmax(lg[0, :V]))
                proposal.append(tok)
            # 2) target verifies [out[-1], proposal[:-1]] in one pass:
            #    logits[i] scores position pos+i -> greedy next for prefix+i
            logits, cache_t = T.verify_chunk(
                target_params, target_cfg, cache_t,
                tensor([[out[-1]] + proposal[:-1]]), pos, impl=impl)
            stats["target_calls"] += 1
            stats["proposed"] += len(proposal)
            greedy = torch.argmax(logits[0, :, :V], dim=-1).tolist()
            n_acc = 0
            for i in range(k):
                if greedy[i] == proposal[i]:
                    n_acc += 1
                else:
                    break
            accepted = proposal[:n_acc]
            if n_acc < k:
                accepted = accepted + [greedy[n_acc]]   # target's correction
            stats["accepted"] += n_acc
            out.extend(accepted)
            pos += n_acc + (1 if n_acc < k else 0)
            cache_t["pos"] = torch.full_like(cache_t["pos"], pos)
            # 3) draft cache: keep only the accepted prefix; rewind by
            #    re-prefilling the accepted history (the draft is small)
            if n_acc == k:
                cache_d = cd                    # fully accepted: in sync
            else:
                hist = np.concatenate([np.asarray(prompt, np.int64),
                                       np.asarray(out, np.int64)])
                _, cache_d = prefill(draft_params, draft_cfg, hist[:-1])
    return out[:n_tokens], stats
